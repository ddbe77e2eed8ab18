"""Data sources: the synthetic token stream of the language models and the
point sources of chunked STKDE."""
from .pipeline import DataConfig, SyntheticLM, as_chunks, stkde_stream

__all__ = ["DataConfig", "SyntheticLM", "as_chunks", "stkde_stream"]
