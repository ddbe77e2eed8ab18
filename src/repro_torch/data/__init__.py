"""Point sources for chunked STKDE (the LM token stream is not ported yet)."""
from .pipeline import as_chunks, stkde_stream

__all__ = ["as_chunks", "stkde_stream"]
