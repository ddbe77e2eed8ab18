"""Serving substrate of the port: the bucketed language-model engine and
partial STKDE answers from a progress journal."""
from .engine import (
    EngineConfig,
    PartialGridAnswer,
    Request,
    RequestResult,
    ServingEngine,
    cache_bytes,
    make_prefill,
    make_serve_step,
    stkde_partial_answer,
)

__all__ = [
    "ServingEngine", "EngineConfig", "Request", "RequestResult",
    "make_serve_step", "make_prefill", "cache_bytes", "PartialGridAnswer",
    "stkde_partial_answer",
]
