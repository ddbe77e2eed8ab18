"""Core STKDE: the paper's contribution as composable PyTorch modules."""
from .geometry import Domain, from_points
from . import kernels_math
from .pb import pb, pb_sym, pb_eval_only, VARIANTS
from .vb import vb, vb_dec
from . import bucketing, plan
from .datasets import (
    STKDEInstance,
    INSTANCES,
    get_instance,
    bench_suite,
    clustered_events,
)
from .api import ChunkedResult, stkde, stkde_chunked, validate_inputs

__all__ = [
    "stkde",
    "stkde_chunked",
    "ChunkedResult",
    "validate_inputs",
    "Domain",
    "from_points",
    "kernels_math",
    "pb",
    "pb_sym",
    "pb_eval_only",
    "vb",
    "vb_dec",
    "VARIANTS",
    "bucketing",
    "plan",
    "STKDEInstance",
    "INSTANCES",
    "get_instance",
    "bench_suite",
    "clustered_events",
]
