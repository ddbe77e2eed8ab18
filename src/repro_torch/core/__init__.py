"""Core STKDE: the paper's contribution as composable PyTorch modules."""
from .geometry import Domain, from_points
from . import kernels_math
from .pb import pb, pb_sym, VARIANTS
from . import bucketing
from .datasets import (
    STKDEInstance,
    INSTANCES,
    get_instance,
    bench_suite,
    clustered_events,
)
from .api import stkde, validate_inputs

__all__ = [
    "stkde",
    "validate_inputs",
    "Domain",
    "from_points",
    "kernels_math",
    "pb",
    "pb_sym",
    "VARIANTS",
    "bucketing",
    "STKDEInstance",
    "INSTANCES",
    "get_instance",
    "bench_suite",
    "clustered_events",
]
