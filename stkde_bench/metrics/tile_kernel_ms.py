"""Device time of the tile kernel per query, ms: the split pass and the
reduction (``kernels/csrc/stkde_tile.cu``), by kernel name in the profiler's
trace of real queries."""
from stkde_bench.harness import TILE_KERNELS


def read(rec):
    s = rec.device_s(TILE_KERNELS)
    return None if s is None else 1e3 * s
