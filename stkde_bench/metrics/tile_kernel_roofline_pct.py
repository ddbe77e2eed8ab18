"""The query's least time (``roofline.py``, from its points and domain
alone) over the tile kernel's device time, %."""
from stkde_bench.harness import TILE_KERNELS


def read(rec):
    s, least = rec.device_s(TILE_KERNELS), rec.least_s()
    return None if s is None or least is None else 100.0 * least / s
