"""Hand-written Hopper kernels for the STKDE compute hot-spot.

csrc/stkde_tile.cu — PB-SYM tile accumulation, CUDA C++ for sm_90a
                     (work items over the tiles' points, 3xTF32 mma.sync)
stkde_tile.py      — its wrapper (work plan, launch, launch counter, modes)
build.py           — nvcc build of csrc/ at first use, ctypes loading
ops.py             — public wrappers (bucketing + kernel + slice)
ref.py             — the plain PyTorch version (CPU path, allclose target)
"""
from .ops import stkde_tiled, default_tile
from .stkde_tile import stkde_tiles_cuda
from .ref import stkde_tiles_ref

__all__ = [
    "stkde_tiled",
    "default_tile",
    "stkde_tiles_cuda",
    "stkde_tiles_ref",
]
