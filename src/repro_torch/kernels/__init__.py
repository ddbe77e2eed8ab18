"""Hand-written Hopper kernels for the STKDE compute hot-spot.

csrc/stkde_tile.cu — PB-SYM tile accumulation, CUDA C++ for sm_90a
                     (work items over the tiles' points, 3xTF32 mma.sync)
stkde_tile.py      — its wrapper (work plan, launch, launch counter, modes)
csrc/stkde_scatter.cu — the PB-SYM scatter in one launch, CUDA C++ for
                     sm_90a (a warp a point, vector atomics along t); the
                     route of core/pb.py::_pb_impl on CUDA
stkde_scatter.py   — its wrapper (checks, launch, launch counter)
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
