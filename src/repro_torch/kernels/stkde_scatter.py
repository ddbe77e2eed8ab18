"""PB-SYM scatter on Hopper: the wrapper of ``csrc/stkde_scatter.cu``.

One launch adds every point's bandwidth cylinder into a zeroed grid with
atomics (see the note at the top of the ``.cu``): no host sync, and no
allocation but the grid. ``core/pb.py::_pb_impl`` takes it for CUDA points,
the PB-SYM variant, atomic adds and kernel functions the CUDA kernels know
(``core.pb.scatter_route``); everything else keeps that module's loop over
blocks of points, which is also what the kernel is held against on the card.
The wrapper takes CUDA tensors only: it has no CPU form, and nothing falls
back from it to the loop.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.geometry import Domain
from ..core import kernels_math as km
from ..obs import metrics as obs_metrics
from ..resilience.errors import KernelUnavailableError
from . import build
from .stkde_tile import MAX_SMEM_BYTES

# the registry counter of the kernel's launches
LAUNCHES = "stkde_scatter.launches"
# the kernel walks the points in the order i -> i * order mod n; the prime
# 2^31 - 1 is coprime to every n below it, which is every n the wrapper takes
ORDER_PRIME = 2_147_483_647


def point_order(n: int) -> int:
    """The multiplier of the kernel's walk over ``n`` points: coprime to
    ``n``, so that ``i -> i * order mod n`` visits each point once (0 when
    ``n <= 1``)."""
    return ORDER_PRIME % n if n > 1 else 0


def _library() -> ctypes.CDLL:
    lib = build.load("stkde_scatter")
    fn = lib.stkde_scatter_launch
    if fn.argtypes is None:
        ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_float)
        fn.argtypes = ([ptr, i64, ptr] + [i32] * 5 + [f32] * 8 + [i32] * 2
                       + [i64, ptr])
        fn.restype = i32
        lib.stkde_scatter_smem_bytes.argtypes = [i32] * 2
        lib.stkde_scatter_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(points: torch.Tensor, dom: Domain) -> None:
    """Refuse what the kernel does not take, before anything is allocated
    or launched."""
    if points.dim() != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be (n, 3); got {tuple(points.shape)}")
    if points.dtype != torch.float32:
        raise ValueError(f"points must be float32; got {points.dtype}")
    if not points.is_contiguous():
        raise ValueError("points must be contiguous")
    if points.shape[0] >= 2**31 - 1:
        raise ValueError(
            f"fewer than 2^31 - 1 points; got {points.shape[0]}")
    if dom.grid_voxels >= 2**31:
        raise ValueError(
            f"the scatter kernel needs a grid below 2^31 voxels; got "
            f"{dom.grid_voxels}")


def _launch(points: torch.Tensor, grid: torch.Tensor, dom: Domain,
            norm: float, ks_id: int, kt_id: int) -> None:
    """One launch on the current stream of the points' card (not
    synchronised). ``grid`` is a fresh allocation of the points' device, so
    it is aligned for the kernel's 16-byte adds."""
    if not points.is_cuda:
        raise KernelUnavailableError(
            "the scatter kernel needs CUDA points; CPU tensors take "
            "core/pb.py's loop")
    lib = _library()
    smem = lib.stkde_scatter_smem_bytes(dom.Hs, dom.Ht)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"bandwidths Hs={dom.Hs} Ht={dom.Ht} need {smem} bytes of shared "
            f"memory a block; a block has {MAX_SMEM_BYTES}")
    n = points.shape[0]
    with torch.cuda.device(points.device):
        err = lib.stkde_scatter_launch(
            points.data_ptr(), n, grid.data_ptr(), *dom.grid_shape, dom.Hs,
            dom.Ht, dom.ox, dom.oy, dom.ot, dom.sres, dom.tres, dom.hs,
            dom.ht, norm, ks_id, kt_id, point_order(n),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise KernelUnavailableError(
            f"stkde_scatter launch failed with CUDA error {err} (n={n} "
            f"grid={dom.grid_shape} Hs={dom.Hs} Ht={dom.Ht})")


def stkde_scatter_cuda(points: torch.Tensor, dom: Domain, n_total: int,
                       ks: km.SpatialKernel = km.DEFAULT_KS,
                       kt: km.TemporalKernel = km.DEFAULT_KT) -> torch.Tensor:
    """The PB-SYM density grid ``dom.grid_shape`` (float32, on the points'
    card) of ``points`` ``(n, 3)`` float32, contiguous, normalised by
    ``n_total``. Home voxels are unclipped, as the loop's: a point outside
    ``dom`` adds the part of its cylinder that lies inside. No points give
    the zeroed grid, with no launch."""
    _check(points, dom)
    ks_id, kt_id = km.spatial_kernel_id(ks), km.temporal_kernel_id(kt)
    grid = torch.zeros(dom.grid_shape, dtype=torch.float32,
                       device=points.device)
    if points.shape[0] == 0:
        return grid
    _launch(points, grid, dom, km.normalization(n_total, dom.hs, dom.ht),
            ks_id, kt_id)
    obs_metrics.counter(LAUNCHES).inc()
    return grid
