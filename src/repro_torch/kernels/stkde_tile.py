"""PB-SYM tile accumulation on Hopper: the wrapper of ``csrc/stkde_tile.cu``.

The paper's PB-SYM observation — each point's contribution factors into a
spatial disk ``Ks[X, Y]`` and a temporal bar ``Kt[T]`` — makes a grid tile's
density a contraction over its candidate points,

    density[bx, by, bt]  =  sum_p Ks_p[bx, by] * Kt_p[bt]

which the CUDA kernel computes with one block per output tile, the tile's sums
resident in registers across the whole point stream, and the points arriving
pre-bucketed per tile (host-side overlap bucketing, ``core/bucketing.py``) in
``chunk``-sized panels staged through shared memory. See the note at the top
of the ``.cu`` for what bounds it and what the design does about that.

Where the tensors live decides what runs: CUDA tensors launch the kernel (or
raise ``KernelUnavailableError``), CPU tensors run the plain version
``ref.stkde_tiles_ref``. Nothing falls back from the one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core.geometry import Domain
from ..core import kernels_math as km
from ..resilience.errors import KernelUnavailableError
from . import build
from .ref import stkde_tiles_ref

# execution modes of the tile kernel's entry points
MODES = ("auto", "reference", "compiled")

# dynamic shared memory one block may use on Hopper
MAX_SMEM_BYTES = 232_448

_launches = 0


def launch_count() -> int:
    """How many times this process has launched the CUDA tile kernel."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load("stkde_tile")
    fn = lib.stkde_tile_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
            + [ctypes.c_float] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.stkde_tile_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.stkde_tile_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(t: torch.Tensor, name: str, shape, dtype) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(
            f"{name} must be {dtype} of shape {tuple(shape)}; got "
            f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(pts_tiles, valid_tiles, counts, dom, tile, cap, n_total, chunk,
            ks, kt) -> torch.Tensor:
    """Check the arguments, launch the kernel on the current stream of the
    tensors' device, and return the padded grid (not synchronised)."""
    global _launches
    ks_id = km.spatial_kernel_id(ks)
    kt_id = km.temporal_kernel_id(kt)
    bx, by, bt = tile
    ntx, nty, ntt = pts_tiles.shape[:3]
    dev = pts_tiles.device
    _check(pts_tiles, "pts_tiles", (ntx, nty, ntt, cap, 3), torch.float32)
    _check(valid_tiles, "valid_tiles", (ntx, nty, ntt, cap), torch.float32)
    if valid_tiles.device != dev:
        raise ValueError("pts_tiles and valid_tiles must be on one device")
    if counts is not None:
        _check(counts, "counts", (ntx, nty, ntt), torch.int32)
        if counts.device != dev:
            raise ValueError("counts must be on the device of pts_tiles")
    if min(bx, by, bt, cap, chunk) < 1 or cap % chunk:
        raise ValueError(
            f"chunk must divide cap and tile be positive; got tile={tile} "
            f"cap={cap} chunk={chunk}")
    ntiles = ntx * nty * ntt
    if ntiles >= 2**31 or cap >= 2**31 - chunk:
        raise ValueError(f"too many tiles ({ntiles}) or cap too large ({cap})")

    lib = _library()
    smem = lib.stkde_tile_smem_bytes(bx, by, chunk)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"a panel of chunk={chunk} points for tile {tile} needs {smem} "
            f"bytes of shared memory; a block has {MAX_SMEM_BYTES}: lower "
            "chunk or the tile")

    out = torch.empty((ntx * bx, nty * by, ntt * bt), dtype=torch.float32,
                      device=dev)
    norm = km.normalization(n_total, dom.hs, dom.ht)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.stkde_tile_launch(
            pts_tiles.data_ptr(), valid_tiles.data_ptr(),
            None if counts is None else counts.data_ptr(), out.data_ptr(),
            ntx, nty, ntt, bx, by, bt, cap, chunk,
            dom.ox, dom.oy, dom.ot, dom.sres, dom.tres, dom.hs, dom.ht, norm,
            ks_id, kt_id, stream,
        )
    _launches += 1
    if err != 0:
        raise KernelUnavailableError(
            f"stkde_tile kernel launch failed with CUDA error {err} "
            f"(tile={tile} cap={cap} chunk={chunk} smem={smem})")
    return out


def stkde_tiles_cuda(
    pts_tiles: torch.Tensor,    # (ntx, nty, ntt, cap, 3) f32
    valid_tiles: torch.Tensor,  # (ntx, nty, ntt, cap) f32
    dom: Domain,
    tile: Tuple[int, int, int],
    cap: int,
    n_total: int,
    chunk: int = 256,
    ks: km.SpatialKernel = km.DEFAULT_KS,
    kt: km.TemporalKernel = km.DEFAULT_KT,
    mode: str = "auto",
    counts: Optional[torch.Tensor] = None,  # (ntx, nty, ntt) int32
) -> torch.Tensor:
    """Padded density grid (ntx*bx, nty*by, ntt*bt).

    ``mode`` selects what runs: ``"compiled"`` launches the CUDA kernel and
    raises ``KernelUnavailableError`` for CPU tensors; ``"reference"`` runs
    the plain PyTorch version wherever the tensors live; ``"auto"`` (default)
    launches the kernel for CUDA tensors and runs the plain version for CPU
    tensors. ``ks``/``kt`` must be callables of ``kernels_math`` when the
    kernel runs; the plain version takes any callable.

    ``counts`` are the tiles' true loads (``Buckets.counts``). A bucket holds
    its valid points first, so with ``counts`` a tile's walk stops at the end
    of the ``chunk`` panel that holds its last valid point instead of at
    ``cap``; the terms left out are exact zeros.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    on_cuda = pts_tiles.is_cuda
    if mode == "compiled" and not on_cuda:
        raise KernelUnavailableError(
            "mode='compiled' needs CUDA tensors; the tile kernel has no CPU "
            "form (mode='reference' runs the plain version)")
    if mode == "reference" or not on_cuda:
        return stkde_tiles_ref(pts_tiles, valid_tiles, dom, tile, n_total,
                               ks, kt, counts=counts)
    return _launch(pts_tiles, valid_tiles, counts, dom, tile, cap, n_total,
                   min(chunk, cap), ks, kt)
