"""Top-level STKDE public API of the port.

    from repro_torch.core.api import stkde
    grid = stkde(points, dom)                          # PB-SYM scatter
    grid = stkde(points, dom, use_tiled_kernel=True)   # CUDA tile kernel
    grid = stkde(points, dom, device="cpu")            # plain versions, host

Robustness contract: inputs are validated at this boundary (typed
``ReproValidationError`` instead of downstream shape errors) and outputs are
NaN/Inf-checked. ``device=None`` means ``"cuda"``; without a CUDA device that
raises ``KernelUnavailableError`` — nothing carries on on the CPU unasked.
Meshes, strategies, fallback and chunked execution are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..resilience.degrade import ensure_finite
from ..resilience.errors import ReproValidationError
from .geometry import Domain
from . import kernels_math as km
from .pb import pb as _pb


def validate_inputs(points, dom: Domain) -> np.ndarray:
    """API-boundary validation; returns points as float32 ``(n, 3)``.

    Rejects (typed ``ReproValidationError``): empty point sets, wrong
    shapes, NaN/Inf coordinates, non-positive bandwidths/resolutions,
    and time coordinates outside the domain's time window (± one
    temporal bandwidth — points just outside still radiate density in).
    """
    pts = np.asarray(points, dtype=np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ReproValidationError(
            f"points must be (n, 3) [x, y, t]; got shape {pts.shape}"
        )
    if len(pts) == 0:
        raise ReproValidationError("empty point set")
    if not np.isfinite(pts).all():
        bad = int(len(pts) - np.isfinite(pts).all(axis=1).sum())
        raise ReproValidationError(
            f"{bad}/{len(pts)} points have NaN/Inf coordinates"
        )
    if not (dom.hs > 0 and dom.ht > 0):
        raise ReproValidationError(
            f"bandwidths must be positive: hs={dom.hs} ht={dom.ht}"
        )
    if not (dom.sres > 0 and dom.tres > 0):
        raise ReproValidationError(
            f"resolutions must be positive: sres={dom.sres} tres={dom.tres}"
        )
    t_lo, t_hi = dom.ot - dom.ht, dom.ot + dom.gt + dom.ht
    t = pts[:, 2]
    if t.min() < t_lo or t.max() > t_hi:
        n_out = int(((t < t_lo) | (t > t_hi)).sum())
        raise ReproValidationError(
            f"{n_out}/{len(pts)} points outside the domain time window "
            f"[{t_lo}, {t_hi}] (ot={dom.ot} gt={dom.gt} ht={dom.ht})"
        )
    return pts


def stkde(
    points,
    dom: Domain,
    ks: km.SpatialKernel = km.DEFAULT_KS,
    kt: km.TemporalKernel = km.DEFAULT_KT,
    use_tiled_kernel: bool = False,
    validate: bool = True,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Space-time kernel density grid for ``points`` over ``dom``: a
    ``float32`` tensor of shape ``dom.grid_shape`` on ``device``.

    use_tiled_kernel: overlap-bucket the points on the host and run the
              tile kernel (the CUDA kernel on a CUDA device, its plain
              version on the CPU) instead of the PB-SYM scatter.
    validate: typed input validation at this boundary (see
              ``validate_inputs``).
    device:   ``None`` means ``"cuda"``.
    """
    dev = resolve_device(device)
    if validate:
        pts = validate_inputs(points, dom)
    else:
        pts = np.asarray(points, dtype=np.float32)
    if use_tiled_kernel:
        from ..kernels import stkde_tiled

        return ensure_finite(
            stkde_tiled(pts, dom, ks=ks, kt=kt, device=dev), "stkde.tiled")
    return ensure_finite(
        _pb(pts, dom, variant="sym", ks=ks, kt=kt, device=dev), "stkde.pb"
    )
