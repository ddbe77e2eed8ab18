"""Meshes of logical shards: the port's counterpart of ``jax.sharding.Mesh``
and of the reference's ``launch/mesh.py``.

A ``Mesh`` is an n-d array of ``torch.device``s with one name per axis. The
strategies in ``stkde_dist`` run one shard per mesh position from a single
controller process, in a fixed order, and move halo bands and partial grids
between shards with ``.to(device)`` (``collectives``). A device may repeat:
eight shards on ``cuda:0`` is a valid mesh, and is how one card runs every
strategy with real halo exchanges between its shards.

A mesh made with ``positions=True`` gives each position a device object of
its own (equal in value, distinct in identity): the position identity that
``launch.dryrun`` accounts bytes by when every position sits on one fake
device. While its accounting runs (``tracking``), ``at`` names the position
whose work runs now and ``device_of`` the device object of the position a
tensor lives at. Without a tracker both cost nothing and change nothing.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device


class Mesh:
    """Devices laid out on named axes.

    devices:    nested sequence (or array) of ``torch.device`` or device
                strings; its shape is the mesh's shape. A CUDA device
                without a card raises ``KernelUnavailableError``.
    axis_names: one name per axis of ``devices``.
    """

    def __init__(self, devices, axis_names: Sequence[str],
                 positions: bool = False):
        arr = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if arr.ndim != len(names):
            raise ValueError(f"mesh of {arr.ndim} axes given "
                             f"{len(names)} names {names}")
        if len(set(names)) != len(names):
            raise ValueError(f"axis names repeat: {names}")
        self.devices = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            self.devices[idx] = resolve_device(arr[idx])
            if positions:
                # a distinct object per position: ``torch.device`` is
                # immutable, so rebuilding it from its fields gives one
                d = self.devices[idx]
                self.devices[idx] = torch.device(d.type, d.index)
        self.axis_names = names
        self.has_positions = positions

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first_device(self) -> torch.device:
        """Where assembled (gathered or reduced) results are placed."""
        return self.devices.flat[0]

    def devices_of(self, axes: Sequence[str]) -> np.ndarray:
        """The device of each shard of a value split over ``axes``: an array
        of shape ``(mesh.shape[a] for a in axes)``. Mesh axes not in
        ``axes`` hold replicas; the shard runs on the replica at index 0."""
        axes = tuple(axes)
        missing = [a for a in axes if a not in self.axis_names]
        if missing:
            raise ValueError(f"axes {missing} not in mesh {self.axis_names}")
        rest = [k for k, a in enumerate(self.axis_names) if a not in axes]
        perm = [self.axis_names.index(a) for a in axes] + rest
        arr = np.transpose(self.devices, perm)
        return arr[(slice(None),) * len(axes) + (0,) * len(rest)]

    def __repr__(self) -> str:
        devices = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, devices={devices})"


def make_host_mesh(n_devices: int = 8, multi_pod: bool = False,
                   device: DeviceLike = None) -> Mesh:
    """Small mesh with the reference's axis names and shapes: ``(n/2, 2)``
    ``("data", "model")``, or ``(2, n/4, 2)`` ``("pod", "data", "model")``
    with ``multi_pod``. Every shard sits on ``device`` (``None`` means
    ``"cuda"``; tests pass ``"cpu"``)."""
    dev = resolve_device(device)
    if multi_pod:
        shape: Tuple[int, ...] = (2, max(1, n_devices // 4), 2)
        axes: Tuple[str, ...] = ("pod", "data", "model")
    else:
        shape = (max(1, n_devices // 2), 2)
        axes = ("data", "model")
    devices = np.empty(shape, dtype=object)
    devices.fill(dev)
    return Mesh(devices, axes)


def shrink_mesh(mesh: Mesh, n_lost: int = 1) -> Optional[Mesh]:
    """Rebuild ``mesh`` after losing ``n_lost`` devices (tail devices are
    dropped — the injector does not name a victim, and any survivor
    permutation is equivalent for our collectives).

    Axis names are preserved so strategy code keeps working unchanged.
    The trailing (model) axis size is kept where possible and halved
    until the survivors fill at least one full row; leading extra axes
    (e.g. ``pod``) collapse to 1. Returns ``None`` when fewer than two
    usable devices remain — the caller then degrades to single-device
    execution.
    """
    devices = list(mesh.devices.reshape(-1))
    survivors = devices[: len(devices) - n_lost]
    names = tuple(mesh.axis_names)
    last = int(mesh.shape[names[-1]]) if len(names) > 1 else 1
    n = len(survivors)
    while last > 1 and n // last < 1:
        last //= 2
    lead = n // max(1, last)
    used = lead * last
    if used < 2:
        return None
    if len(names) == 1:
        shape: Tuple[int, ...] = (used,)
    else:
        shape = (1,) * (len(names) - 2) + (lead, last)
    arr = np.empty(used, dtype=object)
    arr[:] = survivors[:used]
    return Mesh(arr.reshape(shape), names)


# ------------------------------------------------------ position identity
class _Tracking:
    """What ``tracking`` installs: a ``positions=True`` mesh's device
    objects by row-major position, the tracker's tensor -> position function
    and function-mode factory, and the position whose work runs now."""

    def __init__(self, mesh: Mesh, locate: Callable, function_mode: Callable):
        self.devices = list(mesh.devices.flat)
        # the mesh's objects are held in ``devices``, so their ids stay theirs
        self.index = {id(d): k for k, d in enumerate(self.devices)}
        self.locate = locate
        self.function_mode = function_mode
        self.current: Optional[int] = None

    @contextlib.contextmanager
    def running(self, pos: Optional[int]):
        prev, self.current = self.current, pos
        try:
            yield
        finally:
            self.current = prev


_TRACKING: Optional[_Tracking] = None


@contextlib.contextmanager
def tracking(mesh: Mesh, locate: Callable, function_mode: Callable):
    """While open, ``mesh``'s positions are accounted: ``locate`` (tensor ->
    position or ``None``) answers ``position_of`` and ``device_of`` for
    tensors, and ``function_mode()`` makes the accounting's torch function
    mode, which a checkpointed block's recompute re-enters (autograd runs it
    with no function mode)."""
    global _TRACKING
    prev, _TRACKING = _TRACKING, _Tracking(mesh, locate, function_mode)
    try:
        yield
    finally:
        _TRACKING = prev


def position_of(x) -> Optional[int]:
    """The position of a device object of the tracked mesh, or of a tensor
    as the tracker places it; ``None`` for anything else, and always when
    no tracker is installed."""
    tr = _TRACKING
    if tr is None:
        return None
    if isinstance(x, torch.Tensor):
        return tr.locate(x)
    return tr.index.get(id(x))


def device_of(t: torch.Tensor) -> torch.device:
    """The device ``t`` lives on, as the port's meshes name it: the device
    object of its position under a tracker, else ``t.device``."""
    tr = _TRACKING
    pos = tr.locate(t) if tr is not None else None
    return tr.devices[pos] if pos is not None else t.device


def current_position() -> Optional[int]:
    return _TRACKING.current if _TRACKING is not None else None


def recompute_context():
    """A context manager that re-enters the position current now and the
    tracker's function mode (nothing without a tracker): what a
    checkpointed block's recompute (``remat``) runs under, since autograd
    runs it during backward, after the caller's ``at`` has closed."""
    tr = _TRACKING
    if tr is None:
        return contextlib.nullcontext()
    return _recompute(tr, tr.current)


@contextlib.contextmanager
def _recompute(tr: _Tracking, pos: Optional[int]):
    with tr.running(pos), tr.function_mode():
        yield


@contextlib.contextmanager
def at(device):
    """While open, ``device``'s position is the one whose work runs now:
    the tracker places there what is created without a placed input. A
    no-op for a device that is no position of the tracked mesh."""
    pos = position_of(device)
    if pos is None:
        yield
        return
    with _TRACKING.running(pos):
        yield
