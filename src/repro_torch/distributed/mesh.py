"""Meshes of logical shards: the port's counterpart of ``jax.sharding.Mesh``
and of the reference's ``launch/mesh.py``.

A ``Mesh`` is an n-d array of ``torch.device``s with one name per axis. The
strategies in ``stkde_dist`` run one shard per mesh position from a single
controller process, in a fixed order, and move halo bands and partial grids
between shards with ``.to(device)`` (``collectives``). A device may repeat:
eight shards on ``cuda:0`` is a valid mesh, and is how one card runs every
strategy with real halo exchanges between its shards.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

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

    def __init__(self, devices, axis_names: Sequence[str]):
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
        self.axis_names = names

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
