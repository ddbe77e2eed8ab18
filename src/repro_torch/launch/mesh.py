"""Production mesh shapes (the reference's ``launch/mesh.py``) as ``Mesh``es
of ``torch.device``s, plus the host-mesh and failure-shrink constructors of
``distributed/mesh.py`` under the reference's import path."""
from __future__ import annotations

import numpy as np

from .._device import DeviceLike, resolve_device
from ..distributed.mesh import Mesh, make_host_mesh, shrink_mesh

__all__ = ["make_production_mesh", "make_host_mesh", "shrink_mesh"]


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> Mesh:
    """The reference's 16 x 16 ``("data", "model")`` mesh (256 shards), or
    2 x 16 x 16 ``("pod", "data", "model")`` with ``multi_pod`` (512), every
    position on ``device`` (``None`` means ``"cuda"``). Its shapes are what
    the placement rules of ``distributed.sharding`` are checked on."""
    dev = resolve_device(device)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devices = np.empty(shape, dtype=object)
    devices.fill(dev)
    return Mesh(devices, axes)
