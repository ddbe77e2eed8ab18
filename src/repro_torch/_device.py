"""Device resolution shared by every entry point of the port, and the one
copy of a point set to its device."""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .obs import trace as obs_trace
from .resilience.errors import KernelUnavailableError

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device that is not there raises
    ``KernelUnavailableError``; the CPU is used only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise KernelUnavailableError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host"
        )
    return dev


def points_to_device(points, device: torch.device) -> torch.Tensor:
    """The ``(n, 3)`` float32 points on ``device``, copied once (from pinned
    host memory when the device is a card)."""
    with obs_trace.span("stkde.h2d", device=device) as sp:
        pts = torch.from_numpy(np.ascontiguousarray(points, dtype=np.float32))
        if sp.recording:
            sp.set(bytes=pts.nbytes)
        if device.type == "cuda":
            return pts.pin_memory().to(device, non_blocking=True)
        return pts.to(device)
