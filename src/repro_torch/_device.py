"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch

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
