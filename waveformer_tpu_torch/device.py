"""Device resolution shared by the entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The CUDA device unless the caller asks for another one.

    Raises when no device was given and CUDA is absent: the entry points
    never carry on on the CPU unless the caller asked for it.
    """
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain PyTorch path"
        )
    return torch.device("cuda", torch.cuda.current_device())
