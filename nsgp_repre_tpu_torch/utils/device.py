"""The device an entry point runs on.

The port runs on ``cuda`` unless the caller names another device. With
no device named, or ``cuda`` named, and no CUDA device present, it
raises: it never falls back to the CPU on its own.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The named device, else ``cuda``; raises when that is CUDA and CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless device='cpu' is passed"
        )
    return dev
