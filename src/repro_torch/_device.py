"""Device resolution for the port's entry points.

Every entry point runs on ``cuda`` unless its caller names another device.
A request for ``cuda`` on a machine without a usable GPU raises: the port
never falls back to the CPU on its own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; raise when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and torch.cuda.is_available() "
            "is False; pass device='cpu' explicitly to run the plain versions"
        )
    return dev
