"""Device resolution (mirrors ``paddle_tpu/core/place.py``).

The port's entry points run on the card by default: ``None`` resolves
to ``"cuda"``, and asking for CUDA where no CUDA device is present
raises instead of silently falling back to the CPU. The CPU is used only
when the caller names it, as the tests do.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` -> cpu; a CUDA device must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is present; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: cuda or cpu")
    return dev

