"""Parameter initializers (mirrors ``paddle_tpu/nn/initializer``).

Each initializer fills a tensor in place from an explicit
``torch.Generator`` — by default the generator of the tensor's device
(``core.rng.generator``), so ``seed(n)`` makes model construction
reproducible per device.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core import rng


class Initializer:
    def __call__(self, t: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        raise NotImplementedError


class Normal(Initializer):
    """N(mean, std) draws."""

    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean = float(mean)
        self.std = float(std)

    def __call__(self, t, generator=None):
        gen = generator if generator is not None else rng.generator(t.device)
        with torch.no_grad():
            return t.normal_(self.mean, self.std, generator=gen)


class Constant(Initializer):
    """Every element ``value`` (draws nothing)."""

    def __init__(self, value: float = 0.0):
        self.value = float(value)

    def __call__(self, t, generator=None):
        with torch.no_grad():
            return t.fill_(self.value)


__all__ = ["Initializer", "Normal", "Constant"]
