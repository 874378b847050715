"""``LayerNorm`` (mirrors ``paddle_tpu/nn/layer/norm.py``).

Same parameter names (``weight``, ``bias``) and the same eps semantics as
the reference's ``_ln`` (``models/gpt.py``): biased variance, eps inside
the square root, ``(x - mean) / sqrt(var + eps) * weight + bias``.
Abstract under ``LazyGuard`` (``framework.lazy.parameter``).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as TF

from ...core.place import resolve_device
from ...framework.lazy import parameter
from .. import initializer as I


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape: int, epsilon: float = 1e-5,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.normalized_shape = (int(normalized_shape),)
        self.epsilon = float(epsilon)
        self.weight = parameter(self.normalized_shape, I.Constant(1.0), dev)
        self.bias = parameter(self.normalized_shape, I.Constant(0.0), dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return TF.layer_norm(x, self.normalized_shape, self.weight,
                             self.bias, self.epsilon)
