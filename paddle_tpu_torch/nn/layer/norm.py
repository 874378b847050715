"""``LayerNorm`` (mirrors ``paddle_tpu/nn/layer/norm.py``).

Same parameter names (``weight``, ``bias``) and the same eps semantics as
the reference's ``_ln`` (``models/gpt.py``): biased variance, eps inside
the square root, ``(x - mean) / sqrt(var + eps) * weight + bias``.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as TF

from ...core.place import resolve_device


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape: int, epsilon: float = 1e-5,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.normalized_shape = (int(normalized_shape),)
        self.epsilon = float(epsilon)
        self.weight = nn.Parameter(torch.ones(normalized_shape, device=dev))
        self.bias = nn.Parameter(torch.zeros(normalized_shape, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return TF.layer_norm(x, self.normalized_shape, self.weight,
                             self.bias, self.epsilon)
