"""``LayerNorm`` (mirrors ``paddle_tpu/nn/layer/norm.py``).

Same parameter names (``weight``, ``bias``) and the same eps semantics as
the reference's ``_ln`` (``models/gpt.py``): biased variance, eps inside
the square root, ``(x - mean) / sqrt(var + eps) * weight + bias``.
Abstract under ``LazyGuard`` (``framework.lazy.parameter``).

A bf16 or f16 input is normalised in f32 and rounded once, as the
reference's ``layer_norm`` does (``nn/functional/norm.py``): on the card
PyTorch's kernel computes so (its weight and bias gradients are f32 sums
rounded once). Its CPU kernel's weight and bias gradients of a bf16
input miss the f32 sums by far more than one bf16 rounding, and by more
the fewer threads it runs on, so off the card the input and the affine
parameters are upcast and the f32 result is cast back.
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
        if x.device.type != "cuda" and x.dtype in (torch.bfloat16,
                                                   torch.float16):
            return TF.layer_norm(x.float(), self.normalized_shape,
                                 self.weight.float(), self.bias.float(),
                                 self.epsilon).to(x.dtype)
        return TF.layer_norm(x, self.normalized_shape, self.weight,
                             self.bias, self.epsilon)
