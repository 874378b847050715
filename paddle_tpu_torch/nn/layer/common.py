"""``Linear`` and ``Embedding`` (mirrors ``paddle_tpu/nn/layer/common.py``).

``Linear`` keeps the reference's ``weight [in, out]`` layout and applies
``x @ W + b``, so weights carry across from the JAX package without a
transpose.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...core.place import resolve_device
from .. import initializer as I


class Linear(nn.Module):
    """``y = x @ weight + bias`` with ``weight [in_features, out_features]``."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr: Optional[I.Initializer] = None,
                 has_bias: bool = True, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(in_features, out_features,
                                               device=dev))
        (weight_attr or I.Normal(0.0, 0.02))(self.weight)
        if has_bias:
            self.bias = nn.Parameter(torch.zeros(out_features, device=dev))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.weight
        return y if self.bias is None else y + self.bias


class Embedding(nn.Module):
    """Row lookup into ``weight [num_embeddings, embedding_dim]``."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr: Optional[I.Initializer] = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(num_embeddings, embedding_dim,
                                               device=dev))
        (weight_attr or I.Normal(0.0, 0.02))(self.weight)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.weight[ids]
