"""Normalization layers (mirrors ``paddle_tpu/nn/layer/norm.py``):
``LayerNorm``, ``RMSNorm``, the batch norms (``BatchNorm1D/2D/3D``, the
fluid ``BatchNorm``, ``SyncBatchNorm``), ``GroupNorm``, the instance
norms, ``LocalResponseNorm`` and ``SpectralNorm``. The batch norms keep
the reference's buffers ``_mean``/``_variance`` and its momentum rule
(``functional/norm.py``); they are not ``torch.nn.BatchNorm2d``, whose
buffers, momentum and running variance differ.

``LayerNorm``:

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
parameters are upcast and the f32 result is cast back. The rule lives
in ``functional.layer_norm``, which ``forward`` calls.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...core import rng
from ...framework.lazy import in_lazy_mode, parameter
from .. import functional as F
from .. import initializer as I
from .layers import Layer, layer_device


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape: int, epsilon: float = 1e-5,
                 device=None):
        super().__init__()
        dev = layer_device(device)
        self.normalized_shape = (int(normalized_shape),)
        self.epsilon = float(epsilon)
        self.weight = parameter(self.normalized_shape, I.Constant(1.0), dev)
        self.bias = parameter(self.normalized_shape, I.Constant(0.0), dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)


class RMSNorm(Layer):
    """Beyond the reference's Paddle: RMSNorm for LLM blocks."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 device=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr,
            default_initializer=I.Constant(1.0), device=device)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class _BatchNormBase(Layer):
    """The reference's batch norm (``functional.batch_norm``): buffers
    ``_mean`` (zeros) and ``_variance`` (ones) in f32, no
    ``num_batches_tracked``; ``momentum`` is the share kept."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, device=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        dev = layer_device(device)
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0), device=dev)
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True, device=dev)
        meta = in_lazy_mode()
        self.register_buffer("_mean", torch.zeros(
            num_features, device="meta" if meta else dev))
        self.register_buffer("_variance", torch.ones(
            num_features, device="meta" if meta else dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name,
                         device)


class BatchNorm(_BatchNormBase):
    """The fluid-era ``BatchNorm`` (reference: fluid/dygraph/nn.py), with
    its activation ``act`` after the norm."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, moving_mean_name=None,
                 moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False,
                 device=None):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats or None,
                         device=device)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act:
            out = getattr(F, self._act)(out)
        return out


class SyncBatchNorm(_BatchNormBase):
    """Batch norm over the whole data-parallel batch. As in the
    reference (where GSPMD's one program sees the global batch), it is
    ``BatchNorm``: the trainer's ``context.batch_norm_scope`` spans the
    ranks for every batch norm of the model alike."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        for name, sub in list(layer.named_children()):
            if isinstance(sub, _BatchNormBase) and not isinstance(
                    sub, SyncBatchNorm):
                new = SyncBatchNorm(sub._num_features, sub._momentum,
                                    sub._epsilon,
                                    weight_attr=None if sub.weight
                                    is not None else False,
                                    bias_attr=None if sub.bias is not None
                                    else False,
                                    data_format=sub._data_format,
                                    device=sub._mean.device)
                with torch.no_grad():
                    if sub.weight is not None:
                        new.weight.copy_(sub.weight)
                    if sub.bias is not None:
                        new.bias.copy_(sub.bias)
                    new._mean.copy_(sub._mean)
                    new._variance.copy_(sub._variance)
                setattr(layer, name, new)
            else:
                cls.convert_sync_batchnorm(sub)
        return layer


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_channels], attr=weight_attr,
            default_initializer=I.Constant(1.0), device=device)
        self.bias = self.create_parameter([num_channels], attr=bias_attr,
                                          is_bias=True, device=device)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class InstanceNorm1D(Layer):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None, device=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0), device=device)
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True, device=device)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm2D(InstanceNorm1D):
    pass


class InstanceNorm3D(InstanceNorm1D):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(Layer):
    """``W / sigma_max(W)`` by power iteration (reference:
    operators/spectral_norm_op.cc): the weight viewed as ``[shape[dim],
    prod(rest)]``; buffers ``weight_u``/``weight_v`` (unit vectors, drawn
    from the device's generator) updated without gradient each forward;
    the gradient flows through the weight only."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None, device=None):
        super().__init__()
        self._dim = int(dim)
        self._power_iters = int(power_iters)
        self._eps = float(eps)
        self._weight_shape = [int(s) for s in weight_shape]
        h = self._weight_shape[self._dim]
        w = int(np.prod(self._weight_shape)) // h
        dev = layer_device(device)
        gen = rng.generator(dev)
        u = torch.randn(h, generator=gen, device=dev)
        v = torch.randn(w, generator=gen, device=dev)
        self.register_buffer("weight_u", u / torch.clamp(u.norm(),
                                                         min=self._eps))
        self.register_buffer("weight_v", v / torch.clamp(v.norm(),
                                                         min=self._eps))

    def forward(self, weight):
        perm = [self._dim] + [i for i in range(weight.dim())
                              if i != self._dim]
        mat = weight.permute(perm).reshape(weight.shape[self._dim], -1)
        u, v = self.weight_u, self.weight_v
        with torch.no_grad():
            m = mat.detach()
            for _ in range(self._power_iters):
                v = m.t() @ u
                v = v / torch.clamp(v.norm(), min=self._eps)
                u = m @ v
                u = u / torch.clamp(u.norm(), min=self._eps)
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
        sigma = u @ (mat @ v)
        return weight / sigma
