"""Activation functionals (mirrors
``paddle_tpu/nn/functional/activation.py``; reference:
python/paddle/nn/functional/activation.py). Each is the reference's
formula in PyTorch operations; ``gumbel_softmax`` draws its noise from
the device's ``torch.Generator`` (``core.rng``), so its samples are not
the reference's."""
from __future__ import annotations

import torch
from torch.nn import functional as TF

from ...core import rng

__all__ = ["relu", "relu6", "sigmoid", "tanh", "silu", "swish", "mish",
           "tanhshrink", "log_sigmoid", "gelu", "leaky_relu", "prelu", "elu",
           "selu", "celu", "hardtanh", "hardshrink", "softshrink",
           "hardsigmoid", "hardswish", "softplus", "softsign",
           "thresholded_relu", "maxout", "softmax", "log_softmax",
           "gumbel_softmax", "glu", "relu_", "elu_", "softmax_", "tanh_"]


def relu(x, name=None):
    return torch.relu(x)


def relu6(x, name=None):
    return torch.clamp(x, 0.0, 6.0)


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def tanh(x, name=None):
    return torch.tanh(x)


def silu(x, name=None):
    return TF.silu(x)


swish = silu


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def mish(x, name=None):
    return x * torch.tanh(_softplus(x))


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def log_sigmoid(x, name=None):
    return TF.logsigmoid(x)


def gelu(x, approximate=False, name=None):
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def leaky_relu(x, negative_slope=0.01, name=None):
    return torch.where(x >= 0, x, negative_slope * x)


def prelu(x, weight, data_format="NCHW", name=None):
    w = weight
    if w.numel() > 1:
        shape = [1] * x.dim()
        shape[1 if data_format == "NCHW" else x.dim() - 1] = w.numel()
        w = w.reshape(shape)
    return torch.where(x >= 0, x, w * x)


def elu(x, alpha=1.0, name=None):
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    return torch.where(x > 0, x, alpha * torch.expm1(x / alpha))


def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return torch.clamp(x * slope + offset, 0.0, 1.0)


def hardswish(x, name=None):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return torch.where(x * beta > threshold, x, _softplus(x * beta) / beta)


def softsign(x, name=None):
    return x / (x.abs() + 1)


def thresholded_relu(x, threshold=1.0, name=None):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def maxout(x, groups, axis=1, name=None):
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = x.shape[:ax] + (c // groups, groups) + x.shape[ax + 1:]
    return x.reshape(shape).amax(dim=ax + 1)


def _as(x, dtype):
    if dtype is None:
        return x
    return x.to(getattr(torch, dtype) if isinstance(dtype, str) else dtype)


def softmax(x, axis=-1, dtype=None, name=None):
    return torch.softmax(_as(x, dtype), dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    return torch.log_softmax(_as(x, dtype), dim=axis)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    u = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    u.uniform_(torch.finfo(torch.float32).tiny, 1.0,
               generator=rng.generator(x.device))
    g = (-torch.log(-torch.log(u))).to(x.dtype)
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = y_hard - y.detach() + y
    return y


def glu(x, axis=-1, name=None):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def relu_(x, name=None):
    return x.relu_()


def elu_(x, alpha=1.0, name=None):
    return x.copy_(elu(x, alpha))


def softmax_(x, axis=-1, dtype=None, name=None):
    return x.copy_(softmax(x, axis, dtype))


def tanh_(x, name=None):
    return x.tanh_()
