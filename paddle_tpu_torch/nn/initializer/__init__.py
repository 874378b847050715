"""Parameter initializers (mirrors ``paddle_tpu/nn/initializer``).

Each initializer fills a tensor in place from an explicit
``torch.Generator`` — by default the generator of the tensor's device
(``core.rng.generator``), so ``seed(n)`` makes model construction
reproducible per device. The draws are not the reference's (threefry
keys there, Philox here): the distributions, bounds and fan rules are.
``Constant``, ``Assign`` and ``Dirac`` draw nothing and equal the
reference's values exactly.

Fans follow the reference's ``_fans``: a 2-D weight is a Linear's
``[in, out]``; a conv kernel ``[out, in/groups, *k]`` has fan-in
``in/groups · prod(k)`` and fan-out ``out · prod(k)``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ...core import rng


def calculate_gain(nonlinearity, param=None):
    """The recommended gain of ``nonlinearity`` (the reference's table)."""
    recommended = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    if nonlinearity not in recommended:
        raise ValueError(f"Unsupported nonlinearity: {nonlinearity}")
    return recommended[nonlinearity]


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        # Linear weights are [in, out] in paddle convention.
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __call__(self, t: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        raise NotImplementedError

    @staticmethod
    def _gen(t, generator):
        return generator if generator is not None else rng.generator(t.device)


class Normal(Initializer):
    """N(mean, std) draws."""

    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean = float(mean)
        self.std = float(std)

    def __call__(self, t, generator=None):
        with torch.no_grad():
            return t.normal_(self.mean, self.std,
                             generator=self._gen(t, generator))


class Constant(Initializer):
    """Every element ``value`` (draws nothing)."""

    def __init__(self, value: float = 0.0):
        self.value = float(value)

    def __call__(self, t, generator=None):
        with torch.no_grad():
            return t.fill_(self.value)


class TruncatedNormal(Initializer):
    """N(mean, std) truncated to ``mean ± 2·std`` (the reference's
    ``truncated_normal(-2, 2)``): inverse-CDF draws."""

    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean = float(mean)
        self.std = float(std)

    def __call__(self, t, generator=None):
        lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
        hi = 1.0 - lo
        with torch.no_grad():
            u = torch.empty(t.shape, dtype=torch.float32, device=t.device)
            u.uniform_(2 * lo - 1, 2 * hi - 1,
                       generator=self._gen(t, generator))
            z = torch.erfinv(u).mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
            return t.copy_(z * self.std + self.mean)


class Uniform(Initializer):
    """U[low, high) draws."""

    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low = float(low)
        self.high = float(high)

    def __call__(self, t, generator=None):
        with torch.no_grad():
            return t.uniform_(self.low, self.high,
                              generator=self._gen(t, generator))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, t, generator=None):
        fi, fo = _fans(t.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        return Normal(0.0, self.gain * math.sqrt(2.0 / (fi + fo)))(
            t, generator)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, t, generator=None):
        fi, fo = _fans(t.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(t, generator)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, t, generator=None):
        fi, _ = _fans(t.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return Normal(0.0, gain / math.sqrt(fi))(t, generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, t, generator=None):
        fi, _ = _fans(t.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(t, generator)


class Assign(Initializer):
    """The given values (an array, list or tensor), reshaped to the
    parameter's shape."""

    def __init__(self, value):
        self.value = value

    def __call__(self, t, generator=None):
        v = self.value
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        with torch.no_grad():
            return t.copy_(torch.from_numpy(
                np.ascontiguousarray(v).reshape(tuple(t.shape))).to(t.dtype))


class Orthogonal(Initializer):
    """A (semi-)orthogonal matrix over ``[prod(shape[:-1]), shape[-1]]``
    times ``gain``: the QR of a normal draw with R's diagonal signs folded
    in, as ``jax.nn.initializers.orthogonal``."""

    def __init__(self, gain=1.0):
        self.gain = float(gain)

    def __call__(self, t, generator=None):
        n_cols = int(t.shape[-1]) if t.dim() else 1
        n_rows = int(t.numel() // max(n_cols, 1))
        shape = (n_cols, n_rows) if n_rows < n_cols else (n_rows, n_cols)
        with torch.no_grad():
            a = torch.empty(shape, dtype=torch.float32, device=t.device)
            a.normal_(0.0, 1.0, generator=self._gen(t, generator))
            q, r = torch.linalg.qr(a)
            q = q * torch.sign(torch.diagonal(r))
            if n_rows < n_cols:
                q = q.t()
            return t.copy_((q * self.gain).reshape(t.shape))


class Dirac(Initializer):
    """The identity kernel: ``w[i, i % in, centre] = 1`` for
    ``i < min(out, in·groups)``, zero elsewhere."""

    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, t, generator=None):
        shape = tuple(t.shape)
        out = np.zeros(shape, np.float32)
        oc, ic = shape[0], shape[1]
        centre = tuple(s // 2 for s in shape[2:])
        for i in range(min(oc, ic * self.groups)):
            out[(i, i % ic) + centre] = 1.0
        with torch.no_grad():
            return t.copy_(torch.from_numpy(out).to(t.dtype))


# paddle legacy-name aliases (fluid.initializer)
ConstantInitializer = Constant
NormalInitializer = Normal
TruncatedNormalInitializer = TruncatedNormal
UniformInitializer = Uniform
XavierInitializer = XavierNormal
MSRAInitializer = KaimingNormal
NumpyArrayInitializer = Assign

__all__ = ["Initializer", "Normal", "Constant", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal",
           "KaimingUniform", "Assign", "Orthogonal", "Dirac",
           "calculate_gain", "ConstantInitializer", "NormalInitializer",
           "TruncatedNormalInitializer", "UniformInitializer",
           "XavierInitializer", "MSRAInitializer", "NumpyArrayInitializer"]
