"""Pooling functionals (mirrors ``paddle_tpu/nn/functional/pooling.py``;
reference: python/paddle/nn/functional/pooling.py).

Kept from the reference, where torch differs:

- ``exclusive=True`` (the default of the average pools) divides each
  window by the count of its positions inside the input, torch's
  ``count_include_pad=False``; with ``"SAME"``/``"VALID"`` padding the
  reference divides by the whole window, and so does the port;
- padding takes the conv forms (``"SAME"``, ``"VALID"``, per-dim and
  asymmetric pairs), applied with ``F.pad`` (``-inf`` for max) where torch
  takes no such pad;
- ``ceil_mode`` is accepted and not read, and ``avg_pool2d/3d`` drop
  ``divisor_override``: the reference's output shapes and values;
- the adaptive average pools at sizes that do not divide the input
  resample it as the reference's ``jax.image.resize(..., "linear")``
  does in 1-D and 2-D (``_resize.py``), and average the reference's bins
  ``[floor(i·L/o), ceil((i+1)·L/o))`` in 3-D; the adaptive max pools
  need sizes that divide, as in the reference.
"""
from __future__ import annotations

import torch
from torch.nn import functional as TF

from . import _resize
from .conv import _padding, _string_pads, _torch_pad, _tuple

__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d"]

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}


def _pool(x, kernel, stride, padding, n, data_format, average,
          exclusive=True):
    kernel = _tuple(kernel, n)
    stride = _tuple(stride if stride is not None else kernel, n)
    pad_cfg = _padding(padding, n)
    chan_last = not data_format.startswith("NC")
    if chan_last:
        x = x.movedim(-1, 1)
    string = isinstance(pad_cfg, str)
    pads = _string_pads(pad_cfg, x.shape[2:], kernel, stride) if string \
        else pad_cfg
    native = all(lo == hi and 2 * lo <= k for (lo, hi), k in
                 zip(pads, kernel))
    count_pad = string or not exclusive
    if not average:
        if native:
            out = _MAX[n](x, kernel, stride, tuple(lo for lo, _ in pads))
        else:
            fill = float("-inf") if x.is_floating_point() else \
                torch.iinfo(x.dtype).min
            out = _MAX[n](TF.pad(x, _torch_pad(pads), value=fill), kernel,
                          stride)
    elif native:
        out = _AVG[n](x, kernel, stride, tuple(lo for lo, _ in pads),
                      count_include_pad=count_pad)
    else:
        xp = TF.pad(x, _torch_pad(pads))
        out = _AVG[n](xp, kernel, stride)
        if not count_pad:
            ones = TF.pad(torch.ones_like(x[:1, :1]), _torch_pad(pads))
            out = out / _AVG[n](ones, kernel, stride)
    if chan_last:
        out = out.movedim(1, -1)
    return out


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, kernel_size, stride, padding, 1, data_format, False)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _pool(x, kernel_size, stride, padding, 2, data_format, False)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _pool(x, kernel_size, stride, padding, 3, data_format, False)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, kernel_size, stride, padding, 1, data_format, True,
                 exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 2, data_format, True,
                 exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, data_format, True,
                 exclusive)


def _divides(sizes, outs):
    return all(s % o == 0 for s, o in zip(sizes, outs))


def adaptive_avg_pool1d(x, output_size, name=None):
    o = int(output_size)
    if x.shape[-1] % o == 0:
        return TF.adaptive_avg_pool1d(x, o)
    return _resize.resize(x, (2,), (o,), "linear")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    out_hw = _tuple(output_size, 2)
    chan_last = not data_format.startswith("NC")
    axes = (1, 2) if chan_last else (2, 3)
    sizes = tuple(x.shape[a] for a in axes)
    if _divides(sizes, out_hw):
        v = x.movedim(-1, 1) if chan_last else x
        out = TF.adaptive_avg_pool2d(v, out_hw)
        return out.movedim(1, -1) if chan_last else out
    return _resize.resize(x, axes, out_hw, "linear")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    out = _tuple(output_size, 3)
    chan_last = not data_format.startswith("NC")
    v = x.movedim(-1, 1) if chan_last else x
    y = TF.adaptive_avg_pool3d(v, out)
    return y.movedim(1, -1) if chan_last else y


def _adaptive_max(x, output_size, n):
    out = _tuple(output_size, n)
    if not _divides(x.shape[2:], out):
        raise NotImplementedError(
            f"adaptive_max_pool{n}d requires output_size to divide the "
            "spatial dims (general sizes: use adaptive_avg_pool)")
    return {1: TF.adaptive_max_pool1d, 2: TF.adaptive_max_pool2d,
            3: TF.adaptive_max_pool3d}[n](x, out)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_max(x, output_size, 1)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_max(x, output_size, 2)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_max(x, output_size, 3)
