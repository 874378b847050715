"""Convolution functionals (mirrors ``paddle_tpu/nn/functional/conv.py``;
reference: python/paddle/nn/functional/conv.py, kernels
operators/conv_cudnn_op.cu).

The reference lowers every conv to XLA's ``conv_general_dilated``, not to
a Pallas kernel, so the counterpart here is PyTorch's own conv (cuDNN on
the card). What is the reference's and not torch's is kept:

- ``padding`` as ``"SAME"``/``"VALID"`` at any stride (XLA's rule: the
  output is ``ceil(in / stride)``, the total pad split low-first), an
  int, one int per spatial dim, ``2n`` ints ``[l0, r0, l1, r1, ...]`` or
  ``[[l, r], ...]``; an asymmetric pad is applied with ``F.pad`` first;
- channel-last ``data_format`` (``NLC``, ``NHWC``, ``NDHWC``);
- a transpose's weight ``[in, out/groups, *k]``, its pads
  ``(k_eff - 1 - l, k_eff - 1 - r + output_padding)`` around the
  stride-dilated input; string padding raises for a transpose, as in the
  reference.
"""
from __future__ import annotations

from torch.nn import functional as TF

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in (list(v) * n if len(v) == 1 else v))
    return (int(v),) * n


def _padding(padding, n):
    """The reference's ``_padding``: ``"SAME"``/``"VALID"`` or ``n``
    ``(lo, hi)`` pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and not isinstance(padding[0], (list, tuple)):
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    return [tuple(int(q) for q in p) for p in padding]


def _string_pads(mode, in_sizes, windows, strides):
    """XLA's ``padtype_to_pads``: SAME gives ``ceil(in / stride)``
    outputs with the total pad split ``(t // 2, t - t // 2)``."""
    if mode == "VALID":
        return [(0, 0)] * len(in_sizes)
    if mode != "SAME":
        raise ValueError(f"unknown padding {mode!r}: SAME or VALID")
    pads = []
    for size, win, st in zip(in_sizes, windows, strides):
        out = -(-size // st)
        t = max((out - 1) * st + win - size, 0)
        pads.append((t // 2, t - t // 2))
    return pads


def _torch_pad(pairs):
    """``(lo, hi)`` per spatial dim -> ``F.pad``'s last-dim-first list."""
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    return flat


def _conv(x, weight, bias, stride, padding, dilation, groups, n,
          data_format, transpose=False, output_padding=0):
    stride = _tuple(stride, n)
    dilation = _tuple(dilation, n)
    pad_cfg = _padding(padding, n)
    chan_last = not data_format.startswith("NC")
    if chan_last:
        x = x.movedim(-1, 1)
    k = weight.shape[2:]
    k_eff = [(k[i] - 1) * dilation[i] + 1 for i in range(n)]
    if not transpose:
        if isinstance(pad_cfg, str):
            pad_cfg = _string_pads(pad_cfg, x.shape[2:], k_eff, stride)
        if all(lo == hi for lo, hi in pad_cfg):
            out = _CONV[n](x, weight, bias, stride,
                           tuple(lo for lo, _ in pad_cfg), dilation, groups)
        else:
            out = _CONV[n](TF.pad(x, _torch_pad(pad_cfg)), weight, bias,
                           stride, 0, dilation, groups)
    else:
        if isinstance(pad_cfg, str):
            raise ValueError("string padding unsupported for transpose")
        opad = _tuple(output_padding, n)
        # the whole transposed conv ((in-1)·s + k_eff a dim), then each
        # dim cut by (l, r - output_padding), zero-extended where negative
        out = _CONV_T[n](x, weight, None, stride, 0, 0, groups, dilation)
        for d, ((lo, hi), op) in enumerate(zip(pad_cfg, opad)):
            ax = 2 + d
            if lo:
                out = out.narrow(ax, lo, out.shape[ax] - lo)
            cut = hi - op
            if cut > 0:
                out = out.narrow(ax, 0, out.shape[ax] - cut)
            elif cut < 0:
                pad = [0, 0] * (out.dim() - 1 - ax) + [0, -cut]
                out = TF.pad(out, pad)
        if bias is not None:
            out = out + bias.reshape([1, -1] + [1] * n)
    if chan_last:
        out = out.movedim(1, -1)
    return out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 data_format, transpose=True, output_padding=output_padding)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format, transpose=True, output_padding=output_padding)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format, transpose=True, output_padding=output_padding)
