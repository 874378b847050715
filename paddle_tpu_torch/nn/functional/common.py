"""Common functionals: linear, dropout, embedding, pad, interpolate ...
(mirrors ``paddle_tpu/nn/functional/common.py``; reference:
python/paddle/nn/functional/common.py, input.py).

Dropout masks come from the device's ``torch.Generator``
(``core.rng``): the same rate and scale as the reference's
(``upscale_in_train`` scales kept values by ``1/(1-p)`` in training;
``downscale_in_infer`` keeps them as they are and scales by ``1-p`` at
inference), not the same bits. ``interpolate`` resamples as the
reference's ``jax.image.resize`` (``_resize.py``): ``"area"`` and every
linear mode are its triangle filter, ``"bicubic"`` Keys' cubic, and
``align_corners`` is accepted and not read, as there.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as TF

from ...core import rng
from . import _resize

__all__ = ["linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "embedding", "one_hot", "label_smooth", "pad", "zeropad2d",
           "interpolate", "upsample", "bilinear", "cosine_similarity",
           "pixel_shuffle", "unfold", "fold"]


def linear(x, weight, bias=None, name=None):
    """``x @ W + b`` with ``W [in, out]``."""
    y = x @ weight
    return y if bias is None else y + bias


def _keep_mask(x, p, shape):
    u = torch.empty(shape, dtype=torch.float32, device=x.device)
    u.uniform_(0.0, 1.0, generator=rng.generator(x.device))
    return u < (1.0 - p)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if axis is None:
        shape = tuple(x.shape)
    else:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = tuple(s if i in axes else 1 for i, s in enumerate(x.shape))
    keep = _keep_mask(x, p, shape)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), zero).to(x.dtype)
    return torch.where(keep, x, zero)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    return dropout(x, p, axis=[0, 1] if data_format == "NCHW" else [0, 3],
                   training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    return dropout(x, p, axis=[0, 1] if data_format == "NCDHW" else [0, 4],
                   training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x
    alpha, scale = 1.6732632423543772, 1.0507009873554805
    alpha_p = -alpha * scale
    keep = _keep_mask(x, p, tuple(x.shape))
    a = (1.0 / ((1.0 - p) * (1.0 + p * alpha_p ** 2)) ** 0.5)
    b = -a * alpha_p * p
    fill = torch.full((), alpha_p, dtype=x.dtype, device=x.device)
    return (a * torch.where(keep, x, fill) + b).to(x.dtype)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at ``x``; rows at ``padding_idx`` (negative:
    from the end) are zero, and so is their gradient."""
    out = weight[x]
    if padding_idx is not None:
        pad = padding_idx if padding_idx >= 0 else weight.shape[0] + \
            padding_idx
        out = torch.where((x == pad)[..., None], torch.zeros_like(out), out)
    return out


def one_hot(x, num_classes, name=None):
    return TF.one_hot(x.long(), num_classes).float()


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def _pad_index(n, lo, hi, mode):
    """Source index of every padded position along an axis of size n."""
    i = np.arange(-lo, n + hi)
    if mode == "replicate":
        return np.clip(i, 0, n - 1)
    if mode == "circular":
        return np.mod(i, n)
    period = 2 * (n - 1)                 # reflect, the edge not repeated
    j = np.mod(i, period) if period else np.zeros_like(i)
    return np.where(j >= n, period - j, j)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",  # noqa: A002
        name=None):
    """The reference's ``pad``: an int pads every dim; ``2·ndim`` ints
    pad each dim from the first; else the pairs pad the spatial dims
    innermost first (``[left, right, top, bottom, front, back]``).
    Modes ``constant``, ``reflect``, ``replicate`` and ``circular``."""
    pad = [int(p) for p in pad] if not isinstance(pad, int) else pad
    nd = x.dim()
    if isinstance(pad, int):
        cfg = [(pad, pad)] * nd
    elif len(pad) == 2 * nd:
        cfg = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        cfg = [(0, 0)] * nd
        spatial = list(range(2, nd)) if data_format.startswith("NC") else \
            list(range(1, nd - 1))
        pairs = [(pad[2 * i], pad[2 * i + 1]) for i in range(len(pad) // 2)]
        for ax, pr in zip(reversed(spatial), pairs):
            cfg[ax] = pr
    if mode == "constant":
        flat = []
        for lo, hi in reversed(cfg):
            flat += [lo, hi]
        return TF.pad(x, flat, value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise ValueError(f"unknown pad mode {mode!r}")
    for ax, (lo, hi) in enumerate(cfg):
        if lo or hi:
            idx = torch.from_numpy(_pad_index(x.shape[ax], lo, hi, mode))
            x = x.index_select(ax, idx.to(x.device))
    return x


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


_METHOD = {"nearest": "nearest", "bilinear": "linear", "bicubic": "cubic",
           "trilinear": "linear", "linear": "linear", "area": "linear"}


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    method = _METHOD[mode]
    chan_last = not data_format.startswith("NC")
    axes = list(range(1, x.dim() - 1)) if chan_last else \
        list(range(2, x.dim()))
    if size is not None:
        tgt = [int(s) for s in (size if isinstance(size, (list, tuple))
                                else [size])]
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) else \
            [scale_factor] * len(axes)
        tgt = [int(x.shape[ax] * s) for ax, s in zip(axes, sf)]
    return _resize.resize(x, axes, tgt, method)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def bilinear(x1, x2, weight, bias=None, name=None):
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    num = (x1 * x2).sum(dim=axis)
    den = torch.linalg.vector_norm(x1, dim=axis) * \
        torch.linalg.vector_norm(x2, dim=axis)
    return num / torch.clamp(den, min=eps)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    if data_format == "NCHW":
        b, c, h, w = x.shape
        v = x.reshape(b, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return v.reshape(b, c // (r * r), h * r, w * r)
    b, h, w, c = x.shape
    v = x.reshape(b, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return v.reshape(b, h * r, w * r, c // (r * r))


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[B, C·kh·kw, L]``, channel major."""
    return TF.unfold(x, _pair(kernel_sizes), _pair(dilations),
                     _pair(paddings), _pair(strides))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the transpose of ``unfold``: overlapping patches sum."""
    return TF.fold(x, _pair(output_sizes), _pair(kernel_sizes),
                   _pair(dilations), _pair(paddings), _pair(strides))
