"""The reference's ``jax.image.resize`` as weight matrices, for
``interpolate`` and the adaptive pools at sizes that do not divide.

``resize(x, axes, sizes, method)`` resamples each axis in ``axes`` to its
size in ``sizes``: ``"nearest"`` picks ``floor((i + 0.5) · in / out)`` (in
f32), ``"linear"`` and ``"cubic"`` contract the axis with the matrix of
``jax._src.image.scale.compute_weight_mat`` (half-pixel sample points,
the kernel widened by ``in / out`` when downsampling — antialiased —
each column normalised, samples outside the input zeroed), Keys' cubic
at a = -0.5. The matrices are built in numpy f32 from the shapes alone.
"""
from __future__ import annotations

import numpy as np
import torch


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


def weight_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """``[in_size, out_size]`` f32: column j weights input samples for
    output sample j."""
    f32 = np.float32
    scale = f32(out_size) / f32(in_size)
    inv = f32(1.0) / scale
    kscale = max(inv, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kscale
    w = _KERNELS[method](x.astype(f32)).astype(f32)
    tot = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(tot != 0, tot, 1), 0).astype(f32)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def nearest_index(in_size: int, out_size: int) -> np.ndarray:
    off = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(in_size) / np.float32(out_size)
    return np.floor(off.astype(np.float32)).astype(np.int64)


def resize(x: torch.Tensor, axes, sizes, method: str) -> torch.Tensor:
    for ax, n in zip(axes, sizes):
        m = x.shape[ax]
        if m == n:
            continue
        if method == "nearest":
            idx = torch.from_numpy(nearest_index(m, n)).to(x.device)
            x = x.index_select(ax, idx)
            continue
        w = torch.from_numpy(weight_matrix(m, n, method)).to(
            device=x.device, dtype=x.dtype)
        x = torch.tensordot(x.movedim(ax, -1), w, dims=1).movedim(-1, ax)
    return x
