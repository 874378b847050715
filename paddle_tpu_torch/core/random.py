"""Counter-based random numbers bit-equal to ``jax.random`` (threefry).

The JAX package defines its sampling law through ``jax.random`` keys: a
request's key is folded by the absolute position of the token it emits,
so a stream does not depend on scheduling. This module is a copy of the
parts the package calls, written in integer tensor ops, so it gives the
same bits as JAX on the CPU and the same bits again on a card:

- ``PRNGKey(seed)``: ``threefry_seed``, the key ``(seed >> 32, seed &
  0xFFFFFFFF)``;
- ``fold_in(keys, data)``: threefry-2x32 of the counter pair ``(0,
  data)``;
- ``split(keys, num)``: key ``i`` is ``threefry(key, (0, i))``, both
  words (``_threefry_split_foldlike``);
- ``bits(keys, shape)``: 32-bit words ``x0 ^ x1`` of threefry over the
  flat row-major index split into hi and lo words
  (``_threefry_random_bits_partitionable``);
- ``uniform``, ``gumbel`` (mode "low") and ``categorical`` (the Gumbel
  max trick, with replacement) on those bits.

This follows jax 0.9 with ``jax_threefry_partitionable`` True and
``use_high_dynamic_range_gumbel`` False (``tests/test_torch_random.py``
checks both, and the bits, against the installed jax).

A key is an int64 tensor ``[..., 2]`` holding two uint32 words (torch's
uint32 has few ops on CUDA). Every function takes a batch of keys: keys
``[N, 2]`` and positions ``[N]`` give ``N`` folded keys at once, and
``bits(keys [N, 2], (V,))`` gives ``[N, V]``, each row drawn from its
own key, which is what ``jax.vmap`` over the rows gives. Every word is
kept in ``[0, 2**32)``, so int64's arithmetic ``>>`` acts as a logical
shift. ``uniform`` is bit-equal to JAX's; ``gumbel`` applies torch's
``log``, which may differ from XLA's by an ulp.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from .place import DeviceLike, resolve_device

__all__ = ["PRNGKey", "fold_in", "split", "bits", "uniform", "gumbel",
           "categorical", "as_key", "key_to_numpy"]

MASK = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

KeyLike = Union[torch.Tensor, np.ndarray, Sequence[int]]


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32, 20 rounds (Salmon et al., SC'11), elementwise over
    broadcastable int64 tensors of uint32 words. Returns ``(y0, y1)``."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def as_key(key: KeyLike, device: DeviceLike = None) -> torch.Tensor:
    """A key (or batch of keys) as the int64 ``[..., 2]`` tensor this
    module takes: from a tensor (kept on its device unless ``device`` is
    named), or a numpy uint32 array as the JAX package keeps its keys
    (placed on ``device``: the card unless the caller names the CPU)."""
    if isinstance(key, torch.Tensor):
        t = key.to(device=device) if device is not None else key
        return t.long() & MASK
    arr = np.asarray(key).astype(np.int64) & MASK
    return torch.as_tensor(arr, device=resolve_device(device))


def key_to_numpy(key: torch.Tensor) -> np.ndarray:
    """The uint32 numpy form of a key (or batch), as ``jax.random`` keys
    are stored."""
    return key.detach().cpu().numpy().astype(np.uint32)


def PRNGKey(seed: int,  # noqa: N802
            device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: ``[2]`` int64 on ``device`` (the card
    unless the caller names the CPU). The seed is taken as jax takes a
    Python int without 64-bit mode: its low 32 bits (two's complement
    for a negative seed) under a high word of 0."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=resolve_device(device))


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a batch: ``keys [..., 2]`` and ``data``
    (an int or an int tensor broadcastable to ``keys.shape[:-1]``) give
    ``[*broadcast, 2]``."""
    if isinstance(data, (int, np.integer)):
        # filled on the device: a tensor copied from the host would wait
        # for the stream
        data = keys.new_full((), int(data))
    elif not isinstance(data, torch.Tensor):
        data = torch.as_tensor(data, dtype=torch.int64, device=keys.device)
    data = data.to(keys.device).long() & MASK
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def _counters(shape: Sequence[int], device):
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``keys [..., 2]`` -> ``[..., num, 2]``."""
    hi, lo = _counters((num,), keys.device)
    y0, y1 = threefry2x32(keys[..., 0, None], keys[..., 1, None], hi, lo)
    return torch.stack([y0, y1], dim=-1)


def bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits`` (32-bit) for each key: ``[*keys.shape[:-1],
    *shape]`` int64 holding uint32 values."""
    shape = tuple(int(s) for s in shape)
    batch = keys.shape[:-1]
    hi, lo = _counters(shape, keys.device)
    k1 = keys[..., 0].reshape(tuple(batch) + (1,))
    k2 = keys[..., 1].reshape(tuple(batch) + (1,))
    y0, y1 = threefry2x32(k1, k2, hi, lo)
    return (y0 ^ y1).reshape(tuple(batch) + shape)


def uniform(keys: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32, bit-equal: 23 random mantissa bits
    under exponent 0 (``[1, 2)``), minus 1, scaled to ``[minval,
    maxval)`` with one rounding (XLA fuses the scale and shift into an
    FMA; so does ``addcmul``) and clamped below at ``minval``."""
    b = bits(keys, shape)
    one = (b >> 9) | 0x3F800000          # < 2**31: exact in int32
    f = one.to(torch.int32).view(torch.float32) - 1.0
    # the bounds are filled on the device: a tensor copied from the host
    # would wait for the stream, and with it for the tick that made the
    # logits
    lo = f.new_full((), minval)
    hi = f.new_full((), maxval)
    return torch.maximum(lo, torch.addcmul(lo, f, hi - lo))


def gumbel(keys: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.gumbel`` in f32, mode "low": ``-log(-log(u))`` with
    ``u`` uniform on ``[tiny, 1)``."""
    tiny = float(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(uniform(keys, shape, tiny, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (with replacement):
    ``argmax(gumbel + logits)``. The keys' batch dims lead ``logits``;
    each key draws the rest of its shape, so one key ``[2]`` over
    ``[N, V]`` logits is ``categorical(key, logits)`` and keys ``[N, 2]``
    over ``[N, V]`` are ``vmap(categorical)`` row by row."""
    nb = keys.dim() - 1
    if tuple(keys.shape[:-1]) != tuple(logits.shape[:nb]):
        raise ValueError(f"keys {tuple(keys.shape)} do not lead logits "
                         f"{tuple(logits.shape)}")
    g = gumbel(keys, logits.shape[nb:])
    return torch.argmax(g + logits, dim=-1)
