"""Checkpoint save/load (mirrors ``paddle_tpu/framework/io.py:21-51``;
reference: python/paddle/framework/io.py:202,292 — pickled per-tensor
numpy state dicts).

A dict of numpy arrays pickled to disk, the reference's format: a file
written here loads with the JAX package's ``framework.io.load`` and the
reverse. Tensors become numpy arrays on the host; a bf16 tensor is stored
as f32 (numpy has no bf16 without ``ml_dtypes``, which the port does not
need), a value bf16 holds exactly. Sharded, async checkpoints of
training state are ``distributed.checkpoint``'s.
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import torch


def _to_saveable(obj):
    if torch.is_tensor(obj):
        t = obj.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def save(obj: Any, path: str, protocol: int = 4, **configs):
    """paddle.save equivalent."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_saveable(obj), f, protocol=protocol)


def load(path: str, **configs) -> Any:
    """paddle.load equivalent: the numpy-backed state
    (``set_state_dict`` takes numpy)."""
    with open(path, "rb") as f:
        return pickle.load(f)
