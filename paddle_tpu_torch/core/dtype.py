"""Dtype names (mirrors ``paddle_tpu/core/dtype.py``) for the dtypes this
slice uses, mapped to torch."""
from __future__ import annotations

import torch

float32 = torch.float32
bfloat16 = torch.bfloat16
int8 = torch.int8
int32 = torch.int32
int64 = torch.int64

_ALIASES = {
    "float32": float32, "fp32": float32, "float": float32, "f32": float32,
    "bfloat16": bfloat16, "bf16": bfloat16,
    "int8": int8, "int32": int32, "int64": int64,
}


def convert_dtype(dtype) -> torch.dtype:
    """Normalize a dtype name or ``torch.dtype`` to a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    key = str(dtype).lower()
    if key not in _ALIASES:
        raise ValueError(f"unsupported dtype {dtype!r}; expected one of "
                         f"{sorted(_ALIASES)}")
    return _ALIASES[key]
