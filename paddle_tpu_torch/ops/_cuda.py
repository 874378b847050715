"""Small helpers shared by the kernel wrappers (no counterpart in the JAX
package): dtype codes of the C interface, argument checks, and the
``ctypes`` binding of a kernel's C entry."""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build

#: dtype codes of the kernels' C interface (csrc/common.cuh DtypeCode):
#: the float types every kernel computes in ...
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: ... and those plus int8, the storage type of quantized operands (KV page
#: pools with per-page scales; x, wq and the requantized output of the
#: int8 matmul)
STORAGE_DTYPE_CODE = {**DTYPE_CODE, torch.int8: 2}

_VP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_CTYPES = {"p": _VP, "i": _INT, "f": _FLOAT}


def entry(lib_name: str, fn_name: str, signature: str):
    """The C function ``fn_name`` of kernel library ``lib_name`` with its
    ``argtypes`` set from ``signature`` (one letter per argument: ``p``
    pointer or stream, ``i`` int, ``f`` float) and an ``int`` (the
    ``cudaError_t``) result. Builds the kernels on first use."""
    fn = getattr(_build.load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = [_CTYPES[c] for c in signature]
        fn.restype = _INT
    return fn


def check_cuda(name: str, tensors: Sequence[torch.Tensor],
               device: torch.device) -> None:
    """Every tensor on ``device`` (a CUDA device) and contiguous."""
    for i, t in enumerate(tensors):
        if t.device != device:
            raise ValueError(f"{name}: argument {i} is on {t.device}, "
                             f"expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} must be contiguous")


def raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError_t {err}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
