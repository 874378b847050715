"""Fused int8 matmul: quantize -> int8 x int8 -> int32 product ->
dequant / bias / activation epilogue in one kernel (mirrors
``paddle_tpu/ops/int8_matmul.py``).

``int8_matmul`` computes ``epilogue(quantize(x) @ wq)`` and
``int8_linear_fused`` folds ``Int8Linear``'s scales into it. On a CUDA
tensor ``int8_matmul`` launches ``csrc/int8_matmul.cu`` (the port of the
TPU kernel ``_kernel``) by one of two routes, chosen by shape before the
launch (``_mm_route``):

- ``wgmma`` (K a multiple of 16, 16-byte aligned operands): a float x is
  quantized once by ``quantize_x`` (``INT8_QUANTIZE_LAUNCHES``), then the
  TMA-fed wgmma kernel multiplies ``xq`` by wq in its K-major form
  ``[N, K]`` (``INT8_MATMUL_WGMMA_LAUNCHES``). ``Int8Linear`` keeps that
  copy of its weight; a bare call makes one;
- ``mma`` (any other shape): the mma.sync kernel, which quantizes x while
  it stages it and reads wq ``[K, N]`` as it is
  (``INT8_MATMUL_LAUNCHES``).

On a CPU tensor it runs the plain version ``_plain_int8_matmul`` — the
same function for every flag (float or int8 ``x``, ``relu``,
``quant_out``, ``out_dtype``). Nothing selects the plain version for a
CUDA tensor, and no route falls back to another.

``scale``, ``bias`` and ``qscale`` are tensors on ``x``'s device (an
activation scale is a buffer of its layer): nothing here reads a device
value on the host.

``int8_matmul_cost`` and ``int8_quantize_cost`` give each kernel's work
(FLOPs, bytes): the bound ``chip_smoke.py`` reports, and what each launch
adds to a counted program (``profiler/program_stats.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..profiler import program_stats as _pstats
from . import _cuda

__all__ = ["int8_matmul", "int8_linear_fused", "quantize_x",
           "int8_matmul_cost", "int8_quantize_cost",
           "INT8_MATMUL_LAUNCHES", "INT8_MATMUL_WGMMA_LAUNCHES",
           "INT8_QUANTIZE_LAUNCHES"]

#: launches of the mma route's kernel (incremented once per launch,
#: nowhere else)
INT8_MATMUL_LAUNCHES = 0
#: launches of the wgmma route's product kernel
INT8_MATMUL_WGMMA_LAUNCHES = 0
#: launches of the wgmma route's x-quantize pass (``quantize_x``)
INT8_QUANTIZE_LAUNCHES = 0

#: TMA reads rows whose stride is a multiple of 16 bytes from 16-byte
#: aligned bases
_TMA_ALIGN = 16

#: K values summed per exact f32 product of the plain version:
#: 127 * 127 * 1024 < 2**24, so every partial sum is an exact integer
_EXACT_K = 1024


def _exact_int_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``xq [M, K] @ wq [K, N]`` of int8 values as int32, exactly.
    PyTorch has no integer matmul on a card (``torch._int_mm`` is a
    library kernel, the yardstick only) and an f32 product is inexact past
    2**24, so the product runs in f32 over K chunks short enough to stay
    exact and the chunks are summed in int32 — on every device."""
    acc = torch.zeros(xq.shape[0], wq.shape[1], dtype=torch.int32,
                      device=xq.device)
    for k0 in range(0, xq.shape[1], _EXACT_K):
        part = xq[:, k0:k0 + _EXACT_K].float() @ \
            wq[k0:k0 + _EXACT_K].float()
        acc += part.to(torch.int32)
    return acc


def _plain_quantize_x(x, qscale, amax):
    """The quantize pass's plain version: ``clip(round(f32(x) * qscale),
    +-amax)`` as int8, one f32 product rounded half to even."""
    return torch.round(x.float() * qscale).clamp_(-amax, amax) \
        .to(torch.int8)


def _plain_int8_matmul(x, wq, scale, bias, qscale, relu, quant_out,
                       out_dtype, amax):
    """The plain version: the kernel's function in PyTorch operations.
    ``f32(acc) * scale + bias`` is two separately rounded operations, as
    in the kernel, so the requantized outputs agree bit for bit."""
    xq = x if x.dtype == torch.int8 else _plain_quantize_x(x, qscale, amax)
    y = _exact_int_matmul(xq, wq).float() * scale
    if bias is not None:
        y = y + bias
    if relu:
        y = torch.relu(y)
    if quant_out:
        return torch.round(y).clamp_(-amax, amax).to(torch.int8)
    return y.to(out_dtype)


def _mm_route(x, wq_kn=None) -> str:
    """The CUDA route of an ``int8_matmul`` over ``x [M, K]``: ``"wgmma"``
    when TMA can read both operands (K a multiple of 16, and the bases
    it reads 16-byte aligned: an int8 x itself, and ``wq_kn`` when the
    caller gives the K-major copy; a float x is read through its fresh
    quantized copy, a missing ``wq_kn`` made fresh), else ``"mma"``."""
    if x.shape[1] % _TMA_ALIGN:
        return "mma"
    read = [t for t in ((x if x.dtype == torch.int8 else None), wq_kn)
            if t is not None]
    if any(t.data_ptr() % _TMA_ALIGN for t in read):
        return "mma"
    return "wgmma"


def int8_matmul_cost(x, out, k: int, n: int, has_bias: bool):
    """(FLOPs, bytes) of one fused product of ``x [M, K]`` (float or
    int8) by an int8 ``[K, N]`` weight into ``out [M, N]``: 2·M·K·N
    operations; x, the weight and the output once each, the f32 scale
    (and bias) vectors and the one-element qscale."""
    m = x.numel() // k
    nbytes = (x.numel() * x.element_size() + k * n
              + out.numel() * out.element_size()
              + 4 * n * (2 if has_bias else 1) + 4)
    return 2.0 * m * k * n, nbytes


def int8_quantize_cost(x):
    """(FLOPs, bytes) of the quantize pass over ``x``: a product, a
    rounding and a clip an element; x read, int8 written, qscale."""
    return 3.0 * x.numel(), x.numel() * (x.element_size() + 1) + 4


def quantize_x(x, qscale, amax: float = 127.0):
    """``clip(round(f32(x) * qscale), +-amax)`` as int8 ``[M, K]``, round
    half to even: the wgmma route's quantize pass (each element once). On
    a CUDA tensor the kernel ``int8_quantize`` of ``csrc/int8_matmul.cu``,
    on a CPU tensor the plain version."""
    if x.dtype not in _cuda.DTYPE_CODE:
        raise TypeError(f"quantize_x: x must be f32 or bf16, got {x.dtype}")
    if x.device.type == "cpu":
        return _plain_quantize_x(x, qscale, float(amax))
    global INT8_QUANTIZE_LAUNCHES
    name = "quantize_x"
    _cuda.check_cuda(name, (x, qscale), x.device)
    xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    fn = _cuda.entry("int8_matmul", "int8_quantize", "ppplifp")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), qscale.data_ptr(), xq.data_ptr(), x.numel(),
                 _cuda.DTYPE_CODE[x.dtype], float(amax),
                 _cuda.stream_handle(x.device))
    _cuda.raise_on_error(name, err)
    INT8_QUANTIZE_LAUNCHES += 1
    if _pstats.ACTIVE is not None:
        _pstats.note_kernel("int8_quantize", int8_quantize_cost, x)
    return xq


def int8_matmul(x, wq, scale, bias=None, qscale=None, *,
                relu: bool = False, quant_out: bool = False,
                out_dtype=torch.float32, amax: float = 127.0, wq_kn=None):
    """y = dequant(quantize(x) @ wq) [+ bias] [relu] [requantize].

    x:      [M, K] f32/bf16 (quantized in the kernel with ``qscale``:
            ``clip(round(x * qscale), +-amax)``, round half to even) or
            int8 (pre-quantized; ``qscale`` ignored).
    wq:     [K, N] int8.
    scale:  [N] f32 — combined dequant scale applied to the int32
            accumulator (the caller folds (s_act/amax)*(s_w/wmax) and, for
            ``quant_out``, the next layer's amax/s_act into it).
    bias:   optional [N] f32, added after the scale (before the ReLU).
    qscale: f32 tensor of one element; required for a float ``x``.
    quant_out: emit int8 (``clip(round(y))``) for a following int8 layer.
    out_dtype: f32 or bf16, the type of a float output.
    wq_kn:  optional [N, K] int8, ``wq.T.contiguous()`` kept by the caller
            (the wgmma route reads wq K-major; without it a copy is made
            per call). Never read on the CPU.

    Any M, K, N: ragged edges are handled in the kernel, nothing is
    padded. Returns [M, N].
    """
    name = "int8_matmul"
    if x.dim() != 2 or wq.dim() != 2 or x.shape[1] != wq.shape[0]:
        raise ValueError(f"{name}: x [M, K] and wq [K, N] expected, got "
                         f"{tuple(x.shape)} and {tuple(wq.shape)}")
    if x.dtype not in _cuda.STORAGE_DTYPE_CODE or wq.dtype != torch.int8:
        raise TypeError(f"{name}: x must be f32, bf16 or int8 and wq int8, "
                        f"got {x.dtype} and {wq.dtype}")
    if out_dtype not in _cuda.DTYPE_CODE:
        raise TypeError(f"{name}: out_dtype must be f32 or bf16, got "
                        f"{out_dtype}")
    m, n = x.shape[0], wq.shape[1]
    x_float = x.dtype != torch.int8
    if x_float and qscale is None:
        raise ValueError(f"{name}: a float x needs qscale")
    vectors = [("scale", scale, n)]
    if bias is not None:
        vectors.append(("bias", bias, n))
    if x_float:
        vectors.append(("qscale", qscale, 1))
    for what, t, numel in vectors:
        if t.dtype != torch.float32 or t.numel() != numel:
            raise TypeError(f"{name}: {what} must be f32 with {numel} "
                            f"element(s), got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name}: {what} is on {t.device}, x on "
                             f"{x.device}")
    if wq.device != x.device:
        raise ValueError(f"{name}: wq is on {wq.device}, x on {x.device}")
    if wq_kn is not None and (wq_kn.dtype != torch.int8 or
                              tuple(wq_kn.shape) != (n, wq.shape[0]) or
                              wq_kn.device != x.device):
        raise ValueError(f"{name}: wq_kn must be int8 [N, K] = "
                         f"{(n, wq.shape[0])} on {x.device}, got "
                         f"{wq_kn.dtype} {tuple(wq_kn.shape)} on "
                         f"{wq_kn.device}")
    if x.device.type == "cpu":
        return _plain_int8_matmul(x, wq, scale.reshape(-1),
                                  None if bias is None else bias.reshape(-1),
                                  qscale, relu, quant_out, out_dtype,
                                  float(amax))
    return _int8_matmul_cuda(x, wq, scale, bias, qscale if x_float else None,
                             relu, quant_out, out_dtype, float(amax),
                             wq_kn=wq_kn)


def _int8_matmul_cuda(x, wq, scale, bias, qscale, relu, quant_out,
                      out_dtype, amax, wq_kn=None):
    dev = x.device
    name = "int8_matmul"
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    tensors = [t for t in (x, wq, scale, bias, qscale, wq_kn)
               if t is not None]
    _cuda.check_cuda(name, tensors, dev)
    if _mm_route(x, wq_kn) == "wgmma":
        return _mm_wgmma(x, wq.t().contiguous() if wq_kn is None else wq_kn,
                         scale, bias, qscale, relu, quant_out, out_dtype,
                         amax)
    return _mm_mma(x, wq, scale, bias, qscale, relu, quant_out, out_dtype,
                   amax)


def _mm_wgmma(x, wq_kn, scale, bias, qscale, relu, quant_out, out_dtype,
              amax):
    """The wgmma route: x quantized once (a float x), then the product
    over ``wq_kn [N, K]``."""
    global INT8_MATMUL_WGMMA_LAUNCHES
    dev = x.device
    name = "int8_matmul_wgmma"
    xq = x if x.dtype == torch.int8 else quantize_x(x, qscale, amax)
    m, k = x.shape
    n = wq_kn.shape[0]
    odt = torch.int8 if quant_out else out_dtype
    out = torch.empty(m, n, dtype=odt, device=dev)
    fn = _cuda.entry("int8_matmul", name, "pppppiiiifip")
    with torch.cuda.device(dev):
        err = fn(xq.data_ptr(), wq_kn.data_ptr(), scale.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 m, k, n, _cuda.STORAGE_DTYPE_CODE[odt], amax,
                 int(bool(relu)), _cuda.stream_handle(dev))
    _cuda.raise_on_error(name, err)
    INT8_MATMUL_WGMMA_LAUNCHES += 1
    if _pstats.ACTIVE is not None:
        _pstats.note_kernel(name, int8_matmul_cost, xq, out, k, n,
                            bias is not None)
    return out


def _mm_mma(x, wq, scale, bias, qscale, relu, quant_out, out_dtype, amax):
    """The mma route: the mma.sync kernel over wq ``[K, N]``, x quantized
    while it is staged."""
    global INT8_MATMUL_LAUNCHES
    dev = x.device
    name = "int8_matmul"
    m, k = x.shape
    n = wq.shape[1]
    odt = torch.int8 if quant_out else out_dtype
    out = torch.empty(m, n, dtype=odt, device=dev)
    fn = _cuda.entry(name, name, "ppppppiiiiifip")
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), wq.data_ptr(),
                 None if qscale is None else qscale.data_ptr(),
                 scale.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 m, k, n, _cuda.STORAGE_DTYPE_CODE[x.dtype],
                 _cuda.STORAGE_DTYPE_CODE[odt], amax, int(bool(relu)),
                 _cuda.stream_handle(dev))
    _cuda.raise_on_error(name, err)
    INT8_MATMUL_LAUNCHES += 1
    if _pstats.ACTIVE is not None:
        _pstats.note_kernel(name, int8_matmul_cost, x, out, k, n,
                            bias is not None)
    return out


def int8_linear_fused(x, wq, w_scale, act_scale, bias=None, *,
                      wmax: float = 127.0, amax: float = 127.0,
                      relu: bool = False,
                      next_act_scale: Optional[torch.Tensor] = None,
                      out_dtype=torch.float32, wq_kn=None):
    """``Int8Linear``'s math through the fused kernel.

    Folds the per-channel dequant (and, when ``next_act_scale`` is given,
    the next layer's activation quantization) into the kernel epilogue:

        y   = (xq @ wq) * (s_a/amax) * (s_w/wmax) + b          (f32)
        yq  = clip(round(y * amax/s_a'))                       (int8)

    x may be f32/bf16 (quantized in the kernel) or int8 (the output of a
    previous ``next_act_scale`` layer). ``w_scale [N]``, ``act_scale`` and
    ``next_act_scale`` (one element each) are f32 tensors on x's device.
    ``wq_kn``: the caller's K-major copy of ``wq`` (``int8_matmul``).
    """
    sa = act_scale.float().clamp_min(1e-8)
    ws = w_scale.float().clamp_min(1e-8)
    scale = (sa / amax) * (ws / wmax)
    b = None if bias is None else bias.float()
    quant_out = next_act_scale is not None
    if quant_out:
        nq = amax / next_act_scale.float().clamp_min(1e-8)
        scale = scale * nq
        if b is not None:
            b = b * nq
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    y = int8_matmul(x2, wq, scale.reshape(-1).contiguous(),
                    None if b is None else b.reshape(-1).contiguous(),
                    qscale=(amax / sa).reshape(1), relu=relu,
                    quant_out=quant_out, out_dtype=out_dtype, amax=amax,
                    wq_kn=wq_kn)
    return y.reshape(lead + (wq.shape[1],))
