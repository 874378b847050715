"""Flash attention forward (mirrors ``paddle_tpu/ops/flash_attention.py``).

``flash_attention(q, k, v, causal, scale)`` takes the public
``[batch, seq, heads, head_dim]`` layout and returns ``(o, lse)``: ``o``
in the input dtype and the natural-log logsumexp ``[B*H, S, 1]`` in f32,
the contract the backward and ring-attention slices will read. On a CUDA
tensor it launches ``csrc/flash_attention_fwd.cu`` (the port of the TPU
kernel ``_fwd_kernel``); on a CPU tensor it runs the plain version
(``mha_reference`` plus its logsumexp). Forward only: the backward
kernels come with the training slice, so a call that could record a
gradient raises.
"""
from __future__ import annotations

import math

import torch

from . import _cuda

__all__ = ["flash_attention", "mha_reference", "supported",
           "FLASH_FWD_LAUNCHES"]

#: launches of the CUDA kernel (incremented once per launch, nowhere else)
FLASH_FWD_LAUNCHES = 0

_BLOCK_Q = 1024
_BLOCK_K = 1024
_SEQ_ALIGN = 128
_NEG_INF = -1e30


def _pick_block(seq, cap):
    """Largest block edge <= cap that divides seq (128-aligned), else None."""
    b = min(cap, seq)
    while b >= _SEQ_ALIGN:
        if seq % b == 0:
            return b
        b //= 2
    return None


def supported(q_shape, attn_mask, dropout_p, kv_seq=None) -> bool:
    """True when the flash kernel handles this case — the reference's
    rule: no mask, no dropout, D <= 256, and sequence lengths its block
    picker accepts (any length from 128 to 1024; beyond 1024 a multiple
    of 128). The CUDA kernel masks a ragged last tile itself."""
    if attn_mask is not None or dropout_p:
        return False
    if len(q_shape) != 4:
        return False
    if _pick_block(q_shape[1], _BLOCK_Q) is None:
        return False
    if kv_seq is not None and _pick_block(kv_seq, _BLOCK_K) is None:
        return False
    return q_shape[3] <= 256


def _plain_fwd(q, k, v, causal, scale):
    """The plain version: ``mha_reference``'s arithmetic, plus the
    natural-log LSE of the same f32 logits. Returns (o, lse)."""
    b, sq, h, d = q.shape
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    logits = (torch.einsum("bhsd,bhtd->bhst", qt, kt) * s).float()
    if causal:
        sk = logits.shape[-1]
        tril = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril()
        logits = torch.where(tril, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhst,bhtd->bhsd", probs, vt).transpose(1, 2)
    lse = torch.logsumexp(logits, dim=-1).reshape(b * h, sq, 1)
    return out, lse


def mha_reference(q, k, v, causal=False, scale=None):
    """Unfused reference (the kernel is compared against this)."""
    return _plain_fwd(q, k, v, causal, scale)[0]


def _check(q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes [batch, seq, heads, dim]")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or \
            q.shape[2:] != k.shape[2:]:
        raise ValueError(f"flash_attention shapes disagree: q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    sq, sk = q.shape[1], k.shape[1]
    if _pick_block(sq, _BLOCK_Q) is None or _pick_block(sk, _BLOCK_K) is None:
        raise ValueError(
            f"flash_attention needs 128-aligned seq lens, got q={sq} kv={sk}")
    if causal and sq != sk:
        raise ValueError("causal flash_attention requires seq_q == seq_kv")
    if q.shape[3] > 256:
        raise ValueError("flash_attention supports head_dim <= 256")


def flash_attention(q, k, v, causal=False, scale=None):
    """q, k, v ``[B, S, H, D]`` -> ``(o [B, S, H, D], lse [B*H, S, 1] f32)``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("backward lands with the training slice")
    _check(q, k, v, causal)
    if q.device.type == "cpu":
        return _plain_fwd(q, k, v, causal, scale)
    return _flash_cuda(q, k, v, causal, scale)


def _flash_cuda(q, k, v, causal, scale):
    global FLASH_FWD_LAUNCHES
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    _cuda.check_cuda("flash_attention", (q, k, v), dev)
    if q.dtype not in _cuda.DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError("flash_attention kernel takes f32 or bf16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty_like(q)
    lse = torch.empty(b * h, sq, 1, device=dev, dtype=torch.float32)
    fn = _cuda.entry("flash_attention_fwd", "flash_attention_fwd",
                     "pppppiiiiiifip")
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, sq, sk, h, d, int(bool(causal)),
                 float(s), _cuda.DTYPE_CODE[q.dtype],
                 _cuda.stream_handle(dev))
    _cuda.raise_on_error("flash_attention_fwd", err)
    FLASH_FWD_LAUNCHES += 1
    return o, lse
