"""Attention functionals (mirrors ``paddle_tpu/nn/functional/attention.py``).

Same dispatch as the reference: when ``ops.flash_attention.supported``
holds (no mask, no dropout, D <= 256, a sequence length the reference's
block picker accepts) the call
goes to ``ops.flash_attention.flash_attention`` — the CUDA kernels for
CUDA tensors, their plain versions for CPU tensors — and carries
gradients through its autograd Function (the backward kernels);
otherwise it runs the plain masked softmax path with the ``-1e30`` mask
constant, differentiated by PyTorch's autograd.
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as TF


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None):
    """q, k, v: ``[batch, seq, heads, head_dim]`` (paddle convention)."""
    from ...ops import flash_attention as fa

    if fa.supported(query.shape, attn_mask, dropout_p, kv_seq=key.shape[1]):
        return fa.flash_attention(query.contiguous(), key.contiguous(),
                                  value.contiguous(), causal=is_causal,
                                  scale=scale)[0]
    d = query.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    qt, kt, vt = (x.transpose(1, 2) for x in (query, key, value))
    logits = (torch.einsum("bhsd,bhtd->bhst", qt, kt) * s).float()
    if is_causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        tril = torch.ones(sq, sk, dtype=torch.bool,
                          device=query.device).tril()
        logits = torch.where(tril, logits, -1e30)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = torch.where(attn_mask, logits, -1e30)
        else:
            logits = logits + attn_mask.float()
    probs = torch.softmax(logits, dim=-1).to(query.dtype)
    out = torch.einsum("bhst,bhtd->bhsd", probs, vt).transpose(1, 2)
    if dropout_p > 0.0 and training:
        out = TF.dropout(out, dropout_p, training=True)
    return out
