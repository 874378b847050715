"""Fused lm-head + softmax cross-entropy, chunked so that the
``[B, S, V]`` logits never exist (mirrors ``paddle_tpu/ops/fused_ce.py``).

A Python loop over sequence chunks replaces the reference's
``lax.scan``: each chunk computes its logits tile ``x_chunk @ W^T`` in
f32 (bf16 ``x``/``W`` are upcast first, as ``preferred_element_type=f32``
gives the reference f32 logits), reduces it to logsumexp and the gold
logit, and discards it. Each chunk runs under
``torch.utils.checkpoint`` (the reference ``jax.checkpoint``s the scan
body): backward recomputes the chunk's logits instead of storing them,
so the peak logits footprint is one chunk. Gradients flow to ``x`` and
the weight.

This is not a TPU kernel in the reference, so it stays plain PyTorch
(ROADMAP queue 2, last paragraph).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

IGNORE = -100

__all__ = ["IGNORE", "fused_linear_cross_entropy",
           "fused_linear_cross_entropy_fn", "shifted_labels"]


def _chunk_size(s, chunk):
    """The reference's chunk: ``chunk`` shrunk by halving to a divisor of
    ``s``; one chunk when ``chunk`` is None or covers ``s``."""
    if chunk is None or chunk >= s:
        return s
    cs = chunk
    while s % cs:
        cs //= 2
    return cs


def _chunk_loss(xc, w, lc, bias, ignore_index, w_is_vh):
    """Summed CE of one chunk ``xc [B, cs, H]`` (f32 logits, reduced and
    discarded)."""
    logits = xc.float() @ (w.t() if w_is_vh else w)         # [B, cs, V]
    if bias is not None:
        logits = logits + bias.float()
    v = logits.shape[-1]
    lse = torch.logsumexp(logits, dim=-1)
    mask = lc != ignore_index
    gold = logits.gather(-1, lc.clamp(0, v - 1).long()[..., None])[..., 0]
    return torch.where(mask, lse - gold, 0.0).sum()


def _fused_ce(x, w, labels, ignore_index, chunk, w_is_vh, bias=None):
    """x: [B, S, H]; w: [V, H] (embedding layout) or [H, V]; labels [B, S];
    bias: optional [V] added to the logits. Mean CE over non-ignored
    positions, f32 scalar."""
    s = x.shape[1]
    cs = _chunk_size(s, chunk)
    wf = w.float()     # one upcast per call, shared by every chunk
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, cs):
        args = (x[:, c0:c0 + cs], wf, labels[:, c0:c0 + cs], bias,
                ignore_index, w_is_vh)
        total = total + (checkpoint(_chunk_loss, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else _chunk_loss(*args))
    n = (labels != ignore_index).sum()
    return total / n.clamp(min=1).float()


def fused_linear_cross_entropy_fn(x, w, labels, ignore_index=IGNORE,
                                  chunk=256, transpose_w=False, bias=None):
    """``transpose_w=False``: w is [V, H] (tied-embedding layout, logits =
    x @ w.T). ``transpose_w=True``: w is [H, V] (Linear layout)."""
    return _fused_ce(x, w, labels, ignore_index, chunk, not transpose_w,
                     bias=bias)


def shifted_labels(tokens, ignore_index=IGNORE):
    """Next-token labels: tokens shifted left, last position ignored."""
    return torch.cat([tokens[:, 1:],
                      torch.full((tokens.shape[0], 1), ignore_index,
                                 dtype=tokens.dtype, device=tokens.device)],
                     dim=1)


def fused_linear_cross_entropy(x, weight, labels, ignore_index=IGNORE,
                               chunk=256, transpose_w=False, bias=None,
                               next_token=False, name=None):
    """``next_token=True`` shifts the labels left by one (LM objective)
    before the loss."""
    if next_token:
        labels = shifted_labels(labels, ignore_index)
    return fused_linear_cross_entropy_fn(
        x, weight, labels, ignore_index=ignore_index, chunk=chunk,
        transpose_w=transpose_w, bias=bias)
