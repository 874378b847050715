"""Gradient clipping (mirrors ``paddle_tpu/optimizer/clip.py`` and the
trainer's ``strategy_compiler.functional_clip``; reference:
python/paddle/fluid/clip.py GradientClipByValue/ByNorm/ByGlobalNorm).

One implementation, ``functional_clip``, serves the eager
``Optimizer.step`` (through ``apply_grad_clip``) and the trainer. It
scales the gradients in place, where the reference builds new arrays:
a copy of every gradient would double the gradients' memory.
Norms are taken in f32 and the scale stays on the device (no host sync).
"""
from __future__ import annotations

from typing import List, Sequence

import torch


def functional_clip(clip, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Apply a clip config to ``grads`` in place and return them. A scale
    multiplies in f32 and rounds back to each gradient's dtype, as the
    reference's ``(g * scale).astype(g.dtype)``."""
    from ..nn import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue

    grads = list(grads)
    if clip is None or not grads:
        return grads
    if isinstance(clip, ClipGradByValue):
        for g in grads:
            g.clamp_(clip.min, clip.max)
    elif isinstance(clip, ClipGradByNorm):
        for g in grads:
            n = torch.linalg.vector_norm(g.float())
            _scale_(g, torch.clamp(clip.clip_norm / torch.clamp(n, min=1e-12),
                                   max=1.0))
    elif isinstance(clip, ClipGradByGlobalNorm):
        gn = torch.sqrt(sum(g.float().square().sum() for g in grads))
        scale = torch.clamp(clip.clip_norm / torch.clamp(gn, min=1e-12),
                            max=1.0)
        for g in grads:
            _scale_(g, scale)
    else:
        raise TypeError(f"Unknown grad clip type: {type(clip)}")
    return grads


def _scale_(g: torch.Tensor, scale: torch.Tensor) -> None:
    """``g <- g * scale`` in place, the product taken in f32 (or wider) and
    rounded once to ``g``'s dtype. ``g.mul_(scale)`` would not do that on
    the card: a 0-dim CUDA ``scale`` is cast to a bf16 ``g``'s dtype before
    the product, so the result is rounded twice."""
    g.copy_(g.to(torch.promote_types(g.dtype, scale.dtype)) * scale)


def apply_grad_clip(clip, params) -> None:
    """Clip ``p.grad`` of every parameter that has one, in place."""
    functional_clip(clip, [p.grad for p in params if p.grad is not None])
