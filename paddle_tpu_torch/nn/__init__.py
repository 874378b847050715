"""Layers, initializers, functionals and gradient-clip configs the ported
slices need (mirrors ``paddle_tpu.nn``). ``Sequential`` and ``ReLU`` are
PyTorch's own, beside the port's ``[in, out]`` ``Linear``."""
from torch.nn import ReLU, Sequential

from .layer.common import Embedding, Linear
from .layer.norm import LayerNorm

__all__ = ["Embedding", "Linear", "LayerNorm", "ReLU", "Sequential",
           "ClipGradByNorm", "ClipGradByGlobalNorm", "ClipGradByValue"]


class ClipGradByNorm:
    """Clip each gradient to L2 norm ``clip_norm`` (applied by
    ``optimizer.clip``)."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm


class ClipGradByGlobalNorm:
    """Scale all gradients by ``min(1, clip_norm / global L2 norm)``
    (reference: fluid/clip.py GradientClipByGlobalNorm)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm
        self.group_name = group_name


class ClipGradByValue:
    """Clamp every gradient element to ``[min, max]``."""

    def __init__(self, max, min=None):  # noqa: A002
        self.max = max
        self.min = -max if min is None else min
