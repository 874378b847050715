"""Layers, initializers and functionals this slice needs (mirrors
``paddle_tpu.nn``)."""
from .layer.common import Embedding, Linear
from .layer.norm import LayerNorm

__all__ = ["Embedding", "Linear", "LayerNorm"]
