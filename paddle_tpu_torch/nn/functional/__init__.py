"""Functionals (mirrors ``paddle_tpu.nn.functional``)."""
from ...ops.fused_ce import fused_linear_cross_entropy
from .attention import scaled_dot_product_attention

__all__ = ["fused_linear_cross_entropy", "scaled_dot_product_attention"]
