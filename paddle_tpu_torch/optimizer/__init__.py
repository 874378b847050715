"""``paddle.optimizer`` (mirrors ``paddle_tpu.optimizer``): Adam, AdamW,
the LR schedulers and gradient clipping."""
from . import lr
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["lr", "Adam", "AdamW", "Optimizer"]
