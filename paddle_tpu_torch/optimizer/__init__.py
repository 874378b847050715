"""``paddle.optimizer`` (mirrors ``paddle_tpu.optimizer``): SGD, Adam, AdamW,
the LR schedulers and gradient clipping."""
from . import lr
from .optimizer import SGD, Adam, AdamW, Optimizer

__all__ = ["lr", "SGD", "Adam", "AdamW", "Optimizer"]
