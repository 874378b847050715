"""``paddle.optimizer`` (mirrors ``paddle_tpu.optimizer``): SGD, Momentum,
Adam, AdamW, the LR schedulers and gradient clipping."""
from . import lr
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer

__all__ = ["lr", "SGD", "Momentum", "Adam", "AdamW", "Optimizer"]
