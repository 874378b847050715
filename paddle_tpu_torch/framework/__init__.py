"""Framework helpers (mirrors ``paddle_tpu/framework``): ``io`` save and
load of pickled numpy state."""
from . import io

__all__ = ["io"]
