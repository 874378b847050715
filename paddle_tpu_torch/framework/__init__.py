"""Framework helpers (mirrors ``paddle_tpu/framework``): ``io`` save and
load of pickled numpy state, ``lazy`` abstract parameters
(``LazyGuard``)."""
from . import io, lazy
from .lazy import LazyGuard

__all__ = ["io", "lazy", "LazyGuard"]
