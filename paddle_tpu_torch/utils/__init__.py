"""Small host-side utilities (mirrors ``paddle_tpu.utils``)."""
from .lru import LRUCache

__all__ = ["LRUCache"]
