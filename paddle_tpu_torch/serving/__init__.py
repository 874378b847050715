"""Paged-KV continuous-batching serving (mirrors ``paddle_tpu.serving``)."""
from .engine import Request, ServingConfig, ServingEngine
from .paged_cache import NULL_PAGE, PageAllocator, PagePool, PrefixCache
from .sched import SCHED_POLICIES, ChunkScheduler

__all__ = ["Request", "ServingConfig", "ServingEngine", "NULL_PAGE",
           "PageAllocator", "PagePool", "PrefixCache", "SCHED_POLICIES",
           "ChunkScheduler"]
