"""Paged-KV continuous-batching serving (mirrors ``paddle_tpu.serving``).
Speculative decoding: ``ServingConfig(spec=SpecConfig(draft_model, k))``
(``spec.py``)."""
from .engine import Request, ServingConfig, ServingEngine
from .paged_cache import NULL_PAGE, PageAllocator, PagePool, PrefixCache
from .sched import SCHED_POLICIES, ChunkScheduler, SpecKController
from .spec import DraftRunner, SpecConfig

__all__ = ["Request", "ServingConfig", "ServingEngine", "SpecConfig",
           "DraftRunner", "NULL_PAGE", "PageAllocator", "PagePool",
           "PrefixCache", "SCHED_POLICIES", "ChunkScheduler",
           "SpecKController"]
