"""Paged-KV continuous-batching serving (mirrors ``paddle_tpu.serving``).
Speculative decoding: ``ServingConfig(spec=SpecConfig(draft_model, k))``
(``spec.py``). The legacy two-dispatch engine:
``ServingConfig(attention_kernel="legacy")``. The KV handoff of
disaggregated serving: ``submit(..., hold_after_prefill=True)``,
``held_ready``, ``export_held``, ``release_exported``,
``admit_prefilled``; hot prefix-chain migration:
``export_prefix_chain``, ``import_prefix_chain`` over the chain hashes
(``chain_hash``, ``chain_hashes``). The multi-process mesh that drives
them (``disagg.py``): ``DisaggServer`` (one rank's coordinator:
consensus-routed admission, prefill/decode disaggregation or the
symmetric layout, the elastic mesh, prefix routing), ``MeshSpec``,
``HandoffChannel`` and ``route_requests``."""
from .disagg import DisaggServer, HandoffChannel, MeshSpec, route_requests
from .engine import Request, ServingConfig, ServingEngine
from .paged_cache import (NULL_PAGE, PageAllocator, PagePool, PrefixCache,
                          chain_hash, chain_hashes)
from .sched import SCHED_POLICIES, ChunkScheduler, SpecKController
from .spec import DraftRunner, SpecConfig

__all__ = ["Request", "ServingConfig", "ServingEngine", "SpecConfig",
           "DraftRunner", "NULL_PAGE", "PageAllocator", "PagePool",
           "PrefixCache", "chain_hash", "chain_hashes", "SCHED_POLICIES",
           "ChunkScheduler", "SpecKController", "DisaggServer",
           "HandoffChannel", "MeshSpec", "route_requests"]
