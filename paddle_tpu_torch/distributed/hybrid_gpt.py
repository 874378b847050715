"""GPT hybrid-parallel trainer: the back-compat name of the generic
``HybridPipelineTrainer`` (mirrors ``paddle_tpu/distributed/hybrid_gpt.py``;
reference: the composition that fleet/base/strategy_compiler.py chains
from sharding_optimizer.py, pipeline_optimizer.py and the amp/recompute
meta-optimizers).
"""
from __future__ import annotations

from .hybrid import HybridPipelineTrainer

__all__ = ["GPTHybridTrainer"]


class GPTHybridTrainer(HybridPipelineTrainer):
    """``HybridPipelineTrainer`` under its round-1 name; ``step(tokens)``."""
