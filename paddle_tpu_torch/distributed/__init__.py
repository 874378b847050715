"""Distributed (mirrors ``paddle_tpu.distributed``). This slice has the
tensor-parallel layers at degree 1, the strategy config (``fleet``) and
the single-device ``hybrid.HybridPipelineTrainer``."""
