"""Distributed layers (mirrors ``paddle_tpu.distributed``). This slice has
the tensor-parallel layers at degree 1 only."""
