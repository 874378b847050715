"""Distributed context the model reads while it runs (mirrors
``paddle_tpu/distributed/context.py:22-56``).

A trainer sets the scope around the model's forward so that layers can
pick a mesh-aware implementation (ring attention over ``sp``) without
the mesh threaded through every ``forward`` signature. The reference
threads the same information through rewritten per-rank programs and
ring ids (fleet meta-optimizers, meta_optimizers/common.py); here it is
a scoped (mesh, axis) pair.

The reference's ``pipeline_auto_axes_scope``, ``in_partial_manual_region``
and ``nested_kernel_shard`` (``context.py:59-115``) serve a Mosaic
partitioning rule that has no CUDA counterpart; they come with their
only callers, the pipeline and ring attention (ROADMAP queue 1 item 7c).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

from .mesh import Mesh

__all__ = ["sequence_parallel_scope", "manual_sequence_parallel_scope",
           "current_sequence_parallel"]

_SP: Optional[Tuple[Mesh, str, bool]] = None


@contextlib.contextmanager
def sequence_parallel_scope(mesh: Mesh, axis_name: str = "sp"):
    """Within this scope, attention layers use ring attention over
    ``axis_name`` (when the axis is larger than 1)."""
    global _SP
    prev = _SP
    _SP = (mesh, axis_name, False) if mesh.shape.get(axis_name, 1) > 1 \
        else None
    try:
        yield
    finally:
        _SP = prev


@contextlib.contextmanager
def manual_sequence_parallel_scope():
    """Marks that the surrounding code already runs per rank over the sp
    axis (the pipeline's stage body): the attention layer then calls the
    ring directly instead of opening another per-rank region."""
    global _SP
    prev = _SP
    if prev is not None:
        _SP = (prev[0], prev[1], True)
    try:
        yield
    finally:
        _SP = prev


def current_sequence_parallel() -> Optional[Tuple[Mesh, str, bool]]:
    return _SP
