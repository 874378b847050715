"""Distributed context the model reads while it runs (mirrors
``paddle_tpu/distributed/context.py:22-56``).

A trainer sets the scope around the model's forward so that layers can
pick a mesh-aware implementation (ring attention over ``sp``) without
the mesh threaded through every ``forward`` signature. The reference
threads the same information through rewritten per-rank programs and
ring ids (fleet meta-optimizers, meta_optimizers/common.py); here it is
a scoped (mesh, axis) pair.

The pipeline's scopes (``pipeline_auto_axes_scope``,
``current_pipeline_auto_axes``, ``in_partial_manual_region``,
``nested_kernel_shard``; reference ``context.py:58-115``) keep the
reference's observable contract: scopes nest and restore, and the
getters return what the scope set. They serve a Mosaic partitioning
rule (every mesh axis manual around a Pallas call) that has no CUDA
counterpart: every rank of the port already runs its own shard, so
there is never a partially manual region and a kernel needs no nesting.

``moe_routing_scope`` is the port's own: the mesh axes over which an
MoE layer routes its tokens (``distributed/moe.py``). Under GSPMD the
reference's router sees the global micro-batch; a rank of the port sees
its slice, so the trainers name the axes the batch was cut over.

``loss_totals_scope`` is the port's own too: the global denominators of
a loss head whose terms are means over different counts (BERT's masked
positions and its rows; ``models/bert.py``). The reference's head runs
once over the global batch; a rank of the port runs it over its
micro-batch's dp slice, so the trainers hand the head the global batch's
counts and it returns its share of the global loss.

``batch_norm_scope`` is the port's own as well: the mesh axis over which
a batch norm takes its batch moments in training mode. On the
reference's GSPMD route (ZeRO 0 or 3 with f32 gradients) its one
program sees the whole logical batch, so the moments span every dp
shard; a rank of the port sees its slice, so the trainer names ``dp``
and ``nn.functional.batch_norm`` averages the moments over it with a
differentiable all-reduce. On the manual routes (ZeRO 1/2 on a pure dp
mesh, int8 gradients) the reference takes shard-local moments and
averages the new running buffers after the step; there the trainer
sets no scope.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

from .mesh import Mesh

__all__ = ["sequence_parallel_scope", "manual_sequence_parallel_scope",
           "current_sequence_parallel", "pipeline_auto_axes_scope",
           "current_pipeline_auto_axes", "in_partial_manual_region",
           "nested_kernel_shard", "moe_routing_scope",
           "current_moe_routing", "loss_totals_scope",
           "current_loss_totals", "batch_norm_scope",
           "current_batch_norm"]

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


_PIPE_AUTO: Optional[Tuple[Mesh, Tuple[str, ...]]] = None


@contextlib.contextmanager
def pipeline_auto_axes_scope(mesh: Mesh, axes):
    """Inside the pipeline's stage body, the mesh axes other than ``pp``
    (and a manual ``sp``). The reference's kernels read it to nest a
    shard_map; the port records it with the same nesting contract."""
    global _PIPE_AUTO
    prev = _PIPE_AUTO
    _PIPE_AUTO = (mesh, tuple(axes))
    try:
        yield
    finally:
        _PIPE_AUTO = prev


def current_pipeline_auto_axes() -> Optional[Tuple[Mesh, Tuple[str, ...]]]:
    return _PIPE_AUTO


def in_partial_manual_region() -> bool:
    """Always False in the port: each rank runs its own shard of every
    axis, so no region is partially manual (the reference: True inside
    the pipeline scope on a non-CPU target)."""
    return False


def nested_kernel_shard(fn, in_specs, out_specs):
    """The reference wraps ``fn`` in a shard_map over the scope's auto
    axes (None outside a scope). A rank of the port already holds its
    shard of every axis and calls a kernel on it directly, so inside a
    scope this returns ``fn`` unchanged, and None outside one, as the
    reference does. ``in_specs``/``out_specs`` are accepted and unused."""
    if _PIPE_AUTO is None:
        return None
    return fn


_MOE_ROUTE: Optional[Tuple[Mesh, Tuple[str, ...]]] = None


@contextlib.contextmanager
def moe_routing_scope(mesh: Optional[Mesh], axes=("dp",)):
    """Within this scope an MoE layer routes over every token of the
    ranks along ``axes`` (those of size > 1; the first name major in
    the global token order, as the batch is cut: dim 0 over ``dp``, dim
    1 over ``sp``). None or no such axis: each rank routes its own."""
    global _MOE_ROUTE
    prev = _MOE_ROUTE
    kept = tuple(a for a in axes if mesh is not None
                 and mesh.shape.get(a, 1) > 1)
    _MOE_ROUTE = (mesh, kept) if kept else None
    try:
        yield
    finally:
        _MOE_ROUTE = prev


def current_moe_routing() -> Optional[Tuple[Mesh, Tuple[str, ...]]]:
    return _MOE_ROUTE


_LOSS_TOTALS: Optional[tuple] = None


@contextlib.contextmanager
def loss_totals_scope(totals: Optional[tuple]):
    """Within this scope a loss head that reads it divides each term's sum
    by the matching entry of ``totals`` (the global batch's counts, from
    the model's ``pipeline_loss_totals``), instead of by its own count:
    its value is its share of the global loss. None: each head takes its
    own means."""
    global _LOSS_TOTALS
    prev = _LOSS_TOTALS
    _LOSS_TOTALS = totals
    try:
        yield
    finally:
        _LOSS_TOTALS = prev


def current_loss_totals() -> Optional[tuple]:
    return _LOSS_TOTALS


_BATCH_NORM: Optional[Tuple[Mesh, str]] = None


@contextlib.contextmanager
def batch_norm_scope(mesh: Optional[Mesh], axis: Optional[str] = "dp"):
    """Within this scope a batch norm in training mode takes its batch
    mean and variance over every rank along ``axis`` (when the mesh has
    it at size > 1); None: over the rank's own rows."""
    global _BATCH_NORM
    prev = _BATCH_NORM
    _BATCH_NORM = (mesh, axis) if mesh is not None and axis is not None \
        and mesh.shape.get(axis, 1) > 1 else None
    try:
        yield
    finally:
        _BATCH_NORM = prev


def current_batch_norm() -> Optional[Tuple[Mesh, str]]:
    return _BATCH_NORM
