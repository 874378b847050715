"""SPMD collective primitives over a mesh axis (mirrors
``paddle_tpu/distributed/primitives.py:1-36``: ``lax.psum``,
``lax.all_gather``, ``lax.ppermute`` ...).

Each rank runs the same program on its own shard; a primitive names a
mesh axis (``mesh.get_mesh()``; a tuple of axes spans their lines, the
first name major) and runs on this rank's process group along it. An
axis of size 1 is the identity, as it is under ``shard_map``; an axis
the mesh does not have raises ``NameError`` (jax: "unbound axis name").
Pieces are placed and read by axis index (``Mesh.group_order``), not by
group rank, so over a tuple of axes named out of the mesh's order
``all_gather``, ``psum_scatter`` and ``all_to_all`` follow the first
name major, as jax's do; ``ppermute`` indexes by ascending rank, as
jax's lowering does.

Gradients follow the transpose rules the reference gets under its
``shard_map`` (``check_vma=False``, ``distributed/_compat.py``): the
objective is the sum of every rank's own loss, so

  psum / pmean      -> psum / pmean of the cotangent
  all_gather        -> psum_scatter of the cotangent (same axis, tiling)
  psum_scatter      -> all_gather of the cotangent
  all_to_all        -> all_to_all with split and concat axes swapped
  ppermute(perm)    -> ppermute by the inverse permutation

``pmax``/``pmin`` have no differentiation rule in jax; their backward
raises the same way. Every primitive notes its collective for the
accounting (``collective.py``), the backward's collectives included.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch.autograd import Function

from ..profiler.instrument import note_collective
from .collective import (ReduceOp, _all_reduce_, _all_to_all, _gather_list,
                         _permute, _reduce_scatter)
from .mesh import get_mesh

__all__ = ["psum", "pmean", "pmax", "pmin", "all_gather", "all_to_all",
           "ppermute", "axis_index", "psum_scatter", "reduce_scatter",
           "ring_permute"]


def _axis(axis_name):
    """(mesh, axis size, group, group rank of each axis index) of
    ``axis_name``."""
    mesh = get_mesh()
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    if mesh is None or any(n not in mesh.axis_names for n in names):
        raise NameError(f"unbound axis name: {axis_name}")
    return mesh, mesh.axis_size(names), mesh.group(names), \
        mesh.group_order(names)


def _to_group(parts, order):
    """Pieces by axis index -> by group rank."""
    out = [None] * len(order)
    for i, g in enumerate(order):
        out[g] = parts[i]
    return out


def _from_group(parts, order):
    """Pieces by group rank -> by axis index."""
    return [parts[g] for g in order]


def _note(kind: str, t: torch.Tensor) -> torch.Tensor:
    note_collective(kind, t.dtype, t.numel() * t.element_size())
    return t


def _reduced(x, op, group):
    return _note("all_reduce", _all_reduce_(x.detach().clone(), op, group))


class _AllReduce(Function):
    @staticmethod
    def forward(ctx, x, op, group, scale):
        ctx.op, ctx.group, ctx.scale = op, group, scale
        y = _reduced(x, op, group)
        return y if scale == 1 else y / scale

    @staticmethod
    def backward(ctx, g):
        if ctx.op != ReduceOp.SUM:
            name = "pmax" if ctx.op == ReduceOp.MAX else "pmin"
            raise NotImplementedError(
                f"Differentiation rule for '{name}' not implemented")
        y = _reduced(g, ReduceOp.SUM, ctx.group)
        return (y if ctx.scale == 1 else y / ctx.scale), None, None, None


def _reduce(x, axis_name, op, mean=False):
    if isinstance(x, (tuple, list)):
        return type(x)(_reduce(v, axis_name, op, mean) for v in x)
    _, n, group, _ = _axis(axis_name)
    if not torch.is_tensor(x):
        # a host constant: jax folds it (psum(1, ax) is the axis size)
        return x * n if op == ReduceOp.SUM and not mean else x
    if n == 1:
        return x
    return _AllReduce.apply(x, op, group, n if mean else 1)


def psum(x, axis_name):
    return _reduce(x, axis_name, ReduceOp.SUM)


def pmean(x, axis_name):
    return _reduce(x, axis_name, ReduceOp.SUM, mean=True)


def pmax(x, axis_name):
    return _reduce(x, axis_name, ReduceOp.MAX)


def pmin(x, axis_name):
    return _reduce(x, axis_name, ReduceOp.MIN)


def _pieces(x, n, dim, tiled):
    if tiled:
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {x.shape[dim]} does "
                             f"not split over an axis of size {n}")
        return list(x.chunk(n, dim))
    if x.shape[dim] != n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} must equal "
                         f"the axis size {n} (tiled=False)")
    return list(x.unbind(dim))


def _joined(parts, dim, tiled):
    return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)


def _gather(x, group, order, dim, tiled):
    return _note("all_gather", _joined(
        _from_group(_gather_list(x, group), order), dim, tiled))


def _scatter(x, group, order, dim, tiled):
    return _note("reduce_scatter", _reduce_scatter(
        _to_group(_pieces(x, len(order), dim, tiled), order), ReduceOp.SUM,
        group))


class _AllGather(Function):
    @staticmethod
    def forward(ctx, x, group, order, dim, tiled):
        ctx.args = (group, order, dim, tiled)
        return _gather(x.detach(), group, order, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        return (_scatter(g, *ctx.args),) + (None,) * 4


class _ReduceScatter(Function):
    @staticmethod
    def forward(ctx, x, group, order, dim, tiled):
        ctx.args = (group, order, dim, tiled)
        return _scatter(x.detach(), group, order, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        return (_gather(g, *ctx.args),) + (None,) * 4


def all_gather(x, axis_name, *, axis=0, tiled=False):
    """Every rank's ``x`` along a new ``axis`` (``tiled``: concatenated
    on ``axis``)."""
    _, n, group, order = _axis(axis_name)
    if n == 1:
        return x if tiled else x.unsqueeze(axis)
    return _AllGather.apply(x, group, order, axis, tiled)


def psum_scatter(x, axis_name, scatter_dimension=0, tiled=True):
    """``psum`` of ``x`` whose ``scatter_dimension`` is split over the
    axis: this rank keeps its piece (``tiled=False``: the dimension has
    the axis size and is dropped)."""
    _, n, group, order = _axis(axis_name)
    if n == 1:
        return x if tiled else x.squeeze(scatter_dimension)
    return _ReduceScatter.apply(x, group, order, scatter_dimension, tiled)


reduce_scatter = psum_scatter


def _exchange(x, group, order, split_axis, concat_axis, tiled):
    pieces = _to_group(_pieces(x, len(order), split_axis, tiled), order)
    return _note("all_to_all", _joined(
        _from_group(_all_to_all(pieces, group), order), concat_axis, tiled))


class _AllToAll(Function):
    @staticmethod
    def forward(ctx, x, group, order, split_axis, concat_axis, tiled):
        ctx.args = (group, order, concat_axis, split_axis, tiled)
        return _exchange(x.detach(), group, order, split_axis, concat_axis,
                         tiled)

    @staticmethod
    def backward(ctx, g):
        return (_exchange(g, *ctx.args),) + (None,) * 5


def all_to_all(x, axis_name, split_axis, concat_axis, *, tiled=False):
    """Piece j of ``x``'s ``split_axis`` goes to axis index j; the pieces
    received are joined on ``concat_axis`` in axis order (``tiled=False``:
    ``split_axis`` has the axis size, is dropped, and the pieces stack
    on a new ``concat_axis``)."""
    _, n, group, order = _axis(axis_name)
    if n == 1:
        return x if tiled else x.squeeze(split_axis).unsqueeze(concat_axis)
    return _AllToAll.apply(x, group, order, split_axis, concat_axis, tiled)


def _permuted(x, pairs, ranks, group):
    return _note("collective_permute", _permute(x, pairs, ranks, group))


class _PPermute(Function):
    @staticmethod
    def forward(ctx, x, pairs, ranks, group):
        ctx.args = ([(d, s) for s, d in pairs], ranks, group)
        return _permuted(x.detach(), pairs, ranks, group)

    @staticmethod
    def backward(ctx, g):
        return _permuted(g, *ctx.args), None, None, None


def ppermute(x, axis_name, perm: Sequence[Tuple[int, int]]):
    """For each ``(src, dst)`` of indices, dst receives src's ``x``; an
    index no pair sends to gets zeros. The indices are group ranks, the
    line's ranks in ascending order: jax's lowering sorts each replica
    group before it applies ``perm``, so over a tuple named out of the
    mesh's order they are not ``axis_index``'s."""
    mesh, n, group, _ = _axis(axis_name)
    pairs = [(int(s), int(d)) for s, d in perm]
    if n == 1:
        return x if pairs else torch.zeros_like(x)
    return _PPermute.apply(x, pairs, sorted(mesh.axis_ranks(axis_name)),
                           group)


def axis_index(axis_name) -> torch.Tensor:
    """This rank's index on the axis: an int32 scalar tensor."""
    mesh, _, _, _ = _axis(axis_name)
    return torch.tensor(mesh.axis_index(axis_name), dtype=torch.int32)


def ring_permute(x, axis_name, shift=1):
    """Cyclic shift along a mesh axis (the pipeline's and ring
    attention's building block; replaces the reference's send_v2/recv_v2
    p2p ops)."""
    n = psum(1, axis_name)
    perm = [(i, (i + shift) % n) for i in range(n)]
    return ppermute(x, axis_name, perm)
