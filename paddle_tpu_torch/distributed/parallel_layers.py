"""Tensor-parallel layers (mirrors
``paddle_tpu/distributed/parallel_layers.py:25-96``; reference: the
Megatron-style ``paddle.distributed.split`` of collective.py:492-566).

The layers keep the reference's class and parameter names, layouts
(``weight [in, out]``) and ``param_shardings``/``output_sharding`` specs,
so ``GPT`` reads like the reference and its ``state_dict`` keys match.

The degree is the current mesh's ``tp`` axis when the layer is built
(``mesh.init_mesh``). At degree 1, or with no mesh, each layer is
exactly its dense counterpart: the same parameters, initializers and
arithmetic. At degree > 1 each rank holds its shard of the dims that
``param_shardings`` names and runs Megatron's conjugate collectives,
each an ``autograd.Function`` over the rank's ``tp`` group. The loss
after them is the same on every ``tp`` rank and counts once:

  _CopyToTP      identity forward, all-reduce backward (before a column
                 product, whose input is replicated)
  _ReduceFromTP  all-reduce forward, identity backward (after a row
                 product, the vocab shard's masked lookup, and the cross
                 entropy's sum-exp and target logit)
  _GatherFromTP  all-gather forward, this rank's slice backward
                 (``gather_output=True``)
  _ScatterToTP   this rank's slice forward, all-gather backward (a row
                 layer whose input is not yet parallel)

``shard_reference_state`` cuts a reference model's full parameters to
one rank's shards along those same specs, and ``gather_reference_state``
puts every rank's shards back together under the reference's names and
layouts. A layer whose sharded dim is not one block of columns declares
how to read it in ``shard_views``: ``{leaf: (view, axis)}`` reads the
dim as the ``view`` shape (global sizes) and cuts it on ``axis`` of the
view. GPT's fused qkv projection declares ``(3, heads, head_dim)`` cut
on the heads, so that rank r holds q, k and v of heads
``[r·H/tp, (r+1)·H/tp)``: under GSPMD the reference's arithmetic stays
global and a contiguous cut of the columns is harmless there, but a rank
that computes on its own shard needs all three of its heads' q, k, v.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn
from torch.autograd import Function

from ..nn.layer.common import Embedding, Linear
from .collective import ReduceOp
from .mesh import P, get_mesh
from .primitives import _gather, _reduced

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelEmbedding",
           "ParallelCrossEntropy", "shard_reference_state",
           "gather_reference_state", "TP_AXIS"]

TP_AXIS = "tp"


def _tp():
    """(degree, mesh) of the current mesh's ``tp`` axis."""
    mesh = get_mesh()
    if mesh is None or TP_AXIS not in mesh.axis_names:
        return 1, None
    n = mesh.shape[TP_AXIS]
    return n, (mesh if n > 1 else None)


class _CopyToTP(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ReduceOp.SUM, ctx.group), None


class _ReduceFromTP(Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduced(x, ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _tp_gather(x, mesh):
    """Every ``tp`` rank's ``x`` concatenated on the last dim."""
    return _gather(x, mesh.group(TP_AXIS), mesh.group_order(TP_AXIS), -1,
                   True)


class _GatherFromTP(Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.n, ctx.index = mesh.shape[TP_AXIS], mesh.axis_index(TP_AXIS)
        return _tp_gather(x.detach(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, -1)[ctx.index].contiguous(), None


class _ScatterToTP(Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.chunk(mesh.shape[TP_AXIS], -1)[
            mesh.axis_index(TP_AXIS)].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _tp_gather(g, ctx.mesh), None


def _shard(size: int, n: int, what: str) -> int:
    if size % n:
        raise ValueError(f"{what} {size} does not split over tp={n}")
    return size // n


class ColumnParallelLinear(Linear):
    """``W [in, out]`` sharded on ``out`` (column); the output is sharded
    on the feature dim, and ``gather_output=True`` gathers it."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, device=None):
        n, mesh = _tp()
        super().__init__(in_features, _shard(out_features, n, "out_features"),
                         weight_attr=weight_attr, has_bias=has_bias,
                         device=device)
        self.gather_output = gather_output
        self._mesh = mesh
        self.param_shardings = {"weight": P(None, TP_AXIS),
                                "bias": P(TP_AXIS)}
        self.output_sharding = P() if gather_output else \
            P(None, None, TP_AXIS)
        self.shard_views: Dict[str, tuple] = {}

    def forward(self, x):
        if self._mesh is None:
            return super().forward(x)
        group = self._mesh.group(TP_AXIS)
        y = super().forward(_CopyToTP.apply(x, group))
        if self.gather_output:
            y = _GatherFromTP.apply(y, self._mesh)
        return y


class RowParallelLinear(Linear):
    """``W [in, out]`` sharded on ``in`` (row); the input is sharded on
    its feature dim (``input_is_parallel``, else this rank takes its
    slice), the partial products are all-reduced and the bias is added
    after the reduce."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False, device=None):
        n, mesh = _tp()
        super().__init__(_shard(in_features, n, "in_features"),
                         out_features, weight_attr=weight_attr,
                         has_bias=has_bias, device=device)
        self.input_is_parallel = input_is_parallel
        self._mesh = mesh
        self.param_shardings = {"weight": P(TP_AXIS, None), "bias": P()}
        self.output_sharding = P()

    def forward(self, x):
        if self._mesh is None:
            return super().forward(x)
        group = self._mesh.group(TP_AXIS)
        if not self.input_is_parallel:
            x = _ScatterToTP.apply(x, self._mesh)
        y = _ReduceFromTP.apply(x @ self.weight, group)
        return y if self.bias is None else y + self.bias


class VocabParallelEmbedding(Embedding):
    """Embedding table sharded over vocab (reference: collective.py:492
    _parallel_embedding): rank i holds rows ``[i*V/n, (i+1)*V/n)``, looks
    up the ids in its range (zeros elsewhere) and the lookups are
    all-reduced."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 device=None):
        n, mesh = _tp()
        super().__init__(_shard(num_embeddings, n, "num_embeddings"),
                         embedding_dim, weight_attr=weight_attr,
                         device=device)
        self._mesh = mesh
        self.param_shardings = {"weight": P(TP_AXIS, None)}

    def forward(self, ids):
        if self._mesh is None:
            return super().forward(ids)
        rows = self.weight.shape[0]
        start = self._mesh.axis_index(TP_AXIS) * rows
        local = ids - start
        keep = (local >= 0) & (local < rows)
        out = self.weight[torch.where(keep, local, 0)] * \
            keep.unsqueeze(-1).to(self.weight.dtype)
        return _ReduceFromTP.apply(out, self._mesh.group(TP_AXIS))


ParallelEmbedding = VocabParallelEmbedding


def vocab_parallel_ce(z: torch.Tensor, labels: torch.Tensor,
                      mesh) -> torch.Tensor:
    """Per-position cross entropy ``logsumexp(z) - z[label]`` of logits
    ``z`` (f32) whose last dim is this rank's vocab shard (rank i holds
    ``[i*v, (i+1)*v)``): the row max all-reduced with MAX over ``tp``
    outside autograd, the sum of exponentials and the target's logit
    through ``_ReduceFromTP``. Labels outside every shard (ignored
    positions) give ``logsumexp``; the caller masks them."""
    group = mesh.group(TP_AXIS)
    v = z.shape[-1]
    local = labels - mesh.axis_index(TP_AXIS) * v
    keep = (local >= 0) & (local < v)
    m = _reduced(z.detach().amax(-1), ReduceOp.MAX, group)
    zs = z - m.unsqueeze(-1)
    sumexp = _ReduceFromTP.apply(zs.exp().sum(-1), group)
    tgt = _ReduceFromTP.apply(
        zs.gather(-1, torch.where(keep, local, 0).unsqueeze(-1))
        .squeeze(-1) * keep.to(zs.dtype), group)
    return torch.log(sumexp) - tgt


class ParallelCrossEntropy(nn.Module):
    """Mean cross entropy over logits whose last dim is the vocab
    (labels ``ignore_index`` are left out; the reference's
    ``F.cross_entropy(..., reduction="mean")``). At tp > 1 the logits are
    this rank's vocab shard: the row max, the sum of exponentials and
    the target's logit are all-reduced over ``tp``."""

    def __init__(self, ignore_index: int = -100):
        super().__init__()
        self.ignore_index = ignore_index
        _, self._mesh = _tp()

    def forward(self, logits, labels):
        labels = labels.long()
        if labels.dim() == logits.dim():
            labels = labels.squeeze(-1)
        mask = labels != self.ignore_index
        z = logits.float()
        if self._mesh is None:
            logp = torch.log_softmax(z, -1)
            tgt = logp.gather(-1, labels.clamp(0, z.shape[-1] - 1)
                              .unsqueeze(-1)).squeeze(-1)
            loss = -tgt
        else:
            loss = vocab_parallel_ce(z, labels, self._mesh)
        loss = torch.where(mask, loss, torch.zeros_like(loss))
        return loss.sum() / mask.sum().clamp(min=1)


def _sharded_dims(model, name, mesh):
    """(owning layer's view of each sharded dim, [(dim, axes, size)]) of
    parameter ``name``: the dims its layer's ``param_shardings`` name over
    mesh axes of size > 1."""
    owner, _, leaf = name.rpartition(".")
    try:
        mod = model.get_submodule(owner) if owner else model
    except AttributeError:
        mod = None
    spec = getattr(mod, "param_shardings", {}).get(leaf)
    view = getattr(mod, "shard_views", {}).get(leaf)
    dims = []
    if spec is not None and mesh is not None:
        for dim, names in enumerate(spec):
            axes = (names,) if isinstance(names, str) else names
            if names is None or \
                    any(a not in mesh.axis_names for a in axes):
                continue
            n = mesh.axis_size(names)
            if n > 1:
                dims.append((dim, names, n))
    return view, dims


def _as_view(shape, dim, view):
    """``shape`` with ``dim`` read as ``view`` (``None``: as it is)."""
    if view is None:
        return tuple(shape), dim
    vshape, axis = view
    return tuple(shape[:dim]) + tuple(vshape) + tuple(shape[dim + 1:]), \
        dim + axis


def shard_reference_state(model: nn.Module,
                          state: Mapping[str, np.ndarray],
                          mesh=None) -> Dict[str, np.ndarray]:
    """This rank's shard of a reference model's full parameters
    ``{name: array}`` (the reference's ``state_dict()`` as numpy): each
    parameter cut along the dims its owning layer's ``param_shardings``
    name, at this rank's index on those mesh axes, through the layer's
    ``shard_views`` where it declares one; a parameter no spec names (a
    DataParallel replica's, a LayerNorm's) is kept whole. Load the
    result with ``models.gpt.load_reference_state``."""
    mesh = mesh if mesh is not None else get_mesh()
    out = {}
    for name, arr in state.items():
        arr = np.asarray(arr)
        view, dims = _sharded_dims(model, name, mesh)
        for dim, names, n in dims:
            shape = arr.shape
            vshape, vdim = _as_view(shape, dim, view)
            size = _shard(vshape[vdim], n, f"{name} dim {dim}")
            i = mesh.axis_index(names)
            arr = np.take(arr.reshape(vshape),
                          np.arange(i * size, (i + 1) * size), axis=vdim)
            arr = arr.reshape(shape[:dim] + (shape[dim] // n,)
                              + shape[dim + 1:])
        out[name] = arr
    return out


def gather_reference_state(model: nn.Module,
                           state: Mapping[str, np.ndarray] = None,
                           mesh=None) -> Dict[str, np.ndarray]:
    """The inverse of ``shard_reference_state``: every rank's shards of
    ``state`` (this rank's ``{name: array}``; default the model's own,
    ``models.gpt.state_to_numpy``) all-gathered over the axes they are
    cut on, back to the reference's full names and layouts (copies, never
    views of the parameters). Collective: every rank of the mesh calls it
    and gets the whole state."""
    from ..models.gpt import state_to_numpy

    mesh = mesh if mesh is not None else get_mesh()
    if state is None:
        state = state_to_numpy(model)
    params = dict(model.named_parameters())
    out = {}
    for name, arr in state.items():
        arr = np.array(arr)
        view, dims = _sharded_dims(model, name, mesh)
        if dims:
            dev = params[name].device if name in params else "cpu"
            t = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
            for dim, names, n in dims:
                shape = tuple(t.shape)
                if view is not None:
                    vshape, axis = view
                    vshape = vshape[:axis] + (vshape[axis] // n,) + \
                        vshape[axis + 1:]
                    local, vdim = _as_view(shape, dim, (vshape, axis))
                else:
                    local, vdim = shape, dim
                t = _gather(t.reshape(local), mesh.group(names),
                            mesh.group_order(names), vdim, True)
                t = t.reshape(shape[:dim] + (shape[dim] * n,)
                              + shape[dim + 1:])
            arr = t.cpu().numpy()
        out[name] = arr
    return out
