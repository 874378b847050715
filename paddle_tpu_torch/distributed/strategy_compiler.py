"""Strategy compiler: a ``DistributedStrategy`` -> one data-, tensor- and
ZeRO-parallel train step over ``torch.distributed`` (mirrors
``paddle_tpu/distributed/strategy_compiler.py``; reference:
fleet/base/strategy_compiler.py and meta_optimizers/*).

The reference compiles the strategy into sharding annotations on one
pjit program and lets GSPMD insert the collectives. Here every rank runs
its own shard eagerly and the collectives are explicit, over the mesh's
process groups (``mesh.py``):

  dp        each rank takes its slice of the global batch (dim 0); the
            gradients are reduced over ``dp`` ONCE a step: one flat f32
            bucket all-reduce (÷ dp) at ZeRO 0, or the reduce-scatter of
            a ZeRO route
  tp        the parallel layers' ``param_shardings`` and Megatron's
            conjugate collectives (``parallel_layers.py``); replicated
            parameters get equal gradients on every ``tp`` rank
  ZeRO 1/2  on a pure-dp mesh with f32 storage: the flat slab of
            ``qcomm.dp_zero_step`` (reduce-scatter -> update of the owned
            chunk -> all-gather); elsewhere the per-parameter route: each
            optimizer state lives on the 1/dp slice of its parameter's
            first divisible dim (``_add_axis``), the gradient is
            reduce-scattered onto that slice and the updated slice
            all-gathered. The reference selects the two routes by the
            same rule (``zero_manual``).
  ZeRO 3    the per-parameter route with the parameters stored on their
            slices too: each is all-gathered before use by an
            ``autograd.Function`` whose backward reduce-scatters, again
            when recompute re-runs a block
  ep        the MoE layers' ``param_shardings`` (``moe.py``): each rank
            computes its experts and the outputs are summed over ``ep``;
            the layers route over the micro-batch's ``dp`` slices
            (``context.moe_routing_scope``), as GSPMD's global router
  pp, sp    as far as the reference's compiled step takes them: axes
            nothing is cut over, so every rank along them computes the
            same step (the pipeline and the ring are ``hybrid.py``'s)
  amp       the forward runs on bf16 copies of the floating parameters
            (buffers, a batch norm's running statistics, stay f32)
  BN        a batch norm's statistics follow the reference's two routes:
            on the GSPMD one (ZeRO 0 or 3, f32 gradients) the batch
            moments span the micro-batch's dp slices
            (``context.batch_norm_scope``, a differentiable all-reduce);
            on the manual ones (the ZeRO 1/2 slab, int8 gradients) each
            rank takes its own slice's moments and the floating buffers
            are averaged over dp after the step, as the reference's
            shard_map ``pmean``s them; the buffers move once a
            micro-batch, in order
  clip      by global norm: a sharded parameter's squared norm is summed
            over its shard axes (tp, ep, a ZeRO slice's dp), a
            replicated one counts once

``build_mesh_from_strategy``, the spec helpers and the update functions
are pure functions held to the reference's outputs case by case.
``HybridParallelTrainer`` (``compile_train_step``) is the layer-agnostic
trainer; ``hybrid.HybridPipelineTrainer`` drives the pipeline protocol
over the same update (``_ShardedUpdate``).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.autograd import Function

from ..framework.lazy import is_abstract
from ..optimizer.clip import _scale_, functional_clip
from ..profiler import instrument as _pinstr
from ..profiler import is_enabled as _prof_enabled
from ..profiler import program_stats as _pstats
from ..profiler import recompile as _precomp
from ..profiler import registry as _preg
from ..profiler import trace as _ptrace
from . import qcomm as _qcomm
from .collective import ReduceOp
from .context import batch_norm_scope, loss_totals_scope, moe_routing_scope
from .fleet.distributed_strategy import DistributedStrategy
from .mesh import Mesh, P, create_mesh
from .parallel import bucket_mean
from .primitives import _gather, _reduced, _scatter

__all__ = ["build_mesh_from_strategy", "resolve_param_specs",
           "functional_clip", "make_param_update", "make_flat_update",
           "HybridParallelTrainer", "compile_train_step"]


def build_mesh_from_strategy(strategy: DistributedStrategy,
                             devices=None) -> Mesh:
    """hybrid_configs degrees -> a Mesh with axes (dp, pp, tp, sp[, ep]);
    ``dp_degree`` -1 takes the ranks the other degrees leave."""
    import torch.distributed as dist

    if devices is None:
        devices = range(dist.get_world_size() if dist.is_initialized()
                        else 1)
    devs = list(devices)
    h = strategy.hybrid_configs
    tp = max(1, h.mp_degree)
    pp = max(1, h.pp_degree)
    sp = max(1, h.sp_degree)
    ep = max(1, getattr(h, "ep_degree", 1))
    dp = h.dp_degree if h.dp_degree > 0 else \
        len(devs) // (tp * pp * sp * ep)
    axes = {"dp": dp, "pp": pp, "tp": tp, "sp": sp}
    if ep > 1:
        axes["ep"] = ep
    return create_mesh(axes, devs)


def _spec_axes(spec) -> set:
    used = set()
    for entry in spec:
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            used.update(entry)
        else:
            used.add(entry)
    return used


def _add_axis(spec, ndim: int, shape, axis_name: str, axis_size: int):
    """``spec`` with ``axis_name`` added on the first dim of ``shape``
    (already divided by the existing sharding) that it divides; ``spec``
    unchanged if no dim qualifies (ZeRO's parameter and state sharding)."""
    if axis_size <= 1 or axis_name in _spec_axes(spec):
        return spec
    entries = list(spec) + [None] * (ndim - len(spec))
    for d in range(ndim):
        e = entries[d]
        existing = () if e is None else (e if isinstance(e, tuple) else (e,))
        if shape[d] % axis_size != 0:
            continue
        entries[d] = tuple(existing) + (axis_name,) if existing else axis_name
        return P(*entries)
    return spec


def _local_check_shape(shape, spec, mesh):
    """``shape`` divided by ``spec``'s existing sharding."""
    out = list(shape)
    for d, e in enumerate(spec):
        if e is None:
            continue
        axes = e if isinstance(e, (tuple, list)) else (e,)
        for a in axes:
            out[d] = out[d] // mesh.shape[a]
    return tuple(out)


def _owner_spec(layer, name):
    """(owning module, its declared spec of ``name`` or None)."""
    owner, _, leaf = name.rpartition(".")
    mod = layer.get_submodule(owner) if owner else layer
    return mod, getattr(mod, "param_shardings", {}).get(leaf)


def _global_shape(layer, name, p, mesh):
    """The reference's (global) shape of parameter ``name``: a layer built
    under a tp > 1 mesh holds its shard, so each dim its spec shards over
    ``tp`` counts ``tp`` times."""
    mod, spec = _owner_spec(layer, name)
    shape = list(p.shape)
    if spec is None or getattr(mod, "_mesh", None) is None:
        return tuple(shape)
    for d, e in enumerate(spec):
        for a in ((e,) if isinstance(e, str) else (e or ())):
            shape[d] *= mod._mesh.shape[a]
    return tuple(shape)


def _layout(model, name, local_shape, mesh):
    """Parameter ``name``'s checkpoint layout: (local shape, global shape,
    index, axes it is cut over, the layout dims of each local dim). A dim
    its layer's spec cuts over tp or ep counts the axis' size times, at
    this rank's index; a dim the layer reads through ``shard_views`` is
    laid out as that view (GPT's qkv ``[..., 3h]`` as ``[..., 3, H, D]``
    cut on the heads), so every piece is one box of the global array."""
    from .parallel_layers import _sharded_dims

    view, dims = _sharded_dims(model, name, mesh)
    cuts = {d: (axes, n) for d, axes, n in dims}
    lshape, gshape, index, vdims = [], [], [], []
    for d, size in enumerate(local_shape):
        if d not in cuts:
            vdims.append([len(lshape)])
            lshape.append(size)
            gshape.append(size)
            index.append([0, size])
            continue
        axes, n = cuts[d]
        r = mesh.axis_index(axes)
        parts = [(size * n, True)] if view is None else \
            [(v, j == view[1]) for j, v in enumerate(view[0])]
        vdims.append(list(range(len(lshape), len(lshape) + len(parts))))
        for g, cut in parts:
            k = g // n if cut else g
            lshape.append(k)
            gshape.append(g)
            index.append([r * k, (r + 1) * k] if cut else [0, g])
    axes = set()
    for _, a, _ in dims:
        axes |= set((a,) if isinstance(a, str) else a)
    return tuple(lshape), tuple(gshape), index, axes, vdims


def resolve_param_specs(layer, mesh, zero_stage: int = 0) -> Dict[str, P]:
    """Every parameter's PartitionSpec: the tp specs the layers declare
    (``param_shardings``), axes absent from the mesh or of size 1
    dropped, plus the ``dp`` axis of ZeRO-3 (``_add_axis`` on the shape
    left after the tp sharding)."""
    named = dict(layer.named_parameters())
    specs = {name: P() for name in named}
    for lname, sub in layer.named_modules():
        ps = getattr(sub, "param_shardings", None)
        if not ps:
            continue
        for local, spec in ps.items():
            gname = f"{lname}.{local}" if lname else local
            if gname not in specs:
                continue
            entries = []
            for e in spec:
                if e is None:
                    entries.append(None)
                elif isinstance(e, (tuple, list)):
                    kept = tuple(a for a in e if a in mesh.axis_names
                                 and mesh.shape[a] > 1)
                    entries.append(kept if kept else None)
                else:
                    entries.append(e if e in mesh.axis_names
                                   and mesh.shape[e] > 1 else None)
            specs[gname] = P(*entries)
    if zero_stage >= 3 and "dp" in mesh.axis_names:
        dp = mesh.shape["dp"]
        for name, p in named.items():
            shape = _local_check_shape(_global_shape(layer, name, p, mesh),
                                       specs[name], mesh)
            specs[name] = _add_axis(specs[name], p.dim(), shape, "dp", dp)
    return specs


def make_param_update(opt):
    """The per-parameter update shared by both trainers and
    ``Optimizer.step``: ``opt._update_param`` (the L2 decay on the f32
    gradient, then ``_update`` at ``lr * plr`` with decoupled decay
    ``wd``), returning ``(p, s)``."""

    def upd(p, g, s, lr, step_no, plr=1.0, wd=0.0):
        opt._update_param(p, g, s, lr, step_no, plr, wd)
        return p, s

    return upd


def select_update(opt, p, g, s: dict, lr, step_no, plr, wd, ok) -> None:
    """``opt._update_param`` of ``p`` and its state ``s`` in place; with a
    verdict ``ok`` (a device bool, the bad-step guard) the update is
    computed on copies and kept only where ``ok``: on a bad step ``p``
    and every state stay bit for bit as they were (the reference's
    ``jnp.where(ok, new, old)``), on a good one they take the update's
    values exactly. No host sync."""
    if ok is None:
        opt._update_param(p, g, s, lr, step_no, plr, wd)
        return
    new_p = p.detach().clone()
    new_s = {k: v.clone() if torch.is_tensor(v) else v for k, v in s.items()}
    opt._update_param(new_p, g, new_s, lr, step_no, plr, wd)
    p.copy_(torch.where(ok, new_p, p))
    for k, v in s.items():
        if torch.is_tensor(v):
            v.copy_(torch.where(ok, new_s[k], v))


#: the reference's name for the ZeRO slab's update (``qcomm.dp_zero_step``):
#: the same rule on the owned flat slice, with ``plr``/``wd`` numbers or
#: vectors laid out like the flat buffer; exact, as ``_update`` is
#: elementwise
make_flat_update = make_param_update


def _flat_knob(vals, sizes, pad_to):
    """Per-parameter scalars -> one float when uniform, else an f32
    vector laid out like the flat parameter buffer (zero-padded tail:
    pad elements get knob 0, inert, as their gradients are 0)."""
    vals = [float(v) for v in vals]
    if len(set(vals)) <= 1:
        return vals[0] if vals else 0.0
    vec = np.concatenate([np.full(s, v, np.float32)
                          for v, s in zip(vals, sizes)]) \
        if sizes else np.zeros(0, np.float32)
    vec = np.pad(vec, (0, pad_to - vec.size))
    return torch.from_numpy(vec)


class _GatherDP(Function):
    """A ZeRO-3 parameter's slice -> the whole (local) parameter, gathered
    over ``dp`` on ``dim``; backward reduce-scatters (sums) the gradient
    back onto the slice."""

    @staticmethod
    def forward(ctx, shard, group, order, dim):
        ctx.args = (group, order, dim)
        return _gather(shard.detach(), group, order, dim, True)

    @staticmethod
    def backward(ctx, g):
        return (_scatter(g, *ctx.args, True),) + (None,) * 3


def _zero_route(mesh, zero: int, pure_extra: bool = True) -> bool:
    """The reference's ``zero_manual``: stages 1-2 on a pure-dp mesh with
    dp > 1 (and ``pure_extra``: the caller's own conditions)."""
    if mesh is None:
        return False
    dp = mesh.shape.get("dp", 1)
    pure_dp = all(s == 1 for a, s in mesh.shape.items() if a != "dp")
    return bool(zero in (1, 2) and dp > 1 and pure_dp and pure_extra)


class _ShardedUpdate:
    """The update side of both trainers over ``mesh``: gradients reduced
    over ``dp`` once, the global-norm clip across the shard axes, the
    optimizer on each rank's part and the parameters made whole again.

    ``named``: ``[(name, parameter)]``, the rank's local (tp-shard)
    parameters, which the trainer updates in place. ``specs``: their tp
    specs (``resolve_param_specs`` at stage 0). ``zero``: the ZeRO stage;
    ``manual`` selects the flat slab (``qcomm.dp_zero_step``);
    ``grad_comm`` 'int8' reduces the gradients over ``dp`` on the
    quantized ring (the slab's reduce-scatter, or one fused all-reduce of
    every gradient elsewhere). Optimizer states live here (``states[i]``)
    and go back to the optimizer's accumulators, whole, in ``sync``."""

    def __init__(self, mesh, named, specs, optimizer, zero: int,
                 manual: bool, block: int = 2048, param_comm: str = "f32",
                 param_dtype=None, moment_dtype=None, grad_sums=(),
                 norm_axes=(), grad_comm: str = "f32"):
        self.mesh = mesh
        # [(axis, per-parameter bool)]: gradients summed over the axis
        # before the dp reduction (hybrid.py: every one over sp, the
        # non-block ones over pp), and the parameters whose squared
        # norms the clip sums over it (the blocks over pp, the experts
        # over ep)
        self.grad_sums = list(grad_sums)
        self.norm_axes = list(norm_axes)
        self.opt = optimizer
        self.zero = zero
        self.manual = manual
        self.block = int(block)
        self.param_comm = param_comm
        self.grad_comm = grad_comm
        self.moment_dtype = moment_dtype
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        # each parameter's local (tp-shard) shape, kept when ZeRO 3
        # releases the whole parameter's storage
        self.shapes = [tuple(p.shape) for p in self.params]
        shape = mesh.shape if mesh is not None else {}
        self.dp = shape.get("dp", 1)
        self.tp = shape.get("tp", 1)
        self.dp_index = mesh.axis_index("dp") if self.dp > 1 else 0
        self.tp_sharded = [self.tp > 1 and "tp" in _spec_axes(specs[n])
                           for n in self.names]
        with torch.no_grad():
            for p in self.params:
                if param_dtype is not None and p.is_floating_point():
                    p.data = p.data.to(param_dtype)
        self._broadcast()
        # the dim of each parameter whose 1/dp slice this rank owns
        self.sdim: List[Optional[int]] = [None] * len(self.params)
        self.shards: List[Optional[torch.Tensor]] = [None] * len(self.params)
        if manual:
            self._init_slab()
            return
        for i, (n, p) in enumerate(named):
            if zero >= 1 and self.dp > 1:
                spec = _add_axis(specs[n], p.dim(), tuple(p.shape), "dp",
                                 self.dp)
                if "dp" in _spec_axes(spec):
                    self.sdim[i] = next(
                        d for d, e in enumerate(spec)
                        if e == "dp" or (isinstance(e, tuple) and "dp" in e))
            if zero >= 3 and self.sdim[i] is not None:
                shard = torch.nn.Parameter(self._slice(i, p.detach()).clone(),
                                           requires_grad=p.requires_grad)
                self.shards[i] = shard
                p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        self.states = []
        for i, p in enumerate(self.params):
            if zero >= 1 and self.dp > 1:
                st = optimizer._init_state(self._view(i))
            else:
                st = optimizer._state_for(p)
            self.states.append(self._cast_state(st))
            if not (zero >= 1 and self.dp > 1):
                optimizer._accumulators[id(p)] = self.states[-1]

    @torch.no_grad()
    def _broadcast(self) -> None:
        """Every dp rank starts from the values of dp index 0 (its own tp
        shard's), so the replicas of a dp group are equal from the first
        step on, as the reference's one global array is. An abstract
        trainer's parameters hold no values to send."""
        if self.dp == 1 or any(is_abstract(p) for p in self.params):
            return
        import torch.distributed as dist

        src = self.mesh.axis_ranks("dp")[0]
        for p in self.params:
            dist.broadcast(p.data, src, group=self.group)

    # -- layout ------------------------------------------------------------
    def _cast_state(self, st: dict) -> dict:
        if self.moment_dtype is None:
            return st
        return {k: v.to(self.moment_dtype) if v.is_floating_point() else v
                for k, v in st.items()}

    def _slice(self, i: int, t: torch.Tensor) -> torch.Tensor:
        d = self.sdim[i]
        k = t.shape[d] // self.dp
        return t.narrow(d, self.dp_index * k, k)

    def _view(self, i: int) -> torch.Tensor:
        """What rank updates of parameter i: its shard (ZeRO 3), the slice
        of its storage (ZeRO 1/2), or the whole parameter."""
        if self.shards[i] is not None:
            return self.shards[i].data
        if self.sdim[i] is not None:
            return self._slice(i, self.params[i].data)
        return self.params[i]

    def _init_slab(self):
        self.sizes = [p.numel() for p in self.params]
        self.chunk = _qcomm.zero_chunk_len(sum(self.sizes), self.dp,
                                           self.block)
        slab = self.dp * self.chunk
        dev = self.params[0].device
        st = self.opt._init_state(torch.empty(self.chunk, device=dev))
        if self.param_comm != "f32":
            st["master"] = _qcomm._flat_chunk(self.params, self.dp_index,
                                             self.chunk, slab)
        self.slab = st
        lo, hi = self.dp_index * self.chunk, (self.dp_index + 1) * self.chunk

        def knob(vals):
            k = _flat_knob(vals, self.sizes, slab)
            return k if isinstance(k, float) else k[lo:hi].to(dev)

        self.plr = knob([self.opt._lr_ratio(p) for p in self.params])
        self.wd = knob([self.opt._decoupled_wd(p) for p in self.params])

    @property
    def group(self):
        return self.mesh.group("dp")

    def _gather_dp(self, t, dim):
        return _gather(t, self.group, self.mesh.group_order("dp"), dim, True)

    # -- the trainers' side ----------------------------------------------
    def leaves(self) -> List[torch.Tensor]:
        """The tensors whose ``.grad`` the backward fills."""
        return [s if s is not None else p
                for s, p in zip(self.shards, self.params)]

    def value(self, i: int) -> torch.Tensor:
        """Parameter i as the forward uses it: gathered from its shard at
        ZeRO 3 (differentiably), else the parameter."""
        if self.shards[i] is None:
            return self.params[i]
        return _GatherDP.apply(self.shards[i], self.group,
                               self.mesh.group_order("dp"), self.sdim[i])

    def zero_grad(self) -> None:
        for t in self.leaves():
            t.grad = None

    def _grad(self, t: torch.Tensor) -> torch.Tensor:
        return t.grad if t.grad is not None else torch.zeros_like(t)

    def _axis_sums(self) -> None:
        """Every ``grad_sums`` gradient summed over its axis, in place (a
        missing one counts as 0): one flat f32 bucket all-reduce an
        axis."""
        leaves = self.leaves()
        for axis, which in self.grad_sums:
            idx = [i for i, w in enumerate(which) if w]
            if not idx:
                continue
            flat = torch.cat([self._grad(leaves[i]).reshape(-1).float()
                              for i in idx])
            flat = _reduced(flat, ReduceOp.SUM, self.mesh.group(axis))
            for i, c in zip(idx, flat.split([leaves[i].numel()
                                             for i in idx])):
                t = leaves[i]
                t.grad = c.view(t.shape).to(t.dtype)

    def _reduced_grads(self) -> List[Optional[torch.Tensor]]:
        """Each parameter's gradient on the part this rank updates, the
        mean over ``dp``: one bucket all-reduce for every parameter that
        has no dp slice, a reduce-scatter for each that has one (ZeRO 3:
        the gather's backward did it). At dp 1 a parameter without a
        gradient gets None (it is not updated); over dp it counts as 0,
        so that every rank runs the same collectives."""
        leaves = self.leaves()
        grads: List[Optional[torch.Tensor]] = [None] * len(leaves)
        if self.dp == 1:
            return [t.grad for t in leaves]
        if self.grad_comm == "int8":
            means = _qcomm.quantized_all_reduce_tree(
                [self._grad(t) for t in leaves], self.mesh, self.dp,
                block=self.block, mean=True)
            return [g.float() if self.sdim[i] is None
                    else self._slice(i, g.float())
                    for i, g in enumerate(means)]
        bucket = []
        for i, t in enumerate(leaves):
            if self.sdim[i] is None:
                bucket.append(i)
            elif self.shards[i] is not None:
                grads[i] = self._grad(t).float() / self.dp
            else:
                grads[i] = _scatter(self._grad(t).float(), self.group,
                                    self.mesh.group_order("dp"),
                                    self.sdim[i], True) / self.dp
        if bucket:
            means = bucket_mean([self._grad(leaves[i]) for i in bucket],
                                self.dp, self.group)
            for i, g in zip(bucket, means):
                grads[i] = g
        return grads

    def _masks(self, live):
        """(axis, per live gradient: is it a distinct part along the
        axis) for every axis a squared norm is summed over."""
        return (("tp", [self.tp_sharded[i] for i in live]),
                ("dp", [self.sdim[i] is not None for i in live])) + \
            tuple((axis, [which[i] for i in live])
                  for axis, which in self.norm_axes)

    def _sq_norms(self, grads, live) -> torch.Tensor:
        """Each live gradient's squared norm, summed over the axes it is
        cut on (``_masks``): the global array's."""
        sq = torch.stack([grads[i].float().square().sum() for i in live])
        for axis, which in self._masks(live):
            if self.mesh.shape.get(axis, 1) > 1 and any(which):
                mask = torch.tensor(which, device=sq.device)
                summed = _reduced(torch.where(mask, sq, 0.0), ReduceOp.SUM,
                                  self.mesh.group(axis))
                sq = torch.where(mask, summed, sq)
        return sq

    def global_norm(self) -> float:
        """The global norm of the gradients the backward left, as the
        clip takes it (after the axis sums and the dp reduction):
        collective, every rank calls it; the gradients are consumed."""
        self._axis_sums()
        grads = self._reduced_grads()
        live = [i for i, g in enumerate(grads) if g is not None]
        return float(torch.sqrt(self._sq_norms(grads, live).sum()))

    def _clip(self, clip, grads: List[Optional[torch.Tensor]]) -> None:
        """``clip`` on the reduced gradients (None: no gradient), in
        place. A squared norm is summed over ``tp`` for a tp-sharded
        parameter and over ``dp`` for one whose gradient is a dp slice; a
        replicated one counts once, so the norms equal the reference's on
        the global arrays."""
        from ..nn import ClipGradByGlobalNorm, ClipGradByNorm

        live = [i for i, g in enumerate(grads) if g is not None]
        if clip is None or not live:
            return
        gs = [grads[i] for i in live]
        if not isinstance(clip, (ClipGradByGlobalNorm, ClipGradByNorm)) or \
                not any(any(m) for _, m in self._masks(live)):
            functional_clip(clip, gs)
            return
        sq = self._sq_norms(grads, live)
        norms = torch.sqrt(sq.sum()).expand(len(gs)) \
            if isinstance(clip, ClipGradByGlobalNorm) else torch.sqrt(sq)
        scales = torch.clamp(clip.clip_norm / torch.clamp(norms, min=1e-12),
                             max=1.0)
        for g, sc in zip(gs, scales):
            _scale_(g, sc)

    def verdict(self, loss: torch.Tensor, grads) -> torch.Tensor:
        """The bad-step guard's verdict (reference ``hybrid.py:1071-1080``):
        the loss and every clipped gradient this rank holds finite, as a
        device bool, agreed over the mesh. A rank sees only its part (its
        tp shard, pp stage, sp chunk, experts, dp slice), so the verdict
        is a MIN over every axis of the mesh: no rank keeps an update
        that another skips. ``isfinite`` a gradient, not a squared norm,
        so that a huge but finite gradient cannot overflow the check."""
        ok = torch.isfinite(loss.detach().float()).reshape(())
        for g in grads:
            if g is not None:
                ok = ok & torch.isfinite(g).all()
        flag = ok.to(torch.int32)
        shape = self.mesh.shape if self.mesh is not None else {}
        for axis, n in shape.items():
            if n > 1:
                flag = _reduced(flag, ReduceOp.MIN, self.mesh.group(axis))
        return flag.bool()

    @torch.no_grad()
    def update(self, lr: float, step_no: int,
               loss: Optional[torch.Tensor] = None
               ) -> Optional[torch.Tensor]:
        """Reduce, clip, update and regather: the rest of a step after
        the backward. With the step's ``loss`` given, the guarded update:
        it returns the mesh-agreed verdict (a device bool) and keeps the
        update only where it is true (``select_update``)."""
        opt = self.opt
        if self.manual:
            clip = opt._grad_clip
            return _qcomm.dp_zero_step(
                self.mesh, self.dp, self.block, self.grad_comm,
                self.param_comm,
                make_flat_update(opt), self.params,
                [self._grad(p) for p in self.params], self.slab, lr,
                step_no, self.plr, self.wd,
                clip_norm=float(clip.clip_norm) if clip is not None
                else None, guard=loss is not None, loss=loss)
        self._axis_sums()
        grads = self._reduced_grads()
        self._clip(opt._grad_clip, grads)
        ok = None if loss is None else self.verdict(loss, grads)
        for i, p in enumerate(self.params):
            if not p.requires_grad or grads[i] is None:
                continue
            select_update(opt, self._view(i), grads[i], self.states[i], lr,
                          step_no, opt._lr_ratio(p), opt._decoupled_wd(p),
                          ok)
            if self.sdim[i] is not None and self.shards[i] is None:
                p.data.copy_(self._gather_dp(self._view(i), self.sdim[i]))
        return ok

    # -- checkpoint pieces -----------------------------------------------
    def _stored(self, i: int) -> torch.Tensor:
        """Parameter i's stored values: its dp shard at ZeRO 3, else the
        parameter."""
        return self.shards[i].data if self.shards[i] is not None \
            else self.params[i].data

    def _pieces(self, model, cut_axes) -> List[tuple]:
        """Every piece of state this rank holds, for ``distributed.
        checkpoint``: ``(key, storage, local shape, global shape, index,
        replica_id)``. Shapes and indices are in the parameter's global
        (view) layout (``_layout``): its tp and ep cuts, a ZeRO slice's
        dp cut, and on the slab route each parameter's flat range of this
        rank's chunk. ``cut_axes[i]``: further axes parameter i is cut
        over (``pp`` for a pipeline stage's blocks). A piece is written by
        the rank whose index is 0 on every axis it is not cut over."""
        out = []
        for i, name in enumerate(self.names):
            lay = _layout(model, name, self.shapes[i], self.mesh)
            axes = lay[3] | set(cut_axes[i])
            dp_cut = self.shards[i] is not None
            key = f"params/{name}"
            out.append((key, self._stored(i)) + self._cut(lay, i, dp_cut)
                       + (self._replica(axes | ({"dp"} if dp_cut else
                                                set())),))
            if self.manual:
                continue
            for k, v in self.states[i].items():
                sliced = self.sdim[i] is not None
                if tuple(v.shape) != tuple(self._view(i).shape):
                    out.append((f"opt/{name}/{k}", v, tuple(v.shape),
                                tuple(v.shape), None,
                                self._replica(set(cut_axes[i]))))
                    continue
                out.append((f"opt/{name}/{k}", v) + self._cut(lay, i, sliced)
                           + (self._replica(axes | ({"dp"} if sliced
                                                    else set())),))
        if self.manual:
            lo, hi = self.dp_index * self.chunk, \
                (self.dp_index + 1) * self.chunk
            off = 0
            for name, sz in zip(self.names, self.sizes):
                a, b = max(off, lo), min(off + sz, hi)
                if a < b:
                    for k, v in self.slab.items():
                        key = f"master/{name}" if k == "master" \
                            else f"opt/{name}/{k}"
                        out.append((key, v[a - lo:b - lo], (b - a,), (sz,),
                                    [[a - off, b - off]], 0))
                off += sz
        return out

    def _cut(self, lay, i: int, dp_cut: bool):
        """(local shape, global shape, index) of parameter i's layout,
        with the dp slice of ``sdim`` when ``dp_cut``."""
        lshape, gshape, index, _, vdims = lay
        lshape, index = list(lshape), [list(x) for x in index]
        if dp_cut:
            dims = vdims[self.sdim[i]]
            if len(dims) != 1:
                raise NotImplementedError(
                    f"checkpoint of {self.names[i]}: its ZeRO dp slice "
                    "cuts a dim its shard_views reshape")
            d = dims[0]
            k = lshape[d] // self.dp
            lo = index[d][0] + self.dp_index * k
            index[d] = [lo, lo + k]
            lshape[d] = k
        return tuple(lshape), tuple(gshape), index

    def _replica(self, cut: set) -> int:
        shape = self.mesh.shape if self.mesh is not None else {}
        return int(any(self.mesh.axis_index(a) != 0
                       for a, n in shape.items() if n > 1 and a not in cut))

    def state_pieces(self, model, cut_axes) -> dict:
        """``{"params": {name: Sharded}, "opt": {name: {key: Sharded}}}``
        (and ``"master"`` on the slab route with a compressed return):
        the trainers' ``device_state``."""
        from .checkpoint import Sharded

        tree: dict = {}
        for key, t, lshape, gshape, index, rep in self._pieces(model,
                                                               cut_axes):
            node = tree
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = Sharded(t.reshape(lshape), gshape, index, rep)
        return tree

    @torch.no_grad()
    def load_pieces(self, model, cut_axes, st: dict) -> None:
        """The inverse of ``state_pieces``: every piece of ``st`` copied
        into the storage it came from, in place."""
        from .checkpoint import Sharded

        for key, t, _, _, _, _ in self._pieces(model, cut_axes):
            node = st
            for part in key.split("/"):
                node = node[part]
            src = node.data if isinstance(node, Sharded) else node
            t.copy_(torch.as_tensor(src).reshape(t.shape))

    # -- ledger and sync -------------------------------------------------
    def ledger(self) -> dict:
        """Resident bytes of this rank by category (the reference's
        ``memory_ledger``): the stored parameters (shards at ZeRO 3), the
        gradients' f32 peak (4 bytes a local parameter element), the
        optimizer state where it lives, and the f32 master of a bf16
        ``dp_param_comm``."""
        stored = [s if s is not None else p
                  for s, p in zip(self.shards, self.params)]
        cats = {"param": stored,
                "grad": 4 * sum(s.numel() * self.dp if s is not None
                                else p.numel()
                                for s, p in zip(self.shards, self.params))}
        if self.manual:
            cats["opt_state"] = {k: v for k, v in self.slab.items()
                                 if k != "master"}
            if "master" in self.slab:
                cats["master"] = self.slab["master"]
        else:
            cats["opt_state"] = self.states
        return _pinstr.record_memory_ledger(cats)

    @torch.no_grad()
    def sync(self) -> None:
        """Whole parameters back in the model (ZeRO 3) and whole
        optimizer states in the optimizer's accumulators: collective,
        every rank calls it."""
        opt = self.opt
        if self.manual:
            flat = {k: _qcomm.all_gather_cast(v, self.mesh)
                    for k, v in self.slab.items() if k != "master"}
            off = 0
            for p, sz in zip(self.params, self.sizes):
                opt._accumulators[id(p)] = {
                    k: v[off:off + sz].view(p.shape).clone()
                    for k, v in flat.items()}
                off += sz
            return
        for i, p in enumerate(self.params):
            d = self.sdim[i]
            if d is None:
                continue
            if self.shards[i] is not None:
                p.data = self._gather_dp(self.shards[i].data, d)
            opt._accumulators[id(p)] = {
                k: self._gather_dp(v, d) for k, v in self.states[i].items()}


def _validate_zero_clip(optimizer, manual: bool) -> None:
    from ..nn import ClipGradByGlobalNorm

    clip = optimizer._grad_clip
    if manual and clip is not None and \
            not isinstance(clip, ClipGradByGlobalNorm):
        raise NotImplementedError(
            "ZeRO sharded update supports grad clipping only "
            "by global norm (per-leaf clips need the full "
            f"gradient on every shard); got {type(clip).__name__}")


class _swapped:
    """Run ``module`` with ``values`` in place of the named parameters
    (the reference's ``_swapped_state``); the stored ones come back on
    exit.

    Same-thread nesting is legal and restores LIFO. Two threads swapping
    the same parameter slot is not (a prefetch or snapshot thread reading
    the model while a step runs would see the other's tensors): each swap
    records its thread per slot in ``_owner`` and a swap from another
    thread raises ``RuntimeError``."""

    _owner: dict = {}                # (id(module), leaf) -> (thread, depth)
    _owner_lock = threading.Lock()

    def __init__(self, module: torch.nn.Module,
                 values: Dict[str, torch.Tensor]):
        self.slots = []
        for name, t in values.items():
            owner, _, leaf = name.rpartition(".")
            mod = module.get_submodule(owner) if owner else module
            self.slots.append((mod, leaf, t))

    def __enter__(self):
        tid = threading.get_ident()
        reg = _swapped._owner
        with _swapped._owner_lock:
            # every slot checked before any is registered: a raise here
            # leaves no entry behind (no __exit__ runs)
            for mod, leaf, _ in self.slots:
                owner = reg.get((id(mod), leaf))
                if owner is not None and owner[0] != tid:
                    raise RuntimeError(
                        "_swapped: parameter slot is already swapped by "
                        "another thread — two threads are running the "
                        "same module with substituted parameters. Build "
                        "separate module instances per thread.")
            for mod, leaf, _ in self.slots:
                owner = reg.get((id(mod), leaf))
                reg[(id(mod), leaf)] = (tid, 1 if owner is None
                                        else owner[1] + 1)
        self.saved = []
        for mod, leaf, t in self.slots:
            self.saved.append(mod._parameters[leaf])
            mod._parameters[leaf] = t
        return self

    def __exit__(self, *exc):
        for (mod, leaf, _), p in zip(reversed(self.slots),
                                     reversed(self.saved)):
            mod._parameters[leaf] = p
        reg = _swapped._owner
        with _swapped._owner_lock:
            for mod, leaf, _ in self.slots:
                tid, depth = reg[(id(mod), leaf)]
                if depth <= 1:
                    del reg[(id(mod), leaf)]
                else:
                    reg[(id(mod), leaf)] = (tid, depth - 1)
        return False


def _dp_slices(batch, mesh, specs=None):
    """This rank's part of a global batch: each leaf that ``specs`` (by
    default ``dp_batch_specs``) puts on ``dp`` sliced on dim 0 at this
    rank's dp index."""
    dp = mesh.shape.get("dp", 1) if mesh is not None else 1
    if dp == 1:
        return tuple(batch)
    r = mesh.axis_index("dp")
    specs = specs or _qcomm.dp_batch_specs(batch, dp)
    return tuple(b.chunk(dp, 0)[r] if spec == P("dp") else b
                 for b, spec in zip(batch, specs))


class HybridParallelTrainer:
    """The layer-agnostic trainer over (model, optimizer, strategy): the
    batch's dim 0 over ``dp``, the layers' tp specs, ZeRO 1-3 and amp,
    each step eager on every rank. The parameters are the model's own,
    trained in place; ``sync_to_layer()`` makes them and the optimizer's
    state whole (collective: every rank calls it).

    ``loss_fn(output, label)``: the loss of ``layer(*batch[:-1])`` against
    ``batch[-1]``, whose dtype amp keeps; without it the model's own
    ``.loss(*batch)``. ``accumulate_steps`` k: the global batch splits
    into k micro-batches on dim 0 (each then over ``dp``), one backward
    each, and ONE update on the mean gradient. The loss is the mean of
    the micro-batches' dp-mean losses. ``data_spec``: per batch leaf
    ``P('dp')`` (sliced over dp) or ``P()`` (whole on every rank); the
    default is ``qcomm.dp_batch_specs``. A layer that declares
    ``pipeline_loss_totals`` (a loss of several means, BERT's) runs each
    micro-batch's dp slice inside ``context.loss_totals_scope`` of that
    micro-batch's counts, so that the dp mean is the micro-batch's loss
    as the reference's one head over it gives. ``donate`` is accepted:
    an eager step holds no second copy to donate. A layer built under
    ``LazyGuard`` makes an abstract trainer, which plans (``aot_lower``,
    ``aot_compile``, ``memory_analysis``: ``plan.py``) and does not step,
    as ``hybrid.HybridPipelineTrainer``'s. ``dp_grad_comm="int8"`` reduces
    the dp gradients on the quantized ring (pure dp, ZeRO <= 2; with
    ``accumulate_steps`` the global batch must divide dp ×
    accumulate_steps, as the reference's per-shard split needs);
    ``dp_param_comm`` defaults to 'bf16' on the slab route with int8
    gradients, as in the reference."""

    def __init__(self, layer, optimizer, strategy: Optional[
            DistributedStrategy] = None, mesh=None,
            loss_fn=None, data_spec: Optional[Tuple] = None,
            donate: bool = True, accumulate_steps: int = 1,
            dp_grad_comm: str = "f32", dp_grad_block: int = 2048,
            dp_param_comm: Optional[str] = None):
        self.layer = layer
        self.optimizer = optimizer
        self.accumulate_steps = int(accumulate_steps)
        self.strategy = strategy or DistributedStrategy()
        self.mesh = mesh if mesh is not None else \
            build_mesh_from_strategy(self.strategy)
        self.loss_fn = loss_fn
        zero = self.strategy.sharding_configs.sharding_stage if \
            self.strategy.sharding else 0
        self.zero_stage = zero
        self.amp = bool(self.strategy.amp)
        _qcomm.validate_dp_grad_comm(dp_grad_comm, self.mesh,
                                     zero_stage=zero,
                                     block=int(dp_grad_block))
        self.dp_grad_comm = dp_grad_comm
        self.dp_grad_block = int(dp_grad_block)
        self.zero_manual = _zero_route(self.mesh, zero)
        if dp_param_comm is None:
            dp_param_comm = "bf16" if self.zero_manual and \
                dp_grad_comm == "int8" else "f32"
        _qcomm.validate_dp_param_comm(dp_param_comm, self.zero_manual)
        self.dp_param_comm = dp_param_comm
        _validate_zero_clip(optimizer, self.zero_manual)
        named = [(n, p) for n, p in layer.named_parameters()]
        self.param_names = [n for n, _ in named]
        self.param_specs = resolve_param_specs(layer, self.mesh, zero)
        specs = resolve_param_specs(layer, self.mesh, 0)
        norm_axes = [("ep", ["ep" in _spec_axes(specs[n])
                             for n, _ in named])] \
            if self.mesh.shape.get("ep", 1) > 1 else []
        self.abstract = any(is_abstract(p) for _, p in named)
        self._fake_mode = None
        if self.abstract:
            from .plan import fake_parameters

            self._fake_mode = fake_parameters(layer, optimizer)
            named = list(layer.named_parameters())
        with self._fake_mode or contextlib.nullcontext():
            self._upd = _ShardedUpdate(
                self.mesh, named, specs, optimizer, zero, self.zero_manual,
                self.dp_grad_block, dp_param_comm, norm_axes=norm_axes,
                grad_comm=dp_grad_comm)
        self.data_spec = data_spec
        # batch-norm moments shard-local, buffers averaged after the step
        # (the reference's manual routes) instead of spanning dp
        self._bn_local = self.mesh.shape.get("dp", 1) > 1 and (
            self.zero_manual or dp_grad_comm == "int8")
        self._step = 0
        self._prof_site = _precomp.unique_site("compile_train_step")
        self._program_counts: Dict[str, dict] = {}

    # -- functional pieces -------------------------------------------------
    def _forward_loss(self, batch) -> torch.Tensor:
        layer = self.layer
        vals = {n: _amp_cast(self._upd.value(i), self.amp)
                for i, n in enumerate(self.param_names)}
        if self.amp:
            n_cast = len(batch) - 1 if self.loss_fn is not None \
                else len(batch)
            batch = tuple(b.to(torch.bfloat16) if i < n_cast and
                          b.is_floating_point() else b
                          for i, b in enumerate(batch))
        with _swapped(layer, vals), _ptrace.annotate("fwd"):
            if self.loss_fn is not None:
                loss = self.loss_fn(layer(*batch[:-1]), batch[-1])
            else:
                loss = layer.loss(*batch)
        return loss.float()

    def _local(self, batch):
        return _dp_slices(batch, self.mesh, self.data_spec)

    def _loss(self, batch, backward: bool) -> torch.Tensor:
        """The dp-mean loss of the step over its micro-batches, with each
        micro-batch's backward (scaled 1/k) when ``backward``."""
        k = self.accumulate_steps
        qdp = self.mesh.shape.get("dp", 1) \
            if self.dp_grad_comm == "int8" else 1
        for b in batch:
            if b.dim() and b.shape[0] % (k * qdp if k > 1 else 1):
                raise ValueError(
                    f"gradient merge: batch size {b.shape[0]} is "
                    f"not divisible by accumulate_steps={k}"
                    + (" — the PER-SHARD batch: dp_grad_comm='int8' "
                       "splits micro-batches inside each dp shard, so "
                       "the global batch must divide dp × "
                       "accumulate_steps" if qdp > 1 else ""))
        micros = [torch.chunk(b, k, 0) if b.dim() else [b] * k
                  for b in batch]
        dev = batch[0].device
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        from .plan import planning

        totals_of = None if self.loss_fn is not None or planning() else \
            getattr(self.layer, "pipeline_loss_totals", None)
        for i in range(k):
            whole = tuple(m[i] for m in micros)
            mb = self._local(whole)
            # an MoE layer routes over the micro-batch's dp slices
            cut = mb[0].shape[:1] != whole[0].shape[:1]
            axes = ("dp",) if cut else ()
            # a head of several means: its dp slice's share of the
            # micro-batch's loss (hybrid.py), times dp for the dp mean
            totals = totals_of(*whole) if totals_of is not None else None
            w = self.mesh.shape.get("dp", 1) if totals is not None and cut \
                else 1
            bn_axis = "dp" if cut and not self._bn_local else None
            with moe_routing_scope(self.mesh, axes), \
                    loss_totals_scope(totals), \
                    batch_norm_scope(self.mesh, bn_axis):
                part = self._forward_loss(mb) * w / k
                if backward:
                    part.backward()
            loss = loss + part.detach()
        return _dp_mean(loss, self.mesh)

    def _step_body(self, batch) -> torch.Tensor:
        lr = self.optimizer.get_lr()
        self._step += 1
        self._upd.zero_grad()
        loss = self._loss(batch, backward=True)
        with _ptrace.annotate("optim"):
            self._upd.update(lr, self._step)
        self._upd.zero_grad()
        if self._bn_local:
            self._mean_buffers()
        self.optimizer._global_step = self._step
        return loss

    @torch.no_grad()
    def _mean_buffers(self) -> None:
        """The manual routes' buffer rule: every floating buffer (a batch
        norm's running statistics) averaged over dp after the step."""
        dp = self.mesh.shape.get("dp", 1)
        for b in self.layer.buffers():
            if b.is_floating_point():
                b.copy_(_reduced(b, ReduceOp.SUM, self.mesh.group("dp"))
                        / dp)

    def step(self, *batch) -> torch.Tensor:
        """One step on the GLOBAL batch (every rank passes the same one);
        returns the f32 loss. An abstract trainer raises."""
        if self.abstract:
            raise RuntimeError(
                "This trainer was built from a LazyGuard (abstract) layer: "
                "it can plan (memory_analysis / aot_lower) but not execute. "
                "Materialize the layer (framework.lazy.materialize) and "
                "build the optimizer and the trainer again to train.")
        dev = self._device()
        prof = _prof_enabled()
        t0 = time.perf_counter_ns() if prof else 0
        with _ptrace.scope("compiled/h2d") if prof \
                else contextlib.nullcontext():
            batch = tuple(torch.as_tensor(b, device=dev) for b in batch)
        _precomp.mark_trace(self._prof_site, batch)
        if not prof:
            return _pstats.dispatch(self._program_counts, self._prof_site,
                                    self._step_body, batch)
        with _ptrace.scope("compiled/step"):
            loss = _pstats.dispatch(self._program_counts, self._prof_site,
                                    self._step_body, batch)
            float(loss)
        reg = _preg()
        reg.counter("train/steps").add(1)
        reg.counter("train/tokens").add(_pinstr.tokens_in_batch(batch))
        reg.histogram("compiled/step_ms").observe(
            (time.perf_counter_ns() - t0) / 1e6)
        _pinstr.record_memory_high_water(device=dev)
        return loss

    __call__ = step

    def _device(self) -> torch.device:
        return self._upd.leaves()[0].device

    def profile_step_phases(self, *batch, iters: int = 2,
                            trace_window: int = 0) -> dict:
        """Per-phase (fwd/bwd/optim/comm) decomposition of the step, as
        ``hybrid.HybridPipelineTrainer.profile_step_phases`` (the
        reference's counterpart of it)."""
        return _profile_phases(self, batch, iters, trace_window)

    def memory_ledger(self) -> dict:
        """Per-rank resident bytes by category (``mem/{param,grad,
        opt_state,master}_bytes``): on a ZeRO route the optimizer state
        (and the master of a bf16 ``dp_param_comm``) is this rank's
        1/dp."""
        return self._upd.ledger()

    def aot_lower(self, *batch):
        """The step planned on fakes of this trainer's state (``plan.py``),
        as ``hybrid.HybridPipelineTrainer.aot_lower``."""
        from .plan import lower

        return lower(self, batch)

    def aot_compile(self, *batch):
        return self.aot_lower(*batch).compile()

    def memory_analysis(self, *batch) -> dict:
        return self.aot_compile(*batch).memory_analysis()

    def sync_to_layer(self):
        """The model with whole parameters, the optimizer with whole
        states (collective)."""
        self._upd.sync()
        return self.layer

    def device_state(self) -> dict:
        """This rank's training state for ``distributed.checkpoint``:
        ``{"params": {name: Sharded}, "opt": {name: {key: Sharded}}}``
        (``"master"`` too on the slab route with a compressed return),
        each piece this rank's local tensor with its global shape and
        index (``_ShardedUpdate.state_pieces``): a ZeRO slab saves each
        parameter's flat range of this rank's chunk, so a restore at
        another dp degree or ZeRO stage reads it back."""
        return self._upd.state_pieces(self.layer,
                                      [()] * len(self.param_names))

    def load_device_state(self, st: dict, step: Optional[int] = None):
        """Inverse of :meth:`device_state` (the restore path): every
        piece copied into place; ``step`` restores the step count and
        the optimizer's ``_global_step``."""
        self._upd.load_pieces(self.layer, [()] * len(self.param_names), st)
        if step is not None:
            self._step = int(step)
            self.optimizer._global_step = int(step)


def compile_train_step(layer, optimizer, strategy=None, mesh=None,
                       loss_fn=None, **kw) -> HybridParallelTrainer:
    return HybridParallelTrainer(layer, optimizer, strategy, mesh, loss_fn,
                                 **kw)


# ---------------------------------------------------------------------------
# helpers shared with hybrid.py
# ---------------------------------------------------------------------------
def _amp_cast(t: torch.Tensor, amp: bool) -> torch.Tensor:
    """The forward's copy of a parameter: bf16 under amp (differentiable),
    the tensor itself otherwise."""
    return t.to(torch.bfloat16) if amp and t.is_floating_point() else t


def _dp_mean(loss: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of every dp rank's ``loss`` (one scalar all-reduce)."""
    dp = mesh.shape.get("dp", 1) if mesh is not None else 1
    if dp == 1:
        return loss
    return _reduced(loss, ReduceOp.SUM, mesh.group("dp")) / dp


def _profile_phases(tr, batch, iters: int, trace_window: int) -> dict:
    """Both trainers' ``profile_step_phases``: fwd (the loss under
    ``no_grad``), fwd+bwd (no update; the gradients are cleared
    afterwards) and the step itself timed by ``instrument.time_compiled``
    (one warm call, then ``iters``: training state advances); bwd =
    fwdbwd − fwd, optim = step − fwdbwd, comm from the step site's counted
    collective bytes, which also stand for its ``cost_bytes_accessed``.
    ``trace_window=k`` wraps ``k`` more real steps in a parsed device
    trace returned under ``"trace"``."""
    dev = tr._device()
    b = tuple(torch.as_tensor(x, device=dev) for x in batch)
    # the timed forwards leave the running statistics as they were: only
    # the steps advance them
    model = getattr(tr, "layer", None) or tr.model
    bufs = [t for t in model.buffers() if t.is_floating_point()]
    kept = [t.clone() for t in bufs]

    def fwd():
        with torch.no_grad():
            return tr._loss(b, backward=False)

    def fwdbwd():
        tr._upd.zero_grad()
        return tr._loss(b, backward=True)

    t_fwd = _pinstr.time_compiled(fwd, iters)
    t_fb = _pinstr.time_compiled(fwdbwd, iters)
    tr._upd.zero_grad()
    with torch.no_grad():
        for t, k in zip(bufs, kept):
            t.copy_(k)
    t_step = _pinstr.time_compiled(lambda: tr.step(*batch), iters)
    ps = _pstats.record_counted(tr._prof_site,
                                tr._program_counts[tr._prof_site])
    out = _pinstr.record_phases(
        fwd_s=t_fwd, fwdbwd_s=t_fb, step_s=t_step,
        comm_bytes=sum(c["bytes"] for c in ps.collectives.values()),
        platform=dev.type, cost_bytes_accessed=ps.bytes_accessed)
    if trace_window:
        from ..profiler import device_trace as _dtrace

        with _dtrace.capture(steps=int(trace_window),
                             label=tr._prof_site) as cap:
            for _ in range(int(trace_window)):
                _pinstr._first_leaf(tr.step(*batch))
        out["trace"] = cap.summary
    return out
