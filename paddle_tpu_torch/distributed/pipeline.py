"""Pipeline parallelism over a mesh axis (mirrors
``paddle_tpu/distributed/pipeline.py``; reference: fleet
meta_optimizers/pipeline_optimizer.py:136 and the SectionWorker schedule
of section_worker.cc:34).

Each ``pp`` rank holds one stage's blocks and runs the reference's
schedule as an eager loop over ticks. Every tick begins with ONE
``primitives.ppermute`` over ``pp`` (stage i sends its last output to
stage i + 1; the last stage's goes round to stage 0); autograd runs the
reverse ring through the permute's backward, so there are no
hand-written per-stage backward passes.

Schedules (``v_virtual``):

- 1, GPipe fill-drain: ``n_micro + pp − 1`` ticks of a whole stage's
  layers; bubble ``(pp − 1)/(n_micro + pp − 1)``.
- v > 1, interleaved: stage s holds v "virtual stages" (circuit c: the
  layers ``c·(pp·lps_v) + s·lps_v + j``), micro-batches circle the ring
  v times, ``n_ticks = v·n_micro + pp − 1`` ticks of 1/v the work;
  bubble ``(pp − 1)/(v·n_micro + pp − 1)``. Needs ``n_micro >= pp``.

At tick t stage 0 takes micro-batch ``t mod n_micro`` fresh (circuit 0)
or as it came back round the ring (a later circuit, held in the return
buffer); stage s works on circuit ``clip((t − s) // n_micro, 0, v − 1)``;
the last stage's output of the last circuit is micro-batch ``done_t``'s
result. Aux scalars (``stage_aux``) count on the ticks where a stage
holds real data (``s <= t < s + v·n_micro``), are summed over ``pp`` and
divided by ``n_micro``.

**Every rank issues the same collectives in the same order.** A stage
skips its compute on a tick where it holds no real data (its output
there is masked anyway, so it passes its input on unchanged), but it
never skips the tick's permute. The permute's input always requires a
gradient (a leaf at tick 0) and each tick's input depends on the tick's
received tensor on every stage (stage 0 selects with ``torch.where``,
which still routes a zero gradient to the received one), so every
rank's autograd graph chains the permutes one after another and runs
their backward functions in the same (reverse) order. The loss head
runs on the last stage only (``head_fn``), and the scalar is then
summed over ``pp``; the other stages return a zero that depends on
their last tick, so that their backward starts there.

A returned scalar's VALUE is the sum over ``pp`` (and for the aux, the
mean over a manual ``sp``); its gradient is this rank's own share, as
the objective is the sum of every rank's share. Backward on it on
every rank gives each stage its parameters' gradients.

The reference's ``boundary_f32``/``param_f32`` promotions (bf16 on
XLA:CPU) and ``legacy_all_manual`` (old jax without a partially manual
shard_map) work around bugs of those toolchains: they have no
counterpart here.

Gloo on CUDA tensors has no point-to-point send: there the permute
takes the all-gather spelling (``collective._permute``). NCCL's
send/recv is the path on a machine with a card a rank.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils._pytree import tree_map

from ..profiler.trace import annotate as _annotate
from .mesh import get_mesh

__all__ = ["stack_block_params", "pipeline_apply"]


def stack_block_params(block_param_lists):
    """[{name: tensor} per layer] -> {name: [L, ...] stacked}."""
    names = list(block_param_lists[0].keys())
    return {n: torch.stack([bp[n] for bp in block_param_lists], 0)
            for n in names}


def _to_microbatches(x, n_micro):
    b = x.shape[0]
    assert b % n_micro == 0, f"batch {b} not divisible into {n_micro} micro"
    return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))


def _from_microbatches(mbs, orig_shape):
    return mbs.reshape(orig_shape)


def _circuit(params, c: int, v: int):
    """The stage's parameters of circuit ``c``: entry c of a sequence of
    v, or index c of dim 0 of every tensor of a tree."""
    if v == 1:
        return params
    if isinstance(params, (list, tuple)) and len(params) == v:
        return params[c]
    return tree_map(lambda a: a[c] if torch.is_tensor(a) else a, params)


def _psum(x, mesh, axis):
    """The differentiable psum over ``axis`` of ``mesh``."""
    from .collective import ReduceOp
    from .primitives import _AllReduce

    if mesh.shape.get(axis, 1) == 1:
        return x
    return _AllReduce.apply(x, ReduceOp.SUM, mesh.group(axis), 1)


def _ring(x, mesh, axis):
    """The tick's permute: stage i's ``x`` to stage i + 1 (the last
    stage's to stage 0)."""
    from .primitives import _PPermute

    n = mesh.shape[axis]
    pairs = [(i, (i + 1) % n) for i in range(n)]
    return _PPermute.apply(x, pairs, sorted(mesh.axis_ranks(axis)),
                           mesh.group(axis))


def _global_share(local, total):
    """``total``'s value with ``local``'s gradient."""
    return local + (total - local).detach()


def pipeline_apply(mesh, stage_fn: Callable, stacked_params: Any, x,
                   n_micro: int, pp_axis: str = "pp",
                   sp_axis: Optional[str] = None, v_virtual: int = 1,
                   head_fn: Optional[Callable] = None,
                   head_args: tuple = (), stage_aux: bool = False):
    """Run ``x [batch, ...]`` (this rank's; only stage 0's values are
    read) through the pipelined blocks in ``n_micro`` micro-batches of
    dim 0.

    ``stacked_params``: this rank's stage. ``stage_fn(chunk, x_mb)``
    applies one (virtual) stage to one micro-batch; ``chunk`` is
    ``stacked_params`` at v_virtual 1, else its circuit's entry (a
    sequence of v entries, or tensors whose dim 0 is v).
    ``stage_aux``: ``stage_fn`` returns ``(y_mb, aux_scalar)``.

    ``head_fn(full_output, *head_args) -> scalar`` runs on the last stage
    on its whole output ``[batch, ...]``; the result is the scalar summed
    over ``pp``. Without it every rank gets the last stage's output (a
    masked psum over ``pp``, as in the reference): a caller that computes
    a loss from it counts it on one stage. ``sp_axis``: the stage sees
    the local sequence shard (its attention runs the ring); the aux is
    then averaged over that axis. Returns ``out`` or ``(out, aux)``."""
    mesh = mesh if mesh is not None else get_mesh()
    pp = mesh.shape.get(pp_axis, 1)
    v = v_virtual
    if sp_axis is not None and mesh.shape.get(sp_axis, 1) <= 1:
        sp_axis = None
    if v > 1 and n_micro < pp:
        raise ValueError(
            f"interleaved schedule needs n_micro >= pp ({n_micro} < {pp})")
    if pp == 1:
        mbs = _to_microbatches(x, n_micro)
        outs, auxs = [], []
        for i in range(n_micro):
            out = None
            for c in range(v):
                with _annotate("pp/stage"):
                    out = stage_fn(_circuit(stacked_params, c, v),
                                   mbs[i] if out is None else out)
                if stage_aux:
                    out, a = out
                    auxs.append(a.float())
            outs.append(out)
        full = _from_microbatches(torch.stack(outs), x.shape)
        res = head_fn(full, *head_args) if head_fn is not None else full
        if not stage_aux:
            return res
        aux = torch.stack(auxs).sum() / n_micro
        if sp_axis is not None:
            aux = _global_share(aux / mesh.shape[sp_axis],
                                _psum(aux.detach(), mesh, sp_axis) /
                                mesh.shape[sp_axis])
        return res, aux

    stage = mesh.axis_index(pp_axis)
    first, last = stage == 0, stage == pp - 1
    n_ticks = v * n_micro + pp - 1
    mbs = _to_microbatches(x, n_micro) if first else None
    mb_shape = (x.shape[0] // n_micro,) + tuple(x.shape[1:])
    prev = torch.zeros(mb_shape, dtype=x.dtype, device=x.device,
                       requires_grad=True)
    ret = [None] * n_micro          # stage 0: circuits come back here
    outputs = [None] * n_micro      # the last stage: finished micro-batches
    on_first = torch.tensor(True, device=x.device)
    aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for t in range(n_ticks):
        with _annotate("pp/ppermute"):
            recv = _ring(prev, mesh, pp_axis)
        if first:
            if v > 1 and t >= pp:
                ret[(t - pp) % n_micro] = recv
            mb = t % n_micro if v > 1 else min(t, n_micro - 1)
            circuit0 = t // n_micro if v > 1 else 0
            own = mbs[mb] if circuit0 == 0 or ret[mb] is None else ret[mb]
            inp = torch.where(on_first, own, recv)
        else:
            inp = recv
        busy = stage <= t < stage + v * n_micro
        if busy:
            c_s = min(max((t - stage) // n_micro, 0), v - 1)
            with _annotate("pp/stage"):
                out = stage_fn(_circuit(stacked_params, c_s, v), inp)
            if stage_aux:
                out, a = out
                aux_acc = aux_acc + a.float()
        else:
            out = inp
        done_t = t - (pp - 1) - (v - 1) * n_micro
        if last and done_t >= 0:
            outputs[done_t % n_micro if v > 1 else done_t] = out
        prev = out

    aux = None
    if stage_aux:
        local = aux_acc / n_micro
        total = _psum(local.detach(), mesh, pp_axis)
        if sp_axis is not None:
            n_sp = mesh.shape[sp_axis]
            local = local / n_sp
            total = _psum(total, mesh, sp_axis) / n_sp
        aux = _global_share(local, total)
    # the non-last stages' backward starts at their last tick
    tail = torch.where(~on_first, prev, 0.0).sum().float()
    if head_fn is not None:
        if last:
            full = _from_microbatches(torch.stack(outputs), x.shape)
            with _annotate("pp/head"):
                loss = head_fn(full, *head_args).float() + tail
        else:
            loss = tail
        out = _global_share(loss, _psum(loss.detach(), mesh, pp_axis))
        return (out, aux) if stage_aux else out
    if last:
        full = _from_microbatches(torch.stack(outputs), x.shape)
    else:
        full = torch.zeros(x.shape, dtype=x.dtype, device=x.device) + tail
    shared = _psum(full, mesh, pp_axis)
    return (shared, aux) if stage_aux else shared
