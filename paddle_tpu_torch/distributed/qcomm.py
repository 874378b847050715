"""The data-parallel communication module: the f32, bf16 and int8
spellings of the gradient reduction and the ZeRO parameter return
(mirrors ``paddle_tpu/distributed/qcomm.py``).

The reference runs these inside a ``shard_map`` manual over ``dp``; here
every rank runs them on its own tensors over its ``dp`` process group
(``mesh.group("dp")``), pieces placed by axis index:

- ``validate_dp_grad_comm`` / ``validate_dp_param_comm``: the trainers'
  knob checks, with the reference's messages;
- ``zero_chunk_len``: the per-rank flat chunk of the ZeRO layout;
- ``dp_batch_specs``: which batch leaves ride dim 0 over ``dp``;
- ``reduce_scatter`` (f32) and ``all_gather_cast`` (the bf16 payload
  goes with an f32 master);
- ``quantize_blockwise`` / ``dequantize_blockwise``: int8 values with
  one f32 scale (``amax / 127``) a ``block`` of elements, rounded half
  to even and clipped at ±127, as the reference's;
- the EQuARX ring: ``quantized_reduce_scatter`` (``n - 1`` hops of the
  int8 partial sum and its scales; each rank dequantizes, adds its own
  f32 chunk and quantizes again), ``quantized_all_gather`` (the owned
  chunk quantized once, int8 and scales gathered) and their composition
  ``quantized_all_reduce`` / ``quantized_all_reduce_tree`` (one fused
  flat buffer); the hops keep the reference's order. The reference's
  compiled ring is not bit-equal to its own source arithmetic: inside
  the ``shard_map`` program XLA turns ``amax / 127`` into ``amax *
  f32(1/127)`` and contracts the dequantize-and-add into a fused
  multiply-add. The port computes the source's arithmetic, so the two
  rings agree within the reference's bound (one quantization step a hop,
  plus one for the gather), and mostly bit for bit;
- ``dp_quantized_value_and_grads``: a loss and its gradients on this
  rank's batch slice, the gradients reduced by the quantized ring;
- ``dp_zero_step``: the ZeRO-1/2 flat-slab update of both trainers, on
  the f32 or the int8 ring, with an f32, bf16 or int8 return.

Counted result bytes of the int8 all-reduce (``profiler.instrument``):
``(N-1)/N·T + T`` int8 bytes plus ``4·T/block`` f32 scale bytes a hop
and in the gather, against the f32 all-reduce's ``4T``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from ..utils.tree import flatten, unflatten
from .collective import ReduceOp
from .mesh import P
from .primitives import _gather, _permuted, _reduced, _scatter

__all__ = ["reduce_scatter", "all_gather_cast", "zero_chunk_len",
           "dp_zero_step", "validate_dp_grad_comm",
           "validate_dp_param_comm", "dp_batch_specs",
           "quantize_blockwise", "dequantize_blockwise",
           "quantized_all_reduce", "quantized_all_reduce_tree",
           "quantized_reduce_scatter", "quantized_all_gather",
           "dp_quantized_value_and_grads"]


def validate_dp_grad_comm(dp_grad_comm: str, mesh, *, zero_stage: int = 0,
                          block: int = 2048, unsupported=()) -> None:
    """The trainers' ``dp_grad_comm`` check: value in {'f32', 'int8'}
    (the reference's messages). 'int8' additionally needs a positive
    block, a pure-DP mesh, ZeRO stage <= 2 and none of ``unsupported``
    ``(name, flag)`` pairs (the reference's checks, in its order)."""
    if dp_grad_comm not in ("f32", "int8"):
        raise ValueError(
            f"unknown dp_grad_comm {dp_grad_comm!r}; expected "
            "'f32' or 'int8'")
    if dp_grad_comm != "int8":
        return
    if block < 1:
        raise ValueError("dp_grad_block must be >= 1")
    other = {a: s for a, s in mesh.shape.items()
             if a != "dp" and s > 1}
    if other:
        raise NotImplementedError(
            f"dp_grad_comm='int8' supports pure data parallelism; "
            f"mesh has non-dp axes {other} (quantized collectives "
            "under tp/pp/sp are ROADMAP residue)")
    if zero_stage >= 3:
        raise NotImplementedError(
            "dp_grad_comm='int8' with ZeRO stage 3 (parameter "
            "sharding) is ROADMAP residue; stages 1-2 run the "
            "sharded weight update on the quantized ring")
    for name, flag in unsupported:
        if flag:
            raise NotImplementedError(
                f"dp_grad_comm='int8' does not compose with {name}")


def validate_dp_param_comm(dp_param_comm: str, zero_manual: bool) -> None:
    """The ``dp_param_comm`` check (the ZeRO all-gather's payload):
    value in {'f32', 'bf16', 'int8'}; the compressed spellings only on
    the flat-slab sharded update."""
    if dp_param_comm not in ("f32", "bf16", "int8"):
        raise ValueError(
            f"unknown dp_param_comm {dp_param_comm!r}; expected "
            "'f32', 'bf16' or 'int8'")
    if dp_param_comm != "f32" and not zero_manual:
        raise ValueError(
            f"dp_param_comm={dp_param_comm!r} requires the manual "
            "ZeRO sharded update (zero_stage 1/2 on a pure-DP mesh "
            "with dp > 1); without it params never ride a collective")


def dp_batch_specs(batch, dp: int):
    """Which batch leaves each dp rank slices on dim 0 (``P('dp')``) and
    which it keeps whole (``P()``): a leaf rides the batch axis when its
    dim 0 equals the first array leaf's and divides ``dp``; an
    indivisible batch is kept whole everywhere (every rank computes the
    full batch: wasteful but exact). The reference's rule."""
    lead = next((b.shape[0] for b in batch
                 if getattr(b, "ndim", 0) >= 1), None)
    if lead is None or lead % dp:
        return tuple(P() for _ in batch)
    return tuple(
        P("dp") if getattr(b, "ndim", 0) >= 1 and b.shape[0] == lead
        else P()
        for b in batch)


def zero_chunk_len(total: int, axis_size: int, block: int) -> int:
    """Per-rank flat chunk length of the ZeRO layout: ``total`` elements
    split into one chunk a rank, each a whole number of ``block``s.
    Callers pad their flat buffer to ``axis_size * zero_chunk_len(...)``."""
    return block * max(1, math.ceil(total / (axis_size * block)))


def _dp(mesh):
    return mesh.group("dp"), mesh.group_order("dp")


def reduce_scatter(x: torch.Tensor, mesh, axis_size: int, *,
                   mean: bool = False) -> torch.Tensor:
    """The flat f32 ``x`` (length a multiple of ``axis_size``) summed over
    the ``dp`` ranks; rank r keeps chunk r (``mean``: divided by the axis
    size). The reference's f32 ring gives the same ownership."""
    n = int(axis_size)
    if n < 1:
        raise ValueError(f"axis_size must be >= 1, got {n}")
    flat = x.float().reshape(-1)
    if n == 1:
        return flat / n if mean else flat
    if flat.shape[0] % n:
        raise ValueError(
            f"reduce-scatter input size {flat.shape[0]} must be a "
            f"multiple of axis_size {n}")
    out = _scatter(flat, *_dp(mesh), 0, True)
    return out / n if mean else out


def all_gather_cast(chunk: torch.Tensor, mesh,
                    dtype=torch.float32) -> torch.Tensor:
    """Every rank's owned chunk, carried at ``dtype`` (bf16 halves the
    payload; f32 is exact), as the flat f32 concatenation in chunk
    order."""
    group, order = _dp(mesh)
    return _gather(chunk.to(dtype), group, order, 0, True).float()


def dp_zero_step(mesh, axis_size: int, block: int, grad_comm: str,
                 param_comm: str, update_fn, params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], flat_state: Dict[str,
                                                                 torch.Tensor],
                 lr, step_no: int, plr, wd, *,
                 clip_norm: Optional[float] = None,
                 guard: bool = False) -> None:
    """The ZeRO-1/2 flat-slab update over the ``dp`` group (the body of
    the reference's ``dp_zero_step``, run by each rank after its own
    backward):

    1. the gradients (this rank's, of its batch slice) flattened into
       ONE f32 buffer, padded to ``axis_size * chunk``
       (``zero_chunk_len``), reduced to their owner (mean): the int8 ring
       for ``grad_comm='int8'``, else the f32 reduce-scatter; rank r
       keeps the reduced chunk r;
    2. clip by global norm (``clip_norm``): the squared sums of the owned
       chunks all-reduced over ``dp``, then ``g * (clip/gn if gn > clip
       else 1)``, the reference's spelling;
    3. ``update_fn(p_chunk, g_chunk, moments, lr, step_no, plr, wd)``
       updates the owned flat slice in place; the parameter chunk is
       ``flat_state['master']`` when present (the f32 master of a
       compressed ``param_comm``), else sliced from the parameters.
       Moments live at chunk shape: the memory win. ``plr``/``wd`` are
       floats or this rank's chunk of the per-element knob vector;
    4. the updated chunks all-gathered back (``param_comm`` 'f32' exact,
       'bf16' cast for transport, 'int8' the quantized gather) and
       written into ``params`` in place.

    ``flat_state`` is updated in place. ``guard`` (the bad-step verdict)
    is ROADMAP queue 1 item 8b."""
    if guard:
        raise NotImplementedError(
            "guard_bad_steps is not ported yet: ROADMAP queue 1 item 8b "
            "(resilience)")
    n = int(axis_size)
    sizes = [p.numel() for p in params]
    total = sum(sizes)
    chunk = zero_chunk_len(total, n, block)
    pad = chunk * n - total
    dev = params[0].device
    flat_g = torch.cat([g.float().reshape(-1) for g in grads]
                       + [torch.zeros(pad, device=dev)])
    if grad_comm == "int8":
        g_c = quantized_reduce_scatter(flat_g, mesh, n, block=block,
                                       mean=True)
    else:
        g_c = reduce_scatter(flat_g, mesh, n, mean=True)
    del flat_g
    if clip_norm is not None:
        gsq = _reduced(g_c.square().sum(), ReduceOp.SUM, mesh.group("dp"))
        gn = torch.sqrt(gsq)
        g_c = g_c * torch.where(gn > clip_norm, clip_norm / gn,
                                torch.ones_like(gn))
    r = mesh.axis_index("dp")
    if "master" in flat_state:
        p_c = flat_state["master"]
    else:
        p_c = _flat_chunk(params, r, chunk, chunk * n)
    moments = {k: v for k, v in flat_state.items() if k != "master"}
    update_fn(p_c, g_c, moments, lr, step_no, plr, wd)
    if param_comm == "int8":
        full = quantized_all_gather(p_c, mesh, block=block)
    else:
        full = all_gather_cast(p_c, mesh, torch.bfloat16
                               if param_comm == "bf16" else torch.float32)
    off = 0
    with torch.no_grad():
        for p, sz in zip(params, sizes):
            p.copy_(full[off:off + sz].view(p.shape))
            off += sz


#: symmetric int8 range of every payload (round half to even, as the
#: reference's ``jnp.round``)
_QMAX = 127.0


def quantize_blockwise(x: torch.Tensor, block: int = 2048):
    """Flat f32 ``x`` (length divisible by ``block``) -> (int8 values, f32
    per-block scales ``amax / 127``). An all-zero block gets scale 0 and
    quantizes to exact zeros."""
    xb = x.float().reshape(-1, block)
    scale = xb.abs().amax(1) / _QMAX
    q = torch.round(xb / torch.clamp(scale, min=1e-30)[:, None])
    q = torch.clamp(q, -_QMAX, _QMAX).to(torch.int8)
    return q.reshape(-1), scale


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor,
                         block: int = 2048) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise` (f32 out)."""
    return (q.reshape(-1, block).float() * scale[:, None]).reshape(-1)


def _ring_next(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` of the rank one dp index behind (the ring's forward hop:
    index i sends to i + 1), counted as a ``collective_permute``."""
    group, order = _dp(mesh)
    n = len(order)
    pairs = [(order[i], order[(i + 1) % n]) for i in range(n)]
    return _permuted(x.contiguous(), pairs, sorted(mesh.axis_ranks("dp")),
                     group)


def _check_ring(n: int, block: int) -> None:
    if n < 1:
        raise ValueError(f"axis_size must be >= 1, got {n}")
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")


def quantized_reduce_scatter(x: torch.Tensor, mesh, axis_size: int, *,
                             block: int = 2048,
                             mean: bool = False) -> torch.Tensor:
    """The int8 ring's reduce-scatter half: ``x`` is this rank's flat f32
    buffer, padded to ``axis_size * chunk`` with ``chunk`` a multiple of
    ``block`` (``zero_chunk_len``); returns the reduced f32 chunk this
    rank owns (dp index r owns ``x[r*chunk:(r+1)*chunk]``) after
    ``axis_size - 1`` int8 hops with f32 accumulation. Rank r seeds
    chunk r-1 and at hop s adds its own chunk r-2-s to the incoming
    partial: the reference's order."""
    n = int(axis_size)
    _check_ring(n, block)
    flat = x.float().reshape(-1)
    if n == 1:
        return flat / n if mean else flat
    if flat.shape[0] % (n * block):
        raise ValueError(
            f"reduce-scatter input size {flat.shape[0]} must be a "
            f"multiple of axis_size*block = {n * block}; pad to "
            "zero_chunk_len first")
    chunks = flat.reshape(n, -1)
    r = mesh.axis_index("dp")
    acc = chunks[(r - 1) % n]
    for s in range(n - 1):
        q, sc = quantize_blockwise(acc, block)
        q, sc = _ring_next(q, mesh), _ring_next(sc, mesh)
        acc = dequantize_blockwise(q, sc, block) + chunks[(r - 2 - s) % n]
    return acc / n if mean else acc


def quantized_all_gather(chunk: torch.Tensor, mesh, *,
                         block: int = 2048) -> torch.Tensor:
    """The int8 ring's all-gather half: this rank's owned chunk quantized
    once, int8 values and scales gathered over ``dp`` and dequantized
    here; the flat f32 concatenation in chunk order."""
    group, order = _dp(mesh)
    q, sc = quantize_blockwise(chunk.float(), block)
    qg = _gather(q, group, order, 0, True)
    sg = _gather(sc, group, order, 0, True)
    return dequantize_blockwise(qg, sg, block)


def quantized_all_reduce(x: torch.Tensor, mesh, axis_size: int, *,
                         block: int = 2048,
                         mean: bool = False) -> torch.Tensor:
    """The EQuARX all-reduce of ``x`` over ``dp``: the flat f32 buffer
    padded to ``zero_chunk_len``, :func:`quantized_reduce_scatter`, then
    :func:`quantized_all_gather`; ``x``'s shape and dtype."""
    n = int(axis_size)
    _check_ring(n, block)
    flat = x.float().reshape(-1)
    if n == 1:
        return (flat / n if mean else flat).reshape(x.shape).to(x.dtype)
    size = flat.shape[0]
    chunk = zero_chunk_len(size, n, block)
    flat = torch.cat([flat, flat.new_zeros(chunk * n - size)])
    acc = quantized_reduce_scatter(flat, mesh, n, block=block, mean=mean)
    full = quantized_all_gather(acc, mesh, block=block)[:size]
    return full.reshape(x.shape).to(x.dtype)


def quantized_all_reduce_tree(tree, mesh, axis_size: int, *,
                              block: int = 2048, mean: bool = False):
    """:func:`quantized_all_reduce` over every tensor of ``tree`` (dicts,
    lists, tuples) as ONE fused ring over their f32 concatenation (the
    EQuARX fused-buffer layout; dict keys in sorted order, as jax
    flattens them), each restored to its shape and dtype."""
    items = flatten(tree)
    leaves = [(k, l) for k, l in items if l is not None]
    if not leaves:
        return tree
    flat = torch.cat([l.float().reshape(-1) for _, l in leaves])
    red = quantized_all_reduce(flat, mesh, axis_size, block=block,
                               mean=mean)
    out, off = dict(items), 0
    for k, l in leaves:
        out[k] = red[off:off + l.numel()].view(l.shape).to(l.dtype)
        off += l.numel()
    return unflatten(tree, out)


def dp_quantized_value_and_grads(mesh, axis_size: int, block: int, fn,
                                 rep_args, batch, batch_specs, key: int):
    """``fn(rep_args, key, local_batch) -> (loss, aux, grads)`` on this
    rank's part of ``batch`` (the leaves ``batch_specs`` puts on ``dp``
    sliced on dim 0 at the dp index; the key folded with it, so dropout
    masks differ by rank), then the dp mean of the loss and of the
    floating ``aux`` leaves, and the quantized ring (mean) over the
    gradient tree. Returns the reduced ``(loss, aux, grads)``."""
    from ..core import rng as _rng

    n = int(axis_size)
    r = mesh.axis_index("dp") if n > 1 else 0
    local = tuple(b.chunk(n, 0)[r] if spec == P("dp") else b
                  for b, spec in zip(batch, batch_specs))
    loss, aux, grads = fn(rep_args, _rng.fold_in(key, r), local)
    if n == 1:
        return loss, aux, grads
    group = mesh.group("dp")

    def mean(a):
        if torch.is_tensor(a) and a.is_floating_point():
            return _reduced(a, ReduceOp.SUM, group) / n
        return a

    aux = unflatten(aux, {k: mean(a) for k, a in flatten(aux)})
    grads = quantized_all_reduce_tree(grads, mesh, n, block=block,
                                      mean=True)
    return mean(loss), aux, grads


def _flat_chunk(values: List[torch.Tensor], rank: int, chunk: int,
               slab: int) -> torch.Tensor:
    """This rank's ``chunk`` of the flat f32 concatenation of ``values``
    padded with zeros to ``slab`` elements."""
    dev = values[0].device
    flat = torch.cat([v.detach().float().reshape(-1) for v in values])
    flat = torch.cat([flat, torch.zeros(slab - flat.numel(), device=dev)])
    return flat[rank * chunk:(rank + 1) * chunk].clone()
