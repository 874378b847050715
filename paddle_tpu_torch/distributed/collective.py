"""Eager collectives over ``torch.distributed`` (mirrors
``paddle_tpu/distributed/collective.py:31-174``; reference:
python/paddle/distributed/collective.py:101-457, the C++ data plane of
operators/collective/c_allreduce_op.h:157).

Each op works in place on a ``torch.Tensor`` (or appends to the output
list), as the reference's does on its ``Tensor``, and a world of one
process is the identity. The reference spells every op as a host
all-gather followed by a local reduction; the port calls the process
group's own op, and the reference's all-gather spelling only where the
backend lacks the op for the tensor's device (``_p2p_native``). The
spelling is chosen from the backend and the device, never by catching
an error. ``reduce`` leaves the result
on every rank and ``reduce_scatter``/``alltoall`` index by rank, as the
reference's do.

Every op notes its kind, dtype and result-buffer bytes for the
collective accounting (``profiler.instrument.note_collective``) under the
reference's op names: ``all_reduce``, ``all_gather``, ``reduce_scatter``,
``all_to_all``, ``collective_permute`` and ``collective_broadcast`` (a
broadcast, and a scatter: one source, every rank keeps its slice).

The SPMD counterparts, which take a mesh axis name and are
differentiable, are ``primitives.py``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from ..profiler.instrument import note_collective

__all__ = ["ReduceOp", "all_reduce", "all_gather", "broadcast", "reduce",
           "scatter", "reduce_scatter", "alltoall", "barrier", "get_group",
           "send", "recv", "split"]


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3


_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT}


def _world(group=None) -> int:
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def _p2p_native(tensor: torch.Tensor, group) -> bool:
    """Whether the backend sends point to point for this tensor's device.
    gloo runs every other op of this module on CUDA tensors (staged
    through pinned host memory; found on an H100 with torch 2.11) but no
    point-to-point send, so ``ppermute`` takes the reference's all-gather
    spelling there. ``all_to_all`` is ``all_to_all_single`` on a stacked
    tensor on every backend: gloo has no list all-to-all."""
    return tensor.device.type != "cuda" or dist.get_backend(group) != "gloo"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# the process-group calls shared with primitives.py (no accounting here)
# ---------------------------------------------------------------------------
def _gather_list(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t``, in group-rank order."""
    out = [torch.empty_like(t) for _ in range(_world(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def _all_reduce_(t: torch.Tensor, op, group) -> torch.Tensor:
    """``t`` reduced over ``group``, in place."""
    dist.all_reduce(t, op=_TORCH_OP[op], group=group)
    return t


def _reduce_scatter(chunks: Sequence[torch.Tensor], op, group
                    ) -> torch.Tensor:
    """Group rank r's result: ``chunks[r]`` reduced over the group."""
    chunks = [c.contiguous() for c in chunks]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, op=_TORCH_OP[op], group=group)
    return out


def _all_to_all(chunks: Sequence[torch.Tensor], group
                ) -> List[torch.Tensor]:
    """Group rank r's result: ``[rank s's chunks[r] for s]``."""
    stacked = torch.stack(list(chunks))
    out = torch.empty_like(stacked)
    dist.all_to_all_single(out, stacked, group=group)
    return list(out.unbind(0))


def _permute(x: torch.Tensor, pairs: Sequence[Tuple[int, int]],
             ranks: Sequence[int], group) -> torch.Tensor:
    """``ppermute``: for each ``(src, dst)`` of group indices, dst
    receives src's ``x``; a rank no pair sends to gets zeros.
    ``ranks``: the group's global ranks, in group order."""
    me = dist.get_rank(group)
    src = [s for s, d in pairs if d == me]
    out = torch.zeros_like(x)
    if not _p2p_native(x, group):
        got = _gather_list(x, group)
        return got[src[0]] if src else out
    x = x.contiguous()
    ops = []
    for s, d in pairs:
        if s == me and d != me:
            ops.append(dist.P2POp(dist.isend, x, ranks[d], group))
    if src and src[0] != me:
        ops.append(dist.P2POp(dist.irecv, out, ranks[src[0]], group))
    elif src:
        out.copy_(x)
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return out


# ---------------------------------------------------------------------------
# the eager API
# ---------------------------------------------------------------------------
def all_reduce(tensor: torch.Tensor, op=ReduceOp.SUM, group=None,
               use_calc_stream=True):
    """In-place all-reduce across ranks (reference: c_allreduce_op.h)."""
    if _world(group) == 1:
        return tensor
    _all_reduce_(tensor, op, group)
    note_collective("all_reduce", tensor.dtype, _nbytes(tensor))
    return tensor


def all_gather(tensor_list: List[torch.Tensor], tensor: torch.Tensor,
               group=None, use_calc_stream=True):
    """Appends every rank's ``tensor`` to ``tensor_list``."""
    if _world(group) == 1:
        tensor_list.append(tensor.clone())
        return tensor_list
    got = _gather_list(tensor, group)
    tensor_list.extend(got)
    note_collective("all_gather", tensor.dtype, len(got) * _nbytes(tensor))
    return tensor_list


def broadcast(tensor: torch.Tensor, src: int, group=None,
              use_calc_stream=True):
    """``tensor`` takes global rank ``src``'s value."""
    if _world(group) == 1:
        return tensor
    dist.broadcast(tensor, src, group=group)
    note_collective("collective_broadcast", tensor.dtype, _nbytes(tensor))
    return tensor


def reduce(tensor: torch.Tensor, dst: int, op=ReduceOp.SUM, group=None,
           use_calc_stream=True):
    """The reference's reduce: every rank, ``dst`` included, holds the
    reduction (an all-reduce)."""
    return all_reduce(tensor, op, group, use_calc_stream)


def scatter(tensor: torch.Tensor, tensor_list=None, src=0, group=None,
            use_calc_stream=True):
    """Rank i takes ``tensor_list[i]`` of global rank ``src``."""
    if _world(group) == 1:
        if tensor_list:
            tensor.copy_(torch.as_tensor(tensor_list[0]))
        return tensor
    lst = None
    if dist.get_rank() == src:
        lst = [torch.as_tensor(t).to(tensor).contiguous()
               for t in tensor_list]
    dist.scatter(tensor, lst, src=src, group=group)
    note_collective("collective_broadcast", tensor.dtype, _nbytes(tensor))
    return tensor


def reduce_scatter(tensor: torch.Tensor, tensor_list, op=ReduceOp.SUM,
                   group=None):
    """Group rank r's ``tensor``: ``tensor_list[r]`` reduced over ranks
    (the reference sums whatever ``op`` says; here ``op`` is applied)."""
    if _world(group) == 1:
        tensor.copy_(torch.as_tensor(tensor_list[0]))
        return tensor
    lst = [torch.as_tensor(t).to(tensor) for t in tensor_list]
    tensor.copy_(_reduce_scatter(lst, op, group))
    note_collective("reduce_scatter", tensor.dtype, _nbytes(tensor))
    return tensor


def alltoall(in_tensor_list, out_tensor_list, group=None):
    """Appends, for each rank r, rank r's ``in_tensor_list[me]``."""
    if _world(group) == 1:
        out_tensor_list.extend(t.clone() for t in in_tensor_list)
        return out_tensor_list
    got = _all_to_all(list(in_tensor_list), group)
    out_tensor_list.extend(got)
    note_collective("all_to_all", got[0].dtype, sum(_nbytes(t) for t in got))
    return out_tensor_list


def send(tensor, dst=0, group=None, use_calc_stream=True):
    raise NotImplementedError(
        "eager p2p send/recv is served by the SPMD path (primitives."
        "ppermute, ring_permute), as in the reference")


recv = send


def barrier(group=None):
    """reference: operators/collective/barrier_op."""
    if _world(group) == 1:
        return
    dist.barrier(group=group)


def get_group(id=0):  # noqa: A002
    """The default group (None), as in the reference."""
    return None


# --- Megatron-style parallel building block -------------------------------
def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """``paddle.distributed.split`` (reference: distributed/collective.py
    :566 _parallel_linear / _parallel_embedding): a tensor-parallel layer
    built on ``x``'s device and applied to ``x``. ``bias_attr=False``
    drops the bias, as in the reference."""
    from .parallel_layers import (ColumnParallelLinear, ParallelEmbedding,
                                  RowParallelLinear)

    has_bias = bias_attr is not False
    if operation == "linear":
        in_f, out_f = size
        if axis == 1 or axis == "column":
            layer = ColumnParallelLinear(in_f, out_f, weight_attr=weight_attr,
                                         has_bias=has_bias,
                                         gather_output=gather_out,
                                         device=x.device)
        else:
            layer = RowParallelLinear(in_f, out_f, weight_attr=weight_attr,
                                      has_bias=has_bias, device=x.device)
        return layer(x)
    if operation == "embedding":
        vocab, dim = size
        layer = ParallelEmbedding(vocab, dim, weight_attr=weight_attr,
                                  device=x.device)
        return layer(x)
    raise ValueError(f"Unsupported split operation: {operation}")
