"""Eager data parallelism (mirrors ``paddle_tpu/distributed/parallel.py:
22-66``; reference: python/paddle/fluid/dygraph/parallel.py
DataParallel:322, the imperative Reducer of reducer.cc).

Each rank runs the whole model on its own batch. At construction every
parameter takes rank 0's value. ``apply_collective_grads`` averages the
gradients over the ranks with ONE collective: every gradient flattened
into one f32 bucket, all-reduced, divided by the world size and cast
back (the reference Reducer's concat-and-allreduce, reducer.cc:463-559).
Paired with ``fleet.distributed_optimizer``, each gradient is all-reduced
a second time at ``step``, the reference's eager semantics
(``fleet/fleet_base.py``); the trainer ``distributed.hybrid`` on a
``dp`` mesh reduces once.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from .collective import all_reduce, broadcast
from .env import get_world_size

__all__ = ["DataParallel"]


def bucket_mean(grads: List[torch.Tensor], n: int,
                group=None) -> List[torch.Tensor]:
    """The mean over the ``n`` ranks of ``group`` (None: the world) of
    every tensor of ``grads``, through one fused f32 bucket all-reduce:
    f32 views of the bucket, shaped like ``grads``."""
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    all_reduce(flat, group=group)
    flat /= n
    return [c.view(g.shape) for c, g in
            zip(flat.split([g.numel() for g in grads]), grads)]


class DataParallel(nn.Module):
    def __init__(self, layers: nn.Module, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        if get_world_size() > 1:
            with torch.no_grad():
                for p in layers.parameters():
                    broadcast(p.data, src=0)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        return loss

    @torch.no_grad()
    def apply_collective_grads(self):
        n = get_world_size()
        if n <= 1:
            return
        with_grad = [p for p in self._layers.parameters()
                     if p.grad is not None]
        if not with_grad:
            return
        for p, g in zip(with_grad,
                        bucket_mean([p.grad for p in with_grad], n)):
            p.grad.copy_(g)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    load_state_dict = set_state_dict
