"""Process bring-up on ``torch.distributed`` (mirrors
``paddle_tpu/distributed/env.py``; reference:
python/paddle/distributed/parallel.py:57 init_parallel_env,
fluid/dygraph/parallel.py ParallelEnv).

The launcher's env protocol is the reference's: ``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ENDPOINTS``,
``PADDLE_CURRENT_ENDPOINT``, ``PADDLE_RANK_IN_NODE``, and
``PADDLE_COORDINATOR`` (else the first endpoint) as the address of the
TCP store every rank meets at. An address with a scheme (``file://...``,
``tcp://...``) is handed to ``init_process_group`` as it is.

One process holds one card: ``cuda:<FLAGS_selected_gpus>``, whose
default is ``PADDLE_RANK_IN_NODE``. The backend defaults to ``nccl`` on
a card and ``gloo`` on the CPU. An explicit backend (the argument, or
``PADDLE_DISTRI_BACKEND``, which the launcher's ``--backend`` sets)
overrides that default and never moves the device, except ``cpu``, the
reference's spelling, which means gloo on the CPU. Without a card the
default device raises; nothing drops to the CPU on its own. A world of
one process is a no-op, as in the reference.

``plan_world(world_size, rank)`` is the planning world: torch.distributed's
``fake`` backend (``FakeStore``), a world of any size inside one process
seen from one rank, whose collectives move nothing. A mesh built in it
makes the same axis groups as a real world of that size, so a trainer
there plans one rank's step (``plan.py``): the counterpart of the
reference's ``--xla_force_host_platform_device_count=16``
(``benchmarks/plan_13b.py:21-25``). The backend lives in a private module
of torch; where it is missing, ``plan_world`` raises.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..core.place import resolve_device

__all__ = ["ParallelEnv", "init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "plan_world"]

_initialized = False
_device: Optional[torch.device] = None


def _selected_gpu() -> int:
    sel = os.environ.get("FLAGS_selected_gpus")
    if sel:
        return int(sel.split(",")[0])
    return int(os.environ.get("PADDLE_RANK_IN_NODE", "0"))


class ParallelEnv:
    """reference: fluid/dygraph/parallel.py ParallelEnv."""

    @property
    def rank(self) -> int:
        return get_rank()

    @property
    def world_size(self) -> int:
        return get_world_size()

    @property
    def device_id(self) -> int:
        return _selected_gpu()

    @property
    def device(self) -> torch.device:
        """The device this rank's collectives and tensors use (set by
        ``init_parallel_env``; ``cuda:<device_id>`` before it)."""
        return _device if _device is not None else \
            torch.device("cuda", self.device_id)

    @property
    def current_endpoint(self) -> str:
        eps = self.trainer_endpoints
        return eps[self.rank] if self.rank < len(eps) else ""

    @property
    def trainer_endpoints(self):
        return os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")

    @property
    def nranks(self):
        return self.world_size

    @property
    def local_rank(self):
        return self.rank


def _init_method(addr: str) -> str:
    return addr if "://" in addr else f"tcp://{addr}"


def init_parallel_env(coordinator_address: Optional[str] = None,
                      num_processes: Optional[int] = None,
                      process_id: Optional[int] = None,
                      backend: Optional[str] = None):
    """``paddle.distributed.init_parallel_env``: reads the env protocol
    where an argument is absent, picks the device and backend (module
    docstring) and joins the default process group. A world of one is a
    no-op."""
    global _initialized, _device
    if _initialized:
        return ParallelEnv()
    n = num_processes if num_processes is not None else \
        int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    if n > 1:
        pid = process_id if process_id is not None else \
            int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        coord = coordinator_address or os.environ.get("PADDLE_COORDINATOR")
        if not coord:
            eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")
            coord = eps[0] if eps[0] else "127.0.0.1:12355"
        backend = backend or os.environ.get("PADDLE_DISTRI_BACKEND") or None
        if backend not in (None, "nccl", "gloo", "cpu"):
            raise ValueError(f"unknown backend {backend!r}: nccl, gloo or "
                             "cpu (gloo on the CPU)")
        dev = resolve_device("cpu" if backend == "cpu" else
                             torch.device("cuda", _selected_gpu()))
        if backend in (None, "cpu"):
            backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=_init_method(coord),
                                rank=pid, world_size=n)
        _device = dev
    _initialized = True
    return ParallelEnv()


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_initialized() -> bool:
    return _initialized



@contextlib.contextmanager
def plan_world(world_size: int, rank: int = 0):
    """A planning world of ``world_size`` ranks in this process, as rank
    ``rank`` (module docstring). The default process group is destroyed
    on exit and the current mesh restored."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from .mesh import get_mesh, set_mesh

    if dist.is_initialized():
        raise RuntimeError("plan_world: this process already has a process "
                           "group; plan in a process of its own")
    if not 0 <= rank < world_size:
        raise ValueError(f"plan_world: rank {rank} outside a world of "
                         f"{world_size}")
    mesh = get_mesh()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        set_mesh(mesh)
        dist.destroy_process_group()
