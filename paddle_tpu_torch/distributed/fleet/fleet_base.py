"""Fleet facade (mirrors ``paddle_tpu/distributed/fleet/fleet_base.py:
20-260``; reference: python/paddle/distributed/fleet/base/fleet_base.py
— Fleet:63, init:130, distributed_optimizer:598, distributed_model:643).

``distributed_model`` wraps a model in ``DataParallel``;
``distributed_optimizer`` returns a ``DistributedOptimizer`` that applies
the strategy's eager semantics at ``step``: the per-parameter gradient
all-reduce and its division, ``gradient_merge``, and ``localsgd`` /
``adaptive_localsgd``. ``save_persistables`` saves a trainer's sharded
state through ``distributed.checkpoint``, or an eager model's
``state_dict`` as ``persistables.pdparams`` (``framework.io``). The
LARS/LAMB swap needs ``Momentum``, ``Lars`` and ``Lamb`` (ROADMAP queue
1 item 9) and raises, naming the item.

The double gradient sync is kept on purpose: with a model wrapped by
``DataParallel``, whose ``apply_collective_grads`` has already averaged
every gradient, ``step`` all-reduces each one again and divides by the
world size. Those are the reference's eager semantics
(``paddle_tpu/distributed/fleet/fleet_base.py:199-206``), and the second
all-reduce averages values that are already equal, so the result does
not change. The data-parallel path that reduces every gradient once is
the trainer, ``distributed.hybrid.HybridPipelineTrainer`` (or
``strategy_compiler.compile_train_step``) on a ``dp`` mesh.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from ...optimizer.optimizer import Optimizer
from ..env import ParallelEnv, get_rank, get_world_size, init_parallel_env
from .distributed_strategy import DistributedStrategy

__all__ = ["Fleet", "DistributedOptimizer", "fleet"]


class _RoleMaker:
    """reference: fleet/base/role_maker.py PaddleCloudRoleMaker —
    topology from the env protocol."""

    def __init__(self, is_collective=True):
        self.is_collective = is_collective

    def worker_index(self):
        return get_rank()

    def worker_num(self):
        return get_world_size()

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def is_first_worker(self):
        return get_rank() == 0


class Fleet:
    def __init__(self):
        self._role_maker: Optional[_RoleMaker] = None
        self._strategy: Optional[DistributedStrategy] = None

    def init(self, role_maker=None, is_collective=True, strategy=None):
        init_parallel_env()
        self._role_maker = role_maker or _RoleMaker(is_collective)
        self._strategy = strategy or DistributedStrategy()
        return self

    @property
    def _final_strategy(self):
        return self._strategy

    def worker_index(self):
        return self._role_maker.worker_index()

    def worker_num(self):
        return self._role_maker.worker_num()

    def is_first_worker(self):
        return self._role_maker.is_first_worker()

    def worker_endpoints(self, to_string=False):
        eps = ParallelEnv().trainer_endpoints
        return ",".join(eps) if to_string else eps

    def barrier_worker(self):
        from ..collective import barrier

        barrier()

    def distributed_optimizer(self, optimizer: Optimizer, strategy=None):
        if strategy is not None:
            self._strategy = strategy
        return DistributedOptimizer(optimizer, self._strategy, self)

    def distributed_model(self, model):
        """Dygraph DP wrapper (reference: fleet_base.py:643 →
        paddle.DataParallel)."""
        from ..parallel import DataParallel

        self._model = model
        return DataParallel(model)

    def save_persistables(self, exe=None, dirname=None, main_program=None,
                          mode=0, trainer=None, model=None, optimizer=None,
                          step=0):
        """Save training persistables (parameters and optimizer state),
        as the reference's (``fleet_base.py:93-125``).

        ``trainer``: a trainer with ``device_state()``: a sharded sync
        save of step ``step`` (``distributed.checkpoint``; every rank
        calls it); returns the step directory. ``model``/``optimizer``
        (default the model of ``distributed_model``): rank 0 writes
        ``{"model": state_dict[, "optimizer": state_dict]}`` to
        ``dirname/persistables.pdparams`` with ``framework.io.save``;
        returns ``dirname``."""
        if dirname is None:
            dirname = exe if isinstance(exe, str) else None
        if dirname is None:
            raise ValueError("save_persistables needs dirname")
        if trainer is not None and hasattr(trainer, "device_state"):
            from .. import checkpoint as dck

            h = dck.save(dirname, trainer.device_state(), step=step,
                         meta={"step": step}, async_=False)
            return h.directory
        model = model or getattr(self, "_model", None)
        if model is None:
            raise ValueError(
                "save_persistables needs trainer= or model= (no global "
                "static program exists)")
        if self.is_first_worker():
            from ...framework import io as fio

            state = {"model": model.state_dict()}
            if optimizer is not None:
                state["optimizer"] = optimizer.state_dict()
            fio.save(state, os.path.join(dirname, "persistables.pdparams"))
        return dirname

    def stop_worker(self):
        pass


class DistributedOptimizer:
    """reference: fleet_base.py distributed_optimizer's return value. The
    strategy's eager semantics at ``step`` (module docstring); every
    other attribute is the inner optimizer's."""

    def __init__(self, inner_opt: Optimizer, strategy: DistributedStrategy,
                 fleet_obj: Fleet):
        self.inner_opt = self._maybe_swap(inner_opt, strategy)
        self.user_defined_strategy = strategy
        self._fleet = fleet_obj
        self._merge_count = 0
        self._local_step = 0
        self._since_sync = 0
        self._localsgd_lr0 = None

    @staticmethod
    def _maybe_swap(opt, strategy):
        """LARS/LAMB meta-optimizers (reference: meta_optimizers/
        lars_optimizer.py, lamb_optimizer.py)."""
        if strategy is not None and (strategy.lars or strategy.lamb):
            raise NotImplementedError(
                "the LARS/LAMB swap needs Momentum, Lars and Lamb, not "
                "ported yet: ROADMAP queue 1 item 9 (long tail)")
        return opt

    def __getattr__(self, name):
        return getattr(self.inner_opt, name)

    def _params(self):
        return self.inner_opt._parameter_list or []

    @torch.no_grad()
    def step(self):
        from ..collective import all_reduce

        strategy = self.user_defined_strategy
        if strategy and strategy.gradient_merge:
            k = strategy.gradient_merge_configs.k_steps
            self._merge_count += 1
            if self._merge_count % k != 0:
                return  # accumulate only (grads keep summing into .grad)
            if strategy.gradient_merge_configs.avg:
                for p in self._params():
                    if p.grad is not None:
                        p.grad.div_(k)
        # LocalSGD (reference: meta_optimizers/localsgd_optimizer.py):
        # from begin_step on, skip the per-step gradient sync and average
        # the PARAMETERS every k steps instead (one fused all-reduce); the
        # adaptive variant grows k as the lr decays (k_t = round(init_k *
        # sqrt(lr0 / lr_t))). Before begin_step it is synchronous SGD.
        localsgd = strategy is not None and (strategy.localsgd or
                                             strategy.adaptive_localsgd)
        self._local_step += 1
        local_phase = False
        if localsgd:
            begin = (strategy.adaptive_localsgd_configs.begin_step
                     if strategy.adaptive_localsgd
                     else strategy.localsgd_configs.begin_step)
            local_phase = self._local_step >= begin
        n = get_world_size()
        if n > 1 and not local_phase:
            for p in self._params():
                if p.grad is not None:
                    all_reduce(p.grad)
                    p.grad.div_(n)
        self.inner_opt.step()
        if local_phase and n > 1:
            if strategy.adaptive_localsgd:
                cfg = strategy.adaptive_localsgd_configs
                if self._localsgd_lr0 is None:
                    self._localsgd_lr0 = float(self.inner_opt.get_lr())
                lr = max(float(self.inner_opt.get_lr()), 1e-12)
                k = max(1, int(round(cfg.init_k_steps *
                                     (self._localsgd_lr0 / lr) ** 0.5)))
            else:
                k = max(1, strategy.localsgd_configs.k_steps)
            # count steps SINCE THE LAST SYNC (a time-varying adaptive k
            # gated on a global step modulo would fire erratically)
            self._since_sync += 1
            if self._since_sync >= k:
                self._average_parameters()
                self._since_sync = 0

    @torch.no_grad()
    def _average_parameters(self):
        """Fused-bucket all-reduce average of the parameter VALUES (the
        LocalSGD sync point; the reference inserts c_allreduce on the
        parameters, localsgd_optimizer.py)."""
        from ..collective import all_reduce

        params = [p for p in self._params() if p is not None]
        if not params:
            return
        bucket = torch.cat([p.reshape(-1).float() for p in params])
        all_reduce(bucket)
        bucket /= get_world_size()
        off = 0
        for p in params:
            p.copy_(bucket[off:off + p.numel()].view_as(p))
            off += p.numel()

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.inner_opt.clear_grad()
        return [], []


fleet = Fleet()
