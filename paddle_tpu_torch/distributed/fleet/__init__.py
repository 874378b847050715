"""``paddle.distributed.fleet`` (mirrors
``paddle_tpu/distributed/fleet/__init__.py:1-23``): the strategy config,
the fleet facade and its module-level aliases, the role makers and the
distributed metrics."""
from . import metrics
from .distributed_strategy import DistributedStrategy
from .fleet_base import DistributedOptimizer, Fleet, _RoleMaker, fleet

init = fleet.init
distributed_optimizer = fleet.distributed_optimizer
distributed_model = fleet.distributed_model
worker_index = fleet.worker_index
worker_num = fleet.worker_num
is_first_worker = fleet.is_first_worker
worker_endpoints = fleet.worker_endpoints
barrier_worker = fleet.barrier_worker


class UserDefinedRoleMaker(_RoleMaker):
    def __init__(self, *args, **kwargs):
        super().__init__(kwargs.get("is_collective", True))


class PaddleCloudRoleMaker(_RoleMaker):
    def __init__(self, is_collective=False, **kwargs):
        super().__init__(is_collective)


__all__ = ["DistributedStrategy", "DistributedOptimizer", "Fleet", "fleet",
           "metrics", "init", "distributed_optimizer", "distributed_model",
           "worker_index", "worker_num", "is_first_worker",
           "worker_endpoints", "barrier_worker", "UserDefinedRoleMaker",
           "PaddleCloudRoleMaker"]
