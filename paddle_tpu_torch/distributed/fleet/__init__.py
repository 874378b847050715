"""``paddle.distributed.fleet`` (mirrors
``paddle_tpu/distributed/fleet/__init__.py``). This slice has the
strategy config only; the fleet runtime, role makers and metrics come
with the distributed slice (ROADMAP queue 1 item 7)."""
from .distributed_strategy import DistributedStrategy

__all__ = ["DistributedStrategy"]
