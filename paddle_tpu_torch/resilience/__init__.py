"""paddle_tpu_torch.resilience: the fault-tolerant training runtime
(mirrors ``paddle_tpu/resilience``).

Preemptions, poisoned batches, hung steps, flaky data sources and
corrupted checkpoints are survivable events, each tested on a fixed
schedule.

Pieces (each importable alone):

  - ``ResilientRunner`` / ``ResilienceConfig`` (``runner.py``): the
    hardened loop: the bad-step guard with the K-streak rollback that
    re-seeds the data cursor, the preemption checkpoint, the watchdog,
    the degraded restore, retried data loading, the async step window,
    and with a ``Consensus`` the mesh-agreed rollback or abort.
  - ``StepWatchdog`` (``watchdog.py``): the hung-step monitor; dumps the
    live thread stacks and the profiler's span state, optionally aborts
    with ``WATCHDOG_EXIT_CODE`` (74).
  - ``PreemptionHandler`` / ``PreemptedError`` (``preemption.py``):
    SIGTERM/SIGINT -> flag -> the step finishes -> a committed
    checkpoint -> the resumable exit status ``PREEMPT_EXIT_CODE`` (75).
  - ``chaos`` (``chaos.py``): the deterministic fault injection the
    tests drive (NaN gradients, truncated, corrupt or uncommitted
    shards, data-loader exceptions, hangs, self-preemption).

The guard itself is ``HybridPipelineTrainer(..., guard_bad_steps=True)``
(``distributed/hybrid.py``). Recoveries are profiler counters:
``resilience/steps_skipped``, ``resilience/rollbacks``,
``resilience/restore_fallbacks``, ``resilience/preemptions``,
``resilience/data_retries``, ``resilience/watchdog_fires``.

Quick use::

    tr = HybridPipelineTrainer(model, opt, strategy, mesh,
                               guard_bad_steps=True)
    runner = ResilientRunner(tr, ckpt_dir, save_interval=100,
                             config=ResilienceConfig(
                                 bad_step_limit=3,
                                 watchdog_timeout_s=600))
    result = runner.run(data_fn, total_steps)   # data_fn(cursor)
    if result.preempted:
        sys.exit(result.exit_code)              # the supervisor restarts
"""
from __future__ import annotations

from . import chaos  # noqa: F401
from .preemption import (PREEMPT_EXIT_CODE, PreemptedError,  # noqa: F401
                         PreemptionHandler)
from .runner import ResilienceConfig, ResilientRunner, RunResult  # noqa: F401
from .watchdog import WATCHDOG_EXIT_CODE, StepWatchdog  # noqa: F401

__all__ = [
    "ResilienceConfig", "ResilientRunner", "RunResult",
    "PreemptionHandler", "PreemptedError", "PREEMPT_EXIT_CODE",
    "StepWatchdog", "WATCHDOG_EXIT_CODE",
    "chaos",
]
