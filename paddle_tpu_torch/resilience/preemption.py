"""Graceful-preemption signal handling (mirrors
``paddle_tpu/resilience/preemption.py``).

A scheduler preempts a worker with a SIGTERM and a grace window. Here
preemption is a normal, resumable event: the handler only RECORDS the
request; the training loop (``resilience/runner.py``) finishes the step
in flight, forces a synchronous committed checkpoint and exits with a
resumable status, and the restarted process continues the same loss
curve.

The handler flips a flag and remembers the signal number: no I/O, no
locks, no collectives in the signal frame (a checkpoint collective
started from a signal frame could interleave with the training step's
collectives and deadlock the process group).

With the async step window (``ResilienceConfig(async_dispatch=True)``)
the loop may hold dispatched steps whose losses it has not read when it
sees the flag. The preemption flush first drains that window, running
the bad-step accounting for each step in it (a preemption must not skip
a rollback the synchronous loop would have taken), then takes the
synchronous committed save, whose ``manager.wait()`` joins a streamed
snapshot in flight. So the committed state is exactly the state after
the last drained clean step.
"""
from __future__ import annotations

import signal
import threading
from typing import Iterable, Optional

__all__ = ["PreemptionHandler", "PreemptedError", "PREEMPT_EXIT_CODE"]

#: EX_TEMPFAIL, "transient failure, retry me": a supervisor (a
#: restartPolicy, the elastic launcher) tells it from a crash and
#: reschedules instead of alerting
PREEMPT_EXIT_CODE = 75


class PreemptedError(RuntimeError):
    """Raised by the resilient runner after the preemption checkpoint
    is committed, with ``ResilienceConfig(raise_on_preempt=True)``; the
    default returns ``RunResult(preempted=True)`` instead. Carries what
    a supervisor needs to resume."""

    def __init__(self, step: int, signum: int, ckpt_dir: Optional[str]):
        super().__init__(
            f"preempted by signal {signum} at step {step}; committed "
            f"checkpoint in {ckpt_dir!r}: exit {PREEMPT_EXIT_CODE} and "
            f"restart to resume")
        self.step = step
        self.signum = signum
        self.ckpt_dir = ckpt_dir
        self.exit_code = PREEMPT_EXIT_CODE


class PreemptionHandler:
    """Install SIGTERM/SIGINT handlers that set a flag; the training
    loop polls ``requested`` at step boundaries.

    As a context manager it restores the previous handlers on exit. Only
    the main thread may install signal handlers (a CPython rule); from
    another thread ``install`` does nothing, so library code can use the
    handler unconditionally. ``request()`` takes the same path from code
    (the chaos harness, a cluster-notice poller).
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,
                                                 signal.SIGINT)):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self.signum: Optional[int] = None
        self._prev: dict = {}
        self._installed = False

    # -- flag --------------------------------------------------------------
    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def request(self, signum: int = signal.SIGTERM) -> None:
        self.signum = signum
        self._event.set()

    def clear(self) -> None:
        self._event.clear()
        self.signum = None

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    # -- installation ------------------------------------------------------
    def _on_signal(self, signum, frame) -> None:
        self.request(signum)

    def install(self) -> "PreemptionHandler":
        if self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            return self
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._on_signal)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False
