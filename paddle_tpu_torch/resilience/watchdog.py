"""Step watchdog: a monitor thread that fires on a hung training step
(mirrors ``paddle_tpu/resilience/watchdog.py``).

A hung step (a wedged collective, a kernel that never ends, a dead data
source) looks from the outside like a slow one: nothing raises, the job
stops. When no ``pet()`` arrives within the timeout the watchdog dumps
every thread's Python stack with the profiler's open spans and
per-scope summary (the spans say which phase hung), writes a
flight-recorder JSON (``profiler.events.dump_flight``), flushes the
active metrics sink with reason ``"watchdog"``, adds one to
``resilience/watchdog_fires`` and, with ``abort``, ends the process so
that the elastic restart takes over.

Nothing on the fire path touches the card: no ``.item()``, no
``synchronize``, no read of device memory. A hung kernel holds the
stream, and a call that waited on it would hang the watchdog too; the
dump reads host state only (Python frames, the span stacks, the
registry), and a host thread blocked in a CUDA sync has released the
GIL.

The deadline is jittered (a multiplier in ``[1, 1 + jitter_frac]``, from
a seeded RNG): a stall of the whole job must not make every process
dump and abort in the same instant. ``jitter_frac=0`` gives the exact
deadline tests need.
"""
from __future__ import annotations

import os
import random
import sys
import threading
import time
import traceback
from typing import Callable, Optional

__all__ = ["StepWatchdog", "WATCHDOG_EXIT_CODE", "dump_stacks"]

#: apart from the preemption code: a supervisor tells "hung and
#: aborted" from "preempted, resumable"
WATCHDOG_EXIT_CODE = 74


def dump_stacks(out=None) -> str:
    """Every thread's Python stack and the profiler's open spans and
    scope summary, as one string (also written to ``out``, default
    stderr)."""
    from ..profiler import trace as _ptrace

    lines = ["=== resilience.watchdog: hung-step dump ==="]
    live = _ptrace.live_spans()
    if live:
        lines.append("open profiler spans (thread -> scope stack):")
        for tid, stack in sorted(live.items()):
            lines.append(f"  thread {tid}: {' > '.join(stack)}")
    summ = _ptrace.scope_summary()
    if summ:
        lines.append("profiler scope summary:")
        for name, s in sorted(summ.items()):
            lines.append(
                f"  {name}: n={s['count']} mean={s['mean_ms']}ms "
                f"max={s['max_ms']}ms")
    names = {t.ident: t.name for t in threading.enumerate()}
    for tid, frame in sys._current_frames().items():
        lines.append(f"--- thread {tid} ({names.get(tid, '?')}) ---")
        lines.append("".join(traceback.format_stack(frame)).rstrip())
    text = "\n".join(lines) + "\n"
    f = out if out is not None else sys.stderr
    try:
        f.write(text)
        f.flush()
    except (OSError, ValueError):
        pass                      # a dump must never take the job down
    return text


class StepWatchdog:
    """``start()`` the monitor, ``pet(step)`` after every completed
    step, ``stop()`` when the loop ends (as a context manager it does
    both).

    timeout_s:    most wall time between pets before the watchdog fires.
    jitter_frac:  deadline multiplier drawn from [1, 1 + jitter_frac]
                  at each pet (seeded: deterministic).
    on_fire:      callable(step, elapsed_s, dump_text) told of a fire.
    abort:        after the dump, end the process with
                  WATCHDOG_EXIT_CODE (``os._exit``: a hung runtime cannot
                  be trusted to run atexit handlers).
    dump_file:    optional path the dump is appended to besides stderr;
                  the flight recorder's JSON goes beside it.
    """

    def __init__(self, timeout_s: float, jitter_frac: float = 0.1,
                 abort: bool = False,
                 on_fire: Optional[Callable] = None,
                 dump_file: Optional[str] = None,
                 poll_s: Optional[float] = None,
                 seed: int = 0):
        if timeout_s <= 0:
            raise ValueError("watchdog timeout_s must be > 0")
        self.timeout_s = float(timeout_s)
        self.jitter_frac = max(0.0, float(jitter_frac))
        self.abort = bool(abort)
        self.on_fire = on_fire
        self.dump_file = dump_file
        self.poll_s = poll_s if poll_s is not None \
            else min(0.25, self.timeout_s / 4)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._deadline = 0.0
        self._last_pet_t = 0.0
        self._gen = 0               # pet generation: one fire a generation
        self._step = -1
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired = False
        #: where the last fire's flight-recorder JSON landed (None when
        #: neither dump_file nor an active sink gave it a place, the write
        #: failed, or it timed out on hung I/O)
        self.flight_path: Optional[str] = None

    def _new_deadline(self) -> float:
        mult = 1.0 + self._rng.uniform(0.0, self.jitter_frac) \
            if self.jitter_frac else 1.0
        return time.monotonic() + self.timeout_s * mult

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "StepWatchdog":
        if self._thread is not None:
            return self
        self._stop.clear()
        with self._lock:
            self._deadline = self._new_deadline()
            self._last_pet_t = time.monotonic()
        self._thread = threading.Thread(
            target=self._monitor, name="resilience-watchdog", daemon=True)
        self._thread.start()
        return self

    def pet(self, step: int = -1, grace_s: float = 0.0) -> None:
        """The step heartbeat: call after every completed step.
        ``grace_s`` extends THIS deadline only: the runner grants it to a
        lifetime's first step, whose kernel builds and cold caches dwarf
        the steady-state timeout."""
        with self._lock:
            self._step = step
            self._deadline = self._new_deadline() + max(0.0, grace_s)
            self._last_pet_t = time.monotonic()
            self._gen += 1

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
        self._thread = None

    def __enter__(self) -> "StepWatchdog":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- monitor -----------------------------------------------------------
    def _monitor(self) -> None:
        fired_gen = None
        while not self._stop.wait(self.poll_s):
            with self._lock:
                overdue = time.monotonic() > self._deadline
                step = self._step
                gen = self._gen
            if overdue and gen != fired_gen:
                # one fire a pet generation: a continuing hang is not
                # dumped again every poll, but the monitor lives on and
                # the next pet arms it for a later hang
                fired_gen = gen
                self._fire(step)

    def _fire(self, step: int) -> None:
        from ..profiler import events as _pevents
        from ..profiler import sink as _psink
        from ..profiler.metrics import registry as _registry

        self.fired = True
        _registry().counter("resilience/watchdog_fires").add(1)
        elapsed = time.monotonic() - self._last_pet_t
        text = dump_stacks()
        _pevents.emit("watchdog_fire", step=step,
                      elapsed_s=round(elapsed, 3))

        # what persists: the stack dump, the flight recorder's JSON
        # (beside the dump or in the active sink's directory) and a sink
        # flush, so that metrics.jsonl ends on a "watchdog" line. With
        # abort, os._exit below skips atexit, so this is the last chance;
        # the hang may BE a hung filesystem, so the file I/O runs on a
        # daemon thread with a bound: past it the abort goes on without
        # the artifact
        holder = {}

        def _persist() -> None:
            if self.dump_file:
                try:
                    with open(self.dump_file, "a") as f:
                        f.write(text)
                except OSError:
                    pass
            holder["flight"] = _pevents.dump_flight(
                "watchdog", path=(self.dump_file + ".flight.json")
                if self.dump_file else None)
            # bounded too: the sink's writer may hold the flush lock in
            # hung I/O
            _psink.flush_active("watchdog", timeout=5.0)

        pt = threading.Thread(target=_persist, name="watchdog-persist",
                              daemon=True)
        pt.start()
        pt.join(timeout=10.0)
        self.flight_path = holder.get("flight")
        if self.on_fire is not None:
            try:
                self.on_fire(step, elapsed, text)
            except Exception:
                traceback.print_exc()
        if self.abort:
            # the hung step may be in the CUDA runtime: os._exit is the
            # one exit that cannot itself hang; the elastic restart
            # resumes from the last committed checkpoint
            os._exit(WATCHDOG_EXIT_CODE)
