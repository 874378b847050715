"""Host spans, annotations and the device trace (mirrors
``paddle_tpu/profiler/trace.py``).

- ``scope(name)`` / ``RecordEvent``: a ``perf_counter_ns`` host span,
  nested through a thread-local stack (an inner scope's full name is
  ``"outer/inner"``), that also opens ``torch.profiler.record_function``
  under its full name, the part ``jax.profiler.TraceAnnotation`` plays in
  the reference: a span lands in a ``torch.profiler`` trace beside the
  kernels launched inside it. The reference has a second, "traced" mode
  (inside a ``jit`` trace a scope is ``jax.named_scope`` metadata and
  records no host time). PyTorch runs eagerly and has no trace to annotate,
  so here every scope is a host span.
- ``annotate(name)``: ``record_function`` whether or not profiling is on,
  as the reference's ``annotate`` is always a ``named_scope``.
- ``enable(trace_dir=...)`` also starts a ``torch.profiler.profile`` (CPU
  activity, and CUDA activity when a CUDA device is present);
  ``disable()`` stops it and writes its Chrome trace into ``trace_dir``
  (``trace_file()`` names the file), the counterpart of
  ``jax.profiler.start_trace``/``stop_trace``.

Disabled mode is the fast path: ``scope()`` is a no-op context manager
guarded by one module-global bool: no allocation, no lock, no event.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.profiler import record_function

_enabled = False
_lock = threading.Lock()
_events: List[tuple] = []      # (full_name, start_ns, end_ns, thread_id)
# the Chrome-trace span list keeps the most recent _MAX_EVENTS (older
# ones are dropped and counted); scope_summary stays exact through the
# incremental _agg aggregates
_MAX_EVENTS = 100_000
_dropped = 0
_agg: Dict[str, list] = {}     # name -> [count, total_ns, min_ns, max_ns]
_t_enable_ns: Optional[int] = None
_t_disable_ns: Optional[int] = None
_trace_dir: Optional[str] = None
_prof = None                   # the running torch.profiler.profile
_trace_file: Optional[str] = None
_trace_seq = 0

_live_stacks: Dict[int, List[str]] = {}   # thread id -> open scope names


def _prune_dead_stacks_locked() -> None:
    """Drop the stacks of exited threads (``_lock`` held)."""
    alive = set(sys._current_frames())
    for tid in [t for t in _live_stacks if t not in alive]:
        del _live_stacks[tid]


class _TLS(threading.local):
    def __init__(self):
        self.stack: List[str] = []
        # registered so other threads (a watchdog) can see which scopes
        # are open when a step hangs
        with _lock:
            _prune_dead_stacks_locked()
            _live_stacks[threading.get_ident()] = self.stack


_tls = _TLS()


def live_spans() -> Dict[int, List[str]]:
    """The open host scopes of every thread that has one (empty while
    profiling is off: scopes are no-ops then)."""
    with _lock:
        _prune_dead_stacks_locked()
        return {tid: list(s) for tid, s in _live_stacks.items() if s}


def is_enabled() -> bool:
    return _enabled


def enable(trace_dir: Optional[str] = None, reset: bool = True) -> None:
    """Turn profiling on. ``trace_dir`` also starts a ``torch.profiler``
    trace, written there as a Chrome trace by ``disable()``; host scopes
    ride along as ``record_function`` ranges."""
    global _enabled, _t_enable_ns, _t_disable_ns, _trace_dir, _prof
    if reset:
        reset_events()
    _t_enable_ns = time.perf_counter_ns()
    _t_disable_ns = None
    if trace_dir and _prof is None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        _trace_dir = trace_dir
        _prof = profile(activities=acts)
        _prof.__enter__()
    _enabled = True


def disable() -> Dict[str, dict]:
    """Turn profiling off, stop and write the device trace if one runs;
    returns the per-scope summary (``scope_summary``)."""
    global _enabled, _t_disable_ns, _trace_dir, _prof, _trace_file
    global _trace_seq
    _enabled = False
    _t_disable_ns = time.perf_counter_ns()
    if _prof is not None:
        prof, _prof = _prof, None
        prof.__exit__(None, None, None)
        path = os.path.join(
            _trace_dir, f"torch-trace-{os.getpid()}-{_trace_seq}.json")
        _trace_seq += 1
        prof.export_chrome_trace(path)
        _trace_file = path
        _trace_dir = None
    return scope_summary()


def trace_file() -> Optional[str]:
    """The Chrome trace the last ``disable()`` wrote (None before any)."""
    return _trace_file


def reset_events() -> None:
    global _dropped
    with _lock:
        _events.clear()
        _agg.clear()
        _dropped = 0


def enabled_window_s() -> float:
    """Seconds the profiler has been (or was) enabled: the denominator of
    rate metrics (tokens/sec, steps/sec)."""
    if _t_enable_ns is None:
        return 0.0
    end = _t_disable_ns if _t_disable_ns is not None \
        else time.perf_counter_ns()
    return max(end - _t_enable_ns, 0) / 1e9


class scope:  # noqa: N801 - context manager, lowercase like the reference
    """``with profiler.scope("hybrid/h2d"):``, a host span (module
    docstring). Nesting composes names: ``"hybrid/step/sync_wait"``."""

    __slots__ = ("name", "_t0", "_full", "_rf", "_on")

    def __init__(self, name: str):
        self.name = name
        self._t0 = 0
        self._full = name
        self._rf = None
        self._on = False

    def __enter__(self):
        if not _enabled:
            return self
        self._on = True
        stack = _tls.stack
        self._full = "/".join(stack + [self.name]) if stack else self.name
        stack.append(self.name)
        self._rf = record_function(self._full)
        self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if not self._on:
            return False
        t1 = time.perf_counter_ns()
        self._rf.__exit__(None, None, None)
        self._rf = None
        self._on = False
        if _tls.stack and _tls.stack[-1] == self.name:
            _tls.stack.pop()
        global _dropped
        dt = t1 - self._t0
        with _lock:
            a = _agg.get(self._full)
            if a is None:
                _agg[self._full] = [1, dt, dt, dt]
            else:
                a[0] += 1
                a[1] += dt
                if dt < a[2]:
                    a[2] = dt
                if dt > a[3]:
                    a[3] = dt
            _events.append((self._full, self._t0, t1,
                            threading.get_ident()))
            if len(_events) > _MAX_EVENTS:
                drop = len(_events) - _MAX_EVENTS
                del _events[:drop]
                _dropped += drop
        return False


class RecordEvent(scope):
    """The span under the reference framework's name: explicit
    ``begin()``/``end()`` beside the context-manager protocol."""

    def begin(self):
        return self.__enter__()

    def end(self):
        self.__exit__(None, None, None)


def annotate(name: str):
    """A ``record_function`` range, whether or not profiling is on: the
    name shows in any ``torch.profiler`` trace around the kernels
    launched inside it, and costs a few microseconds otherwise."""
    return record_function(name)


def events() -> List[tuple]:
    with _lock:
        return list(_events)


def scope_summary() -> Dict[str, dict]:
    """Per-scope host-span statistics: ``{full_name: {count, total_ms,
    mean_ms, min_ms, max_ms}}``, exact even after old spans age out of
    the bounded span list."""
    with _lock:
        items = [(name, list(a)) for name, a in _agg.items()]
    out = {}
    for name, (n, tot, mn, mx) in items:
        out[name] = {"count": n, "total_ms": round(tot / 1e6, 4),
                     "mean_ms": round(tot / n / 1e6, 4),
                     "min_ms": round(mn / 1e6, 4),
                     "max_ms": round(mx / 1e6, 4)}
    return out


def chrome_trace(extra_metadata: Optional[dict] = None) -> dict:
    """The host spans as a chrome://tracing / Perfetto object
    (``{"traceEvents": [...]}``); ``extra_metadata`` and the count of
    dropped spans ride in ``otherData``."""
    evs = events()
    trace_events = [
        {"name": n, "ph": "X", "ts": t0 / 1e3, "dur": (t1 - t0) / 1e3,
         "pid": 0, "tid": tid, "cat": "host"}
        for n, t0, t1, tid in evs]
    doc = {"traceEvents": trace_events, "displayTimeUnit": "ms"}
    meta = dict(extra_metadata or {})
    if _dropped:
        meta["dropped_events"] = _dropped
    doc["otherData"] = meta
    return doc


def export_chrome_trace(path: str,
                        extra_metadata: Optional[dict] = None) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(extra_metadata), f)
    return path
