"""Request trace ids and the process clock state (mirrors the clock
helpers of ``paddle_tpu/profiler/disttrace.py``).

- ``trace_id(gid)``: the deterministic id ``g<gid>`` of a global request,
  the same string on every rank; the engine stamps a request's id as the
  ``trace`` attribute of each of its events.
- ``walltime()``: this rank's wall clock plus an injected test skew
  (``PADDLE_CLOCK_SKEW``, ``"<rank>:<seconds>[,...]"`` or one float for
  every rank). Each sink flush stamps a ``(wall_s, t_ns)`` anchor read
  from it, so an offline reader can place any event's ``perf_counter``
  stamp on this rank's wall clock.
- ``clock_state()``/``set_clock_state()``: this rank's agreed offset
  against a reference rank (``offset_s``, ``unc_s``, ``ref``,
  ``synced``), stamped into every sink line and flight dump.

The clock agreement itself (``ClockSync``) comes with ROADMAP queue 1
item 8; until then nothing sets the state and every stamp says
``synced: false``. Sign convention: ``offset_s`` of rank K is K's wall
clock minus the reference rank's.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

__all__ = [
    "trace_id", "walltime", "local_skew_s",
    "clock_state", "set_clock_state", "reset_clock_state",
]

#: injected test skew: "<rank>:<seconds>[,<rank>:<seconds>]" or a bare
#: float applied to every rank
SKEW_ENV = "PADDLE_CLOCK_SKEW"


def trace_id(gid: int) -> str:
    """Deterministic trace id of global request ``gid``."""
    return f"g{int(gid):08d}"


def _env_rank() -> int:
    """This process's rank from the ``PADDLE_TRAINER_ID`` environment
    variable (0 when unset or malformed)."""
    try:
        return int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    except ValueError:
        return 0


def local_skew_s(rank: Optional[int] = None) -> float:
    """The injected wall-clock skew of ``rank`` (default: this process)
    from ``PADDLE_CLOCK_SKEW``; 0.0 when unset."""
    raw = os.environ.get(SKEW_ENV)
    if not raw:
        return 0.0
    r = _env_rank() if rank is None else int(rank)
    try:
        if ":" not in raw:
            return float(raw)
        for part in raw.split(","):
            rr, ss = part.split(":")
            if int(rr) == r:
                return float(ss)
        return 0.0
    except ValueError:
        return 0.0


def walltime(skew_s: Optional[float] = None) -> float:
    """This rank's wall clock: ``time.time()`` plus the injected skew.
    Every wall stamp that takes part in cross-host arithmetic comes from
    here, so a skew is the same (and correctable) on all of them."""
    return time.time() + (local_skew_s() if skew_s is None else skew_s)


_lock = threading.Lock()
_state: Dict[str, object] = {
    "offset_s": None,   # this rank's wall clock minus the reference's
    "unc_s": None,      # +- bound on offset_s
    "ref": 0,           # reference rank the offsets are relative to
    "synced": False,    # True once an agreed estimate was adopted
}


def set_clock_state(offset_s: Optional[float], unc_s: Optional[float],
                    ref: int = 0, synced: bool = True) -> None:
    """Adopt this rank's agreed clock offset; the sink stamps it into
    every later flush line."""
    with _lock:
        _state["offset_s"] = None if offset_s is None else float(offset_s)
        _state["unc_s"] = None if unc_s is None else float(unc_s)
        _state["ref"] = int(ref)
        _state["synced"] = bool(synced)


def clock_state() -> dict:
    """A copy of the clock state ``{offset_s, unc_s, ref, synced}``;
    ``offset_s`` None means this rank never synced."""
    with _lock:
        return dict(_state)


def reset_clock_state() -> None:
    set_clock_state(None, None, ref=0, synced=False)
