"""Per-request event timelines and the flight recorder (mirrors
``paddle_tpu/profiler/events.py``).

The metrics registry answers "how much, how fast overall"; this module
answers "what happened to request 17, and when". It is a bounded log of
typed records stamped with ``perf_counter_ns`` (the clock of
``trace.py``'s spans), which the serving engine feeds at every request
lifecycle edge (submit, admit, prefix hit, copy-on-write, chunk dispatch,
first token, preempt, requeue, cancel, finish; and in spec mode draft,
verify and accept). From the log it derives:

- per-request timelines (``timeline(rid)``) and a latency breakdown
  (``latency_breakdown``): queue wait, prefill, decode and preempted
  time, reconstructed by a state machine over the edges;
- rolling-window TTFT/TPOT percentiles (``request_latency_stats``) from
  the ``ttft_ms``/``tpot_ms`` attributes the engine stamps on ``finish``
  events;
- the flight recorder (``FlightRecorder``, ``dump_flight``): the tail of
  the ring, the metrics snapshot, the metric deltas since the last
  ``mark()`` and the open spans, written as one JSON document.

The log is on by default (``set_enabled``): a request emits O(1) events a
residency period (``accept``: one a verify tick), never one a token. The
ring keeps the newest ``capacity`` events and counts the ones it drops;
sequence numbers never rewind (``clear()`` empties the ring only), so a
sink's cursor survives a reset. ``dump_flight`` never raises.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

__all__ = [
    "Event", "EventLog", "log", "emit", "set_enabled", "is_enabled",
    "timeline", "latency_breakdown", "breakdown_from_events",
    "latency_table", "request_latency_stats",
    "FlightRecorder", "flight_recorder", "dump_flight",
]

#: the well-known kinds (informational: ``emit()`` takes any string).
#: The serving engine's lifecycle edges: ``submit``, ``admit``,
#: ``prefix_hit``, ``cow_copy``, ``chunk`` (``start``/``end``/``final``),
#: ``first_token``, ``preempt``, ``requeue``, ``cancel`` and ``finish``
#: (``tokens``/``reason``/``preempts``/``ttft_ms``/``tpot_ms``). A spec
#: engine adds ``draft`` (the slot's draft cache began catching up, once
#: an admission cycle), ``verify`` (the first verify tick carrying the
#: request's drafts, once a cycle) and ``accept`` (every speculating
#: verify tick, ``accepted``/``drafted``): at most one a verify tick.
#: The other kinds are the reference's too: the handoff and the mesh's
#: control plane (``serving/disagg.py``, ``distributed/consensus.py``),
#: ``rollback`` (the resilient runner: ``bad_cursors``, or ``mesh_abort``
#: with ``participants``/``missing``), ``alert`` (``profiler/live.py``:
#: ``rule``, ``state``, ``value``, ``threshold``, and ``rank`` for a
#: per-rank rule) and the watchdog's ``watchdog_fire`` (``step``,
#: ``elapsed_s``); a log read by both packages names the same kinds. A
#: request submitted with a trace id stamps it as ``trace`` on each of
#: its events.
EVENT_KINDS = (
    "submit", "admit", "prefix_hit", "cow_copy", "chunk",
    "first_token", "draft", "verify", "accept",
    "handoff_out", "handoff_in",
    "route", "clock_sync", "consensus_decision", "lease_expiry",
    "vote_window_expiry",
    "member_join", "member_leave", "redispatch", "cancel",
    "preempt", "requeue", "finish", "rollback", "alert",
)


class Event:
    """One structured record: process-monotonic ``t_ns``
    (perf_counter_ns — the same clock as trace.py spans), a ``kind``
    string, an optional request id, and free-form attrs."""

    __slots__ = ("seq", "t_ns", "kind", "rid", "attrs")

    def __init__(self, seq: int, t_ns: int, kind: str,
                 rid: Optional[int], attrs: dict):
        self.seq = seq
        self.t_ns = t_ns
        self.kind = kind
        self.rid = rid
        self.attrs = attrs

    def to_dict(self) -> dict:
        d = {"seq": self.seq, "t_ns": self.t_ns, "kind": self.kind}
        if self.rid is not None:
            d["rid"] = self.rid
        d.update(self.attrs)
        return d

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Event({self.to_dict()!r})"


class EventLog:
    """Bounded, thread-safe, seq-numbered ring of Events."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._buf: deque = deque()
        self._lock = threading.Lock()
        self._next_seq = 0
        self._dropped = 0

    def emit(self, kind: str, rid: Optional[int] = None,
             **attrs) -> Optional[Event]:
        if not _enabled:
            return None
        t = time.perf_counter_ns()
        with self._lock:
            ev = Event(self._next_seq, t, kind, rid, attrs)
            self._next_seq += 1
            self._buf.append(ev)
            if len(self._buf) > self.capacity:
                self._buf.popleft()
                self._dropped += 1
        return ev

    @property
    def next_seq(self) -> int:
        return self._next_seq

    @property
    def total(self) -> int:
        """Events ever emitted (including ones aged out of the ring)."""
        return self._next_seq

    @property
    def dropped(self) -> int:
        return self._dropped

    def events(self, rid: Optional[int] = None,
               kind: Optional[str] = None,
               since_seq: int = 0) -> List[Event]:
        with self._lock:
            evs = list(self._buf)
        return [e for e in evs
                if e.seq >= since_seq
                and (rid is None or e.rid == rid)
                and (kind is None or e.kind == kind)]

    def since(self, seq: int) -> Tuple[List[Event], int]:
        """(events with seq >= seq, next cursor) — the sink's segment
        read. The cursor advances past everything returned, so repeated
        calls stream the log exactly once."""
        with self._lock:
            evs = [e for e in self._buf if e.seq >= seq]
            return evs, self._next_seq

    def tail(self, n: int) -> List[Event]:
        with self._lock:
            if n <= 0:
                return []
            return list(self._buf)[-n:]

    def clear(self) -> None:
        """Empty the buffer. Sequence numbers are NOT rewound (sink
        cursors stay valid); the dropped counter is reset."""
        with self._lock:
            self._buf.clear()
            self._dropped = 0


_enabled = True
_log = EventLog()


def log() -> EventLog:
    return _log


def emit(kind: str, rid: Optional[int] = None, **attrs) -> Optional[Event]:
    """Emit into the process-global log (the one instrumented code
    feeds and the sink drains)."""
    return _log.emit(kind, rid=rid, **attrs)


def set_enabled(on: bool) -> None:
    """Event recording on/off (default ON — lifecycle edges are cheap).
    Turned off, the engine's emits cost one bool read each."""
    global _enabled
    _enabled = bool(on)


def is_enabled() -> bool:
    return _enabled


# ---------------------------------------------------------------------------
# timeline queries
# ---------------------------------------------------------------------------
def timeline(rid: int, event_log: Optional[EventLog] = None) -> List[Event]:
    """All of ``rid``'s events in emission order. NOTE: rids are unique
    within one engine; when several engines share the process, filter
    by the ``eng`` attr (each engine stamps its own id) or use
    ``latency_table`` which groups by (eng, rid)."""
    return (event_log or _log).events(rid=rid)


#: state -> breakdown bucket the elapsed time is charged to
_STATE_BUCKET = {"queued": "queue_wait_ms", "requeued": "preempted_ms",
                 "prefill": "prefill_ms", "decode": "decode_ms",
                 "re_prefill": "preempted_ms"}


def breakdown_from_events(evs: List[Event]) -> Optional[dict]:
    """Latency breakdown of ONE request's event sequence: wall time
    split into queue wait (submit -> first admission), prefill
    (admission -> first token), decode (first token -> finish) and
    preempted time (each preempt -> the END of the re-prefill it
    forced: requeue wait, re-admission, and the re-prefill chunks —
    tracked via the ``final`` attr the engine stamps on ``chunk``
    events — are all preemption cost, not decode), plus the finish
    event's ttft/tpot/tokens attrs. Speculative-decoding events ride
    the decode bucket: ``draft``/``verify``/``accept`` never move the
    state machine (time keeps accruing to the current state, so the
    four buckets still sum to the total); ``accept`` events are instead
    FOLDED into ``spec_accepted``/``spec_drafted`` counts on the
    result (present only when the request speculated). Partial
    sequences (events aged out of the ring, request still running)
    yield a breakdown of what is known, flagged
    ``"complete": False``."""
    if not evs:
        return None
    out = {k: 0.0 for k in
           ("queue_wait_ms", "prefill_ms", "decode_ms", "preempted_ms")}
    state = None
    t_last = evs[0].t_ns
    t_submit = None
    t_first_tok = None
    seen_first = False
    preempts = 0
    spec_accepted = 0
    spec_drafted = 0
    finish: Optional[Event] = None

    def charge(t_ns: int) -> None:
        nonlocal t_last
        bucket = _STATE_BUCKET.get(state)
        if bucket is not None:
            out[bucket] += (t_ns - t_last) / 1e6
        t_last = t_ns

    for ev in evs:
        k = ev.kind
        if k == "submit":
            state = "queued"
            t_last = ev.t_ns
            t_submit = ev.t_ns
        elif k == "admit":
            charge(ev.t_ns)
            # a re-admission after preemption re-prefills the generated
            # prefix before decode resumes — still preemption cost
            state = "re_prefill" if seen_first else "prefill"
        elif k == "chunk":
            if state == "re_prefill":
                charge(ev.t_ns)
                if ev.attrs.get("final"):
                    state = "decode"
        elif k == "first_token":
            charge(ev.t_ns)
            state = "decode"
            seen_first = True
            if t_first_tok is None:
                t_first_tok = ev.t_ns
        elif k == "accept":
            spec_accepted += int(ev.attrs.get("accepted") or 0)
            spec_drafted += int(ev.attrs.get("drafted") or 0)
        elif k == "preempt":
            charge(ev.t_ns)
            state = "requeued"
            preempts += 1
        elif k == "finish":
            charge(ev.t_ns)
            state = None
            finish = ev
    rid = evs[0].rid
    # complete means the WHOLE lifecycle was observed: a head-truncated
    # sequence (submit aged out of the ring, finish still in it) is
    # missing entire buckets and must not be trusted as a full breakdown
    result = {"rid": rid, **{k: round(v, 3) for k, v in out.items()},
              "preempts": preempts,
              "complete": finish is not None and t_submit is not None}
    if spec_drafted:
        result["spec_accepted"] = spec_accepted
        result["spec_drafted"] = spec_drafted
    if t_submit is not None and t_first_tok is not None:
        result["ttft_ms"] = round((t_first_tok - t_submit) / 1e6, 3)
    if t_submit is not None and finish is not None:
        result["total_ms"] = round((finish.t_ns - t_submit) / 1e6, 3)
    if finish is not None:
        for key in ("tokens", "tpot_ms", "reason"):
            if key in finish.attrs and finish.attrs[key] is not None:
                result[key] = finish.attrs[key]
        # engine-stamped TTFT backfills a ring whose first_token event
        # already aged out (computed-from-events wins when both exist)
        if "ttft_ms" not in result and \
                finish.attrs.get("ttft_ms") is not None:
            result["ttft_ms"] = finish.attrs["ttft_ms"]
    return result


def latency_breakdown(rid: int,
                      event_log: Optional[EventLog] = None
                      ) -> Optional[dict]:
    return breakdown_from_events(timeline(rid, event_log))


def latency_table(since_seq: int = 0,
                  event_log: Optional[EventLog] = None) -> List[dict]:
    """One breakdown row per request observed since ``since_seq``,
    grouped by (engine id, rid) so co-resident engines don't alias.
    Sorted by rid."""
    lg = event_log or _log
    groups: Dict[tuple, List[Event]] = {}
    for ev in lg.events(since_seq=since_seq):
        if ev.rid is None:
            continue
        groups.setdefault((ev.attrs.get("eng"), ev.rid), []).append(ev)
    ordered = sorted(groups.items(),
                     key=lambda kv: (kv[0][1], str(kv[0][0])))
    rows = []
    for (eng_id, _rid), evs in ordered:
        r = breakdown_from_events(evs)
        if r is not None:
            # co-resident engines reuse rids — the row must say WHICH
            # engine it belongs to, or the advertised (eng, rid) split
            # is impossible for consumers
            r["eng"] = eng_id
            rows.append(r)
    return rows


def _percentiles(vals: List[float]) -> dict:
    from .metrics import percentile as _pctl

    if not vals:
        return {}
    s = sorted(vals)
    n = len(s)

    def pick(q):
        return round(_pctl(s, q), 3)

    return {"p50": pick(50), "p90": pick(90), "p95": pick(95),
            "p99": pick(99), "mean": round(sum(s) / n, 3), "count": n}


def request_latency_stats(window_s: Optional[float] = None,
                          event_log: Optional[EventLog] = None,
                          now_ns: Optional[int] = None,
                          since_seq: int = 0) -> dict:
    """Rolling-window TTFT/TPOT percentiles over finished requests:
    p50/p90/p95/p99 (+mean/count) of the ``ttft_ms``/``tpot_ms`` attrs
    the engine stamps on ``finish`` events. ``window_s=None`` covers
    everything still in the ring."""
    lg = event_log or _log
    fins = lg.events(kind="finish", since_seq=since_seq)
    if window_s is not None:
        now = now_ns if now_ns is not None else time.perf_counter_ns()
        cutoff = now - int(window_s * 1e9)
        fins = [e for e in fins if e.t_ns >= cutoff]
    ttfts = [e.attrs["ttft_ms"] for e in fins
             if e.attrs.get("ttft_ms") is not None]
    tpots = [e.attrs["tpot_ms"] for e in fins
             if e.attrs.get("tpot_ms") is not None]
    return {"window_s": window_s, "requests": len(fins),
            "ttft_ms": _percentiles(ttfts), "tpot_ms": _percentiles(tpots)}


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------
class FlightRecorder:
    """Post-mortem capture: the last ``tail_events`` events, the full
    metrics snapshot, numeric metric DELTAS since the last ``mark()``
    (what moved in the window before the incident — a stuck counter is
    as diagnostic as a spiking one), and the profiler's open spans.
    ``dump()`` returns the document and best-effort writes it as JSON;
    it never raises — a failed file write is flagged with a
    ``"write_error"`` key in the returned document instead."""

    def __init__(self, tail_events: int = 2048):
        self.tail_events = int(tail_events)
        self._lock = threading.Lock()
        self._baseline: Dict[str, float] = {}
        self._baseline_t_ns: Optional[int] = None

    @staticmethod
    def _numeric_view(snapshot: dict) -> Dict[str, float]:
        out = {}
        for name, s in snapshot.items():
            if s.get("type") == "histogram":
                out[name] = float(s.get("count", 0))
            elif s.get("value") is not None:
                out[name] = float(s["value"])
        return out

    def mark(self) -> None:
        """Set the delta baseline (call at steady-state points — the
        sink's flush loop does, so deltas read 'since last flush')."""
        from .metrics import registry

        with self._lock:
            self._baseline = self._numeric_view(registry().snapshot())
            self._baseline_t_ns = time.perf_counter_ns()

    def dump(self, path: Optional[str] = None,
             reason: str = "") -> dict:
        from . import trace as _trace
        from .metrics import registry

        try:
            snap = registry().snapshot()
            cur = self._numeric_view(snap)
            with self._lock:
                base = dict(self._baseline)
                base_t = self._baseline_t_ns
            deltas = {k: round(v - base.get(k, 0.0), 6)
                      for k, v in cur.items()
                      if v != base.get(k, 0.0)}
            # the writer's rank and clock state order dumps of several
            # ranks
            from . import disttrace as _disttrace
            from .sink import _detect_rank

            # the last consensus epoch adopted per family orders dumps
            # of several ranks by their agreement history
            from ..distributed.consensus import adopted_epochs

            epochs = adopted_epochs()
            doc = {
                "kind": "flight_recorder_dump",
                "reason": reason,
                "unix_time": time.time(),
                "t_ns": time.perf_counter_ns(),
                "baseline_t_ns": base_t,
                "rank": _detect_rank(),
                "clock": _disttrace.clock_state(),
                "consensus_epochs": epochs,
                "events": [e.to_dict() for e in _log.tail(self.tail_events)],
                "events_dropped": _log.dropped,
                "metrics": snap,
                "metric_deltas_since_mark": deltas,
                "open_spans": {str(t): s
                               for t, s in _trace.live_spans().items()},
                "scope_summary": _trace.scope_summary(),
            }
            # the newest parsed device-trace window (device_trace.py),
            # None before any capture completed
            from . import device_trace as _dtrace

            doc["trace_summary"] = _dtrace.last_summary()
        except Exception as e:  # pragma: no cover - post-mortem shield
            doc = {"kind": "flight_recorder_dump", "reason": reason,
                   "error": f"{type(e).__name__}: {e}"}
        if path:
            try:
                with open(path, "w") as f:
                    json.dump(doc, f)
            except OSError as e:
                # a dump must never take the job down, but callers must
                # not advertise a file that does not exist (dump_flight
                # turns this into its documented None)
                doc["write_error"] = f"{type(e).__name__}: {e}"
        return doc


_flight = FlightRecorder()


def flight_recorder() -> FlightRecorder:
    return _flight


def dump_flight(reason: str, path: Optional[str] = None) -> Optional[str]:
    """Write a flight-recorder dump and return its path. ``path=None``
    falls back to the active sink's directory
    (``flight-<seq>-<sanitized reason>.json``); with neither, nothing
    is written and None returns. A failed file write also returns None
    (the document was lost — don't point post-mortem tooling at a path
    that does not exist). Never raises — this runs inside watchdog
    fires and rollback paths."""
    try:
        if path is None:
            from . import sink as _sink

            s = _sink.active_sink()
            if s is None:
                return None
            tag = "".join(c if c.isalnum() else "-" for c in reason)[:48]
            path = f"{s.directory}/flight-{_log.next_seq}-{tag}.json"
        doc = _flight.dump(path, reason=reason)
        return None if "write_error" in doc else path
    except Exception:  # pragma: no cover - post-mortem shield
        return None
