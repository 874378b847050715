"""Persistent metrics sink: the registry and the event log on disk
(mirrors ``paddle_tpu/profiler/sink.py``).

A background writer flushes, every ``interval_s`` and at every exit edge:

- ``metrics.jsonl``: one JSON line a flush (timestamp, reason, rank,
  ``flush_seq``, the clock anchor, ``events_lost`` and the registry
  snapshot), append-only: a torn last line loses one flush, never the
  file;
- ``events.jsonl``: the event log streamed once through a sequence
  cursor, one JSON object an event. The cursor advances only after a
  successful append, so an I/O error re-sends the whole segment on the
  next flush (at least once; ``tools/check_sink_schema.py`` flags the
  damaged file). Events that aged out of the ring between flushes leave
  seq gaps here and are counted in the flush's ``events_lost``;
- ``metrics.prom``: the latest snapshot in the Prometheus textfile
  format, rewritten atomically (tmp + rename);
- ``frames/rank<K>-<seq>.json``: a telemetry frame a flush (cumulative
  counters with their deltas, gauges, the histograms' sketches), written
  atomically, the newest ``frame_keep`` kept.

Flush reasons: ``interval`` (the thread), ``exit`` (``close()``;
``enable_sink`` registers an atexit close), ``replaced``/``disabled``
(``enable_sink``/``disable_sink``), ``reset`` (``profiler.enable`` and
``profiler.reset`` drain the ring before emptying it) and whatever a
caller passes to ``flush``. Every flush also marks the flight recorder,
so a later dump's deltas read "since the last flush".

One sink is active a process. A new sink moves an earlier session's
``metrics.jsonl``/``events.jsonl`` aside (first free ``.N`` suffix), so
every file keeps strictly increasing sequence numbers. Every line carries
the writer's rank (``torch.distributed``'s when it is initialized, else
0), and with more than one process ``enable_sink`` writes into a
``rank<K>/`` subdirectory, so no two processes append to one file. The
writer thread touches no tensor: pure host I/O. Every line and frame
carries the rank's clock anchor and its agreed clock offset
(``disttrace.clock_state``, adopted by a serving mesh's ``clock``
round), and every frame the consensus epochs this rank adopted, so
``tools/merge_traces.py`` aligns the ranks' sinks from them alone.
"""
from __future__ import annotations

import atexit
import json
import os
import re
import threading
import time
from typing import Dict, Optional

from . import disttrace as _disttrace
from . import events as _events
from .metrics import registry

__all__ = ["MetricsSink", "enable_sink", "disable_sink", "active_sink",
           "flush_active", "prometheus_text", "stats"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(prefix: str, name: str) -> str:
    return _NAME_RE.sub("_", f"{prefix}_{name}")


def _rotate(path: str) -> None:
    """Move a non-empty artifact from an earlier sink session aside —
    appending this session's seq-0 lines after it would break the
    per-file strictly-increasing flush_seq/seq contract the schema
    validator enforces."""
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        return
    k = 1
    while os.path.exists(f"{path}.{k}"):
        k += 1
    os.replace(path, f"{path}.{k}")


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def prometheus_text(snapshot: Dict[str, dict],
                    prefix: str = "paddle_tpu") -> str:
    """Registry snapshot -> Prometheus textfile exposition. Counters
    get the conventional ``_total`` suffix; histograms export as
    summaries (count/sum + p50/p90/p95/p99 quantile samples from the
    bounded reservoir — rank-local, like the snapshot itself)."""
    lines = []
    for name in sorted(snapshot):
        s = snapshot[name]
        typ = s.get("type")
        if typ == "counter":
            n = _prom_name(prefix, name) + "_total"
            lines += [f"# TYPE {n} counter", f"{n} {_fmt(s['value'])}"]
        elif typ == "gauge":
            if s.get("value") is None:
                continue
            n = _prom_name(prefix, name)
            lines += [f"# TYPE {n} gauge", f"{n} {_fmt(s['value'])}"]
        elif typ == "histogram":
            n = _prom_name(prefix, name)
            lines.append(f"# TYPE {n} summary")
            lines.append(f"{n}_count {_fmt(s.get('count', 0))}")
            if s.get("count"):
                lines.append(f"{n}_sum {_fmt(s['sum'])}")
                for q, key in ((0.5, "p50"), (0.9, "p90"),
                               (0.95, "p95"), (0.99, "p99")):
                    if s.get(key) is not None:
                        lines.append(
                            f'{n}{{quantile="{q}"}} {_fmt(s[key])}')
    return "\n".join(lines) + "\n"


class MetricsSink:
    """See module docstring. ``start()`` launches the interval thread;
    ``flush(reason)`` is safe from any thread; ``close()`` is
    idempotent and always ends with a final flush."""

    def __init__(self, directory: str, interval_s: float = 10.0,
                 prefix: str = "paddle_tpu",
                 metrics_file: str = "metrics.jsonl",
                 events_file: str = "events.jsonl",
                 prom_file: str = "metrics.prom",
                 event_log: Optional[_events.EventLog] = None,
                 rank: Optional[int] = None,
                 frames: bool = True, frame_keep: int = 16):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        if frame_keep < 2:
            raise ValueError("frame_keep must be >= 2")
        self.rank = _detect_rank() if rank is None else int(rank)
        if self.rank < 0:
            raise ValueError("rank must be >= 0")
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.interval_s = float(interval_s)
        self.prefix = prefix
        self._metrics_path = os.path.join(directory, metrics_file)
        self._events_path = os.path.join(directory, events_file)
        self._prom_path = os.path.join(directory, prom_file)
        _rotate(self._metrics_path)   # prom is rewritten atomically —
        _rotate(self._events_path)    # latest-wins is its contract
        self._event_log = event_log or _events.log()
        self._cursor = 0           # event-log seq already persisted
        self._flushes = 0
        self._flush_errors = 0     # failed/timed-out flush attempts
        self._last_error: Optional[str] = None
        # telemetry frames: every flush also publishes an atomic
        # per-rank frame
        self.frames = bool(frames)
        self._frames_dir = os.path.join(directory, "frames")
        self._frame_keep = int(frame_keep)
        self._frames_written = 0
        self._frame_errors = 0     # failed publications (fire-and-
        self._prev_counters: Dict[str, float] = {}  # forget, counted)
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "MetricsSink":
        if self._thread is None and not self._closed:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="profiler-sink", daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.flush("interval")
            except Exception:  # keep the writer alive; the failure is
                pass           # already counted by flush()

    def close(self, reason: str = "exit",
              timeout: Optional[float] = None) -> None:
        """``timeout`` bounds each lock wait (same contract as
        ``flush``): a writer thread wedged in hung I/O must not hang
        process exit — the atexit hook passes one, skipping the final
        flush rather than blocking forever."""
        if not self._lock.acquire(timeout=-1 if timeout is None
                                  else timeout):
            self._closed = True       # wedged writer: give up the flush
            self._flush_errors += 1
            self._last_error = f"close({reason!r}): lock timeout"
            self._stop.set()
            return
        try:
            if self._closed:
                return
            self._closed = True
        finally:
            self._lock.release()
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5)
        self._thread = None
        if not self._lock.acquire(timeout=-1 if timeout is None
                                  else timeout):
            return
        try:
            self._flush_locked(reason)
        finally:
            self._lock.release()

    def __enter__(self) -> "MetricsSink":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- flushing ----------------------------------------------------------
    def flush(self, reason: str = "manual",
              timeout: Optional[float] = None) -> Optional[dict]:
        """``timeout`` makes the flush best-effort: if the writer lock
        cannot be acquired in time (the interval thread wedged in hung
        I/O while holding it), return None instead of blocking. The
        watchdog's fire path uses this — a stuck flush must never stand
        between the watchdog and its abort ``os._exit``."""
        if not self._lock.acquire(timeout=-1 if timeout is None
                                  else timeout):
            # a wedged writer IS a flush failure: data the caller asked
            # to persist did not land — count it so summary() shows it
            self._flush_errors += 1
            self._last_error = f"flush({reason!r}): lock timeout"
            return None
        try:
            if self._closed:
                return None
            try:
                return self._flush_locked(reason)
            except Exception as e:
                self._flush_errors += 1
                self._last_error = \
                    f"flush({reason!r}): {type(e).__name__}: {e}"
                raise
        finally:
            self._lock.release()

    def _flush_locked(self, reason: str) -> dict:
        with self._lock:
            snap = registry().snapshot()
            # stamp-then-increment BEFORE any I/O: a flush that dies
            # mid-write leaves a GAP in flush_seq, never a duplicate
            # (the schema validator requires strictly-increasing seqs)
            seq = self._flushes
            self._flushes += 1
            evs, cursor = self._event_log.since(self._cursor)
            # ring overflow between flushes ages events out before they
            # persist: the segment then starts past the cursor (or the
            # cursor jumps with no events at all). Count the gap — the
            # loss lands in this flush's metrics line, never silent.
            first = evs[0].seq if evs else cursor
            lost = max(0, first - self._cursor)
            if evs:
                # rank-stamped at write: events are process-local, so
                # the writer's rank IS the event's rank
                seg = "".join(
                    json.dumps({**ev.to_dict(), "rank": self.rank})
                    + "\n" for ev in evs)
                with open(self._events_path, "a") as f:
                    f.write(seg)
            elif not os.path.exists(self._events_path):
                # schema contract: the file exists even before the
                # first event (a validator must not special-case it)
                open(self._events_path, "a").close()
            # the cursor advances only once the segment hit the file —
            # an I/O error above re-sends it on the next flush
            self._cursor = cursor
            # cross-host tracing metadata: (clock.wall_s,
            # t_ns) is this rank's wall-clock anchor — the pair is
            # read back-to-back, so an offline consumer can place any
            # event's perf_counter t_ns on this rank's wall clock;
            # offset_s/unc_s are the agreed clock alignment (relative
            # to clock.ref) tools/merge_traces.py corrects with.
            # clock.wall_s deliberately comes from disttrace.walltime
            # (ts below stays the process's REAL time): an injected
            # test skew must reach the anchor, or the mesh tests could
            # not prove the offset correction recovers it.
            # the wall read is BRACKETED by two monotonic reads: the
            # midpoint pairs the clocks to first order even if the
            # thread is preempted between the reads, and the half-gap
            # is stamped as anchor_unc_s so the merger can widen its
            # slack instead of flagging a phantom ordering violation
            t_a = time.perf_counter_ns()
            wall = _disttrace.walltime()
            t_b = time.perf_counter_ns()
            t_ns = (t_a + t_b) // 2
            clock = dict(_disttrace.clock_state(),
                         wall_s=round(wall, 6),
                         anchor_unc_s=round((t_b - t_a) / 2e9, 9))
            line = {"ts": round(time.time(), 6), "reason": reason,
                    "rank": self.rank, "flush_seq": seq,
                    "t_ns": t_ns, "clock": clock,
                    "events_lost": lost, "metrics": snap}
            with open(self._metrics_path, "a") as f:
                f.write(json.dumps(line) + "\n")
            tmp = self._prom_path + ".tmp"
            with open(tmp, "w") as f:
                f.write(prometheus_text(snap, self.prefix))
            os.replace(tmp, self._prom_path)
            # telemetry frame: fire-and-forget — a dead or
            # slow aggregator-side filesystem must never fail the flush
            # the metrics line above already committed
            if self.frames:
                try:
                    self._publish_frame(seq, line, snap)
                except Exception as e:
                    self._frame_errors += 1
                    self._last_error = \
                        f"frame({seq}): {type(e).__name__}: {e}"
            # deltas in a later flight dump read "since the last flush"
            _events.flight_recorder().mark()
            return line

    def _publish_frame(self, seq: int, line: dict,
                       snap: Dict[str, dict]) -> None:
        """Write ``frames/rank<K>-<seq>.json`` atomically (tmp +
        rename): cumulative counters with
        deltas-since-last-frame, last-value gauges, CUMULATIVE sketch
        buckets (cross-rank merge stays exact; a lost frame costs
        nothing — the next one carries the full state), this flush's
        clock anchor, and the consensus epochs this rank adopted
        (``consensus.adopted_epochs``). Old
        frames beyond ``frame_keep`` are pruned — the frames dir is a
        rolling tail, not an archive (metrics.jsonl is the archive)."""
        counters: Dict[str, dict] = {}
        gauges: Dict[str, Optional[float]] = {}
        new_prev: Dict[str, float] = {}
        for name, s in snap.items():
            if s.get("type") == "counter":
                v = float(s["value"] or 0.0)
                counters[name] = {
                    "v": v,
                    "d": round(v - self._prev_counters.get(name, 0.0),
                               9)}
                new_prev[name] = v
            elif s.get("type") == "gauge":
                gauges[name] = s["value"]
        from ..distributed.consensus import adopted_epochs

        epochs: Dict[str, int] = adopted_epochs()
        frame = {"kind": "telemetry_frame", "rank": self.rank,
                 "seq": seq, "ts": line["ts"], "t_ns": line["t_ns"],
                 "clock": line["clock"],
                 "events_lost": line["events_lost"],
                 "adopted_epochs": epochs, "counters": counters,
                 "gauges": gauges,
                 "sketches": registry().sketch_dicts()}
        os.makedirs(self._frames_dir, exist_ok=True)
        name = f"rank{self.rank}-{seq}.json"
        tmp = os.path.join(self._frames_dir, f".{name}.tmp")
        with open(tmp, "w") as f:
            f.write(json.dumps(frame))
        os.replace(tmp, os.path.join(self._frames_dir, name))
        # deltas advance only once the frame LANDED — a failed write
        # re-bases the next frame's "d" on the last published one
        self._prev_counters.update(new_prev)
        self._frames_written += 1
        floor = seq - self._frame_keep
        if floor >= 0:
            pat = re.compile(rf"^rank{self.rank}-(\d+)\.json$")
            for fn in os.listdir(self._frames_dir):
                m = pat.match(fn)
                if m and int(m.group(1)) <= floor:
                    try:
                        os.remove(os.path.join(self._frames_dir, fn))
                    except OSError:  # pragma: no cover - racing reader
                        pass

    @property
    def flushes(self) -> int:
        return self._flushes

    @property
    def flush_errors(self) -> int:
        """Flush attempts that failed (I/O error or lock timeout) —
        surfaced in-process via ``profiler.summary()["sink"]``, not
        just implied by holes in the on-disk artifacts."""
        return self._flush_errors

    @property
    def frames_written(self) -> int:
        return self._frames_written

    @property
    def frame_errors(self) -> int:
        """Telemetry-frame publications that failed (counted, never
        raised — a dead aggregator-side filesystem must not block the
        serving process's flush path)."""
        return self._frame_errors

    @property
    def last_error(self) -> Optional[str]:
        return self._last_error


# ---------------------------------------------------------------------------
# process-global active sink
# ---------------------------------------------------------------------------
_active: Optional[MetricsSink] = None
_atexit_registered = False


def _atexit_close() -> None:  # pragma: no cover - interpreter teardown
    s = _active
    if s is not None:
        try:
            # bounded: a writer wedged in hung I/O (holding the flush
            # lock) must not hang interpreter exit
            s.close("exit", timeout=10.0)
        except Exception:
            pass


def _detect_rank() -> int:
    """This process's rank in ``torch.distributed`` (0 when it was never
    initialized)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def _detect_world() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


def enable_sink(directory: str, per_rank_subdir: Optional[bool] = None,
                **kwargs) -> MetricsSink:
    """Create + start the process's active sink (closing any prior
    one) and register the exit flush. kwargs ride to MetricsSink.

    On a multi-process mesh each rank's artifacts land in
    ``<directory>/rank<K>/`` (``per_rank_subdir``: None = auto, on
    exactly when the ``torch.distributed`` world has more than one
    process): N processes never share a JSONL file, so no interleaved
    or torn lines, and the per-file seq contract survives."""
    global _active, _atexit_registered
    if _active is not None:
        _active.close("replaced")
    rank = kwargs.get("rank")
    if rank is None:
        rank = _detect_rank()
        kwargs["rank"] = rank
    if per_rank_subdir is None:
        per_rank_subdir = _detect_world() > 1
    if per_rank_subdir:
        directory = os.path.join(directory, f"rank{rank}")
    _active = MetricsSink(directory, **kwargs).start()
    if not _atexit_registered:
        atexit.register(_atexit_close)
        _atexit_registered = True
    return _active


def disable_sink(reason: str = "disabled") -> None:
    global _active
    if _active is not None:
        _active.close(reason)
        _active = None


def active_sink() -> Optional[MetricsSink]:
    return _active


def stats() -> dict:
    """In-process sink health: {active, directory, flushes,
    flush_errors, last_error} — what ``profiler.summary()`` embeds so
    a failing writer is visible BEFORE anyone reads metrics.jsonl."""
    s = _active
    if s is None:
        return {"active": False, "flushes": 0, "flush_errors": 0,
                "frames": 0, "frame_errors": 0, "last_error": None}
    return {"active": True, "directory": s.directory,
            "flushes": s.flushes, "flush_errors": s.flush_errors,
            "frames": s.frames_written, "frame_errors": s.frame_errors,
            "last_error": s.last_error}


def flush_active(reason: str,
                 timeout: Optional[float] = None) -> Optional[dict]:
    """Flush the active sink if there is one; never raises (called
    from watchdog fires and preemption paths). ``timeout`` bounds the
    wait for a wedged writer — see MetricsSink.flush."""
    s = _active
    if s is None:
        return None
    try:
        return s.flush(reason, timeout=timeout)
    except Exception:  # pragma: no cover - post-mortem shield
        return None
