"""The live mesh telemetry plane: tail every rank's frames, merge,
alert, publish (mirrors ``paddle_tpu/profiler/live.py``).

Every rank's ``MetricsSink`` flush publishes an atomic telemetry frame
(``frames/rank<K>-<seq>.json``: counter values and deltas, last-value
gauges, CUMULATIVE sketch buckets, the flush's clock anchor, the adopted
consensus epochs). A :class:`LiveAggregator`, in a process of its own
or on any rank, pure stdlib, with no collectives and no device call, tails those
frames and rewrites, atomically, every tick:

- ``mesh_status.json``: per-rank health (frame age, torn count, clock
  sync, lease corroboration, dead flag), mesh-wide latency percentiles
  from bucket-wise merged sketches (an exact merge: the mesh p95 is the
  union sketch's, within the sketch's ``rel_err`` of the true stream),
  window rollups (tokens/s, prefix-hit rate, page pressure, busy
  fraction) and the alert board;
- ``mesh_status.prom``: the same as a Prometheus textfile;
- ``mesh_status_history.jsonl``: a rolling tail of every published
  status (the viewer's ``--history``).

The frames' names and keys are the reference's, so one aggregator reads
a root where ranks of both packages write, and this module equals the
reference's on such a root (``ts`` aside).

The elastic mesh: when the consensus board holds a ``member`` family,
the aggregator's world FOLLOWS the latest agreed member set (the
``membership`` block: epoch, members, source) instead of the static
``world``. Alert rules may be ``per_rank=True``: the stock ``dead_rank``
rule keeps a damped streak a rank, and its transitions name the rank.

The transport is the shared directory, as the consensus board's: the
aggregator can never block serving; a dead aggregator leaves a stale
``mesh_status.json`` (its own ``ts`` says so).

Degradation is stated, never guessed:

- a torn frame (killed mid-write before the atomic rename, or a corrupt
  landing) is COUNTED (``torn`` a rank, ``frames_torn`` for the mesh)
  and skipped;
- a rank whose clock never synced aggregates with ``unc=None``: its
  samples count, the status cannot bound the cross-host part;
- rank death needs TWO signals: frame age past ``staleness_s`` AND the
  consensus lease stale or absent (when a board is given). A fresh
  lease with stale frames reads ``stale``, not ``dead``.

TTFT source: ranks publishing ``serving/e2e_ttft_ms`` (the disaggregated
coordinator's offset-corrected end-to-end sketch) win over the engine's
``serving/ttft_ms``, which is local to the rank for imported requests:
if ANY rank has the e2e sketch, only e2e sketches merge.

Alerting: declarative :class:`AlertRule`\\ s evaluated every tick; a
rule fires after ``for_ticks`` consecutive breaches and resolves only
below ``hysteresis * threshold``. Every transition lands as an ``alert``
event in the ring and a sink flush (reason ``alert``), and the FIRST
firing of each rule dumps the flight recorder.

The viewer: ``python -m paddle_tpu_torch.profiler.live ROOT [--once]
[--history N] [--board DIR --world N]`` repaints a status table every
tick (a mirror of the reference's ``tools/live_dash.py``); it runs the
aggregator with ``emit_alerts=False``, so a reader writes no events.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from . import events as _events
from .sketch import QuantileSketch

__all__ = ["AlertRule", "LiveAggregator", "default_rules"]

_FRAME_RE = re.compile(r"^rank(\d+)-(\d+)\.json$")

#: status latency key -> frame sketch name (first present wins; see
#: module docstring for the e2e-over-local TTFT rule)
_LATENCY_SOURCES = (
    ("ttft_ms", ("serving/e2e_ttft_ms", "serving/ttft_ms")),
    ("tpot_ms", ("serving/tpot_ms",)),
    ("queue_wait_ms", ("serving/prefill_queue_wait_ms",)),
)


class AlertRule:
    """One declarative health condition over the mesh status.

    ``probe(status) -> Optional[float]`` extracts the watched value
    (None = not evaluable this tick — streaks HOLD, they neither grow
    nor clear on missing data). Breach is ``value >= threshold``
    (probes are phrased so bigger is worse); the rule fires after
    ``for_ticks`` CONSECUTIVE breaches and resolves after
    ``clear_ticks`` consecutive ticks with ``value <
    hysteresis * threshold`` (``hysteresis <= 1`` pulls the resolve
    line below the fire line, so a value sitting on the threshold
    cannot flap the alert).

    ``per_rank=True`` changes the probe contract:
    ``probe(status) -> Dict[rank, Optional[float]]`` and the rule runs
    an INDEPENDENT streak machine per rank — rank 3 flapping must not
    reset rank 1's breach streak, and one transition names the rank it
    happened on (``"rank"`` in the transition dict and on the ring
    event). The aggregate view stays intact: ``firing`` is true while
    ANY rank fires, ``last_value`` is the worst evaluable rank, and
    ``state()`` keeps the scalar keys plus a ``per_rank`` sub-block.
    A rank that disappears from the probe's dict (left the mesh)
    holds its streaks, like a None value."""

    __slots__ = ("name", "probe", "threshold", "for_ticks",
                 "hysteresis", "clear_ticks", "firing", "fired_count",
                 "last_value", "_streak", "_clear", "per_rank",
                 "_rank_states")

    def __init__(self, name: str,
                 probe: Callable[[dict], Optional[float]],
                 threshold: float, for_ticks: int = 1,
                 hysteresis: float = 1.0, clear_ticks: int = 1,
                 per_rank: bool = False):
        if for_ticks < 1 or clear_ticks < 1:
            raise ValueError("for_ticks/clear_ticks must be >= 1")
        if not 0.0 < hysteresis <= 1.0:
            raise ValueError("hysteresis must be in (0, 1]")
        self.name = name
        self.probe = probe
        self.threshold = float(threshold)
        self.for_ticks = int(for_ticks)
        self.hysteresis = float(hysteresis)
        self.clear_ticks = int(clear_ticks)
        self.per_rank = bool(per_rank)
        self.firing = False
        self.fired_count = 0
        self.last_value: Optional[float] = None
        self._streak = 0
        self._clear = 0
        self._rank_states: Dict[str, dict] = {}

    def evaluate(self, status: dict) -> Optional[str]:
        """Advance the state machine one tick; returns the transition
        (``"firing"`` / ``"resolved"``) or None. Never raises — a
        probe error reads as not-evaluable. Scalar rules only; a
        per-rank rule is driven via :meth:`evaluate_all`."""
        if self.per_rank:
            raise TypeError(f"rule {self.name!r} is per_rank: drive "
                            "it with evaluate_all()")
        try:
            v = self.probe(status)
        except Exception:
            v = None
        self.last_value = None if v is None else float(v)
        if v is None:
            return None
        if not self.firing:
            if v >= self.threshold:
                self._streak += 1
                if self._streak >= self.for_ticks:
                    self.firing = True
                    self.fired_count += 1
                    self._clear = 0
                    return "firing"
            else:
                self._streak = 0
            return None
        if v < self.hysteresis * self.threshold:
            self._clear += 1
            if self._clear >= self.clear_ticks:
                self.firing = False
                self._streak = 0
                return "resolved"
        else:
            self._clear = 0
        return None

    def _step_rank(self, rs: dict, v: Optional[float]) -> Optional[str]:
        """One rank's streak machine — the same damped transitions as
        the scalar path, over the rank's own state dict."""
        rs["value"] = None if v is None else float(v)
        if v is None:
            return None
        if not rs["firing"]:
            if v >= self.threshold:
                rs["streak"] += 1
                if rs["streak"] >= self.for_ticks:
                    rs["firing"] = True
                    rs["fired_count"] += 1
                    rs["clear"] = 0
                    return "firing"
            else:
                rs["streak"] = 0
            return None
        if v < self.hysteresis * self.threshold:
            rs["clear"] += 1
            if rs["clear"] >= self.clear_ticks:
                rs["firing"] = False
                rs["streak"] = 0
                return "resolved"
        else:
            rs["clear"] = 0
        return None

    def evaluate_all(self, status: dict) -> List[dict]:
        """Advance one tick and return this rule's transition dicts
        (possibly several for a per-rank rule: rank 1 can fire on the
        same tick rank 3 resolves)."""
        if not self.per_rank:
            tr = self.evaluate(status)
            if tr is None:
                return []
            return [{"rule": self.name, "state": tr,
                     "value": self.last_value,
                     "threshold": self.threshold,
                     "fired_count": self.fired_count}]
        try:
            vals = self.probe(status)
        except Exception:
            vals = None
        if not isinstance(vals, dict):
            vals = {}
        out = []
        for rank in sorted(vals, key=str):
            rs = self._rank_states.setdefault(
                str(rank), {"firing": False, "streak": 0, "clear": 0,
                            "fired_count": 0, "value": None})
            tr = self._step_rank(rs, vals[rank])
            if tr == "firing":
                self.fired_count += 1
            if tr is not None:
                out.append({"rule": self.name, "state": tr,
                            "rank": str(rank), "value": rs["value"],
                            "threshold": self.threshold,
                            "fired_count": self.fired_count})
        self.firing = any(rs["firing"]
                          for rs in self._rank_states.values())
        evaluable = [rs["value"] for rs in self._rank_states.values()
                     if rs["value"] is not None]
        self.last_value = max(evaluable) if evaluable else None
        return out

    def state(self) -> dict:
        st = {"firing": self.firing, "value": self.last_value,
              "threshold": self.threshold,
              "fired_count": self.fired_count}
        if self.per_rank:
            st["per_rank"] = {
                r: {"firing": rs["firing"], "value": rs["value"],
                    "fired_count": rs["fired_count"]}
                for r, rs in sorted(self._rank_states.items())}
        return st


def default_rules(ttft_p95_ms: float = 2000.0,
                  pool_util: float = 0.98,
                  for_ticks: int = 3) -> List[AlertRule]:
    """The stock rule set. ``ttft_p95_ms`` is the SLO
    target; ``for_ticks`` damps the sustained-condition rules (W
    consecutive windows). ``dead_rank`` and ``events_lost`` fire on
    the first breach — neither is a transient."""

    def _p95(st, key="ttft_ms"):
        m = st["latency"].get(key)
        return None if m is None else m.get("p95")

    def _dead(st):
        return {r: float(blk["dead"])
                for r, blk in st["ranks"].items()}

    def _stall(st):
        tps = st["rollups"].get("tokens_per_sec")
        if tps is None:             # no window yet — not evaluable
            return None
        active = max((r.get("gauges", {}).get("serving/active_slots")
                      or 0.0) for r in st["ranks"].values()) \
            if st["ranks"] else 0.0
        return 1.0 if tps == 0.0 and active > 0.0 else 0.0

    def _pressure(st):
        return st["rollups"].get("page_pressure")

    def _lost(st):
        return float(st["events_lost"])

    return [
        AlertRule("p95_ttft_over_target", _p95, ttft_p95_ms,
                  for_ticks=for_ticks, hysteresis=0.9),
        AlertRule("dead_rank", _dead, 1.0, per_rank=True),
        AlertRule("decode_stall", _stall, 1.0, for_ticks=for_ticks),
        AlertRule("pool_pressure", _pressure, pool_util,
                  for_ticks=for_ticks, hysteresis=0.95),
        AlertRule("events_lost", _lost, 1.0),
    ]


class _RankState:
    __slots__ = ("last_seq", "frames", "torn", "ts", "t_ref",
                 "clock", "counters", "gauges", "sketches",
                 "events_lost", "adopted_epochs")

    def __init__(self):
        self.last_seq = -1
        self.frames = 0
        self.torn = 0
        self.ts: Optional[float] = None
        self.t_ref: Optional[float] = None
        self.clock: dict = {}
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, Optional[float]] = {}
        self.sketches: Dict[str, QuantileSketch] = {}
        self.events_lost = 0
        self.adopted_epochs: Dict[str, int] = {}


class LiveAggregator:
    """See module docstring. ``tick()`` is one scan-merge-publish
    pass; ``start()``/``stop()`` wrap it in a daemon thread for
    embedding; ``run()`` drives it in the foreground (the viewer,
    ``main``). Touches no device and runs no collective: pure host
    I/O, safe anywhere."""

    def __init__(self, root: str, interval_s: float = 2.0,
                 staleness_s: Optional[float] = None,
                 world: Optional[int] = None,
                 board_dir: Optional[str] = None,
                 lease_s: float = 5.0,
                 rules: Optional[List[AlertRule]] = None,
                 prefix: str = "paddle_tpu",
                 emit_alerts: bool = True,
                 history_limit: int = 512):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.root = root
        self.interval_s = float(interval_s)
        #: a rank is STALE once its newest frame is older than this;
        #: default 3 aggregation ticks — callers whose sinks flush
        #: slower than that must pass ~1.5x the sink interval
        self.staleness_s = (3.0 * self.interval_s
                            if staleness_s is None
                            else float(staleness_s))
        self.world = world
        self.board_dir = board_dir
        self.lease_s = float(lease_s)
        self.rules = default_rules() if rules is None else list(rules)
        self.prefix = prefix
        self.emit_alerts = bool(emit_alerts)
        self.status_json = os.path.join(root, "mesh_status.json")
        self.status_prom = os.path.join(root, "mesh_status.prom")
        #: rolling JSONL of every published status (the viewer's
        #: ``--history`` replays it); kept to
        #: the last ``history_limit`` lines (0 disables the history)
        self.status_history = os.path.join(
            root, "mesh_status_history.jsonl")
        self.history_limit = int(history_limit)
        self._history_appends = 0
        self._ranks: Dict[int, _RankState] = {}
        self._ticks = 0
        self._last_status: Optional[dict] = None
        self._prev_now: Optional[float] = None
        self._prev_counter_sums: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- frame ingestion ---------------------------------------------------
    def _frames_dirs(self) -> List[str]:
        """``<root>/frames`` (single-process sink) plus every
        ``<root>/rank<K>/frames`` (per-rank subdir mesh layout)."""
        out = []
        d = os.path.join(self.root, "frames")
        if os.path.isdir(d):
            out.append(d)
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for n in sorted(names):
            if n.startswith("rank"):
                d = os.path.join(self.root, n, "frames")
                if os.path.isdir(d):
                    out.append(d)
        return out

    def _ingest(self, st: _RankState, frame: dict) -> None:
        st.ts = float(frame["ts"])
        clock = frame.get("clock") or {}
        st.clock = clock
        # placement on the reference clock (disttrace's sign convention:
        # w_ref = w_k - offset_s); an unsynced rank places on its own
        # wall — same-host it coincides, cross-host the status's
        # synced=False says the age is unbounded-skew
        if clock.get("synced") and clock.get("offset_s") is not None:
            st.t_ref = float(clock["wall_s"]) - float(clock["offset_s"])
        else:
            st.t_ref = st.ts
        st.counters = {n: float(c["v"])
                       for n, c in (frame.get("counters") or {}).items()}
        st.gauges = dict(frame.get("gauges") or {})
        st.events_lost += int(frame.get("events_lost") or 0)
        st.adopted_epochs = dict(frame.get("adopted_epochs") or {})
        sketches = {}
        for name, d in (frame.get("sketches") or {}).items():
            # a malformed sketch is a torn frame in sheep's clothing —
            # from_dict raises, the caller counts
            sketches[name] = QuantileSketch.from_dict(d)
        st.sketches = sketches

    def _scan(self) -> None:
        """Pick up every frame newer than each rank's cursor, in seq
        order. A frame that fails to parse/validate advances the
        cursor (the rename was atomic — a bad landing is FINAL) and
        bumps the rank's ``torn`` count; the rank's state keeps the
        last good frame."""
        pending: Dict[int, List] = {}
        for d in self._frames_dirs():
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for n in names:
                m = _FRAME_RE.match(n)
                if not m:
                    continue
                r, seq = int(m.group(1)), int(m.group(2))
                st = self._ranks.get(r)
                if st is not None and seq <= st.last_seq:
                    continue
                pending.setdefault(r, []).append(
                    (seq, os.path.join(d, n)))
        for r, files in pending.items():
            st = self._ranks.setdefault(r, _RankState())
            for seq, path in sorted(files):
                if seq <= st.last_seq:
                    continue
                st.last_seq = seq
                try:
                    with open(path) as f:
                        frame = json.load(f)
                    if frame.get("kind") != "telemetry_frame" or \
                            int(frame.get("rank", -1)) != r:
                        raise ValueError("frame header mismatch")
                    self._ingest(st, frame)
                    st.frames += 1
                except (OSError, ValueError, KeyError, TypeError):
                    st.torn += 1

    # -- aggregation -------------------------------------------------------
    def _merged_sketches(self) -> Dict[str, dict]:
        """Mesh-wide latency block: per status key, the bucket-wise
        merge of every rank's cumulative sketch for the chosen source
        metric."""
        out: Dict[str, dict] = {}
        any_e2e = any("serving/e2e_ttft_ms" in st.sketches
                      for st in self._ranks.values())
        for key, sources in _LATENCY_SOURCES:
            if key == "ttft_ms" and any_e2e:
                sources = ("serving/e2e_ttft_ms",)
            merged: Optional[QuantileSketch] = None
            contributing: List[int] = []
            for r, st in self._ranks.items():
                for name in sources:
                    sk = st.sketches.get(name)
                    if sk is not None and sk.count:
                        merged = sk.copy() if merged is None \
                            else merged.merge(sk)
                        contributing.append(r)
                        break
            if merged is None or not merged.count:
                continue
            # clock-uncertainty bound on the CROSS-HOST component:
            # only TTFT has one (it spans submit and first-token hosts
            # — worst pair = 2x the largest per-rank bound); TPOT and
            # queue-wait are single-monotonic-clock durations. Any
            # contributing unsynced rank makes the bound unstatable.
            if key != "ttft_ms":
                unc_ms: Optional[float] = 0.0
            else:
                uncs = []
                for r in contributing:
                    c = self._ranks[r].clock
                    if not c.get("synced") or c.get("unc_s") is None:
                        uncs = None
                        break
                    uncs.append(float(c["unc_s"]))
                unc_ms = None if uncs is None \
                    else round(2.0 * max(uncs) * 1e3, 6)
            out[key] = {
                "count": merged.count,
                "min": merged.min, "max": merged.max,
                "p50": merged.percentile(50),
                "p90": merged.percentile(90),
                "p95": merged.percentile(95),
                "p99": merged.percentile(99),
                "unc_ms": unc_ms, "rel_err": merged.rel_err,
                "ranks": sorted(contributing),
            }
        return out

    def _counter_sum(self, name: str) -> float:
        return sum(st.counters.get(name, 0.0)
                   for st in self._ranks.values())

    def _gauge_max(self, name: str) -> Optional[float]:
        vals = [st.gauges.get(name) for st in self._ranks.values()]
        vals = [v for v in vals if v is not None]
        return max(vals) if vals else None

    def _rollups(self, now: float) -> dict:
        """Window rollups from counter deltas between aggregation
        ticks (rate keys are None on the first tick — no window yet)."""
        dt = None if self._prev_now is None else max(
            now - self._prev_now, 1e-9)
        sums = {n: self._counter_sum(n) for n in
                ("serving/tokens_generated", "serving/prefix_hit_tokens",
                 "serving/prompt_tokens")}
        tps = None
        if dt is not None:
            d = sums["serving/tokens_generated"] - \
                self._prev_counter_sums.get(
                    "serving/tokens_generated", 0.0)
            tps = round(max(d, 0.0) / dt, 3)
        hit_rate = None
        if sums["serving/prompt_tokens"] > 0:
            hit_rate = round(sums["serving/prefix_hit_tokens"]
                             / sums["serving/prompt_tokens"], 6)
        self._prev_counter_sums = sums
        return {
            "tokens_per_sec": tps,
            "prefix_hit_rate": hit_rate,
            "page_pressure": self._gauge_max("serving/page_util"),
            "goodput_busy_frac":
                self._gauge_max("trace/goodput_busy_frac"),
        }

    def _membership(self) -> Optional[dict]:
        """The latest agreed ``member`` decision on the consensus
        board: the aggregator's world FOLLOWS the mesh's
        own membership — a joiner shows up in ``mesh_status`` the
        moment the round publishes, a dead rank stops counting as
        "missing" once voted out. None when no board, no member
        family, or no decision yet (static-world fallback)."""
        if self.board_dir is None:
            return None
        fam = os.path.join(self.board_dir, "member")
        try:
            # dir names are e<epoch>, zero-padded by the consensus
            # (e000004) — keep the real name, sort by the number
            epochs = sorted((int(n[1:]), n) for n in os.listdir(fam)
                            if n.startswith("e") and n[1:].isdigit())
        except OSError:
            return None
        for e, name in reversed(epochs):
            path = os.path.join(fam, name, "decision.json")
            try:
                with open(path) as f:
                    dec = json.load(f)
                members = {str(k): str(v) for k, v in
                           ((dec.get("value") or {})
                            .get("members") or {}).items()}
                if not members:
                    raise ValueError("empty member table")
                return {"epoch": e, "members": members,
                        "source": "board"}
            except (OSError, ValueError, KeyError, TypeError):
                continue            # undecided/torn epoch: look older
        return None

    # -- publication -------------------------------------------------------
    def _rank_block(self, now: float,
                    world: Optional[int]) -> Dict[str, dict]:
        lease_ages: Dict[int, float] = {}
        if self.board_dir is not None:
            try:
                from ..distributed.consensus import lease_ages as _la
                lease_ages = _la(self.board_dir, world)
            except Exception:
                lease_ages = {}
        out: Dict[str, dict] = {}
        for r, st in sorted(self._ranks.items()):
            age = None if st.t_ref is None else max(0.0, now - st.t_ref)
            stale = age is not None and age >= self.staleness_s
            lease_age = lease_ages.get(r)
            # death needs corroboration when a board is present: stale
            # frames AND a stale/absent lease. Without a board, frame
            # staleness alone decides (documented weaker evidence).
            dead = stale and (self.board_dir is None
                              or lease_age is None
                              or lease_age >= self.lease_s)
            out[str(r)] = {
                "seq": st.last_seq, "frames": st.frames,
                "torn": st.torn,
                "age_s": None if age is None else round(age, 3),
                "synced": bool(st.clock.get("synced")),
                "offset_s": st.clock.get("offset_s"),
                "unc_s": st.clock.get("unc_s"),
                "stale": stale, "dead": dead,
                "lease_age_s": None if lease_age is None
                else round(lease_age, 3),
                "events_lost": st.events_lost,
                "gauges": st.gauges,
                "adopted_epochs": st.adopted_epochs,
            }
        return out

    def _build_status(self, now: float) -> dict:
        membership = self._membership()
        # the agreed member set outranks the static --world: joiners
        # count, voted-out ranks stop reading as "missing"
        world = (len(membership["members"]) if membership
                 else self.world)
        ranks = self._rank_block(now, world)
        if membership:
            present = {str(r) for r in membership["members"]}
            missing = bool(present - set(ranks))
        else:
            missing = world is not None and len(ranks) < world
        status = {
            "kind": "mesh_status", "ts": round(now, 6),
            "root": self.root, "tick": self._ticks,
            "interval_s": self.interval_s,
            "staleness_s": self.staleness_s,
            "world": world,
            "membership": membership,
            "ranks": ranks,
            "partial": bool(missing
                            or any(r["dead"] or r["torn"]
                                   for r in ranks.values())),
            "frames_torn": sum(r["torn"] for r in ranks.values()),
            "events_lost": sum(r["events_lost"]
                               for r in ranks.values()),
            "latency": self._merged_sketches(),
            "rollups": self._rollups(now),
        }
        return status

    def _prom_text(self, status: dict) -> str:
        p = self.prefix
        lines = [f"# TYPE {p}_mesh_partial gauge",
                 f"{p}_mesh_partial {int(status['partial'])}",
                 f"# TYPE {p}_mesh_frames_torn gauge",
                 f"{p}_mesh_frames_torn {status['frames_torn']}",
                 f"# TYPE {p}_mesh_events_lost gauge",
                 f"{p}_mesh_events_lost {status['events_lost']}"]
        if status.get("membership"):
            lines += [f"# TYPE {p}_mesh_members gauge",
                      f"{p}_mesh_members "
                      f"{len(status['membership']['members'])}"]
        for r, blk in status["ranks"].items():
            lines.append(f'{p}_mesh_rank_dead{{rank="{r}"}} '
                         f'{int(blk["dead"])}')
        for key, m in status["latency"].items():
            n = f"{p}_mesh_{key.replace('/', '_')}"
            lines.append(f"# TYPE {n} summary")
            lines.append(f"{n}_count {m['count']}")
            for q, k in ((0.5, "p50"), (0.9, "p90"),
                         (0.95, "p95"), (0.99, "p99")):
                lines.append(f'{n}{{quantile="{q}"}} {m[k]}')
        for key, v in status["rollups"].items():
            if v is None:
                continue
            n = f"{p}_mesh_{key}"
            lines += [f"# TYPE {n} gauge", f"{n} {v}"]
        for rule in self.rules:
            lines.append(f'{p}_mesh_alert_firing{{rule="{rule.name}"}}'
                         f' {int(rule.firing)}')
        return "\n".join(lines) + "\n"

    def _publish(self, status: dict) -> None:
        os.makedirs(self.root, exist_ok=True)
        for path, text in ((self.status_json,
                            json.dumps(status, indent=1)),
                           (self.status_prom,
                            self._prom_text(status))):
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(text)
            os.replace(tmp, path)
        self._append_history(status)

    def _append_history(self, status: dict) -> None:
        """One compact JSONL line per publish, rolled to the last
        ``history_limit`` lines. The trim rewrites atomically (tmp +
        replace) so a tailing dashboard never reads a torn file; it
        runs every 64 appends, so the file briefly overshoots the
        limit — a bounded-disk guarantee, not an exact-length one."""
        if self.history_limit <= 0:
            return
        line = json.dumps(status, separators=(",", ":"))
        with open(self.status_history, "a") as f:
            f.write(line + "\n")
        self._history_appends += 1
        if self._history_appends % 64 == 0:
            try:
                with open(self.status_history) as f:
                    lines = f.readlines()
                if len(lines) > self.history_limit:
                    tmp = self.status_history + ".tmp"
                    with open(tmp, "w") as f:
                        f.writelines(lines[-self.history_limit:])
                    os.replace(tmp, self.status_history)
            except OSError:
                pass                # next trim pass retries

    # -- alerting ----------------------------------------------------------
    def _evaluate_rules(self, status: dict) -> List[dict]:
        transitions = []
        for rule in self.rules:
            transitions.extend(rule.evaluate_all(status))
        status["alerts"] = {r.name: r.state() for r in self.rules}
        status["alert_transitions"] = transitions
        if transitions and self.emit_alerts:
            self._emit_transitions(transitions)
        return transitions

    def _emit_transitions(self, transitions: List[dict]) -> None:
        """Alert side effects, all shielded — telemetry must never
        take the aggregator down: the ``alert`` ring event, a sink
        flush (reason ``alert`` — the transition is on disk NOW, not
        at the next interval), and a flight dump on each rule's FIRST
        firing."""
        from . import sink as _sink
        for t in transitions:
            try:
                kw = dict(rule=t["rule"], state=t["state"],
                          value=t["value"], threshold=t["threshold"])
                if "rank" in t:       # per-rank rule: name the rank
                    kw["rank"] = t["rank"]
                _events.emit("alert", **kw)
            except Exception:
                pass
            if t["state"] == "firing" and t["fired_count"] == 1:
                try:
                    _events.dump_flight(f"alert-{t['rule']}")
                except Exception:
                    pass
        try:
            _sink.flush_active("alert", timeout=1.0)
        except Exception:
            pass

    # -- driving -----------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> dict:
        """One scan-merge-publish-alert pass; returns (and retains)
        the status document it wrote."""
        with self._lock:
            now = time.time() if now is None else float(now)
            self._ticks += 1
            self._scan()
            status = self._build_status(now)
            self._evaluate_rules(status)
            try:
                self._publish(status)
            except OSError:
                # a torn publish target is the CONSUMER's outage, not
                # serving's — keep ticking, the next rewrite heals it
                pass
            self._last_status = status
            self._prev_now = now
            return status

    @property
    def status(self) -> Optional[dict]:
        """The last tick's document (None before the first tick)."""
        return self._last_status

    def start(self) -> "LiveAggregator":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="live-aggregator", daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                pass                # next tick retries; never escapes

    def stop(self, final_tick: bool = True) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2 * self.interval_s + 5)
        self._thread = None
        if final_tick:
            self.tick()

    def run(self, duration_s: Optional[float] = None,
            on_tick: Optional[Callable[[dict], None]] = None) -> None:
        """Foreground drive (the viewer, ``main``): tick every
        ``interval_s`` until ``duration_s`` elapses (forever if None)
        or KeyboardInterrupt."""
        t0 = time.time()
        while duration_s is None or time.time() - t0 < duration_s:
            st = self.tick()
            if on_tick is not None:
                on_tick(st)
            time.sleep(self.interval_s)

    def __enter__(self) -> "LiveAggregator":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False


# ---------------------------------------------------------------------------
# the viewer: python -m paddle_tpu_torch.profiler.live ROOT
# ---------------------------------------------------------------------------
def _fmt(v, nd=1):
    if v is None:
        return "-"
    return f"{v:.{nd}f}"


def render(st: dict) -> str:
    lines = []
    flags = []
    if st["partial"]:
        flags.append("PARTIAL")
    if st["frames_torn"]:
        flags.append(f"torn={st['frames_torn']}")
    if st["events_lost"]:
        flags.append(f"events_lost={st['events_lost']}")
    lines.append(
        f"mesh_status tick={st['tick']} "
        f"ranks={len(st['ranks'])}"
        + (f"/{st['world']}" if st.get("world") else "")
        + (" [" + " ".join(flags) + "]" if flags else " [ok]"))
    mem = st.get("membership")
    if mem:
        roster = " ".join(f"{r}:{role}" for r, role in
                          sorted(mem["members"].items(),
                                 key=lambda kv: int(kv[0])))
        lines.append(f"members e{mem['epoch']} [{roster}]")
    lines.append(f"{'rank':>4} {'seq':>5} {'age_s':>7} {'sync':>5} "
                 f"{'state':>6} {'torn':>4} {'lease':>7}")
    for r, blk in st["ranks"].items():
        state = ("DEAD" if blk["dead"]
                 else "stale" if blk["stale"] else "live")
        lines.append(
            f"{r:>4} {blk['seq']:>5} {_fmt(blk['age_s'], 2):>7} "
            f"{'y' if blk['synced'] else 'n':>5} {state:>6} "
            f"{blk['torn']:>4} {_fmt(blk['lease_age_s'], 1):>7}")
    if st["latency"]:
        lines.append(f"{'latency':>14} {'count':>7} {'p50':>9} "
                     f"{'p95':>9} {'p99':>9} {'unc_ms':>8}")
        for key, m in st["latency"].items():
            lines.append(
                f"{key:>14} {m['count']:>7} {_fmt(m['p50']):>9} "
                f"{_fmt(m['p95']):>9} {_fmt(m['p99']):>9} "
                f"{_fmt(m['unc_ms'], 3):>8}")
    ro = st["rollups"]
    lines.append(
        f"tokens/s={_fmt(ro['tokens_per_sec'])} "
        f"prefix_hit={_fmt(ro['prefix_hit_rate'], 3)} "
        f"page_util={_fmt(ro['page_pressure'], 3)} "
        f"busy_frac={_fmt(ro['goodput_busy_frac'], 3)}")
    firing = [n for n, a in st.get("alerts", {}).items()
              if a["firing"]]
    lines.append("alerts: " + (", ".join(
        f"{n}(v={_fmt(st['alerts'][n]['value'], 1)})"
        for n in firing) if firing else "none firing"))
    return "\n".join(lines)


def render_history(root: str, last: int) -> str:
    """Compact one-line-per-tick replay of the rolling
    ``mesh_status_history.jsonl`` the aggregator appends on every
    publish: when did the member set change, when did a
    rank die, how did the p95 move. Torn/partial lines are skipped
    (the trim rewrite is atomic; a torn TAIL line means a writer is
    mid-append right now)."""
    path = os.path.join(root, "mesh_status_history.jsonl")
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError:
        return f"no history at {path} (aggregator never published?)"
    out = [f"{'tick':>6} {'ts':>12} {'ranks':>5} {'members':>9} "
           f"{'dead':>4} {'ttft_p95':>9} alerts"]
    for raw in lines[-last:]:
        try:
            st = json.loads(raw)
        except ValueError:
            continue
        mem = st.get("membership")
        members = ("e{} n={}".format(mem["epoch"],
                                     len(mem["members"]))
                   if mem else "-")
        dead = sum(1 for b in st.get("ranks", {}).values()
                   if b.get("dead"))
        p95 = (st.get("latency", {}).get("ttft_ms") or {}).get("p95")
        firing = [n for n, a in st.get("alerts", {}).items()
                  if a.get("firing")]
        out.append(
            f"{st.get('tick', -1):>6} {st.get('ts', 0):>12.1f} "
            f"{len(st.get('ranks', {})):>5} {members:>9} {dead:>4} "
            f"{_fmt(p95):>9} "
            + (",".join(firing) if firing else "-"))
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.profiler.live",
        description="In-terminal live view of the mesh telemetry plane")
    ap.add_argument("root", help="sink root directory to tail")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="aggregation tick seconds (default 2)")
    ap.add_argument("--staleness", type=float, default=None,
                    help="rank-dead frame age (default 3x interval)")
    ap.add_argument("--world", type=int, default=None,
                    help="expected rank count (partial below it)")
    ap.add_argument("--board", default=None,
                    help="consensus board dir for lease corroboration")
    ap.add_argument("--lease-s", type=float, default=5.0)
    ap.add_argument("--ttft-slo-ms", type=float, default=2000.0,
                    help="p95 TTFT alert target")
    ap.add_argument("--once", action="store_true",
                    help="one tick, print, exit (CI / scripting)")
    ap.add_argument("--history", type=int, nargs="?", const=50,
                    default=None, metavar="N",
                    help="replay the last N lines of "
                         "mesh_status_history.jsonl and exit "
                         "(default 50)")
    ap.add_argument("--duration", type=float, default=None,
                    help="stop after this many seconds")
    args = ap.parse_args(argv)

    if args.history is not None:
        print(render_history(args.root, args.history))
        return 0

    agg = LiveAggregator(
        args.root, interval_s=args.interval,
        staleness_s=args.staleness, world=args.world,
        board_dir=args.board, lease_s=args.lease_s,
        rules=default_rules(ttft_p95_ms=args.ttft_slo_ms),
        emit_alerts=False)  # a reader must not write alert events
    if args.once:
        print(render(agg.tick()))
        return 0
    t0 = time.time()
    try:
        while args.duration is None or \
                time.time() - t0 < args.duration:
            st = agg.tick()
            # repaint in place when attached to a tty; plain append
            # otherwise (logs stay readable)
            if sys.stdout.isatty():
                sys.stdout.write("\x1b[2J\x1b[H")
            print(render(st), flush=True)
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
