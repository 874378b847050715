"""Runtime metrics registry: counters, gauges and histograms (mirrors
``paddle_tpu/profiler/metrics.py``).

The serving engine writes ``serving/ticks``, ``serving/tokens_per_sec``,
``serving/ttft_ms`` and the rest here. Histograms are backed by the
mergeable quantile sketch (``sketch.py``): exact count/sum/min/max and
percentiles within a stated 1% relative error; ``sketch_dicts()`` is the
sink's telemetry-frame payload. ``aggregate()`` reduces the snapshot
across ranks over the port's ``distributed.fleet.metrics``.
"""
from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from .sketch import QuantileSketch


def percentile(sorted_vals, q: float) -> Optional[float]:
    """Nearest-rank percentile over a PRE-SORTED sequence (None when
    empty) — the reference's one quantile convention."""
    n = len(sorted_vals)
    if n == 0:
        return None
    return sorted_vals[min(int(q / 100.0 * n), n - 1)]


class Counter:
    """Monotonic accumulator (tokens seen, ticks run, bytes)."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._lock = threading.Lock()

    def add(self, v: float = 1.0) -> None:
        with self._lock:
            self._v += float(v)

    @property
    def value(self) -> float:
        return self._v

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self._v}


class Gauge:
    """Last-value metric."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v: Optional[float] = None
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def set_max(self, v: float) -> None:
        """High-water-mark update: keep the max of current and v."""
        with self._lock:
            v = float(v)
            if self._v is None or v > self._v:
                self._v = v

    @property
    def value(self) -> Optional[float]:
        return self._v

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self._v}


class Histogram:
    """Distribution metric backed by a quantile sketch."""

    __slots__ = ("name", "_sk", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._sk = QuantileSketch()
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._sk.observe(v)

    @property
    def count(self) -> int:
        return self._sk.count

    def percentile(self, q: float) -> Optional[float]:
        with self._lock:
            return self._sk.percentile(q)

    def sketch_dict(self) -> dict:
        """The backing sketch's JSON form, read under one lock hold: the
        telemetry frame's payload."""
        with self._lock:
            return self._sk.to_dict()

    def snapshot(self) -> dict:
        with self._lock:
            return self._sk.snapshot()


class MetricsRegistry:
    """Named metric store; ``counter/gauge/histogram(name)`` create on
    first use; ``snapshot()`` is the JSON-ready export."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.snapshot() for name, m in items}

    def sketch_dicts(self) -> Dict[str, dict]:
        """The sketch of every non-empty histogram (a telemetry frame's
        ``sketches``; empty ones are left out)."""
        with self._lock:
            items = [(n, m) for n, m in self._metrics.items()
                     if isinstance(m, Histogram)]
        return {n: d for n, d in ((n, m.sketch_dict()) for n, m in
                                  items) if d["n"]}

    @staticmethod
    def _gather_json(obj) -> list:
        """Every rank's ``obj``: its JSON bytes zero-padded to the
        all-reduced maximum length (collectives move fixed-size buffers,
        not strings) and all-gathered as uint8, in rank order."""
        import torch

        from ..distributed import collective as coll
        from ..distributed.env import ParallelEnv
        from ..distributed.fleet import metrics as fm

        payload = np.frombuffer(json.dumps(obj).encode(), np.uint8)
        buf = np.zeros(int(fm.max(payload.size)), np.uint8)
        buf[: payload.size] = payload
        gathered: list = []
        coll.all_gather(gathered,
                        torch.from_numpy(buf).to(ParallelEnv().device))
        return [json.loads(bytes(t.cpu().numpy()).rstrip(b"\x00").decode())
                for t in gathered]

    @classmethod
    def _schema_union(cls, snap: Dict[str, dict]) -> List[Tuple[str, str]]:
        """All ranks' (name, type) pairs, unioned and sorted: the one
        deterministic reduction order every rank walks in
        ``aggregate()`` (the local schema in a world of one)."""
        from ..distributed.env import get_world_size

        local = sorted((n, s["type"]) for n, s in snap.items())
        if get_world_size() <= 1:
            return local
        union = set()
        for pairs in cls._gather_json(local):
            union.update(tuple(p) for p in pairs)
        return sorted(union)

    def _gather_sketch(self, name: str) -> Optional[QuantileSketch]:
        """Every rank's sketch of histogram ``name`` merged into one
        (bucket-wise add: exact; the local sketch in a world of one).
        Every rank issues the same collectives even where it lacks the
        metric: an empty sketch is the merge's neutral element. Where no
        rank has a sample, every rank skips the gather alike (None)."""
        from ..distributed.env import get_world_size
        from ..distributed.fleet import metrics as fm

        with self._lock:
            m = self._metrics.get(name)
        local = m.sketch_dict() if isinstance(m, Histogram) \
            else QuantileSketch().to_dict()
        if get_world_size() <= 1:
            return QuantileSketch.from_dict(local) if local["n"] \
                else None
        if not int(fm.max(1 if local["n"] else 0)):
            return None
        merged = QuantileSketch()
        for d in self._gather_json(local):
            merged.merge(QuantileSketch.from_dict(d))
        return merged if merged.count else None

    def aggregate(self) -> Dict[str, dict]:
        """The snapshot reduced across ranks: counters and histogram
        count/sum are summed, gauges and histogram max take the MAX and
        histogram min the MIN (a fleet-wide high-water mark is the max
        over ranks), and histogram quantiles come from the merged rank
        sketches (the quantiles of one sketch that saw the union, within
        the sketch's rel_err). The snapshot itself in a world of one.

        Every reduction is a collective, so ranks issue the same
        sequence: the schema union aligns rank-dependent metric sets and
        its sorted order fixes the pairing; a metric a rank lacks
        contributes the reduction's neutral element."""
        from ..distributed.env import get_world_size
        from ..distributed.fleet import metrics as fm

        snap = self.snapshot()
        if get_world_size() <= 1:
            return snap
        for name, typ in self._schema_union(snap):
            s = snap.get(name)
            if s is None or s["type"] != typ:
                s = snap[name] = (
                    {"type": "histogram", "count": 0}
                    if typ == "histogram" else {"type": typ, "value": None})
            if typ == "counter":
                s["value"] = float(fm.sum(s["value"] or 0.0))
            elif typ == "gauge":
                v = s["value"]
                red = float(fm.max(v if v is not None else -np.inf))
                s["value"] = None if red == -np.inf else red
            elif typ == "histogram":
                have = bool(s.get("count"))
                n = int(fm.sum(s.get("count", 0)))
                tot = float(fm.sum(s.get("sum", 0.0)))
                mn = float(fm.min(s["min"] if have else np.inf))
                mx = float(fm.max(s["max"] if have else -np.inf))
                if n:
                    s.update(count=n, sum=tot, mean=tot / n,
                             min=mn, max=mx)
                merged = self._gather_sketch(name)
                if merged is not None:
                    s.update(p50=merged.percentile(50),
                             p90=merged.percentile(90),
                             p95=merged.percentile(95),
                             p99=merged.percentile(99))
                else:
                    for q in ("p50", "p90", "p95", "p99"):
                        s.pop(q, None)
        return snap


_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _registry
