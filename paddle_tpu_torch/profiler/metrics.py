"""Runtime metrics registry: counters, gauges and histograms (mirrors
``paddle_tpu/profiler/metrics.py``).

The serving engine writes ``serving/ticks``, ``serving/tokens_per_sec``,
``serving/ttft_ms`` and the rest here. Histograms are backed by the
mergeable quantile sketch (``sketch.py``): exact count/sum/min/max and
percentiles within a stated 1% relative error; ``sketch_dicts()`` is the
sink's telemetry-frame payload. Cross-rank aggregation (``aggregate``)
comes with ROADMAP queue 1 item 7a.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

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


_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _registry
