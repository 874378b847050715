"""Mergeable quantile sketch (a copy of ``paddle_tpu/profiler/sketch.py``,
kept in the port so that it imports nothing of the JAX package; the
histograms of ``profiler.metrics`` use it).

The Histogram reservoir this replaces kept "the most recent 1024
observations" per rank and cross-rank aggregation NaN-pad-allgathered
the raw samples: an approximation whose error was *unstated* (whatever
the window happened to hold) and whose merge cost grew with the sample
count. This module is the DDSketch construction instead (Masson et al.,
VLDB'19 — the datadog sketch serving dashboards actually run on):

- **relative-error buckets**: value ``v > 0`` lands in bucket
  ``ceil(log_gamma(v))`` with ``gamma = (1 + a) / (1 - a)`` for a
  configured relative accuracy ``a`` (default 1%). Reporting a bucket's
  geometric midpoint guarantees ``|est - v| <= a * v`` for EVERY
  quantile — a stated, uniform bound, not a sampling accident.
- **bounded size**: at most ``max_buckets`` buckets per sign; overflow
  collapses the LOWEST buckets together (the DDSketch rule: quantiles
  ABOVE the collapsed floor — the tail an SLO quotes — keep the full
  bound; everything folded below it is degraded and the folded count
  is surfaced as ``collapsed``, never hidden). 2048 buckets at 1%
  span ~ 17 orders of magnitude of value, so on any physical latency
  stream collapse is a pathology flag, not a code path.
- **exact merge**: two sketches with the same ``gamma`` merge by
  bucket-wise ADDITION — associative, commutative, lossless. A mesh's
  p95 computed from merged rank sketches is EXACTLY the p95 the union
  sketch would have produced; there is no cross-rank approximation
  left to state. ``subtract`` gives windowed deltas between two
  cumulative snapshots of the SAME stream the same way.

Count / sum / min / max stay exact (the old Histogram contract).
Percentiles follow the repo's nearest-rank convention over bucket
counts and are clamped into ``[min, max]``, so tiny sketches behave
sanely. Serialization (``to_dict``/``from_dict``) is pure-JSON — the
telemetry frames ride it; keys are stringified ints because JSON
object keys are strings.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

__all__ = ["QuantileSketch", "DEFAULT_REL_ERR"]

#: default relative accuracy: 1% — the documented bound mesh_status
#: quotes and the live-vs-offline agreement tests assert against
DEFAULT_REL_ERR = 0.01


class QuantileSketch:
    """DDSketch-style mergeable quantile sketch. Not thread-safe —
    Histogram wraps every touch in its own lock."""

    __slots__ = ("rel_err", "gamma", "_lg", "max_buckets", "_pos",
                 "_neg", "_zero", "_n", "_sum", "_min", "_max",
                 "collapsed")

    def __init__(self, rel_err: float = DEFAULT_REL_ERR,
                 max_buckets: int = 2048):
        if not 0.0 < rel_err < 1.0:
            raise ValueError("rel_err must be in (0, 1)")
        if max_buckets < 2:
            raise ValueError("max_buckets must be >= 2")
        self.rel_err = float(rel_err)
        self.gamma = (1.0 + rel_err) / (1.0 - rel_err)
        self._lg = math.log(self.gamma)
        self.max_buckets = int(max_buckets)
        self._pos: Dict[int, int] = {}   # bucket index -> count (v>0)
        self._neg: Dict[int, int] = {}   # mirrored buckets for v<0
        self._zero = 0                   # exact-zero count
        self._n = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        #: number of observations folded into a floor bucket by the
        #: bounded-size collapse (0 on every healthy stream)
        self.collapsed = 0

    # -- ingest ------------------------------------------------------------
    def _index(self, v: float) -> int:
        # gamma^(i-1) < v <= gamma^i; the +eps-free ceil form is exact
        # enough: a boundary landing one bucket over still satisfies
        # the relative-error bound by construction
        return int(math.ceil(math.log(v) / self._lg))

    def observe(self, v: float) -> None:
        v = float(v)
        if math.isnan(v):
            return
        self._n += 1
        self._sum += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v
        if v > 0.0:
            i = self._index(v)
            self._pos[i] = self._pos.get(i, 0) + 1
            if len(self._pos) > self.max_buckets:
                self._collapse(self._pos)
        elif v < 0.0:
            i = self._index(-v)
            self._neg[i] = self._neg.get(i, 0) + 1
            if len(self._neg) > self.max_buckets:
                self._collapse(self._neg)
        else:
            self._zero += 1

    def _collapse(self, buckets: Dict[int, int]) -> None:
        """Fold the lowest buckets into one floor bucket until the
        bound holds — tail accuracy (the quoted quantiles) survives;
        the folded count is surfaced in ``collapsed``."""
        keys = sorted(buckets)
        while len(buckets) > self.max_buckets:
            lo = keys.pop(0)
            c = buckets.pop(lo)
            buckets[keys[0]] = buckets.get(keys[0], 0) + c
            self.collapsed += c

    # -- read --------------------------------------------------------------
    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def min(self) -> Optional[float]:
        return None if self._n == 0 else self._min

    @property
    def max(self) -> Optional[float]:
        return None if self._n == 0 else self._max

    def _bucket_value(self, i: int) -> float:
        # geometric midpoint of (gamma^(i-1), gamma^i]: worst-case
        # relative error a = (gamma - 1) / (gamma + 1) = rel_err
        return 2.0 * self.gamma ** i / (self.gamma + 1.0)

    def _ascending(self) -> List[Tuple[float, int]]:
        out = [(-self._bucket_value(i), self._neg[i])
               for i in sorted(self._neg, reverse=True)]
        if self._zero:
            out.append((0.0, self._zero))
        out.extend((self._bucket_value(i), self._pos[i])
                   for i in sorted(self._pos))
        return out

    def percentile(self, q: float) -> Optional[float]:
        """Nearest-rank percentile estimate (the repo convention:
        rank ``min(int(q/100 * n), n - 1)`` over the sorted stream),
        within ``rel_err`` relative error, clamped into [min, max]."""
        if self._n == 0:
            return None
        rank = min(int(q / 100.0 * self._n), self._n - 1)
        seen = 0
        est = self._max
        for v, c in self._ascending():
            seen += c
            if seen > rank:
                est = v
                break
        return min(max(est, self._min), self._max)

    def snapshot(self) -> dict:
        """Histogram-snapshot-shaped summary (the keys sink/prom/bench
        consumers already read)."""
        if self._n == 0:
            return {"type": "histogram", "count": 0}
        return {"type": "histogram", "count": self._n,
                "sum": self._sum, "mean": self._sum / self._n,
                "min": self._min, "max": self._max,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p95": self.percentile(95), "p99": self.percentile(99)}

    # -- merge / window ----------------------------------------------------
    def _check_compatible(self, other: "QuantileSketch") -> None:
        if abs(other.rel_err - self.rel_err) > 1e-12:
            raise ValueError(
                f"cannot combine sketches with rel_err "
                f"{self.rel_err} vs {other.rel_err}")

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into self (bucket-wise add — exact). Returns
        self for chaining."""
        self._check_compatible(other)
        for i, c in other._pos.items():
            self._pos[i] = self._pos.get(i, 0) + c
        for i, c in other._neg.items():
            self._neg[i] = self._neg.get(i, 0) + c
        self._zero += other._zero
        self._n += other._n
        self._sum += other._sum
        self._min = min(self._min, other._min)
        self._max = max(self._max, other._max)
        self.collapsed += other.collapsed
        if len(self._pos) > self.max_buckets:
            self._collapse(self._pos)
        if len(self._neg) > self.max_buckets:
            self._collapse(self._neg)
        return self

    def subtract(self, older: "QuantileSketch") -> "QuantileSketch":
        """Windowed delta between two CUMULATIVE snapshots of the same
        stream (``self`` newer): bucket-wise subtraction, floored at 0
        (a collapse between the snapshots can shift counts across
        buckets — floor, never guess negatives). The window's min/max
        are unknowable from buckets alone, so they are the delta's
        bucket-implied bounds — honest to within ``rel_err``."""
        self._check_compatible(older)
        out = QuantileSketch(self.rel_err, self.max_buckets)
        for i, c in self._pos.items():
            d = c - older._pos.get(i, 0)
            if d > 0:
                out._pos[i] = d
        for i, c in self._neg.items():
            d = c - older._neg.get(i, 0)
            if d > 0:
                out._neg[i] = d
        out._zero = max(0, self._zero - older._zero)
        out._n = (sum(out._pos.values()) + sum(out._neg.values())
                  + out._zero)
        out._sum = self._sum - older._sum
        if out._n:
            lows = [-out._bucket_value(max(out._neg))] if out._neg \
                else ([0.0] if out._zero else
                      [out._bucket_value(min(out._pos))])
            highs = [out._bucket_value(max(out._pos))] if out._pos \
                else ([0.0] if out._zero else
                      [-out._bucket_value(min(out._neg))])
            out._min = min(lows)
            out._max = max(highs)
        return out

    def copy(self) -> "QuantileSketch":
        out = QuantileSketch(self.rel_err, self.max_buckets)
        out.merge(self)
        return out

    # -- serialization (JSON-pure: the telemetry frame payload) ------------
    def to_dict(self) -> dict:
        return {"rel_err": self.rel_err, "n": self._n,
                "sum": self._sum,
                "min": None if self._n == 0 else self._min,
                "max": None if self._n == 0 else self._max,
                "zero": self._zero, "collapsed": self.collapsed,
                "pos": {str(i): c for i, c in self._pos.items()},
                "neg": {str(i): c for i, c in self._neg.items()}}

    @classmethod
    def from_dict(cls, d: dict,
                  max_buckets: int = 2048) -> "QuantileSketch":
        """Inverse of ``to_dict``. Raises (ValueError/KeyError/
        TypeError) on a malformed document — a torn frame must be
        COUNTED by the caller, never guessed into a sketch."""
        out = cls(float(d["rel_err"]), max_buckets)
        out._pos = {int(i): int(c) for i, c in
                    (d.get("pos") or {}).items()}
        out._neg = {int(i): int(c) for i, c in
                    (d.get("neg") or {}).items()}
        out._zero = int(d.get("zero", 0))
        out._n = int(d["n"])
        out._sum = float(d["sum"])
        out.collapsed = int(d.get("collapsed", 0))
        if any(c < 0 for c in out._pos.values()) or \
                any(c < 0 for c in out._neg.values()) or \
                out._zero < 0 or out._n < 0:
            raise ValueError("negative sketch bucket count")
        bucketed = (sum(out._pos.values()) + sum(out._neg.values())
                    + out._zero)
        if bucketed != out._n:
            raise ValueError(
                f"sketch bucket counts {bucketed} != n {out._n}")
        if out._n:
            if d.get("min") is None or d.get("max") is None:
                raise ValueError("non-empty sketch without min/max")
            out._min = float(d["min"])
            out._max = float(d["max"])
        return out
