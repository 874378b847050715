"""Chunk-selection scheduler policies (mirrors
``paddle_tpu/serving/sched.py``).

``ChunkScheduler`` picks which pending slot opens the next prefill chunk
of a tick and how many chunks the tick selects:

* ``"fifo"``  — oldest admission first, constant budget (the default);
* ``"sjf"``   — shortest remaining prefill first;
* ``"aged-sjf"`` — SJF with deadline aging: effective priority
  ``max(remaining - age_rate * waited_ticks, 0)`` with FIFO tie-break,
  which bounds every request's wait (``starvation_bound_ticks``).

Non-fifo policies also shape the per-tick prefill budget within
``[1, prefill_chunks_per_tick]`` from decode-stall telemetry.
``SpecKController`` turns each slot's speculative accept rate into its
draft depth. Host-side only: nothing here touches the device.

Not in this slice: the mesh routing keys.
"""
from __future__ import annotations

from collections import deque
from typing import Optional, Sequence, Tuple

import numpy as np

from ..profiler.metrics import percentile
from ..profiler.metrics import registry as _registry

__all__ = ["SCHED_POLICIES", "ChunkScheduler", "SpecKController"]

SCHED_POLICIES = ("fifo", "sjf", "aged-sjf")


class ChunkScheduler:
    """Host-side chunk-selection + prefill-budget policy. Per scheduler
    step the engine calls :meth:`on_tick` once, :meth:`chunk_budget` once
    and :meth:`pick` once per selected chunk, plus :meth:`note_admit` /
    :meth:`note_open` / :meth:`note_release` / :meth:`note_finish` at the
    matching lifecycle edges."""

    def __init__(self, policy: str, num_slots: int,
                 slot_capacity: int, prefill_chunk: int,
                 chunks_per_tick: int, *,
                 age_rate_tokens: Optional[int] = None,
                 stats_every: int = 16):
        if policy not in SCHED_POLICIES:
            raise ValueError(
                f"unknown scheduler policy {policy!r}; expected one of "
                f"{SCHED_POLICIES}")
        self.policy = policy
        self.num_slots = int(num_slots)
        self.slot_capacity = int(slot_capacity)
        self.prefill_chunk = int(prefill_chunk)
        self.chunks_per_tick = int(chunks_per_tick)
        #: priority decay per waited tick, in remaining-prefill tokens
        self.age_rate = int(age_rate_tokens
                            or max(1, prefill_chunk // 4))
        #: fifo keeps the constant budget
        self.shape_budget = policy != "fifo"
        self._tick = 0
        self._anchor = np.zeros(self.num_slots, np.int64)
        self.max_wait_ticks_seen = 0
        self._first_open_pending = [False] * self.num_slots
        self._stats_every = max(1, int(stats_every))
        self._ttft_window: deque = deque(maxlen=64)
        self._tpot_window: deque = deque(maxlen=64)
        self._ttft_p95 = 0.0
        self._tpot_p95 = 0.0
        self._ttft_ref = 0.0
        self._tpot_ref = 0.0

    # -- lifecycle bookkeeping ---------------------------------------------
    def on_tick(self) -> None:
        self._tick += 1
        if self.shape_budget and self._tick % self._stats_every == 0:
            self._refresh_stats()

    def note_admit(self, slot: int) -> None:
        self._anchor[slot] = self._tick
        self._first_open_pending[slot] = True

    def note_open(self, slot: int) -> None:
        waited = int(self._tick - self._anchor[slot])
        if self._first_open_pending[slot]:
            self._first_open_pending[slot] = False
            self.max_wait_ticks_seen = max(self.max_wait_ticks_seen,
                                           waited)
        self._anchor[slot] = self._tick

    def note_release(self, slot: int) -> None:
        self._first_open_pending[slot] = False

    def note_finish(self, ttft_ms: Optional[float],
                    tpot_ms: Optional[float]) -> None:
        if ttft_ms is not None:
            self._ttft_window.append(float(ttft_ms))
        if tpot_ms is not None:
            self._tpot_window.append(float(tpot_ms))

    # -- chunk selection ----------------------------------------------------
    def pick(self, cands: Sequence[Tuple[int, int, int]]) -> Optional[int]:
        """Next slot to open a prefill chunk from ``cands = [(slot,
        admit_seq, remaining_prefill_tokens), ...]``; None when empty."""
        if not cands:
            return None
        if self.policy == "fifo":
            return min(cands, key=lambda c: c[1])[0]
        if self.policy == "sjf":
            return min(cands, key=lambda c: (c[2], c[1]))[0]

        def key(c):
            slot, seq, rem = c
            waited = self._tick - int(self._anchor[slot])
            return (max(rem - self.age_rate * waited, 0), seq)

        best = min(cands, key=key)
        if best[2] > min(c[2] for c in cands):
            _registry().counter("serving/aged_promotions").add(1)
        return best[0]

    def starvation_bound_ticks(self) -> int:
        """Upper bound on admission -> first chunk open under aged-sjf:
        ``ceil(cap / age_rate) + (num_slots - 1) * ceil(cap / chunk) + 1``."""
        cap = self.slot_capacity
        to_floor = -(-cap // self.age_rate)
        chunks_per_slot = -(-cap // self.prefill_chunk)
        return to_floor + (self.num_slots - 1) * chunks_per_slot + 1

    # -- budget shaping -----------------------------------------------------
    def _refresh_stats(self) -> None:
        self._ttft_p95 = float(percentile(
            sorted(self._ttft_window), 95)) if self._ttft_window else 0.0
        self._tpot_p95 = float(percentile(
            sorted(self._tpot_window), 95)) if self._tpot_window else 0.0
        for cur, ref in (("_ttft_p95", "_ttft_ref"),
                         ("_tpot_p95", "_tpot_ref")):
            c = getattr(self, cur)
            if c > 0.0:
                r = getattr(self, ref)
                setattr(self, ref, c if r == 0.0 else 0.75 * r + 0.25 * c)

    def chunk_budget(self, pending_prefill: int, resident_decodes: int,
                     queue_depth: int) -> int:
        """Per-tick prefill budget in ``[1, chunks_per_tick]``: halved
        under decode-stall pressure (floor 1 when TPOT p95 rose 1.5x over
        its baseline), restored to the full budget by a queue backlog or
        a TTFT p95 1.5x over its baseline. FIFO keeps the constant."""
        npf = self.chunks_per_tick
        if not self.shape_budget or pending_prefill <= 0 or npf <= 1:
            return npf
        budget = npf
        if queue_depth == 0 and 2 * resident_decodes >= self.num_slots:
            budget = max(1, npf // 2)
            if self._tpot_ref > 0.0 and \
                    self._tpot_p95 >= 1.5 * self._tpot_ref:
                budget = 1
        if queue_depth > 0 or (
                self._ttft_ref > 0.0
                and self._ttft_p95 >= 1.5 * self._ttft_ref):
            budget = npf
        return budget


class SpecKController:
    """Adaptive per-slot speculation depth (``SpecConfig.adaptive``).

    A per-slot accept-rate EWMA ``a_s`` (tokens accepted / tokens drafted
    per verify tick, alpha ``ewma_alpha``) maps to the draft depth
    ``floor(a_s * k + 0.5)`` clamped to ``[0, k]``. New tenants start at
    ``a_s = 1`` (full depth): an un-speculated slot produces no evidence,
    so the draft earns its demotion, not its promotion.

    Re-probing: a slot at depth 0 rides as a plain decode row and stops
    producing observations, so every ``reprobe_every``-th
    :meth:`tick_depth` call at depth 0 drafts at depth 1. The probe flag
    latches until the probe's observation lands (catch-up feeding can take
    ticks). Each consecutive rejected probe doubles the slot's period, up
    to ``8 * reprobe_every``; any observation with ``accepted > 0``
    restores the base period. ``reprobe_every=0`` disables probing.
    :meth:`depth` is pure; only ``tick_depth`` advances probe state, so the
    engine calls it once per slot per tick. Admission, preemption and
    finish :meth:`reset` the slot.
    """

    def __init__(self, num_slots: int, k: int,
                 ewma_alpha: float = 0.5, reprobe_every: int = 0):
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if reprobe_every < 0:
            raise ValueError("reprobe_every must be >= 0")
        self.k = int(k)
        self.alpha = float(ewma_alpha)
        self.reprobe_every = int(reprobe_every)
        self._ewma = np.ones(int(num_slots), np.float64)
        self._zero_ticks = np.zeros(int(num_slots), np.int64)
        self._probing = np.zeros(int(num_slots), bool)
        self._period = np.full(int(num_slots), int(reprobe_every),
                               np.int64)

    def reset(self, slot: int) -> None:
        self._ewma[slot] = 1.0
        self._zero_ticks[slot] = 0
        self._probing[slot] = False
        self._period[slot] = self.reprobe_every

    def depth(self, slot: int) -> int:
        """The slot's depth, without probe side effects."""
        return int(min(self.k, int(self._ewma[slot] * self.k + 0.5)))

    def tick_depth(self, slot: int) -> int:
        """The slot's depth for this tick, advancing re-probe state: counts
        consecutive depth-0 ticks and returns 1 (the probe) every
        period-th one. Call once per slot per scheduler tick."""
        d = self.depth(slot)
        if d > 0 or self.reprobe_every == 0:
            self._zero_ticks[slot] = 0
            return d
        if self._probing[slot]:
            return 1                # probe still awaiting evidence
        self._zero_ticks[slot] += 1
        if self._zero_ticks[slot] >= self._period[slot]:
            self._zero_ticks[slot] = 0
            self._probing[slot] = True
            return 1
        return 0

    def observe(self, slot: int, accepted: int, drafted: int) -> None:
        if drafted <= 0:
            return
        if self._probing[slot]:
            # multiplicative backoff on a rejected probe; base cadence
            # restored the moment any draft token lands
            if accepted > 0:
                self._period[slot] = self.reprobe_every
            else:
                self._period[slot] = min(self._period[slot] * 2,
                                         self.reprobe_every * 8)
        elif accepted > 0:
            self._period[slot] = self.reprobe_every
        self._probing[slot] = False     # the probe's evidence landed
        rate = min(max(accepted / drafted, 0.0), 1.0)
        self._ewma[slot] += self.alpha * (rate - self._ewma[slot])

    def probe_period(self, slot: int) -> int:
        """Current re-probe period of ``slot``."""
        return int(self._period[slot])

    def ewma(self, slot: int) -> float:
        return float(self._ewma[slot])

    def probing(self, slot: int) -> bool:
        return bool(self._probing[slot])
