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
``[1, prefill_chunks_per_tick]`` from decode-stall telemetry. Host-side
only: nothing here touches the device.

Not in this slice: the adaptive speculation depth controller and the
mesh routing keys.
"""
from __future__ import annotations

from collections import deque
from typing import Optional, Sequence, Tuple

import numpy as np

from ..profiler.metrics import percentile
from ..profiler.metrics import registry as _registry

__all__ = ["SCHED_POLICIES", "ChunkScheduler"]

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
