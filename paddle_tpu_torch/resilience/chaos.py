"""Deterministic fault injection for the resilience tests (mirrors
``paddle_tpu/resilience/chaos.py``).

Every fault the runtime claims to survive is injected here on a fixed
schedule keyed by data cursor or step number, never at random, so a run
with a given ``ChaosPlan`` is exactly reproducible: a preempted,
corrupted and restarted run is compared with an uninterrupted run of the
same plan.

Fault classes:
  - NaN gradients: ``nan_cursors``; the runner calls the trainer's
    ``inject_fault_scale(nan)`` for those batches, which poisons the loss
    and every gradient (``guard_bad_steps`` catches it).
  - data-loader exceptions: ``flaky_cursors``; the wrapped data_fn
    raises ``ChaosDataError`` a set number of times a cursor before it
    succeeds (the retry with backoff).
  - step hangs: ``hang_steps``; ``maybe_hang(step)`` sleeps past the
    watchdog's timeout.
  - self-preemption: ``preempt_after_step``; after that step the plan
    sends SIGTERM to its own process (a deterministic stand-in for the
    scheduler's signal).
  - checkpoint corruption: the file surgeons below work on the layout of
    ``distributed/checkpoint.py``, which is the reference's (a truncated
    shard, flipped bytes at the same length, a deleted COMMIT, a deleted
    shard, a kill between the shard's fsync and the commit).
"""
from __future__ import annotations

import os
import signal
import time
from typing import Dict, Iterable, Optional

__all__ = ["ChaosPlan", "ChaosDataError", "truncate_shard",
           "flip_shard_byte", "delete_commit", "delete_shard",
           "simulate_kill_mid_save", "abandon_async_save",
           "newest_committed_step"]


class ChaosDataError(RuntimeError):
    """The injected transient data-loader failure."""


# ---------------------------------------------------------------------------
# checkpoint-directory surgeons (operate on distributed/checkpoint.py layout)
# ---------------------------------------------------------------------------


def _step_dir(ckpt_dir: str, step: Optional[int]) -> str:
    from ..distributed import checkpoint as dck

    if step is None:
        step = newest_committed_step(ckpt_dir)
    return os.path.join(ckpt_dir, dck._STEP_FMT.format(step))


def newest_committed_step(ckpt_dir: str) -> int:
    from ..distributed import checkpoint as dck

    step = dck.latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    return step


def _shard_path(ckpt_dir: str, step: Optional[int], proc: int) -> str:
    return os.path.join(_step_dir(ckpt_dir, step), f"shard_p{proc}.bin")


def truncate_shard(ckpt_dir: str, step: Optional[int] = None,
                   keep_bytes: int = 16, proc: int = 0) -> str:
    """Cut a shard file short (a crash mid-write after COMMIT was
    already durable on another host, or a filesystem losing a tail)."""
    p = _shard_path(ckpt_dir, step, proc)
    with open(p, "r+b") as f:
        f.truncate(keep_bytes)
    return p


def flip_shard_byte(ckpt_dir: str, step: Optional[int] = None,
                    offset: int = 10, proc: int = 0) -> str:
    """Silent bit rot: XOR one byte, length unchanged — only a CRC
    verify can see this."""
    p = _shard_path(ckpt_dir, step, proc)
    with open(p, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))
    return p


def delete_commit(ckpt_dir: str, step: Optional[int] = None) -> str:
    """Remove the COMMIT marker: the step must stop counting as
    committed (latest_step walks past it)."""
    d = _step_dir(ckpt_dir, step)
    p = os.path.join(d, "COMMIT")
    os.unlink(p)
    return d


def delete_shard(ckpt_dir: str, step: Optional[int] = None,
                 proc: int = 0) -> str:
    """Lose a whole shard file (dead disk / evicted cache object)."""
    p = _shard_path(ckpt_dir, step, proc)
    os.unlink(p)
    return p


def simulate_kill_mid_save(ckpt_dir: str, step: int) -> str:
    """Shard bytes present, COMMIT absent — the exact on-disk state a
    SIGKILL between fsync and commit leaves behind."""
    from ..distributed import checkpoint as dck

    d = os.path.join(ckpt_dir, dck._STEP_FMT.format(step))
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "shard_p0.bin"), "wb") as f:
        f.write(b"\x00" * 64)
    # no manifest, no COMMIT
    return d


def abandon_async_save(handle) -> str:
    """Kill-mid-snapshot for a REAL streamed save (checkpoint.save
    snapshot_async): join the writer thread — the most adversarial
    surviving state, every shard byte + manifest durable on disk — but
    never run ``wait()``, so COMMIT is never written. Deterministic
    stand-in for a SIGKILL landing between the last fsync and the
    commit marker; ``latest_step`` must keep resolving to the previous
    committed step. Returns the uncommitted step directory."""
    handle._thread.join()
    return handle.directory


# ---------------------------------------------------------------------------
# the in-loop plan
# ---------------------------------------------------------------------------


class ChaosPlan:
    """Deterministic fault schedule consumed by the resilient runner.

    nan_cursors:        data cursors whose batch poisons the gradients.
    flaky_cursors:      {cursor: n_failures} — data_fn raises
                        ChaosDataError that many times for the cursor
                        before succeeding.
    hang_steps:         {step: seconds} — sleep after the step's batch
                        is fetched (watchdog bait).
    preempt_after_step: send SIGTERM to this process after the step
                        completes (None: never).
    """

    def __init__(self,
                 nan_cursors: Iterable[int] = (),
                 flaky_cursors: Optional[Dict[int, int]] = None,
                 hang_steps: Optional[Dict[int, float]] = None,
                 preempt_after_step: Optional[int] = None):
        self.nan_cursors = frozenset(int(c) for c in nan_cursors)
        self.flaky_cursors = dict(flaky_cursors or {})
        self.hang_steps = {int(k): float(v)
                           for k, v in (hang_steps or {}).items()}
        self.preempt_after_step = preempt_after_step
        self._remaining_failures = dict(self.flaky_cursors)

    # -- hooks the runner calls -------------------------------------------
    def poisons(self, cursor: int) -> bool:
        return cursor in self.nan_cursors

    def wrap_data_fn(self, data_fn):
        """data_fn(cursor) that raises ChaosDataError the configured
        number of times per flaky cursor, then delegates."""
        def chaotic(cursor):
            left = self._remaining_failures.get(cursor, 0)
            if left > 0:
                self._remaining_failures[cursor] = left - 1
                raise ChaosDataError(
                    f"injected data-loader failure for cursor {cursor} "
                    f"({left - 1} more to come)")
            return data_fn(cursor)

        return chaotic

    def maybe_hang(self, step: int) -> None:
        s = self.hang_steps.get(step)
        if s:
            time.sleep(s)

    def maybe_preempt(self, step: int) -> None:
        if self.preempt_after_step is not None \
                and step == self.preempt_after_step:
            os.kill(os.getpid(), signal.SIGTERM)
