"""Cursor-accurate background input prefetch for the training loop
(mirrors ``paddle_tpu/distributed/prefetch.py``).

- **cursor accuracy**: the loop consumes batches by data cursor (a
  rollback re-seeds the cursor past poisoned batches, so "next item" is
  not "cursor + 1"). ``get(cursor)`` hands back the staged batch for
  exactly that cursor; a mismatch discards every in-flight batch
  (counted in ``discarded``) and restarts the producer at the requested
  cursor.
- **blocklist**: ``skip_fn(cursor)`` is asked before a cursor is fetched
  or staged, so a poisoned batch is never read again.
- **H2D overlap**: the producer thread runs ``fetch(cursor)`` and the
  optional ``stage`` hook (the trainer's ``_stage_batch``: pinned host
  memory, a side stream the thread waits for, ``record_stream`` for the
  compute stream), so the next batch's host-to-device copy overlaps the
  current step.

The ``elastic/prefetch_depth`` gauge records how many staged batches were
ready at each consume (while the profiler is on).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Optional

__all__ = ["BatchPrefetcher"]


class BatchPrefetcher:
    """Double-buffered, rollback-aware input prefetcher.

    fetch(cursor) -> batch (tuple, or a single array — normalized to a
        tuple); called on the producer thread.
    stage(batch_tuple) -> staged tuple (e.g. the trainer's
        ``_stage_batch``); optional, also on the producer thread.
    depth: max batches staged ahead (the bounded in-flight window).
    skip_fn(cursor) -> bool: blocklist — skipped before fetch/stage.
    """

    def __init__(self, fetch: Callable, stage: Optional[Callable] = None,
                 depth: int = 2, skip_fn: Optional[Callable] = None):
        self._fetch = fetch
        self._stage = stage
        self.depth = max(1, int(depth))
        self._skip_fn = skip_fn
        self._cond = threading.Condition()
        self._queue: deque = deque()     # (cursor, staged_batch | exc)
        self._gen = 0                    # bumped by invalidate()
        self._next_cursor = 0
        self._inflight: Optional[int] = None
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        # observability (tests + post-mortems): how many in-flight
        # batches invalidations have discarded over this lifetime
        self.discarded = 0

    # -- lifecycle ---------------------------------------------------------
    def start(self, cursor: int) -> "BatchPrefetcher":
        with self._cond:
            self._next_cursor = int(cursor)
        self._thread = threading.Thread(
            target=self._run, name="batch-prefetch", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- producer ----------------------------------------------------------
    def _skip(self, cursor: int) -> int:
        while self._skip_fn is not None and self._skip_fn(cursor):
            cursor += 1
        return cursor

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._stopped and len(self._queue) >= self.depth:
                    self._cond.wait()
                if self._stopped:
                    return
                gen = self._gen
                cursor = self._skip(self._next_cursor)
                self._next_cursor = cursor + 1
                self._inflight = cursor
            try:
                batch = self._fetch(cursor)
                if not isinstance(batch, tuple):
                    batch = (batch,)
                item = self._stage(batch) if self._stage is not None \
                    else batch
            except BaseException as e:   # surfaced by get(), never lost
                item = e
            with self._cond:
                self._inflight = None
                # an invalidation raced this fetch: the batch belongs to
                # a discarded timeline — drop it, never hand it out
                if gen == self._gen and not self._stopped:
                    self._queue.append((cursor, item))
                else:
                    self.discarded += 1
                self._cond.notify_all()

    # -- consumer ----------------------------------------------------------
    def _invalidate_locked(self, cursor: int) -> None:
        self.discarded += len(self._queue)
        self._queue.clear()
        self._gen += 1
        self._next_cursor = int(cursor)
        self._cond.notify_all()

    def invalidate(self, cursor: int) -> None:
        """Rollback: discard every in-flight prefetched batch and
        restart the producer at ``cursor`` (the re-seeded data cursor).
        Batches already being fetched are dropped on arrival."""
        with self._cond:
            self._invalidate_locked(cursor)

    def get(self, cursor: int):
        """The staged batch for exactly ``cursor`` (blocks). A head
        mismatch (the cursor moved underneath us) invalidates the
        in-flight window and refetches."""
        from ..profiler import is_enabled as _prof_enabled
        from ..profiler import registry as _registry

        with self._cond:
            while True:
                if self._stopped:
                    raise RuntimeError("BatchPrefetcher is stopped")
                if self._queue:
                    head_cursor, item = self._queue[0]
                    if head_cursor != cursor:
                        self._invalidate_locked(cursor)
                        continue
                    if _prof_enabled():
                        _registry().gauge("elastic/prefetch_depth").set(
                            len(self._queue))
                    self._queue.popleft()
                    self._cond.notify_all()
                    if isinstance(item, BaseException):
                        raise item
                    return item
                # queue empty: is the producer even heading for cursor?
                heading = (self._inflight == cursor
                           or self._next_cursor == cursor)
                if not heading:
                    self._invalidate_locked(cursor)
                self._cond.wait()
