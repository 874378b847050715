"""Elastic training: periodic async checkpoints and resume from the
newest committed step, with an asynchronous step loop (mirrors
``paddle_tpu/distributed/elastic.py:68-268``).

- every ``save_interval`` steps the trainer's sharded ``device_state``
  goes through the async checkpoint (``distributed/checkpoint.py``);
- the checkpoint's meta holds the step, the port's random state
  (``core.rng.get_rng_state``) and the real data cursor (which may run
  ahead of the step after a rollback skipped batches), so a killed and
  restarted run continues the same loss curve;
- ``run`` resumes from the newest COMMITTED step (a kill mid-save lands
  on the one before); with ``degraded_restore`` (default) a corrupt
  newest step walks back to an older one
  (``checkpoint.restore_degraded``).

The async step loop:

1. **deferred loss sync** (``async_dispatch``): the loop keeps a window
   of at most ``max_inflight`` losses not read back and reads them at
   ``sync_interval`` boundaries, window overflow, save points and the
   end. The steps run what a synchronous loop runs; only when the host
   reads the scalar changes.
2. **input prefetch** (``prefetch_depth``): ``prefetch.BatchPrefetcher``
   runs ``data_fn(cursor)`` and the trainer's ``_stage_batch`` for the
   next cursors while the current step runs.
3. **streamed snapshots** (``snapshot_async``): a save copies the state
   off the card in chunks on the writer thread; the loop passes the
   ``wait_snapshot`` gate before the next step (the trainers update
   their state in place), so the copies overlap the data fetch, the
   staging and the loss reads.

Usage::

    tr = HybridPipelineTrainer(model, opt, strategy, mesh)
    el = ElasticTrainer(tr, ckpt_dir, save_interval=100)
    el.run(data_fn, total_steps)   # data_fn(cursor) -> batch tuple
"""
from __future__ import annotations

from typing import Optional

from ..core import rng as rng_mod
from ..profiler import is_enabled as _prof_enabled
from ..profiler import registry as _registry
from ..profiler import trace as _ptrace
from .checkpoint import CheckpointManager, all_steps, load_meta

__all__ = ["ElasticTrainer"]


class ElasticTrainer:
    def __init__(self, trainer, ckpt_dir: str, save_interval: int = 100,
                 keep: int = 2, degraded_restore: bool = True,
                 verify_restore: bool = False,
                 async_dispatch: bool = False, sync_interval: int = 8,
                 max_inflight: int = 2, prefetch_depth: int = 0,
                 snapshot_async: bool = False,
                 snapshot_chunk_bytes: Optional[int] = None):
        self.trainer = trainer
        self.save_interval = save_interval
        ckpt_kw = {}
        if snapshot_chunk_bytes is not None:
            ckpt_kw["snapshot_chunk_bytes"] = int(snapshot_chunk_bytes)
        self.manager = CheckpointManager(ckpt_dir, keep=keep,
                                         snapshot_async=snapshot_async,
                                         **ckpt_kw)
        self.async_dispatch = bool(async_dispatch)
        self.sync_interval = max(1, int(sync_interval))
        self.max_inflight = max(1, int(max_inflight))
        self.prefetch_depth = max(0, int(prefetch_depth))
        # degraded_restore: resume() walks back past unreadable newest
        # steps instead of raising. verify_restore: crc-check the shard
        # files on restore (the walk-back sees silent bit flips only
        # then)
        self.degraded_restore = degraded_restore
        self.verify_restore = verify_restore
        # the data cursor is state of its own, not an alias of step: a
        # rollback re-seeds it past a poisoned batch. data_fn(cursor)
        # -> batch.
        self.data_cursor = 0
        # meta of the checkpoint the last resume() restored
        self.last_meta: dict = {}
        # host reads of device losses this trainer made
        self.loss_syncs = 0

    # -- state capture -----------------------------------------------------
    def _meta(self, step: int, extra=None) -> dict:
        meta = {"step": int(step),
                "rng_state": rng_mod.get_rng_state(),
                "data_cursor": int(self.data_cursor)}
        if extra:
            meta.update(extra)
        return meta

    def _restore_rng(self, meta: dict) -> None:
        if "rng_state" in meta:
            rng_mod.set_rng_state(meta["rng_state"])

    # -- resume ------------------------------------------------------------
    def resume(self, max_step: Optional[int] = None) -> int:
        """Restore the newest readable committed checkpoint; returns the
        step to continue FROM (0 if none). Restores the trainer state,
        the random state, and the data cursor. ``max_step`` caps the
        restore target (the newest committed step ``<= max_step``), so
        that every rank can land on the same step."""
        template = self.trainer.device_state()
        if self.degraded_restore:
            state, meta, step = self.manager.restore_degraded(
                template, verify=self.verify_restore, max_step=max_step)
            if step is None:
                return 0
        else:
            step = self.manager.latest_step()
            if max_step is not None:
                eligible = [s for s in all_steps(self.manager.directory)
                            if s <= max_step]
                step = eligible[-1] if eligible else None
            if step is None:
                return 0
            state = self.manager.restore(template, step=step,
                                         verify=self.verify_restore)
            meta = load_meta(self.manager.directory, step)
        self.trainer.load_device_state(state, step=step)
        self.last_meta = dict(meta or {})
        if meta:
            self._restore_rng(meta)
            # pre-cursor checkpoints carried only step; cursor == step
            # was exact for them (no rollback machinery existed)
            self.data_cursor = int(meta.get("data_cursor", step))
        else:
            self.data_cursor = int(step)
        return int(step)

    # -- checkpointing -----------------------------------------------------
    def save(self, step: int, extra=None, async_: bool = True):
        return self.manager.save(step, self.trainer.device_state(),
                                 meta=self._meta(step, extra),
                                 async_=async_)

    # -- async step pipeline helpers ---------------------------------------
    def _sync_loss(self, dev) -> float:
        """Materialize one device loss (the ONLY host←device sync of the
        loop). The ``hybrid/sync_wait`` span measures how long the host
        actually waited — with async dispatch most of the execution
        already happened underneath the later dispatches, so this span
        shrinking (vs the synchronous per-step wait) IS the win."""
        with _ptrace.scope("hybrid/sync_wait"):
            v = float(dev)
        self.loss_syncs += 1
        if _prof_enabled():
            _registry().counter("elastic/loss_syncs").add(1)
        return v

    def _stage_for_prefetch(self, batch: tuple) -> tuple:
        """The prefetcher's staging hook: the trainer's ``_stage_batch``
        (so ``step`` finds the batch on the device), or the batch as it
        is for a trainer without one."""
        stage = getattr(self.trainer, "_stage_batch", None)
        return batch if stage is None else stage(batch)

    # -- the loop ----------------------------------------------------------
    def run(self, data_fn, total_steps: int, on_step=None) -> list:
        """data_fn(cursor) -> batch tuple (the deterministic data
        cursor: batch content is a pure function of the cursor, which
        equals the global step until a rollback skips batches). Returns
        the per-step losses of THIS process lifetime.

        With ``async_dispatch`` the losses (and ``on_step`` calls) are
        materialized at sync points — window overflow (``max_inflight``),
        ``sync_interval`` boundaries, save points, run end — in step
        order; the values are bitwise-identical to synchronous mode.

        The snapshot gate comes last before each step: the data fetch
        and the staging above it overlap an in-flight save's copies."""
        start = self.resume()
        losses: list = []
        pending: list = []               # (step, device loss future)

        def drain(keep: int = 0) -> None:
            while len(pending) > keep:
                s, dev = pending.pop(0)
                v = self._sync_loss(dev)
                losses.append(v)
                if on_step is not None:
                    on_step(s, v)

        # async dispatch also stops a profiled trainer step from waiting
        # for its own loss (the drain records hybrid/sync_wait instead);
        # restored on exit
        prev_profiled_sync = getattr(self.trainer, "profiled_step_sync",
                                     True)
        self.trainer.profiled_step_sync = not self.async_dispatch
        prefetcher = None
        if self.prefetch_depth > 0:
            from .prefetch import BatchPrefetcher

            prefetcher = BatchPrefetcher(
                data_fn, stage=self._stage_for_prefetch,
                depth=self.prefetch_depth).start(self.data_cursor)
        try:
            for step in range(start, total_steps):
                if prefetcher is not None:
                    batch = prefetcher.get(self.data_cursor)
                else:
                    batch = data_fn(self.data_cursor)
                    if not isinstance(batch, tuple):
                        batch = (batch,)
                # the streamed-snapshot gate last before the step (which
                # updates in place the state a save may still be copying)
                self.manager.wait_snapshot()
                loss = self.trainer.step(*batch)
                self.data_cursor += 1
                pending.append((step, loss))
                done = step + 1
                if not self.async_dispatch:
                    drain()
                elif done % self.sync_interval == 0:
                    drain()
                else:
                    drain(keep=self.max_inflight)
                if done % self.save_interval == 0 or done == total_steps:
                    drain()          # losses land before their save
                    self.save(done)
        finally:
            self.trainer.profiled_step_sync = prev_profiled_sync
            if prefetcher is not None:
                prefetcher.stop()
        drain()
        self.manager.wait()
        return losses
