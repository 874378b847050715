"""The hardened training loop: the bad-step guard and rollback,
graceful preemption, the step watchdog, the degraded restore and retried
data loading (mirrors ``paddle_tpu/resilience/runner.py``).

``ResilientRunner`` wraps a ``HybridPipelineTrainer`` (or anything with
its ``step``/``device_state``/``load_device_state`` surface) behind an
``ElasticTrainer`` and runs this loop:

  1. **bad-step guard**: the trainer's finite check
     (``guard_bad_steps``) skips the update of a NaN/Inf step; the
     runner counts consecutive bad steps and after ``bad_step_limit`` of
     them ROLLS BACK to the newest readable committed checkpoint and
     re-seeds the data cursor past the offending batches (they go into a
     skip set saved in every checkpoint's meta, so neither the replay
     nor a later restart feeds them again).
  2. **graceful preemption**: SIGTERM/SIGINT set a flag; the step in
     flight finishes, a synchronous committed checkpoint lands, and
     ``run`` returns a RunResult with the resumable exit code.
  3. **step watchdog**: a monitor thread that dumps the live stacks and
     the profiler's span state on a hung step and, with abort, ends the
     process so that the elastic restart takes over
     (``resilience/watchdog.py``).
  4. **degraded restore**: the resume walks back past corrupt newest
     steps (``checkpoint.restore_degraded``) instead of dying.
  5. data loading rides ``utils.retry`` with exponential backoff.

Every recovery moves a profiler counter: ``resilience/steps_skipped``,
``resilience/rollbacks``, ``resilience/restore_fallbacks``,
``resilience/preemptions``, ``resilience/data_retries``,
``resilience/watchdog_fires`` (and, with a consensus,
``resilience/mesh_agreements``, ``mesh_rollbacks``, ``mesh_aborts``).

Determinism: with a fixed ``ChaosPlan``, a run that is preempted,
corrupted and restarted gives the same per-step losses as an
uninterrupted run (bitwise on the CPU; on the card within the spread of
two uninterrupted runs where the card's atomics reorder a sum).

Agreement across ranks: with ``ResilienceConfig(consensus=...)`` (a
``distributed.consensus.Consensus`` over the job's shared board) the
K-streak verdict is agreed by the mesh. The rank that completes a streak
opens a ``resil`` vote (verdict ``rollback``, or ``abort`` when it has
nothing to restore and no guard); the other ranks see the open round at
their next step boundary (one directory poll a step), drain their
window, and join with verdict ``healthy`` and their own partial streak.
The decision carries the UNION of every rank's poisoned cursors, so all
ranks re-seed alike and the data timelines stay in lockstep; an agreed
abort raises on every rank. Each vote carries the rank's newest commit
at or before its own streak's start, the reducer publishes the min, and
every rank resumes capped at it (``ElasticTrainer.resume(max_step=)``):
a rank that committed after the proposer's streak began walks back with
the mesh. Leases ride a heartbeat thread for the length of ``run`` (a
cold first step must not read as a dead rank).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

from ..distributed.elastic import ElasticTrainer
from ..profiler.metrics import registry as _registry
from ..utils.retry import retry
from .preemption import PREEMPT_EXIT_CODE, PreemptionHandler
from .watchdog import StepWatchdog

__all__ = ["ResilienceConfig", "ResilientRunner", "RunResult"]


def _resilience_reducer(votes):
    """The ``resil`` vote's deterministic reduce: the mesh verdict is
    the most severe any rank reported (abort > rollback > healthy), the
    poisoned-cursor set is the union — every rank must blocklist every
    rank's bad batches or the data timelines diverge — and the restore
    ``target`` is the MIN over the ranks' ``restorable`` steps (each
    rank's newest commit at or before its own bad-streak start; -1 when
    it has none). The min is the newest step safe for EVERY rank:
    without it, a rank that committed a checkpoint after the proposer's
    streak began would resume from younger state than the proposer and
    the mesh would leave state-lockstep. ``v.get`` keeps rounds with
    older peers (votes without the field) decidable."""
    verdicts = [v["verdict"] for v in votes.values()]
    verdict = "abort" if "abort" in verdicts else (
        "rollback" if "rollback" in verdicts else "healthy")
    cursors = sorted({int(c) for v in votes.values()
                      for c in v["bad_cursors"]})
    rest = [int(v.get("restorable", -1)) for v in votes.values()]
    rest = [r for r in rest if r >= 0]
    return {"verdict": verdict, "bad_cursors": cursors,
            "target": min(rest) if rest else -1}


class ResilienceConfig:
    """Knobs of the hardened loop (README's resilience section).

    bad_step_limit:         consecutive guarded-bad steps before a
                            rollback (K).
    watchdog_timeout_s:     None disables the watchdog.
    watchdog_first_grace_s: extra allowance for a lifetime's first step
                            (kernel builds, cold caches); default
                            10× the timeout.
    watchdog_jitter:        deadline jitter fraction (so that ranks
                            do not all fire at once).
    watchdog_abort:         hard-exit on fire (WATCHDOG_EXIT_CODE).
    data_retry_attempts /   retry-with-exponential-backoff policy for
    data_retry_base_delay:  data_fn calls (utils.retry).
    verify_restore:         CRC-verify shards on resume (the walk-back
                            can only SEE silent corruption when on).
    raise_on_preempt:       raise PreemptedError after the preemption
                            checkpoint commits, instead of returning a
                            RunResult with preempted=True (default).
    consensus:              a distributed.consensus.Consensus over the
                            job's shared board — K-streak rollback and
                            abort become mesh-wide agreements (module
                            docstring). None (default) keeps the
                            host-local single-process behavior.

    The async step window (``distributed/elastic.py``'s docstring):

    async_dispatch:         defer loss AND guard-verdict syncs behind a
                            bounded in-flight window so dispatch of
                            step N+1 overlaps execution of step N. The
                            window only opens once a COMMITTED
                            checkpoint exists: a K-streak rollback with
                            younger in-flight steps restores that
                            checkpoint (state, RNG, cursor), which is
                            what keeps deferred-mode loss curves
                            bitwise-identical to synchronous mode.
    sync_interval:          materialize the window at least this often.
    max_inflight:           window size (default 2 steps).
    prefetch_depth:         background input prefetch (+H2D staging)
                            depth; 0 disables. Rollback invalidates
                            every in-flight prefetched batch; the
                            persisted skipped_cursors blocklist is
                            honored before staging.
    snapshot_async /        streamed checkpoint snapshots: D2H in
    snapshot_chunk_bytes:   bounded chunks on the writer thread, gated
                            before the next dispatch (checkpoint.save).
    """

    def __init__(self,
                 bad_step_limit: int = 3,
                 watchdog_timeout_s: Optional[float] = None,
                 watchdog_first_grace_s: Optional[float] = None,
                 watchdog_jitter: float = 0.1,
                 watchdog_abort: bool = False,
                 watchdog_dump_file: Optional[str] = None,
                 watchdog_seed: int = 0,
                 data_retry_attempts: int = 4,
                 data_retry_base_delay: float = 0.05,
                 data_retry_max_delay: float = 5.0,
                 data_retry_jitter: float = 0.0,
                 verify_restore: bool = True,
                 raise_on_preempt: bool = False,
                 async_dispatch: bool = False,
                 sync_interval: int = 8,
                 max_inflight: int = 2,
                 prefetch_depth: int = 0,
                 snapshot_async: bool = False,
                 snapshot_chunk_bytes: Optional[int] = None,
                 consensus=None):
        if bad_step_limit < 1:
            raise ValueError("bad_step_limit must be >= 1")
        self.consensus = consensus
        self.bad_step_limit = int(bad_step_limit)
        self.watchdog_timeout_s = watchdog_timeout_s
        self.watchdog_first_grace_s = watchdog_first_grace_s if \
            watchdog_first_grace_s is not None else (
                10.0 * watchdog_timeout_s if watchdog_timeout_s else 0.0)
        self.watchdog_jitter = watchdog_jitter
        self.watchdog_abort = watchdog_abort
        self.watchdog_dump_file = watchdog_dump_file
        self.watchdog_seed = watchdog_seed
        self.data_retry_attempts = int(data_retry_attempts)
        self.data_retry_base_delay = float(data_retry_base_delay)
        self.data_retry_max_delay = float(data_retry_max_delay)
        self.data_retry_jitter = float(data_retry_jitter)
        self.verify_restore = bool(verify_restore)
        self.raise_on_preempt = bool(raise_on_preempt)
        self.async_dispatch = bool(async_dispatch)
        self.sync_interval = max(1, int(sync_interval))
        self.max_inflight = max(1, int(max_inflight))
        self.prefetch_depth = max(0, int(prefetch_depth))
        self.snapshot_async = bool(snapshot_async)
        self.snapshot_chunk_bytes = snapshot_chunk_bytes


class RunResult:
    """What a resilient run lifetime produced.

    losses:      {step: loss} for every step this LIFETIME executed and
                 kept (rollback-discarded steps are removed).
    preempted:   True when the run stopped on a preemption request
                 after committing its checkpoint; ``exit_code`` is then
                 the resumable status (75/EX_TEMPFAIL) a worker should
                 exit with so the supervisor reschedules it.
    completed:   reached total_steps.
    """

    def __init__(self, losses: Dict[int, float], start_step: int,
                 final_step: int, total_steps: int, preempted: bool,
                 rollbacks: int):
        self.losses = losses
        self.start_step = start_step
        self.final_step = final_step
        self.total_steps = total_steps
        self.preempted = preempted
        self.rollbacks = rollbacks

    @property
    def completed(self) -> bool:
        return not self.preempted and self.final_step >= self.total_steps

    @property
    def exit_code(self) -> int:
        return PREEMPT_EXIT_CODE if self.preempted else 0

    def loss_list(self):
        """Losses as a dense list ordered by step (steps this lifetime)."""
        return [self.losses[s] for s in sorted(self.losses)]


class ResilientRunner:
    def __init__(self, trainer, ckpt_dir: str, save_interval: int = 100,
                 keep: int = 3, config: Optional[ResilienceConfig] = None,
                 chaos=None):
        self.config = config or ResilienceConfig()
        self.chaos = chaos
        self.elastic = ElasticTrainer(
            trainer, ckpt_dir, save_interval=save_interval, keep=keep,
            degraded_restore=True,
            verify_restore=self.config.verify_restore,
            snapshot_async=self.config.snapshot_async,
            snapshot_chunk_bytes=self.config.snapshot_chunk_bytes)
        self.trainer = trainer
        self.preemption = PreemptionHandler()
        # cursors whose batches poisoned a rollback — never fed again;
        # persisted in every checkpoint's meta so restarts keep them
        self._skips: set = set()
        # the active input prefetcher (async pipeline), exposed for the
        # chaos tests' in-flight-discard assertions
        self.prefetcher = None

    # -- helpers -----------------------------------------------------------
    def _extra_meta(self) -> dict:
        return {"skipped_cursors": sorted(self._skips)}

    def _merge_resumed_skips(self) -> None:
        self._skips.update(
            int(c) for c in self.elastic.last_meta.get(
                "skipped_cursors", []))

    def _advance_past_skips(self) -> None:
        el = self.elastic
        while el.data_cursor in self._skips:
            el.data_cursor += 1

    def _fetch(self, data_fn, cursor: int):
        cfg = self.config
        reg = _registry()

        def _note(i, e, d):
            reg.counter("resilience/data_retries").add(1)

        return retry(lambda: data_fn(cursor),
                     attempts=cfg.data_retry_attempts,
                     base_delay=cfg.data_retry_base_delay,
                     max_delay=cfg.data_retry_max_delay,
                     jitter=cfg.data_retry_jitter,
                     seed=cursor,          # deterministic per batch
                     on_retry=_note)

    def _restorable(self, streak_start: int) -> int:
        """Newest committed step at or before this rank's bad-streak
        start (-1 when none): the restore point this rank can take
        without resuming state younger than the streak's first poisoned
        batch. Cast into the ``resil`` vote; the reducer mins it across
        ranks so every rank restores the SAME step (state-lockstep)."""
        mgr = self.elastic.manager
        mgr.wait()            # an in-flight save must count or not, not race
        from ..distributed.checkpoint import all_steps
        steps = [s for s in all_steps(mgr.directory)
                 if s <= streak_start]
        return steps[-1] if steps else -1

    def _mesh_agree(self, verdict: str, cursors,
                    restorable: int = -1) -> dict:
        """One ``resil`` agreement round (module docstring): cast this
        rank's verdict + poisoned cursors + newest safely-restorable
        step, adopt the published decision. Raises on an agreed abort —
        EVERY rank raises, which is the point (no survivor trains into
        a dead mesh)."""
        cons = self.config.consensus
        reg = _registry()
        dec = cons.decide(
            "resil",
            {"verdict": verdict,
             "bad_cursors": sorted(int(c) for c in cursors),
             "restorable": int(restorable)},
            reducer=_resilience_reducer)
        reg.counter("resilience/mesh_agreements").add(1)
        if dec.value["verdict"] == "abort":
            reg.counter("resilience/mesh_aborts").add(1)
            from ..profiler import events as _pevents
            from ..profiler import sink as _psink

            _pevents.emit("rollback", mesh_abort=True,
                          participants=dec.participants,
                          missing=dec.missing)
            _pevents.dump_flight("mesh-abort")
            _psink.flush_active("rollback")
            raise RuntimeError(
                f"mesh-wide abort agreed (resil#{dec.epoch}): a rank "
                f"hit its bad-step limit with no restorable checkpoint "
                f"and no guard; participants={dec.participants} "
                f"missing={dec.missing}")
        if dec.value["verdict"] == "rollback":
            reg.counter("resilience/mesh_rollbacks").add(1)
        return dec.value

    def _rollback(self, bad_cursors, guarded: bool,
                  target: Optional[int] = None) -> int:
        """K consecutive bad steps: restore the newest readable
        committed checkpoint — capped at the mesh-agreed ``target``
        step when a consensus round produced one (>= 0), so every rank
        lands on the SAME restore point regardless of how far past the
        streak start it had committed — and blocklist the poisoned
        cursors. Returns the step to continue from. With no committed
        checkpoint yet, a GUARDED trainer just continues past the bad
        batches (the guard kept the weights clean; the cursors
        stay blocklisted for any future replay) — an UNGUARDED one has
        already taken the poisoned updates with nothing to restore, so
        the only honest move is to fail loudly.

        Before the restore, the flight recorder dumps (reason
        "rollback") and the active sink flushes: the window of metric
        deltas + events leading INTO the bad streak is the post-mortem
        evidence, and the restore is about to overwrite the live state
        it describes."""
        from ..profiler import events as _pevents
        from ..profiler import sink as _psink

        el = self.elastic
        _registry().counter("resilience/rollbacks").add(1)
        _pevents.emit("rollback", bad_cursors=sorted(bad_cursors))
        _pevents.dump_flight("rollback")
        _psink.flush_active("rollback")
        self._skips.update(bad_cursors)
        el.manager.wait()              # never restore under an async save
        cap = int(target) if target is not None and int(target) >= 0 \
            else None
        newest = el.manager.latest_step()
        if cap is not None and newest is not None:
            from ..distributed.checkpoint import all_steps
            elig = [s for s in all_steps(el.manager.directory)
                    if s <= cap]
            newest = elig[-1] if elig else None
        if newest is None:
            if not guarded:
                raise RuntimeError(
                    f"{len(bad_cursors)} consecutive non-finite steps "
                    "on a trainer WITHOUT guard_bad_steps and no "
                    "committed checkpoint to roll back to: the weights "
                    "are poisoned and unrecoverable. Enable "
                    "guard_bad_steps or checkpoint before the first "
                    "fault window.")
            return -1                  # continue in place
        step = el.resume(max_step=cap)
        self._merge_resumed_skips()
        return step

    # -- the loop ----------------------------------------------------------
    def run(self, data_fn, total_steps: int, on_step=None) -> RunResult:
        """The hardened loop, with the async step pipeline when the
        config enables it: dispatched steps park their device loss AND
        guard verdict in a bounded in-flight window; the per-step
        bad-step/rollback/save logic runs at materialization time, in
        step order, exactly as the synchronous loop would have run it.
        The window only opens once a committed checkpoint exists — a
        K-streak detected with younger steps already dispatched rolls
        back to that checkpoint (restoring state, RNG and data cursor),
        which discards the younger in-flight timeline deterministically
        and keeps the loss curve bitwise-reproducible.

        NOTE: ElasticTrainer.run has the plain (no-resilience) copy of
        this window/drain/prefetch/gate sequencing — a semantic change
        to the window in either loop almost certainly needs the same
        change in the other (its run() docstring carries the same
        cross-reference)."""
        cfg = self.config
        el = self.elastic
        tr = self.trainer
        chaos = self.chaos
        cons = cfg.consensus
        reg = _registry()
        guarded = bool(getattr(tr, "guard_bad_steps", False))
        # deferred verdicts need the PER-STEP device scalar; a guarded
        # trainer without the accessor must run with a closed window —
        # the `last_step_ok` property only reads the LATEST dispatched
        # step's verdict, which is the right step only when the drain
        # happens immediately after its dispatch
        get_ok = getattr(tr, "last_step_ok_device", None)
        can_defer = not guarded or get_ok is not None
        fetch = chaos.wrap_data_fn(data_fn) if chaos is not None \
            else data_fn

        handler = self.preemption
        handler.clear()
        handler.install()
        wd = None
        if cfg.watchdog_timeout_s:
            wd = StepWatchdog(cfg.watchdog_timeout_s,
                              jitter_frac=cfg.watchdog_jitter,
                              abort=cfg.watchdog_abort,
                              dump_file=cfg.watchdog_dump_file,
                              seed=cfg.watchdog_seed).start()
            # the checkpoint restore below is as slow as a first step
            # on a big model/slow FS — it gets the same grace, or every
            # resume of a large job would fire (and with abort, loop)
            wd.pet(-1, grace_s=cfg.watchdog_first_grace_s)
        rollbacks = 0
        preempted = False
        prefetcher = None
        prev_profiled_sync = getattr(tr, "profiled_step_sync", True)
        if cons is not None:
            # lease upkeep off-thread: a cold step that takes a
            # minute must not read as a dead rank to the mesh
            cons.start_heartbeat()
        try:
            start = el.resume()
            self._merge_resumed_skips()
            have_ckpt = el.manager.latest_step() is not None
            # async dispatch: a PROFILED trainer step must not force its
            # own per-step loss sync (hybrid.py profiled_step_sync) —
            # drain() records the honest hybrid/sync_wait span instead
            # (restored in the finally below)
            tr.profiled_step_sync = not cfg.async_dispatch
            if cfg.prefetch_depth > 0:
                from ..distributed.prefetch import BatchPrefetcher

                # fetch rides the SAME retry wrapper; the persisted
                # blocklist is consulted before a cursor is even read
                prefetcher = BatchPrefetcher(
                    lambda c: self._fetch(fetch, c),
                    stage=el._stage_for_prefetch,
                    depth=cfg.prefetch_depth,
                    skip_fn=self._skips.__contains__).start(el.data_cursor)
            self.prefetcher = prefetcher
            losses: Dict[int, float] = {}
            pending: list = []    # (step, cursor, dev_loss, dev_verdict)
            rolled: list = [None]  # (target_step, restored) from a drain
            consecutive_bad = 0
            bad_cursors: list = []
            first = True
            step = start

            def drain(keep: int = 0) -> bool:
                """Materialize the oldest in-flight steps down to
                ``keep``, running the bad-step accounting for each.
                Returns False when a K-streak rollback interrupted the
                drain: every younger in-flight step is discarded (its
                timeline is gone — the restore rewound state, RNG and
                cursor) and ``rolled[0]`` holds where to continue."""
                nonlocal consecutive_bad, bad_cursors, rollbacks
                while len(pending) > keep:
                    s, cur, dev, okdev = pending.pop(0)
                    lossf = el._sync_loss(dev)
                    if guarded:
                        ok = bool(okdev) if okdev is not None \
                            else tr.last_step_ok
                    else:
                        ok = not (math.isnan(lossf) or math.isinf(lossf))
                    if not ok:
                        reg.counter("resilience/steps_skipped").add(1)
                        consecutive_bad += 1
                        bad_cursors.append(cur)
                        if consecutive_bad >= cfg.bad_step_limit:
                            if wd is not None:
                                # the rollback's checkpoint restore is
                                # as slow as the startup one — same
                                # grace (it also covers the consensus
                                # wait for the other ranks to join)
                                wd.pet(s,
                                       grace_s=cfg.watchdog_first_grace_s)
                            roll_cursors = bad_cursors
                            roll_target = None
                            if cons is not None:
                                # THIS rank's verdict becomes the
                                # mesh's: propose, wait for the ranks
                                # that saw nothing wrong, adopt the
                                # union cursor set + min restore
                                # target (or the abort). The streak
                                # covers steps
                                # [s - consecutive_bad + 1, s]; the
                                # vote's restorable is the newest
                                # commit not younger than its start.
                                verdict = "abort" if (
                                    el.manager.latest_step() is None
                                    and not guarded) else "rollback"
                                dec = self._mesh_agree(
                                    verdict, bad_cursors,
                                    restorable=self._restorable(
                                        s - consecutive_bad + 1))
                                roll_cursors = dec["bad_cursors"]
                                roll_target = dec.get("target")
                            back = self._rollback(roll_cursors, guarded,
                                                  target=roll_target)
                            rollbacks += 1
                            consecutive_bad = 0
                            bad_cursors = []
                            n_younger = len(pending)
                            pending.clear()
                            if prefetcher is not None:
                                prefetcher.invalidate(el.data_cursor)
                            if back >= 0:
                                # replay: forget the rolled-over steps
                                for s2 in [s2 for s2 in losses
                                           if s2 >= back]:
                                    del losses[s2]
                                rolled[0] = (back, True)
                            else:
                                # continue in place (guarded, nothing
                                # committed): re-run this step index
                                # with the re-seeded cursor. The window
                                # only opens once a checkpoint commits,
                                # so younger in-flight steps here mean
                                # every commit VANISHED mid-run — their
                                # already-applied updates cannot be
                                # rewound, and re-running their indices
                                # would double-apply. Fail loudly.
                                if n_younger:
                                    raise RuntimeError(
                                        f"K consecutive bad steps with "
                                        f"no readable committed "
                                        f"checkpoint while {n_younger} "
                                        f"younger async-dispatched "
                                        f"step(s) were in flight "
                                        f"(commits removed mid-run?): "
                                        f"state cannot be rewound")
                                rolled[0] = (s, False)
                            return False
                    else:
                        consecutive_bad = 0
                        bad_cursors = []
                    losses[s] = lossf
                    if on_step is not None:
                        on_step(s, lossf)
                return True

            def resume_after_rollback():
                nonlocal step, first
                back, restored = rolled[0]
                step = back
                if restored:
                    first = True       # a restored state gets the grace
                rolled[0] = None

            def join_mesh_round() -> bool:
                """A peer opened a ``resil`` round: drain the window
                (our own streak may complete inside — that path joins
                the SAME round as proposer), then join as healthy and
                execute whatever the mesh agreed. Returns False when
                the drain's own rollback already handled everything."""
                nonlocal step, first, rollbacks, consecutive_bad, \
                    bad_cursors
                if not drain(0):
                    return False
                # this rank's own partial streak (may be empty) covers
                # steps [step - consecutive_bad, step - 1]; its vote
                # offers the newest commit at or before that start
                dec = self._mesh_agree(
                    "healthy", bad_cursors,
                    restorable=self._restorable(step - consecutive_bad))
                if dec["verdict"] != "rollback":
                    return True
                if wd is not None:
                    wd.pet(step, grace_s=cfg.watchdog_first_grace_s)
                back = self._rollback(dec["bad_cursors"], guarded,
                                      target=dec.get("target"))
                rollbacks += 1
                consecutive_bad = 0
                bad_cursors = []
                if prefetcher is not None:
                    prefetcher.invalidate(el.data_cursor)
                if back >= 0:
                    for s2 in [s2 for s2 in losses if s2 >= back]:
                        del losses[s2]
                    step = back
                    first = True
                # back < 0: guarded with nothing committed — continue
                # in place; the union cursors are blocklisted, so the
                # next fetch skips them exactly like the proposer's
                return True

            while True:
                if cons is not None and cons.pending("resil"):
                    if not join_mesh_round():
                        resume_after_rollback()
                    continue
                if step >= total_steps:
                    if not drain(0):
                        resume_after_rollback()
                        continue
                    break
                if wd is not None:
                    wd.pet(step, grace_s=cfg.watchdog_first_grace_s
                           if first else 0.0)
                self._advance_past_skips()
                cursor = el.data_cursor
                if prefetcher is not None:
                    batch = prefetcher.get(cursor)
                else:
                    batch = self._fetch(fetch, cursor)
                    if not isinstance(batch, tuple):
                        batch = (batch,)
                if chaos is not None:
                    chaos.maybe_hang(step)
                    if guarded and chaos.poisons(cursor):
                        tr.inject_fault_scale(float("nan"))
                # streamed-snapshot gate LAST before the dispatch (which
                # donates the state an in-flight save may still be
                # copying to host): the fetch/staging above overlaps the
                # snapshot's D2H
                el.manager.wait_snapshot()
                loss = tr.step(*batch)
                el.data_cursor = cursor + 1
                okdev = get_ok() if (guarded and get_ok is not None) \
                    else None
                first = False
                pending.append((step, cursor, loss, okdev))
                done = step + 1
                step = done

                # in-flight window: 0 (materialize now) unless async
                # dispatch is on, a committed checkpoint anchors a
                # potential rollback, AND per-step device verdicts are
                # available (can_defer); sync_interval forces a drain
                window = cfg.max_inflight if (cfg.async_dispatch
                                              and have_ckpt
                                              and can_defer) else 0
                if window and done % cfg.sync_interval == 0:
                    window = 0
                if not drain(keep=window):
                    resume_after_rollback()
                    continue

                if chaos is not None:
                    chaos.maybe_preempt(done - 1)
                if handler.requested:
                    # make the exit resumable: drain everything the
                    # in-flight window holds, then one synchronous
                    # committed save. NEVER mid-streak (even guarded):
                    # a preemption is asymmetric — the uninterrupted
                    # run has no restore point here, so committing one
                    # would shift the K-streak rollback target and
                    # break loss-curve parity. The restart resumes from
                    # the last streak-free checkpoint and
                    # deterministically replays the streak instead.
                    if not drain(0):
                        resume_after_rollback()
                        continue
                    if consecutive_bad == 0:
                        if wd is not None:
                            # a synchronous big-model save is as slow
                            # as a restore — same grace, or abort mode
                            # kills the commit it exists to protect
                            wd.pet(done,
                                   grace_s=cfg.watchdog_first_grace_s)
                        el.save(done, extra=self._extra_meta(),
                                async_=False)
                        have_ckpt = True
                    reg.counter("resilience/preemptions").add(1)
                    # persist the lifetime's telemetry AFTER the commit
                    # (the handler stays async-signal-
                    # trivial; all I/O happens here at the step
                    # boundary, before the resumable exit)
                    from ..profiler import sink as _psink

                    _psink.flush_active("preempt")
                    preempted = True
                    break
                if done % el.save_interval == 0 or done == total_steps:
                    if not drain(0):
                        resume_after_rollback()
                        continue
                    # saveable: a GUARDED trainer's weights are clean
                    # even mid-bad-streak (the update was deselected);
                    # WITHOUT the guard (host-side NaN check only) the
                    # poisoned update already landed, and committing it
                    # would make the NaN weights the rollback/restart
                    # target — an unrecoverable livelock
                    if guarded or consecutive_bad == 0:
                        el.save(done, extra=self._extra_meta())
                        have_ckpt = True
            if wd is not None:     # joining the async save can be slow
                wd.pet(step, grace_s=cfg.watchdog_first_grace_s)
            el.manager.wait()
            if preempted and cfg.raise_on_preempt:
                from .preemption import PreemptedError

                raise PreemptedError(step, handler.signum or 0,
                                     el.manager.directory)
            return RunResult(losses=losses, start_step=start,
                             final_step=step, total_steps=total_steps,
                             preempted=preempted, rollbacks=rollbacks)
        finally:
            tr.profiled_step_sync = prev_profiled_sync
            if cons is not None:
                cons.stop_heartbeat()
            if prefetcher is not None:
                prefetcher.stop()
            if wd is not None:
                wd.stop()
            handler.uninstall()
