"""paddle_tpu_torch.resilience and the bad-step guard of the port's
``HybridPipelineTrainer`` (degree 1, CPU), held against the JAX package
(the reference's ``tests/test_resilience.py`` and the ``ResilientRunner``
cases of ``tests/test_async_pipeline.py``).

- The watchdog (fire and dump, quiet when petted, the first step's
  grace), its fire path with every device read patched to raise, and its
  abort in a child process: exit 74, the stacks and the open span in the
  dump, a ``watchdog`` line in the sink. The preemption handler. The
  chaos module's checkpoint surgeons on the port's checkpoints.
- The guard: a poisoned step leaves every parameter and optimizer state
  bit-identical (resident and ``offload_optimizer``), the next clean step
  trains, injection needs the guard, and a guarded clean run equals an
  unguarded one bit for bit (the port selects on copies: the same
  operations; the reference states only near-equality across its two
  compiled programs). (The guarded trainer held to the JAX trainer on
  the poisoned sequence, at degree 1 and on gloo ranks, is
  ``tests/test_torch_resilience_mesh.py``, which shares the oracle run.)
- ``ResilientRunner`` against the reference runner on the same
  ``ChaosPlan(nan_cursors={3, 4, 5}, flaky_cursors={6: 1})``, K 3, save
  interval 3, 8 steps, from the same weights: the same skipped cursors,
  rollbacks, restored steps, data retries, counters and checkpoint meta,
  losses within rtol 1e-5 (NaN where the reference's are NaN). Within
  the port: the async window (prefetch, streamed snapshots) equals the
  synchronous loop bit for bit and never feeds a blocklisted cursor
  again; a preemption commits and resumes, one inside a bad streak
  commits nothing; a restart after the newest shard was corrupted walks
  back one step (``resilience/restore_fallbacks``) and continues the
  uninterrupted run's losses bit for bit; the ``resil`` reducer equals
  the reference's on random votes.
- A fresh interpreter imports ``paddle_tpu_torch.resilience`` and
  ``paddle_tpu_torch.profiler.live`` and holds no JAX module.
"""
import json
import math
import os
import random
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.distributed import checkpoint as dck
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.distributed.hybrid import HybridPipelineTrainer
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.profiler import sink as tsink
from paddle_tpu_torch.resilience import (PREEMPT_EXIT_CODE,
                                         WATCHDOG_EXIT_CODE,
                                         PreemptionHandler,
                                         ResilienceConfig, ResilientRunner,
                                         StepWatchdog, chaos)
from paddle_tpu_torch.resilience.runner import _resilience_reducer
from paddle_tpu_torch.utils.tree import flatten

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

#: the reference's ``_tiny_trainer`` model (tests/test_resilience.py)
TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
            max_seq_len=16)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the test workers share the machine's cores
    (and a run compared bit for bit with another runs as many)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    tsink.disable_sink()
    yield
    tsink.disable_sink()
    tprof.trace.disable()


def _counter(name):
    return tprof.registry().counter(name).value


# ---------------------------------------------------------------------------
# the watchdog and the preemption handler
# ---------------------------------------------------------------------------
def test_watchdog_fires_on_hang_and_dumps_state():
    fired = []
    before = _counter("resilience/watchdog_fires")
    wd = StepWatchdog(0.2, jitter_frac=0.0, abort=False, poll_s=0.05,
                      on_fire=lambda step, el, text: fired.append(
                          (step, text)))
    with wd:
        wd.pet(0)
        time.sleep(0.7)                  # no pets: it must fire, once
    assert wd.fired and len(fired) == 1
    step, text = fired[0]
    assert step == 0
    assert "hung-step dump" in text and "thread" in text
    assert _counter("resilience/watchdog_fires") == before + 1


def test_watchdog_stays_quiet_when_petted():
    wd = StepWatchdog(0.3, jitter_frac=0.0, abort=False, poll_s=0.05)
    with wd:
        for s in range(6):
            wd.pet(s)
            time.sleep(0.1)
    assert not wd.fired


def test_watchdog_first_step_grace():
    wd = StepWatchdog(0.2, jitter_frac=0.0, abort=False, poll_s=0.05)
    with wd:
        wd.pet(0, grace_s=1.0)           # a cold first step's allowance
        time.sleep(0.6)                  # > timeout, < timeout + grace
        assert not wd.fired
        wd.pet(1)
        time.sleep(0.1)
    assert not wd.fired


def test_watchdog_fire_path_reads_nothing_from_the_device(tmp_path,
                                                          monkeypatch):
    """Every call that waits on the card raises here: the fire still
    dumps the open span, writes the flight recorder and flushes the sink
    with reason ``watchdog`` (a hung kernel holds the stream; a fire path
    that waited on it would hang too)."""
    def refuse(*a, **k):
        raise AssertionError("the watchdog's fire path read the device")

    for obj, name in ((torch.cuda, "synchronize"),
                      (torch.cuda.Event, "synchronize"),
                      (torch.Tensor, "item"), (torch.Tensor, "tolist"),
                      (torch.Tensor, "cpu"), (torch.Tensor, "__float__")):
        monkeypatch.setattr(obj, name, refuse)
    tsink.enable_sink(str(tmp_path), interval_s=3600.0,
                      per_rank_subdir=False)
    tprof.enable(reset=False)
    dump = str(tmp_path / "hang.txt")
    wd = StepWatchdog(0.2, jitter_frac=0.0, poll_s=0.05, dump_file=dump)
    with tprof.scope("hybrid/step"), wd:
        wd.pet(7)
        time.sleep(0.7)
    tsink.disable_sink()
    assert wd.fired
    text = open(dump).read()
    assert "open profiler spans" in text and "hybrid/step" in text
    assert wd.flight_path == dump + ".flight.json"
    assert json.load(open(wd.flight_path))["reason"] == "watchdog"
    reasons = [json.loads(ln)["reason"]
               for ln in open(tmp_path / "metrics.jsonl")]
    assert "watchdog" in reasons


def test_watchdog_abort_ends_the_process_with_74(tmp_path):
    script = (
        "import sys, time\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from paddle_tpu_torch import profiler\n"
        "from paddle_tpu_torch.profiler import sink\n"
        "from paddle_tpu_torch.resilience import StepWatchdog\n"
        f"sink.enable_sink({str(tmp_path)!r}, interval_s=3600.0,\n"
        "                 per_rank_subdir=False)\n"
        "profiler.enable(reset=False)\n"
        f"wd = StepWatchdog(0.3, jitter_frac=0.0, abort=True,\n"
        f"                  dump_file={str(tmp_path / 'dump.txt')!r})\n"
        "with profiler.scope('hybrid/step'):\n"
        "    wd.start()\n"
        "    wd.pet(3)\n"
        "    time.sleep(30)\n")
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=60,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert p.returncode == WATCHDOG_EXIT_CODE == 74, p.stderr[-2000:]
    text = open(tmp_path / "dump.txt").read()
    assert "hung-step dump" in text and "hybrid/step" in text
    reasons = [json.loads(ln)["reason"]
               for ln in open(tmp_path / "metrics.jsonl")]
    assert reasons[-1] == "watchdog"


def test_preemption_handler_flags_sigterm_and_restores():
    prev = signal.getsignal(signal.SIGTERM)
    with PreemptionHandler() as h:
        assert not h.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.wait(timeout=5)
        assert h.requested and h.signum == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) is prev
    h = PreemptionHandler()
    h.request()
    assert h.requested
    h.clear()
    assert not h.requested


# ---------------------------------------------------------------------------
# the chaos surgeons on the port's checkpoints
# ---------------------------------------------------------------------------
def _saved(d, steps=(2, 4)):
    for s in steps:
        dck.save(d, {"x": torch.arange(64, dtype=torch.float32) * s},
                 step=s, meta={"step": s}, async_=False)
    return {"x": torch.zeros(64)}


@pytest.mark.parametrize("damage,verify,warns", [
    ("kill_mid_save", False, False), ("truncate", False, True),
    ("flip", True, True), ("delete_commit", False, False),
    ("delete_shard", False, True), ("abandon_async", False, False)])
def test_chaos_damage_walks_back_to_a_readable_step(tmp_path, damage,
                                                    verify, warns):
    d = str(tmp_path)
    template = _saved(d)
    want = 4
    before = _counter("resilience/restore_fallbacks")
    if damage == "kill_mid_save":
        chaos.simulate_kill_mid_save(d, step=6)
    elif damage == "abandon_async":
        step_dir = chaos.abandon_async_save(dck.save(
            d, {"x": torch.ones(64)}, step=6))
        assert os.path.exists(os.path.join(step_dir, "shard_p0.bin"))
    else:
        {"truncate": chaos.truncate_shard, "flip": chaos.flip_shard_byte,
         "delete_commit": chaos.delete_commit,
         "delete_shard": chaos.delete_shard}[damage](d)
        want = 2
    assert chaos.newest_committed_step(d) == (2 if damage == "delete_commit"
                                              else 4)
    if warns:
        with pytest.warns(RuntimeWarning):
            st, _, step = dck.restore_degraded(d, template, verify=verify)
    else:
        st, _, step = dck.restore_degraded(d, template, verify=verify)
    assert step == want
    np.testing.assert_array_equal(st["x"].numpy(),
                                  np.arange(64, dtype=np.float32) * want)
    assert _counter("resilience/restore_fallbacks") == before + int(warns)


def test_all_steps_corrupt_raises(tmp_path):
    d = str(tmp_path)
    template = _saved(d)
    for s in (2, 4):
        chaos.truncate_shard(d, step=s, keep_bytes=4)
    with pytest.raises(IOError), pytest.warns(RuntimeWarning):
        dck.restore_degraded(d, template, verify=False)
    with pytest.raises(FileNotFoundError):
        chaos.newest_committed_step(str(tmp_path / "empty"))


# ---------------------------------------------------------------------------
# the guard
# ---------------------------------------------------------------------------
def _tiny_trainer(guard=True, seed=11, state=None, **kw):
    import paddle_tpu_torch as pt

    pt.seed(seed)
    net = tgpt.GPT(tgpt.GPTConfig(**TINY), device="cpu")
    if state is not None:
        tgpt.load_reference_state(net, state)
    opt = AdamW(2e-3, parameters=net.named_parameters())
    return HybridPipelineTrainer(net, opt, DistributedStrategy(), n_micro=1,
                                 guard_bad_steps=guard, **kw)


def _batch(cursor):
    rng = np.random.RandomState(1000 + cursor)
    return (rng.randint(0, 128, (2, 16)).astype(np.int64),)


def _bits(tr):
    return [t.data.contiguous().reshape(-1).view(torch.uint8).clone()
            for _, t in flatten(tr.device_state())]


@pytest.mark.parametrize("kw", [{}, {"offload_optimizer": True}],
                         ids=["resident", "offload_optimizer"])
def test_guard_skips_update_bit_exactly(kw):
    tr = _tiny_trainer(**kw)
    assert np.isfinite(float(tr.step(*_batch(0)))) and tr.last_step_ok
    assert tr.last_step_ok_device().dtype == torch.bool
    before = _bits(tr)
    tr.inject_fault_scale(float("nan"))
    assert math.isnan(float(tr.step(*_batch(1))))
    assert not tr.last_step_ok
    after = _bits(tr)
    assert len(before) == len(after) > 0
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert tr._step == 2 and tr.optimizer._global_step == 2
    tr.step(*_batch(2))                  # the next clean step trains
    assert tr.last_step_ok
    assert not all(torch.equal(a, b) for a, b in zip(after, _bits(tr)))


def test_guard_requires_flag_and_is_exact_on_clean_steps():
    with pytest.raises(RuntimeError, match="guard_bad_steps"):
        _tiny_trainer(guard=False).inject_fault_scale(float("nan"))
    a, b = _tiny_trainer(guard=True), _tiny_trainer(guard=False)
    for c in range(3):
        assert float(a.step(*_batch(c))) == float(b.step(*_batch(c)))
    assert all(torch.equal(x, y) for x, y in zip(_bits(a), _bits(b)))


# ---------------------------------------------------------------------------
# ResilientRunner against the reference runner
# ---------------------------------------------------------------------------
PLAN = dict(nan_cursors={3, 4, 5}, flaky_cursors={6: 1})
COUNTERS = ("resilience/steps_skipped", "resilience/rollbacks",
            "resilience/restore_fallbacks", "resilience/preemptions",
            "resilience/data_retries")


def _run_chaotic(trainer, registry, runner_cls, cfg_cls, chaos_mod, d,
                 async_=False, total=8, batch=_batch, events=None):
    """The reference's ``_run_chaotic`` (tests/test_async_pipeline.py)
    with either package's classes: (result, runner, cursors fed to the
    trainer, the steps each resume restored, counter deltas and, with
    ``events`` (a package's profiler events module), the ``rollback``
    events' fields)."""
    cfg = cfg_cls(bad_step_limit=3, data_retry_base_delay=0.01,
                  async_dispatch=async_, sync_interval=5, max_inflight=2,
                  prefetch_depth=2 if async_ else 0, snapshot_async=async_)
    runner = runner_cls(trainer, d, save_interval=3, config=cfg,
                        chaos=chaos_mod.ChaosPlan(**PLAN))
    consumed, restored = [], []
    step, resume = trainer.step, runner.elastic.resume
    trainer.step = lambda *b: (consumed.append(runner.elastic.data_cursor),
                               step(*b))[1]
    runner.elastic.resume = lambda *a, **k: (
        restored.append(resume(*a, **k)), restored[-1])[1]
    c0 = {n: registry().counter(n).value for n in COUNTERS}
    if events is not None:
        events.set_enabled(True)
        seq0 = events.log().next_seq
    res = runner.run(batch, total)
    delta = {n: registry().counter(n).value - c0[n] for n in COUNTERS}
    if events is not None:
        delta["rollback_events"] = [
            e.attrs for e in events.log().since(seq0)[0]
            if e.kind == "rollback"]
    return res, runner, consumed, restored, delta


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference runner on its ``_tiny_trainer`` (one virtual CPU
    device), and that trainer's initial weights."""
    import jax

    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet import DistributedStrategy as JS
    from paddle_tpu.distributed.hybrid import HybridPipelineTrainer as JT
    from paddle_tpu.distributed.mesh import create_mesh
    from paddle_tpu.models import GPT, GPTConfig
    from paddle_tpu.profiler import events as jevents
    from paddle_tpu.profiler.metrics import registry
    from paddle_tpu.resilience import ResilienceConfig as JC
    from paddle_tpu.resilience import ResilientRunner as JR
    from paddle_tpu.resilience import chaos as jchaos

    paddle.seed(11)
    net = GPT(GPTConfig(**TINY))
    state = {k: np.asarray(v._value) for k, v in net.state_dict().items()}
    opt = paddle.optimizer.AdamW(2e-3, parameters=net.parameters())
    tr = JT(net, opt, JS(), create_mesh({"dp": 1}, jax.devices()[:1]),
            n_micro=1, guard_bad_steps=True)
    d = str(tmp_path_factory.mktemp("ref_runner"))
    out = _run_chaotic(tr, registry, JR, JC, jchaos, d, events=jevents,
                       batch=lambda c: tuple(b.astype(np.int32)
                                             for b in _batch(c)))
    return state, d, out


def _port_chaotic(d, state=None, async_=False, total=8):
    from paddle_tpu_torch.profiler import events
    from paddle_tpu_torch.profiler.metrics import registry

    return _run_chaotic(_tiny_trainer(state=state), registry,
                        ResilientRunner, ResilienceConfig, chaos, d,
                        async_=async_, events=events, total=total)


@pytest.fixture(scope="module")
def port_run(reference_run, tmp_path_factory):
    """The port's runner, synchronous, on the reference's weights and
    plan: the run the reference is held to, and the uninterrupted run the
    async window and the restarted lives are held to."""
    d = str(tmp_path_factory.mktemp("port_runner"))
    return d, _port_chaotic(d, state=reference_run[0])


def test_runner_matches_reference_runner(reference_run, port_run):
    state, ref_dir, (rres, rrun, rcons, rrest, rdelta) = reference_run
    d, (res, run, cons, rest, delta) = port_run
    assert res.completed and rres.completed
    assert res.rollbacks == rres.rollbacks == 1
    assert sorted(run._skips) == sorted(rrun._skips) == [3, 4, 5]
    assert rest == rrest == [0, 3]
    assert cons == rcons
    # the counters, and the rollback event's fields (events.py's
    # ``rollback`` kind: the reference's ``bad_cursors``)
    assert delta == rdelta
    assert delta["rollback_events"] == [{"bad_cursors": [3, 4, 5]}]
    assert delta["resilience/steps_skipped"] == 3
    assert delta["resilience/data_retries"] == 1
    assert sorted(res.losses) == sorted(rres.losses) == list(range(8))
    for s in res.losses:
        a, b = res.losses[s], rres.losses[s]
        assert (math.isnan(a) and math.isnan(b)) or \
            a == pytest.approx(b, rel=1e-5), (s, a, b)
    want = dck.load_meta(ref_dir, dck.latest_step(ref_dir))
    got = dck.load_meta(d, dck.latest_step(d))
    for k in ("step", "data_cursor", "skipped_cursors"):
        assert got[k] == want[k], k
    assert got["skipped_cursors"] == [3, 4, 5]


def test_async_window_equals_sync_and_never_replays_the_blocklist(
        reference_run, port_run, tmp_path):
    _, (res_s, _, cons_s, _, _) = port_run
    res_a, run_a, cons_a, _, _ = _port_chaotic(
        str(tmp_path / "async"), state=reference_run[0], async_=True)
    assert res_s.completed and res_a.completed
    assert res_s.rollbacks == res_a.rollbacks == 1
    assert sorted(res_s.losses) == sorted(res_a.losses)
    for s in res_s.losses:
        a, b = res_s.losses[s], res_a.losses[s]
        assert (math.isnan(a) and math.isnan(b)) or a == b, (s, a, b)
    for bad in (3, 4, 5):               # fed once: the poisoning pass
        assert cons_a.count(bad) == cons_s.count(bad) == 1
    assert run_a.prefetcher is not None and run_a.prefetcher.discarded >= 1
    ck = str(tmp_path / "async")
    assert dck.load_meta(ck, dck.latest_step(ck))["skipped_cursors"] == \
        [3, 4, 5]


def test_rollback_reseeds_cursor_and_persists_the_skips(tmp_path):
    """The reference's ``test_rollback_after_k_bad_steps_reseeds_cursor``:
    6 steps consume cursors 0, 1, 2, 6, 7, 8; the kept curve is clean."""
    ck = str(tmp_path / "ck")
    tr = _tiny_trainer()
    runner = ResilientRunner(tr, ck, save_interval=3,
                             config=ResilienceConfig(bad_step_limit=3),
                             chaos=chaos.ChaosPlan(nan_cursors={3, 4, 5}))
    res = runner.run(_batch, 6)
    assert res.completed and res.rollbacks == 1
    meta = dck.load_meta(ck, dck.latest_step(ck))
    assert meta["skipped_cursors"] == [3, 4, 5]
    assert meta["data_cursor"] == 9 and meta["step"] == 6
    assert sorted(res.losses) == list(range(6))
    assert all(np.isfinite(v) for v in res.losses.values())


def test_preemption_commits_resumes_and_mid_streak_commits_nothing(
        tmp_path):
    ck = str(tmp_path / "ck")
    before = _counter("resilience/preemptions")
    cfg = ResilienceConfig(async_dispatch=True, sync_interval=100,
                           max_inflight=3, prefetch_depth=2,
                           snapshot_async=True)
    runner = ResilientRunner(_tiny_trainer(), ck, save_interval=2,
                             config=cfg,
                             chaos=chaos.ChaosPlan(preempt_after_step=2))
    res = runner.run(_batch, 6)
    assert res.preempted and not res.completed
    assert res.exit_code == PREEMPT_EXIT_CODE == 75
    assert _counter("resilience/preemptions") == before + 1
    assert dck.latest_step(ck) == 3 and sorted(res.losses) == [0, 1, 2]
    res2 = ResilientRunner(_tiny_trainer(), ck, save_interval=2,
                           config=cfg).run(_batch, 6)
    assert res2.completed and res2.start_step == 3
    assert sorted(res2.losses) == [3, 4, 5]
    # inside a bad streak a preemption commits no restore point
    ck2 = str(tmp_path / "ck2")
    res = ResilientRunner(_tiny_trainer(), ck2, save_interval=100,
                          chaos=chaos.ChaosPlan(nan_cursors={0, 1},
                                                preempt_after_step=0)
                          ).run(_batch, 4)
    assert res.preempted and dck.latest_step(ck2) is None


def test_restart_after_corrupt_newest_walks_back_and_continues(
        reference_run, port_run, tmp_path):
    """The runner tests' chaos plan, preempted after step 6 (the replay's
    step: no streak is open): the periodic commits are steps 3 and 6 and
    the preemption commits step 7. With a byte of step 7's shard flipped,
    the restart walks back to step 6 (one fallback) and the losses of
    both lives equal the uninterrupted run's on every step, bit for
    bit (the resilience phase's (s3) on the card)."""
    state = reference_run[0]
    full = port_run[1][0]
    ck = str(tmp_path / "ck")
    cfg = ResilienceConfig(bad_step_limit=3, data_retry_base_delay=0.01)
    first = ResilientRunner(_tiny_trainer(state=state), ck, save_interval=3,
                            config=cfg,
                            chaos=chaos.ChaosPlan(preempt_after_step=6,
                                                  **PLAN)).run(_batch, 8)
    assert first.preempted and dck.latest_step(ck) == 7
    chaos.flip_shard_byte(ck)
    before = _counter("resilience/restore_fallbacks")
    with pytest.warns(RuntimeWarning):
        second = ResilientRunner(_tiny_trainer(state=state), ck,
                                 save_interval=3, config=cfg,
                                 chaos=chaos.ChaosPlan(**PLAN)
                                 ).run(_batch, 8)
    assert _counter("resilience/restore_fallbacks") == before + 1
    assert second.completed and second.start_step == 6
    assert sorted({**first.losses, **second.losses}) == list(range(8))
    for s, v in {**first.losses, **second.losses}.items():
        w = full.losses[s]
        assert (math.isnan(v) and math.isnan(w)) or v == w, (s, v, w)


def test_resilience_reducer_matches_reference():
    from paddle_tpu.resilience.runner import _resilience_reducer as ref

    rng = random.Random(0)
    for _ in range(200):
        votes = {r: {"verdict": rng.choice(["healthy", "rollback",
                                            "abort"]),
                     "bad_cursors": rng.sample(range(20),
                                               rng.randint(0, 4)),
                     "restorable": rng.randint(-1, 9)}
                 for r in range(rng.randint(1, 4))}
        if rng.random() < 0.2:           # an older peer's vote
            del votes[0]["restorable"]
        assert _resilience_reducer(votes) == ref(votes)


def test_imports_hold_no_jax():
    code = ("import sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "import paddle_tpu_torch.resilience, "
            "paddle_tpu_torch.profiler.live\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout
