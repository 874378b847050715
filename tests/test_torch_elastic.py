"""The port's ``distributed/elastic.py`` and ``distributed/prefetch.py``
(the oracle: ``tests/test_elastic.py`` and the loop cases of
``tests/test_async_pipeline.py``), on the CPU.

- A gpt_tiny child (``tests/data/torch_elastic_worker.py``: save every 2
  steps, ``prefetch_depth`` 2, ``async_dispatch``, ``snapshot_async``)
  SIGKILLed mid-run and started again resumes from the newest committed
  step and continues the uninterrupted run's loss curve bit for bit
  (the reference's test asks rtol 1e-6; on the CPU the port's steps are
  deterministic). The reference's version is slow-marked; this one runs
  6 steps of gpt_tiny in each life.
- A child killed while its step-4 save is still writing (each write
  slowed) restarts from step 2, the previous committed step.
- Deferred loss sync: the losses of ``async_dispatch`` equal the
  synchronous loop's bit for bit.
- ``BatchPrefetcher``: batches by exact cursor, ``invalidate`` and a
  moved cursor discard what is in flight (``discarded``), ``skip_fn``
  is asked before a fetch, a fetch error surfaces at ``get``, and the
  ``elastic/prefetch_depth`` gauge is set while profiling.
- In-place updates against a save: the trainers update their state in
  place, so a sync save copies before it returns and a
  ``snapshot_async`` save is gated by ``wait_snapshot``; a step after
  either leaves the committed bytes at the pre-step values.

The guard and ``ResilientRunner`` cases of ``tests/test_async_pipeline.py``
wait for ROADMAP queue 1 item 8.
"""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "data", "torch_elastic_worker.py")
TOTAL = 6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads for this module's in-process trainers: the
    suite runs several workers on few cores, where torch's default (one
    thread a core) oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spawn(ckpt, log, **env_extra):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    env.update({k: str(v) for k, v in env_extra.items()})
    return subprocess.Popen(
        [sys.executable, WORKER, str(ckpt), str(log), str(TOTAL)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=REPO)


def _losses(log):
    out = {}
    if os.path.exists(log):
        for line in open(log):
            s, loss = line.strip().split(",")
            out[int(s)] = float(loss)          # later lives overwrite
    return out


def _kill_when(p, cond, timeout=300):
    deadline = time.time() + timeout
    try:
        while time.time() < deadline and p.poll() is None:
            if cond():
                p.send_signal(signal.SIGKILL)
                break
            time.sleep(0.02)
        p.wait(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode != 0, "the child should have been killed"


@pytest.fixture(scope="module")
def reference_curve(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic_ref")
    p = _spawn(d / "ck", d / "ref.log")
    out, _ = p.communicate(timeout=300)
    assert p.returncode == 0, out[-3000:]
    ref = _losses(d / "ref.log")
    assert len(ref) == TOTAL
    return ref


def _finish(ckpt, log, ref):
    p = _spawn(ckpt, log)
    out, _ = p.communicate(timeout=300)
    assert p.returncode == 0, out[-3000:]
    got = _losses(log)
    assert sorted(got) == list(range(TOTAL))
    for s in range(TOTAL):
        assert got[s] == ref[s], (s, got[s], ref[s])
    return [int(x) for x in open(str(log) + ".resumed").read().split()]


def test_sigkill_resume_identical_curve(tmp_path, reference_curve):
    from paddle_tpu_torch.distributed import checkpoint as dck

    log, ckpt = tmp_path / "run.log", tmp_path / "ck"
    p = _spawn(ckpt, log, ELASTIC_STEP_DELAY=0.2)
    _kill_when(p, lambda: len(_losses(log)) >= TOTAL // 2
               and dck.latest_step(str(ckpt)))
    assert len(_losses(log)) < TOTAL
    newest = dck.latest_step(str(ckpt))
    assert _finish(ckpt, log, reference_curve) == [0, newest]


def test_kill_mid_snapshot_lands_on_the_previous_commit(tmp_path,
                                                       reference_curve):
    from paddle_tpu_torch.distributed import checkpoint as dck

    log, ckpt = tmp_path / "run.log", tmp_path / "ck"
    p = _spawn(ckpt, log, ELASTIC_SLOW_WRITE=0.03)

    def mid_save():
        return os.path.isdir(ckpt / "step_00000004") and \
            dck.all_steps(str(ckpt)) == [2]

    _kill_when(p, mid_save)
    assert dck.all_steps(str(ckpt)) == [2]
    assert not (ckpt / "step_00000004" / "COMMIT").exists()
    assert _finish(ckpt, log, reference_curve) == [0, 2]


# ---------------------------------------------------------------------------
# in-process: the loop, the prefetcher, saves against in-place updates
# ---------------------------------------------------------------------------
def _trainer(seed=11):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.hybrid import HybridPipelineTrainer
    from paddle_tpu_torch.models import gpt as tgpt
    from paddle_tpu_torch.optimizer import AdamW

    pt.seed(seed)
    net = tgpt.gpt_tiny(device="cpu")
    opt = AdamW(2e-3, parameters=net.named_parameters())
    return HybridPipelineTrainer(net, opt, DistributedStrategy(), n_micro=2)


def _data(cursor):
    rng = np.random.RandomState(1000 + cursor)
    return (rng.randint(0, 128, (4, 32)).astype(np.int64),)


def test_deferred_sync_is_bitwise(tmp_path):
    from paddle_tpu_torch.distributed.elastic import ElasticTrainer

    runs = {}
    for name, kw in (("sync", {}),
                     ("async", dict(async_dispatch=True, max_inflight=2,
                                    sync_interval=3, prefetch_depth=2))):
        el = ElasticTrainer(_trainer(), str(tmp_path / name),
                            save_interval=3, **kw)
        seen = []
        runs[name] = el.run(_data, 6, on_step=lambda s, v: seen.append(s))
        assert seen == list(range(6)) and el.loss_syncs == 6
    assert runs["sync"] == runs["async"]


def test_prefetcher_cursor_invalidate_and_skip():
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.distributed.prefetch import BatchPrefetcher

    fetched = []

    def fetch(c):
        fetched.append(c)
        if c == 42:
            raise RuntimeError("bad batch 42")
        return np.full(2, c)

    staged = []
    with BatchPrefetcher(fetch, stage=lambda b: staged.append(b) or b,
                         depth=2, skip_fn=lambda c: c in (3, 4)) as pf:
        pf.start(0)
        profiler.enable(reset=False)
        try:
            assert pf.get(0)[0].tolist() == [0, 0]
            assert profiler.registry().gauge(
                "elastic/prefetch_depth").value >= 1
        finally:
            profiler.disable()
        assert pf.get(1)[0].tolist() == [1, 1]
        assert pf.get(2)[0].tolist() == [2, 2]
        # the skipped cursors are never fetched: 2 is followed by 5
        assert pf.get(5)[0].tolist() == [5, 5]
        assert 3 not in fetched and 4 not in fetched
        while len(pf._queue) < pf.depth:       # a full window in flight
            time.sleep(0.01)
        before = pf.discarded
        # a rollback: the cursor moves back, the window is thrown away
        assert pf.get(1)[0].tolist() == [1, 1]
        assert pf.discarded > before
        pf.invalidate(42)
        with pytest.raises(RuntimeError, match="bad batch 42"):
            pf.get(42)
    assert len(staged) >= 5


@pytest.mark.parametrize("snapshot_async", [False, True])
def test_committed_bytes_are_the_pre_step_values(tmp_path, snapshot_async):
    from paddle_tpu_torch.distributed import checkpoint as dck

    tr = _trainer()
    tr.step(*_data(0))
    want = {k: v.data.clone()
            for k, v in tr.device_state()["params"].items()}
    h = dck.save(str(tmp_path), tr.device_state(), step=1,
                 snapshot_async=snapshot_async)
    if snapshot_async:
        h.wait_snapshot()
    tr.step(*_data(1))                       # updates in place
    moved = tr.device_state()["params"]
    assert any(not torch.equal(moved[k].data, v) for k, v in want.items())
    h.wait()
    back = dck.restore(str(tmp_path), _trainer().device_state())
    for k, v in want.items():
        assert torch.equal(back["params"][k].data, v), k
