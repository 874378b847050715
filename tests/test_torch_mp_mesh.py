"""The port's serving mesh on real processes, on the CPU, started through
``paddle_tpu_torch.distributed.mp_mesh`` (the torch counterpart of
``tools/mp_mesh.py``); the workers are ``tests/data/torch_serving_worker.py``.

Every rank serves the JAX package's gpt_tiny (0.2 init, seed 0), its
weights written here as numpy and loaded by each rank, so the mesh's
streams are held to the JAX single engine's as well as to each worker's
own single engine. The clean two-process disaggregated run stays in
tier 1; the chaos legs (kill mid-handoff, kill one and re-dispatch, join
mid-run) carry the reference's ``multihost`` and ``slow`` markers, as
``tests/multihost/test_{serving,elastic}_mesh.py`` do. Every test skips
itself where the host cannot spawn workers (``mp_mesh.can_spawn``).
``tools/merge_traces.py`` runs as a subprocess.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from paddle_tpu_torch.distributed import mp_mesh

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "data", "torch_serving_worker.py")
MERGER = os.path.join(REPO, "tools", "merge_traces.py")
SKEW = 0.4
CPU = {"PADDLE_DISTRI_BACKEND": "cpu", "OMP_NUM_THREADS": "1"}

sys.path.insert(0, os.path.join(HERE, "data"))
import torch_serving_worker as W  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _spawnable():
    if not mp_mesh.can_spawn():
        pytest.skip("this host cannot spawn worker processes "
                    "(MPMESH_DISABLE set, or no subprocess/socket support)")


@pytest.fixture(scope="module")
def jax_net():
    import paddle_tpu as paddle
    from paddle_tpu.models import gpt as jgpt

    paddle.seed(0)
    net = jgpt.gpt_tiny(initializer_range=0.2)
    net.eval()
    return net


def _write_state(jnet, out_dir):
    np.savez(os.path.join(out_dir, "state.npz"),
             **{k: np.asarray(v._value) for k, v in jnet.state_dict().items()})


def _jax_streams(jnet, prompts):
    from paddle_tpu.serving import ServingConfig, ServingEngine

    eng = ServingEngine(jnet, ServingConfig(**W.CFG))
    rids = [eng.submit(p, W.MAX_NEW) for p in prompts]
    out = eng.run()
    return {g: np.asarray(out[r]) for g, r in enumerate(rids)}


def _results(tmp_path, ranks):
    out = []
    for r in ranks:
        with open(tmp_path / f"results.{r}.json") as f:
            out.append(json.load(f))
    return out


def _exactly_once(docs, n):
    owner = {}
    for doc in docs:
        for g in doc["results"]:
            assert g not in owner, f"gid {g} on ranks {owner[g]}, {doc['rank']}"
            owner[g] = doc["rank"]
    assert sorted(int(g) for g in owner) == list(range(n)), sorted(owner)
    return {int(g): np.asarray(doc["results"][g])
            for doc in docs for g in doc["results"]}


def _merge(sink_root, out):
    res = subprocess.run([sys.executable, MERGER, str(sink_root), "--out",
                          str(out)], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr + res.stdout
    with open(out) as f:
        return json.load(f)


def test_two_process_disagg_bitwise_and_merged(tmp_path, jax_net):
    """Rank 1 prefills on a clock skewed by 0.4 s, rank 0 decodes: the
    streams equal the JAX single engine's, rank 0 owns every TTFT (the
    handed-off ones with their uncertainty), rank 1 recovered its skew,
    and the two sinks merge into one monotonic timeline whose handoffs
    equal rank 0's imports."""
    _write_state(jax_net, tmp_path)
    res = mp_mesh.launch(2, WORKER, [str(tmp_path), "run"],
                         log_dir=str(tmp_path / "logs"), timeout=120,
                         env_extra=dict(CPU, PADDLE_CLOCK_SKEW=f"1:{SKEW}"))
    assert res.ok, res.tail()
    r0, r1 = _results(tmp_path, (0, 1))
    assert r0["foreign_modules"] == r1["foreign_modules"] == []
    assert r1["handoffs_sent"] == r0["handoffs_recv"] > 0
    assert r0["results"] and not r1["results"]
    got = _exactly_once((r0, r1), len(W.RUN_LENS))
    want = _jax_streams(jax_net, W.prompts_for(W.RUN_LENS))
    for g in want:
        np.testing.assert_array_equal(got[g], want[g])
    assert r0["ttft_ms"] and not r1["ttft_ms"] and r0["ttft_unc_ms"]
    for g, unc in r0["ttft_unc_ms"].items():
        assert r0["ttft_ms"][g] > 0
        assert unc < SKEW * 1e3 / 2
    assert r1["clock"]["synced"]
    assert abs(r1["clock"]["offset_s"] - SKEW) <= r1["clock"]["unc_s"] + 0.05
    doc = _merge(tmp_path / "sink", tmp_path / "merged.json")
    assert not doc["partial"]
    assert doc["handoffs"] == r0["handoffs_recv"]
    assert doc["monotonic_violations"] == 0
    assert abs(doc["ranks"]["1"]["offset_s"] - SKEW) <= \
        doc["ranks"]["1"]["unc_s"] + 0.05
    for req in doc["requests"]:
        assert req["complete"] and req["monotonic"], req
    for req in (r for r in doc["requests"] if r["handed_off"]):
        assert req["ranks"] == [0, 1]
        assert req["ttft_lo_ms"] <= req["ttft_ms"] <= req["ttft_hi_ms"]


@pytest.mark.multihost
@pytest.mark.slow
def test_kill_prefill_rank_mid_handoff(tmp_path, jax_net):
    """Rank 1 dies between a payload's bytes and their rename: rank 0
    imports nothing, keeps a clean pool, and, once the mesh declares
    rank 1 dead, re-prefills the long prompts: every gid once, bitwise."""
    _write_state(jax_net, tmp_path)
    res = mp_mesh.launch(2, WORKER, [str(tmp_path), "chaos"],
                         log_dir=str(tmp_path / "logs"), timeout=240,
                         chaos="kill:1:pre_handoff_commit",
                         expect_fail_ranks=(1,), env_extra=CPU)
    assert res.ok, res.tail()
    assert res.returncodes[1] == mp_mesh.KILL_EXIT
    assert "chaos-killed" in res.log(1)
    names = os.listdir(tmp_path / "shared" / "handoff")
    assert any(".tmp" in n for n in names), names
    assert not any(n.endswith(".npz") for n in names), names
    (r0,) = _results(tmp_path, (0,))
    assert r0["handoffs_recv"] == 0
    got = _exactly_once((r0,), len(W.RUN_LENS))
    want = _jax_streams(jax_net, W.prompts_for(W.RUN_LENS))
    for g in want:
        np.testing.assert_array_equal(got[g], want[g])
    assert set(r0["redispatched"].values()) == {"reprefill"}
    assert sorted(int(g) for g in r0["redispatched"]) == sorted(
        set(range(len(W.RUN_LENS))) - set(r0["direct"]))
    doc = _merge(tmp_path / "sink", tmp_path / "merged.json")
    assert doc["requests_total"] > 0


@pytest.mark.multihost
@pytest.mark.slow
def test_kill_one_redispatch_zero_lost(tmp_path, jax_net):
    """Three symmetric ranks; rank 2 is SIGKILLed mid-run. The survivors
    agree membership {0, 1}, re-dispatch its orphans and finish every gid
    exactly once, bitwise, with ledgers that balance net of voids."""
    _write_state(jax_net, tmp_path)
    h = mp_mesh.launch_async(3, WORKER, [str(tmp_path), "kill"],
                             log_dir=str(tmp_path / "logs"), env_extra=CPU)
    assert mp_mesh.wait_for_files([str(tmp_path / "kill.ready")],
                                  timeout_s=240.0), "the mesh never loaded"
    h.kill_rank(2)
    res = h.wait(300)
    assert res.ok, res.tail()
    assert res.returncodes[2] != 0
    r0, r1 = _results(tmp_path, (0, 1))
    got = _exactly_once((r0, r1), len(W.KILL_LENS))
    want = _jax_streams(jax_net, W.prompts_for(W.KILL_LENS))
    for g in want:
        np.testing.assert_array_equal(got[g], want[g])
    for doc in (r0, r1):
        assert sorted(doc["members"]) == ["0", "1"], doc["members"]
        assert doc["member_epoch"] >= 0
    sent = sum(d["handoffs_sent"] - d["handoffs_void_sent"] for d in (r0, r1))
    recv = sum(d["handoffs_recv"] - d["handoffs_void_recv"] for d in (r0, r1))
    assert sent == recv
    redis = {**r0["redispatched"], **r1["redispatched"]}
    assert redis and set(redis.values()) <= {"requeue", "scavenge",
                                             "reprefill"}
    ttft = {**r0["ttft_ms"], **r1["ttft_ms"]}
    assert all(g in ttft for g in redis)


@pytest.mark.multihost
@pytest.mark.slow
def test_join_mid_run_joiner_serves(tmp_path, jax_net):
    """Two ranks drain wave 1; a third joins mid-run, is admitted by a
    member round and serves routed wave-2 traffic."""
    _write_state(jax_net, tmp_path)
    h = mp_mesh.launch_async(2, WORKER, [str(tmp_path), "join"],
                             log_dir=str(tmp_path / "logs"), env_extra=CPU)
    assert mp_mesh.wait_for_files([str(tmp_path / "wave1.done")],
                                  timeout_s=240.0), "wave 1 never drained"
    h.spawn_rank(2, world=3)
    res = h.wait(300)
    assert res.ok, res.tail()
    docs = _results(tmp_path, (0, 1, 2))
    n = len(W.JOIN_WAVE1) + len(W.JOIN_WAVE2)
    got = _exactly_once(docs, n)
    want = _jax_streams(jax_net, W.prompts_for(W.JOIN_WAVE1 + W.JOIN_WAVE2))
    for g in want:
        np.testing.assert_array_equal(got[g], want[g])
    r2 = docs[2]
    assert r2["results"], "the joiner served nothing"
    assert all(int(g) >= len(W.JOIN_WAVE1) for g in r2["results"])
    for doc in docs:
        assert sorted(doc["members"]) == ["0", "1", "2"], doc["members"]
        assert doc["member_epoch"] >= 0


def test_launcher_verdicts_and_chaos_spec(tmp_path, monkeypatch):
    """MeshResult's verdict: a chaos target must die and every other rank
    exit 0; the chaos spec parses as the reference's."""
    res = mp_mesh.MeshResult({0: 0, 1: 137}, str(tmp_path), (1,), False)
    assert res.ok
    assert not mp_mesh.MeshResult({0: 0, 1: 0}, str(tmp_path), (1,),
                                  False).ok
    assert not mp_mesh.MeshResult({0: 1, 1: 137}, str(tmp_path), (1,),
                                  False).ok
    assert not mp_mesh.MeshResult({0: 0}, str(tmp_path), (), True).ok
    monkeypatch.setenv(mp_mesh.CHAOS_ENV, "hang:2:pre_vote:1.5")
    assert mp_mesh.chaos_spec() == ("hang", 2, "pre_vote", 1.5)
    monkeypatch.setenv(mp_mesh.CHAOS_ENV, "boom:1:x")
    with pytest.raises(ValueError):
        mp_mesh.chaos_spec()
