"""The port's elastic serving mesh and prefix routing on a live mesh, held
against the JAX package (counterparts of ``tests/test_elastic_serving.py``
and ``TestPrefixEconomyMesh`` of ``tests/test_prefix_economy.py``).

Logical ranks drive their ``DisaggServer`` step by step over one shared
board, so every death interleaving is exact: died before export (the
orphan re-routes from its prompt), died mid-handoff (a surviving KV file
addressed to the corpse is scavenged), died while decoding (re-prefill),
the ledgers' voids, and a joiner admitted mid-run. Each case finishes
every gid exactly once on the survivors, with clean pool audits, and the
streams bitwise the JAX single engine's (gpt_tiny at 0.2 init, weights
carried by ``load_reference_state``).
"""
import os
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import ServingConfig as JConfig
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import disagg as jd
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.profiler import events as pevents
from paddle_tpu_torch.profiler.metrics import registry
from paddle_tpu_torch.serving import (DisaggServer, MeshSpec, ServingConfig,
                                      ServingEngine, route_requests)
from paddle_tpu_torch.serving.disagg import _member_reducer

CFG = dict(num_slots=2, page_size=8, pages_per_slot=4, prefill_chunk=8)
MAX_NEW = 6


@pytest.fixture(autouse=True)
def _process_state():
    """Adopted epochs and the clock state are process-wide (the sink and
    the flight recorder read them): leave them as this test found them."""
    from paddle_tpu_torch.distributed import consensus as _c
    from paddle_tpu_torch.profiler import disttrace as _dt

    adopted, clock = _c.adopted_epochs(), _dt.clock_state()
    yield
    with _c._ADOPTED_LOCK:
        _c._ADOPTED.clear()
        _c._ADOPTED.update(adopted)
    _dt.set_clock_state(clock["offset_s"], clock["unc_s"], ref=clock["ref"],
                        synced=clock["synced"])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    paddle.seed(0)
    jnet = jgpt.gpt_tiny(initializer_range=0.2)
    jnet.eval()
    net = tgpt.gpt_tiny(device="cpu", initializer_range=0.2)
    tgpt.load_reference_state(
        net, {k: np.asarray(v._value) for k, v in jnet.state_dict().items()})
    net.eval()
    return jnet, net


def _prompts(lens, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (t,)).astype(np.int32) for t in lens]


def _jax_single(jnet, prompts, max_new=MAX_NEW):
    eng = JEngine(jnet, JConfig(**CFG))
    rids = [eng.submit(p, max_new) for p in prompts]
    out = eng.run()
    return {g: np.asarray(out[r]) for g, r in enumerate(rids)}


def _mesh(tmp_path, net, ranks, world, prefill_ranks=(0,), **kw):
    kw.setdefault("lease_s", 0.5)
    return [DisaggServer(net, ServingConfig(**CFG),
                         MeshSpec(r, world, prefill_ranks=prefill_ranks),
                         str(tmp_path), **kw) for r in ranks]


def _kill(srv):
    """An in-process death: the heartbeat stops and the lease is backdated
    past any staleness window, as a killed process leaves the board. The
    server is never stepped again."""
    srv.close()
    lease = os.path.join(srv.consensus.dir, f"lease.{srv.mesh.rank}")
    t = time.time() - 60.0
    os.utime(lease, (t, t))


def _drive(servers, pred, timeout_s=120.0, label=""):
    deadline = time.monotonic() + timeout_s
    while not pred():
        for s in servers:
            s.step()
        if time.monotonic() > deadline:
            raise AssertionError(
                f"drive timeout ({label}): " + " | ".join(
                    f"r{s.mesh.rank} unrouted={len(s._unrouted())} "
                    f"requeued={sorted(s._requeued)} "
                    f"members={sorted(s._members)} "
                    f"served={sorted(s.results())} "
                    f"verdict={s._done_verdict}" for s in servers))


def _merged_exactly_once(servers, n):
    merged = {}
    for s in servers:
        for g, out in s.results().items():
            assert g not in merged, f"gid {g} finished on two ranks"
            merged[g] = out
    assert sorted(merged) == list(range(n)), sorted(merged)
    return merged


def _assert_streams(merged, want):
    for g, out in merged.items():
        np.testing.assert_array_equal(out, want[g],
                                      err_msg=f"gid {g} diverged")


def _close_all(servers):
    for s in servers:
        s.close()


class TestMemberReducer:
    def test_join_unions_member_tables(self):
        votes = {0: {"members": {"0": "prefill", "1": "decode"}, "me": 0,
                     "role": "prefill", "dead": [], "routed": 7},
                 1: {"members": {"0": "prefill", "1": "decode"}, "me": 1,
                     "role": "decode", "dead": [], "routed": 7},
                 2: {"members": {"2": "decode"}, "me": 2, "role": "decode",
                     "dead": [], "routed": 0}}
        v = _member_reducer(votes)
        assert v == jd._member_reducer(votes)
        assert v["members"] == {"0": "prefill", "1": "decode", "2": "decode"}
        assert v["dead"] == [] and v["routed"] == 7

    def test_dead_leaves_and_voters_never_die(self):
        full = {"0": "prefill", "1": "decode", "2": "decode"}
        votes = {0: {"members": full, "me": 0, "role": "prefill",
                     "dead": [2], "routed": 3},
                 1: {"members": full, "me": 1, "role": "decode",
                     "dead": [0, 2], "routed": 3}}
        v = _member_reducer(votes)
        assert v["members"] == {"0": "prefill", "1": "decode"}
        assert v["dead"] == [2]

    def test_deterministic_across_voter_order(self):
        votes = {r: {"members": {"0": "decode", "1": "decode"}, "me": r,
                     "role": "decode", "dead": [], "routed": 2}
                 for r in (0, 1)}
        assert _member_reducer(votes) == _member_reducer(
            dict(sorted(votes.items(), reverse=True)))


class TestRouteRequestsElastic:
    def _vote(self, seen, routed, pending, requeue=(), decode=(1, 2)):
        return {"seen": seen, "routed": routed,
                "pending": {str(g): ln for g, ln in pending.items()},
                "requeue": list(requeue), "free_pages": 100,
                "free_slots": 4, "queued": 0,
                "topology": {"prefill": [0], "decode": list(decode),
                             "threshold": 9}}

    def test_hwm_is_max_of_voters(self):
        votes = {0: self._vote(4, 4, {}), 1: self._vote(4, 4, {}),
                 2: self._vote(4, 0, {0: 4, 1: 4, 2: 4, 3: 4})}
        v = route_requests(votes)
        assert v == jd.route_requests(votes)
        assert v["assign"] == {} and v["routed"] == 4

    def test_requeued_gids_are_rerouted(self):
        votes = {0: self._vote(4, 4, {1: 16, 3: 4}, requeue=[1, 3],
                               decode=(1,)),
                 1: self._vote(4, 4, {1: 16, 3: 4}, requeue=[1],
                               decode=(1,))}
        v = route_requests(votes)
        assert v == jd.route_requests(votes)
        assert sorted(v["assign"]) == ["1", "3"]
        assert v["assign"]["1"] == [0, 1] and v["assign"]["3"] == [-1, 1]
        assert v["routed"] == 4

    def test_requeue_without_lens_is_skipped(self):
        votes = {0: self._vote(2, 2, {}, requeue=[0], decode=(1,))}
        assert route_requests(votes)["assign"] == {}


class TestDeadRankRedispatch:
    LENS = (16, 4, 12)

    def _submit_all(self, servers, prompts):
        for s in servers:
            for p in prompts:
                s.submit(p, MAX_NEW)

    def _finish(self, live, want, n):
        _drive(live, lambda: all(s._done_verdict for s in live),
               label="post-kill drain")
        merged = _merged_exactly_once(live, n)
        _assert_streams(merged, want)
        for s in live:
            assert s.check_consistency() == []
            assert sorted(s._members) == sorted(x.mesh.rank for x in live)
        return merged

    @pytest.fixture(scope="class")
    def want(self, nets):
        return _jax_single(nets[0], _prompts(self.LENS))

    def test_died_before_export_requeues_from_scratch(self, nets, want,
                                                      tmp_path):
        net = nets[1]
        prompts = _prompts(self.LENS)
        servers = _mesh(tmp_path, net, range(3), 3)
        try:
            seq0 = pevents.log().next_seq
            self._submit_all(servers, prompts)
            # hold every export back so the death lands before any KV
            # file exists: the orphan re-routes from its prompt alone
            servers[0]._export_held, orig = (
                lambda: None), servers[0]._export_held
            _drive(servers, lambda: all(len(s._assignments) == len(prompts)
                                        for s in servers), label="routing")
            victims = [g for g, (_p, d) in servers[0]._assignments.items()
                       if d == 2]
            assert victims, "routing sent nothing to rank 2"
            _kill(servers[2])
            servers[0]._export_held = orig
            live = servers[:2]
            self._finish(live, want, len(prompts))
            redis = {**live[0].redispatched, **live[1].redispatched}
            assert set(victims) <= set(redis)
            assert all(m == "requeue" for g, m in redis.items()
                       if g in victims)
            kinds = [e.kind for e in pevents.log().events(since_seq=seq0)]
            assert "member_leave" in kinds and "redispatch" in kinds
        finally:
            _close_all(servers)

    def test_died_mid_handoff_scavenges_surviving_kv(self, nets, want,
                                                     tmp_path):
        net = nets[1]
        prompts = _prompts(self.LENS)
        servers = _mesh(tmp_path, net, range(3), 3)
        try:
            self._submit_all(servers, prompts)
            # rank 2 votes but never consumes its arrivals: the exported
            # payload outlives it on the channel
            servers[2]._import_arrivals = lambda: None
            handoff = os.path.join(str(tmp_path), "handoff")
            _drive(servers, lambda: any(n.endswith("-to2.npz")
                                        for n in os.listdir(handoff)),
                   label="export lands")
            orphan = [int(n[2:10]) for n in os.listdir(handoff)
                      if n.endswith("-to2.npz")]
            _kill(servers[2])
            before = registry().counter("serving/handoffs_scavenged").value
            self._finish(servers[:2], want, len(prompts))
            assert registry().counter(
                "serving/handoffs_scavenged").value > before
            assert any(servers[1].redispatched.get(g) == "scavenge"
                       for g in orphan)
        finally:
            _close_all(servers)

    def test_died_while_decoding_reprefills_honestly(self, nets, want,
                                                     tmp_path):
        net = nets[1]
        prompts = _prompts(self.LENS)
        servers = _mesh(tmp_path, net, range(3), 3)
        try:
            self._submit_all(servers, prompts)
            _drive(servers, lambda: servers[2].handoffs_recv >= 1,
                   label="import lands")
            for _ in range(3):
                servers[2].step()
            _kill(servers[2])
            live = servers[:2]
            merged = self._finish(live, want, len(prompts))
            redis = {**live[0].redispatched, **live[1].redispatched}
            assert redis and set(redis) <= set(merged)
            ttfts = {**live[0].ttfts(), **live[1].ttfts()}
            assert set(redis) <= set(ttfts)
        finally:
            _close_all(servers)

    def test_ledgers_rebalance_with_voids(self, nets, want, tmp_path):
        net = nets[1]
        prompts = _prompts(self.LENS)
        servers = _mesh(tmp_path, net, range(3), 3)
        try:
            self._submit_all(servers, prompts)
            _drive(servers, lambda: servers[2].handoffs_recv >= 1,
                   label="import lands")
            _kill(servers[2])
            live = servers[:2]
            self._finish(live, want, len(prompts))
            sent = sum(s.handoffs_sent - s.handoffs_void_sent for s in live)
            recv = sum(s.handoffs_recv - s.handoffs_void_recv for s in live)
            assert sent == recv
            assert any(s.handoffs_void_sent for s in live)
        finally:
            _close_all(servers)


class TestJoinMidRun:
    def test_joiner_is_admitted_and_serves(self, nets, tmp_path):
        jnet, net = nets
        wave1 = _prompts((4, 6), seed=3)
        wave2 = _prompts((4, 6, 5, 7, 4, 6), seed=5)
        prompts = wave1 + wave2
        seq0 = pevents.log().next_seq
        servers = _mesh(tmp_path, net, range(2), 2, prefill_ranks=())
        try:
            for s in servers:
                for p in wave1:
                    s.submit(p, MAX_NEW)
            _drive(servers, lambda: all(s._done_verdict for s in servers),
                   label="wave1")
            joiner = _mesh(tmp_path, net, [2], 3, prefill_ranks=(),
                           join=True)[0]
            servers.append(joiner)
            assert not joiner._joined
            for p in wave1:
                joiner.submit(p, MAX_NEW)
            _drive(servers, lambda: joiner._joined, label="admission")
            for s in servers:
                for p in wave2:
                    s.submit(p, MAX_NEW)
            _drive(servers, lambda: all(s._done_verdict for s in servers),
                   label="wave2")
            for s in servers:
                assert sorted(s._members) == [0, 1, 2]
            merged = _merged_exactly_once(servers, len(prompts))
            _assert_streams(merged, _jax_single(jnet, prompts))
            assert joiner.results(), "the joiner served nothing"
            kinds = [e.kind for e in pevents.log().events(since_seq=seq0)]
            assert "member_join" in kinds
        finally:
            _close_all(servers)

    def test_joiner_never_reroutes_assigned_work(self, nets, tmp_path):
        net = nets[1]
        prompts = _prompts((4, 6, 5), seed=7)
        servers = _mesh(tmp_path, net, range(2), 2, prefill_ranks=())
        try:
            for s in servers:
                for p in prompts:
                    s.submit(p, MAX_NEW)
            _drive(servers, lambda: all(s._done_verdict for s in servers),
                   label="pre-join drain")
            hwm = servers[0]._routed_hwm
            joiner = _mesh(tmp_path, net, [2], 3, prefill_ranks=(),
                           join=True)[0]
            servers.append(joiner)
            for p in prompts:
                joiner.submit(p, MAX_NEW)
            _drive(servers, lambda: joiner._joined, label="admission")
            assert joiner._routed_hwm >= hwm
            _drive(servers, lambda: all(s._done_verdict for s in servers),
                   label="post-join drain")
            _merged_exactly_once(servers, len(prompts))
            assert not joiner.results()
        finally:
            _close_all(servers)


class TestPrefixEconomyMesh:
    def test_cross_rank_economy_end_to_end(self, nets, tmp_path):
        """A shared system prompt on a symmetric two-rank mesh with prefix
        routing on: the streams stay the JAX single engine's, prefix hits
        accrue, the mesh index converges, a directed migration lands on
        the peer under clean audits, and evicting published chains counts
        withdrawals."""
        jnet, net = nets
        sys_prefix = _prompts((16,), seed=11)[0]
        tails = _prompts((8, 8, 8, 8), seed=12)
        prompts = [np.concatenate([sys_prefix, t]).astype(np.int32)
                   for t in tails]
        want = _jax_single(jnet, prompts, 4)
        servers = [DisaggServer(net, ServingConfig(**CFG), MeshSpec(r, 2),
                                str(tmp_path), lease_s=2.0,
                                prefix_routing=True, prefix_publish_s=0.05)
                   for r in range(2)]
        try:
            for s in servers:
                for p in prompts:
                    s.submit(p, 4)
            hits0 = registry().counter("serving/prefix_hit_tokens").value
            _drive(servers, lambda: all(s._done_verdict for s in servers),
                   label="economy")
            merged = _merged_exactly_once(servers, len(prompts))
            _assert_streams(merged, want)
            assert registry().counter(
                "serving/prefix_hit_tokens").value > hits0
            for s in servers:
                assert s.check_consistency() == []

            def adopted():
                return all(any((s._prefix_index.get(r) or {}).get("chains")
                               for r in ("0", "1")) for s in servers)

            _drive(servers, adopted, timeout_s=30.0, label="index")
            src, dst = servers
            gids = sorted(set(src._local.values()))
            assert gids, "rank 0 served nothing"
            sent0 = src.prefix_migrations_out
            src._migrate_out = {gids[0]: 1}
            src._export_migrations()
            assert src.prefix_migrations_out == sent0 + 1
            assert src.prefix_migration_bytes_out > 0
            got0 = dst.prefix_migrations_in
            dst._import_migrations()
            assert dst.prefix_migrations_in >= got0
            assert dst.check_consistency() == []
            dst._published_chains = set(
                dst.engine.pool.prefix.digest()["chains"])
            assert dst._published_chains
            sd0 = dst.stale_digest_withdrawals
            assert dst.engine.pool.drop_prefix_cache() > 0
            assert dst.stale_digest_withdrawals > sd0
            assert dst._withdrawals_due > 0
            assert dst.check_consistency() == []
            doc = tmp_path / "r0.json"
            src.write_results(str(doc))
            import json
            with open(doc) as f:
                econ = json.load(f)["prefix_economy"]
            assert econ["kv_dtype"] == "float32"
            assert econ["migrations_out"] == src.prefix_migrations_out
        finally:
            _close_all(servers)


def test_single_engine_oracle_is_the_jax_stream(nets):
    """The port's own single engine gives the JAX single engine's streams
    on the elastic workloads, so the mesh cases above hold both."""
    jnet, net = nets
    prompts = _prompts(TestDeadRankRedispatch.LENS)
    eng = ServingEngine(net, ServingConfig(**CFG))
    rids = [eng.submit(p, MAX_NEW) for p in prompts]
    out = eng.run()
    want = _jax_single(jnet, prompts)
    for g, r in enumerate(rids):
        np.testing.assert_array_equal(out[r], want[g])
