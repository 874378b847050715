"""The port's serving mesh (``paddle_tpu_torch/serving/disagg.py``) held
against the JAX package's: ``MeshSpec``, ``HandoffChannel``, the routing
function and the reducers, and ``DisaggServer`` on two or three logical
ranks that are threads over one shared directory (as
``tests/test_disagg.py`` drives them).

- Units and channel: the counterparts of ``TestMeshSpec``,
  ``TestHandoffChannel``, ``TestHandoffRetry`` and ``TestScavenge``.
- Routing: ``route_requests``, ``_chain_hit_tokens`` and the ``clock``,
  ``member``, ``prefix`` and ``done`` reducers equal the reference's on
  seeded random votes (topologies, dead members, requeues, prefix
  digests); the cases of ``TestPrefixRouting`` and ``TestMembersExclusion``.
- Parity: the two-rank streams are bitwise the JAX single engine's on the
  same prompts (gpt_tiny at 0.2 init, its weights carried by
  ``load_reference_state``), disaggregated and symmetric, with
  preemption on the prefill side and on the decode side; ``kv_dtype=
  "int8"`` is held bitwise to the port's own single int8 engine (the
  contract of int8 pages: bitwise between int8 engines of one schedule).
- Channel interop: a file the reference's channel wrote is polled and
  imported by the port and gives the JAX stream, and the other way round,
  over f32 and int8 pages. bf16: a reference file's ``ml_dtypes.bfloat16``
  pages reach the port as 2-byte void records, which its ``poll`` takes
  as the same bits (converted); a port file holds uint16 bits, which the
  reference polls as uint16 and must view as bf16 itself.

The elastic cases (dead ranks, joiners) and prefix routing on a live mesh
are in ``tests/test_torch_elastic_serving.py``.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import HandoffChannel as JChannel
from paddle_tpu.serving import ServingConfig as JConfig
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import disagg as jd
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.profiler.metrics import registry
from paddle_tpu_torch.serving import (DisaggServer, HandoffChannel, MeshSpec,
                                      ServingConfig, ServingEngine,
                                      chain_hashes, disagg as td,
                                      route_requests)
from paddle_tpu_torch.utils.retry import RetryError

CFG = dict(num_slots=2, page_size=8, pages_per_slot=4, prefill_chunk=8)


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
    """One intra-op thread: the test workers share the machine's cores."""
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


def _single(eng, prompts, max_new):
    rids = [eng.submit(p, max_new) for p in prompts]
    out = eng.run()
    return [np.asarray(out[r]) for r in rids]


def _drive_all(servers, timeout_s=120.0):
    """Every logical rank's ``run`` at once; the merged results."""
    outs = [None] * len(servers)
    errs = []

    def drive(i):
        try:
            outs[i] = servers[i].run(timeout_s=timeout_s)
        except Exception as e:      # pragma: no cover - failure detail
            errs.append((i, repr(e)))

    ts = [threading.Thread(target=drive, args=(i,))
          for i in range(len(servers))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs, errs
    merged = {}
    for o in outs:
        for g in o:
            assert g not in merged, f"gid {g} finished on two ranks"
        merged.update(o)
    return merged


def _mesh(net, tmp_path, world, prefill_ranks, cfgs=None, **kw):
    kw.setdefault("lease_s", 2.0)
    cfgs = cfgs or [ServingConfig(**CFG)] * world
    return [DisaggServer(net, cfgs[r], MeshSpec(r, world, prefill_ranks),
                         str(tmp_path), **kw) for r in range(world)]


# ---------------------------------------------------------------------------
# units: the mesh spec and the channel
# ---------------------------------------------------------------------------
class TestMeshSpec:
    def test_validation_equals_reference(self):
        for args in [(2, 2), (0, 2, (5,)), (0, 2, (0, 1)), (-1, 1)]:
            with pytest.raises(ValueError):
                MeshSpec(*args)
            with pytest.raises(ValueError):
                jd.MeshSpec(*args)
        for args in [(0, 3, (1,)), (2, 3, (0, 1)), (1, 2)]:
            a, b = MeshSpec(*args), jd.MeshSpec(*args)
            assert (a.decode_ranks, a.disaggregated, a.is_prefill) == \
                (b.decode_ranks, b.disaggregated, b.is_prefill)

    def test_symmetric_decodes_everywhere(self):
        m = MeshSpec(1, 3)
        assert m.decode_ranks == (0, 1, 2) and not m.disaggregated


PAYLOAD = dict(prompt=np.arange(4, dtype=np.int32), orig_prompt_len=4,
               max_new=3, first_token=7, key=np.zeros(2, np.uint32),
               n_tokens=4, kv_dtype="float32",
               k=np.ones((2, 1, 8, 4, 16), np.float32),
               v=np.ones((2, 1, 8, 4, 16), np.float32))


class TestHandoffChannel:
    def test_send_poll_consumes_and_is_addressed(self, tmp_path):
        a = HandoffChannel(str(tmp_path), 0)
        b = HandoffChannel(str(tmp_path), 1)
        nbytes = a.send(1, 3, {"prompt": np.arange(5, dtype=np.int32),
                               "max_new": 4})
        assert nbytes == 5 * 4 + 8
        assert os.listdir(tmp_path) == ["h-00000003-to1.npz"]
        assert a.poll() == []                      # not addressed to 0
        got = b.poll()
        assert [g for g, _ in got] == [3]
        assert got[0][1]["max_new"] == 4 and isinstance(
            got[0][1]["max_new"], int)
        assert b.poll() == []                      # consumed

    def test_tmp_files_are_invisible(self, tmp_path):
        b = HandoffChannel(str(tmp_path), 1)
        with open(tmp_path / "h-00000001-to1.npz.tmp99", "wb") as f:
            f.write(b"torn")
        assert b.poll() == []

    def test_kinds_never_cross(self, tmp_path):
        a = HandoffChannel(str(tmp_path), 0)
        a.send(1, 2, {"x": np.zeros(2)}, kind="m")
        b = HandoffChannel(str(tmp_path), 1)
        assert b.poll() == []
        assert [g for g, _ in b.poll(kind="m")] == [2]

    def test_file_names_equal_reference(self, tmp_path):
        a = HandoffChannel(str(tmp_path / "a"), 0)
        r = JChannel(str(tmp_path / "r"), 0)
        for kind in ("h", "m"):
            assert os.path.basename(a._path_to(12, 3, kind)) == \
                os.path.basename(r._path_to(12, 3, kind))


class TestHandoffRetry:
    def test_transient_send_errors_backoff_and_count(self, tmp_path,
                                                     monkeypatch):
        ch = HandoffChannel(str(tmp_path), 0)
        ch.retry_base_delay_s = 0.0
        before = registry().counter("serving/handoff_retries").value
        real_rename = os.rename
        fails = {"n": 2}

        def flaky(src, dst):
            if fails["n"] > 0:
                fails["n"] -= 1
                raise OSError(28, "No space left on device")
            return real_rename(src, dst)

        monkeypatch.setattr(os, "rename", flaky)
        ch.send(1, 0, {"max_new": 1, "x": np.zeros(4, np.float32)})
        assert registry().counter("serving/handoff_retries").value - \
            before == 2
        monkeypatch.undo()
        assert [g for g, _ in HandoffChannel(str(tmp_path), 1).poll()] == [0]

    def test_exhausted_retries_surface(self, tmp_path, monkeypatch):
        ch = HandoffChannel(str(tmp_path), 0)
        ch.retry_attempts = 2
        ch.retry_base_delay_s = 0.0

        def always(src, dst):
            raise OSError(4, "Interrupted system call")

        monkeypatch.setattr(os, "rename", always)
        with pytest.raises(RetryError):
            ch.send(1, 0, {"max_new": 1, "x": np.zeros(4, np.float32)})


class TestScavenge:
    def test_claims_and_readdresses(self, tmp_path):
        HandoffChannel(str(tmp_path), 0).send(2, 5, dict(PAYLOAD))
        claimer = HandoffChannel(str(tmp_path), 1)
        n0 = registry().counter("serving/handoffs_scavenged").value
        assert claimer.scavenge(5, 2)
        assert registry().counter("serving/handoffs_scavenged").value == n0 + 1
        assert HandoffChannel(str(tmp_path), 2).poll() == []
        assert [g for g, _ in claimer.poll()] == [5]

    def test_missing_file_is_not_claimed(self, tmp_path):
        assert not HandoffChannel(str(tmp_path), 1).scavenge(9, 2)

    def test_torn_payload_is_deleted_not_imported(self, tmp_path):
        bad = dict(PAYLOAD)
        del bad["k"]
        HandoffChannel(str(tmp_path), 0).send(2, 7, bad)
        claimer = HandoffChannel(str(tmp_path), 1)
        before = registry().counter("serving/handoff_scavenge_failed").value
        assert not claimer.scavenge(7, 2)
        assert registry().counter(
            "serving/handoff_scavenge_failed").value == before + 1
        assert claimer.poll() == []
        assert not any(n.endswith(".npz") for n in os.listdir(tmp_path))


# ---------------------------------------------------------------------------
# routing and the reducers against the reference's, on random votes
# ---------------------------------------------------------------------------
def _random_votes(rng, hashes):
    world = int(rng.randint(1, 5))
    ranks = list(range(world))
    prefill = sorted(rng.choice(world, int(rng.randint(0, world)),
                                replace=False).tolist())
    decode = [r for r in ranks if r not in prefill]
    threshold = int(rng.randint(4, 20))
    routed = int(rng.randint(0, 4))
    members = sorted(r for r in ranks if rng.rand() < 0.85) or [0]
    voters = sorted(rng.choice(world, int(rng.randint(1, world + 1)),
                               replace=False).tolist())
    votes = {}
    for r in voters:
        seen = routed + int(rng.randint(0, 6))
        pending = {str(g): int(rng.randint(1, 40))
                   for g in range(routed, seen)}
        v = {"seen": seen, "routed": routed - int(rng.randint(0, 2)),
             "pending": pending,
             "requeue": sorted(rng.choice(max(routed, 1),
                                          int(rng.randint(0, 2)),
                                          replace=False).tolist())
             if routed else [],
             "free_pages": int(rng.randint(0, 64)),
             "free_slots": int(rng.randint(0, 4)),
             "queued": int(rng.randint(0, 5)),
             "prefill_backlog": int(rng.randint(0, 200)),
             "ttft_p95_ms": float(np.round(rng.rand() * 50, 3)),
             "chunk": 8, "page_size": 8,
             "topology": {"prefill": prefill, "decode": decode,
                          "threshold": threshold}}
        for g in v["requeue"]:
            v["pending"][str(g)] = int(rng.randint(1, 40))
        if rng.rand() < 0.7:
            v["members"] = members
        if rng.rand() < 0.6:
            v["chains"] = {g: [hashes[i] for i in
                               range(int(rng.randint(1, len(hashes))))]
                           for g in pending}
        votes[r] = v
    index = {str(r): {"page_size": 8,
                      "chains": {h: 8 * (i + 1) for i, h in enumerate(hashes)
                                 if rng.rand() < 0.7}}
             for r in ranks if rng.rand() < 0.6}
    return votes, index


@pytest.mark.parametrize("seed", range(6))
def test_route_requests_equals_reference_on_random_votes(seed):
    rng = np.random.RandomState(seed)
    hashes = chain_hashes(np.arange(48, dtype=np.int32), 8)
    for _ in range(40):
        votes, index = _random_votes(rng, hashes)
        for idx in (None, index):
            assert route_requests(votes, prefix_index=idx) == \
                jd.route_requests(votes, prefix_index=idx)
        for g in ("0", "1"):
            chain = [hashes[i] for i in range(int(rng.randint(0, 6)))]
            for dig in index.values():
                assert td._chain_hit_tokens(chain, dig) == \
                    jd._chain_hit_tokens(chain, dig), g


@pytest.mark.parametrize("seed", range(4))
def test_reducers_equal_reference_on_random_votes(seed):
    rng = np.random.RandomState(seed)
    hashes = chain_hashes(np.arange(32, dtype=np.int32), 8)
    for _ in range(40):
        ranks = sorted(rng.choice(5, int(rng.randint(1, 5)),
                                  replace=False).tolist())
        clock = {r: {"offset_s": float(rng.randn()), "unc_s": float(rng.rand()),
                     "ref": 0} for r in ranks}
        member = {}
        for r in ranks:
            v = {"members": {str(m): ("prefill" if rng.rand() < 0.3
                                      else "decode")
                             for m in range(5) if rng.rand() < 0.6},
                 "dead": sorted(rng.choice(5, int(rng.randint(0, 3)),
                                           replace=False).tolist()),
                 "routed": int(rng.randint(0, 9))}
            if rng.rand() < 0.8:
                v["me"], v["role"] = r, "decode" if rng.rand() < 0.7 \
                    else "prefill"
            member[r] = v
        prefix = {r: {"digest": {"page_size": 8, "chains": {
            h: 8 * (i + 1) for i, h in enumerate(hashes) if rng.rand() < 0.5}}}
            for r in ranks}
        done = {r: {"idle": bool(rng.rand() < 0.8),
                    "sent": int(rng.randint(0, 3)),
                    "recv": int(rng.randint(0, 3)),
                    "void_sent": int(rng.randint(0, 2)),
                    "void_recv": int(rng.randint(0, 2)),
                    "served": int(rng.randint(0, 3)),
                    "seen": 4, "routed": 4 if rng.rand() < 0.8 else 3}
                for r in ranks}
        for name, votes in (("_clock_reducer", clock),
                            ("_member_reducer", member),
                            ("_prefix_reducer", prefix),
                            ("_done_reducer", done)):
            assert getattr(td, name)(dict(votes)) == \
                getattr(jd, name)(dict(votes)), name


class TestPrefixRouting:
    def _vote(self, seen, routed, pending, *, backlog=0, fs=4,
              members=None, chains=None, decode=(0, 1), prefill=()):
        v = {"seen": seen, "routed": routed,
             "pending": {str(g): ln for g, ln in pending.items()},
             "free_pages": 100, "free_slots": fs, "queued": 0,
             "prefill_backlog": backlog, "chunk": 8, "page_size": 8,
             "topology": {"prefill": list(prefill),
                          "decode": list(decode), "threshold": 9}}
        if members is not None:
            v["members"] = sorted(members)
        if chains is not None:
            v["chains"] = {str(g): list(c) for g, c in chains.items()}
        return v

    def _chain(self, n=24):
        return chain_hashes(np.arange(n, dtype=np.int32), 8)

    def _digest(self, chain):
        return {"page_size": 8,
                "chains": {h: (i + 1) * 8 for i, h in enumerate(chain)}}

    def test_affinity_breaks_a_load_tie(self):
        chain = self._chain()
        votes = {r: self._vote(1, 0, {0: 24}, chains={0: chain})
                 for r in (0, 1)}
        assert route_requests(votes)["assign"]["0"] == [-1, 0]
        out = route_requests(votes, prefix_index={"1": self._digest(chain)})
        assert out["assign"]["0"] == [-1, 1] and "migrate" not in out

    def test_load_outweighs_affinity_and_directs_migration(self):
        chain = self._chain()
        votes = {0: self._vote(1, 0, {0: 24}, chains={0: chain}),
                 1: self._vote(1, 0, {0: 24}, chains={0: chain},
                               backlog=64)}
        out = route_requests(votes, prefix_index={"1": self._digest(chain)})
        assert out["assign"]["0"] == [-1, 0]
        assert out["migrate"] == {"0": [1, 0]}

    def test_no_migration_when_runner_matches_best(self):
        chain = self._chain()
        votes = {r: self._vote(1, 0, {0: 24}, chains={0: chain})
                 for r in (0, 1)}
        idx = {"0": self._digest(chain), "1": self._digest(chain)}
        assert "migrate" not in route_requests(votes, prefix_index=idx)

    def test_broken_chain_stops_the_hit_at_the_gap(self):
        chain = self._chain()
        holed = self._digest(chain)
        del holed["chains"][chain[1]]
        votes = {r: self._vote(1, 0, {0: 24}, chains={0: chain}, backlog=8)
                 for r in (0, 1)}
        assert td._chain_hit_tokens(chain, holed) == 8
        out = route_requests(votes, prefix_index={"1": holed})
        assert out["assign"]["0"] == [-1, 1]

    def test_decision_is_voter_order_deterministic(self):
        chain = self._chain()
        votes = {0: self._vote(2, 0, {0: 24, 1: 16}, chains={0: chain}),
                 1: self._vote(2, 0, {0: 24, 1: 16}, chains={0: chain},
                               backlog=64)}
        idx = {"1": self._digest(chain)}
        assert route_requests(votes, prefix_index=idx) == route_requests(
            dict(reversed(list(votes.items()))), prefix_index=idx)


class TestMembersExclusion:
    _vote = TestPrefixRouting._vote

    def test_stale_vote_of_evicted_rank_gets_nothing(self):
        votes = {0: self._vote(4, 0, {g: 8 for g in range(4)},
                               members=(0, 1), decode=(0, 1, 2)),
                 1: self._vote(4, 0, {g: 8 for g in range(4)},
                               members=(0, 1), decode=(0, 1, 2)),
                 2: self._vote(1, 0, {0: 8}, members=(0, 1, 2),
                               decode=(0, 1, 2))}
        out = route_requests(votes)
        assert out["routed"] == 4 and len(out["assign"]) == 4
        assert all(2 not in pair for pair in out["assign"].values())

    def test_no_member_decode_rank_parks_the_round(self):
        votes = {0: self._vote(2, 0, {0: 8, 1: 8}, members=(0,),
                               decode=(1,), prefill=(0,))}
        out = route_requests(votes)
        assert out["assign"] == {} and out["routed"] == 0

    def test_votes_without_members_keep_old_pricing(self):
        votes = {0: self._vote(2, 0, {0: 16, 1: 4}, decode=(0, 1))}
        out = route_requests(votes)
        assert all(d == 0 for _, d in out["assign"].values())
        assert out["routed"] == 2


# ---------------------------------------------------------------------------
# DisaggServer parity against the JAX single engine
# ---------------------------------------------------------------------------
class TestDisaggServerParity:
    def test_two_rank_disagg_bitwise_vs_jax_single_engine(self, nets,
                                                          tmp_path):
        jnet, net = nets
        prompts = _prompts((8, 16, 12, 20, 6))
        want = _single(JEngine(jnet, JConfig(**CFG)), prompts, 8)
        reg = registry()
        b0 = reg.counter("serving/handoff_bytes_in").value
        servers = _mesh(net, tmp_path, 2, (0,))
        for s in servers:
            for p in prompts:
                s.submit(p, 8)
        merged = _drive_all(servers)
        assert sorted(merged) == list(range(len(prompts)))
        for g, w in enumerate(want):
            np.testing.assert_array_equal(merged[g], w)
        long_ = [g for g, p in enumerate(prompts) if len(p) > 8]
        assert servers[0].handoffs_sent == servers[1].handoffs_recv == \
            len(long_)
        assert not servers[0].results()           # the prefill rank owns none
        per_page = 2 * net.config.num_layers * 8 * net.config.hidden_size * 4
        assert reg.counter("serving/handoff_bytes_in").value - b0 == \
            per_page * sum(-(-len(prompts[g]) // 8) for g in long_)
        # the decode rank owns every TTFT; the handed-off ones carry an
        # uncertainty and ordered bounds
        assert sorted(servers[1].ttfts()) == list(range(len(prompts)))
        assert sorted(servers[1].ttft_uncs()) == long_
        for g, (lo, t, hi) in servers[1].ttft_bounds().items():
            assert lo <= t <= hi and t > 0
        for s in servers:
            assert s.check_consistency() == []
            s.close()

    def test_symmetric_two_rank_bitwise(self, nets, tmp_path):
        jnet, net = nets
        prompts = _prompts((8, 16, 12, 6))
        want = _single(JEngine(jnet, JConfig(**CFG)), prompts, 8)
        servers = _mesh(net, tmp_path, 2, ())
        for s in servers:
            for p in prompts:
                s.submit(p, 8)
        merged = _drive_all(servers)
        for g, w in enumerate(want):
            np.testing.assert_array_equal(merged[g], w)
        assert servers[0].handoffs_sent == servers[1].handoffs_sent == 0
        assert all(s.results() for s in servers)   # load split both ways
        for s in servers:
            s.close()

    @pytest.mark.parametrize("side", ["prefill", "decode"])
    def test_preemption_on_either_side_still_bitwise(self, nets, tmp_path,
                                                     side):
        """A starved pool on the prefill rank (holds in flight) or on the
        decode rank (imports growing while decoding) preempts; the
        streams stay the JAX single engine's, which never preempted."""
        jnet, net = nets
        big = dict(CFG, pages_per_slot=6)
        if side == "prefill":
            prompts, max_new = _prompts((40, 40, 40), seed=5), 4
            tiny = dict(big, num_pages=9)
        else:
            prompts, max_new = _prompts((20, 20, 20), seed=6), 20
            tiny = dict(big, num_pages=8)
        want = _single(JEngine(jnet, JConfig(**big)), prompts, max_new)
        cfgs = [ServingConfig(**tiny), ServingConfig(**big)]
        if side == "decode":
            cfgs.reverse()
        pre0 = registry().counter("serving/preemptions").value
        servers = _mesh(net, tmp_path, 2, (0,), cfgs=cfgs)
        for s in servers:
            for p in prompts:
                s.submit(p, max_new)
        merged = _drive_all(servers)
        for g, w in enumerate(want):
            np.testing.assert_array_equal(merged[g], w)
        assert registry().counter("serving/preemptions").value > pre0
        assert servers[1].handoffs_recv == len(prompts)
        for s in servers:
            assert s.check_consistency() == []
            s.close()

    def test_disagg_int8_bitwise_vs_port_single_int8(self, nets, tmp_path):
        """int8 pages ride the handoff with their scales: the streams are
        bitwise the port's single int8 engine's (contention-free sizing:
        int8 bitwise equality holds between engines of one schedule), and
        the bytes moved are int8 values plus f32 scales."""
        _, net = nets
        prompts = _prompts((8, 16, 12))
        cfg = dict(CFG, num_slots=3, kv_dtype="int8", prefix_cache=False)
        want = _single(ServingEngine(net, ServingConfig(**cfg)), prompts, 8)
        b0 = registry().counter("serving/handoff_bytes_in").value
        servers = _mesh(net, tmp_path, 2, (0,),
                        cfgs=[ServingConfig(**cfg)] * 2)
        for s in servers:
            for p in prompts:
                s.submit(p, 8)
        merged = _drive_all(servers)
        for g, w in enumerate(want):
            np.testing.assert_array_equal(merged[g], w)
        nh = net.config.num_heads
        hd = net.config.hidden_size // nh
        pages = sum(-(-len(p) // 8) for p in prompts if len(p) > 8)
        int8_bytes = pages * 2 * net.config.num_layers * (8 * nh * hd + nh * 4)
        assert registry().counter("serving/handoff_bytes_in").value - b0 == \
            int8_bytes
        for s in servers:
            assert s.check_consistency() == []
            s.close()

    def test_assignment_arriving_before_submit_is_parked(self, nets,
                                                         tmp_path):
        """A rank routed a gid before its driver submitted it parks the
        assignment and applies it at ``submit``; nothing is orphaned."""
        jnet, net = nets
        prompts = _prompts((8, 12))
        servers = _mesh(net, tmp_path, 2, (), lease_s=30.0)
        for s in servers:
            s.consensus.window_s = 0.3
        for p in prompts:
            servers[0].submit(p, 4)
        deadline = time.time() + 60
        while not servers[0]._assignments and time.time() < deadline:
            servers[0].step()
        assert servers[0]._assignments
        while not servers[1]._assignments and time.time() < deadline:
            servers[1]._admission_round()
            time.sleep(0.01)
        assert servers[1]._assignments and not servers[1]._local
        assert servers[1]._routed_hwm == 2
        for p in prompts:
            servers[1].submit(p, 4)
        owned = [g for g, (_p, d) in servers[1]._assignments.items()
                 if d == 1]
        assert sorted(servers[1]._local.values()) == sorted(owned)
        merged = _drive_all(servers)
        want = _single(JEngine(jnet, JConfig(**CFG)), prompts, 4)
        for g, w in enumerate(want):
            np.testing.assert_array_equal(merged[g], w)
        for s in servers:
            s.close()

    def test_reset_results_prunes_collected_state(self, nets, tmp_path):
        _, net = nets
        srv = DisaggServer(net, ServingConfig(**CFG), MeshSpec(0, 1),
                           str(tmp_path), lease_s=2.0)
        for p in _prompts((8, 12)):
            srv.submit(p, 4)
        srv.run(timeout_s=60)
        assert len(srv.results()) == 2 and srv._served_total == 2
        srv.reset_results()
        assert not srv._local and not srv._reqs and not srv._collected
        assert srv._served_total == 2
        assert not srv.engine._requests
        g = srv.submit(_prompts((8,), seed=9)[0], 3)
        assert g in srv.run(timeout_s=60)
        doc_path = tmp_path / "res.json"
        srv.write_results(str(doc_path))
        import json
        with open(doc_path) as f:
            doc = json.load(f)
        assert doc["rank"] == 0 and str(g) in doc["results"]
        assert doc["clock"]["synced"] and doc["clock"]["offset_s"] == 0.0
        srv.close()


# ---------------------------------------------------------------------------
# the channel across packages
# ---------------------------------------------------------------------------
def _export_all(eng, prompts, max_new):
    rids = [eng.submit(p, max_new, hold_after_prefill=True) for p in prompts]
    payloads = {}
    for _ in range(200):
        eng.step()
        eng.drain(0)
        for rid in list(eng.held_ready()):
            payloads[rid] = eng.export_held(rid)
            eng.release_exported(rid)
        if len(payloads) == len(prompts):
            break
    return [payloads[r] for r in rids]


def _import_all(eng, arrivals, max_new):
    local = {}
    pending = list(arrivals)
    while pending or not eng.idle():
        nxt = []
        for gid, pl in pending:
            lr = eng.admit_prefilled(pl)
            if lr is None:
                nxt.append((gid, pl))
            else:
                local[lr] = gid
        pending = nxt
        if not eng.step() and eng._inflight:
            eng.drain(0)
    eng.drain(0)
    return {g: np.asarray(eng._requests[lr].out, np.int32)
            for lr, g in local.items()}


KV = {"f32": None, "bf16": "bf16", "int8": "int8"}


@pytest.mark.parametrize("kv", sorted(KV))
@pytest.mark.parametrize("way", ["reference_to_port", "port_to_reference"])
def test_channel_interop_gives_the_reference_stream(nets, tmp_path, way, kv):
    jnet, net = nets
    cfg = dict(CFG, kv_dtype=KV[kv])
    prompts = _prompts((8, 16, 12))
    want = _single(JEngine(jnet, JConfig(**cfg)), prompts, 6)
    if way == "reference_to_port":
        pe, send_ch = JEngine(jnet, JConfig(**cfg)), JChannel
        de, recv_ch = ServingEngine(net, ServingConfig(**cfg)), HandoffChannel
    else:
        pe, send_ch = ServingEngine(net, ServingConfig(**cfg)), HandoffChannel
        de, recv_ch = JEngine(jnet, JConfig(**cfg)), JChannel
    tx = send_ch(str(tmp_path), 0)
    for g, pl in enumerate(_export_all(pe, prompts, 6)):
        tx.send(1, g, pl)
    arrivals = recv_ch(str(tmp_path), 1).poll()
    assert sorted(g for g, _ in arrivals) == [0, 1, 2]
    assert os.listdir(tmp_path) == []              # every file consumed
    if kv == "bf16":
        # both directions carry the same bits; only their numpy type
        # differs: the port's poll converts the reference's void records
        # to uint16, and the reference takes the port's uint16 as they are
        assert all(pl["k"].dtype == np.uint16 for _, pl in arrivals)
        if way == "port_to_reference":
            import jax.numpy as jnp

            arrivals = [(g, dict(pl, k=pl["k"].view(jnp.bfloat16),
                                 v=pl["v"].view(jnp.bfloat16)))
                        for g, pl in arrivals]
    got = _import_all(de, arrivals, 6)
    for g, w in enumerate(want):
        np.testing.assert_array_equal(got[g], w)
    assert de.pool.check_consistency() == []


def test_port_poll_converts_only_tagged_bf16_void_pages(tmp_path):
    import ml_dtypes

    pl = dict(PAYLOAD, kv_dtype="bfloat16",
              k=np.ones((2, 1, 8, 4, 16), ml_dtypes.bfloat16),
              v=np.full((2, 1, 8, 4, 16), 2, ml_dtypes.bfloat16))
    JChannel(str(tmp_path), 0).send(1, 0, pl)
    ((_, got),) = HandoffChannel(str(tmp_path), 1).poll()
    assert got["k"].dtype == np.uint16 and (got["k"] == 0x3F80).all()
    assert (got["v"] == 0x4000).all()
    JChannel(str(tmp_path), 0).send(1, 1, dict(
        pl, kv_dtype="float32", k=np.ones(4, ml_dtypes.bfloat16)))
    ((_, raw),) = HandoffChannel(str(tmp_path), 1).poll()
    assert raw["k"].dtype.kind == "V"               # not tagged bf16: as is


# ---------------------------------------------------------------------------
# cross-host TTFT and the clock rounds (logical ranks with skewed clocks)
# ---------------------------------------------------------------------------
class TestCrossHostTTFT:
    def test_handed_off_request_reports_offset_corrected_e2e_ttft(
            self, nets, tmp_path):
        """The decode rank's clock runs 5 s slow: an uncorrected delta
        would read about -5000 ms. The corrected end-to-end TTFT lies
        inside the run's wall time with ordered bounds, the agreed table
        recovered the skew, and both halves of a handed-off request carry
        its trace id."""
        from paddle_tpu_torch.profiler import disttrace
        from paddle_tpu_torch.profiler import events as pevents

        _, net = nets
        prompts = _prompts((8, 16, 12))
        servers = [DisaggServer(net, ServingConfig(**CFG),
                                MeshSpec(r, 2, prefill_ranks=(0,)),
                                str(tmp_path), lease_s=2.0,
                                clock_skew_s=-5.0 if r == 1 else 0.0)
                   for r in range(2)]
        seq0 = pevents.log().next_seq
        for s in servers:
            for p in prompts:
                s.submit(p, 4)
        t0 = time.perf_counter()
        merged = _drive_all(servers)
        wall_ms = (time.perf_counter() - t0) * 1e3
        assert sorted(merged) == [0, 1, 2]
        decode = servers[1]
        handed = [g for g, r in decode._reqs.items() if r.prefill_rank == 0]
        assert sorted(handed) == [1, 2]
        ttfts, bounds = decode.ttfts(), decode.ttft_bounds()
        for g in handed:
            assert 0.0 < ttfts[g] < wall_ms + 1000.0
            lo, mid, hi = bounds[g]
            assert lo <= mid <= hi and hi - lo < 1000.0
        assert all(g not in servers[0].ttfts() for g in handed)
        off = decode._clock_table["1"]["offset_s"]
        assert abs(off + 5.0) <= decode._clock_table["1"]["unc_s"] + 0.05
        evs = pevents.log().events(since_seq=seq0)
        for g in handed:
            kinds = {e.kind for e in evs
                     if e.attrs.get("trace") == disttrace.trace_id(g)}
            assert {"submit", "admit", "handoff_out", "handoff_in",
                    "finish"} <= kinds, (g, kinds)
        assert any(e.kind == "route" for e in evs)
        assert any(e.kind == "clock_sync" for e in evs)
        for s in servers:
            s.close()

    def test_window_expired_rank_self_heals_and_reaches_the_mesh(
            self, nets, tmp_path):
        from paddle_tpu_torch.distributed.consensus import Consensus

        _, net = nets
        conss = [Consensus(str(tmp_path / "board"), r, 2, lease_s=30.0,
                           window_s=0.3) for r in range(2)]
        servers = [DisaggServer(net, ServingConfig(**CFG),
                                MeshSpec(r, 2, prefill_ranks=(0,)),
                                str(tmp_path), consensus=conss[r],
                                clock_skew_s=0.75 if r == 1 else 0.0)
                   for r in range(2)]
        try:
            deadline = time.time() + 10
            while servers[0]._clock_table is None and time.time() < deadline:
                servers[0]._clock_round()
                time.sleep(0.02)
            assert servers[0]._clock_table is not None
            assert "1" not in servers[0]._clock_table
            deadline = time.time() + 10
            while time.time() < deadline:
                servers[0]._clock_round()
                servers[1]._clock_round()
                t0, t1 = servers[0]._clock_table, servers[1]._clock_table
                if t0 and t1 and "1" in t0 and "1" in t1:
                    break
                time.sleep(0.005)
            for s in servers:
                assert set(s._clock_table) == {"0", "1"}, s._clock_table
            e1 = servers[1]._clock_table["1"]
            assert abs(e1["offset_s"] - 0.75) <= e1["unc_s"] + 0.05
            assert servers[0]._clock_table["1"] == e1
        finally:
            for s in servers:
                s.close()

    def test_periodic_resync_absorbs_a_mid_run_clock_step(self, nets,
                                                          tmp_path):
        _, net = nets
        servers = [DisaggServer(net, ServingConfig(**CFG),
                                MeshSpec(r, 2, prefill_ranks=(0,)),
                                str(tmp_path), lease_s=30.0,
                                clock_skew_s=2.5 if r == 1 else 0.0,
                                clock_resync_s=0.05)
                   for r in range(2)]

        def table_has(off):
            for s in servers:
                e = (s._clock_table or {}).get("1") or {}
                if e.get("offset_s") is None or \
                        abs(e["offset_s"] - off) > (e.get("unc_s") or 0) + 0.05:
                    return False
            return True

        try:
            deadline = time.time() + 10
            while time.time() < deadline and not table_has(2.5):
                for s in servers:
                    s._clock_round()
                time.sleep(0.005)
            assert table_has(2.5)
            r0 = registry().counter("consensus/clock_resyncs").value
            deadline = time.time() + 0.5
            while time.time() < deadline:
                for s in servers:
                    s._clock_round()
                time.sleep(0.005)
            assert registry().counter("consensus/clock_resyncs").value == r0
            servers[1]._skew_s = 4.5
            servers[1].clock.skew_s = 4.5
            deadline = time.time() + 10
            while time.time() < deadline and not table_has(4.5):
                for s in servers:
                    s._clock_round()
                time.sleep(0.005)
            assert table_has(4.5), servers[1]._clock_table
            assert registry().counter("consensus/clock_resyncs").value > r0
        finally:
            for s in servers:
                s.close()
