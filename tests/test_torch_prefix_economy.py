"""The prefix economy's host structures and hot prefix-chain migration,
held against the JAX package.

- chain hashes (``chain_hash``/``chain_hashes``) and ``PrefixCache.digest``
  equal the reference's strings for the same tokens;
- ``chain_pages``, ``rev`` and ``on_drop`` (withdraw before reclaim: the
  hook sees the page still held) behave as the reference's;
- the allocator's zero-free hook queues an int8 page's scale reset and ends
  its migration provenance at the last reference;
- ``ttfc_key``, ``prefix_affinity_key`` and ``ChunkScheduler.ttft_p95``
  equal the reference's on seeded random votes and finishes;
- ``export_prefix_chain`` -> ``import_prefix_chain`` port to port, JAX to
  port and port to JAX: a request admitted onto the migrated chain gives
  the origin's stream, its prefix hit counts as remote, mismatched
  payloads raise, and a full pool is a clean miss.

The port runs its plain versions here (CPU tensors).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import ServingConfig as JConfig
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import paged_cache as jpc
from paddle_tpu.serving import sched as jsched
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.profiler import registry
from paddle_tpu_torch.serving import (PagePool, ServingConfig, ServingEngine,
                                      chain_hash, chain_hashes)
from paddle_tpu_torch.serving import paged_cache as tpc
from paddle_tpu_torch.serving import sched as tsched

CFG = dict(num_slots=2, page_size=8, pages_per_slot=4, prefill_chunk=8)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's tiny shapes: the test
    workers share the machine's cores, and oversubscribed threads made
    these tests many times slower."""
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


def _pool(mod=tpc, **over):
    kw = dict(num_layers=1, num_pages=9, page_size=8, num_heads=2,
              head_dim=4, num_slots=2, pages_per_slot=3, prefix_cache=True)
    kw.update(over)
    return mod.PagePool(**kw)


# ---------------------------------------------------------------------------
# chain hashes and the digest
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_hashes_equal_reference_strings(seed):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, 50304, rng.randint(1, 200)).astype(np.int32)
    ps = int(rng.choice([4, 8, 16]))
    assert chain_hashes(toks, ps) == jpc.chain_hashes(toks, ps)
    parent = jpc.chain_hash("", toks[:ps])
    assert chain_hash(parent, toks[:ps]) == jpc.chain_hash(parent, toks[:ps])
    assert tpc.CHAIN_HASH_LEN == jpc.CHAIN_HASH_LEN


def test_digest_and_chain_pages_equal_reference():
    """The same inserts on both packages' pools give the same digest, the
    same chain pages and hashes, and the same ``rev`` history."""
    r = np.random.RandomState(4)
    base = r.randint(0, 128, 24).astype(np.int32)
    other = np.concatenate([base[:8], r.randint(0, 128, 16)]).astype(np.int32)
    res = []
    for mod in (jpc, tpc):
        p = _pool(mod, num_pages=12, pages_per_slot=3)
        revs = [p.prefix.rev]
        p.grow_slot(0, 3)
        p.prefix.insert(base, list(p._held[0]))
        revs.append(p.prefix.rev)
        p.grow_slot(1, 3)
        p.prefix.insert(other, list(p._held[1]))
        revs.append(p.prefix.rev)
        p.prefix.insert(base, list(p._held[0]))      # nothing new
        revs.append(p.prefix.rev)
        pages, hashes = p.prefix.chain_pages(
            np.concatenate([other, base[:5]]))
        res.append((p.prefix.digest(), hashes, len(pages), revs,
                    len(p.prefix), p.check_consistency()))
    assert res[0] == res[1]
    assert res[1][4] == 5 and res[1][5] == []


class TestChainHashes:
    def test_deterministic_and_parent_dependent(self):
        c = np.arange(8, dtype=np.int32)
        h1 = chain_hash("", c)
        assert chain_hash("", c) == h1 and len(h1) == 16
        assert chain_hash(h1, c) != h1
        assert chain_hash("", np.arange(1, 9)) != h1

    def test_chain_is_prefix_stable(self):
        long, short = np.arange(24), np.arange(16)
        assert chain_hashes(long, 8)[:2] == chain_hashes(short, 8)
        assert chain_hashes(np.arange(23), 8) == chain_hashes(short, 8)
        assert chain_hashes(np.arange(7), 8) == []

    def test_digest_and_chain_pages_match_recomputation(self):
        p = _pool()
        toks = np.arange(16, dtype=np.int32)
        p.grow_slot(0, 2)
        held = list(p._held[0])
        p.prefix.insert(toks, held)
        hs = chain_hashes(toks, 8)
        d = p.prefix.digest()
        assert d["page_size"] == 8
        assert d["chains"] == {hs[0]: 8, hs[1]: 16}
        pages, hashes = p.prefix.chain_pages(toks)
        assert pages == held and hashes == hs
        pages2, _ = p.prefix.chain_pages(np.arange(24, dtype=np.int32))
        assert pages2 == held


class TestWithdrawBeforeReclaim:
    def test_on_drop_fires_while_pages_still_held(self):
        p = _pool()
        p.grow_slot(0, 1)
        page = p._held[0][0]
        toks = np.arange(8, dtype=np.int32)
        p.prefix.insert(toks, [page])
        p.release_slot(0)               # the index alone holds it now
        assert p.allocator.refcount(page) == 1
        seen = []
        p.prefix.on_drop = lambda h, n: seen.append(
            (h, n, p.allocator.refcount(page)))
        rev0 = p.prefix.rev
        assert p.prefix.evict_for(1) >= 1
        assert seen == [(chain_hashes(toks, 8)[0], 8, 1)]
        assert p.allocator.refcount(page) == 0
        assert p.prefix.rev > rev0
        assert p.check_consistency() == []

    def test_rev_tracks_structural_changes_only(self):
        p = _pool()
        p.grow_slot(0, 2)
        toks = np.arange(16, dtype=np.int32)
        rev0 = p.prefix.rev
        p.prefix.insert(toks, list(p._held[0]))
        rev1 = p.prefix.rev
        assert rev1 > rev0
        p.prefix.insert(toks, list(p._held[0]))
        assert p.prefix.rev == rev1
        p.release_slot(0)
        assert p.prefix.clear() == 2 and p.prefix.rev > rev1
        assert len(p.prefix) == 0


class TestZeroFreeHook:
    def test_zero_freed_page_queues_a_scale_reset(self):
        p = _pool(dtype=torch.int8)
        pages = p.allocator.alloc(2)
        p._fresh.clear()
        p.allocator.free(pages[:1])     # the last reference: reset queued
        assert pages[0] in p._fresh
        assert pages[1] not in p._fresh
        p.allocator.free(pages[1:])

    def test_shared_page_resets_only_at_last_ref(self):
        p = _pool(dtype=torch.int8)
        (page,) = p.allocator.alloc(1)
        p.allocator.share([page])
        p._fresh.clear()
        p.allocator.free([page])
        assert page not in p._fresh
        p.allocator.free([page])
        assert page in p._fresh

    @pytest.mark.parametrize("dtype", [torch.float32, torch.int8],
                             ids=["f32", "int8"])
    def test_migrated_provenance_ends_at_last_ref(self, dtype):
        p = _pool(dtype=dtype)
        (page,) = p.allocator.alloc(1)
        p.migrated_pages.add(page)
        p.allocator.share([page])
        p.allocator.free([page])
        assert page in p.migrated_pages      # still held
        p.allocator.free([page])
        assert page not in p.migrated_pages
        # the hook holds the pool's list and set, not the pool
        assert p.allocator.on_zero.__closure__ is not None
        assert all(not isinstance(c.cell_contents, PagePool)
                   for c in p.allocator.on_zero.__closure__)


# ---------------------------------------------------------------------------
# routing keys and the TTFT window (pure)
# ---------------------------------------------------------------------------
def _random_votes(rng, n_ranks):
    votes = {}
    for r in range(n_ranks):
        if rng.rand() < 0.15:
            continue                          # no vote this round
        v = {"chunk": int(rng.choice([8, 64, 256])),
             "queued": int(rng.randint(0, 6)),
             "free_slots": int(rng.randint(0, 8)),
             "free_pages": int(rng.randint(0, 200)),
             "page_size": int(rng.choice([8, 16]))}
        if rng.rand() < 0.8:
            v["prefill_backlog"] = int(rng.randint(0, 4000))
        if rng.rand() < 0.7:
            v["ttft_p95_ms"] = float(rng.rand() * 500)
        votes[r] = v
    return votes


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_routing_keys_equal_reference_on_random_votes(seed):
    rng = np.random.RandomState(seed)
    for _ in range(50):
        votes = _random_votes(rng, 4)
        extra_t = {r: int(rng.randint(0, 600)) for r in range(4)
                   if rng.rand() < 0.5}
        extra_r = {r: int(rng.randint(0, 3)) for r in range(4)
                   if rng.rand() < 0.5}
        for rank in range(5):
            assert tsched.ttfc_key(votes, rank, extra_t, extra_r) == \
                jsched.ttfc_key(votes, rank, extra_t, extra_r)
            hit = int(rng.choice([0, 7, 64, 513]))
            assert tsched.prefix_affinity_key(votes, rank, extra_t, extra_r,
                                              hit) == \
                jsched.prefix_affinity_key(votes, rank, extra_t, extra_r,
                                           hit)


class TestPrefixAffinityKey:
    def _vote(self, backlog=0, chunk=8):
        return {"prefill_backlog": backlog, "chunk": chunk,
                "queued": 0, "free_slots": 4, "free_pages": 100}

    def test_hit_discount_is_priced_in_chunks(self):
        votes = {0: self._vote(), 1: self._vote()}
        base = tsched.ttfc_key(votes, 1, {}, {})
        k = tsched.prefix_affinity_key(votes, 1, {}, {}, hit_tokens=24)
        assert k[0] == base[0] - 3.0
        assert k[1:] == base[1:]
        assert tsched.prefix_affinity_key(votes, 1, {}, {}, 0) == base

    def test_unvoted_rank_gets_no_discount(self):
        votes = {0: self._vote()}
        assert tsched.prefix_affinity_key(votes, 1, {}, {}, 999)[0] \
            >= float(1 << 20)


@pytest.mark.parametrize("policy", ["fifo", "aged-sjf"])
def test_ttft_p95_equals_reference(policy):
    args = (policy, 4, 256, 32, 2)
    js, ts = jsched.ChunkScheduler(*args), tsched.ChunkScheduler(*args)
    assert js.ttft_p95() == ts.ttft_p95() == 0.0
    rng = np.random.RandomState(8)
    for i in range(150):
        ttft = None if rng.rand() < 0.1 else float(rng.rand() * 900)
        tpot = float(rng.rand() * 40)
        js.note_finish(ttft, tpot)
        ts.note_finish(ttft, tpot)
        if i % 7 == 0:
            assert ts.ttft_p95() == js.ttft_p95()
    assert ts.ttft_p95() == js.ttft_p95() > 0


# ---------------------------------------------------------------------------
# chain migration between engines
# ---------------------------------------------------------------------------
def _serve(eng, prompt, max_new):
    rid = eng.submit(prompt, max_new)
    return eng.run()[rid]


MIGRATE = {"port_to_port": ("port", "port"), "jax_to_port": ("jax", "port"),
           "port_to_jax": ("port", "jax")}


@pytest.mark.parametrize("way", sorted(MIGRATE))
def test_migrated_chain_serves_the_origin_stream(nets, way):
    """Engine A serves a prompt and exports its cached chain; a fresh
    engine B imports it (24 tokens newly indexed; again: 0, every page
    returns to the pool) and serves the same prompt off the migrated pages
    to A's stream. On the port's side the hit counts as remote (the
    counter and the prefix_hit event's remote_tokens)."""
    jnet, net = nets

    def make(pkg):
        return ServingEngine(net, ServingConfig(**CFG)) if pkg == "port" \
            else JEngine(jnet, JConfig(**CFG))

    src, dst = MIGRATE[way]
    prompt = _prompts((24,))[0]
    a = make(src)
    out_a = _serve(a, prompt, 4)
    payload = a.export_prefix_chain(prompt)
    assert payload is not None and payload["n_tokens"] == 24
    assert str(payload["kv_dtype"]) == "float32"
    assert payload["k"].shape[1] == 3 and payload["tokens"].shape == (24,)
    b = make(dst)
    reg = registry()
    rem0 = reg.counter("serving/prefix_hit_tokens_remote").value
    log = tprof.event_log()
    seq0 = log.next_seq
    assert b.import_prefix_chain(payload) == 24
    assert len(b.pool.migrated_pages) == 3
    assert b.pool.check_consistency() == []
    free0 = b.pool.allocator.num_free
    assert b.import_prefix_chain(payload) == 0
    assert b.pool.allocator.num_free == free0
    assert b.pool.check_consistency() == []
    out_b = _serve(b, prompt, 4)
    np.testing.assert_array_equal(out_b, out_a)
    assert b.pool.check_consistency() == []
    if dst == "port":
        # 24-token prompt: lookup caps at 23, so 2 full migrated pages hit
        # and the third is reused by copy-on-write
        assert reg.counter("serving/prefix_hit_tokens_remote").value \
            - rem0 == 16
        (hit,) = [e for e in log.events(since_seq=seq0)
                  if e.kind == "prefix_hit"
                  and e.attrs.get("eng") == b._eng_id]
        assert hit.attrs["remote_tokens"] == 16
        assert hit.attrs["tokens"] == 23


def test_import_rejects_mismatched_payloads(nets):
    _, net = nets
    prompt = _prompts((16,))[0]
    a = ServingEngine(net, ServingConfig(**CFG))
    _serve(a, prompt, 4)
    payload = a.export_prefix_chain(prompt)
    assert payload is not None
    with pytest.raises(ValueError, match="int8"):
        a.import_prefix_chain(dict(payload, kv_dtype="int8"))
    with pytest.raises(ValueError, match="inconsistent"):
        a.import_prefix_chain(dict(payload, tokens=payload["tokens"][:8]))
    with pytest.raises(ValueError, match="inconsistent"):
        a.import_prefix_chain(dict(payload, v=payload["v"][:, :1]))
    assert a.pool.check_consistency() == []
    assert a.export_prefix_chain(np.arange(16, dtype=np.int32) + 200) is None


def test_import_into_a_full_pool_is_a_clean_miss(nets):
    """A speculative import never evicts local cache: with no free page it
    indexes nothing and returns 0."""
    _, net = nets
    prompt = _prompts((16,))[0]
    a = ServingEngine(net, ServingConfig(**CFG))
    _serve(a, prompt, 4)
    payload = a.export_prefix_chain(prompt)
    b = ServingEngine(net, ServingConfig(**CFG))
    grabbed = []
    while True:
        got = b.pool.allocator.alloc(1)
        if got is None:
            break
        grabbed += got
    assert b.import_prefix_chain(payload) == 0
    assert not b.pool.migrated_pages
    b.pool.allocator.free(grabbed)
    assert b.pool.check_consistency() == []


def test_int8_chain_carries_its_scales(nets):
    """int8 pages migrate with their per-page per-head scales: the
    imported pages and scales equal the payload's, a naked payload is
    refused, and the prompt served off the chain gives the origin's
    stream (two int8 engines agree exactly)."""
    _, net = nets
    cfg = dict(CFG, kv_dtype="int8")
    prompt = _prompts((24,))[0]
    a = ServingEngine(net, ServingConfig(**cfg))
    out_a = _serve(a, prompt, 4)
    payload = a.export_prefix_chain(prompt)
    assert payload is not None and str(payload["kv_dtype"]) == "int8"
    assert payload["k_scale"].shape == (net.config.num_layers, 3,
                                        net.config.num_heads)
    b = ServingEngine(net, ServingConfig(**cfg))
    with pytest.raises(ValueError, match="scales"):
        b.import_prefix_chain({k: v for k, v in payload.items()
                               if not k.endswith("_scale")})
    assert b.import_prefix_chain(payload) == 24
    pages, _ = b.pool.prefix.chain_pages(prompt)
    idx = torch.as_tensor(pages)
    np.testing.assert_array_equal(b.pool.k_scale[:, idx].numpy(),
                                  payload["k_scale"])
    np.testing.assert_array_equal(b.pool.v[:, idx].numpy(), payload["v"])
    np.testing.assert_array_equal(_serve(b, prompt, 4), out_a)
    assert b.pool.check_consistency() == []
