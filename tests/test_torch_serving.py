"""paddle_tpu_torch.serving held against the JAX package's engine.

The port's engine and the reference's (``attention_kernel="ragged-xla"``)
serve the same prompts with the same weights; their greedy streams must
be EQUAL token for token — prefix hits, copy-on-write of a divergent tail
page, and an oversubscribed pool that preempts included. The port runs
its plain versions here (CPU tensors); the card's kernels are held
against those by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import ServingPredictor as JPredictor
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import ServingConfig as JConfig
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import paged_cache as jpc
from paddle_tpu_torch.inference import ServingPredictor
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.profiler import registry
from paddle_tpu_torch.serving import ServingConfig, ServingEngine
from paddle_tpu_torch.serving import paged_cache as tpc


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the test workers share the machine's cores
    (oversubscribed, this file's cases took several times longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    """gpt_tiny at initializer_range 0.2: greedy decode is context
    dependent (the default 0.02 collapses to one repeated token)."""
    paddle.seed(0)
    jnet = jgpt.gpt_tiny(initializer_range=0.2)
    jnet.eval()
    net = tgpt.gpt_tiny(device="cpu", initializer_range=0.2)
    tgpt.load_reference_state(
        net, {k: np.asarray(v._value) for k, v in jnet.state_dict().items()})
    net.eval()
    return jnet, net


def _prompts():
    r = np.random.RandomState(3)
    base = r.randint(0, 128, (30,)).astype(np.int32)
    return [
        r.randint(0, 128, (5,)).astype(np.int32),
        base,
        r.randint(0, 128, (17,)).astype(np.int32),
        base.copy(),                                    # full prefix hit
        np.concatenate([base[:20],                      # mid-page COW
                        r.randint(0, 128, (7,)).astype(np.int32)]),
        r.randint(0, 128, (9,)).astype(np.int32),
    ]


CASES = {
    "prefix_cow": dict(num_slots=2, page_size=8, pages_per_slot=8,
                       prefill_chunk=8, prefill_chunks_per_tick=2),
    "no_prefix_cache": dict(num_slots=3, page_size=8, pages_per_slot=8,
                            prefill_chunk=16, prefix_cache=False),
    "oversubscribed": dict(num_slots=3, page_size=4, pages_per_slot=16,
                           num_pages=14, prefill_chunk=8),
    "sjf": dict(num_slots=2, page_size=8, pages_per_slot=8,
                prefill_chunk=8, prefill_chunks_per_tick=2,
                scheduler="sjf"),
    "aged_sjf": dict(num_slots=2, page_size=8, pages_per_slot=8,
                     prefill_chunk=8, prefill_chunks_per_tick=2,
                     scheduler="aged-sjf"),
    "bf16_kv": dict(num_slots=2, page_size=8, pages_per_slot=8,
                    prefill_chunk=8, kv_dtype="bf16"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_streams_equal_reference_engine(nets, case):
    jnet, net = nets
    kw = CASES[case]
    prompts = _prompts()
    jeng = JEngine(jnet, JConfig(attention_kernel="ragged-xla", **kw))
    jr = [jeng.submit(p, 12) for p in prompts]
    ref = jeng.run()
    reg = registry()
    pre0 = reg.counter("serving/preemptions").value
    hits0 = reg.counter("serving/prefix_hit_tokens").value
    cow0 = reg.counter("cache_share/cow_copies").value
    eng = ServingEngine(net, ServingConfig(**kw))
    tr = [eng.submit(p, 12) for p in prompts]
    got = eng.run()
    for a, b in zip(jr, tr):
        assert got[b].shape == (12,)
        np.testing.assert_array_equal(got[b], ref[a])
    assert eng.pool.check_consistency() == []
    if case == "oversubscribed":
        assert reg.counter("serving/preemptions").value > pre0
    if case == "prefix_cow":
        assert reg.counter("serving/prefix_hit_tokens").value > hits0
        assert reg.counter("cache_share/cow_copies").value > cow0
    eng.pool.drop_prefix_cache()
    assert eng.pool.allocator.num_allocated == 0


SAMPLING = dict(decode="sampling", temperature=0.9, top_k=40, top_p=0.9,
                seed=21)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sampling_streams_equal_reference_engine(nets, case):
    """decode='sampling': each request's key folded by the position of
    the token it emits, on the threefry generator bit-equal to jax.random
    — the streams equal the JAX engine's token for token, prefix hits,
    COW and preemption (the oversubscribed case) included."""
    jnet, net = nets
    kw = dict(CASES[case], **SAMPLING)
    prompts = _prompts()
    jeng = JEngine(jnet, JConfig(attention_kernel="ragged-xla", **kw))
    jr = [jeng.submit(p, 12) for p in prompts]
    ref = jeng.run()
    reg = registry()
    pre0 = reg.counter("serving/preemptions").value
    eng = ServingEngine(net, ServingConfig(**kw))
    tr = [eng.submit(p, 12) for p in prompts]
    got = eng.run()
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(got[b], ref[a])
    if case == "oversubscribed":
        assert reg.counter("serving/preemptions").value > pre0
    assert eng.pool.check_consistency() == []


def test_sampling_per_request_overrides_equal_reference(nets):
    """Per-request temperature/top_k/top_p and explicit keys ride the
    same tick; each request's stream equals the JAX engine's and does not
    depend on its neighbours: served alone it is the same."""
    jnet, net = nets
    kw = dict(num_slots=3, page_size=8, pages_per_slot=8, prefill_chunk=8,
              prefill_chunks_per_tick=2, **SAMPLING)
    over = [dict(temperature=0.5), dict(top_k=3), dict(top_p=0.5, top_k=0),
            dict(), dict(temperature=2.0, top_k=1),
            dict(key=np.array([7, 9], np.uint32), top_p=0.8)]
    prompts = _prompts()
    jeng = JEngine(jnet, JConfig(attention_kernel="ragged-xla", **kw))
    jr = [jeng.submit(p, 10, **o) for p, o in zip(prompts, over)]
    ref = jeng.run()
    eng = ServingEngine(net, ServingConfig(**kw))
    tr = [eng.submit(p, 10, **o) for p, o in zip(prompts, over)]
    got = eng.run()
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(got[b], ref[a])
    # the top_k=1 request is greedy whatever its temperature
    greedy = ServingEngine(net, ServingConfig(
        **dict(kw, decode="greedy")))
    g = greedy.submit(prompts[4], 10)
    np.testing.assert_array_equal(greedy.run()[g], got[tr[4]])
    # alone, with the key it was given (rid 2's default), the same stream
    from paddle_tpu_torch.core import random as R

    solo = ServingEngine(net, ServingConfig(**kw))
    key = R.key_to_numpy(R.fold_in(
        R.PRNGKey(SAMPLING["seed"], device="cpu"), tr[2]))
    r = solo.submit(prompts[2], 10, key=key, **over[2])
    np.testing.assert_array_equal(solo.run()[r], got[tr[2]])


def test_serving_predictor_matches_reference(nets):
    jnet, net = nets
    toks = np.random.RandomState(5).randint(0, 128, (3, 12)).astype(np.int32)
    lens = np.array([12, 7, 3])
    kw = dict(num_slots=2, page_size=8, pages_per_slot=4, prefill_chunk=8)
    ref = JPredictor(jnet, max_new_tokens=6, **kw).run([toks, lens])
    got = ServingPredictor(net, max_new_tokens=6, **kw).run([toks, lens])
    assert ServingPredictor(net, **kw).get_input_names() == \
        ["tokens", "lengths"]
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


def test_engine_metrics_and_deferred_sync(nets):
    _, net = nets
    reg = registry()
    ticks0 = reg.counter("serving/ticks").value
    gen0 = reg.counter("serving/tokens_generated").value
    eng = ServingEngine(net, ServingConfig(num_slots=2, page_size=8,
                                           pages_per_slot=8, max_inflight=2))
    for p in _prompts()[:3]:
        eng.submit(p, 5)
    out = eng.run()
    assert sum(len(v) for v in out.values()) == 15
    assert reg.counter("serving/tokens_generated").value - gen0 == 15
    assert reg.counter("serving/ticks").value > ticks0
    assert reg.gauge("serving/tokens_per_sec").value > 0
    assert reg.histogram("serving/ttft_ms").count >= 3
    # the deferred window held ticks in flight (max_inflight after the
    # drain, plus the tick just dispatched)
    assert eng.max_inflight_seen == 3
    assert eng.idle()
    # the token tensor of a tick stays on the engine's device until drained
    assert eng.device.type == "cpu" and eng.pool.k.device.type == "cpu"


def test_cancel_frees_the_slot(nets):
    _, net = nets
    eng = ServingEngine(net, ServingConfig(num_slots=1, page_size=8,
                                           pages_per_slot=8))
    a = eng.submit(_prompts()[1], 8)
    b = eng.submit(_prompts()[0], 4)
    eng.step()
    assert eng.cancel(a) and eng.cancel(b)
    assert not eng.cancel(a)
    assert eng.run() == {}
    eng.pool.drop_prefix_cache()
    assert eng.pool.allocator.num_allocated == 0


@pytest.mark.parametrize("knob", [
    dict(kv_dtype="int8", attention_kernel="legacy"),
    dict(attention_kernel="legacy")])
def test_unported_knobs_raise_not_implemented(nets, knob):
    """Both knobs are ported (the name is kept from when they raised):
    legacy over int8 pages is the reference's ValueError (legacy keeps
    the model-dtype pool), and the legacy engine serves."""
    _, net = nets
    if "kv_dtype" in knob:
        with pytest.raises(ValueError, match="unified tick"):
            ServingEngine(net, ServingConfig(**knob))
        return
    eng = ServingEngine(net, ServingConfig(num_slots=2, page_size=8,
                                           pages_per_slot=8, **knob))
    rids = [eng.submit(p, 5) for p in _prompts()[:3]]
    out = eng.run()
    assert [out[r].shape for r in rids] == [(5,)] * 3
    assert len(eng.compiled_sites) == 2
    assert eng.pool.check_consistency() == []


def _held_payload(eng, prompt, max_new=4):
    rid = eng.submit(prompt, max_new, hold_after_prefill=True)
    for _ in range(30):
        eng.step()
        eng.drain(0)
        if rid in eng.held_ready():
            return rid
    raise AssertionError("the held request never became held-ready")


@pytest.mark.parametrize("call", ["hold", "export_held", "release_exported",
                                  "admit_prefilled", "export_prefix_chain",
                                  "import_prefix_chain"])
def test_unported_handoff_paths_raise_not_implemented(nets, call):
    """Each handoff and chain call is ported (the name is kept from when
    they raised) and does its work."""
    _, net = nets
    kw = dict(num_slots=1, page_size=8, pages_per_slot=4)
    eng = ServingEngine(net, ServingConfig(**kw))
    prompt = _prompts()[2]                               # 17 tokens
    if call in ("hold", "export_held", "release_exported",
                "admit_prefilled"):
        rid = _held_payload(eng, prompt)
        assert eng.held_ready() == (rid,)
        assert len(eng._requests[rid].out) == 1
        if call == "hold":
            assert not eng.step()          # a held slot does not decode
            return
        pl = eng.export_held(rid)
        assert pl["k"].shape == (net.config.num_layers, 3, 8, 4, 16)
        assert pl["n_tokens"] == 17 and pl["kv_dtype"] == "float32"
        if call == "export_held":
            assert eng.held_ready() == (rid,)   # export is read-only
            return
        eng.release_exported(rid)
        assert eng.held_ready() == () and eng.idle()
        assert eng.pool.check_consistency() == []
        if call == "release_exported":
            assert len(eng.pool.prefix) == 2    # the prompt's full pages
            return
        de = ServingEngine(net, ServingConfig(**kw))
        lr = de.admit_prefilled(pl)
        de.run()
        want = ServingEngine(net, ServingConfig(**kw))
        wr = want.submit(prompt, 4)
        np.testing.assert_array_equal(de._requests[lr].out,
                                      want.run()[wr])
        return
    r = eng.submit(prompt, 4)
    eng.run()
    pl = eng.export_prefix_chain(prompt)
    assert pl["n_tokens"] == 16 and pl["k"].shape[1] == 2
    if call == "import_prefix_chain":
        other = ServingEngine(net, ServingConfig(**kw))
        assert other.import_prefix_chain(pl) == 16
        r2 = other.submit(prompt, 4)
        np.testing.assert_array_equal(other.run()[r2],
                                      eng._requests[r].out)


def test_bad_knobs_raise_value_error(nets):
    _, net = nets
    for kw in (dict(attention_kernel="flash"), dict(decode="beam"),
               dict(kv_dtype="fp8"), dict(scheduler="lifo")):
        with pytest.raises(ValueError):
            ServingEngine(net, ServingConfig(**kw))


@pytest.mark.parametrize("mod", [jpc, tpc], ids=["jax", "torch"])
def test_allocator_refcounts_agree(mod):
    a = mod.PageAllocator(6)
    got = a.alloc(2)
    assert a.num_free == 3 and mod.NULL_PAGE not in got
    assert a.alloc(4) is None and a.num_free == 3
    a.share([got[0]])
    a.free(got)
    assert a.refcount(got[0]) == 1 and a.refcount(got[1]) == 0
    a.free([got[0]])
    assert a.num_free == 5 and a.utilization() == 0.0
    with pytest.raises(ValueError):
        a.free([got[0]])
    with pytest.raises(ValueError):
        a.free([mod.NULL_PAGE])


def test_prefix_cache_lookup_insert_evict_agree_with_reference():
    toks = np.arange(40, dtype=np.int32)
    other = np.concatenate([toks[:12], np.full(10, 99, np.int32)])
    res = []
    for mod in (jpc, tpc):
        a = mod.PageAllocator(10)
        pc = mod.PrefixCache(8, a)
        pages = a.alloc(4)
        assert pc.insert(toks[:32], pages) == 4
        a.free(pages)                       # index holds the only ref
        look = pc.lookup(toks)
        part = pc.lookup(other)
        freed = pc.evict_for(2)
        res.append((look, part, freed, sorted(pc.pages()), a.num_free))
    assert res[0] == res[1]


@pytest.mark.parametrize("policy", ["fifo", "sjf", "aged-sjf"])
def test_chunk_scheduler_decisions_equal_reference(policy):
    """The same random lifecycle drives both packages' ChunkScheduler:
    every pick, budget and the starvation bookkeeping agree."""
    from paddle_tpu.serving.sched import ChunkScheduler as JSched
    from paddle_tpu_torch.serving.sched import ChunkScheduler as TSched

    args = (policy, 4, 256, 32, 3)
    js, ts = JSched(*args, stats_every=4), TSched(*args, stats_every=4)
    r = np.random.RandomState(11)
    for _ in range(200):
        for s in (js, ts):
            s.on_tick()
        slot = int(r.randint(4))
        op = r.randint(4)
        for s in (js, ts):
            if op == 0:
                s.note_admit(slot)
            elif op == 1:
                s.note_open(slot)
            elif op == 2:
                s.note_release(slot)
        if op == 3:
            ttft, tpot = float(r.rand() * 100), float(r.rand() * 10)
            for s in (js, ts):
                s.note_finish(ttft, tpot)
        cands = [(s, int(r.randint(100)), int(r.randint(1, 256)))
                 for s in range(4) if r.rand() < 0.7]
        assert js.pick(cands) == ts.pick(cands)
        b = (int(r.randint(4)), int(r.randint(5)), int(r.randint(3)))
        assert js.chunk_budget(*b) == ts.chunk_budget(*b)
    assert js.max_wait_ticks_seen == ts.max_wait_ticks_seen
    assert js.starvation_bound_ticks() == ts.starvation_bound_ticks()
