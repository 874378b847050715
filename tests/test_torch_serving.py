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
    dict(decode="sampling"),
    dict(kv_dtype="int8", attention_kernel="legacy"),   # int8 itself is ported
    dict(spec=object()), dict(attention_kernel="legacy")])
def test_unported_knobs_raise_not_implemented(nets, knob):
    _, net = nets
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingEngine(net, ServingConfig(**knob))


@pytest.mark.parametrize("call", ["hold", "export_held", "release_exported",
                                  "admit_prefilled", "export_prefix_chain",
                                  "import_prefix_chain"])
def test_unported_handoff_paths_raise_not_implemented(nets, call):
    _, net = nets
    eng = ServingEngine(net, ServingConfig(num_slots=1, page_size=8,
                                           pages_per_slot=4))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if call == "hold":
            eng.submit(np.arange(4), 2, hold_after_prefill=True)
        elif call in ("export_held", "release_exported"):
            getattr(eng, call)(0)
        else:
            getattr(eng, call)({})


def test_bad_knobs_raise_value_error(nets):
    _, net = nets
    for kw in (dict(attention_kernel="ragged-xla"), dict(decode="beam"),
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
