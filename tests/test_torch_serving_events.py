"""The serving engine's event timeline and dispatch sites, held against
the JAX package's engine.

The port's engine and the reference's (``attention_kernel="ragged-xla"``)
serve the same schedules with the same weights (gpt_tiny at
initializer_range 0.2, copied by ``load_reference_state``): an
oversubscribed pool that preempts, and twin speculative decoding at k 3.
Per request, the sequence of event kinds must be equal, and so must every
attribute that is not a time or an id (``eng``, ``trace``, ``ttft_ms``,
``tpot_ms``, ``ms``). ``compiled_sites`` names match up to their ``#n``
suffix. The port runs its plain versions here (CPU tensors).
"""
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.profiler as jprof
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.profiler import recompile as jrec
from paddle_tpu.serving import ServingConfig as JConfig
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import SpecConfig as JSpec
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.profiler import recompile as trec
from paddle_tpu_torch.profiler.events import breakdown_from_events
from paddle_tpu_torch.serving import ServingConfig, ServingEngine, SpecConfig

#: attributes that carry a time or an id, not the schedule
TIMING = {"eng", "trace", "ttft_ms", "tpot_ms", "ms"}

PREEMPT = dict(num_slots=2, page_size=8, pages_per_slot=3, num_pages=5,
               prefill_chunk=8)
SPEC = dict(num_slots=2, page_size=8, pages_per_slot=3, prefill_chunk=8)


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


def _prompts(n):
    rng = np.random.RandomState(3)
    return [rng.randint(0, 128, (8,)).astype(np.int32) for _ in range(n)]


def _serve(eng, log, prompts, max_new):
    """Serve on ``eng``; returns (rids, {rid: its events, this engine's
    alone}, streams)."""
    seq0 = log.next_seq
    rids = [eng.submit(p, max_new) for p in prompts]
    out = eng.run()
    mine = [e for e in log.events(since_seq=seq0)
            if e.attrs.get("eng") == eng._eng_id]
    return rids, {r: [e for e in mine if e.rid == r] for r in rids}, \
        [out[r].tolist() for r in rids]


def _schedule(evs):
    return [(e.kind, {k: v for k, v in e.attrs.items() if k not in TIMING})
            for e in evs]


def _hold(jevs, tevs, jrids, trids):
    for jr, tr in zip(jrids, trids):
        assert _schedule(tevs[tr]) == _schedule(jevs[jr]), tr
        for e in tevs[tr]:
            for v in e.attrs.values():
                assert v is None or type(v) in (int, float, str, bool), e


def _check_breakdowns(tevs, rids, max_new):
    for rid in rids:
        evs = tevs[rid]
        first = {}
        for e in evs:
            first.setdefault(e.kind, e.t_ns)
        assert first["submit"] <= first["admit"] <= first["first_token"] \
            <= first["finish"]
        b = breakdown_from_events(evs)
        assert b["complete"] and b["tokens"] == max_new
        buckets = b["queue_wait_ms"] + b["prefill_ms"] + b["decode_ms"] \
            + b["preempted_ms"]
        assert buckets == pytest.approx(b["total_ms"], abs=1.5)
        (fin,) = [e for e in evs if e.kind == "finish"]
        assert fin.attrs["ttft_ms"] > 0 and fin.attrs["tpot_ms"] > 0


def _strip(site):
    return site.rsplit("#", 1)[0]


def test_preemption_events_equal_reference(nets):
    jnet, net = nets
    prompts = _prompts(3)
    jeng = JEngine(jnet, JConfig(attention_kernel="ragged-xla", **PREEMPT))
    jrids, jevs, jout = _serve(jeng, jprof.event_log(), prompts, 16)
    eng = ServingEngine(net, ServingConfig(**PREEMPT))
    shapes = []
    orig = trec.mark_trace

    def spy(site, *trees):
        if site == eng._tick_site:
            shapes.append(trec.signature(*trees))
        orig(site, *trees)

    trec.mark_trace = spy
    try:
        trids, tevs, tout = _serve(eng, tprof.event_log(), prompts, 16)
    finally:
        trec.mark_trace = orig
    assert tout == jout
    _hold(jevs, tevs, jrids, trids)
    kinds = [e.kind for r in trids for e in tevs[r]]
    assert kinds.count("preempt") > 0
    assert kinds.count("preempt") == kinds.count("requeue")
    for r in trids:
        ks = [e.kind for e in tevs[r]]
        for i, k in enumerate(ks):
            if k == "preempt":
                assert ks[i + 1] == "requeue" and "admit" in ks[i + 2:]
    _check_breakdowns(tevs, trids, 16)
    assert any(breakdown_from_events(tevs[r])["preempted_ms"] > 0
               for r in trids)
    stats = eng.latency_stats()
    assert stats["requests"] >= 3 and stats["ttft_ms"]["count"] >= 3
    assert [_strip(s) for s in eng.compiled_sites] == \
        [_strip(s) for s in jeng.compiled_sites] == ["serving.tick"]
    # the reference's tick is one program (a lax.cond holds the
    # decode-only and the mixed branch): one trace. The port runs a
    # decode-only tick at its own shorter shape, so its site counts the
    # distinct tick shapes it ran: the mixed one and the decode-only one
    assert jrec.trace_counts()[jeng._tick_site] == 1
    assert trec.trace_counts()[eng._tick_site] == len(set(shapes)) == 2


def test_twin_spec_events_equal_reference(nets):
    jnet, net = nets
    prompts = _prompts(1)
    jeng = JEngine(jnet, JConfig(attention_kernel="ragged-xla",
                                 spec=JSpec(draft_model=jnet, k=3), **SPEC))
    jrids, jevs, jout = _serve(jeng, jprof.event_log(), prompts, 16)
    eng = ServingEngine(net, ServingConfig(
        spec=SpecConfig(draft_model=net, k=3), **SPEC))
    branches = {"tick": set(), "draft": set()}
    tick, draft = eng._spec_tick, eng._draft.tick

    def spy_tick(*a, **kw):                  # (..., has_chunks, has_drafts)
        branches["tick"].add((bool(a[14]), bool(a[15])))
        return tick(*a, **kw)

    def spy_draft(*a, **kw):                 # (..., has_feed, has_gen)
        branches["draft"].add((bool(a[10]), bool(a[11]),
                               kw.get("chain") is not None))
        return draft(*a, **kw)

    eng._spec_tick, eng._draft.tick = spy_tick, spy_draft
    trids, tevs, tout = _serve(eng, tprof.event_log(), prompts, 16)
    assert tout == jout
    _hold(jevs, tevs, jrids, trids)
    (rid,) = trids
    kinds = [e.kind for e in tevs[rid]]
    assert kinds.index("draft") < kinds.index("verify") \
        < kinds.index("accept")
    accepts = [e for e in tevs[rid] if e.kind == "accept"]
    assert accepts
    for e in accepts:
        assert 0 <= e.attrs["accepted"] <= e.attrs["drafted"]
    _check_breakdowns(tevs, trids, 16)
    b = breakdown_from_events(tevs[rid])
    assert b["spec_drafted"] >= b["spec_accepted"] > 0
    assert [_strip(s) for s in eng.compiled_sites] == \
        [_strip(s) for s in jeng.compiled_sites] == \
        ["serving.tick", "serving.draft"]
    # the reference compiles each of its two sites once (every branch
    # inside one program); each port tick runs its branch at the branch's
    # own shapes, so each site counts the branches it ran
    jc, tc = jrec.trace_counts(), trec.trace_counts()
    assert [jc[s] for s in jeng.compiled_sites] == [1, 1]
    assert tc[eng._tick_site] == len(branches["tick"]) >= 2
    assert tc[eng._draft.site] == len(branches["draft"]) >= 1


def test_cancel_and_trace_ids(nets):
    """``cancel`` emits its reason; a ``trace_id`` rides every event of its
    request; attributes stay plain Python values (the sink writes JSON)."""
    _, net = nets
    eng = ServingEngine(net, ServingConfig(**SPEC))
    log = tprof.event_log()
    seq0 = log.next_seq
    a = eng.submit(_prompts(1)[0], 4, trace_id="g00000007")
    b = eng.submit(_prompts(2)[1], 4)
    assert eng.cancel(b, reason="test")
    eng.run()
    evs = [e for e in log.events(since_seq=seq0)
           if e.attrs.get("eng") == eng._eng_id]
    assert {e.attrs.get("trace") for e in evs if e.rid == a} == \
        {"g00000007"}
    assert [(e.kind, e.attrs.get("reason")) for e in evs if e.rid == b] \
        == [("submit", None), ("cancel", "test")]
    assert eng._eng_id != ServingEngine(net, ServingConfig(**SPEC))._eng_id
