"""paddle_tpu_torch's sampled speculative decoding held against the JAX
package's.

With rejection-sampling acceptance and both distributions filtered by
the same per-request temperature/top-k/top-p, each position's law is the
plain sampling law, and fixed-key streams are equal to the plain engine's
at both accept extremes: a twin draft always accepts the plain draw, and
under ``top_k=1`` an independent draft's rejection leaves a one-hot
residual at the plain draw. The port's streams must equal the JAX spec
engine's token for token (gpt_tiny at initializer_range 0.2, weights
copied by ``load_reference_state``), for the synchronous arm and the
overlap arm (``SpecConfig.overlap``: the next draft tick chained on the
verify tick's device outputs), under per-request overrides, preemption
and EOS.

Token equality across two implementations is only meaningful where no
draw is a near tie: every categorical draw the port makes here is
recorded, and no top-two gap of gumbel + logits may fall under 1e-5 (a
row whose best score is NEG_INF, an all-rejected residual never read, is
left out).
"""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import ServingConfig as JConfig
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import SpecConfig as JSpec
from paddle_tpu_torch.core import random as R
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.profiler import registry
from paddle_tpu_torch.serving import ServingConfig, ServingEngine, SpecConfig

GAP = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the test workers share the machine's cores
    (oversubscribed, this file's cases took several times longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _copy(jnet, tcfg):
    net = tgpt.GPT(tcfg, device="cpu")
    tgpt.load_reference_state(
        net, {k: np.asarray(v._value) for k, v in jnet.state_dict().items()})
    net.eval()
    return net


@pytest.fixture(scope="module")
def nets():
    """(JAX target, port target, JAX draft, port draft): gpt_tiny at
    initializer_range 0.2 and an independent 2-layer draft."""
    paddle.seed(0)
    jnet = jgpt.gpt_tiny(initializer_range=0.2)
    jnet.eval()
    net = _copy(jnet, tgpt.GPTConfig(vocab_size=128, hidden_size=64,
                                     num_layers=4, num_heads=4,
                                     max_seq_len=64, initializer_range=0.2))
    kw = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
              max_seq_len=64, initializer_range=0.2)
    paddle.seed(7)
    jdraft = jgpt.GPT(jgpt.GPTConfig(**kw))
    jdraft.eval()
    return jnet, net, jdraft, _copy(jdraft, tgpt.GPTConfig(**kw))


@pytest.fixture
def gaps(monkeypatch):
    """The smallest top-two gap of gumbel + logits over the rows of every
    categorical draw the port makes during the test."""
    seen = []
    orig = R.categorical

    def record(keys, logits):
        nb = keys.dim() - 1
        score = R.gumbel(keys, logits.shape[nb:]) + logits
        top = torch.topk(score.reshape(-1, score.shape[-1]), 2).values
        live = top[:, 0] > -1e8
        if bool(live.any()):
            seen.append(float((top[live, 0] - top[live, 1]).min()))
        return orig(keys, logits)

    monkeypatch.setattr(R, "categorical", record)
    return seen


PROMPTS = [np.arange(8, dtype=np.int32) % 128,
           (np.arange(11, dtype=np.int32) * 3) % 128]
KEYS = [np.asarray(jax.random.PRNGKey(100 + i)) for i in range(2)]
LAW = dict(decode="sampling", temperature=0.9, top_p=0.95)
BASE = dict(num_slots=2, page_size=8, pages_per_slot=4, prefill_chunk=8)


def _run(eng, prompts, keys, max_new, over=None, audit=True):
    over = over or [{}] * len(prompts)
    rids = [eng.submit(p, max_new, key=k, **o)
            for p, k, o in zip(prompts, keys, over)]
    for _ in range(2000):
        if eng.idle():
            break
        eng.step()
        if audit:
            assert eng.pool.check_consistency() == []
    out = eng.run()
    return [out[r].tolist() for r in rids]


def _pair(nets, spec_kw, draft, max_new=12, prompts=PROMPTS, keys=KEYS,
          over=None, **kw):
    """(JAX spec engine streams, port spec engine streams, port engine)."""
    jnet, net, jdraft, tdraft = nets
    jd, td = (jnet, net) if draft == "twin" else (jdraft, tdraft)
    cfg = dict(BASE, **LAW)
    cfg.update(kw)
    jeng = JEngine(jnet, JConfig(attention_kernel="ragged-xla",
                                 spec=JSpec(draft_model=jd, **spec_kw),
                                 **cfg))
    ref = _run(jeng, prompts, keys, max_new, over, audit=False)
    eng = ServingEngine(net, ServingConfig(
        spec=SpecConfig(draft_model=td, **spec_kw), **cfg))
    return ref, _run(eng, prompts, keys, max_new, over), eng


def test_twin_draft_both_arms_equal_reference_and_plain(nets, gaps):
    """Twin draft: every draft accepted; the synchronous and overlap arms
    give the JAX spec engine's streams, which are the plain sampling
    engine's; the overlap arm really chained its draft ticks."""
    jnet, net, _, _ = nets
    reg = registry()
    acc0 = reg.counter("serving/spec_accepted_tokens").value
    ch0 = reg.counter("serving/spec_chained_ticks").value
    con0 = reg.counter("serving/spec_chained_consumed").value
    ref, sync, es = _pair(nets, dict(k=3, overlap=False), "twin", top_k=20)
    _, over, eo = _pair(nets, dict(k=3, overlap=True), "twin", top_k=20)
    plain = _run(ServingEngine(net, ServingConfig(**BASE, **LAW, top_k=20)),
                 PROMPTS, KEYS, 12)
    assert sync == ref == over == plain
    assert reg.counter("serving/spec_accepted_tokens").value > acc0
    assert reg.counter("serving/spec_chained_ticks").value > ch0
    assert reg.counter("serving/spec_chained_consumed").value > con0
    for eng in (es, eo):
        assert eng._draft.aux.total_pages() == 0
    assert gaps and min(gaps) > GAP


@pytest.mark.parametrize("overlap", [False, True])
def test_independent_draft_top_k1_equals_reference(nets, gaps, overlap):
    """Under top_k=1 both filtered laws are one-hot: an accepted draft is
    the target's argmax, a rejection's residual is one-hot at it. Equal
    streams at any accept rate: the all-rejected extreme without a rigged
    draft."""
    ref, got, _ = _pair(nets, dict(k=3, overlap=overlap), "indep", top_k=1)
    assert got == ref
    assert gaps and min(gaps) > GAP


def test_per_request_overrides_equal_reference(nets, gaps):
    """Per-request temperature/top_k/top_p and keys ride the verify
    tick's law (the draft samples under the same per-slot law)."""
    over = [dict(temperature=0.5, top_k=3), dict(top_p=0.5, top_k=0),
            dict(temperature=2.0, top_k=1)]
    prompts = PROMPTS + [(np.arange(9, dtype=np.int32) * 7) % 128]
    keys = KEYS + [np.array([7, 9], np.uint32)]
    ref, got, _ = _pair(nets, dict(k=2, overlap=True), "twin",
                        prompts=prompts, keys=keys, over=over, top_k=20,
                        num_slots=3)
    assert got == ref
    assert gaps and min(gaps) > GAP


def test_eos_and_preemption_mid_speculation_equal_reference(nets, gaps):
    """EOS inside an accepted window truncates the emission mid-absorb;
    an oversubscribed pool (draft pages compete in it) preempts with
    speculation live and chained ticks pending. Streams equal the JAX
    engine's; finished slots returned their draft pages."""
    jnet, net, _, _ = nets
    probe = _run(ServingEngine(net, ServingConfig(**BASE, **LAW, top_k=20)),
                 PROMPTS, KEYS, 12)
    eos = probe[0][4]
    ref, got, eng = _pair(nets, dict(k=3, overlap=True), "twin", top_k=20,
                          eos_token_id=eos)
    assert got == ref and len(got[0]) < 12
    assert eng._draft.aux.total_pages() == 0
    reg = registry()
    pre0 = reg.counter("serving/preemptions").value
    prompts = [(np.arange(8, dtype=np.int32) * m) % 128 for m in (1, 5, 7)]
    keys = [np.asarray(jax.random.PRNGKey(200 + i)) for i in range(3)]
    ref, got, _ = _pair(nets, dict(k=3, overlap=True), "twin", max_new=16,
                        prompts=prompts, keys=keys, top_k=20,
                        pages_per_slot=3, num_pages=5)
    assert reg.counter("serving/preemptions").value > pre0
    assert got == ref
    assert gaps and min(gaps) > GAP


def test_adaptive_decay_returns_draft_pages(nets, gaps):
    """An independent draft decays adaptive depth to 0; the pressure
    ladder's first rung (_reclaim_draft of decayed slots) returns their
    draft pages, and the stream still equals the JAX engine's. The same
    run on the JAX engine, reclaimed at the same step, agrees on the
    pages freed."""
    jnet, net, jdraft, tdraft = nets
    cfg = dict(BASE, **LAW, top_k=20)
    spec = dict(k=3, adaptive=True, reprobe_every=0)
    engs = [JEngine(jnet, JConfig(attention_kernel="ragged-xla",
                                  spec=JSpec(draft_model=jdraft, **spec),
                                  **cfg)),
            ServingEngine(net, ServingConfig(
                spec=SpecConfig(draft_model=tdraft, **spec), **cfg))]
    rids = [e.submit(PROMPTS[0], 14, key=KEYS[0]) for e in engs]
    for _ in range(40):
        for e in engs:
            e.step()
        live = [s for s, r in enumerate(engs[1]._slot_rid) if r is not None]
        if live and all(engs[1]._spec_ctl.depth(s) == 0 for s in live) \
                and engs[1]._draft.aux.total_pages() > 0:
            break
    assert engs[1]._draft.aux.total_pages() > 0
    before = engs[1].pool.allocator.num_allocated
    reg = registry()
    rec0 = reg.counter("serving/spec_draft_pages_reclaimed").value
    freed = [e._reclaim_draft(all_slots=False) for e in engs]
    assert freed[0] == freed[1] > 0
    assert reg.counter("serving/spec_draft_pages_reclaimed").value \
        - rec0 == freed[1]
    assert engs[1]._draft.aux.total_pages() == 0
    assert engs[1].pool.allocator.num_allocated == before - freed[1]
    assert engs[1].pool.check_consistency() == []
    outs = [e.run()[r].tolist() for e, r in zip(engs, rids)]
    assert outs[1] == outs[0]
    assert gaps and min(gaps) > GAP
