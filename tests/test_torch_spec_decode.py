"""paddle_tpu_torch's speculative decoding held against the JAX package's:
greedy streams, ``gpt_ragged_apply(spec_k)``, the shared page economy and
the adaptive-depth controller.

The port's spec engine and the reference's (``attention_kernel=
"ragged-xla"``) serve the same prompts with the same target and draft
weights (gpt_tiny at initializer_range 0.2, copied by
``load_reference_state``); their greedy streams must be EQUAL token for
token, and equal to the port's plain engine's: a twin draft (every draft
accepted: multi-token emission and rewind) and an independent 2-layer
draft (almost every draft rejected), k 1, 3 and 4, prefix hits with a
copy-on-write page, preemption mid-speculation, a request finishing at
exact slot capacity, EOS inside an accepted draft run, adaptive depth,
bf16 pages and int8 pages. The port runs its plain versions here (CPU tensors); the
card's kernels are held against those by chip_smoke.py. The page audit
``check_consistency()`` must be empty after every tick.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.profiler import registry as jregistry
from paddle_tpu.serving import ServingConfig as JConfig
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import SpecConfig as JSpec
from paddle_tpu.serving import paged_cache as jpc
from paddle_tpu.serving.sched import SpecKController as JSpecK
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.profiler import registry
from paddle_tpu_torch.serving import ServingConfig, ServingEngine, SpecConfig
from paddle_tpu_torch.serving import paged_cache as tpc
from paddle_tpu_torch.serving.sched import SpecKController as TSpecK

TOL = dict(rtol=1e-4, atol=1e-4)     # test_torch_gpt.py's: f32, 4 layers


def _copy(jnet, tcfg):
    net = tgpt.GPT(tcfg, device="cpu")
    tgpt.load_reference_state(
        net, {k: np.asarray(v._value) for k, v in jnet.state_dict().items()})
    net.eval()
    return net


@pytest.fixture(scope="module")
def nets():
    """(JAX target, port target, JAX draft, port draft): gpt_tiny at
    initializer_range 0.2 (greedy decode is context dependent), and an
    independent 2-layer draft from another seed (its argmax rarely
    matches the target's)."""
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
    draft = _copy(jdraft, tgpt.GPTConfig(**kw))
    return jnet, net, jdraft, draft


def _news(prompts, max_new):
    return max_new if isinstance(max_new, list) else [max_new] * len(prompts)


def _drive(eng, prompts, max_new, **submit):
    """Serve ``prompts`` (``max_new``: one budget or one per prompt) step
    by step, auditing the page economy after every tick; returns the
    streams in prompt order."""
    rids = [eng.submit(p, n, **submit)
            for p, n in zip(prompts, _news(prompts, max_new))]
    for _ in range(2000):
        if eng.idle():
            break
        eng.step()
        assert eng.pool.check_consistency() == []
    out = eng.run()
    return [out[r].tolist() for r in rids]


def _jax_streams(jnet, jspec, kw, batches):
    eng = JEngine(jnet, JConfig(attention_kernel="ragged-xla", spec=jspec,
                                **kw))
    out = []
    for prompts, max_new in batches:
        rids = [eng.submit(p, n)
                for p, n in zip(prompts, _news(prompts, max_new))]
        res = eng.run()
        out.append([res[r].tolist() for r in rids])
    return out


def _prompts(seed, lens, vocab=128):
    r = np.random.RandomState(seed)
    return [r.randint(0, vocab, (t,)).astype(np.int32) for t in lens]


def _system_prompts():
    r = np.random.RandomState(9)
    system = r.randint(0, 128, (16,)).astype(np.int32)
    ps = [np.concatenate([system, r.randint(0, 128, (8,)).astype(np.int32)])
          for _ in range(4)]
    a = r.randint(0, 128, (16,)).astype(np.int32)
    b = np.concatenate([a[:12], (a[12:] + 1) % 128]).astype(np.int32)
    # both admission orders (the second re-aliases the first's cached
    # pages), then a prompt that diverges from a cached one mid-page
    return [(ps, 8), (ps[::-1], 8), ([a], 8), ([b], 8)]


BASE = dict(num_slots=2, page_size=8, pages_per_slot=3, prefill_chunk=8)
# name: (engine knobs, draft ("twin" or "indep"), k, extra spec knobs,
#        [(prompts, max_new), ...] served one batch after another)
GREEDY = {
    "twin_k3": (BASE, "twin", 3, {}, [(_prompts(3, (8, 16, 8)),
                                       [16, 8, 16])]),
    "indep_k4": (BASE, "indep", 4, {}, [(_prompts(11, (8, 16)), 8)]),
    "twin_k1": (BASE, "twin", 1, {}, [(_prompts(5, (8, 12)), 12)]),
    "preempt_mid_spec": (dict(BASE, num_pages=5), "twin", 3, {},
                         [(_prompts(4, (8, 8, 8)), 16)]),
    "prefix_cow": (dict(BASE, pages_per_slot=5), "twin", 3, {},
                   _system_prompts()),
    # 9 + 24 - 1 == 32 == the slot capacity, beside a co-resident
    "exact_capacity": (dict(BASE, pages_per_slot=4), "twin", 3, {},
                       [(_prompts(6, (9, 8)), [24, 25])]),
    "bf16_kv": (dict(BASE, kv_dtype="bf16"), "twin", 3, {},
                [(_prompts(8, (8, 8)), 16)]),
    "adaptive_indep": (BASE, "indep", 3,
                       dict(adaptive=True, reprobe_every=2),
                       [(_prompts(12, (8, 8)), 16)]),
}


@pytest.mark.parametrize("case", sorted(GREEDY))
def test_greedy_spec_streams_equal_reference_and_plain(nets, case):
    jnet, net, jdraft, draft = nets
    kw, which, k, extra, batches = GREEDY[case]
    jd, td = (jnet, net) if which == "twin" else (jdraft, draft)
    ref = _jax_streams(jnet, JSpec(draft_model=jd, k=k, **extra), kw,
                       batches)
    reg = registry()
    pre0 = reg.counter("serving/preemptions").value
    acc0 = reg.counter("serving/spec_accepted_tokens").value
    hit0 = reg.counter("serving/prefix_hit_tokens").value
    cow0 = reg.counter("cache_share/cow_copies").value
    eng = ServingEngine(net, ServingConfig(
        spec=SpecConfig(draft_model=td, k=k, **extra), **kw))
    plain = ServingEngine(net, ServingConfig(**kw))
    for (prompts, max_new), want in zip(batches, ref):
        got = _drive(eng, prompts, max_new)
        assert got == want
        assert got == _drive(plain, prompts, max_new)
        assert all(len(set(g)) >= 3 for g in got if len(g) >= 8)
    # finished slots return every draft page
    assert eng._draft.aux.total_pages() == 0
    if which == "twin":
        assert reg.counter("serving/spec_accepted_tokens").value > acc0
    if case == "preempt_mid_spec":
        assert reg.counter("serving/preemptions").value > pre0
    if case == "prefix_cow":
        assert reg.counter("serving/prefix_hit_tokens").value > hit0
        assert reg.counter("cache_share/cow_copies").value > cow0
    eng.pool.drop_prefix_cache()
    assert eng.pool.allocator.num_allocated == 0


def test_eos_inside_an_accepted_run_stops_exactly(nets):
    """EOS found inside an accepted draft run truncates the emission at
    it (spec mode reads every verify tick, so there is no lag window)."""
    jnet, net, _, _ = nets
    toks = _prompts(5, (6,))
    plain = _drive(ServingEngine(net, ServingConfig(**BASE)), toks, 12)[0]
    eos = plain[2]
    kw = dict(BASE, eos_token_id=eos)
    ref = _jax_streams(jnet, JSpec(draft_model=jnet, k=3), kw,
                       [(toks, 12)])[0]
    got = _drive(ServingEngine(net, ServingConfig(
        spec=SpecConfig(draft_model=net, k=3), **kw)), toks, 12)
    assert got == ref
    assert got[0] == plain[:plain.index(eos) + 1]


def test_int8_spec_streams(nets):
    """kv_dtype="int8": two port runs are equal, and each request's stream
    equals the JAX int8 spec engine's wherever the plain int8 engines of
    the two packages already agree (int8 pages agree by a match rate, not
    bitwise, across implementations)."""
    jnet, net, _, _ = nets
    kw = dict(BASE, kv_dtype="int8")
    prompts = _prompts(3, (8, 6, 8))
    ref = _jax_streams(jnet, JSpec(draft_model=jnet, k=3), kw,
                       [(prompts, 16)])[0]
    jplain = _jax_streams(jnet, None, kw, [(prompts, 16)])[0]
    tplain = _drive(ServingEngine(net, ServingConfig(**kw)), prompts, 16)
    runs = [_drive(ServingEngine(net, ServingConfig(
        spec=SpecConfig(draft_model=net, k=3), **kw)), prompts, 16)
        for _ in range(2)]
    assert runs[0] == runs[1]
    agree = [i for i in range(len(prompts)) if jplain[i] == tplain[i]]
    assert agree
    for i in agree:
        assert runs[0][i] == ref[i]


def _spec_metadata(ns=3, k=3, w=8, ps=8, nps=8, npages=40, seed=2):
    """A verify tick over scrambled pages: slot 0 speculates 3 deep at
    position 20, slot 1 one deep at 5, slot 2 decodes without drafts at 10
    (row_len 1), then a chunk row mid-prompt and a pad chunk row. The
    slots' pages cover their draft positions."""
    r = np.random.RandomState(seed)
    perm = r.permutation(np.arange(1, npages)).astype(np.int32)
    base = ns * (1 + k)
    nt = base + 2 * w
    tab = np.zeros((ns + 2, nps), np.int32)
    tab[0, :3] = perm[0:3]
    tab[1, :1] = perm[3:4]
    tab[2, :2] = perm[6:8]
    tab[3, :2] = perm[4:6]
    kd = np.array([3, 1, 0], np.int32)
    pos0 = np.array([20, 5, 10], np.int32)
    tokens = r.randint(0, 128, nt).astype(np.int32)
    tok_pos = np.zeros(nt, np.int32)
    tok_limit = np.zeros(nt, np.int32)
    tok_pos[:ns] = pos0
    tok_limit[:ns] = nps * ps
    dj = np.arange(k)[None, :]
    tok_pos[ns:base] = (pos0[:, None] + 1 + dj).reshape(-1)
    tok_limit[ns:base] = np.where(dj < kd[:, None], nps * ps, 0).reshape(-1)
    tok_pos[base:base + w] = 8 + np.arange(w)
    tok_limit[base:base + w] = 16
    row_pos0 = np.array([20, 5, 10, 8, 0], np.int32)
    row_len = np.concatenate([1 + kd, [8, 1]]).astype(np.int32)
    sample = np.zeros((ns, 1 + k), np.int32)
    sample[:, 0] = np.arange(ns)
    sample[:, 1:] = ns + np.arange(ns)[:, None] * k + dj
    sample_ix = np.concatenate([sample.reshape(-1), [base + 7]]) \
        .astype(np.int32)
    return dict(ns=ns, k=k, w=w, ps=ps, npages=npages, tokens=tokens,
                tok_pos=tok_pos, tok_limit=tok_limit, tab=tab,
                row_pos0=row_pos0, row_len=row_len, sample_ix=sample_ix)


NAMES = ("tokens", "tok_pos", "tok_limit", "tab", "row_pos0", "row_len",
         "sample_ix")


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_ragged_apply_spec_k_equals_reference(nets, kv):
    """gpt_ragged_apply(spec_k=3): logits at every verify position and the
    written pages agree with the reference's on the same pools and
    metadata (int8: the scales too). A non-speculating slot riding the
    verify group (row_len 1) gives the logits of the plain layout's decode
    row (spec_k=0) on the same pools."""
    jnet, net, _, _ = nets
    d = _spec_metadata()
    cfg = jnet.config
    L, nh = cfg.num_layers, cfg.num_heads
    shape = (L, d["npages"], d["ps"], nh, cfg.hidden_size // nh)
    r = np.random.RandomState(4)
    k0 = r.randn(*shape).astype(np.float32)
    v0 = r.randn(*shape).astype(np.float32)
    sc0 = {}
    if kv == "int8":
        k0 = np.clip(np.round(k0 * 40), -127, 127).astype(np.int8)
        v0 = np.clip(np.round(v0 * 40), -127, 127).astype(np.int8)
        s = (r.rand(L, d["npages"], nh).astype(np.float32) + 0.5) / 40
        s[:, 0] = 0.0                              # the null page
        sc0 = dict(kscale=s, vscale=s.copy())
    stacked, other = jnet._decode_state()
    jres = jgpt.gpt_ragged_apply(
        cfg, stacked, other, jnp.asarray(k0), jnp.asarray(v0),
        *(jnp.asarray(d[n]) for n in NAMES), decode_rows=d["ns"],
        chunk_width=d["w"], spec_k=d["k"],
        **{n: jnp.asarray(a) for n, a in sc0.items()})
    ts, to = net._decode_state()
    pools = [torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())]
    tsc = {n: torch.from_numpy(a.copy()) for n, a in sc0.items()}
    with torch.inference_mode():
        tres = tgpt.gpt_ragged_apply(
            net.config, ts, to, *pools,
            *(torch.from_numpy(d[n]) for n in NAMES), decode_rows=d["ns"],
            chunk_width=d["w"], spec_k=d["k"], **tsc)
    assert len(tres) == len(jres) == (5 if kv == "int8" else 3)
    np.testing.assert_allclose(tres[0].numpy(), np.asarray(jres[0]), **TOL)
    for got, want in zip(tres[1:], jres[1:]):
        # the null page collects pad writes in an unspecified order
        got, want = got.numpy()[:, 1:], np.asarray(want)[:, 1:]
        if got.dtype == np.int8:
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(got, want, **TOL)
    if kv == "int8":
        return
    # slot 2 (row_len 1) against the plain layout's decode row (spec_k=0)
    ns, k, w = d["ns"], d["k"], d["w"]
    base = ns * (1 + k)
    keep = np.r_[0:ns, base:base + 2 * w]
    plain = {n: d[n] for n in NAMES}
    for n in ("tokens", "tok_pos", "tok_limit"):
        plain[n] = d[n][keep]
    plain["row_len"] = np.array([1, 1, 1, 8, 1], np.int32)
    plain["sample_ix"] = np.array([2], np.int32)
    pools = [torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())]
    with torch.inference_mode():
        lg = tgpt.gpt_ragged_apply(
            net.config, ts, to, *pools,
            *(torch.from_numpy(plain[n]) for n in NAMES), decode_rows=ns,
            chunk_width=w)[0]
    np.testing.assert_allclose(lg.numpy()[0],
                               tres[0].numpy()[2 * (1 + k)], **TOL)


def test_page_economy_equals_reference():
    """One random sequence of target grow/shrink/release, prefix inserts
    and draft (AuxPageTable) grow/shrink/release calls on both packages'
    PagePool: equal tables, refcounts and free lists after every call,
    and an empty audit."""
    pools = []
    for mod in (jpc, tpc):
        kw = dict(num_layers=1, num_pages=14, page_size=4, num_heads=1,
                  head_dim=2, num_slots=3, pages_per_slot=5,
                  prefix_cache=True)
        pool = mod.PagePool(**kw)
        pools.append((pool, mod.AuxPageTable(pool, num_slots=3)))
    r = np.random.RandomState(13)
    toks = np.arange(20, dtype=np.int32)
    for _ in range(300):
        op, slot = int(r.randint(7)), int(r.randint(3))
        n = int(r.randint(0, 4))
        res = []
        for pool, aux in pools:
            if op == 0:
                room = pool.pages_per_slot - pool.slot_pages(slot)
                res.append(pool.grow_slot(slot, min(n, room)))
            elif op == 1:
                res.append(pool.shrink_slot(slot, n))
            elif op == 2:
                res.append(pool.release_slot(slot))
            elif op == 3:
                res.append(aux.grow_to(slot, n * 5))
            elif op == 4:
                res.append(aux.shrink_slot(slot, n))
            elif op == 5:
                res.append(aux.release_slot(slot))
            else:
                held = pool.slot_pages(slot)
                res.append(pool.prefix.insert(
                    toks[:held * 4], [int(p) for p in
                                      pool.tables[slot, :held]]))
        assert res[0] == res[1]
        (jp, ja), (tp, ta) = pools
        np.testing.assert_array_equal(jp.tables, tp.tables)
        np.testing.assert_array_equal(ja.tables, ta.tables)
        assert jp.allocator._ref == tp.allocator._ref
        assert jp.allocator._free == tp.allocator._free
        assert tp.check_consistency() == [] == jp.check_consistency()
    assert ta.total_pages() == ja.total_pages()


def test_spec_k_controller_equals_reference():
    """The same random call sequence on both packages' controller: equal
    depths, tick depths, EWMAs, probe flags and probe periods. The
    reference's own pins of two of its engine tests fail in the reference
    (ROADMAP queue 3), so the port is held to the reference class's
    outputs, not to those pins."""
    args = (4, 4, 0.5, 3)
    js, ts = JSpecK(*args), TSpecK(*args)
    r = np.random.RandomState(17)
    for _ in range(400):
        slot, op = int(r.randint(4)), int(r.randint(4))
        if op == 0:
            js.reset(slot)
            ts.reset(slot)
        elif op == 1:
            assert js.tick_depth(slot) == ts.tick_depth(slot)
        else:
            drafted = int(r.randint(0, 5))
            acc = int(r.randint(0, drafted + 1)) if op == 2 else 0
            js.observe(slot, acc, drafted)
            ts.observe(slot, acc, drafted)
        for s in range(4):
            assert js.depth(s) == ts.depth(s)
            assert js.ewma(s) == ts.ewma(s)
            assert js.probing(s) == ts.probing(s)
            assert js.probe_period(s) == ts.probe_period(s)
    for bad in (dict(ewma_alpha=0.0), dict(reprobe_every=-1)):
        for cls in (JSpecK, TSpecK):
            with pytest.raises(ValueError):
                cls(2, 4, **bad)


SPEC_COUNTERS = ("spec_draft_ticks", "spec_feed_tokens",
                 "spec_drafted_tokens", "spec_accepted_tokens", "ticks",
                 "tokens_generated", "prefills", "preemptions")


def test_spec_metrics_equal_reference(nets):
    """After the same run (an oversubscribed pool, so draft pages and
    preemption both come into play), the spec counters and gauges equal
    the JAX engine's."""
    jnet, net, _, _ = nets
    kw = dict(BASE, num_pages=6)
    prompts = _prompts(21, (8, 8, 8))

    def snap(reg):
        return {n: reg.counter("serving/" + n).value for n in SPEC_COUNTERS}

    j0, t0 = snap(jregistry()), snap(registry())
    jh0 = jregistry().histogram("serving/spec_accept_len").count
    th0 = registry().histogram("serving/spec_accept_len").count
    _jax_streams(jnet, JSpec(draft_model=jnet, k=3), kw, [(prompts, 16)])
    _drive(ServingEngine(net, ServingConfig(
        spec=SpecConfig(draft_model=net, k=3), **kw)), prompts, 16)
    j1, t1 = snap(jregistry()), snap(registry())
    jd = {n: j1[n] - j0[n] for n in SPEC_COUNTERS}
    td = {n: t1[n] - t0[n] for n in SPEC_COUNTERS}
    assert td == jd and td["spec_accepted_tokens"] > 0
    assert registry().histogram("serving/spec_accept_len").count - th0 \
        == jregistry().histogram("serving/spec_accept_len").count - jh0
    for g in ("spec_rows", "spec_k_effective"):       # the last tick's
        assert registry().gauge("serving/" + g).value == \
            pytest.approx(jregistry().gauge("serving/" + g).value)
    # the accept rate is over the registry's whole life: each package's
    # gauge is its own counters' ratio
    for reg in (registry(), jregistry()):
        assert reg.gauge("serving/spec_accept_rate").value == pytest.approx(
            reg.counter("serving/spec_accepted_tokens").value
            / reg.counter("serving/spec_drafted_tokens").value)


def test_spec_validation_errors_equal_reference(nets):
    """The reference's validation: legacy plus spec, overlap without
    sampling, k < 1, a vocab mismatch and a draft context shorter than the
    target's raise the same ValueError in both packages; legacy alone
    builds the legacy engine."""
    jnet, net, _, _ = nets
    base = dict(num_slots=1, page_size=8, pages_per_slot=2)

    def pair(seed, **kw):
        paddle.seed(seed)
        cfg = dict(vocab_size=128, hidden_size=32, num_layers=1,
                   num_heads=2, max_seq_len=64)
        cfg.update(kw)
        j = jgpt.GPT(jgpt.GPTConfig(**cfg))
        return j, _copy(j, tgpt.GPTConfig(**cfg))

    other_vocab, short_ctx = pair(1, vocab_size=64), pair(2, max_seq_len=16)
    cases = [(dict(decode="greedy"), (jnet, net), dict(k=2, overlap=True)),
             (dict(attention_kernel="legacy"), (jnet, net), dict(k=2)),
             ({}, (jnet, net), dict(k=0)),
             ({}, other_vocab, dict(k=2)),
             ({}, short_ctx, dict(k=2))]
    for kw, (jd, td), skw in cases:
        with pytest.raises(ValueError) as je:
            JEngine(jnet, JConfig(spec=JSpec(draft_model=jd, **skw),
                                  **base, **kw))
        with pytest.raises(ValueError) as te:
            ServingEngine(net, ServingConfig(
                spec=SpecConfig(draft_model=td, **skw), **base, **kw))
        assert str(te.value) == str(je.value)
    # legacy alone builds the two-dispatch engine
    assert len(ServingEngine(net, ServingConfig(
        attention_kernel="legacy", **base)).compiled_sites) == 2
