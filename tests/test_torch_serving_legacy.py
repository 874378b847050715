"""The serving engine's legacy two-dispatch mode held against the JAX
package's (``attention_kernel="legacy"``).

The legacy engine runs a prefill program per prompt chunk
(``gpt_paged_suffix_apply``: one slot's chunk as one ragged row) and one
fixed-shape ``[num_slots, 1]`` decode tick per step. On the same weights
(gpt_tiny at initializer_range 0.2, copied by ``load_reference_state``)
its streams equal the JAX legacy engine's token for token, greedy and
sampled, with prefix hits, copy-on-write and preemption, and equal the
port's unified engine's. The port runs its plain versions here (CPU
tensors).

The JAX legacy engine passes ``self._slot_len`` and ``self.pool.tables``
to its jitted tick without a copy (``np.ascontiguousarray`` returns a
contiguous array itself), and the CPU backend may alias a numpy argument;
the host then updates both in place while the tick may still be queued,
so an early tick can read the next step's positions. ``_copied`` hands
the JAX engine copies of its numpy arguments, so the reference computes
what its code says.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import ServingConfig as JConfig
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.profiler import recompile, registry
from paddle_tpu_torch.serving import ServingConfig, ServingEngine, SpecConfig
from paddle_tpu_torch.serving.engine import ATTENTION_KERNELS

#: f32 logits and pools of one chunk through 4 layers, two packages
SUFFIX_TOL = 1e-5


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


def _copied(jeng):
    """The JAX legacy engine with its dispatches handed copies of their
    numpy arguments (see the module docstring)."""
    for name in ("_tick", "_prefill"):
        fn = getattr(jeng, name)
        setattr(jeng, name, lambda *a, fn=fn: fn(
            *[np.array(x) if isinstance(x, np.ndarray) else x for x in a]))
    return jeng


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
}
LAWS = {"greedy": {},
        "sampling": dict(decode="sampling", temperature=0.9, top_k=40,
                         top_p=0.9, seed=21)}


@pytest.mark.parametrize("case", [(0, 0), (8, 0), (16, 5)],
                         ids=["pos0_0_full", "pos0_8_full", "pos0_16_tail"])
def test_paged_suffix_apply_equals_reference(nets, case):
    """One chunk of 8 tokens at pos0 through gpt_paged_suffix_apply in
    both packages over the same seeded pools: the logits at the sampled
    index and every written page agree at SUFFIX_TOL (the null page
    takes the pad tokens' writes in an unspecified order and is left
    out)."""
    import jax.numpy as jnp

    from paddle_tpu.models.gpt import gpt_paged_suffix_apply as jsuffix

    jnet, net = nets
    pos0, short = case
    cfg = net.config
    t, ps, nps, npages = 8, 4, 8, 12
    nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    rng = np.random.RandomState(5 + pos0)
    kp = rng.randn(cfg.num_layers, npages, ps, nh, hd).astype(np.float32)
    vp = rng.randn(cfg.num_layers, npages, ps, nh, hd).astype(np.float32)
    toks = rng.randint(0, 128, (1, t)).astype(np.int32)
    true_len = pos0 + t - short
    row = np.zeros(nps, np.int32)
    n_pages = -(-true_len // ps)
    row[:n_pages] = rng.choice(np.arange(1, npages), n_pages, replace=False)
    li = min(max(true_len - 1 - pos0, 0), t - 1)
    js, jo = jnet._decode_state()
    jl, jk, jv = jsuffix(jnet.config, js, jo, jnp.asarray(kp),
                         jnp.asarray(vp), jnp.asarray(toks), pos0,
                         true_len, jnp.asarray(row), li)
    ts, to = net._decode_state()
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    with torch.inference_mode():
        tl, tk, tv = tgpt.gpt_paged_suffix_apply(
            cfg, ts, to, tk, tv, torch.from_numpy(toks).long(), pos0,
            true_len, torch.from_numpy(row), li)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=SUFFIX_TOL,
                               atol=SUFFIX_TOL)
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:],
                               rtol=SUFFIX_TOL, atol=SUFFIX_TOL)
    np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:],
                               rtol=SUFFIX_TOL, atol=SUFFIX_TOL)
    # the chunk's real tokens were written; pages no token reached kept
    # their content
    written = row[pos0 // ps:n_pages].tolist()
    for pg in written:
        assert not np.array_equal(tk.numpy()[:, pg], kp[:, pg])
    untouched = sorted(set(range(1, npages)) - set(written))
    np.testing.assert_array_equal(tk.numpy()[:, untouched], kp[:, untouched])


@pytest.mark.parametrize("law", sorted(LAWS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_legacy_streams_equal_reference_engine(nets, case, law):
    jnet, net = nets
    kw = dict(CASES[case], attention_kernel="legacy", **LAWS[law])
    prompts = _prompts()
    jeng = _copied(JEngine(jnet, JConfig(**kw)))
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


@pytest.mark.parametrize("law", sorted(LAWS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_legacy_streams_equal_unified_engine(nets, case, law):
    """The two dispatch structures compute the same tokens: the legacy
    engine's streams equal the port's unified engine's."""
    _, net = nets
    kw = dict(CASES[case], **LAWS[law])
    prompts = _prompts()
    outs = []
    for kernel in (None, "legacy"):
        eng = ServingEngine(net, ServingConfig(attention_kernel=kernel,
                                               **kw))
        rids = [eng.submit(p, 12) for p in prompts]
        got = eng.run()
        outs.append([got[r].tolist() for r in rids])
    assert outs[0] == outs[1]


def test_legacy_has_two_sites_of_one_shape_each(nets):
    """The tick and the prefill program are fixed-shape: each legacy
    dispatch site runs exactly one argument signature."""
    _, net = nets
    kw = dict(CASES["prefix_cow"], attention_kernel="legacy")
    eng = ServingEngine(net, ServingConfig(**kw))
    for p in _prompts():
        eng.submit(p, 6)
    eng.run()
    sites = eng.compiled_sites
    assert [s.rsplit("#", 1)[0] for s in sites] == ["serving.tick",
                                                    "serving.prefill"]
    counts = recompile.trace_counts()
    assert [counts[s] for s in sites] == [1, 1]


def test_legacy_exact_capacity_equals_reference(nets):
    """A request whose prompt plus budget fills its slot exactly (56 + 9 -
    1 == 64 == slot capacity == max_seq_len) finishes at pos == cap and
    keeps riding the fixed-shape tick beside a longer request: its write
    goes to the null page and its position row is clamped to wpe's last,
    as the reference's gather clamps it."""
    jnet, net = nets
    r = np.random.RandomState(9)
    prompts = [r.randint(0, 128, (56,)).astype(np.int32),
               r.randint(0, 128, (6,)).astype(np.int32)]
    budgets = [9, 30]
    kw = dict(num_slots=2, page_size=8, prefill_chunk=16,
              attention_kernel="legacy", max_inflight=3)
    assert net.config.max_seq_len == 64
    jeng = _copied(JEngine(jnet, JConfig(**kw)))
    jr = [jeng.submit(p, n) for p, n in zip(prompts, budgets)]
    ref = jeng.run()
    eng = ServingEngine(net, ServingConfig(**kw))
    assert eng.pool.slot_capacity == 64
    tr = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
    seen = []
    orig = eng._tick

    def spy(*a):
        seen.append(int(a[5].max()))
        return orig(*a)

    eng._tick = spy
    got = eng.run()
    assert 64 in seen            # a tick rode with pos == slot capacity
    for a, b, n in zip(jr, tr, budgets):
        assert got[b].shape == (n,)
        np.testing.assert_array_equal(got[b], ref[a])
    assert eng.pool.check_consistency() == []


@pytest.mark.parametrize("knob", [
    "spec", "scheduler", "kv_int8", "kv_bf16", "unknown_kernel",
    "impl_name_xla", "impl_name_pallas"])
def test_legacy_value_errors(nets, knob):
    """The reference's ValueErrors: legacy refuses speculative decoding,
    non-fifo schedulers and a pool dtype other than the model's; an
    unknown kernel name is refused, the reference's impl names 'xla' and
    'pallas' included (the port has no ``attention_impl`` alias)."""
    _, net = nets
    kw = {
        "spec": dict(attention_kernel="legacy",
                     spec=SpecConfig(draft_model=net, k=2)),
        "scheduler": dict(attention_kernel="legacy", scheduler="sjf"),
        "kv_int8": dict(attention_kernel="legacy", kv_dtype="int8"),
        "kv_bf16": dict(attention_kernel="legacy", kv_dtype="bf16"),
        "unknown_kernel": dict(attention_kernel="flash"),
        "impl_name_xla": dict(attention_kernel="xla"),
        "impl_name_pallas": dict(attention_kernel="pallas"),
    }[knob]
    with pytest.raises(ValueError):
        ServingEngine(net, ServingConfig(num_slots=1, page_size=8,
                                         pages_per_slot=4, **kw))


@pytest.mark.parametrize("kw", [
    dict(attention_kernel="ragged-xla"), dict(attention_kernel="ragged-pallas"),
    dict(attention_kernel="legacy", kv_dtype="f32")],
    ids=["ragged_xla", "ragged_pallas", "legacy_f32_pool"])
def test_kernel_names_build_their_engine(nets, kw):
    """Both ragged names build the unified engine (one site, the same
    stream as the default); legacy with an explicit pool dtype equal to
    the model's is legal."""
    _, net = nets
    cfg = dict(num_slots=2, page_size=8, pages_per_slot=4, prefill_chunk=8)
    p = _prompts()[2]
    base = ServingEngine(net, ServingConfig(**cfg))
    rb = base.submit(p, 6)
    want = base.run()[rb]
    eng = ServingEngine(net, ServingConfig(**cfg, **kw))
    legacy = kw.get("attention_kernel") == "legacy"
    assert eng.attention_kernel in ATTENTION_KERNELS
    assert len(eng.compiled_sites) == (2 if legacy else 1)
    r = eng.submit(p, 6)
    np.testing.assert_array_equal(eng.run()[r], want)
