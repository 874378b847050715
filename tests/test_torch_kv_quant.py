"""int8 KV pages of paddle_tpu_torch held against the JAX package
(mirrors tests/test_kv_quant.py).

- ``paged_kv_scatter`` on int8 pools: the same seeded writes through the
  reference and the port. Scales agree at rtol 1e-6; the int8 pools are
  equal (were a value to differ, the check says where and holds it to 1
  LSB on at most 0.1% of the elements: a re-quantization ratio rounded
  differently can move a value across a .5 boundary).
- ``_gather_attend`` with scales against the reference's ``impl="xla"``
  and its Pallas kernel in interpret mode, at 1e-5 / 2e-5.
- The scale lifecycle of ``PagePool`` and the engine.
- The port's int8 engine against the JAX int8 engine and against the
  port's own f32 engine on a standard-init (0.02) model, where the greedy
  argmax margin is real: token match >= 0.99, prefix hits, copy-on-write
  and preemption included.

Everything runs the plain versions (CPU tensors); chip_smoke.py holds the
CUDA kernel's int8 path against them on the card.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import GPT as JGPT
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.serving import ServingConfig as JConfig
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.profiler import registry
from paddle_tpu_torch.serving import ServingConfig, ServingEngine
from paddle_tpu_torch.serving.paged_cache import PagePool

REPO = Path(__file__).resolve().parent.parent


def _assert_pools_equal(got, ref, what=""):
    """int8 pools equal; a difference is reported with its place and
    held to <= 1 LSB on <= 0.1% of the elements."""
    got, ref = np.asarray(got, np.int32), np.asarray(ref, np.int32)
    diff = np.abs(got - ref)
    bad = np.argwhere(diff > 0)
    if bad.size:
        where = [tuple(int(i) for i in ix) for ix in bad[:5]]
        assert diff.max() <= 1 and bad.shape[0] <= 1e-3 * diff.size, (
            f"{what}: {bad.shape[0]} of {diff.size} int8 values differ "
            f"(max {diff.max()} LSB), first at {where}")


class _Both:
    """One int8 pool + scale in each package, written in lockstep."""

    def __init__(self, P=4, ps=4, NH=2, D=8):
        self.jp = jnp.zeros((P, ps, NH, D), jnp.int8)
        self.js = jnp.zeros((P, NH), jnp.float32)
        self.tp = torch.zeros(P, ps, NH, D, dtype=torch.int8)
        self.ts = torch.zeros(P, NH)

    def write(self, page, off, vals):
        page = np.asarray(page, np.int32)
        off = np.asarray(off, np.int32)
        vals = np.asarray(vals, np.float32)
        self.jp, self.js = jpa.paged_kv_scatter(
            self.jp, self.js, page, off, jnp.asarray(vals))
        pool, scale = tpa.paged_kv_scatter(
            self.tp, self.ts, torch.from_numpy(page), torch.from_numpy(off),
            torch.from_numpy(vals))
        assert pool is self.tp and scale is self.ts      # in place
        return self

    def check(self, what=""):
        np.testing.assert_allclose(self.ts.numpy(), np.asarray(self.js),
                                   rtol=1e-6, atol=0, err_msg=what)
        # the null page holds whatever its duplicate writes left: skip it
        _assert_pools_equal(self.tp.numpy()[1:], np.asarray(self.jp)[1:],
                            what)
        return self


# ---------------------------------------------------------------------------
# paged_kv_scatter on int8 pools
# ---------------------------------------------------------------------------
def test_scatter_all_zero_page_keeps_scale_zero():
    b = _Both().write([1], [0], np.zeros((1, 2, 8))).check()
    assert float(b.ts.abs().max()) == 0.0 and int(b.tp.abs().max()) == 0


def test_scatter_single_outlier_head_isolated():
    vals = np.full((1, 2, 8), 0.01, np.float32)
    vals[0, 0, 3] = 100.0
    b = _Both().write([2], [1], vals).check()
    deq = b.tp.numpy().astype(np.float32)[2, 1] * b.ts.numpy()[2][:, None]
    assert abs(deq[0, 3] - 100.0) <= 100.0 / 254 + 1e-6
    # head 1's error is bounded by its own (tiny) scale, not the outlier's
    assert np.abs(deq[1] - 0.01).max() <= 0.01 / 254 + 1e-6


def test_scatter_rescale_on_growth_keeps_old_tokens():
    rng = np.random.RandomState(0)
    small = rng.randn(1, 2, 8).astype(np.float32) * 0.1
    big = rng.randn(1, 2, 8).astype(np.float32)
    b = _Both().write([1], [0], small).check("first write")
    b.write([1], [1], big).check("growth")
    s = b.ts.numpy()[1]
    deq0 = b.tp.numpy().astype(np.float32)[1, 0] * s[:, None]
    assert np.abs(deq0 - small[0]).max() <= 1.5 * s.max() + 1e-7
    # steady state: a same-scale rewrite leaves resident content alone
    before, s_before = b.tp.clone(), b.ts.clone()
    b.write([1], [2], small).check("steady state")
    assert torch.equal(b.tp[1, :2], before[1, :2])
    assert torch.equal(b.ts, s_before)


def test_scatter_null_page_scale_stays_zero():
    b = _Both().write([0], [2], np.full((1, 2, 8), 5.0)).check()
    assert float(b.ts[0].abs().max()) == 0.0


def test_scatter_duplicate_pages_of_a_chunk_and_pad_tokens():
    """A chunk landing several tokens in one page (every duplicate
    rewrites the page from the same pre-write content), tokens of two
    pages in one call, pad tokens on the null page, then a second chunk
    that grows the scales of the resident content."""
    rng = np.random.RandomState(3)
    b = _Both(P=6, ps=4, NH=3, D=16)
    page = [2, 2, 2, 2, 5, 5, 0, 0]
    off = [0, 1, 2, 3, 0, 1, 2, 2]
    b.write(page, off, rng.randn(8, 3, 16) * 0.3).check("chunk 1")
    b.write([5, 5, 3, 0], [2, 3, 0, 1],
            rng.randn(4, 3, 16) * 2.0).check("chunk 2 (growth)")
    assert float(b.ts[0].abs().max()) == 0.0
    assert float(b.ts[5].min()) > float(b.ts[2].max())
    # one-token decode writes on top
    for t in range(3):
        b.write([3], [1 + t], rng.randn(1, 3, 16)).check(f"decode {t}")


def test_scatter_unquantized_pool_is_a_plain_scatter():
    pool = torch.zeros(4, 4, 2, 8)
    vals = torch.full((1, 2, 8), 3.25)
    out, sc = tpa.paged_kv_scatter(pool, None, torch.tensor([1]),
                                   torch.tensor([0]), vals)
    assert out is pool and sc is None
    assert torch.equal(pool[1, 0], vals[0])


# ---------------------------------------------------------------------------
# dequantization in the shared gather
# ---------------------------------------------------------------------------
def _quantized_pools(seed=0, P=6, ps=8, NH=4, D=16, toks=20):
    rng = np.random.RandomState(seed)
    k, v = _Both(P, ps, NH, D), _Both(P, ps, NH, D)
    kf = np.zeros((P, ps, NH, D), np.float32)
    vf = np.zeros_like(kf)
    table = np.array([[1, 2, 3]], np.int32)
    for t in range(toks):
        pg, off = [table[0, t // ps]], [t % ps]
        kk = rng.randn(1, NH, D).astype(np.float32)
        vv = rng.randn(1, NH, D).astype(np.float32)
        kf[pg[0], off[0]], vf[pg[0], off[0]] = kk[0], vv[0]
        k.write(pg, off, kk)
        v.write(pg, off, vv)
    k.check("k pool")
    v.check("v pool")
    return (kf, vf), (k, v), table, rng


def _port_attend(q, k, v, table, pos0, tl):
    with torch.inference_mode():
        return tpa.ragged_paged_attention(
            torch.from_numpy(q), k.tp, v.tp, torch.from_numpy(table),
            torch.from_numpy(pos0), torch.from_numpy(tl),
            k_scale=k.ts, v_scale=v.ts)


@pytest.mark.parametrize("impl,tol", [("xla", 1e-5), ("pallas", 2e-5)])
@pytest.mark.parametrize("t", [1, 4], ids=["decode", "chunk"])
def test_int8_gather_attend_matches_reference(impl, tol, t):
    """The port reads ITS pools, the reference its own (equal, checked
    while they were written)."""
    (kf, vf), (k, v), table, rng = _quantized_pools()
    q = rng.randn(1, t, 4, 16).astype(np.float32)
    pos0 = np.array([20 - t], np.int32)
    tl = np.array([t], np.int32)
    ref = jpa.ragged_paged_attention(
        jnp.asarray(q), k.jp, v.jp, jnp.asarray(table), jnp.asarray(pos0),
        jnp.asarray(tl), impl=impl, k_scale=k.js, v_scale=v.js)
    got = _port_attend(q, k, v, table, pos0, tl).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=tol)
    # and the quantized read stays close to the f32 pools'
    with torch.inference_mode():
        f32 = tpa.ragged_paged_attention(
            torch.from_numpy(q), torch.from_numpy(kf), torch.from_numpy(vf),
            torch.from_numpy(table), torch.from_numpy(pos0),
            torch.from_numpy(tl)).numpy()
    assert np.abs(got - f32).max() < 0.05


def test_int8_gather_attend_under_bf16_queries_matches_reference():
    """A bf16 model: the int8 values are cast to bf16 (exact) and the f32
    scales promote the product to f32 on both sides; the softmax weights
    are rounded to bf16 before the second contraction."""
    _, (k, v), table, rng = _quantized_pools(seed=1)
    q = rng.randn(1, 1, 4, 16).astype(np.float32)
    pos0, tl = np.array([19], np.int32), np.array([1], np.int32)
    ref = jpa.ragged_paged_attention(
        jnp.asarray(q, jnp.bfloat16), k.jp, v.jp, jnp.asarray(table),
        jnp.asarray(pos0), jnp.asarray(tl), k_scale=k.js, v_scale=v.js)
    with torch.inference_mode():
        got = tpa.ragged_paged_attention(
            torch.from_numpy(q).bfloat16(), k.tp, v.tp,
            torch.from_numpy(table), torch.from_numpy(pos0),
            torch.from_numpy(tl), k_scale=k.ts, v_scale=v.ts)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    # one bf16 ulp: both round one f32 result
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-3)


def test_null_pages_read_as_zero():
    """A row whose table is all null attends only masked keys; with scale
    0 the null page's bytes dequantize to exact zeros."""
    _, (k, v), _, rng = _quantized_pools()
    k.tp[0] = 77                                   # garbage in the null page
    q = rng.randn(1, 1, 4, 16).astype(np.float32)
    out = _port_attend(q, k, v, np.zeros((1, 3), np.int32),
                       np.array([0], np.int32), np.array([1], np.int32))
    assert bool(torch.isfinite(out).all())
    assert float(out.abs().max()) == 0.0


def test_delegating_spellings_pass_the_scales_through():
    _, (k, v), table, rng = _quantized_pools()
    q = torch.from_numpy(rng.randn(1, 1, 4, 16).astype(np.float32))
    tab = torch.from_numpy(table)
    p0 = torch.tensor([19], dtype=torch.int32)
    want = tpa.ragged_paged_attention(q, k.tp, v.tp, tab, p0,
                                      torch.ones_like(p0), k_scale=k.ts,
                                      v_scale=v.ts)
    dec = tpa.paged_decode_attention(q, k.tp, v.tp, tab, p0, k_scale=k.ts,
                                     v_scale=v.ts)
    torch.testing.assert_close(dec, want, rtol=0, atol=0)
    qc = torch.from_numpy(rng.randn(1, 4, 4, 16).astype(np.float32))
    pre = tpa.paged_prefill_attention(qc, k.tp, v.tp, tab, 16,
                                      k_scale=k.ts, v_scale=v.ts)
    ragc = tpa.ragged_paged_attention(
        qc, k.tp, v.tp, tab, torch.tensor([16], dtype=torch.int32),
        torch.tensor([4], dtype=torch.int32), k_scale=k.ts, v_scale=v.ts)
    torch.testing.assert_close(pre, ragc, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# scale lifecycle of the pool
# ---------------------------------------------------------------------------
def _pool(**kw):
    return PagePool(2, 6, 4, 2, 4, 2, 2, dtype=torch.int8, device="cpu",
                    **kw)


def test_pool_int8_state_and_bytes():
    pool = _pool()
    assert pool.quantized and pool.k.dtype == torch.int8
    assert pool.k_scale.shape == (2, 6, 2) == pool.v_scale.shape
    assert pool.k_scale.dtype == torch.float32
    f32 = PagePool(2, 6, 4, 2, 4, 2, 2, device="cpu")
    assert not f32.quantized and not hasattr(f32, "k_scale")
    assert pool.nbytes == 2 * 2 * 6 * 4 * 2 * 4 + 2 * 2 * 6 * 2 * 4
    assert f32.nbytes == 2 * 2 * 6 * 4 * 2 * 4 * 4


def test_take_fresh_pads_and_resets_overflow_at_once():
    pool = _pool()
    pool._fresh[:] = [1, 2, 3]
    pool.k_scale[:, 1:4] = 7.0
    pool.v_scale[:, 1:4] = 7.0
    fresh = pool.take_fresh(1)
    assert fresh.tolist() == [1] and fresh.dtype == np.int32
    assert pool._fresh == []
    # the overflow pages (2, 3) were reset at once; page 1 is the tick's
    assert float(pool.k_scale[:, 2:4].abs().max()) == 0.0
    assert float(pool.v_scale[:, 2:4].abs().max()) == 0.0
    assert bool((pool.k_scale[:, 1] == 7.0).all())
    assert pool.take_fresh(4).tolist() == [0, 0, 0, 0]    # null-page pad


def test_claim_fresh_drops_duplicates():
    """alloc -> free -> realloc inside one scheduler step lists a page at
    the allocation, at the zero-free (the allocator's on_zero hook) and
    at the reallocation; a COW claim must drop every occurrence."""
    pool = _pool()
    a = pool._alloc(2)
    pool.allocator.free(a)
    b = pool._alloc(1)
    assert pool._fresh.count(b[0]) >= 2
    pool.claim_fresh(b[0])
    assert b[0] not in pool._fresh
    assert any(p != b[0] for p in pool._fresh)


def test_dropped_int8_pool_is_freed_without_a_gc_pass():
    """The allocator's hook holds the pending-reset list, not the pool:
    dropping the last reference frees the pool's tensors at once."""
    import gc
    import weakref

    gc.disable()
    try:
        pool = _pool()
        pool.allocator.free(pool._alloc(2))
        assert len(pool._fresh) == 4          # listed at alloc and at free
        alive = weakref.ref(pool)
        del pool
        assert alive() is None
    finally:
        gc.enable()


def test_unquantized_pool_lists_nothing():
    """A float pool lists no page for a scale reset, at allocation or at
    free; its zero-free hook only ends migration provenance."""
    pool = PagePool(1, 6, 4, 2, 4, 2, 2, device="cpu")
    pool.allocator.free(pool._alloc(2))
    assert pool._fresh == [] and not hasattr(pool, "k_scale")
    pool.claim_fresh(3)                                    # a no-op
    assert pool._fresh == []


def test_cow_copy_carries_scales_and_unlists_the_copy():
    pool = _pool()
    src, dst = pool._alloc(2)
    pool.k[:, src] = torch.arange(32, dtype=torch.int8).reshape(4, 2, 4)
    pool.v[:, src] = 3
    pool.k_scale[:, src] = torch.tensor([[0.5, 0.25], [2.0, 4.0]])
    pool.v_scale[:, src] = 1.5
    pool.take_fresh(8)
    pool._fresh[:] = [dst, 4, dst]
    pool.copy_page(src, dst)
    assert torch.equal(pool.k[:, dst], pool.k[:, src])
    assert torch.equal(pool.v[:, dst], pool.v[:, src])
    assert torch.equal(pool.k_scale[:, dst], pool.k_scale[:, src])
    assert torch.equal(pool.v_scale[:, dst], pool.v_scale[:, src])
    assert pool._fresh == [4]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def nets():
    """The standard-init (0.02) small model of tests/test_kv_quant.py in
    both packages, same weights."""
    kw = dict(vocab_size=128, hidden_size=64, num_layers=4, num_heads=4,
              max_seq_len=256)
    paddle.seed(0)
    jnet = JGPT(JGPTConfig(**kw))
    jnet.eval()
    net = tgpt.GPT(tgpt.GPTConfig(**kw), device="cpu")
    tgpt.load_reference_state(
        net, {k: np.asarray(v._value) for k, v in jnet.state_dict().items()})
    net.eval()
    return jnet, net


def _prompts(n, lens, seed=7, vocab=128):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (lens[i % len(lens)],)).astype(np.int32)
            for i in range(n)]


def _run(net, prompts, max_new, kv_dtype, *, slots=4, page_size=8,
         pages_per_slot=None, **kw):
    pps = pages_per_slot or -(-(max(len(p) for p in prompts) + max_new)
                              // page_size)
    cfg = dict(num_slots=slots, page_size=page_size, pages_per_slot=pps,
               kv_dtype=kv_dtype, **kw)
    if isinstance(net, JGPT):
        eng = JEngine(net, JConfig(attention_kernel="ragged-xla", **cfg))
    else:
        eng = ServingEngine(net, ServingConfig(**cfg))
    rids = [eng.submit(p, max_new) for p in prompts]
    res = eng.run()
    return [res[r] for r in rids], eng


def _match_rate(a_list, b_list):
    tot = mat = 0
    for a, b in zip(a_list, b_list):
        assert len(a) == len(b)
        tot += len(a)
        mat += int((np.asarray(a) == np.asarray(b)).sum())
    return mat / max(tot, 1), tot


def _cow_prompts():
    """A shared prefix diverging mid-page (copy-on-write)."""
    rng = np.random.RandomState(5)
    base = rng.randint(0, 128, (12,)).astype(np.int32)
    prompts = []
    for i in range(5):
        p = base.copy()
        if i:
            p[10:] = rng.randint(0, 128, (2,))
        prompts.append(np.concatenate(
            [p, rng.randint(0, 128, (4,)).astype(np.int32)]))
    return prompts


WORKLOADS = {
    # mixed lengths with an exact-capacity rider (16 + 16 == 32 tokens)
    "mixed_lengths": (lambda: _prompts(6, (5, 9, 16, 8)), 16,
                      dict(pages_per_slot=4)),
    # COW divergence + pool pressure that forces preemption
    "cow_and_preempt": (_cow_prompts, 10,
                        dict(slots=3, pages_per_slot=4, num_pages=8)),
}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_int8_engine_matches_reference_and_f32_engines(nets, name):
    jnet, net = nets
    make, max_new, kw = WORKLOADS[name]
    prompts = make()
    ref, _ = _run(jnet, prompts, max_new, "int8", **kw)
    reg = registry()
    cow0 = reg.counter("cache_share/cow_copies").value
    pre0 = reg.counter("serving/preemptions").value
    hit0 = reg.counter("serving/prefix_hit_tokens").value
    got, eng = _run(net, prompts, max_new, "int8", **kw)
    if name == "cow_and_preempt":
        assert reg.counter("cache_share/cow_copies").value > cow0
        assert reg.counter("serving/preemptions").value > pre0
        assert reg.counter("serving/prefix_hit_tokens").value > hit0
    f32, _ = _run(net, prompts, max_new, None, **kw)
    assert eng.pool.quantized and eng.pool.k.dtype == torch.int8
    assert eng.pool.check_consistency() == []
    rate, tot = _match_rate(ref, got)
    assert tot >= 50
    assert rate >= 0.99, f"vs the JAX int8 engine: {rate} over {tot} tokens"
    rate, tot = _match_rate(f32, got)
    assert rate >= 0.99, f"vs the port's f32 engine: {rate} over {tot}"
    # the null page's scale rows never moved
    assert float(eng.pool.k_scale[:, 0].abs().max()) == 0.0
    assert float(eng.pool.v_scale[:, 0].abs().max()) == 0.0


def test_two_int8_engines_equal_and_prefix_cache_changes_nothing(nets):
    """Two int8 engines on one schedule agree exactly; aliased prefix
    pages hold the int8 content and scales their first tenant wrote, so
    cached == uncached too."""
    _, net = nets
    rng = np.random.RandomState(3)
    system = rng.randint(0, 128, (32,)).astype(np.int32)
    prompts = [np.concatenate([system, rng.randint(0, 128, (4,))
                               .astype(np.int32)]) for _ in range(4)]
    h0 = registry().counter("serving/prefix_hit_tokens").value
    on, _ = _run(net, prompts, 8, "int8", prefix_cache=True)
    assert registry().counter("serving/prefix_hit_tokens").value > h0
    on2, _ = _run(net, prompts, 8, "int8", prefix_cache=True)
    off, _ = _run(net, prompts, 8, "int8", prefix_cache=False)
    for a, b, c in zip(on, on2, off):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_stale_scale_reset_on_reuse(nets):
    """Poison the scales of every free page, then run a workload that
    recycles pages: the streams equal the unpoisoned run's, so a recycled
    page's scales are reset before its first write."""
    _, net = nets
    prompts = _prompts(6, (7, 13), seed=11)
    clean, clean_eng = _run(net, prompts, 12, "int8", slots=2)
    eng = ServingEngine(net, ServingConfig(
        num_slots=2, page_size=8, pages_per_slot=-(-25 // 8),
        kv_dtype="int8"))
    free = torch.tensor(sorted(eng.pool.allocator._free))
    eng.pool.k_scale[:, free] = 1e6
    eng.pool.v_scale[:, free] = 1e6
    rids = [eng.submit(p, 12) for p in prompts]
    res = eng.run()
    for a, r in zip(clean, rids):
        np.testing.assert_array_equal(a, res[r])
    # the scales themselves (greedy tokens of a small model can hide a
    # wrong K scale): every page the clean run wrote holds the clean
    # run's scales, K and V
    for name in ("k_scale", "v_scale"):
        got = getattr(eng.pool, name)
        want = getattr(clean_eng.pool, name)
        written = want > 0
        assert bool(written.any())
        assert torch.equal(got[written], want[written]), name


def test_tick_resets_fresh_scales_before_use_even_past_the_cap(nets):
    """``take_fresh`` runs at the head of the tick, before the scale
    tensors are used: with a cap of 1 the overflow path rewrites the
    scales at once, and the streams still equal the normal run's."""
    _, net = nets
    prompts = _prompts(4, (9, 17), seed=13)
    want, _ = _run(net, prompts, 10, "int8", slots=2)
    eng = ServingEngine(net, ServingConfig(
        num_slots=2, page_size=8, pages_per_slot=4, kv_dtype="int8"))
    eng._fresh_cap = 1
    free = torch.tensor(sorted(eng.pool.allocator._free))
    eng.pool.k_scale[:, free] = 1e6
    eng.pool.v_scale[:, free] = 1e6
    rids = [eng.submit(p, 10) for p in prompts]
    res = eng.run()
    for a, r in zip(want, rids):
        np.testing.assert_array_equal(a, res[r])


def test_int8_schedule_independent_across_admission_orders(nets):
    """A page's scales die with its last reference, so which recycled
    page a request lands on can never tint its output."""
    _, net = nets
    prompts = _prompts(4, (9, 17, 7, 13), seed=13)
    fwd, _ = _run(net, prompts, 10, "int8", slots=2)
    rev, _ = _run(net, list(reversed(prompts)), 10, "int8", slots=2)
    for a, b in zip(fwd, reversed(rev)):
        np.testing.assert_array_equal(a, b)


def test_pool_bytes_about_a_quarter(nets):
    _, net = nets
    _, eng_f = _run(net, _prompts(1, (6,)), 4, None)
    _, eng_q = _run(net, _prompts(1, (6,)), 4, "int8")
    assert eng_q.pool.nbytes < 0.3 * eng_f.pool.nbytes
    assert eng_q.pool.nbytes > 0.25 * eng_f.pool.nbytes   # the scales count


def test_ragged_apply_int8_logits_close_to_f32_pools(nets):
    """gpt_ragged_apply with int8 pools returns the scales too, updates
    them in place, and its logits stay close to the f32-pool run's."""
    _, net = nets
    cfg = net.config
    stacked, other = net._decode_state()
    nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    toks = np.random.RandomState(2).randint(0, 128, 16)
    args = [torch.from_numpy(np.asarray(a, d)) for a, d in (
        (toks, np.int64), (np.arange(16), np.int32),
        (np.full(16, 16), np.int32), ([[1, 2]], np.int32), ([0], np.int32),
        ([16], np.int32), (np.arange(16), np.int64))]
    out = {}
    for kind in ("f32", "int8"):
        dt = torch.int8 if kind == "int8" else torch.float32
        kp = torch.zeros(cfg.num_layers, 3, 8, nh, hd, dtype=dt)
        vp = torch.zeros_like(kp)
        sc = {}
        if kind == "int8":
            sc = dict(kscale=torch.zeros(cfg.num_layers, 3, nh),
                      vscale=torch.zeros(cfg.num_layers, 3, nh))
        with torch.inference_mode():
            res = tgpt.gpt_ragged_apply(cfg, stacked, other, kp, vp, *args,
                                        decode_rows=0, chunk_width=16, **sc)
        assert len(res) == (5 if kind == "int8" else 3)
        if kind == "int8":
            assert res[3] is sc["kscale"] and res[4] is sc["vscale"]
            assert float(res[3][:, 1:].min()) > 0.0
            assert float(res[3][:, 0].abs().max()) == 0.0
        out[kind] = res[0]
    err = float((out["int8"] - out["f32"]).abs().max())
    assert 0.0 < err < 0.02 * float(out["f32"].abs().max())


def test_unknown_kv_dtype_raises(nets):
    _, net = nets
    for bad in ("fp4", "fp8", "int4"):
        with pytest.raises(ValueError, match="kv_dtype"):
            ServingEngine(net, ServingConfig(kv_dtype=bad))


def test_int8_handoff_still_waits_for_the_serving_remainder(nets):
    """The int8 handoff is ported (the name is kept from when it raised):
    a held request's int8 pages round-trip with their scales, and the
    decode engine's stream equals the single int8 engine's."""
    _, net = nets
    kw = dict(num_slots=1, page_size=8, pages_per_slot=4, kv_dtype="int8")
    prompt = _prompts(1, [16])[0]
    single = ServingEngine(net, ServingConfig(**kw))
    sr = single.submit(prompt, 6)
    want = single.run()[sr]
    pe = ServingEngine(net, ServingConfig(**kw))
    rid = pe.submit(prompt, 6, hold_after_prefill=True)
    for _ in range(30):
        pe.step()
        pe.drain(0)
        if rid in pe.held_ready():
            break
    pl = pe.export_held(rid)
    assert pl["kv_dtype"] == "int8" and pl["k"].dtype == np.int8
    assert pl["k_scale"].shape == (net.config.num_layers, 2,
                                   net.config.num_heads)
    pe.release_exported(rid)
    de = ServingEngine(net, ServingConfig(**kw))
    lr = de.admit_prefilled(pl)
    pages = torch.as_tensor(de.pool._held[0])
    np.testing.assert_array_equal(de.pool.k_scale[:, pages].numpy(),
                                  pl["k_scale"])
    np.testing.assert_array_equal(de.pool.v[:, pages].numpy(), pl["v"])
    de.run()
    np.testing.assert_array_equal(de._requests[lr].out, want)
    assert de.pool.check_consistency() == []


def test_new_modules_import_neither_jax_nor_the_jax_package():
    """The int8 slice's modules load in a fresh interpreter without
    pulling in jax or paddle_tpu."""
    code = (
        "import importlib, sys\n"
        "for m in ('paddle_tpu_torch.ops.int8_matmul', "
        "'paddle_tpu_torch.quantization', 'paddle_tpu_torch.nn', "
        "'paddle_tpu_torch.ops.paged_attention', "
        "'paddle_tpu_torch.serving.paged_cache', "
        "'paddle_tpu_torch.serving.engine', "
        "'paddle_tpu_torch.serving.sched', "
        "'paddle_tpu_torch.profiler.device_trace', "
        "'paddle_tpu_torch.profiler.program_stats', "
        "'paddle_tpu_torch.profiler.instrument', "
        "'paddle_tpu_torch.models.gpt'):\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'paddle_tpu' or "
        "m.startswith('paddle_tpu.'))\n"
        "print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
