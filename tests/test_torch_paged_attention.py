"""paddle_tpu_torch.ops.paged_attention held against the JAX package.

The port's plain version (what a CPU tensor runs) is compared with the
reference's Pallas kernel in interpret mode and with its XLA spelling on
the same numpy inputs, at atol = rtol = 2e-5 — the tolerance the
reference itself uses between its Pallas kernel and XLA (online softmax
reassociates the sum). Pad queries (i >= true_len) are garbage on every
path and are never compared. The CUDA kernel itself is held against this
plain version on the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch.ops import paged_attention as tpa

TOL = dict(rtol=2e-5, atol=2e-5)

P, PS, NH, HD = 12, 8, 4, 16


def _pools(seed, dtype=np.float32):
    r = np.random.RandomState(seed)
    k = r.randn(P, PS, NH, HD).astype(dtype)
    v = r.randn(P, PS, NH, HD).astype(dtype)
    return r, k, v


def _cases():
    """(q, table, pos0, true_len) row groups of every serving kind."""
    r = np.random.RandomState(7)
    decode = (r.randn(5, 1, NH, HD).astype(np.float32),
              np.array([[3, 0, 0, 0],      # one-page slot
                        [3, 5, 0, 0],      # aliases row 0's page
                        [3, 5, 7, 2],      # fully grown, same prefix
                        [8, 0, 0, 0],      # COW'd divergent tail page
                        [0, 0, 0, 0]],     # inactive slot: null table
                       np.int32),
              np.array([0, 9, 31, 7, 0], np.int32),
              np.ones(5, np.int32))
    chunk = (r.randn(3, 8, NH, HD).astype(np.float32),
             np.array([[3, 5, 7, 2], [3, 5, 0, 0], [6, 1, 4, 0]], np.int32),
             np.array([16, 4, 17], np.int32),
             np.array([8, 5, 3], np.int32))
    # chunk rows next to a pad row (all-null table, true_len 1) and rows
    # whose attended length ends mid-page
    mixed = (r.randn(3, 8, NH, HD).astype(np.float32),
             np.array([[9, 10, 11, 0], [0, 0, 0, 0], [4, 0, 0, 0]],
                      np.int32),
             np.array([11, 0, 0], np.int32),
             np.array([8, 1, 5], np.int32))
    return {"decode": decode, "chunk": chunk, "mixed_pad": mixed}


def _tile_edge_cases():
    """Row groups at the edges of the CUDA chunk-row kernel's tiles:
    (q, table, pos0, true_len, page size). Their oracle is this plain
    version, so it is held to the reference there too."""
    r = np.random.RandomState(11)

    def q(rows, t):
        return r.randn(rows, t, NH, HD).astype(np.float32)

    return {
        # chunk rows whose pos0 is not page-aligned
        "chunk_unaligned": (q(2, 16), np.array([[4, 9, 2, 0], [7, 3, 11, 0]],
                                               np.int32),
                            np.array([5, 13], np.int32),
                            np.array([16, 11], np.int32), PS),
        # T not a multiple of the kernel's query tile; last real query 37
        "t40_true37": (q(1, 40), np.array([[6, 2, 9, 4, 11, 0]], np.int32),
                       np.array([3], np.int32), np.array([37], np.int32),
                       PS),
        # pages of 16 and of 32 positions
        "ps16": (q(2, 24), np.array([[3, 8, 1, 0], [5, 10, 2, 7]], np.int32),
                 np.array([7, 30], np.int32), np.array([24, 20], np.int32),
                 16),
        "ps32": (q(2, 40), np.array([[4, 6, 0], [9, 1, 11]], np.int32),
                 np.array([0, 45], np.int32), np.array([40, 33], np.int32),
                 32),
        # the attended range ends one position into its last page
        "ends_one_into_page": (q(1, 9), np.array([[7, 3, 10, 0]], np.int32),
                               np.array([8], np.int32),
                               np.array([9], np.int32), PS),
    }


def _port(q, k, v, tab, p0, tl):
    with torch.inference_mode():
        return tpa.ragged_paged_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(tab), torch.from_numpy(p0),
            torch.from_numpy(tl)).float().numpy()


def _real(x, tl):
    """Only the real queries of each row."""
    return [x[r, :int(tl[r])] for r in range(x.shape[0])]


@pytest.mark.parametrize("case", ["decode", "chunk", "mixed_pad",
                                  "chunk_unaligned", "t40_true37", "ps16",
                                  "ps32", "ends_one_into_page"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_ragged_plain_matches_reference(case, impl):
    if case in _cases():
        q, tab, p0, tl = _cases()[case]
        _, k, v = _pools(3)
    else:
        q, tab, p0, tl, ps = _tile_edge_cases()[case]
        r = np.random.RandomState(13)
        k = r.randn(P, ps, NH, HD).astype(np.float32)
        v = r.randn(P, ps, NH, HD).astype(np.float32)
    ref = np.asarray(jpa.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tab),
        jnp.asarray(p0), jnp.asarray(tl), impl=impl))
    got = _port(q, k, v, tab, p0, tl)
    for a, b in zip(_real(got, tl), _real(ref, tl)):
        np.testing.assert_allclose(a, b, **TOL)


def test_bf16_pool_under_f32_queries_upcasts_like_reference():
    """kv_dtype='bf16': both packages gather bf16 pages and contract in
    f32, so the same bf16 values give the same f32 result."""
    q, tab, p0, tl = _cases()["chunk"]
    _, k, v = _pools(4)
    kb = jnp.asarray(k, jnp.bfloat16)
    vb = jnp.asarray(v, jnp.bfloat16)
    ref = np.asarray(jpa.ragged_paged_attention(
        jnp.asarray(q), kb, vb, jnp.asarray(tab), jnp.asarray(p0),
        jnp.asarray(tl)))
    kt = torch.from_numpy(np.array(kb.astype(jnp.float32))).bfloat16()
    vt = torch.from_numpy(np.array(vb.astype(jnp.float32))).bfloat16()
    with torch.inference_mode():
        got = tpa.ragged_paged_attention(
            torch.from_numpy(q), kt, vt, torch.from_numpy(tab),
            torch.from_numpy(p0), torch.from_numpy(tl))
    assert got.dtype == torch.float32
    for a, b in zip(_real(got.numpy(), tl), _real(ref, tl)):
        np.testing.assert_allclose(a, b, **TOL)


def test_paged_kv_scatter_matches_reference_in_place():
    r, k, _ = _pools(5)
    page = np.array([3, 3, 0, 7, 0], np.int32)
    off = np.array([0, 1, 5, 7, 5], np.int32)
    vals = r.randn(5, NH, HD).astype(np.float32)
    ref, _ = jpa.paged_kv_scatter(jnp.asarray(k), None, jnp.asarray(page),
                                  jnp.asarray(off), jnp.asarray(vals))
    pool = torch.from_numpy(k.copy())
    out, scale = tpa.paged_kv_scatter(pool, None, torch.from_numpy(page),
                                      torch.from_numpy(off),
                                      torch.from_numpy(vals))
    assert out is pool and scale is None
    ref = np.asarray(ref)
    # every page but the null page (duplicate writes land there in an
    # unspecified order on both sides) matches exactly
    np.testing.assert_array_equal(out.numpy()[1:], ref[1:])


def test_delegating_spellings_equal_ragged_call():
    _, k, v = _pools(6)
    q, tab, p0, _ = _cases()["decode"]
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    qt, tt, pt = (torch.from_numpy(x) for x in (q, tab, p0))
    dec = tpa.paged_decode_attention(qt, kt, vt, tt, pt)
    rag = tpa.ragged_paged_attention(qt, kt, vt, tt, pt,
                                     torch.ones_like(pt))
    torch.testing.assert_close(dec, rag, rtol=0, atol=0)
    qc = torch.from_numpy(_cases()["chunk"][0])
    tc = tt[:3]
    pre = tpa.paged_prefill_attention(qc, kt, vt, tc, 9)
    ragc = tpa.ragged_paged_attention(
        qc, kt, vt, tc, torch.full((3,), 9, dtype=torch.int32),
        torch.full((3,), 8, dtype=torch.int32))
    torch.testing.assert_close(pre, ragc, rtol=0, atol=0)


def test_cpu_tensors_take_plain_version_without_counting_a_launch():
    q, tab, p0, tl = _cases()["decode"]
    _, k, v = _pools(1)
    before = tpa.RAGGED_LAUNCHES
    _port(q, k, v, tab, p0, tl)
    assert tpa.RAGGED_LAUNCHES == before
    # chunk rows (T > 1) on the CPU count no chunk-row launch either
    chunk = tpa.RAGGED_CHUNK_LAUNCHES
    q, tab, p0, tl = _cases()["chunk"]
    _port(q, k, v, tab, p0, tl)
    assert tpa.RAGGED_CHUNK_LAUNCHES == chunk
    assert tpa.RAGGED_LAUNCHES == before


def test_int8_scales_raise_not_implemented():
    """The int8 path is ported (tests/test_torch_kv_quant.py holds it to
    the reference), so scales no longer raise NotImplementedError. What
    raises is a call whose scales and pools disagree: scales beside float
    pools, int8 pools without scales, or scales of the wrong shape."""
    q, tab, p0, tl = _cases()["decode"]
    _, k, v = _pools(2)
    sc = torch.ones(P, NH)
    args = [torch.from_numpy(x) for x in (q, k, v, tab, p0, tl)]
    with pytest.raises(ValueError, match="int8 pools"):
        tpa.ragged_paged_attention(*args, k_scale=sc, v_scale=sc)
    args[1], args[2] = args[1].to(torch.int8), args[2].to(torch.int8)
    with pytest.raises(ValueError, match="int8 pools"):
        tpa.ragged_paged_attention(*args)
    with pytest.raises(ValueError, match="int8 pools"):
        tpa.ragged_paged_attention(*args, k_scale=sc)
    with pytest.raises(TypeError, match=r"\[P, NH\]"):
        tpa.ragged_paged_attention(*args, k_scale=sc[:, :2],
                                   v_scale=sc[:, :2])
    out = tpa.ragged_paged_attention(*args, k_scale=sc, v_scale=sc)
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    pool, scale = tpa.paged_kv_scatter(
        args[1], sc, torch.zeros(1, dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), torch.zeros(1, NH, HD))
    assert pool is args[1] and scale is sc


def _decode_rows(ps, nps=4):
    """One decode group at the lengths where the CUDA decode-row kernel's
    chunks and page splits have their edges: 1 position, exactly one
    page, a page plus one, the full table (nps pages), and a row whose
    only page is the null page. Returns (table, pos0, P)."""
    pages = iter(np.random.RandomState(ps).permutation(
        np.arange(1, 1 + 4 * nps)))
    lengths = [1, ps, ps + 1, nps * ps]
    tab = np.zeros((len(lengths) + 1, nps), np.int32)
    for i, n in enumerate(lengths):
        for j in range((n - 1) // ps + 1):
            tab[i, j] = next(pages)
    pos0 = np.array([n - 1 for n in lengths] + [0], np.int32)
    return tab, pos0, 1 + 4 * nps


@pytest.mark.parametrize("ps", [16, 32])
@pytest.mark.parametrize("pools", ["bf16", "int8"])
def test_decode_rows_plain_matches_pallas_at_page_edges(pools, ps):
    """Decode rows (T == 1) over bf16 pools with bf16 queries, and over
    int8 pools with per-page, per-head scales (the null page at scale 0)
    under f32 queries: the port's plain version against the reference's
    Pallas kernel in interpret mode. int8: f32 on both sides, at TOL.
    bf16: the plain version contracts in bf16 (scores and weights rounded
    to bf16, as the reference's XLA spelling does), the Pallas kernel in
    f32; one bf16 rounding of a score moves a weight by 2^-9 of itself,
    so the outputs agree within one bf16 ulp: rtol 2^-7 plus atol 1e-2
    (an ulp at |o| just over 1)."""
    tab, pos0, npages = _decode_rows(ps)
    r = np.random.RandomState(21 + ps)
    tl = np.ones(len(pos0), np.int32)
    q = r.randn(len(pos0), 1, NH, HD).astype(np.float32)
    if pools == "bf16":
        k = r.randn(npages, ps, NH, HD).astype(np.float32)
        v = r.randn(npages, ps, NH, HD).astype(np.float32)
        qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
        qt, kt, vt = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                      .bfloat16() for a in (qj, kj, vj))
        scales_j, scales_t = {}, {}
        tol = dict(rtol=2 ** -7, atol=1e-2)
    else:
        k = r.randint(-127, 128, (npages, ps, NH, HD)).astype(np.int8)
        v = r.randint(-127, 128, (npages, ps, NH, HD)).astype(np.int8)
        ks = (r.rand(npages, NH) * 0.02 + 0.001).astype(np.float32)
        vs = (r.rand(npages, NH) * 0.02 + 0.001).astype(np.float32)
        ks[0] = vs[0] = 0.0                       # the null page
        qj, kj, vj = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
        qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
        scales_j = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        scales_t = dict(k_scale=torch.from_numpy(ks),
                        v_scale=torch.from_numpy(vs))
        tol = TOL
    ref = jpa.ragged_paged_attention(
        qj, kj, vj, jnp.asarray(tab), jnp.asarray(pos0), jnp.asarray(tl),
        impl="pallas", **scales_j)
    with torch.inference_mode():
        got = tpa.ragged_paged_attention(
            qt, kt, vt, torch.from_numpy(tab), torch.from_numpy(pos0),
            torch.from_numpy(tl), **scales_t)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **tol)
    if pools == "int8":      # the null-page row reads exact zeros
        assert float(got[-1].abs().max()) == 0.0
