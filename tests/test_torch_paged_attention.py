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


def _port(q, k, v, tab, p0, tl):
    with torch.inference_mode():
        return tpa.ragged_paged_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(tab), torch.from_numpy(p0),
            torch.from_numpy(tl)).float().numpy()


def _real(x, tl):
    """Only the real queries of each row."""
    return [x[r, :int(tl[r])] for r in range(x.shape[0])]


@pytest.mark.parametrize("case", ["decode", "chunk", "mixed_pad"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_ragged_plain_matches_reference(case, impl):
    q, tab, p0, tl = _cases()[case]
    _, k, v = _pools(3)
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
