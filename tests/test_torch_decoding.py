"""paddle_tpu_torch.ops.decoding held against paddle_tpu.ops.decoding.

The same numpy inputs go through both modules: the filters, the three
decode loops over a toy step function (a Markov table of logits), and the
speculative acceptance functions on the same keys. Tokens must be equal;
scores and probabilities agree to f32 rounding.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import decoding as JD
from paddle_tpu_torch.core import random as R
from paddle_tpu_torch.ops import decoding as TD


def _logits(seed, n=4, v=64, scale=2.0):
    return (np.random.RandomState(seed).randn(n, v) * scale) \
        .astype(np.float32)


def _filtered_equal(got, want):
    """Same masked set; unmasked logits unchanged (bitwise)."""
    got = np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_array_equal(got <= TD.NEG_INF / 2,
                                  want <= JD.NEG_INF / 2)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- filters
@pytest.mark.parametrize("k,p", [(0, 1.0), (5, 1.0), (0, 0.9), (10, 0.5),
                                 (64, 0.95), (1, 1.0), (3, 0.0)])
def test_apply_top_k_top_p_equals_reference(k, p):
    lg = _logits(k + int(p * 10))
    _filtered_equal(TD.apply_top_k_top_p(torch.from_numpy(lg), k, p),
                    JD.apply_top_k_top_p(jnp.asarray(lg), k, p))


@pytest.mark.parametrize("k", [8, 9, 1000, 0, -1, -5])
def test_top_k_out_of_range_is_noop(k):
    lg = _logits(0, 2, 8, 1.0)
    np.testing.assert_array_equal(
        TD.apply_top_k_top_p(torch.from_numpy(lg), top_k=k).numpy(), lg)
    np.testing.assert_array_equal(
        np.asarray(JD.apply_top_k_top_p(jnp.asarray(lg), top_k=k)), lg)


@pytest.mark.parametrize("p", [0.0, 1e-9, 0.3])
def test_top_p_degenerate_keeps_argmax(p):
    lg = np.array([[0.1, 2.0, -1.0, 0.5]], np.float32)
    out = TD.apply_top_k_top_p(torch.from_numpy(lg), top_p=p).numpy()
    assert out[0, 1] > TD.NEG_INF / 2
    assert (out[0, [0, 2, 3]] <= TD.NEG_INF / 2).all()
    _filtered_equal(out, JD.apply_top_k_top_p(jnp.asarray(lg), top_p=p))


def test_top_p_keeps_smallest_prefix():
    lg = np.log(np.array([[0.5, 0.3, 0.15, 0.05]], np.float32))
    out = TD.apply_top_k_top_p(torch.from_numpy(lg), top_p=0.7).numpy()
    assert (out[0, :2] > TD.NEG_INF / 2).all()
    assert (out[0, 2:] <= TD.NEG_INF / 2).all()


def test_top_k_then_degenerate_top_p_compose():
    lg = np.array([[0.1, 2.0, -1.0, 0.5]], np.float32)
    out = TD.apply_top_k_top_p(torch.from_numpy(lg), top_k=2, top_p=0.0)
    _filtered_equal(out, JD.apply_top_k_top_p(jnp.asarray(lg), 2, 0.0))
    assert out[0, 1] > TD.NEG_INF / 2


def test_per_row_filter_equals_reference():
    """Every row its own params, the disabled sentinels included; each
    row also equals the scalar filter with its params."""
    ks = np.array([0, 5, 64, -1, 1, 12, 3, 100], np.int32)
    ps = np.array([1.0, 1.0, 0.9, 0.5, 1.0, 0.0, 0.95, 1.5], np.float32)
    lg = _logits(7, len(ks))
    got = TD.apply_top_k_top_p_per_row(torch.from_numpy(lg),
                                       torch.from_numpy(ks),
                                       torch.from_numpy(ps)).numpy()
    _filtered_equal(got, JD.apply_top_k_top_p_per_row(
        jnp.asarray(lg), jnp.asarray(ks), jnp.asarray(ps)))
    for i in range(len(ks)):
        one = TD.apply_top_k_top_p(torch.from_numpy(lg[i:i + 1]),
                                   int(ks[i]), float(ps[i])).numpy()
        np.testing.assert_array_equal(got[i:i + 1], one)


# ---------------------------------------------------- decode loops, toy step
V, STEPS = 12, 6


def _table(seed=5):
    rng = np.random.RandomState(seed)
    return (rng.randn(V, V).astype(np.float32) * 2.0,
            rng.randn(3, V).astype(np.float32) * 2.0)


def _jstep(table):
    t = jnp.asarray(table)

    def step(cache, tok, pos):
        return t[tok] + 0.01 * pos, {"n": cache["n"] + 1}
    return step


def _tstep(table):
    t = torch.from_numpy(table)

    def step(cache, tok, pos):
        return t[tok] + 0.01 * pos, {"n": cache["n"] + 1}
    return step


@pytest.mark.parametrize("eos", [None, 3])
def test_greedy_decode_equals_reference(eos):
    table, first = _table()
    jids, jc = JD.greedy_decode(_jstep(table), {"n": jnp.zeros(3)},
                                jnp.asarray(first), 4, STEPS, eos)
    tids, tc = TD.greedy_decode(_tstep(table), {"n": torch.zeros(3)},
                                torch.from_numpy(first), 4, STEPS, eos)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tc["n"].numpy(), np.asarray(jc["n"]))


@pytest.mark.parametrize("kw", [
    dict(), dict(top_k=4), dict(top_p=0.8, temperature=0.7),
    dict(top_k=5, top_p=0.9, temperature=1.3, eos_token_id=2),
    dict(top_k=1)], ids=["plain", "topk", "topp_temp", "all_eos", "k1"])
def test_sampling_decode_equals_reference(kw):
    table, first = _table(6)
    for seed in (0, 3, 11):
        jids, _ = JD.sampling_decode(
            _jstep(table), {"n": jnp.zeros(3)}, jnp.asarray(first), 4,
            STEPS, jax.random.PRNGKey(seed), **kw)
        tids, _ = TD.sampling_decode(
            _tstep(table), {"n": torch.zeros(3)}, torch.from_numpy(first),
            4, STEPS, R.PRNGKey(seed, device="cpu"), **kw)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))


@pytest.mark.parametrize("k,lp,eos", [(1, 0.0, None), (3, 0.0, None),
                                      (4, 0.8, None), (4, 1.0, 2),
                                      (2, 0.0, 5)])
def test_beam_search_decode_equals_reference(k, lp, eos):
    table, first = _table(7)
    first = first[:2]
    jids, js = JD.beam_search_decode(
        _jstep(table), {"n": jnp.zeros(2 * k)}, jnp.asarray(first), 0,
        STEPS, k, length_penalty=lp, eos_token_id=eos)
    tids, ts = TD.beam_search_decode(
        _tstep(table), {"n": torch.zeros(2 * k)}, torch.from_numpy(first),
        0, STEPS, k, length_penalty=lp, eos_token_id=eos)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)


def test_tile_cache_for_beams_equals_reference():
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    want = JD.tile_cache_for_beams((jnp.asarray(a), {"b": jnp.asarray(a)}),
                                   3)
    got = TD.tile_cache_for_beams((torch.from_numpy(a),
                                   {"b": torch.from_numpy(a)}), 3)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1]["b"].numpy(),
                                  np.asarray(want[1]["b"]))


# --------------------------------------------------- speculative acceptance
def test_spec_accept_length_equals_reference():
    rng = np.random.RandomState(4)
    d = rng.randint(0, 3, (16, 5)).astype(np.int32)
    t = rng.randint(0, 3, (16, 5)).astype(np.int32)
    n = rng.randint(0, 6, (16,)).astype(np.int32)
    want = np.asarray(JD.spec_accept_length(jnp.asarray(d), jnp.asarray(t),
                                            jnp.asarray(n)))
    got = TD.spec_accept_length(torch.from_numpy(d), torch.from_numpy(t),
                                torch.from_numpy(n)).numpy()
    np.testing.assert_array_equal(got, want)


def _spec_inputs(seed, n=6, k=3, v=40, twin=False):
    rng = np.random.RandomState(seed)
    tl = (rng.randn(n, k + 1, v) * 2).astype(np.float32)
    temps = rng.uniform(0.5, 1.5, n).astype(np.float32)
    top_ks = np.array([0, 5, 10, 0, 3, 40][:n], np.int32)
    top_ps = np.array([1.0, 0.9, 1.0, 0.8, 1.0, 0.95][:n], np.float32)
    if twin:
        src = tl[:, :k]
    else:
        src = (rng.randn(n, k, v) * 2).astype(np.float32)
    lg = src / np.maximum(temps, 1e-6)[:, None, None]
    lg = JD.apply_top_k_top_p_per_row(
        jnp.asarray(lg.reshape(n * k, v)), jnp.repeat(top_ks, k),
        jnp.repeat(top_ps, k))
    dp = np.asarray(jax.nn.softmax(lg, -1)).reshape(n, k, v)
    dt = np.stack([[rng.choice(v, p=dp[i, j] / dp[i, j].sum())
                    for j in range(k)] for i in range(n)]).astype(np.int32)
    nd = np.array([3, 2, 0, 3, 1, 3][:n], np.int32)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))
    pos = rng.randint(5, 50, n).astype(np.int32)
    return tl, dp, dt, nd, keys, pos, temps, top_ks, top_ps


@pytest.mark.parametrize("seed,twin", [(0, False), (1, False), (2, True),
                                       (3, True)])
def test_spec_rejection_sample_equals_reference(seed, twin):
    args = _spec_inputs(seed, twin=twin)
    jt, ja = JD.spec_rejection_sample(*[jnp.asarray(a) for a in args])
    tt, ta = TD.spec_rejection_sample(*[torch.from_numpy(np.array(a))
                                        for a in args])
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    if twin:     # ratio 1: every offered draft is accepted
        np.testing.assert_array_equal(ta.numpy(), args[3])
