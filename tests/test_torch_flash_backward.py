"""The flash-attention backward of paddle_tpu_torch held against the JAX
package.

``ops.flash_attention._bwd`` (its plain versions, which CPU tensors run)
against the reference's ``_bwd`` on ``res`` from ``_flash_fwd_res`` —
the Pallas kernels in interpret mode — at atol = rtol = 3e-5, the
reference's own gradient tolerance (``tests/test_flash_attention.py``):
the single tile (S 128 and the ragged S 1000), the dQ + dK/dV pair
(S 1280 in 5 x 5 tiles of 256, S 2048 in 2 x 2 tiles of 1024), cross
attention whose sides pick different blocks, and the ``delta=`` /
``out_dtype=f32`` overrides. Each case also checks that both packages
pick the same kernel. Then gradients through the autograd Function
against ``jax.grad`` of ``_flash_mha`` with the reference test's
``sum(sin(o))`` loss. The CUDA kernels are held against these plain
versions on the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa

TOL = dict(rtol=3e-5, atol=3e-5)


def _inputs(seed, b, sq, sk, h, d):
    r = np.random.RandomState(seed)
    q = r.randn(b, sq, h, d).astype(np.float32)
    k = r.randn(b, sk, h, d).astype(np.float32)
    v = r.randn(b, sk, h, d).astype(np.float32)
    do = r.randn(b, sq, h, d).astype(np.float32)
    return q, k, v, do


def _spy(monkeypatch, module, names, calls):
    for n in names:
        fn = getattr(module, n)

        def wrapped(*a, _fn=fn, _n=n, **kw):
            calls.append(_n)
            return _fn(*a, **kw)

        monkeypatch.setattr(module, n, wrapped)


def _reference_bwd(q, k, v, do, causal, delta=None, out_dtype=None):
    b, _, h, _ = q.shape
    _, res = jfa._flash_fwd_res(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal, None)
    q3, k3, v3, o3, lse, _, _, s_val, bq, bk = res
    do3 = jfa._reshape_in(jnp.asarray(do))
    grads = jfa._bwd(s_val, causal, bq, bk, (q3, k3, v3, o3, lse), do3,
                     delta=None if delta is None else jnp.asarray(delta),
                     out_dtype=out_dtype)
    return [np.asarray(jfa._reshape_out(g, b, h)) for g in grads], \
        (s_val, bq, bk)


def _port_bwd(q, k, v, do, causal, delta=None, out_dtype=None):
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa._plain_fwd(tq, tk, tv, causal, None)
    bq, bk = tfa._blocks(q.shape[1], k.shape[1], causal)
    grads = tfa._bwd(1.0 / np.sqrt(q.shape[3]), causal, bq, bk,
                     (tq, tk, tv, o, lse), tdo,
                     delta=None if delta is None else torch.from_numpy(delta),
                     out_dtype=out_dtype)
    return grads, (bq, bk)


CASES = [
    # (b, sq, sk, h, d, causal, route)
    (2, 128, 128, 2, 32, True, "single"),
    (2, 128, 128, 2, 32, False, "single"),
    (1, 1000, 1000, 1, 32, True, "single"),       # ragged: one tile of 1000
    (1, 1000, 1000, 1, 32, False, "single"),
    (1, 1280, 1280, 2, 32, True, "pair"),         # 5 x 5 tiles of 256
    (1, 1280, 1280, 1, 32, False, "pair"),
    (1, 2048, 2048, 1, 32, True, "pair"),         # 2 x 2 tiles of 1024
    (1, 128, 640, 2, 32, False, "single"),        # cross: 128 x 640
    (1, 128, 1280, 2, 32, False, "pair"),         # cross: 128 x (5 x 256)
]


@pytest.mark.parametrize("b,sq,sk,h,d,causal,route", CASES)
def test_bwd_matches_reference_and_picks_the_same_kernel(
        monkeypatch, b, sq, sk, h, d, causal, route):
    q, k, v, do = _inputs(sq + sk + int(causal), b, sq, sk, h, d)
    jcalls, tcalls = [], []
    _spy(monkeypatch, jfa, ["_bwd_single_tile"], jcalls)
    _spy(monkeypatch, tfa, ["_bwd_single_tile", "_bwd_dq", "_bwd_dkv"],
         tcalls)
    ref, (_, jbq, jbk) = _reference_bwd(q, k, v, do, causal)
    got, (bq, bk) = _port_bwd(q, k, v, do, causal)
    assert (bq, bk) == (jbq, jbk)
    ref_route = "single" if jcalls else "pair"
    port_route = "single" if tcalls == ["_bwd_single_tile"] else (
        "pair" if tcalls == ["_bwd_dq", "_bwd_dkv"] else tcalls)
    assert ref_route == port_route == route
    for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32 and g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, err_msg=name, **TOL)


@pytest.mark.parametrize("sq", [128, 1280])
def test_delta_and_out_dtype_overrides(sq):
    """Ring attention's hooks: a given delta (the global row's) and f32
    partials from bf16 inputs."""
    q, k, v, do = _inputs(7, 1, sq, sq, 2, 32)
    r = np.random.RandomState(8)
    delta = r.randn(2, sq, 1).astype(np.float32)
    ref, _ = _reference_bwd(q, k, v, do, True, delta=delta)
    got, _ = _port_bwd(q, k, v, do, True, delta=delta)
    for g, x in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), x, **TOL)
    # bf16 inputs: f32 partials against the reference's, and the input
    # dtype by default (bf16 rounding of o and of P/dS on both sides)
    qb, kb, vb, dob = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    _, res = jfa._flash_fwd_res(qb, kb, vb, True, None)
    q3, k3, v3, o3, lse3, _, _, s_val, jbq, jbk = res
    ref = jfa._bwd(s_val, True, jbq, jbk, (q3, k3, v3, o3, lse3),
                   jfa._reshape_in(dob), out_dtype=jnp.float32)
    ref = [np.asarray(jfa._reshape_out(g, 1, 2)) for g in ref]
    tq, tk, tv, tdo = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
    o, lse = tfa._plain_fwd(tq, tk, tv, True, None)
    bq, bk = tfa._blocks(sq, sq, True)
    for out_dtype, want in ((torch.float32, torch.float32),
                            (None, torch.bfloat16)):
        got = tfa._bwd(1 / np.sqrt(32), True, bq, bk, (tq, tk, tv, o, lse),
                       tdo, out_dtype=out_dtype)
        assert all(g.dtype == want for g in got)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.float().numpy(), r, rtol=2e-2,
                                       atol=2e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_matches_jax_grad(causal):
    q, k, v, _ = _inputs(3, 1, 128, 128, 2, 32)

    def loss_ref(q, k, v):
        return jnp.sum(jnp.sin(jfa._flash_mha(q, k, v, causal, None)))

    ref = jax.grad(loss_ref, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = tfa.flash_attention(tq, tk, tv, causal=causal)
    assert not lse.requires_grad
    torch.sin(o).sum().backward()
    for t, r, name in zip((tq, tk, tv), ref, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   err_msg=name, **TOL)


def test_checkpointed_flash_reruns_forward_and_matches(monkeypatch):
    """Under torch.utils.checkpoint the forward runs again in backward and
    the gradients equal the plain autograd of mha_reference."""
    from torch.utils.checkpoint import checkpoint

    q, k, v, _ = _inputs(4, 1, 256, 256, 2, 32)
    grads = []
    for ckpt in (False, True):
        calls = []
        _spy(monkeypatch, tfa, ["_plain_fwd"], calls)
        ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]

        def f(a, b, c):
            return tfa.flash_attention(a, b, c, causal=True)[0]

        o = checkpoint(f, *ts, use_reentrant=False) if ckpt else f(*ts)
        torch.sin(o).sum().backward()
        grads.append([t.grad for t in ts])
        assert len(calls) == (2 if ckpt else 1)
        monkeypatch.undo()
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    torch.sin(tfa.mha_reference(*ts, causal=True)).sum().backward()
    for a, b_, r in zip(grads[0], grads[1], ts):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=0, atol=0)
        np.testing.assert_allclose(a.numpy(), r.grad.numpy(), **TOL)
