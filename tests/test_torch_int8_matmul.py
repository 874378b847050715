"""paddle_tpu_torch.ops.int8_matmul held against the JAX package.

The same seeded numpy inputs go through the reference's
``int8_linear_fused`` / ``int8_matmul`` (its Pallas kernel in interpret
mode, as tests/test_int8_pallas.py runs it) and through the port's plain
version (what a CPU tensor runs). Float outputs agree at rtol 1e-6 / atol
1e-5, the reference's own tolerance between its fused kernel and the
unfused expression (the two-layer chain: 1e-5 / 1e-4); int8 outputs are
equal. The CUDA kernel itself is held against this plain version on the
card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import int8_matmul as jim
from paddle_tpu_torch.ops import int8_matmul as tim

TOL = dict(rtol=1e-6, atol=1e-5)


def _quantize_weights(w, wmax=127.0):
    ws = np.max(np.abs(w), axis=0)
    q = np.clip(np.round(w / np.maximum(ws, 1e-8) * wmax),
                -wmax, wmax).astype(np.int8)
    return q, ws.astype(np.float32)


def _setup(m=96, k=200, n=72, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, k) * 0.5).astype(np.float32)
    wq, ws = _quantize_weights(rng.randn(k, n).astype(np.float32))
    b = rng.randn(n).astype(np.float32)
    sa = np.float32(np.abs(x).max())
    return x, wq, ws, b, sa


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _ref(x, wq, ws, sa, b=None, **kw):
    if "next_act_scale" in kw:
        kw["next_act_scale"] = jnp.asarray(kw["next_act_scale"])
    out = jim.int8_linear_fused(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws), jnp.asarray(sa),
        None if b is None else jnp.asarray(b), **kw)
    return np.asarray(out.astype(jnp.float32)) if out.dtype != jnp.int8 \
        else np.asarray(out)


def _port(x, wq, ws, sa, b=None, **kw):
    if "next_act_scale" in kw:
        kw["next_act_scale"] = _t(kw["next_act_scale"])
    with torch.inference_mode():
        out = tim.int8_linear_fused(
            x if isinstance(x, torch.Tensor) else _t(x), _t(wq), _t(ws),
            _t(sa), None if b is None else _t(b), **kw)
    return out


@pytest.mark.parametrize("shape,seed", [((96, 200, 72), 0),
                                        ((67, 130, 45), 1)],
                         ids=["basic", "unaligned_67x130x45"])
def test_fused_linear_matches_reference(shape, seed):
    x, wq, ws, b, sa = _setup(*shape, seed=seed)
    got = _port(x, wq, ws, sa, b)
    assert got.dtype == torch.float32 and got.shape == (shape[0], shape[2])
    np.testing.assert_allclose(got.numpy(), _ref(x, wq, ws, sa, b), **TOL)


def test_no_bias_and_3d_input():
    rng = np.random.RandomState(2)
    x3 = (rng.randn(4, 24, 100) * 0.3).astype(np.float32)
    wq, ws = _quantize_weights(rng.randn(100, 56).astype(np.float32))
    sa = np.float32(0.9)
    got = _port(x3, wq, ws, sa)
    assert got.shape == (4, 24, 56)
    np.testing.assert_allclose(got.numpy(), _ref(x3, wq, ws, sa), **TOL)


def test_prequantized_int8_input():
    """int8 x skips the quantize but still dequantizes with the caller's
    activation scale."""
    rng = np.random.RandomState(4)
    xq = rng.randint(-127, 128, (32, 80)).astype(np.int8)
    wq, ws = _quantize_weights(rng.randn(80, 40).astype(np.float32))
    sa = np.float32(2.5)
    np.testing.assert_allclose(_port(xq, wq, ws, sa).numpy(),
                               _ref(xq, wq, ws, sa), **TOL)


def test_bf16_input_and_bf16_output():
    x, wq, ws, b, sa = _setup(seed=5)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = _ref(xb, wq, ws, sa, b)
    xt = _t(x).bfloat16()
    np.testing.assert_allclose(_port(xt, wq, ws, sa, b).numpy(), ref, **TOL)
    # a bf16 output is the f32 result rounded once
    ref16 = _ref(xb, wq, ws, sa, b, out_dtype=jnp.bfloat16)
    got16 = _port(xt, wq, ws, sa, b, out_dtype=torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    # one bf16 ulp where the two f32 results straddle a rounding boundary
    np.testing.assert_allclose(got16.float().numpy(), ref16, rtol=2 ** -7,
                               atol=1e-5)


def test_two_layer_chain_with_relu_and_requantize():
    """fc1 (+ReLU, requantized to int8 at fc2's activation scale) -> fc2:
    the int8 intermediate is equal on both sides, the chain's output
    agrees at the chain tolerance."""
    rng = np.random.RandomState(3)
    m, d, h = 48, 64, 160
    x = (rng.randn(m, d) * 0.5).astype(np.float32)
    w1q, w1s = _quantize_weights(rng.randn(d, h).astype(np.float32))
    w2q, w2s = _quantize_weights(rng.randn(h, d).astype(np.float32))
    b1 = rng.randn(h).astype(np.float32)
    b2 = rng.randn(d).astype(np.float32)
    sa1, sa2 = np.float32(1.7), np.float32(41.5)
    ref1 = _ref(x, w1q, w1s, sa1, b1, relu=True, next_act_scale=sa2)
    got1 = _port(x, w1q, w1s, sa1, b1, relu=True, next_act_scale=sa2)
    assert got1.dtype == torch.int8 and ref1.dtype == np.int8
    assert int(got1.max()) > 20 and int(got1.min()) == 0   # ReLU, in range
    np.testing.assert_array_equal(got1.numpy(), ref1)
    ref2 = _ref(ref1, w2q, w2s, sa2, b2)
    got2 = _port(got1, w2q, w2s, sa2, b2)
    np.testing.assert_allclose(got2.numpy(), ref2, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("flags", [
    dict(), dict(relu=True), dict(quant_out=True),
    dict(relu=True, quant_out=True), dict(out_dtype="bfloat16"),
    dict(no_bias=True), dict(int8_x=True, relu=True)],
    ids=lambda f: "-".join(f) or "plain")
def test_int8_matmul_every_flag_matches_reference(flags):
    """``int8_matmul`` itself, flag by flag, at a ragged shape."""
    flags = dict(flags)
    rng = np.random.RandomState(6)
    m, k, n = 37, 70, 29
    if flags.pop("int8_x", False):
        x = rng.randint(-127, 128, (m, k)).astype(np.int8)
    else:
        x = (rng.randn(m, k) * 0.7).astype(np.float32)
    wq = rng.randint(-127, 128, (k, n)).astype(np.int8)
    scale = (rng.rand(n) * 2e-3 + 1e-4).astype(np.float32)
    bias = None if flags.pop("no_bias", False) else \
        rng.randn(n).astype(np.float32)
    qs = np.float32(127.0 / 2.1)
    odt = flags.pop("out_dtype", "float32")
    ref = jim.int8_matmul(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale),
        None if bias is None else jnp.asarray(bias), jnp.asarray(qs),
        out_dtype=getattr(jnp, odt), **flags)
    with torch.inference_mode():
        got = tim.int8_matmul(
            _t(x), _t(wq), _t(scale), None if bias is None else _t(bias),
            _t(qs).reshape(1), out_dtype=getattr(torch, odt), **flags)
    if flags.get("quant_out"):
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    else:
        assert got.dtype == getattr(torch, odt)
        tol = dict(rtol=2 ** -7, atol=1e-5) if odt == "bfloat16" else TOL
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(ref.astype(jnp.float32)), **tol)


def test_exact_accumulation_past_f32_integers():
    """K long enough that |acc| passes 2**24, where one f32 product would
    round: the plain version's product (f32 over K chunks of 1024, summed
    in int32) stays exact."""
    rng = np.random.RandomState(8)
    xq = torch.from_numpy(np.full((3, 5000), 127, np.int8))
    wq = torch.from_numpy(rng.choice([126, 127], (5000, 4)).astype(np.int8))
    want = xq.long() @ wq.long()
    assert int(want.max()) > 2 ** 24
    assert not torch.equal((xq.float() @ wq.float()).long(), want)
    got = tim._exact_int_matmul(xq, wq)
    assert got.dtype == torch.int32
    torch.testing.assert_close(got.long(), want, rtol=0, atol=0)
    assert 127 * 127 * tim._EXACT_K < 2 ** 24


def test_wrapper_checks_and_cpu_counts_no_launch():
    x, wq, ws, b, sa = _setup(8, 12, 6, seed=7)
    before = tim.INT8_MATMUL_LAUNCHES
    _port(x, wq, ws, sa, b)
    assert tim.INT8_MATMUL_LAUNCHES == before
    scale = torch.ones(6)
    with pytest.raises(ValueError, match="qscale"):
        tim.int8_matmul(_t(x), _t(wq), scale)
    with pytest.raises(TypeError, match="int8"):
        tim.int8_matmul(_t(x), _t(wq).float(), scale, qscale=torch.ones(1))
    with pytest.raises(ValueError, match=r"\[M, K\]"):
        tim.int8_matmul(_t(x)[:, :5], _t(wq), scale, qscale=torch.ones(1))
    with pytest.raises(TypeError, match="scale"):
        tim.int8_matmul(_t(x), _t(wq), torch.ones(5), qscale=torch.ones(1))
    with pytest.raises(TypeError, match="out_dtype"):
        tim.int8_matmul(_t(x), _t(wq), scale, qscale=torch.ones(1),
                        out_dtype=torch.float16)
