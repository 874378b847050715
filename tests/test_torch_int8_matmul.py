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


# ---------------------------------------------------------------------------
# the two CUDA routes and the wgmma route's quantize pass
# ---------------------------------------------------------------------------
def _meta(shape, dtype, offset=0):
    """A "meta" tensor (no data) whose data_ptr is `offset` bytes past an
    aligned base when dtype is int8."""
    n = int(np.prod(shape))
    base = torch.empty(n + offset, dtype=dtype, device="meta")
    return base[offset:].reshape(shape)


@pytest.mark.parametrize("k,xdt,x_off,kn_off,route", [
    (4096, torch.bfloat16, 0, None, "wgmma"),   # fc1: a float x, no copy
    (16384, torch.int8, 0, 0, "wgmma"),         # fc2: int8 x, a given copy
    (144, torch.float32, 0, 0, "wgmma"),
    (130, torch.float32, 0, None, "mma"),       # rows not 16-byte strided
    (136, torch.int8, 0, 0, "mma"),
    (4096, torch.int8, 3, 0, "mma"),            # int8 x off a 16-byte base
    (4096, torch.bfloat16, 0, 5, "mma"),        # the K-major copy off it
    (4096, torch.float32, 0, None, "wgmma")],
    ids=["fc1", "fc2", "k144", "k130", "k136", "x_unaligned",
         "copy_unaligned", "f32_no_copy"])
def test_mm_route_by_k_and_alignment(k, xdt, x_off, kn_off, route):
    """``_mm_route`` picks the wgmma route when TMA can read what the
    kernel reads: K a multiple of 16 and 16-byte aligned int8 operands (a
    float x is read through its own fresh quantized copy)."""
    x = _meta((64, k), xdt, x_off if xdt == torch.int8 else 0)
    wq_kn = None if kn_off is None else _meta((256, k), torch.int8, kn_off)
    assert tim._mm_route(x, wq_kn) == route


def test_cpu_takes_the_plain_version_on_either_route_counting_nothing():
    """CPU tensors of both routes' shapes run the plain version and count
    no launch on any of the three counters."""
    counters = ("INT8_MATMUL_LAUNCHES", "INT8_MATMUL_WGMMA_LAUNCHES",
                "INT8_QUANTIZE_LAUNCHES")
    before = [getattr(tim, c) for c in counters]
    rng = np.random.RandomState(9)
    for k in (144, 130):
        x = (rng.randn(20, k) * 0.5).astype(np.float32)
        wq, ws = _quantize_weights(rng.randn(k, 24).astype(np.float32))
        sa = np.float32(np.abs(x).max())
        route = tim._mm_route(_t(x), None)
        assert route == ("wgmma" if k == 144 else "mma")
        got = _port(x, wq, ws, sa, wq_kn=_t(np.ascontiguousarray(wq.T)))
        np.testing.assert_allclose(got.numpy(), _ref(x, wq, ws, sa), **TOL)
        xq = tim.quantize_x(_t(x), _t(np.float32(127.0 / sa)).reshape(1))
        assert xq.dtype == torch.int8
    assert [getattr(tim, c) for c in counters] == before


def _tie_x(rng, m, k, qs):
    """x whose products with qs hold exact .5 ties (odd multiples of
    0.5 / qs, exact in bf16) and values past +-127, beside normal ones."""
    ties = (rng.randint(-128, 128, (m, k)) * 2 + 1) * (0.5 / qs)
    big = rng.choice([-1.0, 1.0], (m, k)) * rng.uniform(128, 400, (m, k)) \
        / qs
    normal = rng.randn(m, k) * 30.0 / qs
    pick = rng.randint(0, 3, (m, k))
    return np.where(pick == 0, ties, np.where(pick == 1, big, normal)) \
        .astype(np.float32)


@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_quantize_pass_plain_version_is_bit_equal_to_reference(xdt):
    """The wgmma route's quantize pass (``quantize_x``, its plain version
    on the CPU) against the reference's quantizer: the JAX int8_matmul in
    interpret mode times the identity with scale 1 returns its int8 x as
    exact f32 values. Exact .5 ties round half to even on both sides."""
    rng = np.random.RandomState(10)
    m, k, qs = 24, 64, np.float32(2.0)
    x = _tie_x(rng, m, k, qs)
    xj = jnp.asarray(x).astype(getattr(jnp, xdt))
    xt = _t(x).to(getattr(torch, xdt))
    xs = xt.float().numpy() * qs
    assert (xs - np.floor(xs) == 0.5).sum() > m * k // 8   # ties kept
    assert (np.abs(xs) > 127.5).sum() > m * k // 8          # clipped
    eye = np.eye(k, dtype=np.int8)
    ref = np.asarray(jim.int8_matmul(
        xj, jnp.asarray(eye), jnp.ones((k,), jnp.float32), None,
        jnp.asarray(qs)))
    got = tim.quantize_x(xt, _t(qs).reshape(1))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy().astype(np.float32), ref)
    np.testing.assert_array_equal(
        got.numpy(), tim._plain_quantize_x(xt, _t(qs).reshape(1),
                                           127.0).numpy())


def test_wq_kn_is_checked_and_never_read_on_the_cpu():
    x, wq, ws, b, sa = _setup(8, 32, 6, seed=12)
    kn = np.ascontiguousarray(wq.T)
    with pytest.raises(ValueError, match="wq_kn"):
        _port(x, wq, ws, sa, b, wq_kn=_t(kn).T)        # [K, N], not [N, K]
    with pytest.raises(ValueError, match="wq_kn"):
        _port(x, wq, ws, sa, b, wq_kn=_t(kn).float())
    # the plain version reads wq: a copy that disagrees changes nothing
    np.testing.assert_array_equal(
        _port(x, wq, ws, sa, b, wq_kn=torch.zeros(6, 32, dtype=torch.int8))
        .numpy(), _port(x, wq, ws, sa, b).numpy())
