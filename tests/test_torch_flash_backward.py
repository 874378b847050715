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


# ---------------------------------------------------------------------------
# The numerics of the CUDA backward kernels (csrc/flash_attention_bwd.cu):
# every product of the backward formulas runs on the tensor cores as
# 3xTF32. Emulated here on the CPU and held to an f64 computation of the
# same formulas at BWD_F32_TOL, the tolerance chip_smoke.py holds the
# kernels to against the plain f32 version: first the product split alone
# (every element; each split product summed by an f32 matmul), then the
# split with the kernels' truncating accumulation (sampled rows).
# ---------------------------------------------------------------------------

BWD_F32_TOL = 3e-5  # chip_smoke.py: the reference's own gradient tolerance


def _tf32(x):
    """The kernels' hi half: f32 bits rounded to TF32 (10 explicit
    mantissa bits), to nearest with ties away from zero on the magnitude
    (half a TF32 ulp added, the 13 low bits cleared: cvt.rna's rounding)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    """What the tensor core reads of an f32 value given as a tf32
    operand: its top 19 bits (the kernels' lo half, truncated)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, products):
    """a @ b in f32 as the kernels' mma.sync does it: with 3 products each
    operand is split into hi = _tf32(x) and lo = x - hi, which the tensor
    core truncates to TF32, and the sum is lo·hi + hi·lo + hi·hi (each
    TF32 product exact in f32); with 1 product, hi·hi alone."""
    ah, bh = _tf32(a), _tf32(b)
    if products == 1:
        return ah @ bh
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _emulated_bwd(q, k, v, do, lse, delta, causal, scale, products):
    """The kernels' function ([H, S, D] f32 inputs, lse and delta f32
    [H, Sq, 1]): P = exp2(s·scale·log2e − lse·log2e), dS = P ∘ (dO·Vᵀ −
    δ)·scale, dQ = dS·K, dK = dSᵀ·Q, dV = Pᵀ·dO, each product emulated."""
    log2e = np.float32(1.4426950408889634)
    s = _mm_tf32(q, k.transpose(1, 2), products)
    dp = _mm_tf32(do, v.transpose(1, 2), products)
    p = torch.exp2(s * np.float32(scale * log2e) - lse * log2e)
    if causal:
        sq, sk = s.shape[1:]
        p = torch.where(torch.ones(sq, sk, dtype=torch.bool).tril(), p, 0.0)
    ds = p * (dp - delta) * np.float32(scale)
    return (_mm_tf32(ds, k, products),
            _mm_tf32(ds.transpose(1, 2), q, products),
            _mm_tf32(p.transpose(1, 2), do, products))


def _f64_bwd(q, k, v, do, causal, scale):
    """The same formulas in f64 from the same values; lse and delta (the
    forward's, which the kernels receive in f32) returned alongside."""
    q, k, v, do = (x.double() for x in (q, k, v, do))
    s = q @ k.transpose(1, 2) * scale
    if causal:
        sq, sk = s.shape[1:]
        s = torch.where(torch.ones(sq, sk, dtype=torch.bool).tril(), s,
                        -torch.inf)
    lse = torch.logsumexp(s, -1, keepdim=True)
    p = torch.exp(s - lse)
    delta = ((p @ v) * do).sum(-1, keepdim=True)
    ds = p * (do @ v.transpose(1, 2) - delta) * scale
    return (ds @ k, ds.transpose(1, 2) @ q, p.transpose(1, 2) @ do), \
        lse.float(), delta.float()


NUMERICS_CASES = [
    # (name, sq, h, d, causal, dtype): the grad path's S 1024 causal f32,
    # a ragged length (the kernels mask S 1000 inside a tile), bf16 inputs
    ("f32_S1024_causal", 1024, 2, 128, True, torch.float32),
    ("f32_S1000_full", 1000, 2, 128, False, torch.float32),
    ("bf16_S1024_causal", 1024, 2, 128, True, torch.bfloat16),
]


def _numerics(sq, h, d, causal, dtype, products, seed):
    r = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(r.randn(h, sq, d).astype(np.float32))
                   .to(dtype).float() for _ in range(4))
    if dtype == torch.bfloat16:
        # bf16 values are exact in TF32: their lo half is 0, so S and dP
        # take one product and the gradients two (dS and P are f32)
        assert all(torch.equal(_tf32(x), x) for x in (q, k, v, do))
    scale = 1.0 / np.sqrt(d)
    ref, lse, delta = _f64_bwd(q, k, v, do, causal, scale)
    got = _emulated_bwd(q, k, v, do, lse, delta, causal, scale, products)
    return got, ref


@pytest.mark.parametrize("name,sq,h,d,causal,dtype", NUMERICS_CASES,
                         ids=[c[0] for c in NUMERICS_CASES])
def test_3xtf32_backward_stays_within_the_f32_tolerance(name, sq, h, d,
                                                        causal, dtype):
    """The product split alone, summed by f32 matmuls (the kernels'
    truncating accumulators are emulated further down). 3xTF32 drops
    lo·lo and the bits of lo below TF32: a few 2^-22 of
    |x·y| per product, against 2^-24 for one f32 rounding. Held to f64 at
    rtol = atol = BWD_F32_TOL, the tolerance of the kernels' chip check
    against the plain f32 version (which itself sits within about 1e-6 of
    f64 here), so the split leaves that check its margin."""
    got, ref = _numerics(sq, h, d, causal, dtype, 3, seed=sq + h + d)
    for g, r, what in zip(got, ref, ("dq", "dk", "dv")):
        assert torch.isfinite(g).all(), what
        np.testing.assert_allclose(g.double().numpy(), r.numpy(),
                                   rtol=BWD_F32_TOL, atol=BWD_F32_TOL,
                                   err_msg=f"{name} {what}")


@pytest.mark.parametrize("name,sq,h,d,causal,dtype", NUMERICS_CASES,
                         ids=[c[0] for c in NUMERICS_CASES])
def test_1xtf32_backward_leaves_the_f32_tolerance(name, sq, h, d, causal,
                                                  dtype):
    """The negative control: one TF32 product per f32 product (2^-11
    relative per operand, what allow_tf32 would give) does not stay within
    BWD_F32_TOL of f64, so the split is what holds the kernels there."""
    got, ref = _numerics(sq, h, d, causal, dtype, 1, seed=sq + h + d)
    worst = 0.0
    for g, r in zip(got, ref):
        excess = (g.double() - r).abs() - BWD_F32_TOL * (1 + r.abs())
        worst = max(worst, float(excess.max()))
    assert worst > 0.0, f"{name}: 1xTF32 stayed within the f32 tolerance"


# The kernels' accumulation. A tensor core adds each mma's products into
# its accumulator with truncation. Modelled as measured on earlier NVIDIA
# tensor cores (Fasi, Higham, Mikaitis and Pranesh, "Numerical behavior of
# NVIDIA tensor cores", PeerJ Comput. Sci. 2021): products exact, every
# addend aligned to the largest one's exponent and cut to 24 bits toward
# zero, the sum cut to 24 bits toward zero; no guard bits, the most lossy
# reading. The kernels' order: S and dP over the head dim in one
# accumulator (lo·hi, hi·lo, hi·hi each 8 columns); each tile of a
# gradient product from zero, small products (lo·hi, hi·lo) and big
# (hi·hi) apart, joined to the output by one f32 add; the merged kernel's
# dQ in one accumulator a key block (lo·hi, hi·lo, hi·hi), the blocks
# added in f32 (by atomics on the card; here in key order).


def _tc_step(c, a, b):
    """c + a @ b as one mma: c [.., R, N] f64 holding f32 values, a
    [.., R, K] and b [.., K, N] f64 holding TF32 (or bf16) values."""
    terms = a.unsqueeze(-1) * b.unsqueeze(-3)            # exact in f64
    top = torch.maximum(terms.abs().amax(-2), c.abs())
    grid = torch.ldexp(torch.ones_like(top), torch.frexp(top).exponent - 24)
    s = (torch.trunc(terms / grid.unsqueeze(-2)).sum(-2)
         + torch.trunc(c / grid)) * grid                 # exact in f64
    m, e = torch.frexp(s)
    return torch.ldexp(torch.trunc(m * 2.0 ** 24) / 2.0 ** 24, e)


def _halves(x, lo=True):
    hi = _tf32(x)
    return hi.double(), (_tf32_trunc(x - hi).double() if lo else None)


def _tc_scores(a, b, bf16):
    """a [H, R, D] (the warp's rows) times b [H, N, D] (streamed rows)
    transposed, over the head dim zero-filled to a multiple of 16, in one
    accumulator: the bf16 mma (16 columns) for bf16 values, else 3xTF32."""
    d = a.shape[-1]
    dp = -(-d // 16) * 16
    a, b = (torch.nn.functional.pad(x, (0, dp - d)) for x in (a, b))
    c = torch.zeros(a.shape[0], a.shape[1], b.shape[1], dtype=torch.float64)
    if bf16:
        for kk in range(0, dp, 16):
            c = _tc_step(c, a[..., kk:kk + 16].double(),
                         b[..., kk:kk + 16].double().transpose(1, 2))
        return c.float()
    (ah, al), (bh, bl) = _halves(a), _halves(b)
    for kk in range(0, dp, 8):
        bh_, bl_ = (x[..., kk:kk + 8].transpose(1, 2) for x in (bh, bl))
        c = _tc_step(c, al[..., kk:kk + 8], bh_)
        c = _tc_step(c, ah[..., kk:kk + 8], bl_)
        c = _tc_step(c, ah[..., kk:kk + 8], bh_)
    return c.float()


def _tc_grad(x, y, tile, blo, merged_dq=False):
    """x [H, R, N] f32 (P or dS, made in the kernel) times y [H, N, D]
    over N in tiles of ``tile`` rows, the kernels' way (see above); blo:
    y is f32 (split) rather than bf16."""
    h, r, n = x.shape
    npad = -(-n // tile) * tile
    x = torch.nn.functional.pad(x, (0, npad - n))
    y = torch.nn.functional.pad(y, (0, 0, 0, npad - n))
    nt = npad // tile
    (xh, xl), (yh, yl) = _halves(x), _halves(y, blo)
    xh, xl = (z.reshape(h, r, nt, tile).transpose(1, 2) for z in (xh, xl))
    yh = yh.reshape(h, nt, tile, -1)
    yl = yl.reshape(h, nt, tile, -1) if blo else None
    big = torch.zeros(h, nt, r, y.shape[-1], dtype=torch.float64)
    small = torch.zeros_like(big)
    for k0 in range(0, tile, 8):
        ks = slice(k0, k0 + 8)
        if merged_dq:
            big = _tc_step(big, xl[..., ks], yh[..., ks, :])
            if blo:
                big = _tc_step(big, xh[..., ks], yl[..., ks, :])
        elif blo:
            small = _tc_step(small, xl[..., ks], yh[..., ks, :])
            small = _tc_step(small, xh[..., ks], yl[..., ks, :])
        else:
            big = _tc_step(big, xl[..., ks], yh[..., ks, :])
        big = _tc_step(big, xh[..., ks], yh[..., ks, :])
    part = big.float() + small.float() if blo and not merged_dq \
        else big.float()
    acc = torch.zeros(h, r, y.shape[-1])
    for t in range(nt):
        acc = acc + part[:, t]
    return acc


def _tiles(d, bf16, merged):
    """(dQ key tile, dK/dV query tile) of the launchers in
    csrc/flash_attention_bwd.cu; the merged kernel's dQ key block is its
    16 NW keys."""
    if merged:
        return (128 if d <= 128 else 64), (32 if d <= 64 and not bf16
                                           else 16)
    return (32 if d <= 128 else 16), (16 if bf16 or d > 128 else 32)


def _tc_rows(q, k, v, do, lse, delta, causal, scale, qrows, krows, bf16,
             merged):
    """The kernels' dQ at rows qrows and dK, dV at rows krows ([H, S, D]
    f32 holding the input values; lse, delta [H, Sq] f32)."""
    log2e = np.float32(1.4426950408889634)
    sl2, sc = np.float32(np.float32(scale) * log2e), np.float32(scale)
    sq, sk = q.shape[1], k.shape[1]
    bk, bq = _tiles(q.shape[-1], bf16, merged)

    def p_ds(s, dp, rows):      # [H, keys, queries], queries at ``rows``
        keys = torch.arange(sk) if s.shape[1] == sk else torch.tensor(krows)
        live = keys[:, None] <= torch.tensor(rows)[None, :] if causal \
            else torch.ones(len(keys), len(rows), dtype=torch.bool)
        p = torch.where(live, torch.exp2(s * sl2 - lse[:, None, rows]
                                         * log2e), 0.0)
        return p, p * (dp - delta[:, None, rows]) * sc

    if merged:   # dS^T of the dK/dV body: keys as the warp's rows
        _, ds = p_ds(_tc_scores(k, q[:, qrows], bf16),
                     _tc_scores(v, do[:, qrows], bf16), qrows)
    else:
        _, ds = p_ds(_tc_scores(q[:, qrows], k, bf16).transpose(1, 2),
                     _tc_scores(do[:, qrows], v, bf16).transpose(1, 2),
                     qrows)
    dq = _tc_grad(ds.transpose(1, 2), k, bk, not bf16, merged_dq=merged)
    pt, dst = p_ds(_tc_scores(k[:, krows], q, bf16),
                   _tc_scores(v[:, krows], do, bf16), list(range(sq)))
    return (dq, _tc_grad(dst, q, bq, not bf16),
            _tc_grad(pt, do, bq, not bf16))


ACC_CASES = [
    # (name, s, h, d, causal, dtype, merged): the grad paths' S 1024 (the
    # merged kernel) and S 2048 (the pair) causal f32, a ragged S 1000, D
    # 256 on both (the smallest margin on the card), bf16 at D 96
    ("f32_S1024_causal_merged", 1024, 2, 128, True, torch.float32, True),
    ("f32_S1000_full_merged", 1000, 2, 128, False, torch.float32, True),
    ("f32_S1024_D256_causal_merged", 1024, 2, 256, True, torch.float32,
     True),
    ("f32_S2048_causal_pair", 2048, 2, 128, True, torch.float32, False),
    ("f32_S2048_D256_causal_pair", 2048, 2, 256, True, torch.float32, False),
    ("bf16_S2048_D96_causal_pair", 2048, 2, 96, True, torch.bfloat16, False),
]


@pytest.mark.parametrize("name,s,h,d,causal,dtype,merged", ACC_CASES,
                         ids=[c[0] for c in ACC_CASES])
def test_3xtf32_truncating_accumulation_stays_within_the_f32_tolerance(
        name, s, h, d, causal, dtype, merged):
    """The split and the accumulation as the kernels do them, under the
    truncation model above, at the rows that sum the most terms: dQ of the
    last 16 queries (in the ragged last tile at S 1000), dK and dV of the
    first 16 keys. Held to f64 at rtol = atol = BWD_F32_TOL, as the
    product-split test above. What the card's tensor cores really drop is
    not known here: chip_smoke.py holds the kernels themselves."""
    r = np.random.RandomState(s + d)
    q, k, v, do = (torch.from_numpy(r.randn(h, s, d).astype(np.float32))
                   .to(dtype).float() for _ in range(4))
    scale = 1.0 / np.sqrt(d)
    qrows, krows = list(range(s - 16, s)), list(range(16))
    (rq, rk, rv), lse, delta = _f64_bwd(q, k, v, do, causal, scale)
    got = _tc_rows(q, k, v, do, lse[..., 0], delta[..., 0], causal, scale,
                   qrows, krows, dtype == torch.bfloat16, merged)
    for g, ref, what in zip(got, (rq[:, qrows], rk[:, krows], rv[:, krows]),
                            ("dq", "dk", "dv")):
        assert torch.isfinite(g).all(), what
        np.testing.assert_allclose(g.double().numpy(), ref.numpy(),
                                   rtol=BWD_F32_TOL, atol=BWD_F32_TOL,
                                   err_msg=f"{name} {what}")


def test_tc_step_truncates_toward_zero():
    """The model itself: an addend below the largest one's last bit is cut
    away, whatever its sign, and the sum is cut (not rounded) to 24 bits."""
    one = torch.ones(1, 1, dtype=torch.float64)
    u = 2.0 ** -23      # the f32 ulp at 1
    for tiny in (0.75 * u, -0.75 * u):
        x = torch.full((1, 1), tiny, dtype=torch.float64)
        assert float(_tc_step(one, x, one)) == 1.0
    # (1 + u) + (1 + 2u) = 2 + 1.5 ulp(2): cut to 2 + ulp(2), where
    # rounding would give 2 + 2 ulp(2)
    a = torch.tensor([[1.0 + u, 1.0 + 2 * u]], dtype=torch.float64)
    got = _tc_step(torch.zeros(1, 1, dtype=torch.float64), a,
                   torch.ones(2, 1, dtype=torch.float64))
    assert float(got) == 2.0 + 2 * u
