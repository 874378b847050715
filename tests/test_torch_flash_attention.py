"""paddle_tpu_torch.ops.flash_attention held against the JAX package.

The port's plain version (what a CPU tensor runs) against the reference's
Pallas flash forward in interpret mode and against its ``mha_reference``,
at S = 128 and D = 32, causal and not: the output at atol = rtol = 2e-5
(f32, online softmax reassociates the sum) and the natural-log LSE at
the same tolerance. The CUDA kernel is held against this plain version on
the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.nn import functional as TFn
from paddle_tpu_torch.ops import flash_attention as tfa

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, b=2, s=128, h=2, d=32, sk=None):
    r = np.random.RandomState(seed)
    q = r.randn(b, s, h, d).astype(np.float32)
    k = r.randn(b, sk or s, h, d).astype(np.float32)
    v = r.randn(b, sk or s, h, d).astype(np.float32)
    return q, k, v


def _port(q, k, v, causal):
    with torch.inference_mode():
        o, lse = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal)
    return o.numpy(), lse.numpy()


@pytest.mark.parametrize("causal", [False, True])
def test_output_and_lse_match_pallas_interpret(causal):
    q, k, v = _qkv(0)
    o_ref, res = jfa._flash_fwd_res(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal, None)
    lse_ref = np.asarray(res[4])
    o, lse = _port(q, k, v, causal)
    assert lse.shape == lse_ref.shape == (2 * 2, 128, 1)
    np.testing.assert_allclose(o, np.asarray(o_ref), **TOL)
    np.testing.assert_allclose(lse, lse_ref, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_output_matches_mha_reference(causal):
    q, k, v = _qkv(1)
    ref = jfa.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal)
    o, _ = _port(q, k, v, causal)
    np.testing.assert_allclose(o, np.asarray(ref), **TOL)
    with torch.inference_mode():
        plain = tfa.mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal)
    np.testing.assert_allclose(plain.numpy(), o, rtol=0, atol=0)


@pytest.mark.parametrize("s,causal", [(128, True), (128, False),
                                      (200, True), (40, True), (40, False)])
def test_sdpa_dispatch_matches_reference(s, causal):
    """Lengths the reference's block picker accepts (128..1024 of any
    length) take the flash entry, shorter ones the plain masked path —
    in both packages."""
    q, k, v = _qkv(2, s=s)
    assert tfa.supported(q.shape, None, 0.0, kv_seq=s) == \
        jfa.supported(q.shape, None, 0.0, kv_seq=s) == (s >= 128)
    ref = JF.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=causal)
    ref = np.asarray(getattr(ref, "_value", ref))
    with torch.inference_mode():
        got = TFn.scaled_dot_product_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            is_causal=causal)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_grad_enabled_inputs_raise_not_implemented():
    """A grad-requiring call on CPU tensors returns gradients and counts
    no launch. (The name dates from the forward-only port, where such a
    call raised NotImplementedError.)"""
    counters = ("FLASH_FWD_LAUNCHES", "FLASH_BWD_SINGLE_LAUNCHES",
                "FLASH_BWD_DQ_LAUNCHES", "FLASH_BWD_DKV_LAUNCHES")
    before = [getattr(tfa, c) for c in counters]
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(3))
    o, lse = tfa.flash_attention(q, k, v, causal=True)
    o.sum().backward()
    for t in (q, k, v):
        assert t.grad is not None and t.grad.shape == t.shape
        assert bool(torch.isfinite(t.grad).all())
    assert [getattr(tfa, c) for c in counters] == before


def test_bad_shapes_raise():
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, s=128, sk=256))
    with pytest.raises(ValueError, match="seq_q == seq_kv"):
        tfa.flash_attention(q, k, v, causal=True)
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, s=96))
    with pytest.raises(ValueError, match="128-aligned"):
        tfa.flash_attention(q, k, v)


def test_cpu_tensors_take_plain_version_without_counting_a_launch():
    before = tfa.FLASH_FWD_LAUNCHES
    _port(*_qkv(5), causal=True)
    assert tfa.FLASH_FWD_LAUNCHES == before
