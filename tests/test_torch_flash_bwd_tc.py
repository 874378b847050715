"""The bf16 backward of paddle_tpu_torch's flash attention, held against
the JAX package on the CPU.

On the card the tensor-core backward kernels (merged single tile, dQ,
dK/dV) round P and dS to bf16 as the reference does, and chip_smoke.py
holds them to the port's bf16 plain versions on the same bf16 inputs. So
those plain versions are the oracle, and here they are held to the
reference: ``tfa._bwd`` on CPU bf16 tensors against the reference's
``_bwd`` (its Pallas kernels in interpret mode) on the same bf16 q, k, v,
dO and the reference forward's own o and LSE. Cases: the single tile
(S 256, causal and full, and cross attention 128 x 640) and the dQ +
dK/dV pair (S 1280 in 5 x 5 tiles of 256, causal), D 64. Both sides
round P and dS to bf16 and accumulate in f32, in different orders, then
round the gradients to bf16: held at atol = rtol = 2e-2 (one bf16 ulp at
|g| <~ 2, plus the few P/dS elements that round the other way).

Also: each backward entry picks its wgmma or mma.sync wrapper by
``_tc_route`` (checked on "meta" tensors, which reach the selection
without a card), and every kernel wrapper refuses a CPU tensor before it
builds anything.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa

BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _spy(monkeypatch, module, names, calls):
    for n in names:
        fn = getattr(module, n)

        def wrapped(*a, _fn=fn, _n=n, **kw):
            calls.append(_n)
            return _fn(*a, **kw)

        monkeypatch.setattr(module, n, wrapped)


CASES = [
    # (b, sq, sk, h, d, causal, route)
    (1, 256, 256, 2, 64, True, "single"),
    (1, 256, 256, 2, 64, False, "single"),
    (1, 128, 640, 2, 64, False, "single"),        # cross: 128 x 640
    (1, 1280, 1280, 1, 64, True, "pair"),         # 5 x 5 tiles of 256
]


@pytest.mark.parametrize("b,sq,sk,h,d,causal,route", CASES)
def test_bf16_plain_bwd_matches_reference(monkeypatch, b, sq, sk, h, d,
                                          causal, route):
    r = np.random.RandomState(sq + sk + int(causal))
    tq, tdo = (torch.from_numpy(r.randn(b, sq, h, d).astype(np.float32))
               .bfloat16() for _ in range(2))
    tk, tv = (torch.from_numpy(r.randn(b, sk, h, d).astype(np.float32))
              .bfloat16() for _ in range(2))
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                       for t in (tq, tk, tv, tdo))
    jcalls, tcalls = [], []
    _spy(monkeypatch, jfa, ["_bwd_single_tile"], jcalls)
    _spy(monkeypatch, tfa, ["_bwd_single_tile", "_bwd_dq", "_bwd_dkv"],
         tcalls)

    _, res = jfa._flash_fwd_res(jq, jk, jv, causal, None)
    q3, k3, v3, o3, lse, _, _, s_val, jbq, jbk = res
    assert o3.dtype == jnp.bfloat16
    ref = jfa._bwd(s_val, causal, jbq, jbk, (q3, k3, v3, o3, lse),
                   jfa._reshape_in(jdo))
    ref = [np.asarray(jfa._reshape_out(g, b, h).astype(jnp.float32))
           for g in ref]

    # the same o and LSE on the port's side
    o = torch.from_numpy(np.array(
        jfa._reshape_out(o3, b, h).astype(jnp.float32))).bfloat16()
    tlse = torch.from_numpy(np.array(lse))
    bq, bk = tfa._blocks(sq, sk, causal)
    assert (bq, bk) == (jbq, jbk)
    got = tfa._bwd(s_val, causal, bq, bk, (tq, tk, tv, o, tlse), tdo)

    ref_route = "single" if jcalls else "pair"
    port_route = "single" if tcalls == ["_bwd_single_tile"] else (
        "pair" if tcalls == ["_bwd_dq", "_bwd_dkv"] else tcalls)
    assert ref_route == port_route == route
    for g, x, name in zip(got, ref, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16 and g.shape == x.shape, name
        assert np.isfinite(x).all() and np.abs(x).max() > 0.1, name
        np.testing.assert_allclose(g.float().numpy(), x, err_msg=name,
                                   **BF16_TOL)


_ROUTED = ("_bwd_single_tile", "_bwd_dq", "_bwd_dkv")


@pytest.mark.parametrize("dtype,d,tc", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
    (torch.bfloat16, 96, False), (torch.bfloat16, 32, False),
    (torch.float32, 64, False), (torch.float32, 128, False)])
def test_backward_entries_pick_the_route_of_tc_route(monkeypatch, dtype, d,
                                                     tc):
    calls = []
    for base in _ROUTED:
        for route in ("tc", "mma"):
            name = f"{base}_{route}"
            monkeypatch.setattr(
                tfa, name, lambda *a, _n=name, **kw: calls.append(_n))
    q = torch.empty(1, 128, 2, d, dtype=dtype, device="meta")
    lse = torch.empty(2, 128, 1, device="meta")
    res = (q, q, q, lse)
    tfa._bwd_single_tile(0.125, True, res, q, lse, (dtype,) * 3)
    tfa._bwd_dq(0.125, True, res, q, lse, dtype)
    tfa._bwd_dkv(0.125, True, res, q, lse, (dtype,) * 2)
    want = "tc" if tc else "mma"
    assert calls == [f"{base}_{want}" for base in _ROUTED]


@pytest.mark.parametrize("name", [f"{base}_{route}" for base in _ROUTED
                                  for route in ("tc", "mma")])
def test_kernel_wrappers_refuse_cpu_tensors(name):
    q = torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16)
    lse = torch.zeros(2, 128, 1)
    dtypes = torch.bfloat16 if name.startswith("_bwd_dq") else \
        (torch.bfloat16,) * 3
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(tfa, name)(0.125, True, (q, q, q, lse), q, lse, dtypes)
