"""The port's ring attention (``ops/ring_attention.py``) on 2 and 4 gloo
ranks (CPU), and the hybrid trainer at ``{"sp": 2}``.

- Every rank holds its sequence shard of the global q, k, v (the
  reference test's shapes, ``tests/test_ring_attention.py:35-90``: sp 4
  at S 32, D 8 and sp 2 at S 256, D 32), causal and not. The shards of
  the output and of the gradients of ``sum(sin(o))`` put together equal
  full attention (the port's plain ``mha_reference`` under autograd) and
  the JAX ``sequence_parallel_attention`` on the same inputs: the
  forward at atol/rtol 2e-5, the gradients at 3e-5, the reference
  test's tolerances. The CPU chunks run the plain versions; the chip
  check holds the kernels (``chip_smoke.py``'s ``parallel`` phase).
- The counted permutes: ``2·(sp − 1)`` forward (K and V), ``4·(sp − 1)
  + 2`` backward (K, V, dK and dV, and the last hop of dK and dV home).
- ``GPTHybridTrainer`` at ``{"dp": 1, "sp": 2}`` against the JAX
  trainer at the same mesh: losses at rtol 1e-5 and gathered parameters
  at atol 1e-5 where the step-0 gradient is clear, 3 AdamW steps with
  ``ClipGradByGlobalNorm(1.0)``; every gradient summed over sp (each
  rank's loss is its shard's share of the global mean).
"""
import importlib.util
import json
import os
import zlib

import numpy as np
import pytest

_spec = importlib.util.spec_from_file_location(
    "torch_hybrid_oracle", os.path.join(os.path.dirname(__file__), "data",
                                        "torch_hybrid_oracle.py"))
oracle = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(oracle)

#: (name, sp, S, D, causal): the reference test's shapes
RING = [(f"sp{sp}_s{s}_{'causal' if c else 'full'}", sp, s, d, c)
        for sp, s, d in ((4, 32, 8), (2, 256, 32)) for c in (False, True)]


def _qkv(name, b, s, d):
    r = np.random.RandomState(zlib.crc32(name.encode()))
    return [r.randn(b, s, 2, d).astype(np.float32) for _ in range(3)]


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    out = {}
    for sp in (2, 4):
        cases = [dict(name=n, causal=c) for n, p, s, d, c in RING
                 if p == sp]
        inp = {"nranks": sp, "cases": json.dumps(cases)}
        for n, p, s, d, c in RING:
            if p == sp:
                for t, a in zip("qkv", _qkv(n, 1, s, d)):
                    inp[f"{n}.{t}"] = a
        res = oracle.run_job(tmp_path_factory.mktemp(f"ring{sp}"), "ring",
                             sp, inp)
        oracle.foreign_free(res)
        out[sp] = (inp, res)
    return out


def _full(q, k, v, causal):
    """Full attention and the gradients of sum(sin(o)) (plain PyTorch)."""
    import torch

    from paddle_tpu_torch.ops.flash_attention import mha_reference

    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = mha_reference(*ts, causal=causal)
    torch.sin(o).sum().backward()
    return o.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_ring(q, k, v, sp, causal):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops.ring_attention import sequence_parallel_attention

    mesh = oracle.jax_mesh({"sp": sp})

    def loss(a, b, c):
        return jnp.sum(jnp.sin(sequence_parallel_attention(
            a, b, c, mesh, causal=causal)))

    args = [jnp.asarray(a) for a in (q, k, v)]
    o = jax.jit(lambda a, b, c: sequence_parallel_attention(
        a, b, c, mesh, causal=causal))(*args)
    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
    return np.asarray(o), [np.asarray(x) for x in g]


def _gathered(res, name, key):
    return np.concatenate([arrays[f"{name}.{key}"] for arrays, _ in res],
                          axis=1)


@pytest.mark.parametrize("name,sp,s,d,causal", RING)
def test_ring_equals_full_attention(rings, name, sp, s, d, causal):
    inp, res = rings[sp]
    q, k, v = (inp[f"{name}.{t}"] for t in "qkv")
    o, grads = _full(q, k, v, causal)
    np.testing.assert_allclose(_gathered(res, name, "o"), o, atol=2e-5,
                               rtol=2e-5)
    for t, g in zip("qkv", grads):
        np.testing.assert_allclose(_gathered(res, name, f"d{t}"), g,
                                   atol=3e-5, rtol=3e-5, err_msg=t)


@pytest.mark.parametrize("name,sp,s,d,causal", RING)
def test_ring_equals_the_jax_ring(rings, name, sp, s, d, causal):
    inp, res = rings[sp]
    q, k, v = (inp[f"{name}.{t}"] for t in "qkv")
    o, grads = _jax_ring(q, k, v, sp, causal)
    np.testing.assert_allclose(_gathered(res, name, "o"), o, atol=2e-5,
                               rtol=2e-5)
    for t, g in zip("qkv", grads):
        np.testing.assert_allclose(_gathered(res, name, f"d{t}"), g,
                                   atol=3e-5, rtol=3e-5, err_msg=t)


@pytest.mark.parametrize("name,sp,s,d,causal", RING)
def test_ring_permutes(rings, name, sp, s, d, causal):
    _, res = rings[sp]
    for _, values in res:
        assert values[f"{name}.fwd_stats"]["ops"] == \
            {"collective_permute": 2 * (sp - 1)}
        assert values[f"{name}.bwd_stats"]["ops"] == \
            {"collective_permute": 4 * (sp - 1) + 2}


SP = {"dp": 1, "sp": 2}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    _, state = oracle.ref_state()
    case = dict(name="sp2", mesh=SP, grads=True)
    res = oracle.run_job(tmp_path_factory.mktemp("hybrid_sp"), "hybrid", 2,
                         oracle.inputs(state, cases=json.dumps([case])))
    oracle.foreign_free(res)
    return res


def test_sp2_trainer_matches_reference(port):
    state0, losses, final, _ = oracle.jax_train(SP)
    _, state = oracle.ref_state()
    _, g0 = oracle.ref_grads(state, oracle.tokens()[0])
    for arrays, values in port:
        np.testing.assert_allclose(values["sp2.losses"], losses,
                                   rtol=oracle.LOSS_RTOL)
        # step 0's gradients, summed over sp: the reference's
        for n, g in g0.items():
            np.testing.assert_allclose(arrays[f"sp2.grad.{n}"], g,
                                       rtol=1e-4, atol=2e-6, err_msg=n)
        # the clip's global norm counts a parameter replicated over sp once
        norm = np.sqrt(sum(float(np.square(g.astype(np.float64)).sum())
                           for g in g0.values()))
        np.testing.assert_allclose(values["sp2.grad_norm"], norm, rtol=1e-5)
    oracle.assert_params(port[0][0], final, state0, g0, prefix="sp2.param.")
