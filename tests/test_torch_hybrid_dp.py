"""The port's ``GPTHybridTrainer`` at ``{"dp": 2}`` (2 gloo ranks, CPU)
held against the JAX package's ``GPTHybridTrainer`` at the same mesh
shape on 2 of the 8 virtual CPU devices, ZeRO stage for stage (built as
``tests/test_zero_shard.py`` builds them). gpt_tiny from the reference's
weights (``shard_reference_state``; results back through
``gather_reference_state``), AdamW(1e-3, weight_decay 0.01) with
``ClipGradByGlobalNorm(1.0)``, 3 steps on global [4, 32] batches, each
rank taking its dp slice.

Cases: ZeRO 0 (one bucket all-reduce), 1 and 2 (the flat slab of
``qcomm.dp_zero_step``), 3 (the per-parameter route, parameters stored
on their dp slices), 2 with ``param_dtype="bfloat16"`` (the
per-parameter route, as the reference selects it) and ZeRO 2 on a
global batch of 3, which does not divide dp: ``dp_batch_specs`` keeps it
whole on both ranks, so each rank's loss is the global batch's and its
weight takes no factor of dp. The reference's ``HybridPipelineTrainer``
refuses that batch (it stages every batch dp-sharded), so the oracle
there is the JAX trainer at ``{"dp": 1}`` on the same global batch,
which every dp degree must equal.

The clip (1.0) acts on these batches, and a clip that acts hides a
gradient's size from the update (a gradient twice too large is clipped
to the same step). So ZeRO 0, 2 and 3 also run without the clip: there
the first moments after 3 steps (atol 1e-6) show the dp mean of every
gradient.

- f32 losses at rtol 1e-5; parameters after 3 steps at atol 1e-5 where
  the step-0 gradient is clear of zero (the reference's own
  sharded-vs-replicated bound, ``tests/test_zero_shard.py:215-217``);
  the first moments at atol 1e-6.
- bf16 storage: losses at atol 5e-4 and parameters within one bf16 ulp
  on at least 85% of the elements (the bounds of
  ``tests/test_torch_training.py``'s bf16 case).
- The ZeRO routes: ``memory_ledger()["opt_state"]`` per rank <= 1/2 + 5%
  of ZeRO 0's; ``master`` only with ``dp_param_comm="bf16"``; the counted
  collectives show f32 reduce-scatter and all-gather and no gradient
  all-reduce (at most two: the loss, and the clip's squared norms, a
  scalar on the slab and one f32 a parameter on the per-parameter
  route); the step site counts one signature over 3 steps.
"""
import importlib.util
import os

import numpy as np
import pytest

_spec = importlib.util.spec_from_file_location(
    "torch_hybrid_oracle", os.path.join(os.path.dirname(__file__), "data",
                                        "torch_hybrid_oracle.py"))
oracle = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(oracle)

DP = {"dp": 2}
CASES = [dict(name="z0", mesh=DP, zero=0),
         dict(name="z1", mesh=DP, zero=1),
         dict(name="z2", mesh=DP, zero=2),
         dict(name="z2_bf16comm", mesh=DP, zero=2, dp_param_comm="bf16"),
         dict(name="z3", mesh=DP, zero=3),
         dict(name="z2_bf16", mesh=DP, zero=2, param_dtype="bfloat16"),
         dict(name="z2_b3", mesh=DP, zero=2, batch=3)] + \
    [dict(name=f"z{z}_noclip", mesh=DP, zero=z, clip=None) for z in (0, 2, 3)]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    _, state = oracle.ref_state()
    import json
    res = oracle.run_job(tmp_path_factory.mktemp("hybrid_dp"), "hybrid", 2,
                         oracle.inputs(state, cases=json.dumps(CASES)))
    oracle.foreign_free(res)
    return res


@pytest.fixture(scope="module")
def g0():
    _, state = oracle.ref_state()
    return oracle.ref_grads(state, oracle.tokens()[0])[1]


@pytest.mark.parametrize("zero", [0, 1, 2, 3])
def test_dp2_zero_matches_reference(port, g0, zero):
    name = f"z{zero}"
    state0, losses, final, m1 = oracle.jax_train(DP, zero=zero)
    arrays, values = port[0]
    assert values[f"{name}.zero_manual"] == (zero in (1, 2))
    for _, v in port:
        np.testing.assert_allclose(v[f"{name}.losses"], losses,
                                   rtol=oracle.LOSS_RTOL)
    oracle.assert_params(arrays, final, state0, g0,
                         prefix=f"{name}.param.")
    for n, m in m1.items():
        np.testing.assert_allclose(arrays[f"{name}.moment1.{n}"], m,
                                   rtol=0, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("name", ["z1", "z2", "z2_bf16comm", "z3",
                                  "z2_bf16"])
def test_dp2_zero_ledger_and_collectives(port, name):
    for _, v in port:
        base = v["z0.ledger"]
        led = v[f"{name}.ledger"]
        assert led["opt_state"] <= (0.5 + 0.05) * base["opt_state"], \
            (led, base)
        assert ("master" in led) == (name == "z2_bf16comm"), led
        assert v[f"{name}.traces"] == 1
        st = v[f"{name}.stats"]
        kd = st["bytes_by_kind_dtype"]
        # the parameters travel at their storage dtype, or the bf16
        # payload of dp_param_comm
        gather_dt = "bf16" if name in ("z2_bf16comm", "z2_bf16") else "f32"
        assert kd["reduce_scatter"]["f32"] > 0 and \
            kd["all_gather"].get(gather_dt, 0) > 0, kd
        # no gradient is all-reduced: at most the loss and the clip's
        # squared norms (one f32 a parameter: 52 here)
        assert st["ops"].get("all_reduce", 0) <= 2, st["ops"]
        assert st["bytes"].get("all_reduce", 0) <= 4 * (52 + 1), st
        if name == "z3":
            assert led["param"] <= 0.55 * base["param"], (led, base)


def test_dp2_zero0_reduces_every_gradient_once(port):
    numel = port[0][1]["z0.numel"]
    for _, v in port:
        st = v["z0.stats"]
        assert st["ops"] == {"all_reduce": 2}, st["ops"]
        assert st["bytes"]["all_reduce"] == 4 * numel + 4, st


def test_dp2_bf16_storage_matches_reference(port):
    """param_dtype bf16 at ZeRO 2: the per-parameter route in both
    packages (the flat slab takes f32 storage only). With bf16 parameters
    the forward computes in bf16 in both packages, which round their
    products in different orders: losses at rtol 2e-3, half of bf16's
    2^-8 (measured 2.6e-4, 3e-4 of it at step 0, before any update)."""
    state0, losses, final, _ = oracle.jax_train(DP, zero=2,
                                                param_dtype="bfloat16")
    arrays, values = port[0]
    assert not values["z2_bf16.zero_manual"]
    np.testing.assert_allclose(values["z2_bf16.losses"], losses, rtol=2e-3)
    ulp = 2.0 ** -7
    within = np.concatenate([
        (np.abs(arrays[f"z2_bf16.param.{n}"] - w)
         <= ulp * np.abs(w) + 1e-6).ravel() for n, w in final.items()])
    assert within.mean() >= 0.85, within.mean()


def test_dp2_bf16_param_comm_keeps_an_f32_master(port, g0):
    """dp_param_comm="bf16" on the slab route: the all-gather carries
    bf16, the update reads the f32 master chunk; the parameters are the
    reference's within one bf16 ulp."""
    state0, losses, final, _ = oracle.jax_train(DP, zero=2,
                                                dp_param_comm="bf16")
    arrays, values = port[0]
    np.testing.assert_allclose(values["z2_bf16comm.losses"], losses,
                               rtol=1e-4)
    ulp = 2.0 ** -7
    for n, w in final.items():
        clear = np.abs(g0[n]) > oracle.G_CLEAR
        a = arrays[f"z2_bf16comm.param.{n}"]
        assert (np.abs(a - w) <= ulp * np.abs(w) + 1e-6)[clear].mean() \
            >= 0.99, n


def test_dp2_indivisible_batch_matches_reference(port):
    _, state = oracle.ref_state()
    g0 = oracle.ref_grads(state, oracle.tokens()[0][:3])[1]
    state0, losses, final, m1 = oracle.jax_train({"dp": 1}, batch=3)
    for _, v in port:
        np.testing.assert_allclose(v["z2_b3.losses"], losses,
                                   rtol=oracle.LOSS_RTOL)
    arrays = port[0][0]
    oracle.assert_params(arrays, final, state0, g0, prefix="z2_b3.param.")
    for n, m in m1.items():
        np.testing.assert_allclose(arrays[f"z2_b3.moment1.{n}"], m,
                                   rtol=0, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("zero", [0, 2, 3])
def test_dp2_unclipped_moments_match_reference(port, g0, zero):
    name = f"z{zero}_noclip"
    state0, losses, final, m1 = oracle.jax_train(DP, zero=zero, clip=None)
    arrays = port[0][0]
    for _, v in port:
        np.testing.assert_allclose(v[f"{name}.losses"], losses,
                                   rtol=oracle.LOSS_RTOL)
    oracle.assert_params(arrays, final, state0, g0, prefix=f"{name}.param.")
    for n, m in m1.items():
        np.testing.assert_allclose(arrays[f"{name}.moment1.{n}"], m,
                                   rtol=0, atol=1e-6, err_msg=n)
