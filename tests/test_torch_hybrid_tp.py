"""The port's ``GPTHybridTrainer`` with GPT's heads split over ``tp``,
held against the JAX package's ``GPTHybridTrainer`` at the same mesh
shape on the virtual CPU devices: ``{"dp": 1, "tp": 2}`` on 2 gloo ranks
and ``{"dp": 2, "tp": 2}`` on 4. gpt_tiny from the reference's weights,
AdamW(1e-3, weight_decay 0.01) with ``ClipGradByGlobalNorm(1.0)`` (the
global norm sums each tp-sharded parameter's squared norm over ``tp``
and counts each replicated one once), 3 steps on global [4, 32] batches.

- tp 2, f32: losses at rtol 1e-5, parameters after 3 steps at atol 1e-5
  where the step-0 gradient is clear of zero, first moments at 1e-6.
- ``remat_policy="dots"`` (matrix products saved, the rest recomputed)
  gives the same losses and parameters as full recompute (bitwise on the
  CPU: recomputation is deterministic).
- The train phase's recipe at tp 2 (amp, recompute, bf16 parameters and
  moments), and dp 2 x tp 2 at ZeRO 2 with amp and recompute: the
  forward computes in bf16 in both packages, which round their products
  in different orders. Losses at rtol 2e-3, half of bf16's 2^-8;
  parameters within one bf16 ulp on at least 85% of the elements, the
  bound of ``tests/test_torch_training.py`` (the recipe at tp 2 measured
  1.2e-4 and 95.7%).
- The counted collectives of a tp step are all-reduces only: per layer
  two in the forward (the row layers), two in the backward (the column
  layers' input gradients) and, under recompute, the first row layer's
  again (torch's non-reentrant checkpoint stops recomputing once the
  saved tensors are back); the embedding's, the loss's three (row max,
  sum of exponentials, target logit; again in its checkpointed
  backward), the head input's gradient and the clip's squared norms.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

_spec = importlib.util.spec_from_file_location(
    "torch_hybrid_oracle", os.path.join(os.path.dirname(__file__), "data",
                                        "torch_hybrid_oracle.py"))
oracle = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(oracle)

TP = {"dp": 1, "tp": 2}
DPTP = {"dp": 2, "tp": 2}
RECIPE = dict(amp=True, recompute=True, param_dtype="bfloat16",
              moment_dtype="bfloat16")
CASES = [dict(name="tp2", mesh=TP),
         dict(name="tp2_remat", mesh=TP, recompute=True),
         dict(name="tp2_dots", mesh=TP, recompute=True, remat_policy="dots"),
         dict(name="tp2_recipe", mesh=TP, **RECIPE)]
LAYERS = oracle.CFG["num_layers"]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    _, state = oracle.ref_state()
    res = oracle.run_job(tmp_path_factory.mktemp("hybrid_tp"), "hybrid", 2,
                         oracle.inputs(state, cases=json.dumps(CASES)))
    oracle.foreign_free(res)
    return res


@pytest.fixture(scope="module")
def g0():
    _, state = oracle.ref_state()
    return oracle.ref_grads(state, oracle.tokens()[0])[1]


def _bf16_close(arrays, prefix, final, share=0.85):
    ulp = 2.0 ** -7
    within = np.concatenate([
        (np.abs(arrays[prefix + n] - w) <= ulp * np.abs(w) + 1e-6).ravel()
        for n, w in final.items()])
    assert within.mean() >= share, within.mean()


def test_tp2_f32_matches_reference(port, g0):
    state0, losses, final, m1 = oracle.jax_train(TP)
    for rank, (arrays, values) in enumerate(port):
        np.testing.assert_allclose(values["tp2.losses"], losses,
                                   rtol=oracle.LOSS_RTOL)
        oracle.assert_params(arrays if rank == 0 else port[0][0], final,
                             state0, g0, prefix="tp2.param.")
    arrays = port[0][0]
    for n, m in m1.items():
        np.testing.assert_allclose(arrays[f"tp2.moment1.{n}"], m, rtol=0,
                                   atol=1e-6, err_msg=n)


def test_tp2_remat_dots_equals_full_recompute(port):
    arrays, values = port[0]
    assert values["tp2_dots.losses"] == values["tp2_remat.losses"]
    for k in arrays:
        if k.startswith("tp2_remat.param."):
            np.testing.assert_allclose(
                arrays[k.replace("tp2_remat", "tp2_dots")], arrays[k],
                rtol=0, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name,recompute", [("tp2", False),
                                            ("tp2_remat", True)])
def test_tp2_counted_collectives(port, name, recompute):
    fwd = 2 * LAYERS + 1 + 3             # row layers, embedding, loss
    bwd = 2 * LAYERS + 1 + 3 + 1          # column layers, head input,
    #                                       the loss recomputed, the clip
    for _, values in port:
        ops = values[f"{name}.stats"]["ops"]
        assert ops == {"all_reduce": fwd + bwd + (LAYERS if recompute
                                                  else 0)}, ops


def test_tp2_train_recipe_matches_reference(port):
    state0, losses, final, _ = oracle.jax_train(TP, **RECIPE)
    arrays, values = port[0]
    np.testing.assert_allclose(values["tp2_recipe.losses"], losses,
                               rtol=2e-3)
    _bf16_close(arrays, "tp2_recipe.param.", final)


def test_dp2_tp2_zero2_amp_recompute_matches_reference(tmp_path):
    """4 ranks: ZeRO 2 on a mesh with tp takes the per-parameter route in
    both packages; f32 storage, amp and recompute."""
    _, state = oracle.ref_state()
    case = dict(name="dptp", mesh=DPTP, zero=2, amp=True, recompute=True)
    res = oracle.run_job(tmp_path, "hybrid", 4,
                         oracle.inputs(state, cases=json.dumps([case])))
    oracle.foreign_free(res)
    state0, losses, final, _ = oracle.jax_train(DPTP, zero=2, amp=True,
                                                recompute=True)
    arrays, values = res[0]
    assert not values["dptp.zero_manual"]
    for _, v in res:
        np.testing.assert_allclose(v["dptp.losses"], losses, rtol=2e-3)
        kd = v["dptp.stats"]["bytes_by_kind_dtype"]
        assert kd["reduce_scatter"]["f32"] > 0 and \
            kd["all_gather"]["f32"] > 0, kd
    _bf16_close(arrays, "dptp.param.", final)
