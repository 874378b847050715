"""The port's ``GPTHybridTrainer`` with the pipeline composed with the
other axes, on 4 gloo ranks (CPU), held against the JAX package's
trainer at the same mesh on 4 of the virtual CPU devices: gpt_tiny from
the reference's weights, AdamW(1e-3, weight_decay 0.01) with
``ClipGradByGlobalNorm(1.0)``, 3 steps on global [4, 32] batches,
``n_micro`` 2 (the default: pp).

- ``{"dp": 1, "pp": 2, "tp": 2}`` (reference ``tests/test_hybrid_models.py:111,
  137``): each stage's blocks split their heads over ``tp``; the head's
  vocab-parallel loss runs on the last stage.
- ``{"dp": 1, "pp": 2, "sp": 2}``: each stage sees its sequence shard
  (the reference's manual sp inside the stage) and its attention runs
  the ring; the head's global mean over the shards.
- ``{"dp": 2, "pp": 2}`` at ZeRO 3: each stage's parameters stored on
  their dp slices (the per-parameter route).

Losses at rtol 1e-5, gathered parameters at atol 1e-5 where the step-0
gradient is clear of zero.
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

CASES = [dict(name="pp2tp2", mesh={"dp": 1, "pp": 2, "tp": 2}),
         dict(name="pp2sp2", mesh={"dp": 1, "pp": 2, "sp": 2}),
         dict(name="dp2pp2_z3", mesh={"dp": 2, "pp": 2}, zero=3)]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    _, state = oracle.ref_state()
    res = oracle.run_job(tmp_path_factory.mktemp("hybrid_pp4"), "hybrid", 4,
                         oracle.inputs(state, cases=json.dumps(CASES)))
    oracle.foreign_free(res)
    return res


@pytest.fixture(scope="module")
def g0():
    _, state = oracle.ref_state()
    return oracle.ref_grads(state, oracle.tokens()[0])[1]


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_pipeline_composed_matches_reference(port, g0, case):
    name = case["name"]
    state0, losses, final, _ = oracle.jax_train(case["mesh"],
                                                zero=case.get("zero", 0))
    for _, values in port:
        np.testing.assert_allclose(values[f"{name}.losses"], losses,
                                   rtol=oracle.LOSS_RTOL)
    oracle.assert_params(port[0][0], final, state0, g0,
                         prefix=f"{name}.param.")


def test_zero3_stage_holds_its_slices(port):
    """ZeRO 3 over dp on each stage: a rank's stored parameters and
    optimizer state are about half of its stage's (the non-block
    parameters and its circuits' blocks)."""
    _, state = oracle.ref_state()
    for _, values in port:
        layers = {l for c in values["dp2pp2_z3.circuits"] for l in c}
        stage = sum(a.size for n, a in state.items()
                    if not n.startswith("blocks.")
                    or int(n.split(".")[1]) in layers)
        led = values["dp2pp2_z3.ledger"]
        assert led["param"] <= 0.55 * 4 * stage, (led, stage)
        assert led["opt_state"] <= 0.55 * 2 * 4 * stage, (led, stage)
