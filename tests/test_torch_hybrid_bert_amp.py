"""BERT at dp 2 x tp 2 x pp 2 under amp on 8 gloo ranks (CPU): the oracle
``TestBertHybrid.test_bert_hybrid_training_decreases_loss``
(``tests/test_hybrid_models.py:50-61``) held to the JAX
``HybridPipelineTrainer`` at the same mesh (worker
``tests/data/torch_dist_worker.py``'s ``bert`` job, the JAX side from
``tests/data/torch_hybrid_oracle.py``).

bert_tiny, ``n_micro`` 2, ``AdamW(2e-3)`` (weight decay 0.01), 5 steps
on one global [8, 32] batch. Both packages compute the forward in bf16
and round their products in different orders, so the losses are held at
rtol 2e-3, half of bf16's 2^-8 (the bound of
``tests/test_torch_hybrid_tp.py``); they must fall, and agree across the
ranks (the trainer's loss is the dp mean).
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

CFG = oracle.BERT_CFG
MESH = {"dp": 2, "tp": 2, "pp": 2}
STEPS = 5
SEED = 6
LR = 2e-3


@pytest.fixture(scope="module")
def batches():
    one = oracle.bert_batches(1, 8, 32, seed=4)
    return tuple(np.repeat(a, STEPS, axis=0) for a in one)


@pytest.fixture(scope="module")
def port(tmp_path_factory, batches):
    _, state = oracle.bert_ref_state(CFG, SEED)
    case = dict(name="amp", mesh=MESH, n_micro=2, amp=True, opt="adamw",
                lr=LR, steps=STEPS)
    res = oracle.run_job(tmp_path_factory.mktemp("bert_amp"), "bert", 8,
                         oracle.bert_inputs(state, CFG, batches,
                                            cases=json.dumps([case])),
                         timeout=300)
    oracle.foreign_free(res)
    return res


def test_dp2_tp2_pp2_amp_training_matches_reference(port, batches):
    _, jl, _ = oracle.jax_bert_train(CFG, MESH, batches, STEPS, SEED,
                                     opt="adamw", lr=LR, amp=True, n_micro=2)
    assert jl[-1] < jl[0], jl
    first = port[0][1]["amp.losses"]
    for _, values in port:
        got = values["amp.losses"]
        assert got == first                      # the dp mean, every rank
        assert all(np.isfinite(got)) and got[-1] < got[0], got
        np.testing.assert_allclose(got, jl, rtol=2e-3)
        assert values["amp.whole"] is True
