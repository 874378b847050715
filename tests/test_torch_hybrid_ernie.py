"""ERNIE at ZeRO 3 with recompute on dp 4 x tp 2, 8 gloo ranks (CPU): the
oracle ``TestErnieZero3`` (``tests/test_hybrid_models.py:64-101``) held
to the JAX ``HybridPipelineTrainer`` at the same mesh (worker
``tests/data/torch_dist_worker.py``'s ``bert`` job, the JAX side from
``tests/data/torch_hybrid_oracle.py``).

ernie_tiny (4 layers, 4 heads, type vocab 4) on global [8, 32] batches:

- ``SGD(0)``: the step-0 loss equals the JAX trainer's at the same mesh
  and the reference's eager loss at rtol 1e-5 (f32; the oracle's bound
  is 2e-2);
- amp, ``AdamW(2e-3)`` with ``ClipGradByGlobalNorm(1.0)``, 5 steps on one
  batch: the losses at rtol 2e-3 against JAX (both packages compute in
  bf16 and round in different orders; ``tests/test_torch_hybrid_tp.py``'s
  bound), falling and equal on every rank. The parameters after the
  steps: the root mean square of their difference from the JAX
  trainer's at most a tenth of the root mean square the steps moved them
  (measured 3.3e-4 against 5.8e-3 moved), and every element within
  ``2·lr·steps`` (Adam moves an element by about lr a step, so an element
  whose update sign the two packages pick apart can be that far; measured
  8.6e-3 against 2e-2). The share within one bf16 ulp, the bound of
  ``tests/test_torch_training.py``, does not hold here even between the
  reference's own runs: its trainer at dp 4 x tp 2 and at degree 1 agree
  within one bf16 ulp on 77.4% of the elements, with a root mean square
  difference of 2.4e-4 (the port's: 66.1%, 3.3e-4). A step of 2e-3 on
  weights of about 0.02 is ten bf16 ulps, so one flipped sign in five
  steps leaves an element several ulps away;
- the block parameters hold dp slices (ZeRO 3), and ``sync_to_layer``
  with ``gather_reference_state`` gives every parameter whole.
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

CFG = oracle.ERNIE_CFG
MESH = {"dp": 4, "tp": 2}
STEPS = 5
SEED = 7
LR, CLIP = 2e-3, 1.0
Z3 = dict(zero=3, recompute=True)


@pytest.fixture(scope="module")
def batches():
    step0 = oracle.bert_batches(1, 8, 32, seed=5)
    train = oracle.bert_batches(1, 8, 32, seed=6)
    return tuple(np.concatenate([a] + [b] * STEPS)
                 for a, b in zip(step0, train))


@pytest.fixture(scope="module")
def ref():
    return oracle.bert_ref_state(CFG, SEED)


@pytest.fixture(scope="module")
def port(tmp_path_factory, batches, ref):
    cases = [dict(name="sgd0", mesh=MESH, **Z3),
             dict(name="amp", mesh=MESH, amp=True, opt="adamw", lr=LR,
                  clip=CLIP, steps=STEPS, first=1, **Z3)]
    res = oracle.run_job(tmp_path_factory.mktemp("ernie"), "bert", 8,
                         oracle.bert_inputs(ref[1], CFG, batches,
                                            cases=json.dumps(cases)),
                         timeout=300)
    oracle.foreign_free(res)
    return res


def test_zero3_recompute_step0_loss_matches_reference(port, batches, ref):
    step0 = tuple(b[:1] for b in batches)
    eager = oracle.bert_eager_loss(ref[0], tuple(b[0] for b in step0))
    _, jl, _ = oracle.jax_bert_train(CFG, MESH, step0, 1, SEED, **Z3)
    np.testing.assert_allclose(jl[0], eager, rtol=1e-5)
    for _, values in port:
        np.testing.assert_allclose(values["sgd0.losses"][0], jl[0],
                                   rtol=1e-5)


def test_zero3_recompute_amp_clip_training_matches_reference(port, batches):
    train = tuple(b[1:] for b in batches)
    state0, jl, final = oracle.jax_bert_train(CFG, MESH, train, STEPS, SEED,
                                         opt="adamw", lr=LR, clip=CLIP,
                                         amp=True, **Z3)
    first = port[0][1]["amp.losses"]
    for _, values in port:
        got = values["amp.losses"]
        assert got == first and got[-1] < got[0], got
        np.testing.assert_allclose(got, jl, rtol=2e-3)
        assert not values["amp.zero_manual"]
        # ZeRO 3: every block's parameters carry the dp slice
        sliced = set(values["amp.dp_sliced"])
        blocks = {n for n in final if n.startswith("bert.blocks.")}
        assert any(n in sliced for n in blocks), sorted(sliced)
        assert values["amp.whole"] is True
    arrays = port[0][0]
    diff = np.concatenate([(arrays[f"amp.param.{n}"] - w).ravel()
                           for n, w in final.items()])
    moved = np.concatenate([(w - state0[n]).ravel()
                            for n, w in final.items()])
    assert np.sqrt(np.mean(diff ** 2)) <= 0.1 * np.sqrt(np.mean(moved ** 2))
    assert np.abs(diff).max() <= 2 * LR * STEPS, np.abs(diff).max()
