"""BERT's masked-position MLM head and gradient merge through the port's
trainers on one process (CPU), against the JAX package where it has a
counterpart:

- the oracle ``TestMaskedPositionMLMHead``
  (``tests/test_hybrid_models.py:219-255``) through the port's
  ``HybridPipelineTrainer``: with ``max_predictions`` 16 at S 32 and no
  row masking more than 16, the gathered head's step-0 loss equals the
  full head's at 1e-4 (same weights); and the gathered head at
  ``max_predictions`` 8 trains under amp (AdamW, 5 steps, the loss
  falls);
- ``compile_train_step`` with ``accumulate_steps=4`` on bert_tiny (f32,
  ``SGD`` with the global-norm clip, 3 steps on [8, 32] batches) against
  the JAX ``compile_train_step``: losses at rtol 1e-5 and parameters at
  atol 1e-5 (the mean of the micro-batches' losses, one update on the
  mean gradient).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.distributed.hybrid import HybridPipelineTrainer
from paddle_tpu_torch.distributed.strategy_compiler import compile_train_step
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.optimizer import SGD, AdamW

_spec = importlib.util.spec_from_file_location(
    "torch_hybrid_oracle", os.path.join(os.path.dirname(__file__), "data",
                                        "torch_hybrid_oracle.py"))
oracle = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(oracle)

CFG = oracle.BERT_CFG


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(state, **kw):
    net = tbert.bert_tiny(device="cpu", **kw)
    tgpt.load_reference_state(net, state)
    return net


def _t(batch):
    return [torch.from_numpy(np.asarray(a)).long() for a in batch]


def test_gathered_head_matches_full_head():
    _, state = oracle.bert_ref_state(CFG, 7)
    batch = tuple(b[0] for b in oracle.bert_batches(1, 8, 32, seed=11))
    # 16 < S 32, so the gather runs; no row masks more than 16
    assert (np.sum(batch[2] != -100, axis=1) <= 16).all()
    losses = []
    for maxp in (0, 16):
        net = _port(state, max_predictions=maxp)
        tr = HybridPipelineTrainer(net, SGD(0.0,
                                            parameters=net.parameters()),
                                   DistributedStrategy())
        losses.append(float(tr.step(*_t(batch))))
    assert abs(losses[0] - losses[1]) < 1e-4, losses


def test_gathered_head_trains():
    _, state = oracle.bert_ref_state(CFG, 8)
    net = _port(state, max_predictions=8)
    s = DistributedStrategy()
    s.amp = True
    tr = HybridPipelineTrainer(net, AdamW(2e-3,
                                          parameters=net.named_parameters()),
                               s)
    batch = _t(tuple(b[0] for b in oracle.bert_batches(1, 8, 32, seed=9)))
    losses = [float(tr.step(*batch)) for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_compile_train_step_accumulate_matches_reference():
    batches = oracle.bert_batches(3, 8, 32, seed=13)
    state0, jl, final = oracle.jax_bert_train(
        CFG, {"dp": 1}, batches, 3, 5, opt="sgd", lr=0.5, clip=0.5,
        trainer="compile", accumulate=4)
    net = _port(state0)
    opt = SGD(0.5, parameters=net.named_parameters(),
              grad_clip=tnn.ClipGradByGlobalNorm(0.5))
    tr = compile_train_step(net, opt, DistributedStrategy(),
                            accumulate_steps=4)
    losses = [float(tr.step(*_t(tuple(b[i] for b in batches))))
              for i in range(3)]
    np.testing.assert_allclose(losses, jl, rtol=1e-5)
    got = tgpt.state_to_numpy(tr.sync_to_layer())
    moved = 0.0
    for n, w in final.items():
        np.testing.assert_allclose(got[n], w, rtol=0, atol=1e-5, err_msg=n)
        moved = max(moved, float(np.abs(w - state0[n]).max()))
    assert moved > 1e-3, moved
