"""Data parallelism of the port on 2 gloo ranks (CPU), held against the
JAX package's single-process result on the ranks' concatenated batches.

One job (``tests/data/torch_dist_worker.py``, job ``dp``) on a port
gpt_tiny (vocab 128, h 64, 2 layers, 2 heads) loaded from the reference
model's weights by ``load_reference_state``:

- ``DataParallel``: rank 1 starts from other weights, the wrap
  broadcasts rank 0's; after ``apply_collective_grads`` every gradient
  equals ``jax.grad`` of the reference GPT loss on the concatenated
  [4, 32] batch (rtol = atol = 1e-4, the port's ``GPT.loss`` gradient
  tolerance against the reference); ``fleet.distributed_optimizer(AdamW)``
  then steps, and each parameter equals the reference AdamW's step on
  that batch wherever |g| > 1e-4 (atol 1e-6; Adam's first update is
  about lr·sign(g), so a gradient within its tolerance of 0 may take
  either sign); the accounting counts the f32 bucket (4 bytes a
  parameter element) and the optimizer's per-parameter all-reduces.
- ``gradient_merge`` with k 2 and avg: the first step updates nothing;
  the merged gradient equals ``jax.grad`` on all four micro-batches (the
  mean of two [4, 32] batches' gradients).
- LocalSGD (k 3) and adaptive LocalSGD (init_k 2, constant lr) with
  AdamW on different data per rank: parameters differ between syncs and
  are bitwise equal after each one (the properties of
  ``tests/localsgd_worker.py``).
"""
import importlib.util
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.static.functional import _swapped_state, state_tensors

_spec = importlib.util.spec_from_file_location(
    "torch_dist_worker", os.path.join(os.path.dirname(__file__), "data",
                                      "torch_dist_worker.py"))
worker = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(worker)

CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
           max_seq_len=64, initializer_range=0.1)
LR = 1e-3
S = 32
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _ref_model():
    paddle.seed(3)
    net = jgpt.GPT(jgpt.GPTConfig(**CFG))
    return net, {k: np.asarray(v._value) for k, v in net.state_dict().items()}


def _ref_grads(state, tokens):
    """The reference GPT's loss on ``tokens`` and its gradients, as one
    jitted ``jax.value_and_grad`` over the model's parameters (the
    reference's ``static.functional`` swap; the eager tape gives the same
    values but compiles op by op); the gradients are also left on the
    parameters' ``.grad`` for the reference optimizer."""
    net, _ = _ref_model()
    net.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    names, params, _, _ = state_tensors(net)

    def loss_fn(values, tok):
        with _swapped_state(params, list(values)):
            return net.loss(paddle.to_tensor(tok))._value

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        [p._value for p in params], jnp.asarray(tokens, jnp.int32))
    for p, g in zip(params, grads):
        p.grad = paddle.to_tensor(g)
    return net, float(loss), {n: np.asarray(g) for n, g in zip(names, grads)}


@pytest.fixture(scope="module")
def dp_job(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    _, state = _ref_model()
    r = np.random.RandomState(5)
    v = CFG["vocab_size"]
    inp = {"cfg": np.array(json.dumps(CFG)), "lr": np.array(LR),
           "tok": r.randint(0, v, (2, 2, S)).astype(np.int64),
           "merge_tok": r.randint(0, v, (2, 2, 2, S)).astype(np.int64),
           "local_tok": r.randint(0, v, (2, 6, 2, S)).astype(np.int64)}
    # the first merge micro-step takes the DP step's batch, whose reference
    # gradients ref_step computes anyway
    inp["merge_tok"][:, 0] = inp["tok"]
    inp.update({f"state.{k}": a for k, a in state.items()})
    np.savez(d / "inputs.npz", **inp)
    return inp, state, worker.launch_job("dp", 2, d)


def test_fleet_roles_and_hygiene(dp_job):
    for rank, (_, v) in enumerate(dp_job[2]):
        idx, num, first, eps = v["worker"]
        assert (idx, num, first) == (rank, 2, rank == 0)
        assert len(eps.split(",")) == 2
        assert v["foreign_modules"] == []


@pytest.fixture(scope="module")
def ref_step(dp_job):
    """The reference on the concatenated batch: (loss, gradients, the
    parameters after AdamW's step)."""
    inp, state, _ = dp_job
    net, loss, grads = _ref_grads(state, inp["tok"].reshape(4, S))
    JAdamW(LR, parameters=net.parameters(), weight_decay=0.01).step()
    return loss, grads, {n: np.asarray(p._value)
                         for n, p in net.named_parameters()}


def test_synced_gradients_equal_the_reference_on_the_concatenated_batch(
        dp_job, ref_step):
    _, _, out = dp_job
    loss, want, _ = ref_step
    for rank, (a, v) in enumerate(out):
        assert set(v["names"]) == set(want)
        for n, g in want.items():
            np.testing.assert_allclose(a[f"grad.{n}"], g, **GRAD_TOL,
                                       err_msg=f"{n} rank {rank}")
    # each rank's own loss is its half of the batch: their mean is the
    # concatenated batch's loss
    assert np.mean([v["loss"] for _, v in out]) == pytest.approx(
        loss, rel=1e-5)


def test_distributed_adamw_step_equals_the_reference_step(dp_job, ref_step):
    out = dp_job[2]
    _, grads, params = ref_step
    for n, want in params.items():
        clear = np.abs(grads[n]) > GRAD_TOL["atol"]
        for rank, (a, _) in enumerate(out):
            got = a[f"param.{n}"]
            np.testing.assert_allclose(got[clear], want[clear], rtol=0,
                                       atol=1e-6, err_msg=f"{n} rank {rank}")
        np.testing.assert_array_equal(out[0][0][f"param.{n}"],
                                      out[1][0][f"param.{n}"])


def test_accounting_counts_the_bucket_and_the_per_parameter_reduces(dp_job):
    for _, v in dp_job[2]:
        numel = v["numel"]
        st = v["stats"]
        assert st["ops"] == {"all_reduce": 1 + v["n_params"]}
        assert st["bytes"] == {"all_reduce": 2 * 4 * numel}
        assert st["bytes_by_dtype"] == {"f32": 2 * 4 * numel}
        assert st["total_bytes"] == 2 * 4 * numel


def test_gradient_merge_k2(dp_job, ref_step):
    """The merged gradient is the mean over all four equal micro-batches:
    the mean of the reference's gradients on each micro-step's
    concatenated [4, 32] batch (the first is ``ref_step``'s)."""
    inp, state, out = dp_job
    second = _ref_grads(state, inp["merge_tok"][:, 1].reshape(4, S))[2]
    want = {n: (ref_step[1][n] + second[n]) / 2 for n in second}
    for rank, (a, v) in enumerate(out):
        assert v["merge_first_is_noop"]
        for n, g in want.items():
            np.testing.assert_allclose(a[f"merge_grad.{n}"], g, **GRAD_TOL,
                                       err_msg=f"{n} rank {rank}")


@pytest.mark.parametrize("kind,k,steps", [("localsgd", 3, 6),
                                          ("adaptive_localsgd", 2, 4)])
def test_localsgd_diverges_between_syncs_and_agrees_after(dp_job, kind, k,
                                                          steps):
    want = [(s + 1) % k == 0 for s in range(steps)]
    for _, v in dp_job[2]:
        assert v[kind] == want
