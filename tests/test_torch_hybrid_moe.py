"""A MoE GPT in the port's trainers at ``ep`` 2, held against the JAX
package's at the same mesh on the virtual CPU devices: gpt_tiny's
widths with 4 experts (top-2, capacity 1.25, aux weight 0.01; 8 experts
at ``{"dp": 2, "ep": 2}``), weights from the reference's ``state_dict()``
(each ``ep`` rank loads its half of the experts:
``shard_reference_state``'s ``ep`` cut), 3 AdamW steps with
``ClipGradByGlobalNorm(1.0)`` on global [4, 32] batches.

- ``GPTHybridTrainer`` at ``{"dp": 1, "ep": 2}`` and at ``{"dp": 1,
  "pp": 2}`` (the aux through the pipeline's ``stage_aux``: busy ticks,
  summed over pp, over n_micro; ``tests/test_moe.py:211``), with step
  0's gradients (the experts' on their ``ep`` rank, the rest equal on
  both) against the reference's ``GPT.loss`` gradients where the
  micro-batch is the whole batch.
- ``compile_train_step`` at ``{"dp": 2, "ep": 2}`` with the model's
  ``.loss`` (the reference's own example, ``examples/moe_expert_parallel.py``):
  the router sees each micro-batch's dp slices as one group.

Losses at rtol 1e-5 and gathered parameters at atol 1e-5 where the
step-0 gradient is clear, the tolerances of the port's other trainer
tests.
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

MOE = dict(oracle.CFG, moe_num_experts=4, moe_top_k=2,
           moe_capacity_factor=1.25, moe_aux_weight=0.01)
MOE8 = dict(MOE, moe_num_experts=8)
EP = {"dp": 1, "ep": 2}
PP = {"dp": 1, "pp": 2}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    _, state = oracle.ref_state(cfg=MOE)
    cases = [dict(name="ep2", mesh=EP, grads=True),
             dict(name="pp2", mesh=PP, grads=True)]
    res = oracle.run_job(tmp_path_factory.mktemp("hybrid_moe"), "hybrid",
                         2, oracle.inputs(state, cfg=MOE,
                                          cases=json.dumps(cases)))
    oracle.foreign_free(res)
    return res


def _ref_grads(cfg, tok):
    import jax
    import jax.numpy as jnp

    import paddle_tpu as paddle
    from paddle_tpu.static.functional import _swapped_state, state_tensors

    net, _ = oracle.ref_state(cfg=cfg)
    names, params, _, _ = state_tensors(net)

    def loss_fn(values, t):
        with _swapped_state(params, list(values)):
            return net.loss(paddle.to_tensor(t))._value

    grads = jax.jit(jax.grad(loss_fn))([p._value for p in params],
                                       jnp.asarray(tok, jnp.int32))
    return {n: np.asarray(g) for n, g in zip(names, grads)}


@pytest.fixture(scope="module")
def g0():
    return _ref_grads(MOE, oracle.tokens()[0])


def _stage_grads(port, name):
    """Step 0's gradients of a pp run, each from its stage."""
    out = {}
    for arrays, _ in port:
        for k, a in arrays.items():
            if k.startswith(f"{name}.grad."):
                out[k[len(f"{name}.grad."):]] = a
    return out


@pytest.mark.parametrize("name,mesh", [("ep2", EP), ("pp2", PP)])
def test_moe_trainer_matches_reference(port, g0, name, mesh):
    state0, losses, final, _ = oracle.jax_train(mesh, cfg=MOE)
    for _, values in port:
        np.testing.assert_allclose(values[f"{name}.losses"], losses,
                                   rtol=oracle.LOSS_RTOL)
    # pp 2 routes each of its 2 micro-batches on its own, so its step-0
    # gradient (where Adam's first step is clear) is its own
    clear = g0 if name == "ep2" else _stage_grads(port, name)
    oracle.assert_params(port[0][0], final, state0, clear,
                         prefix=f"{name}.param.")


def test_moe_ep2_gradients(port, g0):
    """Step 0 at ep 2: each rank's experts' gradients are its half of the
    reference's; the gate's and the rest are whole on both ranks."""
    for rank, (arrays, _) in enumerate(port):
        for n, g in g0.items():
            got = arrays[f"ep2.grad.{n}"]
            if got.shape != g.shape:       # an expert tensor: [E/2, ...]
                g = np.split(g, 2, 0)[rank]
            np.testing.assert_allclose(got, g, rtol=1e-4, atol=2e-6,
                                       err_msg=n)
    # the clip's global norm counts each rank's experts once
    norm = np.sqrt(sum(float(np.square(g.astype(np.float64)).sum())
                       for g in g0.values()))
    for _, values in port:
        np.testing.assert_allclose(values["ep2.grad_norm"], norm, rtol=1e-5)


def test_compile_train_step_moe_dp2_ep2(tmp_path):
    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet import DistributedStrategy
    from paddle_tpu.distributed.strategy_compiler import compile_train_step

    net, state = oracle.ref_state(cfg=MOE8)
    res = oracle.run_job(tmp_path, "compile_moe", 4,
                         oracle.inputs(state, cfg=MOE8))
    oracle.foreign_free(res)
    opt = paddle.optimizer.AdamW(
        oracle.LR, parameters=net.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(oracle.CLIP))
    tr = compile_train_step(net, opt, DistributedStrategy(),
                            oracle.jax_mesh({"dp": 2, "ep": 2}))
    losses = [float(np.asarray(tr.step(t))) for t in oracle.tokens()]
    net = tr.sync_to_layer()
    final = {k: np.asarray(v._value, np.float32)
             for k, v in net.state_dict().items()}
    g0 = _ref_grads(MOE8, oracle.tokens()[0])
    for _, values in res:
        np.testing.assert_allclose(values["losses"], losses,
                                   rtol=oracle.LOSS_RTOL)
        assert values["experts_held"][0] == 4
    oracle.assert_params(res[0][0], final, state, g0, prefix="param.")
    # the router's all-gather over dp, the ep sums
    ops = res[0][1]["stats"]["ops"]
    assert ops["all_gather"] >= oracle.CFG["num_layers"], ops


def test_moe_dp2_ep2_zero2_matches_reference(tmp_path):
    """4 ranks, ZeRO 2 (the per-parameter route, each expert state on
    the dp slice of its rank's experts): the router's group is the
    micro-batch's dp slices, as in the reference's GSPMD program."""
    mesh = {"dp": 2, "ep": 2}
    _, state = oracle.ref_state(cfg=MOE8)
    case = dict(name="dpep", mesh=mesh, zero=2)
    res = oracle.run_job(tmp_path, "hybrid", 4,
                         oracle.inputs(state, cfg=MOE8,
                                       cases=json.dumps([case])))
    oracle.foreign_free(res)
    state0, losses, final, _ = oracle.jax_train(mesh, zero=2, cfg=MOE8)
    assert not res[0][1]["dpep.zero_manual"]
    for _, values in res:
        np.testing.assert_allclose(values["dpep.losses"], losses,
                                   rtol=oracle.LOSS_RTOL)
    oracle.assert_params(res[0][0], final, state0,
                         _ref_grads(MOE8, oracle.tokens()[0]),
                         prefix="dpep.param.")
