"""``compile_train_step`` (the layer-agnostic ``HybridParallelTrainer``)
and the data-parallel pair of the port on 2 gloo ranks (CPU), held
against the JAX package.

- ``loss_fn``: gpt_tiny's logits through a user cross entropy against
  explicit labels (the next tokens, the last position ignored), ``accumulate_steps=2`` (each micro-batch's backward,
  ONE update on the mean gradient) at ``{"dp": 2}``, ZeRO 0; the
  model's own ``.loss`` at ZeRO 2 (the flat slab). Both against the JAX
  ``compile_train_step`` at the same mesh on 2 virtual devices: losses
  at rtol 1e-5, parameters after 3 steps at atol 1e-5 where the step-0
  gradient is clear of zero.
- The double gradient sync (ROADMAP queue 1 item 7b): the eager
  ``DataParallel`` + ``fleet.distributed_optimizer`` pair all-reduces
  the bucket, then every gradient again; the trainer at dp 2 reduces
  each gradient once (one bucket) and a scalar loss. The pair's synced
  gradients equal the trainer's (rtol = atol = 1e-6: the second
  all-reduce averages equal values) and so do the parameters after one
  AdamW step (atol 1e-6 where |g| is clear of zero).
"""
import importlib.util
import os

import numpy as np

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet import DistributedStrategy
from paddle_tpu.distributed.strategy_compiler import compile_train_step

_spec = importlib.util.spec_from_file_location(
    "torch_hybrid_oracle", os.path.join(os.path.dirname(__file__), "data",
                                        "torch_hybrid_oracle.py"))
oracle = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(oracle)


def _labels(toks):
    """GPT.loss's targets as explicit labels (the next token; the last
    position ignored), so that the ``loss_fn`` case's loss and step-0
    gradient are ``GPT.loss``'s."""
    lbl = np.roll(toks, -1, axis=-1).astype(np.int32)
    lbl[..., -1] = -100
    return lbl


def _jax_compiled(loss_fn, zero):
    net, state0 = oracle.ref_state()
    opt = paddle.optimizer.AdamW(
        oracle.LR, parameters=net.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(oracle.CLIP))
    s = DistributedStrategy()
    if zero:
        s.sharding = True
        s.sharding_configs = {"sharding_stage": zero}
    tr = compile_train_step(net, opt, s, oracle.jax_mesh({"dp": 2}),
                            loss_fn=loss_fn, accumulate_steps=2)
    toks = oracle.tokens()
    losses = [float(np.asarray(tr.step(t, _labels(t)) if loss_fn
                               else tr.step(t))) for t in toks]
    net = tr.sync_to_layer()
    return state0, losses, {k: np.asarray(v._value, np.float32)
                            for k, v in net.state_dict().items()}


def test_compile_train_step_matches_reference(tmp_path):
    _, state = oracle.ref_state()
    toks = oracle.tokens()
    res = oracle.run_job(tmp_path, "compile", 2,
                         oracle.inputs(state, steps_lbl=_labels(toks)))
    oracle.foreign_free(res)
    v = oracle.CFG["vocab_size"]

    def ce(out, lbl):
        return paddle.nn.functional.cross_entropy(out.reshape([-1, v]),
                                                  lbl.reshape([-1]))

    g0 = oracle.ref_grads(state, toks[0])[1]
    for name, loss_fn, zero in (("loss_fn", ce, 0), ("model_loss", None, 2)):
        state0, losses, final = _jax_compiled(loss_fn, zero)
        arrays, values = res[0]
        assert values[f"{name}.zero_manual"] == (zero == 2)
        for _, vals in res:
            np.testing.assert_allclose(vals[f"{name}.losses"], losses,
                                       rtol=oracle.LOSS_RTOL)
        oracle.assert_params(arrays, final, state0, g0,
                             prefix=f"{name}.param.")
    kd = res[0][1]["model_loss.stats"]["bytes_by_kind_dtype"]
    assert kd["reduce_scatter"]["f32"] > 0 and kd["all_gather"]["f32"] > 0


def test_eager_pair_gradients_equal_the_trainers(tmp_path):
    _, state = oracle.ref_state()
    tok = oracle.tokens(1, seed=5)[0]
    res = oracle.run_job(tmp_path, "dp_pair", 2, oracle.inputs(state,
                                                               tok=tok))
    oracle.foreign_free(res)
    g0 = oracle.ref_grads(state, tok)[1]
    numel = sum(a.size for a in state.values())
    for arrays, values in res:
        for n, g in g0.items():
            np.testing.assert_allclose(arrays[f"eager.grad.{n}"],
                                       arrays[f"trainer.grad.{n}"],
                                       rtol=1e-6, atol=1e-6, err_msg=n)
            clear = np.abs(g) > oracle.G_CLEAR
            np.testing.assert_allclose(arrays[f"eager.param.{n}"][clear],
                                       arrays[f"trainer.param.{n}"][clear],
                                       rtol=0, atol=1e-6, err_msg=n)
        eager, once = values["eager_stats"], values["trainer_stats"]
        assert eager["ops"] == {"all_reduce": 1 + len(state)}
        assert eager["bytes"]["all_reduce"] == 2 * 4 * numel
        assert once["ops"] == {"all_reduce": 2}
        assert once["bytes"]["all_reduce"] == 4 * numel + 4
