"""The JAX package's side of the port's hybrid-trainer tests
(``tests/test_torch_hybrid_*.py``): gpt_tiny's reference weights from a
seed, the global token batches, and the JAX trainers at the port's mesh
shapes on the 8 virtual CPU devices of ``tests/conftest.py`` (built as
``tests/test_zero_shard.py`` builds them). Imported by path, as
``torch_dist_worker.py`` is."""
import importlib.util
import json
import os

import numpy as np

import jax

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet import DistributedStrategy
from paddle_tpu.distributed.hybrid_gpt import GPTHybridTrainer
from paddle_tpu.distributed.mesh import create_mesh
from paddle_tpu.models import gpt as jgpt

_spec = importlib.util.spec_from_file_location(
    "torch_dist_worker", os.path.join(os.path.dirname(__file__),
                                      "torch_dist_worker.py"))
worker = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(worker)

#: gpt_tiny: 4 heads (2 a rank at tp 2), vocab 128 (64 a rank)
CFG = dict(vocab_size=128, hidden_size=64, num_layers=4, num_heads=4,
           max_seq_len=64, initializer_range=0.1)
LR = 1e-3
CLIP = 1.0
STEPS = 3
B, S = 4, 32
#: f32 losses (the reference's own sharded-vs-replicated parity is
#: bitwise; the port sums the same values in other orders)
LOSS_RTOL = 1e-5
#: parameters after 3 AdamW steps where |g| at step 0 is clear of zero
#: (Adam's first step is about lr·sign(g), so an element whose gradient
#: is within rounding of 0 may step either way): the reference's own
#: sharded-vs-replicated bound (tests/test_zero_shard.py:215-217)
PARAM_ATOL = 1e-5
G_CLEAR = 1e-4


def ref_state(seed=3, cfg=None):
    paddle.seed(seed)
    net = jgpt.GPT(jgpt.GPTConfig(**(cfg or CFG)))
    return net, {k: np.asarray(v._value) for k, v in
                 net.state_dict().items()}


def tokens(n=STEPS, seed=0):
    r = np.random.RandomState(seed)
    return r.randint(0, CFG["vocab_size"], (n, B, S)).astype(np.int32)


def inputs(state, cfg=None, **extra):
    """The ``inputs.npz`` dict of a worker job."""
    d = {f"state.{k}": v for k, v in state.items()}
    d.update(cfg=json.dumps(cfg or CFG), lr=LR, clip=CLIP,
             steps_tok=tokens())
    d.update(extra)
    return d


def run_job(tmp_path, job, nranks, inp, timeout=240):
    np.savez(os.path.join(str(tmp_path), "inputs.npz"), **inp)
    return worker.launch_job(job, nranks, tmp_path, timeout=timeout)


def jax_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return create_mesh(dict(axes), jax.devices()[:n])


def jax_train(axes, zero=0, amp=False, recompute=False, seed=3,
              batch=None, clip=CLIP, cfg=None, **kw):
    """The JAX GPTHybridTrainer at ``axes`` and ZeRO ``zero`` over the
    token batches of ``tokens()`` (their first ``batch`` rows), with the
    global-norm clip at ``clip`` (None: none), on gpt_tiny or ``cfg``:
    (initial params, losses, final params, moment1)."""
    net, state0 = ref_state(seed, cfg)
    opt = paddle.optimizer.AdamW(
        LR, parameters=net.parameters(), weight_decay=0.01,
        grad_clip=None if clip is None
        else paddle.nn.ClipGradByGlobalNorm(clip))
    s = DistributedStrategy()
    s.amp, s.recompute = amp, recompute
    if zero:
        s.sharding = True
        s.sharding_configs = {"sharding_stage": zero}
    tr = GPTHybridTrainer(net, opt, s, jax_mesh(axes), **kw)
    losses = [float(tr.step(t[:batch])) for t in tokens()]
    net = tr.sync_to_layer()
    final = {k: np.asarray(v._value, np.float32)
             for k, v in net.state_dict().items()}
    m1 = {n: np.asarray(opt._accumulators[id(p)]["moment1"], np.float32)
          for n, p in net.named_parameters()}
    return state0, losses, final, m1


def ref_grads(state, tok):
    """The reference GPT's loss on ``tok`` and every gradient (one jitted
    value_and_grad, as tests/test_torch_dataparallel.py)."""
    import jax.numpy as jnp
    from paddle_tpu.static.functional import _swapped_state, state_tensors

    net, _ = ref_state()
    net.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    names, params, _, _ = state_tensors(net)

    def loss_fn(values, t):
        with _swapped_state(params, list(values)):
            return net.loss(paddle.to_tensor(t))._value

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        [p._value for p in params], jnp.asarray(tok, jnp.int32))
    return float(loss), {n: np.asarray(g) for n, g in zip(names, grads)}


def assert_params(got, want, state0, g0, atol=PARAM_ATOL, prefix=""):
    """Every parameter within ``atol`` of the reference's wherever the
    step-0 gradient is clear of zero; the parameters moved."""
    moved = 0.0
    for n, w in want.items():
        a = got[prefix + n]
        clear = np.abs(g0[n]) > G_CLEAR
        assert clear.any(), n
        np.testing.assert_allclose(a[clear], w[clear], rtol=0, atol=atol,
                                   err_msg=n)
        moved = max(moved, float(np.abs(w - state0[n]).max()))
    assert moved > 100 * atol, moved


def foreign_free(res):
    for _, values in res:
        assert values["foreign_modules"] == [], values["foreign_modules"]


#: the guard's chaos sequence: a NaN injected before these steps of
#: ``tokens()`` (the resilience tests poison one rank of the port's mesh)
POISON_STEPS = (1,)


def jax_guarded(axes, zero=0, poison=POISON_STEPS, seed=3, clip=CLIP,
                cfg=None, **kw):
    """The JAX GPTHybridTrainer with ``guard_bad_steps`` at ``axes`` and
    ZeRO ``zero`` over ``tokens()``, ``inject_fault_scale(nan)`` before
    each step in ``poison``: (initial params, losses, verdicts, final
    params)."""
    net, state0 = ref_state(seed, cfg)
    opt = paddle.optimizer.AdamW(
        LR, parameters=net.parameters(), weight_decay=0.01,
        grad_clip=None if clip is None
        else paddle.nn.ClipGradByGlobalNorm(clip))
    s = DistributedStrategy()
    if zero:
        s.sharding = True
        s.sharding_configs = {"sharding_stage": zero}
    tr = GPTHybridTrainer(net, opt, s, jax_mesh(axes),
                          guard_bad_steps=True, **kw)
    losses, oks = [], []
    for i, t in enumerate(tokens()):
        if i in poison:
            tr.inject_fault_scale(float("nan"))
        losses.append(float(tr.step(t)))
        oks.append(tr.last_step_ok)
    net = tr.sync_to_layer()
    final = {k: np.asarray(v._value, np.float32)
             for k, v in net.state_dict().items()}
    return state0, losses, oks, final
