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


# ---------------------------------------------------------------------------
# BERT and ERNIE (tests/test_torch_hybrid_bert*.py, test_torch_hybrid_ernie)
# ---------------------------------------------------------------------------
#: bert_tiny's and ernie_tiny's widths (the reference's ``models/bert.py``
#: and ``models/ernie.py``): 4 heads, vocab 128
BERT_CFG = dict(kind="bert", vocab_size=128, hidden_size=64, num_layers=2,
                num_heads=4, max_seq_len=64, type_vocab_size=2)
ERNIE_CFG = dict(kind="ernie", vocab_size=128, hidden_size=64, num_layers=4,
                 num_heads=4, max_seq_len=64)


def _bert_classes(kind):
    from paddle_tpu.models import bert as jbert
    from paddle_tpu.models import ernie as jernie

    return ((jbert.BertConfig, jbert.BertForPretraining) if kind == "bert"
            else (jernie.ErnieConfig, jernie.ErnieForPretraining))


def bert_ref_state(cfg, seed):
    """The reference BertForPretraining / ErnieForPretraining of ``cfg``
    from ``seed``: (model, {name: array})."""
    kw = dict(cfg)
    config_cls, model_cls = _bert_classes(kw.pop("kind"))
    paddle.seed(seed)
    net = model_cls(config_cls(**kw))
    return net, {k: np.asarray(v._value) for k, v in
                 net.state_dict().items()}


def bert_batches(n, b, s, vocab=128, seed=0, rate=0.15):
    """``n`` global batches ``(tokens, token_type_ids, mlm_labels,
    nsp_labels)`` as ``tests/test_hybrid_models.py`` draws them: arrays
    ``[n, b, s]`` (three) and ``[n, b]``."""
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, vocab, (n, b, s)).astype(np.int32)
    tt = rng.randint(0, 2, (n, b, s)).astype(np.int32)
    mlm = np.where(rng.rand(n, b, s) < rate,
                   rng.randint(0, vocab, (n, b, s)), -100).astype(np.int32)
    nsp = rng.randint(0, 2, (n, b)).astype(np.int32)
    return tok, tt, mlm, nsp


def bert_inputs(state, cfg, batches, **extra):
    """The ``inputs.npz`` dict of a ``bert`` worker job."""
    d = {f"state.{k}": v for k, v in state.items()}
    d.update(cfg=json.dumps(cfg), steps_tok=batches[0], steps_tt=batches[1],
             steps_mlm=batches[2], steps_nsp=batches[3])
    d.update(extra)
    return d


def bert_eager_loss(net, batch):
    """The reference model's ``loss`` on one global batch."""
    return float(net.loss(*[paddle.to_tensor(a) for a in batch]).numpy())


def jax_bert_train(cfg, axes, batches, steps, seed, opt="sgd", lr=0.0,
                   clip=None, zero=0, amp=False, recompute=False,
                   n_micro=None, trainer="hybrid", accumulate=1):
    """The JAX trainer (``HybridPipelineTrainer``, or ``compile_train_step``
    with ``accumulate`` micro-batches) on the reference model of ``cfg``
    at ``axes`` over the first ``steps`` of ``batches``: (initial params,
    losses, final params)."""
    from paddle_tpu.distributed.hybrid import HybridPipelineTrainer
    from paddle_tpu.distributed.strategy_compiler import compile_train_step

    net, state0 = bert_ref_state(cfg, seed)
    gc = None if clip is None else paddle.nn.ClipGradByGlobalNorm(clip)
    if opt == "sgd":
        o = paddle.optimizer.SGD(lr, parameters=net.parameters(),
                                 grad_clip=gc)
    else:
        o = paddle.optimizer.AdamW(lr, parameters=net.parameters(),
                                   grad_clip=gc)
    s = DistributedStrategy()
    s.amp, s.recompute = amp, recompute
    if zero:
        s.sharding = True
        s.sharding_configs = {"sharding_stage": zero}
    # the JAX trainers place the batch on "dp": the mesh always has it
    axes = dict({"dp": 1}, **axes)
    if trainer == "compile":
        tr = compile_train_step(net, o, s, jax_mesh(axes),
                                accumulate_steps=accumulate)
    else:
        tr = HybridPipelineTrainer(net, o, s, jax_mesh(axes),
                                   n_micro=n_micro)
    losses = [float(tr.step(*[b[i] for b in batches]))
              for i in range(steps)]
    net = tr.sync_to_layer()
    final = {k: np.asarray(v._value, np.float32)
             for k, v in net.state_dict().items()}
    return state0, losses, final


# ---------------------------------------------------------------------------
# ResNet with BatchNorm in compile_train_step (tests/test_torch_vision_*.py)
# ---------------------------------------------------------------------------
#: ResNet-18 at 10 classes, 32x32, global batch 8, Momentum(0.1)
VISION_BATCH = (8, 3, 32, 32)
VISION_LR = 0.1
VISION_STEPS = 3


def vision_ref_state(seed=3):
    """The reference ResNet-18 (10 classes) with the port's state from
    ``seed`` (``_torch_nn_oracle.paired_models``: built abstract, without
    the reference's per-shape initializer programs): (model, {name:
    array}), buffers included."""
    from _torch_nn_oracle import paired_models

    net, _ = paired_models("resnet18", seed, num_classes=10)
    return net, {k: np.asarray(v._value) for k, v in
                 net.state_dict().items()}


def vision_batches(n=VISION_STEPS):
    """``n`` global batches: images from ``RandomState(0)``, labels from
    ``RandomState(1)``."""
    xs = np.random.RandomState(0).randn(n, *VISION_BATCH).astype(np.float32)
    ys = np.random.RandomState(1).randint(
        0, 10, (n, VISION_BATCH[0])).astype(np.int64)
    return xs, ys


def _velocity(tr, names):
    st = tr.opt_states
    if isinstance(st, dict):                 # the ZeRO 1/2 flat slab
        return {"slab": np.array(st["velocity"], np.float32)}
    return {n: np.array(s["velocity"], np.float32)
            for n, s in zip(names, st)}


def jax_vision_trajectory(axes, zero=0, amp=False, accumulate=1, seed=3,
                          steps=VISION_STEPS, perturb=None):
    """The JAX ``compile_train_step`` on the reference ResNet-18 with
    ``Momentum(0.1)`` at ``axes`` and ZeRO ``zero`` over
    ``vision_batches``, the loss ``cross_entropy(out.float(), label)``:
    {"names", "buffer_names", "states": [state before step 0, after step
    0, ...], "losses"}; a state is {"params", "buffers", "velocity"} of
    numpy arrays by name (the velocity of the flat slab under "slab").

    ``perturb`` d: each step is also taken, from the same state, on the
    batch's images times ``1 + d·N(0, 1)`` (a fixed draw): "perturbed"
    holds the states after those and "perturbed_losses" their losses —
    the reference's own response to input noise of that size, which
    bounds how close an implementation that rounds differently can
    come."""
    import jax.numpy as jnp
    import paddle_tpu.nn.functional as JF
    from paddle_tpu.distributed.strategy_compiler import compile_train_step

    net, _ = vision_ref_state(seed)
    opt = paddle.optimizer.Momentum(VISION_LR, parameters=net.parameters())
    s = DistributedStrategy()
    s.amp = amp
    if zero:
        s.sharding = True
        s.sharding_configs = {"sharding_stage": zero}
    tr = compile_train_step(
        net, opt, s, jax_mesh(axes),
        loss_fn=lambda out, lbl: JF.cross_entropy(out.astype("float32"),
                                                  lbl),
        accumulate_steps=accumulate)
    names, bnames = list(tr.param_names), list(tr.buffer_names)

    def state():
        # copies: the trainer donates its state arrays to the next step
        return {"params": {n: np.array(p, np.float32)
                           for n, p in zip(names, tr.params)},
                "buffers": {n: np.array(b, np.float32)
                            for n, b in zip(bnames, tr.buffers)},
                "velocity": _velocity(tr, names)}

    def restore(st):
        _, p_sh, s_sh, b_sh = tr._out_shardings
        tr.params = [jax.device_put(jnp.asarray(st["params"][n]), sh)
                     for n, sh in zip(names, p_sh)]
        tr.buffers = [jax.device_put(jnp.asarray(st["buffers"][n]), sh)
                      for n, sh in zip(bnames, b_sh)]
        v = st["velocity"]
        if isinstance(tr.opt_states, dict):
            tr.opt_states = {"velocity": jax.device_put(
                jnp.asarray(v["slab"]), s_sh["velocity"])}
        else:
            tr.opt_states = [{"velocity": jax.device_put(
                jnp.asarray(v[n]), sh["velocity"])}
                for n, sh in zip(names, s_sh)]
        tr._step -= 1

    out = {"names": names, "buffer_names": bnames, "states": [state()],
           "losses": [], "perturbed": [], "perturbed_losses": [],
           "zero_manual": bool(tr.zero_manual)}
    noise = np.random.RandomState(7).randn(*VISION_BATCH).astype(np.float32)
    for x, y in zip(*vision_batches(steps)):
        if perturb:
            before = out["states"][-1]
            out["perturbed_losses"].append(float(tr.step(
                x * (1 + perturb * noise), y)))
            out["perturbed"].append(state())
            restore(before)
        out["losses"].append(float(tr.step(x, y)))
        out["states"].append(state())
    return out


def vision_inputs(traj, cases):
    """The ``inputs.npz`` dict of a ``vision`` worker job: the batches and,
    for each case, the reference's states."""
    xs, ys = vision_batches()
    d = {"xs": xs, "ys": ys, "cases": json.dumps(cases)}
    for case in cases:
        for k, st in enumerate(traj[case["name"]]["states"]):
            for part in ("params", "buffers", "velocity"):
                for n, a in st[part].items():
                    d[f"{case['name']}.{k}.{part}.{n}"] = a
    return d
