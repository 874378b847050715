"""The training slice of paddle_tpu_torch held against the JAX package.

Inputs are numpy from a seed; the port's model gets the reference
model's initial weights through ``load_reference_state``. The JAX side
runs its Pallas flash kernels in interpret mode (``conftest.py``: f32
matmuls at "highest" precision); the port side runs the plain versions
of its kernels on CPU tensors.

- ``fused_ce``: loss and gradients against
  ``fused_linear_cross_entropy_fn`` at atol = rtol = 1e-5 (f32; the
  chunked sums reassociate), tied and ``transpose_w``, with
  ignore_index labels, chunk 256 over S 512 and S 384 (the shrink).
- ``GPT.loss``: loss and every parameter's gradient at S 128 (both
  packages take the flash path) at atol = rtol = 1e-4.
- The trainer: ``GPTConfig(vocab 128, h 64, 2 layers, 2 heads, S
  128)``, tokens ``[4, 128]``, ``n_micro=2``, the single-chip recipe's
  AdamW(weight_decay 0.1), ``LinearWarmup(CosineAnnealingDecay)`` and
  ``ClipGradByGlobalNorm(1.0)``, 3 steps in each package: amp off
  (recompute on and off) at loss rtol 1e-5 and parameters atol 1e-4;
  amp on with bf16 parameters and moments at peak 2e-2: losses at atol
  5e-4, parameters at one bf16 ulp on most elements and moments at
  5e-2 of their largest value (see the test for why not every
  element). The eager ``loss.backward(); opt.step()`` loop against the
  trainer.
- ``AdamW`` with ``apply_decay_param_fun`` and ``lr_ratio``, the three
  clips, and the recipe's schedule over 30 steps against the JAX
  package's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy
from paddle_tpu.distributed.hybrid import HybridPipelineTrainer as JTrainer
from paddle_tpu.distributed.strategy_compiler import build_mesh_from_strategy
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops import fused_ce as jce
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.distributed.hybrid import HybridPipelineTrainer
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import fused_ce as tce
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
           max_seq_len=128)


# ---------------------------------------------------------------------------
# fused lm-head cross entropy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", [512, 384])
@pytest.mark.parametrize("transpose_w", [False, True])
def test_fused_ce_loss_and_grads_match_reference(s, transpose_w):
    r = np.random.RandomState(s + transpose_w)
    b, h, v = 2, 32, 96
    x = r.randn(b, s, h).astype(np.float32)
    w = (r.randn(h, v) if transpose_w else r.randn(v, h)).astype(np.float32)
    labels = r.randint(0, v, (b, s)).astype(np.int32)
    labels[r.rand(b, s) < 0.2] = -100
    assert tce._chunk_size(s, 256) == (256 if s == 512 else 128)

    def ref_loss(x_, w_):
        return jce.fused_linear_cross_entropy_fn(
            x_, w_, jnp.asarray(labels), chunk=256, transpose_w=transpose_w)

    ref, (gx, gw) = jax.value_and_grad(ref_loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    got = tce.fused_linear_cross_entropy_fn(
        tx, tw, torch.from_numpy(labels), chunk=256, transpose_w=transpose_w)
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(ref), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), **TOL)


def test_fused_ce_bf16_inputs_give_f32_logits():
    """bf16 x/w: the loss equals the f32 computation on the same
    (upcast) values — logits are f32, as preferred_element_type gives."""
    r = np.random.RandomState(0)
    x = torch.from_numpy(r.randn(2, 256, 32).astype(np.float32)).bfloat16()
    w = torch.from_numpy(r.randn(64, 32).astype(np.float32)).bfloat16()
    lab = torch.from_numpy(r.randint(0, 64, (2, 256)))
    got = tce.fused_linear_cross_entropy(x, w, lab, next_token=True)
    want = tce.fused_linear_cross_entropy(x.float(), w.float(), lab,
                                          next_token=True)
    assert got.dtype == torch.float32
    assert float(got) == float(want)
    sl = tce.shifted_labels(lab)
    assert bool((sl[:, :-1] == lab[:, 1:]).all()) and \
        bool((sl[:, -1] == -100).all())


# ---------------------------------------------------------------------------
# GPT.loss
# ---------------------------------------------------------------------------
def _jax_model(seed, **kw):
    paddle.seed(seed)
    jnet = jgpt.GPT(jgpt.GPTConfig(**dict(CFG, **kw)))
    state = {k: np.asarray(v._value) for k, v in jnet.state_dict().items()}
    return jnet, state


def _port_model(state, **kw):
    net = tgpt.GPT(tgpt.GPTConfig(**dict(CFG, **kw)), device="cpu")
    tgpt.load_reference_state(net, state)
    return net


@pytest.mark.parametrize("tied", [True, False])
def test_gpt_loss_and_every_gradient_match_reference(tied):
    jnet, state = _jax_model(1, tie_word_embeddings=tied,
                             initializer_range=0.1)
    toks = np.random.RandomState(2).randint(0, 128, (2, 128)).astype(
        np.int32)
    jloss = jnet.loss(paddle.to_tensor(toks))
    jloss.backward()
    jgrads = {n: np.asarray(p.grad._value)
              for n, p in jnet.named_parameters()}
    net = _port_model(state, tie_word_embeddings=tied, initializer_range=0.1)
    loss = net.loss(torch.from_numpy(toks))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss._value),
                               rtol=1e-5, atol=1e-5)
    grads = {n: p.grad.numpy() for n, p in net.named_parameters()}
    assert set(grads) == set(jgrads)
    for n, g in grads.items():
        np.testing.assert_allclose(g, jgrads[n], rtol=1e-4, atol=1e-4,
                                   err_msg=n)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
STEPS = 3


def _sched(pkg, peak):
    return pkg.LinearWarmup(pkg.CosineAnnealingDecay(peak, T_max=1000),
                            warmup_steps=20, start_lr=1e-6, end_lr=peak)


def _tokens(seed=3):
    return np.random.RandomState(seed).randint(0, 128, (4, 128)).astype(
        np.int32)


_JAX_RUNS = {}


def _moments(opt, net):
    """The optimizer's accumulators by parameter name, f32 numpy (either
    package: both key them by ``id`` of the parameter)."""
    return {n: {k: np.asarray(v.float() if torch.is_tensor(v) else v,
                              np.float32)
                for k, v in opt._accumulators[id(p)].items()}
            for n, p in net.named_parameters()}


def _jax_train(amp, recompute, bf16, peak):
    key = (amp, recompute, bf16, peak)
    if key not in _JAX_RUNS:
        jnet, state0 = _jax_model(5)
        sched = _sched(jlr, peak)
        opt = paddle.optimizer.AdamW(
            sched, parameters=jnet.parameters(), weight_decay=0.1,
            grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
        s = JStrategy()
        s.amp, s.recompute = amp, recompute
        mesh = build_mesh_from_strategy(s, jax.devices()[:1])
        kw = dict(param_dtype="bfloat16", moment_dtype="bfloat16") \
            if bf16 else {}
        tr = JTrainer(jnet, opt, s, mesh, n_micro=2, **kw)
        losses = []
        for _ in range(STEPS):
            losses.append(float(tr.step(_tokens())))
            sched.step()
        jnet = tr.sync_to_layer()
        final = {k: np.asarray(v._value, np.float32)
                 for k, v in jnet.state_dict().items()}
        _JAX_RUNS[key] = (state0, losses, final, _moments(opt, jnet))
    return _JAX_RUNS[key]


def _port_train(state0, amp, recompute, bf16, peak, block_hook=None):
    net = _port_model(state0)
    if block_hook is not None:
        net.blocks[0].register_forward_hook(block_hook)
    sched = _sched(tlr, peak)
    opt = AdamW(sched, parameters=net.named_parameters(), weight_decay=0.1,
                grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    s = DistributedStrategy()
    s.amp, s.recompute = amp, recompute
    kw = dict(param_dtype="bfloat16", moment_dtype="bfloat16") \
        if bf16 else {}
    tr = HybridPipelineTrainer(net, opt, s, n_micro=2, **kw)
    losses = []
    for _ in range(STEPS):
        loss = tr.step(torch.from_numpy(_tokens()))
        assert loss.dtype == torch.float32 and loss.dim() == 0
        losses.append(float(loss))
        sched.step()
    return losses, tgpt.state_to_numpy(tr.sync_to_layer()), opt, net


@pytest.mark.parametrize("recompute,peak", [(True, 2e-4), (True, 2e-2),
                                            (False, 2e-2)])
def test_trainer_f32_matches_reference(recompute, peak):
    """The recipe's schedule (peak 2e-4), and the same schedule at 2e-2,
    where three steps move the parameters far past the tolerance."""
    state0, jlosses, jfinal, _ = _jax_train(False, recompute, False, peak)
    losses, final, _, _ = _port_train(state0, False, recompute, False, peak)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=0)
    moved = max(float(np.abs(jfinal[n] - state0[n]).max()) for n in state0)
    assert moved > (1e-3 if peak > 1e-3 else 1e-5)
    for n, v in final.items():
        np.testing.assert_allclose(v, jfinal[n], rtol=0, atol=1e-4,
                                   err_msg=n)


def test_trainer_amp_bf16_state_matches_reference():
    """amp on, bf16 parameters and moments, recompute on, at peak 2e-2,
    where three steps move the weights by tens of bf16 ulps. The JAX
    trainer runs bf16 through its interpret-mode flash kernel on the
    CPU, so this case keeps S 128 and both packages take the flash path.

    The packages round their bf16 products in different orders, so their
    gradients differ by a few bf16 ulps. Adam divides each gradient
    element by its own root mean square, so an element whose gradient is
    rounding noise steps by about +-lr with a sign each package picks on
    its own (the key bias's gradient is zero in exact arithmetic:
    softmax does not see a shift of its logits). So parameters are held
    to one bf16 ulp on most elements, not all: at least 85% of all
    elements and 80% of each weight matrix's (measured 91% and 88%; a
    skipped update or moments that are not written back leave about 1%).
    The moments, which are not normalised, are held at 5e-2 of each
    tensor's largest value (measured at most 2.4e-2). Losses at atol
    5e-4 (measured 7e-5; dropping the moments moves step 3's by 3e-2)."""
    state0, jlosses, jfinal, jmom = _jax_train(True, True, True, 2e-2)
    dtypes = set()
    losses, final, opt, net = _port_train(
        state0, True, True, True, 2e-2,
        block_hook=lambda m, i, o: dtypes.add(o.dtype))
    assert dtypes == {torch.bfloat16}               # the forward is bf16
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=5e-4)
    ulp = 2.0 ** -7                                 # relative, 8 bits
    mats = [n for n, v in state0.items() if v.ndim == 2]
    moved = np.concatenate([
        (np.abs(jfinal[n] - state0[n]) / (ulp * np.abs(jfinal[n]))).ravel()
        for n in mats])
    assert np.median(moved) > 8                     # measured about 25
    within = {n: np.abs(v - jfinal[n]) <= ulp * np.abs(jfinal[n]) + 1e-6
              for n, v in final.items()}
    share = np.mean(np.concatenate([w.ravel() for w in within.values()]))
    assert share >= 0.85, share
    for n in mats:
        assert within[n].mean() >= 0.8, (n, within[n].mean())
    for st in opt._accumulators.values():
        assert all(v.dtype == torch.bfloat16 for v in st.values())
    for n, st in _moments(opt, net).items():
        for k, v in st.items():
            ref = jmom[n][k]
            np.testing.assert_allclose(v, ref, rtol=0,
                                       atol=5e-2 * np.abs(ref).max(),
                                       err_msg=f"{n} {k}")


def test_eager_loop_matches_trainer():
    """``loss.backward(); opt.step(); opt.clear_grad()`` on the whole
    batch equals the trainer's micro-batched step (amp off)."""
    state0, _, _, _ = _jax_train(False, True, False, 2e-2)
    losses, final, _, _ = _port_train(state0, False, True, False, 2e-2)
    net = _port_model(state0)
    sched = _sched(tlr, 2e-2)
    opt = AdamW(sched, parameters=net.named_parameters(), weight_decay=0.1,
                grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    eager = []
    for _ in range(STEPS):
        loss = net.loss(torch.from_numpy(_tokens()))
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        eager.append(float(loss.detach()))
    np.testing.assert_allclose(eager, losses, rtol=1e-5, atol=0)
    for n, v in tgpt.state_to_numpy(net).items():
        np.testing.assert_allclose(v, final[n], rtol=0, atol=1e-5, err_msg=n)


def test_trainer_refuses_what_it_does_not_run():
    net = tgpt.GPT(tgpt.GPTConfig(**CFG), device="cpu")
    opt = AdamW(1e-3, parameters=net.named_parameters())
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        HybridPipelineTrainer(net, opt, guard_bad_steps=True)
    # the offload knobs and int8 gradients run since item 7d
    # (tests/test_torch_stream_layers.py, tests/test_torch_qcomm.py); what
    # the reference refuses of them, the port refuses with its errors
    for kw, match in ((dict(offload_params=True), "requires strategy.amp"),
                      (dict(stream_layers=True), "requires offload")):
        with pytest.raises(ValueError, match=match):
            HybridPipelineTrainer(net, opt, **kw)
    assert HybridPipelineTrainer(net, opt,
                                 dp_grad_comm="int8").dp_grad_comm == "int8"
    # pp, sp, ep and v_virtual run (ROADMAP queue 1 item 7c); a virtual
    # degree that does not divide the blocks is the reference's error
    with pytest.raises(ValueError, match="divisible by pp_degree"):
        HybridPipelineTrainer(net, opt, v_virtual=3)
    # planning runs since item 7e (tests/test_torch_plan.py): the three
    # calls give the reference's memory_analysis keys
    keys = {"argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes", "peak_bytes_est"}
    planner = HybridPipelineTrainer(net, opt)
    tok = torch.from_numpy(_tokens())
    assert planner.aot_lower(tok).as_text().startswith("# planned")
    assert keys <= set(planner.aot_compile(tok).memory_analysis())
    assert keys <= set(planner.memory_analysis(tok))
    tr = HybridPipelineTrainer(net, opt, n_micro=3, free_eager=True)
    with pytest.raises(ValueError, match="n_micro"):
        tr.step(torch.from_numpy(_tokens()))
    assert tr.sync_to_layer() is net


def test_trainer_profiler_counters():
    from paddle_tpu_torch import profiler

    net = tgpt.GPT(tgpt.GPTConfig(**dict(CFG, num_layers=1)), device="cpu")
    opt = AdamW(1e-3, parameters=net.named_parameters())
    tr = HybridPipelineTrainer(net, opt, n_micro=2)
    reg = profiler.registry()
    steps0 = reg.counter("train/steps").value
    tokens0 = reg.counter("train/tokens").value
    tr.step(torch.from_numpy(_tokens()))            # profiler off
    assert reg.counter("train/steps").value == steps0
    profiler.enable()
    try:
        tr.step(torch.from_numpy(_tokens()))
    finally:
        profiler.disable()
    assert reg.counter("train/steps").value == steps0 + 1
    assert reg.counter("train/tokens").value == tokens0 + 4 * 128
    assert reg.histogram("hybrid/step_ms").count >= 1


# ---------------------------------------------------------------------------
# optimizer, clips, schedules
# ---------------------------------------------------------------------------
def _param_sets(seed):
    r = np.random.RandomState(seed)
    shapes = {"a.weight": (4, 3), "a.bias": (3,), "b.weight": (5,)}
    vals = {n: r.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: (r.randn(*s) * 3).astype(np.float32)
              for n, s in shapes.items()} for _ in range(4)]
    return vals, grads


def test_adamw_decay_fun_and_lr_ratio_match_reference():
    vals, grads = _param_sets(0)
    decay = lambda name: not name.endswith("bias")   # noqa: E731
    ratio = {"a.weight": 1.0, "a.bias": 0.5, "b.weight": 2.0}
    jps = []
    for n, v in vals.items():
        p = paddle.create_parameter(list(v.shape), "float32")
        p._value = jnp.asarray(v)
        p.name = n
        p.optimize_attr["learning_rate"] = ratio[n]
        jps.append(p)
    jopt = paddle.optimizer.AdamW(0.01, parameters=jps, weight_decay=0.3,
                                  apply_decay_param_fun=decay)
    tps = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
           for n, v in vals.items()}
    by_id = {id(p): n for n, p in tps.items()}
    topt = AdamW(0.01, parameters=list(tps.items()), weight_decay=0.3,
                 apply_decay_param_fun=decay,
                 lr_ratio=lambda p: ratio[by_id[id(p)]])
    for g in grads:
        for p in jps:
            p.grad = paddle.to_tensor(g[p.name])
        jopt.step()
        jopt.clear_grad()
        for n, p in tps.items():
            p.grad = torch.from_numpy(g[n])
        topt.step()
        topt.clear_grad()
    for p in jps:
        np.testing.assert_allclose(tps[p.name].detach().numpy(),
                                   np.asarray(p._value), rtol=1e-6,
                                   atol=1e-6, err_msg=p.name)
    sd = topt.state_dict()
    assert sd["global_step"] == 4 and "a.bias_moment1" in sd
    with pytest.raises(ValueError, match="named_parameters"):
        AdamW(0.01, parameters=list(tps.values()),
              apply_decay_param_fun=decay)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["global", "norm", "value"])
def test_clips_match_reference(kind, dtype):
    """f32 gradients at 1e-6; bf16 gradients bit for bit, and (for the
    scaling clips) equal to one rounding of the f32 product,
    ``(g.float() * scale).to(bf16)``, as the reference's
    ``(g * scale).astype(g.dtype)``."""
    from paddle_tpu.optimizer.clip import apply_grad_clip as japply
    from paddle_tpu_torch.optimizer.clip import apply_grad_clip

    _, grads = _param_sets(1)
    g = grads[0]
    tdt = getattr(torch, dtype)
    if dtype == "bfloat16":     # the same bf16 values on both sides
        g = {n: torch.from_numpy(v).to(tdt).float().numpy()
             for n, v in g.items()}
    make = {"global": lambda m: m.ClipGradByGlobalNorm(1.0),
            "norm": lambda m: m.ClipGradByNorm(2.0),
            "value": lambda m: m.ClipGradByValue(1.5, -0.5)}[kind]
    jps = []
    for n, v in g.items():
        p = paddle.create_parameter(list(v.shape), "float32")
        p.grad = paddle.to_tensor(v, dtype=dtype)
        jps.append(p)
    japply(make(paddle.nn), jps)
    tps = []
    for v in g.values():
        p = torch.nn.Parameter(torch.zeros(v.shape, dtype=tdt))
        p.grad = torch.from_numpy(v.copy()).to(tdt)
        tps.append(p)
    apply_grad_clip(make(tnn), tps)
    for jp, tp in zip(jps, tps):
        assert tp.grad.dtype == tdt
        ref = np.asarray(jp.grad._value).astype(np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(tp.grad.numpy(), ref, rtol=1e-6,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(tp.grad.float().numpy(), ref)
    if dtype == "bfloat16" and kind != "value":
        gs = [torch.from_numpy(v) for v in g.values()]
        if kind == "global":
            n = torch.sqrt(sum(x.square().sum() for x in gs))
            scales = [torch.clamp(1.0 / torch.clamp(n, min=1e-12),
                                  max=1.0)] * len(gs)
        else:
            scales = [torch.clamp(2.0 / torch.clamp(
                torch.linalg.vector_norm(x), min=1e-12), max=1.0)
                for x in gs]
        assert max(float(sc) for sc in scales) < 1.0    # the clip is active
        for x, sc, tp in zip(gs, scales, tps):
            torch.testing.assert_close(tp.grad, (x * sc).to(tdt), rtol=0,
                                       atol=0)


def test_recipe_schedule_matches_reference_over_30_steps():
    js, ts = _sched(jlr, 2e-4), _sched(tlr, 2e-4)
    for _ in range(30):
        assert ts() == js()
        js.step()
        ts.step()
    names = [n for n in dir(jlr) if n[0].isupper()]
    assert len(names) == 15                  # LRScheduler and 14 schedules
    assert all(hasattr(tlr, n) for n in names)
