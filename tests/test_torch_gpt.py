"""paddle_tpu_torch.models.gpt held against the JAX package, plus the
port's structural rules.

Weights come from the reference model (``state_dict`` -> numpy ->
``load_reference_state``); inputs are made with numpy from a seed. The
logits of ``GPT.forward`` and of ``gpt_ragged_apply`` must agree with
the reference's at atol = 1e-4 (f32 on both sides, different reduction
orders over 4 layers).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.models import gpt as tgpt

TOL = dict(rtol=1e-4, atol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(seed=0, max_seq_len=64):
    """gpt_tiny widths; initializer_range 0.2 keeps the logits varied."""
    kw = dict(vocab_size=128, hidden_size=64, num_layers=4, num_heads=4,
              max_seq_len=max_seq_len, initializer_range=0.2)
    paddle.seed(seed)
    jnet = jgpt.GPT(jgpt.GPTConfig(**kw))
    jnet.eval()
    net = tgpt.GPT(tgpt.GPTConfig(**kw), device="cpu")
    net.eval()
    tgpt.load_reference_state(
        net, {k: np.asarray(v._value) for k, v in jnet.state_dict().items()})
    return jnet, net


@pytest.mark.parametrize("seq,max_seq", [(64, 64), (128, 128)])
def test_forward_logits_match_reference(seq, max_seq):
    """seq 64 runs the plain attention path, seq 128 the flash entry (its
    plain version on the CPU) — in both packages."""
    jnet, net = _pair(max_seq_len=max_seq)
    toks = np.random.RandomState(1).randint(0, 128, (2, seq)).astype(
        np.int32)
    ref = np.asarray(jnet(paddle.to_tensor(toks))._value)
    with torch.inference_mode():
        got = net(torch.from_numpy(toks).long()).numpy()
    assert got.shape == (2, seq, 128)
    np.testing.assert_allclose(got, ref, **TOL)


def _ragged_inputs():
    """A mixed tick over scrambled pages: 3 decode rows (one inactive),
    one chunk row mid-prompt and one pad chunk row."""
    r = np.random.RandomState(2)
    ns, w, ps, nps, npages = 3, 8, 8, 8, 40
    perm = r.permutation(np.arange(1, npages)).astype(np.int32)
    tab = np.zeros((ns + 2, nps), np.int32)
    tab[0, :3] = perm[0:3]            # slot 0: 20 tokens resident
    tab[1, :1] = perm[3:4]            # slot 1: 5 tokens resident
    tab[3, :2] = perm[4:6]            # chunk row: prompt of 16, start 8
    tokens = r.randint(0, 128, ns + 2 * w).astype(np.int32)
    tok_pos = np.zeros(ns + 2 * w, np.int32)
    tok_limit = np.zeros(ns + 2 * w, np.int32)
    tok_pos[:ns] = [20, 5, 0]
    tok_limit[:ns] = nps * ps
    tok_pos[ns:ns + w] = 8 + np.arange(w)
    tok_limit[ns:ns + w] = 16
    row_pos0 = np.array([20, 5, 0, 8, 0], np.int32)
    row_len = np.array([1, 1, 1, 8, 1], np.int32)
    sample_ix = np.array([0, 1, ns + 7, ns + 3], np.int32)
    return dict(ns=ns, w=w, ps=ps, npages=npages, tokens=tokens,
                tok_pos=tok_pos, tok_limit=tok_limit, tab=tab,
                row_pos0=row_pos0, row_len=row_len, sample_ix=sample_ix)


def test_ragged_apply_logits_and_pools_match_reference():
    jnet, net = _pair(seed=3)
    d = _ragged_inputs()
    cfg = jnet.config
    L, nh = cfg.num_layers, cfg.num_heads
    shape = (L, d["npages"], d["ps"], nh, cfg.hidden_size // nh)
    r = np.random.RandomState(4)
    k0 = r.randn(*shape).astype(np.float32)
    v0 = r.randn(*shape).astype(np.float32)
    stacked, other = jnet._decode_state()
    names = ("tokens", "tok_pos", "tok_limit", "tab", "row_pos0",
             "row_len", "sample_ix")
    ref, kref, vref = jgpt.gpt_ragged_apply(
        cfg, stacked, other, jnp.asarray(k0), jnp.asarray(v0),
        *(jnp.asarray(d[n]) for n in names),
        decode_rows=d["ns"], chunk_width=d["w"])
    tstacked, tother = net._decode_state()
    kp, vp = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    with torch.inference_mode():
        got, kout, vout = tgpt.gpt_ragged_apply(
            net.config, tstacked, tother, kp, vp,
            *(torch.from_numpy(d[n]) for n in names),
            decode_rows=d["ns"], chunk_width=d["w"])
    assert kout is kp and vout is vp          # updated in place
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # written pages agree (the null page collects pad writes in an
    # unspecified order and is excluded)
    np.testing.assert_allclose(kp.numpy()[:, 1:], np.asarray(kref)[:, 1:],
                               **TOL)
    np.testing.assert_allclose(vp.numpy()[:, 1:], np.asarray(vref)[:, 1:],
                               **TOL)


def test_load_reference_state_rejects_missing_extra_and_misshaped():
    jnet, net = _pair()
    state = {k: np.asarray(v._value) for k, v in jnet.state_dict().items()}
    bad = dict(state)
    bad.pop("ln_f.bias")
    with pytest.raises(KeyError, match="ln_f.bias"):
        tgpt.load_reference_state(net, bad)
    bad = dict(state, **{"lm_head.weight": np.zeros((64, 128), np.float32)})
    with pytest.raises(KeyError, match="lm_head.weight"):
        tgpt.load_reference_state(net, bad)
    bad = dict(state)
    bad["blocks.0.attn.qkv_proj.weight"] = np.zeros((192, 64), np.float32)
    with pytest.raises(ValueError, match="qkv_proj"):
        tgpt.load_reference_state(net, bad)


def test_state_to_numpy_inverts_load_reference_state():
    jnet, net = _pair()
    state = {k: np.asarray(v._value) for k, v in jnet.state_dict().items()}
    back = tgpt.state_to_numpy(net)
    assert set(back) == set(state)
    for k, v in back.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, state[k])


def test_loss_is_the_pipeline_protocol_composed():
    """GPT.loss == pipeline_head(blocks(pipeline_stem(tokens))), and the
    label count is the shifted objective's."""
    _, net = _pair(max_seq_len=128)
    toks = torch.from_numpy(np.random.RandomState(4).randint(0, 128, (2, 128)))
    with torch.no_grad():
        x = net.pipeline_stem(toks)
        for blk in net.pipeline_blocks():
            x = blk(x)
        via_protocol = net.pipeline_head(x, toks)
        direct = net.loss(toks)
    assert float(direct) == float(via_protocol)
    assert net.pipeline_label_count(toks) == 2 * 127


def test_parameter_names_and_layouts_equal_reference():
    jnet, net = _pair()
    ref = {k: tuple(v.shape) for k, v in jnet.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert got == ref


def test_presets_match_reference():
    for name in ("gpt3_125m", "gpt3_350m", "gpt3_1_3b", "gpt3_2_7b",
                 "gpt3_6_7b", "gpt3_13b"):
        a = getattr(jgpt.GPTConfig, name)()
        b = getattr(tgpt.GPTConfig, name)()
        assert vars(a) == vars(b), name
        assert a.num_params() == b.num_params()


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgpt.gpt_tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgpt.GPT(tgpt.GPTConfig(vocab_size=16, hidden_size=8, num_layers=1,
                                num_heads=2, max_seq_len=8))
    assert tgpt.gpt_tiny(device="cpu").device.type == "cpu"


def test_moe_config_raises_not_implemented():
    """A MoE GPT builds and trains (its loss adds the aux); its decode
    raises, as the reference's does (``models/gpt.py:785-788``)."""
    net = tgpt.gpt_tiny(device="cpu", moe_num_experts=2)
    assert type(net.blocks[0].mlp).__name__ == "MoEMLP"
    with pytest.raises(NotImplementedError, match="MoE decode"):
        net.generate(np.zeros((1, 4), np.int64), max_new_tokens=2)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of paddle_tpu_torch — the training slice's fused_ce,
    optimizer, distributed.hybrid and distributed.fleet, the int8
    slice's ops.int8_matmul and quantization and the profiler's trace,
    events, sink, recompile and disttrace and the serving engine, page
    cache and scheduler (legacy mode, handoff, chains), the BERT and
    ERNIE models, and the vision slice's nn (conv, pooling, norms,
    losses, initializers), io, metric, vision (models and datasets) and
    quantization among them — and
    chip_smoke.py load in a fresh interpreter without pulling in jax or
    paddle_tpu."""
    code = (
        "import importlib, pkgutil, sys, runpy\n"
        "import paddle_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'paddle_tpu_torch.')]\n"
        "need = {'paddle_tpu_torch.ops.fused_ce', "
        "'paddle_tpu_torch.models.bert', 'paddle_tpu_torch.models.ernie', "
        "'paddle_tpu_torch.optimizer', 'paddle_tpu_torch.optimizer.lr', "
        "'paddle_tpu_torch.optimizer.clip', "
        "'paddle_tpu_torch.distributed.hybrid', "
        "'paddle_tpu_torch.distributed.fleet', "
        "'paddle_tpu_torch.ops.int8_matmul', "
        "'paddle_tpu_torch.quantization', "
        "'paddle_tpu_torch.profiler.trace', "
        "'paddle_tpu_torch.profiler.events', "
        "'paddle_tpu_torch.profiler.sink', "
        "'paddle_tpu_torch.profiler.recompile', "
        "'paddle_tpu_torch.profiler.disttrace', "
        "'paddle_tpu_torch.profiler.device_trace', "
        "'paddle_tpu_torch.profiler.program_stats', "
        "'paddle_tpu_torch.profiler.instrument', "
        "'paddle_tpu_torch.serving.engine', "
        "'paddle_tpu_torch.serving.paged_cache', "
        "'paddle_tpu_torch.serving.sched', "
        "'paddle_tpu_torch.nn', 'paddle_tpu_torch.nn.layer.conv', "
        "'paddle_tpu_torch.nn.functional.pooling', "
        "'paddle_tpu_torch.nn.functional.norm', "
        "'paddle_tpu_torch.nn.functional.loss', "
        "'paddle_tpu_torch.nn.initializer', 'paddle_tpu_torch.io', "
        "'paddle_tpu_torch.metric', 'paddle_tpu_torch.vision', "
        "'paddle_tpu_torch.vision.models.resnet', "
        "'paddle_tpu_torch.vision.datasets'}\n"
        "assert need <= set(mods), sorted(need - set(mods))\n"
        "for m in mods: importlib.import_module(m)\n"
        "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'paddle_tpu' or "
        "m.startswith('paddle_tpu.'))\n"
        "assert len(mods) > 15, mods\n"
        "print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
