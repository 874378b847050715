"""The port's ``LazyGuard`` (``paddle_tpu_torch/framework/lazy.py``) and the
abstract hybrid trainer, held to the JAX package's
(``tests/test_lazy_init.py``): parameters made under the guard hold no
bytes, ``materialize`` makes them real (bit-equal to an eager build
under the same seed), the guard is scoped, and a trainer over an
abstract model plans on a planning world (``env.plan_world``) without
allocating and refuses to step. The planned per-rank shapes and
optimizer-state bytes equal the reference abstract trainer's
(``sharding.shard_shape`` of its ``ShapeDtypeStruct``s on 4 of the
conftest's CPU devices)."""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.distributed.fleet.distributed_strategy import \
    DistributedStrategy as JStrategy
from paddle_tpu.distributed.hybrid import HybridPipelineTrainer as JTrainer
from paddle_tpu.distributed.strategy_compiler import \
    build_mesh_from_strategy as jmesh
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed import mesh as M
from paddle_tpu_torch.distributed.env import plan_world
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.distributed.hybrid import HybridPipelineTrainer
from paddle_tpu_torch.framework.lazy import (LazyGuard, in_lazy_mode,
                                             is_abstract, materialize)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.optimizer import AdamW

TINY = dict(vocab_size=128, hidden_size=64, num_layers=4, num_heads=4,
            max_seq_len=64)


def _strategy(cls, dp, tp, pp, zero=0):
    s = cls()
    s.amp = True
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": tp, "pp_degree": pp}
    if zero:
        s.sharding = True
        s.sharding_configs = {"sharding_stage": zero}
    return s


def _port_trainer(dp, tp, pp, zero=0, **kw):
    """An abstract port trainer over gpt_tiny at the mesh (dp, pp, tp) of
    the current planning world."""
    M.init_mesh({"dp": dp, "pp": pp, "tp": tp, "sp": 1})
    with LazyGuard():
        model = tgpt.GPT(tgpt.GPTConfig(**TINY), device="cpu")
    opt = AdamW(1e-4, parameters=model.named_parameters())
    return HybridPipelineTrainer(model, opt, _strategy(
        DistributedStrategy, dp, tp, pp, zero), M.get_mesh(), n_micro=2,
        **kw)


def _ref_trainer(dp, tp, pp, zero=0):
    s = _strategy(JStrategy, dp, tp, pp, zero)
    with paddle.LazyGuard():
        model = jgpt.GPT(jgpt.GPTConfig(**TINY))
    opt = paddle.optimizer.AdamW(1e-4, parameters=model.parameters())
    mesh = jmesh(s, np.array(jax.devices()[:dp * tp * pp]))
    return JTrainer(model, opt, s, mesh=mesh, n_micro=2)


def _shard_bytes(sds) -> int:
    return int(np.prod(sds.sharding.shard_shape(sds.shape))) * \
        np.dtype(sds.dtype).itemsize


def test_lazy_params_are_abstract_and_materialize():
    with LazyGuard():
        net = tnn.Linear(8, 4, device="cpu")
    assert is_abstract(net.weight) and is_abstract(net.bias)
    assert tuple(net.weight.shape) == (8, 4)
    assert net.weight.is_meta          # shapes and dtypes, no bytes
    materialize(net)
    assert not is_abstract(net.weight)
    out = net(torch.ones(2, 8))
    assert out.shape == (2, 4)
    assert torch.isfinite(out).all()


def test_lazy_guard_scoped_and_nested():
    with LazyGuard():
        with LazyGuard():
            a = tnn.Linear(4, 4, device="cpu")
        b = tnn.LayerNorm(4, device="cpu")
        assert in_lazy_mode()
    c = tnn.Linear(4, 4, device="cpu")
    assert not in_lazy_mode()
    assert is_abstract(a.weight) and is_abstract(b.weight)
    assert not is_abstract(c.weight)


def test_materialized_gpt_equals_eager_bitwise():
    """Under the same seed a materialized lazy GPT (tp 1, MoE included)
    equals an eagerly built one, bit for bit: the initializers draw in
    the order of creation."""
    for extra in ({}, {"moe_num_experts": 4, "moe_top_k": 2}):
        cfg = tgpt.GPTConfig(**TINY, **extra)
        pt.seed(11)
        eager = tgpt.GPT(cfg, device="cpu")
        pt.seed(11)
        with LazyGuard():
            lazy = tgpt.GPT(cfg, device="cpu")
        assert all(is_abstract(p) for p in lazy.parameters())
        materialize(lazy)
        want, got = eager.state_dict(), lazy.state_dict()
        assert list(got) == list(want)
        for n in want:
            assert torch.equal(got[n], want[n]), n
        assert lazy.embeddings.wte.weight.data_ptr() != 0


def test_abstract_model_refuses_reference_state():
    with LazyGuard():
        net = tgpt.GPT(tgpt.GPTConfig(**TINY), device="cpu")
    with pytest.raises(ValueError, match="LazyGuard"):
        tgpt.load_reference_state(net, {})


def test_gpt3_13b_abstract_matches_reference_names_shapes_dtypes():
    """GPT-3 13B (V 50304, h 5120, 40 layers, 40 heads, S 2048) under both
    packages' guards: the same parameter names, shapes and dtypes, and no
    bytes on either side (the JAX side's values are ShapeDtypeStructs;
    the port names the card, which this host does not need)."""
    with paddle.LazyGuard():
        ref = jgpt.GPT(jgpt.GPTConfig.gpt3_13b())
    with LazyGuard():
        port = tgpt.GPT(tgpt.GPTConfig.gpt3_13b())
    want = {n: p._value for n, p in ref.named_parameters()}
    got = dict(port.named_parameters())
    assert list(got) == list(want)
    for n, sds in want.items():
        assert isinstance(sds, jax.ShapeDtypeStruct), n
        p = got[n]
        assert p.is_meta, n
        assert tuple(p.shape) == tuple(sds.shape), n
        assert str(p.dtype).replace("torch.", "") == str(sds.dtype), n
        assert p._lazy[2].type == "cuda", n
    assert sum(p.numel() for p in got.values()) == \
        tgpt.GPTConfig.gpt3_13b().num_params()


def test_abstract_trainer_plans_without_allocating():
    """dp 2, mp 2, pp 2 on a planning world of 8 (the reference's
    test_abstract_trainer_plans_without_allocating): every piece of state
    is a fake, the plan's peak is positive and ``step`` refuses."""
    with plan_world(8, 0):
        tr = _port_trainer(2, 2, 2, param_dtype="bfloat16")
        assert tr.abstract
        state = list(tr._upd.params) + [v for st in tr._upd.states
                                        for v in st.values()]
        assert state and all(is_abstract(t) for t in state)
        assert all(is_abstract(p) for p in tr.model.parameters())
        ma = tr.memory_analysis(torch.empty(4, 64, dtype=torch.int64,
                                            device="meta"))
        assert ma and ma.get("peak_bytes_est", 0) > 0
        with pytest.raises(RuntimeError, match="LazyGuard"):
            tr.step(np.zeros((4, 64), np.int64))
        materialize(tr.model)
        assert not any(is_abstract(p) for p in tr.model.parameters())
        assert dict(tr.model.named_parameters())[
            "blocks.0.attn.qkv_proj.weight"].shape == (64, 96)


def test_planned_shapes_equal_reference_shard_shapes():
    """gpt_tiny at tp 2 x pp 2: each rank's planned parameters have the
    reference abstract trainer's shard shapes (a stage's blocks: its lps
    layers of the stacked [pp, lps, ...] shard)."""
    ref = _ref_trainer(1, 2, 2)
    for rank in range(4):
        with plan_world(4, rank):
            tr = _port_trainer(1, 2, 2)
            held = dict(zip(tr._names, tr._upd.params))
            stage = tr.stage
            for sfx, sds in ref.block_vals.items():
                shard = sds.sharding.shard_shape(sds.shape)
                assert shard[:2] == (1, tr.lps), sfx
                layers = [l for c in tr.circuits for l in c]
                for l in layers:
                    p = held[f"blocks.{l}.{sfx}"]
                    assert tuple(p.shape) == tuple(shard[2:]), (sfx, l)
                assert all(l // tr.lps == stage for l in layers)
            for n, sds in zip(ref.other_names, ref.other_vals):
                assert tuple(held[n].shape) == \
                    tuple(sds.sharding.shard_shape(sds.shape)), n


@pytest.mark.parametrize("zero", [1, 2])
def test_planned_optimizer_bytes_equal_reference(zero):
    """ZeRO 1 and 2 at dp 2 x tp 2: the planned optimizer state of each
    rank holds as many bytes as the reference's shard of it, and the
    plan's arguments are the ledger's state."""
    ref = _ref_trainer(2, 2, 1, zero)
    want = sum(_shard_bytes(v) for d in ref.block_opt.values()
               for v in d.values()) + \
        sum(_shard_bytes(v) for d in ref.other_opt for v in d.values())
    for rank in range(4):
        with plan_world(4, rank):
            tr = _port_trainer(2, 2, 1, zero)
            assert not tr.zero_manual
            led = tr.memory_ledger()
            assert led["opt_state"] == want, (rank, led, want)
            ma = tr.memory_analysis(torch.empty(4, 64, dtype=torch.int64,
                                                device="meta"))
            assert ma["argument_size_in_bytes"] == led["param"] + \
                led["opt_state"]
