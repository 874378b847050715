"""The pure parts of the port's strategy compiler and data-parallel
update (``distributed/strategy_compiler.py``, ``distributed/qcomm.py``)
held to the JAX package's functions case by case, on one process:

- ``build_mesh_from_strategy``'s axes (dp auto from the world size);
- ``_spec_axes``, ``_add_axis``, ``_local_check_shape`` and
  ``resolve_param_specs`` on gpt_tiny, ZeRO 0 and 3 (the reference's
  ``tests/test_distributed.py:40-70`` cases and more);
- ``make_param_update`` / ``make_flat_update`` (AdamW, Adam with L2
  decay, per-element knobs) against the reference's at rtol 1e-6, and
  the flat update's slice invariance, bit for bit (the mechanism of the
  flat slab, ``tests/test_zero_shard.py:132-162``);
- ``_flat_knob``, ``zero_chunk_len``, ``dp_batch_specs``;
- the validation errors (int8 with ZeRO 3, ``dp_param_comm`` without the
  sharded update, a per-leaf clip under the slab route) with the
  reference's messages; the int8 spellings run at degree 1 (the ring
  against the reference: ``tests/test_torch_qcomm.py``).
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed import qcomm as jq
from paddle_tpu.distributed import strategy_compiler as jsc
from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy
from paddle_tpu.distributed.mesh import create_mesh as jcreate_mesh
from paddle_tpu.models import gpt_tiny as jgpt_tiny
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed import qcomm as tq
from paddle_tpu_torch.distributed import strategy_compiler as tsc
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.distributed.mesh import P as TP
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.optimizer import clip as tclip


def _spec(p):
    """A PartitionSpec of either package as a plain tuple."""
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in p)


@pytest.mark.parametrize("hybrid", [{}, {"mp_degree": 2},
                                    {"mp_degree": 2, "dp_degree": 4},
                                    {"mp_degree": 4}, {"sp_degree": 2},
                                    {"mp_degree": 2, "ep_degree": 2}])
def test_build_mesh_from_strategy_axes(monkeypatch, hybrid):
    seen = {}
    monkeypatch.setattr(tsc, "create_mesh",
                        lambda axes, devs: seen.update(axes=axes,
                                                       n=len(devs)))
    s, js = DistributedStrategy(), JStrategy()
    s.hybrid_configs = js.hybrid_configs = hybrid
    tsc.build_mesh_from_strategy(s, devices=range(8))
    want = jsc.build_mesh_from_strategy(js, jax.devices()[:8])
    assert seen["axes"] == dict(want.shape) and seen["n"] == 8


ADD_AXIS = [((), 2, (8, 6), "dp", 2), ((None, "tp"), 2, (8, 3), "dp", 2),
            (("tp", None), 2, (4, 6), "dp", 4), ((), 1, (3,), "dp", 2),
            ((None,), 2, (3, 5), "dp", 2), (("dp",), 1, (8,), "dp", 2),
            ((), 2, (8, 6), "dp", 1), ((None, None), 3, (3, 6, 4), "dp", 2),
            (("tp",), 2, (4, 8), "dp", 2)]


@pytest.mark.parametrize("spec,ndim,shape,axis,size", ADD_AXIS)
def test_add_axis_matches_reference(spec, ndim, shape, axis, size):
    from jax.sharding import PartitionSpec as JP

    got = tsc._add_axis(TP(*spec), ndim, shape, axis, size)
    want = jsc._add_axis(JP(*spec), ndim, shape, axis, size)
    assert _spec(got) == _spec(want)
    assert tsc._spec_axes(got) == jsc._spec_axes(want)


def test_local_check_shape_matches_reference():
    from jax.sharding import PartitionSpec as JP

    mesh = types.SimpleNamespace(shape={"dp": 2, "tp": 4},
                                 axis_names=("dp", "tp"))
    for spec, shape in (((None, "tp"), (8, 16)), ((("dp", "tp"),), (16,)),
                        (("tp", "dp"), (8, 8)), ((), (5,))):
        assert tsc._local_check_shape(shape, TP(*spec), mesh) == \
            jsc._local_check_shape(shape, JP(*spec), mesh)


@pytest.mark.parametrize("axes,zero", [({"dp": 4, "tp": 2}, 0),
                                       ({"dp": 8}, 0),
                                       ({"dp": 4, "tp": 2}, 3),
                                       ({"dp": 8}, 3),
                                       ({"dp": 2, "tp": 4}, 3)])
def test_resolve_param_specs_matches_reference(axes, zero):
    """The reference's TestShardingSpecs cases: the tp specs the layers
    declare (the qkv projection's spelled as the reference spells it),
    axes the mesh lacks dropped, ZeRO 3's dp on the first divisible dim."""
    paddle.seed(0)
    want = jsc.resolve_param_specs(
        jgpt_tiny(), jcreate_mesh(axes, jax.devices()[:8]), zero_stage=zero)
    mesh = types.SimpleNamespace(shape=dict(axes), axis_names=tuple(axes))
    got = tsc.resolve_param_specs(gpt_tiny(device="cpu"), mesh, zero)
    assert set(got) == set(want)
    for n in want:
        assert _spec(got[n]) == _spec(want[n]), n
    if "tp" in axes:
        assert _spec(got["blocks.0.attn.qkv_proj.weight"])[:2] in \
            ((None, "tp"), ("dp", "tp"))


def _update_pair(opt_kind):
    """(port optimizer, reference optimizer) of one kind."""
    tp_, jp = torch.nn.Parameter(torch.zeros(4)), \
        paddle.create_parameter([4], "float32")
    if opt_kind == "adamw":
        return (AdamW(1e-3, parameters=[tp_], weight_decay=0.01),
                paddle.optimizer.AdamW(1e-3, parameters=[jp],
                                       weight_decay=0.01))
    return (Adam(1e-3, parameters=[tp_], weight_decay=0.01),
            paddle.optimizer.Adam(1e-3, parameters=[jp], weight_decay=0.01))


@pytest.mark.parametrize("kind", ["adamw", "adam_l2"])
@pytest.mark.parametrize("knobs", ["scalar", "vector"])
def test_param_and_flat_update_match_reference(kind, knobs):
    topt, jopt = _update_pair(kind)
    rng = np.random.RandomState(3)
    p, g = (rng.randn(256).astype(np.float32) for _ in range(2))
    plr, wd = ((1.0, 0.01) if knobs == "scalar" else
               (rng.rand(256).astype(np.float32),
                rng.rand(256).astype(np.float32) * 0.1))
    if kind != "adamw":      # Adam's decoupled decay is 0 (its L2 is not)
        wd = wd * 0
    jst = {k: jnp.asarray(rng.rand(256).astype(np.float32))
           for k in ("moment1", "moment2")}
    jp_, js_ = jsc.make_flat_update(jopt)(
        jnp.asarray(p), jnp.asarray(g), jst, jnp.float32(1e-3),
        jnp.int32(2), jnp.asarray(plr), jnp.asarray(wd))
    for upd in (tsc.make_flat_update(topt),
                lambda *a: tsc.make_param_update(topt)(*a[:5], plr=a[5],
                                                       wd=a[6])):
        tp_ = torch.from_numpy(p.copy())
        ts = {k: torch.from_numpy(np.asarray(v).copy())
              for k, v in jst.items()}
        knob = (lambda x: x) if knobs == "scalar" else torch.from_numpy
        got_p, got_s = upd(tp_, torch.from_numpy(g), ts, 1e-3, 2,
                           knob(plr), knob(wd))
        np.testing.assert_allclose(got_p.numpy(), np.asarray(jp_),
                                   rtol=1e-6, atol=1e-7)
        for k in js_:
            np.testing.assert_allclose(got_s[k].numpy(),
                                       np.asarray(js_[k]), rtol=1e-6,
                                       atol=1e-9)


def test_flat_update_slice_invariance():
    """Updating the whole flat slab equals updating each dp rank's chunk
    on its own, bit for bit."""
    topt, _ = _update_pair("adamw")
    upd = tsc.make_flat_update(topt)
    rng = np.random.RandomState(4)
    p, g = (torch.from_numpy(rng.randn(256).astype(np.float32))
            for _ in range(2))
    st = {"moment1": torch.zeros(256), "moment2": torch.zeros(256)}
    full_p, full_s = upd(p.clone(), g, {k: v.clone() for k, v in
                                        st.items()}, 1e-3, 1, 1.0, 0.01)
    for lo in (0, 128):
        hp, hs = upd(p[lo:lo + 128].clone(), g[lo:lo + 128],
                     {k: v[lo:lo + 128].clone() for k, v in st.items()},
                     1e-3, 1, 1.0, 0.01)
        assert torch.equal(hp, full_p[lo:lo + 128])
        for k in hs:
            assert torch.equal(hs[k], full_s[k][lo:lo + 128])


@pytest.mark.parametrize("vals,sizes,pad", [([0.1, 0.1], [3, 5], 12),
                                            ([1.0, 0.5, 1.0], [2, 2, 3], 8),
                                            ([], [], 4)])
def test_flat_knob_matches_reference(vals, sizes, pad):
    got = tsc._flat_knob(vals, sizes, pad)
    want = np.asarray(jsc._flat_knob(vals, sizes, pad))
    np.testing.assert_array_equal(np.asarray(got, np.float32), want)


@pytest.mark.parametrize("total,n,block", [(64, 8, 4), (65, 8, 4),
                                           (1, 8, 2048), (212000, 2, 2048)])
def test_zero_chunk_len_matches_reference(total, n, block):
    assert tq.zero_chunk_len(total, n, block) == \
        jq.zero_chunk_len(total, n, block)


@pytest.mark.parametrize("shapes,dp", [([(8, 4), (8,), (3,)], 2),
                                       ([(6, 4), (6, 4)], 4),
                                       ([(), (8, 2)], 2), ([(4, 4)], 1)])
def test_dp_batch_specs_match_reference(shapes, dp):
    got = tq.dp_batch_specs([torch.zeros(s) for s in shapes], dp)
    want = jq.dp_batch_specs([jnp.zeros(s) for s in shapes], dp)
    assert [_spec(g) for g in got] == [_spec(w) for w in want]


def _message(fn, *a, **k):
    with pytest.raises(Exception) as e:
        fn(*a, **k)
    return type(e.value), str(e.value)


def test_validation_errors_equal_the_reference():
    mesh = types.SimpleNamespace(shape={"dp": 8})
    for args, kw in ((("int8", mesh), dict(zero_stage=3)),
                     (("f16", mesh), {}),
                     (("int8", types.SimpleNamespace(shape={"dp": 2,
                                                            "tp": 2})), {})):
        assert _message(tq.validate_dp_grad_comm, *args, **kw) == \
            _message(jq.validate_dp_grad_comm, *args, **kw)
    for args in (("f16", True), ("bf16", False), ("int8", False)):
        assert _message(tq.validate_dp_param_comm, *args) == \
            _message(jq.validate_dp_param_comm, *args)
    # a per-leaf clip under the slab route (ZeRO 1 on a pure-dp mesh)
    net = jgpt_tiny()
    jopt = paddle.optimizer.AdamW(1e-3, parameters=net.parameters(),
                                  grad_clip=paddle.nn.ClipGradByValue(1.0))
    s = JStrategy()
    s.sharding = True
    s.sharding_configs = {"sharding_stage": 1}
    want = _message(jsc.compile_train_step, net, jopt, s,
                    jsc.build_mesh_from_strategy(s, jax.devices()[:8]))
    topt = AdamW(1e-3, parameters=[torch.nn.Parameter(torch.zeros(2))],
                 grad_clip=tnn.ClipGradByValue(1.0))
    assert _message(tsc._validate_zero_clip, topt, True) == want
    tsc._validate_zero_clip(topt, False)        # the per-parameter route


def test_int8_spellings_name_item_7d():
    """The int8 spellings raised naming item 7d until it was ported; they
    run now (held to the reference in tests/test_torch_qcomm.py): at
    degree 1 the ring is the identity and the knobs validate."""
    mesh = types.SimpleNamespace(shape={"dp": 2})
    tq.validate_dp_grad_comm("int8", mesh)
    tq.validate_dp_param_comm("int8", True)
    q, s = tq.quantize_blockwise(torch.zeros(4), block=4)
    assert q.dtype == torch.int8 and not q.any() and not s.any()
    assert not tq.dequantize_blockwise(q, s, block=4).any()
    x = torch.arange(4.0)
    for fn in (tq.quantized_all_reduce, tq.quantized_reduce_scatter):
        assert torch.equal(fn(x, None, 1), x)
    assert tq.quantized_all_reduce_tree({}, None, 1) == {}


def test_functional_clip_is_the_optimizers():
    assert tsc.functional_clip is tclip.functional_clip
    x = torch.arange(8.0)
    assert torch.equal(tq.reduce_scatter(x, None, 1), x)
    assert torch.equal(tq.reduce_scatter(x, None, 1, mean=True), x)


@pytest.mark.parametrize("amp", [False, True])
def test_compile_train_step_at_degree_one_matches_reference(amp):
    """``compile_train_step`` on one process (a degree-1 mesh): a Linear
    regression under ``loss_fn`` with ``accumulate_steps=2``; under amp
    the input runs in bf16 and the float label keeps its dtype, as the
    reference's ``_forward_loss`` keeps it (strategy_compiler.py:370-412).
    Losses at rtol 1e-5 (f32) or 2e-3 (bf16 products: half of bf16's
    2^-8), parameters after 3 steps at atol 1e-5 (f32) or 5e-4 under amp:
    5% of one step's update of about lr = 1e-2, which bf16 gradients move
    (measured 1.03e-4)."""
    from paddle_tpu.nn import Linear as JLinear
    from paddle_tpu_torch.distributed.mesh import create_mesh
    from paddle_tpu_torch.nn.layer.common import Linear

    rng = np.random.RandomState(5)
    w = rng.randn(8, 4).astype(np.float32)
    x = rng.randn(3, 16, 8).astype(np.float32)
    y = rng.randn(3, 16, 4).astype(np.float32)
    seen = set()

    def tloss(out, lbl):
        seen.add((out.dtype, lbl.dtype))
        return ((out.float() - lbl) ** 2).mean()

    def jloss(out, lbl):
        return ((out.astype("float32") - lbl) ** 2).mean()

    tl = Linear(8, 4, device="cpu")
    jl = JLinear(8, 4)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w))
    jl.weight.set_value(paddle.to_tensor(w))
    s, js = DistributedStrategy(), JStrategy()
    s.amp = js.amp = amp
    tr = tsc.compile_train_step(
        tl, AdamW(1e-2, parameters=tl.named_parameters()), s,
        create_mesh({"dp": 1}), loss_fn=tloss, accumulate_steps=2,
        donate=False)
    jtr = jsc.compile_train_step(
        jl, paddle.optimizer.AdamW(1e-2, parameters=jl.parameters()), js,
        jsc.build_mesh_from_strategy(js, jax.devices()[:1]), loss_fn=jloss,
        accumulate_steps=2)
    got = [float(tr.step(torch.from_numpy(a), torch.from_numpy(b)))
           for a, b in zip(x, y)]
    want = [float(np.asarray(jtr.step(a, b))) for a, b in zip(x, y)]
    np.testing.assert_allclose(got, want, rtol=2e-3 if amp else 1e-5)
    assert seen == ({(torch.bfloat16, torch.float32)} if amp
                    else {(torch.float32, torch.float32)})
    jtr.sync_to_layer()
    np.testing.assert_allclose(tl.weight.detach().numpy(),
                               np.asarray(jl.weight._value),
                               rtol=0, atol=5e-4 if amp else 1e-5)
    with pytest.raises(ValueError, match="accumulate_steps"):
        tr.step(torch.zeros(3, 8), torch.zeros(3, 4))
