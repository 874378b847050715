"""paddle_tpu_torch.quantization held against the JAX package.

The same seeded numpy inputs and the same weights (carried across as
numpy by ``quantization.load_reference_state``) go through the reference
toolkit and the port's: fake-quant values and straight-through gradients,
the running activation scale, QAT -> calibration -> int8 deploy on
``Sequential(Linear, ReLU, Linear)``, and the exported int8 state. The
reference's deploy model runs both ways — its fused Pallas kernel in
interpret mode (``PADDLE_TPU_INT8_PALLAS=1``, set with monkeypatch) and
its unfused expression (``=0``); the port has one way, the fused function
(its plain version here, CPU tensors).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import quantization as jq
from paddle_tpu_torch import nn, quantization as tq


def _state(jmodel):
    return {k: np.asarray(v._value) for k, v in jmodel.state_dict().items()}


def _mlp_pair(dims, seed):
    """The same Linear/ReLU stack in both packages, same weights."""
    paddle.seed(seed)
    jl, tl = [], []
    for i, (a, b) in enumerate(zip(dims, dims[1:])):
        if i:
            jl.append(jnn.ReLU())
            tl.append(nn.ReLU())
        jl.append(jnn.Linear(a, b))
        tl.append(nn.Linear(a, b, device="cpu"))
    jnet, net = jnn.Sequential(*jl), nn.Sequential(*tl)
    tq.load_reference_state(net, _state(jnet))
    return jnet, net


def _qat_pair(dims, seed, steps=3):
    """Both stacks quantized and run `steps` training forwards on the
    same growing inputs; left in eval mode."""
    jnet, net = _mlp_pair(dims, seed)
    jq.QAT().quantize(jnet)
    tq.QAT().quantize(net)
    x = np.random.RandomState(seed).randn(8, dims[0]).astype(np.float32)
    jnet.train()
    net.train()
    for i in range(steps):
        xi = x * (1.0 + 0.5 * i)
        jo = jnet(paddle.to_tensor(xi))
        to = net(torch.from_numpy(xi))
    jnet.eval()
    net.eval()
    return jnet, net, x, np.asarray(jo._value), to.detach().numpy()


# ---------------------------------------------------------------------------
# fake-quant primitive
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(), dict(bits=4), dict(scale=0.7),
                                dict(channel_axis=0), dict(channel_axis=1)],
                         ids=lambda k: "-".join(f"{a}{b}" for a, b in
                                                k.items()) or "absmax8")
def test_fake_quant_values_match_reference(kw):
    x = np.random.RandomState(0).randn(6, 10).astype(np.float32)
    ref = np.asarray(jq.fake_quant(paddle.to_tensor(x), **kw)._value)
    got = tq.fake_quant(torch.from_numpy(x), **kw).numpy()
    # the same f32 expression; 1 ulp where a division rounds differently
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    if not kw:
        np.testing.assert_allclose(got * 127.0 / np.abs(x).max(),
                                   np.round(got * 127.0 / np.abs(x).max()),
                                   atol=1e-4)


def test_fake_quant_ste_gradient_matches_reference():
    """Inside |x| <= scale the gradient passes, outside it is zero, and
    the scale gets none."""
    xv = np.asarray([0.5, 2.0, -0.9, -1.5, 1.0], np.float32)
    up = np.asarray([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    jx = paddle.to_tensor(xv)
    jx.stop_gradient = False
    jout = jq.fake_quant(jx, paddle.to_tensor(np.asarray(1.0, np.float32)))
    (jout * paddle.to_tensor(up)).sum().backward()
    x = torch.from_numpy(xv).requires_grad_()
    scale = torch.tensor(1.0, requires_grad=True)
    out = tq.fake_quant(x, scale)
    (out * torch.from_numpy(up)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jout._value), rtol=1e-6)
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jx.grad._value))
    np.testing.assert_array_equal(x.grad.numpy(), [1.0, 0.0, 3.0, 0.0, 5.0])
    assert scale.grad is None


def test_abs_max_scale_gets_no_gradient_through_the_scale():
    """scale=None computes the abs-max from x; the straight-through
    gradient still is the pass-through mask alone (all ones: every
    |x| <= max|x|)."""
    xv = np.random.RandomState(1).randn(4, 5).astype(np.float32)
    x = torch.from_numpy(xv).requires_grad_()
    tq.fake_quant(x).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones_like(xv))


# ---------------------------------------------------------------------------
# QAT layers
# ---------------------------------------------------------------------------
def test_act_quant_scale_after_training_forwards_matches_reference():
    jnet, net, _, jo, to = _qat_pair((16, 32, 8), seed=3, steps=4)
    # the last training forward's outputs and every running scale agree
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    ref = _state(jnet)
    for name, t in net.state_dict().items():
        np.testing.assert_allclose(t.numpy(), ref[name], rtol=1e-6,
                                   err_msg=name)
    s0 = float(net[0].act_quant.scale)
    assert s0 > 0
    # eval mode freezes the scales
    net(torch.full((2, 16), 100.0))
    assert float(net[0].act_quant.scale) == s0


def test_qat_eval_output_and_gradients_match_reference():
    jnet, net, x, _, _ = _qat_pair((16, 32, 8), seed=4)
    jo = jnet(paddle.to_tensor(x))
    to = net(torch.from_numpy(x))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo._value),
                               rtol=1e-5, atol=1e-5)
    jo.sum().backward()
    to.sum().backward()
    jgrads = {n: np.asarray(p.grad._value)
              for n, p in jnet.named_parameters()}
    for n, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[n], rtol=1e-4,
                                   atol=1e-5, err_msg=n)


def test_ptq_calibrate_matches_reference():
    jnet, net = _mlp_pair((8, 4), seed=6)
    x = np.random.RandomState(1).randn(32, 8).astype(np.float32)
    fp32 = net(torch.from_numpy(x)).detach().numpy()
    cfg = dict(moving_rate=0.0)
    jp, tp = jq.PTQ(jq.QuantConfig(**cfg)), tq.PTQ(tq.QuantConfig(**cfg))
    jp.quantize(jnet)
    tp.quantize(net)
    jp.calibrate(jnet, [(paddle.to_tensor(x),)] * 4, steps=4)
    tp.calibrate(net, [(x,)] * 4, steps=4)          # numpy batches too
    assert not net.training
    np.testing.assert_allclose(float(net[0].act_quant.scale),
                               float(np.asarray(
                                   jnet[0].act_quant.scale._value)),
                               rtol=1e-6)
    out = net(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(
        out, np.asarray(jnet(paddle.to_tensor(x))._value), rtol=1e-5,
        atol=1e-5)
    assert np.abs(out - fp32).max() < 0.05 * np.abs(fp32).max() + 0.05


# ---------------------------------------------------------------------------
# int8 deploy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pallas", ["1", "0"], ids=["ref_fused",
                                                    "ref_unfused"])
def test_int8_deploy_matches_reference(monkeypatch, pallas):
    """QAT -> calibrate -> convert_to_int8_deploy on Sequential(Linear,
    ReLU, Linear). Against the reference's fused kernel the port agrees
    at 1e-5 / 1e-4 (the chain tolerance of tests/test_int8_pallas.py);
    against its unfused expression at the same tolerance — fc2 there
    quantizes the f32 ReLU output itself, which the fused chain does in
    fc1's epilogue with differently rounded scales."""
    jnet, net, x, _, _ = _qat_pair((32, 64, 16), seed=9)
    qat_eval = net(torch.from_numpy(x)).detach().numpy()
    assert jq.convert_to_int8_deploy(jnet) == 2
    assert tq.convert_to_int8_deploy(net) == 2
    fc1, fc2 = net[0], net[2]
    assert isinstance(fc1, tq.Int8Linear) and isinstance(fc2, tq.Int8Linear)
    assert fc1._fuse_relu and fc1._next_scale is fc2.act_scale
    assert fc2._int8_src is fc1 and not fc2._fuse_relu
    # the deploy state is equal entry by entry, with the reference's keys
    ref_state = _state(jnet)
    own = net.state_dict()
    assert sorted(own) == sorted(ref_state)
    for name, t in own.items():
        assert t.dtype == (torch.int8 if name.endswith("weight_q")
                           else torch.float32), name
        np.testing.assert_array_equal(t.numpy(), ref_state[name],
                                      err_msg=name)
    monkeypatch.setenv("PADDLE_TPU_INT8_PALLAS", pallas)
    ref = np.asarray(jnet(paddle.to_tensor(x))._value)
    got = net(torch.from_numpy(x))
    assert got.dtype == torch.float32 and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    # and the int8 compute stays close to the fake-quant model it came from
    assert np.abs(got.numpy() - qat_eval).max() < \
        0.02 * np.abs(qat_eval).max()


def test_reference_deploy_state_loads_into_port_layers(monkeypatch):
    """The reference deploy model's state_dict (weight_q int8, w_scale,
    act_scale, bias) carried into a port deploy model built from OTHER
    weights: afterwards both compute the same thing."""
    jnet, _, x, _, _ = _qat_pair((32, 64, 16), seed=11)
    jq.convert_to_int8_deploy(jnet)
    _, net, _, _, _ = _qat_pair((32, 64, 16), seed=12)
    tq.convert_to_int8_deploy(net)
    before = net(torch.from_numpy(x)).numpy()
    tq.load_reference_state(net, _state(jnet))
    monkeypatch.setenv("PADDLE_TPU_INT8_PALLAS", "1")
    ref = np.asarray(jnet(paddle.to_tensor(x))._value)
    got = net(torch.from_numpy(x)).numpy()
    assert np.abs(before - ref).max() > 1e-2
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    with pytest.raises(KeyError, match="missing"):
        tq.load_reference_state(net, {"0.weight_q": np.zeros((32, 64),
                                                             np.int8)})


def test_three_layer_chain_keeps_bf16(monkeypatch):
    """3 fused layers: the middle one is int8 in, int8 out, and the
    float dtype the first layer saw comes out of the last."""
    jnet, net, x, _, _ = _qat_pair((16, 32, 32, 8), seed=10)
    jq.convert_to_int8_deploy(jnet)
    tq.convert_to_int8_deploy(net)
    lin = [m for m in net if isinstance(m, tq.Int8Linear)]
    assert lin[0]._next_scale is not None and lin[1]._next_scale is not None
    assert lin[2]._next_scale is None
    out = net(torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
    assert lin[1]._last_float_dtype == torch.bfloat16
    monkeypatch.setenv("PADDLE_TPU_INT8_PALLAS", "1")
    ref = jnet(paddle.to_tensor(jnp.asarray(x, jnp.bfloat16)))._value
    assert ref.dtype == jnp.bfloat16
    # both round one f32 result to bf16: one ulp where they straddle
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-4)
    assert net(torch.from_numpy(x)).dtype == torch.float32


def test_export_int8_state_equals_reference_entry_by_entry():
    jnet, net, _, _, _ = _qat_pair((16, 32, 8), seed=7)
    ref, got = jq.export_int8_state(jnet), tq.export_int8_state(net)
    assert sorted(got) == sorted(ref) == ["0", "2"]
    for name, entry in got.items():
        assert sorted(entry) == sorted(ref[name])
        assert entry["int8_weight"].dtype == np.int8
        np.testing.assert_array_equal(entry["int8_weight"],
                                      ref[name]["int8_weight"])
        np.testing.assert_array_equal(entry["scales"], ref[name]["scales"])
        assert entry["channel_axis"] == ref[name]["channel_axis"] == 1
        np.testing.assert_allclose(entry["act_scale"],
                                   ref[name]["act_scale"], rtol=1e-6)


def test_per_tensor_weight_quantization_matches_reference():
    cfg = dict(weight_quantize_type="abs_max")
    jnet, net = _mlp_pair((8, 6), seed=13)
    jq.QAT(jq.QuantConfig(**cfg)).quantize(jnet)
    tq.QAT(tq.QuantConfig(**cfg)).quantize(net)
    x = np.random.RandomState(13).randn(5, 8).astype(np.float32)
    jnet(paddle.to_tensor(x))
    net(torch.from_numpy(x))
    ref, got = jq.export_int8_state(jnet), tq.export_int8_state(net)
    assert got["0"]["channel_axis"] is None and got["0"]["scales"].shape == (1,)
    np.testing.assert_array_equal(got["0"]["int8_weight"],
                                  ref["0"]["int8_weight"])
    jq.convert_to_int8_deploy(jnet)
    tq.convert_to_int8_deploy(net)
    np.testing.assert_array_equal(net[0].w_scale.numpy(),
                                  np.asarray(jnet[0].w_scale._value))


def test_int8_linear_k_major_copy_stays_out_of_the_state_dict(monkeypatch):
    """Each Int8Linear keeps ``weight_q.T.contiguous()`` (what the int8
    kernel's wgmma route reads) as a non-persistent buffer: the state_dict
    keys stay the reference layer's, the copy equals the transpose, moves
    with ``.to()``, is rebuilt when weight_q is loaded in place, and the
    fc1 -> fc2 chain still agrees with the reference."""
    jnet, net, x, _, _ = _qat_pair((32, 64, 16), seed=14)
    jq.convert_to_int8_deploy(jnet)
    tq.convert_to_int8_deploy(net)
    assert sorted(net.state_dict()) == sorted(_state(jnet))
    for lin in (net[0], net[2]):
        assert "weight_kn" not in lin.state_dict()
        assert lin.weight_kn.dtype == torch.int8
        assert lin.weight_kn.is_contiguous()
        assert torch.equal(lin.weight_kn, lin.weight_q.t().contiguous())
        assert lin._weight_kn() is lin.weight_kn          # built once
    monkeypatch.setenv("PADDLE_TPU_INT8_PALLAS", "1")
    ref = np.asarray(jnet(paddle.to_tensor(x))._value)
    got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    # an in-place load of other weights rebuilds the copy on next use
    jnet2, _, _, _, _ = _qat_pair((32, 64, 16), seed=15)
    jq.convert_to_int8_deploy(jnet2)
    tq.load_reference_state(net, _state(jnet2))
    for lin in (net[0], net[2]):
        assert torch.equal(lin._weight_kn(), lin.weight_q.t().contiguous())
    np.testing.assert_allclose(
        net(torch.from_numpy(x)).numpy(),
        np.asarray(jnet2(paddle.to_tensor(x))._value), rtol=1e-5, atol=1e-4)
    # the copy follows the module to another device with its buffers
    net.to("meta")
    assert net[0].weight_kn.device.type == "meta"
    assert net[0].weight_kn.shape == (64, 32)


# ---------------------------------------------------------------------------
# errors and what waits for later slices
# ---------------------------------------------------------------------------
def test_no_quantizable_layers_raises():
    with pytest.raises(ValueError, match="no quantizable"):
        tq.QAT().quantize(nn.Sequential(nn.ReLU()))


def test_uncalibrated_deploy_raises():
    net = nn.Sequential(nn.Linear(8, 4, device="cpu"))
    tq.QAT().quantize(net)          # no forward pass ran
    with pytest.raises(ValueError, match="uncalibrated"):
        tq.convert_to_int8_deploy(net)


def test_more_than_8_bits_deploy_raises():
    net = nn.Sequential(nn.Linear(8, 4, device="cpu"))
    tq.QAT(tq.QuantConfig(weight_bits=16)).quantize(net)
    net(torch.ones(2, 8))
    with pytest.raises(ValueError, match="<=8-bit"):
        tq.convert_to_int8_deploy(net)


@pytest.mark.parametrize("what", ["QuantedConv2D", "Int8Conv2D",
                                  "save_quantized_model"])
def test_conv_and_save_wait_for_the_long_tail(what):
    """``save_quantized_model`` still waits for ``jit.save``; the conv
    layers are ported (``tests/test_torch_vision_quant.py`` holds them to
    the JAX package): each builds from a ``Conv2D`` and runs."""
    if what == "save_quantized_model":
        with pytest.raises(NotImplementedError,
                           match="ROADMAP queue 1 item 9"):
            tq.save_quantized_model(nn.Sequential(), "unused", None)
        return
    conv = nn.Conv2D(3, 4, 3, padding=1, device="cpu")
    layer = tq.QuantedConv2D(conv, tq.QuantConfig()) \
        if what == "QuantedConv2D" else tq.Int8Conv2D(conv, 1.0)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, 3, 5, 5).astype(np.float32))
    assert tuple(layer(x).shape) == (2, 4, 5, 5)
