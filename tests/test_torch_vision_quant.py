"""The port's quantized conv layers (``QuantedConv2D``, ``Int8Conv2D``,
``paddle_tpu_torch/quantization``) held against the JAX package's on the
CPU, with the same weights (``quantization.load_reference_state``) and
seeded inputs:

- QAT: three training-mode forwards of a conv stack, then eval: the
  running activation scales equal the reference's, the fake-quant
  outputs and the weight's straight-through gradient at rtol 1e-5, atol
  1e-5 (a float conv of fake-quantized values, up to 576 f32 products a
  sum in another order: 1.5e-6 apart at K 576, measured);
- deploy (``convert_to_int8_deploy``): ``weight_q`` equal int8 for int8,
  ``w_scale`` and ``act_scale`` equal, and the outputs at rtol 1e-6,
  atol 1e-6 (the int32 sums are exact) against the reference's deploy
  model, for ``groups == 1`` (int8 im2col and the fused int8 product: the
  mma route at K = C·kh·kw = 150, LeNet's conv2, and the wgmma rule's K
  = 576, ResNet's 3x3 at C 64; the CPU runs the kernels' plain version)
  with stride, dilation and padding, and grouped (weight-only int8);
- the exported int8 state of a conv layer equals the reference's;
- a QAT LeNet trained a few steps on synthetic MNIST and converted keeps
  its fake-quant accuracy to within 1 point on the set.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import quantization as jq
from paddle_tpu_torch import nn, quantization as tq
from paddle_tpu_torch.ops import int8_matmul as im


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(jmodel):
    return {k: np.asarray(v._value) for k, v in jmodel.state_dict().items()}


CONVS = [
    # (in, out, k, kwargs, x shape)
    (6, 16, 5, dict(), (4, 6, 14, 14)),                      # K 150
    (64, 32, 3, dict(padding=1), (2, 64, 8, 8)),             # K 576
    (3, 8, 3, dict(stride=2, padding=1, dilation=2), (2, 3, 11, 11)),
    (8, 8, 3, dict(padding=[1, 2]), (2, 8, 7, 7)),
    (8, 12, 3, dict(padding=1, groups=4), (2, 8, 6, 6)),     # grouped
    (4, 6, 3, dict(padding=[0, 1, 1, 2]), (2, 4, 7, 7)),     # other pad
]


def _pair(i, seed=0):
    cin, cout, k, kw, _ = CONVS[i]
    paddle.seed(seed + i)
    jnet = jnn.Sequential(jnn.Conv2D(cin, cout, k, **kw), jnn.ReLU())
    net = nn.Sequential(nn.Conv2D(cin, cout, k, device="cpu", **kw),
                        nn.ReLU())
    tq.load_reference_state(net, _state(jnet))
    jq.QAT().quantize(jnet)
    tq.QAT().quantize(net)
    x = np.random.RandomState(seed + i).randn(*CONVS[i][4]).astype(
        np.float32)
    jnet.train()
    net.train()
    for step in range(3):
        xi = x * (1.0 + 0.5 * step)
        jo = jnet(paddle.to_tensor(xi))
        to = net(torch.from_numpy(xi))
        np.testing.assert_allclose(to.detach().numpy(), np.asarray(
            jo._value), rtol=1e-5, atol=1e-5)
    jnet.eval()
    net.eval()
    return jnet, net, x


@pytest.mark.parametrize("i", range(len(CONVS)),
                         ids=[f"conv{i}" for i in range(len(CONVS))])
def test_quanted_conv2d_matches_reference(i):
    jnet, net, x = _pair(i)
    assert isinstance(net[0], tq.QuantedConv2D)
    np.testing.assert_array_equal(net[0].act_quant.scale.numpy(),
                                  np.asarray(jnet[0].act_quant.scale._value))
    jx = paddle.to_tensor(x)
    jo = jnet(jx)
    tw = net[0].inner.weight
    to = net(torch.from_numpy(x))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo._value),
                               rtol=1e-5, atol=1e-5)
    ct = np.random.RandomState(9).randn(*to.shape).astype(np.float32)
    (jo * paddle.to_tensor(ct)).sum().backward()
    (to * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(
        tw.grad.numpy(), np.asarray(jnet[0].inner.weight.grad.numpy()),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("i", range(len(CONVS)),
                         ids=[f"conv{i}" for i in range(len(CONVS))])
def test_int8_conv2d_deploy_matches_reference(i, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_INT8_PALLAS", "0")
    jnet, net, x = _pair(i)
    assert jq.convert_to_int8_deploy(jnet) == 1
    assert tq.convert_to_int8_deploy(net) == 1
    j, t = jnet[0], net[0]
    assert isinstance(t, tq.Int8Conv2D)
    np.testing.assert_array_equal(t.weight_q.numpy(),
                                  np.asarray(j.weight_q._value))
    np.testing.assert_array_equal(t.w_scale.numpy(),
                                  np.asarray(j.w_scale._value))
    assert float(t.act_scale) == float(np.asarray(j.act_scale._value))
    assert sorted(t.state_dict()) == sorted(_state(j))
    counts = (im.INT8_MATMUL_LAUNCHES, im.INT8_MATMUL_WGMMA_LAUNCHES)
    jo = np.asarray(jnet(paddle.to_tensor(x))._value)
    to = net(torch.from_numpy(x)).numpy()
    assert (im.INT8_MATMUL_LAUNCHES, im.INT8_MATMUL_WGMMA_LAUNCHES) == \
        counts, "the CPU runs the plain version, no kernel"
    np.testing.assert_allclose(to, jo, rtol=1e-6, atol=1e-6)


def test_int8_conv2d_route_rule_by_k():
    """The im2col product's K picks the CUDA route: C·kh·kw % 16 == 0 is
    the wgmma route, anything else mma.sync (``ops.int8_matmul._mm_route``
    on the patches the layer builds)."""
    for (cin, _, k, kw, _xs), want in zip(CONVS[:2], ("mma", "wgmma")):
        patches = torch.zeros(64, cin * k * k, dtype=torch.int8)
        wq_kn = torch.zeros(16, cin * k * k, dtype=torch.int8)
        assert im._mm_route(patches, wq_kn) == want
    assert im._mm_route(torch.zeros(8, 147, dtype=torch.int8)) == "mma"


def test_export_int8_state_of_a_conv_equals_reference():
    jnet, net, _ = _pair(1)
    je, te = jq.export_int8_state(jnet), tq.export_int8_state(net)
    assert sorted(je) == sorted(te)
    for name in je:
        np.testing.assert_array_equal(te[name]["int8_weight"],
                                      je[name]["int8_weight"])
        np.testing.assert_array_equal(te[name]["scales"], je[name]["scales"])
        assert te[name]["channel_axis"] == je[name]["channel_axis"] == 0
        assert te[name]["act_scale"] == je[name]["act_scale"]


def test_qat_lenet_keeps_its_accuracy_after_int8_deploy():
    from paddle_tpu_torch import io, seed
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet

    seed(3)
    data = MNIST(mode="train", synthetic_size=256)
    net = LeNet(device="cpu")
    tq.QAT().quantize(net)
    opt = Adam(0.002, parameters=net.parameters())
    for x, y in io.DataLoader(data, batch_size=64, shuffle=True,
                              device="cpu"):
        F.cross_entropy(net(x), y).backward()
        opt.step()
        opt.clear_grad()
    net.eval()

    def accuracy():
        acc = Accuracy()
        with torch.no_grad():
            for x, y in io.DataLoader(data, batch_size=128, device="cpu"):
                acc.update(acc.compute(net(x), y))
        return acc.accumulate()

    fake = accuracy()
    assert tq.convert_to_int8_deploy(net) == 5
    assert isinstance(net.features[3], tq.Int8Conv2D)
    assert fake > 0.5 and abs(accuracy() - fake) <= 0.01, (fake, accuracy())
