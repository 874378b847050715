"""The port's ``nn`` layers, ``Layer`` base, containers and initializers
(``paddle_tpu_torch/nn``) held against the JAX package on the CPU.

- ``BatchNorm2D``: the reference's weights and buffers loaded into both
  packages, three training-mode forwards on seeded batches (outputs at
  rtol 1e-5, and the running ``_mean``/``_variance`` at 1e-6: momentum
  0.9, the biased batch variance), then eval; a bf16 input's statistics
  equal those of the same values in f32, and its output the reference's
  bf16 output; ``use_global_stats``; ``state_dict`` names equal the
  reference's for every norm, conv, pool-free layer with parameters;
- the layers that own parameters forward and backward against the
  reference's after ``set_state_dict`` (conv and transposes, the norms,
  ``PReLU``, ``Bilinear``, ``SpectralNorm`` with its power-iteration
  buffers, the loss layers);
- the initializers: by shape, bounds and moments (``Uniform``, the
  Xavier and Kaiming pairs with the reference's fans for Linear and conv
  weights, ``TruncatedNormal``, ``Orthogonal``); ``Constant``, ``Assign``
  and ``Dirac`` equal the reference's exactly; ``calculate_gain``;
- ``Layer``: ``create_parameter`` and ``ParamAttr``, ``set_state_dict``
  from numpy and from tensors, ``clear_gradients``, ``parameters()`` as a
  list, ``LazyGuard``; the containers (``Sequential`` with pairs and
  slices, ``LayerList``, ``LayerDict``, ``ParameterList``);
- the oracle cases of ``tests/test_nn_layers.py`` that 9b covers.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.initializer as JI
import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.nn.initializer as I
from paddle_tpu_torch.framework.lazy import LazyGuard, is_abstract
from paddle_tpu_torch.models.gpt import load_reference_state
from _torch_nn_oracle import TOL, arr


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu():
    with nn.device_scope("cpu"):
        yield


def _ref_state(layer, seed):
    """The reference layer's state with every float entry redrawn from
    ``seed`` (variances kept positive)."""
    out = {}
    for i, (k, v) in enumerate(layer.state_dict().items()):
        a = np.asarray(v._value)
        if a.dtype.kind == "f":
            a = arr(a.shape, seed + i) * 0.5
            if "variance" in k:
                a = np.abs(a) + 0.5
        out[k] = a
    layer.set_state_dict(out)
    return out


def _pair_layers(jl, tl, seed=0):
    state = _ref_state(jl, seed)
    assert sorted(tl.state_dict()) == sorted(state)
    load_reference_state(tl, state)
    return state


def _fwd_bwd(jl, tl, x, seed=7):
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    jo, to = jl(jx), tl(tx)
    np.testing.assert_allclose(to.detach().numpy(), jo.numpy(), **TOL)
    ct = arr(tuple(jo.shape), seed)
    (jo * paddle.to_tensor(ct)).sum().backward()
    (to * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), **TOL)
    jp = dict(jl.named_parameters())
    for n, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jp[n].grad.numpy(),
                                   err_msg=n, **TOL)


def test_batch_norm_three_train_forwards_then_eval():
    jl, tl = jnn.BatchNorm2D(5), nn.BatchNorm2D(5)
    _pair_layers(jl, tl, 3)
    jl.train()
    tl.train()
    for i in range(3):
        _fwd_bwd(jl, tl, arr((6, 5, 4, 4), 20 + i) * 2 + 1)
        np.testing.assert_allclose(tl._mean.numpy(), jl._mean.numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tl._variance.numpy(),
                                   jl._variance.numpy(), rtol=1e-6,
                                   atol=1e-6)
    jl.eval()
    tl.eval()
    _fwd_bwd(jl, tl, arr((6, 5, 4, 4), 30))
    assert tl._mean.dtype == tl._variance.dtype == torch.float32


def test_batch_norm_momentum_and_biased_variance():
    tl = nn.BatchNorm2D(3)
    x = arr((4, 3, 2, 2), 40) * 3
    tl(torch.from_numpy(x))
    np.testing.assert_allclose(tl._mean.numpy(),
                               0.1 * x.mean(axis=(0, 2, 3)), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tl._variance.numpy(),
                               0.9 + 0.1 * x.var(axis=(0, 2, 3)),
                               rtol=1e-5, atol=1e-6)
    assert "num_batches_tracked" not in tl.state_dict()


def test_batch_norm_bf16_statistics_are_f32s():
    x = arr((6, 4, 3, 3), 41) * 2 + 3
    xb = torch.from_numpy(x).bfloat16()
    a, b = nn.BatchNorm2D(4), nn.BatchNorm2D(4)
    ya = a(xb)
    b(xb.float())
    assert ya.dtype == torch.bfloat16
    assert torch.equal(a._mean, b._mean)
    assert torch.equal(a._variance, b._variance)
    jl = jnn.BatchNorm2D(4)
    jy = jl(paddle.to_tensor(xb.float().numpy()).astype("bfloat16"))
    np.testing.assert_allclose(a._mean.numpy(), jl._mean.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(a._variance.numpy(), jl._variance.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        ya.detach().float().numpy(),
        np.asarray(jy.astype("float32").numpy()))


def test_batch_norm_use_global_stats_in_training():
    jl = jnn.BatchNorm2D(3, use_global_stats=True)
    tl = nn.BatchNorm2D(3, use_global_stats=True)
    state = _pair_layers(jl, tl, 5)
    _fwd_bwd(jl, tl, arr((4, 3, 3, 3), 42))
    np.testing.assert_array_equal(tl._mean.numpy(), state["_mean"])


LAYERS = [
    ("Conv1D", (3, 4, 3), dict(padding=1), (2, 3, 7)),
    ("Conv2D", (3, 4, 3), dict(stride=2, padding="SAME"), (2, 3, 7, 7)),
    ("Conv2D", (4, 6, 3), dict(groups=2, bias_attr=False), (2, 4, 6, 6)),
    ("Conv3D", (2, 3, 3), dict(padding=1), (1, 2, 4, 4, 4)),
    ("Conv1DTranspose", (3, 4, 3), dict(stride=2), (2, 3, 5)),
    ("Conv2DTranspose", (3, 4, 3), dict(stride=2, padding=1,
                                        output_padding=1), (2, 3, 4, 4)),
    ("Conv3DTranspose", (2, 3, 3), dict(stride=2), (1, 2, 3, 3, 3)),
    ("BatchNorm1D", (4,), {}, (6, 4)),
    ("BatchNorm3D", (3,), {}, (2, 3, 2, 3, 3)),
    ("BatchNorm", (3,), dict(act="relu"), (4, 3, 3, 3)),
    ("SyncBatchNorm", (3,), {}, (4, 3, 3, 3)),
    ("GroupNorm", (2, 6), {}, (2, 6, 3, 3)),
    ("InstanceNorm2D", (3,), {}, (2, 3, 4, 4)),
    ("LocalResponseNorm", (3,), {}, (2, 5, 3, 3)),
    ("RMSNorm", (8,), {}, (3, 8)),
    ("LayerNorm", (6,), {}, (3, 6)),
    ("PReLU", (3,), {}, (2, 3, 4, 4)),
    ("Linear", (5, 3), {}, (4, 5)),
    ("MaxPool2D", (3, 2, 1), {}, (2, 3, 7, 7)),
    ("AvgPool2D", (3, 2, 1), {}, (2, 3, 7, 7)),
    ("AdaptiveAvgPool2D", ((2, 3),), {}, (2, 3, 5, 7)),
    ("AdaptiveMaxPool2D", (2,), {}, (2, 3, 4, 4)),
    ("Flatten", (), {}, (2, 3, 4)),
    ("Upsample", (), dict(scale_factor=2, mode="bilinear"), (2, 3, 3, 4)),
    ("Pad2D", ([1, 0, 2, 1],), dict(mode="reflect"), (2, 3, 4, 4)),
    ("PixelShuffle", (2,), {}, (2, 8, 3, 3)),
    ("Unfold", (3,), dict(paddings=1), (2, 3, 5, 5)),
    ("Softmax", (), dict(axis=1), (3, 5)),
    ("Hardswish", (), {}, (3, 5)),
    ("GELU", (), dict(approximate=True), (3, 5)),
    ("Maxout", (2,), {}, (2, 4, 3)),
]


@pytest.mark.parametrize("i", range(len(LAYERS)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LAYERS)])
def test_layer_matches_reference(i):
    name, args, kw, xs = LAYERS[i]
    jl, tl = getattr(jnn, name)(*args, **kw), getattr(nn, name)(*args, **kw)
    _pair_layers(jl, tl, 10 + i)
    _fwd_bwd(jl, tl, arr(xs, 50 + i) + (1.0 if "Norm" in name else 0.0))


def test_spectral_norm_matches_reference():
    jl, tl = jnn.SpectralNorm([4, 3, 2], dim=1, power_iters=2), \
        nn.SpectralNorm([4, 3, 2], dim=1, power_iters=2)
    _pair_layers(jl, tl, 60)
    w = arr((4, 3, 2), 61)
    for _ in range(2):                 # the buffers carry across calls
        jo = jl(paddle.to_tensor(w))
        to = tl(torch.from_numpy(w))
        np.testing.assert_allclose(to.numpy(), jo.numpy(), **TOL)
    np.testing.assert_allclose(tl.weight_u.numpy(), jl.weight_u.numpy(),
                               **TOL)


def test_bilinear_and_loss_layers_match_reference():
    jl, tl = jnn.Bilinear(3, 4, 2), nn.Bilinear(3, 4, 2)
    _pair_layers(jl, tl, 70)
    a, b = arr((5, 3), 71), arr((5, 4), 72)
    np.testing.assert_allclose(
        tl(torch.from_numpy(a), torch.from_numpy(b)).detach().numpy(),
        jl(paddle.to_tensor(a), paddle.to_tensor(b)).numpy(), **TOL)
    x, lbl = arr((6, 4), 73), arr((6,), 74, 0, 4, np.int64)
    for name, kw in (("CrossEntropyLoss", dict(reduction="sum")),
                     ("NLLLoss", {}), ("MSELoss", {}), ("L1Loss", {}),
                     ("SmoothL1Loss", dict(delta=0.5))):
        y = lbl if name in ("CrossEntropyLoss", "NLLLoss") else arr(
            (6, 4), 75)
        np.testing.assert_allclose(
            getattr(nn, name)(**kw)(torch.from_numpy(x),
                                    torch.from_numpy(y)).numpy(),
            getattr(jnn, name)(**kw)(paddle.to_tensor(x),
                                     paddle.to_tensor(y)).numpy(), **TOL)
    hl, ht = jnn.HSigmoidLoss(4, 6), nn.HSigmoidLoss(4, 6)
    _pair_layers(hl, ht, 76)
    np.testing.assert_allclose(
        ht(torch.from_numpy(x), torch.from_numpy(lbl)).detach().numpy(),
        hl(paddle.to_tensor(x), paddle.to_tensor(lbl)).numpy(), **TOL)


@pytest.mark.parametrize("cls", ["BatchNorm2D", "SyncBatchNorm"])
def test_convert_sync_batchnorm(cls):
    net = nn.Sequential(nn.Conv2D(3, 4, 3), getattr(nn, cls)(4),
                        nn.Sequential(nn.BatchNorm1D(4)))
    with torch.no_grad():
        net[1]._mean.fill_(0.25)
    out = nn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(out[1], nn.SyncBatchNorm)
    assert isinstance(out[2][0], nn.SyncBatchNorm)
    assert float(out[1]._mean[0]) == 0.25


# -- initializers ------------------------------------------------------------
def _draw(init, shape, seed=0):
    from paddle_tpu_torch.core import rng

    rng.seed(seed)
    return init(torch.empty(shape)).numpy()


@pytest.mark.parametrize("shape", [(256, 384), (64, 32, 3, 3)],
                         ids=["linear", "conv"])
@pytest.mark.parametrize("name", ["XavierUniform", "XavierNormal",
                                  "KaimingUniform", "KaimingNormal"])
def test_fan_initializers_match_reference_moments(name, shape):
    t = _draw(getattr(I, name)(), shape)
    j = np.asarray(getattr(JI, name)()(shape))
    assert t.shape == j.shape
    np.testing.assert_allclose(t.std(), j.std(), rtol=0.03)
    assert abs(t.mean()) < 0.05 * j.std()
    if "Uniform" in name:
        fi, fo = JI._fans(shape)
        gain = 1.0 if "Xavier" in name else 2 ** 0.5
        limit = gain * (6.0 / (fi + fo) if "Xavier" in name
                        else 3.0 / fi) ** 0.5
        assert -limit <= t.min() and t.max() <= limit
        assert abs(t.max() - j.max()) < 0.01 * j.max()


def test_uniform_normal_truncated_orthogonal():
    u = _draw(I.Uniform(-0.3, 0.7), (200, 100))
    assert u.min() >= -0.3 and u.max() < 0.7
    assert abs(u.mean() - 0.2) < 0.01
    n = _draw(I.Normal(1.0, 2.0), (200, 100))
    assert abs(n.mean() - 1.0) < 0.05 and abs(n.std() - 2.0) < 0.05
    tn = _draw(I.TruncatedNormal(0.5, 2.0), (200, 100))
    jt = np.asarray(JI.TruncatedNormal(0.5, 2.0)((200, 100)))
    assert tn.min() >= 0.5 - 4.0 - 1e-5 and tn.max() <= 0.5 + 4.0 + 1e-5
    np.testing.assert_allclose(tn.std(), jt.std(), rtol=0.03)
    for shape in ((6, 4), (3, 8), (2, 3, 5)):
        q = _draw(I.Orthogonal(1.5), shape).reshape(-1, shape[-1])
        small = min(q.shape)
        g = q.T @ q if q.shape[0] >= q.shape[1] else q @ q.T
        np.testing.assert_allclose(g, 2.25 * np.eye(small), atol=1e-5)


@pytest.mark.parametrize("case", ["constant", "assign", "dirac",
                                  "dirac_groups"])
def test_exact_initializers_equal_reference(case):
    if case == "constant":
        t, j = I.Constant(0.75), JI.Constant(0.75)
        shape = (3, 4)
    elif case == "assign":
        v = arr((12,), 80)
        t, j = I.Assign(v), JI.Assign(v)
        shape = (3, 4)
    else:
        g = 2 if case == "dirac_groups" else 1
        t, j = I.Dirac(g), JI.Dirac(g)
        shape = (4, 3, 3, 3)
    np.testing.assert_array_equal(t(torch.empty(shape)).numpy(),
                                  np.asarray(j(shape)))


def test_calculate_gain_equals_reference():
    for nl in ("sigmoid", "linear", "conv2d", "tanh", "relu", "selu"):
        assert I.calculate_gain(nl) == JI.calculate_gain(nl)
    assert I.calculate_gain("leaky_relu", 0.2) == \
        JI.calculate_gain("leaky_relu", 0.2)
    with pytest.raises(ValueError):
        I.calculate_gain("swish")


# -- Layer and containers ---------------------------------------------------
def test_create_parameter_and_param_attr():
    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.w = self.create_parameter([3, 4])
            self.b = self.create_parameter([4], is_bias=True)
            self.frozen = self.create_parameter(
                [2], attr=nn.ParamAttr(initializer=I.Constant(2.0),
                                       trainable=False))
            self.none = self.create_parameter([2], attr=False)

    net = Net()
    assert net.none is None
    assert not net.frozen.requires_grad and float(net.frozen[0]) == 2.0
    assert torch.equal(net.b, torch.zeros(4))
    assert isinstance(net.parameters(), list) and len(net.parameters()) == 3
    with LazyGuard():
        lazy = Net()
    assert is_abstract(lazy.w)


def test_set_state_dict_from_numpy_and_tensors_and_clear_gradients():
    net = nn.Sequential(("fc", nn.Linear(3, 2)), ("bn", nn.BatchNorm1D(2)))
    sd = {k: v.detach().numpy() + 1.0 for k, v in net.state_dict().items()}
    missing, unexpected = net.set_state_dict(dict(sd, extra=np.zeros(1)))
    assert missing == [] and unexpected == ["extra"]
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k])
    missing, _ = net.set_state_dict(
        {"fc.weight": torch.zeros(3, 2)})
    assert "bn._mean" in missing
    assert float(net.fc.weight.detach().abs().sum()) == 0
    net(torch.ones(4, 3)).sum().backward()
    assert net.fc.bias.grad is not None
    net.clear_gradients()
    assert all(p.grad is None for p in net.parameters())


def test_containers():
    seq = nn.Sequential(("a", nn.Linear(2, 3)), ("b", nn.ReLU()))
    assert list(dict(seq.named_children())) == ["a", "b"]
    assert isinstance(seq[0:1], nn.Sequential) and len(seq[0:1]) == 1
    assert isinstance(seq, torch.nn.Sequential)
    assert isinstance(nn.Sequential([("x", nn.ReLU())])[0], nn.ReLU)
    ll = nn.LayerList([nn.Linear(2, 2)])
    ll.append(nn.ReLU())
    ll.insert(0, nn.Tanh())
    ll.extend([nn.Sigmoid()])
    assert [type(m).__name__ for m in ll] == ["Tanh", "Linear", "ReLU",
                                              "Sigmoid"]
    ld = nn.LayerDict({"p": nn.ReLU()})
    ld["q"] = nn.Linear(1, 1)
    assert list(ld.keys()) == ["p", "q"] and "q" in ld
    pl = nn.ParameterList([torch.nn.Parameter(torch.ones(2))])
    pl.append(torch.nn.Parameter(torch.zeros(3)))
    assert len(pl) == 2 and len(nn.Layer.parameters(pl)) == 2
    jseq = jnn.Sequential(("a", jnn.Linear(2, 3)), ("b", jnn.ReLU()))
    assert sorted(jseq.state_dict()) == sorted(seq.state_dict())


def test_forward_post_hook_and_sublayers():
    net = nn.Sequential(nn.Linear(2, 2), nn.ReLU())
    h = net.register_forward_post_hook(lambda m, i, o: o * 0 + 3)
    assert float(net(torch.ones(1, 2))[0, 0]) == 3.0
    h.remove()
    assert len(net.sublayers()) == 2
    assert len(net.sublayers(include_self=True)) == 3


# -- the oracle cases of tests/test_nn_layers.py ----------------------------
def test_linear_shapes_and_grad():
    layer = nn.Linear(8, 4)
    out = layer(torch.rand(2, 8))
    assert tuple(out.shape) == (2, 4)
    out.sum().backward()
    assert tuple(layer.weight.grad.shape) == (8, 4)
    assert tuple(layer.bias.grad.shape) == (4,)


def test_conv2d_matches_naive():
    layer = nn.Conv2D(2, 3, 3, padding=1)
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 2, 5, 5)
                         .astype(np.float32))
    out = layer(x)
    assert tuple(out.shape) == (1, 3, 5, 5)
    w, b = layer.weight.detach().numpy(), layer.bias.detach().numpy()
    xp = np.pad(x.numpy(), [(0, 0), (0, 0), (1, 1), (1, 1)])
    naive = np.zeros((1, 3, 5, 5), np.float32)
    for o in range(3):
        for i in range(5):
            for j in range(5):
                naive[0, o, i, j] = (xp[0, :, i:i + 3, j:j + 3]
                                     * w[o]).sum() + b[o]
    np.testing.assert_allclose(out.detach().numpy(), naive, rtol=1e-5,
                               atol=1e-5)
    out.mean().backward()
    assert layer.weight.grad is not None


def test_batchnorm_train_eval():
    bn = nn.BatchNorm2D(4)
    x = torch.from_numpy(np.random.RandomState(1).rand(8, 4, 3, 3)
                         .astype(np.float32) * 5 + 2)
    bn.train()
    o = bn(x).detach().numpy()
    assert abs(o.mean()) < 1e-4
    assert abs(o.std() - 1.0) < 1e-2
    assert abs(float(bn._mean.mean())) > 1e-4
    bn.eval()
    assert tuple(bn(x).shape) == (8, 4, 3, 3)


def test_layernorm_values():
    ln = nn.LayerNorm(6)
    x = np.random.RandomState(2).rand(3, 6).astype(np.float32) * 4
    out = ln(torch.from_numpy(x)).detach().numpy()
    want = (x - x.mean(-1, keepdims=True)) / np.sqrt(
        x.var(-1, keepdims=True) + 1e-5)
    np.testing.assert_allclose(out, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_is_the_functional(dtype):
    """nn.LayerNorm and F.layer_norm share one precision rule: off the
    card a bf16 input is normalised in f32 and rounded once."""
    import paddle_tpu_torch.nn.functional as F

    ln = nn.LayerNorm(6)
    with torch.no_grad():
        ln.weight.copy_(torch.linspace(0.5, 1.5, 6))
        ln.bias.copy_(torch.linspace(-1, 1, 6))
    x = torch.from_numpy(np.random.RandomState(3).randn(4, 6).astype(
        np.float32) * 3).to(dtype)
    out = ln(x)
    assert out.dtype == dtype
    assert torch.equal(out, F.layer_norm(x, 6, ln.weight, ln.bias))
    want = torch.nn.functional.layer_norm(
        x.float(), (6,), ln.weight.float(), ln.bias.float(), 1e-5).to(dtype)
    assert torch.equal(out, want)


def test_embedding_padding_idx():
    emb = nn.Embedding(10, 4, padding_idx=0)
    ids = torch.tensor([[0, 3], [5, 0]])
    out = emb(ids)
    assert tuple(out.shape) == (2, 2, 4)
    np.testing.assert_allclose(out.detach().numpy()[0, 0], np.zeros(4),
                               atol=1e-7)
    assert float(emb.weight[0].abs().sum()) == 0.0
    out.sum().backward()
    assert float(emb.weight.grad[0].abs().sum()) == 0.0


def test_dropout_train_eval():
    do = nn.Dropout(0.5)
    x = torch.ones(100, 100)
    do.train()
    y = do(x).numpy()
    assert (y == 0).mean() > 0.3
    assert abs(y.mean() - 1.0) < 0.1
    do.eval()
    np.testing.assert_allclose(do(x).numpy(), 1.0)


def test_sequential_and_state_dict():
    net = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
    sd = net.state_dict()
    assert set(sd.keys()) == {"0.weight", "0.bias", "2.weight", "2.bias"}
    net2 = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
    net2.set_state_dict({k: v.numpy() for k, v in sd.items()})
    x = torch.rand(3, 4)
    np.testing.assert_allclose(net(x).detach().numpy(),
                               net2(x).detach().numpy(), rtol=1e-6)


def test_parameter_registration_and_named():
    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(2, 2)
            self.w = self.create_parameter([3])

        def forward(self, x):
            return self.fc(x)

    net = Net()
    names = [n for n, _ in net.named_parameters()]
    assert "w" in names and "fc.weight" in names and "fc.bias" in names
    assert len(net.parameters()) == 3


def test_train_eval_propagates():
    net = nn.Sequential(nn.Linear(2, 2), nn.Dropout(0.5))
    net.eval()
    assert not net[1].training
    net.train()
    assert net[1].training
