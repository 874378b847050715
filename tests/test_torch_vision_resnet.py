"""The port's LeNet, ResNet-18 and ResNet-50
(``paddle_tpu_torch/vision/models``) held against the JAX package's on
the CPU. Each port model gets the reference model's whole ``state_dict``
(parameters and the batch norms' ``_mean``/``_variance``) through
``load_reference_state``; both run the same seeded ``[2, 3, 32, 32]``
batch (LeNet ``[2, 1, 28, 28]``) with ``num_classes`` 10. LeNet's state is
the reference's own initialisation; a ResNet's is the port's, set into
the reference model built under ``LazyGuard`` (the reference's eager
initializers compile an XLA program a parameter shape):

- the whole model in eval mode: the logits and every parameter's
  gradient of ``sum(logits · ct)``; LeNet in train mode too;
- ResNet in train mode layer by layer: one training-mode forward of the
  reference records the input of every conv, batch norm, pool and linear
  layer; each port layer, fed that input, gives the reference layer's
  output, its input's and parameters' gradients under a seeded
  cotangent, and (a batch norm) its running ``_mean``/``_variance``
  after the forward — so every layer the training step runs is held,
  with the inputs the model gives it.

All at rtol 1e-5, atol 1e-5 (gradients relative to the largest of their
tensor, at least 1). Why train mode goes layer by layer: at 32² layer4's
batch norms see 1x1 maps, two values a channel, and normalise them with
gain ``1/sqrt(var + eps)`` up to ``1/sqrt(eps)`` = 316, forward and
backward; two implementations whose convs sum in other orders (XLA's and
oneDNN's, 1e-6 apart) differ by up to that gain times as much after each
such norm, and the whole train-mode ResNet-50 compounds it (its logits
2.4 apart, measured; eval mode, where the norms use fixed statistics,
agrees to 4e-6). The models' ``state_dict`` names are the reference's,
and ``pretrained=True`` raises.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision import models as jm
from paddle_tpu_torch.models.gpt import load_reference_state
from paddle_tpu_torch.vision import models as tm
from _torch_nn_oracle import TOL, arr, paired_models


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grad_close(got, want, name):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                               atol=TOL["atol"], err_msg=name)


_NETS = {}


def _nets(name):
    """The reference model and the port's with one state, built once a
    module and put back to that state for each test: LeNet's state is the
    reference's own from a seed; a ResNet's is the port's, given to the
    reference built abstract (``paired_models``: the reference's eager
    initializers would take about 18 s a ResNet here)."""
    if name not in _NETS:
        if name == "lenet":
            paddle.seed(11)
            jnet = jm.LeNet()
            state = {k: np.asarray(v._value).copy()
                     for k, v in jnet.state_dict().items()}
            tnet = tm.LeNet(device="cpu")
            assert sorted(tnet.state_dict()) == sorted(state)
        else:
            jnet, tnet = paired_models(name, 11, num_classes=10)
            state = {k: np.asarray(v._value).copy()
                     for k, v in jnet.state_dict().items()}
        _NETS[name] = (jnet, tnet, state)
    jnet, tnet, state = _NETS[name]
    jnet.set_state_dict(state)
    load_reference_state(tnet, state)
    jnet.train()
    tnet.train()
    return jnet, tnet


def _compare(jfn, tfn, jmods, tmods, x, seed, what):
    """``jfn``/``tfn`` on ``x``: output, input gradient, the gradients of
    the parameters and the buffers of ``jmods``/``tmods`` (paired
    layers)."""
    for jmod, tmod in zip(jmods, tmods):
        for p in jmod.parameters():
            p.clear_gradient()
        tmod.clear_gradients() if hasattr(tmod, "clear_gradients") else \
            tmod.zero_grad(set_to_none=True)
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    jo, to = jfn(jx), tfn(tx)
    jv = np.asarray(jo.numpy())
    _grad_close(to.detach().numpy(), jv, f"{what} output")
    ct = arr(jv.shape, seed)
    (jo * paddle.to_tensor(ct)).sum().backward()
    (to * torch.from_numpy(ct)).sum().backward()
    _grad_close(tx.grad.numpy(), np.asarray(jx.grad.numpy()),
                f"{what} input grad")
    for jmod, tmod in zip(jmods, tmods):
        jp = dict(jmod.named_parameters())
        for n, p in tmod.named_parameters():
            _grad_close(p.grad.numpy(), np.asarray(jp[n].grad.numpy()),
                        f"{what} grad {n}")
        jb = dict(jmod.named_buffers())
        for n, b in tmod.named_buffers():
            np.testing.assert_allclose(b.numpy(), np.asarray(jb[n].numpy()),
                                       err_msg=f"{what} {n}", **TOL)
    return jv


def _compare_compiled(jnet, tnet, x, seed, what):
    """The whole model in eval mode: the reference's logits and the
    gradients of ``sum(logits · ct)`` as compiled programs
    (``static.functional_call`` under ``jax.jit`` and ``jax.vjp``; the
    eager model compiles an XLA program an op, about 20 s for ResNet-50
    here, and agrees with the compiled one to 2e-8) against the port's:
    the logits, the input's and every parameter's gradient, and the
    buffers, which eval mode leaves as they are."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.static.functional import functional_call, state_tensors

    pn, pt, bn, bt = state_tensors(jnet)
    bv = [b._value for b in bt]

    @jax.jit
    def logits(pv, xv):
        return functional_call(jnet, pv, bv, (paddle.Tensor(xv),),
                               training=False)[0]

    jo, vjp = jax.vjp(logits, [p._value for p in pt], jnp.asarray(x))
    jv = np.asarray(jo)
    ct = arr(jv.shape, seed)
    gp, gx = vjp(jnp.asarray(ct))
    tnet.zero_grad(set_to_none=True)
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    to = tnet(tx)
    _grad_close(to.detach().numpy(), jv, f"{what} output")
    (to * torch.from_numpy(ct)).sum().backward()
    _grad_close(tx.grad.numpy(), np.asarray(gx), f"{what} input grad")
    jp = dict(zip(pn, gp))
    tp = dict(tnet.named_parameters())
    assert sorted(tp) == sorted(jp)
    for n, p in tp.items():
        _grad_close(p.grad.numpy(), np.asarray(jp[n]), f"{what} grad {n}")
    jb = dict(zip(bn, bv))
    for n, b in tnet.named_buffers():
        np.testing.assert_allclose(b.numpy(), np.asarray(jb[n]),
                                   err_msg=f"{what} {n}", **TOL)


def _record_layer_inputs(jnet, x):
    """{layer name: its input} of one training-mode forward of the
    reference over ``x`` (its state restored afterwards)."""
    from paddle_tpu.nn import AdaptiveAvgPool2D, BatchNorm2D, Conv2D, \
        Linear, MaxPool2D

    state = {k: np.asarray(v._value) for k, v in jnet.state_dict().items()}
    seen, hooks = {}, []
    for name, layer in jnet.named_sublayers():
        if isinstance(layer, (Conv2D, BatchNorm2D, Linear, MaxPool2D,
                              AdaptiveAvgPool2D)):
            hooks.append(layer.register_forward_pre_hook(
                lambda lay, inputs, name=name: seen.__setitem__(
                    name, np.asarray(inputs[0].numpy()))))
    jnet.train()
    jnet(paddle.to_tensor(x))
    for h in hooks:
        h.remove()
    jnet.set_state_dict(state)
    return seen


@pytest.mark.parametrize("name", ["lenet", "resnet18", "resnet50"])
def test_model_eval_matches_reference(name):
    jnet, tnet = _nets(name)
    jnet.eval()
    tnet.eval()
    xs = (2, 1, 28, 28) if name == "lenet" else (2, 3, 32, 32)
    _compare_compiled(jnet, tnet, arr(xs, 2), 12, f"{name} eval")


@pytest.mark.parametrize("name", ["lenet", "resnet18", "resnet50"])
def test_model_train_matches_reference(name):
    jnet, tnet = _nets(name)
    if name == "lenet":
        _compare(jnet, tnet, [jnet], [tnet], arr((2, 1, 28, 28), 1), 11,
                 "lenet train")
        return
    inputs = _record_layer_inputs(jnet, arr((2, 3, 32, 32), 1))
    jl = dict(jnet.named_sublayers())
    tl = dict(tnet.named_sublayers())
    kinds = set()
    for i, (n, x) in enumerate(inputs.items()):
        jl[n].train()
        tl[n].train()
        kinds.add(type(tl[n]).__name__)
        _compare(jl[n], tl[n], [jl[n]], [tl[n]], x, 30 + i,
                 f"{name} train {n}")
    assert kinds == {"Conv2D", "BatchNorm2D", "Linear", "MaxPool2D",
                     "AdaptiveAvgPool2D"}
    n_norms = sum(1 for m in tnet.modules()
                  if type(m).__name__ == "BatchNorm2D")
    assert sum(1 for n in inputs if "bn" in n or "downsample.1" in n) == \
        n_norms


def test_pretrained_raises_and_blocks_are_the_reference_blocks():
    with pytest.raises(ValueError, match="pretrained"):
        tm.resnet50(pretrained=True, device="cpu")
    net = tm.resnet34(num_classes=0, with_pool=False, device="cpu")
    assert isinstance(net.layer1[0], tm.BasicBlock)
    assert tuple(net(torch.zeros(1, 3, 64, 64)).shape) == (1, 512, 2, 2)
    assert len(net.layer3) == 6
