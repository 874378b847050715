"""Activation layers, thin wrappers over the functionals (mirrors
``paddle_tpu/nn/layer/activation.py``). ``ReLU`` is also a
``torch.nn.ReLU``, so that the int8 chain fusion (``quantization``)
finds it between two int8 linears."""
from __future__ import annotations

from torch import nn

from .. import functional as F
from .. import initializer as I
from .layers import Layer


def _make(fname, cls_name, bases=(Layer,)):
    fn = getattr(F, fname)

    def __init__(self, *args, **kwargs):
        Layer.__init__(self)
        self._args = args
        self._kwargs = dict(kwargs)
        self._kwargs.pop("name", None)

    def forward(self, x):
        return fn(x, *self._args, **self._kwargs)

    return type(cls_name, bases, {"__init__": __init__, "forward": forward})


ReLU = _make("relu", "ReLU", (Layer, nn.ReLU))
ReLU6 = _make("relu6", "ReLU6")
Sigmoid = _make("sigmoid", "Sigmoid")
Tanh = _make("tanh", "Tanh")
GELU = _make("gelu", "GELU")
LeakyReLU = _make("leaky_relu", "LeakyReLU")
ELU = _make("elu", "ELU")
SELU = _make("selu", "SELU")
CELU = _make("celu", "CELU")
Hardtanh = _make("hardtanh", "Hardtanh")
Hardshrink = _make("hardshrink", "Hardshrink")
Softshrink = _make("softshrink", "Softshrink")
Hardsigmoid = _make("hardsigmoid", "Hardsigmoid")
Hardswish = _make("hardswish", "Hardswish")
Softplus = _make("softplus", "Softplus")
Softsign = _make("softsign", "Softsign")
Swish = _make("swish", "Swish")
Silu = _make("silu", "Silu")
Mish = _make("mish", "Mish")
Tanhshrink = _make("tanhshrink", "Tanhshrink")
ThresholdedReLU = _make("thresholded_relu", "ThresholdedReLU")
LogSigmoid = _make("log_sigmoid", "LogSigmoid")
Softmax = _make("softmax", "Softmax")
LogSoftmax = _make("log_softmax", "LogSoftmax")
Maxout = _make("maxout", "Maxout")


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, device=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init), device=device)

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)
