"""Convolution layers (mirrors ``paddle_tpu/nn/layer/conv.py``).

The reference's parameter names and layouts: ``weight [out, in/groups,
*k]`` (a transpose's ``[in, out/groups, *k]``) and ``bias [out]``, both
drawn from ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` with ``fan_in =
in/groups · prod(k)`` unless ``weight_attr``/``bias_attr`` say otherwise
(``bias_attr=False``: no bias). The private attributes (``_stride``,
``_padding``, ...) are the reference's, which the quantized conv reads.
"""
from __future__ import annotations

import numpy as np

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


def _ntuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, n, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 transpose=False, output_padding=0, device=None):
        super().__init__()
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, n)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._n = n
        self._transpose = transpose
        self._output_padding = output_padding
        if transpose:
            w_shape = (in_channels, out_channels // groups) + \
                self._kernel_size
        else:
            w_shape = (out_channels, in_channels // groups) + \
                self._kernel_size
        fan_in = in_channels // groups * int(np.prod(self._kernel_size))
        k = 1.0 / np.sqrt(fan_in)
        self.weight = self.create_parameter(
            w_shape, attr=weight_attr, default_initializer=I.Uniform(-k, k),
            device=device)
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=I.Uniform(-k, k), device=device)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}, "
                f"stride={self._stride}, padding={self._padding}")


def _conv_layer(name, n, fn, default_format):
    class _Conv(_ConvNd):
        def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                     padding=0, dilation=1, groups=1, padding_mode="zeros",
                     weight_attr=None, bias_attr=None,
                     data_format=default_format, device=None):
            super().__init__(in_channels, out_channels, kernel_size, n,
                             stride, padding, dilation, groups, padding_mode,
                             weight_attr, bias_attr, data_format,
                             device=device)

        def forward(self, x):
            return fn(x, self.weight, self.bias, self._stride, self._padding,
                      self._dilation, self._groups, self._data_format)

    _Conv.__name__ = _Conv.__qualname__ = name
    return _Conv


def _conv_t_layer(name, n, fn, default_format):
    class _ConvT(_ConvNd):
        def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                     padding=0, output_padding=0, groups=1, dilation=1,
                     weight_attr=None, bias_attr=None,
                     data_format=default_format, device=None):
            super().__init__(in_channels, out_channels, kernel_size, n,
                             stride, padding, dilation, groups, "zeros",
                             weight_attr, bias_attr, data_format,
                             transpose=True, output_padding=output_padding,
                             device=device)

        def forward(self, x, output_size=None):
            return fn(x, self.weight, self.bias, self._stride, self._padding,
                      self._output_padding, self._groups, self._dilation,
                      output_size, self._data_format)

    _ConvT.__name__ = _ConvT.__qualname__ = name
    return _ConvT


Conv1D = _conv_layer("Conv1D", 1, F.conv1d, "NCL")
Conv2D = _conv_layer("Conv2D", 2, F.conv2d, "NCHW")
Conv3D = _conv_layer("Conv3D", 3, F.conv3d, "NCDHW")
Conv1DTranspose = _conv_t_layer("Conv1DTranspose", 1, F.conv1d_transpose,
                                "NCL")
Conv2DTranspose = _conv_t_layer("Conv2DTranspose", 2, F.conv2d_transpose,
                                "NCHW")
Conv3DTranspose = _conv_t_layer("Conv3DTranspose", 3, F.conv3d_transpose,
                                "NCDHW")
