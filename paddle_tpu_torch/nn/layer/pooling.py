"""Pooling layers (mirrors ``paddle_tpu/nn/layer/pooling.py``). As in
the reference, a pool layer passes its kernel, stride and padding on and
keeps its other arguments unread."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D"]


class _PoolNd(Layer):
    _fn = None

    def __init__(self, kernel_size=None, stride=None, padding=0, **kw):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.kw = kw

    def forward(self, x):
        return type(self)._fn(x, self.kernel_size, self.stride, self.padding)


def _pool_layer(name, fn):
    return type(name, (_PoolNd,), {"_fn": staticmethod(fn)})


MaxPool1D = _pool_layer("MaxPool1D", F.max_pool1d)
MaxPool2D = _pool_layer("MaxPool2D", F.max_pool2d)
MaxPool3D = _pool_layer("MaxPool3D", F.max_pool3d)
AvgPool1D = _pool_layer("AvgPool1D", F.avg_pool1d)
AvgPool2D = _pool_layer("AvgPool2D", F.avg_pool2d)
AvgPool3D = _pool_layer("AvgPool3D", F.avg_pool3d)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size, self.data_format)


class _AdaptiveMax(Layer):
    _fn = None

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return type(self)._fn(x, self.output_size)


AdaptiveMaxPool1D = type("AdaptiveMaxPool1D", (_AdaptiveMax,),
                         {"_fn": staticmethod(F.adaptive_max_pool1d)})
AdaptiveMaxPool2D = type("AdaptiveMaxPool2D", (_AdaptiveMax,),
                         {"_fn": staticmethod(F.adaptive_max_pool2d)})
AdaptiveMaxPool3D = type("AdaptiveMaxPool3D", (_AdaptiveMax,),
                         {"_fn": staticmethod(F.adaptive_max_pool3d)})
