"""Common layers (mirrors ``paddle_tpu/nn/layer/common.py``): ``Linear``,
``Embedding``, the dropouts, ``Flatten``, ``Identity``, the pads,
``Upsample``, ``Bilinear``, ``CosineSimilarity``, ``PixelShuffle``,
``Fold``/``Unfold`` and ``PairwiseDistance``.

``Linear`` keeps the reference's ``weight [in, out]`` layout and applies
``x @ W + b``, so weights carry across from the JAX package without a
transpose. Parameters are made through ``framework.lazy.parameter``:
abstract under ``LazyGuard``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...framework.lazy import parameter
from .. import functional as F
from .. import initializer as I
from .layers import Layer, layer_device


class Linear(nn.Module):
    """``y = x @ weight + bias`` with ``weight [in_features, out_features]``."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr: Optional[I.Initializer] = None,
                 has_bias: bool = True, device=None):
        super().__init__()
        dev = layer_device(device)
        self.weight = parameter((in_features, out_features),
                                weight_attr or I.Normal(0.0, 0.02), dev)
        if has_bias:
            self.bias = parameter((out_features,), I.Constant(0.0), dev)
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.weight
        return y if self.bias is None else y + self.bias


class Embedding(nn.Module):
    """Row lookup into ``weight [num_embeddings, embedding_dim]``. With
    ``padding_idx`` (negative: from the end) that row starts at zero and
    looks up as zero, with no gradient, as in the reference."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr: Optional[I.Initializer] = None, device=None,
                 padding_idx: Optional[int] = None):
        super().__init__()
        dev = layer_device(device)
        self._padding_idx = padding_idx if padding_idx is None or \
            padding_idx >= 0 else num_embeddings + padding_idx
        init = weight_attr or I.Normal(0.0, 0.02)
        if self._padding_idx is not None:
            init = _ZeroRow(init, self._padding_idx)
        self.weight = parameter((num_embeddings, embedding_dim), init, dev)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self._padding_idx is None:
            return self.weight[ids]
        return F.embedding(ids, self.weight, self._padding_idx)


class _ZeroRow(I.Initializer):
    """``init``, then row ``row`` set to zero."""

    def __init__(self, init, row):
        self.init, self.row = init, row

    def __call__(self, t, generator=None):
        self.init(t, generator)
        with torch.no_grad():
            t[self.row] = 0
        return t


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Pad1D(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value,
                     self.data_format)


class Pad2D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format, name)


class Pad3D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format, name)


class ZeroPad2D(Pad2D):
    pass


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.align_mode, self.data_format = align_mode, data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, device=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr,
            device=device)
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True, device=device)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.kernel_sizes, self.strides = kernel_sizes, strides
        self.paddings, self.dilations = paddings, dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)


class Fold(Layer):
    """col2im, the transpose of ``Unfold`` (overlaps sum)."""

    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes, self.kernel_sizes = output_sizes, kernel_sizes
        self.strides, self.paddings = strides, paddings
        self.dilations = dilations

    def forward(self, x):
        return F.fold(x, self.output_sizes, self.kernel_sizes, self.strides,
                      self.paddings, self.dilations)


class PairwiseDistance(Layer):
    """The p-norm of ``x - y + epsilon`` over the last dim, in f32."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        d = (x - y).float() + self.epsilon
        out = torch.linalg.vector_norm(d.abs(), ord=self.p, dim=-1,
                                       keepdim=self.keepdim)
        return out.to(x.dtype)
