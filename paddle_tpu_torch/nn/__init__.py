"""``paddle.nn`` of the port (mirrors ``paddle_tpu.nn``): the ``Layer``
base and its containers, conv 1-D/2-D/3-D and their transposes, pooling,
the activations, the norms (the batch norms with the reference's
buffers and momentum), the losses, the common layers, the initializers,
the functionals and the gradient-clip configs. ``Linear`` keeps the
reference's ``[in, out]`` weight; every layer's parameter and buffer
names are the reference's, so a model's ``state_dict`` carries across
with ``models.gpt.load_reference_state``.

Not in this package yet: the recurrent and transformer layers, the
decoders and ``nn.utils`` (ROADMAP queue 1 item 9), and
``functional/vision.py`` (item 9b-2)."""
from ..framework.param_attr import ParamAttr
from . import functional, initializer
from .layer.activation import (CELU, ELU, GELU, SELU, Hardshrink,
                               Hardsigmoid, Hardswish, Hardtanh, LeakyReLU,
                               LogSigmoid, LogSoftmax, Maxout, Mish, PReLU,
                               ReLU, ReLU6, Sigmoid, Silu, Softmax, Softplus,
                               Softshrink, Softsign, Swish, Tanh, Tanhshrink,
                               ThresholdedReLU)
from .layer.common import (AlphaDropout, Bilinear, CosineSimilarity, Dropout,
                           Dropout2D, Dropout3D, Embedding, Flatten, Fold,
                           Identity, Linear, Pad1D, Pad2D, Pad3D,
                           PairwiseDistance, PixelShuffle, Unfold, Upsample,
                           UpsamplingBilinear2D, UpsamplingNearest2D,
                           ZeroPad2D)
from .layer.container import LayerDict, LayerList, ParameterList, Sequential
from .layer.conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose,
                         Conv3D, Conv3DTranspose)
from .layer.layers import Layer, device_scope
from .layer.loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,
                         CrossEntropyLoss, CTCLoss, HingeEmbeddingLoss,
                         HSigmoidLoss, KLDivLoss, L1Loss, MarginRankingLoss,
                         MSELoss, NLLLoss, SmoothL1Loss, TripletMarginLoss)
from .layer.norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                         GroupNorm, InstanceNorm1D, InstanceNorm2D,
                         InstanceNorm3D, LayerNorm, LocalResponseNorm,
                         RMSNorm, SpectralNorm, SyncBatchNorm)
from .layer.pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                            AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                            AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                            AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D,
                            MaxPool3D)


class ClipGradByNorm:
    """Clip each gradient to L2 norm ``clip_norm`` (applied by
    ``optimizer.clip``)."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm


class ClipGradByGlobalNorm:
    """Scale all gradients by ``min(1, clip_norm / global L2 norm)``
    (reference: fluid/clip.py GradientClipByGlobalNorm)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm
        self.group_name = group_name


class ClipGradByValue:
    """Clamp every gradient element to ``[min, max]``."""

    def __init__(self, max, min=None):  # noqa: A002
        self.max = max
        self.min = -max if min is None else min
