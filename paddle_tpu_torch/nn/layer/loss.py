"""Loss layers (mirrors ``paddle_tpu/nn/layer/loss.py``): each holds its
options and calls the functional."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["CrossEntropyLoss", "MSELoss", "L1Loss", "SmoothL1Loss",
           "NLLLoss", "BCELoss", "BCEWithLogitsLoss", "KLDivLoss",
           "MarginRankingLoss", "CTCLoss", "HingeEmbeddingLoss",
           "CosineEmbeddingLoss", "TripletMarginLoss", "HSigmoidLoss"]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__()
        self._weight = weight
        self.ignore_index, self.reduction = ignore_index, reduction
        self.soft_label, self.axis = soft_label, axis
        self.use_softmax = use_softmax

    def forward(self, input, label):  # noqa: A002
        return F.cross_entropy(input, label, self._weight, self.ignore_index,
                               self.reduction, self.soft_label, self.axis,
                               self.use_softmax)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.l1_loss(input, label, self.reduction)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction, self.delta = reduction, delta

    def forward(self, input, label):  # noqa: A002
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self._weight, self.ignore_index = weight, ignore_index
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.nll_loss(input, label, self._weight, self.ignore_index,
                          self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self._weight, self.reduction = weight, reduction

    def forward(self, input, label):  # noqa: A002
        return F.binary_cross_entropy(input, label, self._weight,
                                      self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self._weight, self.reduction = weight, reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self._weight, self.reduction, self.pos_weight)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.kl_div(input, label, self.reduction)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, other, label):  # noqa: A002
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, label):  # noqa: A002
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.margin, self.p, self.epsilon = margin, p, epsilon
        self.swap, self.reduction = swap, reduction

    def forward(self, input, positive, negative):  # noqa: A002
        return F.triplet_margin_loss(input, positive, negative, self.margin,
                                     self.p, self.epsilon, self.swap,
                                     self.reduction)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid over ``F.hsigmoid_loss``: the
    ``[num_classes - 1, feature_size]`` internal-node weights (``[num_classes,
    ...]`` for a custom tree) and their ``[n, 1]`` bias."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None, device=None):
        super().__init__()
        if not is_custom and num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        self.num_classes = num_classes
        self.is_custom = is_custom
        self.is_sparse = is_sparse
        n_nodes = num_classes if is_custom else num_classes - 1
        self.weight = self.create_parameter(
            [n_nodes, feature_size], attr=weight_attr, device=device)
        self.bias = self.create_parameter(
            [n_nodes, 1], attr=bias_attr, is_bias=True, device=device)

    def forward(self, input, label, path_table=None, path_code=None):  # noqa: A002
        if self.is_custom and path_table is None:
            raise ValueError("is_custom=True requires path_table/path_code")
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               bias=self.bias, path_table=path_table,
                               path_code=path_code, is_sparse=self.is_sparse)
