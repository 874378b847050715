"""Loss functionals (mirrors ``paddle_tpu/nn/functional/loss.py``;
reference: python/paddle/nn/functional/loss.py, kernels
operators/softmax_with_cross_entropy_op.cu). Each is the reference's
formula in PyTorch operations: its clips, its reductions (``"mean"``,
``"sum"``, ``"none"``, ``kl_div``'s ``"batchmean"``) and, for
``cross_entropy``, its label forms (``[N]`` or ``[N, 1]`` indices, soft
labels), ``ignore_index`` (clipped before the gather, masked after),
``weight`` (a weighted mean over the kept labels' weights) and
``use_softmax=False`` (the input is a probability)."""
from __future__ import annotations

import torch
from torch.nn import functional as TF

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "nll_loss",
           "mse_loss", "l1_loss", "smooth_l1_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss",
           "sigmoid_focal_loss", "square_error_cost", "log_loss", "ctc_loss",
           "dice_loss", "npair_loss", "hsigmoid_loss"]


def _reduce_loss(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    logp = torch.log_softmax(input, dim=axis) if use_softmax else \
        torch.log(torch.clamp(input, min=1e-30))
    if soft_label:
        return _reduce_loss(-(label * logp).sum(dim=axis), reduction)
    ax = axis % logp.dim()
    idx = label.long()
    if idx.dim() == logp.dim():
        idx = idx.squeeze(ax)
    mask = idx != ignore_index
    safe = idx.clamp(0, logp.shape[ax] - 1)
    loss = -logp.gather(ax, safe.unsqueeze(ax)).squeeze(ax)
    loss = torch.where(mask, loss, torch.zeros_like(loss))
    if weight is not None:
        w = weight[safe]
        loss = loss * w
        if reduction == "mean":
            return torch.where(mask, loss, torch.zeros_like(loss)).sum() / \
                torch.clamp((w * mask).sum(), min=1e-12)
    elif reduction == "mean":
        return loss.sum() / torch.clamp(mask.sum(), min=1)
    return _reduce_loss(loss, reduction)


softmax_with_cross_entropy = cross_entropy


def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean", name=None):
    lbl = label.long()
    loss = -input.gather(1, lbl[:, None])[:, 0]
    if weight is not None:
        loss = loss * weight[lbl]
    return _reduce_loss(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return _reduce_loss((input - label) ** 2, reduction)


def l1_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return _reduce_loss((input - label).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0,  # noqa: A002
                   name=None):
    d = (input - label).abs()
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce_loss(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",  # noqa: A002
                         name=None):
    p = torch.clamp(input, 1e-12, 1.0 - 1e-12)
    loss = -(label * torch.log(p) + (1 - label) * torch.log(1 - p))
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    z, y = logit, label
    if pos_weight is None:
        loss = torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs()))
    else:
        loss = -(pos_weight * y * TF.logsigmoid(z)
                 + (1 - y) * TF.logsigmoid(-z))
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


def kl_div(input, label, reduction="mean", name=None):  # noqa: A002
    loss = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce_loss(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",  # noqa: A002
                        name=None):
    return _reduce_loss(torch.clamp(-label * (input - other) + margin,
                                    min=0.0), reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",  # noqa: A002
                         name=None):
    return _reduce_loss(torch.where(label == 1, input,
                                    torch.clamp(margin - input, min=0.0)),
                        reduction)


def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean",
                          name=None):
    cos = (input1 * input2).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), min=1e-12)
    loss = torch.where(label == 1, 1 - cos, torch.clamp(cos - margin,
                                                        min=0.0))
    return _reduce_loss(loss, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,  # noqa: A002
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def dist(a, b):
        return torch.linalg.vector_norm(a - b + epsilon, ord=p, dim=-1)

    dp, dn = dist(input, positive), dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce_loss(torch.clamp(dp - dn + margin, min=0.0), reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    z, y = logit, label
    p = torch.sigmoid(z)
    ce = torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs()))
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    loss = a_t * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce_loss(loss, reduction)


def square_error_cost(input, label):  # noqa: A002
    return (input - label) ** 2


def log_loss(input, label, epsilon=1e-4, name=None):  # noqa: A002
    return -label * torch.log(input + epsilon) \
        - (1 - label) * torch.log(1 - input + epsilon)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC by the forward algorithm over time (reference:
    operators/warpctc_op.cc; the reference's scan, a loop here).
    ``log_probs [T, B, C]``, ``labels [B, S]``."""
    lp = log_probs
    t_len, b, _ = lp.shape
    s = labels.shape[1]
    lbl = labels.long()
    in_len = input_lengths.long().to(lp.device)
    lbl_len = label_lengths.long().to(lp.device)
    neg = torch.tensor(-1e30, dtype=lp.dtype, device=lp.device)
    ext = torch.full((b, 2 * s + 1), blank, dtype=torch.long,
                     device=lp.device)
    ext[:, 1::2] = lbl
    ext_len = 2 * lbl_len + 1
    rows = torch.arange(b, device=lp.device)
    alpha = torch.full((b, 2 * s + 1), -1e30, dtype=lp.dtype,
                       device=lp.device)
    first = torch.where(lbl_len > 0, lp[0, rows, ext[:, 1]], neg)
    alpha = torch.cat([lp[0, :, blank][:, None], first[:, None],
                       alpha[:, 2:]], 1)
    ext_shift2 = torch.cat([torch.full((b, 2), -1, dtype=torch.long,
                                       device=lp.device), ext[:, :-2]], 1)
    allow_skip = (ext != blank) & (ext != ext_shift2)
    for t in range(1, t_len):
        a1 = torch.cat([neg.expand(b, 1), alpha[:, :-1]], 1)
        a2 = torch.cat([neg.expand(b, 2), alpha[:, :-2]], 1)
        merged = torch.logaddexp(alpha, a1)
        merged = torch.where(allow_skip, torch.logaddexp(merged, a2), merged)
        new = merged + lp[t].gather(1, ext)
        alpha = torch.where((t < in_len)[:, None], new, alpha)
    last = (ext_len - 1).clamp(0, 2 * s)
    prev = (ext_len - 2).clamp(0, 2 * s)
    ll = torch.logaddexp(alpha.gather(1, last[:, None])[:, 0],
                         alpha.gather(1, prev[:, None])[:, 0])
    loss = -ll
    if reduction == "mean":
        return (loss / torch.clamp(lbl_len, min=1)).mean()
    return _reduce_loss(loss, reduction)


def dice_loss(input, label, epsilon=1e-5, name=None):  # noqa: A002
    lbl = label.squeeze(-1) if label.shape[-1] == 1 else label
    lv = TF.one_hot(lbl.long(), input.shape[-1]).to(input.dtype)
    axes = tuple(range(1, input.dim()))
    inter = (input * lv).sum(axes)
    denom = input.sum(axes) + lv.sum(axes)
    return (1.0 - 2.0 * inter / (denom + epsilon)).mean()


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    n = labels.shape[0]
    lv = labels.reshape(n, 1)
    soft = (lv == lv.t()).float()
    soft = soft / soft.sum(1, keepdim=True)
    l2 = ((anchor ** 2).sum(1).mean() + (positive ** 2).sum(1).mean()) \
        * 0.25 * l2_reg
    sim = (anchor @ positive.t()).float()
    ce = -(soft * torch.log_softmax(sim, -1)).sum(-1)
    return l2 + ce.mean()


def hsigmoid_loss(input, label, num_classes, weight, bias=None,  # noqa: A002
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss ``[N, 1]`` over the reference's implicit
    heap (leaf ``label + num_classes``; node row ``prefix - 1``, target
    the suffix bit) or a custom ``path_table``/``path_code``."""
    if num_classes < 2 and path_table is None:
        raise ValueError("num_classes must be >= 2 for the default tree")
    if path_table is None:
        c = label.long().reshape(-1) + num_classes
        js = torch.arange(int(num_classes).bit_length(), device=input.device)
        up = c[:, None] >> (js[None, :] + 1)
        valid = up > 0
        idx = torch.where(valid, up - 1, torch.zeros_like(up))
        bit = ((c[:, None] >> js[None, :]) & 1).float()
    else:
        pt = path_table.long()
        idx = pt.clamp(min=0)
        valid = pt >= 0
        bit = path_code.float()
    logits = torch.einsum("nlf,nf->nl", weight[idx].float(), input.float())
    if bias is not None:
        logits = logits + bias.reshape(-1)[idx].float()
    ce = torch.clamp(logits, min=0) - logits * bit \
        + torch.log1p(torch.exp(-logits.abs()))
    return torch.where(valid, ce, torch.zeros_like(ce)).sum(
        -1, keepdim=True).to(input.dtype)
