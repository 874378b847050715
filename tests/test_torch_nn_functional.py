"""The port's activation, loss and common functionals
(``paddle_tpu_torch/nn/functional/{activation,loss,common}.py``) held
against the JAX package's on the CPU: the same seeded numpy inputs, the
values and the gradients of ``sum(out · ct)`` with respect to every float
input at rtol 1e-5, atol 1e-5 in f32.

- every activation the reference's ``nn/__init__.py`` exports a layer of,
  with its options;
- every loss: ``cross_entropy`` with labels ``[N]`` and ``[N, 1]``, soft
  labels, ``ignore_index``, ``weight`` under each reduction, ``axis`` 1 and
  ``use_softmax=False``; the others with their reductions and options,
  ``ctc_loss`` and both trees of ``hsigmoid_loss`` included;
- common: ``linear``, ``embedding`` with ``padding_idx``, ``one_hot``,
  ``label_smooth``, ``pad`` in its four modes and three pad forms,
  ``interpolate`` (nearest, bilinear, bicubic; up and down, by size and
  by scale, channel-last), ``bilinear``, ``cosine_similarity``,
  ``pixel_shuffle``, ``unfold``/``fold`` and the dropouts at inference;
  the dropouts in training are held by rate and scale, not bit for bit
  (the masks come from another generator).
"""
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn.functional as TF
from _torch_nn_oracle import arr, check_pair


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ACT = [
    ("relu", {}), ("relu6", {}), ("sigmoid", {}), ("tanh", {}),
    ("silu", {}), ("swish", {}), ("mish", {}), ("tanhshrink", {}),
    ("log_sigmoid", {}), ("gelu", {}), ("gelu", dict(approximate=True)),
    ("leaky_relu", dict(negative_slope=0.2)), ("elu", dict(alpha=0.7)),
    ("selu", {}), ("celu", dict(alpha=1.3)), ("hardtanh", dict(min=-0.5,
                                                              max=0.7)),
    ("hardshrink", dict(threshold=0.3)), ("softshrink", dict(threshold=0.4)),
    ("hardsigmoid", {}), ("hardswish", {}), ("softplus", dict(beta=2.0)),
    ("softsign", {}), ("thresholded_relu", dict(threshold=0.5)),
    ("maxout", dict(groups=2)), ("softmax", dict(axis=1)),
    ("log_softmax", {}), ("glu", dict(axis=1)),
]


@pytest.mark.parametrize("fn,kw", ACT,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(ACT)])
def test_activation_matches_reference(fn, kw):
    x = arr((3, 4, 5), 1) * 3
    if fn == "softplus":
        x[0, 0, :2] = [12.0, 9.5]          # past the threshold at beta 2
    check_pair(getattr(JF, fn), getattr(TF, fn), [x], grads=(0,), kw=kw)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_prelu_matches_reference(fmt):
    x = arr((2, 3, 4, 4) if fmt == "NCHW" else (2, 4, 4, 3), 2)
    check_pair(JF.prelu, TF.prelu, [x, np.abs(arr((3,), 3)) * 0.3],
               grads=(0, 1), kw=dict(data_format=fmt))


def _labels(n, c, seed, shape=None):
    return arr(shape or (n,), seed, 0, c, np.int64)


def _ce_cases():
    x = arr((6, 5), 4)
    x3 = arr((4, 5, 3), 5)
    soft = np.abs(arr((6, 5), 6))
    soft /= soft.sum(-1, keepdims=True)
    lbl = _labels(6, 5, 7)
    lbl_ign = lbl.copy()
    lbl_ign[[1, 4]] = -100
    w = np.abs(arr((5,), 8)) + 0.1
    probs = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    return [
        ("index", [x, lbl], {}),
        ("index_n1", [x, lbl[:, None]], {}),
        ("soft", [x, soft], dict(soft_label=True)),
        ("ignore", [x, lbl_ign], {}),
        ("ignore_sum", [x, lbl_ign], dict(reduction="sum")),
        ("weight_mean", [x, lbl_ign, w], {}),
        ("weight_sum", [x, lbl, w], dict(reduction="sum")),
        ("weight_none", [x, lbl, w], dict(reduction="none")),
        ("none", [x, lbl], dict(reduction="none")),
        ("axis1", [x3, _labels(4, 5, 9, (4, 3))], dict(axis=1)),
        ("no_softmax", [probs.astype(np.float32), lbl],
         dict(use_softmax=False)),
    ]


CE = _ce_cases()


@pytest.mark.parametrize("i", range(len(CE)), ids=[c[0] for c in CE])
def test_cross_entropy_matches_reference(i):
    _, args, kw = CE[i]

    def call(mod):
        def f(x, lbl, w=None):
            return mod.cross_entropy(x, lbl, weight=w, **kw)
        return f

    check_pair(call(JF), call(TF), args, grads=(0,))


def _loss_cases():
    x, y = arr((6, 4), 10), arr((6, 4), 11)
    p = 1 / (1 + np.exp(-x))
    yb = arr((6, 4), 12, 0, 2, np.float32)
    sign = arr((6,), 13, 0, 2, np.float32) * 2 - 1
    logp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    tgt = np.abs(arr((6, 4), 14))
    tgt /= tgt.sum(-1, keepdims=True)
    return [
        ("nll_loss", [logp.astype(np.float32), _labels(6, 4, 15)], {}),
        ("nll_loss", [logp.astype(np.float32), _labels(6, 4, 15),
                      np.abs(arr((4,), 16))], dict(reduction="sum")),
        ("mse_loss", [x, y], {}), ("mse_loss", [x, y], dict(reduction="none")),
        ("l1_loss", [x, y], dict(reduction="sum")),
        ("smooth_l1_loss", [x, y], dict(delta=0.5)),
        ("binary_cross_entropy", [p.astype(np.float32), yb], {}),
        ("binary_cross_entropy", [p.astype(np.float32), yb,
                                  np.abs(arr((6, 4), 17))],
         dict(reduction="sum")),
        ("binary_cross_entropy_with_logits", [x, yb], {}),
        ("binary_cross_entropy_with_logits", [x, yb, None,
                                              np.abs(arr((4,), 18))], {}),
        ("kl_div", [logp.astype(np.float32), tgt.astype(np.float32)], {}),
        ("kl_div", [logp.astype(np.float32), tgt.astype(np.float32)],
         dict(reduction="batchmean")),
        ("margin_ranking_loss", [x[:, 0].copy(), y[:, 0].copy(), sign],
         dict(margin=0.3)),
        ("hinge_embedding_loss", [x, np.sign(y).astype(np.float32)],
         dict(margin=0.5)),
        ("cosine_embedding_loss", [x, y, sign], dict(margin=0.1)),
        ("triplet_margin_loss", [x, y, arr((6, 4), 19)], {}),
        ("triplet_margin_loss", [x, y, arr((6, 4), 19)],
         dict(swap=True, p=1.0, reduction="sum")),
        ("sigmoid_focal_loss", [x, yb], {}),
        ("sigmoid_focal_loss", [x, yb, np.float32(3.0) * np.ones(
            (1,), np.float32)], dict(reduction="mean")),
        ("square_error_cost", [x, y], {}),
        ("log_loss", [p.astype(np.float32), yb], {}),
        ("dice_loss", [np.abs(p).astype(np.float32),
                       _labels(6, 4, 20, (6, 1))], {}),
        ("npair_loss", [x, y, _labels(6, 3, 21).astype(np.float32)], {}),
    ]


LOSS = _loss_cases()


@pytest.mark.parametrize("i", range(len(LOSS)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LOSS)])
def test_loss_matches_reference(i):
    fn, args, kw = LOSS[i]
    if fn == "binary_cross_entropy_with_logits" and len(args) == 4:
        def call(mod):
            return lambda z, y, pw: mod.binary_cross_entropy_with_logits(
                z, y, pos_weight=pw, **kw)
        args = [args[0], args[1], args[3]]
        grads = (0,)
    elif fn == "sigmoid_focal_loss" and len(args) == 3:
        def call(mod):
            return lambda z, y, n: mod.sigmoid_focal_loss(
                z, y, normalizer=n, **kw)
        grads = (0,)
    else:
        def call(mod):
            return lambda *a: getattr(mod, fn)(*a, **kw)
        grads = tuple(i for i, a in enumerate(args)
                      if isinstance(a, np.ndarray) and a.dtype == np.float32
                      and not (fn in ("hinge_embedding_loss", "npair_loss",
                                      "cosine_embedding_loss",
                                      "margin_ranking_loss") and i == len(
                                          args) - 1)
                      and not (fn == "kl_div" and i == 1)
                      and not (fn in ("binary_cross_entropy",
                                      "binary_cross_entropy_with_logits",
                                      "sigmoid_focal_loss", "log_loss")
                               and i >= 1))
    check_pair(call(JF), call(TF), args, grads=grads)


def test_ctc_loss_matches_reference():
    t_len, b, c, s = 7, 3, 5, 3
    x = arr((t_len, b, c), 22)
    logp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    labels = arr((b, s), 23, 1, c, np.int64)
    in_len = np.array([7, 6, 5], np.int64)
    lbl_len = np.array([3, 2, 1], np.int64)
    for red in ("mean", "sum"):
        check_pair(lambda lp, *r: JF.ctc_loss(lp, *r, reduction=red),
                   lambda lp, *r: TF.ctc_loss(lp, *r, reduction=red),
                   [logp, labels, in_len, lbl_len], grads=(0,))


@pytest.mark.parametrize("tree", ["default", "custom"])
def test_hsigmoid_loss_matches_reference(tree):
    n, f, c = 5, 6, 7
    x, lbl = arr((n, f), 24), _labels(n, c, 25)
    if tree == "default":
        w, b = arr((c - 1, f), 26), arr((c - 1, 1), 27)
        check_pair(lambda x_, l_, w_, b_: JF.hsigmoid_loss(x_, l_, c, w_,
                                                           b_),
                   lambda x_, l_, w_, b_: TF.hsigmoid_loss(x_, l_, c, w_,
                                                           b_),
                   [x, lbl, w, b], grads=(0, 2, 3))
    else:
        w = arr((c, f), 28)
        table = arr((n, 3), 29, 0, c, np.int64)
        table[:, 2] = -1
        code = arr((n, 3), 30, 0, 2, np.int64)
        check_pair(lambda x_, l_, w_, t_, c_: JF.hsigmoid_loss(
                       x_, l_, c, w_, path_table=t_, path_code=c_),
                   lambda x_, l_, w_, t_, c_: TF.hsigmoid_loss(
                       x_, l_, c, w_, path_table=t_, path_code=c_),
                   [x, lbl, w, table, code], grads=(0, 2))


def _pad_cases():
    x4 = arr((2, 3, 4, 5), 31)
    return [(x4, [1, 2, 0, 1], m, "NCHW")
            for m in ("constant", "reflect", "replicate", "circular")] + [
        (x4, [1, 0, 2, 1], "reflect", "NHWC"),
        (arr((2, 3, 5), 32), [2, 1], "replicate", "NCL"),
        (arr((1, 2, 3, 4, 5), 33), [1, 1, 0, 2, 1, 0], "constant", "NCDHW"),
        (x4, [0, 0, 1, 0, 1, 2, 0, 1], "circular", "NCHW"),
        (x4, 1, "constant", "NCHW"),
    ]


PAD = _pad_cases()


@pytest.mark.parametrize("i", range(len(PAD)),
                         ids=[f"{c[2]}-{c[3]}-{i}" for i, c in enumerate(PAD)])
def test_pad_matches_reference(i):
    x, pad, mode, fmt = PAD[i]

    def call(mod):
        return lambda v: mod.pad(v, pad, mode=mode, value=0.5,
                                 data_format=fmt)

    check_pair(call(JF), call(TF), [x], grads=(0,))


INTERP = [
    ((2, 3, 4, 5), dict(size=[8, 7], mode="nearest")),
    ((2, 3, 8, 7), dict(size=[4, 3], mode="nearest")),
    ((2, 3, 4, 5), dict(size=[8, 10], mode="bilinear")),
    ((2, 3, 9, 7), dict(size=[4, 3], mode="bilinear")),
    ((2, 3, 4, 5), dict(scale_factor=2, mode="bicubic")),
    ((2, 3, 9, 9), dict(size=[4, 5], mode="bicubic")),
    ((2, 4, 5, 3), dict(size=[7, 3], mode="bilinear", data_format="NHWC")),
    ((2, 3, 6), dict(size=[9], mode="linear", data_format="NCW")),
    ((1, 2, 3, 4, 5), dict(scale_factor=[2, 1, 2], mode="trilinear",
                           data_format="NCDHW")),
    ((2, 3, 6, 6), dict(size=[4, 4], mode="area")),
]


@pytest.mark.parametrize("i", range(len(INTERP)),
                         ids=[f"{c[1]['mode']}-{i}" for i, c in
                              enumerate(INTERP)])
def test_interpolate_matches_reference(i):
    shape, kw = INTERP[i]
    check_pair(JF.interpolate, TF.interpolate, [arr(shape, 34)],
               grads=(0,), kw=kw)


COMMON = [
    ("linear", [(3, 4), (4, 5), (5,)], {}),
    ("bilinear", [(3, 4), (3, 5), (2, 4, 5), (2,)], {}),
    ("cosine_similarity", [(3, 6), (3, 6)], dict(axis=1)),
    ("cosine_similarity", [(2, 3, 4), (2, 3, 4)], dict(axis=-1)),
    ("pixel_shuffle", [(2, 8, 3, 3)], dict(upscale_factor=2)),
    ("pixel_shuffle", [(2, 3, 3, 8)], dict(upscale_factor=2,
                                           data_format="NHWC")),
    ("unfold", [(2, 3, 6, 6)], dict(kernel_sizes=3, strides=2, paddings=1)),
    ("unfold", [(2, 3, 6, 5)], dict(kernel_sizes=[2, 3], dilations=2)),
    ("fold", [(2, 27, 9)], dict(output_sizes=6, kernel_sizes=3, strides=2,
                                paddings=1)),
    ("label_smooth", [(4, 5)], dict(epsilon=0.2)),
    ("dropout", [(4, 5)], dict(p=0.3, training=False,
                               mode="downscale_in_infer")),
    ("dropout", [(4, 5)], dict(p=0.3, training=False)),
    ("alpha_dropout", [(4, 5)], dict(p=0.3, training=False)),
]


@pytest.mark.parametrize("i", range(len(COMMON)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(COMMON)])
def test_common_matches_reference(i):
    fn, shapes, kw = COMMON[i]
    args = [arr(s, 40 + j) for j, s in enumerate(shapes)]
    check_pair(lambda *a: getattr(JF, fn)(*a, **kw),
               lambda *a: getattr(TF, fn)(*a, **kw), args,
               grads=tuple(range(len(args))))


@pytest.mark.parametrize("pad", [None, 0, 3, -1])
def test_embedding_matches_reference(pad):
    w = arr((6, 4), 50)
    ids = np.array([[0, 3, 5], [5, 0, 2]], np.int64)
    check_pair(lambda i_, w_: JF.embedding(i_, w_, padding_idx=pad),
               lambda i_, w_: TF.embedding(i_, w_, padding_idx=pad),
               [ids, w], grads=(1,))


def test_one_hot_matches_reference():
    ids = np.array([0, 3, 2, 4], np.int64)
    check_pair(JF.one_hot, TF.one_hot, [ids], kw=dict(num_classes=5))


@pytest.mark.parametrize("fn,mode", [("dropout", "upscale_in_train"),
                                     ("dropout", "downscale_in_infer"),
                                     ("dropout2d", None),
                                     ("alpha_dropout", None)])
def test_dropout_in_training_keeps_rate_and_scale(fn, mode):
    """The masks differ from the reference's (another generator): the
    kept share is 1 - p and kept values are x / (1 - p) (upscale), x
    (downscale), whole channels (2-D), or the SELU-affine of alpha
    dropout."""
    from paddle_tpu_torch.core import rng

    p = 0.3
    rng.seed(3)
    x = torch.from_numpy(np.abs(arr((64, 32, 8, 8), 51)) + 0.5)
    if fn == "dropout":
        y = TF.dropout(x, p, training=True, mode=mode)
        kept = y != 0
        scale = 1 / (1 - p) if mode == "upscale_in_train" else 1.0
        torch.testing.assert_close(y[kept], x[kept] * scale)
    elif fn == "dropout2d":
        y = TF.dropout2d(x, p, training=True)
        kept = y != 0
        chan = kept.flatten(2)
        assert bool((chan.all(-1) | ~chan.any(-1)).all())
        torch.testing.assert_close(y[kept], x[kept] / (1 - p))
    else:
        y = TF.alpha_dropout(x, p, training=True)
        alpha_p = -1.6732632423543772 * 1.0507009873554805
        a = (1.0 / ((1.0 - p) * (1.0 + p * alpha_p ** 2)) ** 0.5)
        b = -a * alpha_p * p
        dropped = torch.isclose(y, torch.full_like(y, a * alpha_p + b))
        kept = ~dropped
        torch.testing.assert_close(y[kept], a * x[kept] + b)
    share = kept.float().mean().item()
    # four standard deviations of the share of independent draws (one a
    # channel for dropout2d)
    units = x.shape[0] * x.shape[1] if fn == "dropout2d" else x.numel()
    assert abs(share - (1 - p)) < 4 * (p * (1 - p) / units) ** 0.5, share
