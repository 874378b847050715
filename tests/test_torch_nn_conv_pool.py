"""The port's conv, pooling and normalization functionals
(``paddle_tpu_torch/nn/functional/{conv,pooling,norm}.py``) held against
the JAX package's on the CPU: the same seeded numpy inputs, the values and
the input and weight gradients of ``sum(out · ct)`` at rtol 1e-5, atol
1e-5 in f32 (the reference's convs at ``highest`` precision,
``tests/conftest.py``).

- conv 1-D/2-D/3-D: int, per-dim, ``2n``-list (asymmetric) and
  ``"SAME"``/``"VALID"`` padding at stride 1 and 2, dilation, groups and
  channel-last formats; the nested ``[[l, r], ...]`` form equals the flat
  one (the reference's parser reads nested pairs only at lengths other
  than n and 2n);
- the transposes: stride, ``output_padding``, asymmetric pads, groups,
  dilation, channel-last;
- every pool: max and average (``exclusive`` both ways, ``ceil_mode``
  passed and unread as in the reference, string and asymmetric padding),
  the adaptive pools at sizes that divide and, for the average ones, that
  do not (the reference's resize and bins);
- the norms: ``batch_norm`` in training (the running buffers after the
  call, momentum 0.9, biased variance) and eval, ``use_global_stats``,
  ``layer_norm``, ``instance_norm``, ``group_norm`` (both layouts),
  ``local_response_norm``, ``rms_norm`` and ``normalize``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
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


CONV = [
    # (fn, x shape, w shape, kwargs)
    ("conv1d", (2, 4, 9), (6, 4, 3), dict(padding=1)),
    ("conv1d", (2, 4, 9), (6, 4, 3), dict(padding="SAME", stride=2)),
    ("conv1d", (2, 4, 9), (6, 4, 3), dict(padding="VALID", stride=2)),
    ("conv1d", (2, 4, 9), (6, 4, 3), dict(padding=[1, 2])),
    ("conv1d", (2, 4, 9), (6, 2, 3), dict(padding=2, dilation=2, groups=2)),
    ("conv1d", (2, 9, 4), (6, 4, 3), dict(padding=1, data_format="NLC")),
    ("conv2d", (2, 4, 7, 7), (6, 4, 3, 3), dict(padding=1)),
    ("conv2d", (2, 4, 7, 7), (6, 4, 3, 3), dict(padding="SAME", stride=2)),
    ("conv2d", (2, 4, 8, 8), (6, 4, 3, 3), dict(padding="SAME", stride=2)),
    ("conv2d", (2, 4, 7, 7), (6, 4, 3, 3), dict(padding="VALID",
                                                stride=2)),
    ("conv2d", (2, 4, 7, 7), (6, 4, 3, 3), dict(padding=[1, 0])),
    ("conv2d", (2, 4, 7, 7), (6, 4, 3, 3), dict(padding=[1, 2, 0, 1])),
    ("conv2d", (2, 4, 7, 7), (6, 4, 3, 3), dict(padding=2, dilation=2)),
    ("conv2d", (2, 4, 7, 7), (6, 2, 3, 3), dict(padding=1, groups=2)),
    ("conv2d", (2, 7, 7, 4), (6, 4, 3, 3), dict(padding=1, stride=2,
                                                data_format="NHWC")),
    ("conv2d", (2, 7, 7, 4), (6, 4, 3, 3), dict(padding=[0, 1, 1, 2],
                                                data_format="NHWC")),
    ("conv3d", (1, 2, 5, 5, 5), (3, 2, 3, 3, 3), dict(padding=1)),
    ("conv3d", (1, 2, 5, 5, 5), (3, 2, 3, 3, 3), dict(padding="SAME",
                                                      stride=2)),
    ("conv3d", (1, 5, 5, 5, 2), (3, 2, 3, 3, 3), dict(
        padding=[1, 0, 1, 1, 0, 1], data_format="NDHWC")),
    ("conv1d_transpose", (2, 4, 5), (4, 3, 3), dict(stride=2, padding=1,
                                                    output_padding=1)),
    ("conv1d_transpose", (2, 4, 5), (4, 3, 3), dict(padding=[1, 0])),
    ("conv1d_transpose", (2, 4, 5), (4, 3, 3), dict(groups=2, dilation=2,
                                                    stride=2)),
    ("conv2d_transpose", (2, 4, 4, 4), (4, 3, 3, 3), dict(
        stride=2, padding=1, output_padding=1)),
    ("conv2d_transpose", (2, 4, 4, 4), (4, 3, 3, 3), dict(groups=2,
                                                          padding=1)),
    ("conv2d_transpose", (2, 4, 4, 4), (4, 3, 3, 3), dict(
        stride=2, padding=[1, 2, 0, 1])),
    ("conv2d_transpose", (2, 4, 4, 4), (4, 3, 3, 3), dict(
        stride=2, padding=[1, 0], output_padding=[1, 0], dilation=2)),
    ("conv2d_transpose", (2, 4, 4, 4), (4, 3, 3, 3), dict(
        stride=2, padding=1, data_format="NHWC")),
    ("conv3d_transpose", (1, 2, 3, 3, 3), (2, 3, 3, 3, 3), dict(
        stride=2, padding=1, output_padding=1)),
]


@pytest.mark.parametrize("i", range(len(CONV)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CONV)])
def test_conv_matches_reference(i):
    """Every other case without a bias."""
    fn, xs, ws, kw = CONV[i]
    bias = i % 2 == 0
    cout = ws[1] * kw.get("groups", 1) if "transpose" in fn else ws[0]
    args = [arr(xs, 1), arr(ws, 2), arr((cout,), 3) if bias else None]
    check_pair(getattr(JF, fn), getattr(TF, fn), args,
               grads=(0, 1, 2) if bias else (0, 1), kw=kw)


def test_conv_nested_pairs_equal_flat_pairs():
    x, w = torch.from_numpy(arr((2, 4, 7, 7), 1)), \
        torch.from_numpy(arr((6, 4, 3, 3), 2))
    flat = TF.conv2d(x, w, padding=[1, 2, 0, 1])
    nested = TF.conv2d(x, w, padding=[[1, 2], [0, 1]])
    assert torch.equal(flat, nested)


def test_conv_transpose_string_padding_raises_as_reference():
    x, w = torch.zeros(1, 2, 4, 4), torch.zeros(2, 2, 3, 3)
    with pytest.raises(ValueError, match="string padding"):
        TF.conv2d_transpose(x, w, padding="SAME")


POOL = [
    ("max_pool1d", (2, 3, 9), dict(kernel_size=2, stride=2)),
    ("max_pool1d", (2, 3, 9), dict(kernel_size=3, stride=2, padding=1)),
    ("max_pool1d", (2, 3, 9), dict(kernel_size=3, stride=2,
                                   padding="SAME")),
    ("max_pool2d", (2, 3, 8, 8), dict(kernel_size=2, stride=2)),
    ("max_pool2d", (2, 3, 9, 9), dict(kernel_size=3, stride=2, padding=1)),
    ("max_pool2d", (2, 3, 9, 9), dict(kernel_size=3, stride=2,
                                      padding="SAME")),
    ("max_pool2d", (2, 3, 9, 9), dict(kernel_size=3, stride=2,
                                      padding=[0, 1, 1, 2])),
    ("max_pool2d", (2, 9, 9, 3), dict(kernel_size=3, stride=2, padding=1,
                                      data_format="NHWC")),
    ("max_pool2d", (2, 3, 9, 9), dict(kernel_size=2, stride=2,
                                      ceil_mode=True)),
    ("max_pool3d", (1, 2, 6, 6, 6), dict(kernel_size=2, stride=2)),
    ("max_pool3d", (1, 2, 5, 5, 5), dict(kernel_size=3, stride=2,
                                         padding=1)),
    ("avg_pool1d", (2, 3, 9), dict(kernel_size=3, stride=2, padding=1)),
    ("avg_pool1d", (2, 3, 9), dict(kernel_size=3, stride=2, padding=1,
                                   exclusive=False)),
    ("avg_pool2d", (2, 3, 8, 8), dict(kernel_size=2, stride=2)),
    ("avg_pool2d", (2, 3, 9, 9), dict(kernel_size=3, stride=2, padding=1)),
    ("avg_pool2d", (2, 3, 9, 9), dict(kernel_size=3, stride=2, padding=1,
                                      exclusive=False)),
    ("avg_pool2d", (2, 3, 9, 9), dict(kernel_size=3, stride=2,
                                      padding="SAME")),
    ("avg_pool2d", (2, 3, 9, 9), dict(kernel_size=3, stride=2,
                                      padding=[0, 1, 1, 2])),
    ("avg_pool2d", (2, 3, 9, 9), dict(kernel_size=3, stride=2,
                                      padding=[0, 1, 1, 2],
                                      exclusive=False)),
    ("avg_pool2d", (2, 9, 9, 3), dict(kernel_size=3, stride=2, padding=1,
                                      data_format="NHWC")),
    ("avg_pool2d", (2, 3, 9, 9), dict(kernel_size=2, stride=2,
                                      ceil_mode=True, divisor_override=3)),
    ("avg_pool3d", (1, 2, 5, 5, 5), dict(kernel_size=3, stride=2,
                                         padding=1)),
    ("adaptive_avg_pool1d", (2, 3, 12), dict(output_size=4)),
    ("adaptive_avg_pool1d", (2, 3, 10), dict(output_size=4)),
    ("adaptive_avg_pool1d", (2, 3, 4), dict(output_size=7)),
    ("adaptive_avg_pool2d", (2, 3, 8, 8), dict(output_size=(1, 1))),
    ("adaptive_avg_pool2d", (2, 3, 8, 8), dict(output_size=4)),
    ("adaptive_avg_pool2d", (2, 3, 10, 7), dict(output_size=(3, 3))),
    ("adaptive_avg_pool2d", (2, 10, 7, 3), dict(output_size=(3, 3),
                                                data_format="NHWC")),
    ("adaptive_avg_pool3d", (1, 2, 4, 4, 4), dict(output_size=2)),
    ("adaptive_avg_pool3d", (1, 2, 5, 7, 4), dict(output_size=(2, 3, 3))),
    ("adaptive_max_pool1d", (2, 3, 12), dict(output_size=4)),
    ("adaptive_max_pool2d", (2, 3, 8, 8), dict(output_size=2)),
    ("adaptive_max_pool3d", (1, 2, 4, 4, 4), dict(output_size=2)),
]


@pytest.mark.parametrize("fn,xs,kw", POOL,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(POOL)])
def test_pool_matches_reference(fn, xs, kw):
    check_pair(getattr(JF, fn), getattr(TF, fn), [arr(xs, 4)], grads=(0,),
               kw=kw)


def test_adaptive_max_pool_needs_dividing_sizes():
    with pytest.raises(NotImplementedError, match="divide"):
        TF.adaptive_max_pool2d(torch.zeros(1, 1, 5, 5), 2)


def _bn_pair(x, training, use_global_stats=None, data_format="NCHW",
             momentum=0.9):
    c = x.shape[1] if data_format.startswith("NC") else x.shape[-1]
    rm, rv = arr((c,), 11) * 0.1, np.abs(arr((c,), 12)) + 0.5
    w, b = arr((c,), 13), arr((c,), 14)
    jm, jv = paddle.to_tensor(rm), paddle.to_tensor(rv)
    tm, tv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    kw = dict(training=training, momentum=momentum,
              data_format=data_format, use_global_stats=use_global_stats)
    check_pair(lambda x_, w_, b_: JF.batch_norm(x_, jm, jv, w_, b_, **kw),
               lambda x_, w_, b_: TF.batch_norm(x_, tm, tv, w_, b_, **kw),
               [x, w, b], grads=(0, 1, 2))
    np.testing.assert_allclose(tm.numpy(), jm.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), jv.numpy(), rtol=1e-6, atol=1e-6)
    return tm.numpy(), tv.numpy(), rm, rv


@pytest.mark.parametrize("case", ["train", "eval", "global_stats", "nhwc",
                                  "1d", "3d", "momentum"])
def test_batch_norm_matches_reference(case):
    x = arr((6, 4, 3, 3), 10) * 3 + 1
    if case == "train":
        m, v, rm, rv = _bn_pair(x, True)
        bm = x.mean(axis=(0, 2, 3))
        bv = x.var(axis=(0, 2, 3))          # biased
        np.testing.assert_allclose(m, 0.9 * rm + 0.1 * bm, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(v, 0.9 * rv + 0.1 * bv, rtol=1e-5,
                                   atol=1e-6)
    elif case == "eval":
        _bn_pair(x, False)
    elif case == "global_stats":
        m, v, rm, rv = _bn_pair(x, True, use_global_stats=True)
        assert np.array_equal(m, rm) and np.array_equal(v, rv)
    elif case == "nhwc":
        _bn_pair(x.transpose(0, 2, 3, 1).copy(), True, data_format="NHWC")
    elif case == "1d":
        _bn_pair(arr((8, 4), 15), True, data_format="NC")
    elif case == "3d":
        _bn_pair(arr((2, 4, 3, 3, 3), 16), True, data_format="NCDHW")
    else:
        _bn_pair(x, True, momentum=0.5)


NORM = [
    ("layer_norm", [(3, 4, 6), (6,), (6,)], dict(normalized_shape=6)),
    ("layer_norm", [(3, 4, 6), (4, 6), (4, 6)],
     dict(normalized_shape=[4, 6])),
    ("instance_norm", [(2, 3, 4, 4), (3,), (3,)], {}),
    ("instance_norm", [(2, 3, 5), None, None], {}),
    ("group_norm", [(2, 6, 3, 3), (6,), (6,)], dict(num_groups=3)),
    ("group_norm", [(2, 3, 3, 6), (6,), (6,)], dict(num_groups=2,
                                                   data_format="NHWC")),
    ("local_response_norm", [(2, 7, 3, 3)], dict(size=5)),
    ("local_response_norm", [(2, 3, 3, 6)], dict(size=3,
                                                 data_format="NHWC")),
    ("rms_norm", [(3, 4, 8), (8,)], {}),
    ("normalize", [(3, 5)], {}),
    ("normalize", [(3, 5, 2)], dict(p=1, axis=-1)),
]


def _norm_call(module, fn, kw):
    f = getattr(module, fn)
    if fn == "layer_norm":
        return lambda x, w, b: f(x, kw["normalized_shape"], w, b)
    if fn == "instance_norm":
        return lambda x, w=None, b=None: f(x, weight=w, bias=b)
    if fn == "group_norm":
        return lambda x, w, b: f(x, kw["num_groups"], 1e-5, w, b,
                                 kw.get("data_format", "NCHW"))
    if fn == "rms_norm":
        return lambda x, w: f(x, w)
    return lambda x: f(x, **kw)


@pytest.mark.parametrize("fn,shapes,kw", NORM,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(NORM)])
def test_norm_matches_reference(fn, shapes, kw):
    args = [arr(s, 20 + i) + (2.0 if i == 0 else 0.0)
            for i, s in enumerate(shapes) if s is not None]
    check_pair(_norm_call(JF, fn, kw), _norm_call(TF, fn, kw), args,
               grads=tuple(range(len(args))))


def test_layer_norm_bf16_keeps_f32_statistics():
    x = arr((3, 8), 30) * 4 + 2
    w, b = arr((8,), 31), arr((8,), 32)
    j = JF.layer_norm(paddle.to_tensor(x).astype("bfloat16"), 8,
                      paddle.to_tensor(w), paddle.to_tensor(b))
    t = TF.layer_norm(torch.from_numpy(x).bfloat16(), 8,
                      torch.from_numpy(w), torch.from_numpy(b))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(j.astype("float32").numpy()))
