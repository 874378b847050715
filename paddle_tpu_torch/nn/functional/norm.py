"""Normalization functionals (mirrors ``paddle_tpu/nn/functional/norm.py``;
reference: python/paddle/nn/functional/norm.py, kernels
operators/batch_norm_op.cu).

``batch_norm`` is the reference's, not torch's:

- ``momentum`` is the share KEPT: ``r = m·r + (1 - m)·batch`` (0.9 by
  default, torch's 0.1 the other way round);
- the running variance takes the batch's BIASED variance (the one that
  normalises), where ``F.batch_norm`` stores the unbiased one;
- statistics and the normalisation run in f32 for a bf16 or f16 input,
  ``(x - mean) / sqrt(var + eps) · w + b``, cast back to the input's
  dtype once; the running buffers stay f32;
- ``use_global_stats`` normalises with the running buffers in training
  mode too, and leaves them as they are.

Inside a trainer's ``context.batch_norm_scope`` over ``dp`` the batch
moments span every dp rank's rows: the local mean and variance are
averaged over the axis with a differentiable all-reduce (equal rows a
rank), the variance by the law of total variance, so that the gradient
through the global statistics reaches every rank's rows — what the
reference's one program over the global batch computes.
"""
from __future__ import annotations

import torch
from torch.nn import functional as TF

__all__ = ["normalize", "layer_norm", "batch_norm", "instance_norm",
           "group_norm", "local_response_norm", "rms_norm"]

_LOW = (torch.bfloat16, torch.float16)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    nrm = (x.abs() ** p).sum(dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp(nrm, min=epsilon)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    """A bf16 or f16 input is normalised in f32 and rounded once: on the
    card by PyTorch's kernel itself; off the card the input and the affine
    parameters are upcast and the f32 result is cast back (the CPU
    kernel's weight and bias gradients of a bf16 input miss the f32 sums
    by far more than one rounding). ``nn.LayerNorm`` calls this."""
    ns = (normalized_shape,) if isinstance(normalized_shape, int) else \
        tuple(normalized_shape)
    if x.device.type != "cuda" and x.dtype in _LOW:
        out = TF.layer_norm(x.float(), ns,
                            None if weight is None else weight.float(),
                            None if bias is None else bias.float(), epsilon)
        return out.to(x.dtype)
    return TF.layer_norm(x, ns, weight, bias, epsilon)


def _moments(xf, axes):
    """The batch's mean and biased variance over ``axes`` (f32), over
    the batch-norm scope's mesh axis when one is set."""
    from ...distributed.context import current_batch_norm

    var, mean = torch.var_mean(xf, dim=axes, unbiased=False)
    scope = current_batch_norm()
    if scope is not None:
        from ...distributed.collective import ReduceOp
        from ...distributed.primitives import _AllReduce

        mesh, axis = scope
        group, n = mesh.group(axis), mesh.shape[axis]
        gmean = _AllReduce.apply(mean, ReduceOp.SUM, group, n)
        var = _AllReduce.apply(var + (mean - gmean) ** 2, ReduceOp.SUM,
                               group, n)
        mean = gmean
    return mean, var


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    chan = 1 if data_format.startswith("NC") else x.dim() - 1
    shape = [1] * x.dim()
    shape[chan] = x.shape[chan]
    xf = x.float()
    if training and not use_global_stats:
        axes = tuple(i for i in range(x.dim()) if i != chan)
        mean, var = _moments(xf, axes)
        with torch.no_grad():
            running_mean.copy_(momentum * running_mean
                               + (1 - momentum) * mean.detach())
            running_var.copy_(momentum * running_var
                              + (1 - momentum) * var.detach())
    else:
        mean, var = running_mean.float(), running_var.float()
    out = (xf - mean.reshape(shape)) / torch.sqrt(var.reshape(shape)
                                                  + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape).float()
    if bias is not None:
        out = out + bias.reshape(shape).float()
    return out.to(x.dtype)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    chan_last = not data_format.startswith("NC")
    axes = tuple(range(1, x.dim() - 1)) if chan_last else \
        tuple(range(2, x.dim()))
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=axes, unbiased=False, keepdim=True)
    out = (xf - mean) / torch.sqrt(var + eps)
    shape = [1] * x.dim()
    c = -1 if chan_last else 1
    shape[c] = x.shape[c]
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out.to(x.dtype)


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    b = x.shape[0]
    if data_format == "NCHW":
        c = x.shape[1]
        v = x.reshape((b, num_groups, c // num_groups) + tuple(x.shape[2:]))
        axes = tuple(range(2, v.dim()))
    else:
        c = x.shape[-1]
        v = x.reshape(tuple(x.shape[:-1]) + (num_groups, c // num_groups))
        axes = tuple(range(1, v.dim() - 2)) + (v.dim() - 1,)
    vf = v.float()
    var, mean = torch.var_mean(vf, dim=axes, unbiased=False, keepdim=True)
    out = ((vf - mean) / torch.sqrt(var + epsilon)).reshape(x.shape)
    shape = [1] * x.dim()
    shape[1 if data_format == "NCHW" else -1] = c
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out.to(x.dtype)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    c_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    half = size // 2
    sq = x * x
    pad = [0, 0] * (x.dim() - 1 - c_axis) + [half, size - half - 1]
    padded = TF.pad(sq, pad)
    n = x.shape[c_axis]
    acc = sum(padded.narrow(c_axis, i, n) for i in range(size))
    return x / torch.pow(k + alpha * acc, beta)


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    xf = x.float()
    out = xf / torch.sqrt((xf * xf).mean(dim=-1, keepdim=True) + epsilon)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)
