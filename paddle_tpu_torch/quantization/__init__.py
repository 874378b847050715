"""Quantization toolkit: QAT (fake-quant training) + PTQ (post-training
calibration) + int8 deploy layers and export (mirrors
``paddle_tpu/quantization/__init__.py``).

The fake-quant op is a quantize-dequantize with a straight-through
gradient (a ``torch.autograd.Function``), layer wrapping is child
replacement on the ``nn.Module`` tree, and the deploy form computes in
int8: ``Int8Linear`` always goes through
``ops.int8_matmul.int8_linear_fused`` — the CUDA kernel on a CUDA tensor,
its plain version on a CPU tensor. There is no switch that avoids the
kernel on a card.

    net = nn.Sequential(nn.Linear(64, 256), nn.ReLU(), nn.Linear(256, 64))
    QAT().quantize(net)          # wrap the Linear layers
    net.train(); net(x)          # training or calibration forwards
    net.eval()
    convert_to_int8_deploy(net)  # int8 weights; fc1 -> ReLU -> fc2 fused
    y = net(x)

Waiting for later slices (each raises ``NotImplementedError`` naming its
ROADMAP item): the conv layers ``QuantedConv2D``/``Int8Conv2D`` (``nn``
has no conv yet) and ``save_quantized_model`` (needs ``jit.save``).
"""
from __future__ import annotations

import weakref
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..models.gpt import load_reference_state as _load_module_state
from ..nn.layer.common import Linear
from ..ops.int8_matmul import int8_linear_fused

__all__ = ["fake_quant", "QuantConfig", "QAT", "PTQ",
           "QuantedLinear", "QuantedConv2D", "Int8Linear", "Int8Conv2D",
           "convert_to_int8_deploy", "export_int8_state",
           "save_quantized_model", "load_reference_state"]

_TODO_CONV = ("quantized conv layers are not ported yet: ROADMAP queue 1 "
              "item 9 (long tail: the rest of nn, conv included)")
_TODO_SAVE = ("save_quantized_model is not ported yet: it serialises "
              "through jit.save, ROADMAP queue 1 item 9 (long tail: jit, "
              "export, the artifact Predictor)")


# ---------------------------------------------------------------------------
# fake-quant primitive (quantize-dequantize with STE)
# ---------------------------------------------------------------------------
class _QDQ(torch.autograd.Function):
    """``clip(round(x / s * qmax), +-qmax) * s / qmax`` with the
    straight-through gradient: passed inside ``|x| <= s``, zero outside,
    none to the scale."""

    @staticmethod
    def forward(ctx, x, scale, bits):
        qmax = 2.0 ** (bits - 1) - 1.0
        s = scale.clamp_min(1e-8)
        ctx.save_for_backward(x, s)
        return torch.clamp(torch.round(x / s * qmax), -qmax, qmax) * s / qmax

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * (x.abs() <= s).to(g.dtype), None, None


def fake_quant_fn(x, scale=None, bits=8, channel_axis=None):
    """Quantize-dequantize. scale=None -> abs-max of x (per tensor, or
    per channel when channel_axis is given)."""
    if scale is None:
        if channel_axis is not None:
            axes = tuple(i for i in range(x.dim()) if i != channel_axis)
            scale = x.abs().amax(dim=axes, keepdim=True)
        else:
            scale = x.abs().max()
    return _QDQ.apply(x, scale, bits)


def fake_quant(x, scale=None, bits=8, channel_axis=None, name=None):
    """Fake-quant of a tensor. scale: None (abs-max), a tensor, or a plain
    scalar/array."""
    if scale is not None and not isinstance(scale, torch.Tensor):
        scale = torch.as_tensor(np.asarray(scale, np.float32),
                                device=x.device)
    return fake_quant_fn(x, scale, bits=bits, channel_axis=channel_axis)


# ---------------------------------------------------------------------------
# quantized layers (QAT)
# ---------------------------------------------------------------------------
class QuantConfig:
    def __init__(self, weight_bits: int = 8, activation_bits: int = 8,
                 weight_quantize_type: str = "channel_wise_abs_max",
                 activation_quantize_type: str = "moving_average_abs_max",
                 moving_rate: float = 0.9):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.weight_quantize_type = weight_quantize_type
        self.activation_quantize_type = activation_quantize_type
        self.moving_rate = moving_rate


class _ActQuant(nn.Module):
    """Activation fake-quant with moving-average abs-max state, updated
    in training mode only (the buffer lives on the layer's device and is
    never read on the host here)."""

    def __init__(self, config: QuantConfig, device=None):
        super().__init__()
        self.bits = config.activation_bits
        self.rate = config.moving_rate
        self.register_buffer("scale", torch.zeros((), dtype=torch.float32,
                                                  device=device))

    def forward(self, x):
        if self.training:
            with torch.no_grad():
                cur = x.abs().max().float()
                s = self.scale
                self.scale.copy_(torch.where(
                    s > 0, self.rate * s + (1 - self.rate) * cur, cur))
        return fake_quant(x, self.scale, bits=self.bits)


class QuantedLinear(nn.Module):
    """A ``Linear`` under fake-quant of its input (running abs-max) and of
    its weight (abs-max, per output column when channel-wise)."""

    def __init__(self, inner: Linear, config: QuantConfig):
        super().__init__()
        self.inner = inner
        self.act_quant = _ActQuant(config, device=inner.weight.device)
        self.bits = config.weight_bits
        self.channel_wise = "channel" in config.weight_quantize_type

    def forward(self, x):
        xq = self.act_quant(x)
        wq = fake_quant(self.inner.weight, bits=self.bits,
                        channel_axis=1 if self.channel_wise else None)
        y = xq @ wq
        return y if self.inner.bias is None else y + self.inner.bias


class QuantedConv2D(nn.Module):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_TODO_CONV)


_WRAP = {Linear: QuantedLinear}


def _wrap_tree(layer: nn.Module, config: QuantConfig) -> int:
    n = 0
    for name, child in list(layer.named_children()):
        cls = _WRAP.get(type(child))
        if cls is not None:
            setattr(layer, name, cls(child, config))
            n += 1
        else:
            n += _wrap_tree(child, config)
    return n


class QAT:
    """Quantization-aware training. quantize() rewrites the layer tree in
    place; train as usual; convert_to_int8_deploy()/export_int8_state()
    export."""

    def __init__(self, config: Optional[QuantConfig] = None):
        self.config = config or QuantConfig()

    def quantize(self, model: nn.Module) -> nn.Module:
        n = _wrap_tree(model, self.config)
        if n == 0:
            raise ValueError("no quantizable (Linear/Conv2D) layers found")
        return model


class PTQ:
    """Post-training quantization: run calibration batches, record abs-max
    activation ranges, then leave a model whose scales are fixed (same
    fake-quant graph, frozen statistics)."""

    def __init__(self, config: Optional[QuantConfig] = None):
        self.config = config or QuantConfig()

    def quantize(self, model: nn.Module) -> nn.Module:
        QAT(self.config).quantize(model)
        return model

    def calibrate(self, model: nn.Module, data_iter, steps: int = 8):
        model.train()   # moving-average scales update during calibration
        dev = next(model.parameters()).device
        it = iter(data_iter)
        with torch.no_grad():
            for _ in range(steps):
                try:
                    batch = next(it)
                except StopIteration:
                    break
                xs = batch[0] if isinstance(batch, (tuple, list)) else batch
                if not isinstance(xs, torch.Tensor):
                    xs = torch.as_tensor(np.asarray(xs))
                model(xs.to(dev))
        model.eval()    # freeze: eval mode stops scale updates
        return model


# ---------------------------------------------------------------------------
# deploy layers: the compute is int8
# ---------------------------------------------------------------------------
class Int8Linear(nn.Module):
    """Deploy-time int8 linear:

        xq  = clip(round(x * amax / s_x))  (int8, static act scale from QAT)
        acc = xq @ wq                      (int8 x int8 -> int32)
        y   = acc * (s_x/amax) * (s_w/wmax) + b   (f32 dequant, per column)

    all inside ``int8_linear_fused`` (one kernel on a card). Fake-quant
    QAT math is deq(q(x)) @ deq(q(w)) = this expression in exact
    arithmetic, so outputs match QAT eval to f32 rounding."""

    def __init__(self, inner: Linear, act_scale: float, bits: int = 8,
                 act_bits: int = 8, channel_wise: bool = True):
        super().__init__()
        self._wmax = float(2 ** (bits - 1) - 1)      # e.g. 127 at 8 bits
        self._amax = float(2 ** (act_bits - 1) - 1)
        dev = inner.weight.device
        w = inner.weight.detach().float().cpu().numpy()     # [in, out]
        if channel_wise:
            scales = np.max(np.abs(w), axis=0)              # per out column
        else:
            scales = np.broadcast_to(np.max(np.abs(w)), (w.shape[1],))
        scale = np.maximum(scales.reshape(1, -1), 1e-8)
        q = np.clip(np.round(w / scale * self._wmax),
                    -self._wmax, self._wmax).astype(np.int8)
        self.register_buffer("weight_q", torch.from_numpy(q).to(dev))
        # weight_q K-major ([out, in]), what the kernel's wgmma route reads
        # (it takes 8-bit operands K-major only): built once, kept out of
        # the state_dict (whose keys and layout stay the reference's),
        # moved by .to() with the other buffers, and rebuilt by
        # _weight_kn() if weight_q changes (an in-place load)
        self.register_buffer("weight_kn", self.weight_q.t().contiguous(),
                             persistent=False)
        self._kn_of = self._weight_key()
        self.register_buffer("w_scale", torch.from_numpy(
            np.ascontiguousarray(scales, np.float32)).to(dev))
        self.register_buffer("act_scale", torch.tensor(
            float(act_scale), dtype=torch.float32, device=dev))
        self.bias = inner.bias
        # set by _fuse_sequential_int8: apply the ReLU and re-quantize to
        # the NEXT int8 layer's scale inside the kernel epilogue, emitting
        # int8 directly. _int8_src points a consumer back at its producer
        # so the chain's final output keeps the ORIGINAL float dtype (int8
        # carries none). Both links are plain attributes, not child
        # modules (the state_dict keeps the reference's keys), and the
        # back link is weak (no cycle keeps a dropped model's weights).
        self._fuse_relu = False
        self._last_float_dtype = None
        self._chain(None, None)

    def _chain(self, nxt: Optional["Int8Linear"],
               src: Optional["Int8Linear"]) -> None:
        object.__setattr__(self, "_int8_next", nxt)
        object.__setattr__(self, "_int8_src_ref",
                           None if src is None else weakref.ref(src))

    @property
    def _next_scale(self) -> Optional[torch.Tensor]:
        """The next int8 layer's activation scale when this layer is
        chain-fused to it (read from the layer, so it follows a move of
        the model to another device)."""
        nxt = self._int8_next
        return None if nxt is None else nxt.act_scale

    @property
    def _int8_src(self) -> Optional["Int8Linear"]:
        """The chain-fused producer of this layer's int8 input."""
        ref = self._int8_src_ref
        return None if ref is None else ref()

    def _weight_key(self):
        """What identifies weight_q's content: its storage and, where it
        keeps one, its version counter (bumped by every in-place write)."""
        wq = self.weight_q
        return (wq.data_ptr(), wq.device,
                None if wq.is_inference() else wq._version)

    def _weight_kn(self) -> torch.Tensor:
        """``weight_q.T.contiguous()``, rebuilt only when weight_q has
        changed since it was made."""
        key = self._weight_key()
        if key != self._kn_of:
            self.weight_kn = self.weight_q.t().contiguous()
            self._kn_of = key
        return self.weight_kn

    def forward(self, x):
        if x.dtype == torch.int8:
            # int8 input from a chain-fused producer: restore the float
            # dtype the producer saw (stored forward so that chains of 3
            # and more layers propagate it too)
            odt = getattr(self._int8_src, "_last_float_dtype",
                          None) or torch.float32
        else:
            odt = x.dtype
        self._last_float_dtype = odt
        with torch.no_grad():
            return int8_linear_fused(
                x, self.weight_q, self.w_scale, self.act_scale, self.bias,
                wmax=self._wmax, amax=self._amax, relu=self._fuse_relu,
                next_act_scale=self._next_scale, out_dtype=odt,
                wq_kn=self._weight_kn())


class Int8Conv2D(nn.Module):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_TODO_CONV)


def _fuse_sequential_int8(seq) -> int:
    """Inside an ``nn.Sequential`` (forward order == child order), chain
    Int8Linear -> ReLU -> Int8Linear triples: the first linear applies the
    ReLU and re-quantizes straight to the second's int8 input inside the
    kernel epilogue, so the f32 intermediate never reaches device memory.
    The interposed ReLU child stays in place (identity on the non-negative
    int8 values)."""
    kids = list(seq.named_children())
    n = 0
    for (_, c1), (_, c2), (_, c3) in zip(kids, kids[1:], kids[2:]):
        if isinstance(c1, Int8Linear) and isinstance(c2, nn.ReLU) \
                and isinstance(c3, Int8Linear) \
                and c1._next_scale is None and c1._amax == c3._amax:
            c1._fuse_relu = True
            c1._chain(c3, c1._int8_src)
            c3._chain(c3._int8_next, c1)
            n += 1
    return n


def convert_to_int8_deploy(model: nn.Module, _undo=None) -> int:
    """Swap every QuantedLinear for its deploy-time int8 layer IN PLACE.
    Returns the count converted. ``_undo`` (internal): a list collecting
    (parent, name, original) so a caller can restore the model."""
    n = 0
    for name, child in list(model.named_children()):
        if isinstance(child, QuantedLinear):
            if child.bits > 8 or child.act_quant.bits > 8:
                raise ValueError(
                    f"int8 deploy supports <=8-bit quantization, got "
                    f"weight_bits={child.bits} "
                    f"activation_bits={child.act_quant.bits}")
            act_scale = float(child.act_quant.scale)
            if act_scale == 0.0:
                raise ValueError(
                    f"layer '{name}' has an uncalibrated activation "
                    "observer (act scale == 0): no training or "
                    "calibration forward pass has run, so the deployed "
                    "int8 graph would saturate every activation. Run at "
                    "least one forward pass (QAT training step or PTQ "
                    "calibration batch) before converting to int8 deploy.")
            if _undo is not None:
                _undo.append((model, name, child))
            setattr(model, name, Int8Linear(
                child.inner, act_scale, bits=child.bits,
                act_bits=child.act_quant.bits,
                channel_wise=child.channel_wise))
            n += 1
        else:
            n += convert_to_int8_deploy(child, _undo)
    if isinstance(model, nn.Sequential):
        _fuse_sequential_int8(model)
    return n


def export_int8_state(model: nn.Module) -> Dict[str, dict]:
    """Export quantized-layer weights as int8 + scales (the deployable
    artifact's weight transform)."""
    out = {}
    for name, sub in model.named_modules():
        if isinstance(sub, QuantedLinear):
            w = sub.inner.weight.detach().float().cpu().numpy()
            axis = 1 if sub.channel_wise else None
            if axis is None:
                scale = np.max(np.abs(w))
                scales = np.asarray([scale], np.float32)
            else:
                axes = tuple(i for i in range(w.ndim) if i != axis)
                scales = np.max(np.abs(w), axis=axes)
                shape = [1] * w.ndim
                shape[axis] = -1
                scale = scales.reshape(shape)
            q = np.clip(np.round(w / np.maximum(scale, 1e-8) * 127.0),
                        -127, 127).astype(np.int8)
            out[name] = {"int8_weight": q,
                         "scales": scales.astype(np.float32),
                         "channel_axis": axis,
                         "act_scale": float(sub.act_quant.scale)}
    return out


def save_quantized_model(model: nn.Module, path: str, input_spec,
                         batch_buckets=None):
    raise NotImplementedError(_TODO_SAVE)


def load_reference_state(model: nn.Module,
                         state: Mapping[str, np.ndarray]) -> None:
    """Copy the reference model's state — ``{name: np.asarray(t._value)}``
    from the JAX package's ``state_dict()`` — into ``model``, whose layer
    tree has the same form: a QAT model's ``inner.weight``, ``inner.bias``
    and ``act_quant.scale``, or a deploy model's ``weight_q`` (int8),
    ``w_scale``, ``act_scale`` and ``bias``. Raises on missing, extra or
    mis-shaped keys. After it both packages compute from the same
    numbers."""
    _load_module_state(model, state)
