"""``Layer``: the port's module base (mirrors
``paddle_tpu/nn/layer/layers.py``; reference:
python/paddle/fluid/dygraph/layers.py).

A ``Layer`` is a ``torch.nn.Module`` with the reference's surface on top:
``create_parameter`` (through ``framework.lazy.parameter``, so that a
layer built under ``LazyGuard`` stays abstract), ``set_state_dict`` from
numpy arrays or tensors, ``clear_gradients``, ``parameters()`` as a list,
``sublayers``/``add_sublayer``/``register_forward_post_hook``, and
``register_buffer(..., persistable=)``. ``state_dict`` is the module's:
its keys are the reference's, dotted the same way, buffers included.

Parameters are made on the device a layer names (``device=``), else on
the device of the innermost ``device_scope``, else on the card
(``core.place.resolve_device``): a model built inside
``device_scope("cpu")`` is made on the CPU without each of its layers
naming it.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import numpy as np
import torch
from torch import nn

from ...core.place import resolve_device
from ...framework.lazy import parameter
from ...framework.param_attr import ParamAttr
from .. import initializer as I

__all__ = ["Layer", "device_scope", "layer_device"]

_scope = threading.local()


@contextlib.contextmanager
def device_scope(device):
    """Layers built inside make their parameters and buffers on
    ``device`` unless they name another."""
    stack = getattr(_scope, "stack", None)
    if stack is None:
        stack = _scope.stack = []
    stack.append(resolve_device(device))
    try:
        yield stack[-1]
    finally:
        stack.pop()


def layer_device(device=None) -> torch.device:
    """``device`` when given, else the innermost ``device_scope``'s, else
    the card."""
    if device is not None:
        return resolve_device(device)
    stack = getattr(_scope, "stack", None)
    return stack[-1] if stack else resolve_device(None)


class Layer(nn.Module):
    def __init__(self, name_scope: Optional[str] = None, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    # -- registration ------------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, device=None
                         ) -> Optional[nn.Parameter]:
        """A parameter of ``shape`` from ``attr`` (None, False for none,
        an initializer or a ``ParamAttr``), else ``default_initializer``,
        else ``Constant(0)`` for a bias and ``XavierNormal`` otherwise —
        the reference's rule (``build_parameter``)."""
        attr = ParamAttr._to_attr(attr)
        if attr is None:
            return None
        init = attr.initializer or default_initializer or (
            I.Constant(0.0) if is_bias else I.XavierNormal())
        dt = dtype or self._dtype
        dt = getattr(torch, dt) if isinstance(dt, str) else dt
        p = parameter(shape, init, layer_device(device), dt)
        p.requires_grad_(bool(attr.trainable))
        return p

    def add_parameter(self, name: str, parameter_: Optional[nn.Parameter]):
        self.register_parameter(name, parameter_)
        return parameter_

    def add_sublayer(self, name: str, sublayer: nn.Module):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor: Optional[torch.Tensor],
                        persistable: bool = True):
        super().register_buffer(name, tensor, persistent=persistable)
        return tensor

    # -- iteration ---------------------------------------------------------
    def parameters(self, include_sublayers: bool = True, recurse=None):
        return list(super().parameters(
            recurse=include_sublayers if recurse is None else recurse))

    def sublayers(self, include_self: bool = False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix: str = "", include_self: bool = False):
        for name, m in self.named_modules(prefix=prefix):
            if m is self and not include_self:
                continue
            yield name, m

    def clear_gradients(self) -> None:
        for p in self.parameters():
            p.grad = None

    # -- hooks -------------------------------------------------------------
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)``; a non-None return replaces
        the outputs."""
        return self.register_forward_hook(hook)

    # -- state dict --------------------------------------------------------
    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Copy ``state_dict`` (numpy arrays or tensors) into this layer's
        parameters and buffers; returns ``(missing, unexpected)`` keys."""
        own = self.state_dict()
        missing, unexpected = [], []
        with torch.no_grad():
            for k, v in state_dict.items():
                if k not in own:
                    unexpected.append(k)
                    continue
                t = own[k]
                if isinstance(v, torch.Tensor):
                    v = v.detach()
                else:
                    arr = np.asarray(v)
                    arr = np.array(arr, dtype=np.float32
                                   if arr.dtype.kind not in "fiub"
                                   else arr.dtype)
                    v = torch.from_numpy(arr)
                t.copy_(v.reshape(t.shape).to(device=t.device,
                                              dtype=t.dtype))
        missing = [k for k in own if k not in state_dict]
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    def extra_repr(self) -> str:
        return ""

