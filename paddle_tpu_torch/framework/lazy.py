"""Abstract (lazy) parameter creation: ``LazyGuard`` (mirrors
``paddle_tpu/framework/lazy.py``).

Under the guard a layer's parameters are made on the ``meta`` device:
shapes and dtypes, no bytes on the host or the card. Each records what
``materialize`` needs (``_lazy``): its place in the order of creation,
its initializer, the device it was asked for, its shape and its dtype.
A model built so can be

* planned by the hybrid trainer: a trainer over an abstract model turns
  its parameters into fake tensors (``torch._subclasses.FakeTensor``) on
  their devices, builds all of its state as fake tensors, and runs its
  step on them in ``aot_lower``/``aot_compile``/``memory_analysis``
  (``distributed/plan.py``); its ``step()`` raises;
* materialized with ``materialize(model)``: each parameter's initializer
  runs on its device in the order the parameters were created, which is
  the order an eager build draws in, so the model equals one built
  eagerly under the same ``paddle_tpu_torch.seed``, bit for bit. A
  materialized parameter is a new tensor (PyTorch cannot give a ``meta``
  tensor storage in place): build the optimizer and the trainer after
  ``materialize``.

On the CPU the guard also lets a model name the card (``device=None``)
without one: nothing is made there until ``materialize``.
"""
from __future__ import annotations

import itertools
import threading

import torch
from torch import nn

__all__ = ["LazyGuard", "in_lazy_mode", "is_abstract", "materialize",
           "parameter"]

_state = threading.local()
_order = itertools.count()


def in_lazy_mode() -> bool:
    return getattr(_state, "lazy", False)


class LazyGuard:
    """Context manager: parameters created inside are abstract. Thread
    local and nestable."""

    def __enter__(self):
        self._prev = in_lazy_mode()
        _state.lazy = True
        return self

    def __exit__(self, *exc):
        _state.lazy = self._prev
        return False


def is_abstract(t) -> bool:
    """True for a tensor that holds no values: on the ``meta`` device (a
    parameter made under ``LazyGuard``) or a ``FakeTensor`` (a planning
    trainer's state)."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, torch.Tensor) and (t.is_meta
                                            or isinstance(t, FakeTensor))


def parameter(shape, init, device, dtype=torch.float32) -> nn.Parameter:
    """A parameter of ``shape`` filled in place by ``init(tensor)`` (an
    ``nn.initializer``) on ``device``; under the guard a ``meta``
    parameter that records them for ``materialize``."""
    shape = tuple(int(s) for s in shape)
    if in_lazy_mode():
        p = nn.Parameter(torch.empty(shape, dtype=dtype, device="meta"))
        p._lazy = (next(_order), init, torch.device(device), shape, dtype)
        return p
    t = torch.empty(shape, dtype=dtype, device=device)
    init(t)
    return nn.Parameter(t)


def materialize(layer: nn.Module, device=None) -> nn.Module:
    """Make every abstract parameter of ``layer`` real: its recorded
    initializer run at its recorded shape and dtype on ``device`` (default
    the recorded one), in the order of creation. A parameter that two
    modules share stays shared. Returns ``layer``."""
    from ..core.place import resolve_device

    slots = {}
    for mod in layer.modules():
        for leaf, p in mod._parameters.items():
            if p is not None and is_abstract(p):
                rec = getattr(p, "_lazy", None)
                if rec is None:
                    raise ValueError(
                        f"parameter {leaf} of {type(mod).__name__} holds no "
                        "values and was not made under LazyGuard: nothing "
                        "records how to initialize it")
                slots.setdefault(id(p), (rec, p, []))[2].append((mod, leaf))
    with torch.no_grad():
        for rec, p, where in sorted(slots.values(), key=lambda s: s[0][0]):
            _, init, dev, shape, dtype = rec
            t = torch.empty(shape, dtype=dtype, device=resolve_device(
                device if device is not None else dev))
            init(t)
            new = nn.Parameter(t, requires_grad=p.requires_grad)
            for mod, leaf in where:
                mod._parameters[leaf] = new
    return layer
