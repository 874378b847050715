"""Container layers (mirrors ``paddle_tpu/nn/layer/container.py``;
reference: python/paddle/fluid/dygraph/container.py).

Each is a ``Layer`` and the matching ``torch.nn`` container at once, so
code that asks ``isinstance(m, torch.nn.Sequential)`` (the int8 chain
fusion) sees a port ``Sequential`` as one. ``Sequential`` also takes
``(name, layer)`` pairs, as the reference's does.
"""
from __future__ import annotations

from torch import nn

from .layers import Layer

__all__ = ["Sequential", "LayerList", "LayerDict", "ParameterList"]


def _ordered_items(layers):
    """``(name, layer)`` pairs of a container's constructor arguments:
    layers, ``(name, layer)`` pairs, a list of pairs or a dict."""
    if len(layers) == 1 and isinstance(layers[0], dict):
        return list(layers[0].items())
    if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
            layers[0] and isinstance(layers[0][0], tuple):
        return [(str(n), m) for n, m in layers[0]]
    return [(str(m[0]), m[1]) if isinstance(m, tuple) else (str(i), m)
            for i, m in enumerate(layers)]


class Sequential(Layer, nn.Sequential):
    def __init__(self, *layers):
        Layer.__init__(self)
        for name, layer in _ordered_items(layers):
            self.add_module(name, layer)


class LayerList(Layer, nn.ModuleList):
    def __init__(self, sublayers=None):
        Layer.__init__(self)
        for i, layer in enumerate(sublayers or ()):
            self.add_module(str(i), layer)


class LayerDict(Layer, nn.ModuleDict):
    def __init__(self, sublayers=None):
        Layer.__init__(self)
        if sublayers:
            self.update(sublayers)


class ParameterList(Layer, nn.ParameterList):
    def __init__(self, parameters=None):
        Layer.__init__(self)
        for p in parameters or ():
            self.append(p)
