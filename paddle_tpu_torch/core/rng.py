"""Random-number state (mirrors ``paddle_tpu/core/rng.py``).

``seed(n)`` reseeds one ``torch.Generator`` per device. Initializers draw
from the generator of the device the parameter lives on, so a model built
after ``seed(n)`` on a given device is reproducible. The JAX package's
threefry keys and torch's Philox give different numbers from the same
seed: tests that compare the two packages make their inputs with numpy
and carry weights across with ``models.gpt.load_reference_state``.
"""
from __future__ import annotations

from typing import Dict

import torch

_seed = 0
_generators: Dict[str, torch.Generator] = {}


def seed(value: int) -> None:
    """Reseed every per-device generator (created lazily from ``value``)."""
    global _seed
    _seed = int(value)
    for gen in _generators.values():
        gen.manual_seed(_seed)


def generator(device) -> torch.Generator:
    """The generator for ``device`` (created seeded on first use)."""
    dev = torch.device(device)
    key = str(dev) if dev.type == "cpu" else \
        f"cuda:{dev.index if dev.index is not None else torch.cuda.current_device()}"
    gen = _generators.get(key)
    if gen is None:
        gen = torch.Generator(device=key)
        gen.manual_seed(_seed)
        _generators[key] = gen
    return gen
