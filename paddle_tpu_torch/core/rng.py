"""Random-number state (mirrors ``paddle_tpu/core/rng.py``).

``seed(n)`` reseeds one ``torch.Generator`` per device, and the numpy
``RandomState`` the data samplers draw from. Initializers draw
from the generator of the device the parameter lives on, so a model built
after ``seed(n)`` on a given device is reproducible. The JAX package's
threefry keys and torch's Philox give different numbers from the same
seed: tests that compare the two packages make their inputs with numpy
and carry weights across with ``models.gpt.load_reference_state``.

``key_scope(key)`` and ``scope_key()`` are the reference's keyed draws
for code that must draw the same numbers again: each ``scope_key()``
folds the scope's key with its count of draws so far, so a block that
opens its own scope (as the trainer's checkpointed blocks do) draws the
same keys when ``torch.utils.checkpoint`` recomputes it, on whichever
thread the backward runs.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import numpy as np
import torch

_seed = 0
_generators: Dict[str, torch.Generator] = {}

#: the host's sampling stream (the reference's ``_numpy_generator``):
#: ``io``'s samplers and ``random_split`` draw from it, so the batches a
#: loader shuffles after ``seed(n)`` are the reference's, index for index
_numpy_generator = np.random.RandomState(0)


def seed(value: int) -> None:
    """Reseed every per-device generator (created lazily from ``value``)
    and the host's numpy stream (with ``value % 2**32``, as the
    reference)."""
    global _seed
    _seed = int(value)
    for gen in _generators.values():
        gen.manual_seed(_seed)
    _numpy_generator.seed(_seed % (2 ** 32))


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


_M64 = (1 << 64) - 1
_scope_state = threading.local()


def fold_in(key: int, data: int) -> int:
    """A new non-negative 63-bit key from ``key`` and ``data`` (splitmix64
    of their mix): the keyed draws' counterpart of ``jax.random.fold_in``
    (other numbers)."""
    z = (int(key) ^ ((int(data) + 1) * 0x9E3779B97F4A7C15)) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1


@contextlib.contextmanager
def key_scope(key: int):
    """Make ``key`` the source of ``scope_key()`` inside (this thread)."""
    stack = getattr(_scope_state, "stack", None)
    if stack is None:
        stack = _scope_state.stack = []
    stack.append([int(key), 0])
    try:
        yield
    finally:
        stack.pop()


def scope_key() -> Optional[int]:
    """The innermost scope's next key, or None outside every scope."""
    stack = getattr(_scope_state, "stack", None)
    if not stack:
        return None
    entry = stack[-1]
    entry[1] += 1
    return fold_in(entry[0], entry[1] - 1)


def get_rng_state() -> dict:
    """The port's random state as JSON-able data: the seed and every
    per-device generator's state bytes (an elastic checkpoint's meta)."""
    return {"seed": _seed,
            "generators": {k: g.get_state().tolist()
                           for k, g in _generators.items()}}


def set_rng_state(state: dict) -> None:
    """Inverse of :func:`get_rng_state` (generators of devices this
    process has not used yet are made first)."""
    global _seed
    _seed = int(state["seed"])
    for k, st in state.get("generators", {}).items():
        generator(k).set_state(torch.tensor(st, dtype=torch.uint8))


def initial_seed(device) -> int:
    """The seed ``generator(device)`` starts from, without making a
    generator for ``device`` (a plan names a card the host may not have)."""
    dev = torch.device(device)
    key = str(dev) if dev.type == "cpu" else \
        f"cuda:{dev.index if dev.index is not None else 0}"
    gen = _generators.get(key)
    return gen.initial_seed() if gen is not None else _seed
