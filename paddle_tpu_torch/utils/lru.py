"""Small bounded LRU map for per-shape caches (mirrors
``paddle_tpu/utils/lru.py``).

A serving loop feeds per-shape caches an unbounded key stream (every
distinct batch/length combination mints a new entry), so a dict that is
"cache forever" under training workloads becomes a slow leak under
serving. This LRU keeps the hot shapes and counts what it drops: every
eviction increments the ``cache_evict/<name>`` counter in the profiler
registry, so a deployment whose shape traffic exceeds the cap is visible
in the registry.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Optional


class LRUCache:
    """dict-ish bounded mapping with least-recently-used eviction.

    ``on_evict(key, value)`` runs for every evicted entry (a cache
    may use it to drop companion state keyed by the same object).
    """

    def __init__(self, capacity: int, name: str = "lru",
                 on_evict: Optional[Callable[[Any, Any], None]] = None):
        if capacity < 1:
            raise ValueError(f"LRU capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.name = name
        self.on_evict = on_evict
        self._d: OrderedDict = OrderedDict()
        self.evictions = 0

    def get(self, key, default=None):
        try:
            self._d.move_to_end(key)
        except KeyError:
            return default
        return self._d[key]

    def put(self, key, value) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            k, v = self._d.popitem(last=False)
            self.evictions += 1
            self._count_eviction()
            if self.on_evict is not None:
                self.on_evict(k, v)

    def _count_eviction(self) -> None:
        from ..profiler import registry

        registry().counter(f"cache_evict/{self.name}").add(1)

    def __contains__(self, key) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)

    def __getitem__(self, key):
        v = self.get(key, _MISSING)
        if v is _MISSING:
            raise KeyError(key)
        return v

    def __setitem__(self, key, value) -> None:
        self.put(key, value)

    def keys(self):
        return self._d.keys()

    def values(self):
        return self._d.values()

    def clear(self) -> None:
        self._d.clear()


_MISSING = object()
