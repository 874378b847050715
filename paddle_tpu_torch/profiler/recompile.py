"""Dispatch-site telemetry: how many shapes each hot-path site has run
(mirrors ``paddle_tpu/profiler/recompile.py``).

In the reference a jitted step function calls ``mark_trace(site,
*trees)`` at the top of its traced body, so every call is a compile and
any compile after a site's first is a retrace. PyTorch compiles nothing:
a dispatch site calls ``mark_trace`` with its arguments on every
dispatch, and the site "traces" when it first runs an argument
signature (the shape and dtype of every leaf) it has not run before, as
``jax.jit``'s cache would miss on it. So ``trace_counts()[site]`` is the
number of distinct argument signatures the site has run: the programs
the reference compiles for the same schedule, or the captures a CUDA
graph of the site would take. A later new signature is a **retrace**: it
moves the ``profiler/retraces`` counter and lands in ``retraces()`` with
its diff against the previous one (while the profiler is enabled).

Dtypes are written in the reference's spelling (``"float32"``, not
``"torch.float32"``), so a retrace log reads the same in both packages.
"""
from __future__ import annotations

import itertools
import logging
import threading
from contextlib import contextmanager
from typing import Any, Dict, List, Set

from . import trace as _trace
from .metrics import registry

logger = logging.getLogger("paddle_tpu_torch.profiler")

_lock = threading.Lock()
_seen: Dict[str, Set[tuple]] = {}         # site -> signatures run
_last: Dict[str, tuple] = {}              # site -> its newest signature
_retraces: List[dict] = []
_suppress = 0
_site_seq = itertools.count()


def unique_site(prefix: str) -> str:
    """A process-unique site name for a per-instance dispatch site (two
    engines must not share one site: the second's first shape would read
    as the first's retrace)."""
    return f"{prefix}#{next(_site_seq)}"


@contextmanager
def suppressed():
    """New signatures inside this context are recorded at their site but
    move neither the public retrace counter nor the log (diagnostic runs
    that change shapes on purpose)."""
    global _suppress
    _suppress += 1
    try:
        yield
    finally:
        _suppress -= 1


def _dtype_name(dtype) -> str:
    s = str(dtype)
    return s[len("torch."):] if s.startswith("torch.") else s


def _leaf_sig(x: Any) -> tuple:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return (tuple(int(d) for d in shape), _dtype_name(dtype))
    return ((), type(x).__name__)


def _leaves(tree, out: list) -> list:
    """Flatten as ``jax.tree_util.tree_leaves`` does: tuples and lists in
    order, dicts by sorted key, None as no leaf."""
    if tree is None:
        return out
    if isinstance(tree, (tuple, list)):
        for t in tree:
            _leaves(t, out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    else:
        out.append(tree)
    return out


def signature(*trees) -> tuple:
    """The ``(shape, dtype)`` of every leaf of ``trees``; reading a
    tensor's shape and dtype never waits for the device."""
    return tuple(_leaf_sig(leaf) for t in trees for leaf in _leaves(t, []))


def mark_trace(site: str, *trees) -> None:
    """Record that ``site`` runs with these arguments. A signature the
    site has run before is a cache hit and records nothing. Signatures
    are kept whether or not profiling is on (a site first run while it
    was off still detects its first retrace after ``enable``); the
    public counter and log move only while it is on."""
    sig = signature(*trees)
    with _lock:
        seen = _seen.setdefault(site, set())
        if sig in seen:
            return
        seen.add(sig)
        prev = _last.get(site)
        _last[site] = sig
        n = len(seen)
    if prev is not None and _trace.is_enabled() and not _suppress:
        # zip_longest: a changed leaf count shows as a diff entry
        ev = {"site": site, "trace_no": n,
              "prev_signature": prev, "signature": sig,
              "changed": [
                  {"index": i, "prev": p, "new": q}
                  for i, (p, q) in enumerate(
                      itertools.zip_longest(prev, sig)) if p != q]}
        with _lock:
            _retraces.append(ev)
        registry().counter("profiler/retraces").add(1)
        logger.warning("new signature at %s (trace #%d): %s", site, n,
                       ev["changed"])


def watch(fn, site: str = None):  # noqa: RUF013 - mirrors functools style
    """Wrap a function so every new argument signature it runs is
    recorded at ``site`` (default: its qualified name)."""
    name = site or getattr(fn, "__qualname__", getattr(fn, "__name__",
                                                       "fn"))

    def wrapped(*args, **kwargs):
        mark_trace(name, args, kwargs)
        return fn(*args, **kwargs)

    wrapped.__name__ = getattr(fn, "__name__", "wrapped")
    return wrapped


def retraces() -> List[dict]:
    with _lock:
        return list(_retraces)


def clear_log() -> None:
    """Clear the public retrace log but keep the signatures each site ran
    (a site first run before this call still reads as a retrace on its
    next new signature); ``reset()`` drops those too."""
    with _lock:
        _retraces.clear()


def trace_counts() -> Dict[str, int]:
    """``{site: distinct argument signatures run}``."""
    with _lock:
        return {site: len(s) for site, s in _seen.items()}


def reset() -> None:
    with _lock:
        _seen.clear()
        _last.clear()
        _retraces.clear()
