"""Per-site program accounting: the program inventory (mirrors
``paddle_tpu/profiler/xla_stats.py``).

The recompile telemetry (``recompile.py``) says when a dispatch site ran
a new argument signature; this module says what one dispatch of a site
costs: FLOPs, bytes accessed and a per-category breakdown, keyed by the
same site names (``serving.tick#0``, ``hybrid.step#1``).

PyTorch compiles no program, so the port counts one: a site's "program"
is its **first dispatch**. The first time a site runs (``dispatch``),
that one execution runs under a counting ``TorchDispatchMode``
(``OpCounter``), which sees every aten op the dispatch runs, forward and
backward: autograd's engine threads, ``torch.utils.checkpoint``'s
recomputed forwards and ``torch.inference_mode()`` work included. This
is the reference's ``_note_avals``, which keeps only a site's first
dispatch too.

- **FLOPs**: ``torch.utils.flop_counter.flop_registry`` (mm, addmm, bmm,
  baddbmm, the SDPA ops, convolutions), each op's FLOPs under its
  category. A CUDA kernel launched through ``ctypes`` is invisible to a
  dispatch mode, so each kernel wrapper of ``ops/`` notes its own
  ``(flops, bytes)`` (``note_kernel``, from the ``*_cost`` function
  beside it) while a counter runs; with no counter running that is one
  attribute read.
- **Bytes accessed**: the input bytes plus the output bytes of every op
  that is not a view, an alias or an allocation
  (``device_trace.NO_WORK_OPS``, as the reference skips ``bitcast`` and
  ``tuple``).
- **Categories**: ``{cat: {ops, bytes[, flops]}}`` on
  ``device_trace.categorize_op``'s axis, the one traced time is bucketed
  on, so counted cost and measured milliseconds join per category.
- **compile_ms**: the wall time of that counted first dispatch, counting
  overhead included: the one-time cost the site paid, as the reference's
  is the compile it paid.

Each site's ``module`` (the join key of parsed traces) is the name of the
``record_function`` range the site opens around every dispatch, which is
the site's own name. The engine and the trainer keep their counted
record per site; ``record_counted`` folds one into the inventory and the
``xla/<site>/{compile_ms,flops,bytes_accessed}`` gauges (the reference's
names). Accounting never raises into the caller's hot path.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional, Set

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from . import trace as _trace
from .device_trace import NO_WORK_OPS, categorize_op
from .metrics import registry

__all__ = ["ProgramStats", "OpCounter", "count", "dispatch", "site_fn",
           "note_kernel", "record_counted", "inventory", "program_inventory",
           "get", "reset", "module_sites", "ambiguous_modules",
           "register_module_site"]


class ProgramStats:
    """One dispatch site's counted program: totals, the trace join key
    (``module``), the per-category breakdown and per-collective-kind ops
    and result bytes (``{kind: {ops, bytes}}``, the collectives the
    site's first dispatch noted; none at degree 1)."""

    __slots__ = ("site", "compile_ms", "flops", "bytes_accessed",
                 "cost", "recorded_unix", "module", "categories",
                 "collectives", "flops_unattributed")

    def __init__(self, site: str, compile_ms: Optional[float],
                 flops: Optional[float], bytes_accessed: Optional[float],
                 cost: dict, module: Optional[str] = None,
                 categories: Optional[dict] = None,
                 collectives: Optional[dict] = None,
                 flops_unattributed: Optional[float] = None):
        self.site = site
        self.compile_ms = compile_ms
        self.flops = flops
        self.bytes_accessed = bytes_accessed
        self.cost = cost
        self.module = module
        self.categories = categories or {}
        self.collectives = collectives or {}
        self.flops_unattributed = flops_unattributed
        self.recorded_unix = time.time()

    def to_dict(self) -> dict:
        return {
            "site": self.site,
            "compile_ms": None if self.compile_ms is None
            else round(self.compile_ms, 3),
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "cost_available": bool(self.cost),
            "module": self.module,
            "categories": self.categories,
            "collectives": self.collectives,
            "flops_unattributed": self.flops_unattributed,
        }


_lock = threading.Lock()
_programs: Dict[str, ProgramStats] = {}
#: module (range name) -> site; a module claimed by two sites lands in
#: _ambiguous
_module_sites: Dict[str, str] = {}
_ambiguous: Set[str] = set()


def register_module_site(module: str, site: str) -> None:
    """Register (or re-register) the module -> site mapping that
    ``device_trace`` attributes parsed slices by."""
    with _lock:
        prior = _module_sites.get(module)
        if prior is not None and prior != site:
            _ambiguous.add(module)
        _module_sites[module] = site


def module_sites() -> Dict[str, str]:
    with _lock:
        return dict(_module_sites)


def ambiguous_modules() -> Set[str]:
    with _lock:
        return set(_ambiguous)


# ---------------------------------------------------------------------------
# counting one dispatch
# ---------------------------------------------------------------------------
def _tensor_bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(x.numel() * x.element_size() for x in leaves
               if isinstance(x, torch.Tensor))


class OpCounter(TorchDispatchMode):
    """Counts the FLOPs, bytes and categories of every aten op dispatched
    while it is active (module docstring), plus the kernels the ``ops/``
    wrappers note (``note_kernel``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0
        self.ops = 0
        self.categories: Dict[str, dict] = {}
        self.collectives: Dict[str, dict] = {}
        self._paused = 0
        self._lock = threading.Lock()
        self.prev: Optional[OpCounter] = None   # ACTIVE when its count began
        self.closed = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet not in flop_registry and not self._paused:
            # under inference_mode a composite op (matmul, einsum, linear)
            # reaches the mode whole: count the ops it decomposes into
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if self._paused:
            return out
        name = packet.__name__
        if name in NO_WORK_OPS:
            return out
        try:
            f = flop_registry.get(packet)
            flops = float(f(*args, **kwargs, out_val=out)) if f else 0.0
            nbytes = _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        except Exception:
            # a formula that fails on an op's arguments leaves the op
            # uncounted: accounting never raises into the dispatch it counts
            return out
        self._add(f"aten::{name}", flops, nbytes)
        return out

    def _add(self, name: str, flops: float, nbytes: int) -> None:
        cat = categorize_op(name)
        with self._lock:
            self.ops += 1
            self.flops += flops
            self.bytes += nbytes
            c = self.categories.setdefault(cat, {"ops": 0, "bytes": 0,
                                                 "flops": 0.0})
            c["ops"] += 1
            c["bytes"] += nbytes
            c["flops"] += flops

    def kernel(self, name: str, flops: float, nbytes: int) -> None:
        """A CUDA kernel's cost, under ``categorize_op(name)``."""
        self._add(name, float(flops), int(nbytes))

    def collective(self, kind: str, nbytes: int) -> None:
        """A collective the site ran (``instrument.note_collective``):
        ``collectives[kind] = {ops, bytes}``, result-buffer bytes."""
        with self._lock:
            c = self.collectives.setdefault(kind, {"ops": 0, "bytes": 0})
            c["ops"] += 1
            c["bytes"] += int(nbytes)

    @contextlib.contextmanager
    def paused(self):
        """Ops inside run uncounted (a cost function's own reads)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def result(self, compile_ms: float) -> dict:
        """The counted program: ``{compile_ms, flops, bytes_accessed, ops,
        categories, collectives}``; a category carries ``flops`` only
        where it has some."""
        cats = {}
        for cat, c in sorted(self.categories.items()):
            cats[cat] = {"ops": c["ops"], "bytes": c["bytes"]}
            if c["flops"]:
                cats[cat]["flops"] = c["flops"]
        return {"compile_ms": compile_ms, "flops": self.flops,
                "bytes_accessed": float(self.bytes), "ops": self.ops,
                "categories": cats,
                "collectives": {k: dict(v) for k, v in
                                sorted(self.collectives.items())}}


#: the counter of the dispatch being counted, read by the kernel wrappers
#: (a module global, not thread-local: the autograd engine's device
#: threads launch backward kernels too)
ACTIVE: Optional[OpCounter] = None
#: guards ACTIVE's hand-back: counts on two threads at once (two
#: in-process ranks' first dispatches) may end in either order
_ACTIVE_LOCK = threading.Lock()


def note_kernel(name: str, cost, *args, **kwargs) -> None:
    """Called by a kernel wrapper after its launch on the CUDA path: adds
    ``cost(*args, **kwargs) -> (flops, bytes)`` to the active counter
    (computed with counting paused). Wrappers test ``ACTIVE is not None``
    first, so an uncounted launch pays one attribute read."""
    c = ACTIVE
    if c is None:
        return
    with c.paused():
        flops, nbytes = cost(*args, **kwargs)
    c.kernel(name, flops, nbytes)


_warm = False


def count(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a fresh counter; returns (its
    output, the counted program: ``OpCounter.result``). The first count
    of a process first enters a dispatch mode once, untimed: PyTorch
    sets dispatch modes up at first use (seconds), a cost of the process,
    not of the site."""
    global ACTIVE, _warm
    if not _warm:
        with OpCounter():
            torch.zeros(1).add_(1)
        _warm = True
    counter = OpCounter()
    with _ACTIVE_LOCK:
        counter.prev, ACTIVE = ACTIVE, counter
    t0 = time.perf_counter()
    try:
        with counter:
            out = fn(*args, **kwargs)
    finally:
        # hand back to the newest count still open, never to one that
        # another thread has ended meanwhile
        with _ACTIVE_LOCK:
            counter.closed = True
            if ACTIVE is counter:
                prev = counter.prev
                while prev is not None and prev.closed:
                    prev = prev.prev
                ACTIVE = prev
    return out, counter.result((time.perf_counter() - t0) * 1e3)


def dispatch(records: dict, site: str, fn, *args, **kwargs):
    """One dispatch of ``site``: ``fn(*args, **kwargs)`` inside the
    site's ``record_function`` range; the site's first dispatch (no entry
    in ``records`` yet) runs counted and its record lands in
    ``records[site]``."""
    with _trace.annotate(site):
        if site in records:
            return fn(*args, **kwargs)
        out, rec = count(fn, *args, **kwargs)
        records[site] = rec
        return out


def site_fn(records: dict, site: str, fn):
    """``fn`` as a dispatch site: each call runs ``dispatch(records, site,
    fn, ...)``."""

    def call(*args, **kwargs):
        return dispatch(records, site, fn, *args, **kwargs)

    return call


def record_counted(site: str, counted: dict) -> ProgramStats:
    """Fold a site's counted program (``count``'s record) into the
    inventory, register its module (the site's range name) for trace
    attribution, and set the ``xla/<site>/*`` gauges."""
    cats = {c: dict(v) for c, v in counted["categories"].items()}
    flops = counted["flops"]
    byts = counted["bytes_accessed"]
    register_module_site(site, site)
    stats = ProgramStats(
        site, counted["compile_ms"], flops, byts,
        {"flops": flops, "bytes accessed": byts}, module=site,
        categories=cats, collectives=counted.get("collectives"),
        flops_unattributed=flops - sum(c.get("flops", 0.0)
                                       for c in cats.values()))
    with _lock:
        _programs[site] = stats
    reg = registry()
    reg.gauge(f"xla/{site}/compile_ms").set(stats.compile_ms)
    reg.gauge(f"xla/{site}/flops").set(flops)
    reg.gauge(f"xla/{site}/bytes_accessed").set(byts)
    reg.counter("xla/programs_recorded").add(1)
    return stats


def get(site: str) -> Optional[ProgramStats]:
    with _lock:
        return _programs.get(site)


def inventory() -> Dict[str, dict]:
    """JSON-ready {site: stats}."""
    with _lock:
        return {site: s.to_dict() for site, s in sorted(_programs.items())}


#: package-level spelling (``profiler.program_inventory()``)
program_inventory = inventory


def reset() -> None:
    """Clear the inventory and the module -> site maps (a stale mapping
    would attribute slices to a site the inventory no longer holds).
    Record programs again before capturing a window."""
    with _lock:
        _programs.clear()
        _module_sites.clear()
        _ambiguous.clear()
