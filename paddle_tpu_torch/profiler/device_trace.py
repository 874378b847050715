"""Device time from parsed ``torch.profiler`` windows (mirrors
``paddle_tpu/profiler/device_trace.py``).

Wrap a window of hot-loop iterations in ``capture``: it runs a
``torch.profiler.profile`` (CPU activity, and CUDA activity on a card),
exports its Chrome trace into a temporary directory and parses it with
the standard library alone (gzip + json). From the parsed timeline it
derives, per window:

- **device-busy wall time** (the interval union of device slices) and the
  host-gap split, ``wall = device_busy + host_gap``;
- a **per-category breakdown** (matmul / attention / scatter-gather /
  elementwise / collective) by slice count and milliseconds
  (``class_table`` splits matmul into conv and gemm, elementwise into
  reduction and pointwise, for any list of named slices);
- **per-collective durations by kind** and the measured **compute∩comm
  overlap fraction** (0 at degree 1, where no collective runs);
- a **goodput/MFU ledger**: each site's counted FLOPs
  (``program_stats``) times its traced executions over the window's wall
  time, against the card's peak, and ``goodput_busy_frac``.

**Device slices.** On a card: the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events. ``gpu_user_annotation`` events also sit on the
card's rows, but each one spans the kernels of a ``record_function``
range; counting them as device work would count those kernels twice, so
they are left out. On a CPU-only trace: the leaf ``cpu_op`` events (no
other ``cpu_op`` nested inside them on the same thread; ops that do no
work of their own, ``NO_WORK_OPS``, count neither as slices nor as
nesting), the counterpart of the reference's XLA:CPU thunks: real
per-op wall time, but host-scheduled, so the busy union measures the
CPU, not an accelerator.

**Site correlation.** Every dispatch site opens a ``record_function``
range named after itself (``serving.tick#0``, ``hybrid.step#1``), and
``program_stats`` registers that name as the site's module. A slice's
module is the innermost enclosing range the module map knows: a kernel
is joined through ``args.correlation`` to the ``cuda_runtime`` /
``cuda_driver`` event that launched it, and through that event's thread
and time to the range; a CPU leaf op by containment on its own thread.
The autograd engine launches a card's backward kernels from its own
device thread, outside the caller's range on the caller's thread; a
launch that no range on its own thread encloses joins the innermost known
range on any thread whose span holds it (the caller waits inside its
range while backward runs). A device slice launched inside a
collective's host range on the same thread (a ``c10d::allreduce_`` op,
gloo's ``gloo:all_reduce`` range on its worker thread) is that
collective's: it is named ``"<range>: <slice>"`` and so counts under
``collective``. Over gloo a card's collective is such copies (device to
pinned host, host to device); NCCL's kernels carry their own names.
Record the sites' programs
(``record_program_stats()`` / ``profile_step_phases``) before the window
closes, or their slices land in ``unattributed_modules``.

**Per-site executions** are the reference's estimate: the least per-name
slice count inside a module; with one attributed site, the capture's
``steps`` hint replaces it.

**Peak FLOPs** (``default_peak_flops``): the ``PADDLE_PEAK_FLOPS``
environment variable wins; then a CUDA name table (an H100's bf16 dense
tensor-core peak, 989 TFLOP/s); then a one-shot CPU matmul calibration
(``"calibrated"``); then a labelled nominal value.

Entry points::

    with device_trace.capture(steps=4, label="hybrid.step") as cap:
        for _ in range(4):
            step()                   # read a result, so the work is done
    cap.summary                      # the parsed window

    win = device_trace.TraceWindow(length=2, every=100, start=10)
    for i in range(n_steps):
        with win.step():
            trainer.step(batch)      # steps 10-11, 110-111, ... traced
    win.last                         # newest summary

Wired through ``HybridPipelineTrainer.profile_step_phases(trace_window=k)``
and ``ServingEngine.trace_window()``. Each summary feeds the registry's
``trace/*`` and ``phase/comm_*`` gauges, an active sink's
``trace_summary.json`` and the flight recorder's dumps.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

from .metrics import registry

__all__ = [
    "TraceParseError", "capture", "trace_capture", "TraceWindow",
    "find_trace_file", "load_trace_events", "parse_timeline", "Timeline",
    "summarize", "record_summary", "last_summary",
    "last_trace_summary", "reset", "categorize_op", "collective_kind",
    "overlap_fraction", "interval_union_ms", "default_peak_flops",
    "CATEGORIES", "CLASSES", "classify_op", "class_table",
]


class TraceParseError(ValueError):
    """A trace file that cannot be read as trace-event JSON: truncated
    gzip, malformed JSON, or a document without ``traceEvents``."""


# ---------------------------------------------------------------------------
# op classification
# ---------------------------------------------------------------------------
#: substring -> collective kind, checked in order
_COLLECTIVE_KINDS = (
    ("all-reduce", "all_reduce"), ("all_reduce", "all_reduce"),
    ("reduce-scatter", "reduce_scatter"),
    ("reduce_scatter", "reduce_scatter"),
    ("all-gather", "all_gather"), ("all_gather", "all_gather"),
    ("all-to-all", "all_to_all"), ("all_to_all", "all_to_all"),
    ("collective-permute", "ppermute"),
    ("collective_permute", "ppermute"), ("ppermute", "ppermute"),
    ("collective-broadcast", "collective_broadcast"),
    ("collective_broadcast", "collective_broadcast"),
    # torch.distributed on a card: the c10d ops (``c10d::allreduce_``,
    # ``c10d::_allgather_base_``, ``c10d::alltoall_base_``), gloo's
    # ranges (``gloo:all_reduce``, covered above), NCCL's kernels
    # (``ncclDevKernel_AllReduce_Sum_f32_RING_LL``,
    # ``ncclDevKernel_SendRecv``)
    ("allreduce", "all_reduce"), ("reducescatter", "reduce_scatter"),
    ("allgather", "all_gather"), ("alltoall", "all_to_all"),
    ("sendrecv", "ppermute"), ("c10d::send", "ppermute"),
    ("c10d::recv", "ppermute"), ("gloo:send", "ppermute"),
    ("gloo:recv", "ppermute"),
    ("c10d::broadcast", "collective_broadcast"),
    ("gloo:broadcast", "collective_broadcast"),
    ("kernel_broadcast", "collective_broadcast"),
    ("c10d::scatter", "collective_broadcast"),
    ("gloo:scatter", "collective_broadcast"),
)

# The reference's spellings, then the port's: cuBLAS's Hopper GEMMs
# (nvjet_*), other cuBLAS/CUTLASS GEMMs (*xmma*, cutlass_*), wgmma
# kernels and the CPU trace's aten GEMM ops; the ragged paged attention
# kernels (ragged_kernel, ragged_chunk_kernel, ragged_chunk_merge).
_MATMUL_PAT = ("dot", "conv", "einsum", "matmul", "cublas", "gemm",
               "nvjet", "xmma", "cutlass", "wgmma", "aten::mm", "addmm",
               "bmm", "_int_mm")
_ATTENTION_PAT = ("attention", "attn", "softmax", "flash", "ragged",
                  "paged")
_SCATTER_GATHER_PAT = ("scatter", "gather", "dynamic-slice",
                       "dynamic_slice", "dynamic-update-slice",
                       "dynamic_update_slice", "sort", "take")

#: the four compute categories + collectives; sums over a summary's
#: ``categories`` cover every parsed device slice exactly once
CATEGORIES = ("matmul", "attention", "scatter-gather", "elementwise",
              "collective")


def collective_kind(name: str) -> Optional[str]:
    """Collective kind of an op/slice name, or None."""
    n = name.lower()
    for pat, kind in _COLLECTIVE_KINDS:
        if pat in n:
            return kind
    return None


def categorize_op(name: str) -> str:
    """Category of one device slice (a kernel, a copy, a CPU leaf op) or
    of one counted op, by its name: collective, then attention, matmul,
    scatter-gather, else elementwise."""
    n = name.lower()
    if collective_kind(n) is not None:
        return "collective"
    if any(p in n for p in _ATTENTION_PAT):
        return "attention"
    if any(p in n for p in _MATMUL_PAT):
        return "matmul"
    if any(p in n for p in _SCATTER_GATHER_PAT):
        return "scatter-gather"
    return "elementwise"


# The port's own finer split (the reference's summary has none): inside
# matmul, cuDNN's convolution kernels (forward, data and weight
# gradients) and the CPU trace's convolution ops; inside elementwise, the
# reductions (PyTorch's reduce and Welford kernels, the norm kernels,
# cuDNN's batch-norm kernels, the CPU trace's reducing ops).
_CONV_PAT = ("conv", "fprop", "dgrad", "wgrad", "implicit_gemm")
_REDUCTION_PAT = ("reduce", "welford", "batch_norm", "layer_norm",
                  "group_norm", "instance_norm", "rms_norm", "bn_fw",
                  "bn_bw", "aten::sum", "aten::mean", "aten::var",
                  "aten::std", "aten::amax", "aten::amin")

#: classify_op's classes: matmul = conv + gemm, elementwise = reduction +
#: pointwise; every other category is a class of its own
CLASSES = ("conv", "gemm", "attention", "scatter-gather", "reduction",
           "pointwise", "collective")


def classify_op(name: str) -> str:
    """The class of one device slice inside its :func:`categorize_op`
    category (``CLASSES``): a matmul is a conv or a gemm, an elementwise
    slice a reduction or pointwise; the other categories are kept."""
    cat = categorize_op(name)
    n = name.lower()
    if cat == "matmul":
        return "conv" if any(p in n for p in _CONV_PAT) else "gemm"
    if cat == "elementwise":
        return "reduction" if any(p in n for p in _REDUCTION_PAT) \
            else "pointwise"
    return cat


def class_table(ops) -> Dict[str, dict]:
    """``{class: {"count", "ms"}}`` over ``ops``, each ``(name, ms)`` or
    ``(name, ms, count)`` (an aggregate of ``count`` slices)."""
    out = {c: {"count": 0, "ms": 0.0} for c in CLASSES}
    for name, ms, *count in ops:
        c = out[classify_op(name)]
        c["count"] += count[0] if count else 1
        c["ms"] += ms
    return out


# ---------------------------------------------------------------------------
# interval arithmetic
# ---------------------------------------------------------------------------
def _merge(intervals: List[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    if not intervals:
        return []
    ivs = sorted(intervals)
    out = [list(ivs[0])]
    for s, e in ivs[1:]:
        if s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def interval_union_ms(intervals: List[Tuple[float, float]]) -> float:
    """Total covered length of ``[(start_us, end_us), ...]`` in ms."""
    return sum(e - s for s, e in _merge(intervals)) / 1e3


def _intersection_len_us(a: List[Tuple[float, float]],
                         b: List[Tuple[float, float]]) -> float:
    """|union(a) ∩ union(b)| in us (both merged by the caller)."""
    total = 0.0
    i = j = 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def overlap_fraction(comm: List[Tuple[float, float]],
                     compute: List[Tuple[float, float]]) -> float:
    """Fraction of collective time with compute in flight: |union(comm)
    ∩ union(compute)| / |union(comm)|, clamped to [0, 1]; 0.0 when no
    collective slices exist."""
    cm = _merge(comm)
    denom = sum(e - s for s, e in cm)
    if denom <= 0:
        return 0.0
    frac = _intersection_len_us(cm, _merge(compute)) / denom
    return min(max(frac, 0.0), 1.0)


# ---------------------------------------------------------------------------
# trace-file loading (stdlib only)
# ---------------------------------------------------------------------------
def find_trace_file(log_dir: str) -> Optional[str]:
    """Newest ``*.trace.json(.gz)`` directly under ``log_dir``
    (``capture``'s export, ``torch.profiler``'s TensorBoard handler's
    ``*.pt.trace.json``)."""
    pats = (os.path.join(log_dir, "*.trace.json.gz"),
            os.path.join(log_dir, "*.trace.json"))
    for pat in pats:
        files = glob.glob(pat)
        if files:
            return max(files, key=os.path.getmtime)
    return None


def load_trace_events(path: str) -> dict:
    """Read one trace-event document ({"traceEvents": [...]} or a bare
    event list) from ``path`` (gzipped by extension). Raises
    :class:`TraceParseError` on truncated gzip, malformed JSON or a wrong
    document shape."""
    try:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8",
                    errors="replace") as f:
            doc = json.load(f)
    except (OSError, EOFError, ValueError, UnicodeDecodeError) as e:
        # gzip truncation surfaces as EOFError, bad gzip magic as
        # OSError(BadGzipFile), malformed JSON as JSONDecodeError
        raise TraceParseError(f"{path}: {type(e).__name__}: {e}") from e
    if isinstance(doc, list):
        doc = {"traceEvents": doc}
    if not isinstance(doc, dict) or \
            not isinstance(doc.get("traceEvents"), list):
        raise TraceParseError(
            f"{path}: not a trace-event document (no traceEvents list)")
    return doc


# ---------------------------------------------------------------------------
# timeline parsing
# ---------------------------------------------------------------------------
class Timeline:
    """Parsed slices of one capture window.

    ``device_ops``: [(name, module|None, ts_us, dur_us)], the device
    slices (module docstring) and the site module each joins.
    ``host_spans``: [(name, ts_us, dur_us)], the ``record_function``
    ranges (profiler scopes, annotations, site ranges). The window bounds
    (``t_min_us``/``t_max_us``) cover device slices and host spans only,
    not the profiler's own start-up and export events.
    """

    __slots__ = ("device_ops", "host_spans", "events_total",
                 "t_min_us", "t_max_us")

    def __init__(self):
        self.device_ops: List[Tuple[str, Optional[str], float, float]] = []
        self.host_spans: List[Tuple[str, float, float]] = []
        self.events_total = 0
        self.t_min_us: Optional[float] = None
        self.t_max_us: Optional[float] = None


_DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
_LAUNCH_CATS = frozenset({"cuda_runtime", "cuda_driver"})


#: aten ops that do no work of their own: views and aliases, allocations,
#: dtype and conjugation bookkeeping. A trace shows them nested inside the
#: ops that run them (aten::mm holds aten::resolve_conj); they are neither
#: device slices of a CPU trace nor nesting that would hide their parent.
#: ``program_stats`` counts no bytes for them either.
NO_WORK_OPS = frozenset({
    "view", "_unsafe_view", "_reshape_alias", "reshape", "expand", "t",
    "transpose", "permute", "slice", "select", "squeeze", "unsqueeze",
    "as_strided", "detach", "alias", "unbind", "split", "split_with_sizes",
    "view_as", "lift_fresh", "empty", "empty_like", "empty_strided",
    "new_empty", "new_empty_strided", "resolve_conj", "resolve_neg",
    "resize_", "result_type", "promote_types"})
_NO_WORK_NAMES = frozenset(f"aten::{n}" for n in NO_WORK_OPS) | {"detach"}


def _is_host_annotation(name: str) -> bool:
    # drop the python tracer ("$file:line fn") and C++ internals ("a::b")
    return not (name.startswith("$") or "::" in name)


def _leaf_ops(ops: List[tuple]) -> List[tuple]:
    """The ``(name, tid, ts, dur)`` ops with no other op nested inside on
    their thread (``NO_WORK_OPS`` left out first)."""
    ops = [op for op in ops if op[0] not in _NO_WORK_NAMES]
    by_tid: Dict[object, List[tuple]] = {}
    for op in ops:
        by_tid.setdefault(op[1], []).append(op)
    leaves = []
    for tops in by_tid.values():
        tops.sort(key=lambda o: (o[2], -o[3]))
        stack: List[list] = []        # [end_us, op, has_child]
        for op in tops:
            while stack and stack[-1][0] <= op[2]:
                end, top, child = stack.pop()
                if not child:
                    leaves.append(top)
            if stack:
                stack[-1][2] = True
            stack.append([op[2] + op[3], op, False])
        leaves.extend(top for _, top, child in stack if not child)
    return leaves


class _Ranges:
    """The known site ranges of a trace: the innermost one holding a
    point, on one thread or on any."""

    def __init__(self, ranges: List[tuple]):
        self._all = ranges                     # (name, tid, ts, end)
        self._by_tid: Dict[object, List[tuple]] = {}
        for r in ranges:
            self._by_tid.setdefault(r[1], []).append(r)

    @staticmethod
    def _innermost(ranges, ts) -> Optional[str]:
        best = None
        for name, _tid, t0, t1 in ranges:
            if t0 <= ts <= t1 and (best is None or t0 > best[0]):
                best = (t0, name)
        return None if best is None else best[1]

    def module(self, tid, ts) -> Optional[str]:
        if not self._all:
            return None
        m = self._innermost(self._by_tid.get(tid, ()), ts)
        return m if m is not None else self._innermost(self._all, ts)

    def on_thread(self, tid, ts) -> Optional[str]:
        """The innermost range holding ``ts`` on thread ``tid`` alone."""
        return self._innermost(self._by_tid.get(tid, ()), ts)


def parse_timeline(doc: dict, modules=None) -> Timeline:
    """Split a ``torch.profiler`` trace-event document into device slices
    (with the site module each joins) and host ranges. ``modules``: the
    range names that are site modules (default:
    ``program_stats.module_sites()``)."""
    if modules is None:
        from . import program_stats as _pstats

        modules = _pstats.module_sites()
    modules = set(modules)
    tl = Timeline()
    evs = doc.get("traceEvents", [])
    tl.events_total = len(evs)
    kernels, cpu_ops, ranges, comm = [], [], [], []
    launches: Dict[object, tuple] = {}
    for e in evs:
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        try:
            ts = float(e["ts"])
            dur = float(e.get("dur", 0.0))
        except (KeyError, TypeError, ValueError):
            continue
        name = e.get("name")
        if not isinstance(name, str):
            continue
        cat = e.get("cat")
        args = e.get("args")
        args = args if isinstance(args, dict) else {}
        tid = e.get("tid")
        if cat in _DEVICE_CATS:
            kernels.append((name, args.get("correlation"), ts, dur))
        elif cat in _LAUNCH_CATS:
            if args.get("correlation") is not None:
                launches[args["correlation"]] = (tid, ts)
        elif cat == "cpu_op":
            cpu_ops.append((name, tid, ts, dur))
            if collective_kind(name) is not None:
                comm.append((name, tid, ts, ts + dur))
        elif cat == "user_annotation":
            if collective_kind(name) is not None:
                comm.append((name, tid, ts, ts + dur))
            if name in modules:
                ranges.append((name, tid, ts, ts + dur))
            if _is_host_annotation(name):
                tl.host_spans.append((name, ts, dur))
    sites = _Ranges(ranges)
    colls = _Ranges(comm)
    if kernels:
        for name, corr, ts, dur in kernels:
            at = launches.get(corr)
            module = None if at is None else sites.module(*at)
            coll = None if at is None else colls.on_thread(*at)
            if coll is not None and collective_kind(name) is None:
                name = f"{coll}: {name}"
            tl.device_ops.append((name, module, ts, dur))
    else:
        for name, tid, ts, dur in _leaf_ops(cpu_ops):
            tl.device_ops.append((name, sites.module(tid, ts), ts, dur))
    tl.device_ops.sort(key=lambda o: o[2])
    for _, _, ts, dur in tl.device_ops:
        _extend(tl, ts, dur)
    for _, ts, dur in tl.host_spans:
        _extend(tl, ts, dur)
    return tl


def _extend(tl: Timeline, ts: float, dur: float) -> None:
    if tl.t_min_us is None or ts < tl.t_min_us:
        tl.t_min_us = ts
    if tl.t_max_us is None or ts + dur > tl.t_max_us:
        tl.t_max_us = ts + dur


# ---------------------------------------------------------------------------
# peak FLOPs (MFU denominator)
# ---------------------------------------------------------------------------
#: bf16 dense tensor-core peak FLOP/s by card-name substring (the peak
#: PERF.md's MFU uses); the CPU entry is the fallback for hosts where the
#: calibration below fails. ``peak_flops_source`` labels which was used.
_PEAK_FLOPS = {"h100": 989e12, "h200": 989e12, "cpu": 5e10}

#: one-shot CPU calibration: measured at the first summary and kept for
#: the process, so every MFU of a run shares one denominator
_cpu_calibration: Optional[float] = None
_cpu_calibrated = False
_calib_lock = threading.Lock()


def _measure_cpu_peak_flops(n: int = 512,
                            reps: int = 5) -> Optional[float]:
    """Measured f32 matmul throughput of this host: the best of ``reps``
    timed ``n x n`` multiplies after one warm-up (best, so the MFU it
    divides stays <= 1). None on any failure."""
    try:
        import numpy as np

        rng = np.random.default_rng(0)
        a = rng.standard_normal((n, n)).astype(np.float32)
        b = rng.standard_normal((n, n)).astype(np.float32)
        a @ b
        best = None
        flop = 2.0 * n ** 3
        for _ in range(reps):
            t0 = time.perf_counter()
            (a @ b).sum()
            dt = time.perf_counter() - t0
            if dt > 0 and (best is None or dt < best):
                best = dt
        return None if best is None else flop / best
    except Exception:  # pragma: no cover - exotic BLAS failure
        return None


def default_peak_flops() -> Tuple[Optional[float], str]:
    """(peak FLOP/s, source label) for the local device. Precedence:
    ``PADDLE_PEAK_FLOPS``, the CUDA name table (a card the table lacks
    has no peak: None), the one-shot CPU calibration, the labelled
    nominal CPU value."""
    global _cpu_calibration, _cpu_calibrated
    env = os.environ.get("PADDLE_PEAK_FLOPS")
    if env:
        try:
            return float(env), "env:PADDLE_PEAK_FLOPS"
        except ValueError:
            pass
    try:
        import torch

        if torch.cuda.is_available():
            name = torch.cuda.get_device_name(0)
            for key in ("h200", "h100"):
                if key in name.lower():
                    return _PEAK_FLOPS[key], f"cuda-{key}-bf16-peak"
            return None, f"cuda-no-peak-for:{name}"
    except Exception:
        pass
    with _calib_lock:
        if not _cpu_calibrated:
            _cpu_calibration = _measure_cpu_peak_flops()
            _cpu_calibrated = True
        if _cpu_calibration is not None:
            return _cpu_calibration, "calibrated"
    return _PEAK_FLOPS["cpu"], "nominal-cpu-placeholder"


def _platform() -> str:
    try:
        import torch

        return "cuda" if torch.cuda.is_available() else "cpu"
    except Exception:
        return "unknown"


# ---------------------------------------------------------------------------
# summarization
# ---------------------------------------------------------------------------
def _cat_table() -> Dict[str, dict]:
    return {c: {"count": 0, "ms": 0.0} for c in CATEGORIES}


def summarize(doc_or_timeline, steps: Optional[int] = None,
              peak_flops: Optional[float] = None,
              label: str = "trace") -> dict:
    """The window's summary (module docstring) from a parsed timeline or
    a raw trace-event document: the reference's dict, key for key. Pure
    host arithmetic.

    ``steps``: the hot-loop iterations the capture wrapped (per-step
    normalizations; None leaves them out). ``peak_flops``: the MFU
    denominator (default :func:`default_peak_flops`)."""
    from . import program_stats as _pstats

    tl = doc_or_timeline if isinstance(doc_or_timeline, Timeline) \
        else parse_timeline(doc_or_timeline)
    if peak_flops is None:
        peak_flops, peak_src = default_peak_flops()
    else:
        peak_src = "caller"
    platform = _platform()

    wall_ms = 0.0
    if tl.t_min_us is not None and tl.t_max_us is not None:
        wall_ms = (tl.t_max_us - tl.t_min_us) / 1e3

    categories = _cat_table()
    collectives: Dict[str, dict] = {}
    comm_iv: List[Tuple[float, float]] = []
    compute_iv: List[Tuple[float, float]] = []
    all_iv: List[Tuple[float, float]] = []
    mod_ops: Dict[Optional[str], dict] = {}
    for name, module, ts, dur in tl.device_ops:
        iv = (ts, ts + dur)
        all_iv.append(iv)
        cat = categorize_op(name)
        categories[cat]["count"] += 1
        categories[cat]["ms"] += dur / 1e3
        if cat == "collective":
            kind = collective_kind(name)
            c = collectives.setdefault(kind, {"count": 0, "ms": 0.0})
            c["count"] += 1
            c["ms"] += dur / 1e3
            comm_iv.append(iv)
        else:
            compute_iv.append(iv)
        m = mod_ops.setdefault(module, {
            "ops": 0, "device_ms": 0.0, "op_counts": {},
            "categories": _cat_table(), "collectives": {}})
        m["ops"] += 1
        m["device_ms"] += dur / 1e3
        m["op_counts"][name] = m["op_counts"].get(name, 0) + 1
        m["categories"][cat]["count"] += 1
        m["categories"][cat]["ms"] += dur / 1e3
        if cat == "collective":
            mc = m["collectives"].setdefault(
                collective_kind(name), {"count": 0, "ms": 0.0})
            mc["count"] += 1
            mc["ms"] += dur / 1e3

    device_busy_ms = interval_union_ms(all_iv)
    host_gap_ms = max(wall_ms - device_busy_ms, 0.0)
    busy_frac = device_busy_ms / wall_ms if wall_ms > 0 else 0.0
    comm_ms = sum(c["ms"] for c in collectives.values())
    comm_overlap = overlap_fraction(comm_iv, compute_iv)

    # --- site correlation + per-site ledger -------------------------------
    module_sites = _pstats.module_sites()
    ambiguous = _pstats.ambiguous_modules()
    inv = {s.site: s for s in map(_pstats.get, _pstats.inventory())
           if s is not None}
    sites: Dict[str, dict] = {}
    unattributed: Dict[str, dict] = {}
    for module, m in mod_ops.items():
        # the least per-name count estimates executions (ops in loops
        # repeat; an op every execution runs once is counted once)
        execs = min(m["op_counts"].values()) if m["op_counts"] else 0
        site = module_sites.get(module) if module else None
        row = {
            "module": module,
            "ops": m["ops"],
            "device_ms": round(m["device_ms"], 4),
            "executions": execs,
            "executions_source": "trace_min_op_count",
            "categories": {c: {"count": v["count"],
                               "ms": round(v["ms"], 4)}
                           for c, v in m["categories"].items()
                           if v["count"]},
            "collectives": {k: {"count": v["count"],
                                "ms": round(v["ms"], 4)}
                            for k, v in m["collectives"].items()},
        }
        if site is None:
            unattributed[module or "<unknown>"] = {
                "ops": row["ops"], "device_ms": row["device_ms"],
                "executions": execs}
            continue
        if module in ambiguous:
            row["ambiguous"] = True
        sites[site] = row

    # one attributed site and a steps hint: the hint is the exact count
    if steps and len(sites) == 1:
        row = next(iter(sites.values()))
        row["executions"] = int(steps)
        row["executions_source"] = "steps_hint"

    model_flops_total = 0.0
    flops_known = False
    for site, row in sites.items():
        execs = row["executions"]
        row["device_ms_per_exec"] = round(
            row["device_ms"] / execs, 4) if execs else None
        ps = inv.get(site)
        if ps is not None and ps.flops is not None and execs:
            # the site's counted FLOPs (its first dispatch) x traced
            # executions: a count joined onto measured time
            row["flops_per_exec"] = ps.flops
            flops = ps.flops * execs
            model_flops_total += flops
            flops_known = True
            if row["device_ms"] > 0:
                row["model_flops_per_s"] = round(
                    flops / (row["device_ms"] / 1e3), 3)
                if peak_flops:
                    row["mfu"] = round(
                        flops / (row["device_ms"] / 1e3) / peak_flops,
                        6)
        if ps is not None and ps.collectives:
            for kind, cb in ps.collectives.items():
                dst = row["collectives"].setdefault(
                    kind, {"count": 0, "ms": 0.0})
                dst["bytes_per_exec"] = cb.get("bytes")
                dst["modeled_ops_per_exec"] = cb.get("ops")

    for row in sites.values():
        execs = row["executions"]
        for kind, c in row["collectives"].items():
            if kind in collectives and "bytes_per_exec" in c \
                    and c["bytes_per_exec"] is not None:
                collectives[kind]["bytes"] = (
                    collectives[kind].get("bytes", 0)
                    + c["bytes_per_exec"] * max(execs, 1))
    for c in collectives.values():
        c["ms"] = round(c["ms"], 4)

    wall_s = wall_ms / 1e3 if wall_ms > 0 else None
    ledger = {
        "peak_flops": peak_flops,
        "peak_flops_source": peak_src,
        "model_flops_total": model_flops_total if flops_known else None,
        "model_flops_per_s": round(model_flops_total / wall_s, 3)
        if flops_known and wall_s else None,
        "mfu": round(model_flops_total / wall_s / peak_flops, 6)
        if flops_known and wall_s and peak_flops else None,
        "goodput_busy_frac": round(busy_frac, 6),
        "steps": steps,
        "wall_ms_per_step": round(wall_ms / steps, 4)
        if steps else None,
        "device_busy_ms_per_step": round(device_busy_ms / steps, 4)
        if steps else None,
        "host_gap_ms_per_step": round(host_gap_ms / steps, 4)
        if steps else None,
    }

    host: Dict[str, dict] = {}
    for name, _ts, dur in tl.host_spans:
        h = host.setdefault(name, {"count": 0, "ms": 0.0})
        h["count"] += 1
        h["ms"] += dur / 1e3
    for h in host.values():
        h["ms"] = round(h["ms"], 4)

    return {
        "kind": "device_trace_summary",
        "label": label,
        "platform": platform,
        "unix_time": round(time.time(), 3),
        "steps": steps,
        "events_total": tl.events_total,
        "device_ops": len(tl.device_ops),
        "empty": not tl.device_ops,
        "wall_ms": round(wall_ms, 4),
        "device_busy_ms": round(device_busy_ms, 4),
        "host_gap_ms": round(host_gap_ms, 4),
        "busy_frac": round(busy_frac, 6),
        "categories": {c: {"count": v["count"], "ms": round(v["ms"], 4)}
                       for c, v in categories.items()},
        "collectives": collectives,
        "comm_ms": round(comm_ms, 4),
        "comm_overlap_frac": round(comm_overlap, 6),
        "comm_traced_ms_per_step": round(comm_ms / steps, 4)
        if steps else None,
        "sites": sites,
        "unattributed_modules": unattributed,
        "ledger": ledger,
        "host_annotations": host,
    }


# ---------------------------------------------------------------------------
# summary recording: gauges + sink artifact + last-summary slot
# ---------------------------------------------------------------------------
_last_lock = threading.Lock()
_last: Optional[dict] = None


def last_summary() -> Optional[dict]:
    """The most recent recorded summary (what flight-recorder dumps
    carry); None before any capture completed."""
    with _last_lock:
        return _last


def reset() -> None:
    global _last
    with _last_lock:
        _last = None


def record_summary(summary: dict) -> dict:
    """Fold a summary into the registry gauges (``trace/*``,
    ``phase/comm_traced_ms``, ``phase/comm_overlap_frac``), write it
    through an active sink as ``trace_summary.json`` (atomic rewrite) and
    keep it for flight dumps. Never raises.

    A degraded summary (a skipped capture, a parse error: no ``wall_ms``)
    is only counted (``trace/windows_degraded``): it must not replace the
    last good summary, feed the gauges or overwrite the sink's artifact
    with a document its schema rejects."""
    global _last
    if "wall_ms" not in summary:
        try:
            registry().counter("trace/windows_degraded").add(1)
        except Exception:
            pass
        return summary
    try:
        reg = registry()
        reg.gauge("trace/device_busy_ms").set(summary["device_busy_ms"])
        reg.gauge("trace/host_gap_ms").set(summary["host_gap_ms"])
        reg.gauge("trace/goodput_busy_frac").set(summary["busy_frac"])
        reg.gauge("trace/device_ops").set(float(summary["device_ops"]))
        per_step = summary.get("comm_traced_ms_per_step")
        reg.gauge("phase/comm_traced_ms").set(
            per_step if per_step is not None else summary["comm_ms"])
        reg.gauge("phase/comm_overlap_frac").set(
            summary["comm_overlap_frac"])
        for kind, c in summary.get("collectives", {}).items():
            reg.gauge(f"trace/comm/{kind}_ms").set(c["ms"])
        led = summary.get("ledger") or {}
        if led.get("mfu") is not None:
            reg.gauge("trace/mfu").set(led["mfu"])
        if led.get("model_flops_per_s") is not None:
            reg.gauge("trace/model_flops_per_s").set(
                led["model_flops_per_s"])
        reg.counter("trace/windows_recorded").add(1)
    except Exception:
        pass
    with _last_lock:
        _last = summary
    try:
        from . import sink as _sink

        s = _sink.active_sink()
        if s is not None:
            path = os.path.join(s.directory, "trace_summary.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(summary, f)
            os.replace(tmp, path)
    except Exception:
        pass
    return summary


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------
def _degraded(label: str, **why) -> dict:
    return {"kind": "device_trace_summary", "label": label, "empty": True,
            **why}


class capture:  # noqa: N801 - context manager, lowercase like scope
    """Wrap a window of hot-loop iterations in a ``torch.profiler``
    trace and parse it on exit::

        with device_trace.capture(steps=4, label="hybrid.step") as cap:
            for _ in range(4):
                step()
        cap.summary              # dict (see summarize)
        cap.timeline             # the parsed Timeline

    Stopping the profiler waits for the card, so no launched work is cut
    off. ``log_dir=None`` traces into a temporary directory removed after
    parsing (``keep_files=True`` keeps it; ``cap.trace_file`` names the
    file). ``steps`` may be set inside the block. One profiler runs per
    process: if another is active (``profiler.enable(trace_dir=...)``, a
    caller's own ``torch.profiler.profile``), the capture does nothing
    and ``summary = {"skipped": ...}``. Parse failures land in
    ``summary["error"]``; neither kind of degraded summary is recorded
    (:func:`record_summary` counts it).
    """

    def __init__(self, log_dir: Optional[str] = None,
                 steps: Optional[int] = None,
                 peak_flops: Optional[float] = None,
                 label: str = "trace", keep_files: bool = False):
        self.log_dir = log_dir
        self.steps = steps
        self.peak_flops = peak_flops
        self.label = label
        self.keep_files = keep_files or log_dir is not None
        self.summary: Optional[dict] = None
        self.timeline: Optional[Timeline] = None
        self.trace_file: Optional[str] = None
        self._dir: Optional[str] = None
        self._tmp = False
        self._prof = None

    def __enter__(self) -> "capture":
        import torch
        from torch.profiler import ProfilerActivity, profile

        if torch.autograd._profiler_enabled():
            # a second session would break the running one
            self.summary = _degraded(
                self.label, skipped="another torch.profiler session is "
                                    "active")
            return self
        if self.log_dir is None:
            self._dir = tempfile.mkdtemp(prefix="ptpu-trace-")
            self._tmp = True
        else:
            os.makedirs(self.log_dir, exist_ok=True)
            self._dir = self.log_dir
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        try:
            prof = profile(activities=acts)
            prof.__enter__()
            self._prof = prof
        except Exception as e:
            self.summary = _degraded(self.label, skipped=str(e))
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._prof is not None:
            prof, self._prof = self._prof, None
            try:
                prof.__exit__(None, None, None)
                if exc_type is None:
                    path = os.path.join(
                        self._dir, f"torch-{os.getpid()}.trace.json")
                    prof.export_chrome_trace(path)
            except Exception as e:
                self.summary = _degraded(self.label,
                                         error=f"stop/export: {e}")
            else:
                if exc_type is None:
                    self._parse()
        if self.summary is not None and exc_type is None:
            record_summary(self.summary)
        if self._tmp and not self.keep_files and self._dir:
            shutil.rmtree(self._dir, ignore_errors=True)
            self.trace_file = None
        return False

    def _parse(self) -> None:
        path = find_trace_file(self._dir)
        if path is None:
            self.summary = _degraded(self.label,
                                     error="no trace file exported")
            return
        self.trace_file = path
        try:
            self.timeline = parse_timeline(load_trace_events(path))
            self.summary = summarize(self.timeline, steps=self.steps,
                                     peak_flops=self.peak_flops,
                                     label=self.label)
        except TraceParseError as e:
            self.summary = _degraded(self.label, error=str(e))


#: package-level spellings (``profiler.trace_capture`` /
#: ``profiler.last_trace_summary``)
trace_capture = capture
last_trace_summary = last_summary


class TraceWindow:
    """Windowed capture scheduler: trace iterations N..N+length-1, every
    ``every`` iterations (``every=0``: one window only)::

        win = TraceWindow(length=2, every=100, start=10)
        for i in range(steps):
            with win.step():
                trainer.step(batch)
        win.last            # newest summary; win.summaries holds all

    ``max_windows`` bounds how many windows fire (0 = unbounded); each is
    one :class:`capture` (steps=length). A window start that meets an
    active profiler is skipped and counted (``win.skipped``)."""

    def __init__(self, length: int = 2, every: int = 0, start: int = 0,
                 log_dir: Optional[str] = None,
                 peak_flops: Optional[float] = None,
                 label: str = "window", max_windows: int = 0,
                 keep_files: bool = False):
        if length < 1:
            raise ValueError("length must be >= 1")
        if every and every < length:
            raise ValueError("every must be 0 or >= length "
                             "(windows must not overlap)")
        self.length = int(length)
        self.every = int(every)
        self.start = int(start)
        self.log_dir = log_dir
        self.peak_flops = peak_flops
        self.label = label
        self.max_windows = int(max_windows)
        self.keep_files = keep_files
        self.summaries: List[dict] = []
        self.skipped = 0
        self._i = 0
        self._cap: Optional[capture] = None
        self._end = -1

    @property
    def last(self) -> Optional[dict]:
        return self.summaries[-1] if self.summaries else None

    def _should_start(self, i: int) -> bool:
        if self.max_windows and len(self.summaries) >= self.max_windows:
            return False
        if i < self.start:
            return False
        if self.every:
            return (i - self.start) % self.every == 0
        return i == self.start

    def step(self) -> "_WindowStep":
        """Context manager wrapping ONE hot-loop iteration."""
        return _WindowStep(self)


class _WindowStep:
    __slots__ = ("_w",)

    def __init__(self, window: TraceWindow):
        self._w = window

    def __enter__(self):
        w = self._w
        if w._cap is None and w._should_start(w._i):
            n = len(w.summaries)
            sub = os.path.join(w.log_dir, f"window-{n}") \
                if w.log_dir else None
            cap = capture(log_dir=sub, steps=w.length,
                          peak_flops=w.peak_flops,
                          label=f"{w.label}#{n}",
                          keep_files=w.keep_files)
            cap.__enter__()
            if cap._prof is None:
                # another profiler is live: nothing was started, and the
                # capture's __exit__ will never run to remove its dir
                if cap._tmp and cap._dir:
                    shutil.rmtree(cap._dir, ignore_errors=True)
                w.skipped += 1
            else:
                w._cap = cap
                w._end = w._i + w.length - 1
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        w = self._w
        try:
            if w._cap is not None and (w._i >= w._end
                                       or exc_type is not None):
                cap = w._cap
                w._cap = None
                cap.__exit__(exc_type, exc, tb)
                if exc_type is None and cap.summary is not None:
                    w.summaries.append(cap.summary)
        finally:
            w._i += 1
        return False
