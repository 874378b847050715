"""Instrumentation helpers shared by the trainer and engine hooks (mirrors
``paddle_tpu/profiler/instrument.py``).

- device memory: ``device_memory_stats`` reads ``torch.cuda.memory_stats``
  and ``mem_get_info`` under the reference's key names (``bytes_in_use``,
  ``peak_bytes_in_use``, ``bytes_limit``); a CPU device reports nothing
  (None), as the reference's CPU backend does;
- the memory ledger: resident bytes per state category
  (``record_memory_ledger``), each tensor counted at its own bytes (the
  port runs at degree 1: no tensor is sharded);
- the phase decomposition (``record_phases``) and the timing helper the
  trainers share (``time_compiled``);
- batch token counting for throughput metrics (``tokens_in_batch``).

The collective accounting of the reference (``collective_stats``,
``record_collective_stats``, ``record_collectives_from``) comes with
ROADMAP queue 1 item 7a, when the port has collectives to count.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from .metrics import registry
from .recompile import _leaves

__all__ = ["device_memory_stats", "record_memory_high_water",
           "record_memory_ledger", "estimate_comm_ms", "time_compiled",
           "record_phases", "tokens_in_batch"]


def device_memory_stats(device=None) -> Optional[dict]:
    """The CUDA allocator's statistics of ``device`` (default: the current
    CUDA device) under the reference's key names: ``bytes_in_use`` and
    ``peak_bytes_in_use`` (bytes held by tensors now and at most since
    the process started or the peak was reset), ``bytes_reserved`` (held
    by the caching allocator) and ``bytes_limit`` (the card's memory).
    None for a CPU device or where CUDA reports nothing; never raises."""
    try:
        if device is None:
            if not torch.cuda.is_available():
                return None
            dev = torch.device("cuda", torch.cuda.current_device())
        else:
            dev = torch.device(device)
        if dev.type != "cuda":
            return None
        st = torch.cuda.memory_stats(dev)
        _, total = torch.cuda.mem_get_info(dev)
    except Exception:
        return None
    if not st:
        return None
    return {"bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(st.get("reserved_bytes.all.current", 0)),
            "bytes_limit": int(total)}


def record_memory_high_water(prefix: str = "memory",
                             device=None) -> Optional[int]:
    """Record the device-memory high-water mark (bytes) as a max-gauge
    (``{prefix}/peak_bytes_in_use``, with ``{prefix}/bytes_in_use``
    beside it). Returns the peak, or None (and sets no gauge) where the
    device has no stats: a CPU device."""
    st = device_memory_stats(device)
    if st is None:
        return None
    peak = st.get("peak_bytes_in_use", st.get("bytes_in_use"))
    if peak is None:
        return None
    reg = registry()
    reg.gauge(f"{prefix}/peak_bytes_in_use").set_max(int(peak))
    if "bytes_in_use" in st:
        reg.gauge(f"{prefix}/bytes_in_use").set(int(st["bytes_in_use"]))
    return int(peak)


def _per_rank_bytes(v) -> int:
    """Resident bytes of one ledger entry: a tree (tuples, lists, dicts)
    of tensors, each counted at its own ``numel * element_size`` (the
    reference counts a sharded array at its shard's shape; at degree 1
    that is the whole tensor), or a plain int (bytes computed by the
    caller, e.g. a transient gradient buffer)."""
    if isinstance(v, int):
        return v
    return sum(a.numel() * a.element_size() for a in _leaves(v, []))


def record_memory_ledger(categories: dict, prefix: str = "mem") -> dict:
    """Resident bytes per state category (``param`` / ``grad`` /
    ``opt_state`` / ``master``...): each value is a tree of tensors or a
    byte count, folded into the ``{prefix}/{name}_bytes`` gauge.
    Returns ``{name: bytes}``."""
    reg = registry()
    out = {}
    for name, v in categories.items():
        b = _per_rank_bytes(v)
        out[name] = b
        reg.gauge(f"{prefix}/{name}_bytes").set(b)
    return out


# Nominal link rate (bytes/s, one direction) of the comm-phase MODEL
# below: an H100 SXM's NVLink 4 is 900 GB/s both directions together; the
# CPU figure is a loopback placeholder. Neither is measured.
_LINK_BW = {"cuda": 450e9, "cpu": 10e9}


def estimate_comm_ms(total_bytes: int, platform: str = "cuda") -> float:
    """Lower-bound comm-phase time: collective bytes over the nominal
    link rate. A MODEL, not a measurement (no overlap, no algorithm); 0
    for a step with no collectives, as every degree-1 step is."""
    return total_bytes / _LINK_BW.get(platform, _LINK_BW["cuda"]) * 1e3


def _first_leaf(o) -> float:
    """A host read of the first element of the first tensor in ``o``:
    waits for the work that produced it."""
    t = next(x for x in _leaves(o, []) if torch.is_tensor(x))
    return float(t.reshape(-1)[0])


def time_compiled(fn, iters: int = 2) -> float:
    """Mean seconds per call of ``fn``: one warm call, then ``iters``
    timed calls ended by a host read of the first output's first element
    (the sync point of asynchronous launches), as the reference times its
    compiled programs. Shared by ``profile_step_phases`` so the phase
    numbers stay comparable."""
    _first_leaf(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    _first_leaf(out)
    return (time.perf_counter() - t0) / iters


def record_phases(fwd_s=None, fwdbwd_s=None, step_s=None,
                  comm_bytes=None, platform: str = "cuda",
                  cost_bytes_accessed=None) -> dict:
    """Fold a phase decomposition (seconds; any may be None) into the
    ``phase/*_ms`` gauges: bwd = fwdbwd − fwd, optim = step − fwdbwd,
    ``comm_ms`` the nominal-rate model of ``comm_bytes`` and
    ``comm_measured_ms`` the step's wall time apportioned by the
    collective bytes' share of ``cost_bytes_accessed`` (the step site's
    counted bytes). Returns the phases (ms)."""
    reg = registry()
    out = {}
    if fwd_s is not None:
        out["fwd_ms"] = fwd_s * 1e3
    if fwdbwd_s is not None and fwd_s is not None:
        out["bwd_ms"] = max(fwdbwd_s - fwd_s, 0.0) * 1e3
    if step_s is not None:
        out["step_ms"] = step_s * 1e3
        if fwdbwd_s is not None:
            out["optim_ms"] = max(step_s - fwdbwd_s, 0.0) * 1e3
    if comm_bytes is not None:
        out["comm_ms"] = estimate_comm_ms(comm_bytes, platform)
        if step_s is not None and cost_bytes_accessed:
            share = min(float(comm_bytes) / float(cost_bytes_accessed),
                        1.0)
            out["comm_measured_ms"] = step_s * 1e3 * share
    for k, v in out.items():
        reg.gauge(f"phase/{k[:-3]}_ms").set(round(v, 4))
    return {k: round(v, 4) for k, v in out.items()}


def tokens_in_batch(batch) -> int:
    """Throughput accounting of a step's batch: ``batch*seq`` when the
    first array-like argument is a 2-d integer tensor (a token grid),
    else its first dimension (samples)."""
    for b in batch:
        shape = getattr(b, "shape", None)
        if shape is None or len(shape) == 0:
            continue
        if len(shape) == 2 and "int" in str(getattr(b, "dtype", "")):
            return int(shape[0]) * int(shape[1])
        return int(shape[0])
    return 0
