"""paddle_tpu_torch.profiler: runtime observability (mirrors
``paddle_tpu/profiler``).

- **Spans** (``trace.py``): ``scope``/``RecordEvent`` host spans that are
  also ``torch.profiler`` ranges, ``annotate``, ``scope_summary`` and the
  Chrome-trace export. ``enable(trace_dir=...)`` also records a
  ``torch.profiler`` trace (host ranges and the card's kernels) and
  ``disable()`` writes it there.
- **Metrics** (``metrics.py``): counters, gauges and sketch-backed
  histograms in one process-global registry.
- **Event timelines** (``events.py``): the serving engine's lifecycle
  events, per-request latency breakdowns, rolling TTFT/TPOT percentiles
  and the flight recorder.
- **The sink** (``sink.py``): registry and events on disk
  (``metrics.jsonl``, ``events.jsonl``, ``metrics.prom``, telemetry
  frames), checked by ``tools/check_sink_schema.py``.
- **Dispatch-site telemetry** (``recompile.py``): the argument signatures
  each hot-path site has run (``ServingEngine.compiled_sites``,
  ``HybridPipelineTrainer``'s ``hybrid.step`` site).
- **The program inventory** (``program_stats.py``): each site's first
  dispatch counted (FLOPs, bytes accessed, per-category breakdown, the
  wall time it took), folded into ``summary()["programs"]`` by
  ``ServingEngine.record_program_stats()`` and
  ``HybridPipelineTrainer.profile_step_phases``.
- **Device time** (``device_trace.py``): ``trace_capture`` /
  ``TraceWindow`` parse a ``torch.profiler`` window into device-busy time
  and host gap, per-category and per-site device milliseconds and an MFU
  ledger over the sites' counted FLOPs (``ServingEngine.trace_window()``,
  ``profile_step_phases(trace_window=k)``).
- **Instrumentation** (``instrument.py``): device-memory high-water marks,
  the memory ledger, the phase decomposition, token counting.

Quick use::

    from paddle_tpu_torch import profiler
    profiler.enable(trace_dir="trace")      # resets the registry
    ... serve or train ...
    print(profiler.summary())
    profiler.disable()                      # writes the Chrome trace

Since the distributed slice (ROADMAP queue 1 item 7a): the collective
accounting (``count_collectives``, ``collective_stats`` and its
recorders, counted at the port's collective wrappers) and the cross-rank
reduction (``summary(aggregate=True)``). Since the serving mesh (ROADMAP
queue 1 item 8a): clock agreement (``disttrace.ClockSync``; the agreed
offset and the adopted consensus epochs ride every sink line, frame and
flight dump). Since resilience (item 8b): the live mesh telemetry plane
(``live.py``: ``LiveAggregator`` tails every rank's frames, merges their
sketches, tracks staleness with lease corroboration and the board's
membership, writes ``mesh_status.json``, ``mesh_status.prom`` and
``mesh_status_history.jsonl`` and fires ``AlertRule`` rules, each firing an
``alert`` event, a sink flush with reason ``alert`` and, the first time,
a flight dump; its viewer is ``python -m paddle_tpu_torch.profiler.live
ROOT``), and the watchdog's hooks: ``resilience.StepWatchdog`` dumps
``live_spans``/``scope_summary`` and the flight recorder and flushes the
sink with reason ``watchdog``; the runner's rollbacks emit ``rollback``
events and flush with reason ``rollback``. ``live`` is imported at its
first use (``profiler.LiveAggregator`` or ``from paddle_tpu_torch.
profiler import live``), so the viewer runs as ``-m`` without a second
copy of the module.
"""
from __future__ import annotations

from . import disttrace, events, metrics, recompile, sink, sketch  # noqa
from . import device_trace, instrument, program_stats, trace  # noqa: F401
from .device_trace import (TraceWindow, last_trace_summary,  # noqa: F401
                           trace_capture)
from .disttrace import clock_state, set_clock_state, trace_id  # noqa
from .events import (EventLog, FlightRecorder, dump_flight,  # noqa: F401
                     emit, flight_recorder, latency_breakdown,
                     latency_table, request_latency_stats)
from .events import log as event_log  # noqa: F401
from .instrument import (collective_stats, count_collectives,  # noqa
                         device_memory_stats, estimate_comm_ms,
                         record_collective_stats, record_collectives_from,
                         record_memory_high_water, record_memory_ledger,
                         record_phases, tokens_in_batch)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,  # noqa
                      registry)
from .program_stats import program_inventory  # noqa: F401
from .recompile import (mark_trace, retraces, suppressed,  # noqa: F401
                        trace_counts, unique_site, watch)
from .sink import (MetricsSink, active_sink, disable_sink,  # noqa: F401
                   enable_sink, flush_active, prometheus_text)
from .sketch import QuantileSketch  # noqa: F401
from .trace import (RecordEvent, annotate, chrome_trace,  # noqa: F401
                    export_chrome_trace, is_enabled, live_spans, scope,
                    scope_summary)

__all__ = [
    "enable", "disable", "is_enabled", "reset",
    "scope", "RecordEvent", "annotate",
    "scope_summary", "chrome_trace", "export_chrome_trace", "live_spans",
    "registry", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "mark_trace", "watch", "retraces", "trace_counts", "suppressed",
    "unique_site",
    "collective_stats", "record_collective_stats",
    "record_collectives_from", "count_collectives", "estimate_comm_ms", "record_phases", "device_memory_stats",
    "record_memory_high_water", "record_memory_ledger", "tokens_in_batch",
    "summary",
    "emit", "event_log", "EventLog", "latency_breakdown", "latency_table",
    "request_latency_stats", "flight_recorder", "FlightRecorder",
    "dump_flight",
    "MetricsSink", "enable_sink", "disable_sink", "active_sink",
    "flush_active", "prometheus_text",
    "program_inventory",
    "trace_capture", "TraceWindow", "last_trace_summary",
    "trace_id", "clock_state", "set_clock_state",
    "QuantileSketch", "LiveAggregator", "AlertRule", "default_rules",
]

#: the live plane's names, imported from ``live.py`` at their first use
_LIVE = ("LiveAggregator", "AlertRule", "default_rules")


def __getattr__(name):
    if name == "live" or name in _LIVE:
        import importlib

        live = importlib.import_module(".live", __name__)
        return live if name == "live" else getattr(live, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def enable(trace_dir=None, reset: bool = True) -> None:
    """Turn profiling on. ``reset`` (default) clears earlier host spans,
    the metrics registry, the event log, the program inventory, the last
    trace summary and the public retrace log, so
    the counters and rates cover this enabled window alone; the
    signatures each site ran and the event sequence numbers are kept (an
    active sink first drains the ring). ``trace_dir`` also starts a
    ``torch.profiler`` trace that ``disable()`` writes there."""
    if reset:
        sink.flush_active("reset")
        trace.reset_events()
        metrics.registry().reset()
        recompile.clear_log()
        events.log().clear()
        program_stats.reset()
        device_trace.reset()
    trace.enable(trace_dir=trace_dir, reset=False)


def disable() -> dict:
    """Stop profiling (and write the device trace, if one runs); returns
    ``summary()`` as it stood just before."""
    s = summary()
    trace.disable()
    return s


def reset() -> None:
    """Clear spans, metrics, events, the program inventory, the last
    trace summary and the signatures each site ran (the enabled flag and
    the event sequence numbers are kept; an active sink drains the ring
    first)."""
    sink.flush_active("reset")
    trace.reset_events()
    metrics.registry().reset()
    recompile.reset()
    events.log().clear()
    program_stats.reset()
    device_trace.reset()


def summary(aggregate: bool = False) -> dict:
    """Everything the profiler observed, JSON-ready: per-scope host
    spans, the metrics snapshot, rates over the enabled window
    (``train/*`` counters per second), the ``phase/*`` gauges, the
    retrace log, ``events_lost`` (events aged out of the ring) and the
    sink's health. ``programs`` is the program inventory
    (``program_stats.inventory()``: the sites recorded since the last
    reset). ``aggregate=True`` reduces the metrics across ranks
    (``MetricsRegistry.aggregate``); every rank must call it."""
    reg = metrics.registry()
    snap = reg.aggregate() if aggregate else reg.snapshot()
    window_s = trace.enabled_window_s()
    rates = {}
    phases = {}
    for name, s in snap.items():
        if s["type"] == "counter" and window_s > 0 and \
                name.startswith("train/"):
            rates[name.split("/", 1)[1] + "_per_sec"] = round(
                s["value"] / window_s, 3)
        if name.startswith("phase/") and s.get("value") is not None:
            phases[name.split("/", 1)[1]] = round(s["value"], 4)
    return {"enabled_window_s": round(window_s, 6),
            "scopes": trace.scope_summary(),
            "metrics": snap,
            "rates": rates,
            "phases_ms": phases,
            "retraces": recompile.retraces(),
            "programs": program_stats.inventory(),
            "events_lost": events.log().dropped,
            "sink": sink.stats()}
