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

Quick use::

    from paddle_tpu_torch import profiler
    profiler.enable(trace_dir="trace")      # resets the registry
    ... serve or train ...
    print(profiler.summary())
    profiler.disable()                      # writes the Chrome trace

Not yet here: device-time parsing and program stats (ROADMAP queue 1
item 6c: ``summary()["programs"]`` stays empty), cross-rank aggregation
(item 7a) and clock agreement, live telemetry and the watchdog hooks
(item 8).
"""
from __future__ import annotations

from . import disttrace, events, metrics, recompile, sink, sketch  # noqa
from . import trace  # noqa: F401
from .disttrace import clock_state, set_clock_state, trace_id  # noqa
from .events import (EventLog, FlightRecorder, dump_flight,  # noqa: F401
                     emit, flight_recorder, latency_breakdown,
                     latency_table, request_latency_stats)
from .events import log as event_log  # noqa: F401
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,  # noqa
                      registry)
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
    "summary",
    "emit", "event_log", "EventLog", "latency_breakdown", "latency_table",
    "request_latency_stats", "flight_recorder", "FlightRecorder",
    "dump_flight",
    "MetricsSink", "enable_sink", "disable_sink", "active_sink",
    "flush_active", "prometheus_text",
    "trace_id", "clock_state", "set_clock_state",
    "QuantileSketch",
]


def enable(trace_dir=None, reset: bool = True) -> None:
    """Turn profiling on. ``reset`` (default) clears earlier host spans,
    the metrics registry, the event log and the public retrace log, so
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
    trace.enable(trace_dir=trace_dir, reset=False)


def disable() -> dict:
    """Stop profiling (and write the device trace, if one runs); returns
    ``summary()`` as it stood just before."""
    s = summary()
    trace.disable()
    return s


def reset() -> None:
    """Clear spans, metrics, events and the signatures each site ran
    (the enabled flag and the event sequence numbers are kept; an active
    sink drains the ring first)."""
    sink.flush_active("reset")
    trace.reset_events()
    metrics.registry().reset()
    recompile.reset()
    events.log().clear()


def summary(aggregate: bool = False) -> dict:
    """Everything the profiler observed, JSON-ready: per-scope host
    spans, the metrics snapshot, rates over the enabled window
    (``train/*`` counters per second), the ``phase/*`` gauges, the
    retrace log, ``events_lost`` (events aged out of the ring) and the
    sink's health. ``programs`` is the reference's compiled-program
    inventory: empty until ROADMAP queue 1 item 6c ports its
    ``record_program_stats``. ``aggregate=True`` (the cross-rank
    reduction) comes with item 7a."""
    if aggregate:
        raise NotImplementedError(
            "summary(aggregate=True) is not ported yet: ROADMAP queue 1 "
            "item 7a (MetricsRegistry.aggregate)")
    snap = metrics.registry().snapshot()
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
            "programs": {},
            "events_lost": events.log().dropped,
            "sink": sink.stats()}
