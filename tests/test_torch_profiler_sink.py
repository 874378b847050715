"""paddle_tpu_torch.profiler's metrics sink and flight recorder, held
against the JAX package's.

Both sinks flush the same registry content and events; their artifacts
(``metrics.jsonl``, ``events.jsonl``, ``metrics.prom`` and the telemetry
frames) must agree in everything but the timestamps and sequence numbers,
and every directory a port sink writes here must pass
``tools/check_sink_schema.py``. Rotation of an earlier session's files,
the at-least-once event cursor, the ``events_lost`` count and the flight
recorder follow the reference's own tests.
"""
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import paddle_tpu.profiler as jprof
from paddle_tpu.profiler import events as jev
from paddle_tpu.profiler import sink as jsink
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.profiler import events as tev
from paddle_tpu_torch.profiler import sink as tsink
from paddle_tpu_torch.profiler.events import EventLog, FlightRecorder
from paddle_tpu_torch.profiler.sink import MetricsSink

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKER = os.path.join(REPO, "tools", "check_sink_schema.py")


@pytest.fixture(autouse=True)
def _clean():
    """No active sink, an empty event ring and a registry holding one
    counter in both packages (the schema wants a TYPE line in every
    metrics.prom; sequence numbers keep advancing: the documented clear()
    contract)."""
    for s, p, ev in ((tsink, tprof, tev), (jsink, jprof, jev)):
        s.disable_sink()
        p.reset()
        ev.set_enabled(True)
        p.registry().counter("test/runs").add(1)
    yield
    for s, p in ((tsink, tprof), (jsink, jprof)):
        s.disable_sink()
        p.reset()


def _checker():
    spec = importlib.util.spec_from_file_location("check_sink_schema",
                                                  CHECKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    schema = json.load(open(os.path.join(os.path.dirname(CHECKER),
                                         "sink_schema.json")))
    return mod, schema


def _schema_errors(d):
    """Every violation check_sink_schema.py finds in sink directory ``d``,
    its telemetry frames included."""
    mod, schema = _checker()
    mod._ERRORS.clear()
    mod.check_metrics_jsonl(os.path.join(d, "metrics.jsonl"), schema)
    mod.check_events_jsonl(os.path.join(d, "events.jsonl"), schema)
    mod.check_prometheus(os.path.join(d, "metrics.prom"), schema)
    if os.path.isdir(os.path.join(d, "frames")):
        mod.check_frames_dir(os.path.join(d, "frames"), schema)
    errs = list(mod._ERRORS)
    mod._ERRORS.clear()
    return errs


def _lines(d, name):
    return [json.loads(x) for x in open(os.path.join(d, name))]


def _feed(prof, lg):
    """The same registry content into one package's registry, the same
    events into ``lg`` (an EventLog or the events module); returns lg."""
    reg = prof.registry()
    reg.counter("serving/tokens_generated").add(32)
    reg.counter("train/steps").add(3)
    reg.gauge("serving/page_util").set(0.25)
    for v in np.random.RandomState(1).gamma(2.0, 20.0, 64):
        reg.histogram("serving/ttft_ms").observe(float(v))
    lg.emit("submit", rid=0, eng=1, prompt_tokens=8, max_new=4)
    lg.emit("accept", rid=0, eng=1, slot=0, accepted=2, drafted=3)
    lg.emit("finish", rid=0, eng=1, tokens=4, reason="max_new",
            preempts=0, ttft_ms=1.5, tpot_ms=0.25)
    return lg


def test_sink_artifacts_and_frames_equal_reference(tmp_path):
    dirs = {}
    for name, prof, ev, sink in (("ref", jprof, jev, jsink),
                                 ("port", tprof, tev, tsink)):
        d = dirs[name] = str(tmp_path / name)
        lg = _feed(prof, ev.EventLog())      # both logs start at seq 0
        with sink.MetricsSink(d, interval_s=60.0, event_log=lg) as s:
            s.flush("manual")
            prof.registry().counter("serving/tokens_generated").add(8)
    ref, port = dirs["ref"], dirs["port"]
    assert _schema_errors(port) == []
    # metrics lines: the same keys, reasons, losses and snapshots
    rl, pl = _lines(ref, "metrics.jsonl"), _lines(port, "metrics.jsonl")
    assert [sorted(x) for x in pl] == [sorted(x) for x in rl]
    assert [x["reason"] for x in pl] == ["manual", "exit"]
    for a, b in zip(pl, rl):
        assert a["metrics"] == b["metrics"]
        assert (a["flush_seq"], a["events_lost"], a["rank"]) == \
            (b["flush_seq"], b["events_lost"], b["rank"])
        assert sorted(a["clock"]) == sorted(b["clock"])
        assert a["clock"]["synced"] is False
    # events: each once, with the writer's rank; seq and t_ns differ
    strip = ("seq", "t_ns")
    assert [{k: v for k, v in e.items() if k not in strip}
            for e in _lines(port, "events.jsonl")] == \
        [{k: v for k, v in e.items() if k not in strip}
         for e in _lines(ref, "events.jsonl")]
    assert open(os.path.join(port, "metrics.prom")).read() == \
        open(os.path.join(ref, "metrics.prom")).read()
    # frames: one a flush, the same counters (with deltas), gauges and
    # sketches
    for seq in (0, 1):
        fr = json.load(open(os.path.join(ref, "frames",
                                         f"rank0-{seq}.json")))
        fp = json.load(open(os.path.join(port, "frames",
                                         f"rank0-{seq}.json")))
        assert sorted(fp) == sorted(fr)
        for k in ("kind", "rank", "seq", "counters", "gauges", "sketches",
                  "events_lost"):
            assert fp[k] == fr[k], k
        # the reference's are the consensus epochs its process adopted
        # (other tests in this process may have); the port has none yet
        assert fp["adopted_epochs"] == {}
    assert fp["counters"]["serving/tokens_generated"] == {"v": 40.0,
                                                          "d": 8.0}


def test_schema_checker_cli_accepts_port_sink(tmp_path):
    d = str(tmp_path / "sink")
    _feed(tprof, tev)
    tsink.enable_sink(d, interval_s=60.0)
    tsink.flush_active("manual")
    tsink.disable_sink()
    out = subprocess.run([sys.executable, CHECKER, d], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "sink schema: OK" in out.stdout


def test_active_sink_lifecycle_and_stats(tmp_path):
    assert tsink.stats() == jsink.stats()
    assert tsink.flush_active("nothing") is None
    a = tsink.enable_sink(str(tmp_path / "a"), interval_s=60.0)
    b = tsink.enable_sink(str(tmp_path / "b"), interval_s=60.0)
    assert tsink.active_sink() is b
    reasons = [x["reason"] for x in _lines(a.directory, "metrics.jsonl")]
    assert reasons[-1] == "replaced"
    a.close()                              # idempotent: no extra line
    assert len(_lines(a.directory, "metrics.jsonl")) == len(reasons)
    st = tsink.stats()
    assert st["active"] and st["directory"] == b.directory
    assert set(st) == {"active", "directory", "flushes", "flush_errors",
                       "frames", "frame_errors", "last_error"}
    assert tprof.summary()["sink"] == st
    tprof.reset()                          # drains the ring: "reset"
    tprof.registry().counter("test/runs").add(1)
    tsink.disable_sink()
    assert tsink.active_sink() is None
    assert [x["reason"] for x in _lines(b.directory, "metrics.jsonl")] == \
        ["reset", "disabled"]
    for d in (a.directory, b.directory):
        assert _schema_errors(d) == []


def test_per_rank_subdirectory(tmp_path, monkeypatch):
    monkeypatch.setattr(tsink, "_detect_world", lambda: 2)
    s = tsink.enable_sink(str(tmp_path), interval_s=60.0, rank=1)
    assert s.directory == str(tmp_path / "rank1") and s.rank == 1
    tev.emit("submit", rid=3)
    tsink.disable_sink()
    assert {e["rank"] for e in _lines(s.directory, "events.jsonl")} == {1}
    assert _schema_errors(s.directory) == []
    assert tsink._detect_rank() == 0       # no process group here


def test_interval_thread_flushes(tmp_path):
    d = str(tmp_path / "sink")
    tprof.registry().counter("t/x").add(1)
    with MetricsSink(d, interval_s=0.05) as s:
        deadline = time.time() + 5.0
        while s.flushes < 2 and time.time() < deadline:
            time.sleep(0.02)
    reasons = [x["reason"] for x in _lines(d, "metrics.jsonl")]
    assert "interval" in reasons and reasons[-1] == "exit"
    assert _schema_errors(d) == []


def test_dir_reuse_rotates_earlier_session(tmp_path):
    d = str(tmp_path / "sink")
    for rid in (1, 2):
        tev.emit("submit", rid=rid)
        with MetricsSink(d, interval_s=60.0):
            pass
    for name in ("metrics.jsonl", "events.jsonl"):
        assert os.path.exists(os.path.join(d, name + ".1"))
    assert [x["flush_seq"] for x in _lines(d, "metrics.jsonl")] == [0]
    # a new sink's cursor starts at 0: it streams the ring's whole content
    assert [e["rid"] for e in _lines(d, "events.jsonl.1")] == [1]
    assert [e["rid"] for e in _lines(d, "events.jsonl")] == [1, 2]
    assert _schema_errors(d) == []


def test_failed_event_write_resends_segment(tmp_path):
    """At least once: an I/O error leaves the cursor where it was, so
    the segment lands whole on the next flush, and the failed flush burns
    its flush_seq (a gap, never a duplicate)."""
    d = str(tmp_path / "sink")
    s = MetricsSink(d, interval_s=60.0)    # not started: no thread
    tev.emit("submit", rid=7)
    good = s._events_path
    s._events_path = os.path.join(d, "no-such-dir", "events.jsonl")
    with pytest.raises(OSError):
        s.flush("manual")
    assert s.flush_errors == 1 and "manual" in s.last_error
    s._events_path = good
    s.close()
    assert [e["rid"] for e in _lines(d, "events.jsonl")] == [7]
    assert [x["flush_seq"] for x in _lines(d, "metrics.jsonl")] == [1]
    assert _schema_errors(d) == []


def test_ring_overflow_counts_events_lost(tmp_path):
    lg = EventLog(capacity=4)
    s = MetricsSink(str(tmp_path), interval_s=60.0, event_log=lg)
    for i in range(3):
        lg.emit("submit", rid=i)
    assert s.flush("manual")["events_lost"] == 0
    for i in range(10):                    # seqs 3..12; the ring keeps 4
        lg.emit("submit", rid=i)
    assert s.flush("manual")["events_lost"] == 6
    s.close()
    rows = _lines(str(tmp_path), "metrics.jsonl")
    assert [r["events_lost"] for r in rows] == [0, 6, 0]
    assert [e["seq"] for e in _lines(str(tmp_path), "events.jsonl")] == \
        [0, 1, 2, 9, 10, 11, 12]
    assert _schema_errors(str(tmp_path)) == []


def test_frames_keep_the_newest(tmp_path):
    s = MetricsSink(str(tmp_path), interval_s=60.0, frame_keep=2)
    for _ in range(5):
        s.flush("manual")
    s.close()
    assert sorted(os.listdir(tmp_path / "frames")) == \
        ["rank0-4.json", "rank0-5.json"]
    assert s.frames_written == 6 and s.frame_errors == 0
    with pytest.raises(ValueError):
        MetricsSink(str(tmp_path), frame_keep=1)
    assert _schema_errors(str(tmp_path)) == []


def test_flight_recorder_deltas_equal_reference(tmp_path):
    docs = []
    for prof, ev in ((jprof, jev), (tprof, tev)):
        fr = ev.FlightRecorder(tail_events=2)
        prof.registry().counter("t/ticks").add(5)
        prof.registry().histogram("t/ms").observe(1.0)
        fr.mark()
        prof.registry().counter("t/ticks").add(2)
        prof.registry().counter("t/still").add(0)
        prof.registry().histogram("t/ms").observe(2.0)
        for i in range(3):
            ev.emit("watchdog_fire", step=i)
        path = str(tmp_path / f"{prof.__name__}.json")
        doc = fr.dump(path, reason="test")
        assert json.load(open(path))["reason"] == "test"
        docs.append(doc)
    ref, port = docs
    assert sorted(port) == sorted(ref)
    assert port["metric_deltas_since_mark"] == \
        ref["metric_deltas_since_mark"] == {"t/ticks": 2.0, "t/ms": 1.0}
    assert [e["step"] for e in port["events"]] == [1, 2]
    assert port["consensus_epochs"] == {} and port["trace_summary"] is None
    assert port["clock"] == ref["clock"]


def test_flight_dump_carries_the_last_trace_summary():
    """Beside the None case above: after a recorded device-trace window
    the dump carries that summary."""
    from paddle_tpu_torch.profiler import device_trace as tdt

    summary = tdt.summarize({"traceEvents": []}, label="t")
    tdt.record_summary(summary)
    assert tev.flight_recorder().dump(reason="t")["trace_summary"] is summary
    tprof.reset()
    assert tev.flight_recorder().dump(reason="t")["trace_summary"] is None


def test_dump_flight_paths(tmp_path):
    assert tev.dump_flight("nowhere") is None      # no sink, no path
    tsink.enable_sink(str(tmp_path / "sink"), interval_s=60.0)
    p = tev.dump_flight("bad step!")
    assert p is not None and os.path.exists(p)
    assert "bad-step-" in os.path.basename(p)      # sanitized reason
    assert json.load(open(p))["kind"] == "flight_recorder_dump"
    bad = str(tmp_path / "missing" / "dir" / "f.json")
    assert tev.dump_flight("x", path=bad) is None
    doc = FlightRecorder().dump(bad, reason="x")
    assert "write_error" in doc
