"""paddle_tpu_torch.profiler held against the JAX package's profiler.

The pure-host pieces (the latency breakdown, the latency table, the
rolling TTFT/TPOT stats, the Prometheus text, the retrace diffs, trace
ids, the summary's keys) run the same inputs through both packages and
must give equal results. Spans, the Chrome-trace export and the
``torch.profiler`` trace that ``enable(trace_dir=...)`` writes are checked
on the port alone, the last one on a tiny trainer step on the CPU.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu.profiler as jprof
from paddle_tpu.profiler import disttrace as jdist
from paddle_tpu.profiler import events as jev
from paddle_tpu.profiler import metrics as jmetrics
from paddle_tpu.profiler import recompile as jrec
from paddle_tpu.profiler import sink as jsink
from paddle_tpu.profiler import trace as jtrace
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.profiler import disttrace as tdist
from paddle_tpu_torch.profiler import events as tev
from paddle_tpu_torch.profiler import metrics as tmetrics
from paddle_tpu_torch.profiler import recompile as trec
from paddle_tpu_torch.profiler import sink as tsink
from paddle_tpu_torch.profiler import trace as ttrace


def _quiet():
    for p, s in ((tprof, tsink), (jprof, jsink)):
        if p.is_enabled():
            p.disable()
        s.disable_sink()
        p.reset()


@pytest.fixture(autouse=True)
def _clean():
    """Both profilers start and end disabled and empty, with no sink."""
    _quiet()
    yield
    _quiet()


# ---------------------------------------------------------------------------
# event timelines: the same hand-built sequences through both packages
# ---------------------------------------------------------------------------
#: (kind, rid, t_ms, attrs) of each scenario; the rid's submit may be
#: missing (head-truncated: aged out of the ring)
SCENARIOS = {
    "plain": [
        ("submit", 1, 0.0, {"prompt_tokens": 8, "max_new": 8}),
        ("admit", 1, 10.0, {"slot": 0}),
        ("chunk", 1, 12.0, {"slot": 0, "start": 0, "end": 8,
                            "final": True}),
        ("first_token", 1, 30.0, {"slot": 0}),
        ("finish", 1, 100.0, {"tokens": 8, "reason": "eos",
                              "preempts": 0, "ttft_ms": 30.0,
                              "tpot_ms": 10.0}),
    ],
    "preempt_requeue": [
        ("submit", 2, 0.0, {}),
        ("admit", 2, 10.0, {"slot": 1}),
        ("first_token", 2, 30.0, {"slot": 1}),
        ("preempt", 2, 40.0, {"slot": 1, "generated": 3}),
        ("requeue", 2, 40.0, {"prompt_tokens": 11, "max_new": 5}),
        ("admit", 2, 70.0, {"slot": 0}),
        ("prefix_hit", 2, 71.0, {"slot": 0, "tokens": 8,
                                 "remote_tokens": 0}),
        ("chunk", 2, 75.0, {"final": False}),
        ("chunk", 2, 80.0, {"final": True}),
        ("finish", 2, 100.0, {"tokens": 8, "reason": "max_new",
                              "preempts": 1, "ttft_ms": 30.0,
                              "tpot_ms": 5.0}),
    ],
    "head_truncated": [
        ("admit", 3, 5.0, {}),
        ("first_token", 3, 17.5, {}),
        ("finish", 3, 40.0, {"tokens": 4, "ttft_ms": 12.5, "tpot_ms": 2.0,
                             "reason": "eos"}),
    ],
    "spec_accepts": [
        ("submit", 4, 0.0, {}),
        ("admit", 4, 1.0, {"slot": 0}),
        ("chunk", 4, 2.0, {"start": 0, "end": 8, "final": True}),
        ("first_token", 4, 6.0, {"slot": 0}),
        ("draft", 4, 7.0, {"slot": 0, "pos": 0}),
        ("verify", 4, 9.0, {"slot": 0, "k": 3}),
        ("accept", 4, 11.0, {"slot": 0, "accepted": 3, "drafted": 3}),
        ("accept", 4, 15.0, {"slot": 0, "accepted": 1, "drafted": 3}),
        ("accept", 4, 19.0, {"slot": 0, "accepted": 0, "drafted": 2}),
        ("finish", 4, 21.0, {"tokens": 8, "reason": "max_new",
                             "ttft_ms": 6.0, "tpot_ms": 2.143}),
    ],
    "unfinished": [
        ("submit", 5, 0.0, {}),
        ("admit", 5, 3.0, {}),
    ],
}


def _logs(names, eng=None):
    """The scenarios' events, in order, in a fresh EventLog of each
    package with fixed stamps (t0 of scenario i at i seconds)."""
    out = []
    for mod in (jev, tev):
        lg = mod.EventLog()
        for i, name in enumerate(names):
            for kind, rid, t_ms, attrs in SCENARIOS[name]:
                a = dict(attrs) if eng is None else dict(attrs, eng=eng)
                ev = lg.emit(kind, rid=rid, **a)
                ev.t_ns = i * 10 ** 9 + int(t_ms * 1e6)
        out.append(lg)
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_breakdown_equals_reference(name):
    jlog, tlog = _logs([name])
    rid = SCENARIOS[name][0][1]
    want = jev.breakdown_from_events(jlog.events(rid=rid))
    got = tev.breakdown_from_events(tlog.events(rid=rid))
    assert got == want
    assert tev.latency_breakdown(rid, tlog) == want
    assert [e.to_dict() for e in tev.timeline(rid, tlog)] == \
        [e.to_dict() for e in jev.timeline(rid, jlog)]


def test_breakdown_values():
    """The state machine's arithmetic on the preempted request: the
    requeue wait and the re-prefill are preemption cost, and the four
    buckets sum to the total."""
    _, tlog = _logs(["preempt_requeue"])
    b = tev.breakdown_from_events(tlog.events(rid=2))
    assert b["complete"] and b["preempts"] == 1
    assert (b["queue_wait_ms"], b["prefill_ms"], b["decode_ms"],
            b["preempted_ms"]) == (10.0, 20.0, 30.0, 40.0)
    assert b["total_ms"] == 100.0
    _, tlog = _logs(["spec_accepts", "head_truncated"])
    b = tev.breakdown_from_events(tlog.events(rid=4))
    assert (b["spec_accepted"], b["spec_drafted"]) == (4, 8)
    b = tev.breakdown_from_events(tlog.events(rid=3))
    assert b["complete"] is False and b["ttft_ms"] == 12.5


@pytest.mark.parametrize("eng", [None, 7])
def test_latency_table_equals_reference(eng):
    jlog, tlog = _logs(sorted(SCENARIOS), eng=eng)
    # a second engine reusing rid 1 must not alias the first's row
    for lg in (jlog, tlog):
        for i, kind in enumerate(("submit", "admit", "first_token",
                                  "finish")):
            ev = lg.emit(kind, rid=1, eng="other")
            ev.t_ns = 10 ** 10 + i * 10 ** 6
    want = jev.latency_table(event_log=jlog)
    assert tev.latency_table(event_log=tlog) == want
    assert len(want) == len(SCENARIOS) + 1
    since = tlog.events()[7].seq
    assert tev.latency_table(since_seq=since, event_log=tlog) == \
        jev.latency_table(since_seq=since, event_log=jlog)


@pytest.mark.parametrize("window_s", [None, 0.5, 2.5, 60.0])
def test_request_latency_stats_equal_reference(window_s):
    names = sorted(SCENARIOS) * 3            # 12 finishes, repeated rids
    jlog, tlog = _logs(names)
    now = len(names) * 10 ** 9
    want = jev.request_latency_stats(window_s=window_s, event_log=jlog,
                                     now_ns=now)
    got = tev.request_latency_stats(window_s=window_s, event_log=tlog,
                                    now_ns=now)
    assert got == want
    if window_s is None:
        assert got["requests"] == 12
        assert set(got["ttft_ms"]) == {"p50", "p90", "p95", "p99", "mean",
                                       "count"}


def test_event_log_ring_and_cursor():
    """The ring's bound, drop count and the cursor that survives
    clear(), as the reference's."""
    for mod in (jev, tev):
        lg = mod.EventLog(capacity=4)
        for i in range(10):
            lg.emit("submit", rid=i)
        assert [e.rid for e in lg.events()] == [6, 7, 8, 9]
        assert (lg.dropped, lg.total) == (6, 10)
        evs, cur = lg.since(8)
        assert [e.seq for e in evs] == [8, 9] and cur == 10
        assert [e.rid for e in lg.tail(2)] == [8, 9]
        lg.clear()
        assert lg.next_seq == 10 and lg.dropped == 0
    tev.set_enabled(False)
    try:
        assert tev.emit("submit", rid=1) is None
        assert not tev.is_enabled()
    finally:
        tev.set_enabled(True)


# ---------------------------------------------------------------------------
# metrics and the Prometheus text
# ---------------------------------------------------------------------------
def _fill(reg):
    reg.counter("serving/tokens.generated").add(2)
    reg.counter("train/steps").add(7)
    reg.gauge("mem/peak").set(1.5)
    reg.gauge("never/set")
    reg.gauge("serving/tokens_per_sec").set(345.25)
    h = reg.histogram("serving/ttft_ms")
    for v in np.random.RandomState(0).lognormal(3.0, 1.0, 200):
        h.observe(float(v))
    reg.histogram("empty/ms")
    return reg


def test_prometheus_text_equals_reference():
    jsnap = _fill(jmetrics.MetricsRegistry()).snapshot()
    tsnap = _fill(tmetrics.MetricsRegistry()).snapshot()
    assert tsnap == jsnap
    want = jsink.prometheus_text(jsnap)
    assert tsink.prometheus_text(tsnap) == want
    assert tsink.prometheus_text(tsnap, prefix="x") == \
        jsink.prometheus_text(jsnap, prefix="x")
    assert 'paddle_tpu_serving_ttft_ms{quantile="0.95"}' in want


def test_sketch_dicts_equal_reference():
    jreg = _fill(jmetrics.MetricsRegistry())
    treg = _fill(tmetrics.MetricsRegistry())
    assert treg.sketch_dicts() == jreg.sketch_dicts()
    assert set(treg.sketch_dicts()) == {"serving/ttft_ms"}
    assert treg.histogram("serving/ttft_ms").sketch_dict()["n"] == 200


# ---------------------------------------------------------------------------
# spans and the Chrome-trace export
# ---------------------------------------------------------------------------
def _spans(mod):
    for _ in range(3):
        with mod.scope("step"):
            with mod.scope("h2d"):
                pass
            ev = mod.RecordEvent("sync_wait")
            ev.begin()
            ev.end()


def test_scope_summary_counts_equal_reference():
    counts = []
    for p in (jprof, tprof):
        p.enable()
        _spans(p)
        counts.append({k: v["count"] for k, v in p.scope_summary().items()})
        assert set(p.scope_summary()["step"]) == {
            "count", "total_ms", "mean_ms", "min_ms", "max_ms"}
    assert counts[1] == counts[0] == {"step": 3, "step/h2d": 3,
                                      "step/sync_wait": 3}


def test_disabled_scopes_record_nothing():
    _spans(tprof)
    assert ttrace.events() == [] and tprof.scope_summary() == {}
    assert tprof.live_spans() == {}


def test_live_spans_show_open_scopes():
    tprof.enable()
    with tprof.scope("outer"):
        with tprof.scope("inner"):
            (stack,) = tprof.live_spans().values()
            assert stack == ["outer", "inner"]
    assert tprof.live_spans() == {}


def test_chrome_trace_structure_equals_reference(tmp_path, monkeypatch):
    docs = []
    for p, tr in ((jprof, jtrace), (tprof, ttrace)):
        monkeypatch.setattr(tr, "_MAX_EVENTS", 5)
        p.enable()
        _spans(p)                            # 9 spans, 5 kept
        path = str(tmp_path / f"{p.__name__}.json")
        assert p.export_chrome_trace(path, extra_metadata={"run": 1}) == path
        doc = json.load(open(path))
        docs.append(doc)
        assert p.scope_summary()["step"]["count"] == 3     # exact
    jdoc, tdoc = docs
    assert tdoc["otherData"] == jdoc["otherData"] == {"run": 1,
                                                      "dropped_events": 4}
    assert tdoc["displayTimeUnit"] == jdoc["displayTimeUnit"]

    def shape(doc):
        return [(e["name"], e["ph"], e["pid"], e["cat"], sorted(e))
                for e in doc["traceEvents"]]

    assert shape(tdoc) == shape(jdoc)
    assert all(e["dur"] >= 0 for e in tdoc["traceEvents"])


def test_enable_trace_dir_writes_a_torch_profiler_trace(tmp_path):
    """enable(trace_dir=...) records a torch.profiler trace that disable()
    writes as Chrome JSON: the host scopes and the always-on annotations
    of a trainer step land in it as ranges. A second enable with
    reset=False keeps the registry."""
    from paddle_tpu_torch.distributed.hybrid import HybridPipelineTrainer
    from paddle_tpu_torch.models import gpt as tgpt
    from paddle_tpu_torch.optimizer import AdamW

    net = tgpt.GPT(tgpt.GPTConfig(vocab_size=64, hidden_size=32,
                                  num_layers=1, num_heads=2, max_seq_len=16),
                   device="cpu")
    tr = HybridPipelineTrainer(net, AdamW(1e-3,
                                          parameters=net.named_parameters()),
                               n_micro=2)
    toks = torch.from_numpy(
        np.random.RandomState(0).randint(0, 64, (2, 16)).astype(np.int32))
    tprof.registry().counter("t/kept").add(1)
    d = str(tmp_path / "trace")
    tprof.enable(trace_dir=d, reset=False)
    loss = tr.step(toks)
    s = tprof.disable()
    assert np.isfinite(float(loss))
    assert s["metrics"]["t/kept"]["value"] == 1.0
    assert s["metrics"]["train/steps"]["value"] == 1.0
    assert {"hybrid/h2d", "hybrid/step", "hybrid/step/sync_wait"} <= \
        set(s["scopes"])
    path = ttrace.trace_file()
    assert os.path.dirname(path) == d
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert {"hybrid/step", "hybrid/step/sync_wait", "fwd/stem",
            "fwd/blocks", "fwd/head"} <= names
    assert not tprof.is_enabled()


# ---------------------------------------------------------------------------
# recompile telemetry
# ---------------------------------------------------------------------------
#: one site's argument sequence: (tokens [B, S], extra) per call; the last
#: call adds a leaf
SHAPES = [((4, 8), None), ((4, 16), None), ((2, 16), None),
          ((2, 16), (3,))]


def _args(np_mod, shape, extra):
    x = np_mod(np.zeros(shape, np.int32))
    return (x,) if extra is None else (x, {"aux": np_mod(
        np.zeros(extra, np.float32))})


def test_retrace_log_equals_reference():
    """The same signature sequence at one site: the same `changed` diff
    entries (dtypes in the reference's spelling: a torch.int32 tensor
    reads "int32")."""
    logs = []
    for p, rec, wrap in ((jprof, jrec, np.asarray),
                         (tprof, trec, torch.from_numpy)):
        p.enable()
        for shape, extra in SHAPES:
            rec.mark_trace("t.site", *_args(wrap, shape, extra))
        logs.append(rec.retraces())
        assert rec.trace_counts()["t.site"] == len(SHAPES)
        assert p.registry().counter("profiler/retraces").value == 3
    jlog, tlog = logs
    assert [e["changed"] for e in tlog] == [e["changed"] for e in jlog]
    assert [e["signature"] for e in tlog] == [e["signature"] for e in jlog]
    assert tlog[0]["changed"] == [{"index": 0, "prev": ((4, 8), "int32"),
                                   "new": ((4, 16), "int32")}]


def test_repeated_signature_is_a_cache_hit():
    """The reference's mark_trace runs only when jit traces; the port's
    runs at every dispatch, so a signature the site already ran records
    nothing: trace_counts counts distinct signatures."""
    tprof.enable()
    for shape in ((4, 8), (4, 16), (4, 8), (4, 16), (4, 8)):
        trec.mark_trace("t.hit", torch.zeros(shape))
    assert trec.trace_counts()["t.hit"] == 2
    assert len(trec.retraces()) == 1
    with trec.suppressed():
        trec.mark_trace("t.hit", torch.zeros(3))
    assert trec.trace_counts()["t.hit"] == 3 and len(trec.retraces()) == 1
    trec.clear_log()
    assert trec.retraces() == [] and trec.trace_counts()["t.hit"] == 3
    f = trec.watch(lambda x: x + 1, "t.watch")
    f(torch.ones(2))
    f(torch.ones(2))
    assert trec.trace_counts()["t.watch"] == 1
    assert trec.unique_site("a") != trec.unique_site("a")


def test_signature_flattens_like_tree_leaves():
    tree = ({"b": np.zeros(2), "a": [np.ones((1, 3)), None]}, 5, "s")
    assert trec.signature(tree) == jrec.signature(tree)
    assert trec.signature(torch.zeros(2, dtype=torch.bfloat16)) == \
        (((2,), "bfloat16"),)


# ---------------------------------------------------------------------------
# trace ids, clock state, the summary
# ---------------------------------------------------------------------------
def test_trace_ids_and_clock_state_equal_reference(monkeypatch):
    for gid in list(range(12)) + [99999999, 123456789, 10 ** 12]:
        assert tdist.trace_id(gid) == jdist.trace_id(gid)
    assert tdist.clock_state() == {"offset_s": None, "unc_s": None,
                                   "ref": 0, "synced": False}
    monkeypatch.setenv("PADDLE_CLOCK_SKEW", "0:0.5,1:-2.0")
    for r in (0, 1, 2):
        assert tdist.local_skew_s(r) == jdist.local_skew_s(r)
    monkeypatch.setenv("PADDLE_CLOCK_SKEW", "0.25")
    assert tdist.local_skew_s() == 0.25
    assert abs(tdist.walltime() - jdist.walltime()) < 1.0
    tdist.set_clock_state(0.1, 0.01, ref=1)
    try:
        assert tdist.clock_state() == {"offset_s": 0.1, "unc_s": 0.01,
                                       "ref": 1, "synced": True}
    finally:
        tdist.reset_clock_state()


def test_summary_keys_equal_reference():
    for p in (jprof, tprof):
        p.enable()
        p.registry().counter("train/tokens").add(1000)
        p.registry().gauge("phase/fwd_ms").set(1.25)
    want, got = jprof.summary(), tprof.summary()
    assert set(got) == set(want)
    assert set(got["sink"]) == set(want["sink"])
    assert got["programs"] == {}
    assert got["phases_ms"] == want["phases_ms"] == {"fwd_ms": 1.25}
    assert got["rates"]["tokens_per_sec"] > 0
    d = tprof.disable()
    assert d["metrics"]["train/tokens"]["value"] == 1000.0
    with pytest.raises(NotImplementedError, match="7a"):
        tprof.summary(aggregate=True)


def test_package_names_cover_the_reference_slice():
    """Every name of the reference's __all__ that the port has so far."""
    later = {"collective_stats", "record_collective_stats",
             "record_collectives_from", "ClockSync",
             "LiveAggregator", "AlertRule", "default_rules"}
    # PyTorch lowers and compiles no program: program_stats counts a
    # site's first dispatch instead (record_counted)
    no_counterpart = {"record_lowered", "record_compiled"}
    want = set(jprof.__all__) - later - no_counterpart
    assert want <= set(tprof.__all__)
    assert not (later | no_counterpart) & set(tprof.__all__)
    for name in tprof.__all__:
        assert hasattr(tprof, name), name


def test_summary_programs_populated_after_record():
    """Beside the empty case above: a recorded site's program lands in
    summary()["programs"], and enable() clears it again."""
    from paddle_tpu_torch.profiler import program_stats as tps

    tprof.enable()
    rec = {}
    tps.dispatch(rec, "t.site#0", lambda: torch.ones(4, 4) @ torch.ones(4, 4))
    tps.record_counted("t.site#0", rec["t.site#0"])
    progs = tprof.summary()["programs"]
    assert set(progs) == {"t.site#0"}
    assert progs["t.site#0"]["flops"] == 2 * 4 ** 3
    tprof.enable()
    assert tprof.summary()["programs"] == {}


def test_enable_reset_clears_registry_and_events():
    tprof.registry().counter("t/x").add(1)
    tprof.emit("submit", rid=1)
    seq = tprof.event_log().next_seq
    tprof.enable()
    assert "t/x" not in tprof.registry().names()
    assert tprof.event_log().events() == []
    assert tprof.event_log().next_seq == seq
    assert tprof.is_enabled()
