"""paddle_tpu_torch.profiler.live, the live mesh telemetry plane, held
against the JAX package's.

- Every case of the reference's ``tests/test_live.py`` that drives the
  sink's frames, ``LiveAggregator``, ``AlertRule``/``default_rules`` or
  the event ring runs here on the port's modules: the reference module is
  loaded from its file and its names (``profiler``, ``pevents``,
  ``psink``, ``AlertRule``, ``LiveAggregator``, ``default_rules``,
  ``QuantileSketch``) are bound to the port's before each case. Its cases
  of the schema checker alone (``tools/check_sink_schema.py`` on
  hand-made documents) test the tool, not a module, and stay there; the
  viewer's history case runs on the port's viewer
  (``python -m paddle_tpu_torch.profiler.live``).
- A mixed root: rank 0's frames written by the JAX package's sink, rank
  1's by the port's, with alerts firing: the port's aggregator gives the
  reference aggregator's status on it, ``ts`` aside, and both write a
  ``mesh_status.json`` the schema checker accepts.
"""
import importlib.util
import json
import os
import time

import pytest

import paddle_tpu.profiler as jprof
from paddle_tpu.profiler import events as jev
from paddle_tpu.profiler import live as jlive
from paddle_tpu.profiler import sink as jsink
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.profiler import events as tev
from paddle_tpu_torch.profiler import live as tlive
from paddle_tpu_torch.profiler import sink as tsink
from paddle_tpu_torch.profiler.sketch import QuantileSketch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: the reference's test module, its names bound to the port's modules
REF = _load("_reference_test_live", os.path.join(HERE, "test_live.py"))
REF.profiler, REF.pevents, REF.psink = tprof, tev, tsink
REF.AlertRule, REF.LiveAggregator = tlive.AlertRule, tlive.LiveAggregator
REF.default_rules, REF.QuantileSketch = tlive.default_rules, QuantileSketch

#: the reference's cases of the modules: every one but the checker's own
#: on hand-made documents (the tool's; its case on a real live run, which
#: drives the sink and the aggregator, stays) and the tool viewer's
#: (ported as ``test_viewer_history_renders``)
CASES = tuple(sorted(
    n for n in dir(REF) if n.startswith("test_")
    and (not n.startswith("test_checker_")
         or n == "test_checker_accepts_real_live_run")
    and n != "test_live_dash_history_renders"))


@pytest.fixture(autouse=True)
def _clean():
    """No active sink, empty rings and registries, an unsynced clock, in
    both packages (the reference's own fixture, for each package)."""
    from paddle_tpu.profiler import disttrace as jdt
    from paddle_tpu_torch.profiler import disttrace as tdt

    for s, p, ev, dt in ((tsink, tprof, tev, tdt), (jsink, jprof, jev, jdt)):
        s.disable_sink()
        p.reset()
        ev.set_enabled(True)
        dt.reset_clock_state()
    yield
    for s, p in ((tsink, tprof), (jsink, jprof)):
        s.disable_sink()
        p.reset()


def test_reference_cases_cover_the_module():
    """The reference file's 23 cases of the sink's frames, the aggregator,
    the alert rules and the event ring all run here."""
    assert len(CASES) == 23, CASES
    assert "test_dead_rank_alert_side_effects" in CASES


@pytest.mark.parametrize("case", CASES)
def test_reference_case_on_the_port(case, tmp_path):
    fn = getattr(REF, case)
    args = fn.__code__.co_varnames[:fn.__code__.co_argcount]
    fn(*[tmp_path for _ in args])


def test_viewer_history_renders(tmp_path, capsys):
    """The reference's ``test_live_dash_history_renders`` on the port's
    viewer: its ``--history`` replay and one ``--once`` tick."""
    d = str(tmp_path)
    REF._write_frame(d, 0, 0)
    tlive.LiveAggregator(d, interval_s=0.01, staleness_s=1e9,
                         emit_alerts=False).tick()
    assert tlive.main([d, "--history", "10"]) == 0
    out = capsys.readouterr().out
    assert "tick" in out and "members" in out
    assert tlive.main([d, "--once"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("mesh_status tick=1 ranks=1")


def _flush_rank(sink_mod, prof_mod, root, rank, ttfts, tokens):
    """One frame of ``rank`` written by ``sink_mod`` from its package's
    registry: the e2e TTFT sketch, a token counter and a page gauge."""
    reg = prof_mod.registry()
    for v in ttfts:
        reg.histogram("serving/e2e_ttft_ms").observe(v)
    reg.counter("serving/tokens_generated").add(tokens)
    reg.gauge("serving/page_util").set(0.5 + 0.1 * rank)
    s = sink_mod.MetricsSink(os.path.join(root, f"rank{rank}"),
                             interval_s=3600.0, rank=rank)
    s.flush("manual")
    s.close()


def test_mixed_package_root_gives_the_reference_status(tmp_path):
    """Rank 0's frames from the JAX package's sink, rank 1's from the
    port's (the same frame names and keys), world 3 so that a rank is
    missing, a staleness that makes rank 0 dead: the port's status equals
    the reference aggregator's on the same root at the same ``now``, the
    alert board and its transitions included; ``mesh_status.json`` of
    each passes the schema checker."""
    root = str(tmp_path)
    _flush_rank(jsink, jprof, root, 0, [100.0 + i for i in range(30)], 40)
    time.sleep(0.5)
    _flush_rank(tsink, tprof, root, 1, [400.0 + 3 * i for i in range(30)],
                70)
    kw = dict(interval_s=0.01, staleness_s=0.25, world=3,
              emit_alerts=False)
    now = time.time()
    want = jlive.LiveAggregator(root, **kw).tick(now=now)
    with open(os.path.join(root, "mesh_status.json")) as f:
        want_file = json.load(f)
    got = tlive.LiveAggregator(root, **kw).tick(now=now)
    with open(os.path.join(root, "mesh_status.json")) as f:
        got_file = json.load(f)
    for doc in (want, got, want_file, got_file):
        doc.pop("ts")
    assert got == want
    assert got_file == want_file
    lat = got["latency"]["ttft_ms"]
    assert lat["count"] == 60 and lat["ranks"] == [0, 1]
    assert got["ranks"]["0"]["dead"] and not got["ranks"]["1"]["dead"]
    assert got["partial"] and got["world"] == 3
    assert [(t["rule"], t["rank"]) for t in got["alert_transitions"]
            if t["rule"] == "dead_rank"] == [("dead_rank", "0")]
    checker = _load("check_sink_schema",
                    os.path.join(REPO, "tools", "check_sink_schema.py"))
    with open(os.path.join(REPO, "tools", "sink_schema.json")) as f:
        schema = json.load(f)
    checker._ERRORS.clear()
    checker.check_live_status_dir(root, schema)
    assert checker._ERRORS == [], checker._ERRORS
