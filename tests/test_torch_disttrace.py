"""The port's clock agreement (``profiler/disttrace.ClockSync``) and the
cross-host metadata the sink and the flight recorder carry, held against
the JAX package's (counterparts of ``TestClockSync``,
``TestSinkClockMetadata`` and ``TestFlightRecorderTags`` of
``tests/test_disttrace.py``).

A ClockSync of the port and one of the reference share one directory in
either role: the ping/pong files are the reference's. Pure host code.
"""
import importlib.util
import json
import os
import time

import pytest

from paddle_tpu.profiler import disttrace as jdt
from paddle_tpu_torch.distributed.consensus import Consensus
from paddle_tpu_torch.profiler import disttrace
from paddle_tpu_torch.profiler.events import EventLog, FlightRecorder
from paddle_tpu_torch.profiler.sink import MetricsSink

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKER = os.path.join(REPO, "tools", "check_sink_schema.py")


@pytest.fixture(autouse=True)
def _process_state():
    """Adopted epochs and the clock state are process-wide (the sink and
    the flight recorder read them): leave them as this test found them."""
    from paddle_tpu_torch.distributed import consensus as _c
    from paddle_tpu_torch.profiler import disttrace as _dt

    adopted, clock = _c.adopted_epochs(), _dt.clock_state()
    yield
    with _c._ADOPTED_LOCK:
        _c._ADOPTED.clear()
        _c._ADOPTED.update(adopted)
    _dt.set_clock_state(clock["offset_s"], clock["unc_s"], ref=clock["ref"],
                        synced=clock["synced"])


def _schema_errors(d):
    """Every violation ``tools/check_sink_schema.py`` finds in the sink
    directory ``d`` (its lines and its frames)."""
    spec = importlib.util.spec_from_file_location("check_sink_schema",
                                                  CHECKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(os.path.join(REPO, "tools", "sink_schema.json")) as f:
        schema = json.load(f)
    mod._ERRORS.clear()
    mod.check_metrics_jsonl(os.path.join(d, "metrics.jsonl"), schema)
    mod.check_frames_dir(os.path.join(d, "frames"), schema)
    errs = list(mod._ERRORS)
    mod._ERRORS.clear()
    return errs


def _pump(ref, cli, rounds=400):
    for _ in range(rounds):
        ref.step()
        if cli.step():
            return
    raise AssertionError("clock sync never became ready")


class TestClockSync:
    @pytest.mark.parametrize("skew", [0.75, -0.75, 0.0])
    def test_recovers_injected_skew_within_uncertainty(self, tmp_path, skew):
        ref = disttrace.ClockSync(str(tmp_path), 0, 2, skew_s=0.0,
                                  n_samples=4)
        cli = disttrace.ClockSync(str(tmp_path), 1, 2, skew_s=skew,
                                  n_samples=4)
        _pump(ref, cli)
        off, unc = cli.estimate()
        assert unc >= 0.0
        assert abs(off - skew) <= unc + 0.05
        assert ref.estimate() == (0.0, 0.0)

    def test_reference_is_ready_immediately_and_serves(self, tmp_path):
        ref = disttrace.ClockSync(str(tmp_path), 0, 2, skew_s=0.0)
        assert ref.step() and ref.ready
        cli = disttrace.ClockSync(str(tmp_path), 1, 2, skew_s=0.0,
                                  n_samples=1)
        assert not cli.ready and cli.estimate() is None
        _pump(ref, cli, 20)
        assert [n for n in os.listdir(tmp_path)
                if n.startswith(("ping.", "pong."))] == []

    def test_validation(self, tmp_path):
        with pytest.raises(ValueError):
            disttrace.ClockSync(str(tmp_path), 2, 2)
        with pytest.raises(ValueError):
            disttrace.ClockSync(str(tmp_path), 0, 1, n_samples=0)
        with pytest.raises(ValueError):
            disttrace.ClockSync(str(tmp_path), 0, 2, ref=3)

    def test_stale_pong_is_purged_at_init(self, tmp_path):
        """A restarted rank's leftover pong (answered long ago) must not
        pair with its fresh ping and win the least-uncertainty pick."""
        with open(tmp_path / "pong.1.0", "w") as f:
            json.dump({"t_ref": time.time() - 100.0}, f)
        with open(tmp_path / "ping.1.0", "w") as f:
            json.dump({"rank": 1}, f)
        with open(tmp_path / "pong.2.0", "w") as f:     # a peer's: kept
            json.dump({"t_ref": 0.0}, f)
        ref = disttrace.ClockSync(str(tmp_path), 0, 3, skew_s=0.0)
        cli = disttrace.ClockSync(str(tmp_path), 1, 3, skew_s=0.0,
                                  n_samples=2)
        assert sorted(os.listdir(tmp_path)) == ["pong.2.0"]
        _pump(ref, cli)
        off, unc = cli.estimate()
        assert abs(off) <= unc + 0.05

    def test_resync_starts_a_fresh_round(self, tmp_path):
        ref = disttrace.ClockSync(str(tmp_path), 0, 2, skew_s=0.0,
                                  n_samples=2)
        cli = disttrace.ClockSync(str(tmp_path), 1, 2, skew_s=0.3,
                                  n_samples=2)
        _pump(ref, cli)
        seq = cli._seq
        cli.skew_s = 0.9              # the clock stepped
        cli.resync()
        assert not cli.ready and cli._seq == seq + 1
        ref.resync()                  # the reference has nothing to redo
        assert ref.ready
        _pump(ref, cli)
        off, unc = cli.estimate()
        assert abs(off - 0.9) <= unc + 0.05

    @pytest.mark.parametrize("server", ["reference", "port"])
    def test_exchange_across_packages(self, tmp_path, server):
        """A reference rank answers a port rank's pings and the other way
        round: one file protocol."""
        S, K = (jdt, disttrace) if server == "reference" else (disttrace, jdt)
        ref = S.ClockSync(str(tmp_path), 0, 2, skew_s=0.0)
        cli = K.ClockSync(str(tmp_path), 1, 2, skew_s=-0.4, n_samples=3)
        _pump(ref, cli)
        off, unc = cli.estimate()
        assert abs(off + 0.4) <= unc + 0.05

    def test_same_estimate_as_reference_on_the_same_samples(self, tmp_path):
        a = disttrace.ClockSync(str(tmp_path / "a"), 1, 2, n_samples=3)
        b = jdt.ClockSync(str(tmp_path / "b"), 1, 2, n_samples=3)
        samples = [(0.004, 0.51), (0.001, 0.49), (0.002, 0.5)]
        a._samples, b._samples = list(samples), list(samples)
        assert a.estimate() == b.estimate() == (0.49, 0.001)
        assert a.ready and b.ready

    def test_skew_env_is_the_default_skew(self, tmp_path, monkeypatch):
        monkeypatch.setenv(disttrace.SKEW_ENV, "1:0.25")
        assert disttrace.ClockSync(str(tmp_path), 1, 2).skew_s == 0.25
        assert disttrace.ClockSync(str(tmp_path), 0, 2).skew_s == 0.0


class TestSinkClockMetadata:
    def test_lines_and_frames_carry_clock_and_epochs(self, tmp_path):
        """A flush line and its telemetry frame carry the agreed offset
        and the consensus epochs this process adopted; both pass the
        schema checker."""
        c = Consensus(str(tmp_path / "board"), 0, 1)
        c.decide("sinkfam", 1, reducer="max")
        c.decide("sinkfam", 2, reducer="max")
        disttrace.set_clock_state(0.25, 0.001, ref=0)
        try:
            s = MetricsSink(str(tmp_path / "sink"), interval_s=60,
                            event_log=EventLog(), rank=0)
            line = s._flush_locked("manual")
            s.close()
        finally:
            disttrace.reset_clock_state()
        assert isinstance(line["t_ns"], int)
        clk = line["clock"]
        assert clk["offset_s"] == 0.25 and clk["unc_s"] == 0.001
        assert clk["synced"] and clk["ref"] == 0
        assert isinstance(clk["wall_s"], float)
        frames = sorted(os.listdir(tmp_path / "sink" / "frames"))
        with open(tmp_path / "sink" / "frames" / frames[0]) as f:
            frame = json.load(f)
        assert frame["adopted_epochs"]["sinkfam"] == 1
        assert frame["clock"]["offset_s"] == 0.25
        assert _schema_errors(str(tmp_path / "sink")) == []

    def test_unsynced_state_stamps_nulls_not_zeros(self, tmp_path):
        disttrace.reset_clock_state()
        s = MetricsSink(str(tmp_path), interval_s=60, event_log=EventLog(),
                        rank=0)
        line = s._flush_locked("manual")
        s.close()
        assert line["clock"]["offset_s"] is None
        assert line["clock"]["unc_s"] is None
        assert not line["clock"]["synced"]

    def test_anchor_wall_honors_injected_skew(self, tmp_path, monkeypatch):
        monkeypatch.setenv(disttrace.SKEW_ENV, "0:2.0")
        s = MetricsSink(str(tmp_path), interval_s=60, event_log=EventLog(),
                        rank=0)
        line = s._flush_locked("manual")
        s.close()
        assert line["clock"]["wall_s"] - time.time() > 1.5
        assert abs(line["ts"] - time.time()) < 1.0


class TestFlightRecorderTags:
    def test_dump_carries_rank_clock_and_epochs(self, tmp_path):
        c = Consensus(str(tmp_path / "board"), 0, 1)
        c.decide("ordering", 1, reducer="max")
        disttrace.set_clock_state(0.5, 0.002, ref=0)
        try:
            doc = FlightRecorder(tail_events=4).dump(reason="test")
        finally:
            disttrace.reset_clock_state()
        assert doc["rank"] == 0
        assert doc["clock"]["offset_s"] == 0.5
        assert doc["consensus_epochs"].get("ordering") == 0
