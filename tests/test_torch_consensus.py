"""The port's consensus board (``paddle_tpu_torch/distributed/consensus.py``)
and its retry helper, held against the JAX package's.

The counterparts of ``tests/test_consensus.py`` run N logical ranks in one
process (threads where concurrency matters) on the port's module. A mixed
board puts a rank of the reference and a rank of the port on one
directory: they reach the same decisions and publish the same
``decision.json``. The reducers equal the reference's on seeded random
votes. Pure host code: nothing here touches a tensor.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

from paddle_tpu.distributed import consensus as J
from paddle_tpu_torch.distributed import consensus as C
from paddle_tpu_torch.distributed.consensus import (Consensus,
                                                    ConsensusTimeout,
                                                    Decision, REDUCERS)
from paddle_tpu_torch.profiler import events as pevents
from paddle_tpu_torch.profiler.metrics import registry
from paddle_tpu_torch.utils.retry import RetryError, backoff_delays, retry


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


def _ranks(tmp_path, world, **kw):
    kw.setdefault("lease_s", 0.4)
    kw.setdefault("poll_s", 0.005)
    kw.setdefault("timeout_s", 10.0)
    return [Consensus(str(tmp_path), r, world, **kw) for r in range(world)]


def _decide_all(cs, family, values, reducer="majority"):
    """Every rank's ``decide`` at once; the decisions in rank order."""
    out = [None] * len(cs)
    errs = []

    def run(i):
        try:
            out[i] = cs[i].decide(family, values[i], reducer=reducer)
        except Exception as e:       # pragma: no cover - failure detail
            errs.append((i, e))

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(cs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs, errs
    return out


class TestSingleRank:
    def test_world1_decides_immediately(self, tmp_path):
        c = Consensus(str(tmp_path), 0, 1)
        d = c.decide("admit", {"load": 3}, reducer="first")
        assert d.value == {"load": 3}
        assert d.epoch == 0 and d.participants == [0] and not d.missing
        d2 = c.decide("admit", {"load": 4}, reducer="first")
        assert d2.epoch == 1 and d2.value == {"load": 4}

    def test_epochs_are_per_family(self, tmp_path):
        c = Consensus(str(tmp_path), 0, 1)
        assert c.decide("a", 1, reducer="first").epoch == 0
        assert c.decide("b", 2, reducer="first").epoch == 0
        assert c.decide("a", 3, reducer="first").epoch == 1

    def test_bad_args_raise(self, tmp_path):
        with pytest.raises(ValueError):
            Consensus(str(tmp_path), 2, 2)
        with pytest.raises(ValueError):
            Consensus(str(tmp_path), 0, 0)
        with pytest.raises(ValueError):
            Consensus(str(tmp_path), 0, 1, lease_s=0)
        c = Consensus(str(tmp_path), 0, 1)
        with pytest.raises(ValueError):
            c.vote("../escape", 1)

    def test_for_mesh_is_rank0_of_1_without_a_group(self, tmp_path):
        c = Consensus.for_mesh(str(tmp_path))
        assert (c.rank, c.world) == (0, 1)


class TestReducers:
    def test_builtin_reducers(self):
        votes = {0: 3, 1: 1, 2: 3}
        assert REDUCERS["min"](votes) == 1
        assert REDUCERS["max"](votes) == 3
        assert REDUCERS["majority"](votes) == 3
        assert REDUCERS["first"](votes) == 3
        assert REDUCERS["any"]({0: False, 1: True}) is True
        assert REDUCERS["all"]({0: False, 1: True}) is False
        assert REDUCERS["union"]({0: [3, 1], 1: [1, 7]}) == [1, 3, 7]

    def test_majority_tie_breaks_to_lowest_rank(self):
        votes = {0: "a", 1: "b", 2: "b", 3: "a"}
        assert REDUCERS["majority"](votes) == "a"

    @pytest.mark.parametrize("seed", range(4))
    def test_reducers_equal_reference_on_random_votes(self, seed):
        rng = np.random.RandomState(seed)
        assert sorted(REDUCERS) == sorted(J.REDUCERS)
        for _ in range(25):
            n = int(rng.randint(1, 6))
            ranks = sorted(rng.choice(8, n, replace=False).tolist())
            ints = {r: int(rng.randint(0, 4)) for r in ranks}
            lists = {r: rng.randint(0, 9, rng.randint(0, 4)).tolist()
                     for r in ranks}
            dicts = {r: {"v": int(rng.randint(0, 3))} for r in ranks}
            for name in REDUCERS:
                vs = lists if name == "union" else \
                    dicts if name in ("majority", "first") and \
                    rng.rand() < 0.5 else ints
                assert REDUCERS[name](dict(vs)) == J.REDUCERS[name](dict(vs))


class TestAgreement:
    def test_three_ranks_agree_and_carry_all_votes(self, tmp_path):
        cs = _ranks(tmp_path, 3)
        decs = _decide_all(cs, "admit", [10, 20, 10])
        for d in decs:
            assert d.value == 10 and d.epoch == 0
            assert d.votes == {0: 10, 1: 20, 2: 10}
            assert d.participants == [0, 1, 2] and d.missing == []
        assert decs[0].to_dict() == decs[1].to_dict() == decs[2].to_dict()

    def test_epoch_advances_in_lockstep(self, tmp_path):
        cs = _ranks(tmp_path, 2)
        for e in range(3):
            decs = _decide_all(cs, "admit", [e, e + 100], reducer="min")
            assert all(d.epoch == e and d.value == e for d in decs)
        assert all(c.epoch("admit") == 3 for c in cs)

    def test_callable_reducer(self, tmp_path):
        cs = _ranks(tmp_path, 2)

        def spread(votes):
            return max(votes.values()) - min(votes.values())

        decs = _decide_all(cs, "x", [3, 10], reducer=spread)
        assert all(d.value == 7 for d in decs)

    def test_late_rank_adopts_published_decision(self, tmp_path):
        cs = _ranks(tmp_path, 2, lease_s=0.2, window_s=0.3)
        stop = threading.Event()

        def beat():
            while not stop.is_set():
                cs[1].heartbeat()
                time.sleep(0.05)

        t = threading.Thread(target=beat)
        t.start()
        try:
            d0 = cs[0].decide("admit", 5)
        finally:
            stop.set()
            t.join()
        assert d0.value == 5 and d0.missing == [1]
        d1 = cs[1].decide("admit", 99)
        assert d1.epoch == 0 and d1.value == 5
        assert d1.to_dict() == d0.to_dict()

    def test_vote_is_idempotent_first_wins(self, tmp_path):
        c = Consensus(str(tmp_path), 0, 1)
        c.vote("t", "first")
        c.vote("t", "second")
        d = c.outcome("t", reducer="first")
        assert d is not None and d.value == "first"


class TestLiveness:
    def test_dead_rank_is_dropped_after_lease_expiry(self, tmp_path):
        cs = _ranks(tmp_path, 3, lease_s=0.25)
        t0 = time.monotonic()
        decs = _decide_all(cs[:2], "admit", [[1], [2]], reducer="union")
        assert time.monotonic() - t0 < 5.0
        for d in decs:
            assert d.missing == [2] and d.participants == [0, 1]
            assert d.value == [1, 2]

    def test_leader_death_hands_publication_to_next_rank(self, tmp_path):
        cs = _ranks(tmp_path, 2, lease_s=0.25)
        cs[0].vote("admit", 7)
        time.sleep(0.35)
        d = cs[1].decide("admit", 9, reducer="min")
        assert d.value == 7
        assert d.leader == 1 and d.participants == [0, 1]

    def test_follower_times_out_when_leader_never_decides(self, tmp_path):
        cs = _ranks(tmp_path, 2, lease_s=30.0, window_s=60.0, timeout_s=0.5)
        with pytest.raises(ConsensusTimeout):
            cs[1].decide("x", 1)

    def test_provably_dead_sole_peer_does_not_block(self, tmp_path):
        cs = _ranks(tmp_path, 2, lease_s=0.2, window_s=60.0)
        os.unlink(os.path.join(str(tmp_path), "lease.1"))
        d = cs[0].decide("x", 1, reducer="first")
        assert d.value == 1 and d.missing == [1]

    def test_window_expiry_decides_without_silent_live_rank(self, tmp_path):
        seq0 = pevents.log().next_seq
        n0 = registry().counter("consensus/vote_window_expiries").value
        cs = _ranks(tmp_path, 2, lease_s=10.0, window_s=0.2)
        d = cs[0].decide("x", 4)
        assert d.value == 4 and d.missing == [1]
        assert registry().counter(
            "consensus/vote_window_expiries").value == n0 + 1
        evs = [e for e in pevents.log().events(since_seq=seq0)
               if e.kind == "vote_window_expiry"]
        assert [e.attrs["waiting_on"] for e in evs] == [[1]]

    def test_heartbeat_thread_keeps_the_lease(self, tmp_path):
        c = Consensus(str(tmp_path), 0, 2, lease_s=0.3).start_heartbeat(0.05)
        other = Consensus(str(tmp_path), 1, 2, lease_s=0.3)
        try:
            time.sleep(0.5)
            assert other.alive() == [0, 1]
            assert C.lease_ages(str(tmp_path))[0] < 0.3
        finally:
            c.stop_heartbeat()
        time.sleep(0.4)
        n0 = registry().counter("consensus/lease_expiries").value
        assert other.alive() == [1]
        assert registry().counter("consensus/lease_expiries").value == n0 + 1

    def test_board_discovers_a_joiner_and_fast_forwards(self, tmp_path):
        cs = _ranks(tmp_path, 2, lease_s=5.0)
        for e in range(3):
            _decide_all(cs, "admit", [e, e], reducer="first")
        joiner = Consensus(str(tmp_path), 2, 3, lease_s=5.0)
        assert cs[0].board_ranks() == [0, 1, 2]
        assert cs[0].alive() == [0, 1, 2]
        assert sorted(C.lease_ages(str(tmp_path), world=2)) == [0, 1]
        assert joiner.fast_forward("admit") == 0    # full history survives
        import shutil
        shutil.rmtree(tmp_path / "admit" / "e000000")
        assert Consensus(str(tmp_path), 3, 4).fast_forward("admit") == 1


class TestPendingAndOutcome:
    def test_pending_signals_open_proposal(self, tmp_path):
        cs = _ranks(tmp_path, 2)
        assert not cs[1].pending("rollback")
        cs[0].vote("rollback", {"verdict": "rollback", "step": 4})
        assert cs[1].pending("rollback")
        d = cs[1].decide("rollback", {"verdict": "healthy"}, reducer="first")
        assert d.value["verdict"] == "rollback"
        assert cs[0].decide("rollback", None).epoch == 0
        assert not cs[1].pending("rollback")

    def test_outcome_is_nonblocking(self, tmp_path):
        cs = _ranks(tmp_path, 2)
        cs[0].vote("x", 1)
        t0 = time.monotonic()
        assert cs[0].outcome("x") is None
        assert time.monotonic() - t0 < 0.2

    def test_publish_race_single_winner(self, tmp_path):
        cs = _ranks(tmp_path, 2)
        cs[0].vote("x", "zero")
        cs[1].vote("x", "one")
        d0 = cs[0].outcome("x", reducer="first")
        d1 = cs[1].outcome("x", reducer="first")
        assert d0 is not None and d1 is not None
        assert d0.to_dict() == d1.to_dict()

    def test_decision_roundtrip(self):
        d = Decision("f", 3, [1, 2], {0: [1], 1: [2]}, [0, 1], [2], 0)
        assert Decision.from_dict(
            json.loads(json.dumps(d.to_dict()))).to_dict() == d.to_dict()

    def test_adoption_is_observed(self, tmp_path):
        """Every adoption: ``consensus/epochs_adopted``, a vote round
        trip, a ``consensus_decision`` event and ``adopted_epochs``."""
        seq0 = pevents.log().next_seq
        reg = registry()
        n0 = reg.counter("consensus/epochs_adopted").value
        h0 = reg.histogram("consensus/vote_rtt_ms").count
        cs = _ranks(tmp_path, 2)
        _decide_all(cs, "obs_family", [1, 2], reducer="max")
        assert reg.counter("consensus/epochs_adopted").value == n0 + 2
        assert reg.histogram("consensus/vote_rtt_ms").count == h0 + 2
        evs = [e for e in pevents.log().events(since_seq=seq0)
               if e.kind == "consensus_decision"
               and e.attrs["family"] == "obs_family"]
        assert len(evs) == 2 and all("rtt_ms" in e.attrs for e in evs)
        assert C.adopted_epochs()["obs_family"] == 0


class TestHistoryBounds:
    def test_adopted_epochs_are_pruned(self, tmp_path):
        cs = _ranks(tmp_path, 2)
        rounds = 4 * C.KEEP_EPOCHS
        for e in range(rounds):
            _decide_all(cs, "admit", [e, e], reducer="first")
        fam = tmp_path / "admit"
        dirs = [n for n in os.listdir(fam) if n.startswith("e")]
        assert len(dirs) < rounds
        assert f"e{rounds - 1:06d}" in dirs
        decs = _decide_all(cs, "admit", [1, 2], reducer="min")
        assert all(d.value == 1 and d.epoch == rounds for d in decs)
        assert C.KEEP_EPOCHS == J.KEEP_EPOCHS


class TestMixedBoard:
    """A reference rank and a port rank on one board: the same protocol."""

    @pytest.mark.parametrize("leader", ["port", "reference"])
    def test_same_decisions_and_files(self, tmp_path, leader):
        mk = {"port": Consensus, "reference": J.Consensus}
        other = "reference" if leader == "port" else "port"
        cs = [mk[leader](str(tmp_path), 0, 2, lease_s=2.0, poll_s=0.005,
                         timeout_s=10.0),
              mk[other](str(tmp_path), 1, 2, lease_s=2.0, poll_s=0.005,
                        timeout_s=10.0)]
        for e, (vals, red) in enumerate([([3, 5], "min"),
                                         ([[2, 1], [1, 4]], "union"),
                                         ([{"a": 1}, {"a": 2}], "first"),
                                         ([True, False], "all")]):
            decs = _decide_all(cs, "mixed", vals, reducer=red)
            assert decs[0].to_dict() == decs[1].to_dict()
            assert decs[0].epoch == e and decs[0].leader == 0
            with open(tmp_path / "mixed" / f"e{e:06d}" / "decision.json") as f:
                on_disk = json.load(f)
            assert on_disk == decs[0].to_dict() == decs[1].to_dict()
            assert decs[0].value == J.REDUCERS[red](
                {0: vals[0], 1: vals[1]})

    def test_port_follower_adopts_reference_history(self, tmp_path):
        ref = J.Consensus(str(tmp_path), 0, 1)
        for v in (4, 5):
            ref.decide("hist", v, reducer="first")
        late = Consensus(str(tmp_path), 1, 2, lease_s=0.01)
        got = [late.outcome("hist", reducer="first") for _ in range(2)]
        assert [d.value for d in got] == [4, 5]
        assert [d.to_dict() for d in got] == [
            J.Decision.from_dict(json.load(open(
                tmp_path / "hist" / f"e{e:06d}" / "decision.json"))).to_dict()
            for e in range(2)]


class TestRetry:
    def test_schedule_equals_reference(self):
        from paddle_tpu.utils import retry as jr

        for kw in (dict(attempts=5, base_delay=0.05, factor=2.0,
                        max_delay=0.3),
                   dict(attempts=4, base_delay=0.1, factor=3.0,
                        max_delay=5.0, jitter=0.5, seed=11)):
            assert backoff_delays(**kw) == jr.backoff_delays(**kw)

    def test_call_decorator_and_exhaustion(self):
        seen, sleeps = [], []
        box = {"n": 2}

        def flaky():
            if box["n"]:
                box["n"] -= 1
                raise OSError("transient")
            return "ok"

        assert retry(flaky, attempts=4, base_delay=0.01,
                     on_retry=lambda i, e, d: seen.append((i, d)),
                     sleep=sleeps.append) == "ok"
        assert seen == [(0, 0.01), (1, 0.02)] and sleeps == [0.01, 0.02]

        @retry(attempts=2, base_delay=0.0, exceptions=(OSError,))
        def always():
            raise OSError("down")

        with pytest.raises(RetryError) as ei:
            always()
        assert ei.value.attempts == 2 and isinstance(ei.value.last, OSError)
        with pytest.raises(ValueError):       # not a retried exception
            retry(lambda: int("x"), exceptions=(OSError,))
