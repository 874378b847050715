"""Cross-rank agreement: a deterministic all-gather vote with epoch and
lease semantics over a shared directory (mirrors
``paddle_tpu/distributed/consensus.py``, the same on-disk protocol: a
rank of the port and a rank of the reference can share one board).

The serving mesh (``serving/disagg.py``) agrees through it on admission
routing, the clock offset table, membership, the prefix index and
completion. A board on a shared directory, not a ``torch.distributed``
collective, because agreement must be reached exactly when the mesh is
unhealthy: a dead or hung peer is the input, and a collective with a
dead participant hangs.

Protocol (per topic *family*, e.g. ``"admit"``):

- every rank keeps a **lease** alive (``lease.<rank>`` mtime, refreshed
  by ``heartbeat()``, by every vote and poll, and by the daemon thread of
  ``start_heartbeat``). A rank whose lease is older than ``lease_s`` is
  suspect: its vote is no longer awaited.
- decisions happen in dense **epochs** 0, 1, 2, ... per family. Each
  rank casts at most one immutable vote an epoch
  (``<family>/e<epoch>/vote.<rank>``).
- the **leader**, the lowest-ranked live rank, publishes the decision
  once every live rank has voted, or once the epoch's vote window
  (``window_s`` from its first vote) expires with at least one vote.
  Publication is an exclusive link of an immutable ``decision.json``; of
  two racing leaders exactly one file wins and the other adopts it.
- every rank adopts the decision by reading that file, then advances its
  epoch cursor; a rank that slept through epochs reads the dense history
  in order. The decision carries every vote it was reduced from.

The value is the leader's reduction of the votes (sorted by rank) with
the caller's reducer: ``any``/``all``, ``majority`` (most common value,
lowest-rank tie-break), ``min``/``max``, ``union`` (sorted union of list
votes), ``first`` (lowest-ranked vote), or a callable ``f({rank: vote})``.

Observability: every adoption adds one to ``consensus/epochs_adopted``,
observes the vote round trip (``consensus/vote_rtt_ms``, cast to adopted,
when this rank voted) and emits ``consensus_decision``; lease expiries
(``consensus/lease_expiries``, ``lease_expiry``) and vote-window expiries
(``consensus/vote_window_expiries``, ``vote_window_expiry``) are counted
at the transition. None of it can break agreement. ``adopted_epochs()``
is the process-wide ``{family: last adopted epoch}`` that the sink's
frames and the flight recorder's dumps carry.

Limits: liveness is mtime-based, so a board across nodes needs a shared
filesystem with coherent timestamps; a rank that dies after voting still
counts (its vote is a fact on the board).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from collections import Counter as _Counter
from typing import Any, Callable, Dict, List, Optional, Union

__all__ = ["Consensus", "Decision", "ConsensusTimeout", "REDUCERS",
           "adopted_epochs", "lease_ages"]

#: adopted epochs kept on disk behind every live rank's cursor (the
#: replay window of a slow rank); older ones are pruned
KEEP_EPOCHS = 8


class ConsensusTimeout(RuntimeError):
    """decide() ran out of time before a decision was published."""


#: last adopted epoch per family, process-global: the
#: flight recorder stamps this into post-mortem dumps so dumps from
#: different ranks can be ordered by agreement history, not just wall
#: clocks. Written on every adoption; a process driving several
#: Consensus instances (in-process mesh tests) sees the newest.
_ADOPTED: Dict[str, int] = {}
_ADOPTED_LOCK = threading.Lock()


def adopted_epochs() -> Dict[str, int]:
    """{family: last adopted epoch} for this process."""
    with _ADOPTED_LOCK:
        return dict(_ADOPTED)


def lease_ages(board_dir: str,
               world: Optional[int] = None) -> Dict[int, float]:
    """{rank: seconds since its ``lease.<rank>`` was refreshed} read
    straight off the board directory — a pure-stdlib OBSERVER's view
    of mesh liveness (the serving mesh's death detector reads it;
    an observer needs no Consensus instance). A rank with NO lease file
    is simply absent from the result — never fabricated. ``world``
    bounds the scan when given; otherwise every ``lease.*`` file on
    the board is reported."""
    out: Dict[int, float] = {}
    now = time.time()
    try:
        names = os.listdir(board_dir)
    except OSError:
        return out
    for n in names:
        if not n.startswith("lease."):
            continue
        try:
            r = int(n[len("lease."):])
        except ValueError:
            continue
        if world is not None and not 0 <= r < world:
            continue
        try:
            out[r] = max(0.0, now - os.path.getmtime(
                os.path.join(board_dir, n)))
        except OSError:
            pass
    return out


class Decision:
    """One published, immutable agreement.

    epoch:        dense per-family decision index.
    value:        the reduced (agreed) value — what callers act on.
    votes:        {rank: vote} actually received (sorted by rank).
    participants: ranks whose votes were reduced.
    missing:      ranks alive at epoch start that never voted inside
                  the window, plus suspects — the fault evidence.
    leader:       rank that published.
    """

    __slots__ = ("family", "epoch", "value", "votes", "participants",
                 "missing", "leader")

    def __init__(self, family: str, epoch: int, value, votes: Dict[int, Any],
                 participants: List[int], missing: List[int], leader: int):
        self.family = family
        self.epoch = epoch
        self.value = value
        self.votes = votes
        self.participants = participants
        self.missing = missing
        self.leader = leader

    def to_dict(self) -> dict:
        return {"family": self.family, "epoch": self.epoch,
                "value": self.value,
                "votes": {str(r): v for r, v in self.votes.items()},
                "participants": self.participants,
                "missing": self.missing, "leader": self.leader}

    @classmethod
    def from_dict(cls, d: dict) -> "Decision":
        return cls(d["family"], int(d["epoch"]), d["value"],
                   {int(r): v for r, v in d["votes"].items()},
                   [int(r) for r in d["participants"]],
                   [int(r) for r in d["missing"]], int(d["leader"]))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Decision({self.family}#{self.epoch} -> {self.value!r} "
                f"votes={self.votes!r} missing={self.missing!r})")


def _majority(votes: Dict[int, Any]):
    """Most common vote value; ties break toward the value held by the
    lowest-ranked voter (deterministic without value ordering)."""
    counts = _Counter(json.dumps(v, sort_keys=True)
                      for v in votes.values())
    best = max(counts.values())
    for r in sorted(votes):
        if counts[json.dumps(votes[r], sort_keys=True)] == best:
            return votes[r]
    raise ValueError("majority of zero votes")  # pragma: no cover


REDUCERS: Dict[str, Callable[[Dict[int, Any]], Any]] = {
    "any": lambda v: any(bool(x) for x in v.values()),
    "all": lambda v: all(bool(x) for x in v.values()),
    "majority": _majority,
    "min": lambda v: min(v[r] for r in sorted(v)),
    "max": lambda v: max(v[r] for r in sorted(v)),
    "union": lambda v: sorted({x for vv in v.values() for x in vv}),
    "first": lambda v: v[min(v)],
}


class Consensus:
    """See module docstring. One instance per rank per board."""

    def __init__(self, board_dir: str, rank: int, world: int, *,
                 lease_s: float = 5.0, window_s: Optional[float] = None,
                 poll_s: float = 0.02, timeout_s: float = 60.0):
        if world < 1 or not 0 <= rank < world:
            raise ValueError(f"bad rank/world {rank}/{world}")
        if lease_s <= 0:
            raise ValueError("lease_s must be > 0")
        self.dir = board_dir
        self.rank = int(rank)
        self.world = int(world)
        self.lease_s = float(lease_s)
        #: a live-but-slow rank gets this long from the epoch's FIRST
        #: vote before the leader decides without it (a dead rank is
        #: dropped sooner, at lease expiry)
        self.window_s = float(window_s) if window_s is not None \
            else 4.0 * float(lease_s)
        self.poll_s = float(poll_s)
        self.timeout_s = float(timeout_s)
        self._epochs: Dict[str, int] = {}
        #: when THIS rank voted in (family, epoch) — the anchor of the
        #: vote round-trip measurement (vote cast -> decision adopted)
        self._vote_t: Dict[tuple, float] = {}
        #: previously-observed live set; None until the first alive()
        #: call so mesh bring-up (peers' leases not written yet) does
        #: not read as a storm of expiries
        self._last_alive: Optional[set] = None
        self._hb_stop: Optional[threading.Event] = None
        self._hb_thread: Optional[threading.Thread] = None
        os.makedirs(board_dir, exist_ok=True)
        self.heartbeat()

    @classmethod
    def for_mesh(cls, board_dir: str, **kw) -> "Consensus":
        """Build from the ambient ``torch.distributed`` world (rank 0
        of 1 when no process group was initialized), through the one
        rank/world detection helper (``profiler.sink``)."""
        from ..profiler.sink import _detect_rank, _detect_world

        return cls(board_dir, _detect_rank(), _detect_world(), **kw)

    # -- leases ------------------------------------------------------------
    def _lease_path(self, rank: int) -> str:
        return os.path.join(self.dir, f"lease.{rank}")

    def heartbeat(self) -> None:
        """Refresh this rank's lease. Called implicitly by every vote
        and poll; loops that can stall (compile, checkpoint I/O) should
        call it at their own boundaries."""
        p = self._lease_path(self.rank)
        try:
            os.utime(p)
        except OSError:
            with open(p, "w") as f:
                f.write(str(os.getpid()))

    def start_heartbeat(self, interval_s: Optional[float] = None
                        ) -> "Consensus":
        """Refresh the lease from a daemon thread (default every
        ``lease_s / 3``). Use whenever the calling loop can stall
        longer than the lease — a rank COMPILING its first program for
        a minute is alive, and its lease must say so. A killed process
        stops heartbeating (threads die with it), which is exactly the
        signal the board wants; a HUNG process keeps its lease — that
        is the vote window's job, not the lease's."""
        if self._hb_thread is not None:
            return self
        beat = max((self.lease_s / 3.0) if interval_s is None
                   else float(interval_s), 0.02)
        self._hb_stop = threading.Event()

        def loop():
            while not self._hb_stop.wait(beat):
                try:
                    self.heartbeat()
                except OSError:  # pragma: no cover - board removed
                    pass

        self._hb_thread = threading.Thread(
            target=loop, name="consensus-heartbeat", daemon=True)
        self._hb_thread.start()
        return self

    def stop_heartbeat(self) -> None:
        if self._hb_thread is None:
            return
        self._hb_stop.set()
        self._hb_thread.join(timeout=2)
        self._hb_thread = None
        self._hb_stop = None

    def board_ranks(self) -> List[int]:
        """Every rank with a ``lease.<r>`` file on the board — the
        DISCOVERED membership candidates (a joiner outside
        this instance's original ``world`` announces itself by writing
        its lease; static meshes see exactly ``range(world)`` because
        nobody else ever writes one). Self always counts."""
        cand = set(range(self.world))
        cand.add(self.rank)
        try:
            names = os.listdir(self.dir)
        except OSError:
            return sorted(cand)
        for n in names:
            if n.startswith("lease.") and ".tmp" not in n:
                try:
                    cand.add(int(n[len("lease."):]))
                except ValueError:
                    pass
        return sorted(cand)

    def alive(self) -> List[int]:
        """Ranks with a fresh lease (self always counts). Candidates
        are discovered from the board (:meth:`board_ranks`), not
        assumed from ``world`` — leadership and vote-await semantics
        follow the mesh that actually exists, so a mid-run joiner is
        awaited the moment its lease lands."""
        now = time.time()
        out = []
        for r in self.board_ranks():
            if r == self.rank:
                out.append(r)
                continue
            try:
                if now - os.path.getmtime(self._lease_path(r)) \
                        < self.lease_s:
                    out.append(r)
            except OSError:
                pass
        cur = set(out)
        if self._last_alive is not None and cur != self._last_alive:
            for r in sorted(self._last_alive - cur):
                _note_lease_expiry(r)
        self._last_alive = cur
        return out

    # -- epochs ------------------------------------------------------------
    def _family_dir(self, family: str) -> str:
        if "/" in family or family.startswith("lease."):
            raise ValueError(f"bad family name {family!r}")
        return os.path.join(self.dir, family)

    def _epoch_dir(self, family: str, epoch: int) -> str:
        return os.path.join(self._family_dir(family), f"e{epoch:06d}")

    def epoch(self, family: str) -> int:
        """This rank's current (next unadopted) epoch for ``family``.
        Always starts at 0: a rank that slept through epochs (or a
        restarted one) adopts the dense published history IN ORDER —
        every decision carries assignments/verdicts the rank must act
        on, so skipping ahead would silently drop agreements."""
        if family not in self._epochs:
            self._epochs[family] = 0
            os.makedirs(self._family_dir(family), exist_ok=True)
        return self._epochs[family]

    def fast_forward(self, family: str) -> int:
        """Joiner catch-up: position this rank's epoch
        cursor at the OLDEST epoch still on the board for ``family``.
        A rank that joins after earlier epochs were pruned
        (KEEP_EPOCHS) cannot adopt them in order — ``epoch()``'s dense
        contract would stall it forever at a directory that no longer
        exists. It fast-forwards to the surviving history's head and
        adopts from there; whatever state the pruned epochs carried
        reaches it through the membership decision's sync snapshot
        (serving/disagg.py ``_member_reducer``). Returns the cursor
        (unchanged — possibly 0 — when the full history survives)."""
        fam = self._family_dir(family)
        cur = self.epoch(family)
        oldest: Optional[int] = None
        try:
            names = os.listdir(fam)
        except OSError:
            names = []
        for n in names:
            if n.startswith("e") and len(n) == 7 and n[1:].isdigit():
                e = int(n[1:])
                oldest = e if oldest is None else min(oldest, e)
        if oldest is not None and oldest > cur:
            self._epochs[family] = oldest
        return self._epochs[family]

    # -- voting ------------------------------------------------------------
    def vote(self, family: str, value) -> None:
        """Cast this rank's (immutable, idempotent) vote in the current
        epoch. A second vote in the same epoch is ignored — re-voting a
        DIFFERENT value in one epoch is a caller bug, not a protocol
        feature."""
        self.heartbeat()
        ed = self._epoch_dir(family, self.epoch(family))
        os.makedirs(ed, exist_ok=True)
        path = os.path.join(ed, f"vote.{self.rank}")
        self._vote_t.setdefault((family, self.epoch(family)),
                                time.monotonic())
        if os.path.exists(path):
            return
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"rank": self.rank, "value": value,
                       "t": time.time()}, f)
        try:
            os.link(tmp, path)      # exclusive: first vote wins
        except FileExistsError:
            pass
        finally:
            os.unlink(tmp)

    def pending(self, family: str) -> bool:
        """True when the current epoch already has activity (a vote or
        a decision) — how a healthy rank notices, at its own step
        boundary, that a peer opened a proposal it should join."""
        ed = self._epoch_dir(family, self.epoch(family))
        try:
            return bool(os.listdir(ed))
        except OSError:
            return False

    def _read_votes(self, ed: str) -> Dict[int, Any]:
        votes: Dict[int, Any] = {}
        try:
            names = os.listdir(ed)
        except OSError:
            return votes
        for n in names:
            if not n.startswith("vote.") or ".tmp" in n:
                continue
            try:
                with open(os.path.join(ed, n)) as f:
                    d = json.load(f)
                votes[int(d["rank"])] = d["value"]
            except (OSError, ValueError, KeyError):
                continue            # torn concurrent write: next poll
        return votes

    def _first_vote_t(self, ed: str) -> Optional[float]:
        ts = []
        try:
            names = os.listdir(ed)
        except OSError:
            return None
        for n in names:
            if n.startswith("vote.") and ".tmp" not in n:
                try:
                    ts.append(os.path.getmtime(os.path.join(ed, n)))
                except OSError:
                    pass
        return min(ts) if ts else None

    def outcome(self, family: str,
                reducer: Union[str, Callable] = "majority"
                ) -> Optional[Decision]:
        """Non-blocking: the current epoch's decision if one can be
        adopted or published right now, else None. Adopting a decision
        advances the epoch cursor, so the next vote opens the next
        epoch."""
        self.heartbeat()
        e = self.epoch(family)
        ed = self._epoch_dir(family, e)
        dpath = os.path.join(ed, "decision.json")
        dec = self._try_read_decision(dpath)
        if dec is None:
            snap = self._should_publish(family, ed)
            if snap is not None:
                dec = self._publish(family, e, ed, dpath, reducer,
                                    *snap)
        if dec is not None:
            self._epochs[family] = e + 1
            rtt = self._vote_t.pop((family, e), None)
            _note_adoption(dec, None if rtt is None
                           else (time.monotonic() - rtt) * 1e3)
            self._note_adopted(family, e)
        return dec

    def decide(self, family: str, value, *,
               reducer: Union[str, Callable] = "majority",
               timeout_s: Optional[float] = None) -> Decision:
        """Blocking all-gather vote: cast ``value``, poll until the
        epoch's decision exists (publishing it if this rank becomes the
        leader), adopt it. Raises ConsensusTimeout past ``timeout_s``."""
        self.vote(family, value)
        deadline = time.monotonic() + (self.timeout_s if timeout_s is None
                                       else float(timeout_s))
        while True:
            dec = self.outcome(family, reducer)
            if dec is not None:
                return dec
            if time.monotonic() > deadline:
                raise ConsensusTimeout(
                    f"{family}#{self.epoch(family)}: no decision within "
                    f"timeout (alive={self.alive()})")
            time.sleep(self.poll_s)

    # -- history bounds ----------------------------------------------------
    def _note_adopted(self, family: str, epoch: int) -> None:
        """Publish this rank's adopted-epoch cursor and periodically
        prune history every live rank is past: decisions are immutable
        facts, but an agreement board that grows one directory per
        round forever is a filesystem leak on a long-lived mesh.
        Epochs newer than ``min(live cursors) - KEEP_EPOCHS`` survive
        so a transiently-slow rank still catches up in order; a rank
        dead past its lease that later revives may find its history
        pruned — it was not a member anymore (documented residue)."""
        fam = self._family_dir(family)
        path = os.path.join(fam, f"cursor.{self.rank}")
        tmp = path + f".tmp{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                f.write(str(epoch))
            os.replace(tmp, path)
        except OSError:  # pragma: no cover - board dir vanished
            return
        if (epoch + 1) % KEEP_EPOCHS != 0:
            return
        cursors = []
        for r in self.alive():
            try:
                with open(os.path.join(fam, f"cursor.{r}")) as f:
                    cursors.append(int(f.read()))
            except (OSError, ValueError):
                return          # a live rank with no cursor: no prune
        cut = min(cursors) - KEEP_EPOCHS + 1
        try:
            names = os.listdir(fam)
        except OSError:  # pragma: no cover
            return
        for n in names:
            if n.startswith("e") and len(n) == 7 and n[1:].isdigit() \
                    and int(n[1:]) < cut:
                shutil.rmtree(os.path.join(fam, n), ignore_errors=True)

    # -- leader path -------------------------------------------------------
    def _try_read_decision(self, dpath: str) -> Optional[Decision]:
        try:
            with open(dpath) as f:
                return Decision.from_dict(json.load(f))
        except OSError:
            return None
        except ValueError:          # pragma: no cover - torn mid-link
            return None             # read (impossible: link is atomic)

    def _should_publish(self, family: str, ed: str):
        """The publish decision AND its evidence: (votes, live) when
        this rank should publish right now, else None. The snapshot is
        handed to _publish verbatim — recomputing liveness there could
        see a lease flap and blame a rank that was never waited out."""
        live = self.alive()
        if self.rank != min(live):
            return None             # not the leader
        votes = self._read_votes(ed)
        if not votes:
            return None             # nothing to decide from
        if all(r in votes for r in live):
            return votes, live      # every live rank voted
        t0 = self._first_vote_t(ed)
        if t0 is not None and time.time() - t0 > self.window_s:
            return votes, live
        return None

    def _publish(self, family: str, epoch: int, ed: str, dpath: str,
                 reducer: Union[str, Callable], votes: Dict[int, Any],
                 live: List[int]) -> Optional[Decision]:
        red = REDUCERS[reducer] if isinstance(reducer, str) else reducer
        missing = sorted(set(range(self.world)) - set(votes))
        waited_out = sorted(set(live) - set(votes))
        if waited_out:
            # publishing WITHOUT every live vote: the epoch's window
            # expired on someone — fault evidence worth an event
            _note_window_expiry(family, epoch, waited_out)
        dec = Decision(family, epoch, red(dict(sorted(votes.items()))),
                       dict(sorted(votes.items())), sorted(votes),
                       missing, self.rank)
        tmp = dpath + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(dec.to_dict(), f)
        try:
            os.link(tmp, dpath)     # exclusive publish: one winner
        except FileExistsError:
            dec = self._try_read_decision(dpath)   # adopt the winner's
        finally:
            os.unlink(tmp)
        _note_decision(family, live)
        return dec


def _note_decision(family: str, live: List[int]) -> None:
    """Profiler breadcrumbs — decisions are rare, counters are cheap."""
    try:
        from ..profiler.metrics import registry

        registry().counter(f"consensus/decisions_{family}").add(1)
        registry().gauge("consensus/live_ranks").set(float(len(live)))
    except Exception:               # pragma: no cover - metrics must
        pass                        # never break agreement


def _note_adoption(dec: Decision, rtt_ms: Optional[float]) -> None:
    """Consensus observability: every adoption counts an
    epoch, times the vote round trip (cast -> adopted, only when this
    rank voted in the epoch) and leaves a ``consensus_decision`` event
    — all flushed through the normal sink, all guarded (telemetry must
    never break agreement)."""
    with _ADOPTED_LOCK:
        _ADOPTED[dec.family] = dec.epoch
    try:
        from ..profiler import events as _events
        from ..profiler.metrics import registry

        registry().counter("consensus/epochs_adopted").add(1)
        attrs = {"family": dec.family, "epoch": dec.epoch,
                 "leader": dec.leader, "missing": len(dec.missing)}
        if rtt_ms is not None:
            registry().histogram("consensus/vote_rtt_ms").observe(rtt_ms)
            attrs["rtt_ms"] = round(rtt_ms, 3)
        _events.emit("consensus_decision", **attrs)
    except Exception:               # pragma: no cover
        pass


def _note_lease_expiry(peer: int) -> None:
    try:
        from ..profiler import events as _events
        from ..profiler.metrics import registry

        registry().counter("consensus/lease_expiries").add(1)
        _events.emit("lease_expiry", peer=int(peer))
    except Exception:               # pragma: no cover
        pass


def _note_window_expiry(family: str, epoch: int,
                        waiting_on: List[int]) -> None:
    try:
        from ..profiler import events as _events
        from ..profiler.metrics import registry

        registry().counter("consensus/vote_window_expiries").add(1)
        _events.emit("vote_window_expiry", family=family,
                     epoch=int(epoch),
                     waiting_on=[int(r) for r in waiting_on])
    except Exception:               # pragma: no cover
        pass
