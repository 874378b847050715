"""Request trace ids and the process clock state (mirrors the clock
helpers of ``paddle_tpu/profiler/disttrace.py``).

- ``trace_id(gid)``: the deterministic id ``g<gid>`` of a global request,
  the same string on every rank; the engine stamps a request's id as the
  ``trace`` attribute of each of its events.
- ``walltime()``: this rank's wall clock plus an injected test skew
  (``PADDLE_CLOCK_SKEW``, ``"<rank>:<seconds>[,...]"`` or one float for
  every rank). Each sink flush stamps a ``(wall_s, t_ns)`` anchor read
  from it, so an offline reader can place any event's ``perf_counter``
  stamp on this rank's wall clock.
- ``clock_state()``/``set_clock_state()``: this rank's agreed offset
  against a reference rank (``offset_s``, ``unc_s``, ``ref``,
  ``synced``), stamped into every sink line and flight dump.

- ``ClockSync``: Cristian-style clock alignment over a shared directory
  (the substrate of the consensus board and the handoff channel). A
  rank other than the reference stamps ``t0`` on its clock and writes a
  ping; the reference answers with its wall time ``t_ref``; the rank
  stamps ``t1`` when the pong lands. The sample's offset is ``(t0 + t1)
  / 2 - t_ref`` and its uncertainty ``(t1 - t0) / 2`` (the reply lies
  somewhere in the round trip); the sample of least uncertainty of
  ``n_samples`` wins. ``serving/disagg.py`` agrees the mesh's offset
  table on the consensus board (family ``clock``) and adopts this rank's
  row through ``set_clock_state``, so the sink's lines and frames and
  the flight recorder's dumps carry it; a cross-host TTFT is reported
  as ``value +- (unc_src + unc_dst)``.

Sign convention: ``offset_s`` of rank K is K's wall clock minus the
reference rank's; a K-stamped wall time in reference time is ``w_k -
offset_s``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional, Tuple

__all__ = [
    "trace_id", "walltime", "local_skew_s",
    "clock_state", "set_clock_state", "reset_clock_state",
    "ClockSync",
]

#: injected test skew: "<rank>:<seconds>[,<rank>:<seconds>]" or a bare
#: float applied to every rank
SKEW_ENV = "PADDLE_CLOCK_SKEW"


def trace_id(gid: int) -> str:
    """Deterministic trace id of global request ``gid``."""
    return f"g{int(gid):08d}"


def _env_rank() -> int:
    """This process's rank from the ``PADDLE_TRAINER_ID`` environment
    variable (0 when unset or malformed)."""
    try:
        return int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    except ValueError:
        return 0


def local_skew_s(rank: Optional[int] = None) -> float:
    """The injected wall-clock skew of ``rank`` (default: this process)
    from ``PADDLE_CLOCK_SKEW``; 0.0 when unset."""
    raw = os.environ.get(SKEW_ENV)
    if not raw:
        return 0.0
    r = _env_rank() if rank is None else int(rank)
    try:
        if ":" not in raw:
            return float(raw)
        for part in raw.split(","):
            rr, ss = part.split(":")
            if int(rr) == r:
                return float(ss)
        return 0.0
    except ValueError:
        return 0.0


def walltime(skew_s: Optional[float] = None) -> float:
    """This rank's wall clock: ``time.time()`` plus the injected skew.
    Every wall stamp that takes part in cross-host arithmetic comes from
    here, so a skew is the same (and correctable) on all of them."""
    return time.time() + (local_skew_s() if skew_s is None else skew_s)


_lock = threading.Lock()
_state: Dict[str, object] = {
    "offset_s": None,   # this rank's wall clock minus the reference's
    "unc_s": None,      # +- bound on offset_s
    "ref": 0,           # reference rank the offsets are relative to
    "synced": False,    # True once an agreed estimate was adopted
}


def set_clock_state(offset_s: Optional[float], unc_s: Optional[float],
                    ref: int = 0, synced: bool = True) -> None:
    """Adopt this rank's agreed clock offset; the sink stamps it into
    every later flush line."""
    with _lock:
        _state["offset_s"] = None if offset_s is None else float(offset_s)
        _state["unc_s"] = None if unc_s is None else float(unc_s)
        _state["ref"] = int(ref)
        _state["synced"] = bool(synced)


def clock_state() -> dict:
    """A copy of the clock state ``{offset_s, unc_s, ref, synced}``;
    ``offset_s`` None means this rank never synced."""
    with _lock:
        return dict(_state)


def reset_clock_state() -> None:
    set_clock_state(None, None, ref=0, synced=False)


class ClockSync:
    """One rank's half of the ping exchange (module docstring).

    The reference rank answers pings (``step()`` is its serve loop and
    returns True immediately — its own offset is 0 ± 0 by definition);
    every other rank issues ``n_samples`` pings, one at a time, and
    keeps the minimum-uncertainty sample. ``step()`` is non-blocking
    and cheap (one listdir / one stat), built to ride a scheduler
    heartbeat; ``estimate()`` returns ``(offset_s, unc_s)`` once ready.

    Files (all atomic tmp+rename; a rank killed mid-write leaves only
    an ignorable ``.tmp``): ``ping.<rank>.<seq>`` client -> reference,
    ``pong.<rank>.<seq>`` reference -> client (JSON ``{"t_ref": ...}``).
    Consumed files are unlinked by their reader, so the directory
    stays O(in-flight), not O(history).
    """

    def __init__(self, directory: str, rank: int, world: int, *,
                 ref: int = 0, n_samples: int = 5,
                 skew_s: Optional[float] = None):
        if world < 1 or not 0 <= rank < world:
            raise ValueError(f"bad rank/world {rank}/{world}")
        if not 0 <= ref < world:
            raise ValueError(f"reference rank {ref} outside the mesh")
        if n_samples < 1:
            raise ValueError("n_samples must be >= 1")
        self.dir = directory
        self.rank = int(rank)
        self.world = int(world)
        self.ref = int(ref)
        self.n_samples = int(n_samples)
        #: injected test skew (None -> the PADDLE_CLOCK_SKEW default);
        #: must match the skew of every other wall stamp this rank
        #: makes, or the "correction" would un-correct real stamps
        self.skew_s = local_skew_s(rank) if skew_s is None \
            else float(skew_s)
        self._seq = 0
        self._t0: Optional[float] = None      # outstanding ping stamp
        self._samples: list = []              # (unc_s, offset_s)
        os.makedirs(directory, exist_ok=True)
        # purge THIS rank's leftovers from a previous incarnation
        # (restart after a mid-sync crash): seq restarts at 0, and a
        # stale pong.<rank>.0 answered minutes ago would pair with a
        # fresh ping into a wildly-wrong offset whose tiny claimed
        # uncertainty WINS the min-unc selection. Peers' files are
        # not ours to touch.
        self._purge_own_files()

    def _purge_own_files(self) -> None:
        """Unlink THIS rank's ping/pong files (init and resync both
        need it — a stale pong pairing with a fresh ping is the
        hazard in both lifecycles)."""
        try:
            for n in os.listdir(self.dir):
                if n.startswith((f"ping.{self.rank}.",
                                 f"pong.{self.rank}.")):
                    try:
                        os.unlink(os.path.join(self.dir, n))
                    except OSError:  # pragma: no cover
                        pass
        except OSError:  # pragma: no cover - dir vanished
            pass

    # -- clock under test ---------------------------------------------------
    def _now(self) -> float:
        return walltime(self.skew_s)

    # -- protocol -----------------------------------------------------------
    def _write_atomic(self, path: str, doc: dict) -> None:
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)

    def _serve(self) -> None:
        """Reference side: answer every outstanding ping."""
        try:
            names = os.listdir(self.dir)
        except OSError:
            return
        for n in names:
            if not n.startswith("ping.") or ".tmp" in n:
                continue
            pong = os.path.join(self.dir, "pong." + n[len("ping."):])
            self._write_atomic(pong, {"t_ref": self._now()})
            try:
                os.unlink(os.path.join(self.dir, n))
            except OSError:  # pragma: no cover - racing second server
                pass

    def step(self) -> bool:
        """Pump the exchange; True once :meth:`estimate` is ready. The
        reference rank serves pongs and is always ready. Call from the
        scheduler heartbeat until ready (the reference keeps calling —
        peers may still be sampling)."""
        if self.rank == self.ref:
            self._serve()
            return True
        if self._t0 is not None:
            pong = os.path.join(self.dir,
                                f"pong.{self.rank}.{self._seq}")
            try:
                with open(pong) as f:
                    t_ref = float(json.load(f)["t_ref"])
            except (OSError, ValueError, KeyError):
                return self.ready          # reply not landed yet
            t1 = self._now()
            t0 = self._t0
            self._t0 = None
            self._seq += 1
            try:
                os.unlink(pong)
            except OSError:  # pragma: no cover
                pass
            self._samples.append(((t1 - t0) / 2.0,
                                  (t0 + t1) / 2.0 - t_ref))
            return self.ready
        if len(self._samples) < self.n_samples:
            ping = os.path.join(self.dir,
                                f"ping.{self.rank}.{self._seq}")
            # t0 BEFORE the write becomes visible: the reference may
            # reply the instant the rename lands, and a t_ref outside
            # [t0, t1] would break the "reply is inside the round
            # trip" premise the ± bound rests on. Stamping early only
            # WIDENS the bound — conservative by construction.
            self._t0 = self._now()
            self._write_atomic(ping, {"rank": self.rank})
        return self.ready

    def resync(self) -> None:
        """Begin a FRESH sampling round (periodic drift tracking): drop
        the previous round's samples, advance the sequence past any
        in-flight exchange and purge this rank's
        leftover ping/pong files — the same stale-pong hazard the
        ``__init__`` purge guards against, now mid-life (a pong
        answered before the resync pairing with a post-resync ping
        would claim a tiny uncertainty for a stale offset and WIN the
        min-unc selection). ``ready`` goes False until ``n_samples``
        new round trips land; the reference rank has nothing to
        resample (its offset is 0 by definition) and no-ops."""
        if self.rank == self.ref:
            return
        self._t0 = None
        self._samples = []
        self._seq += 1
        self._purge_own_files()

    @property
    def ready(self) -> bool:
        return self.rank == self.ref or \
            len(self._samples) >= self.n_samples

    def estimate(self) -> Optional[Tuple[float, float]]:
        """(offset_s, unc_s) — this rank's clock minus the reference's
        with its ± bound — or None while still sampling. The reference
        rank is exactly (0, 0): offsets are *defined* relative to it."""
        if self.rank == self.ref:
            return (0.0, 0.0)
        if not self._samples:
            return None
        unc, off = min(self._samples)
        return (off, unc)
