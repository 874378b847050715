"""Multi-process serving: sharded page pools, consensus-routed admission,
and prefill/decode disaggregation (mirrors ``paddle_tpu/serving/disagg.py``
with its on-disk protocol: board, channel file names and payload keys are
the reference's, so a rank of the port and a rank of the reference read
each other's files).

Topology
--------
Each process (rank) of the mesh runs ONE local :class:`ServingEngine`
over its OWN page pool on its own device: the mesh's KV pool is sharded
by construction (a page id means something only on its owning rank).
Ranks split into two slot groups:

- the **prefill group** (``MeshSpec.prefill_ranks``): long prompts are
  admitted here with ``hold_after_prefill``. The engine runs the normal
  chunked, prefix-cached, preemptible prefill and samples the first
  token; the coordinator then ships the prompt's KV pages to a decode
  rank through :class:`HandoffChannel` and releases the slot. A prefill
  engine's ticks carry only chunk rows.
- the **decode group** (everyone else): imports arrive decode-ready
  (``ServingEngine.admit_prefilled`` seeds the slot where a local
  prefill would have left it), so their ticks carry decode rows; short
  prompts (below ``long_prompt_threshold``, one prefill chunk + 1 by
  default) still prefill locally.

``MeshSpec(prefill_ranks=())`` is the **symmetric** scale-out: every
rank decodes its own admissions, no handoff.

Admission
---------
Every rank submits the SAME request stream in the same order (the SPMD
driver contract: a global id is the submission sequence). Which rank
owns a request is agreed on the consensus board
(``distributed/consensus.py``): each admission round the ranks vote
their load (free pages and slots, queue depth, queued prefill tokens,
rolling p95 TTFT) and the highest id they have seen; the leader reduces
the votes with the pure :func:`route_requests` and publishes the
assignment, and every rank admits exactly its own requests from its own
copy of the stream. No request data rides a vote.

Elastic mesh
------------
A ``member`` round agrees who is on the mesh; routing, the ``done``
ledgers and the clock follow the agreed member set. A member whose
lease is stale past ``dead_after_s`` is declared dead: survivors
re-dispatch its orphans from their own records (requeue through
routing, or a deterministic claimer scavenges a surviving KV file
addressed to the corpse), and the ``done`` ledgers void the handoffs
whose peer died. A joiner (``join=True``) writes its lease, fast-forwards
past pruned history, and is admitted by a member round that carries the
routing high-water mark. Every request finishes exactly once in the
converged ledger; a request whose owner died after serving it is served
again by a survivor (its trace id lets a consumer de-duplicate).

KV handoff
----------
Pages travel as raw pool content through an atomic-rename file channel
(tmp write + rename: a rank killed mid-send leaves only a ``.tmp``). The
port's bf16 pages travel as uint16 bits (numpy has no bf16), tagged
``kv_dtype="bfloat16"``; a reference rank's bf16 file holds
``ml_dtypes.bfloat16`` arrays, which numpy reads back as 2-byte void
records: :meth:`HandoffChannel.poll` takes those as the same bits. int8
pools hand off int8 values with their per-page scales.

Tracing and clocks
------------------
Every request carries ``disttrace.trace_id(gid)`` on its engine events
and across the handoff (``trace_ctx``: submit, export and prefill-TTFT
stamps). The ranks run a Cristian clock sync against rank 0
(``disttrace.ClockSync`` over ``<shared>/clock``), agree the offset
table on the board (family ``clock``) and adopt their row into the
process clock state, which every sink line and frame carries. A
handed-off request's TTFT is the end-to-end delta, prefill-rank submit
to decode-rank first token, offset-corrected, with the two ranks'
summed uncertainty (:meth:`DisaggServer.ttft_bounds`).

Determinism: on the CPU, greedy disaggregated streams are bitwise the
single engine's: the decode rank attends over page bytes identical to
what its own prefill would have written, and each row's result does not
depend on which rows share a tick. ``DisaggServer`` adds no device logic
of its own; ``HandoffChannel`` is host I/O only.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..distributed.consensus import Consensus, lease_ages
from ..profiler import disttrace as _disttrace
from ..profiler import events as _pevents
from ..profiler.metrics import registry as _registry
from ..utils.retry import RetryError, retry as _retry
from .engine import ServingConfig, ServingEngine
from .paged_cache import chain_hashes
from .sched import prefix_affinity_key, ttfc_key

__all__ = ["MeshSpec", "HandoffChannel", "DisaggServer",
           "route_requests"]


def _bf16_as_bits(payload: dict) -> None:
    """Take a bf16 payload's pages as uint16 bits, in place. A file
    written by the reference holds ``ml_dtypes.bfloat16`` arrays, which
    ``np.load`` returns as 2-byte void records (``|V2``) of the same
    bits; the port's own files already hold uint16. Only a payload tagged
    ``kv_dtype="bfloat16"`` is touched, and only 2-byte void arrays."""
    if "kv_dtype" not in payload or str(payload["kv_dtype"]) != "bfloat16":
        return
    for k in ("k", "v"):
        a = payload.get(k)
        if a is not None and a.dtype.kind == "V" and a.dtype.itemsize == 2:
            payload[k] = a.view(np.uint16)


@dataclass(frozen=True)
class MeshSpec:
    """Who is who on the serving mesh. ``prefill_ranks=()`` means
    symmetric scale-out (every rank prefills + decodes its own
    admissions, no handoff)."""

    rank: int
    world: int
    prefill_ranks: Tuple[int, ...] = ()

    def __post_init__(self):
        if not 0 <= self.rank < self.world:
            raise ValueError(f"bad rank {self.rank}/{self.world}")
        bad = [r for r in self.prefill_ranks
               if not 0 <= r < self.world]
        if bad:
            raise ValueError(f"prefill ranks {bad} outside the mesh")
        if len(set(self.prefill_ranks)) == self.world:
            raise ValueError("every rank is a prefill rank: nobody "
                             "would decode")

    @property
    def decode_ranks(self) -> Tuple[int, ...]:
        return tuple(r for r in range(self.world)
                     if r not in self.prefill_ranks)

    @property
    def disaggregated(self) -> bool:
        return bool(self.prefill_ranks)

    @property
    def is_prefill(self) -> bool:
        return self.rank in self.prefill_ranks


class HandoffChannel:
    """Rank-to-rank KV payload transport over a shared directory.

    ``send`` is atomic (tmp write + rename): a reader either sees the
    whole payload or nothing — a sender killed mid-write leaves a
    ``.tmp`` nobody reads. ``poll`` consumes arrivals for THIS rank.
    ``pre_commit`` is the chaos seam: tests point it at
    ``mp_mesh.chaos_point`` to kill a rank between the payload bytes
    landing and the handoff becoming visible.

    Transient I/O: every filesystem touch rides
    :func:`utils.retry.retry` exponential backoff against
    EINTR/ENOSPC-class ``OSError`` — a flaky shared dir must not look
    like a dead peer to the elastic mesh's death detector. Retries are
    counted into ``serving/handoff_retries``."""

    #: chaos hook, invoked between tmp-write and the atomic rename
    pre_commit = staticmethod(lambda: None)

    #: transient-I/O retry policy; class attributes so chaos tests can
    #: tighten the schedule without monkeypatching utils.retry
    retry_attempts = 4
    retry_base_delay_s = 0.01

    def __init__(self, directory: str, rank: int):
        self.dir = directory
        self.rank = int(rank)
        os.makedirs(directory, exist_ok=True)

    def _retry_io(self, fn):
        def _count(_i, _e, _d):
            _registry().counter("serving/handoff_retries").add(1)
        return _retry(fn, attempts=self.retry_attempts,
                      base_delay=self.retry_base_delay_s,
                      exceptions=(OSError,), on_retry=_count)

    def _path_to(self, gid: int, dst: int, kind: str = "h") -> str:
        return os.path.join(self.dir, f"{kind}-{gid:08d}-to{dst}.npz")

    def send(self, dst: int, gid: int, payload: dict,
             kind: str = "h") -> int:
        """Ship ``payload`` to rank ``dst``; returns payload bytes.
        ``kind`` prefixes the filename (default ``h`` = request
        handoff; ``m`` = prefix-chain migration) so the two
        payload families can never cross a poll: a migration chain
        imported as a request — or scavenged off a corpse as one —
        would be a torn admission."""
        final = self._path_to(gid, dst, kind)
        tmp = final + f".tmp{os.getpid()}"
        arrays = {}
        for k, v in payload.items():
            arrays[k] = np.asarray(v)

        def _write():
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)

        self._retry_io(_write)
        HandoffChannel.pre_commit()
        self._retry_io(lambda: os.rename(tmp, final))
        return sum(a.nbytes for a in arrays.values())

    def poll(self, kind: str = "h") -> List[Tuple[int, dict]]:
        """Consume every complete ``kind`` payload addressed to this
        rank."""
        out = []
        prefix = f"{kind}-"
        suffix = f"-to{self.rank}.npz"
        try:
            names = sorted(os.listdir(self.dir))
        except OSError:
            return out
        for n in names:
            if not (n.startswith(prefix) and n.endswith(suffix)):
                continue
            path = os.path.join(self.dir, n)
            gid = int(n[len(prefix):len(prefix) + 8])

            def _load(p=path):
                with np.load(p) as z:
                    return {k: z[k] for k in z.files}

            try:
                payload = self._retry_io(_load)
            except (RetryError, ValueError):
                continue            # racing rename / torn: next poll
            for k in ("orig_prompt_len", "max_new", "first_token",
                      "n_tokens", "preempts"):
                if k in payload:
                    payload[k] = int(payload[k])
            _bf16_as_bits(payload)
            try:
                self._retry_io(lambda p=path: os.unlink(p))
            except RetryError:
                continue            # must not import without consuming
            out.append((gid, payload))
        return out

    def scavenge(self, gid: int, dead_rank: int) -> bool:
        """Claim a DEAD rank's unconsumed payload for this rank
        (re-dispatch): atomically rename
        ``h-<gid>-to<dead>.npz`` to address this rank, then audit that
        the payload actually loads with the keys an import needs — a
        torn or inconsistent file is deleted, not imported (the caller
        falls back to re-prefill, the honest path). Only safe once the
        mesh has DECLARED the addressee dead: a live addressee could
        race the rename with its own poll. Returns True when the
        payload is claimed and clean (the normal ``poll`` imports it
        next heartbeat)."""
        src = self._path_to(gid, dead_rank)
        dst = self._path_to(gid, self.rank)
        try:
            os.rename(src, dst)
        except OSError:
            if not os.path.exists(dst):   # nothing to claim
                return False
        try:
            with np.load(dst) as z:
                keys = set(z.files)
                need = {"prompt", "orig_prompt_len", "max_new",
                        "first_token", "key", "n_tokens", "kv_dtype",
                        "k", "v"}
                if not need <= keys:
                    raise ValueError(
                        f"payload missing {sorted(need - keys)}")
                if int(z["n_tokens"]) < 1 or \
                        z["k"].shape != z["v"].shape:
                    raise ValueError("inconsistent KV payload")
        except (OSError, ValueError, KeyError):
            try:
                os.unlink(dst)
            except OSError:
                pass
            _registry().counter(
                "serving/handoff_scavenge_failed").add(1)
            return False
        _registry().counter("serving/handoffs_scavenged").add(1)
        return True


def _chain_hit_tokens(chain: List[str], digest: dict) -> int:
    """Tokens of ``chain`` (a prompt's chunk-hash chain, lowest chunk
    first) covered by a rank's published ``digest`` — the longest
    UNBROKEN published prefix (a gap means the parent chain was
    evicted; anything past it is unusable)."""
    chains = digest.get("chains") or {}
    hit = 0
    for h in chain:
        n = chains.get(str(h))
        if n is None:
            break
        hit = int(n)
    return hit


def route_requests(votes: Dict[int, dict],
                   prefix_index: Optional[dict] = None) -> dict:
    """The admission reducer: a PURE function of one round's votes —
    whichever live rank leads publishes the same assignment.

    Each vote:  ``{"seen": hwm, "routed": n, "pending": {gid: plen},
    "free_pages": int, "free_slots": int, "queued": int,
    "prefill_backlog": tokens, "ttft_p95_ms": float, "chunk": int,
    "topology": {"prefill": [...], "decode": [...], "threshold": T}}``

    Routes every gid in ``[routed, min(seen over voters))``: a long
    prompt (``plen >= threshold``) goes to the best prefill rank (when
    a prefill group exists) and is decoded by the best decode rank;
    anything else is prefilled AND decoded by the best decode rank.
    "Best" is load-shaped (:func:`sched.ttfc_key`): the
    rank with the smallest estimated TIME-TO-FIRST-CHUNK — its
    queued-prefill-token backlog plus what this round already assigned
    it, in chunk-train units, a slot-overflow penalty, and the rank's
    rolling p95 TTFT as the measured tie-break — rather than free
    pages alone (free pages say nothing about how long a chunk train
    the new arrival queues behind, which is exactly the parked-shorts
    pathology). Votes without
    backlog/p95 keys degrade to a queue-depth estimate, so a
    mixed-version mesh still orders sanely. Deterministic tie-break
    toward the lower rank; same consensus round as before.

    Elastic extensions: the round's high-water mark is the
    MAX of the voters' (a joiner that fast-forwarded past pruned admit
    history votes a low hwm — every gid below the mesh's real mark was
    already assigned in decisions the lagging voter adopts in order,
    so re-routing them would double-serve); and a vote may carry a
    ``requeue`` list — gids whose assigned rank the mesh declared dead
    — which are re-routed through the same load-shaped pick, after
    the fresh range (their lens ride ``pending`` like any unrouted
    gid's).

    Global KV economy: when the caller passes the adopted
    mesh ``prefix_index`` ({rank: digest}) and votes carry per-gid
    chunk-hash ``chains``, the pick discounts each candidate by its
    published prefix coverage (:func:`sched.prefix_affinity_key` —
    hit length priced in the SAME chunk currency as the load terms,
    so a hot rank is not swamped by affinity). When the load vote
    still sends a request AWAY from its best published prefix by a
    page or more, the decision carries a ``migrate`` directive
    ``{gid: [src, dst]}`` — the owning rank replicates the hot chain
    to where the request will actually prefill. Pure policy: only the
    leader computes this; every peer ADOPTS the published decision,
    so a stale or rank-skewed index costs performance, never
    divergence.

    Membership fix: a rank the member round
    agreed OUT is excluded from every pick set — even when a stale
    vote of its still sits on the board — instead of being priced as
    merely busy. Votes without a ``members`` key (an older sender) keep
    the old price-as-busy behavior for missing voters.
    """
    members: Optional[set] = None
    for v in votes.values():
        m = v.get("members")
        if m is None:
            continue
        m = {int(r) for r in m}
        members = m if members is None else (members & m)
    if members:
        # an agreed-out rank's stale vote must not shape the round
        # either: casting a vote proves liveness, but a lingering
        # board file from before the eviction proves nothing
        live = {r: v for r, v in votes.items() if r in members}
        if live:
            votes = live
    topo = votes[min(votes)]["topology"]
    prefill = list(topo["prefill"])
    decode = list(topo["decode"])
    threshold = int(topo["threshold"])
    routed = max(int(v["routed"]) for v in votes.values())
    upto = min(int(v["seen"]) for v in votes.values())
    lens: Dict[int, int] = {}
    chains: Dict[int, List[str]] = {}
    for r in sorted(votes):
        for g, ln in votes[r]["pending"].items():
            lens[int(g)] = int(ln)
        for g, c in (votes[r].get("chains") or {}).items():
            chains.setdefault(int(g), [str(h) for h in c])

    # keyed by the TOPOLOGY's ranks, not the voters': a dead peer's
    # vote is missing but its rank is still routable (ttfc_key prices
    # it as busy — indexing it must not crash the leader) — UNLESS
    # the member round agreed it out
    if members is not None:
        prefill = [r for r in prefill if r in members]
        decode = [r for r in decode if r in members]
    ranks_all = set(prefill) | set(decode)
    extra_tokens = {r: 0 for r in ranks_all}
    extra_reqs = {r: 0 for r in ranks_all}

    def hits_for(gid):
        chain = chains.get(gid)
        if prefix_index is None or not chain:
            return None
        out = {}
        for r in ranks_all:
            dig = prefix_index.get(str(r)) or prefix_index.get(r)
            if dig:
                out[r] = _chain_hit_tokens(chain, dig)
        return out or None

    def pick(ranks, hits=None):
        if hits:
            return min(ranks, key=lambda r: prefix_affinity_key(
                votes, r, extra_tokens, extra_reqs, hits.get(r, 0)))
        return min(ranks, key=lambda r: ttfc_key(
            votes, r, extra_tokens, extra_reqs))

    def place(gid, plen, assign, migrate):
        if not decode:
            return False            # no routable decode rank: park
        hits = hits_for(gid)
        d = pick(decode, hits)
        extra_reqs[d] += 1
        p = -1
        if prefill and plen >= threshold:
            p = pick(prefill, hits)
            extra_reqs[p] += 1
            extra_tokens[p] += plen   # the chunk train runs HERE
        else:
            extra_tokens[d] += plen   # short prompts prefill where
        assign[str(gid)] = [p, d]     # they decode
        if hits:
            # the prefix pays off on the rank that RUNS the prefill;
            # when load pushed the request a page or more away from
            # its best published chain, direct the owner to replicate
            # the chain to the runner (hot-chain migration)
            runner = p if p >= 0 else d
            best = max(hits, key=lambda r: (hits[r], -r))
            ps = int((votes.get(best) or votes[min(votes)])
                     .get("page_size", 16))
            if best != runner and \
                    hits[best] - hits.get(runner, 0) >= ps:
                migrate[str(gid)] = [int(best), int(runner)]
        return True

    assign: Dict[str, List[int]] = {}
    migrate: Dict[str, List[int]] = {}
    fresh = 0
    for gid in range(routed, upto):
        plen = lens.get(gid)
        if plen is None:            # no voter carried it: leave queued
            break
        if not place(gid, plen, assign, migrate):
            break
        fresh += 1
    requeue = sorted({int(g) for v in votes.values()
                      for g in v.get("requeue", [])}
                     - {int(g) for g in assign})
    for gid in requeue:
        plen = lens.get(gid)
        if plen is None:
            continue                # no voter carries it any more
        place(gid, plen, assign, migrate)
    out = {"assign": assign, "routed": routed + fresh}
    if migrate:
        out["migrate"] = migrate
    return out


def _clock_reducer(votes: Dict[int, dict]) -> dict:
    """The ``clock`` round's reducer: every rank's (offset, unc) vote,
    gathered into one table keyed by rank — pure and deterministic
    (votes arrive rank-sorted). The reference rank is taken from the
    lowest voter (every vote carries the same ``ref`` by
    construction)."""
    ref = int(votes[min(votes)].get("ref", 0))
    return {"ref": ref,
            "offsets": {str(r): {"offset_s": v.get("offset_s"),
                                 "unc_s": v.get("unc_s")}
                        for r, v in sorted(votes.items())}}


def _member_reducer(votes: Dict[int, dict]) -> dict:
    """The ``member`` round's reducer: one agreed member
    set from the voters' views. Pure and deterministic:

    - the member table is the UNION of the voters' tables (iterated
      rank-sorted, first writer wins on role), plus every voter's own
      announcement (``me``/``role``) — that is how a joiner enters;
    - the dead set is the union of the voters' observations MINUS the
      voters themselves (casting a vote is proof of life — a rank can
      never be voted out of a round it is participating in), and dead
      ranks leave the member table;
    - ``routed`` is the MAX of the voters' admission high-water marks:
      the sync point a joiner adopts so it never re-routes work the
      mesh assigned before it arrived.
    """
    members: Dict[int, str] = {}
    for r in sorted(votes):
        v = votes[r]
        for k, role in sorted((v.get("members") or {}).items(),
                              key=lambda kv: int(kv[0])):
            members.setdefault(int(k), str(role))
        me = v.get("me")
        if me is not None:
            members.setdefault(int(me), str(v.get("role", "decode")))
    dead = set()
    for v in votes.values():
        dead.update(int(d) for d in v.get("dead", []))
    dead -= set(votes)
    for d in sorted(dead):
        members.pop(d, None)
    routed = max([int(v.get("routed", 0)) for v in votes.values()]
                 or [0])
    return {"members": {str(r): members[r] for r in sorted(members)},
            "dead": sorted(dead), "routed": routed}


def _prefix_reducer(votes: Dict[int, dict]) -> dict:
    """The ``prefix`` round's reducer: the mesh prefix
    index is simply every voter's digest keyed by rank — pure,
    deterministic (votes arrive rank-sorted), and tiny: chunk-hash
    chains with token lengths, NEVER page bytes or token ids. Adoption
    MERGES per rank across rounds (a round's voters may be a subset),
    and membership changes prune dead ranks' entries."""
    return {"index": {str(r): (v.get("digest") or {})
                      for r, v in sorted(votes.items())}}


@dataclass
class _GlobalReq:
    gid: int
    prompt: np.ndarray
    max_new: int
    submit_w: float                  # wall clock (disttrace.walltime)
    trace: str = ""                  # deterministic cross-host trace id
    prefill_rank: int = -1
    decode_rank: int = -1
    routed: bool = False
    ttft_ms: Optional[float] = None
    #: ± clock-alignment uncertainty on ttft_ms — present exactly when
    #: ttft_ms is a CROSS-host delta corrected by a synced offset pair
    #: (same-host pairs have no cross-clock term; an unsynced mesh
    #: reports the delta with unc None = unbounded, never a fake 0)
    ttft_unc_ms: Optional[float] = None
    out: Optional[np.ndarray] = None
    meta: dict = field(default_factory=dict)


class DisaggServer:
    """One rank's serving coordinator on the mesh (module docstring).

    Driver contract: every rank constructs the same server over the
    same shared directory and calls ``submit`` with the SAME request
    stream in the same order; ``step()`` is the scheduler heartbeat
    (admission votes, exports, imports, one engine step); ``run()``
    drives until the mesh agrees the stream is fully served.

    ::

        mesh = MeshSpec(rank, world, prefill_ranks=(0,))
        srv = DisaggServer(model, cfg, mesh, shared_dir)
        for p in prompts:                 # identical on every rank
            srv.submit(p, max_new)
        srv.run()
        srv.results()                     # {gid: ids decoded HERE}
    """

    def __init__(self, model, config: ServingConfig, mesh: MeshSpec,
                 shared_dir: str, *,
                 long_prompt_threshold: Optional[int] = None,
                 consensus: Optional[Consensus] = None,
                 lease_s: float = 5.0,
                 dead_after_s: Optional[float] = None,
                 join: bool = False,
                 clock_skew_s: Optional[float] = None,
                 clock_resync_s: float = 0.0,
                 prefix_routing: bool = False,
                 prefix_publish_s: float = 0.5):
        self.mesh = mesh
        self.engine = ServingEngine(model, config)
        self.consensus = consensus if consensus is not None else \
            Consensus(os.path.join(shared_dir, "board"), mesh.rank,
                      mesh.world, lease_s=lease_s)
        self.channel = HandoffChannel(
            os.path.join(shared_dir, "handoff"), mesh.rank)
        self.shared_dir = shared_dir
        #: prompts >= this many tokens route through the prefill group
        #: (default: one prefill chunk — anything longer would occupy
        #: multiple mixed ticks on a decode rank)
        self.long_prompt_threshold = (
            int(long_prompt_threshold) if long_prompt_threshold
            else self.engine.prefill_chunk + 1)
        self._reqs: Dict[int, _GlobalReq] = {}
        self._next_gid = 0
        self._routed_hwm = 0
        #: published assignments, kept keyed by gid: an assignment can
        #: ARRIVE before this rank's driver submitted the gid (a rank
        #: whose vote missed the window still gets routed to) — it is
        #: applied at submit() time instead of being dropped
        self._assignments: Dict[int, Tuple[int, int]] = {}
        self._served_total = 0
        self._voted_admit = False
        self._voted_done = False
        self._local: Dict[int, int] = {}      # local rid -> gid
        self._collected: set = set()
        self._pending_imports: List[Tuple[int, dict]] = []
        self.handoffs_sent = 0
        self.handoffs_recv = 0
        self._done_verdict: Optional[bool] = None
        self._done_open_t = 0.0
        # -- elastic membership ------------------------------
        #: the agreed member set {rank: "prefill"|"decode"} — routing
        #: topology, done ledgers, and death observation all follow
        #: THIS, not the static MeshSpec. A joiner starts knowing only
        #: itself (the member round teaches it the rest); everyone
        #: else seeds from the spec.
        my_role = "prefill" if mesh.is_prefill else "decode"
        if join:
            self._members: Dict[int, str] = {mesh.rank: my_role}
        else:
            self._members = {
                r: ("prefill" if r in mesh.prefill_ranks
                    else "decode")
                for r in range(mesh.world)}
        #: a member is DECLARED dead when its consensus lease is stale
        #: past this — 2 leases by default, the same double-evidence
        #: margin a live observer demands before flagging
        self.dead_after_s = (2.0 * lease_s if dead_after_s is None
                             else float(dead_after_s))
        #: False until the member round admits this rank: a joiner
        #: adopts the agreed routing high-water mark BEFORE it may
        #: influence routing, so it can never re-route assigned work
        self._joined = not join
        self._voted_member = False
        self._member_open_t = 0.0
        self._member_epoch = -1
        self._dead: set = set()
        #: gids orphaned by a death, waiting for re-routing — they ride
        #: the admission vote's ``requeue`` list until an assignment
        #: for them publishes
        self._requeued: set = set()
        #: per-gid handoff ledgers + void counters: the done round
        #: balances ``sent - void_sent == recv - void_recv``, so a
        #: handoff whose peer died REBALANCES instead of wedging the
        #: mesh (the monotonic sent/recv counters survive for reports)
        self._sent_log: Dict[int, int] = {}
        self._recv_log: Dict[int, int] = {}
        self.handoffs_void_sent = 0
        self.handoffs_void_recv = 0
        #: gids whose KV payload this rank claimed off a corpse: their
        #: import counts void (the sender's ledger entry was voided
        #: with the sender)
        self._scavenged: set = set()
        # -- cross-host tracing ------------------------------
        #: injected test skew applied to EVERY wall stamp this server
        #: makes (submit/export/import) AND to its clock-sync samples —
        #: one consistent wrong clock, exactly what a skewed host is.
        #: NOTE: the explicit ``clock_skew_s`` parameter skews only
        #: THIS server (in-process multi-server protocol tests, where
        #: a per-process sink could not represent two logical clocks
        #: anyway); a run whose per-rank sinks will be MERGED must
        #: inject skew via PADDLE_CLOCK_SKEW instead, which also
        #: reaches the sink's wall-clock anchor (disttrace.walltime)
        self._skew_s = _disttrace.local_skew_s(mesh.rank) \
            if clock_skew_s is None else float(clock_skew_s)
        self.clock = _disttrace.ClockSync(
            os.path.join(shared_dir, "clock"), mesh.rank, mesh.world,
            skew_s=self._skew_s)
        self._clock_voted = False
        #: the agreed offset table {str(rank): {offset_s, unc_s}}, or
        #: None until the ``clock`` consensus round publishes
        self._clock_table: Optional[Dict[str, dict]] = None
        #: periodic clock re-sync: every ``clock_resync_s``
        #: seconds after adoption, re-run the Cristian exchange on the
        #: heartbeat; when the fresh offset moved by MORE than its
        #: uncertainty, adopt it locally and re-vote the consensus
        #: ``clock`` round (a new epoch peers join via ``pending``, the
        #: straggler-heal machinery). 0 = one-shot sync (the older
        #: behavior); the reference rank never resamples (its offset
        #: is 0 by definition) but keeps serving pongs either way.
        self.clock_resync_s = float(clock_resync_s)
        self._resyncing = False
        self._resync_at = float("inf")
        #: per-gid handoff trace context of IMPORTED requests:
        #: {gid: (ctx dict from the payload, import wall stamp)}
        self._handoff_ctx: Dict[int, Tuple[dict, float]] = {}
        # -- global KV economy -------------------------------
        #: publish local prefix digests + route on the mesh index +
        #: replicate hot chains; forced off without a prefix cache
        #: (nothing to publish). Pure host-side policy either way.
        self.prefix_routing = bool(prefix_routing) and \
            self.engine.pool.prefix is not None
        self.prefix_publish_s = float(prefix_publish_s)
        #: the adopted mesh prefix index {str(rank): digest}, merged
        #: across rounds, pruned on membership change
        self._prefix_index: Dict[str, dict] = {}
        self._voted_prefix = False
        self._prefix_open_t = 0.0
        self._published_rev = -1          # trie rev at last vote
        self._published_chains: set = set()
        self._withdrawals_due = 0         # dirty: publish immediately
        #: migration directives adopted from routing decisions where
        #: THIS rank is the chain owner: {gid: dst rank}
        self._migrate_out: Dict[int, int] = {}
        #: (dst, chain tail hash) already shipped — the same hot chain
        #: is not re-sent every round the index lags
        self._migrated_sent: set = set()
        self.prefix_migrations_out = 0
        self.prefix_migrations_in = 0
        self.prefix_migration_bytes_out = 0
        self.prefix_migration_bytes_in = 0
        self.stale_digest_withdrawals = 0
        if self.prefix_routing:
            # withdraw-before-reclaim: the hook
            # runs while the index still holds the page's refcount
            self.engine.pool.prefix.on_drop = self._on_prefix_drop
        # lease upkeep on a daemon thread: a rank COMPILING its first
        # tick (tens of seconds on a small box) is alive, and its lease
        # must say so or a fast peer transiently "survives" it and
        # decides rounds alone (Consensus.start_heartbeat docstring).
        self.consensus.start_heartbeat()
        if join:
            self._catch_up()

    def close(self) -> None:
        self.consensus.stop_heartbeat()

    def __enter__(self) -> "DisaggServer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- submission (identical stream on every rank) -----------------------
    def submit(self, prompt_ids, max_new_tokens: int) -> int:
        p = np.asarray(prompt_ids, np.int32).reshape(-1)
        gid = self._next_gid
        self._next_gid += 1
        self._reqs[gid] = _GlobalReq(gid, p, int(max_new_tokens),
                                     self._walltime(),
                                     trace=_disttrace.trace_id(gid))
        # an open-ended driver (Poisson arrivals) may submit AFTER an
        # idle period already voted the mesh done — new work reopens
        # the question (the next done round sees served < seen)
        self._done_verdict = None
        if gid in self._assignments:
            # the mesh routed this gid before our driver submitted it
            # (our admission vote missed a round's window): apply the
            # published assignment now instead of orphaning it
            self._apply_assignment(gid)
        return gid

    # -- clock alignment ----------------------------------------
    def _walltime(self) -> float:
        return _disttrace.walltime(self._skew_s)

    def _clock_round(self) -> None:
        """Non-blocking Cristian sync + consensus rounds: pump the
        ping exchange until this rank's estimate is ready, vote it
        (family ``clock``), adopt the published mesh-wide offset
        table. The reference rank keeps serving pongs forever (a
        cheap listdir on the heartbeat) so late peers can still
        sample. A rank the vote window expired OUT of the published
        table keeps sampling, self-heals its own entry the moment its
        estimate lands (its local stamps must not stay uncorrected),
        and re-votes — opening the NEXT clock epoch, which every peer
        joins via ``pending`` so the straggler's offset reaches the
        whole mesh; tables merge across epochs."""
        cons = self.consensus
        me = str(self.mesh.rank)
        healed = self._clock_table is not None and \
            me in self._clock_table
        if self.mesh.rank == self.clock.ref or not healed or \
                self._resyncing:
            self.clock.step()
        self._resync_round(me)
        if self._clock_table is not None and not healed and \
                self.clock.ready and not self._clock_voted:
            # window-expired straggler: heal locally NOW (peers may
            # already be draining), then gossip via the next epoch
            self._heal_local(self.clock.estimate())
            self._vote_clock()
        if self._clock_table is None:
            self._vote_clock()
        if self._clock_voted or cons.pending("clock"):
            # a pending round a peer opened (first sync OR a healed
            # straggler's re-round) is joined with our best estimate
            self._vote_clock()
            dec = cons.outcome("clock", reducer=_clock_reducer)
            if dec is not None:
                self._clock_voted = False
                self._adopt_clock(dec.value)

    def _heal_local(self, est: Tuple[float, float]) -> None:
        """Adopt a fresh LOCAL estimate into the table + the
        process clock state + the sink/event surfaces and re-derive
        collected TTFTs — the shared step of the straggler-heal and
        periodic-resync paths (a change to one must not silently miss
        the other; the caller follows with its own vote logic)."""
        self._clock_table[str(self.mesh.rank)] = {
            "offset_s": est[0], "unc_s": est[1]}
        _disttrace.set_clock_state(est[0], est[1], ref=self.clock.ref)
        _registry().gauge("consensus/clock_unc_ms").set(est[1] * 1e3)
        _pevents.emit("clock_sync", offset_s=est[0], unc_s=est[1],
                      ref=self.clock.ref)
        self._refresh_ttfts()

    def _resync_round(self, me: str) -> None:
        """Periodic drift tracking: once the resync
        interval elapses, restart the ping exchange
        (``ClockSync.resync``) and pump it on the heartbeat; when the
        fresh estimate lands, compare it to the adopted entry — an
        offset that moved by MORE than the SUM of the two
        uncertainties is a real drift/step (two estimates each within
        ±unc of the truth can legitimately differ by up to
        unc_old + unc_new, so anything inside the summed bound is
        indistinguishable from measurement noise and must not churn
        epochs), so adopt it locally right away (our own stamps must
        not stay wrong while the round converges) and re-vote the
        ``clock`` family, opening a new epoch every peer joins via
        ``pending`` and adopts MERGED (the straggler-heal path's
        machinery, reused)."""
        if self.clock_resync_s <= 0 or self.mesh.rank == self.clock.ref:
            return
        if not self._resyncing:
            if self._clock_table is not None and me in \
                    self._clock_table and \
                    time.monotonic() >= self._resync_at:
                self.clock.resync()
                self._resyncing = True
            return
        if not self.clock.ready:
            return                    # still resampling
        self._resyncing = False
        self._resync_at = time.monotonic() + self.clock_resync_s
        est = self.clock.estimate()
        old = (self._clock_table or {}).get(me) or {}
        old_off = old.get("offset_s")
        bound = est[1] + float(old.get("unc_s") or 0.0)
        if old_off is not None and abs(est[0] - old_off) <= bound:
            return                    # within the stated uncertainty
        _registry().counter("consensus/clock_resyncs").add(1)
        self._heal_local(est)
        self._clock_voted = False
        self._vote_clock()

    def _vote_clock(self) -> None:
        """Cast this rank's clock vote in the current epoch, once,
        when its estimate exists (no-op otherwise)."""
        if self._clock_voted or not self.clock.ready:
            return
        est = self.clock.estimate()
        self.consensus.vote("clock", {"offset_s": est[0],
                                      "unc_s": est[1],
                                      "ref": self.clock.ref})
        self._clock_voted = True

    def _adopt_clock(self, value: dict) -> None:
        # MERGE across epochs: a straggler's re-round carries only
        # that epoch's voters — it must extend the table, not erase
        # the first round's entries
        table = dict(self._clock_table or {})
        table.update(value.get("offsets") or {})
        me = str(self.mesh.rank)
        if me not in table and self.clock.ready:
            # published without our vote (window expiry): our local
            # estimate still anchors our OWN sink metadata honestly
            est = self.clock.estimate()
            if est is not None:
                table[me] = {"offset_s": est[0], "unc_s": est[1]}
        self._clock_table = table
        mine = table.get(me)
        ref = int(value.get("ref", 0))
        off = None if mine is None else mine.get("offset_s")
        unc = None if mine is None else mine.get("unc_s")
        _disttrace.set_clock_state(off, unc, ref=ref,
                                   synced=mine is not None)
        if unc is not None:
            _registry().gauge("consensus/clock_unc_ms").set(unc * 1e3)
        _pevents.emit("clock_sync", offset_s=off, unc_s=unc, ref=ref)
        self._refresh_ttfts()
        if self.clock_resync_s > 0 and self._resync_at == float("inf"):
            # first adoption arms the periodic re-sync timer
            self._resync_at = time.monotonic() + self.clock_resync_s

    def _offset_of(self, rank: int) -> Tuple[float, Optional[float]]:
        """(offset_s, unc_s) of ``rank`` from the agreed table; an
        unsynced rank reads as offset 0 with unc None — uncorrected
        and explicitly unbounded, never silently exact."""
        e = (self._clock_table or {}).get(str(int(rank)))
        if e is None or e.get("offset_s") is None:
            return 0.0, None
        unc = e.get("unc_s")
        return float(e["offset_s"]), (None if unc is None
                                      else float(unc))

    # -- elastic membership -------------------------------------
    def _topology(self) -> dict:
        """Routing topology derived from the AGREED member set — a
        dead rank has left it, a joiner has entered it. Degenerate
        guard: a mesh whose every decode member died routes everything
        to the surviving ranks (they all decode) rather than crash the
        reducer on an empty pick set."""
        prefill = sorted(r for r, ro in self._members.items()
                         if ro == "prefill")
        decode = sorted(r for r, ro in self._members.items()
                        if ro == "decode")
        if not decode:
            prefill, decode = [], (sorted(self._members)
                                   or [self.mesh.rank])
        return {"prefill": prefill, "decode": decode,
                "threshold": self.long_prompt_threshold}

    def _observe_dead(self) -> List[int]:
        """Members whose consensus lease went stale past
        ``dead_after_s`` — the evidence a ``member`` round is opened
        on. The ABSENCE of a lease file is not death evidence (mesh
        bring-up); only a lease that existed and stopped refreshing
        is."""
        ages = lease_ages(self.consensus.dir)
        me = self.mesh.rank
        return sorted(r for r in self._members
                      if r != me and ages.get(r) is not None
                      and ages[r] >= self.dead_after_s)

    def _member_round(self) -> None:
        """Non-blocking membership agreement: a rank OPENS a
        ``member`` round when it observes a death or wants to join
        (rate-limited — death evidence persists until adopted);
        everyone else joins the pending round. Every vote carries the
        voter's member table, so the reduced union teaches a joiner
        the mesh and the mesh the joiner."""
        cons = self.consensus
        if self._voted_member:
            dec = cons.outcome("member", reducer=_member_reducer)
            if dec is not None:
                self._voted_member = False
                self._adopt_members(dec)
            return
        dead = self._observe_dead()
        want = bool(dead) or not self._joined
        now = time.monotonic()
        if cons.pending("member") or \
                (want and now - self._member_open_t > 0.5):
            cons.vote("member", {
                "members": {str(r): ro for r, ro in
                            sorted(self._members.items())},
                "me": self.mesh.rank,
                "role": ("prefill" if self.mesh.is_prefill
                         else "decode"),
                "dead": dead,
                "routed": self._routed_hwm,
            })
            self._voted_member = True
            self._member_open_t = now

    def _adopt_members(self, dec) -> None:
        value = dec.value
        new = {int(r): str(ro)
               for r, ro in (value.get("members") or {}).items()}
        dead = [int(d) for d in value.get("dead", [])]
        old = dict(self._members)
        self._members = new
        self._member_epoch = int(dec.epoch)
        me = self.mesh.rank
        _registry().gauge("serving/mesh_members").set(float(len(new)))
        if new and me == min(new):
            # one membership event per transition MESH-wide (the
            # route-event idiom): the lowest surviving member announces
            for r in sorted(set(new) - set(old)):
                _registry().counter("serving/member_joins").add(1)
                _pevents.emit("member_join", member=int(r),
                              role=new[r], epoch=int(dec.epoch))
            for r in sorted(r for r in dead if r in old):
                _registry().counter("serving/member_leaves").add(1)
                _pevents.emit("member_leave", member=int(r),
                              role=old.get(r, "decode"),
                              epoch=int(dec.epoch),
                              reason="lease_expired")
        if me in new and not self._joined:
            # admitted: adopt the agreed routing high-water mark so a
            # joiner can never re-route work assigned before it came
            self._joined = True
            self._routed_hwm = max(self._routed_hwm,
                                   int(value.get("routed", 0)))
        # the mesh prefix index follows membership: an
        # agreed-out rank's published chains must stop attracting
        # routing the moment the eviction adopts
        self._prune_prefix_index()
        if me not in new and self._joined:
            self._on_evicted()
            return
        newly_dead = sorted(r for r in dead if r in old and r != me)
        if newly_dead:
            self._dead.update(newly_dead)
            self._rebalance_ledgers(newly_dead)
            self._redispatch_orphans(newly_dead)
            self._done_verdict = None

    def _rebalance_ledgers(self, newly_dead: List[int]) -> None:
        """VOID every handoff ledger entry whose peer died: the
        corpse's side of the count will never be voted again, so the
        surviving side must not wedge ``_done_reducer``'s
        sent/recv balance forever (the monotonic ``handoffs_sent`` /
        ``handoffs_recv`` counters are untouched: reports read them)."""
        dead = set(newly_dead)
        for gid, dst in list(self._sent_log.items()):
            if dst in dead:
                del self._sent_log[gid]
                self.handoffs_void_sent += 1
        for gid, src in list(self._recv_log.items()):
            if src in dead:
                del self._recv_log[gid]
                self.handoffs_void_recv += 1

    def _redispatch_orphans(self, newly_dead: List[int]) -> None:
        """Reconstruct and re-dispatch every request orphaned by the
        dead ranks, from records every survivor already holds: the
        prompt (SPMD driver contract), the published assignment, and
        the handoff ledgers/trace contexts.

        - assigned DECODE rank died: its (possibly in-flight) result
          is gone. If an exported-KV file addressed to it survives on
          the channel, a deterministic claimer — pure function of
          (member set, gid), so every survivor repoints the assignment
          identically without another round — renames it to itself and
          audits the payload (``HandoffChannel.scavenge``); otherwise
          the gid re-routes from scratch through the next admission
          round's ``requeue`` list. Re-prefill from the prompt is the
          honest fallback, never a guessed KV state.
        - assigned PREFILL rank died, decode owner alive: only the
          decode owner acts, locally. Work that already landed (or a
          complete file in flight — sends are atomic, a corpse leaves
          only ``.tmp``) is left alone; otherwise the owner re-runs
          the prefill itself.
        """
        me = self.mesh.rank
        dead = set(newly_dead)
        mine = set(self._local.values())
        pending = {g for g, _ in self._pending_imports}
        topo = self._topology()
        live_decode = [r for r in topo["decode"] if r not in dead]
        for gid in sorted(self._reqs):
            req = self._reqs[gid]
            if not req.routed or gid in self._collected:
                continue
            p, d = req.prefill_rank, req.decode_rank
            if d in dead:
                claimer = (live_decode[gid % len(live_decode)]
                           if live_decode else -1)
                has_file = claimer >= 0 and (
                    os.path.exists(self.channel._path_to(gid, d)) or
                    os.path.exists(self.channel._path_to(gid,
                                                         claimer)))
                if has_file:
                    claimed = True
                    if claimer == me:
                        claimed = self.channel.scavenge(gid, d)
                        if claimed:
                            self._scavenged.add(gid)
                            req.meta["redispatched"] = "scavenge"
                            req.meta["redispatch_w"] = \
                                self._walltime()
                            _registry().counter(
                                "serving/redispatches").add(1)
                            _pevents.emit(
                                "redispatch", gid=gid,
                                trace=req.trace, mode="scavenge",
                                dead_rank=int(d))
                    if claimed:
                        req.decode_rank = claimer
                        self._assignments[gid] = (p, claimer)
                        self._done_verdict = None
                        continue
                self._requeue_gid(gid, dead_rank=d)
            elif p in dead:
                if d != me:
                    continue
                if gid in mine or gid in pending or \
                        gid in self._handoff_ctx or \
                        gid in self._scavenged:
                    continue        # the handoff beat the death
                if os.path.exists(self.channel._path_to(gid, me)):
                    continue        # complete and in flight: poll()
                self._reprefill_local(gid, dead_rank=p)

    def _requeue_gid(self, gid: int, dead_rank: int) -> None:
        """Send an orphaned gid back through routing: tear down any
        local work under the dead assignment, mark it unrouted, and
        let the next admission round's ``requeue`` list re-place it
        (load-shaped like any fresh arrival)."""
        req = self._reqs[gid]
        for rid, g in list(self._local.items()):
            if g != gid:
                continue
            er = self.engine._requests.get(rid)
            if er is not None and not er.done:
                self.engine.cancel(rid)
            del self._local[rid]
        req.routed = False
        req.prefill_rank = -1
        req.decode_rank = -1
        self._assignments.pop(gid, None)
        self._requeued.add(gid)
        req.meta["redispatched"] = "requeue"
        req.meta.setdefault("redispatch_w", self._walltime())
        self._done_verdict = None
        me = self.mesh.rank
        if self._members and me == min(self._members):
            # one re-dispatch event per gid mesh-wide (every survivor
            # runs this symmetrically)
            _registry().counter("serving/redispatches").add(1)
            _pevents.emit("redispatch", gid=gid, trace=req.trace,
                          mode="requeue", dead_rank=int(dead_rank))

    def _reprefill_local(self, gid: int, *, mode: str = "reprefill",
                         dead_rank: int = -1) -> None:
        """Honest fallback: THIS rank re-runs the prefill from the
        prompt it holds and decodes locally — no routing round needed,
        the route already names this rank as the visible owner."""
        req = self._reqs.get(gid)
        if req is None or gid in self._collected:
            return
        req.meta["redispatched"] = mode
        req.meta["redispatch_w"] = self._walltime()
        lr = self.engine.submit(req.prompt, req.max_new,
                                trace_id=req.trace)
        self._local[lr] = gid
        req.prefill_rank = -1
        req.decode_rank = self.mesh.rank
        req.routed = True
        self._assignments[gid] = (-1, self.mesh.rank)
        self._done_verdict = None
        _registry().counter("serving/redispatches").add(1)
        _pevents.emit("redispatch", gid=gid, trace=req.trace,
                      mode=mode, dead_rank=int(dead_rank))

    def _on_evicted(self) -> None:
        """The mesh voted US out — a false-positive death (our lease
        went stale while we kept running: long GC, suspended VM).
        Survivors requeued everything assigned here, INCLUDING work we
        already served (they cannot see our collections), so the
        honest reaction is to become a joiner again: abandon in-flight
        work, retract collected results (they re-serve elsewhere — the
        at-least-once edge of the mesh's contract), zero our side
        of the handoff ledgers the way the survivors voided theirs,
        and re-announce through the member round."""
        self._joined = False
        for rid, gid in list(self._local.items()):
            er = self.engine._requests.get(rid)
            if er is not None and not er.done:
                self.engine.cancel(rid, reason="evicted")
            del self._local[rid]
        self._served_total -= len(self._collected)
        for gid in self._collected:
            req = self._reqs.get(gid)
            if req is not None:
                req.out = None
                req.ttft_ms = None
                req.ttft_unc_ms = None
        self._collected.clear()
        self.handoffs_void_sent = self.handoffs_sent
        self.handoffs_void_recv = self.handoffs_recv
        self._sent_log.clear()
        self._recv_log.clear()
        self._requeued.clear()
        self._migrate_out.clear()
        self._done_verdict = None
        _registry().counter("serving/self_evictions").add(1)

    def _catch_up(self) -> None:
        """Joiner bring-up: fast-forward every agreement family past
        pruned history (``Consensus.fast_forward``), then DRAIN the
        surviving decisions in order — assignments park (``submit``
        applies them when the driver replays the stream), the clock
        table and member set adopt, and stale ``done`` verdicts are
        discarded (a mesh that was idle-done before we joined must not
        make OUR ``run()`` return before we served anything)."""
        cons = self.consensus
        for fam in ("member", "clock", "admit", "done", "prefix"):
            cons.fast_forward(fam)
        while True:
            dec = cons.outcome("member", reducer=_member_reducer)
            if dec is None:
                break
            self._adopt_members(dec)
        while True:
            dec = cons.outcome("clock", reducer=_clock_reducer)
            if dec is None:
                break
            self._adopt_clock(dec.value)
        while True:
            dec = cons.outcome("prefix", reducer=_prefix_reducer)
            if dec is None:
                break
            if self.prefix_routing:
                self._adopt_prefix(dec.value)
        while True:
            dec = cons.outcome("admit", reducer=self._route_reducer)
            if dec is None:
                break
            self._adopt_assignment_decision(dec)
        while True:
            if cons.outcome("done", reducer=_done_reducer) is None:
                break
        self._done_verdict = None

    @property
    def members(self) -> Dict[int, str]:
        """The agreed member set {rank: role} as of
        ``_member_epoch``."""
        return dict(self._members)

    @property
    def redispatched(self) -> Dict[int, str]:
        """{gid: mode} of requests re-dispatched after a death as
        seen by THIS rank (mode in requeue|reprefill|scavenge) —
        reports and tests intersect this with ``results()`` for the
        re-served tail."""
        return {g: r.meta["redispatched"]
                for g, r in self._reqs.items()
                if "redispatched" in r.meta}

    # -- global KV economy --------------------------------------
    def _on_prefix_drop(self, chain_hash: str, n_tokens: int) -> None:
        """PrefixCache eviction hook, called BEFORE the page is handed
        back to the allocator: a chain this rank may have published is
        going away, so record the withdrawal NOW — the next prefix
        round publishes immediately (no rate-limit wait), and until it
        lands a peer routing on the stale digest merely mis-prices a
        pick (the lookup on arrival is an honest miss)."""
        if chain_hash in self._published_chains:
            self._withdrawals_due += 1
            self.stale_digest_withdrawals += 1
            _registry().counter(
                "serving/stale_digest_withdrawals").add(1)
            _pevents.emit("prefix_withdraw", chain=chain_hash,
                          tokens=int(n_tokens))

    def _prefix_round(self) -> None:
        """Non-blocking digest publication through the consensus board
        (family ``prefix``): vote this rank's current trie digest when
        it CHANGED since the last vote — rate-limited, except a
        withdrawal publishes immediately — or when a peer opened the
        round; adopt the merged mesh index when it publishes. Digests
        only: chunk-hash chains + token lengths ride the board, page
        bytes ride the handoff channel and only on an agreed migrate
        directive."""
        if not self.prefix_routing:
            return
        cons = self.consensus
        if self._voted_prefix:
            dec = cons.outcome("prefix", reducer=_prefix_reducer)
            if dec is not None:
                self._voted_prefix = False
                self._adopt_prefix(dec.value)
            return
        trie = self.engine.pool.prefix
        now = time.monotonic()
        changed = trie.rev != self._published_rev
        want = changed and (
            self._withdrawals_due > 0
            or now - self._prefix_open_t > self.prefix_publish_s)
        if cons.pending("prefix") or want:
            digest = trie.digest()
            cons.vote("prefix", {"digest": digest})
            self._voted_prefix = True
            self._prefix_open_t = now
            self._published_rev = trie.rev
            self._published_chains = set(digest["chains"])
            self._withdrawals_due = 0
            _pevents.emit("prefix_publish",
                          chains=len(digest["chains"]))

    def _adopt_prefix(self, value: dict) -> None:
        for r, dig in (value.get("index") or {}).items():
            self._prefix_index[str(r)] = dig
        self._prune_prefix_index()

    def _prune_prefix_index(self) -> None:
        """Membership prunes the mesh index: an agreed-out rank's
        digests must not attract routing (its pages are gone with
        it)."""
        keep = {str(r) for r in self._members}
        for r in [r for r in self._prefix_index if r not in keep]:
            del self._prefix_index[r]

    def _route_reducer(self, votes: Dict[int, dict]) -> dict:
        """The admission reducer actually registered on the board:
        :func:`route_requests` closed over this rank's adopted mesh
        prefix index. SPMD-safe even though the index is per-rank
        state: only the round's LEADER computes the reducer — every
        other rank adopts the published decision verbatim — so index
        staleness or skew costs placement quality, never stream
        divergence."""
        return route_requests(
            votes, prefix_index=(self._prefix_index
                                 if self.prefix_routing else None))

    def _export_migrations(self) -> None:
        """Execute adopted migrate directives owned by this rank:
        replicate the hot chain's raw pages (+ scales) to the rank the
        router placed the request on, over the handoff channel's
        ``m`` family. The chain may have been evicted since the
        decision — the honest outcome is a skipped send, never a
        guessed payload."""
        if not self._migrate_out:
            return
        ps = self.engine.pool.page_size
        for gid, dst in sorted(self._migrate_out.items()):
            req = self._reqs.get(gid)
            if req is None:
                continue          # driver not caught up: retry later
            del self._migrate_out[gid]
            if dst not in self._members or dst in self._dead:
                continue
            payload = self.engine.export_prefix_chain(req.prompt)
            if payload is None:
                continue          # evicted since published: honest miss
            n_tok = int(payload["n_tokens"])
            tail = chain_hashes(req.prompt[:n_tok], ps)[-1]
            if (dst, tail) in self._migrated_sent:
                continue
            self._migrated_sent.add((dst, tail))
            nbytes = self.channel.send(dst, gid, payload, kind="m")
            self.prefix_migrations_out += 1
            self.prefix_migration_bytes_out += nbytes
            reg = _registry()
            reg.counter("serving/prefix_migrations_out").add(1)
            reg.counter("serving/prefix_migration_bytes_out") \
                .add(nbytes)
            _pevents.emit("prefix_migrate_out", gid=int(gid),
                          dst=int(dst), tokens=n_tok, bytes=nbytes,
                          kv_dtype=str(payload["kv_dtype"]))

    def _import_migrations(self) -> None:
        """Consume migrated chains addressed to this rank and insert
        them into the local trie under the normal refcount rules
        (``ServingEngine.import_prefix_chain``); the next prefix round
        republishes the grown digest, so followers of the same tenant
        route here and hit REMOTELY-prefilled pages."""
        if not self.prefix_routing:
            return
        for gid, payload in self.channel.poll(kind="m"):
            try:
                tokens = self.engine.import_prefix_chain(payload)
            except ValueError:
                _registry().counter(
                    "serving/prefix_migration_rejected").add(1)
                continue
            if not tokens:
                # pool full or nothing new: dropped. Counted — a mesh
                # whose every migration lands in a full pool is a
                # sizing problem the operator must be able to SEE.
                _registry().counter(
                    "serving/prefix_migration_dropped").add(1)
                continue
            nbytes = sum(np.asarray(payload[k]).nbytes
                         for k in ("k", "v", "k_scale", "v_scale")
                         if k in payload)
            self.prefix_migrations_in += 1
            self.prefix_migration_bytes_in += nbytes
            reg = _registry()
            reg.counter("serving/prefix_migrations_in").add(1)
            reg.counter("serving/prefix_migration_bytes_in").add(nbytes)
            _pevents.emit("prefix_migrate_in", gid=int(gid),
                          tokens=int(tokens), bytes=nbytes,
                          kv_dtype=str(payload.get("kv_dtype")))

    # -- scheduling --------------------------------------------------------
    def _unrouted(self) -> List[int]:
        # requeued gids (orphans of a death, below the high-water
        # mark) need routing exactly like never-routed ones
        return sorted(set(range(self._routed_hwm, self._next_gid))
                      | self._requeued)

    def _admission_round(self) -> None:
        """Non-blocking consensus admission: vote when there is
        anything to route (or a peer opened the round), adopt the
        assignment when it publishes."""
        cons = self.consensus
        unrouted = self._unrouted()
        if not unrouted and not cons.pending("admit"):
            return
        if not self._voted_admit:
            eng = self.engine
            free_slots = sum(r is None for r in eng._slot_rid)
            # load-shaped vote: queued-prefill-token
            # backlog (every token a new arrival's first chunk waits
            # behind — queued prompts in full, residents' remaining
            # prefill) and the rank's rolling p95 TTFT, next to the
            # free-capacity counts the old reducer used alone
            backlog = sum(int(r.prompt.shape[0]) for r in eng._queue)
            for s, rid in enumerate(eng._slot_rid):
                if rid is not None:
                    backlog += max(0, int(eng._slot_prompt[s])
                                   - int(eng._slot_len[s]))
            # rolling p95 from the scheduler's bounded finish window
            # (O(64) — walking the profiler event ring here would put
            # an O(ring) scan on every admission round)
            p95 = eng._sched.ttft_p95()
            vote = {
                "seen": self._next_gid,
                "routed": self._routed_hwm,
                "pending": {str(g): int(self._reqs[g].prompt.shape[0])
                            for g in unrouted},
                "requeue": sorted(self._requeued),
                "free_pages": int(eng.pool.allocator.num_free),
                "free_slots": int(free_slots),
                "queued": int(len(eng._queue)) + len(eng._held_ready),
                "prefill_backlog": int(backlog),
                "ttft_p95_ms": round(float(p95), 3),
                "chunk": int(eng.prefill_chunk),
                "page_size": int(eng.pool.page_size),
                # topology follows the AGREED member set, not the
                # static MeshSpec: a dead rank left it, a
                # joiner entered it
                "topology": self._topology(),
                # the agreed member set rides every admission vote
                #: an agreed-out rank's stale
                # vote or topology row is EXCLUDED by the reducer,
                # not priced as busy
                "members": sorted(self._members),
            }
            if self.prefix_routing:
                # per-gid chunk-hash chains (capped — the affinity
                # term saturates long before 32 pages) so the leader
                # can price published-prefix coverage per candidate
                ch = {}
                for g in unrouted:
                    c = chain_hashes(self._reqs[g].prompt,
                                     eng.pool.page_size)[:32]
                    if c:
                        ch[str(g)] = c
                if ch:
                    vote["chains"] = ch
            cons.vote("admit", vote)
            self._voted_admit = True
        dec = cons.outcome("admit", reducer=self._route_reducer)
        if dec is None:
            return
        self._voted_admit = False
        self._adopt_assignment_decision(dec)

    def _adopt_assignment_decision(self, dec) -> None:
        """Apply one published admission decision (the shared adoption
        step of the live round and the joiner's history catch-up)."""
        assign = dec.value["assign"]
        if assign:
            _registry().counter("consensus/requests_routed") \
                .add(len(assign))
        me = self.mesh.rank
        for g_str, (p_rank, d_rank) in sorted(assign.items(),
                                              key=lambda kv: int(kv[0])):
            gid = int(g_str)
            p_rank, d_rank = int(p_rank), int(d_rank)
            prev = self._assignments.get(gid)
            self._assignments[gid] = (p_rank, d_rank)
            self._requeued.discard(gid)
            if prev is not None and prev != (p_rank, d_rank) and \
                    gid in self._reqs and gid not in self._collected:
                # a re-dispatch OVERWROTE a stale claim (e.g. a failed
                # scavenge audit re-routed a gid the mesh had
                # repointed at the claimer): tear down local work
                # under the old assignment, re-apply under the new
                req = self._reqs[gid]
                for rid, g in list(self._local.items()):
                    if g == gid:
                        er = self.engine._requests.get(rid)
                        if er is not None and not er.done:
                            self.engine.cancel(rid)
                        del self._local[rid]
                req.routed = False
                req.prefill_rank = -1
                req.decode_rank = -1
            if d_rank == me:
                # the routing decision, as an event on the rank that
                # will OWN the visible result (one event per request
                # mesh-wide, not one per rank)
                _pevents.emit("route", gid=gid,
                              trace=_disttrace.trace_id(gid),
                              prefill=p_rank, decode=d_rank)
            if gid in self._reqs:
                self._apply_assignment(gid)
            # else: routed before our driver submitted it — submit()
            # applies the parked assignment when the gid arrives
        for g_str, sd in (dec.value.get("migrate") or {}).items():
            src, dst = int(sd[0]), int(sd[1])
            if src == me and dst != me:
                # this rank owns the hot chain: replicate it to where
                # the request will actually prefill (_export_migrations
                # runs it on the heartbeat — the prompt is known here
                # by the SPMD driver contract, so the chain is
                # recoverable from the trie even though the directive
                # carries only ranks)
                self._migrate_out.setdefault(int(g_str), dst)
        self._routed_hwm = max(self._routed_hwm,
                               int(dec.value["routed"]))

    def _apply_assignment(self, gid: int) -> None:
        req = self._reqs[gid]
        if req.routed:
            return
        req.prefill_rank, req.decode_rank = self._assignments[gid]
        req.routed = True
        me = self.mesh.rank
        if req.prefill_rank == me:
            lr = self.engine.submit(req.prompt, req.max_new,
                                    hold_after_prefill=True,
                                    trace_id=req.trace)
            self._local[lr] = gid
        elif req.decode_rank == me and req.prefill_rank < 0:
            lr = self.engine.submit(req.prompt, req.max_new,
                                    trace_id=req.trace)
            self._local[lr] = gid
        else:
            return
        if "redispatched" in req.meta:
            # the re-dispatch clock restarts at the actual re-submit:
            # TTFT accounting charges the user wait from the ORIGINAL
            # submit up to here, then the engine pair takes over
            # (same-host wall stamps — no clock correction involved)
            req.meta["redispatch_w"] = self._walltime()

    def _export_held(self) -> None:
        eng = self.engine
        for rid in eng.held_ready():
            gid = self._local.get(rid)
            if gid is None:          # not ours to ship (can't happen)
                continue
            req = self._reqs[gid]
            payload = eng.export_held(rid)
            # the prefill-rank leg of the trace rides the payload: the
            # decode rank (and the offline merger) need the submit
            # wall stamp to report a TRUE end-to-end TTFT instead of
            # the old suppressed decode-side ~0 ms pair. The engine's
            # same-host prefill TTFT (submit -> first token on THIS
            # rank) travels too — it is a clean clock pair and bounds
            # the handoff breakdown from the left.
            er = eng._requests[rid]
            prefill_ttft = None
            if er.first_token_t is not None:
                prefill_ttft = (er.first_token_t - er.submit_t) * 1e3
                req.meta["prefill_ttft_ms"] = prefill_ttft
            payload["trace_ctx"] = json.dumps({
                "trace": req.trace, "gid": gid,
                "prefill_rank": self.mesh.rank,
                "submit_w": req.submit_w,
                "export_w": self._walltime(),
                "prefill_ttft_ms": prefill_ttft,
            })
            self.channel.send(req.decode_rank, gid, payload)
            eng.release_exported(rid)
            self.handoffs_sent += 1
            # per-gid ledger entry: voided if the receiver dies before
            # the mesh's done balance can count its recv
            self._sent_log[gid] = int(req.decode_rank)

    @staticmethod
    def _payload_src(payload: dict) -> Optional[int]:
        """Sender rank from the payload's trace context (None for a
        payload of an older sender without one)."""
        raw = payload.get("trace_ctx")
        if raw is None:
            return None
        try:
            return int(json.loads(str(raw)).get("prefill_rank", -1))
        except (ValueError, TypeError):
            return None

    def _note_recv(self, gid: int, payload: dict) -> None:
        """Recv-side ledger bookkeeping: a scavenged payload (or one
        whose sender the mesh already declared dead) counts VOID — the
        sender's side of the balance is gone with the sender."""
        self.handoffs_recv += 1
        if gid in self._scavenged:
            self._scavenged.discard(gid)
            self.handoffs_void_recv += 1
            return
        src = self._payload_src(payload)
        if src is None:
            return                    # legacy payload: unvoidable
        if src in self._dead:
            self.handoffs_void_recv += 1
        else:
            self._recv_log[gid] = src

    def _import_arrivals(self) -> None:
        self._pending_imports.extend(self.channel.poll())
        still: List[Tuple[int, dict]] = []
        for gid, payload in self._pending_imports:
            try:
                lr = self.engine.admit_prefilled(payload)
            except ValueError:
                # the engine's admission audit rejected the payload
                # (page count / dtype — e.g. a scavenged file from a
                # mismatched corpse): never a torn import into the
                # pool — drop it and re-prefill locally, the honest
                # fallback
                _registry().counter(
                    "serving/handoff_import_rejected").add(1)
                src = self._payload_src(payload)
                self._note_recv(gid, payload)
                self._reprefill_local(
                    gid, dead_rank=-1 if src is None else src)
                continue
            if lr is None:
                still.append((gid, payload))    # no slot/pages yet
                continue
            self._local[lr] = gid
            self._note_recv(gid, payload)
            # stamp the import wall moment + keep the payload's trace
            # context: together with the agreed clock offsets they make
            # the handed-off request's end-to-end TTFT computable HERE
            # (keyed by gid, not _reqs — the import can land before our
            # driver submitted the gid)
            raw = payload.get("trace_ctx")
            if raw is not None:
                try:
                    ctx = json.loads(str(raw))
                except ValueError:   # pragma: no cover - torn context
                    ctx = None
                if ctx is not None:
                    self._handoff_ctx[gid] = (ctx, self._walltime())
                    # the channel-wait histogram sample is recorded in
                    # _stamp_e2e_ttft once the offsets are SYNCED — a
                    # histogram cannot retract a pre-adoption
                    # skew-corrupted observation the way ttft_ms can
                    # be re-derived
        self._pending_imports = still

    def _collect_finished(self) -> None:
        eng = self.engine
        # iterate OUR rid map, not the engine's whole request history:
        # the heartbeat must stay O(resident + uncollected), not
        # O(everything ever served)
        for rid, gid in list(self._local.items()):
            er = eng._requests.get(rid)
            if er is None or not er.done:
                continue
            if getattr(er, "canceled", False):
                del self._local[rid]    # re-dispatched away: no result
                continue
            if gid in self._collected:
                continue
            req = self._reqs[gid]
            if req.prefill_rank == self.mesh.rank and \
                    req.decode_rank != self.mesh.rank:
                continue            # done-by-export, not a result
            self._collected.add(gid)
            self._served_total += 1
            req.out = np.asarray(er.out, np.int32)
            # TTFT: a locally-served request keeps the
            # same-host engine clock pair; a handed-off one reports
            # the TRUE end-to-end delta — prefill-rank submit wall ->
            # this rank's import (its first-token moment), corrected
            # by the agreed clock offsets and carrying their summed
            # uncertainty. The old path suppressed the decode-side
            # pair entirely (first_token_t == submit_t at import — a
            # bogus ~0 ms) and left ttft_ms=None for every handed-off
            # request: the mesh's headline latency was unmeasurable by
            # construction.
            if req.ttft_ms is None and er.first_token_t is not None:
                if req.prefill_rank in (-1, self.mesh.rank):
                    req.ttft_ms = \
                        (er.first_token_t - er.submit_t) * 1e3
                    rw = req.meta.get("redispatch_w")
                    if rw is not None:
                        # a re-dispatched request's first token only
                        # exists because of the re-submit: the user
                        # waited from the ORIGINAL submit. Both wall
                        # stamps are this host's — no clock
                        # correction involved. (A handed-off requeue
                        # needs no term: its e2e path already anchors
                        # at the original submit_w from the ctx.)
                        req.ttft_ms += max(
                            0.0, (rw - req.submit_w) * 1e3)
                    # the mesh TTFT sketch of a live observer:
                    # the engine's own serving/ttft_ms is bogus-local
                    # for imported requests, so the coordinator owns
                    # an e2e histogram — one sample per gid, the same
                    # values write_results() reports
                    _registry().histogram(
                        "serving/e2e_ttft_ms").observe(req.ttft_ms)
                else:
                    self._stamp_e2e_ttft(req)
            req.meta["finish_w"] = self._walltime()

    def _stamp_e2e_ttft(self, req: _GlobalReq) -> None:
        """End-to-end TTFT of a request handed off TO this rank:
        (import wall - our offset) - (prefill-rank submit wall - its
        offset), in the reference rank's clock, ± the two offsets'
        summed uncertainty. A payload without a trace context (a
        older sender) leaves ttft_ms None — honestly absent,
        never the old bogus ~0 ms."""
        ctx, import_w = self._handoff_ctx.get(req.gid, (None, None))
        if ctx is None:
            return
        o_me, u_me = self._offset_of(self.mesh.rank)
        o_p, u_p = self._offset_of(int(ctx.get("prefill_rank", -1)))
        req.ttft_ms = ((import_w - o_me)
                       - (float(ctx["submit_w"]) - o_p)) * 1e3
        if u_me is not None and u_p is not None:
            first_stamp = req.ttft_unc_ms is None
            req.ttft_unc_ms = (u_me + u_p) * 1e3
            if first_stamp:
                # exactly one synced observation per handed-off
                # request (unc transitions None -> value once)
                _registry().histogram(
                    "serving/handoff_channel_wait_ms").observe(
                    ((import_w - o_me)
                     - (float(ctx["export_w"]) - o_p)) * 1e3)
                # same latch for the live plane's e2e TTFT sketch
                # of a live observer: only the offset-corrected value lands —
                # a sketch cannot retract a skew-corrupted sample the
                # way _refresh_ttfts re-derives ttft_ms
                _registry().histogram(
                    "serving/e2e_ttft_ms").observe(req.ttft_ms)

    def _refresh_ttfts(self) -> None:
        """Re-derive handed-off TTFTs from their retained trace
        contexts under the CURRENT offset table: a request collected
        while the clock round was still converging (the mesh's first
        steps are compile-heavy — imports can beat adoption) was
        stamped uncorrected with unc None; once the table exists, the
        corrected value with its bound replaces it. Idempotent; called
        on every read surface (ttfts/ttft_bounds/write_results) and at
        table adoption."""
        if self._clock_table is None:
            return
        for gid in self._handoff_ctx:
            req = self._reqs.get(gid)
            if req is not None and req.ttft_ms is not None \
                    and req.ttft_unc_ms is None:
                self._stamp_e2e_ttft(req)

    def step(self) -> bool:
        """One coordinator heartbeat. Returns whether the local engine
        dispatched device work (the driver's idle signal)."""
        self.consensus.heartbeat()
        self._clock_round()
        self._member_round()
        self._prefix_round()
        self._admission_round()
        self._export_migrations()
        self._import_arrivals()
        self._import_migrations()
        progressed = self.engine.step()
        if not progressed and self.engine._inflight:
            self.engine.drain(0)
        self._export_held()
        self._collect_finished()
        self._done_round()
        return progressed

    def _clock_settled(self) -> bool:
        """The clock round is adopted — or can never be: a dead
        reference rank answers no pings and leads no round, so waiting
        on it would hold the whole drain hostage (TTFTs then ship
        uncorrected with unc None, which is the honest degraded
        outcome, not a hang)."""
        return self._clock_table is not None or \
            self.clock.ref not in self.consensus.alive()

    def quiescent(self) -> bool:
        """Locally drained: nothing unrouted, engine idle, no parked
        imports, no unexported holds — and the clock round settled (a
        short workload must not declare the mesh done while offsets
        are still converging: collected TTFTs would ship uncorrected.
        The round terminates on any live mesh: every stepping rank
        votes, a dead non-reference rank is window-expired by the
        leader, and a dead REFERENCE releases the gate outright —
        see :meth:`_clock_settled`)."""
        eng = self.engine
        return (self._clock_settled()
                and not self._unrouted()
                and not self._pending_imports
                and not self._migrate_out
                and not eng._held_ready
                and not eng._queue and not eng._inflight
                and all(r is None for r in eng._slot_rid))

    def _done_round(self) -> None:
        """Non-blocking mesh-wide completion agreement: a ``done``
        vote round carries (idle, sent, recv, hwm) per rank; the mesh
        is done when every rank is idle with matching handoff ledgers.
        A QUIESCENT rank opens rounds (rate-limited); a BUSY rank joins
        any pending round immediately with ``idle=False`` — so no peer
        ever stalls on the vote window waiting for a rank that is
        simply working. Requires a healthy mesh: chaos tests drive
        ``step()`` + local quiescence instead (a corpse's ledger never
        balances — its unserved assignments are the documented
        residue)."""
        cons = self.consensus
        if self._voted_done:
            dec = cons.outcome("done", reducer=_done_reducer)
            if dec is not None:
                self._voted_done = False
                self._done_verdict = bool(dec.value)
            return
        q = self.quiescent()
        if cons.pending("done") or \
                (q and time.monotonic() - self._done_open_t > 0.2):
            cons.vote("done", {"idle": q,
                               "sent": self.handoffs_sent,
                               "recv": self.handoffs_recv,
                               "void_sent": self.handoffs_void_sent,
                               "void_recv": self.handoffs_void_recv,
                               "served": self._served_total,
                               "seen": self._next_gid,
                               "routed": self._routed_hwm})
            self._voted_done = True
            self._done_open_t = time.monotonic()

    def run(self, timeout_s: float = 600.0,
            poll_s: float = 0.005) -> Dict[int, np.ndarray]:
        """Drive until the mesh agrees the stream is served; returns
        the requests decoded on THIS rank ({gid: np.int32 ids})."""
        deadline = time.monotonic() + timeout_s
        while True:
            progressed = self.step()
            if self._done_verdict:
                break
            if not progressed:
                time.sleep(poll_s)      # waiting on arrivals or votes
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"disagg mesh did not drain: rank {self.mesh.rank} "
                    f"unrouted={len(self._unrouted())} "
                    f"requeued={len(self._requeued)} "
                    f"held={len(self.engine._held_ready)} "
                    f"imports={len(self._pending_imports)} "
                    f"members={sorted(self._members)} "
                    f"sent={self.handoffs_sent} recv={self.handoffs_recv} "
                    f"void={self.handoffs_void_sent}/"
                    f"{self.handoffs_void_recv}")
        return self.results()

    # -- results -----------------------------------------------------------
    def results(self) -> Dict[int, np.ndarray]:
        return {g: r.out for g, r in self._reqs.items()
                if r.out is not None}

    def reset_results(self) -> None:
        """Hand collected/forwarded requests back to the allocator: a
        long-running host must not grow ``_reqs``/``_local``/engine
        request history with every request ever served (the engine's
        ``reset_results`` idiom, lifted to the mesh level). Call after
        consuming ``results()``; mesh-wide done accounting survives
        (``_served_total`` is a monotonic counter, not a scan)."""
        drop_rids = []
        canceled_rids = []
        for rid, gid in self._local.items():
            er = self.engine._requests.get(rid)
            if er is None or not er.done:
                continue
            if getattr(er, "canceled", False):
                # re-dispatched away: free the rid, but KEEP the gid's
                # mesh state — it lives (or lived) somewhere else
                canceled_rids.append(rid)
                continue
            req = self._reqs.get(gid)
            exported = req is not None and \
                req.prefill_rank == self.mesh.rank and \
                req.decode_rank != self.mesh.rank
            if gid in self._collected or exported:
                drop_rids.append(rid)
        for rid in canceled_rids:
            self._local.pop(rid)
        for rid in drop_rids:
            gid = self._local.pop(rid)
            self._reqs.pop(gid, None)
            self._collected.discard(gid)
            self._handoff_ctx.pop(gid, None)
        self.engine.reset_results()

    def ttfts(self) -> Dict[int, float]:
        """{gid: ttft_ms} owned by the rank that served the request's
        visible result: a same-host clock pair for locally-served
        requests, the offset-corrected END-TO-END delta (prefill-rank
        submit -> this rank's first token) for handed-off ones — see
        :meth:`ttft_bounds` for the uncertainty that delta carries."""
        self._refresh_ttfts()
        return {g: r.ttft_ms for g, r in self._reqs.items()
                if r.ttft_ms is not None}

    def ttft_uncs(self) -> Dict[int, float]:
        """{gid: ± clock-uncertainty ms} for the TTFTs that are
        cross-host deltas (the handed-off requests this rank decoded);
        same-host pairs and unsynced deltas are absent."""
        self._refresh_ttfts()
        return {g: r.ttft_unc_ms for g, r in self._reqs.items()
                if r.ttft_unc_ms is not None}

    def ttft_bounds(self) -> Dict[int, Tuple[float, float, float]]:
        """{gid: (lo_ms, ttft_ms, hi_ms)} — the TTFT with its clock-
        alignment error bar. Same-host pairs have no cross-clock term
        (lo == ttft == hi); a cross-host delta widens by the two
        ranks' summed offset uncertainty; a cross-host delta measured
        WITHOUT a synced clock table is excluded (its bounds would be
        fiction)."""
        self._refresh_ttfts()
        out = {}
        for g, r in self._reqs.items():
            if r.ttft_ms is None:
                continue
            handed = r.prefill_rank not in (-1, self.mesh.rank) and \
                r.decode_rank == self.mesh.rank
            if not handed:
                out[g] = (r.ttft_ms, r.ttft_ms, r.ttft_ms)
            elif r.ttft_unc_ms is not None:
                out[g] = (r.ttft_ms - r.ttft_unc_ms, r.ttft_ms,
                          r.ttft_ms + r.ttft_unc_ms)
        return out

    def write_results(self, path: str) -> None:
        """Atomic per-rank results artifact (the test and benchmark drivers
        merge these instead of adding a gather collective)."""
        self._refresh_ttfts()
        doc = {
            "rank": self.mesh.rank,
            "results": {str(g): r.out.tolist()
                        for g, r in self._reqs.items()
                        if r.out is not None},
            "ttft_ms": {str(g): round(t, 3)
                        for g, t in self.ttfts().items()},
            "ttft_unc_ms": {str(g): round(u, 3)
                            for g, u in self.ttft_uncs().items()},
            "clock": _disttrace.clock_state(),
            "handoffs_sent": self.handoffs_sent,
            "handoffs_recv": self.handoffs_recv,
            "handoffs_void_sent": self.handoffs_void_sent,
            "handoffs_void_recv": self.handoffs_void_recv,
            "members": {str(r): ro
                        for r, ro in sorted(self._members.items())},
            "member_epoch": self._member_epoch,
            "redispatched": {str(g): m
                             for g, m in self.redispatched.items()},
        }
        if self.prefix_routing:
            reg = _registry()
            doc["prefix_economy"] = {
                "prefix_hit_tokens": int(reg.counter(
                    "serving/prefix_hit_tokens").value),
                "remote_hit_tokens": int(reg.counter(
                    "serving/prefix_hit_tokens_remote").value),
                "migrations_out": self.prefix_migrations_out,
                "migrations_in": self.prefix_migrations_in,
                "migration_bytes_out": self.prefix_migration_bytes_out,
                "migration_bytes_in": self.prefix_migration_bytes_in,
                "stale_withdrawals": self.stale_digest_withdrawals,
                "kv_dtype": self.engine._kv_name,
                "published_chains": len(self._published_chains),
            }
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)

    def check_consistency(self) -> List[str]:
        """The local pool-shard audit (multihost chaos tests run this
        on SURVIVORS after a peer died mid-handoff)."""
        return self.engine.pool.check_consistency()


def _done_reducer(votes: Dict[int, dict]) -> bool:
    """Done iff every voter is idle, the handoff ledgers balance, every
    rank has seen+routed the same stream, AND every routed request was
    actually served (each gid finishes on exactly one rank, so served
    counts sum to the stream length). The served term is what makes a
    round decided while one rank's vote is transiently missing come out
    False instead of declaring victory over its unserved work.

    Elastic rebalance: the balance nets out VOIDED
    handoffs — entries whose peer the mesh declared dead, whose side
    of the count will never be voted — so a death rebalances the
    ledgers instead of wedging them (``sent - void_sent ==
    recv - void_recv``; pre-elastic votes default the void terms to
    0). ``served == seen`` still holds because survivors re-dispatch
    and re-serve every orphaned gid."""
    idle = all(v["idle"] for v in votes.values())
    sent = sum(int(v["sent"]) - int(v.get("void_sent", 0))
               for v in votes.values())
    recv = sum(int(v["recv"]) - int(v.get("void_recv", 0))
               for v in votes.values())
    served = sum(int(v["served"]) for v in votes.values())
    seen = {int(v["seen"]) for v in votes.values()}
    routed = {int(v["routed"]) for v in votes.values()}
    return bool(idle and sent == recv and len(seen) == 1
                and routed == seen and served == seen.pop())
