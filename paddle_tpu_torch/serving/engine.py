"""Continuous-batching serving engine over the paged KV cache (mirrors
``paddle_tpu/serving/engine.py``, unified tick only).

- **One mixed-row tick per scheduler step.** Every token in flight rides
  one ``gpt_ragged_apply`` forward as a ragged row: resident decodes as
  one-token rows and up to ``prefill_chunks_per_tick`` prompt chunks as
  ``prefill_chunk``-token rows, through one ``ragged_paged_attention``
  call per row group and layer. A tick with no chunk runs the decode
  rows alone.
- **Chunked prefill**: a long prompt never blocks resident decodes for
  more than one chunk's compute.
- **Prefix caching** with copy-on-write of a mid-page divergent tail
  page; unreferenced cached pages are evicted LRU under pool pressure;
  preemption inserts the victim's fully-written pages first, so its
  re-prefill is a prefix hit.
- **Deferred host sync**: each tick's token tensor stays on the device;
  the host dispatches tick N+1 before ``_drain`` materializes tick N,
  keeping up to ``max_inflight`` ticks in flight. Scheduling that must be
  host-deterministic (positions, page growth, max-token stops) never
  reads device data; only EOS discovery rides the lagged window.
- **Exhaustion -> eviction -> preemption** of the youngest request, whose
  generated prefix is requeued as a longer prompt.

The page pools are updated in place (``index_put_`` in
``ops.paged_attention.paged_kv_scatter``, an in-place page copy for COW):
PyTorch has no buffer donation, and an in-place update is what donation
bought the reference. The kernel or its plain version is chosen by the
pools' device alone; there is no knob that selects the plain version on
a card.

``kv_dtype="int8"`` stores the pools as int8 with per-page per-head f32
scales (about a quarter of the f32 pool's bytes): every KV write goes
through the quantizing ``paged_kv_scatter`` and every read dequantizes
with the same scales, in the kernel on a card. The scale rows of pages
that were allocated or freed since the last tick are reset at the head of
the tick, before anything reads them; a copy-on-write page keeps its
donor's scales. Streams agree with the unquantized engine by a match
rate, not bitwise; two int8 engines on the same schedule agree exactly.

Not in this slice (each raises ``NotImplementedError`` naming its
ROADMAP item): ``decode="sampling"``, speculative
decoding (``spec``), the legacy two-dispatch mode
(``attention_kernel="legacy"``), disaggregated export/import and prefix
chain migration. The event timeline and recompile telemetry come with
the profiler slice.

Profiler signals (``profiler.metrics.registry()``):
``serving/queue_depth``, ``serving/active_slots``, ``serving/page_util``,
``serving/ttft_ms``, ``serving/tpot_ms``, ``serving/prefill_queue_wait_ms``,
``serving/requeue_wait_ms``, ``serving/chunk_wait_ms``,
``serving/tokens_per_sec``, ``serving/tokens_generated``,
``serving/prefills``, ``serving/prefill_chunks``, ``serving/ticks``,
``serving/preemptions``, ``serving/requests_finished``,
``serving/token_syncs``, ``serving/prefix_lookups``,
``serving/prefix_hit_tokens``, ``serving/prompt_tokens``,
``serving/mixed_rows`` (+ ``_decode``/``_prefill``),
``serving/decode_batch``, ``serving/budget_cuts``, and
``cache_share/*``.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.gpt import gpt_ragged_apply
from ..profiler.metrics import registry as _registry
from .paged_cache import PagePool
from .sched import SCHED_POLICIES, ChunkScheduler

__all__ = ["ServingConfig", "ServingEngine", "Request"]

_TODO_SAMPLING = ("decode='sampling' is not ported yet: ROADMAP queue 1 "
                  "item 4 (dense decode and sampling)")
_TODO_SPEC = ("speculative decoding is not ported yet: ROADMAP queue 1 "
              "item 5 (speculative decoding)")
_TODO_SERVING = ("is not ported yet: ROADMAP queue 1 item 6 (serving "
                 "remainder: legacy mode, disaggregation, chain migration)")


@dataclass
class ServingConfig:
    """Engine knobs. The pool holds ``num_pages - 1`` allocatable pages
    (page 0 is the null page) of ``page_size`` tokens, shared by
    ``num_slots`` resident requests of at most ``pages_per_slot`` pages
    (``slot_capacity = pages_per_slot * page_size`` tokens). Sizing
    ``num_pages - 1 < num_slots * pages_per_slot`` oversubscribes the pool,
    served by prefix-cache eviction then preemption."""

    num_slots: int = 8
    page_size: int = 16
    pages_per_slot: int = 0          # default: ceil(max_seq_len / page_size)
    num_pages: int = 0               # default: full residency + null page
    prefill_chunk: int = 0           # tokens per prefill chunk (0: 2 pages)
    prefill_chunks_per_tick: int = 1  # prefill rows per unified tick
    scheduler: str = "fifo"          # 'fifo' | 'sjf' | 'aged-sjf'
    prefix_cache: bool = True        # share prompt-prefix pages
    max_inflight: int = 2            # unmaterialized ticks in flight
    decode: str = "greedy"           # 'greedy' ('sampling': later slice)
    kv_dtype: Optional[str] = None   # None (model dtype)|'f32'|'bf16'|'int8'
    eos_token_id: Optional[int] = None
    attention_kernel: Optional[str] = None   # only 'legacy' is recognized
    spec: Optional[object] = None            # speculative decoding config


@dataclass
class Request:
    rid: int
    prompt: np.ndarray               # current prompt (grows on preemption)
    max_new: int                     # tokens still wanted (shrinks on preempt)
    out: List[int] = field(default_factory=list)
    done: bool = False
    submit_t: float = 0.0
    queue_t: float = 0.0             # (re)queue anchor: submit, or requeue
    preempts: int = 0
    first_token_t: Optional[float] = None
    orig_prompt_len: int = 0
    canceled: bool = False


class _Inflight:
    __slots__ = ("tok", "meta")

    def __init__(self, tok, meta):
        self.tok = tok               # device int64 tensor
        self.meta = meta             # [(index_into_tok, slot, rid)]


#: one selected-but-not-yet-dispatched prompt chunk of the unified tick
_Chunk = Tuple[int, int, int, int, int]   # (slot, rid, start, end, t0)


def _to_device(device, *arrays):
    """Ship several small host int arrays in ONE host-to-device copy and
    return device views of each (int32, original shapes)."""
    flat = np.concatenate([np.asarray(a, np.int32).reshape(-1)
                           for a in arrays])
    buf = torch.from_numpy(flat).to(device, non_blocking=True)
    out, i = [], 0
    for a in arrays:
        a = np.asarray(a)
        out.append(buf[i:i + a.size].view(a.shape))
        i += a.size
    return out


class ServingEngine:
    """Continuous-batching serving runtime for a dense ``GPT`` model::

        eng = ServingEngine(model, ServingConfig(num_slots=8))
        rid = eng.submit(prompt_ids, max_new_tokens=32)
        out = eng.run()[rid]          # np.int32 generated ids

    The engine runs on the model's device.
    """

    def __init__(self, model, config: Optional[ServingConfig] = None):
        cfg = config or ServingConfig()
        mcfg = model.config
        if cfg.decode == "sampling":
            raise NotImplementedError(_TODO_SAMPLING)
        if cfg.decode != "greedy":
            raise ValueError(f"unknown decode mode {cfg.decode!r}")
        if cfg.spec is not None:
            raise NotImplementedError(_TODO_SPEC)
        if cfg.attention_kernel == "legacy":
            raise NotImplementedError(
                "attention_kernel='legacy' " + _TODO_SERVING)
        if cfg.attention_kernel is not None:
            raise ValueError(
                f"unknown attention_kernel {cfg.attention_kernel!r}: the "
                "port has one tick; the pools' device chooses the kernel "
                "(CUDA) or its plain version (CPU)")
        if cfg.prefill_chunks_per_tick < 1:
            raise ValueError("prefill_chunks_per_tick must be >= 1")
        if cfg.scheduler not in SCHED_POLICIES:
            raise ValueError(
                f"unknown scheduler {cfg.scheduler!r}; expected one of "
                f"{SCHED_POLICIES}")
        self.config = cfg
        self.model_config = mcfg
        self.device = model.device
        self._stacked, self._other = model._decode_state()
        self._dtype = self._other["embeddings.wte.weight"].dtype
        kv_map = {None: self._dtype, "f32": torch.float32,
                  "bf16": torch.bfloat16, "int8": torch.int8}
        if cfg.kv_dtype not in kv_map:
            raise ValueError(
                f"unknown kv_dtype {cfg.kv_dtype!r}; expected one of "
                "None (model dtype), 'f32', 'bf16', 'int8'")
        kv_dtype = kv_map[cfg.kv_dtype]
        nh = mcfg.num_heads
        hd = mcfg.hidden_size // nh
        ps = cfg.page_size
        pages_per_slot = cfg.pages_per_slot or -(-mcfg.max_seq_len // ps)
        num_pages = cfg.num_pages or cfg.num_slots * pages_per_slot + 1
        self.pool = PagePool(mcfg.num_layers, num_pages, ps, nh, hd,
                             cfg.num_slots, pages_per_slot,
                             dtype=kv_dtype, device=self.device,
                             prefix_cache=cfg.prefix_cache)
        self.prefill_chunk = int(cfg.prefill_chunk) or 2 * ps
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        b_slots = cfg.num_slots
        # int8 pools: the fixed size of the per-tick scale-reset vector
        # (paged_cache.take_fresh), past the most one scheduler step can
        # list: decode growth (<= 1 page per slot), the selected chunks'
        # pages, and pages freed by finishes and preemptions in between
        self._fresh_cap = (b_slots + cfg.prefill_chunks_per_tick
                           * (self.prefill_chunk // ps + 2) + 8)
        self._sched = ChunkScheduler(
            cfg.scheduler, b_slots, self.pool.slot_capacity,
            self.prefill_chunk, cfg.prefill_chunks_per_tick)
        # host scheduling state (never reads device data)
        self._slot_rid: List[Optional[int]] = [None] * b_slots
        self._slot_len = np.zeros(b_slots, np.int32)      # tokens in cache
        self._slot_prompt = np.zeros(b_slots, np.int32)   # current prompt len
        self._slot_dispatched = np.zeros(b_slots, np.int64)  # tokens emitted
        self._slot_admit_seq = np.zeros(b_slots, np.int64)
        self._slot_admit_t = np.zeros(b_slots, np.float64)
        self._slot_wait_due = [False] * b_slots
        self._slot_looked_up = [False] * b_slots
        self._admit_seq = 0
        self._queue: deque = deque()
        self._requests: Dict[int, Request] = {}
        self._next_rid = 0
        self._inflight: deque = deque()
        self.max_inflight_seen = 0
        # device state: each slot's last emitted token
        self._last_tok = torch.zeros(b_slots, dtype=torch.int64,
                                     device=self.device)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int,
               hold_after_prefill: bool = False) -> int:
        """Queue one request; returns its id."""
        if hold_after_prefill:
            raise NotImplementedError(
                "hold_after_prefill (disaggregated prefill) " + _TODO_SERVING)
        p = np.asarray(prompt_ids, np.int32).reshape(-1)
        t0 = p.shape[0]
        cap = self.pool.slot_capacity
        if t0 < 1 or max_new_tokens < 1:
            raise ValueError("need a non-empty prompt and max_new >= 1")
        if t0 + max_new_tokens - 1 > cap:
            raise ValueError(
                f"prompt {t0} + {max_new_tokens} new tokens needs "
                f"{t0 + max_new_tokens - 1} cache positions; slot capacity "
                f"is {cap} (pages_per_slot * page_size)")
        if self.pool.pages_for(t0 + max_new_tokens - 1) > \
                self.pool.allocator.num_pages - 1:
            raise ValueError("request exceeds the whole page pool")
        rid = self._next_rid
        self._next_rid += 1
        now = time.perf_counter()
        req = Request(rid=rid, prompt=p, max_new=int(max_new_tokens),
                      submit_t=now, queue_t=now, orig_prompt_len=t0)
        self._requests[rid] = req
        self._queue.append(req)
        _registry().counter("serving/prompt_tokens").add(t0)
        return rid

    def step(self) -> bool:
        """One scheduler iteration: bound the in-flight window, admit into
        free slots, select prompt chunks, grow pages (preempting on
        exhaustion), dispatch ONE unified tick. Returns whether any device
        work was dispatched."""
        self._sched.on_tick()
        self._drain(self.config.max_inflight)
        self._admit()
        chunks = self._collect_chunks()
        self._grow_pages()
        dispatched = self._dispatch_unified(chunks)
        reg = _registry()
        reg.gauge("serving/queue_depth").set(float(len(self._queue)))
        reg.gauge("serving/active_slots").set(
            float(sum(r is not None for r in self._slot_rid)))
        reg.gauge("serving/page_util").set(self.pool.allocator.utilization())
        return dispatched

    def run(self) -> Dict[int, np.ndarray]:
        """Drive until every submitted request finished; returns
        ``{rid: generated ids np.int32[<= max_new]}``."""
        t0 = time.perf_counter()
        tokens0 = self._tokens_done()
        while True:
            progressed = self.step()
            if not progressed:
                if self._inflight:
                    self._drain(0)
                    continue
                if all(r is None for r in self._slot_rid):
                    if not self._queue:
                        break
                    raise RuntimeError(
                        "serving queue stalled: page pool too small for "
                        "the queued prompt")
                raise RuntimeError(
                    "serving scheduler deadlock: resident requests but "
                    "nothing dispatchable")
        wall = max(time.perf_counter() - t0, 1e-9)
        done = self._tokens_done() - tokens0
        _registry().gauge("serving/tokens_per_sec").set(done / wall)
        return {rid: np.asarray(r.out, np.int32)
                for rid, r in self._requests.items()
                if r.done and not r.canceled}

    def drain(self, target: int = 0) -> None:
        """Materialize in-flight ticks until at most ``target`` remain."""
        self._drain(target)

    def idle(self) -> bool:
        return (not self._queue and not self._inflight
                and all(r is None for r in self._slot_rid))

    def reset_results(self) -> None:
        """Forget finished requests."""
        self._requests = {rid: r for rid, r in self._requests.items()
                          if not r.done}

    def cancel(self, rid: int) -> bool:
        """Abandon a request wherever it stands, freeing its slot and
        pages without a result. False for an unknown or finished one."""
        req = self._requests.get(rid)
        if req is None or req.done:
            return False
        if any(r.rid == rid for r in self._queue):
            self._queue = deque(r for r in self._queue if r.rid != rid)
        elif rid in self._slot_rid:
            self._drain(0)
            if rid in self._slot_rid:
                slot = self._slot_rid.index(rid)
                self._sched.note_release(slot)
                self.pool.release_slot(slot)
                self._slot_rid[slot] = None
                self._slot_len[slot] = 0
        if req.done:
            return False
        req.done = True
        req.canceled = True
        req.out = []
        _registry().counter("serving/requests_canceled").add(1)
        return True

    def export_held(self, rid: int) -> dict:
        raise NotImplementedError("KV export " + _TODO_SERVING)

    def release_exported(self, rid: int) -> None:
        raise NotImplementedError("KV export " + _TODO_SERVING)

    def admit_prefilled(self, payload: dict) -> Optional[int]:
        raise NotImplementedError("KV import " + _TODO_SERVING)

    def export_prefix_chain(self, tokens) -> Optional[dict]:
        raise NotImplementedError("prefix chain migration " + _TODO_SERVING)

    def import_prefix_chain(self, payload: dict) -> int:
        raise NotImplementedError("prefix chain migration " + _TODO_SERVING)

    def _tokens_done(self) -> int:
        return sum(len(r.out) for r in self._requests.values())

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------
    def _drain(self, target: int) -> None:
        """Materialize in-flight ticks oldest-first until at most
        ``target`` remain. The ONLY place device data reaches the host."""
        reg = _registry()
        while len(self._inflight) > target:
            ent = self._inflight.popleft()
            toks = ent.tok.cpu().numpy()
            reg.counter("serving/token_syncs").add(1)
            now = time.perf_counter()
            for idx, slot, rid in ent.meta:
                req = self._requests[rid]
                if req.done:
                    continue        # EOS discovered while this was in flight
                tok = int(toks[idx])
                req.out.append(tok)
                reg.counter("serving/tokens_generated").add(1)
                if req.first_token_t is None:
                    req.first_token_t = now
                    reg.histogram("serving/ttft_ms").observe(
                        (now - req.submit_t) * 1000.0)
                eos = self.config.eos_token_id
                if eos is not None and tok == eos:
                    self._finish(slot, rid)
                elif len(req.out) >= req.max_new:
                    self._finish(slot, rid)

    def _insert_prefix(self, slot: int, tokens: np.ndarray,
                       written: int) -> None:
        """Register ``slot``'s fully-written pages (KV for
        ``tokens[:written]``) in the prefix index."""
        if self.pool.prefix is None:
            return
        n_full = min(written, tokens.shape[0]) // self.pool.page_size
        if n_full:
            self.pool.prefix.insert(
                tokens[:n_full * self.pool.page_size],
                [int(p) for p in self.pool.tables[slot, :n_full]])

    def _finish(self, slot: int, rid: int) -> None:
        req = self._requests[rid]
        req.done = True
        if self._slot_rid[slot] == rid:
            self._sched.note_release(slot)
            # cache the finished sequence's full pages before release
            seq = np.concatenate(
                [req.prompt, np.asarray(req.out, np.int32)])
            self._insert_prefix(slot, seq, int(self._slot_len[slot]))
            self.pool.release_slot(slot)
            self._slot_rid[slot] = None
            self._slot_len[slot] = 0
        # fold the preemption-era prefix back into the result
        extra = req.prompt[req.orig_prompt_len:]
        if extra.size:
            req.out = [int(t) for t in extra] + req.out
        reg = _registry()
        reg.counter("serving/requests_finished").add(1)
        if req.first_token_t is not None:
            ttft = (req.first_token_t - req.submit_t) * 1000.0
            tpot = (time.perf_counter() - req.first_token_t) * 1000.0 \
                / max(len(req.out) - 1, 1)
            self._sched.note_finish(ttft, tpot)
            reg.histogram("serving/tpot_ms").observe(tpot)

    def _admit(self) -> None:
        """Move queued requests into free slots (pages are acquired per
        chunk, so the prefix lookup runs as late as possible)."""
        free = [s for s, r in enumerate(self._slot_rid) if r is None]
        while self._queue and free:
            req = self._queue.popleft()
            slot = free.pop()
            self._slot_rid[slot] = req.rid
            self._slot_len[slot] = 0
            self._slot_prompt[slot] = req.prompt.shape[0]
            self._slot_dispatched[slot] = 0
            self._slot_looked_up[slot] = False
            self._admit_seq += 1
            self._slot_admit_seq[slot] = self._admit_seq
            self._slot_admit_t[slot] = time.perf_counter()
            self._slot_wait_due[slot] = True
            self._sched.note_admit(slot)

    def _next_prefill_slot(self, pend: Dict[int, int]) -> Optional[int]:
        cands = []
        for s, rid in enumerate(self._slot_rid):
            if rid is None:
                continue
            frontier = pend.get(s, int(self._slot_len[s]))
            remaining = int(self._slot_prompt[s]) - frontier
            if remaining > 0:
                cands.append((s, int(self._slot_admit_seq[s]), remaining))
        return self._sched.pick(cands)

    def _lookup_prefix(self, slot: int, req: Request) -> None:
        """Alias the longest cached page-aligned prefix of the prompt into
        ``slot`` (plus one copy-on-write page when the prompt diverges
        from a cached chunk mid-page); prefill starts after it."""
        if self.pool.prefix is None:
            return
        full_pages, partial = self.pool.prefix.lookup(req.prompt)
        reg = _registry()
        reg.counter("serving/prefix_lookups").add(1)
        hit = 0
        if full_pages:
            self.pool.share_into_slot(slot, full_pages)
            hit = len(full_pages) * self.pool.page_size
        if partial is not None:
            src, lcp = partial
            # pin the donor page: the grow below may evict cached pages
            self.pool.allocator.share([src])
            try:
                if self.pool.grow_slot(slot, 1):
                    dst = self.pool.tables[slot,
                                           self.pool.slot_pages(slot) - 1]
                    with torch.inference_mode():
                        self.pool.copy_page(int(src), int(dst))
                    hit += lcp
                    reg.counter("cache_share/cow_copies").add(1)
            finally:
                self.pool.allocator.free([src])
        self._slot_len[slot] = hit
        if hit:
            reg.counter("serving/prefix_hit_tokens").add(hit)

    def _observe_wait(self, req: Request) -> None:
        wait_ms = (time.perf_counter() - req.queue_t) * 1000.0
        name = "serving/requeue_wait_ms" if req.preempts \
            else "serving/prefill_queue_wait_ms"
        _registry().histogram(name).observe(wait_ms)

    def _open_chunk(self, s: int, pend: Dict[int, int]) -> Optional[_Chunk]:
        """Prefix lookup if due, then size the slot's next prompt chunk
        and acquire its pages. None when the slot was freed on the way."""
        rid = self._slot_rid[s]
        req = self._requests[rid]
        if not self._slot_looked_up[s]:
            self._slot_looked_up[s] = True
            self._observe_wait(req)
            self._lookup_prefix(s, req)
        t0 = int(self._slot_prompt[s])
        start = pend.get(s, int(self._slot_len[s]))
        end = min(start + self.prefill_chunk, t0)
        need = self.pool.pages_for(end) - self.pool.slot_pages(s)
        if not self._acquire_pages(s, need):
            return None
        if self._slot_wait_due[s]:
            self._slot_wait_due[s] = False
            wait_ms = (time.perf_counter() - self._slot_admit_t[s]) * 1000.0
            _registry().histogram("serving/chunk_wait_ms").observe(wait_ms)
        self._sched.note_open(s)
        return (s, rid, start, end, t0)

    def _collect_chunks(self) -> List[_Chunk]:
        """Select up to the policy's per-tick budget of prompt chunks and
        acquire their pages without dispatching. ``_slot_len`` commits
        only at dispatch (a selected chunk may be dropped by a later
        preemption, and its frontier must not reach the prefix index)."""
        chunks: List[_Chunk] = []
        pend: Dict[int, int] = {}
        npf = self.config.prefill_chunks_per_tick
        budget = npf
        if self._sched.shape_budget:
            pending = sum(
                1 for s, rid in enumerate(self._slot_rid)
                if rid is not None
                and int(self._slot_len[s]) < self._slot_prompt[s])
            budget = min(npf, self._sched.chunk_budget(
                pending, len(self._ticking_slots()), len(self._queue)))
            if budget < npf and pending:
                _registry().counter("serving/budget_cuts").add(1)
        for _ in range(budget):
            s = self._next_prefill_slot(pend)
            if s is None:
                break
            chunk = self._open_chunk(s, pend)
            if chunk is None:
                continue
            pend[s] = chunk[3]
            chunks.append(chunk)
        return chunks

    def _acquire_pages(self, s: int, need: int) -> bool:
        """Grow slot ``s`` by ``need`` pages, escalating: free list (+
        prefix-cache eviction) -> drain in-flight finishes -> preempt the
        youngest. False when ``s`` itself was freed along the way."""
        if need <= 0 or self.pool.grow_slot(s, need):
            return True
        self._drain(0)
        if self._slot_rid[s] is None:
            return False
        if self.pool.grow_slot(s, need):
            return True
        if not any(x != s and self._slot_rid[x] is not None
                   for x in range(self.config.num_slots)):
            raise RuntimeError(
                "serving pool exhausted: cannot cover a resident request "
                "even with the prefix cache drained and no co-resident to "
                "preempt")
        self._preempt_for(s, need)
        return self._slot_rid[s] is not None

    def _ticking_slots(self) -> List[int]:
        """Slots that advance this tick: resident, prefill complete, not
        finished, emissions still owed."""
        out = []
        for s, rid in enumerate(self._slot_rid):
            if rid is None:
                continue
            req = self._requests[rid]
            if not req.done and \
                    1 <= self._slot_dispatched[s] < req.max_new:
                out.append(s)
        return out

    def _grow_pages(self) -> None:
        for s in self._ticking_slots():
            if self._slot_rid[s] is None:
                continue            # freed by an earlier drain/preempt
            need_page = int(self._slot_len[s]) // self.pool.page_size
            if need_page < self.pool.slot_pages(s):
                continue
            self._acquire_pages(s, 1)

    def _preempt_for(self, needy_slot: int, need: int) -> None:
        """Free pages by requeueing the youngest resident request (its
        generated prefix becomes prompt; its full pages are indexed first,
        so the re-prefill is a prefix hit)."""
        live = [s for s in range(self.config.num_slots)
                if self._slot_rid[s] is not None]
        victim = max(live, key=lambda s: self._slot_admit_seq[s])
        rid = self._slot_rid[victim]
        req = self._requests[rid]
        if not self._slot_looked_up[victim]:
            self._observe_wait(req)
        req.prompt = np.concatenate(
            [req.prompt, np.asarray(req.out, np.int32)])
        req.max_new -= len(req.out)
        req.out = []
        req.preempts += 1
        req.queue_t = time.perf_counter()
        self._insert_prefix(victim, req.prompt, int(self._slot_len[victim]))
        self._queue.appendleft(req)
        self._sched.note_release(victim)
        self.pool.release_slot(victim)
        self._slot_rid[victim] = None
        self._slot_len[victim] = 0
        _registry().counter("serving/preemptions").add(1)
        if victim != needy_slot and self._slot_rid[needy_slot] is not None:
            if not self.pool.grow_slot(needy_slot, need):
                self._preempt_for(needy_slot, need)

    # ------------------------------------------------------------------
    # unified dispatch: ONE forward per scheduler step
    # ------------------------------------------------------------------
    def _dispatch_unified(self, chunks: List[_Chunk]) -> bool:
        """Assemble and run the mixed-row tick: one decode row per slot
        (inactive slots write to the null page through their zeroed table
        rows) plus one ``prefill_chunk``-token row block per selected
        chunk. A chunk whose slot lost its request since selection is
        dropped."""
        chunks = [c for c in chunks if self._slot_rid[c[0]] == c[1]]
        ticking = self._ticking_slots()
        if not ticking and not chunks:
            return False
        ns = self.config.num_slots
        w = self.prefill_chunk
        npf = self.config.prefill_chunks_per_tick
        nps = self.pool.pages_per_slot
        cap = self.pool.slot_capacity
        nt = ns + npf * w
        pf_toks = np.zeros(npf * w, np.int32)
        tok_pos = np.zeros(nt, np.int32)
        tok_limit = np.zeros(nt, np.int32)   # pad rows: limit 0 -> null page
        tok_pos[:ns] = self._slot_len
        tok_limit[:ns] = cap
        row_tab = np.zeros((ns + npf, nps), np.int32)
        row_tab[:ns] = self.pool.tables
        row_pos0 = np.zeros(ns + npf, np.int32)
        row_pos0[:ns] = self._slot_len
        row_len = np.ones(ns + npf, np.int32)
        sample_ix = np.zeros(ns, np.int32)
        emit = np.zeros(ns, np.int32)
        for s in ticking:
            sample_ix[s] = s
            emit[s] = 1
        finishers = []
        for c, (s, rid, start, end, t0) in enumerate(chunks):
            base = ns + c * w
            req = self._requests[rid]
            pf_toks[c * w:c * w + (end - start)] = req.prompt[start:end]
            tok_pos[base:base + w] = start + np.arange(w)
            tok_limit[base:base + w] = t0
            row_tab[ns + c] = self.pool.tables[s]
            row_pos0[ns + c] = start
            row_len[ns + c] = end - start
            # the slot's decode row sits at the post-chunk frontier (it
            # garbage-writes there, overwritten by the next real token)
            tok_pos[s] = end
            row_pos0[s] = end
            if end >= t0:
                finishers.append((s, rid))
                sample_ix[s] = base + (t0 - 1 - start)
                emit[s] = 1
        # a tick without chunks runs the decode rows alone
        n_tok, n_row = (nt, ns + npf) if chunks else (ns, ns)
        pool = self.pool
        # int8 pools: drain the pending scale resets BEFORE the scale
        # tensors are used (the overflow path rewrites them at once)
        fresh = pool.take_fresh(self._fresh_cap) if pool.quantized \
            else np.zeros(0, np.int32)
        with torch.inference_mode():
            (pf_d, pos_d, lim_d, tab_d, p0_d, len_d, six_d, emit_d,
             fresh_d) = _to_device(self.device, pf_toks, tok_pos[:n_tok],
                                   tok_limit[:n_tok], row_tab[:n_row],
                                   row_pos0[:n_row], row_len[:n_row],
                                   sample_ix, emit, fresh)
            tokens = torch.cat([self._last_tok, pf_d.long()]) if chunks \
                else self._last_tok
            scales = {}
            if pool.quantized:
                # the tick's scale reset (fresh pads with the null page,
                # whose scale is 0)
                pool.k_scale.index_fill_(1, fresh_d.long(), 0.0)
                pool.v_scale.index_fill_(1, fresh_d.long(), 0.0)
                scales = dict(kscale=pool.k_scale, vscale=pool.v_scale)
            logits = gpt_ragged_apply(
                self.model_config, self._stacked, self._other,
                pool.k, pool.v, tokens, pos_d, lim_d, tab_d,
                p0_d, len_d, six_d.long(), decode_rows=ns, chunk_width=w,
                **scales)[0]
            tok = self._sample_tok(logits)
            self._last_tok = torch.where(emit_d.bool(), tok, self._last_tok)
        meta = [(s, s, self._slot_rid[s]) for s in ticking]
        meta += [(s, s, rid) for s, rid in finishers]
        if meta:
            self._inflight.append(_Inflight(tok, meta))
        self.max_inflight_seen = max(self.max_inflight_seen,
                                     len(self._inflight))
        reg = _registry()
        for s in ticking:
            self._slot_len[s] += 1
            self._slot_dispatched[s] += 1
        for s, rid, start, end, t0 in chunks:
            self._slot_len[s] = end
            if end >= t0:
                self._slot_dispatched[s] = 1
                reg.counter("serving/prefills").add(1)
            # publish the pages this chunk completed
            self._insert_prefix(s, self._requests[rid].prompt, end)
        reg.counter("serving/ticks").add(1)
        if chunks:
            reg.counter("serving/prefill_chunks").add(len(chunks))
        reg.gauge("serving/decode_batch").set(float(len(ticking)))
        reg.gauge("serving/mixed_rows").set(float(len(ticking)
                                                  + len(chunks)))
        reg.gauge("serving/mixed_rows_decode").set(float(len(ticking)))
        reg.gauge("serving/mixed_rows_prefill").set(float(len(chunks)))
        return True

    @staticmethod
    def _sample_tok(logits: torch.Tensor) -> torch.Tensor:
        """Greedy token choice: argmax of the f32 log-softmax (the
        reference's greedy branch)."""
        lp = torch.log_softmax(logits.float(), dim=-1)
        return torch.argmax(lp, dim=-1)
