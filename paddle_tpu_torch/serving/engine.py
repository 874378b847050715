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

``decode="sampling"`` draws each token from the slot's own law:
temperature, top-k and top-p per request (``submit`` overrides, else the
config's), filtered by ``ops.decoding.apply_top_k_top_p_per_row``, then
``core.random.categorical`` under the request's key folded by the
absolute position of the token it emits. The keys, the emission
positions and the per-slot params ride the tick's one host-to-device
copy, and every row of a tick draws at once on the device. Folding by
position makes a stream independent of scheduling, preemption and its
neighbours, and the threefry generator makes it equal to the JAX
engine's stream on the same logits. The greedy branch is unchanged.

``spec=SpecConfig(draft_model=..., k=...)`` (``serving/spec.py``) turns
each scheduler step into a draft tick and a verify tick: the draft model
runs up to ``k`` tokens ahead of every decoding slot, the verify tick
scores each slot's ``1 + k`` tokens as one row of the ragged kernel, and
acceptance (greedy: the longest prefix equal to the target's argmax;
sampling: the rejection rule) emits up to ``k + 1`` tokens a slot. The
emitted stream is the plain engine's, greedy or sampled. Draft pages come
from the target pool's allocator; under pressure the engine reclaims them
before it preempts. Each step makes one host-to-device copy of its
metadata and reads the verify result back at its end (no deferred window
in spec mode); with ``overlap=True`` (sampling) the next draft tick is
enqueued on the verify tick's device outputs before that read.

Not in this slice (each raises ``NotImplementedError`` naming its
ROADMAP item): the legacy two-dispatch mode (``attention_kernel="legacy"``),
disaggregated export/import and prefix chain migration. The event
timeline and recompile telemetry (the reference's ``compiled_sites`` and
its ``draft``/``verify``/``accept`` events) come with the profiler slice.

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
``cache_share/*``; in spec mode ``serving/spec_draft_ticks``,
``spec_feed_tokens``, ``spec_chained_ticks``, ``spec_chained_consumed``,
``spec_drafted_tokens``, ``spec_accepted_tokens``, ``spec_accept_len``,
``spec_rows``, ``spec_k_effective``, ``spec_accept_rate``,
``spec_draft_pages_reclaimed`` and ``draft_pool_pages``/``_share``/
``_share_peak``.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import random as _random
from ..models.gpt import gpt_ragged_apply
from ..profiler.metrics import registry as _registry
from .paged_cache import PagePool
from .sched import SCHED_POLICIES, ChunkScheduler, SpecKController
from .spec import (DraftRunner, SpecConfig, _greedy, _sample_rows,
                   make_spec_tick)

__all__ = ["ServingConfig", "ServingEngine", "Request"]

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
    decode: str = "greedy"           # 'greedy' | 'sampling'
    kv_dtype: Optional[str] = None   # None (model dtype)|'f32'|'bf16'|'int8'
    temperature: float = 1.0         # sampling defaults; per-request
    top_k: int = 0                   #   overrides ride submit()
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    seed: int = 0                    # sampling keys: fold_in(key(seed), rid)
    attention_kernel: Optional[str] = None   # only 'legacy' is recognized
    spec: Optional[SpecConfig] = None        # speculative decoding


@dataclass
class Request:
    rid: int
    prompt: np.ndarray               # current prompt (grows on preemption)
    max_new: int                     # tokens still wanted (shrinks on preempt)
    key: np.ndarray                  # uint32[2] sampling key (position folds)
    out: List[int] = field(default_factory=list)
    done: bool = False
    submit_t: float = 0.0
    queue_t: float = 0.0             # (re)queue anchor: submit, or requeue
    preempts: int = 0
    first_token_t: Optional[float] = None
    orig_prompt_len: int = 0
    canceled: bool = False
    temperature: Optional[float] = None   # per-request sampling overrides
    top_k: Optional[int] = None           #   (None -> engine config default)
    top_p: Optional[float] = None


class _Inflight:
    __slots__ = ("tok", "meta")

    def __init__(self, tok, meta):
        self.tok = tok               # device int64 tensor
        self.meta = meta             # [(index_into_tok, slot, rid)]


#: one selected-but-not-yet-dispatched prompt chunk of the unified tick
_Chunk = Tuple[int, int, int, int, int]   # (slot, rid, start, end, t0)


def _to_device(device, *arrays, pin: bool = False):
    """Ship several small host arrays in ONE host-to-device copy and
    return device views of each, in their shapes: int and bool arrays as
    int32, float32 arrays as float32 and uint32 arrays (sampling keys) as
    int64 holding the uint32 values. float32 and uint32 travel as their
    bits. ``pin`` (spec mode) starts the copy to a card from pinned
    memory: a copy from pageable memory first waits for every kernel
    queued before it, which would serialize the chained draft tick."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    flat = np.concatenate([
        (a.view(np.int32) if a.dtype in (np.float32, np.uint32)
         else a.astype(np.int32)).reshape(-1) for a in arrays])
    buf = torch.from_numpy(flat)
    if pin and torch.device(device).type == "cuda":
        buf = buf.pin_memory()
    buf = buf.to(device, non_blocking=True)
    out, i = [], 0
    for a in arrays:
        v = buf[i:i + a.size].view(a.shape)
        if a.dtype == np.float32:
            v = v.view(torch.float32)
        elif a.dtype == np.uint32:
            v = v.long() & _random.MASK
        out.append(v)
        i += a.size
    return out


def _to_host(*tensors):
    """Start copying small int64 device tensors to the host and return a
    function that waits for that copy alone and gives them as numpy
    arrays: on a card the copy lands in pinned memory behind an event, so
    work queued after this call (the chained draft tick) runs on while
    the host reads."""
    if tensors[0].device.type != "cuda":
        out = [t.numpy() for t in tensors]
        return lambda: out
    flat = torch.cat([t.reshape(-1) for t in tensors])
    host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
    host.copy_(flat, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait():
        done.synchronize()
        arr, out, i = host.numpy(), [], 0
        for t in tensors:
            out.append(arr[i:i + t.numel()].reshape(tuple(t.shape)))
            i += t.numel()
        return out

    return wait


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
        if cfg.decode not in ("greedy", "sampling"):
            raise ValueError(f"unknown decode mode {cfg.decode!r}")
        self._spec = cfg.spec
        if self._spec is not None:
            if cfg.attention_kernel == "legacy":
                raise ValueError(
                    "speculative decoding needs the unified mixed-row "
                    "tick; attention_kernel='legacy' has no verify row "
                    "path")
            if self._spec.overlap and cfg.decode != "sampling":
                raise ValueError(
                    "spec.overlap chains the next draft tick on the "
                    "sampled verify tick's device outputs; greedy spec "
                    "has no chained draft build — use decode='sampling'")
            if self._spec.k < 1:
                raise ValueError("spec.k must be >= 1")
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
        spec_extra = 0
        if self._spec is not None:
            self._init_spec(model)
            # speculation growth per slot, and draft pages freed by the
            # rewinds (they are listed when their last reference drops)
            spec_extra = self._spec_k // ps + 3
        # int8 pools: the fixed size of the per-tick scale-reset vector
        # (paged_cache.take_fresh), past the most one scheduler step can
        # list: decode growth (<= 1 page per slot), speculation growth,
        # the selected chunks' pages, and pages freed by finishes and
        # preemptions in between
        self._fresh_cap = (b_slots * (1 + spec_extra)
                           + cfg.prefill_chunks_per_tick
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
        # per-slot sampling state, set at admission, shipped every tick
        self._keys = np.zeros((b_slots, 2), np.uint32)
        self._temps = np.full(b_slots, cfg.temperature, np.float32)
        self._topks = np.full(b_slots, cfg.top_k, np.int32)
        self._topps = np.full(b_slots, cfg.top_p, np.float32)
        # request keys are host metadata: folded on the CPU at submit
        self._base_key = _random.PRNGKey(cfg.seed, device="cpu")

    def _init_spec(self, model) -> None:
        """Speculative state: the draft runner on the target pool's
        allocator, the verify tick, the adaptive-depth controller."""
        cfg, mcfg, spec = self.config, self.model_config, self._spec
        dcfg = spec.draft_model.config
        if dcfg.vocab_size != mcfg.vocab_size:
            raise ValueError(
                f"draft vocab_size {dcfg.vocab_size} != target "
                f"{mcfg.vocab_size}: acceptance compares token ids")
        if dcfg.max_seq_len < mcfg.max_seq_len:
            raise ValueError(
                f"draft max_seq_len {dcfg.max_seq_len} must cover "
                f"the target's {mcfg.max_seq_len}")
        if spec.draft_model.device != self.device:
            raise ValueError(
                f"draft model on {spec.draft_model.device}, target on "
                f"{self.device}: the engine runs both on one device")
        ns = cfg.num_slots
        self._spec_k = int(spec.k)
        # adaptive per-slot depth in [0, k] (None: always k)
        self._spec_ctl = (SpecKController(ns, self._spec_k, spec.ewma_alpha,
                                          spec.reprobe_every)
                          if spec.adaptive else None)
        # tick_depth() results of this step: the probe state advances once
        # per slot per step, read at the feed loop and the depth clamp
        self._spec_tick_depth: Dict[int, int] = {}
        self._spec_sampling = cfg.decode == "sampling"
        self._spec_overlap = bool(spec.overlap)
        # the chained draft tick in flight (overlap): device drafts and
        # probs, the host validity mask, or None
        self._spec_pend: Optional[dict] = None
        self._draft = DraftRunner(spec.draft_model, ns,
                                  self.pool.slot_capacity, self._spec_k,
                                  self.prefill_chunk, self.pool,
                                  sampling=self._spec_sampling)
        self._zero_drafts = torch.zeros(ns * self._spec_k, dtype=torch.long,
                                        device=self.device)
        self._spec_tick = make_spec_tick(mcfg, ns, self._spec_k,
                                         self.prefill_chunk,
                                         sampling=self._spec_sampling)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int,
               key: Optional[np.ndarray] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               hold_after_prefill: bool = False) -> int:
        """Queue one request; returns its id. ``temperature``/``top_k``/
        ``top_p`` override the config's sampling params for this request
        (ignored under greedy decode); ``key`` (uint32[2], a
        ``jax.random``-style key) defaults to ``fold_in(PRNGKey(seed),
        rid)`` under sampling; greedy decode draws nothing and keeps a
        zero key."""
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
        if key is None:
            key = (_random.key_to_numpy(_random.fold_in(self._base_key, rid))
                   if self.config.decode == "sampling"
                   else np.zeros(2, np.uint32))
        now = time.perf_counter()
        req = Request(rid=rid, prompt=p, max_new=int(max_new_tokens),
                      key=np.asarray(key, np.uint32), submit_t=now,
                      queue_t=now, orig_prompt_len=t0,
                      temperature=temperature, top_k=top_k, top_p=top_p)
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
        if self._spec is not None:
            dispatched = self._dispatch_spec(chunks)
        else:
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
                self._spec_reset(slot)
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

    def _spec_reset(self, slot: int) -> None:
        """Invalidate the slot's draft state (admission, finish,
        preemption, cancel): the next tenant's draft cache re-feeds from
        0."""
        if self._spec is None:
            return
        self._draft.release_pages(slot)
        if self._spec_pend is not None:
            # a chained draft tick built on this tenant's frontier means
            # nothing for the next one
            self._spec_pend["valid"][slot] = False
        if self._spec_ctl is not None:
            self._spec_ctl.reset(slot)

    def _finish(self, slot: int, rid: int) -> None:
        req = self._requests[rid]
        req.done = True
        if self._slot_rid[slot] == rid:
            self._spec_reset(slot)
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
            self._spec_reset(slot)
            self._admit_seq += 1
            self._slot_admit_seq[slot] = self._admit_seq
            self._slot_admit_t[slot] = time.perf_counter()
            self._slot_wait_due[slot] = True
            self._sched.note_admit(slot)
            self._keys[slot] = req.key
            c = self.config
            self._temps[slot] = (c.temperature if req.temperature is None
                                 else req.temperature)
            self._topks[slot] = c.top_k if req.top_k is None else req.top_k
            self._topps[slot] = c.top_p if req.top_p is None else req.top_p

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
        # draft pages are worth less than target pages: reclaim them
        # (decayed slots first, then every slot) before draining finishes
        # or preempting a tenant
        if self._reclaim_draft(all_slots=False) and \
                self.pool.grow_slot(s, need):
            return True
        self._drain(0)
        if self._slot_rid[s] is None:
            return False
        if self.pool.grow_slot(s, need):
            return True
        if self._reclaim_draft(all_slots=True) and \
                self.pool.grow_slot(s, need):
            return True
        if not any(x != s and self._slot_rid[x] is not None
                   for x in range(self.config.num_slots)):
            raise RuntimeError(
                "serving pool exhausted: cannot cover a resident request "
                "even with the prefix cache drained and no co-resident to "
                "preempt")
        self._preempt_for(s, need)
        return self._slot_rid[s] is not None

    def _reclaim_draft(self, all_slots: bool) -> int:
        """Return draft pages to the pool under target-page pressure:
        ``all_slots=False`` releases only slots whose adaptive depth has
        decayed to 0 (they are not speculating), ``all_slots=True`` every
        draft cache (those slots ride as plain decode rows and re-feed
        when pressure eases). Never touches target pages. Returns pages
        freed."""
        if self._spec is None:
            return 0
        freed = 0
        for s in range(self.config.num_slots):
            if self._draft.aux.slot_pages(s) == 0:
                continue
            decayed = (self._spec_ctl is not None
                       and self._spec_ctl.depth(s) == 0)
            if all_slots or decayed:
                freed += self._draft.release_pages(s)
                if self._spec_pend is not None:
                    self._spec_pend["valid"][s] = False
        if freed:
            _registry().counter(
                "serving/spec_draft_pages_reclaimed").add(freed)
        return freed

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
        self._spec_reset(victim)
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
    def _tick_layout(self, chunks: List[_Chunk], base: int):
        """The host metadata of a tick's rows, shared by the unified and
        the verify tick: one row per slot at flat positions ``0..ns-1``
        (its frontier; inactive slots write to the null page through
        their zeroed table rows), a section ``ns..base-1`` the caller
        fills (the verify tick's drafts; empty in the unified tick), then
        one ``prefill_chunk``-token row block per chunk at ``base + c *
        w``. A chunked slot's own row sits at the post-chunk frontier (it
        garbage-writes there, overwritten by the next real token).

        Returns ``(pf_toks, tok_pos, tok_limit, row_tab, row_pos0,
        row_len, finishers)``; ``finishers`` lists ``(slot, rid, flat
        index of the prompt's last token, prompt length)`` for each chunk
        that completes its prompt."""
        ns = self.config.num_slots
        w = self.prefill_chunk
        npf = self.config.prefill_chunks_per_tick
        cap = self.pool.slot_capacity
        nt = base + npf * w
        pf_toks = np.zeros(npf * w, np.int32)
        tok_pos = np.zeros(nt, np.int32)
        tok_limit = np.zeros(nt, np.int32)   # pad rows: limit 0 -> null page
        tok_pos[:ns] = self._slot_len
        tok_limit[:ns] = cap
        row_tab = np.zeros((ns + npf, self.pool.pages_per_slot), np.int32)
        row_tab[:ns] = self.pool.tables
        row_pos0 = np.zeros(ns + npf, np.int32)
        row_pos0[:ns] = self._slot_len
        row_len = np.ones(ns + npf, np.int32)
        finishers = []
        for c, (s, rid, start, end, t0) in enumerate(chunks):
            coff = base + c * w
            req = self._requests[rid]
            pf_toks[c * w:c * w + (end - start)] = req.prompt[start:end]
            tok_pos[coff:coff + w] = start + np.arange(w)
            tok_limit[coff:coff + w] = t0
            row_tab[ns + c] = self.pool.tables[s]
            row_pos0[ns + c] = start
            row_len[ns + c] = end - start
            tok_pos[s] = end
            row_pos0[s] = end
            if end >= t0:
                finishers.append((s, rid, coff + (t0 - 1 - start), t0))
        return (pf_toks, tok_pos, tok_limit, row_tab, row_pos0, row_len,
                finishers)

    def _take_fresh(self) -> np.ndarray:
        """int8 pools: drain the pending scale resets for this tick's
        head, BEFORE the scale tensors are used (the overflow path
        rewrites them at once); empty for float pools."""
        if self.pool.quantized:
            return self.pool.take_fresh(self._fresh_cap)
        return np.zeros(0, np.int32)

    def _commit_chunks(self, chunks: List[_Chunk]) -> None:
        """The dispatched chunks' frontiers commit; a completed prompt
        counts its prefill, and the pages each chunk completed are
        published in the prefix index."""
        reg = _registry()
        for s, rid, start, end, t0 in chunks:
            self._slot_len[s] = end
            if end >= t0:
                self._slot_dispatched[s] = 1
                reg.counter("serving/prefills").add(1)
            self._insert_prefix(s, self._requests[rid].prompt, end)

    def _tick_gauges(self, ticking: List[int],
                     chunks: List[_Chunk]) -> None:
        reg = _registry()
        reg.counter("serving/ticks").add(1)
        if chunks:
            reg.counter("serving/prefill_chunks").add(len(chunks))
        reg.gauge("serving/decode_batch").set(float(len(ticking)))
        reg.gauge("serving/mixed_rows").set(float(len(ticking)
                                                  + len(chunks)))
        reg.gauge("serving/mixed_rows_decode").set(float(len(ticking)))
        reg.gauge("serving/mixed_rows_prefill").set(float(len(chunks)))

    def _dispatch_unified(self, chunks: List[_Chunk]) -> bool:
        """Assemble and run the mixed-row tick: one decode row per slot
        plus one ``prefill_chunk``-token row block per selected chunk
        (``_tick_layout``). A chunk whose slot lost its request since
        selection is dropped."""
        chunks = [c for c in chunks if self._slot_rid[c[0]] == c[1]]
        ticking = self._ticking_slots()
        if not ticking and not chunks:
            return False
        ns = self.config.num_slots
        npf = self.config.prefill_chunks_per_tick
        (pf_toks, tok_pos, tok_limit, row_tab, row_pos0, row_len,
         finishers) = self._tick_layout(chunks, ns)
        sample_ix = np.zeros(ns, np.int32)
        # the absolute position of the token each row emits: the sampling
        # law folds it into the slot's key
        sample_pos = np.zeros(ns, np.int32)
        emit = np.zeros(ns, np.int32)
        for s in ticking:
            sample_ix[s] = s
            sample_pos[s] = self._slot_len[s] + 1
            emit[s] = 1
        for s, _, ix, t0 in finishers:
            sample_ix[s] = ix
            sample_pos[s] = t0
            emit[s] = 1
        # a tick without chunks runs the decode rows alone
        n_tok, n_row = (tok_pos.size, ns + npf) if chunks else (ns, ns)
        pool = self.pool
        fresh = self._take_fresh()
        law = (sample_pos, self._keys, self._temps, self._topks,
               self._topps) if self.config.decode == "sampling" else ()
        with torch.inference_mode():
            (pf_d, pos_d, lim_d, tab_d, p0_d, len_d, six_d, emit_d,
             fresh_d, *law_d) = _to_device(
                self.device, pf_toks, tok_pos[:n_tok], tok_limit[:n_tok],
                row_tab[:n_row], row_pos0[:n_row], row_len[:n_row],
                sample_ix, emit, fresh, *law)
            tokens = torch.cat([self._last_tok, pf_d.long()]) if chunks \
                else self._last_tok
            logits = gpt_ragged_apply(
                self.model_config, self._stacked, self._other,
                pool.k, pool.v, tokens, pos_d, lim_d, tab_d,
                p0_d, len_d, six_d.long(), decode_rows=ns,
                chunk_width=self.prefill_chunk,
                **pool.tick_scales(fresh_d))[0]
            tok = self._sample_tok(logits, *law_d)
            self._last_tok = torch.where(emit_d.bool(), tok, self._last_tok)
        meta = [(s, s, self._slot_rid[s]) for s in ticking]
        meta += [(s, s, rid) for s, rid, _, _ in finishers]
        if meta:
            self._inflight.append(_Inflight(tok, meta))
        self.max_inflight_seen = max(self.max_inflight_seen,
                                     len(self._inflight))
        for s in ticking:
            self._slot_len[s] += 1
            self._slot_dispatched[s] += 1
        self._commit_chunks(chunks)
        self._tick_gauges(ticking, chunks)
        return True

    # ------------------------------------------------------------------
    # speculative decoding: a draft tick runs k tokens ahead per caught-up
    # slot, then ONE verify/mixed tick scores every slot's (1+k)-token row
    # through the same ragged call that carries the prefill chunks. The
    # host reads each verify result (acceptance decides the next step's
    # positions); the emitted stream is the target's own.
    # ------------------------------------------------------------------
    def _dispatch_spec(self, chunks: List[_Chunk]) -> bool:
        """One spec scheduler step: (1) the draft tick's plan: catch-up
        feed for slots behind the accepted frontier, ``k`` draft steps for
        caught-up decoding slots; slots with a valid chained draft
        (overlap) skip it, their drafts came from the previous step; (2)
        each slot's depth ``k_s``, clamped by its remaining budget, target
        page headroom and draft page headroom (growth is best effort,
        never preempting a co-resident to speculate deeper); (3) the
        verify/mixed tick's metadata; (4) under overlap, the next draft
        tick's chained frontier. All of it goes to the device in one copy,
        then the draft tick, the verify tick and the chained draft tick are
        enqueued, and the host reads the verify result, which the chained
        tick does not wait for; (5) absorb: append the accepted prefix and
        the correction, rewind both frontiers past the rejected tail and
        return their pages, check the chained tick against what
        absorbed."""
        chunks = [c for c in chunks if self._slot_rid[c[0]] == c[1]]
        ticking = self._ticking_slots()
        if not ticking and not chunks:
            return False
        ns = self.config.num_slots
        k = self._spec_k
        w = self.prefill_chunk
        cap = self.pool.slot_capacity
        dr = self._draft
        reg = _registry()
        ticking_set = set(ticking)
        self._spec_tick_depth.clear()
        sampling = self._spec_sampling
        pend = self._spec_pend

        # ---- (1) the draft tick: feed + generate ----
        feed_toks = np.zeros((ns, w), np.int32)
        feed_pos0 = np.zeros(ns, np.int32)
        feed_len = np.zeros(ns, np.int32)
        gen_tok = np.zeros(ns, np.int32)
        gen_pos = np.full(ns, cap, np.int32)   # cap: null-routed
        last_tok = np.zeros(ns, np.int32)
        gen_slots: List[int] = []
        chained: List[int] = []   # slots riding the pending chained tick
        for s, rid in enumerate(self._slot_rid):
            if rid is None:
                continue
            req = self._requests[rid]
            if s in ticking_set:
                last_tok[s] = req.out[-1]
            pend_ok = pend is not None and bool(pend["valid"][s])
            if self._spec_ctl is not None:
                self._spec_tick_depth[s] = self._spec_ctl.tick_depth(s)
                if self._spec_tick_depth[s] == 0:
                    # decayed to depth 0: a plain decode row, out of the
                    # draft tick (feeding a cache nobody verifies is pure
                    # cost) until a reset or a re-probe
                    if pend_ok:
                        pend["valid"][s] = False
                    continue
            if pend_ok:
                if s in ticking_set and req.max_new - len(req.out) >= 2:
                    # the chained tick already seeded past this frontier
                    # and drafted k tokens: no feed, no generate
                    chained.append(s)
                    continue
                pend["valid"][s] = False
            behind = int(self._slot_len[s]) - int(dr.len[s])
            fed = 0
            if behind > 0:
                # catch the draft cache up toward the accepted frontier:
                # prompt tokens (admission, prefix hits the draft never
                # saw) and emitted tokens ride the same chunk-shaped feed
                fed = min(behind, w)
                lo = int(dr.len[s])
                if not dr.grow_for(s, lo + fed):
                    # best effort: feed only as far as held pages reach
                    fed = max(0, min(fed, dr.held_tokens(s) - lo))
                if fed:
                    seq = np.concatenate(
                        [req.prompt, np.asarray(req.out, np.int32)])
                    feed_toks[s, :fed] = seq[lo:lo + fed]
                    feed_pos0[s] = lo
                    feed_len[s] = fed
            if s in ticking_set and behind - fed == 0 and \
                    req.max_new - len(req.out) >= 2 and \
                    dr.grow_for(s, min(int(self._slot_len[s]) + k, cap)):
                gen_tok[s] = req.out[-1]
                gen_pos[s] = int(self._slot_len[s])
                gen_slots.append(s)
        any_feed = bool(feed_len.any())
        # the draft tick's tables, before the chain's growth below
        dtab = dr.aux.tables.copy()

        # ---- (2) per-slot speculation depth (host-deterministic) ----
        k_arr = np.zeros(ns, np.int32)
        for s in gen_slots + chained:
            req = self._requests[self._slot_rid[s]]
            pos0 = int(self._slot_len[s])
            ks = min(k, req.max_new - len(req.out) - 1, cap - 1 - pos0)
            if self._spec_ctl is not None:
                ks = min(ks, self._spec_tick_depth.get(
                    s, self._spec_ctl.depth(s)))
            if ks <= 0:
                continue
            need = self.pool.pages_for(pos0 + ks + 1) \
                - self.pool.slot_pages(s)
            if need > 0 and not self.pool.grow_slot(s, need):
                # pool pressure: speculate only as deep as held pages
                # reach (k_s may reach 0: a plain decode row)
                ks = min(ks, self.pool.slot_pages(s) * self.pool.page_size
                         - pos0 - 1)
            if ks > 0:
                k_arr[s] = ks
        has_drafts = bool(k_arr.any())

        # ---- (3) the verify/mixed tick ----
        base = ns * (1 + k)
        (pf_toks, tok_pos, tok_limit, row_tab, row_pos0, row_len,
         finishers) = self._tick_layout(chunks, base)
        # the draft section: slot s's k drafts at ns + s * k + j, verified
        # at positions slot_len + 1 + j (live only below its depth)
        dj = np.arange(k)[None, :]
        tok_pos[ns:base] = (self._slot_len[:, None] + 1 + dj).reshape(-1)
        tok_limit[ns:base] = np.where(dj < k_arr[:, None], cap, 0) \
            .reshape(-1)
        row_len[:ns] += k_arr
        sample = np.zeros((ns, 1 + k), np.int32)
        sample[:, 0] = np.arange(ns)
        sample[:, 1:] = ns + np.arange(ns)[:, None] * k + dj
        # each slot's primary token folds at slot_len + 1, a prefill
        # finisher's at t0 (the sampling law's positions)
        sample_pos = (self._slot_len + 1).astype(np.int32)
        for s, _, ix, t0 in finishers:
            sample[s, 0] = ix
            sample_pos[s] = t0
        finishers = [(s, rid) for s, rid, _, _ in finishers]
        pool = self.pool
        fresh = self._take_fresh()

        # ---- (4) overlap: the next draft tick's chained frontier ----
        cm2 = np.zeros(ns, bool)
        ch_pos0 = np.zeros(ns, np.int32)
        if sampling and self._spec_overlap and has_drafts:
            for s in np.nonzero(k_arr)[0]:
                s = int(s)
                req = self._requests[self._slot_rid[s]]
                pos0 = int(self._slot_len[s])
                # the chained steps write draft positions up to pos0 + acc
                # + k <= pos0 + ks + k: chain only where held draft pages
                # cover that (a refusal means a catch-up tick next step)
                if req.max_new - len(req.out) < 2 or not dr.grow_for(
                        s, min(pos0 + int(k_arr[s]) + k + 1, cap)):
                    continue
                cm2[s] = True
                ch_pos0[s] = pos0
        cm = np.zeros(ns, bool)
        cm[chained] = True
        law = (self._keys, sample_pos, self._temps, self._topks,
               self._topps) if sampling else ()

        with torch.inference_mode():
            (dtab_d, ftok_d, fpos_d, flen_d, gtok_d, gpos_d, last_d, pf_d,
             pos_d, lim_d, tab_d, p0_d, len_d, six_d, kd_d, cm_d, dtab2_d,
             chp_d, cm2_d, fresh_d, *law_d) = _to_device(
                self.device, dtab, feed_toks, feed_pos0, feed_len, gen_tok,
                gen_pos, last_tok, pf_toks, tok_pos, tok_limit, row_tab,
                row_pos0, row_len, sample.reshape(-1), k_arr, cm,
                dr.aux.tables, ch_pos0, cm2, fresh, *law, pin=True)
            # (keys, temps, top_ks, top_ps): the draft steps' law
            dlaw = (law_d[0], *law_d[2:]) if sampling else None
            drafts = dprobs = None
            if any_feed or gen_slots:
                out = dr.tick(dr.stacked, dr.other, dr.kc, dr.vc, dtab_d,
                              ftok_d, fpos_d, flen_d, gtok_d, gpos_d,
                              any_feed, bool(gen_slots), law=dlaw)
                drafts, dprobs = out if sampling else (out, None)
                dr.len += feed_len
                reg.counter("serving/spec_draft_ticks").add(1)
                if any_feed:
                    reg.counter("serving/spec_feed_tokens").add(
                        int(feed_len.sum()))
            if chained:
                # splice the pending chained drafts (the previous step's
                # device outputs) over this step's
                cmb = cm_d.bool()
                if drafts is None:
                    drafts = torch.zeros_like(pend["drafts"])
                    dprobs = torch.zeros_like(pend["probs"])
                drafts = torch.where(cmb[:, None], pend["drafts"], drafts)
                dprobs = torch.where(cmb[:, None, None], pend["probs"],
                                     dprobs)
                reg.counter("serving/spec_chained_consumed").add(
                    len(chained))
            draft_flat = self._zero_drafts if drafts is None \
                else drafts.reshape(-1)
            tok_m, acc = self._spec_tick(
                self._stacked, self._other, pool.k, pool.v, last_d.long(),
                draft_flat, pf_d.long(), pos_d, lim_d, tab_d, p0_d, len_d,
                six_d.long(), kd_d, bool(chunks), has_drafts,
                scales=pool.tick_scales(fresh_d),
                law=tuple(law_d) if sampling else None, draft_probs=dprobs)
            fetch = _to_host(tok_m, acc)
            pend_new = None
            if cm2.any():
                # enqueued behind the verify tick, before the host reads
                # it: the read and the absorb below overlap this tick
                ch_drafts, ch_probs = dr.tick(
                    dr.stacked, dr.other, dr.kc, dr.vc, dtab2_d, None, None,
                    None, torch.zeros_like(chp_d),
                    torch.full_like(chp_d, cap), False, True, law=dlaw,
                    chain=(tok_m, acc, chp_d, cm2_d.bool()))
                pend_new = {"drafts": ch_drafts, "probs": ch_probs,
                            "valid": cm2}
                reg.counter("serving/spec_draft_ticks").add(1)
                reg.counter("serving/spec_chained_ticks").add(1)
        # install before the absorb, so _finish/_spec_reset invalidate the
        # right entries
        self._spec_pend = pend_new

        self._commit_chunks(chunks)

        # ---- (5) absorb: acceptance, rewind, finishes ----
        toks, accs = fetch()
        reg.counter("serving/token_syncs").add(1)
        now = time.perf_counter()
        eos = self.config.eos_token_id
        for s, rid in [(t, self._slot_rid[t]) for t in ticking] + finishers:
            req = self._requests[rid]
            ks = int(k_arr[s])
            a = min(int(accs[s]), ks) if ks else 0
            pos0 = int(self._slot_len[s])
            emitted = 0
            finished = False
            for j in range(a + 1):
                tok = int(toks[s, j])
                req.out.append(tok)
                emitted += 1
                reg.counter("serving/tokens_generated").add(1)
                if req.first_token_t is None:
                    req.first_token_t = now
                    reg.histogram("serving/ttft_ms").observe(
                        (now - req.submit_t) * 1000.0)
                if (eos is not None and tok == eos) or \
                        len(req.out) >= req.max_new:
                    finished = True
                    break
            if s in ticking_set:
                # the accepted prefix's KV is in the cache (this verify
                # row wrote it); the rejected tail is truncated off
                self._slot_len[s] = pos0 + emitted
                if ks:
                    gained = emitted - 1
                    reg.counter("serving/spec_drafted_tokens").add(ks)
                    reg.counter("serving/spec_accepted_tokens").add(gained)
                    reg.histogram("serving/spec_accept_len").observe(
                        float(gained))
                    if self._spec_ctl is not None:
                        self._spec_ctl.observe(s, gained, ks)
                if s in gen_slots or s in chained:
                    # the chained tick's seed assumed the whole accepted
                    # prefix and the correction were emitted and the slot
                    # keeps ticking; anything else (EOS, the budget)
                    # invalidates it and the slot catches up next step
                    if (pend_new is not None and bool(pend_new["valid"][s])
                            and not finished and emitted == a + 1
                            and len(req.out) < req.max_new):
                        # the chained tick wrote the seed at the new
                        # frontier (and healed a fully accepted row)
                        dr.len[s] = pos0 + emitted
                    else:
                        if pend_new is not None:
                            pend_new["valid"][s] = False
                        # the draft's own speculation wrote the accepted
                        # tokens' KV; pages past its frontier go back
                        dr.rewind(s, pos0 + min(emitted, k))
                if not finished and ks:
                    # rewind: pages past the new frontier (+1 position of
                    # headroom for the next write) go back to the pool;
                    # refcounts keep shared pages alive
                    self.pool.shrink_slot(s, self.pool.pages_for(
                        int(self._slot_len[s]) + 1))
            self._slot_dispatched[s] = len(req.out)
            if finished:
                self._finish(s, rid)
        self._tick_gauges(ticking, chunks)
        reg.gauge("serving/spec_rows").set(float(int((k_arr > 0).sum())))
        # mean offered depth across speculating slots this tick
        reg.gauge("serving/spec_k_effective").set(
            float(k_arr[k_arr > 0].mean()) if has_drafts else 0.0)
        drafted = reg.counter("serving/spec_drafted_tokens").value
        if drafted:
            reg.gauge("serving/spec_accept_rate").set(
                reg.counter("serving/spec_accepted_tokens").value / drafted)
        # the draft cache's share of the shared pool
        dp = dr.aux.total_pages()
        reg.gauge("serving/draft_pool_pages").set(float(dp))
        share = dp / max(pool.allocator.num_allocated, 1)
        reg.gauge("serving/draft_pool_share").set(share)
        reg.gauge("serving/draft_pool_share_peak").set_max(share)
        return True

    @staticmethod
    def _sample_tok(logits: torch.Tensor, positions=None, keys=None,
                    temps=None, top_ks=None, top_ps=None) -> torch.Tensor:
        """Token choice from last-token logits [N, V]. Greedy (no law
        given): argmax of the f32 log-softmax (the reference's greedy
        branch). Sampling: each row's temperature/top-k/top-p, then a
        categorical draw under the row's key folded by the absolute
        ``positions`` of the emitted tokens, all rows at once. Both are
        ``serving/spec.py``'s spellings, which the spec ticks share."""
        if keys is None:
            return _greedy(logits)
        return _sample_rows(logits, keys, positions, temps, top_ks,
                            top_ps)[0]
