"""Continuous-batching serving engine over the paged KV cache (mirrors
``paddle_tpu/serving/engine.py``).

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

Every lifecycle edge of a request is an event in the profiler's event
log (``profiler/events.py``), stamped with the engine's id (``eng``) and
the request's ``trace`` id when it has one: ``submit``, ``admit``,
``prefix_hit``, ``cow_copy``, ``chunk``, ``first_token`` (when the host
holds the token: at the read of the tick that sampled it), ``preempt``,
``requeue``, ``cancel`` and ``finish`` (with ``ttft_ms``/``tpot_ms``); a
spec engine adds ``draft``, ``verify`` and ``accept``, and the handoff
``handoff_out`` and ``handoff_in`` (bytes, pages, ms). ``latency_stats``
reads the rolling TTFT/TPOT percentiles off them. Each dispatch marks its
arguments at its recompile site (``compiled_sites``), so
``profiler.trace_counts()`` counts the tick shapes each site has run. Each
dispatch also runs inside a ``record_function`` range named after its
site, and each site's first dispatch is counted
(``profiler/program_stats.py``): ``record_program_stats()`` folds those
counts into the profiler's program inventory, and ``trace_window()``
parses a ``torch.profiler`` window of ticks into device time per site
(``profiler/device_trace.py``).

``attention_kernel="legacy"`` keeps the reference's pre-unification
engine as the baseline of the dispatch collapse: each step dispatches up
to ``prefill_chunks_per_tick`` prefill programs (one slot's chunk as one
``prefill_chunk``-query ragged row, ``gpt_paged_suffix_apply``) and then
one fixed-shape decode tick of ``[num_slots, 1]`` rows (idle slots write
to the null page through their zeroed table rows; a slot that finished
at exactly its capacity rides with ``pos == slot_capacity``, its write
sent to the null page and its position row clamped). Two dispatch sites,
``serving.tick`` and ``serving.prefill``; fifo chunk selection and the
model-dtype pool only. ``"ragged-xla"``, ``"ragged-pallas"`` and the
default ``None`` all name the unified tick: the pools' device picks the
kernel (CUDA) or its plain version (CPU), and no name selects the plain
version on a card.

The KV handoff of disaggregated serving: ``submit(...,
hold_after_prefill=True)`` parks a request after its prompt is
prefilled and its first token read (``held_ready``); ``export_held``
reads its pages (and an int8 pool's scales) into a host payload in one
gather and one device-to-host copy, ``release_exported`` publishes the
prompt's pages in the local prefix index and frees the slot, and another
engine's ``admit_prefilled`` writes the pages into fresh ones (one
host-to-device copy and one ``index_copy_`` a pool, of the payload's
pages only) and decodes on as if it had prefilled the prompt
itself. bf16 pages travel as their ``uint16`` bits. Hot prefix chains
migrate the same way: ``export_prefix_chain`` ships a prompt's cached
chain, ``import_prefix_chain`` indexes it in this engine's trie, and a
prefix hit on such pages counts as remote.

Profiler signals (``profiler.metrics.registry()``):
``serving/queue_depth``, ``serving/active_slots``, ``serving/page_util``,
``serving/ttft_ms``, ``serving/tpot_ms``, ``serving/prefill_queue_wait_ms``,
``serving/requeue_wait_ms``, ``serving/chunk_wait_ms``,
``serving/tokens_per_sec``, ``serving/tokens_generated``,
``serving/prefills``, ``serving/prefill_chunks``, ``serving/ticks``,
``serving/preemptions``, ``serving/requests_finished``,
``serving/token_syncs``, ``serving/prefix_lookups``,
``serving/prefix_hit_tokens`` (+ ``_remote``), ``serving/prompt_tokens``,
``serving/handoffs_out``/``_in``, ``serving/handoff_bytes_out``/``_in``,
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
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import random as _random
from ..models.gpt import gpt_paged_suffix_apply, gpt_ragged_apply
from ..profiler import events as _events
from ..profiler import program_stats as _pstats
from ..profiler import recompile as _recompile
from ..profiler.metrics import registry as _registry
from ..profiler.sink import _detect_rank
from .paged_cache import PagePool
from .sched import SCHED_POLICIES, ChunkScheduler, SpecKController
from .spec import (DraftRunner, SpecConfig, _greedy, _sample_rows,
                   make_spec_tick)

__all__ = ["ServingConfig", "ServingEngine", "Request"]

#: engine ids stamped on every event (``eng``), so the timelines of
#: engines sharing the process (and, with the rank folded in, the merged
#: logs of several processes) do not alias
_ENGINE_SEQ = iter(range(1 << 20))

#: attention_kernel values: the two ragged names are the unified tick
#: (the reference's XLA and Pallas spellings of it; here the pools' device
#: picks the kernel or its plain version), "legacy" the two-dispatch
#: engine kept as the baseline of the dispatch collapse
ATTENTION_KERNELS = ("ragged-xla", "ragged-pallas", "legacy")

#: the KV payloads' dtype names (the reference's numpy spellings)
_KV_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
             torch.int8: "int8"}


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
    attention_kernel: Optional[str] = None   # None | ATTENTION_KERNELS
    spec: Optional[SpecConfig] = None        # speculative decoding


@dataclass
class Request:
    rid: int
    prompt: np.ndarray               # current prompt (grows on preemption)
    max_new: int                     # tokens still wanted (shrinks on preempt)
    key: np.ndarray                  # uint32[2] sampling key (position folds)
    out: List[int] = field(default_factory=list)
    done: bool = False
    hold: bool = False               # stop after the first token (export)
    submit_t: float = 0.0
    queue_t: float = 0.0             # (re)queue anchor: submit, or requeue
    preempts: int = 0
    first_token_t: Optional[float] = None
    orig_prompt_len: int = 0
    canceled: bool = False
    temperature: Optional[float] = None   # per-request sampling overrides
    top_k: Optional[int] = None           #   (None -> engine config default)
    top_p: Optional[float] = None
    trace_id: Optional[str] = None        # cross-host trace id (events)


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
        if cfg.prefill_chunks_per_tick < 1:
            raise ValueError("prefill_chunks_per_tick must be >= 1")
        if cfg.scheduler not in SCHED_POLICIES:
            raise ValueError(
                f"unknown scheduler {cfg.scheduler!r}; expected one of "
                f"{SCHED_POLICIES}")
        kernel = cfg.attention_kernel
        if kernel is not None and kernel not in ATTENTION_KERNELS:
            raise ValueError(
                f"unknown attention kernel {kernel!r}; expected one of "
                f"{ATTENTION_KERNELS}")
        self._spec = cfg.spec
        if self._spec is not None:
            if kernel == "legacy":
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
        self._legacy = kernel == "legacy"
        if self._legacy and cfg.scheduler != "fifo":
            raise ValueError(
                "scheduler policies need the unified tick; "
                "attention_kernel='legacy' is the pre-unification "
                "bench baseline and keeps fifo chunk selection")
        self.attention_kernel = kernel
        self.config = cfg
        self.model_config = mcfg
        self.device = model.device
        self._eng_id = (_detect_rank() << 20) | next(_ENGINE_SEQ)
        self._tick_site = _recompile.unique_site("serving.tick")
        # each site's counted first dispatch (program_stats.dispatch)
        self._program_counts: Dict[str, dict] = {}
        self._stacked, self._other = model._decode_state()
        self._dtype = self._other["embeddings.wte.weight"].dtype
        kv_map = {None: self._dtype, "f32": torch.float32,
                  "bf16": torch.bfloat16, "int8": torch.int8}
        if cfg.kv_dtype not in kv_map:
            raise ValueError(
                f"unknown kv_dtype {cfg.kv_dtype!r}; expected one of "
                "None (model dtype), 'f32', 'bf16', 'int8'")
        kv_dtype = kv_map[cfg.kv_dtype]
        if self._legacy and kv_dtype != self._dtype:
            raise ValueError(
                f"kv_dtype={cfg.kv_dtype!r} needs the unified tick; "
                "attention_kernel='legacy' is the pre-unification "
                "bench baseline and keeps the model-dtype pool")
        self._kv_name = _KV_NAMES[kv_dtype]
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
        # held requests whose first token the host holds: exportable
        self._held_ready: set = set()
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
        if self._legacy:
            # the pre-unification pair: a decode tick and a prefill program
            self._prefill_site = _recompile.unique_site("serving.prefill")
            self._tick = self._make_legacy_tick()
            self._prefill = self._make_prefill_chunk()

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
        # per-admission-cycle latches of the draft and verify events
        self._spec_started = [False] * ns
        self._spec_verifying = [False] * ns
        self._draft = DraftRunner(spec.draft_model, ns,
                                  self.pool.slot_capacity, self._spec_k,
                                  self.prefill_chunk, self.pool,
                                  sampling=self._spec_sampling,
                                  records=self._program_counts)
        self._zero_drafts = torch.zeros(ns * self._spec_k, dtype=torch.long,
                                        device=self.device)
        self._spec_tick = make_spec_tick(mcfg, ns, self._spec_k,
                                         self.prefill_chunk,
                                         sampling=self._spec_sampling,
                                         site=self._tick_site,
                                         records=self._program_counts)

    @property
    def compiled_sites(self) -> Tuple[str, ...]:
        """Recompile-telemetry site names of the hot-path dispatches: the
        tick, in spec mode the draft tick beside it, in legacy mode the
        prefill program beside it."""
        if self._legacy:
            return (self._tick_site, self._prefill_site)
        if self._spec is not None:
            return (self._tick_site, self._draft.site)
        return (self._tick_site,)

    def record_program_stats(self) -> Dict[str, dict]:
        """Fold the counted first dispatch of every hot-path site that has
        dispatched (``compiled_sites``) into the profiler's program
        inventory (``program_stats.record_counted``: FLOPs, bytes,
        categories, the wall time of that dispatch) and register each
        site's range as its trace module. Returns {site: stats-dict}."""
        return {site: _pstats.record_counted(site, rec).to_dict()
                for site, rec in sorted(self._program_counts.items())}

    @contextmanager
    def trace_window(self, log_dir: Optional[str] = None,
                     peak_flops: Optional[float] = None):
        """A parsed device-trace window over the ticks driven inside the
        block::

            with eng.trace_window() as cap:
                for _ in range(8):
                    eng.step()
                eng.drain(0)          # read the ticks' tokens
            cap.summary               # per-tick device timeline

        Records the sites' programs first (``record_program_stats``: the
        module -> site join and the FLOPs of the MFU ledger) and again
        before the window closes, for a site first dispatched inside it;
        then wraps the block in ``device_trace.capture`` with ``steps``
        set to the measured tick count (the ``serving/ticks`` counter's
        delta), so per-step rows read per tick."""
        from ..profiler import device_trace as _dtrace

        self.record_program_stats()
        t0 = _registry().counter("serving/ticks").value
        cap = _dtrace.capture(log_dir=log_dir, peak_flops=peak_flops,
                              label=f"serving.eng{self._eng_id}")
        with cap:
            yield cap
            cap.steps = int(
                _registry().counter("serving/ticks").value - t0) or None
            self.record_program_stats()

    def _emit(self, kind: str, rid: int, **attrs) -> None:
        """One lifecycle event; attrs are plain ints, floats and strings
        (never numpy scalars or tensors: the sink writes JSON)."""
        req = self._requests.get(rid)
        if req is not None and req.trace_id is not None:
            attrs.setdefault("trace", req.trace_id)
        _events.emit(kind, rid=rid, eng=self._eng_id, **attrs)

    def latency_stats(self, window_s: Optional[float] = None) -> dict:
        """Rolling-window TTFT/TPOT p50/p90/p95/p99 over requests finished
        in the last ``window_s`` seconds (None: all still in the event
        ring). Reads the process-global log: other live engines' requests
        count too; ``profiler.latency_table()`` rows split them by
        ``eng``."""
        return _events.request_latency_stats(window_s=window_s)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int,
               key: Optional[np.ndarray] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               hold_after_prefill: bool = False,
               trace_id: Optional[str] = None) -> int:
        """Queue one request; returns its id. ``temperature``/``top_k``/
        ``top_p`` override the config's sampling params for this request
        (ignored under greedy decode); ``key`` (uint32[2], a
        ``jax.random``-style key) defaults to ``fold_in(PRNGKey(seed),
        rid)`` under sampling; greedy decode draws nothing and keeps a
        zero key. ``trace_id`` is stamped as ``trace`` on every event of
        the request and rides its handoff.

        ``hold_after_prefill``: prefill the prompt (chunked, prefix-cached,
        preemptible as any other) and read the first token, then park the
        slot instead of decoding (``held_ready``) until ``export_held``
        and ``release_exported`` hand it to a decode engine."""
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
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      hold=bool(hold_after_prefill), trace_id=trace_id)
        self._requests[rid] = req
        self._queue.append(req)
        _registry().counter("serving/prompt_tokens").add(t0)
        self._emit("submit", rid, prompt_tokens=int(t0),
                   max_new=int(max_new_tokens))
        return rid

    def step(self) -> bool:
        """One scheduler iteration: bound the in-flight window, admit into
        free slots, select prompt chunks, grow pages (preempting on
        exhaustion), dispatch ONE unified tick (legacy mode: the prefill
        programs of the chunks, then the decode tick). Returns whether
        any device work was dispatched."""
        self._sched.on_tick()
        self._drain(self.config.max_inflight)
        self._admit()
        if self._legacy:
            dispatched = self._prefill_chunks()
            self._grow_pages()
            dispatched = self._dispatch_legacy_tick() or dispatched
        else:
            chunks = self._collect_chunks()
            self._grow_pages()
            dispatched = (self._dispatch_spec(chunks) if self._spec is not None
                          else self._dispatch_unified(chunks))
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

    def cancel(self, rid: int, reason: str = "redispatch") -> bool:
        """Abandon a request wherever it stands (queued, resident or held
        ready), freeing its slot and pages without a result, and emit a
        ``cancel`` event with ``reason``. False for an unknown or finished
        one."""
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
        self._held_ready.discard(rid)
        req.done = True
        req.canceled = True
        req.out = []
        _registry().counter("serving/requests_canceled").add(1)
        self._emit("cancel", rid, reason=reason)
        return True

    # ------------------------------------------------------------------
    # KV handoff: a prefill engine exports a held request's pages, a
    # decode engine imports them. Pages move as raw pool content (int8
    # pools with their scales), through one gather and one device-to-host
    # copy out and one host-to-device copy and one index_copy_ a pool in.
    # Neither is a dispatch site: compiled_sites is unchanged.
    # ------------------------------------------------------------------
    def held_ready(self) -> Tuple[int, ...]:
        """rids submitted with ``hold_after_prefill`` whose prompt is
        prefilled and whose first token the host holds: exportable."""
        return tuple(sorted(self._held_ready))

    def export_held(self, rid: int) -> dict:
        """The handoff payload of a held-ready request: its current
        prompt, remaining budget, sampling state, first token, and the
        content of the ``ceil(t0 / page_size)`` pages holding the prompt's
        KV (``k``/``v`` [L, n, ps, NH, D]; bf16 as uint16 bits; int8 with
        ``k_scale``/``v_scale`` [L, n, NH]). Read-only: the slot stays
        resident until ``release_exported``, so a failed send can retry."""
        if rid not in self._held_ready:
            raise ValueError(f"request {rid} is not held-ready")
        t_span = time.perf_counter()
        req = self._requests[rid]
        slot = self._slot_rid.index(rid)
        pages = list(self.pool._held[slot])
        t0 = int(self._slot_len[slot])
        assert t0 == req.prompt.shape[0], "held slot frontier != prompt"
        payload = {
            "prompt": np.asarray(req.prompt, np.int32),
            "orig_prompt_len": int(req.orig_prompt_len),
            "max_new": int(req.max_new),
            "first_token": int(req.out[0]),
            "key": np.asarray(req.key, np.uint32),
            "n_tokens": t0,
            "preempts": int(req.preempts),
            # the receiving pool must store the same representation
            "kv_dtype": self._kv_name,
        }
        payload.update(self._read_pages(pages))
        # sampling overrides travel only when set (absent: the decode
        # engine's defaults, as a local submit with None overrides)
        if req.temperature is not None:
            payload["temperature"] = float(req.temperature)
        if req.top_k is not None:
            payload["top_k"] = int(req.top_k)
        if req.top_p is not None:
            payload["top_p"] = float(req.top_p)
        if req.trace_id is not None:
            payload["trace_id"] = req.trace_id
        nbytes = self._page_bytes(payload)
        reg = _registry()
        reg.counter("serving/handoffs_out").add(1)
        reg.counter("serving/handoff_bytes_out").add(nbytes)
        self._emit("handoff_out", rid, slot=int(slot), tokens=t0,
                   pages=len(pages), bytes=nbytes,
                   ms=round((time.perf_counter() - t_span) * 1e3, 3))
        return payload

    def release_exported(self, rid: int) -> None:
        """Drop a held request after its payload shipped: publish its
        prompt's full pages in the local prefix index, release the slot,
        and mark the request done here (the decode engine finishes it)."""
        if rid not in self._held_ready:
            raise ValueError(f"request {rid} is not held-ready")
        req = self._requests[rid]
        slot = self._slot_rid.index(rid)
        self._insert_prefix(slot, req.prompt, int(self._slot_len[slot]))
        self._sched.note_release(slot)
        self.pool.release_slot(slot)
        self._slot_rid[slot] = None
        self._slot_len[slot] = 0
        self._held_ready.discard(rid)
        req.done = True

    def admit_prefilled(self, payload: dict) -> Optional[int]:
        """Admit an exported payload: bind a free slot, allocate the
        prompt's pages, write the payload's content (and scales) into
        them and seed the decode state where a local prefill would have
        left it (frontier at the prompt's length, one token emitted,
        ``last_tok`` the first token), so the next tick decodes it as an
        ordinary row. Returns the local rid, or None when no slot or pages
        are free now (the caller retries; an import never preempts)."""
        t_span = time.perf_counter()
        p = np.asarray(payload["prompt"], np.int32).reshape(-1)
        t0 = p.shape[0]
        max_new = int(payload["max_new"])
        first_tok = int(payload["first_token"])
        tid = payload.get("trace_id")
        tid = str(tid) if tid is not None else None
        src_dtype = payload.get("kv_dtype")
        if src_dtype is not None and str(src_dtype) != self._kv_name:
            raise ValueError(
                f"handoff payload carries {str(src_dtype)!r} KV pages "
                f"but this pool stores {self._kv_name} — prefill and "
                "decode groups must serve the same kv_dtype (silently "
                "casting would corrupt the cache)")
        cap = self.pool.slot_capacity
        if t0 + max_new - 1 > cap:
            raise ValueError(
                f"handoff needs {t0 + max_new - 1} cache positions; "
                f"slot capacity is {cap}")
        free = [s for s, r in enumerate(self._slot_rid) if r is None]
        if not free:
            return None
        slot = free.pop()
        n_pages = self.pool.pages_for(t0)
        if n_pages != payload["k"].shape[1]:
            raise ValueError(
                f"payload carries {payload['k'].shape[1]} pages for a "
                f"{t0}-token prompt; expected {n_pages}")
        arrays = self._page_arrays(payload, n_pages)
        if not self.pool.grow_slot(slot, n_pages):
            return None
        rid = self._next_rid
        self._next_rid += 1
        now = time.perf_counter()
        req = Request(rid=rid, prompt=p, max_new=max_new,
                      key=np.asarray(payload["key"], np.uint32),
                      out=[first_tok], submit_t=now, queue_t=now,
                      orig_prompt_len=int(payload["orig_prompt_len"]),
                      preempts=int(payload.get("preempts", 0)),
                      trace_id=tid)
        req.first_token_t = now
        self._requests[rid] = req
        self._slot_rid[slot] = rid
        self._slot_len[slot] = t0
        self._slot_prompt[slot] = t0
        self._slot_dispatched[slot] = 1
        self._slot_looked_up[slot] = True     # no prefill owed here
        self._admit_seq += 1
        self._slot_admit_seq[slot] = self._admit_seq
        self._slot_admit_t[slot] = now
        self._slot_wait_due[slot] = False     # no chunk ever opens here
        self._spec_reset(slot)
        self._keys[slot] = req.key
        c = self.config
        self._temps[slot] = c.temperature if \
            payload.get("temperature") is None else payload["temperature"]
        self._topks[slot] = c.top_k if payload.get("top_k") is None \
            else payload["top_k"]
        self._topps[slot] = c.top_p if payload.get("top_p") is None \
            else payload["top_p"]
        self._write_pages(self.pool._held[slot], arrays)
        self._set_last_tok(slot, torch.tensor([first_tok],
                                              device=self.device))
        nbytes = self._page_bytes(payload)
        reg = _registry()
        reg.counter("serving/handoffs_in").add(1)
        reg.counter("serving/handoff_bytes_in").add(nbytes)
        self._emit("handoff_in", rid, slot=int(slot), tokens=int(t0),
                   pages=int(n_pages), bytes=nbytes,
                   ms=round((time.perf_counter() - t_span) * 1e3, 3))
        # the first token may already meet a stop condition
        eos = self.config.eos_token_id
        if eos is not None and first_tok == eos:
            self._finish(slot, rid, reason="eos")
        elif len(req.out) >= req.max_new:
            self._finish(slot, rid, reason="max_new")
        return rid

    def _page_bytes(self, payload: dict) -> int:
        return int(sum(payload[k].nbytes for k in
                       ("k", "v") + (("k_scale", "v_scale")
                                     if self.pool.quantized else ())))

    def _set_last_tok(self, slot: int, tok: torch.Tensor) -> None:
        """``last_tok[slot] = tok`` without touching the old tensor, which
        an in-flight tick may still hand to the host."""
        last = self._last_tok.clone()
        last[slot:slot + 1] = tok
        self._last_tok = last

    def _pool_views(self):
        """The pools as tensors of their storage bits (bf16 as int16, so
        the host holds them in numpy)."""
        k, v = self.pool.k, self.pool.v
        if k.dtype == torch.bfloat16:
            return k.view(torch.int16), v.view(torch.int16)
        return k, v

    def _read_pages(self, pages) -> dict:
        """The content of ``pages``: one gather from each pool into one
        device buffer and one device-to-host copy. ``{"k", "v"}`` [L, n,
        ps, NH, D] (bf16 as uint16 bits), plus ``{"k_scale", "v_scale"}``
        [L, n, NH] f32 of an int8 pool."""
        pool = self.pool
        kt, vt = self._pool_views()
        idx = torch.as_tensor(np.asarray(pages, np.int64),
                              device=self.device)
        with torch.inference_mode():
            buf = torch.empty((2, kt.shape[0], len(pages)) + kt.shape[2:],
                              dtype=kt.dtype, device=self.device)
            torch.index_select(kt, 1, idx, out=buf[0])
            torch.index_select(vt, 1, idx, out=buf[1])
            host = buf.cpu().numpy()
            if kt.dtype == torch.int16:
                host = host.view(np.uint16)
            out = {"k": host[0], "v": host[1]}
            if pool.quantized:
                sc = torch.stack([pool.k_scale.index_select(1, idx),
                                  pool.v_scale.index_select(1, idx)])
                sc = sc.cpu().numpy()
                out["k_scale"], out["v_scale"] = sc[0], sc[1]
        return out

    def _page_arrays(self, payload: dict, n: int) -> dict:
        """A payload's page content (and an int8 pool's scales) as host
        arrays in this pool's storage type, checked before anything is
        bound: ``n`` pages of this pool's page shape, and bf16 pages as
        their 2-byte bits (uint16, int16 or ml_dtypes bfloat16) — a
        float16 or other 2-byte array would otherwise be reinterpreted as
        garbage. Raises ValueError."""
        pool = self.pool
        kt, _ = self._pool_views()
        np_dtype = {torch.float32: np.float32, torch.int16: np.int16,
                    torch.int8: np.int8}[kt.dtype]
        shape = (kt.shape[0], n) + tuple(kt.shape[2:])
        out = {}
        for key in ("k", "v"):
            a = np.asarray(payload[key])
            if kt.dtype == torch.int16:
                if a.dtype not in (np.uint16, np.int16) and \
                        a.dtype.name != "bfloat16":
                    raise ValueError(
                        "bf16 pages travel as uint16 bits (or ml_dtypes "
                        f"bfloat16), got {a.dtype}")
                a = a.view(np.int16)
            if a.shape != shape:
                raise ValueError(f"payload {key!r} pages have shape "
                                 f"{a.shape}; this pool takes {shape}")
            # writable too: torch.from_numpy warns on a read-only array
            out[key] = np.require(a, np_dtype, "CW")
        if pool.quantized:
            for key in ("k_scale", "v_scale"):
                if key not in payload:
                    raise ValueError(f"int8 pages without their scales "
                                     f"({key!r} missing)")
                a = np.asarray(payload[key], np.float32)
                if a.shape != shape[:2] + (pool.num_heads,):
                    raise ValueError(f"payload {key!r} has shape "
                                     f"{a.shape}")
                out[key] = np.require(a, requirements="CW")
        return out

    def _write_pages(self, pages, arrays: dict) -> None:
        """Write checked page content (``_page_arrays``) into ``pages``:
        one host-to-device copy and one ``index_copy_`` a pool, of the
        payload's pages only. ``pages``: a slot's held pages (a request
        handoff) or freshly allocated index pages (a migrated chain)."""
        pool = self.pool
        kt, vt = self._pool_views()
        dst = [(kt, "k"), (vt, "v")]
        if pool.quantized:
            dst += [(pool.k_scale, "k_scale"), (pool.v_scale, "v_scale")]
        with torch.inference_mode():
            d = torch.as_tensor(np.asarray(pages, np.int64),
                                device=self.device)
            for t, key in dst:
                t.index_copy_(1, d, torch.from_numpy(arrays[key]).to(
                    self.device))
        if pool.quantized:
            # the import just wrote these scale rows: the next tick's
            # fresh-page reset must not zero them
            for pg in pages:
                pool.claim_fresh(int(pg))

    # ------------------------------------------------------------------
    # hot prefix-chain migration: the handoff's representation (raw page
    # content, int8 with scales) for a cached chain, written by the same
    # page writer
    # ------------------------------------------------------------------
    def export_prefix_chain(self, tokens) -> Optional[dict]:
        """Payload replicating this engine's cached prefix chain of
        ``tokens`` (full indexed pages only, at most one slot's worth), or
        None when nothing is cached (an evicted chain is a missed
        migration, not an error)."""
        pool = self.pool
        if pool.prefix is None:
            return None
        toks = np.asarray(tokens, np.int32).reshape(-1)
        pages, _ = pool.prefix.chain_pages(toks)
        pages = pages[:pool.pages_per_slot]
        if not pages:
            return None
        n_tok = len(pages) * pool.page_size
        payload = {"tokens": toks[:n_tok], "n_tokens": n_tok,
                   "kv_dtype": self._kv_name}
        payload.update(self._read_pages(pages))
        return payload

    def import_prefix_chain(self, payload: dict) -> int:
        """Index a migrated chain in this engine's trie under the normal
        refcount rules: allocate fresh pages (a plain allocation: a
        speculative import never evicts local cache), write the content,
        insert, then drop the import's temporary reference (a chunk the
        trie already held keeps its first page; the import's copy goes
        back to the pool). Returns the tokens newly indexed (0: no room,
        or nothing new). Raises ValueError on a payload this pool must
        not store."""
        pool = self.pool
        if pool.prefix is None:
            return 0
        toks = np.asarray(payload["tokens"], np.int32).reshape(-1)
        src_dtype = payload.get("kv_dtype")
        if src_dtype is not None and str(src_dtype) != self._kv_name:
            raise ValueError(
                f"migrated chain carries {str(src_dtype)!r} pages but "
                f"this pool stores {self._kv_name}")
        n_pages = int(payload["k"].shape[1])
        ps = pool.page_size
        if n_pages < 1 or n_pages > pool.pages_per_slot or \
                n_pages * ps != toks.shape[0] or \
                payload["k"].shape != payload["v"].shape:
            raise ValueError("inconsistent migrated chain payload")
        arrays = self._page_arrays(payload, n_pages)
        pages = pool.allocator.alloc(n_pages)
        if pages is None:
            return 0
        self._write_pages(pages, arrays)
        new = pool.prefix.insert(toks, pages)
        # newly indexed pages stay at refcount 1 (the index's); duplicates
        # of cached chunks reach 0 and go back to the pool
        pool.allocator.free(pages)
        pool.migrated_pages.update(
            p for p in pages if pool.allocator.refcount(p) > 0)
        return new * ps

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
                    self._emit("first_token", rid, slot=int(slot))
                if req.hold:
                    # the first token is the last thing this engine
                    # computes for it: park it for export (its stops are
                    # the decode engine's business)
                    self._held_ready.add(rid)
                    continue
                eos = self.config.eos_token_id
                if eos is not None and tok == eos:
                    self._finish(slot, rid, reason="eos")
                elif len(req.out) >= req.max_new:
                    self._finish(slot, rid, reason="max_new")

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
        self._spec_started[slot] = False
        self._spec_verifying[slot] = False

    def _finish(self, slot: int, rid: int, reason: str = "max_new") -> None:
        req = self._requests[rid]
        req.done = True
        self._held_ready.discard(rid)
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
        tokens = len(req.out)
        ttft = tpot = None
        if req.first_token_t is not None:
            ttft = (req.first_token_t - req.submit_t) * 1000.0
            tpot = (time.perf_counter() - req.first_token_t) * 1000.0 \
                / max(tokens - 1, 1)
            self._sched.note_finish(ttft, tpot)
            reg.histogram("serving/tpot_ms").observe(tpot)
        self._emit("finish", rid, tokens=tokens, reason=reason,
                   preempts=int(req.preempts),
                   ttft_ms=None if ttft is None else round(ttft, 3),
                   tpot_ms=None if tpot is None else round(tpot, 3))

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
            self._emit("admit", req.rid, slot=int(slot))
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
        remote = 0
        if full_pages:
            self.pool.share_into_slot(slot, full_pages)
            hit = len(full_pages) * self.pool.page_size
            if self.pool.migrated_pages:
                # tokens served off pages that arrived by chain migration
                remote = sum(1 for p in full_pages
                             if p in self.pool.migrated_pages) \
                    * self.pool.page_size
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
                    self._emit("cow_copy", req.rid, slot=int(slot),
                               tokens=int(lcp))
            finally:
                self.pool.allocator.free([src])
        self._slot_len[slot] = hit
        if hit:
            reg.counter("serving/prefix_hit_tokens").add(hit)
            if remote:
                reg.counter("serving/prefix_hit_tokens_remote").add(remote)
            self._emit("prefix_hit", req.rid, slot=int(slot),
                       tokens=int(hit), remote_tokens=int(remote))

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
        finished, not held, emissions still owed."""
        out = []
        for s, rid in enumerate(self._slot_rid):
            if rid is None:
                continue
            req = self._requests[rid]
            if req.hold:
                continue    # a held slot stops at its first token
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
        # the window was drained before preemption: req.out is current
        self._emit("preempt", rid, slot=int(victim),
                   generated=len(req.out))
        if not self._slot_looked_up[victim]:
            self._observe_wait(req)
        req.prompt = np.concatenate(
            [req.prompt, np.asarray(req.out, np.int32)])
        req.max_new -= len(req.out)
        req.out = []
        req.preempts += 1
        # a held-ready victim's first token moved into its prompt: the
        # requeued cycle re-prefills and holds again
        self._held_ready.discard(rid)
        req.queue_t = time.perf_counter()
        self._insert_prefix(victim, req.prompt, int(self._slot_len[victim]))
        self._queue.appendleft(req)
        self._spec_reset(victim)
        self._sched.note_release(victim)
        self.pool.release_slot(victim)
        self._slot_rid[victim] = None
        self._slot_len[victim] = 0
        _registry().counter("serving/preemptions").add(1)
        self._emit("requeue", rid, prompt_tokens=int(req.prompt.shape[0]),
                   max_new=int(req.max_new))
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
            self._emit("chunk", rid, slot=int(s), start=int(start),
                       end=int(end), final=bool(end >= t0))
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

        def tick():
            (pf_d, pos_d, lim_d, tab_d, p0_d, len_d, six_d, emit_d,
             fresh_d, *law_d) = _to_device(
                self.device, pf_toks, tok_pos[:n_tok], tok_limit[:n_tok],
                row_tab[:n_row], row_pos0[:n_row], row_len[:n_row],
                sample_ix, emit, fresh, *law)
            tokens = torch.cat([self._last_tok, pf_d.long()]) if chunks \
                else self._last_tok
            # a decode-only tick runs at its own, shorter shape
            _recompile.mark_trace(self._tick_site, pool.k, tab_d, pos_d,
                                  tokens)
            logits = gpt_ragged_apply(
                self.model_config, self._stacked, self._other,
                pool.k, pool.v, tokens, pos_d, lim_d, tab_d,
                p0_d, len_d, six_d.long(), decode_rows=ns,
                chunk_width=self.prefill_chunk,
                **pool.tick_scales(fresh_d))[0]
            tok = self._sample_tok(logits, *law_d)
            self._last_tok = torch.where(emit_d.bool(), tok, self._last_tok)
            return tok

        with torch.inference_mode():
            tok = _pstats.dispatch(self._program_counts, self._tick_site,
                                   tick)
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
                    if not self._spec_started[s]:
                        self._spec_started[s] = True
                        self._emit("draft", rid, slot=s, pos=lo)
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
                if not self._spec_verifying[s]:
                    self._spec_verifying[s] = True
                    self._emit("verify", req.rid, slot=s, k=int(ks))
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
            finished = None
            for j in range(a + 1):
                tok = int(toks[s, j])
                req.out.append(tok)
                emitted += 1
                reg.counter("serving/tokens_generated").add(1)
                if req.first_token_t is None:
                    req.first_token_t = now
                    reg.histogram("serving/ttft_ms").observe(
                        (now - req.submit_t) * 1000.0)
                    self._emit("first_token", rid, slot=s)
                if eos is not None and tok == eos:
                    finished = "eos"
                    break
                if len(req.out) >= req.max_new:
                    finished = "max_new"
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
                    self._emit("accept", rid, slot=s, accepted=gained,
                               drafted=ks)
                if s in gen_slots or s in chained:
                    # the chained tick's seed assumed the whole accepted
                    # prefix and the correction were emitted and the slot
                    # keeps ticking; anything else (EOS, the budget)
                    # invalidates it and the slot catches up next step
                    if (pend_new is not None and bool(pend_new["valid"][s])
                            and finished is None and emitted == a + 1
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
                if finished is None and ks:
                    # rewind: pages past the new frontier (+1 position of
                    # headroom for the next write) go back to the pool;
                    # refcounts keep shared pages alive
                    self.pool.shrink_slot(s, self.pool.pages_for(
                        int(self._slot_len[s]) + 1))
            self._slot_dispatched[s] = len(req.out)
            if finished is not None:
                self._finish(s, rid, reason=finished)
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

    # ------------------------------------------------------------------
    # legacy two-dispatch mode (attention_kernel="legacy"): the
    # pre-unification engine, a prefill program per chunk and a decode
    # tick per step, kept as the baseline of the dispatch collapse
    # ------------------------------------------------------------------
    def _prefill_chunks(self) -> bool:
        """Advance prefilling slots by up to ``prefill_chunks_per_tick``
        chunks, each dispatched at once, oldest admission first."""
        any_dispatch = False
        for _ in range(self.config.prefill_chunks_per_tick):
            s = self._next_prefill_slot({})
            if s is None:
                break
            chunk = self._open_chunk(s, {})
            if chunk is None:
                break
            self._dispatch_prefill_chunk(*chunk)
            any_dispatch = True
        return any_dispatch

    def _dispatch_prefill_chunk(self, s: int, rid: int, start: int,
                                end: int, t0: int) -> None:
        req = self._requests[rid]
        toks = np.zeros((1, self.prefill_chunk), np.int32)
        toks[0, :end - start] = req.prompt[start:end]
        law = (req.key[None], self._temps[s:s + 1], self._topks[s:s + 1],
               self._topps[s:s + 1]) \
            if self.config.decode == "sampling" else ()
        with torch.inference_mode():
            toks_d, p0_d, tl_d, row_d, *law_d = _to_device(
                self.device, toks, np.array([start], np.int32),
                np.array([t0], np.int32), self.pool.tables[s], *law)
            tok0 = self._prefill(self._stacked, self._other, self.pool.k,
                                 self.pool.v, toks_d.long(), p0_d, tl_d,
                                 row_d, *law_d)
        _registry().counter("serving/prefill_chunks").add(1)
        self._emit("chunk", rid, slot=int(s), start=int(start), end=int(end),
                   final=bool(end >= t0))
        if end >= t0:                # the final chunk: tok0 is real
            self._set_last_tok(s, tok0)
            self._inflight.append(_Inflight(tok0, [(0, s, rid)]))
            self.max_inflight_seen = max(self.max_inflight_seen,
                                         len(self._inflight))
            self._slot_dispatched[s] = 1
            self._slot_len[s] = t0
            _registry().counter("serving/prefills").add(1)
        else:
            self._slot_len[s] = end
        # publish the pages this chunk completed
        self._insert_prefix(s, req.prompt, int(self._slot_len[s]))

    def _dispatch_legacy_tick(self) -> bool:
        """The fixed-shape decode tick: one row per slot at its frontier,
        whether it ticks or not (idle slots write to the null page through
        their zeroed table rows; a prefilling slot's row writes at its
        frontier, which its next chunk overwrites)."""
        ticking = self._ticking_slots()
        if not ticking:
            return False
        law = (self._keys, self._temps, self._topks, self._topps) \
            if self.config.decode == "sampling" else ()
        with torch.inference_mode():
            tab_d, pos_d, *law_d = _to_device(
                self.device, self.pool.tables, self._slot_len, *law)
            tok = self._tick(self._stacked, self._other, self.pool.k,
                             self.pool.v, tab_d, pos_d, self._last_tok,
                             *law_d)
        self._last_tok = tok
        self._inflight.append(_Inflight(
            tok, [(s, s, self._slot_rid[s]) for s in ticking]))
        self.max_inflight_seen = max(self.max_inflight_seen,
                                     len(self._inflight))
        for s in ticking:
            self._slot_len[s] += 1
            self._slot_dispatched[s] += 1
        self._tick_gauges(ticking, [])
        return True

    def _make_legacy_tick(self):
        """The legacy decode tick: ``[num_slots, 1]`` decode rows of
        ``gpt_ragged_apply`` at each slot's frontier ``pos`` with write
        limit ``slot_capacity`` (a slot that finished at exactly its
        capacity rides with ``pos == cap``: its write goes to the null
        page and its position row is clamped to the table's last, as the
        reference's gather clamps it). Samples every row; the sampling
        law folds each key by ``pos + 1``."""
        mcfg = self.model_config
        ns = self.config.num_slots
        site = self._tick_site
        dev = self.device
        rows = torch.arange(ns, device=dev)
        ones = torch.ones(ns, dtype=torch.int32, device=dev)
        limit = torch.full((ns,), self.pool.slot_capacity,
                           dtype=torch.int32, device=dev)

        def tick(stacked, other, kpool, vpool, tab, pos, tok, *law):
            _recompile.mark_trace(site, kpool, tab, pos, tok)
            logits = gpt_ragged_apply(
                mcfg, stacked, other, kpool, vpool, tok, pos, limit, tab,
                pos, ones, rows, decode_rows=ns, chunk_width=0)[0]
            if not law:
                return self._sample_tok(logits)
            keys, temps, top_ks, top_ps = law
            return self._sample_tok(logits, pos + 1, keys, temps, top_ks,
                                    top_ps)

        return _pstats.site_fn(self._program_counts, site, tick)

    def _make_prefill_chunk(self):
        """The legacy prefill program: one chunk of one slot through
        ``gpt_paged_suffix_apply`` at the fixed width ``prefill_chunk``;
        the token it samples (its key folded by the prompt's length) is
        real only on the prompt's last chunk."""
        mcfg = self.model_config
        site = self._prefill_site
        w = self.prefill_chunk

        def prefill(stacked, other, kpool, vpool, tokens, pos0, true_len,
                    page_row, *law):
            _recompile.mark_trace(site, tokens, kpool, pos0)
            li = torch.clamp(true_len - 1 - pos0, 0, w - 1)
            logits = gpt_paged_suffix_apply(
                mcfg, stacked, other, kpool, vpool, tokens, pos0, true_len,
                page_row, li)[0]
            if not law:
                return self._sample_tok(logits)
            key, temp, top_k, top_p = law
            return self._sample_tok(logits, true_len, key, temp, top_k,
                                    top_p)

        return _pstats.site_fn(self._program_counts, site, prefill)

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
