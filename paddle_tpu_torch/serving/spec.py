"""Speculative decoding on the paged serving engine (mirrors
``paddle_tpu/serving/spec.py``).

A small **draft model** runs ``k`` tokens ahead of each resident slot,
then ONE target **verify tick** scores every slot's ``1 + k``-token row
through ``gpt_ragged_apply(spec_k=k)``: the slot rows attend as one
``[num_slots, 1 + k]`` group of the ragged kernel (a verify row is a
chunk-shaped row whose logits are kept at every position).

**Greedy acceptance** keeps the longest draft prefix equal to the
target's argmax, plus one correction token, so the emitted stream is the
target's own argmax stream: the plain engine's greedy stream.
**Sampled acceptance** is the rejection rule of
``ops.decoding.spec_rejection_sample``: accept draft token ``t`` with
probability ``min(1, p_tgt(t) / p_drf(t))``, else resample from the
normalized residual ``max(0, p_tgt - p_drf)``. Both distributions are
filtered by the same per-request temperature/top-k/top-p, so the law at
every position is the plain engine's ``categorical(fold_in(key, pos),
lp)``: a twin draft always accepts the plain draw, and a draft with
disjoint support always rejects into it.

- **Draft tick** (``make_draft_tick``, held by ``DraftRunner``): the draft
  KV lives in draft-dtype pools ``[L_d, num_pages, page_size, NH_d, D_d]``
  addressed through per-slot draft page tables
  (``paged_cache.AuxPageTable``) on the target pool's allocator, so draft
  and target pages compete in one refcounted economy and the engine
  reclaims draft pages before it preempts anyone. Pad and overflow writes
  go to page 0, the null page. One call does both draft duties of a
  step: a ``feed`` stage catches slots up to the target's accepted
  frontier (chunk-shaped rows), then a ``generate`` stage runs the draft
  steps. Its attention is plain PyTorch over the gathered table view
  ``pool[dtab]`` under the causal mask, as in the reference, where it is
  not a Pallas kernel either. The sampling build samples each draft token
  under the slot's own law, returns the filtered draft distributions the
  rejection rule divides by, and takes a **chained frontier**: the
  previous verify tick's device outputs (``tok_m``, ``acc``) and a chain
  mask, from which it gathers the seed ``tok_m[s, acc]`` at position
  ``pos0 + acc + 1`` on the device, so the engine can enqueue it before
  the verify result reaches the host. Its generate stage runs ``k + 1``
  steps: step 0 rewrites the token at ``seed_pos - 1`` (the position a
  fully accepted row emitted but never wrote; null-routed otherwise).
- **Verify tick** (``make_spec_tick``): the unified mixed-row tick with a
  draft section. Flat token layout ``[ns last_tok | ns*k drafts |
  chunks]``. Four branches, chosen on the host from ``has_drafts`` and
  ``has_chunks`` (never from a device value): without drafts it runs the
  exact non-speculative layout, without chunks it skips the prefill rows.

**Rewind**: the rejected tail's KV writes land in pages only this slot
holds, so the engine truncates the frontier and returns pages past the
new length (``shrink_slot`` on the target tables and on the draft's
``AuxPageTable``). The draft cache needs no repair: its own speculation
wrote the accepted tokens' KV, and the correction token arrives as the
next step's seed.

Both ticks run inside their site's ``record_function`` range and count
their first dispatch into the engine's program records
(``profiler/program_stats.py``). Both mark their arguments at a recompile
site (``profiler/recompile.py``): the verify tick at the engine's
``serving.tick`` site,
with the shapes of the branch it runs, and the draft tick at its own
``serving.draft`` site, with the stages it runs (feed, generate, a
chained frontier). ``trace_counts()`` of each is the number of distinct
shapes it ran: where the reference compiles one program holding every
branch, each branch here runs at its own shape.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core import random as _random
from ..models.gpt import _ln, gpt_block_body, gpt_ragged_apply
from ..ops.decoding import (apply_top_k_top_p_per_row, spec_accept_length,
                            spec_rejection_sample)
from ..profiler import program_stats as _pstats
from ..profiler import recompile as _recompile
from .paged_cache import AuxPageTable

__all__ = ["SpecConfig", "DraftRunner", "make_draft_tick", "make_spec_tick"]


@dataclass
class SpecConfig:
    """Speculative-decoding knobs for ``ServingConfig.spec``.

    ``draft_model``: a dense ``GPT`` sharing the target's vocab, with
    ``max_seq_len`` at least the target's; its quality moves only the
    accept rate, never the stream. ``k``: draft tokens a verify tick
    offers per slot; each slot's depth is clamped every tick by its
    remaining token budget and page headroom (down to 0, a plain decode
    row). ``adaptive``: each slot's depth follows its accept-rate EWMA
    (alpha ``ewma_alpha``; ``sched.SpecKController``) instead of always
    offering ``k``. ``reprobe_every``: a slot stuck at depth 0 drafts one
    token every this many ticks, the period doubling on consecutive
    rejected probes (0 disables). ``overlap`` (sampling only): enqueue the
    next draft tick, chained on the verify tick's device outputs, before
    the host reads the verify result."""

    draft_model: object
    k: int = 4
    adaptive: bool = False
    ewma_alpha: float = 0.5
    reprobe_every: int = 64
    overlap: bool = False


class DraftRunner:
    """The draft model's state and its tick.

    Host side: ``len[s]`` is the slot's draft frontier (paged positions
    ``0..len[s]-1`` hold the accepted sequence's KV) and ``aux`` the
    slot's draft page table on the shared pool allocator. Device side:
    the paged draft pools, updated in place by the tick. The engine owns
    scheduling (what to feed, who generates) and the frontier
    bookkeeping."""

    def __init__(self, draft_model, num_slots: int, capacity: int,
                 k: int, feed_width: int, pool, sampling: bool = False,
                 records: Optional[dict] = None):
        cfg = draft_model.config
        self.config = cfg
        self.k = int(k)
        self.capacity = int(capacity)
        self.feed_width = int(feed_width)
        self.sampling = bool(sampling)
        self.pool = pool
        self.aux = AuxPageTable(pool, num_slots)
        self.stacked, self.other = draft_model._decode_state()
        wte = self.other["embeddings.wte.weight"]
        nh = cfg.num_heads
        shape = (cfg.num_layers, pool.num_pages, pool.page_size, nh,
                 cfg.hidden_size // nh)
        self.kc = torch.zeros(shape, dtype=wte.dtype, device=wte.device)
        self.vc = torch.zeros_like(self.kc)
        self.len = np.zeros(num_slots, np.int64)
        self.site = _recompile.unique_site("serving.draft")
        self.tick = make_draft_tick(cfg, num_slots, capacity, k, feed_width,
                                    pool.page_size, sampling=sampling,
                                    site=self.site, records=records)

    def held_tokens(self, slot: int) -> int:
        """Draft positions covered by the slot's held pages."""
        return self.aux.slot_pages(slot) * self.pool.page_size

    def grow_for(self, slot: int, n_tokens: int) -> bool:
        """Best effort: hold enough draft pages for ``n_tokens`` positions.
        False when the pool can't cover it (the engine then speculates
        less; draft growth never escalates)."""
        return self.aux.grow_to(slot, min(int(n_tokens), self.capacity))

    def rewind(self, slot: int, n_tokens: int) -> int:
        """Truncate the draft frontier to ``n_tokens`` and return pages
        past it to the pool. Returns pages freed."""
        self.len[slot] = int(n_tokens)
        return self.aux.shrink_slot(slot, self.pool.pages_for(int(n_tokens)))

    def release_pages(self, slot: int) -> int:
        """Return ALL of the slot's draft pages (pressure decay, and the
        invalidation at admission, finish, preemption and cancel). Their
        content is gone, so the frontier resets to 0 and the slot
        re-feeds from scratch. Returns pages freed."""
        self.len[slot] = 0
        return self.aux.release_slot(slot)


def _head(x_last, other, wte):
    if "lm_head.weight" in other:
        return x_last @ other["lm_head.weight"]
    return x_last @ wte.T


def _greedy(logits):
    """The repo's one greedy spelling: argmax of the f32 log-softmax."""
    return torch.argmax(torch.log_softmax(logits.float(), dim=-1), dim=-1)


def _sample_rows(logits, keys, pos, temps, top_ks, top_ps):
    """The engine's per-row sampling law, all rows at once: temperature,
    per-row top-k/top-p, log-softmax, then ``categorical(fold_in(key,
    pos))``. The plain engine's ticks, the draft steps and the verify
    tick's plain branches all draw through it. Returns (tokens, lp)."""
    lg = logits.float() / torch.clamp(temps, min=1e-6)[:, None]
    lg = apply_top_k_top_p_per_row(lg, top_ks, top_ps)
    lp = torch.log_softmax(lg, dim=-1)
    return _random.categorical(_random.fold_in(keys, pos), lp), lp


def make_draft_tick(cfg, num_slots: int, capacity: int, k: int,
                    feed_width: int, page_size: int, sampling: bool = False,
                    site: str = "serving.draft",
                    records: Optional[dict] = None):
    """Build the draft tick. Position ``p`` of slot ``s`` lives at
    ``(dtab[s, p // ps], p % ps)`` of the paged pools; pad and overflow
    writes go to the null page 0, and attention reads the table view
    ``pool[dtab].reshape(ns, -1, NH, D)`` under the causal mask (null
    entries past the frontier are masked and weigh exactly 0).

    ``tick(stacked, other, kc, vc, dtab, feed_toks, feed_pos0, feed_len,
    gen_tok, gen_pos, has_feed, has_gen, law=None, chain=None)``:

      kc/vc       [L, num_pages, ps, NH, D] paged pools, updated in place
      dtab        [ns, pages_per_slot] int32 draft page tables
      feed_toks   [ns, F] catch-up tokens per slot
      feed_pos0   [ns]    first feed position per slot
      feed_len    [ns]    real feed tokens (0: nothing to feed)
      gen_tok     [ns]    generation seed (the slot's last accepted token)
      gen_pos     [ns]    its position; ``capacity`` for slots that do not
                          generate (null-routed writes, unread drafts)
      has_feed    bool    host flag: run the feed stage
      has_gen     bool    host flag: run the generate stage

    Greedy returns drafts ``[ns, k]``. The sampling build takes ``law =
    (keys [ns, 2], temps, top_ks, top_ps)`` and optionally ``chain =
    (tok_m [ns, 1+k], acc [ns], pos0 [ns], mask [ns] bool)``: chained rows
    seed with ``tok_m[s, acc]`` at ``pos0 + acc + 1``, gathered on the
    device. It returns (drafts ``[ns, k]``, the filtered draft
    distributions ``[ns, k, V]``). Every call runs inside the ``site``
    range and marks the stages it runs at the recompile ``site``; the
    first call is counted into ``records[site]`` (``program_stats``).
    """
    nh = cfg.num_heads
    hd = cfg.hidden_size // nh
    eps = cfg.layer_norm_eps
    msl = cfg.max_seq_len
    ns = num_slots
    cap = capacity
    ps = page_size
    f = feed_width
    scale = math.sqrt(hd)

    def body(stacked, other, kc, vc, dtab, feed_toks, feed_pos0, feed_len,
             gen_tok, gen_pos, has_feed, has_gen, law=None, chain=None):
        _recompile.mark_trace(site, kc, feed_toks if has_feed else None,
                              gen_tok if has_gen else None, chain)
        dev = kc.device
        wte = other["embeddings.wte.weight"]
        wpe = other["embeddings.wpe.weight"]
        rows = torch.arange(ns, device=dev)
        tab = dtab.long()
        slen = tab.shape[1] * ps
        key_pos = torch.arange(slen, device=dev)

        def layers(x, pg, off, qpos):
            # x [ns, T, h]; the tokens' KV goes to (pg, off) [ns, T]; query
            # t of row s attends positions <= qpos[s, t]
            mask = key_pos[None, None, None, :] <= qpos[:, None, :, None]
            for layer, p in enumerate(stacked):
                kcl, vcl = kc[layer], vc[layer]

                def attend(q, kk, vv):
                    kcl.index_put_((pg, off), kk.to(kcl.dtype))
                    vcl.index_put_((pg, off), vv.to(vcl.dtype))
                    kv = kcl[tab].reshape(ns, slen, nh, hd)
                    vw = vcl[tab].reshape(ns, slen, nh, hd)
                    att = torch.einsum("btnd,bsnd->bnts", q, kv) / scale
                    att = torch.where(mask, att, -1e9)
                    w = torch.softmax(att.float(), dim=-1).to(q.dtype)
                    return torch.einsum("bnts,bsnd->btnd", w, vw), None

                x, _ = gpt_block_body(x, p, eps, nh, hd, attend)
            return x

        if has_feed:
            # chunk-style catch-up: F tokens per slot in one forward; pad
            # positions (i >= feed_len) write to the null page
            ar = torch.arange(f, device=dev)
            pos = feed_pos0.long()[:, None] + ar[None, :]           # [ns, F]
            live = (ar[None, :] < feed_len[:, None]) & (pos >= 0) & \
                (pos < cap)
            pc = torch.clamp(pos, 0, cap - 1)
            pg = torch.where(live, tab[rows[:, None], pc // ps], 0)
            x = wte[feed_toks.long()] + wpe[torch.clamp(pos, 0, msl - 1)]
            layers(x, pg, pc % ps, pos)

        if not has_gen:
            drafts = torch.zeros((ns, k), dtype=torch.long, device=dev)
            if sampling:
                return drafts, torch.zeros((ns, k, cfg.vocab_size),
                                           dtype=torch.float32, device=dev)
            return drafts

        g_tok, g_pos = gen_tok.long(), gen_pos.long()
        pre_tok, pre_mask = g_tok, torch.zeros(ns, dtype=torch.bool,
                                               device=dev)
        if sampling and chain is not None:
            ch_tok_m, ch_acc, ch_pos0, ch_mask = chain
            ch_mask = ch_mask.bool()
            acc_c = torch.clamp(ch_acc.long(), 0, k)
            g_tok = torch.where(ch_mask, ch_tok_m[rows, acc_c], g_tok)
            g_pos = torch.where(ch_mask, ch_pos0.long() + acc_c + 1, g_pos)
            # the full-acceptance heal (step 0): the token at seed_pos - 1,
            # tok_m[acc - 1] for a chained row with acc >= 1; every other
            # row has that position already and null-routes the write
            pre_mask = ch_mask & (ch_acc > 0)
            pre_tok = ch_tok_m[rows, torch.clamp(acc_c - 1, 0, k)]
        # the sampling build runs k + 1 steps from seed_pos - 1: step 0 is
        # the heal write, step 1 is forced to the seed, later steps chain
        tok = g_tok
        p = g_pos - 1 if sampling else g_pos
        outs, probs = [], []
        for i in range(k + 1 if sampling else k):
            live = (p >= 0) & (p < cap)
            if sampling and i == 0:
                tok, live = pre_tok, live & pre_mask
            elif sampling and i == 1:
                tok = g_tok
            pc = torch.clamp(p, 0, cap - 1)
            pg = torch.where(live, tab[rows, pc // ps], 0)
            x = wte[tok[:, None]] + wpe[torch.clamp(p, 0, msl - 1)][:, None]
            x = layers(x, pg[:, None], (pc % ps)[:, None], p[:, None])
            x = _ln(x, other["ln_f.weight"], other["ln_f.bias"], eps)
            lg = _head(x[:, -1], other, wte)
            if sampling:
                # the token emitted after writing position p sits at p + 1:
                # the same fold the plain tick uses there
                tok, lp = _sample_rows(lg, law[0], p + 1, *law[1:])
                probs.append(torch.exp(lp))
            else:
                tok = _greedy(lg)
            outs.append(tok)
            p = p + 1
        if sampling:
            # step 0 is the heal write; the drafts come from steps 1..k
            return torch.stack(outs[1:], dim=1), torch.stack(probs[1:], dim=1)
        return torch.stack(outs, dim=1)

    return _pstats.site_fn({} if records is None else records, site, body)


def make_spec_tick(mcfg, num_slots: int, k: int, chunk_width: int,
                   sampling: bool = False, site: str = "serving.tick",
                   records: Optional[dict] = None):
    """Build the verify/mixed tick: the unified mixed-row tick with a draft
    section, over the target pools (updated in place).

    ``tick(stacked, other, kpool, vpool, last_tok, draft_toks, pf_toks,
    tok_pos, tok_limit, row_tab, row_pos0, row_len, sample_ix, n_draft,
    has_chunks, has_drafts, scales=None, law=None, draft_probs=None) ->
    (tok_m [ns, 1+k], accepted [ns])``

    The flat token layout is ``[ns last_tok | ns*k drafts | npf*w
    chunks]``; ``sample_ix`` ``[ns * (1+k)]`` is in that layout,
    ``reshape(ns, 1+k)``-able: column 0 is each slot's primary emission
    position (its last_tok row, or for a slot whose final prefill chunk
    rides this tick, the chunk's last real position), columns 1..k its
    draft verify positions. ``n_draft`` [ns] is each slot's depth this tick
    (0: plain decode row).

    ``has_drafts`` and ``has_chunks`` are host bools choosing one of four
    branches: without drafts the tick runs the exact non-speculative layout
    (the draft section sliced out) and computes only the ns primary
    logits; without chunks it skips the prefill rows. The greedy build
    returns the target's argmax at every verify position and the accepted
    lengths (``spec_accept_length``; tokens past column 0 are 0 in the
    plain branches). ``scales`` (int8 pools) are the scale keywords of
    ``gpt_ragged_apply``, reset for this tick by ``PagePool.tick_scales``
    as for the unified tick. The sampling build takes ``law = (keys,
    sample_pos, temps, top_ks, top_ps)`` (``sample_pos``: the column-0
    emission positions) and the draft tick's ``draft_probs [ns, k, V]``;
    its spec branches run ``spec_rejection_sample`` and its plain branches
    the per-row sampling law. Each call runs inside the ``site`` range and
    marks the pools, row tables, positions and tokens of the branch it
    runs at the recompile ``site``; the first call is counted into
    ``records[site]`` (``program_stats``).
    """
    ns = num_slots
    w = chunk_width
    base = ns * (1 + k)

    def body(stacked, other, kpool, vpool, last_tok, draft_toks, pf_toks,
             tok_pos, tok_limit, row_tab, row_pos0, row_len, sample_ix,
             n_draft, has_chunks, has_drafts, scales=None, law=None,
             draft_probs=None):
        sc = scales or {}

        def run(toks, pos, lim, tab, p0, ln, six, sk):
            _recompile.mark_trace(site, kpool, tab, pos, toks)
            return gpt_ragged_apply(mcfg, stacked, other, kpool, vpool, toks,
                                    pos, lim, tab, p0, ln, six,
                                    decode_rows=ns, chunk_width=w,
                                    spec_k=sk, **sc)[0]

        if has_drafts:
            tokens = torch.cat([last_tok, draft_toks, pf_toks])
            if has_chunks:
                lg = run(tokens, tok_pos, tok_limit, row_tab, row_pos0,
                         row_len, sample_ix, k)
            else:
                lg = run(tokens[:base], tok_pos[:base], tok_limit[:base],
                         row_tab[:ns], row_pos0[:ns], row_len[:ns],
                         sample_ix, k)
            if sampling:
                keys, sample_pos, temps, top_ks, top_ps = law
                return spec_rejection_sample(
                    lg.reshape(ns, 1 + k, -1), draft_probs,
                    draft_toks.reshape(ns, k), n_draft, keys, sample_pos,
                    temps, top_ks, top_ps)
            tok_m = _greedy(lg).reshape(ns, 1 + k)
        else:
            # the exact non-speculative layout: the draft section sliced
            # out of every metadata vector; chunk-section sample indices
            # shift down by it (draft indices are unused here: n_draft is
            # all 0)
            tokens = torch.cat([last_tok, pf_toks])
            pos = torch.cat([tok_pos[:ns], tok_pos[base:]])
            lim = torch.cat([tok_limit[:ns], tok_limit[base:]])
            six = sample_ix[::1 + k]
            six = torch.where(six < ns, six, six - ns * k)
            if has_chunks:
                lg = run(tokens, pos, lim, row_tab, row_pos0, row_len, six, 0)
            else:
                lg = run(tokens[:ns], pos[:ns], lim[:ns], row_tab[:ns],
                         row_pos0[:ns], row_len[:ns], six, 0)
            tok_m = torch.zeros((ns, 1 + k), dtype=torch.long,
                                device=lg.device)
            if sampling:
                keys, sample_pos, temps, top_ks, top_ps = law
                tok_m[:, 0] = _sample_rows(lg, keys, sample_pos, temps,
                                           top_ks, top_ps)[0]
                return tok_m, torch.zeros(ns, dtype=torch.long,
                                          device=lg.device)
            tok_m[:, 0] = _greedy(lg)
        return tok_m, spec_accept_length(draft_toks.reshape(ns, k),
                                         tok_m[:, :k], n_draft)

    return _pstats.site_fn({} if records is None else records, site, body)
