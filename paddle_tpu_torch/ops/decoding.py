"""Autoregressive decoding loops: greedy, top-k/top-p sampling, beam search
(mirrors ``paddle_tpu/ops/decoding.py``).

The step contract, shared by all strategies::

    step_fn(cache, tokens [N], pos) -> (logits [N, V], cache)

``cache`` is a tensor or a tuple, list or dict of them whose leaves lead
with the batch (times beam) dim. The reference's ``lax.scan`` over the
ticks is a Python loop here; ``GPT.generate``'s step writes each token's
K/V into the cache leaves in place. The beam reorder is an
``index_select`` over the ``[B*K, ...]`` leaves.

Random draws go through ``core.random``, the threefry generator that is
bit-equal to ``jax.random``: ``sampling_decode`` splits its key once a
tick as the reference does, and the engine's per-row law
(``serving/engine.py``) folds each request's key by the position of the
token it emits. Filtering, sorts, cumsums and the beam top-k are plain
PyTorch: the reference computes none of them in a Pallas kernel.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from ..core import random as R

__all__ = ["greedy_decode", "sampling_decode", "beam_search_decode",
           "tile_cache_for_beams", "apply_top_k_top_p",
           "apply_top_k_top_p_per_row", "spec_accept_length",
           "spec_rejection_sample"]

NEG_INF = -1e9

#: fold_in salt separating the acceptance-uniform stream from the
#: token-draw stream at the same position: the draw for position ``p``
#: consumes ``fold_in(key, p)`` and the accept test consumes
#: ``fold_in(fold_in(key, p), SALT)``.
SPEC_ACCEPT_SALT = 0x5BD1E995


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    raise TypeError(f"cache leaf of type {type(tree).__name__}")


def _force_eos(logprobs, finished, eos_token_id):
    """Finished rows: only EOS is allowed, at logprob 0 (score frozen)."""
    if eos_token_id is None:
        return logprobs
    v = logprobs.shape[-1]
    eos_row = torch.full((v,), NEG_INF, dtype=logprobs.dtype,
                         device=logprobs.device)
    eos_row[eos_token_id] = 0.0
    return torch.where(finished[..., None], eos_row, logprobs)


def _top_k_stable(x, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, ties in index
    order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def greedy_decode(step_fn: Callable, cache: Any, first_logits, start_pos,
                  max_new_tokens: int, eos_token_id: Optional[int] = None):
    """Argmax decoding seeded from the prefill's last-token logits
    ``first_logits`` [N, V]. Tick t picks the token for position
    ``start_pos + t`` from the current logits, then advances the cache.
    Returns (ids [N, max_new_tokens] int64, cache)."""
    n = first_logits.shape[0]
    logits = first_logits
    fin = torch.zeros(n, dtype=torch.bool, device=first_logits.device)
    ids = []
    for t in range(max_new_tokens):
        lp = torch.log_softmax(logits.float(), dim=-1)
        lp = _force_eos(lp, fin, eos_token_id)
        tok = torch.argmax(lp, dim=-1)
        if eos_token_id is not None:
            fin = fin | (tok == eos_token_id)
        logits, cache = step_fn(cache, tok, start_pos + t)
        ids.append(tok)
    return torch.stack(ids, dim=1), cache


def apply_top_k_top_p(logits, top_k: int = 0, top_p: float = 1.0):
    """Mask logits outside the top-k / nucleus top-p set.

    ``top_k >= vocab`` and ``top_k <= 0`` filter nothing, and a ``top_p``
    so small that no prefix reaches it (including 0.0) keeps the argmax
    token: a sampling step never sees an all-``NEG_INF`` row."""
    v = logits.shape[-1]
    if 0 < top_k < v:
        kth = torch.sort(logits, dim=-1).values[..., v - top_k]
        logits = torch.where(logits < kth[..., None], NEG_INF, logits)
    if top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # the smallest prefix with cumulative prob >= top_p; the top-1
        # token is always kept
        keep_sorted = cum - probs < top_p
        keep_sorted[..., 0] = True
        kth = torch.where(keep_sorted, sorted_l, torch.inf).amin(dim=-1)
        logits = torch.where(logits < kth[..., None], NEG_INF, logits)
    return logits


def apply_top_k_top_p_per_row(logits, top_k, top_p):
    """Row-wise ``apply_top_k_top_p``: ``top_k`` int [N] and ``top_p``
    float32 [N] filter each row of ``logits`` [N, V] independently (the
    serving engine's per-request sampling params).

    Per-row disable semantics are exact no-ops, matching the scalar path
    bitwise: ``top_k <= 0`` or ``>= V`` keeps the row untouched
    (threshold -inf), and ``top_p >= 1.0`` likewise. The nucleus rule
    always keeps the argmax token."""
    v = logits.shape[-1]
    tk = torch.as_tensor(top_k, device=logits.device).long()
    tp = torch.as_tensor(top_p, dtype=torch.float32, device=logits.device)
    sorted_d = torch.sort(logits, dim=-1, descending=True).values
    k_eff = torch.clamp(tk, 1, v)
    kth = sorted_d.gather(-1, (k_eff - 1)[..., None])[..., 0]
    thr_k = torch.where((tk > 0) & (tk < v), kth, -torch.inf)
    logits = torch.where(logits < thr_k[..., None], NEG_INF, logits)
    sorted_f = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_f, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = cum - probs < tp[..., None]
    keep_sorted[..., 0] = True
    kth_p = torch.where(keep_sorted, sorted_f, torch.inf).amin(dim=-1)
    thr_p = torch.where(tp < 1.0, kth_p, -torch.inf)
    return torch.where(logits < thr_p[..., None], NEG_INF, logits)


def spec_accept_length(draft_toks, target_toks, n_draft):
    """Greedy speculative acceptance: the length of the longest draft
    prefix the target agrees with.

    draft_toks [N, k], target_toks [N, k] (the target's argmax at each
    draft token's predecessor position), n_draft [N] (drafts offered per
    row, <= k). Returns accepted [N] in ``[0, n_draft]``: draft j+1 is
    accepted iff drafts 1..j were and ``d_{j+1} == t_j``."""
    k = draft_toks.shape[1]
    dev = draft_toks.device
    n_draft = torch.as_tensor(n_draft, device=dev).long()
    offered = torch.arange(k, device=dev)[None, :] < n_draft[:, None]
    match = (draft_toks == target_toks) & offered
    # cumprod turns the first mismatch into a permanent 0
    return torch.cumprod(match.long(), dim=1).sum(dim=1)


def spec_rejection_sample(target_logits, draft_probs, draft_toks, n_draft,
                          keys, positions, temps, top_ks, top_ps):
    """Sampled speculative acceptance (Leviathan/Chen rejection rule):
    accept draft token t with probability ``min(1, p_tgt(t)/p_drf(t))``;
    on the first rejection resample the correction from the normalized
    residual ``max(0, p_tgt - p_drf)``. The target side is filtered here
    by the same per-row temperature/top-k/top-p as the (pre-filtered)
    draft side.

    target_logits [N, 1+k, V] (column j scores position ``positions +
    j``), draft_probs [N, k, V] f32, draft_toks [N, k], n_draft [N],
    keys [N, 2] (``core.random`` keys), positions [N], temps/top_ks/top_ps
    [N]. Returns ``(tokens [N, 1+k], accepted [N])``: the accepted drafts,
    then the correction (or, when every offered draft was accepted, the
    bonus draw from the target's own column)."""
    n, kp1, v = target_logits.shape
    k = kp1 - 1
    dev = target_logits.device
    n_draft = torch.as_tensor(n_draft, device=dev).long()
    positions = torch.as_tensor(positions, device=dev).long()
    keys = R.as_key(keys, dev)
    temps = torch.as_tensor(temps, dtype=torch.float32, device=dev)

    lg = target_logits.float() / torch.clamp(temps, min=1e-6)[:, None, None]
    lg = apply_top_k_top_p_per_row(
        lg.reshape(n * kp1, v),
        torch.as_tensor(top_ks, device=dev).long().repeat_interleave(kp1),
        torch.as_tensor(top_ps, dtype=torch.float32,
                        device=dev).repeat_interleave(kp1))
    lp = torch.log_softmax(lg, dim=-1).reshape(n, kp1, v)
    pt = torch.exp(lp)

    # the draw at absolute position p folds p into the request key: the
    # plain tick's law, so column 0 of a plain row is the plain draw
    pos = positions[:, None] + torch.arange(kp1, device=dev)[None, :]
    ckeys = R.fold_in(keys[:, None, :], pos)                # [N, 1+k, 2]
    direct = R.categorical(ckeys, lp)                       # [N, 1+k]

    # acceptance test per draft column, on a salted uniform stream
    draft_toks = draft_toks.long()
    pt_d = pt[:, :k].gather(-1, draft_toks[..., None])[..., 0]
    pd_d = draft_probs.gather(-1, draft_toks[..., None])[..., 0]
    akeys = R.fold_in(ckeys[:, :k], SPEC_ACCEPT_SALT)
    u = R.uniform(akeys, ())                                # [N, k]
    offered = torch.arange(k, device=dev)[None, :] < n_draft[:, None]
    accept = offered & (u < pt_d / torch.clamp(pd_d, min=1e-30))
    acc = torch.cumprod(accept.long(), dim=1).sum(dim=1)

    # residual correction: dead entries stay at NEG_INF, and where resid
    # == p_tgt elementwise the logits are log p_tgt + log(1.0) bitwise
    resid = torch.clamp(pt[:, :k] - draft_probs, min=0.0)
    rl = torch.where(resid > 0.0,
                     lp[:, :k] + torch.log(
                         resid / torch.clamp(pt[:, :k], min=1e-38)),
                     NEG_INF)
    res_tok = R.categorical(ckeys[:, :k], rl)               # [N, k]

    corr = torch.where(offered, res_tok, direct[:, :k])
    out = torch.where(torch.arange(k, device=dev)[None, :] < acc[:, None],
                      draft_toks, corr)
    return torch.cat([out, direct[:, k:]], dim=1), acc


def sampling_decode(step_fn: Callable, cache: Any, first_logits, start_pos,
                    max_new_tokens: int, key, top_k: int = 0,
                    top_p: float = 1.0, temperature: float = 1.0,
                    eos_token_id: Optional[int] = None):
    """Temperature + top-k/top-p sampling, seeded from the prefill's
    last-token logits. ``key`` is a ``core.random`` key, split once a
    tick (the second half draws the tick's tokens), as the reference
    splits its ``jax.random`` key. Returns (ids int64, cache)."""
    n = first_logits.shape[0]
    dev = first_logits.device
    key = R.as_key(key, dev)
    # a tensor divisor on the logits' device: a true f32 division, as the
    # reference's (a CPU scalar divisor is a product by its reciprocal on
    # a card)
    temp = torch.clamp(torch.tensor(temperature, dtype=torch.float32,
                                    device=dev), min=1e-6)
    logits = first_logits
    fin = torch.zeros(n, dtype=torch.bool, device=dev)
    ids = []
    for t in range(max_new_tokens):
        lg = apply_top_k_top_p(logits.float() / temp, top_k, top_p)
        lp = torch.log_softmax(lg, dim=-1)
        lp = _force_eos(lp, fin, eos_token_id)
        key, sub = R.split(key).unbind(0)
        tok = R.categorical(sub, lp)
        if eos_token_id is not None:
            fin = fin | (tok == eos_token_id)
        logits, cache = step_fn(cache, tok, start_pos + t)
        ids.append(tok)
    return torch.stack(ids, dim=1), cache


def beam_search_decode(step_fn: Callable, cache: Any, first_logits,
                       start_pos, max_new_tokens: int, num_beams: int,
                       length_penalty: float = 0.0,
                       eos_token_id: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search: top-k over beam*vocab accumulated logprobs with parent
    reordering.

    Cache leaves must already be tiled to [B*K, ...]
    (``tile_cache_for_beams``) and warmed by a prefill whose last-token
    logits are ``first_logits`` [B, V]; beam 0 seeds the search.
    ``step_fn`` runs on the flattened [B*K] batch. Returns (ids [B,
    max_new_tokens] of the best beam, scores [B])."""
    b, v = first_logits.shape
    k = num_beams
    dev = first_logits.device

    lp0 = torch.log_softmax(first_logits.float(), dim=-1)
    scores, tok0 = _top_k_stable(lp0, k)                    # [B, K]
    fin = torch.zeros((b, k), dtype=torch.bool, device=dev) \
        if eos_token_id is None else tok0 == eos_token_id
    ids = torch.zeros((b, k, max_new_tokens), dtype=torch.int64, device=dev)
    ids[:, :, 0] = tok0
    cur = tok0
    base = torch.arange(b, device=dev)[:, None] * k
    for t in range(1, max_new_tokens):
        # the token fed at tick t was decoded at step t-1 and occupies
        # sequence position start_pos + t - 1
        logits, cache = step_fn(cache, cur.reshape(b * k),
                                start_pos + t - 1)
        lp = torch.log_softmax(logits.float(), dim=-1).reshape(b, k, v)
        lp = _force_eos(lp, fin, eos_token_id)
        total = scores[:, :, None] + lp                     # [B, K, V]
        scores, flat_idx = _top_k_stable(total.reshape(b, k * v), k)
        parent = flat_idx // v
        token = flat_idx % v
        ids = ids.gather(1, parent[:, :, None].expand(-1, -1,
                                                      max_new_tokens))
        fin = fin.gather(1, parent)
        ids[:, :, t] = token
        if eos_token_id is not None:
            fin = fin | (token == eos_token_id)
        gidx = (base + parent).reshape(b * k)
        cache = _tree_map(lambda a: a.index_select(0, gidx), cache)
        cur = token

    if length_penalty:
        if eos_token_id is None:
            lengths = torch.full(scores.shape, float(max_new_tokens),
                                 dtype=torch.float32, device=dev)
        else:
            lengths = (ids != eos_token_id).float().sum(dim=-1) + 1.0
        norm = scores / lengths ** length_penalty
    else:
        norm = scores
    best = torch.argmax(norm, dim=1)                        # [B]
    rows = torch.arange(b, device=dev)
    return ids[rows, best], norm[rows, best]


def tile_cache_for_beams(cache: Any, num_beams: int):
    """Repeat each cache leaf's batch rows ``num_beams`` times ([B, ...] ->
    [B*K, ...], beam-major within a batch row)."""
    return _tree_map(lambda a: a.repeat_interleave(num_beams, dim=0), cache)
