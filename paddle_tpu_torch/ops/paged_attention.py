"""Ragged paged attention over a page-table KV cache (mirrors
``paddle_tpu/ops/paged_attention.py``).

One entry point, ``ragged_paged_attention``, over per-row metadata
``(page_table row, pos0, true_len)``: a decode step is a row with
``true_len == 1``, a prefill chunk a row with ``true_len`` up to its chunk
width. On a CUDA tensor it launches ``csrc/ragged_paged_attention.cu``
(the port of the TPU kernel ``_ragged_kernel``: a decode-row kernel for
``T == 1``, 16-byte loads and each row's pages split over blocks, and
the register-tiled chunk-row kernel of ``csrc/attention_simt.cuh`` for
``T > 1``, counted apart in ``RAGGED_CHUNK_LAUNCHES``; either may add
its merge kernel, counted with it); on a CPU tensor it runs
the plain version ``_gather_attend`` — the reference's XLA spelling:
gather each row's pages into a contiguous ``[R, S_cap, NH, D]`` view and
run dense masked attention with an f32 softmax. Nothing selects the plain
version for a CUDA tensor.

Layout: pools are ``[num_pages, page_size, NH, D]`` per layer; page 0 is
the null page (writes of inactive rows land there, gathers of unallocated
table entries read it and are masked). ``paged_kv_scatter`` writes a
tick's KV into the pool in place (``index_put_``).

Quantized pools (``kv_dtype="int8"``): the pools store int8 values plus
per-page per-head f32 scales ``[P, NH]`` per layer. The write side is
``paged_kv_scatter``: each token's per-head amax scatter-maxes into its
page's scale, resident page content is re-quantized when the scale grows,
and the token is quantized at the final scale; the null page's scale stays
0. The read side dequantizes right after the gather in ``_gather_attend``
and, on the card, inside the kernel (a page's scale for the block's head
folded into the scores and the weights). Unquantized pools take none of
these operations.

``ragged_cost`` gives one call's work on its data (FLOPs, bytes): what
each launch adds to a counted program (``profiler/program_stats.py``) and
the bound ``chip_smoke.py`` reports.
"""
from __future__ import annotations

import math

import torch

from ..profiler import program_stats as _pstats
from . import _cuda

__all__ = ["ragged_paged_attention", "paged_decode_attention", "ragged_cost",
           "paged_prefill_attention", "paged_kv_scatter", "RAGGED_LAUNCHES",
           "RAGGED_INT8_LAUNCHES", "RAGGED_CHUNK_LAUNCHES",
           "RAGGED_CHUNK_LAUNCHES_BY_T"]

#: launches of the CUDA kernel (incremented once per launch, nowhere else)
RAGGED_LAUNCHES = 0
#: those of them that ran over int8 pools (the kernel's int8 path)
RAGGED_INT8_LAUNCHES = 0
#: those of them with T > 1 (chunk rows: the register-tiled kernel of the
#: same source; T == 1 launches the decode-row kernel)
RAGGED_CHUNK_LAUNCHES = 0
#: the same launches by query rows T ({T: launches}): a verify group of
#: speculative decoding is T = 1 + k, a prefill chunk group T = its width
RAGGED_CHUNK_LAUNCHES_BY_T: dict = {}

_NEG_INF = -1e9     # same masking constant as the reference
#: most key splits of a chunk-row query tile (the kernel's scratch room)
_CHUNK_MAX_SPLIT = 4
#: most page splits of a decode row (T == 1; the kernel's scratch room)
_DECODE_MAX_SPLIT = 32
#: the decode rows' split tickets, int32, one set per (device, stream):
#: every call leaves them 0 (the split that merges a row resets its
#: ticket), so they are zeroed once, when made or grown
_DECODE_TICKETS = {}



def _gather_attend(q, k_pool, v_pool, page_table, qpos,
                   k_scale=None, v_scale=None):
    """The plain version: gather + mask + f32 softmax.

    q           [R, T, NH, D]  queries
    k_pool      [P, ps, NH, D] per-layer key page pool
    v_pool      [P, ps, NH, D] per-layer value page pool
    page_table  [R, NPs] int32 page ids per row (0 = null page)
    qpos        [R, T] int32   last attendable cache position per query
    k_scale     [P, NH] f32    per-page per-head dequant scales (int8
    v_scale     [P, NH]        pools only; None leaves the math untouched)

    Every reduction runs at the full slot capacity ``NPs * ps`` with
    exact-zero weights behind the mask. A pool stored narrower than the
    queries (bf16 pool, f32 model) is upcast after the gather; the
    contraction runs at the wider of the two dtypes. Quantized pools
    dequantize right after the gather, as the reference spells it: the
    int8 values cast to the query dtype times the gathered f32 scales
    (null pages carry scale 0, so their bytes read as exact zeros), which
    promotes to f32; the softmax weights are rounded to the query dtype
    before the second contraction, as the reference's are. Returns
    ``[R, T, NH, D]`` in the query dtype.
    """
    r = q.shape[0]
    nps, ps = page_table.shape[1], k_pool.shape[1]
    nh, hd = k_pool.shape[2], k_pool.shape[3]
    s_cap = nps * ps
    tab = page_table.long()
    k_c = k_pool[tab]                       # [R, NPs, ps, NH, D]
    v_c = v_pool[tab]
    if k_scale is not None:
        k_c = k_c.to(q.dtype) * k_scale[tab][:, :, None, :, None]
        v_c = v_c.to(q.dtype) * v_scale[tab][:, :, None, :, None]
        wide = k_c.dtype
    else:
        wide = torch.promote_types(k_pool.dtype, q.dtype)
    qw = q.to(wide)
    k_c = k_c.to(wide).reshape(r, s_cap, nh, hd)
    v_c = v_c.to(wide).reshape(r, s_cap, nh, hd)
    key_pos = torch.arange(s_cap, device=q.device)
    mask = key_pos[None, None, None, :] <= qpos[:, None, :, None]
    att = torch.einsum("btnd,bsnd->bnts", qw, k_c) / math.sqrt(hd)
    att = torch.where(mask, att, _NEG_INF)
    w = torch.softmax(att.float(), dim=-1).to(q.dtype).to(wide)
    out = torch.einsum("bnts,bsnd->btnd", w, v_c)
    return out.to(q.dtype)


def _host_i64(x) -> torch.Tensor:
    return torch.as_tensor(x).to("cpu", torch.int64)


def _nbytes(x) -> int:
    return x.nbytes if hasattr(x, "nbytes") and not torch.is_tensor(x) \
        else x.numel() * x.element_size()


def ragged_cost(q, k_pool, page_table, pos0, true_len, k_scale=None):
    """(FLOPs, bytes) of one ragged call on this data (tensors on either
    device, or numpy arrays; device values are read on the host). Bytes:
    each row's attended K/V positions ``min(pos0 + true_len, S_cap)`` (a
    row past its table reads the whole table) at the pool's width, the
    f32 scale rows of its attended pages (int8 pools), q and o, and the
    metadata. FLOPs: ``4·NH·D`` per (real query, attended key) pair, query
    ``j`` of a row attending ``min(pos0 + j + 1, S_cap)`` keys."""
    r, t, nh, hd = q.shape
    ps = k_pool.shape[1]
    nps = page_table.shape[1]
    s_cap = nps * ps
    p0, tl = _host_i64(pos0), _host_i64(true_len)
    attended = int(torch.clamp(p0 + tl, max=s_cap).sum())
    nbytes = (2 * attended * nh * hd * k_pool.element_size()
              + 2 * r * t * nh * hd * q.element_size()
              + _nbytes(page_table) + _nbytes(pos0) + _nbytes(true_len))
    if k_scale is not None:
        pages = int(torch.clamp((p0 + tl - 1) // ps + 1, max=nps).sum())
        nbytes += 2 * pages * nh * k_scale.element_size()
    # keys of row i: sum over j < tl of min(p0 + 1 + j, cap); the first m
    # queries stop short of the cap
    m = torch.clamp(s_cap - p0, min=0)
    m = torch.minimum(m, tl)
    keys = int((m * p0 + m * (m + 1) // 2 + (tl - m) * s_cap).sum())
    return 4.0 * nh * hd * keys, nbytes


def ragged_paged_attention(q, k_pool, v_pool, page_table, pos0, true_len,
                           k_scale=None, v_scale=None):
    """One attention call over ragged rows of the page pool.

    q           [R, T, NH, D]  per-row query blocks
    k_pool      [P, ps, NH, D] per-layer key page pool (f32, bf16, int8)
    v_pool      [P, ps, NH, D] per-layer value page pool
    page_table  [R, NPs] int32 page ids per row (0 = null page)
    pos0        [R] int32      absolute position of each row's query 0
    true_len    [R] int32      real queries in the row (1 = decode row)
    k_scale     [P, NH] f32    dequant scales of int8 pools (both given
    v_scale     [P, NH]        with int8 pools, neither otherwise)

    Query ``i`` of row ``r`` attends cache positions ``<= pos0[r] + i``.
    Queries at ``i >= true_len[r]`` are computed anyway and are garbage
    the caller must ignore (the kernel reads no page past the row's last
    real query, so the garbage differs between versions). Returns
    ``[R, T, NH, D]`` in the query dtype.
    """
    quantized = k_pool.dtype == torch.int8
    if (k_scale is None) != (v_scale is None) or \
            quantized != (k_scale is not None):
        raise ValueError("ragged_paged_attention: int8 pools come with "
                         "k_scale and v_scale, other pools with neither")
    scales = (k_scale, v_scale) if quantized else ()
    for t in (k_pool, v_pool, page_table, pos0, true_len) + scales:
        if t.device != q.device:
            raise ValueError("ragged_paged_attention: all arguments must be "
                             f"on {q.device}, got one on {t.device}")
    for t in (page_table, pos0, true_len):
        if t.dtype != torch.int32:
            raise TypeError("ragged_paged_attention: page_table, pos0 and "
                            f"true_len must be int32, got {t.dtype}")
    for t in scales:
        if t.dtype != torch.float32 or \
                tuple(t.shape) != (k_pool.shape[0], k_pool.shape[2]):
            raise TypeError("ragged_paged_attention: k_scale and v_scale "
                            "must be f32 [P, NH], got "
                            f"{t.dtype} {tuple(t.shape)}")
    if q.device.type == "cpu":
        t = q.shape[1]
        qpos = pos0[:, None] + torch.arange(t, dtype=pos0.dtype)[None, :]
        return _gather_attend(q, k_pool, v_pool, page_table, qpos,
                              k_scale=k_scale, v_scale=v_scale)
    return _ragged_cuda(q, k_pool, v_pool, page_table, pos0, true_len,
                        k_scale, v_scale)


def _ragged_cuda(q, k_pool, v_pool, page_table, pos0, true_len,
                 k_scale=None, v_scale=None):
    global RAGGED_LAUNCHES, RAGGED_INT8_LAUNCHES, RAGGED_CHUNK_LAUNCHES
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"ragged_paged_attention: unsupported device {dev}")
    name = "ragged_paged_attention"
    scales = () if k_scale is None else (k_scale, v_scale)
    _cuda.refuse_planned(name, (q, k_pool, v_pool))
    _cuda.check_cuda(name, (q, k_pool, v_pool, page_table, pos0, true_len)
                     + scales, dev)
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"{name}: q [R, T, NH, D] and pools [P, ps, NH, D] "
                         f"expected, got q {tuple(q.shape)} k_pool "
                         f"{tuple(k_pool.shape)} v_pool {tuple(v_pool.shape)}")
    r, t, nh, hd = q.shape
    _, ps, pnh, phd = k_pool.shape
    if (pnh, phd) != (nh, hd):
        raise ValueError(f"{name}: pool heads/dim {(pnh, phd)} != q's "
                         f"{(nh, hd)}")
    if page_table.dim() != 2 or page_table.shape[0] != r or \
            pos0.shape != (r,) or true_len.shape != (r,):
        raise ValueError(f"{name}: page_table [R, NPs], pos0 [R] and "
                         f"true_len [R] expected for R={r}")
    if q.dtype not in _cuda.DTYPE_CODE or \
            k_pool.dtype not in _cuda.STORAGE_DTYPE_CODE or \
            v_pool.dtype != k_pool.dtype:
        raise TypeError(f"{name}: q must be f32 or bf16 and the pools f32, "
                        f"bf16 or int8, got {q.dtype}/{k_pool.dtype}/"
                        f"{v_pool.dtype}")
    if ps > 32 or hd > 256:
        raise ValueError(f"{name}: kernel supports page_size <= 32 and "
                         f"head_dim <= 256, got {ps} and {hd}")
    out = torch.empty_like(q)
    # room for the kernel to split each chunk-row query tile's keys, or
    # each decode row's pages (it splits only when the group has too few
    # blocks for the card)
    max_split = _CHUNK_MAX_SPLIT if t > 1 else _DECODE_MAX_SPLIT
    scratch = torch.empty(r * t * nh * max_split * (hd + 2), device=dev,
                          dtype=torch.float32)
    tickets = _decode_tickets(dev, r * nh) if t == 1 else None
    fn = _cuda.entry(name, name, "pppppppppiiiiiiiifpipp")
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 page_table.data_ptr(), pos0.data_ptr(), true_len.data_ptr(),
                 None if k_scale is None else k_scale.data_ptr(),
                 None if v_scale is None else v_scale.data_ptr(),
                 out.data_ptr(), r, t, nh, hd, ps, page_table.shape[1],
                 _cuda.DTYPE_CODE[q.dtype],
                 _cuda.STORAGE_DTYPE_CODE[k_pool.dtype],
                 1.0 / math.sqrt(hd),
                 scratch.data_ptr(), max_split,
                 None if tickets is None else tickets.data_ptr(),
                 _cuda.stream_handle(dev))
    _cuda.raise_on_error(name, err)
    RAGGED_LAUNCHES += 1
    if k_scale is not None:
        RAGGED_INT8_LAUNCHES += 1
    if t > 1:
        RAGGED_CHUNK_LAUNCHES += 1
        by_t = RAGGED_CHUNK_LAUNCHES_BY_T
        by_t[t] = by_t.get(t, 0) + 1
    if _pstats.ACTIVE is not None:
        _pstats.note_kernel(name, ragged_cost, q, k_pool, page_table, pos0,
                            true_len, k_scale)
    return out


def _decode_tickets(dev, n):
    """At least ``n`` zeroed int32 tickets for the decode rows' page
    splits on ``dev``'s current stream (calls on one stream run in order,
    so they share a set; another stream gets its own)."""
    key = (dev.index, _cuda.stream_handle(dev))
    tickets = _DECODE_TICKETS.get(key)
    if tickets is None or tickets.numel() < n:
        tickets = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _DECODE_TICKETS[key] = tickets
    return tickets


def _decode_splits(q, k_pool, page_table) -> int:
    """The most page ranges the decode-row kernel cuts a row of this
    ``T == 1`` call in on q's card (1: no split; a row shorter than that
    many ranges of 4 pages takes fewer). CUDA tensors only."""
    fn = _cuda.entry("ragged_paged_attention", "ragged_decode_splits",
                     "iiiiiii")
    r, _, nh, hd = q.shape
    with torch.cuda.device(q.device):
        return fn(r, nh, hd, page_table.shape[1], _cuda.DTYPE_CODE[q.dtype],
                  _cuda.STORAGE_DTYPE_CODE[k_pool.dtype], _DECODE_MAX_SPLIT)


def paged_decode_attention(q, k_pool, v_pool, page_table, attend_pos,
                           k_scale=None, v_scale=None):
    """One decode step: a ragged call where every row is a single query
    at its slot's write position. q [B, 1, NH, D]; attend_pos [B] int32.
    Returns [B, 1, NH, D]."""
    ones = torch.ones_like(attend_pos)
    return ragged_paged_attention(q, k_pool, v_pool, page_table,
                                  attend_pos, ones, k_scale=k_scale,
                                  v_scale=v_scale)


def paged_prefill_attention(q, k_pool, v_pool, page_table, pos0,
                            k_scale=None, v_scale=None):
    """Suffix-prefill (chunked) attention: each batch row is a T-query
    chunk starting at the shared position ``pos0``. The chunk's own KV
    must already be in the pool. Returns [B, T, NH, D]."""
    b, t = q.shape[0], q.shape[1]
    row_pos0 = torch.full((b,), int(pos0), dtype=torch.int32,
                          device=q.device)
    tl = torch.full((b,), t, dtype=torch.int32, device=q.device)
    return ragged_paged_attention(q, k_pool, v_pool, page_table, row_pos0, tl,
                                  k_scale=k_scale, v_scale=v_scale)


def paged_kv_scatter(pool, scale, page, off, vals):
    """Write one tick's per-token KV into the page pool, in place.

    pool   [P, ps, NH, D]  per-layer page pool (f32/bf16/int8)
    scale  [P, NH] f32     per-page per-head scales (int8 pools; None
                           otherwise)
    page   [NT] int        target page per token (0 = null page)
    off    [NT] int        offset within the page
    vals   [NT, NH, D]     the token KV (cast to the pool dtype)

    Unquantized pools: one scatter. int8 pools quantize on write with
    running per-page scales, as the reference does:

    1. each token's per-head ``amax / 127`` scatter-maxes into its page's
       scale row (null-page contributions masked to 0, so the null page's
       scale stays 0);
    2. the resident int8 content of every written page is re-quantized
       ``round(q * s_old / s_new)`` — an exact no-op while the scale is
       unchanged; a freshly reset page (``s_old == 0``) is zeroed;
    3. the token is quantized at the final scale (``|q| <= 127``).

    Duplicate page targets (a chunk landing several tokens in one page)
    are safe: every duplicate computes the same rescaled page from the
    same pre-write content, and the offset writes are disjoint. Not a
    Pallas kernel in the reference, so plain PyTorch on both devices.

    Returns (pool, scale): the same tensors, updated in place (the JAX
    reference returns new arrays; the port has no donation and saves the
    copies). Everything the update reads — the old scales, the gathered
    pages, the new scales — is read before the page rewrite and the token
    write.
    """
    page, off = page.long(), off.long()
    if scale is None:
        pool.index_put_((page, off), vals.to(pool.dtype))
        return pool, None
    vals = vals.float()
    a = vals.abs().amax(dim=-1) / 127.0                     # [NT, NH]
    a = torch.where((page > 0)[:, None], a, torch.zeros_like(a))
    s_old = scale[page]                                     # [NT, NH]
    scale.scatter_reduce_(0, page[:, None].expand_as(a), a, "amax",
                          include_self=True)
    s_new = scale[page]
    ratio = torch.where(s_new > 0.0, s_old / s_new.clamp_min(1e-30),
                        torch.zeros_like(s_new))
    pg = pool[page].float()                                 # [NT, ps, NH, D]
    pg = torch.round(pg * ratio[:, None, :, None])
    pool.index_put_((page,), pg.to(torch.int8))
    q = torch.round(vals / s_new.clamp_min(1e-30)[:, :, None])
    q = q.clamp_(-127.0, 127.0)
    pool.index_put_((page, off), q.to(torch.int8))
    return pool, scale
