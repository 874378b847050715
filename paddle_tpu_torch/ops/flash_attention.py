"""Flash attention forward and backward (mirrors
``paddle_tpu/ops/flash_attention.py``).

``flash_attention(q, k, v, causal, scale)`` takes the public
``[batch, seq, heads, head_dim]`` layout and returns ``(o, lse)``: ``o``
in the input dtype and the natural-log logsumexp ``[B*H, S, 1]`` in f32
(not differentiable). It is a ``torch.autograd.Function`` (the
reference's ``jax.custom_vjp``): the forward saves ``(q, k, v, o, lse)``
and the backward runs ``_bwd``. Under ``torch.utils.checkpoint`` the
forward runs again inside backward and the backward reads the recomputed
``o`` and ``lse``.

Kernels, each with a launch counter:

- forward (``_fwd_kernel``), two routes chosen by ``_tc_route`` before
  the launch: bf16 at head dim 64 or 128 takes the tensor-core kernel
  ``csrc/flash_attention_fwd_tc.cu`` (wgmma, TMA, a producer warpgroup;
  ``FLASH_FWD_TC_LAUNCHES``); f32, and bf16 at any other head dim, the
  SIMT kernel ``csrc/flash_attention_fwd.cu`` (``FLASH_FWD_LAUNCHES``).
  f32 stays off the tensor cores: the port keeps TF32 off.
- backward, chosen by ``_bwd`` with the reference's rule (blocks from
  ``_pick_block``, ``bq = bk`` when causal): one tile each way takes the
  merged kernel (``_bwd_single_tile_kernel``), anything else the pair dQ
  (``_bwd_dq_kernel``) and dK/dV (``_bwd_dkv_kernel``). Each of the three
  has the same two routes as the forward: on the wgmma route
  ``csrc/flash_attention_bwd_single_tile_tc.cu``
  (``FLASH_BWD_SINGLE_TC_LAUNCHES``), ``csrc/flash_attention_bwd_dq_tc.cu``
  (``FLASH_BWD_DQ_TC_LAUNCHES``) and ``csrc/flash_attention_bwd_dkv_tc.cu``
  (``FLASH_BWD_DKV_TC_LAUNCHES``); otherwise the kernels of
  ``csrc/flash_attention_bwd.cu`` (``FLASH_BWD_SINGLE_LAUNCHES``,
  ``FLASH_BWD_DQ_LAUNCHES``, ``FLASH_BWD_DKV_LAUNCHES``), whose products
  run on the tensor cores through ``mma.sync`` as 3xTF32 (each f32
  operand split into two TF32 halves, three products; f32 accuracy
  whatever ``allow_tf32`` says).

The wgmma kernels are bounded by operations (989 TFLOP/s bf16);
they round P (and dS) to bf16 before their products, as the reference
does; the ``mma.sync`` kernels keep P and dS in f32. Each kernel's
plain PyTorch version sits beside it (``_plain_fwd``,
``_plain_bwd_single_tile``, ``_plain_bwd_dq``, ``_plain_bwd_dkv``): CPU
tensors run it, and ``chip_smoke.py`` holds the kernel against it on the
card. A CUDA tensor always launches a kernel; a failed build or launch
raises. A tensor with no values (``_cuda.planned``: a fake tensor of a
plan of the train step on the CUDA route, ``distributed/plan.py``, or a
``meta`` tensor) takes each wrapper's shape rule: the wrapper allocates
what its kernel allocates (O and the LSE; the gradients, with the merged
kernel's f32 dQ scratch and tickets) and launches nothing, so a plan
holds no ``[B, H, S, S]`` scores.

``flash_fwd_cost`` and ``flash_bwd_cost`` give each kernel's work
(FLOPs, bytes): what each launch adds to a counted program
(``profiler/program_stats.py``) and the bound ``chip_smoke.py`` reports.
"""
from __future__ import annotations

import math

import torch

from ..profiler import program_stats as _pstats
from . import _cuda

__all__ = ["flash_attention", "mha_reference", "supported",
           "flash_fwd_cost", "flash_bwd_cost",
           "FLASH_FWD_LAUNCHES", "FLASH_FWD_TC_LAUNCHES",
           "FLASH_BWD_SINGLE_LAUNCHES", "FLASH_BWD_SINGLE_TC_LAUNCHES",
           "FLASH_BWD_DQ_LAUNCHES", "FLASH_BWD_DQ_TC_LAUNCHES",
           "FLASH_BWD_DKV_LAUNCHES", "FLASH_BWD_DKV_TC_LAUNCHES"]

#: launches of each CUDA kernel (incremented once per launch, nowhere else)
FLASH_FWD_LAUNCHES = 0
FLASH_FWD_TC_LAUNCHES = 0
FLASH_BWD_SINGLE_LAUNCHES = 0
FLASH_BWD_SINGLE_TC_LAUNCHES = 0
FLASH_BWD_DQ_LAUNCHES = 0
FLASH_BWD_DQ_TC_LAUNCHES = 0
FLASH_BWD_DKV_LAUNCHES = 0
FLASH_BWD_DKV_TC_LAUNCHES = 0

#: head dims the tensor-core kernels are built for
_TC_HEAD_DIMS = (64, 128)

_BLOCK_Q = 1024
_BLOCK_K = 1024
_SEQ_ALIGN = 128
_NEG_INF = -1e30
_LOG2E = 1.4426950408889634


def _tc_route(dtype, d) -> bool:
    """True when a flash launch (forward or any backward kernel) over
    ``dtype`` inputs of head dim ``d`` takes the wgmma kernel (bf16 at D
    64 or 128), False for the other kernel (f32, and any other D): the
    SIMT forward, the mma.sync (3xTF32) backward."""
    return dtype == torch.bfloat16 and d in _TC_HEAD_DIMS


def _tma_aligned(name, tensors):
    """TMA reads from 16-byte aligned bases only."""
    for i, t in enumerate(tensors):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: argument {i} is not 16-byte aligned")


def _pick_block(seq, cap):
    """Largest block edge <= cap that divides seq (128-aligned), else None."""
    b = min(cap, seq)
    while b >= _SEQ_ALIGN:
        if seq % b == 0:
            return b
        b //= 2
    return None


def _blocks(sq, sk, causal):
    """The reference's tile edges (``_flash_fwd_res``): picked per side,
    equal under causal so the diagonal block covers its own row."""
    bq, bk = _pick_block(sq, _BLOCK_Q), _pick_block(sk, _BLOCK_K)
    if causal:
        bq = bk = min(bq, bk)
    return bq, bk


def supported(q_shape, attn_mask, dropout_p, kv_seq=None) -> bool:
    """True when the flash kernel handles this case — the reference's
    rule: no mask, no dropout, D <= 256, and sequence lengths its block
    picker accepts (any length from 128 to 1024; beyond 1024 a multiple
    of 128). The CUDA kernels mask a ragged last tile themselves."""
    if attn_mask is not None or dropout_p:
        return False
    if len(q_shape) != 4:
        return False
    if _pick_block(q_shape[1], _BLOCK_Q) is None:
        return False
    if kv_seq is not None and _pick_block(kv_seq, _BLOCK_K) is None:
        return False
    return q_shape[3] <= 256


def _plain_fwd(q, k, v, causal, scale):
    """The plain version: ``mha_reference``'s arithmetic, plus the
    natural-log LSE of the same f32 logits. Returns (o, lse)."""
    b, sq, h, d = q.shape
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    logits = (torch.einsum("bhsd,bhtd->bhst", qt, kt) * s).float()
    if causal:
        sk = logits.shape[-1]
        tril = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril()
        logits = torch.where(tril, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhst,bhtd->bhsd", probs, vt).transpose(1, 2)
    lse = torch.logsumexp(logits, dim=-1).reshape(b * h, sq, 1)
    return out, lse


def mha_reference(q, k, v, causal=False, scale=None):
    """Unfused reference (the kernel is compared against this)."""
    return _plain_fwd(q, k, v, causal, scale)[0]


def flash_fwd_cost(q, k, v, causal, exact: bool = False):
    """(FLOPs, bytes) of one forward over ``q [B, Sq, H, D]`` and ``k``,
    ``v [B, Sk, H, D]``. By default the reference kernel's own
    ``pl.CostEstimate``: ``4·BH·Sq·Sk·D`` FLOPs, halved when causal, and
    ``2·(|q| + |k| + |v|)·itemsize`` bytes, which is what a counted
    program reports. ``exact=True`` counts this kernel's work, the bound
    column's: the causal pairs ``Sq·(Sq+1)/2`` (else ``Sq·Sk``), q, k, v
    and o at their width and the f32 LSE."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if exact:
        pairs = sq * (sq + 1) / 2 if causal else sq * sk
        return (4.0 * b * h * d * pairs,
                2 * b * (sq + sk) * h * d * q.element_size() + 4 * b * h * sq)
    flops = 4 * (b * h) * sq * sk * d // (2 if causal else 1)
    return float(flops), 2 * (q.numel() + k.numel() + v.numel()) * \
        q.element_size()


#: the backward kernels: (products of 2·D FLOPs per (query, key) pair,
#: the gradients each writes)
_BWD_WORK = {"single": (10.0, ("dq", "dk", "dv")), "dq": (6.0, ("dq",)),
             "dkv": (8.0, ("dk", "dv"))}


def flash_bwd_cost(kind, q, k, causal, out_dtype):
    """(FLOPs, bytes) of one backward kernel: ``kind`` ``"single"`` (the
    merged kernel), ``"dq"`` or ``"dkv"``. FLOPs: its products over the
    (query, key) pairs (``Sq·(Sq+1)/2`` causal, else ``Sq·Sk``); bytes:
    q, k, v and dO at their width, the f32 LSE and delta, and the
    gradients it writes in ``out_dtype``."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    op_factor, grads = _BWD_WORK[kind]
    pairs = sq * (sq + 1) / 2 if causal else sq * sk
    osz = torch.empty((), dtype=out_dtype).element_size()
    nbytes = (2 * b * (sq + sk) * h * d * q.element_size()
              + 2 * b * h * sq * 4
              + sum((sq if g == "dq" else sk) for g in grads)
              * b * h * d * osz)
    return op_factor * b * h * d * pairs, nbytes


def _check(q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes [batch, seq, heads, dim]")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or \
            q.shape[2:] != k.shape[2:]:
        raise ValueError(f"flash_attention shapes disagree: q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    sq, sk = q.shape[1], k.shape[1]
    if _pick_block(sq, _BLOCK_Q) is None or _pick_block(sk, _BLOCK_K) is None:
        raise ValueError(
            f"flash_attention needs 128-aligned seq lens, got q={sq} kv={sk}")
    if causal and sq != sk:
        raise ValueError("causal flash_attention requires seq_q == seq_kv")
    if q.shape[3] > 256:
        raise ValueError("flash_attention supports head_dim <= 256")


def flash_attention(q, k, v, causal=False, scale=None):
    """q, k, v ``[B, S, H, D]`` -> ``(o [B, S, H, D], lse [B*H, S, 1] f32)``;
    differentiable in q, k and v."""
    _check(q, k, v, causal)
    return _FlashAttention.apply(q, k, v, causal, scale)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        if q.device.type == "cpu":
            o, lse = _plain_fwd(q, k, v, causal, scale)
        else:
            o, lse = _flash_cuda(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        s = ctx.scale if ctx.scale is not None else \
            1.0 / math.sqrt(q.shape[3])
        bq, bk = _blocks(q.shape[1], k.shape[1], ctx.causal)
        dq, dk, dv = _bwd(s, ctx.causal, bq, bk, (q, k, v, o, lse),
                          do.contiguous())
        return dq, dk, dv, None, None


def _flash_cuda(q, k, v, causal, scale):
    """The forward on the card: the tensor-core or the SIMT kernel, by
    ``_tc_route``."""
    dev = q.device
    if dev.type != "cuda" and not (dev.type == "meta" and _cuda.planned(q)):
        raise ValueError(f"flash_attention: unsupported device {dev}")
    _cuda.check_cuda("flash_attention", (q, k, v), dev)
    if q.dtype not in _cuda.DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError("flash_attention kernel takes f32 or bf16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    kern = _flash_tc if _tc_route(q.dtype, q.shape[3]) else _flash_simt
    return kern(q, k, v, causal, scale)


def _fwd_outputs(q, scale):
    b, sq, h, d = q.shape
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    lse = torch.empty(b * h, sq, 1, device=q.device, dtype=torch.float32)
    return torch.empty_like(q), lse, float(s)


def _flash_simt(q, k, v, causal, scale):
    """SIMT forward (``csrc/flash_attention_fwd.cu``): f32, and bf16 at a
    head dim the tensor-core kernel does not take. Register-tiled products
    on the FMA units (the core of ``csrc/attention_simt.cuh``) over a
    cp.async K/V ring; the products stay in f32 (no TF32)."""
    global FLASH_FWD_LAUNCHES
    b, sq, h, d = q.shape
    o, lse, s = _fwd_outputs(q, scale)
    if _cuda.planned(q):
        return o, lse
    fn = _cuda.entry("flash_attention_fwd", "flash_attention_fwd",
                     "pppppiiiiiifip")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, sq, k.shape[1], h, d, int(bool(causal)),
                 s, _cuda.DTYPE_CODE[q.dtype], _cuda.stream_handle(q.device))
    _cuda.raise_on_error("flash_attention_fwd", err)
    FLASH_FWD_LAUNCHES += 1
    if _pstats.ACTIVE is not None:
        _pstats.note_kernel("flash_attention_fwd", flash_fwd_cost, q, k, v,
                            causal)
    return o, lse


def _flash_tc(q, k, v, causal, scale):
    """Tensor-core forward (``csrc/flash_attention_fwd_tc.cu``): bf16,
    D 64 or 128."""
    global FLASH_FWD_TC_LAUNCHES
    name = "flash_attention_fwd_tc"
    b, sq, h, d = q.shape
    if not _tc_route(q.dtype, d):
        raise TypeError(f"{name} takes bf16 at D in {_TC_HEAD_DIMS}, got "
                        f"{q.dtype} at D {d}")
    o, lse, s = _fwd_outputs(q, scale)
    if _cuda.planned(q):
        return o, lse
    _tma_aligned(name, (q, k, v))
    fn = _cuda.entry(name, name, "pppppiiiiiifp")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, sq, k.shape[1], h, d, int(bool(causal)),
                 s, _cuda.stream_handle(q.device))
    _cuda.raise_on_error(name, err)
    FLASH_FWD_TC_LAUNCHES += 1
    if _pstats.ACTIVE is not None:
        _pstats.note_kernel(name, flash_fwd_cost, q, k, v, causal)
    return o, lse


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def _bwd(scale, causal, block_q, block_k, res, do, delta=None,
         out_dtype=None):
    """The reference's ``_bwd`` (same selection rule) over the public
    layout: ``res = (q, k, v, o, lse)`` with q/k/v/o ``[B, S, H, D]`` and
    lse ``[B*H, Sq, 1]``, ``do`` ``[B, Sq, H, D]``. ``delta`` ``[B*H,
    Sq, 1]`` f32 defaults to ``rowsum(do * o)`` (plain PyTorch, as in the
    reference); ring attention passes the global row's delta and
    ``out_dtype=torch.float32`` so its per-chunk partials do not round.
    Returns ``(dq, dk, dv)`` in ``[B, S, H, D]``."""
    q, k, v, o, lse = res
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    nq, nk = sq // block_q, sk // block_k
    if delta is None:
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
            .reshape(b * h, sq, 1).contiguous()
    dtypes = (out_dtype or q.dtype, out_dtype or k.dtype,
              out_dtype or v.dtype)
    if nq == 1 and nk == 1:
        return _bwd_single_tile(scale, causal, (q, k, v, lse), do, delta,
                                dtypes)
    dq = _bwd_dq(scale, causal, (q, k, v, lse), do, delta, dtypes[0])
    dk, dv = _bwd_dkv(scale, causal, (q, k, v, lse), do, delta, dtypes[1:])
    return dq, dk, dv


def _plain_grads(scale, causal, res, do, delta, dtypes, want):
    """The reference's backward formulas over the whole sequence, with P
    from the saved LSE: ``P = exp2(s·log2e − lse·log2e)``, ``dS = P ∘
    (dO·Vᵀ − δ)·scale``; P and dS are cast to the input dtype before
    their products (f32 accumulation), as the TPU kernels do. ``want``
    names the gradients to return, in the order (dq, dk, dv)."""
    q, k, v, lse = res
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    s = torch.einsum("bhsd,bhtd->bhst", qt.float(), kt.float()) * \
        (scale * _LOG2E)
    if causal:
        tril = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = torch.where(tril, s, _NEG_INF)
    p = torch.exp2(s - lse.reshape(b, h, sq, 1) * _LOG2E)
    dp = torch.einsum("bhsd,bhtd->bhst", dot.float(), vt.float())
    ds = p * (dp - delta.reshape(b, h, sq, 1)) * scale
    out = []
    if "dq" in want:
        out.append(torch.einsum("bhst,bhtd->bhsd", ds.to(q.dtype).float(),
                                kt.float()))
    if "dk" in want:
        out.append(torch.einsum("bhst,bhsd->bhtd", ds.to(q.dtype).float(),
                                qt.float()))
    if "dv" in want:
        out.append(torch.einsum("bhst,bhsd->bhtd", p.to(do.dtype).float(),
                                dot.float()))
    return tuple(g.transpose(1, 2).to(dt).contiguous()
                 for g, dt in zip(out, dtypes))


def _plain_bwd_single_tile(scale, causal, res, do, delta, dtypes):
    """Plain version of the merged single-tile kernel: (dq, dk, dv)."""
    return _plain_grads(scale, causal, res, do, delta, dtypes,
                        ("dq", "dk", "dv"))


def _plain_bwd_dq(scale, causal, res, do, delta, dtype):
    """Plain version of the dQ kernel."""
    return _plain_grads(scale, causal, res, do, delta, (dtype,), ("dq",))[0]


def _plain_bwd_dkv(scale, causal, res, do, delta, dtypes):
    """Plain version of the dK/dV kernel: (dk, dv)."""
    return _plain_grads(scale, causal, res, do, delta, dtypes, ("dk", "dv"))


def _bwd_args(name, scale, causal, res, do, delta, out_dtypes):
    """Checks shared by the three backward wrappers; returns the
    leading C arguments (pointers of q, k, v, dO, LSE, δ), or None for a
    planned ``q`` (``_cuda.planned``: the shape rule)."""
    q, k, v, lse = res
    dev = q.device
    if dev.type != "cuda" and not (dev.type == "meta" and _cuda.planned(q)):
        raise ValueError(f"{name}: unsupported device {dev}")
    _cuda.check_cuda(name, (q, k, v, do, lse, delta), dev)
    if q.dtype not in _cuda.DTYPE_CODE or any(
            t.dtype != q.dtype for t in (k, v, do)):
        raise TypeError(f"{name} takes f32 or bf16 q/k/v/dO of one dtype, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}/{do.dtype}")
    b, sq, h, _ = q.shape
    for t, what in ((lse, "lse"), (delta, "delta")):
        if t.dtype != torch.float32 or t.numel() != b * h * sq:
            raise ValueError(f"{name}: {what} must be f32 [B*H, Sq, 1]")
    if len(set(out_dtypes)) != 1 or out_dtypes[0] not in _cuda.DTYPE_CODE:
        raise TypeError(f"{name}: gradients of one dtype, f32 or bf16, "
                        f"got {out_dtypes}")
    if _cuda.planned(q):
        return None
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())


def _tc_check(name, res, do):
    """What a tensor-core backward kernel takes beyond ``_bwd_args``:
    bf16 at D 64 or 128, TMA-aligned q/k/v/dO."""
    q, k, v = res[0], res[1], res[2]
    if not _tc_route(q.dtype, q.shape[3]):
        raise TypeError(f"{name} takes bf16 at D in {_TC_HEAD_DIMS}, got "
                        f"{q.dtype} at D {q.shape[3]}")
    if not _cuda.planned(q):
        _tma_aligned(name, (q, k, v, do))


def _dims(res, causal, scale):
    q, k = res[0], res[1]
    b, sq, h, d = q.shape
    return (b, sq, k.shape[1], h, d, int(bool(causal)), float(scale),
            _cuda.DTYPE_CODE[q.dtype])


def _bwd_single_tile(scale, causal, res, do, delta, dtypes):
    """Merged dQ/dK/dV (``_bwd_single_tile_kernel``): one launch, P and
    dS computed once; the wgmma or the mma.sync kernel, by
    ``_tc_route``."""
    q = res[0]
    if q.device.type == "cpu":
        return _plain_bwd_single_tile(scale, causal, res, do, delta, dtypes)
    kern = _bwd_single_tile_tc if _tc_route(q.dtype, q.shape[3]) else \
        _bwd_single_tile_mma
    return kern(scale, causal, res, do, delta, dtypes)


def _single_tile_outputs(res, dtypes):
    """The merged kernels' outputs and their zeroed f32 dQ scratch and
    per-head tickets; with an f32 output the scratch is dQ itself (no
    tickets). Returns (their pointers, or None for a planned ``q``; (dq,
    dk, dv))."""
    q, k = res[0], res[1]
    dev = q.device
    out = dtypes[0]
    dq_acc = torch.zeros(q.shape, device=dev, dtype=torch.float32)
    if out == torch.float32:
        dq, tickets = dq_acc, None
    else:
        dq = torch.empty(q.shape, device=dev, dtype=out)
        tickets = torch.zeros(q.shape[0] * q.shape[2], device=dev,
                              dtype=torch.int32)
    dk = torch.empty(k.shape, device=dev, dtype=out)
    dv = torch.empty(k.shape, device=dev, dtype=out)
    if _cuda.planned(q):
        return None, (dq, dk, dv)
    return (None if dq is dq_acc else dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dq_acc.data_ptr(),
            None if tickets is None else tickets.data_ptr()), (dq, dk, dv)


def _bwd_single_tile_mma(scale, causal, res, do, delta, dtypes):
    """mma.sync merged kernel (``csrc/flash_attention_bwd.cu``, 3xTF32):
    f32, or bf16 at a head dim the wgmma kernel does not take."""
    global FLASH_BWD_SINGLE_LAUNCHES
    name = "flash_attention_bwd_single_tile"
    ptrs = _bwd_args(name, scale, causal, res, do, delta, dtypes)
    dev = res[0].device
    out_ptrs, grads = _single_tile_outputs(res, dtypes)
    if ptrs is None:
        return grads
    fn = _cuda.entry("flash_attention_bwd", name, "ppppppppppp" "iiiiiifiip")
    with torch.cuda.device(dev):
        err = fn(*ptrs, *out_ptrs, *_dims(res, causal, scale),
                 _cuda.DTYPE_CODE[dtypes[0]], _cuda.stream_handle(dev))
    _cuda.raise_on_error(name, err)
    FLASH_BWD_SINGLE_LAUNCHES += 1
    if _pstats.ACTIVE is not None:
        _pstats.note_kernel(name, flash_bwd_cost, "single", res[0], res[1],
                            causal, dtypes[0])
    return grads


def _bwd_single_tile_tc(scale, causal, res, do, delta, dtypes):
    """Tensor-core merged kernel
    (``csrc/flash_attention_bwd_single_tile_tc.cu``): bf16 inputs at D 64
    or 128, gradients in bf16 or f32."""
    global FLASH_BWD_SINGLE_TC_LAUNCHES
    name = "flash_attention_bwd_single_tile_tc"
    ptrs = _bwd_args(name, scale, causal, res, do, delta, dtypes)
    _tc_check(name, res, do)
    dev = res[0].device
    out_ptrs, grads = _single_tile_outputs(res, dtypes)
    if ptrs is None:
        return grads
    fn = _cuda.entry(name, name, "ppppppppppp" "iiiiiifip")
    with torch.cuda.device(dev):
        err = fn(*ptrs, *out_ptrs, *_dims(res, causal, scale)[:-1],
                 _cuda.DTYPE_CODE[dtypes[0]], _cuda.stream_handle(dev))
    _cuda.raise_on_error(name, err)
    FLASH_BWD_SINGLE_TC_LAUNCHES += 1
    if _pstats.ACTIVE is not None:
        _pstats.note_kernel(name, flash_bwd_cost, "single", res[0], res[1],
                            causal, dtypes[0])
    return grads


def _bwd_dq(scale, causal, res, do, delta, dtype):
    """dQ over k tiles (``_bwd_dq_kernel``): the wgmma or the mma.sync
    kernel, by ``_tc_route``."""
    q = res[0]
    if q.device.type == "cpu":
        return _plain_bwd_dq(scale, causal, res, do, delta, dtype)
    kern = _bwd_dq_tc if _tc_route(q.dtype, q.shape[3]) else _bwd_dq_mma
    return kern(scale, causal, res, do, delta, dtype)


def _bwd_dq_mma(scale, causal, res, do, delta, dtype):
    """mma.sync dQ (``csrc/flash_attention_bwd.cu``, 3xTF32): f32, or
    bf16 at a head dim the wgmma kernel does not take."""
    global FLASH_BWD_DQ_LAUNCHES
    name = "flash_attention_bwd_dq"
    ptrs = _bwd_args(name, scale, causal, res, do, delta, (dtype,))
    q = res[0]
    dq = torch.empty(q.shape, device=q.device, dtype=dtype)
    if ptrs is None:
        return dq
    fn = _cuda.entry("flash_attention_bwd", name, "ppppppp" "iiiiiifiip")
    with torch.cuda.device(q.device):
        err = fn(*ptrs, dq.data_ptr(), *_dims(res, causal, scale),
                 _cuda.DTYPE_CODE[dtype], _cuda.stream_handle(q.device))
    _cuda.raise_on_error(name, err)
    FLASH_BWD_DQ_LAUNCHES += 1
    if _pstats.ACTIVE is not None:
        _pstats.note_kernel(name, flash_bwd_cost, "dq", res[0], res[1],
                            causal, dtype)
    return dq


def _bwd_dq_tc(scale, causal, res, do, delta, dtype):
    """Tensor-core dQ (``csrc/flash_attention_bwd_dq_tc.cu``): bf16
    inputs at D 64 or 128, dQ in bf16 or f32."""
    global FLASH_BWD_DQ_TC_LAUNCHES
    name = "flash_attention_bwd_dq_tc"
    ptrs = _bwd_args(name, scale, causal, res, do, delta, (dtype,))
    _tc_check(name, res, do)
    q = res[0]
    dq = torch.empty(q.shape, device=q.device, dtype=dtype)
    if ptrs is None:
        return dq
    fn = _cuda.entry(name, name, "ppppppp" "iiiiiifip")
    with torch.cuda.device(q.device):
        err = fn(*ptrs, dq.data_ptr(), *_dims(res, causal, scale)[:-1],
                 _cuda.DTYPE_CODE[dtype], _cuda.stream_handle(q.device))
    _cuda.raise_on_error(name, err)
    FLASH_BWD_DQ_TC_LAUNCHES += 1
    if _pstats.ACTIVE is not None:
        _pstats.note_kernel(name, flash_bwd_cost, "dq", res[0], res[1],
                            causal, dtype)
    return dq


def _bwd_dkv(scale, causal, res, do, delta, dtypes):
    """dK/dV over q tiles from the diagonal on (``_bwd_dkv_kernel``): the
    wgmma or the mma.sync kernel, by ``_tc_route``."""
    q = res[0]
    if q.device.type == "cpu":
        return _plain_bwd_dkv(scale, causal, res, do, delta, dtypes)
    kern = _bwd_dkv_tc if _tc_route(q.dtype, q.shape[3]) else _bwd_dkv_mma
    return kern(scale, causal, res, do, delta, dtypes)


def _bwd_dkv_mma(scale, causal, res, do, delta, dtypes):
    """mma.sync dK/dV (``csrc/flash_attention_bwd.cu``, 3xTF32): f32, or
    bf16 at a head dim the wgmma kernel does not take."""
    global FLASH_BWD_DKV_LAUNCHES
    name = "flash_attention_bwd_dkv"
    ptrs = _bwd_args(name, scale, causal, res, do, delta, dtypes)
    k = res[1]
    dk = torch.empty(k.shape, device=k.device, dtype=dtypes[0])
    dv = torch.empty(k.shape, device=k.device, dtype=dtypes[1])
    if ptrs is None:
        return dk, dv
    fn = _cuda.entry("flash_attention_bwd", name, "pppppppp" "iiiiiifiip")
    with torch.cuda.device(k.device):
        err = fn(*ptrs, dk.data_ptr(), dv.data_ptr(),
                 *_dims(res, causal, scale), _cuda.DTYPE_CODE[dtypes[0]],
                 _cuda.stream_handle(k.device))
    _cuda.raise_on_error(name, err)
    FLASH_BWD_DKV_LAUNCHES += 1
    if _pstats.ACTIVE is not None:
        _pstats.note_kernel(name, flash_bwd_cost, "dkv", res[0], res[1],
                            causal, dtypes[0])
    return dk, dv


def _bwd_dkv_tc(scale, causal, res, do, delta, dtypes):
    """Tensor-core dK/dV (``csrc/flash_attention_bwd_dkv_tc.cu``): bf16
    inputs at D 64 or 128, gradients in bf16 or f32."""
    global FLASH_BWD_DKV_TC_LAUNCHES
    name = "flash_attention_bwd_dkv_tc"
    ptrs = _bwd_args(name, scale, causal, res, do, delta, dtypes)
    _tc_check(name, res, do)
    k = res[1]
    dk = torch.empty(k.shape, device=k.device, dtype=dtypes[0])
    dv = torch.empty(k.shape, device=k.device, dtype=dtypes[1])
    if ptrs is None:
        return dk, dv
    fn = _cuda.entry(name, name, "pppppppp" "iiiiiifip")
    with torch.cuda.device(k.device):
        err = fn(*ptrs, dk.data_ptr(), dv.data_ptr(),
                 *_dims(res, causal, scale)[:-1], _cuda.DTYPE_CODE[dtypes[0]],
                 _cuda.stream_handle(k.device))
    _cuda.raise_on_error(name, err)
    FLASH_BWD_DKV_TC_LAUNCHES += 1
    if _pstats.ACTIVE is not None:
        _pstats.note_kernel(name, flash_bwd_cost, "dkv", res[0], res[1],
                            causal, dtypes[0])
    return dk, dv
