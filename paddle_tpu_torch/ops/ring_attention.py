"""Ring attention: sequence parallelism over a mesh axis (mirrors
``paddle_tpu/ops/ring_attention.py``).

Each rank holds ``S/sp`` consecutive rows of q, k and v. The K/V chunks
travel around the ring (rank i sends to rank i + 1), and at ring step t
rank ``idx`` attends its own queries to the chunk of rank ``src = (idx -
t) mod sp``. Under the causal mask that chunk is fully visible (src <
idx), the causal diagonal (src == idx) or fully masked (src > idx)
(``_branch``): ordinary causal or non-causal attention per chunk, so
the flash kernels serve every step unchanged. The steps merge with the
running-max ``(m, w, acc)`` of the online softmax; the logits never
exist beyond one chunk.

The backward is a second ring. dQ accumulates at home; the dK/dV
partials travel with their K/V chunk and take one extra hop to arrive
home after sp hops. Every chunk's backward is given the GLOBAL row's
``delta = rowsum(dO · O)`` and the ring's global LSE, so its P and dS
are the full attention's.

Both rings are one ``torch.autograd.Function`` (the reference's
``jax.custom_vjp``). On a CUDA tensor the chunks run the port's flash
kernels: the forward through the flash forward entry
(``flash_attention._flash_cuda``: the wgmma kernel for bf16 at D 64 or
128, else the SIMT kernel), which returns O and the LSE, and the
backward through ``flash_attention._bwd(..., delta=delta,
out_dtype=torch.float32)`` (the merged kernel for one tile each way,
else the dQ and dK/dV pair), whose f32 partials do not round before
the ring sums them. On a CPU tensor the chunks run the plain versions
(``_chunk_fwd_plain``, ``_chunk_bwd_plain``: the reference's
``_chunk_fwd_jnp`` and ``_chunk_bwd_jnp``).

A masked step still pays its permute (every rank issues the same
collectives in the same order) and skips its compute. The permutes are
``primitives``' ``collective_permute`` (noted for the accounting): per
forward ``2·(sp − 1)`` (K and V), per backward ``4·(sp − 1) + 2`` (K,
V, dK and dV, and the last hop of dK and dV home).

**The given delta on the card (ROADMAP queue 3 item 2).** The wgmma
backward kernels round P and dS to bf16 before their products, as the
reference's kernels do. With a delta computed from the kernel's own O
the rounding inputs are those of the plain version; with the ring's
global delta (an f32 sum over the ring's merged O, which the chunk
kernel never saw) a dS element that lies within an f32 ulp of a bf16
rounding boundary can round to the other side in the kernel and in the
plain version: one bf16 flip of P or dS. A flip moves dQ, dK or dV by
at most one bf16 ulp of that P or dS times the other operand's row,
which ``chip_smoke.given_delta_check`` measures directly. The chip
check therefore holds a given-delta chunk backward to ``BWD_TC_ATOL``
elementwise plus at most one such flip a row. The allowance applies
only where a delta is given: every other kernel check stays as it was.

``ring_attention`` is the per-rank call over ``axis_name`` of the
current mesh (the reference's inside-shard_map form);
``sequence_parallel_attention`` takes the mesh. The reference's
shard_map spelling of the latter has no counterpart: a rank of the port
already holds its sequence shard.
"""
from __future__ import annotations

import math

import torch
from torch.autograd import Function

from . import flash_attention as fa

__all__ = ["ring_attention", "sequence_parallel_attention"]

_NEG_INF = -1e30


def _use_kernel(q, sq, sk, d) -> bool:
    """The reference's ``_use_pallas``: chunks the flash kernels take."""
    return (q.device.type == "cuda"
            and fa._pick_block(sq, fa._BLOCK_Q) is not None
            and fa._pick_block(sk, fa._BLOCK_K) is not None
            and d <= 256 and sq == sk)


def _bh(t):
    """[B, S, H, X] -> [B*H, S, X]."""
    b, s, h = t.shape[:3]
    return t.transpose(1, 2).reshape(b * h, s, t.shape[3])


def _bshx(t, b, h):
    """[B*H, S, X] -> [B, S, H, X]."""
    return t.reshape(b, h, t.shape[1], t.shape[2]).transpose(1, 2)


# ---------------------------------------------------------------------------
# per-chunk forward: (o normalized in q's dtype, lse [B*H, S, 1] f32)
# ---------------------------------------------------------------------------
def _chunk_fwd_plain(q, k, v, scale, causal):
    q3, k3, v3 = _bh(q), _bh(k), _bh(v)
    s = torch.einsum("bqd,bkd->bqk", q3.float(), k3.float()) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bqk,bkd->bqd", (p / l).to(v.dtype).float(),
                     v3.float()).to(q.dtype)
    return _bshx(o, q.shape[0], q.shape[2]), m + torch.log(l)


def _chunk_fwd(q, k, v, scale, causal):
    if _use_kernel(q, q.shape[1], k.shape[1], q.shape[3]):
        return fa._flash_cuda(q, k, v, causal, scale)
    return _chunk_fwd_plain(q, k, v, scale, causal)


# ---------------------------------------------------------------------------
# per-chunk backward: f32 (dq, dk, dv) [B, S, H, D] given the global
# (lse, delta) [B*H, S, 1]
# ---------------------------------------------------------------------------
def _chunk_bwd_plain(q, k, v, do, lse, delta, scale, causal):
    b, h = q.shape[0], q.shape[2]
    q3, k3, v3, do3 = _bh(q), _bh(k), _bh(v), _bh(do)
    s = torch.einsum("bqd,bkd->bqk", q3.float(), k3.float()) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, _NEG_INF)
    p = torch.exp(s - lse)
    dv = torch.einsum("bqk,bqd->bkd", p.to(do.dtype).float(), do3.float())
    dp = torch.einsum("bqd,bkd->bqk", do3.float(), v3.float())
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bqk,bkd->bqd", ds.to(k.dtype).float(), k3.float())
    dk = torch.einsum("bqk,bqd->bkd", ds.to(q.dtype).float(), q3.float())
    return _bshx(dq, b, h), _bshx(dk, b, h), _bshx(dv, b, h)


def _chunk_bwd(q, k, v, do, lse, delta, scale, causal):
    if _use_kernel(q, q.shape[1], k.shape[1], q.shape[3]):
        bq, bk = fa._blocks(q.shape[1], k.shape[1], causal)
        return fa._bwd(scale, causal, bq, bk, (q, k, v, None, lse), do,
                       delta=delta, out_dtype=torch.float32)
    return _chunk_bwd_plain(q, k, v, do, lse, delta, scale, causal)


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------
def _branch(t: int, idx: int, sp: int, causal: bool) -> int:
    """0 = skip (masked), 1 = full, 2 = diagonal-causal, for ring step t
    on rank ``idx``."""
    if not causal:
        return 1
    src = (idx - t) % sp
    return 0 if src > idx else (1 if src < idx else 2)


def _shift(ring, *xs):
    """Each tensor one hop along the ring (rank i -> i + 1)."""
    from ..distributed.primitives import _permuted

    if ring is None:                  # a ring of one rank
        return xs
    pairs, ranks, group = ring
    return tuple(_permuted(x.contiguous(), pairs, ranks, group) for x in xs)


def _ring_fwd(q, k, v, causal, s_val, ring, sp, idx):
    """The forward ring: (o [B, S_loc, H, D] in q's dtype, the global LSE
    [B*H, S_loc, 1] f32)."""
    b, s_loc, h, d = q.shape
    m = torch.full((b * h, s_loc, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    w = torch.zeros_like(m)
    acc = torch.zeros((b * h, s_loc, d), dtype=torch.float32,
                      device=q.device)
    k_c, v_c = k, v
    for t in range(sp):
        br = _branch(t, idx, sp, causal)
        if br:
            o_t, lse_t = _chunk_fwd(q, k_c, v_c, s_val, br == 2)
            m_new = torch.maximum(m, lse_t)
            alpha = torch.exp(m - m_new)
            beta = torch.exp(lse_t - m_new)
            acc = acc * alpha + _bh(o_t).float() * beta
            w = w * alpha + beta
            m = m_new
        if t < sp - 1:
            k_c, v_c = _shift(ring, k_c, v_c)
    w_safe = torch.where(w == 0.0, 1.0, w)
    o = _bshx((acc / w_safe).to(q.dtype), b, h).contiguous()
    return o, (m + torch.log(w_safe)).contiguous()


class _Ring(Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, ring, sp, idx):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        s_val = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
        o, lse = _ring_fwd(q, k, v, causal, s_val, ring, sp, idx)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, s_val, ring, sp, idx)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, s_val, ring, sp, idx = ctx.args
        b, s_loc, h, d = q.shape
        do = do.to(q.dtype).contiguous()
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
            .reshape(b * h, s_loc, 1).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_c = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv_c = torch.zeros_like(dk_c)
        k_c, v_c = k, v
        for t in range(sp):
            br = _branch(t, idx, sp, causal)
            if br:
                dq_t, dk_t, dv_t = _chunk_bwd(q, k_c, v_c, do, lse, delta,
                                              s_val, br == 2)
                dq = dq + dq_t
                dk_c = dk_c + dk_t
                dv_c = dv_c + dv_t
            # the dK/dV partials travel with their chunk; the last hop
            # takes only them home
            if t < sp - 1:
                k_c, v_c, dk_c, dv_c = _shift(ring, k_c, v_c, dk_c, dv_c)
            else:
                dk_c, dv_c = _shift(ring, dk_c, dv_c)
        return (dq.to(q.dtype), dk_c.to(k.dtype), dv_c.to(v.dtype),
                None, None, None, None, None)


def _ring_of(mesh, axis_name):
    """(ring permute arguments, axis size, this rank's index)."""
    if mesh is None or axis_name not in mesh.axis_names:
        raise NameError(f"unbound axis name: {axis_name}")
    n = mesh.shape[axis_name]
    pairs = [(i, (i + 1) % n) for i in range(n)]
    return ((pairs, sorted(mesh.axis_ranks(axis_name)),
             mesh.group(axis_name)), n, mesh.axis_index(axis_name))


def _ring_mha(q, k, v, causal, scale, mesh, axis_name):
    ring, sp, idx = _ring_of(mesh, axis_name)
    if sp == 1:
        ring = None
    return _Ring.apply(q, k, v, causal, scale, ring, sp, idx)


def ring_attention(q, k, v, axis_name: str = "sp", causal: bool = True,
                   scale=None):
    """Ring attention over ``axis_name`` of the current mesh
    (``mesh.get_mesh()``). q, k, v: this rank's ``[batch, seq_local,
    heads, head_dim]`` shard; returns the local shard of the output.
    Differentiable in q, k and v (the backward ring)."""
    from ..distributed.mesh import get_mesh

    return _ring_mha(q, k, v, causal, scale, get_mesh(), axis_name)


def sequence_parallel_attention(q, k, v, mesh, causal: bool = True,
                                scale=None, axis_name: str = "sp"):
    """Ring attention over ``axis_name`` of ``mesh``: q, k, v are this
    rank's sequence shards (dim 1) of the global ``[B, S, H, D]``
    arrays, in rank order along the axis."""
    return _ring_mha(q, k, v, causal, scale, mesh, axis_name)
