"""Mixture-of-Experts FFN with experts sharded over an ``ep`` mesh axis
(mirrors ``paddle_tpu/distributed/moe.py``).

Routing is the reference's: top-k rounds over the transposed ``[E, T]``
probabilities, each round's capacity slot by a cumsum of earlier tokens
routed to the same expert (earlier rounds first), capacity ``cap =
ceil(capacity_factor · k · T / E)``, overflow tokens dropped (they fall
through the residual), and the Switch load-balance loss ``E · Σ_e
(fraction_e / k) · mean-prob_e``. Dispatch and combine are gathers
whose backward functions are gathers too (``_DispatchGather``,
``_CombineGather``): within a round a token holds at most one slot, so
the transpose of each gather is a gather through the inverse map.

**The routing group.** Under GSPMD the reference's ``switch_moe`` sees
the global micro-batch: T, the capacity, the slot positions and the
aux means are taken over every token across ``dp`` (and ``sp`` when it
is not manual). A rank of the port holds its slice, so it routes over
the ranks of ``context.moe_routing_scope`` (the trainers open it): the
per-row, per-expert counts of every round are all-gathered over the
group (one ``all_gather``), and each token's global slot position is
its position within its own row plus the counts of every token before
it in the global order (rows over ``dp`` first, then the row's ``sp``
shards). The sum gives the next round's ``prior``; the aux fractions
and mean probabilities are global means (the probabilities through a
differentiable ``psum`` over the group). Outside a scope a rank routes
its own tokens, which is the reference's arithmetic on that batch.

**Expert parallelism.** Every ``ep`` rank holds the same tokens (the
trainers cut the batch over ``dp`` only) and routes them identically.
``MoEMLP`` built under a mesh with ``ep`` > 1 holds ``E/ep`` experts
(``param_shardings`` cut ``[E, ...]`` on ``ep``); a rank computes the
slots of its own experts and combines them, and the partial outputs are
summed over ``ep``. That sum is a conjugate pair, as Megatron's tp
layers are (``parallel_layers._CopyToTP``/``_ReduceFromTP``): identity
forward and all-reduce backward on the layer's inputs (the tokens and
the gate weight), all-reduce forward and identity backward on its
output. The replicated gate and the tokens then get equal, complete
gradients on every ``ep`` rank. The aux loss, which every ``ep`` rank
computes whole, enters the gradient at ``1/ep`` (its value unchanged),
so that the all-reduce counts it once. No all-to-all is needed.

The experts' batched products stay ``torch`` matrix products (no
Pallas kernel in the reference); routing, dispatch and combine are
plain PyTorch.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.autograd import Function
from torch.nn import functional as TF

from ..nn import initializer as I
from .collective import ReduceOp
from .mesh import P, get_mesh

__all__ = ["MoEMLP", "switch_moe"]


class _DispatchGather(Function):
    """``xe[s] = x[token_of_slot[s]]``; backward ``dx[t] = Σ_k valid[k,
    t] ? g[slot_of_token[k, t]] : 0`` (gathers only)."""

    @staticmethod
    def forward(ctx, x, token_of_slot, slot_of_token, valid):
        ctx.save_for_backward(slot_of_token, valid)
        return x[token_of_slot]

    @staticmethod
    def backward(ctx, g):
        slot_of_token, valid = ctx.saved_tensors
        dx = None
        for k in range(slot_of_token.shape[0]):
            dk = torch.where(valid[k][:, None], g[slot_of_token[k]], 0.0)
            dx = dk if dx is None else dx + dk
        return dx.to(g.dtype), None, None, None


class _CombineGather(Function):
    """``y[t] = Σ_k valid[k, t] · gates[k, t] · ye[slot_of_token[k, t]]``;
    backward: ``dye[s] = occupied[s] ? dy[token_of_slot[s]] ·
    gates[round_of_slot[s], token_of_slot[s]] : 0`` and ``dgates[k, t] =
    valid ? <dy[t], ye[slot]> : 0`` (gathers only)."""

    @staticmethod
    def forward(ctx, ye, gates, slot_of_token, valid, token_of_slot,
                round_of_slot, occupied):
        ctx.save_for_backward(ye, gates, slot_of_token, valid,
                              token_of_slot, round_of_slot, occupied)
        y = None
        for k in range(slot_of_token.shape[0]):
            w = (gates[k] * valid[k]).to(ye.dtype)[:, None]
            c = ye[slot_of_token[k]] * w
            y = c if y is None else y + c
        return y

    @staticmethod
    def backward(ctx, dy):
        ye, gates, slot_of_token, valid, token_of_slot, round_of_slot, \
            occupied = ctx.saved_tensors
        wsel = gates[round_of_slot, token_of_slot].to(ye.dtype)
        dye = torch.where(occupied[:, None], dy[token_of_slot] *
                          wsel[:, None], 0.0).to(ye.dtype)
        dgs = []
        for k in range(slot_of_token.shape[0]):
            contrib = (dy.float() * ye[slot_of_token[k]].float()).sum(-1)
            dgs.append(torch.where(valid[k], contrib, 0.0))
        return dye, torch.stack(dgs), None, None, None, None, None


def _group(route):
    """(mesh, axes, group size, index along the axes) of a routing scope
    (None: the rank alone)."""
    if route is None:
        return None
    mesh, axes = route
    return mesh, axes, mesh.axis_size(axes), mesh.axis_index(axes)


def switch_moe(x, gate_w, w_in, b_in, w_out, b_out, *, top_k=1,
               capacity_factor=1.25, rows: int = 1, route=None,
               ep: Optional[Tuple] = None, stats: Optional[dict] = None):
    """MoE FFN over this rank's tokens. x: ``[T, H]`` (``rows`` rows of
    ``T/rows`` positions, row-major); gate_w ``[H, E]``; experts stacked
    ``w_in [E_l, H, F]``, ``b_in [E_l, F]``, ``w_out [E_l, F, H]``,
    ``b_out [E_l, H]`` (``E_l = E/ep``: this rank's experts).

    ``route``: ``(mesh, axes)`` of the routing group
    (``context.current_moe_routing()``; None: this rank alone). ``ep``:
    ``(group, size, index)`` of the expert-parallel axis, or None.

    Returns ``(y [T, H], aux)``: ``y`` this rank's tokens' outputs (summed
    over ``ep``) and ``aux`` the group's Switch load-balance loss (f32).
    ``stats``, a dict, receives the routing: each round's ``experts``
    and ``kept`` ``[K, T]`` and the ``top`` k + 1 probabilities ``[k+1,
    T]`` (a round's choice is clear of rounding where its margin over the
    next is)."""
    from . import primitives as prim
    from .parallel_layers import _CopyToTP, _ReduceFromTP

    t, h = x.shape
    e = gate_w.shape[1]
    grp = _group(route)
    g_size = grp[2] if grp else 1
    t_all = t * g_size
    cap = max(1, int(math.ceil(capacity_factor * top_k * t_all / e)))
    ep_group, ep_n, ep_idx = ep if ep is not None else (None, 1, 0)
    if ep_n > 1:
        x = _CopyToTP.apply(x, ep_group)
        gate_w = _CopyToTP.apply(gate_w, ep_group)
    dev = x.device

    # -- routing: top_k rounds over [E, T] ------------------------------
    logits_t = gate_w.to(x.dtype).t() @ x.t()                  # [E, T]
    probs_t = torch.softmax(logits_t.float(), dim=0)
    ar = torch.arange(e, device=dev)[:, None]
    expert_rounds, gate_rounds, onehots = [], [], []
    remaining = probs_t
    for _ in range(top_k):
        idx = remaining.argmax(0)                               # [T]
        onehot = ar == idx[None, :]                             # [E, T]
        expert_rounds.append(idx)
        onehots.append(onehot)
        gate_rounds.append((remaining * onehot).sum(0))
        remaining = remaining * (~onehot)

    # every round's per-row, per-expert counts, over the group
    oh = torch.stack(onehots).reshape(top_k, e, rows, t // rows)
    counts = oh.sum(-1).transpose(1, 2)                          # [K, rows, E]
    if grp:
        mesh, axes, n, me = grp
        every = prim._gather(counts, mesh.group(axes),
                             mesh.group_order(axes), 0, False)  # [G,K,rows,E]
        # rows of earlier ranks of the group: the global order is (dp
        # index, row, sp index, position); group index = dp-major
        n_dp = mesh.shape[axes[0]] if axes[0] == "dp" else 1
        n_sp = n // n_dp
        d0, q0 = divmod(me, n_sp)
        per = every.reshape(n_dp, n_sp, top_k, rows, e)
        before_dp = per[:d0].sum((0, 1, 3))                     # [K, E]
        row_all = per[d0].sum(0)                                # [K, rows, E]
        before_row = torch.cumsum(row_all, 1) - row_all
        before_sp = per[d0, :q0].sum(0)                         # [K, rows, E]
        offset = before_dp[:, None, :] + before_row + before_sp
        totals = every.sum((0, 2))                              # [K, E]
    else:
        offset = torch.cumsum(counts, 1) - counts
        totals = counts.sum(1)

    if stats is not None:
        with torch.no_grad():
            stats.update(experts=torch.stack(expert_rounds),
                         top=probs_t.topk(min(top_k + 1, e), dim=0).values)

    # -- dispatch: cumsum slot assignment -------------------------------
    prior = torch.zeros(e, dtype=torch.long, device=dev)
    slot_rounds, keep_rounds = [], []
    for k in range(top_k):
        o = oh[k].long()                                        # [E, rows, S]
        pos_in_row = torch.cumsum(o, -1) - o
        pos_e = pos_in_row + offset[k].t()[:, :, None]
        idx = expert_rounds[k]
        pos = (pos_e * o).sum(0).reshape(-1) + prior[idx]       # [T]
        prior = prior + totals[k]
        keep = pos < cap
        slot_rounds.append(torch.where(keep, idx * cap + pos, e * cap))
        keep_rounds.append(keep)

    if stats is not None:
        stats["kept"] = torch.stack(keep_rounds)

    # this rank's experts' slots: [base, base + E_l·cap)
    e_l = w_in.shape[0]
    base, n_slots = ep_idx * e_l * cap, e_l * cap
    slot_flat = torch.cat(slot_rounds)
    token_flat = torch.arange(t, device=dev).repeat(top_k)
    round_flat = torch.arange(top_k, device=dev).repeat_interleave(t)
    local = (slot_flat >= base) & (slot_flat < base + n_slots)
    tgt = torch.where(local, slot_flat - base, n_slots)
    token_of_slot = torch.zeros(n_slots + 1, dtype=torch.long, device=dev)
    token_of_slot[tgt] = token_flat
    round_of_slot = torch.zeros(n_slots + 1, dtype=torch.long, device=dev)
    round_of_slot[tgt] = round_flat
    occupied = torch.zeros(n_slots + 1, dtype=torch.bool, device=dev)
    occupied[tgt] = True
    token_of_slot, round_of_slot, occupied = (
        token_of_slot[:n_slots], round_of_slot[:n_slots], occupied[:n_slots])
    slot_of_token = torch.stack([(s - base).clamp(0, n_slots - 1)
                                 for s in slot_rounds])          # [K, T]
    valid = torch.stack([kp & (s >= base) & (s < base + n_slots)
                         for kp, s in zip(keep_rounds, slot_rounds)])

    xe = _DispatchGather.apply(x, token_of_slot, slot_of_token,
                               valid).reshape(e_l, cap, h)
    hmid = TF.gelu(torch.einsum("ech,ehf->ecf", xe, w_in.to(x.dtype))
                   + b_in.to(x.dtype)[:, None, :], approximate="tanh")
    ye = (torch.einsum("ecf,efh->ech", hmid, w_out.to(x.dtype))
          + b_out.to(x.dtype)[:, None, :]).reshape(e_l * cap, h)
    gates = torch.stack(gate_rounds)                             # [K, T]
    y = _CombineGather.apply(ye, gates, slot_of_token, valid,
                             token_of_slot, round_of_slot, occupied)

    # -- the Switch aux loss over the group -----------------------------
    frac = totals.float().sum(0) / t_all
    prob_sum = probs_t.sum(1)
    if grp:
        prob_sum = prim._AllReduce.apply(prob_sum, ReduceOp.SUM,
                                         grp[0].group(grp[1]), 1)
    aux = e * ((frac / top_k) * (prob_sum / t_all)).sum()
    if ep_n > 1:
        y = _ReduceFromTP.apply(y, ep_group)
        share = aux / ep_n
        aux = share + (aux - share).detach()
    return y, aux.float()


def _ep():
    """(degree, mesh) of the current mesh's ``ep`` axis."""
    mesh = get_mesh()
    if mesh is None or "ep" not in mesh.axis_names:
        return 1, None
    n = mesh.shape["ep"]
    return n, (mesh if n > 1 else None)


class MoEMLP(nn.Module):
    """Drop-in MoE replacement for a transformer FFN block (the
    reference's parameter names and layouts). ``forward(x [B, S, H])``;
    the load-balance loss of the last forward is ``self.aux_loss``.

    Built under a mesh whose ``ep`` axis is > 1 the layer holds this
    rank's ``num_experts / ep`` experts (``shard_reference_state`` cuts
    them on ``param_shardings``)."""

    def __init__(self, hidden_size: int, ffn_hidden_size: int,
                 num_experts: int, top_k: int = 1,
                 capacity_factor: float = 1.25,
                 initializer_range: float = 0.02, device=None):
        super().__init__()
        ep, mesh = _ep()
        if num_experts % ep:
            raise ValueError(f"num_experts {num_experts} does not split "
                             f"over ep={ep}")
        init = I.Normal(0.0, initializer_range)
        e, h, f = num_experts, hidden_size, ffn_hidden_size
        e_l = e // ep
        self.num_experts = e
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self._mesh = mesh

        def param(shape, normal):
            t = torch.empty(shape, device=device)
            if normal:
                init(t)
            else:
                t.zero_()
            return nn.Parameter(t)

        self.gate = param((h, e), True)
        self.w_in = param((e_l, h, f), True)
        self.b_in = param((e_l, f), False)
        self.w_out = param((e_l, f, h), True)
        self.b_out = param((e_l, h), False)
        # expert dim sharded over 'ep' (the trainers consume these)
        self.param_shardings = {
            "gate": P(), "w_in": P("ep", None, None),
            "b_in": P("ep", None), "w_out": P("ep", None, None),
            "b_out": P("ep", None)}
        self.aux_loss = torch.zeros((), device=device)
        #: the routing of the last forward (``switch_moe``'s ``stats``)
        self.last_route: dict = {}

    def forward(self, x):
        from .context import current_moe_routing

        b, s, h = x.shape
        mesh = self._mesh
        ep = None if mesh is None else (
            mesh.group("ep"), mesh.shape["ep"], mesh.axis_index("ep"))
        y, aux = switch_moe(
            x.reshape(b * s, h), self.gate, self.w_in, self.b_in,
            self.w_out, self.b_out, top_k=self.top_k,
            capacity_factor=self.capacity_factor, rows=b,
            route=current_moe_routing(), ep=ep, stats=self.last_route)
        self.aux_loss = aux
        return y.reshape(b, s, h)
