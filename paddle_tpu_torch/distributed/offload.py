"""Host offload of the hybrid trainer's state, streamed through the card
around the update (mirrors the offload and ``stream_layers`` paths of
``paddle_tpu/distributed/hybrid.py:74-125, 217-270, 867-1358``).

``offload_optimizer``: the optimizer's moments live in pinned host
memory. ``offload_params``: the parameters' f32 masters do too, and the
model's parameters on the card become bf16 compute copies (the forward's
amp copies; their gradients are bf16). Each step streams the state of
one parameter group after another through the card:

    fetch group k+depth (host -> card, copy stream)  ∥
    update group k (the compute stream)               ∥
    write back group k (card -> host, second copy stream)

A fetch waits for the update ``offload_depth`` groups back (a CUDA event:
PyTorch's counterpart of the reference's ``optimization_barrier``
chain), and the host waits for group k-depth-1's write-back before it
allocates group k's buffers, so at most about ``offload_depth`` groups'
working sets are on the card. The update is the resident path's
(``opt._update_param`` on the f32 master or the parameter, then the
cast back to the storage dtypes), in the same order, so an offloaded run
computes what a resident run computes; the compute copy is the new
master cast to bf16.

Groups: ``stream_layers`` holds the state per layer (one group a layer,
then one a non-block parameter, the reference's order); without it a
group is one parameter suffix over every layer of the stage (the
reference's stacked group). The first ``offload_depth`` fetches are
issued when the step starts and run under the forward and backward;
``conservative_fetch`` issues them after the backward (no overlap). With
``offload_params`` the compute copies persist on the card between steps:
each update writes them from the new masters.

On the card host state is pinned (``pin_memory``; it raises when it
cannot, and the state never quietly stays on the card). On the CPU the
device is the host: the state is a host tensor and the copies are
synchronous.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from .strategy_compiler import _ShardedUpdate, select_update

__all__ = ["_OffloadUpdate"]


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``: pinned when ``t`` is on the card."""
    t = t.detach()
    if t.device.type == "cuda":
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        return h
    return t.clone()


class _OffloadUpdate(_ShardedUpdate):
    """``_ShardedUpdate`` (per-parameter route, no ZeRO slice over dp)
    whose optimizer state and, with ``offload_params``, f32 masters live
    on the host and stream through the device around each group's
    update."""

    def __init__(self, *args, offload_optimizer: bool = False,
                 offload_params: bool = False,
                 groups: Optional[List[List[int]]] = None, depth: int = 2,
                 conservative: bool = False, **kw):
        super().__init__(*args, **kw)
        if self.manual or any(d is not None for d in self.sdim):
            raise NotImplementedError(
                "host offload with ZeRO sharding over dp is not supported "
                "by the port: offload at ZeRO 0, or shard without offload")
        self.offload_optimizer = bool(offload_optimizer)
        self.offload_params = bool(offload_params)
        self.depth = max(1, int(depth))
        self.conservative = bool(conservative)
        self.groups = groups if groups is not None else \
            [[i] for i in range(len(self.params))]
        self.dev = self.params[0].device
        cuda = self.dev.type == "cuda"
        self.h2d = torch.cuda.Stream(self.dev) if cuda else None
        self.d2h = torch.cuda.Stream(self.dev) if cuda else None
        with torch.no_grad():
            if self.offload_optimizer:
                self.states = [{k: _host(v) for k, v in st.items()}
                               for st in self.states]
                for p, st in zip(self.params, self.states):
                    if id(p) in self.opt._accumulators:
                        self.opt._accumulators[id(p)] = st
            self.master: List[Optional[torch.Tensor]] = \
                [None] * len(self.params)
            if self.offload_params:
                for i, p in enumerate(self.params):
                    if p.is_floating_point():
                        self.master[i] = _host(p.data)
                        p.data = p.data.to(torch.bfloat16)
        self._wb: List[Optional[object]] = [None] * len(self.groups)
        self._fetched: dict = {}
        self._whole = False          # sync_to_layer left f32 parameters

    # -- streams ---------------------------------------------------------
    def _record(self, stream=None):
        """An event on ``stream``, by default the current stream of the
        parameters' card (not of the caller's current device)."""
        if self.h2d is None:
            return None
        ev = torch.cuda.Event()
        ev.record(stream if stream is not None
                  else torch.cuda.current_stream(self.dev))
        return ev

    def _fetch(self, g: int) -> None:
        """Group g's host state onto the device (the copy stream), after
        the compute stream's work so far and the previous step's
        write-back of the same group."""
        back = g - self.depth - 1
        if back >= 0 and self._wb[back] is not None:
            self._wb[back].synchronize()          # bound the working set
        bufs = {}
        for i in self.groups[g]:
            if self.master[i] is not None:
                bufs[("m", i)] = (self.master[i],
                                  torch.empty_like(self.master[i],
                                                   device=self.dev))
            if self.offload_optimizer:
                for k, v in self.states[i].items():
                    bufs[(k, i)] = (v, torch.empty_like(v, device=self.dev))
        ready = self._record()
        if self.h2d is None:
            for host, buf in bufs.values():
                buf.copy_(host)
        else:
            with torch.cuda.stream(self.h2d):
                self.h2d.wait_event(ready)
                if self._wb[g] is not None:
                    self.h2d.wait_event(self._wb[g])
                for host, buf in bufs.values():
                    buf.copy_(host, non_blocking=True)
        self._fetched[g] = (bufs, self._record(self.h2d))

    def _take(self, g: int) -> dict:
        if g not in self._fetched:
            self._fetch(g)
        bufs, ev = self._fetched.pop(g)
        if ev is not None:
            torch.cuda.current_stream(self.dev).wait_event(ev)
        return bufs

    def _write_back(self, g: int, bufs: dict) -> None:
        done = self._record()
        if self.d2h is None:
            for host, buf in bufs.values():
                host.copy_(buf)
            return
        with torch.cuda.stream(self.d2h):
            self.d2h.wait_event(done)
            for host, buf in bufs.values():
                host.copy_(buf, non_blocking=True)
                buf.record_stream(self.d2h)
        self._wb[g] = self._record(self.d2h)

    def host_state(self) -> List[torch.Tensor]:
        """The state that lives on the host: the moments under
        ``offload_optimizer``, the f32 masters under ``offload_params``
        (a plan's host-resident arguments, ``plan.py``)."""
        out = [v for st in self.states for v in st.values()] \
            if self.offload_optimizer else []
        return out + [m for m in self.master if m is not None]

    def host_sync(self) -> None:
        """Wait for every write-back: the host state is current."""
        for ev in self._wb:
            if ev is not None:
                ev.synchronize()

    # -- the trainer's side ----------------------------------------------
    @torch.no_grad()
    def start_step(self) -> None:
        """At the top of a step: the compute copies back from f32 after a
        ``sync``, and the first ``depth`` fetches (unless
        ``conservative``)."""
        if self._whole:
            for p, m in zip(self.params, self.master):
                if m is not None:
                    p.data = p.data.to(torch.bfloat16)
            self._whole = False
        if not self.conservative:
            for g in range(min(self.depth, len(self.groups))):
                if g not in self._fetched:
                    self._fetch(g)

    @torch.no_grad()
    def update(self, lr: float, step_no: int,
               loss: Optional[torch.Tensor] = None
               ) -> Optional[torch.Tensor]:
        """The streamed update; with ``loss``, guarded as the resident
        one: the deselect runs on the device copies fetched for the
        update, before they are written back to the host (reference
        ``hybrid.py:172-175``), so a bad step streams nothing twice."""
        opt = self.opt
        self._axis_sums()
        grads = self._reduced_grads()
        self._clip(opt._grad_clip, grads)
        ok = None if loss is None else self.verdict(loss, grads)
        for g in range(min(self.depth, len(self.groups))):
            if g not in self._fetched:
                self._fetch(g)
        for g, group in enumerate(self.groups):
            bufs = self._take(g)
            for i in group:
                p = self.params[i]
                if not p.requires_grad or grads[i] is None:
                    continue
                target = bufs[("m", i)][1] if ("m", i) in bufs \
                    else self._view(i)
                st = {k: bufs[(k, i)][1] for k in self.states[i]} \
                    if self.offload_optimizer else self.states[i]
                select_update(opt, target, grads[i], st, lr, step_no,
                              opt._lr_ratio(p), opt._decoupled_wd(p), ok)
                if ("m", i) in bufs:
                    p.data.copy_(target)
            nxt = g + self.depth
            if nxt < len(self.groups) and nxt not in self._fetched:
                self._fetch(nxt)
            self._write_back(g, bufs)
        return ok

    # -- checkpoint pieces, ledger, sync -----------------------------------
    def _stored(self, i: int) -> torch.Tensor:
        if self.master[i] is not None:
            return self.master[i]
        return super()._stored(i)

    def state_pieces(self, model, cut_axes) -> dict:
        self.host_sync()
        return super().state_pieces(model, cut_axes)

    @torch.no_grad()
    def load_pieces(self, model, cut_axes, st: dict) -> None:
        """Restore into the host state, then rebuild the compute copies
        from the masters (derived state: never saved)."""
        self.host_sync()
        self._fetched.clear()
        super().load_pieces(model, cut_axes, st)
        for p, m in zip(self.params, self.master):
            if m is not None:
                p.data.copy_(m.to(self.dev))

    def _window(self, bytes_of) -> int:
        """The most bytes ``depth`` consecutive groups hold."""
        sizes = [sum(bytes_of(i) for i in grp) for grp in self.groups]
        return max((sum(sizes[g:g + self.depth])
                    for g in range(len(sizes))), default=0)

    def ledger(self) -> dict:
        """Device bytes by category as the base counts them, with the
        offloaded categories at the streamed window (``depth`` groups'
        worth): an estimate from the schedule, not a reading of the
        allocator; the host's apart (real tensors): ``host_opt_state``
        and ``host_master``."""
        from ..profiler import instrument as _pinstr

        self.host_sync()

        def state_bytes(i):
            return sum(v.numel() * v.element_size()
                       for v in self.states[i].values())

        def master_bytes(i):
            m = self.master[i]
            return 0 if m is None else m.numel() * m.element_size()

        leaves = self.leaves()
        cats = {"param": leaves,
                "grad": sum(t.numel() * (t.element_size()
                                         if self.offload_params else 4)
                            for t in leaves)}
        if self.offload_optimizer:
            cats["opt_state"] = self._window(state_bytes)
            cats["host_opt_state"] = self.states
        else:
            cats["opt_state"] = self.states
        if self.offload_params:
            cats["master"] = self._window(master_bytes)
            cats["host_master"] = [m for m in self.master if m is not None]
        return _pinstr.record_memory_ledger(cats)

    @torch.no_grad()
    def sync(self) -> None:
        """Whole f32 parameters (the masters) in the model and device
        copies of the states in the optimizer; the next step casts the
        compute copies again."""
        self.host_sync()
        for i, p in enumerate(self.params):
            if self.master[i] is not None:
                p.data = self.master[i].to(self.dev)
                self._whole = True
            if self.offload_optimizer:
                self.opt._accumulators[id(p)] = {
                    k: v.to(self.dev) for k, v in self.states[i].items()}
