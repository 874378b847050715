"""Model-agnostic trainer, degree-1 path (mirrors
``paddle_tpu/distributed/hybrid.py``).

The model declares the reference's three-method pipeline protocol
(``models/gpt.py``):

  pipeline_stem(*batch)  -> activations       (embeddings)
  pipeline_blocks()      -> list of identical blocks
  pipeline_head(x, *batch) -> scalar loss     (norm + head + loss)

One ``step(*batch)`` on one device: the batch splits on dim 0 into
``n_micro`` micro-batches (``pipeline.py``'s ``_to_microbatches``), each
runs stem -> blocks -> head and its backward, and the gradients
accumulate. A micro-batch's mean loss is weighed by its share of the
whole batch's non-ignored targets (``pipeline_label_count``, when the
model has it; equal shares otherwise), so the step's loss and gradients
equal the reference's one head over the full output. Then the
optimizer's clip, the reference's update rule at ``optimizer.get_lr()``
and the cast-back to the storage dtypes.

The trainer trains the model's own parameters in place: there is no
stacked copy, and ``sync_to_layer()`` returns the model.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core.dtype import convert_dtype
from ..optimizer.clip import functional_clip
from ..profiler import instrument as _pinstr
from ..profiler import is_enabled as _prof_enabled
from ..profiler import program_stats as _pstats
from ..profiler import recompile as _precomp
from ..profiler import registry as _preg
from ..profiler import trace as _ptrace
from .fleet.distributed_strategy import DistributedStrategy


def _check_protocol(model):
    for m in ("pipeline_stem", "pipeline_blocks", "pipeline_head"):
        if not hasattr(model, m):
            raise TypeError(
                f"{type(model).__name__} does not implement the pipeline "
                f"protocol ({m}); see distributed/hybrid.py docstring")


def _queue(item: int, what: str) -> NotImplementedError:
    names = {7: "distributed training", 8: "resilience"}
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP queue 1 item {item} "
        f"({names[item]})")


@contextlib.contextmanager
def _swapped_params(module: torch.nn.Module, values: Dict[str, torch.Tensor]):
    """Run ``module`` with ``values`` in place of the named parameters
    (the reference's ``_swapped_state``): the amp compute copies. The
    stored parameters come back on exit."""
    saved = []
    for name, t in values.items():
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        saved.append((mod, leaf, mod._parameters[leaf]))
        mod._parameters[leaf] = t
    try:
        yield
    finally:
        for mod, leaf, p in reversed(saved):
            mod._parameters[leaf] = p


class HybridPipelineTrainer:
    """Trainer for any pipeline-protocol model on one device."""

    def __init__(self, model, optimizer,
                 strategy: Optional[DistributedStrategy] = None,
                 mesh=None, n_micro: Optional[int] = None,
                 v_virtual: Optional[int] = None,
                 remat_policy: Optional[str] = None,
                 param_dtype=None, moment_dtype=None,
                 offload_optimizer: bool = False,
                 offload_params: bool = False,
                 stream_layers: bool = False,
                 free_eager: bool = False,
                 guard_bad_steps: bool = False,
                 dp_grad_comm: str = "f32",
                 dp_param_comm: Optional[str] = None):
        """Knobs, as in the reference:

        strategy.amp: the forward runs on bf16 copies of every floating
            parameter (ref :676-682); gradients flow through the cast to
            the stored parameters. Not ``torch.autocast``, which keeps
            LayerNorm and softmax in f32 and would not match.
        strategy.recompute: each block runs under
            ``torch.utils.checkpoint(use_reentrant=False)`` (ref :735-742);
            the flash forward kernel runs again inside backward.
        n_micro: micro-batches per step (default: the strategy's
            ``accumulate_steps`` / ``micro_batch``, at least 1).
        param_dtype / moment_dtype: storage dtypes of the parameters and
            the optimizer moments (e.g. ``"bfloat16"``). The update
            computes in f32 and casts back (ref :822-834). The model's
            parameters are converted in place.
        free_eager: accepted; there is nothing to free, because the
            trainer holds no copy of the model's parameters.

        When ``profiler.enable()`` is on, every step syncs on the loss,
        moves ``train/steps``, ``train/tokens`` (``tokens_in_batch``) and
        the ``hybrid/step_ms`` histogram in ``profiler.registry()``,
        records the device-memory high-water mark
        (``memory/peak_bytes_in_use``) and the host spans ``hybrid/h2d``
        (the batch's copy to the device), ``hybrid/step`` and, inside it,
        ``sync_wait`` (the wait on the loss): the reference's names. The
        forward always opens the ranges ``fwd/stem``, ``fwd/blocks`` and
        ``fwd/head`` (``profiler.annotate``). Every step marks its batch at
        the ``hybrid.step#N`` recompile site (``self._prof_site``) and runs
        inside a ``record_function`` range of that name; the site's first
        step is counted (``profiler/program_stats.py``).
        ``profile_step_phases`` decomposes a step into phases (and, with
        ``trace_window``, parses a device trace of more steps);
        ``memory_ledger`` gives the resident bytes by state category.

        Not ported (each raises ``NotImplementedError`` naming its ROADMAP
        item): a ``mesh``, pipeline/tensor/data/sequence parallel degrees,
        ZeRO sharding, ``v_virtual > 1``, ``remat_policy="dots"``, the
        offload and ``stream_layers`` knobs and quantized collectives
        (queue 1 item 7); ``guard_bad_steps`` (item 8)."""
        _check_protocol(model)
        s = strategy or DistributedStrategy()
        if mesh is not None:
            raise _queue(7, "a device mesh")
        hc = s.hybrid_configs
        for deg in ("dp_degree", "mp_degree", "pp_degree", "sharding_degree",
                    "sp_degree", "ep_degree"):
            if getattr(hc, deg, 1) not in (-1, 1):
                raise _queue(7, f"hybrid_configs.{deg} > 1")
        if s.pipeline or s.tensor_parallel or s.sharding:
            raise _queue(7, "pipeline, tensor-parallel and ZeRO strategies")
        if (v_virtual or 1) != 1:
            raise _queue(7, "an interleaved pipeline (v_virtual > 1)")
        if remat_policy == "dots":
            raise _queue(7, 'remat_policy="dots"')
        if remat_policy is not None:
            raise ValueError(f"unknown remat_policy {remat_policy!r}")
        if offload_optimizer or offload_params or stream_layers:
            raise _queue(7, "host offload (offload_optimizer, "
                            "offload_params, stream_layers)")
        if dp_grad_comm != "f32" or dp_param_comm not in (None, "f32"):
            raise _queue(7, "quantized collectives (dp_grad_comm, "
                            "dp_param_comm)")
        if guard_bad_steps:
            raise _queue(8, "guard_bad_steps")
        self.model = model
        self.optimizer = optimizer
        self.strategy = s
        self.n_micro = n_micro or max(s.pipeline_configs.accumulate_steps,
                                      s.pipeline_configs.micro_batch, 1)
        self.amp = bool(s.amp)
        self.remat = bool(s.recompute)
        self.param_dtype = convert_dtype(param_dtype) if param_dtype \
            else None
        self.moment_dtype = convert_dtype(moment_dtype) if moment_dtype \
            else None

        self._params = dict(model.named_parameters())
        self._blocks = list(model.pipeline_blocks())
        # per block, its parameter names; the rest are "other" params
        self._block_names = [[n for n, _ in blk.named_parameters()]
                             for blk in self._blocks]
        in_blocks = {id(p) for blk in self._blocks for p in blk.parameters()}
        self._other_names = [n for n, p in self._params.items()
                             if id(p) not in in_blocks]
        with torch.no_grad():
            for p in self._params.values():
                if self.param_dtype is not None and p.is_floating_point():
                    p.data = p.data.to(self.param_dtype)
                st = optimizer._state_for(p)
                if self.moment_dtype is not None:
                    for k, v in list(st.items()):
                        if v.is_floating_point():
                            st[k] = v.to(self.moment_dtype)
        self._step = 0
        # the batch signatures the step has run (profiler/recompile.py)
        self._prof_site = _precomp.unique_site("hybrid.step")
        # the step site's counted first dispatch (program_stats.dispatch)
        self._program_counts: Dict[str, dict] = {}

    # ---------------------------------------------------------------------
    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        """The forward's copy of a parameter: bf16 under amp (a
        differentiable cast), the parameter itself otherwise."""
        return t.to(torch.bfloat16) if self.amp and t.is_floating_point() \
            else t

    def _forward_loss(self, batch) -> torch.Tensor:
        """stem -> blocks -> head of one micro-batch; f32 scalar."""
        model = self.model
        other = {n: self._cast(self._params[n]) for n in self._other_names}
        with _swapped_params(model, other):
            with _ptrace.annotate("fwd/stem"):
                x = model.pipeline_stem(*batch)
            with _ptrace.annotate("fwd/blocks"):
                for blk, names in zip(self._blocks, self._block_names):
                    vals = [self._cast(p) for p in blk.parameters()]

                    def run(h, *ps, blk=blk, names=names):
                        with _swapped_params(blk, dict(zip(names, ps))):
                            return blk(h)

                    x = checkpoint(run, x, *vals, use_reentrant=False) \
                        if self.remat else run(x, *vals)
            with _ptrace.annotate("fwd/head"):
                loss = model.pipeline_head(x, *batch)
        return loss.float()

    def step(self, *batch) -> torch.Tensor:
        """One optimizer step on ``batch`` (e.g. ``tokens [B, S]``, int,
        on the model's device); returns the f32 loss."""
        dev = next(iter(self._params.values())).device
        prof = _prof_enabled()
        t0 = time.perf_counter_ns() if prof else 0
        with _ptrace.scope("hybrid/h2d") if prof \
                else contextlib.nullcontext():
            batch = tuple(torch.as_tensor(b, device=dev) for b in batch)
        bsz = batch[0].shape[0]
        if bsz % self.n_micro:
            raise ValueError(f"batch {bsz} is not divisible by n_micro "
                             f"{self.n_micro}")
        _precomp.mark_trace(self._prof_site, batch)
        if not prof:
            return _pstats.dispatch(self._program_counts, self._prof_site,
                                    self._step_body, batch, dev, bsz)
        with _ptrace.scope("hybrid/step"):
            loss = _pstats.dispatch(self._program_counts, self._prof_site,
                                    self._step_body, batch, dev, bsz)
            with _ptrace.scope("sync_wait"):
                float(loss)                  # truthful sync on the loss
        reg = _preg()
        reg.counter("train/steps").add(1)
        reg.counter("train/tokens").add(_pinstr.tokens_in_batch(batch))
        reg.histogram("hybrid/step_ms").observe(
            (time.perf_counter_ns() - t0) / 1e6)
        _pinstr.record_memory_high_water(device=dev)
        return loss

    def _loss(self, batch, dev, bsz: int, backward: bool) -> torch.Tensor:
        """The step's loss over every micro-batch (each weighed by its
        share of the targets), with each micro-batch's backward when
        ``backward``; the f32 loss, not waited for."""
        micro = [torch.split(b, bsz // self.n_micro) for b in batch]
        counter = getattr(self.model, "pipeline_label_count", None)
        total = counter(*batch) if counter is not None else None
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(self.n_micro):
            mb = tuple(m[i] for m in micro)
            w = counter(*mb) / total if total else 1.0 / self.n_micro
            part = self._forward_loss(mb) * w
            if backward:
                part.backward()
            loss = loss + part.detach()
        return loss

    def _step_body(self, batch, dev, bsz: int) -> torch.Tensor:
        """Forward, backward, clip and update of one step; the f32 loss,
        not waited for."""
        lr = self.optimizer.get_lr()
        self._step += 1
        params = [p for p in self._params.values() if p.requires_grad]
        for p in params:
            p.grad = None
        loss = self._loss(batch, dev, bsz, backward=True)
        live = [p for p in params if p.grad is not None]
        functional_clip(self.optimizer._grad_clip, [p.grad for p in live])
        self.optimizer._apply_updates(live, lr, self._step)
        for p in params:
            p.grad = None
        self.optimizer._global_step = self._step
        return loss

    __call__ = step

    def profile_step_phases(self, *batch, iters: int = 2,
                            trace_window: int = 0) -> dict:
        """Per-phase (fwd/bwd/optim/comm) decomposition of the train step
        into the ``phase/*_ms`` gauges (``profiler.summary()["phases_ms"]``),
        as the reference's. Nested prefixes are timed
        (``instrument.time_compiled``: one warm call, then ``iters``
        calls ended by a host read of the result): fwd (the loss over
        every micro-batch under ``no_grad``), fwd+bwd (the loss and its
        gradients, no update; the gradients are cleared afterwards) and
        the step itself (``1 + iters`` real optimizer steps: training
        state advances). bwd = fwdbwd − fwd, optim = step − fwdbwd; comm
        is 0 at degree 1, with the step site's counted bytes as
        ``cost_bytes_accessed``. Also folds the ``hybrid.step#N`` site's
        counted first dispatch into the program inventory.

        ``trace_window=k`` wraps ``k`` more real steps, each read back, in
        a parsed device-trace capture (``profiler.device_trace``) labelled
        with the site and returns its summary under ``"trace"``."""
        dev = next(iter(self._params.values())).device
        b = tuple(torch.as_tensor(x, device=dev) for x in batch)
        bsz = b[0].shape[0]
        params = [p for p in self._params.values() if p.requires_grad]

        def fwd():
            with torch.no_grad():
                return self._loss(b, dev, bsz, backward=False)

        def fwdbwd():
            for p in params:
                p.grad = None
            return self._loss(b, dev, bsz, backward=True)

        t_fwd = _pinstr.time_compiled(fwd, iters)
        t_fb = _pinstr.time_compiled(fwdbwd, iters)
        for p in params:
            p.grad = None
        t_step = _pinstr.time_compiled(lambda: self.step(*batch), iters)
        ps = _pstats.record_counted(self._prof_site,
                                    self._program_counts[self._prof_site])
        out = _pinstr.record_phases(
            fwd_s=t_fwd, fwdbwd_s=t_fb, step_s=t_step, comm_bytes=0,
            platform=dev.type, cost_bytes_accessed=ps.bytes_accessed)
        if trace_window:
            from ..profiler import device_trace as _dtrace

            with _dtrace.capture(steps=int(trace_window),
                                 label=self._prof_site) as cap:
                for _ in range(int(trace_window)):
                    _pinstr._first_leaf(self.step(*batch))
            out["trace"] = cap.summary
        return out

    def memory_ledger(self) -> dict:
        """Resident bytes by state category (``record_memory_ledger``:
        gauges ``mem/{param,grad,opt_state}_bytes``), as the reference
        counts them at degree 1: every parameter at its storage dtype,
        ``grad`` as 4 bytes per parameter element (the gradients' f32
        peak) and the optimizer's accumulators. No ``master`` category:
        the reference has one only on its sharded (ZeRO) path."""
        params = list(self._params.values())
        return _pinstr.record_memory_ledger({
            "param": params,
            "grad": 4 * sum(p.numel() for p in params),
            "opt_state": [self.optimizer._state_for(p) for p in params]})

    def sync_to_layer(self):
        """The model, whose parameters the trainer updates in place (the
        optimizer's accumulators are its own)."""
        return self.model
