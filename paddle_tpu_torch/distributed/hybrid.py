"""Model-agnostic hybrid-parallel trainer on a ``{dp, tp}`` mesh with
ZeRO 1-3 (mirrors ``paddle_tpu/distributed/hybrid.py``).

The model declares the reference's three-method pipeline protocol
(``models/gpt.py``):

  pipeline_stem(*batch)  -> activations       (embeddings)
  pipeline_blocks()      -> list of identical blocks
  pipeline_head(x, *batch) -> scalar loss     (norm + head + loss)

``step(*batch)`` takes the GLOBAL batch, as the reference's does, on
every rank; each rank takes its dp slice of dim 0
(``qcomm.dp_batch_specs``). The slice splits on dim 0 into ``n_micro``
micro-batches (``pipeline.py``'s ``_to_microbatches``); each runs stem
-> blocks -> head and its backward, and the gradients accumulate. A
micro-batch's mean loss is weighed by its share of the GLOBAL batch's
non-ignored targets (``pipeline_label_count`` of the global batch, the
all-reduce over dp of the ranks' counts; equal shares without it), times
dp, so that the dp mean of the ranks' losses and gradients is the
reference's one head over the full output.

Then the update of ``strategy_compiler._ShardedUpdate``: the gradients
reduced over ``dp`` once (a flat f32 bucket all-reduce at ZeRO 0; the
reduce-scatter of a ZeRO route), the optimizer's clip with norms summed
over the shard axes, the reference's update rule at
``optimizer.get_lr()``, the cast-back to the storage dtypes, and the
parameters made whole again. The two ZeRO routes are selected as the
reference selects them (``zero_manual``: stages 1-2 on a pure-dp mesh
with f32 storage take the flat slab of ``qcomm.dp_zero_step``;
everything else the per-parameter ``_add_axis`` route). The data-parallel
path of this trainer reduces every gradient once; the eager pair
``DataParallel`` + ``fleet.distributed_optimizer`` keeps the reference's
eager semantics and all-reduces twice (``fleet_base.py``).

Replicated parameters get equal gradients on every ``tp`` rank through
the tensor-parallel layers' conjugate collectives; the loss is the same
on every ``tp`` rank. The trainer trains the model's own (local)
parameters in place; at ZeRO 3 it holds each parameter's dp slice and
all-gathers it before use. ``sync_to_layer()`` makes the model's
parameters and the optimizer's state whole (collective).
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core import rng as _rng
from ..core.dtype import convert_dtype
from ..profiler import instrument as _pinstr
from ..profiler import is_enabled as _prof_enabled
from ..profiler import program_stats as _pstats
from ..profiler import recompile as _precomp
from ..profiler import registry as _preg
from ..profiler import trace as _ptrace
from . import qcomm as _qcomm
from .fleet.distributed_strategy import DistributedStrategy
from .strategy_compiler import (_amp_cast, _check_mesh, _dp_mean,
                                _dp_slices, _profile_phases, _ShardedUpdate,
                                _swapped, _validate_zero_clip, _zero_route,
                                build_mesh_from_strategy,
                                resolve_param_specs)


def _check_protocol(model):
    for m in ("pipeline_stem", "pipeline_blocks", "pipeline_head"):
        if not hasattr(model, m):
            raise TypeError(
                f"{type(model).__name__} does not implement the pipeline "
                f"protocol ({m}); see distributed/hybrid.py docstring")


_ITEMS = {"7c": "pipeline, MoE and ring attention",
          "7d": "quantized collectives, checkpoints and offload",
          "7e": "planning without allocation", "8": "resilience"}


def _queue(item: str, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP queue 1 item {item} "
        f"({_ITEMS[item]})")


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat_policy="dots"``: matrix products without batch dims are
    saved, everything else (the flash kernel included) recomputed: the
    counterpart of ``jax.checkpoint_policies
    .dots_with_no_batch_dims_saveable``."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _check_layers(model, mesh) -> None:
    """The model's parallel layers must have been built under a mesh of
    the trainer's tp degree (they shard themselves when built)."""
    tp = mesh.shape.get("tp", 1)
    for name, mod in model.named_modules():
        if getattr(mod, "param_shardings", None) is None or \
                not hasattr(mod, "_mesh"):
            continue
        built = 1 if mod._mesh is None else mod._mesh.shape["tp"]
        if built != tp:
            raise ValueError(
                f"{name or type(model).__name__} was built at tp={built}, "
                f"the trainer's mesh has tp={tp}: build the model after "
                "distributed.mesh.init_mesh(...) of the same degrees")


class HybridPipelineTrainer:
    """Trainer for any pipeline-protocol model on a {dp, tp} mesh."""

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
                 dp_grad_block: int = 2048,
                 dp_param_comm: Optional[str] = None):
        """Knobs, as in the reference:

        mesh: a ``{dp, tp}`` mesh (``mesh.create_mesh``; default
            ``build_mesh_from_strategy(strategy)``, whose ``dp`` takes the
            ranks ``mp_degree`` leaves). The model must have been built
            under a mesh of the same tp degree.
        strategy.sharding + sharding_configs.sharding_stage: ZeRO 1, 2 or
            3 over ``dp`` (module docstring for the two routes).
        strategy.amp: the forward runs on bf16 copies of every floating
            parameter (ref :676-682); gradients flow through the cast to
            the stored parameters. Not ``torch.autocast``, which keeps
            LayerNorm and softmax in f32 and would not match.
        strategy.recompute: each block runs under
            ``torch.utils.checkpoint(use_reentrant=False)`` (ref :735-742);
            the flash forward kernel (and at ZeRO 3 the block's parameter
            all-gathers) runs again inside backward.
            ``remat_policy="dots"`` saves the outputs of matrix products
            without batch dims (``aten.mm``/``aten.addmm``) and
            recomputes the rest (``create_selective_checkpoint_contexts``).
        n_micro: micro-batches per step of each rank's slice (default:
            the strategy's ``accumulate_steps`` / ``micro_batch``, at
            least 1).
        param_dtype / moment_dtype: storage dtypes of the parameters and
            the optimizer moments (e.g. ``"bfloat16"``). The update
            computes in f32 and casts back (ref :822-834). The model's
            parameters are converted in place. Either one sends ZeRO 1-2
            to the per-parameter route, as in the reference.
        dp_param_comm: the slab route's all-gather payload, 'f32' or
            'bf16' (then with an f32 master chunk in the optimizer state).
        free_eager: accepted; there is nothing to free, because the
            trainer holds no second copy of the model's parameters.

        When ``profiler.enable()`` is on, every step syncs on the loss,
        moves ``train/steps``, ``train/tokens`` (``tokens_in_batch`` of
        the global batch) and the ``hybrid/step_ms`` histogram in
        ``profiler.registry()``, records the device-memory high-water
        mark (``memory/peak_bytes_in_use``) and the host spans
        ``hybrid/h2d`` (the batch's copy to the device), ``hybrid/step``
        and, inside it, ``sync_wait`` (the wait on the loss): the
        reference's names. The forward always opens the ranges
        ``fwd/stem``, ``fwd/blocks`` and ``fwd/head``
        (``profiler.annotate``). Every step marks its batch at the
        ``hybrid.step#N`` recompile site (``self._prof_site``) and runs
        inside a ``record_function`` range of that name; the site's first
        step is counted (``profiler/program_stats.py``), its collectives
        included. ``profile_step_phases`` decomposes a step into phases
        (and, with ``trace_window``, parses a device trace of more
        steps); ``memory_ledger`` gives this rank's resident bytes by
        state category.

        Not ported (each raises ``NotImplementedError`` naming its ROADMAP
        item): pp, sp and ep degrees > 1 and ``v_virtual > 1`` (queue 1
        item 7c); the offload and ``stream_layers`` knobs, int8
        collectives, ``device_state`` (7d); planning a LazyGuard model,
        ``aot_lower``/``aot_compile``/``memory_analysis`` (7e);
        ``guard_bad_steps`` (8)."""
        _check_protocol(model)
        s = strategy or DistributedStrategy()
        for deg in ("pp_degree", "sp_degree", "ep_degree"):
            if getattr(s.hybrid_configs, deg, 1) > 1:
                raise _queue("7c", f"hybrid_configs.{deg} > 1")
        mesh = mesh if mesh is not None else build_mesh_from_strategy(s)
        _check_mesh(mesh)
        if (v_virtual or 1) != 1:
            raise _queue("7c", "an interleaved pipeline (v_virtual > 1)")
        if remat_policy not in (None, "dots"):
            raise ValueError(f"unknown remat_policy {remat_policy!r}")
        if offload_optimizer or offload_params or stream_layers:
            raise _queue("7d", "host offload (offload_optimizer, "
                               "offload_params, stream_layers)")
        if guard_bad_steps:
            raise _queue("8", "guard_bad_steps")
        _check_layers(model, mesh)
        self.model = model
        self.optimizer = optimizer
        self.strategy = s
        self.mesh = mesh
        self.n_micro = n_micro or max(s.pipeline_configs.accumulate_steps,
                                      s.pipeline_configs.micro_batch, 1)
        self.amp = bool(s.amp)
        self.remat = bool(s.recompute)
        self.remat_policy = remat_policy
        self.zero = s.sharding_configs.sharding_stage if s.sharding else 0
        self.param_dtype = convert_dtype(param_dtype) if param_dtype \
            else None
        self.moment_dtype = convert_dtype(moment_dtype) if moment_dtype \
            else None
        _qcomm.validate_dp_grad_comm(dp_grad_comm, mesh,
                                     zero_stage=self.zero,
                                     block=int(dp_grad_block))
        self.dp_grad_comm = dp_grad_comm
        self.dp_grad_block = int(dp_grad_block)
        self.zero_manual = _zero_route(
            mesh, self.zero, self.param_dtype is None
            and self.moment_dtype is None)
        if dp_param_comm is None:
            dp_param_comm = "f32"
        _qcomm.validate_dp_param_comm(dp_param_comm, self.zero_manual)
        self.dp_param_comm = dp_param_comm
        _validate_zero_clip(optimizer, self.zero_manual)

        named = list(model.named_parameters())
        self._names = [n for n, _ in named]
        self._index = {n: i for i, n in enumerate(self._names)}
        name_by_id = {id(p): n for n, p in named}
        self._blocks = list(model.pipeline_blocks())
        # per block, its parameters' (local name, model-level name)
        self._block_names = [[(n, name_by_id[id(p)])
                              for n, p in blk.named_parameters()]
                             for blk in self._blocks]
        in_blocks = {full for names in self._block_names
                     for _, full in names}
        self._other_names = [n for n in self._names if n not in in_blocks]
        self._upd = _ShardedUpdate(
            mesh, named, resolve_param_specs(model, mesh, 0), optimizer,
            self.zero, self.zero_manual, self.dp_grad_block, dp_param_comm,
            self.param_dtype, self.moment_dtype)
        self._step = 0
        # the root of the steps' dropout keys (_loss)
        self._key = _rng.generator(self._device()).initial_seed()
        # the batch signatures the step has run (profiler/recompile.py)
        self._prof_site = _precomp.unique_site("hybrid.step")
        # the step site's counted first dispatch (program_stats.dispatch)
        self._program_counts: Dict[str, dict] = {}

    # ---------------------------------------------------------------------
    def _value(self, name: str) -> torch.Tensor:
        """The forward's copy of parameter ``name``: whole (gathered at
        ZeRO 3) and bf16 under amp."""
        return _amp_cast(self._upd.value(self._index[name]), self.amp)

    def _forward_loss(self, batch, key: int) -> torch.Tensor:
        """stem -> blocks -> head of one micro-batch; f32 scalar. ``key``:
        the micro-batch's ``core.rng`` key; each block draws its keyed
        dropout masks in a scope of its own, opened inside the
        checkpointed function so that its recompute draws them again."""
        model = self.model
        other = {n: self._value(n) for n in self._other_names}
        context_fn = {}
        if self.remat and self.remat_policy == "dots":
            from torch.utils.checkpoint import \
                create_selective_checkpoint_contexts

            context_fn = {"context_fn": functools.partial(
                create_selective_checkpoint_contexts, _dots_policy)}
        with _swapped(model, other), _rng.key_scope(key):
            with _ptrace.annotate("fwd/stem"):
                x = model.pipeline_stem(*batch)
            with _ptrace.annotate("fwd/blocks"):
                for j, (blk, names) in enumerate(zip(self._blocks,
                                                     self._block_names)):

                    def run(h, blk=blk, names=names,
                            bkey=_rng.fold_in(key, 1 + j)):
                        vals = {n: self._value(full) for n, full in names}
                        with _swapped(blk, vals), _rng.key_scope(bkey):
                            return blk(h)

                    x = checkpoint(run, x, use_reentrant=False,
                                   **context_fn) if self.remat else run(x)
            with _ptrace.annotate("fwd/head"):
                loss = model.pipeline_head(x, *batch)
        return loss.float()

    def step(self, *batch) -> torch.Tensor:
        """One optimizer step on the GLOBAL ``batch`` (e.g. ``tokens [B,
        S]``, int; every rank passes the same one); returns the f32 loss
        (the dp mean), not waited for unless profiling."""
        dev = self._device()
        prof = _prof_enabled()
        t0 = time.perf_counter_ns() if prof else 0
        with _ptrace.scope("hybrid/h2d") if prof \
                else contextlib.nullcontext():
            batch = tuple(torch.as_tensor(b, device=dev) for b in batch)
        _precomp.mark_trace(self._prof_site, batch)
        if not prof:
            return _pstats.dispatch(self._program_counts, self._prof_site,
                                    self._step_body, batch)
        with _ptrace.scope("hybrid/step"):
            loss = _pstats.dispatch(self._program_counts, self._prof_site,
                                    self._step_body, batch)
            with _ptrace.scope("sync_wait"):
                float(loss)                  # truthful sync on the loss
        reg = _preg()
        reg.counter("train/steps").add(1)
        reg.counter("train/tokens").add(_pinstr.tokens_in_batch(batch))
        reg.histogram("hybrid/step_ms").observe(
            (time.perf_counter_ns() - t0) / 1e6)
        _pinstr.record_memory_high_water(device=dev)
        return loss

    def _device(self) -> torch.device:
        return self._upd.leaves()[0].device

    def _loss(self, batch, backward: bool) -> torch.Tensor:
        """The step's loss (the dp mean) over this rank's micro-batches
        (each weighed by its share of the global batch's targets, times
        dp where the batch was sliced over dp), with each micro-batch's
        backward when ``backward``; the f32 loss, not waited for. The
        dropout masks are keyed by the port's seed, the step and the
        micro-batch (``core.rng.fold_in``)."""
        counter = getattr(self.model, "pipeline_label_count", None)
        total = counter(*batch) if counter is not None else None
        local = _dp_slices(batch, self.mesh)
        # the dp ranks' parts add up to the global batch when it was
        # sliced; an indivisible batch is whole on every rank
        share = self.mesh.shape.get("dp", 1) if local[0].shape[0] < \
            batch[0].shape[0] else 1
        bsz = local[0].shape[0]
        if bsz % self.n_micro:
            raise ValueError(f"batch {bsz} is not divisible by n_micro "
                             f"{self.n_micro}")
        micro = [torch.split(b, bsz // self.n_micro) for b in local]
        loss = torch.zeros((), dtype=torch.float32, device=local[0].device)
        step_key = _rng.fold_in(self._key, self._step)
        for i in range(self.n_micro):
            mb = tuple(m[i] for m in micro)
            w = counter(*mb) * share / total if total \
                else 1.0 / self.n_micro
            part = self._forward_loss(mb, _rng.fold_in(step_key, i)) * w
            if backward:
                part.backward()
            loss = loss + part.detach()
        return _dp_mean(loss, self.mesh)

    def _step_body(self, batch) -> torch.Tensor:
        """Forward, backward, clip and update of one step; the f32 loss,
        not waited for."""
        lr = self.optimizer.get_lr()
        self._step += 1
        self._upd.zero_grad()
        loss = self._loss(batch, backward=True)
        self._upd.update(lr, self._step)
        self._upd.zero_grad()
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
        from the step site's counted collective bytes (the dp reduction,
        the ZeRO gathers, the tp activations' all-reduces), with its
        counted bytes as ``cost_bytes_accessed``. Also folds the
        ``hybrid.step#N`` site's counted first dispatch into the program
        inventory.

        ``trace_window=k`` wraps ``k`` more real steps, each read back, in
        a parsed device-trace capture (``profiler.device_trace``) labelled
        with the site and returns its summary under ``"trace"``."""
        return _profile_phases(self, batch, iters, trace_window)

    def memory_ledger(self) -> dict:
        """This rank's resident bytes by state category
        (``record_memory_ledger``: gauges ``mem/{param,grad,opt_state,
        master}_bytes``), as the reference counts them: every stored
        parameter at its storage dtype (its dp slice at ZeRO 3), ``grad``
        as 4 bytes per local parameter element (the gradients' f32
        peak), the optimizer's state where it lives (1/dp of it on a ZeRO
        route) and, on the slab route with a bf16 ``dp_param_comm``, the
        f32 ``master`` chunk."""
        return self._upd.ledger()

    def sync_to_layer(self):
        """The model with whole parameters and the optimizer with whole
        states (the reference's ``_unflatten_zero_opt`` on the slab
        route): collective, every rank calls it."""
        self._upd.sync()
        return self.model

    def device_state(self):
        raise _queue("7d", "device_state / load_device_state (checkpoints)")

    load_device_state = device_state

    def aot_lower(self, *batch):
        raise _queue("7e", "aot_lower / aot_compile / memory_analysis")

    aot_compile = memory_analysis = aot_lower
