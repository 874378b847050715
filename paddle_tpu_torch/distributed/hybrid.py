"""Model-agnostic hybrid-parallel trainer on the full mesh ``{dp, pp,
tp, sp, ep}`` with ZeRO 1-3 (mirrors ``paddle_tpu/distributed/hybrid.py``).

The model declares the reference's three-method pipeline protocol
(``models/gpt.py``):

  pipeline_stem(*batch)  -> activations       (embeddings)
  pipeline_blocks()      -> list of identical blocks
  pipeline_head(x, *batch) -> scalar loss     (norm + head + loss)

and, for pp > 1, ``pipeline_stem_spec(*batch) -> (shape, dtype)`` of the
stem's output (what a stage after the first receives).

``step(*batch)`` takes the GLOBAL batch, as the reference's does, on
every rank. The batch splits on dim 0 into ``n_micro`` micro-batches
(``pipeline.py``'s ``_to_microbatches``) and each rank takes its ``dp``
slice of every micro-batch, so that a rank's micro-batch i is its part
of the reference's micro-batch i (an MoE layer routes over exactly
those tokens: ``context.moe_routing_scope``). Under ``sp`` the model
cuts dim 1 itself (``context.sequence_parallel_scope``, opened here).
A micro-batch's loss is weighed by its share of the GLOBAL batch's
non-ignored targets (``pipeline_label_count``; equal shares without
it), times dp, so that the dp mean of the ranks' losses and gradients
is the reference's one head over the full output.

pp = 1: each micro-batch runs stem -> blocks -> head and its backward,
and the gradients accumulate. pp > 1: each ``pp`` rank holds only its
own stage's blocks (the others' storage is released when the trainer
is built) and the micro-batches run through ``pipeline.pipeline_apply``
with the GPipe (``v_virtual`` 1) or the interleaved schedule: stage s,
circuit c holds the layers ``c·(pp·lps_v) + s·lps_v + j`` (reference
``hybrid.py:471-476``). Stage 0 runs the stem, the last stage the head;
one backward runs the reverse ring. Under pp × sp the stage sees its
sequence shard (the reference's manual sp) and an MoE layer routes per
``sp`` shard, its aux averaged over ``sp`` (reference
``pipeline.py:250-252``); at pp 1 it routes over ``dp`` and ``sp``.
MoE blocks add ``moe_aux_weight`` times their load-balance loss.

Gradients of parameters that several ranks hold:

  dp   reduced ONCE a step: a flat f32 bucket all-reduce (÷ dp) at ZeRO
       0, the reduce-scatter of a ZeRO route
  pp   the non-block parameters (the stem's and the head's) are summed
       over ``pp``: the tied ``wte`` gets stage 0's embedding gradient
       plus the last stage's head gradient (under GSPMD the shard_map's
       transpose does this)
  sp   every gradient is summed over ``sp`` (each rank's loss is its
       shard's share of the global mean), not averaged
  tp   the tensor-parallel layers' conjugate collectives give the
       replicated parameters equal gradients on every ``tp`` rank
  ep   the MoE layer's conjugate pair gives the gate and the rest equal
       gradients on every ``ep`` rank; each rank's experts are its own

The global-norm clip counts a parameter replicated over pp, sp or ep
once: block parameters' squared norms are summed over ``pp``, experts'
over ``ep`` (and tp shards' over ``tp``, ZeRO slices' over ``dp``), which
equals the reference's ``functional_clip`` on the global arrays.

Then the update of ``strategy_compiler._ShardedUpdate``: the optimizer's
clip, the reference's update rule at ``optimizer.get_lr()``, the
cast-back to the storage dtypes, and the parameters made whole again.
The two ZeRO routes are selected as the reference selects them
(``zero_manual``: stages 1-2 on a pure-dp mesh with f32 storage take
the flat slab of ``qcomm.dp_zero_step``; everything else the
per-parameter ``_add_axis`` route, which composes with every axis). The
data-parallel path reduces every gradient once; the eager pair
``DataParallel`` + ``fleet.distributed_optimizer`` keeps the reference's
eager semantics and all-reduces twice (``fleet_base.py``). With
``guard_bad_steps`` the update is guarded: the verdict (the loss and
every clipped gradient finite) is agreed as a MIN over every mesh axis
and a bad step's update is deselected bit for bit (``_ShardedUpdate.
verdict``, ``strategy_compiler.select_update``, ``qcomm.dp_zero_step``).

The trainer trains the model's own (local) parameters in place; at
ZeRO 3 it holds each parameter's dp slice and all-gathers it before
use. ``sync_to_layer()`` makes the model's stage parameters and the
optimizer's state whole over ``dp`` (collective);
``parallel_layers.gather_reference_state`` then assembles the global
state across tp, ep and pp.

Planning (the reference's ``hybrid.py:338-345, 1369-1374, 1563-1644``):
a model built under ``framework.lazy.LazyGuard`` makes an abstract
trainer (``self.abstract``). Its parameters become fake tensors on their
devices (``plan.fake_parameters``) and every piece of state the trainer
builds is a fake too (the storage casts, the pipeline's stage release,
the ZeRO slices and slab, offload's host state), so nothing is allocated
on the host or the card; ``step()`` raises. ``aot_lower(*batch)`` runs
the step's own code on fakes of any trainer's state (``plan.py``),
``aot_compile`` analyses its buffers and ``memory_analysis`` gives the
reference's keys. Unlike the reference, which turns its manual ZeRO off
when it plans abstractly (``hybrid.py:361-366``), the port plans the
route its ``step()`` would take: a plan is worth what its match with the
allocator is worth.
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
from ..framework.lazy import is_abstract
from ..profiler import instrument as _pinstr
from ..profiler import is_enabled as _prof_enabled
from ..profiler import program_stats as _pstats
from ..profiler import recompile as _precomp
from ..profiler import registry as _preg
from ..profiler import trace as _ptrace
from . import context as _dctx
from . import plan as _plan
from . import qcomm as _qcomm
from .fleet.distributed_strategy import DistributedStrategy
from .pipeline import _global_share, pipeline_apply
from .strategy_compiler import (_amp_cast, _dp_mean, _profile_phases,
                                _ShardedUpdate, _spec_axes, _swapped,
                                _validate_zero_clip, _zero_route,
                                build_mesh_from_strategy,
                                resolve_param_specs)


def _check_protocol(model):
    for m in ("pipeline_stem", "pipeline_blocks", "pipeline_head"):
        if not hasattr(model, m):
            raise TypeError(
                f"{type(model).__name__} does not implement the pipeline "
                f"protocol ({m}); see distributed/hybrid.py docstring")


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
    the trainer's tp and ep degrees (they shard themselves when built)."""
    for name, mod in model.named_modules():
        specs = getattr(mod, "param_shardings", None)
        if specs is None or not hasattr(mod, "_mesh"):
            continue
        axes = set()
        for spec in specs.values():
            axes |= _spec_axes(spec)
        for axis in sorted(axes & {"tp", "ep"}):
            built = 1 if mod._mesh is None else mod._mesh.shape.get(axis, 1)
            if built != mesh.shape.get(axis, 1):
                raise ValueError(
                    f"{name or type(model).__name__} was built at "
                    f"{axis}={built}, the trainer's mesh has {axis}="
                    f"{mesh.shape.get(axis, 1)}: build the model after "
                    "distributed.mesh.init_mesh(...) of the same degrees")


def _stage_on(dev: torch.device, batch) -> tuple:
    """``batch`` on ``dev`` (see ``HybridPipelineTrainer._stage_batch``);
    on the CPU the leaves as tensors."""
    if dev.type != "cuda":
        return tuple(torch.as_tensor(b) for b in batch)
    main = torch.cuda.default_stream(dev)
    side = torch.cuda.Stream(dev)
    out = []
    with torch.cuda.stream(side):
        for b in batch:
            t = torch.as_tensor(b)
            if t.device.type == "cpu":
                t = t.pin_memory().to(dev, non_blocking=True)
            t.record_stream(main)
            out.append(t)
    side.synchronize()
    return tuple(out)


def pipeline_layout(n_layers: int, pp: int, v: int):
    """Stage s's circuits: ``[[layer of (c, j) for j] for c]`` per stage,
    layer ``c·(pp·lps_v) + s·lps_v + j`` (the reference's circular
    assignment, ``hybrid.py:471-476``)."""
    lps_v = n_layers // (pp * v)
    return [[[c * pp * lps_v + s * lps_v + j for j in range(lps_v)]
             for c in range(v)] for s in range(pp)]


class HybridPipelineTrainer:
    """Trainer for any pipeline-protocol model on a {dp, pp, tp, sp, ep}
    mesh."""

    def __init__(self, model, optimizer,
                 strategy: Optional[DistributedStrategy] = None,
                 mesh=None, n_micro: Optional[int] = None,
                 v_virtual: Optional[int] = None,
                 remat_policy: Optional[str] = None,
                 param_dtype=None, moment_dtype=None,
                 offload_optimizer: bool = False,
                 offload_params: bool = False,
                 offload_depth: int = 2,
                 stream_layers: bool = False,
                 comp_resident: bool = True,
                 conservative_fetch: bool = False,
                 free_eager: bool = False,
                 guard_bad_steps: bool = False,
                 dp_grad_comm: str = "f32",
                 dp_grad_block: int = 2048,
                 dp_param_comm: Optional[str] = None):
        """Knobs, as in the reference:

        mesh: a mesh over some of ``dp, pp, tp, sp, ep``
            (``mesh.create_mesh``; default
            ``build_mesh_from_strategy(strategy)``, whose ``dp`` takes the
            ranks the other degrees leave). The model must have been built
            under a mesh of the same tp and ep degrees.
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
        n_micro: micro-batches per step (default: the strategy's
            ``accumulate_steps`` / ``micro_batch``, at least ``pp``).
        v_virtual: virtual stages a ``pp`` rank (default
            ``pipeline_configs.virtual_pipeline_degree``, else 1): the
            interleaved schedule, which needs ``n_micro >= pp``.
        param_dtype / moment_dtype: storage dtypes of the parameters and
            the optimizer moments (e.g. ``"bfloat16"``). The update
            computes in f32 and casts back (ref :822-834). The model's
            parameters are converted in place. Either one sends ZeRO 1-2
            to the per-parameter route, as in the reference.
        dp_grad_comm: 'int8' reduces the dp gradients on the quantized
            ring (``qcomm``: the slab's reduce-scatter at ZeRO 1-2, one
            fused all-reduce at ZeRO 0); pure-dp meshes, ZeRO <= 2, not
            with ``offload_params`` or ``stream_layers`` (the reference's
            rules). ``dp_grad_block``: its quantization block.
        dp_param_comm: the slab route's all-gather payload, 'f32', 'bf16'
            or 'int8' (a compressed one with an f32 master chunk in the
            optimizer state); default 'bf16' on the slab route with int8
            gradients, else 'f32', as in the reference.
        offload_optimizer / offload_params / offload_depth / stream_layers
            / conservative_fetch: the optimizer state and,
            with ``offload_params`` (needs amp), the f32 masters live in
            pinned host memory and stream through the card around the
            update, ``offload_depth`` groups at a time (``offload.py``);
            ``stream_layers`` makes a group one layer (needs an offload
            knob and ``v_virtual`` 1). Offload runs the per-parameter
            update at ZeRO 0.
        comp_resident: accepted; under ``offload_params`` the bf16
            compute copies always stay on the card between steps (each
            update writes them from the new masters). The reference's
            ``False`` releases them for an XLA reason the port does not
            have.
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
        ``fwd/stem``, ``fwd/blocks`` and ``fwd/head``, and under pp
        ``pp/ppermute``, ``pp/stage`` and ``pp/head``
        (``profiler.annotate``). Every step marks its batch at the
        ``hybrid.step#N`` recompile site (``self._prof_site``) and runs
        inside a ``record_function`` range of that name; the site's first
        step is counted (``profiler/program_stats.py``), its collectives
        included. ``profile_step_phases`` decomposes a step into phases
        (and, with ``trace_window``, parses a device trace of more
        steps); ``memory_ledger`` gives this rank's resident bytes by
        state category.

        guard_bad_steps: the bad-step guard (reference :164-175) that
            ``paddle_tpu_torch.resilience`` rides on. The verdict is
            ``isfinite(loss)`` and every gradient finite after the clip,
            taken where each rank holds its part (its tp shard, pp stage,
            sp chunk, experts, dp slice) and agreed as a MIN over every
            axis of the mesh, so that every rank keeps or skips the same
            update. A bad step computes the update and deselects it: the
            parameters and every optimizer state stay bit for bit as they
            were (momentum does not decay, weight decay does not apply);
            the step count and the LR schedule still advance.
            ``last_step_ok_device()`` is the verdict as a device tensor
            (no sync), ``last_step_ok`` reads it; ``inject_fault_scale(
            nan)`` poisons the next step's loss. Composes with
            ``offload_optimizer`` (the deselect runs on the device copies
            fetched for the update); ``offload_params`` and
            ``stream_layers`` raise ``ValueError``, as in the reference.

        A model built under ``LazyGuard`` makes an abstract trainer, which
        plans (``aot_lower``/``aot_compile``/``memory_analysis``) and does
        not step (module docstring)."""
        _check_protocol(model)
        s = strategy or DistributedStrategy()
        mesh = mesh if mesh is not None else build_mesh_from_strategy(s)
        if remat_policy not in (None, "dots"):
            raise ValueError(f"unknown remat_policy {remat_policy!r}")
        _check_layers(model, mesh)
        #: built from a LazyGuard model: plans, never steps
        self.abstract = any(is_abstract(p) for p in model.parameters())
        self._fake_mode = _plan.fake_parameters(model, optimizer) \
            if self.abstract else None
        cfg = getattr(model, "config", None)
        self.moe = bool(getattr(cfg, "moe_num_experts", 0))
        self.moe_aux_weight = float(getattr(cfg, "moe_aux_weight", 0.0))
        self.model = model
        self.optimizer = optimizer
        self.strategy = s
        self.mesh = mesh
        self.pp = mesh.shape.get("pp", 1)
        self.sp = mesh.shape.get("sp", 1)
        self.n_micro = n_micro or max(s.pipeline_configs.accumulate_steps,
                                      s.pipeline_configs.micro_batch,
                                      self.pp)
        self.v = v_virtual or getattr(s.pipeline_configs,
                                      "virtual_pipeline_degree", 1) or 1
        self.amp = bool(s.amp)
        self.remat = bool(s.recompute)
        self.remat_policy = remat_policy
        self.zero = s.sharding_configs.sharding_stage if s.sharding else 0
        self.param_dtype = convert_dtype(param_dtype) if param_dtype \
            else None
        self.moment_dtype = convert_dtype(moment_dtype) if moment_dtype \
            else None
        self.offload_optimizer = bool(offload_optimizer)
        self.offload_params = bool(offload_params)
        self.offload_depth = max(1, int(offload_depth))
        self.stream_layers = bool(stream_layers)
        self.comp_resident = bool(comp_resident)
        self.conservative_fetch = bool(conservative_fetch)
        if offload_params and not self.amp:
            raise ValueError("offload_params requires strategy.amp (the "
                             "compute copies are bf16)")
        if self.stream_layers:
            if not (offload_params or offload_optimizer):
                raise ValueError(
                    "stream_layers requires offload_params and/or "
                    "offload_optimizer (it schedules host streams)")
            if self.v != 1:
                raise ValueError(
                    "stream_layers supports v_virtual == 1 (per-layer "
                    "groups assume the [pp, lps, ...] stacking)")
        self.guard_bad_steps = bool(guard_bad_steps)
        if self.guard_bad_steps and (offload_params or stream_layers):
            raise ValueError(
                "guard_bad_steps is not supported with offload_params/"
                "stream_layers yet (the bad-step select would stream "
                "host-resident state through the card a second time); "
                "offload_optimizer alone composes: its deselect runs on "
                "the device copies already fetched for the update")
        # the device verdict of the last guarded step (None before one);
        # _fault_scale poisons exactly one coming step's loss
        self._last_ok_dev: Optional[torch.Tensor] = None
        self._fault_scale: Optional[float] = None
        offload = self.offload_optimizer or self.offload_params
        _qcomm.validate_dp_grad_comm(
            dp_grad_comm, mesh, zero_stage=self.zero,
            block=int(dp_grad_block),
            unsupported=(("offload_params (the host-streamed update "
                          "builders bypass the shard_map grad wrap)",
                          offload_params),
                         ("stream_layers", stream_layers)))
        self.dp_grad_comm = dp_grad_comm
        self.dp_grad_block = int(dp_grad_block)
        self.zero_manual = _zero_route(
            mesh, self.zero, self.param_dtype is None
            and self.moment_dtype is None and not offload)
        if dp_param_comm is None:
            dp_param_comm = "bf16" if self.zero_manual and \
                dp_grad_comm == "int8" else "f32"
        _qcomm.validate_dp_param_comm(dp_param_comm, self.zero_manual)
        self.dp_param_comm = dp_param_comm
        _validate_zero_clip(optimizer, self.zero_manual)
        with self._fake_mode or contextlib.nullcontext():
            self._init_state(model, optimizer, mesh, offload, dp_grad_comm)
        # per parameter, the axes its piece is cut over beyond its spec
        # (device_state): a pipeline stage's blocks over pp
        other = set(self._other_names)
        self._cut_axes = [("pp",) if self.pp > 1 and n not in other
                          else () for n in self._names]
        self._step = 0
        # the root of the steps' dropout keys (_loss)
        self._key = _rng.initial_seed(self._device()) if self.abstract \
            else _rng.generator(self._device()).initial_seed()
        # the batch signatures the step has run (profiler/recompile.py)
        self._prof_site = _precomp.unique_site("hybrid.step")
        # the step site's counted first dispatch (program_stats.dispatch)
        self._program_counts: Dict[str, dict] = {}

    def _init_state(self, model, optimizer, mesh, offload, dp_grad_comm):
        """The stage layout, the released blocks of the other stages and
        the update's state (under the fake mode when abstract)."""
        blocks = list(model.pipeline_blocks())
        L = len(blocks)
        if L % (self.pp * self.v) != 0:
            raise ValueError(
                f"{L} blocks must be divisible by pp_degree×v_virtual="
                f"{self.pp}×{self.v}")
        self.lps = L // self.pp
        self.n_layers = L
        self.stage = mesh.axis_index("pp") if self.pp > 1 else 0
        layout = pipeline_layout(L, self.pp, self.v)
        #: this stage's circuits: the global layer indices of each
        self.circuits = layout[self.stage]
        local = sorted(l for c in self.circuits for l in c)
        named = list(model.named_parameters())
        name_by_id = {id(p): n for n, p in named}
        self._blocks = blocks
        # per layer, its parameters' (local name, model-level name)
        self._block_names = [[(n, name_by_id[id(p)])
                              for n, p in blk.named_parameters()]
                             for blk in blocks]
        in_blocks = {full for names in self._block_names
                     for _, full in names}
        held = {full for l in local for _, full in self._block_names[l]}
        if self.pp > 1:
            owner = {l: st for st, circ in enumerate(layout)
                     for c in circ for l in c}
            # the other stages' blocks: their storage is released; the
            # layout and shapes stay on the model for the state cuts
            # (parallel_layers.shard/gather_reference_state)
            owners, shapes = {}, {}
            for l, blk in enumerate(blocks):
                for n, full in self._block_names[l]:
                    p = blk.get_parameter(n)
                    owners[full] = owner[l]
                    shapes[full] = tuple(p.shape)
                    if owner[l] != self.stage:
                        p.data = torch.empty(0, dtype=p.dtype,
                                             device=p.device)
            model._pipeline_layout = {"stage": self.stage, "owner": owners,
                                      "shapes": shapes}
        named = [(n, p) for n, p in named if n not in in_blocks or n in held]
        self._names = [n for n, _ in named]
        self._index = {n: i for i, n in enumerate(self._names)}
        self._other_names = [n for n in self._names if n not in in_blocks]
        specs = resolve_param_specs(model, mesh, 0)
        other = set(self._other_names)
        sums, masks = [], []
        if self.sp > 1:
            sums.append(("sp", [True] * len(named)))
        if self.pp > 1:
            sums.append(("pp", [n in other for n, _ in named]))
            masks.append(("pp", [n not in other for n, _ in named]))
        if mesh.shape.get("ep", 1) > 1:
            masks.append(("ep", ["ep" in _spec_axes(specs[n])
                                 for n, _ in named]))
        args = (mesh, named, specs, optimizer, self.zero, self.zero_manual,
                self.dp_grad_block, self.dp_param_comm, self.param_dtype,
                self.moment_dtype)
        kw = dict(grad_sums=sums, norm_axes=masks, grad_comm=dp_grad_comm)
        if offload:
            from .offload import _OffloadUpdate

            self._upd = _OffloadUpdate(
                *args, offload_optimizer=self.offload_optimizer,
                offload_params=self.offload_params,
                groups=self._offload_groups(local), depth=self.offload_depth,
                conservative=self.conservative_fetch, **kw)
        else:
            self._upd = _ShardedUpdate(*args, **kw)

    def _offload_groups(self, local):
        """The streamed update's parameter groups: one layer each under
        ``stream_layers``, else one parameter suffix over this stage's
        layers; then one group a non-block parameter."""
        idx = self._index
        if self.stream_layers:
            groups = [[idx[full] for _, full in self._block_names[l]]
                      for l in local]
        else:
            n_sfx = len(self._block_names[local[0]]) if local else 0
            groups = [[idx[self._block_names[l][j][1]] for l in local]
                      for j in range(n_sfx)]
        return groups + [[idx[n]] for n in self._other_names]

    # ---------------------------------------------------------------------
    def _value(self, name: str) -> torch.Tensor:
        """The forward's copy of parameter ``name``: whole (gathered at
        ZeRO 3) and bf16 under amp."""
        return _amp_cast(self._upd.value(self._index[name]), self.amp)

    def _context_fn(self) -> dict:
        if self.remat and self.remat_policy == "dots":
            from torch.utils.checkpoint import \
                create_selective_checkpoint_contexts

            return {"context_fn": functools.partial(
                create_selective_checkpoint_contexts, _dots_policy)}
        return {}

    def _block(self, layer: int, h, key: int):
        """Block ``layer`` on ``h`` under its keyed dropout scope (opened
        inside the checkpointed function so that its recompute draws the
        masks again): ``h`` or, MoE, ``(h, aux)``."""
        blk, names = self._blocks[layer], self._block_names[layer]

        def run(h, bkey=_rng.fold_in(key, 1 + layer)):
            vals = {n: self._value(full) for n, full in names}
            with _swapped(blk, vals), _rng.key_scope(bkey):
                out = blk(h)
                return (out, blk.mlp.aux_loss) if self.moe else out

        if self.remat:
            return checkpoint(run, h, use_reentrant=False,
                              **self._context_fn())
        return run(h)

    def _blocks_on(self, layers, h, key: int):
        """``layers`` in order on ``h``: ``h``, or MoE ``(h, moe_aux_weight
        · Σ aux)``."""
        aux = None
        for layer in layers:
            out = self._block(layer, h, key)
            if self.moe:
                out, a = out
                aux = a.float() if aux is None else aux + a.float()
            h = out
        return (h, aux * self.moe_aux_weight) if self.moe else h

    def _forward_loss(self, batch, key: int, weight) -> torch.Tensor:
        """pp = 1: stem -> blocks -> head of one micro-batch; the f32
        loss weighed by ``weight``, plus the weighted MoE aux over
        ``n_micro`` (its gradient 1/sp a rank: the routing group spans
        ``sp``, so every sp rank holds the same aux)."""
        model = self.model
        other = {n: self._value(n) for n in self._other_names}
        with _swapped(model, other), _rng.key_scope(key):
            with _ptrace.annotate("fwd/stem"):
                x = model.pipeline_stem(*batch)
            with _ptrace.annotate("fwd/blocks"):
                x = self._blocks_on(range(self.n_layers), x, key)
            if self.moe:
                x, aux = x
            with _ptrace.annotate("fwd/head"):
                loss = model.pipeline_head(x, *batch).float() * weight
        if self.moe:
            aux = aux / self.n_micro
            loss = loss + _global_share(aux / self.sp, aux)
        return loss

    def _pipeline_loss(self, batch, step_key: int, weight) -> torch.Tensor:
        """pp > 1: the whole local batch through ``pipeline_apply``; stage
        0 runs the stem, the last stage the head. The f32 loss (its value
        summed over pp, its gradient this stage's share)."""
        model = self.model
        other = {n: self._value(n) for n in self._other_names}
        calls = [0]

        def stage_fn(layers, h):
            # the k-th busy tick of this stage holds micro-batch k mod
            # n_micro: its dropout key
            mb = calls[0] % self.n_micro
            calls[0] += 1
            return self._blocks_on(layers, h, _rng.fold_in(step_key, mb))

        def head_fn(full, *b):
            with _ptrace.annotate("fwd/head"):
                return model.pipeline_head(full, *b).float() * weight

        with _swapped(model, other), _rng.key_scope(step_key):
            with _ptrace.annotate("fwd/stem"):
                if self.stage == 0:
                    x = model.pipeline_stem(*batch)
                else:                 # only the shape is read there
                    shape, dtype = model.pipeline_stem_spec(*batch)
                    x = torch.empty(shape, dtype=dtype,
                                    device=batch[0].device)
            with _ptrace.annotate("fwd/blocks"):
                out = pipeline_apply(
                    self.mesh, stage_fn,
                    self.circuits if self.v > 1 else self.circuits[0],
                    x, self.n_micro,
                    sp_axis="sp" if self.sp > 1 else None, v_virtual=self.v,
                    head_fn=head_fn, head_args=tuple(batch),
                    stage_aux=self.moe)
        if self.moe:
            loss, aux = out
            return loss + aux
        return out

    #: a profiled step waits for its loss; an async-dispatch loop
    #: (``elastic.ElasticTrainer``) clears it, and the histogram is then
    #: ``hybrid/dispatch_ms``
    profiled_step_sync = True

    def step(self, *batch) -> torch.Tensor:
        """One optimizer step on the GLOBAL ``batch`` (e.g. ``tokens [B,
        S]``, int; every rank passes the same one); returns the f32 loss
        (the dp mean), not waited for unless profiling. An abstract trainer
        raises: it plans, it does not run."""
        if self.abstract:
            raise RuntimeError(
                "This trainer was built from a LazyGuard (abstract) model: "
                "it can plan (memory_analysis / aot_lower) but not execute. "
                "Materialize the model (framework.lazy.materialize) and "
                "build the optimizer and the trainer again to train.")
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
            if self.profiled_step_sync:
                with _ptrace.scope("sync_wait"):
                    float(loss)              # truthful sync on the loss
        reg = _preg()
        reg.counter("train/steps").add(1)
        reg.counter("train/tokens").add(_pinstr.tokens_in_batch(batch))
        reg.histogram("hybrid/step_ms" if self.profiled_step_sync
                      else "hybrid/dispatch_ms").observe(
            (time.perf_counter_ns() - t0) / 1e6)
        _pinstr.record_memory_high_water(device=dev)
        return loss

    def _device(self) -> torch.device:
        return self._upd.leaves()[0].device

    def _stage_batch(self, batch) -> tuple:
        """The batch on the device, for a prefetch thread
        (``prefetch.BatchPrefetcher``'s ``stage``): each leaf copied from
        pinned host memory on a side stream that the thread waits for,
        and recorded on the compute stream so that the allocator keeps
        it until the step that reads it is done."""
        return _stage_on(self._device(), batch)

    def _local(self, batch):
        """This rank's dp slice of every micro-batch of the global
        ``batch``, the micro-batches in order along dim 0, and the dp
        factor of its weights (dp where the batch was cut, else 1: an
        indivisible batch is whole on every rank)."""
        dp = self.mesh.shape.get("dp", 1)
        n = self.n_micro
        lead = batch[0].shape[0]
        if dp == 1 or lead % (dp * n):
            return tuple(batch), 1
        r = self.mesh.axis_index("dp")

        def cut(b):
            if not b.dim() or b.shape[0] != lead:
                return b
            m = b.reshape((n, dp, lead // (n * dp)) + tuple(b.shape[1:]))
            return m[:, r].reshape((lead // dp,) + tuple(b.shape[1:]))

        return tuple(cut(b) for b in batch), dp

    def _scopes(self, dp_cut: bool):
        """The sp scope (the model's ring attention and sequence shard)
        and the MoE routing group: the ranks the micro-batch was cut over
        (dp where ``dp_cut``, and sp unless the pipeline makes it
        manual)."""
        axes = (("dp",) if dp_cut else ()) + \
            (("sp",) if self.pp == 1 else ())
        stack = contextlib.ExitStack()
        stack.enter_context(_dctx.sequence_parallel_scope(self.mesh))
        stack.enter_context(_dctx.moe_routing_scope(self.mesh, axes))
        return stack

    def _loss(self, batch, backward: bool,
              fault: Optional[float] = None) -> torch.Tensor:
        """The step's loss (the dp mean) over this rank's micro-batches
        (each weighed by its share of the global batch's targets, times
        dp where the batch was cut over dp), with the backward when
        ``backward``; the f32 loss, not waited for. The dropout masks are
        keyed by the port's seed, the step and the micro-batch
        (``core.rng.fold_in``). ``fault`` (``inject_fault_scale``)
        multiplies each loss before its backward: a NaN poisons the loss
        and, through the cotangent, every gradient."""
        # a plan reads no device value: its micro-batches weigh equally
        counter = None if _plan.planning() else \
            getattr(self.model, "pipeline_label_count", None)
        total = counter(*batch) if counter is not None else None
        local, share = self._local(batch)
        bsz = local[0].shape[0]
        if bsz % self.n_micro:
            raise ValueError(f"batch {bsz} is not divisible by n_micro "
                             f"{self.n_micro}")
        step_key = _rng.fold_in(self._key, self._step)
        with self._scopes(share > 1):
            if self.pp > 1:
                w = counter(*local) * share / total if total else 1.0
                loss = self._pipeline_loss(local, step_key, w)
                if fault is not None:
                    loss = loss * fault
                if backward:
                    loss.backward()
                return _dp_mean(loss.detach(), self.mesh)
            micro = [torch.split(b, bsz // self.n_micro) for b in local]
            loss = torch.zeros((), dtype=torch.float32,
                               device=local[0].device)
            for i in range(self.n_micro):
                mb = tuple(m[i] for m in micro)
                w = counter(*mb) * share / total if total \
                    else 1.0 / self.n_micro
                part = self._forward_loss(mb, _rng.fold_in(step_key, i), w)
                if fault is not None:
                    part = part * fault
                if backward:
                    part.backward()
                loss = loss + part.detach()
        return _dp_mean(loss, self.mesh)

    def _step_body(self, batch) -> torch.Tensor:
        """Forward, backward, clip and update of one step; the f32 loss,
        not waited for. Guarded, the update is kept only where the
        mesh-agreed verdict holds (``last_step_ok_device``); the step
        count and the LR schedule advance either way (reference
        ``hybrid.py:1377``)."""
        lr = self.optimizer.get_lr()
        self._step += 1
        self._upd.zero_grad()
        start = getattr(self._upd, "start_step", None)
        if start is not None:
            start()
        fault, self._fault_scale = self._fault_scale, None
        loss = self._loss(batch, backward=True, fault=fault)
        ok = self._upd.update(lr, self._step,
                              loss if self.guard_bad_steps else None)
        if self.guard_bad_steps:
            self._last_ok_dev = ok
        self._upd.zero_grad()
        self.optimizer._global_step = self._step
        return loss

    __call__ = step

    # -- the bad-step guard's surface (paddle_tpu_torch.resilience) -------
    @property
    def last_step_ok(self) -> bool:
        """The verdict of the last guarded step (True before one, or
        unguarded). Reading it syncs on the verdict."""
        if self._last_ok_dev is None:
            return True
        return bool(self._last_ok_dev)

    def last_step_ok_device(self) -> Optional[torch.Tensor]:
        """The last guarded step's verdict as the device bool (None before
        one): the async window's handle, read without a sync here."""
        return self._last_ok_dev

    def inject_fault_scale(self, value: float) -> None:
        """Chaos hook: multiply the NEXT step's loss by ``value`` (NaN
        poisons the loss and every gradient). One-shot; it needs
        ``guard_bad_steps``, so that the poison cannot reach the
        weights."""
        if not self.guard_bad_steps:
            raise RuntimeError(
                "inject_fault_scale requires guard_bad_steps=True: "
                "injecting a NaN without the guard would poison the "
                "weights permanently")
        self._fault_scale = float(value)

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
        the ZeRO gathers, the tp activations' all-reduces, the pipeline's
        permutes), with its counted bytes as ``cost_bytes_accessed``.
        Also folds the ``hybrid.step#N`` site's counted first dispatch
        into the program inventory.

        ``trace_window=k`` wraps ``k`` more real steps, each read back, in
        a parsed device-trace capture (``profiler.device_trace``) labelled
        with the site and returns its summary under ``"trace"``."""
        return _profile_phases(self, batch, iters, trace_window)

    def memory_ledger(self) -> dict:
        """This rank's resident bytes by state category
        (``record_memory_ledger``: gauges ``mem/{param,grad,opt_state,
        master}_bytes``), as the reference counts them: every stored
        parameter of this rank (its stage's blocks under pp, its experts
        under ep, its tp shard, its dp slice at ZeRO 3) at its storage
        dtype, ``grad`` as 4 bytes per local parameter element (the
        gradients' f32 peak; 2 for the bf16 gradients of
        ``offload_params``), the optimizer's state where it lives (1/dp
        of it on a ZeRO route) and, on the slab route with a compressed
        ``dp_param_comm``, the f32 ``master`` chunk. Under host offload
        the device's ``opt_state`` and ``master`` are estimates: the
        streamed window (``offload_depth`` groups' worth) as the
        schedule bounds it, not the allocator's reading; the host's are
        apart: ``host_opt_state`` and ``host_master``."""
        return self._upd.ledger()

    def sync_to_layer(self):
        """The model with whole parameters and the optimizer with whole
        states over ``dp`` (the reference's ``_unflatten_zero_opt`` on
        the slab route): collective, every rank calls it. The model keeps
        this rank's stage, experts and tp shard;
        ``parallel_layers.gather_reference_state`` puts the global state
        together."""
        self._upd.sync()
        return self.model

    def device_state(self) -> dict:
        """This rank's training state for ``distributed.checkpoint``:
        ``{"params": {name: Sharded}, "opt": {name: {key: Sharded}}}``
        (``"master"`` too on the slab route with a compressed return),
        each piece this rank's local tensor with its global shape and
        index: tp shards (GPT's qkv in its ``[3, H, D]`` view), experts
        over ep, a ZeRO slice over dp or each parameter's flat range of
        the slab, a pipeline stage's blocks. Under ``offload_params``
        the parameters' pieces are the host masters (the compute copies
        are derived and not saved)."""
        return self._upd.state_pieces(self.model, self._cut_axes)

    def load_device_state(self, st: dict, step: Optional[int] = None):
        """Inverse of :meth:`device_state` (the restore path): every
        piece copied into place; under ``offload_params`` the bf16
        compute copies are rebuilt from the restored masters. ``step``
        restores the step count and the optimizer's ``_global_step``."""
        self._upd.load_pieces(self.model, self._cut_axes, st)
        if step is not None:
            self._step = int(step)
            self.optimizer._global_step = int(step)

    def aot_lower(self, *batch) -> "_plan.Lowered":
        """The step on ``batch`` (tensors, arrays, or ``meta`` tensors as
        shape specs) planned on fakes of this trainer's state, abstract or
        materialized: nothing runs, nothing is allocated and nothing real
        changes (``plan.py``). Its ``as_text()`` lists the program, its
        ``collectives`` what ``count_collectives`` would count."""
        return _plan.lower(self, batch)

    def aot_compile(self, *batch) -> "_plan.Compiled":
        """``aot_lower(*batch).compile()``: the buffer analysis."""
        return self.aot_lower(*batch).compile()

    def memory_analysis(self, *batch) -> dict:
        """The planned step's bytes under the reference's keys
        (``argument/output/temp/alias_size_in_bytes``, ``peak_bytes_est``
        = arguments − alias + temps) and, under host offload,
        ``host_resident_argument_bytes``, ``hbm_argument_bytes`` and
        ``hbm_peak_bytes_est`` (``plan.Compiled``)."""
        return self.aot_compile(*batch).memory_analysis()
