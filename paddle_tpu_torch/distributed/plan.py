"""Planning without allocation: the trainers' ``aot_lower``,
``aot_compile`` and ``memory_analysis`` (mirrors the AOT surface of
``paddle_tpu/distributed/hybrid.py:1563-1644``).

The reference lowers its jitted train step and reads XLA's buffer
assignment. The port's step is eager Python and has no program to
lower, so a plan runs **the trainer's own step code** (``_step_body``)
once under ``torch._subclasses.FakeTensorMode``: every tensor is a fake
of the right shape, dtype and device, no kernel runs and no byte is
allocated. The plan therefore follows the allocations and frees of the
eager step that the card runs; there is no second, hand-written model
of the step.

``lower(trainer, batch)`` -> ``Lowered``:

- The state goes in as fakes, on shallow copies of the trainer, its
  update (``strategy_compiler._ShardedUpdate``, ``offload._OffloadUpdate``)
  and its optimizer: a materialized trainer's tensors through
  ``FakeTensorMode.from_tensor`` (metadata; nothing is copied), an
  abstract trainer's as they are (fakes already, ``hybrid.py``). So
  nothing real changes: parameters, optimizer state, the step counts
  (``optimizer._global_step``), the LR scheduler, the port's RNG, the
  model's attributes and the profiler's counters stay bit-equal. The
  batch may hold tensors, arrays or shape specs: ``meta`` tensors, the
  counterpart of ``jax.ShapeDtypeStruct``. Its leaves are made on the
  device inside the plan, as ``step()`` copies a host batch there.
- A ``TorchDispatchMode`` above the fake mode (``_Recorder``) records the
  program: each op with its outputs' shapes and dtypes, each ``c10d`` op
  with its group's ranks, and each collective the port's wrappers note
  (``profiler.instrument.note_collective``: kind, dtype and result bytes,
  what ``count_collectives`` counts at run time). A new storage is an
  allocation at the op that made it; ``weakref.finalize`` on the fake
  storage marks the op after which its last reference dropped. Views
  share their base's storage and count once; in-place writes allocate
  nothing.

``Lowered.compile()`` -> ``Compiled``: the liveness analysis of those
events, each device storage rounded as the CUDA caching allocator rounds
it (to 512 bytes) on a card. Nothing is lowered and ``torch.compile``
does not run: "compile" here is the buffer analysis.
``Compiled.memory_analysis()`` gives the reference's keys:

  argument_size_in_bytes  the state at the step's start: on the device
                          and, under host offload, on the host
  output_size_in_bytes    what is live at the step's end: the state,
                          updated in place, and the loss
  temp_size_in_bytes      the device's peak less its arguments
  alias_size_in_bytes     0: the eager step updates its state in the
                          argument buffers themselves and donates none
  peak_bytes_est          arguments − alias + temps: the host-resident
                          state plus the device's peak

and, under host offload, ``host_resident_argument_bytes``,
``hbm_argument_bytes`` and ``hbm_peak_bytes_est`` (the device's peak).
``Compiled.fwd_bwd_peak_bytes`` (the device's peak from the step's start
to the update's entry) and ``update_peak_bytes`` (inside the update) are
the two readings of ``chip_smoke.py``'s measured step. What the plan
does not see: cuBLAS's workspace, the CUDA context, and an allocator
block larger than its request.

Host reads of device values on the step's path are skipped while a plan
runs (``planning()``), never branched on: the trainer's label count
(``pipeline_label_count``) is not read. The kernel wrappers take a shape
rule on a fake tensor of the CUDA route (``ops/_cuda.planned``): they
allocate what the kernel allocates and launch nothing, so a plan of a
CUDA step holds the flash kernels' O and LSE where the CPU route's plain
version holds the scores.

A plan runs where its collectives cannot block: a world of one, or a
planning world (``env.plan_world``: torch.distributed's ``fake``
backend, any size, in one process).
"""
from __future__ import annotations

import contextlib
import copy
import threading
import time
import weakref
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..profiler import instrument as _pinstr
from ..profiler import program_stats as _pstats

__all__ = ["lower", "Lowered", "Compiled", "planning", "fake_parameters"]

#: the CUDA caching allocator's granularity
_BLOCK = 512

_depth = [0]


def planning() -> bool:
    """True while a plan runs a step (host reads are skipped)."""
    return _depth[0] > 0


def _rounded(nbytes: int, cuda: bool) -> int:
    if not cuda or not nbytes:
        return nbytes
    return -(-nbytes // _BLOCK) * _BLOCK


def _canon(dtype) -> str:
    return _pinstr._DTYPE_CANON.get(dtype, str(dtype).replace("torch.", ""))


class _Recorder(TorchDispatchMode):
    """The program and its storages' lifetimes (module docstring).

    ``events``: ``(kind, delta, phase)`` in order, ``kind`` "device" or
    "host" (``None`` for a phase mark). A storage is on the host when the
    plan's device is a card and the storage is not on it, or when it is
    host-resident state by role (``host`` of ``track``)."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.ops: List[tuple] = []
        self.events: List[tuple] = []
        self.args = {"device": 0, "host": 0}
        self.phase = "fwd_bwd"
        self.closed = False
        self._known: Dict[int, tuple] = {}
        self._finalizers = []
        # group name -> ranks (a group this rank is not in registers
        # under a plain int)
        self._groups = {pg.group_name: dist.get_process_group_ranks(pg)
                        for pg in dist.distributed_c10d._world.pg_group_ranks
                        if isinstance(pg, dist.ProcessGroup)
                        } if dist.is_initialized() else {}
        self._lock = threading.RLock()

    # -- storages ------------------------------------------------------
    def track(self, t: torch.Tensor, arg: bool = False,
              host: bool = False) -> None:
        st = t.untyped_storage()
        sid = id(st)
        with self._lock:
            if sid in self._known or self.closed:
                return
            kind = "host" if host or t.device.type != self.device.type \
                else "device"
            size = _rounded(st.nbytes(), self.cuda and kind == "device")
            self._known[sid] = (size, kind)
            if arg:
                self.args[kind] += size
            else:
                self.events.append((kind, size, self.phase))
            self._finalizers.append(weakref.finalize(st, self._freed, sid))

    def _freed(self, sid: int) -> None:
        with self._lock:
            size, kind = self._known.pop(sid, (0, None))
            if kind is not None and not self.closed:
                self.events.append((kind, -size, self.phase))

    def mark(self, phase: str) -> None:
        with self._lock:
            self.phase = phase
            self.events.append((None, 0, phase))

    def close(self) -> Dict[str, int]:
        """Stop recording; the bytes still live, by kind (the outputs)."""
        with self._lock:
            self.closed = True
            live = {"device": 0, "host": 0}
            for size, kind in self._known.values():
                live[kind] += size
            for f in self._finalizers:
                f.detach()
            self._finalizers.clear()
        return live

    # -- the program -----------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":              # device and layout queries
            return out
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        group = None
        if func.namespace == "c10d":
            for a in list(args) + list(kwargs.values()):
                if isinstance(a, torch.ScriptObject):
                    try:
                        pg = torch._C._distributed_c10d.ProcessGroup.unbox(a)
                    except RuntimeError:
                        continue                      # a ReduceOp
                    group = self._groups.get(pg.group_name)
        with self._lock:
            self.ops.append((str(func), [(tuple(t.shape), _canon(t.dtype),
                                          str(t.device)) for t in outs],
                             group))
        for t in outs:
            self.track(t)
        return out


class Compiled:
    """The buffer analysis of a ``Lowered`` plan (module docstring)."""

    def __init__(self, lowered: "Lowered"):
        rec = lowered._rec
        self.device = lowered.device
        self.host_state_bytes = lowered.host_state_bytes
        args = dict(rec.args)
        live = dict(args)
        peaks: Dict[str, int] = {"fwd_bwd": live["device"]}
        phase = "fwd_bwd"
        for kind, delta, ph in rec.events:
            if kind is None:
                phase = ph
                peaks[phase] = max(peaks.get(phase, 0), live["device"])
                continue
            live[kind] += delta
            if kind == "device":
                peaks[phase] = max(peaks.get(phase, 0), live["device"])
        #: the device's peak from the step's start to the update's entry,
        #: inside the update, and over the step
        self.fwd_bwd_peak_bytes = peaks["fwd_bwd"]
        self.update_peak_bytes = peaks.get("update", 0)
        self.peak_bytes = max(peaks.values())
        self.argument_bytes = args
        self.output_bytes = lowered.output_bytes

    def memory_analysis(self) -> dict:
        args = self.argument_bytes["device"] + self.argument_bytes["host"]
        temp = self.peak_bytes - self.argument_bytes["device"]
        out = {"argument_size_in_bytes": args,
               "output_size_in_bytes": sum(self.output_bytes.values()),
               "temp_size_in_bytes": temp,
               "alias_size_in_bytes": 0}
        out["peak_bytes_est"] = args - out["alias_size_in_bytes"] + temp
        if self.host_state_bytes is not None:
            out["host_resident_argument_bytes"] = self.host_state_bytes
            out["hbm_argument_bytes"] = args - self.host_state_bytes
            out["hbm_peak_bytes_est"] = out["peak_bytes_est"] - \
                self.host_state_bytes
        return out


class Lowered:
    """One planned step: its ops, collectives and storage events
    (module docstring)."""

    def __init__(self, rec: _Recorder, collectives: list, output_bytes,
                 host_state_bytes: Optional[int], wall_s: float):
        self._rec = rec
        self.device = rec.device
        #: ``(kind, canonical dtype, result bytes)`` of each collective, in
        #: order (``instrument.collective_stats`` takes them)
        self.collectives = list(collectives)
        self.output_bytes = output_bytes
        self.host_state_bytes = host_state_bytes
        #: the plan's host wall time (seconds)
        self.wall_s = wall_s

    @property
    def ops(self) -> List[tuple]:
        """``(op, [(shape, dtype, device)] of its outputs, group ranks or
        None)`` of each op, in order."""
        return self._rec.ops

    def collective_stats(self) -> dict:
        return _pinstr.collective_stats(self.collectives)

    def as_text(self) -> str:
        lines = [f"# planned train step on {self.device}: "
                 f"{len(self.ops)} ops, {len(self.collectives)} collectives"]
        for i, (op, outs, group) in enumerate(self.ops):
            res = ", ".join(f"{dt}{list(shape)} {dev}"
                            for shape, dt, dev in outs)
            grp = "" if group is None else f" group={group}"
            lines.append(f"%{i} = {op}{grp} -> ({res})")
        return "\n".join(lines)

    def compile(self) -> Compiled:
        return Compiled(self)


# ---------------------------------------------------------------------------
# the abstract trainer's parameters
# ---------------------------------------------------------------------------
def fake_parameters(model: torch.nn.Module, optimizer) -> FakeTensorMode:
    """Turn every abstract parameter of ``model`` (a ``meta`` one made
    under ``LazyGuard``, or a fake of another plan) into a fake parameter
    on its device, in place in its modules and in ``optimizer``'s list
    and names; returns the ``FakeTensorMode`` they belong to, under which
    an abstract trainer builds its state. Each keeps its ``_lazy`` record,
    so ``framework.lazy.materialize`` still makes the model real."""
    from ..framework.lazy import is_abstract

    if not all(is_abstract(p) for p in model.parameters()):
        raise ValueError("an abstract model is abstract as a whole: build "
                         "all of it under LazyGuard")
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    made = {}
    for mod in model.modules():
        for leaf, p in list(mod._parameters.items()):
            if p is None or not is_abstract(p):
                continue
            if id(p) not in made:
                rec = getattr(p, "_lazy", None)
                if p.is_meta and rec is None:
                    raise ValueError(
                        f"parameter {leaf} of {type(mod).__name__} is on "
                        "the meta device but was not made under LazyGuard: "
                        "its device is unknown")
                dev = rec[2] if p.is_meta else p.device
                with mode:
                    f = torch.nn.Parameter(
                        torch.empty(p.shape, dtype=p.dtype, device=dev),
                        requires_grad=p.requires_grad)
                f._lazy = rec
                made[id(p)] = (p, f)
            mod._parameters[leaf] = made[id(p)][1]
    plist, names = optimizer._parameter_list, optimizer._names
    for i, p in enumerate(plist):
        if id(p) in made:
            f = made[id(p)][1]
            plist[i] = f
            names[id(f)] = names.pop(id(p), None)
    return mode


# ---------------------------------------------------------------------------
# the shadow of a trainer's state
# ---------------------------------------------------------------------------
class _Faker:
    """Each tensor of a trainer's state as a fake of ``mode`` (a fake of
    the mode as it is), memoized so that shared tensors stay shared; the
    fakes made are the plan's arguments."""

    def __init__(self, mode: FakeTensorMode):
        self.mode = mode
        self.made: Dict[int, torch.Tensor] = {}

    def tensor(self, t: torch.Tensor) -> torch.Tensor:
        f = self.made.get(id(t))
        if f is None:
            if isinstance(t, FakeTensor):
                if t.fake_mode is not self.mode:
                    raise RuntimeError("plan: state of another FakeTensorMode")
                f = t
            elif t.is_meta:
                raise RuntimeError(
                    "plan: a meta tensor in the trainer's state; an abstract "
                    "trainer holds fakes on the planned device")
            else:
                f = self.mode.from_tensor(t)
            self.made[id(t)] = f
        return f

    def tree(self, v):
        if isinstance(v, torch.Tensor):
            return self.tensor(v)
        if isinstance(v, list):
            return [self.tree(x) for x in v]
        if isinstance(v, tuple):
            return tuple(self.tree(x) for x in v)
        if isinstance(v, dict):
            return {k: self.tree(x) for k, x in v.items()}
        return v


def _shadow(tr, faker: _Faker):
    """(a shallow copy of ``tr`` whose update and optimizer are shallow
    copies holding fakes, the host-resident state's fakes)."""
    opt = tr.optimizer
    sh_opt = copy.copy(opt)
    sh_opt._accumulators = {}
    upd = copy.copy(tr._upd)
    for k, v in vars(tr._upd).items():
        upd.__dict__[k] = sh_opt if v is opt else faker.tree(v)
    names = dict(opt._names)
    for rid, f in faker.made.items():
        if rid in opt._names:
            names[id(f)] = opt._names[rid]
    sh_opt._names = names
    sh = copy.copy(tr)
    sh._upd = upd
    sh.optimizer = sh_opt
    host = [faker.tensor(t) for t in getattr(tr._upd, "host_state",
                                             lambda: [])()]
    return sh, host


@contextlib.contextmanager
def _model_attrs_kept(model: torch.nn.Module):
    """Every module's attributes (and the contents of its dict-valued
    ones) as they were: a forward may leave a fake behind (an MoE layer's
    ``aux_loss`` and ``last_route``)."""
    skip = ("_parameters", "_buffers", "_modules")
    saved = [(m, {k: (v, dict(v) if isinstance(v, dict) else None)
                  for k, v in vars(m).items() if k not in skip})
             for m in model.modules()]
    try:
        yield
    finally:
        for m, attrs in saved:
            for k, (v, content) in attrs.items():
                if content is not None:
                    v.clear()
                    v.update(content)
                m.__dict__[k] = v


@contextlib.contextmanager
def _profiler_isolated():
    """The collectives noted inside reach only the plan's own counter:
    the caller's ``count_collectives`` and a counted dispatch site see
    none of them."""
    saved = list(_pinstr._COUNTERS)
    active = _pstats.ACTIVE
    _pinstr._COUNTERS.clear()
    _pstats.ACTIVE = None
    try:
        yield
    finally:
        _pinstr._COUNTERS[:] = saved
        _pstats.ACTIVE = active


def _batch_spec(b):
    """(shape, dtype) of a batch leaf: a tensor (a ``meta`` one is a
    spec), an array or a number."""
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b)
    return tuple(b.shape), b.dtype


def lower(tr, batch) -> Lowered:
    """Plan one ``tr._step_body`` on ``batch`` (module docstring)."""
    if getattr(tr, "abstract", False):
        mode = tr._fake_mode
        mode.allow_non_fake_inputs = False
    else:
        mode = FakeTensorMode()
    dev = tr._device()
    specs = [_batch_spec(b) for b in batch]
    faker = _Faker(mode)
    sh, host = _shadow(tr, faker)
    rec = _Recorder(dev)
    host_ids = {id(t) for t in host}
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(_model_attrs_kept(tr.model if hasattr(
            tr, "model") else tr.layer))
        stack.enter_context(_profiler_isolated())
        counted = stack.enter_context(_pinstr.count_collectives())
        stack.enter_context(mode)
        stack.enter_context(rec)
        _depth[0] += 1
        stack.callback(lambda: _depth.__setitem__(0, _depth[0] - 1))
        for f in faker.made.values():
            rec.track(f, arg=True, host=id(f) in host_ids)
        update = sh._upd.update

        def marked(*a, **k):
            rec.mark("update")
            try:
                return update(*a, **k)
            finally:
                rec.mark("after_update")

        sh._upd.update = marked
        b = tuple(torch.empty(shape, dtype=dtype, device=dev)
                  for shape, dtype in specs)
        loss = sh._step_body(b)
        del b, sh
        outputs = rec.close()
        del loss
    host_bytes = sum(t.untyped_storage().nbytes() for t in
                     {id(t): t for t in host}.values()) \
        if hasattr(tr._upd, "host_state") else None
    return Lowered(rec, counted.notes, outputs, host_bytes,
                   time.perf_counter() - t0)
