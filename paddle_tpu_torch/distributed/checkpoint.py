"""Sharded, async checkpoints with a commit marker (mirrors
``paddle_tpu/distributed/checkpoint.py``).

- **keyed by shard**: every tensor of the state tree is saved as the
  pieces this rank owns. A piece is a :class:`Sharded` (the rank's local
  tensor, the global shape and the piece's index in it, and whether this
  rank is the one that writes it: ``replica_id == 0``); a plain tensor is
  whole and written by rank 0. Each rank writes ONE shard file with the
  pieces it owns, so a save never assembles a global tensor.
- **async**: the device-to-host copies happen inline (into pinned host
  memory, one synchronize), the file writes on a background thread;
  ``SaveHandle.wait()`` joins, fsyncs and commits. With
  ``snapshot_async`` the copies too run on the thread, chunk by chunk on
  a side stream; the caller must pass ``wait_snapshot()`` before it
  changes the saved tensors (the trainers update their state in place).
- **crash-consistent**: a step directory counts only once its COMMIT
  marker exists, written by rank 0 after every rank has fsync'd its file
  and the ranks agree no write failed; ``latest_step`` ignores the rest.
- **resume-exact**: ``restore`` fills a template of the same tree: a
  :class:`Sharded` leaf reads its own index (the fast path when a saved
  piece has that index; else the global tensor is assembled from every
  rank's pieces and cut, which is how a restore changes topology). A
  saved tensor whose global shape differs from the template's but has as
  many elements is read in C order (a ZeRO slab's flat piece of a
  parameter restores into the parameter's shape).

The on-disk layout is the reference's, so a directory written by either
package is read by the other::

    dir/step_00000100/
        shard_p0.bin manifest_p0.json   # per rank: key, dtype name,
                                        # global shape, index, offset,
                                        # byte count; the file's crc32
        meta.json COMMIT                # rank 0

bf16 goes to disk as raw bytes under the dtype name ``"bfloat16"``. The
writer is the reference's pure-Python ``_PyWriter`` contract (its native
``AsyncWriter`` comes with ROADMAP queue 1 item 9's ``core/native.py``).
``_barrier`` and ``_sum_across_hosts`` are ``torch.distributed``
all-reduces when a process group exists.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.tree import flatten, unflatten

__all__ = ["Sharded", "SaveHandle", "save", "restore", "restore_degraded",
           "all_steps", "latest_step", "load_meta", "CheckpointManager"]

_STEP_FMT = "step_{:08d}"
_COMMIT = "COMMIT"
_SNAPSHOT_CHUNK_BYTES = 64 * 1024 * 1024

_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
          torch.int32: "int32", torch.int64: "int64", torch.bool: "bool"}


class Sharded:
    """One rank's piece of a global tensor: ``data`` (the local tensor),
    ``shape`` (the global shape), ``index`` (``[[start, stop]]`` a dim of
    the global shape) and ``replica_id`` (0: this rank writes the piece;
    other ranks holding the same piece pass 1)."""

    __slots__ = ("data", "shape", "index", "replica_id")

    def __init__(self, data: torch.Tensor, shape, index=None,
                 replica_id: int = 0):
        self.data = data
        self.shape = tuple(int(d) for d in shape)
        self.index = [[int(a), int(b)] for a, b in index] if index \
            is not None else [[0, d] for d in self.shape]
        self.replica_id = int(replica_id)
        if [b - a for a, b in self.index] != list(data.shape):
            raise ValueError(
                f"piece of shape {tuple(data.shape)} does not fill index "
                f"{self.index} of {self.shape}")

    def __repr__(self):
        return (f"Sharded({tuple(self.data.shape)} of {self.shape} at "
                f"{self.index}, replica {self.replica_id})")


def _ckpt_counters():
    """(stall_ms, d2h_bytes): the time the caller was blocked (the inline
    part of ``save`` and any ``wait_snapshot``), and every byte copied
    off the device."""
    from ..profiler import registry

    reg = registry()
    return reg.counter("ckpt/stall_ms"), reg.counter("ckpt/d2h_bytes")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _rank_world() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return _NAMES[dt]
    return str(np.dtype(dt))


def _torch_dtype(name: str) -> torch.dtype:
    return {v: k for k, v in _NAMES.items()}[name]


def _from_bytes(raw: bytes, name: str, shape) -> torch.Tensor:
    """A CPU tensor of dtype ``name`` from its raw bytes."""
    if name == "bfloat16":
        arr = np.frombuffer(raw, np.uint16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(raw, np.dtype(name))
                            .reshape(shape).copy())


def _piece(leaf, rank: int):
    """(global shape, dtype name, [(index, local tensor)] this rank
    writes) of a state leaf."""
    if isinstance(leaf, Sharded):
        own = [(leaf.index, leaf.data)] if leaf.replica_id == 0 else []
        return list(leaf.shape), _dtype_name(leaf.data.dtype), own
    t = torch.as_tensor(leaf)
    shape = [int(d) for d in t.shape]
    own = [([[0, d] for d in shape], t)] if rank == 0 else []
    return shape, _dtype_name(t.dtype), own


class _PyWriter:
    """The reference's pure-Python writer: sequential writes with a
    running crc32; ``close`` fsyncs and returns ``(bytes, crc32)``."""

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._total = 0
        self._crc = 0

    def write(self, data) -> None:
        b = memoryview(data).cast("B")
        self._f.write(b)
        self._crc = zlib.crc32(b, self._crc)
        self._total += len(b)

    def close(self):
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        return (self._total, self._crc)


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """The bytes of a host tensor as a flat uint8 array (no copy)."""
    t = t.reshape(-1)
    if t.dtype == torch.bool:
        t = t.view(torch.uint8)
    return t.view(torch.uint8).numpy()


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` that later in-place updates of ``t`` do not
    reach: pinned and queued without a wait for a CUDA tensor (the caller
    synchronizes), a clone for a CPU one."""
    t = t.detach()
    if t.device.type == "cuda":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host
    return t.contiguous().clone()


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------
class SaveHandle:
    """An in-flight save. ``wait()`` blocks until the checkpoint is
    durable and committed; the cross-rank agreement and the COMMIT marker
    happen there, on the caller's thread (a collective from a background
    thread could interleave with the training loop's collectives)."""

    def __init__(self, step_dir: str, step: int, thread: threading.Thread,
                 errbox: list, snap_event: Optional[threading.Event] = None):
        self._dir = step_dir
        self._step = step
        self._thread = thread
        self._err = errbox
        self._done = False
        self._snap = snap_event

    @property
    def snapshot_done(self) -> bool:
        return self._snap is None or self._snap.is_set()

    def wait_snapshot(self) -> None:
        """Block until every saved byte is on the host: the gate before
        the caller changes the saved tensors. The block time lands in
        ``ckpt/stall_ms``."""
        if self._snap is None or self._snap.is_set():
            return
        stall, _ = _ckpt_counters()
        t0 = time.perf_counter_ns()
        self._snap.wait()
        stall.add((time.perf_counter_ns() - t0) / 1e6)

    def wait(self) -> None:
        if self._done:
            return
        self.wait_snapshot()
        self._thread.join()
        self._done = True
        # a rank whose write failed vetoes the COMMIT on every rank
        n_failed = _sum_across_hosts(1 if self._err else 0)
        if n_failed:
            if self._err:
                raise self._err[0]
            raise IOError(
                f"checkpoint step {self._step}: shard write failed on "
                f"{n_failed} rank(s); step NOT committed")
        if _rank_world()[0] == 0:
            with open(os.path.join(self._dir, _COMMIT), "w") as f:
                f.write("ok\n")
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(self._dir)
        _barrier()

    @property
    def directory(self) -> str:
        return self._dir


def save(directory: str, state, step: int, meta: Optional[dict] = None,
         async_: bool = True, snapshot_async: bool = False,
         snapshot_chunk_bytes: int = _SNAPSHOT_CHUNK_BYTES) -> SaveHandle:
    """Save a tree (dicts, lists, tuples) of tensors, numpy arrays and
    :class:`Sharded` pieces as step ``step`` of ``directory``; every rank
    calls it. Returns a :class:`SaveHandle`; the step counts once
    ``wait()`` has committed it (``async_=False`` waits here).

    ``snapshot_async=False``: the host copies are made before this
    returns, so the caller may change the state at once.
    ``snapshot_async=True``: this returns after recording the plan; the
    copies run on the writer thread in ``snapshot_chunk_bytes`` chunks,
    and the caller must pass ``wait_snapshot()`` before changing the
    saved tensors."""
    rank, world = _rank_world()
    step_dir = os.path.join(directory, _STEP_FMT.format(step))
    os.makedirs(step_dir, exist_ok=True)
    # a step saved again: the stale COMMIT goes before any byte changes
    commit_path = os.path.join(step_dir, _COMMIT)
    if rank == 0 and os.path.exists(commit_path):
        os.unlink(commit_path)
        _fsync_dir(step_dir)
    _barrier()

    stall, d2h = _ckpt_counters()
    t0 = time.perf_counter_ns()
    entries: Dict[str, dict] = {}
    buffers: List[list] = []           # [tensor (device or host), nbytes]
    offset = 0
    cards = set()
    for key, leaf in flatten(state):
        if leaf is None:
            continue
        shape, name, own = _piece(leaf, rank)
        info = {"shape": shape, "dtype": name, "shards": []}
        for index, t in own:
            nbytes = t.numel() * t.element_size()
            if t.device.type == "cuda":
                cards.add(t.device)
            data = t.detach() if snapshot_async else _to_host(t)
            info["shards"].append({"index": index, "offset": offset,
                                   "nbytes": int(nbytes)})
            buffers.append([data, int(nbytes)])
            offset += nbytes
        entries[key] = info
    if len(cards) > 1:
        raise ValueError(f"save: one rank's pieces lie on {len(cards)} "
                         f"cards ({sorted(str(c) for c in cards)})")
    card = cards.pop() if cards else None
    if not snapshot_async:
        if card is not None:
            torch.cuda.synchronize(card)
        d2h.add(offset)
    stall.add((time.perf_counter_ns() - t0) / 1e6)

    manifest = {"format": 1, "process": rank, "nprocs": world,
                "step": int(step), "file": f"shard_p{rank}.bin",
                "arrays": entries}
    errbox: list = []
    snap_event = threading.Event() if snapshot_async else None
    # the side stream's copies start after the work queued so far on the
    # pieces' card
    ready = None
    if snapshot_async and card is not None:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(card))

    def _snapshot():
        """Device-to-host copies of the planned pieces, chunk by chunk on
        a side stream of the pieces' card (each chunk's copies queued,
        then waited for). The card is named: a new thread's current
        device is card 0, whatever the caller's is."""
        with torch.cuda.device(card) if card is not None \
                else contextlib.nullcontext():
            _copy_chunks(torch.cuda.Stream(device=card)
                         if card is not None else None)

    def _copy_chunks(stream):
        if stream is not None:
            stream.wait_event(ready)
        chunk, size = [], 0

        def flush():
            if stream is not None:
                stream.synchronize()
            for slot in chunk:
                d2h.add(slot[1])
            chunk.clear()

        with torch.cuda.stream(stream) if stream is not None \
                else contextlib.nullcontext():
            for slot in buffers:
                if chunk and size + slot[1] > snapshot_chunk_bytes:
                    flush()
                    size = 0
                slot[0] = _to_host(slot[0])
                chunk.append(slot)
                size += slot[1]
            flush()

    def _finish():
        try:
            if snapshot_async:
                _snapshot()
                snap_event.set()
            w = _PyWriter(os.path.join(step_dir, f"shard_p{rank}.bin"))
            for slot in buffers:
                w.write(_host_bytes(slot[0]))
                slot[0] = None
            total, crc = w.close()
            manifest["file_crc32"] = int(crc)
            manifest["file_bytes"] = int(total)
            _write_json_durable(step_dir, f"manifest_p{rank}.json", manifest)
            if meta is not None and rank == 0:
                _write_json_durable(step_dir, "meta.json", meta)
            _fsync_dir(step_dir)
        except BaseException as e:  # surfaced by wait()
            errbox.append(e)
        finally:
            if snap_event is not None:
                snap_event.set()     # error path: never hang the gate

    t = threading.Thread(target=_finish, name=f"ckpt-save-{step}",
                         daemon=False)
    t.start()
    handle = SaveHandle(step_dir, step, t, errbox, snap_event=snap_event)
    if not async_:
        handle.wait()
    return handle


def _write_json_durable(dirname: str, name: str, obj) -> None:
    """write-tmp -> fsync -> rename: COMMIT never points at partial
    json."""
    tmp = os.path.join(dirname, f".{name}.tmp")
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(dirname, name))


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _sum_across_hosts(value: int) -> int:
    """A small int summed over every rank (a barrier too); unchanged
    without a process group."""
    import torch.distributed as dist

    if _rank_world()[1] <= 1:
        return int(value)
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    dist.all_reduce(t)
    return int(t.item())


def _barrier() -> None:
    _sum_across_hosts(0)


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------
def all_steps(directory: str) -> List[int]:
    """Committed checkpoint steps, ascending."""
    steps = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for n in names:
        if n.startswith("step_") and os.path.exists(
                os.path.join(directory, n, _COMMIT)):
            try:
                steps.append(int(n[len("step_"):]))
            except ValueError:
                pass
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    s = all_steps(directory)
    return s[-1] if s else None


def load_meta(directory: str, step: int) -> Optional[dict]:
    p = os.path.join(directory, _STEP_FMT.format(step), "meta.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


class _ShardSource:
    """Every saved piece of one step, by key."""

    def __init__(self, step_dir: str, verify: bool = False):
        self.step_dir = step_dir
        self.arrays: Dict[str, dict] = {}
        self._files: Dict[str, Any] = {}
        manifests = sorted(n for n in os.listdir(step_dir)
                           if n.startswith("manifest_p"))
        if not manifests:
            raise FileNotFoundError(f"no manifests in {step_dir}")
        for mn in manifests:
            with open(os.path.join(step_dir, mn)) as f:
                m = json.load(f)
            if verify:
                self._verify(m)
            for key, info in m["arrays"].items():
                tgt = self.arrays.setdefault(
                    key, {"shape": info["shape"], "dtype": info["dtype"],
                          "shards": []})
                for sh in info["shards"]:
                    tgt["shards"].append(dict(sh, file=m["file"]))

    def _verify(self, manifest: dict) -> None:
        path = os.path.join(self.step_dir, manifest["file"])
        crc = 0
        with open(path, "rb") as f:
            while True:
                b = f.read(1 << 22)
                if not b:
                    break
                crc = zlib.crc32(b, crc)
        if manifest.get("file_crc32") and crc != manifest["file_crc32"]:
            raise IOError(f"checkpoint corrupt: crc mismatch in {path}")

    def _read(self, fname: str, offset: int, nbytes: int) -> bytes:
        f = self._files.get(fname)
        if f is None:
            f = open(os.path.join(self.step_dir, fname), "rb")
            self._files[fname] = f
        f.seek(offset)
        raw = f.read(nbytes)
        if len(raw) != nbytes:
            raise IOError(f"checkpoint truncated: {fname} holds "
                          f"{len(raw)} of {nbytes} bytes at {offset}")
        return raw

    def close(self):
        for f in self._files.values():
            f.close()
        self._files.clear()

    def exact(self, key: str, index) -> Optional[torch.Tensor]:
        info = self.arrays[key]
        for sh in info["shards"]:
            if sh["index"] == index:
                raw = self._read(sh["file"], sh["offset"], sh["nbytes"])
                return _from_bytes(raw, info["dtype"],
                                   [b - a for a, b in index])
        return None

    def assemble(self, key: str) -> torch.Tensor:
        info = self.arrays[key]
        out = torch.empty(info["shape"], dtype=_torch_dtype(info["dtype"]))
        covered = 0
        for sh in info["shards"]:
            idx = tuple(slice(a, b) for a, b in sh["index"])
            shape = [b - a for a, b in sh["index"]]
            raw = self._read(sh["file"], sh["offset"], sh["nbytes"])
            out[idx] = _from_bytes(raw, info["dtype"], shape)
            covered += int(np.prod(shape))
        # saved pieces are disjoint (replica-0 dedupe): the element count
        # proves coverage
        total = int(np.prod(info["shape"])) if info["shape"] else 1
        if covered != total:
            raise IOError(
                f"checkpoint incomplete for {key!r}: shards cover "
                f"{covered}/{total} elements (missing per-rank manifest?)")
        return out


def _restore_leaf(src: _ShardSource, key: str, tgt):
    info = src.arrays[key]
    saved = [int(d) for d in info["shape"]]
    if isinstance(tgt, Sharded):
        shape, index = list(tgt.shape), tgt.index
        dtype, dev = tgt.data.dtype, tgt.data.device
    elif isinstance(tgt, np.ndarray):
        shape, index, dtype, dev = list(tgt.shape), None, None, None
    else:
        t = torch.as_tensor(tgt)
        shape, index, dtype, dev = list(t.shape), None, t.dtype, t.device
    if shape != saved and int(np.prod(shape)) != int(np.prod(saved)):
        raise ValueError(f"{key}: checkpoint shape {saved} != template "
                         f"shape {shape}")
    if index is not None and shape == saved:
        got = src.exact(key, index)
        if got is None:
            got = src.assemble(key)[tuple(slice(a, b) for a, b in index)]
    else:
        got = src.assemble(key).reshape(shape)
        if index is not None:
            got = got[tuple(slice(a, b) for a, b in index)]
    if isinstance(tgt, np.ndarray):
        return got.float().numpy() if got.dtype == torch.bfloat16 \
            else got.numpy()
    got = got.to(device=dev, dtype=dtype)
    if isinstance(tgt, Sharded):
        return Sharded(got, tgt.shape, tgt.index, tgt.replica_id)
    return got


def restore(directory: str, template, step: Optional[int] = None,
            verify: bool = False):
    """Step ``step`` (default the newest committed) of ``directory`` in
    the tree of ``template``: a :class:`Sharded` leaf gets its own index
    of the saved tensor (a :class:`Sharded` on its device and dtype), a
    tensor leaf the whole tensor, a numpy leaf a numpy array. ``verify``
    checks each file's crc32 first."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    step_dir = os.path.join(directory, _STEP_FMT.format(step))
    src = _ShardSource(step_dir, verify=verify)
    out: Dict[str, Any] = {}
    try:
        for key, tgt in flatten(template):
            if tgt is None:
                out[key] = None
                continue
            if key not in src.arrays:
                raise KeyError(f"checkpoint {step_dir} missing array {key!r}")
            out[key] = _restore_leaf(src, key, tgt)
    finally:
        src.close()
    return unflatten(template, out)


def restore_degraded(directory: str, template, verify: bool = True,
                     on_fallback=None, max_step: Optional[int] = None):
    """The newest readable committed step (at most ``max_step``), walking
    back over steps that fail to read (crc mismatch, a truncated or
    missing file, a lost manifest, mangled json). Each skipped step adds
    one to ``resilience/restore_fallbacks``, warns and calls
    ``on_fallback(step, exc)``. Returns ``(state, meta, step)``; raises
    only when no committed step reads."""
    import warnings

    from ..profiler import registry as _registry

    steps = all_steps(directory)
    if max_step is not None:
        steps = [s for s in steps if s <= max_step]
    if not steps:
        raise FileNotFoundError(
            f"no committed checkpoint in {directory}"
            + (f" at step <= {max_step}" if max_step is not None else ""))
    errors = []
    for step in reversed(steps):
        try:
            state = restore(directory, template, step=step, verify=verify)
            return state, load_meta(directory, step), step
        except (OSError, ValueError, KeyError, json.JSONDecodeError) as e:
            errors.append((step, e))
            _registry().counter("resilience/restore_fallbacks").add(1)
            warnings.warn(
                f"checkpoint step {step} unreadable ({e!r}); falling "
                f"back to an older committed step", RuntimeWarning)
            if on_fallback is not None:
                on_fallback(step, e)
    raise IOError(
        f"no readable committed checkpoint in {directory}; tried "
        + ", ".join(f"step {s}: {e!r}" for s, e in errors))


# ---------------------------------------------------------------------------
# manager
# ---------------------------------------------------------------------------
class CheckpointManager:
    """Rolling async checkpoints with retention: ``save`` joins the
    previous save first and returns at once; ``restore_latest`` reads the
    newest committed step; ``keep`` steps stay."""

    def __init__(self, directory: str, keep: int = 3,
                 snapshot_async: bool = False,
                 snapshot_chunk_bytes: int = _SNAPSHOT_CHUNK_BYTES):
        self.directory = directory
        self.keep = keep
        self.snapshot_async = bool(snapshot_async)
        self.snapshot_chunk_bytes = int(snapshot_chunk_bytes)
        self._pending: Optional[SaveHandle] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, state, meta: Optional[dict] = None,
             async_: bool = True) -> SaveHandle:
        self.wait()
        h = save(self.directory, state, step, meta=meta, async_=async_,
                 snapshot_async=self.snapshot_async and async_,
                 snapshot_chunk_bytes=self.snapshot_chunk_bytes)
        self._pending = h
        if not async_:
            self._gc()
        return h

    def wait_snapshot(self) -> None:
        """The gate before the saved state changes: blocks until an
        in-flight save's host copies are done (no-op otherwise)."""
        if self._pending is not None:
            self._pending.wait_snapshot()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.wait()
            self._pending = None
            self._gc()

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def restore(self, template, step: Optional[int] = None,
                verify: bool = False):
        return restore(self.directory, template, step=step, verify=verify)

    def restore_latest(self, template, verify: bool = False):
        step = self.latest_step()
        if step is None:
            return None, None
        state = self.restore(template, step=step, verify=verify)
        return state, load_meta(self.directory, step)

    def restore_degraded(self, template, verify: bool = True,
                         on_fallback=None,
                         max_step: Optional[int] = None):
        """``restore_degraded`` on this directory; ``(None, None, None)``
        when it holds no committed step (under the cap)."""
        try:
            return restore_degraded(self.directory, template,
                                    verify=verify,
                                    on_fallback=on_fallback,
                                    max_step=max_step)
        except FileNotFoundError:
            return None, None, None

    def _gc(self) -> None:
        if _rank_world()[0] != 0:
            return
        steps = all_steps(self.directory)
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(
                os.path.join(self.directory, _STEP_FMT.format(s)),
                ignore_errors=True)
        # uncommitted debris older than the newest committed step
        for n in os.listdir(self.directory):
            if not n.startswith("step_"):
                continue
            p = os.path.join(self.directory, n)
            if os.path.exists(os.path.join(p, _COMMIT)):
                continue
            try:
                s = int(n[len("step_"):])
            except ValueError:
                continue
            if steps and s < steps[-1]:
                shutil.rmtree(p, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.wait()
