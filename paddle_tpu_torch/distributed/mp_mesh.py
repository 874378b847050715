"""A real multi-process mesh: launcher and worker helpers (the torch
counterpart of ``tools/mp_mesh.py``).

It starts N worker processes with the port's ``PADDLE_*`` env protocol
(``distributed/launch.py``) and watches them, with **chaos hooks that
kill or hang exactly one process at a named point**, so a kill-one claim
runs against a real dead process. Unlike ``distributed.launch``, which
ends the whole job at the first failure, the watcher lets the ranks named
in ``expect_fail_ranks`` die and the others run to their end.

Driver side::

    from paddle_tpu_torch.distributed import mp_mesh
    res = mp_mesh.launch(2, "worker.py", [out_dir], log_dir=log_dir,
                         chaos="kill:1:pre_handoff_commit",
                         expect_fail_ranks=(1,),
                         env_extra={"PADDLE_DISTRI_BACKEND": "cpu"})
    assert res.ok, res.tail()

    h = mp_mesh.launch_async(2, "worker.py", [out_dir], log_dir=log_dir)
    h.kill_rank(1)                       # a real SIGKILL corpse
    h.spawn_rank(2, world=3)             # a joiner (init_env_only)
    assert h.wait(120).ok

Worker side::

    from paddle_tpu_torch.distributed import mp_mesh
    rank, world = mp_mesh.init()         # gloo via env.init_parallel_env
    mp_mesh.barrier("up")                # keys in rank 0's TCP store
    mp_mesh.chaos_point("pre_vote")      # dies or hangs here if chosen
    ...
    mp_mesh.finish(ok_file)              # marker + hard exit

``init`` joins the default process group through
``env.init_parallel_env``, whose backend the environment names
(``PADDLE_DISTRI_BACKEND``: ``cpu`` for gloo on the CPU, ``gloo`` for gloo
with the rank on ``cuda:<FLAGS_selected_gpus>``). The group exists so
``profiler.sink._detect_rank`` returns the mesh rank (sink directories,
engine ids); the mesh's agreement and data stay on the consensus board
and the handoff channel, never a collective, because a collective with a
dead peer hangs. Barriers are keys in rank 0's TCP store (the default
group's store).

``finish`` ends the process with ``os._exit`` after its marker: a group
whose peer was killed can hang a survivor's interpreter teardown, so the
launcher judges a worker by its exit code and its marker. Rank 0 hosts
the store, so chaos targets are ranks >= 1 and rank 0 exits last
(``finish_last``). A joiner outside the first world cannot enter the
group: it uses ``init_env_only`` and the board alone.
"""
from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["CHAOS_ENV", "KILL_EXIT", "MeshResult", "MeshHandle", "can_spawn",
           "launch", "launch_async", "init", "init_env_only", "barrier",
           "chaos_spec", "chaos_point", "wait_for_files", "finish",
           "finish_last"]

#: the checkout holding the package: the workers' working directory and
#: the head of their PYTHONPATH
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: chaos env var: "<kind>:<rank>:<point>[:<seconds>]", kind kill|hang
CHAOS_ENV = "MPMESH_CHAOS"
KILL_EXIT = 137


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def can_spawn() -> bool:
    """Whether this host can run the mesh at all (subprocesses and
    localhost sockets, and ``MPMESH_DISABLE`` unset)."""
    if os.environ.get("MPMESH_DISABLE"):
        return False
    try:
        _free_port()
        subprocess.run([sys.executable, "-c", "pass"], timeout=60,
                       check=True, capture_output=True)
        return True
    except Exception:
        return False


class MeshResult:
    """Per-rank exit codes and logs of one mesh run."""

    def __init__(self, returncodes: Dict[int, int], log_dir: str,
                 expect_fail_ranks: Sequence[int], timed_out: bool):
        self.returncodes = returncodes
        self.log_dir = log_dir
        self.expect_fail_ranks = tuple(expect_fail_ranks)
        self.timed_out = timed_out

    @property
    def ok(self) -> bool:
        """Every rank exited 0 but the chaos targets, which must not."""
        if self.timed_out:
            return False
        for r, rc in self.returncodes.items():
            if r in self.expect_fail_ranks:
                if rc == 0:
                    return False      # the chaos target survived
            elif rc != 0:
                return False
        return True

    def log(self, rank: int) -> str:
        try:
            with open(os.path.join(self.log_dir,
                                   f"workerlog.{rank}")) as f:
                return f.read()
        except OSError:
            return ""

    def tail(self, n_chars: int = 2000) -> str:
        out = [f"timed_out={self.timed_out} rcs={self.returncodes}"]
        for r in sorted(self.returncodes):
            out.append(f"--- workerlog.{r} ---\n{self.log(r)[-n_chars:]}")
        return "\n".join(out)


class MeshHandle:
    """A mesh whose workers run while the driver acts on them: kill a
    member (``kill_rank``), start a joiner (``spawn_rank``), then
    ``wait`` for the verdict ``launch`` returns."""

    def __init__(self, script: str, script_args: List[str],
                 log_dir: str, endpoints: List[str],
                 expect_fail_ranks: List[int], chaos: Optional[str],
                 env_extra: Optional[Dict[str, str]]):
        self.script = script
        self.script_args = script_args
        self.log_dir = log_dir
        self.endpoints = endpoints
        self.expect_fail_ranks = expect_fail_ranks
        self.chaos = chaos
        self.env_extra = env_extra
        self._procs: Dict[int, subprocess.Popen] = {}
        self._logs: List = []

    def _worker_env(self, rank: int, world: int) -> Dict[str, str]:
        while len(self.endpoints) < world:
            self.endpoints.append(f"127.0.0.1:{_free_port()}")
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_CURRENT_ENDPOINT": self.endpoints[rank],
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(self.endpoints[:world]),
            "PADDLE_RANK_IN_NODE": str(rank),
            "PADDLE_COORDINATOR": self.endpoints[0],
            "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
        })
        if self.chaos:
            env[CHAOS_ENV] = self.chaos
        if self.env_extra:
            env.update(self.env_extra)
        return env

    def _start(self, rank: int, env: Dict[str, str],
               args: Sequence[str]) -> subprocess.Popen:
        out = open(os.path.join(self.log_dir, f"workerlog.{rank}"), "w")
        self._logs.append(out)
        p = subprocess.Popen(
            [sys.executable, self.script] + [str(a) for a in args],
            env=env, stdout=out, stderr=subprocess.STDOUT, cwd=REPO)
        self._procs[rank] = p
        return p

    def spawn_rank(self, rank: int, world: int,
                   script_args: Optional[Sequence[str]] = None,
                   env_extra: Optional[Dict[str, str]] = None
                   ) -> subprocess.Popen:
        """Start one more worker, the mid-run joiner. It sees
        ``PADDLE_TRAINERS_NUM=world``; the members keep theirs (the
        board reconciles them). Its exit code joins ``wait``'s verdict."""
        if rank in self._procs:
            raise ValueError(f"rank {rank} already running")
        env = self._worker_env(rank, world)
        if env_extra:
            env.update(env_extra)
        return self._start(rank, env, self.script_args
                           if script_args is None else list(script_args))

    def kill_rank(self, rank: int) -> None:
        """SIGKILL one member (no cleanup, like the OOM killer); the rank
        joins ``expect_fail_ranks``."""
        p = self._procs[rank]
        if p.poll() is None:
            p.kill()
        if rank not in self.expect_fail_ranks:
            self.expect_fail_ranks.append(rank)

    def poll_rank(self, rank: int) -> Optional[int]:
        return self._procs[rank].poll()

    def wait(self, timeout: float = 300.0) -> MeshResult:
        """Watch every started process (joiners too) to its end. A rank
        outside ``expect_fail_ranks`` that fails, or the timeout, ends
        the others (SIGTERM, then SIGKILL after 10 s)."""
        rcs: Dict[int, int] = {}
        deadline = time.time() + timeout
        timed_out = False
        try:
            while len(rcs) < len(self._procs):
                if time.time() > deadline:
                    timed_out = True
                    break
                hard_fail = False
                for r, p in list(self._procs.items()):
                    if r in rcs:
                        continue
                    rc = p.poll()
                    if rc is not None:
                        rcs[r] = rc
                        if rc != 0 and r not in self.expect_fail_ranks:
                            hard_fail = True
                if hard_fail:
                    break
                time.sleep(0.05)
        finally:
            for p in self._procs.values():
                if p.poll() is None:
                    p.send_signal(signal.SIGTERM)
            kill_at = time.time() + 10
            for r, p in self._procs.items():
                while p.poll() is None and time.time() < kill_at:
                    time.sleep(0.1)
                if p.poll() is None:
                    p.kill()
                    p.wait()
                rcs.setdefault(r, p.returncode)
            for f in self._logs:
                f.close()
            self._logs = []
        return MeshResult(rcs, self.log_dir, tuple(self.expect_fail_ranks),
                          timed_out)


def launch_async(nprocs: int, script: str,
                 script_args: Sequence[str] = (), *, log_dir: str,
                 chaos: Optional[str] = None,
                 expect_fail_ranks: Sequence[int] = (),
                 env_extra: Optional[Dict[str, str]] = None) -> MeshHandle:
    """Start ``nprocs`` workers and return without waiting; the endpoint
    list grows as joiners start."""
    if nprocs < 1:
        raise ValueError("nprocs must be >= 1")
    os.makedirs(log_dir, exist_ok=True)
    endpoints = [f"127.0.0.1:{_free_port()}" for _ in range(nprocs)]
    handle = MeshHandle(script, list(script_args), log_dir, endpoints,
                        list(expect_fail_ranks), chaos, env_extra)
    for rank in range(nprocs):
        handle._start(rank, handle._worker_env(rank, nprocs),
                      script_args)
    return handle


def launch(nprocs: int, script: str, script_args: Sequence[str] = (),
           *, log_dir: str, timeout: float = 300.0,
           chaos: Optional[str] = None,
           expect_fail_ranks: Sequence[int] = (),
           env_extra: Optional[Dict[str, str]] = None) -> MeshResult:
    """Start ``nprocs`` workers with the ``PADDLE_*`` env protocol (rank
    0's endpoint holds the TCP store), watch them to their end, and
    return their verdict (``MeshHandle.wait``)."""
    return launch_async(nprocs, script, script_args, log_dir=log_dir,
                        chaos=chaos, expect_fail_ranks=expect_fail_ranks,
                        env_extra=env_extra).wait(timeout)


# ---------------------------------------------------------------------------
# worker side (called by the launched scripts)
# ---------------------------------------------------------------------------
def init() -> Tuple[int, int]:
    """Join the mesh's default process group through
    ``env.init_parallel_env`` (the backend ``PADDLE_DISTRI_BACKEND``
    names; without it, a card's default, which raises where there is no
    card). Returns (rank, world)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from .env import init_parallel_env

    env = init_parallel_env()
    return env.rank, env.world_size


def init_env_only() -> Tuple[int, int]:
    """(rank, world) from the env protocol, with no process group: a
    joiner's bring-up (it cannot enter a group it was not started
    with; the board needs none)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    return (int(os.environ.get("PADDLE_TRAINER_ID", "0")),
            int(os.environ.get("PADDLE_TRAINERS_NUM", "1")))


def _store():
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("mp_mesh.init() first (single-process run?)")
    return dist.distributed_c10d._get_default_store()


def barrier(name: str, timeout_ms: int = 60000) -> None:
    """Wait until every rank of the group reached ``name`` (a counter
    key in rank 0's store). Not after a chaos kill: a dead peer never
    arrives; the board's lease paths handle that case."""
    import torch.distributed as dist

    store, world = _store(), dist.get_world_size()
    key = f"mpmesh_barrier/{name}"
    store.add(key, 1)
    deadline = time.monotonic() + timeout_ms / 1e3
    while store.add(key, 0) < world:
        if time.monotonic() > deadline:
            raise TimeoutError(f"mp_mesh barrier {name!r}: "
                               f"{store.add(key, 0)}/{world} arrived")
        time.sleep(0.01)


def chaos_spec() -> Optional[Tuple[str, int, str, float]]:
    """The parsed ``MPMESH_CHAOS``: (kind, rank, point, seconds) or
    None."""
    raw = os.environ.get(CHAOS_ENV)
    if not raw:
        return None
    parts = raw.split(":")
    if len(parts) < 3:
        raise ValueError(f"bad {CHAOS_ENV} spec {raw!r}")
    kind, rank, point = parts[0], int(parts[1]), parts[2]
    secs = float(parts[3]) if len(parts) > 3 else 3600.0
    if kind not in ("kill", "hang"):
        raise ValueError(f"bad {CHAOS_ENV} kind {kind!r}")
    return kind, rank, point, secs


def chaos_point(name: str, rank: Optional[int] = None) -> None:
    """A named fault-injection site. With ``chaos="kill:<rank>:<name>"``
    the chosen rank dies here (``os._exit(137)``: no cleanup, like an
    OOM kill); ``hang:<rank>:<name>[:s]`` sleeps ``s`` seconds (a wedged
    peer)."""
    spec = chaos_spec()
    if spec is None:
        return
    kind, target, point, secs = spec
    if point != name:
        return
    if rank is None:
        rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    if rank != target:
        return
    if kind == "kill":
        sys.stdout.write(f"[mp_mesh] rank {rank} chaos-killed at "
                         f"{name!r}\n")
        sys.stdout.flush()
        os._exit(KILL_EXIT)
    sys.stdout.write(f"[mp_mesh] rank {rank} chaos-hang {secs}s at "
                     f"{name!r}\n")
    sys.stdout.flush()
    time.sleep(secs)


def wait_for_files(paths: Sequence[str], timeout_s: float = 60.0) -> bool:
    """Poll until every path exists (True) or the timeout passes."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if all(os.path.exists(p) for p in paths):
            return True
        time.sleep(0.05)
    return all(os.path.exists(p) for p in paths)


def finish_last(ok_file: str, peer_ok_files: Sequence[str],
                timeout_s: float = 60.0) -> None:
    """Rank 0's epilogue: wait for the other survivors' markers (rank 0
    holds the store), then write its own and exit; nonzero when a peer's
    marker never appears."""
    ok = wait_for_files(peer_ok_files, timeout_s)
    if not ok:
        missing = [p for p in peer_ok_files if not os.path.exists(p)]
        sys.stdout.write(f"[mp_mesh] missing peer markers: {missing}\n")
    finish(ok_file if ok else None, 0 if ok else 1)


def finish(ok_file: Optional[str] = None, code: int = 0) -> None:
    """A worker's epilogue: write the marker, flush, and ``os._exit``
    (module docstring)."""
    if ok_file:
        with open(ok_file, "w") as f:
            f.write("OK\n")
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
