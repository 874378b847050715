"""Distributed launcher CLI: ``python -m paddle_tpu_torch.distributed.launch``
(mirrors ``paddle_tpu/distributed/launch.py:1-158``; reference:
python/paddle/distributed/fleet/launch.py:334 launch(), launch_utils.py
:435-464 start_local_trainers, :295 terminate_local_procs).

One process per rank, each with the reference's env protocol:
``PADDLE_TRAINER_ID``, ``PADDLE_CURRENT_ENDPOINT``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ENDPOINTS``,
``PADDLE_RANK_IN_NODE`` and ``PADDLE_COORDINATOR`` (the first endpoint:
rank 0's TCP store, ``env.init_parallel_env``). ``--backend`` sets the
children's backend (``PADDLE_DISTRI_BACKEND``: ``nccl``, ``gloo``, or
``cpu`` for gloo on the CPU). A rank uses ``cuda:<FLAGS_selected_gpus>``,
whose default is its rank in the node; set ``FLAGS_selected_gpus`` to
put every rank on one card. Per-rank logs go to
``<log_dir>/workerlog.<rank>``; when one rank fails the others are
terminated and the launcher exits with its code.

``--host_devices`` (the reference's virtual CPU devices per rank) has no
torch counterpart: a rank holds one device. It accepts 0 or 1.

Usage:
    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 train.py
    python -m paddle_tpu_torch.distributed.launch --backend cpu \\
        --nproc_per_node 4 --log_dir logs train.py --lr 0.1
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="spawn one training process per rank with the "
                    "PADDLE_* env protocol")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="ranks to spawn on this node")
    p.add_argument("--ips", type=str, default="127.0.0.1",
                   help="comma-separated node ips (multi-host)")
    p.add_argument("--node_rank", type=int,
                   default=int(os.environ.get("PADDLE_NODE_RANK", "0")))
    p.add_argument("--started_port", type=int, default=0,
                   help="base port for rank endpoints (0 = pick free)")
    p.add_argument("--log_dir", type=str, default=None,
                   help="write per-rank logs to <log_dir>/workerlog.<rank>")
    p.add_argument("--backend", type=str, default=None,
                   choices=("nccl", "gloo", "cpu"),
                   help="the children's backend (cpu: gloo on the CPU)")
    p.add_argument("--host_devices", type=int, default=0,
                   help="devices per rank: 0 or 1 (a torch rank holds one "
                        "device)")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if args.host_devices not in (0, 1):
        p.error(f"--host_devices {args.host_devices}: a torch rank holds one "
                "device (the reference's virtual CPU devices per rank have "
                "no counterpart); launch more ranks with --nproc_per_node")
    return args


def get_cluster_endpoints(ips: List[str], nproc: int, base_port: int
                          ) -> List[str]:
    """reference: launch.py get_cluster_from_args:172."""
    return [f"{ip}:{base_port + i}" for ip in ips for i in range(nproc)]


def start_local_trainers(args, endpoints: List[str]) -> List[subprocess.Popen]:
    """reference: launch_utils.py start_local_trainers:435."""
    procs = []
    nproc = args.nproc_per_node
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    for local_rank in range(nproc):
        rank = args.node_rank * nproc + local_rank
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
            "PADDLE_TRAINERS_NUM": str(len(endpoints)),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
            "PADDLE_RANK_IN_NODE": str(local_rank),
            "PADDLE_COORDINATOR": endpoints[0],
        })
        if args.backend:
            env["PADDLE_DISTRI_BACKEND"] = args.backend
        cmd = [sys.executable, args.training_script] + \
            args.training_script_args
        out = None
        if args.log_dir:
            out = open(os.path.join(args.log_dir, f"workerlog.{rank}"), "w")
        try:
            procs.append(subprocess.Popen(
                cmd, env=env, stdout=out,
                stderr=subprocess.STDOUT if out else None))
        finally:
            if out is not None:
                out.close()
    return procs


def watch_local_trainers(procs: List[subprocess.Popen]) -> int:
    """Poll the children; on any failure terminate the rest (reference:
    launch_utils.py watch_local_trainers + terminate_local_procs:295)."""
    try:
        while True:
            alive = False
            for p in procs:
                rc = p.poll()
                if rc is None:
                    alive = True
                elif rc != 0:
                    terminate_local_procs(procs)
                    return rc
            if not alive:
                return 0
            time.sleep(0.2)
    except KeyboardInterrupt:
        terminate_local_procs(procs)
        return 130


def terminate_local_procs(procs: List[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.time() + 10
    for p in procs:
        while p.poll() is None and time.time() < deadline:
            time.sleep(0.2)
        if p.poll() is None:
            p.kill()
            p.wait()


def launch(argv=None) -> int:
    args = parse_args(argv)
    if args.training_script_args[:1] == ["--"]:
        args.training_script_args = args.training_script_args[1:]
    ips = [ip.strip() for ip in args.ips.split(",") if ip.strip()]
    base = args.started_port or _free_port()
    endpoints = get_cluster_endpoints(ips, args.nproc_per_node, base)
    return watch_local_trainers(start_local_trainers(args, endpoints))


if __name__ == "__main__":
    sys.exit(launch())
