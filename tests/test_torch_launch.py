"""The port's launcher (``python -m paddle_tpu_torch.distributed.launch``):
the env protocol and failure propagation (mirrors
``tests/test_launch.py:25-49``).

Two launcher jobs: 2 ranks that read the protocol, meet at rank 0's TCP
store (``PADDLE_COORDINATOR``, as the reference's launcher test keeps
TCP) over gloo on the CPU (``--backend cpu``), all-reduce once, check
their ``sys.modules`` for JAX and the JAX package and write per-rank
logs; and 2 ranks of which one fails while the other waits, which the
launcher must terminate, exiting with the failed rank's code.
"""
import os
import subprocess
import sys
import time

import pytest

from paddle_tpu_torch.distributed import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_launch(args, timeout=120):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
              "PADDLE_COORDINATOR", "FLAGS_selected_gpus"):
        env.pop(k, None)
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch"] + args,
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)


ENV_SCRIPT = """\
import os, sys
import torch
import paddle_tpu_torch.distributed as dist
rank = os.environ['PADDLE_TRAINER_ID']
n = os.environ['PADDLE_TRAINERS_NUM']
eps = os.environ['PADDLE_TRAINER_ENDPOINTS'].split(',')
cur = os.environ['PADDLE_CURRENT_ENDPOINT']
assert cur == eps[int(rank)] and n == '2' and len(eps) == 2
assert os.environ['PADDLE_COORDINATOR'] == eps[0]
assert os.environ['PADDLE_RANK_IN_NODE'] == rank
assert os.environ['PADDLE_DISTRI_BACKEND'] == 'cpu'
assert sys.argv[2:] == ['--flag', 'v']
env = dist.init_parallel_env()
assert (env.rank, env.world_size) == (int(rank), 2)
assert env.current_endpoint == cur and str(env.device) == 'cpu'
assert torch.distributed.get_backend() == 'gloo'
t = torch.full((3,), float(env.rank + 1))
dist.all_reduce(t)
assert t.tolist() == [3.0, 3.0, 3.0]
bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')
       or m == 'paddle_tpu' or m.startswith('paddle_tpu.')]
assert not bad, bad
print('rank', rank, 'ok')
open(os.path.join(sys.argv[1], 'env_ok.' + rank), 'w').write('ok')
"""


@pytest.fixture(scope="module")
def env_job(tmp_path_factory):
    d = tmp_path_factory.mktemp("launch_env")
    script = d / "dump_env.py"
    script.write_text(ENV_SCRIPT)
    r = _run_launch(["--nproc_per_node", "2", "--backend", "cpu",
                     "--log_dir", str(d / "logs"), str(script), str(d),
                     "--flag", "v"])
    return d, r


def _logs(d):
    out = ""
    for f in sorted((d / "logs").iterdir()) if (d / "logs").exists() else ():
        out += f"\n--- {f.name} ---\n" + f.read_text()[-2000:]
    return out


def test_launcher_env_protocol_and_tcp_rendezvous(env_job):
    d, r = env_job
    assert r.returncode == 0, _logs(d) or r.stderr[-2000:]
    assert (d / "env_ok.0").exists() and (d / "env_ok.1").exists()


def test_launcher_writes_per_rank_logs(env_job):
    d, _ = env_job
    for rank in (0, 1):
        assert f"rank {rank} ok" in (d / "logs" / f"workerlog.{rank}"
                                     ).read_text()


def test_launcher_propagates_failure_and_terminates_the_rest(tmp_path):
    script = tmp_path / "boom.py"
    script.write_text("import os, sys, time\n"
                      "if os.environ['PADDLE_TRAINER_ID'] == '1':\n"
                      "    sys.exit(3)\n"
                      "time.sleep(60)\n")
    t0 = time.time()
    r = _run_launch(["--nproc_per_node", "2", str(script)])
    assert r.returncode == 3
    assert time.time() - t0 < 30      # rank 0 was terminated, not awaited


def test_host_devices_accepts_one_device_per_rank():
    assert launch.parse_args(["--host_devices", "1", "x.py"]).host_devices \
        == 1
    assert launch.parse_args(["x.py"]).host_devices == 0
    with pytest.raises(SystemExit):
        launch.parse_args(["--host_devices", "4", "x.py"])
    with pytest.raises(SystemExit):
        launch.parse_args(["--backend", "mpi", "x.py"])


def test_cluster_endpoints_and_defaults():
    assert launch.get_cluster_endpoints(["a", "b"], 2, 100) == [
        "a:100", "a:101", "b:100", "b:101"]
    a = launch.parse_args(["train.py", "--lr", "0.1"])
    assert (a.nproc_per_node, a.ips, a.backend, a.training_script,
            a.training_script_args) == (1, "127.0.0.1", None, "train.py",
                                        ["--lr", "0.1"])
