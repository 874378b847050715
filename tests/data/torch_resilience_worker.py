"""One rank of the port's two-rank resilience mesh (``tests/
test_torch_resilience_mesh.py``), started by
``paddle_tpu_torch.distributed.mp_mesh``: ``ResilientRunner`` with the
consensus board, a NaN streak only rank 1 injects, and a mesh-agreed
rollback (the port's counterpart of ``tests/multihost/
worker_resilience.py``).

    python tests/data/torch_resilience_worker.py <out_dir> <mode>

``plain``: environment-only ranks (no process group), each a degree-1
trainer of the same seed on the same batches, each with its own
checkpoint directory, paced so that neither runs more than 2 cursors
ahead of the other; rank 0 sees nothing wrong and joins the round rank 1
opens. ``zero``: one gloo group, a {"dp": 2} trainer at ZeRO 1 with int8
gradients over it and one shared checkpoint directory; the verdict is
agreed by the trainer's MIN over dp, and both ranks open the round. Each
rank writes ``run.<rank>.json`` (rollbacks, skips, losses, the steps it
restored to). The worker never imports JAX.
"""
import json
import os
import sys
import time

TOTAL_STEPS = 7
NAN_CURSORS = {3, 4}


def main():
    out_dir, mode = sys.argv[1], sys.argv[2]
    from paddle_tpu_torch.distributed import mp_mesh

    rank, world = mp_mesh.init() if mode == "zero" else \
        mp_mesh.init_env_only()
    assert world == 2
    import numpy as np

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed.consensus import Consensus
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.hybrid import HybridPipelineTrainer
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.resilience import (ResilienceConfig,
                                             ResilientRunner, chaos)

    pt.seed(11)
    net = GPT(GPTConfig(vocab_size=128, hidden_size=32, num_layers=2,
                        num_heads=2, max_seq_len=16), device="cpu")
    opt = AdamW(2e-3, parameters=net.named_parameters())
    strat = DistributedStrategy()
    kw, mesh = {}, None
    if mode == "zero":
        mesh = M.init_mesh({"dp": 2})
        strat.sharding = True
        strat.sharding_configs = {"sharding_stage": 1}
        kw["dp_grad_comm"] = "int8"
    tr = HybridPipelineTrainer(net, opt, strat, mesh, n_micro=1,
                               guard_bad_steps=True, **kw)
    if mode == "zero":
        assert tr.zero_manual, "zero mode did not take the slab route"
    cons = Consensus(os.path.join(out_dir, "board"), rank, world,
                     lease_s=3.0, timeout_s=120.0)

    def batch(cursor):
        rng = np.random.RandomState(1000 + cursor)
        return (rng.randint(0, 128, (2, 16)).astype(np.int64),)

    prog = os.path.join(out_dir, "prog")
    os.makedirs(prog, exist_ok=True)

    def gated(cursor):
        """Replicated data's pacing: never more than 2 cursors ahead of
        the peer; an open resil round ends the wait (the agreed
        rollback makes the pacing moot)."""
        with open(os.path.join(prog, f"p.{rank}"), "w") as f:
            f.write(str(cursor))
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                with open(os.path.join(prog, f"p.{1 - rank}")) as f:
                    peer = int(f.read())
            except (OSError, ValueError):
                peer = -1
            if peer >= cursor - 2 or cons.pending("resil"):
                break
            time.sleep(0.01)
        return batch(cursor)

    plan = chaos.ChaosPlan(nan_cursors=NAN_CURSORS) if rank == 1 else None
    ckpt = os.path.join(out_dir, "ckpt" if mode == "zero" else
                        f"ckpt{rank}")
    runner = ResilientRunner(
        tr, ckpt, save_interval=3,
        config=ResilienceConfig(bad_step_limit=2, consensus=cons),
        chaos=plan)
    restored = []
    resume = runner.elastic.resume
    runner.elastic.resume = lambda *a, **k: (
        restored.append(resume(*a, **k)), restored[-1])[1]
    res = runner.run(batch if mode == "zero" else gated, TOTAL_STEPS)
    assert res.completed
    with open(os.path.join(out_dir, f"run.{rank}.json"), "w") as f:
        json.dump({"rank": rank, "rollbacks": res.rollbacks,
                   "skips": sorted(runner._skips), "restored": restored,
                   "losses": {str(s): res.losses[s]
                              for s in sorted(res.losses)},
                   "foreign_modules": sorted(
                       m for m in sys.modules if m == "jax"
                       or m.startswith("jax.") or m == "paddle_tpu"
                       or m.startswith("paddle_tpu."))}, f)
    ok = os.path.join(out_dir, f"ok.{rank}")
    if rank == 0:
        mp_mesh.finish_last(ok, [os.path.join(out_dir, "ok.1")])
    mp_mesh.finish(ok)


if __name__ == "__main__":
    main()
