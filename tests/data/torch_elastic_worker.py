"""One life of the port's elastic training run (``tests/
test_torch_elastic.py``): gpt_tiny through ``ElasticTrainer`` on the CPU,
appending ``step,loss`` lines to a log; the test SIGKILLs it and starts
it again, and the curve must continue bit for bit.

    python tests/data/torch_elastic_worker.py <ckpt_dir> <log> <total>

``ELASTIC_STEP_DELAY`` paces each logged step; ``ELASTIC_SLOW_WRITE``
makes every checkpoint write that slow (the kill then lands mid-save).
Each life appends the step it resumed from to ``<log>.resumed``. The worker never imports JAX.
"""
import os
import sys
import time

import numpy as np


def main():
    ckpt_dir, log_path, total = sys.argv[1], sys.argv[2], int(sys.argv[3])
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import checkpoint as dck
    from paddle_tpu_torch.distributed.elastic import ElasticTrainer
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.hybrid import HybridPipelineTrainer
    from paddle_tpu_torch.models import gpt as tgpt
    from paddle_tpu_torch.optimizer import AdamW

    slow = float(os.environ.get("ELASTIC_SLOW_WRITE", "0"))
    if slow:
        write = dck._PyWriter.write

        def slow_write(self, data):
            time.sleep(slow)
            write(self, data)

        dck._PyWriter.write = slow_write

    pt.seed(11)
    net = tgpt.gpt_tiny(device="cpu")
    opt = AdamW(2e-3, parameters=net.named_parameters())
    tr = HybridPipelineTrainer(net, opt, DistributedStrategy(), n_micro=2)
    el = ElasticTrainer(tr, ckpt_dir, save_interval=2, prefetch_depth=2,
                        async_dispatch=True, snapshot_async=True)

    def data_fn(cursor):
        rng = np.random.RandomState(1000 + cursor)
        return (rng.randint(0, 128, (4, 32)).astype(np.int64),)

    log = open(log_path, "a")
    resume = el.resume
    el.resume = lambda *a, **k: _note(log_path, resume(*a, **k))
    delay = float(os.environ.get("ELASTIC_STEP_DELAY", "0"))

    def on_step(step, loss):
        log.write(f"{step},{loss!r}\n")
        log.flush()
        os.fsync(log.fileno())
        time.sleep(delay)

    el.run(data_fn, total, on_step=on_step)
    print("DONE")


def _note(log_path, step):
    with open(log_path + ".resumed", "a") as f:
        f.write(f"{step}\n")
    return step


if __name__ == "__main__":
    main()
