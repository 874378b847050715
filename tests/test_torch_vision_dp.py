"""ResNet-18 with its batch norms in the port's ``compile_train_step`` at
dp 2 on gloo ranks (``tests/data/torch_dist_worker.py``'s ``vision``
job), held against the JAX trainer at the same mesh on 2 virtual
devices, step by step from the reference's state, under the bound of
``tests/test_torch_vision_train.py`` (its docstring gives the why):

- ZeRO 0, where the reference's one program sees the whole batch and the
  batch moments span both ranks (the port's differentiable all-reduce);
- ZeRO 1, the flat slab, where each rank takes its own slice's moments
  and the running buffers are averaged after the step;
- the ZeRO 0 case run with shard-local moments instead misses the
  reference's buffers by more than 1e-3 and 100 times the bound, so the
  global reduction is what the check sees; ZeRO 1's reference buffers
  and ZeRO 0's differ by more than 1e-3 too.
"""
import numpy as np
import pytest
import torch

from test_torch_vision_train import F32, NOISE, NOISE_FACTOR, _check, oracle


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_resnet18_train_step_dp2_batch_norm_routes(tmp_path):
    cases = [{"name": "zero0", "mesh": {"dp": 2}, "zero": 0},
             {"name": "zero1", "mesh": {"dp": 2}, "zero": 1},
             {"name": "zero0_local", "mesh": {"dp": 2}, "zero": 0,
              "local": True, "steps": 1}]
    traj = {name: oracle.jax_vision_trajectory({"dp": 2}, zero=zero,
                                               perturb=NOISE[False])
            for name, zero in (("zero0", 0), ("zero1", 1))}
    assert traj["zero1"]["zero_manual"] and not traj["zero0"]["zero_manual"]
    traj["zero0_local"] = traj["zero0"]
    res = oracle.run_job(tmp_path, "vision", 2,
                         oracle.vision_inputs(traj, cases), timeout=400)
    oracle.foreign_free(res)
    steps = len(traj["zero0"]["losses"])
    for rank in range(2):
        arrays, values = res[rank]
        assert values["zero1.zero_manual"] and \
            not values["zero0.zero_manual"]

        def after(name):
            return [{n[len(f"{name}.{k + 1}."):]: a
                     for n, a in arrays.items()
                     if n.startswith(f"{name}.{k + 1}.")}
                    for k in range(steps)]

        for name in ("zero0", "zero1"):
            _check(traj[name], values[f"{name}.losses"], after(name), F32,
                   f"rank {rank} {name}")
        # shard-local moments on the global route miss its buffers by far
        # more than the bound above, and the two routes' reference
        # buffers differ as well
        local = after("zero0_local")[0]
        want = traj["zero0"]["states"][1]["buffers"]
        pert = traj["zero0"]["perturbed"][0]["buffers"]
        other = traj["zero1"]["states"][1]["buffers"]

        def gap(a, b):
            return max(float(np.abs(a[n] - b[n]).max()) for n in want
                       if n.endswith("_variance"))

        noise = NOISE_FACTOR * gap(pert, want)
        assert gap(local, want) > max(1e-3, 100 * noise), \
            (gap(local, want), noise)
        assert gap(other, want) > 1e-3
