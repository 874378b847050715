"""ResNet-18 with its batch norms in the port's ``compile_train_step``,
held against the JAX package's trainer on the CPU (``bench.py:213-243``'s
train step at test size: 10 classes, 32², global batch 8,
``Momentum(0.1)``, the loss ``cross_entropy(out.float(), label)``).

The JAX trainer runs 3 steps free and its state (parameters, the batch
norms' ``_mean``/``_variance``, the Momentum velocity) is recorded
before and after each (``torch_hybrid_oracle.jax_vision_trajectory``).
The port takes each step from the reference's state before it, on the
same global batch, and must give the reference's loss (all three steps)
and its state after the first two, each tensor within ``tol ·
max(|ref|, 1)`` (f32: 1e-5, amp: 2e-3) or within ten times the
reference's own response to noise in the images
(the same step from the same state on images times ``1 + d·N(0, 1)``,
d = 1e-6 in f32 and 4e-3 under amp), whichever is larger.

Why the second bound: a batch norm normalises its channel with gain
``1/sqrt(var + eps)``; at 32² layer4's maps are 1x1, so a norm over a
micro-batch or dp slice of 4 rows sees 4 values a channel and its gain
reaches 316, forward and backward, and under amp every activation is
rounded to bf16 (relative 4e-3) before it. Two implementations whose
convs sum in other orders then part by that gain times their rounding
(measured: 1e-4 in conv1's weight after one step with two micro-batches;
8.6e-3 of the loss under amp), and so does the reference from itself
when its images move by a rounding. Measured, the port stays within 7
times that response at every tensor of every case. A difference of
rule (the momentum, the biased variance, global against shard-local
moments) moves the state by orders of magnitude more. Each step is
held from the same state because ``Momentum(0.1)`` on this random batch
takes the loss from 5 to 16 in three steps: run free, any two such
implementations part further each step. The state after the third step
is not held: there, in the dp 2 ZeRO 0 run, one output of layer1.0's
first batch norm lies 4.2e-7 from the ReLU's kink, the two packages
round it to opposite sides, and that channel's bias gradient is 0.0070
in one and 0.0136 in the other (measured; the reference's eager model
agrees with its trainer, and the port's dp 1 and dp 2 trainers agree
with each other to 3e-8): a tie the weights of that step decide, not a
rule, which the exploding loss makes likely.

- dp 1 in this process: f32, amp (bf16 parameters and activations, the
  buffers f32) and ``accumulate_steps`` 2 (the buffers move once a
  micro-batch, in order).
- dp 2 on gloo ranks: ``tests/test_torch_vision_dp.py``.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

_spec = importlib.util.spec_from_file_location(
    "torch_hybrid_oracle", os.path.join(os.path.dirname(__file__), "data",
                                        "torch_hybrid_oracle.py"))
oracle = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(oracle)

F32, AMP = 1e-5, 2e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the images' relative noise of the reference's own response
NOISE = {False: 1e-6, True: 4e-3}
#: how many times that response the port may differ by
NOISE_FACTOR = 10.0
#: the steps after which the state is held (see the module docstring)
HELD_STATES = 2


def _check(traj, losses, after, tol, what):
    """The port's losses and states after each step (``after[k]``: name ->
    array, parameters and buffers) against the reference trajectory:
    each within ``tol · max(|ref|, 1)`` or ``NOISE_FACTOR`` times the
    reference's response to image noise, whichever is larger."""
    for k, (got, want, pert) in enumerate(zip(
            losses, traj["losses"], traj["perturbed_losses"])):
        bound = max(tol * max(abs(want), 1.0),
                    NOISE_FACTOR * abs(pert - want))
        assert abs(got - want) <= bound, (what, k, got, want, bound)
    for k, got in enumerate(after[:HELD_STATES]):
        want = dict(traj["states"][k + 1]["params"],
                    **traj["states"][k + 1]["buffers"])
        pert = dict(traj["perturbed"][k]["params"],
                    **traj["perturbed"][k]["buffers"])
        assert sorted(got) == sorted(want)
        for n, w in want.items():
            err = float(np.abs(got[n] - w).max())
            bound = max(tol * max(float(np.abs(w).max()), 1.0),
                        NOISE_FACTOR * float(np.abs(pert[n] - w).max()))
            assert err <= bound, (what, k, n, err, bound)


def _run_local(case, traj):
    """The worker's step loop in this process at dp 1."""
    worker = oracle.worker
    inp = oracle.vision_inputs({case["name"]: traj}, [case])
    arrays, values = {}, {}
    worker.vision_step_case(inp, case, 0, arrays, values)
    after = [{n[len(f"{case['name']}.{k + 1}."):]: a
              for n, a in arrays.items()
              if n.startswith(f"{case['name']}.{k + 1}.")}
             for k in range(len(traj["losses"]))]
    return values[f"{case['name']}.losses"], after


@pytest.mark.parametrize("amp,acc", [(False, 1), (True, 1), (False, 2)],
                         ids=["f32", "amp", "accumulate2"])
def test_resnet18_train_step_dp1_matches_reference(amp, acc):
    traj = oracle.jax_vision_trajectory({"dp": 1}, amp=amp, accumulate=acc,
                                        perturb=NOISE[amp])
    case = {"name": "dp1", "mesh": {"dp": 1}, "amp": amp,
            "accumulate": acc}
    losses, after = _run_local(case, traj)
    _check(traj, losses, after, AMP if amp else F32, f"dp1 {case}")
    moved = [n for n in traj["buffer_names"] if n.endswith("_variance")
             and not np.allclose(after[0][n], 1.0)]
    assert len(moved) == len([n for n in traj["buffer_names"]
                              if n.endswith("_variance")])
