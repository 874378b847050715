"""The bad-step guard and the mesh-agreed rollback on gloo ranks (CPU),
held against the JAX package.

- The guarded ``HybridPipelineTrainer`` at degree 1 (in this process)
  and on two ranks at dp 2 with ZeRO 1,
  2 and 3, with int8 gradients (ZeRO 1, the slab's int8 ring), at pp 2
  and with ``offload_optimizer``, gpt_tiny for 3 steps with a NaN
  injected on rank 1 ALONE before step 1 (``tests/data/
  torch_dist_worker.py``'s ``poison``), against the JAX trainer with the
  guard on the same sequence (``torch_hybrid_oracle.jax_guarded``,
  poison global there; the reference's sharded and replicated runs are
  bitwise equal, so one degree-1 run is the oracle of every f32 case):
  every rank's verdicts equal the reference's (the poisoned step False
  on both ranks: the MIN over the mesh), the poisoned step leaves every
  byte of each rank's state as it was, the losses of the clean steps
  within ``LOSS_RTOL`` on every rank (the poisoned step's is NaN on
  every rank: under dp through the dp mean, under pp through the product
  of the stages' fault scales, as the reference's one global loss is
  NaN), and the parameters within
  ``PARAM_ATOL`` where the step-0 gradient is clear of zero. The int8
  case is held to the same f32 oracle within what quantization moves an
  Adam step (each applied step about lr·sign(g), an element near zero
  may go the other way; the slab's bf16 return rounds each parameter),
  as ``tests/test_torch_qcomm.py`` holds int8 runs (the reference's int8
  loss-curve pin is red, ROADMAP queue 3 item 3).
- ``ResilientRunner`` with the consensus board on two real processes
  (``distributed.mp_mesh``; worker ``tests/data/torch_resilience_
  worker.py``), NaN only on rank 1 at cursors 3 and 4, ``bad_step_limit``
  2: in ``plain`` mode (replicated degree-1 trainers, rank 0 joins the
  round rank 1 opens) and in ``zero`` mode (dp 2, ZeRO 1, int8 gradients
  over gloo, one shared checkpoint) both ranks roll back once, to the
  same step, both skip [3, 4], and their loss curves are bitwise equal
  and finite: the port's ``tests/multihost/test_resilience_mesh.py``.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

from paddle_tpu_torch.distributed import mp_mesh

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "torch_hybrid_oracle", os.path.join(HERE, "data",
                                        "torch_hybrid_oracle.py"))
oracle = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(oracle)

WORKER = os.path.join(HERE, "data", "torch_resilience_worker.py")
POISON = {"steps": list(oracle.POISON_STEPS), "rank": 1}
G = dict(guard_bad_steps=True, poison=POISON)
CASES = [dict(name="dp2_z1", mesh={"dp": 2}, zero=1, **G),
         dict(name="dp2_z2", mesh={"dp": 2}, zero=2, **G),
         dict(name="dp2_z3", mesh={"dp": 2}, zero=3, **G),
         dict(name="dp2_z1_int8", mesh={"dp": 2}, zero=1,
              dp_grad_comm="int8", **G),
         dict(name="pp2", mesh={"pp": 2}, n_micro=2, **G),
         dict(name="dp2_offload", mesh={"dp": 2}, offload_optimizer=True,
              **G)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this process's trainer: the test workers
    share the machine's cores (the ranks run one each)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    _, state = oracle.ref_state()
    res = oracle.run_job(tmp_path_factory.mktemp("guard"), "hybrid", 2,
                         oracle.inputs(state, cases=json.dumps(CASES)))
    oracle.foreign_free(res)
    return res


@pytest.fixture(scope="module")
def ref():
    """The JAX trainer with the guard on the poisoned sequence, and the
    step-0 gradients (the parameter check's mask)."""
    state0, losses, oks, final = oracle.jax_guarded({"dp": 1})
    g0 = oracle.ref_grads(state0, oracle.tokens()[0])[1]
    return state0, losses, oks, final, g0


def _poisoned(i):
    return i in POISON["steps"]


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_guard_matches_reference_with_one_rank_poisoned(port, ref, case):
    name = case["name"]
    state0, losses, oks, final, g0 = ref
    assert oks == [not _poisoned(i) for i in range(len(losses))]
    for rank, (_, values) in enumerate(port):
        assert values[f"{name}.oks"] == oks, (rank, values[f"{name}.oks"])
        for i in POISON["steps"]:
            assert values[f"{name}.kept.{i}"] is True, (rank, i)
        got = values[f"{name}.losses"]
        for i, (a, b) in enumerate(zip(got, losses)):
            if not _poisoned(i):
                tol = 2e-2 if "int8" in name else oracle.LOSS_RTOL
                assert a == pytest.approx(b, rel=tol), (rank, i, a, b)
            else:
                assert np.isnan(a) and np.isnan(b), (rank, i, a, b)
    prefix = f"{name}.param."
    if "int8" not in name:
        oracle.assert_params(port[0][0], final, state0, g0, prefix=prefix)
        return
    applied = len(losses) - len(POISON["steps"])
    moved = 0.0
    for n, w in final.items():
        a = port[0][0][prefix + n]
        bound = 2 * oracle.LR * applied + 2.0 ** -8 * np.abs(w) + 1e-6
        assert (np.abs(a - w) <= bound).all(), n
        moved = max(moved, float(np.abs(a - state0[n]).max()))
    assert moved > 100 * oracle.PARAM_ATOL, moved


def test_guard_matches_reference_at_degree_one(ref):
    """The same sequence on one process (no mesh): the verdicts, the
    losses (NaN at the poisoned step) and the parameters."""
    import math

    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.hybrid import HybridPipelineTrainer
    from paddle_tpu_torch.models import gpt as tgpt
    from paddle_tpu_torch.optimizer import AdamW

    state0, losses, oks, final, g0 = ref
    pt.seed(3)
    net = tgpt.GPT(tgpt.GPTConfig(**oracle.CFG), device="cpu")
    tgpt.load_reference_state(net, state0)
    opt = AdamW(oracle.LR, parameters=net.named_parameters(),
                weight_decay=0.01,
                grad_clip=tnn.ClipGradByGlobalNorm(oracle.CLIP))
    tr = HybridPipelineTrainer(net, opt, DistributedStrategy(),
                               guard_bad_steps=True)
    got, got_ok = [], []
    for i, t in enumerate(oracle.tokens()):
        if _poisoned(i):
            tr.inject_fault_scale(float("nan"))
        got.append(float(tr.step(torch.from_numpy(t).long())))
        got_ok.append(tr.last_step_ok)
    assert got_ok == oks
    for a, b in zip(got, losses):
        assert (math.isnan(a) and math.isnan(b)) or \
            a == pytest.approx(b, rel=oracle.LOSS_RTOL), (got, losses)
    oracle.assert_params(tgpt.state_to_numpy(tr.sync_to_layer()), final,
                         state0, g0)


@pytest.fixture(scope="module", params=["plain", "zero"])
def agreed(request, tmp_path_factory):
    if not mp_mesh.can_spawn():
        pytest.skip("this host cannot spawn worker processes")
    out = tmp_path_factory.mktemp(f"resil_{request.param}")
    res = mp_mesh.launch(2, WORKER, [str(out), request.param],
                         log_dir=str(out / "logs"), timeout=240,
                         env_extra={"PADDLE_DISTRI_BACKEND": "cpu",
                                    "OMP_NUM_THREADS": "1"})
    assert res.ok, res.tail()
    runs = []
    for r in range(2):
        with open(out / f"run.{r}.json") as f:
            runs.append(json.load(f))
    return request.param, runs


def test_one_rank_nan_rolls_the_mesh_back_in_lockstep(agreed):
    mode, runs = agreed
    for run in runs:
        assert run["foreign_modules"] == [], run["foreign_modules"]
    # both ranks rolled back once: in plain mode rank 0 because the mesh
    # agreed, not because it saw anything wrong itself
    assert [d["rollbacks"] for d in runs] == [1, 1]
    assert runs[0]["skips"] == runs[1]["skips"] == [3, 4]
    # the first resume found nothing; the rollback restored the same
    # committed step on both ranks (the reducer's min target)
    assert runs[0]["restored"] == runs[1]["restored"] == [0, 3]
    l0 = [runs[0]["losses"][k] for k in sorted(runs[0]["losses"], key=int)]
    l1 = [runs[1]["losses"][k] for k in sorted(runs[1]["losses"], key=int)]
    assert len(l0) == len(l1) == 7
    assert np.isfinite(l0).all() and np.isfinite(l1).all()
    np.testing.assert_array_equal(l0, l1)
