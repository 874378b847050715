"""Planning without allocation (``paddle_tpu_torch/distributed/plan.py``):
the trainers' ``aot_lower``/``aot_compile``/``memory_analysis`` run the
step's own code on fake tensors.

- The collectives a plan records at a planning world of 2
  (``env.plan_world``) are those a real 2-rank gloo step counts
  (``count_collectives``, ``tests/data/torch_dist_worker.py``'s
  ``hybrid`` job on gpt_tiny), kind by kind and byte for byte, at dp 2
  ZeRO 2, tp 2 and pp 2, on each rank.
- The plan's arguments are ``memory_ledger``'s state bytes; under host
  offload ``host_resident_argument_bytes`` is the host state's bytes (the
  reference's ``tests/test_stream_layers.py:176-182``).
- ``aot_lower`` of a materialized trainer leaves everything real
  bit-equal: parameters, optimizer state, ``_global_step``, the LR
  scheduler, the RNG and the profiler's counters.
- The card's route takes the flash wrappers' shape rules: no
  ``[B, H, S, S]`` tensor and no kernel build. This CPU build of torch
  cannot run autograd over fake CUDA tensors (its autograd asks the CUDA
  device guard for a stream and aborts), so the attention entry and the
  backward wrappers run on fake CUDA tensors without autograd, and the
  whole step is planned on the ``meta`` route, which takes the same shape
  rules; the CPU route's plan holds the plain version's scores.
- Doubling the batch raises the temps and leaves the arguments; a MoE
  GPT plans at ep 2."""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.distributed import mesh as M
from paddle_tpu_torch.distributed import plan as P
from paddle_tpu_torch.distributed.env import plan_world
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.distributed.hybrid import HybridPipelineTrainer
from paddle_tpu_torch.framework.lazy import LazyGuard, is_abstract
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.optimizer import AdamW, lr
from paddle_tpu_torch.profiler import instrument

_spec_oracle = importlib.util.spec_from_file_location(
    "torch_hybrid_oracle", os.path.join(os.path.dirname(__file__), "data",
                                        "torch_hybrid_oracle.py"))
oracle = importlib.util.module_from_spec(_spec_oracle)
_spec_oracle.loader.exec_module(oracle)

CASES = [dict(name="dp2z2", mesh={"dp": 2}, zero=2),
         dict(name="tp2", mesh={"dp": 1, "tp": 2}),
         dict(name="pp2", mesh={"dp": 1, "pp": 2})]
SMALL = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
             max_seq_len=256)


def _spec(b, s):
    return torch.empty(b, s, dtype=torch.int64, device="meta")


def _trainer(model, mesh=None, zero=0, clip=oracle.CLIP, sched=None, **kw):
    opt = AdamW(sched or oracle.LR, parameters=model.named_parameters(),
                weight_decay=0.01,
                grad_clip=tnn.ClipGradByGlobalNorm(clip) if clip else None)
    s = DistributedStrategy()
    s.amp, s.recompute = kw.pop("amp", False), kw.pop("recompute", False)
    if zero:
        s.sharding = True
        s.sharding_configs = {"sharding_stage": zero}
    return HybridPipelineTrainer(model, opt, s, mesh, **kw)


def _lazy_gpt(cfg, device="cpu"):
    with LazyGuard():
        return tgpt.GPT(tgpt.GPTConfig(**cfg), device=device)


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    _, state = oracle.ref_state()
    return oracle.run_job(tmp_path_factory.mktemp("plan_gloo"), "hybrid", 2,
                          oracle.inputs(state, cases=json.dumps(CASES)))


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_planned_collectives_equal_a_real_gloo_step(gloo, case):
    for rank, (_, values) in enumerate(gloo):
        with plan_world(2, rank):
            mesh = M.init_mesh(case["mesh"])
            tr = _trainer(_lazy_gpt(oracle.CFG), mesh, case.get("zero", 0))
            low = tr.aot_lower(_spec(oracle.B, oracle.S))
        got, want = low.collective_stats(), values[f"{case['name']}.stats"]
        assert want["total_bytes"] > 0
        for key in ("ops", "bytes", "bytes_by_kind_dtype", "total_bytes"):
            assert got[key] == want[key], (rank, key, got[key], want[key])
        # the plan's program names each c10d op's group
        groups = [g for _, _, g in low.ops if g is not None]
        assert groups and all(sorted(g) == [0, 1] for g in groups)


def test_record_collectives_from_a_plan():
    with plan_world(2, 0):
        mesh = M.init_mesh({"dp": 1, "tp": 2})
        low = _trainer(_lazy_gpt(oracle.CFG), mesh).aot_lower(
            _spec(oracle.B, oracle.S))
    st = instrument.record_collectives_from(low, mesh, prefix="plan")
    assert st == low.collective_stats() and st["total_bytes"] > 0
    assert tprof.registry().gauge("plan/collective_bytes_per_step").value \
        == st["total_bytes"]


def _snapshot(tr):
    upd = tr._upd
    return {"params": {n: p.detach().clone()
                       for n, p in tr.model.named_parameters()},
            "states": [{k: v.clone() for k, v in st.items()}
                       for st in upd.states],
            "grads": [t.grad for t in upd.leaves()],
            "global_step": tr.optimizer._global_step, "step": tr._step,
            "lr": tr.optimizer._learning_rate.state_dict(),
            "port_rng": trng.get_rng_state(),
            "torch_rng": torch.get_rng_state(),
            "registry": tprof.registry().snapshot(),
            "aux": {n: (m.aux_loss, dict(m.last_route))
                    for n, m in tr.model.named_modules()
                    if hasattr(m, "aux_loss")}}


def _assert_same(a, b):
    for n, t in a["params"].items():
        assert torch.equal(t, b["params"][n]), n
    for sa, sb in zip(a["states"], b["states"]):
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    assert all(g is None for g in b["grads"])
    for k in ("global_step", "step", "lr", "port_rng", "registry"):
        assert a[k] == b[k], k
    assert torch.equal(a["torch_rng"], b["torch_rng"])
    for n, (aux, route) in a["aux"].items():
        aux2, route2 = b["aux"][n]
        assert aux2 is aux and route2.keys() == route.keys(), n
        assert all(route2[k] is route[k] for k in route), n


@pytest.mark.parametrize("extra", [{}, {"moe_num_experts": 4,
                                        "moe_top_k": 2}],
                         ids=["dense", "moe"])
def test_aot_lower_leaves_real_state_bit_equal(extra):
    pt.seed(5)
    model = tgpt.GPT(tgpt.GPTConfig(**SMALL, dropout=0.1, **extra),
                     device="cpu")
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-3, T_max=100),
                            warmup_steps=3, start_lr=1e-5, end_lr=1e-3)
    tr = _trainer(model, sched=sched, amp=True, recompute=True,
                  param_dtype="bfloat16", moment_dtype="bfloat16",
                  n_micro=2)
    tok = torch.randint(0, SMALL["vocab_size"], (4, 256),
                        generator=torch.Generator().manual_seed(0))
    tr.step(tok)
    sched.step()
    tprof.enable(reset=False)
    try:
        before = _snapshot(tr)
        with instrument.count_collectives() as outer:
            low = tr.aot_lower(tok)
        after = _snapshot(tr)
    finally:
        tprof.disable()
    assert outer.notes == []
    _assert_same(before, after)
    assert len(low.ops) > 100 and not any(
        is_abstract(p) for p in tr.model.parameters())
    # a real step still runs after it, from the same state
    assert np.isfinite(float(tr.step(tok)))


def test_arguments_equal_the_ledger_and_batch_scales_temps():
    pt.seed(5)
    tr = _trainer(tgpt.GPT(tgpt.GPTConfig(**SMALL), device="cpu"),
                  amp=True, recompute=True, n_micro=2,
                  param_dtype="bfloat16", moment_dtype="bfloat16")
    led = tr.memory_ledger()
    one = tr.memory_analysis(_spec(4, 256))
    two = tr.memory_analysis(_spec(8, 256))
    assert one["argument_size_in_bytes"] == led["param"] + \
        led["opt_state"]
    assert two["argument_size_in_bytes"] == one["argument_size_in_bytes"]
    assert two["temp_size_in_bytes"] > one["temp_size_in_bytes"]
    for ma in (one, two):
        assert ma["alias_size_in_bytes"] == 0
        assert ma["peak_bytes_est"] == ma["argument_size_in_bytes"] - \
            ma["alias_size_in_bytes"] + ma["temp_size_in_bytes"]
        assert ma["output_size_in_bytes"] >= ma["argument_size_in_bytes"]
    c = tr.aot_compile(_spec(4, 256))
    assert 0 < c.update_peak_bytes < c.fwd_bwd_peak_bytes <= \
        one["peak_bytes_est"]


def test_offload_host_resident_arguments():
    pt.seed(5)
    tr = _trainer(tgpt.GPT(tgpt.GPTConfig(**SMALL), device="cpu"),
                  amp=True, n_micro=2, moment_dtype="bfloat16",
                  offload_params=True, offload_optimizer=True,
                  stream_layers=True)
    host = tr._upd.host_state()
    want = sum(t.numel() * t.element_size() for t in host)
    ma = tr.memory_analysis(_spec(4, 256))
    led = tr.memory_ledger()
    assert ma["host_resident_argument_bytes"] == want > 0
    assert want == led["host_opt_state"] + led["host_master"]
    assert ma["hbm_argument_bytes"] == ma["argument_size_in_bytes"] - want \
        == led["param"]
    assert ma["hbm_peak_bytes_est"] == ma["peak_bytes_est"] - want


def _scores(low, s):
    return [op for op, outs, _ in low.ops
            if any(len(shape) == 4 and shape[-2:] == (s, s)
                   for shape, _, _ in outs)]


def test_card_route_takes_the_shape_rules(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a plan built a kernel")

    monkeypatch.setattr(_build, "load", no_build)
    launches = {k: getattr(fa, k) for k in fa.__all__
                if k.endswith("LAUNCHES")}
    # fake CUDA tensors through the attention entry and the backward
    # kernels' wrappers (both routes): their outputs only
    from torch._subclasses.fake_tensor import FakeTensorMode
    from paddle_tpu_torch.nn import functional as F

    rec = P._Recorder(torch.device("cuda"))
    for dt, d in ((torch.bfloat16, 64), (torch.float32, 16)):
        with FakeTensorMode(), rec:
            q, k, v = (torch.empty(2, 256, 4, d, dtype=dt, device="cuda")
                       for _ in range(3))
            o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            _, lse = fa.flash_attention(q, k, v, causal=True)
            dq, dk, dv = fa._bwd(0.125, True, 128, 128, (q, k, v, o, lse), o)
        assert o.shape == dq.shape == dk.shape == q.shape
        assert dq.device.type == "cuda"
    assert not _scores(P.Lowered(rec, [], {}, None, 0.0), 256)
    # the whole step on the meta route: the same shape rules, with autograd
    card = _trainer(_lazy_gpt(SMALL, device="meta"), amp=True,
                    recompute=True, n_micro=2, param_dtype="bfloat16")
    low = card.aot_lower(_spec(4, 256))
    assert not _scores(low, 256)
    assert {k: getattr(fa, k) for k in launches} == launches
    # the CPU route's plain version holds the [B, H, S, S] scores
    cpu = _trainer(_lazy_gpt(SMALL), amp=True, recompute=True, n_micro=2,
                   param_dtype="bfloat16")
    low_cpu = cpu.aot_lower(_spec(4, 256))
    assert _scores(low_cpu, 256)
    assert low.compile().peak_bytes < low_cpu.compile().peak_bytes


def test_moe_gpt_plans_at_ep2():
    cfg = dict(oracle.CFG, moe_num_experts=4, moe_top_k=2,
               moe_capacity_factor=1.25, moe_aux_weight=0.01)
    for rank in range(2):
        with plan_world(2, rank):
            mesh = M.init_mesh({"dp": 1, "ep": 2})
            tr = _trainer(_lazy_gpt(cfg), mesh, n_micro=2)
            ma = tr.memory_analysis(_spec(oracle.B, oracle.S))
            led = tr.memory_ledger()
        assert ma["argument_size_in_bytes"] == led["param"] + \
            led["opt_state"]
        assert ma["temp_size_in_bytes"] > 0
