"""HybridPipelineTrainer's profiling held against the JAX package's:
``profile_step_phases``, ``memory_ledger`` and the profiled step's
counters.

- The counterpart of test_profiler.py::test_phase_decomposition_and_
  induced_retrace: the phases, the ``hybrid.step`` program in the
  inventory (``compile_ms > 0``), then a changed batch shape retraces
  exactly once.
- ``profile_step_phases(trace_window=2)``: a parsed CPU trace whose
  ``hybrid.step`` row has two executions.
- ``memory_ledger()`` equals the JAX trainer's for the same model,
  optimizer and storage dtypes, category by category.
- The profiled step's ``train/tokens`` is ``tokens_in_batch``; on the CPU
  ``record_memory_high_water()`` returns None and sets no gauge, as the
  reference's does there.
"""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
import paddle_tpu.profiler as jprof
from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy
from paddle_tpu.distributed.hybrid import HybridPipelineTrainer as JTrainer
from paddle_tpu.distributed.strategy_compiler import build_mesh_from_strategy
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.distributed.hybrid import HybridPipelineTrainer
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.optimizer import AdamW

CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=32)


@pytest.fixture(autouse=True)
def _clean():
    for p in (tprof, jprof):
        if p.is_enabled():
            p.disable()
        p.reset()
    yield
    for p in (tprof, jprof):
        if p.is_enabled():
            p.disable()
        p.reset()


def _tokens():
    return np.random.RandomState(0).randint(0, 128, (4, 32)).astype(
        np.int32)


def _tiny_trainer(**kw):
    torch.manual_seed(11)
    net = tgpt.GPT(tgpt.GPTConfig(**CFG), device="cpu")
    opt = AdamW(1e-3, parameters=net.named_parameters())
    tr = HybridPipelineTrainer(net, opt, DistributedStrategy(), n_micro=1,
                               **kw)
    return tr, torch.from_numpy(_tokens())


def test_phase_decomposition_and_induced_retrace():
    tr, toks = _tiny_trainer()
    tprof.enable()
    tr.step(toks)
    phases = tr.profile_step_phases(toks, iters=1)
    for k in ("fwd_ms", "bwd_ms", "optim_ms", "comm_ms", "step_ms"):
        assert k in phases and phases[k] >= 0, phases
    assert phases["comm_ms"] == 0.0 and phases["fwd_ms"] > 0
    s = tprof.summary()
    assert {"fwd_ms", "bwd_ms", "optim_ms", "comm_ms"} <= \
        set(s["phases_ms"])
    assert s["rates"]["tokens_per_sec"] > 0
    (site,) = [k for k in s["programs"] if k.startswith("hybrid.step")]
    assert site == tr._prof_site
    assert s["programs"][site]["compile_ms"] > 0
    assert s["programs"][site]["flops"] > 0
    assert s["retraces"] == []
    tr.step(toks[:, :16])
    s = tprof.summary()
    assert len(s["retraces"]) == 1
    assert s["metrics"]["profiler/retraces"]["value"] == 1.0
    (ev,) = s["retraces"]
    assert ev["changed"]


def test_trace_window_rows_read_per_step():
    tr, toks = _tiny_trainer()
    out = tr.profile_step_phases(toks, iters=1, trace_window=2)
    s = out["trace"]
    assert s["label"] == tr._prof_site and s["steps"] == 2
    row = s["sites"][tr._prof_site]
    assert row["executions"] == 2 and row["executions_source"] == \
        "steps_hint"
    assert row["flops_per_exec"] == tprof.program_inventory()[
        tr._prof_site]["flops"]
    assert s["categories"]["matmul"]["count"] > 0
    assert 0.0 <= s["busy_frac"] <= 1.0
    assert tprof.last_trace_summary() is s


def _jax_ledger(**kw):
    paddle.seed(11)
    jnet = jgpt.GPT(jgpt.GPTConfig(**CFG))
    opt = paddle.optimizer.AdamW(1e-3, parameters=jnet.parameters())
    s = JStrategy()
    mesh = build_mesh_from_strategy(s, jax.devices()[:1])
    return JTrainer(jnet, opt, s, mesh, n_micro=1, **kw).memory_ledger()


@pytest.mark.parametrize("dtypes", [{}, dict(param_dtype="bfloat16",
                                             moment_dtype="bfloat16")])
def test_memory_ledger_equals_reference(dtypes):
    want = _jax_ledger(**dtypes)
    tr, _ = _tiny_trainer(**dtypes)
    got = tr.memory_ledger()
    assert got == want
    assert set(got) == {"param", "grad", "opt_state"}
    snap = tprof.registry().snapshot()
    for k, v in got.items():
        assert snap[f"mem/{k}_bytes"]["value"] == v


def test_profiled_step_counts_tokens_and_no_cpu_memory():
    tr, toks = _tiny_trainer()
    tprof.enable()
    tr.step(toks)
    snap = tprof.registry().snapshot()
    assert snap["train/tokens"]["value"] == \
        tprof.tokens_in_batch((toks,)) == 4 * 32
    assert tprof.tokens_in_batch((toks.float(),)) == 4
    assert tprof.device_memory_stats("cpu") is None
    assert tprof.record_memory_high_water() is None
    assert not any(k.startswith("memory/") for k in snap)
