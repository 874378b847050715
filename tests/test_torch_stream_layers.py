"""Host offload and ``stream_layers`` in the port's
``HybridPipelineTrainer`` (``distributed/offload.py``) held against the
JAX trainer with the same knobs (the oracle: ``tests/test_stream_layers
.py``; the JAX side with ``PADDLE_TPU_FAKE_PINNED_HOST=1``, as there).

- Parity: the offloaded masters and moments streamed per layer against
  the JAX trainer's same run: losses at atol 5e-3
  (the oracle's own bound between these variants: both sides compute
  under amp in bf16 and sum in other orders) over 3 steps; pp 2 on two
  gloo ranks (the stage's own layers streamed) against the JAX trainer
  at pp 2, its first loss at the oracle's 2e-2.
- Placement does not change the math: within the port, the whole-group
  and the per-layer schedule, the offloaded and resident moments,
  ``comp_resident=False`` (accepted: the port's compute copies always
  stay on the card), and ``conservative_fetch`` against the free
  schedule give the same losses bit for bit (the same update on the
  same values, in the same order; the oracle holds them within 5e-3).
  ``offload_optimizer`` alone equals the resident run bit for bit.
- State: ``sync_to_layer`` gives whole f32 parameters, and
  ``device_state`` restored into a fresh trainer resumes exactly.
- ``memory_ledger`` (in place of the oracle's ``memory_analysis``, which
  is ROADMAP queue 1 item 7e): the host's bytes apart from the device's,
  whose moments and masters fall to ``offload_depth`` layers' worth.
- Validation: ``stream_layers`` needs an offload knob and ``v_virtual``
  1, ``offload_params`` needs amp, int8 gradients refuse
  ``offload_params``, and ``guard_bad_steps`` refuses ``offload_params``
  and ``stream_layers`` with the reference's ``ValueError``.
"""
import functools
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

_spec = importlib.util.spec_from_file_location(
    "torch_hybrid_oracle", os.path.join(os.path.dirname(__file__), "data",
                                        "torch_hybrid_oracle.py"))
oracle = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(oracle)

CFG = dict(vocab_size=128, hidden_size=64, num_layers=4, num_heads=4,
           max_seq_len=32)
LR = 5e-3
OFF = dict(offload_params=True, offload_optimizer=True,
           moment_dtype="bfloat16")
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads for this module's in-process trainers: the
    suite runs several workers on few cores, where torch's default (one
    thread a core) oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _toks(b=8, s=32, seed=0):
    return np.random.RandomState(seed).randint(0, 128, (b, s)) \
        .astype(np.int64)


@functools.lru_cache(maxsize=None)
def _state():
    return oracle.ref_state(11, CFG)[1]


@functools.lru_cache(maxsize=None)
def _jax_losses(stream, pp=1):
    """The JAX trainer's losses with the offload knobs (fake pinned host,
    as its own tests run it)."""
    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet import DistributedStrategy
    from paddle_tpu.distributed.hybrid import HybridPipelineTrainer

    os.environ["PADDLE_TPU_FAKE_PINNED_HOST"] = "1"
    try:
        net, _ = oracle.ref_state(11, CFG)
        opt = paddle.optimizer.AdamW(LR, parameters=net.parameters())
        s = DistributedStrategy()
        s.amp, s.recompute = True, True
        s.hybrid_configs = {"pp_degree": pp}
        s.pipeline = pp > 1
        tr = HybridPipelineTrainer(
            net, opt, s, oracle.jax_mesh({"dp": 1, "pp": pp}), n_micro=2,
            stream_layers=stream, **OFF)
        toks = _toks().astype(np.int32)
        return tuple(float(tr.step(toks)) for _ in range(STEPS))
    finally:
        os.environ.pop("PADDLE_TPU_FAKE_PINNED_HOST", None)


def _make(**kw):
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.hybrid import HybridPipelineTrainer
    from paddle_tpu_torch.models import gpt as tgpt
    from paddle_tpu_torch.optimizer import AdamW

    net = tgpt.GPT(tgpt.GPTConfig(**CFG), device="cpu")
    tgpt.load_reference_state(net, _state())
    opt = AdamW(LR, parameters=net.named_parameters())
    s = DistributedStrategy()
    s.amp, s.recompute = True, True
    return HybridPipelineTrainer(net, opt, s, n_micro=2, **kw)


def _run(tr, n=STEPS):
    toks = torch.from_numpy(_toks())
    return [float(tr.step(toks)) for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _cached(**kw):
    """The port's losses with knobs ``kw`` (each run once a module)."""
    return tuple(_run(_make(**kw)))


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------
def test_offload_matches_reference():
    got = _cached(stream_layers=True, **OFF)
    want = _jax_losses(True)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)
    assert got[-1] < got[0]


@pytest.mark.parametrize("variant", [
    dict(stream_layers=False),
    dict(offload_optimizer=False),
    dict(comp_resident=False),
    dict(conservative_fetch=True),
    dict(offload_depth=1)])
def test_placement_does_not_change_the_math(variant):
    base = _cached(stream_layers=True, **OFF)
    kw = dict(OFF, stream_layers=True)
    kw.update(variant)
    assert _cached(**kw) == base


def test_optimizer_offload_alone_is_the_resident_run():
    resident = _cached(moment_dtype="bfloat16")
    assert _cached(offload_optimizer=True, moment_dtype="bfloat16") == \
        resident
    assert _cached(offload_optimizer=True, stream_layers=True,
                   moment_dtype="bfloat16") == resident


def test_optimizer_only_stream_trains():
    losses = _cached(offload_optimizer=True, param_dtype="bfloat16",
                     moment_dtype="bfloat16", stream_layers=True)
    assert all(np.isfinite(v) for v in losses) and losses[-1] < losses[0]


@pytest.fixture(scope="module")
def pp2(tmp_path_factory):
    case = dict(name="pp2", mesh={"pp": 2}, amp=True, recompute=True,
                n_micro=2, clip=None, stream_layers=True, **OFF)
    inp = oracle.inputs(_state(), cfg=CFG, cases=json.dumps([case]),
                        lr=LR, steps_tok=np.stack([_toks()] * STEPS))
    res = oracle.run_job(tmp_path_factory.mktemp("stream_pp2"), "hybrid",
                         2, inp)
    oracle.foreign_free(res)
    return res


def test_stream_under_pp2(pp2):
    """Each stage streams its own layers; the first loss is the JAX pp-2
    stream's within the oracle's 2e-2, and the run is the port's pp-1
    stream's (the same arithmetic but the pipeline's sums over pp)
    within 5e-3."""
    want = _jax_losses(True, pp=2)
    one = _cached(stream_layers=True, **OFF)
    for _, v in pp2:
        got = v["pp2.losses"]
        assert abs(got[0] - want[0]) < 2e-2, (got, want)
        np.testing.assert_allclose(got, one, rtol=0, atol=5e-3)
        assert all(np.isfinite(x) for x in got)


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------
def test_sync_to_layer_restores_whole_parameters():
    tr = _make(stream_layers=True, **OFF)
    _run(tr, 2)
    model = tr.sync_to_layer()
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32, n
        assert torch.equal(p.data, tr._upd.master[tr._index[n]]), n
    # the trainer goes on from there: its compute copies come back
    tr.step(torch.from_numpy(_toks()))
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())


def test_device_state_roundtrip_resume_exact(tmp_path):
    from paddle_tpu_torch.distributed import checkpoint as dck

    toks = torch.from_numpy(_toks())
    tr = _make(stream_layers=True, **OFF)
    _run(tr, 3)
    dck.save(str(tmp_path), tr.device_state(), step=3, async_=False)
    expect = float(tr.step(toks))
    tr2 = _make(stream_layers=True, **OFF)
    tr2.load_device_state(dck.restore(str(tmp_path), tr2.device_state()),
                          step=3)
    assert float(tr2.step(toks)) == expect


def test_memory_ledger_counts_host_state_apart():
    led_res = _make().memory_ledger()
    tr = _make(stream_layers=True, offload_depth=2, **OFF)
    _run(tr, 1)
    led = tr.memory_ledger()
    n = sum(p.numel() for p in tr.model.parameters())
    # the host holds every f32 master and bf16 moment
    assert led["host_master"] == 4 * n
    assert led["host_opt_state"] == 2 * 2 * n
    # the device: bf16 compute copies and gradients, and at most two
    # groups of the stream's masters and moments (a layer, or the
    # largest non-block parameter)
    assert led["param"] == 2 * n and led["grad"] == 2 * n
    groups = [sum(tr._upd.params[i].numel() for i in g)
              for g in tr._upd.groups]
    window = max(a + b for a, b in zip(groups, groups[1:]))
    assert led["master"] == 4 * window
    assert led["opt_state"] == 2 * 2 * window
    assert led["opt_state"] < led_res["opt_state"] / 4


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------
def test_validation():
    with pytest.raises(ValueError, match="stream_layers"):
        _make(stream_layers=True)
    with pytest.raises(ValueError, match="v_virtual"):
        _make(stream_layers=True, v_virtual=2, **OFF)
    with pytest.raises(NotImplementedError, match="offload_params"):
        _make(offload_params=True, dp_grad_comm="int8")
    # the guard composes with offload_optimizer alone (ROADMAP queue 1
    # item 8b); with offload_params or stream_layers it raises, as the
    # reference's does
    assert _make(offload_optimizer=True, guard_bad_steps=True) \
        .guard_bad_steps
    with pytest.raises(ValueError, match="guard_bad_steps"):
        _make(guard_bad_steps=True, **OFF)
    with pytest.raises(ValueError, match="guard_bad_steps"):
        _make(offload_optimizer=True, stream_layers=True,
              guard_bad_steps=True)

    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.hybrid import HybridPipelineTrainer
    from paddle_tpu_torch.models import gpt as tgpt
    from paddle_tpu_torch.optimizer import AdamW

    net = tgpt.GPT(tgpt.GPTConfig(**CFG), device="cpu")
    with pytest.raises(ValueError, match="amp"):
        HybridPipelineTrainer(net, AdamW(LR, parameters=net.parameters()),
                              DistributedStrategy(), offload_params=True)
