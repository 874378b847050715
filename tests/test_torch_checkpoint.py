"""The port's ``distributed/checkpoint.py``, the trainers'
``device_state``/``load_device_state`` and ``Fleet.save_persistables``,
held against the JAX package's (the oracle: ``tests/test_checkpoint.py``
and the sharded save, restore and walk-back cases of
``tests/test_zero_shard.py``).

- The six cases of ``tests/test_checkpoint.py``: the sharded pieces of
  two gloo ranks (CPU) saved and restored whole, restored at another cut
  (a change of topology), an uncommitted step ignored, a flipped byte
  caught by the crc, retention, and a trainer resumed from a checkpoint
  that continues as the JAX trainer's uninterrupted run (losses at rtol
  1e-5, the hybrid tests' f32 bound: the two packages sum in other
  orders).
- The on-disk layout is the reference's: a step the JAX package wrote
  reads in the port and the reverse, bf16 leaves included (bit for bit).
- Sharded trainer state: saved at ``{"dp": 2}`` ZeRO 2 (each rank's
  flat range of the slab) and at ``{"tp": 2}`` (GPT's qkv in its ``[3,
  H, D]`` view), restored into a degree-1 trainer: parameters and first
  moments bit-equal to the gathered ones.
- The walk-back of ``tests/test_zero_shard.py``: a resume restores the
  saved state bit for bit, a corrupt newest step falls back to the
  older one (a warning and ``resilience/restore_fallbacks``), and
  ``max_step`` caps the target.
- ``save_persistables``: the trainer branch (a sharded sync save) and
  the eager branch (rank 0 writes ``persistables.pdparams``, which the
  reference's ``framework.io.load`` reads).

The guard and ``ResilientRunner`` cases of ``tests/test_zero_shard.py``
and ``tests/test_async_pipeline.py`` wait for ROADMAP queue 1 item 8.
"""
import importlib.util
import json
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu_torch.distributed import checkpoint as dck

_spec = importlib.util.spec_from_file_location(
    "torch_hybrid_oracle", os.path.join(os.path.dirname(__file__), "data",
                                        "torch_hybrid_oracle.py"))
oracle = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(oracle)

W = np.arange(64, dtype=np.float32).reshape(8, 8)
B = (np.arange(8, dtype=np.float32) * 0.37).astype(np.float32)
CASES = [dict(name="z2", mesh={"dp": 2}, zero=2, ckpt=True),
         dict(name="tp2", mesh={"dp": 1, "tp": 2}, ckpt=True)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads for this module's in-process trainers: the
    suite runs several workers on few cores, where torch's default (one
    thread a core) oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    _, state = oracle.ref_state()
    res = oracle.run_job(d, "ckpt", 2, oracle.inputs(
        state, w=W, b=B, cases=json.dumps(CASES)))
    oracle.foreign_free(res)
    return str(d), res


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# the six cases of tests/test_checkpoint.py
# ---------------------------------------------------------------------------
def test_save_restore_sharded_roundtrip(job):
    d, res = job
    plain = os.path.join(d, "ckpt_plain")
    assert dck.load_meta(plain, 3) == {"k": 1}
    for arrays, values in res:
        assert values["steps"] == [3, 4]
        np.testing.assert_array_equal(arrays["w3"], W)
        np.testing.assert_array_equal(arrays["b3"],
                                      _bf16(B).float().numpy())
    # the snapshot_async save took the values before the change that
    # followed wait_snapshot (the in-place update after a save)
    for r, (arrays, values) in enumerate(res):
        np.testing.assert_array_equal(arrays["w4_own"], W[4 * r:4 * r + 4])
        assert values["w4_index"] == [[4 * r, 4 * r + 4], [0, 8]]


def test_restore_to_different_sharding(job):
    plain = os.path.join(job[0], "ckpt_plain")
    for c in range(4):          # column blocks: another cut of the rows
        t = dck.Sharded(torch.zeros(8, 2), (8, 8), [[0, 8], [2 * c,
                                                             2 * c + 2]])
        out = dck.restore(plain, {"w": t}, step=3)
        np.testing.assert_array_equal(out["w"].data.numpy(),
                                      W[:, 2 * c:2 * c + 2])
        assert out["w"].index == t.index


class _OnCard1(torch.Tensor):
    """A host tensor that says it lies on card 1 (no card here)."""

    @property
    def device(self):
        return torch.device("cuda", 1)


@pytest.mark.parametrize("snapshot_async", [False, True])
def test_save_copies_on_the_pieces_card(tmp_path, monkeypatch,
                                        snapshot_async):
    """A rank on card 1: the sync save waits for card 1, and the streamed
    snapshot's writer thread (whose current device starts at card 0)
    copies under card 1 on a side stream of card 1, after an event on
    card 1's current stream. torch.cuda is faked (thread-local current
    device and stream); the values must still come back."""
    import threading

    seen = {"copies": [], "sync": [], "ready": []}
    local = threading.local()

    class Stream:
        def __init__(self, device=None):
            self.device = device

        def wait_event(self, ev):
            seen["ready"].append((self.device, ev.on))

        def synchronize(self):
            pass

    class Event:
        on = None

        def record(self, stream=None):
            self.on = None if stream is None else stream.device

    class _Ctx:
        def __init__(self, attr, value):
            self.attr, self.value = attr, value

        def __enter__(self):
            self.prev = getattr(local, self.attr, None)
            setattr(local, self.attr, self.value)

        def __exit__(self, *exc):
            setattr(local, self.attr, self.prev)

    def to_host(t):
        stream = getattr(local, "stream", None)
        seen["copies"].append((getattr(local, "device", None),
                               None if stream is None else stream.device,
                               t.device))
        return t.as_subclass(torch.Tensor).clone()

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream(device))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: _Ctx("device", torch.device(d)))
    monkeypatch.setattr(torch.cuda, "stream", lambda s: _Ctx("stream", s))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: seen["sync"].append(device))
    monkeypatch.setattr(dck, "_to_host", to_host)
    card = torch.device("cuda", 1)
    x = torch.arange(24, dtype=torch.float32).as_subclass(_OnCard1)
    h = dck.save(str(tmp_path), {"x": x}, step=1,
                 snapshot_async=snapshot_async)
    h.wait()
    if snapshot_async:
        assert seen["copies"] == [(card, card, card)]
        assert seen["ready"] == [(card, card)]
        assert seen["sync"] == []
    else:
        assert seen["sync"] == [card]
    out = dck.restore(str(tmp_path), {"x": torch.zeros(24)})
    np.testing.assert_array_equal(out["x"].numpy(), np.arange(24))


def test_save_refuses_pieces_on_two_cards(tmp_path):
    class _OnCard0(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    a = torch.zeros(4).as_subclass(_OnCard0)
    b = torch.zeros(4).as_subclass(_OnCard1)
    with pytest.raises(ValueError, match="2 cards"):
        dck.save(str(tmp_path), {"a": a, "b": b}, step=1,
                 snapshot_async=True)


def test_uncommitted_checkpoint_ignored(tmp_path):
    x = torch.ones(8)
    dck.save(str(tmp_path), {"x": x}, step=1).wait()
    dck.save(str(tmp_path), {"x": x * 2}, step=2).wait()
    os.makedirs(tmp_path / "step_00000003", exist_ok=True)
    assert dck.latest_step(str(tmp_path)) == 2
    out = dck.restore(str(tmp_path), {"x": x})
    np.testing.assert_array_equal(out["x"].numpy(), 2 * np.ones(8))


def test_corruption_detected(tmp_path):
    x = torch.arange(256, dtype=torch.float32)
    dck.save(str(tmp_path), {"x": x}, step=1).wait()
    shard = tmp_path / "step_00000001" / "shard_p0.bin"
    raw = bytearray(shard.read_bytes())
    raw[10] ^= 0xFF
    shard.write_bytes(bytes(raw))
    with pytest.raises(IOError):
        dck.restore(str(tmp_path), {"x": x}, verify=True)


def test_manager_retention_and_latest(tmp_path):
    x = torch.ones(8)
    with dck.CheckpointManager(str(tmp_path), keep=2) as mgr:
        for s in (1, 2, 3, 4):
            mgr.save(s, {"x": x * s}, meta={"step": s})
    assert dck.all_steps(str(tmp_path)) == [3, 4]
    state, meta = dck.CheckpointManager(str(tmp_path)).restore_latest(
        {"x": x})
    assert meta["step"] == 4
    np.testing.assert_array_equal(state["x"].numpy(), 4 * np.ones(8))


def _port_trainer(state, zero=0, **kw):
    """The port's GPTHybridTrainer at degree 1 on gpt_tiny from the
    reference's weights (AdamW, the global-norm clip), in this
    process."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.hybrid_gpt import GPTHybridTrainer
    from paddle_tpu_torch.models import gpt as tgpt
    from paddle_tpu_torch.optimizer import AdamW

    net = tgpt.GPT(tgpt.GPTConfig(**oracle.CFG), device="cpu")
    tgpt.load_reference_state(net, state)
    opt = AdamW(oracle.LR, parameters=net.named_parameters(),
                weight_decay=0.01,
                grad_clip=tnn.ClipGradByGlobalNorm(oracle.CLIP))
    s = DistributedStrategy()
    if zero:
        s.sharding = True
        s.sharding_configs = {"sharding_stage": zero}
    return GPTHybridTrainer(net, opt, s, **kw)


def test_trainer_resume_continues_the_reference_run(tmp_path):
    """3 steps, a sync save, a fresh trainer restored from it, 3 more:
    the 6 losses are the JAX trainer's uninterrupted run's."""
    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet import DistributedStrategy
    from paddle_tpu.distributed.hybrid_gpt import GPTHybridTrainer

    toks = oracle.tokens(n=6)
    net, state = oracle.ref_state()
    opt = paddle.optimizer.AdamW(
        oracle.LR, parameters=net.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(oracle.CLIP))
    ref = GPTHybridTrainer(net, opt, DistributedStrategy(),
                           oracle.jax_mesh({"dp": 1}))
    want = [float(ref.step(t)) for t in toks]

    t1 = _port_trainer(state)
    got = [float(t1.step(torch.from_numpy(t).long())) for t in toks[:3]]
    dck.save(str(tmp_path), t1.device_state(), step=3, meta={"step": 3},
             async_=False)
    t2 = _port_trainer(state)
    t2.load_device_state(dck.restore(str(tmp_path), t2.device_state()),
                         step=3)
    assert t2._step == 3 and t2.optimizer._global_step == 3
    got += [float(t2.step(torch.from_numpy(t).long())) for t in toks[3:]]
    np.testing.assert_allclose(got, want, rtol=oracle.LOSS_RTOL)


# ---------------------------------------------------------------------------
# the reference's layout, both ways
# ---------------------------------------------------------------------------
def test_reference_step_reads_in_the_port(tmp_path):
    mesh = oracle.jax_mesh({"dp": 2, "tp": 4})
    xs = jax.device_put(jnp.asarray(W), NamedSharding(mesh, JP("dp", "tp")))
    ys = jax.device_put(jnp.asarray(B).astype(jnp.bfloat16),
                        NamedSharding(mesh, JP("tp")))
    jck.save(str(tmp_path), {"w": xs, "nested": {"b": ys}}, step=5,
             meta={"k": 2}).wait()
    tmpl = {"w": torch.zeros(8, 8),
            "nested": {"b": torch.zeros(8, dtype=torch.bfloat16)}}
    out = dck.restore(str(tmp_path), tmpl, verify=True)
    np.testing.assert_array_equal(out["w"].numpy(), W)
    assert out["nested"]["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["nested"]["b"].float().numpy(),
                                  np.asarray(ys.astype(jnp.float32)))
    # one tp column block of it, as a rank of the port would read it
    piece = dck.Sharded(torch.zeros(4, 2), (8, 8), [[4, 8], [2, 4]])
    got = dck.restore(str(tmp_path), {"w": piece})["w"].data.numpy()
    np.testing.assert_array_equal(got, W[4:8, 2:4])
    assert dck.load_meta(str(tmp_path), 5) == {"k": 2}


def test_port_step_reads_in_the_reference(tmp_path):
    dck.save(str(tmp_path), {"w": torch.from_numpy(W),
                             "nested": {"b": _bf16(B)}}, step=7,
             meta={"k": 3}).wait()
    assert jck.all_steps(str(tmp_path)) == [7]
    mesh = oracle.jax_mesh({"dp": 2, "tp": 4})
    tmpl = {"w": jax.ShapeDtypeStruct(
        (8, 8), jnp.float32, sharding=NamedSharding(mesh, JP("dp", "tp"))),
        "nested": {"b": jax.ShapeDtypeStruct(
            (8,), jnp.bfloat16, sharding=NamedSharding(mesh, JP("tp")))}}
    out = jck.restore(str(tmp_path), tmpl, verify=True)
    np.testing.assert_array_equal(np.asarray(out["w"]), W)
    np.testing.assert_array_equal(
        np.asarray(out["nested"]["b"].astype(jnp.float32)),
        _bf16(B).float().numpy())
    assert jck.load_meta(str(tmp_path), 7) == {"k": 3}


# ---------------------------------------------------------------------------
# sharded trainer state, restored at degree 1
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["z2", "tp2"])
def test_sharded_trainer_state_restores_at_degree_1(job, name):
    d, res = job
    arrays = res[0][0]
    _, state = oracle.ref_state()
    tr = _port_trainer(state)
    st = dck.restore(os.path.join(d, "ckpt", name), tr.device_state(),
                     verify=True)
    tr.load_device_state(st, step=oracle.STEPS)
    params = dict(tr.model.named_parameters())
    for n, want in ((k[len(f"{name}.param."):], v)
                    for k, v in arrays.items()
                    if k.startswith(f"{name}.param.")):
        np.testing.assert_array_equal(params[n].detach().numpy(), want,
                                      err_msg=n)
        m1 = tr.optimizer._accumulators[id(params[n])]["moment1"]
        np.testing.assert_array_equal(
            m1.numpy(), arrays[f"{name}.moment1.{n}"], err_msg=n)


def test_device_state_pieces_carry_global_layout(job):
    """The pieces' manifests: the dp-2 ZeRO-2 slab as each parameter's
    flat range (the ranges of the two ranks tile it), GPT's qkv at tp 2
    in its [in, 3, H, D] view cut on the heads."""
    d, _ = job
    src = dck._ShardSource(os.path.join(d, "ckpt", "z2",
                                        "step_00000003"))
    info = src.arrays["opt/blocks.0.attn.qkv_proj.weight/moment1"]
    assert info["shape"] == [64 * 192]
    cover = sorted(tuple(sh["index"][0]) for sh in info["shards"])
    assert cover[0][0] == 0 and cover[-1][1] == 64 * 192
    assert all(a[1] == b[0] for a, b in zip(cover, cover[1:]))
    src = dck._ShardSource(os.path.join(d, "ckpt", "tp2",
                                        "step_00000003"))
    info = src.arrays["params/blocks.0.attn.qkv_proj.weight"]
    assert info["shape"] == [64, 3, 4, 16]
    assert sorted(sh["index"][2] for sh in info["shards"]) == [[0, 2],
                                                                [2, 4]]


# ---------------------------------------------------------------------------
# the walk-back of tests/test_zero_shard.py
# ---------------------------------------------------------------------------
def test_resume_walks_back_over_a_corrupt_step(tmp_path):
    from paddle_tpu_torch.distributed.elastic import ElasticTrainer
    from paddle_tpu_torch.profiler import registry

    _, state = oracle.ref_state()
    toks = [torch.from_numpy(t).long() for t in oracle.tokens(n=4)]
    tr = _port_trainer(state)
    tr.step(toks[0])
    el = ElasticTrainer(tr, str(tmp_path / "ck"), save_interval=100,
                        keep=10, verify_restore=True)
    el.save(3, async_=False)
    saved = {k: v.clone() for k, v in
             tr.optimizer._accumulators[id(tr._upd.params[0])].items()}
    loss4 = float(tr.step(toks[1]))
    assert el.resume() == 3
    for k, v in tr.optimizer._accumulators[
            id(tr._upd.params[0])].items():
        assert torch.equal(v, saved[k])
    assert float(tr.step(toks[1])) == loss4

    el.save(5, async_=False)
    step5 = tmp_path / "ck" / "step_00000005"
    next(p for p in step5.iterdir()
         if p.name.startswith("shard")).write_bytes(b"garbage")
    before = registry().counter("resilience/restore_fallbacks").value
    with pytest.warns(RuntimeWarning, match="unreadable"):
        assert el.resume() == 3
    assert registry().counter("resilience/restore_fallbacks").value == \
        before + 1
    el.save(8, async_=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert el.resume(max_step=3) == 3


# ---------------------------------------------------------------------------
# Fleet.save_persistables
# ---------------------------------------------------------------------------
def test_save_persistables_both_branches(tmp_path):
    from paddle_tpu.framework import io as jio
    from paddle_tpu_torch.distributed.fleet import fleet

    _, state = oracle.ref_state()
    tr = _port_trainer(state)
    tr.step(torch.from_numpy(oracle.tokens()[0]).long())
    fleet.init(is_collective=True)
    d = fleet.save_persistables(dirname=str(tmp_path / "tr"), trainer=tr,
                                step=1)
    assert d.endswith("step_00000001") and dck.latest_step(
        str(tmp_path / "tr")) == 1
    back = dck.restore(str(tmp_path / "tr"), tr.device_state())
    for n, piece in back["params"].items():
        assert torch.equal(piece.data, tr.device_state()["params"][n].data)

    out = fleet.save_persistables(dirname=str(tmp_path / "eager"),
                                  model=tr.model,
                                  optimizer=tr.optimizer)
    got = jio.load(os.path.join(out, "persistables.pdparams"))
    for n, p in tr.model.state_dict().items():
        np.testing.assert_array_equal(got["model"][n], p.numpy())
    m = got["optimizer"]["embeddings.wte.weight_moment1"]
    assert m.shape == (128, 64) and got["optimizer"]["global_step"] == 1
