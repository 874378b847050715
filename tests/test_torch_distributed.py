"""The port's distributed package in one process (world 1), held against
the JAX package where the reference has the same function.

The env protocol and device rules of ``init_parallel_env``; the mesh
(creation, rejection, ``P``/``sharding``/``axis_size``); the context
scopes; every eager collective's single-process semantics (mirrors
``tests/test_distributed.py:205-216``); the primitives on size-1 axes;
``split``; DataParallel, the fleet facade and its optimizer at world 1;
the deferred pieces raising with their ROADMAP items; the collective
accounting (notes, gauges, the counted site's ``collectives``, the
trace's collective names); ``aggregate`` at world 1; and the import
hygiene of the package and its launcher.
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import paddle_tpu.distributed.context as jctx
import paddle_tpu.distributed.mesh as jmesh
import paddle_tpu_torch
import paddle_tpu_torch.distributed as tdist
from paddle_tpu.distributed.fleet import metrics as jfm
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed import context as tctx
from paddle_tpu_torch.distributed import env as tenv
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.distributed import primitives as TP
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.distributed.fleet import metrics as tfm
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.nn.layer.common import Linear
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.profiler import device_trace as tdt
from paddle_tpu_torch.profiler import instrument as tinstr
from paddle_tpu_torch.profiler import program_stats as tps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROTOCOL = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
            "PADDLE_TRAINER_ENDPOINTS", "PADDLE_CURRENT_ENDPOINT",
            "PADDLE_RANK_IN_NODE", "PADDLE_COORDINATOR",
            "PADDLE_DISTRI_BACKEND", "FLAGS_selected_gpus")


@pytest.fixture
def clean_env(monkeypatch):
    for k in PROTOCOL:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(tenv, "_initialized", False)
    yield monkeypatch
    tmesh.set_mesh(None)


@pytest.fixture
def profiling():
    """The profiler on for one test, and off again after it (its enabled
    flag is process-wide: later tests in this worker expect it off)."""
    tprof.enable()
    yield
    tprof.disable()


@pytest.fixture
def mesh1(clean_env):
    m = tmesh.init_mesh({"dp": 1, "tp": 1})
    yield m


# ---------------------------------------------------------------------------
# env
# ---------------------------------------------------------------------------
def test_parallel_env_reads_the_protocol(clean_env):
    clean_env.setenv("PADDLE_TRAINER_ENDPOINTS", "10.0.0.1:6170,10.0.0.2:6170")
    clean_env.setenv("PADDLE_RANK_IN_NODE", "3")
    e = tdist.ParallelEnv()
    assert e.trainer_endpoints == ["10.0.0.1:6170", "10.0.0.2:6170"]
    assert e.current_endpoint == "10.0.0.1:6170"
    assert (e.rank, e.world_size, e.nranks, e.local_rank) == (0, 1, 1, 0)
    assert e.device_id == 3                   # one card per process
    assert e.device == torch.device("cuda", 3)
    clean_env.setenv("FLAGS_selected_gpus", "1,2")
    assert e.device_id == 1


def test_world_of_one_is_a_noop(clean_env):
    assert not tdist.is_initialized()
    e = tdist.init_parallel_env()
    assert tdist.is_initialized() and isinstance(e, tdist.ParallelEnv)
    assert (tdist.get_rank(), tdist.get_world_size()) == (0, 1)
    assert tenv._device is None
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("kw", [dict(), dict(backend="gloo"),
                                dict(backend="nccl")])
def test_the_default_device_is_the_card_and_never_falls_back(clean_env, kw):
    """No card here: the default device (and an explicit backend, which
    never moves it) raises instead of dropping to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.init_parallel_env(num_processes=2, process_id=0, **kw)
    assert not tdist.is_initialized()


def test_unknown_backend_raises(clean_env):
    with pytest.raises(ValueError, match="unknown backend"):
        tdist.init_parallel_env(num_processes=2, backend="mpi")


def test_coordinator_address_forms():
    assert tenv._init_method("10.0.0.1:6170") == "tcp://10.0.0.1:6170"
    assert tenv._init_method("file:///tmp/s") == "file:///tmp/s"
    assert tenv._init_method("tcp://h:1") == "tcp://h:1"


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------
def test_mesh_at_world_one(mesh1):
    assert tdist.get_mesh() is mesh1
    assert mesh1.axis_names == ("dp", "tp")
    assert mesh1.shape == {"dp": 1, "tp": 1} and mesh1.size == 1
    assert mesh1.group("dp") is None and mesh1.axis_ranks("tp") == [0]
    assert mesh1.axis_index("dp") == 0
    assert mesh1.axis_index(("dp", "tp")) == 0
    assert mesh1.group_order(("tp", "dp")) == [0]


@pytest.mark.parametrize("axes,n", [({"dp": 2}, 1), ({"dp": 3}, 8),
                                    ({"dp": 2, "tp": 2}, 8)])
def test_mesh_rejects_a_wrong_device_count_as_the_reference(clean_env, axes,
                                                            n):
    import jax

    with pytest.raises(ValueError) as want:
        jmesh.create_mesh(axes, jax.devices()[:n])
    with pytest.raises(ValueError) as got:
        tmesh.create_mesh(axes, range(n))
    assert str(got.value) == str(want.value)


def test_mesh_of_several_ranks_needs_a_process_group(clean_env):
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        tmesh.create_mesh({"dp": 2}, range(2))


def test_partition_spec_sharding_and_axis_size(mesh1, monkeypatch):
    spec = tdist.P(None, "tp")
    assert spec == (None, "tp") and isinstance(spec, tuple)
    assert tuple(spec) == tuple(jmesh.P(None, "tp"))
    assert repr(spec) == "PartitionSpec(None, 'tp')"
    sh = tdist.sharding("dp", None)
    assert sh.mesh is mesh1 and sh.spec == tdist.P("dp", None)
    assert sh == tdist.sharding("dp", None)
    assert tdist.axis_size("tp") == 1 and tdist.axis_size("ep") == 1
    tmesh.set_mesh(None)
    monkeypatch.setattr(jmesh, "_current_mesh", None)
    assert tdist.axis_size("tp") == jmesh.axis_size("tp") == 1
    with pytest.raises(RuntimeError, match="No mesh set"):
        tdist.sharding("dp")


# ---------------------------------------------------------------------------
# context
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sp", [1, 2])
def test_sequence_parallel_scopes_match_the_reference(sp):
    m = types.SimpleNamespace(shape={"sp": sp})
    for ctx in (jctx, tctx):
        assert ctx.current_sequence_parallel() is None
    with tctx.sequence_parallel_scope(m), jctx.sequence_parallel_scope(m):
        assert tctx.current_sequence_parallel() == \
            jctx.current_sequence_parallel()
        with tctx.manual_sequence_parallel_scope(), \
                jctx.manual_sequence_parallel_scope():
            assert tctx.current_sequence_parallel() == \
                jctx.current_sequence_parallel()
        assert tctx.current_sequence_parallel() == \
            ((m, "sp", False) if sp > 1 else None)
    assert tctx.current_sequence_parallel() is None


# ---------------------------------------------------------------------------
# single-process collectives (mirrors tests/test_distributed.py:205-216)
# ---------------------------------------------------------------------------
def test_single_process_semantics(clean_env):
    t = torch.arange(4, dtype=torch.float32)
    assert C.all_reduce(t) is t
    np.testing.assert_allclose(t.numpy(), np.arange(4))
    outs = []
    C.all_gather(outs, t)
    assert len(outs) == 1 and torch.equal(outs[0], t)
    assert outs[0] is not t
    assert C.broadcast(t, 0) is t
    assert C.reduce(t, 0) is t and torch.equal(t, torch.arange(4.0))


def test_single_process_scatter_reduce_scatter_alltoall(clean_env):
    t = torch.zeros(3)
    parts = [torch.tensor([1.0, 2.0, 3.0])]
    C.scatter(t, parts)
    assert torch.equal(t, parts[0])
    u = torch.zeros(3)
    C.reduce_scatter(u, [torch.tensor([4.0, 5.0, 6.0])])
    assert torch.equal(u, torch.tensor([4.0, 5.0, 6.0]))
    out = []
    C.alltoall(parts, out)
    assert torch.equal(out[0], parts[0]) and out[0] is not parts[0]
    C.barrier()
    assert C.get_group() is None


def test_send_recv_and_spawn_raise():
    with pytest.raises(NotImplementedError, match="ppermute"):
        tdist.send(torch.zeros(1))
    with pytest.raises(NotImplementedError, match="ppermute"):
        tdist.recv(torch.zeros(1))
    with pytest.raises(NotImplementedError, match="launch"):
        tdist.spawn(print)


def test_primitives_on_size_one_axes(mesh1):
    x = torch.randn(2, 4, requires_grad=True)
    assert TP.psum(x, "dp") is x and TP.pmean(x, ("dp", "tp")) is x
    assert TP.pmax(x, "tp") is x and TP.pmin(x, "tp") is x
    assert TP.psum(1, "dp") == 1 and TP.psum((x, 3), "tp")[1] == 3
    assert TP.all_gather(x, "dp").shape == (1, 2, 4)
    assert TP.all_gather(x, "dp", axis=1, tiled=True) is x
    assert TP.psum_scatter(x, "dp") is x
    assert TP.reduce_scatter is TP.psum_scatter
    assert TP.all_to_all(x, "tp", 0, 1, tiled=True) is x
    assert TP.ppermute(x, "dp", [(0, 0)]) is x
    assert torch.equal(TP.ppermute(x, "dp", []), torch.zeros(2, 4))
    assert TP.ring_permute(x, "tp") is x
    assert int(TP.axis_index("tp")) == 0
    assert TP.axis_index("dp").dtype == torch.int32
    with pytest.raises(NameError, match="unbound axis name: ep"):
        TP.psum(x, "ep")


def test_primitives_need_a_mesh(clean_env):
    tmesh.set_mesh(None)
    with pytest.raises(NameError, match="unbound axis name"):
        TP.psum(torch.ones(1), "dp")


@pytest.mark.parametrize("op,axis,size,shape", [
    ("linear", 1, (8, 12), (2, 3, 12)), ("linear", 0, (8, 12), (2, 3, 12)),
    ("embedding", 0, (16, 12), (2, 3, 12))])
def test_split_builds_the_parallel_layer(clean_env, op, axis, size, shape):
    x = torch.randn(2, 3, 8) if op == "linear" else \
        torch.randint(0, 16, (2, 3))
    y = tdist.split(x, size, op, axis=axis)
    assert y.shape == shape
    assert tdist.split(torch.randn(2, 8), (8, 4), "linear",
                       bias_attr=False).shape == (2, 4)
    with pytest.raises(ValueError, match="Unsupported split"):
        tdist.split(x, size, "conv")


def test_gpt_at_tp_above_one_names_item_7b(clean_env):
    """ROADMAP item 7b splits GPT's heads over tp: built under a tp 2
    mesh, each rank holds half of the heads and of the vocab, its qkv
    shard cut on the heads. Serving such a model (generate, the engine)
    is item 8 and raises, naming it."""
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    clean_env.setattr(tmesh, "_current_mesh", types.SimpleNamespace(
        axis_names=("dp", "tp"), shape={"dp": 1, "tp": 2},
        axis_index=lambda name: 0))
    net = tgpt.GPT(tgpt.GPTConfig(vocab_size=64, hidden_size=32,
                                  num_layers=1, num_heads=2, max_seq_len=16),
                   device="cpu")
    attn = net.blocks[0].attn
    assert attn.num_heads == 1
    assert tuple(attn.qkv_proj.weight.shape) == (32, 48)
    assert attn.qkv_proj.shard_views["weight"] == ((3, 2, 16), 1)
    assert tuple(net.embeddings.wte.weight.shape) == (32, 32)
    assert attn.out_proj.input_is_parallel
    with pytest.raises(NotImplementedError, match="item 8"):
        net.generate(torch.zeros(1, 4, dtype=torch.long), max_new_tokens=2)
    with pytest.raises(NotImplementedError, match="item 8"):
        ServingEngine(net, ServingConfig(num_slots=1, page_size=4,
                                         pages_per_slot=4))


# ---------------------------------------------------------------------------
# DataParallel and fleet at world 1
# ---------------------------------------------------------------------------
def test_data_parallel_at_world_one(clean_env):
    assert paddle_tpu_torch.DataParallel is tdist.DataParallel
    paddle_tpu_torch.seed(0)
    net = tgpt.GPT(tgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                                  num_heads=2, max_seq_len=16), device="cpu")
    dp = tdist.DataParallel(net)
    assert set(dp.state_dict()) == set(net.state_dict())
    tok = torch.randint(0, 64, (2, 16))
    assert torch.equal(dp(tok), net(tok))
    assert dp.scale_loss(3.0) == 3.0
    net.loss(tok).backward()
    g = {n: p.grad.clone() for n, p in net.named_parameters()}
    dp.apply_collective_grads()
    for n, p in net.named_parameters():
        assert torch.equal(p.grad, g[n])
    dp.set_state_dict(net.state_dict())


def test_fleet_at_world_one_steps_as_the_inner_optimizer(clean_env):
    f = fleet.init(is_collective=True)
    assert f is fleet.fleet
    assert (fleet.worker_index(), fleet.worker_num(),
            fleet.is_first_worker()) == (0, 1, True)
    assert isinstance(fleet.distributed_model(torch.nn.Linear(2, 2)),
                      tdist.DataParallel)
    fleet.barrier_worker()
    nets = []
    for wrap in (False, True):
        paddle_tpu_torch.seed(0)
        net = Linear(8, 4, device="cpu")
        opt = AdamW(1e-3, parameters=net.named_parameters())
        if wrap:
            opt = fleet.distributed_optimizer(opt)
            assert opt.get_lr() == 1e-3           # the inner's attribute
        for s in range(2):
            x = torch.randn(3, 8, generator=torch.Generator().manual_seed(s))
            net(x).square().mean().backward()
            opt.step()
            opt.clear_grad()
        nets.append(net)
    for (n, a), (_, b) in zip(nets[0].named_parameters(),
                              nets[1].named_parameters()):
        assert torch.equal(a, b), n


def test_role_makers_are_role_makers(clean_env):
    for rm in (fleet.PaddleCloudRoleMaker(is_collective=True),
               fleet.UserDefinedRoleMaker()):
        fleet.init(role_maker=rm)
        assert fleet.worker_index() == 0 and fleet.worker_num() == 1
        assert rm.is_worker() and not rm.is_server()


@pytest.mark.parametrize("switch", ["lars", "lamb"])
def test_lars_lamb_swap_names_item_9(clean_env, switch):
    s = DistributedStrategy()
    setattr(s, switch, True)
    fleet.init(strategy=s)
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        fleet.distributed_optimizer(AdamW(1e-3, parameters=[]), s)


def test_deferred_pieces_name_their_items(clean_env):
    fleet.init()
    # save_persistables runs since item 7d (tests/test_torch_checkpoint.py);
    # without a directory it raises the reference's error
    with pytest.raises(ValueError, match="dirname"):
        fleet.fleet.save_persistables()
    with pytest.raises(NotImplementedError, match="item 9"):
        tfm.distributed_metric(object())


def test_fleet_metrics_at_world_one_match_the_reference():
    for f in ("sum", "max", "min"):
        got, want = getattr(tfm, f)(3), getattr(jfm, f)(3)
        assert got == want and isinstance(got, float)
        np.testing.assert_allclose(getattr(tfm, f)([1, 2, 3]),
                                   getattr(jfm, f)([1, 2, 3]))
    np.testing.assert_allclose(tfm.max(torch.tensor([4.0, 5.0])), [4, 5])
    assert tfm.acc(7, 10) == jfm.acc(7, 10)
    assert tfm.acc(0, 0) == 0.0
    for pos, neg in (([0, 0, 0, 4], [4, 0, 0, 0]), ([2, 2], [2, 2]),
                     ([0, 0], [0, 0]), ([3, 1, 4, 1], [5, 9, 2, 6])):
        assert tfm.auc(pos, neg) == pytest.approx(jfm.auc(pos, neg))


# ---------------------------------------------------------------------------
# the collective accounting
# ---------------------------------------------------------------------------
NOTES = [("all_reduce", torch.float32, 64), ("reduce_scatter", torch.bfloat16,
                                             32),
         ("all_gather", torch.int8, 16), ("collective_permute",
                                          torch.float32, 8),
         ("all_gather", torch.float32, 128), ("all_to_all", torch.uint8, 4)]


def test_collective_stats_of_the_notes():
    with tinstr.count_collectives() as outer:
        with tinstr.count_collectives() as inner:
            for n in NOTES[:3]:
                tinstr.note_collective(*n)
        for n in NOTES[3:]:
            tinstr.note_collective(*n)
    tinstr.note_collective("all_reduce", torch.float32, 1)   # none active
    assert len(inner.notes) == 3 and len(outer.notes) == 6
    st = tinstr.collective_stats(outer)
    assert st == {
        "ops": {"all_reduce": 1, "reduce_scatter": 1, "all_gather": 2,
                "collective_permute": 1, "all_to_all": 1},
        "bytes": {"all_reduce": 64, "reduce_scatter": 32, "all_gather": 144,
                  "collective_permute": 8, "all_to_all": 4},
        "bytes_by_dtype": {"f32": 200, "bf16": 32, "i8": 16, "ui8": 4},
        "bytes_by_kind_dtype": {
            "all_reduce": {"f32": 64}, "reduce_scatter": {"bf16": 32},
            "all_gather": {"i8": 16, "f32": 128},
            "collective_permute": {"f32": 8}, "all_to_all": {"ui8": 4}},
        "total_bytes": 252}
    assert tinstr.collective_stats(outer.notes) == st


def test_record_collective_stats_sets_the_reference_gauges(profiling):
    with tinstr.count_collectives() as c:
        for n in NOTES:
            tinstr.note_collective(*n)
    tinstr.record_collective_stats(c, prefix="cx")
    g = {k: s["value"] for k, s in tprof.registry().snapshot().items()
         if k.startswith("cx/")}
    assert g == {
        "cx/collective_bytes_per_step": 252, "cx/collective_ops_per_step": 6,
        "cx/collective_bytes_int8": 20, "cx/collective_bytes_f32": 200,
        # the ring halves: reduce-scatter with the permute hops
        "cx/collective_bytes_reduce_scatter_int8": 0,
        "cx/collective_bytes_reduce_scatter_bf16": 32,
        "cx/collective_bytes_reduce_scatter_f32": 8,
        "cx/collective_bytes_all_gather_int8": 16,
        "cx/collective_bytes_all_gather_bf16": 0,
        "cx/collective_bytes_all_gather_f32": 128}
    st = tinstr.record_collectives_from(
        lambda: tinstr.note_collective("all_reduce", torch.float32, 40),
        prefix="cy")
    assert st["total_bytes"] == 40
    assert tprof.registry().gauge("cy/collective_ops_per_step").value == 1


def test_a_counted_site_keeps_its_collectives():
    rec = {}

    def step():
        y = torch.ones(4) * 2
        tinstr.note_collective("all_reduce", torch.float32, 16)
        tinstr.note_collective("all_reduce", torch.float32, 16)
        tinstr.note_collective("all_gather", torch.bfloat16, 8)
        return y

    tps.dispatch(rec, "t.dp#0", step)
    ps = tps.record_counted("t.dp#0", rec["t.dp#0"])
    assert ps.collectives == {"all_reduce": {"ops": 2, "bytes": 32},
                              "all_gather": {"ops": 1, "bytes": 8}}
    assert ps.to_dict()["collectives"] == ps.collectives
    tps.dispatch(rec, "t.dp#0", step)           # a later dispatch: uncounted
    assert rec["t.dp#0"]["collectives"]["all_reduce"]["ops"] == 2


@pytest.mark.parametrize("name,kind", [
    ("c10d::allreduce_", "all_reduce"), ("gloo:all_reduce", "all_reduce"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "all_reduce"),
    ("c10d::_allgather_base_", "all_gather"),
    ("gloo:all_gather", "all_gather"),
    ("ncclDevKernel_ReduceScatter_Sum_bf16_RING_LL", "reduce_scatter"),
    ("c10d::reduce_scatter_", "reduce_scatter"),
    ("c10d::alltoall_base_", "all_to_all"),
    ("ncclDevKernel_SendRecv", "ppermute"), ("c10d::recv_", "ppermute"),
    ("c10d::broadcast_", "collective_broadcast"),
    ("gloo:broadcast", "collective_broadcast"),
    ("ncclDevKernel_Broadcast_RING_LL", "collective_broadcast"),
    ("aten::broadcast_tensors", None), ("Memcpy HtoD (Pinned -> Device)",
                                        None)])
def test_trace_names_of_torch_distributed_collectives(name, kind):
    assert tdt.collective_kind(name) == kind
    assert (tdt.categorize_op(name) == "collective") == (kind is not None)


def test_gloo_copies_join_their_collective():
    """A card's gloo collective is its copies: the device-to-pinned copy
    the caller's c10d op launches and the copy back that gloo's worker
    thread launches in its range (tests/data/torch_gloo_cuda.trace.json.gz,
    shaped as an H100 trace)."""
    doc = tdt.load_trace_events(os.path.join(
        REPO, "tests", "data", "torch_gloo_cuda.trace.json.gz"))
    tl = tdt.parse_timeline(doc, modules={"dp.step#0"})
    names = [n for n, _, _, _ in tl.device_ops]
    assert names[1:5] == [
        "c10d::allreduce_: Memcpy DtoH (Device -> Pinned)",
        "gloo:all_reduce: Memcpy HtoD (Pinned -> Device)",
        "c10d::_allgather_base_: Memcpy DtoH (Device -> Pinned)",
        "gloo:all_gather: Memcpy HtoD (Pinned -> Device)"]
    assert names[-1] == "Memcpy HtoD (Pinned -> Device)"
    s = tdt.summarize(tl, steps=1, peak_flops=1e12)
    assert s["categories"]["collective"]["count"] == 5
    assert s["collectives"]["all_reduce"]["count"] == 3
    assert s["collectives"]["all_gather"]["count"] == 2
    assert s["categories"]["elementwise"]["count"] == 2


def test_aggregate_at_world_one_is_the_snapshot(profiling):
    reg = tprof.registry()
    reg.counter("a/c").add(4)
    reg.gauge("a/g").set(2.5)
    reg.histogram("a/h").observe(1.0)
    assert reg.aggregate() == reg.snapshot()
    assert reg._schema_union(reg.snapshot()) == [
        ("a/c", "counter"), ("a/g", "gauge"), ("a/h", "histogram")]


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------
def test_the_package_and_its_launcher_import_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import paddle_tpu_torch.distributed\n"
        "import paddle_tpu_torch.distributed.launch\n"
        "from paddle_tpu_torch.distributed import fleet, primitives, mesh\n"
        "from paddle_tpu_torch.distributed.fleet import metrics\n"
        "from paddle_tpu_torch.distributed import (checkpoint, elastic,\n"
        "    offload, prefetch, qcomm)\n"
        "from paddle_tpu_torch.framework import io\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'paddle_tpu' or m.startswith('paddle_tpu.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
