"""The port's collectives on real gloo process groups (CPU), held against
the JAX package.

Two jobs, each started once (``tests/data/torch_dist_worker.py``):

- 2 ranks: every eager op of ``distributed/collective.py`` against the
  reference's semantics (its all-gather spelling, ``collective.py:42-124``:
  a stacked reduction, ``reduce`` on every rank, rank-indexed
  ``reduce_scatter`` and ``alltoall``), exactly; the accounting of those
  ops; ``fleet.metrics`` against the reference's functions on the
  ranks' combined inputs (rtol 1e-12: f64 sums of two terms);
  ``MetricsRegistry.aggregate`` against a reference registry that
  observed the union (equal: both merge the same sketch buckets).
- 4 ranks on a {"dp": 2, "tp": 2} mesh: every primitive's output and the
  gradient of the ranks' summed losses against the reference primitives
  under ``shard_map`` on 4 of the conftest's 8 CPU devices (f32, rtol =
  atol = 1e-6: sums of at most four terms in another order), and the
  port's ``collective_stats`` of the forward program against the
  reference's ``collective_stats`` of its lowered StableHLO, key for key.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from paddle_tpu.distributed import primitives as JPrim
from paddle_tpu.distributed._compat import shard_map
from paddle_tpu.distributed.fleet import metrics as jfm
from paddle_tpu.profiler import metrics as jmetrics
from paddle_tpu.profiler.instrument import collective_stats as jstats

_spec = importlib.util.spec_from_file_location(
    "torch_dist_worker", os.path.join(os.path.dirname(__file__), "data",
                                      "torch_dist_worker.py"))
worker = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(worker)

TOL = dict(rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# 2 ranks: the eager API, fleet.metrics, aggregate
# ---------------------------------------------------------------------------
def _coll_inputs():
    r = np.random.RandomState(0)
    inp = {f"x{k}": r.randn(3, 4).astype(np.float32) for k in range(2)}
    inp.update({f"i{k}": r.randint(-50, 50, 5).astype(np.int32)
                for k in range(2)})
    inp.update({f"parts{k}": r.randn(2, 3, 4).astype(np.float32)
                for k in range(2)})
    inp["fm_scalar"] = r.randn(2)
    inp["fm_array"] = r.randn(2, 6)
    inp["fm_correct"] = np.array([7, 5])
    inp["fm_total"] = np.array([10, 12])
    inp["fm_pos"] = r.randint(0, 20, (2, 8)).astype(np.float64)
    inp["fm_neg"] = r.randint(0, 20, (2, 8)).astype(np.float64)
    # disjoint samples: rank 0 below rank 1
    inp["h0"] = r.uniform(1, 50, 120)
    inp["h1"] = r.uniform(50, 400, 200)
    inp["gauge"] = np.array([2.5, 7.25])
    return inp


@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    d = tmp_path_factory.mktemp("coll")
    inp = _coll_inputs()
    np.savez(d / "inputs.npz", **inp)
    return inp, worker.launch_job("collectives", 2, d)


def _both(coll, key):
    return [a[key] for a, _ in coll[1]]


@pytest.mark.parametrize("name,reduce", [
    ("sum", lambda s: s.sum(0)), ("max", lambda s: s.max(0)),
    ("min", lambda s: s.min(0)), ("prod", lambda s: s.prod(0))])
def test_all_reduce_ops(coll, name, reduce):
    inp, _ = coll
    want = reduce(np.stack([inp["x0"], inp["x1"]]))
    for got in _both(coll, f"all_reduce_{name}"):
        np.testing.assert_array_equal(got, want)


def test_all_reduce_int_and_bf16(coll):
    inp, _ = coll
    for got in _both(coll, "all_reduce_int_max"):
        np.testing.assert_array_equal(got, np.maximum(inp["i0"], inp["i1"]))
    b = [torch.from_numpy(inp[f"x{k}"]).bfloat16().float() for k in (0, 1)]
    want = (b[0] + b[1]).bfloat16().float().numpy()
    for got in _both(coll, "all_reduce_bf16"):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["all_gather", "broadcast", "reduce"])
def test_gather_broadcast_reduce(coll, op):
    inp, _ = coll
    want = {"all_gather": np.stack([inp["x0"], inp["x1"]]),
            "broadcast": inp["x1"],
            "reduce": inp["x0"] + inp["x1"]}[op]
    for got in _both(coll, op):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["scatter", "reduce_scatter", "alltoall"])
def test_rank_indexed_ops(coll, op):
    inp, _ = coll
    for rank, got in enumerate(_both(coll, op)):
        want = {"scatter": inp["parts0"][rank],
                "reduce_scatter": inp["parts0"][rank] + inp["parts1"][rank],
                "alltoall": np.stack([inp["parts0"][rank],
                                      inp["parts1"][rank]])}[op]
        np.testing.assert_array_equal(got, want)


def test_eager_accounting(coll):
    """Result-buffer bytes by op and dtype: x is 3x4 f32 (48 B)."""
    want = {"ops": {"all_reduce": 7, "all_gather": 1,
                    "collective_broadcast": 2, "reduce_scatter": 1,
                    "all_to_all": 1},
            "bytes": {"all_reduce": 5 * 48 + 20 + 24, "all_gather": 96,
                      "collective_broadcast": 96, "reduce_scatter": 48,
                      "all_to_all": 96},
            "bytes_by_dtype": {"f32": 5 * 48 + 96 + 96 + 48 + 96,
                               "i32": 20, "bf16": 24},
            "bytes_by_kind_dtype": {
                "all_reduce": {"f32": 240, "i32": 20, "bf16": 24},
                "all_gather": {"f32": 96},
                "collective_broadcast": {"f32": 96},
                "reduce_scatter": {"f32": 48}, "all_to_all": {"f32": 96}}}
    want["total_bytes"] = sum(want["bytes"].values())
    for _, v in coll[1]:
        assert v["stats"] == want


def test_send_raises_and_world(coll):
    for rank, (_, v) in enumerate(coll[1]):
        assert v["send_raises"] and v["world"] == 2
        assert v["device"] == "cpu"


def test_ranks_import_neither_jax_nor_the_jax_package(coll):
    for _, v in coll[1]:
        assert v["foreign_modules"] == []


def test_fleet_metrics_against_reference_on_combined_inputs(coll):
    inp, out = coll
    want = {"fm_sum_scalar": jfm.sum(inp["fm_scalar"].sum()),
            "fm_max_scalar": jfm.max(inp["fm_scalar"].max()),
            "fm_min_scalar": jfm.min(inp["fm_scalar"].min()),
            "fm_acc": jfm.acc(int(inp["fm_correct"].sum()),
                              int(inp["fm_total"].sum())),
            "fm_auc": jfm.auc(inp["fm_pos"].sum(0), inp["fm_neg"].sum(0))}
    arrays = {"fm_sum_array": jfm.sum(inp["fm_array"].sum(0)),
              "fm_max_array": jfm.max(inp["fm_array"].max(0)),
              "fm_min_array": jfm.min(inp["fm_array"].min(0))}
    for a, v in out:
        for k, w in want.items():
            assert v[k] == pytest.approx(w, rel=1e-12), k
        for k, w in arrays.items():
            np.testing.assert_allclose(a[k], w, rtol=1e-12, err_msg=k)


def _union_registry(inp):
    reg = jmetrics.MetricsRegistry()
    for v in np.concatenate([inp["h0"], inp["h1"]]):
        reg.histogram("m/h").observe(float(v))
    reg.histogram("m/only0").observe(3.5)
    reg.histogram("m/empty")
    reg.counter("m/c").add(4.0 + 5.0)
    reg.counter("m/only1").add(2.0)
    reg.gauge("m/g").set(float(inp["gauge"].max()))
    reg.gauge("m/unset")
    return reg.snapshot()


def test_aggregate_equals_the_union_registry(coll):
    """Disjoint samples on the two ranks: the aggregated quantiles equal
    those of one reference registry that observed the union; counters
    sum, gauges take the max, a metric one rank lacks is reduced with the
    neutral element."""
    inp, out = coll
    want = _union_registry(inp)
    for _, v in out:
        got = v["aggregate"]
        assert set(got) == set(want)
        for name, w in want.items():
            g = got[name]
            assert g["type"] == w["type"], name
            if w["type"] != "histogram":
                assert g["value"] == w["value"], name
                continue
            assert g["count"] == w["count"], name
            if not w["count"]:
                continue
            for k in ("sum", "mean", "min", "max"):
                assert g[k] == pytest.approx(w[k], rel=1e-12), (name, k)
            for q in ("p50", "p90", "p95", "p99"):
                assert g[q] == w[q], (name, q)
    h = out[0][1]["aggregate"]["m/h"]
    assert h["p50"] > inp["h0"].max()      # moved into rank 1's range


def test_summary_aggregate_is_the_rank_reduction(coll):
    a0, a1 = (v["aggregate"] for _, v in coll[1])
    assert a0 == a1
    for _, v in coll[1]:
        assert v["summary_aggregate"] == v["aggregate"]


# ---------------------------------------------------------------------------
# 4 ranks, {"dp": 2, "tp": 2}: the primitives against shard_map
# ---------------------------------------------------------------------------
#: the outputs whose gradients are compared: every differentiable one
DIFF = ["psum_tp", "pmean_dp", "psum_all", "gather_dp_tiled",
        "gather_tp_stacked", "a2a_tp_tiled", "a2a_tp", "ppermute_dp",
        "ppermute_partial", "ring_tp", "scatter_dp", "scatter_tp_untiled",
        "gather_tpdp_tiled", "scatter_tpdp", "a2a_tpdp_tiled",
        "ppermute_tpdp"]
TPDP = worker.TPDP


def _ref_program(x, minmax=True):
    """The reference program; ``minmax=False``, the differentiable one:
    no pmax/pmin (jax has no rule for them), and the untiled all_to_all
    spelled as its tiled equivalent (jax 0.9 cannot transpose the untiled
    one under shard_map: a cotangent of the wrong shape)."""
    P = JPrim
    outs = {
        "psum_tp": P.psum(x, "tp"),
        "pmean_dp": P.pmean(x, "dp"),
        "psum_all": P.psum(x, ("dp", "tp")),
        "gather_dp_tiled": P.all_gather(x, "dp", axis=0, tiled=True),
        "gather_tp_stacked": P.all_gather(x, "tp", axis=1),
        "a2a_tp_tiled": P.all_to_all(x, "tp", 1, 0, tiled=True),
        "a2a_tp": P.all_to_all(x, "tp", 0, 1) if minmax else
        P.all_to_all(x[:, None], "tp", 0, 1, tiled=True)[0].T,
        "ppermute_dp": P.ppermute(x, "dp", [(0, 1), (1, 0)]),
        "ppermute_partial": P.ppermute(x, "tp", [(0, 1)]),
        "ring_tp": P.ring_permute(x, "tp", shift=1),
        # a tuple named out of the mesh's order: axis index tp * 2 + dp
        "gather_tpdp_tiled": P.all_gather(x, TPDP, axis=0, tiled=True),
        "scatter_tpdp": P.psum_scatter(x, TPDP, scatter_dimension=1,
                                       tiled=True),
        "a2a_tpdp_tiled": P.all_to_all(x, TPDP, 1, 0, tiled=True),
        "ppermute_tpdp": P.ppermute(x, TPDP, [(0, 1), (1, 2), (2, 3),
                                              (3, 0)]),
    }
    outs["scatter_dp"] = P.psum_scatter(outs["gather_dp_tiled"], "dp",
                                        scatter_dimension=0, tiled=True)
    outs["scatter_tp_untiled"] = P.psum_scatter(outs["gather_tp_stacked"],
                                                "tp", scatter_dimension=1,
                                                tiled=False)
    if minmax:           # no differentiation rule in jax
        outs["pmax_tp"] = P.pmax(x, "tp")
        outs["pmin_dp"] = P.pmin(x, "dp")
    return outs


def _jmesh():
    return Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))


def _per_device(fn, mesh, n_in):
    """``fn`` on each device's [1, ...] slice of inputs whose leading
    axis is the device (rank) index; outputs the same way."""
    spec = JP(("dp", "tp"))

    def body(*args):
        out = fn(*(a[0] for a in args))
        return jax.tree_util.tree_map(lambda o: o[None], out)

    return shard_map(body, mesh=mesh, in_specs=(spec,) * n_in,
                     out_specs=spec)


@pytest.fixture(scope="module")
def mesh_job(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    r = np.random.RandomState(1)
    x = r.randn(4, 2, 4).astype(np.float32)
    mesh = _jmesh()
    shapes = jax.eval_shape(_per_device(_ref_program, mesh, 1), x)
    inp = {"x": x}
    for k in DIFF:
        inp[f"w_{k}"] = r.randn(*shapes[k].shape).astype(np.float32)
    np.savez(d / "inputs.npz", **inp)
    return inp, worker.launch_job("mesh", 4, d)


def test_mesh_coordinates_are_row_major(mesh_job):
    for rank, (_, v) in enumerate(mesh_job[1]):
        assert v["coords"] == [rank // 2, rank % 2]
        assert v["foreign_modules"] == []


@pytest.fixture(scope="module")
def ref_forward():
    """The reference program, jitted once: its outputs and its lowering
    share the trace."""
    return jax.jit(_per_device(_ref_program, _jmesh(), 1))


def test_primitive_outputs_match_shard_map(mesh_job, ref_forward):
    inp, out = mesh_job
    ref = ref_forward(inp["x"])
    for rank, (a, _) in enumerate(out):
        for k, v in ref.items():
            np.testing.assert_allclose(a[k], np.asarray(v)[rank], **TOL,
                                       err_msg=f"{k} rank {rank}")
        assert float(a["index"]) == (rank // 2) * 10 + rank % 2
        assert float(a["psum_const"]) == 4.0
        assert float(a["index_tpdp"]) == (rank % 2) * 2 + rank // 2


def test_primitive_gradients_match_shard_map(mesh_job):
    """The gradient of the sum of every rank's loss: each primitive's
    transpose as the reference gets it under shard_map."""
    inp, out = mesh_job
    mesh = _jmesh()

    def local_loss(x, *ws):
        outs = _ref_program(x, minmax=False)
        return sum(jnp.sum(outs[k] * w) for k, w in zip(DIFF, ws))

    f = _per_device(local_loss, mesh, 1 + len(DIFF))
    grad = jax.jit(jax.grad(lambda x, *ws: jnp.sum(f(x, *ws))))(
        inp["x"], *(inp[f"w_{k}"] for k in DIFF))
    for rank, (a, _) in enumerate(out):
        np.testing.assert_allclose(a["grad"], np.asarray(grad)[rank],
                                   **TOL, err_msg=f"rank {rank}")


def test_collective_stats_match_the_lowered_program(mesh_job, ref_forward):
    inp, out = mesh_job
    text = ref_forward.lower(inp["x"]).as_text()
    want = jstats(text)
    assert want["ops"], "the reference program lowered no collective"
    for _, v in out:
        assert v["stats"] == json.loads(json.dumps(want))


def test_pmax_has_no_gradient_and_unbound_axes_raise(mesh_job):
    with pytest.raises(NotImplementedError):
        jax.grad(lambda x: jnp.sum(_per_device(
            lambda y: JPrim.pmax(y, "tp"), _jmesh(), 1)(x)))(
            mesh_job[0]["x"])
    for _, v in mesh_job[1]:
        assert v["pmax_grad_raises"] and v["unbound_raises"]
