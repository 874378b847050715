"""The port's tensor-parallel layers at tp = 2 on 2 gloo ranks (CPU),
held against the reference's dense layers (JAX) with the same full
weights.

One job (``tests/data/torch_dist_worker.py``, job ``tp``) on a {"tp": 2}
mesh; each rank loads its shard of the full weights with
``shard_reference_state``. Held at rtol = atol = 1e-5 (f32; a row
product sums its two halves in another order):

- ColumnParallelLinear(64 -> 256, gather_output=False), exact GELU,
  RowParallelLinear(256 -> 64, input_is_parallel=True): the output, the
  input's gradient and every weight's gradient gathered along the dims
  ``param_shardings`` names;
- ColumnParallelLinear with gather_output=True, RowParallelLinear with
  input_is_parallel=False (it takes its own slice of a full input);
- VocabParallelEmbedding(128, 64): lookups across both shards;
- ParallelCrossEntropy over vocab-sharded logits [2, 16, 128] with
  ignored labels: the loss and the logits' gradient.

At degree 1 (no mesh, or a tp axis of size 1) each layer is today's
dense layer, bit for bit, in-process.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed import parallel_layers as JPL
from paddle_tpu_torch import seed as tseed
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.distributed import parallel_layers as PL
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.nn.layer.common import Embedding, Linear

_spec = importlib.util.spec_from_file_location(
    "torch_dist_worker", os.path.join(os.path.dirname(__file__), "data",
                                      "torch_dist_worker.py"))
worker = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(worker)

H, F, V = 64, 256, 128
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs():
    r = np.random.RandomState(11)
    inp = {"dims": np.array([H, F, V]),
           "col.weight": r.randn(H, F).astype(np.float32) * 0.1,
           "col.bias": r.randn(F).astype(np.float32) * 0.1,
           "row.weight": r.randn(F, H).astype(np.float32) * 0.1,
           "row.bias": r.randn(H).astype(np.float32) * 0.1,
           "emb.weight": r.randn(V, H).astype(np.float32),
           "x": r.randn(2, 16, H).astype(np.float32),
           "xf": r.randn(2, 16, F).astype(np.float32),
           "w_mlp": r.randn(2, 16, H).astype(np.float32),
           "w_col": r.randn(2, 16, F).astype(np.float32),
           "ids": r.randint(0, V, (2, 16)).astype(np.int64),
           "logits": r.randn(2, 16, V).astype(np.float32) * 3,
           "labels": r.randint(0, V, (2, 16)).astype(np.int64)}
    inp["labels"][0, :3] = -100
    return inp


@pytest.fixture(scope="module")
def tp_job(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    return inp, worker.launch_job("tp", 2, d)


def _ref_layer(layer, inp, prefix):
    layer.set_state_dict({n: paddle.to_tensor(inp[prefix + n])
                          for n, _ in layer.named_parameters()})
    return layer


def _ref_run(layers, x, w, gelu=False):
    xt = paddle.to_tensor(x)
    if x.dtype.kind == "f":
        xt.stop_gradient = False
    y = xt
    for i, layer in enumerate(layers):
        y = layer(y)
        if gelu and i == 0:
            y = JF.gelu(y, approximate=False)
    (y * paddle.to_tensor(w)).sum().backward()
    grads = [{n: np.asarray(p.grad._value) for n, p in
              layer.named_parameters()} for layer in layers]
    dx = np.asarray(xt.grad._value) if x.dtype.kind == "f" else None
    return np.asarray(y._value), dx, grads


#: the dim each parameter is sharded on (param_shardings), None: whole
SHARD_DIM = {"col": {"weight": 1, "bias": 0}, "row": {"weight": 0,
                                                      "bias": None},
             "emb": {"weight": 0}}


def _check(out, name, kinds, y, dx, grads):
    for rank, (a, _) in enumerate(out):
        np.testing.assert_allclose(a[f"{name}.out"], y, **TOL,
                                   err_msg=f"{name} out rank {rank}")
        if dx is not None:
            np.testing.assert_allclose(a[f"{name}.dx"], dx, **TOL,
                                       err_msg=f"{name} dx rank {rank}")
    for i, kind in enumerate(kinds):
        for n, g in grads[i].items():
            dim = SHARD_DIM[kind][n]
            parts = [a[f"{name}.{i}.{n}"] for a, _ in out]
            got = parts[0] if dim is None else np.concatenate(parts, dim)
            np.testing.assert_allclose(got, g, **TOL,
                                       err_msg=f"{name} {kind}.{n}")
            if dim is None:
                np.testing.assert_allclose(parts[1], g, **TOL)


def test_column_then_row_mlp(tp_job):
    inp, out = tp_job
    col = _ref_layer(JPL.ColumnParallelLinear(H, F, gather_output=False),
                     inp, "col.")
    row = _ref_layer(JPL.RowParallelLinear(F, H, input_is_parallel=True),
                     inp, "row.")
    _check(out, "mlp", ["col", "row"],
           *_ref_run([col, row], inp["x"], inp["w_mlp"], gelu=True))


def test_column_gather_output(tp_job):
    inp, out = tp_job
    col = _ref_layer(JPL.ColumnParallelLinear(H, F), inp, "col.")
    _check(out, "col_gather", ["col"],
           *_ref_run([col], inp["x"], inp["w_col"]))


def test_row_takes_its_slice_of_a_full_input(tp_job):
    inp, out = tp_job
    row = _ref_layer(JPL.RowParallelLinear(F, H), inp, "row.")
    _check(out, "row_full", ["row"],
           *_ref_run([row], inp["xf"], inp["w_mlp"]))


def test_vocab_parallel_embedding(tp_job):
    inp, out = tp_job
    emb = _ref_layer(JPL.VocabParallelEmbedding(V, H), inp, "emb.")
    _check(out, "emb", ["emb"], *_ref_run([emb], inp["ids"], inp["w_mlp"]))


def test_parallel_cross_entropy(tp_job):
    inp, out = tp_job
    z = paddle.to_tensor(inp["logits"])
    z.stop_gradient = False
    loss = JPL.ParallelCrossEntropy()(z, paddle.to_tensor(
        inp["labels"].astype(np.int32)))
    loss.backward()
    dz = np.asarray(z.grad._value)
    for _, v in out:
        assert v["ce"] == pytest.approx(float(loss._value), rel=1e-5)
    np.testing.assert_allclose(
        np.concatenate([a["ce.dz"] for a, _ in out], -1), dz, **TOL)


def test_shards_specs_and_hygiene(tp_job):
    _, out = tp_job
    for _, v in out:
        assert v["shapes.col."] == {"weight": [H, F // 2],
                                    "bias": [F // 2]}
        assert v["shapes.row."] == {"weight": [F // 2, H], "bias": [H]}
        assert v["shapes.emb."] == {"weight": [V // 2, H]}
        assert v["specs"] == {
            "col": [[None, "tp"], ["tp"], [None, None, "tp"], []],
            "row": [["tp", None], [], []], "emb": [["tp", None]]}
        assert v["foreign_modules"] == []


def test_tensor_parallel_accounting(tp_job):
    """Forward and backward of the mlp: the row product's all-reduce
    [2, 16, 64] forward and the column input's all-reduce backward."""
    b = 2 * 16 * H * 4
    for _, v in tp_job[1]:
        assert v["mlp_stats"]["ops"] == {"all_reduce": 2}
        assert v["mlp_stats"]["bytes"] == {"all_reduce": 2 * b}


# ---------------------------------------------------------------------------
# degree 1: today's dense layers, bit for bit
# ---------------------------------------------------------------------------
@pytest.fixture(params=["no_mesh", "tp1"])
def degree1(request):
    tmesh.set_mesh(tmesh.create_mesh({"tp": 1})
                   if request.param == "tp1" else None)
    yield
    tmesh.set_mesh(None)


@pytest.mark.parametrize("kind", ["column", "row", "embedding"])
def test_degree1_layers_are_the_dense_layers_bitwise(degree1, kind):
    x = torch.from_numpy(np.random.RandomState(2).randn(3, 5, 32)
                         .astype(np.float32))
    make = {"column": (lambda: PL.ColumnParallelLinear(32, 48,
                                                       device="cpu"),
                       lambda: Linear(32, 48, device="cpu")),
            "row": (lambda: PL.RowParallelLinear(32, 48, device="cpu"),
                    lambda: Linear(32, 48, device="cpu")),
            "embedding": (lambda: PL.VocabParallelEmbedding(
                32, 16, device="cpu"),
                lambda: Embedding(32, 16, device="cpu"))}[kind]
    tseed(7)
    a = make[0]()
    tseed(7)
    b = make[1]()
    for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                  b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    inp = torch.randint(0, 32, (3, 5)) if kind == "embedding" else x
    assert torch.equal(a(inp), b(inp))


def test_degree1_cross_entropy_matches_reference(degree1):
    inp = _inputs()
    want = JF.cross_entropy(paddle.to_tensor(inp["logits"]),
                            paddle.to_tensor(inp["labels"].astype(np.int32)),
                            reduction="mean")
    got = PL.ParallelCrossEntropy()(torch.from_numpy(inp["logits"]),
                                    torch.from_numpy(inp["labels"]))
    assert float(got) == pytest.approx(float(want._value), rel=1e-6)


def test_degree1_shard_is_the_whole_state(degree1):
    tseed(1)
    net = tgpt.gpt_tiny(device="cpu")
    state = tgpt.state_to_numpy(net)
    shard = PL.shard_reference_state(net, state)
    assert set(shard) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(shard[k], v)
