"""The port's int8 half of ``distributed/qcomm.py`` held against the JAX
package's: the blockwise quantizers bit for bit, the int8 ring on 2 and
4 gloo ranks (CPU) against the reference's ring under ``shard_map`` on
the conftest's virtual CPU devices, and ``dp_grad_comm="int8"`` in both
trainers at ``{"dp": 2}``, ZeRO 0, 1 and 2, for 3 steps against the JAX
trainers at the same mesh.

The reference's ``tests/test_qcomm.py::TestQuantizedDPTraining``
``::test_loss_curve_parity`` and ``::test_collective_bytes_bound_and_
dtype_gauges`` are red reference pins (ROADMAP queue 3 item
3): the port is held to the reference FUNCTIONS' outputs here (its
trainers and its ring), not to those pins.

Tolerances:
- quantizers: bit-equal (``amax / 127``, round half to even, clip at
  ±127, as the reference's source).
- the ring halves, the all-reduce and the tree: within the reference's
  bound (``distributed/qcomm.py``'s docstring): one quantization step a
  hop, plus one for the gather, a step being the block's largest
  partial-sum magnitude / 127 (bounded here by the block's sum of |x|
  over the ranks). Not bit for bit: inside the reference's compiled
  ``shard_map`` ring XLA turns ``amax / 127`` into ``amax * f32(1/127)``
  and contracts the dequantize-and-add into one FMA, an ulp from the
  source arithmetic the port computes, and an ulp can move a rounding
  by a step.
- trainers: the port fuses the gradients in its parameter order, the
  reference in its stacked-block order, so the quantization blocks hold
  other elements and each element's error is another draw within the
  bound (one step of ``amax_block / 127`` a hop, plus one for the
  gather: ``tests/test_qcomm.py``'s bound). An element whose gradient
  lies within a step of zero may take its Adam step either way, so
  parameters after 3 AdamW steps (lr 1e-3) are at most 2·lr a step
  apart (plus a step of the block's amax / 127 a step with the int8
  return), and the share of elements within 2e-4 of the reference's is
  held to within 0.15 of the same share between the reference's own
  int8 and f32 runs (how far quantization alone moves them; measured
  0.83 against 0.97 at worst, a 64-element LayerNorm weight), or to
  0.75 where that is higher (not with the int8 return, whose rounding
  of every parameter dominates; the bound above holds there). Losses at rtol 2e-3 (step 0, before any
  update: 1e-5), and the port's int8 losses within 2e-2 of the
  reference's f32 run (the reference's ``test_loss_curve_parity``
  bound).
- counted bytes: exactly the reference's formula, ``(N-1)/N·T + T`` int8
  bytes plus ``4·T/block`` f32 scale bytes a hop and in the gather.
"""
import functools
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from paddle_tpu.distributed import qcomm as jq
from paddle_tpu.distributed._compat import shard_map
from paddle_tpu_torch.distributed import qcomm as tq

_spec = importlib.util.spec_from_file_location(
    "torch_hybrid_oracle", os.path.join(os.path.dirname(__file__), "data",
                                        "torch_hybrid_oracle.py"))
oracle = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(oracle)

DP = {"dp": 2}
BLOCK = 128
#: the share of parameter elements within 2e-4 of the reference's
SHARE = 0.9


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------
def _q_inputs():
    r = np.random.RandomState(0)
    x = (r.randn(4096) * 3).astype(np.float32)
    x[:BLOCK] = 0.0                                   # an all-zero block
    x[200] = 1e4                                      # an outlier block
    # .5 ties: amax 127 makes the scale 1, so k + 0.5 rounds to even
    x[1024:1024 + BLOCK] = np.linspace(-10, 10, BLOCK)
    x[1024] = 127.0
    x[1030:1036] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5]
    return x


@pytest.mark.parametrize("block", [64, 128, 2048])
def test_quantizers_bit_equal_to_reference(block):
    x = _q_inputs()
    qj, sj = jq.quantize_blockwise(jnp.asarray(x), block)
    qt, st = tq.quantize_blockwise(torch.from_numpy(x), block)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(
        tq.dequantize_blockwise(qt, st, block).numpy(),
        np.asarray(jq.dequantize_blockwise(qj, sj, block)))


def test_quantizer_edge_blocks():
    x = _q_inputs()
    q, s = tq.quantize_blockwise(torch.from_numpy(x), BLOCK)
    assert float(s[0]) == 0.0 and int(q[:BLOCK].abs().max()) == 0
    assert q[1030:1036].tolist() == [0, 2, 2, 0, -2, -2]   # half to even
    back = tq.dequantize_blockwise(q, s, BLOCK).numpy()
    # the outlier costs its own block's precision only
    assert np.abs(back[256:512] - x[256:512]).max() <= \
        float(s[2:4].max()) / 2 + 1e-7


def test_zero_chunk_len_and_validation():
    assert tq.zero_chunk_len(64, 8, 4) == jq.zero_chunk_len(64, 8, 4) == 8
    assert tq.zero_chunk_len(65, 8, 4) == jq.zero_chunk_len(65, 8, 4)
    assert tq.zero_chunk_len(1, 8, 2048) == 2048
    with pytest.raises(ValueError):
        tq.quantized_all_reduce(torch.ones(8), None, 0)
    with pytest.raises(ValueError):
        tq.quantized_all_reduce(torch.ones(8), None, 2, block=0)
    x = torch.arange(8.0)
    assert torch.equal(tq.quantized_all_reduce(x, None, 1), x)


def test_validation_errors_match_reference():
    from paddle_tpu_torch.distributed.mesh import Mesh

    class _M:
        def __init__(self, shape):
            self.shape = shape

    def both(fn, *a, **k):
        errs = []
        for mod in (jq, tq):
            with pytest.raises(Exception) as e:
                getattr(mod, fn)(*a, **k)
            errs.append((type(e.value), str(e.value)))
        assert errs[0] == errs[1], errs

    both("validate_dp_grad_comm", "int4", _M({"dp": 2}))
    both("validate_dp_grad_comm", "int8", _M({"dp": 2, "tp": 2}))
    both("validate_dp_grad_comm", "int8", _M({"dp": 2}), zero_stage=3)
    both("validate_dp_grad_comm", "int8", _M({"dp": 2}), block=0)
    both("validate_dp_grad_comm", "int8", _M({"dp": 2}),
         unsupported=(("stream_layers", True),))
    both("validate_dp_param_comm", "f16", True)
    both("validate_dp_param_comm", "int8", False)
    for z in (0, 1, 2):
        tq.validate_dp_grad_comm("int8", _M({"dp": 8}), zero_stage=z)
    tq.validate_dp_param_comm("int8", True)
    assert Mesh  # the port's mesh class is what the trainers pass


# ---------------------------------------------------------------------------
# the ring at 2 and 4 ranks
# ---------------------------------------------------------------------------
def _ring_inputs(n):
    r = np.random.RandomState(n)
    return dict(x=(r.randn(n, n * 3 * BLOCK) * 2).astype(np.float32),
                y=(r.randn(n, 1000) * 3).astype(np.float32),
                ta=r.randn(n, 17, 5).astype(np.float32),
                tb=r.randn(n, 33).astype(np.float32),
                w=r.randn(6).astype(np.float32),
                xb=r.randn(8, 6).astype(np.float32),
                yb=r.randn(8).astype(np.float32), block=BLOCK)


@pytest.fixture(scope="module", params=[2, 4])
def ring(request, tmp_path_factory):
    n = request.param
    inp = _ring_inputs(n)
    res = oracle.run_job(tmp_path_factory.mktemp(f"qring{n}"), "qring", n,
                         inp)
    oracle.foreign_free(res)
    return n, inp, res


def _smap(n, fn, out_spec=JP("dp")):
    return jax.jit(shard_map(fn, mesh=oracle.jax_mesh({"dp": n}),
                             in_specs=(JP("dp"),), out_specs=out_spec,
                             check_vma=False))


def _step_bound(x, block):
    """Per element: one quantization step of its block, the block's
    largest possible partial sum (the sum of |x| over the ranks) / 127."""
    amax = np.abs(x).sum(0).reshape(-1, block).max(1) / 127
    return np.repeat(amax, block)


def test_ring_halves_within_bound_of_reference(ring):
    n, inp, res = ring
    x = jnp.asarray(inp["x"])
    rs = np.asarray(_smap(n, lambda xs: jq.quantized_reduce_scatter(
        xs[0], "dp", n, block=BLOCK)[None])(x))
    rs_mean = np.asarray(_smap(n, lambda xs: jq.quantized_reduce_scatter(
        xs[0], "dp", n, block=BLOCK, mean=True)[None])(x))
    ag = np.asarray(_smap(n, lambda xs: jq.quantized_all_gather(
        jq.quantized_reduce_scatter(xs[0], "dp", n, block=BLOCK), "dp",
        block=BLOCK)[None])(x))
    step = _step_bound(inp["x"], BLOCK).reshape(n, -1)
    exact = inp["x"].sum(0).reshape(n, -1)
    for r, (arrays, _) in enumerate(res):
        assert np.all(np.abs(arrays["rs"] - rs[r]) <= (n - 1) * step[r])
        assert np.all(np.abs(arrays["rs_mean"] - rs_mean[r])
                      <= (n - 1) * step[r] / n)
        assert np.all(np.abs(arrays["ag"] - ag[r])
                      <= n * step.reshape(-1))
        # and the sum both approximate
        assert np.all(np.abs(arrays["rs"] - exact[r]) <= (n - 1) * step[r])


def test_all_reduce_and_tree_within_bound_of_reference(ring):
    n, inp, res = ring
    ar = np.asarray(_smap(n, lambda ys: jq.quantized_all_reduce(
        ys[0], "dp", n, block=BLOCK, mean=True)[None])(
        jnp.asarray(inp["y"])))
    mesh = oracle.jax_mesh({"dp": n})
    tree = jax.jit(shard_map(
        lambda a, b: jq.quantized_all_reduce_tree(
            {"a": a[0], "b": b[0]}, "dp", n, block=64),
        mesh=mesh, in_specs=(JP("dp"), JP("dp")), out_specs=JP(),
        check_vma=False))(jnp.asarray(inp["ta"]),
                          jnp.asarray(inp["tb"]).astype(jnp.bfloat16))
    y = inp["y"]
    pad = n * tq.zero_chunk_len(y.shape[1], n, BLOCK) - y.shape[1]
    step = _step_bound(np.pad(y, ((0, 0), (0, pad))), BLOCK)[:y.shape[1]]
    flat = np.concatenate([inp["ta"].reshape(n, -1), inp["tb"]], 1)
    pad = n * tq.zero_chunk_len(flat.shape[1], n, 64) - flat.shape[1]
    tstep = _step_bound(np.pad(flat, ((0, 0), (0, pad))), 64)
    for arrays, values in res:
        assert np.all(np.abs(arrays["ar"] - ar[0]) <= n * step / n)
        assert np.all(np.abs(arrays["tree_a"] - np.asarray(tree["a"]))
                      .reshape(-1) <= n * tstep[:85])
        # bf16 leaves: the bound plus one bf16 rounding of either side
        tb = np.asarray(tree["b"].astype(jnp.float32))
        assert np.all(np.abs(arrays["tree_b"] - tb) <= n * tstep[85:118]
                      + 2 ** -7 * np.abs(tb))
        assert values["tree_dtypes"] == ["torch.float32", "torch.bfloat16"]


def test_all_reduce_counted_bytes_match_the_formula(ring):
    """(N-1)/N·T + T int8 bytes and 4·T/block f32 scale bytes a hop and
    in the gather (T the padded buffer), against the f32 all-reduce's
    4T: at most 0.55x."""
    n, inp, res = ring
    T = n * tq.zero_chunk_len(inp["y"].shape[1], n, BLOCK)
    for _, values in res:
        st = values["ar_stats"]
        kd = st["bytes_by_kind_dtype"]
        assert kd["collective_permute"]["i8"] == (n - 1) * T // n
        assert kd["collective_permute"]["f32"] == \
            4 * (n - 1) * T // (n * BLOCK)
        assert kd["all_gather"]["i8"] == T
        assert kd["all_gather"]["f32"] == 4 * T // BLOCK
        assert st["total_bytes"] <= 0.55 * 4 * T


def test_dp_quantized_value_and_grads(ring):
    """Each rank's loss and gradient of its batch slice, the loss pmean'd
    and the gradient through the ring: the reference's wrap on the same
    slices (its shard_map); the gradient within the ring's bound."""
    n, inp, res = ring
    mesh = oracle.jax_mesh({"dp": n})

    def fn(w, key, batch):
        xb, yb = batch
        loss, g = jax.value_and_grad(
            lambda w_: jnp.mean((xb @ w_ - yb) ** 2))(w)
        return loss, {"n": jnp.asarray(xb.shape[0])}, {"w": g}

    batch = (jnp.asarray(inp["xb"]), jnp.asarray(inp["yb"]))
    loss, aux, grads = jax.jit(lambda w, *b: jq.dp_quantized_value_and_grads(
        mesh, n, 64, fn, w, b, (JP("dp"), JP("dp")),
        jax.random.PRNGKey(0)))(jnp.asarray(inp["w"]), *batch)
    g = np.asarray(grads["w"])
    for arrays, values in res:
        assert values["vg_rows"] == 8 // n == int(aux["n"])
        np.testing.assert_allclose(values["vg_loss"], float(loss),
                                   rtol=1e-6)
        # n steps of the largest per-rank gradient magnitude / 127
        assert np.all(np.abs(arrays["vg_grad"] - g)
                      <= n * n * np.abs(g).max() / 127 + 1e-6)


# ---------------------------------------------------------------------------
# the trainers at dp 2
# ---------------------------------------------------------------------------
CASES = ([dict(name=f"h{z}", mesh=DP, zero=z, dp_grad_comm="int8")
          for z in (0, 1, 2)]
         + [dict(name="h2_i8ret", mesh=DP, zero=2, dp_grad_comm="int8",
                 dp_param_comm="int8")]
         + [dict(name=f"c{z}", mesh=DP, zero=z, dp_grad_comm="int8",
                 trainer="compile") for z in (0, 1, 2)])


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    _, state = oracle.ref_state()
    res = oracle.run_job(tmp_path_factory.mktemp("qtrain"), "hybrid", 2,
                         oracle.inputs(state, cases=json.dumps(CASES)))
    oracle.foreign_free(res)
    return res


@pytest.fixture(scope="module")
def g0():
    _, state = oracle.ref_state()
    return oracle.ref_grads(state, oracle.tokens()[0])[1]


def _jax_compile(zero):
    """The JAX ``compile_train_step`` with int8 gradients at dp 2: (initial
    params, losses, final params)."""
    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet import DistributedStrategy
    from paddle_tpu.distributed.strategy_compiler import compile_train_step

    net, state0 = oracle.ref_state()
    opt = paddle.optimizer.AdamW(
        oracle.LR, parameters=net.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(oracle.CLIP))
    s = DistributedStrategy()
    if zero:
        s.sharding = True
        s.sharding_configs = {"sharding_stage": zero}
    tr = compile_train_step(net, opt, s, oracle.jax_mesh(DP),
                            dp_grad_comm="int8")
    losses = [float(tr.step(t)) for t in oracle.tokens()]
    net = tr.sync_to_layer()
    final = {k: np.asarray(v._value, np.float32)
             for k, v in net.state_dict().items()}
    return state0, losses, final


@functools.lru_cache(maxsize=None)
def _f32_run():
    """The reference's f32 run at dp 2 (ZeRO 0): (losses, final
    parameters)."""
    return tuple(oracle.jax_train(DP)[1:3])



def _hold(port, name, state0, losses, final, g0, noise):
    """The port's int8 run against the reference's: losses, and each
    parameter's share of elements within 2e-4 of the reference's, next
    to ``noise`` (the same share between the reference's int8 run and
    its f32 run: how far quantization alone moves the parameters)."""
    arrays, values = port[0]
    for _, v in port:
        np.testing.assert_allclose(v[f"{name}.losses"][0], losses[0],
                                   rtol=1e-5)
        np.testing.assert_allclose(v[f"{name}.losses"], losses, rtol=2e-3)
    # an element whose gradient is within a quantization step of zero
    # may take an Adam step either way: at most 2·lr a step apart
    for n, w in final.items():
        a = arrays[f"{name}.param.{n}"]
        d = np.abs(a - w)
        # an int8 return rounds every parameter to a step of its block
        qstep = oracle.STEPS * np.abs(w).max() / 127 \
            if values[f"{name}.dp_param_comm"] == "int8" else 0.0
        assert d.max() <= 2 * oracle.LR * oracle.STEPS + qstep + 1e-6, n
        if qstep:
            continue
        share = float((d <= 2e-4).mean())
        base = float((np.abs(w - noise[n]) <= 2e-4).mean())
        assert share >= min(SHARE, base) - 0.15, (n, share, base)


@pytest.mark.parametrize("zero", [0, 1, 2])
def test_hybrid_int8_matches_reference(port, g0, zero):
    state0, losses, final, _ = oracle.jax_train(DP, zero=zero,
                                                dp_grad_comm="int8")
    noise = _f32_run()[1]
    values = port[0][1]
    assert values[f"h{zero}.zero_manual"] == (zero in (1, 2))
    # the reference's default return half: bf16 on the slab route
    assert values[f"h{zero}.dp_param_comm"] == ("bf16" if zero else "f32")
    _hold(port, f"h{zero}", state0, losses, final, g0, noise)


@pytest.mark.parametrize("zero", [0, 1, 2])
def test_compile_int8_matches_reference(port, g0, zero):
    state0, losses, final = _jax_compile(zero)
    _hold(port, f"c{zero}", state0, losses, final, g0, _f32_run()[1])


def test_int8_return_half_matches_reference(port, g0):
    state0, losses, final, _ = oracle.jax_train(
        DP, zero=2, dp_grad_comm="int8", dp_param_comm="int8")
    _hold(port, "h2_i8ret", state0, losses, final, g0, _f32_run()[1])


def test_int8_losses_near_f32_and_bytes_by_the_formula(port):
    """The port's int8 run within the reference's loss-curve bound of the
    f32 run (the JAX trainer's at the same mesh), and the step's counted
    bytes: the ring's int8 payloads and scales by the formula, at most
    0.55x of the f32 ring's gradient bytes (4 bytes a chunk element)."""
    lf = _f32_run()[0]
    for _, v in port:
        lq = v["h2.losses"]
        assert lf[0] == pytest.approx(lq[0], rel=1e-5)
        for a, b in zip(lf, lq):
            assert abs(a - b) < 2e-2 * max(abs(a), 1.0), (lf, lq)
    numel = port[0][1]["h2.numel"]
    chunk = tq.zero_chunk_len(numel, 2, 2048)
    for _, v in port:
        kd = v["h2.stats"]["bytes_by_kind_dtype"]
        assert kd["collective_permute"] == {"i8": chunk,
                                            "f32": 4 * chunk // 2048}
        assert kd["all_gather"] == {"bf16": 2 * 2 * chunk}
        assert chunk + 4 * chunk // 2048 <= 0.55 * 4 * chunk
        kd0 = v["h0.stats"]["bytes_by_kind_dtype"]
        assert kd0["collective_permute"]["i8"] == chunk
        assert kd0["all_gather"]["i8"] == 2 * chunk
