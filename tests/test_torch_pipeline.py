"""The port's pipeline (``distributed/pipeline.py``) and the hybrid
trainer at ``pp`` 2 on 2 gloo ranks (CPU).

- ``pipeline_apply`` with the GPipe and the interleaved schedule (4
  micro-batches, 4 layers of ``tanh(h @ W)``; at pp 1 too, on
  ``stack_block_params``' stack) equals the sequential stack: the
  head's loss, every layer's gradient (on its stage), the stage aux
  summed over pp and averaged over micro-batches, and the shared output
  without a head on both ranks. Each step issues
  ``v·n_micro + pp − 1`` permutes forward and as many backward.
- The two error messages equal the reference's; an interleaved trainer
  at lr 0 gives back its state (``sync_to_layer`` and
  ``gather_reference_state``, whose pp cut takes each block from its
  stage).
- ``GPTHybridTrainer`` at ``{"dp": 1, "pp": 2}``, GPipe (n_micro 2) and
  interleaved (v 2, n_micro 2), against the JAX package's trainer at the
  same mesh: losses at rtol 1e-5, gathered parameters at atol 1e-5 where
  the step-0 gradient is clear of zero, over 3 AdamW steps with
  ``ClipGradByGlobalNorm(1.0)``. Step 0's gradients on each stage equal
  the reference's; the tied ``wte``'s is the sum of stage 0's embedding
  gradient and the last stage's head gradient. Rank s, circuit c holds
  exactly the reference layers ``c·pp·lps_v + s·lps_v + j``.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

_spec = importlib.util.spec_from_file_location(
    "torch_hybrid_oracle", os.path.join(os.path.dirname(__file__), "data",
                                        "torch_hybrid_oracle.py"))
oracle = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(oracle)

PP = {"dp": 1, "pp": 2}
CASES = [dict(name="gpipe", mesh=PP, n_micro=2, grads=True),
         dict(name="inter", mesh=PP, n_micro=2, v_virtual=2, grads=True)]
L, H, B, N_MICRO = 4, 8, 8, 4


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    _, state = oracle.ref_state()
    res = oracle.run_job(tmp_path_factory.mktemp("hybrid_pp"), "hybrid", 2,
                         oracle.inputs(state, cases=json.dumps(CASES)))
    oracle.foreign_free(res)
    return res


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    _, state = oracle.ref_state()
    r = np.random.RandomState(4)
    inp = oracle.inputs(state, w=(r.randn(L, H, H) * 0.5).astype(np.float32),
                        x=r.randn(B, H).astype(np.float32),
                        g=r.randn(B, H).astype(np.float32))
    res = oracle.run_job(tmp_path_factory.mktemp("pipe"), "pipe", 2, inp)
    oracle.foreign_free(res)
    return inp, res


def _sequential(w, x, g):
    """The stack on the whole batch: (loss, aux, dW, output)."""
    import torch

    w = torch.from_numpy(w).requires_grad_()
    h = torch.from_numpy(x)
    aux = torch.zeros(())
    for mb in h.chunk(N_MICRO):
        for j in range(L):
            mb = torch.tanh(mb @ w[j])
            aux = aux + mb.square().mean()
    out = h
    for j in range(L):
        out = torch.tanh(out @ w[j])
    loss = (out * torch.from_numpy(g)).sum()
    aux = aux / N_MICRO
    (loss + aux).backward()
    return float(loss), float(aux), w.grad.numpy(), out.detach().numpy()


@pytest.mark.parametrize("v", [1, 2])
def test_pipeline_apply_equals_sequential_stack(units, v):
    inp, res = units
    loss, aux, dw, out = _sequential(inp["w"], inp["x"], inp["g"])
    held = set()
    for rank, (arrays, values) in enumerate(res):
        np.testing.assert_allclose(values[f"v{v}.loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(values[f"v{v}.aux"], aux, rtol=1e-5)
        np.testing.assert_allclose(arrays[f"v{v}.out"], out, rtol=1e-5,
                                   atol=1e-6)
        circ = values[f"v{v}.circuits"]
        grad = arrays[f"v{v}.grad"].reshape((-1, H, H))
        for i, layer in enumerate(l for c in circ for l in c):
            np.testing.assert_allclose(grad[i], dw[layer], rtol=1e-4,
                                       atol=1e-6, err_msg=str(layer))
            held.add(layer)
        # the permutes of one step: v·n_micro + pp − 1 each way
        ops = values[f"v{v}.stats"]["ops"]
        assert ops["collective_permute"] == 2 * (v * N_MICRO + 1), ops
    assert held == set(range(L))


@pytest.mark.parametrize("v", [1, 2])
def test_pipeline_apply_one_stage_equals_sequential_stack(units, v):
    """pp 1 (no ranks): the micro-batches through every circuit in turn,
    on ``stack_block_params``' stack; the aux over micro-batches."""
    import torch

    from paddle_tpu_torch.distributed.mesh import create_mesh
    from paddle_tpu_torch.distributed.pipeline import (pipeline_apply,
                                                       stack_block_params)

    inp, _ = units
    loss, aux, dw, out = _sequential(inp["w"], inp["x"], inp["g"])
    layers = [{"w": torch.from_numpy(w).requires_grad_()}
              for w in inp["w"]]
    stacked = stack_block_params(layers)
    params = stacked["w"].reshape((v, L // v, H, H)) if v > 1 \
        else stacked["w"]

    def stage_fn(p, h):
        a = torch.zeros(())
        for j in range(p.shape[0]):
            h = torch.tanh(h @ p[j])
            a = a + h.square().mean()
        return h, a

    got, got_aux = pipeline_apply(
        create_mesh({"dp": 1, "pp": 1}), stage_fn, params,
        torch.from_numpy(inp["x"]), N_MICRO, v_virtual=v, stage_aux=True,
        head_fn=lambda full: (full * torch.from_numpy(inp["g"])).sum())
    (got + got_aux).backward()
    np.testing.assert_allclose(float(got), loss, rtol=1e-5)
    np.testing.assert_allclose(float(got_aux), aux, rtol=1e-5)
    for layer, d in zip(layers, dw):
        np.testing.assert_allclose(layer["w"].grad.numpy(), d, rtol=1e-4,
                                   atol=1e-6)


def test_pipeline_errors_equal_the_reference(units):
    import jax

    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet import DistributedStrategy
    from paddle_tpu.distributed.hybrid import HybridPipelineTrainer
    from paddle_tpu.distributed.pipeline import pipeline_apply

    _, res = units
    values = res[0][1]
    net, _ = oracle.ref_state()
    opt = paddle.optimizer.SGD(0.0, parameters=net.parameters())
    mesh = oracle.jax_mesh(PP)
    with pytest.raises(ValueError) as e:
        HybridPipelineTrainer(net, opt, DistributedStrategy(), mesh,
                              v_virtual=4)
    assert values["divisible_error"] == str(e.value)
    with pytest.raises(ValueError) as e:
        pipeline_apply(mesh, lambda p, h: h, {"w": jax.numpy.zeros((2, 1))},
                       jax.numpy.zeros((4, 2)), 1, v_virtual=2)
    assert values["n_micro_error"] == str(e.value)


def test_interleaved_sync_to_layer_round_trip(units):
    """lr 0: the gathered state is the initial one; then each stage loads
    its own blocks of another whole state (``shard_reference_state``'s
    pp cut: stage s, circuits 0 and 1 of lps_v 1 hold layers s and s +
    2) and the gather gives that state back."""
    inp, res = units
    state = {k[6:]: v for k, v in inp.items() if k.startswith("state.")}
    for rank, (arrays, values) in enumerate(res):
        assert values["shard_blocks"] == [rank, rank + 2]
        for n, a in state.items():
            np.testing.assert_allclose(arrays[f"roundtrip.{n}"], a,
                                       rtol=1e-6, atol=1e-6, err_msg=n)
            np.testing.assert_allclose(arrays[f"reload.{n}"], a + 1.0,
                                       rtol=1e-6, atol=1e-6, err_msg=n)


@pytest.fixture(scope="module")
def g0():
    _, state = oracle.ref_state()
    return oracle.ref_grads(state, oracle.tokens()[0])[1]


@pytest.mark.parametrize("name,kw", [("gpipe", dict(n_micro=2)),
                                     ("inter", dict(n_micro=2,
                                                    v_virtual=2))])
def test_pp2_matches_reference(port, g0, name, kw):
    state0, losses, final, _ = oracle.jax_train(PP, **kw)
    for rank, (arrays, values) in enumerate(port):
        np.testing.assert_allclose(values[f"{name}.losses"], losses,
                                   rtol=oracle.LOSS_RTOL)
    oracle.assert_params(port[0][0], final, state0, g0,
                         prefix=f"{name}.param.")


@pytest.mark.parametrize("name", ["gpipe", "inter"])
def test_pp2_stage_gradients_and_tied_wte(port, g0, name):
    """Step 0's gradients (summed over pp) equal the reference's; the
    tied wte's on both stages is stage 0's embedding gradient plus the
    last stage's head gradient."""
    seen = set()
    for arrays, values in port:
        for k, a in arrays.items():
            if not k.startswith(f"{name}.grad."):
                continue
            n = k[len(f"{name}.grad."):]
            seen.add(n)
            np.testing.assert_allclose(a, g0[n], rtol=1e-4, atol=2e-6,
                                       err_msg=n)
    assert seen == set(g0)
    wte = "embeddings.wte.weight"
    parts = [arrays[f"{name}.wte_part"] for arrays, _ in port]
    for arrays, _ in port:
        np.testing.assert_allclose(arrays[f"{name}.grad.{wte}"], g0[wte],
                                   rtol=1e-4, atol=2e-6)
    # stage 0's embedding part and the last stage's head part: each far
    # from the whole, their sum the reference's
    np.testing.assert_allclose(parts[0] + parts[1], g0[wte], rtol=1e-4,
                               atol=2e-6)
    for part in parts:
        assert np.abs(part - g0[wte]).max() > 100 * 2e-6
    # the clip's global norm: block gradients summed over pp, the others
    # once
    norm = np.sqrt(sum(float(np.square(g.astype(np.float64)).sum())
                       for g in g0.values()))
    for _, values in port:
        np.testing.assert_allclose(values[f"{name}.grad_norm"], norm,
                                   rtol=1e-5)


@pytest.mark.parametrize("name,v", [("gpipe", 1), ("inter", 2)])
def test_stage_holds_the_reference_layers(port, name, v):
    lps_v = oracle.CFG["num_layers"] // (2 * v)
    for s, (_, values) in enumerate(port):
        want = [[c * 2 * lps_v + s * lps_v + j for j in range(lps_v)]
                for c in range(v)]
        assert values[f"{name}.circuits"] == want
        blocks = {int(n.split(".")[1]) for n in values[f"{name}.held"]
                  if n.startswith("blocks.")}
        assert blocks == {l for c in want for l in c}


def test_pipeline_scopes_nest_and_restore():
    """``distributed.context``'s pipeline scopes keep the reference's
    contract: they nest and restore, the getters return what the scope
    set, and ``nested_kernel_shard`` gives None outside a scope (and
    ``fn`` itself inside one: a rank of the port needs no nesting)."""
    from paddle_tpu.distributed import context as jctx
    from paddle_tpu_torch.distributed import context as tctx
    from paddle_tpu_torch.distributed.mesh import create_mesh

    mesh = create_mesh({"dp": 1, "pp": 1})

    def fn(x):
        return x

    for ctx, m in ((tctx, mesh), (jctx, object())):
        assert ctx.current_pipeline_auto_axes() is None
        assert ctx.in_partial_manual_region() is False
        assert ctx.nested_kernel_shard(fn, (), ()) is None
        with ctx.pipeline_auto_axes_scope(m, ["dp", "tp"]):
            assert ctx.current_pipeline_auto_axes() == (m, ("dp", "tp"))
            with ctx.pipeline_auto_axes_scope(m, ("dp",)):
                assert ctx.current_pipeline_auto_axes() == (m, ("dp",))
            assert ctx.current_pipeline_auto_axes() == (m, ("dp", "tp"))
        assert ctx.current_pipeline_auto_axes() is None
    with tctx.pipeline_auto_axes_scope(mesh, ("dp",)):
        assert tctx.nested_kernel_shard(fn, (), ()) is fn
        assert tctx.in_partial_manual_region() is False
