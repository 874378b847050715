"""BERT in the port's ``HybridPipelineTrainer`` and ``compile_train_step``
on gloo ranks (CPU), held against the JAX package (worker
``tests/data/torch_dist_worker.py``'s ``bert`` job, the JAX side from
``tests/data/torch_hybrid_oracle.py``).

- The oracle ``TestBertHybrid`` (``tests/test_hybrid_models.py:35-61``),
  its first case: bert_tiny at tp 2 x pp 2, ``n_micro`` 2, ``SGD(0)``:
  the step-0 loss equals the JAX trainer's at the same mesh and the
  reference's eager full-batch loss, both at rtol 1e-5 (the oracle's own
  bound is 2e-2).
- The two-term loss over cut batches. BERT's loss is the masked
  positions' mean CE plus the rows' mean NSP CE of the GLOBAL batch (the
  reference's head runs once over it). On a batch whose rows mask from 1
  to 16 of their 32 positions, so that every micro-batch and dp slice
  masks a different number, at dp 2 (``n_micro`` 2) and dp 2 x pp 2, f32
  and lr 0, the trainer's loss equals the eager full-batch loss at rtol
  1e-5. With the model's ``pipeline_loss_totals`` hidden (equal shares of
  per-part means) the same runs miss it by more than 1e-3 (measured 2.3%
  at dp 2 and 0.53% at dp 2 x pp 2), so the check can see the trap; the
  model's init is widened (``initializer_range`` 0.5) so that the
  positions' CE spread over several nats and the parts' means differ.
  ``compile_train_step`` at dp 2 with two micro-batches equals the JAX
  ``compile_train_step`` (the mean of the micro-batches' global
  losses).
- ``SGD`` with the global-norm clip on the ZeRO routes at dp 2: the flat
  slab of ``qcomm.dp_zero_step`` (ZeRO 1 and 2) and the per-parameter
  ``_add_axis`` route (ZeRO 3), and at sp 2 (every sp rank runs the
  whole sequence, its head's gradient is 1/sp of the loss's): 3 steps,
  losses at rtol 1e-5 and parameters at atol 1e-5 against the JAX
  trainer at degree 1.
- ``mlm_bias`` is vocab-sharded at tp 2 (``P("tp")``): the gathered state
  after the steps has every parameter whole.
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

#: a wide init, so that the masked positions' CE spread over several nats
#: and the means of parts that mask different numbers differ
CFG = dict(oracle.BERT_CFG, initializer_range=0.5)
SEED = 5
RTOL = 1e-5
SGD_LR, SGD_CLIP = 0.5, 0.5


def _uneven_batch():
    """One global [8, 32] batch whose rows mask 1 to 16 positions."""
    tok, tt, mlm, nsp = oracle.bert_batches(1, 8, 32, seed=21, rate=0.0)
    r = np.random.RandomState(22)
    for row, n in enumerate((16, 1, 3, 12, 2, 9, 5, 14)):
        at = r.choice(32, n, replace=False)
        mlm[0, row, at] = r.randint(0, 128, n)
    return tok, tt, mlm, nsp


@pytest.fixture(scope="module")
def ref():
    return oracle.bert_ref_state(CFG, SEED)


def _run(tmp_path, nranks, state, batches, cases):
    res = oracle.run_job(tmp_path, "bert", nranks, oracle.bert_inputs(
        state, CFG, batches, cases=json.dumps(cases)))
    oracle.foreign_free(res)
    return res


@pytest.fixture(scope="module")
def four(tmp_path_factory, ref):
    """4 ranks: tp 2 x pp 2 on the oracle's batch, then the uneven batch
    at dp 2 x pp 2 with the global loss and with equal shares."""
    _, state = ref
    hyb = oracle.bert_batches(1, 8, 32, seed=3)
    uneven = _uneven_batch()
    batches = tuple(np.concatenate([a, b]) for a, b in zip(hyb, uneven))
    cases = [dict(name="tp2pp2", mesh={"tp": 2, "pp": 2}, n_micro=2)]
    for eq in (False, True):
        cases.append(dict(name="dp2pp2" + ("_eq" if eq else ""),
                          mesh={"dp": 2, "pp": 2}, n_micro=2,
                          equal_shares=eq, first=1))
    return _run(tmp_path_factory.mktemp("bert4"), 4, state, batches,
                cases), batches


@pytest.fixture(scope="module")
def two(tmp_path_factory, ref):
    """2 ranks: the uneven batch at dp 2 (global loss, equal shares,
    compile_train_step), then SGD on the ZeRO routes and at sp 2."""
    _, state = ref
    uneven = _uneven_batch()
    sgd = oracle.bert_batches(3, 8, 32, seed=31)
    batches = tuple(np.concatenate([a, b]) for a, b in zip(uneven, sgd))
    sgd_kw = dict(opt="sgd", lr=SGD_LR, clip=SGD_CLIP, steps=3, first=1)
    cases = [dict(name="dp2", mesh={"dp": 2}, n_micro=2),
             dict(name="dp2_eq", mesh={"dp": 2}, n_micro=2,
                  equal_shares=True),
             dict(name="dp2_compile", mesh={"dp": 2}, trainer="compile",
                  accumulate=2),
             dict(name="dp2_z1", mesh={"dp": 2}, zero=1, **sgd_kw),
             dict(name="dp2_z2", mesh={"dp": 2}, zero=2, **sgd_kw),
             dict(name="dp2_z3", mesh={"dp": 2}, zero=3, **sgd_kw),
             dict(name="sp2", mesh={"sp": 2}, **sgd_kw)]
    return _run(tmp_path_factory.mktemp("bert2"), 2, state, batches,
                cases), batches


def _one(batches, i):
    return tuple(b[i] for b in batches)


def test_tp2_pp2_step0_loss_matches_reference(four, ref):
    res, batches = four
    net, _ = ref
    batch = _one(batches, 0)
    eager = oracle.bert_eager_loss(net, batch)
    _, jl, _ = oracle.jax_bert_train(CFG, {"tp": 2, "pp": 2},
                                     tuple(b[:1] for b in batches), 1, SEED,
                                     n_micro=2)
    np.testing.assert_allclose(jl[0], eager, rtol=RTOL)
    for _, values in res:
        np.testing.assert_allclose(values["tp2pp2.losses"][0], jl[0],
                                   rtol=RTOL)
        np.testing.assert_allclose(values["tp2pp2.losses"][0], eager,
                                   rtol=RTOL)
        # mlm_bias and the word table come back whole from their shards
        assert values["tp2pp2.whole"] is True


def test_uneven_batch_masks_differ_by_part():
    _, _, mlm, _ = _uneven_batch()
    per_row = np.sum(mlm[0] != -100, 1)
    # micro-batch i of dp rank r holds rows [4i + 2r, 4i + 2r + 2)
    parts = [per_row[a:a + 2].sum() for a in range(0, 8, 2)]
    assert len(set(parts)) == 4, parts


@pytest.mark.parametrize("mesh,fixture", [("dp2", "two"),
                                          ("dp2pp2", "four")])
def test_global_two_term_loss_over_cut_batches(mesh, fixture, request, ref):
    res, batches = request.getfixturevalue(fixture)
    net, _ = ref
    i = 1 if fixture == "four" else 0
    eager = oracle.bert_eager_loss(net, _one(batches, i))
    step = 0
    for _, values in res:
        got = values[f"{mesh}.losses"][step]
        np.testing.assert_allclose(got, eager, rtol=RTOL)
        eq = values[f"{mesh}_eq.losses"][step]
        assert abs(eq - eager) > 1e-3 * abs(eager), (eq, eager)


def test_compile_train_step_at_dp2_matches_reference(two):
    res, batches = two
    _, jl, _ = oracle.jax_bert_train(CFG, {"dp": 1},
                                     tuple(b[:1] for b in batches), 1, SEED,
                                     trainer="compile", accumulate=2)
    for _, values in res:
        np.testing.assert_allclose(values["dp2_compile.losses"], jl,
                                   rtol=RTOL)


@pytest.fixture(scope="module")
def sgd_ref(two):
    _, batches = two
    return oracle.jax_bert_train(CFG, {"dp": 1}, tuple(b[1:] for b in batches),
                                 3, SEED, opt="sgd", lr=SGD_LR, clip=SGD_CLIP)


@pytest.mark.parametrize("name", ["dp2_z1", "dp2_z2", "dp2_z3", "sp2"])
def test_sgd_on_the_update_routes_matches_reference(two, sgd_ref, name):
    res, _ = two
    state0, jl, final = sgd_ref
    arrays, values = res[0]
    assert values[f"{name}.zero_manual"] == (name in ("dp2_z1", "dp2_z2"))
    if name == "dp2_z3":
        assert any(n.startswith("bert.blocks.")
                   for n in values[f"{name}.dp_sliced"])
    for _, v in res:
        np.testing.assert_allclose(v[f"{name}.losses"], jl, rtol=RTOL)
    moved = 0.0
    for n, w in final.items():
        np.testing.assert_allclose(arrays[f"{name}.param.{n}"], w, rtol=0,
                                   atol=oracle.PARAM_ATOL, err_msg=n)
        moved = max(moved, float(np.abs(w - state0[n]).max()))
    assert moved > 100 * oracle.PARAM_ATOL, moved
