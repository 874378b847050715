"""GPT at tp = 2 on 2 gloo ranks (CPU), held against the JAX package's
GPT on the same weights: the worker job ``gpt_tp``
(``tests/data/torch_dist_worker.py``) on gpt_tiny (4 heads, 2 a rank;
vocab 128, 64 a rank; dropout 0, as the reference's step-0 tests run).

- Rank r's qkv shard holds exactly heads ``[2r, 2r + 2)`` of q, k and v
  (weight and bias); ``shard_reference_state`` followed by
  ``gather_reference_state`` returns the reference state bit for bit.
- The gathered logits and the loss equal the JAX ``GPT``'s (rtol 1e-5;
  f32, the row products summed in two halves, then all-reduced) and
  every gathered gradient the reference's ``jax.grad`` (rtol = atol =
  1e-4, the port's ``GPT.loss`` gradient tolerance).
- The loss's collectives: the vocab-parallel fused loss all-reduces the
  row max (MAX) outside autograd, the sum of exponentials and the target
  logit; ``generate`` at tp > 1 raises naming ROADMAP queue 1 item 8.
- The job ``tp_rng_clip`` under the trainer at tp 2: at dropout 0.1 the
  gradients with recompute equal those without it (the checkpointed
  blocks draw the replicated regions' masks again; bitwise on the CPU),
  and the masks, the embeddings' output and the replicated parameters'
  gradients are equal on both tp ranks. With ``embeddings.wte.weight``
  frozen (no gradient), the first moments after one AdamW step are 0.1 x
  the reference's ``functional_clip`` of the gathered gradients (rtol
  1e-6, f32).
"""
import importlib.util
import os

import numpy as np

import paddle_tpu as paddle

_spec = importlib.util.spec_from_file_location(
    "torch_hybrid_oracle", os.path.join(os.path.dirname(__file__), "data",
                                        "torch_hybrid_oracle.py"))
oracle = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(oracle)


def test_gpt_at_tp2_matches_reference(tmp_path):
    jnet, state = oracle.ref_state()
    tok = oracle.tokens(1, seed=7)[0]
    res = oracle.run_job(tmp_path, "gpt_tp", 2, oracle.inputs(state,
                                                              tok=tok))
    oracle.foreign_free(res)
    jnet.eval()
    want_logits = np.asarray(jnet(paddle.to_tensor(tok))._value)
    loss, grads = oracle.ref_grads(state, tok)
    h = oracle.CFG["hidden_size"]
    for rank, (arrays, values) in enumerate(res):
        assert values["qkv_shape"] == [h, 3 * h // 2]
        assert values["qkv_heads_exact"] and values["qkv_bias_heads_exact"]
        assert values["roundtrip_names"] and values["roundtrip_exact"] == []
        np.testing.assert_allclose(arrays["logits"], want_logits,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(values["loss"], loss, rtol=1e-5)
        for n, g in grads.items():
            np.testing.assert_allclose(arrays[f"grad.{n}"], g, rtol=1e-4,
                                       atol=1e-4, err_msg=n)
        assert "item 8" in values["generate_raises"]
        ops = values["loss_stats"]["ops"]
        assert set(ops) == {"all_reduce"}, ops


P_DROP, CLIP = 0.1, 0.05
#: the parameters every tp rank holds whole: wpe, ln_f and six a block
REPLICATED = ("ln_", "wpe", "out_proj.bias", "fc_out.bias")


def test_tp2_dropout_and_clip_under_the_trainer(tmp_path):
    import jax.numpy as jnp
    from paddle_tpu.distributed.strategy_compiler import functional_clip

    _, state = oracle.ref_state()
    tok = oracle.tokens(1, seed=7)[0]
    res = oracle.run_job(tmp_path, "tp_rng_clip", 2, oracle.inputs(
        state, tok=tok, p=P_DROP, clip=CLIP))
    oracle.foreign_free(res)
    loss0, _ = oracle.ref_grads(state, tok)
    (a0, v0), (a1, v1) = res
    for arrays, values in res:
        assert values["plain.loss"] == values["remat.loss"]
        assert abs(values["plain.loss"] - loss0) > 1e-3   # dropout is live
        for k in arrays:
            if k.startswith("plain.grad."):
                np.testing.assert_array_equal(
                    arrays[k.replace("plain.", "remat.")], arrays[k],
                    err_msg=k)
        dropped = (arrays["stem"] == 0) & (arrays["stem_eval"] != 0)
        assert 0.08 < dropped.mean() < 0.12, dropped.mean()
    np.testing.assert_array_equal(a0["stem"], a1["stem"])
    shared = [k for k in a0 if k.startswith("remat.grad.")
              and any(r in k for r in REPLICATED)]
    assert len(shared) == 3 + 6 * oracle.CFG["num_layers"], shared
    for k in shared:
        np.testing.assert_array_equal(a0[k], a1[k], err_msg=k)

    before = {k[len("clip.before."):]: jnp.asarray(v) for k, v in a0.items()
              if k.startswith("clip.before.")}
    assert "embeddings.wte.weight" not in before
    assert v0["frozen_without_grad"] == ["embeddings.wte.weight"]
    gn = float(np.sqrt(sum(float(jnp.sum(g * g)) for g in before.values())))
    assert gn > 2 * CLIP, gn                        # the clip is active
    want = functional_clip(paddle.nn.ClipGradByGlobalNorm(CLIP), before)
    for arrays, _ in res:
        assert not arrays["clip.moment1.embeddings.wte.weight"].any()
        for n, w in want.items():
            np.testing.assert_allclose(arrays[f"clip.moment1.{n}"],
                                       0.1 * np.asarray(w), rtol=1e-6,
                                       atol=1e-10, err_msg=n)
