"""paddle_tpu_torch GPT.generate held against paddle_tpu's.

Both packages run gpt_tiny on the same weights (carried across by
``load_reference_state``) and the same prompts. The dense cached forward
agrees to f32 rounding, caches included; the token streams of every
strategy, dense and paged, int8 pages included, are EQUAL: the port's
sampling draws from the threefry generator that is bit-equal to
jax.random, so a seed gives the reference's tokens. The port runs its
plain versions here (CPU tensors).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference.serving import ServingPredictor as JPredictor
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.inference import ServingPredictor
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.profiler import registry
from paddle_tpu_torch.utils import LRUCache


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the test workers share the machine's cores
    (oversubscribed, this file's cases took several times longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    """gpt_tiny at initializer_range 0.2: greedy decode is context
    dependent (the default 0.02 collapses to one repeated token)."""
    paddle.seed(0)
    jnet = jgpt.gpt_tiny(initializer_range=0.2)
    jnet.eval()
    net = tgpt.gpt_tiny(device="cpu", initializer_range=0.2)
    tgpt.load_reference_state(
        net, {k: np.asarray(v._value) for k, v in jnet.state_dict().items()})
    net.eval()
    return jnet, net


def _toks(seed=2, b=3, t=7):
    return np.random.RandomState(seed).randint(0, 128, (b, t)) \
        .astype(np.int32)


def test_cached_apply_equals_reference_logits_and_caches(nets):
    """A 9-token prefill, then two one-token steps: logits at atol 1e-5
    and both caches, against the reference's gpt_cached_apply."""
    jnet, net = nets
    cfg = net.config
    nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    toks = _toks(4, 2, 9)
    nxt = np.array([[5, 17], [99, 3]], np.int32)
    js, jo = jgpt._gpt_decode_state(jnet)
    z = jnp.zeros((2, cfg.num_layers, 16, nh, hd), jnp.float32)
    jl, jk, jv = jgpt.gpt_cached_apply(cfg, js, jo, z, z,
                                       jnp.asarray(toks), 0)
    ts, to = net._decode_state()
    tk = torch.zeros((2, cfg.num_layers, 16, nh, hd))
    tv = torch.zeros_like(tk)
    with torch.inference_mode():
        tl, tk, tv = tgpt.gpt_cached_apply(cfg, ts, to, tk, tv,
                                           torch.from_numpy(toks).long(), 0)
        steps = [(tl, tk.clone(), tv.clone())]
        for i in range(2):
            tl, tk, tv = tgpt.gpt_cached_apply(
                cfg, ts, to, tk, tv, torch.from_numpy(nxt[:, i:i + 1]).long(),
                9 + i)
            steps.append((tl.clone(), tk.clone(), tv.clone()))
    want = [(jl, jk, jv)]
    for i in range(2):
        jl, jk, jv = jgpt.gpt_cached_apply(cfg, js, jo, jk, jv,
                                           jnp.asarray(nxt[:, i:i + 1]), 9 + i)
        want.append((jl, jk, jv))
    for (a, b, c), (x, y, z_) in zip(steps, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(x), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(b.numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(c.numpy(), np.asarray(z_), rtol=1e-5,
                                   atol=1e-5)


def test_cached_apply_logits_index_equals_forward(nets):
    _, net = nets
    cfg = net.config
    toks = torch.from_numpy(_toks(5, 2, 10)).long()
    nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    ck = torch.zeros((2, cfg.num_layers, 12, nh, hd))
    with torch.inference_mode():
        full = net(toks)
        lg, _, _ = tgpt.gpt_cached_apply(cfg, *net._decode_state(), ck,
                                         ck.clone(), toks, 0, logits_index=6)
    np.testing.assert_allclose(lg.numpy(), full[:, 6].numpy(), rtol=1e-5,
                               atol=1e-5)


GEN_CASES = {
    "greedy": dict(),
    "greedy_eos": dict(eos_token_id=7),
    "sampling": dict(decode_strategy="sampling", seed=1),
    "sampling_filters": dict(decode_strategy="sampling", seed=5, top_k=20,
                             top_p=0.9, temperature=0.8),
    "sampling_topp_eos": dict(decode_strategy="sampling", seed=9, top_p=0.7,
                              temperature=1.4, eos_token_id=11),
    "beam1": dict(decode_strategy="beam_search", num_beams=1),
    "beam4": dict(decode_strategy="beam_search", num_beams=4),
    "beam4_penalty": dict(decode_strategy="beam_search", num_beams=4,
                          length_penalty=0.7),
    "beam3_eos": dict(decode_strategy="beam_search", num_beams=3,
                      length_penalty=1.0, eos_token_id=5),
    "paged_greedy": dict(paged=True),
    "paged_sampling": dict(paged=True, decode_strategy="sampling", seed=3,
                           top_k=30, top_p=0.95, temperature=0.9),
    "paged_page4": dict(paged=True, page_size=4),
    "paged_int8": dict(paged=True, kv_dtype="int8"),
    "paged_int8_sampling": dict(paged=True, kv_dtype="int8",
                                decode_strategy="sampling", seed=2),
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_generate_equals_reference(nets, case):
    jnet, net = nets
    kw = GEN_CASES[case]
    toks = _toks()
    ji, js = jnet.generate(paddle.to_tensor(toks), max_new_tokens=9, **kw)
    ti, ts = net.generate(toks, max_new_tokens=9, **kw)
    assert ti.shape == (3, 9) and ts.shape == (3,)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji.numpy()))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js.numpy()),
                               rtol=1e-5, atol=1e-5)


def test_dense_equals_paged_greedy_and_top_k1_is_greedy(nets):
    _, net = nets
    toks = _toks(6, 2, 11)
    dense, _ = net.generate(toks, max_new_tokens=8)
    paged, _ = net.generate(toks, max_new_tokens=8, paged=True)
    np.testing.assert_array_equal(dense.numpy(), paged.numpy())
    for paged_ in (False, True):
        k1, _ = net.generate(toks, max_new_tokens=8, paged=paged_,
                             decode_strategy="sampling", top_k=1, seed=7)
        np.testing.assert_array_equal(k1.numpy(), dense.numpy())


def test_beam_score_at_least_greedy(nets):
    _, net = nets
    toks = _toks(7, 1, 5)
    _, s1 = net.generate(toks, max_new_tokens=4,
                         decode_strategy="beam_search", num_beams=1)
    _, s4 = net.generate(toks, max_new_tokens=4,
                         decode_strategy="beam_search", num_beams=4)
    assert float(s4[0]) >= float(s1[0]) - 1e-5


def test_generate_accepts_tensors_and_wrapper_forward(nets):
    _, net = nets
    toks = _toks(8, 2, 6)
    want, _ = net.generate(toks, max_new_tokens=5)
    got, _ = net.generate(torch.from_numpy(toks), max_new_tokens=5)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    gen = tgpt.GPTForGeneration(net, max_new_tokens=5)
    np.testing.assert_array_equal(gen(toks).numpy(), want.numpy())


@pytest.mark.parametrize("kw,err", [
    (dict(max_new_tokens=60), ValueError),
    (dict(decode_strategy="nucleus"), ValueError),
    (dict(decode_strategy="beam_search", paged=True), NotImplementedError),
    (dict(kv_dtype="int8"), ValueError),
    (dict(paged=True, page_size=5), ValueError)])
def test_generate_errors_as_reference(nets, kw, err):
    jnet, net = nets
    toks = _toks(9, 1, 7)
    kw = dict(dict(max_new_tokens=4), **kw)
    with pytest.raises(err):
        jnet.generate(paddle.to_tensor(toks), **kw)
    with pytest.raises(err):
        net.generate(toks, **kw)


def test_paged_engine_cache_hits_and_rebuilds_on_weight_change(nets):
    """A second paged call of the same shape reuses its engine; an
    in-place weight update (the prefix cache holds K/V of the old values)
    or a replaced parameter rebuilds it."""
    _, net0 = nets
    net = tgpt.gpt_tiny(device="cpu", initializer_range=0.2)
    net.load_state_dict(net0.state_dict())
    net.eval()
    toks = _toks(10, 2, 8)
    a, _ = net.generate(toks, max_new_tokens=8, paged=True)
    eng = net._paged_engines.get(next(iter(net._paged_engines.keys())))[1]
    b, _ = net.generate(toks, max_new_tokens=8, paged=True)
    assert net._paged_engines.get(
        next(iter(net._paged_engines.keys())))[1] is eng
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    with torch.no_grad():
        net.blocks[0].mlp.fc_in.weight.mul_(1.5)
    c, _ = net.generate(toks, max_new_tokens=8, paged=True)
    eng2 = net._paged_engines.get(next(iter(net._paged_engines.keys())))[1]
    assert eng2 is not eng
    dense, _ = net.generate(toks, max_new_tokens=8)
    np.testing.assert_array_equal(c.numpy(), dense.numpy())


def test_paged_engine_lru_evicts_and_counts(nets):
    _, net0 = nets
    net = tgpt.gpt_tiny(device="cpu", initializer_range=0.2)
    net.load_state_dict(net0.state_dict())
    ev0 = registry().counter("cache_evict/gpt_paged_engine").value
    for t in range(3, 3 + tgpt.GPT.PAGED_ENGINE_CACHE_SIZE + 1):
        net.generate(_toks(t, 1, t), max_new_tokens=2, paged=True)
    assert len(net._paged_engines) == tgpt.GPT.PAGED_ENGINE_CACHE_SIZE
    assert registry().counter("cache_evict/gpt_paged_engine").value \
        == ev0 + 1


def test_lru_equals_reference_lru():
    from paddle_tpu.utils.lru import LRUCache as JLRU

    seen = []
    caches = [JLRU(3, "t", on_evict=lambda k, v: seen.append(("j", k))),
              LRUCache(3, "t", on_evict=lambda k, v: seen.append(("t", k)))]
    for c in caches:
        for k in "abcd":
            c[k] = k.upper()
        c.get("b")
        c.put("e", "E")
        assert "a" not in c and c["b"] == "B" and len(c) == 3
        assert list(c.keys()) == ["d", "e", "b"] and c.evictions == 2
    assert [k for who, k in seen if who == "j"] == \
        [k for who, k in seen if who == "t"] == ["a", "c"]
    with pytest.raises(ValueError):
        LRUCache(0)


def test_serving_predictor_sampling_equals_reference(nets):
    jnet, net = nets
    toks = np.random.RandomState(5).randint(0, 128, (3, 12)).astype(np.int32)
    lens = np.array([12, 7, 3])
    kw = dict(num_slots=2, page_size=8, pages_per_slot=4, prefill_chunk=8,
              decode="sampling", temperature=0.9, top_k=40, top_p=0.9,
              seed=13)
    ref = JPredictor(jnet, max_new_tokens=6, **kw).run([toks, lens])
    got = ServingPredictor(net, max_new_tokens=6, **kw).run([toks, lens])
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
