"""The KV handoff of disaggregated serving (hold / export / admit) held
against the JAX package's engine.

A prefill engine takes requests with ``hold_after_prefill=True``, exports
each held-ready one (``export_held``) and releases it; a decode engine
``admit_prefilled``s the payloads and decodes. The streams equal a single
engine's for the same requests, in the port alone and across the
packages both ways: a JAX payload admitted by the port's decode engine
and a port payload admitted by the JAX one give the JAX single engine's
streams, over f32, bf16 and int8 pools (int8 pages carry their scales).
The port's bf16 pages travel as uint16 bits (numpy has no bf16), the
JAX package's as ``ml_dtypes.bfloat16``: a 2-byte view of either is the
other. The port runs its plain versions here (CPU tensors).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import ServingConfig as JConfig
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.profiler import registry
from paddle_tpu_torch.serving import PagePool, ServingConfig, ServingEngine
from paddle_tpu_torch.serving import engine as eng_mod

CFG = dict(num_slots=2, page_size=8, pages_per_slot=4, prefill_chunk=8)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's tiny shapes: the test
    workers share the machine's cores, and oversubscribed threads made
    these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    paddle.seed(0)
    jnet = jgpt.gpt_tiny(initializer_range=0.2)
    jnet.eval()
    net = tgpt.gpt_tiny(device="cpu", initializer_range=0.2)
    tgpt.load_reference_state(
        net, {k: np.asarray(v._value) for k, v in jnet.state_dict().items()})
    net.eval()
    return jnet, net


def _prompts(lens, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (t,)).astype(np.int32) for t in lens]


def _prefill(pe, prompts, max_new, **kw):
    """Hold every prompt on ``pe``, export and release each as it becomes
    held-ready; returns {rid: payload} in submit order."""
    rids = [pe.submit(p, max_new, hold_after_prefill=True, **kw)
            for p in prompts]
    payloads = {}
    for _ in range(200):
        pe.step()
        pe.drain(0)
        for rid in list(pe.held_ready()):
            payloads[rid] = pe.export_held(rid)
            pe.release_exported(rid)
        if len(payloads) == len(prompts):
            break
    assert sorted(payloads) == sorted(rids)
    return [payloads[r] for r in rids]


def _decode(de, payloads, convert=lambda pl: pl):
    """Admit every payload on ``de`` (retrying on None) and decode; returns
    the streams in payload order."""
    local = {}
    pending = list(enumerate(payloads))
    while pending or not de.idle():
        nxt = []
        for i, pl in pending:
            lr = de.admit_prefilled(convert(pl))
            if lr is None:
                nxt.append((i, pl))
            else:
                local[lr] = i
        pending = nxt
        if not de.step() and de._inflight:
            de.drain(0)
    de.drain(0)
    out = [None] * len(payloads)
    for lr, i in local.items():
        out[i] = np.asarray(de._requests[lr].out, np.int32)
    return out


def _single(eng, prompts, max_new):
    rids = [eng.submit(p, max_new) for p in prompts]
    got = eng.run()
    return [got[r] for r in rids]


def test_hold_export_import_streams_equal_single_engine(nets):
    """Port to port: the handed-off streams equal the single engine's,
    both pools pass the audit, the exported prompts were published in the
    prefill engine's own prefix index, and the counters and events carry
    each payload's bytes."""
    _, net = nets
    prompts = _prompts((8, 16, 12))
    want = _single(ServingEngine(net, ServingConfig(**CFG)), prompts, 8)
    log = tprof.event_log()
    seq0 = log.next_seq
    reg = registry()
    out0 = reg.counter("serving/handoff_bytes_out").value
    in0 = reg.counter("serving/handoff_bytes_in").value
    n0 = reg.counter("serving/handoffs_in").value
    pe = ServingEngine(net, ServingConfig(**CFG))
    de = ServingEngine(net, ServingConfig(**CFG))
    payloads = _prefill(pe, prompts, 8)
    assert pe.pool.check_consistency() == []
    assert pe.pool.prefix is not None and len(pe.pool.prefix) > 0
    got = _decode(de, payloads)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert de.pool.check_consistency() == []
    nbytes = sum(pl["k"].nbytes + pl["v"].nbytes for pl in payloads)
    assert reg.counter("serving/handoff_bytes_out").value - out0 == nbytes
    assert reg.counter("serving/handoff_bytes_in").value - in0 == nbytes
    assert reg.counter("serving/handoffs_in").value - n0 == 3
    evs = log.events(since_seq=seq0)
    outs = [e for e in evs if e.kind == "handoff_out"]
    ins = [e for e in evs if e.kind == "handoff_in"]
    assert sorted(e.attrs["bytes"] for e in outs) == \
        sorted(e.attrs["bytes"] for e in ins) == \
        sorted(pl["k"].nbytes * 2 for pl in payloads)
    assert all(e.attrs["eng"] == pe._eng_id for e in outs)
    assert all(e.attrs["eng"] == de._eng_id for e in ins)
    assert [e.attrs["pages"] for e in outs] == \
        [pl["k"].shape[1] for pl in payloads]


def _to_jax(pl):
    """A port payload as the JAX engine takes it: bf16 bits viewed as
    ml_dtypes.bfloat16."""
    import jax.numpy as jnp

    if pl["kv_dtype"] != "bfloat16":
        return pl
    return dict(pl, k=pl["k"].view(jnp.bfloat16), v=pl["v"].view(jnp.bfloat16))


KV = {"f32": None, "bf16": "bf16", "int8": "int8"}


@pytest.mark.parametrize("kv", sorted(KV))
@pytest.mark.parametrize("way", ["jax_to_port", "port_to_jax"])
def test_cross_package_handoff_gives_the_reference_stream(nets, way, kv):
    """A payload exported by one package and admitted by the other
    decodes to the JAX single engine's stream."""
    jnet, net = nets
    cfg = dict(CFG, kv_dtype=KV[kv])
    prompts = _prompts((8, 16, 12))
    want = _single(JEngine(jnet, JConfig(**cfg)), prompts, 8)
    if way == "jax_to_port":
        pe = JEngine(jnet, JConfig(**cfg))
        de = ServingEngine(net, ServingConfig(**cfg))
        convert = lambda pl: pl          # noqa: E731 - bf16 views as int16
    else:
        pe = ServingEngine(net, ServingConfig(**cfg))
        de = JEngine(jnet, JConfig(**cfg))
        convert = _to_jax
    payloads = _prefill(pe, prompts, 8)
    assert str(payloads[0]["kv_dtype"]) == \
        {"f32": "float32", "bf16": "bfloat16", "int8": "int8"}[kv]
    assert ("k_scale" in payloads[0]) == (kv == "int8")
    got = _decode(de, payloads, convert)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert de.pool.check_consistency() == []
    assert pe.pool.check_consistency() == []


@pytest.mark.parametrize("way", ["port", "jax"])
def test_int8_imported_scales_survive_a_tick(nets, way):
    """int8 pages travel with their scales, and every imported page is
    claimed from the pending scale reset: right after the admit and after
    the decode engine's first tick the imported pages' scales equal the
    payload's (16-token prompts: the first decode write opens a new page,
    so no imported page is written)."""
    jnet, net = nets
    cfg = dict(CFG, kv_dtype="int8")
    pe = ServingEngine(net, ServingConfig(**cfg)) if way == "port" \
        else JEngine(jnet, JConfig(**cfg))
    (pl,) = _prefill(pe, _prompts((16,)), 6)
    assert pl["k_scale"].shape == (net.config.num_layers, 2,
                                   net.config.num_heads)
    assert np.abs(pl["k_scale"]).max() > 0
    de = ServingEngine(net, ServingConfig(**cfg))
    lr = de.admit_prefilled(pl)
    slot = de._slot_rid.index(lr)
    pages = torch.as_tensor(de.pool._held[slot])

    def check():
        for name in ("k", "v"):
            np.testing.assert_array_equal(
                getattr(de.pool, name + "_scale")[:, pages].numpy(),
                pl[name + "_scale"])
            np.testing.assert_array_equal(
                getattr(de.pool, name)[:, pages].numpy(), pl[name])

    check()
    assert de.step()
    check()
    de.drain(0)
    # and the whole stream equals the single int8 engine's
    de.run()
    want = _single(ServingEngine(net, ServingConfig(**cfg)),
                   _prompts((16,)), 6)[0]
    np.testing.assert_array_equal(np.asarray(de._requests[lr].out), want)


def _one_payload(net, cfg=CFG, max_new=4, **kw):
    pe = ServingEngine(net, ServingConfig(**cfg))
    (pl,) = _prefill(pe, _prompts((16,)), max_new, **kw)
    return pl


@pytest.mark.parametrize("case", ["kv_dtype", "capacity", "no_slot",
                                  "no_pages", "eos", "max_new"])
def test_admit_prefilled_refusals_and_early_finish(nets, case):
    """A payload of another pool dtype or past the slot capacity raises
    ValueError and binds nothing; no free slot or no free pages returns
    None; a first token that is EOS, or a budget of one token, finishes at
    the admit."""
    _, net = nets
    pl = _one_payload(net)
    if case == "kv_dtype":
        de = ServingEngine(net, ServingConfig(**dict(CFG, kv_dtype="int8")))
        with pytest.raises(ValueError, match="kv_dtype"):
            de.admit_prefilled(pl)
        assert all(r is None for r in de._slot_rid)
        assert de.pool.check_consistency() == []
    elif case == "capacity":
        de = ServingEngine(net, ServingConfig(**CFG))
        with pytest.raises(ValueError, match="capacity"):
            de.admit_prefilled(dict(pl, max_new=1000))
        assert all(r is None for r in de._slot_rid)
    elif case == "no_slot":
        de = ServingEngine(net, ServingConfig(**CFG))
        assert de.admit_prefilled(pl) is not None
        assert de.admit_prefilled(pl) is not None
        assert de.admit_prefilled(pl) is None        # both slots taken
        assert de.pool.check_consistency() == []
    elif case == "no_pages":
        de = ServingEngine(net, ServingConfig(**dict(CFG, num_pages=3)))
        assert de.admit_prefilled(pl) is not None    # 2 pages of 2
        assert de.admit_prefilled(pl) is None        # a slot, no pages
        assert de.pool.check_consistency() == []
    else:
        first = pl["first_token"]
        if case == "eos":
            cfg = dict(CFG, eos_token_id=first)
            pl2 = pl
        else:
            cfg = CFG
            pl2 = dict(pl, max_new=1)
        de = ServingEngine(net, ServingConfig(**cfg))
        lr = de.admit_prefilled(pl2)
        req = de._requests[lr]
        assert req.done and req.out == [first]
        assert all(r is None for r in de._slot_rid)
        assert de.idle() and de.pool.check_consistency() == []


@pytest.mark.parametrize("case", ["uint16", "int16", "bfloat16",
                                  "float16", "page_shape"])
def test_bf16_pool_takes_only_bf16_bits(nets, case):
    """A bf16 pool admits its pages as uint16 or int16 bits or as
    ml_dtypes bfloat16, and decodes the same stream from each; a float16
    array (2 bytes, the wrong type) or pages of another shape raise
    ValueError before anything is bound."""
    import jax.numpy as jnp

    _, net = nets
    cfg = dict(CFG, kv_dtype="bf16")
    pl = _one_payload(net, cfg)
    assert pl["k"].dtype == np.uint16
    want = _decode(ServingEngine(net, ServingConfig(**cfg)), [pl])[0]
    if case == "page_shape":
        bad = dict(pl, k=pl["k"][..., :-1], v=pl["v"][..., :-1])
    else:
        # float16 holds the same values in another 2-byte encoding
        conv = {"uint16": lambda a: a,
                "int16": lambda a: a.view(np.int16),
                "bfloat16": lambda a: a.view(jnp.bfloat16),
                "float16": lambda a: a.view(jnp.bfloat16).astype(
                    np.float16)}[case]
        bad = dict(pl, k=conv(pl["k"]), v=conv(pl["v"]))
    de = ServingEngine(net, ServingConfig(**cfg))
    if case in ("float16", "page_shape"):
        with pytest.raises(ValueError, match={"float16": "bf16 pages",
                                              "page_shape": "shape"}[case]):
            de.admit_prefilled(bad)
        assert all(r is None for r in de._slot_rid)
        assert de.pool.check_consistency() == []
    else:
        np.testing.assert_array_equal(_decode(de, [bad])[0], want)


def test_held_victim_re_prefills_and_holds_again(nets):
    """A held-ready request preempted by a neighbour's growth loses its
    parked first token into its prompt, re-prefills (a prefix hit on its
    own pages) and holds again; its handoff still decodes to the single
    engine's stream."""
    _, net = nets
    cfg = dict(num_slots=2, page_size=4, pages_per_slot=16, num_pages=12,
               prefill_chunk=8)
    long_p, held_p = _prompts((9, 12), seed=7)
    want = _single(ServingEngine(net, ServingConfig(**cfg)), [held_p], 8)[0]
    eng = ServingEngine(net, ServingConfig(**cfg))
    reg = registry()
    pre0 = reg.counter("serving/preemptions").value
    a = eng.submit(long_p, 30)
    h = eng.submit(held_p, 8, hold_after_prefill=True)
    held_once = False
    payload = None
    for _ in range(300):
        eng.step()
        eng.drain(0)
        req = eng._requests[h]
        if h in eng.held_ready():
            held_once = True
            if req.preempts:
                payload = eng.export_held(h)
                eng.release_exported(h)
                break
    assert held_once and payload is not None
    assert reg.counter("serving/preemptions").value > pre0
    assert payload["preempts"] >= 1
    assert payload["orig_prompt_len"] == 12
    # each preemption after a first token moved that token into the prompt
    assert 12 < payload["prompt"].shape[0] <= 12 + payload["preempts"]
    eng.run()
    assert eng._requests[a].done
    assert eng.pool.check_consistency() == []
    de = ServingEngine(net, ServingConfig(**cfg))
    (got,) = _decode(de, [payload])
    # the decode engine folds the preemption-era token back into the
    # result, as a local finish does
    np.testing.assert_array_equal(got, want)


def test_held_slot_never_rides_a_decode_tick(nets):
    _, net = nets
    eng = ServingEngine(net, ServingConfig(**CFG))
    rid = eng.submit(_prompts((16,))[0], 8, hold_after_prefill=True)
    for _ in range(30):
        eng.step()
        eng.drain(0)
        if rid in eng.held_ready():
            break
    assert rid in eng.held_ready()
    for _ in range(5):             # extra steps dispatch nothing
        assert not eng.step()
    eng.drain(0)
    assert len(eng._requests[rid].out) == 1
    assert eng.cancel(rid) and eng.held_ready() == ()
    assert eng.idle()


def test_export_and_release_require_held_ready(nets):
    _, net = nets
    eng = ServingEngine(net, ServingConfig(**CFG))
    rid = eng.submit(_prompts((8,))[0], 4)
    with pytest.raises(ValueError, match="held-ready"):
        eng.export_held(rid)
    with pytest.raises(ValueError, match="held-ready"):
        eng.release_exported(rid)


def test_sampling_overrides_and_trace_ride_the_handoff(nets):
    _, net = nets
    pe = ServingEngine(net, ServingConfig(**CFG))
    de = ServingEngine(net, ServingConfig(**CFG))
    (pl,) = _prefill(pe, _prompts((16,)), 4, temperature=0.3, top_k=7,
                     top_p=0.9, trace_id="t-1")
    assert pl["temperature"] == pytest.approx(0.3) and pl["top_k"] == 7
    lr = de.admit_prefilled(pl)
    slot = de._slot_rid.index(lr)
    assert de._temps[slot] == pytest.approx(0.3)
    assert de._topks[slot] == 7
    assert de._topps[slot] == pytest.approx(0.9)
    assert de._requests[lr].trace_id == "t-1"
    (pl2,) = _prefill(pe, _prompts((16,), seed=4), 4)
    assert "temperature" not in pl2 and "trace_id" not in pl2
    lr2 = de.admit_prefilled(pl2)
    assert de._temps[de._slot_rid.index(lr2)] == \
        pytest.approx(de.config.temperature)


def test_legacy_engines_hand_off(nets):
    """The legacy two-dispatch engine holds, exports and admits like the
    unified one: the streams equal the single legacy engine's."""
    _, net = nets
    cfg = dict(CFG, attention_kernel="legacy")
    prompts = _prompts((8, 16, 12))
    want = _single(ServingEngine(net, ServingConfig(**cfg)), prompts, 8)
    payloads = _prefill(ServingEngine(net, ServingConfig(**cfg)), prompts, 8)
    got = _decode(ServingEngine(net, ServingConfig(**cfg)), payloads)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


class TestPoolConsistencyAudit:
    def _pool(self):
        return PagePool(num_layers=1, num_pages=9, page_size=8,
                        num_heads=2, head_dim=4, num_slots=2,
                        pages_per_slot=3, prefix_cache=True)

    def test_clean_pool_passes(self):
        p = self._pool()
        assert p.check_consistency() == []
        p.grow_slot(0, 2)
        assert p.check_consistency() == []
        p.release_slot(0)
        assert p.check_consistency() == []

    def test_violations_are_reported(self):
        p = self._pool()
        p.grow_slot(0, 2)
        held = p._held[0][0]
        p.tables[0, 0] = 7             # the table row lies about the page
        assert any("table[0]" in v for v in p.check_consistency())
        p.tables[0, 0] = held
        p.allocator._ref[held] += 1    # the refcount drifted
        assert any("refcount" in v for v in p.check_consistency())
        p.allocator._ref[held] -= 1
        assert p.check_consistency() == []

    def test_prefix_index_holds_are_counted(self):
        p = self._pool()
        p.grow_slot(0, 1)
        p.prefix.insert(np.arange(8, dtype=np.int32), [p._held[0][0]])
        assert p.check_consistency() == []
        p.release_slot(0)              # the page survives in the index
        assert p.check_consistency() == []


def test_engine_ids_fold_in_process_index(nets, monkeypatch):
    """Engines of different processes never share an id in merged
    timelines: the rank is folded into the id's high bits."""
    _, net = nets
    monkeypatch.setattr(eng_mod, "_detect_rank", lambda: 0)
    a = ServingEngine(net, ServingConfig(**CFG))
    monkeypatch.setattr(eng_mod, "_detect_rank", lambda: 3)
    b = ServingEngine(net, ServingConfig(**CFG))
    assert a._eng_id != b._eng_id
    assert b._eng_id >> 20 == 3
    c = ServingEngine(net, ServingConfig(**CFG))
    assert b._eng_id != c._eng_id
