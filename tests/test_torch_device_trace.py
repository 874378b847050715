"""paddle_tpu_torch.profiler.device_trace held against the JAX package's
device_trace (the counterpart of tests/test_device_trace.py).

- The pure math (interval unions, overlap fractions, op categories,
  collective kinds) on seeded random inputs equals the reference's, and
  every case of the reference's ``test_categorize_op`` holds; the port's
  own kernel spellings get their own cases.
- ``summarize`` over the same ``Timeline`` (the same slices, modules and
  host spans) with the same programs and module map registered gives the
  reference's summary key for key (``platform``, ``unix_time`` and
  ``peak_flops_source`` aside): the steps hint, an unattributed module,
  an ambiguous module and the collective byte join.
- Two fixtures of the ``torch.profiler`` format (tests/data, written by
  ``make_torch_traces.py``): a CPU trace written in the container and a
  hand-written trace shaped as one from a card; the reference's negative
  fixtures (truncated, malformed, wrong shape, empty window).
- ``record_summary`` (gauges, the sink artifact through
  tools/check_sink_schema.py, the flight recorder), degraded summaries,
  ``reset``, the TraceWindow schedule, the labelled peak FLOPs.
- Live CPU captures: a round trip, a TraceWindow, an engine's
  ``trace_window`` and a capture inside ``profiler.enable(trace_dir=...)``
  (skipped, nothing raised).
"""
import gzip
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu.profiler as jprof
from paddle_tpu.profiler import device_trace as jdt
from paddle_tpu.profiler import xla_stats as jxla
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.profiler import device_trace as dt
from paddle_tpu_torch.profiler import events as tev
from paddle_tpu_torch.profiler import program_stats as tps
from paddle_tpu_torch.profiler import sink as tsink

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
CHECKER = os.path.join(REPO, "tools", "check_sink_schema.py")


def fix(name):
    return os.path.join(DATA, name)


@pytest.fixture(autouse=True)
def _clean():
    for p, s in ((tprof, tsink), (jprof, None)):
        if p.is_enabled():
            p.disable()
        if s is not None:
            s.disable_sink()
        p.reset()
    yield
    for p in (tprof, jprof):
        if p.is_enabled():
            p.disable()
        p.reset()
    tsink.disable_sink()


def _trace_errors(doc):
    """check_trace_summary's findings on one summary document."""
    spec = importlib.util.spec_from_file_location("check_sink_schema",
                                                  CHECKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    schema = json.load(open(os.path.join(REPO, "tools",
                                         "sink_schema.json")))
    mod._ERRORS.clear()
    mod.check_trace_summary(doc, schema, "summary")
    return list(mod._ERRORS)


def _inject(site, module, flops=None, collectives=None):
    """The same program in both packages' inventories and module maps."""
    jxla.register_module_site(module, site)
    with jxla._lock:
        jxla._programs[site] = jxla.ProgramStats(
            site, 1.0, flops, None, {"flops": flops} if flops else {},
            module=module, collectives=collectives)
    tps.register_module_site(module, site)
    with tps._lock:
        tps._programs[site] = tps.ProgramStats(
            site, 1.0, flops, None, {"flops": flops} if flops else {},
            module=module, collectives=collectives)


# ---------------------------------------------------------------------------
# pure math against the reference
# ---------------------------------------------------------------------------
def _intervals(rng, n):
    s = rng.uniform(0, 1000, n)
    return [(float(a), float(a + d)) for a, d in zip(s, rng.uniform(0, 80, n))]


@pytest.mark.parametrize("seed", range(4))
def test_interval_math_equals_reference(seed):
    rng = np.random.RandomState(seed)
    for n in (0, 1, 7, 40):
        a, b = _intervals(rng, n), _intervals(rng, n + 3)
        assert dt.interval_union_ms(a) == jdt.interval_union_ms(a)
        assert dt.overlap_fraction(a, b) == jdt.overlap_fraction(a, b)
        assert dt.overlap_fraction(b, a) == jdt.overlap_fraction(b, a)


#: the reference's test_categorize_op cases, then op names of every family
REFERENCE_NAMES = [
    "dot.4", "convolution.2", "fusion.attention_softmax", "gather.1",
    "dynamic-update-slice.9", "all-reduce-done.1",
    "broadcast_maximum_fusion", "all-gather-start.3", "collective-permute.1",
    "fwd/attn/dot.3", "reduce-scatter.2", "all-to-all.5", "sort.1",
    "take.2", "scatter.7", "copy.1", "reduce.15", "einsum.0",
    "custom-call.cublas_gemm", "flash_fwd", "ppermute.1",
    "collective-broadcast.1", "dynamic-slice.3", "add.9"]


def test_categorize_op_equals_reference():
    assert dt.categorize_op("dot.4") == "matmul"
    assert dt.categorize_op("convolution.2") == "matmul"
    assert dt.categorize_op("fusion.attention_softmax") == "attention"
    assert dt.categorize_op("gather.1") == "scatter-gather"
    assert dt.categorize_op("dynamic-update-slice.9") == "scatter-gather"
    assert dt.categorize_op("all-reduce-done.1") == "collective"
    assert dt.categorize_op("broadcast_maximum_fusion") == "elementwise"
    assert dt.collective_kind("all-gather-start.3") == "all_gather"
    assert dt.collective_kind("collective-permute.1") == "ppermute"
    assert dt.collective_kind("dot.4") is None
    for name in REFERENCE_NAMES:
        assert dt.categorize_op(name) == jdt.categorize_op(name), name
        assert dt.collective_kind(name) == jdt.collective_kind(name), name
    assert dt.CATEGORIES == jdt.CATEGORIES


@pytest.mark.parametrize("name,cat", [
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNN", "matmul"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8", "matmul"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x32_8x5_nn_align1>",
     "matmul"),
    ("void int8_matmul_wgmma_kernel<1>(CUtensorMap)", "matmul"),
    ("aten::mm", "matmul"), ("aten::addmm", "matmul"),
    ("aten::bmm", "matmul"), ("aten::_int_mm", "matmul"),
    ("void (anonymous namespace)::ragged_kernel<float, float, 32>(int)",
     "attention"),
    ("void (anonymous namespace)::ragged_chunk_kernel<Tile128>(int)",
     "attention"),
    ("void ragged_chunk_merge<float>(float const*, float*, int, int)",
     "attention"),
    ("paged_decode", "attention"),
    ("void flash_bwd_dkv_tc_kernel<128>(CUtensorMap)", "attention"),
    ("Memcpy HtoD (Pageable -> Device)", "elementwise"),
    ("void at::native::vectorized_gather_kernel<16, long>", "scatter-gather"),
    ("aten::copy_", "elementwise")])
def test_categorize_port_spellings(name, cat):
    assert dt.categorize_op(name) == cat


@pytest.mark.parametrize("name,cls", [
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "conv"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nchw",
     "conv"),
    ("sm90_xmma_wgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "conv"),
    ("aten::convolution", "conv"),
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNN", "gemm"),
    ("aten::addmm", "gemm"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>",
     "reduction"),
    ("void at::native::batch_norm_collect_statistics_kernel<float>",
     "reduction"),
    ("void cudnn::bn_fw_tr_1C11_kernel_NCHW<__nv_bfloat16, float>",
     "reduction"),
    ("aten::var_mean", "reduction"), ("aten::sum", "reduction"),
    ("aten::normal_", "pointwise"), ("aten::maximum", "pointwise"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::neg>",
     "pointwise"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>",
     "pointwise"),
    ("void flash_bwd_dkv_tc_kernel<128>(CUtensorMap)", "attention"),
    ("void at::native::vectorized_gather_kernel<16, long>",
     "scatter-gather"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "collective")])
def test_classify_op_nests_in_its_category(name, cls):
    assert dt.classify_op(name) == cls
    cat = dt.categorize_op(name)
    assert cat == {"conv": "matmul", "gemm": "matmul",
                   "reduction": "elementwise",
                   "pointwise": "elementwise"}.get(cls, cls)


def test_class_table_sums_to_the_category_table():
    ops = [("aten::convolution", 2.0, 3), ("aten::addmm", 1.5),
           ("aten::var_mean", 0.25, 2), ("aten::mul", 0.5),
           ("aten::gather", 0.125)]
    t = dt.class_table(ops)
    assert set(t) == set(dt.CLASSES)
    assert t["conv"] == {"count": 3, "ms": 2.0}
    assert t["gemm"] == {"count": 1, "ms": 1.5}
    assert t["reduction"] == {"count": 2, "ms": 0.25}
    assert t["pointwise"] == {"count": 1, "ms": 0.5}
    assert t["scatter-gather"] == {"count": 1, "ms": 0.125}
    assert sum(c["count"] for c in t.values()) == 8


# ---------------------------------------------------------------------------
# summarize over the same Timeline in both packages
# ---------------------------------------------------------------------------
def _timeline(pkg, ops, spans):
    tl = pkg.Timeline()
    tl.device_ops = list(ops)
    tl.host_spans = list(spans)
    tl.events_total = len(ops) + len(spans) + 3
    for _, _, ts, dur in ops:
        tl.t_min_us = ts if tl.t_min_us is None else min(tl.t_min_us, ts)
        tl.t_max_us = ts + dur if tl.t_max_us is None else \
            max(tl.t_max_us, ts + dur)
    for _, ts, dur in spans:
        tl.t_min_us = min(tl.t_min_us, ts)
        tl.t_max_us = max(tl.t_max_us, ts + dur)
    return tl


def _random_ops(rng, modules, names, n):
    ops, t = [], 0.0
    for _ in range(n):
        t += float(rng.uniform(0, 30))
        ops.append((names[rng.randint(len(names))],
                    modules[rng.randint(len(modules))], t,
                    float(rng.uniform(1, 40))))
    return ops


def _same_summary(ops, spans, steps, peak=1e12):
    got = dt.summarize(_timeline(dt, ops, spans), steps=steps,
                       peak_flops=peak, label="x")
    want = jdt.summarize(_timeline(jdt, ops, spans), steps=steps,
                         peak_flops=peak, label="x")
    assert _trace_errors(got) == []
    for d in (got, want):
        d.pop("platform")
        d.pop("unix_time")
        d["ledger"].pop("peak_flops_source")
    assert got == want
    return got


@pytest.mark.parametrize("seed", range(3))
def test_summarize_equals_reference(seed):
    rng = np.random.RandomState(seed)
    _inject("hybrid.step#0", "jit_step", flops=2.5e9,
            collectives={"all_reduce": {"ops": 2, "bytes": 4096},
                         "reduce_scatter": {"ops": 1, "bytes": 512}})
    _inject("serving.tick#1", "jit_tick", flops=7e8)
    # a module two sites claimed: flagged ambiguous
    _inject("a#2", "jit_same", flops=1e6)
    _inject("b#3", "jit_same", flops=2e6)
    ops = _random_ops(rng, ["jit_step", "jit_tick", "jit_same",
                            "jit_other", None], REFERENCE_NAMES, 60)
    spans = [("hybrid/step", 0.0, 500.0), ("serving/tick", 20.0, 5.0),
             ("train 1", 30.0, 2.0)]
    s = _same_summary(ops, spans, steps=4)
    assert s["sites"]["b#3"]["ambiguous"] is True
    assert "jit_other" in s["unattributed_modules"]
    assert "<unknown>" in s["unattributed_modules"]
    if "all_reduce" in s["collectives"]:
        assert s["collectives"]["all_reduce"]["bytes"] > 0


def test_summarize_steps_hint_and_ledger_equal_reference():
    rng = np.random.RandomState(11)
    _inject("hybrid.step#0", "jit_step", flops=1e9)
    ops = _random_ops(rng, ["jit_step"], ["dot.1", "add.2", "gather.3"], 30)
    s = _same_summary(ops, [("hybrid/step", 0.0, 10.0)], steps=3)
    row = s["sites"]["hybrid.step#0"]
    assert row["executions"] == 3 and row["executions_source"] == \
        "steps_hint"
    assert s["ledger"]["model_flops_total"] == 3e9
    # no steps: the least per-name count
    s = _same_summary(ops, [], steps=None)
    assert s["sites"]["hybrid.step#0"]["executions_source"] == \
        "trace_min_op_count"


# ---------------------------------------------------------------------------
# fixtures of the torch.profiler format
# ---------------------------------------------------------------------------
def _events(name):
    return json.load(gzip.open(fix(name), "rt"))["traceEvents"]


def test_cpu_fixture_categories_sites_and_bounds():
    """The CPU trace: two dispatches of relu(x @ w).sum() inside the
    hybrid.step#0 range, then x + 1.0 outside it. The leaf ops are mm,
    clamp_min and fill_ per dispatch (resolve_conj, as_strided and
    empty_strided do no work of their own) and copy_ under the add."""
    tps.register_module_site("hybrid.step#0", "hybrid.step#0")
    evs = _events("torch_mini_cpu.trace.json.gz")
    s = dt.summarize({"traceEvents": evs}, steps=None, label="t")
    leaves = [e for e in evs if e["cat"] == "cpu_op" and e["name"] in (
        "aten::mm", "aten::clamp_min", "aten::fill_", "aten::copy_")]
    assert len(leaves) == 7
    assert s["device_ops"] == 7 and not s["empty"]
    busy = jdt.interval_union_ms(
        [(e["ts"], e["ts"] + e["dur"]) for e in leaves])
    assert s["device_busy_ms"] == pytest.approx(busy, abs=1e-4)
    t0 = min(e["ts"] for e in evs if e["cat"] == "user_annotation")
    t1 = max(e["ts"] + e["dur"] for e in leaves)
    assert s["wall_ms"] == pytest.approx((t1 - t0) / 1e3, abs=1e-4)
    assert s["host_gap_ms"] == pytest.approx(s["wall_ms"] - busy, abs=2e-4)
    cats = s["categories"]
    assert cats["matmul"]["count"] == 2
    mm = sum(e["dur"] for e in leaves if e["name"] == "aten::mm")
    assert cats["matmul"]["ms"] == pytest.approx(mm / 1e3, abs=1e-4)
    assert cats["elementwise"]["count"] == 5
    assert cats["attention"]["count"] == cats["collective"]["count"] == 0
    row = s["sites"]["hybrid.step#0"]
    assert row["ops"] == 6 and row["executions"] == 2
    assert row["executions_source"] == "trace_min_op_count"
    assert s["unattributed_modules"] == {"<unknown>": {
        "ops": 1, "device_ms": pytest.approx(
            [e["dur"] for e in leaves if e["name"] == "aten::copy_"][0] / 1e3,
            abs=1e-4), "executions": 1}}
    assert s["host_annotations"]["hybrid.step#0"]["count"] == 2
    assert s["comm_ms"] == 0 and s["comm_overlap_frac"] == 0.0
    assert _trace_errors(s) == []


def test_cuda_fixture_kernels_launches_and_backward_thread():
    """The card's trace: kernels join their launch by correlation; the
    backward kernels launched from the autograd thread join the range
    whose span holds their launch; the gpu_user_annotation span is not
    device work; cpu_op events are ignored beside the card's slices."""
    tps.register_module_site("hybrid.step#0", "hybrid.step#0")
    with tps._lock:
        tps._programs["hybrid.step#0"] = tps.ProgramStats(
            "hybrid.step#0", 5.0, 6.2e11, None, {"flops": 6.2e11},
            module="hybrid.step#0")
    doc = dt.load_trace_events(fix("torch_mini_cuda.trace.json.gz"))
    tl = dt.parse_timeline(doc)
    by_name = {n.split("(")[0]: m for n, m, _, _ in tl.device_ops}
    assert by_name["void flash_bwd_dq_tc_kernel<128>"] == "hybrid.step#0"
    assert by_name["void flash_bwd_dkv_tc_kernel<128>"] == "hybrid.step#0"
    assert by_name["Memset "] is None
    s = dt.summarize(tl, steps=1, peak_flops=989e12, label="t")
    assert s["device_ops"] == 7
    # [1050, 1070] + [1100, 1400] + [1520, 1670] + [1680, 1830] +
    # [1960, 1970] + [2000, 2005]
    assert s["device_busy_ms"] == pytest.approx(0.635, abs=1e-9)
    # bounds: the range from 1000 to the last kernel's end at 2005
    assert s["wall_ms"] == pytest.approx(1.005, abs=1e-9)
    assert s["host_gap_ms"] == pytest.approx(0.37, abs=1e-9)
    cats = s["categories"]
    assert (cats["attention"]["count"], cats["attention"]["ms"]) == (3, 0.5)
    assert (cats["matmul"]["count"], cats["matmul"]["ms"]) == (1, 0.1)
    assert cats["elementwise"]["count"] == 3
    assert cats["elementwise"]["ms"] == pytest.approx(0.035, abs=1e-9)
    row = s["sites"]["hybrid.step#0"]
    assert row["ops"] == 5 and row["device_ms"] == pytest.approx(0.62)
    assert row["executions"] == 1 and row["executions_source"] == \
        "steps_hint"
    assert row["flops_per_exec"] == 6.2e11
    assert row["mfu"] == pytest.approx(6.2e11 / 0.62e-3 / 989e12, abs=1e-6)
    assert s["unattributed_modules"]["<unknown>"]["ops"] == 2
    assert s["ledger"]["mfu"] == pytest.approx(6.2e11 / 1.005e-3 / 989e12,
                                               abs=1e-6)
    assert set(s["host_annotations"]) == {"hybrid.step#0", "fwd/blocks"}
    assert _trace_errors(s) == []


@pytest.mark.parametrize("name", ["truncated", "malformed", "wrong_shape"])
def test_reference_negative_fixtures_raise(name):
    with pytest.raises(dt.TraceParseError):
        dt.load_trace_events(fix(f"{name}.trace.json.gz"))


def test_empty_window_and_missing_file(tmp_path):
    s = dt.summarize(dt.load_trace_events(fix("empty_window.trace.json.gz")),
                     label="t")
    assert s["empty"] and s["device_ops"] == 0
    assert s["device_busy_ms"] == 0.0 and s["sites"] == {}
    assert s["ledger"]["model_flops_total"] is None
    with pytest.raises(dt.TraceParseError):
        dt.load_trace_events(str(tmp_path / "nope.trace.json.gz"))
    assert dt.find_trace_file(str(tmp_path)) is None


# ---------------------------------------------------------------------------
# record_summary, reset, scheduling, peak FLOPs
# ---------------------------------------------------------------------------
def test_record_summary_gauges_sink_and_flight(tmp_path):
    tps.register_module_site("hybrid.step#0", "hybrid.step#0")
    doc = dt.load_trace_events(fix("torch_mini_cuda.trace.json.gz"))
    s = dt.summarize(doc, steps=1, peak_flops=989e12, label="t")
    assert tev.flight_recorder().dump(reason="before")["trace_summary"] \
        is None
    tsink.enable_sink(str(tmp_path), interval_s=3600)
    try:
        dt.record_summary(s)
        snap = tprof.registry().snapshot()
        assert snap["trace/goodput_busy_frac"]["value"] == s["busy_frac"]
        assert snap["trace/device_busy_ms"]["value"] == s["device_busy_ms"]
        assert snap["phase/comm_traced_ms"]["value"] == 0.0
        assert snap["trace/windows_recorded"]["value"] == 1.0
        art = json.load(open(tmp_path / "trace_summary.json"))
        assert art == json.loads(json.dumps(s))
        assert _trace_errors(art) == []
        assert dt.last_summary() is s
        assert tev.flight_recorder().dump(reason="t")["trace_summary"] is s
    finally:
        tsink.disable_sink()


def test_degraded_summary_not_recorded(tmp_path):
    good = dt.summarize(
        dt.load_trace_events(fix("torch_mini_cuda.trace.json.gz")),
        label="good")
    tsink.enable_sink(str(tmp_path), interval_s=3600)
    try:
        dt.record_summary(good)
        dt.record_summary({"kind": "device_trace_summary", "label": "bad",
                           "skipped": "busy", "empty": True})
        assert dt.last_summary() is good
        assert json.load(open(tmp_path / "trace_summary.json"))["label"] \
            == "good"
        assert tprof.registry().counter("trace/windows_degraded").value == 1
    finally:
        tsink.disable_sink()


def test_reset_clears_module_maps_and_last_summary():
    tps.register_module_site("m", "old#0")
    tps.register_module_site("m", "other#1")
    dt.record_summary(dt.summarize(
        dt.load_trace_events(fix("torch_mini_cuda.trace.json.gz"))))
    tprof.reset()
    assert tps.module_sites() == {} and tps.ambiguous_modules() == set()
    assert dt.last_summary() is None
    tps.register_module_site("m", "new#0")
    assert "m" not in tps.ambiguous_modules()


def test_trace_window_schedule():
    w = dt.TraceWindow(length=2, every=5, start=3)
    assert [i for i in range(14) if w._should_start(i)] == [3, 8, 13]
    one = dt.TraceWindow(length=2, start=4)
    assert [i for i in range(10) if one._should_start(i)] == [4]
    capped = dt.TraceWindow(length=1, every=2, max_windows=2)
    capped.summaries = [{}, {}]
    assert not capped._should_start(4)
    with pytest.raises(ValueError):
        dt.TraceWindow(length=0)
    with pytest.raises(ValueError):
        dt.TraceWindow(length=4, every=2)


def test_default_peak_flops_labelled_and_env_wins(monkeypatch):
    monkeypatch.delenv("PADDLE_PEAK_FLOPS", raising=False)
    peak, src = dt.default_peak_flops()
    assert src == "calibrated" and 1e8 < peak < 1e15
    assert dt.default_peak_flops() == (peak, src)         # one-shot
    monkeypatch.setenv("PADDLE_PEAK_FLOPS", "123e9")
    assert dt.default_peak_flops() == (123e9, "env:PADDLE_PEAK_FLOPS")


# ---------------------------------------------------------------------------
# live CPU captures
# ---------------------------------------------------------------------------
def test_live_capture_round_trip():
    x, w = torch.randn(64, 64), torch.randn(64, 64)
    rec = {}

    def step():
        return tps.dispatch(rec, "live.step#0",
                            lambda: torch.relu(x @ w).sum())

    step()
    tps.record_counted("live.step#0", rec["live.step#0"])
    assert rec["live.step#0"]["flops"] == 2 * 64 ** 3
    with dt.capture(steps=3, label="live") as cap:
        for _ in range(3):
            float(step())
    s = cap.summary
    assert not s["empty"] and s["categories"]["matmul"]["count"] == 3
    row = s["sites"]["live.step#0"]
    assert row["executions"] == 3 and row["flops_per_exec"] == 2 * 64 ** 3
    assert s["ledger"]["model_flops_total"] == 3 * 2 * 64 ** 3
    assert dt.last_summary() is s and cap.timeline is not None
    assert cap.trace_file is None          # the temp dir is gone
    assert _trace_errors(s) == []


def test_live_trace_window():
    x = torch.randn(32, 32)
    win = dt.TraceWindow(length=2, every=4, start=1, max_windows=2,
                         label="win")
    for _ in range(9):
        with win.step():
            float((x * 2.0).sum())
    assert len(win.summaries) == 2 and win.last is win.summaries[-1]
    for s in win.summaries:
        assert s["steps"] == 2 and s["device_ops"] > 0


def test_capture_inside_enabled_trace_is_skipped(tmp_path):
    tprof.enable(trace_dir=str(tmp_path / "t"))
    with dt.capture(steps=1) as cap:
        float(torch.ones(4).sum())
    win = dt.TraceWindow(length=1)
    with win.step():
        pass
    tprof.disable()
    assert "skipped" in cap.summary and cap.summary["empty"]
    assert dt.last_summary() is None and win.skipped == 1
    assert tprof.registry().counter("trace/windows_degraded").value == 1
    assert os.path.exists(tprof.trace.trace_file())


def test_engine_trace_window_executions_equal_steps():
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    torch.manual_seed(0)
    net = GPT(GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                        num_heads=2, max_seq_len=64), device="cpu")
    net.eval()
    eng = ServingEngine(net, ServingConfig(num_slots=2, page_size=8,
                                           pages_per_slot=4))
    prompts = [np.arange(4, dtype=np.int32) + i for i in range(2)]
    for p in prompts:
        eng.submit(p, 4)
    eng.run()
    eng.reset_results()
    for p in prompts:
        eng.submit(p + 10, 6)
    with eng.trace_window() as cap:
        for _ in range(4):
            if eng.idle():
                break
            eng.step()
        eng.drain(0)
    eng.run()
    s = cap.summary
    (site,) = eng.compiled_sites
    row = s["sites"][site]
    assert s["steps"] >= 1 and row["executions"] == s["steps"]
    assert row["flops_per_exec"] == tps.get(site).flops > 0
    assert s["categories"]["matmul"]["count"] > 0
    assert _trace_errors(s) == []
