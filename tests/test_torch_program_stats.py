"""paddle_tpu_torch.profiler.program_stats: the per-site program inventory.

- Counterparts of test_serving.py::test_program_inventory_covers_every_
  dispatched_site (unified and legacy engines) and test_spec_decode.py::
  test_program_inventory_covers_draft_site: one entry per dispatched
  site of ``compiled_sites``, each with a positive ``compile_ms``.
- An analytic oracle in place of the reference's HLO-text count (whose
  pin, test_device_trace.py::test_category_breakdown_tiny_program, finds
  no ``dot`` in the installed XLA's HLO text): the tiny program's matmul
  FLOPs are 2·8·8·6; a gpt_tiny unified tick's matmul FLOPs equal the
  hand count of its projections, MLP, lm head over the sampled rows and
  the plain attention's two einsums over the gathered width; a
  ``hybrid.step`` site's matmul FLOPs equal 3x the forward's (4x under
  recompute), with the ops that break the ratio named.
- A view adds no bytes; ``profiler.reset()`` empties the inventory and
  ``record_program_stats()`` fills it again.
- Each kernel's ``*_cost`` function equals its hand formula at a small
  shape; the flash forward's is the reference's own ``pl.CostEstimate``
  expression, read from the reference's source.
"""
import math
import os
import re

import numpy as np
import pytest
import torch

from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.distributed.hybrid import HybridPipelineTrainer
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import int8_matmul as im
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.profiler import program_stats as tps
from paddle_tpu_torch.serving import ServingConfig, ServingEngine, SpecConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    tprof.reset()
    yield
    tprof.reset()


def _net(seed=0, **kw):
    torch.manual_seed(seed)
    net = tgpt.gpt_tiny(device="cpu", initializer_range=0.2, **kw)
    net.eval()
    return net


def _matmul_flops(rec):
    return rec["categories"]["matmul"]["flops"]


# ---------------------------------------------------------------------------
# the inventory covers every dispatched site
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", [None, "legacy"])
def test_program_inventory_covers_every_dispatched_site(kernel):
    eng = ServingEngine(_net(), ServingConfig(
        num_slots=2, page_size=8, pages_per_slot=3, prefill_chunk=8,
        attention_kernel=kernel))
    eng.submit(np.arange(8, dtype=np.int32) % 128, 4)
    eng.run()
    inv = eng.record_program_stats()
    assert set(inv) == set(eng.compiled_sites)
    assert len(inv) == (2 if kernel == "legacy" else 1)
    for site, rec in inv.items():
        assert rec["site"] == rec["module"] == site
        assert rec["compile_ms"] > 0.0 and rec["cost_available"]
        assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
        assert tps.module_sites()[site] == site
    assert tprof.summary()["programs"] == inv


def test_program_inventory_covers_draft_site():
    eng = ServingEngine(_net(), ServingConfig(
        num_slots=1, page_size=8, pages_per_slot=3, prefill_chunk=8,
        spec=SpecConfig(draft_model=_net(1), k=2)))
    eng.submit(np.arange(8, dtype=np.int32) % 128, 6)
    eng.run()
    inv = eng.record_program_stats()
    assert set(inv) == set(eng.compiled_sites) and len(inv) == 2
    assert all(r["compile_ms"] > 0 for r in inv.values())


def test_reset_empties_and_record_fills_again():
    eng = ServingEngine(_net(), ServingConfig(
        num_slots=2, page_size=8, pages_per_slot=3, prefill_chunk=8))
    eng.submit(np.arange(8, dtype=np.int32), 3)
    eng.run()
    first = eng.record_program_stats()
    assert tprof.program_inventory() == first
    tprof.reset()
    assert tprof.program_inventory() == {} and tps.module_sites() == {}
    assert tprof.summary()["programs"] == {}
    assert eng.record_program_stats() == tprof.program_inventory()
    (site,) = eng.compiled_sites
    snap = tprof.registry().snapshot()
    assert snap[f"xla/{site}/flops"]["value"] == first[site]["flops"]
    assert snap[f"xla/{site}/compile_ms"]["value"] > 0


# ---------------------------------------------------------------------------
# the analytic oracle
# ---------------------------------------------------------------------------
def test_tiny_program_matmul_flops():
    """The reference pin's program: take(relu(x @ w), arange(4)).sum()."""
    x, w = torch.ones(8, 6), torch.ones(6, 8)
    out, rec = tps.count(
        lambda: torch.relu(x @ w)[torch.arange(4)].sum())
    assert float(out) == 4 * 8 * 6
    assert _matmul_flops(rec) == 2 * 8 * 8 * 6 == rec["flops"]
    assert rec["categories"]["matmul"]["ops"] == 1
    assert sum(c["ops"] for c in rec["categories"].values()) == rec["ops"]
    with torch.inference_mode():     # composite ops reach the mode whole
        _, rec = tps.count(lambda: torch.einsum("ab,bc->ac", x, w))
    assert _matmul_flops(rec) == 2 * 8 * 8 * 6


def test_views_add_no_bytes():
    x = torch.ones(8, 6)
    _, rec = tps.count(lambda: x.view(48)[2:].unsqueeze(0).t()
                       .reshape(46).expand(2, 46).transpose(0, 1))
    assert rec["bytes_accessed"] == 0 and rec["ops"] == 0
    _, rec = tps.count(lambda: x + 1.0)
    assert rec["bytes_accessed"] == 2 * x.numel() * 4
    assert rec["flops"] == 0.0 and set(rec["categories"]) == {"elementwise"}


def test_unified_tick_matmul_flops_equal_hand_count():
    """The tick site's first dispatch (a mixed tick): every token rides the
    projections and the MLP (24·h² per token and layer), each layer's two
    ragged calls (the decode rows, then the chunk rows) run the plain
    version's two einsums over the gathered width S_cap = pages_per_slot
    · page_size (2·R·T·S_cap·h each), and the lm head runs over the
    num_slots sampled rows."""
    ns, ps, nps, w, npf = 3, 8, 4, 8, 2
    net = _net()
    cfg = net.config
    eng = ServingEngine(net, ServingConfig(
        num_slots=ns, page_size=ps, pages_per_slot=nps, prefill_chunk=w,
        prefill_chunks_per_tick=npf))
    for i in range(3):
        eng.submit((np.arange(12, dtype=np.int32) + i) % 128, 3)
    eng.run()
    (rec,) = eng._program_counts.values()
    h, layers, v = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    assert cfg.ffn_hidden_size == 4 * h
    s_cap = nps * ps
    n_tok = ns + npf * w
    proj = layers * n_tok * 2 * (3 * h * h + h * h + 4 * h * h + 4 * h * h)
    attn = layers * (4 * ns * 1 * s_cap * h + 4 * npf * w * s_cap * h)
    head = ns * 2 * h * v
    assert _matmul_flops(rec) == proj + attn + head
    # no kernel ran: nothing was noted under attention
    assert "flops" not in rec["categories"].get("attention", {})


def _trainer(recompute, seed=5):
    torch.manual_seed(seed)
    cfg = tgpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                         num_heads=2, max_seq_len=128)
    net = tgpt.GPT(cfg, device="cpu")
    opt = AdamW(1e-3, parameters=net.named_parameters(), weight_decay=0.1)
    s = DistributedStrategy()
    s.recompute = recompute
    return HybridPipelineTrainer(net, opt, s, n_micro=2), cfg


@pytest.mark.parametrize("recompute", [False, True])
def test_step_matmul_flops_ratio_to_forward(recompute):
    """The step site's matmul FLOPs against the forward's: a product's
    backward is two products, so a layer that runs once forward costs 3x
    (4x when recompute runs the block forward again in backward). Two ops
    break the ratio, by design: the fused lm-head loss checkpoints each
    chunk, so its logits product is recomputed in backward (4x with or
    without recompute), and the flash backward (the plain version of the
    kernels at S 128) recomputes QKᵀ before its four products (5 einsums
    to the forward's 2: 3.5x, 4.5x under recompute). And recompute
    (``torch.utils.checkpoint``, non-reentrant) stops re-running a block
    once every tensor its backward saves is back: the block's last
    product, the MLP's fc_out, has its inputs by then and is not run
    again (3x where the block's other products are 4x)."""
    tr, cfg = _trainer(recompute)
    b, s = 4, 128
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (b, s)))
    assert fa.supported((b // 2, s, cfg.num_heads, 32), None, 0.0)
    with torch.no_grad():
        _, fwd = tps.count(tr._loss, (toks,), False)
    tr.step(toks)
    step = tr._program_counts[tr._prof_site]
    h, v, layers = cfg.hidden_size, cfg.vocab_size, cfg.num_layers
    # qkv, out_proj and fc_in (16·h² a token), fc_out (8·h²)
    f_front = layers * b * s * 16 * h * h
    f_fc_out = layers * b * s * 8 * h * h
    f_attn = layers * 4 * b * s * s * h
    f_head = 2 * b * s * h * v
    assert _matmul_flops(fwd) == f_front + f_fc_out + f_attn + f_head
    k = 4 if recompute else 3
    assert _matmul_flops(step) == k * f_front + 3 * f_fc_out + \
        (k + 0.5) * f_attn + 4 * f_head


# ---------------------------------------------------------------------------
# the kernels' cost functions
# ---------------------------------------------------------------------------
def _reference_cost_estimate():
    """The flops= and bytes_accessed= expressions of the reference's
    flash forward pl.CostEstimate, as written there."""
    src = open(os.path.join(REPO, "paddle_tpu", "ops",
                            "flash_attention.py")).read()
    m = re.search(r"cost_estimate=pl\.CostEstimate\(\s*flops=(.*?),\s*"
                  r"bytes_accessed=(.*?),\s*transcendentals", src, re.S)
    return m.group(1), m.group(2)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_cost_is_reference_cost_estimate(causal):
    b, s, h, d = 2, 256, 3, 64
    q = torch.zeros(b, s, h, d, dtype=torch.bfloat16)
    flops_src, bytes_src = _reference_cost_estimate()
    q3 = np.zeros((b * h, s, d), np.float16)      # a 2-byte itemsize
    env = {"bh": b * h, "sq": s, "sk": s, "d": d, "causal": causal,
           "q3": q3, "k3": q3, "v3": q3}
    want = (float(eval(flops_src, env)), int(eval(bytes_src, env)))
    assert fa.flash_fwd_cost(q, q, q, causal) == want
    pairs = s * (s + 1) / 2 if causal else s * s
    assert fa.flash_fwd_cost(q, q, q, causal, exact=True) == (
        4.0 * b * h * d * pairs, 4 * b * s * h * d * 2 + 4 * b * h * s)


@pytest.mark.parametrize("kind,factor,rows", [
    ("single", 10.0, lambda sq, sk: sq + 2 * sk),
    ("dq", 6.0, lambda sq, sk: sq), ("dkv", 8.0, lambda sq, sk: 2 * sk)])
@pytest.mark.parametrize("causal,out", [(True, torch.bfloat16),
                                        (False, torch.float32)])
def test_flash_bwd_cost_hand_formula(kind, factor, rows, causal, out):
    b, sq, sk, h, d = 2, 128, 256, 2, 64
    q = torch.zeros(b, sq, h, d, dtype=torch.bfloat16)
    k = torch.zeros(b, sk, h, d, dtype=torch.bfloat16)
    pairs = sq * (sq + 1) / 2 if causal else sq * sk
    osz = 2 if out == torch.bfloat16 else 4
    want = (factor * b * h * d * pairs,
            2 * b * (sq + sk) * h * d * 2 + 2 * b * h * sq * 4
            + rows(sq, sk) * b * h * d * osz)
    assert fa.flash_bwd_cost(kind, q, k, causal, out) == want


@pytest.mark.parametrize("kv,scaled", [(torch.float32, False),
                                       (torch.bfloat16, False),
                                       (torch.int8, True)])
def test_ragged_cost_hand_formula(kv, scaled):
    """Per row and query, a loop: query j attends min(pos0 + j + 1,
    S_cap) keys; a row past its table reads the whole table."""
    r, t, nh, hd, ps, nps = 4, 5, 2, 16, 8, 3
    s_cap = ps * nps
    q = torch.zeros(r, t, nh, hd)
    pool = torch.zeros(10, ps, nh, hd, dtype=kv)
    tab = torch.zeros(r, nps, dtype=torch.int32)
    p0 = torch.tensor([0, 7, 21, 30], dtype=torch.int32)
    tl = torch.tensor([5, 1, 4, 2], dtype=torch.int32)
    scale = torch.zeros(10, nh) if scaled else None
    keys = attended = pages = 0
    for i in range(r):
        a, n = int(p0[i]), int(tl[i])
        keys += sum(min(a + j + 1, s_cap) for j in range(n))
        attended += min(a + n, s_cap)
        pages += min((a + n - 1) // ps + 1, nps)
    nbytes = (2 * attended * nh * hd * pool.element_size()
              + 2 * r * t * nh * hd * 4 + r * nps * 4 + 2 * r * 4
              + (2 * pages * nh * 4 if scaled else 0))
    assert pa.ragged_cost(q, pool, tab, p0, tl, k_scale=scale) == (
        4.0 * nh * hd * keys, nbytes)
    # numpy metadata (chip_smoke's) gives the same
    assert pa.ragged_cost(q, pool, tab.numpy(), p0.numpy(), tl.numpy(),
                          k_scale=scale) == (4.0 * nh * hd * keys, nbytes)


def test_int8_costs_hand_formula():
    m, k, n = 5, 32, 24
    x = torch.zeros(m, k, dtype=torch.bfloat16)
    out = torch.zeros(m, n, dtype=torch.int8)
    assert im.int8_matmul_cost(x, out, k, n, True) == (
        2.0 * m * k * n, m * k * 2 + k * n + m * n + 4 * n * 2 + 4)
    assert im.int8_matmul_cost(x.float(), out.float(), k, n, False) == (
        2.0 * m * k * n, m * k * 4 + k * n + m * n * 4 + 4 * n + 4)
    assert im.int8_quantize_cost(x) == (3.0 * m * k, m * k * 3 + 4)


def test_note_kernel_counts_only_under_a_counter():
    calls = []

    def cost(a):
        calls.append(a)
        torch.ones(3) + 1            # the cost's own ops are not counted
        return 10.0, 20

    tps.note_kernel("ragged_kernel", cost, 1)
    assert calls == [] and tps.ACTIVE is None
    _, rec = tps.count(lambda: tps.note_kernel("ragged_kernel", cost, 2))
    assert calls == [2] and tps.ACTIVE is None
    assert rec["categories"] == {"attention": {"ops": 1, "bytes": 20,
                                               "flops": 10.0}}
    assert math.isclose(rec["flops"], 10.0) and rec["bytes_accessed"] == 20
