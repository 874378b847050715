#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                 # all phases, one card

Setup: TF32 off for matmuls and cuDNN (parity: f32 products in full f32),
the card's name and power limit from nvidia-smi, and the build of every
CUDA kernel from paddle_tpu_torch/csrc/ into paddle_tpu_torch/_build/.

1. kernel phase — each kernel's wrapper on the card against its plain
   PyTorch version on the same inputs, at the serving engine's, the
   model's and the trainer's shapes: max abs error within the stated
   tolerance, kernel / plain / library times (CUDA events), and the least
   time the card could take (bytes over 3.35 TB/s or operations over the
   peak rate of the input type, whichever is larger). The flash backward
   kernels run at S 1024 (the merged single-tile kernel) and S 2048 (the
   dQ + dK/dV pair), f32 and bf16, causal and not. The ragged kernel's
   int8 path runs the same row groups over int8 pools whose content and
   scales the port's own paged_kv_scatter wrote, under f32 and bf16
   queries. The int8 matmul runs the deploy model's two layer shapes
   (f32, bf16 and int8 x, with and without ReLU + requantize) and a ragged
   67 x 130 x 45 with and without bias: int8 outputs equal to the plain
   version's, float outputs at rtol 1e-6 / atol 1e-5.
2. model phase — GPT.forward at gpt3_1_3b width (24 layers, random
   weights from a seed, f32) over 2 prompts of 1024 tokens (flash
   kernel), and gpt_ragged_apply over the same tokens through scrambled
   pages (ragged kernel): every sampled position's logits agree with the
   forward's.
3. engine phase — ServingEngine at gpt3_1_3b serving 16 requests (half
   share a 512-token prefix) 32 greedy tokens each; 4 streams checked
   against teacher-forced GPT.forward argmax.
4. grad phase — GPT.loss at gpt3_1_3b width, 2 layers, f32, one
   sequence of 2048: every parameter's gradient through the kernels
   against a run on the plain attention functions (bound in by this
   script), max |dg| / max |g| <= 1e-3.
5. train phase — HybridPipelineTrainer at gpt3_1_3b, full depth, with
   the single-chip recipe (amp, recompute, bf16 parameters and moments,
   AdamW 0.1, warmup-cosine schedule, global-norm clip 1.0, n_micro 2):
   8 steps on one fixed [4, 2048] batch (the loss must fall), one step
   under torch.profiler, 2 steps on a [4, 1024] batch. Step ms, tokens/s,
   MFU and peak memory.
6. kvint8 phase — the engine phase's workload with kv_dtype="int8": every
   ragged launch runs over int8 pools, two runs give equal streams, the
   pool (scales included) takes <= 0.27 of the f32 pool's bytes, the null
   page's scale rows stay 0, and gpt_ragged_apply's logits over one
   1024-token prompt (4 chunks, then 4 decode steps) with int8 pools
   agree with the f32-pool run within KVINT8_LOGIT_TOL. Token match rate
   against the f32 engine's streams, tokens/s cold and warm, busy share,
   peak memory.
7. deploy phase — Sequential(Linear(4096, 16384), ReLU, Linear(16384,
   4096)) through QAT().quantize -> a calibration forward ->
   convert_to_int8_deploy -> net(x) at batch 4096 with bf16 input: the
   fusion pass wired fc1 -> fc2, one forward is 2 launches of the int8
   matmul kernel, the output is bf16, agrees with the plain chain (int8
   intermediate equal) and stays within DEPLOY_QAT_TOL of the QAT-eval
   output. ms per forward.

Every launch counter is set to 0 just before each of phases 2-7 and read
just after it: those are the main paths' launches, and each path must
launch each of its kernels. Prints JSON lines per case, then
{"kernels": [...]}, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Any failure raises: no phase is caught.
Exits non-zero without a CUDA device or outside a checkout of the repo.

    python3 chip_smoke.py --phases kernels,train   # after editing a kernel
    python3 chip_smoke.py --phases kernels,kvint8,deploy   # the int8 slice
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12,    # f32 outside the tensor cores
              "bfloat16": 989e12,  # bf16 dense tensor cores
              "int8": 1979e12}     # int8 dense tensor cores (operations/s)

F32_TOL = 2e-5   # as the reference holds its Pallas kernels to XLA (f32)
BF16_TOL = 2e-2  # one bf16 ulp at |o| <~ 1, f32 accumulation on both sides
# The kernels accumulate bf16 inputs in f32, so their reference is the
# plain version run on the same bf16 values upcast (exactly) to f32; the
# kernel's bf16 output is compared with it in f32 at BF16_TOL.
MODEL_TOL = 1e-3  # 24 layers of f32 in different reduction orders
BWD_F32_TOL = 3e-5  # the reference's own gradient tolerance (f32)
# bf16 gradients: the kernel rounds its f32 result once, so it is held to
# the plain f32 result rounded to bf16 within one bf16 ulp at any
# magnitude (2^-7 relative; 8 significant bits), plus an absolute floor
# of 1e-3 * max|ref| for elements that cancel to near 0.
BWD_BF16_RTOL = 2.0 ** -7
BWD_BF16_ATOL = 1e-3
GRAD_TOL = 1e-3     # max |dg| / max |g| per parameter, model gradients
# int8 matmul: float outputs at the reference's own tolerance between its
# fused kernel and the unfused expression; int8 outputs must be EQUAL
INT8_MM_RTOL, INT8_MM_ATOL = 1e-6, 1e-5
# int8 KV pages: max |logit(int8 pools) - logit(f32 pools)| over max
# |logit(f32 pools)| for one 1024-token prompt through 24 layers (every
# K/V value carries up to half an int8 step of its page's and head's
# amax / 127, about 0.4% of that amax)
KVINT8_LOGIT_TOL = 0.05
KVINT8_MATCH_FLOOR = 0.5   # int8 vs f32 streams, random weights: one
#                            flipped near-tie changes the rest of a stream
KVINT8_BYTES_RATIO = 0.27  # int8 pool + scales over the f32 pool
# deploy: max |y_int8 - y_qat_eval| over max |y_qat_eval|: one bf16
# rounding of x before the quantizer, the quantizer's steps, a bf16 output
DEPLOY_QAT_TOL = 0.03


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_info_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, dev) -> float:
    """Mean milliseconds per call over ``iters`` calls after warm-up,
    CUDA events on the card (host clock only in a CPU rehearsal)."""
    import torch

    for _ in range(2):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------
def ragged_groups(rng, npages, nps, ps):
    """Row groups at the engine's shapes: (name, T, pos0, true_len,
    tables). Tables are scrambled distinct pages; page 0 is the null
    page."""
    import numpy as np

    def tables(r, n_used):
        tab = np.zeros((r, nps), np.int32)
        for i, n in enumerate(n_used):
            tab[i, :n] = rng.choice(np.arange(1, npages), n, replace=False)
        return tab

    pos0 = rng.randint(200, 1900, 8).astype(np.int32)
    dec = ("decode_R8_T1", 1, pos0, np.ones(8, np.int32),
           tables(8, pos0 // ps + 1))
    p0 = np.array([512, 768], np.int32)
    tl = np.array([256, 256], np.int32)
    chk = ("chunk_R2_T256", 256, p0, tl, tables(2, (p0 + tl - 1) // ps + 1))
    # a row whose attended length ends mid-page, a pad row (all-null
    # table, true_len 1) and a long chunk row ending mid-page
    p0 = np.array([37, 0, 1000], np.int32)
    tl = np.array([100, 1, 250], np.int32)
    tab = tables(3, [(37 + 99) // ps + 1, 0, (1000 + 249) // ps + 1])
    mix = ("mixed_pad_R3_T256", 256, p0, tl, tab)
    return [dec, chk, mix]


def kernel_phase_ragged(dev, iters, seed=0, nh=16, hd=128, ps=16, nps=128):
    import numpy as np
    import torch
    from torch.nn import functional as TF

    from paddle_tpu_torch.ops import paged_attention as pa

    rng = np.random.RandomState(seed)
    npages = 8 * nps + 1                 # the engine's default pool
    g = torch.Generator(device=dev).manual_seed(seed)
    k32 = torch.randn(npages, ps, nh, hd, generator=g, device=dev)
    v32 = torch.randn(npages, ps, nh, hd, generator=g, device=dev)
    pools = {"float32": (k32, v32),
             "bfloat16": (k32.bfloat16(), v32.bfloat16())}
    results = []
    for name, t, p0, tl, tab in ragged_groups(rng, npages, nps, ps):
        r = tab.shape[0]
        q32 = torch.randn(r, t, nh, hd, generator=g, device=dev)
        meta = [torch.from_numpy(x).to(dev) for x in (tab, p0, tl)]
        tab_d, p0_d, tl_d = meta
        qpos = p0_d[:, None] + torch.arange(t, device=dev,
                                            dtype=torch.int32)[None]
        for qdt, kvdt in (("float32", "float32"), ("bfloat16", "bfloat16"),
                          ("float32", "bfloat16")):
            q = q32 if qdt == "float32" else q32.bfloat16()
            k, v = pools[kvdt]
            with torch.inference_mode():
                out = pa.ragged_paged_attention(q, k, v, *meta)
                ref = pa._gather_attend(q.float(), k.float(), v.float(),
                                        tab_d, qpos)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            err = 0.0
            for i in range(r):
                n = int(tl[i])
                d = (out[i, :n].float() - ref[i, :n].float()).abs()
                lim = (BF16_TOL if qdt == "bfloat16"
                       else F32_TOL) * (1 + ref[i, :n].float().abs())
                if not bool(torch.isfinite(out[i, :n]).all()):
                    raise AssertionError(f"ragged {name} {qdt}/{kvdt}: "
                                         "non-finite output")
                if bool((d > lim).any()):
                    raise AssertionError(
                        f"ragged {name} q {qdt} kv {kvdt}: max abs err "
                        f"{float(d.max())} over tolerance")
                err = max(err, float(d.max()))
            # library yardstick: SDPA over the plain gathered cache
            s_cap = nps * ps
            kc = k[tab_d.long()].reshape(r, s_cap, nh, hd).transpose(1, 2)
            vc = v[tab_d.long()].reshape(r, s_cap, nh, hd).transpose(1, 2)
            wide = torch.promote_types(k.dtype, q.dtype)
            kc, vc = kc.to(wide).contiguous(), vc.to(wide).contiguous()
            qt = q.to(wide).transpose(1, 2).contiguous()
            mask = (torch.arange(s_cap, device=dev)[None, None, None, :]
                    <= qpos[:, None, :, None])
            with torch.inference_mode():
                kern_ms = time_ms(lambda: pa.ragged_paged_attention(
                    q, k, v, *meta), iters, dev)
                plain_ms = time_ms(lambda: pa._gather_attend(
                    q, k, v, tab_d, qpos), iters, dev)
                lib_ms = time_ms(lambda: TF.scaled_dot_product_attention(
                    qt, kc, vc, attn_mask=mask), iters, dev)
            # bytes this data needs: attended K/V positions, q, o, metadata
            attended = (p0.astype(np.int64) + tl).sum()
            esz_kv = k.element_size()
            nbytes = (2 * attended * nh * hd * esz_kv
                      + 2 * r * t * nh * hd * q.element_size()
                      + tab.nbytes + p0.nbytes + tl.nbytes)
            # real queries only: query j of a row attends pos0 + j + 1 keys
            keys = sum(int(tl[i]) * int(p0[i]) + int(tl[i]) * (int(tl[i]) + 1)
                       // 2 for i in range(r))
            flops = 4.0 * nh * hd * keys
            b_ms, b_by = bound(nbytes, flops,
                               "float32" if "float32" in (qdt, kvdt)
                               else "bfloat16")
            row = {"phase": "kernel", "kernel": "ragged_paged_attention",
                   "case": name, "q_dtype": qdt, "kv_dtype": kvdt,
                   "max_abs_err": err,
                   "tolerance": BF16_TOL if qdt == "bfloat16" else F32_TOL,
                   "tolerance_reason": (
                       "bf16 output: one bf16 ulp at |o| <~ 1, f32 "
                       "accumulation on both sides" if qdt == "bfloat16"
                       else "f32: online softmax reassociates the sum "
                       "(the reference's own Pallas-vs-XLA tolerance)"),
                   "kernel_ms": kern_ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms,
                   "library": "F.scaled_dot_product_attention over the "
                              "gathered cache (gather not timed)",
                   "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            results.append(row)
    return results


def quantized_pools(dev, k32, v32, tokens_per_call=2048):
    """int8 pools + [P, NH] scales written by the port's own
    paged_kv_scatter from f32 K/V pools, page-aligned runs of tokens per
    call (each page's scale becomes its tokens' per-head amax / 127).
    Page 0, the null page, is never written: its scales stay 0."""
    import torch

    from paddle_tpu_torch.ops import paged_attention as pa

    npages, ps, nh, hd = k32.shape
    out = []
    for src in (k32, v32):
        pool = torch.zeros_like(src, dtype=torch.int8)
        scale = torch.zeros(npages, nh, device=dev)
        page = torch.arange(1, npages, device=dev).repeat_interleave(ps)
        off = torch.arange(ps, device=dev).repeat(npages - 1)
        vals = src[1:].reshape(-1, nh, hd)
        with torch.inference_mode():
            for a in range(0, page.numel(), tokens_per_call):
                sl = slice(a, a + tokens_per_call)
                pa.paged_kv_scatter(pool, scale, page[sl], off[sl], vals[sl])
        out += [pool, scale]
    kq, ks, vq, vs = out
    if float(ks[0].abs().max()) != 0.0 or float(vs[0].abs().max()) != 0.0:
        raise AssertionError("null page scale moved")
    return kq, vq, ks, vs


def kernel_phase_ragged_int8(dev, iters, seed=7, nh=16, hd=128, ps=16,
                             nps=128):
    """The ragged kernel's int8 path against _gather_attend with scales,
    on the row groups of kernel_phase_ragged (null pages in every table,
    a pad row with an all-null table)."""
    import numpy as np
    import torch
    from torch.nn import functional as TF

    from paddle_tpu_torch.ops import paged_attention as pa

    rng = np.random.RandomState(seed)
    npages = 8 * nps + 1
    g = torch.Generator(device=dev).manual_seed(seed)
    k32 = torch.randn(npages, ps, nh, hd, generator=g, device=dev)
    v32 = torch.randn(npages, ps, nh, hd, generator=g, device=dev)
    kq, vq, ks, vs = quantized_pools(dev, k32, v32)
    deq_err = float((kq[1:].float() * ks[1:, None, :, None]
                     - k32[1:]).abs().max())
    results = []
    for name, t, p0, tl, tab in ragged_groups(rng, npages, nps, ps):
        r = tab.shape[0]
        q32 = torch.randn(r, t, nh, hd, generator=g, device=dev)
        meta = [torch.from_numpy(x).to(dev) for x in (tab, p0, tl)]
        tab_d, p0_d, tl_d = meta
        qpos = p0_d[:, None] + torch.arange(t, device=dev,
                                            dtype=torch.int32)[None]
        for qdt in ("float32", "bfloat16"):
            q = q32 if qdt == "float32" else q32.bfloat16()
            with torch.inference_mode():
                out = pa.ragged_paged_attention(q, kq, vq, *meta,
                                                k_scale=ks, v_scale=vs)
                ref = pa._gather_attend(q.float(), kq, vq, tab_d, qpos,
                                        k_scale=ks, v_scale=vs)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            tol = BF16_TOL if qdt == "bfloat16" else F32_TOL
            err = 0.0
            for i in range(r):
                n = int(tl[i])
                d = (out[i, :n].float() - ref[i, :n]).abs()
                if not bool(torch.isfinite(out[i, :n]).all()):
                    raise AssertionError(f"ragged int8 {name} {qdt}: "
                                         "non-finite output")
                if bool((d > tol * (1 + ref[i, :n].abs())).any()):
                    raise AssertionError(
                        f"ragged int8 {name} q {qdt}: max abs err "
                        f"{float(d.max())} over tolerance")
                err = max(err, float(d.max()))
            # library yardstick: SDPA over the gathered, dequantized cache
            s_cap = nps * ps
            tl_ = tab_d.long()
            wide = torch.float32
            kc = (kq[tl_].to(q.dtype) * ks[tl_][:, :, None, :, None]) \
                .reshape(r, s_cap, nh, hd).transpose(1, 2).contiguous()
            vc = (vq[tl_].to(q.dtype) * vs[tl_][:, :, None, :, None]) \
                .reshape(r, s_cap, nh, hd).transpose(1, 2).contiguous()
            qt = q.to(wide).transpose(1, 2).contiguous()
            mask = (torch.arange(s_cap, device=dev)[None, None, None, :]
                    <= qpos[:, None, :, None])
            with torch.inference_mode():
                kern_ms = time_ms(lambda: pa.ragged_paged_attention(
                    q, kq, vq, *meta, k_scale=ks, v_scale=vs), iters, dev)
                plain_ms = time_ms(lambda: pa._gather_attend(
                    q, kq, vq, tab_d, qpos, k_scale=ks, v_scale=vs),
                    iters, dev)
                lib_ms = time_ms(lambda: TF.scaled_dot_product_attention(
                    qt, kc, vc, attn_mask=mask), iters, dev)
            # bytes this data needs: attended K/V positions at one byte,
            # the scale rows of the attended pages, q, o, metadata
            attended = (p0.astype(np.int64) + tl).sum()
            pages = sum(int(p0[i] + tl[i] - 1) // ps + 1 for i in range(r))
            nbytes = (2 * attended * nh * hd + 2 * pages * nh * 4
                      + 2 * r * t * nh * hd * q.element_size()
                      + tab.nbytes + p0.nbytes + tl.nbytes)
            keys = sum(int(tl[i]) * int(p0[i]) + int(tl[i]) * (int(tl[i]) + 1)
                       // 2 for i in range(r))
            b_ms, b_by = bound(nbytes, 4.0 * nh * hd * keys, qdt)
            row = {"phase": "kernel",
                   "kernel": "ragged_paged_attention_int8",
                   "case": name, "q_dtype": qdt, "kv_dtype": "int8",
                   "max_abs_err": err, "tolerance": tol,
                   "tolerance_reason": (
                       "against _gather_attend with scales on the same "
                       "int8 pools, f32-upcast queries: " + (
                           "bf16 output, one bf16 ulp at |o| <~ 1"
                           if qdt == "bfloat16" else
                           "online softmax reassociates the sum; the "
                           "page scale is folded into scores and weights")),
                   "pool_dequant_max_abs_err_vs_f32": deq_err,
                   "kernel_ms": kern_ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms,
                   "library": "F.scaled_dot_product_attention over the "
                              "gathered, dequantized cache (gather and "
                              "dequantization not timed)",
                   "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            results.append(row)
    return results


def kernel_phase_int8_matmul(dev, iters, cases, seed=8):
    """The fused int8 matmul kernel against its plain version.
    cases: (M, K, N, x dtype, relu, quant_out, out dtype, bias). The
    library yardstick is torch._int_mm on pre-quantized x plus the
    epilogue in PyTorch operations (where _int_mm takes the shape)."""
    import torch

    from paddle_tpu_torch.ops import int8_matmul as im

    g = torch.Generator(device=dev).manual_seed(seed)
    results = []
    for m, k, n, xdt, relu, quant_out, odt, has_bias in cases:
        xdtype, odtype = getattr(torch, xdt), getattr(torch, odt)
        if xdt == "int8":
            x = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                              dtype=torch.int32).to(torch.int8)
        else:
            x = (torch.randn(m, k, generator=g, device=dev) * 0.5).to(xdtype)
        w = torch.randn(k, n, generator=g, device=dev)
        ws = w.abs().amax(dim=0)
        wq = torch.round(w / ws * 127.0).clamp_(-127, 127).to(torch.int8)
        del w
        sa = torch.tensor(2.0, device=dev)          # ~4 sigma of x
        scale = (sa / 127.0) * (ws / 127.0)
        bias = torch.randn(n, generator=g, device=dev) if has_bias else None
        if quant_out:       # fold the next layer's quantizer in
            y_amax = 0.5 * k ** 0.5 * 3.0
            scale = scale * (127.0 / y_amax)
            bias = None if bias is None else bias * (127.0 / y_amax)
        qs = (127.0 / sa).reshape(1)
        kw = dict(relu=relu, quant_out=quant_out, out_dtype=odtype)

        def kern():
            return im.int8_matmul(x, wq, scale, bias, qs, **kw)

        def plain():
            return im._plain_int8_matmul(x, wq, scale, bias, qs, relu,
                                         quant_out, odtype, 127.0)

        with torch.inference_mode():
            out, ref = kern(), plain()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        want_dt = torch.int8 if quant_out else odtype
        if out.dtype != want_dt or out.shape != (m, n):
            raise AssertionError(f"int8_matmul {m}x{k}x{n}: out {out.dtype} "
                                 f"{tuple(out.shape)}")
        err = float((out.float() - ref.float()).abs().max())
        if quant_out:
            ok = bool((out == ref).all())
            spread = int(out.max()) - int(out.min())
            if spread < 50:
                raise AssertionError("int8_matmul: requantized output spans "
                                     f"only {spread} steps: a weak check")
        else:
            ok = torch.allclose(out.float(), ref.float(), rtol=INT8_MM_RTOL,
                                atol=INT8_MM_ATOL) and \
                bool(torch.isfinite(out).all())
        if not ok:
            raise AssertionError(f"int8_matmul {m}x{k}x{n} x {xdt} relu "
                                 f"{relu} quant_out {quant_out}: max abs err "
                                 f"{err} against the plain version")
        lib_ms = None
        if m > 16 and k % 8 == 0 and n % 8 == 0:
            def lib():
                xq = x if xdt == "int8" else torch.round(
                    x.float() * qs).clamp_(-127, 127).to(torch.int8)
                y = torch._int_mm(xq, wq).float() * scale
                if bias is not None:
                    y = y + bias
                if relu:
                    y = torch.relu(y)
                if quant_out:
                    return torch.round(y).clamp_(-127, 127).to(torch.int8)
                return y.to(odtype)

            with torch.inference_mode():
                if not torch.equal(lib(), ref):
                    raise AssertionError("the library yardstick computes "
                                         "another function")
                lib_ms = time_ms(lib, iters, dev)
        with torch.inference_mode():
            kern_ms = time_ms(kern, iters, dev)
            plain_ms = time_ms(plain, max(1, iters // 4), dev)
        nbytes = (x.numel() * x.element_size() + wq.numel()
                  + out.numel() * out.element_size()
                  + 4 * n * (2 if has_bias else 1) + 4)
        b_ms, b_by = bound(nbytes, 2.0 * m * k * n, "int8")
        row = {"phase": "kernel", "kernel": "int8_matmul",
               "case": (f"M{m}_K{k}_N{n}_x{xdt}"
                        + ("_relu" if relu else "")
                        + ("_quantout" if quant_out else f"_out{odt}")
                        + ("" if has_bias else "_nobias")),
               "max_abs_err": err,
               "tolerance": "equal" if quant_out else
               {"rtol": INT8_MM_RTOL, "atol": INT8_MM_ATOL},
               "tolerance_reason": (
                   "int8 output: the int32 sum is exact and the epilogue "
                   "rounds as the plain version does (no FMA)"
                   if quant_out else
                   "float output: the reference's own tolerance between "
                   "its fused kernel and the unfused expression"),
               "kernel_ms": kern_ms, "plain_ms": plain_ms,
               "library_ms": lib_ms,
               "library": "torch._int_mm on pre-quantized x + the epilogue "
                          "in PyTorch operations" if lib_ms is not None
               else None,
               "bound_ms": b_ms, "bound_by": b_by,
               "tops": 2.0 * m * k * n / (kern_ms * 1e-3) / 1e12}
        emit(row)
        results.append(row)
    return results


def kernel_phase_flash(dev, iters, shapes, seed=1):
    import torch
    from torch.nn import functional as TF

    from paddle_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(seed)
    results = []
    for (b, s, h, d), causal, dt in shapes:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev)
                   .to(dtype) for _ in range(3))
        with torch.inference_mode():
            o, lse = fa.flash_attention(q, k, v, causal=causal)
            ref, ref_lse = fa._plain_fwd(q.float(), k.float(), v.float(),
                                         causal, None)
        tol = BF16_TOL if dt == "bfloat16" else F32_TOL
        if not bool(torch.isfinite(o).all()):
            raise AssertionError("flash: non-finite output")
        err = float((o.float() - ref.float()).abs().max())
        lse_err = float((lse - ref_lse).abs().max())
        ok = torch.allclose(o.float(), ref.float(), rtol=tol, atol=tol) and \
            torch.allclose(lse, ref_lse, rtol=F32_TOL, atol=F32_TOL * 10)
        if not ok:
            raise AssertionError(f"flash {(b, s, h, d)} causal={causal} "
                                 f"{dt}: o err {err} lse err {lse_err}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        with torch.inference_mode():
            kern_ms = time_ms(lambda: fa.flash_attention(q, k, v, causal),
                              iters, dev)
            plain_ms = time_ms(lambda: fa._plain_fwd(q, k, v, causal, None),
                               max(1, iters // 4), dev)
            lib_ms = time_ms(lambda: TF.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), iters, dev)
        pairs = s * (s + 1) / 2 if causal else s * s
        flops = 4.0 * b * h * d * pairs
        nbytes = 4 * b * s * h * d * q.element_size() + 4 * b * h * s
        b_ms, b_by = bound(nbytes, flops, dt)
        row = {"phase": "kernel", "kernel": "flash_attention_fwd",
               "case": f"B{b}_S{s}_H{h}_D{d}_{'causal' if causal else 'full'}",
               "dtype": dt, "max_abs_err": err, "lse_max_abs_err": lse_err,
               "tolerance": tol,
               "tolerance_reason": (
                   "bf16 output compared in f32: one bf16 ulp at |o| <~ 1"
                   if dt == "bfloat16" else
                   "f32: online softmax reassociates the sum"),
               "kernel_ms": kern_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "library": "F.scaled_dot_product_attention",
               "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        results.append(row)
    return results


def kernel_phase_flash_bwd(dev, iters, cases, seed=4):
    """Each backward kernel against its plain version on the same inputs:
    q/k/v/dO random, o and LSE from the forward kernel, delta = rowsum(dO
    o) (or given). bf16 inputs are held to the plain version run on the
    same values upcast to f32 (the kernels keep P and dS in f32): f32
    outputs at BWD_F32_TOL, bf16 outputs against that result rounded to
    bf16 at BWD_BF16_RTOL and BWD_BF16_ATOL * max|ref|. The
    library yardstick is torch.autograd.grad through
    F.scaled_dot_product_attention minus its forward (dQ, dK and dV
    together), once per case."""
    import torch
    from torch.nn import functional as TF

    from paddle_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = torch.float32
    results = []
    for (b, s, h, d), causal, dt, out_f32, given_delta in cases:
        dtype = getattr(torch, dt)
        q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=dev)
                       .to(dtype) for _ in range(4))
        scale = 1.0 / d ** 0.5
        with torch.no_grad():
            o, lse = (fa._flash_cuda if dev.type == "cuda" else fa._plain_fwd)(
                q, k, v, causal, None)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
            .reshape(b * h, s, 1)
        if given_delta:       # the ring's global-row delta, passed in
            delta = delta * 0.5 + 0.25
        out = f32 if out_f32 else dtype
        bq, bk = fa._blocks(s, s, causal)
        single = s // bq == 1 and s // bk == 1
        res, res32 = (q, k, v, lse), (q.float(), k.float(), v.float(), lse)
        if single:
            parts = [("flash_attention_bwd_single_tile", ("dq", "dk", "dv"),
                      lambda: fa._bwd_single_tile(scale, causal, res, do,
                                                  delta, (out,) * 3),
                      lambda r=res32, o_=do.float():
                      fa._plain_bwd_single_tile(scale, causal, r, o_, delta,
                                                (f32,) * 3), 10.0)]
        else:
            parts = [("flash_attention_bwd_dq", ("dq",),
                      lambda: (fa._bwd_dq(scale, causal, res, do, delta,
                                          out),),
                      lambda r=res32, o_=do.float():
                      (fa._plain_bwd_dq(scale, causal, r, o_, delta, f32),),
                      6.0),
                     ("flash_attention_bwd_dkv", ("dk", "dv"),
                      lambda: fa._bwd_dkv(scale, causal, res, do, delta,
                                          (out,) * 2),
                      lambda r=res32, o_=do.float():
                      fa._plain_bwd_dkv(scale, causal, r, o_, delta,
                                        (f32,) * 2), 8.0)]
        # library: SDPA forward + backward, minus its forward
        qg, kg, vg = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa():
            return TF.scaled_dot_product_attention(qg, kg, vg,
                                                   is_causal=causal)

        def sdpa_grad():
            torch.autograd.grad(sdpa(), (qg, kg, vg), dot)

        with torch.no_grad():
            lib_fwd = time_ms(sdpa, iters, dev)
        lib_ms = time_ms(sdpa_grad, iters, dev) - lib_fwd
        pairs = s * (s + 1) / 2 if causal else s * s
        esz, osz = q.element_size(), torch.empty((), dtype=out).element_size()
        case = (f"B{b}_S{s}_H{h}_D{d}_{'causal' if causal else 'full'}"
                + ("_outf32" if out_f32 else "")
                + ("_delta" if given_delta else ""))
        for name, grads, kern, plain, op_factor in parts:
            got = kern()
            ref = plain()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            errs, tols = {}, {}
            for gname, x, y in zip(grads, got, ref):
                if x.dtype != out or x.shape != y.shape:
                    raise AssertionError(f"{name} {case}: {gname} "
                                         f"{x.dtype} {tuple(x.shape)}")
                if not bool(torch.isfinite(x).all()):
                    raise AssertionError(f"{name} {case}: {gname} not finite")
                if out == f32:
                    rtol = atol = BWD_F32_TOL
                else:
                    rtol = BWD_BF16_RTOL
                    atol = BWD_BF16_ATOL * float(y.abs().max())
                    y = y.to(out).float()
                tols[gname] = {"rtol": rtol, "atol": atol}
                errs[gname] = float((x.float() - y).abs().max())
                if not torch.allclose(x.float(), y, rtol=rtol, atol=atol):
                    raise AssertionError(
                        f"{name} {case} {dt}: {gname} max abs err "
                        f"{errs[gname]} over rtol {rtol} atol {atol}")
            kern_ms = time_ms(kern, iters, dev)
            plain_ms = time_ms(plain, max(1, iters // 4), dev)
            nbytes = (4 * b * s * h * d * esz + 2 * b * h * s * 4
                      + len(grads) * b * s * h * d * osz)
            flops = op_factor * b * h * d * pairs
            b_ms, b_by = bound(nbytes, flops, dt)
            row = {"phase": "kernel", "kernel": name, "case": case,
                   "dtype": dt, "out_dtype": str(out).split(".")[-1],
                   "max_abs_err": max(errs.values()), "max_abs_err_by": errs,
                   "tolerance": tols,
                   "tolerance_reason": (
                       "f32 gradients: summation order only (the "
                       "reference's own gradient tolerance)" if out == f32
                       else "bf16 gradients against the f32 plain result "
                       "rounded to bf16: one bf16 ulp, atol 1e-3 max|ref|"),
                   "kernel_ms": kern_ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms,
                   "library": "torch.autograd.grad through "
                              "F.scaled_dot_product_attention minus its "
                              "forward (dQ, dK and dV together)",
                   "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            results.append(row)
    return results


# ---------------------------------------------------------------------------
# phase 2: the model through both kernels
# ---------------------------------------------------------------------------
def model_phase(model, dev, seq=1024, chunk=256, decode_steps=4, ps=16,
                nps=128, seed=2):
    import numpy as np
    import torch

    from paddle_tpu_torch.models.gpt import gpt_ragged_apply
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    cfg = model.config
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (2, seq)).astype(np.int64)
    f0, r0 = fa.FLASH_FWD_LAUNCHES, pa.RAGGED_LAUNCHES
    with torch.inference_mode():
        ref = model(torch.from_numpy(toks).to(dev))        # [2, seq, V]
    if ref.shape != (2, seq, cfg.vocab_size) or \
            not bool(torch.isfinite(ref).all()):
        raise AssertionError(f"forward logits {tuple(ref.shape)} not finite")
    # the forward's greedy continuation: decode_steps more forwards over
    # the growing sequence (not 128-aligned: the plain attention path)
    seqs = toks.copy()
    nxt = ref[:, -1].argmax(-1).cpu().numpy()
    with torch.inference_mode():
        for i in range(decode_steps):
            seqs = np.concatenate([seqs, nxt[:, None]], axis=1)
            ext = model(torch.from_numpy(seqs).to(dev))
            nxt = ext[:, -1].argmax(-1).cpu().numpy()
    # ext holds the forward's logits at every position of the prompt plus
    # its decode_steps greedy tokens
    # the ragged path: two chunk rows of `chunk` tokens up to position
    # seq, then decode_steps one-token rows fed the forward's greedy tokens
    L, nh = cfg.num_layers, cfg.num_heads
    hd = cfg.hidden_size // nh
    npages = 2 * nps + 1
    kpool = torch.zeros(L, npages, ps, nh, hd, device=dev)
    vpool = torch.zeros_like(kpool)
    tabs = np.zeros((2, nps), np.int32)
    perm = rng.permutation(np.arange(1, npages)).astype(np.int32)
    tabs[0], tabs[1] = perm[:nps], perm[nps:2 * nps]      # scrambled pages
    stacked, other = model._decode_state()
    worst = 0.0
    n_ticks = 0
    total = seq + decode_steps

    def run(tokens, tok_pos, row_pos0, row_len, sample_ix, nd, width):
        nonlocal n_ticks

        def t(x, dtype=np.int32):
            return torch.from_numpy(np.asarray(x, dtype)).to(dev)

        limit = np.full(len(tok_pos), total)
        with torch.inference_mode():
            lg, _, _ = gpt_ragged_apply(
                cfg, stacked, other, kpool, vpool, t(tokens, np.int64),
                t(tok_pos), t(limit), t(tabs), t(row_pos0), t(row_len),
                t(sample_ix, np.int64), decode_rows=nd, chunk_width=width)
        n_ticks += 1
        return lg

    for start in range(0, seq, chunk):
        n = min(chunk, seq - start)
        tokens = np.zeros(2 * chunk, np.int64)
        tok_pos = np.zeros(2 * chunk, np.int32)
        for r in range(2):
            tokens[r * chunk:r * chunk + n] = toks[r, start:start + n]
            tok_pos[r * chunk:(r + 1) * chunk] = start + np.arange(chunk)
        sample = np.concatenate([np.arange(n), chunk + np.arange(n)])
        lg = run(tokens, tok_pos, [start, start], [n, n], sample, 0, chunk)
        want = torch.cat([ref[0, start:start + n], ref[1, start:start + n]])
        worst = max(worst, _check_close(lg, want, f"chunk {start}"))
    for p in range(seq, total):
        lg = run(seqs[:, p], [p, p], [p, p], [1, 1], [0, 1], 2, 0)
        worst = max(worst, _check_close(lg, ext[:, p], f"decode {p}"))
    flash, ragged = fa.FLASH_FWD_LAUNCHES - f0, pa.RAGGED_LAUNCHES - r0
    if flash != L or ragged != L * n_ticks:
        raise AssertionError(f"launch counters: flash {flash} (want {L}), "
                             f"ragged {ragged} (want {L * n_ticks})")
    row = {"phase": "model", "config": "gpt3_1_3b", "layers": L,
           "forward": [2, seq], "decode_steps": decode_steps,
           "ragged_ticks": n_ticks,
           "max_abs_logit_err": worst, "tolerance": MODEL_TOL,
           "tolerance_reason": "24 layers of f32 in different reduction "
                               "orders (TF32 off)",
           "flash_launches": flash, "ragged_launches": ragged}
    emit(row)
    return row


def _check_close(got, want, what) -> float:
    import torch

    if not torch.allclose(got, want, rtol=MODEL_TOL, atol=MODEL_TOL):
        raise AssertionError(f"ragged logits at {what} differ from "
                             f"GPT.forward: {float((got - want).abs().max())}")
    return float((got - want).abs().max())


# ---------------------------------------------------------------------------
# phase 3: the serving engine
# ---------------------------------------------------------------------------
def engine_prompts(cfg, n_req=16, seed=3, prefix=512, lo=64, hi=1024):
    """The serving workload: n_req prompts of lo..hi tokens, half of them
    behind one shared prefix."""
    import numpy as np

    rng = np.random.RandomState(seed)
    shared = rng.randint(0, cfg.vocab_size, prefix).astype(np.int32)
    # the shared requests' tails open with the same 8 tokens: their first
    # page past the prefix agrees mid-page with a cached one, so admission
    # copies that page on write (COW) before prefilling the rest
    head = rng.randint(0, cfg.vocab_size, 8).astype(np.int32)
    prompts = []
    for i in range(n_req):
        if i % 2 == 0:                   # half share one prefix
            n = rng.randint(prefix + 24, hi + 1)
            tail = rng.randint(0, cfg.vocab_size, n - prefix - 8)
            prompts.append(np.concatenate([shared, head, tail])
                           .astype(np.int32))
        else:
            n = rng.randint(lo, hi + 1)
            prompts.append(rng.randint(0, cfg.vocab_size, n).astype(np.int32))
    return prompts


def engine_phase(model, dev, n_req=16, max_new=32, n_check=4, keep=None,
                 **engine_kw):
    """keep: a dict that receives the prompts, the streams and the pool's
    bytes (the kvint8 phase compares against them)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = model.config
    prompts = engine_prompts(cfg, n_req)
    eng = ServingEngine(model, ServingConfig(**engine_kw))
    reg = registry()
    ticks0 = reg.counter("serving/ticks").value
    hits0 = reg.counter("serving/prefix_hit_tokens").value
    cow0 = reg.counter("cache_share/cow_copies").value
    r0 = pa.RAGGED_LAUNCHES
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new) for p in prompts]
    out = eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    ticks = int(reg.counter("serving/ticks").value - ticks0)
    ragged = pa.RAGGED_LAUNCHES - r0
    for rid in rids:
        if out[rid].shape != (max_new,):
            raise AssertionError(f"request {rid}: {out[rid].shape} tokens")
    cows = int(reg.counter("cache_share/cow_copies").value - cow0)
    if cows == 0:
        raise AssertionError("no copy-on-write page copy ran")
    if ragged < cfg.num_layers * ticks:
        raise AssertionError(f"ragged launches {ragged} < "
                             f"{cfg.num_layers} x {ticks} ticks")
    # teacher-forced greedy check: GPT.forward over prompt + the engine's
    # stream recomputes every step's argmax in one call
    match = total = 0
    for i in range(n_check):
        p, o = prompts[i], out[rids[i]]
        seq = np.concatenate([p, o[:-1]]).astype(np.int64)
        with torch.inference_mode():
            lg = model(torch.from_numpy(seq)[None].to(dev))[0]
        pred = lg[len(p) - 1:].argmax(-1).cpu().numpy()
        match += int((pred == o).sum())
        total += len(o)
    rate = match / total
    row = {"phase": "engine", "config": "gpt3_1_3b", "requests": n_req,
           "max_new_tokens": max_new, "ticks": ticks,
           "ragged_launches": ragged, "wall_s": wall,
           "tokens_per_s": n_req * max_new / wall,
           "prefix_hit_tokens": reg.counter(
               "serving/prefix_hit_tokens").value - hits0,
           "cow_copies": cows,
           "greedy_match_rate": rate, "checked_streams": n_check}
    if rate < 0.9:
        emit(row)
        raise AssertionError(f"greedy match rate {rate} < 0.9")
    if keep is not None:
        keep.update(prompts=prompts, streams=[out[r] for r in rids],
                    pool_bytes=eng.pool.nbytes)
    row.update(warm_engine_profile(model, dev, prompts, max_new,
                                   engine_kw)[0])
    emit(row)
    return row


def warm_engine_profile(model, dev, prompts, max_new, engine_kw):
    """The same requests again on fresh engines, now that every shape has
    run once: one run timed plainly (warm tokens/s), one under
    torch.profiler for the card's kernel time. Device busy share = summed
    kernel time / the plain run's wall time. Returns (the numbers, the
    plain run's streams)."""
    import torch

    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    streams = []

    def serve():
        eng = ServingEngine(model, ServingConfig(**engine_kw))
        rids = [eng.submit(p, max_new) for p in prompts]
        out = eng.run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        streams[:] = [out[r] for r in rids]

    t0 = time.perf_counter()
    serve()
    warm = time.perf_counter() - t0
    warm_streams = list(streams)
    _, kernels = profile_kernels(dev, serve)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {
        "warm_wall_s": warm,
        "warm_tokens_per_s": len(prompts) * max_new / warm,
        "warm_device_kernel_ms": busy_ms if kernels else None,
        "warm_device_busy_share": busy_ms / 1e3 / warm if kernels else None,
        "warm_top_kernels": top_kernels(kernels, 6)}, warm_streams


def profile_kernels(dev, fn):
    """(fn's result, the card's kernels by name) of one call of ``fn``
    under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        out = fn()
    return out, [e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA]


def top_kernels(kernels, n):
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:n]
    return [{"name": e.key[:70], "ms": e.self_device_time_total / 1e3,
             "count": e.count} for e in top]


# ---------------------------------------------------------------------------
# phase 6: the serving engine on int8 KV pages
# ---------------------------------------------------------------------------
def ragged_prompt_logits(model, dev, toks, decode_toks=None, quantized=False,
                         chunk=256, decode_steps=4, ps=16, nps=128,
                         stride=8):
    """gpt_ragged_apply over one prompt: chunks of `chunk` tokens (logits
    at every `stride`-th position and the last), then `decode_steps`
    one-token rows fed `decode_toks` (None: this run's own greedy tokens,
    which it returns). f32 pools, or int8 pools with scales."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models.gpt import gpt_ragged_apply

    cfg = model.config
    L, nh = cfg.num_layers, cfg.num_heads
    hd = cfg.hidden_size // nh
    seq = len(toks)
    total = seq + decode_steps
    kpool = torch.zeros(L, nps + 1, ps, nh, hd, device=dev,
                        dtype=torch.int8 if quantized else torch.float32)
    vpool = torch.zeros_like(kpool)
    scales = {}
    if quantized:
        scales = dict(kscale=torch.zeros(L, nps + 1, nh, device=dev),
                      vscale=torch.zeros(L, nps + 1, nh, device=dev))
    tab = np.random.RandomState(seq).permutation(
        np.arange(1, nps + 1)).astype(np.int32)[None]
    stacked, other = model._decode_state()

    def t(x, dtype=np.int32):
        return torch.from_numpy(np.asarray(x, dtype)).to(dev)

    def run(tokens, tok_pos, pos0, n, sample, nd, width):
        with torch.inference_mode():
            return gpt_ragged_apply(
                cfg, stacked, other, kpool, vpool, t(tokens, np.int64),
                t(tok_pos), t(np.full(len(tok_pos), total)), t(tab),
                t([pos0]), t([n]), t(sample, np.int64), decode_rows=nd,
                chunk_width=width, **scales)[0]

    logits = []
    for start in range(0, seq, chunk):
        n = min(chunk, seq - start)
        tokens = np.zeros(chunk, np.int64)
        tokens[:n] = toks[start:start + n]
        sample = sorted(set(range(0, n, stride)) | {n - 1})
        logits.append(run(tokens, start + np.arange(chunk), start, n,
                          sample, 0, chunk))
    fed = []
    nxt = int(logits[-1][-1].argmax())
    for i in range(decode_steps):
        tok = nxt if decode_toks is None else int(decode_toks[i])
        fed.append(tok)
        lg = run([tok], [seq + i], seq + i, 1, [0], 1, 0)
        logits.append(lg)
        nxt = int(lg[0].argmax())
    if quantized and (float(scales["kscale"][:, 0].abs().max()) != 0.0
                      or float(scales["vscale"][:, 0].abs().max()) != 0.0):
        raise AssertionError("kvint8: the null page's scale moved")
    return torch.cat(logits), fed


def kvint8_reference(model, dev, keep, engine_kw, max_new=32, seq=1024,
                     seed=9):
    """What the kvint8 phase compares against, made with f32 pools before
    its launch counts start: the f32 engine's streams and pool bytes
    (taken from the engine phase when that ran) and the f32-pool logits of
    one `seq`-token prompt."""
    import numpy as np

    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = model.config
    if "streams" not in keep:
        prompts = engine_prompts(cfg)
        eng = ServingEngine(model, ServingConfig(**engine_kw))
        rids = [eng.submit(p, max_new) for p in prompts]
        out = eng.run()
        keep.update(prompts=prompts, streams=[out[r] for r in rids],
                    pool_bytes=eng.pool.nbytes)
    toks = np.random.RandomState(seed).randint(0, cfg.vocab_size, seq)
    logits, fed = ragged_prompt_logits(model, dev, toks)
    keep.update(logit_toks=toks, logits=logits, fed=fed)
    return keep


def kvint8_phase(model, dev, ref, max_new=32, **engine_kw):
    import numpy as np
    import torch

    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = model.config
    engine_kw = dict(engine_kw, kv_dtype="int8")
    prompts = ref["prompts"]
    # the hold on correctness: int8-pool logits against the f32-pool run
    got, _ = ragged_prompt_logits(model, dev, ref["logit_toks"], ref["fed"],
                                  quantized=True)
    want = ref["logits"]
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"kvint8: logits {tuple(got.shape)} not finite")
    rel = float((got - want).abs().max()) / float(want.abs().max())
    argmax_match = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    if rel > KVINT8_LOGIT_TOL:
        raise AssertionError(f"kvint8: max |dlogit| / max |logit| {rel} > "
                             f"{KVINT8_LOGIT_TOL}")
    # the engine
    reg = registry()
    ticks0 = reg.counter("serving/ticks").value
    cow0 = reg.counter("cache_share/cow_copies").value
    r0 = pa.RAGGED_LAUNCHES
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    t0 = time.perf_counter()
    eng = ServingEngine(model, ServingConfig(**engine_kw))
    rids = [eng.submit(p, max_new) for p in prompts]
    out = eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    streams = [out[r] for r in rids]
    ticks = int(reg.counter("serving/ticks").value - ticks0)
    ragged = pa.RAGGED_LAUNCHES - r0
    pool = eng.pool
    if not pool.quantized or pool.k.dtype != torch.int8:
        raise AssertionError("kvint8: the pool is not int8")
    if ragged < cfg.num_layers * ticks:
        raise AssertionError(f"kvint8: ragged launches {ragged} < "
                             f"{cfg.num_layers} x {ticks} ticks")
    if int(reg.counter("cache_share/cow_copies").value - cow0) == 0:
        raise AssertionError("kvint8: no copy-on-write page copy ran")
    ratio = pool.nbytes / ref["pool_bytes"]
    if ratio > KVINT8_BYTES_RATIO:
        raise AssertionError(f"kvint8: pool bytes ratio {ratio}")
    null = max(float(pool.k_scale[:, 0].abs().max()),
               float(pool.v_scale[:, 0].abs().max()))
    if null != 0.0:
        raise AssertionError(f"kvint8: null-page scale {null}")
    if eng.pool.check_consistency():
        raise AssertionError(f"kvint8: {eng.pool.check_consistency()}")
    match = sum(int((a == b).sum()) for a, b in zip(streams, ref["streams"]))
    rate = match / (len(streams) * max_new)
    row = {"phase": "kvint8", "config": "gpt3_1_3b", "requests": len(prompts),
           "max_new_tokens": max_new, "ticks": ticks,
           "ragged_launches": ragged, "wall_s": wall,
           "tokens_per_s": len(prompts) * max_new / wall,
           "pool_bytes": pool.nbytes, "f32_pool_bytes": ref["pool_bytes"],
           "pool_bytes_ratio": ratio, "null_page_scale": null,
           "logit_max_rel_err_vs_f32_pools": rel,
           "logit_tolerance": KVINT8_LOGIT_TOL,
           "logit_argmax_match": argmax_match,
           "logit_positions": int(got.shape[0]),
           "token_match_vs_f32_engine": rate,
           "token_match_floor": KVINT8_MATCH_FLOOR,
           "peak_memory_gib_above_model": (peak - mem0) / 2 ** 30}
    if rate < KVINT8_MATCH_FLOOR:
        emit(row)
        raise AssertionError(f"kvint8: token match {rate} against the f32 "
                             f"engine < {KVINT8_MATCH_FLOOR}")
    prof, again = warm_engine_profile(model, dev, prompts, max_new, engine_kw)
    for a, b in zip(streams, again):
        if not np.array_equal(a, b):
            raise AssertionError("kvint8: two int8 runs gave different "
                                 "streams")
    row["two_runs_equal"] = True
    row.update(prof)
    # every launch of this phase ran the kernel's int8 path
    if pa.RAGGED_INT8_LAUNCHES != pa.RAGGED_LAUNCHES:
        raise AssertionError(
            f"kvint8: {pa.RAGGED_LAUNCHES - pa.RAGGED_INT8_LAUNCHES} ragged "
            "launches did not run over int8 pools")
    emit(row)
    return row


# ---------------------------------------------------------------------------
# phase 7: int8 deploy of a quantized MLP
# ---------------------------------------------------------------------------
def deploy_phase(dev, iters, batch=4096, d=4096, h=16384, seed=7):
    """QAT().quantize -> calibration forward -> eval ->
    convert_to_int8_deploy -> net(x) on Sequential(Linear(d, h), ReLU,
    Linear(h, d)), calibrated on f32 x and served on the same x in bf16."""
    import torch

    from paddle_tpu_torch import nn, quantization as Q
    from paddle_tpu_torch.core import rng as _rng
    from paddle_tpu_torch.ops import int8_matmul as im

    _rng.seed(seed)
    net = nn.Sequential(nn.Linear(d, h, device=dev), nn.ReLU(),
                        nn.Linear(h, d, device=dev))
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(batch, d, generator=g, device=dev) * 0.5
    Q.QAT().quantize(net)
    net.train()
    with torch.no_grad():
        net(x)                      # calibration forward
    net.eval()
    with torch.no_grad():
        want = net(x)               # the QAT-eval output
    if Q.convert_to_int8_deploy(net) != 2:
        raise AssertionError("deploy: expected 2 converted layers")
    fc1, fc2 = net[0], net[2]
    if not (fc1._fuse_relu and fc1._next_scale is fc2.act_scale
            and fc2._int8_src is fc1):
        raise AssertionError("deploy: the fusion pass did not wire fc1 -> "
                             "fc2")
    xb = x.bfloat16()
    mids = []
    hook = fc1.register_forward_hook(lambda m, i, o: mids.append(o))
    n0 = im.INT8_MATMUL_LAUNCHES
    got = net(xb)
    launches = im.INT8_MATMUL_LAUNCHES - n0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        if launches != 2:
            raise AssertionError(f"deploy: one forward made {launches} "
                                 "launches of the int8 matmul, not 2")
    if got.dtype != torch.bfloat16 or got.shape != (batch, d) or \
            not bool(torch.isfinite(got).all()):
        raise AssertionError(f"deploy: output {got.dtype} "
                             f"{tuple(got.shape)}")
    # the plain chain: this script binds the plain version in place of the
    # kernel launch (in this process only; the package has no such switch)
    saved = im._int8_matmul_cuda
    try:
        im._int8_matmul_cuda = im._plain_int8_matmul
        ref = net(xb)
    finally:
        im._int8_matmul_cuda = saved
        hook.remove()
    mid, mid_ref = mids
    if mid.dtype != torch.int8 or not torch.equal(mid, mid_ref):
        raise AssertionError("deploy: the int8 intermediate differs from "
                             "the plain chain's")
    if int(mid.max()) < 50 or int(mid.min()) != 0:
        raise AssertionError("deploy: the int8 intermediate is degenerate")
    err = float((got.float() - ref.float()).abs().max())
    if not torch.allclose(got.float(), ref.float(), rtol=2.0 ** -7,
                          atol=INT8_MM_ATOL):
        raise AssertionError(f"deploy: output differs from the plain "
                             f"chain's by {err}")
    rel = float((got.float() - want).abs().max()) / float(want.abs().max())
    if rel > DEPLOY_QAT_TOL:
        raise AssertionError(f"deploy: max error against the QAT-eval "
                             f"output {rel} of max |y| > {DEPLOY_QAT_TOL}")
    with torch.inference_mode():
        ms = time_ms(lambda: net(xb), iters, dev)
    row = {"phase": "deploy", "model": f"Sequential(Linear({d}, {h}), ReLU, "
                                       f"Linear({h}, {d}))",
           "batch": batch, "input_dtype": "bfloat16",
           "output_dtype": "bfloat16", "int8_matmul_launches": launches,
           "int8_intermediate_equal_plain": True,
           "max_abs_err_vs_plain_chain": err,
           "plain_chain_tolerance": {"rtol": 2.0 ** -7,
                                     "atol": INT8_MM_ATOL},
           "plain_chain_tolerance_reason": "both round the same f32 "
                                           "result to bf16: one bf16 ulp",
           "max_rel_err_vs_qat_eval": rel, "qat_tolerance": DEPLOY_QAT_TOL,
           "forward_ms": ms,
           "tops": 4.0 * batch * d * h / (ms * 1e-3) / 1e12}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# phase 4: GPT.loss gradients through the backward kernels
# ---------------------------------------------------------------------------
PLAIN_ATTENTION = {"_flash_cuda": "_plain_fwd",
                   "_bwd_single_tile": "_plain_bwd_single_tile",
                   "_bwd_dq": "_plain_bwd_dq", "_bwd_dkv": "_plain_bwd_dkv"}


def grad_phase(dev, layers=2, seq=2048, seed=5):
    """GPT.loss at gpt3_1_3b width and `layers` deep, f32, one sequence
    of `seq` tokens (2 x 2 tiles: the dQ + dK/dV pair): every parameter's
    gradient through the kernels against a reference run in which this
    script binds the plain attention functions into the module (in this
    process only; the package has no such switch)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.core import rng as _rng
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = GPTConfig.gpt3_1_3b()
    cfg.num_layers = layers
    _rng.seed(seed)
    model = GPT(cfg, device=dev)
    toks = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (1, seq))).to(dev)

    def grads():
        for p in model.parameters():
            p.grad = None
        loss = model.loss(toks)
        loss.backward()
        return float(loss.detach()), {n: p.grad.clone()
                             for n, p in model.named_parameters()}

    loss, got = grads()
    saved = {k: getattr(fa, k) for k in PLAIN_ATTENTION}
    try:
        for k, v in PLAIN_ATTENTION.items():
            setattr(fa, k, getattr(fa, v))
        ref_loss, ref = grads()
    finally:
        for k, v in saved.items():
            setattr(fa, k, v)
    worst, worst_name = 0.0, None
    for n, g in got.items():
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"grad phase: {n} gradient not finite")
        rel = float((g - ref[n]).abs().max()) / max(
            float(ref[n].abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, n
    row = {"phase": "grad", "config": "gpt3_1_3b", "layers": layers,
           "batch": [1, seq], "dtype": "float32", "loss": loss,
           "reference_loss": ref_loss, "max_rel_grad_err": worst,
           "worst_param": worst_name, "tolerance": GRAD_TOL,
           "tolerance_reason": "max |dg| / max |g| per parameter: the same "
                               "f32 math in different reduction orders "
                               "(TF32 off)"}
    emit(row)
    if worst > GRAD_TOL or abs(loss - ref_loss) > GRAD_TOL * abs(ref_loss):
        raise AssertionError(f"grad phase: {worst_name} rel err {worst}, "
                             f"loss {loss} vs {ref_loss}")
    return row


# ---------------------------------------------------------------------------
# phase 5: the single-chip training recipe at full size
# ---------------------------------------------------------------------------
def train_phase(dev, steps=8, short_steps=2, batch=4, seq=2048, n_micro=2,
                seed=6, layers=None):
    """HybridPipelineTrainer at gpt3_1_3b (the recipe of
    examples/train_gpt_1p3b_single_chip.py: amp, recompute, bf16
    parameters and moments, AdamW 0.1 under the warmup-cosine schedule,
    global-norm clip 1.0), `steps` steps on one fixed random batch
    [batch, seq] (the loss must fall), one more under torch.profiler, then
    `short_steps` on a [batch, seq // 2] batch, which takes the merged
    single-tile backward."""
    import numpy as np
    import torch

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.core import rng as _rng
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.hybrid import HybridPipelineTrainer
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.optimizer import AdamW, lr

    cfg = GPTConfig.gpt3_1_3b()
    if layers:
        cfg.num_layers = layers
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    _rng.seed(seed)
    model = GPT(cfg, device=dev)
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(2e-4, T_max=1000),
                            warmup_steps=20, start_lr=1e-6, end_lr=2e-4)
    opt = AdamW(sched, parameters=model.named_parameters(), weight_decay=0.1,
                grad_clip=nn.ClipGradByGlobalNorm(1.0))
    s = DistributedStrategy()
    s.amp = True
    s.recompute = True
    tr = HybridPipelineTrainer(model, opt, s, n_micro=n_micro,
                               param_dtype="bfloat16",
                               moment_dtype="bfloat16")
    rng = np.random.RandomState(seed)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                          (batch, seq))).to(dev)

    def run(toks):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss = float(tr.step(toks))          # syncs on the loss
        ms = (time.perf_counter() - t0) * 1e3
        sched.step()
        if not np.isfinite(loss):
            raise AssertionError(f"train phase: loss {loss} not finite")
        return loss, ms

    losses, times = zip(*[run(tokens) for _ in range(steps)])
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train phase: loss did not fall: {losses}")
    step_ms = float(np.median(times[2:]))
    tok_s = batch * seq / (step_ms / 1e3)
    row = {"phase": "train", "config": "gpt3_1_3b",
           "layers": cfg.num_layers, "batch": [batch, seq],
           "n_micro": n_micro, "amp": True, "recompute": True,
           "param_dtype": "bfloat16", "moment_dtype": "bfloat16",
           "losses": list(losses), "step_ms": list(times),
           "step_ms_median_3_to_8": step_ms, "tokens_per_s": tok_s,
           "mfu": tok_s * cfg.flops_per_token(seq) / PEAK_FLOPS["bfloat16"],
           "mfu_basis": "tokens/s x GPTConfig.flops_per_token(S) / 989e12 "
                        "(bf16 dense)",
           "max_memory_allocated_gib": (
               torch.cuda.max_memory_allocated(dev) / 2 ** 30
               if dev.type == "cuda" else None)}
    row.update(profile_step(dev, lambda: run(tokens)))
    short = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                         (batch, seq // 2))).to(dev)
    row["short_batch"] = [batch, seq // 2]
    row["short_losses"] = [run(short)[0] for _ in range(short_steps)]
    emit(row)
    return row


def profile_step(dev, step) -> dict:
    """One warm step under torch.profiler: the card's kernel time summed
    by kind, and busy share = summed kernel time / the step's wall time."""
    (loss, wall_ms), kernels = profile_kernels(dev, step)
    kinds = {}
    for e in kernels:
        k = e.key.lower()
        kind = ("flash_bwd" if "flash_bwd" in k else
                "flash_fwd" if "flash_fwd" in k else
                "matmul" if any(x in k for x in ("gemm", "nvjet", "cutlass",
                                                 "xmma", "wgmma")) else
                "other")
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 1e3
    busy = sum(kinds.values())
    return {"profiled_step_loss": loss, "profiled_step_wall_ms": wall_ms,
            "profiled_device_kernel_ms": busy if kernels else None,
            "profiled_device_busy_share": busy / wall_ms if kernels
            else None,
            "profiled_kernel_ms_by_kind": kinds,
            "profiled_top_kernels": top_kernels(kernels, 8)}


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20,
                    help="timed calls per kernel measurement")
    ap.add_argument("--phases", default="kernels,model,engine,kvint8,deploy,"
                                        "grad,train",
                    help="comma-separated subset (debugging)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import paddle_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 2
    pkg_dir = os.path.dirname(os.path.abspath(paddle_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != HERE:
        print(f"chip_smoke: paddle_tpu_torch found at {pkg_dir}, not in "
              "this checkout", file=sys.stderr)
        return 2
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import int8_matmul as im
    from paddle_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"setup": "tf32", "matmul_allow_tf32": False,
          "cudnn_allow_tf32": False})
    smi = gpu_info_line()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    emit({"setup": "device", "kind": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    _build.build()
    ptxas = {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in _build.SOURCES}
    emit({"setup": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas})

    cfg = GPTConfig.gpt3_1_3b()
    nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    kern = {}
    if "kernels" in phases:
        rag = kernel_phase_ragged(dev, args.iters, nh=nh, hd=hd)
        fl = kernel_phase_flash(dev, args.iters, [
            ((2, 1024, nh, hd), True, "float32"),      # the model's shape
            ((2, 1000, nh, hd), True, "float32"),      # a ragged last tile
            ((4, 2048, nh, hd), True, "float32"),
            ((4, 2048, nh, hd), False, "float32"),
            ((4, 2048, nh, hd), True, "bfloat16"),
            ((4, 2048, nh, hd), False, "bfloat16")])
        bw = kernel_phase_flash_bwd(dev, args.iters, [
            # row 2: S <= 1024 is one reference tile
            ((2, 1024, nh, hd), True, "bfloat16", False, False),
            ((2, 1024, nh, hd), True, "float32", False, False),
            ((2, 1000, nh, hd), True, "float32", False, False),
            ((2, 1024, nh, hd), False, "float32", False, False),
            # bf16 in, f32 out: the atomically summed dQ scratch held at
            # the f32 tolerance
            ((2, 1024, nh, hd), True, "bfloat16", True, False),
            # rows 3/4: gpt3_1_3b's S = 2048 is 2 x 2 tiles
            ((2, 2048, nh, hd), True, "bfloat16", False, False),
            ((2, 2048, nh, hd), True, "float32", False, False),
            ((2, 2048, nh, hd), False, "float32", False, False),
            ((2, 2048, nh, hd), True, "bfloat16", True, True)])
        kern["ragged"] = next(r for r in rag if r["case"] == "decode_R8_T1"
                              and r["q_dtype"] == r["kv_dtype"] == "float32")
        kern["flash"] = fl[0]
        kern["bwd_single"] = bw[0]
        kern["bwd_dq"] = next(r for r in bw if r["kernel"].endswith("_dq"))
        kern["bwd_dkv"] = next(r for r in bw if r["kernel"].endswith("_dkv"))
        rq = kernel_phase_ragged_int8(dev, args.iters, nh=nh, hd=hd)
        kern["ragged_int8"] = next(
            r for r in rq if r["case"] == "decode_R8_T1"
            and r["q_dtype"] == "float32")
        # (M, K, N, x, relu, quant_out, out, bias): the deploy model's two
        # layers (fc1 under bf16 x with ReLU + requantize is the main
        # path's first launch, fc2 under int8 x its second), then ragged
        # edges in M, K and N
        mm = kernel_phase_int8_matmul(dev, args.iters, [
            (4096, 4096, 16384, "bfloat16", True, True, "float32", True),
            (4096, 16384, 4096, "int8", False, False, "bfloat16", True),
            (4096, 4096, 16384, "float32", False, False, "float32", True),
            (4096, 4096, 16384, "bfloat16", False, False, "float32", True),
            (4096, 4096, 16384, "float32", True, True, "float32", True),
            (67, 130, 45, "float32", False, False, "float32", True),
            (67, 130, 45, "float32", False, False, "float32", False),
            (67, 130, 45, "bfloat16", True, True, "float32", True),
            (67, 130, 45, "int8", False, False, "bfloat16", False)])
        kern["int8_matmul"] = mm[0]

    from paddle_tpu_torch.core import rng as _rng

    # the main paths' launches: every count set to 0 just before a path
    # and read just after it; each path must launch each of its kernels
    counters = {"flash": (fa, "FLASH_FWD_LAUNCHES"),
                "bwd_single": (fa, "FLASH_BWD_SINGLE_LAUNCHES"),
                "bwd_dq": (fa, "FLASH_BWD_DQ_LAUNCHES"),
                "bwd_dkv": (fa, "FLASH_BWD_DKV_LAUNCHES"),
                "ragged": (pa, "RAGGED_LAUNCHES"),
                "ragged_int8": (pa, "RAGGED_INT8_LAUNCHES"),
                "int8_matmul": (im, "INT8_MATMUL_LAUNCHES")}
    launches = {k: 0 for k in counters}
    by_path = {}

    def drive(path, needs, fn, *a, **kw):
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        fn(*a, **kw)
        got = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        by_path[path] = got
        for k, n in got.items():
            launches[k] += n
        missing = [k for k in needs if got[k] == 0]
        if missing:
            raise AssertionError(f"the {path} path never launched {missing}")

    model = None
    if phases & {"model", "engine", "kvint8"}:
        _rng.seed(0)
        model = GPT(cfg, device=dev)
        model.eval()
    if "model" in phases:
        drive("model", ("flash", "ragged"), model_phase, model, dev)
    engine_kw = dict(num_slots=8, page_size=16, pages_per_slot=128,
                     prefill_chunk=256, prefill_chunks_per_tick=2)
    f32_run = {}
    if "engine" in phases:
        drive("engine", ("ragged",), engine_phase, model, dev, keep=f32_run,
              **engine_kw)
    if "kvint8" in phases:
        kvint8_reference(model, dev, f32_run, engine_kw)
        drive("kvint8", ("ragged", "ragged_int8"), kvint8_phase, model, dev,
              f32_run, **engine_kw)
    del model, f32_run
    if "deploy" in phases:
        drive("deploy", ("int8_matmul",), deploy_phase, dev, args.iters)
    if "grad" in phases:
        drive("grad", ("flash", "bwd_dq", "bwd_dkv"), grad_phase, dev)
    if "train" in phases:
        drive("train", ("flash", "bwd_single", "bwd_dq", "bwd_dkv"),
              train_phase, dev)
    emit({"launches_by_path": by_path})

    if kern:
        line = []
        bwd_src = "paddle_tpu_torch/csrc/flash_attention_bwd.cu"
        for key, name, src, replaces in (
                ("flash", "flash_attention_fwd",
                 "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
                 "paddle_tpu/ops/flash_attention.py:118"),
                ("bwd_single", "flash_attention_bwd_single_tile", bwd_src,
                 "paddle_tpu/ops/flash_attention.py:313"),
                ("bwd_dq", "flash_attention_bwd_dq", bwd_src,
                 "paddle_tpu/ops/flash_attention.py:221"),
                ("bwd_dkv", "flash_attention_bwd_dkv", bwd_src,
                 "paddle_tpu/ops/flash_attention.py:264"),
                ("ragged", "ragged_paged_attention",
                 "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
                 "paddle_tpu/ops/paged_attention.py:294"),
                ("ragged_int8", "ragged_paged_attention_int8",
                 "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
                 "paddle_tpu/ops/paged_attention.py:294"),
                ("int8_matmul", "int8_matmul",
                 "paddle_tpu_torch/csrc/int8_matmul.cu",
                 "paddle_tpu/ops/int8_matmul.py:50")):
            r = kern[key]
            line.append({"name": name, "route": "cuda", "source": src,
                         "replaces": replaces, "launches": launches[key],
                         "launches_by_path": {p: n[key] for p, n in
                                              by_path.items()},
                         "shape": r["case"],
                         "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                         "bound_by": r["bound_by"],
                         "library_ms": r["library_ms"]})
        emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
