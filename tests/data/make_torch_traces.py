"""Write the torch.profiler trace fixtures of tests/test_torch_device_trace.py.

    python tests/data/make_torch_traces.py        # from the repo root

- ``torch_mini_cpu.trace.json.gz``: a trace ``torch.profiler`` writes on
  the CPU around two dispatches of a tiny step (``relu(x @ w).sum()``
  inside a ``record_function`` range named ``hybrid.step#0``) and one op
  outside any range. The events ``parse_timeline`` reads (``cpu_op`` and
  ``user_annotation``) are kept as written, their times shifted to start
  at 0; the profiler's metadata is left out.
- ``torch_mini_cuda.trace.json.gz``: a hand-written trace shaped as
  ``torch.profiler`` writes one on a card: ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset`` events joined by ``args.correlation`` to their
  ``cuda_runtime`` / ``cuda_driver`` launches, a ``gpu_user_annotation``
  span over the site's kernels, ``cpu_op`` events (ignored beside the
  card's slices), flow events, and two backward kernels launched from a
  second thread (the autograd engine's) that no range encloses.
- ``torch_gloo_cuda.trace.json.gz``: a hand-written trace of gloo
  collectives on CUDA tensors, shaped as ``torch.profiler`` wrote one on
  an H100 (torch 2.11): the caller thread's ``c10d::allreduce_`` /
  ``c10d::_allgather_base_`` ops launch a device-to-pinned copy, gloo's
  worker thread launches the pinned-to-device copy inside its
  ``gloo:all_reduce`` / ``gloo:all_gather`` range; beside them a compute
  kernel, an NCCL kernel and a copy outside any collective.
"""
import gzip
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def cpu_trace() -> dict:
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(16, 32)
    w = torch.randn(32, 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with record_function("hybrid.step#0"):
                torch.relu(x @ w).sum()
        x + 1.0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.json")
        prof.export_chrome_trace(path)
        doc = json.load(open(path))
    keep = [e for e in doc["traceEvents"] if e.get("ph") == "X"
            and e.get("cat") in ("cpu_op", "user_annotation")]
    t0 = min(e["ts"] for e in keep)
    for e in keep:
        e["ts"] = round(e["ts"] - t0, 3)
        e["pid"], e["tid"] = 1, 1
    return {"traceEvents": keep}


def cuda_trace() -> dict:
    host, gpu = 100, 0
    main, autograd, stream = 1, 2, 7

    def x(cat, name, pid, tid, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
                "ts": ts, "dur": dur, "args": args}

    def launch(tid, ts, corr, name="cudaLaunchKernel", cat="cuda_runtime"):
        return x(cat, name, host, tid, ts, 5.0, correlation=corr)

    def kern(name, ts, dur, corr, cat="kernel"):
        return x(cat, name, gpu, stream, ts, dur, correlation=corr,
                 device=0, stream=stream)

    evs = [
        {"ph": "M", "name": "process_name", "pid": host,
         "args": {"name": "python"}},
        x("Trace", "PyTorch Profiler (0)", "Spans", "PyTorch Profiler", 0.0,
          5000.0),
        x("user_annotation", "hybrid.step#0", host, main, 1000.0, 900.0),
        x("user_annotation", "fwd/blocks", host, main, 1010.0, 190.0),
        x("cpu_op", "aten::mm", host, main, 1025.0, 3.0),
        launch(main, 1020.0, 1),
        kern("void flash_fwd_tc_kernel<128>(CUtensorMap, int)", 1100.0,
             200.0, 1),
        launch(main, 1030.0, 2),
        kern("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNN", 1300.0, 100.0,
             2),
        launch(main, 1040.0, 3, name="cudaMemcpyAsync"),
        kern("Memcpy HtoD (Pinned -> Device)", 1050.0, 20.0, 3,
             cat="gpu_memcpy"),
        # the autograd engine's thread: no range of its own
        launch(autograd, 1500.0, 4),
        kern("void flash_bwd_dq_tc_kernel<128>(CUtensorMap, int)", 1520.0,
             150.0, 4),
        launch(autograd, 1510.0, 5, name="cuLaunchKernel",
               cat="cuda_driver"),
        kern("void flash_bwd_dkv_tc_kernel<128>(CUtensorMap, int)", 1680.0,
             150.0, 5),
        # spans the site's kernels on the card: not device work
        x("gpu_user_annotation", "hybrid.step#0", gpu, stream, 1100.0,
          730.0),
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 4, "pid": host,
         "tid": autograd, "ts": 1500.0},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 4, "pid": gpu,
         "tid": stream, "ts": 1520.0, "bp": "e"},
        # after the range closed, and a kernel whose launch is not in the
        # trace
        launch(main, 1950.0, 6, name="cudaMemsetAsync"),
        kern("Memset (Device)", 1960.0, 10.0, 6, cat="gpu_memset"),
        kern("void at::native::vectorized_elementwise_kernel<4>()", 2000.0,
             5.0, 99),
    ]
    return {"traceEvents": evs}


def gloo_cuda_trace() -> dict:
    host, gpu = 100, 0
    main, gloo, stream, copies = 1, 3, 7, 20

    def x(cat, name, pid, tid, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
                "ts": ts, "dur": dur, "args": args}

    def launch(tid, ts, corr, name="cudaMemcpyAsync"):
        return x("cuda_runtime", name, host, tid, ts, 5.0, correlation=corr)

    def dev(name, ts, dur, corr, cat="gpu_memcpy", tid=copies):
        return x(cat, name, gpu, tid, ts, dur, correlation=corr, device=0,
                 stream=tid)

    evs = [
        x("user_annotation", "dp.step#0", host, main, 0.0, 3000.0),
        launch(main, 10.0, 1, name="cudaLaunchKernel"),
        dev("void at::native::vectorized_elementwise_kernel<4>()", 20.0,
            5.0, 1, cat="kernel", tid=stream),
        # all_reduce: device -> pinned on the caller, back on gloo's thread
        x("cpu_op", "c10d::allreduce_", host, main, 100.0, 400.0),
        launch(main, 200.0, 2),
        dev("Memcpy DtoH (Device -> Pinned)", 210.0, 80.0, 2),
        x("user_annotation", "gloo:all_reduce", host, gloo, 300.0, 700.0),
        launch(gloo, 900.0, 3),
        dev("Memcpy HtoD (Pinned -> Device)", 910.0, 80.0, 3),
        x("gpu_user_annotation", "gloo:all_reduce", gpu, copies, 910.0,
          80.0),
        # all_gather
        x("cpu_op", "c10d::_allgather_base_", host, main, 1100.0, 300.0),
        launch(main, 1150.0, 4),
        dev("Memcpy DtoH (Device -> Pinned)", 1160.0, 80.0, 4),
        x("user_annotation", "gloo:all_gather", host, gloo, 1300.0, 500.0),
        launch(gloo, 1700.0, 5),
        dev("Memcpy HtoD (Pinned -> Device)", 1710.0, 90.0, 5),
        # NCCL names its kernels itself
        launch(main, 2000.0, 6, name="cudaLaunchKernel"),
        dev("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage"
            "<4096ul>)", 2010.0, 120.0, 6, cat="kernel", tid=stream),
        # a copy outside any collective
        launch(main, 2500.0, 7),
        dev("Memcpy HtoD (Pinned -> Device)", 2510.0, 30.0, 7),
    ]
    return {"traceEvents": evs}


def write(name: str, doc: dict) -> None:
    with gzip.open(os.path.join(HERE, name), "wt", encoding="utf-8") as f:
        json.dump(doc, f)


if __name__ == "__main__":
    write("torch_mini_cpu.trace.json.gz", cpu_trace())
    write("torch_mini_cuda.trace.json.gz", cuda_trace())
    write("torch_gloo_cuda.trace.json.gz", gloo_cuda_trace())
