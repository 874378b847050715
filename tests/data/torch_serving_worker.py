"""One rank of the port's multi-process serving mesh on the CPU.

    python tests/data/torch_serving_worker.py <out_dir> <mode>

``tests/test_torch_mp_mesh.py`` starts the ranks through
``paddle_tpu_torch.distributed.mp_mesh`` after writing
``<out_dir>/state.npz`` (gpt_tiny's weights, taken from the JAX package
by the test and loaded here with ``models.gpt.load_reference_state``, so
every rank serves the same model). A rank imports nothing of JAX or the
JAX package; each writes its ``sys.modules`` verdict into its results.

Modes:
  run    two ranks (gloo on the CPU): rank 1 prefills (its wall clock
         skewed by ``PADDLE_CLOCK_SKEW``), rank 0 decodes. Both drive
         ``DisaggServer.run``; rank 0 holds every stream bitwise to its
         own single engine's and every handed-off TTFT to an
         uncertainty; both audit their pools. Each rank's sink lands in
         ``<out_dir>/sink/rank<K>/``.
  chaos  run's layout, launched with ``kill:1:pre_handoff_commit``: rank
         1 dies between its first payload's bytes and their rename. Rank
         0 imports nothing torn, keeps a clean pool, finishes its direct
         requests, then (once the mesh declares rank 1 dead) re-prefills
         the orphans it was routed: every gid exactly once, bitwise.
  kill   three ranks, symmetric, a Poisson-timed stream (no process
         group); rank 0 writes ``kill.ready`` once the stream is routed
         and results flow, and the test SIGKILLs rank 2. The survivors
         finish every gid exactly once with void-netted ledgers.
  join   two ranks drain wave 1 (rank 0 writes ``wave1.done``); the test
         starts rank 2 with ``join=True``; after the member round admits
         it, wave 2 goes out and the joiner must serve some of it.
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from paddle_tpu_torch.distributed import mp_mesh  # noqa: E402

MAX_NEW = 6
CFG = dict(num_slots=2, page_size=8, pages_per_slot=4, prefill_chunk=8)
RUN_LENS = (8, 16, 12, 20)
KILL_LENS = (16, 4, 12, 6, 18, 5, 10, 7)
JOIN_WAVE1 = (4, 6)
JOIN_WAVE2 = (4, 6, 5, 7, 4, 6)
POISSON_MEAN_S = 0.06


def prompts_for(lens, seed=3):
    import numpy as np

    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (t,)).astype(np.int32) for t in lens]


def build(out_dir):
    """gpt_tiny with the weights the test wrote."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models import gpt as tgpt

    torch.set_num_threads(1)
    net = tgpt.gpt_tiny(device="cpu", initializer_range=0.2)
    with np.load(os.path.join(out_dir, "state.npz")) as z:
        tgpt.load_reference_state(net, {k: z[k] for k in z.files})
    net.eval()
    return net


def single(net, prompts):
    """The streams of one engine serving every prompt: {gid: ids}."""
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    eng = ServingEngine(net, ServingConfig(**CFG))
    rids = [eng.submit(p, MAX_NEW) for p in prompts]
    out = eng.run()
    return {g: out[r] for g, r in enumerate(rids)}


def foreign_modules():
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.")
                  or m == "paddle_tpu" or m.startswith("paddle_tpu."))


def drive(srv, pred, deadline_s, what):
    deadline = time.monotonic() + deadline_s
    while not pred():
        srv.step()
        if time.monotonic() > deadline:
            raise SystemExit(
                f"rank {srv.mesh.rank}: timeout driving {what}: "
                f"requeued={sorted(srv._requeued)} "
                f"members={sorted(srv._members)} "
                f"served={sorted(srv.results())} "
                f"verdict={srv._done_verdict}")
        time.sleep(0.005)


def write_results(srv, out_dir, rank, **extra):
    path = os.path.join(out_dir, f"results.{rank}.json")
    srv.write_results(path)
    with open(path) as f:
        doc = json.load(f)
    doc.update(foreign_modules=foreign_modules(), **extra)
    with open(path, "w") as f:
        json.dump(doc, f)


def run_or_chaos(out_dir, mode):
    import numpy as np

    rank, world = mp_mesh.init()
    assert world == 2, world
    import paddle_tpu_torch.profiler as profiler
    from paddle_tpu_torch.profiler.sink import _detect_rank
    from paddle_tpu_torch.serving import (DisaggServer, HandoffChannel,
                                          MeshSpec, ServingConfig)

    assert _detect_rank() == rank
    net = build(out_dir)
    prompts = prompts_for(RUN_LENS)
    sink_root = os.path.join(out_dir, "sink")
    profiler.enable_sink(sink_root, interval_s=0.5)
    if mode == "chaos" and rank == 1:
        # die between the payload bytes landing and the atomic rename
        HandoffChannel.pre_commit = staticmethod(
            lambda: mp_mesh.chaos_point("pre_handoff_commit"))
    srv = DisaggServer(net, ServingConfig(**CFG),
                       MeshSpec(rank, world, prefill_ranks=(1,)),
                       os.path.join(out_dir, "shared"), lease_s=2.0)
    for p in prompts:
        srv.submit(p, MAX_NEW)
    mp_mesh.barrier("engines-up")
    # an anchor line before the chaos point: the victim's sink holds its
    # pre-kill events
    profiler.flush_active("manual")
    ok = os.path.join(out_dir, f"ok.{rank}")
    if mode == "run":
        srv.run(timeout_s=120.0)
        if rank == 0:
            assert srv.handoffs_recv > 0
            handed = [g for g, r in srv._reqs.items()
                      if r.prefill_rank == 1]
            ttfts, uncs = srv.ttfts(), srv.ttft_uncs()
            assert handed and all(ttfts.get(g) is not None
                                  for g in handed), (handed, ttfts)
            assert all(g in uncs for g in handed), (handed, uncs)
        else:
            assert srv.handoffs_sent > 0
            assert srv.ttfts() == {}
        assert srv.check_consistency() == []
        write_results(srv, out_dir, rank)
        profiler.disable_sink()          # os._exit skips atexit
        if rank == 0:
            want = single(net, prompts)
            got = srv.results()
            assert sorted(got) == sorted(want), (sorted(got), sorted(want))
            for g in want:
                np.testing.assert_array_equal(got[g], want[g])
            mp_mesh.finish_last(ok, [os.path.join(out_dir, "ok.1")])
        mp_mesh.finish(ok)

    # ---- chaos ----
    if rank == 1:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            srv.step()
        raise SystemExit("chaos kill never fired on rank 1")
    direct = [i for i, p in enumerate(prompts)
              if len(p) <= srv.engine.prefill_chunk]
    drive(srv, lambda: all(g in srv.results() for g in direct), 60.0,
          "direct requests")
    # nothing torn arrived, and the corpse's half-sent payload is a .tmp
    assert srv.handoffs_recv == 0
    assert srv.check_consistency() == [], srv.check_consistency()
    hdir = os.path.join(out_dir, "shared", "handoff")
    assert not [n for n in os.listdir(hdir) if n.endswith("-to0.npz")]
    # the elastic mesh declares rank 1 dead and this rank re-prefills the
    # long prompts it was to decode
    drive(srv, lambda: len(srv.results()) == len(prompts), 60.0,
          "re-dispatch")
    assert srv.handoffs_recv == 0
    assert srv.check_consistency() == [], srv.check_consistency()
    assert sorted(srv.members) == [0], srv.members
    want = single(net, prompts)
    for g, got in srv.results().items():
        np.testing.assert_array_equal(got, want[g])
    write_results(srv, out_dir, rank, direct=direct)
    profiler.disable_sink()
    mp_mesh.finish(ok)


def kill_or_join(out_dir, mode):
    import numpy as np

    rank, world = mp_mesh.init_env_only()
    import paddle_tpu_torch.profiler as profiler
    from paddle_tpu_torch.serving import DisaggServer, MeshSpec, ServingConfig

    net = build(out_dir)
    sink_root = os.path.join(out_dir, "sink")
    # no process group: name the rank, or the ranks share one file
    profiler.enable_sink(sink_root, per_rank_subdir=True, rank=rank,
                         interval_s=0.5)
    shared = os.path.join(out_dir, "shared")
    ok = os.path.join(out_dir, f"ok.{rank}")
    if mode == "kill":
        prompts = prompts_for(KILL_LENS)
        srv = DisaggServer(net, ServingConfig(**CFG),
                           MeshSpec(rank, 3, prefill_ranks=()), shared,
                           lease_s=1.0)
        if rank == 2:
            # the victim routes and decodes but never publishes a result,
            # so the kill orphans assigned work instead of racing the drain
            srv._collect_finished = lambda: None
        gaps = np.random.RandomState(7).exponential(POISSON_MEAN_S,
                                                    len(prompts))
        for p, gap in zip(prompts, gaps):
            until = time.monotonic() + float(gap)
            while time.monotonic() < until:
                srv.step()
            srv.submit(p, MAX_NEW)
        if rank == 0:
            drive(srv, lambda: srv._routed_hwm >= len(prompts)
                  and len(srv.results()) >= 1, 120.0, "pre-kill load")
            with open(os.path.join(out_dir, "kill.ready"), "w") as f:
                f.write("ready\n")
        drive(srv, lambda: bool(srv._done_verdict), 180.0, "drain")
        assert srv.check_consistency() == [], srv.check_consistency()
        assert sorted(srv._members) == [0, 1], srv._members
        want = single(net, prompts)
        for g, got in srv.results().items():
            np.testing.assert_array_equal(got, want[g])
        write_results(srv, out_dir, rank)
        profiler.disable_sink()
        mp_mesh.finish(ok)

    # ---- join ----
    all_prompts = prompts_for(JOIN_WAVE1 + JOIN_WAVE2)
    wave1 = all_prompts[:len(JOIN_WAVE1)]
    wave2 = all_prompts[len(JOIN_WAVE1):]
    joiner = rank == 2
    spec = (MeshSpec(2, 3, prefill_ranks=()) if joiner
            else MeshSpec(rank, 2, prefill_ranks=()))
    srv = DisaggServer(net, ServingConfig(**CFG), spec, shared,
                       lease_s=3.0, join=joiner)
    # every rank replays the stream: the joiner re-submits wave 1
    for p in wave1:
        srv.submit(p, MAX_NEW)
    if not joiner:
        drive(srv, lambda: bool(srv._done_verdict), 120.0, "wave1")
        if rank == 0:
            with open(os.path.join(out_dir, "wave1.done"), "w") as f:
                f.write("done\n")
    drive(srv, lambda: 2 in srv.members and srv._joined, 120.0,
          "admission")
    for p in wave2:
        srv.submit(p, MAX_NEW)
    drive(srv, lambda: bool(srv._done_verdict), 180.0, "wave2")
    assert srv.check_consistency() == [], srv.check_consistency()
    assert sorted(srv._members) == [0, 1, 2], srv._members
    want = single(net, all_prompts)
    for g, got in srv.results().items():
        np.testing.assert_array_equal(got, want[g])
    write_results(srv, out_dir, rank)
    profiler.disable_sink()
    mp_mesh.finish(ok)


def main():
    out_dir, mode = sys.argv[1], sys.argv[2]
    if mode in ("run", "chaos"):
        run_or_chaos(out_dir, mode)
    elif mode in ("kill", "join"):
        kill_or_join(out_dir, mode)
    else:
        raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    main()
