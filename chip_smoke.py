#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                 # all phases, one card

Setup: TF32 off for matmuls and cuDNN (parity: f32 products in full f32),
the card's name and power limit from nvidia-smi, and the build of every
CUDA kernel from paddle_tpu_torch/csrc/ into paddle_tpu_torch/_build/.

1. kernel phase — each kernel's wrapper on the card against its plain
   PyTorch version on the same inputs, at the serving engine's, the
   model's and the trainer's shapes: max abs error within the stated
   tolerance, kernel / plain / library times on the device alone (CUDA
   events around calls queued behind a torch.cuda._sleep that outlasts
   the host's loop: `timed`), the host loop's own time per call beside
   the kernel's (host_ms), and the least time the card could take (bytes
   over 3.35 TB/s or operations over the peak rate of the input type,
   whichever is larger; each kernel's bytes and operations come from the
   *_cost function beside it in paddle_tpu_torch/ops/, which a counted
   program uses too). The flash backward
   kernels run at S 1024 (the merged single-tile kernel) and S 2048 (the
   dQ + dK/dV pair), f32 and bf16, causal and not, cross attention with
   a ragged side; their library time is one call of PyTorch's fused SDPA
   backward (dQ, dK and dV together). The ragged kernel's
   int8 path runs the same row groups over int8 pools whose content and
   scales the port's own paged_kv_scatter wrote, under f32 and bf16
   queries. The decode rows also run a group of a one-page row beside a
   row whose table is full (the page split; each decode row reports its
   split count). The int8 matmul runs the deploy model's two layer shapes
   (f32, bf16 and int8 x, with and without ReLU + requantize) and ragged
   M and N (4100 x 4096 x 16390, 67 x 144 x 45) on the wgmma route, a
   ragged 67 x 130 x 45 with and without bias on the mma route, and fc1
   and fc2 forced onto the mma route beside their wgmma times: int8
   outputs equal to the plain version's, float outputs at rtol 1e-6 /
   atol 1e-5, the route that ran checked on the counters, the quantize
   pass timed apart (quantize_ms); the quantize pass alone is held bit
   for bit to its plain version on x with exact .5 ties and values past
   +-127, its library time one torch.quantize_per_tensor call on the
   f32 x. bf16 attention at
   head dim 64 or 128 takes the tensor-core kernels (wgmma, TMA): the
   forward at the train step's B2 S2048, at S 1024, at a ragged S 1000
   and at D 64; the merged backward in every bf16 single-tile case and dQ
   and dK/dV in every bf16 pair case, held to the plain versions on the
   same bf16 inputs. f32, and bf16 at D 96, take the SIMT forward and
   the mma.sync backward (3xTF32 products, P and dS in f32): the pair
   also cross and ragged, with a given delta, and the pair and the merged
   kernel at D 40, 64, 80 and 256 (every instantiation, and head dims
   that end inside a group of column blocks), bf16 at D 40 and 256 too;
   their f32 rows are bounded at 165 TFLOP/s (3xTF32, the route of both
   the kernels and the library), the 67 TFLOP/s f32 FMA line beside it.
   The bf16 given delta at S 1024 on the wgmma merged kernel is held to
   the plain version with one bf16 flip of P or dS allowed a row
   (given_delta_check), and so are ring attention's chunk rows (S 1024,
   the causal diagonal and a full chunk, the global delta given, f32
   gradients), beside the ring's full-chunk forward (S 1024, not
   causal); ROADMAP queue 3 item 2 settles that allowance. The
   ragged kernel's chunk rows (T > 1) also run with an unaligned pos0, a
   T 40 row and over a pool of 32-token pages, and both row kinds at the
   generate phase's paged shapes (4 slots of 34 pages: one 512-token
   chunk row from position 0, 4 decode rows); the f32 SDPA yardsticks'
   aten kernels (forward and backward) are named from torch.profiler.
   The build fails if ptxas reports a spill in a tensor-core kernel (the
   int8 wgmma product included), in the register-tiled SIMT kernels (the
   flash forward, the ragged chunk rows), in the decode rows or in the
   mma.sync backward kernels.
The serving phases (2, 3 and 6–11) run one GPT at gpt3_1_3b's widths cut
to SERVE_LAYERS = 4 of its 24 layers (random weights from a seed, f32),
which keeps the whole script inside its time limit as phases are added
(12 until the resume phase and run (g) took the default phases to 1098 s
of the 1200 s limit; 8 until the bert phase took them to 1188 s on a
slow host).

2. model phase — GPT.forward at gpt3_1_3b width (SERVE_LAYERS layers,
   random weights from a seed, f32) over 2 prompts of 1024 tokens (flash
   kernel), and gpt_ragged_apply over the same tokens through scrambled
   pages (ragged kernel): every sampled position's logits agree with the
   forward's.
3. engine phase — ServingEngine at gpt3_1_3b serving 16 requests (half
   share a 512-token prefix) 32 greedy tokens each; 4 streams checked
   against teacher-forced GPT.forward argmax. Then a fresh engine serves
   them again with 8 ticks inside ServingEngine.trace_window() (after one
   tick outside it): the parsed summary passes the sink schema's
   check_trace_summary, busy_frac is in [0, 1], the tick site has
   executions == steps == 8, the ragged_kernel + ragged_chunk_kernel
   slices number the RAGGED_LAUNCHES delta and the ragged_chunk_kernel
   slices the RAGGED_CHUNK_LAUNCHES delta (at most one ragged_chunk_merge
   a call), all of them on the tick site under attention, slices that
   join no site <= 2% of device_busy_ms (the largest printed by name),
   and the tick site's counted program (FLOPs, bytes, compile_ms) with
   non-zero attention FLOPs (the ragged kernel's cost hook).
4. grad phase — GPT.loss at gpt3_1_3b width, 2 layers, one sequence of
   2048: every parameter's gradient through the kernels against a run on
   the plain attention functions (bound in by this script); f32 (the SIMT
   forward, the mma.sync backward) at max |dg| / max |g| <= 1e-3, again
   at S 1024 (the mma.sync merged kernel), then the model cast to bf16
   (the tensor-core forward, dQ and dK/dV) at GRAD_BF16_TOL.
5. train phase — HybridPipelineTrainer at gpt3_1_3b, full depth, with
   the single-chip recipe (amp, recompute, bf16 parameters and moments,
   AdamW 0.1, warmup-cosine schedule, global-norm clip 1.0, n_micro 2):
   8 steps on one fixed [4, 2048] batch (the loss must fall), one step
   under torch.profiler, 2 steps on a [4, 1024] batch. Step ms, tokens/s,
   MFU and peak memory. A clip probe holds the bf16 gradient clips to one
   rounding of g.float() * scale, bit for bit. Then
   profile_step_phases(tokens, iters=1, trace_window=2) on the same
   trainer: fwd/bwd/optim/step ms present and positive; in the parsed
   window of 2 steps every flash kernel slice (the backward kernels the
   autograd thread launches too) joins the hybrid.step site and each
   FLASH_*_LAUNCHES delta equals its kernel's slices, slices joining no
   site <= 2% of busy, the ledger's MFU (counted FLOPs over the window's
   wall) in (0, 1] and the step site's counted FLOPs >= 0.9 x
   GPTConfig.flops_per_token(S) x tokens; memory_ledger() and
   memory/peak_bytes_in_use.
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
   fusion pass wired fc1 -> fc2, one forward is 2 launches of the wgmma
   int8 matmul and 1 of the quantize pass (the mma route is forbidden),
   the output is bf16, agrees with the plain chain (int8 intermediate
   equal) and stays within DEPLOY_QAT_TOL of the QAT-eval output. ms per
   forward (device and host loop) and share of the int8 rate.
8. generate phase — GPT.generate on the engine phase's f32 gpt3_1_3b
   model: dense greedy over 4 prompts of 512 seeded tokens, 32 new
   (S_max 544; held to teacher-forced GPT.forward argmax at >= 0.9), the
   same with paged=True (page 16, 34 pages a slot, 512-token chunk rows:
   the ragged kernel, >= layers x ticks launches; >= 0.9 of its tokens
   equal the dense streams'), paged sampling (temperature 0.8, top_k 50,
   top_p 0.95, seed 11: two calls equal, top_k=1 equal to paged greedy,
   >= 0.99 of the tokens inside the teacher-forced top 50), an engine
   with decode="sampling" serving the engine phase's 16 requests with
   per-request overrides (all finish, two runs equal; the widest tick's
   draw equals the same call on the CPU wherever the two best perturbed
   scores are more than 1e-5 apart, as on most rows), the threefry
   generator on the card (bits for 8 keys x 50304 equal to the CPU's; a
   TV test of 65536 draws from one top-50 row, under a bound derived from
   the sample size) and beam search (B 2, 128-token prompts, 4 beams, 16
   new: num_beams=1 equals dense greedy, 4 beams score >= greedy's
   log-prob - 1e-3). ms per step and tokens/s warm for dense greedy,
   paged greedy and paged sampling (each warm call on prompts not seen
   before, so a paged call prefills all of its prompt as a dense call
   does; the phase fails if one hits the prefix cache), the sampling
   step's share of kernel and wall time under torch.profiler, busy
   share, kernel launches per dense step and peak memory.
9. spec phase — speculative decoding on the engine phase's model and
   workload (16 requests, 32 greedy tokens each) at k 4 with three
   drafts: the twin (the target itself), an independent model at
   gpt3_125m's widths from another seed, and a 2-block draft made of the
   target's embeddings, first two blocks and ln_f. Each draft's streams
   agree with teacher-forced GPT.forward argmax at >= 0.9 and with the
   plain engine's at >= SPEC_MATCH_FLOOR, the twin accepts >= 0.9 of its
   drafts, the page audit is empty after every run, and the chunk-row
   kernel launches at T = 1 + k exactly once a layer for every verify
   tick with drafts (the wrapper's per-T tally), and at least that plus
   once a layer for every tick with chunks in all. Warm tokens/s against the plain
   engine in turns (plain, three drafts, plain), each tick kind's span on
   the card (CUDA events) and host ms, the twin's tick kernel ms and busy
   share under torch.profiler, the twin under decode="sampling" with
   overlap off and on (equal streams, >= 0.99 equal to the plain sampling
   engine's), the twin on int8 pages (two runs equal), peak memory. The
   kernel phase holds the ragged kernel at the verify shape (R8 T5 and
   T2, true_len 1..T, pos0 64-1056, f32, bf16 and int8 pools) to reading
   no page past a row's last real query (a page of NaN in its place) and
   times the T decode-row calls that do the same work beside it. The
   twin's run also checks its event timeline: per request draft <
   verify < accept, accepted <= drafted on every accept event, the
   breakdown's spec_drafted >= spec_accepted.
10. observe phase — the profiler on the engine phase's model and
   workload: a fresh engine with a MetricsSink in a temporary directory
   (per request submit <= admit <= first_token <= finish, a complete
   latency breakdown whose four buckets sum to total_ms within 1.5 ms;
   latency_stats' TTFT and TPOT p50/p95/p99, the bucket sums,
   compiled_sites with each site's trace_counts), the same engine on a
   129-page pool that preempts (each preempt followed by a requeue, then
   an admit; some preempted time), one ServingEngine.trace_window() of 4
   ticks with the sink active (a dump_flight() taken after it carries the
   window's summary), the sink's files through tools/check_sink_schema.py
   --require-trace (exit 0; sizes, events_lost), then
   profiler.enable(trace_dir=..., reset=False) around a 3-request engine
   run and one HybridPipelineTrainer step of gpt3_1_3b (the train
   recipe, [2, 2048]): the Chrome trace disable() writes holds the host
   scopes hybrid/step and sync_wait, the fwd/blocks range, and
   ragged_kernel and flash kernel events; the host spans' own Chrome
   export loads. Last, warm tokens/s with the event log on and off in
   turns (on, off, off, on; each on-turn's bucket sums beside its wall).
11. handoff phase — two paths on the engine phase's model and workload.
   The legacy path: ServingEngine(attention_kernel="legacy") serves the 16
   requests (every request finishes; 4 streams against teacher-forced
   argmax at >= 0.9, the unified engine's streams at >=
   SPEC_MATCH_FLOOR); its two sites (serving.tick, serving.prefill) run
   one shape each, and the counters show exactly num_layers decode-row
   launches a tick and num_layers chunk-row launches at T = prefill_chunk
   a prefill dispatch. Warm tokens/s in turns (unified, legacy, legacy,
   unified), each with its wall, ticks, process CPU seconds and busy
   share (kernel ms of a profiled second run over the plain run's wall).
   The handoff path: a prefill engine holds 8 of the requests
   (hold_after_prefill), exports and releases each, a decode engine
   admits each payload and decodes: every request finishes, both page
   audits are empty, the prefill engine's prefix index is not, each
   admit's pages read back equal to its payload, the streams agree with
   a single engine's at >= SPEC_MATCH_FLOOR and with teacher-forced
   argmax at >= 0.9; bytes, ms and GB/s of each export and import from
   the handoff_out/handoff_in events. The same on int8 pools for 4
   requests, twice (equal streams; the imported scales equal the
   payload's after the admit and after the decode engine's next tick;
   >= KVINT8_MATCH_FLOOR against the single int8 engine). Then the
   shared 512-token prefix's chain migrates: engine A serves the 8
   shared-prefix requests and exports 32 pages, a fresh engine B imports
   512 tokens and serves one of the prompts with a prefix hit of 512
   remote tokens (event and counter), its stream agreeing with A's at
   >= SPEC_MATCH_FLOOR. The kernel phase holds the ragged kernel at the
   legacy engine's shapes: its prefill program's R1 T256 row at pos0 0
   and 512, and its decode tick's R8 T1 rows (5 live, 2 idle on an
   all-null table at pos0 0, whose outputs are ignored, and one at pos0
   == the table's capacity over a full table).

12. dist phase — two ranks on this one card (FLAGS_selected_gpus=0) over
   gloo, started by the port's launcher (python -m
   paddle_tpu_torch.distributed.launch --nproc_per_node 2 --backend gloo
   chip_smoke.py --dist-worker DIR) after every kernel is built; each
   rank writes its results to DIR and a failed rank fails the phase with
   its log's tail. Each rank: the collective API on CUDA tensors
   (all_reduce SUM/MAX/MIN/PROD, broadcast, all_gather, scatter,
   reduce_scatter, alltoall, barrier: exact) and the primitives over a
   {"dp": 2} mesh, outputs and gradients against the same program in
   plain tensor ops; DataParallel and fleet.distributed_optimizer(AdamW)
   on GPT at gpt3_1_3b widths cut to DIST_LAYERS = 4 layers (two ranks
   share the card), f32, TF32 off: a warm-up forward and backward, then 2
   steps on the rank's own seeded [2, 1024] batch (rank 1 starts from
   other weights; the wrap broadcasts rank 0's). The first step's
   collectives are counted: one f32 bucket all-reduce (4 bytes a
   parameter element) and one all-reduce a parameter from the optimizer;
   the second runs in a parsed device_trace window, which must show
   collective slices (gloo's copies through pinned host memory) under
   "collective". Rank 0 then runs a single-process replica from the
   broadcast initial state on both batches concatenated: the synced
   gradients within DIST_GRAD_TOL of its own, and after AdamW's first step
   the parameters within DIST_PARAM_ATOL wherever |g| is clear of zero.
   The f32 bucket all-reduce alone is timed twice (ms, GB/s). Then the
   tensor-parallel layers at tp = 2 at gpt3_1_3b widths against the dense
   layers on rank 0, forward and gradients (the shards' gathered) within
   TP_TOL: ColumnParallel(2048 -> 8192, gather_output=False), GELU,
   RowParallel(8192 -> 2048, input_is_parallel=True) on [2, 1024, 2048];
   VocabParallelEmbedding(50304, 2048); ParallelCrossEntropy over
   [2, 1024, 50304] logits. Last, profiler.summary(aggregate=True)
   across the ranks equals one registry that observed the union. Step ms,
   bucket ms and GB/s, and each rank's launch counts are printed. NCCL
   needs a card per rank and is not run here.
13. hybrid phase — the strategy compiler's trainer (HybridPipelineTrainer)
   on two ranks of this card over gloo, started by the launcher as the
   dist phase's (chip_smoke.py --hybrid-worker DIR), on GPT at gpt3_1_3b
   widths cut to HYBRID_LAYERS = 2 layers (two ranks' models, optimizer
   states and a replica share the card behind gloo's host ring), 2 steps
   each of three runs, all with amp, recompute and AdamW (lr 1e-4) with
   the global-norm clip at HYBRID_CLIP on the first of its two steps:
   (a) {"tp": 2} under the train phase's recipe
   (bf16 parameter and moment storage; 8 heads a rank), global batch
   [2, 2048]; (b) {"dp": 2} ZeRO 2 with f32 storage (the flat slab of
   qcomm.dp_zero_step), global [4, 2048]; (c) {"dp": 2} ZeRO 3 (the
   per-parameter route, parameters on their dp slices), global [4,
   2048]. Each rank counts its first step's collectives and holds them
   to the count derived from the code (_hybrid_expected: (a) 5 bf16
   activation all-reduces a layer and 2 more, the loss's f32 ones;
   (b) one reduce-scatter of the padded flat gradients, one all-gather,
   two scalar all-reduces and no gradient all-reduce; (c) every
   parameter gathered in the forward and each block's again in its
   recompute, reduce-scattered once), gathers every parameter after the
   first step (sync_to_layer, gather_reference_state) and runs the
   second in a parsed device_trace window. Rank 0 then trains a degree-1
   replica from the gathered initial state on the same global batches:
   losses within HYBRID_LOSS_RTOL, the parameters after step 1 within
   HYBRID_PARAM_ATOL (f32) or one bf16 ulp (bf16 storage) on at least
   HYBRID_PARAM_SHARE of each tensor's elements where the replica's |g|
   exceeds HYBRID_G_CLEAR of its tensor's largest and, clipped,
   HYBRID_G_EPS, the first moments
   after step 1 (0.1 x the clipped gradient) and after step 2 (which
   both sides run without the clip, so that a gradient's size shows)
   against the replica's, each tensor's best-fit scale within
   HYBRID_M1_TENSOR_SCALE_TOL of 1 and its relative error within
   HYBRID_M1_RTOL, all of them together at a common scale within
   HYBRID_M1_SCALE_TOL of 1, the replica's gradient norm above the clip
   (so that step 1's clip acts and a wrong global norm shows),
   and on (b) and (c) memory_ledger's opt_state at most 1/2 + 5%
   of the replica's. Run (a)'s replica runs twice on the same first
   batch (ROADMAP queue 3 item 5): how many wte elements differ between
   the two, and the rows of the wte elements the tp run and the replica
   disagree on beyond one bf16 ulp. Step ms, collective bytes and their
   rate over the step, busy share and collective ms of the traced step,
   and each rank's ledger and launch counts are printed.
14. parallel phase — the hybrid trainer on the new axes, in the hybrid
   phase's shape (two ranks of this card over gloo, chip_smoke.py
   --parallel-worker DIR; GPT at gpt3_1_3b widths cut to DIST_LAYERS = 4
   layers; amp, recompute, AdamW with the clip on step 1; 2 steps a
   run): (d) {"pp": 2}, v_virtual 2, n_micro 4, bf16 storage, global
   [4, 2048] (one layer a virtual stage; the flash kernels at B1 S2048);
   (e) {"sp": 2}, f32 storage, global [2, 2048] (1024 positions a rank:
   the ring's chunks run the wgmma forward, causal and full, and the
   merged backward with the global delta and f32 gradients); (f)
   {"ep": 2}, a MoE GPT (8 experts, top-2, capacity 1.25, aux weight
   0.01), bf16 storage, global [2, 2048]. Each run is held on rank 0
   to a degree-1 replica as runs (a)-(c) are (losses, the parameters
   after step 1 by the share rule, the first moments' scales); its
   counted collectives to the code's (_parallel_expected: (d) v·n_micro
   + pp − 1 permutes forward and as many backward at one micro-batch's
   activation; (e) the ring's K/V and dK/dV hops; (f) three ep sums a
   layer). (e) first holds ring_attention alone at [2, 2048, 16, 128]
   bf16 (ring_check): the gathered output against the plain full
   attention at BF16_TOL, the gathered gradients against the plain full
   backward on the ring's global LSE and delta with one bf16 flip of P
   or dS a row (ROADMAP queue 3 item 2). (f) holds the first
   micro-batch's routing to the replica's where the top-2 margins are
   clear of rounding, the dropped counts equal, and each rank's experts
   at 1/2 + 5% of the replica's bytes. Step ms, collective bytes, busy
   and idle share of the traced step, (d)'s bubble beside its idle,
   and each run's launch counts are printed; every rank launches the
   wgmma kernels and none of the f32 route's.
   The hybrid phase's run (g): {"dp": 2} ZeRO 2 with dp_grad_comm="int8"
   and dp_param_comm="bf16" (the int8 ring's one hop, a bf16 return),
   held to run (b) instead of a replica: both losses at
   HYBRID_LOSS_RTOL, the f32 masters after step 1 against (b)'s
   parameters by the share rule at HYBRID_PARAM_ATOL, the first
   moments after step 2 at (b)'s scale, its counted
   collectives to the code's (one int8 and one f32 scale permute, the
   bf16 all-gather, two scalar all-reduces) and its dp gradient bytes at
   most HYBRID_INT8_BYTES_RATIO of (b)'s; a third step's ring-reduced
   gradient within half a quantization step of the hop's block amax of
   the f32 reduce-scatter of the same local gradients. Each rank then
   saves its ZeRO shard (device_state, a sync save) and rank 0 restores
   the directory into a degree-1 trainer: its parameters bit-equal to
   the gathered ones.
   The hybrid phase's run (h): {"dp": 2} ZeRO 1 with int8 gradients
   (the slab's int8 ring), f32 storage, GPT at gpt3_1_3b widths cut to
   HYBRID_RESIL_LAYERS = 2 layers, guard_bad_steps, ResilientRunner with
   the consensus board (one board and one checkpoint directory both
   ranks share, a checkpoint every 3 steps), bad_step_limit 2, a NaN
   injected on rank 1 alone at cursors 3 and 4, 7 steps of a global
   [2, 2048]: both ranks' verdicts False at those cursors and True
   elsewhere (the trainer's MIN over dp), both states' digests unchanged
   there, one agreed rollback each to the same step, skips [3, 4], the
   losses finite and bit-equal across the ranks (the reference's
   tests/multihost/test_resilience_mesh.py, zero mode).
15. resume phase — checkpoints, the elastic restart and host offload on
   one rank, GPT at gpt3_1_3b widths cut to DIST_LAYERS = 4 layers under
   the train recipe (amp, recompute, bf16 parameters and moments, AdamW
   with the clip) at RESUME_BATCH [4, 2048]: (r1) a sync save of
   device_state and its restore into a fresh trainer built from other
   weights (every tensor bit-equal), one more step on both (losses within
   RESUME_SPREAD_FLOOR), save and restore GB/s; (r3) the RESUME_OFFLOAD
   variants (offload_optimizer; offload_params + offload_optimizer +
   stream_layers at offload_depth 2; the same with conservative_fetch),
   4 steps each from
   one seed, held to the resident run (losses, the parameters after
   step 1 by the share rule), each variant's warm step ms and
   memory_ledger (an estimate); the fourth step's allocated bytes,
   measured between steps and around the update: the card holds the
   offloaded bytes less between steps than the resident run, the
   update rises at most offload_depth + 1 groups' working sets above
   the resident update's rise, and conservative_fetch's forward and
   backward peak lies below the free schedule's by the prefetched
   groups; (r2) child processes (chip_smoke.py
   --resume-worker DIR, the kernels loaded from the build above), each
   ElasticTrainer for RESUME_STEPS steps with save_interval 2,
   prefetch_depth 2, async_dispatch and snapshot_async: an uninterrupted
   life A beside a life B SIGKILLed once step 3 is logged and a step is
   committed; B started again resumes from the newest committed step
   beside a second uninterrupted life A': the restored state bit-equal
   to the state B saved there (digests of every piece's bits), the
   data cursor B saved there and A's at that step, that cursor's batch;
   B's losses lie within the spread of A and A' (at least
   RESUME_SPREAD_FLOOR of the loss). The
   wait_snapshot stall and each save call's ms against a sync save's,
   and the prefetch-depth gauge, are printed. The checkpoints live in a
   temporary directory the phase deletes; every run launches the wgmma
   forward, dQ and dK/dV and none of the f32 route's.
16. plan phase — planning without allocation (distributed/plan.py: the
   trainer's own step code run on fake tensors). GPT-3 13B
   (GPTConfig.gpt3_13b: V 50304, h 5120, 40 layers, 40 heads, S 2048)
   built under LazyGuard, the HybridPipelineTrainer under the
   reference's recipe (amp, recompute, bf16 parameters and moments,
   AdamW) at the three factorizations of PLAN_13B (the names of
   benchmarks/plan_13b.py: A_tp8_pp2, B_tp4_pp4, C_tp4_pp2_dp2_zero2) on
   a planning world of 16 (env.plan_world, torch.distributed's fake
   backend), rank 0 and rank 15 (a rank of the last stage, which holds
   the loss head), each in a child process (chip_smoke.py --plan-worker
   OUT NAME RANK), all six at once: memory_analysis at a [32, 2048]
   batch spec, peak_bytes_est against the card's total memory, the
   host's RSS before the model is built and after the plan, and the
   plan's wall time; the phase fails if a
   child's allocated bytes on the card moved, it launched a kernel or it
   planned a [B, H, S, S] tensor. In this process: the resume phase's resident
   configuration (DIST_LAYERS layers at RESUME_BATCH) planned from its
   materialized trainer, then measured on the card as the resume phase
   measures it (_measured_step, after one warm step; the plan_check
   path): the forward-and-backward and update peaks within
   PLAN_PEAK_RTOL of the allocator's (less the bytes allocated before
   the trainer); the train phase's recipe at 24 layers planned
   abstractly, its peak_bytes_est printed beside the train phase's
   max_memory_allocated_gib (printed only: that figure spans the
   profiled step and the clip probe too); hybrid run (a) (tp 2) planned
   at a planning world of 2 on each rank, its collectives equal to run
   (a)'s count when the hybrid phase ran. The plan path launches no
   kernel.
17. disagg phase — the multi-process serving mesh
   (paddle_tpu_torch/serving/disagg.py) on the engine phase's model
   (gpt3_1_3b widths, SERVE_LAYERS layers, f32 pools) and workload (16
   requests of 64-1024 prompt tokens, half behind a 512-token prefix, 32
   greedy tokens; 8 slots, page 16, 128 pages a slot, chunks of 256).
   The parent writes the model's state once (models.gpt.state_to_numpy)
   and the prompts into the phase's directory (the streams it compares
   with are the engine phase's, or one engine's, uncounted, when that
   phase did not run) and starts two ranks on this card
   (FLAGS_selected_gpus=0; gloo for the process group, which only names
   the rank) through paddle_tpu_torch.distributed.mp_mesh (chip_smoke.py
   --disagg-worker DIR A,B,C). Each rank loads the state with
   load_reference_state (its sha1 must equal the parent's), then serves
   runs A, B and C in turn through DisaggServer (lease DISAGG_LEASE_S,
   kept by the heartbeat thread), every launch count set to 0 just before
   a run and read just after, each run with its own board, channel and
   sink (rank<K>/). Run A: MeshSpec(rank, 2, prefill_ranks=(1,)), the
   whole workload: rank 1 prefills every prompt of at least one chunk + 1
   tokens and hands its KV to rank 0; rank 1's clock is skewed by
   DISAGG_SKEW (PADDLE_CLOCK_SKEW, for all three runs). Every gid finishes
   exactly once, handoffs sent == received > 0, both pool audits are [],
   the streams agree with the parent's single engine at >=
   SPEC_MATCH_FLOOR and teacher-forced at >= 0.9, rank 1's agreed offset
   lies within unc_s + 0.05 of the skew, every handed-off TTFT is > 0
   with an uncertainty below DISAGG_TTFT_UNC_MS, and tools/merge_traces.py
   (a subprocess) over the two sinks gives a whole trace without a
   monotonicity violation whose handoffs equal rank 0's imports. Run B:
   prefill_ranks=() (symmetric), the first 8 requests: every gid once, no
   handoff, the streams held as in A. Run C: A's layout on the first 8
   requests, the launch's chaos kill:1:pre_handoff_commit armed: rank 1
   dies between its first payload's bytes and their rename; the survivor
   imports nothing (the channel holds the corpse's .tmp and no .npz),
   keeps its audit at [], finishes its direct requests and, once the mesh
   declares rank 1 dead, re-prefills every orphan (each gid once, held as
   in A). Printed for
   each run, with the card's name and power limit: wall s, tokens/s, TTFT
   p50/p95, handoffs and their bytes, the consensus decisions by family,
   the vote round trip's p50, and row 5's launches by rank. Every
   unified tick runs one decode row a slot (idle ones on the null page)
   and, with prompt chunks, one chunk-row call, so the checks read what
   the rows carried: in run A the prefill rank has no decode-only tick
   and its decode rows emit no token, while the decode rank's do; in run
   B both ranks prefill and decode. Two ranks share one card: a run's
   tokens/s is a record, not a speed-up. The live plane (check (l)):
   while the ranks serve, this process ticks a LiveAggregator
   (profiler/live.py, viewer mode) every LIVE_TICK_S over run A's and
   run C's sink roots with their boards (frames older than
   LIVE_STALENESS_S and an expired lease make a rank dead): A's last
   mesh_status.json names both ranks and passes
   tools/check_sink_schema.py --live-status (a subprocess), and its
   merged e2e TTFT p50 and p95 lie within the sketch's rel_err of the
   nearest-rank values of A's results; C's first dead_rank firing names
   rank 1, its lease expired, rank 0 alive.
18. resilience phase — paddle_tpu_torch/resilience on one rank, GPT at
   gpt3_1_3b widths cut to RESIL_LAYERS = 2 layers under the train
   recipe (amp, recompute, bf16 parameters and moments, AdamW with the
   clip at 1.0) at RESIL_BATCH [4, 2048], the trainer built with
   guard_bad_steps: (s1) in this process, RESIL_TIMED pairs of warm
   steps with the guard and without it in turn (medians printed), then a
   step after inject_fault_scale(nan): NaN loss, last_step_ok False, the
   SHA-1 of device_state unchanged, the next step's verdict True; (s2)
   ResilientRunner over ChaosPlan(nan_cursors={3, 4, 5},
   flaky_cursors={6: 1}), bad_step_limit 3, save_interval 3, 8 steps,
   twice from the same seed (the determinism check): one rollback to
   step 3, skips [3, 4, 5], one data retry, 8 finite losses; the restore
   and each save timed; (s3) a child life (chip_smoke.py
   --resilience-worker DIR preempt) runs the same plan, gets a real
   SIGTERM from this process at cursor 9 (step 6), commits step 7 and
   exits 75; a byte of that shard is flipped; the restarted life
   (restart) walks back to step 6 (resilience/restore_fallbacks 1) and
   finishes: both lives' losses equal (s2)'s bit for bit if (s2)'s two
   runs were, else within their spread (at least RESUME_SPREAD_FLOOR of
   the loss); the commit's ms printed; (s4) a child life (watchdog) with
   the watchdog (timeout RESIL_WD_TIMEOUT_S, jitter RESIL_WD_JITTER, the
   first step's grace RESIL_WD_GRACE_S, abort) and a sink queues
   RESIL_HANG_S of torch.cuda._sleep behind step 2, so the host blocks
   in the loss sync: it exits 74, its dump holds the stacks and the open
   hybrid/sync_wait span, its sink a watchdog line and one watchdog_fire
   event at step 2 (its cold first step did not fire: printed beside the
   grace), with the fire's latency. The lives start while this process
   runs (s2); the checkpoints live in a temporary directory the phase
   deletes.
19. bert phase — BERT and ERNIE pretraining (paddle_tpu_torch/models/
   bert.py, ernie.py). First the two flash kernels the path runs, at the
   BERT micro-batch's attention BERT_ATTN [16, 512, 12, 64] bf16, not
   causal (S 512 is one tile: the merged single-tile backward), each
   held element-wise to its plain version as in the kernel phase and
   timed beside its bound and SDPA. Then a check, uncounted: BERT-base's
   widths at BERT_CHECK_LAYERS layers in bf16 on one micro-batch, the
   loss and every gradient through the kernels against the plain
   attention functions bound in (grad_phase's swap), each against the f32
   model's on the plain functions: the kernels' error (max |dg| / max |g|
   a parameter) at most the plain version's + GRAD_BF16_TOL. Then the
   main path: BertConfig(vocab_size=32768, max_seq_len=512,
   max_predictions=80) (h 768, 12 layers, 12 heads, FFN 3072: the
   reference benchmark's cell, bench.py:926-936) from a seed, amp,
   compile_train_step with accumulate_steps BERT_ACCUMULATE over a global
   BERT_BATCH [64, 512] (bench.py's _mlm_batch, built here), AdamW
   BERT_LR, BERT_STEPS steps on that one batch: the loss finite and
   falling, the warm step median and spread (steps 3 on), tokens/s, MFU
   (tokens/s x BertConfig.flops_per_token(512) / 989e12: the formula
   counts neither the non-causal attention's second half nor the
   gathered head), peak allocated memory, and the launches of the
   forward and the merged backward each warm step (one each a layer a
   micro-batch). Last, the ernie path: two ranks on this card over gloo
   (chip_smoke.py --bert-worker DIR, through the port's launcher) train
   ErnieConfig.ernie_base() widths (h 768, 12 heads, vocab 18000, type
   vocab 4) at ERNIE_LAYERS layers with max_predictions 80 on a global
   ERNIE_BATCH [8, 512] at dp 2 under ZeRO 3, recompute, amp and AdamW
   with ClipGradByGlobalNorm(1.0), ERNIE_STEPS steps: the losses finite
   and equal on both ranks, every block parameter held as a dp slice,
   sync_to_layer + gather_reference_state giving every parameter at its
   whole shape, and each rank's step ms (gloo's host ring, not NCCL).
20. vision phase — nn and vision (paddle_tpu_torch/nn, io, metric,
   vision; ROADMAP queue 1 item 9b). (a) tests/test_e2e_mnist.py's loop:
   seed(33), synthetic MNIST(512), DataLoader(64, shuffle, drop_last) on
   the card, LeNet, Adam(0.002), 3 epochs: the last loss under 0.7 of
   the first, train accuracy through metric.Accuracy over 0.5; the eager
   step at bench.py:152-168's shape. (b) ResNet-50 (f32, TF32 off) from
   a seed on the card and on the CPU with the same weights, [2, 3, 224,
   224], uncounted: train-mode logits and running statistics and
   eval-mode logits within RESNET_CHECK_TOL. (c) bench.py:213-243:
   resnet50(1000), Momentum(0.1), amp, compile_train_step at dp 1, one
   [64, 3, 224, 224] batch from RandomState(0) staged on the card,
   RESNET_WARM + RESNET_TIMED steps: every loss finite, every running
   statistic finite and moved; the warm median step ms, images/s, peak
   memory, one step's kernels by device_trace.class_table and the
   update's host and device ms (the trainer's optim range, torch.profiler),
   then profile_step_phases(iters=1, trace_window=2). (d) Int8Conv2D at
   INT8_CONV_CASES (LeNet's conv2, K 150: mma.sync; a ResNet-50 layer1
   3x3 at [8, 64, 56, 56], K 576: wgmma): the layer's launches (one
   quantize pass, one product of the case's route), its output against
   the same layer on the CPU, then the product kernel alone on the
   layer's int8 patches against its plain version (the quantized input
   equal, the output at INT8_MM_RTOL/ATOL), timed beside its bound and
   torch._int_mm + the epilogue. (e) a QAT LeNet trained one epoch and
   deployed (convert_to_int8_deploy): its accuracy within
   INT8_LENET_ACC_TOL of the fake-quant model's, and each of its five
   int8 layers, on the input it met in the first batch, held and timed
   as in (d). Each int8 row of (d) and (e) joins the kernels line with
   the launches of its own layer on the path.

Every launch counter is set to 0 just before each of phases 2-11 and
17-20 and read just after it (the dist, hybrid, parallel and disagg
phases' ranks and the resilience phase's lives do the same around their
parts, and each phase sums its ranks' or lives' counts): those are
the main paths' launches,
and each path must
launch each of its kernels (the generate path: the ragged decode and
chunk rows, never the int8 path; the spec path: both row kinds and the
int8 path, counted over the spec engines' runs alone: the plain engines
and forwards it compares with run uncounted; the train path: the four
wgmma flash
kernels and none of the f32 route's; the f32 grad paths: the SIMT
forward and the mma.sync backward kernels and no wgmma one; the deploy
path: the wgmma int8 product and the quantize pass, not the mma.sync
int8 kernel, whose kernels-line entry is timed at fc1's shape and has no
main-path launch; the observe path: both ragged row kinds, the wgmma
forward, dQ and dK/dV, none of the f32 route's; the legacy path: both
ragged row kinds, not the int8 path; the handoff path: both row kinds
and the int8 path; the dist path: the SIMT forward and the mma.sync
merged backward, no wgmma one; the hybrid path, on each rank: the wgmma
forward, dQ and dK/dV, none of the f32 route's; the parallel path, on
each rank: those and the merged backward, none of the f32 route's; the
resume path, in this process and in each completed life: the wgmma
forward, dQ and dK/dV, none of the f32 route's; the plan path: no kernel
at all; the plan_check path: the wgmma forward, dQ and dK/dV; the disagg
path, summed over its runs' ranks: both ragged row kinds, not the int8
path; the resilience path, this process and its lives: the wgmma
forward, dQ and dK/dV, none of the f32 route's; the bert path and the
ernie path, on each rank: the wgmma forward and merged backward, not the
dQ and dK/dV pair and none of the f32 route's; the vision path: both
int8 product routes and the quantize pass, no flash or ragged kernel).
Prints
JSON lines per case, then {"kernels": [...]}, the nvidia-smi line, and
as the last line {"ok": true, "device": {...}}. Any failure raises: no phase is caught.
Exits non-zero without a CUDA device or outside a checkout of the repo.

    python3 chip_smoke.py --phases kernels,grad,train   # after editing a
                                                        # flash kernel
    python3 chip_smoke.py --phases kernels,kvint8,deploy   # the int8 slice
    python3 chip_smoke.py --phases generate        # decode and sampling
    python3 chip_smoke.py --phases kernels,spec    # speculative decoding
    python3 chip_smoke.py --phases observe         # the profiler
    python3 chip_smoke.py --phases engine,train,observe   # device time,
                                                   # program stats
    python3 chip_smoke.py --phases kernels,handoff # legacy mode, handoff,
                                                   # chain migration
    python3 chip_smoke.py --phases dist            # process groups and
                                                   # collectives, 2 ranks
    python3 chip_smoke.py --phases hybrid          # the trainer at dp, tp
                                                   # and ZeRO, 2 ranks
    python3 chip_smoke.py --phases parallel        # pp, sp and ep, 2 ranks
    python3 chip_smoke.py --phases resume          # checkpoints, elastic
                                                   # restart, host offload
    python3 chip_smoke.py --phases hybrid,plan     # planning without
                                                   # allocation, 13B plans
    python3 chip_smoke.py --phases disagg          # the serving mesh,
                                                   # 2 ranks a run
    python3 chip_smoke.py --phases resilience      # the guard, rollback,
                                                   # preemption, watchdog
    python3 chip_smoke.py --phases bert            # BERT-base pretraining,
                                                   # ERNIE at ZeRO 3
    python3 chip_smoke.py --phases vision          # LeNet/MNIST, ResNet-50,
                                                   # the int8 conv
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12,    # f32 outside the tensor cores
              "bfloat16": 989e12,  # bf16 dense tensor cores
              "int8": 1979e12,     # int8 dense tensor cores (operations/s)
              # f32 products as 3xTF32 on the tensor cores (the f32
              # backward kernels' route): 495 TFLOP/s TF32 dense, three
              # TF32 products per f32 product
              "tf32x3": 495e12 / 3}

F32_TOL = 2e-5   # as the reference holds its Pallas kernels to XLA (f32)
BF16_TOL = 2e-2  # one bf16 ulp at |o| <~ 1, f32 accumulation on both sides
# The forward kernels' reference is the plain version run on the same bf16
# values upcast (exactly) to f32, and the kernel's bf16 output is compared
# with it in f32 at BF16_TOL. The tensor-core forward also rounds P to
# bf16 before P.V, as the reference does (a relative 2^-9 on each weight,
# averaged over the keys: far inside one output ulp).
MODEL_TOL = 1e-3  # 24 layers of f32 in different reduction orders
#: the serving phases' model: gpt3_1_3b's widths, 4 of its 24 layers
#: (the tolerances below were set at 24 and hold at fewer)
SERVE_LAYERS = 4
BWD_F32_TOL = 3e-5  # the reference's own gradient tolerance (f32)
# The mma.sync backward kernels (f32, and bf16 at D 96) keep P and dS in
# f32 (3xTF32 products: f32 accuracy), so bf16 inputs are held to the
# plain version on the f32-upcast inputs; bf16 gradients round that f32
# result once, so they are held to it rounded to bf16 within one bf16 ulp
# at any magnitude (2^-7 relative; 8 significant bits), plus an absolute
# floor of 1e-3 * max|ref| for elements that cancel to near 0.
BWD_BF16_RTOL = 2.0 ** -7
BWD_BF16_ATOL = 1e-3
# The tensor-core dK/dV kernel rounds P and dS to bf16 before its products,
# as the reference does, so it is held to the plain version on the SAME
# bf16 inputs (S and dP in f32 from the bf16 values, P and dS rounded to
# bf16). The two sum S and dP in different orders, so a P or dS element
# that lies within that f32 difference of a bf16 rounding boundary rounds
# the other way on one side: each such flip moves a gradient by 2^-8 of
# one product term. Held at rtol BWD_F32_TOL (f32 out) or BWD_BF16_RTOL
# (bf16 out) plus atol BWD_TC_ATOL * max|ref|.
BWD_TC_ATOL = 2e-3
GRAD_TOL = 1e-3     # max |dg| / max |g| per parameter, model gradients
# bf16 model: every parameter, activation and gradient in bf16 (8
# significant bits); the plain attention rounds its logits to bf16 where
# the kernels keep them in f32, and the difference runs through both
# layers' backward with a bf16 rounding at every operation
GRAD_BF16_TOL = 5e-2
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


#: every launch count of the kernel wrappers: {key: (module of
#: paddle_tpu_torch.ops, attribute)}; each wrapper adds one where it
#: launches its kernel
LAUNCH_COUNTERS = {
    "flash": ("flash_attention", "FLASH_FWD_LAUNCHES"),
    "flash_tc": ("flash_attention", "FLASH_FWD_TC_LAUNCHES"),
    "bwd_single": ("flash_attention", "FLASH_BWD_SINGLE_LAUNCHES"),
    "bwd_single_tc": ("flash_attention", "FLASH_BWD_SINGLE_TC_LAUNCHES"),
    "bwd_dq": ("flash_attention", "FLASH_BWD_DQ_LAUNCHES"),
    "bwd_dq_tc": ("flash_attention", "FLASH_BWD_DQ_TC_LAUNCHES"),
    "bwd_dkv": ("flash_attention", "FLASH_BWD_DKV_LAUNCHES"),
    "bwd_dkv_tc": ("flash_attention", "FLASH_BWD_DKV_TC_LAUNCHES"),
    "ragged": ("paged_attention", "RAGGED_LAUNCHES"),
    "ragged_chunk": ("paged_attention", "RAGGED_CHUNK_LAUNCHES"),
    "ragged_int8": ("paged_attention", "RAGGED_INT8_LAUNCHES"),
    "int8_matmul": ("int8_matmul", "INT8_MATMUL_LAUNCHES"),
    "int8_matmul_wgmma": ("int8_matmul", "INT8_MATMUL_WGMMA_LAUNCHES"),
    "int8_quantize": ("int8_matmul", "INT8_QUANTIZE_LAUNCHES")}


def read_counts():
    """(every launch count, the chunk-row launches by query rows T)."""
    import importlib

    from paddle_tpu_torch.ops import paged_attention as pa

    mod = importlib.import_module
    return ({k: getattr(mod("paddle_tpu_torch.ops." + m), a)
             for k, (m, a) in LAUNCH_COUNTERS.items()},
            dict(pa.RAGGED_CHUNK_LAUNCHES_BY_T))


def set_counts(counts=None, by_t=None) -> None:
    """Set every launch count (to 0 when ``counts`` is None)."""
    import importlib

    from paddle_tpu_torch.ops import paged_attention as pa

    for k, (m, a) in LAUNCH_COUNTERS.items():
        setattr(importlib.import_module("paddle_tpu_torch.ops." + m), a,
                0 if counts is None else counts[k])
    pa.RAGGED_CHUNK_LAUNCHES_BY_T.clear()
    pa.RAGGED_CHUNK_LAUNCHES_BY_T.update(by_t or {})


@contextlib.contextmanager
def uncounted():
    """Launches made inside are not the driven path's own (a plain
    engine run only to compare with, a reference forward): every count
    is put back to what it was on entry."""
    saved = read_counts()
    try:
        yield
    finally:
        set_counts(*saved)


def ptxas_functions(log: str) -> dict:
    """{kernel function (mangled): {"registers": n, "spill": "..."}} from
    the `-Xptxas -v` build log of one source."""
    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function '" in ln:
            cur = ln.split("'")[1]
            out[cur] = {"registers": None, "spill": ""}
        elif cur and "spill stores" in ln:
            out[cur]["spill"] = ln.strip()
        elif cur and "Used " in ln and " registers" in ln:
            out[cur]["registers"] = int(ln.split("Used ")[1].split()[0])
    return out


def gpu_info_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


_SLEEP_MAX_MS = 200.0        # longest hold on the stream


@functools.lru_cache(maxsize=None)
def _sleep_cycles_per_ms(dev) -> float:
    """torch.cuda._sleep's cycles per millisecond on ``dev``, measured
    once."""
    import torch

    cycles = 20_000_000
    torch.cuda._sleep(cycles // 10)            # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def timed(fn, iters: int, dev):
    """(device ms, host ms) per call over ``iters`` calls after warm-up.

    Host ms: the host's own loop of ``iters`` calls, from its first call
    to its last return, then a sync (what a caller's loop pays when the
    card keeps up). Device ms: the card's time alone. The stream is held
    by ``torch.cuda._sleep`` for longer than that host loop takes, the
    start event and all ``iters`` calls are enqueued behind it, then the
    end event: the calls run back to back, never waiting on the host, so
    a kernel shorter than its wrapper's dispatch is timed by the card. In
    a CPU rehearsal both are the host loop."""
    import torch

    for _ in range(2):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    if dev.type != "cuda":
        return host, host
    torch.cuda.synchronize(dev)
    hold_ms = min(_SLEEP_MAX_MS, 1.5 * host * iters + 0.1)
    cycles = int(hold_ms * _sleep_cycles_per_ms(dev))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host


def time_ms(fn, iters: int, dev) -> float:
    """Device milliseconds per call (``timed``)."""
    return timed(fn, iters, dev)[0]


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
    # chunk rows whose pos0 is not page-aligned, and a T 40 row (not a
    # multiple of the kernel's 64-query tile) whose last real query is 37
    p0 = np.array([517, 771], np.int32)
    tl = np.array([256, 256], np.int32)
    una = ("chunk_unaligned_R2_T256", 256, p0, tl,
           tables(2, (p0 + tl - 1) // ps + 1))
    p0 = np.array([300], np.int32)
    tl = np.array([37], np.int32)
    t40 = ("chunk_R1_T40", 40, p0, tl, tables(1, (p0 + tl - 1) // ps + 1))
    # decode rows split over their pages: a one-page row beside a row
    # whose table is full (all nps pages attended)
    p0 = np.array([5, nps * ps - 1], np.int32)
    dsp = ("decode_split_R2_T1", 1, p0, np.ones(2, np.int32),
           tables(2, p0 // ps + 1))
    return [dec, chk, mix, una, t40, dsp]


def generate_ragged_groups(rng, npages, nps, ps, prompt_len=512,
                           max_new=32, n_rows=4):
    """Row groups at the generate phase's paged shapes: the engine there
    has one slot a prompt, nps = (prompt + max_new) / ps pages a slot and
    chunks of the whole prompt, so a prefill tick is one chunk row of
    prompt_len queries from position 0, and a decode tick n_rows rows
    between the prompt's end and the slot's last position."""
    import numpy as np

    def tables(n_used):
        tab = np.zeros((len(n_used), nps), np.int32)
        for i, n in enumerate(n_used):
            tab[i, :n] = rng.choice(np.arange(1, npages), n, replace=False)
        return tab

    p0 = np.zeros(1, np.int32)
    tl = np.array([prompt_len], np.int32)
    chk = (f"chunk_R1_T{prompt_len}", prompt_len, p0, tl,
           tables((p0 + tl - 1) // ps + 1))
    p0 = rng.randint(prompt_len, prompt_len + max_new, n_rows)
    p0 = p0.astype(np.int32)
    dec = (f"decode_R{n_rows}_T1", 1, p0, np.ones(n_rows, np.int32),
           tables(p0 // ps + 1))
    return [chk, dec]


def spec_ragged_groups(rng, npages, nps, ps, k=4, rows=8):
    """The verify rows of the spec phase: R8 T5 (k 4) and R8 T2 (k 1) over
    128-page tables, true_len mixed between 1 (a slot riding the group
    without drafts) and T, pos0 spread over 64-1056. The 6th element asks
    the kernel phase to hold the kernel to reading no page past a row's
    last real query, and to time the T decode-row calls that would do the
    same work."""
    import numpy as np

    out = []
    for t in (k + 1, 2):
        p0 = rng.randint(64, 1057, rows).astype(np.int32)
        tl = rng.randint(1, t + 1, rows).astype(np.int32)
        tl[:2] = 1, t                       # both extremes in the group
        tab = np.zeros((rows, nps), np.int32)
        for i in range(rows):
            n = (int(p0[i]) + int(tl[i]) - 1) // ps + 1
            tab[i, :n] = rng.choice(np.arange(1, npages), n, replace=False)
        out.append((f"spec_R{rows}_T{t}", t, p0, tl, tab,
                    {"no_read_past": True}))
    return out


def legacy_ragged_groups(rng, npages, nps, ps, chunk=256, slots=8, live=5):
    """The legacy engine's two row shapes at the engine's pool: its prefill
    program's one row of ``chunk`` queries (row length ``chunk``, as the
    program runs every chunk) from pos0 0 and 512, and its fixed-shape
    decode tick: ``live`` rows at their frontiers, idle rows on an
    all-null table at pos0 0 (their outputs are ignored, as the engine
    ignores them), and a slot that finished at exactly its capacity
    (pos0 == nps * ps over a full table: it attends every page)."""
    import numpy as np

    def table(n):
        row = np.zeros(nps, np.int32)
        row[:n] = rng.choice(np.arange(1, npages), n, replace=False)
        return row

    out = []
    for p0 in (0, 512):
        tab = table((p0 + chunk - 1) // ps + 1)[None]
        name = f"legacy_chunk_R1_T{chunk}" + (f"_p{p0}" if p0 else "")
        out.append((name, chunk, np.array([p0], np.int32),
                    np.array([chunk], np.int32), tab))
    idle = slots - live - 1
    p0 = np.concatenate([rng.randint(200, 1900, live), np.zeros(idle),
                         [nps * ps]]).astype(np.int32)
    tab = np.zeros((slots, nps), np.int32)
    for i in range(live):
        tab[i] = table(int(p0[i]) // ps + 1)
    tab[-1] = table(nps)
    out.append((f"legacy_decode_R{slots}_T1", 1, p0, np.ones(slots, np.int32),
                tab, {"ignore_rows": list(range(live, live + idle))}))
    return out


def poisoned(tab, p0, tl, ps, page):
    """``tab`` with every entry past each row's last real query's page
    pointing at ``page`` (a page of NaN appended to the pools)."""
    tab = tab.copy()
    for i in range(tab.shape[0]):
        tab[i, (int(p0[i]) + int(tl[i]) - 1) // ps + 1:] = page
    return tab


def check_no_read_past(name, out, outp, tl):
    """The kernel over poisoned tables must give the same real queries
    bit for bit: a read of a NaN page, masked or not, would show."""
    import torch

    for i in range(out.shape[0]):
        n = int(tl[i])
        if not torch.equal(out[i, :n], outp[i, :n]):
            raise AssertionError(f"ragged {name}: row {i} read a page past "
                                 "its last real query")


def decode_equiv(pa, q, k, v, tab_d, p0_d, **scales):
    """The T decode-row calls (T == 1 each) that do a [R, T] group's work:
    query j of every row at pos0 + j."""
    import torch

    t = q.shape[1]
    qs = [q[:, j:j + 1].contiguous() for j in range(t)]
    ps0 = [p0_d + j for j in range(t)]
    ones = torch.ones_like(p0_d)

    def run():
        for j in range(t):
            pa.ragged_paged_attention(qs[j], k, v, tab_d, ps0[j], ones,
                                      **scales)
    return run


def kernel_phase_ragged(dev, iters, seed=0, nh=16, hd=128, ps=16, nps=128,
                        chunk_only=False, slots=8, groups=ragged_groups):
    """The ragged kernel against _gather_attend over f32 and bf16 pools of
    `slots` slots of nps pages of ps (the engine's size by default), at
    the row groups `groups` gives. `chunk_only` keeps the T > 1 groups
    (the page-size-32 pool runs those only)."""
    import numpy as np
    import torch
    from torch.nn import functional as TF

    from paddle_tpu_torch.ops import paged_attention as pa

    rng = np.random.RandomState(seed)
    npages = slots * nps + 1             # the engine's pool
    g = torch.Generator(device=dev).manual_seed(seed)
    k32 = torch.randn(npages, ps, nh, hd, generator=g, device=dev)
    v32 = torch.randn(npages, ps, nh, hd, generator=g, device=dev)
    pools = {"float32": (k32, v32),
             "bfloat16": (k32.bfloat16(), v32.bfloat16())}
    results = []
    for name, t, p0, tl, tab, *opts in groups(rng, npages, nps, ps):
        opts = opts[0] if opts else {}
        spec = opts.get("no_read_past", False)
        ignore = set(opts.get("ignore_rows", ()))
        if chunk_only and t == 1:
            continue
        if ps != 16:
            name += f"_ps{ps}"
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
                # the kernel only: the plain version reads every page
                if spec and dev.type == "cuda":
                    nan = torch.full((1,) + tuple(k.shape[1:]), float("nan"),
                                     dtype=k.dtype, device=dev)
                    tab_p = torch.from_numpy(
                        poisoned(tab, p0, tl, ps, npages)).to(dev)
                    check_no_read_past(
                        name, out, pa.ragged_paged_attention(
                            q, torch.cat([k, nan]), torch.cat([v, nan]),
                            tab_p, p0_d, tl_d), tl)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            err = 0.0
            for i in range(r):
                if i in ignore:
                    continue
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
                kern_ms, host_ms = timed(lambda: pa.ragged_paged_attention(
                    q, k, v, *meta), iters, dev)
                plain_ms = time_ms(lambda: pa._gather_attend(
                    q, k, v, tab_d, qpos), iters, dev)
                lib_ms = time_ms(lambda: TF.scaled_dot_product_attention(
                    qt, kc, vc, attn_mask=mask), iters, dev)
                dec_ms = time_ms(decode_equiv(pa, q, k, v, tab_d, p0_d),
                                 iters, dev) if spec else None
            flops, nbytes = pa.ragged_cost(q, k, tab, p0, tl)
            b_ms, b_by = bound(nbytes, flops,
                               "float32" if "float32" in (qdt, kvdt)
                               else "bfloat16")
            row = {"phase": "kernel", "kernel": "ragged_paged_attention",
                   "case": name, "rows": "decode" if t == 1 else "chunk",
                   "q_dtype": qdt, "kv_dtype": kvdt,
                   "splits": decode_splits(q, k, tab_d),
                   "max_abs_err": err,
                   "tolerance": BF16_TOL if qdt == "bfloat16" else F32_TOL,
                   "tolerance_reason": (
                       "bf16 output: one bf16 ulp at |o| <~ 1, f32 "
                       "accumulation on both sides" if qdt == "bfloat16"
                       else "f32: online softmax reassociates the sum "
                       "(the reference's own Pallas-vs-XLA tolerance)"),
                   "kernel_ms": kern_ms, "host_ms": host_ms,
                   "plain_ms": plain_ms,
                   "library_ms": lib_ms,
                   "library": "F.scaled_dot_product_attention over the "
                              "gathered cache (gather not timed)",
                   "bound_ms": b_ms, "bound_by": b_by}
            if spec:
                row.update(no_read_past_last_query=dev.type == "cuda",
                           decode_rows_equiv_ms=dec_ms)
            if ignore:
                row["ignored_rows"] = sorted(ignore)
            emit(row)
            results.append(row)
    return results


def decode_splits(q, k_pool, tab):
    """The decode-row kernel's page ranges a row for a T == 1 call on the
    card (None for chunk rows and in a CPU rehearsal)."""
    from paddle_tpu_torch.ops import paged_attention as pa

    if q.shape[1] != 1 or q.device.type != "cuda":
        return None
    return pa._decode_splits(q, k_pool, tab)


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
                             nps=128, groups=ragged_groups):
    """The ragged kernel's int8 path against _gather_attend with scales,
    on the row groups ``groups`` gives (by default kernel_phase_ragged's:
    null pages in every table, a pad row with an all-null table)."""
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
    for name, t, p0, tl, tab, *spec in groups(rng, npages, nps, ps):
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
                if spec and dev.type == "cuda":
                    # the poisoned page: zero bytes under NaN scales
                    nan = torch.full((1, nh), float("nan"), device=dev)
                    zero = torch.zeros((1,) + tuple(kq.shape[1:]),
                                       dtype=kq.dtype, device=dev)
                    tab_p = torch.from_numpy(
                        poisoned(tab, p0, tl, ps, npages)).to(dev)
                    check_no_read_past(
                        name + "_int8", out, pa.ragged_paged_attention(
                            q, torch.cat([kq, zero]), torch.cat([vq, zero]),
                            tab_p, p0_d, tl_d, k_scale=torch.cat([ks, nan]),
                            v_scale=torch.cat([vs, nan])), tl)
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
                kern_ms, host_ms = timed(lambda: pa.ragged_paged_attention(
                    q, kq, vq, *meta, k_scale=ks, v_scale=vs), iters, dev)
                plain_ms = time_ms(lambda: pa._gather_attend(
                    q, kq, vq, tab_d, qpos, k_scale=ks, v_scale=vs),
                    iters, dev)
                lib_ms = time_ms(lambda: TF.scaled_dot_product_attention(
                    qt, kc, vc, attn_mask=mask), iters, dev)
                dec_ms = time_ms(decode_equiv(pa, q, kq, vq, tab_d, p0_d,
                                              k_scale=ks, v_scale=vs),
                                 iters, dev) if spec else None
            flops, nbytes = pa.ragged_cost(q, kq, tab, p0, tl, k_scale=ks)
            b_ms, b_by = bound(nbytes, flops, qdt)
            row = {"phase": "kernel",
                   "kernel": "ragged_paged_attention_int8",
                   "case": name, "rows": "decode" if t == 1 else "chunk",
                   "q_dtype": qdt, "kv_dtype": "int8",
                   "splits": decode_splits(q, kq, tab_d),
                   "max_abs_err": err, "tolerance": tol,
                   "tolerance_reason": (
                       "against _gather_attend with scales on the same "
                       "int8 pools, f32-upcast queries: " + (
                           "bf16 output, one bf16 ulp at |o| <~ 1"
                           if qdt == "bfloat16" else
                           "online softmax reassociates the sum; the "
                           "page scale is folded into scores and weights")),
                   "pool_dequant_max_abs_err_vs_f32": deq_err,
                   "kernel_ms": kern_ms, "host_ms": host_ms,
                   "plain_ms": plain_ms,
                   "library_ms": lib_ms,
                   "library": "F.scaled_dot_product_attention over the "
                              "gathered, dequantized cache (gather and "
                              "dequantization not timed)",
                   "bound_ms": b_ms, "bound_by": b_by}
            if spec:
                row.update(no_read_past_last_query=dev.type == "cuda",
                           decode_rows_equiv_ms=dec_ms)
            emit(row)
            results.append(row)
    return results


def kernel_phase_int8_matmul(dev, iters, cases, seed=8):
    """The fused int8 matmul kernels against their plain version.
    cases: (M, K, N, x dtype, relu, quant_out, out dtype, bias[, route]):
    each case runs the route _mm_route picks, or the route named (the mma
    kernel at a shape the wgmma route takes, to set the two side by side).
    wgmma cases get wq's K-major copy made once, as Int8Linear keeps it,
    and report the quantize pass of a float x apart (quantize_ms, inside
    kernel_ms). The library yardstick is torch._int_mm on pre-quantized x
    plus the epilogue in PyTorch operations (where _int_mm takes the
    shape)."""
    import torch

    from paddle_tpu_torch.ops import int8_matmul as im

    g = torch.Generator(device=dev).manual_seed(seed)
    results = []
    for m, k, n, xdt, relu, quant_out, odt, has_bias, *force in cases:
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
        wq_kn = wq.t().contiguous()
        sa = torch.tensor(2.0, device=dev)          # ~4 sigma of x
        scale = (sa / 127.0) * (ws / 127.0)
        bias = torch.randn(n, generator=g, device=dev) if has_bias else None
        if quant_out:       # fold the next layer's quantizer in
            y_amax = 0.5 * k ** 0.5 * 3.0
            scale = scale * (127.0 / y_amax)
            bias = None if bias is None else bias * (127.0 / y_amax)
        qs = (127.0 / sa).reshape(1)
        kw = dict(relu=relu, quant_out=quant_out, out_dtype=odtype)
        route = force[0] if force else im._mm_route(x, wq_kn)
        if force and force != ["mma"]:
            raise ValueError(f"int8 matmul case: unknown route {force}")

        def kern():
            if force:
                return im._mm_mma(x, wq, scale, bias,
                                  None if xdt == "int8" else qs, relu,
                                  quant_out, odtype, 127.0)
            return im.int8_matmul(x, wq, scale, bias, qs, wq_kn=wq_kn, **kw)

        def plain():
            return im._plain_int8_matmul(x, wq, scale, bias, qs, relu,
                                         quant_out, odtype, 127.0)

        counts = (im.INT8_MATMUL_LAUNCHES, im.INT8_MATMUL_WGMMA_LAUNCHES)
        with torch.inference_mode():
            out, ref = kern(), plain()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            ran = ("mma" if im.INT8_MATMUL_LAUNCHES > counts[0] else
                   "wgmma" if im.INT8_MATMUL_WGMMA_LAUNCHES > counts[1]
                   else None)
            if ran != route:
                raise AssertionError(f"int8_matmul {m}x{k}x{n}: route "
                                     f"{route} expected, {ran} ran")
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
                                 f"{relu} quant_out {quant_out} route "
                                 f"{route}: max abs err {err} against the "
                                 "plain version")
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
        quant_ms = None
        with torch.inference_mode():
            kern_ms, host_ms = timed(kern, iters, dev)
            plain_ms = time_ms(plain, max(1, iters // 4), dev)
            if route == "wgmma" and xdt != "int8":
                quant_ms = time_ms(lambda: im.quantize_x(x, qs), iters, dev)
        flops, nbytes = im.int8_matmul_cost(x, out, k, n, has_bias)
        b_ms, b_by = bound(nbytes, flops, "int8")
        row = {"phase": "kernel",
               "kernel": "int8_matmul_wgmma" if route == "wgmma"
               else "int8_matmul",
               "route": route,
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
               "kernel_ms": kern_ms, "host_ms": host_ms,
               "quantize_ms": quant_ms, "plain_ms": plain_ms,
               "library_ms": lib_ms,
               "library": "torch._int_mm on pre-quantized x + the epilogue "
                          "in PyTorch operations" if lib_ms is not None
               else None,
               "bound_ms": b_ms, "bound_by": b_by,
               "tops": 2.0 * m * k * n / (kern_ms * 1e-3) / 1e12,
               "int8_rate_share": b_ms / kern_ms}
        emit(row)
        results.append(row)
    return results


def kernel_phase_int8_quantize(dev, iters, shapes, seed=6):
    """The wgmma route's quantize pass (quantize_x) against its plain
    version: bit-equal int8. shapes: (M, K, x dtype). Besides normal
    values, x holds exact .5 ties of x * qscale (qscale 2: x = k / 4 for
    odd k, which round half to even) and values past +-amax."""
    import torch

    from paddle_tpu_torch.ops import int8_matmul as im

    g = torch.Generator(device=dev).manual_seed(seed)
    results = []
    for m, k, xdt in shapes:
        xdtype = getattr(torch, xdt)
        x = torch.randn(m, k, generator=g, device=dev) * 30.0
        # odd / 4 with |odd| < 256 (exact in bf16): x * 2 = odd / 2
        ties = (torch.randint(-128, 128, (m, k), generator=g, device=dev)
                * 2 + 1).float() / 4.0
        pick = torch.rand(m, k, generator=g, device=dev) < 0.5
        x = torch.where(pick, ties, x).to(xdtype)
        qs = torch.full((1,), 2.0, device=dev)
        with torch.inference_mode():
            out = im.quantize_x(x, qs)
            ref = im._plain_quantize_x(x, qs, 127.0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        xs = x.float() * 2.0
        n_ties = int((xs - xs.floor() == 0.5).sum())
        n_clip = int((xs.abs() > 127.5).sum())
        if n_ties < m * k // 8 or n_clip == 0:
            raise AssertionError("quantize_x: too few ties or clipped values "
                                 "for a strong check")
        if out.dtype != torch.int8 or not torch.equal(out, ref):
            raise AssertionError(f"quantize_x {m}x{k} {xdt}: "
                                 f"{int((out != ref).sum())} values differ "
                                 "from the plain version")
        with torch.inference_mode():
            kern_ms, host_ms = timed(lambda: im.quantize_x(x, qs), iters, dev)
            plain_ms = time_ms(lambda: im._plain_quantize_x(x, qs, 127.0),
                               iters, dev)
        lib_ms, lib_off = quantize_library(x, qs, ref, iters, dev)
        flops, nbytes = im.int8_quantize_cost(x)
        b_ms, b_by = bound(nbytes, flops, "float32")
        row = {"phase": "kernel", "kernel": "int8_quantize",
               "case": f"M{m}_K{k}_x{xdt}", "max_abs_err": 0.0,
               "tolerance": "equal", "ties": n_ties, "clipped": n_clip,
               "tolerance_reason": "one f32 product, round half to even, "
                                   "clip: the plain version's operations",
               "kernel_ms": kern_ms, "host_ms": host_ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "library": "torch.quantize_per_tensor(f32(x), 1 / qscale, 0, "
                          "qint8), x upcast before the clock (it clips at "
                          "-128, not -127)",
               "library_values_off": lib_off,
               "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        results.append(row)
    return results


def quantize_library(x, qs, ref, iters, dev):
    """(ms, values that differ from ``ref``) of one PyTorch call that
    quantizes per tensor: ``torch.quantize_per_tensor`` on f32(x) at scale
    1 / qscale (exact for qscale 2); (None, None) where this PyTorch has
    no such call on the device."""
    import torch

    x32 = x.float()
    scale = 1.0 / float(qs)

    def call():
        return torch.quantize_per_tensor(x32, scale, 0, torch.qint8)

    try:
        off = int((call().int_repr() != ref).sum())
        return timed(call, iters, dev)[0], off
    except (RuntimeError, NotImplementedError) as e:
        emit({"phase": "kernel", "kernel": "int8_quantize",
              "library_unavailable": str(e)[:200]})
        return None, None


def kernel_phase_flash(dev, iters, shapes, seed=1):
    """The forward kernels against _plain_fwd on the same values upcast to
    f32. Each case reports its route (tensor-core or SIMT); on the card
    the launch counters must show that route ran."""
    import torch
    from torch.nn import functional as TF

    from paddle_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(seed)
    results = []
    for (b, s, h, d), causal, dt in shapes:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev)
                   .to(dtype) for _ in range(3))
        tc = fa._tc_route(dtype, d)
        tc0 = fa.FLASH_FWD_TC_LAUNCHES
        with torch.inference_mode():
            o, lse = fa.flash_attention(q, k, v, causal=causal)
            ref, ref_lse = fa._plain_fwd(q.float(), k.float(), v.float(),
                                         causal, None)
        if dev.type == "cuda" and (fa.FLASH_FWD_TC_LAUNCHES > tc0) != tc:
            raise AssertionError(f"flash {(b, s, h, d)} {dt}: the "
                                 f"{'SIMT' if tc else 'tensor-core'} "
                                 "kernel ran")
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
            kern_ms, host_ms = timed(
                lambda: fa.flash_attention(q, k, v, causal), iters, dev)
            plain_ms = time_ms(lambda: fa._plain_fwd(q, k, v, causal, None),
                               max(1, iters // 4), dev)
            lib_ms = time_ms(lambda: TF.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), iters, dev)
        flops, nbytes = fa.flash_fwd_cost(q, k, v, causal, exact=True)
        b_ms, b_by = bound(nbytes, flops, dt)
        row = {"phase": "kernel",
               "kernel": "flash_attention_fwd_tc" if tc
               else "flash_attention_fwd",
               "route": "wgmma" if tc else "simt",
               "case": f"B{b}_S{s}_H{h}_D{d}_{'causal' if causal else 'full'}",
               "dtype": dt, "max_abs_err": err, "lse_max_abs_err": lse_err,
               "tolerance": tol,
               "tolerance_reason": (
                   "bf16 output compared in f32: one bf16 ulp at |o| <~ 1"
                   + ("; P rounded to bf16 before P.V as the reference does"
                      if tc else "")
                   if dt == "bfloat16" else
                   "f32: online softmax reassociates the sum"),
               "kernel_ms": kern_ms, "host_ms": host_ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "library": "F.scaled_dot_product_attention",
               "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        results.append(row)
    return results


def sdpa_backward_call(q, k, v, do, causal):
    """One PyTorch call that computes dQ, dK and dV of attention on these
    [B, S, H, D] inputs, for the library yardstick: the fused backward of
    PyTorch's own SDPA kernel on the outputs and logsumexp of its forward
    (flash for bf16; the memory-efficient kernel for f32, which flash does
    not take). Returns (a closure of that one call, its name)."""
    import torch

    aten = torch.ops.aten
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    with torch.no_grad():
        if q.dtype == torch.float32:
            out, lse, seed, off = aten._scaled_dot_product_efficient_attention(
                qt, kt, vt, None, True, 0.0, causal)
            return (lambda: aten._scaled_dot_product_efficient_attention_backward(
                dot, qt, kt, vt, None, out, lse, seed, off, 0.0,
                [True, True, True, False], causal),
                "aten._scaled_dot_product_efficient_attention_backward")
        (out, lse, cq, ck, mq, mk, seed, off,
         _) = aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0, causal)
    return (lambda: aten._scaled_dot_product_flash_attention_backward(
        dot, qt, kt, vt, out, lse, cq, ck, mq, mk, 0.0, causal, seed, off),
        "aten._scaled_dot_product_flash_attention_backward")


def sdpa_f32_kernels(dev, shape, seed=2):
    """Which aten kernels one causal f32 F.scaled_dot_product_attention
    call (the f32 forward's library yardstick) runs on the card, from
    torch.profiler, with TF32 off as everywhere in this script."""
    import torch
    from torch.nn import functional as TF

    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(*shape, generator=g, device=dev).transpose(1, 2)
               for _ in range(3))
    with torch.inference_mode():
        TF.scaled_dot_product_attention(q, k, v, is_causal=True)
        _, kernels = profile_kernels(
            dev, lambda: TF.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True))
    return {"phase": "kernel", "library_kernels_f32_sdpa": {
        "shape": list(shape), "causal": True,
        "kernels": [{"name": e.key, "ms": e.self_device_time_total / 1e3}
                    for e in kernels]}}


def sdpa_f32_bwd_kernels(dev, shape, seed=3):
    """Which aten kernels the f32 backward yardstick (sdpa_backward_call:
    PyTorch's memory-efficient attention backward, causal) runs on the
    card, from torch.profiler, with TF32 off as everywhere in this
    script."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(*shape, generator=g, device=dev)
                   for _ in range(4))
    call, name = sdpa_backward_call(q, k, v, do, True)
    call()
    _, kernels = profile_kernels(dev, call)
    return {"phase": "kernel", "library_kernels_f32_sdpa_backward": {
        "call": name, "shape": list(shape), "causal": True,
        "kernels": [{"name": e.key, "ms": e.self_device_time_total / 1e3}
                    for e in kernels]}}


def kernel_phase_flash_bwd(dev, iters, cases, seed=4):
    """Each backward kernel against its plain version on the same inputs:
    q/k/v/dO random, o and LSE from the forward kernel, delta = rowsum(dO
    o) (or given). The mma.sync kernels (3xTF32 products) keep P and dS
    in f32, so their bf16 inputs are held to the plain version run on the
    same values upcast to f32: f32 outputs at BWD_F32_TOL, bf16 outputs
    against that result rounded to bf16 at BWD_BF16_RTOL and
    BWD_BF16_ATOL * max|ref|. The
    tensor-core kernels (bf16 at D 64 or 128: merged, dQ, dK/dV) round P
    and dS to bf16 as the reference does, so they are held to the plain
    version run on the same bf16 inputs, with BWD_TC_ATOL * max|ref| for
    the P and dS elements that round the other way (the merged kernel's dQ
    is summed with atomics: f32 out at the f32 rtol, not bitwise). The
    library yardstick is one timed call of PyTorch's own fused attention
    backward (sdpa_backward_call: dQ, dK and dV together, so the dQ and
    dK/dV rows are compared with it as a pair); the old yardstick,
    autograd through F.scaled_dot_product_attention minus its forward, is
    kept beside it. A case is ((B, Sq, Sk, H, D), causal, dtype, f32 out,
    given delta[, rows]); ``rows`` (ring attention's chunks: a given
    delta, f32 out) holds a tensor-core kernel with the allowance of one
    bf16 flip of P or dS a row (``flip_row_check``, ROADMAP queue 3 item
    2) instead of the element-wise check."""
    import torch
    from torch.nn import functional as TF

    from paddle_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = torch.float32
    results = []
    for case_t in cases:
        (b, sq, sk, h, d), causal, dt, out_f32, given_delta = case_t[:5]
        rows = len(case_t) > 5 and case_t[5]
        dtype = getattr(torch, dt)
        q, do = (torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(b, sk, h, d, generator=g, device=dev).to(dtype)
                for _ in range(2))
        scale = 1.0 / d ** 0.5
        with torch.no_grad():
            o, lse = (fa._flash_cuda if dev.type == "cuda" else fa._plain_fwd)(
                q, k, v, causal, None)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
            .reshape(b * h, sq, 1)
        if given_delta:       # the ring's global-row delta, passed in
            delta = delta * 0.5 + 0.25
        out = f32 if out_f32 else dtype
        bq, bk = fa._blocks(sq, sk, causal)
        single = sq // bq == 1 and sk // bk == 1
        tc = fa._tc_route(dtype, d)
        sfx = "_tc" if tc else ""
        # the tensor-core kernels' plain version takes the same bf16 inputs
        # (P and dS rounded to bf16 there too), the mma.sync kernels' the
        # f32 upcast
        pres, pdo = ((q, k, v, lse), do) if tc else \
            ((q.float(), k.float(), v.float(), lse), do.float())
        res = (q, k, v, lse)
        if single:
            parts = [("flash_attention_bwd_single_tile" + sfx,
                      ("dq", "dk", "dv"),
                      lambda: fa._bwd_single_tile(scale, causal, res, do,
                                                  delta, (out,) * 3),
                      lambda: fa._plain_bwd_single_tile(
                          scale, causal, pres, pdo, delta, (f32,) * 3),
                      "single")]
        else:
            parts = [("flash_attention_bwd_dq" + sfx, ("dq",),
                      lambda: (fa._bwd_dq(scale, causal, res, do, delta,
                                          out),),
                      lambda: (fa._plain_bwd_dq(scale, causal, pres, pdo,
                                                delta, f32),), "dq"),
                     ("flash_attention_bwd_dkv" + sfx, ("dk", "dv"),
                      lambda: fa._bwd_dkv(scale, causal, res, do, delta,
                                          (out,) * 2),
                      lambda: fa._plain_bwd_dkv(scale, causal, pres, pdo,
                                                delta, (f32,) * 2), "dkv")]
        lib_call, lib_name = sdpa_backward_call(q, k, v, do, causal)
        lib_ms = time_ms(lib_call, iters, dev)
        # the yardstick of PRs 2-4: SDPA forward + backward, minus its
        # forward
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
        lib_diff_ms = time_ms(sdpa_grad, iters, dev) - lib_fwd
        shape = f"B{b}_S{sq}" + (f"x{sk}" if sk != sq else "") + \
            f"_H{h}_D{d}"
        case = (shape + f"_{'causal' if causal else 'full'}"
                + ("_outf32" if out_f32 else "")
                + ("_delta" if given_delta else ""))
        for name, grads, kern, plain, kind in parts:
            got = kern()
            ref = plain()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            errs, tols = {}, {}
            if rows:
                if not (tc and single and given_delta and out == f32):
                    raise AssertionError(f"{case}: the row allowance is "
                                         "for a given delta, f32 out")
                flips = flip_row_check(
                    f"{name} {case}", got, ref, flip_row_scales(
                        q, k, v, do, lse, delta, scale, causal),
                    BWD_F32_TOL)
                errs = {gn: f["max_abs_err"] for gn, f in flips.items()}
                tols = {"rtol": BWD_F32_TOL, "atol": "BWD_TC_ATOL max|ref| "
                        "+ 2^-7 of the row scale", "flips": flips}
            for gname, x, y in zip(grads, got, ref) if not rows else ():
                if x.dtype != out or x.shape != y.shape:
                    raise AssertionError(f"{name} {case}: {gname} "
                                         f"{x.dtype} {tuple(x.shape)}")
                if not bool(torch.isfinite(x).all()):
                    raise AssertionError(f"{name} {case}: {gname} not finite")
                if out == f32:
                    rtol = atol = BWD_F32_TOL
                    if tc:
                        atol = BWD_TC_ATOL * float(y.abs().max())
                else:
                    rtol = BWD_BF16_RTOL
                    atol = (BWD_TC_ATOL if tc else BWD_BF16_ATOL) * \
                        float(y.abs().max())
                    y = y.to(out).float()
                tols[gname] = {"rtol": rtol, "atol": atol}
                errs[gname] = float((x.float() - y).abs().max())
                if not torch.allclose(x.float(), y, rtol=rtol, atol=atol):
                    raise AssertionError(
                        f"{name} {case} {dt}: {gname} max abs err "
                        f"{errs[gname]} over rtol {rtol} atol {atol}")
            kern_ms, host_ms = timed(kern, iters, dev)
            plain_ms = time_ms(plain, max(1, iters // 4), dev)
            flops, nbytes = fa.flash_bwd_cost(kind, q, k, causal, out)
            extra = {}
            if dt == "float32":
                # f32 products run on the tensor cores as 3xTF32 (here and
                # in the library's f32 backward), so the card's rate for
                # this work is the 3xTF32 one; the f32 FMA line beside it
                b_ms, b_by = bound(nbytes, flops, "tf32x3")
                extra["bound_f32_fma_ms"] = bound(nbytes, flops, dt)[0]
            else:
                b_ms, b_by = bound(nbytes, flops, dt)
            row = {"phase": "kernel", "kernel": name,
                   "route": "wgmma" if tc else "mma_sync",
                   "case": case,
                   "dtype": dt, "out_dtype": str(out).split(".")[-1],
                   "max_abs_err": max(errs.values()), "max_abs_err_by": errs,
                   "tolerance": tols,
                   "tolerance_reason": (
                       "against the plain version on the same bf16 inputs "
                       "(P and dS rounded to bf16 on both sides): "
                       + ("f32 gradients, summation order" if out == f32 else
                          "bf16 gradients against the plain result rounded "
                          "to bf16, one bf16 ulp")
                       + ", atol 2e-3 max|ref| for P/dS elements that round "
                       "the other way"
                       + ("; a given delta: plus one bf16 flip of P or dS a "
                          "row (2^-7 of the row's scale)" if rows else "")
                       if tc else
                       "f32 gradients: summation order and 3xTF32 "
                       "products (a few 2^-22 each; the reference's own "
                       "gradient tolerance)" if out == f32
                       else "bf16 gradients against the f32 plain result "
                       "rounded to bf16: one bf16 ulp, atol 1e-3 max|ref|"),
                   "kernel_ms": kern_ms, "host_ms": host_ms,
                   "plain_ms": plain_ms,
                   "library_ms": lib_ms,
                   "library": lib_name + " (dQ, dK and dV together), one "
                              "call on its forward's outputs",
                   "library_autograd_minus_forward_ms": lib_diff_ms,
                   "bound_ms": b_ms, "bound_by": b_by, **extra}
            emit(row)
            results.append(row)
    return results


def flip_row_scales(q, k, v, do, lse, delta, scale, causal):
    """One bf16 flip of a P or dS element moves dQ[s, :] by at most 2^-7
    of |dS[s, t]| times a row of K, dK[t, :] by that of dS[s, t] times a
    row of q, dV[t, :] by that of P[s, t] times a row of dO: each output
    row's scale, max_t |dS[s, t]| max|K| (dQ), max_s |dS[s, t]| max|q|
    (dK), max_s P[s, t] max|dO| (dV), from the plain version's P and dS
    on these inputs ([B, S, H, 1] each)."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    b, s, nh, _ = q.shape
    qt, kt, vt, dot = (x.transpose(1, 2).float() for x in (q, k, v, do))
    sc = qt @ kt.transpose(-1, -2) * (scale * fa._LOG2E)
    p = torch.exp2(sc - lse.reshape(b, nh, s, 1) * fa._LOG2E)
    del sc
    if causal:
        p = torch.where(torch.ones(s, s, dtype=torch.bool,
                                   device=q.device).tril(), p, 0.0)
    ds = (p * (dot @ vt.transpose(-1, -2) - delta.reshape(b, nh, s, 1))
          * scale).abs()
    rows = {"dq": ds.amax(-1) * float(kt.abs().max()),
            "dk": ds.amax(-2) * float(qt.abs().max()),
            "dv": p.amax(-2) * float(dot.abs().max())}
    return {k: r.transpose(1, 2).unsqueeze(-1) for k, r in rows.items()}


def flip_row_check(what, got, ref, row_scale, rtol) -> dict:
    """Gradients computed with a given delta, held at rtol plus atol
    BWD_TC_ATOL max|ref| element-wise plus one bf16 flip a row (2^-7 of
    the row's scale, ``flip_row_scales``; ROADMAP queue 3 item 2).
    Returns the errors: the largest, the elements outside the
    element-wise check and the largest row excess over its row scale."""
    import torch

    out = {}
    for name, x, y in zip(("dq", "dk", "dv"), got, ref):
        x, y = x.float(), y.float()
        err = (x - y).abs()
        elem = BWD_TC_ATOL * float(y.abs().max()) + rtol * y.abs()
        rs_ = row_scale[name]
        ratio = ((err - elem).clamp_min(0) / rs_.clamp_min(1e-30))
        out[name] = {"max_abs_err": float(err.max()),
                     "outside_elementwise": int((err > elem).sum()),
                     "max_row_excess_over_row_scale": float(ratio.max())}
        if not bool(torch.isfinite(x).all()) or \
                not bool((err <= elem + 2.0 ** -7 * rs_).all()):
            raise AssertionError(f"{what}: {name} {out[name]} over one "
                                 "bf16 flip a row")
    return out


def given_delta_check(dev, nh, hd, seed=4):
    """Ring attention's given delta at S 1024 causal on bf16 inputs,
    through the wgmma merged kernel with f32 gradients (ROADMAP queue 3
    item 2), against the plain version on the same inputs (both round P
    and dS to bf16). BWD_TC_ATOL * max|ref| does not bound one P or dS
    element that rounds the other way on the two sides: it moves dQ[s, :]
    by one bf16 ulp (at most 2^-7 of |dS[s, t]|) times a row of K, dK[t, :]
    by that of dS[s, t] times a row of q, dV[t, :] by that of P[s, t]
    times a row of dO. So each output row is held at rtol BWD_F32_TOL plus
    atol BWD_TC_ATOL max|ref| plus 2^-7 of its row scale: max_t |dS[s, t]|
    max|K| (dQ), max_s |dS[s, t]| max|q| (dK), max_s P[s, t] max|dO| (dV).
    Reported beside it: the elements outside the element-wise check, and
    the largest row error over its row scale."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    # the inputs kernel_phase_flash_bwd draws for this case as its first
    g = torch.Generator(device=dev).manual_seed(seed)
    b, s, f32 = 2, 1024, torch.float32
    q, do, k, v = (torch.randn(b, s, nh, hd, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    scale = 1.0 / hd ** 0.5
    o, lse = (fa._flash_cuda if dev.type == "cuda" else fa._plain_fwd)(
        q, k, v, True, None)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
        .reshape(b * nh, s, 1) * 0.5 + 0.25
    res = (q, k, v, lse)
    got = fa._bwd_single_tile(scale, True, res, do, delta, (f32,) * 3)
    ref = fa._plain_bwd_single_tile(scale, True, res, do, delta, (f32,) * 3)
    out = flip_row_check(f"given delta S {s} bf16", got, ref,
                         flip_row_scales(q, k, v, do, lse, delta, scale,
                                         True), BWD_F32_TOL)
    row = {"phase": "kernel", "given_delta_check": {
        "case": f"B{b}_S{s}_H{nh}_D{hd}_causal_outf32_delta",
        "kernel": "flash_attention_bwd_single_tile_tc", "dtype": "bfloat16",
        "row_allowance": "2^-7 of the row scale", "errors": out}}
    emit(row)
    return row


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
           "tolerance_reason": f"{L} layers of f32 in different "
                               "reduction orders (TF32 off)",
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
    rate = teacher_match(model, dev, prompts, [out[r] for r in rids],
                         n_check)
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
    row["trace_window"] = engine_trace_window(model, dev, prompts, max_new,
                                              engine_kw)[0]
    emit(row)
    return row


#: the largest share of a window's device-busy time that slices joining no
#: dispatch site may take (host copies outside a site: the drain's
#: readback, a copy-on-write page copy)
UNATTRIBUTED_MAX_SHARE = 0.02


def trace_checker():
    """(tools/check_sink_schema.py as a module, its schema)."""
    import importlib.util

    path = os.path.join(HERE, "tools", "check_sink_schema.py")
    spec = importlib.util.spec_from_file_location("check_sink_schema", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    schema = json.load(open(os.path.join(HERE, "tools", "sink_schema.json")))
    return mod, schema


def check_window(s, site, timeline, dev, what):
    """The checks every parsed window of this script passes: a non-empty
    summary the sink schema accepts, busy_frac in [0, 1], ``site``'s row
    with executions == steps, slices joining no site under
    UNATTRIBUTED_MAX_SHARE of device_busy_ms (the largest of them by
    name, and the summed slice time, returned). Returns the numbers to
    print."""
    mod, schema = trace_checker()
    mod._ERRORS.clear()
    mod.check_trace_summary(s, schema, what)
    errs = list(mod._ERRORS)
    if errs or s.get("empty", True) or not 0.0 <= s["busy_frac"] <= 1.0:
        raise AssertionError(f"{what}: summary {errs or s}")
    row = s["sites"].get(site)
    if row is None or row["executions"] != s["steps"]:
        raise AssertionError(f"{what}: site {site} row {row}, steps "
                             f"{s['steps']}")
    loose = {}
    for name, module, _, dur in timeline.device_ops:
        if module is None:
            key = name[:80]
            loose[key] = loose.get(key, 0.0) + dur / 1e3
    loose_ms = sum(loose.values())
    summed_ms = sum(d for _, _, _, d in timeline.device_ops) / 1e3
    if s["device_busy_ms"] > summed_ms + 1e-3:      # rounded to 1e-4
        raise AssertionError(f"{what}: busy {s['device_busy_ms']} ms > "
                             f"summed slices {summed_ms} ms")
    if dev.type == "cuda" and \
            loose_ms > UNATTRIBUTED_MAX_SHARE * s["device_busy_ms"]:
        raise AssertionError(f"{what}: {loose_ms} ms of slices join no "
                             f"site: {sorted(loose.items())[:8]}")
    return {"steps": s["steps"], "wall_ms": s["wall_ms"],
            "device_busy_ms": s["device_busy_ms"],
            "summed_slice_ms": summed_ms, "host_gap_ms": s["host_gap_ms"],
            "busy_frac": s["busy_frac"],
            "categories": s["categories"], "site": site,
            "site_device_ms": row["device_ms"],
            "site_categories": row["categories"],
            "unattributed_ms": loose_ms,
            "unattributed_share": loose_ms / max(s["device_busy_ms"], 1e-9),
            "unattributed_largest": [
                {"name": k, "ms": v} for k, v in
                sorted(loose.items(), key=lambda kv: -kv[1])[:4]],
            "ledger": s["ledger"]}


def match_launches(what, slices, launches, lost):
    """Each kernel's slices in a window ({kernel: n}) against its launch
    counters' delta ({kernel: n}): equal, except that CUPTI can lose a
    kernel's record (the trace then holds its launch without its slice;
    ``lost`` such launches in the window), so a kernel may fall short by
    launches the trace shows lost, never by more in all, and never holds
    more slices than launches. Returns the shortfall."""
    short = 0
    for k, n in slices.items():
        if n > launches[k]:
            raise AssertionError(f"{what}: {k}: {n} slices, {launches[k]} "
                                 "launches")
        short += launches[k] - n
    if short > lost:
        raise AssertionError(f"{what}: slices {slices} against launches "
                             f"{launches}: {short} short, the trace lost "
                             f"{lost} launches' records")
    return short


def kernel_slices(timeline, name):
    """The slices of the CUDA kernel ``name`` (a word of the demangled
    name: ``ragged_kernel`` is not ``ragged_chunk_kernel``)."""
    import re

    pat = re.compile(rf"\b{name}\b")
    return [(n, m) for n, m, _, _ in timeline.device_ops if pat.search(n)]


def engine_trace_window(model, dev, prompts, max_new, engine_kw, ticks=8):
    """A parsed device-trace window of ``ticks`` engine ticks
    (``ServingEngine.trace_window``) on a fresh engine serving the
    workload, after one tick outside the window (the tick site's counted
    first dispatch). The ragged kernel's slices in the window number the
    launch counters' deltas (ragged_kernel + ragged_chunk_kernel slices =
    RAGGED_LAUNCHES, ragged_chunk_kernel = RAGGED_CHUNK_LAUNCHES, at most
    one ragged_chunk_merge a call), every one of them joins the tick site
    under attention, and the tick site's counted attention FLOPs (the
    kernel's cost hook) are non-zero. Returns (the numbers, the
    capture)."""
    from paddle_tpu_torch.profiler import device_trace as dt
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    eng = ServingEngine(model, ServingConfig(**engine_kw))
    for p in prompts:
        eng.submit(p, max_new)
    eng.step()
    with window_counts() as seen:
        with eng.trace_window() as cap:
            for _ in range(ticks):
                eng.step()
            eng.drain(0)
    ((_, counts),) = seen
    calls, chunk_calls = counts["ragged"], counts["ragged_chunk"]
    eng.run()
    (site,) = eng.compiled_sites
    out = check_window(cap.summary, site, cap.timeline, dev,
                       "engine window")
    if cap.summary["steps"] != ticks:
        raise AssertionError(f"engine window: {cap.summary['steps']} ticks")
    prog = eng.record_program_stats()[site]
    attn_flops = prog["categories"].get("attention", {}).get("flops", 0.0)
    out.update(program={k: prog[k] for k in ("flops", "bytes_accessed",
                                             "compile_ms")},
               program_attention_flops=attn_flops,
               ragged_launches=calls, ragged_chunk_launches=chunk_calls)
    if dev.type == "cuda":
        dec = kernel_slices(cap.timeline, "ragged_kernel")
        chk = kernel_slices(cap.timeline, "ragged_chunk_kernel")
        mrg = kernel_slices(cap.timeline, "ragged_chunk_merge")
        out.update(ragged_kernel_slices=len(dec),
                   ragged_chunk_kernel_slices=len(chk),
                   ragged_chunk_merge_slices=len(mrg),
                   launches_lost_by_trace=len(cap.lost_launches))
        out["slices_short"] = match_launches(
            "engine window", {"ragged_kernel": len(dec),
                              "ragged_chunk_kernel": len(chk)},
            {"ragged_kernel": calls - chunk_calls,
             "ragged_chunk_kernel": chunk_calls}, len(cap.lost_launches))
        if len(mrg) > calls or not chunk_calls:
            raise AssertionError(f"engine window: {len(mrg)} merge slices "
                                 f"for {calls} calls, {chunk_calls} chunk "
                                 "calls")
        stray = [(n[:60], m) for n, m in dec + chk + mrg
                 if m != site or dt.categorize_op(n) != "attention"]
        if stray or attn_flops <= 0:
            raise AssertionError(f"engine window: ragged slices off the "
                                 f"tick site {stray[:4]} or attention "
                                 f"FLOPs {attn_flops}")
    return out, cap


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

    def kernel_ms(part):
        return sum(e.self_device_time_total for e in kernels
                   if part in e.key) / 1e3

    return {
        "warm_wall_s": warm,
        # the ragged kernel's two row kinds (chunk rows: kernel and merge)
        "warm_ragged_chunk_rows_ms": kernel_ms("ragged_chunk"),
        "warm_ragged_decode_rows_ms": kernel_ms("ragged_kernel"),
        "warm_tokens_per_s": len(prompts) * max_new / warm,
        "warm_device_kernel_ms": busy_ms if kernels else None,
        "warm_device_busy_share": busy_ms / 1e3 / warm if kernels else None,
        "warm_top_kernels": top_kernels(kernels, 8)}, warm_streams


def profile_kernels(dev, fn, label=None):
    """(fn's result, the card's kernels by name) of one call of ``fn``
    under torch.profiler. With a ``label`` (a ``record_function`` range
    that ``fn`` opens) it also returns the ranges and fn's wall seconds
    inside the profiler: the ranges' count, the host time inside them
    (cpu_ms), the summed time of the kernels launched inside them
    (device_ms), and their span on the card's timeline (span_ms: first to
    last kernel, gaps included). The kernel list leaves out the
    device-side entries of every record_function range (the label, the
    trainer's fwd/* annotations): a range shows on the card's timeline
    under the name of its host entry, and it is not a kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        out, wall = _timed_call(dev, fn)
    avg = prof.key_averages()
    ranges = {e.key for e in avg if e.device_type == DeviceType.CPU}
    kernels = [e for e in avg if e.device_type == DeviceType.CUDA
               and e.key not in ranges]
    if label is None:
        return out, kernels
    host = [e for e in avg if e.key == label
            and e.device_type == DeviceType.CPU]
    span = [e for e in avg if e.key == label
            and e.device_type != DeviceType.CPU]
    info = {"count": sum(e.count for e in host),
            "cpu_ms": sum(e.cpu_time_total for e in host) / 1e3,
            "device_ms": sum(e.device_time_total for e in host) / 1e3,
            "span_ms": sum(e.self_device_time_total for e in span) / 1e3}
    return out, kernels, info, wall


def top_kernels(kernels, n):
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:n]
    return [{"name": e.key[:70], "ms": e.self_device_time_total / 1e3,
             "count": e.count} for e in top]


# ---------------------------------------------------------------------------
# phase 9: speculative decoding
# ---------------------------------------------------------------------------
SPEC_K = 4
# spec greedy against the plain engine's streams: the verify rows run the
# chunk-row kernel and the plain engine's decode rows the decode-row
# kernel (other reduction orders, other GEMM shapes), so a near tie may
# flip and change the rest of a stream: a match rate, as the engine
# phase's teacher-forced rule
SPEC_MATCH_FLOOR = 0.9
SPEC_TWIN_ACCEPT_FLOOR = 0.9     # twin: accepted / offered drafts
# sampled spec (twin) against the plain sampling engine: the same law
# and keys; only a near tie of gumbel + logits between the draft's and
# the target's logits can flip a draw
SPEC_SAMPLING_MATCH_FLOOR = 0.99
SPEC_LAW = dict(decode="sampling", temperature=0.8, top_k=50, top_p=0.95,
                seed=11)


def spec_drafts(model, dev):
    """(name, draft) of the spec phase: the twin (the target itself), an
    independent model at gpt3_125m's widths with the target's context from
    another seed, and a 2-block draft made of the target's embeddings, its
    first two blocks and ln_f."""
    import dataclasses

    from paddle_tpu_torch.core import rng as _rng
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig

    cfg = model.config
    _rng.seed(1)
    indep = GPT(GPTConfig(vocab_size=cfg.vocab_size, hidden_size=768,
                          num_layers=12, num_heads=12,
                          max_seq_len=cfg.max_seq_len), device=dev)
    two = GPT(dataclasses.replace(cfg, num_layers=2), device=dev)
    own = model.state_dict()
    two.load_state_dict({k: own[k] for k in two.state_dict()})
    for m in (indep, two):
        m.eval()
    return [("twin", model), ("indep_125m", indep), ("two_block", two)]


def spec_instrument(eng, dev):
    """Wrap a spec engine's draft tick and verify tick: CUDA events around
    each call (its span on the card, host gaps included), the host time of
    the call, a record_function range for the profiler, and the verify
    ticks that carried drafts and chunks."""
    import torch
    from torch.profiler import record_function

    st = {"draft": [], "verify": [], "with_drafts": 0, "with_chunks": 0}

    def wrap(fn, kind):
        def call(*a, **kw):
            if kind == "verify":        # (..., has_chunks, has_drafts)
                st["with_chunks"] += bool(a[14])
                st["with_drafts"] += bool(a[15])
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] \
                if dev.type == "cuda" else None
            t0 = time.perf_counter()
            if ev:
                ev[0].record()
            with record_function(f"spec_{kind}_tick"):
                out = fn(*a, **kw)
            if ev:
                ev[1].record()
            st[kind].append((ev, time.perf_counter() - t0))
            return out
        return call

    eng._draft.tick = wrap(eng._draft.tick, "draft")
    eng._spec_tick = wrap(eng._spec_tick, "verify")
    return st


def spec_tick_times(st):
    """Mean span on the card (CUDA events) and host ms of each tick kind;
    read after the run's final sync."""
    out = {}
    for kind in ("draft", "verify"):
        calls = st[kind]
        out[f"{kind}_ticks"] = len(calls)
        if not calls:
            continue
        host = sum(h for _, h in calls) / len(calls) * 1e3
        out[f"{kind}_tick_host_ms"] = host
        out[f"{kind}_tick_wall_ms"] = (
            sum(e[0].elapsed_time(e[1]) for e, _ in calls) / len(calls)
            if calls[0][0] else host)
    out["verify_ticks_with_drafts"] = st["with_drafts"]
    out["verify_ticks_with_chunks"] = st["with_chunks"]
    return out


def spec_serve(model, dev, prompts, max_new, engine_kw):
    """One run on a fresh engine: (streams, wall seconds, the spec
    counters' deltas, the tick stats of a spec engine or None; a spec
    engine's stats hold its events by rid under "events")."""
    from paddle_tpu_torch.profiler import events as pev
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    names = ("ticks", "spec_draft_ticks", "spec_feed_tokens",
             "spec_drafted_tokens", "spec_accepted_tokens",
             "spec_chained_ticks", "spec_chained_consumed",
             "spec_draft_pages_reclaimed", "preemptions", "tokens_generated")
    reg = registry()
    c0 = {n: reg.counter("serving/" + n).value for n in names}
    eng = ServingEngine(model, ServingConfig(**engine_kw))
    st = spec_instrument(eng, dev) if eng.config.spec is not None else None
    seq0 = pev.log().next_seq

    def serve():
        rids = [eng.submit(p, max_new) for p in prompts]
        out = eng.run()
        return [out[r] for r in rids]

    streams, wall = _timed_call(dev, serve)
    for r in streams:
        if r.shape != (max_new,):
            raise AssertionError(f"spec: a stream of {r.shape} tokens")
    bad = eng.pool.check_consistency()
    if bad:
        raise AssertionError(f"spec: page audit {bad[:4]}")
    counts = {n: reg.counter("serving/" + n).value - c0[n] for n in names}
    if st is not None:
        st["events"] = engine_events(eng, seq0)
    return streams, wall, counts, st


def match_rate(a, b):
    return sum(int((x == y).sum()) for x, y in zip(a, b)) / \
        sum(len(x) for x in a)


def teacher_match(model, dev, prompts, streams, n_check):
    """Teacher-forced greedy check: GPT.forward over prompt + stream
    recomputes every step's argmax in one call; the share that agrees."""
    import numpy as np
    import torch

    match = total = 0
    for i in range(n_check):
        p, o = prompts[i], streams[i]
        seq = np.concatenate([p, o[:-1]]).astype(np.int64)
        with torch.inference_mode():
            lg = model(torch.from_numpy(seq)[None].to(dev))[0]
        pred = lg[len(p) - 1:].argmax(-1).cpu().numpy()
        match += int((pred == o).sum())
        total += len(o)
    return match / total


def spec_phase(model, dev, engine_kw, plain=None, card=None, n_req=16,
               max_new=32, n_check=4, k=SPEC_K):
    """Speculative serving at gpt3_1_3b on the engine phase's workload
    (``plain``: the engine phase's streams, when it ran), three drafts at
    k 4: streams, acceptance, the verify rows' chunk-row launches, warm
    tokens/s against the plain engine in turns, the ticks' times; then
    sampled spec (overlap off and on) and int8 pages with the twin."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import SpecConfig

    t_phase = time.perf_counter()
    cfg = model.config
    L = cfg.num_layers
    prompts = engine_prompts(cfg, n_req)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0

    def serve(kw):
        return spec_serve(model, dev, prompts, max_new, kw)

    def serve_plain(kw):
        # a plain engine to compare with: its launches are not the spec
        # path's
        with uncounted():
            return serve(kw)

    if plain is None:
        plain = serve_plain(engine_kw)[0]
    drafts = spec_drafts(model, dev)
    row = {"phase": "spec", "config": "gpt3_1_3b", "card": card,
           "requests": n_req, "max_new_tokens": max_new, "k": k,
           "drafts": {}}

    def kw_for(draft, **extra):
        return dict(engine_kw, spec=SpecConfig(draft_model=draft, k=k,
                                               **extra))

    for name, draft in drafts:
        c0 = pa.RAGGED_CHUNK_LAUNCHES
        v0 = pa.RAGGED_CHUNK_LAUNCHES_BY_T.get(1 + k, 0)
        streams, wall, cnt, st = serve(kw_for(draft))
        chunk_launches = pa.RAGGED_CHUNK_LAUNCHES - c0
        verify_launches = pa.RAGGED_CHUNK_LAUNCHES_BY_T.get(1 + k, 0) - v0
        times = spec_tick_times(st)
        with uncounted():
            teacher = teacher_match(model, dev, prompts, streams, n_check)
        acc = cnt["spec_accepted_tokens"] / max(cnt["spec_drafted_tokens"],
                                                1)
        d = {"cold_wall_s": wall, "ticks": cnt["ticks"],
             "draft_ticks": cnt["spec_draft_ticks"],
             "feed_tokens": cnt["spec_feed_tokens"],
             "drafted_tokens": cnt["spec_drafted_tokens"],
             "accepted_tokens": cnt["spec_accepted_tokens"],
             "accept_rate": acc,
             "verify_ticks_with_drafts": times["verify_ticks_with_drafts"],
             "mean_accepted_per_verify_tick": cnt["spec_accepted_tokens"]
             / max(times["verify_ticks_with_drafts"], 1),
             "tokens_per_tick": cnt["tokens_generated"] / cnt["ticks"],
             "draft_pages_reclaimed": cnt["spec_draft_pages_reclaimed"],
             "preemptions": cnt["preemptions"],
             "chunk_row_launches": chunk_launches,
             "verify_group_launches": verify_launches,
             "teacher_forced_match": teacher,
             "match_vs_plain": match_rate(streams, plain)}
        if name == "twin":
            # the twin run's event timeline: draft < verify < accept per
            # request, accepted <= drafted
            d["timeline"] = check_spec_timelines(st["events"], n_req)
        row["drafts"][name] = d
        # one chunk-row launch at T = 1 + k a layer for the verify group of
        # every tick with drafts, and one a layer for the chunk group of
        # every tick with chunks
        want_v = L * times["verify_ticks_with_drafts"]
        want = want_v + L * times["verify_ticks_with_chunks"]
        fails = []
        if verify_launches != want_v or want_v == 0:
            fails.append(f"verify-group launches {verify_launches}, "
                         f"want {want_v} > 0")
        if chunk_launches < want:
            fails.append(f"chunk-row launches {chunk_launches} < {want}")
        if d["teacher_forced_match"] < 0.9:
            fails.append(f"teacher-forced match {d['teacher_forced_match']}")
        if d["match_vs_plain"] < SPEC_MATCH_FLOOR:
            fails.append(f"match vs plain {d['match_vs_plain']}")
        if name == "twin" and acc < SPEC_TWIN_ACCEPT_FLOOR:
            fails.append(f"twin accept rate {acc}")
        if fails:
            emit(row)
            raise AssertionError(f"spec {name}: {fails}")

    # warm tokens/s in turns on fresh engines: plain, each draft, plain
    walls = {"plain": []}
    for name, draft in [("plain", None)] + drafts + [("plain", None)]:
        if draft is None:
            _, wall, _, st = serve_plain(engine_kw)
        else:
            _, wall, _, st = serve(kw_for(draft))
        walls.setdefault(name, []).append(wall)
        if draft is not None:
            row["drafts"][name].update(
                warm_wall_s=wall, warm_tokens_per_s=n_req * max_new / wall,
                **{"warm_" + n: v for n, v in spec_tick_times(st).items()})
    row["plain_warm_walls_s"] = walls["plain"]
    row["plain_warm_tokens_per_s"] = n_req * max_new / (
        sum(walls["plain"]) / 2)
    # the twin under torch.profiler: kernel ms of each tick kind, busy
    # share against the warm run's wall
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        serve(kw_for(model))
    avg = prof.key_averages()
    kernels = [e for e in avg if e.device_type == DeviceType.CUDA
               and not e.key.startswith("spec_")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    tw = row["drafts"]["twin"]
    for kind in ("draft", "verify"):
        host = [e for e in avg if e.key == f"spec_{kind}_tick"
                and e.device_type == DeviceType.CPU]
        n = sum(e.count for e in host)
        tw[f"{kind}_tick_kernel_ms"] = (
            sum(e.device_time_total for e in host) / 1e3 / max(n, 1))
    tw["warm_device_kernel_ms"] = busy_ms
    tw["warm_device_busy_share"] = busy_ms / 1e3 / tw["warm_wall_s"]
    tw["warm_top_kernels"] = top_kernels(kernels, 6)

    # sampled spec with the twin: overlap off and on, against the plain
    # sampling engine on the same keys
    samp = dict(engine_kw, **SPEC_LAW)
    ref = serve_plain(samp)[0]
    runs = {}
    for overlap in (False, True):
        streams, wall, cnt, _ = serve(
            dict(samp, spec=SpecConfig(draft_model=model, k=k,
                                       overlap=overlap)))
        runs[overlap] = streams
        row["sampling_overlap" if overlap else "sampling_sync"] = {
            "wall_s": wall, "tokens_per_s": n_req * max_new / wall,
            "accept_rate": cnt["spec_accepted_tokens"]
            / max(cnt["spec_drafted_tokens"], 1),
            "chained_ticks": cnt["spec_chained_ticks"],
            "chained_consumed": cnt["spec_chained_consumed"],
            "match_vs_plain_sampling": match_rate(streams, ref)}
    row["sampling_overlap_runs_equal"] = all(
        (a == b).all() for a, b in zip(runs[False], runs[True]))
    worst = min(row[n]["match_vs_plain_sampling"]
                for n in ("sampling_sync", "sampling_overlap"))
    # the twin on int8 pages: two runs, equal streams
    q8 = [serve(dict(kw_for(model), kv_dtype="int8")) for _ in range(2)]
    row["int8"] = {
        "walls_s": [q[1] for q in q8],
        "accept_rate": q8[0][2]["spec_accepted_tokens"]
        / max(q8[0][2]["spec_drafted_tokens"], 1),
        "two_runs_equal": all((a == b).all()
                              for a, b in zip(q8[0][0], q8[1][0])),
        "match_vs_f32_plain": match_rate(q8[0][0], plain)}
    del q8
    row["peak_memory_gib_above_model"] = (
        (torch.cuda.max_memory_allocated(dev) - mem0) / 2 ** 30
        if dev.type == "cuda" else None)
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    fails = []
    if not row["sampling_overlap_runs_equal"]:
        fails.append("sampled spec: overlap on and off differ")
    if worst < SPEC_SAMPLING_MATCH_FLOOR:
        fails.append(f"sampled spec against plain sampling: {worst}")
    if not row["int8"]["two_runs_equal"]:
        fails.append("int8 spec: two runs differ")
    if fails:
        raise AssertionError(f"spec: {fails}")
    return row


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
# phase 8: GPT.generate (dense and paged), sampling, beam search
# ---------------------------------------------------------------------------
def _teacher_logits(model, dev, prompts, streams):
    """GPT.forward over each prompt + its stream (all but the last token):
    the logits that predicted every emitted token, [B, max_new, V]."""
    import torch

    seq = torch.cat([prompts, streams[:, :-1]], dim=1).to(dev)
    with torch.inference_mode():
        lg = model(seq)
    return lg[:, prompts.shape[1] - 1:]


def _timed_call(dev, fn):
    """(fn's result, wall seconds to the end of its device work)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def _warm_calls(dev, fn, prompt_sets):
    """Time ``fn(prompts)`` once on each set of ``prompt_sets`` (each call
    to the end of its device work). Every set is new to the model, so a
    paged call finds none of it in its engine's prefix cache and prefills
    all of it, as a dense call does. Returns (median wall seconds, every
    wall, each call's prefix-hit tokens)."""
    from paddle_tpu_torch.profiler import registry

    hit_tokens = registry().counter("serving/prefix_hit_tokens")
    walls, hits = [], []
    for p in prompt_sets:
        h0 = hit_tokens.value
        _, wall = _timed_call(dev, lambda: fn(p))
        walls.append(wall)
        hits.append(int(hit_tokens.value - h0))
    return sorted(walls)[len(walls) // 2], walls, hits


def sampling_tv(dev, vocab=50304, top_k=50, draws=65536, chunk=4096,
                seed=11):
    """Draw `draws` times from one fixed filtered row (the rows of a tick:
    each draw's key is the request key folded by its position 0..draws-1)
    and return (total-variation distance to the filtered softmax, the
    bound, the support size). The bound is E[TV] <= sqrt(k / n) / 2 plus
    McDiarmid's deviation sqrt(ln(1e6) / (2 n)): a correct sampler exceeds
    it with probability under 1e-6."""
    import math

    import numpy as np
    import torch

    from paddle_tpu_torch.core import random as R
    from paddle_tpu_torch.ops.decoding import apply_top_k_top_p

    g = torch.Generator(device="cpu").manual_seed(seed)
    row = (torch.randn(vocab, generator=g) * 3.0).to(dev)
    lp = torch.log_softmax(apply_top_k_top_p(row[None], top_k)[0], dim=-1)
    p = torch.exp(lp.double()).cpu().numpy()
    key = R.PRNGKey(seed, device=dev)
    counts = np.zeros(vocab, np.int64)
    for c0 in range(0, draws, chunk):
        pos = torch.arange(c0, min(c0 + chunk, draws), device=dev)
        tok = R.categorical(R.fold_in(key, pos),
                            lp[None].expand(pos.shape[0], vocab))
        counts += np.bincount(tok.cpu().numpy(), minlength=vocab)
    tv = 0.5 * float(np.abs(counts / draws - p).sum())
    support = int((p > 0).sum())
    bnd = 0.5 * math.sqrt(support / draws) + \
        math.sqrt(math.log(1e6) / (2 * draws))
    return tv, bnd, support


def generate_phase(model, dev, engine_kw, n_prompt=4, prompt_len=512,
                   max_new=32, beam_prompt=128, beam_new=16, seed=11):
    """GPT.generate at gpt3_1_3b: dense greedy (held to teacher-forced
    GPT.forward argmax), paged greedy (held to the dense streams, through
    the ragged kernel), paged sampling (reproducible, top_k=1 is greedy,
    tokens inside the teacher-forced top 50), an engine with per-request
    sampling overrides (one tick's draw held against the same call on the
    CPU), the generator on the card (bits equal to the CPU's, a
    65536-draw TV test) and beam search (num_beams=1 is greedy; 4 beams
    score at least greedy's log-prob). Warm calls are timed on prompts
    the model has not seen, so every call prefills its whole prompt."""
    import numpy as np
    import torch

    from paddle_tpu_torch.core import random as R
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops.decoding import apply_top_k_top_p_per_row
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = model.config
    rng = np.random.RandomState(seed)

    def prompt_set():
        return torch.from_numpy(rng.randint(
            0, cfg.vocab_size, (n_prompt, prompt_len)).astype(np.int64))

    def gen(p, **kw):
        return model.generate(p, max_new_tokens=max_new, **kw)

    def fresh(n=3):
        return [prompt_set() for _ in range(n)]

    prompts = prompt_set()
    sample_kw = dict(decode_strategy="sampling", temperature=0.8, top_k=50,
                     top_p=0.95, seed=seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    row = {"phase": "generate", "config": "gpt3_1_3b", "batch": n_prompt,
           "prompt_tokens": prompt_len, "max_new_tokens": max_new}
    reg = registry()
    hit_tokens = reg.counter("serving/prefix_hit_tokens")

    def again(kw, ref, what):
        """The same prompts once more: equal ids (a paged call now finds
        all but the last token of each prompt in its prefix cache)."""
        h0 = hit_tokens.value
        if not torch.equal(gen(prompts, **kw)[0], ref):
            raise AssertionError(f"generate: two {what} calls differ")
        return int(hit_tokens.value - h0)

    # dense greedy: cold, the same prompts again, warm on new prompts, and
    # prefill + one step for the step time
    (dense, _), row["dense_cold_s"] = _timed_call(dev, lambda: gen(prompts))
    if dense.shape != (n_prompt, max_new):
        raise AssertionError(f"generate: dense greedy {tuple(dense.shape)}")
    again({}, dense, "dense greedy")
    warm, row["dense_warm_walls_s"], _ = _warm_calls(dev, gen, fresh())
    one, _, _ = _warm_calls(
        dev, lambda p: model.generate(p, max_new_tokens=1), fresh())
    pred = _teacher_logits(model, dev, prompts, dense.cpu()).argmax(-1)
    rate = float((pred.cpu() == dense.cpu()).float().mean())
    row.update(dense_greedy_match=rate, dense_warm_s=warm,
               dense_ms_per_step=warm * 1e3 / max_new,
               dense_decode_step_ms=(warm - one) * 1e3 / (max_new - 1),
               dense_tokens_per_s=n_prompt * max_new / warm)
    if rate < 0.9:
        emit(row)
        raise AssertionError(f"generate: dense greedy match {rate} < 0.9")

    # paged greedy through the engine (page 16, 34 pages a slot, 512-token
    # chunk rows): the ragged kernel on the card
    ticks0 = reg.counter("serving/ticks").value
    r0, c0 = pa.RAGGED_LAUNCHES, pa.RAGGED_CHUNK_LAUNCHES
    paged, _ = gen(prompts, paged=True)
    ticks = int(reg.counter("serving/ticks").value - ticks0)
    ragged = pa.RAGGED_LAUNCHES - r0
    chunks = pa.RAGGED_CHUNK_LAUNCHES - c0
    row["paged_repeat_prefix_hit_tokens"] = again(
        dict(paged=True), paged, "paged greedy")
    pwarm, row["paged_warm_walls_s"], phits = _warm_calls(
        dev, lambda p: gen(p, paged=True), fresh())
    prate = float((paged.cpu() == dense.cpu()).float().mean())
    row.update(paged_ticks=ticks, paged_ragged_launches=ragged,
               paged_chunk_launches=chunks,
               paged_vs_dense_match=prate, paged_warm_s=pwarm,
               paged_warm_prefix_hit_tokens=phits,
               paged_ms_per_step=pwarm * 1e3 / max_new,
               paged_tokens_per_s=n_prompt * max_new / pwarm)
    if ragged < cfg.num_layers * ticks:
        emit(row)
        raise AssertionError(f"generate: paged ragged launches {ragged} < "
                             f"{cfg.num_layers} x {ticks} ticks")
    if prate < 0.9:
        emit(row)
        raise AssertionError(f"generate: paged vs dense match {prate} < 0.9")

    # paged sampling: reproducible, top_k=1 is greedy, inside the top 50
    samp, _ = gen(prompts, paged=True, **sample_kw)
    row["sampling_repeat_prefix_hit_tokens"] = again(
        dict(paged=True, **sample_kw), samp, "paged sampling")
    swarm, row["sampling_warm_walls_s"], shits = _warm_calls(
        dev, lambda p: gen(p, paged=True, **sample_kw), fresh())
    k1, _ = gen(prompts, paged=True, **dict(sample_kw, top_k=1))
    tl = _teacher_logits(model, dev, prompts, samp.cpu())
    top = tl.topk(sample_kw["top_k"], dim=-1).indices.cpu()
    inside = float((top == samp.cpu()[..., None]).any(-1).float().mean())
    row.update(sampling_top_k1_is_greedy=bool(torch.equal(k1, paged)),
               sampling_inside_top_k=inside,
               sampling_distinct_from_greedy=float(
                   (samp.cpu() != paged.cpu()).float().mean()),
               sampling_warm_s=swarm,
               sampling_warm_prefix_hit_tokens=shits,
               sampling_ms_per_step=swarm * 1e3 / max_new,
               sampling_tokens_per_s=n_prompt * max_new / swarm)
    if not row["sampling_top_k1_is_greedy"] or inside < 0.99:
        emit(row)
        raise AssertionError("generate: top_k=1 is not greedy, or sampled "
                             "tokens lie outside the top 50")
    if any(phits) or any(shits):
        emit(row)
        raise AssertionError("generate: a warm paged call on new prompts "
                             "hit the prefix cache")

    # where the time goes: the sampling step's share of the tick under
    # torch.profiler (its kernels and its host time), and the dense decode
    # step's kernels against its wall; each on new prompts
    orig = ServingEngine.__dict__["_sample_tok"]
    host_s = []

    def annotated(*a, **kw):
        with torch.profiler.record_function("sample_tok"):
            return orig.__func__(*a, **kw)

    def clocked(*a, **kw):
        t0 = time.perf_counter()
        out = orig.__func__(*a, **kw)
        host_s.append(time.perf_counter() - t0)
        return out

    p_prof, p_clock = fresh(2)
    try:
        ServingEngine._sample_tok = staticmethod(annotated)
        _, kernels, annot, pwall = profile_kernels(
            dev, lambda: gen(p_prof, paged=True, **sample_kw), "sample_tok")
        # the host time of the step without the profiler's own cost
        ServingEngine._sample_tok = staticmethod(clocked)
        _, cwall = _timed_call(
            dev, lambda: gen(p_clock, paged=True, **sample_kw))
    finally:
        ServingEngine._sample_tok = orig
    kern_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    row.update(sampling_profiled_wall_s=pwall,
               sampling_kernel_ms=kern_ms,
               sampling_busy_share=kern_ms / 1e3 / swarm,
               sample_step_calls=annot["count"],
               sample_step_kernel_ms=annot["device_ms"],
               sample_step_span_ms=annot["span_ms"],
               sample_step_share_of_kernel_time=(
                   annot["device_ms"] / kern_ms if kern_ms else None),
               sample_step_host_ms_profiled=annot["cpu_ms"],
               sample_step_share_of_wall_profiled=annot["cpu_ms"] / 1e3
               / pwall,
               sample_step_host_ms=sum(host_s) * 1e3,
               sample_step_share_of_wall=sum(host_s) / cwall,
               sampling_top_kernels=top_kernels(kernels, 6))
    # the dense step's kernels: 32 new tokens against 1 (the prefill and
    # one step) gives the decode steps' own
    _, dkern = profile_kernels(
        dev, lambda: model.generate(prompts, max_new_tokens=max_new))
    _, dkern1 = profile_kernels(
        dev, lambda: model.generate(prompts, max_new_tokens=1))
    dk_ms = sum(e.self_device_time_total for e in dkern) / 1e3
    dk1_ms = sum(e.self_device_time_total for e in dkern1) / 1e3
    step_kern = (dk_ms - dk1_ms) / (max_new - 1)
    row.update(dense_kernel_ms=dk_ms, dense_busy_share=dk_ms / 1e3 / warm,
               dense_decode_step_kernel_ms=step_kern,
               dense_decode_step_busy_share=step_kern
               / row["dense_decode_step_ms"],
               dense_launches_per_decode_step=(
                   sum(e.count for e in dkern) - sum(e.count for e in dkern1))
               / (max_new - 1),
               dense_top_kernels=top_kernels(dkern, 6))

    # an engine with per-request sampling overrides: 16 requests, two
    # runs; the second keeps its widest tick's draw (inputs and tokens)
    eprompts = engine_prompts(cfg)
    over = [dict(temperature=0.6 + 0.05 * i,
                 top_k=(0, 20, 50, 1)[i % 4],
                 top_p=(1.0, 0.9, 0.8)[i % 3]) for i in range(len(eprompts))]
    tick = {}

    def kept(logits, *law):
        tok = orig.__func__(logits, *law)
        if law and logits.shape[0] > tick.get("rows", 0):
            tick.update(rows=logits.shape[0], logits=logits.cpu(),
                        law=[x.cpu() for x in law], tok=tok.cpu())
        return tok

    def serve():
        eng = ServingEngine(model, ServingConfig(
            decode="sampling", seed=seed, **engine_kw))
        rids = [eng.submit(p, max_new, **o) for p, o in zip(eprompts, over)]
        out = eng.run()
        return [out.get(r) for r in rids]

    first, ewall = _timed_call(dev, serve)
    try:
        ServingEngine._sample_tok = staticmethod(kept)
        second = serve()
    finally:
        ServingEngine._sample_tok = orig
    for i, (a, b) in enumerate(zip(first, second)):
        if a is None or a.shape != (max_new,) or not np.array_equal(a, b):
            raise AssertionError(f"generate: override request {i} did not "
                                 "finish or two runs differ")
    # that tick's draw on the CPU from the same logits, keys, positions
    # and knobs: equal tokens wherever the two best perturbed scores are
    # more than 1e-5 apart (the card's log may differ from the CPU's by
    # an ulp), and most rows must be that far apart
    lg, law = tick["logits"], tick["law"]
    cpu_tok = ServingEngine._sample_tok(lg, *law)
    pos, keys, temps, top_ks, top_ps = law
    filt = apply_top_k_top_p_per_row(
        lg.float() / torch.clamp(temps, min=1e-6)[:, None], top_ks, top_ps)
    score = R.gumbel(R.fold_in(keys, pos), lg.shape[1:]) + \
        torch.log_softmax(filt, dim=-1)
    best2 = score.topk(2, dim=-1).values
    firm = (best2[:, 0] - best2[:, 1]) > 1e-5
    equal = cpu_tok == tick["tok"]
    row.update(override_requests=len(eprompts), override_wall_s=ewall,
               override_tokens_per_s=len(eprompts) * max_new / ewall,
               sample_tick_rows=tick["rows"],
               sample_tick_rows_held=int(firm.sum()),
               sample_tick_rows_equal_cpu=int(equal.sum()))
    if 2 * int(firm.sum()) < tick["rows"] or not bool(equal[firm].all()):
        emit(row)
        raise AssertionError("generate: the card's sampling tick differs "
                             "from the same draw on the CPU")

    # the generator on the card: bits equal to the CPU's; the law by TV
    keys = R.split(R.PRNGKey(seed, device="cpu"), 8)
    on_card = R.bits(keys.to(dev), (cfg.vocab_size,)).cpu()
    if not torch.equal(on_card, R.bits(keys, (cfg.vocab_size,))):
        raise AssertionError("generate: threefry bits on the card differ "
                             "from the CPU's")
    draws = 65536
    tv, tv_bound, support = sampling_tv(dev, cfg.vocab_size, draws=draws)
    row.update(bits_equal_cpu=True, tv_draws=draws, tv_support=support,
               tv_distance=tv, tv_bound=tv_bound)
    if tv > tv_bound:
        emit(row)
        raise AssertionError(f"generate: TV {tv} > bound {tv_bound}")

    # beam search: num_beams=1 is greedy, 4 beams score >= greedy
    bp = prompts[:2, :beam_prompt]
    greedy, _ = model.generate(bp, max_new_tokens=beam_new)
    b1, s1 = model.generate(bp, max_new_tokens=beam_new,
                            decode_strategy="beam_search", num_beams=1)
    (b4, s4), bwall = _timed_call(
        dev, lambda: model.generate(bp, max_new_tokens=beam_new,
                                    decode_strategy="beam_search",
                                    num_beams=4))
    row.update(beam1_is_greedy=bool(torch.equal(b1, greedy)),
               beam4_scores=s4.cpu().tolist(),
               greedy_logprob=s1.cpu().tolist(), beam4_wall_s=bwall)
    if not row["beam1_is_greedy"] or \
            bool((s4 < s1 - 1e-3).any()) or b4.shape != (2, beam_new):
        emit(row)
        raise AssertionError("generate: beam 1 is not greedy, or 4 beams "
                             "score below greedy")
    if dev.type == "cuda":
        row["peak_memory_gib_above_model"] = \
            (torch.cuda.max_memory_allocated(dev) - mem0) / 2 ** 30
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
    n0 = (im.INT8_MATMUL_WGMMA_LAUNCHES, im.INT8_QUANTIZE_LAUNCHES)
    got = net(xb)
    launches = im.INT8_MATMUL_WGMMA_LAUNCHES - n0[0]
    quantize = im.INT8_QUANTIZE_LAUNCHES - n0[1]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        # fc1 quantizes its bf16 x once; fc2 takes fc1's int8 output
        if launches != 2 or quantize != 1:
            raise AssertionError(f"deploy: one forward made {launches} "
                                 "launches of the wgmma int8 matmul and "
                                 f"{quantize} of the quantize pass, not 2 "
                                 "and 1")
    if got.dtype != torch.bfloat16 or got.shape != (batch, d) or \
            not bool(torch.isfinite(got).all()):
        raise AssertionError(f"deploy: output {got.dtype} "
                             f"{tuple(got.shape)}")
    # the plain chain: this script binds the plain version in place of the
    # kernel launch (in this process only; the package has no such switch)
    saved = im._int8_matmul_cuda
    try:
        im._int8_matmul_cuda = \
            lambda *a, wq_kn=None: im._plain_int8_matmul(*a)
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
        ms, host_ms = timed(lambda: net(xb), iters, dev)
    row = {"phase": "deploy", "model": f"Sequential(Linear({d}, {h}), ReLU, "
                                       f"Linear({h}, {d}))",
           "batch": batch, "input_dtype": "bfloat16",
           "output_dtype": "bfloat16",
           "int8_matmul_wgmma_launches": launches,
           "int8_quantize_launches": quantize,
           "int8_intermediate_equal_plain": True,
           "max_abs_err_vs_plain_chain": err,
           "plain_chain_tolerance": {"rtol": 2.0 ** -7,
                                     "atol": INT8_MM_ATOL},
           "plain_chain_tolerance_reason": "both round the same f32 "
                                           "result to bf16: one bf16 ulp",
           "max_rel_err_vs_qat_eval": rel, "qat_tolerance": DEPLOY_QAT_TOL,
           "forward_ms": ms, "forward_host_ms": host_ms,
           "tops": 4.0 * batch * d * h / (ms * 1e-3) / 1e12,
           "int8_rate_share": 4.0 * batch * d * h / PEAK_FLOPS["int8"]
           / (ms * 1e-3)}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# phase 4: GPT.loss gradients through the backward kernels
# ---------------------------------------------------------------------------
# every kernel wrapper of ops.flash_attention -> its plain version
PLAIN_ATTENTION = {"_flash_simt": "_plain_fwd", "_flash_tc": "_plain_fwd",
                   "_bwd_single_tile_mma": "_plain_bwd_single_tile",
                   "_bwd_single_tile_tc": "_plain_bwd_single_tile",
                   "_bwd_dq_mma": "_plain_bwd_dq",
                   "_bwd_dq_tc": "_plain_bwd_dq",
                   "_bwd_dkv_mma": "_plain_bwd_dkv",
                   "_bwd_dkv_tc": "_plain_bwd_dkv"}


@contextlib.contextmanager
def plain_attention():
    """Inside, the flash wrappers' kernel entries are bound to their plain
    versions (in this process only; the package has no such switch)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    saved = {k: getattr(fa, k) for k in PLAIN_ATTENTION}
    try:
        for k, v in PLAIN_ATTENTION.items():
            setattr(fa, k, getattr(fa, v))
        yield
    finally:
        for k, v in saved.items():
            setattr(fa, k, v)


def grad_phase(dev, layers=2, seq=2048, seed=5, dtype="float32"):
    """GPT.loss at gpt3_1_3b width and `layers` deep, one sequence of
    `seq` tokens (2048: 2 x 2 tiles, the dQ + dK/dV pair; 1024: one tile,
    the merged kernel), the model in `dtype` (f32: the SIMT forward and
    the mma.sync backward; bf16: the tensor-core forward and backward
    kernels): every parameter's gradient through the kernels against a
    reference run in which this script binds the plain attention
    functions into the module (in this process only; the package has no
    such switch)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.core import rng as _rng
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig

    cfg = GPTConfig.gpt3_1_3b()
    cfg.num_layers = layers
    _rng.seed(seed)
    model = GPT(cfg, device=dev).to(getattr(torch, dtype))
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
    with plain_attention():
        ref_loss, ref = grads()
    worst, worst_name = 0.0, None
    for n, g in got.items():
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"grad phase: {n} gradient not finite")
        rel = float((g.float() - ref[n].float()).abs().max()) / max(
            float(ref[n].abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, n
    tol = GRAD_TOL if dtype == "float32" else GRAD_BF16_TOL
    row = {"phase": "grad", "config": "gpt3_1_3b", "layers": layers,
           "batch": [1, seq], "dtype": dtype, "loss": loss,
           "reference_loss": ref_loss, "max_rel_grad_err": worst,
           "worst_param": worst_name, "tolerance": tol,
           "tolerance_reason": (
               "max |dg| / max |g| per parameter: the same f32 math in "
               "different reduction orders (TF32 off)" if dtype == "float32"
               else "max |dg| / max |g| per parameter, bf16 model: 8 "
               "significant bits everywhere; the plain attention rounds its "
               "logits to bf16, the kernels keep them in f32")}
    emit(row)
    if worst > tol or abs(loss - ref_loss) > tol * abs(ref_loss):
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

    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig.gpt3_1_3b()
    if layers:
        cfg.num_layers = layers
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    tr, sched = make_trainer(dev, cfg, seed, n_micro)
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
    row["clip_probe"] = clip_probe(dev)
    short = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                         (batch, seq // 2))).to(dev)
    row["short_batch"] = [batch, seq // 2]
    row["short_losses"] = [run(short)[0] for _ in range(short_steps)]
    row["phases"] = train_phases(tr, tokens, cfg, dev, row["mfu"])
    emit(row)
    PHASE_RESULTS["train"] = row
    return row


#: each flash CUDA kernel (a word of its name) and the launch counters
#: (LAUNCH_COUNTERS) of the wrappers that launch it: the mma.sync merged
#: kernel is flash_bwd_dkv_kernel's DQ instantiation
FLASH_KERNEL_NAMES = {
    "flash_fwd_kernel": ("flash",), "flash_fwd_tc_kernel": ("flash_tc",),
    "flash_bwd_single_tc_kernel": ("bwd_single_tc",),
    "flash_bwd_dq_kernel": ("bwd_dq",),
    "flash_bwd_dq_tc_kernel": ("bwd_dq_tc",),
    "flash_bwd_dkv_kernel": ("bwd_dkv", "bwd_single"),
    "flash_bwd_dkv_tc_kernel": ("bwd_dkv_tc",)}


@contextlib.contextmanager
def window_counts():
    """Every device_trace.capture that closes inside: (the capture, the
    launch counts' deltas over its window) in order."""
    from paddle_tpu_torch.profiler import device_trace as dt

    seen = []
    enter, parse = dt.capture.__enter__, dt.capture._parse

    def enter_(self):
        self._counts0 = read_counts()[0]
        return enter(self)

    def parse_(self):
        now = read_counts()[0]
        seen.append((self, {k: now[k] - self._counts0[k] for k in now}))
        parse(self)
        self.lost_launches = [] if self.timeline is None else \
            lost_launches(self.trace_file, self.timeline.t_min_us)

    dt.capture.__enter__, dt.capture._parse = enter_, parse_
    try:
        yield seen
    finally:
        dt.capture.__enter__, dt.capture._parse = enter, parse


def lost_launches(path, t0):
    """The launches (cuda_runtime / cuda_driver events with a correlation
    id) of a trace whose device slice the trace does not hold: (ms after
    the window's start, thread, API name) of each."""
    from paddle_tpu_torch.profiler import device_trace as dt

    evs = dt.load_trace_events(path)["traceEvents"]
    done = {(e.get("args") or {}).get("correlation") for e in evs
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")}
    return [((float(e["ts"]) - t0) / 1e3, e.get("tid"), e.get("name"))
            for e in evs if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and "Launch" in e.get("name", "")
            and (e.get("args") or {}).get("correlation") not in done]


def train_phases(tr, tokens, cfg, dev, phase_mfu):
    """profile_step_phases(tokens, iters=1, trace_window=2) on the train
    phase's trainer: the phases, then a parsed window of 2 steps in which
    every flash kernel slice (forward and the backward kernels the
    autograd thread launches) joins the hybrid.step site and each flash
    launch counter's delta equals its kernel's slices; the ledger's MFU
    (the site's counted FLOPs x 2 over the window's wall) in (0, 1] and
    those FLOPs >= 0.9 x GPTConfig.flops_per_token(S) x tokens;
    memory_ledger() and the device-memory high-water mark."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.profiler import program_stats as ps

    with window_counts() as seen:
        out = tr.profile_step_phases(tokens, iters=1, trace_window=2)
    ((cap, counts),) = seen
    summary = out.pop("trace")
    if summary is not cap.summary:
        raise AssertionError("train window: another capture's summary")
    for k in ("fwd_ms", "bwd_ms", "optim_ms", "step_ms"):
        # a CPU rehearsal's phases are within its timing noise
        if k not in out or (dev.type == "cuda" and not out[k] > 0):
            raise AssertionError(f"train phases: {k} in {out}")
    site = tr._prof_site
    res = {"phases_ms": out, **check_window(summary, site, cap.timeline, dev,
                                            "train window")}
    flops = ps.get(site).flops
    want = 0.9 * cfg.flops_per_token(tokens.shape[1]) * tokens.numel()
    mfu = summary["ledger"]["mfu"]
    res.update(step_site_flops=flops,
               formula_flops_per_step=want / 0.9,
               ledger_mfu=mfu, phase_mfu=phase_mfu,
               memory_ledger=tr.memory_ledger(),
               peak_bytes_in_use=profiler.record_memory_high_water(
                   device=dev),
               window_launches={k: n for k, n in counts.items() if n})
    if flops < want or mfu is None or not 0.0 < mfu <= 1.0:
        raise AssertionError(f"train window: counted FLOPs {flops} < "
                             f"{want} or ledger MFU {mfu}")
    if dev.type == "cuda":
        by_kernel, launched = {}, {}
        for word, keys in FLASH_KERNEL_NAMES.items():
            sl = kernel_slices(cap.timeline, word)
            by_kernel[word] = len(sl)
            launched[word] = sum(counts[k] for k in keys)
            if any(m != site for _, m in sl):
                raise AssertionError(
                    f"train window: {word} slices on the sites "
                    f"{sorted({str(m) for _, m in sl})}, not {site}")
        res.update(flash_slices=by_kernel,
                   launches_lost_by_trace=len(cap.lost_launches),
                   launches_lost_first=cap.lost_launches[:4])
        res["slices_short"] = match_launches(
            "train window", by_kernel, launched, len(cap.lost_launches))
        if not by_kernel["flash_fwd_tc_kernel"] or \
                not by_kernel["flash_bwd_dq_tc_kernel"]:
            raise AssertionError(f"train window: flash slices {by_kernel}")
    return res


def make_trainer(dev, cfg, seed, n_micro=2, lazy=False):
    """(HybridPipelineTrainer, its lr schedule): a GPT of ``cfg`` from
    ``seed`` under the single-chip recipe (amp, recompute, bf16 parameters
    and moments, AdamW 0.1 under the warmup-cosine schedule, global-norm
    clip 1.0); ``lazy``: the GPT built under LazyGuard (an abstract
    trainer, which plans and allocates nothing)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.core import rng as _rng
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.hybrid import HybridPipelineTrainer
    from paddle_tpu_torch.framework.lazy import LazyGuard
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.optimizer import AdamW, lr

    _rng.seed(seed)
    with LazyGuard() if lazy else contextlib.nullcontext():
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
    return tr, sched


def clip_probe(dev, seed=9, numel=(2048 * 2048, 8192 * 2048, 2048, 50304)):
    """The recipe's clips on bf16 gradients at an active scale (norms far
    above the clip), on the card: the port's functional_clip must equal
    (g.float() * scale).to(bf16) bit for bit, one rounding as the
    reference's (g * scale).astype(g.dtype). Also counts the elements the
    in-place g.mul_(scale) with the 0-dim f32 device scale gets wrong on
    the same inputs (it rounds the scale to bf16 first on CUDA)."""
    import torch

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.optimizer.clip import functional_clip

    g = torch.Generator(device=dev).manual_seed(seed)
    grads = [(torch.randn(n, generator=g, device=dev) * 0.3).bfloat16()
             for n in numel]
    out = {"elements": sum(numel)}
    for kind, clip in (("global_norm", nn.ClipGradByGlobalNorm(1.0)),
                       ("by_norm", nn.ClipGradByNorm(1.0))):
        if kind == "global_norm":
            gn = torch.sqrt(sum(x.float().square().sum() for x in grads))
            scales = [torch.clamp(1.0 / torch.clamp(gn, min=1e-12), max=1.0)
                      ] * len(grads)
        else:
            scales = [torch.clamp(1.0 / torch.clamp(
                torch.linalg.vector_norm(x.float()), min=1e-12), max=1.0)
                for x in grads]
        got = functional_clip(clip, [x.clone() for x in grads])
        want = [(x.float() * sc).to(torch.bfloat16)
                for x, sc in zip(grads, scales)]
        old = [x.clone().mul_(sc) for x, sc in zip(grads, scales)]
        bits = lambda t: t.view(torch.int16)   # noqa: E731
        wrong = sum(int((bits(a) != bits(b)).sum())
                    for a, b in zip(got, want))
        old_wrong = sum(int((bits(a) != bits(b)).sum())
                        for a, b in zip(old, want))
        out[kind] = {"scale_max": max(float(sc) for sc in scales),
                     "elements_off_single_rounding": wrong,
                     "old_mul_elements_off_single_rounding": old_wrong}
        if wrong:
            raise AssertionError(f"clip probe {kind}: {wrong} bf16 elements "
                                 "differ from one rounding of g * scale")
    return out


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
# phase 10: observability (the event timeline, the sink, the device trace)
# ---------------------------------------------------------------------------
#: a request's four breakdown buckets sum to its total_ms within this
#: (the reference's own tolerance: the buckets are rounded to 1 us each)
BUCKET_SUM_TOL_MS = 1.5
BUCKETS = ("queue_wait_ms", "prefill_ms", "decode_ms", "preempted_ms")


def engine_events(eng, seq0):
    """{rid: the events ``eng`` emitted since sequence number seq0}: an
    engine's own, by its ``eng`` id (never by position in the log, which
    other engines share)."""
    from paddle_tpu_torch.profiler import events as pev

    out = {}
    for e in pev.log().events(since_seq=seq0):
        if e.rid is not None and e.attrs.get("eng") == eng._eng_id:
            out.setdefault(e.rid, []).append(e)
    return out


def check_timelines(evs, n_req, what):
    """Per request: submit <= admit <= first_token <= finish, a complete
    breakdown whose four buckets sum to total_ms within
    BUCKET_SUM_TOL_MS. Returns the breakdowns in rid order."""
    from paddle_tpu_torch.profiler.events import breakdown_from_events

    if len(evs) != n_req:
        raise AssertionError(f"{what}: events of {len(evs)} requests, "
                             f"want {n_req}")
    rows = []
    for rid, es in sorted(evs.items()):
        first = {}
        for e in es:
            first.setdefault(e.kind, e.t_ns)
        order = [first.get(k) for k in ("submit", "admit", "first_token",
                                         "finish")]
        if None in order or order != sorted(order):
            raise AssertionError(f"{what}: request {rid} out of order: "
                                 f"{[e.kind for e in es]}")
        b = breakdown_from_events(es)
        gap = abs(sum(b[k] for k in BUCKETS) - b.get("total_ms", -1e9))
        if not b["complete"] or gap > BUCKET_SUM_TOL_MS:
            raise AssertionError(f"{what}: request {rid} breakdown {b}")
        rows.append(b)
    return rows


def bucket_sums(rows):
    return {k: sum(r[k] for r in rows) for k in BUCKETS}


def check_spec_timelines(evs, n_req):
    """The spec engine's events of one run: per request draft < verify <
    accept (first occurrences), accepted <= drafted on every accept, and
    the breakdown's spec_drafted >= spec_accepted; the plain timeline
    checks too."""
    rows = check_timelines(evs, n_req, "spec")
    accepts = 0
    for rid, es in evs.items():
        kinds = [e.kind for e in es]
        if not all(k in kinds for k in ("draft", "verify", "accept")) or \
                not kinds.index("draft") < kinds.index("verify") \
                < kinds.index("accept"):
            raise AssertionError(f"spec: request {rid} events {kinds}")
        for e in es:
            if e.kind == "accept":
                accepts += 1
                if not 0 <= e.attrs["accepted"] <= e.attrs["drafted"]:
                    raise AssertionError(f"spec: accept {e.to_dict()}")
    for b in rows:
        if not b.get("spec_drafted", 0) >= b.get("spec_accepted", 0) > 0:
            raise AssertionError(f"spec: breakdown {b}")
    return {"requests": len(rows), "accept_events": accepts,
            "spec_drafted": sum(b["spec_drafted"] for b in rows),
            "spec_accepted": sum(b["spec_accepted"] for b in rows),
            "bucket_sums_ms": bucket_sums(rows)}


def observed_run(model, dev, prompts, max_new, engine_kw):
    """One run of a fresh engine: (its streams, wall seconds, its events
    by rid, the engine)."""
    from paddle_tpu_torch.profiler import events as pev
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    eng = ServingEngine(model, ServingConfig(**engine_kw))
    seq0 = pev.log().next_seq

    def serve():
        rids = [eng.submit(p, max_new) for p in prompts]
        out = eng.run()
        return [out[r] for r in rids]

    streams, wall = _timed_call(dev, serve)
    for r in streams:
        if r.shape != (max_new,):
            raise AssertionError(f"observe: a stream of {r.shape} tokens")
    return streams, wall, engine_events(eng, seq0), eng


def observe_trace_window(model, dev, prompts, max_new, engine_kw):
    """``engine_trace_window`` of 4 ticks under the active sink; then
    ``dump_flight``, whose document must carry the window's summary."""
    from paddle_tpu_torch.profiler import events as pev

    out, cap = engine_trace_window(model, dev, prompts, max_new, engine_kw,
                                   ticks=4)
    path = pev.dump_flight("observe-trace")
    flight = json.load(open(path))
    if flight["trace_summary"] != json.loads(json.dumps(cap.summary)):
        raise AssertionError("observe: the flight dump does not carry the "
                             "window's summary")
    return {"steps": out["steps"], "busy_frac": out["busy_frac"],
            "device_busy_ms": out["device_busy_ms"],
            "unattributed_share": out["unattributed_share"],
            "flight_dump": os.path.basename(path)}


def observe_phase(model, dev, engine_kw, card=None, n_req=16, max_new=32,
                  preempt_pages=129, trace_req=3, trace_new=8,
                  train_cfg=None, train_batch=(2, 2048),
                  turns=("on", "off", "off", "on")):
    """The profiler on the engine phase's workload: the event timeline of
    16 requests with a metrics sink (per-request order and breakdowns,
    latency_stats, the dispatch sites), an oversubscribed pool of
    ``preempt_pages`` pages that preempts, the sink's files through
    tools/check_sink_schema.py, a torch.profiler trace of a short engine
    run and one trainer step of ``train_cfg`` (gpt3_1_3b) written by
    profiler.enable(trace_dir=...), and warm tokens/s with the event log
    on and off in ``turns``."""
    import json as _json
    import shutil
    import tempfile

    import numpy as np
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.profiler import events as pev
    from paddle_tpu_torch.profiler import recompile as prec
    from paddle_tpu_torch.profiler import sink as psink
    from paddle_tpu_torch.profiler import trace as ptrace

    t_phase = time.perf_counter()
    cfg = model.config
    prompts = engine_prompts(cfg, n_req)
    row = {"phase": "observe", "config": "gpt3_1_3b", "card": card,
           "requests": n_req, "max_new_tokens": max_new}
    tmp = tempfile.mkdtemp(prefix="observe-")
    sink_dir = os.path.join(tmp, "sink")
    try:
        # (1) the plain engine's timeline, with a sink. latency_stats reads
        # the whole ring, so the ring starts empty: the sink first drains
        # the earlier phases' events, as profiler.reset() does, so none
        # reads as lost
        psink.enable_sink(sink_dir, interval_s=2.0)
        psink.flush_active("reset")
        pev.log().clear()
        _, wall, evs, eng = observed_run(model, dev, prompts, max_new,
                                         engine_kw)
        rows = check_timelines(evs, n_req, "engine")
        stats = eng.latency_stats()
        counts = prec.trace_counts()
        row["engine"] = {
            "wall_s": wall, "tokens_per_s": n_req * max_new / wall,
            "latency_stats": stats, "bucket_sums_ms": bucket_sums(rows),
            "events": sum(len(es) for es in evs.values()),
            "compiled_sites": {s: counts.get(s, 0)
                               for s in eng.compiled_sites}}
        if stats["requests"] != n_req:
            raise AssertionError(f"latency_stats over {stats['requests']} "
                                 f"requests, want {n_req}")
        # (2) an oversubscribed pool: preemption, requeue, re-admission
        pkw = dict(engine_kw, num_pages=preempt_pages)
        _, wall, evs, eng = observed_run(model, dev, prompts, max_new, pkw)
        rows = check_timelines(evs, n_req, "preempt")
        kinds = {rid: [e.kind for e in es] for rid, es in evs.items()}
        for rid, ks in kinds.items():
            for i, k in enumerate(ks):
                if k == "preempt" and not (
                        ks[i + 1:i + 2] == ["requeue"]
                        and "admit" in ks[i + 2:]):
                    raise AssertionError(f"preempt: request {rid} {ks}")
        preempts = sum(ks.count("preempt") for ks in kinds.values())
        if not preempts or not any(b["preempted_ms"] > 0 for b in rows):
            raise AssertionError(f"preempt: {preempts} preemptions, no "
                                 "preempted time")
        row["preempt"] = {
            "num_pages": preempt_pages, "wall_s": wall,
            "preemptions": preempts,
            "preempted_requests": sum(b["preempts"] > 0 for b in rows),
            "bucket_sums_ms": bucket_sums(rows)}
        # (3) a parsed device-trace window with the sink active: the sink
        # writes its trace_summary.json, and a flight dump taken after it
        # carries the same summary
        row["trace_window"] = observe_trace_window(
            model, dev, prompts[:trace_req], trace_new, engine_kw)
        # (4) the sink's files: closed, then the repo's schema checker,
        # which must find the window's summary
        psink.disable_sink()
        chk = subprocess.run(
            [sys.executable, os.path.join(HERE, "tools",
                                          "check_sink_schema.py"),
             sink_dir, "--require-trace"], capture_output=True, text=True,
            timeout=120)
        lines = [_json.loads(x) for x in
                 open(os.path.join(sink_dir, "metrics.jsonl"))]
        row["sink"] = {
            "schema_rc": chk.returncode,
            "schema_out": chk.stdout.strip().splitlines()[-1:],
            "bytes": {f: os.path.getsize(os.path.join(sink_dir, f))
                      for f in sorted(os.listdir(sink_dir))
                      if os.path.isfile(os.path.join(sink_dir, f))},
            "flushes": len(lines),
            "events_lost": sum(x["events_lost"] for x in lines)}
        if chk.returncode != 0:
            emit(row)
            raise AssertionError(f"sink schema: {chk.stdout[-2000:]}")
        # (5) a torch.profiler trace of a short engine run and one
        # trainer step; enable(reset=False) keeps the registry, which the
        # other phases read as deltas
        if train_cfg is None:
            from paddle_tpu_torch.models.gpt import GPTConfig

            train_cfg = GPTConfig.gpt3_1_3b()
        tr, _ = make_trainer(dev, train_cfg, seed=6)
        rng = np.random.RandomState(6)
        toks = torch.from_numpy(rng.randint(
            0, train_cfg.vocab_size, train_batch)).to(dev)
        float(tr.step(toks))                 # warm: allocations, autotune
        trace_dir = os.path.join(tmp, "trace")
        profiler.enable(trace_dir=trace_dir, reset=False)
        try:
            observed_run(model, dev, prompts[:trace_req], trace_new,
                         engine_kw)
            loss = float(tr.step(toks))
        finally:
            summ = profiler.disable()
        del tr
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        doc = _json.load(open(ptrace.trace_file()))
        names = {e.get("name", "") for e in doc["traceEvents"]}
        kernels = [e.get("name", "") for e in doc["traceEvents"]
                   if e.get("cat") == "kernel"]
        host = os.path.join(trace_dir, "host_spans.json")
        profiler.export_chrome_trace(host)
        host_names = {e["name"] for e in
                      _json.load(open(host))["traceEvents"]}
        row["trace"] = {
            "file_bytes": os.path.getsize(ptrace.trace_file()),
            "events": len(doc["traceEvents"]),
            "kernel_events": len(kernels),
            "ragged_kernel_events": sum("ragged_kernel" in k
                                        for k in kernels),
            "flash_kernel_events": sum("flash" in k for k in kernels),
            "train_loss": loss,
            "scopes": summ["scopes"],
            "host_span_names": sorted(host_names)}
        want = {"hybrid/step", "hybrid/step/sync_wait", "fwd/blocks"}
        # the CPU (a rehearsal) launches no kernel
        no_kernels = dev.type == "cuda" and not (
            row["trace"]["ragged_kernel_events"]
            and row["trace"]["flash_kernel_events"])
        if not np.isfinite(loss) or not want <= names or no_kernels or \
                not {"hybrid/step", "hybrid/step/sync_wait"} <= host_names:
            emit(row)
            raise AssertionError(f"trace: missing {sorted(want - names)} "
                                 "or the ragged/flash kernel events")
        # (6) warm tokens/s with the event log on and off, in turns. An
        # on-turn's bucket sums show where its time went; every turn has
        # the registry's TTFT and TPOT sums (kept with the log off too),
        # its ticks, and the process's CPU seconds (all threads): a turn
        # whose wall grows and CPU time does not waited on the card or for
        # a core
        reg = profiler.registry()

        def hist_sums():
            return [reg.histogram(n).snapshot().get("sum") or 0.0
                    for n in ("serving/ttft_ms", "serving/tpot_ms")]

        runs = []
        try:
            for t in turns:
                pev.set_enabled(t == "on")
                h0, k0 = hist_sums(), reg.counter("serving/ticks").value
                c0 = time.process_time()
                _, wall, evs, _ = observed_run(model, dev, prompts, max_new,
                                               engine_kw)
                h1 = hist_sums()
                r = {"events": t, "wall_s": wall,
                     "tokens_per_s": n_req * max_new / wall,
                     "cpu_s": time.process_time() - c0,
                     "ticks": int(reg.counter("serving/ticks").value - k0),
                     "ttft_sum_ms": h1[0] - h0[0],
                     "tpot_mean_ms": (h1[1] - h0[1]) / n_req}
                if t == "on":
                    r["bucket_sums_ms"] = bucket_sums(
                        check_timelines(evs, n_req, "turn"))
                elif evs:
                    raise AssertionError("events emitted while disabled")
                runs.append(r)
        finally:
            pev.set_enabled(True)
        row["log_cost"] = {"turns": runs}
        for t in ("on", "off"):
            rates = [r["tokens_per_s"] for r in runs if r["events"] == t]
            row["log_cost"][f"median_tokens_per_s_events_{t}"] = float(
                np.median(rates))
    finally:
        psink.disable_sink()
        shutil.rmtree(tmp, ignore_errors=True)
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    return row


# ---------------------------------------------------------------------------
# phase 11: the legacy two-dispatch engine, the KV handoff, chain migration
# ---------------------------------------------------------------------------
def _free_memory(dev) -> None:
    """Give the card back the memory of engines the caller dropped (two
    f32 pools of the engine's size are about 13 GB each)."""
    import gc

    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _serve_counted(model, dev, prompts, max_new, engine_kw):
    """One run on a fresh engine: (streams, wall s, {ticks, prefill
    dispatches, process CPU s}, the engine's sites and their shape
    counts). The engine is dropped before returning."""
    from paddle_tpu_torch.profiler import recompile, registry
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    reg = registry()
    names = ("ticks", "prefill_chunks")
    c0 = {n: reg.counter("serving/" + n).value for n in names}
    eng = ServingEngine(model, ServingConfig(**engine_kw))
    cpu0 = time.process_time()

    def serve():
        rids = [eng.submit(p, max_new) for p in prompts]
        out = eng.run()
        return [out[r] for r in rids]

    streams, wall = _timed_call(dev, serve)
    cnt = {n: int(reg.counter("serving/" + n).value - c0[n]) for n in names}
    cnt["cpu_s"] = time.process_time() - cpu0
    for r in streams:
        if r.shape != (max_new,):
            raise AssertionError(f"a stream of {r.shape} tokens")
    bad = eng.pool.check_consistency()
    if bad:
        raise AssertionError(f"page audit: {bad[:4]}")
    sites = list(eng.compiled_sites)
    shapes = [recompile.trace_counts().get(s) for s in sites]
    del eng
    _free_memory(dev)
    return streams, wall, cnt, (sites, shapes)


def legacy_phase(model, dev, engine_kw, n_req=16, max_new=32, n_check=4,
                 turns=("unified", "legacy", "legacy", "unified")):
    """The legacy engine on the engine phase's workload. Its one counted
    run must finish every request, launch exactly num_layers decode-row
    kernels a tick and num_layers chunk-row kernels at T = prefill_chunk a
    prefill dispatch (and no other chunk rows), and run its two sites at
    one shape each. Uncounted: teacher-forced argmax over n_check streams
    (>= 0.9), the unified engine's streams (>= SPEC_MATCH_FLOOR), and warm
    tokens/s in turns, each turn's wall, ticks and process CPU seconds;
    then one run of each engine under torch.profiler, whose kernel ms over
    a turn's wall is that turn's busy share (a profiled run of this
    workload takes tens of seconds to read back; the two kinds' kernel ms
    moved by about 1% between runs on the card)."""
    import numpy as np

    from paddle_tpu_torch.ops import paged_attention as pa

    t_phase = time.perf_counter()
    cfg = model.config
    L = cfg.num_layers
    w = engine_kw["prefill_chunk"]
    prompts = engine_prompts(cfg, n_req)
    kws = {"unified": engine_kw,
           "legacy": dict(engine_kw, attention_kernel="legacy")}
    counts0, by0 = read_counts()
    r0, c0 = counts0["ragged"], counts0["ragged_chunk"]
    streams, wall, cnt, (sites, shapes) = _serve_counted(
        model, dev, prompts, max_new, kws["legacy"])
    counts, by_t = read_counts()
    chunk_l = counts["ragged_chunk"] - c0
    decode_l = counts["ragged"] - r0 - chunk_l
    by_t = {t: n - by0.get(t, 0) for t, n in by_t.items()
            if n != by0.get(t, 0)}
    row = {"phase": "legacy", "config": "gpt3_1_3b", "requests": n_req,
           "max_new_tokens": max_new, "wall_s": wall,
           "tokens_per_s": n_req * max_new / wall, "ticks": cnt["ticks"],
           "prefill_dispatches": cnt["prefill_chunks"],
           "decode_row_launches": decode_l,
           "chunk_row_launches_by_t": by_t,
           "sites": [s.rsplit("#", 1)[0] for s in sites],
           "site_shapes": shapes}
    fails = []
    if decode_l != L * cnt["ticks"] or cnt["ticks"] == 0:
        fails.append(f"decode-row launches {decode_l} != {L} x "
                     f"{cnt['ticks']} ticks")
    if by_t != {w: L * cnt["prefill_chunks"]} or cnt["prefill_chunks"] == 0:
        fails.append(f"chunk-row launches by T {by_t} != {{{w}: {L} x "
                     f"{cnt['prefill_chunks']} prefill dispatches}}")
    if len(sites) != 2 or shapes != [1, 1]:
        fails.append(f"sites {sites} ran {shapes} shapes")
    if fails:
        emit(row)
        raise AssertionError(f"legacy: {fails}")
    with uncounted():
        row["teacher_forced_match"] = teacher_match(model, dev, prompts,
                                                    streams, n_check)
        runs, unified = [], None
        for kind in turns:
            st, wl, c, _ = _serve_counted(model, dev, prompts, max_new,
                                          kws[kind])
            if kind == "unified" and unified is None:
                unified = st
            runs.append({"engine": kind, "wall_s": wl,
                         "tokens_per_s": n_req * max_new / wl,
                         "ticks": c["ticks"],
                         "prefill_dispatches": c["prefill_chunks"],
                         "cpu_s": c["cpu_s"]})
        kern_ms = {}
        for kind, kw in kws.items():
            _, kernels = profile_kernels(dev, lambda kw=kw: (
                _serve_counted(model, dev, prompts, max_new, kw)[0]))
            kern_ms[kind] = (sum(e.self_device_time_total for e in kernels)
                             / 1e3 if kernels else None)
        for r in runs:
            k = kern_ms[r["engine"]]
            r["busy_share"] = None if k is None else k / 1e3 / r["wall_s"]
    row["kernel_ms"] = kern_ms
    row["match_vs_unified"] = match_rate(streams, unified)
    row["turns"] = runs
    for kind in kws:
        row[f"median_tokens_per_s_{kind}"] = float(np.median(
            [r["tokens_per_s"] for r in runs if r["engine"] == kind]))
    row["legacy_over_unified"] = (row["median_tokens_per_s_legacy"]
                                  / row["median_tokens_per_s_unified"])
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    if row["teacher_forced_match"] < 0.9:
        raise AssertionError(f"legacy: teacher-forced match "
                             f"{row['teacher_forced_match']} < 0.9")
    if row["match_vs_unified"] < SPEC_MATCH_FLOOR:
        raise AssertionError(f"legacy: match vs the unified engine "
                             f"{row['match_vs_unified']} < "
                             f"{SPEC_MATCH_FLOOR}")
    return row


def _same_pages(pool, pages, pl, names=("k", "v", "k_scale", "v_scale")):
    """The pool's content (and scales) at ``pages`` equals the payload's,
    bit for bit (bf16 pages compared as their 16-bit patterns)."""
    import numpy as np
    import torch

    for name in names:
        if name not in pl:
            continue
        got = getattr(pool, name).index_select(1, pages).cpu()
        want = np.ascontiguousarray(pl[name])
        if got.dtype == torch.bfloat16:
            got, want = got.view(torch.int16), want.view(np.int16)
        if not torch.equal(got, torch.from_numpy(want)):
            return False
    return True


def handoff_run(model, dev, engine_kw, prompts, max_new):
    """A prefill engine holds every prompt (``hold_after_prefill``),
    exports each held-ready one and releases it; a decode engine admits
    each payload as it comes (retrying on None) and decodes. Right after
    each admit the imported pages (and an int8 pool's scales) read back
    equal to the payload's; on int8 pools the full pages' scales still do
    after the decode engine's next tick. Returns the streams in prompt
    order and the numbers of the run."""
    import numpy as np
    import torch

    from paddle_tpu_torch.profiler import events as pev
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    seq0 = pev.log().next_seq
    pe = ServingEngine(model, ServingConfig(**engine_kw))
    de = ServingEngine(model, ServingConfig(**engine_kw))
    ps = pe.pool.page_size
    index = {pe.submit(p, max_new, hold_after_prefill=True): i
             for i, p in enumerate(prompts)}
    local, pending, after_tick = {}, [], []
    checks = {"readback": 0, "scales_after_tick": 0}
    t0 = time.perf_counter()
    while True:
        if not pe.idle():
            pe.step()
            pe.drain(0)
        for rid in pe.held_ready():
            pl = pe.export_held(rid)
            pe.release_exported(rid)
            pending.append((index[rid], pl))
        waiting = []
        for i, pl in pending:
            lr = de.admit_prefilled(pl)
            if lr is None:
                waiting.append((i, pl))
                continue
            local[lr] = i
            pages = torch.as_tensor(de.pool._held[de._slot_rid.index(lr)],
                                    device=dev)
            if not _same_pages(de.pool, pages, pl):
                raise AssertionError(f"handoff: request {i}'s imported "
                                     "pages differ from its payload")
            checks["readback"] += 1
            if de.pool.quantized:
                n_full = int(pl["n_tokens"]) // ps
                after_tick.append((pages[:n_full], {
                    k: pl[k][:, :n_full] for k in ("k_scale", "v_scale")}))
        pending = waiting
        ticked = de.step()
        for pages, sc in after_tick:
            if not _same_pages(de.pool, pages, sc):
                raise AssertionError("handoff: imported int8 scales were "
                                     "reset by the decode engine's tick")
            checks["scales_after_tick"] += 1
        after_tick = []
        if not ticked and de._inflight:
            de.drain(0)
        if pe.idle() and not pending and de.idle() and \
                len(local) == len(prompts):
            break
    wall = time.perf_counter() - t0
    streams = [None] * len(prompts)
    for lr, i in local.items():
        streams[i] = np.asarray(de._requests[lr].out, np.int32)
        if streams[i].shape != (max_new,):
            raise AssertionError(f"handoff: request {i} gave "
                                 f"{streams[i].shape} tokens")
    audits = (pe.pool.check_consistency(), de.pool.check_consistency())
    if audits != ([], []):
        raise AssertionError(f"handoff: page audits {audits}")
    if pe.pool.prefix is None or len(pe.pool.prefix) == 0:
        raise AssertionError("handoff: the prefill engine indexed nothing")
    evs = pev.log().events(since_seq=seq0)
    outs = [e.attrs for e in evs if e.kind == "handoff_out"
            and e.attrs.get("eng") == pe._eng_id]
    ins = [e.attrs for e in evs if e.kind == "handoff_in"
           and e.attrs.get("eng") == de._eng_id]
    del pe, de
    _free_memory(dev)

    def side(es):
        b = sum(e["bytes"] for e in es)
        ms = sum(e["ms"] for e in es)
        return {"handoffs": len(es), "bytes": b,
                "bytes_each": [e["bytes"] for e in es],
                "ms_each": [e["ms"] for e in es],
                "gb_per_s": b / ms / 1e6 if ms else None}

    return streams, {"wall_s": wall, "export": side(outs),
                     "import": side(ins), "checks": checks}


def handoff_phase(model, dev, engine_kw, n_req=16, max_new=32, n_check=4,
                  n_handoff=8, n_int8=4, prefix=512):
    """The KV handoff at f32 (n_handoff requests of the engine phase's
    workload) and int8 (n_int8, twice), then chain migration of the
    workload's shared prefix between two engines. The comparisons (single
    engines, teacher-forced forwards) run uncounted."""
    from paddle_tpu_torch.profiler import events as pev
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    t_phase = time.perf_counter()
    cfg = model.config
    prompts = engine_prompts(cfg, n_req)
    row = {"phase": "handoff", "config": "gpt3_1_3b"}
    # (1) f32
    sub = prompts[:n_handoff]
    streams, f32 = handoff_run(model, dev, engine_kw, sub, max_new)
    with uncounted():
        single = _serve_counted(model, dev, sub, max_new, engine_kw)[0]
        f32["teacher_forced_match"] = teacher_match(model, dev, sub,
                                                    streams, n_check)
    f32["match_vs_single"] = match_rate(streams, single)
    row["f32"] = f32
    # (2) int8, twice
    kw8 = dict(engine_kw, kv_dtype="int8")
    sub8 = prompts[:n_int8]
    s8a, i8 = handoff_run(model, dev, kw8, sub8, max_new)
    s8b, i8b = handoff_run(model, dev, kw8, sub8, max_new)
    with uncounted():
        single8 = _serve_counted(model, dev, sub8, max_new, kw8)[0]
    i8["two_runs_equal"] = all((a == b).all() for a, b in zip(s8a, s8b))
    i8["match_vs_single_int8"] = match_rate(s8a, single8)
    i8["checks_second_run"] = i8b["checks"]
    row["int8"] = i8
    # (3) chain migration: A serves the shared-prefix requests and exports
    # the prefix's chain; a fresh B imports it and serves one of them
    shared = [p for i, p in enumerate(prompts) if i % 2 == 0]
    pre = shared[0][:prefix]
    a = ServingEngine(model, ServingConfig(**engine_kw))
    rids = [a.submit(p, max_new) for p in shared]
    out_a = a.run()[rids[0]]
    t0 = time.perf_counter()
    payload = a.export_prefix_chain(pre)
    export_ms = (time.perf_counter() - t0) * 1e3
    del a
    _free_memory(dev)
    ps = engine_kw["page_size"]
    chain = {"pages": None if payload is None else int(payload["k"].shape[1]),
             "export_ms": export_ms}
    if payload is None or chain["pages"] != prefix // ps or \
            payload["n_tokens"] != prefix:
        raise AssertionError(f"chain: exported {chain['pages']} pages, "
                             f"want {prefix // ps}")
    nbytes = payload["k"].nbytes + payload["v"].nbytes
    b = ServingEngine(model, ServingConfig(**engine_kw))
    reg = registry()
    rem0 = reg.counter("serving/prefix_hit_tokens_remote").value
    t0 = time.perf_counter()
    chain["imported_tokens"] = b.import_prefix_chain(payload)
    chain["import_ms"] = (time.perf_counter() - t0) * 1e3
    chain["bytes"] = nbytes
    chain["export_gb_per_s"] = nbytes / chain["export_ms"] / 1e6
    chain["import_gb_per_s"] = nbytes / chain["import_ms"] / 1e6
    seq0 = pev.log().next_seq
    rid = b.submit(shared[0], max_new)
    out_b = b.run()[rid]
    hits = [e.attrs for e in pev.log().events(since_seq=seq0)
            if e.kind == "prefix_hit" and e.attrs.get("eng") == b._eng_id]
    chain["remote_tokens"] = [h["remote_tokens"] for h in hits]
    chain["remote_counter"] = int(
        reg.counter("serving/prefix_hit_tokens_remote").value - rem0)
    chain["match_vs_origin"] = match_rate([out_b], [out_a])
    chain["audit"] = b.pool.check_consistency()
    del b
    _free_memory(dev)
    row["chain"] = chain
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    fails = []
    if f32["teacher_forced_match"] < 0.9:
        fails.append(f"f32 teacher-forced {f32['teacher_forced_match']}")
    if f32["match_vs_single"] < SPEC_MATCH_FLOOR:
        fails.append(f"f32 match vs single {f32['match_vs_single']}")
    if f32["checks"]["readback"] != n_handoff:
        fails.append(f"f32 readbacks {f32['checks']}")
    if not i8["two_runs_equal"]:
        fails.append("int8: two runs differ")
    if i8["match_vs_single_int8"] < KVINT8_MATCH_FLOOR:
        fails.append(f"int8 match vs single {i8['match_vs_single_int8']}")
    if i8["checks"]["readback"] != n_int8 or \
            i8["checks"]["scales_after_tick"] != n_int8:
        fails.append(f"int8 checks {i8['checks']}")
    if chain["imported_tokens"] != prefix:
        fails.append(f"chain imported {chain['imported_tokens']}")
    if chain["remote_tokens"] != [prefix] or \
            chain["remote_counter"] != prefix:
        fails.append(f"chain remote hit {chain['remote_tokens']} / "
                     f"{chain['remote_counter']}")
    if chain["match_vs_origin"] < SPEC_MATCH_FLOOR:
        fails.append(f"chain match vs origin {chain['match_vs_origin']}")
    if chain["audit"]:
        fails.append(f"chain audit {chain['audit'][:4]}")
    if fails:
        raise AssertionError(f"handoff: {fails}")
    return row


# ---------------------------------------------------------------------------
# disagg phase: the multi-process serving mesh, two ranks on one card
# ---------------------------------------------------------------------------
#: run A's injected wall-clock skew on rank 1 (s): large beside the sync's
#: uncertainty on one host, small beside the run
DISAGG_SKEW = 0.4
#: the board's lease (s); a member is declared dead after two
DISAGG_LEASE_S = 3.0
#: a handed-off TTFT's clock uncertainty must stay below this (ms)
DISAGG_TTFT_UNC_MS = 200.0
#: (run, layout, requests: None for the whole workload), served in turn by
#: one pair of processes (one state load): A prefill rank 1 + decode rank
#: 0, B symmetric, C A's layout with rank 1 killed between its first
#: payload and its rename (so C comes last)
DISAGG_RUNS = (("A", "disagg", None), ("B", "symmetric", 8),
               ("C", "chaos", 8))
#: the script each rank runs (``--disagg-worker DIR RUNS``)
DISAGG_WORKER_SCRIPT = os.path.join(HERE, "chip_smoke.py")


def _state_checksum(model) -> str:
    """A digest of every parameter's bytes (sha1 over the state in name
    order, read back to the host): equal on ranks that serve one model."""
    import hashlib

    h = hashlib.sha1()
    for name, t in sorted(model.state_dict().items()):
        h.update(name.encode())
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _drive_until(srv, pred, deadline_s, what):
    deadline = time.monotonic() + deadline_s
    while not pred():
        if not srv.step():
            time.sleep(0.002)
        if time.monotonic() > deadline:
            raise AssertionError(
                f"disagg rank {srv.mesh.rank}: {what} timed out: served "
                f"{sorted(srv.results())}, members {sorted(srv.members)}")


def disagg_worker(out_dir, runs) -> int:
    """One rank of one or more disagg runs (``--disagg-worker DIR RUNS``,
    RUNS comma-separated, started by ``distributed.mp_mesh``): load the
    parent's model state once, then serve each run's workload in turn
    (``_disagg_serve``), and end with the launcher's marker."""
    import numpy as np
    import torch

    from paddle_tpu_torch.distributed import mp_mesh
    from paddle_tpu_torch.distributed.env import ParallelEnv
    from paddle_tpu_torch.models.gpt import (GPT, GPTConfig,
                                             load_reference_state)
    from paddle_tpu_torch.profiler.sink import _detect_rank

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    rank, world = mp_mesh.init()
    dev = ParallelEnv().device
    assert world == 2 and str(dev) == spec["device"], (world, dev)
    assert torch.distributed.get_backend() == "gloo"
    assert _detect_rank() == rank
    t0 = time.perf_counter()
    model = GPT(GPTConfig(**spec["config"]), device=dev)
    with np.load(spec["state"]) as z:
        load_reference_state(model, {k: z[k] for k in z.files})
    model.eval()
    base = {"rank": rank, "device": str(dev),
            "load_s": time.perf_counter() - t0,
            "state_checksum": _state_checksum(model)}
    with np.load(spec["prompts"]) as z:
        prompts = [z[f"p{i}"] for i in range(len(z.files))]
    for name in runs.split(","):
        run = spec["runs"][name]
        _disagg_serve(model, dev, spec, os.path.join(out_dir, name),
                      run["layout"], prompts[:run["n_req"]], dict(base))
        _free_memory(dev)
    mp_mesh.finish(os.path.join(out_dir, f"ok.{rank}"))
    return 0


def _time_handoff_legs(srv) -> dict:
    """Time every leg of a handed-off request's TTFT on this rank: wrap
    its engine's ``step``, ``export_held`` and ``admit_prefilled`` and its
    channel's ``send`` and ``poll`` (attributes of these instances, for
    the phase's measurement only). Wall stamps are ``srv._walltime()``,
    the clock the offset-corrected TTFT uses; ``_ttft_legs`` joins the two
    ranks' stamps."""
    eng, ch = srv.engine, srv.channel
    legs = {"out": {}, "in": {}, "poll_s": 0.0, "polls": 0,
            "tick_ms": []}
    perf_to_wall = srv._walltime() - time.perf_counter()
    step, export_held, admit = eng.step, eng.export_held, \
        eng.admit_prefilled
    send, poll = ch.send, ch.poll

    def _step():
        t = time.perf_counter()
        out = step()
        legs["tick_ms"].append((time.perf_counter() - t) * 1e3)
        return out

    def _export(rid):
        gid, er = srv._local[rid], eng._requests[rid]
        t = srv._walltime()
        payload = export_held(rid)
        legs["out"][gid] = {
            "submit_w": srv._reqs[gid].submit_w,
            "engine_submit_w": er.submit_t + perf_to_wall,
            "first_token_w": er.first_token_t + perf_to_wall,
            "export_w": t, "exported_w": srv._walltime()}
        return payload

    def _send(dst, gid, payload, kind="h"):
        t = srv._walltime()
        n = send(dst, gid, payload, kind=kind)
        if kind == "h" and gid in legs["out"]:
            legs["out"][gid].update(send_w=t, sent_w=srv._walltime())
        return n

    def _poll(kind="h"):
        t = time.perf_counter()
        got = poll(kind=kind)
        legs["poll_s"] += time.perf_counter() - t
        legs["polls"] += 1
        return got

    def _admit(payload):
        gid = int(json.loads(str(payload["trace_ctx"]))["gid"])
        t = srv._walltime()
        lr = admit(payload)
        leg = legs["in"].setdefault(gid, {"first_try_w": t})
        if lr is not None:
            leg.update(admit_w=t, admitted_w=srv._walltime())
        return lr

    eng.step, eng.export_held, eng.admit_prefilled = _step, _export, _admit
    ch.send, ch.poll = _send, _poll
    return legs


def _disagg_serve(model, dev, spec, run_dir, layout, prompts, res):
    """One rank's part of one run: serve ``prompts`` through
    ``DisaggServer`` with every launch count set to 0 just before and read
    just after, and write ``run_dir/results.<rank>.json`` and the rank's
    sink under ``run_dir/sink``."""
    import paddle_tpu_torch.profiler as profiler
    from paddle_tpu_torch.distributed import mp_mesh
    from paddle_tpu_torch.profiler import events as pev
    from paddle_tpu_torch.profiler.metrics import registry
    from paddle_tpu_torch.serving import (DisaggServer, HandoffChannel,
                                          MeshSpec, ServingConfig)

    rank = res["rank"]
    res["layout"] = layout
    profiler.enable_sink(os.path.join(run_dir, "sink"), interval_s=0.5)
    if layout == "chaos" and rank == 1:
        # die between the payload bytes landing and the atomic rename
        HandoffChannel.pre_commit = staticmethod(
            lambda: mp_mesh.chaos_point("pre_handoff_commit"))
    mesh = MeshSpec(rank, 2, prefill_ranks=() if layout == "symmetric"
                    else (1,))
    srv = DisaggServer(model, ServingConfig(**spec["engine_kw"]), mesh,
                       os.path.join(run_dir, "shared"),
                       lease_s=DISAGG_LEASE_S)
    legs = _time_handoff_legs(srv)
    for p in prompts:
        srv.submit(p, spec["max_new"])
    mp_mesh.barrier(f"engines-up-{os.path.basename(run_dir)}")
    # an anchor line before any handoff: even a killed rank's sink holds
    # its clock anchor and its first events
    profiler.flush_active("manual")
    reg = registry()
    names = ("serving/handoff_bytes_out", "serving/handoff_bytes_in",
             "serving/ticks", "serving/prefills", "serving/tokens_generated")
    c0 = {n: reg.counter(n).value for n in names}
    seq0 = pev.log().next_seq
    _sync(dev)
    set_counts()
    t0 = time.perf_counter()
    legs["run_w"] = srv._walltime()
    if layout != "chaos":
        srv.run(timeout_s=spec["timeout_s"])
    elif rank == 1:
        deadline = time.monotonic() + spec["timeout_s"]
        while time.monotonic() < deadline:
            srv.step()
        raise AssertionError("the chaos kill never fired on rank 1")
    else:
        # the survivor: its direct requests first, then, once the mesh
        # declares rank 1 dead, the orphans it re-prefills
        direct = [i for i, p in enumerate(prompts)
                  if len(p) < srv.long_prompt_threshold]
        _drive_until(srv, lambda: all(g in srv.results() for g in direct),
                     spec["timeout_s"], "the direct requests")
        res["direct"] = direct
        res["recv_before_death"] = srv.handoffs_recv
        _drive_until(srv, lambda: len(srv.results()) == len(prompts),
                     spec["timeout_s"], "the re-dispatched requests")
    _sync(dev)
    res["wall_s"] = time.perf_counter() - t0
    res["launches"], res["chunk_launches_by_t"] = read_counts()
    res["counters"] = {n: reg.counter(n).value - c0[n] for n in names}
    evs = pev.log().events(since_seq=seq0)
    res["decisions"] = {}
    for e in evs:
        if e.kind == "consensus_decision":
            fam = e.attrs["family"]
            res["decisions"][fam] = res["decisions"].get(fam, 0) + 1
    res["vote_rtt_ms"] = [e.attrs["rtt_ms"] for e in evs
                          if e.kind == "consensus_decision"
                          and "rtt_ms" in e.attrs]
    res["legs"] = legs
    res["audit"] = srv.check_consistency()
    res["foreign_modules"] = sorted(
        m for m in sys.modules if m == "jax" or m.startswith("jax.")
        or m == "paddle_tpu" or m.startswith("paddle_tpu."))
    path = os.path.join(run_dir, f"results.{rank}.json")
    srv.write_results(path)
    with open(path) as f:
        doc = json.load(f)
    doc.update(res)
    with open(path, "w") as f:
        json.dump(doc, f)
    srv.close()
    profiler.disable_sink()             # os._exit skips atexit


def _disagg_launch(out, dev, timeout):
    """Start the pair of ranks on ``dev`` through ``distributed.mp_mesh``
    for every run of DISAGG_RUNS, served in turn; returns ({run: each
    reporting rank's results}, the launcher's verdict). Rank 1's clock is
    skewed by DISAGG_SKEW throughout (run A checks it), and it dies in
    run C."""
    from paddle_tpu_torch.distributed import mp_mesh

    runs = [(n, lay) for n, lay, _ in DISAGG_RUNS]
    assert [lay for _, lay in runs][-1] == "chaos"
    for n, _ in runs:
        os.makedirs(os.path.join(out, n))
    # gloo with both ranks on cuda:0; gloo on the CPU for a rehearsal of
    # the phase without a card
    env = {"FLAGS_selected_gpus": "0", "OMP_NUM_THREADS": "4",
           "PADDLE_DISTRI_BACKEND": "gloo" if dev.type == "cuda" else "cpu",
           "PADDLE_CLOCK_SKEW": f"1:{DISAGG_SKEW}"}
    names = [n for n, _ in runs]
    res = mp_mesh.launch(2, DISAGG_WORKER_SCRIPT,
                         ["--disagg-worker", out, ",".join(names)],
                         log_dir=os.path.join(out, "logs"), timeout=timeout,
                         chaos="kill:1:pre_handoff_commit",
                         expect_fail_ranks=(1,), env_extra=env)
    if not res.ok:
        print(f"--- disagg runs {names} ---\n{res.tail(4000)}",
              file=sys.stderr)
        raise AssertionError(f"disagg runs {names}: ranks exited "
                             f"{res.returncodes}")
    docs = {}
    for n, lay in runs:
        docs[n] = []
        for r in ((0,) if lay == "chaos" else (0, 1)):
            with open(os.path.join(out, n, f"results.{r}.json")) as f:
                docs[n].append(json.load(f))
    return docs, res


def _disagg_streams(docs, n_req):
    """The union of the ranks' results: every gid exactly once."""
    import numpy as np

    owner = {}
    for d in docs:
        for g in d["results"]:
            if g in owner:
                raise AssertionError(f"disagg: gid {g} finished on ranks "
                                     f"{owner[g]} and {d['rank']}")
            owner[g] = d["rank"]
    if sorted(int(g) for g in owner) != list(range(n_req)):
        raise AssertionError(f"disagg: finished gids {sorted(owner)}")
    return [np.asarray(next(d["results"][str(g)] for d in docs
                            if str(g) in d["results"]), np.int32)
            for g in range(n_req)]


def _nearest_rank(vals, q):
    s = sorted(vals)
    return s[min(int(q / 100.0 * len(s)), len(s) - 1)] if s else None


#: check (l), the live plane over runs A's and C's sinks: this process
#: tails them with a LiveAggregator (viewer mode, a tick every
#: LIVE_TICK_S) while the ranks serve; a rank whose newest frame is
#: LIVE_STALENESS_S old and whose lease expired is dead
LIVE_RUNS = ("A", "C")
LIVE_TICK_S = 0.5
LIVE_STALENESS_S = 2.0


def _live_tail(out, stop, aggs, hist):
    """Tick an aggregator over each of LIVE_RUNS' sink roots (once it
    exists) until ``stop``; each tick's rank block and alert transitions
    go to ``hist[run]``."""
    from paddle_tpu_torch.profiler.live import LiveAggregator

    while True:
        for name in LIVE_RUNS:
            root = os.path.join(out, name, "sink")
            if not os.path.isdir(root):
                continue
            if name not in aggs:
                aggs[name] = LiveAggregator(
                    root, interval_s=LIVE_TICK_S,
                    staleness_s=LIVE_STALENESS_S, world=2,
                    board_dir=os.path.join(out, name, "shared", "board"),
                    lease_s=DISAGG_LEASE_S, emit_alerts=False)
            st = aggs[name].tick()
            hist.setdefault(name, []).append({
                "tick": st["tick"], "transitions": st["alert_transitions"],
                "ranks": {r: {k: b[k] for k in ("dead", "stale", "age_s",
                                                "lease_age_s")}
                          for r, b in st["ranks"].items()}})
        if stop.wait(LIVE_TICK_S):
            return


def _live_checks(out, aggs, hist, rows, fails) -> dict:
    """(l): run A's last status names both ranks, passes
    tools/check_sink_schema.py (``--live-status``, a subprocess) and its
    merged e2e TTFT p50/p95 lie within the sketch's rel_err of the
    nearest-rank values of A's results; run C's first dead_rank firing
    names rank 1, whose lease had expired, while rank 0 was alive."""
    res = {}
    if set(aggs) != set(LIVE_RUNS):
        fails.append(f"live: aggregators for {sorted(aggs)}")
        return res
    st = aggs["A"].tick()
    lat = st["latency"].get("ttft_ms") or {}
    res["A"] = {"ranks": sorted(st["ranks"]), "ttft_ms": lat,
                "ticks": len(hist["A"])}
    if sorted(st["ranks"]) != ["0", "1"]:
        fails.append(f"live A: ranks {sorted(st['ranks'])}")
    for q in ("p50", "p95"):
        want = rows["A"][f"ttft_ms_{q}"]
        got = lat.get(q)
        if got is None or abs(got - want) > lat["rel_err"] * abs(want):
            fails.append(f"live A: ttft {q} {got} vs {want}")
    root = os.path.join(out, "A", "sink")
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "tools", "check_sink_schema.py"),
         os.path.join(root, "rank0"), "--live-status", root],
        capture_output=True, text=True, timeout=120)
    res["A"]["schema_rc"] = proc.returncode
    if proc.returncode != 0:
        fails.append(f"live A: schema {proc.stdout[-1500:]}"
                     f"{proc.stderr[-1500:]}")
    firing = [(h, t) for h in hist["C"] for t in h["transitions"]
              if t["rule"] == "dead_rank" and t["state"] == "firing"]
    res["C"] = {"ticks": len(hist["C"]),
                "first_dead_rank": None if not firing else {
                    "tick": firing[0][0]["tick"], "rank": firing[0][1].get(
                        "rank"), "ranks": firing[0][0]["ranks"]}}
    if not firing:
        fails.append("live C: no dead_rank alert")
        return res
    h, t = firing[0]
    r1, r0 = h["ranks"].get("1", {}), h["ranks"].get("0", {})
    if t.get("rank") != "1" or not r1.get("dead") or \
            r1.get("lease_age_s") is None or \
            r1["lease_age_s"] < DISAGG_LEASE_S or r0.get("dead", True):
        fails.append(f"live C: first dead_rank firing {t} at {h}")
    return res


def disagg_phase(model, dev, engine_kw, plain=None, card=None, n_req=16,
                 max_new=32, n_check=4, timeout=300):
    """Runs A, B and C of the serving mesh (module docstring), two ranks
    on this card; the parent writes the model's state once and, unless
    ``plain`` holds the engine phase's streams of the same workload,
    serves it on one engine (uncounted) for the streams' comparison.
    Returns (the ranks' summed launch counts, their chunk-row launches by
    T)."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from paddle_tpu_torch.models.gpt import state_to_numpy

    t_phase = time.perf_counter()
    cfg = model.config
    prompts = engine_prompts(cfg, n_req)
    out = tempfile.mkdtemp(prefix="disagg_phase_")
    try:
        spec = {"state": os.path.join(out, "state.npz"),
                "prompts": os.path.join(out, "prompts.npz"),
                "config": dataclasses.asdict(cfg), "device": str(dev),
                "max_new": max_new, "engine_kw": engine_kw,
                "timeout_s": timeout / 2,
                "runs": {name: {"layout": lay, "n_req": n or n_req}
                         for name, lay, n in DISAGG_RUNS}}
        np.savez(spec["state"], **state_to_numpy(model))
        np.savez(spec["prompts"], **{f"p{i}": p
                                     for i, p in enumerate(prompts)})
        parent_sum = _state_checksum(model)
        with open(os.path.join(out, "spec.json"), "w") as f:
            json.dump(spec, f)
        single = plain
        if single is None:
            with uncounted():
                single = _serve_counted(model, dev, prompts, max_new,
                                        engine_kw)[0]
        counts = {k: 0 for k in LAUNCH_COUNTERS}
        by_t = {}
        fails = []
        rows, aggs, hist = {}, {}, {}
        stop = threading.Event()
        tail = threading.Thread(target=_live_tail,
                                args=(out, stop, aggs, hist), daemon=True)
        tail.start()
        t0 = time.perf_counter()
        try:
            launched, res = _disagg_launch(out, dev, timeout)
        finally:
            stop.set()
            tail.join()
        launch_s = time.perf_counter() - t0
        for name, layout, _ in DISAGG_RUNS:
            docs = launched[name]
            n_run = spec["runs"][name]["n_req"]
            for d in docs:
                for k in LAUNCH_COUNTERS:
                    counts[k] += d["launches"][k]
                for t, n in d["chunk_launches_by_t"].items():
                    by_t[int(t)] = by_t.get(int(t), 0) + n
            row = _disagg_row(
                name, layout, docs, res, os.path.join(out, name),
                prompts[:n_run], single[:n_run], parent_sum, cfg.num_layers,
                fails)
            if layout == "disagg":
                with uncounted():
                    row["teacher_forced_match"] = teacher_match(
                        model, dev, prompts, _disagg_streams(docs, n_run),
                        n_check)
                if row["teacher_forced_match"] < 0.9:
                    fails.append(f"A: teacher-forced "
                                 f"{row['teacher_forced_match']}")
                row["merge"] = _disagg_merge(os.path.join(out, name),
                                             docs[0], fails)
            rows[name] = row
            emit({"disagg": "run", "card": card, **row})
        emit({"disagg": "live", "card": card,
              **_live_checks(out, aggs, hist, rows, fails)})
        emit({"disagg": "phase", "card": card, "requests": n_req,
              "max_new_tokens": max_new, "layers": cfg.num_layers,
              "state_sha1": parent_sum, "launch_s": launch_s,
              "seconds": time.perf_counter() - t_phase,
              "launches": counts})
    finally:
        shutil.rmtree(out, ignore_errors=True)
    if fails:
        raise AssertionError(f"disagg: {fails}")
    return counts, by_t


def _row5(doc, layers) -> dict:
    """A rank's row-5 launches and what its ticks carried. Every unified
    tick runs one decode row per slot (idle slots on the null page) and,
    when it has prompt chunks, one chunk-row call: per layer, so decode
    launches = ticks x layers, and a tick without chunk rows is a
    decode-only tick. Tokens emitted by decode rows = tokens generated
    less the first tokens of completed prefills."""
    n, c = doc["launches"], doc["counters"]
    ticks = int(c["serving/ticks"])
    return {"decode_rows": n["ragged"] - n["ragged_chunk"],
            "chunk_rows": n["ragged_chunk"], "int8": n["ragged_int8"],
            "ticks": ticks,
            "decode_only_ticks": ticks - n["ragged_chunk"] // layers,
            "decode_tokens": int(c["serving/tokens_generated"]
                                 - c["serving/prefills"])}


#: the legs of a handed-off TTFT, in order: (name, from stamp, to stamp);
#: stamps of rank 1 (prefill) but the last two, which are rank 0's
TTFT_LEGS = (("before_run", "submit_w", "run_w"),
             ("admission", "run_w", "engine_submit_w"),
             ("prefill", "engine_submit_w", "first_token_w"),
             ("to_export", "first_token_w", "export_w"),
             ("export", "export_w", "exported_w"),
             ("to_send", "exported_w", "send_w"),
             ("send", "send_w", "sent_w"),
             ("to_import", "sent_w", "admit_w"),
             ("import", "admit_w", "admitted_w"))


def _ttft_legs(r0, r1) -> dict:
    """Run A's handed-off TTFT split into TTFT_LEGS, each leg's p50 and
    max over the handed-off requests in ms, on the reference clock (each
    rank's stamps less its agreed offset), beside the TTFT the server
    reports. ``to_import`` holds the decode rank's poll cadence, its loads
    and any wait for a free slot; ``before_run`` the barrier that starts
    the run."""
    o = {0: r0["clock"]["offset_s"] or 0.0, 1: r1["clock"]["offset_s"] or 0.0}
    out, inn = r1["legs"]["out"], r0["legs"]["in"]
    per_leg = {name: [] for name, _, _ in TTFT_LEGS}
    gaps = []
    for g, ttft in r0["ttft_unc_ms"].items():
        if g not in out or g not in inn:
            continue
        w = {k: v - o[1] for k, v in out[g].items()}
        w["run_w"] = r1["legs"]["run_w"] - o[1]
        w.update({k: v - o[0] for k, v in inn[g].items()})
        for name, a, b in TTFT_LEGS:
            per_leg[name].append((w[b] - w[a]) * 1e3)
        gaps.append(abs((w["admitted_w"] - w["submit_w"]) * 1e3
                        - r0["ttft_ms"][g]))
    row = {name: {"p50": _nearest_rank(v, 50), "max": max(v, default=None)}
           for name, v in per_leg.items()}
    row["requests"] = len(gaps)
    row["sum_vs_ttft_ms_max"] = max(gaps, default=None)
    for r, d in (("0", r0), ("1", r1)):
        ticks = d["legs"]["tick_ms"]
        row[f"rank{r}"] = {
            "polls": d["legs"]["polls"], "poll_s": d["legs"]["poll_s"],
            "ticks": len(ticks), "first_tick_ms": ticks[:3],
            "tick_ms_p50": _nearest_rank(ticks, 50),
            "tick_s": sum(ticks)}
    return row


def _disagg_row(name, layout, docs, res, run_dir, prompts, single,
                parent_sum, layers, fails):
    """One run's numbers, its checks appended to ``fails``."""
    n_req = len(prompts)
    streams = _disagg_streams(docs, n_req)
    row = {"run": name, "layout": layout,
           "state_sha1": [d["state_checksum"] for d in docs],
           "wall_s": max(d["wall_s"] for d in docs),
           "load_s": [d["load_s"] for d in docs],
           "match_vs_single": match_rate(streams, single)}
    row["tokens_per_s"] = sum(len(s) for s in streams) / row["wall_s"]
    ttft = [t for d in docs for t in d["ttft_ms"].values()]
    row["ttft_ms_p50"] = _nearest_rank(ttft, 50)
    row["ttft_ms_p95"] = _nearest_rank(ttft, 95)
    row["handoffs"] = [d["handoffs_sent"] for d in docs] + \
        [d["handoffs_recv"] for d in docs]
    row["handoff_bytes"] = {str(d["rank"]): {
        "out": d["counters"]["serving/handoff_bytes_out"],
        "in": d["counters"]["serving/handoff_bytes_in"]} for d in docs}
    row["decisions_by_rank"] = {str(d["rank"]): d["decisions"]
                                for d in docs}
    rtts = [v for d in docs for v in d["vote_rtt_ms"]]
    row["vote_rtt_ms_p50"] = _nearest_rank(rtts, 50)
    row["row5_by_rank"] = {str(d["rank"]): _row5(d, layers) for d in docs}
    row["redispatched"] = {k: v for d in docs
                           for k, v in d["redispatched"].items()}
    row["members"] = {str(d["rank"]): sorted(d["members"]) for d in docs}
    row["clock"] = {str(d["rank"]): d["clock"] for d in docs}
    if row["match_vs_single"] < SPEC_MATCH_FLOOR:
        fails.append(f"{name}: match vs single {row['match_vs_single']}")
    for d in docs:
        if d["audit"]:
            fails.append(f"{name}: rank {d['rank']} audit {d['audit'][:4]}")
        if d["foreign_modules"]:
            fails.append(f"{name}: rank {d['rank']} imported "
                         f"{d['foreign_modules'][:4]}")
        if d["state_checksum"] != parent_sum:
            fails.append(f"{name}: rank {d['rank']} state checksum differs")
        if d["launches"]["ragged"] == 0:
            fails.append(f"{name}: rank {d['rank']} launched no row-5 kernel")
    by = row["row5_by_rank"]
    if layout == "disagg":
        r0, r1 = docs
        if not r1["handoffs_sent"] == r0["handoffs_recv"] > 0:
            fails.append(f"A: handoffs {r1['handoffs_sent']} sent, "
                         f"{r0['handoffs_recv']} received")
        # the prefill rank's ticks all carry chunk rows and its decode rows
        # emit nothing; the decode rank decodes
        if by["1"]["decode_only_ticks"] or by["1"]["decode_tokens"] or \
                by["1"]["chunk_rows"] == 0:
            fails.append(f"A: the prefill rank's row-5 launches {by['1']}")
        if by["0"]["decode_tokens"] == 0 or by["0"]["decode_rows"] == 0:
            fails.append(f"A: the decode rank's row-5 launches {by['0']}")
        clk = r1["clock"]
        if not clk["synced"] or abs(clk["offset_s"] - DISAGG_SKEW) > \
                clk["unc_s"] + 0.05:
            fails.append(f"A: rank 1's clock {clk}")
        row["clock_offset_err_s"] = None if clk["offset_s"] is None else \
            abs(clk["offset_s"] - DISAGG_SKEW)
        handed = sorted(r0["ttft_unc_ms"])
        if len(handed) != r0["handoffs_recv"] or any(
                r0["ttft_ms"][g] <= 0 or
                r0["ttft_unc_ms"][g] >= DISAGG_TTFT_UNC_MS for g in handed):
            fails.append(f"A: handed-off TTFTs {r0['ttft_ms']} "
                         f"+- {r0['ttft_unc_ms']}")
        row["ttft_unc_ms_max"] = max(r0["ttft_unc_ms"].values(), default=None)
        row["ttft_legs_ms"] = _ttft_legs(r0, r1)
    elif layout == "symmetric":
        if any(d["handoffs_sent"] or d["handoffs_recv"] for d in docs):
            fails.append(f"B: handoffs {row['handoffs']}")
        if any(by[r]["decode_tokens"] == 0 or by[r]["chunk_rows"] == 0
               for r in by):
            fails.append(f"B: row-5 launches {by}")
    else:
        (r0,) = docs
        if res.returncodes.get(1) != 137 or "chaos-killed" not in res.log(1):
            fails.append(f"C: rank 1 exited {res.returncodes.get(1)}")
        if r0["handoffs_recv"] or r0["recv_before_death"]:
            fails.append(f"C: the survivor imported {r0['handoffs_recv']}")
        names = os.listdir(os.path.join(run_dir, "shared", "handoff"))
        if not any(".tmp" in n for n in names) or \
                any(n.endswith(".npz") for n in names):
            fails.append(f"C: the channel holds {names}")
        orphans = set(range(n_req)) - set(r0["direct"])
        if {int(g) for g in r0["redispatched"]} != orphans or \
                set(r0["redispatched"].values()) != {"reprefill"}:
            fails.append(f"C: re-dispatched {r0['redispatched']}, "
                         f"orphans {sorted(orphans)}")
        if r0["members"] != {"0": "decode"}:
            fails.append(f"C: members {r0['members']}")
        row["orphans"] = len(orphans)
        row["channel_files"] = names
    return row


def _disagg_merge(run_dir, r0, fails):
    """``tools/merge_traces.py`` over run A's two sinks, as a
    subprocess."""
    merged = os.path.join(run_dir, "merged.json")
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "tools", "merge_traces.py"),
         os.path.join(run_dir, "sink"), "--out", merged],
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fails.append(f"A: merge_traces exited {proc.returncode}: "
                     f"{proc.stderr[-2000:]}")
        return None
    with open(merged) as f:
        doc = json.load(f)
    row = {k: doc.get(k) for k in ("partial", "handoffs",
                                   "monotonic_violations",
                                   "requests_total")}
    row["ttft_ms"] = doc.get("latency", {}).get("ttft_ms")
    if doc["monotonic_violations"] != 0 or doc["partial"] or \
            doc["handoffs"] != r0["handoffs_recv"]:
        fails.append(f"A: merged trace {row}")
    return row


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# dist phase: two ranks on one card over gloo
# ---------------------------------------------------------------------------
#: the DP replica's gradients: max |g_dp - g_replica| / max |g_replica| per
#: parameter (f32 with TF32 off; the two sum the batch's halves in another
#: order, cuBLAS may pick another algorithm for M 2048 than for M 4096)
DIST_GRAD_TOL = 1e-4
#: after AdamW's first step, where |g| > DIST_GRAD_TOL * max |g| (its
#: update is about lr * sign(g) elsewhere): |p_dp - p_replica|
DIST_PARAM_ATOL = 1e-6
#: tp = 2 against the dense layer: max |d| / max |ref| per tensor (f32; a
#: row product's two halves are summed apart, then all-reduced)
TP_TOL = 1e-5
DIST_LAYERS = 4          # gpt3_1_3b's widths, 4 of its 24 layers
DIST_BATCH = (2, 1024)   # per rank


def _rel_err(got, want) -> float:
    den = float(want.detach().abs().max()) or 1.0
    return float((got.detach().float() - want.detach().float()).abs().max()
                 ) / den


def _plain_dp_primitives(xs, ws):
    """The dist phase's primitive program for every rank at once, in
    plain tensor ops on the CPU: (per-rank outputs, per-rank gradients of
    the ranks' summed losses)."""
    import torch

    xs = [x.detach().cpu().double().requires_grad_() for x in xs]
    n = len(xs)
    total = sum(xs)
    outs = []
    for r in range(n):
        o = {"psum": total, "pmean": total / n,
             "gather": torch.cat(xs, 0),
             "scatter": total.chunk(n, 0)[r],
             "a2a": torch.cat([x.chunk(n, 0)[r] for x in xs], 1),
             "ppermute": xs[(r + 1) % n], "ring": xs[(r - 1) % n]}
        outs.append(o)
    loss = sum((o[k] * ws[r][k].cpu().double()).sum()
               for r, o in enumerate(outs) for k in o)
    loss.backward()
    return ([{k: v.detach().float() for k, v in o.items()} for o in outs],
            [x.grad.float() for x in xs])


def dist_collectives_check(dev, rank):
    """The collective API on CUDA tensors (the checks of
    tests/collective_worker.py and more), then the primitives over a
    {"dp": 2} mesh, outputs and gradients against the plain program."""
    import torch

    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed import primitives as P

    xs = [torch.arange(12, dtype=torch.float32, device=dev).reshape(3, 4)
          * (r + 1) + r for r in range(2)]
    stack = torch.stack(xs)
    for op, want in ((C.ReduceOp.SUM, stack.sum(0)),
                     (C.ReduceOp.MAX, stack.amax(0)),
                     (C.ReduceOp.MIN, stack.amin(0)),
                     (C.ReduceOp.PROD, stack.prod(0))):
        t = xs[rank].clone()
        C.all_reduce(t, op)
        assert torch.equal(t, want), ("all_reduce", op)
    t = xs[rank].clone()
    C.broadcast(t, src=0)
    assert torch.equal(t, xs[0])
    got = []
    C.all_gather(got, xs[rank])
    assert torch.equal(torch.stack(got), stack)
    parts = [[x * (i + 1) for i in range(2)] for x in xs]
    t = torch.zeros_like(xs[0])
    C.scatter(t, parts[rank], src=0)
    assert torch.equal(t, parts[0][rank])
    t = torch.zeros_like(xs[0])
    C.reduce_scatter(t, parts[rank])
    assert torch.equal(t, parts[0][rank] + parts[1][rank])
    got = []
    C.alltoall(parts[rank], got)
    assert torch.equal(torch.stack(got), torch.stack([parts[0][rank],
                                                      parts[1][rank]]))
    C.barrier()

    mesh = M.init_mesh({"dp": 2})
    g = torch.Generator().manual_seed(100)
    xs = [torch.randn(4, 6, generator=g) for _ in range(2)]
    ws = [{k: torch.randn(*s, generator=g) for k, s in (
        ("psum", (4, 6)), ("pmean", (4, 6)), ("gather", (8, 6)),
        ("scatter", (2, 6)), ("a2a", (2, 12)), ("ppermute", (4, 6)),
        ("ring", (4, 6)))} for _ in range(2)]
    want, want_grad = _plain_dp_primitives(xs, ws)
    x = xs[rank].to(dev).requires_grad_()
    outs = {"psum": P.psum(x, "dp"), "pmean": P.pmean(x, "dp"),
            "gather": P.all_gather(x, "dp", axis=0, tiled=True),
            "scatter": P.psum_scatter(x, "dp", scatter_dimension=0,
                                      tiled=True),
            "a2a": P.all_to_all(x, "dp", 0, 1, tiled=True),
            "ppermute": P.ppermute(x, "dp", [(0, 1), (1, 0)]),
            "ring": P.ring_permute(x, "dp", shift=1)}
    sum((o * ws[rank][k].to(dev)).sum() for k, o in outs.items()).backward()
    errs = {k: _rel_err(o.cpu(), want[rank][k]) for k, o in outs.items()}
    errs["grad"] = _rel_err(x.grad.cpu(), want_grad[rank])
    assert max(errs.values()) <= 1e-6, errs
    assert int(P.axis_index("dp")) == rank == mesh.axis_index("dp")
    M.set_mesh(None)
    return errs


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _dist_step(model, dp, dopt, opt, tok):
    """One DP step: (loss, host ms to the card's end, a copy of the
    synced gradients)."""
    dev = tok.device
    _sync(dev)
    t0 = time.perf_counter()
    loss = model.loss(tok)
    loss.backward()
    dp.apply_collective_grads()
    synced = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    dopt.step()
    opt.clear_grad()
    _sync(dev)
    return float(loss.detach()), (time.perf_counter() - t0) * 1e3, synced


def dist_dp_check(dev, rank, res, cfg=None, batch=DIST_BATCH):
    """DataParallel + fleet.distributed_optimizer(AdamW) at gpt3_1_3b
    widths, DIST_LAYERS layers: 2 f32 steps a rank; rank 0 then runs a
    single-process replica from the broadcast initial state on the two
    batches concatenated."""
    import dataclasses

    import torch

    import paddle_tpu_torch
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import device_trace, instrument

    cfg = cfg or dataclasses.replace(GPTConfig.gpt3_1_3b(),
                                     num_layers=DIST_LAYERS)
    lr = 1e-4
    toks = [torch.randint(0, cfg.vocab_size, batch,
                          generator=torch.Generator().manual_seed(10 + r)
                          ).to(dev) for r in range(2)]
    paddle_tpu_torch.seed(rank)             # rank 1 starts elsewhere
    model = GPT(cfg, device=dev)
    dp = paddle_tpu_torch.DataParallel(model)
    init = ({n: p.detach().clone() for n, p in model.named_parameters()}
            if rank == 0 else None)
    fleet.init(is_collective=True)
    opt = AdamW(lr, parameters=model.named_parameters(), weight_decay=0.01)
    dopt = fleet.distributed_optimizer(opt)
    numel = sum(p.numel() for p in model.parameters())
    n_params = len(list(model.parameters()))
    # warm-up forward and backward (no update): cuBLAS, the kernels' loads
    model.loss(toks[rank]).backward()
    opt.clear_grad()
    set_counts()
    with instrument.count_collectives() as cc:
        loss1, ms1, synced = _dist_step(model, dp, dopt, opt, toks[rank])
    st = instrument.collective_stats(cc)
    assert st["ops"] == {"all_reduce": 1 + n_params}, st["ops"]
    assert st["bytes"] == {"all_reduce": 2 * 4 * numel}, st["bytes"]
    after1 = ({n: p.detach().clone() for n, p in model.named_parameters()}
              if rank == 0 else None)
    if rank != 0:
        synced = None
    with device_trace.capture(steps=1, label="dist.step") as cap:
        loss2, ms2, _ = _dist_step(model, dp, dopt, opt, toks[rank])
    counts, _ = read_counts()
    tr = cap.summary
    assert tr.get("categories", {}).get("collective", {}).get("count", 0) \
        > 0, tr
    assert "all_reduce" in tr["collectives"], tr["collectives"]
    # the bucket all-reduce alone, twice
    bucket = torch.ones(numel, device=dev)
    bucket_ms = []
    for _ in range(2):
        C.barrier()
        _sync(dev)
        t0 = time.perf_counter()
        C.all_reduce(bucket)
        _sync(dev)
        bucket_ms.append((time.perf_counter() - t0) * 1e3)
    del bucket
    res.update(loss=[loss1, loss2], step_ms=[ms1, ms2], numel=numel,
               n_params=n_params, collective_stats=st,
               bucket_ms=bucket_ms, bucket_bytes=4 * numel,
               bucket_GBps=[4 * numel / (m / 1e3) / 1e9 for m in bucket_ms],
               launches=counts,
               trace={"collective": tr["categories"]["collective"],
                      "collectives": tr["collectives"],
                      "busy_frac": tr.get("busy_frac"),
                      "device_busy_ms": tr.get("device_busy_ms"),
                      "wall_ms": tr.get("wall_ms")},
               peak_bytes=torch.cuda.max_memory_allocated(dev)
               if dev.type == "cuda" else None)
    del model, dp, dopt, opt
    if rank != 0:
        return
    # the single-process replica on both batches, from the initial state
    with uncounted():
        rep = GPT(cfg, device=dev)
        with torch.no_grad():
            for n, p in rep.named_parameters():
                p.copy_(init[n])
        del init
        ropt = AdamW(lr, parameters=rep.named_parameters(), weight_decay=0.01)
        rloss = rep.loss(torch.cat(toks))
        rloss.backward()
        gerr, perr, gmax = {}, 0.0, {}
        for n, p in rep.named_parameters():
            gerr[n] = _rel_err(synced[n], p.grad)
            gmax[n] = float(p.grad.abs().max())
        ropt.step()
        for n, p in rep.named_parameters():
            clear = p.grad.abs() > DIST_GRAD_TOL * gmax[n]
            if clear.any():
                perr = max(perr, float((after1[n] - p.detach())[clear]
                                       .abs().max()))
    res.update(replica_loss=float(rloss), grad_rel_err=max(gerr.values()),
               worst_grad=max(gerr, key=gerr.get), param_abs_err=perr)
    assert max(gerr.values()) <= DIST_GRAD_TOL, gerr
    assert perr <= DIST_PARAM_ATOL, perr


def dist_tp_check(dev, rank, res, cfg=None, batch=DIST_BATCH):
    """The tensor-parallel layers at tp = 2 at gpt3_1_3b widths, each
    held to the dense layer on rank 0 (forward and gradients; the shards'
    gradients gathered)."""
    import torch

    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed import parallel_layers as PL
    from paddle_tpu_torch.models.gpt import GPTConfig, load_reference_state
    from paddle_tpu_torch.nn.layer.common import Embedding, Linear

    cfg = cfg or GPTConfig.gpt3_1_3b()
    h, f, v = cfg.hidden_size, cfg.ffn_hidden_size, cfg.vocab_size
    b, s = batch
    g = torch.Generator().manual_seed(21)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    full = {"col.weight": rnd(h, f, scale=0.02), "col.bias": rnd(f, scale=0.02),
            "row.weight": rnd(f, h, scale=0.02), "row.bias": rnd(h, scale=0.02),
            "emb.weight": rnd(v, h, scale=0.02)}
    x, w_h = rnd(b, s, h), rnd(b, s, h)
    ids = torch.randint(0, v, (b, s), generator=g).to(dev)
    logits = rnd(b, s, v, scale=3.0)
    labels = torch.randint(0, v, (b, s), generator=g).to(dev)
    labels[0, :7] = -100

    def state(prefix, dense=False):
        st = {k[len(prefix):]: a for k, a in full.items()
              if k.startswith(prefix)}
        return st if dense else PL.shard_reference_state(
            layers[prefix], {k: a.cpu().numpy() for k, a in st.items()}, m)

    def gathered(t, dim):
        parts = []
        C.all_gather(parts, t.contiguous())
        return parts[0] if dim is None else torch.cat(parts, dim)

    m = M.init_mesh({"tp": 2})
    layers = {"col.": PL.ColumnParallelLinear(h, f, gather_output=False,
                                              device=dev),
              "row.": PL.RowParallelLinear(f, h, input_is_parallel=True,
                                           device=dev),
              "emb.": PL.VocabParallelEmbedding(v, h, device=dev)}
    for p, layer in layers.items():
        load_reference_state(layer, state(p))
    ce = PL.ParallelCrossEntropy()
    M.set_mesh(None)
    errs = {}
    _sync(dev)
    t0 = time.perf_counter()
    xin = x.clone().requires_grad_()
    y = layers["row."](torch.nn.functional.gelu(layers["col."](xin),
                                                approximate="tanh"))
    (y * w_h).sum().backward()
    out_e = layers["emb."](ids)
    (out_e * w_h).sum().backward()
    z = logits.chunk(2, -1)[rank].contiguous().requires_grad_()
    loss = ce(z, labels)
    loss.backward()
    _sync(dev)
    res["tp_ms"] = (time.perf_counter() - t0) * 1e3
    grads = {"col.weight": gathered(layers["col."].weight.grad, 1),
             "col.bias": gathered(layers["col."].bias.grad, 0),
             "row.weight": gathered(layers["row."].weight.grad, 0),
             "row.bias": layers["row."].bias.grad,
             "emb.weight": gathered(layers["emb."].weight.grad, 0),
             "ce.dz": gathered(z.grad, -1)}
    if rank == 0:
        dense = {"col.": Linear(h, f, device=dev), "row.": Linear(f, h,
                                                                  device=dev),
                 "emb.": Embedding(v, h, device=dev)}
        for p, layer in dense.items():
            load_reference_state(layer, {k: a.cpu().numpy() for k, a in
                                         state(p, dense=True).items()})
        xr = x.clone().requires_grad_()
        yr = dense["row."](torch.nn.functional.gelu(dense["col."](xr),
                                                    approximate="tanh"))
        (yr * w_h).sum().backward()
        er = dense["emb."](ids)
        (er * w_h).sum().backward()
        zr = logits.clone().requires_grad_()
        lr_ = PL.ParallelCrossEntropy()(zr, labels)
        lr_.backward()
        errs = {"mlp.out": _rel_err(y, yr), "mlp.dx": _rel_err(xin.grad,
                                                               xr.grad),
                "emb.out": _rel_err(out_e, er),
                "ce.loss": abs(float(loss) - float(lr_)) / abs(float(lr_)),
                "ce.dz": _rel_err(grads["ce.dz"], zr.grad)}
        for k in ("col.weight", "col.bias", "row.weight", "row.bias",
                  "emb.weight"):
            p, n = k.split(".")
            errs[k] = _rel_err(grads[k], getattr(dense[p + "."], n).grad)
        res["tp_errs"] = errs
        assert max(errs.values()) <= TP_TOL, errs


def dist_aggregate_check(rank, res):
    """summary(aggregate=True) across the ranks against one registry
    that observed the union."""
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.profiler.metrics import MetricsRegistry

    samples = [torch.rand(300, generator=torch.Generator().manual_seed(r))
               .mul(100 * (r + 1)).tolist() for r in range(2)]
    profiler.enable()
    reg = profiler.registry()
    for val in samples[rank]:
        reg.histogram("dist/ms").observe(val)
    reg.counter("dist/steps").add(rank + 1)
    reg.gauge(f"dist/only{rank}").set(rank + 0.5)
    got = profiler.summary(aggregate=True)["metrics"]
    union = MetricsRegistry()
    for val in samples[0] + samples[1]:
        union.histogram("dist/ms").observe(val)
    union.counter("dist/steps").add(3)
    union.gauge("dist/only0").set(0.5)
    union.gauge("dist/only1").set(1.5)
    want = union.snapshot()
    assert set(got) == set(want), (sorted(got), sorted(want))
    for name, w in want.items():
        for k, val in w.items():
            if isinstance(val, float):
                assert abs(got[name][k] - val) <= 1e-9 * max(1.0, abs(val)), \
                    (name, k, got[name][k], val)
            else:
                assert got[name][k] == val, (name, k)
    res["aggregate_p50"] = got["dist/ms"]["p50"]


def dist_worker(out_dir) -> int:
    """One rank of the dist phase (started by the launcher)."""
    import torch

    import paddle_tpu_torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = dist.init_parallel_env()
    rank, dev = env.rank, env.device
    assert env.world_size == 2 and dev == torch.device("cuda", 0), \
        (env.world_size, dev)
    assert torch.distributed.get_backend() == "gloo"
    res = {"rank": rank, "device": str(dev)}
    t0 = time.perf_counter()
    res["primitive_errs"] = dist_collectives_check(dev, rank)
    res["collectives_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dist_dp_check(dev, rank, res)
    res["dp_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dist_tp_check(dev, rank, res)
    res["tp_s"] = time.perf_counter() - t0
    dist_aggregate_check(rank, res)
    res["foreign_modules"] = sorted(
        m for m in sys.modules if m == "jax" or m.startswith("jax.")
        or m == "paddle_tpu" or m.startswith("paddle_tpu."))
    assert not res["foreign_modules"], res["foreign_modules"]
    dist.barrier()
    with open(os.path.join(out_dir, f"dist.{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def _run_ranks(dev, flag, prefix, timeout):
    """Launch two ranks of this script (``flag OUT_DIR``) on this card
    (FLAGS_selected_gpus 0) over gloo through the port's launcher; a
    failed rank fails the phase with its log's tail. Returns (each rank's
    ``{prefix}.{rank}.json``, wall seconds)."""
    import shutil
    import signal
    import tempfile

    _free_memory(dev)
    out = tempfile.mkdtemp(prefix=f"{prefix}_phase_")
    logs = os.path.join(out, "logs")
    env = dict(os.environ, FLAGS_selected_gpus="0", OMP_NUM_THREADS="4",
               PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--backend", "gloo", "--log_dir", logs,
         os.path.join(HERE, "chip_smoke.py"), flag, out],
        env=env, cwd=HERE, start_new_session=True)
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        rc = "timeout"
    wall = time.perf_counter() - t0
    try:
        if rc != 0:
            for r in (0, 1):
                path = os.path.join(logs, f"workerlog.{r}")
                if os.path.exists(path):
                    with open(path) as f:
                        print(f"--- {prefix} rank {r} log tail ---\n"
                              + f.read()[-4000:], file=sys.stderr)
            raise AssertionError(f"the {prefix} phase's launcher exited {rc}")
        res = []
        for r in (0, 1):
            with open(os.path.join(out, f"{prefix}.{r}.json")) as f:
                res.append(json.load(f))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return res, wall


def dist_phase(dev, timeout=600):
    """Launch the dist phase's two ranks on this card (FLAGS_selected_gpus
    0) over gloo through the port's launcher; read and check their
    results. Returns (the ranks' summed launch counts, {})."""
    res, wall = _run_ranks(dev, "--dist-worker", "dist", timeout)
    counts = {k: sum(r["launches"][k] for r in res) for k in LAUNCH_COUNTERS}
    for r in res:
        emit({"dist": "rank", **r})
    emit({"dist": "phase", "seconds": wall,
          "step_ms": [r["step_ms"] for r in res],
          "bucket_bytes": res[0]["bucket_bytes"],
          "bucket_ms": [r["bucket_ms"] for r in res],
          "bucket_GBps": [r["bucket_GBps"] for r in res],
          "grad_rel_err": res[0]["grad_rel_err"],
          "param_abs_err": res[0]["param_abs_err"],
          "tp_errs": res[0]["tp_errs"], "launches": counts,
          "launches_by_rank": [r["launches"] for r in res]})
    for r in res:
        for k in ("flash", "bwd_single"):
            assert r["launches"][k] > 0, (r["rank"], k, r["launches"])
    return counts, {}


# ---------------------------------------------------------------------------
# hybrid phase: the strategy compiler's trainer on two ranks of one card
# ---------------------------------------------------------------------------
#: losses against the degree-1 replica (amp: both compute in bf16, the
#: sharded run sums its products in other orders: half of bf16's 2^-8)
HYBRID_LOSS_RTOL = 2e-3
#: after AdamW's first step (about lr * sign(g)), where |g| of the replica
#: exceeds HYBRID_G_CLEAR * max |g| of its tensor and the clipped |g|
#: exceeds HYBRID_G_EPS (100x AdamW's epsilon, 1e-8: nearer to it the
#: step depends on |g|): f32 storage within
#: HYBRID_PARAM_ATOL, bf16 storage within one bf16 ulp (2^-7 of the larger
#: magnitude), on at least HYBRID_PARAM_SHARE of each tensor's. Not on
#: every one: under amp the embedding's gradient is summed in bf16 by
#: the card's atomics, in another order on each side, so a few elements
#: whose gradient nearly cancels step the other way
HYBRID_PARAM_ATOL = 1e-6
HYBRID_BF16_ULP = 2.0 ** -7
HYBRID_G_CLEAR = 1e-2
HYBRID_G_EPS = 1e-6
HYBRID_PARAM_SHARE = 0.99
#: the first moments after step 1 (0.1 x the clipped gradient: they move
#: with the clip's scale and each tensor's share of the gradient) and
#: after step 2, which runs without the clip (so that they move with the
#: gradient's size, the dp mean), each held to the replica's: each
#: tensor's best-fit scale <got, want> / <want, want> within
#: HYBRID_M1_TENSOR_SCALE_TOL of 1 (a gradient counted twice, or not
#: divided by dp, is off by 2x) and its relative
#: error ||got - want|| / ||want|| at most HYBRID_M1_RTOL (a tensor laid
#: out wrongly is off by about 1.4; amp's bf16 sums in other orders give
#: a few 2^-8, more where a small tensor's gradient nearly cancels: the
#: worst measured on an H100 was 0.0148 over the hybrid and parallel
#: runs), and the best-fit scale of all of them together within
#: HYBRID_M1_SCALE_TOL of 1 (a wrong global norm scales every tensor
#: alike; the parallel runs also hold step 1's unclipped global norm to
#: the replica's at that tolerance)
HYBRID_M1_TENSOR_SCALE_TOL = 5e-2
HYBRID_M1_RTOL = 0.05
HYBRID_M1_SCALE_TOL = 2e-3
HYBRID_LR = 1e-4
#: step 1's global-norm clip, below the replica's norm so that it acts
#: (the replica check asserts it: a wrong global norm then shows as a
#: common scale of the first moments)
HYBRID_CLIP = 0.5
#: the hybrid runs' depth: gpt3_1_3b's widths, 2 of its 24 layers
HYBRID_LAYERS = 2
#: (name, mesh, ZeRO stage, storage dtypes, global batch, trainer knobs)
HYBRID_RUNS = (
    ("tp2_recipe", {"dp": 1, "tp": 2}, 0, "bfloat16", (2, 2048), {}),
    ("dp2_zero2", {"dp": 2}, 2, None, (4, 2048), {}),
    ("dp2_zero3", {"dp": 2}, 3, None, (4, 2048), {}),
    ("dp2_int8", {"dp": 2}, 2, None, (4, 2048),
     {"dp_grad_comm": "int8", "dp_param_comm": "bf16"}))
#: run (g) against run (b) (the f32 ring at the same knobs, from the same
#: state on the same batches): the losses of both steps at
#: HYBRID_LOSS_RTOL, a sanity bound only (it is larger than a step's
#: move); what decides is the f32 masters after step 1, held to (b)'s
#: parameters within HYBRID_PARAM_ATOL where (b)'s clipped gradient is
#: clear of zero (the replica rule's mask), on HYBRID_PARAM_SHARE of all
#: such elements together (AdamW's first step is lr * sign(g): a ring
#: that loses or mangles a rank's gradient flips the step of a large
#: share of elements, while the int8 error, at most half a block step,
#: flips only elements below it; a block of the flat slab can hold a
#: small tensor's gradients beside a large one's, so a small tensor,
#: a LayerNorm's, may flip on many of its few elements and the share
#: is not taken a tensor), and the first moments after the unclipped
#: step 2, whose
#: best-fit scale against (b)'s lies within HYBRID_M1_TENSOR_SCALE_TOL
#: of 1 (a gradient not divided by dp is off by 2x; int8 rounds a
#: block's elements below half a step to 0, which pulls the scale a
#: little below 1)
#: run (g)'s dp gradient bytes over run (b)'s (the reference's bound)
HYBRID_INT8_BYTES_RATIO = 0.55


def _hybrid_trainer(model, mesh, zero, dtype, **kw):
    """The train phase's recipe (amp, recompute, AdamW with the
    global-norm clip; bf16 parameter and moment storage when ``dtype``)
    at ZeRO ``zero`` over ``mesh`` (None: degree 1); ``kw``: more of the
    trainer's knobs (n_micro, v_virtual)."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.hybrid import HybridPipelineTrainer
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(HYBRID_LR, parameters=model.named_parameters(),
                weight_decay=0.1,
                grad_clip=tnn.ClipGradByGlobalNorm(HYBRID_CLIP))
    s = DistributedStrategy()
    s.amp = s.recompute = True
    if zero:
        s.sharding = True
        s.sharding_configs = {"sharding_stage": zero}
    if dtype:
        kw.update(param_dtype=dtype, moment_dtype=dtype)
    return HybridPipelineTrainer(model, opt, s, mesh, **kw)


def _timed_step(tr, tok, dev):
    _sync(dev)
    t0 = time.perf_counter()
    loss = float(tr.step(tok))
    _sync(dev)
    return loss, (time.perf_counter() - t0) * 1e3


def _hybrid_expected(name, cfg, batch, stats, numel, n_params):
    """The step's collectives, derived from the code: (a) tp 2: per
    layer two bf16 activation all-reduces forward (the row layers), two
    backward (the column layers' input gradients) and one recomputed
    (the first row layer; the checkpoint stops recomputing once its saved
    tensors are back), the embedding's and the head input's gradient's;
    in f32 three a loss chunk, twice (the chunk is checkpointed), and the
    clip's squared norms. (b) the flat slab: one reduce-scatter of the
    padded flat f32 gradients (this rank keeps a chunk) and one
    all-gather of the chunks, two scalar all-reduces (loss, norm), no
    gradient all-reduce. (c) ZeRO 3: every parameter all-gathered in the
    forward and each block's again in its recompute, reduce-scattered
    once in the backward; the two scalar and norm all-reduces."""
    from paddle_tpu_torch.distributed.qcomm import zero_chunk_len
    from paddle_tpu_torch.ops.fused_ce import _chunk_size

    L, h = cfg.num_layers, cfg.hidden_size
    b, s = batch
    ops, kd = stats["ops"], stats["bytes_by_kind_dtype"]
    if name == "tp2_recipe":
        act = b * s * h * 2
        chunks = s // _chunk_size(s, 256)
        want_ops = {"all_reduce": 5 * L + 2 + 6 * chunks + 1}
        assert ops == want_ops, (ops, want_ops)
        assert kd["all_reduce"]["bf16"] == (5 * L + 2) * act, kd
        return {"activation_all_reduces": 5 * L + 2,
                "activation_bytes": act}
    if name == "dp2_int8":
        # the int8 ring's one hop (the chunk's int8 values and its f32
        # block scales) and the bf16 return
        chunk = zero_chunk_len(numel, 2, 2048)
        assert ops == {"collective_permute": 2, "all_gather": 1,
                       "all_reduce": 2}, ops
        assert kd["collective_permute"] == {"i8": chunk,
                                            "f32": 4 * chunk // 2048}, kd
        assert kd["all_gather"] == {"bf16": 2 * 2 * chunk}, kd
        assert kd["all_reduce"] == {"f32": 8}, kd
        return {"chunk": chunk,
                "grad_bytes": chunk + 4 * chunk // 2048}
    if name == "dp2_zero2":
        chunk = zero_chunk_len(numel, 2, 2048)
        assert ops == {"reduce_scatter": 1, "all_gather": 1,
                       "all_reduce": 2}, ops
        assert kd["reduce_scatter"] == {"f32": 4 * chunk}, kd
        assert kd["all_gather"] == {"f32": 2 * 4 * chunk}, kd
        assert kd["all_reduce"] == {"f32": 8}, kd
        return {"chunk": chunk, "grad_bytes": 4 * chunk}
    per_block = (n_params - 4) // L       # the 4 others: wte, wpe, ln_f
    assert ops["reduce_scatter"] == n_params, ops
    assert ops["all_gather"] == n_params + L * per_block, ops
    assert ops["all_reduce"] == 2 and \
        kd["all_reduce"]["f32"] == 4 * (1 + n_params), kd
    return {"block_params": per_block}


def _moment1(tr, model) -> dict:
    """Every parameter's first moment after ``sync_to_layer``, f32 on the
    host (this rank's stage under a pipeline)."""
    acc = tr.optimizer._accumulators
    return {n: acc[id(p)]["moment1"].float().cpu().numpy()
            for n, p in model.named_parameters() if id(p) in acc}


def _moment_check(got: dict, want: dict, dev) -> dict:
    """The gathered first moments against the replica's: each tensor's
    best-fit scale and relative error, and the common scale of all."""
    import torch

    rel, scale = {}, {}
    dot = norm2 = 0.0
    for n, w in want.items():
        gm = torch.from_numpy(got[n]).to(dev).double()
        wm = torch.from_numpy(w).to(dev).double()
        rel[n] = float((gm - wm).norm() / wm.norm().clamp(min=1e-30))
        d_n, w_n = float((gm * wm).sum()), float((wm * wm).sum())
        scale[n] = d_n / max(w_n, 1e-300)
        dot += d_n
        norm2 += w_n
    worst = max(scale, key=lambda n: abs(scale[n] - 1))
    return {"scale": dot / norm2, "worst_rel_err": max(rel.values()),
            "worst_rel_param": max(rel, key=rel.get),
            "worst_tensor_scale": scale[worst],
            "worst_scale_param": worst}


def _replica_check(cfg, dev, init, toks, dtype, after1, m1, zero_led, res,
                   tr_kw=None, keep=None):
    """Rank 0: a degree-1 trainer from the gathered initial state on the
    same global batches, step 1 under the clip and step 2 without it (as
    the sharded run): losses, the parameters after step 1 (where |g| is
    clear of zero, each tensor on its own), the first moments after each
    step (``m1``: the sharded run's, gathered) and the optimizer state's
    bytes. ``tr_kw``: the replica's n_micro; ``keep`` (a dict): its
    ``hook(replica, gclear)`` runs after step 1, its ``after2(replica)``
    (if any) after step 2."""
    import torch

    from paddle_tpu_torch.models.gpt import GPT, load_reference_state

    from paddle_tpu_torch.distributed.mesh import create_mesh

    rep = GPT(cfg, device=dev)
    load_reference_state(rep, init)
    tr = _hybrid_trainer(rep, create_mesh({"dp": 1}, [0]), 0, dtype,
                         **(tr_kw or {}))
    tr._upd.zero_grad()
    tr._loss((toks[0],), backward=True)
    gnorm = float(torch.sqrt(sum(p.grad.float().square().sum()
                                 for p in rep.parameters())))
    clipped = min(1.0, HYBRID_CLIP / gnorm)
    gclear = {n: (p.grad.abs() > HYBRID_G_CLEAR * p.grad.abs().max())
              & (p.grad.abs() * clipped > HYBRID_G_EPS)
              for n, p in rep.named_parameters()}
    tr._upd.zero_grad()
    losses = [float(tr.step(toks[0]))]
    if keep is not None:
        keep["hook"](rep, gclear)
    worst, checked, total, within = 0.0, 0, 0, 0
    share = {}
    for n, p in rep.named_parameters():
        clear = gclear[n]
        got = torch.from_numpy(after1[n]).to(dev)[clear]
        want = p.detach().float()[clear]
        d = (got - want).abs()
        lim = HYBRID_BF16_ULP * torch.maximum(got.abs(), want.abs()) \
            if dtype else HYBRID_PARAM_ATOL
        ok = int((d <= lim).sum())
        share[n] = ok / max(1, d.numel())
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
        checked += d.numel()
        within += ok
        total += p.numel()
    moments = [_moment_check(m1[0], _moment1(tr, rep), dev)]
    tr.optimizer._grad_clip = None
    losses.append(float(tr.step(toks[1])))
    if keep is not None and "after2" in keep:
        keep["after2"](rep)
    moments.append(_moment_check(m1[1], _moment1(tr, rep), dev))
    led = tr.memory_ledger()
    res.update(replica_losses=losses, param_abs_err=worst,
               params_checked=checked / total,
               params_within=within / max(1, checked),
               worst_share=min(share.values()),
               worst_share_param=min(share, key=share.get),
               replica_grad_norm=gnorm, clip_norm=HYBRID_CLIP,
               moment1=moments,
               replica_opt_state=led["opt_state"],
               opt_state_ratio=zero_led["opt_state"] / led["opt_state"])
    del tr, rep


def _wte_repeat(cfg, dev, init, tok, dtype, after1, rep, gclear, res):
    """ROADMAP queue 3 item 5: a second degree-1 replica of run (a) on the
    same batch; how many ``wte`` elements differ between the two after
    step 1 (the card's bf16 atomics sum the embedding's gradient in
    another order on each run), and, where none do, the rows of the
    elements that the tp run and the replica disagree on beyond one bf16
    ulp (where |g| is clear, as the share rule checks)."""
    import torch

    from paddle_tpu_torch.distributed.mesh import create_mesh
    from paddle_tpu_torch.models.gpt import GPT, load_reference_state

    name = "embeddings.wte.weight"
    rep2 = GPT(cfg, device=dev)
    load_reference_state(rep2, init)
    tr2 = _hybrid_trainer(rep2, create_mesh({"dp": 1}, [0]), 0, dtype)
    tr2.step(tok)
    a = rep.embeddings.wte.weight.detach().float()
    b = rep2.embeddings.wte.weight.detach().float()
    n_diff = int((a != b).sum())
    out = {"replica_repeat_wte_differing": n_diff,
           "wte_elements": a.numel()}
    got = torch.from_numpy(after1[name]).to(dev)
    clear = gclear[name]
    off = ((got - a).abs() > HYBRID_BF16_ULP *
           torch.maximum(got.abs(), a.abs())) & clear
    rows = off.any(-1).nonzero().flatten()
    out.update(tp_run_wte_differing=int(off.sum()),
               tp_run_wte_rows=rows[:32].tolist(),
               tp_run_wte_n_rows=int(rows.numel()),
               rows_in_batch=int(torch.isin(rows, tok.flatten()).sum()))
    res["wte_repeat"] = out
    emit({"hybrid": "wte_repeat", **out})
    del tr2, rep2


def hybrid_run(dev, rank, name, axes, zero, dtype, batch, cfg=None,
               tr_kw=None, ckpt_dir=None, ref=None):
    """One run of the hybrid phase on this rank: 2 steps, the first one's
    collectives counted and every parameter gathered after it, the second
    in a parsed device_trace window; rank 0 then checks a degree-1
    replica. Returns this rank's results. ``cfg``: another GPTConfig
    (a CPU rehearsal at a small size); ``tr_kw``: more trainer knobs.

    Run (g) (``dp_grad_comm="int8"``) is held to ``ref``, run (b)'s
    results, instead of the replica (``_int8_checks``)."""
    import dataclasses

    import torch

    import paddle_tpu_torch
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed.parallel_layers import \
        gather_reference_state
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.profiler import device_trace, instrument

    cfg = cfg or dataclasses.replace(GPTConfig.gpt3_1_3b(),
                                     num_layers=HYBRID_LAYERS)
    toks = [torch.randint(0, cfg.vocab_size, batch,
                          generator=torch.Generator().manual_seed(40 + i)
                          ).to(dev) for i in range(2)]
    mesh = M.init_mesh(axes)
    paddle_tpu_torch.seed(3)
    model = GPT(cfg, device=dev)
    init = gather_reference_state(model)      # tp shards put together
    tr = _hybrid_trainer(model, mesh, zero, dtype, **(tr_kw or {}))
    numel = sum(a.size for a in init.values())
    n_params = len(init)
    res = {"run": name, "mesh": axes, "zero": zero, "dtype": dtype,
           "batch": list(batch), "zero_manual": tr.zero_manual}
    set_counts()
    with instrument.count_collectives() as cc:
        loss1, ms1 = _timed_step(tr, toks[0], dev)
    stats = instrument.collective_stats(cc)
    tr.sync_to_layer()
    after1 = gather_reference_state(model)
    if "master" in getattr(tr._upd, "slab", {}):
        after1 = _slab_masters(tr)      # the model holds the bf16 return
    m1 = [gather_reference_state(model, _moment1(tr, model))]
    # step 2 without the clip: step 1's clip acts, so a gradient's size
    # shows in the first moments only after an unclipped step
    tr.optimizer._grad_clip = None
    with device_trace.capture(steps=1, label=name) as cap:
        loss2, ms2 = _timed_step(tr, toks[1], dev)
    counts, _ = read_counts()
    tr.sync_to_layer()
    m1.append(gather_reference_state(model, _moment1(tr, model)))
    tr_sum = cap.summary
    led = tr.memory_ledger()
    comm_ms = sum(c["ms"] for c in tr_sum.get("collectives", {}).values())
    res.update(losses=[loss1, loss2], step_ms=[ms1, ms2],
               collective_stats=stats, launches=counts, ledger=led,
               expected=_hybrid_expected(name, cfg, batch, stats, numel,
                                         n_params),
               collective_GBps_of_step=[stats["total_bytes"] / ms * 1e-6
                                        for ms in (ms1, ms2)],
               trace={"busy_frac": tr_sum.get("busy_frac"),
                      "device_busy_ms": tr_sum.get("device_busy_ms"),
                      "wall_ms": tr_sum.get("wall_ms"),
                      "collective_ms": comm_ms,
                      "collectives": tr_sum.get("collectives")},
               peak_bytes=torch.cuda.max_memory_allocated(dev)
               if dev.type == "cuda" else None)
    if ref is not None:
        _int8_checks(dev, rank, tr, model, toks, res, ref, ckpt_dir, cfg,
                     after1, m1)
        del tr, model, init, after1, m1
        M.set_mesh(None)
        _free_memory(dev)
        return res
    del tr, model
    M.set_mesh(None)
    _free_memory(dev)
    if name == "dp2_zero2":
        # run (g)'s reference (hybrid_worker drops it before writing)
        res["_kept"] = {"after1": after1, "m1": m1}
    if rank == 0:
        keep = None
        if name == "tp2_recipe":
            keep = {"hook": lambda rep, gclear: _wte_repeat(
                cfg, dev, init, toks[0], dtype, after1, rep, gclear, res)}
        with uncounted():
            _replica_check(cfg, dev, init, toks, dtype, after1, m1, led,
                           res, keep=keep)
        emit({"hybrid": "replica", **{k: res[k] for k in (
            "run", "losses", "replica_losses", "param_abs_err",
            "params_checked", "params_within", "worst_share",
            "worst_share_param", "replica_grad_norm", "clip_norm",
            "moment1", "opt_state_ratio")}})
        for i in range(2):
            got, want = res["losses"][i], res["replica_losses"][i]
            assert abs(got - want) <= HYBRID_LOSS_RTOL * abs(want), \
                (name, i, got, want)
        assert res["worst_share"] >= HYBRID_PARAM_SHARE, res
        assert res["replica_grad_norm"] > HYBRID_CLIP, res
        for mc in res["moment1"]:
            assert mc["worst_rel_err"] <= HYBRID_M1_RTOL, res
            assert abs(mc["worst_tensor_scale"] - 1) <= \
                HYBRID_M1_TENSOR_SCALE_TOL, res
            assert abs(mc["scale"] - 1) <= HYBRID_M1_SCALE_TOL, res
        if zero:
            assert res["opt_state_ratio"] <= 0.5 + 0.05, res
    del init, after1, m1
    _free_memory(dev)
    return res


def _slab_masters(tr) -> dict:
    """The slab route's f32 masters, whole on every rank (a collective),
    by parameter name, as host arrays."""
    from paddle_tpu_torch.distributed import qcomm

    upd = tr._upd
    flat = qcomm.all_gather_cast(upd.slab["master"], upd.mesh)
    out, off = {}, 0
    for n, p, sz in zip(tr._names, upd.params, upd.sizes):
        out[n] = flat[off:off + sz].view(p.shape).float().cpu().numpy()
        off += sz
    return out


def _int8_checks(dev, rank, tr, model, toks, res, ref, ckpt_dir, cfg,
                 after1, m1):
    """Run (g)'s checks (``hybrid_run``): losses, the f32 masters after
    step 1 (``after1``) and the first moments after step 2 (``m1[1]``)
    against run (b) (``ref``, see HYBRID_RUNS); the dp gradient bytes
    against (b)'s; a third step whose ring-reduced gradient
    is held to the f32 reduce-scatter of the same local gradients within
    the hop's quantization bound (at dp 2 the one hop carries the other
    rank's chunk at its block amax / 127: each element within half a
    step); then every rank saves its ZeRO shard (``device_state``, a
    sync save to ``ckpt_dir``) and rank 0 restores the directory into a
    degree-1 trainer (a change of topology): its parameters bit-equal
    to the gathered ones."""
    import torch

    from paddle_tpu_torch.distributed import checkpoint as dck
    from paddle_tpu_torch.distributed import qcomm
    from paddle_tpu_torch.distributed.mesh import create_mesh
    from paddle_tpu_torch.distributed.parallel_layers import \
        gather_reference_state
    from paddle_tpu_torch.models.gpt import GPT

    l_g, l_b = res["losses"], ref["losses"]
    for i in range(2):
        assert abs(l_g[i] - l_b[i]) <= HYBRID_LOSS_RTOL * abs(l_b[i]), \
            (l_g, l_b)
    kept = ref.pop("_kept")
    beta1 = tr.optimizer._beta1
    share, checked, within = {}, 0, 0
    for n, want in kept["after1"].items():
        # (b)'s clipped step-1 gradient: its first moment / (1 - beta1)
        g = torch.from_numpy(kept["m1"][0][n]).to(dev).abs() / (1 - beta1)
        clear = (g > HYBRID_G_CLEAR * g.max()) & (g > HYBRID_G_EPS)
        d = (torch.from_numpy(after1[n]).to(dev)
             - torch.from_numpy(want).to(dev))[clear].abs()
        ok = int((d <= HYBRID_PARAM_ATOL).sum())
        share[n] = ok / d.numel() if d.numel() else 1.0
        checked += d.numel()
        within += ok
    moment = _moment_check(m1[1], kept["m1"][1], dev)
    res["vs_b"] = {"share": within / max(1, checked),
                   "worst_tensor_share": min(share.values()),
                   "worst_tensor_share_param": min(share, key=share.get),
                   "params_checked": checked / sum(
                       a.size for a in kept["after1"].values()),
                   "moment1_step2_scale": moment["scale"],
                   "moment1_step2_worst_rel_err": moment["worst_rel_err"]}
    del kept
    assert res["vs_b"]["share"] >= HYBRID_PARAM_SHARE, res["vs_b"]
    assert abs(moment["scale"] - 1) <= HYBRID_M1_TENSOR_SCALE_TOL, \
        res["vs_b"]
    ratio = res["expected"]["grad_bytes"] / ref["expected"]["grad_bytes"]
    assert ratio <= HYBRID_INT8_BYTES_RATIO, ratio
    ring = qcomm.quantized_reduce_scatter
    seen = []

    def checked(x, mesh, n, block=2048, mean=False):
        out = ring(x, mesh, n, block=block, mean=mean)
        with uncounted():
            exact = qcomm.reduce_scatter(x, mesh, n, mean=mean)
        scale = n if mean else 1
        own = x.float().reshape(n, -1)[mesh.axis_index("dp")]
        other = (exact * scale - own).reshape(-1, block)
        half = other.abs().amax(1, keepdim=True) / 127 / 2
        # plus the f32 roundings of the sum and the mean, and of the
        # sender's chunk as recovered here (the sum less this rank's)
        lim = (half * (1 + 2.0 ** -10) + 2.0 ** -20 * (
            exact * scale).abs().reshape(-1, block)) / scale
        err = (out - exact).abs().reshape(-1, block)
        seen.append({"worst_over_bound": float((err / lim.clamp(
            min=1e-30)).max()), "max_abs_err": float(err.max()),
            "max_half_step": float(half.max() / scale)})
        return out

    qcomm.quantized_reduce_scatter = checked
    try:
        res["losses"].append(float(tr.step(toks[0])))
    finally:
        qcomm.quantized_reduce_scatter = ring
    res["int8_grad_check"] = seen[0]
    assert seen[0]["worst_over_bound"] <= 1.0, seen
    res["grad_bytes_ratio"] = ratio
    dck.save(ckpt_dir, tr.device_state(), step=3, async_=False)
    tr.sync_to_layer()
    final = gather_reference_state(model)
    if rank == 0:
        with uncounted():
            rep = GPT(cfg, device=dev)
            rtr = _hybrid_trainer(rep, create_mesh({"dp": 1}, [0]), 0, None)
            t0 = time.perf_counter()
            rtr.load_device_state(dck.restore(ckpt_dir, rtr.device_state()),
                                  step=3)
            _sync(dev)
            res["restore_s"] = time.perf_counter() - t0
            differ = [n for n, p in rep.named_parameters()
                      if not torch.equal(p.detach().cpu(),
                                         torch.from_numpy(final[n]))]
            assert not differ, differ[:8]
            res["restored_params"] = len(final)
            del rtr, rep
    del final
    emit({"hybrid": "int8", "rank": rank, "losses": res["losses"],
          "ref_losses": l_b, "vs_b": res["vs_b"], "grad_bytes_ratio": ratio,
          "int8_grad_check": seen[0],
          "restored_params": res.get("restored_params")})


#: run (h): the guard and the mesh-agreed rollback at {"dp": 2}, ZeRO 1,
#: int8 gradients (the slab's int8 ring), f32 storage; a NaN on rank 1
#: alone at cursors HYBRID_RESIL_NAN, bad_step_limit 2, a checkpoint every
#: 3 steps in one directory both ranks share, the consensus board beside
#: it
HYBRID_RESIL_LAYERS = 2
HYBRID_RESIL_BATCH = (2, 2048)
HYBRID_RESIL_NAN = (3, 4)
HYBRID_RESIL_STEPS = 7


def hybrid_resilience_run(dev, rank, out_dir, cfg=None,
                          batch=HYBRID_RESIL_BATCH) -> dict:
    """Run (h) on this rank: ``ResilientRunner`` with the consensus board
    over the guarded trainer (GPT at gpt3_1_3b widths cut to
    HYBRID_RESIL_LAYERS layers, the hybrid recipe); each step's verdict,
    whether the poisoned cursors' steps left this rank's state's digest
    as it was, the rollbacks, skips, restored steps and losses, the
    launch counts of the run."""
    import dataclasses

    import numpy as np

    import paddle_tpu_torch
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed.consensus import Consensus
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.resilience import (ResilienceConfig,
                                             ResilientRunner, chaos)

    cfg = cfg or dataclasses.replace(GPTConfig.gpt3_1_3b(),
                                     num_layers=HYBRID_RESIL_LAYERS)
    mesh = M.init_mesh({"dp": 2})
    paddle_tpu_torch.seed(5)
    tr = _hybrid_trainer(GPT(cfg, device=dev), mesh, 1, None,
                         dp_grad_comm="int8", guard_bad_steps=True)
    assert tr.zero_manual, "run (h) did not take the slab route"
    cons = Consensus(os.path.join(out_dir, "resil_board"), rank, 2,
                     lease_s=DISAGG_LEASE_S, timeout_s=120.0)
    runner = ResilientRunner(
        tr, os.path.join(out_dir, "resil_ckpt"), save_interval=3,
        config=ResilienceConfig(bad_step_limit=2, consensus=cons),
        chaos=chaos.ChaosPlan(nan_cursors=HYBRID_RESIL_NAN)
        if rank == 1 else None)
    el = runner.elastic
    verdicts, kept, restored = {}, {}, []
    step, resume = tr.step, el.resume

    def watched(*b):
        cur = el.data_cursor
        before = _digest(tr.device_state()) \
            if cur in HYBRID_RESIL_NAN else None
        loss = step(*b)
        verdicts[cur] = tr.last_step_ok_device()
        if before is not None:
            kept[cur] = _digest(tr.device_state()) == before
        return loss

    tr.step = watched
    el.resume = lambda *a, **k: (restored.append(resume(*a, **k)),
                                 restored[-1])[1]

    def data(cursor):
        rng = np.random.RandomState(4000 + cursor)
        return (rng.randint(0, cfg.vocab_size, batch).astype(np.int64),)

    set_counts()
    t0 = time.perf_counter()
    res = runner.run(data, HYBRID_RESIL_STEPS)
    out = {"run": "h_resilience", "rank": rank,
           "seconds": time.perf_counter() - t0,
           "launches": read_counts()[0], "rollbacks": res.rollbacks,
           "skips": sorted(runner._skips), "restored": restored,
           "losses": {str(s): v for s, v in sorted(res.losses.items())},
           "verdicts": {str(c): bool(v) for c, v in verdicts.items()},
           "kept": {str(c): v for c, v in kept.items()}}
    del runner, tr
    _free_memory(dev)
    return out


def _hybrid_resilience_checks(rs) -> dict:
    """Run (h) across the two ranks: both verdicts False at the poisoned
    cursors and True elsewhere, both states unchanged there, one
    rollback each to the same step, skips equal to the poisoned cursors,
    the losses finite and bit-equal across the ranks."""
    import math

    bad = {str(c) for c in HYBRID_RESIL_NAN}
    fails = []
    for r in rs:
        if {c for c, ok in r["verdicts"].items() if not ok} != bad or \
                set(r["kept"]) != bad or not all(r["kept"].values()):
            fails.append(f"rank {r['rank']}: verdicts {r['verdicts']}, "
                         f"kept {r['kept']}")
        if r["rollbacks"] != 1 or r["skips"] != list(HYBRID_RESIL_NAN) \
                or sorted(map(int, r["losses"])) != \
                list(range(HYBRID_RESIL_STEPS)) or \
                not all(math.isfinite(v) for v in r["losses"].values()):
            fails.append(f"rank {r['rank']}: {r['rollbacks']} rollbacks, "
                         f"skips {r['skips']}, losses {r['losses']}")
    if rs[0]["restored"] != rs[1]["restored"] or \
            rs[0]["losses"] != rs[1]["losses"]:
        fails.append(f"ranks differ: restored {rs[0]['restored']} / "
                     f"{rs[1]['restored']}, losses {rs[0]['losses']} / "
                     f"{rs[1]['losses']}")
    if fails:
        raise AssertionError(f"hybrid run (h): {fails}")
    return {"hybrid": "resilience", "rollbacks": [r["rollbacks"]
                                                  for r in rs],
            "skips": rs[0]["skips"], "restored": rs[0]["restored"],
            "losses": rs[0]["losses"], "verdicts": rs[0]["verdicts"],
            "seconds": [r["seconds"] for r in rs],
            "launches": [r["launches"] for r in rs]}


def hybrid_worker(out_dir) -> int:
    """One rank of the hybrid phase (started by the launcher)."""
    import torch

    import paddle_tpu_torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = dist.init_parallel_env()
    rank, dev = env.rank, env.device
    assert env.world_size == 2 and dev == torch.device("cuda", 0), \
        (env.world_size, dev)
    runs = []
    for name, axes, zero, dtype, batch, kw in HYBRID_RUNS:
        t0 = time.perf_counter()
        int8 = kw.get("dp_grad_comm") == "int8"
        r = hybrid_run(dev, rank, name, axes, zero, dtype, batch, tr_kw=kw,
                       ckpt_dir=os.path.join(out_dir, "ckpt_" + name),
                       ref=next(x for x in runs if x["run"] == "dp2_zero2")
                       if int8 else None)
        r["seconds"] = time.perf_counter() - t0
        runs.append(r)
    for r in runs:
        r.pop("_kept", None)
    _free_memory(dev)
    resil = hybrid_resilience_run(dev, rank, out_dir)
    res = {"rank": rank, "runs": runs, "resilience": resil,
           "foreign_modules": sorted(
        m for m in sys.modules if m == "jax" or m.startswith("jax.")
        or m == "paddle_tpu" or m.startswith("paddle_tpu."))}
    assert not res["foreign_modules"], res["foreign_modules"]
    dist.barrier()
    with open(os.path.join(out_dir, f"hybrid.{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def hybrid_phase(dev, timeout=600):
    """Launch the hybrid phase's two ranks on this card over gloo; read
    and check their results. Returns (the ranks' summed launch counts,
    {})."""
    res, wall = _run_ranks(dev, "--hybrid-worker", "hybrid", timeout)
    PHASE_RESULTS["hybrid"] = res
    counts = {k: sum(run["launches"][k] for r in res
                     for run in r["runs"] + [r["resilience"]])
              for k in LAUNCH_COUNTERS}
    tc = ("flash_tc", "bwd_dq_tc", "bwd_dkv_tc")
    f32_route = ("flash", "bwd_single", "bwd_dq", "bwd_dkv")
    emit(_hybrid_resilience_checks([r["resilience"] for r in res]))
    for r in res:
        for run in r["runs"] + [r["resilience"]]:
            emit({"hybrid": "run", "rank": r["rank"], **run})
            for k in tc:
                assert run["launches"][k] > 0, (r["rank"], run["run"], k)
            for k in f32_route:
                assert run["launches"][k] == 0, (r["rank"], run["run"], k)
    emit({"hybrid": "phase", "seconds": wall, "launches": counts,
          "step_ms": {run["run"]: [r["runs"][i]["step_ms"] for r in res]
                      for i, run in enumerate(res[0]["runs"])},
          "collective_bytes": {run["run"]: run["collective_stats"][
              "total_bytes"] for run in res[0]["runs"]},
          "busy_frac": {run["run"]: [r["runs"][i]["trace"]["busy_frac"]
                                     for r in res]
                        for i, run in enumerate(res[0]["runs"])}})
    return counts, {}


# ---------------------------------------------------------------------------
# parallel phase: the pipeline, the ring over sp and expert parallelism
# ---------------------------------------------------------------------------
#: MoE run (f): gpt3_1_3b widths with 8 experts a layer (top-2)
PARALLEL_MOE = dict(moe_num_experts=8, moe_top_k=2, moe_capacity_factor=1.25,
                    moe_aux_weight=0.01)
#: (name, mesh, storage dtypes, global batch, trainer knobs, MoE config)
PARALLEL_RUNS = (
    ("pp2_v2", {"dp": 1, "pp": 2}, "bfloat16", (4, 2048),
     {"n_micro": 4, "v_virtual": 2}, None),
    ("sp2", {"dp": 1, "sp": 2}, None, (2, 2048), {}, None),
    ("ep2_moe", {"dp": 1, "ep": 2}, "bfloat16", (2, 2048), {},
     PARALLEL_MOE))
#: ring attention alone at the sp run's attention shape, [B, S, H, D]
RING_SHAPE = (2, 2048, 16, 128)
#: a routing choice is compared where its probability exceeds the next
#: one's by more than this on both sides (amp: bf16 logits, a few 2^-8)
MOE_ROUTE_MARGIN = 2e-3
#: run (f)'s experts on an ep rank over the replica's: 1/2 + 5%
EP_EXPERT_SHARE = 0.55
#: each parallel run's own launch counts (the kernels line's ring rows)
PARALLEL_RUN_COUNTS: dict = {}


def ring_check(dev, rank, mesh, shape=RING_SHAPE, seed=12):
    """ring_attention alone over ``sp`` (causal, bf16) on the global
    ``shape`` cut on dim 1: rank 0 holds the gathered output against the
    plain full attention at BF16_TOL, and the gathered gradients against
    the plain full backward on the ring's own global LSE and delta
    (``fa._plain_grads``: P and dS rounded to bf16 as the kernels do) with
    one bf16 flip of P or dS a row (``flip_row_check``; the gradients are
    bf16: BWD_BF16_RTOL)."""
    import torch

    from paddle_tpu_torch.distributed.primitives import _gather
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import ring_attention as ra

    b, s, h, d = shape
    n = mesh.shape["sp"]
    sl = s // n
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(4))

    def mine(t):
        return t[:, rank * sl:(rank + 1) * sl].contiguous()

    ql, kl, vl = (mine(t).requires_grad_() for t in (q, k, v))
    o = ra.ring_attention(ql, kl, vl, "sp", causal=True)
    o.backward(mine(do))
    scale = 1.0 / d ** 0.5
    ring, sp, idx = ra._ring_of(mesh, "sp")
    with torch.no_grad():
        _, lse = ra._ring_fwd(ql.detach(), kl.detach(), vl.detach(), True,
                              scale, ring, sp, idx)

    def whole(t, dim=1):
        return _gather(t.contiguous(), mesh.group("sp"),
                       mesh.group_order("sp"), dim, True)

    o_all = whole(o.detach())
    grads = [whole(x.grad) for x in (ql, kl, vl)]
    lse_all = whole(lse)
    if rank != 0:
        return None
    with torch.no_grad():
        ref_o, _ = fa._plain_fwd(q.float(), k.float(), v.float(), True, None)
    fwd_err = float((o_all.float() - ref_o).abs().max())
    if not torch.allclose(o_all.float(), ref_o, rtol=BF16_TOL,
                          atol=BF16_TOL):
        raise AssertionError(f"ring forward {shape}: max abs err {fwd_err}")
    delta = (do.float() * o_all.float()).sum(-1).transpose(1, 2) \
        .reshape(b * h, s, 1)
    ref = fa._plain_grads(scale, True, (q, k, v, lse_all), do, delta,
                          (torch.float32,) * 3, ("dq", "dk", "dv"))
    flips = flip_row_check(f"ring {shape}", grads, ref, flip_row_scales(
        q, k, v, do, lse_all, delta, scale, True), BWD_BF16_RTOL)
    out = {"shape": list(shape), "sp": n, "dtype": "bfloat16",
           "fwd_max_abs_err": fwd_err, "fwd_tolerance": BF16_TOL,
           "grads": flips, "grad_rule": "rtol 2^-7 + atol BWD_TC_ATOL "
           "max|ref| + one bf16 flip of P or dS a row, against the plain "
           "full backward on the ring's global LSE and delta"}
    emit({"parallel": "ring_check", **out})
    return out


def _moe_layers(model):
    return [blk.mlp for blk in model.blocks
            if type(blk.mlp).__name__ == "MoEMLP"]


def _expert_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for mlp in _moe_layers(model)
               for n, p in mlp.named_parameters() if n != "gate")


def _routes(model) -> list:
    """Each MoE layer's routing of its last forward, on the host."""
    return [{k: t.cpu() for k, t in mlp.last_route.items()}
            for mlp in _moe_layers(model)]


def _route_check(got, want) -> dict:
    """Run (f)'s routing of the first micro-batch against the replica's:
    equal wherever both sides' margin over the next choice exceeds
    MOE_ROUTE_MARGIN; the dropped (token, round) counts equal."""
    checked = same = 0
    for g, w in zip(got, want):
        k = g["experts"].shape[0]
        clear = ((g["top"][:k] - g["top"][1:k + 1]) > MOE_ROUTE_MARGIN) & \
            ((w["top"][:k] - w["top"][1:k + 1]) > MOE_ROUTE_MARGIN)
        checked += int(clear.sum())
        same += int(((g["experts"] == w["experts"]) & clear).sum())
    dropped = [int((~r["kept"]).sum()) for r in got]
    dropped_rep = [int((~r["kept"]).sum()) for r in want]
    out = {"checked": checked, "equal": same,
           "checked_share": checked / max(1, sum(r["experts"].numel()
                                                 for r in got)),
           "dropped": dropped, "replica_dropped": dropped_rep}
    if same != checked or dropped != dropped_rep:
        raise AssertionError(f"MoE routing differs from the replica's: {out}")
    return out


def _route_diff(got, want) -> dict:
    """Step 2's routing on the two sides, reported: the (token, round)
    choices that differ and the dropped counts a layer."""
    return {"differing": [int((g["experts"] != w["experts"]).sum())
                          for g, w in zip(got, want)],
            "dropped": [int((~r["kept"]).sum()) for r in got],
            "replica_dropped": [int((~r["kept"]).sum()) for r in want]}


def _parallel_expected(name, cfg, batch, stats, tr_kw, remat=True) -> dict:
    """The step's counted collectives against the code's: (d) the
    pipeline's permutes, v·n_micro + pp − 1 forward and as many backward,
    each one micro-batch's bf16 activation; (e) per layer the ring's K/V
    hops forward (twice: the block's recompute runs attention again) and
    its backward's K, V, dK, dV hops and the last dK/dV hop home; (f) per
    layer the ep sums: the output forward (once: torch's non-reentrant
    checkpoint stops recomputing once its saved tensors are back, before
    the layer's last op), the tokens' and the gate's gradients, and the
    clip's squared norms over ep."""
    L, h = cfg.num_layers, cfg.hidden_size
    b, s = batch
    ops, kd = stats["ops"], stats["bytes_by_kind_dtype"]
    passes = 2 if remat else 1
    if name == "pp2_v2":
        pp, v, n = 2, tr_kw["v_virtual"], tr_kw["n_micro"]
        ticks = v * n + pp - 1
        act = (b // n) * s * h * 2
        assert ops["collective_permute"] == 2 * ticks, (ops, ticks)
        assert kd["collective_permute"] == {"bf16": 2 * ticks * act}, kd
        return {"ticks": ticks, "permutes": 2 * ticks,
                "permute_bytes": act, "bubble": (pp - 1) / ticks}
    if name == "sp2":
        hop = b * (s // 2) * h * 2               # K or V shard, bf16
        want = {"bf16": L * (2 * passes + 2) * hop, "f32": L * 4 * 2 * hop}
        assert ops["collective_permute"] == L * (2 * passes + 6), ops
        assert kd["collective_permute"] == want, (kd, want)
        return {"permutes": L * (2 * passes + 6), "bytes": want}
    tokens = b * s
    y = tokens * h * 2                           # the layer's output, bf16
    gate = h * cfg.moe_num_experts * 2
    sums = L * 3
    ep_bytes = L * (2 * y + gate)
    assert ops["all_reduce"] == sums + 1, (ops, sums)   # + the clip's
    assert kd["all_reduce"]["bf16"] == ep_bytes, (kd, ep_bytes)
    return {"ep_sums": sums, "ep_bytes": ep_bytes}


def parallel_run(dev, rank, name, axes, dtype, batch, tr_kw, moe, cfg=None,
                 ring_shape=RING_SHAPE):
    """One run of the parallel phase on this rank: 2 steps of the hybrid
    recipe on ``axes`` (the first one's collectives counted and every
    parameter gathered after it, the second in a parsed device_trace
    window); rank 0 then checks a degree-1 replica, as hybrid_run does.
    The sp run first holds ring_attention alone (ring_check), the MoE run
    the routing and the experts' bytes. ``cfg``: another GPTConfig (a CPU
    rehearsal at a small size; ``ring_shape`` the ring check's then)."""
    import dataclasses

    import torch

    import paddle_tpu_torch
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed.parallel_layers import \
        gather_reference_state
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.profiler import device_trace, instrument

    cfg = cfg or dataclasses.replace(GPTConfig.gpt3_1_3b(),
                                     num_layers=DIST_LAYERS)
    if moe:
        cfg = dataclasses.replace(cfg, **moe)
    toks = [torch.randint(0, cfg.vocab_size, batch,
                          generator=torch.Generator().manual_seed(50 + i)
                          ).to(dev) for i in range(2)]
    mesh = M.init_mesh(axes)
    res = {"run": name, "mesh": axes, "dtype": dtype, "batch": list(batch),
           "trainer": tr_kw, "moe": moe}
    if "sp" in axes:
        with uncounted():
            res["ring_check"] = ring_check(dev, rank, mesh, ring_shape)
    paddle_tpu_torch.seed(3)
    model = GPT(cfg, device=dev)
    init = gather_reference_state(model)     # ep shards put together
    tr = _hybrid_trainer(model, mesh, 0, dtype, **tr_kw)
    res["circuits"] = tr.circuits
    # step 1's gradient before the clip, as the clip takes its norm: its
    # size against the replica's (a clip that acts hides it)
    tr._upd.zero_grad()
    tr._loss((toks[0],), backward=True)
    res["grad_norm"] = tr._upd.global_norm()
    tr._upd.zero_grad()
    set_counts()
    with instrument.count_collectives() as cc:
        loss1, ms1 = _timed_step(tr, toks[0], dev)
    stats = instrument.collective_stats(cc)
    routes = [_routes(model) if moe else None]
    tr.sync_to_layer()
    after1 = gather_reference_state(model)
    if "master" in getattr(tr._upd, "slab", {}):
        after1 = _slab_masters(tr)      # the model holds the bf16 return
    m1 = [gather_reference_state(model, _moment1(tr, model))]
    tr.optimizer._grad_clip = None
    with device_trace.capture(steps=1, label=name) as cap:
        loss2, ms2 = _timed_step(tr, toks[1], dev)
    counts, _ = read_counts()
    routes.append(_routes(model) if moe else None)
    tr.sync_to_layer()
    m1.append(gather_reference_state(model, _moment1(tr, model)))
    tr_sum = cap.summary
    led = tr.memory_ledger()
    comm_ms = sum(c["ms"] for c in tr_sum.get("collectives", {}).values())
    busy = tr_sum.get("busy_frac")
    res.update(losses=[loss1, loss2], step_ms=[ms1, ms2],
               collective_stats=stats, launches=counts, ledger=led,
               expected=_parallel_expected(name, cfg, batch, stats, tr_kw),
               collective_GBps_of_step=[stats["total_bytes"] / ms * 1e-6
                                        for ms in (ms1, ms2)],
               trace={"busy_frac": busy,
                      "idle_frac": None if busy is None else 1 - busy,
                      "device_busy_ms": tr_sum.get("device_busy_ms"),
                      "wall_ms": tr_sum.get("wall_ms"),
                      "collective_ms": comm_ms,
                      "collectives": tr_sum.get("collectives")},
               expert_bytes=_expert_bytes(model) if moe else None,
               peak_bytes=torch.cuda.max_memory_allocated(dev)
               if dev.type == "cuda" else None)
    del tr, model
    M.set_mesh(None)
    _free_memory(dev)
    if name == "dp2_zero2":
        # run (g)'s reference (hybrid_worker drops it before writing)
        res["_kept"] = {"after1": after1, "m1": m1}
    if rank == 0:
        keep = None
        if moe:
            def hook(rep, gclear):
                res["routing"] = _route_check(routes[0], _routes(rep))
                res["replica_expert_bytes"] = _expert_bytes(rep)

            keep = {"hook": hook, "after2": lambda rep: res.update(
                rep_routes=_routes(rep))}
        rep_kw = {"n_micro": tr_kw["n_micro"]} if "n_micro" in tr_kw else {}
        with uncounted():
            _replica_check(cfg, dev, init, toks, dtype, after1, m1, led, res,
                           tr_kw=rep_kw, keep=keep)
        if moe:
            res["routing_step2"] = _route_diff(routes[1],
                                               res.pop("rep_routes"))
        emit({"parallel": "replica", **{k: res.get(k) for k in (
            "run", "losses", "replica_losses", "param_abs_err",
            "params_checked", "params_within", "worst_share",
            "worst_share_param", "grad_norm", "replica_grad_norm",
            "clip_norm", "moment1", "routing", "routing_step2",
            "expert_bytes", "replica_expert_bytes")}})
        for i in range(2):
            got, want = res["losses"][i], res["replica_losses"][i]
            assert abs(got - want) <= HYBRID_LOSS_RTOL * abs(want), \
                (name, i, got, want)
        assert res["worst_share"] >= HYBRID_PARAM_SHARE, res
        assert res["replica_grad_norm"] > HYBRID_CLIP, res
        assert abs(res["grad_norm"] / res["replica_grad_norm"] - 1) <= \
            HYBRID_M1_SCALE_TOL, res
        # MoE: step 1's parameters differ from the replica's by an ulp
        # here and there, and bf16 logits put near-ties within that, so
        # step 2 routes (and drops) other tokens on the two sides:
        # its moments are reported (routing_step2), not held
        for mc in res["moment1"][:1 if moe else 2]:
            assert mc["worst_rel_err"] <= HYBRID_M1_RTOL, res
            assert abs(mc["worst_tensor_scale"] - 1) <= \
                HYBRID_M1_TENSOR_SCALE_TOL, res
            assert abs(mc["scale"] - 1) <= HYBRID_M1_SCALE_TOL, res
    if moe:
        # every ep rank holds half the experts: against the replica's
        # bytes (rank 0 measured them) and the configuration's
        h, f = cfg.hidden_size, cfg.ffn_hidden_size
        whole = res.get("replica_expert_bytes") or (
            cfg.num_layers * cfg.moe_num_experts * (2 * h * f + f + h) * 2)
        res["expert_share"] = res["expert_bytes"] / whole
        assert res["expert_share"] <= EP_EXPERT_SHARE, res
    del init, after1, m1
    _free_memory(dev)
    return res


def parallel_worker(out_dir) -> int:
    """One rank of the parallel phase (started by the launcher)."""
    import torch

    import paddle_tpu_torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = dist.init_parallel_env()
    rank, dev = env.rank, env.device
    assert env.world_size == 2 and dev == torch.device("cuda", 0), \
        (env.world_size, dev)
    runs = []
    for name, axes, dtype, batch, tr_kw, moe in PARALLEL_RUNS:
        t0 = time.perf_counter()
        r = parallel_run(dev, rank, name, axes, dtype, batch, tr_kw, moe)
        r["seconds"] = time.perf_counter() - t0
        runs.append(r)
    for r in runs:
        r.pop("_kept", None)
    res = {"rank": rank, "runs": runs, "foreign_modules": sorted(
        m for m in sys.modules if m == "jax" or m.startswith("jax.")
        or m == "paddle_tpu" or m.startswith("paddle_tpu."))}
    assert not res["foreign_modules"], res["foreign_modules"]
    dist.barrier()
    with open(os.path.join(out_dir, f"parallel.{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def parallel_phase(dev, timeout=600):
    """Launch the parallel phase's two ranks on this card over gloo; read
    and check their results. Returns (the ranks' summed launch counts,
    {}); each run's own counts go to PARALLEL_RUN_COUNTS."""
    res, wall = _run_ranks(dev, "--parallel-worker", "parallel", timeout)
    counts = {k: sum(run["launches"][k] for r in res for run in r["runs"])
              for k in LAUNCH_COUNTERS}
    tc = ("flash_tc", "bwd_dq_tc", "bwd_dkv_tc")
    f32_route = ("flash", "bwd_single", "bwd_dq", "bwd_dkv")
    for i, run in enumerate(res[0]["runs"]):
        PARALLEL_RUN_COUNTS[run["run"]] = {
            k: sum(r["runs"][i]["launches"][k] for r in res)
            for k in LAUNCH_COUNTERS}
    for r in res:
        for run in r["runs"]:
            emit({"parallel": "run", "rank": r["rank"], **run})
            # the sp run's chunks are S 1024: the merged backward
            need = ("flash_tc", "bwd_single_tc") if run["run"] == "sp2" \
                else tc
            for k in need:
                assert run["launches"][k] > 0, (r["rank"], run["run"], k)
            for k in f32_route:
                assert run["launches"][k] == 0, (r["rank"], run["run"], k)
    pp = res[0]["runs"][0]
    emit({"parallel": "phase", "seconds": wall, "launches": counts,
          "launches_by_run": PARALLEL_RUN_COUNTS,
          "step_ms": {run["run"]: [r["runs"][i]["step_ms"] for r in res]
                      for i, run in enumerate(res[0]["runs"])},
          "collective_bytes": {run["run"]: run["collective_stats"][
              "total_bytes"] for run in res[0]["runs"]},
          "busy_frac": {run["run"]: [r["runs"][i]["trace"]["busy_frac"]
                                     for r in res]
                        for i, run in enumerate(res[0]["runs"])},
          "pp_bubble": pp["expected"]["bubble"],
          "pp_idle_frac": [r["runs"][0]["trace"]["idle_frac"]
                           for r in res]})
    return counts, {}


# ---------------------------------------------------------------------------
# resume phase: checkpoints, the elastic restart and host offload
# ---------------------------------------------------------------------------
#: the resume phase's global batch and each elastic child's steps
RESUME_BATCH = (4, 2048)
RESUME_STEPS = 6
#: a resumed (or restored) run's loss may differ from an uninterrupted
#: run's by the two uninterrupted runs' spread, or by this share of the
#: loss where that spread is smaller: the card's bf16 atomics sum the
#: embedding's gradient in another order on each run (ROADMAP queue 3
#: item 5), so two runs from the same state need not agree bit for bit
RESUME_SPREAD_FLOOR = 1e-3
#: the offload variants (3 steps each from one seed), held to the
#: resident run
RESUME_OFFLOAD = (
    ("resident", {}),
    ("offload_optimizer", {"offload_optimizer": True}),
    ("offload_params_stream", {"offload_params": True,
                               "offload_optimizer": True,
                               "stream_layers": True, "offload_depth": 2}),
    ("offload_params_stream_conservative", {
        "offload_params": True, "offload_optimizer": True,
        "stream_layers": True, "offload_depth": 2,
        "conservative_fetch": True}))


def _resume_trainer(dev, seed=21, **kw):
    """(trainer, config): GPT at gpt3_1_3b widths cut to DIST_LAYERS
    layers under the train recipe (amp, recompute, bf16 parameters and
    moments, AdamW with the global-norm clip) on one rank; ``kw``: more
    of the trainer's knobs (the offload ones)."""
    import dataclasses

    import paddle_tpu_torch
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig

    cfg = dataclasses.replace(GPTConfig.gpt3_1_3b(), num_layers=DIST_LAYERS)
    paddle_tpu_torch.seed(seed)
    return _hybrid_trainer(GPT(cfg, device=dev), None, 0, "bfloat16",
                           **kw), cfg


def _resume_batch(cfg, cursor):
    """The resume phase's batch at data cursor ``cursor`` (host int64)."""
    import numpy as np

    rng = np.random.RandomState(1000 + cursor)
    return (rng.randint(0, cfg.vocab_size, RESUME_BATCH).astype(np.int64),)


def _state_pieces(st):
    """Every Sharded piece of a device_state tree, by key."""
    from paddle_tpu_torch.utils.tree import flatten

    return dict(flatten(st))


def _digest(st) -> dict:
    """Each piece of a device_state tree by its bits: their sum and their
    sum weighted by position, in int64 (wrapping; integer sums do not
    depend on order), so bit-equal states give equal digests."""
    import torch

    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}
    for k, p in _state_pieces(st).items():
        w = p.data.detach().reshape(-1).view(
            ints[p.data.element_size()]).to(torch.int64)
        pos = torch.arange(w.numel(), device=w.device) % 65521 + 1
        out[k] = [int(w.sum()), int((w * pos).sum())]
    return out


def resume_sync_check(dev, d) -> dict:
    """(r1): one step, a sync save of ``device_state`` to ``d``, a restore
    into a fresh trainer from other weights (every tensor bit-equal to
    the saved one), then one more step on both (losses within
    RESUME_SPREAD_FLOOR). Save and restore GB/s over the state's bytes
    (the restore read warm from the page cache)."""
    import torch

    from paddle_tpu_torch.distributed import checkpoint as dck

    tr, cfg = _resume_trainer(dev)
    tr.step(*_resume_batch(cfg, 0))
    want = _state_pieces(tr.device_state())
    nbytes = sum(p.data.numel() * p.data.element_size()
                 for p in want.values())
    _sync(dev)
    t0 = time.perf_counter()
    dck.save(d, tr.device_state(), step=1, async_=False)
    save_s = time.perf_counter() - t0
    tr2, _ = _resume_trainer(dev, seed=22)
    _sync(dev)
    t0 = time.perf_counter()
    got = dck.restore(d, tr2.device_state(), verify=False)
    tr2.load_device_state(got, step=1)
    _sync(dev)
    restore_s = time.perf_counter() - t0
    back = _state_pieces(tr2.device_state())
    differ = [k for k, p in want.items() if not torch.equal(p.data,
                                                             back[k].data)]
    assert not differ, differ[:8]
    batch = _resume_batch(cfg, 1)
    l1, l2 = float(tr.step(*batch)), float(tr2.step(*batch))
    assert abs(l1 - l2) <= RESUME_SPREAD_FLOOR * abs(l1), (l1, l2)
    out = {"resume": "sync", "state_bytes": nbytes, "pieces": len(want),
           "save_s": save_s, "restore_s": restore_s,
           "save_GBps": nbytes / save_s / 1e9,
           "restore_GBps": nbytes / restore_s / 1e9,
           "restore_read": "warm (page cache)",
           "step2_losses": [l1, l2]}
    del tr, tr2, want, back, got
    _free_memory(dev)
    return out


def resume_worker(out_dir, dev=None) -> int:
    """One life of the elastic run (the resume phase starts it): the
    ElasticTrainer loop on this card with save_interval 2, prefetch_depth
    2, async_dispatch and snapshot_async, ``RESUME_STEPS`` steps; each
    drained loss appended to ``out_dir/losses.log``, and before each save
    the step, the data cursor and the digest of the state it saves
    (``_digest``) to ``out_dir/saves.log``. At the end a sync save of the
    same state times the stall a blocking save costs. Writes
    ``out_dir/life.json`` (launch counts, the step it resumed from, the
    restored state's digest, the data cursor each step trained on,
    whether the first batch after a resume is its cursor's batch, the
    snapshot and sync stalls, the prefetch-depth gauge at each step)."""
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.distributed import checkpoint as dck
    from paddle_tpu_torch.distributed.elastic import ElasticTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = dev or torch.device("cuda", 0)
    interval = int(os.environ.get("RESUME_SAVE_INTERVAL", "2"))
    tr, cfg = _resume_trainer(dev)
    el = ElasticTrainer(tr, os.path.join(out_dir, "ckpt"),
                        save_interval=interval, keep=2, prefetch_depth=2,
                        async_dispatch=True, snapshot_async=True)
    reg = profiler.registry()
    profiler.enable(reset=False)
    depth = []
    log = open(os.path.join(out_dir, "losses.log"), "a")

    def on_step(step, loss):
        depth.append(reg.gauge("elastic/prefetch_depth").value)
        log.write(f"{step},{loss!r}\n")
        log.flush()
        os.fsync(log.fileno())

    resumed, save_ms, cursors, first = [], [], {}, {}
    resume, save, step = el.resume, el.save, tr.step
    saves = open(os.path.join(out_dir, "saves.log"), "a")

    def timed_save(at, *a, **k):
        saves.write(json.dumps({"step": at, "cursor": el.data_cursor,
                                "digest": _digest(tr.device_state())})
                    + "\n")
        saves.flush()
        os.fsync(saves.fileno())
        t0 = time.perf_counter()
        h = save(at, *a, **k)
        save_ms.append((time.perf_counter() - t0) * 1e3)
        return h

    def digested_resume(*a, **k):
        resumed.append(resume(*a, **k))
        first["digest"] = _digest(tr.device_state())
        return resumed[-1]

    def traced_step(*batch):
        cursors[tr._step] = el.data_cursor
        if "batch_equal" not in first:
            want = torch.from_numpy(_resume_batch(cfg, el.data_cursor)[0])
            first["batch_equal"] = torch.equal(batch[0].cpu(), want)
        return step(*batch)

    el.resume, el.save, tr.step = digested_resume, timed_save, traced_step
    stall = reg.counter("ckpt/stall_ms")
    set_counts()
    s0 = stall.value
    el.run(lambda c: _resume_batch(cfg, c), RESUME_STEPS, on_step=on_step)
    snap_stall = stall.value - s0
    counts, _ = read_counts()
    profiler.disable()
    sync_ms = None
    if os.environ.get("RESUME_SYNC_SAVE") == "1":
        _sync(dev)
        t0 = time.perf_counter()
        dck.save(os.path.join(out_dir, "sync"), tr.device_state(), step=1,
                 async_=False)
        sync_ms = (time.perf_counter() - t0) * 1e3
    res = {"resumed": resumed[0], "launches": counts,
           "resumed_digest": first["digest"], "cursors": cursors,
           "first_batch_equal": first["batch_equal"],
           "prefetch_depth": depth, "snapshot_stall_ms": snap_stall,
           "save_call_ms": save_ms, "sync_save_ms": sync_ms,
           "loss_syncs": el.loss_syncs,
           "foreign_modules": sorted(
               m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "paddle_tpu" or m.startswith("paddle_tpu."))}
    assert not res["foreign_modules"], res["foreign_modules"]
    with open(os.path.join(out_dir, "life.json"), "w") as f:
        json.dump(res, f)
    return 0


def _life(out_dir, interval=2, sync_save=False):
    """Start one life of the elastic run (``--resume-worker out_dir``)."""
    env = dict(os.environ, OMP_NUM_THREADS="4",
               RESUME_SAVE_INTERVAL=str(interval),
               RESUME_SYNC_SAVE="1" if sync_save else "0",
               PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    log = open(os.path.join(out_dir, "stdout.log"), "a")
    return subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"),
         "--resume-worker", out_dir], env=env, cwd=HERE,
        stdout=log, stderr=subprocess.STDOUT, start_new_session=True)


def _life_losses(out_dir) -> dict:
    path = os.path.join(out_dir, "losses.log")
    out = {}
    if os.path.exists(path):
        for line in open(path):
            s, v = line.strip().split(",")
            out[int(s)] = float(v)
    return out


def _join(p, out_dir, timeout):
    import signal

    try:
        rc = p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.wait()
        rc = "timeout"
    if rc != 0:
        with open(os.path.join(out_dir, "stdout.log")) as f:
            print(f"--- resume life {out_dir} ---\n" + f.read()[-4000:],
                  file=sys.stderr)
        raise AssertionError(f"a resume life exited {rc}")
    with open(os.path.join(out_dir, "life.json")) as f:
        return json.load(f)


def _saves(out_dir) -> dict:
    """``saves.log`` of a life: {step: {"cursor", "digest"}}."""
    out = {}
    path = os.path.join(out_dir, "saves.log")
    if os.path.exists(path):
        for line in open(path):
            if line.endswith("\n"):
                rec = json.loads(line)
                out[rec["step"]] = rec
    return out


def resume_elastic_check(dev, root, timeout=400) -> tuple:
    """(r2): an uninterrupted life (A) beside one SIGKILLed once step 3 is
    logged and a step is committed (B); B started again must resume from
    the newest committed step, with the state B saved there bit for bit
    (their digests), the data cursor B saved there, which is A's cursor
    at that step, and that cursor's batch. A second uninterrupted life
    (A', saving only at the end) beside it gives the spread: B's losses
    from its resumed step lie within max(|A - A'|, RESUME_SPREAD_FLOOR ·
    |A|) of A's. Returns (result, the completed lives' summed launch
    counts)."""
    import shutil
    import signal

    from paddle_tpu_torch.distributed import checkpoint as dck

    dirs = {k: os.path.join(root, k) for k in ("a", "a2", "b")}
    for d in dirs.values():
        os.makedirs(d)
    t0 = time.perf_counter()
    pa_, pb = _life(dirs["a"], sync_save=True), _life(dirs["b"])
    deadline = time.time() + timeout
    ckpt_b = os.path.join(dirs["b"], "ckpt")
    while len(_life_losses(dirs["b"])) < 4 or \
            dck.latest_step(ckpt_b) is None:
        assert pb.poll() is None, "life B ended before it was killed"
        assert time.time() < deadline, "life B logged no step 3"
        time.sleep(0.05)
    os.killpg(pb.pid, signal.SIGKILL)
    pb.wait()
    killed_at = len(_life_losses(dirs["b"]))
    newest = dck.latest_step(ckpt_b)
    saved_b = _saves(dirs["b"])
    lives = [_join(pa_, dirs["a"], timeout)]
    shutil.rmtree(os.path.join(dirs["a"], "ckpt"), ignore_errors=True)
    shutil.rmtree(os.path.join(dirs["a"], "sync"), ignore_errors=True)
    pa2, pb2 = _life(dirs["a2"], interval=RESUME_STEPS), _life(dirs["b"])
    lives += [_join(pa2, dirs["a2"], timeout), _join(pb2, dirs["b"],
                                                     timeout)]
    wall = time.perf_counter() - t0
    la, la2, lb = (_life_losses(dirs[k]) for k in ("a", "a2", "b"))
    assert lives[2]["resumed"] == newest and newest is not None, \
        (lives[2]["resumed"], newest)
    b2, at_save = lives[2], saved_b[newest]
    differ = [k for k, v in at_save["digest"].items()
              if b2["resumed_digest"].get(k) != v]
    assert not differ and len(b2["resumed_digest"]) == len(
        at_save["digest"]), differ[:8]
    cur_a = {int(k): v for k, v in lives[0]["cursors"].items()}
    cur_b = {int(k): v for k, v in b2["cursors"].items()}
    assert cur_b[newest] == at_save["cursor"] == cur_a[newest], \
        (cur_b, at_save["cursor"], cur_a)
    assert all(cur_b[s] == cur_a[s] for s in cur_b), (cur_b, cur_a)
    assert b2["first_batch_equal"], b2["first_batch_equal"]
    a_state = _saves(dirs["a"]).get(newest, {}).get("digest")
    worst = 0.0
    for s in range(newest, RESUME_STEPS):
        spread = max(abs(la[s] - la2[s]), RESUME_SPREAD_FLOOR * abs(la[s]))
        worst = max(worst, abs(lb[s] - la[s]) / spread)
        assert abs(lb[s] - la[s]) <= spread, (s, lb[s], la[s], la2[s])
    res = {"resume": "elastic", "killed_after_losses": killed_at,
           "resumed_from": newest, "losses_a": [la[s] for s in sorted(la)],
           "losses_a2": [la2[s] for s in sorted(la2)],
           "losses_b": [lb[s] for s in sorted(lb)],
           "worst_over_spread": worst, "wall_s": wall,
           "restored_state_bit_equal_to_saved": True,
           "restored_pieces": len(b2["resumed_digest"]),
           "resumed_cursor": cur_b[newest],
           "a_state_equal_at_resumed_step": a_state == at_save["digest"],
           "snapshot_stall_ms": lives[0]["snapshot_stall_ms"],
           "snapshot_save_call_ms": lives[0]["save_call_ms"],
           "sync_save_ms": lives[0]["sync_save_ms"],
           "prefetch_depth": lives[0]["prefetch_depth"],
           "loss_syncs": lives[0]["loss_syncs"],
           "launches_by_life": [l["launches"] for l in lives]}
    counts = {k: sum(l["launches"][k] for l in lives)
              for k in LAUNCH_COUNTERS}
    for l in lives:
        for k in ("flash_tc", "bwd_dq_tc", "bwd_dkv_tc"):
            assert l["launches"][k] > 0, (k, l["launches"])
        for k in ("flash", "bwd_single", "bwd_dq", "bwd_dkv"):
            assert l["launches"][k] == 0, (k, l["launches"])
    return res, counts


#: the caching allocator may hand a tensor a block up to 1 MiB larger
#: than it asked for (a large block is not split when less would
#: remain): the measured byte checks allow that much a tensor
RESUME_BLOCK_SLACK = 2 ** 20


def _offload_plan(tr) -> dict:
    """Bytes of the offloaded state, from the tensors themselves: what
    leaves the card between steps (the host moments, plus the host
    masters less the compute copies that stay), the largest group's
    streamed working set (its masters and moments on the card) and the
    first ``offload_depth`` groups' (the prefetch), and the number of
    offloaded tensors."""
    upd = tr._upd

    def nb(t):
        return t.numel() * t.element_size()

    def working(i):
        b = sum(nb(v) for v in upd.states[i].values()) \
            if upd.offload_optimizer else 0
        return b + (nb(upd.master[i]) if upd.master[i] is not None else 0)

    groups = [sum(working(i) for i in g) for g in upd.groups]
    off = sum(nb(v) for st in upd.states for v in st.values()) \
        if upd.offload_optimizer else 0
    off += sum(nb(m) - nb(p.data) for p, m in zip(upd.params, upd.master)
               if m is not None)
    n = sum(len(st) for st in upd.states) if upd.offload_optimizer else 0
    n += sum(m is not None for m in upd.master)
    return {"offloaded_bytes": off, "largest_group_bytes": max(groups),
            "prefetch_bytes": sum(groups[:upd.depth]), "tensors": n,
            "depth": upd.depth, "groups": len(groups)}


def _measured_step(tr, tok, dev) -> dict:
    """One step with the card's allocated bytes sampled: between steps
    (before it), the forward and backward's peak, at the update's entry,
    and the update's peak (``torch.cuda`` allocator statistics; the
    update is wrapped with a synchronize on each side)."""
    import torch

    upd = tr._upd
    getattr(upd, "host_sync", lambda: None)()
    _sync(dev)
    mem = {"between_steps": torch.cuda.memory_allocated(dev)}
    torch.cuda.reset_peak_memory_stats(dev)
    update = upd.update

    def sampled(*a, **k):
        _sync(dev)
        mem["fwd_bwd_peak"] = torch.cuda.max_memory_allocated(dev)
        mem["update_entry"] = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        update(*a, **k)
        _sync(dev)
        mem["update_peak"] = torch.cuda.max_memory_allocated(dev)

    upd.update = sampled
    try:
        mem["loss"] = float(tr.step(tok))
    finally:
        del upd.update
    return mem


def resume_offload_check(dev) -> dict:
    """(r3): each RESUME_OFFLOAD variant 4 steps from one seed, held to
    the resident run: losses within RESUME_SPREAD_FLOOR, the parameters
    after step 1 within one bf16 ulp on HYBRID_PARAM_SHARE of each
    tensor's elements. Each variant's warm step ms (the third step) and
    memory_ledger (an estimate: the schedule's bound, not a reading).
    The fourth step is measured on the card (``_measured_step``) and held
    to the resident run's: between steps the card holds at least the
    offloaded bytes less (the moments and masters are on the host); the
    update's rise over the between-steps bytes exceeds the resident
    update's by at most offload_depth + 1 groups' working sets (the
    groups in flight: the one updating, the depth fetched ahead); and
    conservative_fetch's forward and backward peak lies below the free
    schedule's by the prefetched groups."""
    import torch

    cuda = dev.type == "cuda"
    rows, base, base_p, fails = [], None, None, []
    for name, kw in RESUME_OFFLOAD:
        _free_memory(dev)
        tr, cfg = _resume_trainer(dev, **kw)
        losses, ms = [], []
        for i in range(3):
            loss, t = _timed_step(tr, _resume_batch(cfg, i)[0], dev)
            losses.append(loss)
            ms.append(t)
            if i == 0:
                # host copies: the card holds no more than the run itself
                after1 = {k: p.data.to("cpu", copy=True) for k, p in
                          _state_pieces(tr.device_state()).items()
                          if k.startswith("params/")}
        tok = _resume_batch(cfg, 3)[0]
        if cuda:
            mem = _measured_step(tr, tok, dev)
            losses.append(mem.pop("loss"))
        else:
            mem = None
            losses.append(float(tr.step(tok)))
        led = tr.memory_ledger()
        row = {"resume": "offload", "variant": name, "knobs": kw,
               "losses": losses, "step_ms": ms, "warm_step_ms": ms[2],
               "measured_bytes": mem, "ledger_estimate": led,
               "ledger_device_bytes": sum(
                   v for k, v in led.items() if not k.startswith("host_")),
               "ledger_host_bytes": sum(
                   v for k, v in led.items() if k.startswith("host_"))}
        if base is None:
            base, base_p = row, after1
        else:
            worst = 1.0
            for k, w in base_p.items():
                g = after1[k].to(dev).float()
                w = w.to(dev).float()
                ok = (g - w).abs() <= HYBRID_BF16_ULP * torch.maximum(
                    g.abs(), w.abs())
                worst = min(worst, float(ok.float().mean()))
            row["worst_share"] = worst
            assert worst >= HYBRID_PARAM_SHARE, (name, worst)
            for a, b in zip(losses, base["losses"]):
                assert abs(a - b) <= RESUME_SPREAD_FLOOR * abs(b), \
                    (name, losses, base["losses"])
            plan = _offload_plan(tr)
            row["plan"] = plan
            if cuda:
                fails += _offload_memory_checks(row, base, rows, plan)
        rows.append(row)
        emit(row)
        del tr, after1
    del base_p
    _free_memory(dev)
    # every variant's row is printed before a failed byte check stops it
    assert not fails, fails
    return {"resume": "offload", "variants": [r["variant"] for r in rows],
            "warm_step_ms": {r["variant"]: r["warm_step_ms"] for r in rows},
            "measured_bytes": {r["variant"]: r["measured_bytes"]
                               for r in rows}}


def _offload_memory_checks(row, base, rows, plan) -> list:
    """The measured checks of ``resume_offload_check`` on one variant's
    row against the resident run's (``base``) and, for
    conservative_fetch, the free schedule's (in ``rows``); returns the
    failed ones."""
    got, res = row["measured_bytes"], base["measured_bytes"]
    slack = plan["tensors"] * RESUME_BLOCK_SLACK
    saved = res["between_steps"] - got["between_steps"]
    rise = (got["update_peak"] - got["between_steps"]) - \
        (res["update_peak"] - res["between_steps"])
    window = (plan["depth"] + 1) * plan["largest_group_bytes"]
    checks = row["memory_checks"] = {
        "saved_between_steps": saved, "update_rise_over_resident": rise,
        "window_bound": window, "slack": slack}
    fails = []
    if saved < plan["offloaded_bytes"] - slack:
        fails.append((row["variant"], "saved_between_steps", checks))
    if rise > window + slack:
        fails.append((row["variant"], "update_rise", checks))
    if row["knobs"].get("conservative_fetch"):
        free = next(r for r in rows if r["knobs"].get("stream_layers")
                    and not r["knobs"].get("conservative_fetch"))
        lower = free["measured_bytes"]["fwd_bwd_peak"] - \
            got["fwd_bwd_peak"]
        checks["fwd_bwd_peak_below_free"] = lower
        if lower < plan["prefetch_bytes"] - slack:
            fails.append((row["variant"], "fwd_bwd_peak", checks))
    return fails


def resume_phase(dev, timeout=400) -> tuple:
    """(r1) the sync save and restore, (r2) the elastic restart in child
    processes, (r3) the offload variants; checkpoints under a temporary
    directory the phase deletes. Returns (the phase's launch counts, this
    process's and the completed lives', {})."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="resume_phase_")
    t0 = time.perf_counter()
    try:
        set_counts()
        r1 = resume_sync_check(dev, os.path.join(root, "sync"))
        emit(r1)
        shutil.rmtree(os.path.join(root, "sync"), ignore_errors=True)
        r3 = resume_offload_check(dev)
        own, _ = read_counts()
        r2, lives = resume_elastic_check(dev, os.path.join(root, "elastic"),
                                         timeout)
        emit(r2)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    counts = {k: own[k] + lives[k] for k in LAUNCH_COUNTERS}
    emit({"resume": "phase", "seconds": time.perf_counter() - t0,
          "launches": counts, "offload_warm_step_ms": r3["warm_step_ms"],
          "offload_measured_bytes": r3["measured_bytes"]})
    return counts, {}


# ---------------------------------------------------------------------------
# resilience phase: the bad-step guard, the runner, preemption, the watchdog
# ---------------------------------------------------------------------------
#: GPT at gpt3_1_3b widths cut to RESIL_LAYERS layers under the train
#: recipe (amp, recompute, bf16 parameters and moments, AdamW at
#: RESIL_LR with the global-norm clip at RESIL_CLIP), global batch
#: RESIL_BATCH
RESIL_LAYERS = 2
RESIL_BATCH = (4, 2048)
RESIL_LR = 1e-4
RESIL_CLIP = 1.0
#: the runner's chaos plan (a NaN streak of K = RESIL_K at cursors 3-5,
#: one failed fetch of cursor 6), its save interval and its steps
RESIL_NAN = (3, 4, 5)
RESIL_FLAKY = {6: 1}
RESIL_K = 3
RESIL_SAVE = 3
RESIL_STEPS = 8
#: (s1)'s timed pairs of warm steps, guarded and not, interleaved
RESIL_TIMED = 4
#: the cursor the preempted life waits at for the parent's SIGTERM: the
#: batch of step 6 (the streak's cursors are skipped), after the
#: rollback's replay and the commit at step 6, so the preemption commits
#: step 7, outside any bad streak
RESIL_PREEMPT_CURSOR = 9
RESIL_PREEMPT_COMMIT = RESIL_PREEMPT_CURSOR - len(RESIL_NAN) + 1
#: the watchdog's life: timeout, the first step's grace (a cold step on
#: the card took 8.6-13.2 s in the disagg and hybrid phases), jitter,
#: the step whose batch is followed on the stream by a torch.cuda._sleep
#: of RESIL_HANG_S (the host then blocks in the loss sync)
RESIL_WD_TIMEOUT_S = 2.0
RESIL_WD_GRACE_S = 60.0
RESIL_WD_JITTER = 0.1
RESIL_HANG_STEP = 2
RESIL_HANG_S = 6.0
RESIL_COUNTERS = ("resilience/steps_skipped", "resilience/rollbacks",
                  "resilience/restore_fallbacks", "resilience/preemptions",
                  "resilience/data_retries", "resilience/watchdog_fires")


def _resil_trainer(dev, cfg, guard=True, seed=31):
    """The phase's guarded trainer on ``cfg`` (one rank, degree 1)."""
    import paddle_tpu_torch
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.hybrid import HybridPipelineTrainer
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.optimizer import AdamW

    paddle_tpu_torch.seed(seed)
    model = GPT(cfg, device=dev)
    opt = AdamW(RESIL_LR, parameters=model.named_parameters(),
                weight_decay=0.1,
                grad_clip=tnn.ClipGradByGlobalNorm(RESIL_CLIP))
    s = DistributedStrategy()
    s.amp = s.recompute = True
    return HybridPipelineTrainer(model, opt, s, n_micro=2,
                                 param_dtype="bfloat16",
                                 moment_dtype="bfloat16",
                                 guard_bad_steps=guard)


def _resil_spec(root) -> tuple:
    """(GPTConfig, global batch, device) of the phase (``spec.json``)."""
    import torch

    from paddle_tpu_torch.models.gpt import GPTConfig

    with open(os.path.join(root, "spec.json")) as f:
        spec = json.load(f)
    return (GPTConfig(**spec["config"]), tuple(spec["batch"]),
            torch.device(spec["device"]))


def _resil_batch(cfg, batch, cursor):
    import numpy as np

    rng = np.random.RandomState(3000 + cursor)
    return (rng.randint(0, cfg.vocab_size, batch).astype(np.int64),)


def _state_sha1(tr) -> str:
    """SHA-1 over every piece of ``device_state``'s bytes, in key order."""
    import hashlib

    import torch

    h = hashlib.sha1()
    for k, p in sorted(_state_pieces(tr.device_state()).items()):
        h.update(k.encode())
        h.update(p.data.detach().contiguous().reshape(-1)
                 .view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def resil_guard_check(dev, cfg, batch) -> dict:
    """(s1): a cold step, two warm ones, RESIL_TIMED pairs of warm steps
    with the guard and without it in turn (the same trainer: the knob is
    read each step), then a step after ``inject_fault_scale(nan)``: NaN
    loss, ``last_step_ok`` False, the SHA-1 of ``device_state`` unchanged;
    the next clean step's verdict True."""
    import math
    import statistics

    tr = _resil_trainer(dev, cfg)
    data = functools.partial(_resil_batch, cfg, batch)
    cold = _timed_step(tr, data(0)[0], dev)[1]
    for c in (1, 2):
        tr.step(*data(c))
    ms = {"guarded": [], "unguarded": []}
    c = 3
    for _ in range(RESIL_TIMED):
        for mode in ms:
            tr.guard_bad_steps = mode == "guarded"
            ms[mode].append(_timed_step(tr, data(c)[0], dev)[1])
            c += 1
    tr.guard_bad_steps = True
    before = _state_sha1(tr)
    tr.inject_fault_scale(float("nan"))
    loss = float(tr.step(*data(c)))
    ok = tr.last_step_ok
    after = _state_sha1(tr)
    if not (math.isnan(loss) and ok is False and before == after):
        raise AssertionError(f"resilience (s1): loss {loss}, verdict {ok}, "
                             f"sha1 {before} -> {after}")
    tr.step(*data(c + 1))
    if not tr.last_step_ok:
        raise AssertionError("resilience (s1): the clean step after the "
                             "poisoned one was judged bad")
    med = {k: statistics.median(v) for k, v in ms.items()}
    out = {"resilience": "guard", "cold_step_ms": cold,
           "warm_step_ms": ms, "median_ms": med,
           "guard_cost": med["guarded"] / med["unguarded"] - 1.0,
           "poisoned_loss": repr(loss), "verdict": ok,
           "state_sha1": before, "state_sha1_after": after,
           "state_bytes": sum(p.data.numel() * p.data.element_size()
                              for p in _state_pieces(
                                  tr.device_state()).values())}
    del tr
    _free_memory(dev)
    return out


def _resil_run(tr, cfg, batch, ckpt, dev, gate=None, on_step=None):
    """``ResilientRunner`` over the chaos plan (RESIL_NAN, RESIL_FLAKY,
    K RESIL_K, save interval RESIL_SAVE) for RESIL_STEPS steps. ``gate``
    wraps the data function. Returns the run's record: losses, the
    rollbacks, the skipped cursors, the step each resume restored and
    its ms (sync before and after), each save call's ms, the
    ``resilience/*`` counters' moves."""
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.resilience import (ResilienceConfig,
                                             ResilientRunner, chaos)

    runner = ResilientRunner(
        tr, ckpt, save_interval=RESIL_SAVE,
        config=ResilienceConfig(bad_step_limit=RESIL_K,
                                data_retry_base_delay=0.01),
        chaos=chaos.ChaosPlan(nan_cursors=RESIL_NAN,
                              flaky_cursors=RESIL_FLAKY))
    el = runner.elastic
    restored, restore_ms, saves = [], [], []
    resume, save = el.resume, el.save

    def timed_resume(*a, **k):
        _sync(dev)
        t0 = time.perf_counter()
        restored.append(resume(*a, **k))
        _sync(dev)
        restore_ms.append((time.perf_counter() - t0) * 1e3)
        return restored[-1]

    def timed_save(step, *a, **k):
        _sync(dev)
        t0 = time.perf_counter()
        h = save(step, *a, **k)
        saves.append({"step": step, "async": k.get("async_", True),
                      "ms": (time.perf_counter() - t0) * 1e3})
        return h

    el.resume, el.save = timed_resume, timed_save
    reg = registry()
    c0 = {n: reg.counter(n).value for n in RESIL_COUNTERS}
    data = functools.partial(_resil_batch, cfg, batch)
    t0 = time.perf_counter()
    res = runner.run(gate(runner, data) if gate else data, RESIL_STEPS,
                     on_step=on_step)
    return {"losses": {str(s): v for s, v in sorted(res.losses.items())},
            "rollbacks": res.rollbacks, "skips": sorted(runner._skips),
            "preempted": res.preempted, "exit_code": res.exit_code,
            "start_step": res.start_step, "final_step": res.final_step,
            "restored": restored, "restore_ms": restore_ms,
            "saves": saves, "wall_s": time.perf_counter() - t0,
            "counters": {n: reg.counter(n).value - c0[n]
                         for n in RESIL_COUNTERS}}


def _resil_gate(out_dir):
    """The preempted life's data function: at RESIL_PREEMPT_CURSOR it
    writes ``ready`` and waits for the parent's SIGTERM to be flagged."""
    def gate(runner, data):
        def fetch(cursor):
            if cursor == RESIL_PREEMPT_CURSOR:
                open(os.path.join(out_dir, "ready"), "w").close()
                deadline = time.time() + 120
                while not runner.preemption.requested and \
                        time.time() < deadline:
                    time.sleep(0.01)
            return data(cursor)
        return fetch
    return gate


def resilience_worker(out_dir, mode) -> int:
    """One life of the resilience phase (``--resilience-worker DIR
    MODE``): ``preempt`` runs the chaos plan on ``DIR/ckpt`` and waits at
    RESIL_PREEMPT_CURSOR for the parent's SIGTERM (exit 75 once the
    preemption commit lands); ``restart`` resumes it; ``watchdog`` runs
    with the watchdog (RESIL_WD_*, abort on) and a sink, and at step
    RESIL_HANG_STEP queues RESIL_HANG_S of ``torch.cuda._sleep`` behind
    the step (the watchdog ends the process with 74). Each writes
    ``DIR/<mode>.json``; the counts and step times as it goes."""
    import torch

    from paddle_tpu_torch import profiler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = os.path.dirname(out_dir)
    cfg, batch, dev = _resil_spec(root)
    tr = _resil_trainer(dev, cfg)
    prog = os.path.join(out_dir, f"{mode}.steps.json")
    times = []
    t_start = time.time()

    def on_step(step, loss):
        times.append((step, time.time()))
        with open(prog + ".tmp", "w") as f:
            json.dump({"t_start": t_start, "steps": times,
                       "launches": read_counts()[0]}, f)
        os.replace(prog + ".tmp", prog)

    set_counts()
    if mode != "watchdog":
        rec = _resil_run(tr, cfg, batch, os.path.join(out_dir, "ckpt"), dev,
                         gate=_resil_gate(out_dir) if mode == "preempt"
                         else None, on_step=on_step)
    else:
        from paddle_tpu_torch.resilience import (ResilienceConfig,
                                                 ResilientRunner)

        profiler.enable_sink(os.path.join(out_dir, "sink"),
                             interval_s=3600.0, per_rank_subdir=False)
        profiler.enable(reset=False)
        runner = ResilientRunner(
            tr, os.path.join(out_dir, "ckpt"), save_interval=100,
            config=ResilienceConfig(
                watchdog_timeout_s=RESIL_WD_TIMEOUT_S,
                watchdog_first_grace_s=RESIL_WD_GRACE_S,
                watchdog_jitter=RESIL_WD_JITTER, watchdog_abort=True,
                watchdog_dump_file=os.path.join(out_dir, "dump.txt")))
        step = tr.step
        cycles = int(RESIL_HANG_S * 1e3 * _sleep_cycles_per_ms(dev)) \
            if dev.type == "cuda" else 0

        class _HeldLoss:
            """A CPU rehearsal's stand-in for a loss behind a sleeping
            kernel: its read blocks the host as the card's sync would."""

            def __init__(self, loss):
                self.loss = loss

            def __float__(self):
                time.sleep(RESIL_HANG_S)
                return float(self.loss)

        def hanging_step(*b):
            loss = step(*b)
            if tr._step == RESIL_HANG_STEP + 1:
                if cycles:
                    torch.cuda._sleep(cycles)
                else:
                    loss = _HeldLoss(loss)
                with open(os.path.join(out_dir, "hang_t"), "w") as f:
                    f.write(repr(time.time()))
            return loss

        tr.step = hanging_step
        res = runner.run(functools.partial(_resil_batch, cfg, batch),
                         RESIL_HANG_STEP + 2, on_step=on_step)
        rec = {"losses": {str(s): v for s, v in res.losses.items()}}
    rec.update(mode=mode, t_start=t_start, steps=times,
               launches=read_counts()[0], foreign_modules=sorted(
                   m for m in sys.modules if m == "jax"
                   or m.startswith("jax.") or m == "paddle_tpu"
                   or m.startswith("paddle_tpu.")))
    with open(os.path.join(out_dir, f"{mode}.json"), "w") as f:
        json.dump(rec, f)
    return rec.get("exit_code", 0)


def _resil_child(root, name, mode):
    """Start one life (``--resilience-worker root/name mode``)."""
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="4",
               PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    log = open(os.path.join(d, "stdout.log"), "a")
    return subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"),
         "--resilience-worker", d, mode], env=env, cwd=HERE,
        stdout=log, stderr=subprocess.STDOUT, start_new_session=True)


def _resil_join(p, d, want, timeout):
    """Wait for a life; it must exit ``want`` (its log's tail otherwise)."""
    import signal

    try:
        rc = p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.wait()
        rc = "timeout"
    if rc != want:
        with open(os.path.join(d, "stdout.log")) as f:
            print(f"--- resilience life {d} ---\n" + f.read()[-4000:],
                  file=sys.stderr)
        raise AssertionError(f"a resilience life exited {rc}, not {want}")


def _resil_json(path):
    with open(path) as f:
        return json.load(f)


def _resil_losses_held(got, want, spread, exact, what):
    """Every step of ``got`` within ``spread[step]`` of ``want`` (bit for
    bit when ``exact``)."""
    for s, v in got.items():
        w = want[s]
        if exact and v != w or abs(v - w) > spread[s]:
            raise AssertionError(f"resilience {what}: step {s} loss {v!r}, "
                                 f"uninterrupted {w!r} (spread "
                                 f"{spread[s]!r}, bitwise {exact})")


def resilience_phase(dev, cfg=None, batch=RESIL_BATCH, timeout=300) -> tuple:
    """(s1) the guard in this process; then the watchdog's life and the
    preempted life start while this process runs (s2), the
    uninterrupted chaos sequence, twice (the determinism check); (s3) the
    preempted life gets a real SIGTERM at its gate, commits and exits
    75, a byte of its newest shard is flipped and the restarted life
    walks back one step and finishes: its losses and the preempted
    life's held to (s2)'s, bitwise if (s2)'s two runs were bitwise equal,
    else within their spread (at least RESUME_SPREAD_FLOOR of the loss);
    (s4) the watchdog's life exits 74 with the stacks and the open span
    in its dump, a ``watchdog`` line in its sink, its cold first step
    unfired. Returns (the phase's launch counts, this process's and the
    lives', {})."""
    import dataclasses
    import math
    import shutil
    import signal
    import tempfile

    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.resilience import chaos

    cfg = cfg or dataclasses.replace(GPTConfig.gpt3_1_3b(),
                                     num_layers=RESIL_LAYERS)
    batch = tuple(batch)
    root = tempfile.mkdtemp(prefix="resilience_phase_")
    t0 = time.perf_counter()
    fails, procs = [], []
    try:
        with open(os.path.join(root, "spec.json"), "w") as f:
            json.dump({"config": dataclasses.asdict(cfg),
                       "batch": list(batch), "device": str(dev)}, f)
        set_counts()
        s1 = resil_guard_check(dev, cfg, batch)
        emit(s1)
        lives = {"watchdog": _resil_child(root, "wd", "watchdog"),
                 "preempt": _resil_child(root, "life", "preempt")}
        procs += lives.values()
        t_lives = time.perf_counter()
        runs = []
        for tag in ("a", "a2"):
            tr = _resil_trainer(dev, cfg)
            runs.append(_resil_run(tr, cfg, batch,
                                   os.path.join(root, "ckpt_" + tag), dev))
            del tr
            _free_memory(dev)
        own, _ = read_counts()
        a, a2 = runs
        exact = a["losses"] == a2["losses"]
        spread = {s: max(abs(v - a2["losses"][s]),
                         RESUME_SPREAD_FLOOR * abs(v))
                  for s, v in a["losses"].items()}
        nan = [float(c) for c in RESIL_NAN]
        for run in runs:
            if run["rollbacks"] != 1 or run["skips"] != list(RESIL_NAN) \
                    or run["counters"]["resilience/data_retries"] != 1 \
                    or run["counters"]["resilience/steps_skipped"] != \
                    len(RESIL_NAN) or run["restored"] != [0, RESIL_SAVE] \
                    or sorted(map(int, run["losses"])) != \
                    list(range(RESIL_STEPS)) \
                    or not all(math.isfinite(v)
                               for v in run["losses"].values()):
                fails.append(f"(s2) {run}")
        emit({"resilience": "runner", "bitwise_repeat": exact,
              "losses": a["losses"], "losses_repeat": a2["losses"],
              "spread": spread, "nan_cursors": nan,
              **{k: a[k] for k in ("rollbacks", "skips", "restored",
                                   "restore_ms", "saves", "counters",
                                   "wall_s")}})
        # (s3): the SIGTERM at the preempted life's gate
        life = os.path.join(root, "life")
        deadline = time.time() + timeout
        while not os.path.exists(os.path.join(life, "ready")):
            if lives["preempt"].poll() is not None or time.time() > deadline:
                _resil_join(lives["preempt"], life, 75, 1)
                raise AssertionError("the preempted life never reached "
                                     "its gate")
            time.sleep(0.05)
        os.kill(lives["preempt"].pid, signal.SIGTERM)
        _resil_join(lives["preempt"], life, 75, timeout)
        first = _resil_json(os.path.join(life, "preempt.json"))
        ckpt = os.path.join(life, "ckpt")
        newest = chaos.newest_committed_step(ckpt)
        chaos.flip_shard_byte(ckpt)
        restart = _resil_child(root, "life", "restart")
        procs.append(restart)
        _resil_join(restart, life, 0, timeout)
        second = _resil_json(os.path.join(life, "restart.json"))
        pre_save = [s for s in first["saves"] if not s["async"]]
        if not (first["preempted"] and first["exit_code"] == 75
                and first["counters"]["resilience/preemptions"] == 1
                and len(pre_save) == 1 and pre_save[0]["step"] == newest
                == RESIL_PREEMPT_COMMIT):
            fails.append(f"(s3) the preempted life {first}")
        if not (second["start_step"] == RESIL_SAVE * 2
                and second["counters"]["resilience/restore_fallbacks"] == 1
                and second["final_step"] == RESIL_STEPS
                and second["skips"] == list(RESIL_NAN)):
            fails.append(f"(s3) the restarted life {second}")
        for what, life_rec in (("preempted", first), ("restarted", second)):
            try:
                _resil_losses_held(life_rec["losses"], a["losses"], spread,
                                   exact, f"(s3) {what} life")
            except AssertionError as e:
                fails.append(str(e))
        emit({"resilience": "preempt", "commit_step": newest,
              "commit_ms": pre_save[0]["ms"] if pre_save else None,
              "restored": second["restored"],
              "restore_ms": second["restore_ms"],
              "restore_fallbacks":
                  second["counters"]["resilience/restore_fallbacks"],
              "losses_first": first["losses"],
              "losses_restart": second["losses"], "bitwise": exact})
        # (s4): the watchdog's life
        wd = os.path.join(root, "wd")
        _resil_join(lives["watchdog"], wd, 74, timeout)
        steps = _resil_json(os.path.join(wd, "watchdog.steps.json"))
        dump = open(os.path.join(wd, "dump.txt")).read()
        lines = [json.loads(ln) for ln in
                 open(os.path.join(wd, "sink", "metrics.jsonl"))]
        fires = [json.loads(ln) for ln in
                 open(os.path.join(wd, "sink", "events.jsonl"))
                 if '"watchdog_fire"' in ln]
        with open(os.path.join(wd, "hang_t")) as f:
            hang_t = float(f.read())
        wd_line = [ln for ln in lines if ln["reason"] == "watchdog"]
        cold_s = steps["steps"][0][1] - steps["t_start"]
        if not ("hung-step dump" in dump and "hybrid/sync_wait" in dump
                and wd_line and len(fires) == 1
                and fires[0]["step"] == RESIL_HANG_STEP
                and [s for s, _ in steps["steps"]] ==
                list(range(RESIL_HANG_STEP))):
            fails.append(f"(s4) fires {fires}, dump {dump[:400]!r}, "
                         f"lines {[ln['reason'] for ln in lines]}")
        emit({"resilience": "watchdog", "exit_code": 74,
              "timeout_s": RESIL_WD_TIMEOUT_S, "jitter": RESIL_WD_JITTER,
              "first_step_grace_s": RESIL_WD_GRACE_S,
              "cold_first_step_s": cold_s,
              "fire_elapsed_s": fires[0]["elapsed_s"] if fires else None,
              "fire_latency_s": wd_line[-1]["ts"] - hang_t
              if wd_line else None,
              "step_walls": steps["steps"],
              "dump_has_open_span": "hybrid/sync_wait" in dump})
        counts = {k: own[k] + first["launches"][k] +
                  second["launches"][k] + steps["launches"][k]
                  for k in LAUNCH_COUNTERS}
        emit({"resilience": "phase", "seconds": time.perf_counter() - t0,
              "lives_s": time.perf_counter() - t_lives,
              "launches": counts})
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        shutil.rmtree(root, ignore_errors=True)
    if fails:
        raise AssertionError(f"resilience: {fails}")
    return counts, {}


# ---------------------------------------------------------------------------
# plan phase: planning without allocation
# ---------------------------------------------------------------------------
#: GPT-3 13B's factorizations on a planning world of PLAN_WORLD (the
#: reference's names, benchmarks/plan_13b.py): (name, tp, pp, dp, ZeRO
#: stage, n_micro)
PLAN_13B = (("A_tp8_pp2", 8, 2, 1, 0, 8),
            ("B_tp4_pp4", 4, 4, 1, 0, 16),
            ("C_tp4_pp2_dp2_zero2", 4, 2, 2, 2, 8))
PLAN_WORLD = 16
#: global batch [sequences, S] of the 13B plans
PLAN_13B_BATCH = (32, 2048)
#: the resident plan's forward-and-backward and update peaks within this
#: share of the allocator's readings (what the plan does not see:
#: cuBLAS's workspace, allocator blocks larger than their request)
PLAN_PEAK_RTOL = 0.10
#: results of earlier phases the plan phase reads (the train phase's row,
#: the hybrid phase's ranks)
PHASE_RESULTS: dict = {}


def _allocated(dev) -> int:
    """The card's allocated bytes (0 on the CPU: a rehearsal)."""
    import torch

    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0


def _host_rss_gb():
    """This process's resident bytes now (/proc/self/statm), in GB, or
    None where it cannot be read. Not getrusage's ru_maxrss: a child
    keeps its parent's across exec. VmHWM is missing on some hosts, so a
    plan's host peak is read as its RSS at the end (Python keeps what it
    took)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") \
                / 1e9
    except (OSError, IndexError, ValueError):
        return None


def _plan_spec(batch):
    """A ``meta`` tensor: the shape spec of a token batch."""
    import torch

    return torch.empty(batch, dtype=torch.int64, device="meta")


def _scores(low, s) -> int:
    """Ops of a plan with a ``[..., S, S]`` output of four dims (the plain
    attention's scores)."""
    return sum(any(len(shape) == 4 and shape[-2:] == (s, s)
                   for shape, _, _ in outs) for _, outs, _ in low.ops)


def _plan_row(tr, low, dev, t0) -> dict:
    import torch

    comp = low.compile()
    ma = comp.memory_analysis()
    total = torch.cuda.get_device_properties(dev).total_memory \
        if dev.type == "cuda" else None
    return {"memory_analysis": ma,
            "peak_GB": ma["peak_bytes_est"] / 1e9,
            "card_total_GB": None if total is None else total / 1e9,
            "fits": None if total is None else ma["peak_bytes_est"] <= total,
            "fwd_bwd_peak_bytes": comp.fwd_bwd_peak_bytes,
            "update_peak_bytes": comp.update_peak_bytes,
            "ledger": tr.memory_ledger(),
            "ops": len(low.ops), "collectives": low.collective_stats(),
            "score_ops": _scores(low, PLAN_13B_BATCH[1]),
            "lower_s": low.wall_s, "plan_wall_s": time.perf_counter() - t0,
            "host_rss_GB": _host_rss_gb()}


def plan_worker(out_path, name, rank, dev=None) -> int:
    """One 13B plan (``--plan-worker OUT NAME RANK``): rank ``rank`` of a
    planning world of PLAN_WORLD (``env.plan_world``), GPT-3 13B built
    under LazyGuard, the HybridPipelineTrainer at the factorization
    ``name`` of PLAN_13B under the reference's recipe (amp, recompute,
    bf16 parameters and moments, AdamW 1e-4 with weight decay 0.01),
    its step planned on a [32, 2048] batch spec. Writes the row to
    ``out_path``, with the bytes the card's allocator moved and the
    kernels launched meanwhile (``plan_phase`` holds both to 0)."""
    import torch

    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed.env import plan_world
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.hybrid import HybridPipelineTrainer
    from paddle_tpu_torch.distributed.strategy_compiler import \
        build_mesh_from_strategy
    from paddle_tpu_torch.framework.lazy import LazyGuard
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.optimizer import AdamW

    dev = dev or torch.device("cuda", 0)
    _, tp, pp, dp, zero, n_micro = next(p for p in PLAN_13B if p[0] == name)
    alloc0 = _allocated(dev)
    rss0 = _host_rss_gb()
    set_counts()
    t0 = time.perf_counter()
    with plan_world(PLAN_WORLD, rank):
        s = DistributedStrategy()
        s.amp = s.recompute = True
        s.hybrid_configs = {"dp_degree": dp, "mp_degree": tp,
                            "pp_degree": pp}
        if zero:
            s.sharding = True
            s.sharding_configs = {"sharding_stage": zero}
        mesh = M.set_mesh(build_mesh_from_strategy(s))
        with LazyGuard():
            model = GPT(GPTConfig.gpt3_13b(), device=dev)
        opt = AdamW(1e-4, weight_decay=0.01,
                    parameters=model.named_parameters())
        tr = HybridPipelineTrainer(model, opt, s, mesh, n_micro=n_micro,
                                   param_dtype="bfloat16",
                                   moment_dtype="bfloat16")
        low = tr.aot_lower(_plan_spec(PLAN_13B_BATCH))
        row = {"plan": "gpt3_13b", "name": name, "rank": rank,
               "host_rss_before_build_GB": rss0,
               "stage": tr.stage, "mesh": dict(mesh.shape), "zero": zero,
               "n_micro": n_micro, "layers_held": len(
                   [l for c in tr.circuits for l in c])}
        row.update(_plan_row(tr, low, dev, t0))
    counts, _ = read_counts()
    row["launches"] = {k: n for k, n in counts.items() if n}
    row["allocated_moved_bytes"] = _allocated(dev) - alloc0
    with open(out_path, "w") as f:
        json.dump(row, f)
    return 0


def _plan_children(dev, out_dir, timeout):
    """Start every 13B plan (rank 0 and the last stage's rank
    PLAN_WORLD - 1 of each factorization) as a child process, all at
    once; returns a function that waits for them and returns their rows
    (a failed or late child fails the phase; every child is stopped)."""
    import signal

    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    jobs = []
    for name, *_ in PLAN_13B:
        for rank in (0, PLAN_WORLD - 1):
            out = os.path.join(out_dir, f"plan.{name}.{rank}.json")
            log = open(out + ".log", "w")
            p = subprocess.Popen(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                 "--plan-worker", out, name, str(rank)],
                env=env, cwd=HERE, stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True)
            jobs.append((name, rank, out, p, log))
    t0 = time.perf_counter()

    def wait():
        rows, failed = [], []
        try:
            for name, rank, out, p, log in jobs:
                left = max(1.0, timeout - (time.perf_counter() - t0))
                try:
                    rc = p.wait(timeout=left)
                except subprocess.TimeoutExpired:
                    rc = "timeout"
                log.close()
                if rc != 0:
                    with open(out + ".log") as f:
                        print(f"--- plan {name} rank {rank} ({rc}) ---\n"
                              + f.read()[-4000:], file=sys.stderr)
                    failed.append((name, rank, rc))
                    continue
                with open(out) as f:
                    rows.append(json.load(f))
        finally:
            for *_, p, log in jobs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
                log.close()
        if failed:
            raise AssertionError(f"13B plans failed: {failed}")
        return rows

    return wait


def plan_phase(dev, timeout=600) -> dict:
    """The plan phase (the module docstring): the 13B plans in child
    processes; in this process the resident configuration's plan (its
    trainer is kept for ``plan_allocator_check``), the 24-layer train
    recipe's plan and the tp 2 plans of hybrid run (a) at a planning
    world of 2, their collectives held to run (a)'s count. Launches no
    kernel. Returns what ``plan_allocator_check`` needs."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed.env import plan_world
    from paddle_tpu_torch.framework.lazy import LazyGuard
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig

    t_phase = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="plan_phase_")
    try:
        wait = _plan_children(dev, out_dir, timeout)
        _free_memory(dev)
        # the resident configuration (the resume phase's): planned from
        # the materialized trainer, whose step the allocator then measures
        base = _allocated(dev)
        tr, cfg = _resume_trainer(dev)
        before = _allocated(dev)
        t0 = time.perf_counter()
        low = tr.aot_lower(*_resume_batch(cfg, 0))
        resident = _plan_row(tr, low, dev, t0)
        moved = _allocated(dev) - before
        assert moved == 0, ("resident plan allocated", moved)
        emit({"plan": "resident", "layers": cfg.num_layers,
              "batch": list(RESUME_BATCH), **resident})
        # the train phase's recipe at full depth, planned abstractly
        t0 = time.perf_counter()
        before = _allocated(dev)
        full, _ = make_trainer(dev, GPTConfig.gpt3_1_3b(), 6, lazy=True)
        low = full.aot_lower(_plan_spec((4, 2048)))
        row = _plan_row(full, low, dev, t0)
        assert _allocated(dev) == before
        train = PHASE_RESULTS.get("train")
        emit({"plan": "train_recipe", "layers": 24, "batch": [4, 2048],
              "peak_GiB": row["memory_analysis"]["peak_bytes_est"] / 2 ** 30,
              "train_phase_max_memory_allocated_gib":
                  None if train is None else
                  train["max_memory_allocated_gib"], **row})
        del full, low
        # hybrid run (a) at a planning world of 2: its collectives
        name, axes, zero, dtype, batch, kw = HYBRID_RUNS[0]
        hcfg = dataclasses.replace(GPTConfig.gpt3_1_3b(),
                                   num_layers=HYBRID_LAYERS)
        ran = PHASE_RESULTS.get("hybrid")
        tp_rows = []
        for rank in (0, 1):
            t0 = time.perf_counter()
            with plan_world(2, rank):
                mesh = M.init_mesh(axes)
                with LazyGuard():
                    model = GPT(hcfg, device=dev)
                htr = _hybrid_trainer(model, mesh, zero, dtype, **kw)
                low = htr.aot_lower(_plan_spec(batch))
                got = low.collective_stats()
                prow = {"plan": "hybrid_" + name, "rank": rank,
                        "collectives": got, "ops": len(low.ops),
                        "plan_wall_s": time.perf_counter() - t0}
                del htr, model, low
            if ran is not None:
                want = next(r for r in ran[rank]["runs"]
                            if r["run"] == name)["collective_stats"]
                prow["run_a_collectives"] = want
                for key in ("ops", "bytes", "total_bytes"):
                    assert got[key] == want[key], (rank, key, got, want)
            emit(prow)
            tp_rows.append(prow)
        rows = wait()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    for r in rows:
        emit(r)
        assert r["allocated_moved_bytes"] == 0, r
        assert not r["launches"], r
        assert r["score_ops"] == 0, r
        assert r["memory_analysis"]["peak_bytes_est"] > 0, r
    emit({"plan": "phase", "seconds": time.perf_counter() - t_phase,
          "gpt3_13b": {f"{r['name']}.rank{r['rank']}": {
              "peak_GB": r["peak_GB"], "fits": r["fits"],
              "plan_wall_s": r["plan_wall_s"],
              "host_rss_GB": r["host_rss_GB"],
              "host_rss_before_build_GB": r["host_rss_before_build_GB"]}
              for r in rows},
          "hybrid_a_bytes_equal": ran is not None})
    return {"trainer": tr, "cfg": cfg, "base": base, "resident": resident}


def plan_allocator_check(dev, planned) -> dict:
    """The resident plan against the allocator: one warm step, then one
    step measured as the resume phase measures it (``_measured_step``:
    the forward-and-backward peak and the update's peak), less the bytes
    allocated before the trainer was built; each within PLAN_PEAK_RTOL
    of the plan's."""
    tr, cfg, base = planned["trainer"], planned["cfg"], planned["base"]
    plan = planned["resident"]
    tr.step(*_resume_batch(cfg, 1))
    mem = _measured_step(tr, _resume_batch(cfg, 2)[0], dev)
    got = {"between_steps": mem["between_steps"] - base,
           "fwd_bwd_peak": mem["fwd_bwd_peak"] - base,
           "update_peak": mem["update_peak"] - base}
    want = {"between_steps":
            plan["memory_analysis"]["argument_size_in_bytes"],
            "fwd_bwd_peak": plan["fwd_bwd_peak_bytes"],
            "update_peak": plan["update_peak_bytes"]}
    gap = {k: (got[k] - want[k]) / got[k] for k in got}
    row = {"plan": "resident_vs_allocator", "allocator_bytes": got,
           "plan_bytes": want, "gap_share": gap, "rtol": PLAN_PEAK_RTOL,
           "base_bytes": base, "loss": mem["loss"]}
    emit(row)
    for k in ("fwd_bwd_peak", "update_peak"):
        assert abs(gap[k]) <= PLAN_PEAK_RTOL, row
    del planned["trainer"], tr
    _free_memory(dev)
    return row


# ---------------------------------------------------------------------------
# bert phase: BERT-base pretraining on one rank, ERNIE at ZeRO 3 on two
# ---------------------------------------------------------------------------
#: the reference benchmark's BERT-base cell (bench.py:926-936): a global
#: batch of 64 x 512 in 4 micro-batches of 16, one AdamW update a step
BERT_BATCH = (64, 512)
BERT_ACCUMULATE = 4
BERT_LR = 1e-4
#: steps on one batch; the median is over steps 3 on (the first two warm
#: the allocator and cuBLAS)
BERT_STEPS = 8
#: the micro-batch's attention, [B, S, H, D]
BERT_ATTN = (BERT_BATCH[0] // BERT_ACCUMULATE, BERT_BATCH[1], 12, 64)
#: the plain-attention check's depth (BERT-base widths)
BERT_CHECK_LAYERS = 2
#: the ernie path: ernie_base's widths at its full depth, dp 2
ERNIE_LAYERS = 12
ERNIE_BATCH = (8, 512)
ERNIE_STEPS = 4
ERNIE_LR = 1e-4
#: the main paths of the bert phase (the kernels line counts their
#: launches on its BERT-shape rows)
BERT_PATHS = ("bert", "ernie")


def mlm_batch(vocab, batch, seq, seed=0):
    """The reference benchmark's synthetic MLM batch (bench.py's
    _mlm_batch): (tokens, token_type_ids (zeros), mlm_labels (15% of the
    positions, -100 elsewhere), nsp_labels), int32 numpy."""
    import numpy as np

    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, (batch, seq)).astype(np.int32)
    tt = np.zeros((batch, seq), np.int32)
    mlm = np.where(rng.rand(batch, seq) < 0.15,
                   rng.randint(0, vocab, (batch, seq)), -100).astype(np.int32)
    nsp = rng.randint(0, 2, (batch,)).astype(np.int32)
    return tokens, tt, mlm, nsp


def bert_base_config(**kw):
    from paddle_tpu_torch.models.bert import BertConfig

    return BertConfig(vocab_size=32768, max_seq_len=512, max_predictions=80,
                      **kw)


def bert_check(dev, seed=3):
    """BERT-base's widths at BERT_CHECK_LAYERS layers, one micro-batch of
    the main path's shape: every parameter's gradient of the bf16 model
    through the kernels and through the plain attention functions bound
    in (grad_phase's swap), each against the f32 model's on the plain
    functions. The kernels' error may exceed the plain version's by
    GRAD_BF16_TOL at most (max |dg| / max |g| per parameter), and the
    losses agree within it. Not the two bf16 runs against each other:
    the token-type row's gradient is a sum over all 8192 positions that
    cancels to a few bf16 ulps of its terms, so the two bf16 runs differ
    there by most of the row (0.70 of it on the card), whichever is the
    closer to the f32 one."""
    import torch

    from paddle_tpu_torch.core import rng as _rng
    from paddle_tpu_torch.models.bert import BertForPretraining

    cfg = bert_base_config(num_layers=BERT_CHECK_LAYERS)
    _rng.seed(seed)
    model = BertForPretraining(cfg, device=dev).to(torch.bfloat16)
    batch = [torch.from_numpy(a).to(dev) for a in mlm_batch(
        cfg.vocab_size, BERT_ATTN[0], BERT_ATTN[1], seed=seed)]

    def grads():
        for p in model.parameters():
            p.grad = None
        loss = model.loss(*batch)
        loss.backward()
        return float(loss.detach()), {n: p.grad.float()
                                      for n, p in model.named_parameters()}

    loss, got = grads()
    with plain_attention():
        plain_loss, ref = grads()
        model.float()
        f32_loss, truth = grads()

    def rel(g, n):
        return float((g - truth[n]).abs().max()) / max(
            float(truth[n].abs().max()), 1e-30)

    worst, worst_name, excess, excess_name = 0.0, None, -1.0, None
    for n, g in got.items():
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"bert check: {n} gradient not finite")
        e, e_plain = rel(g, n), rel(ref[n], n)
        if e > worst:
            worst, worst_name = e, n
        if e - e_plain > excess:
            excess, excess_name = e - e_plain, n
    row = {"phase": "bert_check", "layers": BERT_CHECK_LAYERS,
           "batch": list(BERT_ATTN[:2]), "dtype": "bfloat16", "loss": loss,
           "plain_loss": plain_loss, "f32_loss": f32_loss,
           "max_rel_grad_err": worst, "worst_param": worst_name,
           "max_excess_over_plain": excess, "excess_param": excess_name,
           "tolerance": GRAD_BF16_TOL,
           "tolerance_reason": "max |dg| / max |g| per parameter against "
           "the f32 model's: the kernels' error at most the plain "
           "version's + the tolerance (bf16 model: 8 significant bits; the "
           "plain attention rounds its logits to bf16, the kernels keep "
           "them in f32)"}
    emit(row)
    if excess > GRAD_BF16_TOL or \
            abs(loss - f32_loss) > GRAD_BF16_TOL * abs(f32_loss):
        raise AssertionError(f"bert check: {excess_name} err beyond the "
                             f"plain version's by {excess}, loss {loss} vs "
                             f"{f32_loss}")
    return row


def bert_phase(dev, steps=BERT_STEPS, batch=BERT_BATCH, layers=None,
               seed=11):
    """The check (uncounted), then BERT-base through compile_train_step
    (amp, accumulate_steps BERT_ACCUMULATE, AdamW BERT_LR) on one fixed
    global batch: the loss finite and falling, the warm step median and
    spread, tokens/s, MFU, peak memory, and each warm step's launches of
    the forward and the merged backward (one each a layer a
    micro-batch)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.core import rng as _rng
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.strategy_compiler import \
        compile_train_step
    from paddle_tpu_torch.models.bert import BertForPretraining
    from paddle_tpu_torch.optimizer import AdamW

    with uncounted():
        check = bert_check(dev)
    _free_memory(dev)
    cfg = bert_base_config()
    if layers:
        cfg.num_layers = layers
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _rng.seed(seed)
    model = BertForPretraining(cfg, device=dev)
    opt = AdamW(BERT_LR, parameters=model.named_parameters())
    s = DistributedStrategy()
    s.amp = True
    tr = compile_train_step(model, opt, s, accumulate_steps=BERT_ACCUMULATE)
    data = [torch.from_numpy(a).to(dev)
            for a in mlm_batch(cfg.vocab_size, *batch)]
    losses, times, launches = [], [], []
    for _ in range(steps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        c0 = read_counts()[0]
        t0 = time.perf_counter()
        loss = float(tr.step(*data))             # syncs on the loss
        times.append((time.perf_counter() - t0) * 1e3)
        c1 = read_counts()[0]
        launches.append({k: c1[k] - c0[k] for k in ("flash_tc",
                                                    "bwd_single_tc")})
        losses.append(loss)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"bert phase: losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"bert phase: loss did not fall: {losses}")
    per_step = cfg.num_layers * BERT_ACCUMULATE
    if dev.type == "cuda" and any(
            n != per_step for c in launches[2:] for n in c.values()):
        raise AssertionError(f"bert phase: launches a step {launches}, "
                             f"want {per_step} of each")
    warm = times[2:]
    step_ms = float(np.median(warm))
    tok_s = batch[0] * batch[1] / (step_ms / 1e3)
    row = {"phase": "bert", "config": "BertConfig(vocab_size=32768, "
           "max_seq_len=512, max_predictions=80)",
           "params": cfg.num_params(), "layers": cfg.num_layers,
           "batch": list(batch), "accumulate_steps": BERT_ACCUMULATE,
           "amp": True, "optimizer": f"AdamW({BERT_LR})",
           "losses": losses, "step_ms": times,
           "step_ms_median_3_to_8": step_ms,
           "step_ms_spread": [min(warm), max(warm)],
           "tokens_per_s": tok_s,
           "mfu": tok_s * cfg.flops_per_token(batch[1])
           / PEAK_FLOPS["bfloat16"],
           "mfu_basis": "tokens/s x BertConfig.flops_per_token(512) / "
                        "989e12 (6N + 12 L h S: not the non-causal "
                        "attention's second half, not the heads)",
           "max_memory_allocated_gib": (
               torch.cuda.max_memory_allocated(dev) / 2 ** 30
               if dev.type == "cuda" else None),
           "launches_by_step": launches,
           "check_excess_over_plain": check["max_excess_over_plain"]}
    emit(row)
    PHASE_RESULTS["bert"] = row
    return row


def ernie_run(dev, layers=ERNIE_LAYERS, batch=ERNIE_BATCH,
              steps=ERNIE_STEPS, seed=13):
    """This rank's part of the ernie path: ernie_base's widths at
    ``layers`` layers under ZeRO 3, recompute, amp and the global-norm
    clip at dp 2; returns its losses, step ms, launches and checks."""
    import numpy as np
    import torch

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.core import rng as _rng
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed import parallel_layers as PL
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.hybrid import HybridPipelineTrainer
    from paddle_tpu_torch.framework.lazy import LazyGuard
    from paddle_tpu_torch.models.ernie import (ErnieConfig,
                                               ErnieForPretraining)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = ErnieConfig.ernie_base()
    cfg.num_layers, cfg.max_predictions = layers, 80
    with LazyGuard():
        shapes = {n: tuple(p.shape) for n, p in
                  ErnieForPretraining(cfg, device=dev).named_parameters()}
    mesh = M.init_mesh({"dp": 2})
    _rng.seed(seed)
    model = ErnieForPretraining(cfg, device=dev)
    opt = AdamW(ERNIE_LR, parameters=model.named_parameters(),
                grad_clip=nn.ClipGradByGlobalNorm(1.0))
    s = DistributedStrategy()
    s.amp = s.recompute = s.sharding = True
    s.sharding_configs = {"sharding_stage": 3}
    tr = HybridPipelineTrainer(model, opt, s, mesh)
    blocks = [n for n in tr._names if n.startswith("bert.blocks.")]
    sliced = {n for n, sh in zip(tr._names, tr._upd.shards)
              if sh is not None}
    data = [torch.from_numpy(a).to(dev)
            for a in mlm_batch(cfg.vocab_size, *batch, seed=seed)]
    set_counts()
    losses, times = [], []
    for _ in range(steps):
        _sync(dev)
        t0 = time.perf_counter()
        losses.append(float(tr.step(*data)))
        times.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()[0]
    tr.sync_to_layer()
    full = PL.gather_reference_state(model)
    M.set_mesh(None)
    return {"layers": layers, "batch": list(batch), "losses": losses,
            "step_ms": times, "launches": counts,
            "blocks": len(blocks),
            "blocks_sliced": sum(n in sliced for n in blocks),
            "whole": sorted(full) == sorted(shapes) and all(
                tuple(a.shape) == shapes[n] for n, a in full.items()),
            "finite": bool(np.isfinite(losses).all())}


def bert_worker(out_dir) -> int:
    """One rank of the bert phase's ernie path (started by the
    launcher)."""
    import torch

    import paddle_tpu_torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = dist.init_parallel_env()
    rank, dev = env.rank, env.device
    assert env.world_size == 2 and dev == torch.device("cuda", 0), \
        (env.world_size, dev)
    res = {"rank": rank, **ernie_run(dev)}
    res["foreign_modules"] = sorted(
        m for m in sys.modules if m == "jax" or m.startswith("jax.")
        or m == "paddle_tpu" or m.startswith("paddle_tpu."))
    assert not res["foreign_modules"], res["foreign_modules"]
    dist.barrier()
    with open(os.path.join(out_dir, f"bert.{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def ernie_phase(dev, timeout=400):
    """Launch the ernie path's two ranks on this card over gloo; check
    their results. Returns (the ranks' summed launch counts, {})."""
    res, wall = _run_ranks(dev, "--bert-worker", "bert", timeout)
    counts = {k: sum(r["launches"][k] for r in res) for k in LAUNCH_COUNTERS}
    for r in res:
        emit({"ernie": "rank", **r})
        if not (r["finite"] and r["whole"]
                and r["blocks_sliced"] == r["blocks"] > 0):
            raise AssertionError(f"ernie rank {r['rank']}: finite "
                                 f"{r['finite']}, whole {r['whole']}, "
                                 f"{r['blocks_sliced']} of {r['blocks']} "
                                 "block parameters sliced over dp")
    if res[0]["losses"] != res[1]["losses"]:
        raise AssertionError(f"ernie: the ranks' losses differ: "
                             f"{[r['losses'] for r in res]}")
    emit({"ernie": "phase", "seconds": wall, "losses": res[0]["losses"],
          "step_ms": [r["step_ms"] for r in res],
          "step_ms_basis": "two ranks on one card over gloo (its host "
                           "ring, not NCCL)", "launches": counts})
    return counts, {}


# ---------------------------------------------------------------------------
# phase 20: vision — LeNet/MNIST, ResNet-50 and the int8 conv
# ---------------------------------------------------------------------------
#: ResNet-50's train step, bench.py:213-243: batch 64 at 224², amp
RESNET_BATCH = (64, 3, 224, 224)
RESNET_WARM, RESNET_TIMED = 2, 10
#: the card-against-CPU forward: f32, TF32 off; max |Δ| over max(|ref|, 1)
#: of the logits and of each running statistic (cuDNN's and oneDNN's convs
#: sum in other orders through 53 convs and 53 norms)
RESNET_CHECK_SHAPE = (2, 3, 224, 224)
RESNET_CHECK_TOL = 1e-3
#: the int8 conv rows: (case, C, O, k, padding, x shape, route). LeNet's
#: conv2 at the loop's batch (K = 6·5·5 = 150: mma.sync) and a ResNet-50
#: layer1 3x3 conv (K = 64·3·3 = 576: wgmma; M 8·56·56 = 25088, N 64)
INT8_CONV_CASES = (("lenet_conv2", 6, 16, 5, 0, (64, 6, 14, 14), "mma"),
                   ("resnet50_layer1_3x3", 64, 64, 3, 1, (8, 64, 56, 56),
                    "wgmma"))
#: a QAT LeNet after convert_to_int8_deploy: accuracy within this of its
#: fake-quant accuracy
INT8_LENET_ACC_TOL = 0.01
#: the int8 kernels whose vision-path launches the kernels line counts by
#: layer, not under the kernel phase's shape
VISION_ROWED = ("int8_matmul", "int8_matmul_wgmma", "int8_quantize")


def _mnist_loader(dev, batch_size, shuffle, drop_last=False, n=512):
    from paddle_tpu_torch import io
    from paddle_tpu_torch.vision.datasets import MNIST

    return io.DataLoader(MNIST(mode="train", synthetic_size=n),
                         batch_size=batch_size, shuffle=shuffle,
                         drop_last=drop_last, device=dev)


def _accuracy(net, dev):
    import torch

    from paddle_tpu_torch.metric import Accuracy

    net.eval()
    acc = Accuracy()
    with torch.no_grad():
        for x, y in _mnist_loader(dev, 128, False):
            acc.update(acc.compute(net(x), y))
    return acc.accumulate()


def lenet_run(dev, epochs=3, seed=33, bench_steps=20):
    """tests/test_e2e_mnist.py's loop on the card: seed(33), synthetic
    MNIST(512), DataLoader(64, shuffle, drop_last), LeNet, Adam(0.002),
    3 epochs; the last loss under 0.7 of the first and train accuracy
    through metric.Accuracy over 0.5. Then the eager step at bench.py:
    152-168's shape (batch 64, Adam 1e-3), its device ms a step."""
    import numpy as np
    import torch

    from paddle_tpu_torch import seed as pseed
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision.models import LeNet

    pseed(seed)
    loader = _mnist_loader(dev, 64, True, drop_last=True)
    net = LeNet(device=dev)
    opt = Adam(0.002, parameters=net.parameters())
    losses = []
    for _ in range(epochs):
        for x, y in loader:
            loss = F.cross_entropy(net(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.detach()))
    acc = _accuracy(net, dev)
    if not (np.isfinite(losses).all() and losses[-1] < 0.7 * losses[0]
            and acc > 0.5):
        raise AssertionError(f"lenet: losses {losses[0]} -> {losses[-1]}, "
                             f"train accuracy {acc}")
    bench = LeNet(device=dev)
    bopt = Adam(1e-3, parameters=bench.parameters())
    x = torch.from_numpy(np.random.RandomState(0).randn(
        64, 1, 28, 28).astype(np.float32)).to(dev)
    y = torch.from_numpy(np.random.RandomState(1).randint(
        0, 10, (64,)).astype(np.int64)).to(dev)

    def step():
        loss = F.cross_entropy(bench(x), y)
        loss.backward()
        bopt.step()
        bopt.clear_grad()

    step_ms, host_ms = timed(step, bench_steps, dev)
    return {"losses": losses, "first_loss": losses[0],
            "last_loss": losses[-1], "train_accuracy": acc,
            "eager_step_ms": step_ms, "eager_step_host_ms": host_ms,
            "eager_images_per_s": 64 / (host_ms / 1e3),
            "eager_step_basis": "bench.py:152-168 (batch 64, Adam 1e-3): "
                                "the card's ms a step behind a held "
                                "stream, and the host loop's"}


def resnet_check(dev, seed=5):
    """ResNet-50 (1000 classes, f32) from a seed on the card and the same
    weights on the CPU, one [2, 3, 224, 224] batch: train mode (the
    logits and every running statistic after the forward) and eval mode
    (the logits), each within RESNET_CHECK_TOL of max(|CPU|, 1)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import seed as pseed
    from paddle_tpu_torch.models.gpt import load_reference_state, \
        state_to_numpy
    from paddle_tpu_torch.vision.models import resnet50

    pseed(seed)
    card = resnet50(device=dev)
    cpu = resnet50(device="cpu")
    load_reference_state(cpu, state_to_numpy(card))
    x = np.random.RandomState(2).randn(*RESNET_CHECK_SHAPE).astype(
        np.float32)
    out = {}
    with torch.no_grad():
        for mode in ("train", "eval"):
            card.train(mode == "train")
            cpu.train(mode == "train")
            a = card(torch.from_numpy(x).to(dev)).cpu().numpy()
            b = cpu(torch.from_numpy(x)).numpy()
            err = float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))
            out[f"{mode}_logits_err"] = err
            if mode == "train":
                cb = dict(cpu.named_buffers())
                out["running_stats_err"] = max(
                    float((t.cpu() - cb[n]).abs().max()
                          / max(float(cb[n].abs().max()), 1.0))
                    for n, t in card.named_buffers())
    bad = {k: v for k, v in out.items() if not v <= RESNET_CHECK_TOL}
    if bad:
        raise AssertionError(f"resnet check: card against CPU {bad} > "
                             f"{RESNET_CHECK_TOL}")
    return dict(out, tol=RESNET_CHECK_TOL,
                tol_basis="max |card - CPU| / max(|CPU|, 1), f32, TF32 off")


def resnet_train(dev, seed=0):
    """bench.py:213-243 on the card: resnet50(num_classes=1000),
    Momentum(0.1), amp, compile_train_step on a dp 1 mesh, the loss
    cross_entropy(out.float(), label), one [64, 3, 224, 224] batch from
    RandomState(0) with labels from RandomState(1) staged on the card.
    RESNET_WARM + RESNET_TIMED steps: every loss finite, the running
    statistics finite and moved; the warm median step ms, images/s and
    peak memory; one step's kernels by name (torch.profiler), split by
    device_trace.class_table, and the update's own time (the trainer's
    "optim" range: its host ms and the device ms of the kernels launched
    inside it); profile_step_phases(iters=1, trace_window=2)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import seed as pseed
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.strategy_compiler import \
        compile_train_step
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    _free_memory(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    pseed(seed)
    net = resnet50(num_classes=1000, device=dev)
    opt = Momentum(0.1, parameters=net.named_parameters())
    s = DistributedStrategy()
    s.amp = True
    tr = compile_train_step(net, opt, s, loss_fn=lambda out, lbl:
                            F.cross_entropy(out.float(), lbl))
    x = torch.from_numpy(np.random.RandomState(0).randn(
        *RESNET_BATCH).astype(np.float32)).to(dev)
    y = torch.from_numpy(np.random.RandomState(1).randint(
        0, 1000, (RESNET_BATCH[0],)).astype(np.int64)).to(dev)
    before = {n: b.clone() for n, b in net.named_buffers()}
    losses, times = [], []
    for _ in range(RESNET_WARM + RESNET_TIMED):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        losses.append(float(tr.step(x, y)))            # syncs on the loss
        times.append((time.perf_counter() - t0) * 1e3)
    stats = dict(net.named_buffers())
    if not np.isfinite(losses).all() or not all(
            bool(torch.isfinite(b).all()) for b in stats.values()) or any(
            torch.equal(before[n], b) for n, b in stats.items()):
        raise AssertionError(f"resnet train: losses {losses}; running "
                             "statistics finite and moved: "
                             f"{sorted(n for n, b in stats.items() if torch.equal(before[n], b))}")
    step_ms = float(np.median(times[RESNET_WARM:]))
    flops_step = 3 * 4.1e9 * RESNET_BATCH[0]
    row = {"config": "resnet50(num_classes=1000), Momentum(0.1), amp, "
                     "compile_train_step dp 1 (bench.py:213-243)",
           "batch": list(RESNET_BATCH), "losses": losses,
           "step_ms": times, "step_ms_median_warm": step_ms,
           "images_per_s": RESNET_BATCH[0] / (step_ms / 1e3),
           "model_tflops_per_s": flops_step / (step_ms / 1e3) / 1e12,
           "model_flops_basis": "3 x 4.1 GFLOP a 224² image x 64 a step "
                                "(the textbook ResNet-50 forward count)",
           "max_memory_allocated_gib": (
               torch.cuda.max_memory_allocated(dev) / 2 ** 30
               if dev.type == "cuda" else None)}
    from paddle_tpu_torch.profiler import device_trace as dt

    _, kernels, optim, _ = profile_kernels(
        dev, lambda: float(tr.step(x, y)), label="optim")
    if dev.type == "cuda" and not (optim["count"] == 1
                                   and optim["cpu_ms"] > 0
                                   and optim["device_ms"] > 0):
        raise AssertionError(f"resnet: the step's optim range {optim}")
    row.update(step_kernels_ms=sum(
        e.self_device_time_total for e in kernels) / 1e3,
        step_classes=dt.class_table(
            (e.key, e.self_device_time_total / 1e3, e.count)
            for e in kernels),
        top_kernels=top_kernels(kernels, 12), n_kernel_names=len(kernels),
        optim={"host_ms": optim["cpu_ms"], "device_ms": optim["device_ms"],
               "span_ms": optim["span_ms"],
               "basis": "the trainer's optim range in one profiled step: "
                        "host time inside it, and the summed device time "
                        "of the kernels launched inside it"})
    phases = tr.profile_step_phases(x, y, iters=1, trace_window=2)
    summary = phases.pop("trace")
    # optim_ms is step - (fwd + bwd), derived from single timings of a
    # host-bound step and clamped at 0: row["optim"] measures the update
    phases.pop("optim_ms")
    for k in ("fwd_ms", "bwd_ms", "step_ms"):
        if k not in phases or (dev.type == "cuda" and not phases[k] > 0):
            raise AssertionError(f"resnet phases: {k} in {phases}")
    row["phases_ms"] = phases
    row["trace_window"] = {k: summary.get(k) for k in (
        "steps", "wall_ms", "device_busy_ms", "host_gap_ms", "busy_frac",
        "device_ops", "categories", "host_annotations")}
    return row


INT8_KEYS = ("int8_matmul", "int8_matmul_wgmma", "int8_quantize")


def _int8_layer_row(dev, layer, x, case, launches, iters):
    """One int8 layer of the vision path (Int8Conv2D or Int8Linear) on an
    input it met there: the layer on the card against a CPU copy of it
    (int8 outputs equal, float outputs at INT8_MM_RTOL/ATOL); then its
    one product alone on the same operands against its plain version on
    the card (a conv's quantized input equal to the plain quantizer's,
    the product at INT8_MM_RTOL/ATOL), the route it took read on the
    launch counters, timed beside its bound and torch._int_mm + the
    epilogue where that takes the shape; and its quantize pass where it
    made one (_int8_quantize_row). ``launches``: {kernel: count} of this
    layer on the driven path. Every launch here is uncounted. Returns
    the rows."""
    import copy

    import torch

    from paddle_tpu_torch.ops import int8_matmul as im
    from paddle_tpu_torch.quantization import Int8Conv2D

    with uncounted(), torch.no_grad():
        y = layer(x)
        ref = copy.deepcopy(layer).to("cpu")(x.cpu())
        layer_err = float((y.cpu().float() - ref.float()).abs().max())
        ok = torch.equal(y.cpu(), ref) if y.dtype == torch.int8 else \
            torch.allclose(y.cpu(), ref, rtol=INT8_MM_RTOL,
                           atol=INT8_MM_ATOL)
        if not ok:
            raise AssertionError(f"int8 layer {case}: the layer on the card "
                                 f"misses the CPU's by {layer_err}")
        amax = layer._amax
        sa = layer.act_scale.clamp_min(1e-8)
        qs = (amax / sa).reshape(1)
        if isinstance(layer, Int8Conv2D):
            xf = x.contiguous()
            a, _ = layer._im2col(im.quantize_x(xf, qs, amax))
            wq, wq_kn = layer._mats()
        else:
            if layer._fuse_relu or layer._next_scale is not None:
                raise AssertionError(f"int8 layer {case}: a chain-fused "
                                     "linear is not on this path")
            a = xf = x.reshape(-1, x.shape[-1]).contiguous()
            wq, wq_kn = layer.weight_q, layer._weight_kn()
        qrow = _int8_quantize_row(dev, xf, qs, amax, case,
                                  launches["int8_quantize"], iters) \
            if launches["int8_quantize"] else None
        scale = ((sa / amax) * (layer.w_scale.clamp_min(1e-8)
                                / layer._wmax)).contiguous()
        bias = layer.bias.float().contiguous()
        m, kk = a.shape
        o = wq.shape[1]

        def kern():
            return im.int8_matmul(a, wq, scale, bias, qs, wq_kn=wq_kn)

        def plain():
            return im._plain_int8_matmul(a, wq, scale, bias, qs, False,
                                         False, torch.float32, amax)

        c0 = read_counts()[0]
        out, want_out = kern(), plain()
        c1 = read_counts()[0]
        route = "wgmma" if c1["int8_matmul_wgmma"] > \
            c0["int8_matmul_wgmma"] else "mma"
        key = "int8_matmul_wgmma" if route == "wgmma" else "int8_matmul"
        if dev.type == "cuda" and (
                c1[key] - c0[key] != 1 or launches[key] < 1
                or launches["int8_matmul" if route == "wgmma"
                            else "int8_matmul_wgmma"]):
            raise AssertionError(f"int8 layer {case}: the product took "
                                 f"{route}, the path's launches {launches}")
        err = float((out - want_out).abs().max())
        if not torch.allclose(out, want_out, rtol=INT8_MM_RTOL,
                              atol=INT8_MM_ATOL):
            raise AssertionError(f"int8 layer {case}: product max abs err "
                                 f"{err} against the plain version")
        kern_ms, host_ms = timed(kern, iters, dev)
        plain_ms = time_ms(plain, max(1, iters // 4), dev)
        lib_ms = None
        if m > 16 and kk % 8 == 0 and o % 8 == 0:
            def lib():
                aq = a if a.dtype == torch.int8 else torch.round(
                    a.float() * qs).clamp_(-127, 127).to(torch.int8)
                return torch._int_mm(aq, wq).float() * scale + bias

            lib_ms = time_ms(lib, iters, dev)
        flops, nbytes = im.int8_matmul_cost(a, out, kk, o, True)
        b_ms, b_by = bound(nbytes, flops, "int8")
    row = {"phase": "vision", "kernel": key, "route": route,
           "name": f"{key}_{case}",
           "case": f"{case}_M{m}_K{kk}_N{o}_x{str(a.dtype)[6:]}",
           "launches": launches[key], "path_launches": launches,
           "max_abs_err": err, "layer_err_vs_cpu": layer_err,
           "tolerance": {"rtol": INT8_MM_RTOL, "atol": INT8_MM_ATOL},
           "kernel_ms": kern_ms, "host_ms": host_ms,
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "library": "torch._int_mm (on x quantized in PyTorch where x "
                      "is float) + the epilogue in PyTorch operations"
           if lib_ms is not None else None,
           "bound_ms": b_ms, "bound_by": b_by,
           "int8_rate_share": b_ms / kern_ms}
    emit(row)
    return [row] + ([qrow] if qrow else [])


def _int8_quantize_row(dev, xf, qs, amax, case, launches, iters):
    """The quantize pass of one int8 layer (its float input ``xf``)
    against its plain version on the card, bit-equal, timed beside its
    bound and torch.quantize_per_tensor."""
    import torch

    from paddle_tpu_torch.ops import int8_matmul as im

    out = im.quantize_x(xf, qs, amax)
    ref = im._plain_quantize_x(xf, qs, amax)
    if not torch.equal(out, ref):
        raise AssertionError(f"int8 layer {case}: {int((out != ref).sum())} "
                             "quantized values differ from the plain version")
    kern_ms, host_ms = timed(lambda: im.quantize_x(xf, qs, amax), iters, dev)
    plain_ms = time_ms(lambda: im._plain_quantize_x(xf, qs, amax), iters,
                       dev)
    lib_ms, lib_off = quantize_library(xf, qs, ref, iters, dev)
    flops, nbytes = im.int8_quantize_cost(xf)
    b_ms, b_by = bound(nbytes, flops, "float32")
    row = {"phase": "vision", "kernel": "int8_quantize",
           "name": f"int8_quantize_{case}",
           "case": f"{case}_x{'x'.join(map(str, xf.shape))}_"
                   f"{str(xf.dtype)[6:]}",
           "launches": launches, "max_abs_err": 0.0, "tolerance": "equal",
           "kernel_ms": kern_ms, "host_ms": host_ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "library_values_off": lib_off,
           "library": "torch.quantize_per_tensor(f32(x), 1 / qscale, 0, "
                      "qint8) (it clips at -128, not -127)",
           "bound_ms": b_ms, "bound_by": b_by}
    emit(row)
    return row


def int8_conv_rows(dev, iters, seed=12):
    """Int8Conv2D at INT8_CONV_CASES on the card, each layer called once
    on the driven path: the route on the launch counters (one quantize
    pass, one product of the case's route), then _int8_layer_row."""
    import torch

    from paddle_tpu_torch.nn import Conv2D
    from paddle_tpu_torch.quantization import Int8Conv2D

    rows = []
    for case, c, o, k, pad, xs, route in INT8_CONV_CASES:
        g = torch.Generator(device=dev).manual_seed(seed)
        conv = Conv2D(c, o, k, padding=pad, device=dev)
        x = torch.randn(xs, generator=g, device=dev)
        layer = Int8Conv2D(conv, act_scale=3.5)       # ~3.5 sigma of x
        c0 = read_counts()[0]
        layer(x)
        c1 = read_counts()[0]
        ran = {n: c1[n] - c0[n] for n in INT8_KEYS}
        want = {"int8_matmul": int(route == "mma"),
                "int8_matmul_wgmma": int(route == "wgmma"),
                "int8_quantize": 1}
        if dev.type == "cuda" and ran != want:
            raise AssertionError(f"int8 conv {case}: launches {ran}, want "
                                 f"{want}")
        rows += _int8_layer_row(dev, layer, x, case, ran, iters)
    return rows


def int8_lenet_check(dev, iters, seed=3):
    """A QAT LeNet trained one epoch on synthetic MNIST(512) on the card,
    then convert_to_int8_deploy (its convs Int8Conv2D, its linears
    Int8Linear): accuracy on the set within INT8_LENET_ACC_TOL of the
    fake-quant model's. Each int8 layer's launches in that pass are
    counted apart (hooks around its forward), and each layer goes
    through _int8_layer_row on the input it met in the first batch."""
    from paddle_tpu_torch import seed as pseed
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.quantization import (QAT, Int8Conv2D, Int8Linear,
                                               convert_to_int8_deploy)
    from paddle_tpu_torch.vision.models import LeNet

    pseed(seed)
    net = LeNet(device=dev)
    QAT().quantize(net)
    opt = Adam(0.002, parameters=net.parameters())
    net.train()
    for x, y in _mnist_loader(dev, 64, True, drop_last=True):
        F.cross_entropy(net(x), y).backward()
        opt.step()
        opt.clear_grad()
    fake = _accuracy(net, dev)
    n = convert_to_int8_deploy(net)
    layers = [(name, m) for name, m in net.named_modules()
              if isinstance(m, (Int8Conv2D, Int8Linear))]
    first, at = {}, {}
    launches = {name: dict.fromkeys(INT8_KEYS, 0) for name, _ in layers}

    def pre(name):
        def hook(mod, args):
            first.setdefault(name, args[0].detach().clone())
            at[name] = read_counts()[0]
        return hook

    def post(name):
        def hook(mod, args, out):
            now = read_counts()[0]
            for k in INT8_KEYS:
                launches[name][k] += now[k] - at[name][k]
        return hook

    hooks = [h for name, m in layers for h in (
        m.register_forward_pre_hook(pre(name)),
        m.register_forward_hook(post(name)))]
    try:
        deployed = _accuracy(net, dev)
    finally:
        for h in hooks:
            h.remove()
    if n != 5 or len(layers) != 5 or \
            not isinstance(net.features[3], Int8Conv2D) or \
            abs(deployed - fake) > INT8_LENET_ACC_TOL or fake < 0.5:
        raise AssertionError(f"int8 lenet: {n} layers, fake-quant "
                             f"accuracy {fake}, int8 {deployed}")
    rows = [r for name, m in layers for r in _int8_layer_row(
        dev, m, first[name], "lenet_deploy_" + name.replace(".", "_"),
        launches[name], iters)]
    return {"converted": n, "fake_quant_accuracy": fake,
            "int8_accuracy": deployed,
            "launches_by_layer": launches}, rows


def vision_phase(dev, iters, kern):
    """The vision path: the LeNet loop, ResNet-50's card-against-CPU
    forward (uncounted), its train step, the int8 conv cases and the QAT
    LeNet's int8 deploy (their comparisons uncounted). The int8 rows, one
    a layer with its own launches, go to ``kern["vision_int8"]``."""
    t0 = time.perf_counter()
    row = {"phase": "vision", "lenet": lenet_run(dev)}
    with uncounted():
        row["resnet50_check"] = resnet_check(dev)
    row["resnet50_train"] = resnet_train(dev)
    rows = int8_conv_rows(dev, iters)
    row["int8_lenet"], deploy_rows = int8_lenet_check(dev, iters)
    kern["vision_int8"] = rows + deploy_rows
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    PHASE_RESULTS["vision"] = row
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20,
                    help="timed calls per kernel measurement")
    ap.add_argument("--phases", default="kernels,model,engine,spec,kvint8,"
                                        "generate,observe,handoff,disagg,"
                                        "deploy,grad,train,dist,hybrid,"
                                        "parallel,resume,resilience,plan,"
                                        "bert,vision",
                    help="comma-separated subset of kernels, model, engine, "
                         "spec, kvint8, generate, observe, handoff, disagg, "
                         "deploy, grad, train, dist, hybrid, parallel, "
                         "resume, resilience, plan, bert, vision "
                         "(debugging)")
    ap.add_argument("--dist-worker", metavar="OUT_DIR", default=None,
                    help="run one rank of the dist phase (the phase starts "
                         "two through the port's launcher)")
    ap.add_argument("--hybrid-worker", metavar="OUT_DIR", default=None,
                    help="run one rank of the hybrid phase")
    ap.add_argument("--bert-worker", metavar="OUT_DIR", default=None,
                    help="run one rank of the bert phase's ernie path")
    ap.add_argument("--parallel-worker", metavar="OUT_DIR", default=None,
                    help="run one rank of the parallel phase")
    ap.add_argument("--resume-worker", metavar="OUT_DIR", default=None,
                    help="run one life of the resume phase's elastic run")
    ap.add_argument("--resilience-worker", nargs=2, default=None,
                    metavar=("OUT_DIR", "MODE"),
                    help="run one life of the resilience phase (MODE "
                         "preempt, restart or watchdog)")
    ap.add_argument("--disagg-worker", nargs=2, default=None,
                    metavar=("OUT_DIR", "RUNS"),
                    help="run one rank of the named disagg runs (the "
                         "phase starts two through distributed.mp_mesh)")
    ap.add_argument("--plan-worker", nargs=3, default=None,
                    metavar=("OUT_JSON", "NAME", "RANK"),
                    help="plan one rank of one GPT-3 13B factorization "
                         "(the plan phase starts them)")
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
    if args.dist_worker:
        return dist_worker(args.dist_worker)
    if args.hybrid_worker:
        return hybrid_worker(args.hybrid_worker)
    if args.bert_worker:
        return bert_worker(args.bert_worker)
    if args.parallel_worker:
        return parallel_worker(args.parallel_worker)
    if args.resume_worker:
        return resume_worker(args.resume_worker)
    if args.resilience_worker:
        return resilience_worker(*args.resilience_worker)
    if args.disagg_worker:
        return disagg_worker(*args.disagg_worker)
    if args.plan_worker:
        out, name, rank = args.plan_worker
        return plan_worker(out, name, int(rank))
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
    ptxas = {n: ptxas_functions(_build.build_log(n)) for n in _build.SOURCES}
    emit({"setup": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas})
    # the tensor-core kernels (the int8 wgmma product too), the
    # register-tiled SIMT kernels (the flash forward, the ragged chunk
    # rows), the decode rows (K/V loads in flight) and the mma.sync
    # backward kernels hold their accumulators in registers: a spill
    # would put them in local memory
    for n, fn_part in (("flash_attention_fwd_tc", ""),
                       ("flash_attention_bwd_dq_tc", ""),
                       ("flash_attention_bwd_dkv_tc", ""),
                       ("flash_attention_bwd_single_tile_tc", ""),
                       ("flash_attention_fwd", "flash_fwd_kernel"),
                       ("ragged_paged_attention", "ragged_chunk_kernel"),
                       ("ragged_paged_attention", "ragged_kernel"),
                       ("int8_matmul", "int8_matmul_wgmma_kernel"),
                       ("flash_attention_bwd", "flash_bwd_dq_kernel"),
                       ("flash_attention_bwd", "flash_bwd_dkv_kernel")):
        fns = {f: v for f, v in ptxas[n].items() if fn_part in f}
        spills = {f: v["spill"] for f, v in fns.items()
                  if "0 bytes spill stores, 0 bytes spill loads"
                  not in v["spill"]}
        if spills or not fns:
            raise AssertionError(f"{n}: ptxas reports spills: {spills}")

    import dataclasses

    cfg = dataclasses.replace(GPTConfig.gpt3_1_3b(), num_layers=SERVE_LAYERS)
    nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    kern = {}
    # each path's wall seconds (the kernels phase's and each driven path's)
    seconds_by_path = {}
    t_kernels = time.perf_counter()
    if "kernels" in phases:
        rag = kernel_phase_ragged(dev, args.iters, nh=nh, hd=hd)
        # chunk rows over a pool of 32-token pages (one page a key tile)
        rag += kernel_phase_ragged(dev, args.iters, nh=nh, hd=hd, ps=32,
                                   nps=64, chunk_only=True)
        # the generate phase's paged shapes: 4 slots of 34 pages, one
        # 512-token chunk row a prefill tick, 4 decode rows
        rag += kernel_phase_ragged(dev, args.iters, nh=nh, hd=hd, nps=34,
                                   slots=4, groups=generate_ragged_groups)
        # the spec phase's verify rows (T = 1 + k), reading no page past a
        # row's last real query
        rag += kernel_phase_ragged(dev, args.iters, nh=nh, hd=hd,
                                   groups=spec_ragged_groups)
        # the legacy engine's prefill row (R1 T256) and its fixed-shape
        # decode tick (R8 T1: idle rows, a slot at exactly its capacity)
        rag += kernel_phase_ragged(dev, args.iters, nh=nh, hd=hd,
                                   groups=legacy_ragged_groups)
        fl = kernel_phase_flash(dev, args.iters, [
            ((2, 1024, nh, hd), True, "float32"),      # the model's shape
            ((2, 1024, nh, hd), False, "float32"),
            ((2, 1000, nh, hd), True, "float32"),      # a ragged last tile
            ((4, 2048, nh, hd), True, "float32"),
            ((4, 2048, nh, hd), False, "float32"),
            ((4, 2048, nh, hd), True, "bfloat16"),
            ((4, 2048, nh, hd), False, "bfloat16"),
            # the tensor-core route: the train step's shape, its short
            # steps, a ragged tile, and D 64
            ((2, 2048, nh, hd), True, "bfloat16"),
            ((2, 1024, nh, hd), True, "bfloat16"),
            # ring attention's full (non-causal) chunk at S/sp = 1024
            ((2, 1024, nh, hd), False, "bfloat16"),
            ((2, 1000, nh, hd), True, "bfloat16"),
            ((2, 2048, 2 * nh, hd // 2), True, "bfloat16"),
            # bf16 at a head dim the tensor cores do not take: SIMT
            ((2, 1024, nh, 96), True, "bfloat16")])
        emit(sdpa_f32_kernels(dev, (2, 1024, nh, hd)))
        emit(sdpa_f32_bwd_kernels(dev, (2, 2048, nh, hd)))
        bw = kernel_phase_flash_bwd(dev, args.iters, [
            # row 2: S <= 1024 is one reference tile. bf16 at D 128 or 64
            # takes the tensor-core merged kernel: the train step's short
            # steps, a ragged tile, cross attention, D 64, and f32 out (the
            # atomically summed dQ scratch held at the f32 rtol)
            ((2, 1024, 1024, nh, hd), True, "bfloat16", False, False),
            ((2, 1000, 1000, nh, hd), True, "bfloat16", False, False),
            ((2, 512, 1024, nh, hd), False, "bfloat16", False, False),
            ((2, 1024, 1024, 2 * nh, hd // 2), True, "bfloat16", False,
             False),
            ((2, 1024, 1024, nh, hd), True, "bfloat16", True, False),
            # f32, and bf16 at another D: the mma.sync merged kernel; D 256
            # takes its 4-warp, two-pass instantiation
            ((2, 1024, 1024, nh, hd), True, "float32", False, False),
            ((2, 1000, 1000, nh, hd), True, "float32", False, False),
            ((2, 1024, 1024, nh, hd), False, "float32", False, False),
            ((2, 1024, 1024, nh, hd), True, "float32", True, True),
            ((2, 1024, 1024, 8, 256), True, "float32", False, False),
            ((2, 1024, 1024, nh, 96), True, "bfloat16", False, False),
            # every other instantiation: f32 D 64, bf16 D <= 64 and D 256;
            # D 40 and 80 end inside a group of column blocks
            ((2, 1024, 1024, 2 * nh, hd // 2), True, "float32", False,
             False),
            ((2, 1024, 1024, nh, 40), True, "float32", False, False),
            ((2, 1024, 1024, nh, 80), False, "float32", False, False),
            ((2, 1024, 1024, nh, 40), True, "bfloat16", False, False),
            ((2, 1024, 1024, 8, 256), True, "bfloat16", False, False),
            # rows 3/4: gpt3_1_3b's S = 2048 is 2 x 2 tiles; bf16 takes
            # the tensor-core dQ and dK/dV
            ((2, 2048, 2048, nh, hd), True, "bfloat16", False, False),
            # cross attention, ragged on either side (a pair case can be
            # ragged only where one side is a single tile)
            ((2, 1000, 2048, nh, hd), False, "bfloat16", False, False),
            ((2, 2048, 1000, nh, hd), False, "bfloat16", False, False),
            ((2, 2048, 2048, 2 * nh, hd // 2), True, "bfloat16", False,
             False),
            # ring attention's hooks: f32 out, a given delta
            ((2, 2048, 2048, nh, hd), True, "bfloat16", True, True),
            # the ring's chunks at S/sp = 1024 (the parallel phase's sp
            # run): the diagonal and a full chunk, the global delta given,
            # f32 partials; one bf16 flip of P or dS a row allowed
            ((2, 1024, 1024, nh, hd), True, "bfloat16", True, True, True),
            ((2, 1024, 1024, nh, hd), False, "bfloat16", True, True, True),
            ((2, 2048, 2048, nh, hd), False, "bfloat16", False, False),
            # f32, and bf16 at another D: the mma.sync dQ and dK/dV; cross
            # and ragged sides, D 64, D 256, a given delta
            ((2, 2048, 2048, nh, hd), True, "float32", False, False),
            ((2, 2048, 2048, nh, hd), False, "float32", False, False),
            ((2, 1000, 2048, nh, hd), False, "float32", False, False),
            ((2, 2048, 1000, nh, hd), False, "float32", False, False),
            ((2, 2048, 2048, 2 * nh, hd // 2), True, "float32", False,
             False),
            ((2, 2048, 2048, 8, 256), True, "float32", False, False),
            ((2, 2048, 2048, nh, hd), True, "float32", True, True),
            ((2, 2048, 2048, nh, 96), True, "bfloat16", False, False),
            ((2, 2048, 2048, nh, 40), True, "float32", False, False),
            ((2, 2048, 2048, nh, 80), False, "float32", False, False),
            ((2, 2048, 2048, nh, 40), True, "bfloat16", False, False),
            ((2, 2048, 2048, 8, 256), True, "bfloat16", False, False)])
        given_delta_check(dev, nh, hd)
        kern["ragged"] = next(r for r in rag if r["case"] == "decode_R8_T1"
                              and r["q_dtype"] == r["kv_dtype"] == "float32")
        kern["ragged_chunk"] = next(
            r for r in rag if r["case"] == "chunk_R2_T256"
            and r["q_dtype"] == r["kv_dtype"] == "float32")
        kern["ragged_verify"] = next(
            r for r in rag if r["case"] == "spec_R8_T5"
            and r["q_dtype"] == r["kv_dtype"] == "float32")
        kern["ragged_legacy_tick"] = next(
            r for r in rag if r["case"] == "legacy_decode_R8_T1"
            and r["q_dtype"] == r["kv_dtype"] == "float32")
        kern["ragged_legacy_prefill"] = next(
            r for r in rag if r["case"] == "legacy_chunk_R1_T256_p512"
            and r["q_dtype"] == r["kv_dtype"] == "float32")
        kern["flash"] = fl[0]
        kern["flash_tc"] = next(r for r in fl if r["route"] == "wgmma"
                                and r["case"] == f"B2_S2048_H{nh}_D{hd}_causal")
        # the ring's chunk shapes (the parallel phase's sp run)
        kern["flash_tc_ring"] = next(
            r for r in fl if r["route"] == "wgmma"
            and r["case"] == f"B2_S1024_H{nh}_D{hd}_full")
        kern["bwd_single_tc_ring"] = next(
            r for r in bw
            if r["kernel"] == "flash_attention_bwd_single_tile_tc"
            and r["case"] == f"B2_S1024_H{nh}_D{hd}_full_outf32_delta")
        # each backward kernel at its main path's shape: the train step's
        # (bf16, S 1024 and 2048) for the wgmma kernels, the f32 grad
        # paths' for the mma.sync ones
        for key, kname, dt, shape in (
                ("bwd_single", "flash_attention_bwd_single_tile", "float32",
                 f"B2_S1024_H{nh}_D{hd}_causal"),
                ("bwd_single_tc", "flash_attention_bwd_single_tile_tc",
                 "bfloat16", f"B2_S1024_H{nh}_D{hd}_causal"),
                ("bwd_dq", "flash_attention_bwd_dq", "float32",
                 f"B2_S2048_H{nh}_D{hd}_causal"),
                ("bwd_dq_tc", "flash_attention_bwd_dq_tc", "bfloat16",
                 f"B2_S2048_H{nh}_D{hd}_causal"),
                ("bwd_dkv", "flash_attention_bwd_dkv", "float32",
                 f"B2_S2048_H{nh}_D{hd}_causal"),
                ("bwd_dkv_tc", "flash_attention_bwd_dkv_tc", "bfloat16",
                 f"B2_S2048_H{nh}_D{hd}_causal")):
            kern[key] = next(r for r in bw if r["kernel"] == kname
                             and r["dtype"] == dt and r["case"] == shape)
        rq = kernel_phase_ragged_int8(dev, args.iters, nh=nh, hd=hd)
        rq += kernel_phase_ragged_int8(dev, args.iters, nh=nh, hd=hd,
                                       groups=spec_ragged_groups)
        kern["ragged_int8"] = next(
            r for r in rq if r["case"] == "decode_R8_T1"
            and r["q_dtype"] == "float32")
        # (M, K, N, x, relu, quant_out, out, bias[, route]): the deploy
        # model's two layers (fc1 under bf16 x with ReLU + requantize is
        # the main path's first product, fc2 under int8 x its second) on
        # the wgmma route, then ragged M and N with K % 16 == 0 (wgmma),
        # K 130 (the mma route), and fc1 and fc2 forced onto the mma route
        mm = kernel_phase_int8_matmul(dev, args.iters, [
            (4096, 4096, 16384, "bfloat16", True, True, "float32", True),
            (4096, 16384, 4096, "int8", False, False, "bfloat16", True),
            (4096, 4096, 16384, "float32", False, False, "float32", True),
            (4096, 4096, 16384, "bfloat16", False, False, "float32", True),
            (4096, 4096, 16384, "float32", True, True, "float32", True),
            (4100, 4096, 16390, "bfloat16", True, True, "float32", True),
            (4100, 4096, 16390, "float32", False, False, "bfloat16", False),
            (67, 144, 45, "int8", False, False, "float32", True),
            (67, 130, 45, "float32", False, False, "float32", True),
            (67, 130, 45, "float32", False, False, "float32", False),
            (67, 130, 45, "bfloat16", True, True, "float32", True),
            (67, 130, 45, "int8", False, False, "bfloat16", False),
            (4096, 4096, 16384, "bfloat16", True, True, "float32", True,
             "mma"),
            (4096, 16384, 4096, "int8", False, False, "bfloat16", True,
             "mma")])
        kern["int8_matmul_wgmma"] = mm[0]
        kern["int8_matmul"] = next(r for r in mm if r["route"] == "mma"
                                   and r["case"] == mm[0]["case"])
        # the quantize pass at fc1's x (bf16, the main path's), f32 x, and
        # a ragged element count
        iq = kernel_phase_int8_quantize(dev, args.iters, [
            (4096, 4096, "bfloat16"), (4096, 4096, "float32"),
            (67, 130, "bfloat16")])
        kern["int8_quantize"] = iq[0]
        seconds_by_path["kernels"] = time.perf_counter() - t_kernels

    from paddle_tpu_torch.core import rng as _rng

    # the main paths' launches: every count set to 0 just before a path
    # and read just after it; each path must launch each of its kernels
    launches = {k: 0 for k in LAUNCH_COUNTERS}
    by_path, by_t_path = {}, {}

    def drive(path, needs, fn, *a, forbid=(), remote=False, **kw):
        """Run one main path; it must launch every kernel of `needs` and
        none of `forbid`. Returns the path's result. `remote`: the path
        runs in other processes, and `fn` returns their counts (each
        process sets its counts to 0 just before its part of the path
        and reads them just after)."""
        t_path = time.perf_counter()
        set_counts()
        out = fn(*a, **kw)
        got, by_t_path[path] = out if remote else read_counts()
        seconds_by_path[path] = time.perf_counter() - t_path
        by_path[path] = got
        for k, n in got.items():
            launches[k] += n
        missing = [k for k in needs if got[k] == 0]
        if missing:
            raise AssertionError(f"the {path} path never launched {missing}")
        stray = [k for k in forbid if got[k] != 0]
        if stray:
            raise AssertionError(f"the {path} path launched {stray}")
        return out

    model = None
    if phases & {"model", "engine", "spec", "kvint8", "generate", "observe",
                 "handoff", "disagg"}:
        _rng.seed(0)
        model = GPT(cfg, device=dev)
        model.eval()
    if "model" in phases:
        drive("model", ("flash", "ragged", "ragged_chunk"), model_phase,
              model, dev,
              forbid=("flash_tc",))
    engine_kw = dict(num_slots=8, page_size=16, pages_per_slot=128,
                     prefill_chunk=256, prefill_chunks_per_tick=2)
    f32_run = {}
    if "engine" in phases:
        drive("engine", ("ragged", "ragged_chunk"), engine_phase, model, dev,
              keep=f32_run, **engine_kw)
    if "spec" in phases:
        drive("spec", ("ragged", "ragged_chunk", "ragged_int8"), spec_phase,
              model, dev, engine_kw, plain=f32_run.get("streams"), card=smi)
    if "kvint8" in phases:
        kvint8_reference(model, dev, f32_run, engine_kw)
        drive("kvint8", ("ragged", "ragged_chunk", "ragged_int8"),
              kvint8_phase, model, dev, f32_run, **engine_kw)
    if "generate" in phases:
        drive("generate", ("ragged", "ragged_chunk"), generate_phase, model,
              dev, engine_kw, forbid=("ragged_int8",))
    tc_kernels = ("flash_tc", "bwd_single_tc", "bwd_dq_tc", "bwd_dkv_tc")
    # the f32 route: the SIMT forward and the mma.sync backward kernels
    f32_kernels = ("flash", "bwd_single", "bwd_dq", "bwd_dkv")
    if "observe" in phases:
        # the engine's ticks and one bf16 train step at S 2048
        drive("observe", ("ragged", "ragged_chunk", "flash_tc", "bwd_dq_tc",
                          "bwd_dkv_tc"), observe_phase, model, dev,
              engine_kw, card=smi, forbid=("ragged_int8",) + f32_kernels)
    if "handoff" in phases:
        # the legacy engine's run, then the handoff and chain migration
        drive("legacy", ("ragged", "ragged_chunk"), legacy_phase, model, dev,
              engine_kw, forbid=("ragged_int8",))
        drive("handoff", ("ragged", "ragged_chunk", "ragged_int8"),
              handoff_phase, model, dev, engine_kw)
    if "disagg" in phases:
        # the serving mesh, two ranks on this card a run: A (rank 1
        # prefills, rank 0 decodes), B (symmetric), C (A's layout, rank 1
        # killed mid-handoff); both row kinds, not the int8 path
        drive("disagg", ("ragged", "ragged_chunk"), disagg_phase, model,
              dev, engine_kw, plain=f32_run.get("streams"), card=smi,
              forbid=("ragged_int8",), remote=True)
    del model, f32_run
    if "deploy" in phases:
        drive("deploy", ("int8_matmul_wgmma", "int8_quantize"),
              deploy_phase, dev, args.iters, forbid=("int8_matmul",))
    if "grad" in phases:
        # f32: the mma.sync pair at S 2048, the merged kernel at S 1024
        drive("grad", ("flash", "bwd_dq", "bwd_dkv"), grad_phase, dev,
              forbid=tc_kernels)
        drive("grad_s1024", ("flash", "bwd_single"), grad_phase, dev,
              seq=1024, forbid=tc_kernels)
        drive("grad_bf16", ("flash_tc", "bwd_dq_tc", "bwd_dkv_tc"),
              grad_phase, dev, dtype="bfloat16", forbid=f32_kernels)
    if "train" in phases:
        drive("train", tc_kernels, train_phase, dev, forbid=f32_kernels)
    if "dist" in phases:
        # two ranks on this card over gloo: the DP step at gpt3_1_3b
        # widths (f32, S 1024: the SIMT forward, the merged backward)
        drive("dist", ("flash", "bwd_single"), dist_phase, dev,
              forbid=tc_kernels, remote=True)
    if "hybrid" in phases:
        # the trainer on a {dp, tp} mesh, two ranks on this card: amp at
        # S 2048 (the wgmma forward, dQ and dK/dV at 8 or 16 local heads)
        drive("hybrid", ("flash_tc", "bwd_dq_tc", "bwd_dkv_tc"),
              hybrid_phase, dev, forbid=f32_kernels, remote=True)
    if "parallel" in phases:
        # the pipeline (GPipe interleaved), the ring over sp and expert
        # parallelism, two ranks on this card: amp at S 2048, the ring's
        # chunks at S 1024 (the wgmma forward and merged backward)
        drive("parallel", ("flash_tc", "bwd_single_tc", "bwd_dq_tc",
                           "bwd_dkv_tc"),
              parallel_phase, dev, forbid=f32_kernels, remote=True)
    if "resume" in phases:
        # checkpoints, the elastic restart (child processes) and host
        # offload, one rank: amp at S 2048 (the wgmma forward, dQ, dK/dV)
        drive("resume", ("flash_tc", "bwd_dq_tc", "bwd_dkv_tc"),
              resume_phase, dev, forbid=f32_kernels, remote=True)
    if "resilience" in phases:
        # the bad-step guard, the resilient runner's rollback, preemption
        # and the watchdog, in this process and in child lives on this
        # card: amp at S 2048 (the wgmma forward, dQ and dK/dV)
        drive("resilience", ("flash_tc", "bwd_dq_tc", "bwd_dkv_tc"),
              resilience_phase, dev, forbid=f32_kernels, remote=True)
    if "plan" in phases:
        # planning without allocation: no kernel runs (the 13B plans'
        # child processes check their own counts); then the resident
        # plan's step on the card, the allocator's readings of it
        planned = drive("plan", (), plan_phase, dev,
                        forbid=tuple(LAUNCH_COUNTERS))
        drive("plan_check", ("flash_tc", "bwd_dq_tc", "bwd_dkv_tc"),
              plan_allocator_check, dev, planned, forbid=f32_kernels)
        del planned
    if "bert" in phases:
        # the two kernels of BERT's path at its micro-batch's attention
        # (D 64, 12 heads, S 512 non-causal: one tile, the merged
        # backward), then BERT-base on this rank and ERNIE at ZeRO 3 on
        # two: the wgmma forward and merged backward, never the pair
        b, s_, h, d = BERT_ATTN
        kern["flash_tc_bert"] = kernel_phase_flash(
            dev, args.iters, [((b, s_, h, d), False, "bfloat16")])[0]
        kern["bwd_single_tc_bert"] = kernel_phase_flash_bwd(
            dev, args.iters, [((b, s_, s_, h, d), False, "bfloat16", False,
                               False)])[0]
        drive("bert", ("flash_tc", "bwd_single_tc"), bert_phase, dev,
              forbid=f32_kernels + ("bwd_dq_tc", "bwd_dkv_tc"))
        drive("ernie", ("flash_tc", "bwd_single_tc"), ernie_phase, dev,
              forbid=f32_kernels + ("bwd_dq_tc", "bwd_dkv_tc"), remote=True)
    if "vision" in phases:
        drive("vision", ("int8_matmul", "int8_matmul_wgmma",
                         "int8_quantize"), vision_phase, dev, args.iters,
              kern, forbid=f32_kernels + tc_kernels + (
                  "ragged", "ragged_chunk", "ragged_int8"))
    emit({"launches_by_path": by_path,
          "chunk_row_launches_by_t": by_t_path,
          "seconds_by_path": seconds_by_path})

    if kern:
        line = []
        bwd_src = "paddle_tpu_torch/csrc/flash_attention_bwd.cu"

        def kernel_entry(r, name, src, replaces, by_p, extra):
            return {"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": sum(by_p.values()),
                    "launches_by_path": by_p, "shape": r["case"],
                    "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                    "host_ms": r["host_ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"], **extra}

        for key, name, src, replaces in (
                ("flash", "flash_attention_fwd",
                 "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
                 "paddle_tpu/ops/flash_attention.py:118"),
                ("flash_tc", "flash_attention_fwd_tc",
                 "paddle_tpu_torch/csrc/flash_attention_fwd_tc.cu",
                 "paddle_tpu/ops/flash_attention.py:118"),
                ("bwd_single", "flash_attention_bwd_single_tile", bwd_src,
                 "paddle_tpu/ops/flash_attention.py:313"),
                ("bwd_single_tc", "flash_attention_bwd_single_tile_tc",
                 "paddle_tpu_torch/csrc/flash_attention_bwd_single_tile_tc.cu",
                 "paddle_tpu/ops/flash_attention.py:313"),
                ("bwd_dq", "flash_attention_bwd_dq", bwd_src,
                 "paddle_tpu/ops/flash_attention.py:221"),
                ("bwd_dq_tc", "flash_attention_bwd_dq_tc",
                 "paddle_tpu_torch/csrc/flash_attention_bwd_dq_tc.cu",
                 "paddle_tpu/ops/flash_attention.py:221"),
                ("bwd_dkv", "flash_attention_bwd_dkv", bwd_src,
                 "paddle_tpu/ops/flash_attention.py:264"),
                ("bwd_dkv_tc", "flash_attention_bwd_dkv_tc",
                 "paddle_tpu_torch/csrc/flash_attention_bwd_dkv_tc.cu",
                 "paddle_tpu/ops/flash_attention.py:264"),
                # the same kernels at ring attention's chunk shapes: their
                # launches in the parallel phase's sp run
                ("flash_tc_ring", "flash_attention_fwd_tc_ring_chunk",
                 "paddle_tpu_torch/csrc/flash_attention_fwd_tc.cu",
                 "paddle_tpu/ops/flash_attention.py:118"),
                ("bwd_single_tc_ring",
                 "flash_attention_bwd_single_tile_tc_ring_chunk",
                 "paddle_tpu_torch/csrc/flash_attention_bwd_single_tile_tc.cu",
                 "paddle_tpu/ops/flash_attention.py:313"),
                ("ragged", "ragged_paged_attention",
                 "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
                 "paddle_tpu/ops/paged_attention.py:294"),
                ("ragged_chunk", "ragged_paged_attention_chunk",
                 "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
                 "paddle_tpu/ops/paged_attention.py:294"),
                # the same kernel at the verify rows' shape: its launches
                # at T = 1 + k
                ("ragged_verify", "ragged_paged_attention_chunk_verify",
                 "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
                 "paddle_tpu/ops/paged_attention.py:294"),
                ("ragged_int8", "ragged_paged_attention_int8",
                 "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
                 "paddle_tpu/ops/paged_attention.py:294"),
                # the same kernel at the legacy engine's shapes: its decode
                # tick's rows and its prefill program's chunk row, launched
                # on the legacy path
                ("ragged_legacy_tick", "ragged_paged_attention_legacy_tick",
                 "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
                 "paddle_tpu/ops/paged_attention.py:294"),
                ("ragged_legacy_prefill",
                 "ragged_paged_attention_chunk_legacy_prefill",
                 "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
                 "paddle_tpu/ops/paged_attention.py:294"),
                ("int8_matmul", "int8_matmul",
                 "paddle_tpu_torch/csrc/int8_matmul.cu",
                 "paddle_tpu/ops/int8_matmul.py:50"),
                ("int8_matmul_wgmma", "int8_matmul_wgmma",
                 "paddle_tpu_torch/csrc/int8_matmul.cu",
                 "paddle_tpu/ops/int8_matmul.py:50"),
                ("int8_quantize", "int8_quantize",
                 "paddle_tpu_torch/csrc/int8_matmul.cu",
                 "paddle_tpu/ops/int8_matmul.py:50"),
                # the same kernels at BERT's micro-batch attention: their
                # launches on the bert and ernie paths
                ("flash_tc_bert", "flash_attention_fwd_tc_bert",
                 "paddle_tpu_torch/csrc/flash_attention_fwd_tc.cu",
                 "paddle_tpu/ops/flash_attention.py:118"),
                ("bwd_single_tc_bert",
                 "flash_attention_bwd_single_tile_tc_bert",
                 "paddle_tpu_torch/csrc/flash_attention_bwd_single_tile_tc.cu",
                 "paddle_tpu/ops/flash_attention.py:313")):
            if key not in kern:          # a phase subset without its row
                continue
            r = kern[key]
            extra = ({"bound_f32_fma_ms": r["bound_f32_fma_ms"]}
                     if "bound_f32_fma_ms" in r else {})
            if key == "ragged_verify":
                by_p = {p: n.get(1 + SPEC_K, 0)
                        for p, n in by_t_path.items()}
            elif key == "ragged_legacy_tick":
                by_p = {p: n["ragged"] - n["ragged_chunk"]
                        for p, n in by_path.items() if p == "legacy"}
            elif key == "ragged_legacy_prefill":
                by_p = {p: n.get(engine_kw["prefill_chunk"], 0)
                        for p, n in by_t_path.items() if p == "legacy"}
            elif key.endswith("_ring"):
                by_p = {"parallel_sp2": PARALLEL_RUN_COUNTS.get(
                    "sp2", {}).get(key[:-len("_ring")], 0)}
            elif key.endswith("_bert"):
                by_p = {p: n[key[:-len("_bert")]]
                        for p, n in by_path.items() if p in BERT_PATHS}
            else:
                # the vision path's products have a row a layer (below)
                by_p = {p: n[key] for p, n in by_path.items()
                        if p not in BERT_PATHS and not (
                            p == "vision" and key in VISION_ROWED)}
            line.append(kernel_entry(r, name, src, replaces, by_p, extra))
        vision = kern.get("vision_int8", [])
        for k in VISION_ROWED if vision else ():
            got = sum(r["launches"] for r in vision if r["kernel"] == k)
            if got != by_path["vision"][k]:
                raise AssertionError(f"the vision rows hold {got} launches "
                                     f"of {k}, the path made "
                                     f"{by_path['vision'][k]}")
        for r in vision:
            line.append(kernel_entry(
                r, r["name"], "paddle_tpu_torch/csrc/int8_matmul.cu",
                "paddle_tpu/ops/int8_matmul.py:50",
                {"vision": r["launches"]}, {}))
        emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
