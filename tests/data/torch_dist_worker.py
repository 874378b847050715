"""One rank of the port's multi-rank CPU test jobs (gloo on the CPU).

    python tests/data/torch_dist_worker.py <job> <out_dir>

``launch_job`` (imported by the tests) starts one such process per rank
with the env protocol of ``paddle_tpu_torch.distributed.launch`` and a
``file://`` store in ``out_dir`` (no TCP port to race for under xdist).
Each rank reads ``<out_dir>/inputs.npz`` (written by the test from a
seed), runs every check of its job, and writes ``<out_dir>/out.<rank>
.npz`` (arrays) and ``<out_dir>/out.<rank>.json`` (values); the tests
compare those with the JAX package's results. A rank never imports JAX
or the JAX package: each records its ``sys.modules`` verdict.

Jobs: ``collectives`` (2 ranks: the eager API, its accounting,
``fleet.metrics``, ``MetricsRegistry.aggregate``), ``mesh`` (4 ranks, a
{"dp": 2, "tp": 2} mesh: the primitives' outputs, gradients and
accounting), ``dp`` (2 ranks: DataParallel and the fleet optimizer on
gpt_tiny, gradient merge, LocalSGD), ``tp`` (2 ranks: the
tensor-parallel layers at tp = 2), ``gpt_tp`` (GPT at tp = 2: the qkv
shard's heads, logits, loss and gradients, the state's round trip),
``hybrid`` (the trainer cases listed in ``inputs.npz``: mesh, ZeRO stage,
amp, recompute, storage dtypes; 2 or 4 ranks), ``compile``
(``compile_train_step`` with a ``loss_fn`` and gradient merge) and
``dp_pair`` (the eager DataParallel + fleet optimizer pair against the
trainer at dp = 2), ``qring`` (the int8 ring of ``qcomm`` on 2 or 4
ranks) and ``ckpt`` (sharded checkpoints of plain pieces). A ``hybrid``
case may name ``"trainer": "compile"`` (``compile_train_step``) and
``"ckpt": true``: its ``device_state`` after the steps is saved under
``<out_dir>/ckpt/<name>``.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# the test side: start a job and read its results
# ---------------------------------------------------------------------------
def launch_job(job, nranks, out_dir, timeout=120):
    """Run ``job`` on ``nranks`` ranks; returns [(arrays, values)] per
    rank. Raises with every rank's log tail if a rank fails."""
    out_dir = str(out_dir)
    store = os.path.join(out_dir, "store")
    eps = [f"127.0.0.1:{6170 + r}" for r in range(nranks)]
    procs, logs = [], []
    for r in range(nranks):
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(r), "PADDLE_TRAINERS_NUM": str(nranks),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(eps),
            "PADDLE_CURRENT_ENDPOINT": eps[r],
            "PADDLE_RANK_IN_NODE": str(r),
            "PADDLE_COORDINATOR": "file://" + store,
            "PADDLE_DISTRI_BACKEND": "cpu", "OMP_NUM_THREADS": "1",
            "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", "")})
        log = open(os.path.join(out_dir, f"log.{r}"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), job, out_dir],
            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=REPO))
    deadline = time.time() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.time() > deadline or any(p.poll() not in (None, 0)
                                             for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    if any(p.returncode != 0 for p in procs):
        tails = ""
        for r in range(nranks):
            with open(os.path.join(out_dir, f"log.{r}")) as f:
                tails += f"\n--- rank {r} (rc {procs[r].returncode}) ---\n" \
                    + f.read()[-3000:]
        raise RuntimeError(f"job {job} failed:{tails}")
    out = []
    for r in range(nranks):
        arrays = dict(np.load(os.path.join(out_dir, f"out.{r}.npz")))
        with open(os.path.join(out_dir, f"out.{r}.json")) as f:
            out.append((arrays, json.load(f)))
    return out


# ---------------------------------------------------------------------------
# the rank side
# ---------------------------------------------------------------------------
def _hygiene():
    return sorted(m for m in sys.modules if m == "jax" or
                  m.startswith("jax.") or m == "paddle_tpu" or
                  m.startswith("paddle_tpu."))


def job_collectives(inp, rank, arrays, values):
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.fleet import metrics as fm
    from paddle_tpu_torch.profiler import instrument

    x = torch.from_numpy(inp[f"x{rank}"])
    with instrument.count_collectives() as cc:
        for name, op in (("sum", C.ReduceOp.SUM), ("max", C.ReduceOp.MAX),
                         ("min", C.ReduceOp.MIN), ("prod", C.ReduceOp.PROD)):
            t = x.clone()
            assert C.all_reduce(t, op) is t
            arrays[f"all_reduce_{name}"] = t.numpy()
        ti = torch.from_numpy(inp[f"i{rank}"])
        C.all_reduce(ti, C.ReduceOp.MAX)
        arrays["all_reduce_int_max"] = ti.numpy()
        tb = x.to(torch.bfloat16)
        C.all_reduce(tb)
        arrays["all_reduce_bf16"] = tb.float().numpy()
        lst = []
        C.all_gather(lst, x)
        arrays["all_gather"] = torch.stack(lst).numpy()
        t = x.clone()
        C.broadcast(t, src=1)
        arrays["broadcast"] = t.numpy()
        t = x.clone()
        C.reduce(t, dst=0)
        arrays["reduce"] = t.numpy()
        t = torch.zeros_like(x)
        C.scatter(t, [torch.from_numpy(a) for a in inp[f"parts{rank}"]],
                  src=0)
        arrays["scatter"] = t.numpy()
        t = torch.zeros_like(x)
        C.reduce_scatter(t, [torch.from_numpy(a)
                             for a in inp[f"parts{rank}"]])
        arrays["reduce_scatter"] = t.numpy()
        out = []
        C.alltoall([torch.from_numpy(a) for a in inp[f"parts{rank}"]], out)
        arrays["alltoall"] = torch.stack(out).numpy()
        C.barrier()
    values["stats"] = instrument.collective_stats(cc)
    try:
        C.send(x, 1 - rank)
        values["send_raises"] = False
    except NotImplementedError:
        values["send_raises"] = True

    # fleet.metrics on this rank's share of the inputs
    values["fm_sum_scalar"] = fm.sum(float(inp["fm_scalar"][rank]))
    arrays["fm_sum_array"] = fm.sum(inp["fm_array"][rank])
    arrays["fm_max_array"] = fm.max(torch.from_numpy(inp["fm_array"][rank]))
    arrays["fm_min_array"] = fm.min(inp["fm_array"][rank].tolist())
    values["fm_max_scalar"] = fm.max(float(inp["fm_scalar"][rank]))
    values["fm_min_scalar"] = fm.min(float(inp["fm_scalar"][rank]))
    values["fm_acc"] = fm.acc(int(inp["fm_correct"][rank]),
                              int(inp["fm_total"][rank]))
    values["fm_auc"] = fm.auc(inp["fm_pos"][rank], inp["fm_neg"][rank])

    # the registry's rank reduction: rank-dependent schemas and samples
    profiler.enable()
    reg = profiler.registry()
    for v in inp[f"h{rank}"]:
        reg.histogram("m/h").observe(float(v))
    reg.counter("m/c").add(float(rank + 4))
    reg.gauge("m/g").set(float(inp["gauge"][rank]))
    if rank == 0:
        reg.histogram("m/only0").observe(3.5)
        reg.histogram("m/empty")
    else:
        reg.counter("m/only1").add(2.0)
        reg.gauge("m/unset")
    values["aggregate"] = reg.aggregate()
    values["summary_aggregate"] = profiler.summary(aggregate=True)["metrics"]


#: the mesh job's axes named against the mesh's order
TPDP = ("tp", "dp")


def _mesh_forward(P, x, rank):
    """The primitives program of the mesh job: (named outputs, the
    differentiable ones)."""
    import torch

    outs = {
        "psum_tp": P.psum(x, "tp"),
        "pmean_dp": P.pmean(x, "dp"),
        "psum_all": P.psum(x, ("dp", "tp")),
        "gather_dp_tiled": P.all_gather(x, "dp", axis=0, tiled=True),
        "gather_tp_stacked": P.all_gather(x, "tp", axis=1),
        "a2a_tp_tiled": P.all_to_all(x, "tp", 1, 0, tiled=True),
        "a2a_tp": P.all_to_all(x, "tp", 0, 1),
        "ppermute_dp": P.ppermute(x, "dp", [(0, 1), (1, 0)]),
        "ppermute_partial": P.ppermute(x, "tp", [(0, 1)]),
        "ring_tp": P.ring_permute(x, "tp", shift=1),
        # a tuple named out of the mesh's order: axis index tp * 2 + dp
        "gather_tpdp_tiled": P.all_gather(x, TPDP, axis=0, tiled=True),
        "scatter_tpdp": P.psum_scatter(x, TPDP, scatter_dimension=1,
                                       tiled=True),
        "a2a_tpdp_tiled": P.all_to_all(x, TPDP, 1, 0, tiled=True),
        "ppermute_tpdp": P.ppermute(x, TPDP, [(0, 1), (1, 2), (2, 3),
                                              (3, 0)]),
    }
    outs["scatter_dp"] = P.psum_scatter(outs["gather_dp_tiled"], "dp",
                                        scatter_dimension=0, tiled=True)
    outs["scatter_tp_untiled"] = P.psum_scatter(outs["gather_tp_stacked"],
                                                "tp", scatter_dimension=1,
                                                tiled=False)
    grads = dict(outs)
    with torch.no_grad():
        outs["pmax_tp"] = P.pmax(x, "tp")
        outs["pmin_dp"] = P.pmin(x, "dp")
    outs["index"] = (P.axis_index("dp") * 10 + P.axis_index("tp")).float()
    outs["index_tpdp"] = P.axis_index(TPDP).float()
    outs["psum_const"] = torch.tensor(float(P.psum(1, ("dp", "tp"))))
    return outs, grads


def job_mesh(inp, rank, arrays, values):
    import torch

    from paddle_tpu_torch.distributed import mesh
    from paddle_tpu_torch.distributed import primitives as P
    from paddle_tpu_torch.profiler import instrument

    m = mesh.init_mesh({"dp": 2, "tp": 2})
    values["coords"] = [m.axis_index("dp"), m.axis_index("tp")]
    x = torch.from_numpy(inp["x"][rank]).requires_grad_()
    with instrument.count_collectives() as fwd:
        outs, diff = _mesh_forward(P, x, rank)
    values["stats"] = instrument.collective_stats(fwd)
    loss = sum((o * torch.from_numpy(inp[f"w_{k}"][rank])).sum()
               for k, o in sorted(diff.items()) if f"w_{k}" in inp)
    loss.backward()
    for k, o in outs.items():
        arrays[k] = o.detach().numpy()
    arrays["grad"] = x.grad.numpy()
    y = torch.from_numpy(inp["x"][rank]).requires_grad_()
    try:
        P.pmax(y, "tp").sum().backward()
        values["pmax_grad_raises"] = False
    except NotImplementedError:
        values["pmax_grad_raises"] = True
    try:
        P.psum(x, "ep")
        values["unbound_raises"] = False
    except NameError:
        values["unbound_raises"] = True


def _flat(params):
    import torch

    return torch.cat([p.detach().reshape(-1) for p in params])


def _gpt(inp, cfg):
    from paddle_tpu_torch.models import gpt as tgpt

    net = tgpt.GPT(tgpt.GPTConfig(**cfg), device="cpu")
    tgpt.load_reference_state(net, {k[6:]: v for k, v in inp.items()
                                    if k.startswith("state.")})
    return net


def job_dp(inp, rank, arrays, values):
    import torch

    import paddle_tpu_torch
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import instrument

    cfg = json.loads(str(inp["cfg"]))
    lr = float(inp["lr"])
    fleet.init(is_collective=True)
    values["worker"] = [fleet.worker_index(), fleet.worker_num(),
                        fleet.is_first_worker(),
                        fleet.worker_endpoints(to_string=True)]

    # DataParallel: rank 1 starts from other weights; the wrap broadcasts
    # rank 0's
    net = _gpt(inp, cfg)
    if rank == 1:
        with torch.no_grad():
            for p in net.parameters():
                p.add_(0.5)
    dp = paddle_tpu_torch.DataParallel(net)
    names = [n for n, _ in net.named_parameters()]
    values["names"] = names
    opt = AdamW(lr, parameters=net.named_parameters(), weight_decay=0.01)
    dopt = fleet.distributed_optimizer(opt)
    tok = torch.from_numpy(inp["tok"][rank])
    with instrument.count_collectives() as cc:
        loss = dp._layers.loss(tok)
        loss.backward()
        dp.apply_collective_grads()
        for n, p in net.named_parameters():
            arrays[f"grad.{n}"] = p.grad.numpy().copy()
        dopt.step()
    values["stats"] = instrument.collective_stats(cc)
    values["numel"] = sum(p.numel() for p in net.parameters())
    values["n_params"] = len(names)
    for n, p in net.named_parameters():
        arrays[f"param.{n}"] = p.detach().numpy().copy()
    values["loss"] = float(loss)

    # gradient merge, k 2: two micro-steps, one update
    net = _gpt(inp, cfg)
    s = DistributedStrategy()
    s.gradient_merge = True
    s.gradient_merge_configs = {"k_steps": 2, "avg": True}
    opt = AdamW(lr, parameters=net.named_parameters(), weight_decay=0.01)
    dopt = fleet.distributed_optimizer(opt, s)
    before = _flat(net.parameters()).clone()
    for i in range(2):
        net.loss(torch.from_numpy(inp["merge_tok"][rank, i])).backward()
        dopt.step()
        if i == 0:
            values["merge_first_is_noop"] = bool(torch.equal(
                before, _flat(net.parameters())))
    for n, p in net.named_parameters():
        arrays[f"merge_grad.{n}"] = p.grad.numpy().copy()
    opt.clear_grad()

    # LocalSGD with AdamW: different data on each rank, params averaged
    # every 3 steps; then adaptive LocalSGD (constant lr: k = init_k)
    for kind, k, steps in (("localsgd", 3, 6), ("adaptive_localsgd", 2, 4)):
        net = _gpt(inp, cfg)
        s = DistributedStrategy()
        setattr(s, kind, True)
        if kind == "localsgd":
            s.localsgd_configs = {"k_steps": k, "begin_step": 1}
        else:
            s.adaptive_localsgd_configs = {"init_k_steps": k,
                                           "begin_step": 1}
        opt = AdamW(lr, parameters=net.named_parameters(), weight_decay=0.01)
        dopt = fleet.distributed_optimizer(opt, s)
        synced = []
        for step in range(steps):
            net.loss(torch.from_numpy(inp["local_tok"][rank, step])).backward()
            dopt.step()
            opt.clear_grad()
            mine = _flat(net.parameters())
            both = []
            C.all_gather(both, mine)
            synced.append(bool(torch.equal(both[0], both[1])))
        values[kind] = synced


def job_tp(inp, rank, arrays, values):
    import torch

    from paddle_tpu_torch.distributed import mesh
    from paddle_tpu_torch.distributed import parallel_layers as PL
    from paddle_tpu_torch.models.gpt import load_reference_state
    from paddle_tpu_torch.profiler import instrument

    m = mesh.init_mesh({"tp": 2})
    h, f, v = (int(a) for a in inp["dims"])

    def load(layer, prefix):
        full = {k[len(prefix):]: a for k, a in inp.items()
                if k.startswith(prefix)}
        load_reference_state(layer, PL.shard_reference_state(layer, full, m))
        values[f"shapes.{prefix}"] = {n: list(p.shape) for n, p in
                                      layer.named_parameters()}
        return layer

    def run(name, layers, x, w):
        x = torch.from_numpy(x).requires_grad_(x.dtype.kind == "f")
        y = x
        for i, layer in enumerate(layers):
            y = layer(y)
            if name == "mlp" and i == 0:
                y = torch.nn.functional.gelu(y)
        arrays[f"{name}.out"] = y.detach().numpy()
        (y * torch.from_numpy(w)).sum().backward()
        if x.requires_grad:
            arrays[f"{name}.dx"] = x.grad.numpy()
        for i, layer in enumerate(layers):
            for n, p in layer.named_parameters():
                arrays[f"{name}.{i}.{n}"] = p.grad.numpy()

    col = load(PL.ColumnParallelLinear(h, f, gather_output=False, device="cpu"),
               "col.")
    row = load(PL.RowParallelLinear(f, h, input_is_parallel=True,
                                    device="cpu"), "row.")
    with instrument.count_collectives() as cc:
        run("mlp", [col, row], inp["x"], inp["w_mlp"])
    values["mlp_stats"] = instrument.collective_stats(cc)
    colg = load(PL.ColumnParallelLinear(h, f, gather_output=True,
                                        device="cpu"), "col.")
    run("col_gather", [colg], inp["x"], inp["w_col"])
    rowf = load(PL.RowParallelLinear(f, h, input_is_parallel=False,
                                     device="cpu"), "row.")
    run("row_full", [rowf], inp["xf"], inp["w_mlp"])
    emb = load(PL.VocabParallelEmbedding(v, h, device="cpu"), "emb.")
    run("emb", [emb], inp["ids"], inp["w_mlp"])
    ce = PL.ParallelCrossEntropy()
    z = torch.from_numpy(inp["logits"]).chunk(2, -1)[m.axis_index("tp")]
    z = z.contiguous().requires_grad_()
    loss = ce(z, torch.from_numpy(inp["labels"]))
    loss.backward()
    values["ce"] = float(loss)
    arrays["ce.dz"] = z.grad.numpy()
    values["specs"] = {
        "col": [list(col.param_shardings["weight"]),
                list(col.param_shardings["bias"]),
                list(col.output_sharding), list(colg.output_sharding)],
        "row": [list(row.param_shardings["weight"]),
                list(row.param_shardings["bias"]),
                list(row.output_sharding)],
        "emb": [list(emb.param_shardings["weight"])]}


# ---------------------------------------------------------------------------
# the strategy compiler and the hybrid trainer
# ---------------------------------------------------------------------------
def _state(inp):
    return {k[6:]: v for k, v in inp.items() if k.startswith("state.")}


def _gpt_sharded(inp, cfg, axes):
    """A port GPT built under a mesh of ``axes``, loaded with this rank's
    shard of the reference state; (mesh, model)."""
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed import parallel_layers as PL
    from paddle_tpu_torch.models import gpt as tgpt

    m = M.init_mesh(axes)
    net = tgpt.GPT(tgpt.GPTConfig(**cfg), device="cpu")
    tgpt.load_reference_state(net, PL.shard_reference_state(
        net, _state(inp), m))
    return m, net


def job_gpt_tp(inp, rank, arrays, values):
    import torch

    from paddle_tpu_torch.distributed import parallel_layers as PL
    from paddle_tpu_torch.models import gpt as tgpt
    from paddle_tpu_torch.profiler import instrument

    cfg = json.loads(str(inp["cfg"]))
    m, net = _gpt_sharded(inp, cfg, {"tp": 2})
    state = _state(inp)
    local = tgpt.state_to_numpy(net)
    values["qkv_shape"] = list(local["blocks.0.attn.qkv_proj.weight"].shape)
    # the qkv shard holds heads [2r, 2r+2) of q, k and v
    nh, h = cfg["num_heads"], cfg["hidden_size"]
    hd = h // nh
    full = state["blocks.0.attn.qkv_proj.weight"].reshape(h, 3, nh, hd)
    want = full[:, :, 2 * rank:2 * rank + 2].reshape(h, -1)
    values["qkv_heads_exact"] = bool(np.array_equal(
        local["blocks.0.attn.qkv_proj.weight"], want))
    fb = state["blocks.0.attn.qkv_proj.bias"].reshape(3, nh, hd)
    values["qkv_bias_heads_exact"] = bool(np.array_equal(
        local["blocks.0.attn.qkv_proj.bias"],
        fb[:, 2 * rank:2 * rank + 2].reshape(-1)))
    back = PL.gather_reference_state(net)
    values["roundtrip_exact"] = sorted(
        n for n, a in back.items() if not np.array_equal(a, state[n]))
    values["roundtrip_names"] = sorted(back) == sorted(state)
    tok = torch.from_numpy(inp["tok"]).long()
    net.eval()
    with torch.no_grad():
        arrays["logits"] = net(tok).numpy()
    net.train()
    with instrument.count_collectives() as cc:
        loss = net.loss(tok)
        loss.backward()
    values["loss_stats"] = instrument.collective_stats(cc)
    values["loss"] = float(loss)
    grads = PL.gather_reference_state(
        net, {n: p.grad.numpy() for n, p in net.named_parameters()})
    for n, g in grads.items():
        arrays[f"grad.{n}"] = g
    try:
        net.generate(tok[:, :4], max_new_tokens=2)
        values["generate_raises"] = ""
    except NotImplementedError as e:
        values["generate_raises"] = str(e)


def job_tp_rng_clip(inp, rank, arrays, values):
    """GPT at tp 2 under the trainer: (1) at dropout 0.1, one step's
    gradients with and without recompute (the checkpointed blocks must
    draw the same replicated-region masks again), the embeddings' output
    under a key scope and the replicated parameters' gradients, both to
    be compared across the tp ranks; (2) at dropout 0 with
    ``embeddings.wte.weight`` frozen, the reduced gradients before the
    global-norm clip and the first moments after one step, gathered."""
    import torch

    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.core import rng as trng
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed import parallel_layers as PL
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.hybrid_gpt import GPTHybridTrainer
    from paddle_tpu_torch.optimizer import AdamW

    cfg = json.loads(str(inp["cfg"]))
    tok = torch.from_numpy(inp["tok"]).long()

    def trainer(net, recompute=False, clip=None):
        opt = AdamW(float(inp["lr"]), parameters=net.named_parameters(),
                    grad_clip=clip)
        s = DistributedStrategy()
        s.recompute = recompute
        return GPTHybridTrainer(net, opt, s, M.get_mesh())

    for name, recompute in (("plain", False), ("remat", True)):
        m, net = _gpt_sharded(inp, dict(cfg, dropout=float(inp["p"])),
                              {"tp": 2})
        tr = trainer(net, recompute)
        torch.manual_seed(11)             # the attention probabilities'
        tr._step = 1
        values[f"{name}.loss"] = float(tr._loss((tok,), backward=True))
        for n, p in net.named_parameters():
            arrays[f"{name}.grad.{n}"] = p.grad.numpy().copy()
        M.set_mesh(None)
    net.train()
    with trng.key_scope(5):
        arrays["stem"] = net.pipeline_stem(tok).detach().numpy()
    with torch.no_grad():
        arrays["stem_eval"] = net.eval().pipeline_stem(tok).numpy()

    m, net = _gpt_sharded(inp, cfg, {"tp": 2})
    net.embeddings.wte.weight.requires_grad_(False)
    tr = trainer(net, clip=tnn.ClipGradByGlobalNorm(float(inp["clip"])))
    tr._loss((tok,), backward=True)
    grads = tr._upd._reduced_grads()
    live = {n: g.numpy().copy() for n, g in zip(tr._names, grads)
            if g is not None}
    values["frozen_without_grad"] = sorted(set(tr._names) - set(live))
    for n, g in PL.gather_reference_state(net, live).items():
        arrays[f"clip.before.{n}"] = g
    tr._upd.zero_grad()
    tr.step(tok)              # AdamW's first moment is 0.1 x the clipped g
    tr.sync_to_layer()
    m1 = {n: tr.optimizer._accumulators[id(p)]["moment1"].numpy()
          for n, p in net.named_parameters()}
    for n, m in PL.gather_reference_state(net, m1).items():
        arrays[f"clip.moment1.{n}"] = m
    M.set_mesh(None)


def _trainer_case(inp, case, rank, arrays, values):
    """One trainer case: build, train ``steps`` steps on the global batch,
    record losses, the first step's collectives, the ledger and the
    gathered state."""
    import torch

    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed import parallel_layers as PL
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.hybrid_gpt import GPTHybridTrainer
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import instrument, recompile

    name = case["name"]
    cfg = dict(json.loads(str(inp["cfg"])), **case.get("cfg", {}))
    m, net = _gpt_sharded(inp, cfg, case["mesh"])
    clip = case.get("clip", float(inp["clip"]))
    opt = AdamW(float(inp["lr"]), parameters=net.named_parameters(),
                weight_decay=0.01, grad_clip=None if clip is None
                else tnn.ClipGradByGlobalNorm(clip))
    s = DistributedStrategy()
    s.amp, s.recompute = case.get("amp", False), case.get("recompute",
                                                          False)
    if case.get("zero"):
        s.sharding = True
        s.sharding_configs = {"sharding_stage": case["zero"]}
    keys = ("dp_param_comm", "dp_grad_comm", "dp_grad_block")
    if case.get("trainer") == "compile":
        from paddle_tpu_torch.distributed.strategy_compiler import \
            compile_train_step

        tr = compile_train_step(net, opt, s, m,
                                **{k: case[k] for k in keys if k in case})
        tr.circuits = None
    else:
        keys += ("param_dtype", "moment_dtype", "remat_policy", "n_micro",
                 "v_virtual", "offload_optimizer", "offload_params",
                 "offload_depth", "stream_layers", "comp_resident",
                 "conservative_fetch")
        tr = GPTHybridTrainer(net, opt, s, m,
                              **{k: case[k] for k in keys if k in case})
    values[f"{name}.zero_manual"] = tr.zero_manual
    values[f"{name}.dp_param_comm"] = tr.dp_param_comm
    values[f"{name}.circuits"] = tr.circuits
    values[f"{name}.held"] = sorted(
        n for n, p in net.named_parameters() if p.numel())
    if case.get("grads"):
        # step 0's gradients, summed over pp and sp (no update)
        tok = torch.from_numpy(inp["steps_tok"][0][:case.get("batch")])
        tr._upd.zero_grad()
        tr._loss((tok.long(),), backward=True)
        wte = tr._upd.leaves()[tr._index["embeddings.wte.weight"]]
        if wte.grad is not None:       # this stage's part, before the sums
            arrays[f"{name}.wte_part"] = wte.grad.float().numpy().copy()
        # the clip's global norm (summed over pp, sp and ep)
        values[f"{name}.grad_norm"] = tr._upd.global_norm()
        for n, t in zip(tr._names, tr._upd.leaves()):
            arrays[f"{name}.grad.{n}"] = t.grad.float().numpy().copy()
        tr._upd.zero_grad()
    losses = []
    for i, tok in enumerate(inp["steps_tok"]):
        tok = torch.from_numpy(tok[:case.get("batch")]).long()
        if i == 0:
            with instrument.count_collectives() as cc:
                losses.append(float(tr.step(tok)))
            values[f"{name}.stats"] = instrument.collective_stats(cc)
        else:
            losses.append(float(tr.step(tok)))
    values[f"{name}.losses"] = losses
    values[f"{name}.ledger"] = tr.memory_ledger()
    values[f"{name}.traces"] = recompile.trace_counts().get(tr._prof_site)
    values[f"{name}.numel"] = sum(p.numel() for p in net.parameters()
                                  if p.numel())
    if case.get("ckpt"):
        from paddle_tpu_torch.distributed import checkpoint as dck

        dck.save(os.path.join(_OUT[0], "ckpt", name), tr.device_state(),
                 step=len(losses), meta={"step": len(losses)}, async_=False)
    tr.sync_to_layer()
    full = PL.gather_reference_state(net)
    moments = {}
    for n, p in net.named_parameters():
        if id(p) in opt._accumulators:     # this rank's stage
            moments[n] = opt._accumulators[id(p)]["moment1"].float().numpy()
    full_m = PL.gather_reference_state(net, moments)
    if rank == 0:
        for n, a in full.items():
            arrays[f"{name}.param.{n}"] = a
        for n, a in full_m.items():
            arrays[f"{name}.moment1.{n}"] = a
    M.set_mesh(None)


def job_hybrid(inp, rank, arrays, values):
    for case in json.loads(str(inp["cases"])):
        _trainer_case(inp, case, rank, arrays, values)


def job_qring(inp, rank, arrays, values):
    """The int8 ring on this job's ranks ({"dp": n}): rank r's row of
    ``x`` through ``quantized_reduce_scatter`` (its chunk),
    ``quantized_all_gather`` of that chunk, ``quantized_all_reduce``
    (mean) with its counted collectives, the fused tree of ``a`` (f32)
    and ``b`` (bf16), and ``dp_quantized_value_and_grads`` on a linear
    least-squares loss."""
    import torch

    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed import qcomm
    from paddle_tpu_torch.distributed.mesh import P
    from paddle_tpu_torch.profiler import instrument

    x = torch.from_numpy(inp["x"])
    n, blk = x.shape[0], int(inp["block"])
    m = M.init_mesh({"dp": n})
    mine = x[rank]
    chunk = qcomm.quantized_reduce_scatter(mine, m, n, block=blk)
    arrays["rs"] = chunk.numpy()
    arrays["rs_mean"] = qcomm.quantized_reduce_scatter(
        mine, m, n, block=blk, mean=True).numpy()
    arrays["ag"] = qcomm.quantized_all_gather(chunk, m, block=blk).numpy()
    y = torch.from_numpy(inp["y"][rank])
    with instrument.count_collectives() as cc:
        arrays["ar"] = qcomm.quantized_all_reduce(y, m, n, block=blk,
                                                  mean=True).numpy()
    values["ar_stats"] = instrument.collective_stats(cc)
    tree = {"a": torch.from_numpy(inp["ta"][rank]),
            "b": torch.from_numpy(inp["tb"][rank]).to(torch.bfloat16)}
    out = qcomm.quantized_all_reduce_tree(tree, m, n, block=64)
    arrays["tree_a"] = out["a"].numpy()
    arrays["tree_b"] = out["b"].float().numpy()
    values["tree_dtypes"] = [str(out["a"].dtype), str(out["b"].dtype)]

    w = torch.from_numpy(inp["w"])
    xb, yb = torch.from_numpy(inp["xb"]), torch.from_numpy(inp["yb"])

    def fn(rep_args, key, batch):
        wt = rep_args.clone().requires_grad_(True)
        loss = ((batch[0] @ wt - batch[1]) ** 2).mean()
        loss.backward()
        return loss.detach(), {"n": torch.tensor(batch[0].shape[0])}, \
            {"w": wt.grad}

    loss, aux, grads = qcomm.dp_quantized_value_and_grads(
        m, n, 64, fn, w, (xb, yb), (P("dp"), P("dp")), 0)
    values["vg_loss"] = float(loss)
    values["vg_rows"] = int(aux["n"])
    arrays["vg_grad"] = grads["w"].numpy()
    M.set_mesh(None)


def job_ckpt(inp, rank, arrays, values):
    """Sharded checkpoints of plain pieces on 2 ranks: rank r holds row
    block r of ``w`` [8, 8] (and its bf16 vector's half), saved sync as
    step 3 and, with ``snapshot_async``, as step 4 after which the pieces
    are overwritten once ``wait_snapshot`` has passed; then every rank
    restores step 3 whole and step 4 as its own piece."""
    import torch

    from paddle_tpu_torch.distributed import checkpoint as dck

    d = os.path.join(_OUT[0], "ckpt_plain")
    w = torch.from_numpy(inp["w"])
    b = torch.from_numpy(inp["b"]).to(torch.bfloat16)
    mine = w[4 * rank:4 * rank + 4].clone()
    bh = b[4 * rank:4 * rank + 4].clone()
    state = {"w": dck.Sharded(mine, (8, 8), [[4 * rank, 4 * rank + 4],
                                            [0, 8]]),
             "nested": {"b": dck.Sharded(bh, (8,), [[4 * rank,
                                                     4 * rank + 4]])}}
    dck.save(d, state, step=3, meta={"k": 1}).wait()
    h = dck.save(d, state, step=4, snapshot_async=True)
    h.wait_snapshot()
    mine.add_(1000.0)                  # after the gate: not in step 4
    bh.fill_(7)
    h.wait()
    values["steps"] = dck.all_steps(d)
    whole = dck.restore(d, {"w": w, "nested": {"b": b}}, step=3,
                        verify=True)
    arrays["w3"] = whole["w"].numpy()
    arrays["b3"] = whole["nested"]["b"].float().numpy()
    own = dck.restore(d, state, step=4)
    arrays["w4_own"] = own["w"].data.numpy()
    values["w4_index"] = own["w"].index
    if "cases" in inp:
        job_hybrid(inp, rank, arrays, values)


def job_compile(inp, rank, arrays, values):
    import torch

    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.strategy_compiler import \
        compile_train_step
    from paddle_tpu_torch.models import gpt as tgpt
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import instrument

    cfg = json.loads(str(inp["cfg"]))
    v = cfg["vocab_size"]

    def ce(out, lbl):
        return torch.nn.functional.cross_entropy(
            out.reshape(-1, v).float(), lbl.reshape(-1).long())

    for name, zero, loss_fn in (("loss_fn", 0, ce), ("model_loss", 2, None)):
        m, net = _gpt_sharded(inp, cfg, {"dp": 2})
        opt = AdamW(float(inp["lr"]), parameters=net.named_parameters(),
                    weight_decay=0.01,
                    grad_clip=tnn.ClipGradByGlobalNorm(float(inp["clip"])))
        s = DistributedStrategy()
        if zero:
            s.sharding = True
            s.sharding_configs = {"sharding_stage": zero}
        tr = compile_train_step(net, opt, s, m, loss_fn=loss_fn,
                                accumulate_steps=2)
        values[f"{name}.zero_manual"] = tr.zero_manual
        losses = []
        for i, tok in enumerate(inp["steps_tok"]):
            tok = torch.from_numpy(tok).long()
            batch = (tok, torch.from_numpy(inp["steps_lbl"][i]).long()) \
                if loss_fn is not None else (tok,)
            with instrument.count_collectives() as cc:
                losses.append(float(tr.step(*batch)))
            if i == 0:
                values[f"{name}.stats"] = instrument.collective_stats(cc)
        values[f"{name}.losses"] = losses
        tr.sync_to_layer()
        for n, a in tgpt.state_to_numpy(net).items():
            arrays[f"{name}.param.{n}"] = a
        M.set_mesh(None)


def job_compile_moe(inp, rank, arrays, values):
    """``compile_train_step`` with the model's ``.loss`` (the MoE aux
    included) on a MoE GPT at ``{"dp": 2, "ep": 2}``: losses, the first
    step's collectives and the gathered state."""
    import torch

    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed import parallel_layers as PL
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.strategy_compiler import \
        compile_train_step
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import instrument

    cfg = json.loads(str(inp["cfg"]))
    m, net = _gpt_sharded(inp, cfg, {"dp": 2, "ep": 2})
    opt = AdamW(float(inp["lr"]), parameters=net.named_parameters(),
                weight_decay=0.01,
                grad_clip=tnn.ClipGradByGlobalNorm(float(inp["clip"])))
    tr = compile_train_step(net, opt, DistributedStrategy(), m)
    losses = []
    for i, tok in enumerate(inp["steps_tok"]):
        with instrument.count_collectives() as cc:
            losses.append(float(tr.step(torch.from_numpy(tok).long())))
        if i == 0:
            values["stats"] = instrument.collective_stats(cc)
    values["losses"] = losses
    tr.sync_to_layer()
    full = PL.gather_reference_state(net)
    if rank == 0:
        for n, a in full.items():
            arrays[f"param.{n}"] = a
    values["experts_held"] = list(net.blocks[0].mlp.w_in.shape)
    M.set_mesh(None)


def job_dp_pair(inp, rank, arrays, values):
    """The eager DataParallel + fleet.distributed_optimizer pair (each
    gradient all-reduced twice) against the trainer at dp = 2 (once)."""
    import torch

    import paddle_tpu_torch
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed.hybrid import HybridPipelineTrainer
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import instrument

    cfg = json.loads(str(inp["cfg"]))
    lr = float(inp["lr"])
    tok = torch.from_numpy(inp["tok"]).long()
    net = _gpt(inp, cfg)
    dp = paddle_tpu_torch.DataParallel(net)
    fleet.init(is_collective=True)
    opt = AdamW(lr, parameters=net.named_parameters(), weight_decay=0.01)
    dopt = fleet.distributed_optimizer(opt)
    with instrument.count_collectives() as cc:
        net.loss(tok.chunk(2)[rank]).backward()
        dp.apply_collective_grads()
        dopt.step()
    values["eager_stats"] = instrument.collective_stats(cc)
    for n, p in net.named_parameters():
        arrays[f"eager.grad.{n}"] = p.grad.numpy().copy()
        arrays[f"eager.param.{n}"] = p.detach().numpy().copy()

    m, net = _gpt_sharded(inp, cfg, {"dp": 2})
    opt = AdamW(lr, parameters=net.named_parameters(), weight_decay=0.01)
    tr = HybridPipelineTrainer(net, opt, mesh=m)
    with instrument.count_collectives() as cc:
        tr._loss((tok,), backward=True)
        grads = tr._upd._reduced_grads()
    values["trainer_stats"] = instrument.collective_stats(cc)
    for n, g in zip(tr._names, grads):
        arrays[f"trainer.grad.{n}"] = g.numpy().copy()
    tr._upd.zero_grad()
    tr.step(tok)
    for n, p in net.named_parameters():
        arrays[f"trainer.param.{n}"] = p.detach().numpy().copy()
    M.set_mesh(None)


# ---------------------------------------------------------------------------
# pipeline, ring attention and MoE units
# ---------------------------------------------------------------------------
def job_pipe(inp, rank, arrays, values):
    """``pipeline_apply`` on {"dp": 1, "pp": 2} (GPipe and interleaved) on
    a stack of ``tanh(h @ W_l)`` layers with a per-call aux; the two
    error messages; the interleaved trainer's state round trip at lr 0."""
    import torch

    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed import parallel_layers as PL
    from paddle_tpu_torch.distributed.hybrid import (HybridPipelineTrainer,
                                                     pipeline_layout)
    from paddle_tpu_torch.distributed.pipeline import pipeline_apply
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import instrument

    m = M.init_mesh({"dp": 1, "pp": 2})
    w, x, g = (torch.from_numpy(inp[k]) for k in ("w", "x", "g"))
    L = w.shape[0]

    def stage_fn(p, h):
        aux = torch.zeros(())
        for j in range(p.shape[0]):
            h = torch.tanh(h @ p[j])
            aux = aux + h.square().mean()
        return h, aux

    for v in (1, 2):
        circ = pipeline_layout(L, 2, v)[rank]
        params = w[torch.tensor(circ)].clone().requires_grad_()
        with instrument.count_collectives() as cc:
            out, aux = pipeline_apply(
                m, stage_fn, params if v > 1 else params[0], x, 4,
                v_virtual=v, stage_aux=True,
                head_fn=lambda full: (full * g).sum())
            (out + aux).backward()
        values[f"v{v}.stats"] = instrument.collective_stats(cc)
        values[f"v{v}.loss"] = float(out)
        values[f"v{v}.aux"] = float(aux)
        values[f"v{v}.circuits"] = circ
        arrays[f"v{v}.grad"] = params.grad.numpy()
        with torch.no_grad():
            shared = pipeline_apply(m, lambda p, h: stage_fn(p, h)[0],
                                    params if v > 1 else params[0], x, 4,
                                    v_virtual=v)
        arrays[f"v{v}.out"] = shared.numpy()
    try:
        pipeline_apply(m, stage_fn, w, x, 1, v_virtual=2)
    except ValueError as e:
        values["n_micro_error"] = str(e)
    cfg = json.loads(str(inp["cfg"]))
    _, net = _gpt_sharded(inp, cfg, {"dp": 1, "pp": 2})
    try:
        HybridPipelineTrainer(net, AdamW(0.0, parameters=net.parameters()),
                              mesh=m, v_virtual=4)
    except ValueError as e:
        values["divisible_error"] = str(e)
    tr = HybridPipelineTrainer(net, AdamW(0.0, parameters=net.parameters(),
                                          weight_decay=0.0),
                               mesh=m, n_micro=4, v_virtual=2)
    tr.step(torch.from_numpy(inp["steps_tok"][0]).long())
    tr.sync_to_layer()
    for n, a in PL.gather_reference_state(net).items():
        arrays[f"roundtrip.{n}"] = a
    # the pp cut: a stage loads only its own blocks of a whole state
    from paddle_tpu_torch.models import gpt as tgpt

    shifted = {n: a + 1.0 for n, a in _state(inp).items()}
    shard = PL.shard_reference_state(net, shifted)
    values["shard_blocks"] = sorted({int(n.split(".")[1]) for n in shard
                                     if n.startswith("blocks.")})
    tgpt.load_reference_state(net, shard)
    for n, a in PL.gather_reference_state(net).items():
        arrays[f"reload.{n}"] = a
    M.set_mesh(None)


def job_ring(inp, rank, arrays, values):
    """Ring attention over every rank as ``sp``: each case's global q, k,
    v cut on dim 1; the local output and the gradients of sum(sin(o))."""
    import torch

    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.ops.ring_attention import (
        ring_attention, sequence_parallel_attention)
    from paddle_tpu_torch.profiler import instrument

    n = int(inp["nranks"])
    m = M.init_mesh({"sp": n})
    for case in json.loads(str(inp["cases"])):
        name = case["name"]
        q, k, v = (torch.from_numpy(inp[f"{name}.{t}"]).chunk(n, 1)[rank]
                   .contiguous().requires_grad_() for t in "qkv")
        with instrument.count_collectives() as cc:
            if case["causal"]:
                o = ring_attention(q, k, v, "sp", causal=True)
            else:
                o = sequence_parallel_attention(q, k, v, m, causal=False)
            values[f"{name}.fwd_stats"] = instrument.collective_stats(cc)
        with instrument.count_collectives() as cc:
            torch.sin(o.float()).sum().backward()
        values[f"{name}.bwd_stats"] = instrument.collective_stats(cc)
        arrays[f"{name}.o"] = o.detach().float().numpy()
        for t, x in zip("qkv", (q, k, v)):
            arrays[f"{name}.d{t}"] = x.grad.float().numpy()
    M.set_mesh(None)


def job_moe(inp, rank, arrays, values):
    """``switch_moe`` routed over a group: each case's mesh, the axes the
    tokens are cut over (the global [B, S, H] batch: dim 0 over dp, dim 1
    over sp; every ep rank holds the same tokens and its experts), the
    local outputs, the kept tokens, the aux and the gradients of
    sum(y * y) + aux."""
    import torch

    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed.context import (current_moe_routing,
                                                      moe_routing_scope)
    from paddle_tpu_torch.distributed.moe import switch_moe
    from paddle_tpu_torch.profiler import instrument

    for case in json.loads(str(inp["cases"])):
        name = case["name"]
        m = M.init_mesh(case["mesh"])
        dp, sp = m.shape.get("dp", 1), m.shape.get("sp", 1)
        ep = m.shape.get("ep", 1)
        x = torch.from_numpy(inp[f"{name}.x"])               # [B, S, H]
        x = x.chunk(dp, 0)[m.axis_index("dp") if dp > 1 else 0]
        x = x.chunk(sp, 1)[m.axis_index("sp") if sp > 1 else 0]
        b, s_l, h = x.shape
        x = x.reshape(b * s_l, h).contiguous().requires_grad_()
        gw, wi, bi, wo, bo = (torch.from_numpy(inp[f"{name}.{k}"])
                              for k in ("gw", "wi", "bi", "wo", "bo"))
        e_i = m.axis_index("ep") if ep > 1 else 0
        wi, bi, wo, bo = (t.chunk(ep, 0)[e_i].contiguous()
                          for t in (wi, bi, wo, bo))
        ps = [t.clone().requires_grad_() for t in (gw, wi, bi, wo, bo)]
        ep_arg = (m.group("ep"), ep, e_i) if ep > 1 else None
        with moe_routing_scope(m, tuple(case["route"])), \
                instrument.count_collectives() as cc:
            y, aux = switch_moe(x, *ps, top_k=case["top_k"],
                                capacity_factor=case["cf"], rows=b,
                                route=current_moe_routing(), ep=ep_arg)
            ((y * y).sum() + aux).backward()
        values[f"{name}.stats"] = instrument.collective_stats(cc)
        values[f"{name}.aux"] = float(aux)
        arrays[f"{name}.y"] = y.detach().numpy()
        arrays[f"{name}.dx"] = x.grad.numpy()
        for k, t in zip(("gw", "wi", "bi", "wo", "bo"), ps):
            arrays[f"{name}.d{k}"] = t.grad.numpy()
        M.set_mesh(None)


#: this rank's output directory (``main``)
_OUT = [None]


def main():
    job, out_dir = sys.argv[1], sys.argv[2]
    _OUT[0] = out_dir
    import paddle_tpu_torch.distributed as dist

    env = dist.init_parallel_env()
    rank = env.rank
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    arrays, values = {}, {"world": env.world_size,
                          "device": str(env.device)}
    globals()["job_" + job](inp, rank, arrays, values)
    values["foreign_modules"] = _hygiene()
    np.savez(os.path.join(out_dir, f"out.{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"out.{rank}.json"), "w") as f:
        json.dump(values, f)
    dist.barrier()


if __name__ == "__main__":
    main()
