"""BERT and ERNIE (``paddle_tpu_torch/models/{bert,ernie}.py``) and
``SGD`` held against the JAX package, module by module, on the CPU.

Both sides get the same numpy inputs from a seed; the port's model gets
the reference model's weights through ``load_reference_state``. At S 32
neither package takes the flash path (its block picker wants S >= 128),
so every f32 case runs the plain attention on both sides and is held at
rtol 1e-5, atol 1e-6 (gradients at rtol 1e-4, atol 1e-5: a sum of
hundreds of f32 products in other orders):

- ``BertEmbeddings`` with and without ``token_type_ids``; one
  ``BertBlock``; ``Bert`` (sequence and pooled output);
  ``BertForPretraining.forward`` (MLM and NSP logits);
- ``loss`` with the full head and with ``max_predictions``, on a batch
  where two rows mask more positions than the gather keeps: the loss and
  every gradient, so a row that dropped other positions than
  ``jax.lax.top_k`` (ties lowest index first) would fail;
- ``Bert.forward`` under a bool and an additive ``attn_mask`` (the plain
  masked softmax; the flash kernels take no mask);
- ``ernie_tiny``'s loss and gradients; the ``state_to_numpy`` round trip;
- amp at S 128: one trainer step at lr 0 in each package, where both
  attentions take the bidirectional flash path (the JAX Pallas kernels in
  interpret mode, the port's plain versions): the loss at atol 5e-4, the
  bound of ``tests/test_torch_training.py``;
- ``SGD`` with an L2 ``weight_decay`` and ``ClipGradByGlobalNorm``
  against the reference's ``SGD``, three eager steps: losses at rtol
  1e-6 and parameters at atol 1e-6; and ``SGD`` through the trainer's
  update routes at degree 1 (the guard's selected update, bf16 moment
  storage with no moments to store, ``offload_optimizer``), each equal
  to the eager loop, its ``device_state`` the parameters alone.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import ernie as jernie
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.distributed.hybrid import HybridPipelineTrainer
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import ernie as ternie
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.optimizer import SGD

F32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
B, S = 4, 32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed=5, ernie=False, **kw):
    """(reference model, port model) with the reference's weights."""
    paddle.seed(seed)
    jnet = (jernie.ernie_tiny if ernie else jbert.bert_tiny)(**kw)
    state = {k: np.asarray(v._value) for k, v in jnet.state_dict().items()}
    net = (ternie.ernie_tiny if ernie else tbert.bert_tiny)(device="cpu",
                                                            **kw)
    tgpt.load_reference_state(net, state)
    return jnet, net


def _batch(seed=3, b=B, s=S, rate=0.15):
    r = np.random.RandomState(seed)
    tok = r.randint(0, 128, (b, s)).astype(np.int32)
    tt = r.randint(0, 2, (b, s)).astype(np.int32)
    mlm = np.where(r.rand(b, s) < rate, r.randint(0, 128, (b, s)),
                   -100).astype(np.int32)
    nsp = r.randint(0, 2, (b,)).astype(np.int32)
    return tok, tt, mlm, nsp


def _j(a):
    return paddle.to_tensor(a)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long() \
        if np.asarray(a).dtype.kind in "iu" else torch.from_numpy(
            np.asarray(a))


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else \
        np.asarray(x._value)


@pytest.mark.parametrize("with_tt", [True, False])
def test_embeddings_match_reference(with_tt):
    jnet, net = _pair()
    tok, tt, _, _ = _batch()
    args = (tok, tt) if with_tt else (tok,)
    got = net.bert.embeddings(*[_t(a) for a in args])
    want = jnet.bert.embeddings(*[_j(a) for a in args])
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_block_matches_reference():
    jnet, net = _pair()
    x = np.random.RandomState(4).randn(B, S, 64).astype(np.float32)
    got = net.bert.blocks[0](torch.from_numpy(x))
    want = jnet.bert.blocks[0](_j(x))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_encoder_and_pretraining_forward_match_reference():
    jnet, net = _pair()
    tok, tt, _, _ = _batch()
    seq, pooled = net.bert(_t(tok), _t(tt))
    jseq, jpooled = jnet.bert(_j(tok), _j(tt))
    np.testing.assert_allclose(_np(seq), _np(jseq), **F32)
    np.testing.assert_allclose(_np(pooled), _np(jpooled), **F32)
    mlm, nsp = net(_t(tok), _t(tt))
    jmlm, jnsp = jnet(_j(tok), _j(tt))
    assert tuple(mlm.shape) == (B, S, 128) and tuple(nsp.shape) == (B, 2)
    np.testing.assert_allclose(_np(mlm), _np(jmlm), **F32)
    np.testing.assert_allclose(_np(nsp), _np(jnsp), **F32)


def _loss_and_grads(jnet, net, batch):
    jloss = jnet.loss(*[_j(a) for a in batch])
    jloss.backward()
    jgrads = {n: np.asarray(p.grad._value)
              for n, p in jnet.named_parameters()}
    loss = net.loss(*[_t(a) for a in batch])
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in net.named_parameters()}
    return float(loss.detach()), grads, float(jloss._value), jgrads


def _crowded(maxp):
    """A batch whose rows 0 and 2 mask more than ``maxp`` positions."""
    batch = _batch(seed=7)
    mlm = batch[2].copy()
    r = np.random.RandomState(8)
    for row in (0, 2):
        mlm[row, ::2] = r.randint(0, 128, S // 2)
    assert (np.sum(mlm != -100, 1)[[0, 2]] > maxp).all()
    assert (np.sum(mlm != -100, 1)[[1, 3]] <= maxp).all()
    return batch[:2] + (mlm,) + batch[3:]


@pytest.mark.parametrize("maxp", [0, 8])
def test_loss_and_every_gradient_match_reference(maxp):
    """The full head, and the gather of 8 masked positions a row, where
    two rows mask 16 or more (the kept positions are the first 8)."""
    jnet, net = _pair(max_predictions=maxp)
    loss, grads, jloss, jgrads = _loss_and_grads(jnet, net, _crowded(8))
    np.testing.assert_allclose(loss, jloss, **F32)
    assert set(grads) == set(jgrads)
    for n, g in grads.items():
        np.testing.assert_allclose(g, jgrads[n], err_msg=n, **GRAD)


def test_gather_keeps_the_first_masked_positions():
    """Ties of the 0/1 mask go lowest index first: a row with more
    masked positions than ``max_predictions`` keeps its first ones."""
    mlm = torch.full((2, 12), -100)
    mlm[0, [1, 3, 4, 8, 11]] = 7
    mlm[1, [0, 5]] = 3
    pos, score = tbert._masked_positions(mlm, 4)
    assert pos[0].tolist() == [1, 3, 4, 8]
    assert score[0].tolist() == [1, 1, 1, 1]
    assert pos[1, :2].tolist() == [0, 5]
    assert score[1].tolist() == [1, 1, 0, 0]


@pytest.mark.parametrize("kind", ["bool", "additive"])
def test_padding_mask_matches_reference(kind):
    jnet, net = _pair()
    tok, tt, _, _ = _batch()
    keep = np.ones((B, 1, 1, S), bool)
    keep[0, ..., 20:] = False
    keep[2, ..., 9:] = False
    mask = keep if kind == "bool" else \
        np.where(keep, 0.0, -1e4).astype(np.float32)
    seq, pooled = net.bert(_t(tok), _t(tt), torch.from_numpy(mask))
    jseq, jpooled = jnet.bert(_j(tok), _j(tt), _j(mask))
    np.testing.assert_allclose(_np(seq), _np(jseq), **F32)
    np.testing.assert_allclose(_np(pooled), _np(jpooled), **F32)
    # the mask took effect: the masked rows differ from the unmasked run
    free, _ = net.bert(_t(tok), _t(tt))
    assert not np.allclose(_np(free)[0], _np(seq)[0])


def test_ernie_loss_and_gradients_match_reference():
    jnet, net = _pair(seed=7, ernie=True)
    assert isinstance(net.config, ternie.ErnieConfig)
    assert net.config.type_vocab_size == 4 and len(net.bert.blocks) == 4
    loss, grads, jloss, jgrads = _loss_and_grads(jnet, net, _batch(seed=5))
    np.testing.assert_allclose(loss, jloss, **F32)
    for n, g in grads.items():
        np.testing.assert_allclose(g, jgrads[n], err_msg=n, **GRAD)


def test_state_round_trip():
    jnet, net = _pair()
    state = {k: np.asarray(v._value) for k, v in jnet.state_dict().items()}
    back = tgpt.state_to_numpy(net)
    assert list(back) == list(net.state_dict())
    assert sorted(back) == sorted(state)
    for n, a in state.items():
        assert back[n].dtype == np.float32 and np.array_equal(back[n], a), n


def test_configs_match_reference():
    for name in ("bert_base", "bert_large"):
        got, want = getattr(tbert.BertConfig, name)(), \
            getattr(jbert.BertConfig, name)()
        assert vars(got) == vars(want), name
        assert got.num_params() == want.num_params()
        assert got.flops_per_token(512) == want.flops_per_token(512)
    for name in ("ernie_base", "ernie_large", "ernie_10b_style"):
        got, want = getattr(ternie.ErnieConfig, name)(), \
            getattr(jernie.ErnieConfig, name)()
        assert vars(got) == vars(want), name


def test_amp_step_through_bidirectional_flash_matches_reference():
    """amp at S 128: both packages' attention takes the non-causal flash
    path (the JAX kernels in interpret mode); one trainer step at lr 0."""
    from paddle_tpu.distributed.fleet import DistributedStrategy as JS
    from paddle_tpu.distributed.hybrid import HybridPipelineTrainer as JT
    from paddle_tpu.distributed.mesh import create_mesh
    import jax

    cfg = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
               max_seq_len=128)
    paddle.seed(9)
    jnet = jbert.BertForPretraining(jbert.BertConfig(**cfg))
    state = {k: np.asarray(v._value) for k, v in jnet.state_dict().items()}
    net = tbert.BertForPretraining(tbert.BertConfig(**cfg), device="cpu")
    tgpt.load_reference_state(net, state)
    batch = _batch(seed=11, b=2, s=128)
    js = JS()
    js.amp = True
    jtr = JT(jnet, paddle.optimizer.SGD(0.0, parameters=jnet.parameters()),
             js, create_mesh({"dp": 1}, jax.devices()[:1]), n_micro=1)
    want = float(jtr.step(*batch))
    s = DistributedStrategy()
    s.amp = True
    seen = []
    from paddle_tpu_torch.ops import flash_attention as fa

    real = fa.flash_attention

    def spy(q, k, v, causal=False, scale=None):
        seen.append((q.dtype, causal))
        return real(q, k, v, causal=causal, scale=scale)

    fa.flash_attention = spy
    try:
        tr = HybridPipelineTrainer(net, SGD(0.0, parameters=net.parameters()),
                                   s, n_micro=1)
        got = float(tr.step(*[_t(a) for a in batch]))
    finally:
        fa.flash_attention = real
    assert seen and set(seen) == {(torch.bfloat16, False)}, seen
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


# ---------------------------------------------------------------------------
# SGD
# ---------------------------------------------------------------------------
LR, WD, CLIP = 0.5, 0.01, 0.5


def _sgd_eager_port(state, batches, **kw):
    net = tbert.bert_tiny(device="cpu", **kw)
    tgpt.load_reference_state(net, state)
    opt = SGD(LR, parameters=net.parameters(), weight_decay=WD,
              grad_clip=tnn.ClipGradByGlobalNorm(CLIP))
    losses = []
    for batch in batches:
        loss = net.loss(*[_t(a) for a in batch])
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    return losses, tgpt.state_to_numpy(net)


def test_sgd_matches_reference_over_three_steps():
    jnet, _ = _pair(seed=13)
    state0 = {k: np.asarray(v._value) for k, v in jnet.state_dict().items()}
    jopt = paddle.optimizer.SGD(LR, parameters=jnet.parameters(),
                                weight_decay=WD,
                                grad_clip=paddle.nn.ClipGradByGlobalNorm(CLIP))
    batches = [_batch(seed=20 + i) for i in range(3)]
    jlosses = []
    for batch in batches:
        loss = jnet.loss(*[_j(a) for a in batch])
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jlosses.append(float(loss._value))
    jfinal = {k: np.asarray(v._value) for k, v in jnet.state_dict().items()}
    losses, final = _sgd_eager_port(state0, batches)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-6)
    moved = max(float(np.abs(jfinal[n] - state0[n]).max()) for n in state0)
    assert moved > 1e-2, moved
    for n, v in final.items():
        np.testing.assert_allclose(v, jfinal[n], rtol=0, atol=1e-6,
                                   err_msg=n)


@pytest.mark.parametrize("route", [dict(guard_bad_steps=True),
                                   dict(moment_dtype="bfloat16"),
                                   dict(offload_optimizer=True)],
                         ids=["guard", "bf16_moments", "offload_optimizer"])
def test_sgd_through_the_trainer_routes(route):
    """SGD keeps no state: each update route takes the empty state and
    the trainer (one micro-batch: the eager loop's batch) gives the eager
    loop's losses and parameters."""
    jnet, _ = _pair(seed=13)
    state0 = {k: np.asarray(v._value) for k, v in jnet.state_dict().items()}
    batches = [_batch(seed=20 + i) for i in range(3)]
    want_losses, want = _sgd_eager_port(state0, batches)
    net = tbert.bert_tiny(device="cpu")
    tgpt.load_reference_state(net, state0)
    opt = SGD(LR, parameters=net.named_parameters(), weight_decay=WD,
              grad_clip=tnn.ClipGradByGlobalNorm(CLIP))
    tr = HybridPipelineTrainer(net, opt, DistributedStrategy(), n_micro=1,
                               **route)
    losses = [float(tr.step(*[_t(a) for a in b])) for b in batches]
    if route.get("guard_bad_steps"):
        assert tr.last_step_ok
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
    # the checkpoint pieces: parameters only, and they load back
    pieces = tr.device_state()
    assert set(pieces) == {"params"}
    tr.load_device_state(pieces)
    got = tgpt.state_to_numpy(tr.sync_to_layer())
    assert all(st == {} for st in tr._upd.states)
    for n, v in got.items():
        np.testing.assert_allclose(v, want[n], rtol=0, atol=1e-6, err_msg=n)
