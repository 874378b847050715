"""The port's LeNet/MNIST loop and its pieces held against the JAX
package on the CPU: ``io`` (``paddle_tpu_torch/io``), ``vision.datasets``
(MNIST), ``metric`` and ``optimizer.Momentum``.

- The loop of ``tests/test_e2e_mnist.py``: ``seed(33)``,
  ``MNIST(mode="train", synthetic_size=512)``, ``DataLoader(batch_size=64,
  shuffle=True, drop_last=True)``, ``Adam(0.002)``, 3 epochs, with the
  reference LeNet's weights: every step's batch is the reference's
  (the same shuffled batches: both samplers draw from a numpy
  ``RandomState`` that ``seed`` reseeds); each step taken from the
  reference's state before it (parameters and Adam moments) gives its
  loss at rtol 1e-5 and its parameters after at atol 1e-6; run free from
  the reference's weights, the last loss is below 0.7 of the first and
  train accuracy through ``metric.Accuracy`` is above 0.5; the checkpoint
  round trip, also across the two packages' files.
- MNIST: the idx format (gzip, magic checks, root discovery) on files
  written in ``tmp_path``, training on those bytes, the synthetic set
  equal to the reference's and opt-in only.
- ``metric``: ``Accuracy`` (top-k), ``Precision``, ``Recall``, ``Auc`` and
  ``accuracy`` equal the reference's on the same inputs.
- ``io``: every sampler's indices and ``random_split``'s subsets equal the
  reference's after the same seed; the loader with worker threads yields
  the batches of the one without; iterable datasets over workers with
  ``get_worker_info``; the dataset wrappers; ``default_collate_fn``; the
  loader's default device is the card; the native engine names its item.
- ``Momentum`` (with and without Nesterov, with an L2 decay) against the
  reference's, three eager steps of LeNet: losses at rtol 1e-5 and
  parameters at atol 1e-6.
"""
import gzip
import struct

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import io as jio
from paddle_tpu import metric as jmetric
from paddle_tpu.vision.datasets import MNIST as JMNIST
from paddle_tpu.vision.models import LeNet as JLeNet
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch.framework import io as tfio
from paddle_tpu_torch.models.gpt import load_reference_state, state_to_numpy
from paddle_tpu_torch.optimizer import Adam, Momentum
from paddle_tpu_torch.vision.datasets import MNIST
from paddle_tpu_torch.vision.models import LeNet


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_lenet(seed):
    paddle.seed(seed)
    net = JLeNet()
    return net, {k: np.asarray(v._value) for k, v in
                 net.state_dict().items()}


def _port_lenet(state):
    net = LeNet(device="cpu")
    load_reference_state(net, state)
    return net


# -- the LeNet/MNIST loop ----------------------------------------------------
def _reference_loop():
    """The oracle's loop in the JAX package; per step the batch's labels,
    the state before it (parameters, Adam moments, step count), its loss
    and the parameters after."""
    paddle.seed(33)
    train = JMNIST(mode="train", synthetic_size=512)
    loader = jio.DataLoader(train, batch_size=64, shuffle=True,
                            drop_last=True)
    net = JLeNet()
    opt = paddle.optimizer.Adam(0.002, parameters=net.parameters())
    names = {id(p): n for n, p in net.named_parameters()}
    steps = []

    def params():
        return {n: np.asarray(p._value).copy()
                for n, p in net.named_parameters()}

    for _ in range(3):
        for x, y in loader:
            rec = {"params": params(), "step": opt._global_step,
                   "moments": {names[k]: {m: np.asarray(v).copy()
                                          for m, v in st.items()}
                               for k, st in opt._accumulators.items()},
                   "labels": np.asarray(y.numpy())}
            loss = JF.cross_entropy(net(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            rec["loss"] = float(loss.numpy())
            rec["after"] = params()
            steps.append(rec)
    return steps


@pytest.fixture(scope="module")
def ref_loop():
    return _reference_loop()


def _port_loader():
    pt.seed(33)
    train = MNIST(mode="train", synthetic_size=512)
    return train, tio.DataLoader(train, batch_size=64, shuffle=True,
                                 drop_last=True, device="cpu")


def test_lenet_mnist_loop_equals_reference_step_for_step(ref_loop):
    """Each of the 24 steps from the reference's state before it: the same
    shuffled batch, its loss at rtol 1e-5 and the parameters after the
    port's Adam step at atol 1e-6. (Run free, the two loops part by more
    than that within a few steps: Adam's first steps move a weight whose
    gradient is within rounding of zero by about ±lr either way, and the
    loss amplifies it; measured 1.6e-3 relative by step 24.)"""
    _, loader = _port_loader()
    net = LeNet(device="cpu")
    opt = Adam(0.002, parameters=net.named_parameters())
    by_name = dict(net.named_parameters())
    k = 0
    for _ in range(3):
        for x, y in loader:
            rec = ref_loop[k]
            np.testing.assert_array_equal(y.numpy(), rec["labels"])
            load_reference_state(net, dict(
                rec["params"], **{n: b.numpy() for n, b in
                                  net.named_buffers()}))
            opt._global_step = rec["step"]
            for n, st in rec["moments"].items():
                opt._accumulators[id(by_name[n])] = {
                    m: torch.from_numpy(v.copy()) for m, v in st.items()}
            loss = F.cross_entropy(net(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            np.testing.assert_allclose(float(loss), rec["loss"], rtol=1e-5)
            for n, p in net.named_parameters():
                np.testing.assert_allclose(p.detach().numpy(),
                                           rec["after"][n], atol=1e-6,
                                           err_msg=f"step {k} {n}")
            k += 1
    assert k == len(ref_loop) == 3 * (512 // 64)


def test_lenet_learns_synthetic_mnist(ref_loop):
    """The oracle's own criteria on the port's free-running loop from the
    reference's initial weights: the last loss below 0.7 of the first,
    train accuracy through ``metric.Accuracy`` above 0.5."""
    train, loader = _port_loader()
    net = LeNet(device="cpu")
    load_reference_state(net, ref_loop[0]["params"])
    opt = Adam(0.002, parameters=net.parameters())
    losses = []
    for _ in range(3):
        for x, y in loader:
            assert x.device.type == "cpu" and x.dtype == torch.float32
            loss = F.cross_entropy(net(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
    assert losses[0] == pytest.approx(ref_loop[0]["loss"], rel=1e-5)
    assert losses[-1] < losses[0] * 0.7, losses
    net.eval()
    acc = tmetric.Accuracy()
    with torch.no_grad():
        for x, y in tio.DataLoader(train, batch_size=128, device="cpu"):
            acc.update(acc.compute(net(x), y))
    assert acc.accumulate() > 0.5, acc.accumulate()


def test_checkpoint_roundtrip_across_packages(tmp_path):
    jnet, state = _ref_lenet(4)
    net = _port_lenet(state)
    path = str(tmp_path / "ck")
    opt = Adam(0.001, parameters=net.parameters())
    tfio.save(net.state_dict(), path + ".pdparams")
    tfio.save(opt.state_dict(), path + ".pdopt")
    net2 = LeNet(device="cpu")
    net2.set_state_dict(tfio.load(path + ".pdparams"))
    x = np.random.RandomState(0).rand(2, 1, 28, 28).astype(np.float32)
    np.testing.assert_allclose(net(torch.from_numpy(x)).detach().numpy(),
                               net2(torch.from_numpy(x)).detach().numpy(),
                               rtol=1e-6)
    j2 = JLeNet()
    j2.set_state_dict(paddle.load(path + ".pdparams"))
    np.testing.assert_allclose(j2(paddle.to_tensor(x)).numpy(),
                               jnet(paddle.to_tensor(x)).numpy(), rtol=1e-6)
    paddle.save(jnet.state_dict(), path + ".ref.pdparams")
    net3 = LeNet(device="cpu")
    net3.set_state_dict(tfio.load(path + ".ref.pdparams"))
    for k, v in state_to_numpy(net3).items():
        np.testing.assert_array_equal(v, state[k])


# -- MNIST -------------------------------------------------------------------
def _write_idx(tmp_path, images, labels, stem="train"):
    ip = tmp_path / f"{stem}-images-idx3-ubyte.gz"
    lp = tmp_path / f"{stem}-labels-idx1-ubyte.gz"
    n, r, c = images.shape
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, r, c))
        f.write(images.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, n))
        f.write(labels.tobytes())
    return str(ip), str(lp)


def test_mnist_idx_roundtrip(tmp_path):
    r = np.random.RandomState(0)
    imgs = r.randint(0, 255, (16, 28, 28)).astype(np.uint8)
    lbls = r.randint(0, 10, (16,)).astype(np.uint8)
    ip, lp = _write_idx(tmp_path, imgs, lbls)
    ds, ref = MNIST(image_path=ip, label_path=lp), \
        JMNIST(image_path=ip, label_path=lp)
    assert len(ds) == 16
    x0, y0 = ds[3]
    np.testing.assert_allclose(x0[0], imgs[3].astype(np.float32) / 127.5
                               - 1.0)
    np.testing.assert_array_equal(x0, ref[3][0])
    assert int(y0) == int(lbls[3])
    raw = tmp_path / "raw"
    raw.mkdir()
    with gzip.open(ip) as f, open(raw / "img", "wb") as g:
        g.write(f.read())
    with gzip.open(lp) as f, open(raw / "lbl", "wb") as g:
        g.write(f.read())
    plain = MNIST(image_path=str(raw / "img"), label_path=str(raw / "lbl"))
    np.testing.assert_array_equal(plain.images, imgs)


def test_mnist_root_discovery(tmp_path):
    _write_idx(tmp_path, np.zeros((4, 28, 28), np.uint8),
               np.arange(4, dtype=np.uint8), stem="t10k")
    assert len(MNIST(root=str(tmp_path), mode="test")) == 4


@pytest.mark.parametrize("which", ["images", "labels", "count"])
def test_mnist_bad_files_rejected(tmp_path, which):
    ip = tmp_path / "train-images-idx3-ubyte.gz"
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 1234 if which == "images" else 2051,
                            1, 28, 28))
        f.write(b"\0" * 784)
    lp = tmp_path / "train-labels-idx1-ubyte.gz"
    with gzip.open(lp, "wb") as f:
        n = 2 if which == "count" else 1
        f.write(struct.pack(">II", 1234 if which == "labels" else 2049, n)
                + b"\0" * n)
    with pytest.raises(ValueError, match="magic" if which != "count"
                       else "labels"):
        MNIST(image_path=str(ip), label_path=str(lp))


def test_mnist_synthetic_equals_reference_and_is_opt_in():
    for mode in ("train", "test"):
        a, b = MNIST(mode=mode, synthetic_size=64), \
            JMNIST(mode=mode, synthetic_size=64)
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a[5][0], b[5][0])
    with pytest.raises(ValueError, match="synthetic_size"):
        MNIST(mode="train")
    from paddle_tpu_torch.vision.datasets import FashionMNIST
    assert len(FashionMNIST(synthetic_size=8)) == 8


def test_e2e_train_on_real_bytes(tmp_path):
    src = MNIST(mode="train", synthetic_size=256)
    ip, lp = _write_idx(tmp_path, src.images, src.labels.astype(np.uint8))
    ds = MNIST(image_path=ip, label_path=lp)
    pt.seed(7)
    net = LeNet(device="cpu")
    opt = Adam(2e-3, parameters=net.parameters())
    losses = []
    for x, y in tio.DataLoader(ds, batch_size=64, shuffle=True,
                               drop_last=True, device="cpu"):
        loss = F.cross_entropy(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    assert losses[-1] < losses[0]


# -- metric ------------------------------------------------------------------
def test_accuracy_topk_equals_reference():
    r = np.random.RandomState(3)
    pred = r.randn(40, 7).astype(np.float32)
    lbl = r.randint(0, 7, (40, 1)).astype(np.int64)
    t, j = tmetric.Accuracy(topk=(1, 3)), jmetric.Accuracy(topk=(1, 3))
    for i in range(0, 40, 10):
        tc = t.compute(torch.from_numpy(pred[i:i + 10]),
                       torch.from_numpy(lbl[i:i + 10]))
        jc = j.compute(paddle.to_tensor(pred[i:i + 10]),
                       paddle.to_tensor(lbl[i:i + 10]))
        np.testing.assert_array_equal(tc.numpy(), jc.numpy())
        assert t.update(tc) == j.update(jc.numpy())
    assert t.accumulate() == j.accumulate()
    assert t.name() == j.name() == ["acc_top1", "acc_top3"]
    onehot = np.eye(7, dtype=np.float32)[lbl[:, 0]]
    np.testing.assert_array_equal(
        tmetric.Accuracy().compute(torch.from_numpy(pred),
                                   torch.from_numpy(onehot)).numpy(),
        jmetric.Accuracy().compute(paddle.to_tensor(pred),
                                   paddle.to_tensor(onehot)).numpy())
    for k in (1, 2):
        assert float(tmetric.accuracy(torch.from_numpy(pred),
                                      torch.from_numpy(lbl), k=k)) == \
            float(jmetric.accuracy(pred, lbl, k=k).numpy())


def test_precision_recall_auc_equal_reference():
    r = np.random.RandomState(0)
    scores = r.rand(500).astype(np.float32)
    labels = (r.rand(500) < scores).astype(np.int64)
    preds = (scores > 0.5).astype(np.int64)
    for name in ("Precision", "Recall", "Auc"):
        t, j = getattr(tmetric, name)(), getattr(jmetric, name)()
        x = scores if name == "Auc" else preds
        for i in range(0, 500, 125):
            t.update(torch.from_numpy(x[i:i + 125]),
                     torch.from_numpy(labels[i:i + 125]))
            j.update(x[i:i + 125], labels[i:i + 125])
        assert t.accumulate() == pytest.approx(j.accumulate(), abs=1e-12)
        assert t.name() == j.name()
    two = np.stack([1 - scores, scores], 1)
    t, j = tmetric.Auc(), jmetric.Auc()
    t.update(two, labels)
    j.update(two, labels)
    assert t.accumulate() == pytest.approx(j.accumulate(), abs=1e-12)


# -- io ----------------------------------------------------------------------
class _Range(tio.Dataset):
    def __init__(self, n):
        self.n = n

    def __getitem__(self, i):
        return np.full((2,), i, np.float32), np.int64(i)

    def __len__(self):
        return self.n


def test_samplers_and_random_split_equal_reference():
    ds = list(range(23))
    pt.seed(5)
    paddle.seed(5)
    pairs = [
        (tio.RandomSampler(ds), jio.RandomSampler(ds)),
        (tio.RandomSampler(ds, replacement=True, num_samples=9),
         jio.RandomSampler(ds, replacement=True, num_samples=9)),
        (tio.WeightedRandomSampler(np.arange(1, 24), 12),
         jio.WeightedRandomSampler(np.arange(1, 24), 12)),
        (tio.SequenceSampler(ds), jio.SequenceSampler(ds)),
        (tio.BatchSampler(ds, shuffle=True, batch_size=5),
         jio.BatchSampler(ds, shuffle=True, batch_size=5)),
        (tio.BatchSampler(ds, batch_size=5, drop_last=True),
         jio.BatchSampler(ds, batch_size=5, drop_last=True)),
    ]
    for t, j in pairs:
        assert list(t) == list(j) and len(t) == len(j)
    for rank in (0, 1, 2):
        for shuffle in (False, True):
            t = tio.DistributedBatchSampler(ds, 4, num_replicas=3,
                                            rank=rank, shuffle=shuffle)
            j = jio.DistributedBatchSampler(ds, 4, num_replicas=3,
                                            rank=rank, shuffle=shuffle)
            t.set_epoch(2)
            j.set_epoch(2)
            assert list(t) == list(j) and len(t) == len(j)
    t = tio.random_split(ds, [10, 13])
    j = jio.random_split(ds, [10, 13])
    assert [s.indices for s in t] == [s.indices for s in j]


def test_dataset_wrappers_and_collate():
    a, b = _Range(5), _Range(3)
    cat = tio.ConcatDataset([a, b])
    assert len(cat) == 8 and int(cat[6][1]) == 1
    assert int(tio.Subset(a, [4, 2])[0][1]) == 4
    comp = tio.ComposeDataset([a, a])
    assert len(comp[1]) == 4
    with pytest.raises(ValueError):
        tio.ComposeDataset([a, _Range(3)])
    td = tio.TensorDataset([np.arange(6), np.arange(6) * 2])
    assert len(td) == 6 and int(td[2][1]) == 4
    chain = tio.ChainDataset([[1, 2], [3]])
    assert [v for v in chain] == [1, 2, 3]
    batch = tio.default_collate_fn([{"x": np.ones(2, np.float32), "n": 3},
                                    {"x": np.zeros(2, np.float32), "n": 4}])
    assert torch.equal(batch["n"], torch.tensor([3, 4]))
    assert tuple(batch["x"].shape) == (2, 2)
    t = tio.default_collate_fn([torch.ones(3), torch.zeros(3)])
    assert tuple(t.shape) == (2, 3)


@pytest.mark.parametrize("workers", [1, 3])
def test_loader_workers_yield_the_batches_in_order(workers):
    ds = _Range(37)
    pt.seed(9)
    want = [(x.clone(), y.clone()) for x, y in
            tio.DataLoader(ds, batch_size=5, shuffle=True, device="cpu")]
    pt.seed(9)
    got = list(tio.DataLoader(ds, batch_size=5, shuffle=True,
                              num_workers=workers, device="cpu"))
    assert len(got) == len(want) == 8
    for (x, y), (wx, wy) in zip(got, want):
        assert torch.equal(x, wx) and torch.equal(y, wy)


class _Shards(tio.IterableDataset):
    """Yields 0..n-1, each worker its own stride (``get_worker_info``)."""

    def __init__(self, n):
        self.n = n

    def __iter__(self):
        info = tio.get_worker_info()
        w, k = (0, 1) if info is None else (info.id, info.num_workers)
        return iter(np.arange(w, self.n, k, dtype=np.int64))


def test_iterable_dataset_over_workers():
    assert tio.get_worker_info() is None
    one = torch.cat(list(tio.DataLoader(_Shards(20), batch_size=3,
                                        device="cpu")))
    assert one.tolist() == list(range(20))
    many = torch.cat(list(tio.DataLoader(_Shards(20), batch_size=3,
                                         num_workers=2, device="cpu")))
    assert sorted(many.tolist()) == list(range(20))
    dropped = list(tio.DataLoader(_Shards(20), batch_size=3,
                                  drop_last=True, device="cpu"))
    assert all(len(b) == 3 for b in dropped)
    with pytest.raises(TypeError):
        len(tio.DataLoader(_Shards(3), device="cpu"))


def test_loader_runs_on_the_card_by_default_and_native_names_9f():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tio.DataLoader(_Range(4))
    assert len(tio.DataLoader(_Range(10), batch_size=4,
                              device="cpu")) == 3
    with pytest.raises(NotImplementedError, match="9f"):
        tio._NativeIterAdapter(None)


# -- Momentum ----------------------------------------------------------------
@pytest.mark.parametrize("nesterov,wd", [(False, None), (True, 1e-3)])
def test_momentum_equals_reference(nesterov, wd):
    jnet, state = _ref_lenet(8)
    net = _port_lenet(state)
    jopt = paddle.optimizer.Momentum(0.05, momentum=0.9,
                                     parameters=jnet.parameters(),
                                     use_nesterov=nesterov, weight_decay=wd)
    opt = Momentum(0.05, momentum=0.9, parameters=net.parameters(),
                   use_nesterov=nesterov, weight_decay=wd)
    r = np.random.RandomState(1)
    x = r.randn(8, 1, 28, 28).astype(np.float32)
    y = r.randint(0, 10, (8,)).astype(np.int64)
    for _ in range(3):
        jl = JF.cross_entropy(jnet(paddle.to_tensor(x)), paddle.to_tensor(y))
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        tl = F.cross_entropy(net(torch.from_numpy(x)), torch.from_numpy(y))
        tl.backward()
        opt.step()
        opt.clear_grad()
        np.testing.assert_allclose(float(tl), float(jl.numpy()), rtol=1e-5)
    ref = {k: np.asarray(v._value) for k, v in jnet.state_dict().items()}
    for k, v in state_to_numpy(net).items():
        np.testing.assert_allclose(v, ref[k], atol=1e-6, err_msg=k)
    vel = opt._accumulators[id(net.fc[0].weight)]["velocity"]
    assert vel.dtype == torch.float32
