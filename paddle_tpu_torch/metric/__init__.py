"""Metrics (mirrors ``paddle_tpu/metric/__init__.py``; reference:
python/paddle/metric/metrics.py). The host-side bookkeeping of the
reference in numpy; inputs may be torch tensors (on any device; read to
the host once) or arrays, and ``Accuracy.compute``/``accuracy`` return
torch tensors on the input's device."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    return np.asarray(x)


def _device(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    """Top-k accuracy (reference: metric/metrics.py Accuracy)."""

    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        dev = _device(pred, label)
        pred, label = _np(pred), _np(label)
        idx = np.argsort(-pred, axis=-1)[..., :self.maxk]
        if label.ndim == pred.ndim:
            label = label.argmax(-1) if label.shape[-1] == pred.shape[-1] \
                else label.squeeze(-1)
        correct = (idx == label[..., None])
        return torch.from_numpy(correct.astype(np.float32)).to(dev)

    def update(self, correct, *args):
        correct = _np(correct)
        num = correct.shape[0]
        accs = []
        for k in self.topk:
            c = correct[..., :k].any(-1).sum()
            self.total[self.topk.index(k)] += int(c)
            self.count[self.topk.index(k)] += num
            accs.append(c / max(num, 1))
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds).round().reshape(-1)
        labels = _np(labels).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        return self.tp / max(self.tp + self.fp, 1)

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds).round().reshape(-1)
        labels = _np(labels).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        return self.tp / max(self.tp + self.fn, 1)

    def name(self):
        return self._name


class Auc(Metric):
    """The histogram approximation of the ROC AUC (reference:
    metric/metrics.py Auc, auc_op)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels).reshape(-1)
        pos_prob = preds[:, 1] if preds.ndim == 2 else preds.reshape(-1)
        bins = np.clip((pos_prob * self.num_thresholds).astype(int), 0,
                       self.num_thresholds)
        for b, lbl in zip(bins, labels):
            if lbl:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.int64)

    def accumulate(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_pos + tot_pos) * (new_neg - tot_neg) / 2
            tot_pos, tot_neg = new_pos, new_neg
        return auc / (tot_pos * tot_neg) if tot_pos and tot_neg else 0.0

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):  # noqa: A002
    """The share of rows whose label is among the top ``k`` (a 0-d f32
    tensor on the input's device)."""
    dev = _device(input, label)
    pred = _np(input)
    lbl = _np(label).reshape(-1)
    topk_idx = np.argsort(-pred, axis=-1)[:, :k]
    acc = (topk_idx == lbl[:, None]).any(-1).mean()
    return torch.tensor(float(acc), dtype=torch.float32, device=dev)
