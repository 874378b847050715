"""Distributed metric aggregation (mirrors
``paddle_tpu/distributed/fleet/metrics.py:1-104``; reference:
python/paddle/distributed/fleet/metrics/metric.py:22-195 — sum/max/min/
acc/auc over the RoleMaker's Gloo all-reduce).

The values ride the eager collective API (``distributed/collective.py``)
as f64 tensors on this rank's device; a world of one is the identity.
``distributed_metric`` aggregates the ``metric`` package's classes,
which are not ported yet (ROADMAP queue 1 item 9): it raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..collective import ReduceOp, all_reduce
from ..env import ParallelEnv, get_world_size

__all__ = ["sum", "max", "min", "acc", "auc"]

_builtin_sum, _builtin_max, _builtin_min = sum, max, min


def _allreduce_np(arr: np.ndarray, op) -> np.ndarray:
    if get_world_size() <= 1:
        return arr
    # np.array keeps a 0-d input 0-d (ascontiguousarray would make it 1-d)
    t = torch.from_numpy(np.array(arr)).to(ParallelEnv().device)
    all_reduce(t, op=op)
    return t.cpu().numpy()


def _as_array(input) -> np.ndarray:
    """A tensor, numpy array, Python scalar or (nested) list, as f64."""
    if torch.is_tensor(input):
        input = input.detach().cpu().double().numpy()
    return np.asarray(input, np.float64)


def _scalar_or_array(out: np.ndarray):
    """0-d reductions come back as Python floats; arrays keep their
    shape."""
    return float(out) if out.ndim == 0 else out


def sum(input, scope=None, util=None):  # noqa: A001
    """reference: fleet/metrics/metric.py sum(:22)."""
    return _scalar_or_array(_allreduce_np(_as_array(input), ReduceOp.SUM))


def max(input, scope=None, util=None):  # noqa: A001
    """reference: fleet/metrics/metric.py max(:57)."""
    return _scalar_or_array(_allreduce_np(_as_array(input), ReduceOp.MAX))


def min(input, scope=None, util=None):  # noqa: A001
    """reference: fleet/metrics/metric.py min(:92)."""
    return _scalar_or_array(_allreduce_np(_as_array(input), ReduceOp.MIN))


def acc(correct, total, scope=None, util=None):
    """reference: fleet/metrics/metric.py acc(:127) — global
    correct/total."""
    c = sum(correct)
    t = sum(total)
    return float(c) / _builtin_max(float(t), 1.0)


def auc(stat_pos, stat_neg, scope=None, util=None):
    """reference: fleet/metrics/metric.py auc(:162) — all-reduce the
    positive/negative histograms, then integrate."""
    pos = _allreduce_np(_as_array(stat_pos), ReduceOp.SUM)
    neg = _allreduce_np(_as_array(stat_neg), ReduceOp.SUM)
    tot_pos = tot_neg = 0.0
    area = 0.0
    for i in range(len(pos) - 1, -1, -1):
        new_pos = tot_pos + pos[i]
        new_neg = tot_neg + neg[i]
        area += (new_pos + tot_pos) * (new_neg - tot_neg) / 2
        tot_pos, tot_neg = new_pos, new_neg
    return area / (tot_pos * tot_neg) if tot_pos and tot_neg else 0.0


def distributed_metric(metric):
    raise NotImplementedError(
        "distributed_metric aggregates the metric package's classes, not "
        "ported yet: ROADMAP queue 1 item 9 (long tail)")
