"""The port's MoE (``distributed/moe.py``) against the JAX package's.

- ``switch_moe`` on one rank against the JAX ``switch_moe`` on the same
  inputs: top-1 and top-2 without drops, overflow drops, the aux loss,
  and the rigged no-collision case of ``tests/test_moe.py:29-100``;
  outputs at rtol 2e-4 / atol 2e-5 (the reference test's), the aux at
  rtol 1e-5, the gradients of ``sum(y * y) + aux`` at rtol 2e-4 / atol
  2e-5.
- The gather-only backward functions (``_DispatchGather``,
  ``_CombineGather``) against autograd of the plain scatter spelling
  (``tests/test_moe.py:294``'s ``ref_moe``, in PyTorch), top-1 and top-2,
  capacities that drop and that do not.
- On gloo ranks (CPU), routed over a group (``context.moe_routing_scope``):
  ``{"dp": 2}`` with a capacity that drops tokens equals the JAX
  function on the whole batch: the same kept tokens, outputs at rtol
  2e-4 / atol 2e-5, the aux at rtol 1e-5, and the gradients of the sum
  of the ranks' objectives (``sum(y * y)`` of its tokens plus the aux on
  every rank: the whole batch's ``sum(y * y) + dp · aux``). This shows
  that the routing group is global. ``{"dp": 2, "sp": 2}`` (the rows'
  sequence shards) the same. ``{"ep": 2}`` and ``{"dp": 2, "ep": 2}``:
  each rank holds half the experts and the outputs, summed over ``ep``,
  equal one device's (``tests/test_moe.py:116``).
"""
import importlib.util
import json
import os

import numpy as np
import pytest

_spec = importlib.util.spec_from_file_location(
    "torch_hybrid_oracle", os.path.join(os.path.dirname(__file__), "data",
                                        "torch_hybrid_oracle.py"))
oracle = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(oracle)

RTOL, ATOL = 2e-4, 2e-5


def _params(e=4, h=8, f=16, seed=0):
    r = np.random.RandomState(seed)
    return [(r.randn(h, e) * 0.5).astype(np.float32),
            (r.randn(e, h, f) * 0.1).astype(np.float32),
            (r.randn(e, f) * 0.1).astype(np.float32),
            (r.randn(e, f, h) * 0.1).astype(np.float32),
            (r.randn(e, h) * 0.1).astype(np.float32)]


def _rigged():
    """tests/test_moe.py's no-collision case: token 0 prefers e0 then e1,
    token 1 e1 then e0."""
    e, h, f = 2, 4, 8
    r = np.random.RandomState(9)
    x = np.stack([np.ones(h), -np.ones(h)]).astype(np.float32)
    gw = np.outer(np.ones(h), [1.0, -1.0]).astype(np.float32)
    return x, [gw, (r.randn(e, h, f) * 0.3).astype(np.float32),
               np.zeros((e, f), np.float32),
               (r.randn(e, f, h) * 0.3).astype(np.float32),
               np.zeros((e, h), np.float32)]


def _cases():
    r = np.random.RandomState(1)
    p = _params()
    return {
        "top1": (r.randn(16, 8).astype(np.float32), p, 1, 16.0),
        "top2": (r.randn(8, 8).astype(np.float32), p, 2, 16.0),
        "overflow": (np.ones((16, 8), np.float32), p, 1, 0.25),
        "top2_drops": (r.randn(32, 8).astype(np.float32), p, 2, 0.6),
        "aux_varied": (r.randn(64, 8).astype(np.float32), p, 1, 1.25),
        "no_collision": _rigged() + (2, 4.0),
    }


def _jax(x, ps, top_k, cf, scale=1.0):
    """The JAX switch_moe: (y, aux, grads of sum(y*y) + scale*aux wrt x
    and the five parameters)."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.distributed.moe import switch_moe

    def obj(args):
        y, aux = switch_moe(*args, top_k=top_k, capacity_factor=cf)
        return jnp.sum(y * y) + scale * aux

    def fwd(args):
        return switch_moe(*args, top_k=top_k, capacity_factor=cf)

    args = [jnp.asarray(a) for a in [x] + list(ps)]
    y, aux = jax.jit(fwd)(args)
    return (np.asarray(y), float(aux),
            [np.asarray(g) for g in jax.jit(jax.grad(obj))(args)])


def _port(x, ps, top_k, cf, fn=None):
    import torch

    from paddle_tpu_torch.distributed.moe import switch_moe

    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in [x] + ps]
    y, aux = (fn or switch_moe)(*ts, top_k=top_k, capacity_factor=cf)
    ((y * y).sum() + aux).backward()
    return y.detach().numpy(), float(aux), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("case", sorted(_cases()))
def test_switch_moe_matches_the_jax_function(case):
    x, ps, top_k, cf = _cases()[case]
    y, aux, grads = _port(x, ps, top_k, cf)
    jy, jaux, jgrads = _jax(x, ps, top_k, cf)
    np.testing.assert_allclose(y, jy, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(aux, jaux, rtol=1e-5)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, jg, rtol=RTOL, atol=ATOL)
    if case == "overflow":
        assert (np.abs(y) > 1e-9).any(-1).sum() <= 1


def test_aux_prefers_balance():
    x, ps, _, _ = _cases()["aux_varied"]
    assert _port(np.ones_like(x), ps, 1, 1.25)[1] > _port(x, ps, 1, 1.25)[1]


def _ref_moe(x, gw, wi, bi, wo, bo, top_k=1, capacity_factor=1.25):
    """tests/test_moe.py's plain formulation in PyTorch: the same
    routing, a scatter dispatch, autograd's backward."""
    import math

    import torch
    from torch.nn import functional as TF

    t, h = x.shape
    e = gw.shape[1]
    cap = max(1, int(math.ceil(capacity_factor * top_k * t / e)))
    probs = torch.softmax((x @ gw).float(), -1)
    remaining = probs
    y = torch.zeros_like(x)
    frac = torch.zeros(e)
    prior = torch.zeros(e)
    for _ in range(top_k):
        idx = remaining.argmax(-1)
        onehot = TF.one_hot(idx, e).float()
        gate = (remaining * onehot).sum(-1)
        frac = frac + onehot.mean(0)
        remaining = remaining * (1.0 - onehot)
        pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(1) + \
            prior[idx]
        prior = prior + onehot.sum(0)
        keep = pos < cap
        slot = torch.where(keep, idx * cap + pos.long(), e * cap)
        xe = torch.zeros(e * cap + 1, h).index_put((slot,), x)[:e * cap]
        hm = TF.gelu(torch.einsum("ech,ehf->ecf", xe.reshape(e, cap, h), wi)
                     + bi[:, None], approximate="tanh")
        ye = (torch.einsum("ecf,efh->ech", hm, wo)
              + bo[:, None]).reshape(e * cap, h)
        y = y + ye[slot.clamp(max=e * cap - 1)] * (gate * keep)[:, None]
    aux = e * ((frac / top_k) * probs.mean(0)).sum()
    return y, aux


@pytest.mark.parametrize("top_k,cf", [(1, 1.25), (2, 0.6), (1, 0.5),
                                      (2, 4.0)])
def test_gather_backwards_equal_autograd_of_the_scatter(top_k, cf):
    r = np.random.RandomState(5)
    x = r.randn(32, 8).astype(np.float32)
    ps = _params(seed=5)
    y, aux, grads = _port(x, ps, top_k, cf)
    ry, raux, rgrads = _port(x, ps, top_k, cf, fn=_ref_moe)
    np.testing.assert_allclose(y, ry, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux, raux, rtol=1e-6)
    for g, rg in zip(grads, rgrads):
        np.testing.assert_allclose(g, rg, rtol=RTOL, atol=ATOL)


#: (name, mesh, routing axes, top_k, capacity factor, E): the global
#: batch [B, S, H] = [4, 8, 8]
GROUPS = [("dp2_drops", {"dp": 2}, ["dp"], 1, 0.5, 4),
          ("dp2_top2", {"dp": 2}, ["dp"], 2, 0.6, 4),
          ("ep2", {"ep": 2}, [], 2, 1.25, 8)]
GROUPS4 = [("dp2sp2_drops", {"dp": 2, "sp": 2}, ["dp", "sp"], 2, 0.6, 4),
           ("dp2ep2", {"dp": 2, "ep": 2}, ["dp"], 1, 0.75, 8)]


def _group_inputs(groups):
    inp, cases = {}, []
    for name, mesh, route, top_k, cf, e in groups:
        r = np.random.RandomState(len(name))
        inp[f"{name}.x"] = r.randn(4, 8, 8).astype(np.float32)
        for k, a in zip(("gw", "wi", "bi", "wo", "bo"),
                        _params(e=e, seed=len(name) + 1)):
            inp[f"{name}.{k}"] = a
        cases.append(dict(name=name, mesh=mesh, route=route, top_k=top_k,
                          cf=cf))
    inp["cases"] = json.dumps(cases)
    return inp


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    out = {}
    for n, grp in ((2, GROUPS), (4, GROUPS4)):
        inp = _group_inputs(grp)
        res = oracle.run_job(tmp_path_factory.mktemp(f"moe{n}"), "moe", n,
                             inp)
        oracle.foreign_free(res)
        out.update({g[0]: (g, inp, res) for g in grp})
    return out


def _cut(a, mesh, rank_coords):
    """Rank's tokens of the global [B, S, H] (dim 0 over dp, dim 1 over
    sp), flattened."""
    dp, sp = mesh.get("dp", 1), mesh.get("sp", 1)
    a = np.split(a, dp, 0)[rank_coords.get("dp", 0)]
    a = np.split(a, sp, 1)[rank_coords.get("sp", 0)]
    return a.reshape(-1, a.shape[-1])


def _coords(mesh, rank):
    names = list(mesh)
    idx = np.unravel_index(rank, [mesh[n] for n in names])
    return dict(zip(names, (int(i) for i in idx)))


@pytest.mark.parametrize("name", [g[0] for g in GROUPS + GROUPS4])
def test_routing_group_equals_the_whole_batch(groups, name):
    (name, mesh, route, top_k, cf, e), inp, res = groups[name]
    x = inp[f"{name}.x"]
    ps = [inp[f"{name}.{k}"] for k in ("gw", "wi", "bi", "wo", "bo")]
    dp_sp = mesh.get("dp", 1) * mesh.get("sp", 1)
    jy, jaux, jg = _jax(x.reshape(-1, 8), ps, top_k, cf,
                        scale=float(dp_sp))
    jy = jy.reshape(x.shape)
    jdx = jg[0].reshape(x.shape)
    summed = [np.zeros_like(p) for p in ps]
    ep = mesh.get("ep", 1)
    for rank, (arrays, values) in enumerate(res):
        c = _coords(mesh, rank)
        want = _cut(jy, mesh, c)
        got = arrays[f"{name}.y"]
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        # the same kept tokens (a dropped token's output is 0 at top-1)
        np.testing.assert_array_equal(np.abs(got).max(-1) > 0,
                                      np.abs(want).max(-1) > 0)
        np.testing.assert_allclose(values[f"{name}.aux"], jaux, rtol=1e-5)
        np.testing.assert_allclose(arrays[f"{name}.dx"],
                                   _cut(jdx, mesh, c), rtol=RTOL, atol=ATOL)
        e_i = c.get("ep", 0)
        if e_i == 0:        # equal on every ep rank: one a dp rank
            summed[0] += arrays[f"{name}.dgw"]
        for i, k in enumerate(("wi", "bi", "wo", "bo"), 1):
            part = np.split(summed[i], ep, 0)[e_i]
            part += arrays[f"{name}.d{k}"]
    for g, want in zip(summed, jg[1:]):
        np.testing.assert_allclose(g, want, rtol=RTOL, atol=ATOL)
    if name.endswith("drops"):
        kept = (np.abs(jy).max(-1) > 0).mean()
        assert 0 < kept < 1, kept


@pytest.mark.parametrize("name", ["ep2", "dp2ep2"])
def test_ep_sums_once_a_layer(groups, name):
    """One all-reduce over ep forward (the output), two backward (the
    tokens' and the gate's gradients); the routing's all-gather and the
    probabilities' all-reduce over dp."""
    (name, mesh, route, *_), _, res = groups[name]
    dp = mesh.get("dp", 1)
    for _, values in res:
        ops = values[f"{name}.stats"]["ops"]
        assert ops.get("all_reduce", 0) == 3 + (2 if dp > 1 else 0), ops
        assert ops.get("all_gather", 0) == (1 if dp > 1 else 0), ops
