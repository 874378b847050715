"""The pair harness of the port's ``nn`` tests: a JAX-package function and
its port counterpart on the same seeded numpy inputs, their values and the
gradients of ``sum(out * ct)`` (``ct`` a seeded cotangent) with respect to
the float inputs named, held at a stated tolerance."""
import numpy as np
import torch

import paddle_tpu as paddle

TOL = dict(rtol=1e-5, atol=1e-5)


def arr(shape, seed, lo=None, hi=None, dtype=np.float32):
    r = np.random.RandomState(seed)
    if lo is not None:
        return r.randint(lo, hi, shape).astype(dtype)
    return r.randn(*shape).astype(dtype)


def _j(a, grad):
    if isinstance(a, np.ndarray):
        return paddle.to_tensor(a, stop_gradient=not grad)
    return a


def _t(a, grad):
    if isinstance(a, np.ndarray):
        t = torch.from_numpy(a.copy())
        return t.requires_grad_(True) if grad else t
    return a


def check_pair(jfn, tfn, args, grads=(), kw=None, tol=TOL, seed=99):
    """``jfn(*args, **kw)`` (JAX package, numpy args as tensors) against
    ``tfn(*args, **kw)`` (port, numpy args as CPU tensors): the values and
    the gradients of the args whose indices are in ``grads``."""
    kw = kw or {}
    jargs = [_j(a, i in grads) for i, a in enumerate(args)]
    targs = [_t(a, i in grads) for i, a in enumerate(args)]
    jo = jfn(*jargs, **kw)
    to = tfn(*targs, **kw)
    jv = np.asarray(jo.numpy())
    tv = to.detach().float().numpy()
    assert tv.shape == jv.shape, (tv.shape, jv.shape)
    np.testing.assert_allclose(tv, jv, **tol)
    if grads:
        ct = np.random.RandomState(seed).randn(*jv.shape).astype(np.float32) \
            if jv.shape else np.float32(1.0)
        (jo * paddle.to_tensor(ct)).sum().backward()
        (to * torch.from_numpy(np.asarray(ct))).sum().backward()
        for i in grads:
            np.testing.assert_allclose(
                targs[i].grad.numpy(), np.asarray(jargs[i].grad.numpy()),
                err_msg=f"gradient of argument {i}", **tol)
    return jv, tv


def paired_models(name, seed, **kw):
    """(reference model, port model) of ``name`` (a class or factory
    function of both packages' ``vision.models``) with one state: the
    port's model built on the CPU after ``seed(seed)``, the reference's
    built abstract under ``LazyGuard`` (its initializers compile one XLA
    program a parameter shape, about 18 s for a ResNet on the CPU) and
    given that state; the port's is then loaded back from the
    reference's ``state_dict`` through ``load_reference_state``."""
    from paddle_tpu.framework.lazy import is_abstract
    from paddle_tpu.vision import models as jm
    from paddle_tpu_torch import seed as tseed
    from paddle_tpu_torch.models.gpt import load_reference_state
    from paddle_tpu_torch.vision import models as tm

    tseed(seed)
    tnet = getattr(tm, name)(device="cpu", **kw)
    with paddle.LazyGuard():
        jnet = getattr(jm, name)(**kw)
    jnet.set_state_dict({k: v.detach().numpy().copy()
                         for k, v in tnet.state_dict().items()})
    assert not any(is_abstract(p) for p in jnet.parameters())
    state = {k: np.asarray(v._value).copy()
             for k, v in jnet.state_dict().items()}
    assert sorted(tnet.state_dict()) == sorted(state)
    load_reference_state(tnet, state)
    return jnet, tnet

