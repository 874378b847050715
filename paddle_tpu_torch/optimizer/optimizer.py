"""Optimizers (mirrors ``paddle_tpu/optimizer/optimizer.py``; reference:
paddle/fluid/operators/optimizers/adam_op.cu, python/paddle/optimizer/).

The same functional rule as the reference: every step reads the learning
rate (a float or an ``lr.LRScheduler``), clips the gradients, adds an L2
``weight_decay`` to the gradient when one is set, and updates each
parameter with ``_update`` in f32 math. The result is written back in
place at the dtypes the parameter and its state are stored in (the
trainer's ``param_dtype`` / ``moment_dtype`` cast-back rule). ``Adam``
and ``AdamW`` are ported; ``torch.optim`` is not used, because its decay
ordering differs from the reference's ``_decayed_update``.

``parameters`` takes tensors or ``(name, tensor)`` pairs, as
``model.named_parameters()`` gives them. ``AdamW``'s
``apply_decay_param_fun(name)`` reads those names (torch parameters
carry none of their own); ``lr_ratio(param)`` scales the learning rate
per parameter.

Not ported here: SGD, Momentum, Adamax, Adagrad, Adadelta, RMSProp, Lamb,
Lars, ``GradientMerge`` and L1/L2 regularizer objects (ROADMAP queue 1
item 9).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .clip import apply_grad_clip
from .lr import LRScheduler

__all__ = ["Optimizer", "Adam", "AdamW"]


def _long_tail(what):
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP queue 1 item 9 (long tail)")


class Optimizer:
    """Base: learning rate, gradient clip, L2 decay, per-parameter state
    and ``state_dict``. Subclasses define ``_init_state`` and
    ``_update``."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._parameter_list: List[torch.Tensor] = []
        self._names: Dict[int, Optional[str]] = {}
        for item in (parameters if parameters is not None else ()):
            name_, p = item if isinstance(item, tuple) else (None, item)
            self._parameter_list.append(p)
            self._names[id(p)] = name_
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        if weight_decay is None:
            self._weight_decay = 0.0
        elif isinstance(weight_decay, (int, float)):
            self._weight_decay = float(weight_decay)  # L2: g += wd * p
        else:
            raise _long_tail(f"weight_decay={type(weight_decay).__name__}")
        self._accumulators: Dict[int, dict] = {}
        self._global_step = 0

    # -- lr ----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "optimizer's learning rate can't be LRScheduler when invoke "
                "this API, because this will lead to conflict.")
        self._learning_rate = float(value)

    @property
    def _lr_scheduler(self):
        return self._learning_rate if isinstance(self._learning_rate,
                                                 LRScheduler) else None

    # -- state -------------------------------------------------------------
    def _init_state(self, p: torch.Tensor) -> dict:
        return {}

    def _state_for(self, p: torch.Tensor) -> dict:
        s = self._accumulators.get(id(p))
        if s is None:
            s = self._init_state(p)
            self._accumulators[id(p)] = s
        return s

    def _param_name(self, p: torch.Tensor) -> Optional[str]:
        return self._names.get(id(p))

    # -- the update rule (override) ---------------------------------------
    def _update(self, p, g, state: dict, lr: float, step: int, wd=0.0):
        """Update ``p`` and ``state`` in place from the f32 gradient
        ``g``."""
        raise NotImplementedError

    def _decoupled_wd(self, p: torch.Tensor) -> float:
        """Per-parameter decoupled weight-decay coefficient (AdamW
        overrides; 0 disables)."""
        return 0.0

    def _lr_ratio(self, p: torch.Tensor) -> float:
        return 1.0

    @torch.no_grad()
    def _update_param(self, p, g, s, lr: float, step: int, plr=1.0,
                      wd=0.0) -> None:
        """The update rule of one parameter (or a flat slice of several)
        ``p`` and its state ``s``, in place, from its clipped gradient
        ``g``: the L2 decay (``weight_decay`` as a number) on the f32
        gradient, then ``_update`` at ``lr * plr`` with decoupled decay
        ``wd`` (``plr`` and ``wd``: numbers, or vectors laid out like a
        flat ``p``)."""
        g = g.float()
        if self._weight_decay:
            g = g + self._weight_decay * p.float()
        self._update(p, g, s, lr * plr, step, wd=wd)

    def _apply_updates(self, params, lr: float, step: int) -> None:
        """One update of every parameter in ``params`` from its ``.grad``
        (already clipped)."""
        for p in params:
            self._update_param(p, p.grad, self._state_for(p), lr, step,
                               self._lr_ratio(p), self._decoupled_wd(p))

    # -- step --------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        params = [p for p in self._parameter_list
                  if p.requires_grad and p.grad is not None]
        if not params:
            return
        if self._grad_clip is not None:
            apply_grad_clip(self._grad_clip, params)
        self._global_step += 1
        self._apply_updates(params, self.get_lr(), self._global_step)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Dygraph minimize: backward + step."""
        loss.backward()
        self.step()
        return [], []

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    # -- checkpoint --------------------------------------------------------
    def state_dict(self) -> dict:
        sd = {}
        for i, p in enumerate(self._parameter_list):
            s = self._accumulators.get(id(p))
            for k, v in (s or {}).items():
                sd[f"{self._param_name(p) or i}_{k}"] = v
        if self._lr_scheduler is not None:
            sd["LR_Scheduler"] = self._lr_scheduler.state_dict()
        sd["global_step"] = self._global_step
        return sd

    def set_state_dict(self, state_dict):
        self._global_step = int(state_dict.get("global_step", 0))
        if "LR_Scheduler" in state_dict and self._lr_scheduler is not None:
            self._lr_scheduler.set_state_dict(state_dict["LR_Scheduler"])
        for i, p in enumerate(self._parameter_list):
            s = self._init_state(p)
            found = False
            for k in list(s):
                key = f"{self._param_name(p) or i}_{k}"
                if key in state_dict:
                    s[k] = torch.as_tensor(state_dict[key]).to(
                        device=s[k].device, dtype=s[k].dtype).clone()
                    found = True
            if found:
                self._accumulators[id(p)] = s

    set_dict = set_state_dict


class Adam(Optimizer):
    """reference: operators/optimizers/adam_op.cu."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_state(self, p):
        return {"moment1": torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device),
                "moment2": torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)}

    def _update(self, p, g, state, lr, step, wd=0.0):
        """The reference's ``_decayed_update``: f32 moments with bias
        correction, ``upd = lr·(m̂/(√v̂+ε) + wd·p)``; the new moments and
        parameter are stored back at their own dtypes."""
        m1, m2 = state["moment1"], state["moment2"]
        m = self._beta1 * m1.float() + (1 - self._beta1) * g
        v = self._beta2 * m2.float() + (1 - self._beta2) * g * g
        mhat = m / (1 - self._beta1 ** step)
        vhat = v / (1 - self._beta2 ** step)
        pf = p.float()
        upd = lr * (mhat / (torch.sqrt(vhat) + self._epsilon) + wd * pf)
        p.copy_(pf - upd)
        m1.copy_(m)
        m2.copy_(v)


class AdamW(Adam):
    """reference: python/paddle/optimizer/adamw.py (decoupled decay)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        if not isinstance(weight_decay, (int, float)):
            raise _long_tail(f"weight_decay={type(weight_decay).__name__}")
        self._coeff = float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio_fn = lr_ratio
        if apply_decay_param_fun is not None and any(
                n is None for n in self._names.values()):
            raise ValueError("apply_decay_param_fun reads parameter names: "
                             "pass parameters=model.named_parameters()")

    def _decoupled_wd(self, p):
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(self._param_name(p)):
            return 0.0
        return self._coeff

    def _lr_ratio(self, p):
        return 1.0 if self._lr_ratio_fn is None else \
            float(self._lr_ratio_fn(p))
