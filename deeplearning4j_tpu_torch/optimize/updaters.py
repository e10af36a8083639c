"""Gradient updaters with DL4J semantics.

Counterpart of ``deeplearning4j_tpu/optimize/updaters.py``: the same
IUpdater classes, hyperparameters and JSON, so that a
``configuration.json`` written by the JAX package reads and writes back
unchanged, and the same update math. Each updater has

  init_state(params)                      -> state
  apply(grads, state, params, step)       -> (updates, state)

on one layer's ``{name: Tensor}`` dict, where ``updates`` is what gets
SUBTRACTED from the params. The state keeps the JAX package's structure
(``{"m": {...}, "v": {...}}`` for Adam), so it is written in the same leaf
order. A layer whose group nests groups (Bidirectional's
``{"fwd": {...}, "bwd": {...}}``) gets state of the same nesting under each
moment, as the JAX package's tree maps give it; ``apply_mixed`` runs the
math on the leaves keyed by path. Memory: every moment in the state (m,
v, vhat, h, g2, msg, msdx) is updated IN PLACE and the same dicts are
returned; only the updates are new tensors.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.optimize.schedules import (
    resolve_lr, schedule_from_json)
from deeplearning4j_tpu_torch.tree_util import (
    flatten_group, is_nested, tree_map, unflatten_group)


def _zeros(params):
    return tree_map(torch.zeros_like, params)


class IUpdater:
    """Base: holds learningRate (float / schedule / callable)."""

    def __init__(self, learningRate=0.1):
        self.learningRate = learningRate

    def lr(self, step):
        return resolve_lr(self.learningRate, step)

    def init_state(self, params):
        return ()

    def apply(self, grads, state, params, step):
        raise NotImplementedError

    def apply_mixed(self, grads, state, params, step):
        """Master-dtype guard: each gradient takes its parameter's dtype
        before the updater math, so the state and the update stay in the
        master dtype. Identity when the dtypes already match. A nested
        group runs as one flat group keyed by leaf path: the moments are
        updated in place, so the nested state moves with them."""
        if is_nested(params):
            state_flat = (state if not isinstance(state, dict) else
                          {k: flatten_group(v) for k, v in state.items()})
            updates, _ = self.apply_mixed(flatten_group(grads), state_flat,
                                          flatten_group(params), step)
            return unflatten_group(updates), state
        grads = {k: g.to(params[k].dtype) if g.dtype != params[k].dtype
                 else g for k, g in grads.items()}
        return self.apply(grads, state, params, step)

    def to_json(self):
        d = {"@class": type(self).__name__}
        for k, v in self.__dict__.items():
            if hasattr(v, "to_json"):
                v = v.to_json()
            d[k] = v
        return d

    @staticmethod
    def from_json(d):
        return updater_from_config(d)


class NoOp(IUpdater):
    def __init__(self):
        super().__init__(0.0)

    def apply(self, grads, state, params, step):
        return {k: torch.zeros_like(g) for k, g in grads.items()}, state


class Sgd(IUpdater):
    DEFAULT_SGD_LR = 1e-3

    def __init__(self, learningRate=DEFAULT_SGD_LR):
        super().__init__(learningRate)

    def apply(self, grads, state, params, step):
        lr = self.lr(step)
        return {k: lr * g for k, g in grads.items()}, state


class Nesterovs(IUpdater):
    """Nesterov momentum, DL4J formulation (NesterovsUpdater):
    v' = mu*v - lr*g;  update = -(mu*v' - lr*g)."""

    DEFAULT_NESTEROV_MOMENTUM = 0.9

    def __init__(self, learningRate=0.1, momentum=DEFAULT_NESTEROV_MOMENTUM):
        super().__init__(learningRate)
        self.momentum = momentum

    def init_state(self, params):
        return {"v": _zeros(params)}

    def apply(self, grads, state, params, step):
        lr, mu = self.lr(step), self.momentum
        updates = {}
        for k, g in grads.items():
            v = state["v"][k]
            v.mul_(mu).sub_(lr * g)
            updates[k] = -(mu * v - lr * g)
        return updates, state


class AdaGrad(IUpdater):
    DEFAULT_ADAGRAD_EPSILON = 1e-6

    def __init__(self, learningRate=0.1, epsilon=DEFAULT_ADAGRAD_EPSILON):
        super().__init__(learningRate)
        self.epsilon = epsilon

    def init_state(self, params):
        return {"h": _zeros(params)}

    def apply(self, grads, state, params, step):
        lr = self.lr(step)
        updates = {}
        for k, g in grads.items():
            h = state["h"][k].add_(g * g)
            updates[k] = lr * g / (torch.sqrt(h) + self.epsilon)
        return updates, state


class RmsProp(IUpdater):
    DEFAULT_RMSPROP_RMSDECAY = 0.95
    DEFAULT_RMSPROP_EPSILON = 1e-8

    def __init__(self, learningRate=0.1, rmsDecay=DEFAULT_RMSPROP_RMSDECAY,
                 epsilon=DEFAULT_RMSPROP_EPSILON):
        super().__init__(learningRate)
        self.rmsDecay = rmsDecay
        self.epsilon = epsilon

    def init_state(self, params):
        return {"g2": _zeros(params)}

    def apply(self, grads, state, params, step):
        lr, d = self.lr(step), self.rmsDecay
        updates = {}
        for k, g in grads.items():
            a = state["g2"][k].mul_(d).add_((1 - d) * g * g)
            updates[k] = lr * g / torch.sqrt(a + self.epsilon)
        return updates, state


class AdaDelta(IUpdater):
    DEFAULT_ADADELTA_RHO = 0.95
    DEFAULT_ADADELTA_EPSILON = 1e-6

    def __init__(self, rho=DEFAULT_ADADELTA_RHO,
                 epsilon=DEFAULT_ADADELTA_EPSILON):
        super().__init__(1.0)  # AdaDelta has no lr
        self.rho = rho
        self.epsilon = epsilon

    def init_state(self, params):
        return {"msg": _zeros(params), "msdx": _zeros(params)}

    def apply(self, grads, state, params, step):
        rho, eps = self.rho, self.epsilon
        updates = {}
        for k, g in grads.items():
            a = state["msg"][k].mul_(rho).add_((1 - rho) * g * g)
            dx = state["msdx"][k]
            u = g * torch.sqrt(dx + eps) / torch.sqrt(a + eps)
            dx.mul_(rho).add_((1 - rho) * u * u)
            updates[k] = u
        return updates, state


class Adam(IUpdater):
    DEFAULT_ADAM_LEARNING_RATE = 1e-3
    DEFAULT_ADAM_BETA1 = 0.9
    DEFAULT_ADAM_BETA2 = 0.999
    DEFAULT_ADAM_EPSILON = 1e-8

    def __init__(self, learningRate=DEFAULT_ADAM_LEARNING_RATE,
                 beta1=DEFAULT_ADAM_BETA1, beta2=DEFAULT_ADAM_BETA2,
                 epsilon=DEFAULT_ADAM_EPSILON):
        super().__init__(learningRate)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def init_state(self, params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def _moments(self, k, g, state):
        b1, b2 = self.beta1, self.beta2
        m = state["m"][k].mul_(b1).add_((1 - b1) * g)
        v = state["v"][k].mul_(b2).add_((1 - b2) * g * g)
        return m, v

    def _bias_correction(self, step):
        t = step + 1
        return (1.0 - self.beta2 ** t) ** 0.5 / (1.0 - self.beta1 ** t)

    def apply(self, grads, state, params, step):
        lr = self.lr(step)
        bc = self._bias_correction(step)
        updates = {}
        for k, g in grads.items():
            m, v = self._moments(k, g, state)
            updates[k] = lr * bc * m / (torch.sqrt(v) + self.epsilon)
        return updates, state


class AdamW(Adam):
    """Adam with decoupled weight decay."""

    def __init__(self, learningRate=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weightDecay=0.01):
        super().__init__(learningRate, beta1, beta2, epsilon)
        self.weightDecay = weightDecay

    def apply(self, grads, state, params, step):
        updates, state = super().apply(grads, state, params, step)
        lr, wd = self.lr(step), self.weightDecay
        return {k: u + lr * wd * params[k] for k, u in updates.items()}, \
            state


class AMSGrad(Adam):
    def init_state(self, params):
        s = super().init_state(params)
        s["vhat"] = _zeros(params)
        return s

    def apply(self, grads, state, params, step):
        lr = self.lr(step)
        bc = self._bias_correction(step)
        updates = {}
        for k, g in grads.items():
            m, v = self._moments(k, g, state)
            vhat = torch.maximum(state["vhat"][k], v,
                                 out=state["vhat"][k])
            updates[k] = lr * bc * m / (torch.sqrt(vhat) + self.epsilon)
        return updates, state


class AdaMax(Adam):
    def apply(self, grads, state, params, step):
        lr, t, b1 = self.lr(step), step + 1, self.beta1
        updates = {}
        for k, g in grads.items():
            m = state["m"][k].mul_(b1).add_((1 - b1) * g)
            u = state["v"][k]
            torch.maximum(self.beta2 * u, g.abs(), out=u)
            updates[k] = lr / (1 - b1 ** t) * m / (u + self.epsilon)
        return updates, state


class Nadam(Adam):
    def apply(self, grads, state, params, step):
        lr, t = self.lr(step), step + 1
        b1, b2 = self.beta1, self.beta2
        updates = {}
        for k, g in grads.items():
            m, v = self._moments(k, g, state)
            mhat = b1 * m / (1 - b1 ** t) + (1 - b1) * g / (1 - b1 ** t)
            vhat = v / (1 - b2 ** t)
            updates[k] = lr * mhat / (torch.sqrt(vhat) + self.epsilon)
        return updates, state


_REGISTRY = {
    c.__name__: c
    for c in [NoOp, Sgd, Nesterovs, AdaGrad, RmsProp, AdaDelta, Adam, AdamW,
              AMSGrad, AdaMax, Nadam]
}


def updater_from_config(d):
    """Inverse of IUpdater.to_json."""
    if isinstance(d, IUpdater):
        return d
    d = dict(d)
    cls = _REGISTRY[d.pop("@class")]
    lr = d.pop("learningRate", None)
    if isinstance(lr, dict):  # serialized schedule (possibly nested)
        lr = schedule_from_json(lr)
    obj = cls.__new__(cls)
    IUpdater.__init__(obj, lr if lr is not None else 0.1)
    for k, v in d.items():
        setattr(obj, k, v)
    return obj

