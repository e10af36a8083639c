"""Updater configurations (the config side only).

Counterpart of ``deeplearning4j_tpu/optimize/updaters.py``: the same
IUpdater classes and hyperparameters, so that a ``configuration.json``
written by the JAX package reads and writes back unchanged. The update
math (``init_state``/``apply``) comes with the training slice; a learning
rate schedule stays as its JSON dict until then.
"""

from __future__ import annotations


class IUpdater:
    """Base: holds learningRate (a float, or a schedule's JSON dict)."""

    def __init__(self, learningRate=0.1):
        self.learningRate = learningRate

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


class Sgd(IUpdater):
    DEFAULT_SGD_LR = 1e-3

    def __init__(self, learningRate=DEFAULT_SGD_LR):
        super().__init__(learningRate)


class Nesterovs(IUpdater):
    DEFAULT_NESTEROV_MOMENTUM = 0.9

    def __init__(self, learningRate=0.1, momentum=DEFAULT_NESTEROV_MOMENTUM):
        super().__init__(learningRate)
        self.momentum = momentum


class AdaGrad(IUpdater):
    DEFAULT_ADAGRAD_EPSILON = 1e-6

    def __init__(self, learningRate=0.1, epsilon=DEFAULT_ADAGRAD_EPSILON):
        super().__init__(learningRate)
        self.epsilon = epsilon


class RmsProp(IUpdater):
    DEFAULT_RMSPROP_RMSDECAY = 0.95
    DEFAULT_RMSPROP_EPSILON = 1e-8

    def __init__(self, learningRate=0.1, rmsDecay=DEFAULT_RMSPROP_RMSDECAY,
                 epsilon=DEFAULT_RMSPROP_EPSILON):
        super().__init__(learningRate)
        self.rmsDecay = rmsDecay
        self.epsilon = epsilon


class AdaDelta(IUpdater):
    DEFAULT_ADADELTA_RHO = 0.95
    DEFAULT_ADADELTA_EPSILON = 1e-6

    def __init__(self, rho=DEFAULT_ADADELTA_RHO,
                 epsilon=DEFAULT_ADADELTA_EPSILON):
        super().__init__(1.0)  # AdaDelta has no lr
        self.rho = rho
        self.epsilon = epsilon


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


class AdamW(Adam):
    def __init__(self, learningRate=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weightDecay=0.01):
        super().__init__(learningRate, beta1, beta2, epsilon)
        self.weightDecay = weightDecay


class AMSGrad(Adam):
    pass


class AdaMax(Adam):
    pass


class Nadam(Adam):
    pass


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
    obj = cls.__new__(cls)
    IUpdater.__init__(obj, lr if lr is not None else 0.1)
    for k, v in d.items():
        setattr(obj, k, v)
    return obj
