"""Learning-rate schedules.

Counterpart of ``deeplearning4j_tpu/optimize/schedules.py``: the same
ISchedule classes, fields and JSON. The port steps on the host, so a
schedule is a plain function of the integer iteration returning a float.
"""

from __future__ import annotations

import math


class ISchedule:
    def valueAt(self, iteration, epoch=0):
        raise NotImplementedError

    def __call__(self, step):
        return self.valueAt(step)

    def to_json(self):
        d = {"@class": type(self).__name__}
        for k, v in self.__dict__.items():
            d[k] = v.to_json() if isinstance(v, ISchedule) else v
        return d


class FixedSchedule(ISchedule):
    def __init__(self, value: float):
        self.value = value

    def valueAt(self, iteration, epoch=0):
        return self.value


class ExponentialSchedule(ISchedule):
    def __init__(self, initialValue: float, gamma: float):
        self.initialValue = initialValue
        self.gamma = gamma

    def valueAt(self, iteration, epoch=0):
        return self.initialValue * self.gamma ** iteration


class InverseSchedule(ISchedule):
    def __init__(self, initialValue: float, gamma: float, power: float):
        self.initialValue = initialValue
        self.gamma = gamma
        self.power = power

    def valueAt(self, iteration, epoch=0):
        return self.initialValue / (1.0 + self.gamma * iteration) ** self.power


class PolySchedule(ISchedule):
    def __init__(self, initialValue: float, power: float, maxIter: int):
        self.initialValue = initialValue
        self.power = power
        self.maxIter = maxIter

    def valueAt(self, iteration, epoch=0):
        frac = min(iteration / self.maxIter, 1.0)
        return self.initialValue * (1.0 - frac) ** self.power


class SigmoidSchedule(ISchedule):
    def __init__(self, initialValue: float, gamma: float, stepSize: int):
        self.initialValue = initialValue
        self.gamma = gamma
        self.stepSize = stepSize

    def valueAt(self, iteration, epoch=0):
        return self.initialValue / (
            1.0 + math.exp(self.gamma * (iteration - self.stepSize)))


class StepSchedule(ISchedule):
    def __init__(self, initialValue: float, decayRate: float, step: float):
        self.initialValue = initialValue
        self.decayRate = decayRate
        self.step = step

    def valueAt(self, iteration, epoch=0):
        return self.initialValue * self.decayRate ** math.floor(
            iteration / self.step)


class MapSchedule(ISchedule):
    """Piecewise-constant: {iteration: value}. First key must be 0."""

    def __init__(self, values: dict):
        self.values = dict(sorted((int(k), float(v))
                                  for k, v in values.items()))

    def valueAt(self, iteration, epoch=0):
        keys = list(self.values)
        idx = sum(k <= iteration for k in keys) - 1
        return list(self.values.values())[idx]


class RampSchedule(ISchedule):
    """Linear warmup from 0 to the wrapped schedule over numIter steps."""

    def __init__(self, baseSchedule: ISchedule, numIter: int):
        self.baseSchedule = baseSchedule
        self.numIter = numIter

    def valueAt(self, iteration, epoch=0):
        ramp = min((iteration + 1.0) / self.numIter, 1.0)
        return ramp * self.baseSchedule.valueAt(iteration, epoch)


class CycleSchedule(ISchedule):
    """1cycle-style: ramp up then down, with a final annihilation phase."""

    def __init__(self, initialLearningRate, maxLearningRate, cycleLength,
                 annealingLength=None, annealingDecay=0.1):
        self.initialLearningRate = initialLearningRate
        self.maxLearningRate = maxLearningRate
        self.cycleLength = cycleLength
        self.annealingLength = annealingLength or max(cycleLength // 10, 1)
        self.annealingDecay = annealingDecay

    def valueAt(self, iteration, epoch=0):
        half = (self.cycleLength - self.annealingLength) / 2.0
        it = float(iteration)
        lo, hi = self.initialLearningRate, self.maxLearningRate
        if it < half:
            return lo + (hi - lo) * (it / half)
        if it < 2 * half:
            return hi - (hi - lo) * ((it - half) / half)
        return lo * self.annealingDecay ** (
            (it - 2 * half) / max(self.annealingLength, 1))


_SCHEDULES = {c.__name__: c for c in (
    FixedSchedule, ExponentialSchedule, InverseSchedule, PolySchedule,
    SigmoidSchedule, StepSchedule, MapSchedule, RampSchedule,
    CycleSchedule)}


def schedule_from_json(d) -> ISchedule:
    d = dict(d)
    cls = _SCHEDULES[d.pop("@class")]
    kwargs = {
        k: schedule_from_json(v) if isinstance(v, dict) and "@class" in v
        else v
        for k, v in d.items()
    }
    return cls(**kwargs)


def resolve_lr(lr, step):
    """lr may be a float, an ISchedule, or a callable(step)."""
    if isinstance(lr, ISchedule):
        return lr.valueAt(step)
    if callable(lr):
        return lr(step)
    return lr
