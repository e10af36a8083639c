"""Updater configurations and learning-rate schedules."""

from deeplearning4j_tpu_torch.optimize.updaters import (
    Sgd,
    Adam,
    AdamW,
    AdaMax,
    Nadam,
    AMSGrad,
    Nesterovs,
    AdaGrad,
    AdaDelta,
    RmsProp,
    NoOp,
    updater_from_config,
)
from deeplearning4j_tpu_torch.optimize.schedules import (
    FixedSchedule,
    ExponentialSchedule,
    InverseSchedule,
    PolySchedule,
    SigmoidSchedule,
    StepSchedule,
    MapSchedule,
    RampSchedule,
    CycleSchedule,
)

__all__ = [
    "Sgd", "Adam", "AdamW", "AdaMax", "Nadam", "AMSGrad", "Nesterovs",
    "AdaGrad", "AdaDelta", "RmsProp", "NoOp", "updater_from_config",
    "FixedSchedule", "ExponentialSchedule", "InverseSchedule", "PolySchedule",
    "SigmoidSchedule", "StepSchedule", "MapSchedule", "RampSchedule",
    "CycleSchedule",
]
