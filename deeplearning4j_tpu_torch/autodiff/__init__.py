"""SameDiff graphs over the op registry (counterpart of
``deeplearning4j_tpu.autodiff``): ``ops`` holds the ops by the
reference's names, ``samediff`` the graph, its autograd, ``fit``, control
flow and save/load."""

from deeplearning4j_tpu_torch.autodiff.samediff import (
    SameDiff,
    SDVariable,
    TrainingConfig,
    VariableType,
)

__all__ = ["SameDiff", "SDVariable", "TrainingConfig", "VariableType"]
