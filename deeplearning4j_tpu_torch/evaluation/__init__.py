"""Evaluation: classification, regression and calibration metrics over
network outputs (counterpart of ``deeplearning4j_tpu.evaluation``)."""

from deeplearning4j_tpu_torch.evaluation.classification import (  # noqa: F401
    Evaluation, EvaluationBinary, ROC, ROCBinary, ROCMultiClass)
from deeplearning4j_tpu_torch.evaluation.regression import (  # noqa: F401
    RegressionEvaluation)
from deeplearning4j_tpu_torch.evaluation.calibration import (  # noqa: F401
    EvaluationCalibration, ReliabilityDiagram)
