"""Config DSL: layers, input types and the network configuration."""

from deeplearning4j_tpu_torch.nn.conf.configuration import (  # noqa: F401
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf import variational  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf import objdetect  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf import layers_extra  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf import attention  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf import capsnet  # noqa: F401
