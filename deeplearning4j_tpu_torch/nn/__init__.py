"""Networks, layers, activations and weight initialization."""

from deeplearning4j_tpu_torch.nn.activations import Activation  # noqa: F401
from deeplearning4j_tpu_torch.nn.weights import WeightInit  # noqa: F401
from deeplearning4j_tpu_torch.nn.losses import LossFunction  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.configuration import (  # noqa: F401
    BackpropType, MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf import layers  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.layers import (  # noqa: F401
    Bidirectional, DenseLayer, EmbeddingLayer, EmbeddingSequenceLayer,
    GravesLSTM, GRU, LastTimeStep, LSTM, OutputLayer, RnnOutputLayer,
    SimpleRnn)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: F401
    GradientNormalization, MultiLayerNetwork)
