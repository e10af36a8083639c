"""Networks, layers, activations and weight initialization."""

from deeplearning4j_tpu_torch.nn.activations import Activation  # noqa: F401
from deeplearning4j_tpu_torch.nn.weights import WeightInit  # noqa: F401
from deeplearning4j_tpu_torch.nn.losses import LossFunction  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.configuration import (  # noqa: F401
    BackpropType, MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (  # noqa: F401
    ComputationGraphConfiguration, ElementWiseVertex, GraphVertex,
    L2NormalizeVertex, MergeVertex, ReshapeVertex, ScaleVertex, ShiftVertex,
    StackVertex, SubsetVertex)
from deeplearning4j_tpu_torch.nn.conf import layers  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.layers import (  # noqa: F401
    ActivationLayer, BatchNormalization, Bidirectional, Convolution1DLayer,
    ConvolutionLayer, ConvolutionMode, Deconvolution2D, DenseLayer,
    DepthToSpace, DepthwiseConvolution2D, DropoutLayer, EmbeddingLayer,
    EmbeddingSequenceLayer, GlobalPoolingLayer, GravesLSTM, GRU,
    LastTimeStep, LocalResponseNormalization, LossLayer, LSTM, OutputLayer,
    PoolingType, RnnOutputLayer, SeparableConvolution2D, SimpleRnn,
    SpaceToDepth, Subsampling1DLayer, SubsamplingLayer, Upsampling2D,
    ZeroPaddingLayer)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: F401
    GradientNormalization, MultiLayerNetwork)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph  # noqa: F401
