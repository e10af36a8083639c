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
from deeplearning4j_tpu_torch.nn.conf.objdetect import (  # noqa: F401
    Yolo2OutputLayer)
from deeplearning4j_tpu_torch.nn.conf.attention import (  # noqa: F401
    AttentionVertex, LearnedSelfAttentionLayer, RecurrentAttentionLayer,
    SelfAttentionLayer)
from deeplearning4j_tpu_torch.nn.conf.capsnet import (  # noqa: F401
    CapsuleLayer, CapsuleStrengthLayer, PrimaryCapsules)
from deeplearning4j_tpu_torch.nn.conf.layers_extra import (  # noqa: F401
    CenterLossOutputLayer, Convolution3D, Cropping1D, Cropping2D,
    Cropping3D, ElementWiseMultiplicationLayer, FrozenLayer,
    LocallyConnected1D, LocallyConnected2D, MaskZeroLayer, MoELayer,
    OCNNOutputLayer, PReLULayer, RepeatVector, Subsampling3DLayer,
    Upsampling1D, Upsampling3D)
from deeplearning4j_tpu_torch.nn.objdetect import (  # noqa: F401
    DetectedObject, YoloUtils)
from deeplearning4j_tpu_torch.nn.conf.variational import (  # noqa: F401
    AutoEncoder, BernoulliReconstructionDistribution,
    GaussianReconstructionDistribution, VariationalAutoencoder)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: F401
    GradientNormalization, MultiLayerNetwork)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph  # noqa: F401
