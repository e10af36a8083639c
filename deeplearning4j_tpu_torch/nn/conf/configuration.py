"""NeuralNetConfiguration builder DSL and MultiLayerConfiguration.

Counterpart of ``deeplearning4j_tpu/nn/conf/configuration.py``: global
defaults cloned into per-layer configs, nIn inference front to back, and
the same canonical JSON, so a ``configuration.json`` written by either
package builds the same network in the other. Shape inference records a
preprocessor before a layer where the activations change kind, as the
JAX package's does: a flat [N, C*H*W] input (``convolutionalFlat``) is
reshaped to [N, C, H, W] before the first conv or pooling layer, and conv
activations are flattened channel-major to [N, C*H*W] before the first
layer that does not take them as they are (a dense or output layer).
A wrapper (FrozenLayer, MaskZeroLayer) is inferred by its inner layer.
"""

from __future__ import annotations

import json

import numpy as np

from deeplearning4j_tpu_torch.backend import torch_dtype
from deeplearning4j_tpu_torch.nn.conf.inputs import (
    ConvolutionalFlatType, ConvolutionalType, InputType)
from deeplearning4j_tpu_torch.nn.conf.layers import (
    LSTM, ActivationLayer, BaseLayer, BatchNormalization,
    Convolution1DLayer, ConvolutionLayer, Deconvolution2D, DenseLayer,
    DepthToSpace, DropoutLayer, EmbeddingSequenceLayer, GlobalPoolingLayer,
    LocalResponseNormalization, SimpleRnn, SpaceToDepth, SubsamplingLayer,
    Upsampling2D, ZeroPaddingLayer)
from deeplearning4j_tpu_torch.nn.conf.capsnet import PrimaryCapsules
from deeplearning4j_tpu_torch.nn.conf.layers_extra import (
    Cropping2D, FrozenLayer, LocallyConnected2D, MaskZeroLayer, PReLULayer)
from deeplearning4j_tpu_torch.nn.conf.objdetect import Yolo2OutputLayer
from deeplearning4j_tpu_torch.nn.conf.variational import (
    AutoEncoder, VariationalAutoencoder)
from deeplearning4j_tpu_torch.optimize.updaters import (
    IUpdater, Sgd, updater_from_config)

# preprocessor kinds recorded per layer index: (kind, shape or None)
_PP_FLATTEN = "cnn_to_ff"
_PP_TO_CNN = "ff_to_cnn"

# layers that take conv activations as they are: no flatten before them
_TAKES_CONV = (ActivationLayer, BatchNormalization, Cropping2D,
               Deconvolution2D, DepthToSpace, DropoutLayer,
               GlobalPoolingLayer, LocalResponseNormalization,
               LocallyConnected2D, PReLULayer, PrimaryCapsules, SpaceToDepth,
               Upsampling2D, Yolo2OutputLayer, ZeroPaddingLayer)


def _apply_preprocessor(pp, x):
    """``x`` through the preprocessor ``pp`` recorded for a layer (None:
    unchanged). The flatten is channel-major, [N, C, H, W] -> [N, C*H*W]."""
    if pp is None:
        return x
    kind, shape = pp
    if kind == _PP_FLATTEN:
        return x.reshape(x.shape[0], -1)
    if kind == _PP_TO_CNN:
        return x.reshape((x.shape[0],) + tuple(shape))
    raise ValueError(f"unknown preprocessor {kind}")


def _wants_conv(layer):
    """Layers that consume CNN activations directly (GlobalPooling reduces
    the spatial axes itself; Dropout and Activation keep the shape); a
    FrozenLayer as its inner layer."""
    if isinstance(layer, FrozenLayer):
        return _wants_conv(layer.layer)
    return isinstance(layer, _TAKES_CONV)


class BackpropType:
    Standard = "Standard"
    TruncatedBPTT = "TruncatedBPTT"


class MultiLayerConfiguration:
    def __init__(self, layers, defaults=None, inputType=None, seed=12345,
                 dataType="float32", backpropType=BackpropType.Standard,
                 tbpttLength=None, precision=None):
        self.layers: list[BaseLayer] = layers
        self.defaults = defaults or {}
        self.inputType = inputType
        self.seed = seed
        self.dataType = dataType
        self.backpropType = backpropType
        self.tbpttLength = tbpttLength
        # a precision policy (name or JSON) is carried for the round trip;
        # the network refuses to run one until the precision slice lands
        self.precision = precision
        self.preprocessors: list = [None] * len(layers)
        self.layer_input_types: list = [None] * len(layers)
        self._finalize()

    def _finalize(self):
        """Clone defaults into layers and run shape inference front-to-back."""
        if not self.layers:
            return
        for lr in self.layers:
            lr.apply_defaults(self.defaults)
        it = self.inputType
        if it is None:
            # no declared input type: a first layer that states its nIn
            # implies the input kind, and inference chains from there
            first = self.layers[0]
            while isinstance(first, (FrozenLayer, MaskZeroLayer)):
                first = (first.layer if isinstance(first, FrozenLayer)
                         else first.underlying)
            n_in = getattr(first, "nIn", None)
            if n_in is None:
                return
            if isinstance(first, (LSTM, SimpleRnn, Convolution1DLayer,
                                  EmbeddingSequenceLayer)):
                it = InputType.recurrent(n_in)
            elif isinstance(first, (DenseLayer, AutoEncoder,
                                    VariationalAutoencoder)):
                it = InputType.feedForward(n_in)
            else:
                return
        for i, lr in enumerate(self.layers):
            if isinstance(it, ConvolutionalFlatType) and isinstance(
                    lr, (ConvolutionLayer, PrimaryCapsules,
                         SubsamplingLayer)):
                self.preprocessors[i] = (
                    _PP_TO_CNN, (it.channels, it.height, it.width))
                it = InputType.convolutional(it.height, it.width, it.channels)
            elif isinstance(it, ConvolutionalType) and not isinstance(
                    it, ConvolutionalFlatType) and not isinstance(
                    lr, (ConvolutionLayer, SubsamplingLayer)) \
                    and not _wants_conv(lr):
                self.preprocessors[i] = (_PP_FLATTEN, None)
                it = InputType.feedForward(it.arrayElementsPerExample())
            self.layer_input_types[i] = it
            it = lr.infer(it)

    # -- serde ---------------------------------------------------------------
    def to_json(self):
        return json.dumps({
            "layers": [lr.to_json() for lr in self.layers],
            "defaults": _json_defaults(self.defaults),
            "inputType": self.inputType.to_json() if self.inputType else None,
            "seed": self.seed,
            "dataType": self.dataType,
            "backpropType": self.backpropType,
            "tbpttLength": self.tbpttLength,
            "precision": self.precision,
        }, indent=1)

    toJson = to_json

    @staticmethod
    def from_json(s):
        d = json.loads(s) if isinstance(s, str) else s
        defaults = dict(d.get("defaults") or {})
        if isinstance(defaults.get("updater"), dict):
            defaults["updater"] = updater_from_config(defaults["updater"])
        layers = [BaseLayer.from_json(ld) for ld in d["layers"]]
        it = (InputType.from_json(d["inputType"]) if d.get("inputType")
              else None)
        return MultiLayerConfiguration(
            layers, defaults, it, d.get("seed", 12345),
            d.get("dataType", "float32"),
            d.get("backpropType", BackpropType.Standard),
            d.get("tbpttLength"), d.get("precision"))

    fromJson = from_json

    @property
    def dtype(self):
        """The torch dtype of dataType."""
        return torch_dtype(self.dataType)


def _json_defaults(defaults):
    return {k: v.to_json() if hasattr(v, "to_json") else v
            for k, v in defaults.items()}


class ListBuilder:
    def __init__(self, defaults, seed, dataType, precision=None):
        self._defaults = defaults
        self._seed = seed
        self._dataType = dataType
        self._precision = precision
        self._layers: list = []
        self._input_type = None
        self._backprop_type = BackpropType.Standard
        self._tbptt_length = None

    def layer(self, idx_or_layer, layer=None):
        if layer is None:
            self._layers.append(idx_or_layer)
        else:
            idx = int(idx_or_layer)
            while len(self._layers) <= idx:
                self._layers.append(None)
            self._layers[idx] = layer
        return self

    def setInputType(self, input_type):
        self._input_type = input_type
        return self

    def inputType(self, input_type):
        return self.setInputType(input_type)

    def backpropType(self, bt):
        self._backprop_type = bt
        return self

    def tBPTTLength(self, n):
        self._backprop_type = BackpropType.TruncatedBPTT
        self._tbptt_length = int(n)
        return self

    def tBPTTForwardLength(self, n):
        return self.tBPTTLength(n)

    def tBPTTBackwardLength(self, n):
        self._tbptt_length = min(self._tbptt_length or int(n), int(n))
        return self

    def build(self) -> MultiLayerConfiguration:
        if any(lr is None for lr in self._layers):
            raise ValueError("layer list has gaps")
        return MultiLayerConfiguration(self._layers, dict(self._defaults),
                                       self._input_type, self._seed,
                                       self._dataType,
                                       self._backprop_type,
                                       self._tbptt_length,
                                       self._precision)


class NeuralNetConfiguration:
    """Entry point: NeuralNetConfiguration.Builder()...list()...build()."""

    class Builder:
        def __init__(self):
            self._defaults = {"updater": Sgd(1e-2)}
            self._seed = 12345
            self._dataType = "float32"
            self._precision = None

        def seed(self, s):
            self._seed = int(s)
            return self

        def updater(self, u: IUpdater):
            self._defaults["updater"] = u
            return self

        def weightInit(self, wi):
            self._defaults["weightInit"] = wi
            return self

        def activation(self, a):
            self._defaults["activation"] = a
            return self

        def l1(self, v):
            self._defaults["l1"] = float(v)
            return self

        def l2(self, v):
            self._defaults["l2"] = float(v)
            return self

        def dropOut(self, p):
            self._defaults["dropOut"] = float(p)
            return self

        def biasInit(self, v):
            self._defaults["biasInit"] = float(v)
            return self

        def dataType(self, dt):
            name = str(dt).removeprefix("torch.")
            self._dataType = str(np.dtype(name)) if name != "bfloat16" \
                else name
            torch_dtype(self._dataType)  # reject an unsupported type now
            return self

        def precision(self, policy):
            self._precision = policy
            return self

        def gradientNormalization(self, gn, threshold=1.0):
            self._defaults["gradientNormalization"] = gn
            self._defaults["gradientNormalizationThreshold"] = threshold
            return self

        def miniBatch(self, flag=True):
            return self

        def trainingWorkspaceMode(self, *_):
            """Accepted and ignored: PyTorch's caching allocator manages
            device memory, and there are no workspaces."""
            return self

        def inferenceWorkspaceMode(self, *_):
            """Accepted and ignored, as ``trainingWorkspaceMode``."""
            return self

        def cudnnAlgoMode(self, *_):
            """Accepted and ignored: the configuration and its JSON are
            unchanged, ``cudnn.benchmark`` stays off and cuDNN picks each
            convolution's algorithm by its heuristics, so a shape takes
            the same algorithm every call and TF32 stays off."""
            return self

        def list(self):
            return ListBuilder(self._defaults, self._seed, self._dataType,
                               self._precision)

        def graphBuilder(self):
            from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
                GraphBuilder)

            return GraphBuilder(self._defaults, self._seed, self._dataType,
                                self._precision)
