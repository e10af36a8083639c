"""NeuralNetConfiguration builder DSL and MultiLayerConfiguration.

Counterpart of ``deeplearning4j_tpu/nn/conf/configuration.py``: global
defaults cloned into per-layer configs, nIn inference front to back, and
the same canonical JSON, so a ``configuration.json`` written by either
package builds the same network in the other. The layers ported so far
are dense, embedding, recurrent and the recurrent wrappers, which need no
preprocessors.
"""

from __future__ import annotations

import json

import numpy as np

from deeplearning4j_tpu_torch.backend import torch_dtype
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    LSTM, BaseLayer, DenseLayer, EmbeddingSequenceLayer, SimpleRnn)
from deeplearning4j_tpu_torch.optimize.updaters import (
    IUpdater, Sgd, updater_from_config)


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
            n_in = getattr(first, "nIn", None)
            if n_in is None:
                return
            if isinstance(first, (LSTM, SimpleRnn, EmbeddingSequenceLayer)):
                it = InputType.recurrent(n_in)
            elif isinstance(first, DenseLayer):
                it = InputType.feedForward(n_in)
            else:
                return
        for i, lr in enumerate(self.layers):
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

        def list(self):
            return ListBuilder(self._defaults, self._seed, self._dataType,
                               self._precision)
