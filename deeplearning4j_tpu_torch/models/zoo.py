"""Model zoo: canned architectures.

Counterpart of ``deeplearning4j_tpu/models/zoo.py``; the char-RNN is the
first model ported. Each ``conf()`` builds the same configuration (and
JSON) as the JAX package's.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.configuration import (
    NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import LSTM, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.optimize.updaters import Adam


class ZooModel:
    def conf(self):
        raise NotImplementedError

    def init(self, device=None):
        raise NotImplementedError


class TextGenerationLSTM(ZooModel):
    """The GravesLSTM char-RNN baseline (DL4J zoo TextGenerationLSTM):
    two LSTM layers and a softmax RnnOutputLayer over a one-hot vocabulary,
    input and output [N, vocabSize, T]."""

    def __init__(self, vocabSize=77, hidden=256, seqLength=100, seed=123,
                 updater=None):
        self.vocabSize = vocabSize
        self.hidden = hidden
        self.seqLength = seqLength
        self.seed = seed
        self.updater = updater or Adam(2e-3)

    def conf(self):
        return (NeuralNetConfiguration.Builder().seed(self.seed)
                .updater(self.updater).weightInit(WeightInit.XAVIER)
                .list()
                .layer(LSTM.Builder().nOut(self.hidden).activation("tanh")
                       .build())
                .layer(LSTM.Builder().nOut(self.hidden).activation("tanh")
                       .build())
                .layer(RnnOutputLayer.Builder().nOut(self.vocabSize)
                       .activation("softmax").lossFunction("mcxent").build())
                .setInputType(InputType.recurrent(self.vocabSize,
                                                  self.seqLength))
                .build())

    def init(self, device=None) -> MultiLayerNetwork:
        """A network with weights drawn from ``seed``, on ``device``
        ("cuda" unless the caller names another)."""
        return MultiLayerNetwork(self.conf(), device=device).init()
