"""Model zoo: canned architectures.

Counterpart of ``deeplearning4j_tpu/models/zoo.py``: the
``MultiLayerNetwork`` models, LeNet (the LeNet-MNIST baseline), SimpleCNN,
AlexNet, VGG16, VGG19, Darknet19 and TextGenerationLSTM, and ResNet50 (the
ImageNet throughput baseline), a ``ComputationGraph``. Each ``conf()``
builds the same configuration (and JSON) as the JAX package's, where
every model but LeNet, ResNet50 and TextGenerationLSTM builds it inside
``init()``; ``init(device=None)`` puts the network on "cuda" unless the
caller names another device. Weights are drawn from ``seed`` with a
``torch.Generator``, so they differ from the JAX package's; parity goes
through transferred weights.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.configuration import (
    NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    LSTM, ActivationLayer, BatchNormalization, ConvolutionLayer,
    ConvolutionMode, DenseLayer, DropoutLayer, GlobalPoolingLayer,
    LocalResponseNormalization, LossLayer, OutputLayer, PoolingType,
    RnnOutputLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.optimize.updaters import Adam, Nesterovs


class ZooModel:
    def conf(self):
        raise NotImplementedError

    def init(self, device=None) -> MultiLayerNetwork:
        """A network with weights drawn from ``seed``, on ``device``
        ("cuda" unless the caller names another)."""
        return MultiLayerNetwork(self.conf(), device=device).init()

    def metaData(self):
        return {"name": type(self).__name__}


class LeNet(ZooModel):
    """The LeNet-MNIST baseline: conv 20 5x5, max 2x2, conv 50 5x5, max
    2x2, dense 500, softmax over ``numClasses``, on flat 28x28x1 input;
    Adam(1e-3) unless another updater is given."""

    def __init__(self, numClasses=10, seed=123, inputShape=(1, 28, 28),
                 updater=None):
        self.numClasses = numClasses
        self.seed = seed
        self.inputShape = inputShape
        self.updater = updater or Adam(1e-3)

    def conf(self):
        c, h, w = self.inputShape
        return (NeuralNetConfiguration.Builder().seed(self.seed)
                .updater(self.updater).weightInit(WeightInit.XAVIER)
                .list()
                .layer(ConvolutionLayer.Builder().nOut(20).kernelSize([5, 5])
                       .stride([1, 1]).activation("relu").build())
                .layer(SubsamplingLayer.Builder(poolingType=PoolingType.MAX)
                       .kernelSize([2, 2]).stride([2, 2]).build())
                .layer(ConvolutionLayer.Builder().nOut(50).kernelSize([5, 5])
                       .stride([1, 1]).activation("relu").build())
                .layer(SubsamplingLayer.Builder(poolingType=PoolingType.MAX)
                       .kernelSize([2, 2]).stride([2, 2]).build())
                .layer(DenseLayer.Builder().nOut(500).activation("relu")
                       .build())
                .layer(OutputLayer.Builder().nOut(self.numClasses)
                       .activation("softmax").lossFunction("mcxent").build())
                .setInputType(InputType.convolutionalFlat(h, w, c))
                .build())


class SimpleCNN(ZooModel):
    def __init__(self, numClasses=10, seed=123, inputShape=(3, 48, 48)):
        self.numClasses = numClasses
        self.seed = seed
        self.inputShape = inputShape

    def conf(self):
        c, h, w = self.inputShape
        return (NeuralNetConfiguration.Builder().seed(self.seed)
                .updater(Adam(1e-3)).weightInit(WeightInit.RELU)
                .list()
                .layer(ConvolutionLayer.Builder().nOut(16)
                       .kernelSize([3, 3])
                       .convolutionMode(ConvolutionMode.SAME)
                       .activation("relu").build())
                .layer(BatchNormalization.Builder().build())
                .layer(ConvolutionLayer.Builder().nOut(16)
                       .kernelSize([3, 3])
                       .convolutionMode(ConvolutionMode.SAME)
                       .activation("relu").build())
                .layer(SubsamplingLayer.Builder().kernelSize([2, 2])
                       .stride([2, 2]).build())
                .layer(ConvolutionLayer.Builder().nOut(32)
                       .kernelSize([3, 3])
                       .convolutionMode(ConvolutionMode.SAME)
                       .activation("relu").build())
                .layer(BatchNormalization.Builder().build())
                .layer(SubsamplingLayer.Builder().kernelSize([2, 2])
                       .stride([2, 2]).build())
                .layer(GlobalPoolingLayer.Builder().build())
                .layer(DropoutLayer.Builder().dropOut(0.5).build())
                .layer(OutputLayer.Builder().nOut(self.numClasses)
                       .activation("softmax").lossFunction("mcxent").build())
                .setInputType(InputType.convolutional(h, w, c))
                .build())


class AlexNet(ZooModel):
    """AlexNet with LRN and without grouped convolutions."""

    def __init__(self, numClasses=1000, seed=123, inputShape=(3, 224, 224)):
        self.numClasses = numClasses
        self.seed = seed
        self.inputShape = inputShape

    def conf(self):
        c, h, w = self.inputShape
        return (NeuralNetConfiguration.Builder().seed(self.seed)
                .updater(Nesterovs(1e-2, 0.9)).weightInit(WeightInit.RELU)
                .list()
                .layer(ConvolutionLayer.Builder().nOut(96)
                       .kernelSize([11, 11]).stride([4, 4])
                       .activation("relu").build())
                .layer(LocalResponseNormalization.Builder().build())
                .layer(SubsamplingLayer.Builder().kernelSize([3, 3])
                       .stride([2, 2]).build())
                .layer(ConvolutionLayer.Builder().nOut(256)
                       .kernelSize([5, 5]).padding([2, 2])
                       .activation("relu").build())
                .layer(LocalResponseNormalization.Builder().build())
                .layer(SubsamplingLayer.Builder().kernelSize([3, 3])
                       .stride([2, 2]).build())
                .layer(ConvolutionLayer.Builder().nOut(384)
                       .kernelSize([3, 3]).padding([1, 1])
                       .activation("relu").build())
                .layer(ConvolutionLayer.Builder().nOut(384)
                       .kernelSize([3, 3]).padding([1, 1])
                       .activation("relu").build())
                .layer(ConvolutionLayer.Builder().nOut(256)
                       .kernelSize([3, 3]).padding([1, 1])
                       .activation("relu").build())
                .layer(SubsamplingLayer.Builder().kernelSize([3, 3])
                       .stride([2, 2]).build())
                .layer(DenseLayer.Builder().nOut(4096).activation("relu")
                       .dropOut(0.5).build())
                .layer(DenseLayer.Builder().nOut(4096).activation("relu")
                       .dropOut(0.5).build())
                .layer(OutputLayer.Builder().nOut(self.numClasses)
                       .activation("softmax").lossFunction("mcxent").build())
                .setInputType(InputType.convolutional(h, w, c))
                .build())


class VGG16(ZooModel):
    """BLOCKS = (channels, conv-repeats) per pooled stage; VGG19 overrides
    it."""

    BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

    def __init__(self, numClasses=1000, seed=123, inputShape=(3, 224, 224)):
        self.numClasses = numClasses
        self.seed = seed
        self.inputShape = inputShape

    def conf(self):
        c, h, w = self.inputShape
        b = (NeuralNetConfiguration.Builder().seed(self.seed)
             .updater(Nesterovs(1e-2, 0.9)).weightInit(WeightInit.RELU)
             .list())
        for n, reps in self.BLOCKS:
            for _ in range(reps):
                b = b.layer(ConvolutionLayer.Builder().nOut(n)
                            .kernelSize([3, 3])
                            .convolutionMode(ConvolutionMode.SAME)
                            .activation("relu").build())
            b = b.layer(SubsamplingLayer.Builder().kernelSize([2, 2])
                        .stride([2, 2]).build())
        return (b
                .layer(DenseLayer.Builder().nOut(4096).activation("relu")
                       .dropOut(0.5).build())
                .layer(DenseLayer.Builder().nOut(4096).activation("relu")
                       .dropOut(0.5).build())
                .layer(OutputLayer.Builder().nOut(self.numClasses)
                       .activation("softmax").lossFunction("mcxent").build())
                .setInputType(InputType.convolutional(h, w, c))
                .build())


class VGG19(VGG16):
    """VGG16 with a 4th conv in the last three blocks."""

    BLOCKS = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))


class Darknet19(ZooModel):
    """19 SAME convolutions (3x3 and 1x1, leaky ReLU), each followed by
    BatchNormalization, five 2x2 max poolings, a 1x1 conv to
    ``numClasses``, global average pooling and a softmax LossLayer."""

    PLAN = [(32, 3), "P", (64, 3), "P", (128, 3), (64, 1), (128, 3),
            "P", (256, 3), (128, 1), (256, 3), "P", (512, 3), (256, 1),
            (512, 3), (256, 1), (512, 3), "P", (1024, 3), (512, 1),
            (1024, 3), (512, 1), (1024, 3)]

    def __init__(self, numClasses=1000, seed=123, inputShape=(3, 224, 224)):
        self.numClasses = numClasses
        self.seed = seed
        self.inputShape = inputShape

    def conf(self):
        c, h, w = self.inputShape
        b = (NeuralNetConfiguration.Builder().seed(self.seed)
             .updater(Adam(1e-3)).weightInit(WeightInit.RELU).list())
        for item in self.PLAN:
            if item == "P":
                b = b.layer(SubsamplingLayer.Builder().kernelSize([2, 2])
                            .stride([2, 2]).build())
            else:
                n, k = item
                b = (b.layer(ConvolutionLayer.Builder().nOut(n)
                             .kernelSize([k, k])
                             .convolutionMode(ConvolutionMode.SAME)
                             .activation("leakyrelu").build())
                     .layer(BatchNormalization.Builder().build()))
        return (b.layer(ConvolutionLayer.Builder()
                        .nOut(self.numClasses).kernelSize([1, 1])
                        .convolutionMode(ConvolutionMode.SAME)
                        .activation("identity").build())
                .layer(GlobalPoolingLayer.Builder().build())
                .layer(LossLayer(lossFunction="mcxent",
                                 activation="softmax"))
                .setInputType(InputType.convolutional(h, w, c))
                .build())


class ResNet50(ZooModel):
    """ResNet-50 as a ComputationGraph: a 7x7/2 conv stem with
    BatchNormalization and a 3x3/2 max pool, then STAGES of bottleneck
    blocks (1x1, 3x3, 1x1 convs, each with BatchNormalization; a projected
    shortcut on each stage's first block, an identity one after; the sum
    through ReLU), global average pooling and a softmax output;
    Nesterovs(1e-2, 0.9) unless another updater is given. Float32 only
    until the precision slice: ``dataType="bfloat16"`` raises."""

    # (tag, blocks, (f1, f2, f3), the first block's stride)
    STAGES = (("s2", 3, (64, 64, 256), 1),
              ("s3", 4, (128, 128, 512), 2),
              ("s4", 6, (256, 256, 1024), 2),
              ("s5", 3, (512, 512, 2048), 2))

    def __init__(self, numClasses=1000, seed=123, inputShape=(3, 224, 224),
                 updater=None, dataType="float32"):
        if dataType != "float32":
            raise NotImplementedError(
                f"ResNet50 in {dataType} comes with the precision slice "
                f"(ROADMAP.md, queue 1 item 6)")
        self.numClasses = numClasses
        self.seed = seed
        self.inputShape = inputShape
        self.updater = updater or Nesterovs(1e-2, 0.9)
        self.dataType = dataType

    def conf(self):
        c, h, w = self.inputShape
        g = (NeuralNetConfiguration.Builder().seed(self.seed)
             .dataType(self.dataType)
             .updater(self.updater).weightInit(WeightInit.RELU)
             .graphBuilder()
             .addInputs("in"))
        g.setInputTypes(InputType.convolutional(h, w, c))

        def conv(name, n, k, s, inp):
            g.addLayer(name, ConvolutionLayer.Builder().nOut(n)
                       .kernelSize([k, k]).stride([s, s])
                       .convolutionMode(ConvolutionMode.SAME)
                       .activation("identity").build(), inp)
            return name

        def bn(name, inp, act="identity"):
            g.addLayer(name,
                       BatchNormalization.Builder().activation(act).build(),
                       inp)
            return name

        x = bn("bn1", conv("conv1", 64, 7, 2, "in"), "relu")
        g.addLayer("pool1", SubsamplingLayer.Builder().kernelSize([3, 3])
                   .stride([2, 2]).convolutionMode(ConvolutionMode.SAME)
                   .build(), x)
        x = "pool1"

        def bottleneck(tag, inp, filters, stride, project):
            f1, f2, f3 = filters
            a = bn(f"{tag}_b1", conv(f"{tag}_c1", f1, 1, stride, inp),
                   "relu")
            a = bn(f"{tag}_b2", conv(f"{tag}_c2", f2, 3, 1, a), "relu")
            a = bn(f"{tag}_b3", conv(f"{tag}_c3", f3, 1, 1, a))
            s = (bn(f"{tag}_projbn", conv(f"{tag}_proj", f3, 1, stride, inp))
                 if project else inp)
            g.addVertex(f"{tag}_add", ElementWiseVertex("Add"), a, s)
            g.addLayer(f"{tag}_out",
                       ActivationLayer.Builder().activation("relu").build(),
                       f"{tag}_add")
            return f"{tag}_out"

        for stage, blocks, filters, stride in self.STAGES:
            for i in range(blocks):
                x = bottleneck(f"{stage}_{i}", x, filters,
                               stride if i == 0 else 1, i == 0)
        g.addLayer("avgpool", GlobalPoolingLayer.Builder().build(), x)
        g.addLayer("out", OutputLayer.Builder().nOut(self.numClasses)
                   .activation("softmax").lossFunction("mcxent").build(),
                   "avgpool")
        g.setOutputs("out")
        return g.build()

    def init(self, device=None) -> ComputationGraph:
        """The graph with weights drawn from ``seed``, on ``device``
        ("cuda" unless the caller names another)."""
        return ComputationGraph(self.conf(), device=device).init()


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
