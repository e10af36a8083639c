"""Model zoo: canned architectures.

Counterpart of ``deeplearning4j_tpu/models/zoo.py``: the
``MultiLayerNetwork`` models, LeNet (the LeNet-MNIST baseline), SimpleCNN,
AlexNet, VGG16, VGG19, Darknet19, TinyYOLO (tiny-YOLOv2 on VOC) and
TextGenerationLSTM, and the ``ComputationGraph`` models, ResNet50 (the
ImageNet throughput baseline), YOLO2 (Darknet-19 with the reorg
passthrough, 80 COCO classes), UNet, SqueezeNet, Xception, NASNet,
FaceNetNN4Small2 and InceptionResNetV1. Each ``conf()`` builds the same
configuration (and JSON) as the JAX package's, where the JAX package
builds some inside ``init()``; ``init(device=None)`` puts the network on
"cuda" unless the caller names another device. Weights are drawn from
``seed`` with a ``torch.Generator``, so they differ from the JAX
package's; parity goes through transferred weights.
``ZooModel.initPretrained`` (local checkpoint files) comes with
``utils/checkpoint.py``.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.configuration import (
    NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ElementWiseVertex, L2NormalizeVertex, MergeVertex, ScaleVertex)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    LSTM, ActivationLayer, BatchNormalization, ConvolutionLayer,
    ConvolutionMode, Deconvolution2D, DenseLayer, DropoutLayer,
    GlobalPoolingLayer, LocalResponseNormalization, LossLayer, OutputLayer,
    PoolingType, RnnOutputLayer, SeparableConvolution2D, SpaceToDepth,
    SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.conf.layers_extra import (
    CenterLossOutputLayer)
from deeplearning4j_tpu_torch.nn.conf.objdetect import Yolo2OutputLayer
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


class GraphZooModel(ZooModel):
    """A zoo model built as a ComputationGraph."""

    def init(self, device=None) -> ComputationGraph:
        """The graph with weights drawn from ``seed``, on ``device``
        ("cuda" unless the caller names another)."""
        return ComputationGraph(self.conf(), device=device).init()


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


class ResNet50(GraphZooModel):
    """ResNet-50 as a ComputationGraph: a 7x7/2 conv stem with
    BatchNormalization and a 3x3/2 max pool, then STAGES of bottleneck
    blocks (1x1, 3x3, 1x1 convs, each with BatchNormalization; a projected
    shortcut on each stage's first block, an identity one after; the sum
    through ReLU), global average pooling and a softmax output;
    Nesterovs(1e-2, 0.9) unless another updater is given.
    ``dataType="bfloat16"`` is the uniform bfloat16 policy: params,
    running statistics, updater state and compute in bfloat16."""

    # (tag, blocks, (f1, f2, f3), the first block's stride)
    STAGES = (("s2", 3, (64, 64, 256), 1),
              ("s3", 4, (128, 128, 512), 2),
              ("s4", 6, (256, 256, 1024), 2),
              ("s5", 3, (512, 512, 2048), 2))

    def __init__(self, numClasses=1000, seed=123, inputShape=(3, 224, 224),
                 updater=None, dataType="float32"):
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


class TinyYOLO(ZooModel):
    """Tiny-YOLOv2 on VOC: 5 anchor priors, 20 classes, 416x416 input to
    a 13x13 grid; five conv (no bias) + BatchNormalization (leaky ReLU) +
    2x2/2 max-pool stages (16 ... 256 filters), conv 512 with a stride-1
    SAME pool, two conv 1024, a 1x1 conv to B*(5+C) and a
    Yolo2OutputLayer; Adam(1e-3) unless another updater is given."""

    PRIORS = [[1.08, 1.19], [3.42, 4.41], [6.63, 11.38], [9.42, 5.11],
              [16.62, 10.52]]

    def __init__(self, numClasses=20, seed=123, inputShape=(3, 416, 416),
                 boundingBoxPriors=None, updater=None):
        self.numClasses = numClasses
        self.seed = seed
        self.inputShape = inputShape
        self.priors = (boundingBoxPriors if boundingBoxPriors is not None
                       else self.PRIORS)
        self.updater = updater or Adam(1e-3)

    def conf(self):
        c, h, w = self.inputShape
        b = (NeuralNetConfiguration.Builder().seed(self.seed)
             .updater(self.updater).weightInit(WeightInit.RELU).list())

        def conv(n, k=3):
            return (ConvolutionLayer.Builder().nOut(n).kernelSize([k, k])
                    .convolutionMode(ConvolutionMode.SAME)
                    .activation("identity").hasBias(False).build())

        def bn():
            return (BatchNormalization.Builder().activation("leakyrelu")
                    .build())

        for n in (16, 32, 64, 128, 256):
            b = (b.layer(conv(n)).layer(bn())
                 .layer(SubsamplingLayer.Builder().kernelSize([2, 2])
                        .stride([2, 2]).build()))
        # a stride-1 SAME pool keeps the 13x13 grid (tiny-YOLOv2 layer 6)
        b = (b.layer(conv(512)).layer(bn())
             .layer(SubsamplingLayer.Builder().kernelSize([2, 2])
                    .stride([1, 1])
                    .convolutionMode(ConvolutionMode.SAME).build()))
        for n in (1024, 1024):
            b = b.layer(conv(n)).layer(bn())
        n_out = len(self.priors) * (5 + self.numClasses)
        return (b.layer(ConvolutionLayer.Builder().nOut(n_out)
                        .kernelSize([1, 1])
                        .convolutionMode(ConvolutionMode.SAME)
                        .activation("identity").build())
                .layer(Yolo2OutputLayer(boundingBoxPriors=self.priors))
                .setInputType(InputType.convolutional(h, w, c))
                .build())


class YOLO2(GraphZooModel):
    """YOLOv2: the Darknet-19 trunk (conv, no bias, + BatchNormalization
    with leaky ReLU, nodes c0, c0b, ...), the SpaceToDepth "reorg"
    passthrough of the 26x26x512 features (1x1 conv to 64, then 13x13x256)
    merged into the 13x13x1024 head, a conv 1024, a 1x1 conv to B*(5+C)
    and a Yolo2OutputLayer; 416x416x3 input, 80 classes, the 5 COCO
    priors; Adam(1e-3) unless another updater is given."""

    PRIORS = [[0.57273, 0.677385], [1.87446, 2.06253], [3.33843, 5.47434],
              [7.88282, 3.52778], [9.77052, 9.16828]]

    def __init__(self, numClasses=80, seed=123, inputShape=(3, 416, 416),
                 boundingBoxPriors=None, updater=None):
        self.numClasses = numClasses
        self.seed = seed
        self.inputShape = inputShape
        self.priors = (boundingBoxPriors if boundingBoxPriors is not None
                       else self.PRIORS)
        self.updater = updater or Adam(1e-3)

    def conf(self):
        c, h, w = self.inputShape
        g = (NeuralNetConfiguration.Builder().seed(self.seed)
             .updater(self.updater).weightInit(WeightInit.RELU)
             .graphBuilder()
             .addInputs("in"))
        g.setInputTypes(InputType.convolutional(h, w, c))
        idx = [0]

        def conv(n, k, x):
            name = f"c{idx[0]}"
            idx[0] += 1
            g.addLayer(name, ConvolutionLayer.Builder().nOut(n)
                       .kernelSize([k, k])
                       .convolutionMode(ConvolutionMode.SAME)
                       .activation("identity").hasBias(False).build(), x)
            g.addLayer(name + "b", BatchNormalization.Builder()
                       .activation("leakyrelu").build(), name)
            return name + "b"

        def pool(x):
            name = f"p{idx[0]}"
            idx[0] += 1
            g.addLayer(name, SubsamplingLayer.Builder().kernelSize([2, 2])
                       .stride([2, 2]).build(), x)
            return name

        x = pool(conv(32, 3, "in"))
        x = pool(conv(64, 3, x))
        for n1, n2 in ((128, 64), (256, 128)):
            x = pool(conv(n1, 3, conv(n2, 1, conv(n1, 3, x))))
        for n, k in ((512, 3), (256, 1), (512, 3), (256, 1), (512, 3)):
            x = conv(n, k, x)
        passthrough = x                       # 26x26x512
        x = pool(x)
        for n, k in ((1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3),
                     (1024, 3), (1024, 3)):
            x = conv(n, k, x)

        p = conv(64, 1, passthrough)
        g.addLayer("reorg", SpaceToDepth.Builder().blockSize(2).build(), p)
        g.addVertex("cat", MergeVertex(), "reorg", x)
        x = conv(1024, 3, "cat")
        n_out = len(self.priors) * (5 + self.numClasses)
        g.addLayer("head", ConvolutionLayer.Builder().nOut(n_out)
                   .kernelSize([1, 1]).convolutionMode(ConvolutionMode.SAME)
                   .activation("identity").build(), x)
        g.addLayer("out", Yolo2OutputLayer(boundingBoxPriors=self.priors),
                   "head")
        g.setOutputs("out")
        return g.build()


def _graph(model):
    """A graph builder from ``model``'s seed, dataType (where it has
    one), updater and He init, with one conv input "in" of its
    inputShape."""
    c, h, w = model.inputShape
    b = NeuralNetConfiguration.Builder().seed(model.seed)
    if hasattr(model, "dataType"):
        b = b.dataType(model.dataType)
    g = (b.updater(model.updater).weightInit(WeightInit.RELU)
         .graphBuilder().addInputs("in"))
    g.setInputTypes(InputType.convolutional(h, w, c))
    return g


class UNet(GraphZooModel):
    """Encoder-decoder segmentation net: three down blocks (two SAME 3x3
    convs and a 2x2 pool), a middle pair, three up blocks
    (Deconvolution2D 2x2/2, the skip merged, two convs), a 1x1 conv to
    ``numClasses`` and a per-pixel sigmoid ``xent`` LossLayer. ``base``
    scales the published 64 filters."""

    def __init__(self, numClasses=1, seed=123, inputShape=(3, 128, 128),
                 base=64, updater=None, dataType="float32"):
        self.numClasses = numClasses
        self.seed = seed
        self.inputShape = inputShape
        self.base = base
        self.updater = updater or Adam(1e-3)
        self.dataType = dataType

    def conf(self):
        g = _graph(self)

        def conv(name, n, inp, act="relu", k=3):
            g.addLayer(name, ConvolutionLayer.Builder().nOut(n)
                       .kernelSize([k, k]).stride([1, 1])
                       .convolutionMode(ConvolutionMode.SAME)
                       .activation(act).build(), inp)
            return name

        def down(tag, n, inp):
            a = conv(f"{tag}_c2", n, conv(f"{tag}_c1", n, inp))
            g.addLayer(f"{tag}_pool", SubsamplingLayer.Builder()
                       .kernelSize([2, 2]).stride([2, 2]).build(), a)
            return a, f"{tag}_pool"

        def up(tag, n, inp, skip):
            g.addLayer(f"{tag}_up", Deconvolution2D.Builder().nOut(n)
                       .kernelSize([2, 2]).stride([2, 2])
                       .convolutionMode(ConvolutionMode.SAME)
                       .activation("relu").build(), inp)
            g.addVertex(f"{tag}_cat", MergeVertex(), f"{tag}_up", skip)
            return conv(f"{tag}_c2", n, conv(f"{tag}_c1", n, f"{tag}_cat"))

        b = self.base
        s1, x = down("d1", b, "in")
        s2, x = down("d2", b * 2, x)
        s3, x = down("d3", b * 4, x)
        x = conv("mid_c2", b * 8, conv("mid_c1", b * 8, x))
        x = up("u3", b * 4, x, s3)
        x = up("u2", b * 2, x, s2)
        x = up("u1", b, x, s1)
        conv("logits", self.numClasses, x, act="identity", k=1)
        g.addLayer("out", LossLayer(lossFunction="xent",
                                    activation="sigmoid"), "logits")
        g.setOutputs("out")
        return g.build()


class SqueezeNet(GraphZooModel):
    """SqueezeNet v1.1: fire modules (a 1x1 squeeze, parallel 1x1 and 3x3
    expands merged), 3x3/2 pools, dropout, a 1x1 conv to ``numClasses``,
    global average pooling and a softmax LossLayer."""

    def __init__(self, numClasses=1000, seed=123, inputShape=(3, 227, 227),
                 updater=None, dataType="float32"):
        self.numClasses = numClasses
        self.seed = seed
        self.inputShape = inputShape
        self.updater = updater or Adam(1e-3)
        self.dataType = dataType

    def conf(self):
        g = _graph(self)

        def fire(tag, inp, squeeze, expand):
            g.addLayer(f"{tag}_sq", ConvolutionLayer.Builder().nOut(squeeze)
                       .kernelSize([1, 1]).stride([1, 1])
                       .activation("relu").build(), inp)
            g.addLayer(f"{tag}_e1", ConvolutionLayer.Builder().nOut(expand)
                       .kernelSize([1, 1]).stride([1, 1])
                       .activation("relu").build(), f"{tag}_sq")
            g.addLayer(f"{tag}_e3", ConvolutionLayer.Builder().nOut(expand)
                       .kernelSize([3, 3]).stride([1, 1])
                       .convolutionMode(ConvolutionMode.SAME)
                       .activation("relu").build(), f"{tag}_sq")
            g.addVertex(f"{tag}_cat", MergeVertex(), f"{tag}_e1",
                        f"{tag}_e3")
            return f"{tag}_cat"

        def pool(name, inp):
            g.addLayer(name, SubsamplingLayer.Builder().kernelSize([3, 3])
                       .stride([2, 2]).build(), inp)
            return name

        g.addLayer("conv1", ConvolutionLayer.Builder().nOut(64)
                   .kernelSize([3, 3]).stride([2, 2]).activation("relu")
                   .build(), "in")
        x = fire("f3", fire("f2", pool("pool1", "conv1"), 16, 64), 16, 64)
        x = fire("f5", fire("f4", pool("pool3", x), 32, 128), 32, 128)
        x = fire("f7", fire("f6", pool("pool5", x), 48, 192), 48, 192)
        x = fire("f9", fire("f8", x, 64, 256), 64, 256)
        g.addLayer("drop", DropoutLayer.Builder().dropOut(0.5).build(), x)
        g.addLayer("conv10", ConvolutionLayer.Builder()
                   .nOut(self.numClasses).kernelSize([1, 1]).stride([1, 1])
                   .activation("relu").build(), "drop")
        g.addLayer("gap", GlobalPoolingLayer.Builder().build(), "conv10")
        g.addLayer("out", LossLayer(lossFunction="mcxent",
                                    activation="softmax"), "gap")
        g.setOutputs("out")
        return g.build()


class Xception(GraphZooModel):
    """Xception: depthwise-separable convolutions with residual
    shortcuts; a compressed entry flow (a conv stem and one strided
    separable block with a projected shortcut), ``blocks`` residual
    triple-separable middle blocks (8 published), an exit block, global
    average pooling and a softmax output."""

    def __init__(self, numClasses=1000, seed=123, inputShape=(3, 299, 299),
                 blocks=8, updater=None, dataType="float32"):
        self.numClasses = numClasses
        self.seed = seed
        self.inputShape = inputShape
        self.blocks = blocks
        self.updater = updater or Adam(1e-3)
        self.dataType = dataType

    def conf(self):
        g = _graph(self)

        def sep(name, n, inp, act="relu"):
            g.addLayer(name, SeparableConvolution2D.Builder().nOut(n)
                       .kernelSize([3, 3]).stride([1, 1])
                       .convolutionMode(ConvolutionMode.SAME)
                       .activation(act).build(), inp)
            return name

        def bn(name, inp, act="identity"):
            g.addLayer(name, BatchNormalization.Builder().activation(act)
                       .build(), inp)
            return name

        g.addLayer("conv1", ConvolutionLayer.Builder().nOut(32)
                   .kernelSize([3, 3]).stride([2, 2]).activation("relu")
                   .build(), "in")
        x = bn("bn1", "conv1", "relu")
        g.addLayer("conv2", ConvolutionLayer.Builder().nOut(64)
                   .kernelSize([3, 3]).stride([1, 1]).activation("relu")
                   .build(), x)
        x = bn("bn2", "conv2", "relu")
        mid = 128
        a = bn("entry_b1", sep("entry_s1", mid, x), "relu")
        a = bn("entry_b2", sep("entry_s2", mid, a))
        g.addLayer("entry_pool", SubsamplingLayer.Builder()
                   .kernelSize([3, 3]).stride([2, 2])
                   .convolutionMode(ConvolutionMode.SAME).build(), a)
        g.addLayer("entry_proj", ConvolutionLayer.Builder().nOut(mid)
                   .kernelSize([1, 1]).stride([2, 2]).build(), x)
        g.addVertex("entry_add", ElementWiseVertex("Add"), "entry_pool",
                    "entry_proj")
        x = "entry_add"
        for i in range(self.blocks):
            tag = f"mid{i}"
            a = bn(f"{tag}_b1", sep(f"{tag}_s1", mid, x), "relu")
            a = bn(f"{tag}_b2", sep(f"{tag}_s2", mid, a), "relu")
            a = bn(f"{tag}_b3", sep(f"{tag}_s3", mid, a))
            g.addVertex(f"{tag}_add", ElementWiseVertex("Add"), a, x)
            x = f"{tag}_add"
        a = bn("exit_b1", sep("exit_s1", mid * 2, x), "relu")
        g.addLayer("gap", GlobalPoolingLayer.Builder().build(), a)
        g.addLayer("out", OutputLayer.Builder().nOut(self.numClasses)
                   .activation("softmax").lossFunction("mcxent").build(),
                   "gap")
        g.setOutputs("out")
        return g.build()


class NASNet(GraphZooModel):
    """NASNet-A Mobile: ``numBlocks`` normal cells a stage, reduction
    cells between stages, penultimateFilters = 24 times the base filter
    count (so it must divide by 24). Each cell squeezes its two inputs
    (h, h_prev) to the stage's width with a 1x1 conv + BatchNormalization
    (h_prev strided to h's size), runs NASNet-A's five branches of
    separable convs and 3x3 pools, and merges them; a reduction cell
    strides 2."""

    def __init__(self, numClasses=1000, seed=123, inputShape=(3, 224, 224),
                 numBlocks=4, penultimateFilters=1056, stemFilters=32,
                 updater=None, dataType="float32"):
        if penultimateFilters % 24:
            raise ValueError(
                f"penultimateFilters must be divisible by 24 (NASNet-A "
                f"concat width), got {penultimateFilters}")
        self.numClasses = numClasses
        self.seed = seed
        self.inputShape = inputShape
        self.numBlocks = numBlocks
        self.penultimateFilters = penultimateFilters
        self.stemFilters = stemFilters
        self.updater = updater or Adam(1e-3)
        self.dataType = dataType

    def conf(self):
        g = _graph(self)
        h = self.inputShape[1]
        f0 = self.penultimateFilters // 24

        def conv1x1(name, n, inp, stride=1):
            g.addLayer(f"{name}_c", ConvolutionLayer.Builder().nOut(n)
                       .kernelSize([1, 1]).stride([stride, stride])
                       .convolutionMode(ConvolutionMode.SAME)
                       .activation("relu").build(), inp)
            g.addLayer(name, BatchNormalization.Builder().build(),
                       f"{name}_c")
            return name

        def sep_block(name, n, k, stride, inp):
            """sepconv(k, stride) relu -> bn relu -> sepconv(k) -> bn."""
            g.addLayer(f"{name}_s1", SeparableConvolution2D.Builder()
                       .nOut(n).kernelSize([k, k]).stride([stride, stride])
                       .convolutionMode(ConvolutionMode.SAME)
                       .activation("relu").build(), inp)
            g.addLayer(f"{name}_b1", BatchNormalization.Builder()
                       .activation("relu").build(), f"{name}_s1")
            g.addLayer(f"{name}_s2", SeparableConvolution2D.Builder()
                       .nOut(n).kernelSize([k, k]).stride([1, 1])
                       .convolutionMode(ConvolutionMode.SAME)
                       .activation("identity").build(), f"{name}_b1")
            g.addLayer(name, BatchNormalization.Builder().build(),
                       f"{name}_s2")
            return name

        def pool(name, kind, stride, inp):
            g.addLayer(name, SubsamplingLayer.Builder()
                       .poolingType(kind)
                       .kernelSize([3, 3]).stride([stride, stride])
                       .convolutionMode(ConvolutionMode.SAME).build(), inp)
            return name

        def add(name, a, b):
            g.addVertex(name, ElementWiseVertex("Add"), a, b)
            return name

        # the square spatial size of each cell's output: an h_prev that
        # is larger than the cell's h strides by the ceiling of the ratio
        sz = {}

        def normal_cell(tag, p, x, n):
            hq = conv1x1(f"{tag}_hq", n, x)
            pq = conv1x1(f"{tag}_pq", n, p, stride=-(-sz[p] // sz[x]))
            sz[f"{tag}_out"] = sz[x]
            b1 = add(f"{tag}_b1", sep_block(f"{tag}_b1l", n, 3, 1, hq),
                     sep_block(f"{tag}_b1r", n, 5, 1, pq))
            b2 = add(f"{tag}_b2", sep_block(f"{tag}_b2l", n, 5, 1, pq),
                     sep_block(f"{tag}_b2r", n, 3, 1, pq))
            b3 = add(f"{tag}_b3", pool(f"{tag}_b3l", PoolingType.AVG, 1,
                                       hq), pq)
            b4 = add(f"{tag}_b4", pool(f"{tag}_b4l", PoolingType.AVG, 1,
                                       pq),
                     pool(f"{tag}_b4r", PoolingType.AVG, 1, pq))
            b5 = add(f"{tag}_b5", sep_block(f"{tag}_b5l", n, 3, 1, hq),
                     hq)
            g.addVertex(f"{tag}_out", MergeVertex(), pq, b1, b2, b3, b4,
                        b5)
            return f"{tag}_out"

        def reduction_cell(tag, p, x, n):
            target = -(-sz[x] // 2)
            hq = conv1x1(f"{tag}_hq", n, x)
            pq = conv1x1(f"{tag}_pq", n, p, stride=-(-sz[p] // target))
            sz[f"{tag}_out"] = target
            # pq is already at the target size: its branches stride 1
            b1 = add(f"{tag}_b1", sep_block(f"{tag}_b1l", n, 5, 2, hq),
                     sep_block(f"{tag}_b1r", n, 7, 1, pq))
            b2 = add(f"{tag}_b2", pool(f"{tag}_b2l", PoolingType.MAX, 2,
                                       hq),
                     sep_block(f"{tag}_b2r", n, 7, 1, pq))
            b3 = add(f"{tag}_b3", pool(f"{tag}_b3l", PoolingType.AVG, 2,
                                       hq),
                     sep_block(f"{tag}_b3r", n, 5, 1, pq))
            b4 = add(f"{tag}_b4", pool(f"{tag}_b4l", PoolingType.MAX, 2,
                                       hq),
                     sep_block(f"{tag}_b4r", n, 3, 1, b1))
            b5 = add(f"{tag}_b5", pool(f"{tag}_b5l", PoolingType.AVG, 1,
                                       b1), b2)
            g.addVertex(f"{tag}_out", MergeVertex(), b2, b3, b4, b5)
            return f"{tag}_out"

        g.addLayer("stem_conv", ConvolutionLayer.Builder()
                   .nOut(self.stemFilters).kernelSize([3, 3])
                   .stride([2, 2]).convolutionMode(ConvolutionMode.SAME)
                   .build(), "in")
        g.addLayer("stem_bn", BatchNormalization.Builder().build(),
                   "stem_conv")
        sz["stem_bn"] = -(-h // 2)
        p, x = "stem_bn", reduction_cell("stem_r1", "stem_bn", "stem_bn",
                                         f0 // 2 or 1)
        p, x = x, reduction_cell("stem_r2", p, x, f0 // 2 or 1)
        filters = f0
        for stage in range(3):
            for i in range(self.numBlocks):
                p, x = x, normal_cell(f"s{stage}n{i}", p, x, filters)
            if stage < 2:
                p, x = x, reduction_cell(f"s{stage}r", p, x, filters * 2)
                filters *= 2
        g.addLayer("relu_out", ActivationLayer.Builder()
                   .activation("relu").build(), x)
        g.addLayer("gap", GlobalPoolingLayer.Builder().build(), "relu_out")
        g.addLayer("out", OutputLayer.Builder().nOut(self.numClasses)
                   .activation("softmax").lossFunction("mcxent").build(),
                   "gap")
        g.setOutputs("out")
        return g.build()


def _center_loss_head(g, model, x):
    """Global average pooling, a dense embedding, L2 normalization and a
    CenterLossOutputLayer (the face-embedding head)."""
    g.addLayer("gap", GlobalPoolingLayer.Builder().build(), x)
    g.addLayer("embedding", DenseLayer.Builder()
               .nOut(model.embeddingSize).activation("identity").build(),
               "gap")
    g.addVertex("l2norm", L2NormalizeVertex(), "embedding")
    g.addLayer("out", CenterLossOutputLayer.Builder()
               .nOut(model.numClasses).lambdaCoeff(model.lambdaCoeff)
               .activation("softmax").lossFunction("mcxent").build(),
               "l2norm")
    g.setOutputs("out")
    return g.build()


class FaceNetNN4Small2(GraphZooModel):
    """The face-embedding model trained with CenterLossOutputLayer: stem
    convs (each conv without bias + BatchNormalization and ReLU), three
    inception blocks (1x1, 3x3 and 5x5 towers and a pooled 1x1 merged),
    then the embedding and centre-loss head."""

    def __init__(self, numClasses=10, seed=123, inputShape=(3, 96, 96),
                 embeddingSize=128, lambdaCoeff=2e-4, updater=None):
        self.numClasses = numClasses
        self.seed = seed
        self.inputShape = inputShape
        self.embeddingSize = embeddingSize
        self.lambdaCoeff = lambdaCoeff
        self.updater = updater or Adam(1e-3)

    def conf(self):
        g = _graph(self)

        def conv(name, src, n, k, s=1):
            g.addLayer(name, ConvolutionLayer.Builder().nOut(n)
                       .kernelSize([k, k]).stride([s, s])
                       .convolutionMode(ConvolutionMode.SAME)
                       .activation("identity").hasBias(False).build(), src)
            g.addLayer(name + "_bn", BatchNormalization.Builder()
                       .activation("relu").build(), name)
            return name + "_bn"

        def pool(name, src, s):
            g.addLayer(name, SubsamplingLayer.Builder()
                       .kernelSize([3, 3]).stride([s, s])
                       .convolutionMode(ConvolutionMode.SAME).build(), src)
            return name

        x = pool("stem_pool", conv("stem1", "in", 64, 7, 2), 2)
        x = conv("stem3", conv("stem2", x, 64, 1), 192, 3)
        x = pool("stem_pool2", x, 2)

        def inception(tag, src, n1, r3, n3, r5, n5, np_):
            t1 = conv(f"{tag}_1x1", src, n1, 1)
            t3 = conv(f"{tag}_3x3", conv(f"{tag}_3r", src, r3, 1), n3, 3)
            t5 = conv(f"{tag}_5x5", conv(f"{tag}_5r", src, r5, 1), n5, 5)
            tp = conv(f"{tag}_poolproj", pool(f"{tag}_pool", src, 1), np_,
                      1)
            g.addVertex(f"{tag}_cat", MergeVertex(), t1, t3, t5, tp)
            return f"{tag}_cat"

        x = inception("inc1", x, 64, 96, 128, 16, 32, 32)
        x = inception("inc2", x, 64, 96, 128, 32, 64, 64)
        x = inception("inc3", pool("red_pool", x, 2), 128, 96, 192, 32, 64,
                      64)
        return _center_loss_head(g, self, x)


class InceptionResNetV1(GraphZooModel):
    """The FaceNet-class inception-resnet: a stem, ``blocksA`` residual
    inception blocks at width 128 (scaled 0.17), a strided reduction to
    256, ``blocksB`` blocks at 256 (scaled 0.1), then
    FaceNetNN4Small2's embedding and centre-loss head."""

    def __init__(self, numClasses=10, seed=123, inputShape=(3, 96, 96),
                 embeddingSize=128, blocksA=2, blocksB=2, lambdaCoeff=2e-4,
                 updater=None):
        self.numClasses = numClasses
        self.seed = seed
        self.inputShape = inputShape
        self.embeddingSize = embeddingSize
        self.blocksA = blocksA
        self.blocksB = blocksB
        self.lambdaCoeff = lambdaCoeff
        self.updater = updater or Adam(1e-3)

    def conf(self):
        g = _graph(self)

        def conv(name, src, n, k, s=1, act="relu"):
            g.addLayer(name, ConvolutionLayer.Builder().nOut(n)
                       .kernelSize([k, k]).stride([s, s])
                       .convolutionMode(ConvolutionMode.SAME)
                       .activation("identity").hasBias(False).build(), src)
            g.addLayer(name + "_bn", BatchNormalization.Builder()
                       .activation(act).build(), name)
            return name + "_bn"

        def pool(name, src):
            g.addLayer(name, SubsamplingLayer.Builder()
                       .kernelSize([3, 3]).stride([2, 2])
                       .convolutionMode(ConvolutionMode.SAME).build(), src)
            return name

        x = conv("stem3", conv("stem2", conv("stem1", "in", 32, 3, 2), 32,
                               3), 64, 3)
        x = conv("stem4", pool("stem_pool", x), 128, 1)

        def block(tag, src, width, mid, scale=0.17):
            t1 = conv(f"{tag}_1x1", src, mid, 1)
            t2 = conv(f"{tag}_3b", conv(f"{tag}_3a", src, mid, 1), mid, 3)
            g.addVertex(f"{tag}_cat", MergeVertex(), t1, t2)
            up = conv(f"{tag}_up", f"{tag}_cat", width, 1, act="identity")
            g.addVertex(f"{tag}_scale", ScaleVertex(scale), up)
            g.addVertex(f"{tag}_add", ElementWiseVertex("Add"), src,
                        f"{tag}_scale")
            g.addLayer(f"{tag}_act", ActivationLayer.Builder()
                       .activation("relu").build(), f"{tag}_add")
            return f"{tag}_act"

        for i in range(self.blocksA):
            x = block(f"ira{i}", x, 128, 32)
        x = conv("redA_proj", pool("redA_pool", x), 256, 1)
        for i in range(self.blocksB):
            x = block(f"irb{i}", x, 256, 64, scale=0.1)
        return _center_loss_head(g, self, x)
