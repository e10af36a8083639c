"""Input type declarations for automatic shape inference.

A copy of ``deeplearning4j_tpu/nn/conf/inputs.py`` (plain Python, no JAX,
but importing it would import the JAX package): setInputType on the
config builder drives nIn inference, and the JSON forms are the same so
configurations move between the two packages.
"""

from __future__ import annotations

from dataclasses import dataclass


class InputType:
    @staticmethod
    def feedForward(size):
        return FeedForwardType(int(size))

    @staticmethod
    def recurrent(size, timeSeriesLength=None):
        return RecurrentType(int(size), timeSeriesLength)

    @staticmethod
    def convolutional(height, width, channels):
        return ConvolutionalType(int(height), int(width), int(channels))

    @staticmethod
    def convolutionalFlat(height, width, channels):
        return ConvolutionalFlatType(int(height), int(width), int(channels))

    @staticmethod
    def convolutional3D(depth, height, width, channels):
        return Convolutional3DType(int(depth), int(height), int(width),
                                   int(channels))

    @staticmethod
    def from_json(d):
        kinds = {
            "feedforward": lambda: FeedForwardType(d["size"]),
            "recurrent": lambda: RecurrentType(
                d["size"], d.get("timeSeriesLength")),
            "convolutional": lambda: ConvolutionalType(
                d["height"], d["width"], d["channels"]),
            "convolutionalflat": lambda: ConvolutionalFlatType(
                d["height"], d["width"], d["channels"]),
            "convolutional3d": lambda: Convolutional3DType(
                d["depth"], d["height"], d["width"], d["channels"]),
        }
        return kinds[d["kind"]]()


@dataclass
class FeedForwardType:
    size: int
    kind: str = "feedforward"

    def arrayElementsPerExample(self):
        return self.size

    def batch_shape(self, n=1):
        return (n, self.size)

    def to_json(self):
        return {"kind": self.kind, "size": self.size}


@dataclass
class RecurrentType:
    size: int
    timeSeriesLength: int | None = None
    kind: str = "recurrent"

    def arrayElementsPerExample(self):
        return self.size * (self.timeSeriesLength or 1)

    def batch_shape(self, n=1):
        # DL4J time-series layout: [N, C, T]
        return (n, self.size, self.timeSeriesLength or 1)

    def to_json(self):
        return {"kind": self.kind, "size": self.size,
                "timeSeriesLength": self.timeSeriesLength}


@dataclass
class ConvolutionalType:
    height: int
    width: int
    channels: int
    kind: str = "convolutional"

    def arrayElementsPerExample(self):
        return self.height * self.width * self.channels

    def batch_shape(self, n=1):
        return (n, self.channels, self.height, self.width)

    def to_json(self):
        return {"kind": self.kind, "height": self.height,
                "width": self.width, "channels": self.channels}


@dataclass
class Convolutional3DType:
    """Volumetric input, NCDHW layout (reference: InputType.convolutional3D
    with DataFormat.NCDHW)."""

    depth: int
    height: int
    width: int
    channels: int
    kind: str = "convolutional3d"

    def arrayElementsPerExample(self):
        return self.depth * self.height * self.width * self.channels

    def batch_shape(self, n=1):
        return (n, self.channels, self.depth, self.height, self.width)

    def to_json(self):
        return {"kind": self.kind, "depth": self.depth,
                "height": self.height, "width": self.width,
                "channels": self.channels}


@dataclass
class ConvolutionalFlatType(ConvolutionalType):
    """MNIST-style flat input that the first conv layer reshapes to NCHW."""

    kind: str = "convolutionalflat"

    def batch_shape(self, n=1):
        return (n, self.height * self.width * self.channels)
