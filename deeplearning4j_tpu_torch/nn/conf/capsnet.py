"""CapsNet layers: dynamic routing between capsules.

Counterpart of ``deeplearning4j_tpu/nn/conf/capsnet.py``: PrimaryCapsules,
CapsuleLayer and CapsuleStrengthLayer, with ``_squash``, the same config
fields, JSON and param names. The routing's ``lax.fori_loop`` is a Python
loop over ``routings - 1`` iterations, every one differentiated through.
Capsule activations are [N, capsules, capsuleDimensions], typed as
``InputType.recurrent(capsules, capsuleDimensions)``.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.autodiff import ops
from deeplearning4j_tpu_torch.nn.conf.inputs import (
    ConvolutionalType, InputType)
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BaseLayer, _pair, _register)
from deeplearning4j_tpu_torch.nn.weights import init_weight


def _squash(s, axis=-1, eps=1e-7):
    """v = |s|^2 / (1 + |s|^2) * s / |s|."""
    sq = torch.sum(torch.square(s), dim=axis, keepdim=True)
    return (sq / (1.0 + sq)) * s / torch.sqrt(sq + eps)


@_register
class PrimaryCapsules(BaseLayer):
    """Conv feature maps -> primary capsules: a conv with
    channels*capsuleDimensions filters (the registry's ``conv2d``),
    reshaped to [N, channels*H*W, capsuleDimensions] and squashed."""

    def __init__(self, nIn=None, capsuleDimensions=8, channels=32,
                 kernelSize=(9, 9), stride=(2, 2), hasBias=True, **kw):
        super().__init__(**kw)
        self.nIn = nIn
        self.capsuleDimensions = int(capsuleDimensions)
        self.channels = int(channels)
        self.kernelSize = _pair(kernelSize)
        self.stride = _pair(stride)
        self.hasBias = hasBias

    def infer(self, input_type):
        if not isinstance(input_type, ConvolutionalType):
            raise ValueError(
                f"PrimaryCapsules needs convolutional input, "
                f"got {input_type}")
        self.nIn = self.nIn or input_type.channels
        kh, kw = self.kernelSize
        sh, sw = self.stride
        oh = (input_type.height - kh) // sh + 1
        ow = (input_type.width - kw) // sw + 1
        return InputType.recurrent(self.channels * oh * ow,
                                   self.capsuleDimensions)

    def param_shapes(self):
        n_out = self.channels * self.capsuleDimensions
        shapes = {"W": (n_out, self.nIn) + self.kernelSize}
        if self.hasBias:
            shapes["b"] = (n_out,)
        return shapes

    def init_params(self, generator, dtype=torch.float32, device="cpu"):
        shapes = self.param_shapes()
        kh, kw = self.kernelSize
        n_out = shapes["W"][0]
        p = {"W": init_weight(self.weightInit, generator, shapes["W"],
                              self.nIn * kh * kw, n_out * kh * kw, dtype,
                              device)}
        if self.hasBias:
            p["b"] = torch.full((n_out,), float(self.biasInit), dtype=dtype,
                                device=device)
        return p

    def apply(self, params, state, x, training=False, generator=None):
        y = ops.OPS["conv2d"](x, params["W"], params.get("b"),
                              strides=self.stride, padding=(0, 0))
        n = y.shape[0]
        # [N, channels*capsDim, H, W] -> [N, channels*H*W, capsDim]
        y = y.reshape(n, self.channels, self.capsuleDimensions, -1)
        y = y.permute(0, 1, 3, 2).reshape(n, -1, self.capsuleDimensions)
        return _squash(y), state


@_register
class CapsuleLayer(BaseLayer):
    """Fully connected capsules with dynamic routing: ``W`` [inCaps,
    capsules, capsuleDimensions, inputCapsuleDimensions]."""

    def __init__(self, nIn=None, inputCapsuleDimensions=None, capsules=10,
                 capsuleDimensions=16, routings=3, **kw):
        super().__init__(**kw)
        self.nIn = nIn                       # input capsule COUNT
        self.inputCapsuleDimensions = inputCapsuleDimensions
        self.capsules = int(capsules)
        self.capsuleDimensions = int(capsuleDimensions)
        self.routings = int(routings)

    def infer(self, input_type):
        self.nIn = self.nIn or input_type.size
        t = getattr(input_type, "timeSeriesLength", None)
        self.inputCapsuleDimensions = self.inputCapsuleDimensions or t
        if self.inputCapsuleDimensions is None:
            raise ValueError(
                "CapsuleLayer needs inputCapsuleDimensions (the input "
                "type's capsule dimension was undeclared)")
        return InputType.recurrent(self.capsules, self.capsuleDimensions)

    def param_shapes(self):
        return {"W": (self.nIn, self.capsules, self.capsuleDimensions,
                      self.inputCapsuleDimensions)}

    def init_params(self, generator, dtype=torch.float32, device="cpu"):
        return {"W": init_weight(self.weightInit, generator,
                                 self.param_shapes()["W"],
                                 self.inputCapsuleDimensions,
                                 self.capsuleDimensions, dtype, device)}

    def apply(self, params, state, x, training=False, generator=None):
        # x: [N, inCaps, inDim]; u_hat[n,i,j,:] = W[i,j] @ x[n,i]
        u_hat = torch.einsum("ijdk,nik->nijd", params["W"], x)
        n, i, j, _ = u_hat.shape
        b = torch.zeros((n, i, j), dtype=u_hat.dtype, device=u_hat.device)
        for _ in range(self.routings - 1):
            c = torch.softmax(b, dim=2)[..., None]   # over output capsules
            v = _squash(torch.sum(c * u_hat, dim=1))  # [N, j, d]
            b = b + torch.einsum("nijd,njd->nij", u_hat, v)
        c = torch.softmax(b, dim=2)[..., None]
        return _squash(torch.sum(c * u_hat, dim=1)), state


@_register
class CapsuleStrengthLayer(BaseLayer):
    """[N, caps, capsDim] -> each capsule's length [N, caps]."""

    def infer(self, input_type):
        return InputType.feedForward(input_type.size)

    def apply(self, params, state, x, training=False, generator=None):
        return torch.sqrt(torch.sum(torch.square(x), dim=-1) + 1e-9), state
