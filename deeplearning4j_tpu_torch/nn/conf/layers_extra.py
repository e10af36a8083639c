"""Structural and specialty layers.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers_extra.py``, every
layer but ``MoELayer`` (which needs ``parallel/moe.py``): Cropping1D/2D/3D,
Upsampling1D/3D, Convolution3D and Subsampling3DLayer (the registry's
``conv3d``, ``maxPooling3d`` and ``avgPooling3d``: cuDNN's 3-D convolution
in float32 on the GPU), LocallyConnected2D/1D (patches by ``F.unfold``,
in the order of ``lax.conv_general_dilated_patches``: channel-major, then
the window's rows and columns), PReLULayer, RepeatVector,
ElementWiseMultiplicationLayer, the wrappers MaskZeroLayer and
FrozenLayer, and the output layers CenterLossOutputLayer and
OCNNOutputLayer. Same config fields, JSON and param names as the JAX
package.

A wrapper's params and state are its inner layer's (the inner layer sits
in the JSON as ``{"__layer__": {...}}``). Around an ``LSTM``, both
wrappers run the recurrence kernels on the GPU: MaskZeroLayer zeroes the
input and the output at masked steps, and FrozenLayer runs its inner layer
in inference mode (no dropout, BatchNormalization's running statistics
untouched) with gradients still flowing to the layers below, its own
params held by its ``NoOp`` updater whatever the global updater is.

Subsampling3DLayer copies SubsamplingLayer's pooling fault from the JAX
package: every pooling type but MAX averages.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.autodiff import ops
from deeplearning4j_tpu_torch.nn.activations import resolve_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import (
    Convolutional3DType, InputType)
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BaseLayer, BaseOutputLayer, ConvolutionMode, LossLayer, PoolingType,
    _pair, _register)
from deeplearning4j_tpu_torch.nn.weights import init_weight
from deeplearning4j_tpu_torch.optimize.updaters import NoOp


def _triple(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * 3


# ---------------------------------------------------------------------------
# cropping and upsampling
# ---------------------------------------------------------------------------

@_register
class Cropping1D(BaseLayer):
    """[N, C, T] -> (head, tail) timesteps cropped."""

    def __init__(self, cropping=(0, 0), **kw):
        super().__init__(**kw)
        c = cropping if isinstance(cropping, (list, tuple)) else (cropping,
                                                                  cropping)
        self.cropping = tuple(int(v) for v in c)

    def infer(self, input_type):
        t = getattr(input_type, "timeSeriesLength", None)
        if t is not None:
            t = t - self.cropping[0] - self.cropping[1]
            if t <= 0:
                raise ValueError(
                    f"Cropping1D{self.cropping} consumes the whole "
                    f"{input_type.timeSeriesLength}-step sequence")
        return InputType.recurrent(input_type.size, t)

    def apply(self, params, state, x, training=False, generator=None):
        a, bz = self.cropping
        return x[:, :, a: x.shape[2] - bz], state


@_register
class Cropping2D(BaseLayer):
    """[N, C, H, W] cropped by (top, bottom, left, right)."""

    def __init__(self, cropping=(0, 0, 0, 0), **kw):
        super().__init__(**kw)
        c = cropping
        if isinstance(c, int):
            c = (c, c, c, c)
        elif len(c) == 2:
            c = (c[0], c[0], c[1], c[1])
        self.cropping = tuple(int(v) for v in c)

    def infer(self, input_type):
        t, b, l, r = self.cropping
        oh = input_type.height - t - b
        ow = input_type.width - l - r
        if oh <= 0 or ow <= 0:
            raise ValueError(
                f"Cropping2D{self.cropping} leaves a {oh}x{ow} output for "
                f"{input_type.height}x{input_type.width} input")
        return InputType.convolutional(oh, ow, input_type.channels)

    def apply(self, params, state, x, training=False, generator=None):
        t, b, l, r = self.cropping
        return x[:, :, t: x.shape[2] - b, l: x.shape[3] - r], state


@_register
class Cropping3D(BaseLayer):
    """[N, C, D, H, W] cropped by (d1, d2, h1, h2, w1, w2)."""

    def __init__(self, cropping=(0, 0, 0, 0, 0, 0), **kw):
        super().__init__(**kw)
        c = cropping
        if isinstance(c, int):
            c = (c,) * 6
        elif len(c) == 3:
            c = (c[0], c[0], c[1], c[1], c[2], c[2])
        self.cropping = tuple(int(v) for v in c)

    def infer(self, input_type):
        d1, d2, h1, h2, w1, w2 = self.cropping
        od = input_type.depth - d1 - d2
        oh = input_type.height - h1 - h2
        ow = input_type.width - w1 - w2
        if od <= 0 or oh <= 0 or ow <= 0:
            raise ValueError(
                f"Cropping3D{self.cropping} leaves a {od}x{oh}x{ow} output")
        return InputType.convolutional3D(od, oh, ow, input_type.channels)

    def apply(self, params, state, x, training=False, generator=None):
        d1, d2, h1, h2, w1, w2 = self.cropping
        return x[:, :, d1: x.shape[2] - d2, h1: x.shape[3] - h2,
                 w1: x.shape[4] - w2], state


@_register
class Upsampling1D(BaseLayer):
    """[N, C, T] -> each timestep repeated ``size`` times."""

    def __init__(self, size=2, **kw):
        super().__init__(**kw)
        self.size = int(size)

    def infer(self, input_type):
        t = getattr(input_type, "timeSeriesLength", None)
        return InputType.recurrent(input_type.size,
                                   t * self.size if t else None)

    def apply(self, params, state, x, training=False, generator=None):
        return torch.repeat_interleave(x, self.size, dim=2), state


@_register
class Upsampling3D(BaseLayer):
    """[N, C, D, H, W] nearest-neighbour upsampling."""

    def __init__(self, size=(2, 2, 2), **kw):
        super().__init__(**kw)
        self.size = _triple(size)

    def infer(self, input_type):
        sd, sh, sw = self.size
        return InputType.convolutional3D(input_type.depth * sd,
                                         input_type.height * sh,
                                         input_type.width * sw,
                                         input_type.channels)

    def apply(self, params, state, x, training=False, generator=None):
        for axis, s in zip((2, 3, 4), self.size):
            x = torch.repeat_interleave(x, s, dim=axis)
        return x, state


# ---------------------------------------------------------------------------
# 3-D convolution and pooling (NCDHW)
# ---------------------------------------------------------------------------

@_register
class Convolution3D(BaseLayer):
    """NCDHW convolution through the registry's ``conv3d`` (cuDNN on the
    GPU); ``W`` [nOut, nIn, kD, kH, kW]."""

    def __init__(self, nIn=None, nOut=None, kernelSize=(3, 3, 3),
                 stride=(1, 1, 1), padding=(0, 0, 0), dilation=(1, 1, 1),
                 convolutionMode=None, hasBias=True, **kw):
        super().__init__(**kw)
        self.nIn = nIn
        self.nOut = nOut
        self.kernelSize = _triple(kernelSize)
        self.stride = _triple(stride)
        self.padding = _triple(padding)
        self.dilation = _triple(dilation)
        self.convolutionMode = convolutionMode or ConvolutionMode.TRUNCATE
        self.hasBias = hasBias

    def _same(self):
        return self.convolutionMode == ConvolutionMode.SAME

    def infer(self, input_type):
        if not isinstance(input_type, Convolutional3DType):
            raise ValueError(
                f"Convolution3D needs convolutional3D input, "
                f"got {input_type}")
        self.nIn = self.nIn or input_type.channels
        dims = (input_type.depth, input_type.height, input_type.width)
        out = []
        for i in range(3):
            k = (self.kernelSize[i] - 1) * self.dilation[i] + 1
            if self._same():
                out.append(-(-dims[i] // self.stride[i]))
            else:
                out.append((dims[i] + 2 * self.padding[i] - k)
                           // self.stride[i] + 1)
        return InputType.convolutional3D(out[0], out[1], out[2], self.nOut)

    def param_shapes(self):
        shapes = {"W": (self.nOut, self.nIn) + self.kernelSize}
        if self.hasBias:
            shapes["b"] = (self.nOut,)
        return shapes

    def init_params(self, generator, dtype=torch.float32, device="cpu"):
        shapes = self.param_shapes()
        k = self.kernelSize[0] * self.kernelSize[1] * self.kernelSize[2]
        p = {"W": init_weight(self.weightInit, generator, shapes["W"],
                              self.nIn * k, self.nOut * k, dtype, device)}
        if self.hasBias:
            p["b"] = torch.full(shapes["b"], float(self.biasInit),
                                dtype=dtype, device=device)
        return p

    def apply(self, params, state, x, training=False, generator=None):
        x = self._dropout(x, training, generator)
        y = ops.OPS["conv3d"](x, params["W"], params.get("b"),
                              strides=self.stride, padding=self.padding,
                              dilation=self.dilation, sameMode=self._same())
        return self._act(y), state


@_register
class Subsampling3DLayer(BaseLayer):
    """NCDHW max or average pooling through the registry's
    ``maxPooling3d`` and ``avgPooling3d``. As in the JAX package, every
    pooling type but MAX averages."""

    def __init__(self, poolingType=PoolingType.MAX, kernelSize=(2, 2, 2),
                 stride=(2, 2, 2), padding=(0, 0, 0), convolutionMode=None,
                 **kw):
        super().__init__(**kw)
        self.poolingType = poolingType
        self.kernelSize = _triple(kernelSize)
        self.stride = _triple(stride)
        self.padding = _triple(padding)
        self.convolutionMode = convolutionMode or ConvolutionMode.TRUNCATE

    def infer(self, input_type):
        dims = (input_type.depth, input_type.height, input_type.width)
        out = []
        for i in range(3):
            if self.convolutionMode == ConvolutionMode.SAME:
                out.append(-(-dims[i] // self.stride[i]))
            else:
                out.append((dims[i] + 2 * self.padding[i]
                            - self.kernelSize[i]) // self.stride[i] + 1)
        return InputType.convolutional3D(out[0], out[1], out[2],
                                         input_type.channels)

    def apply(self, params, state, x, training=False, generator=None):
        name = ("maxPooling3d" if self.poolingType == PoolingType.MAX
                else "avgPooling3d")
        y = ops.OPS[name](x, kernel=self.kernelSize, strides=self.stride,
                          padding=self.padding,
                          sameMode=self.convolutionMode == ConvolutionMode.SAME)
        return y, state


# ---------------------------------------------------------------------------
# locally connected (unshared weights)
# ---------------------------------------------------------------------------

def _local_contract(patches, w, b):
    """patches [N, K, P] against the per-position weights [P, K, O] ->
    [N, O, P], plus the bias."""
    y = torch.einsum("nkp,pko->nop", patches, w)
    if b is not None:
        y = y + b[None, :, None]
    return y


@_register
class LocallyConnected2D(BaseLayer):
    """A convolution whose weights differ at each output position: ``W``
    [oH*oW, nIn*kH*kW, nOut], ``b`` [nOut]."""

    def __init__(self, nIn=None, nOut=None, kernelSize=(2, 2),
                 stride=(1, 1), padding=(0, 0), hasBias=True,
                 inputSize=None, **kw):
        super().__init__(**kw)
        self.nIn = nIn
        self.nOut = nOut
        self.kernelSize = _pair(kernelSize)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.hasBias = hasBias
        self.inputSize = tuple(inputSize) if inputSize else None  # (H, W)

    def _out_hw(self):
        h, w = self.inputSize
        kh, kw = self.kernelSize
        sh, sw = self.stride
        ph, pw = self.padding
        return ((h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1)

    def infer(self, input_type):
        self.nIn = self.nIn or input_type.channels
        self.inputSize = (input_type.height, input_type.width)
        oh, ow = self._out_hw()
        return InputType.convolutional(oh, ow, self.nOut)

    def param_shapes(self):
        if self.inputSize is None:
            raise ValueError("LocallyConnected2D needs inputSize (H, W) "
                             "or setInputType on the config")
        kh, kw = self.kernelSize
        oh, ow = self._out_hw()
        shapes = {"W": (oh * ow, self.nIn * kh * kw, self.nOut)}
        if self.hasBias:
            shapes["b"] = (self.nOut,)
        return shapes

    def init_params(self, generator, dtype=torch.float32, device="cpu"):
        shapes = self.param_shapes()
        k = shapes["W"][1]
        p = {"W": init_weight(self.weightInit, generator, shapes["W"], k,
                              self.nOut, dtype, device)}
        if self.hasBias:
            p["b"] = torch.full(shapes["b"], float(self.biasInit),
                                dtype=dtype, device=device)
        return p

    def apply(self, params, state, x, training=False, generator=None):
        patches = F.unfold(x, self.kernelSize, padding=self.padding,
                           stride=self.stride)          # [N, C*kh*kw, P]
        oh, ow = self._out_hw()
        y = _local_contract(patches, params["W"], params.get("b"))
        return self._act(y.reshape(x.shape[0], -1, oh, ow)), state


@_register
class LocallyConnected1D(BaseLayer):
    """[N, C, T] convolution with unshared weights: ``W`` [oT, nIn*k,
    nOut], ``b`` [nOut]."""

    def __init__(self, nIn=None, nOut=None, kernelSize=2, stride=1,
                 padding=0, hasBias=True, inputSize=None, **kw):
        super().__init__(**kw)
        self.nIn = nIn
        self.nOut = nOut
        self.kernelSize = int(kernelSize)
        self.stride = int(stride)
        self.padding = int(padding)
        self.hasBias = hasBias
        self.inputSize = int(inputSize) if inputSize else None  # T

    def _out_t(self):
        return ((self.inputSize + 2 * self.padding - self.kernelSize)
                // self.stride + 1)

    def infer(self, input_type):
        self.nIn = self.nIn or input_type.size
        t = getattr(input_type, "timeSeriesLength", None)
        if t:
            self.inputSize = t
        return InputType.recurrent(self.nOut,
                                   self._out_t() if self.inputSize else None)

    def param_shapes(self):
        if self.inputSize is None:
            raise ValueError("LocallyConnected1D needs inputSize (T) or a "
                             "recurrent input type with a declared length")
        shapes = {"W": (self._out_t(), self.nIn * self.kernelSize,
                        self.nOut)}
        if self.hasBias:
            shapes["b"] = (self.nOut,)
        return shapes

    def init_params(self, generator, dtype=torch.float32, device="cpu"):
        shapes = self.param_shapes()
        k = shapes["W"][1]
        p = {"W": init_weight(self.weightInit, generator, shapes["W"], k,
                              self.nOut, dtype, device)}
        if self.hasBias:
            p["b"] = torch.full(shapes["b"], float(self.biasInit),
                                dtype=dtype, device=device)
        return p

    def apply(self, params, state, x, training=False, generator=None):
        patches = F.unfold(x[:, :, None, :], (1, self.kernelSize),
                           padding=(0, self.padding),
                           stride=(1, self.stride))     # [N, C*k, oT]
        return self._act(_local_contract(patches, params["W"],
                                         params.get("b"))), state


# ---------------------------------------------------------------------------
# small parametric and shaping layers
# ---------------------------------------------------------------------------

@_register
class PReLULayer(BaseLayer):
    """Parametric ReLU with a learned slope per channel (or feature)."""

    def __init__(self, nIn=None, alphaInit=0.0, **kw):
        super().__init__(**kw)
        self.nIn = nIn
        self.alphaInit = float(alphaInit)

    def infer(self, input_type):
        self.nIn = self.nIn or getattr(
            input_type, "channels", getattr(input_type, "size", None))
        return input_type

    def param_shapes(self):
        return {"alpha": (self.nIn,)}

    def init_params(self, generator, dtype=torch.float32, device="cpu"):
        return {"alpha": torch.full((self.nIn,), self.alphaInit,
                                    dtype=dtype, device=device)}

    def apply(self, params, state, x, training=False, generator=None):
        shape = [1] * x.dim()
        shape[1 if x.dim() > 2 else -1] = -1
        a = params["alpha"].reshape(shape)
        return torch.where(x >= 0, x, a * x), state


@_register
class RepeatVector(BaseLayer):
    """[N, C] -> [N, C, repetitionFactor]."""

    def __init__(self, repetitionFactor=2, **kw):
        super().__init__(**kw)
        self.repetitionFactor = int(repetitionFactor)

    def infer(self, input_type):
        return InputType.recurrent(input_type.size, self.repetitionFactor)

    def apply(self, params, state, x, training=False, generator=None):
        return x[:, :, None].repeat(1, 1, self.repetitionFactor), state


@_register
class ElementWiseMultiplicationLayer(BaseLayer):
    """act(x * w + b) with a learned ``w`` and ``b`` per feature."""

    def __init__(self, nIn=None, nOut=None, **kw):
        super().__init__(**kw)
        self.nIn = nIn
        self.nOut = nOut

    def infer(self, input_type):
        self.nIn = self.nIn or input_type.size
        self.nOut = self.nIn
        return InputType.feedForward(self.nIn)

    def param_shapes(self):
        return {"w": (self.nIn,), "b": (self.nIn,)}

    def init_params(self, generator, dtype=torch.float32, device="cpu"):
        return {"w": torch.ones((self.nIn,), dtype=dtype, device=device),
                "b": torch.full((self.nIn,), float(self.biasInit or 0.0),
                                dtype=dtype, device=device)}

    def apply(self, params, state, x, training=False, generator=None):
        return self._act(x * params["w"] + params["b"]), state


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

class _Wrapper(BaseLayer):
    """Params, state and shapes are the inner layer's (``_inner``)."""

    def infer(self, input_type):
        return self._inner().infer(input_type)

    def param_shapes(self):
        return self._inner().param_shapes()

    def init_params(self, generator, dtype=torch.float32, device="cpu"):
        return self._inner().init_params(generator, dtype, device)

    def init_state(self, dtype=torch.float32, device="cpu"):
        return self._inner().init_state(dtype, device)


@_register
class MaskZeroLayer(_Wrapper):
    """Masks the timesteps where every feature of the INPUT equals
    ``maskingValue``: the wrapped layer's input and output are zero
    there, so a recurrent layer's carried state never sees the
    sentinel."""

    def __init__(self, underlying=None, maskingValue=0.0, **kw):
        super().__init__(**kw)
        self.underlying = underlying
        self.maskingValue = float(maskingValue)

    def _inner(self):
        return self.underlying

    def apply_defaults(self, defaults):
        super().apply_defaults(defaults)
        if self.underlying is not None:
            self.underlying.apply_defaults(defaults)

    def apply(self, params, state, x, training=False, generator=None):
        keep = torch.any(x != self.maskingValue, dim=1,
                         keepdim=True).to(x.dtype)
        y, state = self.underlying.apply(params, state, x * keep, training,
                                         generator)
        return y * keep.to(y.dtype), state


@_register
class FrozenLayer(_Wrapper):
    """Keeps the inner layer out of training: a ``NoOp`` updater whatever
    the global updater, and inference behaviour even in ``fit`` (no
    dropout, the layer state returned unchanged)."""

    def __init__(self, layer=None, **kw):
        super().__init__(**kw)
        self.layer = layer
        self.updater = NoOp()

    def _inner(self):
        return self.layer

    def apply_defaults(self, defaults):
        d = dict(defaults)
        d.pop("updater", None)   # NoOp whatever the global updater
        super().apply_defaults(d)
        if self.layer is not None:
            self.layer.apply_defaults(d)

    def apply(self, params, state, x, training=False, generator=None):
        y, _ = self.layer.apply(params, state, x, False, None)
        return y, state


# ---------------------------------------------------------------------------
# output layers
# ---------------------------------------------------------------------------

@_register
class CenterLossOutputLayer(BaseOutputLayer):
    """Classification output plus a pull of each example's features
    toward its class centre, 0.5 * lambdaCoeff * mean |h - c_y|^2. The
    centres are parameters ([nOut, nIn]) trained by the layer's updater,
    as in the JAX package; ``alpha`` (DL4J's centre-update rate) is kept
    for the JSON and ignored, with a warning the first time it is set."""

    _warned_alpha = False

    def __init__(self, alpha=0.05, lambdaCoeff=2e-4, **kw):
        super().__init__(**kw)
        self.alpha = float(alpha)
        self.lambdaCoeff = float(lambdaCoeff)
        if alpha != 0.05 and not CenterLossOutputLayer._warned_alpha:
            warnings.warn(
                "CenterLossOutputLayer.alpha is accepted for DL4J config "
                "parity but ignored: centers train with the layer's "
                "updater, not an alpha-EMA", stacklevel=2)
            CenterLossOutputLayer._warned_alpha = True

    def param_shapes(self):
        shapes = super().param_shapes()
        shapes["centers"] = (self.nOut, self.nIn)
        return shapes

    def init_params(self, generator, dtype=torch.float32, device="cpu"):
        p = super().init_params(generator, dtype, device)
        p["centers"] = torch.zeros((self.nOut, self.nIn), dtype=dtype,
                                   device=device)
        return p

    def compute_loss(self, params, x, labels, mask=None):
        base = super().compute_loss(params, x, labels, mask)
        c = labels @ params["centers"]                 # [N, nIn]
        pull = torch.sum(torch.square(x - c), dim=-1)
        if mask is not None and mask.dim() == 1:
            pull = pull * mask
        return base + 0.5 * self.lambdaCoeff * torch.mean(pull)


@_register
class OCNNOutputLayer(LossLayer):
    """One-class neural network output for anomaly detection: the score
    y = w . act(V x); training minimizes mean(relu(q - y)) / nu - q with
    q the nu-quantile of the batch's scores (detached). The state keeps
    ``r``, the quantile smoothed over ``windowSize`` examples, as the
    inference threshold (y < r is an anomaly), and ``seen``, the steps
    so far (int32). Labels are ignored. The state rides the loss-state
    channel of ``MultiLayerNetwork._loss_from``."""

    LOSS_UPDATES_STATE = True

    def __init__(self, nIn=None, hiddenSize=10, nu=0.04, windowSize=10000,
                 activation=None, lossFunction="ocnn", **kw):
        super().__init__(lossFunction=lossFunction,
                         activation=activation or "relu", **kw)
        self.nIn = nIn
        self.hiddenSize = int(hiddenSize)
        self.nu = float(nu)
        self.windowSize = int(windowSize)

    def infer(self, input_type):
        self.nIn = self.nIn or input_type.size
        return InputType.feedForward(1)

    def param_shapes(self):
        return {"V": (self.nIn, self.hiddenSize), "w": (self.hiddenSize,)}

    def init_params(self, generator, dtype=torch.float32, device="cpu"):
        return {"V": init_weight(self.weightInit, generator,
                                 (self.nIn, self.hiddenSize), self.nIn,
                                 self.hiddenSize, dtype, device),
                "w": init_weight(self.weightInit, generator,
                                 (self.hiddenSize,), self.hiddenSize, 1,
                                 dtype, device)}

    def init_state(self, dtype=torch.float32, device="cpu"):
        return {"r": torch.zeros((), dtype=dtype, device=device),
                "seen": torch.zeros((), dtype=torch.int32, device=device)}

    def _score(self, params, x):
        return resolve_activation(self.activation)(x @ params["V"]) \
            @ params["w"]

    def apply(self, params, state, x, training=False, generator=None):
        return self._score(params, x)[:, None], state

    def _smoothed_r(self, y, state):
        """(the batch's nu-quantile q, the state with the smoothed r)."""
        q = torch.quantile(y.detach(), self.nu)
        alpha = min(1.0, y.shape[0] / max(self.windowSize, 1))
        seen = state["seen"]
        r = torch.where(seen > 0, (1.0 - alpha) * state["r"] + alpha * q, q)
        return q, {"r": r.to(state["r"].dtype), "seen": seen + 1}

    def compute_loss_with_state(self, params, x, labels, mask=None,
                                state=None):
        y = self._score(params, x)
        if not state:
            state = self.init_state(x.dtype, x.device)
        q, new_state = self._smoothed_r(y, state)
        # torch.maximum splits the gradient at a tie, as jnp.maximum does
        hinge = torch.maximum(torch.zeros_like(y), q - y)
        if mask is not None and mask.dim() == 1:
            hinge = hinge * mask
        return torch.mean(hinge) / self.nu - q, new_state

    def compute_loss(self, params, x, labels, mask=None):
        return self.compute_loss_with_state(params, x, labels, mask)[0]
