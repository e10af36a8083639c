"""Layer configuration classes.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers.py`` for the layers the
char-RNNs and the recurrent classifiers train and serve through:
DenseLayer, EmbeddingLayer, EmbeddingSequenceLayer, LSTM, GravesLSTM, GRU,
SimpleRnn, the wrappers Bidirectional and LastTimeStep, OutputLayer and
RnnOutputLayer. As in the JAX package a layer config IS the
runtime:

    param_shapes()                          -> {name: shape}
    init_params(generator, dtype, device)   -> {name: Tensor}
    apply(params, state, x, training=False, generator=None)
                                            -> (y, new_state)
    compute_loss(params, x, labels, mask)   (output layers)

with the same config fields, JSON and param names, so a configuration or
a set of weights moves between the two packages unchanged. A wrapper's
inner layer is written into the JSON as ``{"__layer__": {...}}``, and
Bidirectional's params are the nested group ``{"fwd": {...}, "bwd":
{...}}`` (``param_shapes`` nests alike). Dropout runs
only in training and draws its mask from the ``torch.Generator`` passed
in (the JAX package draws from a threefry key, so masks are not shared).

Conventions (matching DL4J): dense inputs [N, F]; recurrent inputs and
outputs [N, C, T].
"""

from __future__ import annotations

import copy

import torch

# the module, not its names: autodiff.ops imports nn.activations, whose
# package imports this module, so the ops are looked up at call time
from deeplearning4j_tpu_torch.autodiff import ops
from deeplearning4j_tpu_torch.nn.activations import resolve_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType, RecurrentType
from deeplearning4j_tpu_torch.nn.losses import resolve_loss
from deeplearning4j_tpu_torch.nn.weights import init_weight
from deeplearning4j_tpu_torch.optimize.updaters import updater_from_config

LAYER_REGISTRY: dict = {}


def _register(cls):
    LAYER_REGISTRY[cls.__name__] = cls
    return cls


def take_rows(w, idx):
    """``w[idx]`` with the JAX package's index rule: ids (ints, or floats
    truncated toward zero) below 0 wrap once by ``len(w)``, then every id
    is clamped to [0, len(w) - 1]. A 4-row ``w`` indexed by [0, 5, -1, -7]
    gives rows 0, 3, 3, 0. No id can reach past ``w``, so a bad request
    never becomes a device-side assert on CUDA."""
    n = w.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx).clamp_(0, n - 1)
    return w[idx]


class _Builder:
    """Generic DL4J-style builder: any method call sets the same-named config
    field (e.g. .nIn(784).nOut(100).activation("relu")); build() constructs
    the layer class."""

    def __init__(self, cls, **preset):
        self._cls = cls
        self._kw = dict(preset)

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)

        def setter(*args):
            self._kw[item] = args[0] if len(args) == 1 else list(args)
            return self

        return setter

    def build(self):
        return self._cls(**self._kw)


class BaseLayer:
    """Common config fields + (de)serialization."""

    # fields every layer inherits from the NeuralNetConfiguration defaults
    # when not set explicitly
    INHERITED = ("activation", "weightInit", "biasInit", "updater", "l1",
                 "l2", "dropOut", "gradientNormalization",
                 "gradientNormalizationThreshold")

    def __init__(self, name=None, activation=None, weightInit=None,
                 biasInit=None, updater=None, l1=None, l2=None, dropOut=None,
                 gradientNormalization=None,
                 gradientNormalizationThreshold=None):
        self.name = name
        self.activation = activation
        self.weightInit = weightInit
        self.biasInit = biasInit
        self.updater = updater
        self.l1 = l1
        self.l2 = l2
        self.dropOut = dropOut
        self.gradientNormalization = gradientNormalization
        self.gradientNormalizationThreshold = gradientNormalizationThreshold

    # -- builder -------------------------------------------------------------
    class _BuilderFactory:
        def __get__(self, obj, cls):
            return lambda **kw: _Builder(cls, **kw)

    Builder = _BuilderFactory()

    def apply_defaults(self, defaults: dict):
        for f in self.INHERITED:
            if getattr(self, f, None) is None and f in defaults:
                # deep-copy so layers never share mutable config objects
                setattr(self, f, copy.deepcopy(defaults[f]))
        if self.activation is None:
            self.activation = "identity"
        if self.weightInit is None:
            self.weightInit = "xavier"
        if self.biasInit is None:
            self.biasInit = 0.0

    # -- shape / params ------------------------------------------------------
    def infer(self, input_type):
        """Set nIn-style fields from input_type; return the output type."""
        return input_type

    def param_shapes(self) -> dict:
        return {}

    def init_params(self, generator, dtype=torch.float32, device="cpu"):
        return {}

    def init_state(self, dtype=torch.float32, device="cpu") -> dict:
        return {}

    def apply(self, params, state, x, training=False, generator=None):
        return x, state

    def _dropout(self, x, training, generator):
        """Inverted dropout; ``dropOut`` is the RETAIN probability (DL4J)."""
        p = self.dropOut
        if not p or p >= 1.0 or not training or generator is None:
            return x
        keep = torch.rand(x.shape, generator=generator, device=x.device,
                          dtype=x.dtype) < p
        return torch.where(keep, x / p, torch.zeros_like(x))

    def _act(self, x):
        # softmax normalizes the CLASS axis: dim 1 in the DL4J NCW
        # time-series layout [N, C, T] (the last axis there is time)
        if x.dim() == 3 and self.activation in ("softmax", "logsoftmax"):
            fn = (torch.softmax if self.activation == "softmax"
                  else torch.log_softmax)
            return fn(x, dim=1)
        return resolve_activation(self.activation or "identity")(x)

    # -- serde ---------------------------------------------------------------
    def to_json(self):
        d = {"@class": type(self).__name__}
        for k, v in self.__dict__.items():
            if k.startswith("_") or v is None:
                continue
            if hasattr(v, "to_json"):
                v = {"__layer__": v.to_json()} if isinstance(
                    v, BaseLayer) else v.to_json()
            elif isinstance(v, tuple):
                v = list(v)
            d[k] = v
        return d

    @staticmethod
    def from_json(d):
        d = dict(d)
        name = d.pop("@class")
        if name not in LAYER_REGISTRY:
            raise NotImplementedError(
                f"layer {name} is not ported to deeplearning4j_tpu_torch yet "
                f"(ported: {sorted(LAYER_REGISTRY)})")
        for k, v in list(d.items()):
            if isinstance(v, dict) and "__layer__" in v:
                d[k] = BaseLayer.from_json(v["__layer__"])
            elif isinstance(v, dict) and "@class" in v:
                d[k] = updater_from_config(v)
        return LAYER_REGISTRY[name](**d)

    def __repr__(self):
        fields = ", ".join(f"{k}={v!r}" for k, v in self.__dict__.items()
                           if v is not None and not k.startswith("_"))
        return f"{type(self).__name__}({fields})"


# ---------------------------------------------------------------------------
# feed-forward layers
# ---------------------------------------------------------------------------

@_register
class DenseLayer(BaseLayer):
    """3-D input [N, C, T] is handled natively (per-timestep linear)."""

    def __init__(self, nIn=None, nOut=None, hasBias=True, **kw):
        super().__init__(**kw)
        self.nIn = nIn
        self.nOut = nOut
        self.hasBias = hasBias

    def infer(self, input_type):
        if isinstance(input_type, RecurrentType):
            self.nIn = self.nIn or input_type.size
            return InputType.recurrent(self.nOut, input_type.timeSeriesLength)
        self.nIn = self.nIn or input_type.arrayElementsPerExample()
        return InputType.feedForward(self.nOut)

    def param_shapes(self):
        if self.nIn is None or self.nOut is None:
            raise ValueError(
                f"{type(self).__name__} has nIn={self.nIn}, nOut={self.nOut}:"
                f" set nIn explicitly or declare setInputType on the config")
        shapes = {"W": (self.nIn, self.nOut)}
        if self.hasBias:
            shapes["b"] = (self.nOut,)
        return shapes

    def init_params(self, generator, dtype=torch.float32, device="cpu"):
        shapes = self.param_shapes()
        p = {"W": init_weight(self.weightInit, generator, shapes["W"],
                              self.nIn, self.nOut, dtype, device)}
        if self.hasBias:
            p["b"] = torch.full(shapes["b"], float(self.biasInit),
                                dtype=dtype, device=device)
        return p

    def _linear(self, params, x):
        if x.dim() == 3:  # [N, C, T]: contract the channel axis per timestep
            y = torch.einsum("nct,ch->nht", x, params["W"])
            if self.hasBias:
                y = y + params["b"][None, :, None]
            return y
        if x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        y = x @ params["W"]
        if self.hasBias:
            y = y + params["b"]
        return y

    def apply(self, params, state, x, training=False, generator=None):
        x = self._dropout(x, training, generator)
        return self._act(self._linear(params, x)), state


@_register
class EmbeddingLayer(BaseLayer):
    """Int indices [N] or [N, 1] (or one-hot [N, nIn]) -> [N, nOut]. The
    lookup is a gather; indices held as floats are cast with ``.long()``,
    where the JAX package uses ``astype(int32)``."""

    def __init__(self, nIn=None, nOut=None, hasBias=False, **kw):
        super().__init__(**kw)
        self.nIn = nIn
        self.nOut = nOut
        self.hasBias = hasBias

    def infer(self, input_type):
        self.nIn = self.nIn or input_type.arrayElementsPerExample()
        return InputType.feedForward(self.nOut)

    def param_shapes(self):
        shapes = {"W": (self.nIn, self.nOut)}
        if self.hasBias:
            shapes["b"] = (self.nOut,)
        return shapes

    def init_params(self, generator, dtype=torch.float32, device="cpu"):
        p = {"W": init_weight(self.weightInit, generator,
                              (self.nIn, self.nOut), self.nIn, self.nOut,
                              dtype, device)}
        if self.hasBias:
            p["b"] = torch.full((self.nOut,), float(self.biasInit),
                                dtype=dtype, device=device)
        return p

    def apply(self, params, state, x, training=False, generator=None):
        if x.is_floating_point() and x.dim() == 2 and \
                x.shape[-1] == self.nIn:
            y = x @ params["W"]   # one-hot path
        else:
            idx = x.long()
            if idx.dim() == 2 and idx.shape[-1] == 1:
                idx = idx[:, 0]
            y = take_rows(params["W"], idx)
        if self.hasBias:
            y = y + params["b"]
        return self._act(y), state


@_register
class EmbeddingSequenceLayer(EmbeddingLayer):
    """Token ids [N, T] or [N, 1, T] (ints, or the same ids held as floats)
    -> [N, nOut, T] (recurrent layout)."""

    def infer(self, input_type):
        if self.nIn is None and isinstance(input_type, RecurrentType):
            self.nIn = input_type.size
        t = getattr(input_type, "timeSeriesLength", None)
        return InputType.recurrent(self.nOut, t)

    def apply(self, params, state, x, training=False, generator=None):
        idx = x.long()
        if idx.dim() == 3:   # [N, 1, T]
            idx = idx[:, 0, :]
        y = take_rows(params["W"], idx)   # [N, T, nOut]
        if self.hasBias:
            y = y + params["b"]
        return self._act(y.permute(0, 2, 1)), state   # [N, nOut, T]


# ---------------------------------------------------------------------------
# recurrent layers
# ---------------------------------------------------------------------------

@_register
class LSTM(BaseLayer):
    """The recurrence runs in ``autodiff.ops.lstmLayer`` (the hand-written
    CUDA kernel on the GPU). Input/output layout [N, C, T]."""

    IS_RECURRENT = True

    def __init__(self, nIn=None, nOut=None, forgetGateBiasInit=1.0, **kw):
        super().__init__(**kw)
        self.nIn = nIn
        self.nOut = nOut
        self.forgetGateBiasInit = forgetGateBiasInit
        if self.activation is None:
            self.activation = "tanh"

    def infer(self, input_type):
        self.nIn = self.nIn or input_type.size
        t = getattr(input_type, "timeSeriesLength", None)
        return InputType.recurrent(self.nOut, t)

    def param_shapes(self):
        h = self.nOut
        return {"W": (self.nIn, 4 * h), "R": (h, 4 * h), "b": (4 * h,)}

    def init_params(self, generator, dtype=torch.float32, device="cpu"):
        shapes = self.param_shapes()
        h = self.nOut
        return {
            "W": init_weight(self.weightInit, generator, shapes["W"],
                             self.nIn, h, dtype, device),
            "R": init_weight(self.weightInit, generator, shapes["R"], h, h,
                             dtype, device),
            "b": torch.zeros(shapes["b"], dtype=dtype, device=device),
        }

    def apply(self, params, state, x, training=False, generator=None):
        """When `state` carries {"h","c"} (streaming rnnTimeStep or a TBPTT
        segment), the recurrence starts from it and the updated state is
        returned; otherwise it starts from zeros and the state passes
        through."""
        x = self._dropout(x, training, generator)
        h0 = state.get("h") if isinstance(state, dict) else None
        c0 = state.get("c") if isinstance(state, dict) else None
        out, hT, cT = ops.lstmLayer(
            x, params["W"], params["R"], params["b"], h0=h0, c0=c0,
            forgetBias=self.forgetGateBiasInit)
        if h0 is not None:
            return out, {"h": hT, "c": cT}
        return out, state

    def streaming_state(self, batch_size, dtype=torch.float32, device="cpu"):
        """Zero carried state for rnnTimeStep."""
        h = torch.zeros((batch_size, self.nOut), dtype=dtype, device=device)
        return {"h": h, "c": torch.zeros_like(h)}


@_register
class GravesLSTM(LSTM):
    """Kept for config parity; peephole connections are dropped, as in the
    JAX package."""


@_register
class GRU(BaseLayer):
    """Gated recurrent unit; the recurrence runs in
    ``autodiff.ops.gruLayer``. resetAfter=False (the default, the classic
    Cho et al. reset-before form, b of 3H) runs a plain loop; True is the
    cuDNN/Keras-v2 convention (b holds [3H input || 3H recurrent]), which
    runs the hand-written CUDA kernels on the GPU. Input/output layout
    [N, C, T]."""

    IS_RECURRENT = True

    def __init__(self, nIn=None, nOut=None, resetAfter=False, **kw):
        super().__init__(**kw)
        self.nIn = nIn
        self.nOut = nOut
        self.resetAfter = resetAfter
        if self.activation is None:
            self.activation = "tanh"

    def infer(self, input_type):
        self.nIn = self.nIn or input_type.size
        t = getattr(input_type, "timeSeriesLength", None)
        return InputType.recurrent(self.nOut, t)

    def param_shapes(self):
        h = self.nOut
        nb = 6 * h if self.resetAfter else 3 * h
        return {"W": (self.nIn, 3 * h), "R": (h, 3 * h), "b": (nb,)}

    def init_params(self, generator, dtype=torch.float32, device="cpu"):
        shapes = self.param_shapes()
        h = self.nOut
        return {
            "W": init_weight(self.weightInit, generator, shapes["W"],
                             self.nIn, h, dtype, device),
            "R": init_weight(self.weightInit, generator, shapes["R"], h, h,
                             dtype, device),
            "b": torch.zeros(shapes["b"], dtype=dtype, device=device),
        }

    def apply(self, params, state, x, training=False, generator=None):
        """As ``LSTM.apply``, with the carried state {"h"}."""
        x = self._dropout(x, training, generator)
        h0 = state.get("h") if isinstance(state, dict) else None
        out, hT = ops.gruLayer(x, params["W"], params["R"], params["b"],
                               h0=h0, resetAfter=self.resetAfter,
                               activation=self.activation)
        if h0 is not None:
            return out, {"h": hT}
        return out, state

    def streaming_state(self, batch_size, dtype=torch.float32, device="cpu"):
        """Zero carried state for rnnTimeStep."""
        return {"h": torch.zeros((batch_size, self.nOut), dtype=dtype,
                                 device=device)}


@_register
class SimpleRnn(BaseLayer):
    """Elman recurrence h_t = act(x_t W + h_{t-1} R + b), in
    ``autodiff.ops.simpleRnnLayer`` (plain PyTorch: the JAX package runs it
    as a ``lax.scan`` with no Pallas kernel). No dropout, as there."""

    IS_RECURRENT = True

    def __init__(self, nIn=None, nOut=None, **kw):
        super().__init__(**kw)
        self.nIn = nIn
        self.nOut = nOut
        if self.activation is None:
            self.activation = "tanh"

    def infer(self, input_type):
        self.nIn = self.nIn or input_type.size
        t = getattr(input_type, "timeSeriesLength", None)
        return InputType.recurrent(self.nOut, t)

    def param_shapes(self):
        return {"W": (self.nIn, self.nOut), "R": (self.nOut, self.nOut),
                "b": (self.nOut,)}

    def init_params(self, generator, dtype=torch.float32, device="cpu"):
        return {
            "W": init_weight(self.weightInit, generator,
                             (self.nIn, self.nOut), self.nIn, self.nOut,
                             dtype, device),
            "R": init_weight(self.weightInit, generator,
                             (self.nOut, self.nOut), self.nOut, self.nOut,
                             dtype, device),
            "b": torch.zeros((self.nOut,), dtype=dtype, device=device),
        }

    def apply(self, params, state, x, training=False, generator=None):
        """As ``LSTM.apply``, with the carried state {"h"}."""
        h0 = state.get("h") if isinstance(state, dict) else None
        out, hT = ops.simpleRnnLayer(x, params["W"], params["R"],
                                     params["b"], h0=h0,
                                     activation=self.activation)
        if h0 is not None:
            return out, {"h": hT}
        return out, state

    def streaming_state(self, batch_size, dtype=torch.float32, device="cpu"):
        """Zero carried state for rnnTimeStep."""
        return {"h": torch.zeros((batch_size, self.nOut), dtype=dtype,
                                 device=device)}


@_register
class Bidirectional(BaseLayer):
    """Wrapper running the inner layer forward and on the time-reversed
    input (modes CONCAT/ADD/AVERAGE/MUL). Params ``{"fwd": {...}, "bwd":
    {...}}``, each the inner layer's. Each direction starts from zero
    state; the layer consumes the whole sequence, so the network refuses
    rnnTimeStep and TBPTT through it."""

    CONCAT, ADD, AVERAGE, MUL = "concat", "add", "average", "mul"

    def __init__(self, rnn=None, mode="concat", **kw):
        super().__init__(**kw)
        self.rnn = rnn
        self.mode = mode

    def apply_defaults(self, defaults):
        super().apply_defaults(defaults)
        self.rnn.apply_defaults(defaults)

    def infer(self, input_type):
        out = self.rnn.infer(input_type)
        size = out.size * 2 if self.mode == self.CONCAT else out.size
        return InputType.recurrent(size, getattr(out, "timeSeriesLength",
                                                 None))

    def param_shapes(self):
        return {"fwd": self.rnn.param_shapes(),
                "bwd": self.rnn.param_shapes()}

    def init_params(self, generator, dtype=torch.float32, device="cpu"):
        return {"fwd": self.rnn.init_params(generator, dtype, device),
                "bwd": self.rnn.init_params(generator, dtype, device)}

    def apply(self, params, state, x, training=False, generator=None):
        yf, _ = self.rnn.apply(params["fwd"], {}, x, training, generator)
        yb, _ = self.rnn.apply(params["bwd"], {}, torch.flip(x, dims=[2]),
                               training, generator)
        yb = torch.flip(yb, dims=[2])
        if self.mode == self.CONCAT:
            return torch.cat([yf, yb], dim=1), state
        if self.mode == self.ADD:
            return yf + yb, state
        if self.mode == self.MUL:
            return yf * yb, state
        return (yf + yb) / 2.0, state


@_register
class LastTimeStep(BaseLayer):
    """Wrapper: [N, C, T] -> [N, C], the inner layer's output at the last
    timestep. Params and state are the inner layer's."""

    def __init__(self, rnn=None, **kw):
        super().__init__(**kw)
        self.rnn = rnn

    def apply_defaults(self, defaults):
        super().apply_defaults(defaults)
        if self.rnn is not None:
            self.rnn.apply_defaults(defaults)

    def infer(self, input_type):
        out = self.rnn.infer(input_type)
        return InputType.feedForward(out.size)

    def param_shapes(self):
        return self.rnn.param_shapes()

    def init_params(self, generator, dtype=torch.float32, device="cpu"):
        return self.rnn.init_params(generator, dtype, device)

    def init_state(self, dtype=torch.float32, device="cpu"):
        return self.rnn.init_state(dtype, device)

    def apply(self, params, state, x, training=False, generator=None):
        y, state = self.rnn.apply(params, state, x, training, generator)
        return y[..., -1], state


# ---------------------------------------------------------------------------
# output layers
# ---------------------------------------------------------------------------

class BaseOutputLayer(DenseLayer):
    def __init__(self, lossFunction="mcxent", **kw):
        super().__init__(**kw)
        self.lossFunction = lossFunction
        # remember whether the user set the activation explicitly so a
        # global .activation(...) default can propagate (DL4J semantics:
        # softmax is the fallback only when NO global default exists)
        self._explicit_activation = self.activation is not None
        if self.activation is None:
            self.activation = "softmax"

    def apply_defaults(self, defaults):
        if (not getattr(self, "_explicit_activation", True)
                and defaults.get("activation") is not None):
            self.activation = defaults["activation"]
        super().apply_defaults(defaults)

    def pre_output(self, params, x):
        return self._linear(params, x)

    def compute_loss(self, params, x, labels, mask=None):
        """The loss from the pre-activation (the fused, stable form)."""
        pre = self.pre_output(params, x)
        return resolve_loss(self.lossFunction)(
            labels, pre, self.activation, mask)


@_register
class OutputLayer(BaseOutputLayer):
    """Dense + loss."""


@_register
class RnnOutputLayer(BaseOutputLayer):
    """Per-timestep output over [N, C, T]."""

    def infer(self, input_type):
        self.nIn = self.nIn or input_type.size
        return InputType.recurrent(self.nOut,
                                   getattr(input_type, "timeSeriesLength",
                                           None))

    def apply(self, params, state, x, training=False, generator=None):
        return self._act(self._linear(params, x)), state


OUTPUT_LAYER_TYPES = (BaseOutputLayer,)
