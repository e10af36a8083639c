"""Attention layers over recurrent activations, and AttentionVertex.

Counterpart of ``deeplearning4j_tpu/nn/conf/attention.py``:
SelfAttentionLayer, LearnedSelfAttentionLayer, RecurrentAttentionLayer
and the graph node AttentionVertex, with the same config fields, JSON and
param names. Activations are DL4J time series [N, C, T]; the attention
runs in [N, T, C] through the registry's ``dotProductAttention`` and
``multiHeadDotProductAttention``, plain PyTorch ops as the JAX package's
are XLA. RecurrentAttentionLayer's ``lax.scan`` is a Python loop over
the timesteps.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.autodiff import ops
from deeplearning4j_tpu_torch.nn.activations import resolve_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import BaseLayer, _register
from deeplearning4j_tpu_torch.nn.weights import init_weight


def _mh_shapes(n_in, proj, n_out):
    return {"Wq": (n_in, proj), "Wk": (n_in, proj), "Wv": (n_in, proj),
            "Wo": (proj, n_out)}


def _draw(layer, shapes, generator, dtype, device):
    """Each param of ``shapes`` by the layer's weight init, fan-in and
    fan-out from its two dims."""
    return {k: init_weight(layer.weightInit, generator, s, s[0], s[-1],
                           dtype, device) for k, s in shapes.items()}


def _head_size(layer, n_in):
    """nOut (with projections) and headSize as the JAX package infers
    them."""
    if not layer.projectInput:
        if layer.nHeads != 1:
            raise ValueError("projectInput=False requires nHeads=1")
        layer.nOut = n_in
    elif layer.nOut is None:
        raise ValueError(f"{type(layer).__name__} needs nOut when "
                         f"projectInput=True")
    if layer.headSize is None:
        if layer.projectInput and layer.nOut % layer.nHeads:
            raise ValueError(
                f"nOut={layer.nOut} not divisible by nHeads="
                f"{layer.nHeads}: set headSize explicitly")
        layer.headSize = (layer.nOut // layer.nHeads if layer.projectInput
                          else n_in)


def _attend(layer, params, q, k, v):
    """[N, Tq, C] queries over [N, T, C] keys and values: multi-head with
    the layer's projections, or single-head on the raw inputs."""
    if layer.projectInput:
        return ops.OPS["multiHeadDotProductAttention"](
            q, k, v, params["Wq"], params["Wk"], params["Wv"],
            params["Wo"], numHeads=layer.nHeads)
    return ops.OPS["dotProductAttention"](q, k, v)


@_register
class SelfAttentionLayer(BaseLayer):
    """Multi-head dot-product self attention: every timestep attends over
    the whole sequence. projectInput=False runs single-head attention on
    the raw input (nOut = nIn)."""

    def __init__(self, nIn=None, nOut=None, nHeads=1, headSize=None,
                 projectInput=True, **kw):
        super().__init__(**kw)
        self.nIn = nIn
        self.nOut = nOut
        self.nHeads = int(nHeads)
        self.headSize = headSize
        self.projectInput = projectInput

    def infer(self, input_type):
        self.nIn = self.nIn or input_type.size
        _head_size(self, self.nIn)
        return InputType.recurrent(
            self.nOut, getattr(input_type, "timeSeriesLength", None))

    def param_shapes(self):
        if not self.projectInput:
            return {}
        return _mh_shapes(self.nIn, self.nHeads * self.headSize, self.nOut)

    def init_params(self, generator, dtype=torch.float32, device="cpu"):
        return _draw(self, self.param_shapes(), generator, dtype, device)

    def apply(self, params, state, x, training=False, generator=None):
        xt = x.transpose(1, 2)                   # [N, T, C]
        y = _attend(self, params, xt, xt, xt)
        # the activation after the swap back: _act's softmax takes the
        # class axis of [N, C, T]
        return self._act(y.transpose(1, 2)), state


@_register
class LearnedSelfAttentionLayer(BaseLayer):
    """Attention with LEARNED queries ``Q`` [nQueries, nIn]: a sequence of
    any length pooled to nQueries steps."""

    def __init__(self, nIn=None, nOut=None, nHeads=1, headSize=None,
                 nQueries=1, projectInput=True, **kw):
        super().__init__(**kw)
        self.nIn = nIn
        self.nOut = nOut
        self.nHeads = int(nHeads)
        self.headSize = headSize
        self.nQueries = int(nQueries)
        self.projectInput = projectInput

    def infer(self, input_type):
        self.nIn = self.nIn or input_type.size
        _head_size(self, self.nIn)
        return InputType.recurrent(self.nOut, self.nQueries)

    def param_shapes(self):
        shapes = ({} if not self.projectInput else _mh_shapes(
            self.nIn, self.nHeads * self.headSize, self.nOut))
        shapes["Q"] = (self.nQueries, self.nIn)
        return shapes

    def init_params(self, generator, dtype=torch.float32, device="cpu"):
        shapes = self.param_shapes()
        q = shapes.pop("Q")
        p = _draw(self, shapes, generator, dtype, device)
        # fan-in nIn, fan-out nQueries, as in the JAX package
        p["Q"] = init_weight(self.weightInit, generator, q, self.nIn,
                             self.nQueries, dtype, device)
        return p

    def apply(self, params, state, x, training=False, generator=None):
        xt = x.transpose(1, 2)
        q = params["Q"].expand((xt.shape[0],) + tuple(params["Q"].shape))
        return self._act(_attend(self, params, q, xt, xt).transpose(1, 2)), \
            state


@_register
class RecurrentAttentionLayer(BaseLayer):
    """A recurrent cell whose step input is augmented with an attention
    readout over the WHOLE input sequence, queried by the previous hidden
    state: h_t = act(x_t W + a_t A + h_{t-1} R + b), a_t = attention of
    h_{t-1} Wq over the input. A loop over the timesteps."""

    IS_RECURRENT = True

    def __init__(self, nIn=None, nOut=None, **kw):
        super().__init__(**kw)
        self.nIn = nIn
        self.nOut = nOut
        if self.activation is None:
            self.activation = "tanh"

    def infer(self, input_type):
        self.nIn = self.nIn or input_type.size
        return InputType.recurrent(
            self.nOut, getattr(input_type, "timeSeriesLength", None))

    def param_shapes(self):
        i, o = self.nIn, self.nOut
        return {"W": (i, o), "R": (o, o), "A": (i, o), "Wq": (o, i),
                "b": (o,)}

    def init_params(self, generator, dtype=torch.float32, device="cpu"):
        shapes = self.param_shapes()
        shapes.pop("b")
        p = _draw(self, shapes, generator, dtype, device)
        p["b"] = torch.zeros((self.nOut,), dtype=dtype, device=device)
        return p

    def apply(self, params, state, x, training=False, generator=None):
        act = resolve_activation(self.activation)
        xt = x.transpose(1, 2)                   # [N, T, C]
        carried = isinstance(state, dict) and bool(state)
        h = state.get("h") if carried else None
        if h is None:
            h = torch.zeros((xt.shape[0], self.nOut), dtype=xt.dtype,
                            device=xt.device)
        hs = []
        for t in range(xt.shape[1]):
            q = (h @ params["Wq"])[:, None, :]   # [N, 1, C]
            a = ops.OPS["dotProductAttention"](q, xt, xt)[:, 0]
            h = act(xt[:, t] @ params["W"] + a @ params["A"]
                    + h @ params["R"] + params["b"])
            hs.append(h)
        y = torch.stack(hs, dim=2)               # [N, nOut, T]
        return (y, {"h": h}) if carried else (y, state)

    def streaming_state(self, batch_size, dtype=torch.float32, device="cpu"):
        """Zero carried state for rnnTimeStep."""
        return {"h": torch.zeros((batch_size, self.nOut), dtype=dtype,
                                 device=device)}


@_register
class AttentionVertex(BaseLayer):
    """Graph node: multi-head attention over separate (queries, keys,
    values) inputs, a parameterized MULTI-input node (the graph feeds it
    the list of its inputs; one input attends over itself, two take keys
    and values from the second)."""

    MULTI_INPUT = True

    def __init__(self, nInQueries=None, nInKeys=None, nInValues=None,
                 nOut=None, nHeads=1, headSize=None, projectInput=True,
                 **kw):
        super().__init__(**kw)
        self.nInQueries = nInQueries
        self.nInKeys = nInKeys
        self.nInValues = nInValues
        self.nOut = nOut
        self.nHeads = int(nHeads)
        self.headSize = headSize
        self.projectInput = projectInput

    def infer(self, *input_types):
        tq = input_types[0]
        self.nInQueries = self.nInQueries or tq.size
        if len(input_types) > 1:
            self.nInKeys = self.nInKeys or input_types[1].size
            self.nInValues = self.nInValues or input_types[-1].size
        else:
            self.nInKeys = self.nInKeys or self.nInQueries
            self.nInValues = self.nInValues or self.nInQueries
        if not self.projectInput:
            if self.nHeads != 1:
                raise ValueError(
                    "AttentionVertex: projectInput=False requires "
                    f"nHeads=1 (got nHeads={self.nHeads}); without "
                    "projections the single-head dotProductAttention "
                    "path is used")
            self.nOut = self.nInValues
        if self.headSize is None:
            self.headSize = (self.nOut // self.nHeads if self.projectInput
                             else self.nInKeys)
        return InputType.recurrent(
            self.nOut, getattr(tq, "timeSeriesLength", None))

    def param_shapes(self):
        if not self.projectInput:
            return {}
        proj = self.nHeads * self.headSize
        return {"Wq": (self.nInQueries, proj), "Wk": (self.nInKeys, proj),
                "Wv": (self.nInValues, proj), "Wo": (proj, self.nOut)}

    def init_params(self, generator, dtype=torch.float32, device="cpu"):
        return _draw(self, self.param_shapes(), generator, dtype, device)

    def apply(self, params, state, xs, training=False, generator=None):
        if not isinstance(xs, (list, tuple)):
            xs = [xs]
        q = xs[0].transpose(1, 2)
        k = xs[1].transpose(1, 2) if len(xs) > 1 else q
        v = xs[2].transpose(1, 2) if len(xs) > 2 else k
        return self._act(_attend(self, params, q, k, v).transpose(1, 2)), \
            state
