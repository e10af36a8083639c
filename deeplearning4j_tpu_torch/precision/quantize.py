"""Int8 post-training quantization for serving.

Counterpart of ``deeplearning4j_tpu/precision/quantize.py``.
``quantize(net, calibration_batches)`` snapshots a trained
MultiLayerNetwork's dense weight matrices as int8 with per-output-channel
scales (symmetric absmax), keeps biases, every other parameter and
embedding tables (found by layer class; more with ``skip_layers=``) in
float, runs the activations in ``compute_dtype`` (bfloat16 unless named),
and returns a ``QuantizedServable`` that registers, warms and batches
through ModelRegistry, DynamicBatcher and InferenceSession unchanged.

The int8 payload and the scales live on the servable's device ("cuda"
unless the caller names another) as ``torch.int8`` and float32 tensors;
dequantization, ``(q.float() * scale).to(compute_dtype)``, runs inside
the servable's inference function next to the product it feeds. The
payload and scales are computed on the host in numpy exactly as the JAX
package computes them, so both packages give the same int8 bits.

Calibration records ``activation_absmax`` (per layer, per channel) and
``calibration_max_err``, the largest absolute difference between the
float network's output and the servable's over the calibration batches
(0.05 is the bar at MNIST scale).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend import resolve_device, torch_dtype
from deeplearning4j_tpu_torch.serving.servable import Servable, _model_dtype
from deeplearning4j_tpu_torch.tree_util import tree_leaves, tree_map

_EPS = 1e-12


def _is_qleaf(x):
    return isinstance(x, tuple) and len(x) == 2


def _host(w) -> np.ndarray:
    """An array, tensor or INDArray as float32 numpy (bfloat16 exactly)."""
    if hasattr(w, "torch"):
        w = w.torch()
    if isinstance(w, torch.Tensor):
        return w.detach().float().cpu().numpy()
    return np.asarray(w, np.float32)


def quantize_array(w) -> tuple:
    """Symmetric per-output-channel int8 quantization of a 2-D weight
    [in, out]: scale[c] = absmax(w[:, c]) / 127. Returns (q_int8,
    scale_f32) as numpy."""
    w = _host(w)
    absmax = np.maximum(np.abs(w).max(axis=0), _EPS)
    scale = (absmax / 127.0).astype(np.float32)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_array(q, scale, compute_dtype):
    """int8 times scale in float32, then down to ``compute_dtype``."""
    return (q.float() * scale).to(torch_dtype(compute_dtype))


def quantize_params(params, skip_layers=(), device="cpu"):
    """Per-layer params -> the same structure on ``device``, each 2-D float
    leaf replaced by an (int8, scale) pair of tensors; conv kernels,
    biases and vectors go through as copies (weight-only dense
    quantization), and so does every leaf of a layer in ``skip_layers``
    (embedding tables: ``quantize`` finds them)."""
    def one(v):
        if v.dim() == 2 and v.is_floating_point():
            q, scale = quantize_array(v)
            return (torch.from_numpy(q).to(device),
                    torch.from_numpy(scale).to(device))
        return v.detach().to(device, copy=True)

    return [tree_map(lambda v: v.detach().to(device, copy=True), p)
            if i in skip_layers else tree_map(one, p)
            for i, p in enumerate(params)]


def _dequant_tree(qparams, compute_dtype):
    """Per-layer qparams -> plain param dicts; (int8, scale) pairs
    dequantize, float leaves (biases stay float32) go through."""
    def one(p):
        if isinstance(p, dict):
            return {k: one(v) for k, v in p.items()}
        return dequantize_array(*p, compute_dtype) if _is_qleaf(p) else p

    return [one(p) for p in qparams]


def _promoted(params, x):
    """A layer's float input and its weight matrices and kernels (leaves
    of two or more dimensions) in the dtype that JAX's type promotion
    gives them; biases and other vectors stay as they are, and PyTorch's
    promotion of the sums they enter is JAX's for these dtypes. So a
    dense layer after a bfloat16 one (whose float32 bias made its output
    float32) multiplies in float32 with the dequantized weights upcast,
    as in the JAX package's servable, and a conv kernel left in float32
    takes a bfloat16 input to float32 (where the JAX package refuses the
    mixed convolution)."""
    if not x.is_floating_point():
        return params, x
    dt = functools.reduce(torch.promote_types, (
        v.dtype for v in tree_leaves(params)
        if v.is_floating_point() and v.dim() >= 2), x.dtype)
    return tree_map(lambda v: v.to(dt) if v.is_floating_point()
                    and v.dim() >= 2 else v, params), x.to(dt)


def _payload_leaves(qparams):
    """The leaves of qparams with each (int8, scale) pair as one leaf."""
    for p in qparams:
        stack = [p]
        while stack:
            node = stack.pop()
            if isinstance(node, dict):
                stack.extend(node[k] for k in sorted(node, reverse=True))
            elif node is not None:
                yield node


def quantized_bytes(qparams) -> dict:
    """{'int8': n, 'float': n}: the payload's bytes, for describe()."""
    int8 = flt = 0
    for leaf in _payload_leaves(qparams):
        if _is_qleaf(leaf):
            q, s = leaf
            int8 += q.numel()
            flt += s.numel() * 4
        else:
            flt += leaf.numel() * leaf.element_size()
    return {"int8": int(int8), "float": int(flt)}


class QuantizedServable(Servable):
    """A frozen int8 snapshot of a MultiLayerNetwork, served through the
    standard Servable contract.

    The weights and the layer states (BatchNormalization's running
    statistics, ...) are a snapshot: training the source net afterwards
    does not change the servable (quantize again to refresh). Only the
    layer and preprocessor structure is kept, never the net object, so
    dropping the net after ``quantize`` frees its float32 masters and
    updater state. The host boundary is the net's: float32 in and out for
    a float32 or bfloat16 output (numpy has no bfloat16 without
    ml_dtypes)."""

    shape_evaluable = True

    def __init__(self, net, example_shape, dtype=None,
                 compute_dtype="bfloat16", skip_layers=(), device=None):
        device = resolve_device(device)
        net._check_init()
        super().__init__(example_shape, device,
                         _model_dtype(net) if dtype is None else dtype)
        # structure only: layer config objects and the preprocessor list
        # carry no parameters
        self._layers = list(net.layers)
        self._preprocessors = list(net.conf.preprocessors)
        self.compute_dtype = torch_dtype(compute_dtype)
        self.output_dtype = net.conf.precision_policy.output_torch
        skip = set(skip_layers) | {
            i for i, lr in enumerate(self._layers)
            if "Embedding" in type(lr).__name__}
        self._qparams = quantize_params(net._params, skip, device)
        self._qstates = [tree_map(lambda v: v.detach().to(device, copy=True),
                                  s) for s in net._states]
        self.calibration_max_err = None
        self.activation_absmax = None

    def _run(self, qparams, states, x):
        from deeplearning4j_tpu_torch.nn.conf.configuration import (
            _apply_preprocessor)

        cd, od = self.compute_dtype, self.output_dtype
        with torch.inference_mode():
            params = _dequant_tree(qparams, cd)
            if x.is_floating_point() and x.dtype != cd:
                x = x.to(cd)   # int8 weights, compute-dtype activations
            for i, lr in enumerate(self._layers):
                x = _apply_preprocessor(self._preprocessors[i], x)
                p, x = _promoted(params[i], x)
                x, _ = lr.apply(p, states[i], x, False, None)
            return x.to(od) if x.is_floating_point() and x.dtype != od \
                else x

    def _infer_fn(self):
        return self._run

    def _call_args(self):
        return (self._qparams, self._qstates)

    def describe_extra(self) -> dict:
        d = {"quantization": "int8_per_channel_absmax",
             "compute_dtype": str(self.compute_dtype).removeprefix("torch."),
             "bytes": quantized_bytes(self._qparams)}
        if self.calibration_max_err is not None:
            d["calibration_max_err"] = round(
                float(self.calibration_max_err), 6)
        return d


def _calibration_features(calibration_iter):
    """Arrays, (features, labels) tuples, DataSet-likes, or any iterable
    of those."""
    for item in calibration_iter:
        if hasattr(item, "getFeatures"):
            item = item.getFeatures()
        elif isinstance(item, (tuple, list)):
            item = item[0]
        yield item.toNumpy() if hasattr(item, "toNumpy") else np.asarray(item)


def quantize(model, calibration_iter, example_shape=None, dtype=None,
             compute_dtype="bfloat16", skip_layers=(),
             device=None) -> QuantizedServable:
    """Int8 PTQ entry point.

    model: a MultiLayerNetwork or a NetworkServable wrapping one;
    calibration_iter: batches the quantized model is checked against
      (and whose per-layer activation absmax is recorded);
    example_shape: the per-example input shape, taken from a wrapped
      servable when a NetworkServable is passed;
    device: where the servable lives ("cuda" unless named).
    """
    from deeplearning4j_tpu_torch.serving.servable import NetworkServable
    from deeplearning4j_tpu_torch.telemetry import flight

    if isinstance(model, NetworkServable):
        if example_shape is None:
            example_shape = model.example_shape
        net = model.net
    else:
        net = model
    if type(net).__name__ != "MultiLayerNetwork":
        raise TypeError(
            f"int8 PTQ currently supports MultiLayerNetwork (got "
            f"{type(net).__name__}); wrap graphs in a distilled "
            f"sequential net or serve them in float")
    sv = QuantizedServable(net, example_shape, dtype=dtype,
                           compute_dtype=compute_dtype,
                           skip_layers=skip_layers, device=device)
    batches = list(_calibration_features(calibration_iter))
    if batches:
        act_absmax: list = [None] * len(net.layers)
        max_err = 0.0
        for f in batches:
            acts = net.feedForward(f)
            for i in range(len(net.layers)):
                a = np.abs(acts[i + 1].toNumpy().astype(np.float32))
                # per channel over axis 1, everything else reduced
                red = tuple(ax for ax in range(a.ndim) if ax != 1) \
                    if a.ndim > 1 else (0,)
                cur = a.max(axis=red)
                act_absmax[i] = cur if act_absmax[i] is None else \
                    np.maximum(act_absmax[i], cur)
            ref = net.output(f).toNumpy().astype(np.float32)
            got = np.asarray(sv.infer(f), np.float32)
            max_err = max(max_err, float(np.abs(got - ref).max()))
        sv.calibration_max_err = max_err
        sv.activation_absmax = [None if a is None else a.tolist()
                                for a in act_absmax]
    flight.record("quantize", layers=len(net.layers),
                  calibration_batches=len(batches),
                  max_err=sv.calibration_max_err)
    return sv
