"""Servable adapters: one uniform `infer(batch) -> batch` face over a
network, with shape-bucketed warmup.

Counterpart of ``deeplearning4j_tpu/serving/servable.py``. There is no
XLA executable to compile: PyTorch runs eagerly, so warmup runs the
inference function once at each ladder shape, which builds the kernels
and fills the allocator's caches before traffic arrives. Parameters are
read from the live network at call time, never captured.

The host boundary of a bfloat16 model (a network whose precision policy
outputs bfloat16) is float32: requests come in as float32 arrays that
hold bfloat16 values, and answers go out as float32, because numpy on
the GPU machine has no bfloat16 (the JAX package's numpy has it through
ml_dtypes). The network casts the batch to its compute dtype, so the
values it computes on are the bfloat16 ones either way.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend import resolve_device


def _model_dtype(model) -> np.dtype:
    """The serving-boundary dtype a model's configuration implies: its
    precision policy's output dtype (the dataType without a policy), with
    bfloat16 served as float32 (the module's host-boundary rule)."""
    conf = getattr(model, "conf", None)
    if conf is None or not hasattr(conf, "precision_policy"):
        return np.dtype(np.float32)
    out = conf.precision_policy.output_dtype
    return np.dtype(np.float32 if out == "bfloat16" else out)


class Servable:
    """Base: a model's pure inference function behind numpy in/out.

    Subclasses provide `_infer_fn()` (the function) and `_call_args()`
    (its non-input arguments, read fresh per call). Batches move to
    `device`, where the model lives."""

    def __init__(self, example_shape, device, dtype=np.float32):
        if example_shape is None:
            raise ValueError(
                "serving needs the per-example input shape (no batch "
                "axis), e.g. example_shape=(784,)")
        self.example_shape = tuple(int(d) for d in example_shape)
        self.dtype = np.dtype(dtype)
        self.device = torch.device(device)
        self._warmed: set = set()
        self._lock = threading.Lock()

    # -- subclass surface ---------------------------------------------------
    def _infer_fn(self):
        raise NotImplementedError

    def _call_args(self) -> tuple:
        raise NotImplementedError

    # -- warmup -------------------------------------------------------------
    def warm_shape(self, shape: tuple):
        """Run the inference function once at one concrete input shape
        (idempotent)."""
        shape = tuple(shape)
        if shape in self._warmed:
            return
        self.infer(np.zeros(shape, self.dtype))
        with self._lock:
            self._warmed.add(shape)

    def warmup(self, ladder) -> list[tuple]:
        """Run every ladder shape once; returns the warmed shapes."""
        shapes = ladder.shapes(self.example_shape)
        for s in shapes:
            self.warm_shape(s)
        return shapes

    @property
    def warmed_shapes(self) -> list[tuple]:
        return sorted(self._warmed)

    # -- hot path -----------------------------------------------------------
    def infer(self, x) -> np.ndarray:
        """Run one already-bucketed batch; the result comes back to the
        host as numpy (which waits for the device), a bfloat16 one as
        float32."""
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=self.dtype))
        y = self._infer_fn()(*self._call_args(), x.to(self.device))
        if y.dtype == torch.bfloat16:
            y = y.float()
        return y.cpu().numpy()


class NetworkServable(Servable):
    """MultiLayerNetwork: runs the network's own inference function, so
    direct `net.output()` calls and serving compute the same thing."""

    def __init__(self, net, example_shape, dtype=None):
        super().__init__(example_shape, net.device,
                         _model_dtype(net) if dtype is None else dtype)
        self.net = net

    def _infer_fn(self):
        return self.net._infer_fn(False)

    def _call_args(self):
        return (self.net._params, self.net._states)


class GraphServable(Servable):
    """ComputationGraph with a single input and a single output: runs the
    graph's own forward, as ``outputSingle`` does, with the params read
    from the live graph at call time."""

    def __init__(self, graph, example_shape, dtype=None):
        if len(graph.conf.inputs) != 1 or len(graph.conf.outputs) != 1:
            raise ValueError(
                f"serving supports single-input/single-output graphs; "
                f"got inputs={graph.conf.inputs} "
                f"outputs={graph.conf.outputs}")
        super().__init__(example_shape, graph.device,
                         _model_dtype(graph) if dtype is None else dtype)
        self.graph = graph

    def _infer_fn(self):
        return self.graph._infer_fn(False)

    def _call_args(self):
        return (self.graph._params, self.graph._states)


class SameDiffServable(Servable):
    """SameDiff graph: serve one placeholder -> one output variable. The
    graph's values are read at call time (a graph trained since it was
    registered serves its new values), and the graph runs under
    ``torch.inference_mode()`` on its own device."""

    def __init__(self, sd, input_name, output_name, example_shape,
                 dtype=None):
        super().__init__(example_shape, sd.device,
                         np.float32 if dtype is None else dtype)
        self.sd = sd
        self.input_name = (input_name.name()
                           if hasattr(input_name, "name") else input_name)
        self.output_name = (output_name.name()
                            if hasattr(output_name, "name") else output_name)

    def _run(self, params, consts, x):
        fn = self.sd._make_fn((self.output_name,), False)
        with torch.inference_mode():
            out = fn({self.input_name: x}, params, consts, self.sd._seed)
        return out[self.output_name]

    def _infer_fn(self):
        return self._run

    def _call_args(self):
        return self.sd._split_values()


class FnServable(Servable):
    """A plain ``fn(x) -> y`` over tensors, served like any network: the
    escape hatch for custom pipelines (BERT's ``forward`` over token ids,
    for one). ``fn`` runs under ``torch.inference_mode()`` on the
    servable's device ("cuda" unless named) and returns a tensor numpy
    can hold (float32, not bfloat16)."""

    def __init__(self, fn, example_shape, dtype=None, device=None):
        super().__init__(example_shape, resolve_device(device),
                         np.float32 if dtype is None else dtype)
        self.fn = fn

    def _run(self, x):
        with torch.inference_mode():
            return self.fn(x)

    def _infer_fn(self):
        return self._run

    def _call_args(self):
        return ()


def as_servable(model, example_shape=None, dtype=None,
                input_name=None, output_name=None) -> Servable:
    """Wrap a supported model type in its Servable adapter. dtype=None
    takes the serving-boundary dtype from the model's precision policy
    (``_model_dtype``; float32 for a SameDiff graph or a plain function); a
    SameDiff graph needs the
    placeholder it is fed through and the variable it answers with."""
    if isinstance(model, Servable):
        return model
    kind = type(model).__name__
    if kind == "MultiLayerNetwork":
        return NetworkServable(model, example_shape, dtype)
    if kind == "ComputationGraph":
        return GraphServable(model, example_shape, dtype)
    if kind == "SameDiff":
        if input_name is None or output_name is None:
            raise ValueError(
                "SameDiff serving needs input_name= and output_name=")
        return SameDiffServable(model, input_name, output_name,
                                example_shape, dtype)
    if callable(model):
        return FnServable(model, example_shape, dtype)
    raise TypeError(f"cannot serve a {kind} (the port serves "
                    f"MultiLayerNetwork, ComputationGraph, SameDiff and "
                    f"plain functions so far)")
