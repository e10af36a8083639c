"""ComputationGraphConfiguration: a DAG of layers and vertices.

Counterpart of ``deeplearning4j_tpu/nn/conf/graph_conf.py``: the same
vertices (parameter-less functions of their inputs), the same
topological order (Kahn's algorithm seeded from the sorted names, so
``params()`` flattens in the JAX package's order), the same shape
inference over the declared input types and the same JSON, so a graph
configuration written by either package builds the same graph in the
other. As in the JAX package, a graph records no preprocessors: each
node takes its inputs as they come. ``AttentionVertex`` lives with the
attention layers (``nn/conf/attention.py``): it has params, so it is a
layer node with ``MULTI_INPUT``, fed the list of its inputs.
"""

from __future__ import annotations

import json

import torch

from deeplearning4j_tpu_torch.backend import torch_dtype
from deeplearning4j_tpu_torch.nn.conf.inputs import (
    ConvolutionalType, InputType, RecurrentType)
from deeplearning4j_tpu_torch.nn.conf.layers import BaseLayer
from deeplearning4j_tpu_torch.optimize.updaters import updater_from_config

VERTEX_REGISTRY: dict = {}


def _register_vertex(cls):
    VERTEX_REGISTRY[cls.__name__] = cls
    return cls


class GraphVertex:
    """Parameter-less combination vertex: ``apply(*xs)`` over tensors."""

    def infer(self, *input_types):
        return input_types[0]

    def apply(self, *xs):
        raise NotImplementedError

    def to_json(self):
        d = {"@class": type(self).__name__}
        d.update({k: (list(v) if isinstance(v, tuple) else v)
                  for k, v in self.__dict__.items()})
        return d

    @staticmethod
    def from_json(d):
        d = dict(d)
        name = d.pop("@class")
        if name not in VERTEX_REGISTRY:
            raise NotImplementedError(
                f"vertex {name} is not ported to deeplearning4j_tpu_torch "
                f"yet (ported: {sorted(VERTEX_REGISTRY)})")
        return VERTEX_REGISTRY[name](**d)


def _with_channels(t0, n):
    """``t0``'s kind (conv, recurrent, feed-forward) with ``n`` channels."""
    if isinstance(t0, ConvolutionalType):
        return InputType.convolutional(t0.height, t0.width, n)
    if isinstance(t0, RecurrentType):
        return InputType.recurrent(n, t0.timeSeriesLength)
    return InputType.feedForward(n)


@_register_vertex
class MergeVertex(GraphVertex):
    """Concatenation along the feature/channel axis (axis 1)."""

    def infer(self, *input_types):
        total = sum(getattr(t, "channels", getattr(t, "size", 0))
                    for t in input_types)
        return _with_channels(input_types[0], total)

    def apply(self, *xs):
        return torch.cat(xs, dim=1)


@_register_vertex
class ElementWiseVertex(GraphVertex):
    Add, Subtract, Product, Average, Max = ("Add", "Subtract", "Product",
                                            "Average", "Max")

    def __init__(self, op="Add"):
        self.op = op

    def apply(self, *xs):
        # out of place throughout: an input may feed other nodes too
        if self.op == "Add":
            y = xs[0]
            for x in xs[1:]:
                y = y + x
            return y
        if self.op == "Subtract":
            return xs[0] - xs[1]
        if self.op == "Product":
            y = xs[0]
            for x in xs[1:]:
                y = y * x
            return y
        if self.op == "Average":
            return sum(xs) / len(xs)
        if self.op == "Max":
            y = xs[0]
            for x in xs[1:]:
                y = torch.maximum(y, x)
            return y
        raise ValueError(self.op)


@_register_vertex
class ScaleVertex(GraphVertex):
    def __init__(self, scaleFactor=1.0):
        self.scaleFactor = scaleFactor

    def apply(self, x):
        return x * self.scaleFactor


@_register_vertex
class ShiftVertex(GraphVertex):
    def __init__(self, shiftFactor=0.0):
        self.shiftFactor = shiftFactor

    def apply(self, x):
        return x + self.shiftFactor


@_register_vertex
class StackVertex(GraphVertex):
    """Stack along the batch axis."""

    def apply(self, *xs):
        return torch.cat(xs, dim=0)


@_register_vertex
class SubsetVertex(GraphVertex):
    """Channels ``fromIdx`` to ``toIdx``, both included."""

    def __init__(self, fromIdx=0, toIdx=0):
        self.fromIdx = int(fromIdx)
        self.toIdx = int(toIdx)

    def infer(self, *input_types):
        return _with_channels(input_types[0], self.toIdx - self.fromIdx + 1)

    def apply(self, x):
        return x[:, self.fromIdx: self.toIdx + 1]


@_register_vertex
class L2NormalizeVertex(GraphVertex):
    """Each example divided by its L2 norm (plus ``eps``)."""

    def __init__(self, eps=1e-8):
        self.eps = eps

    def apply(self, x):
        n = torch.sqrt(torch.sum(x * x, dim=tuple(range(1, x.dim())),
                                 keepdim=True))
        return x / (n + self.eps)


@_register_vertex
class ReshapeVertex(GraphVertex):
    """Each example reshaped to ``newShape`` (the batch axis kept)."""

    def __init__(self, newShape=None):
        self.newShape = tuple(newShape)

    def apply(self, x):
        return x.reshape((x.shape[0],) + tuple(self.newShape))


class ComputationGraphConfiguration:
    def __init__(self, inputs, nodes, outputs, defaults=None, seed=12345,
                 dataType="float32", input_types=None,
                 backpropType="Standard", tbpttLength=None, precision=None):
        self.inputs = list(inputs)            # input names
        self.nodes = nodes                    # name -> (node, [inputs])
        self.outputs = list(outputs)          # output layer names
        self.defaults = defaults or {}
        self.seed = seed
        self.dataType = dataType
        self.input_types = input_types or {}
        self.backpropType = backpropType
        self.tbpttLength = tbpttLength
        # a precision policy (name or JSON) is carried for the round trip;
        # the graph refuses to run one until the precision slice lands
        self.precision = precision
        self.topo_order: list[str] = []
        self._finalize()

    def _finalize(self):
        """Clone defaults into layers, order the nodes (Kahn, seeded from
        the sorted names) and infer shapes over the declared input
        types."""
        for node, _ in self.nodes.values():
            if isinstance(node, BaseLayer):
                node.apply_defaults(self.defaults)
        indeg = {n: 0 for n in self.nodes}
        dependents: dict[str, list[str]] = {n: [] for n in self.nodes}
        for name, (_, ins) in self.nodes.items():
            for i in ins:
                if i in self.nodes:
                    indeg[name] += 1
                    dependents[i].append(name)
                elif i not in self.inputs:
                    raise ValueError(f"node {name!r} input {i!r} undefined")
        ready = sorted(n for n, d in indeg.items() if d == 0)
        order = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for m in dependents[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    ready.append(m)
        if len(order) != len(self.nodes):
            raise ValueError("cycle in computation graph")
        self.topo_order = order
        if self.input_types:
            types = dict(self.input_types)
            for name in order:
                node, ins = self.nodes[name]
                in_types = [types[i] for i in ins if i in types]
                if len(in_types) != len(ins):
                    continue
                multi = (isinstance(node, GraphVertex)
                         or getattr(node, "MULTI_INPUT", False))
                types[name] = (node.infer(*in_types) if multi
                               else node.infer(in_types[0]))

    @property
    def dtype(self):
        """The torch dtype of dataType."""
        return torch_dtype(self.dataType)

    def to_json(self):
        from deeplearning4j_tpu_torch.nn.conf.configuration import (
            _json_defaults)

        nodes = {}
        for name, (node, ins) in self.nodes.items():
            kind = "layer" if isinstance(node, BaseLayer) else "vertex"
            nodes[name] = {"kind": kind, "conf": node.to_json(),
                           "inputs": list(ins)}
        return json.dumps({
            "inputs": self.inputs,
            "nodes": nodes,
            "outputs": self.outputs,
            "defaults": _json_defaults(self.defaults),
            "seed": self.seed,
            "dataType": self.dataType,
            "inputTypes": {k: v.to_json()
                           for k, v in self.input_types.items()},
            "backpropType": self.backpropType,
            "tbpttLength": self.tbpttLength,
            "precision": self.precision,
        }, indent=1)

    toJson = to_json

    @staticmethod
    def from_json(s):
        d = json.loads(s) if isinstance(s, str) else s
        nodes = {}
        for name, nd in d["nodes"].items():
            conf = (BaseLayer.from_json(nd["conf"]) if nd["kind"] == "layer"
                    else GraphVertex.from_json(nd["conf"]))
            nodes[name] = (conf, nd["inputs"])
        defaults = dict(d.get("defaults") or {})
        if isinstance(defaults.get("updater"), dict):
            defaults["updater"] = updater_from_config(defaults["updater"])
        input_types = {k: InputType.from_json(v)
                       for k, v in (d.get("inputTypes") or {}).items()}
        return ComputationGraphConfiguration(
            d["inputs"], nodes, d["outputs"], defaults, d.get("seed", 12345),
            d.get("dataType", "float32"), input_types,
            d.get("backpropType", "Standard"), d.get("tbpttLength"),
            d.get("precision"))

    fromJson = from_json


class GraphBuilder:
    def __init__(self, defaults, seed, dataType, precision=None):
        self._defaults = defaults
        self._seed = seed
        self._dataType = dataType
        self._precision = precision
        self._inputs: list[str] = []
        self._nodes: dict = {}
        self._outputs: list[str] = []
        self._input_types: dict = {}
        self._backprop_type = "Standard"
        self._tbptt_length = None

    def addInputs(self, *names):
        self._inputs.extend(names)
        return self

    def setInputTypes(self, *types):
        for name, t in zip(self._inputs, types):
            self._input_types[name] = t
        return self

    def addLayer(self, name, layer, *inputs):
        self._nodes[name] = (layer, list(inputs))
        return self

    def addVertex(self, name, vertex, *inputs):
        self._nodes[name] = (vertex, list(inputs))
        return self

    def setOutputs(self, *names):
        self._outputs = list(names)
        return self

    def backpropType(self, bt, tbpttLength=None):
        """The backprop type, with one symmetric TBPTT length."""
        self._backprop_type = bt
        if tbpttLength is not None:
            self._tbptt_length = int(tbpttLength)
        return self

    def tBPTTLength(self, n):
        self._backprop_type = "TruncatedBPTT"
        self._tbptt_length = int(n)
        return self

    def build(self) -> ComputationGraphConfiguration:
        return ComputationGraphConfiguration(
            self._inputs, self._nodes, self._outputs, dict(self._defaults),
            self._seed, self._dataType, self._input_types,
            self._backprop_type, self._tbptt_length, self._precision)
