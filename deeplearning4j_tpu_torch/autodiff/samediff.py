"""SameDiff: a define-then-run graph over the op registry, run eagerly
with autograd.

Counterpart of ``deeplearning4j_tpu/autodiff/samediff.py`` (reference
capability: org.nd4j.autodiff.samediff.SameDiff / SDVariable /
TrainingConfig). The graph, its variables, namespaces, control flow,
training and serialization keep the reference's API. PyTorch's idiom
takes the place of the JAX machinery:

- **Device.** A graph lives on one device, "cuda" unless named
  (``SameDiff(device="cpu")``); values given as numpy, lists, tensors or
  the port's ``INDArray`` move there, and ``getArr``/``eval``/``output``
  return the port's ``INDArray``.
- **Running a graph.** No jit and no executable cache: the ops that the
  wanted outputs need run in order, eagerly. ``output`` runs under
  ``torch.inference_mode()`` (a ``gruLayer`` there launches the GRU
  inference kernel); ``calculateGradients`` and ``fit`` run the same ops
  with autograd recording and take ``torch.autograd.grad`` of the summed
  loss variables. ``fit`` updates the parameter tensors in place, so
  ``getArr()`` reads the current values during training.
- **Random streams.** ``var(name, init_fn, *shape)`` calls
  ``init_fn(generator, shape)`` with a ``torch.Generator`` on the graph's
  device seeded from crc32(name) + seed; a random op gets a generator
  seeded from (seed, step, op index). Draws match the reference by
  distribution, not by seed.
- **Save and load** write the reference's zip: ``graph.json`` (dtypes
  under numpy's names), ``values.npz`` and ``updater_state.npz`` in
  ``tree_leaves`` order, control-flow bodies as nested sub-graph dicts
  whose captured constants ride the npz under ``__sub__/`` keys. A zip
  written by either package loads in the other.

Below the graph, the batch helpers of ``fit`` that ``MultiLayerNetwork``
shares.
"""

from __future__ import annotations

import io
import json
import zipfile
import zlib
from dataclasses import dataclass, field
from enum import Enum
from typing import Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.ops import (
    DEVICE_OPS, OPS, RANDOM_OPS, TRAINING_AWARE_OPS)
from deeplearning4j_tpu_torch.backend import resolve_device
from deeplearning4j_tpu_torch.ndarray import INDArray
from deeplearning4j_tpu_torch.ndarray.ndarray import torch_dtype
from deeplearning4j_tpu_torch.optimize.updaters import (
    IUpdater, Sgd, updater_from_config)
from deeplearning4j_tpu_torch.tree_util import tree_fill, tree_leaves


class VariableType(Enum):
    VARIABLE = "VARIABLE"        # trainable
    CONSTANT = "CONSTANT"
    PLACEHOLDER = "PLACEHOLDER"
    ARRAY = "ARRAY"              # op output


@dataclass
class Op:
    fn_name: str
    inputs: list          # input var names
    outputs: list         # output var names
    attrs: dict


class _TraceUnsupported(Exception):
    """Raised when a control-flow body cannot be traced into a child
    SameDiff graph (e.g. it calls torch functions directly instead of the
    SDVariable op surface). SameDiff then falls back to storing the
    raw callable: the graph still runs, but cannot be save()d."""


class _CaptureError(_TraceUnsupported):
    """A body captured an outer variable with no build-time value (a
    placeholder or op output), or a trainable one. Unlike other trace
    failures this cannot work at runtime either, so it is a hard
    build-time error."""


def _dtype_name(dtype) -> str:
    """numpy's name of a dtype ("float32", "int32", "bfloat16"), which
    graph.json holds."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def _host(v) -> np.ndarray:
    """A host numpy copy of a value (a bfloat16 tensor as float32)."""
    if isinstance(v, INDArray):
        v = v.torch()
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


def _to_tensor(v, device, copy=False) -> torch.Tensor:
    """A value on ``device``: tensors and INDArrays as they are (a copy of
    its own with ``copy``), host data as float32/int32 where numpy gives
    64 bits, as the reference does with 64-bit types off."""
    if isinstance(v, INDArray):
        v = v.torch()
    if isinstance(v, torch.Tensor):
        t = v.detach().to(device)
        return t.clone() if copy and t.data_ptr() == v.data_ptr() else t
    a = np.asarray(v)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    elif a.dtype == np.uint64:
        a = a.astype(np.uint32)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _seed_of(*parts) -> int:
    """A generator seed from integers (seed, step, op index)."""
    return zlib.crc32(":".join(str(int(p)) for p in parts).encode())


class SubGraph:
    """A control-flow body as a named child SameDiff graph: the
    serializable representation of whileLoop/ifCond/scan/forLoop bodies
    (reference analog: FlatBuffers function defs in libnd4j's graph
    scheme). arg_names are the child placeholders fed positionally;
    out_names the child variables returned."""

    def __init__(self, graph: "SameDiff", arg_names: list,
                 out_names: list):
        self.graph = graph
        self.arg_names = list(arg_names)
        self.out_names = list(out_names)

    def callable(self, squeeze: bool = False):
        """The child graph as a plain callable over tensors, with the
        signature the control-flow ops expect.

        Random ops are rejected: the body runs with a fixed generator
        seed detached from the parent graph's stream, so a random op would
        draw the SAME values on every call and every loop iteration — a
        silent correctness trap. (Inference-mode dropout is fine: it is
        deterministic at training=False.)"""
        for o in self.graph._ops:
            if o.fn_name in RANDOM_OPS and o.fn_name not in \
                    TRAINING_AWARE_OPS:
                raise ValueError(
                    f"control-flow body contains random op "
                    f"{o.fn_name!r} ({o.outputs[0]!r}): loop/branch "
                    "bodies run with a fixed RNG key, so every call and "
                    "every iteration would draw identical values. Hoist "
                    "the random draw out of the body and pass it in as a "
                    "loop variable instead.")
        fn = self.graph._make_fn(tuple(self.out_names), training=False)
        params, consts = self.graph._split_values()
        arg_names, out_names = self.arg_names, self.out_names

        def call(*args):
            outs = fn(dict(zip(arg_names, args)), params, consts, 0)
            res = tuple(outs[n] for n in out_names)
            return res[0] if (squeeze and len(res) == 1) else res

        return call

    def to_dict(self, value_sink=None, prefix="") -> dict:
        """Serializable dict. Child-graph VALUES (captured constants can
        be weight-matrix sized) go into `value_sink` — the parent's npz
        dict — under prefixed keys, not into the JSON; they are inlined
        when no sink is given (in-memory use)."""
        d = self.graph._graph_dict(value_sink=value_sink,
                                   prefix=prefix or "__sub__/")
        if value_sink is not None:
            d["value_keys"] = {}
            for k, v in self.graph._values.items():
                sk = f"{prefix}{k}"
                value_sink[sk] = _host(v)
                d["value_keys"][k] = sk
        else:
            d["values"] = {
                k: {"dtype": _dtype_name(v.dtype), "data": _host(v).tolist()}
                for k, v in self.graph._values.items()
            }
        return {"args": self.arg_names, "outs": self.out_names,
                "graph": d}

    @staticmethod
    def from_dict(d: dict, value_source=None, device=None) -> "SubGraph":
        child = SameDiff._from_graph_dict(d["graph"], value_source, device)
        if "value_keys" in d["graph"]:
            for k, sk in d["graph"]["value_keys"].items():
                child._values[k] = _to_tensor(value_source[sk], child.device)
        else:
            for k, spec in d["graph"].get("values", {}).items():
                child._values[k] = _to_tensor(
                    np.asarray(spec["data"], np.dtype(spec["dtype"])),
                    child.device)
        return SubGraph(child, d["args"], d["outs"])


def _trace_subgraph(fn, n_args, device) -> SubGraph:
    """Trace a Python body callable into a child SameDiff graph (on the
    parent's device) by calling it with child placeholders. Raises
    _TraceUnsupported when the body escapes the SDVariable op surface."""
    child = SameDiff(device=device)
    child._tracing = True
    arg_names = [f"__arg{i}" for i in range(n_args)]
    phs = [child.placeHolder(n) for n in arg_names]
    try:
        outs = fn(*phs)
    except _TraceUnsupported:
        raise
    except Exception as e:
        raise _TraceUnsupported(
            f"body is not traceable over SDVariables ({type(e).__name__}: "
            f"{e}); it will be stored as a raw callable and the graph "
            f"will not be serializable") from e
    finally:
        child._tracing = False
    outs = outs if isinstance(outs, tuple) else (outs,)
    if not all(isinstance(o, SDVariable) and o.sd is child for o in outs):
        raise _TraceUnsupported(
            "body returned non-SDVariable outputs during tracing")
    return SubGraph(child, arg_names, [o.name() for o in outs])


# which op attrs hold sub-graph bodies, and the callable attr + squeeze
# behavior each one feeds (squeeze: whileLoop's cond must return a scalar,
# not a 1-tuple)
_SUBGRAPH_ATTRS = {
    "cond_graph": ("cond_fn", True),
    "body_graph": ("body_fn", False),
    "true_graph": ("true_fn", False),
    "false_graph": ("false_fn", False),
}


class SDVariable:
    def __init__(self, sd: "SameDiff", name: str, vtype: VariableType,
                 shape=None, dtype=torch.float32):
        self.sd = sd
        self._name = name
        self.variableType = vtype
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype

    def name(self) -> str:
        return self._name

    def getShape(self):
        return self._shape

    # -- graph-building arithmetic -----------------------------------------
    def _bin(self, opname, other, rev=False):
        # when operands come from different graphs (control-flow body
        # tracing mixes child placeholders with captured parent vars),
        # build the op on the graph BEING TRACED regardless of operand
        # order — `outer_const + loop_var` must behave like
        # `loop_var + outer_const`
        sd = self.sd
        if (isinstance(other, SDVariable) and other.sd is not sd
                and getattr(other.sd, "_tracing", False)
                and not getattr(sd, "_tracing", False)):
            sd = other.sd
        a = sd._as_var(self)
        b = sd._as_var(other)
        if rev:
            a, b = b, a
        return sd._op(opname, [a, b])

    def add(self, o):
        return self._bin("add", o)

    def sub(self, o):
        return self._bin("sub", o)

    def mul(self, o):
        return self._bin("mul", o)

    def div(self, o):
        return self._bin("div", o)

    def rsub(self, o):
        return self._bin("sub", o, rev=True)

    def rdiv(self, o):
        return self._bin("div", o, rev=True)

    def pow(self, o):
        return self._bin("pow", o)

    def squaredDifference(self, o):
        return self._bin("squaredDifference", o)

    __add__ = add
    __radd__ = add
    __sub__ = sub
    __rsub__ = rsub
    __mul__ = mul
    __rmul__ = mul
    __truediv__ = div
    __rtruediv__ = rdiv
    __pow__ = pow

    def __neg__(self):
        return self.sd._op("neg", [self])

    def __matmul__(self, o):
        return self.mmul(o)

    # comparisons (reference: SDVariable.gt/lt/gte/lte/eq/neq)
    def gt(self, o):
        return self._bin("gt", o)

    def lt(self, o):
        return self._bin("lt", o)

    def gte(self, o):
        return self._bin("gte", o)

    def lte(self, o):
        return self._bin("lte", o)

    def eq(self, o):
        return self._bin("eq", o)

    def neq(self, o):
        return self._bin("neq", o)

    __gt__ = gt
    __lt__ = lt
    __ge__ = gte
    __le__ = lte

    def all(self, *dims, keepDims=False):
        return self._red("all", dims, keepDims)

    def any(self, *dims, keepDims=False):
        return self._red("any", dims, keepDims)

    def neg(self):
        return self.sd._op("neg", [self])

    def mmul(self, o, transposeA=False, transposeB=False):
        return self.sd._op(
            "matmul", [self, self.sd._as_var(o)],
            {"transposeA": transposeA, "transposeB": transposeB},
        )

    def dot(self, o, *dims):
        return self.sd._op(
            "dot", [self, self.sd._as_var(o)],
            {"dimensions": list(dims) or None},
        )

    # shape ops
    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return self.sd._op("reshape", [self], {"shape": list(shape)})

    def transpose(self):
        return self.sd._op("transpose", [self])

    def permute(self, *dims):
        return self.sd._op("permute", [self], {"dimensions": list(dims)})

    def castTo(self, dtype):
        return self.sd._op("cast", [self], {"dtype": dtype})

    # reductions
    def _red(self, opname, dims, keepDims=False):
        return self.sd._op(
            opname, [self], {"dimensions": list(dims) or None, "keepDims": keepDims}
        )

    def sum(self, *dims, keepDims=False):
        return self._red("sum", dims, keepDims)

    def mean(self, *dims, keepDims=False):
        return self._red("mean", dims, keepDims)

    def max(self, *dims, keepDims=False):
        return self._red("max", dims, keepDims)

    def min(self, *dims, keepDims=False):
        return self._red("min", dims, keepDims)

    def prod(self, *dims, keepDims=False):
        return self._red("prod", dims, keepDims)

    def norm1(self, *dims):
        return self._red("norm1", dims)

    def norm2(self, *dims):
        return self._red("norm2", dims)

    def std(self, biasCorrected=True, *dims):
        return self.sd._op(
            "standardDeviation", [self],
            {"dimensions": list(dims) or None, "biasCorrected": biasCorrected},
        )

    def argmax(self, dim=None):
        return self.sd._op("argmax", [self], {"dimension": dim})

    def argmin(self, dim=None):
        return self.sd._op("argmin", [self], {"dimension": dim})

    # misc
    def get(self, idx):
        raise NotImplementedError("use sd.stridedSlice / sd.gather")

    def rename(self, new_name: str) -> "SDVariable":
        self.sd._rename(self._name, new_name)
        return self

    def markAsLoss(self):
        if self._name not in self.sd._loss_vars:
            self.sd._loss_vars.append(self._name)
        return self

    def isPlaceHolder(self):
        return self.variableType == VariableType.PLACEHOLDER

    # -- execution ----------------------------------------------------------
    def eval(self, feeds: dict | None = None) -> INDArray:
        return self.sd.output(feeds or {}, self._name)[self._name]

    def getArr(self) -> INDArray:
        """A VARIABLE's or CONSTANT's array: a handle over the graph's own
        tensor, which ``fit`` updates in place. Other variables are
        evaluated."""
        if self.variableType in (VariableType.VARIABLE, VariableType.CONSTANT):
            return INDArray(self.sd._values[self._name])
        return self.eval()

    def setArr(self, value):
        self.sd._values[self._name] = _to_tensor(value, self.sd.device,
                                                 copy=True)
        return self

    def __repr__(self):
        return (f"SDVariable(name={self._name!r}, "
                f"type={self.variableType.value}, shape={self._shape})")


# ---------------------------------------------------------------------------
# op namespaces (reference: SDOps families SDMath/SDNN/SDCNN/SDRNN/SDLoss/
# SDRandom on the SameDiff object). Their passthrough lists are the
# reference's whole lists.
# ---------------------------------------------------------------------------

class _Namespace:
    _passthrough: tuple = ()

    def __init__(self, sd: "SameDiff"):
        self.sd = sd

    def __getattr__(self, item):
        if item in type(self)._passthrough:
            def f(*inputs, name=None, **attrs):
                vars_ = [self.sd._as_var(v) for v in inputs]
                return self.sd._op(item, vars_, attrs, name=name)

            return f
        raise AttributeError(item)


class SDMath(_Namespace):
    _passthrough = (
        "add", "sub", "mul", "div", "rsub", "rdiv", "pow", "neg", "abs",
        "exp", "log", "log1p", "sqrt", "square", "reciprocal", "sign",
        "floor", "ceil", "round", "sin", "cos", "tan", "asin", "acos",
        "atan", "sinh", "cosh", "tanh", "erf", "isnan", "isinf", "matmul",
        "tensorMmul", "dot", "cumsum", "cumprod", "sum", "mean", "max",
        "min", "prod", "norm1", "norm2", "normMax", "logSumExp", "moments",
        "variance", "standardDeviation", "countNonZero", "eq", "neq", "gt",
        "gte", "lt", "lte", "and_op", "or_op", "not_op", "xor_op",
        "maximum", "minimum", "clipByValue", "clipByNorm", "standardize",
        "squaredDifference", "floordiv", "mod", "diag", "invertPermutation",
        "reverse", "argmax", "argmin", "atan2", "expm1", "asinh", "acosh",
        "atanh", "erfc", "lgamma", "digamma", "igamma", "igammac",
        "betainc", "segmentSum", "segmentMax", "segmentMin", "segmentMean",
        "segmentProd", "unsortedSegmentSum", "unsortedSegmentMax",
        "unsortedSegmentMin", "unsortedSegmentMean", "unsortedSegmentProd",
        "topK", "inTopK", "confusionMatrix", "bincount", "zeroFraction",
        "trace",
    )


class SDNN(_Namespace):
    _passthrough = (
        "sigmoid", "relu", "relu6", "elu", "selu", "gelu", "softplus",
        "softsign", "swish", "mish", "hardSigmoid", "hardTanh", "leakyRelu",
        "prelu", "softmax", "logSoftmax", "layerNorm", "batchNorm",
        "dropout", "dotProductAttention", "multiHeadDotProductAttention",
        "pad", "rationalTanh", "rectifiedTanh",
    )

    def linear(self, x, w, b=None, name=None):
        y = self.sd._op("matmul", [x, w])
        if b is not None:
            y = self.sd._op("add", [y, b], name=name)
        return y

    def reluLayer(self, x, w, b, name=None):
        return self.sd._op("relu", [self.linear(x, w, b)], name=name)


class SDCNN(_Namespace):
    _passthrough = (
        "conv2d", "conv1d", "conv3d", "depthwiseConv2d", "deconv2d",
        "maxPooling2d", "avgPooling2d", "maxPooling3d", "avgPooling3d",
        "globalAvgPooling", "upsampling2d", "im2col",
    )


class SDRNN(_Namespace):
    _passthrough = ("lstmCell", "gruCell", "lstmLayer", "gruLayer",
                    "simpleRnnLayer")


class SDLoss(_Namespace):
    _passthrough = (
        "softmaxCrossEntropy", "sparseSoftmaxCrossEntropy",
        "sigmoidCrossEntropy", "meanSquaredError", "absoluteDifference",
        "huberLoss", "logLoss", "hingeLoss", "cosineDistance",
        "klDivergence", "ctcLoss",
    )

    def __getattr__(self, item):
        f = super().__getattr__(item)

        def g(*inputs, name=None, **attrs):
            v = f(*inputs, name=name, **attrs)
            v.markAsLoss()
            return v

        return g


class SDLinalg(_Namespace):
    """Reference: org.nd4j.autodiff.samediff.ops.SDLinalg (cholesky,
    solve, svd, qr, lu, matrix inverse/determinant, band part)."""

    _passthrough = (
        "cholesky", "solve", "triangularSolve", "matrixInverse",
        "matrixDeterminant", "logdet", "svd", "qr", "lu", "lstsq",
        "matrixBandPart", "triu", "tril", "diagPart", "trace", "matmul",
    )


class SDImage(_Namespace):
    """Reference: org.nd4j.autodiff.samediff.ops.SDImage (resize ops,
    extract patches, space/batch/depth rearrangements; NCHW layout)."""

    _passthrough = (
        "imageResize", "extractImagePatches", "spaceToDepth",
        "depthToSpace", "spaceToBatch", "batchToSpace",
        "nonMaxSuppression",
    )


class SDRandom(_Namespace):
    def normal(self, mean, stddev, *shape, name=None):
        return self.sd._op(
            "randomNormal", [], {"shape": list(shape), "mean": mean,
                                 "stddev": stddev}, name=name)

    def uniform(self, low, high, *shape, name=None):
        return self.sd._op(
            "randomUniform", [], {"shape": list(shape), "min": low,
                                  "max": high}, name=name)

    def bernoulli(self, p, *shape, name=None):
        return self.sd._op(
            "randomBernoulli", [], {"shape": list(shape), "p": p}, name=name)

    def gamma(self, alpha, beta, *shape, name=None):
        return self.sd._op(
            "randomGamma", [], {"shape": list(shape), "alpha": alpha,
                                "beta": beta}, name=name)

    def poisson(self, lam, *shape, name=None):
        return self.sd._op(
            "randomPoisson", [], {"shape": list(shape), "lam": lam},
            name=name)

    def exponential(self, lam, *shape, name=None):
        return self.sd._op(
            "randomExponential", [], {"shape": list(shape), "lam": lam},
            name=name)

    def truncatedNormal(self, mean, stddev, *shape, name=None):
        return self.sd._op(
            "truncatedNormal", [], {"shape": list(shape), "mean": mean,
                                    "stddev": stddev}, name=name)


# ---------------------------------------------------------------------------

@dataclass
class TrainingConfig:
    """Reference: org.nd4j.autodiff.samediff.TrainingConfig."""

    updater: IUpdater = field(default_factory=lambda: Sgd(1e-2))
    dataSetFeatureMapping: Sequence[str] = ()
    dataSetLabelMapping: Sequence[str] = ()
    lossVariables: Sequence[str] = ()
    l1: float = 0.0
    l2: float = 0.0
    weightDecay: float = 0.0
    minimize: bool = True

    def to_json(self):
        return {
            "updater": self.updater.to_json(),
            "dataSetFeatureMapping": list(self.dataSetFeatureMapping),
            "dataSetLabelMapping": list(self.dataSetLabelMapping),
            "lossVariables": list(self.lossVariables),
            "l1": self.l1, "l2": self.l2, "weightDecay": self.weightDecay,
            "minimize": self.minimize,
        }

    @staticmethod
    def from_json(d):
        d = dict(d)
        d["updater"] = updater_from_config(d["updater"])
        return TrainingConfig(**d)


class History:
    """fit() result (reference: org.nd4j.autodiff.listeners.records.History)."""

    def __init__(self):
        self.lossCurve = []      # per-epoch mean loss
        self.iterLosses = []

    def finalTrainingLoss(self):
        return self.lossCurve[-1] if self.lossCurve else None


class SameDiff:
    MULTI_OUTPUT_OPS = {"moments": 2, "lstmCell": 2, "lstmLayer": 3,
                        "gruLayer": 2, "simpleRnnLayer": 2, "svd": 3,
                        "qr": 2, "lu": 2, "topK": 2}

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._ops: list[Op] = []
        self._vars: dict[str, SDVariable] = {}
        self._values: dict[str, torch.Tensor] = {}  # VARIABLE + CONSTANT
        self._producer: dict[str, int] = {}       # var name -> op index
        self._loss_vars: list[str] = []
        self._name_counter = 0
        self.trainingConfig: TrainingConfig | None = None
        self._train_step_fn = None
        self._updater_state = None
        self._step = 0
        self._seed = 0
        # namespaces
        self.math = SDMath(self)
        self.nn = SDNN(self)
        self.cnn = SDCNN(self)
        self.rnn = SDRNN(self)
        self.loss = SDLoss(self)
        self.random = SDRandom(self)
        self.linalg = SDLinalg(self)
        self.image = SDImage(self)

    @staticmethod
    def create(device=None) -> "SameDiff":
        return SameDiff(device)

    def _generator(self, *parts) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            _seed_of(*parts))

    # -- variable creation --------------------------------------------------
    def _unique(self, base: str) -> str:
        if base not in self._vars:
            return base
        while True:
            self._name_counter += 1
            cand = f"{base}_{self._name_counter}"
            if cand not in self._vars:
                return cand

    def placeHolder(self, name: str, dtype=torch.float32,
                    *shape) -> SDVariable:
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        v = SDVariable(self, name, VariableType.PLACEHOLDER, shape or None,
                       torch_dtype(dtype))
        self._vars[name] = v
        return v

    def var(self, name: str, *args, dtype=torch.float32) -> SDVariable:
        """var(name, array) | var(name, *shape) (zeros) |
        var(name, init_fn, *shape) where init_fn(generator, shape)->array,
        the generator a torch.Generator on the graph's device seeded from
        the name."""
        name = self._unique(name)
        if len(args) == 1 and isinstance(
            args[0], (list, np.ndarray, torch.Tensor, INDArray)
        ):
            val = _to_tensor(args[0], self.device, copy=True)
        elif args and callable(args[0]):
            shape = tuple(
                args[1]) if len(args) == 2 and isinstance(
                args[1], (list, tuple)) else tuple(args[1:])
            # stable per-name seed: crc32, not hash() (which is salted per
            # interpreter and would make initialization nondeterministic)
            g = torch.Generator(device=self.device).manual_seed(
                zlib.crc32(name.encode()) % (2**31) + self._seed)
            val = _to_tensor(args[0](g, shape), self.device,
                             copy=True).to(torch_dtype(dtype))
        else:
            shape = tuple(
                args[0]) if len(args) == 1 and isinstance(
                args[0], (list, tuple)) else tuple(args)
            val = torch.zeros(shape, dtype=torch_dtype(dtype),
                              device=self.device)
        v = SDVariable(self, name, VariableType.VARIABLE,
                       tuple(val.shape), val.dtype)
        self._vars[name] = v
        self._values[name] = val
        return v

    def constant(self, name_or_value, value=None) -> SDVariable:
        if value is None:
            name, value = self._unique("const"), name_or_value
        else:
            name = self._unique(name_or_value)
        val = _to_tensor(value, self.device, copy=True)
        v = SDVariable(self, name, VariableType.CONSTANT,
                       tuple(val.shape), val.dtype)
        self._vars[name] = v
        self._values[name] = val
        return v

    def _as_var(self, x) -> SDVariable:
        if isinstance(x, SDVariable):
            if x.sd is not self:
                return self._capture_foreign(x)
            return x
        return self.constant(x)

    def _capture_foreign(self, var: SDVariable) -> SDVariable:
        """A body closure referenced a variable of ANOTHER graph (the
        parent, during control-flow body tracing): snapshot its current
        value into this graph as a captured constant — the captured-
        constant table that makes control-flow bodies serializable."""
        name = f"__cap_{var.name()}"
        if name in self._vars:
            return self._vars[name]
        src = var.sd
        if var.name() not in src._values:
            raise _CaptureError(
                f"control-flow body captures {var.name()!r}, which has no "
                f"value at build time (placeholders/op outputs cannot be "
                f"captured; pass them as explicit loop variables)")
        if var.variableType == VariableType.VARIABLE:
            # a snapshot would silently FREEZE the trainable param inside
            # the body (updates and gradients would never reach it)
            raise _CaptureError(
                f"control-flow body captures trainable variable "
                f"{var.name()!r}; a build-time snapshot would freeze it — "
                f"pass it as an explicit loop variable instead")
        val = src._values[var.name()].clone()
        v = SDVariable(self, name, VariableType.CONSTANT,
                       tuple(val.shape), val.dtype)
        self._vars[name] = v
        self._values[name] = val
        return v

    def convertToConstant(self, var: SDVariable):
        var.variableType = VariableType.CONSTANT
        return var

    def convertToVariable(self, var: SDVariable):
        var.variableType = VariableType.VARIABLE
        return var

    def _rename(self, old: str, new: str):
        if new in self._vars:
            raise ValueError(f"variable {new!r} already exists")
        v = self._vars.pop(old)
        v._name = new
        self._vars[new] = v
        if old in self._values:
            self._values[new] = self._values.pop(old)
        if old in self._producer:
            self._producer[new] = self._producer.pop(old)
        for op_ in self._ops:
            op_.inputs = [new if n == old else n for n in op_.inputs]
            op_.outputs = [new if n == old else n for n in op_.outputs]
        self._loss_vars = [new if n == old else n for n in self._loss_vars]
        self._invalidate()

    # -- op construction ----------------------------------------------------
    @staticmethod
    def _check_op(fn_name: str):
        """Refuse an op the registry lacks when the graph is built (or
        loaded), never when it runs."""
        if fn_name not in OPS:
            raise ValueError(f"unknown op {fn_name!r}")

    def _op(self, fn_name: str, inputs: list, attrs: dict | None = None,
            name: str | None = None, n_out: int | None = None):
        self._check_op(fn_name)
        attrs = {k: v for k, v in (attrs or {}).items() if v is not None}
        n_out = n_out or self.MULTI_OUTPUT_OPS.get(fn_name, 1)
        base = name or fn_name
        out_names = [
            self._unique(base if i == 0 else f"{base}:{i}")
            for i in range(n_out)
        ]
        op_idx = len(self._ops)
        self._ops.append(Op(fn_name, [v.name() for v in inputs],
                            out_names, attrs))
        outs = []
        for on in out_names:
            v = SDVariable(self, on, VariableType.ARRAY)
            self._vars[on] = v
            self._producer[on] = op_idx
            outs.append(v)
        self._invalidate()
        return outs[0] if n_out == 1 else tuple(outs)

    def _invalidate(self):
        """Drop the train step after a graph mutation."""
        self._train_step_fn = None

    # convenience graph ops on sd itself
    def one_hot(self, x, depth, name=None):
        return self._op("oneHot", [self._as_var(x)], {"depth": depth}, name)

    def gather(self, x, indices, axis=0, name=None):
        return self._op("gather", [self._as_var(x), self._as_var(indices)],
                        {"axis": axis}, name)

    def concat(self, dim, *vars_, name=None):
        return self._op("concat", [self._as_var(v) for v in vars_],
                        {"dimension": dim}, name)

    def stack(self, axis, *vars_, name=None):
        return self._op("stack", [self._as_var(v) for v in vars_],
                        {"axis": axis}, name)

    def unstack(self, x, axis, num, name=None):
        return self._op("unstack", [self._as_var(x)],
                        {"axis": axis, "num": num}, name, n_out=num)

    def split(self, x, numSplit, dimension, name=None):
        return self._op("split", [self._as_var(x)],
                        {"numSplit": numSplit, "dimension": dimension},
                        name, n_out=numSplit)

    def stridedSlice(self, x, begin, end, strides=None, name=None):
        return self._op("stridedSlice", [self._as_var(x)],
                        {"begin": list(begin), "end": list(end),
                         "strides": list(strides) if strides else None}, name)

    def expandDims(self, x, axis, name=None):
        return self._op("expandDims", [self._as_var(x)], {"axis": axis}, name)

    def squeeze(self, x, axis, name=None):
        return self._op("squeeze", [self._as_var(x)], {"axis": axis}, name)

    def where(self, cond, x, y, name=None):
        return self._op("where_op",
                        [self._as_var(cond), self._as_var(x), self._as_var(y)],
                        {}, name)

    def identity(self, x, name=None):
        return self._op("identity", [self._as_var(x)], {}, name)

    # -- control flow (reference: SDBaseOps.whileLoop/ifCond). Bodies are
    # Python callables; at build time each body is TRACED over child-graph
    # placeholder SDVariables into a named sub-SameDiff graph (closure-
    # captured outer constants become a captured-constant table), so
    # graphs holding control flow serialize like any other op. Bodies that
    # escape the SDVariable surface (raw torch calls) fall back to the
    # callable itself: they run and differentiate but cannot be save()d.
    def _body_attrs(self, graph_key: str, fn, n_args: int) -> dict:
        fn_key, squeeze = _SUBGRAPH_ATTRS[graph_key]
        try:
            sub = _trace_subgraph(fn, n_args, self.device)
            return {graph_key: sub, fn_key: sub.callable(squeeze=squeeze)}
        except _CaptureError as e:
            raise ValueError(str(e)) from e
        except _TraceUnsupported:
            return {fn_key: fn}

    def whileLoop(self, condBody, loopBody, *loopVars, name=None):
        """loopVars -> final vars after `while condBody(*v): v =
        loopBody(*v)`."""
        vs = [self._as_var(v) for v in loopVars]
        attrs = self._body_attrs("cond_graph", condBody, len(vs))
        attrs.update(self._body_attrs("body_graph", loopBody, len(vs)))
        return self._op("whileLoop", vs, attrs,
                        name, n_out=len(vs) if len(vs) > 1 else 1)

    def ifCond(self, predicate, trueBody, falseBody, *operands, name=None,
               n_out=1):
        ops_ = [self._as_var(v) for v in operands]
        attrs = self._body_attrs("true_graph", trueBody, len(ops_))
        attrs.update(self._body_attrs("false_graph", falseBody, len(ops_)))
        return self._op("ifCond", [self._as_var(predicate)] + ops_,
                        attrs, name, n_out=n_out)

    def scan(self, body, init, xs, name=None):
        """body(carry, x) -> (carry, y) over the leading axis of xs.
        Returns (final_carry, stacked_ys)."""
        return self._op("scanOp", [self._as_var(init), self._as_var(xs)],
                        self._body_attrs("body_graph", body, 2),
                        name, n_out=2)

    def forLoop(self, n, body, *loopVars, name=None):
        """n fixed iterations of body(i, *vars)."""
        vs = [self._as_var(v) for v in loopVars]
        attrs = {"n": int(n)}
        attrs.update(self._body_attrs("body_graph", body, 1 + len(vs)))
        return self._op("forLoop", vs, attrs,
                        name, n_out=len(vs) if len(vs) > 1 else 1)

    def getVariable(self, name: str) -> SDVariable:
        return self._vars[name]

    def hasVariable(self, name: str) -> bool:
        return name in self._vars

    def variables(self):
        return [v for v in self._vars.values()
                if v.variableType == VariableType.VARIABLE]

    def variableNames(self):
        return [v.name() for v in self.variables()]

    def setLossVariables(self, *names):
        self._loss_vars = [n.name() if isinstance(n, SDVariable) else n
                           for n in names]
        self._train_step_fn = None

    def getLossVariables(self):
        return list(self._loss_vars)

    # -- execution core -----------------------------------------------------
    def _needed_ops(self, wanted: Sequence[str]) -> list[int]:
        needed: set[int] = set()
        stack = [n for n in wanted if n in self._producer]
        while stack:
            n = stack.pop()
            idx = self._producer.get(n)
            if idx is None or idx in needed:
                continue
            needed.add(idx)
            for inp in self._ops[idx].inputs:
                if inp in self._producer:
                    stack.append(inp)
        return sorted(needed)

    def _make_fn(self, outputs: tuple, training: bool):
        """fn(placeholders, params, consts, rng) -> {output: tensor}, which
        runs the ops the outputs need in graph order; ``rng`` (an int)
        seeds the random ops' generators with each op's index."""
        op_indices = self._needed_ops(outputs)

        def fn(placeholders: dict, params: dict, consts: dict, rng):
            env = dict(consts)
            env.update(params)
            env.update(placeholders)
            for idx in op_indices:
                o = self._ops[idx]
                # *_graph attrs are the serializable sub-graph bodies; the
                # ops consume only the *_fn callables
                kwargs = {k: v for k, v in o.attrs.items()
                          if not k.endswith("_graph")}
                fn_name = o.fn_name
                if fn_name in RANDOM_OPS:
                    kwargs["generator"] = self._generator(rng, idx)
                if fn_name in TRAINING_AWARE_OPS:
                    kwargs["training"] = training
                if fn_name in DEVICE_OPS:
                    kwargs["device"] = self.device
                try:
                    args = [env[i] for i in o.inputs]
                except KeyError as e:
                    raise ValueError(
                        f"op {fn_name!r} ({o.outputs[0]!r}) needs "
                        f"{e.args[0]!r}, which was not fed") from None
                res = OPS[fn_name](*args, **kwargs)
                if len(o.outputs) == 1:
                    env[o.outputs[0]] = res
                else:
                    for on, r in zip(o.outputs, res):
                        env[on] = r
            return {n: env[n] for n in outputs}

        return fn

    def _split_values(self):
        params, consts = {}, {}
        for n, v in self._values.items():
            if self._vars[n].variableType == VariableType.VARIABLE:
                params[n] = v
            else:
                consts[n] = v
        return params, consts

    def _feeds(self, feeds: dict) -> dict:
        return {k: _to_tensor(v, self.device) for k, v in feeds.items()}

    def output(self, feeds: dict, *outputs) -> dict:
        """Run the graph for the requested outputs (InferenceSession
        capability), under ``torch.inference_mode()``."""
        names = tuple(
            o.name() if isinstance(o, SDVariable) else o for o in outputs
        )
        feeds = self._feeds(feeds)
        params, consts = self._split_values()
        with torch.inference_mode():
            res = self._make_fn(names, False)(feeds, params, consts,
                                              self._seed)
        return {k: INDArray(v) for k, v in res.items()}

    def batchOutput(self):
        return _BatchOutputBuilder(self)

    def outputSingle(self, feeds: dict, output) -> INDArray:
        name = output.name() if isinstance(output, SDVariable) else output
        return self.output(feeds, name)[name]

    def exec_all(self, feeds: dict) -> dict:
        names = tuple(self._vars)
        return self.output(feeds, *names)

    # -- gradients -----------------------------------------------------------
    def _loss_value(self, outs: dict):
        total = 0.0
        for lv in (self._loss_vars or list(outs)):
            total = total + torch.sum(outs[lv])
        return total

    @staticmethod
    def _grads(loss, leaves: dict) -> dict:
        """d loss / d each leaf; zeros for a leaf the loss does not reach
        (as jax.grad gives)."""
        if isinstance(loss, torch.Tensor) and loss.requires_grad:
            gs = torch.autograd.grad(loss, list(leaves.values()),
                                     allow_unused=True)
        else:
            gs = [None] * len(leaves)
        return {n: torch.zeros_like(t) if g is None else g
                for (n, t), g in zip(leaves.items(), gs)}

    def calculateGradients(self, feeds: dict, *wrt) -> dict:
        """Analytic gradients of the summed loss variables w.r.t. the given
        placeholders and VARIABLEs (autograd over the eager run)."""
        if not self._loss_vars:
            raise ValueError("no loss variables; call setLossVariables/markAsLoss")
        wrt_names = [w.name() if isinstance(w, SDVariable) else w for w in wrt]
        feeds = self._feeds(feeds)
        params, consts = self._split_values()

        diff_feeds = [n for n in wrt_names if n in feeds]
        diff_params = [n for n in wrt_names if n in params]
        missing = [n for n in wrt_names
                   if n not in diff_feeds and n not in diff_params]
        if missing:
            raise ValueError(
                f"cannot differentiate w.r.t. {missing}: each name must be a "
                f"fed placeholder or a VARIABLE (constants/ARRAY outputs are "
                f"not differentiable targets)")

        fwd = self._make_fn(tuple(self._loss_vars), False)
        with torch.enable_grad():
            leaves = {}
            for n in diff_feeds:
                feeds[n] = leaves[n] = feeds[n].detach().requires_grad_(True)
            for n in diff_params:
                params[n] = leaves[n] = \
                    params[n].detach().requires_grad_(True)
            loss = self._loss_value(fwd(feeds, params, consts, self._seed))
            grads = self._grads(loss, leaves)
        return {k: INDArray(grads[k]) for k in diff_feeds + diff_params}

    # -- training ------------------------------------------------------------
    def setProfilerConfig(self, cfg):
        """The NaN/Inf panic checks of the profiler come with the
        telemetry slice."""
        raise NotImplementedError(
            "setProfilerConfig comes with the telemetry slice (ROADMAP.md "
            "queue 1 item 13)")

    def setTrainingConfig(self, cfg: TrainingConfig):
        self.trainingConfig = cfg
        if cfg.lossVariables:
            self._loss_vars = list(cfg.lossVariables)
        self._updater_state = None
        self._train_step_fn = None

    def _build_train_step(self):
        """step_fn(params, opt_state, consts, feeds, rng, step) -> (loss,
        opt_state): forward and backward with autograd, then the updater;
        the parameter tensors are updated in place."""
        cfg = self.trainingConfig
        loss_names = tuple(self._loss_vars)
        fwd = self._make_fn(loss_names, True)
        updater = cfg.updater

        def step_fn(params, opt_state, consts, feeds, rng, step):
            with torch.enable_grad():
                leaves = {n: p.detach().requires_grad_(True)
                          for n, p in params.items()}
                loss = self._loss_value(fwd(feeds, leaves, consts, rng))
                if cfg.l2 > 0:
                    loss = loss + cfg.l2 * sum(
                        torch.sum(w * w) for w in tree_leaves(leaves))
                if cfg.l1 > 0:
                    loss = loss + cfg.l1 * sum(
                        torch.sum(torch.abs(w)) for w in tree_leaves(leaves))
                if not cfg.minimize:
                    loss = -loss
                grads = self._grads(loss, leaves)
            with torch.no_grad():
                if cfg.weightDecay > 0:
                    grads = {n: g + cfg.weightDecay * params[n]
                             for n, g in grads.items()}
                updates, opt_state = updater.apply(grads, opt_state, params,
                                                   step)
                for n, u in updates.items():
                    params[n].sub_(u)
            return loss.detach(), opt_state

        return step_fn

    def fit(self, data=None, epochs: int = 1, listeners=()) -> History:
        """data: iterable of DataSet-like ((features, labels) tuples or
        objects with .getFeatures()/.getLabels()), or a single such batch."""
        if self.trainingConfig is None:
            raise ValueError("call setTrainingConfig first")
        cfg = self.trainingConfig
        if not self._loss_vars:
            raise ValueError("no loss variables set")
        if getattr(self, "_train_step_fn", None) is None:
            self._train_step_fn = self._build_train_step()

        history = History()
        params, consts = self._split_values()
        if self._updater_state is None:
            self._updater_state = cfg.updater.init_state(params)
        opt_state = self._updater_state

        for epoch in range(epochs):
            batches = _as_batches(data)
            if epoch == 0 and not hasattr(data, "reset") and not isinstance(
                batches, (list, tuple)
            ):
                # one-shot iterable (generator): materialize so later epochs
                # see the data instead of silently training on nothing
                batches = list(batches)
                data = batches
            epoch_losses = []
            for ds in batches:
                feats, labels = _split_dataset(ds)
                feeds = {}
                fmap = list(cfg.dataSetFeatureMapping)
                lmap = list(cfg.dataSetLabelMapping)
                for name, arr in zip(fmap, feats):
                    feeds[name] = _to_tensor(arr, self.device)
                for name, arr in zip(lmap, labels):
                    feeds[name] = _to_tensor(arr, self.device)
                loss, opt_state = self._train_step_fn(
                    params, opt_state, consts, feeds,
                    _seed_of(self._seed + 7, self._step), self._step
                )
                self._updater_state = opt_state
                self._step += 1
                epoch_losses.append(loss)  # a device scalar; no sync here
                if listeners:
                    lv = float(loss)
                    for listener in listeners:
                        if hasattr(listener, "iterationDone"):
                            listener.iterationDone(self, self._step, epoch, lv)
            if not epoch_losses:
                raise ValueError(
                    f"epoch {epoch}: data yielded no batches (exhausted "
                    f"iterator or empty dataset)")
            epoch_losses = [float(l) for l in epoch_losses]
            history.iterLosses.extend(epoch_losses)
            history.lossCurve.append(float(np.mean(epoch_losses)))
        return history

    # -- serde (reference: SameDiff.save/load flatbuffers .fb; here the
    # reference package's zip of graph JSON + npz values; control-flow
    # bodies serialize as nested sub-graph dicts) -------------------------
    def _graph_dict(self, value_sink=None, prefix="__sub__/") -> dict:
        return {
            "variables": [
                {
                    "name": v.name(),
                    "type": v.variableType.value,
                    "shape": list(v._shape) if v._shape else None,
                    "dtype": _dtype_name(v.dtype) if v.dtype else "float32",
                }
                for v in self._vars.values()
            ],
            "ops": [
                {"fn": o.fn_name, "inputs": o.inputs, "outputs": o.outputs,
                 "attrs": _json_attrs(o.attrs, value_sink,
                                      prefix=f"{prefix}op{i}/")}
                for i, o in enumerate(self._ops)
            ],
            "lossVariables": self._loss_vars,
        }

    @staticmethod
    def _from_graph_dict(graph: dict, value_source=None,
                         device=None) -> "SameDiff":
        sd = SameDiff(device)
        for vd in graph["variables"]:
            v = SDVariable(
                sd, vd["name"], VariableType(vd["type"]),
                tuple(vd["shape"]) if vd["shape"] else None,
                torch_dtype(vd["dtype"]),
            )
            sd._vars[vd["name"]] = v
        for i, od in enumerate(graph["ops"]):
            SameDiff._check_op(od["fn"])
            sd._ops.append(Op(od["fn"], od["inputs"], od["outputs"],
                              _attrs_from_json(od["attrs"], value_source,
                                               sd.device)))
            for on in od["outputs"]:
                sd._producer[on] = i
        sd._loss_vars = graph.get("lossVariables", [])
        return sd

    def save(self, path: str, saveUpdaterState: bool = False):
        # control-flow sub-graph values (captured constants can be weight-
        # sized) ride the binary npz under "__sub__/"-prefixed keys, not
        # the JSON
        vals = {k: _host(v) for k, v in self._values.items()}
        graph = self._graph_dict(value_sink=vals)
        graph.update({
            "trainingConfig": (self.trainingConfig.to_json()
                               if self.trainingConfig else None),
            "step": self._step,
        })
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr("graph.json", json.dumps(graph, indent=1))
            buf = io.BytesIO()
            np.savez(buf, **vals)
            zf.writestr("values.npz", buf.getvalue())
            if saveUpdaterState and self._updater_state is not None:
                leaves = tree_leaves(self._updater_state)
                sbuf = io.BytesIO()
                np.savez(sbuf, **{str(i): _host(l)
                                  for i, l in enumerate(leaves)})
                zf.writestr("updater_state.npz", sbuf.getvalue())

    @staticmethod
    def load(path: str, loadUpdaterState: bool = False,
             device=None) -> "SameDiff":
        with zipfile.ZipFile(path) as zf:
            graph = json.loads(zf.read("graph.json"))
            values = np.load(io.BytesIO(zf.read("values.npz")))
            sd = SameDiff._from_graph_dict(graph, value_source=values,
                                           device=device)
            for k in values.files:
                if not k.startswith("__sub__/"):
                    sd._values[k] = _to_tensor(values[k], sd.device)
            sd._step = graph.get("step", 0)
            if graph.get("trainingConfig"):
                sd.trainingConfig = TrainingConfig.from_json(
                    graph["trainingConfig"])
            if loadUpdaterState and "updater_state.npz" in zf.namelist():
                params, _ = sd._split_values()
                proto = sd.trainingConfig.updater.init_state(params)
                data = np.load(io.BytesIO(zf.read("updater_state.npz")))
                n = len(tree_leaves(proto))
                sd._updater_state = tree_fill(proto, iter(
                    _to_tensor(data[str(i)], sd.device) for i in range(n)))
        return sd

    def summary(self) -> str:
        lines = [f"SameDiff: {len(self._vars)} variables, {len(self._ops)} ops"]
        for v in self._vars.values():
            if v.variableType != VariableType.ARRAY:
                lines.append(
                    f"  {v.variableType.value:<12} {v.name():<24} {v._shape}"
                )
        for o in self._ops:
            lines.append(
                f"  op {o.fn_name:<20} {','.join(o.inputs)} -> "
                f"{','.join(o.outputs)}"
            )
        return "\n".join(lines)


class _BatchOutputBuilder:
    def __init__(self, sd: SameDiff):
        self.sd = sd
        self._feeds = {}
        self._outputs = []

    def input(self, name, value):
        self._feeds[name.name() if isinstance(name, SDVariable) else name] = value
        return self

    def output(self, *names):
        self._outputs.extend(
            n.name() if isinstance(n, SDVariable) else n for n in names
        )
        return self

    def execute(self) -> dict:
        return self.sd.output(self._feeds, *self._outputs)

    def exec(self) -> dict:
        return self.execute()


def _json_attrs(attrs: dict, value_sink=None, prefix="") -> dict:
    # callables whose sub-graph representation exists serialize as the
    # graph; a callable WITHOUT one is a non-traceable body -> still a
    # hard error (same boundary the reference draws at FlatBuffers
    # function defs)
    graph_backed = {_SUBGRAPH_ATTRS[k][0] for k in attrs
                    if k in _SUBGRAPH_ATTRS}
    out = {}
    for k, v in attrs.items():
        if k in graph_backed:
            continue  # rebuilt from the sub-graph on load
        if isinstance(v, SubGraph):
            out[k] = {"__subgraph__": v.to_dict(value_sink,
                                                prefix=f"{prefix}{k}/")}
            continue
        if callable(v) and not isinstance(v, (type, np.dtype)):
            raise ValueError(
                "graph holds a control-flow op whose body could not be "
                "traced into a sub-graph (it escapes the SDVariable op "
                "surface, e.g. by calling torch functions directly); such "
                "graphs run but cannot be serialized — rewrite the body "
                "over SDVariable ops to make it saveable")
        if isinstance(v, tuple):
            v = list(v)
        elif isinstance(v, (torch.Tensor, np.ndarray)):
            v = _host(v).tolist()
        elif isinstance(v, (np.integer, np.floating)):
            v = v.item()
        else:
            try:
                json.dumps(v)
            except TypeError:
                v = _dtype_name(v)  # dtypes and dtype-like objects
        out[k] = v
    return out


def _attrs_from_json(attrs: dict, value_source=None, device=None) -> dict:
    """Inverse of _json_attrs: rebuild SubGraph bodies and their runtime
    callables from nested sub-graph dicts."""
    out = {}
    for k, v in attrs.items():
        if isinstance(v, dict) and "__subgraph__" in v:
            sub = SubGraph.from_dict(v["__subgraph__"], value_source, device)
            out[k] = sub
            fn_key, squeeze = _SUBGRAPH_ATTRS[k]
            out[fn_key] = sub.callable(squeeze=squeeze)
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# the batch helpers of fit (MultiLayerNetwork.fit shares them)
# ---------------------------------------------------------------------------

def _host_array(x, dtype=None):
    """Host numpy array of a batch: free for numpy, a copy for a tensor
    or an INDArray (which may lie on the GPU)."""
    if isinstance(x, INDArray):
        x = x.torch()
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def _prepare_batches(data, epoch_i, epochs):
    """Batches for one epoch. Materializes a one-shot iterable (generator)
    on the first epoch so later epochs see the data instead of silently
    training on nothing. Returns (batches, data) — rebind data to the
    second element."""
    batches = _as_batches(data)
    if (epoch_i == 0 and epochs > 1 and not hasattr(data, "reset")
            and not isinstance(batches, (list, tuple))):
        batches = list(batches)
        data = batches
    return batches, data


def _ones_mask(labels):
    """Example mask of ones matching the loss's per-example view: [N, T]
    for NCW time-series labels, else [N]."""
    if labels.ndim == 3:
        return np.ones((labels.shape[0], labels.shape[2]), np.float32)
    return np.ones((labels.shape[0],), np.float32)


def _pad_to_bucket(arrs, mask, bucket):
    """Pad batch axis of every array (numpy, or a tensor on its device)
    and the mask up to `bucket` rows by repeating the last row; padding
    rows get mask 0 so they cannot bias the loss. A ragged final
    minibatch then runs at the bucket's shape, as in the JAX package,
    where that keeps one compiled step."""
    n = arrs[0].shape[0]
    if n == bucket:
        return arrs, mask, n
    pad = bucket - n
    out = []
    for a in arrs:
        if isinstance(a, torch.Tensor):   # a batch staged on its device
            out.append(torch.cat([a, a[-1:].expand(pad, *a.shape[1:])]))
            continue
        a = np.asarray(a)
        out.append(np.concatenate([a, np.repeat(a[-1:], pad, axis=0)],
                                  axis=0))
    if isinstance(mask, torch.Tensor):
        mask = torch.cat([mask, mask.new_zeros((pad, *mask.shape[1:]))])
    else:
        mask = np.concatenate(
            [np.asarray(mask),
             np.zeros((pad,) + np.asarray(mask).shape[1:], np.float32)],
            axis=0)
    return out, mask, n


def _as_batches(data):
    if data is None:
        raise ValueError("fit() requires data")
    if isinstance(data, (tuple,)) and len(data) == 2 and not isinstance(
        data[0], (tuple, list)
    ):
        return [data]
    if hasattr(data, "getFeatures") or hasattr(data, "features"):
        return [data]
    if hasattr(data, "reset"):
        data.reset()
    return data


def _split_dataset(ds):
    """Accept (features, labels) tuples, DataSet-like objects, or
    MultiDataSet-like (lists of arrays)."""
    if isinstance(ds, tuple) and len(ds) == 2:
        f, l = ds
    elif hasattr(ds, "getFeatures"):
        f, l = ds.getFeatures(), ds.getLabels()
    else:
        f, l = ds.features, ds.labels
    if not isinstance(f, (list, tuple)):
        f = [f]
    if not isinstance(l, (list, tuple)):
        l = [l]
    return f, l


def _split_dataset_full(ds):
    """Like _split_dataset but also returns (featuresMasks, labelsMasks)
    lists (None entries when absent). Reference: DataSet.getFeaturesMaskArray
    / getLabelsMaskArray — masks mark valid timesteps for variable-length
    sequences and MUST reach the loss (SURVEY.md §2.5 masking row)."""
    f, l = _split_dataset(ds)
    fm = lm = None
    if hasattr(ds, "getFeaturesMaskArray"):
        fm = ds.getFeaturesMaskArray()
        lm = ds.getLabelsMaskArray()
    elif hasattr(ds, "featuresMasks"):
        fm, lm = ds.featuresMasks, ds.labelsMasks
    elif hasattr(ds, "featuresMask"):
        fm, lm = ds.featuresMask, ds.labelsMask
    if not isinstance(fm, (list, tuple)):
        fm = [fm] * len(f) if fm is None else [fm]
    if not isinstance(lm, (list, tuple)):
        lm = [lm] * len(l) if lm is None else [lm]
    return f, l, fm, lm
