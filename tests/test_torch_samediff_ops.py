"""The port's op registry against the JAX package's, op by op.

Every op of the reference's ``autodiff/ops.py:61-1150`` (172 names: the
167 ported with SameDiff and the 5 recurrent ops before them) is called
in both packages on the same seeded numpy inputs and attributes:

- forward: each output to 1e-5 of the reference's largest element
  (float32 on the CPU), NaN where the reference has NaN, the same dtype;
- for each differentiable op, the gradient of a weighted sum of its
  outputs w.r.t. its float inputs (``jax.grad`` against
  ``torch.autograd.grad``) to 1e-4 of the largest element;
- random ops by shape, dtype, range and moments over 20000 draws (they
  take a ``torch.Generator`` where the reference takes a key, so they
  never agree by seed);
- ``gather``'s rule for ids outside the range (a negative id wraps once,
  anything still outside gives NaN rows), with no device assert;
- the port's registry, random, training-aware and device flags are the
  reference's whole registry's (the names past line 1150 have their
  cases in ``tests/test_torch_samediff_ops_2b.py``).
"""

import zlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.autodiff import ops as jax_ops
from deeplearning4j_tpu_torch.autodiff import ops

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
DRAWS = 20000


class Inputs:
    """Seeded numpy inputs for one case."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def f(self, *shape, lo=-1.0, hi=1.0):
        return self.rng.uniform(lo, hi, size=shape).astype(np.float32)

    def pos(self, *shape):
        return self.f(*shape, lo=0.5, hi=2.0)

    def ints(self, hi, *shape, lo=0):
        return self.rng.integers(lo, hi, size=shape).astype(np.int32)

    def bools(self, *shape):
        return self.rng.uniform(size=shape) < 0.5


# (op, variant, build(Inputs) -> (inputs, attrs), grad): grad None
# differentiates every float input, a tuple names the input positions,
# () skips the gradient check
def _cases():
    c = []

    def add(name, build, grad=None, variant=""):
        c.append((name, variant, build, grad))

    for name in ("add", "sub", "mul", "rsub", "maximum", "minimum",
                 "squaredDifference"):
        add(name, lambda r: ([r.f(3, 4), r.f(3, 4)], {}))
    add("add", lambda r: ([r.f(3, 4), r.f(4)], {}), variant="broadcast")
    for name in ("div", "rdiv"):
        add(name, lambda r: ([r.pos(3, 4), r.pos(3, 4)], {}))
    add("pow", lambda r: ([r.pos(3, 4), r.f(3, 4)], {}))
    add("floordiv", lambda r: ([r.f(3, 4, lo=-5, hi=5), r.pos(3, 4)], {}),
        grad=())
    add("mod", lambda r: ([r.f(3, 4, lo=-5, hi=5), r.pos(3, 4)], {}))
    for name in ("identity", "neg", "abs", "exp", "square", "sin", "cos",
                 "atan", "sinh", "cosh", "tanh", "erf"):
        add(name, lambda r: ([r.f(3, 4)], {}))
    for name in ("log", "log1p", "sqrt", "rsqrt", "reciprocal"):
        add(name, lambda r: ([r.pos(3, 4)], {}))
    for name in ("asin", "acos"):
        add(name, lambda r: ([r.f(3, 4, lo=-0.9, hi=0.9)], {}))
    add("tan", lambda r: ([r.f(3, 4, lo=-1.2, hi=1.2)], {}))
    for name in ("sign", "floor", "ceil", "round"):
        add(name, lambda r: ([r.f(3, 4, lo=-3, hi=3)], {}), grad=())
    add("round", lambda r: ([np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5],
                                      np.float32)], {}),
        grad=(), variant="half-even")
    for name in ("isnan", "isinf"):
        add(name, lambda r: ([np.array([0.0, np.nan, np.inf, -np.inf, 1.0],
                                       np.float32)], {}), grad=())
    for name in ("sigmoid", "relu", "elu", "selu", "gelu", "softplus",
                 "softsign", "swish", "mish", "hardTanh", "rationalTanh",
                 "rectifiedTanh"):
        add(name, lambda r: ([r.f(3, 5, lo=-3, hi=3)], {}))
    add("relu6", lambda r: ([r.f(3, 5, lo=-8, hi=8)], {}))
    add("hardSigmoid", lambda r: ([r.f(3, 5, lo=-5, hi=5)], {}))
    add("leakyRelu", lambda r: ([r.f(3, 5)], {"alpha": 0.2}))
    add("prelu", lambda r: ([r.f(3, 5), r.f(5)], {}))
    add("thresholdRelu", lambda r: ([r.f(3, 5)], {"cutoff": 0.3}))
    add("clipByValue", lambda r: ([r.f(3, 5)], {"clipValueMin": -0.5,
                                                "clipValueMax": 0.7}))
    add("clipByNorm", lambda r: ([r.f(3, 5)], {"clipValue": 1.0}))
    add("clipByNorm", lambda r: ([r.f(3, 5)], {"clipValue": 0.8,
                                               "dims": [1]}),
        variant="dims")
    # at the kinks, where jnp.maximum/clip split the gradient evenly
    kinks = lambda r: ([np.array([[-1.0, 0.0, 1.0, -0.5, 0.7, 2.0]],
                                 np.float32)], {})
    for name in ("hardTanh", "leakyRelu", "rectifiedTanh", "relu", "relu6",
                 "elu", "thresholdRelu", "abs", "norm1", "normMax"):
        add(name, kinks, variant="kinks")
    add("clipByValue", lambda r: (kinks(r)[0], {"clipValueMin": -0.5,
                                                "clipValueMax": 0.7}),
        variant="kinks")
    add("sigmoidCrossEntropy", lambda r: ([np.zeros((4, 3), np.float32),
                                           r.bools(4, 3).astype(
                                               np.float32)], {}),
        grad=(0,), variant="zero-logits")
    add("absoluteDifference", lambda r: ([np.array([[1.0, -1.0, 0.5]],
                                                   np.float32),
                                          np.array([[1.0, 0.0, 0.5]],
                                                   np.float32)], {}),
        variant="kinks")
    add("huberLoss", lambda r: ([np.array([[1.0, -1.0, 0.5]], np.float32),
                                 np.array([[1.0, 0.0, -0.5]], np.float32)],
                                {}), variant="kinks")
    add("hingeLoss", lambda r: ([np.array([[1.0, -1.0, 0.5]], np.float32),
                                 np.array([[1.0, 0.0, 1.0]], np.float32)],
                                {}), grad=(0,), variant="kinks")
    add("softmax", lambda r: ([r.f(3, 5)], {}))
    add("softmax", lambda r: ([r.f(3, 5)], {"dimension": 0}), variant="dim0")
    add("logSoftmax", lambda r: ([r.f(3, 5)], {"dimension": 1}))
    add("softmaxDerivative", lambda r: ([r.f(3, 5), r.f(3, 5)], {}))
    # reductions
    for name in ("sum", "mean", "max", "min", "norm1", "norm2", "normMax",
                 "logSumExp"):
        add(name, lambda r: ([r.f(3, 4, 5)], {}))
        add(name, lambda r: ([r.f(3, 4, 5)], {"dimensions": [1, 2],
                                              "keepDims": True}),
            variant="dims")
    add("prod", lambda r: ([r.pos(3, 4)], {}))
    for name in ("sum", "prod", "cumsum", "cumprod"):
        add(name, lambda r: ([r.ints(4, 3, 4, lo=-3)], {}), grad=(),
            variant="int32")
        add(name, lambda r: ([r.bools(3, 4)], {}), grad=(), variant="bool")
    add("prod", lambda r: ([r.pos(3, 4)], {"dimensions": [0]}),
        variant="dims")
    for name in ("any", "all"):
        add(name, lambda r: ([r.bools(3, 4)], {}), grad=())
        add(name, lambda r: ([r.bools(3, 4)], {"dimensions": [1],
                                               "keepDims": True}),
            grad=(), variant="dims")
    add("countNonZero", lambda r: ([r.ints(3, 3, 4).astype(np.float32)],
                                   {"dimensions": [1]}), grad=())
    add("zeroFraction", lambda r: ([r.ints(3, 3, 4).astype(np.float32)], {}),
        grad=())
    for name in ("variance", "standardDeviation"):
        add(name, lambda r: ([r.f(3, 4)], {}))
        add(name, lambda r: ([r.f(3, 4)], {"dimensions": [1],
                                           "biasCorrected": False,
                                           "keepDims": True}),
            variant="dims")
    for name in ("argmax", "argmin"):
        add(name, lambda r: ([r.f(3, 4)], {}), grad=())
        add(name, lambda r: ([r.f(3, 4)], {"dimension": 1,
                                           "keepDims": True}),
            grad=(), variant="dim")
    add("cumsum", lambda r: ([r.f(3, 4)], {"axis": 1}))
    add("cumsum", lambda r: ([r.f(3, 4)], {"axis": 1, "exclusive": True,
                                           "reverse": True}),
        variant="exclusive-reverse")
    add("cumprod", lambda r: ([r.pos(3, 4)], {"axis": 0}))
    add("moments", lambda r: ([r.f(3, 4)], {"dimensions": [0]}))
    # linalg
    add("matmul", lambda r: ([r.f(3, 4), r.f(4, 5)], {}))
    add("matmul", lambda r: ([r.f(4, 3), r.f(5, 4)], {"transposeA": True,
                                                      "transposeB": True}),
        variant="transposed")
    add("tensorMmul", lambda r: ([r.f(2, 3, 4), r.f(4, 3, 5)],
                                 {"axesA": [1, 2], "axesB": [1, 0]}))
    add("batchMmul", lambda r: ([r.f(2, 3, 4), r.f(2, 4, 5)], {}))
    add("dot", lambda r: ([r.f(3, 4), r.f(3, 4)], {}))
    add("dot", lambda r: ([r.f(3, 4), r.f(3, 4)], {"dimensions": [1]}),
        variant="dims")
    # shape and indexing
    add("reshape", lambda r: ([r.f(3, 4)], {"shape": [2, -1]}))
    add("permute", lambda r: ([r.f(2, 3, 4)], {"dimensions": [2, 0, 1]}))
    add("transpose", lambda r: ([r.f(2, 3, 4)], {}))
    add("expandDims", lambda r: ([r.f(3, 4)], {"axis": -1}))
    add("squeeze", lambda r: ([r.f(3, 1, 4)], {"axis": 1}))
    add("concat", lambda r: ([r.f(2, 3), r.f(4, 3)], {"dimension": 0}))
    add("stack", lambda r: ([r.f(2, 3), r.f(2, 3)], {"axis": 1}))
    add("unstack", lambda r: ([r.f(3, 4)], {"axis": 1}))
    add("split", lambda r: ([r.f(4, 6)], {"numSplit": 3, "dimension": 1}))
    add("slice", lambda r: ([r.f(5, 6)], {"begin": [1, 2], "size": [3, -1]}))
    add("slice", lambda r: ([r.f(5, 6)], {"begin": [4, 0], "size": [3, 2]}),
        variant="clamped")
    add("stridedSlice", lambda r: ([r.f(6, 7)], {"begin": [1, 0],
                                                 "end": [5, 7],
                                                 "strides": [2, 3]}))
    add("stridedSlice", lambda r: ([r.f(6, 7)], {"begin": [5, -1],
                                                 "end": [0, -8],
                                                 "strides": [-2, -1]}),
        variant="negative")
    add("tile", lambda r: ([r.f(2, 3)], {"reps": [2, 1, 3]}))
    add("pad", lambda r: ([r.f(3, 4)], {"paddings": [[1, 2], [0, 3]],
                                        "constant": 0.5}))
    for mode in ("REFLECT", "SYMMETRIC", "EDGE", "WRAP"):
        add("pad", lambda r, m=mode: ([r.f(3, 4)],
                                      {"paddings": [[2, 1], [1, 2]],
                                       "mode": m}), variant=mode.lower())
    add("reverse", lambda r: ([r.f(3, 4)], {"dimensions": [1]}))
    add("reverse", lambda r: ([r.f(3, 4)], {}), variant="all")
    add("gather", lambda r: ([r.f(5, 3), r.ints(5, 4, 2).astype(np.float32)],
                             {}), grad=(0,))
    add("gather", lambda r: ([r.f(3, 5, 2), r.ints(5, 4)], {"axis": 1}),
        grad=(0,), variant="axis1")
    add("gather", lambda r: ([r.f(4, 3), np.array([[5, -1], [-7, 2]],
                                                  np.float32)], {}),
        grad=(), variant="out-of-range")
    add("gatherNd", lambda r: ([r.f(4, 5, 2), np.array(
        [[0, 1], [3, 4], [-1, 2]], np.int32)], {}), grad=(0,))
    for name in ("scatterUpdate", "scatterAdd"):
        add(name, lambda r: ([r.f(5, 3), np.array([4, 0, -2], np.int32),
                              r.f(3, 3)], {}), grad=(0, 2))
        add(name, lambda r: ([r.f(5, 3), np.array([1, 7, -9], np.int32),
                              r.f(3, 3)], {}), grad=(),
            variant="out-of-range")
    add("oneHot", lambda r: ([np.array([0, 3, 1, 9, -1], np.float32)],
                             {"depth": 4}), grad=())
    add("oneHot", lambda r: ([r.ints(4, 2, 3)], {"depth": 4, "on": 2.0,
                                                 "off": -1.0, "axis": 0}),
        grad=(), variant="axis0")
    add("linspace", lambda r: ([], {"start": -1.0, "stop": 2.0, "num": 7}),
        grad=())
    add("range", lambda r: ([], {"start": 2, "limit": 11, "delta": 3}),
        grad=())
    add("range", lambda r: ([], {"start": 0.5, "limit": 2.0, "delta": 0.25}),
        grad=(), variant="float")
    add("shape_of", lambda r: ([r.f(2, 3, 4)], {}), grad=())
    add("cast", lambda r: ([r.f(3, 4, lo=-3, hi=3)], {"dtype": "int32"}),
        grad=())
    add("cast", lambda r: ([r.ints(5, 3, 4)], {"dtype": "float32"}),
        grad=(), variant="to-float")
    add("assign_op", lambda r: ([r.f(3, 4), r.f(4)], {}), grad=(1,))
    add("invertPermutation", lambda r: ([r.rng.permutation(6).astype(
        np.int32)], {}), grad=())
    add("sequenceMask", lambda r: ([np.array([0, 2, 5], np.int32)],
                                   {"maxLen": 4}), grad=())
    add("diag", lambda r: ([r.f(4)], {}))
    add("diag", lambda r: ([r.f(4, 4)], {}), variant="matrix")
    add("eye_op", lambda r: ([], {"n": 3, "m": 4}), grad=())
    add("meshgrid", lambda r: ([r.f(3), r.f(4)], {}))
    add("meshgrid", lambda r: ([r.f(3), r.f(4)], {"indexing": "ij"}),
        variant="ij")
    # comparisons and logic
    for name in ("eq", "neq", "gt", "gte", "lt", "lte"):
        add(name, lambda r: ([r.ints(3, 3, 4).astype(np.float32),
                              r.ints(3, 3, 4).astype(np.float32)], {}),
            grad=())
    for name in ("and_op", "or_op", "xor_op"):
        add(name, lambda r: ([r.bools(3, 4), r.bools(3, 4)], {}), grad=())
    add("not_op", lambda r: ([r.bools(3, 4)], {}), grad=())
    add("where_op", lambda r: ([r.ints(2, 3, 4).astype(np.float32),
                                r.f(3, 4), r.f(3, 4)], {}), grad=(1, 2))
    # normalization
    add("layerNorm", lambda r: ([r.f(3, 6), r.pos(6), r.f(6)], {}))
    add("layerNorm", lambda r: ([r.f(3, 6), r.pos(3, 1)],
                                {"channelwise_axis": 0, "epsilon": 1e-3}),
        variant="axis0")
    add("batchNorm", lambda r: ([r.f(2, 3, 4), r.f(3), r.pos(3), r.pos(3),
                                 r.f(3)], {}))
    add("standardize", lambda r: ([r.f(3, 6)], {}))
    add("standardize", lambda r: ([r.f(3, 6)], {"dimensions": [0, 1]}),
        variant="all")
    add("dropout", lambda r: ([r.f(3, 4)], {"p": 0.5}))
    # conv / pool
    add("conv2d", lambda r: ([r.f(2, 3, 7, 6), r.f(4, 3, 3, 2), r.f(4)],
                             {"strides": (2, 1), "padding": (1, 2),
                              "dilation": (1, 2)}))
    add("conv2d", lambda r: ([r.f(2, 3, 7, 6), r.f(4, 3, 3, 2)],
                             {"strides": (2, 3), "sameMode": True}),
        variant="same")
    add("depthwiseConv2d", lambda r: ([r.f(2, 3, 6, 6), r.f(2, 3, 3, 3),
                                       r.f(6)], {"padding": (1, 0)}))
    add("depthwiseConv2d", lambda r: ([r.f(2, 3, 7, 6), r.f(2, 3, 2, 3)],
                                      {"strides": 2, "sameMode": True}),
        variant="same")
    add("conv1d", lambda r: ([r.f(2, 3, 9), r.f(4, 3, 3), r.f(4)],
                             {"stride": 2, "padding": 1}))
    add("conv1d", lambda r: ([r.f(2, 3, 9), r.f(4, 3, 4)],
                             {"stride": 2, "sameMode": True}),
        variant="same")
    add("deconv2d", lambda r: ([r.f(2, 3, 4, 5), r.f(4, 3, 3, 3), r.f(4)],
                               {"strides": (2, 2), "padding": (1, 0)}))
    add("deconv2d", lambda r: ([r.f(2, 3, 4, 5), r.f(4, 3, 3, 2)],
                               {"strides": (2, 3), "sameMode": True}),
        variant="same")
    add("maxPooling2d", lambda r: ([r.f(2, 3, 7, 6)], {}))
    add("maxPooling2d", lambda r: ([r.f(2, 3, 7, 6)],
                                   {"kernel": (3, 3), "strides": (2, 2),
                                    "padding": (1, 1)}), variant="padded")
    add("maxPooling2d", lambda r: ([r.f(2, 3, 7, 6)],
                                   {"kernel": (3, 2), "strides": (2, 2),
                                    "sameMode": True}), variant="same")
    add("avgPooling2d", lambda r: ([r.f(2, 3, 7, 6)], {}))
    add("avgPooling2d", lambda r: ([r.f(2, 3, 7, 6)],
                                   {"kernel": (3, 3), "strides": (2, 2),
                                    "padding": (1, 1)}), variant="padded")
    add("avgPooling2d", lambda r: ([r.f(2, 3, 7, 6)],
                                   {"kernel": (3, 3), "strides": (2, 2),
                                    "padding": (1, 1),
                                    "includePadInAvg": True}),
        variant="include-pad")
    add("avgPooling2d", lambda r: ([r.f(2, 3, 7, 6)],
                                   {"kernel": (3, 2), "strides": (2, 2),
                                    "sameMode": True}), variant="same")
    add("conv3d", lambda r: ([r.f(2, 2, 5, 4, 6), r.f(3, 2, 2, 3, 2),
                              r.f(3)], {"strides": (1, 2, 1),
                                        "padding": (1, 0, 1)}))
    add("conv3d", lambda r: ([r.f(1, 2, 5, 4, 6), r.f(3, 2, 2, 3, 2)],
                             {"strides": 2, "sameMode": True}),
        variant="same")
    add("maxPooling3d", lambda r: ([r.f(2, 2, 5, 4, 6)], {}))
    add("maxPooling3d", lambda r: ([r.f(2, 2, 5, 4, 6)],
                                   {"kernel": 3, "strides": 2,
                                    "sameMode": True}), variant="same")
    add("avgPooling3d", lambda r: ([r.f(2, 2, 5, 4, 6)], {}))
    add("avgPooling3d", lambda r: ([r.f(2, 2, 5, 4, 6)],
                                   {"kernel": 3, "strides": 2,
                                    "padding": 1}), variant="padded")
    add("globalAvgPooling", lambda r: ([r.f(2, 3, 4, 5)], {}))
    add("upsampling2d", lambda r: ([r.f(2, 3, 2, 3)], {"size": (2, 3)}))
    add("im2col", lambda r: ([r.f(2, 3, 5, 6)], {"kernel": (2, 3),
                                                 "strides": (2, 1),
                                                 "padding": (1, 0)}))
    # recurrent (unroll is taken and ignored)
    add("lstmCell", lambda r: ([r.f(3, 4), r.f(3, 5), r.f(3, 5), r.f(4, 20),
                                r.f(5, 20), r.f(20)], {"forgetBias": 1.0}))
    add("gruCell", lambda r: ([r.f(3, 4), r.f(3, 5), r.f(4, 15), r.f(5, 15),
                               r.f(30)], {}))
    add("lstmLayer", lambda r: ([r.f(3, 4, 6), r.f(4, 20), r.f(5, 20),
                                 r.f(20)], {"forgetBias": 1.0,
                                            "unroll": 2}))
    add("gruLayer", lambda r: ([r.f(3, 4, 6), r.f(4, 15), r.f(5, 15),
                                r.f(30)], {"unroll": 8}))
    add("gruLayer", lambda r: ([r.f(3, 4, 6), r.f(4, 15), r.f(5, 15),
                                r.f(15)], {"resetAfter": False,
                                           "activation": "softsign"}),
        variant="reset-before")
    add("simpleRnnLayer", lambda r: ([r.f(3, 4, 6), r.f(4, 5), r.f(5, 5),
                                      r.f(5)], {"activation": "sin",
                                                "unroll": 3}))
    # attention
    add("dotProductAttention", lambda r: ([r.f(2, 3, 4), r.f(2, 5, 4),
                                           r.f(2, 5, 6)], {}))
    add("dotProductAttention", lambda r: ([r.f(2, 3, 4), r.f(2, 5, 4),
                                           r.f(2, 5, 6),
                                           r.ints(2, 2, 3, 5)],
                                          {"scaled": False}),
        grad=(0, 1, 2), variant="mask")
    add("multiHeadDotProductAttention",
        lambda r: ([r.f(2, 3, 8), r.f(2, 5, 8), r.f(2, 5, 8), r.f(8, 8),
                    r.f(8, 8), r.f(8, 8), r.f(8, 8),
                    np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.int32)],
                   {"numHeads": 2}), grad=(0, 1, 2, 3, 4, 5, 6))
    # losses
    onehot = lambda r, n, c: np.eye(c, dtype=np.float32)[r.ints(c, n)]
    add("softmaxCrossEntropy", lambda r: ([r.f(4, 5), onehot(r, 4, 5)], {}),
        grad=(0,))
    add("softmaxCrossEntropy", lambda r: ([r.f(4, 5), onehot(r, 4, 5),
                                           np.array([1, 0, 2, 1],
                                                    np.float32)],
                                          {"labelSmoothing": 0.1}),
        grad=(0,), variant="weights-smoothing")
    add("sparseSoftmaxCrossEntropy",
        lambda r: ([r.f(4, 3, 5), r.ints(5, 4, 3).astype(np.float32)], {}),
        grad=(0,))
    add("sigmoidCrossEntropy", lambda r: ([r.f(4, 3, lo=-3, hi=3),
                                           r.bools(4, 3).astype(np.float32)],
                                          {}), grad=(0,))
    for red in ("MEAN_BY_NONZERO_WEIGHT_COUNT", "MEAN_BY_WEIGHT", "SUM",
                "NONE", "MEAN"):
        add("meanSquaredError",
            lambda r, red=red: ([r.f(4, 3), r.f(4, 3),
                                 np.array([1, 0, 2, 1], np.float32)],
                                {"reduction": red}),
            grad=(0, 1), variant=red.lower())
    add("meanSquaredError", lambda r: ([r.f(4, 3), r.f(4, 3)],
                                       {"reduction": "SUM"}),
        variant="unweighted")
    add("absoluteDifference", lambda r: ([r.f(4, 3), r.f(4, 3)], {}))
    add("huberLoss", lambda r: ([r.f(4, 3, lo=-2, hi=2),
                                 r.f(4, 3, lo=-2, hi=2)], {"delta": 0.5}))
    add("logLoss", lambda r: ([r.f(4, 3, lo=0.05, hi=0.95),
                               r.bools(4, 3).astype(np.float32)], {}),
        grad=(0,))
    add("hingeLoss", lambda r: ([r.f(4, 3, lo=-2, hi=2),
                                 r.bools(4, 3).astype(np.float32)], {}),
        grad=(0,))
    add("cosineDistance", lambda r: ([r.f(4, 3), r.f(4, 3)],
                                     {"reduction": "SUM"}))
    add("klDivergence", lambda r: ([r.pos(4, 3) / 6, r.pos(4, 3) / 6], {}))
    # control flow (the bodies use operators only, so one lambda serves
    # both packages)
    add("whileLoop", lambda r: ([np.float32(3.0), np.float32(0.0)],
                                {"cond_fn": lambda v, a: v < 100,
                                 "body_fn": lambda v, a: (v * 2.0,
                                                          a + v)}),
        grad=())
    add("ifCond", lambda r: ([np.float32(1.0), r.f(3)],
                             {"true_fn": lambda a: a * a,
                              "false_fn": lambda a: a - 1.0}), grad=(1,))
    add("ifCond", lambda r: ([np.float32(0.0), r.f(3), r.f(3)],
                             {"true_fn": lambda a, b: (a * b, a),
                              "false_fn": lambda a, b: (a - b, b * 3.0)}),
        grad=(1, 2), variant="false-two")
    add("scanOp", lambda r: ([r.f(2), r.f(4, 2)],
                             {"body_fn": lambda c, x: (c * x + x, c * 2.0)}))
    add("forLoop", lambda r: ([r.f(3), r.f(3)],
                              {"n": 4, "body_fn": lambda i, a, b: (
                                  a * b + 1.0 * i, b + a)}))
    # TF helpers
    add("tfEinsum", lambda r: ([r.f(2, 3, 4), r.f(2, 4, 5)],
                               {"equation": "bij,bjk->bik"}))
    add("tfZerosLike", lambda r: ([r.f(3, 4)], {}), grad=())
    add("tfOnesLike", lambda r: ([r.f(3, 4)], {}), grad=())
    add("tfStridedSlice", lambda r: ([r.f(4, 5, 6)],
                                     {"idx": [[1, 4, 2], None, 2,
                                              [None, None, -1]]}))
    return c


CASES = _cases()
IDS = [f"{n}-{v}" if v else n for n, v, _, _ in CASES]


def _registrations():
    """(line, name) of each registration in the reference's op registry,
    read from its source (the file, not the module, so that this module
    also collects where the JAX package is stubbed)."""
    import re
    from pathlib import Path

    src = (Path(__file__).resolve().parent.parent / "deeplearning4j_tpu" /
           "autodiff" / "ops.py").read_text().splitlines()
    return [(i, m.group(1) or m.group(2))
            for i, line in enumerate(src, 1)
            for m in re.finditer(r'OPS\["(\w+)"\]\s*=|@op\("(\w+)"', line)]


REF_NAMES = list(dict.fromkeys(n for i, n in _registrations()
                               if 61 <= i <= 1150))
RANDOM = sorted(ops.RANDOM_OPS)


def _jnp(v):
    return jnp.asarray(v) if isinstance(v, (np.ndarray, np.generic)) else v


def _torch(v):
    return torch.from_numpy(np.array(v)) if isinstance(
        v, (np.ndarray, np.generic)) else v


def _tuple(v):
    return v if isinstance(v, tuple) else (v,)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().numpy()
    return np.asarray(v)


def _close(got, want, tol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.nanmax(np.abs(want))) if np.isfinite(want).any() \
        and want.size else 1.0
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), rtol=0,
                               atol=tol * max(scale, 1e-30),
                               equal_nan=True, err_msg=what)


def test_cases_cover_every_op_up_to_line_1150():
    assert len(REF_NAMES) == 172
    assert {n for n, *_ in CASES} == set(REF_NAMES) - set(RANDOM) | \
        {"dropout"}
    assert set(REF_NAMES) <= set(ops.OPS)
    # the port's registry is the reference's whole registry
    assert set(ops.OPS) == set(jax_ops.OPS)
    assert len(ops.OPS) == 260


@pytest.mark.parametrize("name,variant,build,grad", CASES, ids=IDS)
def test_op_forward_matches_jax(name, variant, build, grad):
    inputs, attrs = build(Inputs(zlib.crc32(f"{name}-{variant}".encode())))
    want = _tuple(jax_ops.OPS[name](*map(_jnp, inputs), **attrs))
    got = _tuple(ops.OPS[name](*map(_torch, inputs), **attrs))
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert _np(g).dtype == _np(w).dtype, (k, _np(g).dtype,
                                              _np(w).dtype)
        _close(g, w, FWD_TOL, f"{name} output {k}")


GRAD_CASES = [(n, v, b, g) for n, v, b, g in CASES if g != ()]


@pytest.mark.parametrize("name,variant,build,grad", GRAD_CASES,
                         ids=[f"{n}-{v}" if v else n
                              for n, v, _, _ in GRAD_CASES])
def test_op_gradient_matches_jax(name, variant, build, grad):
    inputs, attrs = build(Inputs(zlib.crc32(f"{name}-{variant}".encode())))
    pos = [i for i, v in enumerate(inputs)
           if np.asarray(v).dtype == np.float32] if grad is None \
        else list(grad)
    outs = _tuple(jax_ops.OPS[name](*map(_jnp, inputs), **attrs))
    rng = np.random.default_rng(7)
    weights = [rng.uniform(0.5, 1.5, size=np.shape(o)).astype(np.float32)
               for o in outs]

    def jax_loss(*diff):
        args = list(map(_jnp, inputs))
        for i, d in zip(pos, diff):
            args[i] = d
        res = _tuple(jax_ops.OPS[name](*args, **attrs))
        return sum(jnp.sum(o * w) for o, w in zip(res, weights))

    want = jax.grad(jax_loss, argnums=tuple(range(len(pos))))(
        *[jnp.asarray(inputs[i]) for i in pos])
    args = list(map(_torch, inputs))
    leaves = [args[i].clone().requires_grad_(True) for i in pos]
    for i, leaf in zip(pos, leaves):
        args[i] = leaf
    res = _tuple(ops.OPS[name](*args, **attrs))
    loss = sum(torch.sum(o * torch.from_numpy(w))
               for o, w in zip(res, weights))
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    for i, g, w in zip(pos, got, want):
        g = torch.zeros_like(leaves[0]) if g is None else g
        _close(g, w, GRAD_TOL, f"{name} d/d input {i}")


# -- random ops: shape, dtype, range and moments ---------------------------------

RANDOM_ATTRS = {
    "randomNormal": {"mean": 0.5, "stddev": 2.0},
    "randomUniform": {"min": -1.0, "max": 3.0},
    "randomBernoulli": {"p": 0.3},
    "randomGamma": {"alpha": 2.5, "beta": 2.0},
    "randomPoisson": {"lam": 3.5},
    "randomExponential": {"lam": 1.5},
    "truncatedNormal": {"mean": 1.0, "stddev": 0.5},
}
RANGES = {
    "randomUniform": (-1.0, 3.0), "randomBernoulli": (0.0, 1.0),
    "randomGamma": (0.0, np.inf), "randomPoisson": (0.0, np.inf),
    "randomExponential": (0.0, np.inf), "truncatedNormal": (0.0, 2.0),
}


def _moments(x):
    x = np.asarray(x, np.float64).ravel()
    return x.mean(), x.std()


def test_random_ops_are_the_reference_s():
    assert set(RANDOM) & set(REF_NAMES) == set(RANDOM_ATTRS) | {"dropout"}
    assert set(RANDOM) & set(REF_NAMES) == jax_ops.RANDOM_OPS & \
        set(REF_NAMES)
    assert ops.RANDOM_OPS == jax_ops.RANDOM_OPS
    assert ops.TRAINING_AWARE_OPS == jax_ops.TRAINING_AWARE_OPS
    # the ops with no tensor input are told the graph's device
    assert ops.DEVICE_OPS == {"linspace", "range", "eye_op", "eye", "fill"}


@pytest.mark.parametrize("name", sorted(RANDOM_ATTRS))
def test_random_op_by_shape_dtype_range_and_moments(name):
    shape = [DRAWS // 50, 50]
    attrs = RANDOM_ATTRS[name]
    want = np.asarray(jax_ops.OPS[name](shape=shape, key=jax.random.key(0),
                                        **attrs))
    gen = torch.Generator().manual_seed(0)
    got = ops.OPS[name](shape=shape, generator=gen, **attrs)
    assert tuple(got.shape) == want.shape
    assert got.numpy().dtype == want.dtype
    got = got.numpy()
    lo, hi = RANGES.get(name, (-np.inf, np.inf))
    assert got.min() >= lo and got.max() <= hi
    if name in ("randomBernoulli", "randomPoisson"):
        assert np.array_equal(got, np.round(got))
    (gm, gs), (wm, ws) = _moments(got), _moments(want)
    # two independent samples of DRAWS: their means differ by a few
    # standard errors at most
    se = ws / np.sqrt(DRAWS)
    assert abs(gm - wm) < 6 * se * np.sqrt(2), (gm, wm)
    assert abs(gs - ws) < 0.05 * ws, (gs, ws)
    # a generator seeded alike draws alike
    again = ops.OPS[name](shape=shape,
                          generator=torch.Generator().manual_seed(0),
                          **attrs).numpy()
    assert np.array_equal(got, again)


def test_dropout_in_training_keeps_p_and_scales():
    x = np.ones((DRAWS // 50, 50), np.float32)
    want = np.asarray(jax_ops.OPS["dropout"](jnp.asarray(x), p=0.8,
                                             key=jax.random.key(0),
                                             training=True))
    got = ops.OPS["dropout"](torch.from_numpy(x), p=0.8,
                             generator=torch.Generator().manual_seed(0),
                             training=True).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert set(np.unique(got)) <= {0.0, np.float32(1 / 0.8)}
    assert abs((got != 0).mean() - (want != 0).mean()) < 0.02
    # at inference, and at p = 1, it is the identity
    for kw in ({"training": False}, {"training": True, "p": 1.0}):
        kw.setdefault("p", 0.5)
        out = ops.OPS["dropout"](torch.from_numpy(x), generator=None, **kw)
        assert np.array_equal(out.numpy(), x)


# -- gather's ids outside the range ----------------------------------------------

def test_gather_wraps_negative_ids_once_and_fills_nan():
    table = np.arange(12, dtype=np.float32).reshape(3, 4)
    ids = np.array([5, -1, -7, 2, 3, -3, 2.7, -0.5], np.float32)
    want = np.asarray(jax_ops.OPS["gather"](jnp.asarray(table),
                                            jnp.asarray(ids)))
    got = ops.OPS["gather"](torch.from_numpy(table),
                            torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)],
                                  want[~np.isnan(want)])
    # rows 0 (5), 2 (-7) and 4 (3) are NaN; -1 -> row 2, -3 -> row 0,
    # 2.7 -> row 2, -0.5 -> row 0 (cast toward zero)
    assert np.isnan(got[[0, 2, 4]]).all()
    np.testing.assert_array_equal(got[[1, 3, 5, 6, 7]],
                                  table[[2, 2, 0, 2, 0]])
    # integer tables fill with the most negative value, as jnp.take does
    ints = np.arange(6, dtype=np.int32).reshape(3, 2)
    want = np.asarray(jax_ops.OPS["gather"](jnp.asarray(ints),
                                            jnp.asarray(ids[:3])))
    got = ops.OPS["gather"](torch.from_numpy(ints),
                            torch.from_numpy(ids[:3])).numpy()
    np.testing.assert_array_equal(got, want)


def test_gather_gradient_skips_the_filled_rows():
    table = np.arange(12, dtype=np.float32).reshape(3, 4)
    ids = np.array([5, -1, 0, -1], np.float32)
    want = jax.grad(lambda t: jnp.nansum(jax_ops.OPS["gather"](
        t, jnp.asarray(ids))))(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    torch.nansum(ops.OPS["gather"](t, torch.from_numpy(ids))).backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
