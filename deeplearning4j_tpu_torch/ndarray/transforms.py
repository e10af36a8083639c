"""Transforms: elementwise math (counterpart of
``deeplearning4j_tpu/ndarray/transforms.py``), each a PyTorch op on the
array's tensor. ``gelu`` is the tanh approximation, as ``jax.nn.gelu``'s
default is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as nnf

from deeplearning4j_tpu_torch.ndarray.ndarray import (
    INDArray, _coerce, _host_tensor, _unwrap)


def _tensor(x) -> torch.Tensor:
    x = _unwrap(x)
    return x if isinstance(x, torch.Tensor) else _host_tensor(x)


def _t(fn):
    def wrapper(x, *args):
        x = _tensor(x)
        return INDArray(fn(x, *[_coerce(a, x) for a in args]))

    return wrapper


class Transforms:
    sigmoid = staticmethod(_t(torch.sigmoid))
    tanh = staticmethod(_t(torch.tanh))
    relu = staticmethod(_t(torch.relu))
    relu6 = staticmethod(_t(nnf.relu6))
    leakyRelu = staticmethod(
        lambda x, a=0.01: INDArray(nnf.leaky_relu(_tensor(x), float(a))))
    elu = staticmethod(_t(nnf.elu))
    selu = staticmethod(_t(nnf.selu))
    gelu = staticmethod(_t(lambda x: nnf.gelu(x, approximate="tanh")))
    softPlus = staticmethod(_t(nnf.softplus))
    softsign = staticmethod(_t(nnf.softsign))
    swish = staticmethod(_t(nnf.silu))
    mish = staticmethod(_t(lambda x: x * torch.tanh(nnf.softplus(x))))
    hardSigmoid = staticmethod(_t(nnf.hardsigmoid))
    hardTanh = staticmethod(_t(lambda x: torch.clamp(x, -1.0, 1.0)))
    exp = staticmethod(_t(torch.exp))
    log = staticmethod(_t(torch.log))
    log1p = staticmethod(_t(torch.log1p))
    sqrt = staticmethod(_t(torch.sqrt))
    abs = staticmethod(_t(torch.abs))
    sign = staticmethod(_t(torch.sign))
    floor = staticmethod(_t(torch.floor))
    ceil = staticmethod(_t(torch.ceil))
    round = staticmethod(_t(torch.round))
    sin = staticmethod(_t(torch.sin))
    cos = staticmethod(_t(torch.cos))
    tan = staticmethod(_t(torch.tan))
    asin = staticmethod(_t(torch.asin))
    acos = staticmethod(_t(torch.acos))
    atan = staticmethod(_t(torch.atan))
    sinh = staticmethod(_t(torch.sinh))
    cosh = staticmethod(_t(torch.cosh))
    pow = staticmethod(_t(torch.pow))
    reciprocal = staticmethod(_t(lambda x: 1.0 / x))
    square = staticmethod(_t(torch.square))
    cube = staticmethod(_t(lambda x: x * x * x))
    neg = staticmethod(_t(torch.neg))
    max = staticmethod(_t(torch.maximum))
    min = staticmethod(_t(torch.minimum))
    clip = staticmethod(_t(torch.clamp))
    step = staticmethod(_t(lambda x: (x > 0).to(x.dtype)))
    erf = staticmethod(_t(torch.special.erf))

    @staticmethod
    def softmax(x, dim: int = -1) -> INDArray:
        return INDArray(torch.softmax(_tensor(x), dim=dim))

    @staticmethod
    def logSoftmax(x, dim: int = -1) -> INDArray:
        return INDArray(torch.log_softmax(_tensor(x), dim=dim))

    @staticmethod
    def unitVec(x) -> INDArray:
        a = _tensor(x)
        return INDArray(a / torch.linalg.vector_norm(a))

    @staticmethod
    def cosineSim(a, b) -> float:
        x, y = _tensor(a).reshape(-1), _tensor(b).reshape(-1)
        return float(torch.dot(x, y) / (torch.linalg.vector_norm(x) *
                                         torch.linalg.vector_norm(y)))

    @staticmethod
    def euclideanDistance(a, b) -> float:
        return float(torch.linalg.vector_norm(
            _tensor(a).reshape(-1) - _tensor(b).reshape(-1)))

    @staticmethod
    def manhattanDistance(a, b) -> float:
        return float((_tensor(a).reshape(-1) -
                      _tensor(b).reshape(-1)).abs().sum())

    @staticmethod
    def allEuclideanDistances(a, b) -> INDArray:
        x, y = _tensor(a), _tensor(b)
        d2 = ((x * x).sum(1, keepdim=True) - 2.0 * x @ y.T +
              (y * y).sum(1)[None, :])
        return INDArray(torch.sqrt(torch.clamp_min(d2, 0.0)))

    @staticmethod
    def allCosineSimilarities(a, b) -> INDArray:
        x, y = _tensor(a), _tensor(b)
        xn = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
        yn = y / torch.linalg.vector_norm(y, dim=1, keepdim=True)
        return INDArray(xn @ yn.T)
