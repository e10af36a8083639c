"""Op registry: a PyTorch function for each SameDiff op, by the JAX
package's names.

Counterpart of ``deeplearning4j_tpu/autodiff/ops.py``, the whole
registry (260 names): the elementwise, activation, reduction, matmul,
shape and indexing, comparison, normalization, random, convolution and
pooling, recurrent, attention, loss, control-flow and TF-helper families,
then linear algebra, segment reductions, sorting, image and colorspace
ops, special functions, ``ctcLoss``, non-max suppression, scatters and
noise layers, with the reference's signatures, attribute names and output
dtypes (int32 where jnp gives int32 with 64-bit types off).

Conventions, as in the reference:

- ``fn(*inputs, **attrs)`` -> a tensor or a tuple of tensors;
- ops in ``RANDOM_OPS`` take a ``generator=`` keyword (a
  ``torch.Generator`` on the graph's device) where the reference takes a
  JAX PRNG ``key=``: they agree with it by shape, dtype and distribution,
  never by seed;
- ops in ``TRAINING_AWARE_OPS`` take ``training=``; ops in
  ``DEVICE_OPS`` (those with no tensor input) take ``device=``;
- conv/pool use NCHW activations and [out, in, kH, kW] weights, DL4J's
  layout.

Every op is plain PyTorch but the recurrent layers: ``lstmLayer`` and
``gruLayer`` run their recurrence in the hand-written kernels of
``kernels/lstm.py`` and ``kernels/gru.py`` (the CUDA kernels on the GPU,
their plain versions on the CPU), as the reference runs its Pallas
kernels. LSTM gate order is i, f, g(cell), o, as in DL4J's lstmLayer
packing; GRU gate order is r, u, then the candidate c, as in libnd4j's
gruCell.
"""

from __future__ import annotations

import functools

import math as _math

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.kernels.gru import gru_seq, gru_seq_infer
from deeplearning4j_tpu_torch.kernels.lstm import lstm_seq, lstm_seq_infer
from deeplearning4j_tpu_torch.ndarray.ndarray import torch_dtype

OPS = {}
RANDOM_OPS: set = set()
TRAINING_AWARE_OPS: set = set()
DEVICE_OPS: set = set()


def op(name=None, random=False, training_aware=False, device_aware=False):
    def deco(fn):
        key = name or fn.__name__
        OPS[key] = fn
        if random:
            RANDOM_OPS.add(key)
        if training_aware:
            TRAINING_AWARE_OPS.add(key)
        if device_aware:
            DEVICE_OPS.add(key)
        return fn

    return deco


def _identity(x):
    return x


def _axis(dims, ndim):
    if dims is None or dims == () or dims == []:
        return None
    if isinstance(dims, int):
        dims = (dims,)
    return tuple(d % ndim for d in dims)


def _all_axes(dims, ndim):
    """``_axis`` with None read as every axis (torch wants them named)."""
    ax = _axis(dims, ndim)
    return tuple(range(ndim)) if ax is None else ax


def _as_float(x):
    """Integer and bool inputs of a mean or variance: float32, as jnp
    promotes them."""
    return x if x.is_floating_point() else x.to(torch.float32)


def _max(x, bound):
    """jnp.maximum(x, bound): at a tie the gradient splits evenly between
    the two, as in JAX (``torch.clamp`` would give it all to x)."""
    return torch.maximum(x, torch.as_tensor(bound, dtype=x.dtype,
                                            device=x.device))


def _min(x, bound):
    return torch.minimum(x, torch.as_tensor(bound, dtype=x.dtype,
                                            device=x.device))


def _clip(x, lo, hi):
    """jnp.clip, with its gradient at the bounds."""
    return _min(_max(x, lo), hi)


def _abs(x):
    """jnp.abs, whose gradient at 0 is 1 (torch.abs gives 0 there)."""
    return torch.where(x >= 0, x, -x)


def _acc(x):
    """The dtype a sum or product of x takes: int32 for bool and integers
    up to 32 bits, as jnp gives them with 64-bit types off (torch would
    widen them to int64); None (x's own) otherwise."""
    small = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32)
    return torch.int32 if x.dtype in small else None


def _long(indices):
    """Ids held as any dtype, cast as ``astype(int32)`` casts them (floats
    truncated toward zero), as int64 for torch's indexing."""
    return indices.to(torch.int32).to(torch.int64)


# ---------------------------------------------------------------------------
# elementwise / transforms
# ---------------------------------------------------------------------------

# binary
OPS["add"] = lambda a, b: a + b
OPS["sub"] = lambda a, b: a - b
OPS["mul"] = lambda a, b: a * b
OPS["div"] = lambda a, b: a / b
OPS["rsub"] = lambda a, b: b - a
OPS["rdiv"] = lambda a, b: b / a
OPS["pow"] = lambda a, b: a**b
OPS["floordiv"] = lambda a, b: torch.floor_divide(a, b)
OPS["mod"] = lambda a, b: torch.remainder(a, b)
OPS["squaredDifference"] = lambda a, b: (a - b) ** 2
OPS["maximum"] = torch.maximum
OPS["minimum"] = torch.minimum

# unary
OPS["identity"] = _identity
OPS["neg"] = torch.neg
OPS["abs"] = _abs
OPS["exp"] = torch.exp
OPS["log"] = torch.log
OPS["log1p"] = torch.log1p
OPS["sqrt"] = torch.sqrt
OPS["rsqrt"] = torch.rsqrt
OPS["square"] = torch.square
OPS["reciprocal"] = torch.reciprocal
OPS["sign"] = torch.sign
OPS["floor"] = torch.floor
OPS["ceil"] = torch.ceil
OPS["round"] = torch.round     # half to even, as jnp.round
OPS["sin"] = torch.sin
OPS["cos"] = torch.cos
OPS["tan"] = torch.tan
OPS["asin"] = torch.asin
OPS["acos"] = torch.acos
OPS["atan"] = torch.atan
OPS["sinh"] = torch.sinh
OPS["cosh"] = torch.cosh
OPS["tanh"] = torch.tanh
OPS["erf"] = torch.erf
OPS["isnan"] = torch.isnan
OPS["isinf"] = torch.isinf

# activations
OPS["sigmoid"] = torch.sigmoid
OPS["relu"] = torch.relu
OPS["relu6"] = F.relu6
OPS["elu"] = F.elu
OPS["selu"] = F.selu
OPS["gelu"] = lambda x: F.gelu(x, approximate="tanh")   # jax.nn.gelu's
OPS["softplus"] = F.softplus
OPS["softsign"] = F.softsign
OPS["swish"] = F.silu
OPS["mish"] = lambda x: x * torch.tanh(F.softplus(x))
OPS["hardSigmoid"] = F.hardsigmoid
OPS["hardTanh"] = lambda x: _clip(x, -1.0, 1.0)
OPS["leakyRelu"] = lambda x, alpha=0.01: torch.where(x >= 0, x, alpha * x)
OPS["prelu"] = lambda x, a: torch.where(x >= 0, x, a * x)
OPS["rationalTanh"] = lambda x: 1.7159 * torch.tanh(2.0 * x / 3.0)
OPS["rectifiedTanh"] = lambda x: _max(torch.tanh(x), 0.0)
OPS["thresholdRelu"] = lambda x, cutoff=0.0: torch.where(
    x > cutoff, x, torch.zeros_like(x))
OPS["clipByValue"] = lambda x, clipValueMin=-1.0, clipValueMax=1.0: \
    _clip(x, clipValueMin, clipValueMax)


@op("clipByNorm")
def _clip_by_norm(x, clipValue=1.0, dims=None):
    n = torch.sqrt(torch.sum(x * x, dim=_all_axes(dims, x.dim()),
                             keepdim=True))
    return torch.where(n > clipValue,
                       x * (clipValue / _max(n, 1e-12)), x)


@op("softmax")
def _softmax(x, dimension=-1):
    return torch.softmax(x, dim=dimension)


@op("logSoftmax")
def _log_softmax(x, dimension=-1):
    return torch.log_softmax(x, dim=dimension)


@op("softmaxDerivative")
def _softmax_deriv(x, wrt, dimension=-1):
    s = torch.softmax(x, dim=dimension)
    return s * (wrt - torch.sum(wrt * s, dim=dimension, keepdim=True))


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _over_axes(fn):
    """A one-axis torch reduction applied over several axes, last first."""
    def f(x, dim, keepdim):
        for d in sorted(dim, reverse=True):
            x = fn(x, dim=d, keepdim=keepdim)
        return x

    return f


def _red(fn):
    def f(x, dimensions=None, keepDims=False):
        return fn(x, dim=_all_axes(dimensions, x.dim()), keepdim=keepDims)

    return f


OPS["sum"] = _red(lambda x, dim, keepdim: torch.sum(x, dim=dim,
                                                    keepdim=keepdim,
                                                    dtype=_acc(x)))
OPS["mean"] = _red(lambda x, dim, keepdim: torch.mean(_as_float(x), dim=dim,
                                                      keepdim=keepdim))
OPS["max"] = _red(torch.amax)
OPS["min"] = _red(torch.amin)
OPS["prod"] = _red(_over_axes(lambda x, dim, keepdim: torch.prod(
    x, dim=dim, keepdim=keepdim, dtype=_acc(x))))
OPS["any"] = _red(_over_axes(torch.any))
OPS["all"] = _red(_over_axes(torch.all))
OPS["norm1"] = _red(lambda x, **k: torch.sum(_abs(x), **k))
OPS["norm2"] = _red(lambda x, **k: torch.sqrt(torch.sum(x * x, **k)))
OPS["normMax"] = _red(lambda x, **k: torch.amax(_abs(x), **k))
OPS["logSumExp"] = _red(torch.logsumexp)
OPS["countNonZero"] = _red(lambda x, **k: OPS["sum"](
    x != 0, k["dim"], k["keepdim"]))
OPS["zeroFraction"] = lambda x: torch.mean((x == 0).to(torch.float32))


@op("variance")
def _variance(x, dimensions=None, biasCorrected=True, keepDims=False):
    return torch.var(_as_float(x), dim=_all_axes(dimensions, x.dim()),
                     correction=1 if biasCorrected else 0, keepdim=keepDims)


@op("standardDeviation")
def _std(x, dimensions=None, biasCorrected=True, keepDims=False):
    return torch.std(_as_float(x), dim=_all_axes(dimensions, x.dim()),
                     correction=1 if biasCorrected else 0, keepdim=keepDims)


def _arg(fn, x, dimension, keepDims):
    """argmax/argmin as jnp gives them: int32, over the flattened array
    when ``dimension`` is None."""
    if dimension is None:
        r = fn(x.reshape(-1))
        if keepDims:
            r = r.reshape((1,) * x.dim())
    else:
        r = fn(x, dim=dimension, keepdim=keepDims)
    return r.to(torch.int32)


@op("argmax")
def _argmax(x, dimension=None, keepDims=False):
    return _arg(torch.argmax, x, dimension, keepDims)


@op("argmin")
def _argmin(x, dimension=None, keepDims=False):
    return _arg(torch.argmin, x, dimension, keepDims)


@op("cumsum")
def _cumsum(x, axis=0, exclusive=False, reverse=False):
    a = x
    if reverse:
        a = torch.flip(a, (axis,))
    r = torch.cumsum(a, dim=axis, dtype=_acc(a))
    if exclusive:
        r = r - a
    if reverse:
        r = torch.flip(r, (axis,))
    return r


@op("cumprod")
def _cumprod(x, axis=0):
    return torch.cumprod(x, dim=axis, dtype=_acc(x))


@op("moments")
def _moments(x, dimensions=None, keepDims=False):
    ax = _all_axes(dimensions, x.dim())
    x = _as_float(x)
    return (torch.mean(x, dim=ax, keepdim=keepDims),
            torch.var(x, dim=ax, correction=0, keepdim=keepDims))


# ---------------------------------------------------------------------------
# linalg (torch.matmul: the reference leaves these to XLA, not to Pallas)
# ---------------------------------------------------------------------------

@op("matmul")
def _matmul(a, b, transposeA=False, transposeB=False):
    if transposeA:
        a = torch.swapaxes(a, -1, -2)
    if transposeB:
        b = torch.swapaxes(b, -1, -2)
    return a @ b


@op("tensorMmul")
def _tensor_mmul(a, b, axesA=None, axesB=None):
    return torch.tensordot(a, b, dims=(list(axesA), list(axesB)))


@op("batchMmul")
def _batch_mmul(a, b):
    return a @ b


@op("dot")
def _dot(a, b, dimensions=None):
    if dimensions is None:
        return torch.sum(a * b)
    return torch.sum(a * b, dim=_axis(dimensions, a.dim()))


# ---------------------------------------------------------------------------
# shape ops
# ---------------------------------------------------------------------------

def _getitem(x, idx):
    """``x[idx]`` with numpy's meaning for slices of negative step, which
    torch does not take: those dims are sliced whole, then picked by
    ``index_select``."""
    basic, picks = [], []
    in_d = out_d = 0
    for i in idx:
        if i is None:
            basic.append(None)
            out_d += 1
        elif isinstance(i, slice):
            if i.step is not None and i.step < 0:
                picks.append((out_d, range(*i.indices(x.shape[in_d]))))
                basic.append(slice(None))
            else:
                basic.append(i)
            in_d += 1
            out_d += 1
        else:
            basic.append(int(i))
            in_d += 1
    y = x[tuple(basic)]
    for d, r in picks:
        y = y.index_select(d, torch.tensor(list(r), dtype=torch.int64,
                                           device=x.device))
    return y


@op("reshape")
def _reshape(x, shape=None):
    return x.reshape(tuple(shape))


@op("permute")
def _permute(x, dimensions=None):
    return x.permute(tuple(dimensions))


@op("transpose")
def _transpose(x):
    return x.permute(tuple(reversed(range(x.dim()))))


@op("expandDims")
def _expand_dims(x, axis=0):
    return torch.unsqueeze(x, axis)


@op("squeeze")
def _squeeze(x, axis=None):
    return torch.squeeze(x) if axis is None else torch.squeeze(x, axis)


@op("concat")
def _concat(*xs, dimension=0):
    return torch.cat(xs, dim=dimension)


@op("stack")
def _stack(*xs, axis=0):
    return torch.stack(xs, dim=axis)


@op("unstack")
def _unstack(x, axis=0, num=None):
    n = num or x.shape[axis]
    return tuple(torch.squeeze(s, axis)
                 for s in torch.split(x, x.shape[axis] // n, dim=axis))


@op("split")
def _split(x, numSplit=2, dimension=0):
    return tuple(torch.split(x, x.shape[dimension] // numSplit,
                             dim=dimension))


@op("slice")
def _slice(x, begin=None, size=None):
    """lax.dynamic_slice: a start is clamped so that the slice fits."""
    idx = []
    for i, (b, s) in enumerate(zip(begin, size)):
        s = s if s >= 0 else x.shape[i] - b
        b = min(max(int(b), 0), x.shape[i] - s)
        idx.append(slice(b, b + s))
    return x[tuple(idx)]


@op("stridedSlice")
def _strided_slice(x, begin=None, end=None, strides=None):
    return _getitem(x, tuple(
        slice(b, e, s) for b, e, s in zip(begin, end,
                                          strides or [1] * len(begin))))


@op("tile")
def _tile(x, reps=None):
    return torch.tile(x, tuple(reps))


def _pad_index(n, lo, hi, mode, device):
    """Source positions of a dim of size n padded by (lo, hi) in numpy's
    "reflect", "symmetric", "edge" or "wrap" mode."""
    j = np.arange(-lo, n + hi)
    if mode == "reflect":
        period = 2 * (n - 1) if n > 1 else 1
        j = np.abs(j) % period
        j = np.where(j >= n, period - j, j)
    elif mode == "symmetric":
        j = j % (2 * n)
        j = np.where(j >= n, 2 * n - 1 - j, j)
    elif mode == "edge":
        j = np.clip(j, 0, n - 1)
    elif mode == "wrap":
        j = j % n
    else:
        raise ValueError(f"unsupported pad mode {mode!r}")
    return torch.as_tensor(j, dtype=torch.int64, device=device)


@op("pad")
def _pad(x, paddings=None, constant=0.0, mode="CONSTANT"):
    pads = [tuple(int(v) for v in p) for p in paddings]
    if mode.upper() == "CONSTANT":
        flat = [v for lo_hi in reversed(pads) for v in lo_hi]
        return F.pad(x, flat, value=constant)
    for d, (lo, hi) in enumerate(pads):
        if lo or hi:
            x = x.index_select(d, _pad_index(x.shape[d], lo, hi,
                                             mode.lower(), x.device))
    return x


@op("reverse")
def _reverse(x, dimensions=None):
    return torch.flip(x, _all_axes(dimensions, x.dim()))


def _fill_value(dtype):
    """jnp.take's fill for ids outside the range: NaN for inexact types,
    the most negative value for signed ints, the largest for unsigned,
    True for bool."""
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


@op("gather")
def _gather(x, indices, axis=0):
    """jnp.take(x, indices.astype(int32), axis): a negative id wraps once
    by the axis' length, and an id still outside [0, length) gives a row of
    the fill value (NaN for floats). The rows are picked with safe ids and
    then filled, so a wild id never becomes a device-side assert."""
    axis = axis % x.dim()
    n = x.shape[axis]
    idx = _long(indices)
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    # rows of the [n, rest] table by a backward that sums each row's
    # gradient in a fixed order, so that its bits repeat: indexing's on
    # CUDA (it sorts the ids), the embedding's on the CPU (the other way
    # round each accumulates in parallel)
    table = x.movedim(axis, 0)
    flat, safe = table.reshape(n, -1), torch.where(valid, idx, 0)
    rows = (flat[safe] if x.device.type == "cuda" else
            F.embedding(safe, flat)).reshape(
        tuple(idx.shape) + tuple(table.shape[1:]))
    mask = valid.reshape(valid.shape + (1,) * (rows.dim() - valid.dim()))
    rows = torch.where(mask, rows, torch.full((), _fill_value(x.dtype),
                                              dtype=x.dtype,
                                              device=x.device))
    return rows.movedim(tuple(range(idx.dim())),
                        tuple(range(axis, axis + idx.dim())))


@op("gatherNd")
def _gather_nd(x, indices):
    """x[tuple(indices.T)] with jnp's indexing rule: negative ids wrap,
    then ids are clamped into range."""
    idx = _long(indices)
    parts = []
    for d in range(idx.shape[-1]):
        i = idx[..., d]
        n = x.shape[d]
        parts.append(torch.where(i < 0, i + n, i).clamp(0, n - 1))
    return x[tuple(parts)]


def _scatter(ref, indices, updates, accumulate):
    """ref.at[indices].set/add(updates) on axis 0: negative ids wrap once,
    ids still outside the range are dropped."""
    n = ref.shape[0]
    idx = _long(indices)
    idx = torch.where(idx < 0, idx + n, idx)
    updates = torch.as_tensor(updates, dtype=ref.dtype,
                              device=ref.device).expand(
        tuple(idx.shape) + tuple(ref.shape[1:]))
    valid = (idx >= 0) & (idx < n)
    return ref.index_put((idx[valid],), updates[valid],
                         accumulate=accumulate)


@op("scatterUpdate")
def _scatter_update(ref, indices, updates):
    return _scatter(ref, indices, updates, False)


@op("scatterAdd")
def _scatter_add(ref, indices, updates):
    return _scatter(ref, indices, updates, True)


@op("oneHot")
def _one_hot(x, depth=None, on=1.0, off=0.0, axis=-1):
    """jax.nn.one_hot: ids outside [0, depth) give a row of zeros (then
    ``off``)."""
    idx = _long(x)
    hot = (idx.unsqueeze(-1) == torch.arange(depth, device=x.device)).to(
        torch.float32)
    hot = hot.movedim(-1, axis % (idx.dim() + 1))
    return hot * (on - off) + off


@op("linspace", device_aware=True)
def _linspace(start=0.0, stop=1.0, num=10, device=None):
    return torch.linspace(start, stop, num, dtype=torch.float32,
                          device=device)


def _arange_dtype(*vals):
    return (torch.int32 if all(isinstance(v, (int, np.integer))
                               for v in vals) else torch.float32)


@op("range", device_aware=True)
def _range(start=0, limit=None, delta=1, device=None):
    if limit is None:
        start, limit = 0, start
    return torch.arange(start, limit, delta,
                        dtype=_arange_dtype(start, limit, delta),
                        device=device)


@op("shape_of")
def _shape_of(x):
    return torch.tensor(tuple(x.shape), dtype=torch.int32, device=x.device)


@op("cast")
def _cast(x, dtype=None):
    return x.to(torch_dtype(dtype))


@op("assign_op")
def _assign_op(a, b):
    return torch.broadcast_to(torch.as_tensor(b, device=a.device),
                              a.shape).to(a.dtype)


@op("invertPermutation")
def _invert_permutation(x):
    return torch.argsort(x).to(torch.int32)


@op("sequenceMask")
def _sequence_mask(lengths, maxLen=None):
    return (torch.arange(maxLen, device=lengths.device)[None, :]
            < lengths[:, None]).to(torch.float32)


@op("diag")
def _diag(x):
    return torch.diag(x)


@op("eye_op", device_aware=True)
def _eye(n=1, m=None, device=None):
    return torch.eye(n, n if m is None else m, dtype=torch.float32,
                     device=device)


@op("meshgrid")
def _meshgrid(*xs, indexing="xy"):
    return tuple(torch.meshgrid(*xs, indexing=indexing))


# comparisons / selection
OPS["eq"] = lambda a, b: a == b
OPS["neq"] = lambda a, b: a != b
OPS["gt"] = lambda a, b: a > b
OPS["gte"] = lambda a, b: a >= b
OPS["lt"] = lambda a, b: a < b
OPS["lte"] = lambda a, b: a <= b
OPS["and_op"] = torch.logical_and
OPS["or_op"] = torch.logical_or
OPS["not_op"] = torch.logical_not
OPS["xor_op"] = torch.logical_xor


@op("where_op")
def _where(cond, x, y):
    return torch.where(cond.to(torch.bool), x, y)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

@op("layerNorm")
def _layer_norm(x, gain, bias=None, channelwise_axis=-1, epsilon=1e-5):
    mean = torch.mean(x, dim=channelwise_axis, keepdim=True)
    var = torch.var(x, dim=channelwise_axis, correction=0, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + epsilon) * gain
    if bias is not None:
        y = y + bias
    return y


@op("batchNorm")
def _batch_norm(x, mean, variance, gamma=None, beta=None, epsilon=1e-5,
                axis=1):
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    y = (x - mean.reshape(shape)) * torch.rsqrt(variance.reshape(shape)
                                                + epsilon)
    if gamma is not None:
        y = y * gamma.reshape(shape)
    if beta is not None:
        y = y + beta.reshape(shape)
    return y


@op("standardize")
def _standardize(x, dimensions=(-1,)):
    ax = _all_axes(dimensions, x.dim())
    m = torch.mean(x, dim=ax, keepdim=True)
    s = torch.std(x, dim=ax, correction=0, keepdim=True)
    return (x - m) / _max(s, 1e-12)


@op("dropout", random=True, training_aware=True)
def _dropout(x, p=0.5, generator=None, training=False):
    """p is the RETAIN probability, matching DL4J dropout semantics
    (org.deeplearning4j.nn.conf.dropout.Dropout: activations scaled by 1/p)."""
    if not training or p >= 1.0:
        return x
    mask = torch.rand(x.shape, generator=generator,
                      device=x.device) < p
    return torch.where(mask, x / p, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# random
# ---------------------------------------------------------------------------

def _uniform(shape, generator):
    return torch.rand(tuple(shape), generator=generator,
                      device=generator.device)


@op("randomNormal", random=True)
def _random_normal(shape=None, mean=0.0, stddev=1.0, generator=None):
    return mean + stddev * torch.randn(tuple(shape), generator=generator,
                                       device=generator.device)


@op("randomUniform", random=True)
def _random_uniform(shape=None, min=0.0, max=1.0, generator=None):
    return min + (max - min) * _uniform(shape, generator)


@op("randomBernoulli", random=True)
def _random_bernoulli(shape=None, p=0.5, generator=None):
    return (_uniform(shape, generator) < p).to(torch.float32)


@op("randomGamma", random=True)
def _random_gamma(shape=None, alpha=1.0, beta=1.0, generator=None):
    """Gamma(alpha, rate beta) (reference: random ops gamma declarable)."""
    a = torch.full(tuple(shape), float(alpha), device=generator.device)
    return torch._standard_gamma(a, generator=generator) / beta


@op("randomPoisson", random=True)
def _random_poisson(shape=None, lam=1.0, generator=None):
    rate = torch.full(tuple(shape), float(lam), device=generator.device)
    return torch.poisson(rate, generator=generator)


@op("randomExponential", random=True)
def _random_exponential(shape=None, lam=1.0, generator=None):
    e = torch.empty(tuple(shape), device=generator.device)
    return e.exponential_(1.0, generator=generator) / lam


@op("truncatedNormal", random=True)
def _truncated_normal(shape=None, mean=0.0, stddev=1.0, generator=None):
    """Normal truncated to +/-2 sigma (TF/DL4J truncated_normal
    semantics), by the inverse CDF of a uniform draw over [Phi(-2),
    Phi(2)]."""
    lo, hi = (0.5 * (1 + _math.erf(b / _math.sqrt(2))) for b in (-2.0, 2.0))
    u = lo + (hi - lo) * _uniform(shape, generator)
    z = _math.sqrt(2) * torch.erfinv(2 * u - 1)
    return mean + stddev * torch.clamp(z, -2.0, 2.0)


# ---------------------------------------------------------------------------
# conv / pool (NCHW, weights [out, in, kH, kW] like libnd4j conv2d)
# ---------------------------------------------------------------------------

def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v, v)


def _triple_(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(a) for a in v)
    return (int(v),) * 3


def _same_pads(sizes, kernel, strides, dilation):
    """XLA's "SAME" padding, (lo, hi) a spatial dim: the output is
    ceil(in / stride), the extra row (when the total is odd) at the end."""
    pads = []
    for n, k, s, d in zip(sizes, kernel, strides, dilation):
        out = -(-n // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pad_spatial(x, pads, value=0.0):
    """Pad the trailing spatial dims of x by [(lo, hi), ...] in order."""
    flat = [v for lo_hi in reversed(pads) for v in lo_hi]
    return F.pad(x, flat, value=value) if any(flat) else x


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _conv(x, w, b, strides, pads, dilation, groups=1):
    nd = x.dim() - 2
    y = _CONV[nd](_pad_spatial(x, pads), w, stride=strides,
                  dilation=dilation, groups=groups)
    if b is not None:
        y = y + b.reshape((1, -1) + (1,) * nd)
    return y


def _conv_pads(x, w, strides, padding, dilation, sameMode):
    nd = x.dim() - 2
    if sameMode:
        return _same_pads(x.shape[2:], w.shape[2:], strides, dilation)
    p = _pair(padding) if nd == 2 else (_triple_(padding) if nd == 3
                                        else (int(padding),))
    return [(q, q) for q in p]


@op("conv2d")
def _conv2d(x, w, b=None, kernel=None, strides=(1, 1), padding=(0, 0),
            dilation=(1, 1), sameMode=False):
    """x: [N,C,H,W]; w: [outC, inC, kH, kW] (DL4J layout)."""
    strides, dilation = _pair(strides), _pair(dilation)
    return _conv(x, w, b, strides,
                 _conv_pads(x, w, strides, padding, dilation, sameMode),
                 dilation)


@op("depthwiseConv2d")
def _depthwise_conv2d(x, w, b=None, strides=(1, 1), padding=(0, 0),
                      dilation=(1, 1), sameMode=False):
    """w: [depthMult, inC, kH, kW] -> grouped conv with C groups."""
    strides, dilation = _pair(strides), _pair(dilation)
    c, mult = x.shape[1], w.shape[0]
    w2 = w.permute(1, 0, 2, 3).reshape(c * mult, 1, *w.shape[2:])
    return _conv(x, w2, b, strides,
                 _conv_pads(x, w2, strides, padding, dilation, sameMode),
                 dilation, groups=c)


@op("conv1d")
def _conv1d(x, w, b=None, stride=1, padding=0, sameMode=False):
    """x: [N,C,W]; w: [outC, inC, k]."""
    return _conv(x, w, b, (stride,),
                 _conv_pads(x, w, (stride,), padding, (1,), sameMode), (1,))


@op("deconv2d")
def _deconv2d(x, w, b=None, strides=(1, 1), padding=(0, 0), sameMode=False):
    """Transposed conv; w: [outC, inC, kH, kW] wrt the FORWARD direction of
    the deconv (i.e. produces outC channels), as the reference computes
    it: the input dilated by the strides, padded k-1-p a side (SAME: k+s-2
    in all, the odd one at the end), convolved with the spatially flipped
    kernel. Output s*(i-1) + k - 2p (SAME: i*s)."""
    strides, p = _pair(strides), _pair(padding)
    k = (w.shape[2], w.shape[3])
    if sameMode:
        tot = (k[0] + strides[0] - 2, k[1] + strides[1] - 2)
        pads = [(t // 2, t - t // 2) for t in tot]
    else:
        pads = [(k[i] - 1 - p[i],) * 2 for i in range(2)]
    n, c, h, wd = x.shape
    xd = x.new_zeros((n, c, (h - 1) * strides[0] + 1,
                      (wd - 1) * strides[1] + 1))
    xd[:, :, ::strides[0], ::strides[1]] = x
    return _conv(xd, torch.flip(w, (2, 3)), b, (1, 1), pads, (1, 1))


def _pool(x, kernel, strides, padding, sameMode, kind, include_pad=False):
    """lax.reduce_window max or add over the trailing 2 or 3 dims: padding
    takes the reduction's identity, and an average (``kind`` "avg")
    divides by the count of real elements in each window, or by the
    window's size with ``include_pad``."""
    nd = x.dim() - 2
    tup = _pair if nd == 2 else _triple_
    k, s = tup(kernel), tup(strides)
    if sameMode:
        pads = _same_pads(x.shape[2:], k, s, (1,) * nd)
    else:
        pads = [(q, q) for q in tup(padding)]
    if kind == "max":
        pool = F.max_pool2d if nd == 2 else F.max_pool3d
        return pool(_pad_spatial(x, pads, -float("inf")), k, s)
    avg = F.avg_pool2d if nd == 2 else F.avg_pool3d
    area = float(np.prod(k))
    total = avg(_pad_spatial(x, pads), k, s) * area
    if include_pad:
        return total / area
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    return total / (avg(_pad_spatial(ones, pads), k, s) * area)


@op("maxPooling2d")
def _max_pool2d(x, kernel=(2, 2), strides=(2, 2), padding=(0, 0),
                sameMode=False):
    return _pool(x, kernel, strides, padding, sameMode, "max")


@op("avgPooling2d")
def _avg_pool2d(x, kernel=(2, 2), strides=(2, 2), padding=(0, 0),
                sameMode=False, includePadInAvg=False):
    return _pool(x, kernel, strides, padding, sameMode, "avg",
                 include_pad=includePadInAvg)


@op("conv3d")
def _conv3d_op(x, w, b=None, strides=(1, 1, 1), padding=(0, 0, 0),
               dilation=(1, 1, 1), sameMode=False):
    """x: [N,C,D,H,W]; w: [outC, inC, kD, kH, kW] (op-level conv3d —
    reference: libnd4j conv3dnew declarable)."""
    strides, dilation = _triple_(strides), _triple_(dilation)
    return _conv(x, w, b, strides,
                 _conv_pads(x, w, strides, padding, dilation, sameMode),
                 dilation)


@op("maxPooling3d")
def _max_pool3d(x, kernel=(2, 2, 2), strides=(2, 2, 2), padding=(0, 0, 0),
                sameMode=False):
    return _pool(x, kernel, strides, padding, sameMode, "max")


@op("avgPooling3d")
def _avg_pool3d(x, kernel=(2, 2, 2), strides=(2, 2, 2), padding=(0, 0, 0),
                sameMode=False):
    return _pool(x, kernel, strides, padding, sameMode, "avg")


@op("globalAvgPooling")
def _global_avg_pool(x, dimensions=(2, 3)):
    return torch.mean(x, dim=_all_axes(dimensions, x.dim()))


@op("upsampling2d")
def _upsampling2d(x, size=(2, 2)):
    s = _pair(size)
    return torch.repeat_interleave(torch.repeat_interleave(x, s[0], dim=2),
                                   s[1], dim=3)


@op("im2col")
def _im2col(x, kernel=(2, 2), strides=(1, 1), padding=(0, 0)):
    """libnd4j's helpers/im2col layout: [n, c, kh, kw, oh, ow]."""
    k, s, p = _pair(kernel), _pair(strides), _pair(padding)
    xp = F.pad(x, (p[1], p[1], p[0], p[0]))
    h, w = xp.shape[2], xp.shape[3]
    oh = (h - k[0]) // s[0] + 1
    ow = (w - k[1]) // s[1] + 1
    ar = lambda n: torch.arange(n, device=x.device)
    idx_h = (ar(oh) * s[0])[:, None] + ar(k[0])[None, :]
    idx_w = (ar(ow) * s[1])[:, None] + ar(k[1])[None, :]
    cols = xp[:, :, idx_h[:, :, None, None], idx_w[None, None, :, :]]
    # [n, c, oh, kh, ow, kw] -> [n, c, kh, kw, oh, ow]
    return cols.permute(0, 1, 3, 5, 2, 4)


# ---------------------------------------------------------------------------
# recurrent (lstmLayer and gruLayer run their recurrence in the
# hand-written kernels; the input projection is hoisted out of it)
# ---------------------------------------------------------------------------

def _needs_grad(*tensors):
    """Grad mode is on and some input requires grad: the autograd route."""
    return torch.is_grad_enabled() and any(
        a is not None and a.requires_grad for a in tensors)


def _activation(name):
    """A recurrent op's ``activation``: a callable as it is, an op name
    through ``OPS`` (as the reference resolves it), else a layer
    activation name ("rationaltanh", "leakyrelu:0.2", ...)."""
    if callable(name):
        return name
    if name in OPS:
        return OPS[name]
    # imported here: the nn package imports the network, which imports
    # SameDiff's module, which imports this one
    from deeplearning4j_tpu_torch.nn.activations import resolve_activation

    return resolve_activation(name)


@op("lstmCell")
def lstmCell(x, h_prev, c_prev, w, r, b=None, forgetBias=0.0):
    """One LSTM step. x:[N,I], h_prev/c_prev:[N,H], w:[I,4H], r:[H,4H],
    b:[4H]."""
    z = x @ w + h_prev @ r
    if b is not None:
        z = z + b
    hsz = h_prev.shape[-1]
    i, f, g, o = (z[..., k * hsz:(k + 1) * hsz] for k in range(4))
    i = torch.sigmoid(i)
    f = torch.sigmoid(f + forgetBias)
    g = torch.tanh(g)
    o = torch.sigmoid(o)
    c = f * c_prev + i * g
    h = o * torch.tanh(c)
    return h, c


@op("lstmLayer")
def lstmLayer(x, w, r, b=None, h0=None, c0=None, forgetBias=0.0,
              returnFullSequence=True, unroll=4):
    """x: [N, I, T] (DL4J NCW layout). Returns ([N,H,T], hT, cT), or
    (hT, hT, cT) when not returnFullSequence.

    The input projection for ALL timesteps is hoisted out of the
    recurrence as one [T*N, I] x [I, 4H] matmul, with the bias and
    forgetBias folded into it; only h.R stays inside the recurrence,
    which runs in ``kernels.lstm`` (the CUDA kernels on the GPU, their
    plain versions on the CPU): ``lstm_seq`` when grad mode is on and an
    input requires grad, ``lstm_seq_infer`` otherwise. ``unroll`` is the
    reference's ``lax.scan`` unroll factor, taken for its signature and
    ignored: the kernel runs the whole sequence.

    Another dtype (bfloat16 under a precision policy) runs a plain PyTorch
    loop over T on any device, as the JAX package runs a ``lax.scan``
    there (its Pallas kernel takes float32 only): the step's arithmetic is
    the scan's, forgetBias added inside the step, and a float32 carry
    beside bfloat16 weights promotes the step to float32, as JAX's type
    promotion does."""
    n, _, t = x.shape
    hsz = r.shape[0]
    if h0 is None:
        h0 = torch.zeros((n, hsz), dtype=x.dtype, device=x.device)
    if c0 is None:
        c0 = torch.zeros((n, hsz), dtype=x.dtype, device=x.device)
    if any(a is not None and a.dtype != torch.float32
           for a in (x, w, r, b, h0, c0)):
        return _lstm_loop(x, w, r, b, h0, c0, forgetBias,
                          returnFullSequence)

    xw = x.permute(2, 0, 1) @ w     # [T, N, 4H]: one batched matmul
    if b is not None:
        xw = xw + b
    if forgetBias:
        xw[:, :, hsz:2 * hsz] += forgetBias   # xw is a fresh tensor here
    seq = lstm_seq if _needs_grad(x, w, r, b, h0, c0) else lstm_seq_infer
    hs, hT, cT = seq(xw, r, h0, c0)
    if not returnFullSequence:
        return hT, hT, cT
    return hs.permute(1, 2, 0), hT, cT   # [N, H, T]


def _lstm_loop(x, w, r, b, h0, c0, forgetBias, returnFullSequence):
    """``lstmLayer``'s recurrence as the JAX package's ``lax.scan`` step,
    one timestep at a time, in the promoted dtype of its operands."""
    hsz = r.shape[0]
    xw = x.permute(2, 0, 1) @ w     # [T, N, 4H]: one batched matmul
    if b is not None:
        xw = xw + b
    dt = functools.reduce(torch.promote_types,
                          (xw.dtype, r.dtype, h0.dtype, c0.dtype))
    xw, r, h, c = (a.to(dt) for a in (xw, r, h0, c0))
    hs = []
    for xw_t in xw:
        z = xw_t + h @ r
        i, f, g, o = (z[..., k * hsz:(k + 1) * hsz] for k in range(4))
        i = torch.sigmoid(i)
        f = torch.sigmoid(f + forgetBias)
        g = torch.tanh(g)
        o = torch.sigmoid(o)
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
    if not returnFullSequence:
        return h, h, c
    return torch.stack(hs, dim=2), h, c   # [N, H, T]


@op("gruCell")
def gruCell(x, h_prev, w, r, b=None):
    """One GRU step (reset-after). x:[N,I], h_prev:[N,H], w:[I,3H],
    r:[H,3H], b:[6H] (r, u then c; input and recurrent biases separate,
    as in libnd4j's gruCell)."""
    hsz = h_prev.shape[-1]
    wz = x @ w
    rz = h_prev @ r
    if b is not None:
        wz = wz + b[:3 * hsz]
        rz = rz + b[3 * hsz:]
    ru = torch.sigmoid(wz[..., :2 * hsz] + rz[..., :2 * hsz])
    rgate, ugate = ru[..., :hsz], ru[..., hsz:]
    cand = torch.tanh(wz[..., 2 * hsz:] + rgate * rz[..., 2 * hsz:])
    return ugate * h_prev + (1 - ugate) * cand


@op("gruLayer")
def gruLayer(x, w, r, b=None, h0=None, unroll=4, resetAfter=True,
             activation="tanh"):
    """x: [N, I, T] (DL4J NCW layout). Returns ([N,H,T], hT).

    The input projection for ALL timesteps is hoisted out of the
    recurrence as one [T*N, I] x [I, 3H] matmul, with the input bias
    folded into it; only h.R stays inside the recurrence. ``unroll`` is
    taken for the reference's signature and ignored.

    resetAfter=True (the cuDNN / Keras-v2 convention): cand = act(xw_c +
    r (h R_c + rb_c)), b holds [3H input || 3H recurrent] (or only the 3H
    input half, rb then 0). With ``tanh`` in float32 the recurrence runs in
    ``kernels.gru`` (the CUDA kernels on the GPU, their plain versions on
    the CPU): ``gru_seq`` when grad mode is on and an input requires grad,
    ``gru_seq_infer`` otherwise. resetAfter=False (the classic Cho et al.
    form: cand = act(xw_c + (r h) R_c), b is 3H input-side only), another
    activation or another dtype runs a plain PyTorch loop over T on any
    device: the JAX package runs those as a ``lax.scan`` with no Pallas
    kernel either."""
    n, _, t = x.shape
    hsz = r.shape[0]
    if h0 is None:
        h0 = torch.zeros((n, hsz), dtype=x.dtype, device=x.device)
    xw = x.permute(2, 0, 1) @ w     # [T, N, 3H]: one batched matmul
    if b is not None:
        xw = xw + b[:3 * hsz]
    rb = b[3 * hsz:] if b is not None and b.shape[0] > 3 * hsz else None

    if resetAfter and activation == "tanh" and all(
            a is None or a.dtype == torch.float32 for a in (x, w, r, b, h0)):
        if rb is None:
            rb = torch.zeros(3 * hsz, dtype=r.dtype, device=r.device)
        seq = gru_seq if _needs_grad(x, w, r, b, h0) else gru_seq_infer
        hs, hT = seq(xw, r, rb, h0)
        return hs.permute(1, 2, 0), hT   # [N, H, T]

    act = _activation(activation)
    h = h0
    hs = []
    for xw_t in xw:
        ru_w, c_w = xw_t[:, :2 * hsz], xw_t[:, 2 * hsz:]
        if resetAfter:
            rz = h @ r
            if rb is not None:
                rz = rz + rb
            ru = torch.sigmoid(ru_w + rz[:, :2 * hsz])
            cand = act(c_w + ru[:, :hsz] * rz[:, 2 * hsz:])
        else:
            ru = torch.sigmoid(ru_w + h @ r[:, :2 * hsz])
            cand = act(c_w + (ru[:, :hsz] * h) @ r[:, 2 * hsz:])
        u = ru[:, hsz:]
        h = u * h + (1.0 - u) * cand
        hs.append(h)
    return torch.stack(hs, dim=2), h


@op("simpleRnnLayer")
def simpleRnnLayer(x, w, r, b=None, h0=None, activation="tanh", unroll=4):
    """x: [N, I, T] (DL4J NCW layout). Returns ([N,H,T], hT) of
    h_t = act(x_t W + b + h_{t-1} R).

    The input projection for ALL timesteps is hoisted out of the
    recurrence as one [T*N, I] x [I, H] matmul with the bias folded in, as
    the JAX package does; each step is then one ``addmm`` and the
    activation, a plain PyTorch loop on any device (the JAX package runs
    it as a ``lax.scan`` with no Pallas kernel). ``unroll`` is taken for
    the reference's signature and ignored."""
    n = x.shape[0]
    hsz = r.shape[0]
    if h0 is None:
        h0 = torch.zeros((n, hsz), dtype=x.dtype, device=x.device)
    act = _activation(activation)
    xw = x.permute(2, 0, 1) @ w     # [T, N, H]: one batched matmul
    if b is not None:
        xw = xw + b
    h = h0
    hs = []
    for xw_t in xw:
        h = act(torch.addmm(xw_t, h, r))
        hs.append(h)
    return torch.stack(hs, dim=2), h


# ---------------------------------------------------------------------------
# attention (plain, as in the reference, which computes these outside any
# Pallas kernel)
# ---------------------------------------------------------------------------

@op("dotProductAttention")
def _dot_product_attention(q, k, v, mask=None, scaled=True):
    """q:[..., T_q, D], k:[..., T_k, D], v:[..., T_k, Dv]."""
    scale = 1.0 / _math.sqrt(q.shape[-1]) if scaled else 1.0
    logits = (q * scale) @ torch.swapaxes(k, -1, -2)
    if mask is not None:
        logits = torch.where(mask.to(torch.bool), logits,
                             torch.full((), -1e30, dtype=logits.dtype,
                                        device=logits.device))
    return torch.softmax(logits, dim=-1) @ v


@op("multiHeadDotProductAttention")
def _mhdpa(q, k, v, wq, wk, wv, wo, mask=None, numHeads=1, scaled=True):
    """Batched multi-head attention: q/k/v [N, T, E]; wq/wk/wv [E, H*Dh],
    wo [H*Dh, E]."""
    n, tq, _ = q.shape

    def heads(x, wm):
        y = x @ wm
        return y.reshape(n, x.shape[1], numHeads, -1).permute(0, 2, 1, 3)

    qh, kh, vh = heads(q, wq), heads(k, wk), heads(v, wv)
    if mask is not None and mask.dim() == 2:
        mask = mask[:, None, None, :]
    o = _dot_product_attention(qh, kh, vh, mask, scaled)
    return o.permute(0, 2, 1, 3).reshape(n, tq, -1) @ wo


# ---------------------------------------------------------------------------
# losses (reference: SDLoss / org.nd4j.linalg.lossfunctions)
# ---------------------------------------------------------------------------

def _reduce_loss(per_ex, weights, reduction):
    if weights is not None:
        per_ex = per_ex * weights
    if reduction in ("MEAN_BY_NONZERO_WEIGHT_COUNT", "MEAN_BY_WEIGHT"):
        if weights is not None:
            denom = torch.clamp(torch.sum(weights != 0), min=1)
            return torch.sum(per_ex) / denom
        return torch.mean(per_ex)
    if reduction == "SUM":
        return torch.sum(per_ex)
    if reduction == "NONE":
        return per_ex
    return torch.mean(per_ex)


def _mean_rest(per):
    """The mean over every axis but the first (per-example)."""
    return torch.mean(per, dim=tuple(range(1, per.dim()))) \
        if per.dim() > 1 else per


@op("softmaxCrossEntropy")
def _softmax_ce(logits, labels, weights=None, labelSmoothing=0.0,
                reduction="MEAN_BY_NONZERO_WEIGHT_COUNT"):
    nc = logits.shape[-1]
    if labelSmoothing > 0:
        labels = labels * (1 - labelSmoothing) + labelSmoothing / nc
    lp = torch.log_softmax(logits, dim=-1)
    per_ex = -torch.sum(labels * lp, dim=-1)
    return _reduce_loss(per_ex, weights, reduction)


@op("sparseSoftmaxCrossEntropy")
def _sparse_softmax_ce(logits, labels,
                       reduction="MEAN_BY_NONZERO_WEIGHT_COUNT"):
    lp = torch.log_softmax(logits, dim=-1)
    per_ex = -torch.gather(lp, -1, _long(labels)[..., None])[..., 0]
    return _reduce_loss(per_ex, None, reduction)


@op("sigmoidCrossEntropy")
def _sigmoid_ce(logits, labels, weights=None,
                reduction="MEAN_BY_NONZERO_WEIGHT_COUNT"):
    per = _max(logits, 0.0) - logits * labels + torch.log1p(
        torch.exp(-_abs(logits)))
    return _reduce_loss(_mean_rest(per), weights, reduction)


@op("meanSquaredError")
def _mse(predictions, labels, weights=None,
         reduction="MEAN_BY_NONZERO_WEIGHT_COUNT"):
    return _reduce_loss(_mean_rest((predictions - labels) ** 2), weights,
                        reduction)


@op("absoluteDifference")
def _mae(predictions, labels, weights=None,
         reduction="MEAN_BY_NONZERO_WEIGHT_COUNT"):
    return _reduce_loss(_mean_rest(_abs(predictions - labels)),
                        weights, reduction)


@op("huberLoss")
def _huber(predictions, labels, weights=None, delta=1.0,
           reduction="MEAN_BY_NONZERO_WEIGHT_COUNT"):
    err = _abs(predictions - labels)
    per = torch.where(err <= delta, 0.5 * err**2,
                      delta * err - 0.5 * delta**2)
    return _reduce_loss(_mean_rest(per), weights, reduction)


@op("logLoss")
def _log_loss(predictions, labels, weights=None, epsilon=1e-7,
              reduction="MEAN_BY_NONZERO_WEIGHT_COUNT"):
    p = _clip(predictions, epsilon, 1 - epsilon)
    per = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))
    return _reduce_loss(_mean_rest(per), weights, reduction)


@op("hingeLoss")
def _hinge(predictions, labels, weights=None,
           reduction="MEAN_BY_NONZERO_WEIGHT_COUNT"):
    # labels in {0,1} -> {-1,1} like SDLoss.hingeLoss
    y = 2.0 * labels - 1.0
    per = _max(1.0 - y * predictions, 0.0)
    return _reduce_loss(_mean_rest(per), weights, reduction)


@op("cosineDistance")
def _cosine_distance(predictions, labels, weights=None, dimension=-1,
                     reduction="MEAN_BY_NONZERO_WEIGHT_COUNT"):
    per_ex = 1.0 - torch.sum(predictions * labels, dim=dimension)
    return _reduce_loss(per_ex, weights, reduction)


@op("klDivergence")
def _kld(predictions, labels, reduction="MEAN_BY_NONZERO_WEIGHT_COUNT"):
    per = labels * (torch.log(_max(labels, 1e-12)) -
                    torch.log(_max(predictions, 1e-12)))
    per_ex = torch.sum(per, dim=tuple(range(1, per.dim()))) \
        if per.dim() > 1 else per
    return _reduce_loss(per_ex, None, reduction)


# ---------------------------------------------------------------------------
# control flow: the bodies are callables over tensors (a traced child
# graph's, or the user's own), run by Python loops; autograd records
# through every iteration and branch
# ---------------------------------------------------------------------------

def _as_tuple(v):
    return v if isinstance(v, tuple) else (v,)


@op("whileLoop")
def _while_loop(*state, cond_fn=None, body_fn=None):
    """state -> final state after `while cond_fn(*state): state =
    body_fn(*state)`."""
    state = tuple(state)
    while bool(cond_fn(*state)):
        state = tuple(body_fn(*state))
    return state if len(state) > 1 else state[0]


@op("ifCond")
def _if_cond(pred, *operands, true_fn=None, false_fn=None):
    take = bool(torch.as_tensor(pred).to(torch.bool).reshape(()))
    out = _as_tuple((true_fn if take else false_fn)(*operands))
    return out if len(out) > 1 else out[0]


@op("scanOp")
def _scan_op(init, xs, body_fn=None):
    """A scan over the leading axis of xs; body_fn(carry, x) -> (carry,
    y). Returns (final_carry, stacked_ys)."""
    carry, ys = init, []
    for x in xs:
        carry, y = body_fn(carry, x)
        ys.append(y)
    return carry, torch.stack(ys)


@op("forLoop")
def _for_loop(*state, n=None, body_fn=None):
    """n fixed iterations: state = body_fn(i, *state), i an int32 scalar
    as lax.fori_loop gives it."""
    state = tuple(state)
    dev = state[0].device if state else None
    for i in range(n):
        state = tuple(body_fn(torch.tensor(i, dtype=torch.int32,
                                           device=dev), *state))
    return state if len(state) > 1 else state[0]


# ---------------------------------------------------------------------------
# TF-import support ops
# ---------------------------------------------------------------------------

@op("tfEinsum")
def _tf_einsum(*xs, equation=None):
    return torch.einsum(equation, *xs)


@op("tfZerosLike")
def _tf_zeros_like(x):
    return torch.zeros_like(x)


@op("tfOnesLike")
def _tf_ones_like(x):
    return torch.ones_like(x)


@op("tfStridedSlice")
def _tf_strided_slice(x, idx=None):
    return _getitem(x, tuple(
        None if i is None else (slice(*i) if isinstance(i, (list, tuple))
                                else i)
        for i in idx))




def _ints(v):
    """The integers of an attribute given as a number, a list, an array or
    a tensor (flattened)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return [int(a) for a in np.asarray(v).reshape(-1)]


def _shape(v):
    return tuple(v.shape) if hasattr(v, "shape") else np.shape(v)


def _unbroadcast(g, shape):
    """Sum a broadcast gradient back to an input's shape."""
    if g is None or tuple(g.shape) == tuple(shape):
        return g
    lead = g.dim() - len(shape)
    g = g.sum(dim=tuple(range(lead))) if lead else g
    dims = tuple(i for i, s in enumerate(shape) if s == 1 and g.shape[i] != 1)
    return g.sum(dim=dims, keepdim=True) if dims else g


def _promote(*xs):
    """Tensors of the float inputs of a special function, on the device and
    dtype of the first tensor among them."""
    like = next(x for x in xs if isinstance(x, torch.Tensor))
    dt = like.dtype if like.is_floating_point() else torch.float32
    return [x.to(dt) if isinstance(x, torch.Tensor) else
            torch.as_tensor(x, dtype=dt, device=like.device) for x in xs]


# ---------------------------------------------------------------------------
# linear algebra (torch.linalg: LAPACK on the CPU, cuSOLVER and cuBLAS on
# the card; the reference leaves these to XLA, not to Pallas)
# ---------------------------------------------------------------------------

@op("cholesky")
def _cholesky(x):
    """jnp.linalg.cholesky: the input symmetrized first (so its gradient is
    symmetric); where a matrix is not positive definite its lower
    triangle is NaN."""
    lo, info = torch.linalg.cholesky_ex((x + x.mT) / 2)
    bad = (info != 0)[..., None, None]
    return torch.tril(torch.where(bad, torch.full(
        (), float("nan"), dtype=lo.dtype, device=lo.device), lo))


OPS["matrixInverse"] = lambda x: torch.linalg.inv_ex(x)[0]
OPS["matrixDeterminant"] = torch.linalg.det
OPS["logdet"] = lambda x: torch.linalg.slogdet(x)[1]
OPS["trace"] = lambda x: torch.sum(torch.diagonal(x, dim1=-2, dim2=-1),
                                   dim=-1, dtype=_acc(x))


@op("solve")
def _solve(a, b, adjoint=False):
    """jnp.linalg.solve: b of one dimension is a vector, else a (batch of)
    matrix."""
    if adjoint:
        a = a.mT.conj()
    if b.dim() == 1:
        return torch.linalg.solve_ex(a, b.unsqueeze(-1))[0].squeeze(-1)
    return torch.linalg.solve_ex(a, b)[0]


@op("triangularSolve")
def _triangular_solve(a, b, lower=True, adjoint=False):
    """jax.scipy.linalg.solve_triangular(a, b, lower, trans=2 if adjoint):
    b with one dimension fewer than a is a vector."""
    vec = b.dim() == a.dim() - 1
    if vec:
        b = b.unsqueeze(-1)
    if adjoint:
        y = torch.linalg.solve_triangular(a.mH, b, upper=lower)
    else:
        y = torch.linalg.solve_triangular(a, b, upper=not lower)
    return y.squeeze(-1) if vec else y


@op("svd")
def _svd(x, fullUV=False, computeUV=True):
    """(s, u, v) as DL4J returns them; computeUV is taken for the
    signature, U and V are always produced (the op's arity stays 3)."""
    u, s, vh = torch.linalg.svd(x, full_matrices=fullUV)
    return s, u, vh.mT


@op("qr")
def _qr(x, fullMatrices=False):
    return tuple(torch.linalg.qr(x, mode="complete" if fullMatrices
                                 else "reduced"))


@op("lu")
def _lu(x):
    """jax.scipy.linalg.lu_factor: the packed LU and the 0-based int32
    pivot rows (LAPACK's getrf, whose pivots torch gives 1-based)."""
    lu, piv, _ = torch.linalg.lu_factor_ex(x)
    return lu, (piv - 1).to(torch.int32)


@op("lstsq")
def _lstsq(a, b, fast=True):
    """jnp.linalg.lstsq's solution: the pseudo-inverse by SVD with singular
    values below max(m, n) * eps of the largest cut, as jnp's default
    rcond."""
    return torch.linalg.pinv(a) @ b


@op("matrixBandPart")
def _matrix_band_part(x, minLower=-1, maxUpper=-1):
    m, n = x.shape[-2], x.shape[-1]
    i = torch.arange(m, device=x.device)[:, None]
    j = torch.arange(n, device=x.device)[None, :]
    keep = torch.ones((m, n), dtype=torch.bool, device=x.device)
    if minLower >= 0:
        keep = keep & (i - j <= minLower)
    if maxUpper >= 0:
        keep = keep & (j - i <= maxUpper)
    return torch.where(keep, x, torch.zeros_like(x))


OPS["triu"] = lambda x, diag=0: torch.triu(x, diagonal=diag)
OPS["tril"] = lambda x, diag=0: torch.tril(x, diagonal=diag)
OPS["diagPart"] = lambda x: torch.diagonal(x, dim1=-2, dim2=-1)


# ---------------------------------------------------------------------------
# segment reductions (jax.ops.segment_*): ids outside [0, numSegments) are
# dropped, an empty segment holds the reduction's identity
# ---------------------------------------------------------------------------

def _num_segments(ids, numSegments):
    if numSegments is not None:
        return int(numSegments)
    if ids.device.type == "meta":
        raise ValueError(
            "segment ops need numSegments when the ids are not known (a "
            "static output shape when the graph is built); pass "
            "numSegments explicitly")
    return int(ids.max()) + 1


def _identity_of(reduce, dtype):
    if reduce in ("sum", "mean"):
        return 0
    if reduce == "prod":
        return 1
    if dtype == torch.bool:
        return reduce == "amin"
    if dtype.is_floating_point:
        return float("-inf") if reduce == "amax" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if reduce == "amax" else info.max


def _segment_reduce(data, ids, n, reduce):
    """scatter_reduce of data's rows into n segments plus one more, where
    the rows of ids outside [0, n) land and which is then dropped."""
    rows = data.reshape((-1,) + tuple(data.shape[max(ids.dim(), 1):]))
    ids = _long(ids).reshape(-1)
    ids = torch.where((ids >= 0) & (ids < n), ids, n)
    index = ids.reshape((-1,) + (1,) * (rows.dim() - 1)).expand(rows.shape)
    out = torch.full((n + 1,) + tuple(rows.shape[1:]),
                     _identity_of(reduce, rows.dtype), dtype=rows.dtype,
                     device=rows.device)
    return out.scatter_reduce(0, index, rows, reduce,
                              include_self=True)[:n]


def _segment(reduce):
    def f(data, ids, numSegments=None):
        return _segment_reduce(data, ids, _num_segments(ids, numSegments),
                               reduce)

    return f


OPS["segmentSum"] = OPS["unsortedSegmentSum"] = _segment("sum")
OPS["segmentMax"] = OPS["unsortedSegmentMax"] = _segment("amax")
OPS["segmentMin"] = OPS["unsortedSegmentMin"] = _segment("amin")
OPS["segmentProd"] = OPS["unsortedSegmentProd"] = _segment("prod")


@op("segmentMean")
def _segment_mean(data, ids, numSegments=None):
    n = _num_segments(ids, numSegments)
    s = _segment_reduce(data, ids, n, "sum")
    c = _segment_reduce(torch.ones_like(data), ids, n, "sum")
    return s / _max(c, 1)


OPS["unsortedSegmentMean"] = _segment_mean


# ---------------------------------------------------------------------------
# topK / misc (stable sorts: among equal values the lower index first, as
# lax.top_k orders them)
# ---------------------------------------------------------------------------

@op("topK")
def _top_k(x, k=1, sorted=True):  # noqa: A002
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    k = int(k)
    return v[..., :k], i[..., :k].to(torch.int32)


@op("inTopK")
def _in_top_k(predictions, targets, k=1):
    _, idx = _top_k(predictions, k)
    return torch.any(idx == targets.to(torch.int32)[..., None], dim=-1)


def _bincount(x, weights, length):
    """jnp.bincount(x, weights, length=length): a negative value counts in
    bin 0, a value past the end is dropped; int32 counts, or the weights'
    dtype."""
    x = torch.clamp(_long(x).reshape(-1), min=0)
    x = torch.where(x < length, x, length)
    w = torch.ones(x.shape, dtype=torch.int32, device=x.device) \
        if weights is None else weights.reshape(-1)
    out = torch.zeros(length + 1, dtype=w.dtype, device=x.device)
    return out.index_add(0, x, w)[:length]


@op("confusionMatrix")
def _confusion_matrix(labels, pred, numClasses):
    n = int(numClasses)
    return _bincount(_long(labels) * n + _long(pred), None, n * n).reshape(
        n, n)


@op("bincount")
def _bincount_op(x, weights=None, minLength=0, maxLength=None):
    """DL4J bincount(values, weights, minLength, maxLength). With maxLength
    the output length is fixed (values >= it are dropped, TF maxlength
    semantics); otherwise it is max(values)+1 extended to minLength, which
    needs the values."""
    if maxLength is not None:
        return _bincount(x, weights, max(int(minLength), int(maxLength)))
    if x.device.type == "meta":
        raise ValueError(
            "bincount without maxLength needs the values; inside a graph "
            "whose shapes are fixed when it is built pass maxLength")
    m = int(_long(x).max()) + 1
    return _bincount(x, weights, max(m, int(minLength)))


# ---------------------------------------------------------------------------
# image / spatial ops (NCHW, the DL4J layout): jax.image.resize's weights,
# computed on the host as jax computes them, then one contraction a
# spatial dim
# ---------------------------------------------------------------------------

def _area_weight_matrix(n_in, n_out):
    """(n_out, n_in) row-stochastic overlap weights: output cell i spans
    input range [i*s, (i+1)*s), s = n_in/n_out; each input pixel
    contributes its fractional overlap (TF ResizeArea region averaging)."""
    s = n_in / n_out
    mat = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        lo, hi = i * s, (i + 1) * s
        for j in range(int(np.floor(lo)), min(int(np.ceil(hi)), n_in)):
            mat[i, j] = min(hi, j + 1) - max(lo, j)
        mat[i] /= s
    return mat


def _kernel_triangle(x):
    return np.maximum(np.float32(0), 1 - np.abs(x))


def _kernel_keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = np.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return np.where(x >= 2., 0., out)


def _kernel_lanczos(radius):
    def k(x):
        with np.errstate(divide="ignore", invalid="ignore"):
            y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
            out = np.where(x > 1e-3, y / np.where(x != 0, np.pi ** 2 * x ** 2,
                                                  1), 1)
        return np.where(x > radius, 0., out)

    return k


_RESIZE_KERNELS = {"bilinear": _kernel_triangle, "cubic": _kernel_keys_cubic,
                   "lanczos3": _kernel_lanczos(3.0),
                   "lanczos5": _kernel_lanczos(5.0)}


def _resize_weights(n_in, n_out, kernel, antialias):
    """jax.image's compute_weight_mat in float32: [n_in, n_out] weights
    with half-pixel centres, each column normalized over the input, zero
    where the sample lies outside the input."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(n_out / n_in)
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / f32(kernel_scale)
    w = kernel(x.astype(f32)).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000. * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def _resize_nearest_index(n_in, n_out):
    off = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(n_in) / np.float32(n_out)
    return np.floor(off.astype(np.float32)).astype(np.int64)


@op("imageResize")
def _image_resize(x, height, width, method="bilinear", antialias=False):
    """x: [N,C,H,W]; method: bilinear|nearest|cubic|lanczos3|lanczos5|area,
    as jax.image.resize (half-pixel centres, Keys cubic a = -0.5) with
    antialias off by default, as the TF/DL4J resize ops. ``area`` averages
    exact input regions (TF ResizeArea)."""
    height, width = int(height), int(width)
    n, c, h, w = x.shape
    m = str(method).lower()
    if m == "area":
        if h % height == 0 and w % width == 0:
            fh, fw = h // height, w // width
            return _as_float(x).reshape(n, c, height, fh, width, fw).mean(
                dim=(3, 5))
        xf = x.to(torch.float32)
        wh = torch.from_numpy(_area_weight_matrix(h, height)).to(x.device)
        ww = torch.from_numpy(_area_weight_matrix(w, width)).to(x.device)
        return torch.einsum("nchw,Hh,Ww->ncHW", xf, wh, ww)
    meth = {"bilinear": "bilinear", "nearest": "nearest", "cubic": "cubic",
            "bicubic": "cubic", "lanczos3": "lanczos3",
            "lanczos5": "lanczos5"}[m]
    if meth == "nearest":
        for d, n_out in ((2, height), (3, width)):
            if x.shape[d] != n_out:
                x = x.index_select(d, torch.from_numpy(_resize_nearest_index(
                    x.shape[d], n_out)).to(x.device))
        return x
    x = _as_float(x)
    for d, n_out in ((2, height), (3, width)):
        if x.shape[d] != n_out:
            wm = torch.from_numpy(_resize_weights(
                x.shape[d], n_out, _RESIZE_KERNELS[meth], antialias)).to(
                dtype=x.dtype, device=x.device)
            x = torch.movedim(torch.movedim(x, d, -1) @ wm, -1, d)
    return x


@op("extractImagePatches")
def _extract_image_patches(x, kH, kW, sH=1, sW=1, sameMode=False):
    """The patch feature dim ordered (kh, kw, c), depth fastest, as TF/DL4J
    extract_image_patches orders it."""
    kH, kW, sH, sW = int(kH), int(kW), int(sH), int(sW)
    n, c = x.shape[0], x.shape[1]
    if sameMode:
        x = _pad_spatial(x, _same_pads(x.shape[2:], (kH, kW), (sH, sW),
                                       (1, 1)))
    oh = (x.shape[2] - kH) // sH + 1
    ow = (x.shape[3] - kW) // sW + 1
    p = F.unfold(x, (kH, kW), stride=(sH, sW))
    return p.reshape(n, c, kH, kW, oh, ow).permute(0, 2, 3, 1, 4, 5).reshape(
        n, kH * kW * c, oh, ow)


@op("spaceToDepth")
def _space_to_depth(x, blockSize=2):
    n, c, h, w = x.shape
    b = int(blockSize)
    x = x.reshape(n, c, h // b, b, w // b, b)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(n, c * b * b, h // b, w // b)


@op("depthToSpace")
def _depth_to_space(x, blockSize=2):
    n, c, h, w = x.shape
    b = int(blockSize)
    cout = c // (b * b)
    x = x.reshape(n, b, b, cout, h, w)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(n, cout, h * b, w * b)


@op("spaceToBatch")
def _space_to_batch(x, blockSize=2, padding=((0, 0), (0, 0))):
    n, c = x.shape[0], x.shape[1]
    b = int(blockSize)
    pads = np.asarray(_ints(padding)).reshape(2, 2)
    x = _pad_spatial(x, [tuple(int(v) for v in p) for p in pads])
    h2, w2 = x.shape[2], x.shape[3]
    x = x.reshape(n, c, h2 // b, b, w2 // b, b)
    return x.permute(3, 5, 0, 1, 2, 4).reshape(n * b * b, c, h2 // b,
                                               w2 // b)


@op("batchToSpace")
def _batch_to_space(x, blockSize=2, crop=((0, 0), (0, 0))):
    nb, c, h, w = x.shape
    b = int(blockSize)
    n = nb // (b * b)
    x = x.reshape(b, b, n, c, h, w)
    x = x.permute(2, 3, 4, 0, 5, 1).reshape(n, c, h * b, w * b)
    ct, cb, cl, cr = _ints(crop)
    return x[:, :, ct: x.shape[2] - cb, cl: x.shape[3] - cr]


# ---------------------------------------------------------------------------
# special functions: torch's where it has them, with the gradients
# jax.grad gives; the incomplete gamma's derivative in a and the
# incomplete beta by series and continued fraction in float64
# ---------------------------------------------------------------------------

OPS["erfc"] = torch.special.erfc
OPS["lgamma"] = torch.lgamma
# digamma has a pole at 0, where jax gives NaN (torch gives -inf)
OPS["digamma"] = lambda x: torch.where(
    x == 0, torch.full((), float("nan"), dtype=x.dtype, device=x.device),
    torch.digamma(x))
OPS["atan2"] = torch.atan2
OPS["expm1"] = torch.expm1
OPS["asinh"] = torch.asinh
OPS["acosh"] = torch.acosh
OPS["atanh"] = torch.atanh


def _igamma_da(a, x):
    """d/da of the regularized lower incomplete gamma P(a, x), term by term
    of its series P = sum_n exp((a + n) ln x - x - lgamma(a + n + 1)), in
    float64; the series runs past its largest term (n near x) until the
    terms are below float64's resolution."""
    a, x = torch.broadcast_tensors(a.double(), x.double())
    top = float(x.max()) if x.numel() else 0.0
    terms = int(min(4000, max(60.0, top + 12.0 * _math.sqrt(max(top, 0.0))
                              + 40.0)))
    n = torch.arange(terms, dtype=torch.float64, device=a.device).reshape(
        (-1,) + (1,) * a.dim())
    lx = torch.log(torch.where(x > 0, x, 1.0))
    an1 = a + n + 1
    t = torch.exp((a + n) * lx - x - torch.lgamma(an1))
    d = torch.sum(t * (lx - torch.digamma(an1)), dim=0)
    return torch.where(x > 0, d, 0.0)


class _IGamma(torch.autograd.Function):
    """P(a, x) (``upper`` False) or Q(a, x) = 1 - P(a, x) (``upper``)."""

    @staticmethod
    def forward(ctx, a, x, upper):
        ctx.save_for_backward(a, x)
        ctx.upper = upper
        return (torch.special.gammaincc if upper else
                torch.special.gammainc)(a, x)

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        sign = -1.0 if ctx.upper else 1.0
        ga = gx = None
        if ctx.needs_input_grad[0]:
            ga = _unbroadcast(g * sign * _igamma_da(a, x).to(g.dtype),
                              a.shape)
        if ctx.needs_input_grad[1]:
            # dP/dx = x^(a-1) e^-x / Gamma(a)
            gx = _unbroadcast(g * sign * torch.exp(
                (a - 1) * torch.log(x) - x - torch.lgamma(a)), x.shape)
        return ga, gx, None


def _igamma(a, x):
    a, x = _promote(a, x)
    return _IGamma.apply(a, x, False)


def _igammac(a, x):
    a, x = _promote(a, x)
    return _IGamma.apply(a, x, True)


OPS["igamma"] = _igamma
OPS["igammac"] = _igammac

_TINY = 1e-300


def _betacf(a, b, x, iters=300):
    """The continued fraction of the incomplete beta function (Lentz's
    method, float64), a fixed number of terms for every element."""
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 - qab * x / qap
    d = 1.0 / torch.where(d.abs() < _TINY, _TINY, d)
    h = d
    for m in range(1, iters + 1):
        m2 = 2 * m
        for aa in (m * (b - m) * x / ((qam + m2) * (a + m2)),
                   -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))):
            d = 1.0 + aa * d
            d = 1.0 / torch.where(d.abs() < _TINY, _TINY, d)
            c = 1.0 + aa / c
            c = torch.where(c.abs() < _TINY, _TINY, c)
            h = h * d * c
    return h


def _betainc_value(a, b, x):
    """The regularized incomplete beta I_x(a, b) in float64: NaN outside
    0 <= x <= 1 or for a, b <= 0, as jax.scipy.special.betainc."""
    a, b, x = torch.broadcast_tensors(a.double(), b.double(), x.double())
    inner = (x > 0) & (x < 1)
    xs = torch.where(inner, x, 0.5)
    swap = xs >= (a + 1.0) / (a + b + 2.0)
    a2, b2 = torch.where(swap, b, a), torch.where(swap, a, b)
    x2 = torch.where(swap, 1.0 - xs, xs)
    front = torch.exp(torch.lgamma(a2 + b2) - torch.lgamma(a2)
                      - torch.lgamma(b2) + a2 * torch.log(x2)
                      + b2 * torch.log1p(-x2)) / a2
    v = front * _betacf(a2, b2, x2)
    v = torch.where(swap, 1.0 - v, v)
    v = torch.where(x <= 0, 0.0, torch.where(x >= 1, 1.0, v))
    bad = (x < 0) | (x > 1) | (a <= 0) | (b <= 0) | x.isnan()
    return torch.where(bad, float("nan"), v)


class _BetaInc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, x):
        ctx.save_for_backward(a, b, x)
        return _betainc_value(a, b, x).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        a, b, x = ctx.saved_tensors
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            raise ValueError(
                "Betainc gradient with respect to a and b not supported.")
        # dI/dx = x^(a-1) (1-x)^(b-1) / B(a, b)
        gx = g * torch.exp((a - 1) * torch.log(x) + (b - 1) * torch.log1p(-x)
                           + torch.lgamma(a + b) - torch.lgamma(a)
                           - torch.lgamma(b))
        return None, None, _unbroadcast(gx, x.shape)


def _betainc(a, b, x):
    return _BetaInc.apply(*_promote(a, b, x))


OPS["betainc"] = _betainc


# ---------------------------------------------------------------------------
# CTC loss (libnd4j ctc_loss): the reference's log-space forward (alpha)
# recursion over time, step by step; autograd gives its gradient
# ---------------------------------------------------------------------------

@op("ctcLoss")
def _ctc_loss(targetLabels, logitInput, targetLabelLengths=None,
              logitInputLengths=None, blankIndex=0):
    """targetLabels: [B, U] int labels (padded); logitInput: [B, T, C]
    unnormalized logits; lengths: [B] ints. Returns the per-example
    negative log likelihood [B]; an alignment that cannot exist gives
    ~1e30, the reference's -inf stand-in."""
    labels = _long(targetLabels)
    logits = logitInput
    b, u = labels.shape
    t_max = logits.shape[1]
    dev = logits.device
    lab_len = torch.full((b,), u, dtype=torch.int64, device=dev) \
        if targetLabelLengths is None else _long(targetLabelLengths)
    log_len = torch.full((b,), t_max, dtype=torch.int64, device=dev) \
        if logitInputLengths is None else _long(logitInputLengths)
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)

    s = 2 * u + 1
    neg_inf = torch.full((), -1e30, device=dev)
    # extended sequence [blank, l1, blank, ..., lU, blank]
    ext = torch.full((b, s), int(blankIndex), dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels
    is_lab = torch.arange(s, device=dev) % 2 == 1
    ext_m2 = torch.cat([torch.full((b, 2), -1, dtype=torch.int64,
                                   device=dev), ext[:, :-2]], dim=1)
    allow_skip = is_lab[None, :] & (ext != ext_m2)
    pad = neg_inf.expand(b, 2)

    first = torch.gather(lp[:, 0], 1, ext)
    alpha = torch.cat([first[:, :2], neg_inf.expand(b, max(s - 2, 0))],
                      dim=1)[:, :s]
    for t in range(1, t_max):
        a1 = torch.cat([pad[:, :1], alpha[:, :-1]], dim=1)
        a2 = torch.cat([pad, alpha], dim=1)[:, :s]
        a2 = torch.where(allow_skip, a2, neg_inf)
        new = torch.logsumexp(torch.stack([alpha, a1, a2]), dim=0) + \
            torch.gather(lp[:, t], 1, ext)
        # freeze past each example's input length
        alpha = torch.where((t < log_len)[:, None], new, alpha)

    end = 2 * lab_len  # index of the final blank state
    a_end = torch.gather(alpha, 1, end[:, None])[:, 0]
    a_last = torch.gather(alpha, 1, torch.clamp(end - 1, min=0)[:, None])[:, 0]
    a_last = torch.where(lab_len > 0, a_last, neg_inf)
    return -torch.logsumexp(torch.stack([a_end, a_last]), dim=0)


# ---------------------------------------------------------------------------
# non-max suppression, a fixed number of picks (the output padded with -1)
# ---------------------------------------------------------------------------

@op("nonMaxSuppression")
def _non_max_suppression(boxes, scores, maxOutputSize=10,
                         iouThreshold=0.5, scoreThreshold=None):
    """boxes [N,4] (y1,x1,y2,x2), scores [N] -> selected indices
    [maxOutputSize] int32, padded with -1; a box overlapping a pick by an
    IoU strictly above the threshold is suppressed (TF/libnd4j)."""
    n = boxes.shape[0]
    k = int(maxOutputSize)
    y1, x1, y2, x2 = (boxes[:, i] for i in range(4))
    area = torch.clamp(y2 - y1, min=0) * torch.clamp(x2 - x1, min=0)
    iy1 = torch.maximum(y1[:, None], y1[None, :])
    ix1 = torch.maximum(x1[:, None], x1[None, :])
    iy2 = torch.minimum(y2[:, None], y2[None, :])
    ix2 = torch.minimum(x2[:, None], x2[None, :])
    inter = torch.clamp(iy2 - iy1, min=0) * torch.clamp(ix2 - ix1, min=0)
    union = area[:, None] + area[None, :] - inter
    iou = torch.where(union > 0, inter / torch.where(union > 0, union, 1),
                      torch.zeros_like(inter))
    live = torch.ones((n,), dtype=torch.bool, device=boxes.device)
    if scoreThreshold is not None:
        live = live & (scores >= scoreThreshold)
    ninf = torch.full((), float("-inf"), dtype=scores.dtype,
                      device=scores.device)
    pos = torch.arange(n, device=boxes.device)
    out = []
    for _ in range(k):
        masked = torch.where(live, scores, ninf)
        idx = torch.argmax(masked)
        ok = masked[idx] > ninf
        out.append(torch.where(ok, idx, -1).to(torch.int32))
        live = live & ~(iou[idx] > iouThreshold) & ok & (pos != idx)
    return torch.stack(out) if out else torch.zeros(
        (0,), dtype=torch.int32, device=boxes.device)


# ---------------------------------------------------------------------------
# shape / index utilities: roll, eye, repeat, flip, sort/argsort, fill,
# scatters
# ---------------------------------------------------------------------------

@op("roll")
def _roll(x, shift=1, dimensions=None):
    ax = _axis(dimensions, x.dim())
    if ax is None:
        return torch.roll(x, int(shift))
    shifts = _ints(shift)
    if len(shifts) == 1:
        shifts = shifts * len(ax)
    return torch.roll(x, tuple(shifts), ax)


@op("eye", device_aware=True)
def _eye_full(rows=None, cols=None, dtype="float32", device=None):
    return torch.eye(int(rows), int(rows) if cols is None else int(cols),
                     dtype=torch_dtype(dtype), device=device)


@op("repeat")
def _repeat(x, repeats=1, dimension=0):
    return torch.repeat_interleave(x, int(repeats), dim=int(dimension))


OPS["flip"] = OPS["reverse"]   # TF/DL4J name alias for the same op


@op("sort")
def _sort(x, dimension=-1, descending=False):
    y = torch.sort(x, dim=dimension, stable=True).values
    return torch.flip(y, (dimension,)) if descending else y


@op("argsort")
def _argsort(x, dimension=-1, descending=False):
    i = torch.argsort(x, dim=dimension, stable=True).to(torch.int32)
    return torch.flip(i, (dimension,)) if descending else i


@op("fill", device_aware=True)
def _fill(shape=None, value=0.0, dtype="float32", device=None):
    return torch.full(tuple(_ints(shape)), value, dtype=torch_dtype(dtype),
                      device=device)


def _scatter_nd_into(ref, indices, updates, accumulate):
    """ref.at[tuple(indices[..., k] for k)].set/add(updates): the last
    dim of indices addresses the first K dims of ref; a negative id wraps
    once, an entry still outside the range is dropped. Dropped entries go
    to one extra slot past the end, so the shapes never depend on the
    ids."""
    idx = _long(indices)
    k = idx.shape[-1]
    lead = tuple(idx.shape[:-1])
    rest = tuple(ref.shape[k:])
    lin = torch.zeros(lead, dtype=torch.int64, device=ref.device)
    valid = torch.ones(lead, dtype=torch.bool, device=ref.device)
    for d in range(k):
        n = ref.shape[d]
        i = idx[..., d]
        i = torch.where(i < 0, i + n, i)
        valid = valid & (i >= 0) & (i < n)
        lin = lin * n + i
    total = int(np.prod(ref.shape[:k])) if k else 1
    lin = torch.where(valid, lin, total)
    updates = torch.as_tensor(updates, dtype=ref.dtype, device=ref.device)
    updates = updates.expand(lead + rest).reshape((-1,) + rest)
    flat = torch.cat([ref.reshape((total,) + rest),
                      torch.zeros((1,) + rest, dtype=ref.dtype,
                                  device=ref.device)])
    out = flat.index_put((lin.reshape(-1),), updates, accumulate=accumulate)
    return out[:total].reshape(ref.shape)


@op("tensorScatterUpdate")
def _tensor_scatter_update(x, indices, updates):
    """TF tensor_scatter_nd_update: indices [N, K] index the first K dims
    of x; updates [N, ...]."""
    return _scatter_nd_into(x, indices, updates, False)


@op("uniqueWithCounts")
def _unique_with_counts(x, size=None):
    """jnp.unique(flat, return_counts=True, size=n, fill_value=flat[0]):
    (sorted values [n], int32 counts [n]), padded with the first element
    and zero counts, or cut to n; n defaults to x.size."""
    flat = x.reshape(-1)
    n = flat.shape[0] if size is None else int(size)
    vals, counts = torch.unique(flat, sorted=True, return_counts=True)
    counts = counts.to(torch.int32)
    short = n - vals.shape[0]
    if short > 0:
        vals = torch.cat([vals, flat[:1].expand(short)])
        counts = torch.cat([counts, counts.new_zeros(short)])
    return vals[:n], counts[:n]


# ---------------------------------------------------------------------------
# image adjustments and colorspace, scatter variants, separable conv / LRN
# / dilation, sequence utilities, loss variants, noise layers
# ---------------------------------------------------------------------------

@op("cross")
def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


OPS["rint"] = torch.round      # half to even, as jnp.rint
OPS["erfinv"] = torch.erfinv


@op("reverseSequence")
def _reverse_sequence(x, seq_lengths, seqAxis=1, batchAxis=0):
    """Reverse the first seq_lengths[b] elements along seqAxis for each
    batch row (TF reverse_sequence); a position that lands past the end
    reads NaN, as jnp.take fills it."""
    t = x.shape[seqAxis]
    y = torch.movedim(x, (batchAxis, seqAxis), (0, 1))
    idx = torch.arange(t, device=x.device)[None, :]
    sl = _long(seq_lengths)[:, None]
    src = torch.where(idx < sl, sl - 1 - idx, idx)       # [B, T]
    valid = (src >= 0) & (src < t)
    src = torch.where(valid, src, 0)
    shape = tuple(src.shape) + (1,) * (y.dim() - 2)
    out = torch.gather(y, 1, src.reshape(shape).expand(y.shape))
    if not bool(valid.all()) and out.is_floating_point():
        out = torch.where(valid.reshape(shape), out,
                          torch.full((), float("nan"), dtype=out.dtype,
                                     device=out.device))
    return torch.movedim(out, (0, 1), (batchAxis, seqAxis))


@op("histogramFixedWidth")
def _histogram_fixed_width(x, range_lo, range_hi, nbins=100):
    lo, hi = float(range_lo), float(range_hi)
    nbins = int(nbins)
    scaled = (_as_float(x).reshape(-1) - lo) / max(hi - lo, 1e-30) * nbins
    # saturate before the cast, as XLA's float-to-int conversion does
    b = torch.clamp(torch.clamp(scaled, -1.0, float(nbins)).to(torch.int32),
                    0, nbins - 1)
    return torch.zeros(nbins, dtype=torch.int32, device=x.device).index_add(
        0, b.to(torch.int64), torch.ones_like(b))


@op("weightedCrossEntropyWithLogits")
def _weighted_ce(targets, logits, posWeight):
    """TF nn.weighted_cross_entropy_with_logits: pos_weight scales the
    positive term; numerically stable log1p form."""
    log_w = 1.0 + (posWeight - 1.0) * targets
    return ((1.0 - targets) * logits + log_w *
            (torch.log1p(torch.exp(-_abs(logits))) + _max(-logits, 0.0)))


@op("meanPairwiseSquaredError")
def _mpse(labels, predictions, weights=1.0):
    """TF losses.mean_pairwise_squared_error per batch row."""
    d = (predictions - labels).reshape(labels.shape[0], -1)
    n = d.shape[1]
    sum_d = torch.sum(d, dim=1)
    sum_d2 = torch.sum(d * d, dim=1)
    per = 2.0 * (n * sum_d2 - sum_d * sum_d) / max(n * (n - 1), 1)
    return torch.mean(per * weights)


@op("clipByGlobalNorm")
def _clip_by_global_norm(*tensors, clipNorm=1.0):
    gn = torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))
    scale = _min(clipNorm / _max(gn, 1e-30), 1.0)
    out = tuple(t * scale for t in tensors)
    return out if len(out) > 1 else out[0]


@op("matrixSetDiag")
def _matrix_set_diag(x, diag):
    n = min(x.shape[-2], x.shape[-1])
    return torch.diagonal_scatter(x, diag[..., :n].to(x.dtype), 0, -2, -1)


def _scatter_variant(reduce):
    """ref.at[indices].max/min/multiply(updates) on axis 0: a negative id
    wraps once, ids still outside the range are dropped."""
    def f(ref, indices, updates):
        n = ref.shape[0]
        rest = tuple(ref.shape[1:])
        idx = _long(indices).reshape(-1)
        idx = torch.where(idx < 0, idx + n, idx)
        idx = torch.where((idx >= 0) & (idx < n), idx, n)
        src = torch.as_tensor(updates, dtype=ref.dtype, device=ref.device)
        src = src.expand(tuple(_long(indices).shape) + rest).reshape(
            (-1,) + rest)
        flat = torch.cat([ref, torch.zeros((1,) + rest, dtype=ref.dtype,
                                           device=ref.device)])
        index = idx.reshape((-1,) + (1,) * len(rest)).expand(src.shape)
        return flat.scatter_reduce(0, index, src, reduce,
                                   include_self=True)[:n]

    return f


OPS["scatterMax"] = _scatter_variant("amax")
OPS["scatterMin"] = _scatter_variant("amin")
OPS["scatterMul"] = _scatter_variant("prod")
OPS["scatterSub"] = lambda ref, idx, upd: _scatter(
    ref, idx, -torch.as_tensor(upd, dtype=ref.dtype, device=ref.device),
    True)


@op("scatterNd")
def _scatter_nd(indices, updates, shape):
    """TF scatter_nd: indices [N,K] into zeros(shape), duplicates summed."""
    updates = torch.as_tensor(updates)
    return _scatter_nd_into(
        torch.zeros(tuple(_ints(shape)), dtype=updates.dtype,
                    device=updates.device), indices, updates, True)


@op("dynamicStitch")
def _dynamic_stitch(indices_list, data_list):
    """TF dynamic_stitch with the index tensors and data given as tuples;
    later entries win on duplicates (TF contract)."""
    first = torch.as_tensor(data_list[0])
    dev = first.device
    total = sum(int(np.prod(_shape(i))) for i in indices_list)
    inner = tuple(first.shape[len(_shape(indices_list[0])):])
    out = torch.zeros((total,) + inner, dtype=first.dtype, device=dev)
    for ind, dat in zip(indices_list, data_list):
        ind = torch.as_tensor(ind, device=dev).reshape(-1)
        dat = torch.as_tensor(dat, device=dev).reshape((-1,) + inner)
        out = _scatter(out, ind, dat, False)
    return out


@op("mirrorPad")
def _mirror_pad(x, paddings, mode="REFLECT"):
    mode = {"REFLECT": "reflect", "SYMMETRIC": "symmetric"}[
        str(mode).upper()]
    pads = np.asarray(_ints(paddings)).reshape(-1, 2)
    for d, (lo, hi) in enumerate(pads):
        if lo or hi:
            x = x.index_select(d, _pad_index(x.shape[d], int(lo), int(hi),
                                             mode, x.device))
    return x


@op("rot90")
def _rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, int(k), tuple(_ints(axes)))


@op("sconv2d")
def _sconv2d(x, depthWeights, pointWeights, strides=(1, 1),
             sameMode=True):
    """Separable conv2d: depthwise [kH,kW,C,M] (TF HWIO-depthwise layout)
    then pointwise [1,1,C*M,F]; NCHW data like conv2d."""
    dw = _depthwise_conv2d(x, depthWeights.permute(3, 2, 0, 1),
                           strides=strides, sameMode=sameMode)
    pw = pointWeights
    f = pw.shape[-1]
    pw_oihw = pw.reshape(pw.shape[-2], f)[None, None].permute(3, 2, 0, 1)
    return _conv2d(dw, pw_oihw, sameMode=True)


@op("localResponseNormalization")
def _lrn(x, depth=5, bias=1.0, alpha=1.0, beta=0.5):
    """TF nn.local_response_normalization, NCHW input: x over (bias +
    alpha * the sum of squares of the channels within depth) ** beta."""
    c = x.shape[1]
    r = int(depth)
    sq = F.pad(torch.square(x), (0, 0, 0, 0, r, r))
    acc = sum(sq[:, j:j + c] for j in range(2 * r + 1))
    return x / torch.pow(bias + alpha * acc, beta)


@op("dilation2d")
def _dilation2d(x, w, sH=1, sW=1, sameMode=True):
    """Grayscale morphological dilation (TF nn.dilation2d), NCHW x
    [N,C,H,W], w [C,kH,kW]. SAME pads with a large negative value (TF
    pads with -inf: the padding never wins the max)."""
    c, kh, kw = w.shape
    sH, sW = int(sH), int(sW)
    if sameMode:
        x = _pad_spatial(x, _same_pads(x.shape[2:], (kh, kw), (sH, sW),
                                       (1, 1)), value=-1e30)
    n = x.shape[0]
    oh = (x.shape[2] - kh) // sH + 1
    ow = (x.shape[3] - kw) // sW + 1
    patches = F.unfold(x, (kh, kw), stride=(sH, sW)).reshape(
        n, c, kh * kw, oh, ow)
    return torch.amax(patches + w.reshape(1, c, kh * kw, 1, 1), dim=2)


@op("adjustContrast")
def _adjust_contrast(x, factor):
    """Per-channel contrast about the spatial mean, NCHW (the last two axes
    are H,W). NHWC images use adjustContrastV2."""
    mean = torch.mean(x, dim=(-2, -1), keepdim=True) if x.dim() == 4 \
        else torch.mean(x)
    return (x - mean) * factor + mean


def _rgb_to_hsv(x):
    """x [..., 3] in [0,1] -> HSV (TF image.rgb_to_hsv)."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = torch.amax(x, dim=-1)
    mn = torch.amin(x, dim=-1)
    d = mx - mn
    safe = torch.where(d > 0, d, torch.ones_like(d))
    h = torch.where(
        mx == r, torch.remainder((g - b) / safe, 6.0),
        torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    h = torch.where(d > 0, h / 6.0, torch.zeros_like(h))
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, torch.ones_like(mx)),
                    torch.zeros_like(mx))
    return torch.stack([h, s, mx], dim=-1)


def _hsv_to_rgb(x):
    h, s, v = x[..., 0] * 6.0, x[..., 1], x[..., 2]
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int64), 6).unsqueeze(-1)

    def choose(*opts):
        return torch.gather(torch.stack(opts, dim=-1), -1, i).squeeze(-1)

    return torch.stack([choose(v, q, p, p, t, v), choose(t, v, v, q, p, p),
                        choose(p, p, t, v, v, q)], dim=-1)


OPS["rgbToHsv"] = _rgb_to_hsv
OPS["hsvToRgb"] = _hsv_to_rgb


@op("adjustHue")
def _adjust_hue(x, delta):
    hsv = _rgb_to_hsv(x)
    h = torch.remainder(hsv[..., 0] + delta, 1.0)
    return _hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


@op("adjustSaturation")
def _adjust_saturation(x, factor):
    hsv = _rgb_to_hsv(x)
    s = _clip(hsv[..., 1] * factor, 0.0, 1.0)
    return _hsv_to_rgb(torch.stack([hsv[..., 0], s, hsv[..., 2]], dim=-1))


@op("randomShuffle", random=True)
def _random_shuffle(x, generator=None):
    return x[torch.randperm(x.shape[0], generator=generator,
                            device=x.device)]


@op("alphaDropout", random=True, training_aware=True)
def _alpha_dropout(x, p=0.05, generator=None, training=False):
    """SELU-preserving dropout (Klambauer et al.); identity at
    inference."""
    if not training or generator is None or p <= 0:
        return x
    alpha_p = -1.7580993408473766
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    # the affine correction a = ((1-p)(1 + p*a'^2))^-1/2 restores unit
    # variance
    a = ((1.0 - p) * (1.0 + p * alpha_p ** 2)) ** -0.5
    b = -a * p * alpha_p
    return a * torch.where(keep, x, torch.full((), alpha_p, dtype=x.dtype,
                                               device=x.device)) + b


@op("gaussianDropout", random=True, training_aware=True)
def _gaussian_dropout(x, p=0.1, generator=None, training=False):
    if not training or generator is None or p <= 0:
        return x
    std = (p / (1.0 - p)) ** 0.5
    return x * (1.0 + std * torch.randn(x.shape, generator=generator,
                                        dtype=x.dtype, device=x.device))


@op("gaussianNoise", random=True, training_aware=True)
def _gaussian_noise(x, stddev=0.1, generator=None, training=False):
    if not training or generator is None:
        return x
    return x + stddev * torch.randn(x.shape, generator=generator,
                                    dtype=x.dtype, device=x.device)


@op("sparseSoftmaxCrossEntropyGrad")
def _sparse_softmax_ce_grad(z, y):
    """TF SparseSoftmaxCrossEntropyWithLogits: (loss [B], backprop
    [B, C]); a label outside the classes gives a NaN loss and a zero
    one-hot row, as the reference's take_along_axis and one_hot."""
    c = z.shape[-1]
    lp = torch.log_softmax(z, dim=-1)
    idx = _long(y)
    idx = torch.where(idx < 0, idx + c, idx)
    valid = (idx >= 0) & (idx < c)
    picked = torch.gather(lp, -1, torch.where(valid, idx, 0)[..., None])[
        ..., 0]
    loss = -torch.where(valid, picked, torch.full((), float("nan"),
                                                  dtype=z.dtype,
                                                  device=z.device))
    bp = torch.softmax(z, dim=-1) - _one_hot(y, depth=c).to(z.dtype)
    return loss, bp


@op("adjustContrastV2")
def _adjust_contrast_nhwc(x, factor=1.0):
    """TF AdjustContrastv2: NHWC, per-channel spatial mean."""
    mean = torch.mean(x, dim=(-3, -2), keepdim=True)
    return (x - mean) * factor + mean
