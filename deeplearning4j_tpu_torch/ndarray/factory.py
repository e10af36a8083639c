"""Nd4j: the static factory (counterpart of
``deeplearning4j_tpu/ndarray/factory.py``).

Arrays go to the default device (``setDefaultDevice``; "cuda" unless
named) or to the ``device`` a call names. The random stream is a
``torch.Generator`` on the CPU (the JAX package's splits a threefry key
per draw): draws are reproducible under ``setSeed`` and made on the CPU,
then moved, so a seed gives the same numbers on every device. They are
not the JAX package's numbers: the two agree in shape, dtype and
distribution, never by seed.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.ndarray import ndarray as _nd
from deeplearning4j_tpu_torch.ndarray.ndarray import (
    INDArray, _host_tensor, _unwrap, torch_dtype)


class _RandomStream:
    """A stateful random stream over one ``torch.Generator``, seeded at
    first use (so importing the package draws nothing)."""

    def __init__(self, seed: int = 0):
        self._seed = seed
        self._gen = None

    def setSeed(self, seed: int):
        self._seed = seed
        self._gen = None

    def generator(self) -> torch.Generator:
        """The stream's generator (the JAX package's ``nextKey``)."""
        if self._gen is None:
            self._gen = torch.Generator().manual_seed(int(self._seed))
        return self._gen

    def nextDouble(self) -> float:
        return float(torch.rand((), generator=self.generator()))

    def nextGaussian(self) -> float:
        return float(torch.randn((), generator=self.generator()))

    def nextInt(self, bound: int) -> int:
        return int(torch.randint(0, bound, (), generator=self.generator()))


def _shape(shape):
    if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
        return tuple(shape[0])
    return tuple(shape)


def _tensors(arrs):
    return [a if isinstance(a, torch.Tensor) else _host_tensor(a)
            for a in (_unwrap(x) for x in arrs)]


class Nd4j:
    """Array factory; the capability analogue of
    org.nd4j.linalg.factory.Nd4j."""

    _rng = _RandomStream(123)
    default_dtype = torch.float32

    # -- device -------------------------------------------------------------
    @classmethod
    def setDefaultDevice(cls, device):
        """Where arrays made from host data go: "cuda" (None, the default)
        or a device the caller names."""
        _nd.set_default_device(device)

    @classmethod
    def getDefaultDevice(cls) -> torch.device:
        return _nd.default_device()

    @classmethod
    def _dev(cls, device):
        return _nd.default_device() if device is None else torch.device(
            device)

    @classmethod
    def _dtype(cls, dtype):
        return cls.default_dtype if dtype is None else torch_dtype(dtype)

    # -- rng ----------------------------------------------------------------
    @classmethod
    def getRandom(cls) -> _RandomStream:
        return cls._rng

    @classmethod
    def setSeed(cls, seed: int):
        cls._rng.setSeed(seed)

    # -- creation -----------------------------------------------------------
    @classmethod
    def create(cls, *args, dtype=None, device=None) -> INDArray:
        """create(data), create(data, shape), or create(*shape).

        A tuple of ints (or int args) is a shape -> zeros, like ND4J
        create(int[]); lists / ndarrays / tensors / INDArrays are data.
        """
        dtype = cls._dtype(dtype)
        first = args[0]
        is_shape_tuple = isinstance(first, tuple) and all(
            isinstance(x, (int, np.integer)) for x in first)
        if (isinstance(first, (list, tuple, np.ndarray, INDArray,
                               torch.Tensor)) and not is_shape_tuple):
            data = _unwrap(first)
            if isinstance(data, torch.Tensor):
                data = data.detach().clone().to(
                    dtype=dtype, device=cls._dev(device) if device else
                    data.device)
            else:
                data = _host_tensor(data, cls._dev(device), dtype)
            if len(args) == 2 and isinstance(args[1], (list, tuple)):
                return INDArray(data.reshape(tuple(args[1])))
            return INDArray(data)
        shape = tuple(first) if is_shape_tuple and len(args) == 1 else args
        return INDArray(torch.zeros(tuple(int(s) for s in shape),
                                    dtype=dtype, device=cls._dev(device)))

    @classmethod
    def zeros(cls, *shape, dtype=None, device=None) -> INDArray:
        return INDArray(torch.zeros(_shape(shape), dtype=cls._dtype(dtype),
                                    device=cls._dev(device)))

    @classmethod
    def ones(cls, *shape, dtype=None, device=None) -> INDArray:
        return INDArray(torch.ones(_shape(shape), dtype=cls._dtype(dtype),
                                   device=cls._dev(device)))

    @classmethod
    def zerosLike(cls, arr) -> INDArray:
        return INDArray(torch.zeros_like(_tensors([arr])[0]))

    @classmethod
    def onesLike(cls, arr) -> INDArray:
        return INDArray(torch.ones_like(_tensors([arr])[0]))

    @classmethod
    def valueArrayOf(cls, shape, value, dtype=None, device=None) -> INDArray:
        if isinstance(shape, int):
            shape = (shape,)
        return INDArray(torch.full(tuple(shape), value,
                                   dtype=cls._dtype(dtype),
                                   device=cls._dev(device)))

    @classmethod
    def scalar(cls, value, dtype=None, device=None) -> INDArray:
        return INDArray(torch.tensor(value, dtype=cls._dtype(dtype),
                                     device=cls._dev(device)))

    @classmethod
    def eye(cls, n: int, dtype=None, device=None) -> INDArray:
        return INDArray(torch.eye(n, dtype=cls._dtype(dtype),
                                  device=cls._dev(device)))

    @classmethod
    def arange(cls, *args, dtype=None, device=None) -> INDArray:
        return INDArray(torch.arange(*args, dtype=cls._dtype(dtype),
                                     device=cls._dev(device)))

    @classmethod
    def linspace(cls, start, stop, num, dtype=None, device=None) -> INDArray:
        return INDArray(torch.linspace(start, stop, int(num),
                                       dtype=cls._dtype(dtype),
                                       device=cls._dev(device)))

    @classmethod
    def _draw(cls, fn, shape, seed, device):
        gen = (torch.Generator().manual_seed(int(seed)) if seed is not None
               else cls._rng.generator())
        t = fn(_shape(shape), generator=gen, dtype=cls.default_dtype)
        return INDArray(t.to(cls._dev(device)))

    @classmethod
    def rand(cls, *shape, seed=None, device=None) -> INDArray:
        """Uniform on [0, 1)."""
        return cls._draw(torch.rand, shape, seed, device)

    @classmethod
    def randn(cls, *shape, seed=None, device=None) -> INDArray:
        """Standard normal."""
        return cls._draw(torch.randn, shape, seed, device)

    @classmethod
    def randomBernoulli(cls, p: float, *shape, device=None) -> INDArray:
        u = torch.rand(_shape(shape), generator=cls._rng.generator())
        return INDArray((u < p).to(cls.default_dtype).to(cls._dev(device)))

    # -- combination --------------------------------------------------------
    @classmethod
    def concat(cls, dim: int, *arrs) -> INDArray:
        return INDArray(torch.cat(_tensors(arrs), dim=dim))

    @classmethod
    def vstack(cls, *arrs) -> INDArray:
        return INDArray(torch.vstack(_tensors(arrs)))

    @classmethod
    def hstack(cls, *arrs) -> INDArray:
        return INDArray(torch.hstack(_tensors(arrs)))

    @classmethod
    def stack(cls, dim: int, *arrs) -> INDArray:
        return INDArray(torch.stack(_tensors(arrs), dim=dim))

    @classmethod
    def pile(cls, *arrs) -> INDArray:
        return cls.stack(0, *arrs)

    @classmethod
    def expandDims(cls, arr, dim: int) -> INDArray:
        return INDArray(_tensors([arr])[0].unsqueeze(dim).clone())

    @classmethod
    def squeeze(cls, arr, dim: int) -> INDArray:
        return INDArray(_tensors([arr])[0].squeeze(dim).clone())

    @classmethod
    def where(cls, cond, x, y) -> INDArray:
        c, a, b = _tensors([cond, x, y])
        return INDArray(torch.where(c.bool(), a, b))

    @classmethod
    def gemm(cls, a, b, transposeA=False, transposeB=False,
             alpha=1.0) -> INDArray:
        A, B = _tensors([a, b])
        if transposeA:
            A = A.T
        if transposeB:
            B = B.T
        return INDArray(alpha * (A @ B))

    @classmethod
    def matmul(cls, a, b) -> INDArray:
        A, B = _tensors([a, b])
        return INDArray(A @ B)

    @classmethod
    def diag(cls, arr) -> INDArray:
        return INDArray(torch.diag(_tensors([arr])[0]))

    @classmethod
    def sort(cls, arr, dim: int = -1, ascending: bool = True) -> INDArray:
        s = torch.sort(_tensors([arr])[0], dim=dim).values
        if not ascending:
            s = torch.flip(s, dims=(dim,))
        return INDArray(s)

    @classmethod
    def fromNumpy(cls, arr: np.ndarray, device=None) -> INDArray:
        return INDArray(_host_tensor(arr, cls._dev(device)))

    # -- npy files, readable by either package -------------------------------
    @classmethod
    def writeNpy(cls, arr, path: str):
        a = arr.toNumpy() if isinstance(arr, INDArray) else np.asarray(
            _unwrap(arr))
        np.save(path, a, allow_pickle=False)

    @classmethod
    def readNpy(cls, path: str, device=None) -> INDArray:
        return INDArray(_host_tensor(np.load(path, allow_pickle=False),
                                     cls._dev(device)))
