"""INDArray: the ND4J tensor API over a ``torch.Tensor``.

Counterpart of ``deeplearning4j_tpu/ndarray/ndarray.py``, with its method
names and meanings: dtypes, views with write-back, broadcasting,
dup/assign, i-suffixed in-place ops, dimension reductions.

What the port does its own way, by design:

- **In-place ops update in place.** ``addi``, ``muli``, ``assign``,
  ``put``, ``putScalar``, ``putRow``, ``replaceWhere`` and the rest write
  into the handle's tensor (cast to its dtype, broadcast to its shape) and
  return the handle; the JAX package rebinds its handle to a new immutable
  array. A handle made from a tensor (``INDArray(t)``) therefore writes
  into ``t``; one made from numpy or a list holds a copy.
- **Handles do not share tensors**, except a view and its parent: every
  function that the JAX package documents as returning a new array
  (``dup``, ``reshape``, ``transpose``, ``permute``, ``ravel``,
  ``broadcast``, ``castTo``, ``getScalar``, ...) returns a handle over a
  tensor of its own, so an in-place op on it never reaches its source.
- **Views are real.** ``get``, ``[]``, ``getRow``, ``getColumn`` and
  ``slice_`` make a view that holds its parent and the index: it reads
  the parent's current values (with ints and slices the index is a torch
  view of the parent's tensor) and writes through it (``index_put`` into
  the parent, or, below an index of lists or arrays, which torch copies,
  into a copy that is written back up the chain).
- ``torch()`` is the JAX package's ``jax()``; ``dtype`` and
  ``dataType()`` are torch dtypes; ``toNumpy()`` of a bfloat16 array is
  float32 (numpy has no bfloat16).
- Arrays made from numpy or Python data take float32 for floating data,
  as the JAX package does with 64-bit types off, and go to the default
  device: "cuda" unless ``Nd4j.setDefaultDevice`` names another (the CPU
  tests name the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend import resolve_device

_default_device = [None]   # None: "cuda", resolved at first use


def default_device() -> torch.device:
    """The device that arrays made from host data go to."""
    return resolve_device(_default_device[0])


def set_default_device(device) -> None:
    _default_device[0] = None if device is None else torch.device(device)


def _host_tensor(data, device=None, dtype=None) -> torch.Tensor:
    """A tensor of its own from numpy or Python data; 64-bit floats become
    float32."""
    if isinstance(data, torch.Tensor):
        t = data.detach().clone()
    else:
        a = np.asarray(data)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        t = torch.tensor(a)
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    return t.to(default_device() if device is None else device)


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def _unwrap(x):
    if isinstance(x, INDArray):
        return x.torch()
    return x


def _operand(x, like: torch.Tensor):
    """``x`` as an operand of ``like``: a tensor, or a Python scalar."""
    x = _unwrap(x)
    if isinstance(x, torch.Tensor) or isinstance(x, (bool, int, float)):
        return x
    if isinstance(x, np.generic):
        return x.item()
    return _host_tensor(x, like.device)


def _coerce(x, like: torch.Tensor) -> torch.Tensor:
    """Like _operand but always a tensor (a row or column given as a list,
    say)."""
    x = _operand(x, like)
    return x if isinstance(x, torch.Tensor) else torch.tensor(
        x, device=like.device)


def _shares(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _basic(index) -> bool:
    """Whether indexing with ``index`` makes a torch view (ints, slices,
    None, Ellipsis)."""
    parts = index if isinstance(index, tuple) else (index,)
    return all(isinstance(i, (int, np.integer, slice, type(None),
                              type(Ellipsis))) for i in parts)


def _index(index):
    """An index torch takes (numpy arrays and lists as int64 tensors)."""
    if isinstance(index, tuple):
        return tuple(_index(i) for i in index)
    if isinstance(index, INDArray):
        index = index.torch()
    if isinstance(index, (list, np.ndarray)):
        return torch.as_tensor(np.asarray(index))
    if isinstance(index, np.integer):
        return int(index)
    return index


class _Writing:
    """The mode an in-place write into ``t`` needs: inference mode for an
    inference tensor (``output`` runs under it), else no_grad."""

    def __init__(self, t: torch.Tensor):
        self._ctx = (torch.inference_mode() if t.is_inference()
                     else torch.no_grad())

    def __enter__(self):
        return self._ctx.__enter__()

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)


class INDArray:
    """A handle over a torch.Tensor; a view holds its parent and the index
    (see the module's docstring for what is written in place)."""

    __slots__ = ("_data", "_parent", "_index")
    __array_priority__ = 100  # beat numpy operator dispatch

    def __init__(self, data, parent: "INDArray | None" = None, index=None,
                 device=None):
        self._parent = parent
        self._index = None if parent is None else _index(index)
        if parent is not None:
            self._data = None  # views read through the parent
            return
        if isinstance(data, INDArray):
            data = data.torch().clone()
        elif not isinstance(data, torch.Tensor):
            data = _host_tensor(data, device)
        self._data = data

    @property
    def _arr(self) -> torch.Tensor:
        if self._parent is not None:
            return self._parent._arr[self._index]
        return self._data

    def _new(self, t: torch.Tensor) -> "INDArray":
        """A handle over a result; a copy where torch returned a view of
        this array's tensor."""
        return INDArray(t.clone() if _shares(t, self._arr) else t)

    # -- raw access ---------------------------------------------------------
    def torch(self) -> torch.Tensor:
        return self._arr

    def toNumpy(self) -> np.ndarray:
        """A host copy (never a view of the tensor, which in-place ops
        change)."""
        t = self._arr.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy() if t.device.type == "cpu" else \
            t.cpu().numpy()

    numpy = toNumpy  # pythonic alias

    def __array__(self, dtype=None, copy=None):
        a = self.toNumpy()
        return a.astype(dtype) if dtype is not None else a

    def _real(self) -> bool:
        """Whether this array's tensor is the root's or a torch view of it
        (every index up the chain basic)."""
        return self._parent is None or (_basic(self._index) and
                                        self._parent._real())

    def _write(self, index, value) -> None:
        """this[index] = value, in place, through the parent chain."""
        if self._real():
            target = self._arr
            with _Writing(target):
                target[index] = value
            return
        full = self._arr.clone()
        full[index] = value
        self._parent._write(self._index, full)

    def _set(self, new) -> "INDArray":
        """Write ``new`` (cast to this dtype, broadcast to this shape) into
        this array in place; a view writes through its parent."""
        cur = self._arr
        new = _coerce(new, cur)
        if _shares(new, cur):
            new = new.clone()
        new = new.to(cur.dtype).broadcast_to(cur.shape)
        if self._parent is not None:
            self._parent._write(self._index, new)
        else:
            with _Writing(cur):
                cur.copy_(new)
        return self

    # -- shape / dtype ------------------------------------------------------
    def shape(self):
        return tuple(self._arr.shape)

    def rank(self) -> int:
        return self._arr.dim()

    def length(self) -> int:
        return int(self._arr.numel())

    def size(self, dim: int) -> int:
        return int(self._arr.shape[dim])

    def isVector(self) -> bool:
        a = self._arr
        return a.dim() == 1 or (a.dim() == 2 and 1 in a.shape)

    def isMatrix(self) -> bool:
        return self._arr.dim() == 2

    def isScalar(self) -> bool:
        return self._arr.dim() == 0 or self._arr.numel() == 1

    def rows(self) -> int:
        return int(self._arr.shape[0])

    def columns(self) -> int:
        return int(self._arr.shape[1])

    def dataType(self):
        return self._arr.dtype

    @property
    def dtype(self):
        return self._arr.dtype

    @property
    def device(self) -> torch.device:
        return self._arr.device

    def castTo(self, dtype) -> "INDArray":
        return self._new(self._arr.to(torch_dtype(dtype)))

    # -- copy / assign ------------------------------------------------------
    def dup(self) -> "INDArray":
        return INDArray(self._arr.clone())

    def assign(self, other) -> "INDArray":
        return self._set(other)

    def ravel(self) -> "INDArray":
        return self._new(self._arr.reshape(-1))

    def flatten(self) -> "INDArray":
        return self.ravel()

    def reshape(self, *shape) -> "INDArray":
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return self._new(self._arr.reshape(shape))

    def transpose(self) -> "INDArray":
        return self._new(self._arr.permute(
            *reversed(range(self._arr.dim()))))

    def permute(self, *axes) -> "INDArray":
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return self._new(self._arr.permute(*axes))

    def broadcast(self, *shape) -> "INDArray":
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return INDArray(self._arr.broadcast_to(shape).clone())

    def repeat(self, dim: int, times: int) -> "INDArray":
        return INDArray(torch.repeat_interleave(self._arr, times, dim=dim))

    def tile(self, *reps) -> "INDArray":
        return INDArray(torch.tile(self._arr, reps))

    # -- elementwise arithmetic (functional + i-suffixed in-place) ----------
    def _op(self, other):
        return _operand(other, self._arr)

    def add(self, other) -> "INDArray":
        return INDArray(self._arr + self._op(other))

    def addi(self, other) -> "INDArray":
        return self._set(self._arr + self._op(other))

    def sub(self, other) -> "INDArray":
        return INDArray(self._arr - self._op(other))

    def subi(self, other) -> "INDArray":
        return self._set(self._arr - self._op(other))

    def rsub(self, other) -> "INDArray":
        return INDArray(self._op(other) - self._arr)

    def rsubi(self, other) -> "INDArray":
        return self._set(self._op(other) - self._arr)

    def mul(self, other) -> "INDArray":
        return INDArray(self._arr * self._op(other))

    def muli(self, other) -> "INDArray":
        return self._set(self._arr * self._op(other))

    def div(self, other) -> "INDArray":
        return INDArray(self._arr / self._op(other))

    def divi(self, other) -> "INDArray":
        return self._set(self._arr / self._op(other))

    def rdiv(self, other) -> "INDArray":
        return INDArray(self._op(other) / self._arr)

    def rdivi(self, other) -> "INDArray":
        return self._set(self._op(other) / self._arr)

    def neg(self) -> "INDArray":
        return INDArray(-self._arr)

    def negi(self) -> "INDArray":
        return self._set(-self._arr)

    def fmod(self, other) -> "INDArray":
        return INDArray(torch.fmod(self._arr, self._op(other)))

    # python operators
    __add__ = add
    __radd__ = add
    __sub__ = sub
    __rsub__ = rsub
    __mul__ = mul
    __rmul__ = mul
    __truediv__ = div
    __rtruediv__ = rdiv
    __neg__ = neg

    def __pow__(self, p):
        return INDArray(self._arr ** self._op(p))

    def __matmul__(self, other):
        return self.mmul(other)

    def __eq__(self, other):  # elementwise, like ND4J eq()
        if isinstance(other, (INDArray, np.ndarray, torch.Tensor, int,
                              float, bool)):
            return self.eq(other)
        return NotImplemented

    def __ne__(self, other):
        if isinstance(other, (INDArray, np.ndarray, torch.Tensor, int,
                              float, bool)):
            return self.neq(other)
        return NotImplemented

    __hash__ = object.__hash__

    # -- broadcast-along-dimension ops (ND4J addRowVector etc.) -------------
    def _row(self, row):
        return _coerce(row, self._arr).reshape(1, -1)

    def _col(self, col):
        return _coerce(col, self._arr).reshape(-1, 1)

    def addRowVector(self, row) -> "INDArray":
        return INDArray(self._arr + self._row(row))

    def addiRowVector(self, row) -> "INDArray":
        return self._set(self._arr + self._row(row))

    def addColumnVector(self, col) -> "INDArray":
        return INDArray(self._arr + self._col(col))

    def addiColumnVector(self, col) -> "INDArray":
        return self._set(self._arr + self._col(col))

    def mulRowVector(self, row) -> "INDArray":
        return INDArray(self._arr * self._row(row))

    def mulColumnVector(self, col) -> "INDArray":
        return INDArray(self._arr * self._col(col))

    def subRowVector(self, row) -> "INDArray":
        return INDArray(self._arr - self._row(row))

    def divRowVector(self, row) -> "INDArray":
        return INDArray(self._arr / self._row(row))

    # -- linalg -------------------------------------------------------------
    def mmul(self, other) -> "INDArray":
        return INDArray(self._arr @ _coerce(other, self._arr))

    def mmuli(self, other) -> "INDArray":
        return self._set(self._arr @ _coerce(other, self._arr))

    def tensorMmul(self, other, axes) -> "INDArray":
        return INDArray(torch.tensordot(self._arr, _coerce(other, self._arr),
                                        dims=axes))

    # -- reductions ---------------------------------------------------------
    def _dims(self, dims):
        return tuple(d if d >= 0 else d + self._arr.dim() for d in dims)

    def sum(self, *dims, keepDims=False) -> "INDArray":
        if not dims:
            return INDArray(self._arr.sum())
        return INDArray(self._arr.sum(dim=self._dims(dims), keepdim=keepDims))

    def _float(self):
        a = self._arr
        return a if a.is_floating_point() else a.float()

    def mean(self, *dims, keepDims=False) -> "INDArray":
        if not dims:
            return INDArray(self._float().mean())
        return INDArray(self._float().mean(dim=self._dims(dims),
                                           keepdim=keepDims))

    def max(self, *dims, keepDims=False) -> "INDArray":
        if not dims:
            return INDArray(self._arr.max())
        return INDArray(torch.amax(self._arr, dim=self._dims(dims),
                                   keepdim=keepDims))

    def min(self, *dims, keepDims=False) -> "INDArray":
        if not dims:
            return INDArray(self._arr.min())
        return INDArray(torch.amin(self._arr, dim=self._dims(dims),
                                   keepdim=keepDims))

    def prod(self, *dims, keepDims=False) -> "INDArray":
        a = self._arr
        if not dims:
            return INDArray(a.prod())
        for d in sorted(self._dims(dims), reverse=True):
            a = a.prod(dim=d, keepdim=keepDims)
        return INDArray(a)

    def std(self, *dims, keepDims=False) -> "INDArray":
        # ND4J std is the sample (Bessel-corrected) std
        if not dims:
            return INDArray(self._float().std(correction=1))
        return INDArray(self._float().std(dim=self._dims(dims), correction=1,
                                          keepdim=keepDims))

    def var(self, *dims, keepDims=False) -> "INDArray":
        if not dims:
            return INDArray(self._float().var(correction=1))
        return INDArray(self._float().var(dim=self._dims(dims), correction=1,
                                          keepdim=keepDims))

    def norm1(self, *dims) -> "INDArray":
        return INDArray(self._arr.abs()).sum(*dims)

    def norm2(self, *dims) -> "INDArray":
        return INDArray(torch.sqrt((self._arr * self._arr).sum(
            dim=self._dims(dims)) if dims else (self._arr * self._arr).sum()))

    def normmax(self, *dims) -> "INDArray":
        return INDArray(self._arr.abs()).max(*dims)

    def _arg_reduce(self, fn, dims):
        a = self._arr
        if not dims:
            return INDArray(fn(a))
        if len(dims) == 1:
            return INDArray(fn(a, dim=dims[0]))
        # multi-dim: move reduced axes last, flatten them, index within them
        dims = tuple(d % a.dim() for d in dims)
        keep = tuple(i for i in range(a.dim()) if i not in dims)
        moved = a.permute(*(keep + dims))
        flat = moved.reshape(moved.shape[:len(keep)] + (-1,))
        return INDArray(fn(flat, dim=-1))

    def argMax(self, *dims) -> "INDArray":
        return self._arg_reduce(torch.argmax, dims)

    def argMin(self, *dims) -> "INDArray":
        return self._arg_reduce(torch.argmin, dims)

    def cumsum(self, dim: int = 0) -> "INDArray":
        return INDArray(torch.cumsum(self._arr, dim=dim))

    def entropy(self) -> "INDArray":
        a = self._arr
        return INDArray(-(a * torch.log(a)).sum())

    # -- comparisons --------------------------------------------------------
    def gt(self, other) -> "INDArray":
        return INDArray(self._arr > self._op(other))

    def gte(self, other) -> "INDArray":
        return INDArray(self._arr >= self._op(other))

    def lt(self, other) -> "INDArray":
        return INDArray(self._arr < self._op(other))

    def lte(self, other) -> "INDArray":
        return INDArray(self._arr <= self._op(other))

    def eq(self, other) -> "INDArray":
        return INDArray(self._arr == self._op(other))

    def neq(self, other) -> "INDArray":
        return INDArray(self._arr != self._op(other))

    def equalsWithEps(self, other, eps: float = 1e-5) -> bool:
        o = _coerce(other, self._arr)
        if tuple(o.shape) != self.shape():
            return False
        return bool(((self._arr - o).abs() < eps).all())

    def equals(self, other) -> bool:
        return self.equalsWithEps(other, 1e-5)

    # -- indexing -----------------------------------------------------------
    def get(self, *index) -> "INDArray":
        """A view with write-back (NDArrayIndex capability)."""
        idx = index[0] if len(index) == 1 else tuple(index)
        return INDArray(None, parent=self, index=idx)

    def __getitem__(self, idx):
        return INDArray(None, parent=self, index=idx)

    def __setitem__(self, idx, value):
        self._write(_index(idx), _operand(value, self._arr))

    def put(self, idx, value) -> "INDArray":
        self._write(_index(idx), _operand(value, self._arr))
        return self

    def putScalar(self, idx, value) -> "INDArray":
        # single int index is LINEAR (raveled) like ND4J putScalar(long, v),
        # matching getDouble's read side
        if isinstance(idx, (list, tuple)):
            idx = tuple(int(i) for i in idx)
        elif self._arr.dim() > 1:
            idx = tuple(int(i) for i in np.unravel_index(int(idx),
                                                         self.shape()))
        else:
            idx = int(idx)
        self._write(idx, value)
        return self

    def getRow(self, i: int) -> "INDArray":
        return INDArray(None, parent=self, index=i)

    def getColumn(self, i: int) -> "INDArray":
        return INDArray(None, parent=self, index=(slice(None), i))

    def getRows(self, *rows) -> "INDArray":
        return INDArray(self._arr[torch.as_tensor(rows)])

    def getColumns(self, *cols) -> "INDArray":
        return INDArray(self._arr[:, torch.as_tensor(cols)])

    def putRow(self, i: int, row) -> "INDArray":
        self._write(i, _coerce(row, self._arr))
        return self

    def putColumn(self, i: int, col) -> "INDArray":
        self._write((slice(None), i), _coerce(col, self._arr).reshape(-1))
        return self

    def slice_(self, i: int, dim: int = 0) -> "INDArray":
        idx = tuple([slice(None)] * dim + [i])
        return INDArray(None, parent=self, index=idx)

    def getScalar(self, *idx) -> "INDArray":
        return INDArray(self._arr[tuple(idx)].clone())

    def getDouble(self, *idx) -> float:
        a = self._arr
        if len(idx) == 1 and a.dim() > 1:
            return float(a.reshape(-1)[idx[0]])
        return float(a[tuple(idx)] if idx else a)

    def getFloat(self, *idx) -> float:
        return self.getDouble(*idx)

    def getInt(self, *idx) -> int:
        return int(self.getDouble(*idx))

    # -- misc ---------------------------------------------------------------
    def isNaN(self) -> "INDArray":
        return INDArray(torch.isnan(self._arr))

    def isInfinite(self) -> "INDArray":
        return INDArray(torch.isinf(self._arr))

    def replaceWhere(self, replacement, mask) -> "INDArray":
        a = self._arr
        return self._set(torch.where(_coerce(mask, a).bool(),
                                     _coerce(replacement, a).to(a.dtype), a))

    def __len__(self) -> int:
        return int(self._arr.shape[0])

    def __repr__(self) -> str:
        return f"INDArray{self.shape()}:{self._arr.dtype}\n{self.toNumpy()}"

    def __str__(self) -> str:
        return str(self.toNumpy())
