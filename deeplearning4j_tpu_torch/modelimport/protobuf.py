"""Minimal protobuf wire-format codec + the TensorFlow framework messages
needed to read/write a frozen GraphDef.

The port's own copy of ``deeplearning4j_tpu/modelimport/protobuf.py``
(numpy only, no TensorFlow and no generated bindings): the protobuf wire
format (varint / 64-bit / length-delimited / 32-bit) plus the messages
GraphDef, NodeDef, AttrValue, TensorProto, TensorShapeProto and the
FunctionDef library, both decode (import) and encode (building a GraphDef
in memory, as the tests and ``chip_smoke.py`` do). Both packages read and
write the same bytes.

The field numbers/types below are the public protobuf schema of
tensorflow/core/framework/{graph,node_def,attr_value,tensor,
tensor_shape,types,function,op_def}.proto.
"""

from __future__ import annotations

import struct

import numpy as np

# wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


# ---------------------------------------------------------------------------
# low-level wire format
# ---------------------------------------------------------------------------

def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _write_varint(out, value):
    if value < 0:
        value &= (1 << 64) - 1  # two's-complement int64
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _zigzag(v):
    return (v << 1) ^ (v >> 63)


def _unzigzag(v):
    return (v >> 1) ^ -(v & 1)


def _signed(v):
    """varint -> signed int64 (two's complement)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def iter_fields(buf):
    """Yield (field_number, wire_type, value) over one serialized message.
    LEN fields yield memoryview payloads; varints yield raw unsigned ints."""
    buf = memoryview(buf)
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == _VARINT:
            v, pos = _read_varint(buf, pos)
        elif wt == _I64:
            v = bytes(buf[pos:pos + 8])
            pos += 8
        elif wt == _LEN:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wt == _I32:
            v = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _emit_tag(out, field, wt):
    _write_varint(out, (field << 3) | wt)


def emit_varint(out, field, value):
    _emit_tag(out, field, _VARINT)
    _write_varint(out, int(value))


def emit_bytes(out, field, payload):
    _emit_tag(out, field, _LEN)
    _write_varint(out, len(payload))
    out.extend(payload)


def emit_float(out, field, value):
    _emit_tag(out, field, _I32)
    out.extend(struct.pack("<f", value))


def _unpack_packed(payload, fmt_char, itemsize):
    return list(np.frombuffer(bytes(payload), dtype=np.dtype(fmt_char)))


def _decode_packed_varints(payload):
    vals = []
    pos = 0
    buf = memoryview(payload)
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        vals.append(_signed(v))
    return vals


# ---------------------------------------------------------------------------
# tensorflow DataType enum (types.proto) <-> numpy
# ---------------------------------------------------------------------------

DT_FLOAT, DT_DOUBLE, DT_INT32, DT_UINT8 = 1, 2, 3, 4
DT_INT16, DT_INT8, DT_STRING = 5, 6, 7
DT_INT64, DT_BOOL = 9, 10
DT_BFLOAT16, DT_HALF = 14, 19

_DT_TO_NP = {
    DT_FLOAT: np.float32, DT_DOUBLE: np.float64, DT_INT32: np.int32,
    DT_UINT8: np.uint8, DT_INT16: np.int16, DT_INT8: np.int8,
    DT_INT64: np.int64, DT_BOOL: np.bool_, DT_HALF: np.float16,
}
_NP_TO_DT = {np.dtype(v): k for k, v in _DT_TO_NP.items()}


def dtype_to_numpy(dt):
    if dt == DT_BFLOAT16:
        # numpy has no bfloat16 of its own; ml_dtypes supplies one
        try:
            import ml_dtypes
        except ImportError as e:
            raise ValueError("a bfloat16 tensor needs the ml_dtypes "
                             "package to be read as numpy") from e
        return np.dtype(ml_dtypes.bfloat16)
    if dt not in _DT_TO_NP:
        raise ValueError(f"unsupported tf DataType enum {dt}")
    return np.dtype(_DT_TO_NP[dt])


def numpy_to_dtype(np_dtype):
    d = np.dtype(np_dtype)
    if d.name == "bfloat16":
        return DT_BFLOAT16
    if d not in _NP_TO_DT:
        raise ValueError(f"unsupported numpy dtype {d}")
    return _NP_TO_DT[d]


# ---------------------------------------------------------------------------
# message classes (decode + encode)
# ---------------------------------------------------------------------------

class TensorShapeProto:
    """tensor_shape.proto: dim=2 repeated {size=1}, unknown_rank=3."""

    def __init__(self, dims=None, unknown_rank=False):
        self.dims = list(dims) if dims is not None else []
        self.unknown_rank = unknown_rank

    @classmethod
    def decode(cls, buf):
        self = cls()
        for field, wt, v in iter_fields(buf):
            if field == 2 and wt == _LEN:
                size = None
                for f2, _w2, v2 in iter_fields(v):
                    if f2 == 1:
                        size = _signed(v2)
                self.dims.append(size if size is not None else -1)
            elif field == 3:
                self.unknown_rank = bool(v)
        return self

    def encode(self):
        out = bytearray()
        for d in self.dims:
            dim = bytearray()
            emit_varint(dim, 1, d)
            emit_bytes(out, 2, dim)
        if self.unknown_rank:
            emit_varint(out, 3, 1)
        return bytes(out)


class TensorProto:
    """tensor.proto: dtype=1, tensor_shape=2, tensor_content=4,
    float_val=5, double_val=6, int_val=7, string_val=8, int64_val=10,
    bool_val=11, half_val=13."""

    def __init__(self, dtype=DT_FLOAT, shape=None, array=None):
        self.dtype = dtype
        self.shape = shape or TensorShapeProto()
        self._array = array

    @classmethod
    def from_numpy(cls, arr):
        arr = np.asarray(arr)
        return cls(numpy_to_dtype(arr.dtype),
                   TensorShapeProto(list(arr.shape)), arr)

    def to_numpy(self):
        return self._array

    @classmethod
    def decode(cls, buf):
        dtype = DT_FLOAT
        shape = TensorShapeProto()
        content = None
        scalars = []
        strings = []
        for field, wt, v in iter_fields(buf):
            if field == 1:
                dtype = v
            elif field == 2:
                shape = TensorShapeProto.decode(v)
            elif field == 4:
                content = bytes(v)
            elif field == 5:  # float_val
                scalars += (_unpack_packed(v, "<f4", 4) if wt == _LEN
                            else [struct.unpack("<f", v)[0]])
            elif field == 6:  # double_val
                scalars += (_unpack_packed(v, "<f8", 8) if wt == _LEN
                            else [struct.unpack("<d", v)[0]])
            elif field in (7, 10, 11, 13):  # int/int64/bool/half vals
                scalars += (_decode_packed_varints(v) if wt == _LEN
                            else [_signed(v)])
            elif field == 8:  # string_val
                strings.append(bytes(v))
        np_dtype = dtype_to_numpy(dtype)
        dims = shape.dims
        n_elem = int(np.prod(dims)) if dims else 1
        if dtype == DT_STRING:
            arr = np.array(strings, dtype=object).reshape(dims)
        elif content is not None:
            arr = np.frombuffer(content, dtype=np_dtype).reshape(dims)
        elif scalars:
            if dtype in (DT_HALF, DT_BFLOAT16):
                # half_val holds raw uint16 bit patterns for both
                vals = np.array(scalars, np.uint16).view(np_dtype)
            else:
                vals = np.array(scalars, dtype=np_dtype)
            if len(vals) < n_elem:  # proto allows trailing-value elision
                vals = np.concatenate(
                    [vals, np.full(n_elem - len(vals), vals[-1], np_dtype)])
            arr = vals.reshape(dims)
        else:
            arr = np.zeros(dims, dtype=np_dtype)
        return cls(dtype, shape, arr)

    def encode(self):
        out = bytearray()
        emit_varint(out, 1, self.dtype)
        emit_bytes(out, 2, self.shape.encode())
        arr = np.ascontiguousarray(self._array)
        emit_bytes(out, 4, arr.tobytes())
        return bytes(out)


class AttrValue:
    """attr_value.proto: list=1, s=2, i=3, f=4, b=5, type=6, shape=7,
    tensor=8. The `list` payload reuses the same field numbers."""

    def __init__(self, **kw):
        self.s = kw.get("s")
        self.i = kw.get("i")
        self.f = kw.get("f")
        self.b = kw.get("b")
        self.type = kw.get("type")
        self.shape = kw.get("shape")
        self.tensor = kw.get("tensor")
        self.list = kw.get("list")  # dict of name -> list
        self.func = kw.get("func")  # function name (NameAttrList.name)

    @classmethod
    def decode(cls, buf):
        self = cls()
        for field, wt, v in iter_fields(buf):
            if field == 1:
                self.list = cls._decode_list(v)
            elif field == 2:
                self.s = bytes(v)
            elif field == 3:
                self.i = _signed(v)
            elif field == 4:
                self.f = struct.unpack("<f", v)[0]
            elif field == 5:
                self.b = bool(v)
            elif field == 6:
                self.type = v
            elif field == 7:
                self.shape = TensorShapeProto.decode(v)
            elif field == 8:
                self.tensor = TensorProto.decode(v)
            elif field == 10:
                # NameAttrList {name=1, attr=2}: functional control flow
                # (While/If) references its cond/body functions this way
                for f2, _w2, v2 in iter_fields(v):
                    if f2 == 1:
                        self.func = bytes(v2).decode("utf-8")
        return self

    @staticmethod
    def _decode_list(buf):
        out = {"s": [], "i": [], "f": [], "b": [], "type": [], "shape": []}
        for field, wt, v in iter_fields(buf):
            if field == 2:
                out["s"].append(bytes(v))
            elif field == 3:
                out["i"] += (_decode_packed_varints(v) if wt == _LEN
                             else [_signed(v)])
            elif field == 4:
                out["f"] += (_unpack_packed(v, "<f4", 4) if wt == _LEN
                             else [struct.unpack("<f", v)[0]])
            elif field == 5:
                out["b"] += ([bool(b) for b in
                              _decode_packed_varints(v)] if wt == _LEN
                             else [bool(v)])
            elif field == 6:
                out["type"] += (_decode_packed_varints(v) if wt == _LEN
                                else [v])
            elif field == 7:
                out["shape"].append(TensorShapeProto.decode(v))
        return out

    def encode(self):
        out = bytearray()
        if self.list is not None:
            lst = bytearray()
            for s in self.list.get("s", []):
                emit_bytes(lst, 2, s)
            for i in self.list.get("i", []):
                emit_varint(lst, 3, i)
            for f in self.list.get("f", []):
                emit_float(lst, 4, f)
            for b in self.list.get("b", []):
                emit_varint(lst, 5, int(b))
            for t in self.list.get("type", []):
                emit_varint(lst, 6, t)
            for sh in self.list.get("shape", []):
                emit_bytes(lst, 7, sh.encode())
            emit_bytes(out, 1, lst)
        if self.s is not None:
            emit_bytes(out, 2, self.s)
        if self.i is not None:
            emit_varint(out, 3, self.i)
        if self.f is not None:
            emit_float(out, 4, self.f)
        if self.b is not None:
            emit_varint(out, 5, int(self.b))
        if self.type is not None:
            emit_varint(out, 6, self.type)
        if self.shape is not None:
            emit_bytes(out, 7, self.shape.encode())
        if self.tensor is not None:
            emit_bytes(out, 8, self.tensor.encode())
        if self.func is not None:
            nal = bytearray()
            emit_bytes(nal, 1, self.func.encode("utf-8"))
            emit_bytes(out, 10, nal)
        return bytes(out)


class NodeDef:
    """node_def.proto: name=1, op=2, input=3 (repeated), device=4,
    attr=5 (map<string, AttrValue> — repeated entry{key=1, value=2})."""

    def __init__(self, name="", op="", inputs=None, attrs=None, device=""):
        self.name = name
        self.op = op
        self.inputs = list(inputs or [])
        self.attrs = dict(attrs or {})
        self.device = device

    @classmethod
    def decode(cls, buf):
        self = cls()
        for field, wt, v in iter_fields(buf):
            if field == 1:
                self.name = bytes(v).decode("utf-8")
            elif field == 2:
                self.op = bytes(v).decode("utf-8")
            elif field == 3:
                self.inputs.append(bytes(v).decode("utf-8"))
            elif field == 4:
                self.device = bytes(v).decode("utf-8")
            elif field == 5:
                key, val = None, None
                for f2, _w2, v2 in iter_fields(v):
                    if f2 == 1:
                        key = bytes(v2).decode("utf-8")
                    elif f2 == 2:
                        val = AttrValue.decode(v2)
                if key is not None:
                    self.attrs[key] = val
        return self

    def encode(self):
        out = bytearray()
        emit_bytes(out, 1, self.name.encode("utf-8"))
        emit_bytes(out, 2, self.op.encode("utf-8"))
        for inp in self.inputs:
            emit_bytes(out, 3, inp.encode("utf-8"))
        if self.device:
            emit_bytes(out, 4, self.device.encode("utf-8"))
        for key in self.attrs:
            entry = bytearray()
            emit_bytes(entry, 1, key.encode("utf-8"))
            emit_bytes(entry, 2, self.attrs[key].encode())
            emit_bytes(out, 5, entry)
        return bytes(out)


class ArgDef:
    """op_def.proto ArgDef: name=1, type=3 (DataType)."""

    def __init__(self, name="", type=DT_FLOAT):  # noqa: A002
        self.name = name
        self.type = type

    @classmethod
    def decode(cls, buf):
        self = cls()
        for field, _wt, v in iter_fields(buf):
            if field == 1:
                self.name = bytes(v).decode("utf-8")
            elif field == 3:
                self.type = v
        return self

    def encode(self):
        out = bytearray()
        emit_bytes(out, 1, self.name.encode("utf-8"))
        emit_varint(out, 3, self.type)
        return bytes(out)


class OpDefSignature:
    """op_def.proto OpDef (signature subset): name=1, input_arg=2,
    output_arg=3 (repeated ArgDef)."""

    def __init__(self, name="", input_args=None, output_args=None):
        self.name = name
        self.input_args = list(input_args or [])
        self.output_args = list(output_args or [])

    @classmethod
    def decode(cls, buf):
        self = cls()
        for field, _wt, v in iter_fields(buf):
            if field == 1:
                self.name = bytes(v).decode("utf-8")
            elif field == 2:
                self.input_args.append(ArgDef.decode(v))
            elif field == 3:
                self.output_args.append(ArgDef.decode(v))
        return self

    def encode(self):
        out = bytearray()
        emit_bytes(out, 1, self.name.encode("utf-8"))
        for a in self.input_args:
            emit_bytes(out, 2, a.encode())
        for a in self.output_args:
            emit_bytes(out, 3, a.encode())
        return bytes(out)


class FunctionDef:
    """function.proto FunctionDef: signature=1 (OpDef), node_def=3
    (repeated NodeDef), ret=4 (map<string,string>: output_arg name ->
    internal tensor ref)."""

    def __init__(self, signature=None, nodes=None, ret=None):
        self.signature = signature or OpDefSignature()
        self.nodes = list(nodes or [])
        self.ret = dict(ret or {})

    @classmethod
    def decode(cls, buf):
        self = cls()
        for field, _wt, v in iter_fields(buf):
            if field == 1:
                self.signature = OpDefSignature.decode(v)
            elif field == 3:
                self.nodes.append(NodeDef.decode(v))
            elif field == 4:
                key, val = None, None
                for f2, _w2, v2 in iter_fields(v):
                    if f2 == 1:
                        key = bytes(v2).decode("utf-8")
                    elif f2 == 2:
                        val = bytes(v2).decode("utf-8")
                if key is not None:
                    self.ret[key] = val
        return self

    def encode(self):
        out = bytearray()
        emit_bytes(out, 1, self.signature.encode())
        for n in self.nodes:
            emit_bytes(out, 3, n.encode())
        for k, v in self.ret.items():
            entry = bytearray()
            emit_bytes(entry, 1, k.encode("utf-8"))
            emit_bytes(entry, 2, v.encode("utf-8"))
            emit_bytes(out, 4, entry)
        return bytes(out)


class GraphDef:
    """graph.proto: node=1 (repeated NodeDef), library=2
    (FunctionDefLibrary{function=1}); versions ignored."""

    def __init__(self, nodes=None, functions=None):
        self.nodes = list(nodes or [])
        self.functions = list(functions or [])   # FunctionDef list

    @classmethod
    def decode(cls, buf):
        self = cls()
        for field, _wt, v in iter_fields(buf):
            if field == 1:
                self.nodes.append(NodeDef.decode(v))
            elif field == 2:
                for f2, _w2, v2 in iter_fields(v):
                    if f2 == 1:
                        self.functions.append(FunctionDef.decode(v2))
        return self

    @classmethod
    def parse(cls, path_or_bytes):
        if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
            return cls.decode(path_or_bytes)
        with open(path_or_bytes, "rb") as f:
            return cls.decode(f.read())

    def encode(self):
        out = bytearray()
        for node in self.nodes:
            emit_bytes(out, 1, node.encode())
        if self.functions:
            lib = bytearray()
            for fn in self.functions:
                emit_bytes(lib, 1, fn.encode())
            emit_bytes(out, 2, lib)
        return bytes(out)

    def save(self, path):
        with open(path, "wb") as f:
            f.write(self.encode())


# ---------------------------------------------------------------------------
# fixture-building helpers (encode side)
# ---------------------------------------------------------------------------

def attr_tensor(arr):
    return AttrValue(tensor=TensorProto.from_numpy(arr))


def attr_type(np_dtype):
    return AttrValue(type=numpy_to_dtype(np_dtype))


def attr_shape(dims):
    return AttrValue(shape=TensorShapeProto(list(dims)))


def attr_i(i):
    return AttrValue(i=int(i))


def attr_b(b):
    return AttrValue(b=bool(b))


def attr_f(f):
    return AttrValue(f=float(f))


def attr_s(s):
    return AttrValue(s=s if isinstance(s, bytes) else s.encode("utf-8"))


def attr_ilist(vals):
    return AttrValue(list={"i": [int(v) for v in vals]})


def attr_func(name):
    return AttrValue(func=str(name))
