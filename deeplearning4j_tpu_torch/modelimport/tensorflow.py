"""TF GraphDef import into SameDiff.

Counterpart of ``deeplearning4j_tpu/modelimport/tensorflow.py``
(reference capability: ``nd4j-api`` ``org.nd4j.imports.graphmapper.tf.
TFGraphMapper#importGraph``). Import is a one-shot translation of a frozen
GraphDef into the port's define-then-run SameDiff graph, which runs its
ops eagerly on one device ("cuda" unless the caller names another), with
autograd for fine-tuning.

Scope, as the reference's: the frozen-inference op set of BERT-class
encoders and the baseline MLP/CNN/LSTM architectures — constants,
placeholders, linear algebra, elementwise math, reductions, shape
manipulation, gather/concat/split/strided-slice, softmax/layer-norm/gelu
decompositions, conv/pool/fused-batch-norm (NHWC handled via explicit
permutes), image and detection ops, host-side constant folding for
shape-carrying tensors (Shape/Pack/Range/... feeding Reshape etc.), TF2
functional control flow (While/If over the FunctionDef library), TF1
single-frame while loops (Enter/Merge/Switch/NextIteration/Exit) and their
TensorArrays, rewritten into loops.

Each emitted op's static output shape comes from running the port's op on
tensors of the "meta" device (shapes and dtypes, no data, no device work),
as the reference asks ``jax.eval_shape``; an op whose output shape
depends on its values runs once on zeros on the CPU instead.

Control deps (``^name``) are dropped: a frozen graph's control edges only
sequence stateful ops, and the imported graph is purely functional.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.ops import OPS
from deeplearning4j_tpu_torch.autodiff.samediff import (
    SameDiff, SubGraph, VariableType)
from deeplearning4j_tpu_torch.modelimport.protobuf import (
    DT_BFLOAT16, AttrValue, GraphDef, NodeDef, TensorShapeProto,
    attr_tensor, attr_type, dtype_to_numpy, numpy_to_dtype)
from deeplearning4j_tpu_torch.ndarray.ndarray import torch_dtype


class TFImportError(ValueError):
    pass


def _ref_parts(name):
    """'node:k' -> (node, None, k); 'node:out_arg:k' -> (node, out_arg, k);
    '^node' -> (None, None, 0)."""
    if name.startswith("^"):
        return None, None, 0
    if ":" in name:
        node, idx = name.rsplit(":", 1)
        arg = None
        if ":" in node:
            node, arg = node.split(":", 1)
        return node, arg, int(idx)
    return name, None, 0


def _ref(name):
    """'node:k' -> (node, k); '^node' -> control dep (None). FunctionDef
    bodies use the 3-part form 'node:out_arg:k'; this bare helper drops
    the arg name (flat index k is only correct for a sole-output-arg op)
    — the importer's _resolve() adds the layout-aware mapping plus the
    distinct-arg-name rejection for ops outside the layout table."""
    node, _, idx = _ref_parts(name)
    return node, idx


# TF ops with multiple NAMED output args, in OpDef order (matching the
# order our handlers bind outputs): lets _resolve() compute the true flat
# index for 3-part FunctionDef refs like 'u:idx:0'. Ops not listed here
# are assumed single-output-arg; a reference through a second distinct
# arg name is detected and rejected (see _resolve), but a LONE reference
# to a non-first arg of an unlisted op cannot be detected without the TF
# OpDef and would resolve to flat index k.
_OUT_ARG_LAYOUTS = {
    "Unique": ("y", "idx"),
    "UniqueV2": ("y", "idx"),
    "UniqueWithCounts": ("y", "idx", "count"),
    "TopKV2": ("values", "indices"),
    "NonMaxSuppressionV4": ("selected_indices", "valid_outputs"),
    "MaxPoolWithArgmax": ("output", "argmax"),
}


def _numpy_dtype(dtype):
    """numpy's dtype of a torch dtype (bfloat16 through ml_dtypes)."""
    name = str(dtype).replace("torch.", "")
    return dtype_to_numpy(DT_BFLOAT16) if name == "bfloat16" \
        else np.dtype(name)


class _Struct:
    """An output's static shape and numpy dtype."""

    def __init__(self, t):
        self.shape = tuple(t.shape)
        self.dtype = _numpy_dtype(t.dtype)


def _eval_shape(fn_name, structs, attrs):
    """The _Struct of each output of OPS[fn_name] on inputs of the given
    (shape, dtype)s, a tuple of them when the op gives several: the op
    runs on "meta" tensors, which carry shapes and dtypes but no data (the
    counterpart of the reference's jax.eval_shape). An op that needs its
    inputs' values (a shape that depends on them, or a kernel with no meta
    version) runs once on zeros on the CPU."""
    fn = OPS[fn_name]

    def run(device):
        ins = [torch.zeros(tuple(shape), dtype=torch_dtype(dt),
                           device=device) for shape, dt in structs]
        with torch.inference_mode():
            return fn(*ins, **attrs)

    try:
        out = run("meta")
    except (NotImplementedError, RuntimeError):
        out = run("cpu")
    if isinstance(out, (tuple, list)):
        return tuple(_Struct(o) for o in out)
    return _Struct(out)


class TFGraphMapper:
    """Entry points mirroring org.nd4j.imports.graphmapper.tf."""

    @staticmethod
    def importGraph(path_or_graphdef, placeholder_shapes=None,
                    trainable=False, strict=False, device=None) -> SameDiff:
        """placeholder_shapes: {placeholder_name: concrete shape} for
        graphs whose recorded input shapes have unknown (-1) dims; the
        import specializes to them (like feeding fixed shapes to the
        reference's TFGraphMapper).

        trainable=True converts the imported weight constants to
        VARIABLEs (see makeTrainable) so the graph can be fine-tuned —
        the reference's imported-BERT training flow.

        strict=True turns documented-deviation warnings (e.g. TF1-legacy
        resize sampling) into TFImportError.

        path_or_graphdef: a file path, the serialized bytes or a GraphDef.
        The graph, its constants and every value it computes live on
        ``device``, "cuda" unless named (``device="cpu"``); without a GPU
        an unnamed device raises."""
        if isinstance(path_or_graphdef, GraphDef):
            gd = path_or_graphdef
        else:
            gd = GraphDef.parse(path_or_graphdef)
        sd = _Importer(gd, placeholder_shapes, strict=strict,
                       device=device).run()
        if trainable:
            TFGraphMapper.makeTrainable(sd)
        return sd

    @staticmethod
    def makeTrainable(sd: SameDiff, names=None) -> list:
        """Convert imported weight constants to trainable VARIABLEs.

        A frozen GraphDef stores every weight as a Const; fine-tuning
        needs them as variables (reference: imported SameDiff graphs
        train after TFGraphMapper import). names=None converts every
        float constant with more than one element (weights/biases),
        leaving scalars and integer tables (shape consts, ids) frozen.
        Returns the converted names."""
        converted = []
        for name, v in sd._vars.items():
            if v.variableType != VariableType.CONSTANT:
                continue
            if names is not None:
                if name in names:
                    sd.convertToVariable(v)
                    converted.append(name)
                continue
            arr = sd._values.get(name)
            if arr is None:
                continue
            if arr.is_floating_point() and arr.numel() > 1:
                sd.convertToVariable(v)
                converted.append(name)
        return converted


class _Importer:
    def __init__(self, gd: GraphDef, placeholder_shapes=None,
                 strict=False, device=None):
        gd = _rewrite_v1_loops(gd)
        self.gd = gd
        self.strict = strict
        self.placeholder_shapes = dict(placeholder_shapes or {})
        self.nodes = {n.name: n for n in gd.nodes}
        self.functions = {f.signature.name: f
                          for f in getattr(gd, "functions", [])}
        self.sd = SameDiff(device=device)
        self.device = self.sd.device
        self.vars = {}        # tf tensor name "node:k" -> SDVariable
        self.shapes = {}      # tf tensor name -> tuple (static)
        self.dtypes = {}      # tf tensor name -> np.dtype
        self.consts = {}      # node name -> np.ndarray (host-foldable)
        self._out_args = {}   # node name -> out_arg name seen in 3-part refs
        self.tensor_arrays = {}  # TensorArrayV3 node -> {size,dtype,elem}

    # -- public ------------------------------------------------------------

    def run(self) -> SameDiff:
        for node in self._topo_order():
            handler = _HANDLERS.get(node.op)
            if handler is None:
                raise TFImportError(
                    f"unsupported TF op {node.op!r} (node {node.name!r})")
            handler(self, node)
        return self.sd

    # -- graph walking -----------------------------------------------------

    def _topo_order(self):
        """Iterative DFS post-order (BERT-class graphs have serial chains
        far deeper than Python's recursion limit)."""
        order, seen, visiting = [], set(), set()
        for root in self.gd.nodes:
            stack = [(root.name, False)]
            while stack:
                name, expanded = stack.pop()
                if expanded:
                    visiting.discard(name)
                    seen.add(name)
                    order.append(self.nodes[name])
                    continue
                if name in seen:
                    continue
                if name in visiting:
                    raise TFImportError(
                        f"cycle at node {name!r} (control flow loops are "
                        "not supported)")
                node = self.nodes.get(name)
                if node is None:
                    raise TFImportError(f"missing node {name!r}")
                visiting.add(name)
                stack.append((name, True))
                for inp in node.inputs:
                    src, _ = _ref(inp)
                    if src is not None and src not in seen:
                        stack.append((src, False))
        return order

    # -- tensor accessors ----------------------------------------------------

    def data_inputs(self, node):
        return [i for i in node.inputs if not i.startswith("^")]

    def _resolve(self, ref):
        """(node, flat_output_index) for a tensor ref, honouring the
        FunctionDef 3-part form 'node:out_arg:k'. Ops in _OUT_ARG_LAYOUTS
        get the exact layout-based index; for unlisted ops flat=k is only
        correct when out_arg is the node's sole output arg, so two
        DISTINCT arg names on one node (which would alias to the same
        index and silently wire the wrong tensor) are rejected."""
        node, arg, k = _ref_parts(ref)
        if node is None or arg is None:
            return node, k
        nd = self.nodes.get(node)
        layout = _OUT_ARG_LAYOUTS.get(nd.op) if nd is not None else None
        if layout is not None:
            if arg not in layout:
                raise TFImportError(
                    f"ref {ref!r}: op {nd.op} has output args {layout}, "
                    f"not {arg!r}")
            return node, layout.index(arg) + k
        seen = self._out_args.setdefault(node, arg)
        if seen != arg:
            raise TFImportError(
                f"node {node!r} is referenced through two distinct output "
                f"args ({seen!r} and {arg!r}); ops with multiple named "
                "output args inside While/If function bodies cannot be "
                "flat-indexed without the TF OpDef layout — re-export the "
                "graph with such multi-output ops outside the function "
                "body, or split the op")
        return node, k

    def var(self, ref):
        """SDVariable for a tf tensor ref, materializing host constants."""
        node, idx = self._resolve(ref)
        key = f"{node}:{idx}"
        if key in self.vars:
            return self.vars[key]
        if node in self.consts and idx == 0:
            v = self.sd.constant(node, np.asarray(self.consts[node]))
            self.vars[key] = v
            return v
        raise TFImportError(f"no tensor produced for {ref!r}")

    def const(self, ref):
        """numpy value of a host-foldable tensor ref, or None."""
        node, idx = self._resolve(ref)
        if idx != 0:
            return None
        return self._fold(node)

    def need_const(self, ref, what):
        v = self.const(ref)
        if v is None:
            raise TFImportError(
                f"{what} must be statically resolvable, but {ref!r} is not "
                "constant-foldable")
        return v

    def shape(self, ref):
        node, idx = self._resolve(ref)
        key = f"{node}:{idx}"
        if key not in self.shapes:
            raise TFImportError(f"no static shape for {ref!r}")
        return self.shapes[key]

    def dtype(self, ref):
        node, idx = self._resolve(ref)
        return self.dtypes.get(f"{node}:{idx}", np.dtype(np.float32))

    # -- emission ------------------------------------------------------------

    def bind(self, node_name, var, shape, dtype, out_idx=0):
        key = f"{node_name}:{out_idx}"
        self.vars[key] = var
        self.shapes[key] = tuple(int(s) for s in shape)
        self.dtypes[key] = np.dtype(dtype)
        return var

    def emit(self, node, fn_name, in_refs, attrs=None, out_dtype=None,
             out_idx_base=0, out_name=None):
        """Emit one SameDiff op; its static shape from ``_eval_shape``.
        out_name overrides the bound tensor name (for handlers that emit
        helper ops around the TF node, e.g. NHWC permutes)."""
        name = out_name or node.name
        in_vars = [self.var(r) for r in in_refs]
        structs = [(self.shape(r), self.dtype(r)) for r in in_refs]
        attrs = {k: v for k, v in (attrs or {}).items() if v is not None}
        try:
            out_struct = _eval_shape(fn_name, structs, attrs)
        except TFImportError:
            raise
        except Exception as e:
            # surface op-level shape/config errors with graph context
            raise TFImportError(
                f"node {node.name!r} ({node.op}): {fn_name} rejected "
                f"the configuration: {e}") from e
        multi = isinstance(out_struct, (tuple, list))
        n_out = len(out_struct) if multi else 1
        res = self.sd._op(fn_name, in_vars, attrs, name, n_out=n_out)
        outs = res if multi else (res,)
        structs_out = out_struct if multi else (out_struct,)
        for i, (v, st) in enumerate(zip(outs, structs_out)):
            self.bind(name, v, st.shape, out_dtype or st.dtype, out_idx=i)
        return res

    # -- host constant folding ----------------------------------------------

    def _fold(self, node_name, _depth=0):
        """numpy value of node_name if computable on the host (memoized)."""
        if node_name in self.consts:
            return self.consts[node_name]
        if _depth > 64:
            return None
        node = self.nodes.get(node_name)
        if node is None:
            return None
        ins = self.data_inputs(node)

        def rec(ref):
            src, idx = _ref(ref)
            if idx != 0:
                return None
            return self._fold(src, _depth + 1)

        val = None
        op = node.op
        if op in ("Identity", "StopGradient", "PreventGradient"):
            val = rec(ins[0])
        elif op in ("Shape", "Size", "Rank"):
            key = f"{_ref(ins[0])[0]}:{_ref(ins[0])[1]}"
            if key in self.shapes:
                sh = self.shapes[key]
                val = {"Shape": np.asarray(sh, np.int32),
                       "Size": np.asarray(int(np.prod(sh)), np.int32),
                       "Rank": np.asarray(len(sh), np.int32)}[op]
        elif op in ("Pack", "ConcatV2", "Add", "AddV2", "Sub", "Mul",
                    "Cast", "Range", "StridedSlice", "Reshape", "Squeeze",
                    "ExpandDims", "Prod", "Maximum", "Minimum", "Floor",
                    "GatherV2", "Neg", "RealDiv", "FloorDiv"):
            vals = [rec(r) for r in ins]
            if all(v is not None for v in vals):
                val = self._fold_compute(node, vals)
        if val is not None:
            self.consts[node_name] = val
        return val

    @staticmethod
    def _fold_compute(node, vals):
        op = node.op
        if op == "Pack":
            return np.stack(vals, axis=node.attrs.get("axis").i
                            if "axis" in node.attrs else 0)
        if op == "ConcatV2":
            axis = int(vals[-1])
            return np.concatenate(vals[:-1], axis=axis)
        if op in ("Add", "AddV2"):
            return vals[0] + vals[1]
        if op == "Sub":
            return vals[0] - vals[1]
        if op == "Mul":
            return vals[0] * vals[1]
        if op == "RealDiv":
            return vals[0] / vals[1]
        if op == "FloorDiv":
            return vals[0] // vals[1]
        if op == "Maximum":
            return np.maximum(vals[0], vals[1])
        if op == "Minimum":
            return np.minimum(vals[0], vals[1])
        if op == "Floor":
            return np.floor(vals[0])
        if op == "Neg":
            return -vals[0]
        if op == "Cast":
            return np.asarray(
                vals[0], dtype_to_numpy(node.attrs["DstT"].type))
        if op == "Range":
            start, limit, delta = (np.asarray(v) for v in vals)
            try:
                out = np.arange(start[()], limit[()], delta[()])
            except ValueError as e:
                raise TFImportError(f"Range node {node.name!r}: {e}")
            all_int = all(np.issubdtype(v.dtype, np.integer)
                          for v in (start, limit, delta))
            return out.astype(np.int32 if all_int else np.float32)
        if op == "StridedSlice":
            return _apply_strided_slice(node, vals[0], vals[1], vals[2],
                                        vals[3])[0]
        if op == "Reshape":
            return np.reshape(vals[0], [int(s) for s in vals[1]])
        if op == "Squeeze":
            dims = [d.i if hasattr(d, "i") else int(d) for d in
                    (node.attrs.get("squeeze_dims").list["i"]
                     if "squeeze_dims" in node.attrs else [])]
            return np.squeeze(vals[0], axis=tuple(dims) if dims else None)
        if op == "ExpandDims":
            return np.expand_dims(vals[0], int(vals[1]))
        if op == "Prod":
            return np.prod(vals[0], axis=tuple(np.atleast_1d(vals[1])))
        if op == "GatherV2":
            axis = int(vals[2]) if len(vals) > 2 else 0
            return np.take(vals[0], np.asarray(vals[1], np.int64), axis=axis)
        return None


def _apply_strided_slice(node, x, begin, end, strides):
    """numpy semantics of TF StridedSlice incl. masks. Returns (result,
    py_slices) — py_slices reusable for the symbolic path."""
    begin = np.atleast_1d(begin).astype(np.int64)
    end = np.atleast_1d(end).astype(np.int64)
    strides = (np.atleast_1d(strides).astype(np.int64) if strides is not None
               else np.ones_like(begin))
    get = lambda a: node.attrs[a].i if a in node.attrs else 0  # noqa: E731
    bm, em = get("begin_mask"), get("end_mask")
    sm, nm = get("shrink_axis_mask"), get("new_axis_mask")
    elm = get("ellipsis_mask")
    if elm:
        # expand the (single) ellipsis into full slices over the dims
        # not covered by the other spec entries (TF allows exactly one)
        if bin(elm).count("1") > 1:
            raise TFImportError(
                "StridedSlice with multiple ellipses is invalid")
        pos = elm.bit_length() - 1
        n_spec = len(begin) - 1  # entries besides the ellipsis
        n_new = bin(nm).count("1")
        rank = np.asarray(x).ndim
        fill = rank - (n_spec - n_new)

        def expand(arr, fill_val):
            return np.concatenate([
                arr[:pos], np.full(fill, fill_val, np.int64),
                arr[pos + 1:]])

        begin = expand(begin, 0)
        end = expand(end, 0)
        strides = expand(strides, 1)

        def expand_mask(mask, set_fill):
            lo = mask & ((1 << pos) - 1)
            hi = (mask >> (pos + 1)) << (pos + fill)
            mid = (((1 << fill) - 1) << pos) if set_fill else 0
            return lo | hi | mid

        bm = expand_mask(bm, True)
        em = expand_mask(em, True)
        sm = expand_mask(sm, False)
        nm = expand_mask(nm, False)
    idx = []
    for i in range(len(begin)):
        if nm & (1 << i):
            idx.append(None)  # np.newaxis
            continue
        if sm & (1 << i):
            idx.append(int(begin[i]))
            continue
        b = None if bm & (1 << i) else int(begin[i])
        e = None if em & (1 << i) else int(end[i])
        idx.append(slice(b, e, int(strides[i])))
    return np.asarray(x)[tuple(idx)], idx


# ---------------------------------------------------------------------------
# per-op handlers
# ---------------------------------------------------------------------------

_HANDLERS = {}


def handler(*names):
    def deco(fn):
        for n in names:
            _HANDLERS[n] = fn
        return fn

    return deco


@handler("Const")
def _h_const(im, node):
    arr = node.attrs["value"].tensor.to_numpy()
    im.consts[node.name] = np.asarray(arr)
    v = im.sd.constant(node.name, np.asarray(arr))
    im.bind(node.name, v, arr.shape, arr.dtype)


@handler("Placeholder", "PlaceholderWithDefault")
def _h_placeholder(im, node):
    dt = dtype_to_numpy(node.attrs["dtype"].type)
    shape = None
    if "shape" in node.attrs and node.attrs["shape"].shape is not None \
            and not node.attrs["shape"].shape.unknown_rank:
        shape = [int(d) if d is not None else -1
                 for d in node.attrs["shape"].shape.dims]
    if node.name in im.placeholder_shapes:
        given = [int(d) for d in im.placeholder_shapes[node.name]]
        if shape is not None and len(given) != len(shape):
            raise TFImportError(
                f"placeholder_shapes[{node.name!r}] rank {len(given)} != "
                f"recorded rank {len(shape)}")
        shape = given
    if shape is None or any(d is None or d < 0 for d in shape):
        # Do NOT fabricate unknown dims: Shape const-folding would bake
        # them into every downstream Reshape (silently wrong at runtime).
        raise TFImportError(
            f"placeholder {node.name!r} has unknown dims {shape}; pass "
            "concrete shapes via importGraph(..., placeholder_shapes="
            "{name: shape}) — the import specializes the graph to them "
            "(re-import to run a different batch size)")
    v = im.sd.placeHolder(node.name, torch_dtype(dt), *shape)
    im.bind(node.name, v, shape, dt)


@handler("Identity", "StopGradient", "PreventGradient", "Snapshot")
def _h_identity(im, node):
    # Emit a real identity op so the node's name is fetchable from the
    # SameDiff graph — freeze_graph conventionally names the OUTPUT with
    # tf.identity(logits, name='output'), and sd.output(..., 'output')
    # must resolve it.
    im.emit(node, "identity", [im.data_inputs(node)[0]])


@handler("NoOp", "Assert")
def _h_noop(im, node):
    pass


_UNARY = {
    "Relu": "relu", "Relu6": "relu6", "Elu": "elu", "Selu": "selu",
    "Softplus": "softplus", "Softsign": "softsign", "Tanh": "tanh",
    "Sigmoid": "sigmoid", "Erf": "erf", "Exp": "exp", "Log": "log",
    "Log1p": "log1p", "Neg": "neg", "Sqrt": "sqrt", "Rsqrt": "rsqrt",
    "Square": "square", "Abs": "abs", "Sign": "sign", "Floor": "floor",
    "Ceil": "ceil", "Round": "round", "Sin": "sin", "Cos": "cos",
    "Tan": "tan", "Asin": "asin", "Acos": "acos", "Atan": "atan",
    "Sinh": "sinh", "Cosh": "cosh", "Reciprocal": "reciprocal",
    "IsNan": "isnan", "IsInf": "isinf", "LogicalNot": "not_op",
    "Erfc": "erfc", "Lgamma": "lgamma", "Digamma": "digamma",
    "Expm1": "expm1", "Asinh": "asinh", "Acosh": "acosh",
    "Atanh": "atanh", "Cholesky": "cholesky",
    "MatrixInverse": "matrixInverse",
    "MatrixDeterminant": "matrixDeterminant",
}


@handler(*_UNARY)
def _h_unary(im, node):
    im.emit(node, _UNARY[node.op], im.data_inputs(node))


_BINARY = {
    "Add": "add", "AddV2": "add", "Sub": "sub", "Mul": "mul",
    "RealDiv": "div", "Div": "div", "FloorDiv": "floordiv",
    "Pow": "pow", "Maximum": "maximum", "Minimum": "minimum",
    "SquaredDifference": "squaredDifference", "FloorMod": "mod",
    "Equal": "eq", "NotEqual": "neq", "Greater": "gt",
    "GreaterEqual": "gte", "Less": "lt", "LessEqual": "lte",
    "LogicalAnd": "and_op", "LogicalOr": "or_op", "Atan2": "atan2",
    "Igamma": "igamma", "Igammac": "igammac",
}


@handler(*_BINARY)
def _h_binary(im, node):
    im.emit(node, _BINARY[node.op], im.data_inputs(node))


@handler("AddN")
def _h_addn(im, node):
    ins = im.data_inputs(node)
    ref = ins[0]
    acc = im.var(ref)
    if len(ins) == 1:
        im.bind(node.name, acc, im.shape(ref), im.dtype(ref))
        return
    for i, nxt in enumerate(ins[1:]):
        last = i == len(ins) - 2
        nm = node.name if last else f"{node.name}__addn{i}"
        acc = im.sd._op("add", [acc, im.var(nxt)], {}, nm)
    im.bind(node.name, acc, im.shape(ref), im.dtype(ref))


@handler("MatMul")
def _h_matmul(im, node):
    a = node.attrs.get("transpose_a")
    b = node.attrs.get("transpose_b")
    im.emit(node, "matmul", im.data_inputs(node),
            {"transposeA": bool(a.b) if a else False,
             "transposeB": bool(b.b) if b else False})


@handler("BatchMatMul", "BatchMatMulV2")
def _h_batch_matmul(im, node):
    adj_x = node.attrs.get("adj_x")
    adj_y = node.attrs.get("adj_y")
    im.emit(node, "matmul", im.data_inputs(node),
            {"transposeA": bool(adj_x.b) if adj_x else False,
             "transposeB": bool(adj_y.b) if adj_y else False})


@handler("BiasAdd")
def _h_bias_add(im, node):
    fmt = node.attrs.get("data_format")
    ins = im.data_inputs(node)
    if fmt is not None and fmt.s == b"NCHW":
        x_shape = im.shape(ins[0])
        bshape = [1] * len(x_shape)
        bshape[1] = x_shape[1]
        b = im.sd._op("reshape", [im.var(ins[1])],
                      {"shape": bshape}, f"{node.name}__b")
        im.bind(f"{node.name}__b", b, bshape, im.dtype(ins[1]))
        im.emit(node, "add", [ins[0], f"{node.name}__b:0"])
        return
    im.emit(node, "add", ins)


@handler("Softmax")
def _h_softmax(im, node):
    im.emit(node, "softmax", im.data_inputs(node), {"dimension": -1})


@handler("LogSoftmax")
def _h_log_softmax(im, node):
    im.emit(node, "logSoftmax", im.data_inputs(node), {"dimension": -1})


_REDUCTIONS = {"Mean": "mean", "Sum": "sum", "Max": "max", "Min": "min",
               "Prod": "prod", "All": "all", "Any": "any"}


@handler(*_REDUCTIONS)
def _h_reduce(im, node):
    ins = im.data_inputs(node)
    axes = im.need_const(ins[1], f"{node.op} reduction indices")
    keep = node.attrs.get("keep_dims")
    rank = len(im.shape(ins[0]))
    dims = [int(a) % rank for a in np.atleast_1d(axes)]
    im.emit(node, _REDUCTIONS[node.op], [ins[0]],
            {"dimensions": dims, "keepDims": bool(keep.b) if keep else False})


@handler("ArgMax", "ArgMin")
def _h_argmax(im, node):
    ins = im.data_inputs(node)
    axis = int(im.need_const(ins[1], "ArgMax axis")) if len(ins) > 1 else 0
    im.emit(node, "_argmax" if node.op == "ArgMax" else "_argmin", [ins[0]],
            {"dim": axis}, out_dtype=np.int64)


@handler("Reshape")
def _h_reshape(im, node):
    ins = im.data_inputs(node)
    target = [int(s) for s in
              im.need_const(ins[1], "Reshape shape")]
    in_shape = im.shape(ins[0])
    if -1 in target:
        known = int(np.prod([s for s in target if s != -1]))
        total = int(np.prod(in_shape))
        target[target.index(-1)] = total // max(known, 1)
    im.emit(node, "reshape", [ins[0]], {"shape": target})


@handler("Transpose")
def _h_transpose(im, node):
    ins = im.data_inputs(node)
    perm = [int(p) for p in im.need_const(ins[1], "Transpose perm")]
    im.emit(node, "permute", [ins[0]], {"dimensions": perm})


@handler("ExpandDims")
def _h_expand_dims(im, node):
    ins = im.data_inputs(node)
    axis = int(im.need_const(ins[1], "ExpandDims axis"))
    im.emit(node, "expandDims", [ins[0]], {"axis": axis})


@handler("Squeeze")
def _h_squeeze(im, node):
    ins = im.data_inputs(node)
    dims = None
    if "squeeze_dims" in node.attrs:
        lst = node.attrs["squeeze_dims"].list
        if lst and lst["i"]:
            dims = tuple(int(i) for i in lst["i"])
    im.emit(node, "squeeze", ins, {"axis": dims})


@handler("ConcatV2")
def _h_concat(im, node):
    ins = im.data_inputs(node)
    axis = int(im.need_const(ins[-1], "ConcatV2 axis"))
    im.emit(node, "concat", ins[:-1], {"dimension": axis})


@handler("Pack")
def _h_pack(im, node):
    axis = node.attrs["axis"].i if "axis" in node.attrs else 0
    im.emit(node, "stack", im.data_inputs(node), {"axis": int(axis)})


@handler("Unpack")
def _h_unpack(im, node):
    axis = node.attrs["axis"].i if "axis" in node.attrs else 0
    num = node.attrs["num"].i
    im.emit(node, "unstack", im.data_inputs(node),
            {"axis": int(axis), "num": int(num)})


@handler("Split")
def _h_split(im, node):
    ins = im.data_inputs(node)  # [axis, value]
    axis = int(im.need_const(ins[0], "Split axis"))
    num = int(node.attrs["num_split"].i)
    im.emit(node, "split", [ins[1]],
            {"numSplit": num, "dimension": axis})


@handler("StridedSlice")
def _h_strided_slice(im, node):
    ins = im.data_inputs(node)
    begin = im.need_const(ins[1], "StridedSlice begin")
    end = im.need_const(ins[2], "StridedSlice end")
    strides = im.need_const(ins[3], "StridedSlice strides") \
        if len(ins) > 3 else None
    in_shape = im.shape(ins[0])
    # allocation-free shape probe (broadcast view, never materialized)
    probe = np.broadcast_to(np.int8(0), in_shape)
    _, idx = _apply_strided_slice(node, probe, begin, end, strides)

    ser = [None if i is None else
           ([i.start, i.stop, i.step] if isinstance(i, slice) else int(i))
           for i in idx]
    im.emit(node, "tfStridedSlice", [ins[0]], {"idx": tuple(
        tuple(s) if isinstance(s, list) else s for s in ser)})


@handler("Slice")
def _h_slice(im, node):
    ins = im.data_inputs(node)
    begin = [int(b) for b in im.need_const(ins[1], "Slice begin")]
    size = [int(s) for s in im.need_const(ins[2], "Slice size")]
    im.emit(node, "slice", [ins[0]], {"begin": begin, "size": size})


@handler("Gather", "GatherV2")
def _h_gather(im, node):
    ins = im.data_inputs(node)
    axis = 0
    if node.op == "GatherV2" and len(ins) > 2:
        axis = int(im.need_const(ins[2], "GatherV2 axis"))
    im.emit(node, "gather", ins[:2], {"axis": axis})


@handler("GatherNd")
def _h_gather_nd(im, node):
    im.emit(node, "gatherNd", im.data_inputs(node))


@handler("OneHot")
def _h_one_hot(im, node):
    ins = im.data_inputs(node)
    depth = int(im.need_const(ins[1], "OneHot depth"))
    on = float(im.need_const(ins[2], "OneHot on_value"))
    off = float(im.need_const(ins[3], "OneHot off_value"))
    axis = node.attrs["axis"].i if "axis" in node.attrs else -1
    im.emit(node, "oneHot", [ins[0]],
            {"depth": depth, "on": on, "off": off, "axis": int(axis)})


@handler("Cast")
def _h_cast(im, node):
    dt = dtype_to_numpy(node.attrs["DstT"].type)
    im.emit(node, "cast", im.data_inputs(node), {"dtype": np.dtype(dt)},
            out_dtype=dt)


@handler("Shape", "Size", "Rank")
def _h_shape(im, node):
    ins = im.data_inputs(node)
    val = im._fold(node.name)
    if val is None:
        sh = im.shape(ins[0])
        val = {"Shape": np.asarray(sh, np.int32),
               "Size": np.asarray(int(np.prod(sh)), np.int32),
               "Rank": np.asarray(len(sh), np.int32)}[node.op]
        im.consts[node.name] = val
    v = im.sd.constant(node.name, val)
    im.bind(node.name, v, np.asarray(val).shape, np.asarray(val).dtype)


@handler("Range")
def _h_range(im, node):
    val = im._fold(node.name)
    if val is None:
        raise TFImportError(f"Range node {node.name!r} with non-constant "
                            "inputs")
    v = im.sd.constant(node.name, val)
    im.bind(node.name, v, val.shape, val.dtype)


@handler("Fill")
def _h_fill(im, node):
    ins = im.data_inputs(node)
    dims = [int(d) for d in im.need_const(ins[0], "Fill dims")]
    value = im.need_const(ins[1], "Fill value")
    arr = np.full(dims, value)
    im.consts[node.name] = arr
    v = im.sd.constant(node.name, arr)
    im.bind(node.name, v, arr.shape, arr.dtype)


@handler("Tile")
def _h_tile(im, node):
    ins = im.data_inputs(node)
    reps = [int(r) for r in im.need_const(ins[1], "Tile multiples")]
    im.emit(node, "tile", [ins[0]], {"reps": reps})


@handler("Pad", "PadV2")
def _h_pad(im, node):
    ins = im.data_inputs(node)
    pads = [[int(a), int(b)] for a, b in
            im.need_const(ins[1], "Pad paddings")]
    const = 0.0
    if node.op == "PadV2" and len(ins) > 2:
        const = float(im.need_const(ins[2], "PadV2 constant"))
    im.emit(node, "pad", [ins[0]], {"paddings": pads, "constant": const})


@handler("Select", "SelectV2")
def _h_select(im, node):
    im.emit(node, "where_op", im.data_inputs(node))


@handler("Einsum")
def _h_einsum(im, node):
    """tf.einsum with a static equation attr — exported BERT graphs
    express their projections this way."""
    eq = node.attrs["equation"].s.decode()
    im.emit(node, "tfEinsum", im.data_inputs(node), {"equation": eq})


@handler("SpaceToDepth", "DepthToSpace")
def _h_space_depth(im, node):
    """NOTE: emitted against our NCHW ops. TF's DEFAULT data_format for
    these ops is NHWC, so an absent attr is NHWC and must be rejected —
    only graphs declaring NCHW import exactly."""
    fmt = node.attrs.get("data_format")
    fmt_s = fmt.s.decode() if fmt is not None else "NHWC"
    if fmt_s != "NCHW":
        raise ValueError(
            f"{node.op} data_format {fmt_s!r} unsupported (NCHW only)")
    bs = int(node.attrs["block_size"].i)
    opname = ("spaceToDepth" if node.op == "SpaceToDepth"
              else "depthToSpace")
    im.emit(node, opname, im.data_inputs(node), {"blockSize": bs})


@handler("TopKV2")
def _h_topk(im, node):
    ins = im.data_inputs(node)
    k = int(im.need_const(ins[1], "TopKV2 k"))
    im.emit(node, "topK", [ins[0]], {"k": k})


@handler("Cumsum")
def _h_cumsum(im, node):
    ins = im.data_inputs(node)
    axis = int(im.need_const(ins[1], "Cumsum axis"))
    excl = node.attrs.get("exclusive")
    rev = node.attrs.get("reverse")
    im.emit(node, "cumsum", [ins[0]],
            {"axis": axis, "exclusive": bool(excl.b) if excl else False,
             "reverse": bool(rev.b) if rev else False})


@handler("ZerosLike", "OnesLike")
def _h_fill_like(im, node):
    key = "tfZerosLike" if node.op == "ZerosLike" else "tfOnesLike"
    im.emit(node, key, im.data_inputs(node))


@handler("Conv2D")
def _h_conv2d(im, node):
    ins = im.data_inputs(node)
    fmt = node.attrs.get("data_format")
    nhwc = fmt is None or fmt.s in (b"NHWC", None)
    strides = [int(s) for s in node.attrs["strides"].list["i"]]
    pad = node.attrs["padding"].s.decode()
    dil = [int(d) for d in node.attrs["dilations"].list["i"]] \
        if "dilations" in node.attrs else [1, 1, 1, 1]
    x_ref = ins[0]
    if nhwc:
        x_ref = _permute(im, node, ins[0], (0, 3, 1, 2), "__nchw")
        s_hw, d_hw = (strides[1], strides[2]), (dil[1], dil[2])
    else:
        s_hw, d_hw = (strides[2], strides[3]), (dil[2], dil[3])
    # TF kernel HWIO -> our OIHW
    w_ref = _permute(im, node, ins[1], (3, 2, 0, 1), "__oihw")
    attrs = {"strides": s_hw,
             "dilation": d_hw,
             "sameMode": pad == "SAME",
             "padding": (0, 0)}
    out_name = node.name if not nhwc else f"{node.name}__conv"
    conv = im.sd._op("conv2d", [im.var(x_ref), im.var(w_ref)], attrs,
                     out_name)
    st = _eval_shape("conv2d", [(im.shape(x_ref), im.dtype(x_ref)),
                                (im.shape(w_ref), im.dtype(w_ref))], attrs)
    im.bind(out_name, conv, st.shape, st.dtype)
    if nhwc:
        _permute(im, node, f"{out_name}:0", (0, 2, 3, 1), "", node.name)


@handler("MaxPool", "AvgPool")
def _h_pool(im, node):
    ins = im.data_inputs(node)
    fmt = node.attrs.get("data_format")
    nhwc = fmt is None or fmt.s in (b"NHWC", None)
    ks = [int(s) for s in node.attrs["ksize"].list["i"]]
    st = [int(s) for s in node.attrs["strides"].list["i"]]
    pad = node.attrs["padding"].s.decode()
    x_ref = ins[0]
    if nhwc:
        x_ref = _permute(im, node, ins[0], (0, 3, 1, 2), "__nchw")
        k_hw, s_hw = (ks[1], ks[2]), (st[1], st[2])
    else:
        k_hw, s_hw = (ks[2], ks[3]), (st[2], st[3])
    fn = "maxPooling2d" if node.op == "MaxPool" else "avgPooling2d"
    out_name = node.name if not nhwc else f"{node.name}__pool"
    attrs = {"kernel": k_hw, "strides": s_hw, "sameMode": pad == "SAME",
             "padding": (0, 0)}
    v = im.sd._op(fn, [im.var(x_ref)], attrs, out_name)
    sh = _eval_shape(fn, [(im.shape(x_ref), im.dtype(x_ref))], attrs)
    im.bind(out_name, v, sh.shape, sh.dtype)
    if nhwc:
        _permute(im, node, f"{out_name}:0", (0, 2, 3, 1), "", node.name)


@handler("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3")
def _h_fused_bn(im, node):
    ins = im.data_inputs(node)  # x, scale, offset, mean, variance
    fmt = node.attrs.get("data_format")
    nhwc = fmt is None or fmt.s in (b"NHWC", None)
    eps = node.attrs["epsilon"].f if "epsilon" in node.attrs else 1e-3
    axis = 3 if nhwc else 1
    im.emit(node, "batchNorm",
            [ins[0], ins[3], ins[4], ins[1], ins[2]],
            {"epsilon": float(eps), "axis": axis})


def _permute(im, node, ref, perm, suffix, out_name=None):
    """Emit a permute helper node; returns the new tensor ref string."""
    name = out_name or f"{node.name}{suffix}"
    attrs = {"dimensions": tuple(perm)}
    v = im.sd._op("permute", [im.var(ref)], attrs, name)
    sh = _eval_shape("permute", [(im.shape(ref), im.dtype(ref))], attrs)
    im.bind(name, v, sh.shape, sh.dtype)
    return f"{name}:0"


# ---------------------------------------------------------------------------
# control flow (the reference interprets TF's control flow in Java) — here
# v2 FUNCTIONAL control flow (While/StatelessWhile/If/StatelessIf +
# FunctionDef library) lowers onto the SameDiff whileLoop/ifCond ops,
# whose bodies are the imported function sub-graphs (serializable, run as
# Python loops and branches over the body's ops). v1 dataflow loops
# (Enter/Merge/Switch/NextIteration/Exit) are frame-encoded and cyclic;
# they are rejected with guidance to re-export functionally, which is
# what TF2's own importer requires too.)
# ---------------------------------------------------------------------------

def _function_subgraph(im, fname, arg_refs, what):
    """Import FunctionDef `fname` into a child SameDiff wrapped as a
    SubGraph; arg shapes/dtypes come from the outer tensors feeding it.
    Returns (SubGraph, out_shapes, out_dtypes)."""
    fdef = im.functions.get(fname)
    if fdef is None:
        raise TFImportError(
            f"{what} references function {fname!r} which is not in the "
            f"GraphDef library (have: {sorted(im.functions)})")
    sig = fdef.signature
    if len(sig.input_args) != len(arg_refs):
        raise TFImportError(
            f"{what} function {fname!r} takes {len(sig.input_args)} args "
            f"but {len(arg_refs)} were passed")

    nodes, ph_shapes = [], {}
    for arg, ref in zip(sig.input_args, arg_refs):
        shape = im.shape(ref)
        dt = im.dtype(ref)
        nodes.append(NodeDef(arg.name, "Placeholder", [], {
            "dtype": AttrValue(type=numpy_to_dtype(dt)),
            "shape": AttrValue(shape=TensorShapeProto(list(shape))),
        }))
        ph_shapes[arg.name] = shape
    nodes += fdef.nodes

    sub = _Importer(GraphDef(nodes, functions=list(im.functions.values())),
                    ph_shapes, strict=im.strict, device=im.device)
    child = sub.run()

    out_names, out_shapes, out_dtypes = [], [], []
    for arg in sig.output_args:
        ret_ref = fdef.ret.get(arg.name)
        if ret_ref is None:
            raise TFImportError(
                f"{what} function {fname!r} has no ret mapping for "
                f"output {arg.name!r}")
        v = sub.var(ret_ref)
        out_names.append(v.name())
        node_name, idx = sub._resolve(ret_ref)
        out_shapes.append(sub.shapes[f"{node_name}:{idx}"])
        out_dtypes.append(sub.dtypes[f"{node_name}:{idx}"])
    return (SubGraph(child, [a.name for a in sig.input_args], out_names),
            out_shapes, out_dtypes)


@handler("While", "StatelessWhile")
def _h_while(im, node):
    ins = im.data_inputs(node)
    cond, _, _ = _function_subgraph(im, node.attrs["cond"].func, ins,
                                    f"While node {node.name!r} cond")
    body, body_shapes, body_dtypes = _function_subgraph(
        im, node.attrs["body"].func, ins, f"While node {node.name!r} body")
    if len(body.out_names) != len(ins):
        raise TFImportError(
            f"While body must return {len(ins)} loop vars, got "
            f"{len(body.out_names)}")
    in_vars = [im.var(r) for r in ins]
    attrs = {"cond_graph": cond, "cond_fn": cond.callable(squeeze=True),
             "body_graph": body, "body_fn": body.callable()}
    n = len(in_vars)
    res = im.sd._op("whileLoop", in_vars, attrs, node.name,
                    n_out=n if n > 1 else 1)
    outs = res if isinstance(res, tuple) else (res,)
    for i, v in enumerate(outs):
        im.bind(node.name, v, body_shapes[i], body_dtypes[i], out_idx=i)


@handler("If", "StatelessIf")
def _h_if(im, node):
    ins = im.data_inputs(node)
    pred, rest = ins[0], ins[1:]
    tb, t_shapes, t_dtypes = _function_subgraph(
        im, node.attrs["then_branch"].func, rest,
        f"If node {node.name!r} then_branch")
    fb, f_shapes, f_dtypes = _function_subgraph(
        im, node.attrs["else_branch"].func, rest,
        f"If node {node.name!r} else_branch")
    if len(tb.out_names) != len(fb.out_names):
        raise TFImportError(
            f"If branches return different arities: {len(tb.out_names)} "
            f"vs {len(fb.out_names)}")
    if list(t_shapes) != list(f_shapes) or \
            [np.dtype(d) for d in t_dtypes] != \
            [np.dtype(d) for d in f_dtypes]:
        raise TFImportError(
            f"If node {node.name!r} branches disagree on output "
            f"shapes/dtypes: then {list(zip(t_shapes, t_dtypes))} vs "
            f"else {list(zip(f_shapes, f_dtypes))} — ifCond requires "
            f"identical branch signatures")
    attrs = {"true_graph": tb, "true_fn": tb.callable(),
             "false_graph": fb, "false_fn": fb.callable()}
    n_out = len(tb.out_names)
    res = im.sd._op("ifCond", [im.var(pred)] + [im.var(r) for r in rest],
                    attrs, node.name, n_out=n_out)
    outs = res if isinstance(res, tuple) else (res,)
    for i, v in enumerate(outs):
        im.bind(node.name, v, t_shapes[i], t_dtypes[i], out_idx=i)


@handler("Enter", "Exit", "Merge", "Switch", "NextIteration", "LoopCond")
def _h_v1_control_flow(im, node):
    # single-frame while loops (incl. single-frame TensorArray loops) are
    # rewritten into _V1While by _rewrite_v1_loops before import; anything
    # that still reaches this handler is outside the supported subset
    raise TFImportError(
        f"node {node.name!r} uses TF v1 dataflow control flow "
        f"({node.op}) outside the supported single-frame while-loop "
        "subset (nested frames / cond-via-Switch are frame-encoded and "
        "cyclic) — re-export the model with TF2 functional control flow "
        "(While/If + function library), which imports onto SameDiff "
        "whileLoop/ifCond")


# ---------------------------------------------------------------------------
# TF v1 dataflow while-loops: the acyclic-frame subset — ONE frame per
# loop, no nesting, TensorArrays lowered to buffers — is rewritten into a
# synthetic functional node before import and lowered onto the same
# SameDiff whileLoop (or forLoop) the TF2 While handler uses. DL4J
# interprets Enter/Merge/Switch/Exit in Java; here the frame is
# translated once at import time:
#   Enter_i -> loop var i's init value (outer graph)
#   Merge_i -> cond-graph placeholder i   (cond computes LoopCond input)
#   Switch_i:1 -> body-graph placeholder i (body computes NextIteration)
#   Exit_i -> whileLoop output i
# Loop-invariant Enters (is_constant=true) and references to outer
# tensors inline as constants when host-foldable; otherwise rejected.
# ---------------------------------------------------------------------------

class _V1Frame:
    def __init__(self, name):
        self.name = name
        self.enters = []        # loop-var Enter nodes
        self.const_enters = []  # is_constant Enters (loop invariants)
        self.handle_enters = {}  # enter name -> TensorArrayV3 node name
        self.nodes = {}         # interior name -> NodeDef (incl. merges)
        self.merges = []
        self.switches = {}      # merge name -> Switch node
        self.exits = {}         # merge name -> Exit node
        self.next_iters = {}    # merge name -> NextIteration input ref
        self.loop_cond = None


# interior TensorArray ops lower onto a loop-carried [size, ...] buffer
# (the TF "flow" edge is reinterpreted as the buffer tensor itself):
# op -> (synthetic op, original input positions kept, in order)
_TA_INTERIOR = {
    "TensorArrayReadV3": ("_TARead", (2, 1)),      # (flow, index)
    "TensorArrayWriteV3": ("_TAWrite", (3, 1, 2)),  # (flow, index, value)
    "TensorArrayGatherV3": ("_TAGather", (2, 1)),   # (flow, indices)
    "TensorArrayScatterV3": ("_TAWrite", (3, 1, 2)),
    "TensorArraySizeV3": ("_TASize", (1,)),         # (flow,)
}


def _find_v1_frames(gd):
    """Group v1 control-flow nodes by frame_name; returns
    {frame: _V1Frame} or raises for unsupported shapes."""
    producers = {n.name: n for n in gd.nodes}
    frames = {}
    frame_of = {}  # node name -> frame name (propagated)

    def frame_attr(n):
        a = n.attrs.get("frame_name")
        if a is None:
            raise TFImportError(
                f"Enter node {n.name!r} has no frame_name attr")
        return a.s.decode() if isinstance(a.s, bytes) else a.s

    enters = [n for n in gd.nodes if n.op == "Enter"]
    if not enters:
        return {}
    for n in enters:
        f = frames.setdefault(frame_attr(n), _V1Frame(frame_attr(n)))
        const = n.attrs.get("is_constant")
        if const is not None and const.b:
            f.const_enters.append(n)
        else:
            f.enters.append(n)
        frame_of[n.name] = f.name
    # forward-propagate frame membership (Exit leaves the frame)
    changed = True
    while changed:
        changed = False
        for n in gd.nodes:
            if n.name in frame_of or n.op in ("Enter", "Exit"):
                continue
            for inp in n.inputs:
                src, _ = _ref(inp)
                if src in frame_of:
                    fname = frame_of[src]
                    if producers[src].op == "Exit":
                        continue
                    frame_of[n.name] = fname
                    frames[fname].nodes[n.name] = n
                    changed = True
                    break
    for n in gd.nodes:
        if n.op == "Exit":
            src, _ = _ref(n.inputs[0])
            if src not in frame_of:
                raise TFImportError(
                    f"Exit node {n.name!r} input does not trace to a "
                    "frame")
            frame_of[n.name] = None  # Exit output is outer
    for f in frames.values():
        _classify_frame(f, producers)
    return frames


def _classify_frame(f, producers):
    _rewrite_frame_tensor_arrays(f, producers)
    for name, n in list(f.nodes.items()):
        if n.op == "Merge":
            f.merges.append(n)
        elif n.op == "LoopCond":
            f.loop_cond = n
    if f.loop_cond is None:
        raise TFImportError(
            f"v1 frame {f.name!r} has no LoopCond — not a while loop")
    f.merges.sort(key=lambda n: n.name)
    enters_by_name = {n.name: n for n in f.enters}
    for m in f.merges:
        srcs = [_ref(i)[0] for i in m.inputs]
        enter = next((s for s in srcs if s in enters_by_name), None)
        ni = next((producers[s] for s in srcs
                   if producers[s].op == "NextIteration"), None)
        if enter is None or ni is None:
            raise TFImportError(
                f"v1 Merge {m.name!r} is not an (Enter, NextIteration) "
                "merge — unsupported frame shape")
        m._enter = enters_by_name[enter]
        f.next_iters[m.name] = ni.inputs[0]
    # order enters to match merges
    f.enters = [m._enter for m in f.merges]
    for n in f.nodes.values():
        if n.op == "Switch":
            src, _ = _ref(n.inputs[0])
            if src in {m.name for m in f.merges}:
                f.switches[src] = n
    for m in f.merges:
        if m.name not in f.switches:
            raise TFImportError(
                f"v1 Merge {m.name!r} has no Switch — unsupported "
                "frame shape")


def _rewrite_frame_tensor_arrays(f, producers):
    """Lower interior TensorArrayV3 ops to synthetic _TA* nodes over the
    flow edge, reinterpreted as the [size, ...] buffer tensor (the
    dynamic_rnn idiom: per-step reads from an input array, per-step
    writes of cell outputs). The array handle (a TF resource) is only an
    identity token — every TA op also carries the flow — so handle
    Enters are dropped and each op keeps (flow, index[, value]) inputs.
    """
    ta_nodes = [n for n in f.nodes.values()
                if n.op.startswith("TensorArray")]
    if not ta_nodes:
        return
    # handle Enters: loop-invariant Enters fed from a TensorArrayV3:0
    for e in list(f.const_enters):
        src, idx = _ref(e.inputs[0])
        p = producers.get(src)
        if p is not None and p.op == "TensorArrayV3" and idx == 0:
            f.handle_enters[e.name] = src
            f.const_enters.remove(e)
    for n in ta_nodes:
        if n.op == "TensorArrayCloseV3":
            del f.nodes[n.name]
            continue
        spec = _TA_INTERIOR.get(n.op)
        if spec is None:
            raise TFImportError(
                f"v1 frame {f.name!r} uses {n.op}, which has no "
                "loop-carried-buffer lowering (supported inside a "
                "frame: TensorArray Read/Write/Scatter/Gather/Size) — "
                "re-export with TF2 functional control flow")
        new_op, keep = spec
        h_src, _h_idx = _ref(n.inputs[0])
        ta_name = f.handle_enters.get(h_src)
        if ta_name is None:
            raise TFImportError(
                f"v1 frame {f.name!r}: {n.op} node {n.name!r} handle "
                "does not come from a loop-invariant Enter of a "
                "TensorArrayV3 created outside the frame — TensorArrays "
                "created inside the loop are unsupported")
        f.nodes[n.name] = NodeDef(
            n.name, new_op, [n.inputs[p] for p in keep], dict(n.attrs))


def _rewrite_v1_loops(gd):
    """Replace each supported v1 while frame with one synthetic
    _V1While node (frame object stashed on the NodeDef); returns the
    rewritten GraphDef (or the original when no frames exist)."""
    frames = _find_v1_frames(gd)
    if not frames:
        return gd
    drop = set()
    synth = []
    exits_of = {}
    for f in frames.values():
        names = set(f.nodes)
        names.update(n.name for n in f.enters + f.const_enters)
        names.update(f.handle_enters)
        # exits: outer nodes consuming a Switch:0 of this frame
        f.exit_nodes = []
        sw_names = {sw.name: mn for mn, sw in f.switches.items()}
        for n in gd.nodes:
            if n.op == "Exit":
                src, _ = _ref(n.inputs[0])
                if src in sw_names:
                    n._merge = sw_names[src]
                    f.exit_nodes.append(n)
                    names.add(n.name)
        drop |= names
        init_refs = [e.inputs[0] for e in f.enters]
        # loop-invariant Enter refs ride as extra inputs so the importer
        # visits their producers first; at import time each is either
        # inlined as a constant (host-foldable) or promoted to a
        # pass-through loop variable (e.g. an input TensorArray buffer)
        inv_refs = [e.inputs[0] for e in f.const_enters]
        node = NodeDef(f"__v1while_{len(synth)}", "_V1While",
                       list(init_refs) + inv_refs, {})
        node._frame = f
        node._n_loop = len(init_refs)
        synth.append(node)
        exits_of[node.name] = f.exit_nodes
    # Exit nodes become Identity over the synthetic node's outputs:
    # their names stay addressable both for downstream refs and as
    # user-requested output tensors
    exit_identities = []
    for node in synth:
        f = node._frame
        merge_pos = {m.name: i for i, m in enumerate(f.merges)}
        for ex in f.exit_nodes:
            i = merge_pos[ex._merge]
            ref = f"{node.name}:{i}" if i else node.name
            exit_identities.append(
                type(ex)(ex.name, "Identity", [ref], dict(ex.attrs)))

    kept = [n for n in gd.nodes if n.name not in drop]
    gd2 = type(gd)(kept + synth + exit_identities, functions=list(
        getattr(gd, "functions", []) or []))
    return gd2


def _const_nodedef(name, arr):
    return NodeDef(name, "Const", [], {
        "dtype": attr_type(arr.dtype), "value": attr_tensor(arr)})


def _subgraph_from_nodes(im, frame, targets, placeholder_map, what,
                         device=None):
    """Child SameDiff over the frame interior: `targets` are the refs to
    return; placeholder_map maps interior node names to (shape, dtype)
    formal args (Merge or Switch). Outer refs inline as constants when
    foldable. The child lives on ``device``, the importer's unless
    named."""
    ph_nodes, ph_shapes = [], {}
    for name, (shape, dt) in placeholder_map.items():
        ph_nodes.append(NodeDef(name, "Placeholder", [], {
            "dtype": AttrValue(type=numpy_to_dtype(dt)),
            "shape": AttrValue(shape=TensorShapeProto(list(shape))),
        }))
        ph_shapes[name] = shape

    # backward closure over interior nodes from the targets; a target
    # that is itself a Switch:1 ref (pass-through loop var: NextIteration
    # fed straight from the Switch) must seed the stack as its Merge
    # placeholder, or the Switch/LoopCond chain gets pulled into the
    # body subgraph
    const_enter_names = {n.name: n for n in frame.const_enters}
    sw_to_merge = {sw.name: mn for mn, sw in frame.switches.items()}
    needed, stack = set(), [
        sw_to_merge.get(_ref(t)[0], _ref(t)[0]) for t in targets]
    interior = dict(frame.nodes)
    rewritten = {}
    while stack:
        nm = stack.pop()
        if nm in needed or nm in placeholder_map:
            continue
        needed.add(nm)
        n = interior.get(nm)
        if n is None:
            if nm in const_enter_names:
                outer_ref = const_enter_names[nm].inputs[0]
                val = im.const(outer_ref)
                if val is None:
                    raise TFImportError(
                        f"{what}: loop-invariant Enter {nm!r} is not "
                        "host-foldable — pass it through the loop state "
                        "or re-export with TF2 control flow")
                arr = np.asarray(val)
                rewritten[nm] = _const_nodedef(nm, arr)
                continue
            val = im.const(nm)
            if val is None:
                raise TFImportError(
                    f"{what}: body references outer tensor {nm!r} "
                    "which is not host-foldable — pass it through the "
                    "loop state or re-export with TF2 control flow")
            rewritten[nm] = _const_nodedef(nm, np.asarray(val))
            continue
        # strip Switch:1 refs down to the placeholder names
        new_inputs = []
        for inp in n.inputs:
            if inp.startswith("^"):
                continue
            src, idx = _ref(inp)
            if src in sw_to_merge:
                new_inputs.append(sw_to_merge[src])
                stack.append(sw_to_merge[src])
            else:
                new_inputs.append(inp)
                stack.append(src)
        rewritten[nm] = NodeDef(nm, n.op, new_inputs, dict(n.attrs))

    gd_nodes = ph_nodes + [rewritten[nm] for nm in rewritten]
    sub = _Importer(GraphDef(gd_nodes, functions=[]), ph_shapes,
                    strict=im.strict, device=device or im.device)
    child = sub.run()
    out_names, out_shapes, out_dtypes = [], [], []
    for t in targets:
        src, idx = _ref(t)
        if src in sw_to_merge:  # Switch:1 -> single-output placeholder
            src, idx = sw_to_merge[src], 0
        v = sub.var(f"{src}:{idx}" if idx else src)
        out_names.append(v.name())
        out_shapes.append(sub.shapes[f"{src}:{idx}"])
        out_dtypes.append(sub.dtypes[f"{src}:{idx}"])
    return (SubGraph(child, list(placeholder_map), out_names),
            out_shapes, out_dtypes)


def _resolve_ta_flow_init(im, f, merge, ref, ph_known, what):
    """An output-TensorArray flow loop var whose init is an unbound
    TensorArrayV3 flow (element_shape unknown at creation): infer the
    element shape by importing just the frame's write-value expression,
    then bind a zeros buffer at the TA's flow output."""
    src, idx = _ref(ref)
    if f"{src}:{idx}" in im.shapes:
        return
    nd = im.nodes.get(src)
    if nd is None or nd.op != "TensorArrayV3" or src not in \
            im.tensor_arrays:
        im.shape(ref)  # raises the standard "no static shape" error
        return
    info = im.tensor_arrays[src]
    if info["elem"] is not None:  # declared element_shape: no probe
        _bind_ta_zeros(im, src, info["elem"], None, out_idx=idx)
        return
    # find a _TAWrite into this loop var: its flow input chain ends at
    # this merge's Switch:1 (possibly through other writes/Identity)
    sw = f.switches[merge.name].name
    write = None
    for n in f.nodes.values():
        if n.op != "_TAWrite":
            continue
        chain, seen = _ref(n.inputs[0])[0], set()
        while chain not in seen:
            seen.add(chain)
            if chain == sw:
                write = n
                break
            p = f.nodes.get(chain)
            if p is None or p.op not in ("_TAWrite", "Identity"):
                break
            chain = _ref(p.inputs[0])[0]
        if write is not None:
            break
    if write is None:
        raise TFImportError(
            f"{what}: TensorArray {src!r} has no element_shape and no "
            "write inside the frame to infer it from")
    try:
        _, shapes, dtypes = _subgraph_from_nodes(
            im, f, [write.inputs[2]], ph_known,
            what + f" (element-shape probe for TensorArray {src!r})")
    except TFImportError as e:
        raise TFImportError(
            f"{what}: cannot infer the element shape of TensorArray "
            f"{src!r} — the written value depends on state that is not "
            f"resolvable before the loop: {e}") from e
    _bind_ta_zeros(im, src, tuple(shapes[0]), dtypes[0], out_idx=idx)


def _cond_cone_inits(im, f, init_refs):
    """The loop-cond cone's merge variables with their host-foldable
    integer/bool inits, or None when the cond depends on anything that
    cannot be tracked on the host (floats, TensorArrays, non-foldable
    outer tensors)."""
    sw_to_merge = {sw.name: mn for mn, sw in f.switches.items()}
    merge_idx = {m.name: i for i, m in enumerate(f.merges)}
    const_enter_names = {n.name for n in f.const_enters}

    needed, frontier, visited = set(), [f.loop_cond.inputs[0]], set()
    while frontier:
        ref = frontier.pop()
        nm = _ref(ref)[0]
        nm = sw_to_merge.get(nm, nm)
        if nm in visited:
            continue
        visited.add(nm)
        if nm in merge_idx:
            if nm not in needed:
                needed.add(nm)
                frontier.append(f.next_iters[nm])
            continue
        n = f.nodes.get(nm)
        if n is None:
            # outer tensor or loop-invariant Enter: must be foldable
            if nm in const_enter_names:
                e = next(e for e in f.const_enters if e.name == nm)
                if im.const(e.inputs[0]) is None:
                    return None
            elif im.const(nm) is None:
                return None
            continue
        if n.op.startswith("_TA"):
            return None  # depends on a buffer: not simulable
        frontier.extend(i for i in n.inputs if not i.startswith("^"))

    inits = []
    for mn in sorted(needed, key=lambda x: merge_idx[x]):
        val = im.const(init_refs[merge_idx[mn]])
        if val is None:
            return None
        val = np.asarray(val)
        if not (np.issubdtype(val.dtype, np.integer)
                or val.dtype == np.bool_):
            return None  # float counters: simulation could drift
        inits.append((mn, val))
    if not inits:
        return None  # cond is loop-invariant: either 0 or infinite
    return inits


def _resolve_scalar(im, f, ref, sw_to_merge, merge_names):
    """('var', merge_name) for a loop-variable ref, ('const', ndarray)
    for a host-foldable value, or None — following Identity chains and
    Switch:1 edges inside the frame."""
    src, idx = _ref(ref)
    seen = set()
    while True:
        if src in seen:
            return None
        seen.add(src)
        mn = sw_to_merge.get(src, src)
        if mn in merge_names:
            return ("var", mn)
        n = f.nodes.get(src)
        if n is None:
            for e in f.const_enters:
                if e.name == src:
                    v = im.const(e.inputs[0])
                    return None if v is None else ("const", np.asarray(v))
            v = im.const(f"{src}:{idx}" if idx else src)
            return None if v is None else ("const", np.asarray(v))
        if n.op in ("Identity", "StopGradient") and idx == 0:
            src, idx = _ref(n.inputs[0])
            continue
        if n.op == "Const":
            return ("const",
                    np.asarray(n.attrs["value"].tensor.to_numpy()))
        return None


_CMP_FLIP = {"Less": "Greater", "Greater": "Less",
             "LessEqual": "GreaterEqual", "GreaterEqual": "LessEqual"}


def _affine_trip_count(im, f, init_refs):
    """Closed-form trip count for the affine counter idiom TF1 emits
    for counted loops and dynamic_rnn (`i = i0; while cmp(i, n): i +=
    c`) — O(1) instead of simulating the loop at import time. None when
    the cond/update are not that shape."""
    merge_idx = {m.name: i for i, m in enumerate(f.merges)}
    sw_to_merge = {sw.name: mn for mn, sw in f.switches.items()}

    cond = f.nodes.get(_ref(f.loop_cond.inputs[0])[0])
    while cond is not None and cond.op == "Identity":
        cond = f.nodes.get(_ref(cond.inputs[0])[0])
    if cond is None or cond.op not in _CMP_FLIP:
        return None
    lhs = _resolve_scalar(im, f, cond.inputs[0], sw_to_merge, merge_idx)
    rhs = _resolve_scalar(im, f, cond.inputs[1], sw_to_merge, merge_idx)
    if lhs is None or rhs is None:
        return None
    op = cond.op
    if lhs[0] == "const" and rhs[0] == "var":
        lhs, rhs, op = rhs, lhs, _CMP_FLIP[op]
    if lhs[0] != "var" or rhs[0] != "const":
        return None
    mn, bound_arr = lhs[1], rhs[1]
    if bound_arr.size != 1 or \
            not np.issubdtype(bound_arr.dtype, np.integer):
        return None
    bound = int(bound_arr.reshape(()))

    init = im.const(init_refs[merge_idx[mn]])
    if init is None:
        return None
    init = np.asarray(init)
    if init.size != 1 or not np.issubdtype(init.dtype, np.integer):
        return None
    i0 = int(init.reshape(()))

    upd = f.nodes.get(_ref(f.next_iters[mn])[0])
    while upd is not None and upd.op == "Identity":
        upd = f.nodes.get(_ref(upd.inputs[0])[0])
    if upd is None or upd.op not in ("Add", "AddV2", "Sub"):
        return None
    a = _resolve_scalar(im, f, upd.inputs[0], sw_to_merge, merge_idx)
    b = _resolve_scalar(im, f, upd.inputs[1], sw_to_merge, merge_idx)
    step = None
    if a is not None and b is not None:
        if a[0] == "var" and a[1] == mn and b[0] == "const" \
                and b[1].size == 1:
            step = int(b[1].reshape(()))
            if upd.op == "Sub":
                step = -step
        elif upd.op != "Sub" and b[0] == "var" and b[1] == mn \
                and a[0] == "const" and a[1].size == 1:
            step = int(a[1].reshape(()))
    if step is None or step == 0:
        return None

    # trips = #{t >= 0 : cmp(i0 + t*step, bound)} with cmp checked
    # before each body run; None when the counter moves away from the
    # exit (non-terminating — leave it to whileLoop)
    if op == "Less":
        if i0 >= bound:
            return 0
        return (bound - i0 + step - 1) // step if step > 0 else None
    if op == "LessEqual":
        if i0 > bound:
            return 0
        return (bound - i0) // step + 1 if step > 0 else None
    if op == "Greater":
        if i0 <= bound:
            return 0
        return (i0 - bound - step - 1) // -step if step < 0 else None
    if i0 < bound:  # GreaterEqual
        return 0
    return (i0 - bound) // -step + 1 if step < 0 else None


_SIM_BINOPS = {
    "Add": np.add, "AddV2": np.add, "Sub": np.subtract,
    "Mul": np.multiply, "FloorDiv": np.floor_divide,
    "Maximum": np.maximum, "Minimum": np.minimum,
    "FloorMod": np.mod, "Mod": np.mod,
    "Less": np.less, "LessEqual": np.less_equal,
    "Greater": np.greater, "GreaterEqual": np.greater_equal,
    "Equal": np.equal, "NotEqual": np.not_equal,
    "LogicalAnd": np.logical_and, "LogicalOr": np.logical_or,
}
_SIM_UNOPS = {"Neg": np.negative, "LogicalNot": np.logical_not,
              "Abs": np.abs, "Square": np.square}


def _np_eval(im, f, ref, env, sw_to_merge, memo):
    """numpy value of a frame-interior ref given the loop-variable env;
    None when an op outside the host-simulable set is reached."""
    src, idx = _ref(ref)
    mn = sw_to_merge.get(src, src)
    if mn in env:
        return env[mn]
    if src in memo:
        return memo[src]
    n = f.nodes.get(src)
    if n is None:
        for e in f.const_enters:
            if e.name == src:
                v = im.const(e.inputs[0])
                memo[src] = None if v is None else np.asarray(v)
                return memo[src]
        v = im.const(f"{src}:{idx}" if idx else src)
        memo[src] = None if v is None else np.asarray(v)
        return memo[src]
    ins = [i for i in n.inputs if not i.startswith("^")]
    if n.op == "Const":
        v = np.asarray(n.attrs["value"].tensor.to_numpy())
    elif n.op in ("Identity", "StopGradient"):
        v = _np_eval(im, f, ins[0], env, sw_to_merge, memo)
    elif n.op == "Cast":
        x = _np_eval(im, f, ins[0], env, sw_to_merge, memo)
        v = None if x is None else np.asarray(
            x, dtype_to_numpy(n.attrs["DstT"].type))
    elif n.op in _SIM_UNOPS:
        x = _np_eval(im, f, ins[0], env, sw_to_merge, memo)
        v = None if x is None else _SIM_UNOPS[n.op](x)
    elif n.op in _SIM_BINOPS and len(ins) == 2:
        xs = [_np_eval(im, f, i, env, sw_to_merge, memo) for i in ins]
        v = None if any(x is None for x in xs) \
            else _SIM_BINOPS[n.op](xs[0], xs[1])
    else:
        v = None
    memo[src] = v
    return v


def _static_trip_count(im, f, init_refs, cap=100_000, jit_cap=10_000):
    """Exact trip count when the loop condition is confined to integer/
    bool loop variables with host-foldable inits whose updates are
    themselves so confined (the counter idiom TF1 emits for dynamic_rnn
    and counted loops); None otherwise. Enables lowering onto forLoop, a
    loop of a fixed count, as the reference lowers it (its whileLoop is
    not reverse-mode differentiable there; the port's differentiates
    either).

    Resolution order: the affine `i += c; i < n` idiom closes
    analytically in O(1); irregular counters simulate in pure numpy on
    the host up to `cap`; only a cond cone with ops outside the numpy set
    falls back to running the cond subgraph on the CPU, capped at
    `jit_cap` calls (bounded import latency for exotic counters, at the
    cost of lowering 1e4..1e5-trip exotic loops onto whileLoop)."""
    inits = _cond_cone_inits(im, f, init_refs)
    if inits is None:
        return None

    trip = _affine_trip_count(im, f, init_refs)
    if trip is not None:
        return trip

    sw_to_merge = {sw.name: mn for mn, sw in f.switches.items()}
    state = {mn: v for mn, v in inits}
    trips = 0
    while trips <= cap:
        memo = {}
        c = _np_eval(im, f, f.loop_cond.inputs[0], state, sw_to_merge,
                     memo)
        if c is None:
            break  # unsupported op: jitted fallback below
        if not bool(np.asarray(c).reshape(())):
            return trips
        new_state = {}
        for mn in state:
            v = _np_eval(im, f, f.next_iters[mn], state, sw_to_merge,
                         memo)
            if v is None:
                break
            new_state[mn] = np.asarray(v)
        if len(new_state) != len(state):
            break
        state = new_state
        trips += 1
    else:
        return None  # numpy sim ran out of cap: not statically counted

    ph = {mn: (tuple(v.shape), v.dtype) for mn, v in inits}
    try:
        # on the CPU: each call's answer goes back to the host
        sub, _, _ = _subgraph_from_nodes(
            im, f, [f.loop_cond.inputs[0]] +
            [f.next_iters[mn] for mn, _ in inits], ph,
            f"v1 frame {f.name!r} trip-count simulation", device="cpu")
    except TFImportError:
        return None
    fn = sub.callable()
    state = [torch.from_numpy(np.array(v)) for _, v in inits]
    trips = 0
    with torch.inference_mode():
        while trips <= jit_cap:
            outs = fn(*state)
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            if not bool(outs[0].reshape(())):
                return trips
            state = list(outs[1:])
            trips += 1
    return None


@handler("_V1While")
def _h_v1_while(im, node):
    f = node._frame
    n_loop = node._n_loop
    init_refs = list(node.inputs[:n_loop])
    inv_refs = list(node.inputs[n_loop:])
    what = f"v1 while frame {f.name!r}"

    # ALL loop-invariant Enters become pass-through loop variables wired
    # to the parent-graph tensor (weights stay parent vars, so
    # makeTrainable + autodiff reach them through the loop; also the
    # only sound choice for non-foldable invariants such as an input
    # TensorArray buffer scattered from a placeholder)
    promoted = list(zip(f.const_enters, inv_refs))
    ph_partial = {e.name: (im.shape(r), im.dtype(r)) for e, r in promoted}
    for m, ref in zip(f.merges, init_refs):
        src, idx = _ref(ref)
        if f"{src}:{idx}" in im.shapes:
            ph_partial[m.name] = (im.shape(ref), im.dtype(ref))
    for m, ref in zip(f.merges, init_refs):
        _resolve_ta_flow_init(im, f, m, ref, ph_partial, what)

    ph_map = {}
    for m, ref in zip(f.merges, init_refs):
        ph_map[m.name] = (im.shape(ref), im.dtype(ref))
    for e, r in promoted:
        ph_map[e.name] = (im.shape(r), im.dtype(r))

    body_targets = [f.next_iters[m.name] for m in f.merges] + \
        [e.name for e, _ in promoted]
    in_refs = init_refs + [r for _, r in promoted]
    in_vars = [im.var(r) for r in in_refs]
    n = len(in_vars)

    trip = _static_trip_count(im, f, init_refs)
    if trip is not None:
        # exact trip count: run the body trip times under forLoop (the
        # body subgraph gets a leading, unused iteration placeholder to
        # match the forLoop body signature body(i, *vars))
        iter_ph = f"{node.name}__iter"
        ph_body = {iter_ph: ((), np.dtype(np.int32))}
        ph_body.update(ph_map)
        body, body_shapes, body_dtypes = _subgraph_from_nodes(
            im, f, body_targets, ph_body, what + " body")
        attrs = {"n": trip, "body_graph": body,
                 "body_fn": body.callable()}
        res = im.sd._op("forLoop", in_vars, attrs, node.name,
                        n_out=n if n > 1 else 1)
    else:
        cond, _, _ = _subgraph_from_nodes(
            im, f, [f.loop_cond.inputs[0]], ph_map, what + " cond")
        body, body_shapes, body_dtypes = _subgraph_from_nodes(
            im, f, body_targets, ph_map, what + " body")
        attrs = {"cond_graph": cond,
                 "cond_fn": cond.callable(squeeze=True),
                 "body_graph": body, "body_fn": body.callable()}
        res = im.sd._op("whileLoop", in_vars, attrs, node.name,
                        n_out=n if n > 1 else 1)
    outs = res if isinstance(res, tuple) else (res,)
    for i, v in enumerate(outs):
        im.bind(node.name, v, body_shapes[i], body_dtypes[i], out_idx=i)


# ---------------------------------------------------------------------------
# TensorArrayV3 family: a TF1 TensorArray lowers to a plain [size, ...]
# buffer tensor carried on the array's "flow" edge (reads are gathers,
# writes are row scatter-updates). The resource handle output (:0) is
# never materialized — every consumer also receives the flow, which
# identifies the buffer.
# ---------------------------------------------------------------------------

def _ta_resolve(im, handle_ref, what):
    src, idx = _ref(handle_ref)
    while True:
        nd = im.nodes.get(src)
        if nd is not None and nd.op == "Identity" and idx == 0:
            src, idx = _ref(nd.inputs[0])
            continue
        break
    if nd is None or nd.op != "TensorArrayV3" or idx != 0 or \
            src not in im.tensor_arrays:
        raise TFImportError(
            f"{what}: handle input does not trace to a TensorArrayV3 "
            "node in the outer graph")
    return src


def _bind_ta_zeros(im, ta, elem, dtype_hint, out_idx=1):
    """The single place the lazy zeros buffer for an unwritten
    TensorArray gets created and bound at the TA's flow output."""
    info = im.tensor_arrays[ta]
    dt = info["dtype"] or dtype_hint or np.dtype(np.float32)
    size = info["size"]
    if info["elem"] is None and elem is None:
        raise TFImportError(
            f"TensorArray {ta!r} is read before any write and has no "
            "element_shape — declare element_shape on the TensorArrayV3")
    elem = tuple(info["elem"] if info["elem"] is not None else elem)
    v = im.sd.constant(f"{ta}__ta_zeros",
                       np.zeros((size,) + elem, dt))
    im.bind(ta, v, (size,) + elem, dt, out_idx=out_idx)


def _ta_buffer_ref(im, flow_ref, ta, elem, dtype, what):
    """Resolve the TA's current buffer; on first use of an unbound flow
    bind a zeros buffer there (lazily — an eagerly bound zeros constant
    would serialize buffer-size dead weight whenever the first op
    overwrites the whole array)."""
    try:
        im.shape(flow_ref)
        return flow_ref
    except TFImportError:
        pass
    src, idx = _ref(flow_ref)
    info = im.tensor_arrays.get(ta)
    if info is None or src != ta:
        raise TFImportError(
            f"{what}: flow input {flow_ref!r} has no producer and does "
            "not trace to a TensorArrayV3 flow output")
    _bind_ta_zeros(im, ta, elem, dtype, out_idx=idx)
    return flow_ref


@handler("TensorArrayV3")
def _h_tensor_array_v3(im, node):
    dyn = node.attrs.get("dynamic_size")
    if dyn is not None and dyn.b:
        raise TFImportError(
            f"node {node.name!r}: TensorArrayV3 with dynamic_size=True "
            "has no static-shape lowering (the buffers are fixed-size) "
            "— re-export with a fixed-size TensorArray")
    ins = im.data_inputs(node)
    size = int(im.need_const(ins[0], "TensorArray size"))
    dt = dtype_to_numpy(node.attrs["dtype"].type) \
        if "dtype" in node.attrs else None
    elem = None
    es = node.attrs.get("element_shape")
    if es is not None and es.shape is not None and \
            not es.shape.unknown_rank:
        dims = [int(d) for d in es.shape.dims]
        if dims and all(d >= 0 for d in dims):
            elem = tuple(dims)
    im.tensor_arrays[node.name] = {"size": size, "dtype": dt,
                                   "elem": elem}
    # the flow output (:1) binds LAZILY on first read/loop use — an
    # eager zeros constant would serialize buffer-size dead weight for
    # the common scatter-everything idiom, which never reads it. The
    # :0 resource handle is deliberately left unbound.


@handler("TensorArrayScatterV3")
def _h_ta_scatter_outer(im, node):
    what = f"node {node.name!r} ({node.op})"
    ins = im.data_inputs(node)  # handle, indices, value, flow
    ta = _ta_resolve(im, ins[0], what)
    info = im.tensor_arrays[ta]
    idxs = im.const(ins[1])  # None: computed indices, general lowering
    vshape, vd = im.shape(ins[2]), im.dtype(ins[2])
    size = info["size"]
    if idxs is not None and vshape and vshape[0] == size and \
            np.array_equal(np.asarray(idxs).ravel(), np.arange(size)):
        im.emit(node, "identity", [ins[2]])  # buffer = value
        return
    flow = _ta_buffer_ref(im, ins[3], ta, tuple(vshape[1:]), vd, what)
    im.emit(node, "scatterUpdate", [flow, ins[1], ins[2]], {})


@handler("TensorArrayWriteV3")
def _h_ta_write_outer(im, node):
    what = f"node {node.name!r} ({node.op})"
    ins = im.data_inputs(node)  # handle, index, value, flow
    ta = _ta_resolve(im, ins[0], what)
    vshape, vd = im.shape(ins[2]), im.dtype(ins[2])
    flow = _ta_buffer_ref(im, ins[3], ta, vshape, vd, what)
    im.emit(node, "scatterUpdate", [flow, ins[1], ins[2]], {})


@handler("TensorArrayGatherV3")
def _h_ta_gather_outer(im, node):
    what = f"node {node.name!r} ({node.op})"
    ins = im.data_inputs(node)  # handle, indices, flow
    ta = _ta_resolve(im, ins[0], what)
    info = im.tensor_arrays[ta]
    idxs = im.const(ins[1])  # None: computed indices, general lowering
    flow = _ta_buffer_ref(im, ins[2], ta, None, None, what)
    fshape = im.shape(flow)
    if idxs is not None and fshape and fshape[0] == info["size"] and \
            np.array_equal(np.asarray(idxs).ravel(),
                           np.arange(info["size"])):
        im.emit(node, "identity", [flow])
        return
    im.emit(node, "gather", [flow, ins[1]], {"axis": 0})


@handler("TensorArrayReadV3")
def _h_ta_read_outer(im, node):
    what = f"node {node.name!r} ({node.op})"
    ins = im.data_inputs(node)  # handle, index, flow
    ta = _ta_resolve(im, ins[0], what)
    flow = _ta_buffer_ref(im, ins[2], ta, None, None, what)
    im.emit(node, "gather", [flow, ins[1]], {"axis": 0})


@handler("TensorArraySizeV3")
def _h_ta_size_outer(im, node):
    ins = im.data_inputs(node)
    ta = _ta_resolve(im, ins[0], f"node {node.name!r} ({node.op})")
    v = im.sd.constant(node.name,
                       np.asarray(im.tensor_arrays[ta]["size"], np.int32))
    im.bind(node.name, v, (), np.int32)


@handler("TensorArrayCloseV3")
def _h_ta_close(im, node):
    pass  # resource cleanup: nothing to materialize


@handler("_TARead", "_TAGather")
def _h_ta_read_interior(im, node):
    im.emit(node, "gather", node.inputs, {"axis": 0})


@handler("_TAWrite")
def _h_ta_write_interior(im, node):
    im.emit(node, "scatterUpdate", node.inputs, {})


@handler("_TASize")
def _h_ta_size_interior(im, node):
    t = im.shape(node.inputs[0])[0]
    v = im.sd.constant(node.name, np.asarray(t, np.int32))
    im.bind(node.name, v, (), np.int32)


@handler("ResizeBilinear", "ResizeNearestNeighbor", "ResizeBicubic",
         "ResizeArea")
def _h_resize(im, node):
    """TF resize ops are NHWC; route through the NCHW imageResize op via
    permutes (same pattern as Conv2D).

    Sampling semantics: imageResize samples at half-pixel centres (TF2,
    half_pixel_centers=True), as the reference's jax.image.resize.
    align_corners=True is rejected; graphs with the TF1-legacy default
    (half_pixel_centers absent/False) import with a warning — interior
    samples can shift by up to half a source pixel vs TF1. 'cubic' is
    Keys a=-0.5 where TF1 ResizeBicubic uses a=-0.75 (documented
    divergence)."""
    ac = node.attrs.get("align_corners")
    if ac is not None and ac.b:
        raise TFImportError(
            f"node {node.name!r} ({node.op}): align_corners=True has no "
            f"imageResize equivalent — re-export with "
            f"half_pixel_centers=True")
    hpc = node.attrs.get("half_pixel_centers")
    if node.op != "ResizeArea" and (hpc is None or not hpc.b):
        if im.strict:
            raise TFImportError(
                f"node {node.name!r} ({node.op}): TF1-legacy sampling "
                f"(half_pixel_centers=False) rejected under "
                f"strict=True — interior samples would shift by up to "
                f"half a source pixel; re-export with "
                f"half_pixel_centers=True or import with strict=False")
        warnings.warn(
            f"TF import: {node.op} node {node.name!r} uses TF1-legacy "
            f"sampling (half_pixel_centers=False); imported with "
            f"half-pixel-center semantics — interior samples may shift "
            f"by up to half a source pixel", stacklevel=2)
    ins = im.data_inputs(node)
    size = im.need_const(ins[1], "resize size")
    oh, ow = int(size[0]), int(size[1])
    method = {"ResizeBilinear": "bilinear",
              "ResizeNearestNeighbor": "nearest",
              "ResizeBicubic": "cubic",
              "ResizeArea": "area"}[node.op]
    x = _permute(im, node, ins[0], (0, 3, 1, 2), "__nchw")
    im.emit(node, "imageResize", [x],
            {"height": oh, "width": ow, "method": method},
            out_name=f"{node.name}__resize")
    _permute(im, node, f"{node.name}__resize:0", (0, 2, 3, 1), "",
             out_name=node.name)


@handler("NonMaxSuppressionV3", "NonMaxSuppressionV4")
def _h_nms(im, node):
    """STATIC-SHAPE deviation from TF (documented): TF returns a
    dynamic-length [num_selected] index tensor; the graph's shapes are
    fixed, so the imported op returns [maxOutputSize] padded with -1. V4
    consumers get the real `valid_outputs` count as output :1 and must
    mask before gathering (a -1 fed to gather wraps to the last row);
    V3 consumers should count idx >= 0 themselves."""
    ins = im.data_inputs(node)
    max_out = int(im.need_const(ins[2], "NMS max_output_size"))
    iou = float(im.need_const(ins[3], "NMS iou_threshold"))
    attrs = {"maxOutputSize": max_out, "iouThreshold": iou}
    if len(ins) > 4:
        attrs["scoreThreshold"] = float(
            im.need_const(ins[4], "NMS score_threshold"))
    idx = im.emit(node, "nonMaxSuppression", ins[:2], attrs)
    if node.op == "NonMaxSuppressionV4":
        # second output: valid_outputs = count of non-padding indices
        zero = im.sd.constant(f"{node.name}__zero", np.int32(0))
        ge = im.sd._op("gte", [idx, zero], {}, f"{node.name}__ge")
        cnt = im.sd._op("sum", [ge], {}, f"{node.name}__validsum")
        valid = im.sd._op("cast", [cnt], {"dtype": "int32"},
                          f"{node.name}__valid")
        im.bind(node.name, valid, (), np.int32, out_idx=1)


def _check_padding(node, pad):
    """SAME/VALID only: TF's EXPLICIT padding would otherwise silently
    compute a VALID conv."""
    if pad not in ("SAME", "VALID"):
        raise TFImportError(
            f"node {node.name!r} ({node.op}): padding={pad!r} is not "
            f"supported (SAME/VALID only)")


@handler("DepthwiseConv2dNative")
def _h_depthwise_conv2d(im, node):
    """TF depthwise kernel [kH, kW, inC, mult] -> our
    [mult, inC, kH, kW] (MobileNet-class graphs)."""
    ins = im.data_inputs(node)
    fmt = node.attrs.get("data_format")
    nhwc = fmt is None or fmt.s in (b"NHWC", None)
    strides = [int(s) for s in node.attrs["strides"].list["i"]]
    pad = node.attrs["padding"].s.decode()
    _check_padding(node, pad)
    dil = [int(d) for d in node.attrs["dilations"].list["i"]] \
        if "dilations" in node.attrs else [1, 1, 1, 1]
    x_ref = ins[0]
    if nhwc:
        x_ref = _permute(im, node, ins[0], (0, 3, 1, 2), "__nchw")
        s_hw, d_hw = (strides[1], strides[2]), (dil[1], dil[2])
    else:
        s_hw, d_hw = (strides[2], strides[3]), (dil[2], dil[3])
    w_ref = _permute(im, node, ins[1], (3, 2, 0, 1), "__mihw")
    attrs = {"strides": s_hw, "dilation": d_hw,
             "sameMode": pad == "SAME", "padding": (0, 0)}
    out_name = node.name if not nhwc else f"{node.name}__conv"
    im.emit(node, "depthwiseConv2d", [x_ref, w_ref], attrs,
            out_name=out_name)
    if nhwc:
        _permute(im, node, f"{out_name}:0", (0, 2, 3, 1), "", node.name)


@handler("Conv3D")
def _h_conv3d(im, node):
    """TF NDHWC conv3d -> our NCDHW op via permutes; kernel DHWIO ->
    OIDHW."""
    ins = im.data_inputs(node)
    fmt = node.attrs.get("data_format")
    if fmt is not None and fmt.s not in (b"NDHWC", None):
        raise TFImportError(
            f"Conv3D node {node.name!r}: only NDHWC data_format is "
            f"supported, got {fmt.s!r}")
    strides = [int(s) for s in node.attrs["strides"].list["i"]]
    pad = node.attrs["padding"].s.decode()
    _check_padding(node, pad)
    dil = [int(d) for d in node.attrs["dilations"].list["i"]] \
        if "dilations" in node.attrs else [1, 1, 1, 1, 1]
    x_ref = _permute(im, node, ins[0], (0, 4, 1, 2, 3), "__ncdhw")
    w_ref = _permute(im, node, ins[1], (4, 3, 0, 1, 2), "__oidhw")
    attrs = {"strides": tuple(strides[1:4]),
             "dilation": tuple(dil[1:4]), "sameMode": pad == "SAME",
             "padding": (0, 0, 0)}
    im.emit(node, "conv3d", [x_ref, w_ref], attrs,
            out_name=f"{node.name}__conv")
    _permute(im, node, f"{node.name}__conv:0", (0, 2, 3, 4, 1), "",
             node.name)


@handler("MaxPool3D", "AvgPool3D")
def _h_pool3d(im, node):
    ins = im.data_inputs(node)
    fmt = node.attrs.get("data_format")
    if fmt is not None and fmt.s not in (b"NDHWC", None):
        raise TFImportError(
            f"{node.op} node {node.name!r}: only NDHWC data_format is "
            f"supported, got {fmt.s!r}")
    ksize = [int(k) for k in node.attrs["ksize"].list["i"]]
    strides = [int(s) for s in node.attrs["strides"].list["i"]]
    pad = node.attrs["padding"].s.decode()
    _check_padding(node, pad)
    x_ref = _permute(im, node, ins[0], (0, 4, 1, 2, 3), "__ncdhw")
    fn = "maxPooling3d" if node.op == "MaxPool3D" else "avgPooling3d"
    attrs = {"kernel": tuple(ksize[1:4]), "strides": tuple(strides[1:4]),
             "sameMode": pad == "SAME", "padding": (0, 0, 0)}
    im.emit(node, fn, [x_ref], attrs, out_name=f"{node.name}__pool")
    _permute(im, node, f"{node.name}__pool:0", (0, 2, 3, 4, 1), "",
             node.name)


# ---------------------------------------------------------------------------
# image, detection, loss and sequence handlers
# ---------------------------------------------------------------------------

@handler("SparseSoftmaxCrossEntropyWithLogits")
def _h_sparse_softmax_ce(im, node):
    """TF op with TWO outputs: per-example loss [B] and backprop
    [B, C] (softmax(logits) - onehot(labels))."""
    im.emit(node, "sparseSoftmaxCrossEntropyGrad", im.data_inputs(node))


@handler("MirrorPad")
def _h_mirror_pad(im, node):
    ins = im.data_inputs(node)
    pads = im.need_const(ins[1], "MirrorPad paddings")
    mode = node.attrs.get("mode")
    mode = (mode.s.decode() if mode is not None and
            isinstance(mode.s, bytes) else "REFLECT")
    im.emit(node, "mirrorPad", [ins[0]],
            {"paddings": tuple(map(tuple, np.asarray(pads).tolist())),
             "mode": mode})


@handler("ReverseSequence")
def _h_reverse_sequence(im, node):
    ins = im.data_inputs(node)
    im.emit(node, "reverseSequence", [ins[0], ins[1]],
            {"seqAxis": int(node.attrs["seq_dim"].i),
             "batchAxis": int(node.attrs.get("batch_dim").i
                              if "batch_dim" in node.attrs else 0)})


@handler("LRN")
def _h_lrn(im, node):
    # TF LRN is NHWC with depth_radius; our op is NCHW with full depth
    ins = im.data_inputs(node)
    r = int(node.attrs["depth_radius"].i) \
        if "depth_radius" in node.attrs else 5
    getf = lambda k, d: (node.attrs[k].f  # noqa: E731
                         if k in node.attrs else d)
    x = _permute(im, node, ins[0], (0, 3, 1, 2), "__nchw")
    im.emit(node, "localResponseNormalization", [x],
            {"depth": r, "bias": getf("bias", 1.0),
             "alpha": getf("alpha", 1.0), "beta": getf("beta", 0.5)},
            out_name=f"{node.name}__lrn")
    _permute(im, node, f"{node.name}__lrn:0", (0, 2, 3, 1), "",
             out_name=node.name)


@handler("RGBToHSV")
def _h_rgb_to_hsv(im, node):
    im.emit(node, "rgbToHsv", im.data_inputs(node))


@handler("HSVToRGB")
def _h_hsv_to_rgb(im, node):
    im.emit(node, "hsvToRgb", im.data_inputs(node))


@handler("AdjustContrastv2")
def _h_adjust_contrast(im, node):
    ins = im.data_inputs(node)
    f = float(im.need_const(ins[1], "AdjustContrastv2 factor"))
    im.emit(node, "adjustContrastV2", [ins[0]], {"factor": f})


@handler("AdjustHue")
def _h_adjust_hue(im, node):
    ins = im.data_inputs(node)
    d = float(im.need_const(ins[1], "AdjustHue delta"))
    im.emit(node, "adjustHue", [ins[0]], {"delta": d})


@handler("AdjustSaturation")
def _h_adjust_saturation(im, node):
    ins = im.data_inputs(node)
    f = float(im.need_const(ins[1], "AdjustSaturation scale"))
    im.emit(node, "adjustSaturation", [ins[0]], {"factor": f})


@handler("Cross")
def _h_cross(im, node):
    im.emit(node, "cross", im.data_inputs(node))


@handler("Rint")
def _h_rint(im, node):
    im.emit(node, "rint", im.data_inputs(node))


@handler("Erfinv")
def _h_erfinv(im, node):
    im.emit(node, "erfinv", im.data_inputs(node))


@handler("HistogramFixedWidth")
def _h_histogram(im, node):
    ins = im.data_inputs(node)
    vr = im.need_const(ins[1], "HistogramFixedWidth value_range")
    nbins = int(im.need_const(ins[2], "HistogramFixedWidth nbins")) \
        if len(ins) > 2 else 100
    im.emit(node, "histogramFixedWidth", [ins[0]],
            {"range_lo": float(vr[0]), "range_hi": float(vr[1]),
             "nbins": nbins})


@handler("ScatterNd")
def _h_scatter_nd(im, node):
    ins = im.data_inputs(node)
    shape = im.need_const(ins[2], "ScatterNd shape")
    im.emit(node, "scatterNd", [ins[0], ins[1]],
            {"shape": tuple(int(s) for s in np.asarray(shape))})


@handler("Dilation2D")
def _h_dilation2d(im, node):
    ins = im.data_inputs(node)
    strides = [int(v) for v in node.attrs["strides"].ints] \
        if "strides" in node.attrs else [1, 1, 1, 1]
    rates = [int(v) for v in node.attrs["rates"].ints] \
        if "rates" in node.attrs else [1, 1, 1, 1]
    if any(r != 1 for r in rates):
        raise TFImportError(
            f"node {node.name!r} (Dilation2D): atrous rates {rates} "
            "are unsupported (only [1,1,1,1]) — importing would "
            "silently compute a dense dilation")
    pad = node.attrs.get("padding")
    same = pad is None or pad.s == b"SAME"
    # TF NHWC x [N,H,W,C], filter [kH,kW,C] -> our NCHW op
    x = _permute(im, node, ins[0], (0, 3, 1, 2), "__nchw")
    w = _permute(im, node, ins[1], (2, 0, 1), "__chw")
    im.emit(node, "dilation2d", [x, w],
            {"sH": strides[1], "sW": strides[2], "sameMode": same},
            out_name=f"{node.name}__dil")
    _permute(im, node, f"{node.name}__dil:0", (0, 2, 3, 1), "",
             out_name=node.name)
