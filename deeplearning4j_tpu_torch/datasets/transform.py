"""DataVec transform engine: Schema + TransformProcess.

Copied from ``deeplearning4j_tpu/datasets/transform.py`` (pure Python on
the host; the port keeps its own copy).

Reference capability: `datavec-api` org.datavec.api.transform —
`Schema`/`Schema.Builder` (typed column metadata) and
`TransformProcess`/`TransformProcess.Builder` (a declarative pipeline of
column transforms executed record-by-record), SURVEY.md §2.4. The
reference executes these on
Spark/local executors; here execution is plain host-side Python over
record lists (ETL is host work — the device path starts at the
DataSet), and the output schema is derived eagerly like the reference's
`TransformProcess.getFinalSchema()`.
"""

from __future__ import annotations

import math

from deeplearning4j_tpu_torch.datasets.records import RecordReader


class ColumnType:
    String = "String"
    Integer = "Integer"
    Long = "Long"
    Double = "Double"
    Float = "Float"
    Categorical = "Categorical"
    Time = "Time"


class Schema:
    """Typed column metadata (reference: org.datavec.api.transform.schema
    .Schema)."""

    def __init__(self, columns):
        # columns: list of (name, type, meta) — meta holds e.g. category
        # state for Categorical columns
        self.columns = list(columns)

    def getColumnNames(self):
        return [c[0] for c in self.columns]

    def getColumnTypes(self):
        return [c[1] for c in self.columns]

    def numColumns(self):
        return len(self.columns)

    def getIndexOfColumn(self, name):
        for i, c in enumerate(self.columns):
            if c[0] == name:
                return i
        raise ValueError(f"no column {name!r} in schema "
                         f"{self.getColumnNames()}")

    def getMetaData(self, name):
        return self.columns[self.getIndexOfColumn(name)][2]

    def __repr__(self):
        cols = ", ".join(f"{n}:{t}" for n, t, _ in self.columns)
        return f"Schema({cols})"

    class Builder:
        def __init__(self):
            self._cols = []

        def addColumnString(self, name):
            self._cols.append((name, ColumnType.String, {}))
            return self

        def addColumnInteger(self, name, minValue=None, maxValue=None):
            self._cols.append((name, ColumnType.Integer,
                               {"min": minValue, "max": maxValue}))
            return self

        def addColumnLong(self, name):
            self._cols.append((name, ColumnType.Long, {}))
            return self

        def addColumnDouble(self, name, minValue=None, maxValue=None):
            self._cols.append((name, ColumnType.Double,
                               {"min": minValue, "max": maxValue}))
            return self

        def addColumnFloat(self, name):
            self._cols.append((name, ColumnType.Float, {}))
            return self

        def addColumnsDouble(self, *names):
            for n in names:
                self.addColumnDouble(n)
            return self

        def addColumnCategorical(self, name, *categories):
            if len(categories) == 1 and isinstance(categories[0],
                                                   (list, tuple)):
                categories = tuple(categories[0])
            self._cols.append((name, ColumnType.Categorical,
                               {"categories": list(categories)}))
            return self

        def build(self) -> "Schema":
            return Schema(self._cols)


# ---------------------------------------------------------------------------
# conditions (reference: org.datavec.api.transform.condition)
# ---------------------------------------------------------------------------

class ConditionOp:
    LessThan = "LessThan"
    LessOrEqual = "LessOrEqual"
    GreaterThan = "GreaterThan"
    GreaterOrEqual = "GreaterOrEqual"
    Equal = "Equal"
    NotEqual = "NotEqual"
    InSet = "InSet"
    NotInSet = "NotInSet"

    _FNS = {
        "LessThan": lambda v, t: v < t,
        "LessOrEqual": lambda v, t: v <= t,
        "GreaterThan": lambda v, t: v > t,
        "GreaterOrEqual": lambda v, t: v >= t,
        "Equal": lambda v, t: v == t,
        "NotEqual": lambda v, t: v != t,
        "InSet": lambda v, t: v in t,
        "NotInSet": lambda v, t: v not in t,
    }


class _SchemaMemo:
    """Per-schema cached computation: rec_fns run once per RECORD, but
    their schema is fixed per step — cache index lookups on schema id
    (schemas live for the TransformProcess lifetime in self._schemas)."""

    def __init__(self, compute):
        self.compute = compute
        self._cache = {}

    def __call__(self, schema):
        # the schema itself is kept in the entry: a bare id() key could
        # alias a new Schema allocated at a freed address
        entry = self._cache.get(id(schema))
        if entry is None or entry[0] is not schema:
            entry = (schema, self.compute(schema))
            self._cache[id(schema)] = entry
        return entry[1]


class _Condition:
    def applies(self, schema, record):
        raise NotImplementedError


class DoubleColumnCondition(_Condition):
    def __init__(self, column, op, value):
        self.column, self.op, self.value = column, op, value
        self._idx = _SchemaMemo(lambda s: s.getIndexOfColumn(self.column))

    def applies(self, schema, record):
        v = float(record[self._idx(schema)])
        return ConditionOp._FNS[self.op](v, self.value)


class CategoricalColumnCondition(_Condition):
    def __init__(self, column, op, value):
        self.column, self.op, self.value = column, op, value
        self._idx = _SchemaMemo(lambda s: s.getIndexOfColumn(self.column))

    def applies(self, schema, record):
        v = str(record[self._idx(schema)])
        return ConditionOp._FNS[self.op](v, self.value)


class StringColumnCondition(CategoricalColumnCondition):
    pass


# ---------------------------------------------------------------------------
# math ops
# ---------------------------------------------------------------------------

class MathOp:
    Add = "Add"
    Subtract = "Subtract"
    Multiply = "Multiply"
    Divide = "Divide"
    Modulus = "Modulus"
    ReverseSubtract = "ReverseSubtract"
    ReverseDivide = "ReverseDivide"
    ScalarMin = "ScalarMin"
    ScalarMax = "ScalarMax"

    _FNS = {
        "Add": lambda v, s: v + s,
        "Subtract": lambda v, s: v - s,
        "Multiply": lambda v, s: v * s,
        "Divide": lambda v, s: v / s,
        "Modulus": lambda v, s: v % s,
        "ReverseSubtract": lambda v, s: s - v,
        "ReverseDivide": lambda v, s: s / v,
        "ScalarMin": lambda v, s: min(v, s),
        "ScalarMax": lambda v, s: max(v, s),
    }


class MathFunction:
    ABS = "ABS"
    CEIL = "CEIL"
    FLOOR = "FLOOR"
    EXP = "EXP"
    LOG = "LOG"
    LOG2 = "LOG2"
    SQRT = "SQRT"
    SIN = "SIN"
    COS = "COS"
    TAN = "TAN"
    SIGNUM = "SIGNUM"

    _FNS = {
        "ABS": abs, "CEIL": math.ceil, "FLOOR": math.floor,
        "EXP": math.exp, "LOG": math.log, "LOG2": math.log2,
        "SQRT": math.sqrt, "SIN": math.sin, "COS": math.cos,
        "TAN": math.tan, "SIGNUM": lambda v: (v > 0) - (v < 0),
    }


# ---------------------------------------------------------------------------
# TransformProcess
# ---------------------------------------------------------------------------

class TransformProcess:
    """A sequence of (schema -> schema, record -> record|None) steps."""

    def __init__(self, initial_schema, steps):
        self.initialSchema = initial_schema
        self.steps = steps  # list of (name, schema_fn, record_fn)
        # derive intermediate schemas eagerly (getFinalSchema parity)
        self._schemas = [initial_schema]
        for _name, schema_fn, _rec in steps:
            self._schemas.append(schema_fn(self._schemas[-1]))

    def getFinalSchema(self) -> Schema:
        return self._schemas[-1]

    def execute(self, records):
        """Transform a list of records; filtered records are dropped."""
        out = []
        for rec in records:
            r = self.executeRecord(rec)
            if r is not None:
                out.append(r)
        return out

    def executeRecord(self, record):
        r = list(record)
        for (name, _schema_fn, rec_fn), schema in zip(self.steps,
                                                      self._schemas):
            r = rec_fn(schema, r)
            if r is None:
                return None
        return r

    class Builder:
        def __init__(self, schema: Schema):
            self.schema = schema
            self.steps = []

        def _add(self, name, schema_fn, rec_fn):
            self.steps.append((name, schema_fn, rec_fn))
            return self

        # -- column removal / selection ---------------------------------

        def removeColumns(self, *names):
            names = set(names)

            def schema_fn(s):
                return Schema([c for c in s.columns if c[0] not in names])

            keep_memo = _SchemaMemo(lambda s: [
                i for i, c in enumerate(s.columns) if c[0] not in names])

            def rec_fn(s, r):
                return [r[i] for i in keep_memo(s)]

            return self._add(f"removeColumns{sorted(names)}", schema_fn,
                             rec_fn)

        def removeAllColumnsExceptFor(self, *names):
            keep_names = set(names)

            def schema_fn(s):
                return Schema([c for c in s.columns if c[0] in keep_names])

            keep_memo = _SchemaMemo(lambda s: [
                i for i, c in enumerate(s.columns) if c[0] in keep_names])

            def rec_fn(s, r):
                return [r[i] for i in keep_memo(s)]

            return self._add("removeAllExcept", schema_fn, rec_fn)

        def reorderColumns(self, *names):
            def schema_fn(s):
                rest = [c for c in s.columns if c[0] not in names]
                picked = [s.columns[s.getIndexOfColumn(n)] for n in names]
                return Schema(picked + rest)

            order_memo = _SchemaMemo(lambda s: (
                lambda idx: idx + [i for i in range(s.numColumns())
                                   if i not in set(idx)])(
                [s.getIndexOfColumn(n) for n in names]))

            def rec_fn(s, r):
                return [r[i] for i in order_memo(s)]

            return self._add("reorder", schema_fn, rec_fn)

        def renameColumn(self, old, new):
            def schema_fn(s):
                return Schema([(new if c[0] == old else c[0], c[1], c[2])
                               for c in s.columns])

            def rec_fn(s, r):
                return r

            return self._add(f"rename {old}->{new}", schema_fn, rec_fn)

        # -- filters -----------------------------------------------------

        def filter(self, condition: _Condition):
            """Drop records MATCHING the condition (reference
            ConditionFilter semantics: removes examples where the
            condition applies)."""

            def schema_fn(s):
                return s

            def rec_fn(s, r):
                return None if condition.applies(s, r) else r

            return self._add("filter", schema_fn, rec_fn)

        # -- categorical -------------------------------------------------

        def categoricalToInteger(self, *names):
            names_set = set(names)

            def schema_fn(s):
                return Schema([
                    (c[0], ColumnType.Integer if c[0] in names_set
                     else c[1], c[2]) for c in s.columns])

            cols_memo = _SchemaMemo(lambda s: [
                (s.getIndexOfColumn(n), s.getMetaData(n)["categories"])
                for n in names_set])

            def rec_fn(s, r):
                out = list(r)
                for i, cats in cols_memo(s):
                    out[i] = cats.index(str(r[i]))
                return out

            return self._add("catToInt", schema_fn, rec_fn)

        def categoricalToOneHot(self, *names):
            def schema_fn(s):
                cols = []
                for c in s.columns:
                    if c[0] in names:
                        for cat in c[2]["categories"]:
                            cols.append((f"{c[0]}[{cat}]",
                                         ColumnType.Integer, {}))
                    else:
                        cols.append(c)
                return Schema(cols)

            def rec_fn(s, r):
                out = []
                for i, c in enumerate(s.columns):
                    if c[0] in names:
                        cats = c[2]["categories"]
                        onehot = [0] * len(cats)
                        onehot[cats.index(str(r[i]))] = 1
                        out.extend(onehot)
                    else:
                        out.append(r[i])
                return out

            return self._add("catToOneHot", schema_fn, rec_fn)

        def integerToOneHot(self, name, minValue, maxValue):
            width = maxValue - minValue + 1

            def schema_fn(s):
                cols = []
                for c in s.columns:
                    if c[0] == name:
                        for v in range(minValue, maxValue + 1):
                            cols.append((f"{name}[{v}]",
                                         ColumnType.Integer, {}))
                    else:
                        cols.append(c)
                return Schema(cols)

            idx_memo = _SchemaMemo(lambda s: s.getIndexOfColumn(name))

            def rec_fn(s, r):
                i = idx_memo(s)
                v = int(r[i])
                if not minValue <= v <= maxValue:
                    raise ValueError(
                        f"integerToOneHot({name!r}): value {v} outside "
                        f"[{minValue}, {maxValue}]")
                onehot = [0] * width
                onehot[v - minValue] = 1
                return list(r[:i]) + onehot + list(r[i + 1:])

            return self._add("intToOneHot", schema_fn, rec_fn)

        def stringToCategorical(self, name, categories):
            cats = list(categories)

            def schema_fn(s):
                return Schema([
                    (c[0], ColumnType.Categorical, {"categories": cats})
                    if c[0] == name else c for c in s.columns])

            def rec_fn(s, r):
                return r

            return self._add("strToCat", schema_fn, rec_fn)

        # -- math --------------------------------------------------------

        def doubleMathOp(self, name, op, scalar):
            def schema_fn(s):
                return s

            idx_memo = _SchemaMemo(lambda s: s.getIndexOfColumn(name))

            def rec_fn(s, r):
                i = idx_memo(s)
                out = list(r)
                out[i] = MathOp._FNS[op](float(r[i]), scalar)
                return out

            return self._add(f"math {op}", schema_fn, rec_fn)

        integerMathOp = doubleMathOp

        def doubleMathFunction(self, name, fn):
            def schema_fn(s):
                return s

            idx_memo = _SchemaMemo(lambda s: s.getIndexOfColumn(name))

            def rec_fn(s, r):
                i = idx_memo(s)
                out = list(r)
                out[i] = MathFunction._FNS[fn](float(r[i]))
                return out

            return self._add(f"mathFn {fn}", schema_fn, rec_fn)

        def normalize(self, name, minValue, maxValue):
            """Min-max scale a column to [0,1] given known bounds."""
            span = maxValue - minValue

            def schema_fn(s):
                return s

            idx_memo = _SchemaMemo(lambda s: s.getIndexOfColumn(name))

            def rec_fn(s, r):
                i = idx_memo(s)
                out = list(r)
                out[i] = (float(r[i]) - minValue) / span
                return out

            return self._add("normalize", schema_fn, rec_fn)

        # -- strings -----------------------------------------------------

        def stringMapTransform(self, name, mapping: dict):
            def schema_fn(s):
                return s

            idx_memo = _SchemaMemo(lambda s: s.getIndexOfColumn(name))

            def rec_fn(s, r):
                i = idx_memo(s)
                out = list(r)
                out[i] = mapping.get(str(r[i]), r[i])
                return out

            return self._add("stringMap", schema_fn, rec_fn)

        def appendStringColumnTransform(self, name, toAppend):
            def schema_fn(s):
                return s

            idx_memo = _SchemaMemo(lambda s: s.getIndexOfColumn(name))

            def rec_fn(s, r):
                i = idx_memo(s)
                out = list(r)
                out[i] = str(r[i]) + toAppend
                return out

            return self._add("appendString", schema_fn, rec_fn)

        def conditionalReplaceValueTransform(self, name, new_value,
                                             condition: _Condition):
            def schema_fn(s):
                return s

            idx_memo = _SchemaMemo(lambda s: s.getIndexOfColumn(name))

            def rec_fn(s, r):
                out = list(r)
                if condition.applies(s, r):
                    out[idx_memo(s)] = new_value
                return out

            return self._add("condReplace", schema_fn, rec_fn)

        def transform(self, name, fn, schema_fn=None):
            """Escape hatch: custom record transform (record -> record)."""

            def sfn(s):
                return schema_fn(s) if schema_fn else s

            return self._add(name, sfn, lambda s, r: fn(s, r))

        def build(self) -> "TransformProcess":
            return TransformProcess(self.schema, self.steps)


class TransformProcessRecordReader(RecordReader):
    """Wrap a RecordReader with a TransformProcess (reference:
    org.datavec.api.records.reader.impl.transform
    .TransformProcessRecordReader). Filtered records are skipped."""

    def __init__(self, recordReader: RecordReader,
                 transformProcess: TransformProcess):
        self.reader = recordReader
        self.tp = transformProcess
        self._pending = None

    def initialize(self, split):
        self.reader.initialize(split)

    def _advance(self):
        while self._pending is None and self.reader.hasNext():
            rec = self.tp.executeRecord(self.reader.next())
            if rec is not None:
                self._pending = rec

    def hasNext(self):
        self._advance()
        return self._pending is not None

    def next(self):
        self._advance()
        if self._pending is None:
            raise StopIteration
        rec, self._pending = self._pending, None
        return rec

    def reset(self):
        self.reader.reset()
        self._pending = None
