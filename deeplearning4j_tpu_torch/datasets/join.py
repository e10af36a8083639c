"""Relational Join of two record sources.

Copied from ``deeplearning4j_tpu/datasets/join.py`` (pure Python on the
host; the port keeps its own copy).

Reference: org.datavec.api.transform.join.Join (SURVEY.md §2.4 transform
row — Schema/TransformProcess "map/filter/join"): a hash join on key
columns; output schema = left columns + right columns minus the right
key columns; Inner/LeftOuter/RightOuter/FullOuter types with None fill
for the missing side (the reference uses NullWritable)."""

from __future__ import annotations

from deeplearning4j_tpu_torch.datasets.transform import Schema


class JoinType:
    INNER = "Inner"
    LEFT_OUTER = "LeftOuter"
    RIGHT_OUTER = "RightOuter"
    FULL_OUTER = "FullOuter"


class Join:
    def __init__(self, joinType, leftSchema, rightSchema,
                 leftColumns, rightColumns):
        self.joinType = joinType
        self.leftSchema = leftSchema
        self.rightSchema = rightSchema
        self.leftColumns = list(leftColumns)
        self.rightColumns = list(rightColumns)
        if len(self.leftColumns) != len(self.rightColumns):
            raise ValueError(
                f"join key arity mismatch: {self.leftColumns} vs "
                f"{self.rightColumns}")
        for n in self.leftColumns:
            leftSchema.getIndexOfColumn(n)   # raises if absent
        for n in self.rightColumns:
            rightSchema.getIndexOfColumn(n)

    # -- schema -------------------------------------------------------------
    def getOutputSchema(self) -> Schema:
        rkeys = set(self.rightColumns)
        cols = list(self.leftSchema.columns)
        cols += [c for c in self.rightSchema.columns if c[0] not in rkeys]
        names = [c[0] for c in cols]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(
                f"joined schema has duplicate non-key columns {dupes} — "
                "rename them before joining")
        return Schema(cols)

    # -- execution ----------------------------------------------------------
    def execute(self, leftRecords, rightRecords):
        """Hash join; multiple matches per key produce the cross product
        (standard relational semantics)."""
        lk = [self.leftSchema.getIndexOfColumn(n)
              for n in self.leftColumns]
        rk = [self.rightSchema.getIndexOfColumn(n)
              for n in self.rightColumns]
        r_rest = [i for i in range(self.rightSchema.numColumns())
                  if i not in set(rk)]
        table = {}
        for rr in rightRecords:
            table.setdefault(tuple(rr[i] for i in rk), []).append(rr)
        out, matched_right = [], set()
        for lr in leftRecords:
            key = tuple(lr[i] for i in lk)
            hits = table.get(key)
            if hits:
                matched_right.add(key)
                for rr in hits:
                    out.append(list(lr) + [rr[i] for i in r_rest])
            elif self.joinType in (JoinType.LEFT_OUTER,
                                   JoinType.FULL_OUTER):
                out.append(list(lr) + [None] * len(r_rest))
        if self.joinType in (JoinType.RIGHT_OUTER, JoinType.FULL_OUTER):
            n_left = self.leftSchema.numColumns()
            for key, rows in table.items():
                if key in matched_right:
                    continue
                for rr in rows:
                    left_fill = [None] * n_left
                    # key columns surface through the LEFT slots
                    for li, ki in zip(lk, range(len(key))):
                        left_fill[li] = key[ki]
                    out.append(left_fill + [rr[i] for i in r_rest])
        return out

    class Builder:
        def __init__(self, joinType=JoinType.INNER):
            self._type = joinType
            self._left = None
            self._right = None
            self._lcols = None
            self._rcols = None

        def setJoinType(self, joinType):
            self._type = joinType
            return self

        def setSchemas(self, leftSchema, rightSchema):
            self._left, self._right = leftSchema, rightSchema
            return self

        def setKeyColumns(self, *names):
            """Same key column names on both sides."""
            self._lcols = self._rcols = list(names)
            return self

        def setKeyColumnsLeft(self, *names):
            self._lcols = list(names)
            return self

        def setKeyColumnsRight(self, *names):
            self._rcols = list(names)
            return self

        def build(self) -> "Join":
            if self._left is None or self._right is None:
                raise ValueError("setSchemas(left, right) is required")
            if not self._lcols or not self._rcols:
                raise ValueError("join key columns are required")
            return Join(self._type, self._left, self._right,
                        self._lcols, self._rcols)


def executeJoin(join: Join, leftReader, rightReader):
    """Drain two RecordReaders and join them (reference analog:
    LocalTransformExecutor.executeJoin). Returns the joined records;
    feed them onward with CollectionRecordReader."""
    left = []
    while leftReader.hasNext():
        left.append(leftReader.next())
    right = []
    while rightReader.hasNext():
        right.append(rightReader.next())
    return join.execute(left, right)
