"""Column analysis over record sources.

Copied from ``deeplearning4j_tpu/datasets/analysis.py`` (pure Python on
the host; the port keeps its own copy).

Reference: org.datavec.local.transforms.AnalyzeLocal +
org.datavec.api.transform.analysis.DataAnalysis (SURVEY.md §2.4): one
pass over the data computing per-column statistics keyed by the
schema's column types — numeric columns get min/max/mean/stddev (Welford
one-pass, so a long stream never materializes), all columns get
total/missing counts, string/categorical columns get distinct values
with occurrence counts."""

from __future__ import annotations

import math

from deeplearning4j_tpu_torch.datasets.transform import ColumnType


class NumericalColumnAnalysis:
    def __init__(self, name):
        self.name = name
        self.countTotal = 0
        self.countMissing = 0
        self._mean = 0.0
        self._m2 = 0.0
        self.min = None
        self.max = None

    def _update(self, value):
        self.countTotal += 1
        if value is None or value == "":
            self.countMissing += 1
            return
        v = float(value)
        n = self.countTotal - self.countMissing
        d = v - self._mean
        self._mean += d / n
        self._m2 += d * (v - self._mean)
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def getMin(self):
        return self.min

    def getMax(self):
        return self.max

    def getMean(self):
        return self._mean

    def getSampleStdev(self):
        n = self.countTotal - self.countMissing
        return math.sqrt(self._m2 / (n - 1)) if n > 1 else 0.0

    def __repr__(self):
        return (f"NumericalColumnAnalysis(min={self.min}, max={self.max},"
                f" mean={self._mean:.6g}, stdev={self.getSampleStdev():.6g},"
                f" count={self.countTotal}, missing={self.countMissing})")


class CategoricalColumnAnalysis:
    def __init__(self, name):
        self.name = name
        self.countTotal = 0
        self.countMissing = 0
        self.counts = {}

    def _update(self, value):
        self.countTotal += 1
        if value is None or value == "":
            self.countMissing += 1
            return
        key = str(value)
        self.counts[key] = self.counts.get(key, 0) + 1

    def getUnique(self):
        return len(self.counts)

    def getMapOfUniqueToCount(self):
        return dict(self.counts)

    def __repr__(self):
        return (f"CategoricalColumnAnalysis(unique={self.getUnique()}, "
                f"count={self.countTotal}, missing={self.countMissing})")


class DataAnalysis:
    def __init__(self, schema, analyses):
        self.schema = schema
        self._by_name = analyses

    def getColumnAnalysis(self, name):
        return self._by_name[name]

    def __repr__(self):
        lines = ["DataAnalysis:"]
        for c in self.schema.columns:
            lines.append(f"  {c[0]} ({c[1]}): {self._by_name[c[0]]!r}")
        return "\n".join(lines)


_NUMERIC = {ColumnType.Integer, ColumnType.Long, ColumnType.Double,
            ColumnType.Float}


class AnalyzeLocal:
    @staticmethod
    def analyze(schema, source) -> DataAnalysis:
        """source: a RecordReader (drained via hasNext/next) or any
        iterable of records."""
        cols = schema.columns
        analyses = {}
        for name, ctype, _meta in cols:
            analyses[name] = (NumericalColumnAnalysis(name)
                              if ctype in _NUMERIC
                              else CategoricalColumnAnalysis(name))
        if hasattr(source, "hasNext"):
            def gen():
                while source.hasNext():
                    yield source.next()
            records = gen()
        else:
            records = iter(source)
        for rec in records:
            if len(rec) != len(cols):
                raise ValueError(
                    f"record width {len(rec)} != schema width "
                    f"{len(cols)}: {rec!r}")
            for (name, _t, _m), val in zip(cols, rec):
                analyses[name]._update(val)
        return DataAnalysis(schema, analyses)
