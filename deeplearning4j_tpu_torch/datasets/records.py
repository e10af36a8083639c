"""Record readers and the record→DataSet bridge.

Copied from ``deeplearning4j_tpu/datasets/records.py`` (numpy only; the
port keeps its own copy). A numeric CSV file parses through the port's
native ``csv_parse`` (``deeplearning4j_tpu_torch/native``) where the library
built, else through numpy, to the same values.

Reference capability: DataVec's RecordReader/InputSplit API
(org.datavec.api.records.reader.impl.csv.CSVRecordReader, FileSplit) and
deeplearning4j-core's RecordReaderDataSetIterator (SURVEY.md §2.4). Host-side
CPU parsing, exactly like the reference — ETL never touches the device."""

from __future__ import annotations

import csv
import glob
import os

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator


class InputSplit:
    def locations(self) -> list:
        raise NotImplementedError


class FileSplit(InputSplit):
    def __init__(self, path, extensions=None, recursive=True):
        self.path = path
        self.extensions = extensions
        self.recursive = recursive

    def locations(self):
        if os.path.isfile(self.path):
            return [self.path]
        pattern = "**/*" if self.recursive else "*"
        files = sorted(glob.glob(os.path.join(self.path, pattern),
                                 recursive=self.recursive))
        files = [f for f in files if os.path.isfile(f)]
        if self.extensions:
            files = [f for f in files
                     if any(f.endswith(e) for e in self.extensions)]
        return files


class ListStringSplit(InputSplit):
    """In-memory lines (reference: ListStringSplit)."""

    def __init__(self, data: list):
        self.data = list(data)

    def locations(self):
        return self.data


class RecordReader:
    def initialize(self, split: InputSplit):
        raise NotImplementedError

    def hasNext(self) -> bool:
        raise NotImplementedError

    def next(self) -> list:
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError


class CollectionRecordReader(RecordReader):
    """Reader over an in-memory list of records (reference:
    org.datavec.api.records.reader.impl.collection
    .CollectionRecordReader) — the bridge from executeJoin /
    TransformProcess.execute output back into the iterator stack."""

    def __init__(self, records):
        self.records = list(records)
        self._pos = 0

    def initialize(self, split=None):
        self._pos = 0

    def hasNext(self):
        return self._pos < len(self.records)

    def next(self):
        if not self.hasNext():
            raise StopIteration
        rec = self.records[self._pos]
        self._pos += 1
        return list(rec)

    def reset(self):
        self._pos = 0


class CSVRecordReader(RecordReader):
    """Reference: CSVRecordReader(numLinesToSkip, delimiter)."""

    def __init__(self, skipNumLines=0, delimiter=","):
        self.skip = skipNumLines
        self.delimiter = delimiter
        self._records: list = []
        self._pos = 0

    def initialize(self, split: InputSplit):
        self._records = []
        if isinstance(split, ListStringSplit):
            rows = csv.reader(split.data, delimiter=self.delimiter)
            self._records = [r for r in rows][self.skip:]
        else:
            for path in split.locations():
                rows = self._read_file(path)
                self._records.extend(rows[self.skip:])
        self._pos = 0
        return self

    def _read_file(self, path):
        """Fully-numeric CSV files parse to float records — through the
        native C kernel when the toolchain is available, else through
        numpy — so record values are IDENTICAL with or without g++.
        Anything non-numeric (quoting, string columns, ragged rows)
        falls back to the general csv module and yields strings."""
        from deeplearning4j_tpu_torch import native

        with open(path, "rb") as f:
            blob = f.read()
        if native.available():
            mat = native.csv_parse(blob, self.delimiter)
            if mat is not None:
                return mat.tolist()
        else:
            try:
                import io

                mat = np.loadtxt(io.BytesIO(blob), dtype=np.float32,
                                 delimiter=self.delimiter, ndmin=2,
                                 comments=None)
                return mat.tolist()
            except ValueError:
                pass
        with open(path, newline="") as f:
            return list(csv.reader(f, delimiter=self.delimiter))

    def hasNext(self):
        return self._pos < len(self._records)

    def next(self):
        r = self._records[self._pos]
        self._pos += 1
        return r

    def reset(self):
        self._pos = 0


class LineRecordReader(RecordReader):
    def __init__(self):
        self._lines: list = []
        self._pos = 0

    def initialize(self, split: InputSplit):
        self._lines = []
        if isinstance(split, ListStringSplit):
            self._lines = list(split.data)
        else:
            for path in split.locations():
                with open(path) as f:
                    self._lines.extend(line.rstrip("\n") for line in f)
        self._pos = 0
        return self

    def hasNext(self):
        return self._pos < len(self._lines)

    def next(self):
        line = self._lines[self._pos]
        self._pos += 1
        return [line]

    def reset(self):
        self._pos = 0


class RecordReaderDataSetIterator(DataSetIterator):
    """records -> DataSet minibatches (reference:
    org.deeplearning4j.datasets.datavec.RecordReaderDataSetIterator).

    Classification: labelIndex column holds an int class -> one-hot of
    numPossibleLabels. Regression: regression=True, labelIndex..labelIndexTo
    columns are float targets."""

    def __init__(self, recordReader: RecordReader, batchSize=32,
                 labelIndex=-1, numPossibleLabels=None, regression=False,
                 labelIndexTo=None):
        super().__init__(batchSize)
        self.reader = recordReader
        self.labelIndex = labelIndex
        self.numPossibleLabels = numPossibleLabels
        self.regression = regression
        self.labelIndexTo = labelIndexTo if labelIndexTo is not None \
            else labelIndex

    def reset(self):
        self.reader.reset()
        self._peek = None

    def _infer_num_labels(self):
        """Full pre-scan so every batch one-hots with the same width (a
        first-batch-only guess breaks when a later batch holds a higher
        class index)."""
        n = getattr(self.reader, "numLabels", None)
        if callable(n) and n():
            self.numPossibleLabels = n()
            return
        li = self.labelIndex
        max_idx = -1
        while self.reader.hasNext():
            rec = self.reader.next()
            idx = li if li >= 0 else len(rec) + li
            max_idx = max(max_idx, int(float(rec[idx])))
        self.reader.reset()
        if max_idx < 0:
            raise ValueError("no records to infer numPossibleLabels from")
        self.numPossibleLabels = max_idx + 1

    def _next_batch(self):
        if not self.regression and self.numPossibleLabels is None:
            self._infer_num_labels()
        feats, labels = [], []
        while len(feats) < self._batch and self.reader.hasNext():
            rec = self.reader.next()
            if rec and isinstance(rec[0], np.ndarray) and rec[0].ndim > 1:
                # tensor record (ImageRecordReader): [tensor, classIdx]
                feats.append(np.asarray(rec[0], np.float32))
                labels.append([float(rec[1])] if len(rec) > 1 else [0.0])
                continue
            rec = [float(v) for v in rec]
            li, lj = self.labelIndex, self.labelIndexTo
            if li < 0:
                li = lj = len(rec) + li
            lab = rec[li:lj + 1]
            feat = rec[:li] + rec[lj + 1:]
            feats.append(feat)
            labels.append(lab)
        if not feats:
            return None
        f = np.asarray(feats, np.float32)
        if self.regression:
            l = np.asarray(labels, np.float32)
        else:
            idx = np.asarray(labels, np.int64).reshape(-1)
            l = np.eye(self.numPossibleLabels, dtype=np.float32)[idx]
        return DataSet(f, l)


class RecordReaderMultiDataSetIterator(DataSetIterator):
    """Joins NAMED record readers into MultiDataSets for multi-input /
    multi-output ComputationGraphs (reference:
    org.deeplearning4j.datasets.datavec.RecordReaderMultiDataSetIterator
    + its Builder: addReader / addInput(column ranges) /
    addOutputOneHot / addOutput).

    Readers advance in lockstep; each input/output takes a column range
    of one reader's records per example.
    """

    class Builder:
        def __init__(self, batchSize=32):
            self._batch = batchSize
            self._readers: dict[str, RecordReader] = {}
            self._inputs: list = []    # (reader, colFrom, colTo)
            self._outputs: list = []   # (reader, colFrom, colTo, oneHotN)

        def addReader(self, name, reader):
            self._readers[name] = reader
            return self

        def addInput(self, readerName, columnFrom=0, columnTo=None):
            self._inputs.append((readerName, columnFrom, columnTo))
            return self

        def addOutput(self, readerName, columnFrom=0, columnTo=None):
            self._outputs.append((readerName, columnFrom, columnTo, None))
            return self

        def addOutputOneHot(self, readerName, column, numClasses):
            self._outputs.append((readerName, column, column,
                                  int(numClasses)))
            return self

        def build(self):
            if not self._inputs or not self._outputs:
                raise ValueError("declare at least one input and output")
            missing = {r for r, *_ in self._inputs + self._outputs
                       } - set(self._readers)
            if missing:
                raise ValueError(f"undeclared readers: {sorted(missing)}")
            return RecordReaderMultiDataSetIterator(self)

    def __init__(self, builder: "RecordReaderMultiDataSetIterator.Builder"):
        super().__init__(builder._batch)
        self._readers = builder._readers
        self._inputs = builder._inputs
        self._outputs = builder._outputs

    def reset(self):
        for r in self._readers.values():
            r.reset()
        self._peek = None

    def _records_row(self):
        """One aligned row of floats per reader, or None when exhausted.

        All readers are checked for exhaustion before any is consumed, so
        mismatched-length readers raise instead of silently dropping the
        records already pulled from the longer ones.
        """
        state = {name: r.hasNext() for name, r in self._readers.items()}
        if not any(state.values()):
            return None
        if not all(state.values()):
            done = sorted(n for n, h in state.items() if not h)
            live = sorted(n for n, h in state.items() if h)
            raise ValueError(
                f"readers out of alignment: {done} exhausted while "
                f"{live} still have records")
        return {name: [float(v) for v in r.next()]
                for name, r in self._readers.items()}

    @staticmethod
    def _cols(rec, c0, c1):
        n = len(rec)
        c1 = n - 1 if c1 is None else (c1 if c1 >= 0 else n + c1)
        c0 = c0 if c0 >= 0 else n + c0
        if not (0 <= c0 <= c1 < n):
            raise ValueError(
                f"column range [{c0}, {c1}] out of bounds for a record "
                f"of width {n}")
        return rec[c0:c1 + 1]

    def _next_batch(self):
        from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet

        rows = []
        while len(rows) < self._batch:
            row = self._records_row()
            if row is None:
                break
            rows.append(row)
        if not rows:
            return None
        feats = []
        for name, c0, c1 in self._inputs:
            feats.append(np.asarray(
                [self._cols(r[name], c0, c1) for r in rows], np.float32))
        labels = []
        for name, c0, c1, onehot in self._outputs:
            vals = [self._cols(r[name], c0, c1) for r in rows]
            if onehot is not None:
                idx = np.asarray([int(v[0]) for v in vals])
                if idx.min() < 0 or idx.max() >= onehot:
                    bad = idx[(idx < 0) | (idx >= onehot)][0]
                    raise ValueError(
                        f"one-hot output from reader {name!r} column "
                        f"{c0}: class index {bad} outside "
                        f"[0, {onehot})")
                labels.append(np.eye(onehot, dtype=np.float32)[idx])
            else:
                labels.append(np.asarray(vals, np.float32))
        # preprocessing happens once, in the base next()
        return MultiDataSet(feats, labels)
