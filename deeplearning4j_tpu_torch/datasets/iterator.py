"""DataSetIterator, ListDataSetIterator and ExistingDataSetIterator.

Copied from ``deeplearning4j_tpu/datasets/iterator.py`` (the base protocol
and the in-memory iterators). Iterators are python-iterable AND expose the
reference's hasNext/next/reset protocol. AsyncDataSetIterator and the
device prefetcher come with the data-tier slice.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class DataSetIterator:
    """Base: subclasses implement reset() and _next_batch() -> DataSet|None."""

    def __init__(self, batch_size=32):
        self._batch = batch_size
        self.preProcessor = None

    # -- reference protocol --------------------------------------------------
    def batch(self):
        return self._batch

    def setPreProcessor(self, pp):
        self.preProcessor = pp

    def getPreProcessor(self):
        return self.preProcessor

    def hasNext(self) -> bool:
        if getattr(self, "_peek", None) is None:
            self._peek = self._next_batch()
        return self._peek is not None

    def next(self) -> DataSet:
        if getattr(self, "_peek", None) is not None:
            ds, self._peek = self._peek, None
        else:
            ds = self._next_batch()
        if ds is None:
            raise StopIteration
        if self.preProcessor is not None:
            self.preProcessor.preProcess(ds)
        return ds

    def reset(self):
        raise NotImplementedError

    def resetSupported(self):
        return True

    def asyncSupported(self):
        return True

    def _next_batch(self):
        raise NotImplementedError

    # -- python protocol -----------------------------------------------------
    def __iter__(self):
        self.reset()
        return self

    def __next__(self) -> DataSet:
        try:
            return self.next()
        except StopIteration:
            raise


class ListDataSetIterator(DataSetIterator):
    """Iterate over an in-memory list of DataSets or one big DataSet split
    into minibatches (reference: ListDataSetIterator)."""

    def __init__(self, data, batch_size=32):
        super().__init__(batch_size)
        if isinstance(data, DataSet):
            self._list = data.batchBy(batch_size)
        else:
            self._list = list(data)
        self._pos = 0

    def reset(self):
        self._pos = 0
        self._peek = None

    def _next_batch(self):
        if self._pos >= len(self._list):
            return None
        ds = self._list[self._pos]
        self._pos += 1
        if not isinstance(ds, DataSet):
            f, l = ds
            ds = DataSet(f, l)
        return ds

    def totalExamples(self):
        return sum(d.numExamples() if isinstance(d, DataSet) else len(d[0])
                   for d in self._list)


class ExistingDataSetIterator(ListDataSetIterator):
    """Reference: ExistingDataSetIterator — wraps an existing collection."""
