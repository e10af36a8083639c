"""DataSetIterator, ListDataSetIterator, ExistingDataSetIterator and
AsyncDataSetIterator.

Copied from ``deeplearning4j_tpu/datasets/iterator.py`` (host Python; the
port keeps its own copy). Iterators are python-iterable AND expose the
reference's hasNext/next/reset protocol. AsyncDataSetIterator prefetches
batches on a host thread, with the reference's wedge detection at
``reset()``; the device half of the pipeline is
``datasets/prefetch.py``'s DevicePrefetcher, which stages batches on a CUDA
side stream.
"""

from __future__ import annotations

import math
import os
import queue
import threading

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


def _positive_finite_timeout(value, what, shown=None):
    """inf/nan/<=0 'wait forever' timeouts would turn the reset() wedge
    guard back into the indefinite hang it exists to prevent."""
    if not (value > 0 and math.isfinite(value)):
        display = value if shown is None else shown
        raise ValueError(
            f"{what} must be a positive finite number of seconds, got "
            f"{display!r}; use a large value for very slow sources")


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


class AsyncDataSetIterator(DataSetIterator):
    """Wraps any DataSetIterator with a background prefetch thread and a
    bounded queue (reference: deeplearning4j AsyncDataSetIterator with
    queue size N). Keeps the accelerator fed while the host parses the
    next batch.

    Wedge detection applies at reset() only: restarting over a producer
    stuck inside the base iterator would interleave two producers on it,
    so reset() raises after join_timeout with no progress. A reset()
    before anything was consumed (notably __iter__'s implicit one on a
    just-built iterator) is a no-op — the fresh producer already sits
    at an epoch start, so there is nothing to rewind and a slow first
    batch is never mistaken for a wedge. Mid-epoch
    consumption (next()) deliberately blocks without a deadline — a
    legitimately slow source (cold storage, first-batch compile stall)
    is indistinguishable from a wedged one there, and a guessed timeout
    would abort healthy training runs."""

    _END = object()
    _JOIN_TIMEOUT = 5.0

    def __init__(self, base: DataSetIterator, queue_size: int = 4,
                 join_timeout: float | None = None):
        super().__init__(base.batch())
        self._base = base
        self._qsize = queue_size
        # per-instance override for sources whose next() legitimately
        # takes longer than the default before reset() declares them
        # wedged; None defers to DL4J_ASYNC_JOIN_TIMEOUT (reachable when
        # a fit() path auto-wraps the iterator) then the class attribute
        if join_timeout is not None:
            # fail at the misconfiguration site, not mid-training
            _positive_finite_timeout(join_timeout, "join_timeout")
        self._join_timeout = join_timeout
        self._queue: queue.Queue = None
        self._thread = None
        self._start()

    def _start(self):
        self._base.reset()
        self._queue = queue.Queue(maxsize=self._qsize)
        self._error = None
        self._done = False
        self._consumed = False  # anything taken off the queue yet?

        def produce():
            try:
                while True:
                    if not self._base.hasNext():
                        break
                    self._queue.put(self._base.next())
            except Exception as e:  # surface in consumer
                self._error = e
            finally:
                self._queue.put(self._END)

        self._thread = threading.Thread(target=produce, daemon=True,
                                        name="dl4j:etl:result-drain")
        self._thread.start()

    def reset(self):
        # drain current thread then restart; drain only while _END is
        # still in flight (if the consumer already took it, a blind
        # get() would block forever on the empty queue), then join so
        # the old producer can't interleave with the new epoch's
        if not self._consumed:
            # untouched producer: the in-flight production IS the start
            # of an epoch (ctor/_start just reset the base), so reset()
            # has nothing to rewind. Crucially this covers __iter__'s
            # reset() on a just-constructed iterator — draining there
            # would declare a legitimately slow FIRST batch (cold
            # storage, compile stall) wedged under default timeouts
            return
        t = self._thread
        if t is not None and t.is_alive():
            # timeout resolution + error construction only on this
            # path: the per-epoch happy case (producer already done and
            # exited) skips straight to the restart
            timeout = self._join_timeout
            if timeout is None:
                raw = os.environ.get("DL4J_ASYNC_JOIN_TIMEOUT")
                if raw is None:
                    timeout = self._JOIN_TIMEOUT
                else:
                    try:
                        timeout = float(raw)
                    except ValueError:
                        timeout = math.nan  # rejected just below
                    # garbage env values would hang the wedge guard
                    # exactly the way it exists to prevent
                    _positive_finite_timeout(
                        timeout, "DL4J_ASYNC_JOIN_TIMEOUT", shown=raw)

            def _wedged():
                return RuntimeError(
                    "AsyncDataSetIterator.reset(): producer thread "
                    f"would not stop (no progress within {timeout}s "
                    "wait windows); base iterator appears wedged, "
                    "refusing to restart over a live producer (pass "
                    "join_timeout= or set DL4J_ASYNC_JOIN_TIMEOUT for "
                    "slow sources)")

            if not self._done:
                # drain to _END; a slow source keeps the drain alive as
                # long as items arrive — only two consecutive empty
                # windows (no progress for 2x timeout) declare it wedged
                empty_windows = 0
                while True:
                    try:
                        item = self._queue.get(timeout=timeout)
                    except queue.Empty:
                        if not t.is_alive():
                            break  # producer exited; nothing to drain
                        empty_windows += 1
                        if empty_windows >= 2:
                            raise _wedged()
                        continue
                    if item is self._END:
                        break
                    empty_windows = 0
            t.join(timeout=timeout)
            if t.is_alive():
                # restarting now would have old and new producers
                # interleave on self._base — the exact race the join
                # exists to prevent
                raise _wedged()
        self._start()
        self._peek = None

    def _next_batch(self):
        if self._done:
            return None  # exhausted: don't block on the dead producer
        item = self._queue.get()
        self._consumed = True
        if item is self._END:
            self._done = True
            if self._error is not None:
                raise self._error
            return None
        return item

    def resetSupported(self):
        return self._base.resetSupported()
