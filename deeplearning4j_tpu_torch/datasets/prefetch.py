"""Host-to-device prefetch on a CUDA side stream.

Counterpart of ``deeplearning4j_tpu/datasets/prefetch.py``.
:class:`DevicePrefetcher` wraps any :class:`DataSetIterator`: a producer
thread pulls batches from the base iterator, runs an optional host-side
``prepare`` step (padding, masks, the dtype cast), copies the arrays to the
device and runs an optional ``deviceTransform`` there (a uint8 -> float
normalisation), and keeps up to ``depth`` staged batches in a bounded
queue. Batch k+1's copy overlaps batch k's compute.

On a CUDA device, where ``jax.device_put`` stood in the JAX package:

- the producer thread stages every batch on a ``torch.cuda.Stream`` of its
  own (the side stream), under ``torch.cuda.device(dev)``: each array is
  copied into a pinned host buffer, then to a fresh device tensor with
  ``non_blocking=True``; ``deviceTransform`` runs on the side stream after
  the copy; an event recorded on the side stream closes the batch;
- a pinned buffer is reused only after the event of the copy that last
  read it has completed;
- ``next()`` makes the consumer's current stream wait on that event and
  calls ``record_stream`` on every staged tensor, so the caching allocator
  does not hand the memory to the side stream again while the consumer's
  stream may still read it.

Every staged batch is a fresh device buffer that the prefetcher never
touches after handing it over (the JAX package's donation rule). On a CPU
device the same class runs without a stream (a fresh host copy a batch),
and only there. A staged ``DataSet`` holds tensors on the device: it is
built around them, since ``DataSet(...)`` would copy them back to numpy.

The trainers auto-wrap plain iterators (``MultiLayerNetwork.fit``) when
``default_depth() > 0``; ``set_default_depth(0)`` (or
``DL4J_PREFETCH_DEPTH=0``) restores the blocking path. The staged-batch
memory claim goes to the port's ``telemetry.memledger`` and the
``prefetch.prepare`` spans to its ``telemetry.tracing``; the prefetch
hit, miss and depth instruments of the metrics registry come with the
telemetry slice (ROADMAP.md, queue 1 item 13).
"""

from __future__ import annotations

import contextlib
import os
import queue as queue_mod
import threading
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend import resolve_device
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator

_depth = [max(0, int(os.environ.get("DL4J_PREFETCH_DEPTH", "2")))]


def default_depth() -> int:
    """Prefetch depth trainers use when auto-wrapping iterators
    (0 disables auto-wrap)."""
    return _depth[0]


def set_default_depth(n: int):
    _depth[0] = max(0, int(n))


class DeviceBatch:
    """A training batch staged on the device by a trainer-specific
    ``prepare`` callback: features/labels/mask are device tensors, and the
    trainer's fit loop consumes them without the usual host-side
    pad/mask/transfer work. ``bucket`` is the padded batch-axis size
    (``MultiLayerNetwork``'s bucket); ``real`` the number of non-padding
    rows."""

    __slots__ = ("features", "labels", "mask", "bucket", "real")

    def __init__(self, features, labels, mask, bucket=None, real=None):
        self.features = features
        self.labels = labels
        self.mask = mask
        self.bucket = bucket
        self.real = real


def staged_dataset(features, labels, featuresMask=None, labelsMask=None):
    """A DataSet around tensors as they are (no copy to numpy)."""
    ds = DataSet.__new__(DataSet)
    ds.features, ds.labels = features, labels
    ds.featuresMask, ds.labelsMask = featuresMask, labelsMask
    return ds


def _tensors(staged):
    """The tensors a staged batch holds."""
    leaves = [getattr(staged, k, None) for k in (
        "features", "labels", "mask", "featuresMask", "labelsMask",
        "featuresMasks", "labelsMasks")]
    out = []
    for leaf in leaves:
        if isinstance(leaf, (list, tuple)):
            out.extend(v for v in leaf if isinstance(v, torch.Tensor))
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


class _PinnedBuffers:
    """Pinned host staging buffers by (shape, dtype). A buffer taken is
    busy until the event recorded after its copy (``ready``) has
    completed, and only then handed out again; past ``limit`` buffers a
    key, the oldest copy is waited for."""

    _BUSY = object()   # taken, its copy's event not recorded yet

    def __init__(self, limit):
        self._limit = limit
        self._bufs: dict = {}

    def take(self, shape, dtype) -> list:
        """A free [buffer, marker] entry, marked busy."""
        entries = self._bufs.setdefault((tuple(shape), dtype), [])
        free = next((e for e in entries if e[1] is None or (
            e[1] is not self._BUSY and e[1].query())), None)
        if free is None:
            waiting = [e for e in entries if e[1] is not self._BUSY]
            if len(entries) < self._limit or not waiting:
                free = [torch.empty(shape, dtype=dtype, pin_memory=True),
                        None]
            else:
                free = waiting[0]   # the oldest copy: wait for it
                free[1].synchronize()
                entries.remove(free)
            entries.append(free)
        free[1] = self._BUSY
        return free

    @staticmethod
    def ready(entries, event):
        """The copies out of ``entries`` end at ``event``."""
        for entry in entries:
            entry[1] = event


class DevicePrefetcher(DataSetIterator):
    """Background host->device staging around any DataSetIterator.

    - ``depth``: max batches in flight (the double buffer; >=1);
    - ``prepare``: optional ``DataSet -> DataSet | DeviceBatch`` of host
      arrays, run in the producer thread before the copy (trainers inject
      their pad + mask + cast); by default the batch's features, labels
      and masks are staged as they are;
    - ``deviceTransform``: optional ``(features) -> features`` applied on
      the device after the copy (on the side stream) — the
      "normalize/augment-to-float on device" hook for uint8 pipelines
      (``floatOutput=False``);
    - ``device``: where batches are staged, "cuda" unless the caller names
      another (the CPU only when named).

    Ordering is the base iterator's order (single producer, FIFO queue);
    backpressure is the bounded queue. ``reset()`` restarts the producer
    (draining any stale generation); ``close()`` stops it.
    """

    _END = object()

    def __init__(self, base: DataSetIterator, depth: int | None = None,
                 prepare=None, deviceTransform=None, loop="prefetch",
                 device=None):
        super().__init__(base.batch())
        self._base = base
        self._depth = max(1, depth if depth is not None
                          else (default_depth() or 2))
        self._prepare = prepare
        self._device_transform = deviceTransform
        self._loop = loop
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = None      # the side stream, made on first start
        self._pinned = _PinnedBuffers(self._depth + 2) if self._cuda \
            else None
        self._gen = 0
        self._queue = None
        self._thread = None
        self._error = None
        self._done = False
        self._closed = False
        self._mem_claim = None   # device memory ledger claim, staged batches

    # -- delegation ----------------------------------------------------------
    def getLabels(self):
        return self._base.getLabels()

    def totalOutcomes(self):
        return getattr(self._base, "totalOutcomes", lambda: 0)()

    def set_epoch(self, epoch):
        if hasattr(self._base, "set_epoch"):
            self._base.set_epoch(epoch)

    def __len__(self):
        return len(self._base)

    def resetSupported(self):
        return self._base.resetSupported()

    def setPreProcessor(self, pp):
        # preprocessing belongs to the base (it runs in the producer
        # thread, before staging)
        self._base.setPreProcessor(pp)

    # -- staging -------------------------------------------------------------
    def _stage(self, x, used):
        """One array (numpy, or a tensor), or a list of them,
        as a fresh tensor on the device; on CUDA through a pinned buffer
        appended to ``used`` and a non-blocking copy on the current (side)
        stream."""
        if x is None:
            return None
        if isinstance(x, (list, tuple)):
            return type(x)(self._stage(v, used) for v in x)
        if isinstance(x, torch.Tensor):
            if x.device == self.device:
                return x.detach().clone()
            host = x.detach().cpu()
        else:
            host = torch.from_numpy(np.ascontiguousarray(x))
        if not self._cuda:
            return host.clone()
        entry = self._pinned.take(host.shape, host.dtype)
        entry[0].copy_(host)
        used.append(entry)
        return entry[0].to(self.device, non_blocking=True)

    def _to_device(self, staged, used):
        if isinstance(staged, DeviceBatch):
            staged.features = self._stage(staged.features, used)
            staged.labels = self._stage(staged.labels, used)
            staged.mask = self._stage(staged.mask, used)
            if self._device_transform is not None:
                staged.features = self._device_transform(staged.features)
            return staged
        if hasattr(staged, "featuresMasks"):   # a MultiDataSet
            out = type(staged).__new__(type(staged))
            for k in ("features", "labels", "featuresMasks",
                      "labelsMasks"):
                setattr(out, k, self._stage(getattr(staged, k), used))
            return out
        f = self._stage(staged.getFeatures(), used)
        if self._device_transform is not None:
            f = self._device_transform(f)
        return staged_dataset(
            f, self._stage(staged.getLabels(), used),
            self._stage(staged.getFeaturesMaskArray(), used),
            self._stage(staged.getLabelsMaskArray(), used))

    def _stage_batch(self, item, prepare):
        """(staged batch, event or None): ``prepare`` on the host, the
        copies and ``deviceTransform`` on the side stream, then an event
        that the consumer waits on."""
        staged = prepare(item) if prepare is not None else item
        if not self._cuda:
            return self._to_device(staged, []), None
        used = []
        # a tensor the base made on this thread's stream is ready first
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            staged = self._to_device(staged, used)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._pinned.ready(used, event)
        return staged, event

    # -- producer ------------------------------------------------------------
    def _produce(self, gen, q, trace_ctx):
        from deeplearning4j_tpu_torch.telemetry import memledger, tracing

        # one flag check per producer generation: with telemetry disabled
        # the loop body never computes staged bytes nor touches the ledger
        claim_pending = memledger.enabled()
        try:
            # the consumer's sampled trace context (captured at _start)
            # becomes current on THIS producer thread, so base-iterator
            # work (the ETL pool's work orders) parents to the training
            # trace across the thread hop
            with tracing.use(trace_ctx), (
                    torch.cuda.device(self.device) if self._cuda
                    else contextlib.nullcontext()):
                self._base.reset()
                while self._gen == gen and self._base.hasNext():
                    item = self._base.next()
                    # no blanket fallback here: an exception out of
                    # prepare or the copy is a real fault and surfaces
                    # at next() through the error path
                    t_prep = (time.perf_counter()
                              if trace_ctx is not None else 0.0)
                    staged = self._stage_batch(item, self._prepare)
                    if claim_pending:
                        # up to depth + 1 staged batches are pinned by
                        # this prefetcher (depth queued + one in flight):
                        # a claim stated once per producer generation
                        claim_pending = False
                        self._mem_claim = memledger.claim(
                            "prefetch", self._loop,
                            nbytes=(memledger.tree_bytes(
                                _tensors(staged[0])) * (self._depth + 1)),
                            device=self.device, depth=self._depth,
                            basis="depth x batch")
                    if trace_ctx is not None:
                        tracing.emit("prefetch.prepare", trace_ctx,
                                     t_prep, time.perf_counter(),
                                     loop=self._loop)
                    while self._gen == gen:
                        try:
                            q.put(staged, timeout=0.1)
                            break
                        except queue_mod.Full:
                            continue
        except Exception as e:  # surfaced at next()
            if self._gen == gen:
                self._error = memledger.oom_error(
                    e, site="prefetch.copy", loop=self._loop) or e
        finally:
            while self._gen == gen:
                try:
                    q.put(self._END, timeout=0.1)
                    break
                except queue_mod.Full:
                    continue

    def _start(self):
        from deeplearning4j_tpu_torch.telemetry import tracing

        if self._cuda and self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        self._gen += 1
        self._queue = queue_mod.Queue(maxsize=self._depth)
        self._error = None
        self._done = False
        self._thread = threading.Thread(
            target=self._produce,
            args=(self._gen, self._queue, tracing.current()),
            daemon=True, name=f"dl4j:prefetch:{self._loop}")
        self._thread.start()

    def _stop(self):
        """Invalidate the current generation and unblock the producer."""
        self._gen += 1
        t, q = self._thread, self._queue
        if t is not None and t.is_alive():
            # drain so a producer blocked on put() sees the stale gen
            while t.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue_mod.Empty:
                    pass
                t.join(timeout=0.05)
        self._thread = None
        self._queue = None
        if self._mem_claim is not None:
            # the staged buffers are dropped with the queue: the claim
            # goes with them (restated by the next producer generation)
            self._mem_claim.release()
            self._mem_claim = None

    # -- consumer ------------------------------------------------------------
    def hasNext(self):
        if self._closed:
            return False
        if self._queue is None:
            self._start()
        if self._done:
            return False
        if getattr(self, "_peek", None) is not None:
            return True
        item = self._take()
        if item is None:
            return False
        self._peek = item
        return True

    def next(self):
        if self._closed:
            raise StopIteration
        if getattr(self, "_peek", None) is not None:
            item, self._peek = self._peek, None
            return item
        if self._queue is None:
            self._start()
        item = self._take()
        if item is None:
            raise StopIteration
        return item

    def _take(self):
        if self._done:
            return None
        item = self._queue.get()
        if item is self._END:
            self._done = True
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            return None
        staged, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in _tensors(staged):
                t.record_stream(consumer)
        return staged

    def reset(self):
        """Stop the producer; the next consume restarts it. Lazy on
        purpose: training loops reset iterators more than once per epoch
        (``_as_batches`` + ``__iter__``), and an eagerly restarted producer
        would consume the base iterator's epoch state (epoch counters,
        augmentation seeds) for a generation that is then immediately
        discarded."""
        self._stop()
        self._peek = None

    def close(self):
        """Stop the producer thread; the prefetcher is terminal after this
        (hasNext() False, next() raises — nothing can silently respawn a
        producer over the base iterator). The base iterator itself is NOT
        closed — its lifecycle belongs to the caller."""
        self._stop()
        self._peek = None
        self._done = True
        self._closed = True

    def __del__(self):  # pragma: no cover - best effort
        try:
            self._stop()
        except Exception:
            pass

    # -- multi-batch staging -------------------------------------------------
    def takeMulti(self, k: int):
        """Stack the next ``k`` staged batches into device-resident
        ``[K, batch, ...]`` features/labels. Returns ``(features_k,
        labels_k)`` or None when fewer than ``k`` batches remain."""
        feats, labels = [], []
        for _ in range(k):
            if not self.hasNext():
                return None
            ds = self.next()
            if isinstance(ds, DeviceBatch):
                feats.append(ds.features)
                labels.append(ds.labels)
            else:
                feats.append(ds.getFeatures())
                labels.append(ds.getLabels())
        return torch.stack(feats), torch.stack(labels)

