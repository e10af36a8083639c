"""DynamicBatcher: coalesce concurrent predict() calls into bucketed
device dispatches.

Counterpart of ``deeplearning4j_tpu/serving/batcher.py`` with the same
semantics, without the replica executor and the telemetry, flight and
tracing hooks (they come with later slices):

- max-latency flush: the first request in a batch waits at most
  `max_latency` seconds for co-travelers, then the batch executes;
- backpressure: the queue is bounded; `submit()` on a full queue raises
  QueueFullError immediately instead of letting latency grow unbounded;
- per-request timeout: a request whose deadline passes while still
  QUEUED fails with ServingTimeout and never reaches the device; one
  whose deadline passes DURING the dispatch fails the same way after it;
- priority: the queue orders high < normal < batch, FIFO within a class;
- graceful shutdown: close() stops the worker and fails queued requests
  with ServingShutdown; retire() finishes them first.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from deeplearning4j_tpu_torch.serving.buckets import pad_rows, pad_time

_REQ_IDS = itertools.count(1)


class QueueFullError(RuntimeError):
    """Backpressure: the batching queue is at capacity."""


class ServingTimeout(TimeoutError):
    """The request's deadline passed before its result was ready."""


class ServingShutdown(RuntimeError):
    """The batcher shut down with this request still queued."""


class _Request:
    __slots__ = ("x", "n", "t", "future", "t_enqueue", "deadline",
                 "req_id")

    def __init__(self, x, deadline):
        self.x = x
        self.n = x.shape[0]
        # real trailing time length of sequence inputs: results slice
        # back to it after bucket padding
        self.t = x.shape[-1] if x.ndim >= 3 else None
        self.future = Future()
        self.t_enqueue = time.perf_counter()
        self.deadline = deadline
        self.req_id = next(_REQ_IDS)

    def expired(self, now):
        return self.deadline is not None and now > self.deadline

    def fail(self, exc):
        if self.future.set_running_or_notify_cancel():
            self.future.set_exception(exc)


def execute_plan(entry, xs):
    """Execute already-coalesced rows through the entry's servable: pad
    the time axis to its covering bucket ONCE, chunk rows by ladder.plan,
    pad each chunk to its bucket, run, and slice the padding rows back
    off. Returns (y_real_rows_time_padded, device_dispatch_count,
    padded_row_count)."""
    ladder = entry.ladder
    sv = entry.servable
    if xs.ndim >= 3:
        xs = pad_time(xs, ladder.covering_seq(xs.shape[-1]))
    n = xs.shape[0]
    outs, n_padded, off = [], 0, 0
    plan = ladder.plan(n)
    for bucket in plan:
        take = min(bucket, n - off)
        chunk = pad_rows(xs[off:off + take], bucket)
        outs.append(sv.infer(chunk)[:take])
        off += take
        n_padded += bucket
    y = outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)
    return y, len(plan), n_padded


def run_batch(entry, batch):
    """Run one formed batch of requests end to end: late expiry check,
    pad/concat, ladder execution, result split, and the mid-execute
    deadline check. A device error fails every request of the batch."""
    now = time.perf_counter()
    live = []
    for r in batch:
        if r.expired(now):
            r.fail(ServingTimeout("timed out in queue"))
        elif r.future.set_running_or_notify_cancel():
            live.append(r)
    if not live:
        return
    try:
        if live[0].t is not None:
            # sequence inputs may differ in trailing length within one
            # coalesced batch: pad each to the covering seq bucket of the
            # longest BEFORE concatenating (results slice back to each
            # request's own real length)
            t_bucket = entry.ladder.covering_seq(max(r.t for r in live))
            parts = [pad_time(r.x, t_bucket) for r in live]
        else:
            parts = [r.x for r in live]
        xs = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
        y, _, _ = execute_plan(entry, xs)
    except Exception as e:  # surface the device error to every caller
        for r in live:
            r.future.set_exception(e)
        return
    done_at = time.perf_counter()
    off = 0
    for r in live:
        seg = y[off:off + r.n]
        if r.t is not None and seg.ndim >= 3 and seg.shape[-1] != r.t:
            seg = seg[..., :r.t]
        off += r.n
        if r.expired(done_at):
            r.future.set_exception(
                ServingTimeout("deadline passed mid-execute"))
        else:
            r.future.set_result(seg)


_PRIO_RANK = {"high": 0, "normal": 1, "batch": 2}


class DynamicBatcher:
    """One worker thread per served model (and version). `entry` is a
    ModelRegistry entry (servable + ladder)."""

    _SENTINEL = object()

    def __init__(self, entry, max_latency=0.002, queue_size=256,
                 default_timeout=30.0):
        self.entry = entry
        self.max_latency = float(max_latency)
        self.default_timeout = default_timeout
        self._accepting = True
        self._q: queue.Queue = queue.PriorityQueue(maxsize=queue_size)
        self._carry = None   # dequeued but didn't fit the closing batch
        self._closed = False
        # serializes submit-enqueue against close-drain: without it a
        # request enqueued between close()'s drain and the closed check
        # would never be completed nor failed
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(
            target=self._run, name=f"dl4j:batcher:coalescer-{entry.name}",
            daemon=True)
        self._worker.start()

    # -- client side --------------------------------------------------------
    def submit(self, x, timeout=None, priority="normal") -> Future:
        """Enqueue one request batch [n, ...]; returns its Future.
        Raises QueueFullError when the bounded queue is at capacity."""
        x = np.asarray(x)
        if timeout is None:
            timeout = self.default_timeout
        deadline = (time.perf_counter() + timeout
                    if timeout is not None else None)
        req = _Request(x, deadline)
        try:
            with self._submit_lock:
                if self._closed or not self._accepting:
                    raise ServingShutdown(
                        f"batcher for {self.entry.name!r} closed")
                self._q.put_nowait((_PRIO_RANK.get(priority, 1),
                                    req.req_id, req))
        except queue.Full:
            raise QueueFullError(
                f"serving queue for {self.entry.name!r} is full "
                f"({self._q.maxsize} requests)") from None
        return req.future

    def queue_depth(self) -> int:
        return self._q.qsize() + (1 if self._carry is not None else 0)

    def retire(self, timeout=30.0):
        """Rolling-update shutdown: stop ACCEPTING, let the worker finish
        everything already queued, then stop."""
        with self._submit_lock:
            if self._closed:
                return
            self._accepting = False
        # rank above every priority class: drains the queue first
        self._q.put((max(_PRIO_RANK.values()) + 1, next(_REQ_IDS),
                     self._SENTINEL))
        self._worker.join(timeout)
        self._closed = True

    def close(self, timeout=5.0):
        """Stop the worker; queued requests fail with ServingShutdown."""
        if self._closed:
            return
        self._closed = True
        self._accepting = False
        # rank below every class: the worker sees it next, fail-fast
        self._q.put((-1, next(_REQ_IDS), self._SENTINEL))
        self._worker.join(timeout)
        with self._submit_lock:       # no submit can enqueue after this
            leftovers = [] if self._carry is None else [self._carry]
            self._carry = None
            while True:
                try:
                    r = self._q.get_nowait()[2]
                except queue.Empty:
                    break
                if r is not self._SENTINEL:
                    leftovers.append(r)
            if self._worker.is_alive():
                # join timed out mid-dispatch and the drain may have
                # consumed the sentinel: re-arm it so the worker exits
                self._q.put((-1, next(_REQ_IDS), self._SENTINEL))
        for r in leftovers:
            r.fail(ServingShutdown("batcher closed"))

    # -- worker side --------------------------------------------------------
    def _next(self, timeout):
        if self._carry is not None:
            r, self._carry = self._carry, None
            return r
        try:
            return self._q.get(timeout=timeout)[2]
        except queue.Empty:
            return None

    def _run(self):
        max_batch = self.entry.ladder.max_batch
        while True:
            head = self._next(timeout=0.1)
            if head is None:
                continue
            if head is self._SENTINEL:
                return
            if self._closed:
                # graceful shutdown: in-flight work completed, queued
                # requests fail fast instead of executing
                head.fail(ServingShutdown("batcher closed"))
                continue
            batch, total = [head], head.n
            flush_at = time.perf_counter() + self.max_latency
            while total < max_batch:
                wait = flush_at - time.perf_counter()
                if wait <= 0:
                    break
                nxt = self._next(timeout=wait)
                if nxt is None:
                    break
                if nxt is self._SENTINEL:
                    run_batch(self.entry, batch)
                    return
                if nxt.expired(time.perf_counter()):
                    nxt.fail(ServingTimeout("timed out in queue"))
                    continue
                if total + nxt.n > max_batch and nxt.n <= max_batch:
                    # would overflow the largest bucket: hold it for the
                    # next batch (oversized requests pass through and get
                    # chunked by the ladder plan)
                    self._carry = nxt
                    break
                batch.append(nxt)
                total += nxt.n
            run_batch(self.entry, batch)
