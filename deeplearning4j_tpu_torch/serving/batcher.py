"""DynamicBatcher: coalesce concurrent predict() calls into bucketed
device dispatches.

Counterpart of ``deeplearning4j_tpu/serving/batcher.py`` with the same
semantics, telemetry, flight records and tracing emits. Per-request
dispatch overhead dominates small-batch inference, so N concurrent
single-example requests should cost ~1 device dispatch, not N: the worker
thread drains a bounded queue, packs requests into the smallest covering
bucket (padding the remainder), runs ONE dispatch, and splits the result
rows back to each caller's Future.

Semantics:
- max-latency flush: the first request in a batch waits at most
  `max_latency` seconds for co-travelers, then the batch executes;
- backpressure: the queue is bounded; `submit()` on a full queue raises
  QueueFullError immediately (callers see HTTP 429) instead of letting
  latency grow without bound;
- per-request timeout: a request that exceeds its deadline while still
  QUEUED fails with ServingTimeout and never reaches the device
  (outcome `timeout_queued`); one whose deadline passes DURING the
  device dispatch completes but is recorded as `timeout_execute`, so an
  operator can tell whether p99 dies in the queue (shed harder, add
  replicas) or on the device (kernels too slow);
- priority: the queue orders high < normal < batch, FIFO within a class;
- graceful shutdown: close() stops the worker and fails queued requests
  with ServingShutdown rather than hanging their futures; retire()
  finishes them first;
- per-request timing: each result's future carries ``dl4j_timing``, its
  queue and execute seconds, stamped before the result is set
  (``InferenceSession.predict(timing=)`` reads it).

With an `executor` (a ReplicaSet), the worker thread becomes a pure
coalescer: formed batches are handed to the work-stealing scheduler as
batch tasks and the padding/concat/dispatch/split runs on a replica
worker, so the replicas' streams execute batches concurrently instead of
serializing through this thread.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from deeplearning4j_tpu_torch.serving.buckets import pad_rows, pad_time
from deeplearning4j_tpu_torch.telemetry import flight, memledger, tracing

# process-wide request ids: every request carries one so flight-recorder
# serving summaries correlate with client-side logs
_REQ_IDS = itertools.count(1)


class QueueFullError(RuntimeError):
    """Backpressure: the batching queue is at capacity."""


class ServingTimeout(TimeoutError):
    """The request's deadline passed before it reached the device."""


class ServingShutdown(RuntimeError):
    """The batcher shut down with this request still queued."""


class _Request:
    __slots__ = ("x", "n", "t", "future", "t_enqueue", "deadline",
                 "req_id", "model", "started", "priority", "trace",
                 "t_open", "t_formed")

    def __init__(self, x, deadline, model=None, priority="normal",
                 trace=None):
        self.x = x
        self.n = x.shape[0]
        # real trailing time length of sequence inputs: results slice
        # back to it after bucket padding
        self.t = x.shape[-1] if x.ndim >= 3 else None
        self.future = Future()
        self.t_enqueue = time.perf_counter()
        self.deadline = deadline
        self.req_id = next(_REQ_IDS)
        self.model = model
        self.started = False   # set_running already done (replica re-run)
        self.priority = priority
        # sampled-trace context captured at submit (None = unsampled):
        # rides the request across the batcher/replica threads so
        # run_batch can emit the queue/coalesce/replica-queue/execute
        # phase spans retroactively
        self.trace = trace
        self.t_open = None     # coalescer popped this batch's head
        self.t_formed = None   # batch closed / handed to the executor

    def trace_id(self):
        return self.trace.trace_id if self.trace is not None else None

    def expired(self, now):
        return self.deadline is not None and now > self.deadline

    def summary(self, outcome, queue_s=None, **extra):
        """Flight-recorder serving summary (one ring-buffer append).
        Pass queue_s when dispatch already happened — measuring it here
        would fold the execute time into the queue wait."""
        if queue_s is None:
            queue_s = time.perf_counter() - self.t_enqueue
        if self.trace is not None:   # sampled: the event names its trace
            extra.setdefault("trace_id", self.trace.trace_id)
        flight.record("serving", req_id=self.req_id, model=self.model,
                      outcome=outcome, rows=self.n,
                      queue_s=round(queue_s, 6), **extra)

    def fail(self, exc, instruments, outcome):
        if self.started:            # already RUNNING (mid-execute fail)
            ok = not self.future.done()
        else:
            ok = self.future.set_running_or_notify_cancel()
            self.started = True
        if ok and not self.future.done():
            self.future.set_exception(exc)
        if instruments is not None:
            instruments.request(outcome)
        self.summary(outcome)


def execute_plan(entry, xs, servable=None):
    """Execute already-coalesced rows through the entry's servable at
    its bucket shapes: pad the time axis to its covering bucket ONCE, chunk
    rows by ladder.plan, pad each chunk to its bucket, run, and slice
    the padding rows back off. The ONE ladder-execution algorithm,
    shared by the batcher worker, the session's direct path, and the
    replica workers (which pass their own `servable` clone, with its
    own CUDA stream).
    Returns (y_real_rows_time_padded, device_dispatch_count,
    padded_row_count).
    """
    ladder = entry.ladder
    sv = servable if servable is not None else entry.servable
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


def _mark_running(req) -> bool:
    """set_running_or_notify_cancel, tolerant of a batch being re-run
    after a replica died mid-execute (the future is already RUNNING on
    the second attempt — only a cancelled/finished future opts out;
    the `started` flag avoids re-poking a RUNNING future, which logs a
    critical and raises)."""
    if req.started:
        return not req.future.done()
    ok = req.future.set_running_or_notify_cancel()
    req.started = True
    return ok


def run_batch(entry, batch, inst, servable=None, replica=None):
    """Run one formed batch of requests end to end: late expiry check
    (outcome `timeout_queued`), pad/concat, ladder execution, result
    split, telemetry, and the mid-execute deadline check (outcome
    `timeout_execute`). Shared by the DynamicBatcher's inline worker
    and the ReplicaSet workers. Raises ReplicaDeath through (the
    scheduler re-queues the batch); every other exception terminates
    the requests with outcome `error`. Returns True when the dispatch
    errored — the ReplicaSet's circuit breaker counts consecutive
    errors per replica."""
    from deeplearning4j_tpu_torch.serving.replica import ReplicaDeath

    now = time.perf_counter()
    live, first_run = [], []
    for r in batch:
        if r.expired(now):
            r.fail(ServingTimeout("timed out in queue"), inst,
                   "timeout_queued")
        else:
            first = not r.started   # before _mark_running flips it
            if _mark_running(r):
                live.append(r)
                if first:
                    first_run.append(r)
            else:
                if inst is not None:
                    inst.request("rejected")  # caller cancelled
                r.summary("cancelled")
    if not live:
        return False
    total = sum(r.n for r in live)
    if inst is not None:
        # only first attempts: a batch re-run after a replica death
        # would fold the failed attempt's execute time into the
        # queue-wait histogram and skew exactly the signal the
        # timeout_queued/timeout_execute split is meant to clean up
        for r in first_run:
            inst.queue_wait.observe(now - r.t_enqueue,
                                    exemplar=r.trace_id())
    for r in first_run:
        if r.trace is None:
            continue
        # retroactive phase spans: the request's wall time
        # decomposes into queue-wait (enqueue -> the coalescer popped
        # this batch's head), coalesce (the max-latency window the
        # batch held open), and — executor mode — replica-queue (batch
        # formed -> a replica worker picked it up)
        t_open = min(r.t_open if r.t_open is not None else now, now)
        t_formed = min(r.t_formed if r.t_formed is not None else now, now)
        tracing.emit("serving.queue_wait", r.trace, r.t_enqueue,
                     max(r.t_enqueue, t_open), req_id=r.req_id)
        tracing.emit("serving.coalesce", r.trace,
                     max(r.t_enqueue, t_open), t_formed,
                     batch_rows=total)
        if replica is not None:
            tracing.emit("serving.replica_queue", r.trace, t_formed,
                         now, replica=replica)
    try:
        if live[0].t is not None:
            # sequence inputs may differ in trailing length within
            # one coalesced batch: pad each to the covering seq
            # bucket of the longest BEFORE concatenating (results
            # slice back to each request's own real length)
            t_bucket = entry.ladder.covering_seq(max(r.t for r in live))
            parts = [pad_time(r.x, t_bucket) for r in live]
        else:
            parts = [r.x for r in live]
        xs = (np.concatenate(parts, axis=0)
              if len(parts) > 1 else parts[0])
        t0 = time.perf_counter()
        y, n_dispatch, n_padded = execute_plan(entry, xs,
                                               servable=servable)
        dt = time.perf_counter() - t0
        if inst is not None:
            inst.execute.observe(
                dt, exemplar=next((r.trace_id() for r in live
                                   if r.trace is not None), None))
            inst.dispatch.inc(n_dispatch)
            inst.occupancy.set(total / max(n_padded, 1))
        for r in live:
            if r.trace is not None:
                tracing.emit("serving.execute", r.trace, t0, t0 + dt,
                             batch_rows=total, dispatches=n_dispatch,
                             **({} if replica is None
                                else {"replica": replica}))
        done_at = time.perf_counter()
        off = 0
        for r in live:
            seg = y[off:off + r.n]
            if r.t is not None and seg.ndim >= 3 and \
                    seg.shape[-1] != r.t:
                seg = seg[..., :r.t]
            off += r.n
            if r.expired(done_at):
                # deadline passed while the device was executing: the
                # caller already gave up, and the distinction from a
                # queued expiry is what says where p99 goes
                r.fail(ServingTimeout("deadline passed mid-execute"),
                       inst, "timeout_execute")
                continue
            # per-request phase durations ride the future (read by
            # session.predict(timing=), which the HTTP layer turns into
            # a Server-Timing header); stamped BEFORE set_result so a
            # waiter woken by the result sees them
            r.future.dl4j_timing = {"queue": round(now - r.t_enqueue, 6),
                                    "execute": round(dt, 6)}
            r.future.set_result(seg)
            if inst is not None:
                inst.request("ok")
            extra = {} if replica is None else {"replica": replica}
            r.summary("ok", queue_s=now - r.t_enqueue,
                      batch_rows=total, dispatches=n_dispatch,
                      execute_s=round(dt, 6), **extra)
    except ReplicaDeath:
        raise                     # scheduler re-queues; futures stay live
    except Exception as e:  # surface the device error to every caller
        # OOM forensics: an allocation failure during the coalesced
        # dispatch fails the requests with the typed DeviceOomError
        # (the flight `oom` event names this seam, the requested bytes
        # and the top device-memory claims)
        oom = memledger.oom_error(e, site="serving.run_batch",
                                  model=entry.name)
        if oom is not None:
            e = oom
        for r in live:
            if not r.future.done():
                r.future.set_exception(e)
            if inst is not None:
                inst.request("error")
            r.summary("error", queue_s=now - r.t_enqueue,
                      error=f"{type(e).__name__}: {e}")
        return True
    return False


_PRIO_RANK = {"high": 0, "normal": 1, "batch": 2}


class DynamicBatcher:
    """One worker thread per served model.

    `entry` is a ModelRegistry entry (servable + ladder); `instruments`
    a telemetry.ServingInstruments, a zero-arg callable returning one
    (or None) — re-resolved per use so telemetry toggled mid-flight is
    honored — or None. `executor` is an optional ReplicaSet: formed
    batches are submitted to its work-stealing scheduler instead of
    executing on this thread (the batcher owns the executor's
    lifecycle: retire/close cascade).

    The coalescing queue is a PRIORITY queue (high < normal < batch,
    FIFO within a class via the monotonic request id): under overload
    a high-priority request jumps the standing best-effort backlog
    instead of aging behind it — one of the three places priority is
    enforced (admission budget, coalescing order, replica-queue
    placement).
    """

    _SENTINEL = object()

    def __init__(self, entry, max_latency=0.002, queue_size=256,
                 default_timeout=30.0, instruments=None, executor=None):
        self.entry = entry
        self.max_latency = float(max_latency)
        self.default_timeout = default_timeout
        self.executor = executor
        self._instruments_fn = (instruments if callable(instruments)
                                else lambda: instruments)
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
        Raises QueueFullError when the bounded queue is at capacity.
        `priority` rides with the request: a ReplicaSet executor places
        batches carrying high-priority requests at the HEAD of a
        replica queue (the single coalescing queue itself stays
        FIFO)."""
        x = np.asarray(x)
        if timeout is None:
            timeout = self.default_timeout
        deadline = (time.perf_counter() + timeout
                    if timeout is not None else None)
        # the caller's sampled trace context (None when unsampled or
        # telemetry disabled — zero tracer calls either way) crosses
        # to the worker/replica threads on the request itself
        req = _Request(x, deadline, model=self.entry.name,
                       priority=priority, trace=tracing.current())
        inst = self._instruments_fn()
        try:
            with self._submit_lock:
                if self._closed or not self._accepting:
                    raise ServingShutdown(
                        f"batcher for {self.entry.name!r} closed")
                self._q.put_nowait((_PRIO_RANK.get(priority, 1),
                                    req.req_id, req))
        except queue.Full:
            if inst is not None:
                inst.request("rejected")
            req.summary("rejected")
            raise QueueFullError(
                f"serving queue for {self.entry.name!r} is full "
                f"({self._q.maxsize} requests)") from None
        if inst is not None:
            inst.depth.set(self._q.qsize())
        return req.future

    def queue_depth(self) -> int:
        depth = self._q.qsize() + (1 if self._carry is not None else 0)
        if self.executor is not None:
            depth += self.executor.depth()
        return depth

    def retire(self, timeout=30.0):
        """Rolling-update shutdown: stop ACCEPTING, let the worker
        finish everything already queued, then stop. (close() is the
        fail-fast path.)"""
        with self._submit_lock:
            if self._closed:
                return
            self._accepting = False
        # rank above every priority class: drains the queue first
        self._q.put((max(_PRIO_RANK.values()) + 1, next(_REQ_IDS),
                     self._SENTINEL))
        self._worker.join(timeout)
        if self.executor is not None:
            self.executor.retire(timeout)
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
        inst = self._instruments_fn()
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
                # instead of polling forever
                self._q.put((-1, next(_REQ_IDS), self._SENTINEL))
        for r in leftovers:
            r.fail(ServingShutdown("batcher closed"), inst, "shutdown")
        if self.executor is not None:
            self.executor.close(timeout)

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
            t_open = time.perf_counter()   # coalescing window opens
            if self._closed:
                # graceful shutdown: in-flight work completed, queued
                # requests fail fast instead of executing
                head.fail(ServingShutdown("batcher closed"),
                          self._instruments_fn(), "shutdown")
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
                    self._execute(batch, total, t_open)
                    return
                if nxt.expired(time.perf_counter()):
                    nxt.fail(ServingTimeout("timed out in queue"),
                             self._instruments_fn(), "timeout_queued")
                    continue
                if total + nxt.n > max_batch and nxt.n <= max_batch:
                    # would overflow the largest bucket: hold it for the
                    # next batch (oversized requests pass through and get
                    # chunked by the ladder plan)
                    self._carry = nxt
                    break
                batch.append(nxt)
                total += nxt.n
            self._execute(batch, total, t_open)

    def _execute(self, batch, total, t_open=None):
        inst = self._instruments_fn()
        if inst is not None:
            inst.depth.set(self._q.qsize())
        t_formed = time.perf_counter()
        for r in batch:
            if r.trace is not None:   # phase stamps for run_batch spans
                r.t_open = t_open
                r.t_formed = t_formed
        if self.executor is not None:
            # pure-coalescer mode: hand the formed batch to the
            # work-stealing scheduler; padding/dispatch/split runs on a
            # replica worker and this thread immediately coalesces the
            # next batch
            try:
                self.executor.submit_batch(batch, inst)
            except Exception as e:
                outcome = ("shutdown" if isinstance(e, ServingShutdown)
                           else "error")
                for r in batch:
                    r.fail(e, inst, outcome)
            return
        run_batch(self.entry, batch, inst)
