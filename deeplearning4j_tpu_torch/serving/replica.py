"""ReplicaSet: multi-replica work-stealing execution for one model.

Counterpart of ``deeplearning4j_tpu/serving/replica.py``. Through one
DynamicBatcher worker a model runs one dispatch at a time. Here the
model's servable is CLONED into N replicas (`Servable.for_device`) and a
scheduler spreads formed batches across them:

- per-replica run queues: a submitted batch is routed to the replica
  with the least load (queued + in-flight), so a slow dispatch on one
  replica doesn't head-of-line-block the others;
- steal-on-idle: a replica with an empty queue pops from the TAIL of
  the longest sibling queue (FIFO order preserved for the victim's
  head), so skewed batch sizes can't strand work behind one replica;
- death containment: a batch that fails with :class:`ReplicaDeath` is
  re-queued to a surviving replica (the request futures stay live —
  work is moved, not lost) and the dead replica stops taking work; a
  replica whose dispatches fail ``ERROR_BREAKER`` times in a row is
  declared dead the same way;
- graceful retire(): stop accepting, drain every queue and in-flight
  dispatch, then stop the workers; close() fails what is queued;
- bounded run queues (``max_queued``): beyond it the coalescer blocks,
  so backpressure surfaces as QueueFullError at the front door.

Where the port differs by design: the reference pins each replica to a
device of its own (``parallel.mesh.replica_devices``). The port serves
on one card, so every replica lives on the model's one device, shares
its parameters, and owns a CUDA stream and a worker thread: the
replicas' dispatches overlap on the card as far as the kernels' SM
demands and the host threads let them. :func:`replica_devices` is the
port's own helper; a device list naming another device raises
ValueError.

All queues share ONE lock (the set's Condition): per-replica deques
give routing and stealing their semantics; a single mutex keeps the
lock-order rule trivially satisfiable and makes load reads consistent.

int8 `QuantizedServable` replicas ride the same path: `for_device`
shares the quantized payload and gives the clone its own stream.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import torch

from deeplearning4j_tpu_torch.backend import resolve_device
from deeplearning4j_tpu_torch.serving.batcher import (
    ServingShutdown, run_batch)
from deeplearning4j_tpu_torch.telemetry import flight


def replica_devices(n=None, device=None, devices=None) -> list:
    """The devices of ``n`` serving replicas on ``device`` (the model's
    one device: "cuda" unless named). An explicit ``devices`` list must
    name only that device; ``n`` beyond its length round-robins, and
    ``n=None`` takes one replica a listed device (one, without a list).
    Every replica on one card gets a CUDA stream of its own
    (`Servable.for_device`)."""
    device = resolve_device(device)
    if devices is None:
        devices = [device]
    devices = [resolve_device(d) if torch.device(d).type == "cuda"
               else torch.device(d) for d in devices]
    if not devices:
        raise ValueError("no devices available for replica placement")
    others = sorted({str(d) for d in devices if d != device})
    if others:
        raise ValueError(
            f"replicas run on the model's device {device}; got "
            f"{', '.join(others)} (the port serves on one card)")
    if n is None:
        n = len(devices)
    if n < 1:
        raise ValueError(f"need n >= 1 replicas, got {n}")
    return [devices[i % len(devices)] for i in range(n)]


class ReplicaDeath(RuntimeError):
    """Infrastructure-level replica failure (device lost, executable
    invalidated). Distinct from a model/runtime error, which terminates
    the requests: a ReplicaDeath moves the batch to a live replica."""


class _BatchTask:
    __slots__ = ("requests", "inst", "attempts")

    def __init__(self, requests, inst):
        self.requests = requests
        self.inst = inst
        self.attempts = 0


class Replica:
    """One copy of the model (its servable clone, with its own CUDA
    stream on a card) plus its run queue and worker thread."""

    def __init__(self, rset, index, device, servable):
        self.rset = rset
        self.index = index
        self.device = device
        self.servable = servable
        self.name = f"r{index}"
        self.queue: deque = deque()
        self.inflight = 0
        self.dead = False
        self.consec_errors = 0   # circuit breaker input
        self._thread = threading.Thread(
            target=rset._worker_loop, args=(self,),
            name=f"dl4j:replica:{rset.entry.name}-{index}", daemon=True)

    def load(self) -> int:
        return len(self.queue) + self.inflight

    def start(self):
        self._thread.start()

    def join(self, timeout=None):
        self._thread.join(timeout)

    def is_alive(self) -> bool:
        return self._thread.is_alive()


class ReplicaSet:
    """N replicas of one registry entry with work-stealing dispatch.

    `devices`: explicit device list (each the model's own device), or
    None for `n_replicas` replicas on the model's device
    (:func:`replica_devices`). The DynamicBatcher owns the set when wired
    through `InferenceSession.register(..., replicas=N)`.
    """

    def __init__(self, entry, n_replicas=None, devices=None,
                 instruments=None, steal=True, warmup=True,
                 max_queued=None):
        devices = replica_devices(n_replicas, entry.servable.device,
                                  devices)
        self.entry = entry
        self.steal = steal
        # total standing batches across all run queues: submit_batch
        # BLOCKS the coalescer beyond this, which backs pressure up
        # into the batcher's bounded request queue — so QueueFullError
        # (HTTP 429) keeps firing at the front door instead of work
        # piling up in unbounded deques behind it
        self.max_queued = (max_queued if max_queued is not None
                           else max(4, 2 * len(devices)))
        self._instruments_fn = (instruments if callable(instruments)
                                else lambda: instruments)
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._accepting = True
        self._closed = False
        self.replicas = [
            Replica(self, i, d, entry.servable.for_device(d))
            for i, d in enumerate(devices)]
        for r in self.replicas:
            # per-replica memory-ledger claim names: clones on one
            # device must not collapse their claims onto one key
            r.servable.mem_label = r.name
        if warmup and entry.warmed:
            # the source servable was warmed; each replica clone warms
            # its own stream and staging buffers
            self.warmup()
        for r in self.replicas:
            r.start()

    # -- lifecycle -----------------------------------------------------------
    def warmup(self):
        """Warm the ladder on every replica (its stream and staging
        buffers): the steady state allocates no staging buffer."""
        for r in self.replicas:
            r.servable.warmup(self.entry.ladder)
        return self

    def retire(self, timeout=30.0):
        """Drain: stop accepting, wait for every queue and in-flight
        dispatch to finish, then stop the workers."""
        deadline = time.perf_counter() + timeout
        with self._lock:
            self._accepting = False
            while self.depth_locked() > 0 or any(
                    r.inflight for r in self.replicas):
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._work.wait(min(remaining, 0.1))
            self._closed = True
            self._work.notify_all()
        for r in self.replicas:
            r.join(max(0.0, deadline - time.perf_counter()) + 1.0)
        self._release_memory_claims()

    def close(self, timeout=5.0):
        """Fail-fast: queued batches fail with ServingShutdown.
        Idempotent — a second close finds the queues already drained."""
        with self._lock:
            self._accepting = False
            self._closed = True
            leftovers = [t for r in self.replicas
                         for t in self._drain_locked(r)]
            self._work.notify_all()
        inst = self._instruments_fn()
        for task in leftovers:
            for req in task.requests:
                req.fail(ServingShutdown("replica set closed"), inst,
                         "shutdown")
        for r in self.replicas:
            r.join(timeout)
        self._release_memory_claims()

    def _release_memory_claims(self):
        """The replica clones' staging buffers die with the set: drop
        their memory-ledger claims."""
        for r in self.replicas:
            release = getattr(r.servable, "release_memory_claims", None)
            if callable(release):
                release()

    def _drain_locked(self, replica):
        out = list(replica.queue)
        replica.queue.clear()
        return out

    # -- submission / introspection ------------------------------------------
    def depth_locked(self) -> int:
        return sum(len(r.queue) for r in self.replicas)

    def depth(self) -> int:
        with self._lock:
            return self.depth_locked()

    def live_replicas(self) -> list:
        return [r for r in self.replicas if not r.dead]

    def submit_batch(self, requests, inst=None):
        """Route one formed batch to the least-loaded live replica. A
        batch carrying a high-priority request goes to the HEAD of the
        run queue (and tail-stealing then migrates best-effort work
        first) — admission control bounds how MANY requests stand in
        line; this bounds WHERE the latency-sensitive ones stand."""
        self._submit(_BatchTask(list(requests),
                                inst if inst is not None
                                else self._instruments_fn()))

    def _submit(self, task):
        urgent = any(getattr(r, "priority", None) == "high"
                     for r in task.requests)
        with self._lock:
            while (not self._closed and self._accepting
                   and self.depth_locked() >= self.max_queued):
                self._work.wait(0.05)   # workers notify on completion
            if self._closed or not self._accepting:
                raise ServingShutdown(
                    f"replica set for {self.entry.name!r} closed")
            live = [r for r in self.replicas if not r.dead]
            if not live:
                raise ReplicaDeath(
                    f"no live replicas for {self.entry.name!r}")
            target = min(live, key=lambda r: (r.load(), r.index))
            if urgent:
                target.queue.appendleft(task)
            else:
                target.queue.append(task)
            self._work.notify_all()
        self._publish_load()

    def _publish_load(self):
        inst = self._instruments_fn()
        if inst is None or getattr(inst, "replica_load", None) is None:
            return
        for r in self.replicas:
            inst.replica_load(r.name).set(-1.0 if r.dead else r.load())

    # -- worker side ---------------------------------------------------------
    def _next_task_locked(self, me):
        """Own queue first (FIFO head); else steal from the tail of the
        longest sibling queue. Returns (task, victim_name_or_None) —
        a non-None victim means the task was stolen."""
        if me.queue:
            return me.queue.popleft(), None
        if self.steal:
            victims = [r for r in self.replicas if r is not me and r.queue]
            if victims:
                victim = max(victims, key=lambda r: len(r.queue))
                return victim.queue.pop(), victim.name
        return None, None

    def _worker_loop(self, me):
        try:
            while True:
                with self._lock:
                    if me.dead:   # a dead replica must not steal work
                        return
                    task, stolen = self._next_task_locked(me)
                    while task is None:
                        if self._closed or me.dead:
                            return
                        if not self._accepting and \
                                self.depth_locked() == 0:
                            return
                        self._work.wait(0.05)
                        task, stolen = self._next_task_locked(me)
                    me.inflight += 1
                try:
                    self._run_task(me, task, stolen)
                finally:
                    with self._lock:
                        me.inflight -= 1
                        self._work.notify_all()
                    self._publish_load()
        finally:
            if me.dead:
                self._on_death(me)

    # consecutive batch-level errors before a replica is declared dead:
    # a real device failure raises generic runtime errors, not ReplicaDeath
    # — without a breaker the broken replica fails batches instantly,
    # keeps a ~0 load, and least-loaded routing feeds it ALL traffic
    # while healthy siblings idle
    ERROR_BREAKER = 3

    @staticmethod
    def _task_trace(task):
        """Trace id of the first sampled request in a batch (None when
        nothing in it was sampled) — incident flight events name the
        span tree they belong to."""
        for r in task.requests:
            ctx = getattr(r, "trace", None)
            if ctx is not None:
                return ctx.trace_id
        return None

    def _run_task(self, me, task, stolen):
        inst = task.inst
        if stolen is not None:
            if inst is not None and \
                    getattr(inst, "steals", None) is not None:
                inst.steals.inc()
            # the steal names its actors: a flight dump after an
            # incident says WHICH replica drained WHOSE queue, not
            # just that steals happened
            flight.record("steal", model=self.entry.name,
                          replica=me.name, victim=stolen,
                          batch_rows=sum(r.n for r in task.requests),
                          trace_id=self._task_trace(task))
        task.attempts += 1
        try:
            errored = run_batch(self.entry, task.requests, inst,
                                servable=me.servable, replica=me.name)
        except ReplicaDeath as e:
            me.dead = True
            flight.record("replica_death", model=self.entry.name,
                          replica=me.name, error=str(e),
                          attempt=task.attempts, reason="death",
                          trace_id=self._task_trace(task))
            self._requeue(me, task, e)
            return
        if not errored:
            me.consec_errors = 0
            return
        me.consec_errors += 1
        others_alive = any(r is not me and not r.dead and r.is_alive()
                           for r in self.replicas)
        if me.consec_errors >= self.ERROR_BREAKER and others_alive:
            # the batch's requests already failed; move the BACKLOG
            me.dead = True
            death = ReplicaDeath(
                f"replica {me.name} tripped the error breaker "
                f"({me.consec_errors} consecutive failed dispatches)")
            flight.record("replica_death", model=self.entry.name,
                          replica=me.name, error=str(death),
                          attempt=task.attempts, reason="breaker",
                          trace_id=self._task_trace(task))
            self._requeue(me, None, death)

    def _requeue(self, me, task, death):
        """Move a failed batch (and everything queued on the dead
        replica) to survivors; fail the requests only when no replica
        is left or the batch already died on every one of them.
        task=None moves just the backlog (breaker-tripped path: the
        triggering batch's requests already failed)."""
        with self._lock:
            stranded = self._drain_locked(me) + \
                ([task] if task is not None else [])
            live = [r for r in self.replicas
                    if not r.dead and r.is_alive()]
            requeued, doomed = [], []
            for t in stranded:
                if live and t.attempts < len(self.replicas):
                    target = min(live, key=lambda r: (r.load(), r.index))
                    target.queue.append(t)
                    requeued.append(t)
                else:
                    doomed.append(t)
            self._work.notify_all()
        inst = self._instruments_fn()
        for t in doomed:
            for req in t.requests:
                req.fail(death, inst, "error")
        if requeued:
            flight.record("replica_requeue", model=self.entry.name,
                          source=me.name, batches=len(requeued))

    def _on_death(self, me):
        self._publish_load()
