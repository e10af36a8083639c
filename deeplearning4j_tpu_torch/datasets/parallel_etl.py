"""Streaming parallel ETL: a persistent multiprocess worker pool with
shared-memory batch transport.

Copied from ``deeplearning4j_tpu/datasets/parallel_etl.py`` (numpy on the
host; the port keeps its own copy). ``_decode_batch`` seeds each batch's
augmentation from ``np.random.default_rng((seed, epoch, seq))`` and each
epoch's permutation from ``(seed, epoch, _PERM_TAG)`` exactly as the JAX
package does, so a batch is bit-identical across the serial, queue and
shared-memory transports and across the two packages. What changes:

- per-host sharding reads the world of ``torch.distributed`` (its size and
  rank when it is initialised; one process otherwise) where the JAX
  package reads ``jax.process_count()`` / ``jax.process_index()``;
- the workers fork from a process that may hold a CUDA context and torch's
  thread pools: they run numpy, PIL and the native library only (no torch
  call, no tensor), as ``_decode_batch`` does;
- a ring's shared-memory segment is named ``dl4j_torch_<pid>_<n>``, so the
  port's segments are told apart in ``/dev/shm``;
- ``prefetchToDevice=True`` copies each batch to the card in ``next()``
  (a blocking copy; ``DevicePrefetcher`` is the overlapped path);
- the loop and ETL instruments of the metrics registry come with the
  telemetry slice (ROADMAP.md, queue 1 item 13); the ``etl.decode`` spans
  of sampled traces ride back from the workers as in the JAX package.

The four optimizations of the JAX package's design stand: persistent
workers that survive ``reset()``, the shared-memory ring (uint8 batches
when no resample is needed, the float cast deferred to the consumer or
the device), seeded epoch shuffling, per-host sharding.
"""

from __future__ import annotations

import atexit
import itertools
import os
import queue as queue_mod
import time

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator

# fork-inherited globals for the chunked TransformProcess executor (set
# synchronously around an ephemeral Pool — image ETL no longer uses this)
_WORK = {}

# distinct rng stream tag for the epoch permutation (the augmentation
# stream is seeded (seed, epoch, seq) without it)
_PERM_TAG = 104729

# the port's shared-memory segments: SHM_PREFIX<pid>_<n> under /dev/shm
SHM_PREFIX = "dl4j_torch_"
_ring_ids = itertools.count()


def _default_workers():
    return max(1, (os.cpu_count() or 1))


def _fork_ctx():
    """The 'fork' start method, or None where it does not exist (Windows)
    or is unsafe as a non-default (macOS, spawn-default since 3.8): the
    pool's queue/semaphore-inheritance scheme is fork-only, so callers
    degrade to their serial path instead of crashing."""
    import multiprocessing as mp
    import sys
    if sys.platform in ("win32", "darwin"):
        return None
    try:
        return mp.get_context("fork")
    except ValueError:
        return None


def _world():
    """(processes, this process's rank): ``torch.distributed``'s world
    when it is initialised, else one process."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _shm_available():
    try:
        from multiprocessing import shared_memory  # noqa: F401

        return True
    except ImportError:  # pragma: no cover
        return False


# ---------------------------------------------------------------------------
# TransformProcess executor (unchanged one-shot chunked pool)
# ---------------------------------------------------------------------------

def _tp_chunk(args):
    lo, hi = args
    tp = _WORK["tp"]
    records = _WORK["records"]
    out = []
    for r in records[lo:hi]:
        res = tp.executeRecord(r)
        if res is not None:
            out.append(res)
    return out


class LocalTransformExecutor:
    """Chunked multi-process TransformProcess execution (reference:
    org.datavec.local.transforms.LocalTransformExecutor)."""

    @staticmethod
    def execute(records, transform_process, numWorkers=None,
                chunkSize=1024):
        records = list(records)
        n = len(records)
        workers = numWorkers or _default_workers()
        ctx = _fork_ctx()
        if workers <= 1 or n <= chunkSize or ctx is None:
            return transform_process.execute(records)
        _WORK["tp"] = transform_process
        _WORK["records"] = records
        try:
            chunks = [(lo, min(lo + chunkSize, n))
                      for lo in range(0, n, chunkSize)]
            with ctx.Pool(workers) as pool:
                parts = pool.map(_tp_chunk, chunks)
        finally:
            _WORK.clear()
        out = []
        for p in parts:
            out.extend(p)
        return out


# ---------------------------------------------------------------------------
# the single source of truth for one batch's values
# ---------------------------------------------------------------------------

def _epoch_perm(n_files, seed, epoch):
    """The epoch's batch->file-index assignment: a permutation drawn
    from (seed, epoch) on its own rng stream, identical wherever it is
    recomputed (parent, worker, resumed process)."""
    rng = np.random.default_rng((seed, epoch, _PERM_TAG))
    return rng.permutation(n_files)


def _decode_batch(files, label_idx, label_gen, loader, transform,
                  batch_size, seq, seed, epoch, perm):
    """Decode/augment ONE batch — shared verbatim by the serial path and
    every pool worker (identical seeding, so the transports are
    deterministically interchangeable). Returns (features, label_idxs)
    where features is uint8 [N,C,H,W] when no resample/augment was
    needed (``asBytes`` succeeded for every image) else float32; the
    uint8 form casts to the float32 form exactly."""
    lo = seq * batch_size
    if perm is not None:
        sel = perm[lo:lo + batch_size]
    else:
        sel = range(lo, min(lo + batch_size, len(files)))
    rng = np.random.default_rng((seed, epoch) + (seq,))
    feats, idxs = [], []
    all_u8 = transform is None
    for i in sel:
        path = files[i]
        if all_u8:
            arr = loader.asBytes(path)
            if arr is None:
                all_u8 = False
                feats = [a.astype(np.float32) for a in feats]
                arr = loader.asMatrix(path)
        else:
            arr = loader.asMatrix(path)
            if transform is not None:
                arr = transform.transform(arr, rng)
        feats.append(arr)
        idxs.append(label_idx[label_gen.getLabelForPath(path)])
    stacked = np.stack(feats)
    if stacked.dtype not in (np.uint8, np.float32):
        stacked = stacked.astype(np.float32)
    return stacked, np.asarray(idxs, np.int32)


# ---------------------------------------------------------------------------
# shared-memory batch ring
# ---------------------------------------------------------------------------

class _RawShmAttach:
    """Worker-side attachment to a parent-created segment by mmapping
    ``/dev/shm/<name>`` directly. ``SharedMemory(name=...)`` would also
    work but registers the attachment with the resource tracker
    (bpo-39959), which under fork produces spurious leaked-segment
    warnings at worker exit; the parent alone owns create/unlink, so
    workers stay off the tracker's books entirely. Linux-only — exactly
    the platforms where the fork-based pool runs at all."""

    def __init__(self, name):
        import mmap

        path = f"/dev/shm/{name.lstrip('/')}"
        fd = os.open(path, os.O_RDWR)
        try:
            size = os.fstat(fd).st_size
            self._mmap = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self.buf = memoryview(self._mmap)

    def close(self):
        try:
            self.buf.release()
            self._mmap.close()
        except Exception:
            pass


def _attach_shm(name):
    try:
        return _RawShmAttach(name)
    except OSError:  # pragma: no cover - nonstandard shm mount
        from multiprocessing import shared_memory

        return shared_memory.SharedMemory(name=name)


class ShmRing:
    """Fixed-slot shared-memory ring for decoded batches.

    Layout: ``slots`` one-byte occupancy flags (64-byte padded), then
    ``slots`` payload regions of ``slot_bytes``. Worker ``w`` of
    ``n_active`` owns the disjoint block of ``k = slots // n_active``
    slots starting at ``w*k`` and cycles through it, so every slot has
    exactly ONE writer (its owner) and one reader (the parent) — the
    occupancy flag is a plain SPSC handshake. A worker waiting on
    ``flags[slot] == 0`` is waiting for its OWN batch from ``k``
    iterations ago (a strictly smaller seq) to be consumed, and the
    parent consumes seqs in order, so the batch the parent blocks on
    always has a free slot: bounded buffering, deadlock-free, with no
    extra queue of free-slot tokens (which could not be created after
    the pool forked anyway).

    Memory-ordering note: the parent never reads a slot until the
    worker's result MESSAGE for it arrives (an mp.Queue pipe write/read
    — kernel-synchronized), so payload visibility does not ride the
    flag. The flag itself only gates slot REUSE; its store/load pair is
    plain shared memory, which is safe on TSO hosts (x86). On weakly
    ordered CPUs (aarch64) the parent's payload copy could in principle
    still be in flight when its flag store becomes visible — use
    ``transport="queue"`` there, or raise queueSize so reuse lags
    reads."""

    def __init__(self, slots, slot_bytes):
        from multiprocessing import shared_memory

        self.slots = int(slots)
        self.slot_bytes = int(slot_bytes)
        self.data_off = ((self.slots + 63) // 64) * 64
        size = self.data_off + self.slots * self.slot_bytes
        self.shm = shared_memory.SharedMemory(
            name=f"{SHM_PREFIX}{os.getpid()}_{next(_ring_ids)}", create=True,
            size=size)
        self.flags = np.frombuffer(self.shm.buf, np.uint8, self.slots, 0)
        self.flags[:] = 0

    @property
    def descriptor(self):
        return {"name": self.shm.name, "slots": self.slots,
                "slot_bytes": self.slot_bytes,
                "data_off": self.data_off}

    def read(self, slot, shape, dtype, cast=None):
        """Copy slot payload out as a host array; with ``cast`` the
        copy and the dtype conversion fuse into one pass (the uint8 ->
        float32 consumer cast never touches an intermediate buffer).
        The slot is reusable the moment this returns."""
        n = int(np.prod(shape))
        view = np.frombuffer(self.shm.buf, dtype, n,
                             self.data_off + slot * self.slot_bytes)
        view = view.reshape(shape)
        if cast is not None and cast != view.dtype:
            return view.astype(cast)
        return view.copy()

    def free(self, slot):
        self.flags[slot] = 0

    def occupancy(self):
        return int(self.flags.sum())

    def close(self):
        # release the parent's buffer views BEFORE closing the mapping
        # (BufferError otherwise), then unlink — workers hold their own
        # attachments until they see the close_ring command
        self.flags = None
        try:
            self.shm.close()
            self.shm.unlink()
        except Exception:
            pass


class _WorkerRing:
    """A worker's view of a parent ShmRing (attach by name)."""

    def __init__(self, descr):
        self.shm = _attach_shm(descr["name"])
        self.slots = descr["slots"]
        self.slot_bytes = descr["slot_bytes"]
        self.data_off = descr["data_off"]
        self.flags = np.frombuffer(self.shm.buf, np.uint8, self.slots, 0)

    def write(self, slot, arr, stall_timeout):
        """Wait for the slot to be consumed, then store the batch."""
        deadline = time.monotonic() + stall_timeout
        while self.flags[slot]:
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"shm ring slot {slot} not freed within "
                    f"{stall_timeout:.0f} s (consumer gone?)")
            time.sleep(0.0005)
        flat = arr.reshape(-1)
        view = np.frombuffer(self.shm.buf, arr.dtype, flat.size,
                             self.data_off + slot * self.slot_bytes)
        view[:] = flat
        self.flags[slot] = 1

    def close(self):
        self.flags = None
        try:
            self.shm.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# persistent worker pool
# ---------------------------------------------------------------------------

def _run_epoch(wid, order, specs, rings, out_q, credits, cancel):
    """Execute one work order inside a worker: decode this worker's
    strided share of the epoch's batches and publish each one. The
    shared ``cancel`` value names the newest abandoned job — checking
    it between batches bounds a mid-epoch reset's wasted decode at one
    batch per worker instead of the rest of the epoch."""
    job = order["job"]
    held = False   # a credit is held but not yet transferred via put()
    try:
        n_active = order["n_active"]
        if wid >= n_active:
            out_q.put(("done", job, wid))
            return
        spec = specs[order["spec"]]
        files = spec["files"]
        # sampled-trace ids riding the work order across the fork
        # the worker cannot reach the parent's tracer ring,
        # so it ships finished span RECORDS back on the results queue
        # and the parent materializes them (tracing.ingest in _handle)
        trace = order.get("trace")
        perm = (_epoch_perm(len(files), order["seed"], order["epoch"])
                if order["shuffle"] else None)
        ring = None
        descr = order.get("ring")
        if descr is not None:
            ring = rings.get(descr["name"])
            if ring is None:
                ring = rings[descr["name"]] = _WorkerRing(descr)
        # each worker OWNS a disjoint block of k ring slots and cycles
        # through it — exactly one writer per slot, so the occupancy
        # flag handshake is a single-producer/single-consumer protocol
        # regardless of how n_active divides the slot count
        k = ring.slots // n_active if ring is not None else 0
        for j, seq in enumerate(range(order["start"] + wid,
                                      order["n_batches"], n_active)):
            if cancel.value >= job:
                break
            # backpressure: a bounded number of in-flight batches
            # pool-wide. The parent releases a batch's credit when it
            # parks a ring batch (slot occupancy bounds shm memory) or
            # consumes/drains a queue batch (the credit bounds
            # host-heap queue memory)
            credits.acquire()
            held = True
            t_dec = time.perf_counter() if trace is not None else 0.0
            feats, idxs = _decode_batch(
                files, spec["label_idx"], spec["label_gen"],
                spec["loader"], spec["transform"], order["batch_size"],
                seq, order["seed"], order["epoch"], perm)
            if trace is not None:
                # CLOCK_MONOTONIC is shared across the fork, so these
                # timestamps line up with the parent's spans
                out_q.put(("span", job, {
                    "name": "etl.decode", "trace_id": trace[0],
                    "parent_id": trace[1], "start": t_dec,
                    "end": time.perf_counter(),
                    "attrs": {"seq": seq, "worker": wid,
                              "rows": int(feats.shape[0])}}))
            if ring is None or feats.nbytes > ring.slot_bytes:
                # queue fallback also catches transform output larger
                # than the slot (e.g. an up-sizing ResizeImageTransform)
                # instead of overflowing into neighboring slots
                out_q.put(("batch", job, seq, None, feats, idxs))
            else:
                slot = wid * k + (j % k)
                ring.write(slot, feats, order["stall"])
                out_q.put(("batch", job, seq,
                           (descr["name"], slot, feats.shape,
                            feats.dtype.char), None, idxs))
            held = False
        out_q.put(("done", job, wid))
    except Exception as e:  # surfaced by the parent
        out_q.put(("error", job, wid, f"{type(e).__name__}: {e}", held))


def _pool_worker(wid, cmd_q, out_q, credits, cancel):
    """Worker main loop: consume commands until told to stop. Work
    orders are processed strictly in submission order; dataset specs
    and shm rings are cached across epochs (the persistence that kills
    the per-epoch fork+pickle cost)."""
    specs, rings = {}, {}
    while True:
        cmd = cmd_q.get()
        kind = cmd[0]
        if kind == "stop":
            break
        if kind == "dataset":
            specs[cmd[1]] = cmd[2]
        elif kind == "drop_dataset":
            specs.pop(cmd[1], None)
        elif kind == "close_ring":
            ring = rings.pop(cmd[1], None)
            if ring is not None:
                ring.close()
        elif kind == "epoch":
            _run_epoch(wid, cmd[1], specs, rings, out_q, credits,
                       cancel)
    for ring in rings.values():
        ring.close()


class EtlWorkerPool:
    """Persistent decode workers shared across epochs (and, if passed
    around as a handle, across iterators).

    Channels are all created BEFORE the fork so they are inherited:
    one command queue per worker (work orders, dataset specs, ring
    lifecycle), one shared results queue, and one pool-wide credit
    semaphore bounding in-flight decoded batches (``maxInflight``).

    Work orders from different iterators serialize per worker — sharing
    a pool between iterators consumed in *lockstep* (e.g. ``zip``) can
    therefore stall; give concurrent iterators their own pools."""

    def __init__(self, numWorkers=None, maxInflight=32):
        self.size = numWorkers or _default_workers()
        self.max_inflight = int(maxInflight)
        self._ctx = _fork_ctx()
        self._procs = []
        self._cmd_qs = []
        self._out_q = None
        self._credits = None
        self._cancel = None
        self._spec_counter = itertools.count()
        self._job_counter = itertools.count()
        self._closed = False

    @property
    def available(self):
        return self._ctx is not None

    def _ensure_started(self):
        if self._procs or self._ctx is None or self._closed:
            return
        ctx = self._ctx
        self._cmd_qs = [ctx.Queue() for _ in range(self.size)]
        self._out_q = ctx.Queue()
        self._credits = ctx.BoundedSemaphore(self.max_inflight)
        # newest abandoned job id (monotonic): workers poll it between
        # batches so a mid-epoch reset stops the decode within one
        # batch instead of decode-and-discarding the rest of the epoch
        self._cancel = ctx.Value("l", -1)
        self._procs = [
            ctx.Process(target=_pool_worker,
                        args=(w, self._cmd_qs[w], self._out_q,
                              self._credits, self._cancel),
                        daemon=True, name=f"dl4j-etl-{w}")
            for w in range(self.size)
        ]
        for p in self._procs:
            p.start()
        _live_pools.add(self)

    def broadcast(self, cmd):
        self._ensure_started()
        for q in self._cmd_qs:
            q.put(cmd)

    def register_dataset(self, spec) -> int:
        """Ship a dataset spec (file list, label map, loader, transform)
        to every worker ONCE; epochs then reference it by id. The spec
        is test-pickled HERE so an unpicklable loader/transform fails
        loudly at registration instead of as an opaque KeyError from
        the queue's feeder thread."""
        import pickle

        try:
            pickle.dumps(spec)
        except Exception as e:
            raise TypeError(
                f"ETL dataset spec is not picklable into workers "
                f"(loader/transform/labelGenerator must be module-level "
                f"classes): {type(e).__name__}: {e}") from e
        spec_id = next(self._spec_counter)
        self.broadcast(("dataset", spec_id, spec))
        return spec_id

    def submit_epoch(self, order) -> int:
        job = next(self._job_counter)
        order = dict(order, job=job)
        self.broadcast(("epoch", order))
        return job

    def release_credit(self):
        try:
            self._credits.release()
        except ValueError:  # pragma: no cover - drain raced a release
            pass

    def cancel_job(self, job):
        """Tell workers to abandon this (and any older) work order."""
        if self._cancel is not None and job is not None:
            with self._cancel.get_lock():
                if job > self._cancel.value:
                    self._cancel.value = job

    def results(self):
        return self._out_q

    def dead_workers(self):
        return [p for p in self._procs
                if not p.is_alive() and p.exitcode not in (0, None)]

    def shutdown(self):
        """Stop workers (idempotent). Queued work is abandoned."""
        if self._closed:
            return
        self._closed = True
        for q in self._cmd_qs:
            try:
                q.put(("stop",))
            except Exception:
                pass
        for p in self._procs:
            p.join(timeout=2)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=2)
        self._procs = []
        _live_pools.discard(self)

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass


_live_pools: set = set()
_shared_pools: dict = {}


def shared_pool(numWorkers=None) -> EtlWorkerPool:
    """A process-wide pool handle keyed by worker count — iterators
    passed the same handle reuse the same forked workers instead of
    each forking their own."""
    n = numWorkers or _default_workers()
    pool = _shared_pools.get(n)
    if pool is None or pool._closed:
        pool = _shared_pools[n] = EtlWorkerPool(n)
    return pool


@atexit.register
def _shutdown_pools():  # pragma: no cover - interpreter teardown
    for pool in list(_live_pools):
        try:
            pool.shutdown()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# the iterator
# ---------------------------------------------------------------------------

class _EpochTail(DataSetIterator):
    """A one-epoch view of a ParallelImageDataSetIterator starting at
    batch ``offset`` — what ``ElasticTrainer`` gets from ``data[k:]``
    when replaying the unconsumed suffix of an interrupted epoch.
    Iterating it plays the parent's CURRENT epoch from ``offset``
    (workers are ordered to skip the consumed prefix, not decode and
    drop it) and leaves the parent positioned at the next epoch."""

    def __init__(self, parent, offset):
        super().__init__(parent.batch())
        self._parent = parent
        self._offset = int(offset)
        # mid-epoch, parent._epoch already points at the NEXT epoch
        # (consumed by _start); the tail must replay the one in flight
        self._epoch = (parent._epoch_playing if parent._epoch_started
                       else parent._epoch)

    def __len__(self):
        return max(0, self._parent._n_batches - self._offset)

    @property
    def hostSharded(self):
        return self._parent.hostSharded

    def reset(self):
        p = self._parent
        p.reset()
        p.set_epoch(self._epoch)
        p._start_from = self._offset

    def hasNext(self):
        return self._parent.hasNext()

    def next(self):
        return self._parent.next()

    def __iter__(self):
        self.reset()
        return self

    def __next__(self):
        if not self._parent.hasNext():
            raise StopIteration
        return self._parent.next()


class ParallelImageDataSetIterator(DataSetIterator):
    """Image-tree -> DataSet iterator whose decode/augment runs on a
    persistent worker pool; batches arrive in deterministic order over
    a shared-memory ring (or a queue), optionally reshuffled per epoch
    and sharded per host.

    Capability analog of ImageRecordReader + RecordReaderDataSetIterator
    + AsyncDataSetIterator fused (SURVEY.md §2.4), rebuilt as a
    streaming engine.

    Parameters beyond the classic set:

    - ``shuffle``: reshuffle the batch->file assignment each epoch from
      ``(seed, epoch)`` (deterministic under resume via ``set_epoch``);
    - ``transport``: ``"auto"`` (shm where available, else queue, else
      serial) | ``"shm"`` | ``"queue"`` | ``"serial"``;
    - ``pool``: an :class:`EtlWorkerPool` handle to share workers with
      other iterators (default: a private pool, persistent across
      epochs, shut down by ``close()``);
    - ``shardByHost``: ``"auto"`` (shard when ``torch.distributed``'s
      world has more than one process) | True | False — each process
      decodes only its rank-strided shard of the sorted file list;
    - ``stallTimeout``: seconds next() waits on the pool before
      declaring the workers stalled (was hardcoded 300);
    - ``floatOutput``: False keeps uint8 features in the DataSet (pair
      with DevicePrefetcher's deviceTransform to normalize on device).
    """

    def __init__(self, split, height, width, channels=3, batchSize=32,
                 labelGenerator=None, imageTransform=None, numWorkers=None,
                 prefetchToDevice=False, seed=0, queueSize=8,
                 shuffle=False, transport="auto", pool=None,
                 shardByHost="auto", stallTimeout=300.0,
                 floatOutput=True, startEpoch=0):
        super().__init__(batchSize)
        from deeplearning4j_tpu_torch.datasets.image import (
            NativeImageLoader, ParentPathLabelGenerator)

        self._split = split
        self._loader = NativeImageLoader(height, width, channels)
        self._label_gen = labelGenerator or ParentPathLabelGenerator()
        self._transform = imageTransform
        self._workers = numWorkers or _default_workers()
        self._prefetch = prefetchToDevice
        self._seed = seed
        self._qsize = max(2, int(queueSize))
        self._shuffle = bool(shuffle)
        self._stall = float(stallTimeout)
        self._float_out = bool(floatOutput)
        self._sample_shape = (channels, height, width)

        files = [f for f in split.locations()
                 if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp",
                                        ".gif"))]
        # labels come from the FULL tree (the class-index mapping must
        # be identical on every host), files from this host's shard
        self._labels = sorted({self._label_gen.getLabelForPath(f)
                               for f in files})
        # O(1) label lookup passed to workers (was labels.index(...) —
        # a linear scan per image)
        self._label_idx = {lab: i for i, lab in enumerate(self._labels)}
        nhosts, rank = _world()
        if shardByHost == "auto":
            shardByHost = nhosts > 1
        if shardByHost:
            shard = sorted(files)[rank::nhosts]
            # every host must run the SAME number of batches per epoch
            # — a shorter shard would exit the epoch early and desync
            # the pod's SPMD collectives — so short shards wrap around
            # (deterministically) up to the longest shard's length
            target = -(-len(files) // nhosts)
            files = [shard[i % len(shard)] for i in range(target)] \
                if shard else []
        self._host_sharded = bool(shardByHost)
        self._files = files
        # ceil: the final partial batch is produced too (the serial
        # reader path yields every record; silently dropping the tail
        # would train on a fixed subset forever)
        self._n_batches = -(-len(files) // batchSize)
        if self._n_batches == 0:
            raise ValueError("no images found")

        self._transport = self._resolve_transport(transport)
        self._pool = None
        self._own_pool = False
        if self._transport != "serial":
            # a private pool's in-flight credit bound follows queueSize
            # (the pre-rebuild mp.Queue(maxsize=queueSize) memory
            # contract); shared pools keep their own maxInflight
            self._pool = pool or EtlWorkerPool(
                self._workers,
                maxInflight=max(self._qsize, self._workers + 1))
            self._own_pool = pool is None
            if not self._pool.available:  # pragma: no cover - platform
                self._transport = "serial"
                self._pool = None
        self._spec_id = None
        self._ring = None

        self._epoch = int(startEpoch)
        self._start_from = 0       # first batch of the next epoch (tail)
        self._epoch_started = False  # this epoch's _start() has run
        self._started = False      # a pool work order is in flight
        self._job = None
        self._done = 0
        self._reorder = {}
        self._next_seq = 0
        self._perm = None
        self._epoch_playing = 0

    # -- introspection -------------------------------------------------------
    @property
    def hostSharded(self):
        """True when this host's batches cover only its own file shard
        — multi-host trainers must then assemble per-process global
        batches (mesh.host_sharded_batch) instead of assuming every
        process feeds the identical batch."""
        return self._host_sharded

    def getLabels(self):
        return list(self._labels)

    def totalOutcomes(self):
        return len(self._labels)

    def __len__(self):
        return self._n_batches

    def __getitem__(self, key):
        """Only tail slices (``it[k:]``) are supported — the shape
        ElasticTrainer uses to replay the rest of an interrupted
        epoch."""
        if not (isinstance(key, slice) and key.stop is None
                and key.step in (None, 1)):
            raise TypeError(
                "ParallelImageDataSetIterator supports only it[k:] "
                "tail slices")
        return _EpochTail(self, key.start or 0)

    def set_epoch(self, epoch):
        """Position the NEXT epoch to play as ``epoch`` (resume
        alignment: a freshly built iterator in a restarted process is
        told which epoch the checkpoint left off in)."""
        if self._epoch_started:
            self.reset()
        self._epoch = int(epoch)

    # -- internals -----------------------------------------------------------
    def _resolve_transport(self, transport):
        if transport not in ("auto", "shm", "queue", "serial"):
            raise ValueError(f"unknown transport {transport!r}")
        if self._workers <= 1 and transport == "auto":
            return "serial"
        if _fork_ctx() is None:
            return "serial"
        if transport == "auto":
            import platform

            # the ring's flag handshake assumes TSO (see ShmRing);
            # weakly ordered hosts default to the queue transport
            tso = platform.machine().lower() in ("x86_64", "amd64",
                                                 "i686", "i386")
            return "shm" if (_shm_available() and tso) else "queue"
        if transport == "shm" and not _shm_available():
            raise RuntimeError(
                "transport='shm' requested but "
                "multiprocessing.shared_memory is unavailable")
        return transport

    def _slot_bytes(self):
        per = int(np.prod(self._sample_shape))
        return self._batch * per * 4  # float32 worst case; uint8 uses 1/4

    def _ensure_ring(self):
        if self._ring is None:
            # at least one owned slot per possible active worker
            # (k = slots // n_active >= 1 in every epoch order)
            self._ring = ShmRing(max(self._qsize, self._pool.size),
                                 self._slot_bytes())
        return self._ring

    def _start(self):
        """Submit this epoch's work order (or prime the serial path)."""
        epoch = self._epoch
        self._epoch += 1
        self._epoch_playing = epoch
        self._epoch_started = True
        self._perm = (_epoch_perm(len(self._files), self._seed, epoch)
                      if self._shuffle else None)
        start, self._start_from = self._start_from, 0
        self._next_seq = start
        self._reorder = {}
        self._done = 0
        if self._transport == "serial":
            self._started = False
            self._job = None
            return
        from deeplearning4j_tpu_torch.telemetry import tracing

        order = {
            "spec": self._register_spec(),
            "seed": self._seed, "epoch": epoch,
            "shuffle": self._shuffle,
            "n_batches": self._n_batches,
            "batch_size": self._batch,
            "n_active": max(1, min(self._pool.size,
                                   self._n_batches - start)),
            "start": start,
            "stall": self._stall,
            "ring": (self._ensure_ring().descriptor
                     if self._transport == "shm" else None),
            # (trace_id, span_id) of the sampled training trace, or
            # None: workers decode under this identity and ship
            # etl.decode span records back beside their batches
            "trace": tracing.current_ids(),
        }
        self._job = self._pool.submit_epoch(order)
        self._started = True

    def _register_spec(self):
        if self._spec_id is None:
            self._spec_id = self._pool.register_dataset({
                "files": self._files,
                "label_idx": self._label_idx,
                "label_gen": self._label_gen,
                "loader": self._loader,
                "transform": self._transform,
            })
        return self._spec_id

    def _serial_batch(self, seq):
        """In-process fallback for one batch — same _decode_batch, same
        seeding as the workers."""
        return _decode_batch(self._files, self._label_idx,
                             self._label_gen, self._loader,
                             self._transform, self._batch, seq,
                             self._seed, self._epoch_playing, self._perm)

    def _handle(self, msg, drain=False):
        """Process one pool message (all bookkeeping lives here: done
        accounting, credit recycling, slot turnover). An "error" is
        ALSO its worker's terminal marker — counting it toward _done is
        what lets drains/finishes complete immediately instead of
        waiting out the stall timeout for a done that will never
        come."""
        kind, job = msg[0], msg[1]
        if kind == "span":
            # worker-produced span record (holds no credit, no slot):
            # materialize it into the parent's tracer ring — stale-job
            # and drain spans are simply dropped
            if job == self._job and not drain:
                from deeplearning4j_tpu_torch.telemetry import tracing

                tracing.ingest(msg[2])
            return False
        if kind == "error":
            if msg[4]:   # the failing worker held an unconsumed credit
                self._pool.release_credit()
            if job == self._job:
                self._done += 1
                if not drain:
                    raise RuntimeError(
                        f"image worker {msg[2]} failed: {msg[3]}")
            return False
        if kind == "done":
            if job == self._job:
                self._done += 1
            return True
        # batch
        _, _, seq, shm_ref, feats, idxs = msg
        stale = job != self._job or drain
        if shm_ref is not None:
            ring_name, slot, shape, dtype_char = shm_ref
            mine = (self._ring is not None
                    and ring_name == self._ring.shm.name)
            if not mine:
                stale = True
            if stale:
                if mine:
                    self._ring.free(slot)
                self._pool.release_credit()
                return False
            # the batch PARKS in its ring slot until next() consumes it
            # (no copy here), and its credit is released NOW: the slot
            # block (freed at consumption) is the shm memory bound, so
            # holding the credit while parked adds nothing — and would
            # let run-ahead workers pin every credit while the worker
            # producing the parent's next needed batch starves in
            # acquire(). Deadlock-free: the parent consumes seqs in
            # order, so the batch it blocks on always finds its owner's
            # slot block free and a credit released here.
            self._pool.release_credit()
            self._reorder[seq] = (shm_ref, idxs)
            return True
        if stale:
            self._pool.release_credit()
            return False
        # queue-transport batches keep their credit until next()
        # consumes them: the decoded payload sits on the host heap, so
        # the credit IS the memory bound (the pre-rebuild
        # mp.Queue(maxsize=queueSize) contract) — releasing on receipt
        # would let a straggler-stalled epoch park unboundedly many
        # float batches in the reorder dict
        self._reorder[seq] = (None, feats, idxs)
        return True

    def _pump(self):
        """Block until self._next_seq lands in the reorder buffer,
        draining pool messages (gap detection:
        all workers done + target seq missing raises immediately
        instead of spinning into the stall timeout)."""
        deadline = time.monotonic() + self._stall
        while self._next_seq not in self._reorder:
            if self._done >= self._pool.size:
                raise RuntimeError(
                    f"all ETL workers finished epoch "
                    f"{self._epoch_playing} but batch {self._next_seq} "
                    f"was never produced (worker crash gap)")
            try:
                msg = self._pool.results().get(
                    timeout=min(5.0, self._stall))
            except queue_mod.Empty:
                dead = self._pool.dead_workers()
                if dead:
                    raise RuntimeError(
                        f"{len(dead)} ETL worker(s) died "
                        f"(exitcodes {[p.exitcode for p in dead]}) "
                        f"without reporting an error")
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"image workers stalled (> {self._stall:.0f} s; "
                        f"configure with stallTimeout=)")
                continue
            self._handle(msg)

    # -- iteration -----------------------------------------------------------
    def hasNext(self):
        if not self._epoch_started:
            return self._start_from < self._n_batches
        return self._next_seq < self._n_batches

    def next(self):
        if not self.hasNext():
            raise StopIteration
        if not self._epoch_started:
            self._start()
        if self._transport == "serial":
            feats, idxs = self._serial_batch(self._next_seq)
        else:
            self._pump()
            entry = self._reorder.pop(self._next_seq)
            if entry[0] is not None:
                # ring-parked batch: fused copy+cast out of the slot,
                # then recycle the slot (its credit was released at
                # park time — see _handle)
                (_, slot, shape, dchar), idxs = entry
                cast = np.float32 if self._float_out else None
                feats = self._ring.read(slot, shape, np.dtype(dchar),
                                        cast=cast)
                self._ring.free(slot)
            else:
                _, feats, idxs = entry
                self._pool.release_credit()
        self._next_seq += 1
        if self._next_seq >= self._n_batches:
            self._finish_epoch()
        if self._float_out and feats.dtype != np.float32:
            feats = feats.astype(np.float32)
        labels = np.zeros((feats.shape[0], len(self._labels)), np.float32)
        labels[np.arange(feats.shape[0]), idxs] = 1.0
        if self._prefetch:
            import torch

            from deeplearning4j_tpu_torch.backend import resolve_device
            from deeplearning4j_tpu_torch.datasets.prefetch import (
                staged_dataset)

            device = resolve_device(None)
            ds = staged_dataset(torch.from_numpy(feats).to(device),
                                torch.from_numpy(labels).to(device))
        else:
            ds = DataSet(feats, labels)
        if self.preProcessor is not None:
            self.preProcessor.preProcess(ds)
        return ds

    def _pool_live(self):
        return (self._pool is not None and not self._pool._closed
                and self._pool._procs)

    def _finish_epoch(self):
        """Collect the epoch's remaining pool messages (done markers —
        all batches are consumed by now) so the pool is quiescent
        before the next work order."""
        self._quiesce()

    def _drain_epoch(self):
        """Abandon an in-flight epoch: cancel the order (workers stop
        within one batch) and consume everything still in flight,
        recycling slots and credits, so the pool is reusable (reset
        mid-epoch, exceptions, close)."""
        if self._started and self._pool_live():
            self._pool.cancel_job(self._job)
        self._quiesce()
        for entry in self._reorder.values():
            if entry[0] is not None:  # parked shm batch holds its slot
                if self._ring is not None:
                    self._ring.free(entry[0][1])
            elif self._pool is not None and not self._pool._closed:
                # parked queue batch still holds its credit
                self._pool.release_credit()
        self._reorder = {}

    def _quiesce(self):
        """Pump pool messages in drain mode until every worker's
        terminal marker (done or error) for the current job arrived."""
        if self._started and self._pool_live():
            deadline = time.monotonic() + self._stall
            while self._done < self._pool.size:
                try:
                    msg = self._pool.results().get(timeout=1.0)
                except queue_mod.Empty:
                    if self._pool.dead_workers() or \
                            time.monotonic() > deadline:
                        break
                    continue
                self._handle(msg, drain=True)
        self._started = False
        self._job = None

    def reset(self):
        self._drain_epoch()
        self._epoch_started = False
        self._next_seq = 0
        self._start_from = 0

    def close(self):
        """Release pool + ring resources. The iterator is dead after
        this (persistent-pool lifecycle is explicit; __del__ is the
        best-effort fallback)."""
        try:
            self._drain_epoch()
        except Exception:
            pass
        if self._ring is not None:
            if self._pool is not None and not self._pool._closed \
                    and self._pool._procs:
                self._pool.broadcast(("close_ring", self._ring.shm.name))
            self._ring.close()
            self._ring = None
        if self._pool is not None:
            if self._spec_id is not None and not self._own_pool \
                    and not self._pool._closed and self._pool._procs:
                self._pool.broadcast(("drop_dataset", self._spec_id))
            if self._own_pool:
                self._pool.shutdown()
            self._pool = None

    def __del__(self):  # best-effort cleanup
        try:
            self.close()
        except Exception:
            pass
