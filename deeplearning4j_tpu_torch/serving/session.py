"""InferenceSession: the one-call serving facade.

    from deeplearning4j_tpu_torch.serving import InferenceSession

    session = InferenceSession()                 # serves on the GPU
    session.register("charrnn", net, example_shape=(77, 100), warmup=True)
    y = session.predict("charrnn", x)            # sync, batched, bucketed
    f = session.predict_async("charrnn", x)      # concurrent callers coalesce

Counterpart of ``deeplearning4j_tpu/serving/session.py``. Every model
gets its own DynamicBatcher (worker thread) created lazily on first
predict; `batching=False` (or per-call `batched=False`) runs the caller's
thread straight through the bucketed servable. The session serves on one
device ("cuda" unless the caller names another) and takes only models
that live there. Replicas, decoders, admission control and telemetry come
with later slices.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout

import numpy as np

from deeplearning4j_tpu_torch.backend import resolve_device
from deeplearning4j_tpu_torch.serving.batcher import (
    DynamicBatcher, ServingTimeout, execute_plan)
from deeplearning4j_tpu_torch.serving.buckets import unpad
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry


class InferenceSession:
    def __init__(self, registry: ModelRegistry | None = None,
                 max_latency=0.002, queue_size=256, default_timeout=30.0,
                 batching=True, device=None):
        self.device = resolve_device(device)
        self.registry = registry or ModelRegistry()
        self.max_latency = max_latency
        self.queue_size = queue_size
        self.default_timeout = default_timeout
        self.batching = batching
        self._batchers: dict[tuple, DynamicBatcher] = {}
        self._lock = threading.Lock()
        self._closed = False

    # -- registry passthrough ------------------------------------------------
    def register(self, name, model, **kw):
        """See ModelRegistry.register. The model must live on the
        session's device. Re-registering retires the model's old batchers:
        new predicts bind the new entry while already-queued requests
        finish on the old servable (rolling update)."""
        dev = getattr(model, "device", None)
        if dev is not None and dev != self.device:
            raise ValueError(f"model {name!r} lives on {dev}; this session "
                             f"serves on {self.device}")
        entry = self.registry.register(name, model, **kw)
        with self._lock:
            stale = [k for k in self._batchers if k[0] == name]
            dropped = [self._batchers.pop(k) for k in stale]
        for b in dropped:
            b.retire()
        return entry

    def ready(self) -> bool:
        """Every registered model's bucket ladder has been warmed."""
        models = self.registry.describe()
        return all(m["warmed"] for m in models) if models else True

    def warmup(self, name=None, version=None):
        self.registry.warmup(name, version)
        return self

    def models(self):
        return self.registry.describe()

    # -- predict -------------------------------------------------------------
    def _batcher(self, name, entry) -> DynamicBatcher:
        """One batcher per served (name, version): pinned-version requests
        coalesce among themselves, never across versions."""
        key = (name, entry.version)
        with self._lock:
            b = self._batchers.get(key)
            if b is None:
                b = DynamicBatcher(entry, max_latency=self.max_latency,
                                   queue_size=self.queue_size,
                                   default_timeout=self.default_timeout)
                self._batchers[key] = b
        return b

    def _prep(self, name, features, version=None):
        entry = self.registry.get(name, version)
        shape = entry.servable.example_shape
        x = np.asarray(features)
        single = x.ndim == len(shape)
        if single:
            x = x[None]
        got = tuple(x.shape[1:])
        # sequence models ([N, C, T]) may vary the trailing time axis —
        # it pads to a seq bucket; every other axis must match exactly
        ok = (got[:-1] == shape[:-1] if x.ndim >= 3 and len(got) == len(shape)
              else got == shape)
        if not ok:
            raise ValueError(
                f"model {name!r} expects examples of shape {shape}, "
                f"got {got}")
        return entry, x, single

    def predict_async(self, name, features, timeout=None, version=None,
                      priority="normal") -> Future:
        """Future of the prediction batch. Concurrent callers of the same
        model (and version) coalesce into shared device dispatches."""
        if self._closed:
            raise RuntimeError("session closed")
        entry, x, single = self._prep(name, features, version)
        future = self._batcher(name, entry).submit(
            x, timeout=timeout, priority=priority)
        if not single:
            return future
        out = Future()
        out.set_running_or_notify_cancel()

        def _done(f):
            e = f.exception()
            if e is not None:
                out.set_exception(e)
            else:
                out.set_result(f.result()[0])

        future.add_done_callback(_done)
        return out

    def predict(self, name, features, timeout=None, batched=None,
                version=None, priority="normal"):
        """Synchronous predict. `batched=False` bypasses the queue and
        runs the bucketed servable on the calling thread."""
        if timeout is None:
            timeout = self.default_timeout
        use_batcher = self.batching if batched is None else batched
        if not use_batcher:
            return self._direct(name, features, version)
        t0 = time.perf_counter()
        future = self.predict_async(name, features, timeout=timeout,
                                    version=version, priority=priority)
        budget = (None if timeout is None
                  else max(0.0, timeout - (time.perf_counter() - t0)) + 0.25)
        try:
            return future.result(timeout=budget)
        except _FutureTimeout:
            raise ServingTimeout(
                f"request to {name!r} timed out after {timeout}s") from None

    def _direct(self, name, features, version=None):
        if self._closed:
            raise RuntimeError("session closed")
        entry, x, single = self._prep(name, features, version)
        t = x.shape[-1] if x.ndim >= 3 else None
        y, _, _ = execute_plan(entry, x)
        y = unpad(y, y.shape[0], t)
        return y[0] if single else y

    # -- lifecycle -----------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {f"{name}:v{version}": {"queue_depth": b.queue_depth()}
                    for (name, version), b in self._batchers.items()}

    def close(self):
        self._closed = True
        with self._lock:
            batchers, self._batchers = list(self._batchers.values()), {}
        for b in batchers:
            b.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
