"""InferenceSession: the one-call serving facade.

    from deeplearning4j_tpu_torch.serving import InferenceSession

    session = InferenceSession()                 # serves on the GPU
    session.register("charrnn", net, example_shape=(77, 100), warmup=True)
    y = session.predict("charrnn", x)            # sync, batched, bucketed
    f = session.predict_async("charrnn", x)      # concurrent callers coalesce

    session.register_decoder("stream", RnnDecodeModel(net, max_slots=32))
    tokens = session.decode("stream", prompt_ids, 64)   # continuous batching

Counterpart of ``deeplearning4j_tpu/serving/session.py``. Every model
gets its own DynamicBatcher (worker thread) created lazily on first
predict; `batching=False` (or per-call `batched=False`) runs the caller's
thread straight through the bucketed servable. Token streams go through
a continuous-batching `DecodeEngine` per decoder (`register_decoder`,
`decode`). With an `AdmissionController` (``admission=``), `predict`,
`predict_async`, the direct path and `decode` are admitted or shed by
priority class before they take a queue slot. ``register(...,
replicas=N)`` serves a model through a work-stealing `ReplicaSet` of N
replicas, each with its own CUDA stream (serving/replica.py). The
serving instruments (``dl4j_serving_*``) record per model while
telemetry is enabled, a sampled request's spans join its trace, and
``health_details`` reports the replica sets and decoders. The session
serves on one device ("cuda" unless the caller names another) and takes
only models and decode models that live there.
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
from deeplearning4j_tpu_torch.serving.registry import (
    ModelNotFound, ModelRegistry)
from deeplearning4j_tpu_torch.serving.replica import ReplicaSet
from deeplearning4j_tpu_torch.telemetry import flight, tracing
from deeplearning4j_tpu_torch.telemetry import registry as _telemetry


class InferenceSession:
    def __init__(self, registry: ModelRegistry | None = None,
                 max_latency=0.002, queue_size=256, default_timeout=30.0,
                 batching=True, device=None, admission=None):
        self.device = resolve_device(device)
        self.registry = registry or ModelRegistry()
        self.max_latency = max_latency
        self.queue_size = queue_size
        self.default_timeout = default_timeout
        self.batching = batching
        self.admission = admission   # AdmissionController or None
        self._batchers: dict[tuple, DynamicBatcher] = {}
        self._replica_spec: dict = {}  # (name, version) -> (n, devices)
        self._decoders: dict = {}      # name -> DecodeEngine
        self._instruments: dict = {}   # per-model bundle, built once
        self._lock = threading.Lock()
        self._closed = False

    # -- registry passthrough ------------------------------------------------
    def register(self, name, model, replicas=None, devices=None, **kw):
        """See ModelRegistry.register. The model must live on the
        session's device. Re-registering retires the model's old batchers:
        new predicts bind the new entry while already-queued requests
        finish on the old servable (rolling update).

        `replicas=N` (or an explicit `devices` list, each the session's
        device) executes this model through a work-stealing ReplicaSet:
        N replicas of the servable, each with its own CUDA stream and run
        queue (see serving/replica.py). The batcher thread then only
        coalesces; dispatches run on the replica workers."""
        dev = getattr(model, "device", None)
        if dev is not None and dev != self.device:
            raise ValueError(f"model {name!r} lives on {dev}; this session "
                             f"serves on {self.device}")
        entry = self.registry.register(name, model, **kw)
        with self._lock:
            stale = [k for k in self._batchers if k[0] == name]
            dropped = [self._batchers.pop(k) for k in stale]
            # specs of superseded versions leak across rolling updates
            # otherwise: sweep every spec for this name first
            for k in [k for k in self._replica_spec if k[0] == name]:
                del self._replica_spec[k]
            if replicas is not None or devices is not None:
                self._replica_spec[(name, entry.version)] = (replicas,
                                                             devices)
        for b in dropped:
            b.retire()
        if entry.warmed and (name, entry.version) in self._replica_spec:
            # build the ReplicaSet (and its N-replica ladder warmup) NOW,
            # not lazily under the session lock on the first predict:
            # ready() keeps meaning "no cold warm run in any request's
            # latency path"
            self._batcher(name, entry)
        flight.record("model_registered", model=name,
                      version=entry.version, warmed=entry.warmed,
                      replicas=replicas)
        return entry

    def register_decoder(self, name, model, warmup=True, **kw):
        """Attach a continuous-batching DecodeEngine under `name`.
        `model` is a decode model (RnnDecodeModel / TransformerDecodeModel)
        on the session's device, or an already-built DecodeEngine. Engine
        kwargs pass through: ``chunk=64`` (chunked prefill),
        ``prefix_cache=True``, ``speculative=SpeculativeConfig(draft,
        k)``."""
        from deeplearning4j_tpu_torch.serving.decode import DecodeEngine

        engine_model = model.model if isinstance(model, DecodeEngine) \
            else model
        dev = getattr(engine_model, "device", None)
        if dev is not None and dev != self.device:
            raise ValueError(f"decode model {name!r} lives on {dev}; this "
                             f"session serves on {self.device}")
        if isinstance(model, DecodeEngine):
            engine = model
        else:
            engine = DecodeEngine(model, name=name,
                                  instruments=lambda: self._inst(name),
                                  **kw)
        if warmup and not engine._warmed:
            engine.warmup()
        with self._lock:
            old = self._decoders.get(name)
            self._decoders[name] = engine
        if old is not None and old is not engine:
            old.close()
        flight.record("decoder_registered", model=name,
                      slots=engine.model.max_slots)
        return engine

    def unregister_decoder(self, name):
        """Detach (and close) the decode engine under `name`. Raises
        ModelNotFound when no such decoder exists."""
        with self._lock:
            engine = self._decoders.pop(name, None)
        if engine is None:
            raise ModelNotFound(name)
        engine.close()
        flight.record("decoder_unregistered", model=name)

    def decoder(self, name):
        engine = self._decoders.get(name)
        if engine is None:
            raise ModelNotFound(name)
        return engine

    def decode(self, name, prompt, max_new_tokens, eos_id=None,
               timeout=None, priority="normal", timing=None):
        """Generated token ids for one prompt through the continuous
        batcher (admission-controlled like predict). ``timing`` (a dict)
        receives the request's ``ttft`` seconds."""
        if self._closed:
            raise RuntimeError("session closed")
        engine = self.decoder(name)
        ticket = None
        if self.admission is not None:
            ticket = self._admit_traced(name, priority)
        try:
            req = engine.submit(prompt, max_new_tokens, eos_id=eos_id)
            if ticket is not None:
                # bind as a default: the variable is nulled on the next
                # line, and a late-bound closure would call None.release
                req.future.add_done_callback(
                    lambda f, t=ticket: t.release())
                ticket = None
            try:
                tokens = req.result(timeout=timeout)
            except _FutureTimeout:
                raise ServingTimeout(
                    f"decode on {name!r} timed out after {timeout}s"
                ) from None
            if timing is not None:
                # read AFTER the result: t_first is written by the engine
                # thread at first-token emission
                timing["ttft"] = ((req.t_first or time.perf_counter())
                                  - req.t_submit)
            return tokens
        finally:
            if ticket is not None:
                ticket.release()

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
    def _inst(self, name):
        """Per-model ServingInstruments: None whenever telemetry is
        disabled (the flag is re-checked on every call so toggling
        mid-flight is honored); the bound bundle itself is built once."""
        if not _telemetry.enabled():
            return None
        inst = self._instruments.get(name)
        if inst is None:
            inst = _telemetry.serving_instruments(name)
            self._instruments[name] = inst
        return inst

    def _admit_traced(self, name, priority):
        """admission.admit with a span on the sampled path: the ticket
        decision is the first hop of the request's span tree (sheds
        raise and the span records status=error, naming the 429)."""
        ctx = tracing.current()
        if ctx is None:
            return self.admission.admit(name, priority,
                                        inst=self._inst(name))
        t0 = time.perf_counter()
        try:
            ticket = self.admission.admit(name, priority,
                                          inst=self._inst(name))
        except Exception as e:
            tracing.emit("serving.admission", ctx, t0,
                         time.perf_counter(), status="error",
                         priority=priority,
                         error=f"{type(e).__name__}: {e}")
            raise
        tracing.emit("serving.admission", ctx, t0, time.perf_counter(),
                     priority=priority)
        return ticket

    def _batcher(self, name, entry) -> DynamicBatcher:
        """One batcher per served (name, version): pinned-version requests
        coalesce among themselves, never across versions. Models
        registered with replicas= get a ReplicaSet executor."""
        key = (name, entry.version)
        b = self._batchers.get(key)
        if b is None:
            with self._lock:
                b = self._batchers.get(key)
                if b is None:
                    executor = None
                    spec = self._replica_spec.get(key)
                    if spec is not None:
                        n, devices = spec
                        executor = ReplicaSet(
                            entry, n_replicas=n, devices=devices,
                            instruments=lambda: self._inst(name))
                    b = DynamicBatcher(
                        entry, max_latency=self.max_latency,
                        queue_size=self.queue_size,
                        default_timeout=self.default_timeout,
                        instruments=lambda: self._inst(name),
                        executor=executor)
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
        model (and version) coalesce into shared device dispatches. With
        an AdmissionController attached, the request is admitted (or shed
        with ShedError) BEFORE it takes a queue slot; its ticket releases
        when the future goes terminal."""
        if self._closed:
            raise RuntimeError("session closed")
        entry, x, single = self._prep(name, features, version)
        ticket = None
        if self.admission is not None:
            ticket = self._admit_traced(name, priority)
        try:
            future = self._batcher(name, entry).submit(
                x, timeout=timeout, priority=priority)
        except Exception:
            if ticket is not None:
                ticket.release()
            raise
        if ticket is not None:
            future.add_done_callback(lambda f: ticket.release())
        if not single:
            return future
        out = Future()
        out.set_running_or_notify_cancel()

        def _done(f):
            e = f.exception()
            if e is not None:
                out.set_exception(e)
            else:
                timing = getattr(f, "dl4j_timing", None)
                if timing is not None:   # before set_result: see batcher
                    out.dl4j_timing = timing
                out.set_result(f.result()[0])

        future.add_done_callback(_done)
        return out

    def predict(self, name, features, timeout=None, batched=None,
                version=None, priority="normal", timing=None):
        """Synchronous predict. `batched=False` bypasses the queue and
        runs the bucketed servable on the calling thread. ``timing`` (a
        dict) is filled with the request's ``queue`` and ``execute``
        seconds, so the HTTP layer can return them in a Server-Timing
        header; the direct path has no queue phase (``queue`` 0.0)."""
        if timeout is None:
            timeout = self.default_timeout
        use_batcher = self.batching if batched is None else batched
        if not use_batcher:
            return self._direct(name, features, version,
                                priority=priority, timing=timing)
        t0 = time.perf_counter()
        future = self.predict_async(name, features, timeout=timeout,
                                    version=version, priority=priority)
        budget = (None if timeout is None
                  else max(0.0, timeout - (time.perf_counter() - t0)) + 0.25)
        try:
            out = future.result(timeout=budget)
            if timing is not None:
                timing.update(getattr(future, "dl4j_timing", None) or {})
            return out
        except _FutureTimeout:
            raise ServingTimeout(
                f"request to {name!r} timed out after {timeout}s") from None

    def _direct(self, name, features, version=None, priority="normal",
                timing=None):
        if self._closed:
            raise RuntimeError("session closed")
        entry, x, single = self._prep(name, features, version)
        inst = self._inst(name)
        if self.admission is not None:
            with self.admission.admit(name, priority, inst=inst):
                return self._direct_run(entry, x, single, inst, timing)
        return self._direct_run(entry, x, single, inst, timing)

    def _direct_run(self, entry, x, single, inst, timing=None):
        t = x.shape[-1] if x.ndim >= 3 else None
        t0 = time.perf_counter()
        try:
            y, n_dispatch, _ = execute_plan(entry, x)
        except Exception:
            if inst is not None:
                inst.request("error")
            raise
        dt = time.perf_counter() - t0
        if timing is not None:   # unbatched: no queue phase by design
            timing.update({"queue": 0.0, "execute": round(dt, 6)})
        if inst is not None:
            inst.execute.observe(dt)
            inst.dispatch.inc(n_dispatch)
            inst.request("ok")
        y = unpad(y, y.shape[0], t)
        return y[0] if single else y

    # -- introspection / lifecycle -------------------------------------------
    def health_details(self) -> dict:
        """Replica-set and decode-engine liveness for a health endpoint:
        a dead replica or a decode slot wedged past its deadline marks
        the matching section degraded (capacity is reduced, traffic
        still flows). Each replica set also says what its replicas hold:
        the streams they run on and the staging bytes each owns beside
        the parameters they share. The reference's ``sharded`` section
        (mesh-sharded servables and decoders) comes with the serving
        half of the parallel tier (ROADMAP.md, queue 1 item 12b)."""
        with self._lock:
            batchers = dict(self._batchers)
            decoders = dict(self._decoders)
        out: dict = {}
        replica_sets = {}
        for (name, version), b in batchers.items():
            if b.executor is None:
                continue
            reps = b.executor.replicas
            dead = [r.name for r in reps if r.dead]
            replica_sets[f"{name}:v{version}"] = {
                "replicas": len(reps), "live": len(reps) - len(dead),
                "dead": dead, "degraded": bool(dead),
                "device": str(b.entry.servable.device),
                "staging_bytes": {
                    r.name: sum(t.numel() * t.element_size() for t in
                                list(r.servable._staging.values()))
                    for r in reps},
                "streams": {r.name: (None if r.servable.stream is None
                                     else r.servable.stream.cuda_stream)
                            for r in reps}}
        if replica_sets:
            out["replica_sets"] = replica_sets
        decs = {}
        for name, engine in decoders.items():
            try:
                decs[name] = engine.health()
            except Exception:   # noqa: BLE001 - a closing engine
                continue
        if decs:
            out["decoders"] = decs
        return out

    def stats(self) -> dict:
        with self._lock:
            out = {}
            for (name, version), b in self._batchers.items():
                row = {"queue_depth": b.queue_depth()}
                if b.executor is not None:
                    row["replicas"] = {
                        r.name: {"device": str(r.device),
                                 "load": r.load(), "dead": r.dead}
                        for r in b.executor.replicas}
                out[f"{name}:v{version}"] = row
            if self.admission is not None:
                out["admission"] = self.admission.describe()
            return out

    def close(self):
        self._closed = True
        with self._lock:
            batchers, self._batchers = list(self._batchers.values()), {}
            decoders, self._decoders = list(self._decoders.values()), {}
        for b in batchers:
            b.close()
        for d in decoders:
            d.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
