"""Process-wide metrics registry: Counter, Gauge, Histogram and Timer.

Counterpart of the core of ``deeplearning4j_tpu/telemetry/registry.py``:
the module switch (``enabled``/``enable``/``disable``), the process
registry (``get_registry``/``set_registry``), the metric families and
``MetricsRegistry.snapshot()``; the text exposition is
``telemetry.prometheus.render``. Every name, label key and number format
is the JAX package's, so the same calls give the same snapshot and the
same exposition text.

- A loop that finds telemetry disabled (one ``enabled()`` check a fit)
  makes no registry call a step.
- Histogram buckets are fixed and log-scale: ``observe`` is a bisect and
  two adds.
- Nothing here touches a device.
- A Timer is also a ``torch.profiler.record_function`` range, the
  counterpart of the reference's ``jax.profiler.TraceAnnotation``.

The serving instrument set (``ServingInstruments``,
``serving_instruments``) is the reference's, family for family. The loop,
ETL and fleet instrument sets, the compile hook and the device-memory
gauges come with the telemetry slice (ROADMAP.md, queue 1 item 13).
"""

from __future__ import annotations

import math
import threading
import time
from bisect import bisect_right

# -- module state ------------------------------------------------------------

_state = {"enabled": True, "registry": None}
_lock = threading.Lock()


def enabled() -> bool:
    return _state["enabled"]


def enable():
    _state["enabled"] = True
    return get_registry()


def disable():
    _state["enabled"] = False


def get_registry() -> "MetricsRegistry":
    """The process-wide registry (created lazily)."""
    reg = _state["registry"]
    if reg is None:
        with _lock:
            reg = _state["registry"]
            if reg is None:
                reg = MetricsRegistry()
                _state["registry"] = reg
    return reg


def set_registry(registry):
    """Swap the process registry (tests: counting stubs). Returns the
    previous registry."""
    prev = _state["registry"]
    _state["registry"] = registry
    return prev


# -- label handling ----------------------------------------------------------

def _label_key(labelnames, labels):
    if sorted(labels) != sorted(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} do not match declared labelnames "
            f"{sorted(labelnames)}")
    return tuple((k, str(labels[k])) for k in labelnames)


class _Family:
    """One named metric family; unlabeled families hold their values
    directly, labeled ones hand out per-labelset children. `local` marks
    host-specific families (per-device gauges) that exporters render but
    snapshot()/aggregation skip — their label sets differ per host,
    which would break the identical-key-set aggregation contract."""

    kind = "untyped"

    def __init__(self, name, help="", labelnames=()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.local = False
        self._children = {}
        self._lock = threading.Lock()

    def labels(self, **labels):
        key = _label_key(self.labelnames, labels)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._make_child()
                    self._children[key] = child
        return child

    def children(self):
        """[(labels_tuple, child)] — the unlabeled family yields itself
        under the empty labelset once it has been touched."""
        if self.labelnames:
            # copy under the lock: a /metrics scrape (UI server thread)
            # must not race a training thread's first labels() call
            with self._lock:
                return sorted(self._children.items())
        return [((), self)]

    def reset(self):
        with self._lock:
            self._children.clear()
        self._reset_self()


class Counter(_Family):
    """Monotonic counter. `inc(v)` with v >= 0."""

    kind = "counter"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self.value = 0.0

    def _make_child(self):
        return Counter(self.name)

    def _reset_self(self):
        self.value = 0.0

    def inc(self, amount=1.0):
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        self.value += amount


class Gauge(_Family):
    """Last-value gauge."""

    kind = "gauge"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self.value = 0.0

    def _make_child(self):
        return Gauge(self.name)

    def _reset_self(self):
        self.value = 0.0

    def set(self, value):
        self.value = float(value)

    def inc(self, amount=1.0):
        self.value += amount

    def dec(self, amount=1.0):
        self.value -= amount


def log_buckets(lo, hi, per_decade=4):
    """Fixed log-scale bucket upper bounds covering [lo, hi]."""
    if not (lo > 0 and hi > lo):
        raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
    n = int(math.ceil(math.log10(hi / lo) * per_decade)) + 1
    # 3 significant digits keep the exposition readable; per_decade <= 10
    # keeps rounded bounds strictly increasing
    return tuple(float(f"{lo * 10 ** (i / per_decade):.3g}")
                 for i in range(n))


# seconds: 100 us .. ~1000 s; bytes: 1 KiB .. ~64 GiB
SECONDS_BUCKETS = log_buckets(1e-4, 1e3, per_decade=4)
BYTES_BUCKETS = tuple(float(1 << (10 + 2 * i)) for i in range(14))


class Histogram(_Family):
    """Cumulative histogram over fixed bucket upper bounds (log-scale by
    default). observe() is allocation-free: one bisect into the
    precomputed bounds + integer adds."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets=SECONDS_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"histogram {name}: buckets must be "
                             "strictly increasing")
        # counts[i] = observations <= buckets[i]; counts[-1] = +Inf bucket
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        # bucket_index -> (trace_id, value, wall_ts): the last sampled
        # trace that landed in each bucket (OpenMetrics exemplars: a
        # p99 bucket links to a concrete span tree). Lazily
        # allocated; never part of snapshot()/aggregation.
        self.exemplars = None

    def _make_child(self):
        return Histogram(self.name, buckets=self.buckets)

    def _reset_self(self):
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.exemplars = None

    def observe(self, value, exemplar=None):
        idx = bisect_right(self.buckets, value)
        self.counts[idx] += 1
        self.sum += value
        if exemplar is not None:
            if self.exemplars is None:
                self.exemplars = {}
            self.exemplars[idx] = (exemplar, value, time.time())

    @property
    def count(self):
        return sum(self.counts)

    def time(self, annotation=None):
        """A Timer span feeding this histogram (and the profiler trace)."""
        return Timer(self, annotation or self.name)


class Timer:
    """Span context: wall-clock into a Histogram and a
    ``torch.profiler.record_function`` range, so the host span lands in a
    profiler trace beside the device work it covers. Reusable (one
    observation a with-block); with histogram=None a pure trace range."""

    __slots__ = ("histogram", "name", "exemplar", "_t0", "_ann")

    def __init__(self, histogram, name):
        self.histogram = histogram
        self.name = name
        self.exemplar = None   # trace id attached to the observation
        self._t0 = 0.0
        self._ann = None

    def __enter__(self):
        from torch.profiler import record_function

        self._ann = record_function(self.name)
        self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._ann is not None:
            self._ann.__exit__(*exc)
            self._ann = None
        if self.histogram is not None:
            self.histogram.observe(dt, exemplar=self.exemplar)
        return False


def span(name):
    """A trace range with no metric: a host-side phase marker."""
    return Timer(None, name)


# -- registry ----------------------------------------------------------------

class MetricsRegistry:
    """Name -> metric family. Re-registering an existing name returns
    the existing family (and rejects a kind/labelnames mismatch), so
    every module can declare its instruments idempotently."""

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        fam = self._metrics.get(name)
        if fam is not None:
            if not isinstance(fam, cls) or \
                    fam.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{fam.kind} with labels {fam.labelnames}")
            return fam
        with self._lock:
            fam = self._metrics.get(name)
            if fam is None:
                fam = cls(name, help, labelnames, **kw)
                self._metrics[name] = fam
            return fam

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=SECONDS_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def timer(self, name, help="", labelnames=(),
              buckets=SECONDS_BUCKETS) -> Timer:
        """Timer over a same-named histogram (seconds)."""
        return self.histogram(name, help, labelnames, buckets).time()

    def collect(self):
        """Metric families, name-sorted (exporter entry point). Copied
        under the lock so a concurrent first-time registration cannot
        resize the dict mid-iteration."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def reset(self):
        for fam in self.collect():
            fam.reset()

    # -- snapshot (the aggregation/exchange format) --------------------------
    def snapshot(self) -> dict:
        """Flat {sample_name: float} of every sample, histogram buckets
        included — the unit of multi-host aggregation. Keys are
        Prometheus sample names with sorted label sets, so identical
        instrument sets on every host produce identical key order.
        Families marked local (device-memory gauges) are skipped: their
        per-host label sets would defeat cross-host aggregation."""
        out = {}
        for fam in self.collect():
            if fam.local:
                continue
            for labels, child in fam.children():
                base = _sample_name(fam.name, labels)
                if fam.kind == "histogram":
                    acc = 0
                    for b, c in zip(child.buckets, child.counts):
                        acc += c
                        out[_sample_name(fam.name + "_bucket",
                                         labels + (("le", fmt_float(b)),)
                                         )] = float(acc)
                    out[_sample_name(fam.name + "_bucket",
                                     labels + (("le", "+Inf"),))] = \
                        float(child.count)
                    out[_sample_name(fam.name + "_sum", labels)] = \
                        float(child.sum)
                    out[_sample_name(fam.name + "_count", labels)] = \
                        float(child.count)
                else:
                    out[base] = float(child.value)
        return out


# -- the serving instrument set ----------------------------------------------

SERVING_REQUESTS_HELP = ("Inference requests by terminal outcome "
                         "(ok|timeout_queued|timeout_execute|rejected|"
                         "shed|error|shutdown)")
SERVING_QUEUE_HELP = "Seconds a request waited in the batching queue"
SERVING_EXECUTE_HELP = ("Seconds per coalesced device dispatch (pad + "
                        "execute + split, host-visible)")
SERVING_OCCUPANCY_HELP = ("Real rows / bucket rows of the last coalesced "
                          "dispatch (1.0 = perfectly filled bucket)")
SERVING_DISPATCH_HELP = "Coalesced device dispatches executed"
SERVING_DEPTH_HELP = "Requests currently queued for batching"
SERVING_STEALS_HELP = ("Batches executed by a replica that stole them "
                       "from a sibling's run queue")
SERVING_REPLICA_LOAD_HELP = ("Queued + in-flight batches per replica "
                             "(-1 = replica dead)")
SERVING_SHED_HELP = ("Requests shed by admission control, by priority "
                     "class (HTTP 429 + Retry-After)")
SERVING_TOKENS_HELP = "Tokens emitted by continuous-batching decode"
SERVING_SLOTS_HELP = ("Decode slots currently occupied by in-flight "
                      "sequences")
SERVING_PREFIX_HITS_HELP = ("Decode admissions that adopted cached "
                            "prefix KV pages (prefill skipped for the "
                            "shared prefix)")
SERVING_PREFIX_MISSES_HELP = ("Decode admissions with no cached "
                              "prefix pages to adopt")
DECODE_TTFT_HELP = ("Seconds from decode submit to the request's "
                    "first emitted token")
DECODE_ACCEPTED_HELP = ("Speculative-decode tokens by outcome: "
                        "accepted (emitted via a verify call), "
                        "rejected (drafted but refuted), fallback "
                        "(emitted by plain decode while speculation "
                        "is in acceptance fallback)")
SERVING_KV_OCCUPANCY_HELP = ("Fraction of the paged decode KV pool "
                             "currently reserved (0..1)")


class ServingInstruments:
    """Bound per-model serving instruments: obtained once per model,
    None when telemetry is disabled, so a disabled serving path performs
    zero registry calls per request."""

    __slots__ = ("model", "_requests", "queue_wait", "execute",
                 "occupancy", "dispatch", "depth", "steals",
                 "_replica_load", "_shed", "tokens", "slots",
                 "prefix_hits", "prefix_misses", "ttft", "_accepted",
                 "kv_occupancy")

    def __init__(self, registry, model):
        self.model = model
        self._requests = registry.counter(
            "dl4j_serving_requests_total", SERVING_REQUESTS_HELP,
            ("model", "outcome"))
        self.queue_wait = registry.histogram(
            "dl4j_serving_queue_wait_seconds", SERVING_QUEUE_HELP,
            ("model",)).labels(model=model)
        self.execute = registry.histogram(
            "dl4j_serving_execute_seconds", SERVING_EXECUTE_HELP,
            ("model",)).labels(model=model)
        self.occupancy = registry.gauge(
            "dl4j_serving_batch_occupancy", SERVING_OCCUPANCY_HELP,
            ("model",)).labels(model=model)
        self.dispatch = registry.counter(
            "dl4j_serving_dispatch_total", SERVING_DISPATCH_HELP,
            ("model",)).labels(model=model)
        self.depth = registry.gauge(
            "dl4j_serving_queue_depth", SERVING_DEPTH_HELP,
            ("model",)).labels(model=model)
        self.steals = registry.counter(
            "dl4j_serving_steals_total", SERVING_STEALS_HELP,
            ("model",)).labels(model=model)
        self._replica_load = registry.gauge(
            "dl4j_serving_replica_load", SERVING_REPLICA_LOAD_HELP,
            ("model", "replica"))
        self._shed = registry.counter(
            "dl4j_serving_shed_total", SERVING_SHED_HELP,
            ("model", "priority"))
        self.tokens = registry.counter(
            "dl4j_serving_decode_tokens_total", SERVING_TOKENS_HELP,
            ("model",)).labels(model=model)
        self.slots = registry.gauge(
            "dl4j_serving_decode_slots", SERVING_SLOTS_HELP,
            ("model",)).labels(model=model)
        self.prefix_hits = registry.counter(
            "dl4j_serving_prefix_hits_total", SERVING_PREFIX_HITS_HELP,
            ("model",)).labels(model=model)
        self.prefix_misses = registry.counter(
            "dl4j_serving_prefix_misses_total",
            SERVING_PREFIX_MISSES_HELP, ("model",)).labels(model=model)
        self.ttft = registry.histogram(
            "dl4j_decode_ttft_seconds", DECODE_TTFT_HELP,
            ("model",)).labels(model=model)
        self._accepted = registry.counter(
            "dl4j_decode_accepted_tokens_total", DECODE_ACCEPTED_HELP,
            ("model", "outcome"))
        self.kv_occupancy = registry.gauge(
            "dl4j_serving_kv_page_occupancy",
            SERVING_KV_OCCUPANCY_HELP, ("model",)).labels(model=model)

    def request(self, outcome):
        self._requests.labels(model=self.model, outcome=outcome).inc()

    def replica_load(self, replica):
        return self._replica_load.labels(model=self.model,
                                         replica=replica)

    def shed(self, priority):
        self._shed.labels(model=self.model, priority=priority).inc()

    def accepted(self, outcome, n=1):
        self._accepted.labels(model=self.model, outcome=outcome).inc(n)


def serving_instruments(model):
    """Per-model serving instrument bundle, or None when disabled."""
    if not _state["enabled"]:
        return None
    return ServingInstruments(get_registry(), model)


def _sample_name(name, labels):
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


def fmt_float(v):
    """Canonical number formatting shared by snapshot keys and the
    Prometheus exposition (integers render bare, le bounds stay short)."""
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))
