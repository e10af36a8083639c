"""Sampled end-to-end tracing: request span trees.

Counterpart of ``deeplearning4j_tpu/telemetry/tracing.py``, whole and with
the same records: metrics say *how slow*, the flight recorder *what
happened recently*; this module attributes one slow request to the queue,
thread or dispatch that ate its time.

- **trace/span ids** in W3C ``traceparent`` form (``00-<trace>-<span>-
  <flags>``): an incoming request joins an upstream trace, and a response
  can carry the header back;
- **head-based sampling**: the keep/drop decision is made ONCE when a
  trace starts (a deterministic 1-in-N counter, honoring an upstream
  sampled flag); an unsampled request performs no tracer work at all,
  since its context is ``None`` and every downstream hop guards on that;
- **explicit cross-thread propagation**: a ``SpanContext`` is plain data.
  It rides the serving ``_Request``, the replica set's ``_BatchTask`` and
  the decode request across the batcher, replica and decode threads.
  Within one thread the current context lives in a
  ``contextvars.ContextVar`` (:func:`current` / :func:`use`);
- **bounded ring**: finished spans append to a deque (no I/O, no device
  work); :func:`export_jsonl` dumps it, filterable by trace id;
- **exemplars**: the serving queue-wait and execute histograms attach the
  sampled trace id to the bucket an observation landed in.

Disabled contract: ``telemetry.disable()`` (or
``tracing.configure(enabled=False)``) makes every entry point return
``None``/``NULL`` before touching the tracer object, so a counting stub
tracer observes ZERO calls per request. Spans only ever wrap host code:
the device work is the same either way.

Quick use::

    from deeplearning4j_tpu_torch.telemetry import tracing

    tracing.configure(sample_rate=1.0)        # default 0.01 (1 in 100)
    span = tracing.start_trace("http.predict")
    with span:                                # sets the current context
        ...                                   # downstream hops nest
    print(tracing.get_tracer().dump_jsonl())
"""

from __future__ import annotations

import itertools
import json
import random
import re
import threading
import time
from collections import deque
from contextlib import contextmanager
from contextvars import ContextVar

from deeplearning4j_tpu_torch.telemetry import registry as _registry

DEFAULT_CAPACITY = 4096
DEFAULT_SAMPLE_RATE = 0.01

_state = {"enabled": True, "tracer": None, "interval": None}
_lock = threading.Lock()
_head_counter = itertools.count()
_current: ContextVar = ContextVar("dl4j_trace_ctx", default=None)

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def enabled() -> bool:
    """Tracing is live: the telemetry master switch AND the tracing
    flag (``telemetry.disable()`` compiles tracing out with the rest)."""
    return _state["enabled"] and _registry.enabled()


def configure(sample_rate=None, capacity=None, enabled=None):
    """Set the head-sampling rate (0 disables sampling, 1 keeps every
    trace), ring capacity, and/or the tracing flag."""
    if enabled is not None:
        _state["enabled"] = bool(enabled)
    if sample_rate is not None:
        rate = float(sample_rate)
        if rate <= 0.0:
            _state["interval"] = 0
        else:
            _state["interval"] = max(1, round(1.0 / min(rate, 1.0)))
    if capacity is not None:
        get_tracer().resize(int(capacity))


def sample_interval() -> int:
    """Current 1-in-N head-sampling interval (0 = never sample)."""
    iv = _state["interval"]
    if iv is None:
        iv = max(1, round(1.0 / DEFAULT_SAMPLE_RATE))
        _state["interval"] = iv
    return iv


def _head_sampled() -> bool:
    iv = sample_interval()
    if iv == 0:
        return False
    return next(_head_counter) % iv == 0


# ---------------------------------------------------------------------------
# contexts and spans
# ---------------------------------------------------------------------------

class SpanContext:
    """Immutable (trace_id, span_id) pair — the unit of propagation.
    Plain data on purpose: it pickles into work orders and rides
    request objects across threads."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id, span_id):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"SpanContext({self.trace_id}, {self.span_id})"

    def __reduce__(self):
        return (SpanContext, (self.trace_id, self.span_id))


def _as_ctx(parent):
    """Normalize a parent handle: SpanContext, Span, or an
    (trace_id, span_id) tuple (the picklable work-order form)."""
    if parent is None:
        return None
    if isinstance(parent, SpanContext):
        return parent
    if isinstance(parent, Span):
        return parent.ctx()
    if isinstance(parent, (tuple, list)) and len(parent) == 2:
        return SpanContext(parent[0], parent[1])
    return None


class Span:
    """A live span; context manager that makes it the current context.
    ``__exit__`` records it into the tracer ring (status ``error`` when
    the body raised)."""

    __slots__ = ("tracer", "trace_id", "span_id", "parent_id", "name",
                 "start", "attrs", "status", "_token")

    def __init__(self, tracer, name, trace_id, span_id, parent_id,
                 attrs=None):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = time.perf_counter()
        self.attrs = dict(attrs or {})
        self.status = "ok"
        self._token = None

    def ctx(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    def set_attr(self, **attrs):
        self.attrs.update(attrs)
        return self

    def __bool__(self):
        return True

    def __enter__(self):
        self._token = _current.set(self.ctx())
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        if exc_type is not None:
            self.status = "error"
            self.attrs.setdefault("error", f"{exc_type.__name__}: {exc}")
        self.tracer.finish(self)
        return False


class _NullSpan:
    """The not-sampled/disabled stand-in: falsy, no-op context manager,
    no tracer calls ever."""

    __slots__ = ()
    trace_id = None
    span_id = None

    def ctx(self):
        return None

    def traceparent(self):
        return None

    def set_attr(self, **attrs):
        return self

    def __bool__(self):
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _NullSpan()


# ---------------------------------------------------------------------------
# the tracer (swappable: set_tracer(CountingStub) in tests)
# ---------------------------------------------------------------------------

class Tracer:
    """Bounded ring of finished span records. ``finish``/``emit`` are
    the only hot-path entry points: one dict build + one deque append,
    no I/O, no device work."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._spans: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        # os-seeded; ids only need uniqueness, not reproducibility
        self._rand = random.Random()

    def resize(self, capacity: int):
        with self._lock:
            self.capacity = int(capacity)
            self._spans = deque(self._spans, maxlen=self.capacity)

    def new_trace_id(self) -> str:
        return f"{self._rand.getrandbits(128):032x}"

    def new_span_id(self) -> str:
        return f"{self._rand.getrandbits(64):016x}"

    def start_span(self, name, trace_id=None, parent_id=None,
                   attrs=None) -> Span:
        if trace_id is None:
            trace_id = self.new_trace_id()
        return Span(self, name, trace_id, self.new_span_id(), parent_id,
                    attrs)

    def finish(self, span: Span, end=None):
        self._append({
            "trace_id": span.trace_id, "span_id": span.span_id,
            "parent_id": span.parent_id, "name": span.name,
            "start": round(span.start, 6),
            "end": round(end if end is not None else time.perf_counter(),
                         6),
            "ts": round(time.time(), 6),
            "status": span.status,
            # copied: a ring record must not alias a dict the caller
            # might still mutate (set_attr after exit) while an export
            # thread iterates it
            "attrs": dict(span.attrs)})

    def emit(self, name, trace_id, parent_id, start, end, attrs=None,
             status="ok") -> str:
        """Record an already-finished span with explicit timestamps
        (retroactive phases: queue waits measured at dispatch time).
        Returns the new span id so children can parent to it."""
        span_id = self.new_span_id()
        self._append({
            "trace_id": trace_id, "span_id": span_id,
            "parent_id": parent_id, "name": name,
            "start": round(float(start), 6), "end": round(float(end), 6),
            "ts": round(time.time(), 6), "status": status,
            "attrs": dict(attrs or {})})
        return span_id

    def _append(self, record):
        with self._lock:
            self._spans.append(record)

    def spans(self, trace_id=None) -> list:
        with self._lock:
            out = list(self._spans)
        if trace_id is not None:
            out = [s for s in out if s["trace_id"] == trace_id]
        return out

    def trace_ids(self) -> list:
        """Distinct trace ids in the ring, oldest first."""
        seen: dict = {}
        for s in self.spans():
            seen.setdefault(s["trace_id"], None)
        return list(seen)

    def clear(self):
        with self._lock:
            self._spans.clear()

    def __len__(self):
        return len(self._spans)

    def dump_jsonl(self, trace_id=None) -> str:
        return "\n".join(json.dumps(s) for s in
                         self.spans(trace_id)) + "\n"


def get_tracer() -> Tracer:
    """The process-wide tracer (created lazily)."""
    tr = _state["tracer"]
    if tr is None:
        with _lock:
            tr = _state["tracer"]
            if tr is None:
                tr = Tracer()
                _state["tracer"] = tr
    return tr


def set_tracer(tracer):
    """Swap the process tracer (tests: counting stubs). Returns the
    previous tracer."""
    prev = _state["tracer"]
    _state["tracer"] = tracer
    return prev


# ---------------------------------------------------------------------------
# module-level emission API (every entry checks enabled() FIRST, so a
# disabled process makes zero tracer-object calls — the CountingStub
# contract)
# ---------------------------------------------------------------------------

def current() -> SpanContext | None:
    """The calling thread's current span context (None when tracing is
    disabled or the caller is not inside a sampled trace)."""
    if not enabled():
        return None
    return _current.get()


def current_ids():
    """(trace_id, span_id) of the current context, or None — the
    picklable form that rides a work order across a process boundary."""
    ctx = current()
    if ctx is None:
        return None
    return (ctx.trace_id, ctx.span_id)


@contextmanager
def use(ctx):
    """Make ``ctx`` (SpanContext, (trace_id, span_id) tuple, or None)
    the current context for the block — the explicit cross-thread
    handoff (prefetcher producer, replica workers)."""
    ctx = _as_ctx(ctx)
    if ctx is None:
        yield None
        return
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def parse_traceparent(header):
    """W3C traceparent -> (trace_id, parent_span_id, sampled) or None
    on anything malformed (never raises: headers are attacker input)."""
    if not header or not isinstance(header, str):
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id, bool(int(flags, 16) & 1)


def start_trace(name, traceparent=None, **attrs):
    """Head-sampled trace root. With an upstream ``traceparent`` the
    upstream decision wins (sampled flag set -> trace, cleared -> drop);
    otherwise the local 1-in-N sampler decides. Returns a started
    :class:`Span` (use as a context manager) or None when not sampled.
    """
    if not enabled():
        return None
    trace_id = parent_id = None
    if traceparent is not None:
        parsed = parse_traceparent(traceparent)
        if parsed is not None:
            trace_id, parent_id, sampled = parsed
            if not sampled:
                return None
        elif not _head_sampled():
            return None
    elif not _head_sampled():
        return None
    return get_tracer().start_span(name, trace_id=trace_id,
                                   parent_id=parent_id, attrs=attrs)


def trace_or_span(name, **attrs):
    """A child span of the current context when one exists (nested
    fits under an ElasticTrainer root, for example), else a
    head-sampled new trace. Returns :data:`NULL` (falsy no-op) when
    disabled or not sampled, so ``with``/truthiness both work."""
    if not enabled():
        return NULL
    ctx = _current.get()
    if ctx is not None:
        return get_tracer().start_span(name, trace_id=ctx.trace_id,
                                       parent_id=ctx.span_id, attrs=attrs)
    return start_trace(name, **attrs) or NULL


def span(name, parent=None, **attrs):
    """Child span context manager under ``parent`` (default: the
    current context). :data:`NULL` when there is no parent — the hot
    path's guard is one falsy check, zero tracer calls."""
    if not enabled():
        return NULL
    ctx = _as_ctx(parent) if parent is not None else _current.get()
    if ctx is None:
        return NULL
    return get_tracer().start_span(name, trace_id=ctx.trace_id,
                                   parent_id=ctx.span_id, attrs=attrs)


def emit(name, parent, start, end, status="ok", **attrs):
    """Record a finished span with explicit perf_counter timestamps
    under ``parent`` (SpanContext / (tid, sid) tuple). Returns the span
    id or None. The retroactive-phase workhorse: queue waits and
    execute windows are measured first, spanned after."""
    if not enabled():
        return None
    ctx = _as_ctx(parent)
    if ctx is None:
        return None
    return get_tracer().emit(name, ctx.trace_id, ctx.span_id, start,
                             end, attrs=attrs, status=status)


def export_jsonl(trace_id=None) -> str:
    """The span ring as JSONL (the ``/debug/traces`` payload) —
    read-only, works whether or not tracing is currently enabled (an
    incident dump must outlive a mid-incident disable())."""
    return get_tracer().dump_jsonl(trace_id=trace_id)


def ingest(record):
    """Materialize a span record produced in another PROCESS (a data
    worker ships these back beside its batches). The record supplies
    trace_id/parent_id/name/start/end/attrs; a fresh span id is
    assigned here."""
    if not enabled() or not isinstance(record, dict):
        return None
    try:
        return get_tracer().emit(
            record["name"], record["trace_id"], record.get("parent_id"),
            record["start"], record["end"],
            attrs=record.get("attrs"), status=record.get("status", "ok"))
    except (KeyError, TypeError):
        return None
