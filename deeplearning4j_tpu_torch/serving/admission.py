"""Admission control: priority classes, per-model concurrency budgets,
and load shedding.

Counterpart of ``deeplearning4j_tpu/serving/admission.py``, whole (host
logic; no device). Overload becomes a POLICY instead of a bounded queue
that rejects whoever arrives next:

- four priority classes: ``high`` (interactive / SLO-bound), ``normal``
  (default), ``batch`` (best-effort backfill) and ``train`` (a fine-tuning
  loop's steps, arbitrated against serving on the same host);
- a per-model concurrency budget (requests admitted and not yet
  terminal). Lower classes are capped at a FRACTION of the budget, so
  headroom is reserved: ``train`` is shed first, then ``batch``, then
  ``normal``, and ``high`` keeps the full budget;
- shed responses carry a computed ``retry_after`` (seconds), from the
  recent per-request service rate and the standing load.

The controller is intentionally approximate: one lock, integer loads,
EWMA service rate. Admission is decided BEFORE a request touches a
batching or decode queue, so a shed costs no queue slot. A shed counts
in the caller's serving instruments (``inst.shed``, ``inst.request(
"shed")``) and is recorded in the flight recorder (model, class,
standing load, and the trace id of a sampled request).
"""

from __future__ import annotations

import threading
import time

from deeplearning4j_tpu_torch.telemetry import flight, tracing

PRIORITIES = ("high", "normal", "batch", "train")

# fraction of a model's budget each class may fill (cumulative with
# everything above it): train is shed beyond 25% standing load, batch
# beyond 50%, normal beyond 85%, high rides to the full budget — so a
# co-hosted fine-tune loop can never occupy more than a quarter of a
# serving model's budget, and is the first thing shed under load
DEFAULT_CLASS_FRACTION = {"high": 1.0, "normal": 0.85, "batch": 0.5,
                          "train": 0.25}


class ShedError(RuntimeError):
    """Request shed by admission control (HTTP 429 + Retry-After)."""

    def __init__(self, message, retry_after=0.1, priority="normal"):
        super().__init__(message)
        self.retry_after = float(retry_after)
        self.priority = priority


class _ModelBudget:
    __slots__ = ("budget", "fractions", "standing", "rate_ewma",
                 "last_done")

    def __init__(self, budget, fractions):
        self.budget = int(budget)
        self.fractions = dict(fractions)
        self.standing = 0          # admitted, not yet terminal
        self.rate_ewma = 0.0       # completions per second (EWMA)
        self.last_done = None


class Ticket:
    """One admitted request; release() exactly once when terminal (the
    session wires it to the future's done-callback)."""

    __slots__ = ("_ctrl", "model", "priority", "_released")

    def __init__(self, ctrl, model, priority):
        self._ctrl = ctrl
        self.model = model
        self.priority = priority
        self._released = False

    def release(self):
        if self._released:
            return
        self._released = True
        self._ctrl._release(self.model)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class AdmissionController:
    """Per-model budgets + priority-class shedding.

    `default_budget` applies to models without an explicit
    `set_budget`. `instruments` is a zero-arg callable returning the
    model's ServingInstruments (or None) — only used to count sheds.
    """

    def __init__(self, default_budget=64, class_fractions=None,
                 min_retry_after=0.05, max_retry_after=5.0):
        self.default_budget = int(default_budget)
        self.class_fractions = dict(class_fractions
                                    or DEFAULT_CLASS_FRACTION)
        self.min_retry_after = min_retry_after
        self.max_retry_after = max_retry_after
        self._models: dict[str, _ModelBudget] = {}
        self._lock = threading.Lock()

    def set_budget(self, model, budget, class_fractions=None):
        with self._lock:
            self._models[model] = _ModelBudget(
                budget, class_fractions or self.class_fractions)
        return self

    def describe(self) -> dict:
        with self._lock:
            return {m: {"budget": b.budget, "standing": b.standing,
                        "fractions": dict(b.fractions),
                        "service_rate": round(b.rate_ewma, 3)}
                    for m, b in self._models.items()}

    def _get(self, model) -> _ModelBudget:
        b = self._models.get(model)
        if b is None:
            b = _ModelBudget(self.default_budget, self.class_fractions)
            self._models[model] = b
        return b

    def admit(self, model, priority="normal", inst=None) -> Ticket:
        """Admit or shed. Raises ShedError with a computed retry_after
        when the request's class is over its share of the budget."""
        if priority not in self.class_fractions:
            raise ValueError(
                f"unknown priority {priority!r}; choose from "
                f"{sorted(self.class_fractions)}")
        with self._lock:
            b = self._get(model)
            cap = max(1, int(b.budget * b.fractions.get(priority, 1.0)))
            if b.standing >= cap:
                excess = b.standing - cap + 1
                retry = self._retry_after(b, excess)
                shed = ShedError(
                    f"model {model!r} over its {priority!r} budget "
                    f"({b.standing}/{cap} standing, budget "
                    f"{b.budget}); retry in {retry:.2f}s",
                    retry_after=retry, priority=priority)
                standing = b.standing
            else:
                b.standing += 1
                shed = None
        if shed is not None:
            if inst is not None:
                inst.shed(priority)
                inst.request("shed")
            # a shed is a POLICY decision: the flight recorder names
            # the model, class, standing load, and (when the request
            # was sampled) its trace id — an incident dump says who
            # was turned away, not just how many
            ctx = tracing.current()
            flight.record("shed", model=model, priority=priority,
                          standing=standing,
                          retry_after=round(shed.retry_after, 4),
                          trace_id=(ctx.trace_id if ctx is not None
                                    else None))
            raise shed
        return Ticket(self, model, priority)

    def _release(self, model):
        now = time.perf_counter()
        with self._lock:
            b = self._models.get(model)
            if b is None:
                return
            b.standing = max(0, b.standing - 1)
            if b.last_done is not None:
                dt = now - b.last_done
                if dt > 0:
                    inst_rate = 1.0 / dt
                    b.rate_ewma = (inst_rate if b.rate_ewma == 0.0
                                   else 0.9 * b.rate_ewma
                                   + 0.1 * inst_rate)
            b.last_done = now

    def _retry_after(self, b, excess) -> float:
        """Seconds until `excess` standing requests should have
        drained at the recent service rate."""
        if b.rate_ewma <= 0.0:
            return self.min_retry_after
        return float(min(self.max_retry_after,
                         max(self.min_retry_after,
                             excess / b.rate_ewma)))
