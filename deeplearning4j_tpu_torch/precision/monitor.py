"""Host side of the loss scaler: the scaler state published one step
behind.

Counterpart of ``deeplearning4j_tpu/precision/monitor.py``, with the same
metric names and flight events:

- ``dl4j_precision_loss_scale{loop}``: the current loss scale (gauge);
- ``dl4j_precision_overflow_total{loop}``: steps whose scaled gradients
  went non-finite (counter);
- ``dl4j_precision_skipped_steps_total{loop}``: steps discarded on the
  device by the overflow gate (counter; equal to the overflows for the
  in-step gate);
- a ``precision`` flight event for every overflow, naming the loop, the
  step and the halved scale.

An overflow is a rise in the device's cumulative ``overflows`` count, so
the step needs no flag of its own. The monitor keeps a one-deep pending
slot: ``on_step`` starts a copy of the new state to pinned host memory
behind the step (``copy_(..., non_blocking=True)`` and a CUDA event, no
synchronisation) and processes the previous step's copy, whose event has
as a rule completed already. So the fit loop never reads a device value
on the host. ``skipped_at(step)`` answers the health monitor's
SKIP_BATCH handshake, which comes with the telemetry slice (ROADMAP.md,
queue 1 item 13), and ``on_launch`` serves ``fitMultiBatch`` (item 12):
both are here and unused until then.
"""

from __future__ import annotations

from collections import deque

import torch

from deeplearning4j_tpu_torch.telemetry import flight
from deeplearning4j_tpu_torch.telemetry import registry as _registry
from deeplearning4j_tpu_torch.telemetry.registry import get_registry

SCALE_HELP = "Current dynamic loss scale per training loop"
OVERFLOW_HELP = ("Training steps whose scaled gradients went non-finite "
                 "(the dynamic loss scaler backed off)")
SKIPPED_HELP = ("Training steps discarded on device by the loss-scaler "
                "overflow gate")


class PrecisionInstruments:
    __slots__ = ("scale", "overflows", "skipped")

    def __init__(self, registry, loop):
        self.scale = registry.gauge(
            "dl4j_precision_loss_scale", SCALE_HELP,
            ("loop",)).labels(loop=loop)
        self.overflows = registry.counter(
            "dl4j_precision_overflow_total", OVERFLOW_HELP,
            ("loop",)).labels(loop=loop)
        self.skipped = registry.counter(
            "dl4j_precision_skipped_steps_total", SKIPPED_HELP,
            ("loop",)).labels(loop=loop)


class _Snapshot:
    """The scaler state on its way to the host: a non-blocking copy of
    each 0-d tensor into pinned memory and, on CUDA, an event after it."""

    __slots__ = ("host", "event")

    def __init__(self, state):
        on_cuda = any(v.device.type == "cuda" for v in state.values())
        self.host = {k: torch.empty((), dtype=v.dtype, pin_memory=on_cuda)
                     .copy_(v.detach(), non_blocking=on_cuda)
                     for k, v in state.items()}
        self.event = None
        if on_cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    def read(self):
        """(scale, overflows) as Python numbers, waiting for this copy
        only."""
        if self.event is not None:
            self.event.synchronize()
        return float(self.host["scale"]), int(self.host["overflows"])


class PrecisionMonitor:
    """One a fit loop (made by ``monitor_for``); call ``on_step(step,
    prec_state)`` after each step and ``flush()`` at the end of the loop,
    before the health monitor's equivalents, so the skip set is filled
    when health accounting asks."""

    def __init__(self, loop, instruments=None):
        self.loop = loop
        self.instruments = instruments
        self._pending = None
        self._baseline = None
        self._last_overflows = 0
        # recent overflow steps for the health-monitor handshake; bounded
        # so a pathological run cannot grow host memory
        self._recent_skips: deque = deque(maxlen=256)

    def skipped_at(self, step) -> bool:
        return step in self._recent_skips

    def baseline_from(self, state):
        """Anchor the overflow-delta detection to the current cumulative
        device count (once before the loop: the monitor is per fit, the
        device counter per network). The copy is read when the first step
        is processed, so this adds no synchronisation either."""
        if state:
            self._baseline = _Snapshot(state)

    def _overflows_base(self):
        if self._baseline is not None:
            self._last_overflows = self._baseline.read()[1]
            self._baseline = None

    def on_step(self, step, prec_state):
        if not prec_state:
            return
        prev, self._pending = self._pending, (step, _Snapshot(prec_state))
        if prev is not None:
            self._process(*prev)

    def flush(self):
        prev, self._pending = self._pending, None
        if prev is not None:
            self._process(*prev)

    def on_launch(self, steps, state):
        """A launch of several steps (``fitMultiBatch``): publish from the
        launch's final scaler state. Overflows inside it are attributed
        to the whole ``steps`` range."""
        if not state:
            return
        self._overflows_base()
        scale, overflows = _Snapshot(state).read()
        inst = self.instruments
        if inst is not None:
            inst.scale.set(scale)
        delta = overflows - self._last_overflows
        if delta > 0:
            self._last_overflows = overflows
            # only the last maxlen indices can survive the deque: slice
            # the range instead of iterating a potentially huge launch
            self._recent_skips.extend(
                steps[-(self._recent_skips.maxlen or len(steps)):])
            if inst is not None:
                inst.overflows.inc(delta)
                inst.skipped.inc(delta)
            flight.record("precision", loop=self.loop,
                          step=[min(steps), max(steps)],
                          event="overflow", skipped=delta,
                          loss_scale=scale, overflows_total=overflows)

    def _process(self, step, snap):
        self._overflows_base()
        scale, overflows = snap.read()
        inst = self.instruments
        if inst is not None:
            inst.scale.set(scale)
        delta = overflows - self._last_overflows
        if delta > 0:
            self._last_overflows = overflows
            self._recent_skips.append(step)
            if inst is not None:
                inst.overflows.inc(delta)
                inst.skipped.inc(delta)
            flight.record("precision", loop=self.loop, step=step,
                          event="overflow", skipped=delta,
                          loss_scale=scale, overflows_total=overflows)


def monitor_for(loop, policy) -> PrecisionMonitor | None:
    """The fit loop's PrecisionMonitor, or None when the policy has no
    loss scaling or telemetry is disabled (then the loop makes no
    registry call a step; the device-side gate runs regardless)."""
    if policy is None or not policy.scaling_enabled:
        return None
    if not _registry.enabled():
        return None
    return PrecisionMonitor(loop, PrecisionInstruments(get_registry(), loop))
