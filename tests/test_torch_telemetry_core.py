"""The port's telemetry core against the JAX package's.

- ``telemetry/registry.py``: the same calls on a fresh registry in each
  package (labelled and unlabelled counters, gauges, histograms with the
  default and custom buckets, timers) give the same ``snapshot()``, and
  ``prometheus.render`` the same exposition text (the reference's with
  ``collect_system=False``, its device-memory gauges), exemplars and a
  name filter included, and the reference's ``parse`` reads it back to
  the port's snapshot; the errors (a counter
  decreased, labels that do not match, a name registered twice with
  another kind, buckets out of order) alike; ``log_buckets`` and
  ``fmt_float`` equal.
- ``telemetry/flight.py``: the same records give the same events and the
  same JSONL dump but for the clocks (``ts``, ``mono``); the ring's
  capacity, ``clear``, the module switch and the excepthook's ``crash``
  record alike.
"""

import json
import sys

import numpy as np
import pytest

from deeplearning4j_tpu.telemetry import flight as jax_flight
from deeplearning4j_tpu.telemetry import prometheus as jax_prometheus
from deeplearning4j_tpu.telemetry import registry as jax_registry
from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.telemetry import flight, prometheus, registry


def _scenario_counters(reg):
    c = reg.counter("dl4j_requests_total", "Requests served",
                    ("model", "outcome"))
    c.labels(model="a", outcome="ok").inc()
    c.labels(model="a", outcome="ok").inc(2.5)
    c.labels(outcome="error", model="b").inc(1)
    reg.counter("dl4j_plain_total", "no labels").inc(7)
    reg.counter("dl4j_never_total", "registered, never touched", ("x",))


def _scenario_gauges(reg):
    g = reg.gauge("dl4j_loss_scale", "Current scale", ("loop",))
    g.labels(loop="fit").set(32768)
    g.labels(loop="graph").set(0.125)
    g.labels(loop="graph").inc(2)
    g.labels(loop="graph").dec(0.5)
    reg.gauge("dl4j_weird", 'help with \\ and\nnewline').set(-1e20)
    reg.gauge("dl4j_label_escape", "escapes", ("path",)).labels(
        path='a "quoted"\\ value\nnext').set(3)


def _scenario_histograms(reg):
    h = reg.histogram("dl4j_step_seconds", "Step wall time", ("loop",))
    for v in (5e-5, 1e-4, 0.00318, 0.02, 7.0, 1e4):
        h.labels(loop="fit").observe(v)
    b = reg.histogram("dl4j_bytes", "Bytes", (),
                      buckets=registry.BYTES_BUCKETS)
    for v in (1, 1024, 1025, 3 << 20):
        b.observe(v)
    t = reg.histogram("dl4j_custom", "custom buckets", ("k",),
                      buckets=(0.5, 1, 2.5))
    t.labels(k="x").observe(1)
    t.labels(k="x").observe(2.6)


def _scenario_timers(reg):
    with reg.timer("dl4j_timed_seconds", "timed"):
        pass
    h = reg.histogram("dl4j_span_seconds", "spans", ("loop",))
    with h.labels(loop="fit").time():
        pass


SCENARIOS = [_scenario_counters, _scenario_gauges, _scenario_histograms]


def _pair(*scenarios):
    regs = registry.MetricsRegistry(), jax_registry.MetricsRegistry()
    for reg in regs:
        for sc in scenarios:
            sc(reg)
    return regs


@pytest.mark.parametrize("scenarios", [[s] for s in SCENARIOS] + [
    SCENARIOS], ids=["counters", "gauges", "histograms", "all"])
def test_exposition_and_snapshot_equal_the_reference(scenarios):
    mine, theirs = _pair(*scenarios)
    assert mine.snapshot() == theirs.snapshot()
    text = prometheus.render(mine)
    assert text == jax_prometheus.render(theirs, collect_system=False)
    assert jax_prometheus.parse(text) == mine.snapshot()


def test_exemplars_and_name_filter():
    mine, theirs = _pair(*SCENARIOS)
    for reg in (mine, theirs):
        h = reg.histogram("dl4j_step_seconds", "Step wall time",
                          ("loop",)).labels(loop="fit")
        h.observe(0.02, exemplar="abc123")
        h.exemplars = {k: (t, v, 1700000000.0)
                       for k, (t, v, _) in h.exemplars.items()}
    got = prometheus.render(mine, exemplars=True)
    want = jax_prometheus.render(theirs, collect_system=False,
                                 exemplars=True)
    assert got == want and 'trace_id="abc123"' in got
    assert jax_prometheus.parse(got) == mine.snapshot()
    got = prometheus.render(mine, name_prefix="dl4j_step")
    assert got == jax_prometheus.render(theirs, collect_system=False,
                                        name_prefix="dl4j_step")
    assert "dl4j_plain_total" not in got


def test_timers_observe_once_each():
    mine, theirs = _pair(_scenario_timers)
    for reg in (mine, theirs):
        snap = reg.snapshot()
        assert snap["dl4j_timed_seconds_count"] == 1.0
        assert snap['dl4j_span_seconds_count{loop="fit"}'] == 1.0
    assert sorted(mine.snapshot()) == sorted(theirs.snapshot())
    with registry.span("phase"):
        pass


@pytest.mark.parametrize("mod", [registry, jax_registry],
                         ids=["port", "jax"])
def test_errors_alike(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("c_total", "", ("a",))
    with pytest.raises(ValueError, match="cannot decrease"):
        c.labels(a="1").inc(-1)
    with pytest.raises(ValueError, match="do not match"):
        c.labels(b="1")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("c_total", "", ("a",))
    with pytest.raises(ValueError, match="already registered"):
        reg.counter("c_total", "", ("b",))
    with pytest.raises(ValueError, match="strictly increasing"):
        reg.histogram("h", "", (), buckets=(1, 1, 2))
    with pytest.raises(ValueError, match="0 < lo < hi"):
        mod.log_buckets(1, 1)
    assert reg.counter("c_total", "", ("a",)) is c
    reg.reset()
    assert reg.snapshot() == {}


def test_buckets_and_number_format_equal():
    assert registry.SECONDS_BUCKETS == jax_registry.SECONDS_BUCKETS
    assert registry.BYTES_BUCKETS == jax_registry.BYTES_BUCKETS
    for args in ((1e-3, 10.0, 3), (0.5, 5000.0, 10)):
        assert registry.log_buckets(*args) == jax_registry.log_buckets(*args)
    for v in (0, 1, -3, 2.5, 1e15, 1e16, 1 / 3, float("inf"),
              float("-inf"), np.float32(0.1)):
        assert registry.fmt_float(v) == jax_registry.fmt_float(v)


def test_module_switch_and_process_registry():
    prev = telemetry.set_registry(None)
    was = telemetry.enabled()
    try:
        reg = telemetry.get_registry()
        assert isinstance(reg, registry.MetricsRegistry)
        assert telemetry.get_registry() is reg
        telemetry.disable()
        assert not telemetry.enabled()
        assert telemetry.enable() is reg and telemetry.enabled()
    finally:
        telemetry.set_registry(prev)
        (telemetry.enable if was else telemetry.disable)()


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------

CLOCKS = ("ts", "mono")


def _strip(events):
    return [{k: v for k, v in e.items() if k not in CLOCKS} for e in events]


def _records(rec):
    rec.record("precision", loop="fit", step=3, event="overflow",
               skipped=1, loss_scale=16384.0, overflows_total=1)
    rec.record("quantize", layers=2, calibration_batches=4, max_err=None)
    rec.record("serving", request="r1", model="m", queue_wait=np.float32(
        0.25), shape=(2, 3))
    rec.record("precision", loop="graph", step=[4, 7], event="overflow")


def test_flight_records_and_dump_equal_the_reference(tmp_path):
    mine, theirs = flight.FlightRecorder(), jax_flight.FlightRecorder()
    for rec in (mine, theirs):
        _records(rec)
    assert _strip(mine.events()) == _strip(theirs.events())
    assert _strip(mine.events("precision")) == _strip(
        theirs.events("precision"))
    assert len(mine) == len(theirs) == 4
    lines = [[{k: v for k, v in json.loads(line).items() if k not in CLOCKS}
              for line in r.dump_jsonl().splitlines()]
             for r in (mine, theirs)]
    assert lines[0] == lines[1]
    path = mine.dump(str(tmp_path / "sub" / "flight.jsonl"))
    assert [json.loads(x)["kind"] for x in open(path)] == [
        "precision", "quantize", "serving", "precision"]
    mine.clear()
    assert mine.events() == []


def test_flight_ring_capacity_and_switch():
    mine, theirs = flight.FlightRecorder(3), jax_flight.FlightRecorder(3)
    for rec in (mine, theirs):
        for i in range(5):
            rec.record("step", step=i)
    assert _strip(mine.events()) == _strip(theirs.events())
    assert [e["seq"] for e in mine.events()] == [3, 4, 5]
    was = flight.enabled()
    flight.disable()
    try:
        assert flight.record("step", step=9) is None
        assert mine.record("step", step=9) is None
    finally:
        flight.enable()
    assert flight.record("step", step=10)["step"] == 10
    if not was:
        flight.disable()
    assert flight.get_recorder() is flight.get_recorder()
    assert flight.default_dump_path().endswith(".jsonl")


def test_excepthook_dumps_a_crash_record(tmp_path, monkeypatch, capsys):
    seen = []
    monkeypatch.setattr(sys, "excepthook", lambda *a: seen.append(a))
    monkeypatch.setattr(flight, "default_dump_path",
                        lambda: str(tmp_path / "crash.jsonl"))
    flight.install_excepthook()
    try:
        flight.install_excepthook()   # idempotent
        try:
            raise KeyError("boom")
        except KeyError:
            sys.excepthook(*sys.exc_info())
    finally:
        flight.uninstall_excepthook()
    assert len(seen) == 1
    crash = [e for e in flight.get_recorder().events("crash")]
    assert crash and crash[-1]["error"] == "KeyError: 'boom'"
    assert "crash" in (tmp_path / "crash.jsonl").read_text()
    assert "flight recorder dumped" in capsys.readouterr().err
