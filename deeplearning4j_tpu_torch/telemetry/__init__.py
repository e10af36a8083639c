"""Telemetry: the process-wide metrics registry, its Prometheus text
exposition and the flight recorder.

Counterpart of ``deeplearning4j_tpu.telemetry``, its first parts: what the
precision monitor records into, and the part of the memory ledger
(``memledger``: claims, OOM forensics, capacity planning) that the decode
engine calls. Training-loop, ETL, serving and fleet instruments, health,
tracing, the compile ledger, the rest of the memory ledger and the
profiler come with the telemetry slice (ROADMAP.md, queue 1 item 13).
"""

from deeplearning4j_tpu_torch.telemetry import flight, memledger, prometheus
from deeplearning4j_tpu_torch.telemetry.flight import FlightRecorder
from deeplearning4j_tpu_torch.telemetry.memledger import (
    CapacityError, DeviceOomError)
from deeplearning4j_tpu_torch.telemetry.registry import (
    BYTES_BUCKETS, SECONDS_BUCKETS, Counter, Gauge, Histogram,
    MetricsRegistry, Timer, disable, enable, enabled, get_registry,
    log_buckets, set_registry, span)

__all__ = [
    "BYTES_BUCKETS", "CapacityError", "Counter", "DeviceOomError",
    "FlightRecorder", "Gauge", "Histogram",
    "MetricsRegistry", "SECONDS_BUCKETS", "Timer", "disable", "enable",
    "enabled", "flight", "get_registry", "log_buckets", "memledger",
    "prometheus",
    "set_registry", "span",
]
