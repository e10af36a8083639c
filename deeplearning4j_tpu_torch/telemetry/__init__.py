"""Telemetry: the process-wide metrics registry, its Prometheus text
exposition and the flight recorder.

Counterpart of ``deeplearning4j_tpu.telemetry``, its first part: what the
precision monitor records into. Training-loop, ETL, serving and fleet
instruments, health, tracing, the compile and memory ledgers and the
profiler come with the telemetry slice (ROADMAP.md, queue 1 item 13).
"""

from deeplearning4j_tpu_torch.telemetry import flight, prometheus
from deeplearning4j_tpu_torch.telemetry.flight import FlightRecorder
from deeplearning4j_tpu_torch.telemetry.registry import (
    BYTES_BUCKETS, SECONDS_BUCKETS, Counter, Gauge, Histogram,
    MetricsRegistry, Timer, disable, enable, enabled, get_registry,
    log_buckets, set_registry, span)

__all__ = [
    "BYTES_BUCKETS", "Counter", "FlightRecorder", "Gauge", "Histogram",
    "MetricsRegistry", "SECONDS_BUCKETS", "Timer", "disable", "enable",
    "enabled", "flight", "get_registry", "log_buckets", "prometheus",
    "set_registry", "span",
]
