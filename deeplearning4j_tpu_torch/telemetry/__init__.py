"""Telemetry: the process-wide metrics registry, its Prometheus text
exposition, the flight recorder and sampled tracing.

Counterpart of ``deeplearning4j_tpu.telemetry``, its first parts: what the
precision monitor records into, the serving instrument set
(``ServingInstruments``, ``serving_instruments``) that the batcher, the
replica sets, admission and the decode engine record into, request
tracing (``tracing``: span trees across the serving threads, W3C
``traceparent``, exemplars on the serving histograms), and the part of the
memory ledger (``memledger``: claims, OOM forensics, capacity planning)
that the decode engine and the serving replicas call. Training-loop, ETL
and fleet instruments, health, the compile ledger, the rest of the memory
ledger and the profiler come with the telemetry slice (ROADMAP.md, queue 1
item 13).
"""

from deeplearning4j_tpu_torch.telemetry import (
    flight, memledger, prometheus, tracing)
from deeplearning4j_tpu_torch.telemetry.flight import FlightRecorder
from deeplearning4j_tpu_torch.telemetry.memledger import (
    CapacityError, DeviceOomError)
from deeplearning4j_tpu_torch.telemetry.registry import (
    BYTES_BUCKETS, SECONDS_BUCKETS, Counter, Gauge, Histogram,
    MetricsRegistry, ServingInstruments, Timer, disable, enable, enabled,
    get_registry, log_buckets, serving_instruments, set_registry, span)

__all__ = [
    "BYTES_BUCKETS", "CapacityError", "Counter", "DeviceOomError",
    "FlightRecorder", "Gauge", "Histogram",
    "MetricsRegistry", "SECONDS_BUCKETS", "ServingInstruments", "Timer",
    "disable", "enable", "enabled", "flight", "get_registry",
    "log_buckets", "memledger", "prometheus", "serving_instruments",
    "set_registry", "span", "tracing",
]
