"""Prometheus text exposition (format 0.0.4) of a MetricsRegistry.

Counterpart of ``deeplearning4j_tpu/telemetry/prometheus.py``'s
``render``: the same text for the same registry calls. The HTTP
``/metrics`` route and its scrapers come with the serving and UI items
(ROADMAP.md, queue 1 items 7 and 13).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.telemetry.registry import (
    fmt_float, get_registry)

def _escape_help(s):
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s):
    return (s.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _labels_text(labels):
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in labels)
    return "{" + inner + "}"


def _exemplar_text(child, idx):
    """OpenMetrics exemplar suffix for one bucket, or '': a latency
    bucket carries the trace id of the last sampled observation that
    landed in it."""
    ex = getattr(child, "exemplars", None)
    if not ex or idx not in ex:
        return ""
    trace_id, value, ts = ex[idx]
    return (f' # {{trace_id="{_escape_label(str(trace_id))}"}} '
            f"{fmt_float(value)} {ts:.3f}")


def render(registry=None, exemplars=False, name_prefix=None) -> str:
    """The whole registry (the process registry unless one is given) in
    Prometheus text exposition: the JAX package's ``render(...,
    collect_system=False)``, its device-memory gauges waiting for the
    telemetry slice. ``exemplars=True`` appends OpenMetrics-style
    exemplar suffixes to the histogram bucket lines (a debug opt-in: the
    exposition is 0.0.4); ``name_prefix`` keeps only the families whose
    name starts with it."""
    reg = registry or get_registry()
    lines = []
    for fam in reg.collect():
        if name_prefix and not fam.name.startswith(name_prefix):
            continue
        lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for labels, child in fam.children():
            if fam.kind == "histogram":
                acc = 0
                for i, (bound, c) in enumerate(zip(child.buckets,
                                                   child.counts)):
                    acc += c
                    lt = _labels_text(labels + (("le", fmt_float(bound)),))
                    ex = _exemplar_text(child, i) if exemplars else ""
                    lines.append(f"{fam.name}_bucket{lt} {acc}{ex}")
                lt = _labels_text(labels + (("le", "+Inf"),))
                ex = (_exemplar_text(child, len(child.buckets))
                      if exemplars else "")
                lines.append(f"{fam.name}_bucket{lt} {child.count}{ex}")
                lines.append(f"{fam.name}_sum{_labels_text(labels)} "
                             f"{fmt_float(child.sum)}")
                lines.append(f"{fam.name}_count{_labels_text(labels)} "
                             f"{child.count}")
            else:
                lines.append(f"{fam.name}{_labels_text(labels)} "
                             f"{fmt_float(child.value)}")
    return "\n".join(lines) + "\n"
