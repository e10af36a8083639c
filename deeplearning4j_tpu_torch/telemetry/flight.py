"""FlightRecorder: a bounded ring buffer of structured runtime events.

Counterpart of ``deeplearning4j_tpu/telemetry/flight.py``, whole: the
same events, fields and JSONL dump. Always on and cheap (one deque
append an event, no device work, no I/O), dumpable the moment something
goes wrong.

Event sources in the port so far:

- ``precision``: a loss-scaler overflow (loop, step, the halved scale,
  the cumulative count), from ``precision.monitor``;
- ``quantize``: an int8 post-training quantization (layers, calibration
  batches, the calibration error), from ``precision.quantize``;
- ``crash``: an uncaught exception, with the opt-in excepthook.

The buffer dumps as JSONL via ``dump()``, or (opt-in) on any uncaught
exception (``install_excepthook()``).
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import tempfile
import threading
import time
from collections import deque

DEFAULT_CAPACITY = 4096

_state = {"enabled": True, "recorder": None}
_lock = threading.Lock()


def enabled() -> bool:
    return _state["enabled"]


def enable():
    _state["enabled"] = True
    return get_recorder()


def disable():
    _state["enabled"] = False


def _json_default(v):
    """Dump-time coercion for numpy scalars/arrays riding in events."""
    if hasattr(v, "item"):
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    return str(v)


class FlightRecorder:
    """Thread-safe ring buffer of event dicts. ``record`` is the only
    hot-path entry point: one flag check, one dict build, one deque
    append — no I/O, no device touch, bounded memory."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=self.capacity)
        self._seq = itertools.count(1)
        self._lock = threading.Lock()

    def record(self, kind: str, **fields):
        if not _state["enabled"]:
            return None
        # ts (wall) orders events ACROSS processes — the fleet router's
        # /debug/fleet/flight merge-sorts worker rings by it; mono is
        # the drift-free intra-process clock for interval arithmetic
        evt = {"seq": next(self._seq), "ts": round(time.time(), 6),
               "mono": round(time.monotonic(), 6), "kind": kind}
        evt.update(fields)
        with self._lock:
            self._events.append(evt)
        return evt

    def events(self, kind: str | None = None) -> list:
        with self._lock:
            evts = list(self._events)
        if kind is not None:
            evts = [e for e in evts if e["kind"] == kind]
        return evts

    def clear(self):
        with self._lock:
            self._events.clear()

    def __len__(self):
        return len(self._events)

    # -- dumping -------------------------------------------------------------
    def dump_jsonl(self) -> str:
        """The whole buffer as JSONL, oldest event first."""
        return "\n".join(json.dumps(e, default=_json_default)
                         for e in self.events()) + "\n"

    def dump(self, path: str | None = None) -> str:
        """Write the buffer as JSONL and return the path (default:
        ``<tmpdir>/dl4j_flight_<pid>.jsonl``)."""
        if path is None:
            path = default_dump_path()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.dump_jsonl())
        return path


def default_dump_path() -> str:
    return os.path.join(tempfile.gettempdir(),
                        f"dl4j_flight_{os.getpid()}.jsonl")


def get_recorder() -> FlightRecorder:
    """The process-wide recorder (created lazily)."""
    rec = _state["recorder"]
    if rec is None:
        with _lock:
            rec = _state["recorder"]
            if rec is None:
                rec = FlightRecorder()
                _state["recorder"] = rec
    return rec


def record(kind: str, **fields):
    """Module-level convenience: record into the process recorder."""
    if not _state["enabled"]:
        return None
    return get_recorder().record(kind, **fields)


def dump(path: str | None = None) -> str:
    return get_recorder().dump(path)


# -- crash dump (opt-in) -----------------------------------------------------

_prev_excepthook = None


def install_excepthook():
    """Dump the flight recorder on any uncaught exception, then delegate
    to the previous hook. Idempotent."""
    global _prev_excepthook
    if _prev_excepthook is not None:
        return
    _prev_excepthook = sys.excepthook

    def _hook(exc_type, exc, tb):
        try:
            record("crash", error=f"{exc_type.__name__}: {exc}")
            path = get_recorder().dump()
            print(f"[dl4j] flight recorder dumped to {path}",
                  file=sys.stderr)
        except Exception:
            pass
        _prev_excepthook(exc_type, exc, tb)

    sys.excepthook = _hook


def uninstall_excepthook():
    global _prev_excepthook
    if _prev_excepthook is not None:
        sys.excepthook = _prev_excepthook
        _prev_excepthook = None
