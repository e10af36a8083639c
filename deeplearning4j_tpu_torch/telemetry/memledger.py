"""Device-memory ownership ledger: claims, OOM forensics and admission-time
capacity planning.

Counterpart of ``deeplearning4j_tpu/telemetry/memledger.py``, the part
that the decode engine calls:

- the claims registry (``Claim``, ``MemLedger``, ``claim``, ``release``):
  every subsystem that pins device memory registers a named, categorized
  claim (the decode engine's KV pools, category ``kv_cache``, target and
  draft lanes), published as ``dl4j_device_memory_claimed_bytes{category,
  device}``;
- OOM forensics (``is_oom``, ``oom_error``, ``raise_if_oom``): a seam that
  catches an allocation failure (``torch.cuda.OutOfMemoryError``, a
  ``MemoryError``, or a message in XLA's ``RESOURCE_EXHAUSTED`` shape)
  records a flight ``oom`` event with the site, the requested bytes and
  the top claims, and fails with a typed ``DeviceOomError``;
- capacity planning (``capacity_known``, ``headroom``, ``plan_capacity``):
  a prospective allocation is judged against the device's headroom
  BEFORE it is made, and refused with a structured ``CapacityError``.

Where the port differs by design:

- a CUDA device's capacity comes from ``torch.cuda.mem_get_info`` (total
  and free bytes) and ``torch.cuda.memory_stats``: the caching
  allocator's reserved-but-unallocated bytes count as headroom, since this
  process can reuse them;
- a device that reports nothing (the CPU) has a capacity only when a
  budget is configured (``configure(budget_bytes=...)`` or
  ``DL4J_DEVICE_BUDGET_BYTES``), and its bytes in use are the ledger's
  own claims on it (PyTorch has no counterpart of ``jax.live_arrays``);
- ``tree_bytes`` counts tensors (the "meta" device's too: the planner's
  estimate allocates nothing) and numpy arrays.

Held back for the telemetry slice: the census against the device's own
accounting, ``refresh_metrics``, ``describe``, the ``/healthz`` memory
section, and the placement planner for sharded pools.
"""

from __future__ import annotations

import logging
import os
import re
import threading
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.telemetry import flight
from deeplearning4j_tpu_torch.telemetry import registry as _registry

log = logging.getLogger("deeplearning4j_tpu_torch")

CLAIMED_HELP = ("Device bytes claimed by each subsystem category in the "
                "HBM ownership ledger (category=unattributed is the "
                "residual against the device's measured bytes_in_use)")

_state = {
    "ledger": None,
    "enabled": True,
    "budget": None,
    "budget_resolved": False,
    "top_n": 8,
}
_lock = threading.Lock()


def configure(budget_bytes=..., top_n=None, enabled=None):
    """``budget_bytes`` is the assumed capacity of a device that reports
    none (None forgets an override and re-reads
    ``DL4J_DEVICE_BUDGET_BYTES``); ``top_n`` bounds the claims an ``oom``
    flight event names; ``enabled`` is the ledger's switch under the
    telemetry flag."""
    with _lock:
        if enabled is not None:
            _state["enabled"] = bool(enabled)
        if budget_bytes is not ...:
            _state["budget"] = (None if budget_bytes is None
                                else int(budget_bytes))
            _state["budget_resolved"] = budget_bytes is not None
        if top_n is not None:
            _state["top_n"] = int(top_n)


def budget_bytes():
    """The configured capacity of a device that reports none: a
    ``configure`` override, else ``DL4J_DEVICE_BUDGET_BYTES``, else None
    (capacity unknown: the planner admits)."""
    with _lock:
        if _state["budget_resolved"]:
            return _state["budget"]
    env = os.environ.get("DL4J_DEVICE_BUDGET_BYTES")
    budget = None
    if env:
        try:
            budget = int(float(env))
        except ValueError:
            log.warning("DL4J_DEVICE_BUDGET_BYTES=%r is not a number; "
                        "ignored", env)
    with _lock:
        if not _state["budget_resolved"]:
            _state["budget"] = budget
    return budget


# ---------------------------------------------------------------------------
# typed errors
# ---------------------------------------------------------------------------

class DeviceOomError(RuntimeError):
    """A device allocation failure, enriched at the seam that caught it:
    ``site`` names the boundary, ``requested_bytes`` the allocation the
    error reported (None when unparseable), ``claims`` the top owners at
    failure (``[{category, name, device, bytes}]``)."""

    def __init__(self, message, site=None, requested_bytes=None,
                 claims=None):
        super().__init__(message)
        self.site = site
        self.requested_bytes = requested_bytes
        self.claims = list(claims or ())


class CapacityError(RuntimeError):
    """A prospective allocation (``need_bytes`` at ``site``) exceeds the
    device's headroom; raised before anything is allocated. ``detail``
    carries the planner's breakdown."""

    def __init__(self, message, site=None, need_bytes=None,
                 headroom_bytes=None, detail=None):
        super().__init__(message)
        self.site = site
        self.need_bytes = need_bytes
        self.headroom_bytes = headroom_bytes
        self.detail = dict(detail or {})


# ---------------------------------------------------------------------------
# byte accounting helpers
# ---------------------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def tree_bytes(tree) -> int:
    """Total bytes of the array leaves of nested dicts, lists and tuples:
    tensors (on any device, "meta" included) and numpy arrays; other
    leaves count zero."""
    total = 0
    for leaf in _leaves(tree):
        numel = getattr(leaf, "numel", None)
        size = getattr(leaf, "element_size", None)
        if callable(numel) and callable(size):
            total += int(numel()) * int(size())
            continue
        nbytes = getattr(leaf, "nbytes", None)
        if nbytes is not None:
            total += int(nbytes)
            continue
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is not None and dtype is not None:
            try:
                total += int(np.prod(shape, dtype=np.int64)
                             * np.dtype(dtype).itemsize)
            except TypeError:
                pass
    return total


def device_label(device=None) -> str:
    """The ledger's label of a device ("cuda:0", "cpu:0"); with none, the
    card the port runs on by default, else the CPU."""
    if device is None:
        if torch.cuda.is_available():
            return f"cuda:{torch.cuda.current_device()}"
        return "cpu:0"
    dtype = getattr(device, "type", None)
    if dtype is None:
        text = str(device)
        dtype, _, idx = text.partition(":")
        return f"{dtype}:{idx or 0}"
    return f"{dtype}:{device.index or 0}"


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------

class Claim:
    """One subsystem's registered ownership of device bytes: the handle
    its owner keeps (``update``, ``touch``, ``release``)."""

    __slots__ = ("category", "name", "device", "bytes", "meta",
                 "created_at", "_ledger", "released")

    def __init__(self, ledger, category, name, nbytes, device, meta):
        self.category = str(category)
        self.name = str(name)
        self.device = device
        self.bytes = int(nbytes)
        self.meta = meta or {}
        self.created_at = time.time()
        self._ledger = ledger
        self.released = False

    def update(self, nbytes=None, tree=None, **meta):
        if tree is not None:
            nbytes = tree_bytes(tree)
        if meta:
            self.meta.update(meta)
        self._ledger.restate(self, int(nbytes) if nbytes is not None
                             else self.bytes)
        return self

    def touch(self):
        self._ledger.publish_total(self.category, self.device)
        return self

    def release(self):
        self._ledger.release_claim(self)

    def describe(self) -> dict:
        return {"category": self.category, "name": self.name,
                "device": self.device, "bytes": self.bytes,
                "age_seconds": round(time.time() - self.created_at, 3),
                **({"meta": self.meta} if self.meta else {})}


class MemLedger:
    """The process-wide claims table: ``(category, name)`` -> Claim, with
    running totals per ``(category, device)``."""

    def __init__(self):
        self._claims: dict = {}
        self._totals: dict = {}
        self._lock = threading.Lock()

    def claim(self, category, name, nbytes, device, meta=None) -> Claim:
        key = (str(category), str(name))
        with self._lock:
            existing = self._claims.get(key)
            if existing is not None:
                self._totals[(existing.category, existing.device)] -= \
                    existing.bytes
                existing.bytes = int(nbytes)
                existing.device = device
                existing.released = False
                if meta:
                    existing.meta.update(meta)
                c = existing
            else:
                c = Claim(self, category, name, nbytes, device, meta)
                self._claims[key] = c
            tkey = (c.category, c.device)
            self._totals[tkey] = self._totals.get(tkey, 0) + c.bytes
        self.publish_total(c.category, c.device)
        return c

    def restate(self, c: Claim, nbytes: int):
        with self._lock:
            if self._claims.get((c.category, c.name)) is not c:
                return
            tkey = (c.category, c.device)
            self._totals[tkey] = \
                self._totals.get(tkey, 0) - c.bytes + nbytes
            c.bytes = nbytes
        self.publish_total(c.category, c.device)

    def release_claim(self, c: Claim):
        with self._lock:
            if self._claims.get((c.category, c.name)) is not c:
                return
            del self._claims[(c.category, c.name)]
            tkey = (c.category, c.device)
            self._totals[tkey] = self._totals.get(tkey, 0) - c.bytes
            c.released = True
        self.publish_total(c.category, c.device)

    def release(self, category, name):
        with self._lock:
            c = self._claims.get((str(category), str(name)))
        if c is not None:
            self.release_claim(c)

    def release_prefix(self, category, name_prefix) -> int:
        with self._lock:
            hits = [c for (cat, name), c in self._claims.items()
                    if cat == category and name.startswith(name_prefix)]
        for c in hits:
            self.release_claim(c)
        return len(hits)

    def claims(self, category=None) -> list:
        with self._lock:
            out = list(self._claims.values())
        if category is not None:
            out = [c for c in out if c.category == category]
        return sorted(out, key=lambda c: -c.bytes)

    def get(self, category, name):
        with self._lock:
            return self._claims.get((str(category), str(name)))

    def total(self, category=None, device=None) -> int:
        with self._lock:
            return sum(v for (cat, dev), v in self._totals.items()
                       if (category is None or cat == category)
                       and (device is None or dev == device))

    def top(self, n=None) -> list:
        n = n if n is not None else _state["top_n"]
        return [c.describe() for c in self.claims()[:n]]

    def _gauge(self):
        if not _registry.enabled():
            return None
        return _registry.get_registry().gauge(
            "dl4j_device_memory_claimed_bytes", CLAIMED_HELP,
            ("category", "device"))

    def publish_total(self, category, device):
        """One gauge-set: the running (category, device) total."""
        fam = self._gauge()
        if fam is None:
            return
        with self._lock:
            val = self._totals.get((category, device), 0)
        fam.labels(category=category, device=device).set(max(0, val))


def get_memledger() -> MemLedger:
    led = _state["ledger"]
    if led is None:
        with _lock:
            led = _state["ledger"]
            if led is None:
                led = MemLedger()
                _state["ledger"] = led
    return led


def set_ledger(ledger):
    """Swap the process ledger (tests). Returns the previous one."""
    prev = _state["ledger"]
    _state["ledger"] = ledger
    return prev


def enabled() -> bool:
    return _registry.enabled() and _state["enabled"]


def claim(category, name, nbytes=None, tree=None, device=None, **meta):
    """Register (or re-state) a claim; None when telemetry is disabled."""
    if not enabled():
        return None
    if tree is not None:
        nbytes = tree_bytes(tree)
    dev = device if isinstance(device, str) else device_label(device)
    return get_memledger().claim(category, name, int(nbytes or 0), dev,
                                 meta or None)


def release(category, name):
    """Drop a claim by key (idempotent, telemetry on or off)."""
    led = _state["ledger"]
    if led is not None:
        led.release(category, name)


# ---------------------------------------------------------------------------
# headroom
# ---------------------------------------------------------------------------

def _cuda_labels():
    if not torch.cuda.is_available():
        return []
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def _device_usage(device=None):
    """{label: {"in_use", "limit", "source"}}: CUDA devices from
    ``mem_get_info`` and the caching allocator's statistics, the CPU from
    the configured budget and the ledger's claims on it."""
    out = {}
    for label in _cuda_labels():
        if device is not None and label != device:
            continue
        idx = int(label.split(":")[1])
        free, total = torch.cuda.mem_get_info(idx)
        stats = torch.cuda.memory_stats(idx)
        cached = int(stats.get("reserved_bytes.all.current", 0)) - int(
            stats.get("allocated_bytes.all.current", 0))
        out[label] = {"in_use": int(total) - int(free) - max(0, cached),
                      "limit": int(total), "source": "mem_get_info"}
    if device is None or not device.startswith("cuda"):
        label = device or "cpu:0"
        led = _state["ledger"]
        out[label] = {"in_use": led.total(device=label) if led else 0,
                      "limit": budget_bytes(), "source": "claims"}
    return out


def capacity_known(device=None) -> bool:
    """Whether the device (any device, with none named) has a known
    capacity: a CUDA card always, another device only under a configured
    budget. False means the planner admits regardless."""
    cuda = _cuda_labels()
    if device is None and cuda:
        return True
    if device is not None and device in cuda:
        return True
    return budget_bytes() is not None


def headroom(device=None) -> int | None:
    """Bytes the planner can admit against (the smallest over the devices
    considered), or None when no capacity is known."""
    if not capacity_known(device=device):
        return None
    best = None
    for row in _device_usage(device).values():
        if not row["limit"]:
            continue
        free = max(0, row["limit"] - row["in_use"])
        best = free if best is None else min(best, free)
    return best


# ---------------------------------------------------------------------------
# OOM forensics
# ---------------------------------------------------------------------------

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory")
_BYTES_RE = re.compile(
    r"(?:allocat\w+\s+|allocate\s+)(\d+)\s*(?:bytes|B)\b")
# torch.cuda.OutOfMemoryError: "Tried to allocate 20.00 MiB"
_TORCH_RE = re.compile(r"allocate\s+([\d.]+)\s*(B|KiB|MiB|GiB|TiB)\b")
_UNITS = {"B": 1, "KiB": 1 << 10, "MiB": 1 << 20, "GiB": 1 << 30,
          "TiB": 1 << 40}


def is_oom(exc) -> bool:
    """Is this exception an allocation failure? (A DeviceOomError is
    already converted.)"""
    if isinstance(exc, DeviceOomError):
        return False
    if isinstance(exc, MemoryError):
        return True
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    msg = str(exc)
    return any(m in msg for m in _OOM_MARKERS)


def requested_bytes(exc) -> int | None:
    msg = str(exc)
    m = _BYTES_RE.search(msg)
    if m:
        return int(m.group(1))
    m = _TORCH_RE.search(msg)
    if m:
        return int(float(m.group(1)) * _UNITS[m.group(2)])
    return None


def oom_error(exc, site, **context) -> DeviceOomError | None:
    """When ``exc`` is an allocation failure: record the flight ``oom``
    event and return the typed error for the seam to raise or fail
    requests with; else None."""
    if not is_oom(exc):
        return None
    req = requested_bytes(exc)
    led = _state["ledger"]
    top = led.top() if isinstance(led, MemLedger) else []
    try:
        flight.record("oom", site=site, requested_bytes=req,
                      error=f"{type(exc).__name__}: {exc}",
                      claims=top, **context)
    except Exception:   # forensics must never mask the failure
        pass
    log.error("device OOM at %s (requested %s bytes); top claims: %s",
              site, req, [(c["category"], c["name"], c["bytes"])
                          for c in top[:3]])
    detail = f" requesting {req} bytes" if req is not None else ""
    return DeviceOomError(
        f"device out of memory at {site}{detail}: "
        f"{type(exc).__name__}: {exc}",
        site=site, requested_bytes=req, claims=top)


def raise_if_oom(exc, site, **context):
    """Convert-and-raise when ``exc`` is an OOM, else return."""
    err = oom_error(exc, site, **context)
    if err is not None:
        raise err from exc


# ---------------------------------------------------------------------------
# admission-time capacity planning
# ---------------------------------------------------------------------------

def plan_capacity(site, need_bytes, detail=None, device=None):
    """Admit or refuse a prospective allocation of ``need_bytes`` at
    ``site`` against the device's headroom: raises ``CapacityError``
    (before anything is allocated) when the headroom is known and too
    small; returns the plan otherwise. Unknown headroom admits."""
    need = int(need_bytes)
    hr = headroom(device=device)
    plan = {"site": site, "need_bytes": need, "headroom_bytes": hr,
            "fits": hr is None or need <= hr,
            **({"detail": dict(detail)} if detail else {})}
    flight.record("capacity_plan", **{k: v for k, v in plan.items()
                                      if k != "detail"})
    if not plan["fits"]:
        raise CapacityError(
            f"capacity planner rejected {site}: needs {need} bytes, "
            f"only {hr} bytes of device headroom "
            f"(breakdown: {detail or {}})",
            site=site, need_bytes=need, headroom_bytes=hr,
            detail=detail)
    return plan

