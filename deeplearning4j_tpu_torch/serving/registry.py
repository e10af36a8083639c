"""ModelRegistry: named, versioned servables with bucket-ladder warmup.

Counterpart of ``deeplearning4j_tpu/serving/registry.py`` without the
capacity planner and telemetry hooks (they come with the telemetry
slice): a registry row is (name, version) -> Servable + BucketLadder, and
`warmup()` runs the ladder's shapes once.
"""

from __future__ import annotations

import threading
import time

from deeplearning4j_tpu_torch.serving.buckets import BucketLadder
from deeplearning4j_tpu_torch.serving.servable import Servable, as_servable


class ModelNotFound(KeyError):
    pass


class _Entry:
    __slots__ = ("name", "version", "servable", "ladder", "registered_at",
                 "warmed", "warmup_seconds")

    def __init__(self, name, version, servable, ladder):
        self.name = name
        self.version = int(version)
        self.servable = servable
        self.ladder = ladder
        self.registered_at = time.time()
        self.warmed = False
        self.warmup_seconds = None

    def warmup(self):
        t0 = time.perf_counter()
        self.servable.warmup(self.ladder)
        self.warmup_seconds = time.perf_counter() - t0
        self.warmed = True
        return self

    def describe(self) -> dict:
        sv = self.servable
        return {
            "name": self.name,
            "version": self.version,
            "type": type(sv).__name__,
            "example_shape": list(sv.example_shape),
            "dtype": str(sv.dtype),
            "device": str(sv.device),
            "ladder": self.ladder.describe(),
            "warmed": self.warmed,
            "warmed_shapes": [list(s) for s in sv.warmed_shapes],
            "warmup_seconds": self.warmup_seconds,
        }


class ModelRegistry:
    """name -> {version -> entry}; lookups default to the newest
    version. Re-register the same (name, version) to replace it (in-flight
    requests on the old entry finish on the old servable)."""

    def __init__(self, ladder: BucketLadder | None = None):
        self.default_ladder = ladder or BucketLadder()
        self._models: dict[str, dict[int, _Entry]] = {}
        self._lock = threading.Lock()

    def register(self, name, model, version=1, example_shape=None,
                 dtype=None, ladder=None, input_name=None,
                 output_name=None, warmup=False) -> _Entry:
        """dtype=None takes the serving dtype from the model's dataType;
        a SameDiff graph is served from its placeholder ``input_name`` to
        its variable ``output_name``."""
        sv = (model if isinstance(model, Servable)
              else as_servable(model, example_shape, dtype,
                               input_name=input_name,
                               output_name=output_name))
        ladder = ladder if ladder is not None else self.default_ladder
        if isinstance(ladder, (list, tuple)):
            ladder = BucketLadder(ladder)
        entry = _Entry(name, version, sv, ladder)
        if warmup:
            # warm before the entry goes live: a failed warmup leaves the
            # registry as it was
            entry.warmup()
        with self._lock:
            self._models.setdefault(name, {})[entry.version] = entry
        return entry

    def unregister(self, name, version=None):
        with self._lock:
            if name not in self._models:
                raise ModelNotFound(name)
            if version is None:
                del self._models[name]
                return
            try:
                del self._models[name][int(version)]
            except KeyError:
                raise ModelNotFound(f"{name}:{version}") from None
            if not self._models[name]:
                del self._models[name]

    def get(self, name, version=None) -> _Entry:
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise ModelNotFound(name)
            if version is None:
                return versions[max(versions)]
            try:
                return versions[int(version)]
            except KeyError:
                raise ModelNotFound(f"{name}:{version}") from None

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._models)

    def entries(self) -> list[_Entry]:
        with self._lock:
            return [e for vs in self._models.values()
                    for e in vs.values()]

    def warmup(self, name=None, version=None):
        """Warm one model's ladder, or every version of every model."""
        entries = ([self.get(name, version)] if name is not None
                   else self.entries())
        for e in entries:
            e.warmup()
        return self

    def describe(self) -> list[dict]:
        """Every (name, version) row, newest version first per name."""
        return [e.describe() for e in
                sorted(self.entries(), key=lambda e: (e.name, -e.version))]
