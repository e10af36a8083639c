"""Device resolution and numeric policy for the PyTorch/CUDA port.

The port runs on the GPU. An entry point given no device takes "cuda" and
raises when CUDA is absent; the CPU is used only when the caller names it
(the CPU tests do). There is no silent fallback to the CPU.

The JAX package computes in float32, so TF32 is off for matmuls and for
cuDNN: TF32 keeps about three decimal digits and would break parity.
Where the build has the per-backend switch, cuDNN's convolutions are also
set to "ieee" by name (``allow_tf32 = False`` alone leaves it reading
"none", inherited).

``Nd4jBackend`` picks between the backends that are there, "cuda" before
"cpu" (the counterpart of the JAX package's TPU-then-CPU discovery).
``load`` takes ``force=`` only: no environment variable reroutes a path,
so the JAX package's ``DL4J_TPU_BACKEND`` is not read.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
if hasattr(getattr(torch.backends.cudnn, "conv", None), "fp32_precision"):
    torch.backends.cudnn.conv.fp32_precision = "ieee"

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: "cuda" unless the caller names
    another. Raises RuntimeError when CUDA is asked for (explicitly or by
    default) and is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' to run its plain CPU versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        # name the card, so tensors' devices (cuda:0) compare equal
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(name) -> torch.dtype:
    """The torch dtype of a configuration's dataType string."""
    if isinstance(name, torch.dtype):
        return name
    key = str(name)
    if key not in _DTYPES:
        raise ValueError(f"unsupported dataType {name!r}")
    return _DTYPES[key]


@dataclass(frozen=True)
class Backend:
    """One loadable execution backend."""

    name: str              # "cuda" | "cpu"
    platform: str          # torch device type
    priority: int          # higher wins
    device_count: int

    def isAvailable(self):
        return self.device_count > 0


class Nd4jBackend:
    """The highest-priority available backend, picked once a process."""

    _loaded: Backend | None = None
    _forced: dict = {}

    @classmethod
    def _discover(cls) -> list[Backend]:
        found = []
        if torch.cuda.is_available() and torch.cuda.device_count():
            found.append(Backend("cuda", "cuda", 100,
                                 torch.cuda.device_count()))
        found.append(Backend("cpu", "cpu", 0, 1))
        return found

    @classmethod
    def availableBackends(cls) -> list[Backend]:
        return sorted(cls._discover(), key=lambda b: -b.priority)

    @classmethod
    def load(cls, force: str | None = None) -> Backend:
        """The highest-priority available backend (memoized), or the one
        ``force`` names; a named backend that is not there raises instead
        of falling back."""
        if force is not None:
            name = str(force).lower()
            if name in cls._forced:
                return cls._forced[name]
            backends = cls.availableBackends()
            for b in backends:
                if b.name == name:
                    cls._forced[name] = b
                    return b
            raise RuntimeError(
                f"backend {force!r} requested but not available (found: "
                f"{[b.name for b in backends]})")
        if cls._loaded is None:
            cls._loaded = cls.availableBackends()[0]
        return cls._loaded

    @classmethod
    def devices(cls, force: str | None = None) -> list[torch.device]:
        b = cls.load(force)
        return [torch.device(b.platform, i) if b.platform == "cuda"
                else torch.device("cpu") for i in range(b.device_count)]

    @classmethod
    def reset(cls):
        """Forget the memoized selections."""
        cls._loaded = None
        cls._forced = {}
