"""Typed runtime configuration.

Counterpart of ``deeplearning4j_tpu/runtime.py``, with the same fields.
PyTorch has no XLA and no jit here, so the knobs map as follows:

- ``platform``: None, "cuda" or "cpu". ``apply`` checks that the backend
  is there (``Nd4jBackend.load(force=...)``) and makes it the default
  device of ``Nd4j``'s factories. Networks keep their own ``device=``.
- ``host_device_count``: None or 1. Virtual devices belong to the
  parallel tier, which is not ported.
- ``matmul_precision``: None or "highest". The port computes float32 in
  float32 (TF32 off), so "high" and "default", which would turn TF32 on,
  are refused.
- ``deterministic``: ``torch.use_deterministic_algorithms(True,
  warn_only=True)`` and ``cudnn.deterministic``.
- ``debug_nans`` / ``debug_infs``: autograd's anomaly detection, which
  raises where a backward pass makes a NaN.
- ``disable_jit``: nothing to do, PyTorch runs eagerly.
- ``extra_xla_flags``: must be empty.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from deeplearning4j_tpu_torch.backend import Nd4jBackend


@dataclass
class RuntimeConfig:
    platform: str | None = None
    host_device_count: int | None = None
    matmul_precision: str | None = None
    deterministic: bool = False
    debug_nans: bool = False
    debug_infs: bool = False
    disable_jit: bool = False
    extra_xla_flags: list[str] = field(default_factory=list)

    def apply(self) -> "RuntimeConfig":
        if self.matmul_precision not in (None, "highest"):
            raise ValueError(
                f"matmul_precision {self.matmul_precision!r} would turn "
                f"TF32 on; the port computes float32 in float32, so only "
                f"'highest' is taken")
        if self.host_device_count not in (None, 1):
            raise NotImplementedError(
                "virtual host devices come with the parallel tier "
                "(ROADMAP.md, queue 1)")
        if self.extra_xla_flags:
            raise ValueError("the port runs no XLA: extra_xla_flags must "
                             "be empty")
        if self.platform is not None:
            from deeplearning4j_tpu_torch.ndarray import Nd4j

            backend = Nd4jBackend.load(force=self.platform)
            Nd4j.setDefaultDevice(backend.platform)
        if self.matmul_precision == "highest":
            torch.set_float32_matmul_precision("highest")
        if self.deterministic:
            torch.use_deterministic_algorithms(True, warn_only=True)
            torch.backends.cudnn.deterministic = True
        if self.debug_nans or self.debug_infs:
            torch.autograd.set_detect_anomaly(True)
        return self

    @staticmethod
    def cpu_mesh(n_devices: int = 8,
                 matmul_precision: str = "highest") -> "RuntimeConfig":
        """The JAX package's in-process multi-device simulation; the port
        takes only ``n_devices=1`` when it is applied."""
        return RuntimeConfig(platform="cpu", host_device_count=n_devices,
                             matmul_precision=matmul_precision)

    @staticmethod
    def environment() -> dict:
        """The runtime's facts: backend, devices, versions."""
        backend = Nd4jBackend.load()
        return {
            "backend": backend.name,
            "device_count": backend.device_count,
            "devices": [str(d) for d in Nd4jBackend.devices()],
            "process_count": 1,
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "cudnn_version": (torch.backends.cudnn.version()
                              if torch.backends.cudnn.is_available()
                              else None),
            "matmul_precision": torch.get_float32_matmul_precision(),
        }
