"""Device resolution and numeric policy for the PyTorch/CUDA port.

The port runs on the GPU. An entry point given no device takes "cuda" and
raises when CUDA is absent; the CPU is used only when the caller names it
(the CPU tests do). There is no silent fallback to the CPU.

The JAX package computes in float32, so TF32 is off for matmuls and for
cuDNN: TF32 keeps about three decimal digits and would break parity.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

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
