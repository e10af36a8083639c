"""A bf16 matrix product with float32 sums as a hand-written CUDA kernel.

Counterpart of the Pallas kernel of ``tools/probe_matmul.py`` (``kern``,
launched by ``bench_pallas``): a [M, K] by b [K, N] in bfloat16, summed in
float32, the result rounded to bfloat16. The reference's ``bm`` (rows of a
per grid step) is a TPU blocking knob that does not change the result;
``csrc/probe_matmul.cu`` has its own tiling.

``matmul_bf16`` takes its plain version only for tensors on the CPU; on a
CUDA tensor it launches the kernel or raises. It counts its launches in
``.launches``.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.kernels import build
from deeplearning4j_tpu_torch.kernels.lstm import _count


def matmul_bf16_reference(a, b):
    """The plain version: upcast to float32, multiply, round to bf16."""
    return (a.float() @ b.float()).to(torch.bfloat16)


def aligned(t):
    """``t`` contiguous with a 16-byte aligned start (the kernels read 16
    bytes at a time), copied only where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def matmul_bf16(a, b):
    """bf16(a b) with float32 sums; a [M, K] and b [K, N] bfloat16."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0] \
            or min(*a.shape, b.shape[1]) < 1:
        raise ValueError(f"matmul_bf16: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not make [M, K] x [K, N]")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise ValueError(f"matmul_bf16: dtypes {a.dtype} and {b.dtype} "
                         f"(bfloat16 only)")
    if a.device != b.device:
        raise ValueError("matmul_bf16: inputs lie on different devices")
    if a.device.type == "cpu":
        return matmul_bf16_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"matmul_bf16: unsupported device {a.device}")
    m, k = a.shape
    n = b.shape[1]
    if k % 16 or n % 16:
        raise ValueError(f"matmul_bf16: K={k} and N={n} must be multiples "
                         f"of 16")
    a, b = aligned(a), aligned(b)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    build.call("probe_matmul", "probe_matmul_bf16", "matmul_bf16",
               [a, b, out, m, k, n], a.device)
    _count(matmul_bf16)
    return out


matmul_bf16.launches = 0
