"""Tensor-core efficiency against matmul shape: the hand-written bf16
kernel (``kernels/probe_matmul.py``) and cuBLAS, bf16 operands, float32
sums. Calibrates what fraction of the H100's dense bf16 peak each (M, K, N)
sustains, the shape ceiling any conv formulation inherits.

    python -m deeplearning4j_tpu_torch.tools.probe_matmul

Counterpart of ``tools/probe_matmul.py``: the same 11 shapes; the kernel
runs where the reference ran its Pallas kernel (M divisible by one of its
row blocks 784 or 3136, with both operands' blocks under 80 MB), cuBLAS
(``torch.matmul``, the yardstick of the reference's XLA dot) at every
shape. One JSON line per measurement.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend import resolve_device
from deeplearning4j_tpu_torch.kernels.probe_matmul import matmul_bf16
from deeplearning4j_tpu_torch.tools.common import measurement, time_ms

K_ITERS = 30
SHAPES = [
    (784, 1024, 256), (1568, 1024, 256), (3136, 1024, 256),
    (784, 256, 256), (3136, 256, 256),
    (784, 256, 1024), (3136, 256, 1024),
    (4096, 4096, 4096), (8192, 2048, 2048),
    (50176, 1024, 256), (50176, 256, 256),
]
ROW_BLOCKS = (784, 3136)   # the reference's bm values


def kernel_runs(m, k, n):
    """Whether the reference ran its Pallas kernel at this shape."""
    return any(m % bm == 0 and bm * (k + n) * 2 < 80e6 for bm in ROW_BLOCKS)


def inputs(m, k, n, device):
    """a [m, k] and b [k, n] in bf16, normal * 0.1 from numpy seeds 0, 1."""
    a = np.random.default_rng(0).standard_normal((m, k), np.float32) * 0.1
    b = np.random.default_rng(1).standard_normal((k, n), np.float32) * 0.1
    return (torch.tensor(a, device=device).to(torch.bfloat16),
            torch.tensor(b, device=device).to(torch.bfloat16))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain versions)")
    device = resolve_device(ap.parse_args(argv).device)
    library = "cublas" if device.type == "cuda" else "torch_cpu"
    records = []
    for m, k, n in SHAPES:
        a, b = inputs(m, k, n, device)
        flops = 2 * m * k * n
        records.append(measurement(
            device, time_ms(lambda: torch.matmul(a, b), K_ITERS, device),
            flops, m=m, k=k, n=n, path=library))
        if kernel_runs(m, k, n):
            records.append(measurement(
                device, time_ms(lambda: matmul_bf16(a, b), K_ITERS, device),
                flops, m=m, k=k, n=n, path="kernel"))
    return records


if __name__ == "__main__":
    main()
