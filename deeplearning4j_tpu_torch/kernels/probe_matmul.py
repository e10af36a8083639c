"""A bf16 matrix product with float32 sums as a hand-written CUDA kernel.

Counterpart of the Pallas kernel of ``tools/probe_matmul.py`` (``kern``,
launched by ``bench_pallas``): a [M, K] by b [K, N] in bfloat16, summed in
float32, the result rounded to bfloat16. The reference's ``bm`` (rows of a
per grid step) is a TPU blocking knob that does not change the result;
``csrc/probe_matmul.cu`` has its own tiling (wgmma fed by TMA), chosen by
shape: ``plan`` computes it as the source does, ``source_plan`` asks the
compiled source.

``matmul_bf16`` takes its plain version only for tensors on the CPU; on a
CUDA tensor it launches the kernel or raises. It counts its launches in
``.launches``.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.kernels import build
from deeplearning4j_tpu_torch.kernels.lstm import _count


# (consumer warpgroups, BN) by preference; BM = 64 * warpgroups
TILES = ((2, 128), (1, 64))
BK = 64                    # k of a ring stage
SMEM_BUDGET = 224 * 1024   # shared bytes of the ring and the out tile
MAX_STAGES = 6
PLAN_FIELDS = ("bm", "bn", "stages", "threads", "smem_bytes", "tiles_m",
               "tiles_n", "grid")


def _ceil(a, b):
    return -(-a // b)


def plan(m, k, n, sms):
    """The kernel's launch plan at a [m, k] x [k, n] on a card of ``sms``
    SMs, as ``csrc/probe_matmul.cu`` computes it (``probe_matmul_plan``),
    for the CPU tests: the first tile of ``TILES`` that makes at least a
    third as many tiles as there are SMs and is no wider than n needs
    (else the smallest); the bf16 out tile staged in shared memory, and a
    ring of as many [bm, 64] + [64, bn] bf16 stages as fit beside it in
    224 KB (at most 6); a persistent grid of min(tiles, sms) blocks, block
    i taking tiles i, i + grid, ... A dict of ``PLAN_FIELDS``."""
    if min(m, k, n, sms) < 1 or k % 16 or n % 16:
        raise ValueError(f"matmul_bf16: no plan for M={m}, K={k}, N={n} "
                         f"on {sms} SMs")
    for i, (wg, bn) in enumerate(TILES):
        bm = 64 * wg
        tiles = _ceil(m, bm) * _ceil(n, bn)
        if i == len(TILES) - 1 or (3 * tiles >= sms and
                                   bn <= _ceil(n, 64) * 64):
            break
    stage = (bm + bn) * BK * 2
    out_tile = bm * bn * 2
    stages = min(MAX_STAGES, (SMEM_BUDGET - out_tile) // stage)
    return dict(bm=bm, bn=bn, stages=stages, threads=128 * (wg + 1),
                smem_bytes=stages * stage + out_tile + 1024 + 2 * stages * 8,
                tiles_m=_ceil(m, bm), tiles_n=_ceil(n, bn),
                grid=min(tiles, sms))


def source_plan(m, k, n, device=None):
    """The plan asked of the compiled source for the current card (nothing
    launched)."""
    out = torch.zeros(len(PLAN_FIELDS), dtype=torch.int32)
    device = torch.device("cuda") if device is None else device
    rc = build.query("probe_matmul", "probe_matmul_plan", "matmul plan",
                     [m, k, n, out], device)
    if rc != 0:
        raise ValueError(f"matmul_bf16: the source refuses M={m}, K={k}, "
                         f"N={n} (code {rc})")
    return dict(zip(PLAN_FIELDS, (int(x) for x in out)))


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
