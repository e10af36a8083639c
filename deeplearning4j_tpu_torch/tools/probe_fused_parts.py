"""Component timing for the fused bottleneck kernel: where do the
microseconds that are not products go? Variants (s2 shape, g=4, b256),
all ``kernels/bottleneck.py`` on ``csrc/fused_bottleneck.cu``:

  matmuls - the three products only, the 3x3 step unshifted
            (``block_matmuls``; its numbers are not a conv's)
  +pad    - the 9 taps as row shifts within each group of g images
            (``block_pad``; no masks, so taps wrap across image edges)
  +mask   - + the 9 edge masks: the exact conv (``block_mask``)
  folded  - bf16 bias epilogues, x-edge masks only (``block_folded``;
            at g > 1 an image's top and bottom rows read the neighbouring
            image's rows, as the reference's ``k_folded`` does)

    python -m deeplearning4j_tpu_torch.tools.probe_fused_parts

Counterpart of ``tools/probe_fused_parts.py``: H, C, F = 14, 1024, 256,
N = 256, G = 4, K = 40 calls per timed run, the same input scales (numpy
seed 0). One JSON line per variant.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend import resolve_device
from deeplearning4j_tpu_torch.kernels import bottleneck
from deeplearning4j_tpu_torch.tools.common import measurement, time_ms

H, C, F = 14, 1024, 256
N, G, K = 256, 4, 40


def make_inputs(n, h, c, f, device):
    """x [n h h, c], w1, w2, w3 bf16 and zero f32 biases b1, b2, b3, from
    numpy seed 0 at the reference's scales."""
    rng = np.random.default_rng(0)
    bf = lambda a: torch.tensor(a.astype(np.float32),  # noqa: E731
                                device=device).to(torch.bfloat16)
    x = bf(rng.normal(size=(n * h * h, c)) * 0.3)
    w1 = bf(rng.normal(size=(c, f)) * 0.04)
    w2 = bf(rng.normal(size=(9, f, f)) * 0.02)
    w3 = bf(rng.normal(size=(f, c)) * 0.06)
    zeros = lambda w: torch.zeros(1, w, device=device)  # noqa: E731
    return x, w1, w2, w3, zeros(f), zeros(f), zeros(c)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain versions)")
    device = resolve_device(ap.parse_args(argv).device)
    h, c, f, n, g = H, C, F, N, G
    flops = n * 2 * h * h * (c * f + 9 * f * f + f * c)
    x, w1, w2, w3, b1, b2, b3 = make_inputs(n, h, c, f, device)
    runs = (
        ("matmuls", lambda: bottleneck.block_matmuls(x, w1, w2, w3, h=h,
                                                     g=g)),
        ("+pad", lambda: bottleneck.block_pad(x, w1, w2, w3, h=h, g=g)),
        ("+mask", lambda: bottleneck.block_mask(x, w1, w2, w3, h=h, g=g)),
        ("folded", lambda: bottleneck.block_folded(x, w1, b1, w2, b2, w3,
                                                   b3, h=h, g=g)),
    )
    return [measurement(device, time_ms(fn, K, device), flops,
                        variant=label, g=g) for label, fn in runs]


if __name__ == "__main__":
    main()
