"""One identity ResNet bottleneck block in one hand-written kernel against
cuBLAS and cuDNN, forward only.

    python -m deeplearning4j_tpu_torch.tools.probe_fused_block \
        [--stage s2] [--batch 256] [--g 0] [--k 20] [--check]

Counterpart of ``tools/probe_fused_block.py``: the same stages (ResNet-50's
stage widths), batch, g sweep and check. The block is

    conv1x1 -> affine -> relu -> conv3x3 -> affine -> relu
    -> conv1x1 -> affine -> +residual -> relu

in bf16 with float32 sums, BN folded to affine scale and shift. Paths:

- ``library_dot``: ``library_block``, the 1x1 convs as cuBLAS matmuls
  (``torch.matmul`` on bf16) and the 3x3 as cuDNN ``conv2d`` in
  channels-last bf16 (the reference's ``xla_block``);
- ``library_conv``: ``library_block_conv``, three cuDNN ``conv2d``s (the
  reference's ``xla_block_conv``);
- ``kernel2d_g*`` / ``kernel4d_g*``: ``kernels/bottleneck.py``
  ``fused_block2d`` / ``fused_block`` (``csrc/fused_bottleneck.cu``).

The library paths are yardsticks, timed and never called by a kernel. They
round each product to bf16 before its affine (cuBLAS and cuDNN return
bf16), one rounding more than the kernels, so ``--check`` holds the kernels
against ``library_block`` at CHECK_TOL of its largest element. A g that
the kernel refuses is skipped with its reason, before any launch; a failed
launch is not caught. One JSON line per measurement.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as nnf

from deeplearning4j_tpu_torch.backend import resolve_device
from deeplearning4j_tpu_torch.kernels import bottleneck
from deeplearning4j_tpu_torch.tools.common import emit, measurement, time_ms
from deeplearning4j_tpu_torch.utils.convert import (
    bottleneck_params_from_numpy)

# (H, C, F): spatial, block channels, bottleneck width
STAGES = {
    "s0": (56, 256, 64),
    "s1": (28, 512, 128),
    "s2": (14, 1024, 256),
    "s3": (7, 2048, 512),
}
G_SWEEP = (2, 4, 8, 16)
# kernel vs library_block, relative to the largest element: the library
# rounds y3 to bf16 before its affine (one bf16 ulp is 2^-8 relative) and
# the output is bf16 too
CHECK_TOL = 2e-2


def block_flops(h, c, f):
    return 2 * h * h * (c * f + 9 * f * f + f * c)


def make_params(seed, c, f):
    """The reference's ``make_params`` from a numpy seed: He-scaled
    normal weights (rounded to bf16 by ``bottleneck_params_from_numpy``),
    affines s1 = 1, s2 = 0.5, s3 = 0.3 and zero shifts; numpy leaves."""
    rng = np.random.default_rng(seed)
    sc = lambda shp, s: rng.standard_normal(shp, np.float32) * s  # noqa
    return {
        "w1": sc((c, f), (2.0 / c) ** 0.5),
        "w2": sc((9, f, f), (2.0 / (9 * f)) ** 0.5),
        "w3": sc((f, c), (2.0 / f) ** 0.5),
        "s1": np.full((1, f), 1.0, np.float32),
        "b1": np.zeros((1, f), np.float32),
        "s2": np.full((1, f), 0.5, np.float32),
        "b2": np.zeros((1, f), np.float32),
        "s3": np.full((1, c), 0.3, np.float32),
        "b3": np.zeros((1, c), np.float32),
    }


def make_input(seed, n, h, c, device):
    """x [n, h, h, c] bf16, normal * 0.5."""
    x = np.random.default_rng(seed).standard_normal((n, h, h, c),
                                                    np.float32) * 0.5
    return torch.tensor(x, device=device).to(torch.bfloat16)


def _affine(y, s, b):
    return y.float() * s.reshape(-1) + b.reshape(-1)


def _conv(y, w_oihw, pad):
    """cuDNN conv2d on NHWC y, channels-last bf16; NHWC out."""
    out = nnf.conv2d(y.permute(0, 3, 1, 2), w_oihw, padding=pad)
    return out.permute(0, 2, 3, 1)


def _w2_oihw(w2):
    f = w2.shape[-1]
    return w2.reshape(3, 3, f, f).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)


def library_block(x, params):
    """The block with cuBLAS matmuls for the 1x1s and a cuDNN conv2d for
    the 3x3 (the reference's ``xla_block``)."""
    p = params
    y = torch.matmul(x, p["w1"])
    y = torch.relu(_affine(y, p["s1"], p["b1"])).to(torch.bfloat16)
    y = _conv(y, _w2_oihw(p["w2"]), 1)
    y = torch.relu(_affine(y, p["s2"], p["b2"])).to(torch.bfloat16)
    y = _affine(torch.matmul(y, p["w3"]), p["s3"], p["b3"])
    return torch.relu(y + x.float()).to(torch.bfloat16)


def library_block_conv(x, params):
    """The block as three cuDNN conv2d calls (the reference's
    ``xla_block_conv``)."""
    p = params
    one = lambda w: w.t()[:, :, None, None].contiguous(  # noqa: E731
        memory_format=torch.channels_last)
    y = _conv(x, one(p["w1"]), 0)
    y = torch.relu(_affine(y, p["s1"], p["b1"])).to(torch.bfloat16)
    y = _conv(y, _w2_oihw(p["w2"]), 1)
    y = torch.relu(_affine(y, p["s2"], p["b2"])).to(torch.bfloat16)
    y = _affine(_conv(y, one(p["w3"]), 0), p["s3"], p["b3"])
    return torch.relu(y + x.float()).to(torch.bfloat16)


def refusal(name, n, h, c, f, g, device):
    """Why the kernel would refuse g here, or None (asked before any
    launch: n % g, and on CUDA the kernel's own plan)."""
    if n % g:
        return f"g={g} does not divide the batch {n}"
    if device.type == "cuda":
        try:
            bottleneck.source_plan(name, n, h, c, f, g, device)
        except ValueError as e:
            return str(e)
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", default="s2", choices=list(STAGES))
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--g", type=int, default=0, help="imgs/cell (0=sweep)")
    ap.add_argument("--k", type=int, default=20, help="calls per timed run")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    h, c, f = STAGES[args.stage]
    n = args.batch
    flops = n * block_flops(h, c, f)
    records = [emit({"stage": args.stage, "h": h, "c": c, "f": f,
                     "batch": n, "gflops_per_call": flops / 1e9})]
    params = bottleneck_params_from_numpy(make_params(0, c, f), device)
    x = make_input(1, n, h, c, device)

    if args.check:
        m = min(8, n)
        g = 4 if m % 4 == 0 else 1
        ref = library_block(x[:m], params).float()
        for label, fn in (("4d", bottleneck.fused_block),
                          ("2d", bottleneck.fused_block2d)):
            out = fn(x[:m], params, g).float()
            err = float((out - ref).abs().max())
            rel = err / float(ref.abs().max())
            records.append(emit({"check": label, "max_abs_err": err,
                                 "rel": rel, "ok": rel <= CHECK_TOL}))

    t_lib = None
    for label, fn in (("library_dot", library_block),
                      ("library_conv", library_block_conv)):
        ms = time_ms(lambda: fn(x, params), args.k, device)
        t_lib = ms if t_lib is None else t_lib
        records.append(measurement(device, ms, flops, path=label))
    gs = [args.g] if args.g else list(G_SWEEP)
    for label, name in (("2d", "fused_block2d"), ("4d", "fused_block")):
        fn = getattr(bottleneck, name)
        for g in gs:
            why = refusal(name, n, h, c, f, g, device)
            if why is not None:
                records.append(emit({"variant": label, "g": g,
                                     "skipped": why}))
                continue
            ms = time_ms(lambda: fn(x, params, g), args.k, device)
            records.append(measurement(device, ms, flops,
                                       path=f"kernel{label}_g{g}"))
            records.append(emit({"variant": label, "g": g,
                                 "speedup_vs_library": t_lib / ms}))
    return records


if __name__ == "__main__":
    main()
