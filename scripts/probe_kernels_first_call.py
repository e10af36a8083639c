"""First call of the probe kernels on a card: build csrc/probe_matmul.cu and
csrc/fused_bottleneck.cu, print ptxas' registers and spills, launch each
kernel once per shape against its plain version, and time a few.

    python scripts/probe_kernels_first_call.py

Prints per shape: max |d| over the largest element, the share of elements
that differ and whether the kernel's output is finite; for the bottleneck
also the kernel's launch plan (band rows, halo, shared memory), whether
it equals its Python mirror, and whether a second call repeats the bits.
Then
matmul_bf16 and cuBLAS at five shapes, and fused_block2d at stage s2,
batch 256, g = 1 and 4, beside the cuBLAS + cuDNN block. A short check,
not a gate: chip_smoke.py holds the kernels to their tolerances.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from deeplearning4j_tpu_torch.kernels import (  # noqa: E402
    bottleneck as bn, build, probe_matmul as pm)
from deeplearning4j_tpu_torch.tools import (  # noqa: E402
    probe_fused_block as pfb)
from deeplearning4j_tpu_torch.tools.common import time_ms  # noqa: E402
from deeplearning4j_tpu_torch.utils.convert import (  # noqa: E402
    bottleneck_params_from_numpy)

SOURCES = ("probe_matmul", "fused_bottleneck")
SMS = 132
MATMULS = [(100, 32, 16), (784, 1024, 256), (3136, 256, 1024),
           (4096, 4096, 4096), (50176, 1024, 256)]


def errs(got, want):
    d = (got.float() - want.float()).abs()
    return (float(d.max()) / max(float(want.float().abs().max()), 1e-30),
            float((d > 0).float().mean()), bool(torch.isfinite(got).all()))


def params(c, f, dev):
    p = bottleneck_params_from_numpy(pfb.make_params(0, c, f), dev)
    for key in ("b1", "b2", "b3"):
        p[key].normal_(0, 0.1)
    return p


def bottleneck_cases(h, c, f, n, gs, dev):
    p = params(c, f, dev)
    x = pfb.make_input(1, n, h, c, dev)
    x2 = x.reshape(-1, c)
    for g in gs:
        for name in bn.VARIANTS:
            fn, ref = getattr(bn, name), getattr(bn, name + "_reference")
            if name.startswith("fused"):
                args, kw = (x, p, g), {}
            elif name == "block_folded":
                args = (x2, p["w1"], p["b1"], p["w2"], p["b2"], p["w3"],
                        p["b3"])
                kw = dict(h=h, g=g)
            else:
                args, kw = (x2, p["w1"], p["w2"], p["w3"]), dict(h=h, g=g)
            out = fn(*args, **kw)
            again = fn(*args, **kw)
            torch.cuda.synchronize()
            plan = bn.source_plan(name, n, h, c, f, g)
            print(name, (h, c, f, n, g), plan, "mirror",
                  plan == bn.plan(name, n, h, c, f, g, SMS),
                  "max|d|/max, differing, finite:",
                  errs(out, ref(*args, **kw)), "bits repeat",
                  bool(torch.equal(out, again)), flush=True)


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(torch.__version__, torch.version.cuda, flush=True)
    t0 = time.time()
    try:
        build.load_all(SOURCES)
    finally:
        for name in SOURCES:
            for line in build.build_log(name).splitlines():
                if any(w in line for w in ("entry function", "registers",
                                           "spill", "rror")):
                    print(name, line.strip())
    print(f"build {time.time() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    global SMS
    SMS = torch.cuda.get_device_properties(0).multi_processor_count
    for m, k, n in MATMULS:
        a = torch.randn(m, k, device=dev).to(torch.bfloat16)
        b = torch.randn(k, n, device=dev).to(torch.bfloat16)
        out = pm.matmul_bf16(a, b)
        torch.cuda.synchronize()
        print("matmul_bf16", (m, k, n), errs(out, pm.matmul_bf16_reference(
            a, b)), "ms", time_ms(lambda: pm.matmul_bf16(a, b), 10, dev),
            "cuBLAS", time_ms(lambda: torch.matmul(a, b), 10, dev),
            flush=True)
    bottleneck_cases(4, 32, 16, 4, (1, 2), dev)
    bottleneck_cases(7, 64, 32, 4, (1, 2, 4), dev)
    bottleneck_cases(14, 1024, 80, 8, (4,), dev)    # F not a multiple of 64
    bottleneck_cases(9, 208, 336, 4, (2,), dev)     # a short last band
    bottleneck_cases(14, 256, 528, 4, (2,), dev)    # F past 512
    bottleneck_cases(70, 256, 512, 2, (1,), dev)    # bands below 64 rows
    bottleneck_cases(70, 2048, 512, 2, (1,), dev)   # affines not in smem
    for h, c, f in pfb.STAGES.values():
        bottleneck_cases(h, c, f, 8, (1, 4), dev)
    for stage, (h, c, f) in pfb.STAGES.items():
        p = params(c, f, dev)
        x = pfb.make_input(1, 256, h, c, dev)
        for g in (1, 4):
            want = bn.fused_block2d_reference(x, p, g)
            got = bn.fused_block2d(x, p, g)
            print("fused_block2d", stage, "b256 g", g,
                  "max|d|/max, differing, finite:", errs(got, want), "ms",
                  time_ms(lambda: bn.fused_block2d(x, p, g), 5, dev),
                  flush=True)
        print(stage, "cuBLAS + cuDNN block ms", time_ms(
            lambda: pfb.library_block(x, p), 5, dev), "three cuDNN convs ms",
            time_ms(lambda: pfb.library_block_conv(x, p), 5, dev),
            flush=True)


if __name__ == "__main__":
    main()
