"""A/B of the launch bounds of the GRU backward's dR pass on one GPU.

    python3 scripts/gru_dr_bounds_ab.py

csrc/gru_seq_bwd.cu asks for two blocks per SM (``__launch_bounds__(256,
2)``), which caps the dR kernel at 128 registers and spills a few, so that
its 192 tiles at H=1024 run in one wave on 132 SMs. This script builds the
source as committed and a copy with the bound ``(256)`` alone (one block
per SM, no spills) side by side, checks that both give the same bits, and
times the dR pass alone (entry ``gru_seq_bwd_dr_f32``) at the GRU
char-RNN's training shape T=100, N=64, H=1024, in turns: committed, copy,
copy, committed (CUDA-event medians of 20 launches each).
"""

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from deeplearning4j_tpu_torch.kernels import build  # noqa: E402

BOUND = "__launch_bounds__(kDrThreads, 2)"


def one_block_copy():
    """Build the source with the bound (256) alone; its library."""
    src = (build.CSRC / "gru_seq_bwd.cu").read_text()
    if BOUND not in src:
        raise SystemExit(f"{BOUND} not found in csrc/gru_seq_bwd.cu")
    out = build.BUILD_DIR / "gru_dr_bounds_ab"
    out.mkdir(parents=True, exist_ok=True)
    copy = out / "gru_seq_bwd_one_block.cu"
    copy.write_text(src.replace(BOUND, "__launch_bounds__(kDrThreads)"))
    lib = out / "libgru_seq_bwd_one_block.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), "-o", str(lib), str(copy)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(proc.stdout + proc.stderr)
    return ctypes.CDLL(str(lib))


def median_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 2
    t, n, h = 100, 64, 1024
    gen = torch.Generator(device="cuda").manual_seed(0)
    hs, h0, drz = (torch.randn(shape, device="cuda", generator=gen)
                   for shape in ((t, n, h), (n, h), (t, n, 3 * h)))
    libs = {"(256, 2) committed": build.load("gru_seq_bwd"),
            "(256) copy": one_block_copy()}
    calls, outs = {}, {}
    for name, lib in libs.items():
        fn = lib.gru_seq_bwd_dr_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        dr = torch.empty((h, 3 * h), device="cuda")
        drb = torch.empty((3 * h,), device="cuda")
        outs[name] = (dr, drb)
        calls[name] = (lambda fn=fn, dr=dr, drb=drb: fn(
            hs.data_ptr(), h0.data_ptr(), drz.data_ptr(), dr.data_ptr(),
            drb.data_ptr(), t, n, h, torch.cuda.current_stream().cuda_stream))
    first, second = list(libs)
    for name in (first, second, second, first):
        print(f"dR pass {name}: {median_ms(calls[name]):.4f} ms", flush=True)
    same = all(torch.equal(a, b) for a, b in zip(outs[first], outs[second]))
    print(f"same bits: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
