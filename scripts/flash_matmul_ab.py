"""First call and A/B of the bf16 flash forward (csrc/flash_attn_fwd.cu) and
matmul_bf16 (csrc/probe_matmul.cu) on a card.

    python scripts/flash_matmul_ab.py [--old DIR ...]

Builds the two sources (and flash_attn_bwd.cu), prints ptxas' registers,
spills and warnings, then holds each kernel against its plain version:
the flash forward (training and inference entries, bf16 and float32) at
chip_smoke.py's FLASH_SHAPES, with the backward fed by the new m and l;
matmul_bf16 at the probe's shapes and a few ragged ones (max |d| over the
largest element and mean |d| over the mean, chip_smoke's rules). Each
launch plan is compared with its Python mirror. Then, at the report shapes
(B, H, T, D = 16, 12, 512, 64 bf16; M, K, N = 50176, 1024, 256), each
kernel and its yardstick (SDPA's forward, cuBLAS's a @ b) are timed as the
median of single calls and as one CUDA-event window over back-to-back
launches; matmul_bf16 also at each probe shape, launched through ctypes
directly. With --old DIR (one or more), the same entries built from DIR's
copy of flash_attn_fwd.cu and/or probe_matmul.cu (say an earlier
commit's, from ``git show <rev>:deeplearning4j_tpu_torch/csrc/<file>``;
the headers come from csrc/) are timed beside them in turns: old, new,
new, old.

Exits 1 if a check fails.
"""

from __future__ import annotations

import ctypes
import math
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deeplearning4j_tpu_torch.kernels import build, flash  # noqa: E402
from deeplearning4j_tpu_torch.kernels import probe_matmul as pm  # noqa: E402
from deeplearning4j_tpu_torch.tools import probe_matmul as pmt  # noqa: E402

RAGGED = [(100, 32, 16), (1000, 80, 48), (3000, 1040, 272),
          (4096, 4096, 4096)]
B2B = 50
failures = []


def check(ok, what):
    if not ok:
        failures.append(what)
        print(f"FAILED: {what}", flush=True)


def single_ms(fn, reps=30):
    """Median of CUDA-event timings of single calls, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def b2b_ms(fn, n=B2B):
    """One CUDA-event window over n back-to-back calls, over n."""
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def build_old(src_dir):
    """(flash forward bf16 entry or None, matmul entry or None) built from
    the copies of flash_attn_fwd.cu and probe_matmul.cu in src_dir."""
    out_dir = Path(src_dir) / "_build"
    out_dir.mkdir(exist_ok=True)
    procs = {}
    for name in ("flash_attn_fwd", "probe_matmul"):
        src = Path(src_dir) / f"{name}.cu"
        if not src.exists():
            continue
        out = out_dir / f"lib{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", str(out), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{src_dir} {name} did not build:\n{log}")
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "arning",
                                       "Loss")):
                print(f"build {src_dir} {name}: {line.strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd = mm = None
    if "flash_attn_fwd" in libs:
        fwd = libs["flash_attn_fwd"].flash_attn_fwd_bf16
        fwd.argtypes = [p] * 6 + [i, i, i, f, i, p]
        fwd.restype = i
    if "probe_matmul" in libs:
        mm = libs["probe_matmul"].probe_matmul_bf16
        mm.argtypes = [p, p, p, i, i, i, p]
        mm.restype = i
    return fwd, mm


def print_build(names):
    for name in names:
        for line in build.build_log(name).splitlines():
            if any(w in line for w in ("registers", "spill", "arning",
                                       "Compiling", "error", "Loss")):
                print(f"build {name}: {line.strip()}", flush=True)


def flash_checks():
    for shape in cs.FLASH_SHAPES:
        b, h, t, d = shape
        for dname in ("bfloat16", "float32"):
            dtype = getattr(torch, dname)
            mirror = flash.fwd_plan(b * h, t, d, dtype)
            source = flash.fwd_source_plan(b * h, t, d, dtype)
            check(mirror == source, f"flash plan {shape} {dname}: mirror "
                  f"{mirror} vs source {source}")
            gen = torch.Generator(device="cuda").manual_seed(b * t + d)
            q, k, v, do = (torch.randn(shape, device="cuda", generator=gen)
                           .to(dtype) for _ in range(4))
            scale = 1.0 / math.sqrt(d)
            o, m, l = flash.flash_fwd(q, k, v, scale)
            oi = flash.flash_attention_infer(q, k, v, scale)
            dk, dv, di = flash.flash_bwd_dkv(q, k, v, o, do, m, l, scale)
            dq = flash.flash_bwd_dq(q, k, v, do, m, l, di, scale)
            torch.cuda.synchronize()
            ro, rm, rl = flash.flash_fwd_reference(q, k, v, scale)
            rdq, rdk, rdv = flash.flash_bwd_reference(q, k, v, o, do, m, l,
                                                      scale)
            tol_f, tol_b = cs.FLASH_TOL[dname]
            fwd = max(cs._rel_err(o.float(), ro.float()),
                      cs._rel_err(m, rm), cs._rel_err(l, rl))
            inf = cs._rel_err(oi.float(), ro.float())
            bwd = max(cs._rel_err(a.float(), r.float())
                      for a, r in ((dq, rdq), (dk, rdk), (dv, rdv)))
            print(f"flash {shape} {dname}: fwd {fwd:.3e} infer {inf:.3e} "
                  f"bwd {bwd:.3e} (m {cs._rel_err(m, rm):.2e}, l "
                  f"{cs._rel_err(l, rl):.2e}); plan {source}", flush=True)
            check(fwd <= tol_f and inf <= tol_f and bwd <= tol_b,
                  f"flash {shape} {dname} outside FLASH_TOL")
            check(all(bool(torch.isfinite(a).all()) for a in (o, oi, m, l)),
                  f"flash {shape} {dname} not finite")


def matmul_checks(sms):
    shapes = [s for s in pmt.SHAPES if pmt.kernel_runs(*s)] + RAGGED
    for (m, k, n) in shapes:
        mirror = pm.plan(m, k, n, sms)
        source = pm.source_plan(m, k, n)
        check(mirror == source, f"matmul plan {(m, k, n)}: mirror {mirror} "
              f"vs source {source}")
        a, b = pmt.inputs(m, k, n, "cuda")
        got = pm.matmul_bf16(a, b)
        torch.cuda.synchronize()
        rel, mean, diff, _ = cs._bf16_errs(got, pm.matmul_bf16_reference(a,
                                                                          b))
        print(f"matmul {(m, k, n)}: max|d|/max {rel:.3e}, mean|d|/mean "
              f"{mean:.3e}, differing {diff:.2e}; plan {source}", flush=True)
        check(rel <= cs.PROBE_TOL and mean <= cs.PROBE_MEAN_TOL,
              f"matmul {(m, k, n)} outside the probe rules")


def timings(olds):
    """olds: {dir: (flash entry or None, matmul entry or None)}."""
    b, h, t, d = cs.FLASH_REPORT
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    o_new, _, _ = flash.flash_fwd(q, k, v, scale)
    o, m, l = (torch.empty_like(x) for x in flash.flash_fwd(q, k, v, scale))
    stream = torch.cuda.current_stream().cuda_stream
    M, K, N = cs.MATMUL_REPORT
    a, bm = pmt.inputs(M, K, N, "cuda")
    out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
    out_new = pm.matmul_bf16(a, bm)

    def old_fwd(fn, save):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                m.data_ptr(), l.data_ptr(), b * h, t, d, scale, save, stream)
        assert rc == 0, rc

    def old_mm(fn):
        rc = fn(a.data_ptr(), bm.data_ptr(), out.data_ptr(), M, K, N, stream)
        assert rc == 0, rc

    cases = {"flash_fwd": [("new", lambda: flash.flash_fwd(q, k, v, scale))],
             "flash_attention_infer": [("new", lambda: flash.
                                        flash_attention_infer(q, k, v,
                                                              scale))],
             "matmul_bf16": [("new", lambda: pm.matmul_bf16(a, bm))]}
    for src, (fwd, mm) in olds.items():
        if fwd is not None:
            old_fwd(fwd, 1)
            torch.cuda.synchronize()
            print(f"{src} vs new: flash o max|d| "
                  f"{float((o.float() - o_new.float()).abs().max()):.3e}",
                  flush=True)
            cases["flash_fwd"].append((src, lambda f=fwd: old_fwd(f, 1)))
            cases["flash_attention_infer"].append(
                (src, lambda f=fwd: old_fwd(f, 0)))
        if mm is not None:
            old_mm(mm)
            torch.cuda.synchronize()
            print(f"{src} vs new: matmul max|d| "
                  f"{float((out.float() - out_new.float()).abs().max()):.3e}",
                  flush=True)
            cases["matmul_bf16"].append((src, lambda f=mm: old_mm(f)))
    yard = {"flash_fwd": lambda: F.scaled_dot_product_attention(q, k, v),
            "matmul_bf16": lambda: torch.matmul(a, bm)}
    with torch.inference_mode():
        for name, entries in cases.items():
            # in turns: each old, new, new, each old
            order = entries[1:] + [entries[0]] * 2 + entries[1:][::-1]
            got = {}
            for label, fn in order:
                got.setdefault(label, []).append(
                    (single_ms(fn), b2b_ms(fn)))
            line = f"time {name}: " + "; ".join(
                f"{label} single " + ", ".join(f"{s:.4f}" for s, _ in v) +
                " b2b " + ", ".join(f"{x:.4f}" for _, x in v)
                for label, v in got.items())
            if name in yard:
                line += (f"; library single {single_ms(yard[name]):.4f} b2b "
                         f"{b2b_ms(yard[name]):.4f}")
            print(line + " ms", flush=True)


def matmul_shapes(olds):
    """matmul_bf16 at every probe shape the reference ran Pallas at, launched
    through ctypes directly (no Python wrapper, whose host work bounds a
    back-to-back run of small shapes), back to back: the new source and
    each old copy."""
    new = build.load("probe_matmul").probe_matmul_bf16
    entries = [("new", new)] + [(src, mm) for src, (_, mm) in olds.items()
                                if mm is not None]
    stream = torch.cuda.current_stream().cuda_stream
    for (m, k, n) in [s for s in pmt.SHAPES if pmt.kernel_runs(*s)]:
        a, b = pmt.inputs(m, k, n, "cuda")
        out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
        args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, stream)
        print(f"matmul {(m, k, n)} direct launches back to back: " + "; ".join(
            f"{label} {b2b_ms(lambda fn=fn: fn(*args)):.4f}"
            for label, fn in entries) + " ms", flush=True)


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    names = ("flash_attn_fwd", "flash_attn_bwd", "probe_matmul")
    try:
        build.load_all(names)
    finally:
        print_build(names)
    olds = {sys.argv[i + 1]: build_old(sys.argv[i + 1])
            for i, arg in enumerate(sys.argv) if arg == "--old"}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"SMs {sms}", flush=True)
    flash_checks()
    matmul_checks(sms)
    timings(olds)
    matmul_shapes(olds)
    print(f"failures: {failures}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
