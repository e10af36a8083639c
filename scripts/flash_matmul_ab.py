"""First call and A/B of the bf16 flash kernels (csrc/flash_attn_fwd.cu,
csrc/flash_attn_bwd.cu) and matmul_bf16 (csrc/probe_matmul.cu) on a card.

    python scripts/flash_matmul_ab.py [--old DIR ...]

Builds the three sources, prints ptxas' registers, spills and warnings and,
from cuobjdump, each backward kernel's HGMMA (wgmma) and atomic
instructions, then holds each kernel against its plain version: the flash
forward (training and inference entries) and backward (dkv, dq), bf16 and
float32, at chip_smoke.py's FLASH_SHAPES, the backward fed by the new m and
l and its bits repeated on a second run; matmul_bf16 at the probe's shapes
and a few ragged ones (max |d| over the largest element and mean |d| over
the mean, chip_smoke's rules). Each launch plan is compared with its Python
mirror. Then, at the report shapes (B, H, T, D = 16, 12, 512, 64 bf16; M,
K, N = 50176, 1024, 256), each kernel and its yardstick (SDPA's forward and
backward, cuBLAS's a @ b) are timed as the median of single calls and as
one CUDA-event window over back-to-back launches, the flash kernels also
launched through ctypes directly ("new direct": no wrapper work), the
backward as dkv, dq and the pair, with a torch.profiler split of its and
SDPA's backward's device time by kernel; matmul_bf16 also at each probe
shape, launched through ctypes directly. With --old DIR (one or more), the
same entries built from DIR's copy of flash_attn_fwd.cu, flash_attn_bwd.cu
and/or probe_matmul.cu (say an earlier commit's, from ``git show
<rev>:deeplearning4j_tpu_torch/csrc/<file>``; the headers come from csrc/),
launched through ctypes, are timed beside them in turns: old, new, new,
old.

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
    """{"fwd", "mm", "dkv", "dq"} -> the bf16 entry or None, built from the
    copies of flash_attn_fwd.cu, probe_matmul.cu and flash_attn_bwd.cu in
    src_dir."""
    out_dir = Path(src_dir) / "_build"
    out_dir.mkdir(exist_ok=True)
    procs = {}
    for name in ("flash_attn_fwd", "probe_matmul", "flash_attn_bwd"):
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
    return entries(libs)


def entries(libs):
    """The bf16 entries of the loaded libraries, their argument types
    declared."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    out = dict.fromkeys(("fwd", "mm", "dkv", "dq"))
    for key, name, entry, types in (
            ("fwd", "flash_attn_fwd", "flash_attn_fwd_bf16",
             [p] * 6 + [i, i, i, f, i, p]),
            ("mm", "probe_matmul", "probe_matmul_bf16",
             [p, p, p, i, i, i, p]),
            ("dkv", "flash_attn_bwd", "flash_attn_bwd_dkv_bf16",
             [p] * 10 + [i, i, i, f, p]),
            ("dq", "flash_attn_bwd", "flash_attn_bwd_dq_bf16",
             [p] * 8 + [i, i, i, f, p])):
        if name in libs:
            fn = getattr(libs[name], entry)
            fn.argtypes = types
            fn.restype = i
            out[key] = fn
    return out


def print_build(names):
    for name in names:
        for line in build.build_log(name).splitlines():
            if any(w in line for w in ("registers", "spill", "arning",
                                       "Compiling", "error", "Loss")):
                print(f"build {name}: {line.strip()}", flush=True)


def sass_counts(name):
    """Per kernel of csrc/<name>.cu's build, the HGMMA (wgmma) and the
    atomic (ATOM, RED) instructions of its SASS, from cuobjdump."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass",
                          str(build.library_path(name))],
                         capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = [0, 0]
        elif fn is not None:
            counts[fn][0] += "HGMMA" in line
            counts[fn][1] += any(op in line for op in (" ATOM", " RED"))
    for fn, (hgmma, atomics) in counts.items():
        print(f"sass {name}: {fn[:90]}: {hgmma} HGMMA, {atomics} atomics",
              flush=True)


def flash_checks():
    for shape in cs.FLASH_SHAPES:
        b, h, t, d = shape
        for dname in ("bfloat16", "float32"):
            dtype = getattr(torch, dname)
            mirror = flash.fwd_plan(b * h, t, d, dtype)
            source = flash.fwd_source_plan(b * h, t, d, dtype)
            check(mirror == source, f"flash plan {shape} {dname}: mirror "
                  f"{mirror} vs source {source}")
            for which in flash.BWD_WHICH:
                bm = flash.bwd_plan(which, b * h, t, d, dtype)
                bs = flash.bwd_source_plan(which, b * h, t, d, dtype)
                check(bm == bs, f"flash {which} plan {shape} {dname}: "
                      f"mirror {bm} vs source {bs}")
            gen = torch.Generator(device="cuda").manual_seed(b * t + d)
            q, k, v, do = (torch.randn(shape, device="cuda", generator=gen)
                           .to(dtype) for _ in range(4))
            scale = 1.0 / math.sqrt(d)
            o, m, l = flash.flash_fwd(q, k, v, scale)
            oi = flash.flash_attention_infer(q, k, v, scale)
            dk, dv, di = flash.flash_bwd_dkv(q, k, v, o, do, m, l, scale)
            dq = flash.flash_bwd_dq(q, k, v, do, m, l, di, scale)
            dk2, dv2, di2 = flash.flash_bwd_dkv(q, k, v, o, do, m, l, scale)
            dq2 = flash.flash_bwd_dq(q, k, v, do, m, l, di2, scale)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in ((dk, dk2), (dv, dv2),
                                                     (dq, dq2))),
                  f"flash backward {shape} {dname}: other bits on a second "
                  f"run")
            ro, rm, rl = flash.flash_fwd_reference(q, k, v, scale)
            rdq, rdk, rdv = flash.flash_bwd_reference(q, k, v, o, do, m, l,
                                                      scale)
            tol_f, tol_b = cs.FLASH_TOL[dname]
            fwd = max(cs._rel_err(o.float(), ro.float()),
                      cs._rel_err(m, rm), cs._rel_err(l, rl))
            inf = cs._rel_err(oi.float(), ro.float())
            bwd = max(cs._rel_err(a.float(), r.float())
                      for a, r in ((dq, rdq), (dk, rdk), (dv, rdv)))
            each = ", ".join(f"{n} {cs._rel_err(x.float(), r.float()):.2e}"
                             for n, x, r in (("dq", dq, rdq), ("dk", dk, rdk),
                                             ("dv", dv, rdv)))
            print(f"flash {shape} {dname}: fwd {fwd:.3e} infer {inf:.3e} "
                  f"bwd {bwd:.3e} ({each}; m {cs._rel_err(m, rm):.2e}, l "
                  f"{cs._rel_err(l, rl):.2e}); plan {source}", flush=True)
            check(fwd <= tol_f and inf <= tol_f and bwd <= tol_b,
                  f"flash {shape} {dname} outside FLASH_TOL")
            check(all(bool(torch.isfinite(a).all())
                      for a in (o, oi, m, l, dq, dk, dv)),
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


def in_turns(name, entries, yard=None):
    """Times each (label, fn) of entries, single and back to back, in
    turns (each old, new, new, each old: entries[0] is the new one), and
    the yardstick once; prints one line."""
    order = entries[1:] + [entries[0]] * 2 + entries[1:][::-1]
    got = {}
    for label, fn in order:
        got.setdefault(label, []).append((single_ms(fn), b2b_ms(fn)))
    line = f"time {name}: " + "; ".join(
        f"{label} single " + ", ".join(f"{s:.4f}" for s, _ in v) +
        " b2b " + ", ".join(f"{x:.4f}" for _, x in v)
        for label, v in got.items())
    if yard is not None:
        line += (f"; library single {single_ms(yard):.4f} b2b "
                 f"{b2b_ms(yard):.4f}")
    print(line + " ms", flush=True)


def max_diff(a, b):
    return float((a.float() - b.float()).abs().max())


def timings(olds):
    """olds: {dir: build_old(dir)}. Old entries and "new direct" write
    into buffers of their own (the backward's fed by the new forward's o,
    m and l)."""
    b, h, t, d = cs.FLASH_REPORT
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(b, h, t, d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    o_new, m_new, l_new = flash.flash_fwd(q, k, v, scale)
    o, m, l = (torch.empty_like(x) for x in (o_new, m_new, l_new))
    stream = torch.cuda.current_stream().cuda_stream
    M, K, N = cs.MATMUL_REPORT
    a, bm = pmt.inputs(M, K, N, "cuda")
    out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
    out_new = pm.matmul_bf16(a, bm)
    dk_new, dv_new, di_new = flash.flash_bwd_dkv(q, k, v, o_new, do, m_new,
                                                 l_new, scale)
    dq_new = flash.flash_bwd_dq(q, k, v, do, m_new, l_new, di_new, scale)
    dk, dv, dq = (torch.empty_like(x) for x in (dk_new, dv_new, dq_new))
    di = torch.empty_like(di_new)
    ptr = lambda *xs: [x.data_ptr() for x in xs]  # noqa: E731

    def old_fwd(fn, save):
        rc = fn(*ptr(q, k, v, o, m, l), b * h, t, d, scale, save, stream)
        assert rc == 0, rc

    def old_mm(fn):
        rc = fn(*ptr(a, bm, out), M, K, N, stream)
        assert rc == 0, rc

    # the backward through ctypes, fed by the new forward's o, m and l
    def direct_dkv(fn):
        rc = fn(*ptr(q, k, v, o_new, do, m_new, l_new, di, dk, dv), b * h,
                t, d, scale, stream)
        assert rc == 0, rc

    def direct_dq(fn):
        rc = fn(*ptr(q, k, v, do, m_new, l_new, di, dq), b * h, t, d, scale,
                stream)
        assert rc == 0, rc

    new = entries({name: build.load(name)
                   for name in ("flash_attn_fwd", "flash_attn_bwd")})
    cases = {"flash_fwd": [("new", lambda: flash.flash_fwd(q, k, v, scale)),
                           ("new direct", lambda: old_fwd(new["fwd"], 1))],
             "flash_attention_infer": [
                 ("new", lambda: flash.flash_attention_infer(q, k, v,
                                                             scale)),
                 ("new direct", lambda: old_fwd(new["fwd"], 0))],
             "matmul_bf16": [("new", lambda: pm.matmul_bf16(a, bm))]}
    bwd = {"flash_bwd_dkv": [
               ("new", lambda: flash.flash_bwd_dkv(q, k, v, o_new, do, m_new,
                                                   l_new, scale)),
               ("new direct", lambda: direct_dkv(new["dkv"]))],
           "flash_bwd_dq": [
               ("new", lambda: flash.flash_bwd_dq(q, k, v, do, m_new, l_new,
                                                  di_new, scale)),
               ("new direct", lambda: direct_dq(new["dq"]))],
           "flash_bwd (dkv + dq)": [
               ("new", lambda: flash.flash_bwd_dq(
                   q, k, v, do, m_new, l_new, flash.flash_bwd_dkv(
                       q, k, v, o_new, do, m_new, l_new, scale)[2], scale)),
               ("new direct", lambda: (direct_dkv(new["dkv"]),
                                       direct_dq(new["dq"])))]}
    for src, old in olds.items():
        if old["fwd"] is not None:
            old_fwd(old["fwd"], 1)
            torch.cuda.synchronize()
            print(f"{src} vs new: flash o max|d| {max_diff(o, o_new):.3e}",
                  flush=True)
            cases["flash_fwd"].append(
                (src, lambda f=old["fwd"]: old_fwd(f, 1)))
            cases["flash_attention_infer"].append(
                (src, lambda f=old["fwd"]: old_fwd(f, 0)))
        if old["mm"] is not None:
            old_mm(old["mm"])
            torch.cuda.synchronize()
            print(f"{src} vs new: matmul max|d| {max_diff(out, out_new):.3e}",
                  flush=True)
            cases["matmul_bf16"].append((src, lambda f=old["mm"]: old_mm(f)))
        if old["dkv"] is not None:
            direct_dkv(old["dkv"])
            direct_dq(old["dq"])
            torch.cuda.synchronize()
            print(f"{src} vs new: max|d| dk {max_diff(dk, dk_new):.3e} dv "
                  f"{max_diff(dv, dv_new):.3e} dq {max_diff(dq, dq_new):.3e} "
                  f"(largest |dk| {float(dk_new.float().abs().max()):.3e}, "
                  f"|dv| {float(dv_new.float().abs().max()):.3e}, |dq| "
                  f"{float(dq_new.float().abs().max()):.3e})", flush=True)
            bwd["flash_bwd_dkv"].append(
                (src, lambda f=old["dkv"]: direct_dkv(f)))
            bwd["flash_bwd_dq"].append((src, lambda f=old["dq"]: direct_dq(f)))
            bwd["flash_bwd (dkv + dq)"].append(
                (src, lambda f=old["dkv"], g=old["dq"]: (direct_dkv(f),
                                                        direct_dq(g))))
    yard = {"flash_fwd": lambda: F.scaled_dot_product_attention(q, k, v),
            "matmul_bf16": lambda: torch.matmul(a, bm)}
    with torch.inference_mode():
        for name, cs_entries in cases.items():
            in_turns(name, cs_entries, yard.get(name))
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qg, kg, vg)
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        o_sdpa, (qg, kg, vg), do, retain_graph=True)
    for name, cs_entries in bwd.items():
        in_turns(name, cs_entries, sdpa_bwd if "+" in name else None)
    device_split("new flash_bwd (dkv + dq)", bwd["flash_bwd (dkv + dq)"][1][1])
    device_split("SDPA bwd", sdpa_bwd)


def device_split(label, fn, n=20):
    """Device time a call by kernel (torch.profiler over n calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = [(getattr(e, "self_device_time_total", 0), e.key)
              for e in prof.key_averages()]
    events = [(us / n / 1e3, key) for us, key in events if us > 0]
    print(f"device {label}: {sum(ms for ms, _ in events):.4f} ms a call: " +
          "; ".join(f"{key[:60]} {ms:.4f}" for ms, key in
                    sorted(events, reverse=True)[:6]), flush=True)


def matmul_shapes(olds):
    """matmul_bf16 at every probe shape the reference ran Pallas at, launched
    through ctypes directly (no Python wrapper, whose host work bounds a
    back-to-back run of small shapes), back to back: the new source and
    each old copy."""
    new = build.load("probe_matmul").probe_matmul_bf16
    mms = [("new", new)] + [(src, old["mm"]) for src, old in olds.items()
                            if old["mm"] is not None]
    stream = torch.cuda.current_stream().cuda_stream
    for (m, k, n) in [s for s in pmt.SHAPES if pmt.kernel_runs(*s)]:
        a, b = pmt.inputs(m, k, n, "cuda")
        out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
        args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, stream)
        print(f"matmul {(m, k, n)} direct launches back to back: " + "; ".join(
            f"{label} {b2b_ms(lambda fn=fn: fn(*args)):.4f}"
            for label, fn in mms) + " ms", flush=True)


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
    sass_counts("flash_attn_bwd")
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
