"""First call and A/B of the bottleneck kernel (csrc/fused_bottleneck.cu,
rows 9-10) on a card.

    python scripts/bottleneck_ab.py [--old FILE ...] [--no-time]
                                    [--stages s0,s1,s2,s3]

Builds csrc/fused_bottleneck.cu through kernels/build.py and prints
ptxas' registers and spills, compares the source's launch plan with its
Python mirror (kernels/bottleneck.py plan) for the six variants at every
stage of tools/probe_fused_block.py's STAGES with g = 1 and 4 (batch 256),
and holds fused_block2d and block_pad there at g = 4 against their plain
versions (chip_smoke.py's PROBE_TOL and PROBE_MEAN_TOL), the bits repeated
on a second call.

Then, at batch 256 and g = 4, it times fused_block2d through the C entry
(ctypes, on the same buffers) for each source, in turns (old, new, new,
old): the median of single calls and one CUDA-event window over calls
back to back, beside the cuBLAS + cuDNN block (tools' library_block). The
sources are the new one, each --old FILE (another fused_bottleneck.cu with
the same C entries, built with the headers beside it first: the mma.sync
kernel before the redesign is ``git show
<rev>:deeplearning4j_tpu_torch/csrc/fused_bottleneck.cu`` with that rev's
``mma_bf16.cuh`` in the same directory), and the new
one built with each diagnostic switch of its header (results wrong, only
times read): without the products (FB_DIAG_NO_MMA), without the loads
(FB_DIAG_NO_LOADS), conv1, conv2 and conv3 alone (FB_DIAG_PHASES=1, 2,
4), and conv3 alone without its epilogue, its x reads or its stores (a
copy of the source with the line that does it edited out: PATCHES);
--diag picks some by label. The share of the bf16 peak is printed for
the whole kernels only (new and --old), where the operation bound is
theirs. A timing that fails other than by the plan's refusal (code -4)
counts as a failed check. Every extra build goes into the git-ignored
build directory, keyed by its source, edits and flags; its registers,
spills and ptxas' wgmma notes (C75xx, counted) are printed, and for the
new source each kernel's count of HGMMA, wgmma waits (WARPGROUP.DEPBAR)
and arrives, local loads and stores (LDL, STL), ldmatrix, barriers and
calls in its SASS (cuobjdump); --sass OUT writes that SASS to the file
OUT. --no-time stops after the checks.

Prints the card's name and power limit first; exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deeplearning4j_tpu_torch.kernels import bottleneck as bn  # noqa: E402
from deeplearning4j_tpu_torch.kernels import build  # noqa: E402
from deeplearning4j_tpu_torch.tools import (  # noqa: E402
    probe_fused_block as pfb)
from deeplearning4j_tpu_torch.utils.convert import (  # noqa: E402
    bottleneck_params_from_numpy)

BATCH, G = 256, 4
REPS, B2B = 10, 20
# the epilogue-split diagnostics: an edit of one line of conv3's epilogue
# in a copy of the source, (text, replacement); each text must occur once
PATCHES = {
    "no epilogue": ("if (!active || !(kPhases & 4)) return;",
                    "if (true) return;"),
    "no x reads": ("xv[j] = residual &&", "xv[j] = false &&"),
    # the values are still computed: the store is kept behind a test the
    # compiler cannot settle
    "no stores": ("if (row_ok && (full_c || c0 + 8 * jj < p.C)) ",
                  "if (row_ok && (full_c || c0 + 8 * jj < p.C) && "
                  "p.h < 0) ")}
DIAGNOSTICS = (("no products", ["-DFB_DIAG_NO_MMA"], None),
               ("no loads", ["-DFB_DIAG_NO_LOADS"], None),
               ("conv1 alone", ["-DFB_DIAG_PHASES=1"], None),
               ("conv2 alone", ["-DFB_DIAG_PHASES=2"], None),
               ("conv3 alone", ["-DFB_DIAG_PHASES=4"], None),
               ("conv3 alone without its epilogue", ["-DFB_DIAG_PHASES=4"],
                "no epilogue"),
               ("conv3 alone without x reads", ["-DFB_DIAG_PHASES=4"],
                "no x reads"),
               ("conv3 alone without stores", ["-DFB_DIAG_PHASES=4"],
                "no stores"))
P, I = ctypes.c_void_p, ctypes.c_int
failures = []


class Refused(RuntimeError):
    """A non-zero return code of fused_bottleneck_run."""

    def __init__(self, rc):
        super().__init__(f"fused_bottleneck_run returned {rc}")
        self.rc = rc


def patched(src: bytes, patch):
    """The source with PATCHES[patch] applied (None: unchanged)."""
    if patch is None:
        return src
    old, new = PATCHES[patch]
    text = src.decode()
    if text.count(old) != 1:
        raise RuntimeError(f"the edit {patch!r} needs {old!r} once in the "
                           f"source, found {text.count(old)}")
    return text.replace(old, new).encode()


def check(ok, what):
    if not ok:
        failures.append(what)
        print(f"FAILED: {what}", flush=True)


def single_ms(fn, reps=REPS):
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
    for _ in range(2):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def print_build(label, log):
    notes = {}
    for line in log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "arning", "rror")):
            print(f"build {label}: {line.strip()}", flush=True)
        if "(C75" in line:   # ptxas' notes on wgmma, counted by kind
            kind = line.split("(C75", 1)[1][:2]
            notes["C75" + kind] = notes.get("C75" + kind, 0) + 1
    if notes:
        print(f"build {label}: ptxas wgmma notes {notes}", flush=True)


def compile_copy(src: bytes, flags, headers=None):
    """Build a copy of fused_bottleneck.cu with extra flags into the build
    directory, its includes searched for first in the directory
    ``headers`` (an --old FILE's own), then in csrc/; returns (library
    path, compiler output)."""
    dirs = ([] if headers is None else [Path(headers)]) + [build.CSRC]
    key = hashlib.sha256(src + "\0".join(flags).encode())
    for d in dirs:
        for header in sorted(d.glob("*.cuh")):
            key.update(header.read_bytes())
    out = build.BUILD_DIR / f"ab-fused_bottleneck-{key.hexdigest()[:16]}"
    out.mkdir(parents=True, exist_ok=True)
    (out / "fused_bottleneck.cu").write_bytes(src)
    lib = out / "libfused_bottleneck.so"
    if lib.exists():
        return lib, (out / "build.log").read_text()
    includes = [arg for d in dirs for arg in ("-I", str(d))]
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *flags,
                           *includes, "-o", str(lib),
                           str(out / "fused_bottleneck.cu")],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    (out / "build.log").write_text(log)
    if proc.returncode:
        raise RuntimeError(f"a copy did not build ({flags}):\n{log}")
    return lib, log


SASS_OPS = ("HGMMA", "WARPGROUP.DEPBAR", "WARPGROUP.ARRIVE", "LDL", "STL",
            "LDSM", "BAR.SYNC", "SYNCS", "CALL")


def sass_counts(lib):
    """Per kernel, the count of the instructions in SASS_OPS in the
    library's SASS (cuobjdump), or {} where cuobjdump is missing."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    text = subprocess.run([str(tool), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = "FM=" + name.split("ILi")[1].split("E")[0] \
                if "ILi" in name else name
            counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name is not None:
            for op in SASS_OPS:
                if f" {op}" in line:
                    counts[name][op] += 1
    return counts


def run_entry(lib):
    fn = ctypes.CDLL(str(lib)).fused_bottleneck_run
    fn.argtypes = [I] + [P] * 11 + [I] * 5 + [P]
    fn.restype = I
    return fn


def inputs(stage):
    h, c, f = pfb.STAGES[stage]
    rng = np.random.default_rng([cs.SEED, 9, h])
    tree = pfb.make_params(int(rng.integers(1 << 30)), c, f)
    for key in ("s1", "b1", "s2", "b2", "s3", "b3"):
        tree[key] = (tree[key] + rng.normal(size=tree[key].shape) * 0.1
                     ).astype(np.float32)
    p = bottleneck_params_from_numpy(tree, "cuda")
    x = pfb.make_input(int(rng.integers(1 << 30)), BATCH, h, c, "cuda")
    return h, c, f, p, x


def checks(stages):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for stage in stages:
        h, c, f = pfb.STAGES[stage]
        for name in bn.VARIANTS:
            for g in (1, G):
                plan = bn.source_plan(name, BATCH, h, c, f, g)
                check(plan == bn.plan(name, BATCH, h, c, f, g, sms),
                      f"{name} {stage} g={g}: source plan {plan} differs "
                      f"from the mirror")
        h, c, f, p, x = inputs(stage)
        x2 = x.reshape(-1, c)
        for name, run, ref in (
                ("fused_block2d", lambda: bn.fused_block2d(x, p, G),
                 lambda: bn.fused_block2d_reference(x, p, G)),
                ("block_pad",
                 lambda: bn.block_pad(x2, p["w1"], p["w2"], p["w3"], h=h,
                                      g=G),
                 lambda: bn.block_pad_reference(x2, p["w1"], p["w2"],
                                                p["w3"], h=h, g=G))):
            got, again = run(), run()
            torch.cuda.synchronize()
            e = cs._bf16_errs(got, ref())
            print(f"check {name} {stage} g={G}: max|d|/max {e[0]:.3e}, "
                  f"mean|d|/mean {e[1]:.3e}, differing {e[2]:.2e}, bits "
                  f"repeat {torch.equal(got, again)}", flush=True)
            check(e[0] <= cs.PROBE_TOL and e[1] <= cs.PROBE_MEAN_TOL,
                  f"{name} {stage}: outside the gate")
            check(torch.equal(got, again), f"{name} {stage}: bits differ")


def timings(stages, sources, diagnostics):
    for stage in stages:
        h, c, f, p, x = inputs(stage)
        out = torch.empty_like(x)
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa
        args = [1, x.data_ptr(), p["w1"].data_ptr(), p["s1"].data_ptr(),
                p["b1"].data_ptr(), p["w2"].data_ptr(), p["s2"].data_ptr(),
                p["b2"].data_ptr(), p["w3"].data_ptr(), p["s3"].data_ptr(),
                p["b3"].data_ptr(), out.data_ptr(), BATCH, h, c, f, G]

        def call(fn):
            rc = fn(*args, stream())
            if rc:
                raise Refused(rc)

        bound, by = cs.bottleneck_bound("fused_block2d", BATCH, h, c, f)
        lib_ms = single_ms(lambda: pfb.library_block(x, p))
        lib_b2b = b2b_ms(lambda: pfb.library_block(x, p))
        print(f"time {stage} (h, C, F = {h}, {c}, {f}) n={BATCH} g={G}: "
              f"bound {bound:.4f} ms ({by}); cuBLAS + cuDNN block single "
              f"{lib_ms:.4f}, back to back {lib_b2b:.4f}", flush=True)
        new = sources[0][1]
        for label, fn in sources[1:]:
            order = [(label, fn), ("new", new), ("new", new), (label, fn)]
            seen = {}
            try:
                for lab, f_ in order:
                    seen.setdefault(lab, []).append(
                        (single_ms(lambda: call(f_)),
                         b2b_ms(lambda: call(f_))))
            except Refused as e:
                print(f"time {stage} {label}: {e}", flush=True)
                check(e.rc == -4, f"time {stage} {label}: {e}")
                continue
            for lab, runs in seen.items():
                s1, b1 = runs[0]
                s2, b2 = runs[1]
                # a diagnostic build computes one product or none: the
                # whole block's bound is not its own
                whole = lab not in diagnostics and by == "operations"
                share = f", {bound / min(b1, b2):.1%} of the bf16 peak" \
                    if whole else ""
                print(f"time {stage} {lab} (vs {label}): single {s1:.4f} / "
                      f"{s2:.4f} ms, back to back {b1:.4f} / {b2:.4f} ms"
                      + share, flush=True)
        del x, p, out
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", nargs="*", default=[])
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--stages", default="s0,s1,s2,s3")
    ap.add_argument("--sass", default=None, metavar="OUT",
                    help="write the new source's SASS to the file OUT")
    ap.add_argument("--diag", default=None,
                    help="comma-separated labels of the diagnostics to "
                         "build (default: all)")
    args = ap.parse_args()
    stages = args.stages.split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    src = (build.CSRC / "fused_bottleneck.cu").read_bytes()
    copies = [(f, Path(f).read_bytes(), [], Path(f).parent)
              for f in args.old]
    if not args.no_time:
        wanted = None if args.diag is None else args.diag.split(",")
        copies += [(label, patched(src, patch), flags, None)
                   for label, flags, patch in DIAGNOSTICS
                   if wanted is None or label in wanted]
    with ThreadPoolExecutor(len(copies) + 1) as pool:
        built = [pool.submit(compile_copy, s, fl, hd)
                 for _, s, fl, hd in copies]
        build.load("fused_bottleneck")
        print_build("new", build.build_log("fused_bottleneck"))
        for kernel, ops in sass_counts(
                build.library_path("fused_bottleneck")).items():
            print(f"sass new {kernel}: {ops}", flush=True)
        if args.sass:
            Path(args.sass).write_text(subprocess.run(
                [str(Path(build._nvcc()).with_name("cuobjdump")), "-sass",
                 str(build.library_path("fused_bottleneck"))],
                capture_output=True, text=True).stdout)
        libs = []
        for (label, _, _, _), fut in zip(copies, built):
            lib, log = fut.result()
            print_build(label, log)
            libs.append((label, run_entry(lib)))
    checks(stages)
    if not args.no_time:
        new = run_entry(build.library_path("fused_bottleneck"))
        timings(stages, [("new", new)] + libs,
                {label for label, _, _ in DIAGNOSTICS})
    if failures:
        print(f"{len(failures)} checks failed", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
