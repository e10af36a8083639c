"""First call and A/B of the GRU backward (csrc/gru_seq_bwd.cu) on a card.

    python scripts/gru_seq_bwd_ab.py [--old FILE] [--diag LABEL,...]
                                     [--no-time] [--sass OUT]

Builds csrc/gru_seq_bwd.cu, prints ptxas' registers, spills and warnings
for each kernel, compares the source's launch plans (``gru_seq_bwd_plan``
for the sweep, ``gru_seq_bwd_dr_plan`` for the dR pass) with their Python
mirrors (kernels/gru.py ``gru_seq_bwd_plan``, ``gru_bwd_dr_plan``) at every
CHECK_SHAPES row, at N = 48 and 96 and at H = 2048, and prints the plan
the card launches. Then it holds the wrapper ``gru_seq_bwd`` against its
plain version at every CHECK_SHAPES row (chip_smoke's GRAD_TOL, relative
to each output's largest element), each launched twice (the bits must
repeat), and the dR pass alone at the step route's H = 2048 against
hprev^T drz.

--old FILE is another copy of gru_seq_bwd.cu with the same C entries (the
kernel before its redesign: ``mkdir -p _ab/old && git show
1f1d9f8:deeplearning4j_tpu_torch/csrc/gru_seq_bwd.cu >
_ab/old/gru_seq_bwd.cu``, and the same for ``warp_reduce.cuh``, which it
includes, into the same directory: a copy's own directory is searched for
headers before csrc/). --diag builds copies of the source with one edit
each (DIAGNOSTICS; "a+b" combines them). Every copy is built into the
git-ignored build directory (all nvcc at once) and checked against the
plain version at the first CHECK_SHAPES rows (gated). At every TIME_SHAPES
row each source is timed through its C entries on the same buffers, as
the median of single calls and as one CUDA-event window over back-to-back
calls, in turns (old, new, new, old, then the diagnostic copies): the
whole backward (``gru_seq_bwd_f32``), the dR pass alone
(``gru_seq_bwd_dr_f32``) and the sweep as their difference, beside each
one's bound; at the step route's H = 2048 the dR pass alone. A "phases"
build also prints where block 0's sweep steps spend their time (clock64
and %globaltimer stamps). --no-time stops after the checks; --sass OUT
prints each kernel's instruction counts and writes the SASS to OUT.

Every phase prints a stamp (seconds since the start). Exits 1 if a check
fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deeplearning4j_tpu_torch.kernels import build, gru, rnn_step  # noqa: E402

# (T, N, H): chip_smoke's GRU_SHAPES, then ragged batches (33 rows, 96 in
# two tiles of 48, 130 in three), widths that are no multiple of 4 or of
# the units, widths past 1056 (20 units a block), the widest the kernel
# before took, and a width too narrow for a cluster of 2
CHECK_SHAPES = cs.GRU_SHAPES + [
    (5, 33, 1000), (4, 96, 1056), (3, 130, 37), (3, 17, 1100),
    (2, 256, 1205), (9, 2, 1112), (5, 3, 1)]
# extra (N, H) of the plan checks: chip_smoke's, and the step route's width
PLAN_EXTRA = [(48, 1024), (96, 1024), (64, 2048), (1, 2048)]
# (T, N, H) timed: training, serving's largest bucket, generation
TIME_SHAPES = [(100, 64, 1024), (100, 32, 1024), (100, 1, 1024),
               (1, 1, 1024)]
STEP_DR_SHAPE = (100, 64, 2048)   # the step route's dR pass
STAMP_MACRO = (
    "__device__ long long g_stamp[2 * 8 * 512];\n"
    "#define STAMP(k) if (blockIdx.x == 0 && threadIdx.x == 0 && t >= 0 "
    "&& t < 512) { unsigned long long g_; asm volatile(\"mov.u64 %0, "
    "%%globaltimer;\" : \"=l\"(g_)); g_stamp[t * 8 + (k)] = clock64(); "
    "g_stamp[8 * 512 + t * 8 + (k)] = (long long)g_; }")
STAMPS_ENTRY = (
    'extern "C" const char* gru_seq_bwd_error_string',
    'extern "C" int gru_seq_bwd_stamps(long long* out) {\n'
    '  return cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));\n'
    '}\n\nextern "C" const char* gru_seq_bwd_error_string')
# label -> edits of the source (each text must appear once); the copies
# in WRONG give wrong results and are only timed
DIAGNOSTICS = {
    # block 0's thread 0 stamps clock64 and %globaltimer at PHASES' points
    # of every sweep step; read back by gru_seq_bwd_stamps
    "phases": [
        ("namespace {", "namespace {\n" + STAMP_MACRO),
        ("for (int tile = group; tile < p.tiles; tile += p.groups) {",
         "for (int tile = group; tile < p.tiles; tile += p.groups) {\n"
         "STAMP(0)"),
        ("      if (have_next) {\n        warp_reduce_scatter",
         "STAMP(1)\n      if (have_next) {\n        warp_reduce_scatter"),
        ("        if (CL > 1) {   // every rank's sums",
         "STAMP(2)\n        if (CL > 1) {   // every rank's sums"),
        ("      // this warp's cells on this rank",
         "STAMP(3)\n      // this warp's cells on this rank"),
        ("      // the next row tile's sums must not reach",
         "STAMP(4)\n      // the next row tile's sums must not reach"),
        STAMPS_ENTRY],
    # the sweep's products and drz loads taken out
    "no-products": [
        ("        for (int j = VEC * lane; j < JR; j += 32 * VEC) {",
         "        for (int j = VEC * lane; j < 0; j += 32 * VEC) {")],
    # the sweep's drz loads from L2 replaced by reads of R's slice in
    # shared memory (the products kept)
    "no-loads": [
        ("              x = __ldcg(reinterpret_cast<const VecT*>(\n"
         "                  d_next + (size_t)(nb + r) * J + jb + j));",
         "              x = *reinterpret_cast<const VecT*>(r_s + j);")],
    # one block of the dR pass an SM (up to 255 registers; the plan counts
    # half the slots)
    "dr-one-block": [("constexpr int kDrPerSm = 2;",
                      "constexpr int kDrPerSm = 1;")],
    # the dR pass without splitting M (no cluster sum)
    "dr-splits-1": [("constexpr int kDrMaxSplits = 4;",
                     "constexpr int kDrMaxSplits = 1;")],
    # the dR pass's M split in at most 2 chunks
    "dr-splits-2": [("constexpr int kDrMaxSplits = 4;",
                     "constexpr int kDrMaxSplits = 2;")],
    # the dR pass's ring of 4 stages (fewer cannot hold the partial tile)
    "dr-stages-4": [("constexpr int kDrStages = 6;",
                     "constexpr int kDrStages = 4;")],
    # the sweep without clusters: each block sums all of j
    "cluster-1": [("constexpr int kMaxCluster = 2;",
                   "constexpr int kMaxCluster = 1;")],
}
WRONG = ("no-products", "no-loads")
# the points block 0 stamps in a sweep step (the "phases" build): the time
# from each to the next, the last to the next step's first
PHASES = ("products", "reduced, pushed", "ranks' sums arrived", "gates",
          "grid barrier")
REPS, B2B = 10, 10
P, I = ctypes.c_void_p, ctypes.c_int
T0 = time.perf_counter()
failures = []


def stamp(what):
    print(f"[{time.perf_counter() - T0:8.2f} s] {what}", flush=True)


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


def entries(lib):
    whole, dr = lib.gru_seq_bwd_f32, lib.gru_seq_bwd_dr_f32
    whole.argtypes = [P] * 13 + [I] * 3 + [P]
    dr.argtypes = [P] * 5 + [I] * 3 + [P]
    whole.restype = dr.restype = I
    return {"whole": whole, "dr": dr, "lib": lib}


def print_build(label, log):
    for line in log.splitlines():
        if any(w in line for w in ("registers", "spill", "arning", "rror",
                                   "Compiling entry")):
            print(f"build {label}: {line.strip()}", flush=True)


def start_copy(label, text, include=None):
    """Start nvcc on a copy of gru_seq_bwd.cu (``text``) in the build
    directory, headers searched in ``include`` first, then csrc/; returns
    (label, process, library)."""
    digest = hashlib.sha256(text.encode()).hexdigest()[:16]
    out = build.BUILD_DIR / f"ab-gru_seq_bwd-{label}-{digest}"
    out.mkdir(parents=True, exist_ok=True)
    (out / "gru_seq_bwd.cu").write_text(text)
    lib = out / "libgru_seq_bwd.so"
    dirs = [include] if include else []
    cmd = [build._nvcc(), *build.NVCC_FLAGS,
           *(f"-I{d}" for d in dirs + [build.CSRC]), "-o", str(lib),
           str(out / "gru_seq_bwd.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return label, proc, lib


def finish_copy(started, sass):
    label, proc, lib = started
    log, _ = proc.communicate()
    print_build(label, log)
    if proc.returncode:
        check(False, f"{label} did not build:\n{log}")
        return None
    if sass:
        sass_counts(label, lib)
    return entries(ctypes.CDLL(str(lib)))


def patched(text, edits, label):
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"diagnostic {label}: {old!r} appears "
                             f"{text.count(old)} times in the source")
        text = text.replace(old, new)
    return text


def sweep_bound(t, n, h):
    """The sweep's half of row 6's bound: reads dhs, dhT, ru, rz_c, cand,
    hs, R, h0 once, writes dxw, drz and dh0 once; 2*T*N*H*3H
    multiply-adds of drz R^T."""
    return cs._bound(4 * (6 * t * n * h + 2 * n * h + h * 3 * h
                          + 6 * t * n * h + n * h), 2.0 * t * n * h * 3 * h)


def dr_bound(t, n, h):
    """The dR pass's: reads hs, h0 and drz once, writes dR and drb once;
    2*T*N*H*3H multiply-adds."""
    return cs._bound(4 * (t * n * h + n * h + 3 * t * n * h + h * 3 * h
                          + 3 * h), 2.0 * t * n * h * 3 * h)


class Case:
    """Inputs of one (T, N, H) shape from chip_smoke's seed, the residuals
    from the plain forward on the card, and output buffers for direct
    calls."""

    def __init__(self, t, n, h):
        self.shape = (t, n, h)
        rng = np.random.default_rng([cs.SEED, 14, t, n, h])

        def dev(*shape, scale=1.0):
            return torch.tensor((rng.normal(size=shape) * scale).astype(
                np.float32), device="cuda")

        xw = dev(t, n, 3 * h, scale=0.5)
        self.r = dev(h, 3 * h, scale=h ** -0.5)
        rb = dev(3 * h, scale=0.1)
        self.h0 = dev(n, h, scale=0.2)
        self.dhs, self.dhT = dev(t, n, h), dev(n, h)
        self.hs, self.ru, self.rzc, self.cand = gru.gru_seq_fwd_reference(
            xw, self.r, rb, self.h0)
        e = lambda *s: torch.empty(s, device="cuda")  # noqa: E731
        self.dxw, self.drz = e(t, n, 3 * h), e(t, n, 3 * h)
        self.dr, self.drb, self.dh0 = e(h, 3 * h), e(3 * h), e(n, h)

    @classmethod
    def dr_only(cls, t, n, h):
        """The dR pass's inputs alone (hs, h0, a drz) from a torch seed, at
        a width the sweep may not take, and its output buffers."""
        case = cls.__new__(cls)
        case.shape = (t, n, h)
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        case.hs, case.drz, case.h0 = (
            torch.randn(s, device="cuda", generator=gen)
            for s in ((t, n, h), (t, n, 3 * h), (n, h)))
        case.dr = torch.empty((h, 3 * h), device="cuda")
        case.drb = torch.empty((3 * h,), device="cuda")
        return case

    def ins(self):
        return [self.dhs, self.dhT, self.ru, self.rzc, self.cand, self.hs,
                self.r, self.h0]

    def whole(self, ent, stream):
        t, n, h = self.shape
        p = [x.data_ptr() for x in self.ins() + [self.dxw, self.drz, self.dr,
                                                  self.drb, self.dh0]]
        return lambda: ent["whole"](*p, t, n, h, stream)

    def dr_pass(self, ent, stream):
        t, n, h = self.shape
        p = [x.data_ptr() for x in (self.hs, self.h0, self.drz, self.dr,
                                    self.drb)]
        return lambda: ent["dr"](*p, t, n, h, stream)

    def outputs(self):
        return [a.clone() for a in (self.dxw, self.dr, self.drb, self.dh0)]

    def plain(self):
        return gru.gru_seq_bwd_reference(*self.ins())


def rel_err(got, want):
    return max(cs._rel_err(a, e) for a, e in zip(got, want))


def plan_checks(sms):
    shapes = sorted({(n, h) for _, n, h in CHECK_SHAPES} | set(PLAN_EXTRA))
    for n, h in shapes:
        mirror = gru.gru_seq_bwd_plan(n, h, sms)
        source = gru.gru_seq_bwd_source_plan(n, h, sms)
        check(source == mirror, f"sweep plan N={n} H={h}: source {source} "
              f"vs mirror {mirror}")
        card = gru.gru_seq_bwd_source_plan(n, h, 0)
        print(f"sweep plan N={n} H={h}: {mirror}; the card launches "
              f"{'the same' if card == mirror else card}", flush=True)
    for t, n, h in CHECK_SHAPES + [STEP_DR_SHAPE]:
        mirror = gru.gru_bwd_dr_plan(t, n, h, sms)
        source = gru.gru_bwd_dr_source_plan(t, n, h, sms)
        card = gru.gru_bwd_dr_source_plan(t, n, h, 0)
        check(source == mirror == card, f"dR plan {(t, n, h)}: source "
              f"{source}, card {card} vs mirror {mirror}")
        print(f"dR plan T,N,H {(t, n, h)}: {mirror[1]}", flush=True)


def wrapper_checks(case):
    _, n, h = case.shape
    check(rnn_step.takes_persistent("gru_bwd", n, h, torch.device("cuda")),
          f"gru_bwd N={n} H={h} takes the step route")
    got = gru.gru_seq_bwd(*case.ins())
    again = gru.gru_seq_bwd(*case.ins())
    torch.cuda.synchronize()
    want = case.plain()
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    err = rel_err(got, want)
    same = all(torch.equal(a, e) for a, e in zip(again, got))
    print(f"check T,N,H {case.shape}: max|d|/max {err:.3e} (dxw, dR, drb, "
          f"dh0: " + ", ".join(f"{cs._rel_err(a, e):.2e}" for a, e in
                               zip(got, want)) + f"); bits repeat {same}",
          flush=True)
    check(finite, f"{case.shape}: not finite")
    check(err <= cs.GRAD_TOL, f"{case.shape}: outside GRAD_TOL")
    check(same, f"{case.shape}: bits differ on a second run")


def copy_checks(case, label, ent, stream):
    rc = case.whole(ent, stream)()
    torch.cuda.synchronize()
    if rc != 0:
        check(False, f"{label} {case.shape}: code {rc}")
        return
    err = rel_err(case.outputs(), case.plain())
    print(f"{label} check T,N,H {case.shape}: max|d|/max {err:.3e}",
          flush=True)
    check(err <= cs.GRAD_TOL, f"{label} {case.shape}: outside GRAD_TOL")


def step_dr_check(sources, stream):
    """The dR pass alone at the step route's width, from a drz of the plain
    sweep's math, against hprev^T drz and its column sums; bits repeated."""
    t, n, h = STEP_DR_SHAPE
    case = Case.dr_only(t, n, h)
    hprev = torch.cat([case.h0[None], case.hs[:-1]]).reshape(-1, h)
    want = (hprev.T @ case.drz.reshape(-1, 3 * h),
            case.drz.reshape(-1, 3 * h).sum(0))
    for label, ent in sources.items():
        fn = case.dr_pass(ent, stream)
        check(fn() == 0, f"{label} step-route dR: launch")
        first = (case.dr.clone(), case.drb.clone())
        check(fn() == 0, f"{label} step-route dR: launch")
        torch.cuda.synchronize()
        err = rel_err(first, want)
        same = torch.equal(first[0], case.dr) and torch.equal(first[1],
                                                              case.drb)
        print(f"{label} dR pass T,N,H {STEP_DR_SHAPE}: max|d|/max "
              f"{err:.3e}; bits repeat {same}", flush=True)
        check(err <= cs.GRAD_TOL and same, f"{label} step-route dR")
    return case


def timings(case, sources, stream, dr_only=False):
    t, n, h = case.shape
    order = (["old", "new", "new", "old"] if "old" in sources else
             ["new", "new"]) + [x for x in sources if x not in ("new",
                                                                "old")]
    got = {}
    for label in order:
        ent = sources[label]
        dr = case.dr_pass(ent, stream)
        whole = None if dr_only else case.whole(ent, stream)
        rc = (whole or dr)()
        if rc != 0:
            print(f"time {label} {case.shape}: code {rc}", flush=True)
            continue
        torch.cuda.synchronize()
        d = (single_ms(dr), b2b_ms(dr))
        w = (single_ms(whole), b2b_ms(whole)) if whole else None
        got.setdefault(label, []).append((w, d))
    db = dr_bound(t, n, h)
    lines = []
    for label, runs in got.items():
        parts = [f"dR {d[0]:.4f} / {d[1]:.4f}" for _, d in runs]
        if not dr_only:
            parts = [f"whole {w[0]:.4f} / {w[1]:.4f}, dR {d[0]:.4f} / "
                     f"{d[1]:.4f}, sweep {w[0] - d[0]:.4f} / "
                     f"{w[1] - d[1]:.4f}" for w, d in runs]
        lines.append(f"{label}: " + "; ".join(parts))
    sb = sweep_bound(t, n, h)
    print(f"time T,N,H {case.shape} (ms, single / back to back): " +
          " | ".join(lines) + f" | bounds: dR {db[0]:.4f} ({db[1]})" +
          ("" if dr_only else f", sweep {sb[0]:.4f} ({sb[1]}), whole "
           f"{cs.gru_bwd_bound(t, n, h)[0]:.4f}"), flush=True)


def phase_split(label, case, ent, stream):
    """Block 0's mean time a sweep step from each stamped point to the next
    (steps T-2 .. 1 of one call of a "phases" build), in SM cycles and
    in ns; the steps run downwards, so a step's last point is followed by
    the first of step t - 1."""
    t = case.shape[0]
    if t < 4:
        return
    fn = ent["lib"].gru_seq_bwd_stamps
    fn.argtypes = [P]
    fn.restype = I
    case.whole(ent, stream)()
    torch.cuda.synchronize()
    out = torch.zeros(2, 512, 8, dtype=torch.int64)
    check(fn(out.data_ptr()) == 0, f"{label}: stamps not read")
    k = len(PHASES)
    d_cyc, d_ns = (torch.cat([a[1:-1, 1:k] - a[1:-1, :k - 1],
                              a[:-2, :1] - a[1:-1, k - 1:k]], 1).mean(0)
                   for a in (out[0, :t].double(), out[1, :t].double()))
    print(f"phases {label} T,N,H {case.shape}: " + "; ".join(
        f"to {name} {c:.0f} cycles {n:.0f} ns" for name, c, n in
        zip(PHASES, d_cyc.tolist(), d_ns.tolist())) +
        f"; a step {float(d_ns.sum()):.0f} ns", flush=True)


def sass_counts(label, lib, path=None):
    """Each kernel's count of instructions, FFMAs, shared-memory loads,
    local loads and stores and barriers in a built library's SASS
    (cuobjdump); with ``path``, the SASS is also written to that file."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                         capture_output=True, text=True).stdout
    ops = ("FFMA", "LDS", "LDL", "STL", "BAR", "LDG", "MEMBAR")
    counts, fn, sass = {}, None, []
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict.fromkeys(("all",) + ops, 0)
            sass.append(line)
        elif fn is not None and "/*" in line and ";" in line:
            sass.append(line)
            counts[fn]["all"] += 1
            for op in ops:
                counts[fn][op] += f" {op}" in line
    for fn, c in counts.items():
        print(f"sass {label} {fn[-48:]}: {c}", flush=True)
    if path is not None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text("\n".join(sass))
        print(f"sass written to {path}", flush=True)


def main():
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    args = sys.argv[1:]
    text = (build.CSRC / "gru_seq_bwd.cu").read_text()
    copies = []
    if "--old" in args:
        path = Path(args[args.index("--old") + 1])
        copies.append(start_copy("old", path.read_text(),
                                 str(path.resolve().parent)))
    diags = (args[args.index("--diag") + 1].split(",") if "--diag" in args
             else [])
    for label in diags:   # "a+b": the edits of a and of b
        edits = [e for part in label.split("+") for e in DIAGNOSTICS[part]]
        copies.append(start_copy(label, patched(text, edits, label)))
    stamp("building")
    try:
        build.load_all(["gru_seq_bwd", "rnn_step"])
    finally:
        print_build("new", build.build_log("gru_seq_bwd"))
    sources = {"new": entries(build.load("gru_seq_bwd"))}
    if "--sass" in args:
        sass_counts("new", build.library_path("gru_seq_bwd"),
                    args[args.index("--sass") + 1])
    for started in copies:
        ent = finish_copy(started, "--sass" in args)
        if ent is not None:
            sources[started[0]] = ent
    stamp("built")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"SMs {sms}", flush=True)
    plan_checks(sms)
    stamp("plans checked")
    stream = torch.cuda.current_stream().cuda_stream
    for shape in CHECK_SHAPES:
        case = Case(*shape)
        wrapper_checks(case)
        if shape in CHECK_SHAPES[:6]:
            for label, ent in sources.items():
                if label != "new" and not set(label.split("+")) & set(WRONG):
                    copy_checks(case, label, ent, stream)
        del case
    stamp("wrappers checked")
    step_case = step_dr_check(sources, stream)
    stamp("step-route dR checked")
    if "--no-time" not in args:
        for shape in TIME_SHAPES:
            timings(Case(*shape), sources, stream)
        timings(step_case, sources, stream, dr_only=True)
        stamp("timed")
    for label, ent in sources.items():
        if "phases" in label.split("+"):
            for shape in TIME_SHAPES:
                phase_split(label, Case(*shape), ent, stream)
    stamp("done")
    print(f"failures: {failures}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
