"""First call and A/B of the LSTM kernels (csrc/lstm_seq_infer.cu, rows 1-2,
and csrc/lstm_seq_bwd.cu, row 3) on a card.

    python scripts/lstm_seq_ab.py [--old DIR,...] [--diag LABEL,...]
                                  [--no-time] [--sass OUT]

Builds both sources, prints ptxas' registers, spills and warnings for each
kernel and the clusters of each size the card holds, compares the
sources' launch plans (``lstm_seq_plan``, ``lstm_seq_bwd_plan``,
``lstm_seq_bwd_dr_plan``) with their Python mirrors (kernels/lstm.py) at
every CHECK_SHAPES row, and holds the wrappers ``lstm_seq_infer``,
``lstm_seq_fwd`` and ``lstm_seq_bwd`` against their plain versions there
(chip_smoke's KERNEL_TOL; GRAD_TOL relative to each output's largest
element), each launched twice (the bits must repeat).

--old DIR,... names directories holding other copies of
lstm_seq_infer.cu and lstm_seq_bwd.cu with the same C entries: the first
is "old", the kernels before their redesign (``--old 31633cc``: the
directory ``_ab/31633cc`` is written from git, ``git show
31633cc:deeplearning4j_tpu_torch/csrc/<file>``, where it is missing and
git has the revision); the others are labelled by their directory's name
(an earlier build of the redesign, say). --diag builds copies of the sources
with one edit each (DIAGNOSTICS; "a+b" combines them). Every copy is
built into the git-ignored build directory (all nvcc at once). At every
TIME_SHAPES row each version is timed through its C entries on the same
buffers, as the median of single calls and as one CUDA-event window over
back-to-back calls, in turns (old, new, new, old, then the diagnostic
copies): the inference forward (row 2), the training forward (row 1), the
backward (row 3), its dR pass alone and the sweep as their difference,
beside each one's bound; at DR_SHAPES (the step route's LSTM widths) the
dR pass alone; at ROUTE_SHAPES (widths past 300, batches 19 to 1024)
each version's three entries against the step route's wrappers,
in turns (``--diag sweep-all-batches`` times the sweep also at the
batches it leaves to the step route). A "phases" build also prints where block 0's steps spend
their time (clock64 and %globaltimer stamps). --no-time stops after the
checks; --sass OUT prints each kernel's instruction counts and writes the
SASS to OUT.

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
from deeplearning4j_tpu_torch.kernels import build, lstm, rnn_step  # noqa: E402

SOURCES = ("lstm_seq_infer", "lstm_seq_bwd")
HEADER = "lstm_cluster.cuh"   # the plan and cluster machinery both include
# (T, N, H): chip_smoke's LSTM shapes, its edge shapes (the top of each
# domain), then ragged batches and widths, a width too narrow for a
# cluster of 8 and one that is no multiple of 4
CHECK_SHAPES = sorted(set(cs.KERNEL_SHAPES) | set(cs.TRAIN_SHAPES) | set(
    cs.LSTM_EDGE_SHAPES) | {(5, 33, 200), (4, 70, 37), (3, 5, 1),
                            (2, 130, 256), (3, 64, 300), (3, 40, 389)})
# (T, N, H) timed: serving's and training's batch, generation, the large
# batch, one step
TIME_SHAPES = [(100, 32, 256), (100, 8, 256), (100, 1, 256),
               (100, 1024, 256), (1, 8, 256), (13, 3, 200)]
DR_SHAPES = [(100, 32, 512), (100, 64, 1024)]   # the step route's dR pass
# (T, N, H) where the persistent kernels and the step route are both timed:
# the widths past those the kernels before the cluster redesign took at
# every batch (the forward's 389, the sweep's 300) and the edges, over the
# batches where a cluster's few rows take the plan to several waves
ROUTE_SHAPES = [(100, n, h) for h in (300, 320, 360, 389, 400, 431, 448)
                for n in (19, 32, 64, 128, 256, 1024)]
STAMP_MACRO = (
    "__device__ long long g_stamp[2 * 8 * 512];\n"
    "#define STAMP(k) if (blockIdx.x == 0 && threadIdx.x == 0 && t >= 0 "
    "&& t < 512) { unsigned long long g_; asm volatile(\"mov.u64 %0, "
    "%%globaltimer;\" : \"=l\"(g_)); g_stamp[t * 8 + (k)] = clock64(); "
    "g_stamp[8 * 512 + t * 8 + (k)] = (long long)g_; }")


def _stamps_entry(name):
    return (f'extern "C" const char* {name}_error_string',
            f'extern "C" int {name}_stamps(long long* out) {{\n'
            f'  return cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));\n'
            f'}}\n\nextern "C" const char* {name}_error_string')


# label -> {source or HEADER: edits} (each text must appear once in its
# file); a patched header is written beside each copied source
DIAGNOSTICS = {
    # block 0's thread 0 stamps clock64 and %globaltimer at PHASES' points
    # of every step; read back by <source>_stamps
    "phases": {
        "lstm_seq_infer": [
            ("namespace {", "namespace {\n" + STAMP_MACRO),
            ("    if (t > 0) {   // h_{t-1}",
             "STAMP(0)\n    if (t > 0) {   // h_{t-1}"),
            ("    const float* const hb = xb",
             "STAMP(1)\n    const float* const hb = xb"),
            ("    // the cells: the splits' sums in split order, then the "
             "gates",
             "STAMP(2)\n    // the cells: the splits' sums in split order, "
             "then the gates"),
            ("    if (t + 1 < T) {\n      __syncthreads();",
             "STAMP(3)\n    if (t + 1 < T) {\n      __syncthreads();"),
            ("      // xw_{t+1} of the cells",
             "STAMP(4)\n      // xw_{t+1} of the cells"),
            _stamps_entry("lstm_seq_infer")],
        "lstm_seq_bwd": [
            ("namespace {", "namespace {\n" + STAMP_MACRO),
            ("    if (have_next) {   // every rank's pushes",
             "STAMP(0)\n    if (have_next) {   // every rank's pushes"),
            ("      const float* const db = xb",
             "STAMP(1)\n      const float* const db = xb"),
            ("    // the cells: the splits' sums in split order, then dz",
             "STAMP(2)\n    // the cells: the splits' sums in split order, "
             "then dz"),
            ("    if (t < 0) break;", "STAMP(3)\n    if (t < 0) break;"),
            ("    // step t-1's inputs of the cells",
             "STAMP(4)\n    // step t-1's inputs of the cells"),
            _stamps_entry("lstm_seq_bwd")]},
    # clusters of 16 first where they fit (8 otherwise)
    "c16": {HEADER: [("constexpr int kClusterOrder[5] = {8, 16, 4, 2, 1};",
                      "constexpr int kClusterOrder[5] = {16, 8, 4, 2, 1};")]},
    # the sweep at every batch its slices fit (sweep_takes left out), so
    # that the route timings time it where the step route takes the shape
    "sweep-all-batches": {HEADER: [(
        "  if (kBwd && !sweep_takes(N, H, caps[0])) return -1;\n", "")]},
    # half the splits of the reduction at most (longer ranges, fewer
    # partial sums a cell, fewer threads)
    "splits-half": {HEADER: [(
        "constexpr int max_splits(bool bwd) { return bwd ? 32 : 8; }",
        "constexpr int max_splits(bool bwd) { return bwd ? 16 : 4; }")]},
}
WRONG = ()
# the points block 0 stamps in a step: the time from each to the next,
# the last to the next step's first
PHASES = ("wait for h (dz)", "products, partials", "cells",
          "stage and pushes", "next inputs")
REPS, B2B = 10, 20
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


def entries(libs):
    """The C entries of a version: {"infer", "fwd", "bwd", "dr"}."""
    fwd, bwd = libs
    out = {"infer": fwd.lstm_seq_infer_f32, "fwd": fwd.lstm_seq_fwd_f32,
           "bwd": bwd.lstm_seq_bwd_f32, "dr": bwd.lstm_seq_bwd_dr_f32,
           "libs": libs}
    out["infer"].argtypes = out["fwd"].argtypes = [P] * 7 + [I] * 3 + [P]
    out["bwd"].argtypes = [P] * 13 + [I] * 3 + [P]
    out["dr"].argtypes = [P] * 4 + [I] * 3 + [P]
    for k in ("infer", "fwd", "bwd", "dr"):
        out[k].restype = I
    return out


def print_build(label, log):
    for line in log.splitlines():
        if any(w in line for w in ("registers", "spill", "arning", "rror",
                                   "Compiling entry")):
            print(f"build {label}: {line.strip()}", flush=True)


def start_copy(label, name, text, include=None, header=None):
    """Start nvcc on a copy of csrc/<name>.cu (``text``) in the build
    directory, beside a copy of HEADER (``header``) where given; headers
    are searched there, then in ``include``, then in csrc/; returns
    (process, library)."""
    digest = hashlib.sha256((text + (header or "")).encode()).hexdigest()[:16]
    out = build.BUILD_DIR / f"ab-{name}-{label}-{digest}"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(text)
    if header is not None:
        (out / HEADER).write_text(header)
    lib = out / f"lib{name}.so"
    dirs = [include] if include else []
    cmd = [build._nvcc(), *build.NVCC_FLAGS,
           *(f"-I{d}" for d in dirs + [build.CSRC]), "-o", str(lib),
           str(out / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, lib


def finish_copies(label, started, sass):
    libs = []
    for name, (proc, lib) in zip(SOURCES, started):
        log, _ = proc.communicate()
        print_build(f"{label} {name}", log)
        if proc.returncode:
            check(False, f"{label} {name} did not build:\n{log}")
            return None
        if sass:
            sass_counts(f"{label} {name}", lib)
        libs.append(ctypes.CDLL(str(lib)))
    return entries(libs)


def patched(text, edits, label):
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"diagnostic {label}: {old!r} appears "
                             f"{text.count(old)} times in the source")
        text = text.replace(old, new)
    return text


def old_dir(arg):
    """The directory of the old copies: ``_ab/<rev>`` written from git
    where ``arg`` names a revision and the directory lacks them, else
    ``arg`` itself."""
    def complete(p):
        return p.is_dir() and all((p / f"{n}.cu").exists() for n in SOURCES)

    path = Path(arg)
    if not complete(path):
        rev = path.name
        path = ROOT / "_ab" / rev
        if complete(path):
            return path
        path.mkdir(parents=True, exist_ok=True)
        for n in SOURCES:
            text = subprocess.run(
                ["git", "show",
                 f"{rev}:deeplearning4j_tpu_torch/csrc/{n}.cu"],
                cwd=ROOT, capture_output=True, text=True, check=True).stdout
            (path / f"{n}.cu").write_text(text)
    return path


class Case:
    """Inputs of one (T, N, H) shape from chip_smoke's seed (drawn on the
    card with ``device_rng``: the route shapes' arrays run to 0.7 GB), the
    residuals from the plain forward on the card, and output buffers for
    direct calls."""

    def __init__(self, t, n, h, dr_only=False, device_rng=False):
        self.shape = (t, n, h)
        rng = np.random.default_rng([cs.SEED, 15, t, n, h])
        gen = torch.Generator(device="cuda")
        gen.manual_seed(cs.SEED * 1000003 + (t * 4099 + n) * 8191 + h)

        def dev(*shape, scale=1.0):
            if device_rng:
                return torch.randn(shape, generator=gen,
                                   device="cuda") * scale
            return torch.tensor((rng.normal(size=shape) * scale).astype(
                np.float32), device="cuda")

        e = lambda *s: torch.empty(s, device="cuda")  # noqa: E731
        self.h0 = dev(n, h, scale=0.2)
        self.hs = dev(t, n, h, scale=0.5)
        self.dxw = dev(t, n, 4 * h)
        self.dr = e(h, 4 * h)
        if dr_only:
            return
        self.xw = dev(t, n, 4 * h, scale=0.5)
        self.r = dev(h, 4 * h, scale=h ** -0.5)
        self.c0 = dev(n, h, scale=0.2)
        self.dhs, self.dhT, self.dcT = dev(t, n, h), dev(n, h), dev(n, h)
        self.hs, self.gates, self.cs = lstm.lstm_seq_fwd_reference(
            self.xw, self.r, self.h0, self.c0)
        self.o_hs, self.o_gates, self.o_cs = e(t, n, h), e(t, n, 4 * h), \
            e(t, n, h)
        self.hT, self.cT = e(n, h), e(n, h)
        self.dh0, self.dc0 = e(n, h), e(n, h)

    def fwd_ins(self):
        return [self.xw, self.r, self.h0, self.c0]

    def bwd_ins(self):
        return [self.dhs, self.dhT, self.dcT, self.gates, self.cs, self.hs,
                self.r, self.h0, self.c0]

    def calls(self, ent, stream):
        """{entry: call} on this case's buffers."""
        t, n, h = self.shape
        ptr = lambda xs: [x.data_ptr() for x in xs]  # noqa: E731
        dr = ptr([self.hs, self.h0, self.dxw, self.dr])
        out = {"dr": lambda: ent["dr"](*dr, t, n, h, stream)}
        if not hasattr(self, "xw"):
            return out
        fi = ptr(self.fwd_ins() + [self.o_hs, self.hT, self.cT])
        ff = ptr(self.fwd_ins() + [self.o_hs, self.o_gates, self.o_cs])
        bw = ptr(self.bwd_ins() + [self.dxw, self.dr, self.dh0, self.dc0])
        out.update(infer=lambda: ent["infer"](*fi, t, n, h, stream),
                   fwd=lambda: ent["fwd"](*ff, t, n, h, stream),
                   bwd=lambda: ent["bwd"](*bw, t, n, h, stream))
        return out


def rel_err(got, want):
    return max(cs._rel_err(a, e) for a, e in zip(got, want))


def abs_err(got, want):
    return max(float((a - e).abs().max()) for a, e in zip(got, want))


def plan_checks(caps, bwd_caps, sms):
    shapes = sorted({(n, h) for _, n, h in CHECK_SHAPES})
    for n, h in shapes:
        for kind, mirror, source, c in (
                ("forward", lstm.lstm_seq_plan(n, h, caps),
                 [lstm.lstm_seq_source_plan(n, h, s, caps) for s in (0, 1)],
                 caps),
                ("sweep", lstm.lstm_seq_bwd_plan(n, h, bwd_caps),
                 [lstm.lstm_seq_bwd_source_plan(n, h, bwd_caps)], bwd_caps)):
            check(all(s == mirror for s in source),
                  f"{kind} plan N={n} H={h}: source {source} vs mirror "
                  f"{mirror}")
            print(f"{kind} plan N={n} H={h}: {mirror}", flush=True)
    for t, n, h in CHECK_SHAPES + DR_SHAPES:
        mirror = lstm.lstm_bwd_dr_plan(t, n, h, sms)
        source = lstm.lstm_bwd_dr_source_plan(t, n, h, 0)
        check(source == mirror, f"dR plan {(t, n, h)}: source {source} vs "
              f"mirror {mirror}")
        print(f"dR plan T,N,H {(t, n, h)}: {mirror[1]}", flush=True)


def wrapper_checks(case, sms):
    """The wrappers by the route they take (the persistent kernels, but
    the backward past the sweep's batches) against the plain versions."""
    _, n, h = case.shape
    dev = torch.device("cuda")
    for kind in ("lstm_infer", "lstm_fwd", "lstm_bwd"):
        want = kind != "lstm_bwd" or lstm.sweep_takes(n, h, sms)
        check(rnn_step.takes_persistent(kind, n, h, dev) == want,
              f"{kind} N={n} H={h} takes the other route")
    with torch.no_grad():
        got_i = [lstm.lstm_seq_infer(*case.fwd_ins()) for _ in range(2)]
    got_f = [lstm.lstm_seq_fwd(*case.fwd_ins()) for _ in range(2)]
    got_b = [lstm.lstm_seq_bwd(*case.bwd_ins()) for _ in range(2)]
    torch.cuda.synchronize()
    want_i = lstm.lstm_seq_infer_reference(*case.fwd_ins())
    want_b = lstm.lstm_seq_bwd_reference(*case.bwd_ins())
    err_i = abs_err(got_i[0], want_i)
    err_f = abs_err(got_f[0], (case.hs, case.gates, case.cs))
    err_b = rel_err(got_b[0], want_b)
    same = [all(torch.equal(a, e) for a, e in zip(*runs))
            for runs in (got_i, got_f, got_b)]
    finite = all(bool(torch.isfinite(a).all())
                 for a in (*got_i[0], *got_f[0], *got_b[0]))
    print(f"check T,N,H {case.shape}: infer max|d| {err_i:.3e}, fwd "
          f"{err_f:.3e}, bwd max|d|/max {err_b:.3e} (dxw, dR, dh0, dc0: " +
          ", ".join(f"{cs._rel_err(a, e):.2e}" for a, e in
                    zip(got_b[0], want_b)) + f"); bits repeat {same}",
          flush=True)
    check(finite, f"{case.shape}: not finite")
    check(max(err_i, err_f) <= cs.KERNEL_TOL, f"{case.shape}: forward "
          f"outside KERNEL_TOL")
    check(err_b <= cs.GRAD_TOL, f"{case.shape}: backward outside GRAD_TOL")
    check(all(same), f"{case.shape}: bits differ on a second run")


def copy_checks(case, label, ent, stream):
    calls = case.calls(ent, stream)
    rcs = [calls[k]() for k in ("infer", "bwd")]
    torch.cuda.synchronize()
    if any(rcs):
        check(False, f"{label} {case.shape}: codes {rcs}")
        return
    err_i = abs_err((case.o_hs, case.hT, case.cT),
                    lstm.lstm_seq_infer_reference(*case.fwd_ins()))
    err_b = rel_err((case.dxw, case.dr, case.dh0, case.dc0),
                    lstm.lstm_seq_bwd_reference(*case.bwd_ins()))
    print(f"{label} check T,N,H {case.shape}: infer max|d| {err_i:.3e}, bwd "
          f"max|d|/max {err_b:.3e}", flush=True)
    check(err_i <= cs.KERNEL_TOL and err_b <= cs.GRAD_TOL,
          f"{label} {case.shape}: outside the tolerances")


def timings(case, sources, stream, dr_only=False):
    t, n, h = case.shape
    order = (["old", "new", "new", "old"] if "old" in sources else
             ["new", "new"]) + [x for x in sources if x not in ("new",
                                                                "old")]
    keys = ("dr",) if dr_only else ("infer", "fwd", "bwd", "dr")
    got = {}
    for label in order:
        calls = case.calls(sources[label], stream)
        rcs = [calls[k]() for k in keys]
        if any(rcs):
            print(f"time {label} {case.shape}: codes {rcs}", flush=True)
            continue
        torch.cuda.synchronize()
        got.setdefault(label, []).append(
            {k: (single_ms(calls[k]), b2b_ms(calls[k])) for k in keys})
    lines = []
    for label, runs in got.items():
        parts = []
        for r in runs:
            s = {k: f"{v[0]:.4f} / {v[1]:.4f}" for k, v in r.items()}
            if not dr_only:
                s["sweep"] = (f"{r['bwd'][0] - r['dr'][0]:.4f} / "
                              f"{r['bwd'][1] - r['dr'][1]:.4f}")
            parts.append(", ".join(f"{k} {v}" for k, v in s.items()))
        lines.append(f"{label}: " + "; ".join(parts))
    db = cs.lstm_dr_bound(t, n, h)
    bounds = f"dR {db[0]:.4f} ({db[1]})"
    if not dr_only:
        bounds = (f"infer {cs.lstm_bound(t, n, h)[0]:.4f}, fwd "
                  f"{cs.fwd_bound(t, n, h)[0]:.4f}, bwd "
                  f"{cs.bwd_bound(t, n, h)[0]:.4f}, sweep "
                  f"{cs.lstm_sweep_bound(t, n, h)[0]:.4f}, " + bounds)
    print(f"time T,N,H {case.shape} (ms, single / back to back): " +
          " | ".join(lines) + f" | bounds: {bounds}", flush=True)


def route_timings(case, sources, caps, bwd_caps, stream):
    """At one ROUTE_SHAPES row, the persistent kernels of every source
    (their C entries) against the step route (the wrappers of
    kernels/rnn_step.py that the LSTM wrappers call, its dR pass
    included), in turns (step, the sources, the sources again, step),
    single and back to back; with each persistent plan's clusters, rows a
    cluster and waves. An entry that refuses the shape is given with its
    code (the sweep's -1: the step route's batch; the old copy's -1 or -2
    past its domain)."""
    t, n, h = case.shape
    labels = list(sources)
    step = {"infer": lambda: rnn_step.lstm_step_infer(*case.fwd_ins()),
            "fwd": lambda: rnn_step.lstm_step_fwd(*case.fwd_ins()),
            "bwd": lambda: rnn_step.lstm_step_bwd(*case.bwd_ins())}
    got = {}
    for label in ["step"] + labels + labels[::-1] + ["step"]:
        calls = step if label == "step" else case.calls(sources[label],
                                                          stream)
        rcs = dict.fromkeys(step, 0)
        if label != "step":
            rcs = {k: calls[k]() for k in step}
            torch.cuda.synchronize()
        got.setdefault(label, []).append(
            {k: (single_ms(calls[k]), b2b_ms(calls[k])) if rc == 0 else rc
             for k, rc in rcs.items()})
    plans = []
    for kind, (rc, p) in (("forward", lstm.lstm_seq_plan(n, h, caps)),
                          ("sweep", lstm.lstm_seq_bwd_plan(n, h, bwd_caps))):
        plans.append(f"{kind} " + (
            f"code {rc}" if rc else f"clusters of {p['cluster']}, "
            f"{p['rows']} rows, {-(-p['tiles'] // p['resident'])} waves"))
    parts = [f"{label}: " + "; ".join(", ".join(
        f"{k} code {v}" if isinstance(v, int) else
        f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in r.items()) for r in runs)
        for label, runs in got.items()]
    print(f"route T,N,H {case.shape} (ms, single / back to back; mirror "
          f"plans: {', '.join(plans)}): " + " | ".join(parts), flush=True)


def phase_split(label, case, ent, stream):
    """Block 0's mean time a step from each stamped point to the next (the
    middle steps of one call of each kernel of a "phases" build), in SM
    cycles and in ns."""
    t = case.shape[0]
    if t < 4:
        return
    calls = case.calls(ent, stream)
    k = len(PHASES)
    for key, name, lib in (("infer", "lstm_seq_infer", ent["libs"][0]),
                           ("bwd", "lstm_seq_bwd", ent["libs"][1])):
        fn = getattr(lib, f"{name}_stamps")
        fn.argtypes = [P]
        fn.restype = I
        calls[key]()
        torch.cuda.synchronize()
        out = torch.zeros(2, 512, 8, dtype=torch.int64)
        check(fn(out.data_ptr()) == 0, f"{label}: stamps not read")
        # the forward's steps run upwards, the sweep's downwards
        a_cyc, a_ns = (out[i, :t, :k].double() for i in (0, 1))
        nxt = (lambda a: a[2:, :1]) if key == "infer" else (
            lambda a: a[:-2, :1])
        d_cyc, d_ns = (torch.cat([a[1:-1, 1:] - a[1:-1, :-1],
                                  nxt(a) - a[1:-1, -1:]], 1).mean(0)
                       for a in (a_cyc, a_ns))
        print(f"phases {label} {key} T,N,H {case.shape}: " + "; ".join(
            f"{name_} {c:.0f} cycles {n_:.0f} ns" for name_, c, n_ in
            zip(PHASES, d_cyc.tolist(), d_ns.tolist())) +
            f"; a step {float(d_ns.sum()):.0f} ns", flush=True)


def sass_counts(label, lib, path=None):
    """Each kernel's count of instructions, FFMAs, shared-memory loads,
    local loads and stores and barriers in a built library's SASS
    (cuobjdump); with ``path``, the SASS is also written to that file."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                         capture_output=True, text=True).stdout
    ops = ("FFMA", "LDS", "LDL", "STL", "BAR", "LDG", "MEMBAR", "SYNCS")
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
        with open(path, "a") as f:
            f.write("\n".join(sass) + "\n")
        print(f"sass written to {path}", flush=True)


def main():
    args = sys.argv[1:]
    olds = ([old_dir(a) for a in args[args.index("--old") + 1].split(",")]
            if "--old" in args else [])
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    texts = {n: (build.CSRC / f"{n}.cu").read_text() for n in SOURCES}
    copies = []
    for i, old in enumerate(olds):
        label = "old" if i == 0 else old.name
        copies.append((label, [start_copy(label, n,
                                          (old / f"{n}.cu").read_text(),
                                          str(old)) for n in SOURCES]))
    diags = (args[args.index("--diag") + 1].split(",") if "--diag" in args
             else [])
    header = (build.CSRC / HEADER).read_text()
    for label in diags:   # "a+b": the edits of a and of b

        def edits(name):
            return [e for part in label.split("+")
                    for e in DIAGNOSTICS[part].get(name, [])]

        head = patched(header, edits(HEADER), label)
        copies.append((label, [start_copy(
            label, n, patched(texts[n], edits(n), label),
            header=head if head != header else None) for n in SOURCES]))
    stamp("building")
    try:
        build.load_all(list(SOURCES) + ["rnn_step"])
    finally:
        for n in SOURCES:
            print_build(f"new {n}", build.build_log(n))
    sources = {"new": entries([build.load(n) for n in SOURCES])}
    sass = "--sass" in args
    if sass:
        for n in SOURCES:
            sass_counts(f"new {n}", build.library_path(n),
                        args[args.index("--sass") + 1])
    for label, started in copies:
        ent = finish_copies(label, started, sass)
        if ent is not None:
            sources[label] = ent
    stamp("built")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    caps, bwd_caps = lstm.lstm_seq_clusters(), lstm.lstm_seq_clusters(True)
    print(f"SMs {sms}; clusters the card holds at one block an SM: forward "
          f"{caps}, sweep {bwd_caps}", flush=True)
    plan_checks(caps, bwd_caps, sms)
    stamp("plans checked")
    stream = torch.cuda.current_stream().cuda_stream
    for shape in CHECK_SHAPES:
        case = Case(*shape)
        wrapper_checks(case, sms)
        if shape in TIME_SHAPES:
            for label, ent in sources.items():
                if label != "new" and not set(label.split("+")) & set(WRONG):
                    copy_checks(case, label, ent, stream)
        del case
        stamp(f"checked {shape}")
    if "--no-time" not in args and not failures:
        for shape in TIME_SHAPES:
            timings(Case(*shape), sources, stream)
        for shape in DR_SHAPES:
            timings(Case(*shape, dr_only=True), sources, stream, dr_only=True)
        stamp("timed")
        for shape in ROUTE_SHAPES:
            route_timings(Case(*shape, device_rng=True), sources, caps,
                          bwd_caps, stream)
        stamp("routes timed")
    for label, ent in sources.items():
        if "phases" in label.split("+"):
            for shape in TIME_SHAPES:
                phase_split(label, Case(*shape), ent, stream)
    stamp("done")
    print(f"failures: {failures}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
