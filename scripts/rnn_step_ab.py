"""First call and A/B of the step route (csrc/rnn_step.cu) on a card.

    python scripts/rnn_step_ab.py [--old FILE ...] [--no-time] [--sass OUT]

Builds csrc/rnn_step.cu (and the dR passes' sources), prints ptxas'
registers, spills and warnings, compares the source's launch plan with its
Python mirror (kernels/rnn_step.py step_plan) at every row of
chip_smoke.py's STEP_SHAPES and at the edge shapes below, then holds the
step wrappers (rnn_step.lstm_step_* and gru_step_*: inference, training
forward, backward with its dR pass) against the plain versions at those
shapes (chip_smoke's tolerances: 1e-4 forward, 1e-4 of each output's
largest backward), the backward's bits repeated on a second run.

Each --old FILE is another copy of rnn_step.cu with the same C entries (an
earlier commit's, from ``git show <rev>:deeplearning4j_tpu_torch/csrc/
rnn_step.cu``, or a diagnostic variant), built beside the new one into the
git-ignored build directory. Its outputs are compared with the new
source's, and at every STEP_SHAPES row each entry (inference, training
forward, reverse sweep) of each source is timed through ctypes on the same
buffers, as the median of single calls and as one CUDA-event window over
back-to-back calls, in turns (old, new, new, old), beside cuDNN's layer
(inference, single and back to back). At the two report shapes
(chip_smoke.STEP_REPORT) torch.profiler splits the new wrappers' device
time by kernel: the forward's T launches, the backward's reverse sweep
(T+1 launches) apart from its dR pass. The step launches overlap (each
next step's blocks start early and wait), so their profiler sum exceeds
the time they take; the direct timings above are the sweep's own. --no-time stops after the checks;
--sass OUT writes the built source's SASS to the file OUT and prints each
kernel's instruction, FFMA and shared-load counts.

Exits 1 if a check fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deeplearning4j_tpu_torch.kernels import (  # noqa: E402
    build, gru, lstm, rnn_step)

# (cell, T, N, H): more than one row tile (N = 65, 130), a width that is
# not a multiple of the units (520), N = 1 at H = 2048 with a short T, and
# widths that are not a multiple of 4 (the 4-byte copies)
EDGE_SHAPES = [("lstm", 6, 65, 520), ("gru", 6, 65, 520),
               ("lstm", 5, 130, 512), ("gru", 5, 130, 520),
               ("lstm", 4, 1, 2048), ("gru", 4, 1, 2048),
               ("lstm", 7, 5, 33), ("gru", 7, 3, 130)]
REPS, B2B = 10, 10
P, I = ctypes.c_void_p, ctypes.c_int
ENTRIES = {"fwd_lstm": ("rnn_step_fwd_lstm_f32", [P] * 8 + [I] * 4 + [P]),
           "fwd_gru": ("rnn_step_fwd_gru_f32", [P] * 8 + [I] * 4 + [P]),
           "bwd_lstm": ("rnn_step_bwd_lstm_f32", [P] * 9 + [I] * 3 + [P]),
           "bwd_gru": ("rnn_step_bwd_gru_f32", [P] * 12 + [I] * 3 + [P])}
failures = []


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
    out = {}
    for key, (name, types) in ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = I
        out[key] = fn
    return out


def print_build(label, log):
    for line in log.splitlines():
        if any(w in line for w in ("registers", "spill", "arning", "rror")):
            print(f"build {label}: {line.strip()}", flush=True)


def build_old(path):
    """The entries of another copy of rnn_step.cu, built into the build
    directory (keyed by its contents)."""
    src = Path(path).read_bytes()
    out = build.BUILD_DIR / (f"ab-rnn_step-"
                             f"{hashlib.sha256(src).hexdigest()[:16]}")
    out.mkdir(parents=True, exist_ok=True)
    (out / "rnn_step.cu").write_bytes(src)
    lib = out / "librnn_step.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), "-o", str(lib),
                           str(out / "rnn_step.cu")],
                          capture_output=True, text=True)
    print_build(path, proc.stdout + proc.stderr)
    if proc.returncode:
        raise RuntimeError(f"{path} did not build:\n{proc.stdout}"
                           f"{proc.stderr}")
    return entries(ctypes.CDLL(str(lib)))


class Case:
    """The inputs of one (cell, T, N, H) shape, made from chip_smoke's seed
    as its step-route phase makes them, and buffers for direct calls."""

    def __init__(self, cell, t, n, h):
        self.cell, self.shape = cell, (t, n, h)
        g = 4 if cell == "lstm" else 3
        rng = np.random.default_rng([cs.SEED, 9, g, t, n, h])

        def dev(*shape, scale=1.0):
            return torch.tensor((rng.normal(size=shape) * scale).astype(
                np.float32), device="cuda")

        self.x = dev(t, n, h)
        self.w, self.r = dev(h, g * h, scale=h ** -0.5), \
            dev(h, g * h, scale=h ** -0.5)
        self.b = dev(g * h, scale=0.1)
        self.h0, self.c0, self.rb = dev(n, h, scale=0.2), \
            dev(n, h, scale=0.2), dev(g * h, scale=0.1)
        self.dhs, self.dhT, self.dcT = dev(t, n, h), dev(n, h), dev(n, h)
        self.xw = torch.matmul(self.x, self.w) + self.b
        self.state = (self.h0, self.c0) if cell == "lstm" else \
            (self.rb, self.h0)
        e = lambda *s: torch.empty(s, device="cuda")  # noqa: E731
        self.hs, self.c = e(t, n, h), e(n, h)
        self.gates = e(t, n, g * h if cell == "lstm" else 2 * h)
        self.cs, self.rzc, self.cand = e(t, n, h), e(t, n, h), e(t, n, h)
        self.dxw, self.drz = e(t, n, g * h), e(t, n, g * h)
        self.dcarry, self.dh0 = e(n, h), e(n, h)

    def names(self):
        return [f"{self.cell}_step_{k}" for k in ("infer", "fwd", "bwd")]

    def wrappers(self):
        return [getattr(rnn_step, name) for name in self.names()]

    def bwd_args(self, fwd):
        if self.cell == "lstm":
            hs, gates, cs_ = fwd
            return (self.dhs, self.dhT, self.dcT, gates, cs_, hs, self.r,
                    self.h0, self.c0)
        hs, ru, rzc, cand = fwd
        return (self.dhs, self.dhT, ru, rzc, cand, hs, self.r, self.h0)

    def direct(self, ent, kind, stream):
        """A call of entry ``kind`` ("infer", "fwd", "sweep") of ``ent`` on
        this case's buffers (the sweep fed by the last direct "fwd")."""
        t, n, h = self.shape
        p = lambda *xs: [None if x is None else x.data_ptr()  # noqa: E731
                         for x in xs]
        if self.cell == "lstm":
            if kind in ("infer", "fwd"):
                save = int(kind == "fwd")
                return lambda: ent["fwd_lstm"](
                    *p(self.xw, self.r, self.h0, self.c0, self.hs, self.c,
                       self.gates, self.cs), save, t, n, h, stream)
            return lambda: ent["bwd_lstm"](
                *p(self.dhs, self.dhT, self.gates, self.cs, self.r, self.c0,
                   self.dxw, self.dcarry, self.dh0), t, n, h, stream)
        if kind in ("infer", "fwd"):
            save = int(kind == "fwd")
            return lambda: ent["fwd_gru"](
                *p(self.xw, self.r, self.rb, self.h0, self.hs, self.gates,
                   self.rzc, self.cand), save, t, n, h, stream)
        return lambda: ent["bwd_gru"](
            *p(self.dhs, self.dhT, self.gates, self.rzc, self.cand, self.hs,
               self.r, self.h0, self.dxw, self.drz, self.dcarry, self.dh0),
            t, n, h, stream)

    def run_direct(self, ent, stream):
        """Each direct entry once, state buffers reset first; returns
        copies of (infer hs, fwd hs, sweep dxw, dh0)."""
        out = []
        for kind in ("infer", "fwd", "sweep"):
            self.c.copy_(self.c0)
            self.dcarry.copy_(self.dcT)
            rc = self.direct(ent, kind, stream)()
            check(rc == 0, f"{self.cell} {self.shape} {kind}: code {rc}")
            torch.cuda.synchronize()
            out.append(self.hs.clone() if kind != "sweep" else
                       (self.dxw.clone(), self.dh0.clone()))
        return out


def plan_checks(sms):
    for cell, t, n, h in cs.STEP_SHAPES + EDGE_SHAPES:
        for kind in rnn_step.STEP_KINDS:
            mirror = rnn_step.step_plan(cell, kind, n, h, sms)
            source = rnn_step.step_source_plan(cell, kind, n, h, sms)
            check(mirror == source, f"step plan {cell} {kind} N={n} H={h}: "
                  f"mirror {mirror} vs source {source}")
            print(f"plan {cell} {kind} N={n} H={h}: {source}", flush=True)


def wrapper_checks(case):
    mod = lstm if case.cell == "lstm" else gru
    infer, fwd, bwd = case.wrappers()
    with torch.no_grad():
        got_i = infer(case.xw, case.r, *case.state)
    got_f = fwd(case.xw, case.r, *case.state)
    bwd_args = case.bwd_args(got_f)
    got_b = bwd(*bwd_args)
    again = bwd(*bwd_args)
    torch.cuda.synchronize()
    want_i = getattr(mod, f"{case.cell}_seq_infer_reference")(
        case.xw, case.r, *case.state)
    want_f = getattr(mod, f"{case.cell}_seq_fwd_reference")(
        case.xw, case.r, *case.state)
    want_b = getattr(mod, f"{case.cell}_seq_bwd_reference")(*bwd_args)
    finite = all(bool(torch.isfinite(a).all())
                 for a in (*got_i, *got_f, *got_b))
    err_i = max(float((a - e).abs().max()) for a, e in zip(got_i, want_i))
    err_f = max(float((a - e).abs().max()) for a, e in zip(got_f, want_f))
    rel_b = [cs._rel_err(a, e) for a, e in zip(got_b, want_b)]
    same = all(torch.equal(a, e) for a, e in zip(again, got_b))
    print(f"check {case.cell} T,N,H {case.shape}: infer max|d| {err_i:.3e}, "
          f"fwd {err_f:.3e}, bwd max|d|/max " +
          ", ".join(f"{x:.3e}" for x in rel_b) +
          f"; bits repeat {same}", flush=True)
    check(finite, f"{case.cell} {case.shape}: not finite")
    check(max(err_i, err_f) <= cs.KERNEL_TOL,
          f"{case.cell} {case.shape}: forward outside KERNEL_TOL")
    check(max(rel_b) <= cs.GRAD_TOL,
          f"{case.cell} {case.shape}: backward outside GRAD_TOL")
    check(same, f"{case.cell} {case.shape}: backward bits differ")
    return got_i[0], got_f[0]


def old_checks(case, olds, stream):
    new = case.run_direct(entries(build.load("rnn_step")), stream)
    for label, ent in olds.items():
        old = case.run_direct(ent, stream)
        d = [float((a - b).abs().max()) for a, b in
             ((old[0], new[0]), (old[1], new[1]), (old[2][0], new[2][0]),
              (old[2][1], new[2][1]))]
        print(f"{label} vs new {case.cell} {case.shape}: max|d| infer hs "
              f"{d[0]:.3e}, fwd hs {d[1]:.3e}, dxw {d[2]:.3e} (largest "
              f"{float(new[2][0].abs().max()):.3e}), dh0 {d[3]:.3e}",
              flush=True)


def timings(case, olds, stream):
    new = entries(build.load("rnn_step"))
    sources = [("new", new)] + list(olds.items())
    order = sources[1:] + [sources[0]] * 2 + sources[1:][::-1]
    for kind in ("infer", "fwd", "sweep"):
        got = {}
        for label, ent in order:
            fn = case.direct(ent, kind, stream)
            got.setdefault(label, []).append((single_ms(fn), b2b_ms(fn)))
        print(f"time {case.cell} {kind} T,N,H {case.shape}: " + "; ".join(
            f"{label} single " + ", ".join(f"{s:.4f}" for s, _ in v) +
            " b2b " + ", ".join(f"{x:.4f}" for _, x in v)
            for label, v in got.items()) + " ms", flush=True)
    t, n, h = case.shape
    layer = (torch.nn.LSTM if case.cell == "lstm" else torch.nn.GRU)(h, h)
    layer = layer.cuda()
    hc = (case.h0[None], case.c0[None]) if case.cell == "lstm" else \
        case.h0[None]
    with torch.inference_mode():
        lib = lambda: layer(case.x, hc)  # noqa: E731
        print(f"time {case.cell} cuDNN layer T,N,H {case.shape}: single "
              f"{single_ms(lib):.4f} b2b {b2b_ms(lib):.4f} ms", flush=True)


def device_split(case):
    """Device ms a call by kernel of the new wrappers (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    infer, fwd, bwd = case.wrappers()
    out_f = fwd(case.xw, case.r, *case.state)
    bwd_args = case.bwd_args(out_f)
    calls = {"infer": lambda: infer(case.xw, case.r, *case.state),
             "fwd": lambda: fwd(case.xw, case.r, *case.state),
             "bwd": lambda: bwd(*bwd_args)}
    for kind, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        n = 5
        with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) \
                as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [(e.self_device_time_total / n / 1e3, e.count // n, e.key)
                  for e in prof.key_averages()
                  if getattr(e, "self_device_time_total", 0) > 0]
        print(f"device {case.cell} {kind} T,N,H {case.shape}: "
              f"{sum(ms for ms, _, _ in events):.4f} ms a call: " + "; ".join(
                  f"{key[:48]} x{cnt} {ms:.4f}" for ms, cnt, key in
                  sorted(events, reverse=True)[:4]), flush=True)


def sass_dump(path):
    """The SASS of the built source into ``path``, and per kernel the count
    of its instructions, FFMAs and shared-memory loads (cuobjdump)."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass",
                          str(build.library_path("rnn_step"))],
                         capture_output=True, text=True).stdout
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(out)
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = [0, 0, 0]
        elif fn is not None and "/*" in line and ";" in line:
            counts[fn][0] += 1
            counts[fn][1] += " FFMA " in line
            counts[fn][2] += " LDS" in line
    for fn, (n, ffma, lds) in counts.items():
        print(f"sass {fn[:80]}: {n} instructions, {ffma} FFMA, {lds} LDS",
              flush=True)


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    names = ("rnn_step", "lstm_seq_bwd", "gru_seq_bwd")
    try:
        build.load_all(names)
    finally:
        print_build("rnn_step", build.build_log("rnn_step"))
    if "--sass" in sys.argv:
        sass_dump(sys.argv[sys.argv.index("--sass") + 1])
    olds = {sys.argv[i + 1]: build_old(sys.argv[i + 1])
            for i, arg in enumerate(sys.argv) if arg == "--old"}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"SMs {sms}", flush=True)
    plan_checks(sms)
    stream = torch.cuda.current_stream().cuda_stream
    cases = [Case(*shape) for shape in cs.STEP_SHAPES + EDGE_SHAPES]
    for case in cases:
        wrapper_checks(case)
        if olds:
            old_checks(case, olds, stream)
    if "--no-time" not in sys.argv:
        for case in cases[:len(cs.STEP_SHAPES)]:
            timings(case, olds, stream)
        for case in cases:
            if case.shape == cs.STEP_REPORT[case.cell]:
                device_split(case)
    print(f"failures: {failures}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
