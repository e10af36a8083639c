"""First call and A/B of the GRU forward kernel (csrc/gru_seq.cu) on a card.

    python scripts/gru_seq_ab.py [--old FILE [--old-phases]]
                                 [--diag LABEL,...] [--no-time] [--sass OUT]

Builds csrc/gru_seq.cu, prints ptxas' registers, spills and warnings for
each kernel, compares the source's launch plan (``gru_seq_plan``) with its
Python mirror (kernels/gru.py gru_seq_plan) at every CHECK_SHAPES row and
prints the plan the card launches (a smaller cluster where it cannot hold
the plan's clusters at once), then holds the wrappers gru_seq_infer and
gru_seq_fwd against their plain versions there (chip_smoke's 1e-4), each
launched twice (the bits must repeat).

--old FILE is another copy of gru_seq.cu with the same C entries (the
kernel before its redesign: ``git show d9f7f28:deeplearning4j_tpu_torch/
csrc/gru_seq.cu > _ab/old/gru_seq.cu``). --diag builds copies of the source
with one edit each (DIAGNOSTICS: a piece taken out, results wrong, or a
smaller cluster limit, results right). Each copy is built beside the source
into the git-ignored build directory (all nvcc at once), checked against
the plain version at CHECK_SHAPES' first rows (printed, gated only for the
old kernel and the cluster variants), and at every TIME_SHAPES row each
source is timed through ctypes on the same buffers, as the median of single
calls and as one CUDA-event window over back-to-back calls, in turns (old,
new, new, old, then the diagnostic copies), beside the bound, cuDNN's GRU
layer and the step route (csrc/rnn_step.cu's rnn_step_fwd_gru_f32, the
route wider GRUs take). --no-time stops after the checks; --sass OUT
prints each kernel's instruction counts (of the copies too) and writes
the source's SASS to the file OUT. A "phases" build (combined with others
as "phases+LABEL") also prints where block 0's steps spend their time;
--old-phases adds such a build of the old kernel.

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
    build, gru, rnn_step)

# (T, N, H): chip_smoke's GRU_SHAPES, then ragged batches (row tiles of
# 33 and 65 rows, 130 rows in two tiles), widths that are no multiple of 4
# or of the units, the widest width the old kernel took at every N and
# those it took at N = 1 and 2, and a width too narrow for a cluster of 2
CHECK_SHAPES = cs.GRU_SHAPES + [
    (5, 33, 1000), (4, 65, 1024), (3, 130, 200), (6, 17, 1056),
    (3, 130, 37), (2, 1024, 1056), (9, 2, 1112), (9, 1, 1157), (5, 3, 4)]
# (entry, T, N, H): training, serving's largest bucket, generation
TIME_SHAPES = [("fwd", 100, 64, 1024), ("infer", 100, 32, 1024),
               ("infer", 100, 1, 1024), ("infer", 1, 1, 1024)]
STAMP_MACRO = (
    "__device__ long long g_stamp[2 * 8 * 512];\n"
    "#define STAMP(k) if (blockIdx.x == 0 && threadIdx.x == 0 && t < 512) "
    "{ unsigned long long g_; asm volatile(\"mov.u64 %0, %%globaltimer;\" "
    ": \"=l\"(g_)); g_stamp[t * 8 + (k)] = clock64(); "
    "g_stamp[8 * 512 + t * 8 + (k)] = (long long)g_; }")
STAMPS_ENTRY = (
    'extern "C" const char* gru_seq_error_string',
    'extern "C" int gru_seq_stamps(long long* out) {\n'
    '  return cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));\n'
    '}\n\nextern "C" const char* gru_seq_error_string')
# label -> edits of the source (each text must appear once); "no-*" give
# wrong results and are only timed
DIAGNOSTICS = {
    "no-products": [("q < KR / 4; q += p.splits)", "q < 0; q += p.splits)"),
                    ("q < qn; q += p.splits)", "q < 0; q += p.splits)")],
    "no-h-loads": [("load_h(0, chunks, 0);", ";"),
                   ("if (s < chunks) load_h(s, 1, s);", ";"),
                   ("if (c + S - 1 < chunks) load_h(c + S - 1, 1, fill);",
                    ";")],
    "no-step-wait": [("if (t + 1 < a.T) grid.sync();", ";")],
    "no-pre-loads": [
        ("load_cell(a, xw_t, h_prev, n0 + e / U, j0 + e % U, pre[i]);",
         "pre[i][3] = 0.5f;")],
    "wait-all": [("cp_async_wait_upto(S - 2);", "cp_async_wait<0>();")],
    "ring-unroll2": [("          for (int q = ks; q < qn; q += p.splits)",
                      "#pragma unroll 2\n"
                      "          for (int q = ks; q < qn; q += p.splits)")],
    "resident-unroll4": [("#pragma unroll 2\n        for (int q = ks; q < "
                          "KR / 4; q += p.splits)", "#pragma unroll 4\n"
                          "        for (int q = ks; q < KR / 4; q += "
                          "p.splits)")],
    "cluster-1": [("constexpr int kMaxCluster = 2;",
                   "constexpr int kMaxCluster = 1;")],
    "ring": [("const bool resident = chunks < S;",
              "const bool resident = false;")],
    # block 0's thread 0 stamps clock64 and %globaltimer at PHASES' points
    # of every step (results right); read back by gru_seq_stamps
    "phases": [
        ("namespace {", "namespace {\n" + STAMP_MACRO),
        ("for (int tile = group; tile < p.tiles; tile += p.groups) {",
         "for (int tile = group; tile < p.tiles; tile += p.groups) {\n"
         "STAMP(0)"),
        ("      float acc[TM][4];", "STAMP(1)\n      float acc[TM][4];"),
        ("__syncthreads();   // the ring is free: the splits' sums go over "
         "it", "__syncthreads();   // the ring is free: the splits' sums go "
         "over it\nSTAMP(2)"),
        ("      const int c4n = C / 4;", "STAMP(3)\n      const int c4n = "
         "C / 4;"),
        ("      if (CL > 1) {   // every rank's sums",
         "STAMP(4)\n      if (CL > 1) {   // every rank's sums"),
        ("      auto sums = [&]", "STAMP(5)\n      auto sums = [&]"),
        ("      if (tile + p.groups < p.tiles) {",
         "STAMP(6)\n      if (tile + p.groups < p.tiles) {"),
        STAMPS_ENTRY],
}
# the copies whose results stay right: held to the tolerance like the old
EXACT = ("cluster-1", "wait-all", "ring", "phases", "ring-unroll2",
         "resident-unroll4")
# the points block 0 stamps in a step (the "phases" build): the time from
# each to the next, the last to the next step's first
PHASES = ("h loads issued", "chunks summed", "splits stored",
          "pushed", "ranks' sums arrived", "gates", "grid barrier")
# the same stamps in the kernel before its redesign (--old): OLD_PHASES
OLD_PHASE_EDITS = [
    ("namespace {", "namespace {\n" + STAMP_MACRO),
    ("for (int rt = group; rt < row_tiles; rt += row_groups) {",
     "for (int rt = group; rt < row_tiles; rt += row_groups) {\nSTAMP(0)"),
    ("      stage_rows<ROWS>(h_s, h_prev, n0, N, H);\n      __syncthreads();",
     "      stage_rows<ROWS>(h_s, h_prev, n0, N, H);\n      __syncthreads();"
     "\nSTAMP(1)"),
    ("      float acc[C];", "STAMP(2)\n      float acc[C];"),
    ("      warp_reduce_scatter<C>(acc, lane);",
     "STAMP(3)\n      warp_reduce_scatter<C>(acc, lane);"),
    ("      float s_r, s_u, s_c;", "STAMP(4)\n      float s_r, s_u, s_c;"),
    ("    if (t + 1 < T) grid.sync();", "STAMP(5)\n    if (t + 1 < T) "
     "grid.sync();"),
    STAMPS_ENTRY]
OLD_PHASES = ("h staged", "xw loads issued", "sums", "reduced", "gates",
              "grid barrier")
# the shared memory a block may use and the threads of the kernel's largest
# plans, at which the card's co-resident clusters are counted
CLUSTER_PROBE = """
#include <cuda_runtime.h>
__global__ void probe(float* p) {
  extern __shared__ float s[];
  if (p) p[0] = s[threadIdx.x];
}
extern "C" int max_clusters(int cluster, int threads, int smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 64);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, probe, &cfg);
}
"""
REPS, B2B = 10, 10
P, I = ctypes.c_void_p, ctypes.c_int
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
    infer, fwd = lib.gru_seq_infer_f32, lib.gru_seq_fwd_f32
    infer.argtypes = [P] * 6 + [I] * 3 + [P]
    fwd.argtypes = [P] * 8 + [I] * 3 + [P]
    infer.restype = fwd.restype = I
    return {"infer": infer, "fwd": fwd, "lib": lib}


def print_build(label, log):
    for line in log.splitlines():
        if any(w in line for w in ("registers", "spill", "arning", "rror",
                                   "Compiling entry")):
            print(f"build {label}: {line.strip()}", flush=True)


def start_copy(label, text):
    """Start nvcc on a copy of gru_seq.cu (``text``) in the build
    directory; returns (label, process, library)."""
    digest = hashlib.sha256(text.encode()).hexdigest()[:16]
    out = build.BUILD_DIR / f"ab-gru_seq-{label.replace('/', '_')}-{digest}"
    out.mkdir(parents=True, exist_ok=True)
    (out / "gru_seq.cu").write_text(text)
    lib = out / "libgru_seq.so"
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I",
                             str(build.CSRC), "-o", str(lib),
                             str(out / "gru_seq.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
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


def cluster_capacity():
    """How many clusters of 1, 2, 4 and 8 blocks (384 threads, 192 KB of
    shared memory: one block an SM) this card holds at once."""
    out = build.BUILD_DIR / "ab-cluster-probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(CLUSTER_PROBE)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o",
                    str(out / "libprobe.so"), str(out / "probe.cu")],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(out / "libprobe.so")).max_clusters
    fn.argtypes = [I, I, I, P]
    fn.restype = I
    for cluster in (1, 2, 4, 8):
        n = ctypes.c_int(0)
        rc = fn(cluster, 384, 192 * 1024, ctypes.byref(n))
        print(f"cluster capacity: {n.value} clusters of {cluster} "
              f"({n.value * cluster} blocks; code {rc})", flush=True)


def patched(text, edits, label):
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"diagnostic {label}: {old!r} appears "
                             f"{text.count(old)} times in the source")
        text = text.replace(old, new)
    return text


class Case:
    """Inputs of one (T, N, H) shape from chip_smoke's seed (as its GRU
    kernel phase makes them) and output buffers for direct calls."""

    def __init__(self, t, n, h):
        self.shape = (t, n, h)
        rng = np.random.default_rng([cs.SEED, 12, t, n, h])

        def dev(*shape, scale=1.0):
            return torch.tensor((rng.normal(size=shape) * scale).astype(
                np.float32), device="cuda")

        self.x = dev(t, n, cs.GRU_EMBED)
        self.w = dev(cs.GRU_EMBED, 3 * h, scale=cs.GRU_EMBED ** -0.5)
        self.r = dev(h, 3 * h, scale=h ** -0.5)
        self.b, self.rb = dev(3 * h, scale=0.1), dev(3 * h, scale=0.1)
        self.h0 = dev(n, h, scale=0.2)
        self.xw = torch.matmul(self.x, self.w) + self.b
        e = lambda *s: torch.empty(s, device="cuda")  # noqa: E731
        self.hs, self.hT = e(t, n, h), e(n, h)
        self.ru, self.rzc, self.cand = e(t, n, 2 * h), e(t, n, h), e(t, n, h)

    def direct(self, ent, kind, stream):
        t, n, h = self.shape
        p = [x.data_ptr() for x in (self.xw, self.r, self.rb, self.h0,
                                    self.hs)]
        if kind == "infer":
            return lambda: ent["infer"](*p, self.hT.data_ptr(), t, n, h,
                                        stream)
        return lambda: ent["fwd"](*p, self.ru.data_ptr(),
                                  self.rzc.data_ptr(), self.cand.data_ptr(),
                                  t, n, h, stream)

    def outputs(self, kind):
        if kind == "infer":
            return [self.hs.clone(), self.hT.clone()]
        return [a.clone() for a in (self.hs, self.ru, self.rzc, self.cand)]

    def plain(self, kind):
        fn = (gru.gru_seq_infer_reference if kind == "infer" else
              gru.gru_seq_fwd_reference)
        return fn(self.xw, self.r, self.rb, self.h0)


def plan_checks(sms):
    for t, n, h in CHECK_SHAPES:
        mirror = gru.gru_seq_plan(n, h, sms)
        for save in (0, 1):
            source = gru.gru_seq_source_plan(n, h, save, sms)
            check(source == mirror, f"plan N={n} H={h} save={save}: source "
                  f"{source} vs mirror {mirror}")
        card = gru.gru_seq_source_plan(n, h, 0, 0)
        print(f"plan N={n} H={h}: {mirror[1]}; the card launches "
              f"{'the same' if card == mirror else card}", flush=True)


def wrapper_checks(case):
    _, n, h = case.shape
    for kind in ("gru_infer", "gru_fwd"):
        check(rnn_step.takes_persistent(kind, n, h, torch.device("cuda")),
              f"{kind} N={n} H={h} takes the step route")
    with torch.no_grad():
        got_i = gru.gru_seq_infer(case.xw, case.r, case.rb, case.h0)
        again_i = gru.gru_seq_infer(case.xw, case.r, case.rb, case.h0)
    got_f = gru.gru_seq_fwd(case.xw, case.r, case.rb, case.h0)
    again_f = gru.gru_seq_fwd(case.xw, case.r, case.rb, case.h0)
    torch.cuda.synchronize()
    want_i, want_f = case.plain("infer"), case.plain("fwd")
    finite = all(bool(torch.isfinite(a).all()) for a in (*got_i, *got_f))
    err_i = max(float((a - e).abs().max()) for a, e in zip(got_i, want_i))
    err_f = max(float((a - e).abs().max()) for a, e in zip(got_f, want_f))
    same = all(torch.equal(a, e) for a, e in
               zip((*again_i, *again_f), (*got_i, *got_f)))
    print(f"check T,N,H {case.shape}: infer max|d| {err_i:.3e}, fwd "
          f"{err_f:.3e}; bits repeat {same}", flush=True)
    check(finite, f"{case.shape}: not finite")
    check(max(err_i, err_f) <= cs.KERNEL_TOL,
          f"{case.shape}: outside KERNEL_TOL")
    check(same, f"{case.shape}: bits differ on a second run")


def copy_checks(case, label, ent, stream, gate):
    errs = []
    for kind in ("infer", "fwd"):
        rc = case.direct(ent, kind, stream)()
        torch.cuda.synchronize()
        if rc != 0:
            check(not gate, f"{label} {case.shape} {kind}: code {rc}")
            print(f"{label} {case.shape} {kind}: code {rc}", flush=True)
            return
        errs.append(max(float((a - e).abs().max()) for a, e in
                        zip(case.outputs(kind), case.plain(kind))))
    print(f"{label} check T,N,H {case.shape}: infer max|d| {errs[0]:.3e}, "
          f"fwd {errs[1]:.3e}", flush=True)
    if gate:
        check(max(errs) <= cs.KERNEL_TOL, f"{label} {case.shape}: outside "
              f"KERNEL_TOL")


def step_route(case, kind, stream):
    fn = build.load("rnn_step").rnn_step_fwd_gru_f32
    fn.argtypes = [P] * 8 + [I] * 4 + [P]
    fn.restype = I
    t, n, h = case.shape
    save = int(kind == "fwd")
    return lambda: fn(case.xw.data_ptr(), case.r.data_ptr(),
                      case.rb.data_ptr(), case.h0.data_ptr(),
                      case.hs.data_ptr(),
                      case.ru.data_ptr() if save else None,
                      case.rzc.data_ptr() if save else None,
                      case.cand.data_ptr() if save else None,
                      save, t, n, h, stream)


def timings(kind, case, sources, stream):
    t, n, h = case.shape
    order = (["old", "new", "new", "old"] if "old" in sources else
             ["new", "new"]) + [x for x in sources if x not in ("new",
                                                                "old")]
    got = {}
    for label in order:
        fn = case.direct(sources[label], kind, stream)
        rc = fn()
        torch.cuda.synchronize()
        if rc != 0:
            print(f"time {label} {kind} {case.shape}: code {rc}", flush=True)
            continue
        got.setdefault(label, []).append((single_ms(fn), b2b_ms(fn)))
    bound = (cs.gru_fwd_bound if kind == "fwd" else cs.gru_infer_bound)(
        t, n, h)
    step = step_route(case, kind, stream)
    check(step() == 0, f"step route {kind} {case.shape}")
    layer = torch.nn.GRU(cs.GRU_EMBED, h).cuda()
    with torch.inference_mode():
        lib = lambda: layer(case.x, case.h0[None])  # noqa: E731
        lib_ms = (single_ms(lib), b2b_ms(lib))
    print(f"time {kind} T,N,H {case.shape}: " + "; ".join(
        f"{label} single " + ", ".join(f"{s:.4f}" for s, _ in v) + " b2b " +
        ", ".join(f"{x:.4f}" for _, x in v) for label, v in got.items()) +
        f"; step route single {single_ms(step):.4f} b2b {b2b_ms(step):.4f}"
        f"; cuDNN GRU layer single {lib_ms[0]:.4f} b2b {lib_ms[1]:.4f}; "
        f"bound {bound[0]:.4f} ({bound[1]}) ms", flush=True)


def phase_split(label, kind, case, ent, stream, names=PHASES):
    """Block 0's mean time a step from each of the build's stamped points
    to the next (steps 1 .. T-2 of one call of a "phases" build; ``names``
    the phases), in SM cycles and in ns."""
    t = case.shape[0]
    if t < 4:
        return
    fn = ent["lib"].gru_seq_stamps
    fn.argtypes = [P]
    fn.restype = I
    case.direct(ent, kind, stream)()
    torch.cuda.synchronize()
    out = torch.zeros(2, 512, 8, dtype=torch.int64)
    check(fn(out.data_ptr()) == 0, f"{label}: stamps not read")
    # step s: stamp k+1 - stamp k, then the next step's first - the last
    k = len(names)
    d_cyc, d_ns = (torch.cat([a[1:-1, 1:k] - a[1:-1, :k - 1],
                              a[2:, :1] - a[1:-1, k - 1:k]], 1).mean(0)
                   for a in (out[0, :t].double(), out[1, :t].double()))
    print(f"phases {label} {kind} T,N,H {case.shape}: " + "; ".join(
        f"to {name} {c:.0f} cycles {n:.0f} ns" for name, c, n in
        zip(names, d_cyc.tolist(), d_ns.tolist())) +
        f"; a step {float(d_ns.sum()):.0f} ns", flush=True)


def sass_counts(label, lib, path=None):
    """Each kernel's count of instructions, FFMAs, shared-memory loads,
    barriers and fences in a built library's SASS (cuobjdump); with
    ``path``, the SASS is also written to that file."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                         capture_output=True, text=True).stdout
    counts, fn, sass = {}, None, []
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict(all=0, FFMA=0, LDS=0, IMAD=0, BAR=0, LDG=0,
                              MEMBAR=0, CCTL=0)
            sass.append(line)
        elif fn is not None and "/*" in line and ";" in line:
            sass.append(line)
            counts[fn]["all"] += 1
            for op in ("FFMA", "LDS", "IMAD", "BAR", "LDG", "MEMBAR",
                       "CCTL"):
                counts[fn][op] += f" {op}" in line
    for fn, c in counts.items():
        print(f"sass {label} {fn[-40:]}: {c}", flush=True)
    if path is not None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text("\n".join(sass))
        print(f"sass written to {path}", flush=True)


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    args = sys.argv[1:]
    text = (build.CSRC / "gru_seq.cu").read_text()
    copies = []
    if "--old" in args:
        old = Path(args[args.index("--old") + 1]).read_text()
        copies.append(start_copy("old", old))
        if "--old-phases" in args:
            copies.append(start_copy("old+phases", patched(
                old, OLD_PHASE_EDITS, "old+phases")))
    diags = (args[args.index("--diag") + 1].split(",") if "--diag" in args
             else [])
    for label in diags:   # "a+b": the edits of a and of b
        edits = [e for part in label.split("+") for e in DIAGNOSTICS[part]]
        copies.append(start_copy(label, patched(text, edits, label)))
    try:
        build.load_all(["gru_seq", "rnn_step"])
    finally:
        print_build("new", build.build_log("gru_seq"))
    sources = {"new": entries(build.load("gru_seq"))}
    if "--sass" in args:
        sass_counts("new", build.library_path("gru_seq"),
                    args[args.index("--sass") + 1])
    for started in copies:
        ent = finish_copy(started, "--sass" in args)
        if ent is not None:
            sources[started[0]] = ent
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"SMs {sms}", flush=True)
    cluster_capacity()
    plan_checks(sms)
    stream = torch.cuda.current_stream().cuda_stream
    for shape in CHECK_SHAPES:
        case = Case(*shape)
        wrapper_checks(case)
        if shape in CHECK_SHAPES[:6]:
            for label, ent in sources.items():
                if label != "new":
                    copy_checks(case, label, ent, stream, gate=all(
                        part in EXACT + ("old",)
                        for part in label.split("+")))
        del case
    if "--no-time" not in args:
        for kind, *shape in TIME_SHAPES:
            timings(kind, Case(*shape), sources, stream)
    for label, ent in sources.items():
        if "phases" in label.split("+"):
            for kind, *shape in TIME_SHAPES:
                phase_split(label, kind, Case(*shape), ent, stream,
                            OLD_PHASES if label == "old+phases" else PHASES)
    print(f"failures: {failures}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
