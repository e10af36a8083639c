"""Smoke run of the PyTorch/CUDA port (deeplearning4j_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one
nvcc per source, in parallel), holds each against its plain PyTorch version
at the shapes the training and serving paths give it (the GRU kernels also
against torch.nn.GRU on cuDNN, which is only timed and checked, never
called by the port), then drives two full-width models with random
weights from a numpy seed:

- the GravesLSTM char-RNN (TextGenerationLSTM: vocab 77, hidden 256,
  seqLength 100, batch 32, Adam(2e-3)): ``gradients`` and 5 ``fit`` steps
  on the card against the same on the CPU (the plain versions), one
  truncated-BPTT step likewise, the kernels' launch counts per step and
  the step time; then the trained net served through InferenceSession,
  its answers against ``net.output`` and the CPU plain forward;
- the GRU char-RNN of TensorFlow's text-generation tutorial (Embedding 66
  -> 256, GRU 1024 reset-after, softmax output 66, T=100, batch 64,
  Adam(1e-3)), with token ids as input: the same training checks, exactly
  one GRU forward and one backward launch per step; then a burst of token
  requests through InferenceSession and 20 tokens of ``rnnTimeStep``
  generation at N=1 against ``net.output``.

Each main path sets its kernels' launch counters to 0 just before it runs
and reads them just after.

Any failed check exits non-zero. Without a GPU it exits non-zero and prints
no result. It imports nothing of the JAX package.

Output: the card's name and power limit (as nvidia-smi gives them), the
build time, one line per kernel shape (max |error| and times), the
training and serving checks, then a ``{"kernels": [...]}`` JSON line and,
last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
# f32 tolerances. The kernel sums h.R in another order than cuBLAS does
# for the plain version, and 100 recurrent steps carry the difference.
KERNEL_TOL = 1e-4
SERVE_TOL = 1e-5     # served rows vs net.output of the same rows (GPU)
PLAIN_TOL = 1e-4     # served rows vs the CPU plain-version forward
# (T, N, H): the serving path's shapes (T=100, H=256, N over the batch
# ladder and a large batch), one step, and a ragged edge in N and H
KERNEL_SHAPES = [(100, 1, 256), (100, 8, 256), (100, 32, 256),
                 (100, 1024, 256), (1, 8, 256), (13, 3, 200)]
# the training kernels: the training batch (100, 32, 256) and the others
TRAIN_SHAPES = [(100, 32, 256), (100, 1, 256), (100, 1024, 256),
                (1, 8, 256), (13, 3, 200)]
REPORT_SHAPE = (100, 32, 256)   # the ladder's largest bucket, the batch
# Backward tolerance, relative to each output's largest element: another
# summation order over 4H in dz R^T (carried through T steps) and over T*N
# in dR, where the plain version sums per step with cuBLAS.
GRAD_TOL = 1e-4
# Training on the card vs the same on the CPU (plain versions), float32:
TRAIN_LOSS_TOL = 1e-4    # relative, per step
# Adam moves a weight by about lr per step (lr*m/sqrt(v), bias-corrected),
# so trained weights are compared against lr*steps, about the most they
# can have moved. Where |g| is small, m/sqrt(v) amplifies the rounding
# difference of the two summation orders, and an element whose gradient
# is at that noise can even take the other sign and land up to
# 2*lr*steps away. Such elements are those whose first moment m is below
# MOMENT_FLOOR of its tensor's largest. Every other weight must agree to
# PARAM_TOL of lr*steps, and m and v themselves to MOMENT_TOL of their
# tensor's largest element.
PARAM_TOL = 1e-2
MOMENT_FLOOR = 1e-3
MOMENT_TOL = 1e-4
STEPS = 5
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and the
# float32 rate outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event timings,
    after one warm-up call."""
    import torch

    fn()
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


def _bound(nbytes, flops):
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the float32 operations over the non-tensor float32 rate."""
    by_bytes, by_ops = nbytes / PEAK_BYTES, flops / PEAK_F32
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def lstm_bound(t, n, h):
    """Least time (ms) the card needs for the recurrence: each input read
    once (xw, R, h0, c0), each output written once (hs, hT, cT), against
    the 2*T*N*H*4H multiply-adds of h.R at the float32 non-tensor rate."""
    return _bound(4 * (t * n * 4 * h + h * 4 * h + 2 * n * h + t * n * h
                       + 2 * n * h), 2.0 * t * n * h * 4 * h)


def fwd_bound(t, n, h):
    """The training forward: reads xw, R, h0, c0 once, writes hs, gates
    and cs once; the same 2*T*N*H*4H multiply-adds."""
    return _bound(4 * (t * n * 4 * h + h * 4 * h + 2 * n * h + t * n * h
                       + t * n * 4 * h + t * n * h), 2.0 * t * n * h * 4 * h)


def bwd_bound(t, n, h):
    """The backward: reads dhs, dhT, dcT, gates, cs, hs, R, h0, c0 once,
    writes dxw, dR, dh0, dc0 once; 2*T*N*H*4H multiply-adds for dz R^T and
    as many for dR."""
    return _bound(4 * (t * n * h + 2 * n * h + t * n * 4 * h + 2 * t * n * h
                       + h * 4 * h + 2 * n * h + t * n * 4 * h + h * 4 * h
                       + 2 * n * h), 4.0 * t * n * h * 4 * h)


def kernel_phase(torch, lstm):
    """Kernel vs plain version at every shape; times of the kernel, the
    plain version and cuDNN's LSTM layer (the yardstick)."""
    rows, max_err = {}, 0.0
    for (t, n, h) in KERNEL_SHAPES:
        rng = np.random.default_rng([SEED, t, n, h])
        nin = h   # the second LSTM layer's input width
        x = rng.normal(size=(t, n, nin)).astype(np.float32)
        w = (rng.normal(size=(nin, 4 * h)) * 0.08).astype(np.float32)
        r = (rng.normal(size=(h, 4 * h)) * 0.08).astype(np.float32)
        b = (rng.normal(size=(4 * h,)) * 0.1).astype(np.float32)
        h0 = (rng.normal(size=(n, h)) * 0.2).astype(np.float32)
        c0 = (rng.normal(size=(n, h)) * 0.2).astype(np.float32)
        fb = 1.0
        dev = lambda a: torch.tensor(a, device="cuda")  # noqa: E731
        x_d, w_d, r_d, b_d, h0_d, c0_d = map(dev, (x, w, r, b, h0, c0))
        bias = b_d.clone()
        bias[h:2 * h] += fb
        xw = torch.matmul(x_d, w_d) + bias

        before = lstm.lstm_seq_infer.launches
        got = lstm.lstm_seq_infer(xw, r_d, h0_d, c0_d)
        torch.cuda.synchronize()
        if lstm.lstm_seq_infer.launches != before + 1:
            fail(f"launch counter did not rise at {(t, n, h)}")
        want = lstm.lstm_seq_infer_reference(xw, r_d, h0_d, c0_d)
        err = max(float((a - e).abs().max()) for a, e in zip(got, want))
        if not all(bool(torch.isfinite(a).all()) for a in got):
            fail(f"non-finite kernel output at {(t, n, h)}")
        if err > KERNEL_TOL:
            fail(f"kernel vs plain max|d|={err:.3e} > {KERNEL_TOL} at "
                 f"{(t, n, h)}")
        max_err = max(max_err, err)

        # cuDNN's LSTM layer on the same weights: W^T, R^T, the bias with
        # forgetBias on the f block, no recurrent bias; gate order i,f,g,o
        # is PyTorch's too
        cudnn = torch.nn.LSTM(nin, h).cuda()
        with torch.no_grad():
            cudnn.weight_ih_l0.copy_(w_d.t())
            cudnn.weight_hh_l0.copy_(r_d.t())
            cudnn.bias_ih_l0.copy_(bias)
            cudnn.bias_hh_l0.zero_()
        hc = (h0_d[None], c0_d[None])
        with torch.inference_mode():
            ref_hs, _ = cudnn(x_d, hc)
            cudnn_err = float((ref_hs - got[0]).abs().max())
            if cudnn_err > KERNEL_TOL:
                fail(f"kernel vs cuDNN max|d|={cudnn_err:.3e} at "
                     f"{(t, n, h)}: the weight mapping or the kernel is "
                     f"wrong")
            reps = 10 if n >= 1024 else 30
            launches = lstm.lstm_seq_infer.launches
            k_ms = time_ms(lambda: lstm.lstm_seq_infer(xw, r_d, h0_d, c0_d),
                           reps)
            layer_ms = time_ms(lambda: lstm.lstm_seq_infer(
                torch.matmul(x_d, w_d) + bias, r_d, h0_d, c0_d), reps)
            if lstm.lstm_seq_infer.launches != launches + 2 * (reps + 1):
                fail("launch counter out of step with the timed launches")
            p_ms = time_ms(lambda: lstm.lstm_seq_infer_reference(
                xw, r_d, h0_d, c0_d), max(3, reps // 3))
            lib_ms = time_ms(lambda: cudnn(x_d, hc), reps)
        bound_ms, bound_by = lstm_bound(t, n, h)
        rows[(t, n, h)] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                               bound_ms=bound_ms, bound_by=bound_by)
        print(f"lstm_seq_infer T={t} N={n} H={h}: max|d| {err:.3e} "
              f"(vs cuDNN {cudnn_err:.3e}); kernel {k_ms:.4f} ms, "
              f"projection+kernel {layer_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"cuDNN LSTM layer {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by})", flush=True)
    return rows, max_err


def _rel_err(got, want):
    """max |got - want| over max |want|."""
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def train_kernel_phase(torch, lstm):
    """lstm_seq_fwd and lstm_seq_bwd vs their plain versions at every
    training shape; times of each kernel, its plain version and cuDNN's
    LSTM layer in training (its forward with grad; autograd's backward of
    it, which also forms the input-projection gradients)."""
    rows = {"lstm_seq_fwd": {}, "lstm_seq_bwd": {}}
    errs = {"lstm_seq_fwd": 0.0, "lstm_seq_bwd": 0.0}   # max |d|, absolute
    for (t, n, h) in TRAIN_SHAPES:
        rng = np.random.default_rng([SEED, 1, t, n, h])

        def dev(*shape, scale=1.0):
            return torch.tensor((rng.normal(size=shape) * scale).astype(
                np.float32), device="cuda")

        x, w, r = dev(t, n, h), dev(h, 4 * h, scale=0.08), \
            dev(h, 4 * h, scale=0.08)
        b, h0, c0 = dev(4 * h, scale=0.1), dev(n, h, scale=0.2), \
            dev(n, h, scale=0.2)
        dhs, dhT, dcT = dev(t, n, h), dev(n, h), dev(n, h)
        bias = b.clone()
        bias[h:2 * h] += 1.0
        xw = torch.matmul(x, w) + bias

        fwd, bwd = lstm.lstm_seq_fwd, lstm.lstm_seq_bwd
        before = (fwd.launches, bwd.launches)
        hs, gates, cs = fwd(xw, r, h0, c0)
        grads = bwd(dhs, dhT, dcT, gates, cs, hs, r, h0, c0)
        torch.cuda.synchronize()
        if (fwd.launches, bwd.launches) != (before[0] + 1, before[1] + 1):
            fail(f"training kernels' launch counters did not rise at "
                 f"{(t, n, h)}")
        want_f = lstm.lstm_seq_fwd_reference(xw, r, h0, c0)
        want_b = lstm.lstm_seq_bwd_reference(dhs, dhT, dcT, gates, cs, hs,
                                             r, h0, c0)
        if not all(bool(torch.isfinite(a).all())
                   for a in (hs, gates, cs, *grads)):
            fail(f"non-finite training kernel output at {(t, n, h)}")
        err_f = max(float((a - e).abs().max())
                    for a, e in zip((hs, gates, cs), want_f))
        err_b = max(_rel_err(a, e) for a, e in zip(grads, want_b))
        abs_b = max(float((a - e).abs().max()) for a, e in zip(grads, want_b))
        if err_f > KERNEL_TOL:
            fail(f"lstm_seq_fwd vs plain max|d|={err_f:.3e} > {KERNEL_TOL} "
                 f"at {(t, n, h)}")
        if err_b > GRAD_TOL:
            fail(f"lstm_seq_bwd vs plain max|d|/max={err_b:.3e} > "
                 f"{GRAD_TOL} at {(t, n, h)}")
        again = bwd(dhs, dhT, dcT, gates, cs, hs, r, h0, c0)
        if not all(torch.equal(a, e) for a, e in zip(again, grads)):
            fail(f"lstm_seq_bwd gave other bits on a second run at "
                 f"{(t, n, h)}: its sums must run in a fixed order")
        errs["lstm_seq_fwd"] = max(errs["lstm_seq_fwd"], err_f)
        errs["lstm_seq_bwd"] = max(errs["lstm_seq_bwd"], abs_b)

        cudnn = torch.nn.LSTM(h, h).cuda()
        with torch.no_grad():
            cudnn.weight_ih_l0.copy_(w.t())
            cudnn.weight_hh_l0.copy_(r.t())
            cudnn.bias_ih_l0.copy_(bias)
            cudnn.bias_hh_l0.zero_()
        x_g, h0_g, c0_g = (a.clone().requires_grad_() for a in (x, h0, c0))
        wrt = [x_g, h0_g, c0_g, *cudnn.parameters()]

        def lib_fwd():
            return cudnn(x_g, (h0_g[None], c0_g[None]))

        ref_hs, (ref_hT, ref_cT) = lib_fwd()
        cudnn_err = float((ref_hs.detach() - hs).abs().max())
        if cudnn_err > KERNEL_TOL:
            fail(f"lstm_seq_fwd vs cuDNN max|d|={cudnn_err:.3e} at "
                 f"{(t, n, h)}")
        outs, cts = (ref_hs, ref_hT, ref_cT), (dhs, dhT[None], dcT[None])
        reps = 10 if n >= 1024 else 30
        launches = (fwd.launches, bwd.launches)   # after the rerun above
        f_ms = time_ms(lambda: fwd(xw, r, h0, c0), reps)
        b_ms = time_ms(lambda: bwd(dhs, dhT, dcT, gates, cs, hs, r, h0, c0),
                       reps)
        if (fwd.launches, bwd.launches) != (launches[0] + reps + 1,
                                            launches[1] + reps + 1):
            fail("training kernels' launch counters out of step with the "
                 "timed launches")
        plain_reps = max(3, reps // 3)
        pf_ms = time_ms(lambda: lstm.lstm_seq_fwd_reference(xw, r, h0, c0),
                        plain_reps)
        pb_ms = time_ms(lambda: lstm.lstm_seq_bwd_reference(
            dhs, dhT, dcT, gates, cs, hs, r, h0, c0), plain_reps)
        lf_ms = time_ms(lib_fwd, reps)
        lb_ms = time_ms(lambda: torch.autograd.grad(outs, wrt, cts,
                                                    retain_graph=True), reps)
        for name, ms, p_ms, l_ms, bound in (
                ("lstm_seq_fwd", f_ms, pf_ms, lf_ms, fwd_bound(t, n, h)),
                ("lstm_seq_bwd", b_ms, pb_ms, lb_ms, bwd_bound(t, n, h))):
            rows[name][(t, n, h)] = dict(ms=ms, plain_ms=p_ms,
                                         library_ms=l_ms, bound_ms=bound[0],
                                         bound_by=bound[1])
            err = (f"{err_f:.3e}" if name == "lstm_seq_fwd" else
                   f"{abs_b:.3e} ({err_b:.3e} of the largest)")
            print(f"{name} T={t} N={n} H={h}: max|d| {err}; "
                  f"kernel {ms:.4f} ms, plain {p_ms:.4f} ms, cuDNN LSTM "
                  f"layer {'backward' if name == 'lstm_seq_bwd' else 'training forward'} "
                  f"{l_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})",
                  flush=True)
    return rows, errs


# ---------------------------------------------------------------------------
# the GRU (reset-after) kernels and the GRU char-RNN
# ---------------------------------------------------------------------------

# (T, N, H): the GRU char-RNN's training batch (100, 64, 1024), the serving
# ladder's ends (N=1 and 32), one generation step, a ragged edge, and an H
# that is no multiple of 4 (the kernels' scalar, non-float4 paths)
GRU_SHAPES = [(100, 64, 1024), (100, 1, 1024), (100, 32, 1024),
              (1, 1, 1024), (13, 3, 200), (7, 5, 37)]
GRU_TRAIN_SHAPE = (100, 64, 1024)
GRU_SERVE_SHAPE = (100, 32, 1024)   # the serving ladder's largest bucket
GRU_EMBED = 256                     # the GRU layer's input width


def gru_infer_bound(t, n, h):
    """Reads xw, R, rb, h0 once, writes hs, hT once; 2*T*N*H*3H
    multiply-adds of h.R at the float32 non-tensor rate."""
    return _bound(4 * (t * n * 3 * h + h * 3 * h + 3 * h + n * h + t * n * h
                       + n * h), 2.0 * t * n * h * 3 * h)


def gru_fwd_bound(t, n, h):
    """The training forward: reads xw, R, rb, h0 once, writes hs, ru
    [T,N,2H], rz_c and cand once; the same multiply-adds."""
    return _bound(4 * (t * n * 3 * h + h * 3 * h + 3 * h + n * h
                       + 5 * t * n * h), 2.0 * t * n * h * 3 * h)


def gru_bwd_bound(t, n, h):
    """The backward: reads dhs, dhT, ru, rz_c, cand, hs, R, h0 once,
    writes dxw, dR, drb, dh0 once; 2*T*N*H*3H multiply-adds for drz R^T and
    as many for dR."""
    return _bound(4 * (6 * t * n * h + 2 * n * h + 2 * h * 3 * h
                       + 3 * t * n * h + 3 * h + n * h),
                  4.0 * t * n * h * 3 * h)


def dr_pass_ms(torch, hs, h0, reps):
    """CUDA-event median of gru_seq_bwd's second pass alone (dR and drb
    from a drz scratch), through its own entry point, so that the sweep
    and the reduction are timed apart. Values do not change its time."""
    import ctypes

    from deeplearning4j_tpu_torch.kernels import build

    t, n, h = hs.shape
    fn = build.load("gru_seq_bwd").gru_seq_bwd_dr_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    drz = torch.ones((t, n, 3 * h), device="cuda")
    dr = torch.empty((h, 3 * h), device="cuda")
    drb = torch.empty((3 * h,), device="cuda")

    def run():
        rc = fn(hs.data_ptr(), h0.data_ptr(), drz.data_ptr(), dr.data_ptr(),
                drb.data_ptr(), t, n, h,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            fail(f"gru_seq_bwd_dr_f32 returned {rc}")

    return time_ms(run, reps)


def gru_kernel_phase(torch, gru):
    """The three GRU kernels vs their plain versions at every GRU shape;
    the backward's determinism; times of each kernel, its plain version
    and torch.nn.GRU on cuDNN (the yardstick: the same reset-after
    recurrence, gate order r, z, n, weight_hh = R^T; never called by the
    port)."""
    names = ("gru_seq_infer", "gru_seq_fwd", "gru_seq_bwd")
    rows = {name: {} for name in names}
    errs = dict.fromkeys(names, 0.0)   # max |d|, absolute
    for (t, n, h) in GRU_SHAPES:
        rng = np.random.default_rng([SEED, 2, t, n, h])

        def dev(*shape, scale=1.0):
            return torch.tensor((rng.normal(size=shape) * scale).astype(
                np.float32), device="cuda")

        x = dev(t, n, GRU_EMBED)
        w = dev(GRU_EMBED, 3 * h, scale=GRU_EMBED ** -0.5)
        r = dev(h, 3 * h, scale=h ** -0.5)
        b, rb = dev(3 * h, scale=0.1), dev(3 * h, scale=0.1)
        h0 = dev(n, h, scale=0.2)
        dhs, dhT = dev(t, n, h), dev(n, h)
        xw = torch.matmul(x, w) + b
        fns = [getattr(gru, name) for name in names]

        before = [fn.launches for fn in fns]
        got_i = gru.gru_seq_infer(xw, r, rb, h0)
        got_f = gru.gru_seq_fwd(xw, r, rb, h0)
        hs, ru, rzc, cand = got_f
        got_b = gru.gru_seq_bwd(dhs, dhT, ru, rzc, cand, hs, r, h0)
        torch.cuda.synchronize()
        if [fn.launches for fn in fns] != [k + 1 for k in before]:
            fail(f"GRU launch counters did not rise at {(t, n, h)}")
        want_i = gru.gru_seq_infer_reference(xw, r, rb, h0)
        want_f = gru.gru_seq_fwd_reference(xw, r, rb, h0)
        want_b = gru.gru_seq_bwd_reference(dhs, dhT, ru, rzc, cand, hs, r,
                                           h0)
        if not all(bool(torch.isfinite(a).all())
                   for a in (*got_i, *got_f, *got_b)):
            fail(f"non-finite GRU kernel output at {(t, n, h)}")
        err_i = max(float((a - e).abs().max()) for a, e in zip(got_i, want_i))
        err_f = max(float((a - e).abs().max()) for a, e in zip(got_f, want_f))
        rel_b = max(_rel_err(a, e) for a, e in zip(got_b, want_b))
        err_b = max(float((a - e).abs().max()) for a, e in zip(got_b, want_b))
        for name, err in (("gru_seq_infer", err_i), ("gru_seq_fwd", err_f)):
            if err > KERNEL_TOL:
                fail(f"{name} vs plain max|d|={err:.3e} > {KERNEL_TOL} at "
                     f"{(t, n, h)}")
        if rel_b > GRAD_TOL:
            fail(f"gru_seq_bwd vs plain max|d|/max={rel_b:.3e} > {GRAD_TOL}"
                 f" at {(t, n, h)}")
        again = gru.gru_seq_bwd(dhs, dhT, ru, rzc, cand, hs, r, h0)
        if not all(torch.equal(a, e) for a, e in zip(again, got_b)):
            fail(f"gru_seq_bwd gave other bits on a second run at "
                 f"{(t, n, h)}: its sums must run in a fixed order")
        for name, err in zip(names, (err_i, err_f, err_b)):
            errs[name] = max(errs[name], err)

        cudnn = torch.nn.GRU(GRU_EMBED, h).cuda()
        with torch.no_grad():
            cudnn.weight_ih_l0.copy_(w.t())
            cudnn.weight_hh_l0.copy_(r.t())
            cudnn.bias_ih_l0.copy_(b)
            cudnn.bias_hh_l0.copy_(rb)
        with torch.inference_mode():
            ref_hs, _ = cudnn(x, h0[None])
        cudnn_err = float((ref_hs - got_i[0]).abs().max())
        if cudnn_err > KERNEL_TOL:
            fail(f"GRU kernel vs cuDNN max|d|={cudnn_err:.3e} at "
                 f"{(t, n, h)}: the weight mapping or the kernel is wrong")
        x_g, h0_g = (a.clone().requires_grad_() for a in (x, h0))
        wrt = [x_g, h0_g, *cudnn.parameters()]

        def lib_fwd():
            return cudnn(x_g, h0_g[None])

        outs = lib_fwd()
        cts = (dhs, dhT[None])
        reps = 10 if t * n * h >= 100 * 32 * 1024 else 20
        plain_reps = 3
        launches = [fn.launches for fn in fns]
        with torch.inference_mode():
            i_ms = time_ms(lambda: gru.gru_seq_infer(xw, r, rb, h0), reps)
            pi_ms = time_ms(lambda: gru.gru_seq_infer_reference(
                xw, r, rb, h0), plain_reps)
            li_ms = time_ms(lambda: cudnn(x, h0[None]), reps)
        f_ms = time_ms(lambda: gru.gru_seq_fwd(xw, r, rb, h0), reps)
        b_ms = time_ms(lambda: gru.gru_seq_bwd(dhs, dhT, ru, rzc, cand, hs,
                                               r, h0), reps)
        if [fn.launches for fn in fns] != [k + reps + 1 for k in launches]:
            fail("GRU launch counters out of step with the timed launches")
        pf_ms = time_ms(lambda: gru.gru_seq_fwd_reference(xw, r, rb, h0),
                        plain_reps)
        pb_ms = time_ms(lambda: gru.gru_seq_bwd_reference(
            dhs, dhT, ru, rzc, cand, hs, r, h0), plain_reps)
        lf_ms = time_ms(lib_fwd, reps)
        lb_ms = time_ms(lambda: torch.autograd.grad(outs, wrt, cts,
                                                    retain_graph=True), reps)
        del outs
        dr_ms = dr_pass_ms(torch, hs, h0, reps)
        print(f"gru_seq_bwd T={t} N={n} H={h}: its dR, drb pass alone "
              f"{dr_ms:.4f} ms, so the sweep {b_ms - dr_ms:.4f} ms",
              flush=True)
        for name, ms, p_ms, l_ms, bound, err, lib in (
                ("gru_seq_infer", i_ms, pi_ms, li_ms,
                 gru_infer_bound(t, n, h), f"{err_i:.3e}", "layer"),
                ("gru_seq_fwd", f_ms, pf_ms, lf_ms, gru_fwd_bound(t, n, h),
                 f"{err_f:.3e}", "training forward"),
                ("gru_seq_bwd", b_ms, pb_ms, lb_ms, gru_bwd_bound(t, n, h),
                 f"{err_b:.3e} ({rel_b:.3e} of the largest)",
                 "autograd backward")):
            rows[name][(t, n, h)] = dict(ms=ms, plain_ms=p_ms,
                                         library_ms=l_ms, bound_ms=bound[0],
                                         bound_by=bound[1])
            print(f"{name} T={t} N={n} H={h}: max|d| {err}"
                  f"{f' (vs cuDNN {cudnn_err:.3e})' if lib == 'layer' else ''}"
                  f"; kernel {ms:.4f} ms, plain {p_ms:.4f} ms, cuDNN GRU "
                  f"{lib} {l_ms:.4f} ms, bound {bound[0]:.4f} ms "
                  f"({bound[1]})", flush=True)
    return rows, errs


def next_char_batch(rng, n, vocab, t):
    """n one-hot sequences [n, vocab, t] and their next-character labels."""
    idx = rng.integers(0, vocab, size=(n, t + 1))
    eye = np.eye(vocab, dtype=np.float32)
    return (eye[idx[:, :-1]].transpose(0, 2, 1).copy(),
            eye[idx[:, 1:]].transpose(0, 2, 1).copy())


def _net_pair(conf_json, arrays):
    """The same network on the card (the default device) and on the CPU."""
    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils.convert import params_from_numpy

    conf = MultiLayerConfiguration.from_json(conf_json)
    gpu = MultiLayerNetwork(conf).init(params_from_numpy(conf, arrays,
                                                         "cuda"))
    if gpu.device.type != "cuda":
        fail(f"the network defaulted to {gpu.device}, not cuda")
    conf = MultiLayerConfiguration.from_json(conf_json)
    cpu = MultiLayerNetwork(conf, device="cpu").init(
        params_from_numpy(conf, arrays, "cpu"))
    return gpu, cpu


def _compare_trained(gpu, cpu, what, lr, steps):
    """Params and Adam moments of two nets trained alike (see PARAM_TOL)."""
    worst_p = worst_m = worst_tiny = 0.0
    n_tiny_off = 0
    for i, (pg, pc) in enumerate(zip(gpu._params, cpu._params)):
        for k in pc:
            mg, mc = (net._opt_states[i]["m"][k].cpu() for net in (gpu, cpu))
            vg, vc = (net._opt_states[i]["v"][k].cpu() for net in (gpu, cpu))
            worst_m = max(worst_m, _rel_err(mg, mc), _rel_err(vg, vc))
            tiny = mc.abs() < MOMENT_FLOOR * mc.abs().max()
            d = (pg[k].cpu() - pc[k]).abs()
            if (~tiny).any():
                worst_p = max(worst_p, float(d[~tiny].max()))
            if tiny.any():
                worst_tiny = max(worst_tiny, float(d[tiny].max()))
                n_tiny_off += int((d[tiny] > PARAM_TOL * lr * steps).sum())
    print(f"train: {what}: card vs CPU params max|d| {worst_p:.3e} = "
          f"{worst_p / (lr * steps):.3e} of lr*steps (moments above the "
          f"floor), Adam m/v max|d|/max {worst_m:.3e}; {n_tiny_off} weights "
          f"with tiny moments beyond that, max|d| {worst_tiny:.3e}",
          flush=True)
    if worst_p > PARAM_TOL * lr * steps:
        fail(f"{what}: params differ by {worst_p:.3e} > "
             f"{PARAM_TOL} * lr * steps")
    if worst_m > MOMENT_TOL:
        fail(f"{what}: Adam moments differ by {worst_m:.3e} > {MOMENT_TOL}")
    if worst_tiny > 2 * lr * steps * (1 + 1e-3):
        fail(f"{what}: a weight moved {worst_tiny:.3e}, more than Adam's "
             f"2*lr*steps")


def training_phase(torch, lstm):
    """Train TextGenerationLSTM at full width on the card and on the CPU
    from the same weights and batch; returns (the trained card net, the
    kernels' launches in the 5 fit steps, the median step ms)."""
    from deeplearning4j_tpu_torch.models.zoo import TextGenerationLSTM

    vocab, hidden, seq, batch = 77, 256, 100, 32
    conf = TextGenerationLSTM(vocabSize=vocab, hidden=hidden,
                              seqLength=seq).conf()
    lr = conf.defaults["updater"].learningRate
    rng = np.random.default_rng(SEED + 1)
    arrays = [{k: (rng.normal(size=s) * 0.08).astype(np.float32)
               for k, s in lr_.param_shapes().items()} for lr_ in conf.layers]
    f, l = next_char_batch(rng, batch, vocab, seq)
    gpu, cpu = _net_pair(conf.to_json(), arrays)

    # (a) gradients, relative to each layer's largest
    g_gpu, g_cpu = gpu.gradients(f, l), cpu.gradients(f, l)
    worst_g = max(_rel_err(torch.cat([gg[k].cpu().reshape(-1) for k in gc]),
                           torch.cat([gc[k].reshape(-1) for k in gc]))
                  for gg, gc in zip(g_gpu, g_cpu) if gc)
    print(f"train: gradients card vs CPU max|d|/max per layer "
          f"{worst_g:.3e}", flush=True)
    if worst_g > GRAD_TOL:
        fail(f"gradients differ by {worst_g:.3e} > {GRAD_TOL} relative")

    # (b)-(d) STEPS fit steps on both; the counters read the card's run
    kernels = (lstm.lstm_seq_infer, lstm.lstm_seq_fwd, lstm.lstm_seq_bwd)
    for fn in kernels:
        fn.launches = 0
    losses_gpu = []
    for _ in range(STEPS):
        gpu.fit(f, l)
        losses_gpu.append(gpu.score())
    launches = {fn.__name__: fn.launches for fn in kernels}
    losses_cpu = []
    for _ in range(STEPS):
        cpu.fit(f, l)
        losses_cpu.append(cpu.score())
    print(f"train: {STEPS} Adam steps, losses card {losses_gpu}, CPU "
          f"{losses_cpu}; launches {launches}", flush=True)
    worst_loss = max(abs(a - b) / abs(b) for a, b in zip(losses_gpu,
                                                         losses_cpu))
    if worst_loss > TRAIN_LOSS_TOL:
        fail(f"losses differ by {worst_loss:.3e} relative")
    if not losses_gpu[-1] < losses_gpu[0]:
        fail(f"the loss did not fall: {losses_gpu}")
    if launches != {"lstm_seq_infer": 0, "lstm_seq_fwd": 2 * STEPS,
                    "lstm_seq_bwd": 2 * STEPS}:
        fail(f"launches in {STEPS} fit steps of a 2-LSTM net: {launches}")
    _compare_trained(gpu, cpu, f"{STEPS} fit steps", lr, STEPS)

    # (e) one truncated-BPTT fit: segments of 50 on T=100
    d = json.loads(conf.to_json())
    d["backpropType"], d["tbpttLength"] = "TruncatedBPTT", 50
    t_gpu, t_cpu = _net_pair(json.dumps(d), arrays)
    before = {fn.__name__: fn.launches for fn in kernels}
    t_gpu.fit(f, l)
    t_cpu.fit(f, l)
    t_launches = {fn.__name__: fn.launches - before[fn.__name__]
                  for fn in kernels}
    rel = abs(t_gpu.score() - t_cpu.score()) / abs(t_cpu.score())
    print(f"train: TBPTT(50) fit, 2 segments: loss card {t_gpu.score()} "
          f"CPU {t_cpu.score()}; launches {t_launches}", flush=True)
    if t_gpu.getIterationCount() != 2 or rel > TRAIN_LOSS_TOL:
        fail(f"TBPTT: {t_gpu.getIterationCount()} iterations, loss "
             f"differs by {rel:.3e}")
    if t_launches != {"lstm_seq_infer": 0, "lstm_seq_fwd": 4,
                      "lstm_seq_bwd": 4}:
        fail(f"TBPTT launches {t_launches}")
    _compare_trained(t_gpu, t_cpu, "TBPTT step", lr, 2)

    # (f) the step time on the host clock, after a warm-up
    times = []
    for k in range(12):
        t0 = time.perf_counter()
        gpu.fit(f, l)
        torch.cuda.synchronize()
        if k >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)
    print(f"train: step time at N={batch} T={seq} H={hidden} vocab={vocab}:"
          f" median {step_ms:.3f} ms over {len(times)} steps (min "
          f"{min(times):.3f}, max {max(times):.3f})", flush=True)
    return gpu, launches, step_ms


def one_hot_batch(rng, n, vocab, t):
    idx = rng.integers(0, vocab, size=(n, t))
    return np.eye(vocab, dtype=np.float32)[idx].transpose(0, 2, 1).copy()


def slice_phase(torch, lstm, net):
    """Serve the trained TextGenerationLSTM at full width through
    InferenceSession."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import (
        DEFAULT_BATCH_BUCKETS, BucketLadder, InferenceSession)

    vocab, seq = net.layers[-1].nOut, 100
    plain = MultiLayerNetwork(net.conf, device="cpu").init(
        [{k: v.detach().cpu().clone() for k, v in p.items()}
         for p in net._params])
    rng = np.random.default_rng(SEED)

    requests = [one_hot_batch(rng, int(rng.integers(1, 5)), vocab, seq)
                for _ in range(16)]
    requests += [one_hot_batch(rng, 32, vocab, seq),
                 one_hot_batch(rng, 1, vocab, 37)]   # 37 pads to 50

    lstm.lstm_seq_infer.launches = 0
    t0 = time.perf_counter()
    session = InferenceSession()
    entry = session.register(
        "charrnn", net, example_shape=(vocab, seq), warmup=True,
        ladder=BucketLadder(DEFAULT_BATCH_BUCKETS, seq_lengths=(50, seq)))
    warm_s = time.perf_counter() - t0
    dispatches = []
    infer = entry.servable.infer

    def counting_infer(x):
        dispatches.append(x.shape)
        return infer(x)

    entry.servable.infer = counting_infer
    t1 = time.perf_counter()
    futures = [session.predict_async("charrnn", x) for x in requests]
    answers = [f.result(timeout=300) for f in futures]
    serve_s = time.perf_counter() - t1
    session.close()
    launches = lstm.lstm_seq_infer.launches
    n_warm = len(entry.servable.warmed_shapes)
    print(f"slice: warmup of {n_warm} ladder shapes {warm_s:.3f} s; "
          f"{len(requests)} requests ({sum(len(x) for x in requests)} rows) "
          f"in {len(dispatches)} dispatches {sorted(set(dispatches))}, "
          f"{serve_s:.4f} s; kernel launches {launches}", flush=True)
    if launches < 2 * (n_warm + len(dispatches)) or not dispatches:
        fail(f"{launches} kernel launches for {n_warm} warmup and "
             f"{len(dispatches)} serving dispatches of a 2-LSTM net")

    worst_gpu = worst_plain = 0.0
    for x, y in zip(requests, answers):
        if y.shape != x.shape[:1] + (vocab,) + x.shape[2:]:
            fail(f"answer shape {y.shape} for request {x.shape}")
        if not np.isfinite(y).all():
            fail("non-finite answer")
        sums = y.sum(axis=1)
        if np.abs(sums - 1.0).max() > 1e-5:
            fail(f"softmax rows sum to {sums.min()}..{sums.max()}")
        direct = net.output(x).cpu().numpy()
        ref = plain.output(x).numpy()
        worst_gpu = max(worst_gpu, float(np.abs(y - direct).max()))
        worst_plain = max(worst_plain, float(np.abs(y - ref).max()))
    print(f"slice: served vs net.output max|d| {worst_gpu:.3e}, served vs "
          f"plain CPU forward max|d| {worst_plain:.3e}", flush=True)
    if worst_gpu > SERVE_TOL:
        fail(f"served vs net.output {worst_gpu:.3e} > {SERVE_TOL}")
    if worst_plain > PLAIN_TOL:
        fail(f"served vs plain forward {worst_plain:.3e} > {PLAIN_TOL}")

    x = requests[0]
    full = net.output(x).cpu().numpy()
    net.rnnClearPreviousState()
    steps = np.stack([net.rnnTimeStep(x[:, :, k]).cpu().numpy()
                      for k in range(5)], axis=-1)
    step_err = float(np.abs(steps - full[:, :, :5]).max())
    print(f"slice: rnnTimeStep x5 vs output max|d| {step_err:.3e}",
          flush=True)
    if step_err > SERVE_TOL:
        fail(f"rnnTimeStep vs output {step_err:.3e} > {SERVE_TOL}")
    return launches


def gru_char_rnn_conf(vocab=66, embed=256, hidden=1024, seq=100):
    """The GRU char-RNN of TensorFlow's "Text generation with an RNN"
    tutorial in the port's DSL: Embedding(66, 256), GRU(1024) with Keras'
    defaults (reset_after=True, tanh/sigmoid), Dense(66) logits with
    sparse softmax cross-entropy (here RnnOutputLayer softmax/mcxent on
    one-hot labels, its stable equivalent), Adam(1e-3), sequences of 100."""
    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        GRU, EmbeddingSequenceLayer, RnnOutputLayer)
    from deeplearning4j_tpu_torch.optimize.updaters import Adam

    return (NeuralNetConfiguration.Builder().seed(SEED).updater(Adam(1e-3))
            .list()
            .layer(EmbeddingSequenceLayer.Builder().nIn(vocab).nOut(embed)
                   .build())
            .layer(GRU.Builder().nOut(hidden).resetAfter(True).build())
            .layer(RnnOutputLayer.Builder().nOut(vocab).activation("softmax")
                   .lossFunction("mcxent").build())
            .setInputType(InputType.recurrent(vocab, seq)).build())


def token_batch(rng, n, vocab, t):
    """n token-id sequences [n, 1, t] (int64) and their next-token one-hot
    labels [n, vocab, t]."""
    idx = rng.integers(0, vocab, size=(n, t + 1))
    labels = np.eye(vocab, dtype=np.float32)[idx[:, 1:]].transpose(0, 2, 1)
    return idx[:, None, :-1].copy(), labels.copy()


def gru_training_phase(torch, gru):
    """Train the GRU char-RNN at full width (66/256/1024, T=100, N=64,
    Adam(1e-3)) on the card and on the CPU from the same weights and
    batch; returns (the trained card net, the kernels' launches in the
    5 fit steps, the median step ms)."""
    vocab, seq, batch = 66, 100, 64
    conf = gru_char_rnn_conf(vocab=vocab, seq=seq)
    lr = conf.defaults["updater"].learningRate
    rng = np.random.default_rng(SEED + 2)
    arrays = [{k: (rng.normal(size=sh) * (sh[0] ** -0.5 if len(sh) == 2
                                          else 0.05)).astype(np.float32)
               for k, sh in lr_.param_shapes().items()}
              for lr_ in conf.layers]
    f, l = token_batch(rng, batch, vocab, seq)
    gpu, cpu = _net_pair(conf.to_json(), arrays)

    g_gpu, g_cpu = gpu.gradients(f, l), cpu.gradients(f, l)
    worst_g = max(_rel_err(torch.cat([gg[k].cpu().reshape(-1) for k in gc]),
                           torch.cat([gc[k].reshape(-1) for k in gc]))
                  for gg, gc in zip(g_gpu, g_cpu) if gc)
    print(f"gru train: gradients card vs CPU max|d|/max per layer "
          f"{worst_g:.3e}", flush=True)
    if worst_g > GRAD_TOL:
        fail(f"GRU gradients differ by {worst_g:.3e} > {GRAD_TOL} relative")

    kernels = (gru.gru_seq_infer, gru.gru_seq_fwd, gru.gru_seq_bwd)
    for fn in kernels:
        fn.launches = 0
    losses_gpu, per_step = [], []
    for _ in range(STEPS):
        before = [fn.launches for fn in kernels]
        gpu.fit(f, l)
        losses_gpu.append(gpu.score())
        per_step.append(tuple(fn.launches - k
                              for fn, k in zip(kernels, before)))
    launches = {fn.__name__: fn.launches for fn in kernels}
    losses_cpu = []
    for _ in range(STEPS):
        cpu.fit(f, l)
        losses_cpu.append(cpu.score())
    print(f"gru train: {STEPS} Adam steps, losses card {losses_gpu}, CPU "
          f"{losses_cpu}; launches {launches}", flush=True)
    worst_loss = max(abs(a - b) / abs(b) for a, b in zip(losses_gpu,
                                                         losses_cpu))
    if worst_loss > TRAIN_LOSS_TOL:
        fail(f"GRU losses differ by {worst_loss:.3e} relative")
    if not losses_gpu[-1] < losses_gpu[0]:
        fail(f"the GRU loss did not fall: {losses_gpu}")
    if per_step != [(0, 1, 1)] * STEPS:
        fail(f"GRU launches per fit step (infer, fwd, bwd): {per_step}")
    _compare_trained(gpu, cpu, f"GRU {STEPS} fit steps", lr, STEPS)

    times = []
    for k in range(7):
        t0 = time.perf_counter()
        gpu.fit(f, l)
        torch.cuda.synchronize()
        if k >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)
    print(f"gru train: step time at N={batch} T={seq} "
          f"H={gpu.layers[1].nOut} vocab={vocab}:"
          f" median {step_ms:.3f} ms over {len(times)} steps (min "
          f"{min(times):.3f}, max {max(times):.3f})", flush=True)
    return gpu, launches, step_ms


def gru_slice_phase(torch, gru, net):
    """Serve the trained GRU char-RNN through InferenceSession (token ids
    [N, 1, T] as float32) and generate with rnnTimeStep at N=1; returns the
    gru_seq_infer launches of the two (not of the net.output calls that
    check them)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import (
        DEFAULT_BATCH_BUCKETS, BucketLadder, InferenceSession)

    vocab, seq = net.layers[-1].nOut, 100
    plain = MultiLayerNetwork(net.conf, device="cpu").init(
        [{k: v.detach().cpu().clone() for k, v in p.items()}
         for p in net._params])
    rng = np.random.default_rng(SEED + 3)

    def ids(n, t):
        return rng.integers(0, vocab, size=(n, 1, t)).astype(np.float32)

    requests = [ids(int(rng.integers(1, 5)), seq) for _ in range(12)]
    requests += [ids(32, seq), ids(1, 37)]   # 37 pads to 50

    gru.gru_seq_infer.launches = 0
    t0 = time.perf_counter()
    session = InferenceSession()
    entry = session.register(
        "gru-charrnn", net, example_shape=(1, seq), warmup=True,
        ladder=BucketLadder(DEFAULT_BATCH_BUCKETS, seq_lengths=(50, seq)))
    warm_s = time.perf_counter() - t0
    dispatches = []
    infer = entry.servable.infer

    def counting_infer(x):
        dispatches.append(x.shape)
        return infer(x)

    entry.servable.infer = counting_infer
    t1 = time.perf_counter()
    futures = [session.predict_async("gru-charrnn", x) for x in requests]
    answers = [fu.result(timeout=300) for fu in futures]
    serve_s = time.perf_counter() - t1
    session.close()
    n_warm = len(entry.servable.warmed_shapes)
    served = gru.gru_seq_infer.launches
    print(f"gru slice: warmup of {n_warm} ladder shapes {warm_s:.3f} s; "
          f"{len(requests)} requests ({sum(len(x) for x in requests)} rows) "
          f"in {len(dispatches)} dispatches {sorted(set(dispatches))}, "
          f"{serve_s:.4f} s; kernel launches {served}", flush=True)
    if served != n_warm + len(dispatches) or not dispatches:
        fail(f"{served} gru_seq_infer launches for {n_warm} warmup and "
             f"{len(dispatches)} serving dispatches of a 1-GRU net")

    worst_gpu = worst_plain = 0.0
    for x, y in zip(requests, answers):
        if y.shape != (x.shape[0], vocab, x.shape[2]):
            fail(f"answer shape {y.shape} for request {x.shape}")
        if not np.isfinite(y).all():
            fail("non-finite GRU answer")
        if np.abs(y.sum(axis=1) - 1.0).max() > 1e-5:
            fail("GRU softmax rows do not sum to 1")
        worst_gpu = max(worst_gpu,
                        float(np.abs(y - net.output(x).cpu().numpy()).max()))
        worst_plain = max(worst_plain,
                          float(np.abs(y - plain.output(x).numpy()).max()))
    print(f"gru slice: served vs net.output max|d| {worst_gpu:.3e}, served "
          f"vs plain CPU forward max|d| {worst_plain:.3e}", flush=True)
    if worst_gpu > SERVE_TOL:
        fail(f"GRU served vs net.output {worst_gpu:.3e} > {SERVE_TOL}")
    if worst_plain > PLAIN_TOL:
        fail(f"GRU served vs plain forward {worst_plain:.3e} > {PLAIN_TOL}")

    # generation: 20 single tokens at N=1, each a [1, 1] id
    tokens = rng.integers(0, vocab, size=(1, 20))
    full = net.output(tokens).cpu().numpy()
    net.rnnClearPreviousState()
    gru.gru_seq_infer.launches = 0
    steps = np.stack([net.rnnTimeStep(tokens[:, k:k + 1]).cpu().numpy()
                      for k in range(20)], axis=-1)
    generated = gru.gru_seq_infer.launches
    step_err = float(np.abs(steps - full).max())
    print(f"gru slice: rnnTimeStep x20 at N=1 vs output max|d| "
          f"{step_err:.3e}; {generated} launches", flush=True)
    if step_err > SERVE_TOL:
        fail(f"GRU rnnTimeStep vs output {step_err:.3e} > {SERVE_TOL}")
    if generated != 20:
        fail("rnnTimeStep did not launch gru_seq_infer once per token")
    return served + generated


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs a "
              "GPU", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.kernels import build, gru, lstm

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    build.load_all(build.SOURCES)
    print(f"build: {', '.join(build.SOURCES)} "
          f"{time.perf_counter() - t0:.2f} s (in parallel)", flush=True)
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}", flush=True)

    rows, max_err = kernel_phase(torch, lstm)
    train_rows, train_errs = train_kernel_phase(torch, lstm)
    gru_rows, gru_errs = gru_kernel_phase(torch, gru)
    net, train_launches, _ = training_phase(torch, lstm)
    launches = slice_phase(torch, lstm, net)
    gru_net, gru_launches, _ = gru_training_phase(torch, gru)
    gru_launches["gru_seq_infer"] = gru_slice_phase(torch, gru, gru_net)

    entries = [
        ("lstm_seq_infer", "lstm_seq_infer.cu", "lstm.py:115", launches,
         max_err, REPORT_SHAPE, rows[REPORT_SHAPE])] + [
        (name, source, f"lstm.py:{line}", train_launches[name],
         train_errs[name], REPORT_SHAPE, train_rows[name][REPORT_SHAPE])
        for name, source, line in (("lstm_seq_fwd", "lstm_seq_infer.cu", 97),
                                   ("lstm_seq_bwd", "lstm_seq_bwd.cu", 200))
    ] + [
        (name, source, f"gru.py:{line}", gru_launches[name], gru_errs[name],
         shape, gru_rows[name][shape])
        for name, source, line, shape in (
            ("gru_seq_infer", "gru_seq.cu", 83, GRU_SERVE_SHAPE),
            ("gru_seq_fwd", "gru_seq.cu", 63, GRU_TRAIN_SHAPE),
            ("gru_seq_bwd", "gru_seq_bwd.cu", 159, GRU_TRAIN_SHAPE))]
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"deeplearning4j_tpu_torch/csrc/{source}",
        "replaces": f"deeplearning4j_tpu/kernels/{where}",
        "shape": list(shape),
        "launches": n_launch,
        "max_abs_err": err,
        "ms": rep["ms"],
        "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"],
        "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"],
    } for name, source, where, n_launch, err, shape, rep in entries]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
