"""Smoke run of the PyTorch/CUDA port (deeplearning4j_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version at the shapes the serving path
gives it, then serves the full-width GravesLSTM char-RNN
(TextGenerationLSTM: vocab 77, hidden 256, seqLength 100, random weights
from a numpy seed) through InferenceSession and checks the answers. Any
failed check exits non-zero. Without a GPU it exits non-zero and prints no
result. It imports nothing of the JAX package.

Output: the card's name and power limit (as nvidia-smi gives them), the
build time, one line per kernel shape (max |error| and times), the
serving checks, then a ``{"kernels": [...]}`` JSON line and, last,
``{"ok": true, "device": {...}}``.
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
REPORT_SHAPE = (100, 32, 256)   # the ladder's largest bucket
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


def lstm_bound(t, n, h):
    """Least time (ms) the card needs for the recurrence: each input read
    once (xw, R, h0, c0), each output written once (hs, hT, cT), against
    the 2*T*N*H*4H multiply-adds of h.R at the float32 non-tensor rate."""
    nbytes = 4 * (t * n * 4 * h + h * 4 * h + 2 * n * h + t * n * h
                  + 2 * n * h)
    flops = 2.0 * t * n * h * 4 * h
    by_bytes, by_ops = nbytes / PEAK_BYTES, flops / PEAK_F32
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


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


def one_hot_batch(rng, n, vocab, t):
    idx = rng.integers(0, vocab, size=(n, t))
    return np.eye(vocab, dtype=np.float32)[idx].transpose(0, 2, 1).copy()


def slice_phase(torch, lstm):
    """Serve TextGenerationLSTM at full width through InferenceSession."""
    from deeplearning4j_tpu_torch.models.zoo import TextGenerationLSTM
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import (
        DEFAULT_BATCH_BUCKETS, BucketLadder, InferenceSession)
    from deeplearning4j_tpu_torch.utils.convert import params_from_numpy

    vocab, hidden, seq = 77, 256, 100
    conf = TextGenerationLSTM(vocabSize=vocab, hidden=hidden,
                              seqLength=seq).conf()
    rng = np.random.default_rng(SEED)
    arrays = [{k: (rng.normal(size=s) * 0.08).astype(np.float32)
               for k, s in lr.param_shapes().items()} for lr in conf.layers]
    net = MultiLayerNetwork(conf).init(params_from_numpy(conf, arrays,
                                                         "cuda"))
    if net.device.type != "cuda":
        fail(f"the network defaulted to {net.device}, not cuda")
    plain = MultiLayerNetwork(conf, device="cpu").init(
        params_from_numpy(conf, arrays, "cpu"))

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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs a "
              "GPU", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.kernels import build, lstm

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    build.load("lstm_seq_infer")
    print(f"build: lstm_seq_infer {time.perf_counter() - t0:.2f} s",
          flush=True)
    for line in build.build_log("lstm_seq_infer").splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: {line.strip()}", flush=True)

    rows, max_err = kernel_phase(torch, lstm)
    launches = slice_phase(torch, lstm)

    rep = rows[REPORT_SHAPE]
    print(json.dumps({"kernels": [{
        "name": "lstm_seq_infer",
        "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/lstm_seq_infer.cu",
        "replaces": "deeplearning4j_tpu/kernels/lstm.py:115",
        "shape": list(REPORT_SHAPE),
        "launches": launches,
        "max_abs_err": max_err,
        "ms": rep["ms"],
        "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"],
        "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
