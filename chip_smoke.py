"""Smoke run of the PyTorch/CUDA port (deeplearning4j_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one
nvcc per source, in parallel), holds each against its plain PyTorch version
at the shapes the training and serving paths give it (the LSTM kernels'
launch plans also against their Python mirrors for the clusters the card
holds, the route query against the widths the kernels before their
cluster redesign took, the three LSTM kernels at the top of those
domains, and the backward's sweep and dR pass timed apart, single and back
to back; the GRU kernels also
against torch.nn.GRU on cuDNN, which is only timed and checked, never
called by the port; the GRU backward's two launch plans, its sweep's and
its dR pass's, also against their Python mirrors, its kernels at ragged
shapes too, the sweep and the dR pass timed apart, the dR pass also at
the step route's H=2048), then drives full-width models with random
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
  generation at N=1 against ``net.output``;
- the same GRU char-RNN built as a SameDiff graph from the same weights
  (gather -> permute -> rnn.gruLayer -> permute -> reshape -> nn.linear
  -> logits [N, T, V] -> loss.sparseSoftmaxCrossEntropy): ``output``
  against the network's on the card, ``calculateGradients`` and 5
  Adam ``fit`` steps on the card against the CPU (one GRU forward and
  one backward launch a step), a save/load round trip that continues
  bit-equal, a control (R + 1e-3) the output check must catch, the graph
  served through InferenceSession (a request with ids outside the
  vocabulary gives NaN rows where ``sd.output`` does, and the requests
  after it still match); then an ``lstmLayer`` graph at the LSTM
  char-RNN's width, card against CPU;
- the bidirectional LSTM classifier of Keras's IMDB example at its widths
  (Embedding 20000 -> 128, Bidirectional(LSTM 64), LastTimeStep(
  Bidirectional(LSTM 64)), two-way softmax, T=200, batch 32, Adam(1e-3)),
  with random token ids: ``gradients`` and 5 ``fit`` steps on the card
  against the CPU, 4 forward and 4 backward LSTM launches a step;
  ``evaluate`` over 10 batches of 32 and a ragged 17, 4 inference
  launches a batch, the confusion matrices equal but for rows within 1e-5
  of a tie; ``rnnTimeStep`` refused; a ModelSerializer round trip on the
  card, bit-equal; the step and evaluation times; and a small SimpleRnn
  net against the CPU;
- the step route (csrc/rnn_step.cu) at the widths the persistent LSTM and
  GRU kernels refuse (LSTM H=512 and 1024, GRU H=2048), which
  kernels/rnn_step.py must choose by shape there, against the plain
  versions and cuDNN; then TextGenerationLSTM(hidden=512) and a GRU(2048)
  char-RNN each serving a burst and taking a ``fit`` step through it;
- the flash-attention kernels (csrc/flash_attn_fwd.cu and
  csrc/flash_attn_bwd.cu, whose bf16 entries run on the tensor cores)
  against their plain versions at five shapes in float32 and bfloat16,
  beside SDPA (only timed, never called by the port), the forward's and
  the backward's launch plans against their Python mirrors, and at BERT's
  shape the bf16 kernels' and SDPA's forward and backward times back to
  back as well as single; then BERT-base (768/12/12, T=512,
  batch 16, lr 1e-4) trained 5 steps by BertTrainer with the flash
  kernels against the dense attention path, in float32 and in bfloat16
  (the main path: 12 forward and 12 + 12 backward flash launches a
  step), with step times and a torch.profiler breakdown; and the trained
  encoder served through InferenceSession and FnServable (N = 1..16 at
  T=512, 12 flash inference launches a dispatch) against a direct
  forward;
- the tool probes' bf16 tensor-core kernels (csrc/probe_matmul.cu and
  csrc/fused_bottleneck.cu, both on wgmma fed by TMA) against their plain
  versions: matmul_bf16 at the 9 probe shapes where the reference ran
  Pallas (its launch plan against its Python mirror; at the report shape
  its and cuBLAS's times back to back as well as single), the six
  bottleneck variants at ResNet-50's four stage widths (batch 256, g = 1
  and 4) and five ragged shapes (F past 512 and bands below 64 rows
  among them), each twice (the bits must repeat), their
  launch plans against the Python mirror, a control the check must
  catch, times beside cuBLAS and the cuBLAS + cuDNN block (single and
  back to back at every stage, with the share of the bf16 peak); then
  the three probe entry points at full width
  (probe_matmul, probe_fused_block --stage s2 --batch 256 --check,
  probe_fused_parts), each launching its kernels;
- LeNet-MNIST (BASELINE config 0: 28x28x1, conv 20 5x5, max 2x2, conv 50
  5x5, max 2x2, dense 500, softmax 10, Adam(1e-3)) from ``LeNet().init()``
  on the card: one epoch over the 10000 synthesised training digits at
  batch 64, each step also taken on the CPU from the card's state (its
  loss and the weights it leaves gated), a CPU net trained on its own,
  ``evaluate`` on the 2000 test digits (accuracies within 2 digits), a
  burst served through InferenceSession against ``output``, the TF32
  switches, fit step times and images/s at batch 64 and 512 with device
  time by kernel and the idle share; then Darknet19 at 224x224 (3 Adam
  steps at batch 4, each from the card's state on the CPU: losses and
  running means and variances gated) and VGG16 at 224x224 (output at
  batch 2 against the CPU; a fit step at batch 32 timed and profiled);
- ResNet-50 (BASELINE config 1: 224x224x3, stages (3, 4, 6, 3) of
  bottlenecks, 1000 classes, float32, Nesterovs(1e-2, 0.9)) from
  ``ResNet50().init()``, a ComputationGraph, on the card against the same
  graph on the CPU from the same numpy weights: the output at batch 2, 3
  fit steps at batch 4 each from the card's state (losses and the 53
  BatchNormalization nodes' running statistics gated), ``evaluate`` with
  a ragged last batch, a zip restored on the card and on the CPU, a
  burst of 10 requests served through InferenceSession against
  ``outputSingle``; the fit step at batch 64 and 256 with images/s, the
  share of the float32 peak, device time by kernel, the idle share and
  the peak memory; ``output`` at batch 64.
  No hand-written kernel is on these paths: cuDNN and cuBLAS carry
  them;
- YOLO2 (the zoo's ComputationGraph: Darknet-19 with the SpaceToDepth
  reorg, 416x416x3, 80 classes, 5 COCO priors, Adam(1e-3)) from
  ``YOLO2().init()`` on synthesised COCO-shaped data (1-4 boxes an image
  in the reference's label format), against the same graph on the CPU:
  the head and the decoded output in training mode and, with the
  running statistics set to one batch's, in inference;
  ``YoloUtils.getPredictedObjects`` on both (the same detections); 3
  Adam steps at batch 4 each from the same state (losses, the 22
  BatchNormalization nodes' running statistics and each param array's
  update gated); a zip restored on the card and the CPU; a served burst
  against ``outputSingle``; ``output`` at 16 and the fit step at batch 16
  and 64 with images/s, the share of the float32 peak, device time by
  kernel, the idle share and the peak memory. TinyYOLO (VOC's 20
  classes, a MultiLayerNetwork) likewise: output, 2 steps, a burst, the
  fit step at 64. Then rows 1-3 through MaskZeroLayer(LSTM 64) and
  FrozenLayer(LSTM 64) at (200, 32, 64) against the CPU (their launches
  counted on the ``fit`` and ``output`` path, the frozen weights
  bit-equal), and every other class of the slice at small widths
  (Convolution3D, the 3-D and 1-D shape layers, LocallyConnected,
  PReLU, the attention layers and AttentionVertex, capsules,
  CenterLoss, OCNN; AutoEncoder and VAE with the noise passed in) on the
  card against the CPU. The phase alone: ``import chip_smoke`` and call
  ``detection_phase(torch, card, lstm)`` after building the LSTM
  sources.

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
import math
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
# (T, N, H) of the bidirectional IMDB classifier (maxlen 200, batch 32,
# 64 units a direction): the LSTM kernels' shape on its path
IMDB_SHAPE = (200, 32, 64)
KERNEL_SHAPES = [(100, 1, 256), (100, 8, 256), (100, 32, 256),
                 (100, 1024, 256), (1, 8, 256), (13, 3, 200), IMDB_SHAPE]
# the training kernels: the training batch (100, 32, 256) and the others
TRAIN_SHAPES = [(100, 32, 256), (100, 1, 256), (100, 1024, 256),
                (1, 8, 256), (13, 3, 200), IMDB_SHAPE]
REPORT_SHAPE = (100, 32, 256)   # the ladder's largest bucket, the batch
# (T, N, H) at the top of the domains that the kernels before their
# cluster redesign took: the forward to H = 431 at N <= 18, the backward
# to H = 300 at any N and to H = 423 at N <= 18
LSTM_EDGE_SHAPES = [(50, 16, 431), (50, 32, 300), (50, 8, 423)]
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


def time_ms(fn, reps, spread=False):
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event timings,
    after one warm-up call; with ``spread``, (median, min, max)."""
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
    if spread:
        return statistics.median(times), min(times), max(times)
    return statistics.median(times)


def time_b2b_ms(fn, n=50):
    """Milliseconds a call of ``fn()`` when calls follow one another: one
    CUDA-event window over ``n`` back-to-back calls after three warm-up
    calls, over ``n`` (a single call's time also holds the host's
    enqueue, which back-to-back calls hide behind the device's work)."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


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
            b2b = time_b2b_ms(lambda: lstm.lstm_seq_infer(xw, r_d, h0_d,
                                                          c0_d), 20)
        bound_ms, bound_by = lstm_bound(t, n, h)
        rows[(t, n, h)] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
                               b2b_ms=b2b, err=err)
        print(f"lstm_seq_infer T={t} N={n} H={h}: max|d| {err:.3e} "
              f"(vs cuDNN {cudnn_err:.3e}); kernel {k_ms:.4f} ms (back to "
              f"back {b2b:.4f}), "
              f"projection+kernel {layer_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"cuDNN LSTM layer {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by})", flush=True)
    return rows, max_err


def _abs_err(got, want):
    """max |got - want|, in float32."""
    return float((got.float() - want.float()).abs().max())


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
        f_b2b = time_b2b_ms(lambda: fwd(xw, r, h0, c0), 20)
        b_b2b = time_b2b_ms(lambda: bwd(dhs, dhT, dcT, gates, cs, hs, r, h0,
                                        c0), 20)
        dr_ms, dr_b2b = lstm_dr_pass_ms(torch, hs, h0, reps)
        sweep_b, dr_b = lstm_sweep_bound(t, n, h)[0], lstm_dr_bound(t, n, h)[0]
        print(f"lstm_seq_bwd T={t} N={n} H={h}: its dR pass alone "
              f"{dr_ms:.4f} ms (back to back {dr_b2b:.4f}; bound "
              f"{dr_b:.4f}), so the sweep {b_ms - dr_ms:.4f} ms (back to "
              f"back {b_b2b - dr_b2b:.4f}; bound {sweep_b:.4f})", flush=True)
        for name, ms, b2b, p_ms, l_ms, bound in (
                ("lstm_seq_fwd", f_ms, f_b2b, pf_ms, lf_ms,
                 fwd_bound(t, n, h)),
                ("lstm_seq_bwd", b_ms, b_b2b, pb_ms, lb_ms,
                 bwd_bound(t, n, h))):
            rows[name][(t, n, h)] = dict(ms=ms, plain_ms=p_ms,
                                         library_ms=l_ms, bound_ms=bound[0],
                                         bound_by=bound[1], b2b_ms=b2b,
                                         err=(err_f if name == "lstm_seq_fwd"
                                              else abs_b))
            err = (f"{err_f:.3e}" if name == "lstm_seq_fwd" else
                   f"{abs_b:.3e} ({err_b:.3e} of the largest)")
            print(f"{name} T={t} N={n} H={h}: max|d| {err}; "
                  f"kernel {ms:.4f} ms (back to back {b2b:.4f}), plain "
                  f"{p_ms:.4f} ms, cuDNN LSTM "
                  f"layer {'backward' if name == 'lstm_seq_bwd' else 'training forward'} "
                  f"{l_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})",
                  flush=True)
        rows["lstm_seq_bwd"][(t, n, h)]["halves"] = dict(
            sweep_ms=b_ms - dr_ms, sweep_b2b_ms=b_b2b - dr_b2b,
            sweep_bound_ms=sweep_b, dr_ms=dr_ms, dr_b2b_ms=dr_b2b,
            dr_bound_ms=dr_b)
    return rows, errs


def lstm_sweep_bound(t, n, h):
    """The sweep's half of row 3's bound: reads dhs, dhT, dcT, gates, cs,
    R, c0 once, writes dxw, dh0, dc0 once; 2*T*N*H*4H multiply-adds of
    dz R^T."""
    return _bound(4 * (t * n * h + 2 * n * h + 4 * t * n * h + t * n * h
                       + 4 * h * h + n * h + 4 * t * n * h + 2 * n * h),
                  2.0 * t * n * h * 4 * h)


def lstm_dr_bound(t, n, h):
    """The dR pass's: reads hs, h0 and dxw once, writes dR once;
    2*T*N*H*4H multiply-adds."""
    return _bound(4 * (t * n * h + n * h + 4 * t * n * h + 4 * h * h),
                  2.0 * t * n * h * 4 * h)


def lstm_dr_pass_ms(torch, hs, h0, reps):
    """CUDA-event median of single calls of lstm_seq_bwd's second pass
    alone (dR from a dxw), through its own entry point, so that the sweep
    and the dR pass are timed apart, and its time back to back. Values do
    not change its time."""
    import ctypes

    from deeplearning4j_tpu_torch.kernels import build

    t, n, h = hs.shape
    fn = build.load("lstm_seq_bwd").lstm_seq_bwd_dr_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dxw = torch.ones((t, n, 4 * h), device="cuda")
    dr = torch.empty((h, 4 * h), device="cuda")

    def run():
        rc = fn(hs.data_ptr(), h0.data_ptr(), dxw.data_ptr(), dr.data_ptr(),
                t, n, h, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            fail(f"lstm_seq_bwd_dr_f32 returned {rc}")

    return time_ms(run, reps), time_b2b_ms(run, 20)


def old_lstm_fits(n, h, bwd, sms):
    """The launch rules of csrc/lstm_seq_infer.cu (forward, either entry)
    and csrc/lstm_seq_bwd.cu's sweep (bwd) before their cluster redesign,
    on a card of ``sms`` SMs (tests/test_torch_lstm_plan.py holds the new
    plans to them too): 32 units a block (256 threads), R's [H, 128] slice
    (forward) or [32, 4H] (sweep) in shared memory beside the partial sums
    and the staged rows of a row tile (16 / ksplit rows); the largest
    ksplit of 8, 4, 2, 1 whose row tiles all fit in one co-resident wave
    (a ksplit whose slice does not fit ends the search with -1), ksplit 1
    looping over row tiles otherwise; ceil(H/32) co-resident blocks at
    least. Blocks an SM by shared memory (233472 bytes an SM, 1 KiB
    reserved a block) and threads; registers are taken not to limit them,
    which can only widen the domain. 0 where it took (N, H), else -1 or
    -2 as the source returned, -3 for an empty dimension."""
    if min(n, h) < 1:
        return -3
    for ks in (8, 4, 2, 1):
        rows = 16 // ks
        smem = (4 * (4 * h * 32 + 512 + rows * 4 * h) if bwd else
                4 * (h * 128 + 2048 + rows * h))
        if smem > 232448:
            return -1
        capacity = min(2048 // 256, 233472 // (smem + 1024)) * sms
        unit_tiles = -(-h // 32)
        if ks > 1 and -(-n // rows) * unit_tiles > capacity:
            continue
        return 0 if capacity >= unit_tiles else -2


# (N, H) where the route query must answer as the kernels before took them
LSTM_DOMAIN_N = (1, 3, 8, 17, 18, 32, 40, 64, 130, 1024)
LSTM_DOMAIN_H = (1, 13, 37, 200, 256, 300, 301, 336, 340, 389, 390, 412,
                 423, 431, 432, 448)


def lstm_plan_phase(torch, lstm):
    """The forward's and the sweep's launch plans as their sources compute
    them (lstm_seq_plan, lstm_seq_bwd_plan), for the clusters this card
    holds, against their Python mirrors (kernels/lstm.py), and the dR
    pass's (lstm_seq_bwd_dr_plan) against its mirror, at every LSTM shape
    of this script; then every (N, H) of the domain grid that the kernels
    before their redesign took (their rules copied) must still launch
    (lstm_seq_fits, lstm_seq_bwd_fits: the launch's own checks), and past
    H = 300 the sweep must leave every other batch to the step route
    (-1)."""
    from deeplearning4j_tpu_torch.kernels import build

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    caps, bwd_caps = lstm.lstm_seq_clusters(), lstm.lstm_seq_clusters(True)
    print(f"lstm plans: the card holds clusters (size: count) {caps} of "
          f"the forward's blocks, {bwd_caps} of the sweep's", flush=True)
    shapes = sorted(set(KERNEL_SHAPES) | set(TRAIN_SHAPES)
                    | set(LSTM_EDGE_SHAPES))
    for t, n, h in shapes:
        want_f = lstm.lstm_seq_plan(n, h, caps)
        want_b = lstm.lstm_seq_bwd_plan(n, h, bwd_caps)
        want_d = lstm.lstm_bwd_dr_plan(t, n, h, sms)
        got = ([lstm.lstm_seq_source_plan(n, h, save) for save in (0, 1)],
               lstm.lstm_seq_bwd_source_plan(n, h),
               lstm.lstm_bwd_dr_source_plan(t, n, h, 0))
        if got != ([want_f, want_f], want_b, want_d):
            fail(f"LSTM plans at {(t, n, h)}: sources {got} vs mirrors "
                 f"{want_f}, {want_b}, {want_d}")
        sweep_rc = 0 if h <= 300 or old_lstm_fits(n, h, True, sms) == 0 \
            else -1
        if (want_f[0], want_b[0]) != (0, sweep_rc):
            fail(f"LSTM plans at {(t, n, h)}: codes {want_f[0]}, "
                 f"{want_b[0]}")
        f, b, d = want_f[1], want_b[1], want_d[1]
        sweep = ("the step route's" if b is None else
                 f"{b['tiles']} clusters of {b['cluster']}, {b['rows']} "
                 f"rows, {b['threads']} threads, {b['splits']} j-splits")
        print(f"lstm plans T={t} N={n} H={h} (source = mirror): forward "
              f"{f['tiles']} clusters of {f['cluster']} x {f['units']} "
              f"units, {f['rows']} rows, {f['threads']} threads, "
              f"{f['splits']} k-splits, {f['smem_bytes']} B; sweep "
              f"{sweep}; dR {d['tiles']} tiles x {d['splits']} splits",
              flush=True)
    took = left = 0
    for n in LSTM_DOMAIN_N:
        for h in LSTM_DOMAIN_H:
            for bwd in (False, True):
                rcs = ([build.query("lstm_seq_bwd", "lstm_seq_bwd_fits",
                                    "fits", [n, h], "cuda")] if bwd else
                       [build.query("lstm_seq_infer", "lstm_seq_fits",
                                    "fits", [n, h, save], "cuda")
                        for save in (0, 1)])
                name = f"{'lstm_seq_bwd' if bwd else 'lstm_seq'}_fits"
                if old_lstm_fits(n, h, bwd, sms) == 0:
                    took += 1
                    if any(rcs):
                        fail(f"{name} N={n} H={h}: codes {rcs}; the kernel "
                             f"before took it")
                elif bwd and h > 300:
                    left += 1
                    if rcs != [-1]:
                        fail(f"{name} N={n} H={h}: codes {rcs}; the step "
                             f"route takes it")
    print(f"lstm plans: every one of the {took} (N, H, kind) the kernels "
          f"before took still launches; the sweep leaves the other {left} "
          f"(N, H) past H = 300 to the step route", flush=True)


def lstm_edge_phase(torch, lstm):
    """The three LSTM kernels at the top of the domains the kernels before
    took (LSTM_EDGE_SHAPES: clusters of 16 blocks, or of 8 blocks of 40
    units), by the persistent route (the backward at the forward's edge,
    past the sweep's batches, by the step route), against their plain
    versions (KERNEL_TOL; GRAD_TOL of each output's largest), each
    launched twice (the bits must repeat)."""
    from deeplearning4j_tpu_torch.kernels import rnn_step

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for t, n, h in LSTM_EDGE_SHAPES:
        # the sweep past H = 300 where the kernel before took it; at
        # (16, 431), the forward's edge, the backward takes the step route
        sweep = old_lstm_fits(n, h, True, sms) == 0
        for kind in ("lstm_infer", "lstm_fwd", "lstm_bwd"):
            if rnn_step.takes_persistent(kind, n, h, "cuda") != (
                    sweep or kind != "lstm_bwd"):
                fail(f"{kind} at N={n} H={h} takes the other route")
        rng = np.random.default_rng([SEED, 15, t, n, h])

        def dev(*shape, scale=1.0):
            return torch.tensor((rng.normal(size=shape) * scale).astype(
                np.float32), device="cuda")

        xw, r = dev(t, n, 4 * h, scale=0.5), dev(h, 4 * h, scale=h ** -0.5)
        h0, c0 = dev(n, h, scale=0.2), dev(n, h, scale=0.2)
        dhs, dhT, dcT = dev(t, n, h), dev(n, h), dev(n, h)
        fns = (lstm.lstm_seq_infer, lstm.lstm_seq_fwd,
               lstm.lstm_seq_bwd if sweep else rnn_step.lstm_step_bwd)
        before = [fn.launches for fn in fns]
        with torch.no_grad():
            infer = [lstm.lstm_seq_infer(xw, r, h0, c0) for _ in range(2)]
        fwd = [lstm.lstm_seq_fwd(xw, r, h0, c0) for _ in range(2)]
        hs, gates, cs = fwd[0]
        bwd = [lstm.lstm_seq_bwd(dhs, dhT, dcT, gates, cs, hs, r, h0, c0)
               for _ in range(2)]
        torch.cuda.synchronize()
        if [fn.launches for fn in fns] != [k + 2 for k in before]:
            fail(f"LSTM kernels did not launch at {(t, n, h)}")
        err_i = max(_abs_err(a, e) for a, e in zip(
            infer[0], lstm.lstm_seq_infer_reference(xw, r, h0, c0)))
        err_f = max(_abs_err(a, e) for a, e in zip(
            fwd[0], lstm.lstm_seq_fwd_reference(xw, r, h0, c0)))
        rel_b = max(_rel_err(a, e) for a, e in zip(
            bwd[0], lstm.lstm_seq_bwd_reference(dhs, dhT, dcT, gates, cs,
                                                hs, r, h0, c0)))
        if max(err_i, err_f) > KERNEL_TOL or rel_b > GRAD_TOL:
            fail(f"LSTM kernels at {(t, n, h)}: infer {err_i:.3e}, fwd "
                 f"{err_f:.3e}, bwd {rel_b:.3e} of the largest")
        for name, runs in zip(("lstm_seq_infer", "lstm_seq_fwd",
                               "lstm_seq_bwd"), (infer, fwd, bwd)):
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                fail(f"{name} gave other bits on a second run at "
                     f"{(t, n, h)}")
        print(f"lstm edge T={t} N={n} H={h}: infer max|d| {err_i:.3e}, fwd "
              f"{err_f:.3e}, bwd max|d|/max {rel_b:.3e}; bits repeat",
              flush=True)


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
# the backward's plans are also checked at these (N, H): row tiles of 48
# and two of 48 rows, and the step route's width (the sweep refuses it)
GRU_BWD_PLAN_EXTRA = [(48, 1024), (96, 1024), (64, 2048)]
# (T, N, H) the backward's sweep plans otherwise than the kernel before
# it: a ragged batch and width, two row tiles, 20 units a block
GRU_BWD_RAGGED = [(5, 33, 1000), (4, 96, 1056), (3, 17, 1100)]
GRU_STEP_DR_SHAPE = (100, 64, 2048)   # the step route's GRU dR pass


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


def gru_sweep_bound(t, n, h):
    """The sweep's half of the backward: reads dhs, dhT, ru, rz_c, cand,
    hs, R, h0 once, writes dxw, the drz scratch and dh0 once; 2*T*N*H*3H
    multiply-adds of drz R^T."""
    return _bound(4 * (6 * t * n * h + 2 * n * h + h * 3 * h
                       + 6 * t * n * h + n * h), 2.0 * t * n * h * 3 * h)


def gru_dr_bound(t, n, h):
    """The dR pass: reads hs, h0 and drz once, writes dR and drb once;
    2*T*N*H*3H multiply-adds."""
    return _bound(4 * (t * n * h + n * h + 3 * t * n * h + h * 3 * h
                       + 3 * h), 2.0 * t * n * h * 3 * h)


def dr_pass_ms(torch, hs, h0, reps):
    """CUDA-event median of single calls of gru_seq_bwd's second pass alone
    (dR and drb from a drz scratch), through its own entry point, so that
    the sweep and the reduction are timed apart, and its time back to
    back. Values do not change its time."""
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

    return time_ms(run, reps), time_b2b_ms(run, 20)


def gru_bwd_plan_check(torch, gru, t, n, h):
    """The backward's launch plans as csrc/gru_seq_bwd.cu computes them
    (gru_seq_bwd_plan for the sweep, gru_seq_bwd_dr_plan for the dR pass)
    against their Python mirrors (kernels/gru.py gru_seq_bwd_plan,
    gru_bwd_dr_plan) at this card's SM count, codes included, and the
    sweep plan the card launches."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mirror = gru.gru_seq_bwd_plan(n, h, sms)
    source = gru.gru_seq_bwd_source_plan(n, h, sms)
    if source != mirror:
        fail(f"gru_seq_bwd sweep plan at N={n} H={h}: source {source} vs "
             f"mirror {mirror}")
    dr_mirror = gru.gru_bwd_dr_plan(t, n, h, sms)
    dr_source = gru.gru_bwd_dr_source_plan(t, n, h, sms)
    if dr_source != dr_mirror:
        fail(f"gru_seq_bwd dR plan at {(t, n, h)}: source {dr_source} vs "
             f"mirror {dr_mirror}")
    card = gru.gru_seq_bwd_source_plan(n, h, 0)
    print(f"gru_seq_bwd plans T={t} N={n} H={h} on {sms} SMs: sweep "
          f"{mirror[1] if mirror[0] == 0 else f'code {mirror[0]}'}, dR "
          f"{dr_mirror[1]} (source = mirror); the card launches "
          f"{'the same' if card == mirror else card}", flush=True)


def gru_bwd_ragged_check(torch, gru):
    """gru_seq_bwd at GRU_BWD_RAGGED, where the sweep's plan differs from
    the kernel before it (a ragged batch, two row tiles, 20 units a
    block), against its plain version (GRAD_TOL), launched twice (the bits
    must repeat), by the persistent route."""
    from deeplearning4j_tpu_torch.kernels import rnn_step

    for t, n, h in GRU_BWD_RAGGED:
        gru_bwd_plan_check(torch, gru, t, n, h)
        if not rnn_step.takes_persistent("gru_bwd", n, h, "cuda"):
            fail(f"gru_seq_bwd at N={n} H={h} takes the step route")
        rng = np.random.default_rng([SEED, 14, t, n, h])

        def dev(*shape, scale=1.0):
            return torch.tensor((rng.normal(size=shape) * scale).astype(
                np.float32), device="cuda")

        xw, r = dev(t, n, 3 * h, scale=0.5), dev(h, 3 * h, scale=h ** -0.5)
        rb, h0 = dev(3 * h, scale=0.1), dev(n, h, scale=0.2)
        hs, ru, rzc, cand = gru.gru_seq_fwd_reference(xw, r, rb, h0)
        ins = [dev(t, n, h), dev(n, h), ru, rzc, cand, hs, r, h0]
        before = gru.gru_seq_bwd.launches
        first, second = gru.gru_seq_bwd(*ins), gru.gru_seq_bwd(*ins)
        torch.cuda.synchronize()
        if gru.gru_seq_bwd.launches != before + 2:
            fail(f"gru_seq_bwd did not launch at {(t, n, h)}")
        rel = max(_rel_err(a, e) for a, e in zip(
            first, gru.gru_seq_bwd_reference(*ins)))
        if rel > GRAD_TOL:
            fail(f"gru_seq_bwd vs plain max|d|/max={rel:.3e} > {GRAD_TOL} "
                 f"at {(t, n, h)}")
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            fail(f"gru_seq_bwd gave other bits on a second run at "
                 f"{(t, n, h)}")
        print(f"gru_seq_bwd T={t} N={n} H={h}: max|d|/max {rel:.3e}, bits "
              f"repeat", flush=True)


def gru_step_dr_phase(torch, gru):
    """The dR pass alone at the step route's GRU width (the step route's
    backward runs it after its own sweep, kernels/rnn_step.py
    gru_step_bwd): its plan against the mirror, dR and drb against hprev^T
    drz (GRAD_TOL), bits repeated, single and back-to-back times against
    its bound."""
    import ctypes

    from deeplearning4j_tpu_torch.kernels import build

    t, n, h = GRU_STEP_DR_SHAPE
    gru_bwd_plan_check(torch, gru, t, n, h)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    hs, drz = (torch.randn(s, device="cuda", generator=gen)
               for s in ((t, n, h), (t, n, 3 * h)))
    h0 = torch.randn((n, h), device="cuda", generator=gen)
    fn = build.load("gru_seq_bwd").gru_seq_bwd_dr_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    outs = []
    for _ in range(2):
        dr = torch.empty((h, 3 * h), device="cuda")
        drb = torch.empty((3 * h,), device="cuda")
        rc = fn(hs.data_ptr(), h0.data_ptr(), drz.data_ptr(), dr.data_ptr(),
                drb.data_ptr(), t, n, h,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            fail(f"gru_seq_bwd_dr_f32 returned {rc} at {(t, n, h)}")
        outs.append((dr, drb))
    torch.cuda.synchronize()
    hprev = torch.cat([h0[None], hs[:-1]]).reshape(-1, h)
    want = (hprev.T @ drz.reshape(-1, 3 * h), drz.reshape(-1, 3 * h).sum(0))
    rel = max(_rel_err(a, e) for a, e in zip(outs[0], want))
    if rel > GRAD_TOL:
        fail(f"the dR pass vs hprev^T drz max|d|/max={rel:.3e} at "
             f"{(t, n, h)}")
    if not all(torch.equal(a, b) for a, b in zip(*outs)):
        fail(f"the dR pass gave other bits on a second run at {(t, n, h)}")
    single, b2b = dr_pass_ms(torch, hs, h0, 10)
    bound = gru_dr_bound(t, n, h)
    print(f"gru step route dR pass T={t} N={n} H={h}: max|d|/max "
          f"{rel:.3e}, bits repeat; single {single:.4f} ms, back to back "
          f"{b2b:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})", flush=True)
    return dict(ms=single, b2b_ms=b2b, bound_ms=bound[0])


def gru_plan_check(torch, gru, n, h):
    """The forward kernel's launch plan as csrc/gru_seq.cu computes it
    (gru_seq_plan, both entries) against its Python mirror
    (kernels/gru.py gru_seq_plan) at this card's SM count, and the plan the
    card launches (a smaller cluster where it cannot hold the plan's
    clusters at once)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mirror = gru.gru_seq_plan(n, h, sms)
    for save in (0, 1):
        source = gru.gru_seq_source_plan(n, h, save, sms)
        if source != mirror:
            fail(f"gru_seq plan at N={n} H={h} save={save}: source {source}"
                 f" vs mirror {mirror}")
    card = gru.gru_seq_source_plan(n, h, 0, 0)
    print(f"gru_seq plan N={n} H={h} on {sms} SMs: {mirror[1]} (source = "
          f"mirror); the card launches "
          f"{'the same' if card == mirror else card[1]}", flush=True)


def gru_step_route_ms(torch, xw, r, rb, h0, save):
    """Single and back-to-back CUDA-event ms of the step route's GRU
    forward (csrc/rnn_step.cu rnn_step_fwd_gru_f32) on these inputs, called
    through its C entry as scripts/rnn_step_ab.py does: a second yardstick
    for the persistent kernel, whose route does not change."""
    import ctypes

    from deeplearning4j_tpu_torch.kernels import build

    t, n, h = xw.shape[0], xw.shape[1], r.shape[0]
    fn = build.load("rnn_step").rnn_step_fwd_gru_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    hs = torch.empty((t, n, h), device="cuda")
    res = [torch.empty((t, n, k * h), device="cuda") if save else None
           for k in (2, 1, 1)]

    def run():
        rc = fn(xw.data_ptr(), r.data_ptr(), rb.data_ptr(), h0.data_ptr(),
                hs.data_ptr(), *(x.data_ptr() if save else None for x in res),
                int(save), t, n, h, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            fail(f"rnn_step_fwd_gru_f32 returned {rc}")

    return time_ms(run, 10), time_b2b_ms(run, 20)


def gru_kernel_phase(torch, gru):
    """The three GRU kernels vs their plain versions at every GRU shape,
    the forward's launch plan against its mirror; every kernel's
    determinism (a second launch repeats the bits); times of each kernel
    (single and back to back), its plain version and torch.nn.GRU on cuDNN
    (the yardstick: the same reset-after recurrence, gate order r, z, n,
    weight_hh = R^T; never called by the port), and at the char-RNN's
    serving and training shapes the step route's forward beside them."""
    names = ("gru_seq_infer", "gru_seq_fwd", "gru_seq_bwd")
    rows = {name: {} for name in names}
    errs = dict.fromkeys(names, 0.0)   # max |d|, absolute
    for (t, n, h) in GRU_SHAPES:
        gru_plan_check(torch, gru, n, h)
        gru_bwd_plan_check(torch, gru, t, n, h)
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
        again = (gru.gru_seq_infer(xw, r, rb, h0), gru.gru_seq_fwd(
            xw, r, rb, h0), gru.gru_seq_bwd(dhs, dhT, ru, rzc, cand, hs, r,
                                            h0))
        for name, first, second in zip(names, (got_i, got_f, got_b), again):
            if not all(torch.equal(a, e) for a, e in zip(second, first)):
                fail(f"{name} gave other bits on a second run at "
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
        with torch.inference_mode():
            i_b2b = time_b2b_ms(lambda: gru.gru_seq_infer(xw, r, rb, h0))
        f_b2b = time_b2b_ms(lambda: gru.gru_seq_fwd(xw, r, rb, h0))
        b_b2b = time_b2b_ms(lambda: gru.gru_seq_bwd(dhs, dhT, ru, rzc, cand,
                                                   hs, r, h0))
        print(f"gru T={t} N={n} H={h} back to back: infer {i_b2b:.4f}, fwd "
              f"{f_b2b:.4f}, bwd {b_b2b:.4f} ms", flush=True)
        if (t, n, h) in (GRU_SERVE_SHAPE, GRU_TRAIN_SHAPE):
            save = (t, n, h) == GRU_TRAIN_SHAPE
            single, b2b = gru_step_route_ms(torch, xw, r, rb, h0, save)
            print(f"gru step route {'fwd' if save else 'infer'} T={t} N={n} "
                  f"H={h} (yardstick, not the route): single {single:.4f} "
                  f"ms, back to back {b2b:.4f} ms", flush=True)
        pf_ms = time_ms(lambda: gru.gru_seq_fwd_reference(xw, r, rb, h0),
                        plain_reps)
        pb_ms = time_ms(lambda: gru.gru_seq_bwd_reference(
            dhs, dhT, ru, rzc, cand, hs, r, h0), plain_reps)
        lf_ms = time_ms(lib_fwd, reps)
        lb_ms = time_ms(lambda: torch.autograd.grad(outs, wrt, cts,
                                                    retain_graph=True), reps)
        del outs
        dr_ms, dr_b2b = dr_pass_ms(torch, hs, h0, reps)
        sweep_b, dr_b = gru_sweep_bound(t, n, h)[0], gru_dr_bound(t, n, h)[0]
        print(f"gru_seq_bwd T={t} N={n} H={h}: its dR, drb pass alone "
              f"{dr_ms:.4f} ms (back to back {dr_b2b:.4f}; bound "
              f"{dr_b:.4f}), so the sweep {b_ms - dr_ms:.4f} ms (back to "
              f"back {b_b2b - dr_b2b:.4f}; bound {sweep_b:.4f})", flush=True)
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
            if name == "gru_seq_bwd":
                rows[name][(t, n, h)]["halves"] = dict(
                    sweep_ms=ms - dr_ms, sweep_b2b_ms=b_b2b - dr_b2b,
                    sweep_bound_ms=sweep_b, dr_ms=dr_ms, dr_b2b_ms=dr_b2b,
                    dr_bound_ms=dr_b)
            print(f"{name} T={t} N={n} H={h}: max|d| {err}"
                  f"{f' (vs cuDNN {cudnn_err:.3e})' if lib == 'layer' else ''}"
                  f"; kernel {ms:.4f} ms, plain {p_ms:.4f} ms, cuDNN GRU "
                  f"{lib} {l_ms:.4f} ms, bound {bound[0]:.4f} ms "
                  f"({bound[1]})", flush=True)
    for n, h in GRU_BWD_PLAN_EXTRA:
        gru_bwd_plan_check(torch, gru, 100, n, h)
    gru_bwd_ragged_check(torch, gru)
    rows["gru_seq_bwd"][GRU_TRAIN_SHAPE]["halves"]["step_route_dr"] = (
        gru_step_dr_phase(torch, gru))
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


def _at(tree, path):
    """The leaf of nested dicts at ``path`` (a tuple of keys)."""
    for k in path:
        tree = tree[k]
    return tree


def _compare_trained(gpu, cpu, what, lr, steps):
    """Params and Adam moments of two nets trained alike (see PARAM_TOL);
    a nested group's leaves (Bidirectional's fwd and bwd) one by one."""
    from deeplearning4j_tpu_torch.tree_util import tree_items

    _compare_leaves([
        (_at(pg, k), leaf,
         *(_at(net._opt_states[i][m], k) for m in ("m", "v")
           for net in (gpu, cpu)))
        for i, (pg, pc) in enumerate(zip(gpu._params, cpu._params))
        for k, leaf in tree_items(pc)], what, lr, steps)


def _compare_leaves(leaves, what, lr, steps):
    """``_compare_trained`` over (param card, param CPU, m card, m CPU, v
    card, v CPU) tuples."""
    worst_p = worst_m = worst_tiny = 0.0
    n_tiny_off = 0
    for pg, pc, mg, mc, vg, vc in leaves:
        pg, pc, mg, mc, vg, vc = (t.cpu() for t in (pg, pc, mg, mc, vg, vc))
        worst_m = max(worst_m, _rel_err(mg, mc), _rel_err(vg, vc))
        tiny = mc.abs() < MOMENT_FLOOR * mc.abs().max()
        d = (pg - pc).abs()
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
        direct = net.output(x).toNumpy()
        ref = plain.output(x).toNumpy()
        worst_gpu = max(worst_gpu, float(np.abs(y - direct).max()))
        worst_plain = max(worst_plain, float(np.abs(y - ref).max()))
    print(f"slice: served vs net.output max|d| {worst_gpu:.3e}, served vs "
          f"plain CPU forward max|d| {worst_plain:.3e}", flush=True)
    if worst_gpu > SERVE_TOL:
        fail(f"served vs net.output {worst_gpu:.3e} > {SERVE_TOL}")
    if worst_plain > PLAIN_TOL:
        fail(f"served vs plain forward {worst_plain:.3e} > {PLAIN_TOL}")

    x = requests[0]
    full = net.output(x).toNumpy()
    net.rnnClearPreviousState()
    steps = np.stack([net.rnnTimeStep(x[:, :, k]).toNumpy()
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


def gru_char_rnn_data(conf, batch, vocab=66, seq=100):
    """The GRU char-RNN's weights (numpy, one dict a layer) and one
    token batch, from the seed the GRU training phase uses."""
    rng = np.random.default_rng(SEED + 2)
    arrays = [{k: (rng.normal(size=sh) * (sh[0] ** -0.5 if len(sh) == 2
                                          else 0.05)).astype(np.float32)
               for k, sh in lr_.param_shapes().items()}
              for lr_ in conf.layers]
    f, l = token_batch(rng, batch, vocab, seq)
    return arrays, f, l


def gru_training_phase(torch, gru):
    """Train the GRU char-RNN at full width (66/256/1024, T=100, N=64,
    Adam(1e-3)) on the card and on the CPU from the same weights and
    batch; returns (the trained card net, the kernels' launches in the
    5 fit steps, the median step ms)."""
    vocab, seq, batch = 66, 100, 64
    conf = gru_char_rnn_conf(vocab=vocab, seq=seq)
    lr = conf.defaults["updater"].learningRate
    arrays, f, l = gru_char_rnn_data(conf, batch)
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
    # ids outside [0, vocab) take the reference's rows (a negative id wraps
    # once, then ids clamp) on the card as on the CPU, with no device
    # assert: the requests and the generation after it still run
    wild = ids(2, seq)
    wild[:, 0, :4] = [vocab + 5, -1, -7, -3 * vocab]
    requests.append(wild)

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
    print(f"gru slice: warmup of {n_warm} ladder shapes "
          f"{sorted(tuple(x) for x in entry.servable.warmed_shapes)} "
          f"{warm_s:.3f} s; {len(requests)} requests "
          f"({sum(len(x) for x in requests)} rows) in {len(dispatches)} "
          f"dispatches {sorted(dispatches)}, {serve_s:.4f} s; kernel "
          f"launches {served}", flush=True)
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
                        float(np.abs(y - net.output(x).toNumpy()).max()))
        worst_plain = max(worst_plain,
                          float(np.abs(y - plain.output(x).toNumpy()).max()))
    print(f"gru slice: served vs net.output max|d| {worst_gpu:.3e}, served "
          f"vs plain CPU forward max|d| {worst_plain:.3e}", flush=True)
    if worst_gpu > SERVE_TOL:
        fail(f"GRU served vs net.output {worst_gpu:.3e} > {SERVE_TOL}")
    if worst_plain > PLAIN_TOL:
        fail(f"GRU served vs plain forward {worst_plain:.3e} > {PLAIN_TOL}")

    # generation: 20 single tokens at N=1, each a [1, 1] id
    tokens = rng.integers(0, vocab, size=(1, 20))
    full = net.output(tokens).toNumpy()
    net.rnnClearPreviousState()
    gru.gru_seq_infer.launches = 0
    steps = np.stack([net.rnnTimeStep(tokens[:, k:k + 1]).toNumpy()
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


# ---------------------------------------------------------------------------
# the GRU char-RNN as a SameDiff graph
# ---------------------------------------------------------------------------

SD_PERTURB = 1e-3   # the control: R shifted by this must fail the check


def samediff_char_rnn(values, device, vocab=66, seq=100):
    """The tutorial's GRU char-RNN in SameDiff's own terms, as a TF import
    builds it: gather (the embedding) -> permute -> rnn.gruLayer ->
    permute -> reshape -> nn.linear -> logits [N, T, V] (the batch on
    axis 0, as a served output needs) -> loss.sparseSoftmaxCrossEntropy,
    trained by Adam(1e-3). ``values`` maps emb, W, R, b, Wo, bo to numpy
    arrays."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.optimize.updaters import Adam

    hidden = values["R"].shape[0]
    sd = SameDiff(device=device)
    tokens = sd.placeHolder("tokens", "float32", -1, seq)
    labels = sd.placeHolder("labels", "float32", -1, seq)
    v = {k: sd.var(k, a) for k, a in values.items()}
    x = sd.gather(v["emb"], tokens).permute(0, 2, 1)        # [N, E, T]
    out, _ = sd.rnn.gruLayer(x, v["W"], v["R"], v["b"])     # [N, H, T]
    h = out.permute(0, 2, 1).reshape(-1, hidden)
    logits = sd.nn.linear(h, v["Wo"], v["bo"]).reshape(-1, seq, vocab)
    logits.rename("logits")
    sd.loss.sparseSoftmaxCrossEntropy(logits.reshape(-1, vocab),
                                      labels.reshape(-1)).rename("loss")
    sd.setTrainingConfig(TrainingConfig(
        updater=Adam(1e-3), dataSetFeatureMapping=["tokens"],
        dataSetLabelMapping=["labels"]))
    return sd


def _launches(kernels, fn):
    """Run ``fn`` with the kernels' counters set to 0; returns (its result,
    {kernel: launches in it})."""
    for k in kernels:
        k.launches = 0
    res = fn()
    return res, {k.__name__: k.launches for k in kernels}


def _sd_lstm_check(torch, lstm):
    """A SameDiff lstmLayer graph at the LSTM char-RNN's width (x [32, 77,
    100], H = 256, forgetBias 1): output and calculateGradients on the
    card against the CPU, with rows 1-3's launches."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff

    n, i, t, hsz = 32, 77, 100, 256
    rng = np.random.default_rng(SEED + 5)
    vals = {"W": rng.normal(size=(i, 4 * hsz)) * i ** -0.5,
            "R": rng.normal(size=(hsz, 4 * hsz)) * hsz ** -0.5,
            "b": rng.normal(size=(4 * hsz,)) * 0.05}
    vals = {k: a.astype(np.float32) for k, a in vals.items()}
    x = rng.normal(size=(n, i, t)).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, size=(n, hsz, t)).astype(np.float32)

    def graph(device):
        sd = SameDiff(device=device)
        xp = sd.placeHolder("x", "float32", n, i, t)
        v = {k: sd.var(k, a) for k, a in vals.items()}
        out, _, _ = sd.rnn.lstmLayer(xp, v["W"], v["R"], v["b"],
                                     forgetBias=1.0, name="lstm")
        (out * sd.constant("weight", weight)).sum().markAsLoss()
        return sd

    gpu, cpu = graph(None), graph("cpu")
    kernels = (lstm.lstm_seq_infer, lstm.lstm_seq_fwd, lstm.lstm_seq_bwd)
    out_g, l_out = _launches(kernels, lambda: gpu.output({"x": x}, "lstm"))
    out_err = _abs_err(out_g["lstm"].torch().cpu(),
                       cpu.output({"x": x}, "lstm")["lstm"].torch())
    g_g, l_grad = _launches(kernels, lambda: gpu.calculateGradients(
        {"x": x}, "x", *vals))
    g_c = cpu.calculateGradients({"x": x}, "x", *vals)
    grad_err = max(_rel_err(g_g[k].torch().cpu(), g_c[k].torch())
                   for k in g_c)
    print(f"samediff lstm: x [{n}, {i}, {t}] H={hsz}: output card vs CPU "
          f"max|d| {out_err:.3e} (launches {l_out}); gradients w.r.t. x, W, "
          f"R, b max|d|/max {grad_err:.3e} (launches {l_grad})", flush=True)
    if out_err > KERNEL_TOL:
        fail(f"SameDiff lstmLayer output differs by {out_err:.3e}")
    if grad_err > GRAD_TOL:
        fail(f"SameDiff lstmLayer gradients differ by {grad_err:.3e}")
    if list(l_out.values()) != [1, 0, 0] or \
            list(l_grad.values()) != [0, 1, 1]:
        fail(f"SameDiff lstmLayer launches: output {l_out}, gradients "
             f"{l_grad}")


def samediff_phase(torch, gru, lstm):
    """The GRU char-RNN built as a SameDiff graph at full width (66/256/
    1024, T=100) from the GRU training phase's weights: its output against
    MultiLayerNetwork's on the card, gradients and 5 Adam fit steps on the
    card against the CPU, the graph served through InferenceSession (a
    request with ids outside the vocabulary among them), a save/load round
    trip, a control that must fail, and an lstmLayer graph. Returns the
    kernels' launches on the graph's main path: rows 4 and 6 in the fit
    steps, row 5 in serving."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.autodiff import SameDiff
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import (
        DEFAULT_BATCH_BUCKETS, BucketLadder)
    from deeplearning4j_tpu_torch.utils.convert import params_from_numpy

    vocab, seq, batch = 66, 100, 64
    conf = gru_char_rnn_conf(vocab=vocab, seq=seq)
    arrays, f, l = gru_char_rnn_data(conf, batch)
    values = {"emb": arrays[0]["W"], "W": arrays[1]["W"],
              "R": arrays[1]["R"], "b": arrays[1]["b"],
              "Wo": arrays[2]["W"], "bo": arrays[2]["b"]}
    tokens = f[:, 0, :].astype(np.float32)                   # [N, T]
    labels = l.argmax(axis=1).astype(np.float32)             # [N, T]
    feeds = {"tokens": tokens, "labels": labels}
    kernels = (gru.gru_seq_infer, gru.gru_seq_fwd, gru.gru_seq_bwd)
    gpu, cpu = samediff_char_rnn(values, None), \
        samediff_char_rnn(values, "cpu")
    if gpu.device.type != "cuda":
        fail(f"the SameDiff graph defaulted to {gpu.device}, not cuda")

    # the graph against the network of the same weights, both on the card
    net = MultiLayerNetwork(conf).init(params_from_numpy(conf, arrays,
                                                         gpu.device))
    want = net.output(f).torch()                             # [N, V, T]
    del net

    def probs(sd):
        logits = sd.output({"tokens": tokens}, "logits")["logits"].torch()
        return torch.softmax(logits, dim=-1).permute(0, 2, 1)

    got, l_out = _launches(kernels, lambda: probs(gpu))
    out_err = _abs_err(got, want)
    bad = samediff_char_rnn(dict(values, R=values["R"] + SD_PERTURB), None)
    ctl_err = _abs_err(probs(bad), want)
    del bad
    print(f"samediff: output vs MultiLayerNetwork.output on the card max|d| "
          f"{out_err:.3e} (launches {l_out}); control (R + {SD_PERTURB}) "
          f"max|d| {ctl_err:.3e}", flush=True)
    if out_err > PLAIN_TOL:
        fail(f"SameDiff graph vs network output {out_err:.3e} > "
             f"{PLAIN_TOL}")
    if ctl_err <= PLAIN_TOL:
        fail(f"the perturbed graph passed the output check ({ctl_err:.3e})")
    if list(l_out.values()) != [1, 0, 0]:
        fail(f"SameDiff output launches {l_out}, not one gru_seq_infer")

    names = list(values)
    g_g, l_grad = _launches(kernels, lambda: gpu.calculateGradients(
        feeds, *names))
    g_c = cpu.calculateGradients(feeds, *names)
    errs = {k: _rel_err(g_g[k].torch().cpu(), g_c[k].torch()) for k in names}
    print("samediff: gradients card vs CPU max|d|/max " + ", ".join(
        f"{k} {e:.3e}" for k, e in errs.items()) + f" (launches {l_grad})",
        flush=True)
    if max(errs.values()) > GRAD_TOL:
        fail(f"SameDiff gradients differ: {errs}")
    if list(l_grad.values()) != [0, 1, 1]:
        fail(f"SameDiff gradient launches {l_grad}")

    lr = gpu.trainingConfig.updater.learningRate
    h_g, l_fit = _launches(kernels, lambda: [
        gpu.fit([(tokens, labels)]).iterLosses[0] for _ in range(STEPS)])
    h_c = [cpu.fit([(tokens, labels)]).iterLosses[0] for _ in range(STEPS)]
    print(f"samediff: {STEPS} Adam fit steps, losses card {h_g}, CPU {h_c}; "
          f"launches {l_fit}", flush=True)
    worst_loss = max(abs(a - b) / abs(b) for a, b in zip(h_g, h_c))
    if worst_loss > TRAIN_LOSS_TOL:
        fail(f"SameDiff losses differ by {worst_loss:.3e} relative")
    if not h_g[-1] < h_g[0]:
        fail(f"the SameDiff loss did not fall: {h_g}")
    if list(l_fit.values()) != [0, STEPS, STEPS]:
        fail(f"SameDiff fit launches {l_fit}, not one forward and one "
             f"backward a step")
    _compare_leaves([(gpu._values[k], cpu._values[k],
                      *(sd._updater_state[m][k] for m in ("m", "v")
                        for sd in (gpu, cpu))) for k in names],
                    f"SameDiff {STEPS} fit steps", lr, STEPS)
    del cpu

    # save and load: outputs bit-equal, the next step equal
    tmp = tempfile.mkdtemp()
    gpu.save(tmp + "/char_rnn.sdz", saveUpdaterState=True)
    loaded = SameDiff.load(tmp + "/char_rnn.sdz", loadUpdaterState=True,
                           device=gpu.device)
    shutil.rmtree(tmp)
    same_out = np.array_equal(
        gpu.output({"tokens": tokens}, "logits")["logits"].toNumpy(),
        loaded.output({"tokens": tokens}, "logits")["logits"].toNumpy())
    step_a = gpu.fit([(tokens, labels)]).iterLosses[0]
    step_b = loaded.fit([(tokens, labels)]).iterLosses[0]
    param_d = max(float((gpu._values[k] - loaded._values[k]).abs().max())
                  for k in names)
    print(f"samediff: save/load on the card: outputs bit-equal {same_out}; "
          f"the next step's losses {step_a} / {step_b}, params max|d| "
          f"{param_d:.3e}", flush=True)
    if not same_out or step_a != step_b or param_d != 0.0:
        fail("the loaded SameDiff graph does not continue as the saved one")
    del loaded

    times = []
    for k in range(7):
        t0 = time.perf_counter()
        gpu.fit([(tokens, labels)])      # ends with the loss on the host
        if k >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)
    print(f"samediff: fit step time at N={batch} T={seq} H="
          f"{values['R'].shape[0]} vocab={vocab}: median {step_ms:.3f} ms "
          f"over {len(times)} steps (min {min(times):.3f}, max "
          f"{max(times):.3f})", flush=True)

    # serving: token ids [N, T] as float32, logits [N, T, V] back
    rng = np.random.default_rng(SEED + 4)

    def ids(n):
        return rng.integers(0, vocab, size=(n, seq)).astype(np.float32)

    requests = [ids(int(rng.integers(1, 5))) for _ in range(12)]
    requests.insert(6, ids(32))
    wild = ids(2)
    wild[0, :4] = [vocab, -1, -70, -200]   # -1 wraps to the last row
    requests.insert(4, wild)
    answers, warmed, dispatches, served, serve_s = _serve_burst(
        torch, "sd-gru", gpu, (seq,), requests,
        BucketLadder(DEFAULT_BATCH_BUCKETS), kernels,
        input_name="tokens", output_name="logits")
    print(f"samediff: served {len(requests)} requests "
          f"({sum(len(x) for x in requests)} rows) in {len(dispatches)} "
          f"dispatches {sorted(dispatches)}, {serve_s:.4f} s; warmup of "
          f"{len(warmed)} shapes; launches {served}", flush=True)
    if served["gru_seq_infer"] != len(warmed) + len(dispatches) or \
            served["gru_seq_fwd"] or served["gru_seq_bwd"]:
        fail(f"{served} launches for {len(warmed)} warmup and "
             f"{len(dispatches)} serving dispatches of the graph")
    worst = 0.0
    for x, y in zip(requests, answers):
        want = gpu.output({"tokens": x}, "logits")["logits"].toNumpy()
        if y.shape != (x.shape[0], seq, vocab):
            fail(f"served shape {y.shape} for request {x.shape}")
        if not np.array_equal(np.isnan(y), np.isnan(want)):
            fail("served NaN rows differ from sd.output's")
        if x is not wild and not np.isfinite(y).all():
            fail("a served answer holds a non-finite value")
        ok = ~np.isnan(want)
        worst = max(worst, float(np.abs(y[ok] - want[ok]).max()))
    nan_rows = int(np.isnan(answers[4]).all(axis=(1, 2)).sum())
    print(f"samediff: served vs sd.output max|d| {worst:.3e}; the request "
          f"with ids {wild[0, :4].tolist()} gave {nan_rows} NaN row(s), "
          f"as sd.output does", flush=True)
    if worst > SERVE_TOL:
        fail(f"served SameDiff rows vs sd.output {worst:.3e} > {SERVE_TOL}")
    if nan_rows != 1 or not np.isfinite(answers[4][1]).all():
        fail("the out-of-range request's rows are not NaN where expected")
    del gpu

    _sd_lstm_check(torch, lstm)
    return {"gru_seq_fwd": l_fit["gru_seq_fwd"],
            "gru_seq_bwd": l_fit["gru_seq_bwd"],
            "gru_seq_infer": served["gru_seq_infer"]}


# ---------------------------------------------------------------------------
# the op registry's later names on the card, and BERT-base imported from a
# TF GraphDef
# ---------------------------------------------------------------------------

def samediff_ops_phase(torch):
    """One case of each of the 88 names the registry took past the
    reference's line 1150 (the first case of each in
    tests/samediff_op_cases.py): the op on CUDA tensors against the same
    op on the CPU, to the CPU tests' tolerances (1e-5 of the largest
    element, 1e-4 for the linear algebra; svd, qr and lu by reconstruction
    and singular values, since cuSOLVER may choose other signs than
    LAPACK). The random ones by what they promise: randomShuffle a
    permutation of the rows, the noise layers the identity at inference
    and the CPU's moments in training."""
    import importlib.util
    from pathlib import Path

    from deeplearning4j_tpu_torch.autodiff import ops

    # by path: an installed package named "tests" may shadow the directory
    path = Path(__file__).resolve().parent / "tests" / "samediff_op_cases.py"
    spec = importlib.util.spec_from_file_location("samediff_op_cases", path)
    oc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oc)

    def on(v, dev):
        if isinstance(v, tuple):
            return tuple(on(a, dev) for a in v)
        return torch.from_numpy(np.array(v)).to(dev) if isinstance(
            v, (np.ndarray, np.generic)) else v

    def outs(v):
        return tuple(v) if isinstance(v, (tuple, list)) else (v,)

    t0 = time.perf_counter()
    seen, worst = set(), {}
    for name, variant, build, _ in oc.CASES:
        if name in seen:
            continue
        seen.add(name)
        inputs, attrs = oc.build(name, variant, build)
        kw = {"device": "cuda"} if name in ops.DEVICE_OPS else {}
        got = outs(ops.OPS[name](*[on(v, "cuda") for v in inputs], **attrs,
                                 **kw))
        want = outs(ops.OPS[name](*[on(v, "cpu") for v in inputs], **attrs))
        try:
            for g in got:
                if g.device.type != "cuda":
                    raise AssertionError(f"output on {g.device}")
            if name in ("svd", "qr", "lu"):
                oc.reconstructs(name, got, on(inputs[0], "cpu"),
                                oc.GRAD_TOL)
                continue
            tol = oc.GRAD_TOL if name in oc.LINALG else oc.FWD_TOL
            for k, (g, w) in enumerate(zip(got, want)):
                if g.dtype != w.dtype:
                    raise AssertionError(f"dtype {g.dtype} != {w.dtype}")
                oc.close(g, w, tol, f"{name} output {k}")
                w = w.double()
                fin = torch.isfinite(w)
                if fin.any():
                    d = (g.cpu().double() - w)[fin].abs().max()
                    worst[name] = float(d / max(float(w[fin].abs().max()),
                                                1e-30))
        except AssertionError as e:
            fail(f"op {name} on the card against the CPU: {e}")
    x = torch.arange(64.0, device="cuda").reshape(16, 4)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shuf = ops.OPS["randomShuffle"](x, generator=gen)
    if shuf.device.type != "cuda" or sorted(
            map(tuple, shuf.tolist())) != sorted(map(tuple, x.tolist())):
        fail("randomShuffle on the card is not a permutation of the rows")
    seen.add("randomShuffle")
    xs = torch.from_numpy(np.random.default_rng(SEED).normal(
        size=200000).astype(np.float32))
    for name, attrs in (("alphaDropout", {"p": 0.3}),
                        ("gaussianDropout", {"p": 0.2}),
                        ("gaussianNoise", {"stddev": 0.5})):
        a = ops.OPS[name](xs.to("cuda"), generator=gen, training=True,
                          **attrs).cpu().double()
        b = ops.OPS[name](xs, generator=torch.Generator().manual_seed(SEED),
                          training=True, **attrs).double()
        if abs(float(a.mean() - b.mean())) > 0.02 or \
                abs(float(a.std() / b.std()) - 1) > 0.02:
            fail(f"{name} on the card: moments {float(a.mean()):.4f}/"
                 f"{float(a.std()):.4f} against the CPU's "
                 f"{float(b.mean()):.4f}/{float(b.std()):.4f}")
    if len(seen) != 88:
        fail(f"the op phase ran {len(seen)} of the 88 later names")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    print(f"samediff ops: the 88 later names on the card against the CPU "
          f"in {time.perf_counter() - t0:.2f} s; largest max|d|/max "
          + ", ".join(f"{k} {v:.2e}" for k, v in top), flush=True)


class BertGraphBuilder:
    """tests/tf_bert_builder.py's BertGraphBuilder, written against the
    port's protobuf (that file imports the JAX package's): the frozen
    graph a TF BERT checkpoint freezes to — GatherV2 embeddings,
    BatchMatMulV2 projections, Mean/SquaredDifference/Rsqrt LayerNorm
    chains, erf-GELU, tied MLM head and an in-graph masked-LM loss — at any
    dims. It writes the same bytes as that builder for the same arguments
    (tests/test_torch_tf_import.py holds it to that)."""

    def __init__(self, vocab=30522, hidden=768, layers=12, heads=12,
                 ffn=3072, max_len=512, batch=2, seq=16, seed=0):
        from deeplearning4j_tpu_torch.modelimport import protobuf

        self.pb = protobuf
        self.f32 = protobuf.attr_type(np.float32)
        self.v, self.h, self.L = vocab, hidden, layers
        self.nh, self.f = heads, ffn
        self.hd = hidden // heads
        self.b, self.t = batch, seq
        self.max_len = max_len
        self.rng = np.random.default_rng(seed)
        self.nodes = []

    def _const(self, name, arr):
        arr = np.asarray(arr)
        return self.pb.NodeDef(name, "Const", [], {
            "dtype": self.pb.attr_type(arr.dtype),
            "value": self.pb.attr_tensor(arr)})

    def _ph(self, name, shape, dtype=np.float32):
        return self.pb.NodeDef(name, "Placeholder", [], {
            "dtype": self.pb.attr_type(dtype),
            "shape": self.pb.attr_shape(shape)})

    def n(self, name, op, inputs, attrs=None):
        self.nodes.append(self.pb.NodeDef(name, op, inputs, attrs or {}))
        return name

    def c(self, name, arr):
        self.nodes.append(self._const(name, arr))
        return name

    def w(self, name, shape, scale=0.02):
        return self.c(name, (self.rng.normal(size=shape) * scale)
                      .astype(np.float32))

    def ln(self, tag, x):
        """Frozen LayerNorm decomposition over the last axis."""
        h, F32, b_ = self.h, self.f32, self.pb.attr_b
        axes = self.c(f"{tag}/axes", np.array([2], np.int32))
        g = self.w(f"{tag}/gamma", (h,), 0.0)
        self.nodes[-1] = self._const(f"{tag}/gamma", np.ones(h, np.float32))
        be = self.c(f"{tag}/beta", np.zeros(h, np.float32))
        eps = self.c(f"{tag}/eps", np.float32(1e-12))
        mu = self.n(f"{tag}/mu", "Mean", [x, axes],
                    {"keep_dims": b_(True), "T": F32})
        sqd = self.n(f"{tag}/sqd", "SquaredDifference", [x, mu],
                     {"T": F32})
        var = self.n(f"{tag}/var", "Mean", [sqd, axes],
                     {"keep_dims": b_(True), "T": F32})
        veps = self.n(f"{tag}/veps", "AddV2", [var, eps], {"T": F32})
        rstd = self.n(f"{tag}/rstd", "Rsqrt", [veps], {"T": F32})
        xc = self.n(f"{tag}/xc", "Sub", [x, mu], {"T": F32})
        xn = self.n(f"{tag}/xn", "Mul", [xc, rstd], {"T": F32})
        xg = self.n(f"{tag}/xg", "Mul", [xn, g], {"T": F32})
        return self.n(f"{tag}/y", "AddV2", [xg, be], {"T": F32})

    def gelu(self, tag, x):
        F32 = self.f32
        r2 = self.c(f"{tag}/r2", np.float32(1.0 / np.sqrt(2.0)))
        half = self.c(f"{tag}/half", np.float32(0.5))
        one = self.c(f"{tag}/one", np.float32(1.0))
        xs = self.n(f"{tag}/xs", "Mul", [x, r2], {"T": F32})
        er = self.n(f"{tag}/erf", "Erf", [xs], {"T": F32})
        e1 = self.n(f"{tag}/e1", "AddV2", [er, one], {"T": F32})
        xh = self.n(f"{tag}/xh", "Mul", [x, half], {"T": F32})
        return self.n(f"{tag}/y", "Mul", [xh, e1], {"T": F32})

    def dense(self, tag, x, w_name, b_name):
        F32 = self.f32
        mm = self.n(f"{tag}/mm", "BatchMatMulV2", [x, w_name], {"T": F32})
        return self.n(f"{tag}/ba", "AddV2", [mm, b_name], {"T": F32})

    def layer(self, li, x):
        h, nh, hd = self.h, self.nh, self.hd
        b, t = self.b, self.t
        F32, b_ = self.f32, self.pb.attr_b
        tag = f"layer{li}"
        wq = self.w(f"{tag}/wq", (h, h))
        wk = self.w(f"{tag}/wk", (h, h))
        wv = self.w(f"{tag}/wv", (h, h))
        bq = self.c(f"{tag}/bq", np.zeros(h, np.float32))
        bk = self.c(f"{tag}/bk", np.zeros(h, np.float32))
        bv = self.c(f"{tag}/bv", np.zeros(h, np.float32))
        hs = self.c(f"{tag}/hshape", np.array([b, t, nh, hd], np.int32))
        ms = self.c(f"{tag}/mshape", np.array([b, t, h], np.int32))
        perm = self.c(f"{tag}/perm", np.array([0, 2, 1, 3], np.int32))
        scale = self.c(f"{tag}/scale", np.float32(1.0 / np.sqrt(hd)))

        def heads(pt, w, bias):
            d = self.dense(f"{tag}/{pt}", x, w, bias)
            r = self.n(f"{tag}/{pt}r", "Reshape", [d, hs], {"T": F32})
            return self.n(f"{tag}/{pt}t", "Transpose", [r, perm],
                          {"T": F32})

        q = heads("q", wq, bq)
        k = heads("k", wk, bk)
        v = heads("v", wv, bv)
        s0 = self.n(f"{tag}/s0", "BatchMatMulV2", [q, k],
                    {"adj_y": b_(True), "T": F32})
        s = self.n(f"{tag}/s", "Mul", [s0, scale], {"T": F32})
        p = self.n(f"{tag}/p", "Softmax", [s], {"T": F32})
        ctx = self.n(f"{tag}/ctx", "BatchMatMulV2", [p, v], {"T": F32})
        ctxt = self.n(f"{tag}/ctxt", "Transpose", [ctx, perm], {"T": F32})
        ctxm = self.n(f"{tag}/ctxm", "Reshape", [ctxt, ms], {"T": F32})
        wo = self.w(f"{tag}/wo", (h, h))
        bo = self.c(f"{tag}/bo", np.zeros(h, np.float32))
        att = self.dense(f"{tag}/out", ctxm, wo, bo)
        res1 = self.n(f"{tag}/res1", "AddV2", [x, att], {"T": F32})
        x1 = self.ln(f"{tag}/ln1", res1)

        wi = self.w(f"{tag}/wi", (h, self.f))
        bi = self.c(f"{tag}/bi", np.zeros(self.f, np.float32))
        wo2 = self.w(f"{tag}/wo2", (self.f, h))
        bo2 = self.c(f"{tag}/bo2", np.zeros(h, np.float32))
        up = self.dense(f"{tag}/ffn_in", x1, wi, bi)
        act = self.gelu(f"{tag}/gelu", up)
        down = self.dense(f"{tag}/ffn_out", act, wo2, bo2)
        res2 = self.n(f"{tag}/res2", "AddV2", [x1, down], {"T": F32})
        return self.ln(f"{tag}/ln2", res2)

    def build(self):
        b, t, h, v = self.b, self.t, self.h, self.v
        F32, b_ = self.f32, self.pb.attr_b
        self.nodes.append(self._ph("input_ids", [b, t], np.int32))
        self.nodes.append(self._ph("labels", [b, t], np.int32))

        tok = self.w("embeddings/tok", (v, h))
        pos_full = self.w("embeddings/pos_full", (self.max_len, h))
        self.c("embeddings/axis0", np.int32(0))
        emb = self.n("embeddings/lookup", "GatherV2",
                     [tok, "input_ids", "embeddings/axis0"], {"T": F32})
        begin = self.c("embeddings/begin", np.array([0, 0], np.int32))
        size = self.c("embeddings/size", np.array([t, h], np.int32))
        pos = self.n("embeddings/pos", "Slice",
                     [pos_full, begin, size], {"T": F32})
        ep = self.n("embeddings/sum", "AddV2", [emb, pos], {"T": F32})
        x = self.ln("embeddings/ln", ep)

        for li in range(self.L):
            x = self.layer(li, x)

        # tied MLM head: logits = x @ tok^T
        logits = self.n("mlm/logits", "BatchMatMulV2", [x, tok],
                        {"adj_y": b_(True), "T": F32})
        # in-graph loss: -mean(sum(onehot(labels) * log_softmax(logits)))
        lsm = self.n("mlm/lsm", "LogSoftmax", [logits], {"T": F32})
        self.c("mlm/depth", np.int32(v))
        self.c("mlm/on", np.float32(1.0))
        self.c("mlm/off", np.float32(0.0))
        oh = self.n("mlm/onehot", "OneHot",
                    ["labels", "mlm/depth", "mlm/on", "mlm/off"],
                    {"T": F32})
        prod = self.n("mlm/prod", "Mul", [lsm, oh], {"T": F32})
        ax2 = self.c("mlm/ax2", np.array([2], np.int32))
        tok_lp = self.n("mlm/tok_lp", "Sum", [prod, ax2],
                        {"keep_dims": b_(False), "T": F32})
        nll = self.n("mlm/nll", "Neg", [tok_lp], {"T": F32})
        axall = self.c("mlm/axall", np.array([0, 1], np.int32))
        self.n("loss", "Mean", [nll, axall],
               {"keep_dims": b_(False), "T": F32})
        return self.pb.GraphDef(self.nodes)


TF_BERT = dict(vocab=30522, hidden=768, layers=12, heads=12, ffn=3072,
               max_len=512)          # BERT-base, tests/tf_bert_builder.py's
TF_BERT_CHECK = (2, 16)   # (batch, seq) of the reference's own slow test
TF_BERT_TIMED = (32, 128)  # a usual fine-tuning shape
TF_BERT_LR = 1e-3
TF_BERT_LOSS_TOL = 1e-5   # relative: the loss and each of the 5 fit losses
TF_BERT_TOL = 1e-4        # of the largest element: logits, gradients
TF_BERT_PERTURB = 1e-3    # the control: one weight + this must fail
TF_BERT_REQUESTS = (1, 3, 8, 32, 2, 17, 5, 12, 1, 30)   # rows a request


def _tf_bert_feeds(batch, seq, seed):
    rng = np.random.default_rng(seed)
    v = TF_BERT["vocab"]
    return {"input_ids": rng.integers(0, v, (batch, seq)).astype(np.int32),
            "labels": rng.integers(0, v, (batch, seq)).astype(np.int32)}


def _tf_bert_train(sd):
    from deeplearning4j_tpu_torch.autodiff import TrainingConfig
    from deeplearning4j_tpu_torch.modelimport import TFGraphMapper
    from deeplearning4j_tpu_torch.optimize.updaters import Adam

    conv = TFGraphMapper.makeTrainable(sd)
    sd.setLossVariables("loss")
    sd.setTrainingConfig(TrainingConfig(
        updater=Adam(TF_BERT_LR), dataSetFeatureMapping=["input_ids"],
        dataSetLabelMapping=["labels"]))
    return conv


def _tf_bert_check(torch):
    """BERT-base imported at (2, 16) on the card and on the CPU from the
    same bytes: output, gradients, 5 Adam fit steps, a control that must
    fail, and a save/load round trip on the card that continues
    bit-equal."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.autodiff import SameDiff
    from deeplearning4j_tpu_torch.modelimport import TFGraphMapper

    b, t = TF_BERT_CHECK
    data = BertGraphBuilder(**TF_BERT, batch=b, seq=t,
                            seed=SEED).build().encode()
    gpu = TFGraphMapper.importGraph(data)
    cpu = TFGraphMapper.importGraph(data, device="cpu")
    del data
    if gpu.device.type != "cuda" or any(
            v.device.type != "cuda" for v in gpu._values.values()):
        fail("the imported graph did not land on the card")
    feeds = _tf_bert_feeds(b, t, SEED + 7)
    names = ("mlm/logits", "loss")
    og, oc = gpu.output(feeds, *names), cpu.output(feeds, *names)
    logits = oc["mlm/logits"].torch()
    scale = float(logits.abs().max())
    logit_err = _abs_err(og["mlm/logits"].torch().cpu(), logits) / scale
    loss_g, loss_c = (float(o["loss"].toNumpy()) for o in (og, oc))
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    # the control: one weight of the embedding row the first token reads
    tok = gpu._values["embeddings/tok"]
    row = int(feeds["input_ids"][0, 0])
    orig = tok[row, 0].clone()
    tok[row, 0] += TF_BERT_PERTURB
    ctl_err = _abs_err(gpu.output(feeds, "mlm/logits")[
        "mlm/logits"].torch().cpu(), logits) / scale
    tok[row, 0] = orig
    print(f"tf bert: BERT-base imported at (B, T) = ({b}, {t}): loss card "
          f"{loss_g:.7f}, CPU {loss_c:.7f} (|d|/loss {loss_err:.3e}, ln V "
          f"{math.log(TF_BERT['vocab']):.4f}); logits max|d|/max "
          f"{logit_err:.3e}; control (embeddings/tok[{row}, 0] + "
          f"{TF_BERT_PERTURB}) {ctl_err:.3e}", flush=True)
    if loss_err > TF_BERT_LOSS_TOL:
        fail(f"imported BERT loss differs by {loss_err:.3e} relative")
    if logit_err > TF_BERT_TOL:
        fail(f"imported BERT logits differ by {logit_err:.3e}")
    if ctl_err <= TF_BERT_TOL:
        fail(f"the perturbed graph passed the logits check ({ctl_err:.3e})")

    conv = _tf_bert_train(gpu)
    if conv != _tf_bert_train(cpu) or len(conv) < 8 * TF_BERT["layers"]:
        fail(f"makeTrainable converted {len(conv)} weights")
    gg = gpu.calculateGradients(feeds, *conv)
    gc = cpu.calculateGradients(feeds, *conv)
    top = max(float(gc[k].torch().abs().max()) for k in conv)
    grad_err = max(_abs_err(gg[k].torch().cpu(), gc[k].torch())
                   for k in conv) / top
    print(f"tf bert: gradients of {len(conv)} weights, card vs CPU max|d| / "
          f"the largest element {grad_err:.3e}", flush=True)
    if grad_err > TF_BERT_TOL:
        fail(f"imported BERT gradients differ by {grad_err:.3e}")
    del gg, gc

    batch = [(feeds["input_ids"], feeds["labels"])]
    h_g = [gpu.fit(batch).iterLosses[0] for _ in range(STEPS)]
    h_c = [cpu.fit(batch).iterLosses[0] for _ in range(STEPS)]
    worst = max(abs(a - c) / abs(c) for a, c in zip(h_g, h_c))
    print(f"tf bert: {STEPS} Adam({TF_BERT_LR}) fit steps, losses card "
          f"{h_g}, CPU {h_c}; max relative |d| {worst:.3e}", flush=True)
    if worst > TF_BERT_LOSS_TOL:
        fail(f"imported BERT fit losses differ by {worst:.3e} relative")
    if not h_g[-1] < h_g[0]:
        fail(f"the imported BERT's loss did not fall: {h_g}")
    del cpu

    tmp = tempfile.mkdtemp()
    try:
        gpu.save(tmp + "/bert.sdz", saveUpdaterState=True)
        loaded = SameDiff.load(tmp + "/bert.sdz", loadUpdaterState=True,
                               device=gpu.device)
    finally:
        shutil.rmtree(tmp)
    same_out = np.array_equal(
        gpu.output(feeds, "mlm/logits")["mlm/logits"].toNumpy(),
        loaded.output(feeds, "mlm/logits")["mlm/logits"].toNumpy())
    step_a = gpu.fit(batch).iterLosses[0]
    step_b = loaded.fit(batch).iterLosses[0]
    param_d = max(float((gpu._values[k] - loaded._values[k]).abs().max())
                  for k in conv)
    print(f"tf bert: save/load on the card: outputs bit-equal {same_out}; "
          f"the next step's losses {step_a} / {step_b}, params max|d| "
          f"{param_d:.3e}", flush=True)
    if not same_out or step_a != step_b or param_d != 0.0:
        fail("the loaded imported graph does not continue as the saved one")


def _tf_bert_timed(torch):
    """BERT-base imported at (32, 128) on the card: the import's phases
    timed, a fit step's time and its device time by kernel, then a burst
    of requests served through InferenceSession, padded to the imported
    batch, against sd.output."""
    from deeplearning4j_tpu_torch.modelimport import TFGraphMapper, protobuf
    from deeplearning4j_tpu_torch.serving import BucketLadder

    b, t = TF_BERT_TIMED
    t0 = time.perf_counter()
    gd = BertGraphBuilder(**TF_BERT, batch=b, seq=t, seed=SEED).build()
    t1 = time.perf_counter()
    data = gd.encode()
    del gd
    t2 = time.perf_counter()
    gd = protobuf.GraphDef.parse(data)
    t3 = time.perf_counter()
    sd = TFGraphMapper.importGraph(gd)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    n_nodes, n_bytes = len(gd.nodes), len(data)
    del gd, data
    print(f"tf bert: import of BERT-base at (B, T) = ({b}, {t}), {n_nodes} "
          f"nodes, {n_bytes / 1e6:.1f} MB: build {t1 - t0:.2f} s, encode "
          f"{t2 - t1:.2f} s, parse {t3 - t2:.2f} s, import {t4 - t3:.2f} s "
          f"({len(sd._ops)} ops)", flush=True)

    _tf_bert_train(sd)
    feeds = _tf_bert_feeds(b, t, SEED + 8)
    batch = [(feeds["input_ids"], feeds["labels"])]
    losses = []
    step_ms = time_ms(lambda: losses.append(sd.fit(batch).iterLosses[0]), 5)
    walls = []
    for _ in range(3):
        w0 = time.perf_counter()
        sd.fit(batch)
        walls.append((time.perf_counter() - w0) * 1e3)
    by_kernel = _device_by_kernel(torch, lambda: sd.fit(batch), n=2)
    device_ms = sum(ms for ms, _, _ in by_kernel)
    wall_ms = statistics.median(walls)
    idle = max(0.0, 1.0 - device_ms / wall_ms)
    tokens = b * t
    flops = 6.0 * tokens * (12 * (4 * 768 * 768 + 2 * 768 * 3072)
                            + 768 * TF_BERT["vocab"]) + 12 * 4.0 * 3 * \
        b * 12 * t * t * 64
    print(f"tf bert: fit step at (B, T) = ({b}, {t}): median {step_ms:.3f} "
          f"ms on CUDA events ({flops / step_ms / 1e9:.1f} TFLOP/s for "
          f"~{flops / 1e12:.2f} TFLOP), host wall {wall_ms:.3f} ms; losses "
          f"{[round(x, 5) for x in losses]}", flush=True)
    print(f"tf bert: device time of a step {device_ms:.3f} ms in "
          f"{sum(n for _, n, _ in by_kernel)} launches, idle share "
          f"{idle:.3f}; by kernel:", flush=True)
    for ms, n, name in by_kernel[:10]:
        print(f"  {ms:9.3f} ms  {n:5d}x  {name[:110]}", flush=True)
    # finite, not falling: at Adam(1e-3) BERT-base's loss on one repeated
    # batch swings (the (2, 16) check holds it against the CPU's)
    if not all(math.isfinite(x) for x in losses):
        fail(f"the imported BERT's timed fit losses: {losses}")

    rng = np.random.default_rng(SEED + 9)
    requests = [rng.integers(0, TF_BERT["vocab"], (n, t)).astype(np.int32)
                for n in TF_BERT_REQUESTS]
    answers, warmed, dispatches, _, serve_s = _serve_burst(
        torch, "tf-bert", sd, (t,), requests, BucketLadder([b]), (),
        input_name="input_ids", output_name="mlm/logits", dtype=np.int32)
    worst = 0.0
    for x, y in zip(requests, answers):
        padded = np.zeros((b, t), np.int32)
        padded[:len(x)] = x
        want = sd.output({"input_ids": padded}, "mlm/logits")[
            "mlm/logits"].toNumpy()[:len(x)]
        if y.shape != want.shape or not np.isfinite(y).all():
            fail(f"served shape {y.shape} (want {want.shape}) or a "
                 f"non-finite value")
        worst = max(worst, float(np.abs(y - want).max()
                                 / np.abs(want).max()))
    rows = sum(map(len, requests))
    print(f"tf bert: served {len(requests)} requests ({rows} rows of {t} "
          f"tokens) in {len(dispatches)} dispatches "
          f"{sorted(dispatches)}, {serve_s:.3f} s; warmup {warmed}; served "
          f"vs sd.output max|d|/max {worst:.3e}", flush=True)
    if worst > TF_BERT_LOSS_TOL:
        fail(f"served imported-BERT rows vs sd.output {worst:.3e}")
    return {"import_s": t4 - t3, "step_ms": step_ms, "idle": idle}


def tf_bert_phase(torch):
    """BERT-base (vocab 30522, hidden 768, 12 layers, 12 heads, FFN 3072,
    max_len 512, erf-GELU, tied MLM head, in-graph masked-LM loss) built
    as a frozen TF GraphDef in memory, encoded to bytes and imported
    through TFGraphMapper onto the card, at (2, 16) against the CPU and at
    (32, 128) timed and served. The graph runs on PyTorch's own ops (the
    attention is BatchMatMulV2 + Softmax in the graph, as the reference's
    import runs it on XLA's), so no kernel of rows 1-10 is on this path."""
    _tf_bert_check(torch)
    torch.cuda.empty_cache()
    res = _tf_bert_timed(torch)
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# the bidirectional LSTM classifier at Keras's IMDB widths
# ---------------------------------------------------------------------------

IMDB_VOCAB, IMDB_EMBED = 20000, 128
IMDB_EVAL_BATCHES, IMDB_RAGGED = 10, 17
TIE_TOL = 1e-5   # rows whose two probabilities are this close are ties
# the small SimpleRnn net: vocab, embedding, units, T, N
SIMPLE_RNN = (50, 16, 32, 20, 8)


def bilstm_imdb_conf():
    """Keras's "Bidirectional LSTM on IMDB" example at its widths in the
    port's DSL: Embedding(20000, 128), Bidirectional(LSTM(64)),
    LastTimeStep(Bidirectional(LSTM(64))), both concatenated, then a two-way
    softmax OutputLayer with MCXENT (DL4J's sentiment head, where Keras has
    Dense(1, sigmoid)); Adam(1e-3), token ids of maxlen 200."""
    from deeplearning4j_tpu_torch.nn import (
        LSTM, Bidirectional, EmbeddingSequenceLayer, InputType, LastTimeStep,
        NeuralNetConfiguration, OutputLayer)
    from deeplearning4j_tpu_torch.optimize import Adam

    t, _, h = IMDB_SHAPE
    return (NeuralNetConfiguration.Builder().seed(SEED).updater(Adam(1e-3))
            .list()
            .layer(EmbeddingSequenceLayer.Builder().nIn(IMDB_VOCAB)
                   .nOut(IMDB_EMBED).build())
            .layer(Bidirectional(LSTM.Builder().nOut(h).build(),
                                 mode=Bidirectional.CONCAT))
            .layer(LastTimeStep(Bidirectional(LSTM.Builder().nOut(h).build(),
                                              mode=Bidirectional.CONCAT)))
            .layer(OutputLayer.Builder().nOut(2).activation("softmax")
                   .lossFunction("mcxent").build())
            .setInputType(InputType.recurrent(1, t)).build())


def _random_group(shapes, rng):
    """Float32 arrays for a layer's param shapes (nested groups alike):
    matrices N(0, 1/min(rows, 128)), vectors N(0, 0.05^2)."""
    if isinstance(shapes, dict):
        return {k: _random_group(v, rng) for k, v in shapes.items()}
    scale = min(shapes[0], 128) ** -0.5 if len(shapes) == 2 else 0.05
    return (rng.normal(size=shapes) * scale).astype(np.float32)


def review_batch(rng, n, vocab=IMDB_VOCAB, t=IMDB_SHAPE[0]):
    """n reviews of token ids [n, 1, t] (int64) and one-hot sentiment
    labels [n, 2]."""
    return (rng.integers(0, vocab, size=(n, 1, t)),
            np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=n)])


def _worst_grad(torch, g_gpu, g_cpu):
    """max over layers of max |d| / max |want| of the layer's gradients."""
    from deeplearning4j_tpu_torch.tree_util import tree_leaves

    return max(_rel_err(torch.cat([g.cpu().reshape(-1)
                                   for g in tree_leaves(gg)]),
                        torch.cat([g.reshape(-1) for g in tree_leaves(gc)]))
               for gg, gc in zip(g_gpu, g_cpu) if gc)


def _imdb_sweep_check(torch, lstm):
    """Row 3 as the second layer's backward meets it: dhs zero except at
    the last step (LastTimeStep's gradient), dhT and dcT zero; against its
    plain version."""
    t, n, h = IMDB_SHAPE
    rng = np.random.default_rng([SEED, 5, t, n, h])

    def dev(*shape, scale=1.0):
        return torch.tensor((rng.normal(size=shape) * scale).astype(
            np.float32), device="cuda")

    xw, r = dev(t, n, 4 * h), dev(h, 4 * h, scale=0.1)
    # a forget-gate bias of 3 carries the gradient back to h0 and c0 (at
    # f ~ 0.5 it is denormal after 200 steps, where the kernel flushes)
    xw[:, :, h:2 * h] += 3.0
    h0, c0 = torch.zeros(n, h, device="cuda"), torch.zeros(n, h,
                                                           device="cuda")
    hs, gates, cs = lstm.lstm_seq_fwd(xw, r, h0, c0)
    dhs = torch.zeros_like(hs)
    dhs[-1] = dev(n, h)
    args = (dhs, torch.zeros_like(h0), torch.zeros_like(c0), gates, cs, hs,
            r, h0, c0)
    got = lstm.lstm_seq_bwd(*args)
    want = lstm.lstm_seq_bwd_reference(*args)
    err = max(_rel_err(a, e) for a, e in zip(got, want))
    print(f"bilstm: lstm_seq_bwd at {IMDB_SHAPE} with dhs only at the last "
          f"step: max|d|/max {err:.3e} (dxw, dR, dh0, dc0)", flush=True)
    if err > GRAD_TOL or not all(bool(torch.isfinite(a).all()) for a in got):
        fail(f"lstm_seq_bwd with a last-step dhs: {err:.3e} > {GRAD_TOL}")


def _evaluation_check(torch, gpu, cpu, sets, ev_gpu, ev_cpu):
    """The card's and the CPU's confusion matrices, equal but for rows
    whose two probabilities lie within TIE_TOL of a tie on either device;
    returns the number of such rows."""
    from deeplearning4j_tpu_torch.evaluation import Evaluation

    labels = np.concatenate([l for _, l in sets])
    out_g = np.concatenate([gpu.output(f).toNumpy() for f, _ in sets])
    out_c = np.concatenate([cpu.output(f).toNumpy() for f, _ in sets])
    worst = float(np.abs(out_g - out_c).max())
    if not np.isfinite(out_g).all() or out_g.shape != labels.shape:
        fail(f"bilstm outputs: shape {out_g.shape}, finite "
             f"{np.isfinite(out_g).all()}")
    if np.abs(out_g.sum(axis=1) - 1.0).max() > 1e-5:
        fail("bilstm softmax rows do not sum to 1")
    ties = ((np.abs(out_g[:, 0] - out_g[:, 1]) <= TIE_TOL)
            | (np.abs(out_c[:, 0] - out_c[:, 1]) <= TIE_TOL))
    differ = out_g.argmax(axis=1) != out_c.argmax(axis=1)
    print(f"bilstm evaluate: {len(labels)} rows, card vs CPU outputs "
          f"max|d| {worst:.3e}; {int(ties.sum())} rows within {TIE_TOL} of "
          f"a tie, {int(differ.sum())} whose class differs; accuracy card "
          f"{ev_gpu.accuracy():.6f} CPU {ev_cpu.accuracy():.6f}; confusion "
          f"card {ev_gpu.confusionMatrix().tolist()} CPU "
          f"{ev_cpu.confusionMatrix().tolist()}", flush=True)
    if worst > PLAIN_TOL:
        fail(f"bilstm outputs card vs CPU {worst:.3e} > {PLAIN_TOL}")
    if (differ & ~ties).any():
        fail(f"{int((differ & ~ties).sum())} rows away from a tie take "
             f"another class on the card")
    # evaluate (padded ragged batch) agrees with the rows taken one batch
    # at a time, and without the tie rows the two devices agree exactly
    for ev, out in ((ev_gpu, out_g), (ev_cpu, out_c)):
        if not np.array_equal(ev.confusionMatrix(), Evaluation(2).eval(
                labels, out).confusionMatrix()):
            fail("evaluate's confusion matrix is not that of its outputs")
    keep = ~ties
    cm_g = Evaluation(2).eval(labels[keep], out_g[keep]).confusionMatrix()
    cm_c = Evaluation(2).eval(labels[keep], out_c[keep]).confusionMatrix()
    if not np.array_equal(cm_g, cm_c):
        fail(f"confusion matrices without ties differ: {cm_g} vs {cm_c}")
    if ev_gpu.confusionMatrix().sum() != len(labels):
        fail("evaluate did not count every row")
    return int(ties.sum())


def _serializer_check(torch, gpu, x):
    """Write the trained net and restore it on the card: params, updater
    state and counters equal, ``output`` bit-equal."""
    import tempfile
    from pathlib import Path

    from deeplearning4j_tpu_torch.tree_util import tree_leaves
    from deeplearning4j_tpu_torch.utils import ModelSerializer

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "bilstm.zip")
        ModelSerializer.writeModel(gpu, path)
        size = Path(path).stat().st_size
        back = ModelSerializer.restoreMultiLayerNetwork(path)
    if back.device.type != "cuda":
        fail(f"restored on {back.device}")
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(back._params) + tree_leaves(back._opt_states),
        tree_leaves(gpu._params) + tree_leaves(gpu._opt_states)))
    bits = torch.equal(back.output(x).torch(), gpu.output(x).torch())
    print(f"bilstm: ModelSerializer zip {size} bytes, restored on the card: "
          f"params and Adam state equal {same}, iteration "
          f"{back.getIterationCount()}, output bit-equal {bits}", flush=True)
    if not (same and bits) or back.getIterationCount() != \
            gpu.getIterationCount():
        fail("the restored bidirectional net differs from the saved one")


def _simple_rnn_check(torch):
    """A small SimpleRnn net, Embedding -> SimpleRnn -> LastTimeStep(
    SimpleRnn) -> softmax, on the card against the CPU: output and 2 Adam
    steps."""
    from deeplearning4j_tpu_torch.nn import (
        EmbeddingSequenceLayer, InputType, LastTimeStep,
        NeuralNetConfiguration, OutputLayer, SimpleRnn)
    from deeplearning4j_tpu_torch.optimize import Adam

    vocab, embed, units, t, n = SIMPLE_RNN
    conf = (NeuralNetConfiguration.Builder().seed(SEED).updater(Adam(1e-3))
            .list()
            .layer(EmbeddingSequenceLayer.Builder().nIn(vocab).nOut(embed)
                   .build())
            .layer(SimpleRnn.Builder().nOut(units).build())
            .layer(LastTimeStep(SimpleRnn.Builder().nOut(units).build()))
            .layer(OutputLayer.Builder().nOut(2).activation("softmax")
                   .lossFunction("mcxent").build())
            .setInputType(InputType.recurrent(1, t)).build())
    rng = np.random.default_rng(SEED + 6)
    arrays = [_random_group(lr_.param_shapes(), rng) for lr_ in conf.layers]
    gpu, cpu = _net_pair(conf.to_json(), arrays)
    x, y = review_batch(rng, n, vocab, t)
    worst = float(np.abs(gpu.output(x).toNumpy()
                         - cpu.output(x).toNumpy()).max())
    losses = []
    for _ in range(2):
        gpu.fit(x, y)
        cpu.fit(x, y)
        losses.append((gpu.score(), cpu.score()))
    rel = max(abs(a - b) / abs(b) for a, b in losses)
    print(f"simple rnn: card vs CPU output max|d| {worst:.3e}; 2 Adam steps, "
          f"losses {losses} (max rel {rel:.3e})", flush=True)
    if worst > PLAIN_TOL or rel > TRAIN_LOSS_TOL:
        fail(f"SimpleRnn net card vs CPU: output {worst:.3e}, loss {rel:.3e}")
    _compare_trained(gpu, cpu, "SimpleRnn 2 fit steps",
                     conf.defaults["updater"].learningRate, 2)


def bilstm_phase(torch, lstm):
    """Train the bidirectional IMDB classifier at full width (vocab 20000,
    embedding 128, 64 units a direction, T=200, N=32, Adam(1e-3)) on the
    card and on the CPU from the same weights and batch, evaluate it on both
    over 10 batches of 32 and a ragged 17, refuse rnnTimeStep, round-trip
    it through ModelSerializer, and check a small SimpleRnn net. Returns
    the LSTM kernels' launches in the 5 fit steps and in the evaluation,
    and the times."""
    from deeplearning4j_tpu_torch.datasets import (
        DataSet, ListDataSetIterator)

    t0 = time.perf_counter()
    _imdb_sweep_check(torch, lstm)
    conf = bilstm_imdb_conf()
    lr = conf.defaults["updater"].learningRate
    rng = np.random.default_rng(SEED + 4)
    arrays = [_random_group(lr_.param_shapes(), rng) for lr_ in conf.layers]
    x, y = review_batch(rng, IMDB_SHAPE[1])
    gpu, cpu = _net_pair(conf.to_json(), arrays)
    print(f"bilstm: {gpu.numParams()} params; layers "
          f"{[type(lr_).__name__ for lr_ in conf.layers]}", flush=True)

    worst_g = _worst_grad(torch, gpu.gradients(x, y), cpu.gradients(x, y))
    print(f"bilstm: gradients card vs CPU max|d|/max per layer "
          f"{worst_g:.3e}", flush=True)
    if worst_g > GRAD_TOL:
        fail(f"bilstm gradients differ by {worst_g:.3e} > {GRAD_TOL}")

    # (a) STEPS fit steps: 4 forward and 4 backward launches a step
    kernels = (lstm.lstm_seq_infer, lstm.lstm_seq_fwd, lstm.lstm_seq_bwd)
    for fn in kernels:
        fn.launches = 0
    losses_gpu, per_step = [], []
    for _ in range(STEPS):
        before = [fn.launches for fn in kernels]
        gpu.fit(x, y)
        losses_gpu.append(gpu.score())
        per_step.append(tuple(fn.launches - k
                              for fn, k in zip(kernels, before)))
    fit_launches = {fn.__name__: fn.launches for fn in kernels}
    losses_cpu = []
    for _ in range(STEPS):
        cpu.fit(x, y)
        losses_cpu.append(cpu.score())
    print(f"bilstm train: {STEPS} Adam steps, losses card {losses_gpu}, CPU "
          f"{losses_cpu}; launches {fit_launches}", flush=True)
    if per_step != [(0, 4, 4)] * STEPS:
        fail(f"bilstm launches per fit step (infer, fwd, bwd): {per_step}")
    worst_loss = max(abs(a - b) / abs(b) for a, b in zip(losses_gpu,
                                                         losses_cpu))
    if worst_loss > TRAIN_LOSS_TOL:
        fail(f"bilstm losses differ by {worst_loss:.3e} relative")
    if not losses_gpu[-1] < losses_gpu[0]:
        fail(f"the bilstm loss did not fall: {losses_gpu}")
    _compare_trained(gpu, cpu, f"bilstm {STEPS} fit steps", lr, STEPS)

    # (b) evaluate 10 batches of 32 and a ragged 17 (padded to 32): 4
    # inference launches a batch
    sets = ([review_batch(rng, IMDB_SHAPE[1])
             for _ in range(IMDB_EVAL_BATCHES)]
            + [review_batch(rng, IMDB_RAGGED)])
    it = ListDataSetIterator([DataSet(f, l) for f, l in sets])
    for fn in kernels:
        fn.launches = 0
    ev_gpu = gpu.evaluate(it)
    eval_launches = {fn.__name__: fn.launches for fn in kernels}
    if eval_launches != {"lstm_seq_infer": 4 * len(sets),
                         "lstm_seq_fwd": 0, "lstm_seq_bwd": 0}:
        fail(f"bilstm evaluate launches over {len(sets)} batches: "
             f"{eval_launches}")
    ev_cpu = cpu.evaluate(it)
    n_ties = _evaluation_check(torch, gpu, cpu, sets, ev_gpu, ev_cpu)
    eval_times = []
    for _ in range(3):
        t1 = time.perf_counter()
        gpu.evaluate(it)
        torch.cuda.synchronize()
        eval_times.append((time.perf_counter() - t1) * 1e3 / len(sets))
    eval_ms = statistics.median(eval_times)
    print(f"bilstm evaluate: {len(sets)} batches, launches {eval_launches}; "
          f"{eval_ms:.3f} ms a batch (host clock, median of 3 passes: "
          f"{[round(v, 3) for v in eval_times]})", flush=True)

    # (c) no streaming through a Bidirectional layer
    try:
        gpu.rnnTimeStep(x[:, :, 0].astype(np.float32))
        fail("rnnTimeStep ran through a Bidirectional layer")
    except ValueError as e:
        if "Bidirectional" not in str(e):
            fail(f"rnnTimeStep raised {e!r}")
        print(f"bilstm: rnnTimeStep refused: {e}", flush=True)

    _serializer_check(torch, gpu, x)

    # (d) the step time, host clock and CUDA events, after a warm-up
    host, dev = [], []
    for k in range(12):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        start.record()
        gpu.fit(x, y)
        end.record()
        torch.cuda.synchronize()
        if k >= 2:
            host.append((time.perf_counter() - t1) * 1e3)
            dev.append(start.elapsed_time(end))
    step_ms, step_ev_ms = statistics.median(host), statistics.median(dev)
    print(f"bilstm train: step time at N={IMDB_SHAPE[1]} T={IMDB_SHAPE[0]} "
          f"H={IMDB_SHAPE[2]}x2 vocab={IMDB_VOCAB}: median {step_ms:.3f} ms "
          f"host clock (min {min(host):.3f}, max {max(host):.3f}), "
          f"{step_ev_ms:.3f} ms CUDA events, over {len(host)} steps",
          flush=True)
    del gpu, cpu

    _simple_rnn_check(torch)
    print(f"bilstm: phase {time.perf_counter() - t0:.2f} s", flush=True)
    return dict(fit=fit_launches, eval=eval_launches, step_ms=step_ms,
                step_ev_ms=step_ev_ms, eval_ms=eval_ms, ties=n_ties)


# ---------------------------------------------------------------------------
# the step route of the LSTM and GRU kernels (kernels/rnn_step.py)
# ---------------------------------------------------------------------------

# (cell, T, N, H): widths the persistent kernels refuse. The LSTM at
# TextGenerationLSTM(hidden=512)'s batch and at N=1, and at H=1024; the GRU
# at H=2048 at a training batch and at N=1.
STEP_SHAPES = [("lstm", 100, 32, 512), ("lstm", 100, 1, 512),
               ("lstm", 100, 64, 1024), ("gru", 100, 64, 2048),
               ("gru", 100, 1, 2048)]
# (kind, N, H): the char-RNNs' shapes, which keep the persistent kernels
PERSISTENT_SHAPES = [("lstm_infer", 32, 256), ("lstm_fwd", 32, 256),
                     ("lstm_bwd", 32, 256), ("lstm_fwd", 1024, 256),
                     ("lstm_bwd", 1024, 256), ("gru_infer", 1, 1024),
                     ("gru_infer", 64, 1024), ("gru_fwd", 64, 1024),
                     ("gru_bwd", 64, 1024)]
STEP_REPORT = {"lstm": (100, 32, 512), "gru": (100, 64, 2048)}
STEP_NAMES = {"lstm": ("lstm_step_infer", "lstm_step_fwd", "lstm_step_bwd"),
              "gru": ("gru_step_infer", "gru_step_fwd", "gru_step_bwd")}


def _device_by_kernel(torch, fn, n=3):
    """Device time a call by kernel of ``fn()`` (torch.profiler over n
    calls after one): [(ms, launches, kernel name)], largest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sorted(((e.self_device_time_total / n / 1e3, e.count // n, e.key)
                   for e in prof.key_averages()
                   if getattr(e, "self_device_time_total", 0) > 0),
                  reverse=True)


def step_sweep_ms(torch, cell, bwd_args, reps):
    """CUDA-event median of the step route's reverse sweep alone (its C
    entry: T+1 launches chained by programmatic dependent launch), without
    the dR pass that the backward wrapper runs after it."""
    from deeplearning4j_tpu_torch.kernels import build

    dhs, dhT = bwd_args[:2]
    t, n, h = dhs.shape
    g = 4 if cell == "lstm" else 3
    dxw = torch.empty((t, n, g * h), device=dhs.device)
    dh0 = torch.empty((n, h), device=dhs.device)
    if cell == "lstm":
        _, _, dcT, gates, cs, _, r, _, c0 = bwd_args
        args = [dhs, dhT, gates, cs, r, c0, dxw, dcT.clone(), dh0, t, n, h]
    else:
        _, _, ru, rzc, cand, hs, r, h0 = bwd_args
        args = [dhs, dhT, ru, rzc, cand, hs, r, h0, dxw, torch.empty_like(dxw),
                torch.empty_like(dh0), dh0, t, n, h]
    return time_ms(lambda: build.call("rnn_step", f"rnn_step_bwd_{cell}_f32",
                                      f"{cell} sweep", args, dhs.device),
                   reps)


def step_route_phase(torch, lstm, gru, rnn_step):
    """The step-route kernels vs the plain versions at every STEP_SHAPES
    row, through the public wrappers (lstm_seq_*, gru_seq_*), which must
    choose the step route there by shape; the launch plans as the source
    gives them against their Python mirror (rnn_step.step_plan); the
    backward's determinism; times of each kernel (single calls and back to
    back), its plain version and cuDNN's layer; at the report shapes each
    call's device time by kernel, the backward's reverse sweep apart from
    its dR pass."""
    names = STEP_NAMES["lstm"] + STEP_NAMES["gru"]
    rows = {name: {} for name in names}
    errs = dict.fromkeys(names, 0.0)
    dev_ = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev_).multi_processor_count
    for kind, n, h in PERSISTENT_SHAPES:
        if not rnn_step.takes_persistent(kind, n, h, dev_):
            fail(f"{kind} N={n} H={h}: the step route was chosen where the "
                 f"persistent kernel launched before")
    for cell, t, n, h in STEP_SHAPES:
        g = 4 if cell == "lstm" else 3
        mod = lstm if cell == "lstm" else gru
        for kind in rnn_step.STEP_KINDS:
            mirror = rnn_step.step_plan(cell, kind, n, h, sms)
            source = rnn_step.step_source_plan(cell, kind, n, h, sms, dev_)
            if mirror != source:
                fail(f"{cell} {kind} N={n} H={h}: the source's step plan "
                     f"{source} differs from its mirror {mirror}")
            print(f"{cell}_step_{kind} plan N={n} H={h}: {source}",
                  flush=True)
        rng = np.random.default_rng([SEED, 9, g, t, n, h])

        def dev(*shape, scale=1.0):
            return torch.tensor((rng.normal(size=shape) * scale).astype(
                np.float32), device="cuda")

        x = dev(t, n, h)
        w, r = dev(h, g * h, scale=h ** -0.5), dev(h, g * h, scale=h ** -0.5)
        b = dev(g * h, scale=0.1)
        h0, c0, rb = dev(n, h, scale=0.2), dev(n, h, scale=0.2), \
            dev(g * h, scale=0.1)
        dhs, dhT, dcT = dev(t, n, h), dev(n, h), dev(n, h)
        xw = torch.matmul(x, w) + b
        route = {k: rnn_step.takes_persistent(f"{cell}_{k}", n, h, dev_)
                 for k in ("infer", "fwd", "bwd")}
        if any(route.values()):
            fail(f"{cell} T={t} N={n} H={h}: the persistent route was "
                 f"chosen {route}; this shape must take the step route")
        steps = [getattr(rnn_step, name) for name in STEP_NAMES[cell]]
        persist = [getattr(mod, f"{cell}_seq_{k}")
                   for k in ("infer", "fwd", "bwd")]
        before = [fn.launches for fn in steps + persist]
        state = (h0, c0) if cell == "lstm" else (rb, h0)
        with torch.no_grad():
            got_i = persist[0](xw, r, *state)
        got_f = persist[1](xw, r, *state)
        if cell == "lstm":
            hs, gates, cs = got_f
            bwd_args = (dhs, dhT, dcT, gates, cs, hs, r, h0, c0)
        else:
            hs, ru, rzc, cand = got_f
            bwd_args = (dhs, dhT, ru, rzc, cand, hs, r, h0)
        got_b = persist[2](*bwd_args)
        torch.cuda.synchronize()
        after = [fn.launches for fn in steps + persist]
        if after != [k + 1 for k in before[:3]] + before[3:]:
            fail(f"{cell} T={t} N={n} H={h}: launches (step route, then "
                 f"persistent) went {before} -> {after}")
        want_i = getattr(mod, f"{cell}_seq_infer_reference")(xw, r, *state)
        want_f = getattr(mod, f"{cell}_seq_fwd_reference")(xw, r, *state)
        want_b = getattr(mod, f"{cell}_seq_bwd_reference")(*bwd_args)
        if not all(bool(torch.isfinite(a).all())
                   for a in (*got_i, *got_f, *got_b)):
            fail(f"non-finite step-route output at {cell} {(t, n, h)}")
        err_i = max(float((a - e).abs().max()) for a, e in zip(got_i, want_i))
        err_f = max(float((a - e).abs().max()) for a, e in zip(got_f, want_f))
        rel_b = max(_rel_err(a, e) for a, e in zip(got_b, want_b))
        err_b = max(float((a - e).abs().max()) for a, e in zip(got_b, want_b))
        if max(err_i, err_f) > KERNEL_TOL:
            fail(f"{cell} step route vs plain max|d|={max(err_i, err_f):.3e}"
                 f" > {KERNEL_TOL} at {(t, n, h)}")
        if rel_b > GRAD_TOL:
            fail(f"{cell} step backward vs plain max|d|/max={rel_b:.3e} > "
                 f"{GRAD_TOL} at {(t, n, h)}")
        again = persist[2](*bwd_args)
        if not all(torch.equal(a, e) for a, e in zip(again, got_b)):
            fail(f"{cell} step backward gave other bits on a second run at "
                 f"{(t, n, h)}")
        for name, err in zip(STEP_NAMES[cell], (err_i, err_f, err_b)):
            errs[name] = max(errs[name], err)

        layer = (torch.nn.LSTM if cell == "lstm" else torch.nn.GRU)(h, h)
        layer = layer.cuda()
        with torch.no_grad():
            layer.weight_ih_l0.copy_(w.t())
            layer.weight_hh_l0.copy_(r.t())
            layer.bias_ih_l0.copy_(b)
            layer.bias_hh_l0.copy_(rb if cell == "gru" else 0 * b)
        hc = (h0[None], c0[None]) if cell == "lstm" else h0[None]
        with torch.inference_mode():
            cudnn_err = float((layer(x, hc)[0] - got_i[0]).abs().max())
        if cudnn_err > KERNEL_TOL:
            fail(f"{cell} step route vs cuDNN max|d|={cudnn_err:.3e} at "
                 f"{(t, n, h)}")
        x_g = x.clone().requires_grad_()
        wrt = [x_g, *layer.parameters()]

        def lib_fwd():
            return layer(x_g, hc)[0]

        lib_hs = lib_fwd()
        plain = [getattr(mod, f"{cell}_seq_{k}_reference")
                 for k in ("infer", "fwd", "bwd")]
        reps, plain_reps = 10, 3
        with torch.inference_mode():
            i_ms = time_ms(lambda: persist[0](xw, r, *state), reps)
            pi_ms = time_ms(lambda: plain[0](xw, r, *state), plain_reps)
            li_ms = time_ms(lambda: layer(x, hc), reps)
            ib_ms = time_b2b_ms(lambda: persist[0](xw, r, *state), 10)
            lib_b_ms = time_b2b_ms(lambda: layer(x, hc), 10)
        f_ms = time_ms(lambda: persist[1](xw, r, *state), reps)
        b_ms = time_ms(lambda: persist[2](*bwd_args), reps)
        fb_ms = time_b2b_ms(lambda: persist[1](xw, r, *state), 10)
        bb_ms = time_b2b_ms(lambda: persist[2](*bwd_args), 10)
        pf_ms = time_ms(lambda: plain[1](xw, r, *state), plain_reps)
        pb_ms = time_ms(lambda: plain[2](*bwd_args), plain_reps)
        lf_ms = time_ms(lib_fwd, reps)
        lbwd = lambda: torch.autograd.grad(  # noqa: E731
            lib_hs, wrt, dhs, retain_graph=True)
        lb_ms = time_ms(lbwd, reps)
        lfb_ms, lbb_ms = time_b2b_ms(lib_fwd, 10), time_b2b_ms(lbwd, 10)
        del lib_hs
        bounds = ((lstm_bound, fwd_bound, bwd_bound) if cell == "lstm" else
                  (gru_infer_bound, gru_fwd_bound, gru_bwd_bound))
        for name, ms, b2b, p_ms, l_ms, l_b2b, bound, err, lib in zip(
                STEP_NAMES[cell], (i_ms, f_ms, b_ms), (ib_ms, fb_ms, bb_ms),
                (pi_ms, pf_ms, pb_ms), (li_ms, lf_ms, lb_ms),
                (lib_b_ms, lfb_ms, lbb_ms), (bd(t, n, h) for bd in bounds),
                (f"{err_i:.3e}", f"{err_f:.3e}",
                 f"{err_b:.3e} ({rel_b:.3e} of the largest)"),
                ("layer", "training forward", "autograd backward")):
            rows[name][(t, n, h)] = dict(ms=ms, plain_ms=p_ms,
                                         library_ms=l_ms, bound_ms=bound[0],
                                         bound_by=bound[1])
            print(f"{name} T={t} N={n} H={h} (step route): max|d| {err}; "
                  f"kernel {ms:.4f} ms (back to back {b2b:.4f}), plain "
                  f"{p_ms:.4f} ms, cuDNN {cell.upper()} {lib} {l_ms:.4f} ms "
                  f"(back to back {l_b2b:.4f}), bound {bound[0]:.4f} ms "
                  f"({bound[1]})", flush=True)
        if (t, n, h) != STEP_REPORT[cell]:
            continue
        # device time by kernel; the backward's sweep apart from its dR
        # pass. The step kernels' launches overlap (each next step's blocks
        # start while this one runs, and wait), so the profiler's sum of
        # their times exceeds the time they take: the sweep is also timed
        # alone, with CUDA events through its C entry.
        calls = [lambda: persist[0](xw, r, *state),
                 lambda: persist[1](xw, r, *state),
                 lambda: persist[2](*bwd_args)]
        sweep_ms = step_sweep_ms(torch, cell, bwd_args, reps)
        for name, fn in zip(STEP_NAMES[cell], calls):
            with torch.no_grad():
                split = _device_by_kernel(torch, fn)
            if not split:
                print(f"{name} T={t} N={n} H={h}: no device time in the "
                      f"trace: not measured", flush=True)
                continue
            steps = sum(ms for ms, _, key in split if "step_" in key)
            dr = sum(ms for ms, _, key in split if "_bwd_dr_" in key)
            alone = (f"; the sweep alone {sweep_ms:.4f} ms (CUDA events)"
                     if name.endswith("bwd") else "")
            print(f"{name} T={t} N={n} H={h} device by kernel: step kernels "
                  f"{steps:.4f} ms (launches overlapping), dR pass {dr:.4f} "
                  f"ms{alone}; " + "; ".join(
                      f"{key[:56]} x{cnt} {ms:.4f}" for ms, cnt, key in
                      split[:4]), flush=True)
    return rows, errs


def _serve_burst(torch, name, model, example_shape, requests, ladder,
                 counters, **register_kw):
    """Serve ``requests`` through a fresh InferenceSession (ladder warmup
    first; ``register_kw`` such as a SameDiff graph's input_name and
    output_name go to ``register``); returns (answers, warmed shapes,
    dispatch shapes, the counters' launches over warmup and burst,
    seconds of the burst)."""
    from deeplearning4j_tpu_torch.serving import InferenceSession

    for fn in counters:
        fn.launches = 0
    session = InferenceSession()
    entry = session.register(name, model, example_shape=example_shape,
                             warmup=True, ladder=ladder, **register_kw)
    dispatches = []
    infer = entry.servable.infer

    def counting_infer(x):
        dispatches.append(x.shape)
        return infer(x)

    entry.servable.infer = counting_infer
    t0 = time.perf_counter()
    futures = [session.predict_async(name, x) for x in requests]
    answers = [fu.result(timeout=600) for fu in futures]
    serve_s = time.perf_counter() - t0
    session.close()
    launches = {fn.__name__: fn.launches for fn in counters}
    return (answers, entry.servable.warmed_shapes, dispatches, launches,
            serve_s)


def wide_rnn_phase(torch, lstm, gru, rnn_step):
    """TextGenerationLSTM(hidden=512) and a GRU(2048) char-RNN, the widths
    the persistent kernels refuse: each serves one burst through
    InferenceSession and takes one fit step on the card, against the same
    on the CPU (the plain versions); every launch must take the step
    route. Returns the step-route kernels' launches in these main paths."""
    from deeplearning4j_tpu_torch.models.zoo import TextGenerationLSTM
    from deeplearning4j_tpu_torch.serving import (
        DEFAULT_BATCH_BUCKETS, BucketLadder)

    counters = [getattr(rnn_step, n) for n in
                STEP_NAMES["lstm"] + STEP_NAMES["gru"]] + [
        lstm.lstm_seq_infer, lstm.lstm_seq_fwd, lstm.lstm_seq_bwd,
        gru.gru_seq_infer, gru.gru_seq_fwd, gru.gru_seq_bwd]
    launches = {}
    vocab, seq = 77, 100
    lstm_conf = TextGenerationLSTM(vocabSize=vocab, hidden=512,
                                   seqLength=seq).conf()
    gru_conf = gru_char_rnn_conf(hidden=2048)
    for cell, conf, batch in (("lstm", lstm_conf, 32), ("gru", gru_conf,
                                                        16)):
        rng = np.random.default_rng([SEED, 11, batch])
        arrays = [{k: (rng.normal(size=sh) * (sh[0] ** -0.5 if len(sh) == 2
                                              else 0.05)).astype(np.float32)
                   for k, sh in lr_.param_shapes().items()}
                  for lr_ in conf.layers]
        v = conf.layers[-1].nOut
        if cell == "lstm":
            f, l = next_char_batch(rng, batch, v, seq)
            requests = [one_hot_batch(rng, n, v, seq) for n in (1, 3, 8)]
            shape = (v, seq)
        else:
            f, l = token_batch(rng, batch, v, seq)
            requests = [rng.integers(0, v, size=(n, 1, seq)).astype(
                np.float32) for n in (1, 3, 8)]
            shape = (1, seq)
        gpu, cpu = _net_pair(conf.to_json(), arrays)
        answers, warmed, dispatches, served, serve_s = _serve_burst(
            torch, f"{cell}-wide", gpu, shape, requests,
            BucketLadder(DEFAULT_BATCH_BUCKETS[:4]), counters)
        worst = 0.0
        for x, y in zip(requests, answers):
            if y.shape != (x.shape[0], v, seq) or not np.isfinite(y).all():
                fail(f"{cell} wide: answer {y.shape} for {x.shape}")
            worst = max(worst, float(np.abs(
                y - gpu.output(x).toNumpy()).max()))
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        gpu.fit(f, l)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fitted = {fn.__name__: fn.launches for fn in counters}
        cpu.fit(f, l)
        rel = abs(gpu.score() - cpu.score()) / abs(cpu.score())
        h = conf.layers[1 if cell == "gru" else 0].nOut
        print(f"wide {cell.upper()} H={h}: warmup {len(warmed)} shapes, "
              f"{len(requests)} requests in {len(dispatches)} dispatches "
              f"{serve_s:.4f} s, served vs net.output max|d| {worst:.3e}; "
              f"launches serving {served}, fit step {fitted}; fit step "
              f"{fit_s:.4f} s (the net's first, host clock); fit loss card "
              f"{gpu.score()} CPU {cpu.score()} (rel {rel:.3e})", flush=True)
        names = STEP_NAMES[cell]
        n_layers = 2 if cell == "lstm" else 1
        n_disp = len(warmed) + len(dispatches)
        want_serve = {names[0]: n_layers * n_disp}
        want_fit = {names[1]: n_layers, names[2]: n_layers}
        for got, want in ((served, want_serve), (fitted, want_fit)):
            if {k: c for k, c in got.items() if c} != want:
                fail(f"{cell} wide launches {got}, want only {want}")
        if worst > SERVE_TOL:
            fail(f"{cell} wide: served vs net.output {worst:.3e}")
        if rel > TRAIN_LOSS_TOL:
            fail(f"{cell} wide: fit losses differ by {rel:.3e}")
        _compare_trained(gpu, cpu, f"wide {cell} fit step",
                         conf.defaults["updater"].learningRate, 1)
        for name in names:
            launches[name] = served.get(name, 0) + fitted.get(name, 0)
    return launches


# ---------------------------------------------------------------------------
# row 7: flash attention, and BERT-base served and trained
# ---------------------------------------------------------------------------

# (B, H, T, D): the BERT-base path (16, 12, 512, 64), one request, a long
# sequence, a ragged T and the other head size
FLASH_SHAPES = [(16, 12, 512, 64), (1, 12, 512, 64), (2, 4, 2048, 64),
                (2, 2, 200, 64), (1, 2, 256, 128)]
FLASH_REPORT = (16, 12, 512, 64)
FLASH_NAMES = ("flash_fwd", "flash_attention_infer", "flash_bwd_dkv",
               "flash_bwd_dq")
# relative to each output's largest element. float32: another summation
# order over T keys (forward) or T queries (dk, dv). bfloat16: o, dq, dk
# and dv are written in bf16 (2^-8 relative), and p is rounded before p.v
# at each key tile's running max, where the plain version rounds it once
# at the row's final max.
FLASH_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-2, 2e-2)}
PEAK_BF16 = 989e12   # H100 SXM dense bf16 tensor rate (NVIDIA data sheet)


def flash_bounds(shape, dtype_name):
    """(name -> (bound ms, what bounds it)) for the four flash kernels:
    each input read once, each output written once, against the
    operations each function needs (4 B H T^2 D for the forward; 8 for dk
    and dv, which recompute s and dp; 6 for dq), at the bf16 tensor rate
    for bf16 and the plain f32 rate for f32."""
    b, h, t, d = shape
    el = 2 if dtype_name == "bfloat16" else 4
    peak = PEAK_BF16 if dtype_name == "bfloat16" else PEAK_F32
    x = b * h * t * d * el      # one [B, H, T, D] tensor
    row = b * h * t * 4         # one [B, H, T] f32 tensor
    work = b * h * t * t * d
    out = {}
    for name, nbytes, ops in (
            ("flash_fwd", 4 * x + 2 * row, 4 * work),
            ("flash_attention_infer", 4 * x, 4 * work),
            ("flash_bwd_dkv", 7 * x + 3 * row, 8 * work),
            ("flash_bwd_dq", 5 * x + 3 * row, 6 * work)):
        by_bytes, by_ops = nbytes / PEAK_BYTES, ops / peak
        out[name] = (max(by_bytes, by_ops) * 1e3,
                     "bytes" if by_bytes >= by_ops else "operations")
    return out


def flash_phase(torch, flash):
    """The flash kernels vs their plain versions at every FLASH_SHAPES row
    in float32 and bfloat16 (checked relative to each output's largest
    element, FLASH_TOL; the largest absolute differences are returned);
    m, l and di too; the backward's determinism; the forward's and the
    backward's launch plans as the source gives them against their Python
    mirrors; times of each kernel, its plain version and SDPA (the
    yardstick, never called by the port), and at the report shape in bf16
    the kernels' and SDPA's forward and backward back-to-back times too."""
    import torch.nn.functional as F

    rows = {name: {} for name in FLASH_NAMES}
    errs = dict.fromkeys(FLASH_NAMES, 0.0)
    fns = [getattr(flash, name) for name in FLASH_NAMES]
    for shape in FLASH_SHAPES:
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            at = (shape[0] * shape[1], shape[2], shape[3], dtype)
            plan = flash.fwd_source_plan(*at)
            if plan != flash.fwd_plan(*at):
                fail(f"flash forward plan at {shape} {dname}: the source "
                     f"gives {plan}, the mirror {flash.fwd_plan(*at)}")
            for which in flash.BWD_WHICH:
                bplan = flash.bwd_source_plan(which, *at)
                if bplan != flash.bwd_plan(which, *at):
                    fail(f"flash {which} plan at {shape} {dname}: the "
                         f"source gives {bplan}, the mirror "
                         f"{flash.bwd_plan(which, *at)}")
            rng = np.random.default_rng([SEED, 7, *shape])
            q, k, v, do = (torch.tensor(rng.normal(size=shape).astype(
                np.float32), device="cuda").to(dtype) for _ in range(4))
            scale = 1.0 / math.sqrt(shape[-1])
            before = [fn.launches for fn in fns]
            o, m, l = flash.flash_fwd(q, k, v, scale)
            oi = flash.flash_attention_infer(q, k, v, scale)
            dk, dv, di = flash.flash_bwd_dkv(q, k, v, o, do, m, l, scale)
            dq = flash.flash_bwd_dq(q, k, v, do, m, l, di, scale)
            torch.cuda.synchronize()
            if [fn.launches for fn in fns] != [c + 1 for c in before]:
                fail(f"flash launch counters did not rise at {shape}")
            ro, rm, rl = flash.flash_fwd_reference(q, k, v, scale)
            rdq, rdk, rdv = flash.flash_bwd_reference(q, k, v, o, do, m, l,
                                                      scale)
            if not all(bool(torch.isfinite(a).all())
                       for a in (o, m, l, oi, dk, dv, di, dq)):
                fail(f"non-finite flash output at {shape} {dname}")
            tol_f, tol_b = FLASH_TOL[dname]
            e = {"flash_fwd": max(_rel_err(o.float(), ro.float()),
                                  _rel_err(m, rm), _rel_err(l, rl)),
                 "flash_attention_infer": _rel_err(oi.float(), ro.float()),
                 "flash_bwd_dkv": max(
                     _rel_err(dk.float(), rdk.float()),
                     _rel_err(dv.float(), rdv.float()),
                     _rel_err(di, flash.flash_di_reference(o, do))),
                 "flash_bwd_dq": _rel_err(dq.float(), rdq.float())}
            absolute = {
                "flash_fwd": max(_abs_err(o, ro), _abs_err(m, rm),
                                 _abs_err(l, rl)),
                "flash_attention_infer": _abs_err(oi, ro),
                "flash_bwd_dkv": max(_abs_err(dk, rdk), _abs_err(dv, rdv),
                                     _abs_err(di, flash.flash_di_reference(
                                         o, do))),
                "flash_bwd_dq": _abs_err(dq, rdq)}
            for name, err in e.items():
                tol = tol_f if name in FLASH_NAMES[:2] else tol_b
                if err > tol:
                    fail(f"{name} vs plain max|d|/max={err:.3e} > {tol} at "
                         f"{shape} {dname}")
                errs[name] = max(errs[name], absolute[name])
            dk2, dv2, di2 = flash.flash_bwd_dkv(q, k, v, o, do, m, l, scale)
            dq2 = flash.flash_bwd_dq(q, k, v, do, m, l, di2, scale)
            if not all(torch.equal(a, b) for a, b in
                       ((dk, dk2), (dv, dv2), (di, di2), (dq, dq2))):
                fail(f"flash backward gave other bits on a second run at "
                     f"{shape} {dname}")

            qg, kg, vg = (a.clone().requires_grad_() for a in (q, k, v))
            o_sdpa = F.scaled_dot_product_attention(qg, kg, vg)
            sdpa_err = _rel_err(o_sdpa.detach().float(), ro.float())
            reps = 10
            t_k = {
                "flash_fwd": time_ms(lambda: flash.flash_fwd(q, k, v, scale),
                                     reps),
                "flash_attention_infer": time_ms(
                    lambda: flash.flash_attention_infer(q, k, v, scale),
                    reps),
                "flash_bwd_dkv": time_ms(lambda: flash.flash_bwd_dkv(
                    q, k, v, o, do, m, l, scale), reps),
                "flash_bwd_dq": time_ms(lambda: flash.flash_bwd_dq(
                    q, k, v, do, m, l, di, scale), reps)}
            p_fwd = time_ms(lambda: flash.flash_fwd_reference(q, k, v,
                                                              scale), 3)
            p_inf = time_ms(lambda: flash.flash_attention_reference(
                q, k, v, scale), 3)
            p_bwd = time_ms(lambda: flash.flash_bwd_reference(
                q, k, v, o, do, m, l, scale), 3)
            with torch.inference_mode():
                l_fwd = time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v), reps)
            l_bwd = time_ms(lambda: torch.autograd.grad(
                o_sdpa, (qg, kg, vg), do, retain_graph=True), reps)
            bounds = flash_bounds(shape, dname)
            plain = {"flash_fwd": p_fwd, "flash_attention_infer": p_inf,
                     "flash_bwd_dkv": p_bwd, "flash_bwd_dq": p_bwd}
            lib = {"flash_fwd": l_fwd, "flash_attention_infer": l_fwd,
                   "flash_bwd_dkv": l_bwd, "flash_bwd_dq": None}
            for name in FLASH_NAMES:
                rows[name][(shape, dname)] = dict(
                    ms=t_k[name], plain_ms=plain[name],
                    library_ms=lib[name], bound_ms=bounds[name][0],
                    bound_by=bounds[name][1])
            b2b = ""
            if (shape, dname) == (FLASH_REPORT, "bfloat16"):
                with torch.inference_mode():
                    b2b = "; back to back " + ", ".join(
                        f"{label} {time_b2b_ms(fn):.4f}" for label, fn in (
                            ("fwd", lambda: flash.flash_fwd(q, k, v, scale)),
                            ("infer", lambda: flash.flash_attention_infer(
                                q, k, v, scale)),
                            ("SDPA fwd", lambda:
                             F.scaled_dot_product_attention(q, k, v)),
                            ("dkv", lambda: flash.flash_bwd_dkv(
                                q, k, v, o, do, m, l, scale)),
                            ("dq", lambda: flash.flash_bwd_dq(
                                q, k, v, do, m, l, di, scale))))
                b2b += (", SDPA bwd " + format(time_b2b_ms(
                    lambda: torch.autograd.grad(o_sdpa, (qg, kg, vg), do,
                                                retain_graph=True)), ".4f"))
            print(f"flash {shape} {dname}: max|d|/max fwd "
                  f"{e['flash_fwd']:.3e} infer "
                  f"{e['flash_attention_infer']:.3e} dkv "
                  f"{e['flash_bwd_dkv']:.3e} dq {e['flash_bwd_dq']:.3e} "
                  f"(SDPA vs plain {sdpa_err:.3e}); ms fwd "
                  f"{t_k['flash_fwd']:.4f} infer "
                  f"{t_k['flash_attention_infer']:.4f} dkv "
                  f"{t_k['flash_bwd_dkv']:.4f} dq "
                  f"{t_k['flash_bwd_dq']:.4f}; plain fwd {p_fwd:.4f} bwd "
                  f"{p_bwd:.4f}; SDPA fwd {l_fwd:.4f} bwd {l_bwd:.4f}; "
                  f"bound fwd {bounds['flash_fwd'][0]:.4f} "
                  f"({bounds['flash_fwd'][1]}) dkv "
                  f"{bounds['flash_bwd_dkv'][0]:.4f} dq "
                  f"{bounds['flash_bwd_dq'][0]:.4f}{b2b}; plan {plan}",
                  flush=True)
            del o_sdpa
    return rows, errs


BERT_BASE = dict(vocab_size=30522, hidden=768, num_layers=12, num_heads=12,
                 ffn=3072, max_len=512)
BERT_BATCH, BERT_T, BERT_LR = 16, 512, 1e-4
# BERT-base trained 5 steps, flash vs the dense path (chip runs on an
# H100, 700 W). float32: weights where m is above MOMENT_FLOOR agree to
# BERT_F32_PARAM_TOL of lr*steps. Read: flash 1.43% of lr*steps, SDPA (a
# library attention, the same inputs) 1.80-1.97%; dense vs a rerun of
# itself 0. BERT's 12 layers carry more summation-order rounding than the
# char-RNNs' PARAM_TOL (1%) allows; Adam divides it by |m|.
BERT_F32_PARAM_TOL = 3e-2
# bfloat16 compute (the dense path rounds the scores and the softmax to
# bf16, the flash kernels keep them in f32): losses per step to
# BERT_BF16_LOSS_TOL relative (read: 1.96e-5), Adam m and v to
# BERT_BF16_MOMENT_TOL of their tensor's largest element (read: 2.40e-2).
# Weights are only printed: bf16 rounding moves a weight by up to
# 1.18 lr*steps.
BERT_BF16_LOSS_TOL = 1e-3
BERT_BF16_MOMENT_TOL = 5e-2
# At random initialisation attention moves BERT's loss little, so in both
# dtypes every flash call of the first step (12 layers) is also held, on
# the main path's own tensors, against the plain versions at FLASH_TOL.
# The control: the flash path with its softmax scale 10% off. In float32
# the end-to-end checks above must catch it, or they could not see a
# wrong kernel; in bfloat16 what they see of it is printed.
BERT_CONTROL_SCALE = 0.9
# served rows vs a direct forward of the same request, bf16 hidden states
# of unit scale: the dispatch's batch may lead cuBLAS to other kernels,
# whose bf16 roundings differ by an ulp (1/64 near 2) and carry on
BERT_SERVE_TOL = 0.125


def bert_numpy_params(rng):
    """BERT-base parameters in the JAX package's layout, drawn from a numpy
    generator as its init_params draws them (normal * 0.02, zero biases,
    unit LayerNorm gains)."""
    c = BERT_BASE
    h, f, v = c["hidden"], c["ffn"], c["vocab_size"]

    def norm(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(
            0.02)

    def ln():
        return {"g": np.ones(h, np.float32), "b": np.zeros(h, np.float32)}

    return {"tok_emb": norm(v, h), "pos_emb": norm(c["max_len"], h),
            "type_emb": norm(2, h), "emb_ln": ln(),
            "mlm_bias": np.zeros(v, np.float32),
            "layers": [{"qkv_w": norm(h, 3 * h),
                        "qkv_b": np.zeros(3 * h, np.float32),
                        "out_w": norm(h, h), "out_b": np.zeros(h, np.float32),
                        "ln1": ln(), "ln2": ln(),
                        "ffn_in_w": norm(h, f),
                        "ffn_in_b": np.zeros(f, np.float32),
                        "ffn_out_w": norm(f, h),
                        "ffn_out_b": np.zeros(h, np.float32)}
                       for _ in range(c["num_layers"])]}


def _bert_leaf_names(params):
    """Names of bert.param_leaves(params), in its order."""
    names = []

    def walk(node, path):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], f"{path}.{key}" if path else key)
        elif isinstance(node, list):
            for i, item in enumerate(node):
                walk(item, f"{path}[{i}]")
        else:
            names.append(path)

    walk(params, "")
    return names


def _compare_bert(a, b, what):
    """Weights and Adam moments of two BertTrainers trained alike, as
    _compare_trained measures them: (the largest weight difference where
    the first moment is above MOMENT_FLOOR of its tensor's largest, the
    largest elsewhere, the largest m or v difference over its tensor's
    largest), each printed with its tensor's name."""
    from deeplearning4j_tpu_torch.models import bert

    lr_steps = BERT_LR * a._step
    names = _bert_leaf_names(a.params)
    above = below = moments = (0.0, "")
    for i, (pa, pb) in enumerate(zip(bert.param_leaves(a.params),
                                     bert.param_leaves(b.params))):
        mb = b.opt["m"][i]
        moments = max(moments, (max(_rel_err(a.opt["m"][i], mb), _rel_err(
            a.opt["v"][i], b.opt["v"][i])), names[i]))
        tiny = mb.abs() < MOMENT_FLOOR * mb.abs().max()
        d = (pa - pb).abs()
        if (~tiny).any():
            above = max(above, (float(d[~tiny].max()), names[i]))
        if tiny.any():
            below = max(below, (float(d[tiny].max()), names[i]))
    print(f"bert train: {what}: params max|d| {above[0]:.3e} = "
          f"{above[0] / lr_steps:.3e} of lr*steps where m is above the "
          f"floor ({above[1]}), {below[0]:.3e} below it ({below[1]}); Adam "
          f"m/v max|d|/max {moments[0]:.3e} ({moments[1]})", flush=True)
    return above[0], below[0], moments[0]


class FlashRecorder:
    """Stands in for flash.flash_attention while a BERT trainer runs
    (bert._attention calls it through the module): calls the kernels'
    autograd Function as before, with the softmax scale times ``factor``
    (1, or the control's), and keeps the first ``keep`` calls' q, k, v,
    scale and o, and through tensor hooks their do, dq, dk and dv."""

    def __init__(self, flash, keep, factor=1.0):
        self.flash, self.keep, self.factor = flash, keep, factor
        self.calls = []

    def __enter__(self):
        self.exact = self.flash.flash_attention
        self.flash.flash_attention = self
        return self

    def __exit__(self, *exc):
        self.flash.flash_attention = self.exact

    def __call__(self, q, k, v, scale):
        o = self.exact(q, k, v, self.factor * scale)
        if len(self.calls) < self.keep:
            rec = {"q": q.detach(), "k": k.detach(), "v": v.detach(),
                   "scale": scale, "o": o.detach()}

            def keeper(name):
                def hook(grad):
                    rec[name] = grad.detach()
                return hook

            for name, a in (("do", o), ("dq", q), ("dk", k), ("dv", v)):
                a.register_hook(keeper(name))
            self.calls.append(rec)
        return o

    def errors(self):
        """max |kernel - plain| / max |plain| over the kept calls: of o,
        and of dq, dk and dv (the plain backward from the kernel's o)."""
        fwd = bwd = 0.0
        for i, rec in enumerate(self.calls):
            if not {"do", "dq", "dk", "dv"} <= set(rec):
                fail(f"flash call {i} of the first step got no gradient")
            q, k, v, scale = rec["q"], rec["k"], rec["v"], rec["scale"]
            ro, rm, rl = self.flash.flash_fwd_reference(q, k, v, scale)
            fwd = max(fwd, _rel_err(rec["o"].float(), ro.float()))
            want = self.flash.flash_bwd_reference(q, k, v, rec["o"],
                                                  rec["do"], rm, rl, scale)
            for name, w in zip(("dq", "dk", "dv"), want):
                bwd = max(bwd, _rel_err(rec[name].float(), w.float()))
        return fwd, bwd


def _bert_step_ms(torch, trainer, tokens, labels, n=5):
    """Median host-clock ms of a train_step ending in a synchronize, after
    two warm-up steps."""
    times = []
    for k in range(n + 2):
        t0 = time.perf_counter()
        trainer.train_step(tokens, labels)
        torch.cuda.synchronize()
        if k >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times), max(times)


def _profile_bert(torch, trainer, tokens, labels, step_ms):
    """Device time by kernel over two steps (torch.profiler), per step: the
    flash kernels' and the flash backward's (di pass, dkv, dq) share, and
    the device's idle share of ``step_ms``, the host-clock step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            trainer.train_step(tokens, labels)
        torch.cuda.synchronize()
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    total = sum(dev_us(e) for e in events) / 2e3
    if total <= 0:
        print("bert profile: no device time in the trace: not measured",
              flush=True)
        return
    flash_ms = sum(dev_us(e) for e in events if "flash_" in e.key) / 2e3
    bwd = {part: sum(dev_us(e) for e in events if f"flash_{part}" in e.key)
           / 2e3 for part in ("di", "dkv", "dq")}
    bwd_ms = sum(bwd.values())
    print(f"bert profile: device time {total:.3f} ms a step, flash kernels "
          f"{flash_ms:.3f} ms ({100 * flash_ms / total:.1f}%), flash "
          f"backward {bwd_ms:.3f} ms ({100 * bwd_ms / total:.1f}%: di "
          f"{bwd['di']:.3f}, dkv {bwd['dkv']:.3f}, dq {bwd['dq']:.3f}); "
          f"device idle {100 * (1 - total / step_ms):.1f}% of the "
          f"{step_ms:.3f} ms host-clock step; top kernels (ms a step, "
          f"calls a step):", flush=True)
    for e in sorted(events, key=lambda e: -dev_us(e))[:14]:
        print(f"  {dev_us(e) / 2e3:9.3f}  {e.count // 2:5d}  "
              f"{e.key[:110]}", flush=True)


def bert_training_phase(torch, flash):
    """BERT-base (768/12/12, T=512) trained by BertTrainer at batch 16 for
    STEPS steps from one numpy draw of parameters, flash kernels vs the
    dense attention path, dropout 0: in float32 on one repeated batch
    (losses, weights, moments held to the LSTM rules, weights to
    BERT_F32_PARAM_TOL) and in bfloat16 on STEPS batches (the default, the
    main path: its launches are counted; losses and moments held to
    BERT_BF16_*); a control that those checks must catch; step times; a
    profile. Returns a
    dict with the bf16 flash trainer, its launches and step times."""
    from deeplearning4j_tpu_torch.models import bert
    from deeplearning4j_tpu_torch.utils.convert import bert_params_from_numpy

    t0 = time.perf_counter()
    tree = bert_numpy_params(np.random.default_rng(SEED + 5))
    batches = [bert.synthetic_mlm_batch(bert.BertConfig(**BERT_BASE),
                                        BERT_BATCH, BERT_T, seed=s)
               for s in range(STEPS)]
    tokens_k = np.stack([b_[0] for b_ in batches])
    labels_k = np.stack([b_[1] for b_ in batches])
    print(f"bert: parameters and {STEPS} batches drawn in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    fns = [getattr(flash, name) for name in FLASH_NAMES]

    def train(dtype, impl, count=False, factor=1.0):
        """(trainer, losses, launches, FlashRecorder or None)"""
        cfg = bert.BertConfig(**BERT_BASE, dropout=0.0, compute_dtype=dtype,
                              attention_impl=impl)
        tr = bert.BertTrainer(cfg, lr=BERT_LR,
                              params=bert_params_from_numpy(tree, "cuda"))
        if tr.device.type != "cuda":
            fail(f"BertTrainer defaulted to {tr.device}")
        if count:
            for fn in fns:
                fn.launches = 0
        # the float32 parity check repeats one batch, as the LSTM and GRU
        # training checks do: its weight rules assume gradients that keep
        # their sign from step to step
        toks, labs = ((tokens_k, labels_k) if dtype == "bfloat16" else
                      (tokens_k[:1].repeat(STEPS, 0),
                       labels_k[:1].repeat(STEPS, 0)))
        rec = FlashRecorder(flash, cfg.num_layers if impl == "flash" else 0,
                            factor)
        with rec:
            losses = tr.train_steps(toks, labs).cpu().numpy()
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in fns}
        if not np.isfinite(losses).all():
            fail(f"bert {dtype} {impl}: non-finite losses {losses}")
        return tr, losses, launches, rec if impl == "flash" else None

    def faults(losses_a, losses_b, a, b, rec, dtype, what):
        """The checks a flash trainer a (its first step's flash calls in
        rec) is held to against the dense trainer b: (those it fails end
        to end, those it fails in situ)."""
        worst = float(np.max(np.abs(losses_a - losses_b)
                             / np.abs(losses_b)))
        print(f"bert train {dtype}: {what}: {STEPS} steps, losses "
              f"{losses_a.tolist()} vs dense {losses_b.tolist()} (max rel "
              f"{worst:.3e})", flush=True)
        above, below, moments = _compare_bert(a, b, f"{dtype} {what}")
        lr_steps = BERT_LR * STEPS
        if dtype == "float32":
            limits = ((worst, TRAIN_LOSS_TOL, "losses"),
                      (above, BERT_F32_PARAM_TOL * lr_steps, "params"),
                      (moments, MOMENT_TOL, "Adam moments"),
                      (below, 2 * lr_steps * (1 + 1e-3),
                       "params below the floor"))
        else:
            limits = ((worst, BERT_BF16_LOSS_TOL, "losses"),
                      (moments, BERT_BF16_MOMENT_TOL, "Adam moments"))
        fwd, bwd = rec.errors()
        print(f"bert train {dtype}: {what}: the first step's "
              f"{len(rec.calls)} flash calls vs plain, max|d|/max o "
              f"{fwd:.3e}, dq/dk/dv {bwd:.3e}", flush=True)
        in_situ = ((fwd, FLASH_TOL[dtype][0], "flash outputs vs plain"),
                   (bwd, FLASH_TOL[dtype][1], "flash gradients vs plain"))
        return tuple([f"{name} differ by {got:.3e} > {tol:.3e}"
                      for got, tol, name in checks if got > tol]
                     for checks in (limits, in_situ))

    results = {}
    for dtype in ("float32", "bfloat16"):
        main = dtype == "bfloat16"
        tr_f, losses_f, launches, rec = train(dtype, "flash", count=main)
        tr_d, losses_d, _, _ = train(dtype, "dense")
        print(f"bert train {dtype}: flash launches {launches}", flush=True)
        bad = sum(faults(losses_f, losses_d, tr_f, tr_d, rec, dtype,
                         "flash vs dense"), [])
        del rec
        if bad:
            fail(f"bert {dtype}: flash vs dense: {'; '.join(bad)}")
        if not main:
            # a yardstick, printed: a library attention's distance
            tr_s, _, _, _ = train(dtype, "dpa")
            _compare_bert(tr_s, tr_d, f"{dtype} SDPA vs dense (yardstick)")
            del tr_s
        tr_c, losses_c, _, rec_c = train(dtype, "flash",
                                         factor=BERT_CONTROL_SCALE)
        end_to_end, in_situ = faults(losses_c, losses_d, tr_c, tr_d, rec_c,
                                     dtype, f"control (scale "
                                     f"x{BERT_CONTROL_SCALE})")
        del tr_c, rec_c
        print(f"bert train {dtype}: the control is caught end to end by "
              f"{end_to_end}, in situ by {in_situ}", flush=True)
        if not (end_to_end if dtype == "float32" else in_situ):
            fail(f"bert {dtype}: the control with its scale "
                 f"{BERT_CONTROL_SCALE}x off passed the checks: they cannot "
                 f"see a wrong attention")
        if main:
            want = {"flash_fwd": 12 * STEPS, "flash_attention_infer": 0,
                    "flash_bwd_dkv": 12 * STEPS, "flash_bwd_dq": 12 * STEPS}
            if launches != want:
                fail(f"bert launches in {STEPS} steps {launches}, want "
                     f"{want}")
            results["launches"] = launches
            results["trainer"] = tr_f
            tok, lab = tokens_k[0], labels_k[0]
            for name, tr in (("flash", tr_f), ("dense", tr_d)):
                med, lo, hi = _bert_step_ms(torch, tr, tok, lab)
                results[f"{name}_ms"] = med
                print(f"bert train bf16 {name}: step median {med:.3f} ms "
                      f"(min {lo:.3f}, max {hi:.3f}) at batch {BERT_BATCH}, "
                      f"T={BERT_T}", flush=True)
            del tr_d
            torch.cuda.empty_cache()
            cfg = bert.BertConfig(**BERT_BASE, dropout=0.0,
                                  attention_impl="dpa")
            tr_s = bert.BertTrainer(
                cfg, lr=BERT_LR, params=bert_params_from_numpy(tree, "cuda"))
            med, lo, hi = _bert_step_ms(torch, tr_s, tok, lab)
            print(f"bert train bf16 SDPA (yardstick): step median "
                  f"{med:.3f} ms (min {lo:.3f}, max {hi:.3f})", flush=True)
            del tr_s
            _profile_bert(torch, tr_f, tok, lab, results["flash_ms"])
        else:
            del tr_f, tr_d
        torch.cuda.empty_cache()
    return results


def bert_serving_phase(torch, flash, trainer):
    """The trained BERT-base encoder served through InferenceSession and
    FnServable: [N, 512] token ids held as floats, N = 1..16 in one burst
    over a batch-only ladder; rows against a direct forward of the same
    request; exactly 12 flash inference launches per dispatch."""
    from deeplearning4j_tpu_torch.models import bert
    from deeplearning4j_tpu_torch.serving import BucketLadder, FnServable

    cfg, params = trainer.cfg, trainer.params

    def encode(x):
        return bert.forward(params, cfg, x.long()).float()

    servable = FnServable(encode, (BERT_T,))
    if servable.device.type != "cuda":
        fail(f"FnServable defaulted to {servable.device}")
    rng = np.random.default_rng(SEED + 6)
    requests = [rng.integers(0, cfg.vocab_size, size=(n, BERT_T)).astype(
        np.float32) for n in range(1, 17)]
    # ids outside the vocabulary take the reference's rows, no device assert
    requests[2][1, :3] = [cfg.vocab_size + 5, -1, -7]
    fns = [getattr(flash, name) for name in FLASH_NAMES]
    t0 = time.perf_counter()
    answers, warmed, dispatches, launches, serve_s = _serve_burst(
        torch, "bert", servable, (BERT_T,), requests,
        BucketLadder((1, 2, 4, 8, 16)), fns)
    total_s = time.perf_counter() - t0
    n_disp = len(warmed) + len(dispatches)
    rows = sum(len(x) for x in requests)
    print(f"bert serve: warmup {len(warmed)} shapes, {len(requests)} "
          f"requests ({rows} rows) in {len(dispatches)} dispatches "
          f"{sorted(set(dispatches))}, burst {serve_s:.4f} s "
          f"({rows / serve_s:.1f} rows/s), with warmup {total_s:.3f} s; "
          f"launches {launches}", flush=True)
    if launches != {"flash_fwd": 0, "flash_attention_infer": 12 * n_disp,
                    "flash_bwd_dkv": 0, "flash_bwd_dq": 0}:
        fail(f"bert serving launches {launches} for {n_disp} dispatches")
    worst = mean = 0.0
    with torch.inference_mode():
        for x, y in zip(requests, answers):
            if y.shape != (x.shape[0], BERT_T, cfg.hidden) or \
                    not np.isfinite(y).all():
                fail(f"bert answer {y.shape} for {x.shape}")
            direct = encode(torch.tensor(x, device="cuda")).cpu().numpy()
            d = np.abs(y - direct)
            worst, mean = max(worst, float(d.max())), max(mean,
                                                          float(d.mean()))
    print(f"bert serve: served vs direct forward max|d| {worst:.3e}, worst "
          f"mean|d| {mean:.3e}", flush=True)
    if worst > BERT_SERVE_TOL:
        fail(f"bert served rows differ from a direct forward by {worst:.3e}")
    return launches["flash_attention_infer"]


PROBE_BATCH = 256          # ResNet-50's stage widths at batch 256
PROBE_GS = (1, 4)          # images per TPU grid step, in the reference
PROBE_REPORT = ("s2", 4)   # probe_fused_parts' shape and the sweep's g
MATMUL_REPORT = (50176, 1024, 256)
# kernels vs plain versions in bf16, per output: max |d| over the largest
# element (one bf16 ulp is up to 2^-7 of it) and mean |d| over mean |ref|.
# At full width the two sides' float32 sums in other orders flip bf16
# roundings of y1, y2 and out in up to 17% of the elements (block_pad at
# s3 on an H100), each by about one ulp: the mean stays near a tenth of
# an ulp, while a wrong tap, mask or epilogue moves it by orders of
# magnitude (the control below).
PROBE_TOL = 1e-2
PROBE_MEAN_TOL = 1e-3
# (n, h, C, F, g) beside the stages: F a multiple of 16 but not of 64 (and
# a 784-row group in bands of 448 and 336); C and F not multiples of 64 and
# a 162-row group in bands of 128 and 34; F past 512 (y2 in chunks); an
# image so wide that bands are below 64 rows beside a two-stage ring, with
# the affines in shared memory and (C = 2048) read from global memory
PROBE_RAGGED = ((8, 14, 1024, 80, 4), (4, 9, 208, 336, 2),
                (4, 14, 256, 528, 2), (2, 70, 256, 512, 1),
                (2, 70, 2048, 512, 1))
PROBE_NAMES = ("matmul_bf16", "fused_block", "fused_block2d",
               "block_matmuls", "block_pad", "block_mask", "block_folded")
PROBE_SOURCES = {"matmul_bf16": "probe_matmul.cu"}
PROBE_REPLACES = {
    "matmul_bf16": "tools/probe_matmul.py:56",
    "fused_block": "tools/probe_fused_block.py:62",
    "fused_block2d": "tools/probe_fused_block.py:123",
    "block_matmuls": "tools/probe_fused_parts.py:38",
    "block_pad": "tools/probe_fused_parts.py:47",
    "block_mask": "tools/probe_fused_parts.py:62",
    "block_folded": "tools/probe_fused_parts.py:82"}


def _bf16_errs(got, want):
    """(max |d| / max |want|, mean |d| / mean |want|, share of elements
    that differ, max |d|) in float32."""
    d = (got.float() - want.float()).abs()
    w = want.float().abs()
    return (float(d.max()) / max(float(w.max()), 1e-30),
            float(d.mean()) / max(float(w.mean()), 1e-30),
            float((d > 0).float().mean()), float(d.max()))


def _bf16_bound(nbytes, flops):
    """(ms, what bounds it) against the bf16 tensor rate."""
    by_bytes, by_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def matmul_bound(m, k, n):
    """a and b read once and out written once in bf16; 2MKN operations."""
    return _bf16_bound(2 * (m * k + k * n + m * n), 2.0 * m * k * n)


def bottleneck_bound(name, n, h, c, f):
    """x read and out written once in bf16, the weights once, the affines
    the variant reads once in float32; 2 n h^2 (CF + 9F^2 + FC)
    operations (block_matmuls too: its 9 taps multiply unshifted rows)."""
    affines = {"fused_block": 4 * f + 2 * c, "fused_block2d": 4 * f + 2 * c,
               "block_folded": 2 * f + c}.get(name, 0)
    nbytes = 2 * (2 * n * h * h * c + c * f + 9 * f * f + f * c) + 4 * affines
    return _bf16_bound(nbytes, 2.0 * n * h * h * (c * f + 9 * f * f + f * c))


def _bottleneck_calls(bn, x, p, h, g):
    """name -> (kernel call, plain call) of the six variants on x."""
    x2 = x.reshape(-1, x.shape[-1])
    w = (p["w1"], p["w2"], p["w3"])
    folded = (p["w1"], p["b1"], p["w2"], p["b2"], p["w3"], p["b3"])
    calls = {}
    for name in bn.VARIANTS:
        fn, ref = getattr(bn, name), getattr(bn, name + "_reference")
        if name.startswith("fused"):
            calls[name] = (lambda fn=fn: fn(x, p, g),
                           lambda ref=ref: ref(x, p, g))
        else:
            args = folded if name == "block_folded" else w
            calls[name] = (lambda fn=fn, a=args: fn(x2, *a, h=h, g=g),
                           lambda ref=ref, a=args: ref(x2, *a, h=h, g=g))
    return calls


def _bottleneck_plans(bn, n, h, c, f, g, sms):
    """The six variants' launch plans as the source gives them, each held
    against its Python mirror; fused_block2d's."""
    for name in bn.VARIANTS:
        plan = bn.source_plan(name, n, h, c, f, g)
        mirror = bn.plan(name, n, h, c, f, g, sms)
        if plan != mirror:
            fail(f"{name} plan at {(n, h, c, f, g)}: the source gives {plan}"
                 f", the mirror {mirror}")
    return bn.source_plan("fused_block2d", n, h, c, f, g)


def _bottleneck_gates(torch, bn, calls, errs, where, label):
    """Each variant once against its plain version (the gate) and once
    more: the bits must repeat; its launch counter must rise."""
    parts = []
    for name, (kernel, plain) in calls.items():
        fn = getattr(bn, name)
        before = fn.launches
        got = kernel()
        again = kernel()
        torch.cuda.synchronize()
        if fn.launches != before + 2:
            fail(f"{name} launch counter did not rise at {where}")
        if not bool((got == again).all()):
            fail(f"{name} at {where}: a second call gave other bits")
        e = _bf16_errs(got, plain())
        _gate(name, where, e)
        errs[name] = max(errs[name], e[3])
        parts.append(f"{name} {e[0]:.2e}/{e[1]:.2e}/{e[2]:.2e}")
        del got, again
    print(f"{label}, max|d|/max / mean|d|/mean / differing (bits "
          f"repeated): {'; '.join(parts)}", flush=True)


def _gate(name, where, errs):
    rel, mean, _, _ = errs
    if rel > PROBE_TOL or mean > PROBE_MEAN_TOL:
        fail(f"{name} vs plain at {where}: max|d|/max {rel:.3e} "
             f"(<= {PROBE_TOL}), mean|d|/mean {mean:.3e} "
             f"(<= {PROBE_MEAN_TOL})")


def probe_kernel_phase(torch, pm, bn):
    """The probe kernels vs their plain versions on the card: matmul_bf16
    at the 9 probe shapes where the reference ran Pallas (its launch plan
    as the source gives it against its Python mirror; at the report shape
    also back-to-back times, its and cuBLAS's), the six
    bottleneck variants at ResNet-50's four stages (batch 256) with g = 1
    and 4 and at PROBE_RAGGED, non-zero affines and biases, each launched
    twice (the bits must repeat) with its launch plan as the source gives
    it held against the Python mirror; a control that the gate must
    catch; times of each kernel, its plain version and the library
    yardstick (cuBLAS; the cuBLAS + cuDNN block) at the report shapes, and
    at every stage fused_block2d's and the block's single and back-to-back
    times with fused_block2d's share of the bf16 peak."""
    from deeplearning4j_tpu_torch.tools import probe_fused_block as pfb
    from deeplearning4j_tpu_torch.tools import probe_matmul as pmt
    from deeplearning4j_tpu_torch.utils.convert import (
        bottleneck_params_from_numpy)

    rows, errs = {}, dict.fromkeys(PROBE_NAMES, 0.0)
    fns = [pm.matmul_bf16] + [getattr(bn, name) for name in bn.VARIANTS]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (m, k, n) in [s for s in pmt.SHAPES if pmt.kernel_runs(*s)]:
        plan = pm.source_plan(m, k, n)
        if plan != pm.plan(m, k, n, sms):
            fail(f"matmul_bf16 plan at {(m, k, n)}: the source gives {plan}, "
                 f"the mirror {pm.plan(m, k, n, sms)}")
        a, b = pmt.inputs(m, k, n, "cuda")
        before = pm.matmul_bf16.launches
        got = pm.matmul_bf16(a, b)
        torch.cuda.synchronize()
        if pm.matmul_bf16.launches != before + 1:
            fail(f"matmul_bf16 launch counter did not rise at {(m, k, n)}")
        e = _bf16_errs(got, pm.matmul_bf16_reference(a, b))
        _gate("matmul_bf16", (m, k, n), e)
        errs["matmul_bf16"] = max(errs["matmul_bf16"], e[3])
        line = (f"matmul_bf16 {(m, k, n)}: max|d|/max {e[0]:.3e}, "
                f"mean|d|/mean {e[1]:.3e}, differing {e[2]:.2e}")
        if (m, k, n) == MATMUL_REPORT:
            bound_ms, bound_by = matmul_bound(m, k, n)
            rows["matmul_bf16"] = dict(
                ms=time_ms(lambda: pm.matmul_bf16(a, b), 30),
                plain_ms=time_ms(lambda: pm.matmul_bf16_reference(a, b), 5),
                library_ms=time_ms(lambda: torch.matmul(a, b), 30),
                bound_ms=bound_ms, bound_by=bound_by)
            line += "; " + ", ".join(
                f"{key} {v:.4f}" for key, v in rows["matmul_bf16"].items()
                if key != "bound_by")
            k_b2b = time_b2b_ms(lambda: pm.matmul_bf16(a, b))
            lib_b2b = time_b2b_ms(lambda: torch.matmul(a, b))
            line += f"; back to back {k_b2b:.4f}, cuBLAS {lib_b2b:.4f}"
        print(f"{line}; plan {plan}", flush=True)
        del a, b, got

    for stage, (h, c, f) in pfb.STAGES.items():
        rng = np.random.default_rng([SEED, 9, h])
        tree = pfb.make_params(int(rng.integers(1 << 30)), c, f)
        for key in ("s1", "b1", "s2", "b2", "s3", "b3"):
            tree[key] = (tree[key] + rng.normal(size=tree[key].shape) * 0.1
                         ).astype(np.float32)
        p = bottleneck_params_from_numpy(tree, "cuda")
        x = pfb.make_input(int(rng.integers(1 << 30)), PROBE_BATCH, h, c,
                           "cuda")
        for g in PROBE_GS:
            _bottleneck_plans(bn, PROBE_BATCH, h, c, f, g, sms)
            calls = _bottleneck_calls(bn, x, p, h, g)
            _bottleneck_gates(torch, bn, calls, errs, f"{stage} g={g}",
                              f"bottleneck {stage} (h, C, F = {h}, {c}, "
                              f"{f}) n={PROBE_BATCH} g={g}")
            if (stage, g) != PROBE_REPORT:
                continue
            # control: block_pad (taps wrap across image edges) held
            # against block_mask's plain version must fail the gate
            e = _bf16_errs(calls["block_pad"][0](),
                           calls["block_mask"][1]())
            print(f"bottleneck control (block_pad vs block_mask's plain "
                  f"version): max|d|/max {e[0]:.3e}, mean|d|/mean "
                  f"{e[1]:.3e}", flush=True)
            if e[0] <= PROBE_TOL and e[1] <= PROBE_MEAN_TOL:
                fail("the bottleneck gate did not catch the control")
            lib_ms = time_ms(lambda: pfb.library_block(x, p), 10)
            conv_ms = time_ms(lambda: pfb.library_block_conv(x, p), 10)
            for name, (kernel, plain) in calls.items():
                bound_ms, bound_by = bottleneck_bound(name, PROBE_BATCH, h,
                                                      c, f)
                rows[name] = dict(ms=time_ms(kernel, 20),
                                  plain_ms=time_ms(plain, 3),
                                  library_ms=lib_ms, bound_ms=bound_ms,
                                  bound_by=bound_by)
            plans = {name: bn.source_plan(name, PROBE_BATCH, h, c, f, g)
                     for name in ("fused_block2d", "block_matmuls")}
            print(f"bottleneck {stage} g={g} ms: " + ", ".join(
                f"{name} {r['ms']:.4f} (plain {r['plain_ms']:.2f})"
                for name, r in rows.items() if name != "matmul_bf16") +
                  f"; cuBLAS+cuDNN block {lib_ms:.4f}, three cuDNN convs "
                  f"{conv_ms:.4f}; bound {bound_ms:.4f} ({bound_by}); "
                  f"plans {plans}", flush=True)
        # every stage's time at the sweep's g, single and back to back,
        # beside the library block, and the share of the bf16 peak
        g = PROBE_REPORT[1]
        plan = bn.source_plan("fused_block2d", PROBE_BATCH, h, c, f, g)
        k_ms = time_ms(lambda: bn.fused_block2d(x, p, g), 10)
        k_b2b = time_b2b_ms(lambda: bn.fused_block2d(x, p, g))
        lib_ms = time_ms(lambda: pfb.library_block(x, p), 10)
        lib_b2b = time_b2b_ms(lambda: pfb.library_block(x, p))
        bound_ms, bound_by = bottleneck_bound("fused_block2d", PROBE_BATCH,
                                              h, c, f)
        share = PROBE_BATCH * pfb.block_flops(h, c, f) / (
            k_b2b * 1e-3) / PEAK_BF16
        print(f"bottleneck {stage} g={g}: fused_block2d {k_ms:.4f} ms, back "
              f"to back {k_b2b:.4f} ms ({share:.1%} of the bf16 peak); "
              f"cuBLAS+cuDNN block {lib_ms:.4f} ms, "
              f"back to back {lib_b2b:.4f} ms; bound {bound_ms:.4f} ms "
              f"({bound_by}); band {plan['band_rows']} rows, y1 for "
              f"{plan['y1_rows']} ({plan['y1_rows'] / plan['band_rows']:.3f}"
              f"x of conv1), {plan['items']} items on {plan['grid']} blocks, "
              f"{plan['smem_bytes']} B shared", flush=True)
        del x, p, calls
        torch.cuda.empty_cache()
    # ragged shapes: F a multiple of 16 but not of 64; a short last band;
    # F past 512; bands below 64 rows; the affines outside shared memory
    for n, h, c, f, g in PROBE_RAGGED:
        rng = np.random.default_rng([SEED, 10, h, f])
        tree = pfb.make_params(int(rng.integers(1 << 30)), c, f)
        for key in ("s1", "b1", "s2", "b2", "s3", "b3"):
            tree[key] = (tree[key] + rng.normal(size=tree[key].shape) * 0.1
                         ).astype(np.float32)
        p = bottleneck_params_from_numpy(tree, "cuda")
        x = pfb.make_input(int(rng.integers(1 << 30)), n, h, c, "cuda")
        plan = _bottleneck_plans(bn, n, h, c, f, g, sms)
        _bottleneck_gates(torch, bn, _bottleneck_calls(bn, x, p, h, g),
                          errs, f"ragged {(n, h, c, f, g)}",
                          f"bottleneck ragged (n, h, C, F, g) = "
                          f"{(n, h, c, f, g)}, {plan['bands']} bands of "
                          f"{plan['band_rows']} of {g * h * h} rows")
    if not all(fn.launches for fn in fns):
        fail("a probe kernel was never launched in its comparison")
    return rows, errs


def probe_main_phase(torch, pm, bn):
    """The three probe entry points at full width, as a user runs them:
    probe_matmul (its 11 shapes), probe_fused_block --stage s2 --batch 256
    --check (the g sweep 2..16) and probe_fused_parts (14/1024/256, N=256,
    G=4); each kernel's launch counter set to 0 just before its probe and
    read just after. Every record must hold a time and a share of the
    peak, the check must pass and no g may be skipped."""
    from deeplearning4j_tpu_torch.tools import (
        probe_fused_block, probe_fused_parts, probe_matmul)

    launches = {}
    for probe, argv, names in (
            (probe_matmul, [], ("matmul_bf16",)),
            (probe_fused_block, ["--stage", "s2", "--batch",
                                 str(PROBE_BATCH), "--check"],
             ("fused_block", "fused_block2d")),
            (probe_fused_parts, [], ("block_matmuls", "block_pad",
                                     "block_mask", "block_folded"))):
        fns = [pm.matmul_bf16 if name == "matmul_bf16" else
               getattr(bn, name) for name in names]
        for fn in fns:
            fn.launches = 0
        t0 = time.perf_counter()
        records = probe.main(argv)
        torch.cuda.synchronize()
        launches.update({name: fn.launches for name, fn in zip(names, fns)})
        label = probe.__name__.rsplit(".", 1)[1]
        print(f"probe {label} {' '.join(argv)}: {len(records)} records in "
              f"{time.perf_counter() - t0:.2f} s; launches "
              f"{ {n: launches[n] for n in names} }", flush=True)
        for rec in records:
            if "skipped" in rec or rec.get("ok") is False:
                fail(f"probe {label}: {rec}")
            if "ms" in rec and not (rec["ms"] > 0 and math.isfinite(
                    rec["frac_of_peak"])):
                fail(f"probe {label}: no time or share in {rec}")
    return launches


LENET_BATCH = 64        # dl4j-examples' LenetMnistExample
LENET_BENCH_BATCH = 512  # bench.py's LeNet batch
LENET_LR = 1e-3          # the zoo's Adam(1e-3)
LENET_DIGITS = 2         # card vs CPU test accuracy, in digits of the 2000
LENET_APART = 1e-3       # share of the weights a step may leave > 1% lr apart
LENET_BURST = (1, 7, 64, 3, 128, 16, 1, 33)   # rows a served request
LENET_TIMED = 20         # fit steps a timing
IMAGENET = (3, 224, 224)
DARKNET_BATCH, DARKNET_STEPS = 4, 3
VGG_CHECK_BATCH, VGG_FIT_BATCH = 2, 32
CNN_TOL = 1e-4   # card vs CPU, of an array's largest element: outputs, BN


def _tf32_flags(torch):
    """The float32 precision switches the port relies on, by name."""
    flags = {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
             "cudnn.benchmark": torch.backends.cudnn.benchmark,
             "float32_matmul_precision": torch.get_float32_matmul_precision()}
    for name, obj in (("cuda.matmul.fp32_precision",
                       torch.backends.cuda.matmul),
                      ("cudnn.conv.fp32_precision",
                       getattr(torch.backends.cudnn, "conv", None))):
        if hasattr(obj, "fp32_precision"):
            flags[name] = obj.fp32_precision
    return flags


def _cpu_twin(net):
    """The same network on the CPU from the card net's weights as numpy."""
    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils.convert import params_from_numpy

    conf = MultiLayerConfiguration.from_json(net.conf.to_json())
    arrays = [{k: v.detach().cpu().numpy() for k, v in p.items()}
              for p in net._params]
    return MultiLayerNetwork(conf, device="cpu").init(
        params_from_numpy(conf, arrays, "cpu"))


def _forward_macs(conf):
    """Multiply-adds an example of a configuration's conv and dense layers
    (a fit step does about 3x the forward's, 2 FLOP a multiply-add)."""
    macs = 0
    for lr, it in zip(conf.layers, conf.layer_input_types):
        kind = type(lr).__name__
        if kind == "ConvolutionLayer":
            out = lr.infer(it)
            kh, kw = lr.kernelSize
            macs += out.height * out.width * lr.nOut * lr.nIn * kh * kw
        elif kind in ("DenseLayer", "OutputLayer"):
            macs += lr.nIn * lr.nOut
    return macs


def _copy_state(torch, src, dst):
    """``dst``'s params, layer states and updater state set to ``src``'s,
    in place (the same network on two devices)."""
    from deeplearning4j_tpu_torch.tree_util import tree_leaves

    with torch.no_grad():
        for a, b in zip(*(tree_leaves([n._params, n._states, n._opt_states])
                          for n in (src, dst))):
            b.copy_(a)


def _fit_steps_ms(torch, net, batches, reps=3):
    """Median host-clock ms a step of ``net.fit`` over ``batches`` (one
    list iterator, one sync at the end, as a user's fit loop), of
    ``reps`` runs after one warm-up run."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator

    times = []
    for k in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(ListDataSetIterator(batches))
        torch.cuda.synchronize()
        if k:
            times.append((time.perf_counter() - t0) * 1e3 / len(batches))
    return statistics.median(times), min(times), max(times)


def _profile_fit(torch, label, net, ds, step_ms, card, top=10):
    """Device time by kernel of one ``fit`` step (``_device_by_kernel`` over
    two steps), its sum and launches, and the device's idle share of
    ``step_ms``, the host-clock step."""
    rows = _device_by_kernel(torch, lambda: net.fit(ds), n=2)
    total = sum(ms for ms, _, _ in rows)
    if total <= 0:
        print(f"{label} profile: no device time in the trace: not measured",
              flush=True)
        return None
    print(f"{label} profile ({card}): device time {total:.4f} ms a step in "
          f"{sum(n for _, n, _ in rows)} launches; device idle "
          f"{100 * (1 - total / step_ms):.1f}% of the {step_ms:.4f} ms "
          f"host-clock step; top kernels (ms a step, calls a step):",
          flush=True)
    for ms, n, name in rows[:top]:
        print(f"  {ms:9.4f}  {n:5d}  {name[:110]}", flush=True)
    return total


def lenet_phase(torch, card):
    """LeNet-MNIST (BASELINE config 0) at its published widths through the
    port's entry points: ``LeNet().init()`` on the card, one epoch of
    ``fit`` over the 10000 synthesised training digits at batch 64 on the
    card and, from the same numpy weights, on the CPU; each step also on
    the CPU from the card's state (gated: the step's loss, the weights it
    leaves); ``evaluate`` on the 2000 test digits (the card's accuracy
    and the CPU's own within LENET_DIGITS); a burst served through
    InferenceSession against ``output``; the TF32 flags, step times and
    images/s at batch 64 and 512, device time by kernel and idle share."""
    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    from deeplearning4j_tpu_torch.datasets.mnist import synthesize_mnist
    from deeplearning4j_tpu_torch.models import LeNet
    from deeplearning4j_tpu_torch.serving import (
        DEFAULT_BATCH_BUCKETS, BucketLadder)

    flags = _tf32_flags(torch)
    print(f"lenet: float32 switches {flags}; cuDNN "
          f"{torch.backends.cudnn.version()}", flush=True)
    if flags["cuda.matmul.allow_tf32"] or flags["cudnn.allow_tf32"]:
        fail("TF32 is on: the port computes float32 in float32")
    gpu = LeNet().init()
    if gpu.device.type != "cuda":
        fail(f"LeNet().init() put the network on {gpu.device}, not cuda")
    from deeplearning4j_tpu_torch.tree_util import tree_leaves

    cpu = _cpu_twin(gpu)      # trained on its own, for the accuracies
    shadow = _cpu_twin(gpu)   # set to the card's state before each step
    train = MnistDataSetIterator(batch_size=LENET_BATCH)
    print(f"lenet: {train.totalExamples()} training digits "
          f"({'synthesised' if train.synthetic else 'IDX files'}), batch "
          f"{LENET_BATCH}, Adam({LENET_LR})", flush=True)
    # The gate holds each step from the same state: its loss, and the
    # weights it leaves. Trajectories part after a few steps: max pooling
    # routes a window's gradient to its argmax, which a near-tie flips
    # between devices, and Adam's early steps move a weight by about lr
    # whatever its gradient's size.
    rows = []
    secs = {"card": 0.0, "cpu": 0.0}
    for ds in train:
        _copy_state(torch, gpu, shadow)
        t0 = time.perf_counter()
        gpu.fit(ds)
        loss = gpu.score()
        secs["card"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu.fit(ds)
        secs["cpu"] += time.perf_counter() - t0
        shadow.fit(ds)
        d = torch.cat([(a.cpu() - b).abs().reshape(-1) for a, b in zip(
            tree_leaves(gpu._params), tree_leaves(shadow._params))])
        rows.append((loss, abs(loss - shadow.score()) / abs(shadow.score()),
                     float(d.max()) / LENET_LR,
                     int((d > PARAM_TOL * LENET_LR).sum()), cpu.score()))
    steps, n_weights = len(rows), gpu.numParams()
    worst = max(r[1] for r in rows)
    reach = max(r[2] for r in rows)
    apart = max(r[3] for r in rows)
    print(f"lenet: one epoch, {steps} steps (the last batch padded to "
          f"{gpu._bucket}): card {secs['card']:.3f} s, CPU "
          f"{secs['cpu']:.3f} s (a score read each step); loss "
          f"{rows[0][0]:.5f} -> {rows[-1][0]:.5f} (the CPU on its own: "
          f"{rows[-1][4]:.5f}); each step from the card's state: losses "
          f"max rel {worst:.3e}, weights after it apart by up to "
          f"{reach:.4f} lr, by more than {PARAM_TOL} lr {apart} of "
          f"{n_weights} at most ({sum(r[3] > 0 for r in rows)} steps with "
          f"any)", flush=True)
    if worst > TRAIN_LOSS_TOL:
        fail(f"lenet: losses differ by {worst:.3e} > {TRAIN_LOSS_TOL}")
    if reach > 2 * (1 + 1e-3) or apart > LENET_APART * n_weights:
        fail(f"lenet: a step leaves weights {reach:.4f} lr apart (Adam's "
             f"reach 2 lr), {apart} beyond {PARAM_TOL} lr (limit "
             f"{LENET_APART} of the weights)")

    test = MnistDataSetIterator(batch_size=LENET_BATCH, train=False)
    gpu.evaluate(test)   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = gpu.evaluate(test)
    eval_s = time.perf_counter() - t0
    ev_cpu = cpu.evaluate(test)
    n_test = test.totalExamples()
    right = (round(ev.accuracy() * n_test), round(ev_cpu.accuracy() * n_test))
    print(f"lenet ({card}): evaluate {n_test} test digits {eval_s:.4f} s; "
          f"accuracy after one epoch card {ev.accuracy():.4f}, CPU "
          f"{ev_cpu.accuracy():.4f} ({right[0]} vs {right[1]} right)",
          flush=True)
    if abs(right[0] - right[1]) > LENET_DIGITS:
        fail(f"lenet: card and CPU accuracies differ by "
             f"{abs(right[0] - right[1])} digits > {LENET_DIGITS}")
    if not math.isfinite(ev.accuracy()) or ev.accuracy() <= 0.1:
        fail(f"lenet: accuracy {ev.accuracy()} after one epoch")

    requests = [synthesize_mnist(n, seed=SEED + n)[0] for n in LENET_BURST]
    answers, warmed, dispatches, _, serve_s = _serve_burst(
        torch, "lenet", gpu, (784,), requests,
        BucketLadder(DEFAULT_BATCH_BUCKETS), ())
    worst = 0.0
    for x, y in zip(requests, answers):
        if y.shape != (x.shape[0], 10) or not np.isfinite(y).all():
            fail(f"lenet: served {y.shape} for a request of {x.shape}")
        worst = max(worst, float(np.abs(y - gpu.output(x).toNumpy()).max()))
    print(f"lenet ({card}): served {len(requests)} requests "
          f"({sum(LENET_BURST)} rows) in {len(dispatches)} dispatches, "
          f"{serve_s:.4f} s; warmup of {len(warmed)} shapes; served vs "
          f"output max|d| {worst:.3e}", flush=True)
    if worst > SERVE_TOL:
        fail(f"lenet: served rows vs output {worst:.3e} > {SERVE_TOL}")

    from deeplearning4j_tpu_torch.datasets import DataSet

    out = {"steps": steps, "accuracy": ev.accuracy(), "eval_s": eval_s}
    for batch in (LENET_BATCH, LENET_BENCH_BATCH):
        x, labels = synthesize_mnist(batch, seed=SEED + batch)
        ds = DataSet(x, np.eye(10, dtype=np.float32)[labels])
        net = gpu.clone()
        med, lo, hi = _fit_steps_ms(torch, net, [ds] * LENET_TIMED)
        tflop = 6 * _forward_macs(gpu.conf) * batch / 1e12
        print(f"lenet ({card}): fit step at batch {batch}: {med:.4f} ms "
              f"(min {lo:.4f}, max {hi:.4f}; {LENET_TIMED} steps a fit "
              f"call, median of 3), {batch / med * 1e3:.1f} images/s; "
              f"~{tflop:.4f} TFLOP a step, {tflop / med * 1e3:.2f} TFLOP/s",
              flush=True)
        _profile_fit(torch, f"lenet b{batch}", net, ds, med, card)
        out[batch] = med
    return out


def cnn_phase(torch, card):
    """The zoo's ImageNet CNNs at 224x224 on the layers of this slice:
    Darknet19 (19 conv, 18 BatchNormalization, leaky ReLU, a LossLayer)
    takes 3 Adam steps at batch 4 on the card and on the CPU, each from
    the card's state (each step's loss and running means and variances
    gated); VGG16's output at batch 2 card against CPU; VGG16's fit step
    time at batch 32 (Nesterovs, dropout 0.5 in its dense layers) with
    device time by kernel."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models import VGG16, Darknet19
    from deeplearning4j_tpu_torch.tree_util import tree_leaves

    rng = np.random.default_rng(SEED + 224)

    def batch(n):
        x = rng.normal(size=(n,) + IMAGENET).astype(np.float32)
        return x, np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, n)]

    gpu = Darknet19().init()
    cpu = _cpu_twin(gpu)
    n_layers = sum(type(lr).__name__ == "BatchNormalization"
                   for lr in gpu.layers)
    worst = worst_bn = 0.0
    for step in range(DARKNET_STEPS):
        # each step from the card's weights, updater state and running
        # statistics: max pooling routes a window's gradient by an argmax
        # that a near-tie flips between devices, and Adam turns such a
        # gradient into a +-lr step, so trajectories part after a step
        _copy_state(torch, gpu, cpu)
        x, y = batch(DARKNET_BATCH)
        t0 = time.perf_counter()
        gpu.fit(x, y)
        g_loss = gpu.score()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu.fit(x, y)
        t_cpu = time.perf_counter() - t0
        rel = abs(g_loss - cpu.score()) / abs(cpu.score())
        bn = max(_rel_err(sg[k].cpu(), sc[k])
                 for sg, sc in zip(gpu._states, cpu._states) for k in sc)
        moved = max(float((pg.cpu() - pc).abs().max())
                    for pg, pc in zip(*(tree_leaves(n._params)
                                        for n in (gpu, cpu))))
        worst, worst_bn = max(worst, rel), max(worst_bn, bn)
        print(f"darknet19 step {step} (batch {DARKNET_BATCH}, "
              f"{IMAGENET[1]}x{IMAGENET[2]}, from the same state): loss "
              f"card {g_loss:.6f}, CPU {cpu.score():.6f} (rel {rel:.3e}); "
              f"running mean/var of {n_layers} BatchNormalization layers "
              f"max|d|/max {bn:.3e}; weights after it apart by up to "
              f"{moved / 1e-3:.3f} lr; card {t_card:.3f} s, CPU {t_cpu:.3f} s",
              flush=True)
    if worst > TRAIN_LOSS_TOL:
        fail(f"darknet19: losses differ by {worst:.3e} > {TRAIN_LOSS_TOL}")
    if n_layers != 18 or worst_bn > CNN_TOL:
        fail(f"darknet19: running statistics differ by {worst_bn:.3e} > "
             f"{CNN_TOL} ({n_layers} BatchNormalization layers)")
    del gpu, cpu

    gpu = VGG16().init()
    cpu = _cpu_twin(gpu)
    x, y = batch(VGG_CHECK_BATCH)
    want = cpu.output(x).toNumpy()
    got = gpu.output(x).toNumpy()
    err = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"vgg16: {gpu.numParams()} params; output at batch "
          f"{VGG_CHECK_BATCH} card vs CPU max|d|/max {err:.3e}; rows sum to "
          f"{got.sum(axis=1).round(5).tolist()}", flush=True)
    if not np.isfinite(got).all() or err > CNN_TOL:
        fail(f"vgg16: output card vs CPU {err:.3e} > {CNN_TOL}")
    del cpu
    ds = DataSet(*batch(VGG_FIT_BATCH))
    med, lo, hi = _fit_steps_ms(torch, gpu, [ds] * 3, reps=2)
    tflop = 6 * _forward_macs(gpu.conf) * VGG_FIT_BATCH / 1e12
    print(f"vgg16 ({card}): fit step at batch {VGG_FIT_BATCH} "
          f"({IMAGENET[1]}x{IMAGENET[2]}, float32): {med:.3f} ms (min "
          f"{lo:.3f}, max {hi:.3f}), {VGG_FIT_BATCH / med * 1e3:.1f} "
          f"images/s; ~{tflop:.3f} TFLOP a step, {tflop / med * 1e3:.2f} "
          f"TFLOP/s of the 67 float32 peak; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    _profile_fit(torch, f"vgg16 b{VGG_FIT_BATCH}", gpu, ds, med, card)
    del gpu
    torch.cuda.empty_cache()
    return {"vgg16_step_ms": med}


RESNET_CHECK_BATCH, RESNET_STEP_BATCH, RESNET_STEPS = 2, 4, 3
# The outputs are held card vs CPU at CNN_TOL of the largest element, in
# training mode and in inference once the running statistics are one
# batch's (``_calibrate_bn``): a fresh graph's running statistics let the
# softmax saturate in inference, where a check compares ones and zeros.
# Each step's weights, from the same state on both devices: the card's
# update of each param array against the CPU's, as the norm of their
# difference over the norm of the CPU's. Backward through 53
# BatchNormalization nodes at batch 4 turns rounding into about 1% of an
# array's update (the CPU at one thread against itself at eight:
# printed as the yardstick), while an update that is missing or computed
# from a wrong gradient is 1 or more apart. An array whose CPU update
# stays below PARAM_TOL**2 lr (a conv bias ahead of BatchNormalization:
# zero exact gradient, rounding noise) is held to that in absolute terms.
RESNET_UPDATE_TOL = 0.1
RESNET_LR = 1e-2         # the zoo's Nesterovs(1e-2, 0.9)
RESNET_EVAL = (16, 16, 6)   # evaluate's batches, the last ragged
RESNET_BURST = (1, 3, 8, 2, 17, 5, 12, 1, 30, 4)   # rows a served request
RESNET_FIT_BATCHES = (64, 256)
RESNET_TIMED = 4         # fit steps a timing
RESNET_FLOP = 3 * 8.2e9  # a training step's FLOP an image (bench.py)
RESNET_PARAMS = 25583592   # the JAX package's count for the same conf


def _graph_cpu_twin(graph):
    """The same graph on the CPU from the card graph's weights and
    running statistics as numpy."""
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
        ComputationGraphConfiguration)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.utils.convert import (
        opt_states_to_numpy, params_from_numpy, states_from_numpy,
        states_to_numpy)

    conf = ComputationGraphConfiguration.from_json(graph.conf.to_json())
    twin = ComputationGraph(conf, device="cpu").init(params_from_numpy(
        conf, opt_states_to_numpy(graph._params), "cpu"))
    twin._states = states_from_numpy(conf, states_to_numpy(graph._states),
                                     "cpu")
    return twin


def _update_gap(before, got, want):
    """Two graphs stepped from the params ``before``: the largest, over
    the param arrays, of the norm of the two updates' difference over the
    norm of ``want``'s update; and the largest difference in the arrays
    whose update in ``want`` stays below PARAM_TOL**2 lr."""
    from deeplearning4j_tpu_torch.tree_util import tree_leaves

    rel = noise = 0.0
    for w0, a, b in zip(before, tree_leaves(got._params),
                        tree_leaves(want._params)):
        step, d = b - w0, a.cpu() - b
        if float(step.abs().max()) > PARAM_TOL ** 2 * RESNET_LR:
            rel = max(rel, float(d.norm() / step.norm()))
        else:
            noise = max(noise, float(d.abs().max()))
    return rel, noise


def _calibrate_bn(torch, graph, x):
    """Set every BatchNormalization node's running statistics to those of
    the batch ``x`` (decay 0 for one training-mode forward). A fresh
    graph's running statistics (0 and 1) let the activations grow through
    the 16 blocks until the softmax saturates, so inference checks there
    compare ones and zeros; calibrated, they compare probabilities."""
    bns = [node for node, _ in graph.conf.nodes.values()
           if type(node).__name__ == "BatchNormalization"]
    decays = [node.decay for node in bns]
    for node in bns:
        node.decay = 0.0
    try:
        with torch.no_grad():
            _, states = graph._forward(graph._params, graph._states,
                                       {graph.conf.inputs[0]: x}, True)
    finally:
        for node, decay in zip(bns, decays):
            node.decay = decay
    graph._states = states


def _resnet_fit_timing(torch, card, gpu, batch):
    """The fit step at ``batch``: CUDA events a step, host clock over a
    fit call of RESNET_TIMED steps, the share of the float32 peak, the
    peak memory, device time by kernel and the idle share."""
    from deeplearning4j_tpu_torch.datasets import DataSet

    rng = np.random.default_rng(SEED + batch)
    ds = DataSet(rng.normal(size=(batch,) + IMAGENET).astype(np.float32),
                 np.eye(1000, dtype=np.float32)[rng.integers(0, 1000,
                                                             batch)])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    med, lo, hi = time_ms(lambda: gpu.fit(ds), RESNET_TIMED, spread=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    host, _, _ = _fit_steps_ms(torch, gpu, [ds] * RESNET_TIMED, reps=1)
    bound = RESNET_FLOP * batch / PEAK_F32 * 1e3
    print(f"resnet50 ({card}): fit step at batch {batch} ({IMAGENET[1]}x"
          f"{IMAGENET[2]}, float32): {med:.3f} ms by CUDA events (min "
          f"{lo:.3f}, max {hi:.3f}; {RESNET_TIMED} steps), "
          f"{batch / med * 1e3:.1f} images/s; host clock {host:.3f} ms a "
          f"step over a fit call of {RESNET_TIMED}; {RESNET_FLOP * batch / 1e12:.3f} TFLOP a step, "
          f"{RESNET_FLOP * batch / med / 1e9:.2f} TFLOP/s, "
          f"{100 * bound / med:.1f}% of the float32 peak (bound "
          f"{bound:.3f} ms); peak memory {peak:.2f} GiB", flush=True)
    _profile_fit(torch, f"resnet50 b{batch}", gpu, ds, med, card, top=12)
    return med, peak


def resnet50_phase(torch, card):
    """ResNet-50 (BASELINE config 1) at its published widths through the
    port's entry points: ``ResNet50().init()`` on the card (224x224x3,
    stages (3, 4, 6, 3) of bottlenecks, 1000 classes, float32,
    Nesterovs(1e-2, 0.9)), against the same graph on the CPU from the same
    numpy weights: the output at batch 2 in training mode; 3 fit steps
    at batch 4 over synthetic ImageNet-shaped batches, each from the
    card's state (the loss, the weights it leaves and the 53
    BatchNormalization nodes' running statistics gated); the running
    statistics set to one batch's (``_calibrate_bn``) and the output at
    batch 2 in inference; ``evaluate`` over an iterator with a ragged last
    batch; a zip written on the card and restored on the card and the
    CPU; a burst of 10 requests served through InferenceSession against
    ``outputSingle``; the fit step at batch 64 and 256 with images/s, the
    share of the float32 peak, device time by kernel, the idle share and
    the peak memory; ``output`` at batch 64."""
    import tempfile
    from pathlib import Path

    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.models import ResNet50
    from deeplearning4j_tpu_torch.serving import BucketLadder
    from deeplearning4j_tpu_torch.tree_util import tree_leaves
    from deeplearning4j_tpu_torch.utils import ModelSerializer

    flags = _tf32_flags(torch)
    print(f"resnet50: float32 switches {flags}", flush=True)
    if flags["cuda.matmul.allow_tf32"] or flags["cudnn.allow_tf32"] or \
            flags.get("cudnn.conv.fp32_precision", "ieee") != "ieee":
        fail("TF32 is on: the port computes float32 in float32")
    rng = np.random.default_rng(SEED + 50)

    def batch(n):
        x = rng.normal(size=(n,) + IMAGENET).astype(np.float32)
        return x, np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, n)]

    t0 = time.perf_counter()
    gpu = ResNet50().init()
    init_s = time.perf_counter() - t0
    if gpu.device.type != "cuda":
        fail(f"ResNet50().init() put the graph on {gpu.device}, not cuda")
    kinds = [type(n).__name__ for n, _ in gpu.conf.nodes.values()]
    bns = [name for name, (n, _) in gpu.conf.nodes.items()
           if type(n).__name__ == "BatchNormalization"]
    print(f"resnet50: {gpu.numParams()} params, {len(kinds)} nodes "
          f"({kinds.count('ConvolutionLayer')} conv, {len(bns)} "
          f"BatchNormalization, {kinds.count('ElementWiseVertex')} adds); "
          f"init {init_s:.2f} s", flush=True)
    if gpu.numParams() != RESNET_PARAMS or \
            kinds.count("ConvolutionLayer") != 53:
        fail(f"resnet50 has {gpu.numParams()} params, "
             f"{kinds.count('ConvolutionLayer')} convs")
    cpu = _graph_cpu_twin(gpu)

    def output_check(what, train):
        x, _ = batch(RESNET_CHECK_BATCH)
        want = cpu.outputSingle(x, train=train).toNumpy()
        got = gpu.outputSingle(x, train=train).toNumpy()
        err = float(np.abs(got - want).max() / np.abs(want).max())
        print(f"resnet50: output ({what}) at batch {RESNET_CHECK_BATCH} "
              f"card vs CPU max|d|/max {err:.3e}; rows sum to "
              f"{got.sum(axis=1).round(5).tolist()}, largest probabilities "
              f"{got.max(axis=1).round(6).tolist()}", flush=True)
        if not np.isfinite(got).all() or got.shape != (2, 1000) or \
                err > CNN_TOL:
            fail(f"resnet50: output ({what}) card vs CPU {err:.3e} > "
                 f"{CNN_TOL}")

    output_check("fresh graph, training mode, batch statistics", True)

    worst = worst_bn = 0.0
    yard = _graph_cpu_twin(gpu)
    for step in range(RESNET_STEPS):
        # each step from the card's state: max pooling's argmax and
        # ReLU's kink flip on near-ties between devices
        for twin in (cpu, yard) if step == 0 else (cpu,):
            _copy_state(torch, gpu, twin)
        before = [p.clone() for p in tree_leaves(cpu._params)]
        ds = DataSet(*batch(RESNET_STEP_BATCH))
        t0 = time.perf_counter()
        gpu.fit(ds)
        g_loss = gpu.score()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu.fit(ds)
        t_cpu = time.perf_counter() - t0
        rel = abs(g_loss - cpu.score()) / abs(cpu.score())
        bn = max(_rel_err(gpu._states[n][k].cpu(), cpu._states[n][k])
                 for n in bns for k in ("mean", "var"))
        upd, noise = _update_gap(before, gpu, cpu)
        worst, worst_bn = max(worst, rel), max(worst_bn, bn)
        print(f"resnet50 step {step} (batch {RESNET_STEP_BATCH}, from the "
              f"same state): loss card {g_loss:.6f}, CPU {cpu.score():.6f} "
              f"(rel {rel:.3e}); running mean/var of {len(bns)} "
              f"BatchNormalization nodes max|d|/max {bn:.3e}; each param "
              f"array's update apart by up to {upd:.3e} of its norm (the "
              f"arrays without gradient: {noise / RESNET_LR:.3e} lr); card "
              f"{t_card:.3f} s, CPU {t_cpu:.3f} s", flush=True)
        if upd > RESNET_UPDATE_TOL or noise > PARAM_TOL ** 2 * RESNET_LR:
            fail(f"resnet50: step {step} updates apart by {upd:.3e} of "
                 f"their norm (limit {RESNET_UPDATE_TOL}), {noise:.3e} "
                 f"where the gradient is 0")
        if step == 0:
            # the yardstick: the CPU against itself at another thread count
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                yard.fit(ds)
            finally:
                torch.set_num_threads(threads)
            print(f"resnet50 step 0 on the CPU at 1 thread against "
                  f"{threads}: updates apart by up to "
                  f"{_update_gap(before, yard, cpu)[0]:.3e} of their norm",
                  flush=True)
    if worst > TRAIN_LOSS_TOL:
        fail(f"resnet50: losses differ by {worst:.3e} > {TRAIN_LOSS_TOL}")
    if worst_bn > CNN_TOL:
        fail(f"resnet50: running statistics differ by {worst_bn:.3e} > "
             f"{CNN_TOL}")
    del yard
    if any(float(gpu._states[n]["mean"].abs().max()) == 0 for n in bns):
        fail("resnet50: a BatchNormalization node kept no running mean")
    _calibrate_bn(torch, gpu, gpu._input(batch(32)[0]))
    _copy_state(torch, gpu, cpu)
    output_check("inference, running statistics of one batch of 32", False)

    sets = [batch(n) for n in RESNET_EVAL]
    it = ListDataSetIterator([DataSet(*s) for s in sets])
    gpu.evaluate(it)   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = gpu.evaluate(it)
    eval_s = time.perf_counter() - t0
    ev_cpu = cpu.evaluate(it)
    out_g = np.concatenate([gpu.outputSingle(f).toNumpy() for f, _ in sets])
    out_c = np.concatenate([cpu.outputSingle(f).toNumpy() for f, _ in sets])
    top = np.sort(out_c, axis=1)[:, -2:]
    ties = (top[:, 1] - top[:, 0]) <= TIE_TOL
    differ = out_g.argmax(axis=1) != out_c.argmax(axis=1)
    n_eval = sum(RESNET_EVAL)
    print(f"resnet50 ({card}): evaluate {n_eval} images in batches "
          f"{RESNET_EVAL} {eval_s:.4f} s; accuracy card {ev.accuracy():.4f} "
          f"CPU {ev_cpu.accuracy():.4f}; {int(differ.sum())} rows whose "
          f"class differs, {int(ties.sum())} within {TIE_TOL} of a tie",
          flush=True)
    if (differ & ~ties).any() or \
            ev.confusionMatrix().sum() != n_eval or \
            abs(ev.accuracy() - ev_cpu.accuracy()) * n_eval > ties.sum():
        fail("resnet50: evaluate differs between card and CPU away from "
             "ties")

    x, _ = batch(RESNET_CHECK_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "resnet50.zip")
        ModelSerializer.writeModel(gpu, path)
        size = Path(path).stat().st_size
        back = ModelSerializer.restoreComputationGraph(path)
        back_cpu = ModelSerializer.restoreComputationGraph(path,
                                                           device="cpu")
    want = gpu.outputSingle(x).toNumpy()
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves([back._params, back._states, back._opt_states]),
        tree_leaves([gpu._params, gpu._states, gpu._opt_states])))
    bits = np.array_equal(back.outputSingle(x).toNumpy(), want)
    err = float(np.abs(back_cpu.outputSingle(x).toNumpy() - want).max()
                / np.abs(want).max())
    print(f"resnet50: zip {size} bytes; restored on the card: state equal "
          f"{same}, iteration {back.getIterationCount()}, output bit-equal "
          f"{bits}; restored on the CPU: output max|d|/max {err:.3e}",
          flush=True)
    if not (same and bits) or back.getIterationCount() != \
            gpu.getIterationCount() or back.device.type != "cuda" or \
            err > CNN_TOL:
        fail("resnet50: the restored graph differs from the saved one")
    del back, back_cpu, cpu

    requests = [batch(n)[0] for n in RESNET_BURST]
    torch.cuda.reset_peak_memory_stats()
    answers, warmed, dispatches, _, serve_s = _serve_burst(
        torch, "resnet50", gpu, IMAGENET, requests,
        BucketLadder((1, 4, 8, 16, 32)), ())
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    worst = 0.0
    for r, y in zip(requests, answers):
        if y.shape != (r.shape[0], 1000) or not np.isfinite(y).all():
            fail(f"resnet50: served {y.shape} for a request of {r.shape}")
        want = gpu.outputSingle(r).toNumpy()
        worst = max(worst, float(np.abs(y - want).max() / np.abs(want).max()))
    print(f"resnet50 ({card}): served {len(requests)} requests "
          f"({sum(RESNET_BURST)} rows) in {len(dispatches)} dispatches "
          f"{sorted(s[0] for s in dispatches)}, {serve_s:.4f} s; warmup of "
          f"{len(warmed)} shapes; served vs outputSingle max|d|/max "
          f"{worst:.3e}; peak memory {serve_peak:.2f} GiB", flush=True)
    # a bucket's batch may take another cuDNN algorithm than the request's
    # own batch, so rows differ by the rounding the output checks allow
    if worst > CNN_TOL:
        fail(f"resnet50: served rows vs outputSingle {worst:.3e} > "
             f"{CNN_TOL}")

    x64, _ = batch(64)
    torch.cuda.reset_peak_memory_stats()
    med, lo, hi = time_ms(lambda: gpu.outputSingle(x64), 10, spread=True)
    print(f"resnet50 ({card}): output at batch 64 {med:.3f} ms by CUDA "
          f"events (min {lo:.3f}, max {hi:.3f}), {64 / med * 1e3:.1f} "
          f"images/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    out = {"output64_ms": med}
    for n in RESNET_FIT_BATCHES:
        out[n] = _resnet_fit_timing(torch, card, gpu, n)
    del gpu
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# object detection (YOLO2, TinyYOLO), the LSTM wrappers and the remaining
# layer modules
# ---------------------------------------------------------------------------

YOLO_SHAPE = (3, 416, 416)
YOLO_GRID = 13
YOLO_LR = 1e-3           # the zoo's Adam(1e-3)
YOLO_CHECK_BATCH, YOLO_STEP_BATCH, YOLO_STEPS = 2, 4, 3
TINY_STEPS = 2
YOLO_BURST = (1, 3, 8, 2, 5, 1, 12, 4)   # rows a served request
YOLO_FIT_BATCHES = (16, 64)
TINY_FIT_BATCH = 64
YOLO_TIMED = 4           # fit steps a timing
YOLO_PARAMS = 50962889   # the JAX package's counts for the same confs
TINY_PARAMS = 15861773
YOLO_THRESHOLD = 0.5     # YoloUtils' default object-confidence threshold
WRAP_STEPS = 2
SMALL_LR = 1e-2
# Adam steps card vs CPU (``_adam_gap``). Adam divides each weight's
# step by the root of its own squared-gradient history, so a weight whose
# gradient is rounding noise, or whose first moment cancels, moves by up
# to a whole lr one way on one device and the other way on the other:
# the weights a step leaves measure that amplification, not the card's
# arithmetic (NVIDIA H100 80GB HBM3, 700.00 W: YOLO2's first step leaves
# 1 of a BatchNormalization array's 128 weights 2 lr apart, 0.177 of its
# update's norm, and so does the CPU at 1 thread against 8; its second
# step left one array's update 0.056 of its norm apart and 7.0% of its
# weights beyond PARAM_TOL lr in one run, 0.121 and 14.8% in another).
# The gate reads what the step took in: the gradient each device's first
# moment took in, (m1 - beta1 m0) / (1 - beta1), and the squared
# gradient its second moment took in, (v1 - beta2 v0) / (1 - beta2),
# card against CPU within RESNET_UPDATE_TOL of each param array's norm
# (the gate of ResNet-50's Nesterovs steps, whose update is linear in the
# gradient), the squares within twice that (a square doubles a relative
# error); and each device's weights moved by Adam's step of its own new
# moments, within PARAM_TOL lr (a missing or misapplied update is about
# lr off). Weights under a NoOp updater (FrozenLayer) do not move. YOLO2
# on the card (NVIDIA H100 80GB HBM3, 700.00 W, 3 runs of 3 steps):
# gradients 1.0e-2 to 3.3e-2 of an array's norm apart, squares 1.5e-2 to
# 5.4e-2, the weights off Adam's step by 6.0e-5 lr (the rounding of a
# weight near 1); the CPU at 1 thread against 8: 8.9e-4 and 1.3e-3.

# The decoded detections card vs CPU, of each field's largest value: wh =
# prior * exp(twh) turns the head's absolute rounding into relative
# error of the largest boxes, so the decoded output reads 0.80e-4 to
# 1.02e-4 where the head's own output (gated at CNN_TOL) reads less
# (NVIDIA H100 80GB HBM3, 700.00 W; YOLO2 at batch 2 and 4).
YOLO_DECODE_TOL = 5e-4


def coco_batch(rng, n, classes=80, grid=YOLO_GRID, shape=YOLO_SHAPE):
    """n synthetic images with 1-4 boxes each, labelled as the reference's
    Yolo2OutputLayer reads them: [n, 4+classes, grid, grid], the box's
    corners (x1, y1, x2, y2) in grid units and a one-hot class at the
    cell of its centre (a later box in the same cell replaces an earlier
    one, one object a cell)."""
    x = rng.normal(size=(n,) + shape).astype(np.float32)
    y = np.zeros((n, 4 + classes, grid, grid), np.float32)
    for i in range(n):
        for _ in range(rng.integers(1, 5)):
            cx, cy = rng.uniform(0.5, grid - 0.5, 2)
            w, h = rng.uniform(0.3, 6.0, 2)
            gx, gy = int(cx), int(cy)
            y[i, :, gy, gx] = 0.0
            y[i, 0:4, gy, gx] = (max(cx - w / 2, 0.0), max(cy - h / 2, 0.0),
                                 min(cx + w / 2, grid), min(cy + h / 2,
                                                            grid))
            y[i, 4 + rng.integers(0, classes), gy, gx] = 1.0
    return x, y


def _graph_types(conf):
    """{node: its input types} over a graph's declared input types."""
    types = dict(conf.input_types)
    ins = {}
    for name in conf.topo_order:
        node, inputs = conf.nodes[name]
        ins[name] = [types[i] for i in inputs]
        multi = type(node).__name__.endswith("Vertex") or getattr(
            node, "MULTI_INPUT", False)
        types[name] = (node.infer(*ins[name]) if multi
                       else node.infer(ins[name][0]))
    return ins, types


def _graph_forward_macs(conf):
    """``_forward_macs`` of a graph: multiply-adds an example of its conv
    and dense nodes."""
    ins, types = _graph_types(conf)
    macs = 0
    for name in conf.topo_order:
        node, _ = conf.nodes[name]
        kind, out = type(node).__name__, types[name]
        if kind == "ConvolutionLayer":
            kh, kw = node.kernelSize
            macs += out.height * out.width * node.nOut * node.nIn * kh * kw
        elif kind in ("DenseLayer", "OutputLayer"):
            macs += node.nIn * node.nOut
    return macs


def _activation_elements(conf):
    """Elements an example of every node's output in a graph."""
    _, types = _graph_types(conf)
    return sum(t.arrayElementsPerExample() for name, t in types.items()
               if name in conf.nodes)


def _match_detections(got, want, gates):
    """(detections of ``want`` with no detection of ``got`` of the same
    example and class whose fields lie within ``gates`` ({field: gate}),
    and the detections of ``got`` left over)."""
    def key(o):
        return (o.exampleNumber, o.predictedClass)

    def near(a, b):
        return all(abs(getattr(a, k) - getattr(b, k)) <= g
                   for k, g in gates.items())

    left = list(got)
    missing = []
    for w in want:
        hit = next((g for g in left if key(g) == key(w) and near(g, w)),
                   None)
        if hit is None:
            missing.append(w)
        else:
            left.remove(hit)
    return missing, left


def _detection_check(torch, gpu, cpu, x):
    """YoloUtils.getPredictedObjects on the card's decoded output and the
    CPU's: the same detections (example, class, and centre, size and
    confidence each within YOLO_DECODE_TOL of that field's largest value
    in the CPU's decoded output), but where a box's object confidence
    lies within its gate of the threshold on either device (those are
    counted and printed)."""
    from deeplearning4j_tpu_torch.nn.objdetect import YoloUtils

    d_gpu, d_cpu = gpu.outputSingle(x), cpu.outputSingle(x)
    a_gpu, a_cpu = d_gpu.toNumpy(), d_cpu.toNumpy()
    fields = {"xy": slice(0, 2), "wh": slice(2, 4), "conf": slice(4, 5),
              "classes": slice(5, None)}
    scale = {k: float(np.abs(a_cpu[:, :, f]).max())
             for k, f in fields.items()}
    err = max(float(np.abs(a_gpu[:, :, f] - a_cpu[:, :, f]).max())
              / scale[k] for k, f in fields.items())
    gates = {"centerX": YOLO_DECODE_TOL * scale["xy"],
             "centerY": YOLO_DECODE_TOL * scale["xy"],
             "width": YOLO_DECODE_TOL * scale["wh"],
             "height": YOLO_DECODE_TOL * scale["wh"],
             "confidence": YOLO_DECODE_TOL * scale["conf"]}
    conf = np.stack([a_gpu[:, :, 4], a_cpu[:, :, 4]])
    border = np.abs(conf - YOLO_THRESHOLD) <= gates["confidence"]
    n_border = int(border.any(axis=0).sum())
    t0 = time.perf_counter()
    got = YoloUtils.getPredictedObjects(d_gpu, YOLO_THRESHOLD)
    decode_s = time.perf_counter() - t0
    want = YoloUtils.getPredictedObjects(d_cpu, YOLO_THRESHOLD)
    missing, extra = _match_detections(got, want, gates)

    def excused(o):
        # a box at the threshold on either device, in o's cell
        gx, gy = int(o.centerX), int(o.centerY)
        return bool(border[:, o.exampleNumber, :, gy, gx].any())

    unexcused = [o for o in missing + extra if not excused(o)]
    print(f"yolo2: decoded output (inference) card vs CPU max|d|/max "
          f"{err:.3e} (each field against its largest: xy, wh, confidence,"
          f" classes); getPredictedObjects at {YOLO_THRESHOLD}: card "
          f"{len(got)}, CPU {len(want)} detections over {x.shape[0]} images"
          f" ({len({o.predictedClass for o in want})} classes); "
          f"{len(missing)} CPU detections without a card twin, "
          f"{len(extra)} card ones without a CPU twin; {n_border} boxes "
          f"whose confidence lies within {gates['confidence']:.3e} of the "
          f"threshold, {len(unexcused)} differences away from it; card "
          f"decode {decode_s * 1e3:.2f} ms", flush=True)
    if err > YOLO_DECODE_TOL or not want or unexcused:
        fail(f"yolo2: detections differ between card and CPU ({err:.3e}, "
             f"{len(unexcused)} away from the threshold)")


def _adam_groups(net):
    """(updater, weights, first moments, second moments) of each node or
    layer holding params, the tensors as lists in one order (no moments
    under NoOp)."""
    from deeplearning4j_tpu_torch.tree_util import tree_leaves

    graph = hasattr(net.conf, "nodes")
    groups = []
    for k in (net.conf.nodes if graph else range(len(net.layers))):
        if not net._params[k]:
            continue
        upd = net._updater(k) if graph else net._layer_updater(k)
        kind = type(upd).__name__
        if kind not in ("Adam", "NoOp"):
            fail(f"no Adam step check for a {kind} updater")
        state = net._opt_states[k]
        moments = ((tree_leaves(state["m"]), tree_leaves(state["v"]))
                   if kind == "Adam" else ([], []))
        groups.append((upd, tree_leaves(net._params[k])) + moments)
    return groups


def _adam_before(net):
    """What ``_adam_gap`` reads of the state a step starts from: the
    network's iteration and, on the CPU, each param group's weights and
    Adam moments."""
    return net._iteration, [
        [[t.detach().cpu().clone() for t in ts] for ts in group[1:]]
        for group in _adam_groups(net)]


def _norm_gap(got, want):
    """||got - want|| / ||want||, 0 where the two are equal."""
    d = float((got - want).norm())
    return d / max(float(want.norm()), 1e-30) if d else 0.0


def _adam_gap(before, got, want):
    """Two networks each stepped once by ``fit`` from the state ``before``
    (``_adam_before``): (the largest, over the param arrays, of the gap in
    norm between the gradients their first moments took in; the same of
    the squared gradients their second moments took in; the largest
    distance, in lr, of either network's weights from Adam's step of its
    own new moments (inf where a NoOp weight moved); the largest distance
    of the two networks' weights in lr; the weights more than PARAM_TOL lr
    apart; the weights in all)."""
    it, groups = before
    grad = sq = form = reach = 0.0
    apart = total = 0
    for (w0s, m0s, v0s), (upd, *mine), (_, *theirs) in zip(
            groups, _adam_groups(got), _adam_groups(want)):
        nets = [[[t.detach().cpu() for t in ts] for ts in leaves]
                for leaves in (mine, theirs)]
        if not m0s:
            if any(not bool((w0 == w1).all()) for w, _, _ in nets
                   for w0, w1 in zip(w0s, w)):
                form = float("inf")
            continue
        lr, bc = upd.lr(it), upd._bias_correction(it)
        b1, b2 = upd.beta1, upd.beta2
        for k, w0 in enumerate(w0s):
            d = nets[0][0][k] - nets[1][0][k]
            reach = max(reach, float(d.abs().max()) / lr)
            apart += int((d.abs() > PARAM_TOL * lr).sum())
            total += d.numel()
            took = []
            for w, m, v in nets:
                adam = lr * bc * m[k] / (v[k].sqrt() + upd.epsilon)
                form = max(form, float((w0 - w[k] - adam).abs().max()) / lr)
                took.append(((m[k] - b1 * m0s[k]) / (1 - b1),
                             (v[k] - b2 * v0s[k]) / (1 - b2)))
            grad = max(grad, _norm_gap(took[0][0], took[1][0]))
            sq = max(sq, _norm_gap(took[0][1], took[1][1]))
    if got._iteration != it + 1 or want._iteration != it + 1:
        fail(f"a fit call took {got._iteration - it} and "
             f"{want._iteration - it} steps, not one")
    return grad, sq, form, reach, apart, total


def _gap_text(gap):
    grad, sq, form, reach, apart, total = gap
    return (f"gradients apart by up to {grad:.3e} of an array's norm, "
            f"squared gradients {sq:.3e}; weights off Adam's step of their "
            f"moments by up to {form:.3e} lr; weights apart by up to "
            f"{reach:.4f} lr, {apart} of {total} by more than {PARAM_TOL} "
            f"lr")


def _adam_gate(name, step, gap):
    """Fails unless the gradient an Adam step took in agrees with the
    CPU's within RESNET_UPDATE_TOL of each array's norm, its square within
    twice that, and each device's weights moved by Adam's step of its own
    moments within PARAM_TOL lr."""
    grad, sq, form = gap[:3]
    if grad > RESNET_UPDATE_TOL or sq > 2 * RESNET_UPDATE_TOL or \
            form > PARAM_TOL:
        fail(f"{name}: step {step}: {_gap_text(gap)} (limits "
             f"{RESNET_UPDATE_TOL} and {2 * RESNET_UPDATE_TOL} of the norm, "
             f"{PARAM_TOL} lr)")


def _steps_from_same_state(torch, name, gpu, cpu, batches, bns=None):
    """One fit step a batch on the card and the CPU, each from the card's
    state: each step's loss (TRAIN_LOSS_TOL relative), the
    BatchNormalization running statistics (CNN_TOL of the largest) and
    what each Adam step took in and did (``_adam_gate``) gated; the CPU at
    one thread against itself at all as the yardstick of step 0."""
    graph = hasattr(gpu.conf, "nodes")
    if bns is None:
        bns = ([n for n, (node, _) in gpu.conf.nodes.items()
                if type(node).__name__ == "BatchNormalization"] if graph
               else [i for i, lr_ in enumerate(gpu.layers)
                     if type(lr_).__name__ == "BatchNormalization"])
    yard = _graph_cpu_twin(gpu) if graph else _cpu_twin(gpu)
    worst = worst_bn = 0.0
    for step, (x, y) in enumerate(batches):
        for twin in (cpu, yard) if step == 0 else (cpu,):
            _copy_state(torch, gpu, twin)
        before = _adam_before(cpu)
        t0 = time.perf_counter()
        gpu.fit((x, y))
        g_loss = gpu.score()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu.fit((x, y))
        t_cpu = time.perf_counter() - t0
        rel = abs(g_loss - cpu.score()) / abs(cpu.score())
        bn = max((_rel_err(gpu._states[n][k].cpu(), cpu._states[n][k])
                  for n in bns for k in ("mean", "var")), default=0.0)
        gap = _adam_gap(before, gpu, cpu)
        worst, worst_bn = max(worst, rel), max(worst_bn, bn)
        print(f"{name} step {step} (batch {x.shape[0]}, from the same "
              f"state): loss card {g_loss:.6f}, CPU {cpu.score():.6f} (rel "
              f"{rel:.3e}); running mean/var of {len(bns)} "
              f"BatchNormalization layers max|d|/max {bn:.3e}; "
              f"{_gap_text(gap)}; card {t_card:.3f} s, CPU {t_cpu:.3f} s",
              flush=True)
        if step == 0:
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                yard.fit((x, y))
            finally:
                torch.set_num_threads(threads)
            print(f"{name} step 0 on the CPU at 1 thread against {threads}:"
                  f" {_gap_text(_adam_gap(before, yard, cpu))}",
                  flush=True)
        _adam_gate(name, step, gap)
    del yard
    if worst > TRAIN_LOSS_TOL:
        fail(f"{name}: losses differ by {worst:.3e} > {TRAIN_LOSS_TOL}")
    if worst_bn > CNN_TOL:
        fail(f"{name}: running statistics differ by {worst_bn:.3e} > "
             f"{CNN_TOL}")


def _output_gap(gpu, cpu, xs, train=False):
    """max|card - CPU| / max|CPU| of the first output."""
    want = cpu.output(*xs, train=train) if hasattr(cpu.conf, "nodes") \
        else [cpu.output(xs[0], train=train)]
    got = gpu.output(*xs, train=train) if hasattr(gpu.conf, "nodes") \
        else [gpu.output(xs[0], train=train)]
    want, got = want[0].toNumpy(), got[0].toNumpy()
    if not np.isfinite(got).all():
        fail("a card output is not finite")
    return float(np.abs(got - want).max() / np.abs(want).max())


def _head_gap(torch, gpu, cpu, x, train=False):
    """max|card - CPU| / max|CPU| of a detector's head, the output
    layer's input (before the decode)."""
    heads = []
    for net in (gpu, cpu):
        with torch.no_grad():
            if hasattr(net.conf, "nodes"):
                env, _ = net._forward(net._params, net._states,
                                      {net.conf.inputs[0]: x}, train,
                                      stop_before_output=True)
                h = env[net.conf.outputs[0]]
            else:
                h, _ = net._forward(net._params, net._states,
                                    net._input(x), train,
                                    upto=len(net.layers) - 1)
        heads.append(h.cpu())
    return _rel_err(*heads)


def _detector_output_check(torch, name, gpu, cpu, x, train, what):
    """The head (CNN_TOL) and the decoded output (YOLO_DECODE_TOL) card
    against CPU."""
    head = _head_gap(torch, gpu, cpu, x, train)
    dec = _output_gap(gpu, cpu, [x], train)
    print(f"{name}: output ({what}) at batch {x.shape[0]} card vs CPU "
          f"max|d|/max: head {head:.3e}, decoded {dec:.3e}", flush=True)
    if head > CNN_TOL or dec > YOLO_DECODE_TOL:
        fail(f"{name}: output ({what}) card vs CPU head {head:.3e} (limit "
             f"{CNN_TOL}), decoded {dec:.3e} (limit {YOLO_DECODE_TOL})")


def _detector_fit_timing(torch, card, name, gpu, batch, macs, rng,
                         classes):
    """The fit step at ``batch`` by CUDA events, host clock over a fit call
    of YOLO_TIMED steps, images/s, the share of the float32 peak (6 FLOP a
    forward multiply-add), the peak memory, device time by kernel and the
    idle share."""
    from deeplearning4j_tpu_torch.datasets import DataSet

    ds = DataSet(*coco_batch(rng, batch, classes))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    med, lo, hi = time_ms(lambda: gpu.fit(ds), YOLO_TIMED, spread=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    host, _, _ = _fit_steps_ms(torch, gpu, [ds] * YOLO_TIMED, reps=1)
    flop = 6 * macs * batch
    bound = flop / PEAK_F32 * 1e3
    print(f"{name} ({card}): fit step at batch {batch} ({YOLO_SHAPE[1]}x"
          f"{YOLO_SHAPE[2]}, float32): {med:.3f} ms by CUDA events (min "
          f"{lo:.3f}, max {hi:.3f}; {YOLO_TIMED} steps), "
          f"{batch / med * 1e3:.1f} images/s; host clock {host:.3f} ms a "
          f"step over a fit call of {YOLO_TIMED}; {flop / 1e12:.3f} TFLOP "
          f"a step, {flop / med / 1e9:.2f} TFLOP/s, {100 * bound / med:.1f}%"
          f" of the float32 peak (bound {bound:.3f} ms); peak memory "
          f"{peak:.2f} GiB", flush=True)
    _profile_fit(torch, f"{name} b{batch}", gpu, ds, med, card, top=12)


def _yolo2_checks(torch, card):
    """YOLO2 (the zoo's, 416x416x3, 80 classes, the 5 COCO priors) on the
    card against its CPU twin: output in training mode; the running
    statistics set to one batch's, output in inference and the
    detections; 3 Adam steps at batch 4 from the same state; a zip; a
    served burst; then ``output`` at 16 and the fit step at batch 16 and
    64."""
    import tempfile
    from pathlib import Path

    from deeplearning4j_tpu_torch.models import YOLO2
    from deeplearning4j_tpu_torch.serving import BucketLadder
    from deeplearning4j_tpu_torch.tree_util import tree_leaves
    from deeplearning4j_tpu_torch.utils import ModelSerializer

    rng = np.random.default_rng(SEED + 416)
    t0 = time.perf_counter()
    gpu = YOLO2().init()
    init_s = time.perf_counter() - t0
    if gpu.device.type != "cuda":
        fail(f"YOLO2().init() put the graph on {gpu.device}, not cuda")
    kinds = [type(n).__name__ for n, _ in gpu.conf.nodes.values()]
    bns = [name for name, (n, _) in gpu.conf.nodes.items()
           if type(n).__name__ == "BatchNormalization"]
    macs = _graph_forward_macs(gpu.conf)
    print(f"yolo2: {gpu.numParams()} params, {len(kinds)} nodes "
          f"({kinds.count('ConvolutionLayer')} conv, {len(bns)} "
          f"BatchNormalization, SpaceToDepth reorg merged into the "
          f"{YOLO_GRID}x{YOLO_GRID} head); {macs / 1e9:.2f} G multiply-adds "
          f"an image forward; init {init_s:.2f} s", flush=True)
    if gpu.numParams() != YOLO_PARAMS or len(bns) != 22:
        fail(f"yolo2 has {gpu.numParams()} params, {len(bns)} "
             f"BatchNormalization nodes")
    cpu = _graph_cpu_twin(gpu)

    x, _ = coco_batch(rng, YOLO_CHECK_BATCH)
    _detector_output_check(torch, "yolo2", gpu, cpu, x, True,
                           "training mode, batch statistics")

    _calibrate_bn(torch, gpu, gpu._input(coco_batch(rng, 16)[0]))
    _copy_state(torch, gpu, cpu)
    x, _ = coco_batch(rng, YOLO_CHECK_BATCH)
    _detector_output_check(torch, "yolo2", gpu, cpu, x, False,
                           "inference, running statistics of one batch "
                           "of 16")
    _detection_check(torch, gpu, cpu, coco_batch(rng, 4)[0])

    batches = [coco_batch(rng, YOLO_STEP_BATCH) for _ in range(YOLO_STEPS)]
    print(f"yolo2: training labels hold "
          f"{[int(b[1][:, 4:].sum()) for b in batches]} boxes over "
          f"{YOLO_STEP_BATCH} images a batch", flush=True)
    _steps_from_same_state(torch, "yolo2", gpu, cpu, batches, bns)
    if any(float(gpu._states[n]["mean"].abs().max()) == 0 for n in bns):
        fail("yolo2: a BatchNormalization node kept no running mean")

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "yolo2.zip")
        ModelSerializer.writeModel(gpu, path)
        size = Path(path).stat().st_size
        back = ModelSerializer.restoreComputationGraph(path)
        back_cpu = ModelSerializer.restoreComputationGraph(path,
                                                           device="cpu")
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves([back._params, back._states, back._opt_states]),
        tree_leaves([gpu._params, gpu._states, gpu._opt_states])))
    want = gpu.outputSingle(x).toNumpy()
    bits = np.array_equal(back.outputSingle(x).toNumpy(), want)
    err = float(np.abs(back_cpu.outputSingle(x).toNumpy() - want).max()
                / np.abs(want).max())
    print(f"yolo2: zip {size} bytes; restored on the card: state equal "
          f"{same}, iteration {back.getIterationCount()}, output bit-equal "
          f"{bits}; restored on the CPU: output max|d|/max {err:.3e}",
          flush=True)
    if not (same and bits) or back.device.type != "cuda" or \
            back.getIterationCount() != gpu.getIterationCount() or \
            err > YOLO_DECODE_TOL:
        fail("yolo2: the restored graph differs from the saved one")
    del back, back_cpu, cpu

    requests = [coco_batch(rng, n)[0] for n in YOLO_BURST]
    answers, warmed, dispatches, _, serve_s = _serve_burst(
        torch, "yolo2", gpu, YOLO_SHAPE, requests,
        BucketLadder((1, 4, 8, 16)), ())
    worst = 0.0
    for r, y in zip(requests, answers):
        if y.shape != (r.shape[0], 5, 85, YOLO_GRID, YOLO_GRID) or \
                not np.isfinite(y).all():
            fail(f"yolo2: served {y.shape} for a request of {r.shape}")
        want = gpu.outputSingle(r).toNumpy()
        worst = max(worst, float(np.abs(y - want).max() / np.abs(want).max()))
    print(f"yolo2 ({card}): served {len(requests)} requests "
          f"({sum(YOLO_BURST)} images) in {len(dispatches)} dispatches "
          f"{sorted(s[0] for s in dispatches)}, {serve_s:.4f} s; warmup of "
          f"{len(warmed)} shapes; served vs outputSingle max|d|/max "
          f"{worst:.3e}", flush=True)
    # a bucket's batch may take another cuDNN algorithm than the
    # request's own batch: rows differ by the rounding the decode check
    # allows
    if worst > YOLO_DECODE_TOL:
        fail(f"yolo2: served rows vs outputSingle {worst:.3e} > "
             f"{YOLO_DECODE_TOL}")

    x16, _ = coco_batch(rng, 16)
    med, lo, hi = time_ms(lambda: gpu.outputSingle(x16), 10, spread=True)
    print(f"yolo2 ({card}): output at batch 16 {med:.3f} ms by CUDA events "
          f"(min {lo:.3f}, max {hi:.3f}), {16 / med * 1e3:.1f} images/s",
          flush=True)
    # reckoned before the run: about six float32 tensors a node output
    # kept for backward, plus params, gradients and Adam's two moments
    act = _activation_elements(gpu.conf)
    for n in YOLO_FIT_BATCHES:
        print(f"yolo2: batch {n} reckoned at ~"
              f"{(6 * act * n + 4 * gpu.numParams()) * 4 / 2**30:.1f} GiB "
              f"({act / 1e6:.1f} M activation elements an image)",
              flush=True)
    for n in YOLO_FIT_BATCHES:
        _detector_fit_timing(torch, card, "yolo2", gpu, n, macs, rng, 80)
    del gpu
    torch.cuda.empty_cache()


def _tiny_yolo_checks(torch, card):
    """TinyYOLO at VOC widths (416x416, 20 classes), a
    MultiLayerNetwork: output in training mode against its CPU twin, 2
    Adam steps from the same state, a served burst, the fit step at batch
    64."""
    from deeplearning4j_tpu_torch.models import TinyYOLO
    from deeplearning4j_tpu_torch.serving import BucketLadder

    rng = np.random.default_rng(SEED + 20)
    gpu = TinyYOLO().init()
    if gpu.device.type != "cuda" or gpu.numParams() != TINY_PARAMS:
        fail(f"TinyYOLO().init(): {gpu.numParams()} params on {gpu.device}")
    cpu = _cpu_twin(gpu)
    cpu._states = [{k: v.cpu() for k, v in s.items()} for s in gpu._states]
    x, _ = coco_batch(rng, YOLO_CHECK_BATCH, 20)
    print(f"tinyyolo: {gpu.numParams()} params", flush=True)
    _detector_output_check(torch, "tinyyolo", gpu, cpu, x, True,
                           "training mode, batch statistics")
    _steps_from_same_state(torch, "tinyyolo", gpu, cpu, [
        coco_batch(rng, YOLO_STEP_BATCH, 20) for _ in range(TINY_STEPS)])
    del cpu
    requests = [coco_batch(rng, n, 20)[0] for n in YOLO_BURST]
    answers, _, dispatches, _, serve_s = _serve_burst(
        torch, "tinyyolo", gpu, YOLO_SHAPE, requests,
        BucketLadder((1, 4, 8, 16)), ())
    worst = max(float(np.abs(y - gpu.output(r).toNumpy()).max()
                      / np.abs(gpu.output(r).toNumpy()).max())
                for r, y in zip(requests, answers))
    print(f"tinyyolo ({card}): served {len(requests)} requests in "
          f"{len(dispatches)} dispatches, {serve_s:.4f} s; served vs output "
          f"max|d|/max {worst:.3e}", flush=True)
    if worst > YOLO_DECODE_TOL or any(
            y.shape[1:] != (5, 25, YOLO_GRID, YOLO_GRID) for y in answers):
        fail(f"tinyyolo: served rows vs output {worst:.3e}")
    _detector_fit_timing(torch, card, "tinyyolo", gpu, TINY_FIT_BATCH,
                         _forward_macs(gpu.conf), rng, 20)
    del gpu
    torch.cuda.empty_cache()


def _wrapped_lstm_net_conf():
    """MaskZeroLayer(LSTM 64) over float sequences of IMDB's embedding
    width (128), a FrozenLayer(LSTM 64) above it, a per-step softmax."""
    from deeplearning4j_tpu_torch import nn
    from deeplearning4j_tpu_torch.optimize.updaters import Adam

    t, _, h = IMDB_SHAPE
    return (nn.NeuralNetConfiguration.Builder().seed(SEED).updater(
        Adam(1e-3)).list()
        .layer(nn.MaskZeroLayer(underlying=nn.LSTM.Builder().nOut(h)
                                .build()))
        .layer(nn.FrozenLayer(layer=nn.LSTM.Builder().nOut(h).build()))
        .layer(nn.RnnOutputLayer.Builder().nOut(2).activation("softmax")
               .lossFunction("mcxent").build())
        .setInputType(nn.InputType.recurrent(IMDB_EMBED, t))
        .build())


def wrapped_lstm_phase(torch, lstm):
    """Rows 1-3 through the wrappers at the IMDB widths (T=200, N=32,
    H=64): MaskZeroLayer(LSTM) over zero-padded float sequences, with a
    FrozenLayer(LSTM) above it, on the card against the CPU from the same
    weights: ``gradients`` (GRAD_TOL), ``output`` (KERNEL_TOL of the
    largest) with its row-2 launches, and WRAP_STEPS fit steps each from
    the same state (the main path: rows 1 and 3 launched, the loss to
    TRAIN_LOSS_TOL, the step by ``_adam_gate``), the frozen weights
    bit-equal. Returns the launches."""
    from deeplearning4j_tpu_torch.tree_util import tree_leaves

    t, n, h = IMDB_SHAPE
    conf = _wrapped_lstm_net_conf()
    rng = np.random.default_rng(SEED + 64)
    arrays = [_random_group(lr_.param_shapes(), rng) for lr_ in conf.layers]
    gpu, cpu = _net_pair(conf.to_json(), arrays)

    def batch():
        x = rng.normal(size=(n, IMDB_EMBED, t)).astype(np.float32)
        for i, length in enumerate(rng.integers(t // 4, t + 1, n)):
            x[i, :, length:] = 0.0          # zero-padded tails
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (n, t))]
        return x, y.transpose(0, 2, 1).copy()

    x, y = batch()
    worst_g = _worst_grad(torch, gpu.gradients(x, y), cpu.gradients(x, y))
    kernels = (lstm.lstm_seq_infer, lstm.lstm_seq_fwd, lstm.lstm_seq_bwd)
    out, infer = _launches(kernels, lambda: gpu.output(x).toNumpy())
    want = cpu.output(x).toNumpy()
    err = float(np.abs(out - want).max() / np.abs(want).max())
    pad = np.all(x == 0, axis=1)
    h1 = gpu.feedForward(x)[1].toNumpy().transpose(0, 2, 1)
    print(f"wrapped lstm: MaskZeroLayer(LSTM {h}) + FrozenLayer(LSTM {h}) "
          f"at T={t} N={n}: gradients card vs CPU max|d|/max {worst_g:.3e};"
          f" output {err:.3e}, launches {infer}; {int(pad.sum())} masked "
          f"steps, their outputs all zero {bool(np.all(h1[pad] == 0))}",
          flush=True)
    if worst_g > GRAD_TOL or err > KERNEL_TOL or not np.all(h1[pad] == 0):
        fail(f"wrapped lstm: gradients {worst_g:.3e}, output {err:.3e}")
    if infer != {"lstm_seq_infer": 2, "lstm_seq_fwd": 0,
                 "lstm_seq_bwd": 0}:
        fail(f"wrapped lstm: output launched {infer}")
    frozen = [p.clone() for p in tree_leaves(gpu._params[1])]
    batches = [batch() for _ in range(WRAP_STEPS)]

    def steps():
        for xb, yb in batches:
            gpu.fit((xb, yb))

    _copy_state(torch, gpu, cpu)
    before = _adam_before(cpu)
    _, fit = _launches(kernels, lambda: gpu.fit(batches[0]))
    cpu.fit(batches[0])
    rel = abs(gpu.score() - cpu.score()) / abs(cpu.score())
    gap = _adam_gap(before, gpu, cpu)
    for xb, yb in batches[1:]:
        _copy_state(torch, gpu, cpu)
        gpu.fit((xb, yb))
        cpu.fit((xb, yb))
        rel = max(rel, abs(gpu.score() - cpu.score()) / abs(cpu.score()))
    still = all(torch.equal(a, b) for a, b in zip(
        frozen, tree_leaves(gpu._params[1])))
    print(f"wrapped lstm: {WRAP_STEPS} Adam steps from the same state, "
          f"losses card vs CPU within {rel:.3e}; step 0: {_gap_text(gap)}; "
          f"launches in a step {fit}; the FrozenLayer's weights bit-equal "
          f"{still}", flush=True)
    _adam_gate("wrapped lstm", 0, gap)
    if rel > TRAIN_LOSS_TOL or not still:
        fail(f"wrapped lstm: losses {rel:.3e}, frozen weights kept "
             f"{still}")
    if fit != {"lstm_seq_infer": 0, "lstm_seq_fwd": 2, "lstm_seq_bwd": 2}:
        fail(f"wrapped lstm: a fit step launched {fit}")
    _, fit_all = _launches(kernels, steps)
    del gpu, cpu
    return {"fit": fit_all, "eval": infer}


def _small_nets():
    """Small-width networks holding every other class of this slice, as
    (name, configuration, input shapes, label shape, label kind)."""
    from deeplearning4j_tpu_torch import nn
    from deeplearning4j_tpu_torch.optimize.updaters import Adam

    def conf(layers, it):
        b = (nn.NeuralNetConfiguration.Builder().seed(SEED)
             .updater(Adam(SMALL_LR)).list())
        for lr_ in layers:
            b = b.layer(lr_)
        return b.setInputType(it).build()

    g = (nn.NeuralNetConfiguration.Builder().seed(SEED)
         .updater(Adam(SMALL_LR)).graphBuilder().addInputs("q", "kv"))
    g.setInputTypes(nn.InputType.recurrent(6, 10),
                    nn.InputType.recurrent(8, 12))
    g.addLayer("att", nn.AttentionVertex(nOut=8, nHeads=2), "q", "kv",
               "kv")
    g.addLayer("pool", nn.GlobalPoolingLayer.Builder().build(), "att")
    g.addLayer("out", nn.CenterLossOutputLayer.Builder().nOut(3)
               .lambdaCoeff(0.1).build(), "pool")
    g.setOutputs("out")
    return [
        ("conv3d", conf([
            nn.Convolution3D.Builder(nOut=4, kernelSize=[3, 3, 3],
                                     convolutionMode="same",
                                     activation="relu").build(),
            nn.Subsampling3DLayer.Builder(kernelSize=[2, 2, 2],
                                          stride=[2, 2, 2]).build(),
            nn.Cropping3D(cropping=(1, 0, 0)),
            nn.Upsampling3D(size=2),
            nn.Subsampling3DLayer.Builder(poolingType="avg",
                                          kernelSize=[2, 2, 2]).build(),
            nn.DenseLayer.Builder(nOut=16, activation="tanh").build(),
            nn.OutputLayer.Builder(nOut=3).build()],
            nn.InputType.convolutional3D(8, 8, 8, 2)),
         [(8, 2, 8, 8, 8)], 3, "classes"),
        ("conv2d", conf([
            nn.ConvolutionLayer.Builder().nOut(6).kernelSize([3, 3])
            .activation("relu").build(),
            nn.Cropping2D(cropping=(1, 0, 1, 1)),
            nn.PReLULayer(alphaInit=0.1),
            nn.LocallyConnected2D.Builder(nOut=4, kernelSize=[3, 3],
                                          stride=[2, 2]).build(),
            nn.FrozenLayer(layer=nn.BatchNormalization.Builder().build()),
            nn.CenterLossOutputLayer.Builder().nOut(3).lambdaCoeff(0.1)
            .build()], nn.InputType.convolutional(16, 16, 3)),
         [(8, 3, 16, 16)], 3, "classes"),
        ("sequence", conf([
            nn.RepeatVector(repetitionFactor=9),
            nn.Cropping1D(cropping=(1, 0)),
            nn.Upsampling1D(size=2),
            nn.LocallyConnected1D.Builder(nOut=8, kernelSize=3,
                                          activation="tanh").build(),
            nn.SelfAttentionLayer.Builder(nOut=8, nHeads=2).build(),
            nn.RecurrentAttentionLayer.Builder(nOut=6).build(),
            nn.LearnedSelfAttentionLayer.Builder(nOut=6, nHeads=2,
                                                 nQueries=4).build(),
            nn.RnnOutputLayer.Builder().nOut(2).build()],
            nn.InputType.feedForward(5)),
         [(8, 5)], (2, 4), "steps"),
        ("ocnn", conf([
            nn.ElementWiseMultiplicationLayer(activation="tanh"),
            nn.DenseLayer.Builder(nOut=8, activation="tanh").build(),
            nn.OCNNOutputLayer.Builder(hiddenSize=6, nu=0.1,
                                       windowSize=64).build()],
            nn.InputType.feedForward(4)),
         [(32, 4)], 1, "zeros"),
        ("capsnet", conf([
            nn.ConvolutionLayer.Builder().nOut(8).kernelSize([3, 3])
            .activation("relu").build(),
            nn.PrimaryCapsules.Builder(capsuleDimensions=4, channels=2,
                                       kernelSize=[3, 3],
                                       stride=[2, 2]).build(),
            nn.CapsuleLayer.Builder(capsules=3, capsuleDimensions=6,
                                    routings=3).build(),
            nn.CapsuleStrengthLayer.Builder().build(),
            nn.ActivationLayer.Builder().activation("softmax").build(),
            nn.LossLayer(lossFunction="mcxent", activation="identity")],
            nn.InputType.convolutional(12, 12, 1)),
         [(8, 1, 12, 12)], 3, "classes"),
        ("attention_vertex", g.build(), [(8, 6, 10), (8, 8, 12)], 3,
         "classes"),
    ]


def _pretrain_check(torch):
    """AutoEncoder and VAE: each layer's pretrain loss and its gradients
    with the same noise passed in (the AE's corruption mask, the VAE's
    eps) on the card against the CPU (GRAD_TOL of the largest), and one
    ``pretrainLayer`` step of each on the card."""
    from deeplearning4j_tpu_torch import nn
    from deeplearning4j_tpu_torch.optimize.updaters import Adam
    from deeplearning4j_tpu_torch.tree_util import tree_leaves

    conf = (nn.NeuralNetConfiguration.Builder().seed(SEED)
            .updater(Adam(SMALL_LR)).list()
            .layer(nn.AutoEncoder.Builder(nIn=64, nOut=32,
                                          corruptionLevel=0.3).build())
            .layer(nn.VariationalAutoencoder.Builder(
                nOut=8, encoderLayerSizes=(24,), decoderLayerSizes=(24,),
                numSamples=2,
                reconstructionDistribution="gaussian").build())
            .layer(nn.OutputLayer.Builder().nOut(4).build()).build())
    rng = np.random.default_rng(SEED + 7)
    arrays = [_random_group(lr_.param_shapes(), rng) for lr_ in conf.layers]
    gpu, cpu = _net_pair(conf.to_json(), arrays)
    x = (rng.random((32, 64)) > 0.5).astype(np.float32)
    for i, noise in ((0, {"keep": rng.random((32, 64)) > 0.3}),
                     (1, {"eps": rng.normal(size=(2, 32, 8)).astype(
                         np.float32)})):
        grads = []
        for net in (gpu, cpu):
            with torch.no_grad():
                h, _ = net._forward(net._params, net._states,
                                    net._input(x), upto=i)
            p = {k: v.detach().requires_grad_()
                 for k, v in net._params[i].items()}
            loss = net.layers[i].pretrain_loss(
                p, h, **{k: torch.as_tensor(v, device=net.device)
                         for k, v in noise.items()})
            grads.append((loss, torch.autograd.grad(
                loss, tree_leaves(p))))
        (lg, gg), (lc, gc) = grads
        lg, lc = float(lg.detach()), float(lc.detach())
        rel = abs(lg - lc) / abs(lc)
        g_err = max(_rel_err(a.cpu(), b) for a, b in zip(gg, gc))
        print(f"pretrain: {type(gpu.layers[i]).__name__} pretrain loss with"
              f" the noise passed in card {lg:.6f}, CPU {lc:.6f} (rel "
              f"{rel:.3e}); gradients max|d|/max {g_err:.3e}", flush=True)
        if rel > TRAIN_LOSS_TOL or g_err > GRAD_TOL:
            fail(f"pretrain: layer {i} card vs CPU loss {rel:.3e}, "
                 f"gradients {g_err:.3e}")
    for i in (0, 1):
        before = [p.clone() for p in tree_leaves(gpu._params[i])]
        gpu.pretrainLayer(i, (x, None))
        moved = max(float((a - b).abs().max()) for a, b in zip(
            before, tree_leaves(gpu._params[i])))
        if not np.isfinite(gpu.score()) or moved == 0:
            fail(f"pretrain: pretrainLayer({i}) on the card: loss "
                 f"{gpu.score()}, moved {moved}")


def small_layers_phase(torch):
    """Every other class of this slice at small widths, on the card
    against its CPU twin from the same weights: the output (CNN_TOL of
    the largest) and one Adam step (the loss to TRAIN_LOSS_TOL relative,
    the step by ``_adam_gate``, OCNN's state through the
    loss-state channel); then the pretrain check."""
    from deeplearning4j_tpu_torch.tree_util import tree_leaves

    rng = np.random.default_rng(SEED + 3)
    for name, conf, shapes, n_out, kind in _small_nets():
        graph = hasattr(conf, "nodes")
        if graph:
            from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

            gpu = ComputationGraph(conf).init()
            cpu = _graph_cpu_twin(gpu)
        else:
            from deeplearning4j_tpu_torch.nn.multilayer import (
                MultiLayerNetwork)

            gpu = MultiLayerNetwork(conf).init()
            cpu = _cpu_twin(gpu)
            cpu._states = [{k: v.cpu() for k, v in s.items()}
                           for s in gpu._states]
        xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
        n = shapes[0][0]
        if kind == "classes":
            y = np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, n)]
        elif kind == "steps":
            c, t = n_out
            y = np.eye(c, dtype=np.float32)[rng.integers(0, c, (n, t))]
            y = y.transpose(0, 2, 1).copy()
        else:
            y = np.zeros((n, n_out), np.float32)
        err = _output_gap(gpu, cpu, xs)
        before = _adam_before(cpu)
        data = (xs, [y]) if graph else (xs[0], y)
        if graph:
            from deeplearning4j_tpu_torch.datasets import MultiDataSet

            data = MultiDataSet(xs, [y])
        gpu.fit(data)
        cpu.fit(data)
        rel = abs(gpu.score() - cpu.score()) / max(abs(cpu.score()), 1e-30)
        gap = _adam_gap(before, gpu, cpu)
        kinds = sorted({type(node).__name__ for node in (
            [nd for nd, _ in conf.nodes.values()] if graph else
            conf.layers)})
        extra = ""
        if name == "ocnn":
            r_g, r_c = (float(s[-1]["r"]) for s in (gpu._states,
                                                     cpu._states))
            extra = f"; OCNN r card {r_g:.6f}, CPU {r_c:.6f}"
            if abs(r_g - r_c) > CNN_TOL * max(abs(r_c), 1e-30) or \
                    int(gpu._states[-1]["seen"]) != 1:
                fail(f"small {name}: OCNN state card {r_g} CPU {r_c}")
        print(f"small {name} ({', '.join(kinds)}): output card vs CPU "
              f"max|d|/max {err:.3e}; one step loss card {gpu.score():.6f}"
              f" CPU {cpu.score():.6f} (rel {rel:.3e}), {_gap_text(gap)}"
              f"{extra}", flush=True)
        _adam_gate(f"small {name}", 0, gap)
        if err > CNN_TOL or rel > TRAIN_LOSS_TOL:
            fail(f"small {name}: output {err:.3e}, loss {rel:.3e}")
        del gpu, cpu
    _pretrain_check(torch)


def detection_phase(torch, card, lstm):
    """YOLO2 (the zoo's ComputationGraph, 416x416x3, 80 classes) and
    TinyYOLO (VOC's 20 classes) through the port's entry points, rows 1-3
    through MaskZeroLayer(LSTM) and FrozenLayer(LSTM), and every other
    class of this slice at small widths, each on the card against its
    CPU twin. Returns the wrapped LSTM's launches."""
    t0 = time.perf_counter()
    flags = _tf32_flags(torch)
    if flags["cuda.matmul.allow_tf32"] or flags["cudnn.allow_tf32"] or \
            flags.get("cudnn.conv.fp32_precision", "ieee") != "ieee":
        fail(f"TF32 is on: {flags}")
    _yolo2_checks(torch, card)
    _tiny_yolo_checks(torch, card)
    wrapped = wrapped_lstm_phase(torch, lstm)
    small_layers_phase(torch)
    print(f"detection: phase {time.perf_counter() - t0:.2f} s", flush=True)
    return wrapped


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs a "
              "GPU", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.kernels import (
        bottleneck, build, flash, gru, lstm, probe_matmul, rnn_step)
    from deeplearning4j_tpu_torch.tools.probe_fused_block import STAGES

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"cuDNN {torch.backends.cudnn.version()}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    build.load_all(build.SOURCES)
    print(f"build: {', '.join(build.SOURCES)} "
          f"{time.perf_counter() - t0:.2f} s (in parallel)", flush=True)
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}", flush=True)

    lstm_plan_phase(torch, lstm)
    rows, max_err = kernel_phase(torch, lstm)
    train_rows, train_errs = train_kernel_phase(torch, lstm)
    lstm_edge_phase(torch, lstm)
    gru_rows, gru_errs = gru_kernel_phase(torch, gru)
    net, train_launches, _ = training_phase(torch, lstm)
    launches = slice_phase(torch, lstm, net)
    gru_net, gru_launches, _ = gru_training_phase(torch, gru)
    gru_launches["gru_seq_infer"] = gru_slice_phase(torch, gru, gru_net)
    del net, gru_net
    sd_launches = samediff_phase(torch, gru, lstm)
    samediff_ops_phase(torch)
    tf_bert_phase(torch)
    bilstm = bilstm_phase(torch, lstm)
    step_rows, step_errs = step_route_phase(torch, lstm, gru, rnn_step)
    step_launches = wide_rnn_phase(torch, lstm, gru, rnn_step)
    flash_rows, flash_errs = flash_phase(torch, flash)
    bert = bert_training_phase(torch, flash)
    flash_launches = dict(bert["launches"])
    flash_launches["flash_attention_infer"] = bert_serving_phase(
        torch, flash, bert["trainer"])
    del bert
    torch.cuda.empty_cache()
    probe_rows, probe_errs = probe_kernel_phase(torch, probe_matmul,
                                                bottleneck)
    probe_launches = probe_main_phase(torch, probe_matmul, bottleneck)
    lenet_phase(torch, card)
    cnn_phase(torch, card)
    resnet50_phase(torch, card)
    wrapped = detection_phase(torch, card, lstm)

    pallas = ("jax/experimental/pallas/ops/tpu/flash_attention.py:{} "
              "(via deeplearning4j_tpu/models/bert.py:197)")
    entries = [
        ("lstm_seq_infer", "lstm_seq_infer.cu", "kernels/lstm.py:115",
         launches, max_err, REPORT_SHAPE, rows[REPORT_SHAPE])] + [
        (name, source, f"kernels/lstm.py:{line}", train_launches[name],
         train_errs[name], REPORT_SHAPE, train_rows[name][REPORT_SHAPE])
        for name, source, line in (("lstm_seq_fwd", "lstm_seq_infer.cu", 97),
                                   ("lstm_seq_bwd", "lstm_seq_bwd.cu", 200))
    ] + [
        # rows 1-3 on the bidirectional classifier's path: row 2 launched
        # by evaluate, rows 1 and 3 by fit
        (name, source, f"kernels/lstm.py:{line}",
         bilstm["eval" if name == "lstm_seq_infer" else "fit"][name],
         (rows if name == "lstm_seq_infer" else
          train_rows[name])[IMDB_SHAPE]["err"], IMDB_SHAPE,
         dict((rows if name == "lstm_seq_infer" else
               train_rows[name])[IMDB_SHAPE], path="bilstm_imdb"))
        for name, source, line in (("lstm_seq_infer", "lstm_seq_infer.cu",
                                    115),
                                   ("lstm_seq_fwd", "lstm_seq_infer.cu", 97),
                                   ("lstm_seq_bwd", "lstm_seq_bwd.cu", 200))
    ] + [
        # rows 1-3 through MaskZeroLayer(LSTM) and FrozenLayer(LSTM): row 2
        # launched by output, rows 1 and 3 by fit
        (name, source, f"kernels/lstm.py:{line}",
         wrapped["eval" if name == "lstm_seq_infer" else "fit"][name],
         (rows if name == "lstm_seq_infer" else
          train_rows[name])[IMDB_SHAPE]["err"], IMDB_SHAPE,
         dict((rows if name == "lstm_seq_infer" else
               train_rows[name])[IMDB_SHAPE], path="maskzero_lstm"))
        for name, source, line in (("lstm_seq_infer", "lstm_seq_infer.cu",
                                    115),
                                   ("lstm_seq_fwd", "lstm_seq_infer.cu", 97),
                                   ("lstm_seq_bwd", "lstm_seq_bwd.cu", 200))
    ] + [
        (name, source, f"kernels/gru.py:{line}", gru_launches[name],
         gru_errs[name], shape, gru_rows[name][shape])
        for name, source, line, shape in (
            ("gru_seq_infer", "gru_seq.cu", 83, GRU_SERVE_SHAPE),
            ("gru_seq_fwd", "gru_seq.cu", 63, GRU_TRAIN_SHAPE),
            ("gru_seq_bwd", "gru_seq_bwd.cu", 159, GRU_TRAIN_SHAPE))
    ] + [
        # rows 4-6 on the SameDiff graph's path: rows 4 and 6 launched by
        # fit, row 5 by serving
        (name, source, f"kernels/gru.py:{line}", sd_launches[name],
         gru_errs[name], shape,
         dict(gru_rows[name][shape], path="samediff_gru"))
        for name, source, line, shape in (
            ("gru_seq_infer", "gru_seq.cu", 83, GRU_SERVE_SHAPE),
            ("gru_seq_fwd", "gru_seq.cu", 63, GRU_TRAIN_SHAPE),
            ("gru_seq_bwd", "gru_seq_bwd.cu", 159, GRU_TRAIN_SHAPE))
    ] + [
        (name, "rnn_step.cu", f"kernels/{cell}.py:{line}",
         step_launches[name], step_errs[name], STEP_REPORT[cell],
         step_rows[name][STEP_REPORT[cell]])
        for cell, lines in (("lstm", (115, 97, 200)), ("gru", (83, 63, 159)))
        for name, line in zip(STEP_NAMES[cell], lines)
    ] + [
        (name, source, pallas.format(line), flash_launches[name],
         flash_errs[name], FLASH_REPORT,
         flash_rows[name][(FLASH_REPORT, "bfloat16")])
        for name, source, line in (
            ("flash_fwd", "flash_attn_fwd.cu", 758),
            ("flash_attention_infer", "flash_attn_fwd.cu", 758),
            ("flash_bwd_dkv", "flash_attn_bwd.cu", 1121),
            ("flash_bwd_dq", "flash_attn_bwd.cu", 1456))] + [
        (name, PROBE_SOURCES.get(name, "fused_bottleneck.cu"),
         PROBE_REPLACES[name], probe_launches[name], probe_errs[name],
         MATMUL_REPORT if name == "matmul_bf16" else
         (PROBE_BATCH, *STAGES[PROBE_REPORT[0]], PROBE_REPORT[1]),
         probe_rows[name]) for name in PROBE_NAMES]
    for name, _, _, n_launch, *_ in entries:
        if not n_launch:
            fail(f"{name} was not launched on its main path")
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"deeplearning4j_tpu_torch/csrc/{source}",
        "replaces": (where if where.startswith(("jax/", "tools/")) else
                     f"deeplearning4j_tpu/{where}"),
        "shape": list(shape),
        "launches": n_launch,
        "max_abs_err": err,
        "ms": rep["ms"],
        "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"],
        "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"],
        **({"b2b_ms": rep["b2b_ms"]} if "b2b_ms" in rep else {}),
        **({"path": rep["path"]} if "path" in rep else {}),
        **({"halves": rep["halves"]} if "halves" in rep else {}),
    } for name, source, where, n_launch, err, shape, rep in entries]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
