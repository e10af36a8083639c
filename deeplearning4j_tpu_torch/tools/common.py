"""What the probes share: the card's peak, timing and output."""

from __future__ import annotations

import json
import time

import torch

# H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)
H100_PEAK_BF16 = 989e12


def time_ms(fn, iters, device, reps=3):
    """Milliseconds a call of ``fn()``: the best of ``reps`` runs of
    ``iters`` calls, after one warm-up call. On CUDA the runs are timed by
    CUDA events on the current stream; on the CPU by the host clock."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / iters)
    return best


def measurement(device, ms, flops, **fields):
    """One probe record: ``fields``, ms, the device, and on CUDA the
    fraction of the H100's dense bf16 peak that ``flops`` in ``ms`` make
    (none for a CPU run, which measures no device)."""
    rec = dict(fields, ms=ms)
    if device.type == "cuda":
        rec["frac_of_peak"] = flops / (ms * 1e-3) / H100_PEAK_BF16
        rec["device"] = torch.cuda.get_device_name(device)
    else:
        rec["device"] = "cpu"
    return emit(rec)


def emit(rec):
    """Print ``rec`` as one JSON line; return it."""
    print(json.dumps(rec), flush=True)
    return rec
