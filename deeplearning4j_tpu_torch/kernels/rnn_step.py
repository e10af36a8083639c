"""The step route of the LSTM and GRU kernels, and the choice of route.

The persistent kernels (``csrc/lstm_seq_infer.cu``, ``lstm_seq_bwd.cu``,
``gru_seq.cu``, ``gru_seq_bwd.cu``) keep a slice of R in shared memory for
a whole sequence and need their grid co-resident. Past a width that
depends on N (the LSTM forward near H = 435, its backward near 300, the
GRU near 1,056) they cannot launch. There the JAX package leaves its
Pallas kernels for a ``lax.scan``; here ``csrc/rnn_step.cu`` takes over:
one ordinary launch per time step, R read from L2/HBM (design and bounds
in its header). The backward's dR (and drb) come from the persistent
sources' dR passes, which take any H.

The persistent sources answer, by shape and before any launch, whether
their kernel would launch on this card (``lstm_seq_fits``,
``lstm_seq_bwd_fits``, ``gru_seq_fits``, ``gru_seq_bwd_fits``: the launch's
own checks, shared memory and the occupancy calculator's co-resident
blocks, with nothing launched); the wrappers in ``lstm.py`` and ``gru.py``
ask through ``takes_persistent`` on CUDA tensors and never route by
catching a failed launch. The step wrappers below are what they call
otherwise; each counts one launch per sequence (T or T+1 kernel launches)
in ``.launches``, and for CPU tensors runs the same plain version as the
persistent route.
"""

from __future__ import annotations

import functools

import torch

from deeplearning4j_tpu_torch.kernels import build, gru, lstm
from deeplearning4j_tpu_torch.kernels.lstm import _count, _cuda_f32

# kind -> (source, entry, arguments after N and H)
_FITS = {
    "lstm_infer": ("lstm_seq_infer", "lstm_seq_fits", (0,)),
    "lstm_fwd": ("lstm_seq_infer", "lstm_seq_fits", (1,)),
    "lstm_bwd": ("lstm_seq_bwd", "lstm_seq_bwd_fits", ()),
    "gru_infer": ("gru_seq", "gru_seq_fits", (0,)),
    "gru_fwd": ("gru_seq", "gru_seq_fits", (1,)),
    "gru_bwd": ("gru_seq_bwd", "gru_seq_bwd_fits", ()),
}


@functools.lru_cache(maxsize=None)
def _fits(kind, n, hsz, device) -> int:
    source, entry, flags = _FITS[kind]
    return build.query(source, entry, f"{kind} route query",
                       [n, hsz, *flags], device)


def takes_persistent(kind, n, hsz, device) -> bool:
    """The route for a CUDA launch of ``kind`` (a key of ``_FITS``): the
    persistent kernel when its source finds it would launch at batch n and
    width hsz on this card (0); else, where R's slice does not fit in
    shared memory (-1) or the grid cannot be co-resident (-2), the step
    route."""
    if kind not in _FITS:
        raise ValueError(f"unknown persistent kernel {kind!r}")
    rc = _fits(kind, n, hsz, torch.device(device))
    if rc not in (0, -1, -2):
        raise RuntimeError(f"{kind} route query at N={n} H={hsz}: code "
                           f"{rc}")
    return rc == 0


# ---------------------------------------------------------------------------
# step-route wrappers
# ---------------------------------------------------------------------------

def lstm_step_infer(xw, r, h0, c0):
    """``lstm_seq_infer`` by the step route: (hs, hT, cT)."""
    lstm._check_shapes("lstm_step_infer", xw, r, h0, c0)
    if xw.device.type == "cpu":
        return lstm.lstm_seq_infer_reference(xw, r, h0, c0)
    xw, r, h0, c0 = _cuda_f32("lstm_step_infer", [xw, r, h0, c0])
    t, n, four_h = xw.shape
    hsz = four_h // 4
    hs = xw.new_empty((t, n, hsz))
    c = c0.clone()   # the c state, updated in place; ends as cT
    build.call("rnn_step", "rnn_step_fwd_lstm_f32", "lstm_step_infer",
               [xw, r, h0, c0, hs, c, None, None, 0, t, n, hsz], xw.device)
    _count(lstm_step_infer)
    return hs, hs[-1].clone(), c


def lstm_step_fwd(xw, r, h0, c0):
    """``lstm_seq_fwd`` by the step route: (hs, gates, cs)."""
    lstm._check_shapes("lstm_step_fwd", xw, r, h0, c0)
    if xw.device.type == "cpu":
        return lstm.lstm_seq_fwd_reference(xw, r, h0, c0)
    xw, r, h0, c0 = _cuda_f32("lstm_step_fwd", [xw, r, h0, c0])
    t, n, four_h = xw.shape
    hsz = four_h // 4
    hs = xw.new_empty((t, n, hsz))
    gates = xw.new_empty((t, n, four_h))
    cs = xw.new_empty((t, n, hsz))
    build.call("rnn_step", "rnn_step_fwd_lstm_f32", "lstm_step_fwd",
               [xw, r, h0, c0, hs, None, gates, cs, 1, t, n, hsz], xw.device)
    _count(lstm_step_fwd)
    return hs, gates, cs


def lstm_step_bwd(dhs, dhT, dcT, gates, cs, hs, r, h0, c0):
    """``lstm_seq_bwd`` by the step route: (dxw, dR, dh0, dc0)."""
    if dhs.device.type == "cpu":
        return lstm.lstm_seq_bwd_reference(dhs, dhT, dcT, gates, cs, hs, r,
                                           h0, c0)
    dhs, dhT, dcT, gates, cs, hs, r, h0, c0 = _cuda_f32(
        "lstm_step_bwd", [dhs, dhT, dcT, gates, cs, hs, r, h0, c0])
    t, n, hsz = dhs.shape
    dxw = gates.new_empty((t, n, 4 * hsz))
    dc = dcT.clone()   # the dc carry, updated in place; ends as dc0
    dh0 = gates.new_empty((n, hsz))
    build.call("rnn_step", "rnn_step_bwd_lstm_f32", "lstm_step_bwd",
               [dhs, dhT, gates, cs, r, c0, dxw, dc, dh0, t, n, hsz],
               dhs.device)
    dr = gates.new_empty((hsz, 4 * hsz))
    build.call("lstm_seq_bwd", "lstm_seq_bwd_dr_f32", "lstm_step_bwd dR",
               [hs, h0, dxw, dr, t, n, hsz], dhs.device)
    _count(lstm_step_bwd)
    return dxw, dr, dh0, dc


def gru_step_infer(xw, r, rb, h0):
    """``gru_seq_infer`` by the step route: (hs, hT)."""
    gru._check_shapes("gru_step_infer", xw, r, rb, h0)
    if xw.device.type == "cpu":
        return gru.gru_seq_infer_reference(xw, r, rb, h0)
    xw, r, rb, h0 = _cuda_f32("gru_step_infer", [xw, r, rb, h0])
    t, n, three_h = xw.shape
    hsz = three_h // 3
    hs = xw.new_empty((t, n, hsz))
    build.call("rnn_step", "rnn_step_fwd_gru_f32", "gru_step_infer",
               [xw, r, rb, h0, hs, None, None, None, 0, t, n, hsz], xw.device)
    _count(gru_step_infer)
    return hs, hs[-1].clone()


def gru_step_fwd(xw, r, rb, h0):
    """``gru_seq_fwd`` by the step route: (hs, ru, rz_c, cand)."""
    gru._check_shapes("gru_step_fwd", xw, r, rb, h0)
    if xw.device.type == "cpu":
        return gru.gru_seq_fwd_reference(xw, r, rb, h0)
    xw, r, rb, h0 = _cuda_f32("gru_step_fwd", [xw, r, rb, h0])
    t, n, three_h = xw.shape
    hsz = three_h // 3
    hs = xw.new_empty((t, n, hsz))
    ru = xw.new_empty((t, n, 2 * hsz))
    rzc = xw.new_empty((t, n, hsz))
    cand = xw.new_empty((t, n, hsz))
    build.call("rnn_step", "rnn_step_fwd_gru_f32", "gru_step_fwd",
               [xw, r, rb, h0, hs, ru, rzc, cand, 1, t, n, hsz], xw.device)
    _count(gru_step_fwd)
    return hs, ru, rzc, cand


def gru_step_bwd(dhs, dhT, ru, rzc, cand, hs, r, h0):
    """``gru_seq_bwd`` by the step route: (dxw, dR, drb, dh0)."""
    if dhs.device.type == "cpu":
        return gru.gru_seq_bwd_reference(dhs, dhT, ru, rzc, cand, hs, r, h0)
    dhs, dhT, ru, rzc, cand, hs, r, h0 = _cuda_f32(
        "gru_step_bwd", [dhs, dhT, ru, rzc, cand, hs, r, h0])
    t, n, hsz = dhs.shape
    dxw = ru.new_empty((t, n, 3 * hsz))
    drz = ru.new_empty((t, n, 3 * hsz))
    dhu = ru.new_empty((n, hsz))
    dh0 = ru.new_empty((n, hsz))
    build.call("rnn_step", "rnn_step_bwd_gru_f32", "gru_step_bwd",
               [dhs, dhT, ru, rzc, cand, hs, r, h0, dxw, drz, dhu, dh0, t, n,
                hsz], dhs.device)
    dr = ru.new_empty((hsz, 3 * hsz))
    drb = ru.new_empty((3 * hsz,))
    build.call("gru_seq_bwd", "gru_seq_bwd_dr_f32", "gru_step_bwd dR",
               [hs, h0, drz, dr, drb, t, n, hsz], dhs.device)
    _count(gru_step_bwd)
    return dxw, dr, drb, dh0


for _fn in (lstm_step_infer, lstm_step_fwd, lstm_step_bwd, gru_step_infer,
            gru_step_fwd, gru_step_bwd):
    _fn.launches = 0
