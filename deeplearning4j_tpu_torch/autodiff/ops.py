"""Recurrent ops: ``lstmCell`` and ``lstmLayer``.

Counterpart of the LSTM part of ``deeplearning4j_tpu/autodiff/ops.py``
(the rest of its op registry comes with later slices). Gate order is
i, f, g(cell), o, as in DL4J's lstmLayer packing, and ``forgetBias`` is
added to the f pre-activation at every step.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.kernels.lstm import lstm_seq, lstm_seq_infer


def lstmCell(x, h_prev, c_prev, w, r, b=None, forgetBias=0.0):
    """One LSTM step. x:[N,I], h_prev/c_prev:[N,H], w:[I,4H], r:[H,4H],
    b:[4H]."""
    z = x @ w + h_prev @ r
    if b is not None:
        z = z + b
    hsz = h_prev.shape[-1]
    i, f, g, o = (z[..., k * hsz:(k + 1) * hsz] for k in range(4))
    i = torch.sigmoid(i)
    f = torch.sigmoid(f + forgetBias)
    g = torch.tanh(g)
    o = torch.sigmoid(o)
    c = f * c_prev + i * g
    h = o * torch.tanh(c)
    return h, c


def lstmLayer(x, w, r, b=None, h0=None, c0=None, forgetBias=0.0,
              returnFullSequence=True):
    """x: [N, I, T] (DL4J NCW layout). Returns ([N,H,T], hT, cT), or
    (hT, hT, cT) when not returnFullSequence.

    The input projection for ALL timesteps is hoisted out of the
    recurrence as one [T*N, I] x [I, 4H] matmul, with the bias and
    forgetBias folded into it; only h.R stays inside the recurrence,
    which runs in ``kernels.lstm.lstm_seq_infer`` (the CUDA kernel on the
    GPU, its plain version on the CPU)."""
    n, _, t = x.shape
    hsz = r.shape[0]
    if x.device.type == "cuda" and any(
            a is not None and a.dtype != torch.float32
            for a in (x, w, r, b, h0, c0)):
        raise NotImplementedError(
            "lstmLayer on CUDA runs the float32 recurrence kernel only; "
            "other precisions come with the precision slice (ROADMAP.md, "
            "queue 1)")
    if h0 is None:
        h0 = torch.zeros((n, hsz), dtype=x.dtype, device=x.device)
    if c0 is None:
        c0 = torch.zeros((n, hsz), dtype=x.dtype, device=x.device)

    xw = x.permute(2, 0, 1) @ w     # [T, N, 4H]: one batched matmul
    if b is not None:
        xw = xw + b
    if forgetBias:
        xw[:, :, hsz:2 * hsz] += forgetBias   # xw is a fresh tensor here
    needs_grad = torch.is_grad_enabled() and any(
        a is not None and a.requires_grad for a in (x, w, r, b, h0, c0))
    hs, hT, cT = (lstm_seq if needs_grad else lstm_seq_infer)(xw, r, h0, c0)
    if not returnFullSequence:
        return hT, hT, cT
    return hs.permute(1, 2, 0), hT, cT   # [N, H, T]
