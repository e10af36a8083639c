"""Recurrent ops: ``lstmCell``, ``lstmLayer``, ``gruCell``, ``gruLayer``
and ``simpleRnnLayer``, registered in ``OPS`` by the JAX package's names.

Counterpart of the recurrent part of ``deeplearning4j_tpu/autodiff/ops.py``
(the rest of its op registry comes with later slices). LSTM gate order is
i, f, g(cell), o, as in DL4J's lstmLayer packing, and ``forgetBias`` is
added to the f pre-activation at every step. GRU gate order is r, u, then the candidate c, as in libnd4j's
gruCell.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.kernels.gru import gru_seq, gru_seq_infer
from deeplearning4j_tpu_torch.kernels.lstm import lstm_seq, lstm_seq_infer
from deeplearning4j_tpu_torch.nn.activations import resolve_activation


def _needs_grad(*tensors):
    """Grad mode is on and some input requires grad: the autograd route."""
    return torch.is_grad_enabled() and any(
        a is not None and a.requires_grad for a in tensors)


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
    seq = lstm_seq if _needs_grad(x, w, r, b, h0, c0) else lstm_seq_infer
    hs, hT, cT = seq(xw, r, h0, c0)
    if not returnFullSequence:
        return hT, hT, cT
    return hs.permute(1, 2, 0), hT, cT   # [N, H, T]


def gruCell(x, h_prev, w, r, b=None):
    """One GRU step (reset-after). x:[N,I], h_prev:[N,H], w:[I,3H],
    r:[H,3H], b:[6H] (r, u then c; input and recurrent biases separate,
    as in libnd4j's gruCell)."""
    hsz = h_prev.shape[-1]
    wz = x @ w
    rz = h_prev @ r
    if b is not None:
        wz = wz + b[:3 * hsz]
        rz = rz + b[3 * hsz:]
    ru = torch.sigmoid(wz[..., :2 * hsz] + rz[..., :2 * hsz])
    rgate, ugate = ru[..., :hsz], ru[..., hsz:]
    cand = torch.tanh(wz[..., 2 * hsz:] + rgate * rz[..., 2 * hsz:])
    return ugate * h_prev + (1 - ugate) * cand


def gruLayer(x, w, r, b=None, h0=None, resetAfter=True, activation="tanh"):
    """x: [N, I, T] (DL4J NCW layout). Returns ([N,H,T], hT).

    The input projection for ALL timesteps is hoisted out of the
    recurrence as one [T*N, I] x [I, 3H] matmul, with the input bias
    folded into it; only h.R stays inside the recurrence.

    resetAfter=True (the cuDNN / Keras-v2 convention): cand = act(xw_c +
    r (h R_c + rb_c)), b holds [3H input || 3H recurrent] (or only the 3H
    input half, rb then 0). With ``tanh`` in float32 the recurrence runs in
    ``kernels.gru`` (the CUDA kernels on the GPU, their plain versions on
    the CPU): ``gru_seq`` when grad mode is on and an input requires grad,
    ``gru_seq_infer`` otherwise. resetAfter=False (the classic Cho et al.
    form: cand = act(xw_c + (r h) R_c), b is 3H input-side only), another
    activation or another dtype runs a plain PyTorch loop over T on any
    device: the JAX package runs those as a ``lax.scan`` with no Pallas
    kernel either."""
    n, _, t = x.shape
    hsz = r.shape[0]
    if h0 is None:
        h0 = torch.zeros((n, hsz), dtype=x.dtype, device=x.device)
    xw = x.permute(2, 0, 1) @ w     # [T, N, 3H]: one batched matmul
    if b is not None:
        xw = xw + b[:3 * hsz]
    rb = b[3 * hsz:] if b is not None and b.shape[0] > 3 * hsz else None

    if resetAfter and activation == "tanh" and all(
            a is None or a.dtype == torch.float32 for a in (x, w, r, b, h0)):
        if rb is None:
            rb = torch.zeros(3 * hsz, dtype=r.dtype, device=r.device)
        seq = gru_seq if _needs_grad(x, w, r, b, h0) else gru_seq_infer
        hs, hT = seq(xw, r, rb, h0)
        return hs.permute(1, 2, 0), hT   # [N, H, T]

    act = resolve_activation(activation)
    h = h0
    hs = []
    for xw_t in xw:
        ru_w, c_w = xw_t[:, :2 * hsz], xw_t[:, 2 * hsz:]
        if resetAfter:
            rz = h @ r
            if rb is not None:
                rz = rz + rb
            ru = torch.sigmoid(ru_w + rz[:, :2 * hsz])
            cand = act(c_w + ru[:, :hsz] * rz[:, 2 * hsz:])
        else:
            ru = torch.sigmoid(ru_w + h @ r[:, :2 * hsz])
            cand = act(c_w + (ru[:, :hsz] * h) @ r[:, 2 * hsz:])
        u = ru[:, hsz:]
        h = u * h + (1.0 - u) * cand
        hs.append(h)
    return torch.stack(hs, dim=2), h


def simpleRnnLayer(x, w, r, b=None, h0=None, activation="tanh"):
    """x: [N, I, T] (DL4J NCW layout). Returns ([N,H,T], hT) of
    h_t = act(x_t W + b + h_{t-1} R).

    The input projection for ALL timesteps is hoisted out of the
    recurrence as one [T*N, I] x [I, H] matmul with the bias folded in, as
    the JAX package does; each step is then one ``addmm`` and the
    activation, a plain PyTorch loop on any device (the JAX package runs
    it as a ``lax.scan`` with no Pallas kernel)."""
    n = x.shape[0]
    hsz = r.shape[0]
    if h0 is None:
        h0 = torch.zeros((n, hsz), dtype=x.dtype, device=x.device)
    act = resolve_activation(activation)
    xw = x.permute(2, 0, 1) @ w     # [T, N, H]: one batched matmul
    if b is not None:
        xw = xw + b
    h = h0
    hs = []
    for xw_t in xw:
        h = act(torch.addmm(xw_t, h, r))
        hs.append(h)
    return torch.stack(hs, dim=2), h


OPS = {"lstmCell": lstmCell, "lstmLayer": lstmLayer, "gruCell": gruCell,
       "gruLayer": gruLayer, "simpleRnnLayer": simpleRnnLayer}
