"""LSTM recurrence as hand-written CUDA kernels, with its gradient.

Counterpart of ``deeplearning4j_tpu/kernels/lstm.py``. Its three Pallas
kernels become CUDA C++ (design and bounds are in each file's header):

- ``_fwd_infer_kernel`` -> ``lstm_seq_infer`` (``csrc/lstm_seq_infer.cu``,
  entry ``lstm_seq_infer_f32``): the inference recurrence;
- ``_fwd_kernel`` -> ``lstm_seq_fwd`` (the same source built with its
  residual-saving flag, entry ``lstm_seq_fwd_f32``): the training forward,
  which also writes the post-activation gates and the cell states;
- ``_bwd_kernel`` -> ``lstm_seq_bwd`` (``csrc/lstm_seq_bwd.cu``): the
  reverse sweep through time and the dR reduction.

``lstm_seq`` binds the last two into a ``torch.autograd.Function``, the
counterpart of the JAX package's ``jax.custom_vjp``.

Layouts as in the JAX package: xw [T, N, 4H] (input projection with bias
and forgetBias folded in), R [H, 4H], h0/c0 [N, H]. Gate packing i, f, g,
o.

Each wrapper takes its plain version only for tensors on the CPU. On a
CUDA tensor it launches its kernel, or raises: a build or launch failure is
an error, never a silent reroute. Each counts its launches in
``.launches``. Widths whose persistent kernel cannot launch on the card
(about H > 435 for the forward, H > 300 for the backward) take the step
route of ``kernels/rnn_step.py``, chosen by shape before the launch, which
counts its own launches.
"""

from __future__ import annotations

import threading

import torch

from deeplearning4j_tpu_torch.kernels import build

_count_lock = threading.Lock()


def _count(fn):
    with _count_lock:
        fn.launches += 1


def _route():
    """``kernels/rnn_step.py``, which picks the persistent kernel or the
    step route by shape (imported here: it imports this module)."""
    from deeplearning4j_tpu_torch.kernels import rnn_step

    return rnn_step


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------

def _gate_step(z, c_prev, hsz):
    i = torch.sigmoid(z[:, :hsz])
    f = torch.sigmoid(z[:, hsz:2 * hsz])
    g = torch.tanh(z[:, 2 * hsz:3 * hsz])
    o = torch.sigmoid(z[:, 3 * hsz:])
    c = f * c_prev + i * g
    return i, f, g, o, c, o * torch.tanh(c)


def lstm_seq_infer_reference(xw, r, h0, c0):
    """The plain version of ``lstm_seq_infer``: a loop over T with the
    kernel's math."""
    hsz = r.shape[0]
    h, c = h0, c0
    hs = []
    for t in range(xw.shape[0]):
        *_, c, h = _gate_step(xw[t] + h @ r, c, hsz)
        hs.append(h)
    return torch.stack(hs), h, c


def lstm_seq_fwd_reference(xw, r, h0, c0):
    """The plain version of ``lstm_seq_fwd``: (hs, gates, cs), gates the
    post-activation [i|f|g|o] of every step."""
    hsz = r.shape[0]
    h, c = h0, c0
    hs, gates, cs = [], [], []
    for t in range(xw.shape[0]):
        i, f, g, o, c, h = _gate_step(xw[t] + h @ r, c, hsz)
        hs.append(h)
        gates.append(torch.cat([i, f, g, o], dim=1))
        cs.append(c)
    return torch.stack(hs), torch.stack(gates), torch.stack(cs)


def lstm_seq_bwd_reference(dhs, dhT, dcT, gates, cs, hs, r, h0, c0):
    """The plain version of ``lstm_seq_bwd``: an explicit reverse loop with
    the math of the JAX package's ``_bwd_kernel`` (not autograd through a
    forward loop). Returns (dxw, dR, dh0, dc0)."""
    hsz = r.shape[0]
    dh_rec, dc = dhT, dcT
    dxw = torch.empty_like(gates)
    dr = torch.zeros_like(r)
    for t in reversed(range(dhs.shape[0])):
        i, f, g, o = gates[t].split(hsz, dim=1)
        c_prev = cs[t - 1] if t else c0
        h_prev = hs[t - 1] if t else h0
        tc = torch.tanh(cs[t])
        dh = dhs[t] + dh_rec
        do = dh * tc
        dc = dc + dh * o * (1.0 - tc * tc)
        dz = torch.cat([dc * g * i * (1.0 - i),
                        dc * c_prev * f * (1.0 - f),
                        dc * i * (1.0 - g * g),
                        do * o * (1.0 - o)], dim=1)
        dxw[t] = dz
        dh_rec = dz @ r.T
        dc = dc * f
        dr += h_prev.T @ dz
    return dxw, dr, dh_rec, dc


# ---------------------------------------------------------------------------
# kernel bindings
# ---------------------------------------------------------------------------

def _launch(name, entry, what, tensors, t, n, hsz, device):
    """``entry(*tensors, T, N, H, stream)`` of ``csrc/<name>.cu``. The
    route was chosen by shape (``_route().takes_persistent``, the
    source's own checks), so a persistent kernel that still finds no room
    (-1) or no co-resident grid (-2) is a fault, and raises."""
    build.call(name, entry, what, [*tensors, t, n, hsz], device)


def _check_shapes(what, xw, r, h0, c0):
    if xw.dim() != 3 or min(xw.shape) < 1:
        raise ValueError(f"xw must be [T>=1, N>=1, 4H>=4], got "
                         f"{tuple(xw.shape)}")
    _, n, four_h = xw.shape
    hsz = r.shape[0]
    if four_h != 4 * hsz or tuple(r.shape) != (hsz, 4 * hsz):
        raise ValueError(f"xw {tuple(xw.shape)} and R {tuple(r.shape)} do "
                         f"not agree on H")
    for name, a in (("h0", h0), ("c0", c0)):
        if tuple(a.shape) != (n, hsz):
            raise ValueError(f"{name} must be [{n}, {hsz}], got "
                             f"{tuple(a.shape)}")
    for a in (r, h0, c0):
        if a.device != xw.device:
            raise ValueError(f"{what} inputs lie on different devices")


def _cuda_f32(what, tensors):
    """The tensors, contiguous, after checking they are float32 on CUDA."""
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {device}")
    for a in tensors:
        if a.dtype != torch.float32:
            raise NotImplementedError(
                f"the {what} kernel takes float32, got {a.dtype}")
    return [a.contiguous() for a in tensors]


def lstm_seq_infer(xw, r, h0, c0):
    """Full LSTM recurrence without residuals: (hs [T,N,H], hT, cT).

    The inference route: its outputs carry no graph on the GPU, so it
    refuses inputs that require grad while grad mode is on (``lstm_seq``
    is the differentiable route)."""
    _check_shapes("lstm_seq_infer", xw, r, h0, c0)
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (xw, r, h0, c0)):
        raise RuntimeError(
            "lstm_seq_infer has no gradient: call lstm_seq for inputs that "
            "require grad, or run under torch.no_grad()/inference_mode()")
    if xw.device.type == "cpu":
        return lstm_seq_infer_reference(xw, r, h0, c0)
    xw, r, h0, c0 = _cuda_f32("lstm_seq_infer", [xw, r, h0, c0])
    t, n, four_h = xw.shape
    hsz = four_h // 4
    if not _route().takes_persistent("lstm_infer", n, hsz, xw.device):
        return _route().lstm_step_infer(xw, r, h0, c0)
    hs = xw.new_empty((t, n, hsz))
    hT = xw.new_empty((n, hsz))
    cT = xw.new_empty((n, hsz))
    _launch("lstm_seq_infer", "lstm_seq_infer_f32", "lstm_seq_infer",
            [xw, r, h0, c0, hs, hT, cT], t, n, hsz, xw.device)
    _count(lstm_seq_infer)
    return hs, hT, cT


def lstm_seq_fwd(xw, r, h0, c0):
    """The training forward: (hs [T,N,H], gates [T,N,4H], cs [T,N,H])."""
    _check_shapes("lstm_seq_fwd", xw, r, h0, c0)
    if xw.device.type == "cpu":
        return lstm_seq_fwd_reference(xw, r, h0, c0)
    xw, r, h0, c0 = _cuda_f32("lstm_seq_fwd", [xw, r, h0, c0])
    t, n, four_h = xw.shape
    hsz = four_h // 4
    if not _route().takes_persistent("lstm_fwd", n, hsz, xw.device):
        return _route().lstm_step_fwd(xw, r, h0, c0)
    hs = xw.new_empty((t, n, hsz))
    gates = xw.new_empty((t, n, four_h))
    cs = xw.new_empty((t, n, hsz))
    _launch("lstm_seq_infer", "lstm_seq_fwd_f32", "lstm_seq_fwd",
            [xw, r, h0, c0, hs, gates, cs], t, n, hsz, xw.device)
    _count(lstm_seq_fwd)
    return hs, gates, cs


def lstm_seq_bwd(dhs, dhT, dcT, gates, cs, hs, r, h0, c0):
    """The backward through time: (dxw [T,N,4H], dR [H,4H], dh0, dc0)."""
    t, n, hsz = dhs.shape
    want = {"dhT": (n, hsz), "dcT": (n, hsz), "gates": (t, n, 4 * hsz),
            "cs": (t, n, hsz), "hs": (t, n, hsz), "r": (hsz, 4 * hsz),
            "h0": (n, hsz), "c0": (n, hsz)}
    args = dict(dhT=dhT, dcT=dcT, gates=gates, cs=cs, hs=hs, r=r, h0=h0,
                c0=c0)
    for name, shape in want.items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"lstm_seq_bwd: {name} must be {list(shape)}, "
                             f"got {list(args[name].shape)}")
        if args[name].device != dhs.device:
            raise ValueError("lstm_seq_bwd inputs lie on different devices")
    if dhs.device.type == "cpu":
        return lstm_seq_bwd_reference(dhs, dhT, dcT, gates, cs, hs, r, h0,
                                      c0)
    ins = _cuda_f32("lstm_seq_bwd",
                    [dhs, dhT, dcT, gates, cs, hs, r, h0, c0])
    if not _route().takes_persistent("lstm_bwd", n, hsz, dhs.device):
        return _route().lstm_step_bwd(*ins)
    dxw = gates.new_empty((t, n, 4 * hsz))
    dr = gates.new_empty((hsz, 4 * hsz))
    dh0 = gates.new_empty((n, hsz))
    dc0 = gates.new_empty((n, hsz))
    _launch("lstm_seq_bwd", "lstm_seq_bwd_f32", "lstm_seq_bwd",
            ins + [dxw, dr, dh0, dc0], t, n, hsz, dhs.device)
    _count(lstm_seq_bwd)
    return dxw, dr, dh0, dc0


for _fn in (lstm_seq_infer, lstm_seq_fwd, lstm_seq_bwd):
    _fn.launches = 0


class _LstmSeq(torch.autograd.Function):
    """(xw, R, h0, c0) -> (hs, hT, cT), with the gradient of all four."""

    @staticmethod
    def forward(ctx, xw, r, h0, c0):
        hs, gates, cs = lstm_seq_fwd(xw, r, h0, c0)
        ctx.save_for_backward(gates, cs, hs, r, h0, c0)
        # copies, so that no output is a view of another
        return hs, hs[-1].clone(), cs[-1].clone()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dhs, dhT, dcT):
        gates, cs, hs, r, h0, c0 = ctx.saved_tensors
        return lstm_seq_bwd(dhs, dhT, dcT, gates, cs, hs, r, h0, c0)


def lstm_seq(xw, r, h0, c0):
    """Full LSTM recurrence (hs [T,N,H], hT, cT) that autograd can
    differentiate: ``lstm_seq_fwd`` forward, ``lstm_seq_bwd`` backward (on
    the CPU their plain versions)."""
    _check_shapes("lstm_seq", xw, r, h0, c0)
    return _LstmSeq.apply(xw, r, h0, c0)
