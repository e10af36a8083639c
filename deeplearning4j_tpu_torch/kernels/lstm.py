"""LSTM recurrence (inference) as a hand-written CUDA kernel.

Counterpart of ``deeplearning4j_tpu/kernels/lstm.py``: its inference
primal ``_fwd_infer_kernel`` becomes ``csrc/lstm_seq_infer.cu`` (design
and bounds are in that file's header). The training half (residual-saving
forward and the BPTT backward) comes with the training slice.

Layouts as in the JAX package: xw [T, N, 4H] f32 (input projection with
bias and forgetBias folded in), R [H, 4H], h0/c0 [N, H] -> (hs [T, N, H],
hT, cT). Gate packing i, f, g, o.

``lstm_seq_infer`` takes its plain version only for tensors on the CPU.
On a CUDA tensor it launches the kernel, or raises: a build or launch
failure is an error, never a silent reroute.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from deeplearning4j_tpu_torch.kernels import build

_NAME = "lstm_seq_infer"
_count_lock = threading.Lock()


def lstm_seq_infer_reference(xw, r, h0, c0):
    """The plain PyTorch version: a loop over T with the kernel's math."""
    hsz = r.shape[0]
    h, c = h0, c0
    hs = []
    for t in range(xw.shape[0]):
        z = xw[t] + h @ r
        i = torch.sigmoid(z[:, :hsz])
        f = torch.sigmoid(z[:, hsz:2 * hsz])
        g = torch.tanh(z[:, 2 * hsz:3 * hsz])
        o = torch.sigmoid(z[:, 3 * hsz:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs), h, c


def _library():
    lib = build.load(_NAME)
    fn = lib.lstm_seq_infer_f32
    if fn.argtypes is None:   # declare once: pointers are 64-bit
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.lstm_seq_infer_error_string.argtypes = [ctypes.c_int]
        lib.lstm_seq_infer_error_string.restype = ctypes.c_char_p
    return lib


def _check_shapes(xw, r, h0, c0):
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
            raise ValueError("lstm_seq_infer inputs lie on different devices")


def lstm_seq_infer(xw, r, h0, c0):
    """Full LSTM recurrence: (hs [T,N,H], hT [N,H], cT [N,H])."""
    _check_shapes(xw, r, h0, c0)
    if xw.device.type == "cpu":
        return lstm_seq_infer_reference(xw, r, h0, c0)
    if xw.device.type != "cuda":
        raise ValueError(f"lstm_seq_infer: unsupported device {xw.device}")
    for a in (xw, r, h0, c0):
        if a.dtype != torch.float32:
            raise NotImplementedError(
                f"the lstm_seq_infer kernel takes float32, got {a.dtype}")
    lib = _library()
    xw, r, h0, c0 = (a.contiguous() for a in (xw, r, h0, c0))
    t, n, four_h = xw.shape
    hsz = four_h // 4
    hs = torch.empty((t, n, hsz), dtype=torch.float32, device=xw.device)
    hT = torch.empty((n, hsz), dtype=torch.float32, device=xw.device)
    cT = torch.empty((n, hsz), dtype=torch.float32, device=xw.device)
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream(xw.device).cuda_stream
        rc = lib.lstm_seq_infer_f32(
            xw.data_ptr(), r.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            hs.data_ptr(), hT.data_ptr(), cT.data_ptr(), t, n, hsz, stream)
    if rc == -1:
        raise ValueError(f"lstm_seq_infer: H={hsz} is too large for the "
                         f"kernel's shared-memory R slice on this device")
    if rc == -2:
        raise ValueError("lstm_seq_infer: the cooperative grid for "
                         f"H={hsz} cannot be co-resident on this device")
    if rc != 0:
        msg = lib.lstm_seq_infer_error_string(rc).decode()
        raise RuntimeError(f"lstm_seq_infer launch failed: {msg} ({rc})")
    with _count_lock:
        lstm_seq_infer.launches += 1
    return hs, hT, cT


lstm_seq_infer.launches = 0
