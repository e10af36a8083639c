"""Non-causal flash attention as hand-written CUDA kernels, with its
gradient.

Counterpart of the Pallas TPU kernel that ``deeplearning4j_tpu/models/
bert.py`` calls (``jax.experimental.pallas.ops.tpu.flash_attention``,
``causal=False``, ``sm_scale = 1/sqrt(D)``, no bias, no segment ids). Its
three ``pallas_call``s become CUDA C++ (design and bounds are in each
file's header):

- ``_flash_attention_impl`` -> ``flash_fwd`` (training: also the row max m
  and row sum l, f32) and ``flash_attention_infer`` (o only), both
  ``csrc/flash_attn_fwd.cu``;
- ``_flash_attention_bwd_dkv`` -> ``flash_bwd_dkv`` and
  ``_flash_attention_bwd_dq`` -> ``flash_bwd_dq``, ``csrc/flash_attn_bwd.cu``
  (the dkv entry first computes ``di = rowsum(o do)``, as the reference's
  VJP does before its two kernels).

``flash_attention`` binds them into a ``torch.autograd.Function``, the
counterpart of the reference's ``jax.custom_vjp``.

Layout as in the JAX package: q, k, v [B, H, T, D], all of one dtype.
On CUDA the kernels take float32 or bfloat16 and D = 64 or 128, any
T >= 1. Each wrapper takes its plain version only for tensors on the CPU;
on a CUDA tensor it launches its kernel or raises. Each counts its
launches in ``.launches``.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.kernels import build
from deeplearning4j_tpu_torch.kernels.lstm import _count

HEAD_DIMS = (64, 128)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------


def _scores(q, k, sm_scale):
    """(q k^T) sm_scale in float32, as the kernel's f32 dot then scale."""
    return (q.float() @ k.float().transpose(-1, -2)) * sm_scale


def flash_fwd_reference(q, k, v, sm_scale):
    """The plain version of ``flash_fwd``: (o, m, l), m and l float32
    [B, H, T]. p is rounded to v's dtype before p.v, and o is written from
    the float32 sum once, as the kernel does."""
    s = _scores(q, k, sm_scale)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    pv = p.to(v.dtype).float() @ v.float()
    o = (pv * (1.0 / l)[..., None]).to(q.dtype)
    return o, m, l


def flash_attention_reference(q, k, v, sm_scale):
    """The plain version of ``flash_attention_infer``: o alone."""
    return flash_fwd_reference(q, k, v, sm_scale)[0]


def _bwd_parts(q, k, v, do, m, l, di, sm_scale):
    s = _scores(q, k, sm_scale)
    p = torch.exp(s - m[..., None]) * (1.0 / l)[..., None]
    dv = p.to(do.dtype).float().transpose(-1, -2) @ do.float()
    dp = do.float() @ v.float().transpose(-1, -2)
    ds = (dp - di[..., None]) * p * sm_scale
    dk = ds.to(do.dtype).float().transpose(-1, -2) @ q.float()
    dq = ds.to(k.dtype).float() @ k.float()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_di_reference(o, do):
    """di = rowsum(o do) in float32 [B, H, T]."""
    return (o.float() * do.float()).sum(dim=-1)


def flash_bwd_reference(q, k, v, o, do, m, l, sm_scale):
    """The plain version of the backward (``flash_bwd_dkv`` then
    ``flash_bwd_dq``), the reference VJP's math: di = rowsum(o do),
    p = exp(s - m) / l, ds = (dp - di) p sm_scale. Returns (dq, dk, dv)."""
    return _bwd_parts(q, k, v, do, m, l, flash_di_reference(o, do),
                      sm_scale)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(what, *tensors):
    """Shapes, dtypes and devices the wrappers share; returns
    (B, H, T, D)."""
    q = tensors[0]
    if q.dim() != 4 or min(q.shape) < 1:
        raise ValueError(f"{what}: q must be [B, H, T>=1, D], got "
                         f"{tuple(q.shape)}")
    for a in tensors[1:]:
        if tuple(a.shape) != tuple(q.shape):
            raise ValueError(f"{what}: shapes {tuple(q.shape)} and "
                             f"{tuple(a.shape)} differ")
        if a.dtype != q.dtype:
            raise ValueError(f"{what}: dtypes {q.dtype} and {a.dtype} "
                             f"differ")
        if a.device != q.device:
            raise ValueError(f"{what}: inputs lie on different devices")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {q.device}")
    return tuple(q.shape)


def _cuda_args(what, shape, tensors):
    """The tensors, contiguous, after checking what the kernels take."""
    d = shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head size {d} (the kernels take "
                         f"{HEAD_DIMS})")
    if tensors[0].dtype not in _SUFFIX:
        raise ValueError(f"{what}: dtype {tensors[0].dtype} (the kernels "
                         f"take float32 and bfloat16)")
    return [a.contiguous() for a in tensors]


def _scratch(like, shape):
    return torch.empty(shape, dtype=torch.float32, device=like.device)


def _fwd_launch(what, q, k, v, sm_scale, save):
    shape = _check(what, q, k, v)
    q, k, v = _cuda_args(what, shape, [q, k, v])
    b, h, t, d = shape
    o = torch.empty_like(q)
    m = _scratch(q, (b, h, t))
    l = _scratch(q, (b, h, t))
    build.call("flash_attn_fwd", f"flash_attn_fwd_{_SUFFIX[q.dtype]}", what,
               [q, k, v, o, m, l, b * h, t, d, float(sm_scale), int(save)],
               q.device)
    return o, m, l


def flash_fwd(q, k, v, sm_scale):
    """The training forward: (o, m, l), m and l float32 [B, H, T]."""
    _check("flash_fwd", q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, sm_scale)
    out = _fwd_launch("flash_fwd", q, k, v, sm_scale, True)
    _count(flash_fwd)
    return out


def flash_attention_infer(q, k, v, sm_scale):
    """Attention without residuals (o [B, H, T, D]), the route when no
    gradient is wanted: it refuses inputs that require grad while grad
    mode is on (``flash_attention`` is the differentiable route)."""
    _check("flash_attention_infer", q, k, v)
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (q, k, v)):
        raise RuntimeError(
            "flash_attention_infer has no gradient: call flash_attention "
            "for inputs that require grad, or run under torch.no_grad()")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, sm_scale)
    o = _fwd_launch("flash_attention_infer", q, k, v, sm_scale, False)[0]
    _count(flash_attention_infer)
    return o


def _check_stats(what, shape, q, *stats):
    for a in stats:
        if tuple(a.shape) != shape[:3] or a.dtype != torch.float32 \
                or a.device != q.device:
            raise ValueError(f"{what}: m, l and di must be float32 "
                             f"{list(shape[:3])} on {q.device}")


def flash_bwd_dkv(q, k, v, o, do, m, l, sm_scale):
    """dk, dv and di = rowsum(o do) [B, H, T] (float32)."""
    shape = _check("flash_bwd_dkv", q, k, v, o, do)
    _check_stats("flash_bwd_dkv", shape, q, m, l)
    if q.device.type == "cpu":
        di = flash_di_reference(o, do)
        _, dk, dv = _bwd_parts(q, k, v, do, m, l, di, sm_scale)
        return dk, dv, di
    q, k, v, o, do, m, l = _cuda_args("flash_bwd_dkv", shape,
                                      [q, k, v, o, do, m, l])
    b, h, t, d = shape
    di = _scratch(q, (b, h, t))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    build.call("flash_attn_bwd", f"flash_attn_bwd_dkv_{_SUFFIX[q.dtype]}",
               "flash_bwd_dkv", [q, k, v, o, do, m, l, di, dk, dv, b * h, t,
                                 d, float(sm_scale)], q.device)
    _count(flash_bwd_dkv)
    return dk, dv, di


def flash_bwd_dq(q, k, v, do, m, l, di, sm_scale):
    """dq, from the di that ``flash_bwd_dkv`` returned."""
    shape = _check("flash_bwd_dq", q, k, v, do)
    _check_stats("flash_bwd_dq", shape, q, m, l, di)
    if q.device.type == "cpu":
        return _bwd_parts(q, k, v, do, m, l, di, sm_scale)[0]
    q, k, v, do, m, l, di = _cuda_args("flash_bwd_dq", shape,
                                       [q, k, v, do, m, l, di])
    b, h, t, d = shape
    dq = torch.empty_like(q)
    build.call("flash_attn_bwd", f"flash_attn_bwd_dq_{_SUFFIX[q.dtype]}",
               "flash_bwd_dq", [q, k, v, do, m, l, di, dq, b * h, t, d,
                                float(sm_scale)], q.device)
    _count(flash_bwd_dq)
    return dq


for _fn in (flash_fwd, flash_attention_infer, flash_bwd_dkv, flash_bwd_dq):
    _fn.launches = 0


class _FlashAttention(torch.autograd.Function):
    """(q, k, v) -> o, with the gradient of all three."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        o, m, l = flash_fwd(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        do = do.contiguous()
        dk, dv, di = flash_bwd_dkv(q, k, v, o, do, m, l, ctx.sm_scale)
        dq = flash_bwd_dq(q, k, v, do, m, l, di, ctx.sm_scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, sm_scale):
    """Attention o [B, H, T, D] that autograd can differentiate:
    ``flash_fwd`` forward, ``flash_bwd_dkv`` and ``flash_bwd_dq`` backward
    (on the CPU their plain versions)."""
    _check("flash_attention", q, k, v)
    return _FlashAttention.apply(q, k, v, sm_scale)
