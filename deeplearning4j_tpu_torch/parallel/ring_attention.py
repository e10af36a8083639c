"""Ring attention: sequence parallelism over the ``seq`` mesh axis.

Counterpart of ``deeplearning4j_tpu/parallel/ring_attention.py``, with its
arithmetic: the sequence is cut into n blocks (n the axis size), each
query block meets every K/V block in turn, and a flash-style online
softmax (running max m, running sum l, output o) accumulates the result,
with the reference's guards for rows that every key so far has masked
(``-inf`` maxima). A mesh without the axis takes the dense route.

The reference's ring is plain ``jnp`` (einsums under ``shard_map``, the
blocks rotated by ``lax.ppermute``), and so is the port's: plain PyTorch
ops, no kernel.

- **One process** (the axis's positions all belong to this process):
  ``q, k, v`` are the whole [B, H, T, D] arrays. Block i's K/V sit on
  position i's device and rotate with ``.to()``
  (``transport.ring_shift``); the n query blocks are batched, so a ring
  step's scores take [B, H, n, T/n, T/n], which is [B, H, T, T/n], not
  T². Autograd runs through the loop.
- **Across ranks** (each rank owns one index along the axis): ``q, k, v``
  are this rank's block [B, H, T/n, D] of the sequence, which starts at
  position rank x T/n, and the result is the block's output. A
  ``torch.autograd.Function`` runs the ring: the forward saves q, k, v, the
  output and the softmax's log-sum-exp m + log l per row; the backward
  walks the ring again with each K/V block's dK/dV accumulators
  travelling with the block (a send to rank + 1 and a receive from
  rank - 1 each step, one extra step bringing the accumulators home),
  while dQ stays on its rank.
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.parallel.mesh import SEQ_AXIS
from deeplearning4j_tpu_torch.parallel import transport


def _online_step(s, m, l, o, vb, eq):
    """One block of the online softmax over scores ``s`` (masked entries
    -inf), the reference's guards included; ``eq`` the einsum of p with
    the value block."""
    blk_max = s.amax(dim=-1)
    new_m = torch.maximum(m, blk_max)
    # guard fully-masked rows (blk_max = -inf)
    finite_m = torch.isfinite(new_m)
    new_m_safe = torch.where(finite_m, new_m, torch.zeros_like(new_m))
    p = torch.exp(s - new_m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    had = torch.isfinite(m)
    correction = torch.exp(torch.where(had, m - new_m_safe,
                                       torch.full_like(m, -math.inf)))
    correction = torch.where(had, correction, torch.zeros_like(correction))
    new_l = l * correction + p.sum(dim=-1)
    new_o = o * correction[..., None] + torch.einsum(eq, p, vb)
    return new_m, new_l, new_o


def _ring_one_process(q, k, v, mesh, axis, causal, scale):
    n = mesh.shape[axis]
    b, h, t, d = q.shape
    if t % n:
        raise ValueError(f"sequence length {t} does not split over "
                         f"{axis}={n}")
    tb = t // n
    dev = q.device
    qb = q.reshape(b, h, n, tb, d)
    kblocks = [k[:, :, i * tb:(i + 1) * tb].to(mesh.axis_device(axis, i))
               for i in range(n)]
    vblocks = [v[:, :, i * tb:(i + 1) * tb].to(mesh.axis_device(axis, i))
               for i in range(n)]
    m = torch.full((b, h, n, tb), -math.inf, dtype=q.dtype, device=dev)
    l = torch.zeros((b, h, n, tb), dtype=q.dtype, device=dev)
    o = torch.zeros((b, h, n, tb, d), dtype=q.dtype, device=dev)
    q_pos = torch.arange(t, device=dev).reshape(n, tb)
    blocks = torch.arange(n, device=dev)
    for step in range(n):
        # query block i holds K/V block (i - step) mod n
        kb = torch.stack([x.to(dev) for x in kblocks], dim=2)
        vb = torch.stack([x.to(dev) for x in vblocks], dim=2)
        s = torch.einsum("bhnqd,bhnkd->bhnqk", qb, kb) * scale
        if causal:
            src = torch.remainder(blocks - step, n)
            k_pos = src[:, None] * tb + torch.arange(tb, device=dev)
            mask = q_pos[:, :, None] >= k_pos[:, None, :]
            s = torch.where(mask, s, torch.full_like(s, -math.inf))
        m, l, o = _online_step(s, m, l, o, vb, "bhnqk,bhnkd->bhnqd")
        if step < n - 1:
            kblocks = transport.ring_shift(kblocks, mesh, axis)
            vblocks = transport.ring_shift(vblocks, mesh, axis)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, t, d)


def _block_scores(q, kb, scale, causal, q_pos, src, tl):
    s = torch.einsum("bhqd,bhkd->bhqk", q, kb) * scale
    if causal:
        k_pos = src * tl + torch.arange(tl, device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(mask, s, torch.full_like(s, -math.inf))
    return s


class _RingAcrossRanks(torch.autograd.Function):
    """The ring over ranks; the backward as in the module docstring."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, scale):
        n = transport.axis_size(mesh, axis)
        r = transport.axis_rank(mesh, axis)
        b, h, tl, d = q.shape
        q_pos = r * tl + torch.arange(tl, device=q.device)
        m = torch.full((b, h, tl), -math.inf, dtype=q.dtype, device=q.device)
        l = torch.zeros((b, h, tl), dtype=q.dtype, device=q.device)
        o = torch.zeros((b, h, tl, d), dtype=q.dtype, device=q.device)
        kb, vb = k, v
        for i in range(n):
            s = _block_scores(q, kb, scale, causal, q_pos, (r - i) % n, tl)
            m, l, o = _online_step(s, m, l, o, vb, "bhqk,bhkd->bhqd")
            if i < n - 1:
                kb, vb = transport.ring_shift((kb, vb), mesh, axis)
        out = o / torch.clamp(l, min=1e-30)[..., None]
        lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                          torch.full_like(l, -math.inf))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (mesh, axis, causal, scale, n, r)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis, causal, scale, n, r = ctx.ring
        tl = q.shape[-2]
        q_pos = r * tl + torch.arange(tl, device=q.device)
        dout = dout.contiguous()
        delta = (dout * out).sum(dim=-1)                  # [B, H, Tl]
        live = torch.isfinite(lse)
        lse_safe = torch.where(live, lse, torch.zeros_like(lse))
        dq = torch.zeros_like(q)
        kb, vb = k, v
        dk, dv = torch.zeros_like(k), torch.zeros_like(v)
        for i in range(n):
            s = _block_scores(q, kb, scale, causal, q_pos, (r - i) % n, tl)
            p = torch.exp(s - lse_safe[..., None])
            p = torch.where(torch.isfinite(s) & live[..., None], p,
                            torch.zeros_like(p))
            dv = dv + torch.einsum("bhqk,bhqd->bhkd", p, dout)
            dp = torch.einsum("bhqd,bhkd->bhqk", dout, vb)
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kb) * scale
            dk = dk + torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale
            if i < n - 1:
                kb, vb, dk, dv = transport.ring_shift((kb, vb, dk, dv), mesh,
                                                      axis)
            else:   # the accumulators go home with one more step
                dk, dv = transport.ring_shift((dk, dv), mesh, axis)
        return dq, dk, dv, None, None, None, None


def ring_attention(q, k, v, mesh, causal: bool = False,
                   axis: str = SEQ_AXIS, scaled: bool = True):
    """Sequence-parallel attention over [B, H, T, D] (this rank's block of
    T across ranks; see the module docstring)."""
    if axis not in mesh.axis_names:
        # degenerate mesh (seq axis size 1): plain attention
        return _dense_attention(q, k, v, causal, scaled)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scaled else 1.0
    if mesh.spans_ranks(axis):
        return _RingAcrossRanks.apply(q, k, v, mesh, axis, causal, scale)
    return _ring_one_process(q, k, v, mesh, axis, causal, scale)


def _dense_attention(q, k, v, causal, scaled):
    scale = 1.0 / math.sqrt(q.shape[-1]) if scaled else 1.0
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        t_q, t_k = s.shape[-2], s.shape[-1]
        mask = (torch.arange(t_q, device=s.device)[:, None]
                >= torch.arange(t_k, device=s.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, -math.inf))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)
