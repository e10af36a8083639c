"""Mixture-of-Experts: top-k gating, dense dispatch and combine, and the
expert FFNs as batched products (the GShard/Switch formulation).

Counterpart of ``deeplearning4j_tpu/parallel/moe.py``, with its names and
every step of its arithmetic (``moe_apply``):

- gating in float32 whatever the activation dtype (``gate_w`` is read as
  float32; callers keep it float32, ``models/bert.py``), or in float64
  for a float64 ``gate_w`` (the reference rounds that to float32: its
  float64 trees are float32 unless JAX runs with x64);
- the load-balancing aux loss E * sum_e(frac_e * mean prob_e), ``frac``
  from the top-1 ``argmax`` (the first maximum, as ``jnp.argmax``), so no
  gradient flows through it;
- the top-k probabilities renormalised by max(sum, 1e-9);
- each (token, choice)'s slot in its expert from an exclusive cumsum over
  the flattened [N*k, E] one-hot, token first, then choice, kept where the
  slot is below the capacity C = ceil(k*N/E * capacity_factor);
- dense ``disp`` and ``comb`` [N, E, C] in the activation dtype, the
  expert FFN with GELU's tanh form (``jax.nn.gelu``'s default).

Ties: the top k come from a stable descending sort, so among equal
probabilities the lower expert index ranks first, as ``jax.lax.top_k``
orders them (``torch.topk`` promises no order among ties).

The expert axis is a layout in the reference (``moe_param_specs``), and
places nothing in one process: the einsums are PyTorch's (cuBLAS on the
card), as the reference leaves them to XLA.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.backend import resolve_device
from deeplearning4j_tpu_torch.parallel.mesh import EXPERT_AXIS, Mesh


def moe_init(generator: torch.Generator, hidden: int, ffn: int,
             n_experts: int, dtype=torch.float32, device=None) -> dict:
    """Random MoE params (gate and w1 normal / sqrt(hidden), w2 normal /
    sqrt(ffn), zero biases), drawn on the CPU from ``generator`` and moved
    to ``device`` (CUDA unless the CPU is named)."""
    device = resolve_device(device)
    s1 = 1.0 / math.sqrt(hidden)
    s2 = 1.0 / math.sqrt(ffn)

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator) * scale).to(
            device=device, dtype=dtype)

    return {
        "gate_w": normal((hidden, n_experts), s1),
        "w1": normal((n_experts, hidden, ffn), s1),
        "b1": torch.zeros((n_experts, ffn), dtype=dtype, device=device),
        "w2": normal((n_experts, ffn, hidden), s2),
        "b2": torch.zeros((n_experts, hidden), dtype=dtype, device=device),
    }


def moe_param_specs() -> dict:
    """The reference's layout: experts over the expert axis (specs as
    tuples of axis names)."""
    return {
        "gate_w": (),
        "w1": (EXPERT_AXIS,), "b1": (EXPERT_AXIS,),
        "w2": (EXPERT_AXIS,), "b2": (EXPERT_AXIS,),
    }


@dataclass
class Routing:
    """What ``moe_route`` decides for N tokens: ``probs`` [N, E] in the
    gating dtype, ``aux`` the load-balancing loss, ``topk_p`` [N, k]
    (renormalised), ``topk_i`` [N, k] expert ids, ``pos`` [N, k] slots,
    ``keep`` [N, k] (slot below ``capacity``)."""

    probs: torch.Tensor
    aux: torch.Tensor
    topk_p: torch.Tensor
    topk_i: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    capacity: int

    @property
    def dropped(self) -> torch.Tensor:
        """The number of (token, choice) pairs past their expert's
        capacity (a 0-d tensor)."""
        return (~self.keep).sum()


def moe_route(gate_w, x, k: int = 2, capacity_factor: float = 1.5
              ) -> Routing:
    """The gating half of ``moe_apply``, in float32, or float64 for a
    float64 ``gate_w``."""
    n = x.shape[0]
    e = gate_w.shape[1]
    c = int(math.ceil(k * n / e * capacity_factor))
    dt = torch.promote_types(gate_w.dtype, torch.float32)
    logits = x.to(dt) @ gate_w.to(dt)
    probs = torch.softmax(logits, dim=-1)
    top1 = probs.argmax(dim=-1)
    frac = F.one_hot(top1, e).to(probs.dtype).mean(dim=0)
    aux = e * (frac * probs.mean(dim=0)).sum()
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_p, topk_i = srt[:, :k], idx[:, :k]
    topk_p = topk_p / torch.clamp(topk_p.sum(dim=-1, keepdim=True),
                                  min=1e-9)
    oh = F.one_hot(topk_i, e)                          # [N, k, E] int64
    flat = oh.reshape(n * k, e)
    pos_flat = torch.cumsum(flat, dim=0) - flat        # exclusive
    pos = (pos_flat.reshape(n, k, e) * oh).sum(dim=-1)  # [N, k]
    return Routing(probs, aux, topk_p, topk_i, pos, pos < c, c)


def moe_dispatch(route: Routing, n_experts: int, dtype):
    """(disp, comb) [N, E, C] in ``dtype`` from a routing."""
    oh = F.one_hot(route.topk_i, n_experts).to(route.topk_p.dtype)
    slot = torch.where(route.keep, route.pos, torch.zeros_like(route.pos))
    pos_oh = F.one_hot(slot, route.capacity).to(route.topk_p.dtype) \
        * route.keep[..., None]
    disp = torch.einsum("nke,nkc->nec", oh, pos_oh).to(dtype)
    comb = torch.einsum("nke,nkc->nec", route.topk_p[..., None] * oh,
                        pos_oh).to(dtype)
    return disp, comb


def moe_experts(params, disp, comb, x):
    """Tokens to their experts, through each expert's FFN and back:
    [N, H] -> [N, H_out]."""
    expert_in = torch.einsum("nec,nh->ech", disp, x)
    hmid = F.gelu(torch.einsum("ech,ehf->ecf", expert_in, params["w1"])
                  + params["b1"][:, None, :], approximate="tanh")
    expert_out = (torch.einsum("ecf,efh->ech", hmid, params["w2"])
                  + params["b2"][:, None, :])
    return torch.einsum("nec,ech->nh", comb, expert_out)


def moe_apply(params, x, k: int = 2, capacity_factor: float = 1.5):
    """x: [N, H] tokens -> ([N, H_out], aux_loss).

    Top-k gating with per-expert capacity C = ceil(k*N/E * cf); tokens past
    it are dropped (they contribute nothing); aux_loss is the
    load-balancing loss (Switch Transformer eq. 4)."""
    route = moe_route(params["gate_w"], x, k, capacity_factor)
    disp, comb = moe_dispatch(route, params["gate_w"].shape[1], x.dtype)
    return moe_experts(params, disp, comb, x), route.aux


class MoELayerTrainer:
    """Minimal expert-parallel trainer: one MoE FFN block regressing
    targets by plain gradient descent, on the mesh's first device (the
    reference shards the experts over ``expert`` and the batch over
    ``data``; the numbers are the same). ``params`` (a tree from
    ``moe_init`` or carried over from the reference) replaces the draw
    from ``seed``."""

    def __init__(self, mesh: Mesh, hidden=16, ffn=32, n_experts=4, k=2,
                 lr=1e-2, aux_weight=1e-2, seed=0, params=None):
        self.mesh = mesh
        self.k = k
        self.lr = lr
        self.aux_weight = aux_weight
        self.device = mesh.device
        if params is None:
            params = moe_init(torch.Generator().manual_seed(seed), hidden,
                              ffn, n_experts, device=self.device)
        self.params = {kk: v.detach().to(self.device, torch.float32).clone()
                       for kk, v in params.items()}

    def loss(self, params, x, y):
        out, aux = moe_apply(params, x, k=self.k)
        return ((out - y) ** 2).mean() + self.aux_weight * aux

    def train_step(self, x, y):
        x, y = (torch.as_tensor(a, dtype=torch.float32, device=self.device)
                for a in (x, y))
        leaves = {kk: v.requires_grad_() for kk, v in self.params.items()}
        try:
            with torch.enable_grad():
                loss = self.loss(leaves, x, y)
                grads = torch.autograd.grad(loss, list(leaves.values()))
        finally:
            for v in leaves.values():
                v.requires_grad_(False)
        with torch.no_grad():
            for v, g in zip(leaves.values(), grads):
                v.sub_(self.lr * g)
        return loss.detach()
