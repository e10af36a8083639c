"""BERT encoder and masked-LM training, single device.

Counterpart of ``deeplearning4j_tpu/models/bert.py``, with its names:
pure functions over an explicit parameter tree (nested dicts of tensors,
``layers`` a list), post-LN encoder blocks, bfloat16 activations over
float32 parameters by default, and an LM head tied to the token
embedding. The attention runs the port's flash kernels
(``kernels/flash.py``) when ``attention_impl`` says so.

Where the reference differs by design:
- random draws come from ``torch.Generator``s (``init_params``, dropout),
  so parity with the JAX package is by transferred weights
  (``utils/convert.py`` ``bert_params_from_numpy``), never by seed;
- dropout keeps an element when a 16-bit draw is at most the reference's
  threshold, the same keep rate, not the same bits;
- ``attention_impl="auto"`` takes flash for T > 1024 with T % 128 == 0 on
  CUDA, where the reference says TPU; ``"dpa"`` is PyTorch's
  ``scaled_dot_product_attention``, as the reference's is
  ``jax.nn.dot_product_attention`` (a library call in both);
- ``n_experts > 0`` replaces every layer's dense FFN with a top-k MoE
  block (``parallel/moe.py``), its ``gate_w`` kept float32 whatever the
  compute dtype; the layers' aux losses, times ``moe_aux_weight``, join
  both MLM losses;
- ``BertTrainer`` takes a ``mesh`` (``parallel/mesh.py``) under the
  one-process semantics of ``parallel/__init__.py``: ``data``, ``model``,
  ``expert`` and ``pipe`` place nothing and change no number, and
  everything sits on the mesh's first device; a ``seq`` axis sends the
  attention to ``ring_attention`` (``parallel/ring_attention.py``) before
  any other route, as the reference's ``_attention`` does, so the flash
  kernels do not run under it. ``param_specs`` gives the reference's
  layout as tuples of axis names, and the trainer keeps it, resolved
  against the mesh, with the (data, seq) batch spec, in name only. A mesh
  across ranks raises (ROADMAP queue 1 item 12b).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.backend import resolve_device, torch_dtype
from deeplearning4j_tpu_torch.kernels import flash
from deeplearning4j_tpu_torch.nn.conf.layers import take_rows
from deeplearning4j_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh, spec_for)
from deeplearning4j_tpu_torch.parallel.moe import (
    moe_apply, moe_init, moe_param_specs)
from deeplearning4j_tpu_torch.parallel.ring_attention import ring_attention


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn: int = 3072
    max_len: int = 512
    type_vocab: int = 2
    dropout: float = 0.1
    compute_dtype: str = "bfloat16"   # activations; params stay f32
    layer_norm_eps: float = 1e-12
    n_experts: int = 0
    moe_k: int = 2
    moe_capacity: float = 1.5
    moe_aux_weight: float = 1e-2
    # "auto": dense up to T=1024, flash beyond for 128-divisible T on
    # CUDA; "dense", "flash" and "dpa" force one implementation
    attention_impl: str = "auto"

    @property
    def head_dim(self):
        return self.hidden // self.num_heads


def init_params(cfg: BertConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random parameters (normal * 0.02, zero biases, unit LayerNorm
    gains), drawn on the CPU from ``generator`` and moved to ``device``
    (CUDA unless the CPU is named; without CUDA that raises). A MoE
    config's layers hold ``moe`` (``moe_init``) instead of the dense FFN."""
    device = resolve_device(device)
    h, f, v = cfg.hidden, cfg.ffn, cfg.vocab_size

    def norm(*shape):
        return (torch.randn(shape, generator=generator) * 0.02).to(device)

    def zeros(n):
        return torch.zeros(n, device=device)

    def ln():
        return {"g": torch.ones(h, device=device), "b": zeros(h)}

    params = {
        "tok_emb": norm(v, h),
        "pos_emb": norm(cfg.max_len, h),
        "type_emb": norm(cfg.type_vocab, h),
        "emb_ln": ln(),
        "layers": [],
        "mlm_bias": zeros(v),
    }
    for _ in range(cfg.num_layers):
        layer = {
            "qkv_w": norm(h, 3 * h), "qkv_b": zeros(3 * h),
            "out_w": norm(h, h), "out_b": zeros(h),
            "ln1": ln(), "ln2": ln(),
        }
        if cfg.n_experts > 0:
            layer["moe"] = moe_init(generator, h, f, cfg.n_experts,
                                    device=device)
        else:
            layer.update({
                "ffn_in_w": norm(h, f), "ffn_in_b": zeros(f),
                "ffn_out_w": norm(f, h), "ffn_out_b": zeros(h),
            })
        params["layers"].append(layer)
    return params


def param_specs(cfg: BertConfig) -> dict:
    """The reference's Megatron-style layout of ``init_params``' tree, each
    spec a tuple of axis names or None (one process places nothing by
    it)."""
    layer = {
        "qkv_w": (None, MODEL_AXIS), "qkv_b": (MODEL_AXIS,),
        "out_w": (MODEL_AXIS, None), "out_b": (),
        "ln1": {"g": (), "b": ()},
        "ln2": {"g": (), "b": ()},
    }
    if cfg.n_experts > 0:
        layer["moe"] = moe_param_specs()
    else:
        layer.update({
            "ffn_in_w": (None, MODEL_AXIS), "ffn_in_b": (MODEL_AXIS,),
            "ffn_out_w": (MODEL_AXIS, None), "ffn_out_b": (),
        })
    return {
        "tok_emb": (None, MODEL_AXIS),
        "pos_emb": (),
        "type_emb": (),
        "emb_ln": {"g": (), "b": ()},
        "layers": [dict(layer) for _ in range(cfg.num_layers)],
        "mlm_bias": (),
    }


def param_leaves(params) -> list:
    """The parameter tensors in a fixed order (top level, then each
    layer), the order ``BertTrainer`` keeps its moments in."""
    out = []

    def walk(node):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key])
        elif isinstance(node, list):
            for item in node:
                walk(item)
        else:
            out.append(node)

    walk(params)
    return out


def _layer_norm(x, g, b, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)   # biased, as jnp.var
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _dropout(x, rate, generator):
    """Inverted dropout from 16-bit draws: keep where the draw is at most
    round((1 - rate) * 65536) - 1, as the reference's threshold."""
    thresh = round((1.0 - rate) * 65536) - 1
    bits = torch.randint(0, 65536, x.shape, generator=generator,
                         device=x.device, dtype=torch.int32)
    return torch.where(bits <= thresh, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _dense_attention(q, k, v):
    hd = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)


def attention_route(cfg: BertConfig, t: int, device_type: str) -> str:
    """The implementation ``_attention`` runs for sequences of length t on
    a device of this type: "flash", "dpa" or "dense"."""
    impl = cfg.attention_impl
    if impl == "auto":
        return ("flash" if t > 1024 and t % 128 == 0
                and device_type == "cuda" else "dense")
    return impl if impl in ("flash", "dpa") else "dense"


def _attention(q, k, v, cfg: BertConfig, mesh=None):
    """[B, H, T, D] attention: a mesh with a ``seq`` axis takes ring
    attention; otherwise ``attention_route``, flash taking the
    differentiable kernels when a gradient is wanted, the inference kernel
    otherwise."""
    if mesh is not None and SEQ_AXIS in mesh.axis_names:
        return ring_attention(q, k, v, mesh)
    impl = attention_route(cfg, q.shape[-2], q.device.type)
    if impl == "dpa":
        return F.scaled_dot_product_attention(q, k, v)
    if impl == "dense":
        return _dense_attention(q, k, v)
    scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (q, k, v)):
        return flash.flash_attention(q, k, v, scale)
    return flash.flash_attention_infer(q, k, v, scale)


def encoder_layer(lp, x, cfg: BertConfig, li=0, deterministic=True,
                  generator=None, mesh=None):
    """One post-LN encoder block. x [B, T, H] in the compute dtype ->
    ([B, T, H], aux loss: the MoE load-balancing loss, float32, or 0.0 for
    a dense FFN). Residual adds happen in the compute dtype, then the sum
    goes to float32 for the LayerNorm."""
    dtype = x.dtype
    b, t = x.shape[0], x.shape[1]
    nh, hd = cfg.num_heads, cfg.head_dim
    qkv = x @ lp["qkv_w"].to(dtype) + lp["qkv_b"].to(dtype)
    q, k, v = qkv.chunk(3, dim=-1)

    def to_heads(a):
        return a.reshape(b, t, nh, hd).permute(0, 2, 1, 3)

    att = _attention(to_heads(q), to_heads(k), to_heads(v), cfg, mesh)
    att = att.permute(0, 2, 1, 3).reshape(b, t, nh * hd)
    att = att @ lp["out_w"].to(dtype) + lp["out_b"].to(dtype)
    drop = not deterministic and cfg.dropout > 0 and generator is not None
    if drop:
        att = _dropout(att, cfg.dropout, generator)
    x = _layer_norm((x + att).float(), lp["ln1"]["g"], lp["ln1"]["b"],
                    cfg.layer_norm_eps).to(dtype)
    if "moe" in lp:
        # gate_w stays float32: the gating runs in float32, and rounding
        # the gate weights to bf16 would move routing decisions near ties
        mp = {k: (v if k == "gate_w" else v.to(dtype))
              for k, v in lp["moe"].items()}
        hdn, aux = moe_apply(mp, x.reshape(b * t, -1), k=cfg.moe_k,
                             capacity_factor=cfg.moe_capacity)
        hdn = hdn.reshape(b, t, -1)
    else:
        aux = torch.zeros((), device=x.device)
        hdn = F.gelu(x @ lp["ffn_in_w"].to(dtype)
                     + lp["ffn_in_b"].to(dtype),
                     approximate="tanh")   # jax.nn.gelu's default
        hdn = hdn @ lp["ffn_out_w"].to(dtype) + lp["ffn_out_b"].to(dtype)
    if drop:
        hdn = _dropout(hdn, cfg.dropout, generator)
    x = _layer_norm((x + hdn).float(), lp["ln2"]["g"], lp["ln2"]["b"],
                    cfg.layer_norm_eps).to(dtype)
    return x, aux


def embed(params, cfg: BertConfig, tokens, type_ids=None):
    """tokens [B, T] -> embedded, LayerNormed activations [B, T, H] in the
    compute dtype. Ids outside the vocabulary follow the reference's
    gather: a negative id wraps once, then ids are clamped."""
    t = tokens.shape[1]
    x = take_rows(params["tok_emb"], tokens)
    x = x + params["pos_emb"][None, :t, :]
    if type_ids is not None:
        x = x + take_rows(params["type_emb"], type_ids)
    x = _layer_norm(x, params["emb_ln"]["g"], params["emb_ln"]["b"],
                    cfg.layer_norm_eps)
    return x.to(torch_dtype(cfg.compute_dtype))


def forward_with_aux(params, cfg: BertConfig, tokens, type_ids=None,
                     deterministic=True, generator=None, mesh=None):
    """tokens [B, T] -> (hidden states [B, T, H], the layers' MoE aux
    losses summed, float32; 0.0 without MoE)."""
    x = embed(params, cfg, tokens, type_ids)
    aux_total = torch.zeros((), device=x.device)
    for li, lp in enumerate(params["layers"]):
        x, aux = encoder_layer(lp, x, cfg, li=li,
                               deterministic=deterministic,
                               generator=generator, mesh=mesh)
        aux_total = aux_total + aux
    return x, aux_total


def forward(params, cfg: BertConfig, tokens, type_ids=None,
            deterministic=True, generator=None, mesh=None):
    """tokens [B, T] -> hidden states [B, T, H] (compute dtype)."""
    return forward_with_aux(params, cfg, tokens, type_ids, deterministic,
                            generator, mesh)[0]


def mlm_loss(params, cfg: BertConfig, tokens, labels, deterministic=False,
             generator=None, mesh=None):
    """Masked-LM loss over every position; labels -100 where unmasked.
    The LM head ties tok_emb."""
    hs, aux = forward_with_aux(params, cfg, tokens,
                               deterministic=deterministic,
                               generator=generator, mesh=mesh)
    logits = hs.float() @ params["tok_emb"].T + params["mlm_bias"]
    logp = torch.log_softmax(logits, dim=-1)
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    tok_lp = torch.gather(logp, -1, safe[..., None].long())[..., 0]
    n = torch.clamp(valid.sum(), min=1)
    loss = -torch.where(valid, tok_lp, torch.zeros_like(tok_lp)).sum() / n
    return loss + cfg.moe_aux_weight * aux


def mlm_loss_masked(params, cfg: BertConfig, tokens, positions, mlm_labels,
                    weights, deterministic=False, generator=None, mesh=None):
    """Masked-LM loss over the gathered masked positions only.

    positions, mlm_labels [B, M] ints, weights [B, M] float32 (0 pads a
    row with fewer masked tokens). The reference multiplies bf16 x bf16
    with float32 accumulation; here both operands go to float32 (exact
    for bf16 values) and multiply with TF32 off."""
    hs, aux = forward_with_aux(params, cfg, tokens,
                               deterministic=deterministic,
                               generator=generator, mesh=mesh)
    loss = masked_lm_head_loss(params, hs, positions, mlm_labels, weights)
    return loss + cfg.moe_aux_weight * aux


def masked_lm_head_loss(params, hs, positions, mlm_labels, weights):
    """The masked-LM head and loss over hidden states hs [B, T, H]:
    gather the masked positions, logits against tok_emb (rounded to hs's
    dtype, then float32, TF32 off) plus mlm_bias, the weighted mean
    negative log-likelihood. ``BertPipelineTrainer`` shares it."""
    gathered = torch.take_along_dim(hs, positions[..., None].long(), dim=1)
    emb = params["tok_emb"].to(gathered.dtype).float()
    logits = gathered.float() @ emb.T + params["mlm_bias"]
    logp = torch.log_softmax(logits, dim=-1)
    tok_lp = torch.gather(logp, -1, mlm_labels[..., None].long())[..., 0]
    n = torch.clamp(weights.sum(), min=1.0)
    return -(tok_lp * weights).sum() / n


def mlm_max_preds(seq_len):
    """Stable masked-slot count (TF BERT's max_predictions_per_seq)."""
    return max(1, int(0.15 * seq_len) + 1)


def mlm_gather(labels, max_preds=None):
    """Host-side: labels [B,T] with -100 at unmasked positions ->
    (positions [B,M], mlm_labels [B,M], weights [B,M]) for
    mlm_loss_masked. M = max_preds or the max masked count in the batch."""
    labels = np.asarray(labels)
    b, t = labels.shape
    counts = (labels >= 0).sum(axis=1)
    m = int(max_preds or max(int(counts.max()), 1))
    positions = np.zeros((b, m), np.int32)
    mlm_labels = np.zeros((b, m), np.int32)
    weights = np.zeros((b, m), np.float32)
    for i in range(b):
        pos = np.nonzero(labels[i] >= 0)[0][:m]
        positions[i, :len(pos)] = pos
        mlm_labels[i, :len(pos)] = labels[i, pos]
        weights[i, :len(pos)] = 1.0
    return positions, mlm_labels, weights


def synthetic_mlm_batch(cfg: BertConfig, batch, seq_len, seed=0,
                        mask_frac=0.15):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, cfg.vocab_size, (batch, seq_len))
    labels = np.full((batch, seq_len), -100, np.int64)
    n_mask = max(1, int(mask_frac * seq_len))
    for i in range(batch):
        pos = rng.choice(seq_len, n_mask, replace=False)
        labels[i, pos] = tokens[i, pos]
        tokens[i, pos] = 1  # [MASK]
    return tokens.astype(np.int32), labels.astype(np.int64)


def adam_update(leaves, grads, opt, step, lr):
    """The reference's Adam over parallel lists of params (updated in
    place), gradients and moments ``opt`` {"m": [...], "v": [...]} (replaced
    by the new moments): eps outside sqrt(v-hat), bias correction with
    step + 1 in float32. ``BertTrainer`` and ``BertPipelineTrainer`` share
    it."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    tt = torch.tensor(step + 1, dtype=torch.float32)
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** tt
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** tt
    on = {}   # the corrections on each device the params sit on
    with torch.no_grad():
        for i, (p, g) in enumerate(zip(leaves, grads)):
            if p.device not in on:
                on[p.device] = (bc1.to(p.device), bc2.to(p.device))
            c1, c2 = on[p.device]
            m = b1 * opt["m"][i] + (1 - b1) * g
            v = b2 * opt["v"][i] + (1 - b2) * g * g
            opt["m"][i], opt["v"][i] = m, v
            p -= lr * (m / c1) / (torch.sqrt(v / c2) + eps)


def mesh_device(mesh, device):
    """The device a trainer given ``mesh`` and ``device`` runs on: the
    named device, else the mesh's first, else CUDA. A mesh whose positions
    belong to several ranks raises: the BERT trainers across ranks are
    ROADMAP queue 1 item 12b."""
    if mesh is not None:
        if mesh.multi_rank:
            raise NotImplementedError(
                "a BERT trainer over a mesh across ranks is not ported: "
                "it comes with ROADMAP queue 1 item 12b")
        if device is None:
            device = mesh.device
    return resolve_device(device)


def _resolve_specs(specs, mesh):
    """A spec tree with the axes the mesh lacks as None."""
    if isinstance(specs, dict):
        return {k: _resolve_specs(v, mesh) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_resolve_specs(v, mesh) for v in specs]
    return spec_for(mesh, *specs)


class BertTrainer:
    """Masked-LM training on one device: forward, autograd backward and
    the reference's Adam (``adam_update``), not ``torch.optim.Adam``, whose
    arithmetic order differs.

    ``params`` (a tree from ``init_params`` or ``bert_params_from_numpy``)
    replaces the random draw from ``seed``; dropout draws from a generator
    seeded with ``seed`` on the trainer's device. ``mesh`` (optional,
    keyword) lays the reference's shardings out in name only
    (``param_specs``, ``batch_spec``, ``pos_spec``): ``data``, ``model``,
    ``expert`` and ``pipe`` change no number, a ``seq`` axis runs ring
    attention, and the trainer runs on the mesh's first device unless
    ``device`` names another."""

    def __init__(self, cfg: BertConfig, lr=1e-4, seed=0, device=None,
                 params=None, *, mesh: Mesh | None = None):
        self.cfg = cfg
        self.lr = lr
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        if mesh is not None:
            self.param_specs = _resolve_specs(param_specs(cfg), mesh)
            self.batch_spec = spec_for(mesh, DATA_AXIS, SEQ_AXIS)
            # masked-position tensors [B, M]: data only (M is not T)
            self.pos_spec = spec_for(mesh, DATA_AXIS)
        if params is None:
            params = init_params(cfg, torch.Generator().manual_seed(seed),
                                 self.device)
        self.params = params
        self._leaves = param_leaves(params)
        for p in self._leaves:
            if p.device != self.device or p.dtype != torch.float32:
                raise ValueError(f"params must be float32 on {self.device}")
        self.opt = {"m": [torch.zeros_like(p) for p in self._leaves],
                    "v": [torch.zeros_like(p) for p in self._leaves]}
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._step = 0

    def _tensor(self, a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _step_math(self, tokens, positions, mlm_labels, weights):
        for p in self._leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss = mlm_loss_masked(
                    self.params, self.cfg, tokens, positions, mlm_labels,
                    weights, deterministic=False, generator=self._gen,
                    mesh=self.mesh)
                grads = torch.autograd.grad(loss, self._leaves,
                                            materialize_grads=True)
        finally:
            for p in self._leaves:
                p.requires_grad_(False)
        adam_update(self._leaves, grads, self.opt, self._step, self.lr)
        return loss.detach()

    def train_step(self, tokens, labels):
        """tokens [B, T] ints; labels [B, T] with -100 at unmasked
        positions. The masked-position gather runs on the host, so the
        step scores only the mlm_max_preds(T) slots. Returns the loss (a
        0-d float32 tensor on the device)."""
        tokens = np.asarray(tokens)
        positions, mlm_labels, weights = mlm_gather(
            labels, max_preds=mlm_max_preds(tokens.shape[1]))
        loss = self._step_math(self._tensor(tokens, torch.long),
                               self._tensor(positions, torch.long),
                               self._tensor(mlm_labels, torch.long),
                               self._tensor(weights, torch.float32))
        self._step += 1
        return loss

    def train_steps(self, tokens_k, labels_k, repeats: int = 1):
        """K = tokens_k.shape[0] steps, R*K with repeats=R, over the
        stacked batches [K, B, T]. Returns the [K] losses of the last
        pass. (The reference runs them as one scanned launch; eager
        PyTorch runs them as a loop.)"""
        losses = None
        for _ in range(repeats):
            losses = torch.stack([self.train_step(t, l)
                                  for t, l in zip(tokens_k, labels_k)])
        return losses
