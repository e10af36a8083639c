"""Pipeline-parallel training of the BERT encoder.

Counterpart of ``deeplearning4j_tpu/models/bert_pipeline.py``, with its
names: the same ``BertConfig``/``init_params`` model as ``models/bert.py``
trained over a dp x pp mesh.

- The L encoder layers are split into S = mesh.shape['pipe'] stages of L/S
  layers; the per-layer trees are stacked to leaves [S, L/S, ...]
  (``stack_layer_params``) and each stage's slice sits on its pipe device.
- The embeddings and the tied MLM head sit on the mesh's first device and
  run on the whole batch; the head is ``models/bert.py``
  ``masked_lm_head_loss``, so this trainer and ``BertTrainer`` compute
  the same loss.
- The schedule is ``parallel/pipeline.py`` ``pipeline_apply`` (one process,
  the reference's order); the backward pipeline is autograd through it;
  each stage runs its L/S layers in order.
- Adam is ``models/bert.py`` ``adam_update``, the reference's arithmetic.

Dropout: the stage running global layer g on microbatch i at step n draws
from a generator seeded by (seed, n, i, g), the reference's keying
(fold_in(fold_in(step rng, microbatch), layer)), so the draws do not
depend on the schedule; the bits differ from the reference's, the keep
rate is the same. With dropout 0 the loss curve follows ``BertTrainer``'s
step for step.

MoE configs are refused with the reference's message: the stage loop
would drop the aux loss.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.bert import (
    BertConfig, adam_update, embed, encoder_layer, init_params,
    masked_lm_head_loss, mesh_device, mlm_gather, mlm_max_preds)
from deeplearning4j_tpu_torch.parallel.mesh import PIPE_AXIS, Mesh
from deeplearning4j_tpu_torch.parallel.pipeline import (
    join_stages, pipeline_apply, split_stages)
from deeplearning4j_tpu_torch.parallel.pipeline_trainer import (
    stack_run_params, unstack_run_params)
from deeplearning4j_tpu_torch.tree_util import tree_leaves, tree_map


def stack_layer_params(cfg: BertConfig, params: dict, n_stages: int):
    """Split init_params' tree into (emb_head, stacked): emb_head is
    everything but the layers; stacked the per-layer trees stacked to
    leaves [S, L/S, ...] by ``stack_run_params``."""
    if cfg.num_layers % n_stages:
        raise ValueError(
            f"num_layers={cfg.num_layers} not divisible by "
            f"pipe={n_stages}")
    stacked = stack_run_params(params["layers"], n_stages)
    emb_head = {k: v for k, v in params.items() if k != "layers"}
    return emb_head, stacked


def unstack_layer_params(stacked) -> list:
    """Inverse of stack_layer_params: [S, L/S, ...] leaves -> list of L
    per-layer param dicts (checkpoint interchange with BertTrainer)."""
    return unstack_run_params(stacked)


def _stage_generator(seed, step, mb, layer, device):
    """The dropout generator of global layer ``layer`` on microbatch
    ``mb`` at step ``step``."""
    seq = np.random.SeedSequence([int(seed), int(step), int(mb), int(layer)])
    return torch.Generator(device=device).manual_seed(
        int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1)))


class BertPipelineTrainer:
    """GPipe training of BERT over a dp x pp mesh: a step is the forward
    pipeline, autograd's backward pipeline and Adam. ``params`` (a tree
    from ``init_params`` or ``bert_params_from_numpy``) replaces the draw
    from ``seed``."""

    def __init__(self, cfg: BertConfig, mesh: Mesh, microbatches: int = 4,
                 lr: float = 1e-4, seed: int = 0, params=None):
        if cfg.n_experts > 0:
            raise ValueError(
                "BertPipelineTrainer does not support MoE configs: the "
                "pipeline stage loop discards the load-balancing aux "
                "loss, so the objective would silently differ from "
                "BertTrainer's — train MoE variants on a dp x ep mesh "
                "via BertTrainer instead")
        self.cfg = cfg
        self.mesh = mesh
        self.microbatches = microbatches
        self.lr = lr
        self.seed = seed
        self.n_stages = mesh.shape.get(PIPE_AXIS, 1)
        self.device = mesh_device(mesh, None)
        if params is None:
            params = init_params(cfg, torch.Generator().manual_seed(seed),
                                 self.device)
        emb, stacked = stack_layer_params(cfg, params, self.n_stages)
        self.params = {
            "emb": tree_map(lambda v: v.detach().to(self.device).clone(),
                            emb),
            "stages": split_stages(stacked, mesh, self.n_stages),
        }
        self._leaves = tree_leaves(self.params)
        self.opt = {"m": [torch.zeros_like(p) for p in self._leaves],
                    "v": [torch.zeros_like(p) for p in self._leaves]}
        self._step = 0

    # -- forward through the pipeline ---------------------------------------
    def _stage_fn(self, stage_params, x, mb_idx, stage, step):
        cfg = self.cfg
        per = cfg.num_layers // self.n_stages
        drop = cfg.dropout > 0
        for li in range(per):
            g = stage * per + li
            gen = (_stage_generator(self.seed, step, mb_idx, g, x.device)
                   if drop else None)
            x, _aux = encoder_layer(
                tree_map(lambda a, li=li: a[li], stage_params), x, cfg,
                li=g, deterministic=not drop, generator=gen)
        return x

    def _loss(self, params, tokens_mb, positions, mlm_labels, weights,
              step):
        cfg, mesh = self.cfg, self.mesh
        m, mb, t = tokens_mb.shape
        x = embed(params["emb"], cfg, tokens_mb.reshape(m * mb, t))
        x = x.reshape(m, mb, t, -1)
        stage_of = {id(p): s for s, p in enumerate(params["stages"])}
        y = pipeline_apply(
            lambda p, h, i: self._stage_fn(p, h, i, stage_of[id(p)], step),
            params["stages"], x, mesh)
        hs = y.reshape(m * mb, t, -1)
        return masked_lm_head_loss(
            params["emb"], hs, positions.reshape(m * mb, -1),
            mlm_labels.reshape(m * mb, -1), weights.reshape(m * mb, -1))

    def stacked_params(self) -> dict:
        """The params in ``init_params``' layout (copies on the first
        device): the embeddings and head, and ``layers``."""
        layers = unstack_layer_params(join_stages(self.params["stages"],
                                                  self.device))
        return {**self.params["emb"], "layers": layers}

    def train_step(self, tokens, labels):
        """tokens [B, T] ints, labels [B, T] (-100 = unmasked). B is split
        into ``microbatches`` GPipe microbatches; returns the loss (a 0-d
        float32 tensor on the device)."""
        tokens = np.asarray(tokens)
        b, t = tokens.shape
        m = self.microbatches
        if b % m:
            raise ValueError(f"batch {b} not divisible by "
                             f"microbatches {m}")
        positions, mlm_labels, weights = mlm_gather(
            labels, max_preds=mlm_max_preds(t))
        mb = b // m

        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device).reshape(m, mb, -1)

        for p in self._leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss = self._loss(self.params, dev(tokens, torch.long),
                                  dev(positions, torch.long),
                                  dev(mlm_labels, torch.long),
                                  dev(weights, torch.float32), self._step)
                grads = torch.autograd.grad(loss, self._leaves,
                                            materialize_grads=True)
        finally:
            for p in self._leaves:
                p.requires_grad_(False)
        adam_update(self._leaves, grads, self.opt, self._step, self.lr)
        self._step += 1
        return loss.detach()
