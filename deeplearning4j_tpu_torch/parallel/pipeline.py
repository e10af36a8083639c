"""GPipe-style pipelines over the ``pipe`` mesh axis, driven by one
process.

Counterpart of ``deeplearning4j_tpu/parallel/pipeline.py``, with its names.
The reference stacks S equal-structure stages on a leading axis sharded
over ``pipe`` and runs S + M - 1 ticks inside ``shard_map``, each device
applying its stage and ``ppermute``-ing the result to the next; the
backward pipeline is ``jax.grad`` reversing every ``ppermute``. Here one
process runs the same schedule:

- stage s's params sit on the mesh's pipe device s (``split_stages``);
- at tick t stage s works on microbatch t - s (the reference's order);
  ticks where that index falls outside [0, M) are bubble ticks and do no
  work;
- an activation moves to the next stage's device with ``.to()`` (the
  reference's ``ppermute``); a ``pipe`` axis across ranks (send/recv
  between ranks' stages) is ROADMAP queue 1 item 12b, and
  ``MeshConfig.build`` refuses it;
- the backward pipeline is autograd through those ops.

The output equals applying the stages in sequence, as the reference's
does. ``data`` places nothing: every stage sees the whole microbatch.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.parallel.mesh import PIPE_AXIS, Mesh, MeshConfig
from deeplearning4j_tpu_torch.tree_util import tree_leaves, tree_map


def n_stages_of(mesh: Mesh) -> int:
    return mesh.shape.get(PIPE_AXIS, 1)


def split_stages(stacked, mesh: Mesh, n_stages: int | None = None) -> list:
    """A tree whose leaves lead with the stage axis S -> a list of S stage
    trees, stage s's leaves copied to the mesh's pipe device s (all to the
    first device when the mesh has no pipe axis)."""
    lead = tree_leaves(stacked)[0].shape[0]
    n = n_stages or lead
    pipe = n_stages_of(mesh)
    return [tree_map(lambda a, s=s: a[s].detach().to(
        mesh.stage_device(s if pipe > 1 else 0)).clone(), stacked)
        for s in range(n)]


def join_stages(stages: list, device=None):
    """The inverse of ``split_stages``: one tree with leaves [S, ...] on
    ``device`` (the first stage's by default)."""
    device = device or tree_leaves(stages[0])[0].device
    return tree_map(lambda *a: torch.stack([v.detach().to(device)
                                            for v in a]), *stages)


def pipeline_apply(stage_fn, stage_params, x_mb, mesh: Mesh):
    """Run the S-stage pipeline over M microbatches.

    stage_fn:      (params_one_stage, x, microbatch_index) -> y (same
                   structure for every stage); microbatch_index is the
                   microbatch the stage is consuming (an int), which a
                   stage needing per-microbatch state (dropout draws)
                   keys on.
    stage_params:  a list of S stage trees (``split_stages``), stage s's on
                   the mesh's pipe device s. With no pipe axis the list's
                   stages all run on the mesh's first device, in the same
                   schedule.
    x_mb:          [M, mb, ...] microbatches.
    returns        [M, mb, ...] outputs of the last stage, on x_mb's
                   device.
    """
    m = x_mb.shape[0]
    pipe = n_stages_of(mesh)
    n = len(stage_params)
    if pipe > 1 and n != pipe:
        raise ValueError(f"{n} stages for pipe={pipe}")
    devs = [mesh.stage_device(s if pipe > 1 else 0) for s in range(n)]
    inbox = [None] * n         # the activation each stage consumes next
    outs = [None] * m
    for t in range(m + n - 1):
        nxt = [None] * n
        for s in range(n):
            mb = t - s
            if not 0 <= mb < m:
                continue          # a bubble tick: no work
            inp = x_mb[mb].to(devs[s]) if s == 0 else inbox[s]
            out = stage_fn(stage_params[s], inp, mb)
            if s == n - 1:
                outs[mb] = out
            else:
                nxt[s + 1] = out.to(devs[s + 1])
        inbox = nxt
    return torch.stack([o.to(x_mb.device) for o in outs])


class PipelineMlp:
    """A pipelined MLP: S stages of [hidden -> hidden] tanh blocks, trained
    by plain gradient descent over a dp x pp mesh. ``params`` ({"W": [S, h,
    h], "b": [S, h]}, e.g. the reference's) replaces the draw from
    ``seed``."""

    def __init__(self, mesh: Mesh, hidden: int, n_stages: int | None = None,
                 microbatches: int = 4, lr: float = 1e-2, seed: int = 0,
                 params=None):
        self.mesh = mesh
        self.hidden = hidden
        self.n_stages = n_stages or n_stages_of(mesh)
        self.microbatches = microbatches
        self.lr = lr
        if params is None:
            gen = torch.Generator().manual_seed(seed)
            params = {
                "W": torch.randn((self.n_stages, hidden, hidden),
                                 generator=gen) / np.sqrt(hidden),
                "b": torch.zeros((self.n_stages, hidden)),
            }
        params = tree_map(lambda a: torch.as_tensor(a, dtype=torch.float32),
                          params)
        self.params = split_stages(params, mesh, self.n_stages)

    @staticmethod
    def stage_fn(p, x, mb_idx):
        del mb_idx  # a stateless stage
        return torch.tanh(x @ p["W"] + p["b"])

    def stacked_params(self):
        """The params as the reference holds them: {"W": [S, h, h], "b":
        [S, h]} on the first stage's device."""
        return join_stages(self.params)

    def forward(self, params, x_mb):
        x_mb = torch.as_tensor(x_mb, dtype=torch.float32,
                               device=self.mesh.device)
        return pipeline_apply(self.stage_fn, params, x_mb, self.mesh)

    def loss(self, params, x_mb, y_mb):
        out = self.forward(params, x_mb)
        return ((out - y_mb) ** 2).mean()

    def train_step(self, x, y):
        """x/y: [batch, hidden]; batch is split into ``microbatches``."""
        m = self.microbatches
        dev = self.mesh.device
        x_mb = torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(
            m, -1, self.hidden)
        y_mb = torch.as_tensor(y, dtype=torch.float32, device=dev).reshape(
            m, -1, self.hidden)
        leaves = tree_leaves(self.params)
        for v in leaves:
            v.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss = self.loss(self.params, x_mb, y_mb)
                grads = torch.autograd.grad(loss, leaves)
        finally:
            for v in leaves:
                v.requires_grad_(False)
        with torch.no_grad():
            for v, g in zip(leaves, grads):
                v.sub_(self.lr * g)
        return loss.detach()


def pipeline_dryrun(devices):
    """The dp x pp dryrun over ``devices``: a 2-stage pipeline with data
    parallelism, two training steps, the loss must fall."""
    n = len(devices)
    pp = 2 if n % 2 == 0 else 1
    dp = n // pp
    mesh = MeshConfig(data=dp, pipe=pp, devices=devices).build()
    hidden, mb, per_mb = 16, 4, max(2 * dp, dp)
    model = PipelineMlp(mesh, hidden, microbatches=mb, lr=5e-2, seed=1)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(mb * per_mb, hidden)).astype(np.float32)
    y = np.tanh(rng.normal(size=(mb * per_mb, hidden))).astype(np.float32)
    l1 = float(model.train_step(x, y))
    l2 = float(model.train_step(x, y))
    print(f"pipeline_dryrun: mesh={dict(mesh.shape)} "
          f"loss {l1:.4f} -> {l2:.4f}")
    assert l2 < l1, "pipeline training did not reduce loss"
