"""Pipeline-parallel training of a MultiLayerNetwork.

Counterpart of ``deeplearning4j_tpu/parallel/pipeline_trainer.py``, with its
names and its rules:

- the trainer finds the longest contiguous run of layers with identical
  structure and configuration (same class, param shapes and dtypes,
  primitive config, updater, no preprocessor inside the run; never the
  output layer), e.g. the stacked LSTM trunk of a char-RNN;
- the run is split into S = mesh.shape['pipe'] stages; the per-layer
  param trees are stacked to leaves [S, run/S, ...] (``stack_run_params``)
  and each stage's slice sits on its pipe device (``split_stages``), with
  the run's updater state stacked alike;
- the layers before the run and after it (the output layer's loss
  included) run on the flat batch on the mesh's first device;
- the schedule is ``parallel/pipeline.py`` ``pipeline_apply``; the
  backward pipeline is autograd through it.

Heterogeneous runs, a preprocessor inside the run, layers carrying state
(BatchNormalization's running statistics, MoELayer's aux loss), dropout
and ``gradientNormalization`` are refused with the reference's errors:
the trainer runs every layer with an empty state and no generator. With
dropout off, the losses follow ``MultiLayerNetwork.fit`` step for step.

A step is eager PyTorch: the forward through the pipeline, under a
``*_mixed`` policy with the float32 masters cast to the compute dtype
inside what autograd differentiates; ``torch.autograd.grad``; each
layer's updater (the run's once, over its stacked leaves); ``p -= u`` in
place. The health rows (``health_labels``) and the health plan of a
step are ``telemetry.health``, which comes with ROADMAP queue 1 item 13.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.samediff import _host_array
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    _apply_preprocessor)
from deeplearning4j_tpu_torch.nn.multilayer import (
    _as_input, _io_dtype, _to_compute)
from deeplearning4j_tpu_torch.parallel.mesh import PIPE_AXIS, Mesh
from deeplearning4j_tpu_torch.parallel.pipeline import (
    join_stages, pipeline_apply, split_stages)
from deeplearning4j_tpu_torch.precision.policy import cast_floating
from deeplearning4j_tpu_torch.tree_util import (
    tree_fill, tree_items, tree_leaves, tree_map)


def _cfg_fingerprint(obj):
    """Primitive-valued config attrs of a layer/updater: the part of its
    behavior not visible in param shapes (activation, l1/l2, dropout,
    learning rate, ...)."""
    return tuple(sorted(
        (k, v) for k, v in vars(obj).items()
        if isinstance(v, (int, float, str, bool, type(None)))))


def _layer_signature(net, i):
    """Structure and config signature deciding stage-stackability: class,
    param paths, leaf shapes and dtypes, primitive config (activation
    etc.), updater config, presence of a preprocessor. Config counts
    because every run layer executes through layer lo's ``apply``."""
    lr = net.layers[i]
    items = list(tree_items(net._params[i]))
    upd = net._layer_updater(i)
    return (
        type(lr).__name__,
        tuple(path for path, _ in items),
        tuple((tuple(v.shape), str(v.dtype)) for _, v in items),
        _cfg_fingerprint(lr),
        (type(upd).__name__, _cfg_fingerprint(upd)),
        net.conf.preprocessors[i] is not None,
    )


def find_stackable_run(net, n_stages):
    """Longest contiguous run of identically-structured layers (excluding
    the output layer) whose length is divisible by n_stages and >= it.
    Returns (lo, hi). Raises with the full signature table if none."""
    n = len(net.layers) - 1  # never include the output layer
    sigs = [_layer_signature(net, i) for i in range(n)]
    best = None
    i = 0
    while i < n:
        j = i + 1
        while j < n and sigs[j] == sigs[i] \
                and not net.conf.preprocessors[j]:
            j += 1
        run = (j - i) - (j - i) % n_stages
        if run >= max(n_stages, 2) and (best is None
                                        or run > best[1] - best[0]):
            best = (i, i + run)
        i = j
    if best is None:
        table = "\n".join(f"  layer {i}: {s[0]} params={s[2]}"
                          for i, s in enumerate(sigs))
        raise ValueError(
            f"no contiguous run of >= max({n_stages}, 2) identically-"
            f"structured layers divisible by pipe={n_stages} — this net "
            f"cannot be stage-stacked. Layer structure:\n{table}")
    return best


def stack_run_params(param_list, n_stages):
    """[R layers of identical trees] -> one tree with leaves
    [S, R/S, ...] (new tensors)."""
    per = len(param_list) // n_stages
    return tree_map(lambda *leaves: torch.stack(
        [v.detach() for v in leaves]).reshape(
            (n_stages, per) + tuple(leaves[0].shape)),
        param_list[0], *param_list[1:])


def unstack_run_params(stacked):
    """Inverse of stack_run_params -> list of R per-layer trees (views of
    ``stacked``)."""
    lead = tree_leaves(stacked)[0]
    s, per = lead.shape[0], lead.shape[1]
    return [tree_map(lambda a, si=si, li=li: a[si, li], stacked)
            for si in range(s) for li in range(per)]


def _layer_reg(lr, leaves):
    """A layer's L2 and L1 terms over ``leaves``, with the JAX package's
    subgradient of |w| at 0 (1), as ``MultiLayerNetwork._loss_from``."""
    reg = 0.0
    if lr.l2:
        reg = reg + lr.l2 * 0.5 * sum((w * w).sum() for w in leaves)
    if lr.l1:
        reg = reg + lr.l1 * sum(torch.where(w >= 0, w, -w).sum()
                                for w in leaves)
    return reg


class PipelineParallelTrainer:
    """GPipe training of a MultiLayerNetwork over a dp x pp mesh.

    net must be init()'d; its params are copied into the trainer (the run
    stage-stacked, each stage on its pipe device, the other layers on the
    mesh's first device) with a fresh updater state; call sync_to_net() to
    write the trained values back for the net's own output, evaluation
    and serialization."""

    def __init__(self, net, mesh: Mesh, microbatches: int = 4,
                 run: tuple | None = None):
        net._check_init()
        self.net = net
        self.mesh = mesh
        self.microbatches = microbatches
        self.n_stages = mesh.shape.get(PIPE_AXIS, 1)
        self.lo, self.hi = run or find_stackable_run(net, self.n_stages)
        self._validate()
        dev = mesh.device
        stacked = stack_run_params(net._params[self.lo:self.hi],
                                   self.n_stages)
        outer = [tree_map(lambda v: v.detach().to(dev).clone(),
                          net._params[i])
                 for i in range(len(net.layers))
                 if not (self.lo <= i < self.hi)]
        self.params = {"outer": outer,
                       "run": split_stages(stacked, mesh, self.n_stages)}
        upds = self._updaters()
        self.opt = {
            "outer": [u.init_state(p) if p else ()
                      for u, p in zip(upds["outer"], outer)],
            # the run's updater state is stage-stacked like its params
            "run": [upds["run"].init_state(p) for p in self.params["run"]],
        }
        self._it = 0
        self.lossCurve: list = []

    # -- validation ---------------------------------------------------------
    def _validate(self):
        net, lo, hi = self.net, self.lo, self.hi
        if (hi - lo) % self.n_stages:
            raise ValueError(
                f"run length {hi - lo} not divisible by "
                f"pipe={self.n_stages}")
        # an explicit run= tuple must pass the same homogeneity bar the
        # auto-detection enforces
        sig0 = _layer_signature(net, lo)
        for i in range(lo, hi):
            if _layer_signature(net, i) != sig0:
                raise ValueError(
                    f"run layer {i} differs in structure/config from "
                    f"layer {lo}; stage stacking requires identical "
                    "layers (class, shapes, activation, updater, "
                    "regularization)")
            if net.conf.preprocessors[i] is not None:
                raise ValueError(
                    f"layer {i} has an input preprocessor inside the "
                    "pipelined run; preprocessors are only supported "
                    "before/after the run")
        for i, lr in enumerate(net.layers):
            # every layer runs with an empty state and no generator here
            if net._states[i]:
                raise ValueError(
                    f"layer {i} ({type(lr).__name__}) carries state "
                    "(running stats / aux-loss / streaming); "
                    "PipelineParallelTrainer drops layer state — train "
                    "this net data-parallel instead")
            if getattr(lr, "dropOut", None):
                raise ValueError(
                    f"layer {i} ({type(lr).__name__}) configures "
                    "dropout; this trainer runs layers without an RNG "
                    "(parity contract is dropout-off) — remove dropOut "
                    "or train data-parallel")
            if getattr(lr, "gradientNormalization", None):
                raise ValueError(
                    f"layer {i} sets gradientNormalization: per-layer "
                    "norms differ across a stacked stage group — "
                    "remove it or train data-parallel")

    def _updaters(self):
        net = self.net
        outer = [net._layer_updater(i) for i in range(len(net.layers))
                 if not (self.lo <= i < self.hi)]
        return {"outer": outer, "run": net._layer_updater(self.lo)}

    # -- forward ------------------------------------------------------------
    def _stage_fn(self, stage_params, x, mb_idx):
        del mb_idx  # deterministic stages (dropout off)
        proto = self.net.layers[self.lo]
        per = tree_leaves(stage_params)[0].shape[0]
        for li in range(per):
            x, _ = proto.apply(tree_map(lambda a, li=li: a[li],
                                        stage_params), {}, x, True, None)
        return x

    def _loss(self, params, f, l, lmask):
        net, lo, hi = self.net, self.lo, self.hi
        pol = net._policy
        if pol.is_mixed:
            params = cast_floating(params, pol.compute_torch)
        outer = iter(params["outer"])
        outer_params = [None if lo <= i < hi else next(outer)
                        for i in range(len(net.layers))]
        m = self.microbatches
        x = _to_compute(f, pol.compute_torch)
        # head (flat batch)
        for i in range(lo):
            x = _apply_preprocessor(net.conf.preprocessors[i], x)
            x, _ = net.layers[i].apply(outer_params[i], {}, x, True, None)
        # pipelined trunk ([M, mb, ...])
        x_mb = x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
        y_mb = pipeline_apply(self._stage_fn, params["run"], x_mb,
                              self.mesh)
        h = y_mb.reshape((-1,) + tuple(y_mb.shape[2:]))
        # tail + loss (flat batch)
        out_idx = len(net.layers) - 1
        for i in range(hi, out_idx):
            h = _apply_preprocessor(net.conf.preprocessors[i], h)
            h, _ = net.layers[i].apply(outer_params[i], {}, h, True, None)
        h = _apply_preprocessor(net.conf.preprocessors[out_idx], h)
        loss = net.layers[out_idx].compute_loss(outer_params[out_idx], h, l,
                                                lmask)
        reg = 0.0
        for i, lr in enumerate(net.layers):
            if lo <= i < hi or not outer_params[i]:
                continue  # the run is handled stacked below
            reg = reg + _layer_reg(lr, tree_leaves(outer_params[i]))
        reg = reg + _layer_reg(net.layers[lo], tree_leaves(params["run"]))
        return loss + reg

    # -- one step -----------------------------------------------------------
    def health_labels(self):
        """The health rows of the reference (outer layers, the run as one
        row, the loss row) belong to ``telemetry.health``."""
        raise NotImplementedError(
            "PipelineParallelTrainer.health_labels and the step's health "
            "plan are telemetry.health, not ported yet: ROADMAP queue 1 "
            "item 13")

    def train_step(self, features, labels, labels_mask=None) -> float:
        f = _host_array(features)
        if f.shape[0] % self.microbatches:
            raise ValueError(
                f"batch {f.shape[0]} not divisible by microbatches="
                f"{self.microbatches}")
        net, dev = self.net, self.mesh.device
        io = _io_dtype(net.conf)
        fx = _as_input(f, dev, io)
        lx = _as_input(_host_array(labels), dev, io)
        lm = None if labels_mask is None else torch.as_tensor(
            _host_array(labels_mask, np.float32), device=dev)
        it = self._it
        flat = tree_leaves(self.params)
        for v in flat:
            v.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss = self._loss(self.params, fx, lx, lm)
                grads = torch.autograd.grad(loss, flat, allow_unused=True)
        finally:
            for v in flat:
                v.requires_grad_(False)
        grads = tree_fill(self.params, iter(
            torch.zeros_like(v) if g is None else g
            for v, g in zip(flat, grads)))
        upds = self._updaters()
        groups = ([(u, "outer", k) for k, u in enumerate(upds["outer"])]
                  + [(upds["run"], "run", s)
                     for s in range(len(self.params["run"]))])
        with torch.no_grad():
            for u, part, k in groups:
                p = self.params[part][k]
                if not p:
                    continue
                upd, self.opt[part][k] = u.apply_mixed(
                    grads[part][k], self.opt[part][k], p, it)
                for pv, uv in zip(tree_leaves(p), tree_leaves(upd)):
                    pv.sub_(uv)
        self._it += 1
        val = float(loss.detach())
        self.lossCurve.append(val)
        return val

    def fit(self, data, epochs: int = 1):
        """data: iterable of (features, labels) or DataSet-likes."""
        for _ in range(epochs):
            for d in data:
                if hasattr(d, "getFeatures"):
                    lm = None
                    if hasattr(d, "getLabelsMaskArray"):
                        lm = d.getLabelsMaskArray()
                    self.train_step(d.getFeatures(), d.getLabels(),
                                    labels_mask=lm)
                else:
                    self.train_step(*d)
            if hasattr(data, "reset"):
                data.reset()
        return self

    def sync_to_net(self):
        """Write the trained params back into the wrapped net (copies on
        the net's device), so the net's own output/evaluate/serialization
        see them."""
        net, lo, hi = self.net, self.lo, self.hi
        run_list = unstack_run_params(join_stages(self.params["run"]))
        outer = iter(self.params["outer"])
        for i in range(len(net.layers)):
            src = run_list[i - lo] if lo <= i < hi else next(outer)
            net._params[i] = tree_map(
                lambda a: a.detach().to(net.device).clone(), src)
        return net
