"""MultiLayerNetwork: the sequential-network runtime.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py``. Parameters are a
list of per-layer ``{name: Tensor}`` dicts in the JAX package's order and
with its names, on one explicit device, and so is the updater state. The
network runs on the GPU unless the caller passes ``device="cpu"``.

As in the JAX package, ``output``, ``feedForward`` (a list of them),
``rnnTimeStep``, ``params``, ``getParam``, ``paramTable`` and
``rnnGetPreviousState`` (a dict of them) return the port's ``INDArray``,
and every call that takes an array takes an ``INDArray``, a tensor or
numpy. ``getParam``, ``paramTable`` and
``rnnGetPreviousState`` hand out copies, so an in-place op on what they
return (which the port's ``INDArray`` writes into its tensor) leaves the
network as it was, as in the JAX package. Serving and the optimizer work
on the tensors underneath (``_infer_fn``, ``_params``), with no wrapper.

A layer's group may nest groups (Bidirectional's ``{"fwd": {...}, "bwd":
{...}}``). Every call that walks the params (``params``, ``setParams``,
``numParams``, L1/L2, the gradient normalizations, the updaters,
``summary``) takes the leaves in ``jax.tree_util.tree_leaves`` order, dict
keys sorted at every level, so ``params()`` is the JAX package's leaves
concatenated. The JAX package's ``params``, ``numParams`` and ``summary``
raise on such groups; the port computes them.

``evaluate`` and ``evaluateRegression`` score an iterator with the port's
``evaluation`` package, padding a ragged last batch up to the largest
batch seen with ``serving.buckets.pad_rows`` and slicing it off again.

Each layer's input goes through the preprocessor the configuration
recorded for it (``_apply_preprocessor``: the reshape of a flat image
before the first conv, the channel-major flatten before the first dense
layer) in ``_forward``, ``_loss_from`` and ``feedForward``, so
``output``, ``fit``, ``score``, ``evaluate`` and ``gradients`` all see it.

A training step is eager PyTorch: the forward with the fused loss,
``torch.autograd.grad`` (through the LSTM kernels' autograd Function on the
GPU), per-layer gradient normalization, the updater, and ``p -= u`` in
place. An output layer with ``LOSS_UPDATES_STATE`` (OCNN's threshold
``r``) returns its new state with the loss in training (the loss-state
channel of ``_loss_from``); in training every layer state's ``_aux_loss``
(MoELayer's load-balancing loss) joins the loss after the output layer's
and before L1/L2 (the aux-loss channel). ``pretrainLayer`` and ``pretrain`` minimize
an AutoEncoder's or a VAE's ``pretrain_loss`` with the layer's own
updater, the layers below frozen, the noise drawn from a generator seeded
by ``conf.seed + 2 + layer`` and the iteration.

The configuration's precision policy (``conf.precision_policy``) sets
the dtypes, as in the JAX package: ``init`` allocates the params, layer
states and updater state in the policy's param dtype; ``_forward`` casts
float inputs to the compute dtype (float64 left alone); under a
``*_mixed`` policy ``_loss_from`` casts the float32 masters to the
compute dtype inside what autograd differentiates, so the gradients come
back in float32 and the updater's moments stay float32, and inference
(``output``, serving, ``rnnTimeStep``) runs in the compute dtype too and
returns the output dtype. ``feedForward`` and ``pretrainLayer`` run in
the param dtype. A batch enters as float32 (float64 for a float64
network), labels included, as numpy arrays enter the JAX package. With
loss scaling (``_prec_state``: the scaler's 0-d tensors) a step scales
the loss, unscales the gradients exactly, and keeps the params, the
updater state and the layer states bitwise as they were when a gradient
is not finite (a ``torch.where`` on the device's flag), then advances the
scaler; ``fit`` publishes the scaler state one step behind through
``precision.monitor_for("fit", ...)``. Nothing on the step reads a device
value on the host.

``fit`` over a plain ``DataSetIterator`` wraps it in a
``DevicePrefetcher`` (``datasets/prefetch.py``), as the JAX package does,
when the iterator ``asyncSupported()``, ``default_depth() > 0`` and the
network is not TBPTT: the producer thread pads, builds the mask, casts a
float batch to the network's input dtype and copies it to the device on a
CUDA side stream (``_prefetch_prepare``), so the step takes device tensors
(a ``DeviceBatch``) and copies nothing. The values are those of the
blocking path, which ``set_default_depth(0)`` restores.

``fitMultiBatch`` runs K steps over stacked [K, batch, ...] batches as K
``fit`` calls would, bitwise, and ``_step`` takes the data-parallel
trainer's gradient all-reduce (``parallel/trainer.py``) as a hook.

Left for later slices, as in ROADMAP.md: training health, telemetry
beyond the precision monitor, and listeners.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.samediff import (
    _as_batches, _host_array, _ones_mask, _pad_to_bucket, _prepare_batches,
    _split_dataset_full)
from deeplearning4j_tpu_torch.backend import resolve_device
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator
from deeplearning4j_tpu_torch.datasets.prefetch import (
    DeviceBatch, DevicePrefetcher, default_depth)
from deeplearning4j_tpu_torch.evaluation import (
    Evaluation, RegressionEvaluation)
from deeplearning4j_tpu_torch.ndarray import INDArray
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    BackpropType, MultiLayerConfiguration, _apply_preprocessor)
from deeplearning4j_tpu_torch.nn.conf.layers import (
    OUTPUT_LAYER_TYPES, Bidirectional)
from deeplearning4j_tpu_torch.precision.monitor import monitor_for
from deeplearning4j_tpu_torch.precision.policy import cast_floating
from deeplearning4j_tpu_torch.precision.scaler import DynamicLossScaler
from deeplearning4j_tpu_torch.serving.buckets import pad_rows
from deeplearning4j_tpu_torch.tree_util import (
    tree_fill, tree_items, tree_leaves, tree_map)


class GradientNormalization:
    ClipL2PerLayer = "clip_l2_per_layer"
    ClipL2PerParamType = "clip_l2_per_param"
    ClipElementWiseAbsoluteValue = "clip_elementwise"
    RenormalizeL2PerLayer = "renorm_l2_per_layer"


def _normalize_grads(grads, mode, threshold):
    """One layer's {name: gradient} (nested groups included); the L2 modes
    take the norm over all of the layer's gradients in leaf order (as the
    JAX package does, per-param-type included)."""
    if mode is None:
        return grads
    if mode == GradientNormalization.ClipElementWiseAbsoluteValue:
        return tree_map(lambda g: torch.clamp(g, -threshold, threshold),
                        grads)
    norm = torch.sqrt(sum((g * g).sum() for g in tree_leaves(grads))
                      + 1e-12)
    if mode == GradientNormalization.RenormalizeL2PerLayer:
        return tree_map(lambda g: g / norm, grads)
    scale = torch.clamp(threshold / norm, max=1.0)
    return tree_map(lambda g: g * scale, grads)


def _detached(states):
    """Layer states with no graph: carried state never takes a gradient
    across steps or TBPTT segments."""
    return [tree_map(torch.Tensor.detach, st) for st in states]


def _shapes(group):
    """A param group's {name: shape} (nested alike)."""
    return tree_map(lambda v: tuple(v.shape), group)


def _as_input(x, device, dtype):
    """A batch (INDArray, tensor or numpy) as a tensor on ``device``;
    float inputs take ``dtype``."""
    if isinstance(x, INDArray):
        x = x.torch()
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x, device=device)
    if x.is_floating_point() and x.dtype != dtype:
        x = x.to(dtype)
    return x


def _io_dtype(conf):
    """The dtype a float batch enters a network in: float64 for a float64
    network, float32 otherwise (the JAX package reads numpy through
    ``jnp.asarray`` with 64-bit types off). The compute cast comes after,
    in ``_forward``."""
    return conf.dtype if conf.dtype == torch.float64 else torch.float32


def _to_compute(x, dtype):
    """A float batch in the compute dtype; integer ids and float64 as they
    are."""
    if x.is_floating_point() and x.dtype != dtype and \
            x.dtype != torch.float64:
        return x.to(dtype)
    return x


def _to_output(y, dtype):
    """An inference result in the policy's output dtype."""
    return y.to(dtype) if y.is_floating_point() and y.dtype != dtype else y


def _gated_update(finite, params, upds, opt_before, opt_after):
    """The updates applied where ``finite`` (a 0-d bool tensor) holds and
    nothing changed where it does not: each param becomes
    ``where(finite, p - u, p)`` in place, and each updater-state leaf (which
    the updater moved in place) ``where(finite, new, old)`` from
    ``opt_before``, its copy taken before the update. Bitwise: a finite
    step's params are ``p - u`` as in the ungated step."""
    for p, u in zip(params, upds):
        p.copy_(torch.where(finite, p - u, p))
    for new, old in zip(opt_after, opt_before):
        new.copy_(torch.where(finite, new, old))


def _keep_if(finite, new, old):
    """Layer states: ``new`` where ``finite`` holds, else ``old``."""
    return tree_map(lambda n, o: torch.where(finite, n, o), new, old)


def _dropout_generator(seed, it, device, offset=1):
    """A step's generator, seeded from ``seed`` + ``offset`` (1 for
    dropout) and the iteration."""
    seq = np.random.SeedSequence([int(seed) + offset, int(it)])
    return torch.Generator(device=device).manual_seed(
        int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1)))


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration, device=None):
        self.conf = conf
        self.layers = conf.layers
        if not self.layers:
            raise ValueError("configuration has no layers")
        if not isinstance(self.layers[-1], OUTPUT_LAYER_TYPES):
            raise ValueError("last layer must be an OutputLayer")
        self.device = resolve_device(device)
        self._policy = conf.precision_policy
        self._scaler = DynamicLossScaler.for_policy(self._policy)
        self._params: list[dict] = []
        self._states: list[dict] = []
        self._opt_states: list = []
        self._prec_state: dict = {}   # the loss scaler's state; {} = off
        self._stream_states = None   # rnnTimeStep carried state per layer
        self._stream_batch = None
        self._bucket = None   # fit batch-size bucket (ragged tail pads to it)
        self._iteration = 0
        self._epoch = 0
        self._score = None
        self._initialized = False

    # -- init ----------------------------------------------------------------
    def init(self, params=None):
        """Initialize from the configuration's seed, or install ``params``
        (a list of per-layer {name: Tensor} dicts in the policy's param
        dtype, as made by ``utils.convert.params_from_numpy``)."""
        dtype = self._policy.param_torch
        if params is None:
            gen = torch.Generator().manual_seed(int(self.conf.seed))
            params = [lr.init_params(gen, dtype, self.device)
                      for lr in self.layers]
        else:
            if len(params) != len(self.layers):
                raise ValueError(f"{len(params)} param dicts for "
                                 f"{len(self.layers)} layers")
            for i, (lr, p) in enumerate(zip(self.layers, params)):
                want = lr.param_shapes()
                got = _shapes(p)
                if got != want:
                    raise ValueError(f"layer {i} params {got} do not match "
                                     f"the configuration's {want}")
                for v in tree_leaves(p):
                    if v.device != self.device or v.dtype != dtype:
                        raise ValueError(
                            f"layer {i} params must be {dtype} on "
                            f"{self.device}, got {v.dtype} on {v.device}")
        self._params = list(params)
        self._states = [lr.init_state(dtype, self.device)
                        for lr in self.layers]
        self._opt_states = [self._layer_updater(i).init_state(p) if p else ()
                            for i, p in enumerate(self._params)]
        self._prec_state = (self._scaler.init_state(self.device)
                            if self._scaler else {})
        self._initialized = True
        return self

    def _layer_updater(self, i):
        u = self.layers[i].updater
        return u if u is not None else self.conf.defaults["updater"]

    def _check_init(self):
        if not self._initialized:
            raise RuntimeError("call init() first")

    def _input(self, x):
        """A batch (INDArray, tensor or numpy) as a tensor on this
        network's device; float inputs take ``_io_dtype``."""
        return _as_input(x, self.device, _io_dtype(self.conf))

    def _compute_params(self, params):
        """The params in the compute dtype under a ``*_mixed`` policy (a
        differentiable cast); as they are otherwise."""
        if self._policy.is_mixed:
            return cast_floating(params, self._policy.compute_torch)
        return params

    # -- pure forward --------------------------------------------------------
    def _forward(self, params, states, x, training=False, generator=None,
                 upto=None, compute_dtype=None):
        """Float inputs take the policy's compute dtype, or
        ``compute_dtype`` where the caller picks one."""
        x = _to_compute(x, compute_dtype or self._policy.compute_torch)
        new_states = []
        n = len(self.layers) if upto is None else upto
        for i in range(n):
            x = _apply_preprocessor(self.conf.preprocessors[i], x)
            x, st = self.layers[i].apply(params[i], states[i], x, training,
                                         generator)
            new_states.append(st)
        new_states.extend(states[n:])
        return x, new_states

    def _infer_fn(self, training=False):
        """The inference function ``(params, states, x) -> y``. PyTorch runs
        eagerly, so there is nothing to compile or cache. With
        ``training`` the layers run in training mode without a generator,
        so dropout is off, as in the JAX package (no rng there)."""

        out = self._policy.output_torch

        def fn(params, states, x):
            with torch.inference_mode():
                y, _ = self._forward(self._compute_params(params), states, x,
                                     training)
            return _to_output(y, out)

        return fn

    def output(self, x, train: bool = False) -> INDArray:
        """The network's output for batch ``x`` ([N, C, T] for recurrent
        nets), over a tensor on the network's device."""
        self._check_init()
        return INDArray(self._infer_fn(train)(self._params, self._states,
                                              self._input(x)))

    def feedForward(self, x, train: bool = False) -> list:
        """The input and every layer's activation, as ``INDArray``s (in
        training mode without a generator, dropout off, with ``train``), in
        the param dtype."""
        self._check_init()
        x = _to_compute(self._input(x), self._policy.param_torch)
        acts = [INDArray(x)]
        with torch.inference_mode():
            for i, lr in enumerate(self.layers):
                x = _apply_preprocessor(self.conf.preprocessors[i], x)
                x, _ = lr.apply(self._params[i], self._states[i], x, train)
                acts.append(INDArray(x))
        return acts

    # -- streaming inference (rnnTimeStep / rnnClearPreviousState) -----------
    def _recurrent_indices(self, forbid_bidirectional=False):
        """The layers that carry streaming state: recurrent layers and
        wrappers of one (LastTimeStep(LSTM)). A Bidirectional layer
        carries none; with ``forbid_bidirectional`` (rnnTimeStep, TBPTT) it
        raises, since its backward direction needs the whole sequence."""
        out = []
        for i, lr in enumerate(self.layers):
            if isinstance(lr, Bidirectional):
                if forbid_bidirectional:
                    raise ValueError(
                        f"layer {i} is Bidirectional: streaming rnnTimeStep"
                        f"/TBPTT cannot carry state through a layer that "
                        f"consumes the whole sequence")
                continue
            if getattr(lr, "IS_RECURRENT", False) or getattr(
                    getattr(lr, "rnn", None), "IS_RECURRENT", False):
                out.append(i)
        return out

    def _seed_rnn_states(self, states, batch_size):
        out = list(states)
        for i in self._recurrent_indices():
            lr = self.layers[i]
            target = lr if getattr(lr, "IS_RECURRENT", False) else lr.rnn
            out[i] = target.streaming_state(batch_size, self.conf.dtype,
                                            self.device)
        return out

    def rnnTimeStep(self, x) -> INDArray:
        """Streaming inference with carried hidden state: x is [N, C] (one
        timestep) or [N, C, T] (a chunk). Successive calls continue the
        sequence; rnnClearPreviousState() resets."""
        self._check_init()
        x = self._input(x)
        single = x.dim() == 2
        if single:
            x = x[:, :, None]
        n = x.shape[0]
        rec = set(self._recurrent_indices(forbid_bidirectional=True))
        if self._stream_states is None or self._stream_batch != n:
            seeded = self._seed_rnn_states(self._states, n)
            self._stream_states = {i: seeded[i] for i in rec}
            self._stream_batch = n
        states = [self._stream_states[i] if i in rec else s
                  for i, s in enumerate(self._states)]
        with torch.inference_mode():
            y, new_states = self._forward(self._compute_params(self._params),
                                          states, x)
        self._stream_states = {i: new_states[i] for i in rec}
        return INDArray(y[:, :, 0] if single and y.dim() == 3 else y)

    def rnnClearPreviousState(self):
        self._stream_states = None
        self._stream_batch = None

    def rnnGetPreviousState(self, layer_idx: int) -> dict:
        """The carried state of a layer, {name: INDArray} (copies)."""
        if self._stream_states is None:
            return {}
        return {k: INDArray(v.clone())
                for k, v in self._stream_states.get(layer_idx, {}).items()}

    def rnnSetPreviousState(self, layer_idx: int, state: dict):
        """Install carried state (e.g. restoring a saved streaming session).
        Works after rnnClearPreviousState: a fresh session is seeded from
        the given state's batch size."""
        vals = {k: self._input(v) for k, v in state.items()}
        if self._stream_states is None:
            if not vals:
                raise ValueError("cannot infer batch size from empty state")
            n = next(iter(vals.values())).shape[0]
            seeded = self._seed_rnn_states(self._states, n)
            self._stream_states = {i: seeded[i]
                                   for i in self._recurrent_indices()}
            self._stream_batch = n
        self._stream_states[layer_idx] = vals

    # -- training ------------------------------------------------------------
    def _loss_from(self, params, states, f, l, training, generator,
                   mask=None):
        """Forward to the last hidden activation, then the output layer's
        fused pre-activation loss, plus L1/L2 on every parameter. Under a
        ``*_mixed`` policy the master params are cast to the compute dtype
        here, inside what autograd differentiates."""
        params = self._compute_params(params)
        out_idx = len(self.layers) - 1
        h, new_states = self._forward(params, states, f, training, generator,
                                      upto=out_idx)
        h = _apply_preprocessor(self.conf.preprocessors[out_idx], h)
        out_layer = self.layers[out_idx]
        if training and getattr(out_layer, "LOSS_UPDATES_STATE", False):
            # the loss-state channel: the output layer's apply() does not
            # run in training, so its state update rides with the loss
            loss, new_states[out_idx] = out_layer.compute_loss_with_state(
                params[out_idx], h, l, mask, states[out_idx])
        else:
            loss = out_layer.compute_loss(params[out_idx], h, l, mask)
        if training:
            # the aux-loss channel: a layer may leave a scalar under
            # "_aux_loss" in its state, which joins the objective
            for st in new_states:
                if isinstance(st, dict) and "_aux_loss" in st:
                    loss = loss + st["_aux_loss"]
        reg = 0.0
        for lr, p in zip(self.layers, params):
            leaves = tree_leaves(p)
            if lr.l2:
                reg = reg + lr.l2 * sum((w * w).sum() for w in leaves) * 0.5
            if lr.l1:
                # |w| with the JAX package's subgradient at 0 (1, where
                # torch's abs takes 0), so a zero bias moves as it does there
                reg = reg + lr.l1 * sum(torch.where(w >= 0, w, -w).sum()
                                        for w in leaves)
        return loss + reg, new_states

    def _value_and_grad(self, states, f, l, mask, training, generator,
                        prec=None):
        """(loss, new_states, per-layer gradients) at the current params; a
        parameter the loss does not reach (a VAE's log-variance head in
        supervised training) gets a zero gradient. With the scaler state
        ``prec`` the gradients are those of the scaled loss (the loss
        returned is not scaled)."""
        leaves = [tree_map(lambda v: v.detach().requires_grad_(), p)
                  for p in self._params]
        loss, new_states = self._loss_from(leaves, states, f, l, training,
                                           generator, mask=mask)
        flat = tree_leaves(leaves)
        target = loss if prec is None else self._scaler.scale_loss(loss,
                                                                   prec)
        grads = torch.autograd.grad(target, flat, allow_unused=True) \
            if flat else ()
        grads = iter(torch.zeros_like(v) if g is None else g
                     for v, g in zip(flat, grads))
        return (loss.detach(), _detached(new_states),
                [tree_fill(p, grads) for p in leaves])

    def _dropout_generator(self, it):
        """The step's dropout generator, seeded from conf.seed + 1 and the
        iteration; None when no layer drops out."""
        if not any(lr.dropOut and lr.dropOut < 1.0 for lr in self.layers):
            return None
        return _dropout_generator(self.conf.seed, it, self.device)

    def _step(self, states, f, l, lmask, reduce_grads=None):
        """One optimizer step on a device batch; returns (loss, states).
        The params and the updater state are updated in place; with loss
        scaling, only where the unscaled gradients are all finite.
        ``reduce_grads(loss, grads) -> (loss, grads)`` (the data-parallel
        all-reduce of ``parallel/trainer.py``) runs on the loss and the
        per-layer gradients before anything reads them."""
        it = self._iteration
        prec = self._prec_state if self._scaler is not None else {}
        loss, new_states, grads = self._value_and_grad(
            states, f, l, lmask, True, self._dropout_generator(it),
            prec=prec or None)
        if reduce_grads is not None:
            loss, grads = reduce_grads(loss, grads)
        with torch.no_grad():
            if prec:
                grads = self._scaler.unscale(grads, prec)
                finite = self._scaler.all_finite(grads)
                opt_before = [v.clone() for v in tree_leaves(
                    self._opt_states)]
            params, upds = [], []
            for i, lr in enumerate(self.layers):
                if not self._params[i]:
                    continue
                g = _normalize_grads(grads[i], lr.gradientNormalization,
                                     lr.gradientNormalizationThreshold or 1.0)
                upd, self._opt_states[i] = self._layer_updater(i).apply_mixed(
                    g, self._opt_states[i], self._params[i], it)
                if prec:   # applied below, once the gate is known
                    params += tree_leaves(self._params[i])
                    upds += tree_leaves(upd)
                    continue
                for p, u in zip(tree_leaves(self._params[i]),
                                tree_leaves(upd)):
                    p.sub_(u)
            if prec:
                _gated_update(finite, params, upds, opt_before,
                              tree_leaves(self._opt_states))
                new_states = _keep_if(finite, new_states, states)
                self._prec_state = self._scaler.next_state(prec, finite)
        self._iteration += 1
        return loss, new_states

    def _device_batch(self, f, l, lmask):
        return (self._input(f), self._input(l),
                torch.as_tensor(lmask, device=self.device))

    def _prefetch_prepare(self):
        """The host-side half of the input pipeline, run in the
        DevicePrefetcher's producer thread before its copy: split,
        pad-to-bucket, mask, and a float batch cast to the input dtype (as
        ``_input`` would on the device), so the fit loop's per-batch host
        work collapses to a queue pop. Returns the raw DataSet (the host
        path) for shapes it does not understand."""
        io = np.dtype(str(_io_dtype(self.conf)).replace("torch.", ""))

        def prepare(ds):
            feats, labels, _, lmasks = _split_dataset_full(ds)
            if len(feats) != 1 or len(labels) != 1:
                return ds
            f = _host_array(feats[0])
            l = _host_array(labels[0])
            lmask = (_host_array(lmasks[0], np.float32)
                     if lmasks[0] is not None else _ones_mask(l))
            real = f.shape[0]
            bucket = max(real, self._bucket or 0)
            if real < bucket:
                (f, l), lmask, _ = _pad_to_bucket([f, l], lmask, bucket)
            f, l = (a.astype(io) if a.dtype.kind == "f" and a.dtype != io
                    else a for a in (f, l))
            return DeviceBatch(f, l, lmask, bucket=bucket, real=real)

        return prepare

    def _wrap_prefetch(self, data):
        """Wrap a plain DataSetIterator in a DevicePrefetcher on this
        network's device (the copy overlaps the steps). Returns (data,
        prefetcher-or-None); the caller closes it."""
        if (isinstance(data, DataSetIterator)
                and not isinstance(data, DevicePrefetcher)
                and data.asyncSupported()
                and default_depth() > 0
                and self.conf.backpropType != BackpropType.TruncatedBPTT):
            wrapped = DevicePrefetcher(
                data, prepare=self._prefetch_prepare(), loop="fit",
                device=self.device)
            return wrapped, wrapped
        return data, None

    def fit(self, data, epochs: int | None = None):
        """fit(iterator) / fit(iterator, nEpochs) / fit(features, labels) /
        fit(DataSet). Every batch trains with an explicit label mask; a
        ragged final batch is padded to the largest batch seen (its last
        row repeated), with mask 0 on the padding rows. Each step's layer
        states (BatchNormalization's running statistics) are kept, the
        recurrent layers' carried state dropped; the padding rows enter
        the batch statistics, as in the JAX package."""
        self._check_init()
        if epochs is not None and not isinstance(epochs, int):
            data, epochs = (data, epochs), 1   # fit(features, labels)
        epochs = epochs or 1
        last_loss = None
        pm = monitor_for("fit", self._policy)
        if pm is not None:
            pm.baseline_from(self._prec_state)
        data, prefetcher = self._wrap_prefetch(data)
        try:
            last_loss = self._fit_epochs(data, epochs, pm)
        finally:
            if prefetcher is not None:
                prefetcher.close()
        if pm is not None:
            pm.flush()
        if last_loss is not None:
            self._score = float(last_loss)
        return self

    def _fit_epochs(self, data, epochs, pm):
        """fit's epochs over ``data``; returns the last step's loss."""
        last_loss = None
        for epoch_i in range(epochs):
            batches, data = _prepare_batches(data, epoch_i, epochs)
            for ds in batches:
                if isinstance(ds, DeviceBatch) and (
                        self._bucket is None or ds.bucket >= self._bucket):
                    # staged by the prefetcher: padded, masked and on the
                    # device already
                    f, l, lmask = ds.features, ds.labels, ds.mask
                    self._bucket = ds.bucket
                elif isinstance(ds, DeviceBatch):
                    # staged against a smaller bucket than this network's
                    # (the bucket grew while the producer ran ahead): the
                    # host pad path, keeping the staged mask so rows
                    # already padded stay out of the loss
                    f, l, lmask = (_host_array(a) for a in (
                        ds.features, ds.labels, ds.mask))
                    (f, l), lmask, _ = _pad_to_bucket([f, l], lmask,
                                                      self._bucket)
                else:
                    feats, labels, _, lmasks = _split_dataset_full(ds)
                    f = _host_array(feats[0])
                    l = _host_array(labels[0])
                    lmask = (_host_array(lmasks[0], np.float32)
                             if lmasks[0] is not None else _ones_mask(l))
                    if self._bucket is None or f.shape[0] > self._bucket:
                        self._bucket = f.shape[0]
                    if f.shape[0] < self._bucket:
                        (f, l), lmask, _ = _pad_to_bucket([f, l], lmask,
                                                          self._bucket)
                tbptt = (self.conf.backpropType == BackpropType.TruncatedBPTT
                         and self.conf.tbpttLength and f.ndim == 3
                         and f.shape[2] > self.conf.tbpttLength)
                if tbptt:
                    last_loss = self._fit_tbptt(f, l, lmask, pm)
                else:
                    it_used = self._iteration
                    last_loss, states = self._step(
                        self._states, *self._device_batch(f, l, lmask))
                    self._states = self._strip_rnn_states(states)
                    if pm is not None:
                        pm.on_step(it_used, self._prec_state)
            self._epoch += 1
        return last_loss

    def fitMultiBatch(self, features_k, labels_k, repeats: int = 1):
        """K optimizer steps over stacked [K, batch, ...] minibatches, as K
        successive ``fit`` calls on the K slices (each with a mask of
        ones); ``repeats=R`` makes R passes over them. Returns the [K]
        losses (of the last pass). The reference scans the K steps in one
        launch; eager PyTorch runs them as a loop, and a stack already on
        this network's device (``DevicePrefetcher.takeMulti``) is sliced
        where it lies, with no host bounce. The precision monitor hears
        of the call once, after its last step (``on_launch``)."""
        self._check_init()
        f_k, l_k = self._input(features_k), self._input(labels_k)
        if f_k.shape[0] != l_k.shape[0]:
            raise ValueError(f"{f_k.shape[0]} feature batches for "
                             f"{l_k.shape[0]} label batches")
        mask = torch.as_tensor(_ones_mask(l_k[0]), device=self.device)
        pm = monitor_for("fit", self._policy)
        if pm is not None:
            pm.baseline_from(self._prec_state)
        it0 = self._iteration
        losses = None
        for _ in range(repeats):
            losses = []
            for f, l in zip(f_k, l_k):
                loss, states = self._step(self._states, f, l, mask)
                self._states = self._strip_rnn_states(states)
                losses.append(loss)
            losses = torch.stack(losses)
        self._score = float(losses[-1])
        if pm is not None:
            pm.on_launch(range(it0, self._iteration), self._prec_state)
        return losses

    def _strip_rnn_states(self, states):
        out = list(states)
        for i in self._recurrent_indices():
            out[i] = {}
        return out

    def _fit_tbptt(self, f, l, lmask, pm=None):
        """Truncated BPTT: each segment of tbpttLength steps is one
        optimizer step; h and c carry across segments, detached, and reset
        at the next minibatch."""
        seg = self.conf.tbpttLength
        self._recurrent_indices(forbid_bidirectional=True)
        states = self._seed_rnn_states(self._states, f.shape[0])
        loss = None
        for t0 in range(0, f.shape[2], seg):
            fc = f[:, :, t0:t0 + seg]
            lc = l[:, :, t0:t0 + seg] if l.ndim == 3 else l
            mc = lmask[:, t0:t0 + seg] if lmask.ndim == 2 else lmask
            if fc.shape[2] < seg:
                # zero-pad the tail segment to the segment length and mask
                # the padded timesteps out of the loss
                pad = seg - fc.shape[2]
                fc = np.concatenate(
                    [fc, np.zeros(fc.shape[:2] + (pad,), fc.dtype)], axis=2)
                if lc.ndim == 3:
                    lc = np.concatenate(
                        [lc, np.zeros(lc.shape[:2] + (pad,), lc.dtype)],
                        axis=2)
                if mc.ndim == 2:
                    mc = np.concatenate(
                        [mc, np.zeros((mc.shape[0], pad), mc.dtype)], axis=1)
            it_used = self._iteration
            loss, states = self._step(states,
                                      *self._device_batch(fc, lc, mc))
            if pm is not None:
                pm.on_step(it_used, self._prec_state)
        self._states = self._strip_rnn_states(states)
        return loss

    # -- layerwise unsupervised pretraining ----------------------------------
    def pretrainLayer(self, layer_idx: int, data, epochs: int = 1):
        """Unsupervised pretraining of ONE layer: each batch's features go
        through layers [0, layer_idx) in inference mode, then one step of
        the layer's ``pretrain_loss`` with the layer's own updater."""
        self._check_init()
        lr = self.layers[layer_idx]
        if not getattr(lr, "HAS_PRETRAIN_LOSS", False):
            raise ValueError(
                f"layer {layer_idx} ({type(lr).__name__}) has no "
                f"unsupervised pretrain loss")
        updater = self._layer_updater(layer_idx)
        loss = None
        for epoch_i in range(epochs):
            batches, data = _prepare_batches(data, epoch_i, epochs)
            for ds in batches:
                feats, _, _, _ = _split_dataset_full(ds)
                f = self._input(_host_array(feats[0]))
                with torch.no_grad():
                    h, _ = self._forward(
                        self._params, self._states, f, upto=layer_idx,
                        compute_dtype=self._policy.param_torch)
                    h = _apply_preprocessor(
                        self.conf.preprocessors[layer_idx], h)
                gen = _dropout_generator(self.conf.seed, self._iteration,
                                         self.device, offset=2 + layer_idx)
                leaves = tree_map(lambda v: v.detach().requires_grad_(),
                                  self._params[layer_idx])
                loss = lr.pretrain_loss(leaves, h, gen)
                g = tree_fill(leaves, iter(torch.autograd.grad(
                    loss, tree_leaves(leaves))))
                loss = loss.detach()
                with torch.no_grad():
                    g = _normalize_grads(
                        g, lr.gradientNormalization,
                        lr.gradientNormalizationThreshold or 1.0)
                    upd, self._opt_states[layer_idx] = updater.apply_mixed(
                        g, self._opt_states[layer_idx],
                        self._params[layer_idx], self._iteration)
                    for p, u in zip(tree_leaves(self._params[layer_idx]),
                                    tree_leaves(upd)):
                        p.sub_(u)
                self._iteration += 1
        if loss is not None:
            self._score = float(loss)
        return self

    def pretrain(self, data, epochs: int = 1):
        """Pretrain every pretrainable layer in order; a one-shot iterable
        is materialized once, so every layer sees the data."""
        if not hasattr(data, "reset") and not isinstance(
                data, (list, tuple)):
            data = list(_as_batches(data))
        for i, lr in enumerate(self.layers):
            if getattr(lr, "HAS_PRETRAIN_LOSS", False):
                self.pretrainLayer(i, data, epochs)
        return self

    # -- scoring / gradients ---------------------------------------------------
    def score(self, dataset=None) -> float:
        self._check_init()
        if dataset is None:
            if self._score is None:
                raise ValueError("no score yet: call fit() or score(dataset)")
            return self._score
        feats, labels, _, lmasks = _split_dataset_full(dataset)
        mask = None if lmasks[0] is None else torch.as_tensor(
            _host_array(lmasks[0]), device=self.device)
        with torch.no_grad():
            loss, _ = self._loss_from(self._params, self._states,
                                      self._input(feats[0]),
                                      self._input(labels[0]), False, None,
                                      mask=mask)
        return float(loss)

    def _eval_outputs(self, iterator):
        """(labels, predictions, mask) per batch, the predictions as numpy.
        A ragged batch is padded up to the largest batch seen so far with
        ``pad_rows`` (its last row repeated) and the padding sliced off the
        output, so the rows' answers are those of an unpadded batch of a
        row-wise network; the masks are left as they are."""
        bucket = None
        for ds in _as_batches(iterator):
            feats, labels, _, lmasks = _split_dataset_full(ds)
            f = _host_array(feats[0])
            n = f.shape[0]
            if bucket is None or n > bucket:
                bucket = n
            out = self.output(pad_rows(f, bucket))
            yield labels[0], out.toNumpy()[:n], lmasks[0]

    def evaluate(self, iterator, numClasses=None) -> Evaluation:
        self._check_init()
        ev = Evaluation(numClasses)
        for labels, out, mask in self._eval_outputs(iterator):
            ev.eval(labels, out, mask=mask)
        return ev

    def evaluateRegression(self, iterator) -> RegressionEvaluation:
        self._check_init()
        ev = RegressionEvaluation()
        for labels, out, mask in self._eval_outputs(iterator):
            ev.eval(labels, out, mask=mask)
        return ev

    def gradients(self, features, labels) -> list[dict]:
        """Per-layer gradients of the loss (inference mode: no dropout)."""
        self._check_init()
        return self._value_and_grad(self._states, self._input(features),
                                    self._input(labels), None, False,
                                    None)[2]

    def computeGradientAndScore(self, features, labels):
        self._check_init()
        loss, _, grads = self._value_and_grad(
            self._states, self._input(features), self._input(labels), None,
            False, None)
        self._score = float(loss)
        return grads, self._score

    # -- params --------------------------------------------------------------
    def params(self) -> INDArray:
        """Flat parameter vector in layer order, each layer's leaves in
        tree-leaves order (the JAX package's order); a copy."""
        self._check_init()
        leaves = [v.reshape(-1) for v in tree_leaves(self._params)]
        if not leaves:
            return INDArray(torch.zeros((0,), dtype=self._policy.param_torch,
                                        device=self.device))
        return INDArray(torch.cat(leaves))

    def setParams(self, flat):
        """Copy a flat vector (``params()`` order) into the params, in
        place."""
        self._check_init()
        flat = self._input(flat).reshape(-1)
        if flat.numel() != self.numParams():
            raise ValueError(f"{flat.numel()} values for {self.numParams()} "
                             f"parameters")
        off = 0
        with torch.no_grad():
            for v in tree_leaves(self._params):
                n = v.numel()
                v.copy_(flat[off:off + n].reshape(v.shape))
                off += n

    def numParams(self) -> int:
        return sum(v.numel() for v in tree_leaves(self._params))

    def getParam(self, layer_idx: int, name: str):
        """A copy of one parameter, or of a nested group as
        {name: INDArray}."""
        return tree_map(lambda v: INDArray(v.clone()),
                        self._params[layer_idx][name])

    def setParam(self, layer_idx: int, name: str, value):
        """Replace one parameter, or a nested group from a dict of
        arrays, with a copy of the same shape."""
        old = self._params[layer_idx][name]

        def put(o, v, where):
            v = self._input(v)
            if v.shape != o.shape:
                raise ValueError(f"param {where} has shape "
                                 f"{tuple(o.shape)}, got {tuple(v.shape)}")
            return v.to(o.dtype).clone()

        if isinstance(old, dict):
            if not isinstance(value, dict) or set(value) != set(old):
                raise ValueError(f"param group {layer_idx}_{name} takes a "
                                 f"dict of {sorted(old)}")
            self._params[layer_idx][name] = {
                k: put(old[k], v, f"{layer_idx}_{name}_{k}")
                for k, v in value.items()}
        else:
            self._params[layer_idx][name] = put(old, value,
                                                f"{layer_idx}_{name}")

    def paramTable(self) -> dict:
        """{"<layer>_<name>": INDArray}, copies; a nested group's leaves
        as "<layer>_<group>_<name>"."""
        return {"_".join(map(str, (i, *path))): INDArray(v.clone())
                for i, p in enumerate(self._params)
                for path, v in tree_items(p)}

    def getIterationCount(self):
        return self._iteration

    def getEpochCount(self):
        return self._epoch

    def clone(self) -> "MultiLayerNetwork":
        """A new network from this one's configuration JSON on the same
        device, with copies of the params, layer states, updater state and
        loss-scaler state (the counters start at 0, as in the JAX
        package)."""
        other = MultiLayerNetwork(
            MultiLayerConfiguration.from_json(self.conf.to_json()),
            device=self.device)
        if self._initialized:
            copy = lambda v: v.detach().clone()  # noqa: E731
            other.init([tree_map(copy, p) for p in self._params])
            other._states = [tree_map(copy, s) for s in self._states]
            other._opt_states = [tree_map(copy, s)
                                 for s in self._opt_states]
            other._prec_state = tree_map(copy, self._prec_state)
        return other

    def summary(self) -> str:
        """One line a layer: index, type, parameter count and shapes."""
        lines = [f"{'idx':<4}{'layer':<28}{'nParams':<10}{'shape'}"]
        for i, (lr, p) in enumerate(zip(self.layers, self._params)):
            n = sum(v.numel() for v in tree_leaves(p))
            lines.append(f"{i:<4}{type(lr).__name__:<28}{n:<10}"
                         f"{_shapes(p)}")
        lines.append(f"Total params: {self.numParams()}")
        return "\n".join(lines)
