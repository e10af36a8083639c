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

A training step is eager PyTorch: the forward with the fused loss,
``torch.autograd.grad`` (through the LSTM kernels' autograd Function on the
GPU), per-layer gradient normalization, the updater, and ``p -= u`` in
place. Left for later slices, as in ROADMAP.md: the precision policies'
compute cast and loss scaler, the loss-state and aux-loss channels of
``_loss_from``, training health, telemetry, listeners, pretraining,
prefetch and fitMultiBatch.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.samediff import (
    _as_batches, _host_array, _ones_mask, _pad_to_bucket, _prepare_batches,
    _split_dataset_full)
from deeplearning4j_tpu_torch.backend import resolve_device
from deeplearning4j_tpu_torch.evaluation import (
    Evaluation, RegressionEvaluation)
from deeplearning4j_tpu_torch.ndarray import INDArray
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    BackpropType, MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.conf.layers import (
    OUTPUT_LAYER_TYPES, Bidirectional)
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


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration, device=None):
        self.conf = conf
        self.layers = conf.layers
        if not self.layers:
            raise ValueError("configuration has no layers")
        if not isinstance(self.layers[-1], OUTPUT_LAYER_TYPES):
            raise ValueError("last layer must be an OutputLayer")
        if conf.precision not in (None, "float32"):
            raise NotImplementedError(
                f"precision policy {conf.precision!r} comes with the "
                f"precision slice (ROADMAP.md, queue 1)")
        self.device = resolve_device(device)
        self._params: list[dict] = []
        self._states: list[dict] = []
        self._opt_states: list = []
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
        (a list of per-layer {name: Tensor} dicts, as made by
        ``utils.convert.params_from_numpy``)."""
        dtype = self.conf.dtype
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
        network's device; float inputs take the configured dtype."""
        if isinstance(x, INDArray):
            x = x.torch()
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x, device=self.device)
        if x.is_floating_point() and x.dtype != self.conf.dtype:
            x = x.to(self.conf.dtype)
        return x

    # -- pure forward --------------------------------------------------------
    def _forward(self, params, states, x, training=False, generator=None,
                 upto=None):
        new_states = []
        n = len(self.layers) if upto is None else upto
        for i in range(n):
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

        def fn(params, states, x):
            with torch.inference_mode():
                y, _ = self._forward(params, states, x, training)
            return y

        return fn

    def output(self, x, train: bool = False) -> INDArray:
        """The network's output for batch ``x`` ([N, C, T] for recurrent
        nets), over a tensor on the network's device."""
        self._check_init()
        return INDArray(self._infer_fn(train)(self._params, self._states,
                                              self._input(x)))

    def feedForward(self, x, train: bool = False) -> list:
        """The input and every layer's activation, as ``INDArray``s (in
        training mode without a generator, dropout off, with ``train``)."""
        self._check_init()
        x = self._input(x)
        acts = [INDArray(x)]
        with torch.inference_mode():
            for i, lr in enumerate(self.layers):
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
            y, new_states = self._forward(self._params, states, x)
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
        fused pre-activation loss, plus L1/L2 on every parameter."""
        out_idx = len(self.layers) - 1
        h, new_states = self._forward(params, states, f, training, generator,
                                      upto=out_idx)
        loss = self.layers[out_idx].compute_loss(params[out_idx], h, l, mask)
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

    def _value_and_grad(self, states, f, l, mask, training, generator):
        """(loss, new_states, per-layer gradients) at the current params."""
        leaves = [tree_map(lambda v: v.detach().requires_grad_(), p)
                  for p in self._params]
        loss, new_states = self._loss_from(leaves, states, f, l, training,
                                           generator, mask=mask)
        flat = tree_leaves(leaves)
        grads = iter(torch.autograd.grad(loss, flat) if flat else ())
        return (loss.detach(), _detached(new_states),
                [tree_fill(p, grads) for p in leaves])

    def _dropout_generator(self, it):
        """The step's dropout generator, seeded from conf.seed + 1 and the
        iteration; None when no layer drops out."""
        if not any(lr.dropOut and lr.dropOut < 1.0 for lr in self.layers):
            return None
        seed = np.random.SeedSequence([int(self.conf.seed) + 1, int(it)])
        return torch.Generator(device=self.device).manual_seed(
            int(seed.generate_state(1, np.uint64)[0] >> np.uint64(1)))

    def _step(self, states, f, l, lmask):
        """One optimizer step on a device batch; returns (loss, states).
        The params and the updater state are updated in place."""
        it = self._iteration
        loss, new_states, grads = self._value_and_grad(
            states, f, l, lmask, True, self._dropout_generator(it))
        with torch.no_grad():
            for i, lr in enumerate(self.layers):
                if not self._params[i]:
                    continue
                g = _normalize_grads(grads[i], lr.gradientNormalization,
                                     lr.gradientNormalizationThreshold or 1.0)
                upd, self._opt_states[i] = self._layer_updater(i).apply_mixed(
                    g, self._opt_states[i], self._params[i], it)
                for p, u in zip(tree_leaves(self._params[i]),
                                tree_leaves(upd)):
                    p.sub_(u)
        self._iteration += 1
        return loss, new_states

    def _device_batch(self, f, l, lmask):
        return (self._input(f), self._input(l),
                torch.as_tensor(lmask, device=self.device))

    def fit(self, data, epochs: int | None = None):
        """fit(iterator) / fit(iterator, nEpochs) / fit(features, labels) /
        fit(DataSet). Every batch trains with an explicit label mask; a
        ragged final batch is padded to the largest batch seen, with mask
        0 on the padding rows."""
        self._check_init()
        if epochs is not None and not isinstance(epochs, int):
            data, epochs = (data, epochs), 1   # fit(features, labels)
        epochs = epochs or 1
        last_loss = None
        for epoch_i in range(epochs):
            batches, data = _prepare_batches(data, epoch_i, epochs)
            for ds in batches:
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
                    last_loss = self._fit_tbptt(f, l, lmask)
                else:
                    last_loss, _ = self._step(
                        self._states, *self._device_batch(f, l, lmask))
            self._epoch += 1
        if last_loss is not None:
            self._score = float(last_loss)
        return self

    def _strip_rnn_states(self, states):
        out = list(states)
        for i in self._recurrent_indices():
            out[i] = {}
        return out

    def _fit_tbptt(self, f, l, lmask):
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
            loss, states = self._step(states,
                                      *self._device_batch(fc, lc, mc))
        self._states = self._strip_rnn_states(states)
        return loss

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
            return INDArray(torch.zeros((0,), dtype=self.conf.dtype,
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
        device, with copies of the params, layer states and updater state
        (the counters start at 0, as in the JAX package)."""
        other = MultiLayerNetwork(
            MultiLayerConfiguration.from_json(self.conf.to_json()),
            device=self.device)
        if self._initialized:
            copy = lambda v: v.detach().clone()  # noqa: E731
            other.init([tree_map(copy, p) for p in self._params])
            other._states = [tree_map(copy, s) for s in self._states]
            other._opt_states = [tree_map(copy, s)
                                 for s in self._opt_states]
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
