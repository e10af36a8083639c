"""ComputationGraph: the DAG-network runtime (multi-input, multi-output).

Counterpart of ``deeplearning4j_tpu/nn/graph.py``. Parameters, layer
states and updater state are ``{node name: ...}`` dicts on one explicit
device, with the JAX package's names; the graph runs on the GPU unless
the caller passes ``device="cpu"``.

The forward walks the configuration's topological order eagerly. Each
node's output is dropped as soon as the last node that reads it has run
(outputs excepted), so inference holds only the live frontier of the
DAG; under autograd the tensors a backward needs stay alive through the
autograd graph, and nothing else. No layer writes into its input, so an
activation read by two nodes (a residual block's input, read by its
first conv and its shortcut) is read intact by both, and autograd sums
its two gradients.

A training step is as ``MultiLayerNetwork``'s: the forward with each
output layer's fused loss summed over the outputs, L1/L2,
``torch.autograd.grad``, per-node gradient normalization and updater,
``p -= u`` in place; the step's layer states (BatchNormalization's
running statistics, by node name) are kept. ``fit`` takes a
``DataSet``, a ``MultiDataSet``, an ``(inputs, labels)`` pair or an
iterator of them, and pads a ragged last batch to the largest batch seen
by repeating its last row, with label mask 0 on the padding rows; the
padding rows enter the batch statistics, as in the JAX package.

Left for later slices, as in ROADMAP.md: ``fitMultiBatch``, the
precision policies and loss scaler, listeners, training health and
telemetry.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.samediff import (
    _as_batches, _host_array, _ones_mask, _pad_to_bucket, _prepare_batches,
    _split_dataset_full)
from deeplearning4j_tpu_torch.backend import resolve_device
from deeplearning4j_tpu_torch.evaluation import Evaluation
from deeplearning4j_tpu_torch.ndarray import INDArray
from deeplearning4j_tpu_torch.nn.conf.configuration import BackpropType
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration, GraphVertex)
from deeplearning4j_tpu_torch.nn.conf.layers import (
    OUTPUT_LAYER_TYPES, BaseLayer, Bidirectional)
from deeplearning4j_tpu_torch.nn.multilayer import (
    _as_input, _dropout_generator, _normalize_grads, _shapes)
from deeplearning4j_tpu_torch.serving.buckets import pad_rows
from deeplearning4j_tpu_torch.tree_util import (
    tree_fill, tree_leaves, tree_map)


def _last_uses(conf):
    """{name: the topological position of the last node that reads it}
    for every input and node; -1 for a name that no node reads."""
    last = {n: -1 for n in list(conf.inputs) + list(conf.nodes)}
    for i, name in enumerate(conf.topo_order):
        for n in conf.nodes[name][1]:
            last[n] = i
    return last


class ComputationGraph:
    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        self.conf = conf
        for out in conf.outputs:
            node, _ = conf.nodes[out]
            if not isinstance(node, OUTPUT_LAYER_TYPES):
                raise ValueError(f"output node {out!r} must be an "
                                 f"OutputLayer/LossLayer")
        if conf.precision not in (None, "float32"):
            raise NotImplementedError(
                f"precision policy {conf.precision!r} comes with the "
                f"precision slice (ROADMAP.md, queue 1)")
        self.device = resolve_device(device)
        self._last_use = _last_uses(conf)
        self._params: dict[str, dict] = {}
        self._states: dict[str, dict] = {}
        self._opt_states: dict = {}
        self._stream_states = None   # rnnTimeStep carried state per node
        self._stream_batch = None
        self._bucket = None   # fit batch-size bucket (ragged tail pads to it)
        self._iteration = 0
        self._epoch = 0
        self._score = None
        self._initialized = False

    # -- init ----------------------------------------------------------------
    def init(self, params=None):
        """Initialize from the configuration's seed (one generator drawn
        from node by node in topological order), or install ``params``
        ({node: {name: Tensor}} for every node, ``{}`` for a vertex, as
        made by ``utils.convert.params_from_numpy``)."""
        dtype = self.conf.dtype
        nodes = self.conf.nodes
        if params is None:
            gen = torch.Generator().manual_seed(int(self.conf.seed))
            params = {name: (nodes[name][0].init_params(gen, dtype,
                                                        self.device)
                             if isinstance(nodes[name][0], BaseLayer)
                             else {})
                      for name in self.conf.topo_order}
        else:
            if set(params) != set(nodes):
                raise ValueError(f"params for {sorted(params)}, the "
                                 f"configuration has {sorted(nodes)}")
            for name, p in params.items():
                node = nodes[name][0]
                want = (node.param_shapes() if isinstance(node, BaseLayer)
                        else {})
                if _shapes(p) != want:
                    raise ValueError(f"node {name!r} params {_shapes(p)} do "
                                     f"not match the configuration's {want}")
                for v in tree_leaves(p):
                    if v.device != self.device or v.dtype != dtype:
                        raise ValueError(
                            f"node {name!r} params must be {dtype} on "
                            f"{self.device}, got {v.dtype} on {v.device}")
        self._params = {name: params[name] for name in self.conf.topo_order}
        self._states = {
            name: (nodes[name][0].init_state(dtype, self.device)
                   if isinstance(nodes[name][0], BaseLayer) else {})
            for name in self.conf.topo_order}
        self._opt_states = {name: (self._updater(name).init_state(p)
                                   if p else ())
                            for name, p in self._params.items()}
        self._initialized = True
        return self

    def _updater(self, name):
        u = getattr(self.conf.nodes[name][0], "updater", None)
        return u if u is not None else self.conf.defaults["updater"]

    def _check_init(self):
        if not self._initialized:
            raise RuntimeError("call init() first")

    def _input(self, x):
        """A batch (INDArray, tensor or numpy) as a tensor on this graph's
        device; float inputs take the configured dtype."""
        return _as_input(x, self.device, self.conf.dtype)

    # -- forward over the DAG ------------------------------------------------
    def _forward(self, params, states, inputs: dict, training=False,
                 generator=None, stop_before_output=False):
        """(env, new_states): env holds the outputs' activations (with
        ``stop_before_output``, each output layer's input instead), every
        other activation dropped after its last reader."""
        env = {k: self._input(v) for k, v in inputs.items()}
        outputs = set(self.conf.outputs)
        last = self._last_use
        new_states = {}
        for i, name in enumerate(self.conf.topo_order):
            node, ins = self.conf.nodes[name]
            xs = [env[n] for n in ins]
            if isinstance(node, GraphVertex):
                env[name] = node.apply(*xs)
                new_states[name] = {}
            elif stop_before_output and name in outputs:
                # the output layer's input, for the fused loss
                env[name] = xs[0]
                new_states[name] = states[name]
            else:
                arg = xs if getattr(node, "MULTI_INPUT", False) else xs[0]
                env[name], new_states[name] = node.apply(
                    params[name], states[name], arg, training, generator)
            del xs
            for n in set(ins) | {name}:
                if last[n] <= i and n not in outputs:
                    env.pop(n, None)
        return env, new_states

    def _infer_fn(self, training=False):
        """``(params, states, x) -> y`` for a single-input, single-output
        graph (serving), under ``torch.inference_mode()``."""
        (name,), (out,) = self.conf.inputs, self.conf.outputs

        def fn(params, states, x):
            with torch.inference_mode():
                env, _ = self._forward(params, states, {name: x}, training)
            return env[out]

        return fn

    def output(self, *xs, train=False) -> list:
        """output(x1, x2, ...): one ``INDArray`` per configured output."""
        self._check_init()
        inputs = {n: self._input(x) for n, x in zip(self.conf.inputs, xs)}
        with torch.inference_mode():
            env, _ = self._forward(self._params, self._states, inputs, train)
        return [INDArray(env[o]) for o in self.conf.outputs]

    def outputSingle(self, *xs, train=False) -> INDArray:
        return self.output(*xs, train=train)[0]

    # -- loss and gradients --------------------------------------------------
    def _loss_from(self, params, states, inputs, labels: dict, training,
                   generator, masks: dict | None = None):
        """The output layers' fused losses, summed, plus L1/L2 on every
        parameter."""
        env, new_states = self._forward(params, states, inputs, training,
                                        generator, stop_before_output=True)
        loss = 0.0
        for out in self.conf.outputs:
            node, _ = self.conf.nodes[out]
            mask = None if masks is None else masks.get(out)
            if training and getattr(node, "LOSS_UPDATES_STATE", False):
                term, new_states[out] = node.compute_loss_with_state(
                    params[out], env[out], labels[out], mask, states[out])
            else:
                term = node.compute_loss(params[out], env[out], labels[out],
                                         mask)
            loss = loss + term
        for name, (node, _) in self.conf.nodes.items():
            leaves = tree_leaves(params.get(name))
            if not leaves:
                continue
            l2 = getattr(node, "l2", None) or 0.0
            l1 = getattr(node, "l1", None) or 0.0
            if l2:
                loss = loss + 0.5 * l2 * sum((w * w).sum() for w in leaves)
            if l1:
                # |w| with the JAX package's subgradient at 0 (1, where
                # torch's abs takes 0)
                loss = loss + l1 * sum(torch.where(w >= 0, w, -w).sum()
                                       for w in leaves)
        return loss, new_states

    def _value_and_grad(self, states, inputs, labels, masks, training,
                        generator):
        """(loss, new_states, {node: gradients}) at the current params; a
        parameter the loss does not reach gets a zero gradient."""
        leaves = {name: tree_map(lambda v: v.detach().requires_grad_(), p)
                  for name, p in self._params.items()}
        loss, new_states = self._loss_from(leaves, states, inputs, labels,
                                           training, generator, masks)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True) \
            if flat else ()
        grads = (torch.zeros_like(v) if g is None else g
                 for v, g in zip(flat, grads))
        return (loss.detach(), tree_map(torch.Tensor.detach, new_states),
                tree_fill(leaves, grads))

    def _dropout_generator(self, it):
        """The step's dropout generator, seeded from conf.seed + 1 and the
        iteration; None when no layer drops out."""
        if not any(isinstance(node, BaseLayer) and node.dropOut
                   and node.dropOut < 1.0
                   for node, _ in self.conf.nodes.values()):
            return None
        return _dropout_generator(self.conf.seed, it, self.device)

    def _step(self, states, inputs, labels, masks):
        """One optimizer step on device feeds; returns (loss, states).
        The params and the updater state are updated in place."""
        it = self._iteration
        loss, new_states, grads = self._value_and_grad(
            states, inputs, labels, masks, True, self._dropout_generator(it))
        with torch.no_grad():
            for name, (node, _) in self.conf.nodes.items():
                if not self._params[name]:
                    continue
                g = _normalize_grads(
                    grads[name], getattr(node, "gradientNormalization", None),
                    getattr(node, "gradientNormalizationThreshold", None)
                    or 1.0)
                upd, self._opt_states[name] = self._updater(name).apply_mixed(
                    g, self._opt_states[name], self._params[name], it)
                for p, u in zip(tree_leaves(self._params[name]),
                                tree_leaves(upd)):
                    p.sub_(u)
        self._iteration += 1
        return loss, new_states

    # -- training ------------------------------------------------------------
    def _feeds(self, ds, with_ones_masks=False):
        """Host-side (inputs, labels, label masks) dicts by name."""
        feats, labels, _, lmasks = _split_dataset_full(ds)
        inputs = {n: _host_array(f) for n, f in zip(self.conf.inputs, feats)}
        lab = {n: _host_array(l) for n, l in zip(self.conf.outputs, labels)}
        masks = {}
        for n, m in zip(self.conf.outputs, lmasks):
            if m is not None:
                masks[n] = _host_array(m, np.float32)
            elif with_ones_masks:
                masks[n] = _ones_mask(lab[n])
        return inputs, lab, masks

    def _device_feeds(self, inputs, labels, masks):
        return ({k: self._input(v) for k, v in inputs.items()},
                {k: self._input(v) for k, v in labels.items()},
                {k: torch.as_tensor(v, device=self.device)
                 for k, v in masks.items()})

    def fit(self, data, epochs: int = 1):
        """fit(iterator[, epochs]) / fit(DataSet) / fit(MultiDataSet) /
        fit((inputs, labels)). Every batch trains with explicit label
        masks; a ragged batch is padded to the largest batch seen (its
        last row repeated) with mask 0 on the padding rows. Each step's
        layer states are kept, the recurrent nodes' carried state
        dropped."""
        self._check_init()
        last = None
        for epoch_i in range(epochs):
            batches, data = _prepare_batches(data, epoch_i, epochs)
            for ds in batches:
                inputs, labels, masks = self._feeds(ds, with_ones_masks=True)
                n = next(iter(inputs.values())).shape[0]
                if self._bucket is None or n > self._bucket:
                    self._bucket = n
                if n < self._bucket:
                    for k in inputs:
                        (inputs[k],), _, _ = _pad_to_bucket(
                            [inputs[k]], np.ones((n,), np.float32),
                            self._bucket)
                    for k in labels:
                        (labels[k],), masks[k], _ = _pad_to_bucket(
                            [labels[k]], masks[k], self._bucket)
                tbptt = (self.conf.backpropType == BackpropType.TruncatedBPTT
                         and self.conf.tbpttLength
                         and any(v.ndim == 3
                                 and v.shape[2] > self.conf.tbpttLength
                                 for v in inputs.values()))
                if tbptt:
                    last = self._fit_tbptt(inputs, labels, masks)
                else:
                    last, states = self._step(
                        self._states,
                        *self._device_feeds(inputs, labels, masks))
                    self._states = self._strip_rnn_states(states)
            self._epoch += 1
        if last is not None:
            self._score = float(last)
        return self

    def fitMultiBatch(self, features_k, labels_k, repeats: int = 1):
        raise NotImplementedError(
            "fitMultiBatch comes with ROADMAP.md queue 1 item 12")

    def setListeners(self, *listeners):
        raise NotImplementedError(
            "listeners come with ROADMAP.md queue 1 item 13")

    # -- TBPTT and streaming state -------------------------------------------
    def _recurrent_nodes(self, forbid_bidirectional=False):
        """The nodes that carry streaming state: recurrent layers and
        wrappers of one; a Bidirectional node carries none, and with
        ``forbid_bidirectional`` (rnnTimeStep, TBPTT) raises."""
        out = []
        for name, (node, _) in self.conf.nodes.items():
            if isinstance(node, Bidirectional):
                if forbid_bidirectional:
                    raise ValueError(
                        f"node {name!r} is Bidirectional: streaming "
                        f"rnnTimeStep/TBPTT cannot carry state through a "
                        f"layer that consumes the whole sequence")
                continue
            if getattr(node, "IS_RECURRENT", False) or getattr(
                    getattr(node, "rnn", None), "IS_RECURRENT", False):
                out.append(name)
        return out

    def _seed_rnn_states(self, states, batch_size):
        out = dict(states)
        for name in self._recurrent_nodes():
            node, _ = self.conf.nodes[name]
            target = node if getattr(node, "IS_RECURRENT", False) \
                else node.rnn
            out[name] = target.streaming_state(batch_size, self.conf.dtype,
                                               self.device)
        return out

    def _strip_rnn_states(self, states):
        out = dict(states)
        for name in self._recurrent_nodes():
            out[name] = {}
        return out

    def _fit_tbptt(self, inputs, labels, masks):
        """Truncated BPTT: each segment of tbpttLength steps is one
        optimizer step; the recurrent state carries across segments,
        detached, and resets at the next minibatch. A short tail segment
        is zero-padded and masked out of the loss."""
        seg = self.conf.tbpttLength
        t_len = max(v.shape[2] for v in inputs.values() if v.ndim == 3)
        n = next(iter(inputs.values())).shape[0]
        self._recurrent_nodes(forbid_bidirectional=True)
        states = self._seed_rnn_states(self._states, n)

        def pad_time(v, pad, axis):
            width = list(v.shape)
            width[axis] = pad
            return np.concatenate([v, np.zeros(width, v.dtype)], axis=axis)

        loss = None
        for t0 in range(0, t_len, seg):
            ic = {k: v[:, :, t0:t0 + seg] if v.ndim == 3 else v
                  for k, v in inputs.items()}
            lc = {k: v[:, :, t0:t0 + seg] if v.ndim == 3 else v
                  for k, v in labels.items()}
            mc = {k: v[:, t0:t0 + seg] if v.ndim == 2 else v
                  for k, v in masks.items()}
            pad = seg - min(seg, t_len - t0)
            if pad:
                ic = {k: pad_time(v, pad, 2) if v.ndim == 3 else v
                      for k, v in ic.items()}
                lc = {k: pad_time(v, pad, 2) if v.ndim == 3 else v
                      for k, v in lc.items()}
                mc = {k: pad_time(v, pad, 1) if v.ndim == 2 else v
                      for k, v in mc.items()}
            loss, states = self._step(states,
                                      *self._device_feeds(ic, lc, mc))
        self._states = self._strip_rnn_states(states)
        return loss

    def rnnTimeStep(self, *xs):
        """Streaming inference with carried recurrent state; each x is
        [N, C] (one timestep) or [N, C, T] (a chunk). Successive calls
        continue the sequence; rnnClearPreviousState() resets."""
        self._check_init()
        arrs = [self._input(x) for x in xs]
        single = arrs[0].dim() == 2
        if single:
            arrs = [a[:, :, None] for a in arrs]
        n = arrs[0].shape[0]
        rec = set(self._recurrent_nodes(forbid_bidirectional=True))
        if self._stream_states is None or self._stream_batch != n:
            seeded = self._seed_rnn_states(self._states, n)
            self._stream_states = {k: seeded[k] for k in rec}
            self._stream_batch = n
        states = {k: (self._stream_states[k] if k in rec else v)
                  for k, v in self._states.items()}
        with torch.inference_mode():
            env, new_states = self._forward(
                self._params, states, dict(zip(self.conf.inputs, arrs)))
        self._stream_states = {k: new_states[k] for k in rec}
        outs = [INDArray(y[:, :, 0] if single and y.dim() == 3 else y)
                for y in (env[o] for o in self.conf.outputs)]
        return outs[0] if len(outs) == 1 else outs

    def rnnClearPreviousState(self):
        self._stream_states = None
        self._stream_batch = None

    # -- scoring -------------------------------------------------------------
    def score(self, dataset=None) -> float:
        self._check_init()
        if dataset is None:
            if self._score is None:
                raise ValueError("no score yet")
            return self._score
        inputs, labels, masks = self._device_feeds(*self._feeds(dataset))
        with torch.no_grad():
            loss, _ = self._loss_from(self._params, self._states, inputs,
                                      labels, False, None, masks)
        return float(loss)

    def evaluate(self, iterator, numClasses=None) -> Evaluation:
        """The first output scored over ``iterator``; a ragged batch is
        padded up to the largest batch seen (``pad_rows``) and the padding
        sliced off the output."""
        self._check_init()
        ev = Evaluation(numClasses)
        bucket = None
        for ds in _as_batches(iterator):
            feats, labels, _, lmasks = _split_dataset_full(ds)
            fs = [_host_array(f) for f in feats]
            n = fs[0].shape[0]
            if bucket is None or n > bucket:
                bucket = n
            out = self.output(*[pad_rows(f, bucket) for f in fs])[0]
            ev.eval(labels[0], out.toNumpy()[:n], mask=lmasks[0])
        return ev

    def gradients(self, inputs_and_labels) -> dict:
        """{node: {name: gradient}} of the loss (inference mode: no
        dropout, running statistics), ``{}`` for a vertex."""
        self._check_init()
        return self._value_and_grad(
            self._states, *self._device_feeds(*self._feeds(
                inputs_and_labels)), False, None)[2]

    # -- params --------------------------------------------------------------
    def numParams(self) -> int:
        return sum(v.numel() for v in tree_leaves(self._params))

    def params(self) -> INDArray:
        """Flat parameter vector: nodes in topological order, each node's
        params by sorted name (the JAX package's order); a copy."""
        self._check_init()
        leaves = [v.reshape(-1) for name in self.conf.topo_order
                  for v in tree_leaves(self._params[name])]
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
            for name in self.conf.topo_order:
                for v in tree_leaves(self._params[name]):
                    v.copy_(flat[off:off + v.numel()].reshape(v.shape))
                    off += v.numel()

    def getParam(self, node: str, name: str) -> INDArray:
        """A copy of one parameter."""
        return INDArray(self._params[node][name].clone())

    def getIterationCount(self):
        return self._iteration

    def getEpochCount(self):
        return self._epoch

    def summary(self) -> str:
        """One line a node: name, type, parameter count and inputs."""
        lines = [f"{'name':<24}{'type':<26}{'nParams':<10}{'inputs'}"]
        for name in self.conf.topo_order:
            node, ins = self.conf.nodes[name]
            n = sum(v.numel() for v in tree_leaves(self._params.get(name)))
            lines.append(f"{name:<24}{type(node).__name__:<26}{n:<10}{ins}")
        lines.append(f"Total params: {self.numParams()}")
        return "\n".join(lines)

