"""Sharded training: the data-parallel trainer and the reference's facades.

Counterpart of ``deeplearning4j_tpu/parallel/trainer.py``, with its names:
``ShardedTrainer`` (``place_params``, ``fit`` over DataSets, iterators and
the ``DevicePrefetcher``, an uneven batch padded), ``ParallelWrapper``,
``ParallelInference``, ``ParameterAveragingTrainingMaster``,
``SharedTrainingMaster`` and ``SparkDl4jMultiLayer``, with the reference's
one-time ``_warn_noop_knob`` notices.

The reference compiles one GSPMD step over the mesh: the batch sharded over
``data``, params replicated or laid out by ``param_specs``, the gradient
psum inside the step. The port's step is ``MultiLayerNetwork._step`` (the
forward, ``torch.autograd.grad``, the updater, the loss-scaler gate):

- **One process.** The batch is padded up to a multiple of the ``data``
  size by repeating its last row (``_pad_batch``), the padding rows get
  mask 0, and the network's own step runs over the whole batch on the
  mesh's first device. ``param_specs`` place nothing (their structure is
  checked against the params). With no padding the result is bitwise
  ``net.fit``'s from the same state.
- **Several ranks.** Each rank takes its shard of the padded global batch
  (``mesh.global_batch``, or its own rows as they are from a
  ``hostSharded`` iterator), computes its step's gradients, weighs them by
  its share of the global mask (c_r / sum c: the global batch's masked
  mean, padding rows weighed out as ``_pad_batch`` does) and sums them
  with one all-reduce, which also carries the weighted loss; every rank
  then applies the same update. The weights sum to one, so L1/L2 count
  once. The layer states' floating leaves (BatchNormalization's running
  statistics) are averaged over the ranks after each step, so the ranks
  stay equal; a step's batch statistics are each rank's own shard's (no
  synchronised batch norm), and a MoE layer's aux loss is each rank's
  weighed the same way. ``place_params`` broadcasts rank 0's params,
  layer states and updater state. At world size 1 (NCCL on the one card)
  the weights are 1 exactly and the step is bitwise the one-process step.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.samediff import (
    _host_array, _ones_mask, _prepare_batches, _split_dataset_full)
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator
from deeplearning4j_tpu_torch.datasets.prefetch import (
    DeviceBatch, DevicePrefetcher, default_depth)
from deeplearning4j_tpu_torch.parallel import transport
from deeplearning4j_tpu_torch.parallel.mesh import (
    DATA_AXIS, SEQ_AXIS, MeshConfig, local_block, spec_for)
from deeplearning4j_tpu_torch.precision.monitor import monitor_for
from deeplearning4j_tpu_torch.tree_util import (
    tree_fill, tree_leaves, tree_map)


def _pad_batch(arr, multiple):
    """Pad the batch axis up to a multiple by repeating the last row, and
    return (padded, real_count). The loss weighting uses real_count so
    padding rows do not bias gradients."""
    n = arr.shape[0]
    rem = n % multiple
    if rem == 0:
        return arr, n
    pad = multiple - rem
    if isinstance(arr, torch.Tensor):   # a batch staged on its device
        return torch.cat([arr, arr[-1:].expand(pad, *arr.shape[1:])]), n
    reps = np.repeat(arr[-1:], pad, axis=0)
    return np.concatenate([arr, reps], axis=0), n


def _padded_mask(labels, lmask, real, n):
    """The label mask (the batch's own, or ones) of the padded batch of n
    rows, 0 on the padding rows."""
    if lmask is None:
        mask = _ones_mask(labels)
    else:
        given = _host_array(lmask, np.float32)
        mask = np.zeros((n,) + given.shape[1:], np.float32)
        mask[:real] = given[:real]
    mask[real:] = 0.0
    return mask


def _check_specs(specs, params):
    """``specs`` must have ``params``' structure, every leaf a tuple."""
    if isinstance(params, dict):
        if not isinstance(specs, dict) or set(specs) != set(params):
            raise ValueError(f"param_specs {specs!r} do not match the "
                             f"params {sorted(params)}")
        for k in params:
            _check_specs(specs[k], params[k])
    elif isinstance(params, (list, tuple)):
        if not isinstance(specs, (list, tuple)) or len(specs) != len(params):
            raise ValueError("param_specs do not match the params' layers")
        for sp, p in zip(specs, params):
            _check_specs(sp, p)
    elif not isinstance(specs, tuple) or len(specs) > params.dim():
        raise ValueError(f"spec {specs!r} for a {params.dim()}-d param")


class ShardedTrainer:
    """Data-parallel trainer around a MultiLayerNetwork.

    ``mesh``: by default every rank's device of the network, over
    ``data``. ``param_specs``: optional tree (the structure of
    ``net._params``) of specs for tensor parallelism; default replicated.
    """

    def __init__(self, net, mesh=None, param_specs=None):
        self.net = net
        self.mesh = mesh or MeshConfig.data_parallel(devices=[net.device])
        if self.mesh.spans_ranks(SEQ_AXIS):
            raise NotImplementedError(
                "a MultiLayerNetwork has no sequence-parallel step: a seq "
                "axis across ranks is for ring attention (BertTrainer, "
                "ROADMAP queue 1 item 12b)")
        if param_specs is not None:
            _check_specs(param_specs, net._params)
        self.param_specs = param_specs
        self._placed = False
        self._n_data = self.mesh.shape.get(DATA_AXIS, 1)
        # under a process group (world size 1 included) the step takes
        # the all-reduce path
        self._ranks = transport.group_active()

    def place_params(self):
        """The network's params, layer states, updater state and loss
        scaler state on the mesh's first device (nothing moves where they
        are already); across ranks rank 0's values broadcast to all."""
        net = self.net
        dev = self.mesh.device
        if net.device != dev:
            move = lambda t: t.to(dev)   # noqa: E731
            net._params = [tree_map(move, p) for p in net._params]
            net._states = [tree_map(move, st) for st in net._states]
            net._opt_states = [tree_map(move, o) if o else o
                               for o in net._opt_states]
            net._prec_state = tree_map(move, net._prec_state)
            net.device = dev
        if self._ranks:
            with torch.no_grad():
                for t in tree_leaves([net._params, net._states,
                                      net._opt_states, net._prec_state]):
                    if isinstance(t, torch.Tensor):
                        transport.broadcast(t, 0)
        self._placed = True

    def _prefetch_prepare(self):
        """Host-side batch prep (split, pad to a multiple of the data
        size, mask), run in the DevicePrefetcher's producer thread before
        its copy to the device."""

        def prepare(ds):
            feats, labels, _, lmasks = _split_dataset_full(ds)
            if len(feats) != 1 or len(labels) != 1:
                return ds
            f = _host_array(feats[0])
            l = _host_array(labels[0])
            f, real = _pad_batch(f, self._n_data)
            l, _ = _pad_batch(l, self._n_data)
            mask = _padded_mask(l, lmasks[0], real, l.shape[0])
            return DeviceBatch(f, l, mask, real=real)

        return prepare

    def _wrap_prefetch(self, data):
        if (not self._ranks
                and isinstance(data, DataSetIterator)
                and not isinstance(data, DevicePrefetcher)
                and data.asyncSupported()
                and default_depth() > 0):
            wrapped = DevicePrefetcher(
                data, prepare=self._prefetch_prepare(), loop="sharded",
                device=self.mesh.device)
            return wrapped, wrapped
        return data, None

    def _batch(self, ds, host_sharded):
        """(features, labels, mask) of this process's rows, on the
        device."""
        if isinstance(ds, DeviceBatch):
            return self.net._device_batch(ds.features, ds.labels, ds.mask)
        feats, labels, _, lmasks = _split_dataset_full(ds)
        f = _host_array(feats[0])
        l = _host_array(labels[0])
        f, real = _pad_batch(f, self._n_data)
        l, _ = _pad_batch(l, self._n_data)
        mask = _padded_mask(l, lmasks[0], real, l.shape[0])
        if self._ranks and not host_sharded:
            spec = spec_for(self.mesh, DATA_AXIS)
            f, l, mask = (local_block(self.mesh, a, spec)
                          for a in (f, l, mask))
        return self.net._device_batch(f, l, mask)

    def _reduce(self, mask):
        """The step's gradient hook across ranks: the gradients and the
        loss weighed by this rank's share of the global mask, then summed
        over the ranks in one all-reduce."""

        def reduce_grads(loss, grads):
            count = mask.sum().to(torch.float32).reshape(1)
            total = transport.all_reduce_sum(count.clone())
            w = count / total
            leaves = tree_leaves(grads)
            # summed in float32, or float64 for a float64 network
            acc = torch.promote_types(loss.dtype, torch.float32)
            flat = torch.cat([g.reshape(-1).to(acc) for g in leaves]
                             + [loss.reshape(1).to(acc)]) * w.to(acc)
            transport.all_reduce_sum(flat)
            out, i = [], 0
            for g in leaves:
                out.append(flat[i:i + g.numel()].reshape(g.shape).to(
                    g.dtype))
                i += g.numel()
            it = iter(out)
            grads = [tree_fill(lg, it) for lg in grads]
            return flat[-1].to(loss.dtype).reshape(loss.shape), grads

        return reduce_grads

    def _mean_states(self, states):
        """Floating layer-state leaves averaged over the ranks."""
        world = transport.world()[0]

        def mean(t):
            if not (isinstance(t, torch.Tensor) and t.is_floating_point()):
                return t
            return transport.all_reduce_sum(t.clone()) / world

        return [tree_map(mean, st) for st in states]

    def fit(self, data, epochs: int = 1):
        net = self.net
        net._check_init()
        if not self._placed:
            self.place_params()
        pm = monitor_for("sharded", net._policy)
        if pm is not None:
            pm.baseline_from(net._prec_state)
        data, prefetcher = self._wrap_prefetch(data)
        host_sharded = bool(getattr(data, "hostSharded", False))
        last = None
        try:
            for epoch_i in range(epochs):
                batches, data = _prepare_batches(data, epoch_i, epochs)
                for ds in batches:
                    f, l, mask = self._batch(ds, host_sharded)
                    it_used = net._iteration
                    last, states = net._step(
                        net._states, f, l, mask,
                        reduce_grads=self._reduce(mask) if self._ranks
                        else None)
                    states = net._strip_rnn_states(states)
                    if self._ranks:
                        states = self._mean_states(states)
                    net._states = states
                    if pm is not None:
                        pm.on_step(it_used, net._prec_state)
                net._epoch += 1
        finally:
            if prefetcher is not None:
                prefetcher.close()
        if pm is not None:
            pm.flush()
        if last is not None:
            net._score = float(last)
        return net


# ---------------------------------------------------------------------------
# facades with the reference's API shapes
# ---------------------------------------------------------------------------


_WARNED_KNOBS: set = set()


def _warn_noop_knob(knob, why):
    """One-time notice that a parity knob is accepted but has no effect
    here (silent no-ops surprise users)."""
    if knob in _WARNED_KNOBS:
        return
    _WARNED_KNOBS.add(knob)
    import warnings

    warnings.warn(f"{knob} is accepted for DL4J API parity but has no "
                  f"effect here: {why}", stacklevel=3)


def _workers_mesh(net, n):
    """A data mesh of n positions over the network's device (the
    one-process mesh repeats it), or over every rank's under a group."""
    if n is None:
        n = (torch.cuda.device_count() if net.device.type == "cuda" else 1)
    return MeshConfig(data=-1, devices=[net.device] * max(1, n)).build()


class ParallelWrapper:
    """Reference: org.deeplearning4j.parallelism.ParallelWrapper.Builder.
    workers() picks how many positions join the data axis;
    averaging/gradient-sharing knobs are accepted for API parity but the
    sync is always the exact all-reduce of every step."""

    class Builder:
        def __init__(self, net):
            self._net = net
            self._workers = None
            self._prefetch = 2

        def workers(self, n):
            self._workers = n
            return self

        def prefetchBuffer(self, n):
            self._prefetch = n
            return self

        def averagingFrequency(self, n):
            _warn_noop_knob("ParallelWrapper.averagingFrequency",
                            "gradients all-reduce exactly every step")
            return self

        def trainingMode(self, *_):
            return self

        def workspaceMode(self, *_):
            return self

        def build(self):
            return ParallelWrapper(self._net,
                                   _workers_mesh(self._net, self._workers),
                                   self._prefetch)

    def __init__(self, net, mesh, prefetch=2):
        self.net = net
        self.mesh = mesh
        self.prefetch = prefetch
        self._trainer = ShardedTrainer(net, mesh)

    def fit(self, iterator, epochs: int = 1):
        from deeplearning4j_tpu_torch.datasets.iterator import (
            AsyncDataSetIterator)

        data = iterator
        if isinstance(iterator, DataSetIterator) and self.prefetch > 0 \
                and iterator.asyncSupported():
            data = AsyncDataSetIterator(iterator, self.prefetch)
        self._trainer.fit(data, epochs)
        return self.net

    def shutdown(self):
        pass


class ParallelInference:
    """Reference: org.deeplearning4j.parallelism.ParallelInference —
    batched inference with the batch padded to the data axis."""

    class Builder:
        def __init__(self, net):
            self._net = net
            self._batch_limit = 32
            self._workers = None

        def inferenceMode(self, *_):
            return self

        def batchLimit(self, n):
            self._batch_limit = n
            return self

        def workers(self, n):
            self._workers = n
            return self

        def build(self):
            return ParallelInference(self._net, self._batch_limit,
                                     self._workers)

    def __init__(self, net, batch_limit=32, workers=None):
        self.net = net
        self.batch_limit = batch_limit
        self.mesh = _workers_mesh(net, workers)
        self._n_data = self.mesh.shape.get(DATA_AXIS, 1)

    def output(self, x):
        from deeplearning4j_tpu_torch.ndarray import INDArray

        xb, real = _pad_batch(_host_array(x), self._n_data)
        return INDArray(self.net.output(xb).torch()[:real])


class ParameterAveragingTrainingMaster:
    """Reference: dl4j-spark ParameterAveragingTrainingMaster.Builder —
    kept as a mesh-size configuration facade (averaging IS all-reduce when
    done every step)."""

    class Builder:
        def __init__(self, *_args):
            self._batch = 32

        def batchSizePerWorker(self, n):
            self._batch = n
            return self

        def averagingFrequency(self, n):
            _warn_noop_knob("TrainingMaster.averagingFrequency",
                            "averaging IS the all-reduce of every step")
            return self

        def workerPrefetchNumBatches(self, n):
            return self

        def build(self):
            return ParameterAveragingTrainingMaster(self._batch)

    def __init__(self, batch_per_worker=32):
        self.batch_per_worker = batch_per_worker


class SharedTrainingMaster(ParameterAveragingTrainingMaster):
    """Reference: gradient-sharing SharedTrainingMaster (threshold-
    compressed async updates). The compression knobs are accepted and
    ignored: a dense synchronous all-reduce replaces them."""

    class Builder(ParameterAveragingTrainingMaster.Builder):
        def thresholdAlgorithm(self, *_):
            _warn_noop_knob("SharedTrainingMaster.thresholdAlgorithm",
                            "a dense synchronous all-reduce replaces "
                            "threshold-compressed async updates")
            return self

        def residualPostProcessor(self, *_):
            return self

        def build(self):
            return SharedTrainingMaster(self._batch)


class SparkDl4jMultiLayer:
    """Reference: org.deeplearning4j.spark.impl.multilayer
    .SparkDl4jMultiLayer — the Spark master's role collapses to 'shard the
    batch over the mesh'; ``sc`` is accepted for signature parity."""

    def __init__(self, sc, net_or_conf, training_master=None):
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        if hasattr(net_or_conf, "layers") and not hasattr(net_or_conf,
                                                          "fit"):
            net = MultiLayerNetwork(net_or_conf)
            net.init()
        else:
            net = net_or_conf
        self.net = net
        self.training_master = training_master
        self._trainer = ShardedTrainer(net)

    def fit(self, data, epochs: int = 1):
        self._trainer.fit(data, epochs)
        return self.net

    def getNetwork(self):
        return self.net
