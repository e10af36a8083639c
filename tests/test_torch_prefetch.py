"""AsyncDataSetIterator, DevicePrefetcher and fit's prefetch path in the
port, against the JAX package's.

- ``AsyncDataSetIterator`` gives the base iterator's batches, and refuses
  a reset over a wedged producer, as the JAX package's does.
- ``DevicePrefetcher`` on the CPU (named; the card is its default) keeps
  the base's order and values bit for bit, in fresh buffers; backpressure,
  reset, errors, ``deviceTransform``, ``takeMulti`` and ``close`` as in the
  JAX package.
- ``MultiLayerNetwork.fit`` wraps a plain iterator in a prefetcher (not
  under TBPTT, not at ``set_default_depth(0)``), and its params after the
  fit equal the blocking path's bit for bit, and the JAX package's fit
  (which prefetches too) within 1e-4 of each array's largest element
  (float32, the other order of sums of a different library).
- ``ComputationGraph.fit`` over a prefetcher takes the staged tensors to
  the step as they are and gives the blocking path's params bit for bit.

``cuda``-marked cases (skipped without a card) stage on the side stream:
the staged batch equals the host batch, the stream is not the
consumer's, the pinned buffers are reused only after their copies, and
fit on the card gives the blocking path's params bit for bit.
"""

import threading
import time

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.datasets as jds
import deeplearning4j_tpu_torch.datasets as pds
from deeplearning4j_tpu import nn as jax_nn
from deeplearning4j_tpu.optimize import updaters as jax_updaters
from deeplearning4j_tpu_torch import nn as port_nn
from deeplearning4j_tpu_torch.datasets import prefetch
from deeplearning4j_tpu_torch.nn import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import updaters as port_updaters
from deeplearning4j_tpu_torch.tree_util import tree_leaves

from torch_parity import TRAIN_RTOL, compare_trees, net_pair

JOIN = 5.0   # seconds any wait in these tests may take


@pytest.fixture
def depth():
    """Restores the default prefetch depth after a test."""
    before = prefetch.default_depth()
    yield prefetch.set_default_depth
    prefetch.set_default_depth(before)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _data(n=20, cols=4, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, cols)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def _bytes(it):
    out = []
    while it.hasNext():
        ds = it.next()
        out.append([np.asarray(a.cpu() if isinstance(a, torch.Tensor)
                               else a).tobytes()
                    for a in (ds.getFeatures(), ds.getLabels())])
    return out


# -- AsyncDataSetIterator -----------------------------------------------------

def test_async_iterator_gives_the_base_batches_as_the_reference():
    x, y = _data(22)
    out = {}
    for name, pkg in (("jax", jds), ("torch", pds)):
        it = pkg.AsyncDataSetIterator(
            pkg.ListDataSetIterator(pkg.DataSet(x, y), 5), queue_size=2,
            join_timeout=JOIN)
        first = _bytes(it)
        it.reset()
        out[name] = (first, _bytes(it), [b.numExamples() for b in it])
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == out["torch"][1]
    assert out["torch"][2] == [5, 5, 5, 5, 2]


def test_async_reset_refuses_a_wedged_producer(monkeypatch):
    x, y = _data(8)
    it = pds.AsyncDataSetIterator(pds.ListDataSetIterator(pds.DataSet(x, y),
                                                          4), 2)
    list(it)
    release = threading.Event()
    wedged = threading.Thread(target=release.wait, daemon=True)
    wedged.start()
    it._thread = wedged
    monkeypatch.setattr(pds.AsyncDataSetIterator, "_JOIN_TIMEOUT", 0.05)
    try:
        with pytest.raises(RuntimeError, match="wedged"):
            it.reset()
    finally:
        release.set()
        wedged.join(JOIN)
    assert not wedged.is_alive()


@pytest.mark.parametrize("bad", [0, -1.0, float("inf"), float("nan")])
def test_async_join_timeout_must_be_positive_finite(bad):
    x, y = _data(4)
    base = {k: pkg.ListDataSetIterator(pkg.DataSet(x, y), 2)
            for k, pkg in (("jax", jds), ("torch", pds))}
    for k, pkg in (("jax", jds), ("torch", pds)):
        with pytest.raises(ValueError, match="positive finite"):
            pkg.AsyncDataSetIterator(base[k], 2, join_timeout=bad)


def test_async_env_join_timeout_is_validated(monkeypatch):
    x, y = _data(8)
    it = pds.AsyncDataSetIterator(pds.ListDataSetIterator(pds.DataSet(x, y),
                                                          4), 2)
    it.next()
    release = threading.Event()
    wedged = threading.Thread(target=release.wait, daemon=True)
    wedged.start()
    it._thread = wedged
    monkeypatch.setenv("DL4J_ASYNC_JOIN_TIMEOUT", "soon")
    try:
        with pytest.raises(ValueError, match="DL4J_ASYNC_JOIN_TIMEOUT"):
            it.reset()
    finally:
        release.set()
        wedged.join(JOIN)


# -- DevicePrefetcher on the CPU ---------------------------------------------

def test_prefetcher_needs_a_device_or_names_the_cpu():
    x, y = _data(4)
    base = pds.ListDataSetIterator(pds.DataSet(x, y), 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pds.DevicePrefetcher(base)
    p = pds.DevicePrefetcher(base, device="cpu")
    assert p.device.type == "cpu" and p._stream is None
    p.close()


@pytest.mark.parametrize("depth_n", [1, 2, 4])
def test_prefetcher_keeps_order_and_values_in_fresh_buffers(depth_n):
    x, y = _data(23)
    base = pds.ListDataSetIterator(pds.DataSet(x, y), 4)
    want = _bytes(base)
    p = pds.DevicePrefetcher(base, depth=depth_n, device="cpu")
    got = []
    while p.hasNext():
        ds = p.next()
        f = ds.getFeatures()
        assert isinstance(f, torch.Tensor) and f.device.type == "cpu"
        # a fresh buffer: not a view of the base's numpy batch
        assert not np.shares_memory(f.numpy(), x)
        got.append([f.numpy().tobytes(), ds.getLabels().numpy().tobytes()])
    assert got == want
    p.reset()
    assert _bytes(p) == want
    p.close()
    assert not p.hasNext()
    with pytest.raises(StopIteration):
        p.next()


def test_prefetcher_backpressure_bounds_the_producer():
    pulled = []

    class Counting(pds.ListDataSetIterator):
        def _next_batch(self):
            ds = super()._next_batch()
            if ds is not None:
                pulled.append(1)
            return ds

    x, y = _data(40)
    p = pds.DevicePrefetcher(Counting(pds.DataSet(x, y), 2), depth=2,
                             device="cpu")
    p.hasNext()
    deadline = time.monotonic() + JOIN
    while len(pulled) < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)
    # depth queued + one peeked + one blocked in put() at most
    assert len(pulled) <= 2 + 2
    p.close()
    assert p._thread is None


def test_prefetcher_surfaces_base_errors():
    class Broken(pds.ListDataSetIterator):
        def _next_batch(self):
            if self._pos == 2:
                raise ValueError("boom at batch 2")
            return super()._next_batch()

    x, y = _data(20)
    p = pds.DevicePrefetcher(Broken(pds.DataSet(x, y), 4), device="cpu")
    p.next()
    p.next()
    with pytest.raises(ValueError, match="boom at batch 2"):
        p.next()
    p.close()


def test_prefetcher_device_transform_prepare_and_take_multi():
    x = np.random.default_rng(1).integers(0, 256, (12, 3, 2, 2),
                                          np.uint8)
    y = np.eye(2, dtype=np.float32)[np.arange(12) % 2]
    base = pds.ListDataSetIterator(pds.DataSet(x, y), 4)
    p = pds.DevicePrefetcher(
        base, device="cpu",
        deviceTransform=lambda f: f.to(torch.float32) * (1 / 255))
    got = [ds.getFeatures() for ds in p]
    assert all(g.dtype == torch.float32 for g in got)
    want = x.astype(np.float32) * np.float32(1 / 255)
    assert torch.cat(got).numpy().tobytes() == want.tobytes()
    p.reset()
    fk, lk = p.takeMulti(3)
    assert tuple(fk.shape) == (3, 4, 3, 2, 2) and tuple(lk.shape) == (3, 4, 2)
    assert p.takeMulti(1) is None
    p.close()

    def prepare(ds):
        f = ds.getFeatures().astype(np.float32)
        return pds.DeviceBatch(f, ds.getLabels(), np.ones(len(f),
                                                          np.float32),
                               bucket=4, real=len(f))

    p = pds.DevicePrefetcher(base, device="cpu", prepare=prepare,
                             deviceTransform=lambda f: f * 2)
    b = p.next()
    assert isinstance(b, pds.DeviceBatch) and b.bucket == 4
    assert b.features.numpy().tobytes() == (
        x[:4].astype(np.float32) * 2).tobytes()
    assert b.mask.dtype == torch.float32
    p.close()


def test_prefetcher_delegates_to_the_base():
    x, y = _data(10)
    base = pds.ListDataSetIterator(pds.DataSet(x, y), 4)
    p = pds.DevicePrefetcher(base, device="cpu")
    p.setPreProcessor(pds.ImagePreProcessingScaler(maxPixelVal=2.0))
    assert base.getPreProcessor() is not None
    ds = p.next()
    assert ds.getFeatures().numpy().tobytes() == (x[:4] / np.float32(
        2.0)).astype(np.float32).tobytes()
    assert p.batch() == 4 and p.resetSupported()
    p.close()


def test_prefetcher_claims_its_staged_bytes_when_telemetry_is_on():
    from deeplearning4j_tpu_torch import telemetry
    from deeplearning4j_tpu_torch.telemetry import memledger

    x, y = _data(8)
    was = telemetry.enabled()
    telemetry.enable()
    try:
        p = pds.DevicePrefetcher(pds.ListDataSetIterator(pds.DataSet(x, y),
                                                         4),
                                 depth=2, loop="t_claim", device="cpu")
        p.next()
        claim = p._mem_claim
        assert claim is not None and claim.category == "prefetch"
        assert claim.bytes == (4 * 4 + 4 * 3) * 4 * 3
        p.close()
        assert p._mem_claim is None
    finally:
        (telemetry.enable if was else telemetry.disable)()
        memledger.release("prefetch", "t_claim")


# -- fit --------------------------------------------------------------------

def _dense_conf(nn, U, seed=3):
    return (nn.NeuralNetConfiguration.Builder().seed(seed)
            .updater(U.Adam(1e-2)).list()
            .layer(nn.DenseLayer.Builder().nIn(4).nOut(8)
                   .activation("relu").build())
            .layer(nn.OutputLayer.Builder().nIn(8).nOut(3)
                   .activation("softmax").lossFunction("mcxent").build())
            .build())


def _fit_pair(depth_n, depth, epochs=2, n=22, batch=5):
    """(port net, JAX net) each fitted over a ListDataSetIterator with a
    ragged last batch, at prefetch depth ``depth_n`` in both packages."""
    from deeplearning4j_tpu.datasets import prefetch as jax_prefetch

    port, jnet = net_pair(_dense_conf(jax_nn, jax_updaters))
    x, y = _data(n)
    before = jax_prefetch.default_depth()
    depth(depth_n)
    jax_prefetch.set_default_depth(depth_n)
    try:
        port.fit(pds.ListDataSetIterator(pds.DataSet(x, y), batch), epochs)
        jnet.fit(jds.ListDataSetIterator(jds.DataSet(x, y), batch), epochs)
    finally:
        jax_prefetch.set_default_depth(before)
    return port, jnet


def _leaf_bytes(net):
    return [v.numpy().tobytes() for v in tree_leaves(
        [net._params, net._opt_states])]


def test_fit_with_prefetch_equals_blocking_and_the_reference(depth):
    port_pf, jnet = _fit_pair(2, depth)
    port_bl, _ = _fit_pair(0, depth)
    assert _leaf_bytes(port_pf) == _leaf_bytes(port_bl)
    assert port_pf.score() == port_bl.score()
    assert port_pf._iteration == port_bl._iteration == 10
    compare_trees(port_pf._params, jnet._params, TRAIN_RTOL, "params")
    compare_trees(port_pf._opt_states, jnet._opt_states, TRAIN_RTOL,
                  "updater")


def test_fit_wraps_plain_iterators_only(depth, monkeypatch):
    made = []
    wrap = MultiLayerNetwork._wrap_prefetch

    def spy(self, data):
        out = wrap(self, data)
        if out[1] is not None:
            made.append(out[1])
        return out

    monkeypatch.setattr(MultiLayerNetwork, "_wrap_prefetch", spy)
    net = MultiLayerNetwork(_dense_conf(port_nn, port_updaters),
                            device="cpu").init()
    x, y = _data(10)
    it = pds.ListDataSetIterator(pds.DataSet(x, y), 5)
    depth(2)
    net.fit(it)
    assert len(made) == 1 and made[0]._closed
    assert made[0].device == net.device and made[0]._loop == "fit"
    net.fit(pds.DataSet(x, y))
    net.fit(x, y)
    own = pds.DevicePrefetcher(it, device="cpu")
    net.fit(own)
    assert len(made) == 1   # a prefetcher passed in is not wrapped again
    own.close()
    depth(0)
    net.fit(it)
    assert len(made) == 1


def test_fit_does_not_wrap_under_tbptt(depth):
    nn = port_nn
    conf = (nn.NeuralNetConfiguration.Builder().seed(1)
            .updater(port_updaters.Sgd(0.1)).list()
            .layer(nn.LSTM.Builder().nIn(3).nOut(4).build())
            .layer(nn.RnnOutputLayer.Builder().nIn(4).nOut(2)
                   .activation("softmax").lossFunction("mcxent").build())
            .tBPTTLength(3).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    data, wrapped = net._wrap_prefetch(pds.ListDataSetIterator([], 2))
    assert wrapped is None
    depth(2)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 3, 7)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (4, 7))].transpose(
        0, 2, 1).copy()
    net.fit(pds.ListDataSetIterator(pds.DataSet(x, y), 2))
    assert net._iteration == 2 * 3


def test_fit_casts_float64_batches_as_the_blocking_path(depth):
    x, y = _data(12)
    nets = []
    for d in (2, 0):
        depth(d)
        net = MultiLayerNetwork(_dense_conf(port_nn, port_updaters),
                                device="cpu").init()
        net.fit(pds.ListDataSetIterator(
            pds.DataSet(x.astype(np.float64), y.astype(np.float64)), 4))
        nets.append(net)
    assert _leaf_bytes(nets[0]) == _leaf_bytes(nets[1])


def test_fit_pads_a_batch_staged_against_a_smaller_bucket():
    net, twin = (MultiLayerNetwork(_dense_conf(port_nn, port_updaters),
                                   device="cpu").init() for _ in range(2))
    assert _leaf_bytes(net) == _leaf_bytes(twin)   # one seed
    x, y = _data(8)
    net._bucket = twin._bucket = 8
    staged = pds.DeviceBatch(torch.tensor(x[:3]), torch.tensor(y[:3]),
                             torch.ones(3), bucket=3, real=3)
    net.fit([staged])   # a list: fit wraps nothing
    twin.fit(pds.DataSet(x[:3], y[:3]))
    assert net._bucket == 8
    assert _leaf_bytes(net) == _leaf_bytes(twin)


# -- ComputationGraph.fit over a prefetcher ---------------------------------

def _graph(seed=4):
    nn = port_nn
    conf = (nn.NeuralNetConfiguration.Builder().seed(seed)
            .updater(port_updaters.Adam(1e-2)).graphBuilder()
            .addInputs("x").setInputTypes(nn.InputType.feedForward(4))
            .addLayer("d", nn.DenseLayer.Builder().nOut(8)
                      .activation("tanh").build(), "x")
            .addLayer("out", nn.OutputLayer.Builder().nOut(3)
                      .activation("softmax").lossFunction("mcxent")
                      .build(), "d")
            .setOutputs("out").build())
    return ComputationGraph(conf, device="cpu").init()


def test_graph_fit_over_a_prefetcher_equals_the_blocking_path(monkeypatch):
    x, y = _data(22)
    g_pf, g_bl = _graph(), _graph()   # one seed: the same params
    seen = []
    step = ComputationGraph._step

    def spy(self, states, inputs, labels, masks):
        seen.append((inputs["x"], labels["out"]))
        return step(self, states, inputs, labels, masks)

    p = pds.DevicePrefetcher(pds.ListDataSetIterator(pds.DataSet(x, y), 5),
                             device="cpu")
    staged = []
    take = p._take

    def record():
        item = take()
        if item is not None:
            staged.append(item)
        return item

    p._take = record
    monkeypatch.setattr(ComputationGraph, "_step", spy)
    g_pf.fit(p, epochs=2)
    p.close()
    n_pf = len(seen)
    monkeypatch.setattr(ComputationGraph, "_step", step)
    g_bl.fit(pds.ListDataSetIterator(pds.DataSet(x, y), 5), epochs=2)
    assert n_pf == 10
    # the staged tensors reach the step as they are (the ragged last
    # batch is padded, on the device, to the bucket)
    assert len(staged) == n_pf
    for (f, l), s in zip(seen, staged):
        if s.getFeatures().shape[0] == 5:
            assert f is s.getFeatures() and l is s.getLabels()
        else:
            assert f.shape[0] == 5
    assert [v.numpy().tobytes() for v in tree_leaves(
        [g_pf._params, g_pf._opt_states])] == [
        v.numpy().tobytes() for v in tree_leaves(
            [g_bl._params, g_bl._opt_states])]


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_side_stream_stages_host_values(cuda):
    x = np.random.default_rng(5).integers(0, 256, (32, 3, 8, 8), np.uint8)
    y = np.eye(4, dtype=np.float32)[np.arange(32) % 4]
    p = pds.DevicePrefetcher(
        pds.ListDataSetIterator(pds.DataSet(x, y), 8), depth=2, device=cuda,
        deviceTransform=lambda f: f.float().mul_(1 / 255))
    got = [ds.getFeatures() for ds in p]
    assert p._stream is not None
    assert p._stream.cuda_stream != \
        torch.cuda.current_stream(cuda).cuda_stream
    assert all(g.device == cuda for g in got)
    want = x.astype(np.float32) * np.float32(1 / 255)
    assert torch.cat(got).cpu().numpy().tobytes() == want.tobytes()
    p.close()


@pytest.mark.cuda
def test_pinned_buffers_are_reused_only_after_their_copy(cuda):
    pool = prefetch._PinnedBuffers(limit=2)
    side = torch.cuda.Stream(device=cuda)
    a = pool.take((1024,), torch.float32)
    b = pool.take((1024,), torch.float32)
    assert a[0].data_ptr() != b[0].data_ptr()   # a is busy
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)          # keeps the copy in flight
        a[0].to(cuda, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(side)
    pool.ready([a], ev)
    pool.ready([b], None)
    c = pool.take((1024,), torch.float32)
    assert c is b                                # b's copy is done
    d = pool.take((1024,), torch.float32)        # waits for a's copy
    assert d is a and ev.query()
    assert a[0].is_pinned()


@pytest.mark.cuda
def test_fit_on_the_card_with_prefetch_equals_blocking(cuda, depth):
    x, y = _data(40)
    nets = []
    for d in (2, 0):
        depth(d)
        net = MultiLayerNetwork(_dense_conf(port_nn, port_updaters),
                                device=cuda).init()   # one seed
        net.fit(pds.ListDataSetIterator(pds.DataSet(x, y), 8), 2)
        nets.append(net)
    assert [v.cpu().numpy().tobytes() for v in tree_leaves(
        nets[0]._params)] == [v.cpu().numpy().tobytes()
                              for v in tree_leaves(nets[1]._params)]


@pytest.mark.cuda
def test_graph_fit_on_the_card_over_a_prefetcher(cuda):
    x, y = _data(20)
    g, twin = (ComputationGraph(_graph().conf, device=cuda).init()
               for _ in range(2))   # one seed: the same params
    p = pds.DevicePrefetcher(pds.ListDataSetIterator(pds.DataSet(x, y), 5),
                             device=cuda)
    g.fit(p)
    p.close()
    twin.fit(pds.ListDataSetIterator(pds.DataSet(x, y), 5))
    assert [v.cpu().numpy().tobytes() for v in tree_leaves(g._params)] == \
        [v.cpu().numpy().tobytes() for v in tree_leaves(twin._params)]
