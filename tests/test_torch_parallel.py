"""The port's parallel tier against the JAX package's, in one process.

``tests/test_parallel.py`` case by case, the JAX package on its 8 virtual
CPU devices (``tests/conftest.py``), the port on meshes of
``["cpu"] * n``, plus what the port adds:

- the mesh config (auto data axis, mixed axes, bad sizes), the rank
  layout of a mesh, and a ``model`` axis across ranks refused (item 12b);
- ``ShardedTrainer``: data-parallel equal bitwise to ``net.fit`` from the
  same state and within the reference's rtol=2e-4, atol=1e-5 of its
  ``ShardedTrainer`` on the same mesh shape; the loss decreasing; a
  61-row batch padded to 64 with the padding masked out (within the same
  tolerance of ``net.fit`` on the 61 rows and of the reference); the
  tensor-parallel specs equal to the reference's and the TP run bitwise
  the replicated one; the prefetched iterator path and the loss-scaler
  path bitwise ``net.fit``'s; a process group of one (gloo) bitwise the
  one-process step;
- the facades (``ParallelWrapper``, ``ParallelInference``,
  ``SparkDl4jMultiLayer``, the training masters' parity warnings);
- ring attention, causal and not, against the reference's
  ``ring_attention`` on its seq=8 mesh and against dense attention
  (rtol=2e-4, atol=2e-5, the reference's), the degenerate mesh, and the
  ring's gradients against dense attention's in both packages to 1e-5 of
  each array's largest element (the reference marks its own gradient test
  slow: its shard_map gradient compiles for minutes; the port's runs here
  at B=2, H=4, T=16, D=8);
- ``fitMultiBatch`` (network and graph) bitwise K ``fit`` calls and within
  rtol=2e-4, atol=1e-5 of the reference's, ``takeMulti``'s stacks into it;
- ``BertTrainer`` with ``seq=4`` and with ``model=2`` against the
  reference's trainer on the same mesh shape (2 layers, hidden 64, T=32,
  dropout 0, float32): two steps' losses to 1e-5 relative and the params
  to 1e-3 of each array's largest element (``BERT_PARAM_RTOL``), no flash
  call under ``seq``;
- ``RuntimeConfig.cpu_mesh``'s virtual devices and ``MultiHost`` at one
  process;
- ``cuda`` cases: the ring on a mesh that repeats the card against dense
  attention and the CPU (output and gradients to 1e-5 of the largest
  element), and ``ShardedTrainer`` on the card bitwise ``net.fit``.
"""

import socket
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nn as J
from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.datasets import ListDataSetIterator as JList
from deeplearning4j_tpu.datasets import prefetch as jprefetch
from deeplearning4j_tpu.models import bert as jbert
from deeplearning4j_tpu.optimize import updaters as JU
from deeplearning4j_tpu.parallel import (
    MeshConfig as JMeshConfig, ShardedTrainer as JShardedTrainer,
    alternating_dense_specs as j_alternating, ring_attention as j_ring)
from deeplearning4j_tpu.parallel.ring_attention import (
    _dense_attention as j_dense)
from deeplearning4j_tpu_torch import parallel as tp
from deeplearning4j_tpu_torch.datasets import (
    DataSet, DevicePrefetcher, ListDataSetIterator)
from deeplearning4j_tpu_torch.models import bert as tbert
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel import multihost, trainer
from deeplearning4j_tpu_torch.parallel.ring_attention import (
    _dense_attention as t_dense)
from deeplearning4j_tpu_torch.utils.convert import bert_params_from_numpy
from torch_parity import close, compare_trees, graph_pair, net_pair, to_np

REF = dict(rtol=2e-4, atol=1e-5)        # tests/test_parallel.py's rule
RING = dict(rtol=2e-4, atol=2e-5)       # its ring-attention rule
GRAD_RTOL = 1e-5                        # of each gradient's largest


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _xy(n=64, fin=12, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, fin)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return X, y


def _conf(seed=5, updater=None, precision=None):
    b = J.NeuralNetConfiguration.Builder().seed(seed).updater(
        updater or JU.Sgd(0.1))
    if precision:
        b = b.precision(precision)
    return (b.list()
            .layer(J.DenseLayer.Builder().nIn(12).nOut(32)
                   .activation("relu").build())
            .layer(J.DenseLayer.Builder().nOut(32).activation("relu")
                   .build())
            .layer(J.OutputLayer.Builder().nOut(3).activation("softmax")
                   .lossFunction("mcxent").build())
            .build())


def _pair(seed=5, updater=None, precision=None):
    """(port net on the CPU, JAX net), the same weights."""
    return net_pair(_conf(seed, updater, precision), seed=seed)


def _cpu_mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return tp.MeshConfig(**axes, devices=["cpu"] * n).build()


def _jax_mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return JMeshConfig(**axes, devices=jax.devices()[:n]).build()


def _bits(net):
    return net.params().numpy().tobytes()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

class TestMeshConfig:
    def test_auto_data_axis(self):
        mesh = tp.MeshConfig.data_parallel(devices=["cpu"] * 8)
        assert mesh.shape == dict(JMeshConfig.data_parallel().shape) == {
            "data": 8}
        assert not mesh.multi_rank and mesh.coords("data") == list(range(8))

    def test_mixed_axes(self):
        mesh = _cpu_mesh(data=4, model=2)
        assert mesh.shape == dict(_jax_mesh(data=4, model=2).shape)
        assert mesh.axis_names == ("data", "model")

    def test_bad_sizes_rejected(self):
        with pytest.raises(ValueError):
            JMeshConfig(data=3, model=3).build()
        with pytest.raises(ValueError):
            tp.MeshConfig(data=3, model=3, devices=["cpu"] * 8).build()
        with pytest.raises(ValueError, match="auto"):
            tp.MeshConfig(data=-1, model=-1, devices=["cpu"] * 8).build()

    def test_rank_layout_and_model_across_ranks_refused(self, monkeypatch):
        """Under a group of 2 (its world faked) the mesh spans 2 x the
        rank's devices rank-major; this rank's rows of a global batch;
        model (and pipe) across ranks raise, naming item 12b."""
        monkeypatch.setattr(multihost, "world", lambda: (2, 1))
        mesh = tp.MeshConfig(data=4, devices=["cpu"] * 2).build()
        assert mesh.multi_rank and mesh.rank == 1
        assert mesh.ranks.tolist() == [0, 0, 1, 1]
        assert mesh.coords("data") == [2, 3]
        x = np.arange(16).reshape(8, 2)
        assert tmesh.global_batch(mesh, x).numpy().tolist() == \
            x[4:].tolist()
        assert tmesh.host_sharded_batch(mesh, x[:3]).shape == (3, 2)
        seq = tp.MeshConfig(data=1, seq=2, devices=["cpu"]).build()
        assert seq.spans_ranks("seq") and seq.axis_peer("seq", 1) == 0
        t = np.arange(24).reshape(1, 1, 8, 3)
        got = tmesh.global_batch(seq, t, (None, None, "seq", None))
        assert got.numpy().tolist() == t[:, :, 4:].tolist()
        for axes in (dict(data=1, model=2), dict(data=1, pipe=2),
                     dict(data=1, expert=2)):
            with pytest.raises(NotImplementedError, match="12b"):
                tp.MeshConfig(**axes, devices=["cpu"]).build()
        # a model axis within each rank is the one-process layout
        inside = tp.MeshConfig(data=2, model=2, devices=["cpu"] * 2).build()
        assert inside.coords("model") == [0, 1]
        assert inside.coords("data") == [1]
        with pytest.raises(NotImplementedError, match="12b"):
            tbert.BertTrainer(tbert.BertConfig(**SMALL_BERT), mesh=mesh)


# ---------------------------------------------------------------------------
# ShardedTrainer
# ---------------------------------------------------------------------------

class TestShardedTrainer:
    def test_dp_matches_single_device(self):
        """Bitwise net.fit's; the reference's sharded step on its 8
        devices within its own rule."""
        X, y = _xy(64)
        port, jnet = _pair(seed=5)
        twin = port.clone()
        twin.fit([(X, y)], 10)
        tp.ShardedTrainer(port, tp.MeshConfig.data_parallel(
            devices=["cpu"] * 8)).fit([(X, y)], 10)
        assert _bits(port) == _bits(twin)
        JShardedTrainer(jnet, JMeshConfig.data_parallel()).fit([(X, y)], 10)
        np.testing.assert_allclose(port.params().numpy(),
                                   np.asarray(jnet.params().numpy()), **REF)
        assert port.getIterationCount() == 10 and port.getEpochCount() == 10

    def test_dp_loss_decreases(self):
        X, y = _xy(64)
        port, jnet = _pair(seed=7, updater=JU.Adam(1e-2))
        s0 = port.score((X, y))
        tp.ShardedTrainer(port, _cpu_mesh(data=8)).fit([(X, y)], 20)
        assert port.score((X, y)) < s0 * 0.7
        JShardedTrainer(jnet).fit([(X, y)], 20)
        close(port.score((X, y)), jnet.score((X, y)), 1e-4, "score")

    def test_uneven_batch_padded_matches_single_device(self):
        """61 rows on 8 data positions: padded to 64, the 3 padding rows
        masked out of the loss."""
        X, y = _xy(61)
        port, jnet = _pair(seed=9)
        twin = port.clone()
        twin.fit([(X, y)], 5)
        tp.ShardedTrainer(port, _cpu_mesh(data=8)).fit([(X, y)], 5)
        np.testing.assert_allclose(port.params().numpy(),
                                   twin.params().numpy(), **REF)
        JShardedTrainer(jnet).fit([(X, y)], 5)
        np.testing.assert_allclose(port.params().numpy(),
                                   np.asarray(jnet.params().numpy()), **REF)

    def test_pad_batch_and_mask(self):
        a = np.arange(10).reshape(5, 2)
        padded, real = trainer._pad_batch(a, 4)
        assert real == 5 and padded.tolist() == a.tolist() + [[8, 9]] * 3
        t, real = trainer._pad_batch(torch.tensor(a), 4)
        assert real == 5 and t.tolist() == padded.tolist()
        assert trainer._pad_batch(a, 5)[0] is a
        m = trainer._padded_mask(np.zeros((8, 3, 4)), None, 5, 8)
        assert m.shape == (8, 4) and m[:5].all() and not m[5:].any()
        given = np.array([[1, 0], [1, 1]], np.float32)
        m = trainer._padded_mask(np.zeros((4, 2, 2)), given, 2, 4)
        assert m.tolist() == [[1, 0], [1, 1], [0, 0], [0, 0]]

    def test_tensor_parallel_matches_replicated(self):
        X, y = _xy(32)
        port_a, jnet_a = _pair(seed=11)
        port_b, jnet_b = _pair(seed=11)
        mesh = _cpu_mesh(data=4, model=2)
        specs = tp.alternating_dense_specs(port_b, axis_size=2)
        jspecs = j_alternating(jnet_b, axis_size=2)
        assert specs == [{k: tuple(v) for k, v in s.items()} for s in jspecs]
        assert tp.replicated_specs(port_a) == [
            {k: () for k in p} for p in port_a._params]
        tp.ShardedTrainer(port_a, _cpu_mesh(data=8)).fit([(X, y)], 5)
        tp.ShardedTrainer(port_b, mesh, param_specs=specs).fit([(X, y)], 5)
        assert _bits(port_a) == _bits(port_b)
        JShardedTrainer(jnet_b, _jax_mesh(data=4, model=2),
                        param_specs=jspecs).fit([(X, y)], 5)
        np.testing.assert_allclose(port_b.params().numpy(),
                                   np.asarray(jnet_b.params().numpy()),
                                   **REF)

    def test_param_specs_must_match_the_params(self):
        port, _ = _pair(seed=3)
        with pytest.raises(ValueError):
            tp.ShardedTrainer(port, _cpu_mesh(data=2),
                              param_specs=[{"W": ()}])
        bad = tp.replicated_specs(port)
        bad[0]["W"] = (None, "model", None)
        with pytest.raises(ValueError, match="2-d"):
            tp.ShardedTrainer(port, _cpu_mesh(data=2), param_specs=bad)

    def test_prefetched_iterator_matches_the_list(self):
        """A ListDataSetIterator goes through the DevicePrefetcher (the
        padding in its producer thread): bitwise the same batches given as
        a list; a 13-row tail padded to the data size."""
        X, y = _xy(45)
        port, _ = _pair(seed=13, updater=JU.Adam(1e-2))
        twin = port.clone()
        it = ListDataSetIterator(DataSet(X, y), 16)
        assert it.asyncSupported()
        tp.ShardedTrainer(port, _cpu_mesh(data=4)).fit(it, 2)
        tp.ShardedTrainer(twin, _cpu_mesh(data=4)).fit(
            [DataSet(X[i:i + 16], y[i:i + 16]) for i in (0, 16, 32)], 2)
        assert _bits(port) == _bits(twin)
        assert port.getIterationCount() == 6

    def test_loss_scaler_path_matches_fit(self):
        """A dynamic loss-scaled policy: the scaler state and the masters
        bitwise net.fit's, an overflowing batch skipped in both."""
        X, y = _xy(32)
        port, _ = _pair(seed=15, precision="fp16_mixed")
        twin = port.clone()
        bad = X.copy()
        bad[0, 0] = np.inf
        batches = [(X, y), (bad, y), (X, y)]
        twin.fit(batches, 1)
        tp.ShardedTrainer(port, _cpu_mesh(data=4)).fit(batches, 1)
        assert _bits(port) == _bits(twin)
        assert {k: float(v) for k, v in port._prec_state.items()} == {
            k: float(v) for k, v in twin._prec_state.items()}
        assert float(port._prec_state["overflows"]) == 1.0

    def test_group_of_one_matches_one_process(self):
        """Under a gloo group of one the step takes the all-reduce path
        (weights exactly 1): bitwise the one-process trainer, as the card
        runs it under NCCL."""
        X, y = _xy(30)
        port, _ = _pair(seed=17, updater=JU.Adam(1e-2))
        twin = port.clone()
        tp.ShardedTrainer(twin, _cpu_mesh(data=4)).fit([(X, y)], 3)
        tp.MultiHost.initialize(tp.VoidConfiguration(
            controllerAddress=f"127.0.0.1:{_free_port()}"),
            num_processes=1, process_id=0, devices=["cpu"] * 4)
        try:
            mesh = tp.MeshConfig(data=4).build()
            tr = tp.ShardedTrainer(port, mesh)
            assert tr._ranks and mesh.shape == {"data": 4}
            tr.fit([(X, y)], 3)
        finally:
            tp.MultiHost.shutdown()
        assert _bits(port) == _bits(twin)
        assert port.score() == twin.score()


# ---------------------------------------------------------------------------
# facades
# ---------------------------------------------------------------------------

class TestFacades:
    def test_parallel_wrapper(self):
        X, y = _xy(64)
        port, _ = _pair(seed=3, updater=JU.Adam(1e-2))
        twin = port.clone()
        s0 = port.score((X, y))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            trainer._WARNED_KNOBS.discard("ParallelWrapper.averagingFrequency")
            wrapper = (tp.ParallelWrapper.Builder(port)
                       .workers(8).prefetchBuffer(2).averagingFrequency(5)
                       .build())
            assert any("parity" in str(x.message) for x in w)
        assert wrapper.mesh.shape == {"data": 8}
        wrapper.fit(ListDataSetIterator(DataSet(X, y), 16), 10)
        assert port.score((X, y)) < s0
        tp.ShardedTrainer(twin, _cpu_mesh(data=8)).fit(
            ListDataSetIterator(DataSet(X, y), 16), 10)
        assert _bits(port) == _bits(twin)
        wrapper.shutdown()

    def test_parallel_inference(self):
        X, _ = _xy(40)
        port, jnet = _pair(seed=5)
        pi = (tp.ParallelInference.Builder(port).batchLimit(64).workers(8)
              .inferenceMode("batched").build())
        out = pi.output(X)
        assert out.shape() == (40, 3)
        np.testing.assert_allclose(out.numpy(), port.output(X).numpy(),
                                   rtol=2e-5, atol=1e-6)
        close(out.numpy(), np.asarray(jnet.output(X).numpy()), 1e-5)

    def test_spark_facade(self):
        X, y = _xy(64)
        port, _ = _pair(seed=13, updater=JU.Adam(1e-2))
        spark_net = tp.SparkDl4jMultiLayer(None, port)
        s0 = port.score((X, y))
        spark_net.fit([(X, y)], 10)
        assert spark_net.getNetwork().score((X, y)) < s0

    def test_training_masters_warn_once(self):
        trainer._WARNED_KNOBS.clear()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            m = (tp.SharedTrainingMaster.Builder(32).batchSizePerWorker(8)
                 .thresholdAlgorithm(None).averagingFrequency(3)
                 .residualPostProcessor(None).workerPrefetchNumBatches(2)
                 .build())
            tp.ParameterAveragingTrainingMaster.Builder(32) \
                .averagingFrequency(3).build()
        assert m.batch_per_worker == 8
        texts = [str(x.message) for x in w]
        assert len(texts) == 2 and all("parity" in t for t in texts)


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------

def _qkv(b=2, h=4, t=16, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, h, t, d)).astype(np.float32)
                 for _ in range(3))


class TestRingAttention:
    @pytest.mark.parametrize("causal", [False, True],
                             ids=["full", "causal"])
    def test_matches_reference_ring_and_dense(self, causal):
        q, k, v = _qkv(seed=int(causal))
        want = np.asarray(j_ring(*map(jnp.asarray, (q, k, v)),
                                 _jax_mesh(data=1, seq=8), causal=causal))
        got = tp.ring_attention(*map(torch.tensor, (q, k, v)),
                                _cpu_mesh(data=1, seq=8), causal=causal)
        np.testing.assert_allclose(got.numpy(), want, **RING)
        dense = t_dense(*map(torch.tensor, (q, k, v)), causal, True)
        np.testing.assert_allclose(got.numpy(), dense.numpy(), **RING)
        np.testing.assert_allclose(
            dense.numpy(), np.asarray(j_dense(*map(jnp.asarray, (q, k, v)),
                                              causal, True)), **RING)

    def test_unscaled_and_uneven_refused(self):
        q, k, v = map(torch.tensor, _qkv(t=8, seed=3))
        mesh = _cpu_mesh(data=1, seq=4)
        np.testing.assert_allclose(
            tp.ring_attention(q, k, v, mesh, scaled=False).numpy(),
            t_dense(q, k, v, False, False).numpy(), **RING)
        with pytest.raises(ValueError, match="split"):
            tp.ring_attention(q[:, :, :6], k[:, :, :6], v[:, :, :6], mesh)

    def test_degenerate_mesh_falls_back(self):
        q, k, v = _qkv(t=8)
        out = tp.ring_attention(*map(torch.tensor, (q, k, v)),
                                _cpu_mesh(data=8))
        np.testing.assert_allclose(
            out.numpy(), np.asarray(j_ring(*map(jnp.asarray, (q, k, v)),
                                           JMeshConfig(data=8).build())),
            **RING)

    @pytest.mark.parametrize("causal", [False, True],
                             ids=["full", "causal"])
    def test_grad_flows(self, causal):
        """Autograd through the one-process ring against dense
        attention's gradients in both packages."""
        q, k, v = _qkv(t=8, seed=2)
        mesh = _cpu_mesh(data=1, seq=8)
        tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
        ring = torch.autograd.grad(
            (tp.ring_attention(tq, tk, tv, mesh, causal=causal) ** 2).sum(),
            (tq, tk, tv))
        dense = torch.autograd.grad(
            (t_dense(tq, tk, tv, causal, True) ** 2).sum(), (tq, tk, tv))

        def fd(q_, k_, v_):
            return jnp.sum(j_dense(q_, k_, v_, causal, True) ** 2)

        jgrads = jax.grad(fd, argnums=(0, 1, 2))(
            *map(jnp.asarray, (q, k, v)))
        for name, g, d, j in zip("qkv", ring, dense, jgrads):
            close(g.numpy(), d.numpy(), GRAD_RTOL, f"d{name} vs dense")
            close(g.numpy(), np.asarray(j), GRAD_RTOL, f"d{name} vs JAX")

    def test_blocks_sit_on_their_positions(self, monkeypatch):
        """Each K/V block moves to the next position's device every ring
        step (n - 1 shifts of K and of V)."""
        calls = []
        real = tp.transport.ring_shift

        def spy(blocks, mesh, axis):
            calls.append(len(blocks))
            return real(blocks, mesh, axis)

        monkeypatch.setattr(tp.transport, "ring_shift", spy)
        q, k, v = map(torch.tensor, _qkv(t=8))
        tp.ring_attention(q, k, v, _cpu_mesh(data=1, seq=4))
        assert calls == [4] * 6


# ---------------------------------------------------------------------------
# fitMultiBatch and takeMulti
# ---------------------------------------------------------------------------

def _stacks(k=4, n=16, seed=21):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(k, n, 12)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (k, n))]
    return X, y


class TestFitMultiBatch:
    @pytest.mark.parametrize("repeats", [1, 2])
    def test_network_matches_fit_calls_and_reference(self, repeats):
        X, y = _stacks()
        port, jnet = _pair(seed=23, updater=JU.Adam(1e-2))
        twin = port.clone()
        losses = port.fitMultiBatch(X, y, repeats=repeats)
        want = []
        for _ in range(repeats):
            want = []
            for f, l in zip(X, y):
                twin.fit(f, l)
                want.append(twin.score())
        assert _bits(port) == _bits(twin)
        assert losses.tolist() == want and port.score() == want[-1]
        assert port.getIterationCount() == 4 * repeats
        jl = jnet.fitMultiBatch(X, y, repeats=repeats)
        np.testing.assert_allclose(losses.numpy(), np.asarray(jl), **REF)
        np.testing.assert_allclose(port.params().numpy(),
                                   np.asarray(jnet.params().numpy()), **REF)

    def test_graph_matches_fit_calls_and_reference(self):
        conf = (J.NeuralNetConfiguration.Builder().seed(4)
                .updater(JU.Adam(1e-2)).graphBuilder()
                .addInputs("in")
                .addLayer("h", J.DenseLayer.Builder().nIn(12).nOut(16)
                          .activation("tanh").build(), "in")
                .addLayer("out", J.OutputLayer.Builder().nIn(16).nOut(3)
                          .activation("softmax").lossFunction("mcxent")
                          .build(), "h")
                .setOutputs("out").build())
        port, jg = graph_pair(conf, seed=4)
        twin, _ = graph_pair(conf, seed=4)
        X, y = _stacks(seed=5)
        losses = port.fitMultiBatch(X, y)
        for f, l in zip(X, y):
            twin.fit(DataSet(f, l))
        assert port.params().numpy().tobytes() == \
            twin.params().numpy().tobytes()
        assert float(losses[-1]) == twin.score()
        jl = jg.fitMultiBatch(X, y)
        np.testing.assert_allclose(losses.numpy(), np.asarray(jl), **REF)
        np.testing.assert_allclose(port.params().numpy(),
                                   np.asarray(jg.params().numpy()), **REF)

    def test_graph_takes_one_input_and_one_output(self):
        conf = (J.NeuralNetConfiguration.Builder().seed(4)
                .updater(JU.Sgd(0.1)).graphBuilder()
                .addInputs("a", "b")
                .addVertex("m", J.MergeVertex(), "a", "b")
                .addLayer("out", J.OutputLayer.Builder().nIn(8).nOut(2)
                          .activation("softmax").build(), "m")
                .setOutputs("out").build())
        port, _ = graph_pair(conf)
        with pytest.raises(ValueError, match="single-input"):
            port.fitMultiBatch(np.zeros((2, 3, 4), np.float32),
                               np.zeros((2, 3, 2), np.float32))

    def test_take_multi_feeds_fit_multi_batch(self):
        """Stacks staged by the prefetcher (on the network's device) into
        fitMultiBatch, bitwise 8 fit calls, and the reference's takeMulti
        -> fitMultiBatch within its rule."""
        X, y = _xy(128, seed=31)
        port, jnet = _pair(seed=29, updater=JU.Adam(1e-2))
        twin = port.clone()
        pf = DevicePrefetcher(ListDataSetIterator(DataSet(X, y), 16),
                              device="cpu")
        try:
            fk, lk = pf.takeMulti(8)
            assert pf.takeMulti(1) is None
        finally:
            pf.close()
        assert isinstance(fk, torch.Tensor) and fk.shape == (8, 16, 12)
        losses = port.fitMultiBatch(fk, lk)
        for i in range(8):
            twin.fit(X[16 * i:16 * (i + 1)], y[16 * i:16 * (i + 1)])
        assert _bits(port) == _bits(twin)
        jpf = jprefetch.DevicePrefetcher(JList(JDataSet(X, y), 16))
        try:
            jfk, jlk = jpf.takeMulti(8)
        finally:
            jpf.close()
        assert np.asarray(jfk).tobytes() == fk.numpy().tobytes()
        jl = jnet.fitMultiBatch(jfk, jlk)
        np.testing.assert_allclose(losses.numpy(), np.asarray(jl), **REF)


# ---------------------------------------------------------------------------
# BertTrainer over seq and model axes
# ---------------------------------------------------------------------------

# of each array's largest element, the MoE BERT trainer's rule
# (tests/test_torch_moe.py): the key bias's gradient is zero in exact
# arithmetic (softmax ignores a shift of every score of a row), so in
# float32 it is rounding noise in both packages, and Adam turns noise into
# +-lr steps that part by ~1e-7 after two steps
BERT_PARAM_RTOL = 1e-3
SMALL_BERT = dict(vocab_size=97, hidden=64, num_layers=2, num_heads=4,
                  ffn=128, max_len=32, dropout=0.0, compute_dtype="float32")


@pytest.mark.parametrize("axes", [dict(data=1, seq=4), dict(data=1, model=2),
                                  dict(data=2, seq=2)],
                         ids=["seq4", "model2", "data2_seq2"])
def test_bert_trainer_matches_reference_on_the_mesh(axes, monkeypatch):
    jcfg = jbert.BertConfig(**SMALL_BERT, attention_impl="dense")
    tcfg = tbert.BertConfig(**SMALL_BERT, attention_impl="flash")
    jt = jbert.BertTrainer(jcfg, _jax_mesh(**axes), lr=1e-3, seed=3)
    mesh = _cpu_mesh(**axes)
    tt = tbert.BertTrainer(tcfg, lr=1e-3, mesh=mesh,
                           params=bert_params_from_numpy(to_np(jt.params),
                                                         "cpu"))
    assert tt.device.type == "cpu"
    assert tt.batch_spec == tmesh.spec_for(mesh, "data", "seq")
    assert tt.param_specs["layers"][0]["qkv_w"] == (
        (None, "model") if "model" in axes else (None, None))
    if "seq" in axes:
        def no_flash(*a, **k):
            raise AssertionError("flash under a seq axis")

        monkeypatch.setattr(tbert.flash, "flash_attention", no_flash)
        monkeypatch.setattr(tbert.flash, "flash_attention_infer", no_flash)
    tokens, labels = jbert.synthetic_mlm_batch(jcfg, 4, 32, seed=7)
    want = [float(jt.train_step(tokens, labels)) for _ in range(2)]
    got = [float(tt.train_step(tokens, labels)) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    compare_trees(tt.params, jt.params, BERT_PARAM_RTOL,
                  "params after 2 steps")


def test_bert_ring_route_matches_dense_route():
    """The same trainer with and without a seq axis: the losses to 1e-5
    relative and the params by ``BERT_PARAM_RTOL`` (only the attention's
    summation order differs)."""
    cfg = tbert.BertConfig(**SMALL_BERT, attention_impl="dense")
    params = tbert.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    a = tbert.BertTrainer(cfg, lr=1e-3, device="cpu",
                          params=to_np_tree(params))
    b = tbert.BertTrainer(cfg, lr=1e-3, mesh=_cpu_mesh(data=1, seq=4),
                          params=to_np_tree(params))
    tokens, labels = tbert.synthetic_mlm_batch(cfg, 2, 32, seed=1)
    la = [float(a.train_step(tokens, labels)) for _ in range(2)]
    lb = [float(b.train_step(tokens, labels)) for _ in range(2)]
    np.testing.assert_allclose(lb, la, rtol=1e-5)
    compare_trees(b.params, a.params, BERT_PARAM_RTOL, "params")


def to_np_tree(params):
    return bert_params_from_numpy(to_np(params), "cpu")


# ---------------------------------------------------------------------------
# the runtime's virtual devices and MultiHost at one process
# ---------------------------------------------------------------------------

def test_cpu_mesh_virtual_devices():
    from deeplearning4j_tpu_torch import runtime
    from deeplearning4j_tpu_torch.ndarray import ndarray as nd

    before = nd._default_device[0]
    try:
        runtime.RuntimeConfig.cpu_mesh(4).apply()
        assert runtime.virtual_cpu_devices() == [torch.device("cpu")] * 4
        mesh = tp.MeshConfig(data=2, seq=2).build()
        assert mesh.shape == {"data": 2, "seq": 2}
        assert {str(d) for d in mesh.devices.flat} == {"cpu"}
        assert runtime.RuntimeConfig.environment()["device_count"] == 4
        with pytest.raises(ValueError):
            runtime.RuntimeConfig(host_device_count=0).apply()
    finally:
        runtime._VIRTUAL["cpu"] = None
        nd._default_device[0] = before


class TestMultiHost:
    def test_single_process_initialize_and_topology(self):
        addr = f"127.0.0.1:{_free_port()}"
        topo = tp.MultiHost.initialize(
            tp.VoidConfiguration(controllerAddress=addr),
            num_processes=1, process_id=0, devices=["cpu"])
        try:
            assert topo == {"process_index": 0, "process_count": 1,
                            "local_devices": 1, "global_devices": 1}
            assert tp.MultiHost.backend() == "gloo"
            # idempotent
            assert tp.MultiHost.initialize()["process_count"] == 1
            with pytest.raises(RuntimeError, match="shutdown"):
                tp.MultiHost.initialize(tp.VoidConfiguration(
                    controllerAddress="127.0.0.1:1"), num_processes=2,
                    process_id=1)
            t = torch.ones(3)
            assert tp.transport.all_reduce_sum(t).tolist() == [1.0] * 3
        finally:
            tp.MultiHost.shutdown()
        assert not torch.distributed.is_initialized()
        assert tp.MultiHost.topology()["process_count"] == 1

    def test_void_configuration_builder_and_parity_warning(self):
        vc = (tp.VoidConfiguration.builder()
              .controllerAddress("10.0.0.1:8476").build())
        assert vc.controllerAddress == "10.0.0.1:8476"
        with pytest.raises(AttributeError, match="no field"):
            tp.VoidConfiguration.builder().bogus
        trainer._WARNED_KNOBS.clear()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            tp.VoidConfiguration(networkMask="10.0.0.0/24")
            assert any("parity" in str(x.message) for x in w)

    def test_without_cuda_the_default_device_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            tp.MultiHost.initialize(num_processes=1, process_id=0)
        assert not tp.MultiHost._initialized


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

cuda = pytest.mark.cuda


@cuda
def test_cuda_ring_matches_dense_and_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    q, k, v = _qkv(t=64, seed=4)
    mesh = tp.MeshConfig(data=1, seq=4, devices=["cuda"] * 4).build()
    for causal in (False, True):
        on_card = [torch.tensor(a, device="cuda", requires_grad=True)
                   for a in (q, k, v)]
        got = tp.ring_attention(*on_card, mesh, causal=causal)
        dense = t_dense(*on_card, causal, True)
        cpu = tp.ring_attention(*map(torch.tensor, (q, k, v)),
                                _cpu_mesh(data=1, seq=4), causal=causal)
        close(to_np(got), to_np(dense), GRAD_RTOL, "ring vs dense")
        close(to_np(got), to_np(cpu), GRAD_RTOL, "card vs CPU")
        g_ring = torch.autograd.grad((got ** 2).sum(), on_card)
        g_dense = torch.autograd.grad((dense ** 2).sum(), on_card)
        for a, b in zip(g_ring, g_dense):
            close(to_np(a), to_np(b), GRAD_RTOL, "gradient")


@cuda
def test_cuda_sharded_trainer_is_bitwise_fit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from deeplearning4j_tpu_torch import nn as TN
    from deeplearning4j_tpu_torch.optimize.updaters import Adam

    conf = (TN.NeuralNetConfiguration.Builder().seed(5)
            .updater(Adam(1e-2)).list()
            .layer(TN.DenseLayer.Builder().nIn(12).nOut(32)
                   .activation("relu").build())
            .layer(TN.OutputLayer.Builder().nOut(3).activation("softmax")
                   .lossFunction("mcxent").build())
            .build())
    net = TN.MultiLayerNetwork(conf).init()
    assert net.device.type == "cuda"
    twin = net.clone()
    X, y = _xy(64)
    twin.fit([(X, y)], 3)
    tp.ShardedTrainer(net, tp.MeshConfig(
        data=4, devices=["cuda"] * 4).build()).fit([(X, y)], 3)
    assert _bits(net) == _bits(twin)
