"""The port's mesh and pipelines against the JAX package's, on the CPU.

- ``parallel/mesh.py``: ``MeshConfig``'s shapes and errors against the
  reference's (the reference on its 8 virtual CPU devices, the port over
  ``["cpu"] * n``), ``spec_for``, the batch helpers; without CUDA the
  default devices raise.
- ``parallel/pipeline.py``: ``pipeline_apply`` against the stages applied
  in sequence and against the reference's, with the microbatch index
  protocol and the reference's schedule order, no work on bubble ticks;
  ``PipelineMlp`` at data=2 x pipe=4 against the reference's (forward to
  1e-5 of the largest element, the loss curve to the reference's
  rtol=2e-3, atol=2e-4); ``pipeline_dryrun``.
- ``models/bert_pipeline.py``: ``BertPipelineTrainer``'s loss curve
  against the reference's at data=2 x pipe=2 and against the port's
  ``BertTrainer`` (dropout 0), the stack round trip, the indivisible-layers
  error, the MoE refusal, dropout keyed by (step, microbatch, layer).
- ``parallel/pipeline_trainer.py``: run detection, loss parity at dp2 x pp2
  with ``MultiLayerNetwork.fit`` and the reference's trainer, a small LSTM
  trunk, the rejections (heterogeneous runs, preprocessors inside the run,
  state, dropout, gradientNormalization), ``sync_to_net``, the held-back
  health rows.
- ``cuda`` cases hold both pipeline trainers on the card against their
  CPU twins.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nn as J
from deeplearning4j_tpu.datasets import DataSet as JaxDataSet
from deeplearning4j_tpu.models import bert as jbert
from deeplearning4j_tpu.models import bert_pipeline as jbp
from deeplearning4j_tpu.optimize import updaters as JU
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu.parallel import pipeline as jpipe
from deeplearning4j_tpu.parallel import pipeline_trainer as jpt
from deeplearning4j_tpu_torch import nn as P
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models import bert as tbert
from deeplearning4j_tpu_torch.models import bert_pipeline as tbp
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import updaters as PU
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel import pipeline as tpipe
from deeplearning4j_tpu_torch.parallel import pipeline_trainer as tpt
from deeplearning4j_tpu_torch.utils.convert import bert_params_from_numpy
from torch_parity import (
    FN_RTOL, as_torch, close, compare_trees, net_pair, to_np)

cuda = pytest.mark.cuda
CURVE = dict(rtol=2e-3, atol=2e-4)   # the reference's multi-step rule


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _meshes(n=8, **axes):
    """(port mesh over n CPU devices, reference mesh over n of its own)."""
    return (tmesh.MeshConfig(**axes, devices=["cpu"] * n).build(),
            jmesh.MeshConfig(**axes, devices=jax.devices()[:n]).build())


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axes,n", [
    (dict(), 8), (dict(data=2, pipe=4), 8), (dict(data=2, expert=4), 8),
    (dict(data=1), 1), (dict(data=-1, pipe=2), 8),
    (dict(data=2, model=2, seq=2), 8), (dict(pipe=-1, data=1), 4),
    (dict(data=-1, model=-1), 8), (dict(data=-1, model=3), 8),
    (dict(data=2, model=2), 8), (dict(data=4, pipe=4), 8),
])
def test_mesh_config_matches_the_reference(axes, n):
    try:
        want = jmesh.MeshConfig(**axes, devices=jax.devices()[:n]).build()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.MeshConfig(**axes, devices=["cpu"] * n).build()
        assert str(got.value) == str(e)
        return
    got = tmesh.MeshConfig(**axes, devices=["cpu"] * n).build()
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert got.devices.shape == want.devices.shape
    assert got.size == n and got.device == torch.device("cpu")
    for names in (("data",), ("data", "pipe"), (None, "data"),
                  ("expert", "model", "seq")):
        assert tmesh.spec_for(got, *names) == tuple(
            jmesh.spec_for(want, *names))
    assert tmesh.MeshConfig.data_parallel(["cpu"] * n).shape == {"data": n}


def test_mesh_needs_cuda_or_named_devices():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default devices are valid")
    for make in (lambda: tmesh.MeshConfig().build(),
                 lambda: tmesh.MeshConfig(devices=["cuda"] * 2).build(),
                 lambda: tmesh.MeshConfig.data_parallel()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_batch_helpers_place_on_the_first_device():
    mesh, _ = _meshes(4, data=2, pipe=2)
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    for fn in (tmesh.shard_batch, tmesh.global_batch,
               tmesh.host_sharded_batch):
        got = fn(mesh, x)
        assert isinstance(got, torch.Tensor) and got.device == mesh.device
        np.testing.assert_array_equal(got.numpy(), x)
    assert tmesh.replicated(mesh) == torch.device("cpu")
    assert mesh.stage_device(1) == torch.device("cpu")
    with pytest.raises(ValueError):
        tmesh.Mesh(np.empty((2, 2), dtype=object), ("data",))


# ---------------------------------------------------------------------------
# pipeline_apply, PipelineMlp
# ---------------------------------------------------------------------------

def _stage_arrays(s=4, h=8, seed=0):
    rng = np.random.default_rng(seed)
    return {"W": (rng.normal(size=(s, h, h)) / np.sqrt(h)).astype(
                np.float32),
            "b": (0.1 * rng.normal(size=(s, h))).astype(np.float32)}


def _seq(params, x_mb):
    out = []
    for i, mb in enumerate(x_mb):
        y = mb
        for s in range(params["W"].shape[0]):
            y = np.tanh(y @ params["W"][s] + params["b"][s]) + 0.01 * i
        out.append(y)
    return np.stack(out)


@pytest.mark.parametrize("axes,stages,against_jax", [
    (dict(data=2, pipe=4), 4, False), (dict(data=1), 4, True),
    (dict(data=4, pipe=2), 2, True)])
def test_pipeline_apply_matches_sequential_and_jax(axes, stages,
                                                   against_jax):
    """Stage s at tick t consumes microbatch t - s; the index reaches the
    stage (here it shifts the output), bubble ticks do no work. (At
    pipe=4 only against the sequential stages: the reference's
    shard_map there compiles for ~15 s, and PipelineMlp's test runs it.)"""
    n = int(np.prod(list(axes.values())))
    mesh, jm = _meshes(n, **axes)
    params = _stage_arrays(stages)
    x_mb = np.random.default_rng(1).normal(size=(4, 4, 8)).astype(
        np.float32)
    calls = []

    def stage(p, x, i):
        calls.append(i)
        return torch.tanh(x @ p["W"] + p["b"]) + 0.01 * i

    got = tpipe.pipeline_apply(
        stage, tpipe.split_stages(as_torch(params), mesh),
        torch.tensor(x_mb), mesh)
    if against_jax:
        want = jpipe.pipeline_apply(
            lambda p, x, i: jax.numpy.tanh(x @ p["W"] + p["b"]) + 0.01 * i,
            jax.tree_util.tree_map(jax.numpy.asarray, params),
            jax.numpy.asarray(x_mb), jm)
        close(got.numpy(), np.asarray(want), FN_RTOL, "vs the reference")
    close(got.numpy(), _seq(params, x_mb), FN_RTOL, "vs sequential")
    assert len(calls) == stages * 4
    pipe = axes.get("pipe", 1)
    if pipe > 1:
        order = [t - s for t in range(4 + pipe - 1) for s in range(pipe)
                 if 0 <= t - s < 4]
        assert calls == order
    back = tpipe.join_stages(tpipe.split_stages(as_torch(params), mesh))
    compare_trees(back, params, 0.0, "split/join")


def test_pipeline_mlp_matches_jax_dp2_pp4():
    mesh, jm = _meshes(8, data=2, pipe=4)
    jmodel = jpipe.PipelineMlp(jm, hidden=8, microbatches=4, lr=5e-2,
                               seed=3)
    model = tpipe.PipelineMlp(mesh, hidden=8, microbatches=4, lr=5e-2,
                              params=to_np(jmodel.params))
    assert len(model.params) == 4
    rng = np.random.default_rng(0)
    x_mb = rng.normal(size=(4, 4, 8)).astype(np.float32)
    close(model.forward(model.params, x_mb).numpy(),
          np.asarray(jmodel.forward(jmodel.params, x_mb)), FN_RTOL,
          "forward")
    x = rng.normal(size=(16, 8)).astype(np.float32)
    y = np.tanh(rng.normal(size=(16, 8))).astype(np.float32)
    want = [float(jmodel.train_step(x, y)) for _ in range(3)]
    got = [float(model.train_step(x, y)) for _ in range(3)]
    np.testing.assert_allclose(got, want, **CURVE)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    compare_trees(model.stacked_params(), jmodel.params, 1e-4, "params")


def test_pipeline_dryrun(capsys):
    tpipe.pipeline_dryrun(["cpu"] * 8)
    assert "pipeline_dryrun: mesh={'data': 4, 'pipe': 2}" in \
        capsys.readouterr().out


# ---------------------------------------------------------------------------
# BertPipelineTrainer
# ---------------------------------------------------------------------------

def _bert_cfgs(n_layers=4, **kw):
    opts = dict(vocab_size=64, hidden=16, num_layers=n_layers, num_heads=2,
                ffn=32, max_len=32, dropout=0.0, compute_dtype="float32")
    opts.update(kw)
    return jbert.BertConfig(**opts), tbert.BertConfig(**opts)


def test_bert_pipeline_matches_jax_and_bert_trainer_dp2_pp2():
    jcfg, tcfg = _bert_cfgs()
    mesh, jm = _meshes(4, data=2, pipe=2)
    jpp = jbp.BertPipelineTrainer(jcfg, jm, microbatches=2, lr=1e-3, seed=7)
    tree = to_np(jbert.init_params(jcfg, jax.random.key(7)))
    pp = tbp.BertPipelineTrainer(tcfg, mesh, microbatches=2, lr=1e-3,
                                 params=bert_params_from_numpy(tree, "cpu"))
    single = tbert.BertTrainer(tcfg, lr=1e-3, device="cpu",
                               params=bert_params_from_numpy(tree, "cpu"))
    assert len(pp.params["stages"]) == 2
    toks, labs = jbert.synthetic_mlm_batch(jcfg, 8, 16, seed=0)
    want = [float(jpp.train_step(toks, labs)) for _ in range(3)]
    got = [float(pp.train_step(toks, labs)) for _ in range(3)]
    one = [float(single.train_step(toks, labs)) for _ in range(3)]
    np.testing.assert_allclose(got, want, **CURVE)
    np.testing.assert_allclose(got, one, **CURVE)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the trained stacks, unstacked, are the single-device trainer's
    compare_trees(pp.stacked_params(), single.params, 1e-3, "params")
    assert pp._step == 3


def test_bert_stack_round_trip_and_errors():
    jcfg, tcfg = _bert_cfgs()
    tree = to_np(jbert.init_params(jcfg, jax.random.key(0)))
    port = bert_params_from_numpy(tree, "cpu")
    emb, stacked = tbp.stack_layer_params(tcfg, port, 2)
    jemb, jstacked = jbp.stack_layer_params(
        jcfg, jax.tree_util.tree_map(jax.numpy.asarray, tree), 2)
    compare_trees(stacked, jstacked, 0.0, "stacked")
    compare_trees(emb, jemb, 0.0, "embeddings and head")
    layers = tbp.unstack_layer_params(stacked)
    assert len(layers) == tcfg.num_layers
    compare_trees(layers, tree["layers"], 0.0, "round trip")
    j3, t3 = _bert_cfgs(n_layers=3)
    with pytest.raises(ValueError, match="not divisible"):
        tbp.stack_layer_params(t3, bert_params_from_numpy(to_np(
            jbert.init_params(j3, jax.random.key(0))), "cpu"), 2)
    mesh, jm = _meshes(2, data=1, pipe=2)
    jmoe_cfg, tmoe_cfg = _bert_cfgs(n_experts=2)
    with pytest.raises(ValueError) as want:
        jbp.BertPipelineTrainer(jmoe_cfg, jm)
    with pytest.raises(ValueError) as got:
        tbp.BertPipelineTrainer(tmoe_cfg, mesh)
    assert str(got.value) == str(want.value) and "MoE" in str(got.value)


def test_bert_pipeline_dropout_is_keyed_and_trains():
    """With dropout on, a stage's draws depend on (step, microbatch,
    layer) only: the same step from the same state repeats its loss, and
    training progresses (the reference asserts progress only)."""
    _, tcfg = _bert_cfgs(dropout=0.2)
    mesh, _ = _meshes(4, data=2, pipe=2)
    tree = to_np(tbert.init_params(tcfg, torch.Generator().manual_seed(1),
                                   "cpu"))
    toks, labs = tbert.synthetic_mlm_batch(tcfg, 8, 16, seed=0)
    a = tbp.BertPipelineTrainer(tcfg, mesh, microbatches=2, lr=5e-3,
                                params=bert_params_from_numpy(tree, "cpu"))
    b = tbp.BertPipelineTrainer(tcfg, mesh, microbatches=2, lr=5e-3,
                                params=bert_params_from_numpy(tree, "cpu"))
    first = float(a.train_step(toks, labs))
    assert first == float(b.train_step(toks, labs))
    gen = tbp._stage_generator(0, 3, 1, 2, "cpu")
    assert torch.equal(torch.rand(4, generator=gen), torch.rand(
        4, generator=tbp._stage_generator(0, 3, 1, 2, "cpu")))
    assert not torch.equal(torch.rand(4, generator=tbp._stage_generator(
        0, 3, 1, 2, "cpu")), torch.rand(4, generator=tbp._stage_generator(
            0, 3, 0, 2, "cpu")))
    last = first
    for _ in range(8):
        last = float(a.train_step(toks, labs))
    assert np.isfinite(last) and last < first


# ---------------------------------------------------------------------------
# PipelineParallelTrainer
# ---------------------------------------------------------------------------

def _mlp_conf(m, n_hidden=4, seed=3, width=16, **dense):
    U = JU if m is J else PU
    b = (m.NeuralNetConfiguration.Builder().seed(seed).updater(U.Adam(1e-2))
         .list())
    for _ in range(n_hidden):
        b.layer(m.DenseLayer.Builder().nOut(width).activation("tanh")
                .build() if not dense else
                m.DenseLayer.Builder(nOut=width, activation="tanh", **dense)
                .build())
    b.layer(m.OutputLayer.Builder().nOut(3).activation("softmax")
            .lossFunction(m.LossFunction.MCXENT).build())
    return b.setInputType(m.InputType.feedForward(width)).build()


def _port_net(conf, seed=0):
    return MultiLayerNetwork(conf, device="cpu").init()


def _data(n=32, width=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, width)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])


def test_run_detection_matches_the_reference():
    for n_hidden, pipe in ((4, 2), (3, 2), (4, 4)):
        port, jnet = net_pair(_mlp_conf(J, n_hidden), 0)
        assert tpt.find_stackable_run(port, pipe) == \
            jpt.find_stackable_run(jnet, pipe)
    conf = (P.NeuralNetConfiguration.Builder().seed(0)
            .updater(PU.Adam(1e-2)).list()
            .layer(P.DenseLayer.Builder().nOut(8).build())
            .layer(P.DenseLayer.Builder().nOut(12).build())
            .layer(P.DenseLayer.Builder().nOut(8).build())
            .layer(P.OutputLayer.Builder().nOut(3).activation("softmax")
                   .lossFunction(P.LossFunction.MCXENT).build())
            .setInputType(P.InputType.feedForward(8)).build())
    with pytest.raises(ValueError, match="Layer structure"):
        tpt.find_stackable_run(_port_net(conf), 2)
    mixed = (P.NeuralNetConfiguration.Builder().seed(0)
             .updater(PU.Adam(1e-2)).list()
             .layer(P.DenseLayer.Builder().nOut(16).activation("tanh")
                    .build())
             .layer(P.DenseLayer.Builder().nOut(16).activation("relu")
                    .build())
             .layer(P.OutputLayer.Builder().nOut(3).activation("softmax")
                    .lossFunction(P.LossFunction.MCXENT).build())
             .setInputType(P.InputType.feedForward(16)).build())
    with pytest.raises(ValueError, match="Layer structure"):
        tpt.find_stackable_run(_port_net(mixed), 2)


def test_dense_parity_dp2_pp2_and_sync_to_net():
    """Eight steps: the pipeline's losses against MultiLayerNetwork.fit
    and against the reference's pipeline trainer, from the same weights;
    then sync_to_net and the net's own output."""
    mesh, jm = _meshes(4, data=2, pipe=2)
    X, y = _data()
    port, jnet = net_pair(_mlp_conf(J), 5)
    ref = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        port.conf.to_json()), device="cpu").init(
            as_torch(to_np(port._params)))
    single = []
    for _ in range(8):
        ref.fit([DataSet(X, y)])
        single.append(ref._score)
    tr = tpt.PipelineParallelTrainer(port, mesh, microbatches=4)
    jtr = jpt.PipelineParallelTrainer(jnet, jm, microbatches=4)
    assert (tr.lo, tr.hi) == (jtr.lo, jtr.hi) == (0, 4)
    got = [tr.train_step(X, y) for _ in range(8)]
    want = [float(jtr.train_step(X, y)) for _ in range(8)]
    np.testing.assert_allclose(got, single, **CURVE)
    np.testing.assert_allclose(got, want, **CURVE)
    assert tr.lossCurve == got
    assert len(tr.opt["run"]) == 2 and tr.opt["run"][0]["m"]["W"].shape \
        == (2, 16, 16)
    before = port.output(X).toNumpy()
    tr.sync_to_net()
    jtr.sync_to_net()
    out = port.output(X).toNumpy()
    assert not np.allclose(out, before)
    close(out, ref.output(X).toNumpy(), 1e-4, "synced vs fit")
    close(out, np.asarray(jnet.output(X).toNumpy()), 1e-4,
          "synced vs the reference's")
    # fit over DataSets continues the same curve
    tr.fit([DataSet(X, y)], epochs=2)
    assert len(tr.lossCurve) == 10


def _lstm_conf(m, seed=7):
    U = JU if m is J else PU
    b = (m.NeuralNetConfiguration.Builder().seed(seed)
         .updater(U.Sgd(5e-2)).list())
    for _ in range(4):
        b.layer(m.LSTM.Builder().nOut(12).build())
    b.layer(m.RnnOutputLayer.Builder().nOut(5).activation("softmax")
            .lossFunction(m.LossFunction.MCXENT).build())
    return b.setInputType(m.InputType.recurrent(12, 6)).build()


def test_lstm_trunk_matches_fit_and_the_reference():
    mesh, _ = _meshes(4, data=2, pipe=2)
    rng = np.random.default_rng(1)
    X = rng.normal(size=(8, 12, 6)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (8, 6))].transpose(
        0, 2, 1)
    port, jnet = net_pair(_lstm_conf(J), 2)
    ref = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        port.conf.to_json()), device="cpu").init(
            as_torch(to_np(port._params)))
    single, jax_single = [], []
    for _ in range(6):
        ref.fit([DataSet(X, y)])
        single.append(ref._score)
        jnet.fit([JaxDataSet(X, y)])
        jax_single.append(jnet._score)
    tr = tpt.PipelineParallelTrainer(port, mesh, microbatches=2)
    assert (tr.lo, tr.hi) == (0, 4)
    got = [tr.train_step(X, y) for _ in range(6)]
    np.testing.assert_allclose(got, single, **CURVE)
    np.testing.assert_allclose(got, jax_single, **CURVE)
    tr.sync_to_net()
    close(port.output(X).toNumpy(), ref.output(X).toNumpy(), 1e-4, "synced")


def _reject(conf_port, conf_jax, match, mesh_axes=dict(data=2, pipe=2),
            prepare=None):
    """Both packages refuse the net with the same message."""
    mesh, jm = _meshes(4, **mesh_axes)
    port, jnet = net_pair(conf_jax, 0) if conf_port is None else (
        _port_net(conf_port), None)
    if prepare is not None:
        prepare(port, jnet)
    with pytest.raises(ValueError, match=match) as got:
        tpt.PipelineParallelTrainer(port, mesh)
    if jnet is not None:
        with pytest.raises(ValueError) as want:
            jpt.PipelineParallelTrainer(jnet, jm)
        assert str(got.value) == str(want.value)


def test_rejections_match_the_reference():
    _reject(None, _mlp_conf(J, dropOut=0.5), "dropout")
    _reject(None, _mlp_conf(J, gradientNormalization="clip_l2_per_layer"),
            "gradientNormalization")

    def bn(m):
        U = JU if m is J else PU
        b = (m.NeuralNetConfiguration.Builder().seed(0)
             .updater(U.Adam(1e-2)).list())
        for _ in range(4):
            b.layer(m.DenseLayer.Builder().nOut(8).activation("tanh")
                    .build())
        b.layer(m.BatchNormalization.Builder().build())
        b.layer(m.OutputLayer.Builder().nOut(3).activation("softmax")
                .lossFunction(m.LossFunction.MCXENT).build())
        return b.setInputType(m.InputType.feedForward(8)).build()

    _reject(None, bn(J), "carries state")

    def moe(m):
        U = JU if m is J else PU
        b = (m.NeuralNetConfiguration.Builder().seed(0)
             .updater(U.Adam(1e-2)).list())
        for _ in range(2):
            b.layer(m.DenseLayer.Builder().nOut(8).activation("tanh")
                    .build())
        b.layer(m.MoELayer.Builder().nOut(8).ffnSize(16).nExperts(2)
                .build())
        b.layer(m.OutputLayer.Builder().nOut(3).activation("softmax")
                .lossFunction(m.LossFunction.MCXENT).build())
        return b.setInputType(m.InputType.feedForward(8)).build()

    _reject(None, moe(J), "carries state")

    class Flat:   # a stand-in preprocessor on every layer of the run
        def __call__(self, x):
            return x

    def with_preprocessors(port, jnet):
        for net in (port, jnet):
            for i in range(4):
                net.conf.preprocessors[i] = Flat()

    mesh, jm = _meshes(4, data=2, pipe=2)
    port, jnet = net_pair(_mlp_conf(J), 0)
    with_preprocessors(port, jnet)
    with pytest.raises(ValueError, match="preprocessor") as got:
        tpt.PipelineParallelTrainer(port, mesh, run=(0, 4))
    with pytest.raises(ValueError) as want:
        jpt.PipelineParallelTrainer(jnet, jm, run=(0, 4))
    assert str(got.value) == str(want.value)
    port, _ = net_pair(_mlp_conf(J), 0)
    with pytest.raises(ValueError, match="not divisible"):
        tpt.PipelineParallelTrainer(port, mesh, run=(0, 3))
    tr = tpt.PipelineParallelTrainer(port, mesh)
    with pytest.raises(NotImplementedError, match="item 13"):
        tr.health_labels()
    with pytest.raises(ValueError, match="not divisible by microbatches"):
        tr.train_step(*_data(n=30))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@cuda
def test_cuda_pipeline_trainer_lstm_matches_the_cpu():
    """An LSTM net on the card against its CPU twin: 3 steps, losses to
    1e-4 relative. Layer 0 (12 -> 32) differs in shape, so the run is
    layers 1-2 and layer 3 runs outside it: rows 1 and 3 launch 1 + 2 x 2
    + 1 times a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from deeplearning4j_tpu_torch.kernels import lstm

    conf = (P.NeuralNetConfiguration.Builder().seed(7)
            .updater(PU.Adam(1e-2)).list())
    for _ in range(4):
        conf.layer(P.LSTM.Builder().nOut(32).build())
    conf = conf.layer(P.RnnOutputLayer.Builder().nOut(5)
                      .activation("softmax").build()).setInputType(
        P.InputType.recurrent(12, 6)).build()
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    gpu = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json())).init(as_torch(to_np(cpu._params), "cuda"))
    devs = [torch.device("cuda")] * 4
    t_gpu = tpt.PipelineParallelTrainer(
        gpu, tmesh.MeshConfig(data=2, pipe=2, devices=devs).build(),
        microbatches=2)
    t_cpu = tpt.PipelineParallelTrainer(
        cpu, tmesh.MeshConfig(data=2, pipe=2, devices=["cpu"] * 4).build(),
        microbatches=2)
    rng = np.random.default_rng(1)
    X = rng.normal(size=(8, 12, 6)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (8, 6))].transpose(
        0, 2, 1)
    assert (t_gpu.lo, t_gpu.hi) == (1, 3)
    lstm.lstm_seq_fwd.launches = lstm.lstm_seq_bwd.launches = 0
    for step in range(3):
        a, b = t_gpu.train_step(X, y), t_cpu.train_step(X, y)
        assert abs(a - b) <= 1e-4 * abs(b), (step, a, b)
    assert lstm.lstm_seq_fwd.launches == lstm.lstm_seq_bwd.launches == 18


@cuda
def test_cuda_bert_pipeline_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    # the flash kernels take head sizes 64 and 128
    _, tcfg = _bert_cfgs(attention_impl="flash", hidden=128, ffn=256)
    tree = to_np(tbert.init_params(tcfg, torch.Generator().manual_seed(1),
                                   "cpu"))
    devs = [torch.device("cuda")] * 2
    gpu = tbp.BertPipelineTrainer(
        tcfg, tmesh.MeshConfig(data=1, pipe=2, devices=devs).build(),
        microbatches=2, lr=1e-3, params=bert_params_from_numpy(tree, "cuda"))
    cpu = tbp.BertPipelineTrainer(
        tcfg, tmesh.MeshConfig(data=1, pipe=2, devices=["cpu"] * 2).build(),
        microbatches=2, lr=1e-3, params=bert_params_from_numpy(tree, "cpu"))
    toks, labs = tbert.synthetic_mlm_batch(tcfg, 8, 16, seed=0)
    for step in range(2):
        a = float(gpu.train_step(toks, labs))
        b = float(cpu.train_step(toks, labs))
        assert abs(a - b) <= 1e-4 * abs(b), (step, a, b)
