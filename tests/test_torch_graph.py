"""ComputationGraph in the port, against the JAX package.

- The vertices of ``nn/conf/graph_conf.py`` (Merge, ElementWise with each
  op, Scale, Shift, Stack, Subset, L2Normalize, Reshape): JSON, ``infer``,
  output and input gradients, to 1e-5 relative.
- ``ComputationGraphConfiguration``: JSON both ways and equal to the JAX
  package's, ``topo_order`` name for name, the errors it raises
  (undefined input, cycle) and the graph's refusal of an output node that
  is no output layer.
- The reference's ``tests/test_nn.py::TestComputationGraph`` runs as
  written on both packages.
- ``ComputationGraph`` with transferred weights: a two-input, two-output
  graph with a MergeVertex (``MultiDataSet``, one Adam step, a ragged
  batch), TBPTT and ``rnnTimeStep`` on a recurrent graph, ``params``,
  ``setParams``, ``gradients``, ``evaluate`` and ``summary``, to 1e-5
  (losses, outputs) and 1e-4 of each array's largest element (trained
  params and updater state; never tighter than 1e-4 of the learning rate,
  for a conv bias ahead of BatchNormalization, whose exact gradient is
  zero).
- ``ModelSerializer`` zips of a graph with BatchNormalization and
  Nesterovs state, from each package restored in the other.
- ``GraphServable`` through ``InferenceSession``: served rows equal
  ``outputSingle`` to 1e-5 of the largest element (the CPU's conv picks
  its algorithm by batch size, so a padded bucket is not bit-equal).
- The mixed graph under ``bf16_mixed``: gradients of the bf16-compute
  loss against the JAX package's (each array's error against the float32
  graph at most 4 times the reference's own, never tighter than 4 unit
  roundoffs of 2^-8), one fit step's loss-scaler state equal, masters
  and moments float32.
- The repairs: ``Nd4jBackend``, ``RuntimeConfig`` and
  ``NeuralNetConfiguration.Builder``'s ``trainingWorkspaceMode``,
  ``inferenceWorkspaceMode`` and ``cudnnAlgoMode``, each against the
  JAX package's.

ResNet-50 itself is in ``test_torch_resnet.py``.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu as jax_pkg
import deeplearning4j_tpu_torch as port_pkg
from deeplearning4j_tpu import datasets as jax_datasets
from deeplearning4j_tpu import nn as jax_nn
from deeplearning4j_tpu.backend import Nd4jBackend as JaxBackend
from deeplearning4j_tpu.nn.conf import graph_conf as jax_graph_conf
from deeplearning4j_tpu.nn.conf import inputs as jax_inputs
from deeplearning4j_tpu.optimize import updaters as jax_updaters
from deeplearning4j_tpu.runtime import RuntimeConfig as JaxRuntimeConfig
from deeplearning4j_tpu.utils.serializer import (
    ModelSerializer as JaxSerializer)
from deeplearning4j_tpu_torch import datasets as port_datasets
from deeplearning4j_tpu_torch import nn as port_nn
from deeplearning4j_tpu_torch.backend import Nd4jBackend
from deeplearning4j_tpu_torch.nn import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf import graph_conf
from deeplearning4j_tpu_torch.nn.conf import inputs as port_inputs
from deeplearning4j_tpu_torch.optimize import updaters as port_updaters
from deeplearning4j_tpu_torch.runtime import RuntimeConfig
from deeplearning4j_tpu_torch.serving import (
    GraphServable, InferenceSession, as_servable)
from deeplearning4j_tpu_torch.tree_util import tree_leaves
from deeplearning4j_tpu_torch.utils import ModelSerializer
from deeplearning4j_tpu_torch.utils.convert import (
    opt_states_to_numpy, params_from_numpy, states_from_numpy,
    states_to_numpy)

FN_RTOL = 1e-5
TRAIN_RTOL = 1e-4

JAX = SimpleNamespace(nn=jax_nn, U=jax_updaters, D=jax_datasets,
                      graph=lambda conf: jax_nn.ComputationGraph(conf))
PORT = SimpleNamespace(nn=port_nn, U=port_updaters, D=port_datasets,
                       graph=lambda conf: ComputationGraph(conf,
                                                           device="cpu"))
PACKAGES = {"jax": JAX, "torch": PORT}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, rtol=FN_RTOL, what="", floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=max(rtol * scale, floor), err_msg=what)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        # a copy: a JAX step that donates its buffers could otherwise
        # write into the port's tensors through a numpy view
        return tree.detach().cpu().numpy().copy()
    return np.asarray(tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _compare_trees(got, want, rtol, what, floor=0.0):
    got, want = dict(_leaves(_np(got))), dict(_leaves(_np(want)))
    assert sorted(got) == sorted(want), what
    for path in want:
        _close(got[path], want[path], rtol, f"{what} {path}", floor)


def _jax_graph(port):
    """The JAX package's graph from the port's configuration JSON on the
    port's params and layer states; its ``init`` draws nothing."""
    jconf = jax_graph_conf.ComputationGraphConfiguration.from_json(
        port.conf.to_json())
    params = _np(port._params)
    for name, (node, _) in jconf.nodes.items():
        if isinstance(node, jax_nn.layers.BaseLayer):
            node.init_params = lambda key, dtype, p=params[name]: \
                jax.tree_util.tree_map(jnp.asarray, p)
    jg = jax_nn.ComputationGraph(jconf).init()
    for node, _ in jconf.nodes.values():
        node.__dict__.pop("init_params", None)
    jg._states = jax.tree_util.tree_map(jnp.asarray, _np(port._states))
    return jg


def _compare_graphs(port, jg, what, rtol=TRAIN_RTOL, lr=0.0):
    """Params, layer states and updater state, each array to ``rtol`` of
    its largest element, and never tighter than ``rtol * lr`` for the
    params and updater state: a conv bias ahead of BatchNormalization has
    a zero gradient in exact arithmetic, so it and its velocity hold
    rounding noise alone."""
    _compare_trees(port._params, jg._params, rtol, f"{what} params",
                   rtol * lr)
    _compare_trees(port._states, jg._states, rtol, f"{what} states")
    _compare_trees(port._opt_states, jg._opt_states, rtol,
                   f"{what} updater", rtol * lr)


# ---------------------------------------------------------------------------
# the vertices
# ---------------------------------------------------------------------------

def _conv(c, h=4, w=5):
    return ("conv", (c, h, w))


def _ff(n):
    return ("ff", (n,))


def _rnn(n, t=6):
    return ("rnn", (n, t))


def _input_type(pkg_inputs, kind):
    tag, dims = kind
    it = pkg_inputs.InputType
    if tag == "conv":
        c, h, w = dims
        return it.convolutional(h, w, c)
    if tag == "rnn":
        return it.recurrent(*dims)
    return it.feedForward(dims[0])


VERTICES = [
    ("MergeVertex", {}, [_conv(3), _conv(2)]),
    ("MergeVertex", {}, [_ff(4), _ff(6), _ff(1)]),
    ("MergeVertex", {}, [_rnn(3), _rnn(5)]),
    ("ElementWiseVertex", {"op": "Add"}, [_conv(3)] * 3),
    ("ElementWiseVertex", {"op": "Subtract"}, [_ff(7)] * 2),
    ("ElementWiseVertex", {"op": "Product"}, [_ff(5)] * 3),
    ("ElementWiseVertex", {"op": "Average"}, [_rnn(4)] * 3),
    ("ElementWiseVertex", {"op": "Max"}, [_conv(2)] * 2),
    ("ScaleVertex", {"scaleFactor": 2.5}, [_conv(3)]),
    ("ShiftVertex", {"shiftFactor": -0.75}, [_ff(6)]),
    ("StackVertex", {}, [_ff(5)] * 2),
    ("SubsetVertex", {"fromIdx": 1, "toIdx": 3}, [_conv(5)]),
    ("SubsetVertex", {"fromIdx": 0, "toIdx": 2}, [_rnn(4)]),
    ("SubsetVertex", {"fromIdx": 2, "toIdx": 2}, [_ff(4)]),
    ("L2NormalizeVertex", {}, [_conv(3)]),
    ("L2NormalizeVertex", {"eps": 1e-3}, [_ff(6)]),
    ("ReshapeVertex", {"newShape": (4, 5)}, [_ff(20)]),
]


@pytest.mark.parametrize(
    "name,kw,kinds", VERTICES,
    ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(VERTICES)])
def test_vertex_matches_the_reference(name, kw, kinds):
    """JSON (and back), ``infer``, the output, and each input's gradient
    of sum(y * r) for a random r."""
    mine = getattr(graph_conf, name)(**kw)
    theirs = getattr(jax_graph_conf, name)(**kw)
    assert mine.to_json() == theirs.to_json()
    back = graph_conf.GraphVertex.from_json(theirs.to_json())
    assert type(back) is type(mine) and back.to_json() == mine.to_json()
    got = mine.infer(*[_input_type(port_inputs, k) for k in kinds])
    want = theirs.infer(*[_input_type(jax_inputs, k) for k in kinds])
    assert got.to_json() == want.to_json()
    rng = np.random.default_rng(len(kinds) * 7 + len(name))
    xs = [rng.normal(size=(3,) + dims).astype(np.float32)
          for _, dims in kinds]
    y = theirs.apply(*[jnp.asarray(x) for x in xs])
    r = rng.normal(size=y.shape).astype(np.float32)
    txs = [torch.tensor(x, requires_grad=True) for x in xs]
    ty = mine.apply(*txs)
    _close(ty.detach().numpy(), y, what="output")
    grads = torch.autograd.grad((ty * torch.tensor(r)).sum(), txs)
    want = jax.grad(lambda *a: jnp.sum(theirs.apply(*a) * r),
                    argnums=tuple(range(len(xs))))(
        *[jnp.asarray(x) for x in xs])
    for i, (g, w) in enumerate(zip(grads, want)):
        _close(g.numpy(), w, what=f"d input {i}")


def test_every_reference_vertex_but_attention_is_ported():
    assert set(graph_conf.VERTEX_REGISTRY) == \
        set(jax_graph_conf.VERTEX_REGISTRY) - {"AttentionVertex"}
    with pytest.raises(NotImplementedError, match="AttentionVertex"):
        graph_conf.GraphVertex.from_json({"@class": "AttentionVertex"})


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------

def _mixed_conf(ns):
    """A graph over every vertex kind, conv and dense layers, declared
    input types, an updater per node and TBPTT fields."""
    nn = ns.nn
    return (nn.NeuralNetConfiguration.Builder().seed(3)
            .updater(ns.U.Nesterovs(0.05, 0.8)).weightInit("xavier")
            .l2(1e-4).graphBuilder()
            .addInputs("img", "vec")
            .setInputTypes(nn.InputType.convolutional(8, 8, 2),
                           nn.InputType.feedForward(6))
            .addLayer("c1", nn.ConvolutionLayer.Builder().nOut(4)
                      .kernelSize([3, 3])
                      .convolutionMode(nn.ConvolutionMode.SAME)
                      .activation("relu").build(), "img")
            .addLayer("bn", nn.BatchNormalization.Builder().build(), "c1")
            .addVertex("sub", nn.SubsetVertex(0, 1), "bn")
            .addVertex("sc", nn.ScaleVertex(0.5), "sub")
            .addVertex("merged", nn.MergeVertex(), "bn", "sc")
            .addLayer("gp", nn.GlobalPoolingLayer.Builder().build(),
                      "merged")
            .addLayer("dv", nn.DenseLayer.Builder().nOut(6)
                      .activation("tanh")
                      .updater(ns.U.Adam(1e-2)).build(), "vec")
            .addVertex("sh", nn.ShiftVertex(0.1), "dv")
            .addVertex("l2", nn.L2NormalizeVertex(), "sh")
            .addVertex("mx", nn.ElementWiseVertex("Max"), "gp", "l2")
            .addLayer("out", nn.OutputLayer.Builder().nOut(3)
                      .activation("softmax").lossFunction("mcxent")
                      .build(), "mx")
            .addLayer("aux", nn.OutputLayer.Builder().nOut(2)
                      .activation("identity").lossFunction("mse").build(),
                      "l2")
            .setOutputs("out", "aux")
            .backpropType("Standard")
            .build())


def test_graph_configuration_json_and_order_are_the_reference_s():
    mine, theirs = _mixed_conf(PORT), _mixed_conf(JAX)
    assert mine.to_json() == theirs.to_json()
    assert mine.topo_order == theirs.topo_order
    for text in (mine.to_json(), theirs.to_json()):
        assert graph_conf.ComputationGraphConfiguration.from_json(
            text).to_json() == text
        assert jax_graph_conf.ComputationGraphConfiguration.from_json(
            text).to_json() == text
    # the layers' nIn come from shape inference over the input types
    assert mine.nodes["gp"][0].to_json() == theirs.nodes["gp"][0].to_json()
    assert mine.nodes["out"][0].nIn == 6 and mine.nodes["aux"][0].nIn == 6
    assert mine.dtype == torch.float32


@pytest.mark.parametrize("edges", [
    # (name, inputs) in insertion order; the order Kahn's sorted seed gives
    [("z", ["in"]), ("a", ["z"]), ("m", ["in"]), ("b", ["a", "m"])],
    [("d", ["c"]), ("c", ["in2"]), ("b", ["in"]), ("a", ["b", "d"]),
     ("e", ["a"]), ("f", ["in", "e"])],
])
def test_topological_order_name_for_name(edges):
    def build(nn):
        b = nn.NeuralNetConfiguration.Builder().graphBuilder().addInputs(
            "in", "in2")
        for name, ins in edges:
            b.addVertex(name, nn.ElementWiseVertex("Add"), *ins)
        return b.setOutputs(edges[-1][0]).build()

    assert build(port_nn).topo_order == build(jax_nn).topo_order


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_configuration_errors_are_the_reference_s(pkg):
    nn = PACKAGES[pkg].nn
    b = (nn.NeuralNetConfiguration.Builder().graphBuilder().addInputs("in")
         .addLayer("a", nn.DenseLayer(nIn=4, nOut=4), "nowhere")
         .setOutputs("a"))
    with pytest.raises(ValueError, match="undefined"):
        b.build()
    b = (nn.NeuralNetConfiguration.Builder().graphBuilder().addInputs("in")
         .addLayer("a", nn.DenseLayer(nIn=4, nOut=4), "b")
         .addLayer("b", nn.DenseLayer(nIn=4, nOut=4), "a")
         .setOutputs("b"))
    with pytest.raises(ValueError, match="cycle"):
        b.build()
    conf = (nn.NeuralNetConfiguration.Builder().graphBuilder()
            .addInputs("in")
            .addLayer("a", nn.DenseLayer(nIn=4, nOut=4), "in")
            .setOutputs("a").build())
    with pytest.raises(ValueError, match="must be an OutputLayer"):
        PACKAGES[pkg].graph(conf)


def _mixed_data(n, seed):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(n, 2, 8, 8)).astype(np.float32)
    vec = rng.normal(size=(n, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    z = rng.normal(size=(n, 2)).astype(np.float32)
    return (img, vec), (y, z)


def test_mixed_graph_trains_as_the_reference():
    """Every vertex kind in one graph, with L1/L2, a per-node updater
    (Adam on ``dv`` under the default Nesterovs) and per-node gradient
    normalization: output, score and 2 fit steps against the JAX
    package's."""
    conf = _mixed_conf(PORT)
    conf.nodes["c1"][0].l1 = 1e-3
    conf.nodes["dv"][0].gradientNormalization = "clip_l2_per_layer"
    conf.nodes["dv"][0].gradientNormalizationThreshold = 0.05
    port = ComputationGraph(
        graph_conf.ComputationGraphConfiguration.from_json(conf.to_json()),
        device="cpu").init()
    jg = _jax_graph(port)
    assert port.conf.to_json() == jg.conf.to_json()
    feats, labels = _mixed_data(5, 0)
    for got, want in zip(port.output(*feats), jg.output(*feats)):
        _close(got.toNumpy(), want.toNumpy())
    _close(port.score((feats, labels)), jg.score((feats, labels)))
    for seed in (1, 2):
        feats, labels = _mixed_data(5, seed)
        port.fit([(feats, labels)])
        jg.fit([(feats, labels)])
        assert abs(port.score() - jg.score()) <= FN_RTOL * abs(jg.score())
    _compare_graphs(port, jg, "mixed", lr=0.05)
    assert set(port._opt_states["dv"]) == {"m", "v"}


BF16_UNIT = 2.0 ** -8   # bfloat16's unit roundoff
BF16_FACTOR = 4


def test_precision_policies_wait_for_their_slice():
    """The mixed graph under ``bf16_mixed`` against the JAX package's from
    the same float32 masters: the JSON; the gradients of the bf16-compute
    loss in float32, each array's error against the float32 graph's
    gradients at most BF16_FACTOR times the JAX package's own (never held
    tighter than BF16_FACTOR unit roundoffs of its largest element); one
    fit step's loss-scaler state equal and the masters and moments still
    float32; the output in float32. An uninitialised graph refuses
    ``output``; ``fitMultiBatch`` refuses this two-input graph (it takes
    single-input, single-output graphs, as the reference's does), and
    listeners still wait for ROADMAP.md queue 1 item 13."""
    with pytest.raises(RuntimeError, match="init"):
        ComputationGraph(_mixed_conf(PORT), device="cpu").output(
            np.zeros((1, 2, 8, 8), np.float32))
    conf = _mixed_conf(PORT)
    conf.precision = "bf16_mixed"
    text = conf.to_json()
    jconf = _mixed_conf(JAX)
    jconf.precision = "bf16_mixed"
    assert jconf.to_json() == text
    port = ComputationGraph(
        graph_conf.ComputationGraphConfiguration.from_json(text),
        device="cpu").init()
    assert port.conf.precision_policy.is_mixed
    jg = _jax_graph(port)
    j32 = _jax_graph(ComputationGraph(_mixed_conf(PORT), device="cpu")
                     .init(port._params))
    feats, labels = _mixed_data(5, 4)
    got = dict(_leaves(_np(port.gradients((feats, labels)))))
    want = dict(_leaves(_np(jg.gradients((feats, labels)))))
    f32 = dict(_leaves(_np(j32.gradients((feats, labels)))))
    assert sorted(got) == sorted(want) == sorted(f32)
    for k in f32:
        assert got[k].dtype == np.float32
        e_port = float(np.abs(got[k] - f32[k]).max())
        e_ref = float(np.abs(np.asarray(want[k], np.float32) - f32[k]).max())
        assert e_port <= BF16_FACTOR * max(
            e_ref, BF16_UNIT * float(np.abs(f32[k]).max())), k
    port.fit([(feats, labels)])
    jg.fit([(feats, labels)])
    assert {k: float(v) for k, v in port._prec_state.items()} == {
        k: float(np.asarray(v)) for k, v in jg._prec_state.items()} == {
        "scale": 2.0 ** 15, "good_steps": 1.0, "overflows": 0.0}
    assert {v.dtype for v in tree_leaves(
        [port._params, port._opt_states])} == {torch.float32}
    assert all(y.dataType() == torch.float32 for y in port.output(*feats))
    with pytest.raises(ValueError, match="single-input"):
        port.fitMultiBatch(np.stack([feats[0]]), np.stack([labels[0]]))
    with pytest.raises(NotImplementedError, match="item 13"):
        port.setListeners(object())


# ---------------------------------------------------------------------------
# the reference's tests/test_nn.py::TestComputationGraph, on both packages
# ---------------------------------------------------------------------------

def _xy(n=32, fin=10, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, fin)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return X, y


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
class TestComputationGraph:
    def _graph_conf(self, pkg):
        nn, U = PACKAGES[pkg].nn, PACKAGES[pkg].U
        return (nn.NeuralNetConfiguration.Builder().seed(7)
                .updater(U.Adam(1e-2))
                .graphBuilder()
                .addInputs("in")
                .addLayer("d1", nn.DenseLayer.Builder().nIn(10).nOut(16)
                          .activation("relu").build(), "in")
                .addLayer("d2", nn.DenseLayer.Builder().nIn(16).nOut(16)
                          .activation("identity").build(), "d1")
                .addVertex("res", nn.ElementWiseVertex("Add"), "d1", "d2")
                .addLayer("out", nn.OutputLayer.Builder().nIn(16).nOut(3)
                          .activation("softmax").lossFunction("mcxent")
                          .build(), "res")
                .setOutputs("out")
                .build())

    def test_residual_graph_trains(self, pkg):
        g = PACKAGES[pkg].graph(self._graph_conf(pkg)).init()
        X, y = _xy()
        s0 = g.score((X, y))
        g.fit([(X, y)], 30)
        assert g.score((X, y)) < s0 * 0.7

    def test_multi_input_merge(self, pkg):
        nn, U = PACKAGES[pkg].nn, PACKAGES[pkg].U
        conf = (nn.NeuralNetConfiguration.Builder().seed(7)
                .updater(U.Adam(1e-2))
                .graphBuilder()
                .addInputs("a", "b")
                .addLayer("da", nn.DenseLayer.Builder().nIn(4).nOut(8)
                          .activation("relu").build(), "a")
                .addLayer("db", nn.DenseLayer.Builder().nIn(6).nOut(8)
                          .activation("relu").build(), "b")
                .addVertex("m", nn.MergeVertex(), "da", "db")
                .addLayer("out", nn.OutputLayer.Builder().nIn(16).nOut(2)
                          .activation("softmax").lossFunction("mcxent")
                          .build(), "m")
                .setOutputs("out").build())
        g = PACKAGES[pkg].graph(conf).init()
        rng = np.random.default_rng(0)
        a = rng.normal(size=(8, 4)).astype(np.float32)
        b = rng.normal(size=(8, 6)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]
        out = g.output(a, b)[0]
        assert out.shape() == (8, 2)
        s0 = g.score(((a, b), (y,)))
        g.fit([((a, b), (y,))], 20)
        assert g.score(((a, b), (y,))) < s0

    def test_json_roundtrip(self, pkg):
        conf = self._graph_conf(pkg)
        g = PACKAGES[pkg].graph(conf).init()
        conf2 = type(conf).from_json(conf.to_json())
        g2 = PACKAGES[pkg].graph(conf2).init()
        X, _ = _xy()
        np.testing.assert_allclose(g.output(X)[0].numpy(),
                                   g2.output(X)[0].numpy(), rtol=1e-5)

    def test_topo_rejects_cycle(self, pkg):
        nn = PACKAGES[pkg].nn
        b = (nn.NeuralNetConfiguration.Builder().graphBuilder()
             .addInputs("in")
             .addLayer("a", nn.DenseLayer(nIn=4, nOut=4), "b")
             .addLayer("b", nn.DenseLayer(nIn=4, nOut=4), "a")
             .setOutputs("b"))
        with pytest.raises(ValueError):
            b.build()


# ---------------------------------------------------------------------------
# ComputationGraph with transferred weights
# ---------------------------------------------------------------------------

def _two_headed():
    """Two inputs, two outputs: dense branches merged, a softmax head and
    a regression head off different nodes, BatchNormalization on one
    branch."""
    nn, U = port_nn, port_updaters
    conf = (nn.NeuralNetConfiguration.Builder().seed(11)
            .updater(U.Adam(1e-2)).weightInit("xavier").graphBuilder()
            .addInputs("a", "b")
            .setInputTypes(nn.InputType.feedForward(4),
                           nn.InputType.feedForward(6))
            .addLayer("da", nn.DenseLayer.Builder().nOut(8)
                      .activation("relu").build(), "a")
            .addLayer("db", nn.DenseLayer.Builder().nOut(5)
                      .activation("tanh").build(), "b")
            .addLayer("bnb", nn.BatchNormalization.Builder().build(), "db")
            .addVertex("m", nn.MergeVertex(), "da", "bnb")
            .addLayer("cls", nn.OutputLayer.Builder().nOut(3)
                      .activation("softmax").lossFunction("mcxent").build(),
                      "m")
            .addLayer("reg", nn.OutputLayer.Builder().nOut(2)
                      .activation("identity").lossFunction("mse").build(),
                      "bnb")
            .setOutputs("cls", "reg").build())
    return ComputationGraph(conf, device="cpu").init()


def _two_headed_data(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 4)).astype(np.float32)
    b = rng.normal(size=(n, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    z = rng.normal(size=(n, 2)).astype(np.float32)
    return (a, b), (y, z)


def test_two_input_two_output_graph_fits_as_the_reference():
    port = _two_headed()
    jg = _jax_graph(port)
    feats, labels = _two_headed_data(7, 0)
    for got, want in zip(port.output(*feats), jg.output(*feats)):
        _close(got.toNumpy(), want.toNumpy())
    assert abs(port.score((feats, labels)) - jg.score((feats, labels))) \
        <= FN_RTOL * jg.score((feats, labels))
    # a MultiDataSet step, then a ragged one padded to the bucket
    for n, seed in ((7, 1), (4, 2)):
        f, lab = _two_headed_data(n, seed)
        port.fit(port_datasets.MultiDataSet(list(f), list(lab)))
        jg.fit(jax_datasets.MultiDataSet(list(f), list(lab)))
        assert abs(port.score() - jg.score()) <= FN_RTOL * abs(jg.score())
    assert port._bucket == 7 and port.getIterationCount() == 2
    _compare_graphs(port, jg, "two-headed")


def test_params_gradients_evaluate_and_summary_match_the_reference():
    port = _two_headed()
    jg = _jax_graph(port)
    _close(port.params().toNumpy(), jg.params().toNumpy(), 0.0)
    assert port.numParams() == jg.numParams()
    feats, labels = _two_headed_data(6, 3)
    _compare_trees(port.gradients((feats, labels)),
                   jg.gradients((feats, labels)), FN_RTOL, "gradients")
    flat = np.random.default_rng(4).normal(
        size=port.numParams()).astype(np.float32)
    port.setParams(flat)
    jg.setParams(flat)
    _close(port.getParam("da", "W").toNumpy(),
           np.asarray(jg.getParam("da", "W").numpy()), 0.0)
    for got, want in zip(port.output(*feats), jg.output(*feats)):
        _close(got.toNumpy(), want.toNumpy())
    batches = [_two_headed_data(n, 10 + n) for n in (6, 6, 5)]
    got = port.evaluate([port_datasets.MultiDataSet(list(f), list(l))
                         for f, l in batches])
    want = jg.evaluate([jax_datasets.MultiDataSet(list(f), list(l))
                        for f, l in batches])
    np.testing.assert_array_equal(np.asarray(got.confusionMatrix()),
                                  np.asarray(want.confusionMatrix()))
    assert port.summary() == jg.summary()


def _recurrent_graph(tbptt=None):
    nn = port_nn
    b = (nn.NeuralNetConfiguration.Builder().seed(5)
         .updater(port_updaters.Adam(5e-3)).graphBuilder()
         .addInputs("x")
         .setInputTypes(nn.InputType.recurrent(4))
         .addLayer("lstm", nn.LSTM.Builder().nOut(6).build(), "x")
         .addLayer("d", nn.DenseLayer.Builder().nOut(6)
                   .activation("identity").build(), "x")
         .addVertex("sum", nn.ElementWiseVertex("Add"), "lstm", "d")
         .addLayer("out", nn.RnnOutputLayer.Builder().nOut(3)
                   .activation("softmax").lossFunction("mcxent").build(),
                   "sum")
         .setOutputs("out"))
    if tbptt:
        b.tBPTTLength(tbptt)
    return ComputationGraph(b.build(), device="cpu").init()


def _sequences(n, t, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4, t)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (n, t))]
    return x, y.transpose(0, 2, 1).copy()


def test_tbptt_and_rnn_time_step_match_the_reference():
    port = _recurrent_graph(tbptt=4)
    jg = _jax_graph(port)
    assert port.conf.to_json() == jg.conf.to_json()
    x, y = _sequences(3, 10, 0)   # segments of 4, 4 and a padded 2
    port.fit((x, y))
    jg.fit((x, y))
    assert port.getIterationCount() == jg._iteration == 3
    assert abs(port.score() - jg.score()) <= FN_RTOL * abs(jg.score())
    _compare_graphs(port, jg, "tbptt")
    assert port._states["lstm"] == {}
    # streaming: two chunks and a single step continue one sequence
    x, _ = _sequences(2, 7, 1)
    for chunk in (x[:, :, :3], x[:, :, 3:6], x[:, :, 6]):
        _close(port.rnnTimeStep(chunk).toNumpy(),
               np.asarray(jg.rnnTimeStep(chunk).numpy()))
    port.rnnClearPreviousState()
    jg.rnnClearPreviousState()
    _close(port.rnnTimeStep(x).toNumpy(),
           np.asarray(jg.rnnTimeStep(x).numpy()))
    _close(port.rnnTimeStep(x).toNumpy()[:, :, -1],
           port.outputSingle(x).toNumpy()[:, :, -1], 1.0)


def test_a_node_read_twice_takes_both_gradients():
    """A block's input feeds its conv and its identity shortcut; the
    forward keeps no activation past its last reader."""
    port = _recurrent_graph()
    assert port._last_use["x"] == port.conf.topo_order.index("lstm")
    x, y = _sequences(2, 5, 3)
    jg = _jax_graph(port)
    _compare_trees(port.gradients((x, y)), jg.gradients((x, y)), FN_RTOL,
                   "gradients")
    env, _ = port._forward(port._params, port._states,
                           {"x": torch.tensor(x)})
    assert set(env) == {"out"}


# ---------------------------------------------------------------------------
# zips, serving
# ---------------------------------------------------------------------------

def _bn_graph():
    """Conv, BatchNormalization and a residual sum, Nesterovs."""
    nn = port_nn
    conf = (nn.NeuralNetConfiguration.Builder().seed(9)
            .updater(port_updaters.Nesterovs(1e-2, 0.9))
            .weightInit("relu").graphBuilder()
            .addInputs("in")
            .setInputTypes(nn.InputType.convolutional(6, 6, 2))
            .addLayer("c", nn.ConvolutionLayer.Builder().nOut(4)
                      .kernelSize([3, 3])
                      .convolutionMode(nn.ConvolutionMode.SAME).build(),
                      "in")
            .addLayer("bn", nn.BatchNormalization.Builder()
                      .activation("relu").build(), "c")
            .addLayer("c2", nn.ConvolutionLayer.Builder().nOut(4)
                      .kernelSize([1, 1]).build(), "bn")
            .addVertex("add", nn.ElementWiseVertex("Add"), "bn", "c2")
            .addLayer("gp", nn.GlobalPoolingLayer.Builder().build(), "add")
            .addLayer("out", nn.OutputLayer.Builder().nOut(3)
                      .activation("softmax").lossFunction("mcxent").build(),
                      "gp")
            .setOutputs("out").build())
    return ComputationGraph(conf, device="cpu").init()


def _images(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 2, 6, 6)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]


def test_zip_from_the_port_restores_in_the_jax_package(tmp_path):
    port = _bn_graph()
    for k in range(2):
        port.fit(_images(5, k))
    assert float(port._states["bn"]["var"].sub(1).abs().max()) > 0
    path = tmp_path / "port.zip"
    ModelSerializer.writeModel(port, str(path))
    jg = JaxSerializer.restoreComputationGraph(str(path))
    assert jg._iteration == 2
    _compare_graphs(port, jg, "port zip", rtol=0.0)
    x, y = _images(5, 7)
    _close(port.outputSingle(x).toNumpy(), jg.outputSingle(x).toNumpy())
    port.fit((x, y))
    jg.fit((x, y))
    _compare_graphs(port, jg, "port zip + 1 step", lr=1e-2)


def test_zip_from_the_jax_package_restores_in_the_port(tmp_path):
    jg = _jax_graph(_bn_graph())
    for k in range(2):
        jg.fit(_images(5, 20 + k))
    path = tmp_path / "jax.zip"
    JaxSerializer.writeModel(jg, str(path))
    port = ModelSerializer.restoreComputationGraph(str(path), device="cpu")
    assert port.getIterationCount() == 2
    _compare_graphs(port, jg, "jax zip", rtol=0.0)
    x, _ = _images(4, 8)
    _close(port.outputSingle(x).toNumpy(), jg.outputSingle(x).toNumpy())
    again = tmp_path / "again.zip"
    ModelSerializer.writeModel(port, str(again), saveUpdater=False)
    back = ModelSerializer.restoreComputationGraph(str(again), device="cpu")
    _compare_trees(back._params, jg._params, 0.0, "no updater")
    assert back.getIterationCount() == 0
    with pytest.raises(ValueError, match="not MultiLayerNetwork"):
        ModelSerializer.restoreMultiLayerNetwork(str(again), device="cpu")


def test_params_and_states_by_node_name():
    port = _bn_graph()
    arrays = _np(port._params)
    params = params_from_numpy(port.conf, arrays, "cpu")
    assert set(params) == set(port.conf.nodes) and params["add"] == {}
    states = states_from_numpy(port.conf, states_to_numpy(port._states),
                               "cpu")
    assert sorted(states["bn"]) == ["mean", "var"]
    assert set(opt_states_to_numpy(port._opt_states)) == \
        set(port.conf.nodes)
    del arrays["add"]
    with pytest.raises(ValueError, match="the graph has"):
        params_from_numpy(port.conf, arrays, "cpu")
    arrays["add"] = {}
    arrays["c"]["W"] = arrays["c"]["W"][:2]
    with pytest.raises(ValueError, match="node 'c'"):
        params_from_numpy(port.conf, arrays, "cpu")
    other = ComputationGraph(port.conf, device="cpu")
    with pytest.raises(ValueError, match="params"):
        other.init({"c": {}})


def test_graph_servable_serves_output_single():
    g = _bn_graph()
    g.fit(_images(6, 1))
    assert isinstance(as_servable(g, example_shape=(2, 6, 6)),
                      GraphServable)
    requests = [_images(n, 30 + n)[0] for n in (1, 3, 8, 2, 5, 1)]
    with InferenceSession(device="cpu", max_latency=0.01) as session:
        session.register("g", g, example_shape=(2, 6, 6),
                         ladder=(1, 4, 8), warmup=True)
        futures = [session.predict_async("g", x) for x in requests]
        answers = [f.result(timeout=60) for f in futures]
    for x, y in zip(requests, answers):
        assert y.shape == (x.shape[0], 3)
        _close(y, g.outputSingle(x).toNumpy())
    with pytest.raises(ValueError, match="single-input"):
        GraphServable(_two_headed(), (4,))


# ---------------------------------------------------------------------------
# the repairs: Nd4jBackend, RuntimeConfig, NeuralNetConfiguration.Builder
# ---------------------------------------------------------------------------

def test_top_level_exports_match_the_reference():
    for name in ("Nd4jBackend", "RuntimeConfig"):
        assert hasattr(jax_pkg, name) and hasattr(port_pkg, name)
    assert port_pkg.Nd4jBackend is Nd4jBackend
    assert port_pkg.RuntimeConfig is RuntimeConfig


def test_nd4j_backend_picks_as_the_reference(monkeypatch):
    for cls in (Nd4jBackend, JaxBackend):
        cls.reset()
    try:
        mine, theirs = Nd4jBackend.load(), JaxBackend.load()
        # no accelerator here: both fall back to the CPU, by priority
        assert (mine.name, mine.priority, mine.isAvailable()) == \
            (theirs.name, theirs.priority, theirs.isAvailable()) == \
            ("cpu", 0, True)
        assert Nd4jBackend.load() is mine   # memoized
        assert [b.name for b in Nd4jBackend.availableBackends()] == ["cpu"]
        assert Nd4jBackend.load(force="CPU") is Nd4jBackend.load("cpu")
        assert Nd4jBackend.devices() == [torch.device("cpu")]
        for cls, gpu in ((Nd4jBackend, "cuda"), (JaxBackend, "tpu")):
            with pytest.raises(RuntimeError, match="not available"):
                cls.load(force=gpu)
        # the JAX package's environment variable reroutes it; the port
        # reads none
        monkeypatch.setenv("DL4J_TPU_BACKEND", "tpu")
        with pytest.raises(RuntimeError, match="not available"):
            JaxBackend.load()
        assert Nd4jBackend.load().name == "cpu"
        # a card, as the port would see one
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        assert [(b.name, b.device_count) for b in
                Nd4jBackend.availableBackends()] == [("cuda", 2), ("cpu", 1)]
        Nd4jBackend.reset()
        assert Nd4jBackend.load().name == "cuda"
        assert Nd4jBackend.devices() == [torch.device("cuda", 0),
                                         torch.device("cuda", 1)]
    finally:
        for cls in (Nd4jBackend, JaxBackend):
            cls.reset()


def test_runtime_config_fields_and_refusals_against_the_reference():
    import dataclasses

    assert [(f.name, f.default) for f in dataclasses.fields(RuntimeConfig)
            if f.name != "extra_xla_flags"] == \
        [(f.name, f.default) for f in dataclasses.fields(JaxRuntimeConfig)
         if f.name != "extra_xla_flags"]
    assert RuntimeConfig.cpu_mesh(1) == RuntimeConfig(
        platform="cpu", host_device_count=1, matmul_precision="highest")
    assert dataclasses.asdict(RuntimeConfig.cpu_mesh(4)) == \
        dataclasses.asdict(JaxRuntimeConfig.cpu_mesh(4))
    for bad in ("high", "default"):
        with pytest.raises(ValueError, match="TF32"):
            RuntimeConfig(matmul_precision=bad).apply()
    from deeplearning4j_tpu_torch import runtime
    from deeplearning4j_tpu_torch.ndarray import ndarray as nd

    default = nd._default_device[0]
    try:   # n virtual devices are a CPU mesh of ["cpu"] * n
        assert RuntimeConfig.cpu_mesh(4).apply().host_device_count == 4
        assert runtime.virtual_cpu_devices() == [torch.device("cpu")] * 4
    finally:
        runtime._VIRTUAL["cpu"] = None
        nd._default_device[0] = default
    with pytest.raises(ValueError, match="XLA"):
        RuntimeConfig(extra_xla_flags=["--x"]).apply()
    with pytest.raises(RuntimeError, match="not available"):
        RuntimeConfig(platform="cuda").apply()
    before = torch.get_float32_matmul_precision()
    assert RuntimeConfig(matmul_precision="highest",
                         disable_jit=True).apply().disable_jit
    assert torch.get_float32_matmul_precision() == "highest"
    torch.set_float32_matmul_precision(before)
    env = RuntimeConfig.environment()
    want = JaxRuntimeConfig.environment()
    # (the JAX package's CPU counts the virtual host devices the tests
    # configure)
    assert (env["backend"], env["process_count"]) == \
        (want["backend"], want["process_count"]) == ("cpu", 1)
    assert env["device_count"] == 1
    assert env["torch_version"] == torch.__version__


@pytest.mark.parametrize("facade", ["trainingWorkspaceMode",
                                    "inferenceWorkspaceMode",
                                    "cudnnAlgoMode"])
def test_builder_facades_return_the_builder_and_leave_the_json(facade):
    def conf(nn, call):
        b = nn.NeuralNetConfiguration.Builder().seed(1)
        if call:
            assert getattr(b, facade)("PREFER_FASTEST") is b
        return (b.list().layer(nn.DenseLayer.Builder().nIn(3).nOut(2)
                               .build())
                .layer(nn.OutputLayer.Builder().nOut(2).build())
                .build().to_json())

    assert conf(port_nn, True) == conf(port_nn, False) == \
        conf(jax_nn, True) == conf(jax_nn, False)
    b = port_nn.NeuralNetConfiguration.Builder()
    assert getattr(b, facade)() is b
    assert not torch.backends.cudnn.benchmark
