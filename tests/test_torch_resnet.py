"""ResNet-50 (the zoo's ComputationGraph) in the port, against the JAX
package.

- ``ResNet50().conf()`` at its defaults and at other widths gives the
  JAX package's JSON, topological order and parameter count (the JAX
  package's ``_expected_num_params``: shapes only, nothing drawn), with
  53 conv and 53 BatchNormalization nodes; ``dataType="bfloat16"``
  (the uniform bf16 policy) gives the reference's JSON, and a narrow
  graph in bfloat16 holds its output, score and gradients to the JAX
  package's by the bf16 rule (its error against float32 at most 4 times
  the reference's own, never tighter than 4 unit roundoffs of 2^-8).
- A narrow residual graph (``NarrowResNet``): ResNet-50's stem and two
  bottlenecks, the first projected and the second an identity, at
  filters (8, 8, 32) on 32x32 input, with the port's weights in both
  packages: output, score and gradients to 1e-5 relative; 3 Nesterovs
  steps with a ragged last batch, each from the same state (the port's
  params, running statistics and velocity copied into the JAX graph
  before it): each step's loss to 1e-5 relative, the params, running
  means and variances and Nesterovs' velocity after it to 1e-4 of each
  array's largest element (never tighter than 1e-4 of the learning rate
  for the params and velocity: a conv bias ahead of BatchNormalization
  has a zero gradient in exact arithmetic); then ``evaluate`` and a zip
  restored in the JAX package. The JAX package's steps run eagerly
  (``jax.disable_jit()``), as the port's do, and each from the same
  state, not as two trajectories: ReLU's kink at 0 makes the gradient
  jump wherever an activation lies within rounding of it, so the
  result there depends on how the sums were rounded. At this graph's
  third step one activation of ``s2_1_out`` lies within 1e-6 of 0, and
  the JAX package's fused (jitted) step parts from its own eager step by
  1.5e-2 of ``bn1``'s beta gradient; the port agrees with the eager
  step to 1e-5.

The ``cuda`` case takes the narrow graph to the card against the CPU.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import datasets as jax_datasets
from deeplearning4j_tpu import nn as jax_nn
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.conf import graph_conf as jax_graph_conf
from deeplearning4j_tpu.optimize import updaters as jax_updaters
from deeplearning4j_tpu.utils.serializer import (
    ModelSerializer as JaxSerializer)
from deeplearning4j_tpu_torch import models as port_models
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.optimize import updaters as port_updaters
from deeplearning4j_tpu_torch.serving import InferenceSession
from deeplearning4j_tpu_torch.tree_util import tree_leaves
from deeplearning4j_tpu_torch.utils import ModelSerializer

FN_RTOL = 1e-5
TRAIN_RTOL = 1e-4
LR = 1e-2            # the zoo's Nesterovs(1e-2, 0.9)
CARD_TOL = 1e-4      # the card against the CPU, of the largest element
cuda = pytest.mark.cuda


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
    """Numpy copies; bfloat16 leaves (either package's) as the float32
    that holds them."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        # a copy: a JAX step that donates its buffers could otherwise
        # write into the port's tensors through a numpy view
        t = tree.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu() \
            .numpy().copy()
    a = np.asarray(tree)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


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


def _compare_graphs(port, jg, what, rtol=TRAIN_RTOL):
    _compare_trees(port._params, jg._params, rtol, f"{what} params",
                   rtol * LR)
    _compare_trees(port._states, jg._states, rtol, f"{what} states")
    _compare_trees(port._opt_states, jg._opt_states, rtol,
                   f"{what} velocity", rtol * LR)


# ---------------------------------------------------------------------------
# ResNet50().conf()
# ---------------------------------------------------------------------------

RESNETS = [{}, dict(numClasses=7, inputShape=(3, 64, 64), seed=5),
           dict(numClasses=10, inputShape=(3, 32, 48), updater="adam")]


def _updater(kw, pkg):
    kw = dict(kw)
    if kw.get("updater") == "adam":
        kw["updater"] = pkg.Adam(1e-4)
    return kw


@pytest.mark.parametrize("kw", RESNETS, ids=range(len(RESNETS)))
def test_resnet50_conf_is_the_reference_s(kw):
    conf = zoo.ResNet50(**_updater(kw, port_updaters)).conf()
    want = jax_zoo.ResNet50(**_updater(kw, jax_updaters)).conf()
    assert conf.to_json() == want.to_json()
    assert conf.topo_order == want.topo_order
    assert ComputationGraphConfiguration.from_json(
        want.to_json()).to_json() == want.to_json()
    kinds = [type(node).__name__ for node, _ in conf.nodes.values()]
    assert kinds.count("ConvolutionLayer") == 53
    assert kinds.count("BatchNormalization") == 53
    assert kinds.count("ElementWiseVertex") == 16
    n = sum(int(np.prod(s)) for node, _ in conf.nodes.values()
            if hasattr(node, "param_shapes")
            for s in node.param_shapes().values())
    assert n == jax_zoo._expected_num_params(want)


def test_resnet50_defaults_and_refusals():
    assert port_models.ResNet50 is zoo.ResNet50
    model = zoo.ResNet50()
    conf = model.conf()
    assert conf.defaults["updater"].to_json() == \
        jax_updaters.Nesterovs(1e-2, 0.9).to_json()
    assert conf.nodes["conv1"][0].param_shapes() == {
        "W": (64, 3, 7, 7), "b": (64,)}
    assert conf.nodes["s5_0_c3"][0].param_shapes()["W"] == (2048, 512, 1, 1)
    assert conf.nodes["out"][0].param_shapes()["W"] == (2048, 1000)
    assert conf.nodes["s4_0_add"][1] == ["s4_0_b3", "s4_0_projbn"]
    assert conf.nodes["s4_1_add"][1] == ["s4_1_b3", "s4_0_out"]
    # dataType="bfloat16" (the reference's uniform bf16 policy) at a small
    # width, against the JAX package from the same bf16 weights: the
    # output in training mode, the score and the gradients, each array's
    # error against the float32 graph on the same values at most
    # BF16_FACTOR times the JAX package's own, never held tighter than
    # BF16_FACTOR unit roundoffs of its largest element
    bf = zoo.ResNet50(dataType="bfloat16").conf()
    assert bf.to_json() == jax_zoo.ResNet50(dataType="bfloat16").conf(
        ).to_json()
    port = NarrowResNet(numClasses=5, inputShape=(3, 32, 32),
                        dataType="bfloat16").init(device="cpu")
    assert {v.dtype for v in tree_leaves(
        [port._params, port._states, port._opt_states])} == {torch.bfloat16}
    jg = _jax_graph(port)
    g32 = ComputationGraph(NarrowResNet(numClasses=5,
                                        inputShape=(3, 32, 32)).conf(),
                           device="cpu").init(
        {k: {n: v.float() for n, v in p.items()}
         for k, p in port._params.items()})
    j32 = _jax_graph(g32)
    x, y = _images(4, 0)
    outs = [g.outputSingle(x, train=True).toNumpy() for g in (port, jg, j32)]
    assert port.outputSingle(x).dataType() == torch.bfloat16
    _bf16_close(*outs, "output")
    _bf16_close(*(g.score((x, y)) for g in (port, jg, j32)), "score")
    grads = [dict(_leaves(_np(g.gradients((x, y))))) for g in (port, jg,
                                                                j32)]
    assert sorted(grads[0]) == sorted(grads[1]) == sorted(grads[2])
    for k in grads[2]:
        _bf16_close(grads[0][k], grads[1][k], grads[2][k], k)


BF16_UNIT = 2.0 ** -8   # bfloat16's unit roundoff
BF16_FACTOR = 4


def _bf16_close(got, ref, f32, what):
    got, ref, f32 = (np.asarray(a, np.float64) for a in (got, ref, f32))
    e_port = float(np.abs(got - f32).max())
    e_ref = float(np.abs(ref - f32).max())
    assert e_port <= BF16_FACTOR * max(
        e_ref, BF16_UNIT * float(np.abs(f32).max())), (what, e_port, e_ref)


# ---------------------------------------------------------------------------
# a narrow residual graph against the JAX package
# ---------------------------------------------------------------------------

class NarrowResNet(zoo.ResNet50):
    """ResNet-50's stem, one projected and one identity bottleneck."""

    STAGES = (("s2", 2, (8, 8, 32), 1),)


def _narrow():
    return NarrowResNet(numClasses=5, inputShape=(3, 32, 32)).init(
        device="cpu")


def _jax_graph(port):
    """The JAX package's graph from the port's configuration JSON on the
    port's params and layer states; its ``init`` draws nothing."""
    jconf = jax_graph_conf.ComputationGraphConfiguration.from_json(
        port.conf.to_json())
    params = _np(port._params)
    for name, (node, _) in jconf.nodes.items():
        if isinstance(node, jax_nn.layers.BaseLayer):
            node.init_params = lambda key, dtype, p=params[name]: \
                jax.tree_util.tree_map(
                    lambda a: jnp.asarray(a).astype(dtype), p)
    jg = jax_nn.ComputationGraph(jconf).init()
    for node, _ in jconf.nodes.values():
        node.__dict__.pop("init_params", None)
    dtype = jconf.precision_policy.param_jnp
    jg._states = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(dtype), _np(port._states))
    return jg


def _images(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3, 32, 32)).astype(np.float32)
    return x, np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)]


def _as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, _np(tree))


@pytest.fixture(scope="module")
def narrow_pair():
    """The narrow graph in both packages after 3 Nesterovs steps on
    batches of 6, 6 and a ragged 4 (padded to 6), each step from the
    port's state; with each step's losses and, after each, both packages'
    params, states and velocities as numpy."""
    port = _narrow()
    jg = _jax_graph(port)
    losses, after = [], []
    for n, seed in ((6, 1), (6, 2), (4, 3)):
        jg._params, jg._states, jg._opt_states = (
            _as_jax(port._params), _as_jax(port._states),
            _as_jax(port._opt_states))
        x, y = _images(n, seed)
        port.fit(DataSet(x, y))
        with jax.disable_jit():
            jg.fit(jax_datasets.DataSet(x, y))
        losses.append((port.score(), jg.score()))
        after.append([_np(t) for t in (
            port._params, port._states, port._opt_states, jg._params,
            jg._states, jg._opt_states)])
    return port, jg, losses, after


def test_narrow_graph_output_score_and_gradients_match():
    port = _narrow()
    jg = _jax_graph(port)
    assert port.conf.topo_order == jg.conf.topo_order
    assert len(port.conf.topo_order) == 23
    x, y = _images(4, 0)
    _close(port.outputSingle(x).toNumpy(), jg.outputSingle(x).toNumpy())
    _close(port.score((x, y)), jg.score((x, y)))
    _compare_trees(port.gradients((x, y)), jg.gradients((x, y)), FN_RTOL,
                   "gradients")
    # both of the block input's readers (c1 and the projection) train
    grads = port.gradients((x, y))
    assert float(grads["s2_0_proj"]["W"].abs().max()) > 0
    assert float(grads["s2_0_c1"]["W"].abs().max()) > 0


def test_narrow_graph_trains_as_the_reference(narrow_pair):
    port, jg, losses, after = narrow_pair
    assert port._bucket == 6 and port.getIterationCount() == 3
    for step, (got, want) in enumerate(losses):
        assert abs(got - want) <= FN_RTOL * abs(want), (step, got, want)
    for step, arrays in enumerate(after):
        mine = SimpleNamespace(_params=arrays[0], _states=arrays[1],
                               _opt_states=arrays[2])
        theirs = SimpleNamespace(_params=arrays[3], _states=arrays[4],
                                 _opt_states=arrays[5])
        _compare_graphs(mine, theirs, f"step {step}")
    # every BatchNormalization node, the projection's included, moved its
    # running statistics
    bns = [n for n, (node, _) in port.conf.nodes.items()
           if type(node).__name__ == "BatchNormalization"]
    assert "s2_0_projbn" in bns and len(bns) == 8
    for name in bns:
        assert float(port._states[name]["mean"].abs().max()) > 0, name


def test_narrow_graph_evaluates_and_zips_as_the_reference(narrow_pair,
                                                           tmp_path):
    port, jg, _, _ = narrow_pair
    batches = [_images(n, 20 + n) for n in (6, 6, 3)]
    got = port.evaluate(ListDataSetIterator([DataSet(*b) for b in batches]))
    want = jg.evaluate([jax_datasets.DataSet(*b) for b in batches])
    np.testing.assert_array_equal(np.asarray(got.confusionMatrix()),
                                  np.asarray(want.confusionMatrix()))
    path = tmp_path / "narrow.zip"
    ModelSerializer.writeModel(port, str(path))
    back = JaxSerializer.restoreComputationGraph(str(path))
    _compare_graphs(port, back, "zip", rtol=0.0)
    assert back._iteration == 3
    x, _ = _images(6, 40)
    _close(port.outputSingle(x).toNumpy(), back.outputSingle(x).toNumpy())


def test_narrow_graph_serves_output_single(narrow_pair):
    port = narrow_pair[0]
    requests = [_images(n, 50 + n)[0] for n in (1, 5, 2, 8)]
    with InferenceSession(device="cpu", max_latency=0.01) as session:
        session.register("resnet", port, example_shape=(3, 32, 32),
                         ladder=(1, 4, 8), warmup=True)
        answers = [f.result(timeout=60) for f in
                   [session.predict_async("resnet", x) for x in requests]]
    for x, y in zip(requests, answers):
        _close(y, port.outputSingle(x).toNumpy())


# the reference's tests/test_models.py::TestZoo ResNet-50 cases, on the port
@pytest.mark.slow
def test_resnet50_structure_and_forward():
    net = zoo.ResNet50(numClasses=7, inputShape=(3, 64, 64)).init(
        device="cpu")
    n_conv = sum(1 for name in net.conf.topo_order
                 if type(net.conf.nodes[name][0]).__name__ ==
                 "ConvolutionLayer")
    assert n_conv == 53, n_conv
    x = np.random.default_rng(0).normal(size=(2, 3, 64, 64)).astype(
        np.float32)
    out = net.output(x)[0]
    assert out.shape() == (2, 7)
    np.testing.assert_allclose(out.numpy().sum(axis=1), 1.0, rtol=1e-4)


@pytest.mark.slow
def test_resnet50_short_fit():
    net = zoo.ResNet50(numClasses=3, inputShape=(3, 32, 32),
                       updater=port_updaters.Adam(1e-4)).init(device="cpu")
    rng = np.random.default_rng(0)
    X = rng.normal(size=(8, 3, 32, 32)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    s0 = net.score((X, y))
    net.fit([(X, y)], 3)
    assert net.score((X, y)) < s0 * 1.5  # moves without blowing up


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@cuda
def test_cuda_narrow_graph_trains_and_serves_as_the_cpu(card, tmp_path):
    """The narrow graph on the card and on the CPU from the same weights:
    output and the first step's loss to CARD_TOL; each of 3 Nesterovs
    steps from the card's state (max pooling's argmax may flip on a
    near-tie between devices, so trajectories are not compared): losses
    to CARD_TOL relative; params, running statistics and velocity to
    CARD_TOL of each array's largest element (never tighter than CARD_TOL
    of lr for params and velocity);
    served rows equal ``outputSingle``; a zip restored on the card
    bit-equal."""
    assert torch.backends.cudnn.conv.fp32_precision == "ieee"
    gpu = NarrowResNet(numClasses=5, inputShape=(3, 32, 32)).init()
    cpu = _narrow()
    assert gpu.device.type == "cuda"
    x, y = _images(6, 0)
    _close(gpu.outputSingle(x).toNumpy(), cpu.outputSingle(x).toNumpy(),
           CARD_TOL)
    for n, seed in ((6, 1), (6, 2), (4, 3)):
        with torch.no_grad():
            for a, b in zip(tree_leaves([gpu._params, gpu._states,
                                         gpu._opt_states]),
                            tree_leaves([cpu._params, cpu._states,
                                         cpu._opt_states])):
                b.copy_(a)
        ds = DataSet(*_images(n, seed))
        gpu.fit(ds)
        cpu.fit(ds)
        assert abs(gpu.score() - cpu.score()) <= CARD_TOL * cpu.score()
        _compare_graphs(gpu, cpu, f"card step {seed}", CARD_TOL)
    requests = [_images(n, 60 + n)[0] for n in (1, 7, 3)]
    with InferenceSession(max_latency=0.01) as session:
        session.register("resnet", gpu, example_shape=(3, 32, 32),
                         ladder=(1, 4, 8), warmup=True)
        for r in requests:
            _close(session.predict("resnet", r),
                   gpu.outputSingle(r).toNumpy())
    path = tmp_path / "narrow.zip"
    ModelSerializer.writeModel(gpu, str(path))
    back = ModelSerializer.restoreComputationGraph(str(path))
    assert back.device.type == "cuda"
    np.testing.assert_array_equal(back.outputSingle(x).toNumpy(),
                                  gpu.outputSingle(x).toNumpy())
