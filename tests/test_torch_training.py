"""Training in the port against training in the JAX package.

A configuration is built in the JAX package; its JSON and weights (and, in
the checkpoint tests, its updater state) move into the port. The same
batches, made with numpy from a seed, then go through both:

- the char-RNN's ``gradients``; ``fit`` with Sgd and with Adam over 3
  steps with a ragged final batch; a TBPTT fit with a ragged tail segment;
- the four gradient normalization modes, with L1 and L2;
- ``params``/``setParams`` in the JAX package's order;
- the ModelSerializer zip with updater state, written by either package
  and restored by the other, continuing identically for one step.

Tolerances (float32 on the CPU; the two frameworks sum in different
orders): losses 1e-6 abs / 1e-5 rel; gradients 1e-6 abs / 1e-4 rel;
params after training 1e-6 abs / 1e-5 rel. An Adam step moves each
weight by about lr·sign(g), so a gradient so close to zero that its sign
depends on the summation order could move a weight by up to 2·lr; the
batches here leave no such element, and the test names the element that
differs if one appears.
"""

import numpy as np
import pytest
import jax
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.iterator import (
    ListDataSetIterator as JaxListIterator)
from deeplearning4j_tpu.models.zoo import TextGenerationLSTM as JaxCharRnn
from deeplearning4j_tpu.nn.conf import configuration as jax_configuration
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize import updaters as jax_updaters
from deeplearning4j_tpu.utils.serializer import (
    ModelSerializer as JaxSerializer)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import (
    GradientNormalization, MultiLayerNetwork)
from deeplearning4j_tpu_torch.utils.convert import (
    opt_states_from_numpy, opt_states_to_numpy, params_from_numpy)
from deeplearning4j_tpu_torch.utils.serializer import ModelSerializer

VOCAB, HIDDEN, SEQ = 11, 16, 6
FN_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is as fast, and leaves the cores
    to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return np.asarray(tree)


def _assert_trees_close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _assert_trees_close(got[k], want[k], tol, f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_close(g, w, tol, f"{what}[{i}]")
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **tol)


def _port_of(jax_net):
    """The port's network with the JAX network's configuration, weights
    and updater state, on the CPU."""
    conf = MultiLayerConfiguration.from_json(jax_net.conf.to_json())
    net = MultiLayerNetwork(conf, device="cpu").init(
        params_from_numpy(conf, _np(jax_net._params), "cpu"))
    net._opt_states = opt_states_from_numpy(conf, _np(jax_net._opt_states),
                                            "cpu")
    return net


def _one_hot(n, t, seed):
    idx = np.random.default_rng(seed).integers(0, VOCAB, size=(n, t + 1))
    eye = np.eye(VOCAB, dtype=np.float32)
    f = eye[idx[:, :-1]].transpose(0, 2, 1).copy()
    l = eye[idx[:, 1:]].transpose(0, 2, 1).copy()   # next character
    return f, l


def _char_rnn(updater, seed=123):
    return JaxCharRnn(vocabSize=VOCAB, hidden=HIDDEN, seqLength=SEQ,
                      seed=seed, updater=updater).init()


# -- the network --------------------------------------------------------------

def test_gradients_match_jax():
    jnet = _char_rnn(jax_updaters.Adam(2e-3))
    net = _port_of(jnet)
    f, l = _one_hot(5, SEQ, seed=1)
    # jitted: the same function, and seconds faster than op by op here
    want = jax.jit(jnet.gradients)(f, l)
    got = net.gradients(f, l)
    _assert_trees_close(got, want, GRAD_TOL, "gradients")
    grads, score = net.computeGradientAndScore(f, l)
    _assert_trees_close(grads, want, GRAD_TOL, "computeGradientAndScore")
    np.testing.assert_allclose(score, jnet.score(JaxDataSet(f, l)), **FN_TOL)
    np.testing.assert_allclose(net.score(DataSet(f, l)), score, **FN_TOL)


@pytest.mark.parametrize("updater", ["Sgd", "Adam"])
def test_fit_matches_jax_with_a_ragged_final_batch(updater):
    up = (jax_updaters.Sgd(0.1) if updater == "Sgd"
          else jax_updaters.Adam(2e-3))
    jnet = _char_rnn(up)
    net = _port_of(jnet)
    batches = [_one_hot(n, SEQ, seed=10 + n) for n in (4, 4, 3)]
    jnet.fit(JaxListIterator([JaxDataSet(f, l) for f, l in batches]))
    net.fit(ListDataSetIterator([DataSet(f, l) for f, l in batches]))
    assert net.getIterationCount() == jnet.getIterationCount() == 3
    assert net.getEpochCount() == jnet.getEpochCount() == 1
    assert net._bucket == 4
    _assert_trees_close(net._params, jnet._params, PARAM_TOL, "params")
    _assert_trees_close(net._opt_states, jnet._opt_states, PARAM_TOL,
                        "updater state")
    np.testing.assert_allclose(net.score(), jnet.score(), **FN_TOL)


def test_fit_entry_forms_agree():
    """fit(features, labels), fit(DataSet) and fit(iterator, epochs) on the
    same batch take the same steps."""
    f, l = _one_hot(4, SEQ, seed=3)
    jnet = _char_rnn(jax_updaters.Adam(2e-3))
    nets = [_port_of(jnet) for _ in range(3)]
    nets[0].fit(f, l)
    nets[0].fit(DataSet(f, l))
    nets[1].fit(ListDataSetIterator([DataSet(f, l)]), 2)
    nets[2].fit(DataSet(f, l))
    nets[2].fit(f, l)
    for net in nets[1:]:
        assert net.getIterationCount() == 2
        _assert_trees_close(net._params, nets[0]._params,
                            dict(rtol=0, atol=0), "entry forms")
    assert nets[1].getEpochCount() == 2


def _tbptt_conf(seg):
    b = (jax_configuration.NeuralNetConfiguration.Builder().seed(5)
         .updater(jax_updaters.Adam(5e-3)).list()
         .layer(jax_layers.LSTM.Builder().nOut(HIDDEN).build())
         .layer(jax_layers.RnnOutputLayer.Builder().nOut(VOCAB)
                .activation("softmax").lossFunction("mcxent").build())
         .setInputType(JaxInputType.recurrent(VOCAB, 7)))
    return b.tBPTTLength(seg).build()


def test_tbptt_matches_jax():
    jnet = JaxNet(_tbptt_conf(3)).init()
    net = _port_of(jnet)
    assert net.conf.tbpttLength == 3
    f, l = _one_hot(4, 7, seed=8)   # 7 steps: segments 3, 3 and 1 (padded)
    m = np.ones((4, 7), np.float32)
    m[1, 5:] = 0.0
    jnet.fit(JaxDataSet(f, l, labelsMask=m))
    net.fit(DataSet(f, l, labelsMask=m))
    assert net.getIterationCount() == jnet.getIterationCount() == 3
    assert net._states == [{}, {}]
    _assert_trees_close(net._params, jnet._params, PARAM_TOL, "params")
    np.testing.assert_allclose(net.score(), jnet.score(), **FN_TOL)


@pytest.mark.parametrize("mode", [
    GradientNormalization.ClipL2PerLayer,
    GradientNormalization.ClipL2PerParamType,
    GradientNormalization.ClipElementWiseAbsoluteValue,
    GradientNormalization.RenormalizeL2PerLayer])
def test_gradient_normalization_and_l1_l2_match_jax(mode):
    conf = (jax_configuration.NeuralNetConfiguration.Builder().seed(2)
            .updater(jax_updaters.Sgd(0.5)).l1(1e-3).l2(5e-3)
            .gradientNormalization(mode, 0.05).list()
            .layer(jax_layers.DenseLayer.Builder().nIn(6).nOut(8)
                   .activation("tanh").build())
            .layer(jax_layers.OutputLayer.Builder().nOut(3)
                   .activation("softmax").lossFunction("mcxent").build())
            .build())
    jnet = JaxNet(conf).init()
    net = _port_of(jnet)
    assert net.layers[0].gradientNormalization == mode
    rng = np.random.default_rng(4)
    f = rng.normal(size=(5, 6)).astype(np.float32)
    l = np.eye(3, dtype=np.float32)[rng.integers(0, 3, size=5)]
    for _ in range(2):
        jnet.fit(f, l)
        net.fit(f, l)
    _assert_trees_close(net._params, jnet._params, PARAM_TOL, mode)
    np.testing.assert_allclose(net.score(DataSet(f, l)),
                               jnet.score(JaxDataSet(f, l)), **FN_TOL)


def test_params_and_set_params_in_jax_order():
    jnet = _char_rnn(jax_updaters.Adam(2e-3))
    net = _port_of(jnet)
    flat = jnet.params().toNumpy()
    np.testing.assert_array_equal(net.params().numpy(), flat)
    assert net.numParams() == flat.size
    assert sorted(net.paramTable()) == sorted(jnet.paramTable())
    new = np.random.default_rng(0).normal(size=flat.shape).astype(np.float32)
    net.setParams(new)
    jnet.setParams(new)
    np.testing.assert_array_equal(net.params().numpy(), new)
    _assert_trees_close(net._params, jnet._params, dict(rtol=0, atol=0),
                        "setParams")
    net.setParam(1, "b", np.ones(4 * HIDDEN, np.float32))
    assert float(net.getParam(1, "b").sum()) == 4 * HIDDEN
    with pytest.raises(ValueError):
        net.setParams(new[:-1])


def test_dropout_is_inverted_and_seeded_by_iteration():
    conf = (jax_configuration.NeuralNetConfiguration.Builder().seed(9)
            .dropOut(0.5).list()
            .layer(jax_layers.DenseLayer.Builder().nIn(64).nOut(4).build())
            .layer(jax_layers.OutputLayer.Builder().nOut(2).build())
            .build())
    net = _port_of(JaxNet(conf).init())
    layer = net.layers[0]
    x = torch.ones((8, 64))
    y = layer._dropout(x, True, net._dropout_generator(3))
    assert set(torch.unique(y).tolist()) <= {0.0, 2.0}   # kept / p
    assert 0.2 < float((y > 0).float().mean()) < 0.8
    assert torch.equal(y, layer._dropout(x, True, net._dropout_generator(3)))
    assert not torch.equal(y, layer._dropout(x, True,
                                             net._dropout_generator(4)))
    # inference, or no generator: identity
    assert torch.equal(layer._dropout(x, False, net._dropout_generator(3)), x)
    assert torch.equal(layer._dropout(x, True, None), x)


# -- checkpoints ----------------------------------------------------------------

def test_port_zip_restores_in_jax_and_continues_identically(tmp_path):
    jnet = _char_rnn(jax_updaters.Adam(2e-3))
    net = _port_of(jnet)
    f, l = _one_hot(4, SEQ, seed=31)
    net.fit(f, l)
    path = str(tmp_path / "port.zip")
    ModelSerializer.writeModel(net, path)
    restored = JaxSerializer.restoreMultiLayerNetwork(path)
    assert restored.getIterationCount() == 1
    _assert_trees_close(restored._params, net._params, dict(rtol=0, atol=0),
                        "params")
    _assert_trees_close(restored._opt_states, net._opt_states,
                        dict(rtol=0, atol=0), "updater state")
    f2, l2 = _one_hot(4, SEQ, seed=32)
    restored.fit(f2, l2)
    net.fit(f2, l2)
    _assert_trees_close(net._params, restored._params, PARAM_TOL, "step")


def test_jax_zip_restores_in_port_and_continues_identically(tmp_path):
    jnet = _char_rnn(jax_updaters.Adam(2e-3))
    f, l = _one_hot(4, SEQ, seed=41)
    jnet.fit(f, l)
    path = str(tmp_path / "jax.zip")
    JaxSerializer.writeModel(jnet, path)
    net = ModelSerializer.restoreMultiLayerNetwork(path, device="cpu")
    assert net.getIterationCount() == 1 and net.getEpochCount() == 1
    _assert_trees_close(net._opt_states, jnet._opt_states,
                        dict(rtol=0, atol=0), "updater state")
    assert opt_states_to_numpy(net._opt_states)[2]["m"]["W"].shape == (
        HIDDEN, VOCAB)
    f2, l2 = _one_hot(4, SEQ, seed=42)
    jnet.fit(f2, l2)
    net.fit(f2, l2)
    _assert_trees_close(net._params, jnet._params, PARAM_TOL, "step")
    _assert_trees_close(net._opt_states, jnet._opt_states, PARAM_TOL,
                        "updater state after the step")
    # without the updater: fresh state and counters
    fresh = ModelSerializer.restoreMultiLayerNetwork(path, loadUpdater=False,
                                                     device="cpu")
    assert fresh.getIterationCount() == 0
    assert float(fresh._opt_states[0]["m"]["W"].abs().sum()) == 0.0
