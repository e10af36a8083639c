"""The port's GRU ops and a GRU char-RNN against the JAX package's.

- ``gruCell`` and ``gruLayer`` (both conventions, with and without the
  recurrent half of the bias, and another activation) against
  ``deeplearning4j_tpu.autodiff.ops.OPS``, values and gradients.
- A small Embedding -> GRU(resetAfter=True) -> RnnOutput net (vocab 11,
  embedding 8, GRU 16, T=7, N=3), the shape of the GRU char-RNN that
  chip_smoke.py trains at full width, built in the JAX package: its JSON
  and weights (random, from a numpy seed, biases included) move into the
  port. Token ids, as ints or as the floats that serving sends, then go
  through ``output``, ``rnnTimeStep``, ``gradients``, 3 Adam ``fit`` steps
  and the ModelSerializer zip in both directions.

Tolerances, float32 on the CPU (the two frameworks sum in different
orders): values 1e-5 abs/rel; gradients 1e-6 abs / 1e-4 rel; params after
training 1e-6 abs / 1e-5 rel.
"""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.autodiff.ops import OPS as JAX_OPS
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.conf import configuration as jax_configuration
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize import updaters as jax_updaters
from deeplearning4j_tpu.utils.serializer import (
    ModelSerializer as JaxSerializer)
from deeplearning4j_tpu_torch.autodiff import ops
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    GRU, EmbeddingLayer, EmbeddingSequenceLayer, OutputLayer,
    RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.convert import (
    opt_states_from_numpy, params_from_numpy)
from deeplearning4j_tpu_torch.utils.serializer import ModelSerializer

VOCAB, EMBED, HIDDEN, SEQ = 11, 8, 16, 7
FN_TOL = dict(rtol=1e-5, atol=1e-5)
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


# -- the ops ------------------------------------------------------------------

def _gru_arrays(n, i, t, h, nb, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * sc).astype(np.float32)
            for s, sc in (((n, i, t), 1.0), ((i, 3 * h), 0.3),
                          ((h, 3 * h), 0.3), ((nb,), 0.2), ((n, h), 0.3))]


def test_gru_cell_matches_jax():
    n, i, h = 4, 5, 6
    rng = np.random.default_rng(1)
    x, hp, w, r, b = [(rng.normal(size=s) * 0.4).astype(np.float32)
                      for s in ((n, i), (n, h), (i, 3 * h), (h, 3 * h),
                                (6 * h,))]
    want = JAX_OPS["gruCell"](*map(jnp.asarray, (x, hp, w, r, b)))
    got = ops.gruCell(*map(torch.from_numpy, (x, hp, w, r, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)
    want = JAX_OPS["gruCell"](*map(jnp.asarray, (x, hp, w, r)))
    got = ops.gruCell(*map(torch.from_numpy, (x, hp, w, r)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)


@pytest.mark.parametrize("reset_after,nb,activation", [
    (True, 36, "tanh"),       # the kernel route, recurrent bias
    (True, 18, "tanh"),       # the kernel route, rb = 0
    (True, 36, "softsign"),   # the plain loop
    (False, 18, "tanh"),      # the plain loop, reset-before
])
def test_gru_layer_matches_jax(reset_after, nb, activation):
    n, i, t, h = 3, 5, 4, 6
    arrays = _gru_arrays(n, i, t, h, nb, seed=nb + reset_after)
    probe = np.random.default_rng(2).normal(size=(n, h, t)).astype(
        np.float32)

    def jax_loss(x, w, r, b, h0):
        out, hT = JAX_OPS["gruLayer"](x, w, r, b, h0=h0,
                                      resetAfter=reset_after,
                                      activation=activation)
        return jnp.sum(out * probe) + jnp.sum(hT * hT), (out, hT)

    (_, (out_j, hT_j)), want = jax.value_and_grad(
        jax_loss, argnums=tuple(range(5)), has_aux=True)(
            *map(jnp.asarray, arrays))
    ins = [torch.tensor(a, requires_grad=True) for a in arrays]
    out, hT = ops.gruLayer(*ins[:4], h0=ins[4], resetAfter=reset_after,
                           activation=activation)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               **FN_TOL)
    np.testing.assert_allclose(hT.detach().numpy(), np.asarray(hT_j),
                               **FN_TOL)
    loss = (out * torch.from_numpy(probe)).sum() + (hT * hT).sum()
    got = torch.autograd.grad(loss, ins)
    for g, wv, name in zip(got, want, ("x", "W", "R", "b", "h0")):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), **GRAD_TOL,
                                   err_msg=name)


# -- the network --------------------------------------------------------------

def _jax_conf(reset_after=True, updater=None):
    return (jax_configuration.NeuralNetConfiguration.Builder().seed(7)
            .updater(updater or jax_updaters.Adam(1e-2)).list()
            .layer(jax_layers.EmbeddingSequenceLayer.Builder().nIn(VOCAB)
                   .nOut(EMBED).build())
            .layer(jax_layers.GRU.Builder().nOut(HIDDEN)
                   .resetAfter(reset_after).build())
            .layer(jax_layers.RnnOutputLayer.Builder().nOut(VOCAB)
                   .activation("softmax").lossFunction("mcxent").build())
            .setInputType(JaxInputType.recurrent(VOCAB, SEQ)).build())


def _random_params(net, seed=3):
    """Weights from a numpy seed, biases included, in both nets."""
    rng = np.random.default_rng(seed)
    arrays = [{k: (rng.normal(size=np.shape(v)) * 0.3).astype(np.float32)
               for k, v in p.items()} for p in net._params]
    net._params = [{k: jnp.asarray(v) for k, v in p.items()}
                   for p in arrays]
    return arrays


@pytest.fixture(scope="module")
def nets():
    """(JAX net, its numpy weights); the port's copy is made per test."""
    jnet = JaxNet(_jax_conf()).init()
    return jnet, _random_params(jnet)


def _port_of(jnet, arrays):
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    net = MultiLayerNetwork(conf, device="cpu").init(
        params_from_numpy(conf, arrays, "cpu"))
    net._opt_states = opt_states_from_numpy(conf, _np(jnet._opt_states),
                                            "cpu")
    return net


def _tokens(n, t, seed):
    """Token ids [n, 1, t] (float32, as served and as the JAX package's
    fit feeds them) and next-token one-hot labels [n, VOCAB, t]."""
    idx = np.random.default_rng(seed).integers(0, VOCAB, size=(n, t + 1))
    labels = np.eye(VOCAB, dtype=np.float32)[idx[:, 1:]].transpose(0, 2, 1)
    return idx[:, None, :-1].astype(np.float32), labels.copy()


def test_configuration_json_round_trip():
    text = _jax_conf().to_json()
    conf = MultiLayerConfiguration.from_json(text)
    assert json.loads(conf.to_json()) == json.loads(text)
    assert [lr.nIn for lr in conf.layers] == [VOCAB, EMBED, HIDDEN]
    assert conf.layers[1].param_shapes() == {
        "W": (EMBED, 3 * HIDDEN), "R": (HIDDEN, 3 * HIDDEN),
        "b": (6 * HIDDEN,)}
    # the port's DSL builds the same configuration itself
    own = (NeuralNetConfiguration.Builder().seed(7)
           .updater(conf.defaults["updater"]).list()
           .layer(EmbeddingSequenceLayer.Builder().nIn(VOCAB).nOut(EMBED)
                  .build())
           .layer(GRU.Builder().nOut(HIDDEN).resetAfter(True).build())
           .layer(RnnOutputLayer.Builder().nOut(VOCAB).activation("softmax")
                  .lossFunction("mcxent").build())
           .setInputType(InputType.recurrent(VOCAB, SEQ)).build())
    assert json.loads(own.to_json()) == json.loads(text)
    assert own.layers[1].param_shapes() == conf.layers[1].param_shapes()
    # reset-before keeps a 3H bias
    before = MultiLayerConfiguration.from_json(_jax_conf(False).to_json())
    assert before.layers[1].param_shapes()["b"] == (3 * HIDDEN,)


@pytest.mark.parametrize("form", ["int [N,T]", "int [N,1,T]",
                                  "float [N,1,T]"])
def test_output_matches_jax(nets, form):
    jnet, arrays = nets
    f, _ = _tokens(3, SEQ, seed=1)
    x = {"int [N,T]": f[:, 0].astype(np.int64),
         "int [N,1,T]": f.astype(np.int64), "float [N,1,T]": f}[form]
    got = _port_of(jnet, arrays).output(x)
    assert got.shape == (3, VOCAB, SEQ)
    np.testing.assert_allclose(got.numpy(), jnet.output(f).toNumpy(),
                               **FN_TOL)


def test_rnn_time_step_matches_jax(nets):
    jnet, arrays = nets
    port = _port_of(jnet, arrays)
    f, _ = _tokens(2, SEQ, seed=5)
    ids = f[:, 0].astype(np.int64)
    jnet.rnnClearPreviousState()
    for k in range(4):   # single steps: ids [N, 1]
        np.testing.assert_allclose(
            port.rnnTimeStep(ids[:, k:k + 1]).numpy(),
            jnet.rnnTimeStep(ids[:, k:k + 1]).toNumpy(), **FN_TOL)
    assert port.rnnGetPreviousState(1)["h"].shape == (2, HIDDEN)
    # then a chunk [N, 1, T] continuing the same sequence
    np.testing.assert_allclose(port.rnnTimeStep(f[:, :, 4:]).numpy(),
                               jnet.rnnTimeStep(f[:, :, 4:]).toNumpy(),
                               **FN_TOL)
    jnet.rnnClearPreviousState()
    # the streamed steps equal the whole-sequence output
    port.rnnClearPreviousState()
    steps = np.stack([port.rnnTimeStep(ids[:, k:k + 1]).numpy()
                      for k in range(SEQ)], axis=-1)
    np.testing.assert_allclose(steps, port.output(ids).numpy(), **FN_TOL)


def test_gradients_match_jax(nets):
    jnet, arrays = nets
    net = _port_of(jnet, arrays)
    f, l = _tokens(3, SEQ, seed=2)
    want = jax.jit(jnet.gradients)(f, l)
    _assert_trees_close(net.gradients(f, l), want, GRAD_TOL, "gradients")
    _assert_trees_close(net.gradients(f.astype(np.int64), l), want,
                        GRAD_TOL, "gradients, int ids")


def test_fit_matches_jax():
    jnet = JaxNet(_jax_conf()).init()
    arrays = _random_params(jnet, seed=4)
    net = _port_of(jnet, arrays)
    for k in range(3):
        f, l = _tokens(3, SEQ, seed=10 + k)
        jnet.fit(JaxDataSet(f, l))
        net.fit(DataSet(f, l))
    assert net.getIterationCount() == jnet.getIterationCount() == 3
    _assert_trees_close(net._params, jnet._params, PARAM_TOL, "params")
    _assert_trees_close(net._opt_states, jnet._opt_states, PARAM_TOL,
                        "updater state")
    np.testing.assert_allclose(net.score(), jnet.score(), **FN_TOL)


def test_port_zip_restores_in_jax_and_back(tmp_path):
    jnet = JaxNet(_jax_conf()).init()
    net = _port_of(jnet, _random_params(jnet, seed=6))
    f, l = _tokens(3, SEQ, seed=20)
    net.fit(f, l)
    path = str(tmp_path / "port.zip")
    ModelSerializer.writeModel(net, path)
    restored = JaxSerializer.restoreMultiLayerNetwork(path)
    assert restored.getIterationCount() == 1
    _assert_trees_close(restored._params, net._params, dict(rtol=0, atol=0),
                        "params")
    _assert_trees_close(restored._opt_states, net._opt_states,
                        dict(rtol=0, atol=0), "updater state")
    # and the JAX package's own zip of it back into the port
    path2 = str(tmp_path / "jax.zip")
    JaxSerializer.writeModel(restored, path2)
    back = ModelSerializer.restoreMultiLayerNetwork(path2, device="cpu")
    _assert_trees_close(back._params, net._params, dict(rtol=0, atol=0),
                        "params back")
    _assert_trees_close(back._opt_states, net._opt_states,
                        dict(rtol=0, atol=0), "updater state back")
    f2, l2 = _tokens(3, SEQ, seed=21)
    back.fit(f2, l2)
    restored.fit(JaxDataSet(f2, l2))
    _assert_trees_close(back._params, restored._params, PARAM_TOL, "step")


def test_embedding_layer_lookup_and_one_hot():
    conf = (NeuralNetConfiguration.Builder().seed(3).list()
            .layer(EmbeddingLayer.Builder().nIn(VOCAB).nOut(EMBED).build())
            .layer(OutputLayer.Builder().nOut(4).build())
            .setInputType(InputType.feedForward(VOCAB)).build())
    assert conf.layers[1].nIn == EMBED
    net = MultiLayerNetwork(conf, device="cpu").init()
    w = net.getParam(0, "W")
    ids = np.array([[3], [0], [10]])
    emb = net.layers[0].apply(net._params[0], {}, torch.from_numpy(ids))[0]
    assert torch.equal(emb, w[[3, 0, 10]])
    one_hot = torch.eye(VOCAB)[[3, 0, 10]]
    np.testing.assert_allclose(
        net.layers[0].apply(net._params[0], {}, one_hot)[0].numpy(),
        emb.numpy(), **FN_TOL)
    assert net.output(ids).shape == (3, 4)


def test_served_token_ids_match_output(nets):
    """InferenceSession serves [N, 1, T] token ids as float32; the ladder's
    row padding repeats a row and its time padding is token 0, which the
    causal recurrence never reads back into the real steps."""
    from deeplearning4j_tpu_torch.serving import (
        BucketLadder, InferenceSession)

    jnet, arrays = nets
    port = _port_of(jnet, arrays)
    requests = [_tokens(n, t, seed=30 + n)[0] for n, t in
                ((1, SEQ), (3, SEQ), (2, 5))]
    with InferenceSession(device="cpu") as session:
        session.register("gru", port, example_shape=(1, SEQ), warmup=True,
                         ladder=BucketLadder((1, 4), seq_lengths=(SEQ,)))
        answers = [session.predict_async("gru", x).result(timeout=60)
                   for x in requests]
    for x, y in zip(requests, answers):
        assert y.shape == (x.shape[0], VOCAB, x.shape[2])
        np.testing.assert_allclose(y, port.output(x).numpy(), **FN_TOL)
        np.testing.assert_allclose(y, jnet.output(x).toNumpy(), **FN_TOL)
