"""The port's char-RNN network against the JAX package's.

One TextGenerationLSTM configuration (vocab 11, hidden 128, seqLength 12)
is built in the JAX package, and its configuration JSON and weights move
into the port: through ``from_json`` and ``params_from_numpy``, and
through the JAX package's own ModelSerializer zip. The same one-hot
batches from a numpy seed then go through both. Tolerance: 1e-5 abs/rel,
float32 on the CPU.
"""

import json

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo import TextGenerationLSTM as JaxCharRnn
from deeplearning4j_tpu.utils.serializer import (
    ModelSerializer as JaxSerializer)
from deeplearning4j_tpu_torch.models.zoo import TextGenerationLSTM
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.convert import params_from_numpy
from deeplearning4j_tpu_torch.utils.serializer import ModelSerializer

VOCAB, HIDDEN, SEQ = 11, 128, 12
RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def jax_net():
    return JaxCharRnn(vocabSize=VOCAB, hidden=HIDDEN, seqLength=SEQ).init()


def _numpy_params(net):
    return [{k: np.asarray(v) for k, v in p.items()} for p in net._params]


def _port(jax_net):
    conf = MultiLayerConfiguration.from_json(jax_net.conf.to_json())
    return MultiLayerNetwork(conf, device="cpu").init(
        params_from_numpy(conf, _numpy_params(jax_net), "cpu"))


def _one_hot(n, t, seed):
    idx = np.random.default_rng(seed).integers(0, VOCAB, size=(n, t))
    return np.eye(VOCAB, dtype=np.float32)[idx].transpose(0, 2, 1).copy()


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_configuration_json_round_trip(jax_net):
    text = JaxCharRnn(vocabSize=VOCAB, hidden=HIDDEN,
                      seqLength=SEQ).conf().to_json()
    conf = MultiLayerConfiguration.from_json(text)
    assert json.loads(conf.to_json()) == json.loads(text)
    assert [lr.nIn for lr in conf.layers] == \
        [lr.nIn for lr in jax_net.conf.layers] == [VOCAB, HIDDEN, HIDDEN]
    # the port's zoo builds the same configuration itself
    own = TextGenerationLSTM(vocabSize=VOCAB, hidden=HIDDEN,
                             seqLength=SEQ).conf()
    assert json.loads(own.to_json()) == json.loads(text)


@pytest.mark.parametrize("n,t", [(1, SEQ), (5, SEQ), (3, 7)])
def test_output_matches_jax(jax_net, n, t):
    x = _one_hot(n, t, seed=n * 10 + t)
    got = _port(jax_net).output(x)
    assert got.shape() == (n, VOCAB, t)
    _close(got.toNumpy(), jax_net.output(x).toNumpy())


def test_rnn_time_step_matches_jax(jax_net):
    port = _port(jax_net)
    x = _one_hot(4, 6, seed=5)
    jax_net.rnnClearPreviousState()
    for k in range(4):   # single steps [N, C]
        _close(port.rnnTimeStep(x[:, :, k]).toNumpy(),
               jax_net.rnnTimeStep(x[:, :, k]).toNumpy())
    # then a chunk [N, C, T] continuing the same sequence
    _close(port.rnnTimeStep(x[:, :, 4:]).toNumpy(),
           jax_net.rnnTimeStep(x[:, :, 4:]).toNumpy())
    jax_net.rnnClearPreviousState()
    # the streamed steps equal the whole-sequence output
    _close(_port(jax_net).output(x).toNumpy()[:, :, :4],
           jax_net.output(x).toNumpy()[:, :, :4])


def test_rnn_state_get_set_clear(jax_net):
    port = _port(jax_net)
    x = _one_hot(2, 5, seed=9)
    port.rnnTimeStep(x[:, :, :3])
    saved = {i: port.rnnGetPreviousState(i) for i in (0, 1)}
    assert saved[0]["h"].shape() == (2, HIDDEN)
    after = port.rnnTimeStep(x[:, :, 3:])
    port.rnnClearPreviousState()
    assert port.rnnGetPreviousState(0) == {}
    for i, st in saved.items():
        port.rnnSetPreviousState(i, st)
    _close(port.rnnTimeStep(x[:, :, 3:]).toNumpy(), after.toNumpy())


def test_restore_jax_model_zip(jax_net, tmp_path):
    path = str(tmp_path / "charrnn.zip")
    JaxSerializer.writeModel(jax_net, path)
    port = ModelSerializer.restoreMultiLayerNetwork(path, device="cpu")
    assert port.numParams() == sum(
        int(np.prod(v.shape)) for p in jax_net._params for v in p.values())
    x = _one_hot(3, SEQ, seed=21)
    _close(port.output(x).toNumpy(), jax_net.output(x).toNumpy())
    # the updater state comes along (by default, as in the JAX package)
    for got, want in zip(port._opt_states, jax_net._opt_states):
        for k in ("m", "v"):
            for name, v in want[k].items():
                _close(got[k][name].numpy(), v)


def test_params_are_checked_against_the_configuration(jax_net):
    conf = MultiLayerConfiguration.from_json(jax_net.conf.to_json())
    arrays = _numpy_params(jax_net)
    bad = [dict(p) for p in arrays]
    bad[1]["R"] = bad[1]["R"][:, :8]
    with pytest.raises(ValueError, match="param R"):
        params_from_numpy(conf, bad, "cpu")
    missing = [dict(p) for p in arrays]
    del missing[2]["b"]
    with pytest.raises(ValueError, match="has params"):
        params_from_numpy(conf, missing, "cpu")
    params = params_from_numpy(conf, arrays, "cpu")
    params[0]["W"] = params[0]["W"].double()
    with pytest.raises(ValueError, match="must be torch.float32"):
        MultiLayerNetwork(conf, device="cpu").init(params)


def test_seeded_init_and_dense_output():
    """A dense net initialized from its own seed: the same seed gives the
    same weights, and output is x@W+b through the activations."""
    conf = (NeuralNetConfiguration.Builder().seed(3).list()
            .layer(DenseLayer.Builder().nIn(6).nOut(5).activation("relu")
                   .build())
            .layer(OutputLayer.Builder().nOut(4).build())
            .build())
    a = MultiLayerNetwork(conf, device="cpu").init()
    b = MultiLayerNetwork(conf, device="cpu").init()
    for pa, pb in zip(a._params, b._params):
        assert all(torch.equal(pa[k], pb[k]) for k in pa)
    x = np.random.default_rng(0).normal(size=(3, 6)).astype(np.float32)
    p0, p1 = a._params
    hidden = torch.relu(torch.from_numpy(x) @ p0["W"] + p0["b"])
    want = torch.softmax(hidden @ p1["W"] + p1["b"], dim=-1)
    _close(a.output(x).toNumpy(), want.numpy())


# -- writeModel(includeFlatCoefficients=True) ---------------------------------

def _coefficients(path):
    import zipfile

    with zipfile.ZipFile(path) as zf:
        return zf.read("coefficients.bin"), set(zf.namelist())


def _flat_case(name):
    """(JAX net, the port's net on its weights carried by convert)."""
    if name == "charrnn":
        jnet = JaxCharRnn(vocabSize=VOCAB, hidden=HIDDEN,
                          seqLength=SEQ).init()
    else:
        from deeplearning4j_tpu.models import zoo as jax_zoo

        jnet = jax_zoo.LeNet().init()
    return jnet, _port(jnet)


@pytest.mark.parametrize("name", ["charrnn", "lenet"])
def test_flat_coefficients_byte_equal_to_the_reference(name, tmp_path):
    """``coefficients.bin`` is one raw little-endian float32 vector in
    ``params()`` order: the two packages' files are byte-equal, and the
    zip still restores (the flag adds an entry, it moves none)."""
    jnet, port = _flat_case(name)
    jpath, ppath = str(tmp_path / "jax.zip"), str(tmp_path / "port.zip")
    JaxSerializer.writeModel(jnet, jpath, includeFlatCoefficients=True)
    ModelSerializer.writeModel(port, ppath, includeFlatCoefficients=True)
    (want, jnames), (got, pnames) = _coefficients(jpath), \
        _coefficients(ppath)
    assert got == want
    assert len(got) == 4 * port.numParams()
    np.testing.assert_array_equal(np.frombuffer(got, "<f4"),
                                  port.params().toNumpy())
    plain = str(tmp_path / "plain.zip")
    ModelSerializer.writeModel(port, plain)
    import zipfile

    with zipfile.ZipFile(plain) as zf:
        assert "coefficients.bin" not in zf.namelist()
        assert pnames - set(zf.namelist()) == {"coefficients.bin"}
    back = ModelSerializer.restoreMultiLayerNetwork(ppath, device="cpu")
    np.testing.assert_array_equal(back.params().toNumpy(),
                                  port.params().toNumpy())


def test_flat_coefficients_of_nested_groups_in_tree_leaves_order(tmp_path):
    """On Bidirectional's nested groups the reference raises; the port
    writes its own ``tree_leaves`` order: each layer's leaves by sorted
    key, a nested group's leaves in its place (``bwd``'s before
    ``fwd``'s), as ``params()`` gives them."""
    from deeplearning4j_tpu.nn.conf.layers import (
        LSTM as JaxLSTM, Bidirectional as JaxBi, RnnOutputLayer as JaxOut)
    from deeplearning4j_tpu.nn.conf.configuration import (
        NeuralNetConfiguration as JaxConf)
    from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInput
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
    from deeplearning4j_tpu_torch.tree_util import tree_leaves

    jconf = (JaxConf.Builder().seed(3).list()
             .layer(JaxBi(JaxLSTM(nOut=3), mode="concat"))
             .layer(JaxOut(nOut=4, activation="softmax",
                           lossFunction="mcxent"))
             .setInputType(JaxInput.recurrent(5)).build())
    jnet = JaxNet(jconf).init()
    with pytest.raises((TypeError, AttributeError)):
        JaxSerializer.writeModel(jnet, str(tmp_path / "j.zip"),
                                 includeFlatCoefficients=True)
    def nested(tree):
        return ({k: nested(v) for k, v in tree.items()}
                if isinstance(tree, dict) else np.asarray(tree))

    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    arrays = [nested(p) for p in jnet._params]
    port = MultiLayerNetwork(conf, device="cpu").init(
        params_from_numpy(conf, arrays, "cpu"))
    assert set(port._params[0]) == {"fwd", "bwd"}
    path = str(tmp_path / "p.zip")
    ModelSerializer.writeModel(port, path, includeFlatCoefficients=True)
    got = np.frombuffer(_coefficients(path)[0], "<f4")
    want = np.concatenate([np.asarray(v, np.float32).reshape(-1)
                           for p in arrays for v in tree_leaves(p)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, port.params().toNumpy())
    # the first leaf is the "bwd" group's first name ("bwd" < "fwd")
    lead = arrays[0]["bwd"][sorted(arrays[0]["bwd"])[0]].reshape(-1)
    np.testing.assert_array_equal(got[:lead.size], lead)
