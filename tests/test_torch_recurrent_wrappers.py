"""The port's SimpleRnn, Bidirectional and LastTimeStep against the JAX
package's, with nested parameter groups everywhere the network touches
params.

Small networks (vocab 23, embedding 6, recurrent widths 4-7, T <= 9,
N = 5) are built with the same DSL calls in both packages; their JSON
must be equal and load in the other package. Weights drawn from a numpy
seed (biases included) go into both, nested groups
(``{"fwd": {...}, "bwd": {...}}``) as they are. Then:

- ``output`` to 1e-5 abs/rel (float32 on the CPU, two summation orders);
- 3 Adam ``fit`` steps, with L2 and per-layer gradient clipping on one
  configuration: losses, params and Adam moments to 1e-4 relative
  (1e-6 absolute);
- ``params``, ``setParams`` and ``numParams`` against
  ``jax.tree_util.tree_leaves`` of the JAX package's tree (exact: the
  same numbers in the same order), ``getParam``/``setParam``/
  ``paramTable`` on groups, ``summary``;
- the ModelSerializer zip in both directions with the updater state;
- ``rnnTimeStep`` and TBPTT through a Bidirectional layer raise
  ``ValueError`` naming it, as in the JAX package, and stream through
  LastTimeStep(LSTM) as there;
- ``simpleRnnLayer`` values and gradients against the JAX op (1e-5
  values, 1e-4 relative / 1e-6 absolute gradients).

The ``cuda``-marked cases hold the LSTM kernels at the bidirectional
IMDB classifier's shape (T, N, H) = (200, 32, 64) against their plain
versions on the card, and a small bidirectional classifier on the card
against the CPU; they skip where CUDA is absent.
"""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.autodiff.ops import OPS as JAX_OPS
from deeplearning4j_tpu.nn.conf import configuration as jax_configuration
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize import updaters as jax_updaters
from deeplearning4j_tpu.utils.serializer import (
    ModelSerializer as JaxSerializer)
from deeplearning4j_tpu_torch.autodiff import ops
from deeplearning4j_tpu_torch.kernels import lstm
from deeplearning4j_tpu_torch.nn import (
    Bidirectional, EmbeddingSequenceLayer, GRU, InputType, LastTimeStep,
    LSTM, MultiLayerConfiguration, MultiLayerNetwork, NeuralNetConfiguration,
    OutputLayer, RnnOutputLayer, SimpleRnn)
from deeplearning4j_tpu_torch.optimize import Adam
from deeplearning4j_tpu_torch.utils import ModelSerializer
from deeplearning4j_tpu_torch.utils.convert import (
    opt_states_from_numpy, opt_states_to_numpy, params_from_numpy)

VOCAB, EMBED, SEQ, BATCH = 23, 6, 9, 5
FN_TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# the card against the CPU, float32: another summation order in the
# kernels, carried through T steps (the smoke's KERNEL_TOL and GRAD_TOL)
CARD_TOL = 1e-4

cuda = pytest.mark.cuda
needs_cuda = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs a CUDA GPU")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- configurations, built with the same calls in both packages ----------------

def _build(L, conf_mod, input_type, updater, name):
    """Configuration ``name`` from the layer module ``L`` (either
    package's)."""
    b = conf_mod.NeuralNetConfiguration.Builder().seed(11).updater(updater)
    if name == "bilstm_l2_clip":
        b = b.l2(1e-3).gradientNormalization("clip_l2_per_layer", 0.5)
    lb = b.list()
    emb = L.EmbeddingSequenceLayer.Builder().nIn(VOCAB).nOut(EMBED).build()
    if name.startswith("bilstm"):   # the IMDB classifier's shape
        lb = (lb.layer(emb)
              .layer(L.Bidirectional.Builder()
                     .rnn(L.LSTM.Builder().nOut(5).build())
                     .mode(L.Bidirectional.CONCAT).build())
              .layer(L.LastTimeStep.Builder().rnn(
                  L.Bidirectional(L.LSTM.Builder().nOut(4).build(),
                                  mode="concat")).build())
              .layer(L.OutputLayer.Builder().nOut(2).activation("softmax")
                     .lossFunction("mcxent").build()))
    elif name.startswith("bi_"):
        mode = name[3:]
        lb = (lb.layer(emb)
              .layer(L.Bidirectional(L.LSTM(nOut=5), mode=mode))
              .layer(L.LastTimeStep(L.LSTM(nOut=4)))
              .layer(L.OutputLayer(nOut=3, lossFunction="mcxent")))
    elif name == "bi_gru_last_simplernn":
        lb = (lb.layer(emb)
              .layer(L.Bidirectional(L.GRU(nOut=4, resetAfter=True)))
              .layer(L.LastTimeStep(L.SimpleRnn(nOut=5)))
              .layer(L.OutputLayer(nOut=3, lossFunction="mcxent")))
    elif name.startswith("last_"):
        inner = {"last_lstm": lambda: L.LSTM(nOut=7),
                 "last_gru": lambda: L.GRU(nOut=6),
                 "last_gru_reset_after": lambda: L.GRU(nOut=6,
                                                       resetAfter=True),
                 "last_simplernn": lambda: L.SimpleRnn(nOut=6)}[name]()
        lb = (lb.layer(emb).layer(L.LastTimeStep(inner))
              .layer(L.OutputLayer(nOut=3, lossFunction="mcxent")))
    else:   # a SimpleRnn sequence model on one-hot input
        lb = (lb.layer(L.SimpleRnn.Builder().nOut(7).activation("tanh")
                       .build())
              .layer(L.SimpleRnn(nOut=5, activation="relu"))
              .layer(L.RnnOutputLayer(nOut=VOCAB, activation="softmax",
                                      lossFunction="mcxent")))
    return lb.setInputType(input_type).build()


CLASSIFIERS = ["bilstm", "bilstm_l2_clip", "bi_concat", "bi_add",
               "bi_average", "bi_mul", "bi_gru_last_simplernn", "last_lstm",
               "last_gru", "last_gru_reset_after", "last_simplernn"]
CONFIGS = CLASSIFIERS + ["simplernn"]


class _PortConf:
    NeuralNetConfiguration = NeuralNetConfiguration


class _PortLayers:
    Bidirectional, EmbeddingSequenceLayer, GRU = (
        Bidirectional, EmbeddingSequenceLayer, GRU)
    LastTimeStep, LSTM, OutputLayer = LastTimeStep, LSTM, OutputLayer
    RnnOutputLayer, SimpleRnn = RnnOutputLayer, SimpleRnn


def _jax_conf(name):
    return _build(jax_layers, jax_configuration,
                  JaxInputType.recurrent(VOCAB, SEQ),
                  jax_updaters.Adam(1e-2), name)


def _port_conf(name):
    return _build(_PortLayers, _PortConf, InputType.recurrent(VOCAB, SEQ),
                  Adam(1e-2), name)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _draw(tree, rng):
    """Random float32 arrays of the shapes of ``tree``'s leaves (arrays,
    or shape tuples), dict keys sorted."""
    if isinstance(tree, dict):
        return {k: _draw(tree[k], rng) for k in sorted(tree)}
    shape = tree if isinstance(tree, tuple) else np.shape(tree)
    return (rng.normal(size=shape) * 0.4).astype(np.float32)


def _pair(name, seed=3):
    """(JAX net, port net) with the same random weights."""
    jnet = JaxNet(_jax_conf(name)).init()
    rng = np.random.default_rng(seed)
    arrays = [_draw(p, rng) for p in jnet._params]
    jnet._params = jax.tree_util.tree_map(jnp.asarray, arrays)
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    net = MultiLayerNetwork(conf, device="cpu").init(
        params_from_numpy(conf, arrays, "cpu"))
    net._opt_states = opt_states_from_numpy(conf, _np(jnet._opt_states),
                                            "cpu")
    return jnet, net


def _data(name, n=BATCH, seed=0):
    rng = np.random.default_rng([seed, n])
    if name == "simplernn":
        idx = rng.integers(0, VOCAB, size=(n, SEQ + 1))
        eye = np.eye(VOCAB, dtype=np.float32)
        return (eye[idx[:, :-1]].transpose(0, 2, 1).copy(),
                eye[idx[:, 1:]].transpose(0, 2, 1).copy())
    n_out = 2 if name.startswith("bilstm") else 3
    ids = rng.integers(0, VOCAB, size=(n, SEQ))
    return ids, np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, n)]


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


# -- configuration -------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_configuration_json_both_ways(name):
    text_j, text_p = _jax_conf(name).to_json(), _port_conf(name).to_json()
    assert json.loads(text_p) == json.loads(text_j)
    port = MultiLayerConfiguration.from_json(text_j)
    assert json.loads(port.to_json()) == json.loads(text_j)
    back = jax_configuration.MultiLayerConfiguration.from_json(text_p)
    assert json.loads(back.to_json()) == json.loads(text_j)
    jnet = JaxNet(_jax_conf(name)).init()
    assert [lr.param_shapes() for lr in port.layers] == \
        jax.tree_util.tree_map(lambda v: tuple(v.shape), jnet._params)


def test_wrapper_json_nests_the_inner_layer():
    d = json.loads(_port_conf("bilstm").to_json())
    bi, last = d["layers"][1], d["layers"][2]
    assert bi["@class"] == "Bidirectional" and bi["mode"] == "concat"
    assert bi["rnn"]["__layer__"]["@class"] == "LSTM"
    assert last["rnn"]["__layer__"]["@class"] == "Bidirectional"
    assert last["rnn"]["__layer__"]["rnn"]["__layer__"]["nOut"] == 4
    conf = _port_conf("bilstm")
    assert [lr.nIn for lr in (conf.layers[1].rnn, conf.layers[2].rnn.rnn,
                              conf.layers[3])] == [EMBED, 10, 8]


# -- forward and training --------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_output_matches_jax(name):
    jnet, net = _pair(name)
    x, _ = _data(name)
    got = net.output(x).toNumpy()
    want = jnet.output(x).toNumpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **FN_TOL)


@pytest.mark.parametrize("name", CONFIGS)
def test_fit_three_adam_steps_matches_jax(name):
    jnet, net = _pair(name)
    x, y = _data(name, seed=1)
    for step in range(3):
        jnet.fit(x, y)
        net.fit(x, y)
        np.testing.assert_allclose(net.score(), jnet.score(),
                                   err_msg=f"loss, step {step}", **TRAIN_TOL)
    _assert_trees_close(net._params, jnet._params, TRAIN_TOL, "params")
    _assert_trees_close(opt_states_to_numpy(net._opt_states),
                        _np(jnet._opt_states), TRAIN_TOL, "adam")


def test_gradients_match_jax_on_nested_groups():
    jnet, net = _pair("bilstm")
    x, y = _data("bilstm", seed=2)
    _assert_trees_close(net.gradients(x, y), jnet.gradients(x, y),
                        GRAD_TOL, "grads")


# -- params on nested groups -----------------------------------------------------

def test_params_follow_the_jax_tree_leaves():
    jnet, net = _pair("bilstm")
    leaves = jax.tree_util.tree_leaves(jnet._params)
    want = np.concatenate([np.ravel(np.asarray(v)) for v in leaves])
    flat = net.params().toNumpy()
    np.testing.assert_array_equal(flat, want)
    assert net.numParams() == want.size
    # bwd before fwd: dict keys sorted at every level
    n_first = sum(int(np.prod(v.shape)) for v in
                  jax.tree_util.tree_leaves(jnet._params[:1]))
    bwd_r = np.asarray(jnet._params[1]["bwd"]["R"]).ravel()
    np.testing.assert_array_equal(flat[n_first:n_first + bwd_r.size], bwd_r)
    other = _pair("bilstm", seed=8)[1]
    other.setParams(flat[::-1].copy())
    np.testing.assert_array_equal(other.params().toNumpy(), flat[::-1])
    other.setParams(net.params())
    x, _ = _data("bilstm")
    np.testing.assert_array_equal(other.output(x).toNumpy(),
                                  net.output(x).toNumpy())


def test_get_set_param_and_table_on_groups():
    jnet, net = _pair("bilstm")
    group = net.getParam(1, "fwd")
    assert sorted(group) == ["R", "W", "b"]
    np.testing.assert_array_equal(group["W"].toNumpy(),
                                  np.asarray(jnet._params[1]["fwd"]["W"]))
    group["W"].addi(1.0)   # a copy: the net is unchanged
    np.testing.assert_array_equal(net.getParam(1, "fwd")["W"].toNumpy(),
                                  np.asarray(jnet._params[1]["fwd"]["W"]))
    new = {k: np.full(v.shape(), 0.25, np.float32) for k, v in group.items()}
    net.setParam(1, "bwd", new)
    jnet.setParam(1, "bwd", new)
    x, _ = _data("bilstm")
    np.testing.assert_allclose(net.output(x).toNumpy(),
                               jnet.output(x).toNumpy(), **FN_TOL)
    with pytest.raises(ValueError, match="takes a dict"):
        net.setParam(1, "bwd", np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="shape"):
        net.setParam(1, "bwd", {k: np.zeros(2, np.float32) for k in new})
    table = net.paramTable()
    assert "1_bwd_R" in table and "2_fwd_b" in table and "0_W" in table
    np.testing.assert_array_equal(table["1_bwd_W"].toNumpy(), new["W"])
    assert sum(v.length() for v in table.values()) == net.numParams()


def test_summary_counts_nested_groups():
    jnet, net = _pair("bilstm")
    lines = net.summary().splitlines()
    assert len(lines) == 6 and lines[-1] == \
        f"Total params: {net.numParams()}"
    n_bi = sum(int(np.prod(v.shape)) for v in
               jax.tree_util.tree_leaves(jnet._params[1]))
    assert lines[2].split()[1:3] == ["Bidirectional", str(n_bi)]
    assert "'fwd': {'W': (6, 20)" in lines[2]
    # on flat groups the JAX package's summary holds, word for word
    _, flat = _pair("last_lstm")
    assert flat.summary() == JaxNet(_jax_conf("last_lstm")).init().summary()


# -- the serializer -------------------------------------------------------------

@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_serializer_zip_both_ways_with_nested_groups(direction, tmp_path):
    jnet, net = _pair("bilstm_l2_clip")
    x, y = _data("bilstm_l2_clip", seed=4)
    jnet.fit(x, y)
    net.fit(x, y)
    path = str(tmp_path / "bilstm.zip")
    if direction == "jax_to_port":
        JaxSerializer.writeModel(jnet, path)
        got = ModelSerializer.restoreMultiLayerNetwork(path, device="cpu")
        src = jnet
    else:
        ModelSerializer.writeModel(net, path)
        got = JaxSerializer.restoreMultiLayerNetwork(path)
        src = net
    _assert_trees_close(got._params, src._params, dict(rtol=0, atol=0),
                        "params")
    _assert_trees_close(_np(got._opt_states), _np(src._opt_states),
                        dict(rtol=0, atol=0), "updater")
    assert got.getIterationCount() == 1
    # both continue training alike
    got.fit(x, y)
    (net if direction == "jax_to_port" else jnet).fit(x, y)
    other = jnet if direction == "port_to_jax" else net
    np.testing.assert_allclose(got.score(), other.score(), **TRAIN_TOL)


def test_serializer_round_trip_is_bit_equal(tmp_path):
    _, net = _pair("bilstm")
    x, y = _data("bilstm")
    net.fit(x, y)
    path = str(tmp_path / "own.zip")
    ModelSerializer.writeModel(net, path)
    back = ModelSerializer.restoreMultiLayerNetwork(path, device="cpu")
    np.testing.assert_array_equal(back.output(x).toNumpy(),
                                  net.output(x).toNumpy())
    np.testing.assert_array_equal(back.params().toNumpy(),
                                  net.params().toNumpy())


# -- streaming and TBPTT ---------------------------------------------------------

@pytest.mark.parametrize("which", ["port", "jax"])
def test_rnn_time_step_refuses_bidirectional(which):
    jnet, net = _pair("bilstm")
    x, _ = _data("bilstm")
    with pytest.raises(ValueError, match="Bidirectional"):
        (net if which == "port" else jnet).rnnTimeStep(x[:, None, :2])


@pytest.mark.parametrize("which", ["port", "jax"])
def test_tbptt_refuses_bidirectional(which):
    conf = _jax_conf("bilstm") if which == "jax" else _port_conf("bilstm")
    d = json.loads(conf.to_json())
    d["backpropType"], d["tbpttLength"] = "TruncatedBPTT", 4
    if which == "jax":
        net = JaxNet(jax_configuration.MultiLayerConfiguration.from_json(
            json.dumps(d))).init()
    else:
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            json.dumps(d)), device="cpu").init()
    x, y = _data("bilstm")
    with pytest.raises(ValueError, match="Bidirectional"):
        net.fit(x[:, None, :].astype(np.float32), y)


def test_rnn_time_step_streams_through_last_time_step():
    """LastTimeStep(LSTM) carries the LSTM's state, as in the JAX
    package: each single step answers as the JAX net does."""
    jnet, net = _pair("last_lstm")
    x, _ = _data("last_lstm")
    ids = x[:, None, :].astype(np.float32)
    for k in range(4):
        np.testing.assert_allclose(
            net.rnnTimeStep(ids[:, :, k]).toNumpy(),
            jnet.rnnTimeStep(ids[:, :, k]).toNumpy(), **FN_TOL)
    assert sorted(net.rnnGetPreviousState(1)) == ["c", "h"]


# -- the op ---------------------------------------------------------------------

@pytest.mark.parametrize("activation,with_b,with_h0", [
    ("tanh", True, True), ("relu", True, False), ("sigmoid", False, True)])
def test_simple_rnn_layer_matches_jax(activation, with_b, with_h0):
    n, i, t, h = 3, 5, 6, 4
    rng = np.random.default_rng(len(activation))
    arrays = [(rng.normal(size=s) * 0.5).astype(np.float32)
              for s in ((n, i, t), (i, h), (h, h), (h,), (n, h))]
    probe = rng.normal(size=(n, h, t)).astype(np.float32)

    def pick(a):
        return [a[0], a[1], a[2], a[3] if with_b else None,
                a[4] if with_h0 else None]

    def jax_loss(x, w, r, b, h0):
        out, hT = JAX_OPS["simpleRnnLayer"](*pick([x, w, r, b, h0]),
                                           activation=activation)
        return jnp.sum(out * probe) + jnp.sum(hT * hT), (out, hT)

    (_, (out_j, hT_j)), want = jax.value_and_grad(
        jax_loss, argnums=tuple(range(5)), has_aux=True)(
            *map(jnp.asarray, arrays))
    ins = [torch.tensor(a, requires_grad=True) for a in arrays]
    x, w, r, b, h0 = pick(ins)
    out, hT = ops.OPS["simpleRnnLayer"](x, w, r, b, h0=h0,
                                        activation=activation)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               **FN_TOL)
    np.testing.assert_allclose(hT.detach().numpy(), np.asarray(hT_j),
                               **FN_TOL)
    loss = (out * torch.from_numpy(probe)).sum() + (hT * hT).sum()
    used = [a for a in pick(ins) if a is not None]
    got = torch.autograd.grad(loss, used)
    for g, wv, name in zip(got, [v for v, a in zip(want, pick(ins))
                                 if a is not None], "xWRbh"):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), **GRAD_TOL,
                                   err_msg=name)


def test_ops_table_holds_the_jax_names():
    assert set(ops.OPS) <= set(JAX_OPS)
    assert {"lstmLayer", "gruLayer", "simpleRnnLayer"} <= set(ops.OPS)


# -- on the card ----------------------------------------------------------------

IMDB_SHAPE = (200, 32, 64)   # (T, N, H) of the bidirectional IMDB net


def _lstm_inputs(t, n, h, device, seed=0):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device)

    return (rnd(t, n, 4 * h), rnd(h, 4 * h, scale=0.1),
            rnd(n, h, scale=0.2), rnd(n, h, scale=0.2))


@cuda
@needs_cuda
def test_lstm_kernels_at_the_imdb_shape_match_plain_versions():
    """Rows 1-3 at (200, 32, 64), the backward with dhs zero except at
    the last step (LastTimeStep's gradient), against the plain versions
    on the card; each output of the backward to CARD_TOL of its largest
    element."""
    t, n, h = IMDB_SHAPE
    xw, r, h0, c0 = _lstm_inputs(t, n, h, "cuda")
    # a forget-gate bias of 3 (f ~ 0.95) carries the last step's gradient
    # back to h0 and c0: at f ~ 0.5 it falls below 1e-38 within 200 steps,
    # where the kernel's flush-to-zero and the plain version's denormals
    # part ways on numbers no step uses
    xw[:, :, h:2 * h] += 3.0
    with torch.no_grad():
        before = lstm.lstm_seq_infer.launches
        got = lstm.lstm_seq_infer(xw, r, h0, c0)
        assert lstm.lstm_seq_infer.launches == before + 1
        want = lstm.lstm_seq_infer_reference(xw, r, h0, c0)
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) < CARD_TOL
        before = lstm.lstm_seq_fwd.launches
        hs, gates, cs = lstm.lstm_seq_fwd(xw, r, h0, c0)
        assert lstm.lstm_seq_fwd.launches == before + 1
        for a, b in zip((hs, gates, cs),
                        lstm.lstm_seq_fwd_reference(xw, r, h0, c0)):
            assert float((a - b).abs().max()) < CARD_TOL
        dhs = torch.zeros_like(hs)
        dhs[-1] = torch.randn(n, h, generator=torch.Generator().manual_seed(
            1)).cuda()
        zero = torch.zeros_like(h0)
        before = lstm.lstm_seq_bwd.launches
        got = lstm.lstm_seq_bwd(dhs, zero, zero, gates, cs, hs, r, h0, c0)
        assert lstm.lstm_seq_bwd.launches == before + 1
        want = lstm.lstm_seq_bwd_reference(dhs, zero, zero, gates, cs, hs,
                                           r, h0, c0)
        for a, b, name in zip(got, want, ("dxw", "dR", "dh0", "dc0")):
            rel = float((a - b).abs().max()) / float(b.abs().max())
            assert rel < CARD_TOL, name


@cuda
@needs_cuda
def test_bidirectional_classifier_on_the_card_matches_the_cpu():
    conf_json = _port_conf("bilstm").to_json()
    rng = np.random.default_rng(5)
    shapes = MultiLayerConfiguration.from_json(conf_json).layers
    arrays = [_draw(lr.param_shapes(), rng) for lr in shapes]
    nets = {}
    for device in ("cuda", "cpu"):
        conf = MultiLayerConfiguration.from_json(conf_json)
        nets[device] = MultiLayerNetwork(conf, device=device).init(
            params_from_numpy(conf, arrays, device))
    x, y = _data("bilstm", n=8, seed=6)
    np.testing.assert_allclose(nets["cuda"].output(x).toNumpy(),
                               nets["cpu"].output(x).toNumpy(),
                               rtol=CARD_TOL, atol=CARD_TOL)
    before = lstm.lstm_seq_fwd.launches, lstm.lstm_seq_bwd.launches
    for _ in range(3):
        for net in nets.values():
            net.fit(x, y)
        np.testing.assert_allclose(nets["cuda"].score(), nets["cpu"].score(),
                                   rtol=CARD_TOL)
    assert (lstm.lstm_seq_fwd.launches - before[0],
            lstm.lstm_seq_bwd.launches - before[1]) == (12, 12)
