"""The port's SameDiff against the JAX package's.

- The 18 tests of ``tests/test_samediff.py``, each written once over a
  package's API and run on both packages: the reference's own assertions
  hold on each, and the arrays each returns agree to 1e-4 of the largest
  element (float32 on the CPU; 150 Adam epochs and numeric gradients sum
  in other orders). Values enter by ``sd.var(name, array)`` from a numpy
  seed, never by seed.
- The GRU char-RNN of TensorFlow's text-generation tutorial as a graph
  (gather -> permute -> rnn.gruLayer -> permute -> reshape -> nn.linear
  -> logits [N, T, V] -> loss.sparseSoftmaxCrossEntropy) at V 11, E 8,
  H 16, T 7, N 4: ``output`` and ``calculateGradients`` to 1e-5, 3 Adam
  steps (losses to 1e-5, parameters and moments to 1e-5 relative), the
  GRU route each call takes, and the graph served through
  ``InferenceSession`` against ``sd.output``.
- The three repairs: ``unroll`` on the recurrent ops, activations named
  by an op, ``input_name``/``output_name`` on ``as_servable`` and
  ``ModelRegistry.register``.
- Zips in both directions, control flow and Adam state included, and
  ``graph.json``'s dtype names.

The ``cuda``-marked cases run the char-RNN graph on the card against the
CPU; they skip where CUDA is absent.
"""

import json
import zipfile
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu import optimize as jax_optimize
from deeplearning4j_tpu.autodiff import ops as jax_ops
from deeplearning4j_tpu.autodiff.samediff import (
    SameDiff as JaxSameDiff, TrainingConfig as JaxTrainingConfig)
from deeplearning4j_tpu_torch import optimize
from deeplearning4j_tpu_torch.autodiff import (
    SameDiff, SDVariable, TrainingConfig, ops)
from deeplearning4j_tpu_torch.kernels import gru as gru_kernels
from deeplearning4j_tpu_torch.serving import (
    InferenceSession, ModelRegistry, SameDiffServable, as_servable)

TOL = 1e-4          # the reference's tests, end to end, across packages
CHAR_TOL = 1e-5     # the char-RNN graph: output, gradients, 3 Adam steps

cuda = pytest.mark.cuda
needs_cuda = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs a CUDA GPU")

JAX = SimpleNamespace(
    create=JaxSameDiff.create,
    load=JaxSameDiff.load, TrainingConfig=JaxTrainingConfig,
    Adam=jax_optimize.Adam, Sgd=jax_optimize.Sgd,
    Nesterovs=jax_optimize.Nesterovs,
    RampSchedule=jax_optimize.RampSchedule,
    FixedSchedule=jax_optimize.FixedSchedule, f32=jnp.float32,
    i32=jnp.int32, normal=jax.random.normal)
PORT = SimpleNamespace(
    create=lambda: SameDiff.create(device="cpu"),
    load=lambda path, **kw: SameDiff.load(path, device="cpu", **kw),
    TrainingConfig=TrainingConfig, Adam=optimize.Adam, Sgd=optimize.Sgd,
    Nesterovs=optimize.Nesterovs, RampSchedule=optimize.RampSchedule,
    FixedSchedule=optimize.FixedSchedule, f32=torch.float32,
    i32=torch.int32,
    normal=lambda g, shape: torch.randn(shape, generator=g,
                                        device=g.device))


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def numeric_grad(f, x, eps=1e-4):
    """Central-difference gradient of scalar f wrt numpy array x."""
    g = np.zeros_like(x, dtype=np.float64)
    it = np.nditer(x, flags=["multi_index"])
    while not it.finished:
        i = it.multi_index
        xp = x.copy(); xp[i] += eps
        xm = x.copy(); xm[i] -= eps
        g[i] = (f(xp) - f(xm)) / (2 * eps)
        it.iternext()
    return g


# -- the 18 tests of tests/test_samediff.py, over either package ------------------

def basic_graph_eval(P, tmp):
    sd = P.create()
    x = sd.placeHolder("x", P.f32, 2, 2)
    w = sd.var("w", [[1.0, 0.0], [0.0, 1.0]])
    x.mmul(w).add(1.0).rename("y")
    out = sd.output({"x": [[1.0, 2.0], [3.0, 4.0]]}, "y")
    np.testing.assert_allclose(out["y"].toNumpy(), [[2, 3], [4, 5]])
    return {"y": out["y"].toNumpy()}


def namespaces(P, tmp):
    sd = P.create()
    x = sd.placeHolder("x", P.f32, 3)
    sd.nn.relu(x).rename("a")
    sd.math.exp(x).rename("b")
    sd.nn.softmax(sd.math.mul(x, 2.0)).rename("s")
    out = sd.output({"x": [-1.0, 0.0, 1.0]}, "a", "b", "s")
    np.testing.assert_allclose(out["a"].toNumpy(), [0, 0, 1])
    np.testing.assert_allclose(out["b"].toNumpy(), np.exp([-1, 0, 1]),
                               rtol=1e-5)
    np.testing.assert_allclose(out["s"].toNumpy().sum(), 1.0, rtol=1e-6)
    return {k: v.toNumpy() for k, v in out.items()}


def gradient_check_mlp(P, tmp):
    rng = np.random.RandomState(0)
    xval = rng.randn(4, 3).astype(np.float32)
    wval = rng.randn(3, 2).astype(np.float32)
    bval = rng.randn(2).astype(np.float32)
    lval = np.eye(2)[rng.randint(0, 2, 4)].astype(np.float32)

    def build(w_):
        sd = P.create()
        x = sd.placeHolder("x", P.f32, 4, 3)
        lab = sd.placeHolder("label", P.f32, 4, 2)
        w = sd.var("w", w_)
        b = sd.var("b", bval)
        h = sd.math.tanh(sd.nn.linear(x, w, b))
        sd.loss.softmaxCrossEntropy(h, lab).rename("loss")
        return sd

    grads = build(wval).calculateGradients({"x": xval, "label": lval},
                                           "w", "b")

    def loss_with_w(w_):
        out = build(w_.astype(np.float32)).output(
            {"x": xval, "label": lval}, "loss")
        return float(out["loss"].getDouble())

    ng = numeric_grad(loss_with_w, wval.astype(np.float64), eps=1e-3)
    np.testing.assert_allclose(grads["w"].toNumpy(), ng, rtol=1e-2,
                               atol=1e-3)
    return {"w": grads["w"].toNumpy(), "b": grads["b"].toNumpy()}


def training_linear_regression(P, tmp):
    rng = np.random.RandomState(1)
    X = rng.randn(128, 4).astype(np.float32)
    true_w = np.array([[1.0], [-2.0], [3.0], [0.5]], dtype=np.float32)
    Y = X @ true_w + 0.01 * rng.randn(128, 1).astype(np.float32)
    sd = P.create()
    x = sd.placeHolder("x", P.f32, -1, 4)
    y = sd.placeHolder("y", P.f32, -1, 1)
    w = sd.var("w", np.zeros((4, 1), np.float32))
    b = sd.var("b", np.zeros((1,), np.float32))
    pred = sd.nn.linear(x, w, b)
    sd.loss.meanSquaredError(pred, y).rename("loss")
    sd.setTrainingConfig(P.TrainingConfig(
        updater=P.Adam(0.05), dataSetFeatureMapping=["x"],
        dataSetLabelMapping=["y"], lossVariables=["loss"]))
    hist = sd.fit([(X, Y)], epochs=150)
    assert hist.lossCurve[-1] < 0.01
    learned = sd.getVariable("w").getArr().toNumpy()
    np.testing.assert_allclose(learned, true_w, atol=0.1)
    return {"w": learned, "losses": np.array(hist.lossCurve)}


def training_loss_decreases_with_each_updater(P, tmp):
    rng = np.random.RandomState(2)
    X = rng.randn(64, 3).astype(np.float32)
    Y = (X.sum(1, keepdims=True) > 0).astype(np.float32)
    out = {}
    for upd in [P.Sgd(0.1), P.Adam(0.05), P.Nesterovs(0.1, 0.9)]:
        sd = P.create()
        x = sd.placeHolder("x", P.f32, -1, 3)
        y = sd.placeHolder("y", P.f32, -1, 1)
        w = sd.var("w", np.zeros((3, 1), np.float32))
        b = sd.var("b", np.zeros((1,), np.float32))
        logits = sd.nn.linear(x, w, b)
        sd.loss.sigmoidCrossEntropy(logits, y).rename("loss")
        sd.setTrainingConfig(P.TrainingConfig(
            updater=upd, dataSetFeatureMapping=["x"],
            dataSetLabelMapping=["y"], lossVariables=["loss"]))
        hist = sd.fit([(X, Y)], epochs=30)
        assert hist.lossCurve[-1] < hist.lossCurve[0], type(upd).__name__
        out[type(upd).__name__] = np.array(hist.lossCurve)
    return out


def lstm_layer_shapes_and_grad(P, tmp):
    sd = P.create()
    N, I, T, H = 2, 3, 5, 4
    x = sd.placeHolder("x", P.f32, N, I, T)
    rng = np.random.RandomState(3)
    w = sd.var("w", (0.1 * rng.randn(I, 4 * H)).astype(np.float32))
    r = sd.var("r", (0.1 * rng.randn(H, 4 * H)).astype(np.float32))
    b = sd.var("b", np.zeros(4 * H, np.float32))
    out, hT, cT = sd.rnn.lstmLayer(x, w, r, b, name="lstm")
    out.sum().markAsLoss().rename("loss")
    xv = rng.randn(N, I, T).astype(np.float32)
    res = sd.output({"x": xv}, out.name(), hT.name())
    assert res[out.name()].shape() == (N, H, T)
    assert res[hT.name()].shape() == (N, H)
    g = sd.calculateGradients({"x": xv}, "w", "r")
    assert g["w"].shape() == (I, 4 * H)
    assert np.abs(g["w"].toNumpy()).sum() > 0
    return {"out": res[out.name()].toNumpy(), "w": g["w"].toNumpy(),
            "r": g["r"].toNumpy()}


def conv_pool_graph(P, tmp):
    sd = P.create()
    x = sd.placeHolder("x", P.f32, 1, 1, 6, 6)
    w = sd.var("w", np.ones((2, 1, 3, 3), np.float32))
    b = sd.var("b", np.zeros(2, np.float32))
    c = sd.cnn.conv2d(x, w, b, kernel=(3, 3), strides=(1, 1),
                      padding=(0, 0))
    sd.cnn.maxPooling2d(c, kernel=(2, 2), strides=(2, 2)).rename("p")
    out = sd.output({"x": np.ones((1, 1, 6, 6), np.float32)}, "p")
    assert out["p"].shape() == (1, 2, 2, 2)
    np.testing.assert_allclose(out["p"].toNumpy(), 9.0)
    return {"p": out["p"].toNumpy()}


def dropout_training_vs_inference(P, tmp):
    sd = P.create()
    x = sd.placeHolder("x", P.f32, 10, 10)
    sd.nn.dropout(x, p=0.5).rename("d")
    out = sd.output({"x": np.ones((10, 10), np.float32)}, "d")
    np.testing.assert_allclose(out["d"].toNumpy(), 1.0)
    return {"d": out["d"].toNumpy()}


def serde_roundtrip(P, tmp):
    sd = P.create()
    x = sd.placeHolder("x", P.f32, -1, 3)
    w = sd.var("w", np.arange(6, dtype=np.float32).reshape(3, 2))
    x.mmul(w).rename("y")
    path = str(tmp / "model.sdz")
    sd.save(path)
    sd2 = P.load(path)
    xv = np.ones((2, 3), np.float32)
    o1 = sd.output({"x": xv}, "y")["y"].toNumpy()
    o2 = sd2.output({"x": xv}, "y")["y"].toNumpy()
    np.testing.assert_allclose(o1, o2)
    assert sd2.getVariable("w").variableType.value == "VARIABLE"
    return {"y": o2}


def serde_with_training_state(P, tmp):
    rng = np.random.RandomState(5)
    X = rng.randn(32, 2).astype(np.float32)
    Y = X @ np.array([[1.0], [2.0]], np.float32)
    sd = P.create()
    x = sd.placeHolder("x", P.f32, -1, 2)
    y = sd.placeHolder("y", P.f32, -1, 1)
    w = sd.var("w", np.zeros((2, 1), np.float32))
    sd.loss.meanSquaredError(x.mmul(w), y).rename("loss")
    sd.setTrainingConfig(P.TrainingConfig(
        updater=P.Adam(0.1), dataSetFeatureMapping=["x"],
        dataSetLabelMapping=["y"], lossVariables=["loss"]))
    sd.fit([(X, Y)], epochs=5)
    path = str(tmp / "m.sdz")
    sd.save(path, saveUpdaterState=True)
    sd2 = P.load(path, loadUpdaterState=True)
    h2 = sd2.fit([(X, Y)], epochs=5)
    assert h2.lossCurve[-1] < h2.lossCurve[0]
    return {"losses": np.array(h2.lossCurve),
            "w": sd2.getVariable("w").getArr().toNumpy()}


def multihead_attention(P, tmp):
    sd = P.create()
    N, T, E, H = 2, 4, 8, 2
    rng = np.random.RandomState(6)
    x = sd.placeHolder("x", P.f32, N, T, E)
    mk = lambda n: sd.var(n, (0.1 * rng.randn(E, E)).astype(np.float32))
    sd.nn.multiHeadDotProductAttention(
        x, x, x, mk("wq"), mk("wk"), mk("wv"), mk("wo"), numHeads=H
    ).rename("att")
    res = sd.output({"x": rng.randn(N, T, E).astype(np.float32)}, "att")
    assert res["att"].shape() == (N, T, E)
    return {"att": res["att"].toNumpy()}


def one_hot_gather(P, tmp):
    sd = P.create()
    idx = sd.placeHolder("idx", P.i32, 3)
    sd.one_hot(idx, 4).rename("oh")
    table = sd.var("table", np.arange(8, dtype=np.float32).reshape(4, 2))
    sd.gather(table, idx).rename("emb")
    out = sd.output({"idx": np.array([0, 2, 3], np.int32)}, "oh", "emb")
    assert out["oh"].shape() == (3, 4)
    np.testing.assert_allclose(out["emb"].toNumpy()[1], [4, 5])
    return {k: v.toNumpy() for k, v in out.items()}


def refit_after_loss_change(P, tmp):
    X = np.ones((4, 2), np.float32)
    Y = np.ones((4, 1), np.float32)
    sd = P.create()
    x = sd.placeHolder("x", P.f32, -1, 2)
    y = sd.placeHolder("y", P.f32, -1, 1)
    w = sd.var("w", np.zeros((2, 1), np.float32))
    pred = x.mmul(w)
    sd.loss.meanSquaredError(pred, y).rename("loss")
    sd.setTrainingConfig(P.TrainingConfig(
        updater=P.Sgd(0.1), dataSetFeatureMapping=["x"],
        dataSetLabelMapping=["y"], lossVariables=["loss"]))
    sd.fit([(X, Y)], epochs=2)
    # add a second loss and retarget — the cached train step must rebuild
    sd.loss.absoluteDifference(pred, y).rename("loss2")
    sd.setLossVariables("loss2")
    h = sd.fit([(X, Y)], epochs=2)
    assert len(h.lossCurve) == 2
    return {"losses": np.array(h.lossCurve)}


def var_initializer_deterministic(P, tmp):
    v1 = P.create().var("w", P.normal, 3, 3).getArr().toNumpy()
    v2 = P.create().var("w", P.normal, 3, 3).getArr().toNumpy()
    np.testing.assert_allclose(v1, v2)
    assert v1.shape == (3, 3) and v1.dtype == np.float32
    return {}   # the draws differ between packages by design


def nested_schedule_serde(P, tmp):
    sd = P.create()
    x = sd.placeHolder("x", P.f32, -1, 2)
    y = sd.placeHolder("y", P.f32, -1, 1)
    w = sd.var("w", np.zeros((2, 1), np.float32))
    sd.loss.meanSquaredError(x.mmul(w), y).rename("loss")
    sd.setTrainingConfig(P.TrainingConfig(
        updater=P.Sgd(P.RampSchedule(P.FixedSchedule(0.1), 10)),
        dataSetFeatureMapping=["x"], dataSetLabelMapping=["y"],
        lossVariables=["loss"]))
    p = str(tmp / "m.sdz")
    sd.save(p)
    sd2 = P.load(p)
    lr = sd2.trainingConfig.updater.learningRate
    assert isinstance(lr, P.RampSchedule)
    assert isinstance(lr.baseSchedule, P.FixedSchedule)
    h = sd2.fit([(np.ones((2, 2), np.float32),
                  np.ones((2, 1), np.float32))], epochs=2)
    assert len(h.lossCurve) == 2
    return {"losses": np.array(h.lossCurve)}


def fit_with_generator_data(P, tmp):
    X = np.ones((8, 2), np.float32)
    Y = np.ones((8, 1), np.float32)
    sd = P.create()
    x = sd.placeHolder("x", P.f32, -1, 2)
    y = sd.placeHolder("y", P.f32, -1, 1)
    w = sd.var("w", np.zeros((2, 1), np.float32))
    sd.loss.meanSquaredError(x.mmul(w), y).rename("loss")
    sd.setTrainingConfig(P.TrainingConfig(
        updater=P.Sgd(0.05), dataSetFeatureMapping=["x"],
        dataSetLabelMapping=["y"], lossVariables=["loss"]))
    gen = ((X[i:i + 4], Y[i:i + 4]) for i in range(0, 8, 4))
    h = sd.fit(gen, epochs=3)
    assert len(h.lossCurve) == 3
    assert not np.isnan(h.lossCurve).any()
    return {"losses": np.array(h.lossCurve)}


def calculate_gradients_strict_wrt(P, tmp):
    sd = P.create()
    x = sd.placeHolder("x", P.f32, 2)
    c = sd.constant("c", np.ones(2, np.float32))
    (x.mul(c)).sum().markAsLoss().rename("loss")
    with pytest.raises(ValueError, match="differentiate"):
        sd.calculateGradients({"x": np.ones(2, np.float32)}, "x", "typo")
    with pytest.raises(ValueError, match="differentiate"):
        sd.calculateGradients({"x": np.ones(2, np.float32)}, "c")
    g = sd.calculateGradients({"x": np.ones(2, np.float32)}, "x")
    np.testing.assert_allclose(g["x"].toNumpy(), [1, 1])
    return {"x": g["x"].toNumpy()}


def params_accessible_during_fit(P, tmp):
    """Listener reads variables mid-fit: it must see the current values."""
    X = np.ones((4, 2), np.float32)
    Y = np.ones((4, 1), np.float32)
    sd = P.create()
    x = sd.placeHolder("x", P.f32, -1, 2)
    y = sd.placeHolder("y", P.f32, -1, 1)
    w = sd.var("w", np.zeros((2, 1), np.float32))
    sd.loss.meanSquaredError(x.mmul(w), y).rename("loss")
    sd.setTrainingConfig(P.TrainingConfig(
        updater=P.Sgd(0.1), dataSetFeatureMapping=["x"],
        dataSetLabelMapping=["y"], lossVariables=["loss"]))
    seen = []

    class L:
        def iterationDone(self, sd_, it, epoch, loss):
            seen.append(sd_.getVariable("w").getArr().toNumpy().copy())

    sd.fit([(X, Y)], epochs=3, listeners=[L()])
    assert len(seen) == 3
    assert np.abs(seen[-1]).sum() > 0
    assert not np.array_equal(seen[0], seen[1])
    return {"seen": np.stack(seen)}


REFERENCE_CASES = [
    basic_graph_eval, namespaces, gradient_check_mlp,
    training_linear_regression, training_loss_decreases_with_each_updater,
    lstm_layer_shapes_and_grad, conv_pool_graph,
    dropout_training_vs_inference, serde_roundtrip,
    serde_with_training_state, multihead_attention, one_hot_gather,
    refit_after_loss_change, var_initializer_deterministic,
    nested_schedule_serde, fit_with_generator_data,
    calculate_gradients_strict_wrt, params_accessible_during_fit,
]


def test_reference_cases_are_the_reference_tests():
    from pathlib import Path

    src = (Path(__file__).parent / "test_samediff.py").read_text()
    names = [ln.split("(")[0][len("def test_"):]
             for ln in src.splitlines() if ln.startswith("def test_")]
    assert sorted(names) == sorted(c.__name__ for c in REFERENCE_CASES)


@pytest.mark.parametrize("case", REFERENCE_CASES, ids=lambda c: c.__name__)
def test_reference_case_on_both_packages(case, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = case(JAX, tmp_path / "jax")
    got = case(PORT, tmp_path / "torch")
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], TOL, k)


# -- the GRU char-RNN graph ----------------------------------------------------

V, E, H, T, N = 11, 8, 16, 7, 4


def char_rnn_values(seed=0):
    rng = np.random.default_rng(seed)
    vals = {"emb": rng.normal(size=(V, E)),
            "W": rng.normal(size=(E, 3 * H)) * E ** -0.5,
            "R": rng.normal(size=(H, 3 * H)) * H ** -0.5,
            "b": rng.normal(size=(6 * H,)) * 0.05,
            "Wo": rng.normal(size=(H, V)) * H ** -0.5,
            "bo": rng.normal(size=(V,)) * 0.05}
    vals = {k: v.astype(np.float32) for k, v in vals.items()}
    tokens = rng.integers(0, V, size=(N, T)).astype(np.float32)
    labels = rng.integers(0, V, size=(N, T)).astype(np.float32)
    return vals, tokens, labels


def char_rnn_graph(P, vals, sd=None):
    """The tutorial's model in SameDiff's terms; logits [N, T, V] so that
    a served batch has its rows on axis 0."""
    sd = sd or P.create()
    tokens = sd.placeHolder("tokens", P.f32, -1, T)
    labels = sd.placeHolder("labels", P.f32, -1, T)
    v = {k: sd.var(k, a) for k, a in vals.items()}
    x = sd.gather(v["emb"], tokens).permute(0, 2, 1)      # [N, E, T]
    out, _ = sd.rnn.gruLayer(x, v["W"], v["R"], v["b"])   # [N, H, T]
    h = out.permute(0, 2, 1).reshape(-1, H)
    logits = sd.nn.linear(h, v["Wo"], v["bo"]).reshape(-1, T, V)
    logits.rename("logits")
    sd.loss.sparseSoftmaxCrossEntropy(logits.reshape(-1, V),
                                      labels.reshape(-1)).rename("loss")
    sd.setTrainingConfig(P.TrainingConfig(
        updater=P.Adam(1e-2), dataSetFeatureMapping=["tokens"],
        dataSetLabelMapping=["labels"]))
    return sd


@pytest.fixture(scope="module")
def char_rnn():
    vals, tokens, labels = char_rnn_values()
    return vals, tokens, labels, char_rnn_graph(JAX, vals)


def test_char_rnn_output_and_gradients_match_jax(char_rnn):
    vals, tokens, labels, jsd = char_rnn
    sd = char_rnn_graph(PORT, vals)
    feeds = {"tokens": tokens, "labels": labels}
    want = jsd.output(feeds, "logits", "loss")
    got = sd.output(feeds, "logits", "loss")
    for k in want:
        _close(got[k].toNumpy(), want[k].toNumpy(), CHAR_TOL, k)
    gw = jsd.calculateGradients(feeds, *vals)
    gg = sd.calculateGradients(feeds, *vals)
    assert list(gg) == list(vals)
    for k in vals:
        _close(gg[k].toNumpy(), gw[k].toNumpy(), CHAR_TOL, f"d{k}")
        assert np.abs(gg[k].toNumpy()).max() > 0


def test_char_rnn_three_adam_steps_match_jax():
    vals, tokens, labels = char_rnn_values()
    jsd, sd = char_rnn_graph(JAX, vals), char_rnn_graph(PORT, vals)
    hw = jsd.fit([(tokens, labels)], epochs=3)
    hg = sd.fit([(tokens, labels)], epochs=3)
    np.testing.assert_allclose(hg.iterLosses, hw.iterLosses, rtol=CHAR_TOL)
    assert hg.iterLosses[-1] < hg.iterLosses[0]
    for k in vals:
        _close(sd.getVariable(k).getArr().toNumpy(),
               np.asarray(jsd.getVariable(k).getArr().toNumpy()),
               CHAR_TOL, k)
        for m in ("m", "v"):
            _close(sd._updater_state[m][k].numpy(),
                   np.asarray(jsd._updater_state[m][k]), CHAR_TOL,
                   f"{m}[{k}]")
    assert sd._step == jsd._step == 3


def _spy_routes(monkeypatch):
    """Record which GRU route each gruLayer call takes."""
    calls = []
    for name in ("gru_seq", "gru_seq_infer"):
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name):
            calls.append(_name)
            return _real(*a)

        monkeypatch.setattr(ops, name, spy)
    return calls


def test_char_rnn_routes(monkeypatch):
    """output serves through the inference route; calculateGradients and
    fit through the differentiable one, also w.r.t. a placeholder alone."""
    vals, tokens, labels = char_rnn_values()
    sd = char_rnn_graph(PORT, vals)
    calls = _spy_routes(monkeypatch)
    feeds = {"tokens": tokens, "labels": labels}
    sd.output(feeds, "logits")
    assert calls == ["gru_seq_infer"]
    sd.calculateGradients(feeds, "R")
    sd.calculateGradients(feeds, "Wo")   # nothing before the GRU needs grad
    assert calls[1:] == ["gru_seq", "gru_seq_infer"]
    sd.fit([(tokens, labels)])
    assert calls[3:] == ["gru_seq"]
    # w.r.t. a placeholder alone: the feed requires grad
    g = SameDiff(device="cpu")
    x = g.placeHolder("x", torch.float32, N, E, T)
    w = g.constant("W", vals["W"])
    r = g.constant("R", vals["R"])
    out, _ = g.rnn.gruLayer(x, w, r)
    out.sum().markAsLoss()
    xv = np.random.default_rng(1).normal(size=(N, E, T)).astype(np.float32)
    dx = g.calculateGradients({"x": xv}, "x")["x"].toNumpy()
    assert calls[4:] == ["gru_seq"]
    jg = JaxSameDiff()
    jx = jg.placeHolder("x", jnp.float32, N, E, T)
    jout, _ = jg.rnn.gruLayer(jx, jg.constant("W", vals["W"]),
                              jg.constant("R", vals["R"]))
    jout.sum().markAsLoss()
    _close(dx, jg.calculateGradients({"x": xv}, "x")["x"].toNumpy(),
           CHAR_TOL)


def test_char_rnn_served_through_inference_session(char_rnn):
    vals, tokens, labels, jsd = char_rnn
    sd = char_rnn_graph(PORT, vals)
    session = InferenceSession(device="cpu")
    try:
        entry = session.register("sd-gru", sd, example_shape=(T,),
                                 input_name="tokens", output_name="logits",
                                 warmup=True)
        assert isinstance(entry.servable, SameDiffServable)
        rng = np.random.default_rng(3)
        requests = [rng.integers(0, V, size=(n, T)).astype(np.float32)
                    for n in (1, 3, 2, 4, 1)]
        wild = rng.integers(0, V, size=(2, T)).astype(np.float32)
        wild[0, :4] = [V, -1, -7 * V, -200]
        requests.insert(2, wild)
        futures = [session.predict_async("sd-gru", x) for x in requests]
        answers = [f.result(timeout=60) for f in futures]
        for x, y in zip(requests, answers):
            want = sd.output({"tokens": x}, "logits")["logits"].toNumpy()
            ref = jsd.output({"tokens": x}, "logits")["logits"].toNumpy()
            assert y.shape == (x.shape[0], T, V)
            np.testing.assert_array_equal(np.isnan(y), np.isnan(want))
            np.testing.assert_array_equal(np.isnan(y), np.isnan(ref))
            np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-5)
        # the wild row is NaN from its first bad id on, the other row not
        assert np.isnan(answers[2][0]).all() and \
            np.isfinite(answers[2][1]).all()
        # the servable reads the graph's values at call time
        sd.getVariable("bo").setArr(vals["bo"] + 1.0)
        again = session.predict("sd-gru", requests[0])
        np.testing.assert_allclose(again, answers[0] + 1.0, rtol=1e-5,
                                   atol=1e-5)
    finally:
        session.close()


# -- the three repairs ------------------------------------------------------------

def test_recurrent_ops_take_unroll_at_the_reference_s_position():
    r = np.random.default_rng(4)
    x = r.normal(size=(2, 3, 5)).astype(np.float32)
    w = r.normal(size=(3, 12)).astype(np.float32) * 0.5
    rr = r.normal(size=(4, 12)).astype(np.float32) * 0.5
    b = r.normal(size=(24,)).astype(np.float32) * 0.1
    t = lambda a: torch.from_numpy(a)
    # gruLayer's 6th positional argument is unroll, as in the reference
    got = ops.OPS["gruLayer"](t(x), t(w), t(rr), t(b), None, 2)
    want = jax_ops.OPS["gruLayer"](jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(rr), jnp.asarray(b), None, 2)
    for g_, w_ in zip(got, want):
        _close(g_.numpy(), np.asarray(w_), 1e-5)
    import inspect

    for name in ("lstmLayer", "gruLayer", "simpleRnnLayer"):
        assert list(inspect.signature(ops.OPS[name]).parameters) == list(
            inspect.signature(jax_ops.OPS[name]).parameters), name


@pytest.mark.parametrize("activation", ["abs", "sin", "identity",
                                        "thresholdRelu", "hardSigmoid",
                                        "rationalTanh", "leakyRelu"])
@pytest.mark.parametrize("op_name", ["gruLayer", "simpleRnnLayer"])
def test_activation_named_by_an_op_resolves_through_ops(op_name,
                                                        activation):
    r = np.random.default_rng(5)
    k = 3 if op_name == "gruLayer" else 1
    x = r.normal(size=(2, 3, 5)).astype(np.float32)
    w = r.normal(size=(3, 4 * k)).astype(np.float32) * 0.5
    rr = r.normal(size=(4, 4 * k)).astype(np.float32) * 0.5
    t = lambda a: torch.from_numpy(a)
    got = ops.OPS[op_name](t(x), t(w), t(rr), activation=activation)
    want = jax_ops.OPS[op_name](jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(rr), activation=activation)
    for g_, w_ in zip(got, want):
        _close(g_.numpy(), np.asarray(w_), 1e-5)


def test_layer_activation_names_still_resolve():
    r = np.random.default_rng(6)
    x = torch.from_numpy(r.normal(size=(2, 3, 5)).astype(np.float32))
    w = torch.from_numpy(r.normal(size=(3, 4)).astype(np.float32))
    rr = torch.from_numpy(r.normal(size=(4, 4)).astype(np.float32))
    for act, fn in (("rationaltanh",
                     lambda z: 1.7159 * torch.tanh(2.0 * z / 3.0)),
                    ("leakyrelu:0.2",
                     lambda z: torch.nn.functional.leaky_relu(z, 0.2)),
                    (torch.sin, torch.sin)):
        got, _ = ops.OPS["simpleRnnLayer"](x, w, rr, activation=act)
        h = torch.zeros(2, 4)
        for k in range(5):
            h = fn(x[:, :, k] @ w + h @ rr)
        np.testing.assert_allclose(got[:, :, -1].numpy(), h.numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_servable_needs_input_and_output_names():
    vals, tokens, _ = char_rnn_values()
    sd = char_rnn_graph(PORT, vals)
    for kw in ({}, {"input_name": "tokens"}, {"output_name": "logits"}):
        with pytest.raises(ValueError, match="input_name= and output_name="):
            as_servable(sd, (T,), **kw)
        with pytest.raises(ValueError, match="input_name= and output_name="):
            ModelRegistry().register("g", sd, example_shape=(T,), **kw)
    entry = ModelRegistry().register(
        "g", sd, example_shape=(T,), input_name=sd.getVariable("tokens"),
        output_name=sd.getVariable("logits"), warmup=True)
    sv = entry.servable
    assert (sv.input_name, sv.output_name) == ("tokens", "logits")
    assert sv.device == sd.device and sv.dtype == np.float32
    np.testing.assert_allclose(
        sv.infer(tokens), sd.output({"tokens": tokens},
                                    "logits")["logits"].toNumpy(),
        rtol=1e-6, atol=1e-6)


# -- zips in both directions ------------------------------------------------------

def _zip_graph(P, vals):
    """The char-RNN with a control-flow head: a scan over a captured
    constant, an ifCond and a forLoop, all serialized as sub-graphs."""
    sd = char_rnn_graph(P, vals)
    scale = sd.constant("scale", np.float32(0.5))
    logits = sd.getVariable("logits")
    carry, ys = sd.scan(lambda c, x: (c + x * scale, c), sd.constant(
        "c0", np.zeros(V, np.float32)), logits.reshape(-1, V).castTo(
        "float32"), name="scan")
    pred = sd.constant("pred", np.float32(1.0))
    head = sd.ifCond(pred, lambda a: a * 2.0, lambda a: a - 1.0, carry,
                     name="head")
    sd.forLoop(2, lambda i, a: (a + scale,), head, name="loop")
    return sd


def test_reference_zip_restores_in_the_port_and_trains_alike(tmp_path):
    vals, tokens, labels = char_rnn_values()
    jsd = _zip_graph(JAX, vals)
    jsd.fit([(tokens, labels)], epochs=2)
    path = str(tmp_path / "ref.sdz")
    jsd.save(path, saveUpdaterState=True)
    with zipfile.ZipFile(path) as zf:
        graph = json.loads(zf.read("graph.json"))
        assert any(k.startswith("__sub__/") for k in np.load(
            __import__("io").BytesIO(zf.read("values.npz"))).files)
    assert {v["dtype"] for v in graph["variables"]} == {"float32"}
    sd = SameDiff.load(path, loadUpdaterState=True, device="cpu")
    feeds = {"tokens": tokens}
    for name in ("logits", "scan", "head", "loop"):
        _close(sd.output(feeds, name)[name].toNumpy(),
               jsd.output(feeds, name)[name].toNumpy(), CHAR_TOL, name)
    assert sd._step == 2
    hw = jsd.fit([(tokens, labels)], epochs=2)
    hg = sd.fit([(tokens, labels)], epochs=2)
    np.testing.assert_allclose(hg.iterLosses, hw.iterLosses, rtol=CHAR_TOL)
    for k in vals:
        _close(sd.getVariable(k).getArr().toNumpy(),
               jsd.getVariable(k).getArr().toNumpy(), CHAR_TOL, k)


def test_port_zip_restores_in_the_reference(tmp_path):
    vals, tokens, labels = char_rnn_values()
    sd = _zip_graph(PORT, vals)
    sd.fit([(tokens, labels)], epochs=2)
    path = str(tmp_path / "port.sdz")
    sd.save(path, saveUpdaterState=True)
    jsd = JaxSameDiff.load(path, loadUpdaterState=True)
    feeds = {"tokens": tokens}
    for name in ("logits", "loop"):
        _close(jsd.output(feeds, name)[name].toNumpy(),
               sd.output(feeds, name)[name].toNumpy(), CHAR_TOL, name)
    hw = jsd.fit([(tokens, labels)], epochs=2)
    hg = sd.fit([(tokens, labels)], epochs=2)
    np.testing.assert_allclose(hw.iterLosses, hg.iterLosses, rtol=CHAR_TOL)


def test_graph_json_holds_numpy_dtype_names(tmp_path):
    sd = SameDiff(device="cpu")
    x = sd.placeHolder("x", torch.int32, 3)
    y = x.castTo(torch.float32).mul(2.0).rename("y")
    z = y.castTo(np.int32).rename("z")
    path = str(tmp_path / "d.sdz")
    sd.save(path)
    with zipfile.ZipFile(path) as zf:
        graph = json.loads(zf.read("graph.json"))
    types = {v["name"]: v["dtype"] for v in graph["variables"]}
    assert types["x"] == "int32"
    casts = [o["attrs"]["dtype"] for o in graph["ops"] if o["fn"] == "cast"]
    assert casts == ["float32", "int32"]
    feeds = {"x": np.array([1, 2, 3], np.int32)}
    for g in (SameDiff.load(path, device="cpu"), JaxSameDiff.load(path)):
        out = g.output(feeds, "y", "z")
        np.testing.assert_array_equal(out["y"].toNumpy(), [2.0, 4.0, 6.0])
        assert out["z"].toNumpy().dtype == np.int32
    assert SameDiff.load(path, device="cpu").getVariable("x").dtype == \
        torch.int32
    assert z.name() == "z"


# -- the rest of the surface --------------------------------------------------------

def test_graph_runs_on_cuda_unless_told():
    real = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        for make in (SameDiff, SameDiff.create, lambda: SameDiff(None)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
    finally:
        torch.cuda.is_available = real
    sd = SameDiff.create(device="cpu")
    assert sd.device.type == "cpu"
    v = sd.var("w", np.ones((2, 2), np.float64))
    assert v.dtype == torch.float32
    assert sd.getVariable("w").getArr().torch().device.type == "cpu"


def test_profiler_config_waits_for_item_13():
    with pytest.raises(NotImplementedError, match="item 13"):
        SameDiff(device="cpu").setProfilerConfig(object())


def test_fit_refuses_an_epoch_with_no_batches():
    for P in (JAX, PORT):
        sd = P.create()
        x = sd.placeHolder("x", P.f32, -1, 2)
        sd.var("w", np.zeros((2, 1), np.float32))
        x.mmul(sd.getVariable("w")).sum().markAsLoss()
        sd.setTrainingConfig(P.TrainingConfig(dataSetFeatureMapping=["x"]))
        with pytest.raises(ValueError, match="no batches"):
            sd.fit([], epochs=1)


def test_summary_exec_all_and_batch_output_match_jax():
    vals, tokens, labels = char_rnn_values()
    jsd, sd = char_rnn_graph(JAX, vals), char_rnn_graph(PORT, vals)
    assert sd.summary() == jsd.summary()
    feeds = {"tokens": tokens, "labels": labels}
    got, want = sd.exec_all(feeds), jsd.exec_all(feeds)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k].toNumpy(), np.asarray(want[k].toNumpy()), CHAR_TOL, k)
    b = sd.batchOutput().input("tokens", tokens).output("logits").execute()
    np.testing.assert_array_equal(b["logits"].toNumpy(),
                                  got["logits"].toNumpy())
    assert isinstance(sd.getVariable("W"), SDVariable)
    assert sd.variableNames() == jsd.variableNames()


# -- on the card --------------------------------------------------------------------

@cuda
@needs_cuda
def test_cuda_char_rnn_graph_matches_the_cpu():
    vals, tokens, labels = char_rnn_values()
    gpu = char_rnn_graph(SimpleNamespace(**{**vars(PORT),
                                            "create": SameDiff.create}),
                         vals)
    cpu = char_rnn_graph(PORT, vals)
    assert gpu.device.type == "cuda"
    feeds = {"tokens": tokens, "labels": labels}
    for k in ("logits", "loss"):
        _close(gpu.output(feeds, k)[k].toNumpy(),
               cpu.output(feeds, k)[k].toNumpy(), 1e-4, k)
    gg, gc = (g.calculateGradients(feeds, *vals) for g in (gpu, cpu))
    again = gpu.calculateGradients(feeds, *vals)
    for k in vals:
        _close(gg[k].toNumpy(), gc[k].toNumpy(), 1e-4, k)
        # the gather's backward too repeats its bits
        np.testing.assert_array_equal(again[k].toNumpy(), gg[k].toNumpy())
    counts = [gru_kernels.gru_seq_fwd, gru_kernels.gru_seq_bwd]
    for fn in counts:
        fn.launches = 0
    hg, hc = (g.fit([(tokens, labels)], epochs=3) for g in (gpu, cpu))
    np.testing.assert_allclose(hg.iterLosses, hc.iterLosses, rtol=1e-4)
    assert [fn.launches for fn in counts] == [3, 3]
    # a wild id is a NaN row on the card too, with no device assert
    wild = tokens.copy()
    wild[0, 0] = -5 * V
    out = gpu.output({"tokens": wild}, "logits")["logits"].toNumpy()
    assert np.isnan(out[0]).all() and np.isfinite(out[1:]).all()
