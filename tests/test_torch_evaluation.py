"""The port's ``evaluation`` package and the rest of ``MultiLayerNetwork``
against the JAX package's.

- Every evaluation class (Evaluation, EvaluationBinary, ROC, ROCMultiClass,
  ROCBinary, RegressionEvaluation, EvaluationCalibration with its
  ReliabilityDiagram) is fed the same arrays, made from a numpy seed, in
  both packages: with and without masks, [N, C, T] time series (folded
  into the batch), several eval() calls, and merge() where a class has
  it. Every metric, ``stats()`` and the accumulated state must be EQUAL
  (bit for bit, NaN equal to NaN): the port copies the numpy code. The
  port's inputs also go in as CPU tensors, the port's ``INDArray`` and
  bfloat16 tensors, which the reference sees as the same values in
  numpy.
- On the char-RNN configuration (TextGenerationLSTM, vocab 11, hidden 8,
  T=6), with the JAX package's weights moved into the port:
  ``evaluate`` and ``evaluateRegression`` over an iterator whose last
  batch is ragged (padded up by ``pad_rows`` and sliced off), the
  confusion matrix equal and the regression metrics to 1e-5 relative;
  ``feedForward`` to 1e-5 abs/rel; ``clone`` (equal outputs, and
  independent of a later ``fit`` of either net); ``summary`` equal, line
  for line.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import evaluation as jax_evaluation
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.iterator import (
    ListDataSetIterator as JaxListIterator)
from deeplearning4j_tpu.models.zoo import TextGenerationLSTM as JaxCharRnn
from deeplearning4j_tpu_torch import evaluation
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.ndarray import INDArray
from deeplearning4j_tpu_torch.nn import (
    MultiLayerConfiguration, MultiLayerNetwork)
from deeplearning4j_tpu_torch.utils.convert import (
    opt_states_from_numpy, params_from_numpy)

VOCAB, HIDDEN, SEQ = 11, 8, 6
FN_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- equality of everything an evaluator holds ---------------------------------

def assert_same(got, want, what="eval"):
    """Equal structure and values: arrays by dtype and bits (NaN equal to
    NaN), floats exactly, evaluator objects by their attributes."""
    if hasattr(want, "__dict__") and not isinstance(want, type):
        assert type(got).__name__ == type(want).__name__, what
        assert_same(vars(got), vars(want), what)
    elif isinstance(want, dict):
        assert sorted(got, key=str) == sorted(want, key=str), what
        for k in want:
            assert_same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif isinstance(want, float):
        assert (got == want) or (np.isnan(got) and np.isnan(want)), \
            (what, got, want)
    else:
        assert got == want, (what, got, want)


def _probs(rng, shape, axis=-1):
    z = rng.normal(size=shape)
    e = np.exp(z - z.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)


def _one_hot(rng, n, c):
    return np.eye(c, dtype=np.float32)[rng.integers(0, c, size=n)]


def _batches(kind, seed):
    """[(labels, predictions, mask)] for evaluator ``kind``: three eval()
    calls, the last with a mask where the class takes one."""
    rng = np.random.default_rng(seed)
    if kind == "Evaluation":
        out = [(_one_hot(rng, 7, 4), _probs(rng, (7, 4)), None),
               # [N, C, T] time series, folded into the batch
               (np.eye(4, dtype=np.float32)[rng.integers(0, 4, (3, 5))]
                .transpose(0, 2, 1).copy(), _probs(rng, (3, 4, 5), axis=1),
                (rng.random((3, 5)) > 0.3).astype(np.float32)),
               (_one_hot(rng, 6, 4), _probs(rng, (6, 4)),
                (rng.random(6) > 0.4).astype(np.float32))]
    elif kind == "EvaluationBinary":
        out = [((rng.random((8, 3)) > 0.5).astype(np.float32),
                rng.random((8, 3)).astype(np.float32), None),
               ((rng.random((5, 3)) > 0.5).astype(np.float32),
                rng.random((5, 3)).astype(np.float32),
                (rng.random((5, 3)) > 0.3).astype(np.float32))]
    elif kind in ("ROC", "ROC_steps"):
        out = [((rng.random(20) > 0.5).astype(np.float32),
                rng.random(20).astype(np.float32), None),
               ((rng.random(9) > 0.5).astype(np.float32),
                rng.random(9).astype(np.float32),
                (rng.random(9) > 0.3).astype(np.float32))]
    elif kind == "ROCMultiClass":
        out = [(_one_hot(rng, 15, 3), _probs(rng, (15, 3)), None),
               (_one_hot(rng, 9, 3), _probs(rng, (9, 3)),
                (rng.random(9) > 0.3).astype(np.float32))]
    elif kind == "ROCBinary":
        out = [((rng.random((10, 3)) > 0.5).astype(np.float32),
                rng.random((10, 3)).astype(np.float32), None),
               # [N, nOut, T] with a per-output mask
               ((rng.random((4, 3, 5)) > 0.5).astype(np.float32),
                rng.random((4, 3, 5)).astype(np.float32),
                (rng.random((4, 3, 5)) > 0.3).astype(np.float32)),
               ((rng.random((6, 3)) > 0.5).astype(np.float32),
                rng.random((6, 3)).astype(np.float32),
                (rng.random(6) > 0.3).astype(np.float32))]
    elif kind == "RegressionEvaluation":
        out = [(rng.normal(size=(9, 3)).astype(np.float32),
                rng.normal(size=(9, 3)).astype(np.float32), None),
               (rng.normal(size=(7, 3)).astype(np.float32),
                rng.normal(size=(7, 3)).astype(np.float32),
                (rng.random(7) > 0.3).astype(np.float32))]
    else:   # EvaluationCalibration
        out = [(_one_hot(rng, 30, 3), _probs(rng, (30, 3)), None),
               (_one_hot(rng, 12, 3), _probs(rng, (12, 3)),
                (rng.random(12) > 0.3).astype(np.float32))]
    return out


_MAKE = {
    "Evaluation": lambda m: m.Evaluation(),
    "EvaluationBinary": lambda m: m.EvaluationBinary(),
    "ROC": lambda m: m.ROC(),
    "ROC_steps": lambda m: m.ROC(thresholdSteps=10),
    "ROCMultiClass": lambda m: m.ROCMultiClass(),
    "ROCBinary": lambda m: m.ROCBinary(),
    "RegressionEvaluation": lambda m: m.RegressionEvaluation(),
    "EvaluationCalibration": lambda m: m.EvaluationCalibration(5, 8),
}


def _readouts(kind, ev):
    """Every metric of ``ev``, by name."""
    if kind == "Evaluation":
        c = ev.numClasses
        return dict(accuracy=ev.accuracy(), precision=ev.precision(),
                    recall=ev.recall(), f1=ev.f1(),
                    per_class=[(ev.precision(k), ev.recall(k), ev.f1(k),
                                ev.falsePositiveRate(k)) for k in range(c)],
                    confusion=ev.confusionMatrix(),
                    rows=ev.getNumRowCounter(), stats=ev.stats(),
                    text=str(ev))
    if kind == "EvaluationBinary":
        return dict(per_output=[(ev.accuracy(i), ev.precision(i),
                                 ev.recall(i), ev.f1(i)) for i in range(3)],
                    stats=ev.stats())
    if kind in ("ROC", "ROC_steps"):
        return dict(auc=ev.calculateAUC(), aucpr=ev.calculateAUCPR())
    if kind == "ROCMultiClass":
        return dict(auc=[ev.calculateAUC(k) for k in range(3)],
                    avg=ev.calculateAverageAUC())
    if kind == "ROCBinary":
        return dict(n=ev.numLabels(),
                    auc=[ev.calculateAUC(i) for i in range(3)],
                    aucpr=[ev.calculateAUCPR(i) for i in range(3)],
                    avg=ev.calculateAverageAUC(), stats=ev.stats())
    if kind == "RegressionEvaluation":
        return dict(cols=[(ev.meanSquaredError(k), ev.meanAbsoluteError(k),
                           ev.rootMeanSquaredError(k),
                           ev.relativeSquaredError(k),
                           ev.pearsonCorrelation(k), ev.rSquared(k))
                          for k in range(3)],
                    avg=(ev.averageMeanSquaredError(),
                         ev.averagerootMeanSquaredError(),
                         ev.averageMeanAbsoluteError()),
                    stats=ev.stats())
    diagrams = [ev.getReliabilityDiagram(k) for k in range(3)]
    return dict(diagrams=[(d.getMeanPredictedValueX(),
                           d.getFractionPositivesY(), d.binCounts)
                          for d in diagrams],
                ece=[ev.expectedCalibrationError(k) for k in range(3)],
                ece_all=ev.expectedCalibrationError(),
                hist_all=ev.getProbabilityHistogramAllClasses(),
                hist=ev.getProbabilityHistogram(),
                residual=ev.getResidualPlotAllClasses(), stats=ev.stats())


_AS = {
    "numpy": lambda a: a,
    "tensor": torch.from_numpy,
    "indarray": lambda a: INDArray(torch.from_numpy(a)),
}


@pytest.mark.parametrize("form", sorted(_AS))
@pytest.mark.parametrize("kind", sorted(_MAKE))
def test_evaluator_equals_jax(kind, form):
    as_port = _AS[form]
    want, got = _MAKE[kind](jax_evaluation), _MAKE[kind](evaluation)
    for labels, preds, mask in _batches(kind, seed=len(kind)):
        want.eval(labels, preds, mask=mask)
        got.eval(as_port(labels), as_port(preds),
                 mask=None if mask is None else as_port(mask))
    assert_same(_readouts(kind, got), _readouts(kind, want), kind)
    assert_same(got, want, kind)


def test_bfloat16_outputs_upcast_as_in_jax():
    """A bf16 tensor of predictions counts as its float32 values do in the
    JAX package (upcast before the cumulative sums)."""
    rng = np.random.default_rng(4)
    labels = (rng.random((64, 2)) > 0.5).astype(np.float32)
    preds = torch.from_numpy(rng.random((64, 2)).astype(np.float32)).to(
        torch.bfloat16)
    as_f32 = preds.float().numpy()
    for name in ("ROCBinary", "EvaluationBinary", "RegressionEvaluation"):
        want = getattr(jax_evaluation, name)().eval(labels, as_f32)
        got = getattr(evaluation, name)().eval(labels, preds)
        assert_same(got, want, name)


def test_calibration_merge_equals_jax():
    parts = _batches("EvaluationCalibration", seed=9)
    merged = {}
    for mod, key in ((jax_evaluation, "jax"), (evaluation, "port")):
        a, b = mod.EvaluationCalibration(5, 8), mod.EvaluationCalibration(5, 8)
        a.eval(*parts[0][:2])
        b.eval(parts[1][0], parts[1][1], mask=parts[1][2])
        a.merge(b)
        merged[key] = a
    assert_same(_readouts("EvaluationCalibration", merged["port"]),
                _readouts("EvaluationCalibration", merged["jax"]))
    assert_same(merged["port"], merged["jax"])


def test_evaluation_package_exports_the_jax_names():
    want = {"Evaluation", "EvaluationBinary", "ROC", "ROCBinary",
            "ROCMultiClass", "RegressionEvaluation", "EvaluationCalibration",
            "ReliabilityDiagram"}
    assert want <= set(dir(jax_evaluation))
    assert want <= set(dir(evaluation))


# -- MultiLayerNetwork: evaluate, feedForward, clone, summary ------------------

@pytest.fixture(scope="module")
def jax_net():
    return JaxCharRnn(vocabSize=VOCAB, hidden=HIDDEN, seqLength=SEQ).init()


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    return np.asarray(tree)


def _port(jax_net):
    conf = MultiLayerConfiguration.from_json(jax_net.conf.to_json())
    net = MultiLayerNetwork(conf, device="cpu").init(
        params_from_numpy(conf, _np(jax_net._params), "cpu"))
    net._opt_states = opt_states_from_numpy(conf, _np(jax_net._opt_states),
                                            "cpu")
    return net


def _char_batches(sizes, seed):
    """One-hot next-character batches [n, VOCAB, SEQ] of the given sizes."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        idx = rng.integers(0, VOCAB, size=(n, SEQ + 1))
        eye = np.eye(VOCAB, dtype=np.float32)
        out.append((eye[idx[:, :-1]].transpose(0, 2, 1).copy(),
                    eye[idx[:, 1:]].transpose(0, 2, 1).copy()))
    return out


@pytest.mark.parametrize("sizes", [(4, 4, 3), (5, 2, 5, 1)])
def test_evaluate_with_ragged_last_batch(jax_net, sizes):
    batches = _char_batches(sizes, seed=sum(sizes))
    port = _port(jax_net)
    want = jax_net.evaluate(JaxListIterator(
        [JaxDataSet(f, l) for f, l in batches]))
    got = port.evaluate(ListDataSetIterator(
        [DataSet(f, l) for f, l in batches]))
    np.testing.assert_array_equal(got.confusionMatrix(),
                                  want.confusionMatrix())
    assert got.accuracy() == want.accuracy()
    assert got.confusionMatrix().sum() == sum(sizes) * SEQ

    want = jax_net.evaluateRegression(JaxListIterator(
        [JaxDataSet(f, l) for f, l in batches]))
    got = port.evaluateRegression(ListDataSetIterator(
        [DataSet(f, l) for f, l in batches]))
    for k in (0, 3, VOCAB - 1):
        for m in ("meanSquaredError", "meanAbsoluteError", "rSquared"):
            np.testing.assert_allclose(getattr(got, m)(k),
                                       getattr(want, m)(k), rtol=1e-5,
                                       err_msg=m)


def test_evaluate_masked_time_series(jax_net):
    """Label masks [N, T] reach Evaluation as in the JAX package."""
    (f, l), = _char_batches((5,), seed=12)
    mask = (np.random.default_rng(13).random((5, SEQ)) > 0.4).astype(
        np.float32)
    want = jax_net.evaluate([JaxDataSet(f, l, labelsMask=mask)])
    got = _port(jax_net).evaluate([DataSet(f, l, labelsMask=mask)])
    np.testing.assert_array_equal(got.confusionMatrix(),
                                  want.confusionMatrix())
    assert got.confusionMatrix().sum() == int(mask.sum())


def test_feed_forward_matches_jax(jax_net):
    (f, _), = _char_batches((3,), seed=21)
    want = jax_net.feedForward(f)
    got = _port(jax_net).feedForward(f)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert isinstance(g, INDArray)
        np.testing.assert_allclose(g.toNumpy(), w.toNumpy(), **FN_TOL)


def test_clone_is_independent_of_later_fits(jax_net):
    (f, l), = _char_batches((4,), seed=31)
    port = _port(jax_net)
    port.fit(f, l)
    twin = port.clone()
    assert twin is not port and twin.device == port.device
    np.testing.assert_array_equal(twin.output(f).toNumpy(),
                                  port.output(f).toNumpy())
    for a, b in zip(twin._opt_states, port._opt_states):
        for k in ("m", "v"):
            for name in b[k] if b else ():
                assert torch.equal(a[k][name], b[k][name])
                assert a[k][name].data_ptr() != b[k][name].data_ptr()
    before = twin.params().toNumpy()
    port.fit(f, l)
    np.testing.assert_array_equal(twin.params().toNumpy(), before)
    twin.fit(f, l)
    assert not np.array_equal(twin.params().toNumpy(), before)
    # the clone's first step is the source's first step (counters at 0,
    # as in the JAX package's clone)
    assert twin.getIterationCount() == 1


def test_summary_equals_jax(jax_net):
    got = _port(jax_net).summary()
    assert got == jax_net.summary()
    assert got.splitlines()[-1] == f"Total params: {jax_net.numParams()}"
