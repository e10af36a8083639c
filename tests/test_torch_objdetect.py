"""Object detection in the port, against the JAX package.

- ``Yolo2OutputLayer``: JSON both ways; the decode and the loss, with its
  gradient with respect to the network output, to 1e-5 relative for the
  default L2 terms and for L1 position with mcxent classes, on labels
  with empty cells, one object and several a cell row; ``_anchor_iou``
  on the same boxes; an empty cell picks prior 0 in both packages.
- ``YoloUtils`` and ``DetectedObject``: the reference's NMS and corner
  cases on both packages; ``getPredictedObjects`` from a tensor and an
  ``INDArray`` gives the JAX package's detections from the same decoded
  array.
- The reference's narrow detection net (conv 8 3x3 leaky ReLU, 1x1 conv
  to B*(5+C), Yolo2OutputLayer on a 4x4 grid) with the port's weights in
  both packages: output and score to 1e-5, 3 Adam steps each from the
  same state (losses to 1e-5 relative, params and Adam moments to 1e-4
  of each array's largest element), and the trained net decodes to the
  same DetectedObjects.
- The zoo's TinyYOLO (a MultiLayerNetwork) and YOLO2 (a
  ComputationGraph): JSON, order and parameter count against the JAX
  package's ``_expected_num_params`` at the published widths (416x416,
  20 and 80 classes) and at 128x128; the reference's slow zoo tests as
  ``slow`` cases; a ``cuda`` case runs the narrow net on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nn as jax_nn
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.conf import objdetect as jax_objdetect
from deeplearning4j_tpu.optimize import updaters as jax_updaters
from deeplearning4j_tpu_torch import nn as port_nn
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.ndarray import INDArray
from deeplearning4j_tpu_torch.nn.conf import objdetect
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration)
from torch_parity import (
    FN_RTOL, TRAIN_RTOL, as_torch, close, compare_trees, net_pair, sync,
    to_np)

PRIORS = [[1.0, 1.0], [3.0, 3.0]]
C = 3
GRID = 4
cuda = pytest.mark.cuda


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _labels(n=2, extra=False):
    """[N, 4+C, H, W]: one object an example (cell (1, 2)), and with
    ``extra`` a second and third in other cells."""
    y = np.zeros((n, 4 + C, GRID, GRID), np.float32)
    for ex in range(n):
        y[ex, 0:4, 1, 2] = (2.1, 1.2, 3.3, 1.9)
        y[ex, 4 + (ex % C), 1, 2] = 1.0
        if extra:
            y[ex, 0:4, 3, 0] = (0.2, 2.5, 1.9, 4.0)
            y[ex, 4 + ((ex + 1) % C), 3, 0] = 1.0
            y[ex, 0:4, 0, 3] = (3.4, 0.1, 3.9, 0.6)
            y[ex, 4, 0, 3] = 1.0
    return y


def _det_conf(pkg, seed=7, **yolo_kw):
    nn = pkg.nn
    return (nn.NeuralNetConfiguration.Builder().seed(seed)
            .updater(pkg.Adam(1e-3)).list()
            .layer(nn.ConvolutionLayer.Builder().nOut(8).kernelSize([3, 3])
                   .convolutionMode(nn.ConvolutionMode.SAME)
                   .activation("leakyrelu").build())
            .layer(nn.ConvolutionLayer.Builder()
                   .nOut(len(PRIORS) * (5 + C)).kernelSize([1, 1])
                   .convolutionMode(nn.ConvolutionMode.SAME)
                   .activation("identity").build())
            .layer(nn.Yolo2OutputLayer(boundingBoxPriors=PRIORS, **yolo_kw))
            .setInputType(nn.InputType.convolutional(GRID, GRID, 2))
            .build())


class _Pkg:
    def __init__(self, nn, updaters):
        self.nn = nn
        self.Adam = updaters.Adam


JAX = _Pkg(jax_nn, jax_updaters)


def _x(n, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, 2, GRID, GRID)).astype(np.float32)


# ---------------------------------------------------------------------------
# Yolo2OutputLayer
# ---------------------------------------------------------------------------

YOLO_VARIANTS = [{}, dict(lossPositionScale="l1",
                          lossClassPredictions="mcxent"),
                 dict(lambdaCoord=2.0, lambdaNoObj=1.0)]


@pytest.mark.parametrize("kw", YOLO_VARIANTS, ids=["l2", "l1_mcxent",
                                                   "lambdas"])
@pytest.mark.parametrize("extra", [False, True], ids=["one", "three"])
def test_yolo_loss_and_gradient_match(kw, extra):
    jl = jax_objdetect.Yolo2OutputLayer(boundingBoxPriors=PRIORS, **kw)
    pl = objdetect.Yolo2OutputLayer(boundingBoxPriors=PRIORS, **kw)
    assert pl.to_json() == jl.to_json()
    assert port_nn.layers.BaseLayer.from_json(jl.to_json()).to_json() == \
        jl.to_json()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, len(PRIORS) * (5 + C), GRID, GRID)).astype(
        np.float32)
    y = _labels(3, extra)
    jx = jnp.asarray(x)
    import jax

    want, jg = jax.value_and_grad(
        lambda v: jl.compute_loss({}, v, jnp.asarray(y)))(jx)
    tx = torch.tensor(x, requires_grad=True)
    got = pl.compute_loss({}, tx, torch.tensor(y))
    (tg,) = torch.autograd.grad(got, [tx])
    close(float(got.detach()), float(want), FN_RTOL, "loss")
    close(to_np(tg), np.asarray(jg), FN_RTOL, "dloss/dx")
    dec, _ = pl.apply({}, {}, torch.tensor(x))
    jdec, _ = jl.apply({}, {}, jx, False, None)
    close(to_np(dec), np.asarray(jdec), FN_RTOL, "decode")
    assert dec.shape == (3, len(PRIORS), 5 + C, GRID, GRID)


def test_anchor_iou_and_empty_cell_prior():
    rng = np.random.default_rng(1)
    wh = np.abs(rng.normal(size=(5, 4, 2))).astype(np.float32) * 3
    wh[0, 0] = 0.0          # an empty cell: IoU 0 for every prior
    priors = np.asarray(zoo.YOLO2.PRIORS, np.float32)
    got = objdetect._anchor_iou(torch.tensor(wh), torch.tensor(priors))
    want = jax_objdetect._anchor_iou(jnp.asarray(wh), jnp.asarray(priors))
    close(to_np(got), np.asarray(want))
    assert float(got[0, 0].abs().max()) == 0.0
    assert int(torch.argmax(got[0, 0])) == int(jnp.argmax(want[0, 0])) == 0
    np.testing.assert_array_equal(to_np(torch.argmax(got, dim=-1)),
                                  np.asarray(jnp.argmax(want, axis=-1)))


def test_yolo_requires_priors_and_infers_its_input():
    with pytest.raises(ValueError, match="boundingBoxPriors"):
        objdetect.Yolo2OutputLayer()
    t = port_nn.InputType.convolutional(13, 13, 125)
    assert objdetect.Yolo2OutputLayer(boundingBoxPriors=PRIORS).infer(t) \
        is t


# ---------------------------------------------------------------------------
# YoloUtils, DetectedObject
# ---------------------------------------------------------------------------

def _obj(mod, ex, cx, cy, w, h, cls, conf):
    probs = np.zeros(C)
    probs[cls] = 1.0
    return mod.DetectedObject(ex, cx, cy, w, h, cls, conf, probs)


@pytest.mark.parametrize("mod", [jax_nn, port_nn], ids=["jax", "torch"])
def test_nms_suppresses_overlap_keeps_distinct(mod):
    a = _obj(mod, 0, 2.0, 2.0, 2.0, 2.0, 1, 0.9)
    b = _obj(mod, 0, 2.1, 2.1, 2.0, 2.0, 1, 0.6)   # overlaps a
    c = _obj(mod, 0, 8.0, 8.0, 2.0, 2.0, 1, 0.7)   # far away
    d = _obj(mod, 0, 2.0, 2.0, 2.0, 2.0, 2, 0.5)   # another class
    e = _obj(mod, 1, 2.0, 2.0, 2.0, 2.0, 1, 0.4)   # another example
    kept = mod.YoloUtils.nonMaxSuppression([a, b, c, d, e], 0.4)
    assert a in kept and c in kept and d in kept and e in kept
    assert b not in kept
    assert kept == [a, c, d, e]


@pytest.mark.parametrize("mod", [jax_nn, port_nn], ids=["jax", "torch"])
def test_corner_helpers(mod):
    o = _obj(mod, 0, 3.0, 4.0, 2.0, 1.0, 0, 0.8)
    assert o.getTopLeftXY() == (2.0, 3.5)
    assert o.getBottomRightXY() == (4.0, 4.5)


def _same_detections(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.exampleNumber, a.predictedClass) == \
            (b.exampleNumber, b.predictedClass)
        for k in ("centerX", "centerY", "width", "height", "confidence"):
            assert getattr(a, k) == pytest.approx(getattr(b, k), rel=1e-6,
                                                  abs=1e-6), k
        close(a.classPredictions, b.classPredictions)


@pytest.mark.parametrize("wrap", ["tensor", "indarray", "numpy"])
def test_get_predicted_objects_matches_the_reference(wrap):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, len(PRIORS) * (5 + C), GRID, GRID)).astype(
        np.float32) * 2
    dec, _ = objdetect.Yolo2OutputLayer(boundingBoxPriors=PRIORS).apply(
        {}, {}, torch.tensor(x))
    arg = {"tensor": dec, "indarray": INDArray(dec),
           "numpy": dec.numpy()}[wrap]
    for thr in (0.3, 0.5, 0.7):
        got = port_nn.YoloUtils.getPredictedObjects(arg, threshold=thr)
        want = jax_nn.YoloUtils.getPredictedObjects(dec.numpy(),
                                                    threshold=thr)
        assert got, thr
        _same_detections(got, want)


# ---------------------------------------------------------------------------
# the narrow detection net, trained in both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def det_pair():
    """The narrow net in both packages after 3 Adam steps on (x, labels)
    batches of 2, 2 and 3 labelled cells, each from the port's state:
    (port, jnet, [(port loss, JAX loss)], [(port arrays, JAX arrays)])."""
    port, jnet = net_pair(_det_conf(JAX), seed=7)
    losses, after = [], []
    for step in range(3):
        sync(port, jnet)
        x, y = _x(2, 10 + step), _labels(2, extra=step > 0)
        port.fit((x, y))
        jnet.fit((x, y))
        losses.append((port.score(), jnet.score()))
        after.append((to_np([port._params, port._opt_states]),
                      to_np([jnet._params, jnet._opt_states])))
    return port, jnet, losses, after


def test_narrow_net_output_score_and_gradients_match():
    port, jnet = net_pair(_det_conf(JAX), seed=3)
    x, y = _x(2), _labels(2, extra=True)
    out = port.output(x).toNumpy()
    close(out, np.asarray(jnet.output(x).numpy()))
    assert out.shape == (2, len(PRIORS), 5 + C, GRID, GRID)
    close(port.score((x, y)), jnet.score((x, y)))
    compare_trees(port.gradients(x, y), jnet.gradients(x, y), FN_RTOL,
                  "gradients")
    # the conv input reaches the output layer unflattened
    assert port.conf.preprocessors == [None, None, None]


def test_narrow_net_trains_as_the_reference(det_pair):
    _, _, losses, after = det_pair
    for step, (got, want) in enumerate(losses):
        assert abs(got - want) <= FN_RTOL * abs(want), (step, got, want)
    for step, (mine, theirs) in enumerate(after):
        compare_trees(mine, theirs, TRAIN_RTOL, f"step {step}",
                      TRAIN_RTOL * 1e-3)


def test_trained_net_decodes_to_the_same_objects(det_pair):
    port, jnet, _, _ = det_pair
    sync(port, jnet)
    x = _x(3, 30)
    dec = port.output(x)
    close(dec.toNumpy(), np.asarray(jnet.output(x).numpy()))
    for thr in (0.45, 0.5):
        got = port_nn.YoloUtils.getPredictedObjects(dec, threshold=thr)
        want = jax_nn.YoloUtils.getPredictedObjects(
            jnet.output(x).numpy(), threshold=thr)
        _same_detections(got, want)


def test_json_round_trip():
    conf = _det_conf(_Pkg(port_nn, __import__(
        "deeplearning4j_tpu_torch.optimize.updaters",
        fromlist=["Adam"])))
    conf2 = MultiLayerConfiguration.from_json(conf.to_json())
    out = conf2.layers[-1]
    assert isinstance(out, objdetect.Yolo2OutputLayer)
    assert np.allclose(out.boundingBoxPriors, PRIORS)
    assert out.lambdaCoord == pytest.approx(5.0)
    assert conf2.to_json() == conf.to_json() == _det_conf(JAX).to_json()


# ---------------------------------------------------------------------------
# the zoo's TinyYOLO and YOLO2
# ---------------------------------------------------------------------------

def _count(conf):
    layers = ([n for n, _ in conf.nodes.values()] if hasattr(conf, "nodes")
              else conf.layers)
    return sum(int(np.prod(s)) for lr in layers
               if hasattr(lr, "param_shapes")
               for s in lr.param_shapes().values())


DETECTORS = [("TinyYOLO", {}), ("YOLO2", {}),
             ("TinyYOLO", dict(numClasses=3, inputShape=(3, 128, 128),
                               boundingBoxPriors=PRIORS)),
             ("YOLO2", dict(numClasses=3, inputShape=(3, 128, 128),
                            boundingBoxPriors=PRIORS, seed=4))]


@pytest.mark.parametrize("name,kw", DETECTORS,
                         ids=["tiny", "yolo2", "tiny128", "yolo2_128"])
def test_zoo_detector_conf_is_the_reference_s(name, kw):
    conf = getattr(zoo, name)(**kw).conf()
    want = getattr(jax_zoo, name)(**kw).conf()
    assert conf.to_json() == want.to_json()
    assert _count(conf) == jax_zoo._expected_num_params(want)
    if name == "YOLO2":
        assert conf.topo_order == want.topo_order
        assert ComputationGraphConfiguration.from_json(
            want.to_json()).to_json() == want.to_json()
        kinds = [type(n).__name__ for n, _ in conf.nodes.values()]
        assert kinds.count("BatchNormalization") == 22
        assert conf.nodes["cat"][1] == ["reorg", "c24b"]
    else:
        assert all(p is None for p in conf.preprocessors)
    if not kw:
        assert _count(conf) == {"TinyYOLO": 15861773,
                                "YOLO2": 50962889}[name]


@pytest.mark.slow
def test_tiny_yolo_builds_and_steps():
    net = zoo.TinyYOLO(numClasses=3, inputShape=(3, 128, 128),
                       boundingBoxPriors=PRIORS).init(device="cpu")
    x = np.random.default_rng(0).normal(size=(1, 3, 128, 128)).astype(
        np.float32)
    y = _labels(1)
    assert net.output(x).shape() == (1, 2, 5 + 3, 4, 4)
    s0 = net.score((x, y))
    net.fit([(x, y)] * 3)
    assert np.isfinite(net.score((x, y))) and np.isfinite(s0)


@pytest.mark.slow
def test_yolo2_builds_and_steps():
    net = zoo.YOLO2(numClasses=3, inputShape=(3, 128, 128),
                    boundingBoxPriors=PRIORS).init(device="cpu")
    x = np.random.default_rng(0).normal(size=(1, 3, 128, 128)).astype(
        np.float32)
    y = _labels(1)
    assert net.outputSingle(x).shape() == (1, 2, 5 + 3, 4, 4)
    net.fit([(x, y)] * 2)
    assert np.isfinite(net.score((x, y)))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@cuda
def test_cuda_narrow_net_trains_and_decodes_as_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.tree_util import tree_leaves

    conf = _det_conf(_Pkg(port_nn, __import__(
        "deeplearning4j_tpu_torch.optimize.updaters", fromlist=["Adam"])))
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    gpu = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json())).init(as_torch(to_np(cpu._params), "cuda"))
    for step in range(3):
        with torch.no_grad():
            for a, b in zip(tree_leaves([gpu._params, gpu._opt_states]),
                            tree_leaves([cpu._params, cpu._opt_states])):
                b.copy_(a)
        x, y = _x(2, 40 + step), _labels(2, extra=True)
        gpu.fit((x, y))
        cpu.fit((x, y))
        assert abs(gpu.score() - cpu.score()) <= 1e-4 * cpu.score()
        compare_trees(gpu._params, cpu._params, 1e-4, f"card step {step}",
                      1e-7)
    x = _x(3, 50)
    close(gpu.output(x).toNumpy(), cpu.output(x).toNumpy(), 1e-4)
    _same_detections(
        port_nn.YoloUtils.getPredictedObjects(gpu.output(x), 0.5),
        port_nn.YoloUtils.getPredictedObjects(cpu.output(x), 0.5))
