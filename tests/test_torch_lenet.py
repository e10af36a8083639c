"""LeNet-MNIST and the zoo's MultiLayerNetwork CNNs in the port, against
the JAX package.

- ``datasets/mnist.py``: the synthesised digits bit-equal to the JAX
  package's for the same seed, the iterator's batches equal, IDX files
  (plain and gzipped) read alike; the reference's
  ``tests/test_datasets.py::TestMnist`` runs as written on both packages.
- The zoo: each ``conf()`` (LeNet, SimpleCNN, AlexNet, VGG16, VGG19,
  Darknet19, at their defaults and at other widths) gives the JAX
  package's JSON and parameter count; the JAX package's models other than
  LeNet build their configuration inside ``init()``, which is caught
  before it draws weights, so VGG16 at 224x224 costs nothing here. The
  reference's ``test_lenet_trains_on_synthetic_mnist`` and
  ``test_simple_cnn_output_shape`` run as written on both packages.
- LeNet at 28x28 with transferred weights: 3 Adam steps on 256
  synthesised digits (batches of 100, 100 and a ragged 56 padded to
  100), each step's loss to 1e-5 relative, params and Adam moments after
  to 1e-4 of each array's largest element; ``evaluate`` on 300 test
  digits gives the same confusion matrix; served through
  ``InferenceSession`` it equals ``output`` (1e-5 of the largest element:
  the CPU's conv picks its algorithm by batch size).
- SimpleCNN's DropoutLayer(0.5): its inference output equals the JAX
  package's, and with the dropout held at 1.0 a fit of 3 steps does too
  (the keep rate and scale by moments are in ``test_torch_cnn.py``).
- ModelSerializer zips with BatchNormalization state, updater state and
  counters, from each package restored in the other.
- Each entry point (the zoo, a bare MultiLayerNetwork, a restored zip)
  turns TF32 off on import, before any conv.

The ``cuda`` cases train and serve LeNet on the card against the CPU.
"""

import gzip
import struct
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import datasets as jax_datasets
from deeplearning4j_tpu import nn as jax_nn
from deeplearning4j_tpu.datasets import mnist as jax_mnist
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.conf import configuration as jax_configuration
from deeplearning4j_tpu.optimize import updaters as jax_updaters
from deeplearning4j_tpu.utils.serializer import (
    ModelSerializer as JaxSerializer)
from deeplearning4j_tpu_torch import datasets as port_datasets
from deeplearning4j_tpu_torch import models as port_models
from deeplearning4j_tpu_torch import nn as port_nn
from deeplearning4j_tpu_torch.datasets import mnist
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.optimize import updaters as port_updaters
from deeplearning4j_tpu_torch.serving import InferenceSession
from deeplearning4j_tpu_torch.utils import ModelSerializer
from deeplearning4j_tpu_torch.utils.convert import (
    opt_states_to_numpy, states_to_numpy)

ROOT = Path(__file__).resolve().parent.parent
FN_RTOL = 1e-5
TRAIN_RTOL = 1e-4
# the card against the CPU: cuDNN's conv algorithms against the CPU's
CARD_TOL = 1e-4
cuda = pytest.mark.cuda

JAX = SimpleNamespace(D=jax_datasets, M=jax_zoo, nn=jax_nn,
                      U=jax_updaters, net=lambda conf: jax_nn.MultiLayerNetwork(
                          conf), init=lambda model: model.init())
PORT = SimpleNamespace(D=port_datasets, M=port_models, nn=port_nn,
                       U=port_updaters,
                       net=lambda conf: MultiLayerNetwork(conf, device="cpu"),
                       init=lambda model: model.init(device="cpu"))
PACKAGES = {"jax": JAX, "torch": PORT}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _close(got, want, rtol=FN_RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        # a copy: a CPU tensor's numpy view would alias its memory, which
        # a JAX step that donates its buffers may then write into
        return tree.detach().cpu().numpy().copy()
    return np.asarray(tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _jax_net(port):
    """The JAX package's network from the port's configuration JSON on the
    port's params and layer states; its ``init`` draws nothing (each
    layer hands out the port's params for the call)."""
    jconf = jax_configuration.MultiLayerConfiguration.from_json(
        port.conf.to_json())
    for lr, p in zip(jconf.layers, _np(port._params)):
        lr.init_params = lambda key, dtype, p=p: jax.tree_util.tree_map(
            jnp.asarray, p)
    jnet = jax_nn.MultiLayerNetwork(jconf).init()
    for lr in jconf.layers:
        del lr.init_params
    jnet._states = [jax.tree_util.tree_map(jnp.asarray, s)
                    for s in _np(port._states)]
    return jnet


def _compare_nets(port, jnet, what, rtol=TRAIN_RTOL):
    """Params, layer states and updater state, each array to ``rtol`` of
    its largest element."""
    for kind, mine, theirs in (
            ("param", _np(port._params), jnet._params),
            ("state", states_to_numpy(port._states), jnet._states),
            ("moment", opt_states_to_numpy(port._opt_states),
             jnet._opt_states)):
        assert len(mine) == len(theirs)
        for i, (a, b) in enumerate(zip(mine, theirs)):
            if not isinstance(b, dict):
                assert a == b == ()
                continue
            got = dict(_leaves(a))
            want = dict(_leaves(b))
            assert sorted(got) == sorted(want), (what, kind, i)
            for path in want:
                _close(got[path], want[path], rtol, f"{what} {kind} {i} "
                                                    f"{path}")


# ---------------------------------------------------------------------------
# datasets/mnist.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,seed", [(50, 7), (300, 123), (40, 124)])
def test_synthesised_digits_are_the_reference_s_bit_for_bit(n, seed):
    got = mnist.synthesize_mnist(n, seed)
    want = jax_mnist.synthesize_mnist(n, seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [dict(batch_size=64, num_examples=200),
                                dict(batch_size=50, train=False,
                                     num_examples=120, seed=5),
                                dict(batch_size=32, num_examples=70,
                                     binarize=True)])
def test_iterator_batches_equal(kw):
    got = mnist.MnistDataSetIterator(**kw)
    want = jax_mnist.MnistDataSetIterator(**kw)
    assert got.synthetic and want.synthetic
    assert (got.totalExamples(), got.totalOutcomes(), got.inputColumns()) \
        == (want.totalExamples(), want.totalOutcomes(),
            want.inputColumns())
    for _ in range(2):   # reset replays the epoch
        a, b = list(got), list(want)
        assert len(a) == len(b) == -(-kw["num_examples"] // kw["batch_size"])
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.features, np.asarray(y.features))
            np.testing.assert_array_equal(x.labels, np.asarray(y.labels))


def _write_idx(path, arr, gz):
    head = struct.pack(">I", 0x0800 | arr.ndim) + b"".join(
        struct.pack(">I", d) for d in arr.shape)
    data = head + arr.astype(np.uint8).tobytes()
    if gz:
        with gzip.open(str(path) + ".gz", "wb") as f:
            f.write(data)
    else:
        path.write_bytes(data)


@pytest.mark.parametrize("gz", [False, True])
def test_idx_files_are_read_as_the_reference_reads_them(tmp_path, gz):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (37, 28, 28))
    lbls = rng.integers(0, 10, 37)
    _write_idx(tmp_path / "t10k-images-idx3-ubyte", imgs, gz)
    _write_idx(tmp_path / "t10k-labels-idx1-ubyte", lbls, gz)
    got = mnist.MnistDataSetIterator(16, train=False, data_dir=str(tmp_path))
    want = jax_mnist.MnistDataSetIterator(16, train=False,
                                          data_dir=str(tmp_path))
    assert not got.synthetic and not want.synthetic
    assert got.totalExamples() == 37
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.features, np.asarray(y.features))
        np.testing.assert_array_equal(x.labels, np.asarray(y.labels))
    np.testing.assert_array_equal(
        next(iter(got)).features[0],
        imgs[0].reshape(784).astype(np.float32) / 255.0)
    # a train/ directory without the train files falls back to synthesis
    assert mnist.MnistDataSetIterator(8, data_dir=str(tmp_path),
                                      num_examples=8).synthetic


# the reference's tests/test_datasets.py::TestMnist, run on both packages
@pytest.mark.parametrize("pkg", sorted(PACKAGES))
class TestMnist:
    def test_synthetic_deterministic(self, pkg):
        D = PACKAGES[pkg].D
        x1, y1 = D.synthesize_mnist(50, seed=7)
        x2, y2 = D.synthesize_mnist(50, seed=7)
        np.testing.assert_allclose(x1, x2)
        assert x1.shape == (50, 784)
        assert 0 <= x1.min() and x1.max() <= 1.0

    def test_iterator_shapes(self, pkg):
        D = PACKAGES[pkg].D
        it = D.MnistDataSetIterator(batch_size=32, train=True,
                                    num_examples=100)
        ds = it.next()
        assert ds.features.shape == (32, 784)
        assert ds.labels.shape == (32, 10)
        assert it.totalOutcomes() == 10

    def test_learnable_by_mlp(self, pkg):
        """The synthetic digits must be actually learnable (else LeNet
        benchmarks are meaningless)."""
        ns = PACKAGES[pkg]
        nn = ns.nn
        train = ns.D.MnistDataSetIterator(batch_size=64, train=True,
                                          num_examples=512, seed=3)
        conf = (nn.NeuralNetConfiguration.Builder().seed(1)
                .updater(ns.U.Adam(1e-3))
                .list()
                .layer(nn.DenseLayer.Builder().nIn(784).nOut(64)
                       .activation("relu").build())
                .layer(nn.OutputLayer.Builder().nOut(10).activation("softmax")
                       .lossFunction("mcxent").build())
                .build())
        net = ns.net(conf).init()
        net.fit(train, 15)
        ev = net.evaluate(train)
        assert ev.accuracy() > 0.9, ev.accuracy()


# ---------------------------------------------------------------------------
# the zoo
# ---------------------------------------------------------------------------

class _Captured:
    """Stands for the JAX package's MultiLayerNetwork inside its zoo's
    ``init()``: keeps the configuration and draws nothing."""

    def __init__(self, conf):
        self.conf = conf

    def init(self):
        return self


def _reference_conf(monkeypatch, model):
    if type(model).__name__ == "LeNet":
        return model.conf()
    monkeypatch.setattr(jax_zoo, "MultiLayerNetwork", _Captured)
    return model.init().conf


ZOO = [("LeNet", {}), ("LeNet", dict(numClasses=7, inputShape=(1, 20, 24),
                                     seed=5)),
       ("SimpleCNN", {}), ("SimpleCNN", dict(numClasses=5,
                                             inputShape=(3, 32, 32))),
       ("AlexNet", {}), ("VGG16", {}), ("VGG16", dict(numClasses=10,
                                                       inputShape=(3, 32, 32))),
       ("VGG19", {}), ("Darknet19", {}),
       ("Darknet19", dict(numClasses=20, inputShape=(3, 64, 96), seed=9))]


@pytest.mark.parametrize("name,kw", ZOO,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(ZOO)])
def test_zoo_conf_is_the_reference_s(monkeypatch, name, kw):
    conf = getattr(zoo, name)(**kw).conf()
    want = _reference_conf(monkeypatch, getattr(jax_zoo, name)(**kw))
    assert conf.to_json() == want.to_json()
    assert conf.preprocessors == want.preprocessors
    assert sum(int(np.prod(s)) for lr in conf.layers
               for _, s in _leaves(lr.param_shapes())) == \
        jax_zoo._expected_num_params(want)
    assert MultiLayerConfiguration.from_json(want.to_json()).to_json() == \
        want.to_json()


def test_zoo_exports_and_the_lenet_widths():
    for name in ("LeNet", "SimpleCNN", "AlexNet", "VGG16", "VGG19",
                 "Darknet19"):
        assert getattr(port_models, name) is getattr(zoo, name)
        assert issubclass(getattr(zoo, name), zoo.ZooModel)
    conf = zoo.LeNet().conf()
    assert [lr.param_shapes() for lr in conf.layers] == [
        {"W": (20, 1, 5, 5), "b": (20,)}, {}, {"W": (50, 20, 5, 5),
                                              "b": (50,)},
        {}, {"W": (800, 500), "b": (500,)}, {"W": (500, 10), "b": (10,)}]
    assert conf.defaults["updater"].to_json() == \
        jax_updaters.Adam(1e-3).to_json()
    assert zoo.LeNet().metaData() == {"name": "LeNet"}


@pytest.mark.parametrize("module", [
    "deeplearning4j_tpu_torch.models.zoo",
    "deeplearning4j_tpu_torch.nn.multilayer",
    "deeplearning4j_tpu_torch.nn.graph",
    "deeplearning4j_tpu_torch.utils.serializer"])
def test_every_entry_point_turns_tf32_off_before_a_conv(module):
    """LeNet().init() and ResNet50().init(), a bare MultiLayerNetwork or
    ComputationGraph and a restored zip each import backend.py, which
    turns TF32 off for cuBLAS and cuDNN (the JAX package computes float32
    in float32) and, where the build has the switch, sets cuDNN's
    convolutions to "ieee" by name."""
    code = ("import torch\n"
            "torch.backends.cudnn.allow_tf32 = True\n"
            "torch.backends.cuda.matmul.allow_tf32 = True\n"
            "conv = getattr(torch.backends.cudnn, 'conv', None)\n"
            "switch = hasattr(conv, 'fp32_precision')\n"
            "if switch:\n"
            "    conv.fp32_precision = 'tf32'\n"
            f"import {module}\n"
            "assert not torch.backends.cudnn.allow_tf32\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
            "assert not switch or conv.fp32_precision == 'ieee'\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# the reference's tests/test_models.py::TestZoo cases, run on both packages
@pytest.mark.parametrize("pkg", sorted(PACKAGES))
class TestZoo:
    def test_lenet_trains_on_synthetic_mnist(self, pkg):
        ns = PACKAGES[pkg]
        net = ns.init(ns.M.LeNet(numClasses=10))
        it = ns.D.MnistDataSetIterator(batch_size=64, num_examples=256)
        s0 = net.score(it.next())
        net.fit(it, 3)
        it.reset()
        assert net.score(it.next()) < s0

    def test_simple_cnn_output_shape(self, pkg):
        ns = PACKAGES[pkg]
        net = ns.init(ns.M.SimpleCNN(numClasses=5, inputShape=(3, 32, 32)))
        x = np.random.default_rng(0).normal(size=(2, 3, 32, 32)).astype(
            np.float32)
        assert net.output(x).shape() == (2, 5)


# ---------------------------------------------------------------------------
# LeNet-MNIST: fit, evaluate, serve
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lenet_pair():
    """LeNet at 28x28 on the same weights in both packages, after 3 Adam
    steps on 256 synthesised digits (batches 100, 100, 56), with each
    step's losses."""
    port = zoo.LeNet().init(device="cpu")
    jnet = _jax_net(port)
    losses = []
    it = mnist.MnistDataSetIterator(batch_size=100, num_examples=256)
    for ds in it:
        port.fit(port_datasets.DataSet(ds.features, ds.labels))
        jnet.fit(jax_datasets.DataSet(ds.features, ds.labels))
        losses.append((port.score(), jnet.score()))
    return port, jnet, losses


def test_lenet_fit_matches_the_reference(lenet_pair):
    port, jnet, losses = lenet_pair
    assert len(losses) == 3 and port._bucket == 100
    for step, (got, want) in enumerate(losses):
        assert abs(got - want) <= FN_RTOL * abs(want), (step, got, want)
    assert port.getIterationCount() == jnet.getIterationCount() == 3
    _compare_nets(port, jnet, "lenet")


def test_lenet_evaluate_matches_the_reference(lenet_pair):
    port, jnet, _ = lenet_pair
    got = port.evaluate(mnist.MnistDataSetIterator(64, train=False,
                                                   num_examples=300))
    want = jnet.evaluate(jax_mnist.MnistDataSetIterator(64, train=False,
                                                        num_examples=300))
    np.testing.assert_array_equal(np.asarray(got.confusionMatrix()),
                                  np.asarray(want.confusionMatrix()))
    assert got.accuracy() == want.accuracy()
    x = mnist.synthesize_mnist(20, seed=9)[0]
    _close(port.output(x).toNumpy(), jnet.output(x).toNumpy())


def test_lenet_served_equals_output(lenet_pair):
    port = lenet_pair[0]
    requests = [mnist.synthesize_mnist(n, seed=40 + n)[0]
                for n in (1, 3, 8, 2, 5, 16, 1)]
    with InferenceSession(device="cpu", max_latency=0.01) as session:
        session.register("lenet", port, example_shape=(784,),
                         ladder=(1, 4, 8, 16), warmup=True)
        futures = [session.predict_async("lenet", x) for x in requests]
        answers = [f.result(timeout=60) for f in futures]
    for x, y in zip(requests, answers):
        assert y.shape == (x.shape[0], 10)
        _close(y, port.output(x).toNumpy())


# ---------------------------------------------------------------------------
# SimpleCNN's dropout, BatchNormalization state in zips
# ---------------------------------------------------------------------------

def _simple_cnn(dropout=None):
    port = zoo.SimpleCNN(numClasses=4, inputShape=(3, 12, 10)).init(
        device="cpu")
    if dropout is not None:
        port.layers[8].dropOut = dropout
    return port


def _digits(n, seed, shape=(3, 12, 10), classes=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n,) + shape).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]


def test_simple_cnn_dropout_in_inference_and_held_at_one_in_fit():
    port = _simple_cnn()
    assert type(port.layers[8]).__name__ == "DropoutLayer"
    assert port.layers[8].dropOut == 0.5
    jnet = _jax_net(port)
    x, _ = _digits(6, 0)
    _close(port.output(x).toNumpy(), jnet.output(x).toNumpy())
    port = _simple_cnn(dropout=1.0)
    assert port._dropout_generator(0) is None
    jnet = _jax_net(port)
    for k, n in enumerate((6, 6, 4)):
        x, y = _digits(n, k + 1)
        port.fit(x, y)
        jnet.fit(x, y)
        assert abs(port.score() - jnet.score()) <= FN_RTOL * abs(
            jnet.score())
    _compare_nets(port, jnet, "simple_cnn")


def _trained_simple_cnn():
    port = _simple_cnn(dropout=1.0)
    for k in range(2):
        port.fit(*_digits(5, 10 + k))
    return port


def test_zip_from_the_port_restores_in_the_jax_package(tmp_path):
    port = _trained_simple_cnn()
    assert any(st for st in port._states)
    path = tmp_path / "port.zip"
    ModelSerializer.writeModel(port, str(path))
    jnet = JaxSerializer.restoreMultiLayerNetwork(str(path))
    assert jnet.getIterationCount() == 2
    _compare_nets(port, jnet, "port zip", rtol=0.0)
    # 5 rows, the port's bucket: the restored net has none yet, and a
    # padding row would enter BatchNormalization's statistics
    x, y = _digits(5, 30)
    _close(port.output(x).toNumpy(), jnet.output(x).toNumpy())
    # the restored net trains on as the port does
    port.fit(x, y)
    jnet.fit(x, y)
    _compare_nets(port, jnet, "port zip + 1 step")


def test_zip_from_the_jax_package_restores_in_the_port(tmp_path):
    jnet = _jax_net(_simple_cnn(dropout=1.0))
    for k in range(2):
        jnet.fit(*_digits(5, 20 + k))
    path = tmp_path / "jax.zip"
    JaxSerializer.writeModel(jnet, str(path))
    port = ModelSerializer.restoreMultiLayerNetwork(str(path), device="cpu")
    assert port.getIterationCount() == 2
    _compare_nets(port, jnet, "jax zip", rtol=0.0)
    x, _ = _digits(4, 31)
    _close(port.output(x).toNumpy(), jnet.output(x).toNumpy())
    # and written again by the port, it holds the same state
    again = tmp_path / "again.zip"
    ModelSerializer.writeModel(port, str(again))
    back = ModelSerializer.restoreMultiLayerNetwork(str(again), device="cpu")
    _compare_nets(back, jnet, "jax zip, port zip", rtol=0.0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@cuda
def test_cuda_lenet_trains_evaluates_and_serves_as_the_cpu(card, tmp_path):
    """``LeNet().init()`` on the card and on the CPU hold the same weights
    (drawn on the CPU from the seed). From them: the output and the dense
    layers' gradients to CARD_TOL; the conv layers' gradients to 5e-2 of
    the largest element: max pooling routes a window's gradient to its
    argmax, which a near-tie (the devices round the conv sums apart)
    flips, moving one element's gradient to its neighbour (one window of
    LeNet's 51200 at batch 64 moves 1.7% of conv2's largest weight
    gradient on an H100); the first step's loss to CARD_TOL. After 4 Adam
    steps the losses within 1e-2 (the first steps move each weight by
    about +-lr, whatever the gradient's size, so a flipped sign is a
    2 lr step), the test accuracies within 2 digits of the 200, served
    rows equal to ``output``, and a zip restored on the card bit-equal."""
    gpu = zoo.LeNet().init()
    cpu = zoo.LeNet().init(device="cpu")
    assert gpu.device.type == "cuda"
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    for a, b in zip(_np(gpu._params), _np(cpu._params)):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    it = mnist.MnistDataSetIterator(batch_size=64, num_examples=200)
    ds = it.next()
    _close(gpu.output(ds.features).toNumpy(),
           cpu.output(ds.features).toNumpy(), CARD_TOL)
    for i, (gg, gc) in enumerate(zip(gpu.gradients(ds.features, ds.labels),
                                     cpu.gradients(ds.features, ds.labels))):
        for k in gc:
            _close(_np(gg[k]), _np(gc[k]), CARD_TOL if i > 3 else 5e-2,
                   f"layer {i} d{k}")
    losses = []
    for ds in it:
        gpu.fit(ds)
        cpu.fit(ds)
        losses.append((gpu.score(), cpu.score()))
    assert len(losses) == 4
    _close(losses[0][0], losses[0][1], CARD_TOL)
    for got, want in losses[1:]:
        assert np.isfinite(got) and abs(got - want) <= 1e-2 * want
    test = mnist.MnistDataSetIterator(64, train=False, num_examples=200)
    assert abs(gpu.evaluate(test).accuracy()
               - cpu.evaluate(test).accuracy()) <= 2 / 200
    x = mnist.synthesize_mnist(13, seed=3)[0]
    want = gpu.output(x).toNumpy()
    with InferenceSession(max_latency=0.01) as session:
        session.register("lenet", gpu, example_shape=(784,),
                         ladder=(1, 8, 16), warmup=True)
        _close(session.predict("lenet", x), want)
    path = tmp_path / "lenet.zip"
    ModelSerializer.writeModel(gpu, str(path))
    back = ModelSerializer.restoreMultiLayerNetwork(str(path))
    assert back.device.type == "cuda"
    np.testing.assert_array_equal(back.output(x).toNumpy(), want)
