"""The zoo's other graph models in the port, against the JAX package.

- UNet, SqueezeNet, Xception, NASNet, FaceNetNN4Small2 and
  InceptionResNetV1: JSON, topological order and parameter count
  against the JAX package's ``_expected_num_params`` (shapes only,
  nothing drawn) at the reference tests' sizes and at the published
  defaults; NASNet's ``penultimateFilters % 24`` check; the package
  exports.
- Forward parity on transferred weights, the output and score to 1e-5
  relative: a narrow InceptionResNetV1 (ScaleVertex, L2NormalizeVertex
  and the CenterLossOutputLayer head) with one SGD step from the same
  state (params and running statistics to 1e-4 of each array's largest,
  never tighter than 1e-4 lr), and a narrow UNet (Deconvolution2D,
  MergeVertex, the per-pixel xent LossLayer).
- The reference's slow zoo tests (``tests/test_models.py``) as ``slow``
  cases on the port.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.optimize import updaters as jax_updaters
from deeplearning4j_tpu_torch import models as port_models
from deeplearning4j_tpu_torch.models import zoo
from torch_parity import (
    FN_RTOL, TRAIN_RTOL, close, compare_trees, graph_pair, sync)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _count(conf):
    def leaves(shapes):
        for v in shapes.values():
            yield from (leaves(v) if isinstance(v, dict) else [v])

    return sum(int(np.prod(s)) for node, _ in conf.nodes.values()
               if hasattr(node, "param_shapes")
               for s in leaves(node.param_shapes()))


MODELS = [
    ("UNet", dict(numClasses=1, inputShape=(3, 32, 32), base=8)),
    ("UNet", {}),
    ("SqueezeNet", dict(numClasses=5, inputShape=(3, 64, 64))),
    ("SqueezeNet", {}),
    ("Xception", dict(numClasses=4, inputShape=(3, 32, 32), blocks=2)),
    ("Xception", {}),
    ("NASNet", dict(numClasses=5, inputShape=(3, 32, 32), numBlocks=1,
                    penultimateFilters=96)),
    ("NASNet", dict(numClasses=3, inputShape=(3, 30, 30), numBlocks=1,
                    penultimateFilters=96)),
    ("NASNet", {}),
    ("FaceNetNN4Small2", dict(numClasses=5, inputShape=(3, 32, 32),
                              embeddingSize=16)),
    ("FaceNetNN4Small2", {}),
    ("InceptionResNetV1", dict(numClasses=4, inputShape=(3, 32, 32),
                               embeddingSize=16, blocksA=1, blocksB=1)),
    ("InceptionResNetV1", {}),
]


@pytest.mark.parametrize("name,kw", MODELS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(MODELS)])
def test_conf_is_the_reference_s(name, kw):
    conf = getattr(zoo, name)(**kw).conf()
    want = getattr(jax_zoo, name)(**kw).conf()
    assert conf.to_json() == want.to_json()
    assert conf.topo_order == want.topo_order
    assert _count(conf) == jax_zoo._expected_num_params(want)
    assert getattr(port_models, name) is getattr(zoo, name)


def test_nasnet_penultimate_filters_validated():
    with pytest.raises(ValueError, match="divisible by 24"):
        zoo.NASNet(penultimateFilters=100)


def test_nasnet_cells():
    names = set(zoo.NASNet(numClasses=5, inputShape=(3, 32, 32),
                           numBlocks=1, penultimateFilters=96)
                .conf().nodes)
    assert {"stem_r1_out", "stem_r2_out", "s0n0_out", "s2n0_out",
            "s0r_out", "s1r_out"} <= names


def _images(n, hw, seed):
    return np.random.default_rng(seed).normal(size=(n, 3, hw, hw)).astype(
        np.float32)


def test_inception_resnet_head_matches_and_steps():
    lr = 0.1
    jconf = jax_zoo.InceptionResNetV1(
        numClasses=4, inputShape=(3, 16, 16), embeddingSize=8, blocksA=1,
        blocksB=1, updater=jax_updaters.Sgd(lr)).conf()
    port, jg = graph_pair(jconf, 2)
    kinds = {type(n).__name__ for n, _ in port.conf.nodes.values()}
    assert {"ScaleVertex", "L2NormalizeVertex",
            "CenterLossOutputLayer"} <= kinds
    x = _images(3, 16, 0)
    y = np.eye(4, dtype=np.float32)[[0, 3, 1]]
    close(port.outputSingle(x).toNumpy(),
          np.asarray(jg.outputSingle(x).numpy()))
    close(port.score((x, y)), jg.score((x, y)))
    sync(port, jg)
    port.fit((x, y))
    jg.fit((x, y))
    assert abs(port.score() - jg.score()) <= FN_RTOL * abs(jg.score())
    compare_trees([port._params, port._states],
                  [jg._params, jg._states], TRAIN_RTOL, "one step",
                  TRAIN_RTOL * lr)
    assert float(port._params["out"]["centers"].abs().max()) > 0


def test_unet_matches_the_reference():
    jconf = jax_zoo.UNet(numClasses=1, inputShape=(3, 16, 16),
                         base=2).conf()
    port, jg = graph_pair(jconf, 3)
    x = _images(2, 16, 1)
    y = (np.random.default_rng(2).random((2, 1, 16, 16)) > 0.5).astype(
        np.float32)
    out = port.outputSingle(x).toNumpy()
    assert out.shape == (2, 1, 16, 16)
    close(out, np.asarray(jg.outputSingle(x).numpy()))
    close(port.score((x, y)), jg.score((x, y)))


# the reference's slow zoo tests (tests/test_models.py), on the port
@pytest.mark.slow
def test_unet_shapes_and_training():
    net = zoo.UNet(numClasses=1, inputShape=(3, 32, 32), base=8).init(
        device="cpu")
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
    assert net.output(X)[0].shape() == (2, 1, 32, 32)
    y = (rng.random((2, 1, 32, 32)) > 0.5).astype(np.float32)
    s0 = float(net.score((X, y)))
    net.fit([(X, y)], 3)
    assert float(net.score((X, y))) < s0


@pytest.mark.slow
def test_squeezenet_fire_modules():
    net = zoo.SqueezeNet(numClasses=5, inputShape=(3, 64, 64)).init(
        device="cpu")
    out = net.output(_images(2, 64, 0))[0].toNumpy()
    assert out.shape == (2, 5)
    np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-4)


@pytest.mark.slow
def test_xception_separable_residuals():
    net = zoo.Xception(numClasses=4, inputShape=(3, 32, 32),
                       blocks=2).init(device="cpu")
    X = _images(2, 32, 0)
    y = np.eye(4, dtype=np.float32)[[1, 3]]
    assert net.output(X)[0].shape() == (2, 4)
    s0 = float(net.score((X, y)))
    net.fit([(X, y)], 3)
    assert float(net.score((X, y))) < s0


@pytest.mark.slow
def test_facenet_center_loss_graph():
    net = zoo.FaceNetNN4Small2(numClasses=5, inputShape=(3, 32, 32),
                               embeddingSize=16).init(device="cpu")
    x = _images(4, 32, 0)
    y = np.eye(5, dtype=np.float32)[[0, 1, 2, 3]]
    assert net._params["embedding"]["W"].shape[1] == 16
    assert net._params["out"]["centers"].shape == (5, 16)
    assert net.outputSingle(x).shape() == (4, 5)
    s0 = net.score((x, y))
    net.fit([(x, y)] * 6)
    assert net.score((x, y)) < s0
    assert float(net._params["out"]["centers"].abs().max()) > 0


@pytest.mark.slow
def test_inception_resnet_v1():
    net = zoo.InceptionResNetV1(numClasses=4, inputShape=(3, 32, 32),
                                embeddingSize=16, blocksA=1,
                                blocksB=1).init(device="cpu")
    x = _images(4, 32, 0)
    y = np.eye(4, dtype=np.float32)[[0, 1, 2, 3]]
    out = net.outputSingle(x).toNumpy()
    assert out.shape == (4, 4) and np.allclose(out.sum(1), 1.0, atol=1e-4)
    s0 = net.score((x, y))
    net.fit([(x, y)] * 5)
    assert net.score((x, y)) < s0


@pytest.mark.slow
def test_nasnet_builds_and_trains():
    net = zoo.NASNet(numClasses=5, inputShape=(3, 32, 32), numBlocks=1,
                     penultimateFilters=96).init(device="cpu")
    X = _images(4, 32, 0)
    y = np.eye(5, dtype=np.float32)[[0, 1, 4, 2]]
    assert net.output(X)[0].shape() == (4, 5)
    s0 = net.score((X, y))
    net.fit([(X, y)] * 20)
    assert net.score((X, y)) < s0


@pytest.mark.slow
def test_nasnet_odd_input_sizes_build():
    net = zoo.NASNet(numClasses=3, inputShape=(3, 30, 30), numBlocks=1,
                     penultimateFilters=96).init(device="cpu")
    assert net.output(_images(2, 30, 0))[0].shape() == (2, 3)
