"""The port's convolutional layers, preprocessors and BatchNormalization
state against the JAX package's.

Layers (every class of the reference's ``nn/conf/layers.py`` from
ConvolutionLayer to ActivationLayer, and LossLayer), each built with the
same call in both packages at small widths (N = 3, C <= 6, H, W <= 9):

- the default JSON (constructor defaults, then after ``apply_defaults``)
  and ``infer`` (the output type and the layer's JSON after it) equal;
- ``param_shapes`` equal to the shapes the JAX package draws;
- with the same params and state (random normal from a numpy seed, the
  running variance positive), ``apply`` in inference and in training
  (no generator, so no dropout draw) gives the same output and new state,
  and the gradients of a random projection of the output with respect to
  the params and the input agree. Tolerance for both: 1e-5 relative with
  a floor of 1e-5 of the largest element (float32 on the CPU, two
  summation orders).

Configurations: the JSON both ways (``convolutionalFlat`` input
included), the recorded preprocessors and per-layer input types, and a
network per configuration with transferred weights: ``output``,
``feedForward``, ``score`` and ``gradients`` to the same tolerance. The
first-dense flatten is channel-major, which only transferred weights can
show.

BatchNormalization state: after 3 Adam ``fit`` steps whose last batch is
ragged (padded to its bucket by repeating its last row, as in the JAX
package) the running mean and variance, params and Adam moments against
the JAX package's (losses 1e-5 relative; params, moments and statistics
to 1e-4 of the largest element of each array: rounding that BatchNorm
over 5-8 rows amplifies through 3 steps); the
same with an LSTM trained by truncated BPTT beside a BatchNormalization,
which keeps its state while the LSTM's is dropped; ``states_from_numpy``
and ``states_to_numpy``.

The reference's ``tests/test_nn.py::TestConvNet`` (bar bf16) runs as
written on both packages. The ``cuda`` cases hold the layers on the card
against the CPU.
"""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn.conf import configuration as jax_configuration
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.optimize import updaters as jax_updaters
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import configuration
from deeplearning4j_tpu_torch.nn.conf import layers as port_layers
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.optimize import updaters as port_updaters
from deeplearning4j_tpu_torch.utils.convert import (
    opt_states_to_numpy, params_from_numpy, states_from_numpy,
    states_to_numpy)

N = 3
FN_RTOL = 1e-5
TRAIN_RTOL = 1e-4
# the card against the CPU: cuDNN's algorithms (Winograd, FFT, implicit
# GEMM) against the CPU's, in float32
CARD_TOL = 1e-4

cuda = pytest.mark.cuda

JAX = SimpleNamespace(L=jax_layers, IT=JaxInputType, C=jax_configuration,
                      U=jax_updaters, net=lambda conf: JaxNet(conf))
PORT = SimpleNamespace(L=port_layers, IT=InputType, C=configuration,
                       U=port_updaters,
                       net=lambda conf: MultiLayerNetwork(conf, device="cpu"))
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


def _torch(tree, device="cpu", grad=False):
    if isinstance(tree, dict):
        return {k: _torch(v, device, grad) for k, v in tree.items()}
    t = torch.tensor(np.asarray(tree), device=device)
    return t.requires_grad_() if grad else t


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _it(ns, spec):
    kind, *dims = spec
    if kind == "conv":
        return ns.IT.convolutional(*dims)
    if kind == "rnn":
        return ns.IT.recurrent(*dims)
    return ns.IT.feedForward(*dims)


def _x_shape(spec):
    kind, *dims = spec
    if kind == "conv":
        h, w, c = dims
        return (N, c, h, w)
    if kind == "rnn":
        return (N, dims[0], dims[1])
    return (N, dims[0])


# name: (layer from a layer module, input type)
LAYER_CASES = {
    "conv_truncate": (lambda L: L.ConvolutionLayer(
        nOut=4, kernelSize=[3, 2], activation="tanh"), ("conv", 7, 6, 3)),
    "conv_same_stride_dilation": (lambda L: L.ConvolutionLayer.Builder()
                                  .nOut(3).kernelSize([3, 3]).stride([2, 2])
                                  .dilation([2, 1])
                                  .convolutionMode(L.ConvolutionMode.SAME)
                                  .activation("relu").build(),
                                  ("conv", 9, 8, 2)),
    "conv_padding_no_bias": (lambda L: L.ConvolutionLayer(
        nOut=5, kernelSize=[2, 3], stride=[2, 1], padding=[1, 2],
        hasBias=False), ("conv", 6, 5, 4)),
    "conv1d": (lambda L: L.Convolution1DLayer(
        nOut=4, kernelSize=3, stride=2, padding=1, activation="tanh"),
        ("rnn", 3, 9)),
    "conv1d_same": (lambda L: L.Convolution1DLayer(
        nOut=2, kernelSize=[4], stride=[2],
        convolutionMode=L.ConvolutionMode.SAME), ("rnn", 5, 7)),
    "separable": (lambda L: L.SeparableConvolution2D(
        nOut=5, depthMultiplier=2, kernelSize=[3, 3],
        convolutionMode=L.ConvolutionMode.SAME), ("conv", 6, 6, 3)),
    "depthwise": (lambda L: L.DepthwiseConvolution2D(
        depthMultiplier=2, kernelSize=[3, 3], stride=[2, 2],
        activation="sigmoid"), ("conv", 7, 7, 3)),
    "deconv": (lambda L: L.Deconvolution2D(
        nOut=3, kernelSize=[3, 3], stride=[2, 2], padding=[1, 1]),
        ("conv", 4, 5, 2)),
    "deconv_same": (lambda L: L.Deconvolution2D(
        nOut=2, kernelSize=[3, 2], stride=[2, 3],
        convolutionMode=L.ConvolutionMode.SAME), ("conv", 3, 4, 3)),
    "pool_max": (lambda L: L.SubsamplingLayer(
        poolingType=L.PoolingType.MAX), ("conv", 6, 7, 3)),
    "pool_avg_padded": (lambda L: L.SubsamplingLayer(
        poolingType=L.PoolingType.AVG, kernelSize=[3, 3], stride=[2, 2],
        padding=[1, 1]), ("conv", 7, 6, 2)),
    "pool_sum_averages": (lambda L: L.SubsamplingLayer(
        poolingType=L.PoolingType.SUM), ("conv", 4, 4, 2)),
    "pool_pnorm_averages": (lambda L: L.SubsamplingLayer.Builder(
        poolingType=L.PoolingType.PNORM).kernelSize([3, 2]).stride([1, 2])
        .build(), ("conv", 5, 6, 2)),
    "pool_max_same": (lambda L: L.SubsamplingLayer(
        kernelSize=[3, 3], stride=[2, 2],
        convolutionMode=L.ConvolutionMode.SAME), ("conv", 7, 8, 2)),
    "pool1d_max": (lambda L: L.Subsampling1DLayer(
        kernelSize=3, stride=2, padding=1), ("rnn", 3, 8)),
    "pool1d_avg": (lambda L: L.Subsampling1DLayer(
        poolingType=L.PoolingType.AVG, kernelSize=3, stride=2, padding=1),
        ("rnn", 3, 9)),
    "batchnorm_conv": (lambda L: L.BatchNormalization(activation="relu"),
                       ("conv", 4, 5, 3)),
    "batchnorm_dense": (lambda L: L.BatchNormalization(decay=0.7, eps=1e-3),
                        ("ff", 6)),
    "batchnorm_rnn_locked": (lambda L: L.BatchNormalization(
        lockGammaBeta=True), ("rnn", 4, 5)),
    "lrn": (lambda L: L.LocalResponseNormalization(k=1.5, alpha=0.1),
            ("conv", 3, 3, 7)),
    "zero_padding_4": (lambda L: L.ZeroPaddingLayer(padding=[1, 2, 0, 3]),
                       ("conv", 3, 4, 2)),
    "zero_padding_2": (lambda L: L.ZeroPaddingLayer(padding=[2, 1]),
                       ("conv", 3, 3, 2)),
    "zero_padding_int": (lambda L: L.ZeroPaddingLayer(padding=1),
                         ("conv", 2, 3, 2)),
    "upsampling": (lambda L: L.Upsampling2D(size=[2, 3]), ("conv", 3, 2, 2)),
    "space_to_depth": (lambda L: L.SpaceToDepth(blockSize=2),
                       ("conv", 4, 6, 3)),
    "depth_to_space": (lambda L: L.DepthToSpace(blockSize=2),
                       ("conv", 3, 2, 8)),
    "global_avg": (lambda L: L.GlobalPoolingLayer(), ("conv", 4, 5, 3)),
    "global_max": (lambda L: L.GlobalPoolingLayer(
        poolingType=L.PoolingType.MAX), ("conv", 4, 3, 3)),
    "global_sum_rnn": (lambda L: L.GlobalPoolingLayer(
        poolingType=L.PoolingType.SUM), ("rnn", 4, 6)),
    "global_pnorm_averages": (lambda L: L.GlobalPoolingLayer(
        poolingType=L.PoolingType.PNORM), ("conv", 3, 3, 2)),
    "dropout": (lambda L: L.DropoutLayer(0.6), ("conv", 3, 3, 2)),
    "activation": (lambda L: L.ActivationLayer(activation="elu"),
                   ("conv", 3, 4, 2)),
    "activation_softmax": (lambda L: L.ActivationLayer.Builder()
                           .activation("softmax").build(), ("ff", 5)),
}

# every layer class of the reference's nn/conf/layers.py:298-834, and
# LossLayer (held by its own test below)
CONV_CLASSES = {
    "ConvolutionLayer", "Convolution1DLayer", "SeparableConvolution2D",
    "DepthwiseConvolution2D", "Deconvolution2D", "SubsamplingLayer",
    "Subsampling1DLayer", "BatchNormalization", "LocalResponseNormalization",
    "ZeroPaddingLayer", "Upsampling2D", "SpaceToDepth", "DepthToSpace",
    "GlobalPoolingLayer", "DropoutLayer", "ActivationLayer"}


def test_the_cases_cover_every_convolutional_layer_class():
    names = {type(make(port_layers)).__name__
             for make, _ in LAYER_CASES.values()}
    assert names == CONV_CLASSES
    assert CONV_CLASSES | {"LossLayer"} <= set(port_layers.LAYER_REGISTRY)
    for name in CONV_CLASSES | {"LossLayer"}:
        assert name in jax_layers.LAYER_REGISTRY


@pytest.mark.parametrize("name", sorted(CONV_CLASSES | {"LossLayer"}))
def test_constructor_defaults_json(name):
    want = jax_layers.LAYER_REGISTRY[name]()
    got = port_layers.LAYER_REGISTRY[name]()
    assert got.to_json() == want.to_json()
    for lr in (want, got):
        lr.apply_defaults({"weightInit": "relu", "dropOut": 0.8,
                           "l2": 1e-4, "updater": JAX.U.Adam(1e-3)
                           if lr is want else PORT.U.Adam(1e-3)})
    assert json.dumps(got.to_json()) == json.dumps(want.to_json())
    back = port_layers.BaseLayer.from_json(want.to_json())
    assert back.to_json() == got.to_json()


def _layer_pair(name):
    make, spec = LAYER_CASES[name]
    pair = []
    for ns in (JAX, PORT):
        lr = make(ns.L)
        lr.apply_defaults({})
        out = lr.infer(_it(ns, spec))
        pair.append((lr, out))
    return pair, spec


def _jax_shapes(jl):
    """The shapes the JAX package's layer draws (traced, not drawn)."""
    return jax.tree_util.tree_map(
        lambda a: tuple(a.shape),
        jax.eval_shape(lambda k: jl.init_params(k, jnp.float32),
                       jax.random.key(0)))


def _random_like(tree, rng, positive=False):
    """Normal draws of ``tree``'s shapes (leaves are shape tuples or
    arrays); ``positive`` makes a "var" leaf positive."""
    if isinstance(tree, dict):
        return {k: _random_like(v, rng, positive and k == "var")
                for k, v in sorted(tree.items())}
    shape = tree if isinstance(tree, tuple) else np.shape(tree)
    a = rng.normal(size=shape).astype(np.float32)
    return (np.abs(a) + 0.5).astype(np.float32) if positive else a


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_layer_json_infer_and_shapes(name):
    ((jl, jout), (pl, pout)), spec = _layer_pair(name)
    assert pl.to_json() == jl.to_json()
    assert pout.to_json() == jout.to_json()
    assert pl.param_shapes() == _jax_shapes(jl)
    gen = torch.Generator().manual_seed(0)
    assert jax.tree_util.tree_map(
        lambda a: tuple(a.shape), _np(pl.init_params(gen))) == \
        pl.param_shapes()
    assert {k: v.shape for k, v in jl.init_state(jnp.float32).items()} == \
        {k: tuple(v.shape) for k, v in pl.init_state().items()}


@pytest.mark.parametrize("training", [False, True], ids=["infer", "train"])
@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_layer_output_and_gradients(name, training):
    ((jl, _), (pl, _)), spec = _layer_pair(name)
    rng = np.random.default_rng(sorted(LAYER_CASES).index(name))
    params = _random_like(_jax_shapes(jl), rng)
    state = _random_like(jl.init_state(jnp.float32), rng, positive=True)
    x = rng.normal(size=_x_shape(spec)).astype(np.float32)

    def jax_fn(p, xx):
        return jl.apply(p, state, xx, training, None)

    jy_shape = jax.eval_shape(jax_fn, params, x)[0].shape
    proj = rng.normal(size=jy_shape).astype(np.float32)
    # one compile for the reference's forward and gradients (op by op,
    # each op compiles on its own)
    (jy, jstate), (jgp, jgx) = jax.jit(lambda p, xx: (jax_fn(p, xx), jax.grad(
        lambda p, xx: jnp.sum(jax_fn(p, xx)[0] * proj), argnums=(0, 1))(
            p, xx)))(params, x)

    tp = _torch(params, grad=True)
    tx = _torch(x, grad=True)
    ty, tstate = pl.apply(tp, _torch(state), tx, training)
    _close(_np(ty), jy, what=f"{name} output")
    assert sorted(tstate) == sorted(jstate)
    for k in jstate:
        _close(_np(tstate[k]), jstate[k], what=f"{name} state {k}")
    flat = [v for _, v in _leaves(tp)]
    grads = torch.autograd.grad((ty * torch.tensor(proj)).sum(),
                                flat + [tx], allow_unused=True)
    for (path, _), g in zip(_leaves(jgp), grads[:-1]):
        want = dict(_leaves(jgp))[path]
        got = np.zeros_like(want) if g is None else _np(g)
        _close(got, want, what=f"{name} d{path}")
    _close(_np(grads[-1]), jgx, what=f"{name} dx")


def test_batchnorm_running_update_is_decay_weighted():
    lr = port_layers.BatchNormalization(decay=0.8)
    lr.apply_defaults({})
    lr.infer(InputType.convolutional(2, 2, 3))
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 2, 2)
    state = {"mean": torch.ones(3), "var": torch.full((3,), 2.0)}
    _, new = lr.apply(lr.init_params(None), state, x, training=True)
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(new["mean"], 0.8 + 0.2 * mean)
    torch.testing.assert_close(new["var"], 1.6 + 0.2 * var)
    y, same = lr.apply(lr.init_params(None), state, x, training=False)
    assert same is state
    torch.testing.assert_close(
        y, (x - 1.0) / torch.sqrt(torch.tensor(2.0 + 1e-5)))


@pytest.mark.parametrize("activation,loss", [("softmax", "mcxent"),
                                             ("identity", "mse"),
                                             ("sigmoid", "xent")])
def test_loss_layer(activation, loss):
    rng = np.random.default_rng(5)
    pre = rng.normal(size=(4, 6)).astype(np.float32)
    labels = np.eye(6, dtype=np.float32)[rng.integers(0, 6, 4)]
    mask = np.array([1, 0, 1, 1], np.float32)
    want = jax_layers.LossLayer(lossFunction=loss, activation=activation)
    got = port_layers.LossLayer(lossFunction=loss, activation=activation)
    for lr in (want, got):
        lr.apply_defaults({})
    assert got.to_json() == want.to_json()
    assert got.param_shapes() == {}
    _close(_np(got.apply({}, {}, torch.tensor(pre))[0]),
           want.apply({}, {}, jnp.asarray(pre), False, None)[0])
    for m in (None, mask):
        tp = torch.tensor(pre, requires_grad=True)
        tl = got.compute_loss({}, tp, torch.tensor(labels),
                              None if m is None else torch.tensor(m))
        jl, jg = jax.value_and_grad(lambda p: want.compute_loss(
            {}, p, jnp.asarray(labels), None if m is None else
            jnp.asarray(m)))(jnp.asarray(pre))
        _close(float(tl.detach()), float(jl))
        _close(_np(torch.autograd.grad(tl, tp)[0]), jg)
    assert isinstance(got, port_layers.OUTPUT_LAYER_TYPES)


def test_dropout_keep_rate_and_scale_by_moments():
    """DropoutLayer draws differ between the packages (threefry against a
    torch.Generator), so each is held to the retain probability p: the
    kept share within 4 sigma of p, kept values exactly x / p, the mean
    of the output within 4 sigma of the input's."""
    p, n = 0.6, 200_000
    x = np.full((n,), 1.5, np.float32)
    port = port_layers.DropoutLayer(p)
    port.apply_defaults({})
    ref = jax_layers.DropoutLayer(p)
    ref.apply_defaults({})
    got = _np(port.apply({}, {}, torch.tensor(x), True,
                         torch.Generator().manual_seed(3))[0])
    want = np.asarray(ref.apply({}, {}, jnp.asarray(x), True,
                                jax.random.key(3))[0])
    sigma = np.sqrt(p * (1 - p) / n)
    for y in (got, want):
        kept = y != 0
        assert abs(kept.mean() - p) < 4 * sigma
        np.testing.assert_array_equal(y[kept], np.float32(1.5 / p))
        assert abs(y.mean() - 1.5) < 4 * 1.5 / p * sigma
    assert not np.array_equal(got, got[::-1])
    # inference and training without a generator pass x through
    for training, gen in ((False, torch.Generator()), (True, None)):
        np.testing.assert_array_equal(
            _np(port.apply({}, {}, torch.tensor(x), training, gen)[0]), x)


# ---------------------------------------------------------------------------
# configurations and networks
# ---------------------------------------------------------------------------

def _conf(ns, name):
    L, IT = ns.L, ns.IT
    b = ns.C.NeuralNetConfiguration.Builder().seed(7).updater(
        ns.U.Adam(1e-2))
    if name == "lenet_flat":
        return (b.weightInit("xavier").list()
                .layer(L.ConvolutionLayer.Builder().nOut(4)
                       .kernelSize([3, 3]).activation("relu").build())
                .layer(L.SubsamplingLayer.Builder(
                    poolingType=L.PoolingType.MAX).kernelSize([2, 2])
                    .stride([2, 2]).build())
                .layer(L.ConvolutionLayer.Builder().nOut(5)
                       .kernelSize([2, 2]).activation("relu").build())
                .layer(L.DenseLayer.Builder().nOut(7).activation("relu")
                       .build())
                .layer(L.OutputLayer.Builder().nOut(4)
                       .activation("softmax").lossFunction("mcxent").build())
                .setInputType(IT.convolutionalFlat(9, 8, 2)).build())
    if name == "pool_first_flat":
        return (b.list()
                .layer(L.SubsamplingLayer(kernelSize=[2, 2], stride=[2, 2]))
                .layer(L.OutputLayer(nOut=3, lossFunction="mcxent"))
                .setInputType(IT.convolutionalFlat(6, 4, 2)).build())
    if name == "bn_dropout_global":
        return (b.weightInit("relu").list()
                .layer(L.ConvolutionLayer(nOut=4, kernelSize=[3, 3],
                                          convolutionMode="same",
                                          activation="relu"))
                .layer(L.BatchNormalization())
                .layer(L.SubsamplingLayer(kernelSize=[2, 2], stride=[2, 2]))
                .layer(L.LocalResponseNormalization(n=3))
                .layer(L.GlobalPoolingLayer())
                .layer(L.DropoutLayer(0.5))
                .layer(L.OutputLayer(nOut=3, activation="softmax",
                                     lossFunction="mcxent"))
                .setInputType(IT.convolutional(8, 6, 3)).build())
    if name == "shape_layers_then_dense":
        return (b.l2(1e-3).list()
                .layer(L.ZeroPaddingLayer(padding=[1, 0, 2, 1]))
                .layer(L.SeparableConvolution2D(nOut=4, kernelSize=[3, 3],
                                                depthMultiplier=2,
                                                activation="tanh"))
                .layer(L.SpaceToDepth(blockSize=2))
                .layer(L.DepthwiseConvolution2D(kernelSize=[2, 2],
                                                depthMultiplier=1,
                                                convolutionMode="same"))
                .layer(L.DepthToSpace(blockSize=2))
                .layer(L.Upsampling2D(size=[1, 2]))
                .layer(L.Deconvolution2D(nOut=2, kernelSize=[2, 2],
                                         stride=[2, 2], activation="relu"))
                .layer(L.ActivationLayer(activation="tanh"))
                .layer(L.BatchNormalization())
                .layer(L.DenseLayer(nOut=5, activation="relu"))
                .layer(L.BatchNormalization())
                .layer(L.OutputLayer(nOut=3, lossFunction="mcxent"))
                .setInputType(IT.convolutional(5, 5, 2)).build())
    if name == "conv1d_no_input_type":
        return (b.list()
                .layer(L.Convolution1DLayer(nIn=3, nOut=4, kernelSize=3,
                                            activation="relu"))
                .layer(L.Subsampling1DLayer(kernelSize=2, stride=2))
                .layer(L.GlobalPoolingLayer(poolingType="max"))
                .layer(L.DenseLayer(nOut=5, activation="tanh"))
                .layer(L.OutputLayer(nOut=2, lossFunction="mcxent"))
                .build())
    if name == "loss_layer_head":
        return (b.list()
                .layer(L.ConvolutionLayer(nOut=3, kernelSize=[1, 1],
                                          convolutionMode="same"))
                .layer(L.GlobalPoolingLayer())
                .layer(L.LossLayer(lossFunction="mcxent",
                                   activation="softmax"))
                .setInputType(IT.convolutional(4, 4, 2)).build())
    raise KeyError(name)


CONFS = ["lenet_flat", "pool_first_flat", "bn_dropout_global",
         "shape_layers_then_dense", "conv1d_no_input_type",
         "loss_layer_head"]


def _data(conf, n, seed, jconf):
    rng = np.random.default_rng(seed)
    it = jconf.inputType
    if it is None:
        shape = (n, 3, 10)
    else:
        shape = (n,) + tuple(it.batch_shape(1)[1:])
    x = rng.normal(size=shape).astype(np.float32)
    classes = next(lr.nOut for lr in reversed(conf.layers)
                   if getattr(lr, "nOut", None))
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def _jax_net(port):
    """The JAX package's network from the port's configuration JSON, on
    the port's params and layer states. Its ``init`` draws nothing: each
    layer hands out the port's params for the call (a threefry draw
    compiles once a shape, seconds a network on the CPU)."""
    jconf = jax_configuration.MultiLayerConfiguration.from_json(
        port.conf.to_json())
    for lr, p in zip(jconf.layers, _np(port._params)):
        lr.init_params = lambda key, dtype, p=p: jax.tree_util.tree_map(
            jnp.asarray, p)
    jnet = JaxNet(jconf).init()
    for lr in jconf.layers:
        del lr.init_params
    jnet._states = [jax.tree_util.tree_map(jnp.asarray, s)
                    for s in _np(port._states)]
    return jnet


def _pair(name, random_states=False):
    """(JAX network, port network) on the same weights drawn by the port
    from the configuration's seed; ``random_states`` puts a random
    running mean and a positive variance in each BatchNormalization."""
    port = MultiLayerNetwork(_conf(PORT, name), device="cpu").init()
    if random_states:
        rng = np.random.default_rng(1)
        port._states = states_from_numpy(port.conf, [
            _random_like(_np(st), rng, positive=True)
            for st in port._states], "cpu")
    return _jax_net(port), port


@pytest.mark.parametrize("name", CONFS)
def test_configuration_json_both_ways_and_preprocessors(name):
    jconf, pconf = _conf(JAX, name), _conf(PORT, name)
    assert pconf.to_json() == jconf.to_json()
    assert configuration.MultiLayerConfiguration.from_json(
        jconf.to_json()).to_json() == jconf.to_json()
    assert jax_configuration.MultiLayerConfiguration.from_json(
        pconf.to_json()).to_json() == pconf.to_json()
    assert pconf.preprocessors == jconf.preprocessors
    assert [None if t is None else t.to_json()
            for t in pconf.layer_input_types] == [
        None if t is None else t.to_json() for t in jconf.layer_input_types]
    for lr in pconf.layers:
        ref = jax_layers.LAYER_REGISTRY[type(lr).__name__]()
        assert configuration._wants_conv(lr) == \
            jax_configuration._wants_conv(ref)


def test_lenet_flat_records_reshape_then_channel_major_flatten():
    conf = _conf(PORT, "lenet_flat")
    assert conf.preprocessors == [("ff_to_cnn", (2, 9, 8)), None, None,
                                  ("cnn_to_ff", None), None]
    x = torch.arange(2 * 5 * 2 * 2, dtype=torch.float32).reshape(2, 5, 2, 2)
    flat = configuration._apply_preprocessor(conf.preprocessors[3], x)
    assert torch.equal(flat[1, :4], x[1, 0].reshape(-1))
    assert configuration._apply_preprocessor(None, x) is x
    with pytest.raises(ValueError, match="unknown preprocessor"):
        configuration._apply_preprocessor(("nope", None), x)


@pytest.mark.parametrize("name", CONFS)
def test_network_output_score_and_gradients(name):
    """The reference's feedForward, score and gradients each run under one
    jax.jit (op by op they compile an executable an op)."""
    jnet, port = _pair(name, random_states=True)
    x, y = _data(port.conf, 5, 11, jnet.conf)
    _close(port.output(x).toNumpy(), jnet.output(x).toNumpy())
    acts = jax.jit(lambda xx: [a.jax() for a in jnet.feedForward(xx)])(x)
    assert len(acts) == len(port.layers) + 1
    for a, b in zip(port.feedForward(x), acts):
        _close(a.toNumpy(), b)
    _close(port.score((x, y)), jax.jit(lambda xx, yy: jnet._loss_from(
        jnet._params, jnet._states, xx, yy, False, None)[0])(x, y))
    assert abs(port.score((x, y)) - jnet.score((x, y))) <= \
        FN_RTOL * abs(jnet.score((x, y)))
    for i, (gp, gj) in enumerate(zip(port.gradients(x, y),
                                     jax.jit(jnet.gradients)(x, y))):
        for (path, want) in _leaves(gj):
            _close(_np(dict(_leaves(gp))[path]), want,
                   what=f"layer {i} d{path}")


# ---------------------------------------------------------------------------
# BatchNormalization state through fit
# ---------------------------------------------------------------------------

def _compare_trained(port, jnet, what):
    """States, params and Adam moments, each array to TRAIN_RTOL of its
    largest element."""
    for i, (sp, sj) in enumerate(zip(port._states, jnet._states)):
        assert sorted(sp) == sorted(sj), (i, sp, sj)
        for k in sj:
            _close(_np(sp[k]), sj[k], TRAIN_RTOL, f"{what} state {i} {k}")
    for i, (pp, pj) in enumerate(zip(port._params, jnet._params)):
        for path, want in _leaves(pj):
            _close(_np(dict(_leaves(pp))[path]), want, TRAIN_RTOL,
                   f"{what} param {i} {path}")
    for i, (op, oj) in enumerate(zip(opt_states_to_numpy(port._opt_states),
                                     jnet._opt_states)):
        if not isinstance(oj, dict):   # a layer without params
            assert op == oj == ()
            continue
        for path, want in _leaves(oj):
            _close(dict(_leaves(op))[path], want, TRAIN_RTOL,
                   f"{what} moment {i} {path}")


@pytest.mark.parametrize("name", ["bn_dropout_global",
                                  "shape_layers_then_dense"])
def test_fit_keeps_batchnorm_running_stats_with_a_ragged_batch(name):
    """Batches of 8, 8 and 5 rows: the last pads to 8 with its last row
    repeated 3 times, and those rows enter the batch statistics in both
    packages. Dropout is held at 1.0 (parity is by weights, not draws)."""
    jnet, port = _pair(name)
    for net in (jnet, port):
        for lr in net.layers:
            if type(lr).__name__ == "DropoutLayer":
                lr.dropOut = 1.0
    batches = [_data(port.conf, n, 20 + k, jnet.conf)
               for k, n in enumerate((8, 8, 5))]
    before = [_np(s) for s in port._states]
    for x, y in batches:
        jnet.fit([(x, y)])
        port.fit([(x, y)])
        _close(port.score(), jnet.score(), what="loss")
    assert port._bucket == 8
    _compare_trained(port, jnet, name)
    moved = [i for i, (b, s) in enumerate(zip(before, port._states))
             if b and not np.allclose(b["mean"], _np(s["mean"]))]
    assert moved == [i for i, lr in enumerate(port.layers)
                     if type(lr).__name__ == "BatchNormalization"]
    # the padding rows count: the same steps on an unpadded last batch
    # give other statistics
    port2 = _pair(name)[1]
    for x, y in batches[:2]:
        port2.fit([(x, y)])
    port2._bucket = None
    port2.fit([batches[2]])
    i = moved[0]
    assert not np.allclose(_np(port2._states[i]["mean"]),
                           _np(port._states[i]["mean"]))


def _tbptt_conf(ns):
    L = ns.L
    return (ns.C.NeuralNetConfiguration.Builder().seed(3)
            .updater(ns.U.Adam(1e-2)).list()
            .layer(L.LSTM(nOut=5))
            .layer(L.BatchNormalization())
            .layer(L.RnnOutputLayer(nOut=3, activation="softmax",
                                    lossFunction="mcxent"))
            .setInputType(ns.IT.recurrent(4, 10)).tBPTTLength(4).build())


def test_tbptt_keeps_batchnorm_state_and_drops_the_lstm_s():
    assert _tbptt_conf(PORT).to_json() == _tbptt_conf(JAX).to_json()
    port = MultiLayerNetwork(_tbptt_conf(PORT), device="cpu").init()
    jnet = _jax_net(port)
    rng = np.random.default_rng(4)
    for n in (4, 3):
        x = rng.normal(size=(n, 4, 10)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (n, 10))
                                        ].transpose(0, 2, 1)
        jnet.fit([(x, y)])
        port.fit([(x, y)])
        _close(port.score(), jnet.score(), what="loss")
    assert port._states[0] == {} and sorted(port._states[1]) == ["mean",
                                                                  "var"]
    _compare_trained(port, jnet, "tbptt")


def test_states_from_and_to_numpy():
    conf = _conf(PORT, "bn_dropout_global")
    arrays = [{} for _ in conf.layers]
    arrays[1] = {"mean": np.arange(4, dtype=np.float64),
                 "var": np.ones(4, np.float32)}
    states = states_from_numpy(conf, arrays, "cpu")
    assert states[0] == {} and states[1]["mean"].dtype == torch.float32
    arrays[1]["mean"][0] = 9.0   # a copy, not an alias
    assert float(states[1]["mean"][0]) == 0.0
    back = states_to_numpy(states)
    np.testing.assert_array_equal(back[1]["mean"], np.arange(4))
    with pytest.raises(ValueError, match="layer 1 .BatchNormalization. "
                                         "state"):
        states_from_numpy(conf, [{}] * len(conf.layers), "cpu")
    bad = [dict(a) for a in arrays]
    bad[1]["var"] = np.ones(5, np.float32)
    with pytest.raises(ValueError, match="shape"):
        states_from_numpy(conf, bad, "cpu")
    with pytest.raises(ValueError, match="layer states for"):
        states_from_numpy(conf, arrays[:2], "cpu")


# ---------------------------------------------------------------------------
# the reference's tests/test_nn.py::TestConvNet, run on both packages
# ---------------------------------------------------------------------------

def _xy(n=32, fin=10, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, fin)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return X, y


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
class TestConvNet:
    def test_lenet_flat_input_trains(self, pkg):
        ns = PACKAGES[pkg]
        L, IT = ns.L, ns.IT
        conf = (ns.C.NeuralNetConfiguration.Builder().seed(1)
                .updater(ns.U.Adam(1e-3))
                .list()
                .layer(L.ConvolutionLayer.Builder().nOut(4).kernelSize([5, 5])
                       .activation("relu").build())
                .layer(L.SubsamplingLayer.Builder().kernelSize([2, 2])
                       .stride([2, 2]).build())
                .layer(L.DenseLayer.Builder().nOut(16).activation("relu")
                       .build())
                .layer(L.OutputLayer.Builder().nOut(10).activation("softmax")
                       .lossFunction("mcxent").build())
                .setInputType(IT.convolutionalFlat(12, 12, 1))
                .build())
        # nIn inference through the conv stack
        assert conf.layers[0].nIn == 1
        assert conf.layers[2].nIn == 4 * 4 * 4
        net = ns.net(conf).init()
        rng = np.random.default_rng(0)
        X = rng.normal(size=(16, 144)).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)]
        s0 = net.score((X, y))
        net.fit([(X, y)], 20)
        assert net.score((X, y)) < s0

    def test_batchnorm_running_stats_update(self, pkg):
        ns = PACKAGES[pkg]
        L = ns.L
        conf = (ns.C.NeuralNetConfiguration.Builder().seed(1)
                .updater(ns.U.Sgd(1e-2))
                .list()
                .layer(L.DenseLayer.Builder().nIn(8).nOut(8)
                       .activation("identity").build())
                .layer(L.BatchNormalization.Builder().build())
                .layer(L.OutputLayer.Builder().nOut(3).activation("softmax")
                       .lossFunction("mcxent").build())
                .setInputType(ns.IT.feedForward(8))
                .build())
        net = ns.net(conf).init()
        X, y = _xy(fin=8)
        mean_before = _np(net._states[1]["mean"])
        net.fit([(X, y)], 5)
        mean_after = _np(net._states[1]["mean"])
        assert not np.allclose(mean_before, mean_after)

    def test_global_pooling(self, pkg):
        ns = PACKAGES[pkg]
        L = ns.L
        conf = (ns.C.NeuralNetConfiguration.Builder().seed(1)
                .updater(ns.U.Sgd(0.1))
                .list()
                .layer(L.ConvolutionLayer.Builder().nOut(6).kernelSize([3, 3])
                       .activation("relu").build())
                .layer(L.GlobalPoolingLayer.Builder().build())
                .layer(L.OutputLayer.Builder().nOut(2).activation("softmax")
                       .lossFunction("mcxent").build())
                .setInputType(ns.IT.convolutional(8, 8, 3))
                .build())
        net = ns.net(conf).init()
        X = np.random.default_rng(0).normal(size=(4, 3, 8, 8)).astype(
            np.float32)
        assert net.output(X).shape() == (4, 2)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@cuda
@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_cuda_layer_matches_the_cpu(card, name):
    make, spec = LAYER_CASES[name]
    lr = make(port_layers)
    lr.apply_defaults({})
    lr.infer(_it(PORT, spec))
    gen = torch.Generator().manual_seed(1)
    params = _np(lr.init_params(gen))
    state = _np(lr.init_state())
    x = np.random.default_rng(2).normal(size=_x_shape(spec)).astype(
        np.float32)
    for training in (False, True):
        want, wstate = lr.apply(_torch(params), _torch(state), _torch(x),
                                training)
        got, gstate = lr.apply(_torch(params, card), _torch(state, card),
                               _torch(x, card), training)
        assert got.device.type == "cuda"
        _close(_np(got), _np(want), rtol=CARD_TOL, what=name)
        for k in wstate:
            _close(_np(gstate[k]), _np(wstate[k]), rtol=CARD_TOL)


@cuda
@pytest.mark.parametrize("name", CONFS)
def test_cuda_network_fit_matches_the_cpu(card, name):
    """From the same weights: output, gradients, a fit step's loss and the
    running statistics it leaves (the step's forward is at equal
    weights; after it, Adam's first steps move weights whose gradients
    are rounding noise by +-lr on either device, so later steps are not
    compared here)."""
    conf = _conf(PORT, name)
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    for lr in cpu.layers:
        if type(lr).__name__ == "DropoutLayer":
            lr.dropOut = 1.0
    gpu = MultiLayerNetwork(configuration.MultiLayerConfiguration.from_json(
        cpu.conf.to_json())).init(params_from_numpy(
            cpu.conf, _np(cpu._params), card))
    assert gpu.device.type == "cuda"
    x, y = _data(conf, 6, 30, conf)
    _close(gpu.output(x).toNumpy(), cpu.output(x).toNumpy(), rtol=CARD_TOL)
    for i, (gg, gc) in enumerate(zip(gpu.gradients(x, y),
                                     cpu.gradients(x, y))):
        for path, want in _leaves(gc):
            _close(_np(dict(_leaves(gg))[path]), _np(want), rtol=CARD_TOL,
                   what=f"layer {i} d{path}")
    gpu.fit([(x, y)])
    cpu.fit([(x, y)])
    _close(gpu.score(), cpu.score(), rtol=CARD_TOL)
    for sg, sc in zip(gpu._states, cpu._states):
        for k in sc:
            _close(_np(sg[k]), _np(sc[k]), rtol=CARD_TOL)
