"""The structural and specialty layers in the port, against the JAX
package.

- Each layer of ``nn/conf/layers_extra.py`` but MoELayer: JSON both
  ways, ``infer``, and the output with its param and input gradients to
  1e-5 of each array's largest element, on transferred weights
  (Cropping1D/2D/3D, Upsampling1D/3D, Convolution3D truncate and SAME
  with stride, padding and dilation, Subsampling3DLayer MAX, AVG and SAME,
  LocallyConnected2D/1D with stride and padding, PReLULayer on conv and
  dense input, RepeatVector, ElementWiseMultiplicationLayer, the wrappers
  MaskZeroLayer(LSTM), FrozenLayer(Dense), FrozenLayer(BatchNormalization)
  in training).
- The configuration's shape inference: a first FrozenLayer or
  MaskZeroLayer declares the input kind by its inner layer, and
  Cropping2D, FrozenLayer(BatchNormalization), LocallyConnected2D,
  PReLULayer and PrimaryCapsules take conv input unflattened, with the
  JAX package's preprocessors.
- Networks, each step from the same state in both packages (losses to
  1e-5 relative, params and updater state to 1e-4 of each array's
  largest): Convolution3D + Subsampling3D + dense; MaskZeroLayer(LSTM)
  over zero-padded sequences; FrozenLayer(LSTM) whose weights stay
  bit-equal while the layer below trains through it; CenterLossOutputLayer
  (centres as params); OCNNOutputLayer through the loss-state channel
  (loss, the state's ``r`` and ``seen``, gradients, 5 steps).
- The reference's own cases: the oversized-crop errors, CenterLoss's
  alpha warning once, a frozen BatchNormalization's state untouched by
  ``fit``.
- ModelSerializer zips holding a FrozenLayer(BatchNormalization) state,
  OCNN's ``r`` and ``seen`` and CenterLoss's centres restore in the other
  package.
A ``cuda`` case takes MaskZeroLayer(LSTM) and FrozenLayer(LSTM) to the
card against the CPU.
"""

import warnings

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nn as J
from deeplearning4j_tpu.nn.conf import layers_extra as jx_extra
from deeplearning4j_tpu.optimize import updaters as JU
from deeplearning4j_tpu.utils.serializer import (
    ModelSerializer as JaxSerializer)
from deeplearning4j_tpu_torch import nn as P
from deeplearning4j_tpu_torch.nn.conf import layers_extra
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import updaters as PU
from deeplearning4j_tpu_torch.utils import ModelSerializer
from torch_parity import (
    FN_RTOL, TRAIN_RTOL, as_torch, check_layer, close, compare_trees,
    net_pair, sync, to_np)

cuda = pytest.mark.cuda


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _conf(pkg, layers, input_type=None, updater=None, seed=3):
    U = JU if pkg is J else PU
    b = (pkg.NeuralNetConfiguration.Builder().seed(seed)
         .updater(updater or U.Adam(1e-2)).list())
    for lr in layers:
        b = b.layer(lr)
    if input_type is not None:
        b = b.setInputType(input_type)
    return b.build()


def _first_layer_pair(make, it):
    """Layer 0 of a one-layer-plus-LossLayer configuration built by
    ``make(pkg)`` in the JAX package, and the port's from its JSON, with
    the port's params for it as numpy and its state."""
    jconf = _conf(J, [make(J), J.LossLayer(lossFunction="mse",
                                           activation="identity")],
                  it(J.InputType))
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert conf.to_json() == jconf.to_json()
    jl, pl = jconf.layers[0], conf.layers[0]
    assert pl.to_json() == jl.to_json()
    params = to_np(pl.init_params(torch.Generator().manual_seed(1)))
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        pl.param_shapes()
    state = to_np(pl.init_state())
    return jl, pl, params, state, (conf.layer_input_types[0],
                                   jconf.layer_input_types[0])


LAYERS = {
    "cropping1d": (lambda m: m.Cropping1D(cropping=(1, 2)),
                   lambda T: T.recurrent(3, 8), (2, 3, 8)),
    "cropping2d": (lambda m: m.Cropping2D(cropping=(1, 0, 2, 1)),
                   lambda T: T.convolutional(6, 7, 2), (2, 2, 6, 7)),
    "cropping3d": (lambda m: m.Cropping3D(cropping=(1, 1, 0)),
                   lambda T: T.convolutional3D(4, 5, 3, 2),
                   (2, 2, 4, 5, 3)),
    "upsampling1d": (lambda m: m.Upsampling1D(size=3),
                     lambda T: T.recurrent(3, 4), (2, 3, 4)),
    "upsampling3d": (lambda m: m.Upsampling3D(size=(2, 1, 3)),
                     lambda T: T.convolutional3D(2, 3, 2, 2),
                     (2, 2, 2, 3, 2)),
    "conv3d": (lambda m: m.Convolution3D.Builder(
        nOut=3, kernelSize=[2, 3, 2], stride=[1, 2, 1], padding=[1, 0, 1],
        activation="tanh").build(),
        lambda T: T.convolutional3D(4, 5, 4, 2), (2, 2, 4, 5, 4)),
    "conv3d_same_dilated": (lambda m: m.Convolution3D.Builder(
        nOut=2, kernelSize=[3, 2, 2], stride=[2, 1, 2], dilation=[1, 2, 1],
        convolutionMode=m.ConvolutionMode.SAME).build(),
        lambda T: T.convolutional3D(5, 4, 5, 3), (2, 3, 5, 4, 5)),
    "subsampling3d_max": (lambda m: m.Subsampling3DLayer.Builder(
        kernelSize=[2, 2, 2], stride=[2, 2, 2]).build(),
        lambda T: T.convolutional3D(4, 4, 5, 2), (2, 2, 4, 4, 5)),
    "subsampling3d_avg_same": (lambda m: m.Subsampling3DLayer.Builder(
        poolingType=m.PoolingType.AVG, kernelSize=[2, 3, 2],
        stride=[2, 2, 1], convolutionMode=m.ConvolutionMode.SAME).build(),
        lambda T: T.convolutional3D(5, 5, 3, 2), (2, 2, 5, 5, 3)),
    "subsampling3d_sum_padded": (lambda m: m.Subsampling3DLayer.Builder(
        poolingType=m.PoolingType.SUM, kernelSize=[2, 2, 2],
        stride=[1, 2, 2], padding=[1, 0, 1]).build(),
        lambda T: T.convolutional3D(3, 4, 4, 1), (2, 1, 3, 4, 4)),
    "locally2d": (lambda m: m.LocallyConnected2D.Builder(
        nOut=3, kernelSize=[2, 3], stride=[1, 2], padding=[1, 0],
        activation="tanh").build(),
        lambda T: T.convolutional(5, 6, 2), (2, 2, 5, 6)),
    "locally1d": (lambda m: m.LocallyConnected1D.Builder(
        nOut=3, kernelSize=3, stride=2, padding=1, activation="tanh")
        .build(), lambda T: T.recurrent(2, 7), (2, 2, 7)),
    "prelu_conv": (lambda m: m.PReLULayer(alphaInit=0.2),
                   lambda T: T.convolutional(3, 3, 4), (2, 4, 3, 3)),
    "prelu_dense": (lambda m: m.PReLULayer(alphaInit=-0.3),
                    lambda T: T.feedForward(5), (3, 5)),
    "repeat_vector": (lambda m: m.RepeatVector(repetitionFactor=4),
                      lambda T: T.feedForward(3), (2, 3)),
    "elementwise_mult": (lambda m: m.ElementWiseMultiplicationLayer(
        activation="tanh", biasInit=0.3), lambda T: T.feedForward(4),
        (3, 4)),
    "maskzero_lstm": (lambda m: m.MaskZeroLayer(
        underlying=m.LSTM.Builder(nOut=4).build(), maskingValue=0.0),
        lambda T: T.recurrent(3, 6), (2, 3, 6)),
    "frozen_dense": (lambda m: m.FrozenLayer(
        layer=m.DenseLayer.Builder(nOut=5, activation="tanh").build()),
        lambda T: T.feedForward(4), (3, 4)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_the_reference(name):
    make, it, shape = LAYERS[name]
    jl, pl, params, state, in_type = _first_layer_pair(make, it)
    x = np.random.default_rng(len(name)).normal(size=shape).astype(
        np.float32)
    if name == "maskzero_lstm":
        x[0, :, 4:] = 0.0            # padded tail
        x[1, :, 2] = 0.0             # an interior masked step
    assert pl.infer(in_type[0]).to_json() == jl.infer(in_type[1]).to_json()
    y = check_layer(jl, pl, params, x, state)
    if name == "maskzero_lstm":
        assert np.all(y[0, :, 4:] == 0) and np.all(y[1, :, 2] == 0)
        assert np.any(y[1, :, 3] != 0)


def test_frozen_batchnorm_runs_in_inference_even_in_training():
    make = lambda m: m.FrozenLayer(  # noqa: E731
        layer=m.BatchNormalization.Builder().build())
    jl, pl, params, state, _ = _first_layer_pair(
        make, lambda T: T.convolutional(3, 3, 2))
    state = {"mean": np.array([0.5, -1.0], np.float32),
             "var": np.array([2.0, 0.5], np.float32)}
    x = np.random.default_rng(0).normal(size=(4, 2, 3, 3)).astype(
        np.float32)
    check_layer(jl, pl, params, x, state, training=True)
    _, new = pl.apply(as_torch(params), as_torch(state), torch.tensor(x),
                      True)
    compare_trees(new, state, 0.0, "frozen BN state")
    assert isinstance(pl.updater, PU.NoOp)


def test_wrappers_json_nests_the_inner_layer():
    jconf = _conf(J, [J.FrozenLayer(layer=J.DenseLayer.Builder(
        nIn=4, nOut=5).build()), J.MaskZeroLayer(
            underlying=J.DenseLayer.Builder(nOut=3).build()),
        J.OutputLayer.Builder().nOut(2).build()], updater=JU.Sgd(0.1))
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert conf.to_json() == jconf.to_json()
    fl, mz = conf.layers[0], conf.layers[1]
    assert isinstance(fl.layer, P.DenseLayer) and \
        isinstance(mz.underlying, P.DenseLayer)
    assert isinstance(fl.updater, PU.NoOp)
    assert isinstance(mz.updater, PU.Sgd)
    assert '"__layer__"' in conf.to_json()


# ---------------------------------------------------------------------------
# shape inference: _finalize and _wants_conv
# ---------------------------------------------------------------------------

FINALIZE = {
    "frozen_first_declares_ff": lambda m: (
        [m.FrozenLayer(layer=m.DenseLayer.Builder(nIn=6, nOut=4).build()),
         m.OutputLayer.Builder().nOut(2).build()], None),
    "maskzero_first_declares_recurrent": lambda m: (
        [m.MaskZeroLayer(underlying=m.LSTM.Builder(nIn=3, nOut=4).build()),
         m.RnnOutputLayer.Builder().nOut(2).build()], None),
    "vae_first_declares_ff": lambda m: (
        [m.VariationalAutoencoder.Builder(nIn=6, nOut=2,
                                          encoderLayerSizes=(4,),
                                          decoderLayerSizes=(4,)).build(),
         m.OutputLayer.Builder().nOut(2).build()], None),
    "conv_takers_unflattened": lambda m: (
        [m.ConvolutionLayer.Builder().nOut(3).kernelSize([2, 2]).build(),
         m.Cropping2D(cropping=1),
         m.PReLULayer(),
         m.FrozenLayer(layer=m.BatchNormalization.Builder().build()),
         m.LocallyConnected2D.Builder(nOut=2, kernelSize=[2, 2]).build(),
         m.FrozenLayer(layer=m.DenseLayer.Builder(nOut=3).build()),
         m.OutputLayer.Builder().nOut(2).build()],
        m.InputType.convolutional(8, 8, 2)),
    "flat_to_capsules": lambda m: (
        [m.PrimaryCapsules(capsuleDimensions=4, channels=2,
                           kernelSize=(3, 3), stride=(2, 2)),
         m.CapsuleLayer(capsules=3, capsuleDimensions=4, routings=2),
         m.CapsuleStrengthLayer(),
         m.LossLayer(lossFunction="mse", activation="identity")],
        m.InputType.convolutionalFlat(9, 9, 1)),
}


@pytest.mark.parametrize("name", sorted(FINALIZE))
def test_finalize_infers_as_the_reference(name):
    jl, jit = FINALIZE[name](J)
    jconf = _conf(J, jl, jit)
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert conf.preprocessors == jconf.preprocessors
    assert [t.to_json() for t in conf.layer_input_types] == [
        t.to_json() for t in jconf.layer_input_types]
    assert conf.to_json() == jconf.to_json()
    pl, pit = FINALIZE[name](P)
    built = _conf(P, pl, pit)
    assert built.preprocessors == jconf.preprocessors
    assert built.to_json() == jconf.to_json()


# ---------------------------------------------------------------------------
# networks, trained in both packages
# ---------------------------------------------------------------------------

def _train_pair(jconf, batches, seed=0, check=None):
    """Each batch one step in both packages from the port's state; losses
    to 1e-5 relative, params and updater state to 1e-4. Returns the
    port's network."""
    port, jnet = net_pair(jconf, seed)
    x0, y0 = batches[0]
    close(port.output(x0).toNumpy(), np.asarray(jnet.output(x0).numpy()))
    compare_trees(port.gradients(x0, y0), jnet.gradients(x0, y0), FN_RTOL,
                  "gradients")
    for step, (x, y) in enumerate(batches):
        sync(port, jnet)
        port.fit((x, y))
        jnet.fit((x, y))
        assert abs(port.score() - jnet.score()) <= FN_RTOL * abs(
            jnet.score()), (step, port.score(), jnet.score())
        compare_trees([port._params, port._opt_states],
                      [jnet._params, jnet._opt_states], TRAIN_RTOL,
                      f"step {step}", TRAIN_RTOL * 1e-4)
        if check is not None:
            check(port, jnet)
    return port


def _cls(n, k, seed):
    return np.eye(k, dtype=np.float32)[
        np.random.default_rng(seed).integers(0, k, n)]


def test_conv3d_net_trains_as_the_reference():
    jconf = _conf(J, [
        J.Convolution3D.Builder(nOut=4, kernelSize=[2, 2, 2],
                                convolutionMode=J.ConvolutionMode.SAME,
                                activation="relu").build(),
        J.Subsampling3DLayer.Builder(kernelSize=[2, 2, 2],
                                     stride=[2, 2, 2]).build(),
        J.DenseLayer.Builder(nOut=8, activation="tanh").build(),
        J.OutputLayer.Builder(nOut=2).build()],
        J.InputType.convolutional3D(4, 4, 4, 2))
    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(3, 2, 4, 4, 4)).astype(np.float32),
                _cls(3, 2, s)) for s in range(3)]
    port = _train_pair(jconf, batches)
    acts = port.feedForward(batches[0][0])
    assert acts[1].shape() == (3, 4, 4, 4, 4)
    assert acts[2].shape() == (3, 4, 2, 2, 2)


def _padded_sequences(n, c, t, seed):
    """Float sequences with zero-padded tails of random lengths."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, c, t)).astype(np.float32)
    for i, length in enumerate(rng.integers(2, t + 1, n)):
        x[i, :, length:] = 0.0
    return x


def test_maskzero_lstm_net_trains_as_the_reference():
    jconf = _conf(J, [
        J.MaskZeroLayer(underlying=J.LSTM.Builder(nOut=5).build()),
        J.RnnOutputLayer.Builder().nOut(2).build()],
        J.InputType.recurrent(3, 7))
    batches = [(_padded_sequences(4, 3, 7, s),
                np.eye(2, dtype=np.float32)[np.random.default_rng(s)
                                            .integers(0, 2, (4, 7))]
                .transpose(0, 2, 1)) for s in range(3)]
    port = _train_pair(jconf, batches)
    h = port.feedForward(batches[0][0])[1].toNumpy()
    pad = np.all(batches[0][0] == 0, axis=1)
    assert np.all(h.transpose(0, 2, 1)[pad] == 0)


def test_frozen_lstm_keeps_its_weights_and_passes_gradients():
    jconf = _conf(J, [
        J.DenseLayer.Builder(nOut=4, activation="tanh").build(),
        J.FrozenLayer(layer=J.LSTM.Builder(nOut=5).build()),
        J.RnnOutputLayer.Builder().nOut(2).build()],
        J.InputType.recurrent(3, 6))
    rng = np.random.default_rng(2)
    batches = [(rng.normal(size=(4, 3, 6)).astype(np.float32),
                np.eye(2, dtype=np.float32)[rng.integers(0, 2, (4, 6))]
                .transpose(0, 2, 1)) for _ in range(3)]
    port, jnet = net_pair(jconf, 0)
    frozen = to_np(port._params[1])
    below = to_np(port._params[0])
    grads = port.gradients(*batches[0])
    assert float(grads[1]["R"].abs().max()) > 0   # the kernel's backward
    assert float(grads[0]["W"].abs().max()) > 0   # reached the layer below
    port = _train_pair(jconf, batches)
    for k, v in frozen.items():
        np.testing.assert_array_equal(to_np(port._params[1][k]), v)
    assert not np.allclose(to_np(port._params[0]["W"]), below["W"])


def test_center_loss_net_trains_as_the_reference():
    jconf = _conf(J, [
        J.DenseLayer.Builder(nIn=6, nOut=4, activation="tanh").build(),
        J.CenterLossOutputLayer.Builder(nOut=3, lambdaCoeff=0.05).build()])
    rng = np.random.default_rng(1)
    batches = [(rng.normal(size=(6, 6)).astype(np.float32), _cls(6, 3, s))
               for s in range(3)]
    port = _train_pair(jconf, batches)
    assert port._params[1]["centers"].shape == (3, 4)
    assert float(port._params[1]["centers"].abs().max()) > 0


def _ocnn_conf(pkg, **kw):
    return _conf(pkg, [
        pkg.DenseLayer.Builder(nIn=2, nOut=6, activation="tanh").build(),
        pkg.OCNNOutputLayer.Builder(hiddenSize=5, nu=0.1, **kw).build()])


@pytest.mark.parametrize("window", [64, 10000])
def test_ocnn_loss_state_channel_matches_the_reference(window):
    """OCNN through the loss-state channel, 5 steps: the loss, the
    gradients, r (the smoothed quantile) and seen, each from the same
    state; labels are ignored."""
    jconf = _ocnn_conf(J, windowSize=window)
    rng = np.random.default_rng(4)
    t = rng.normal(size=(32, 1)).astype(np.float32)
    x = np.concatenate([t, t + 0.05 * rng.normal(size=(32, 1))
                        .astype(np.float32)], axis=1)
    dummy = np.zeros((32, 1), np.float32)

    def state_check(port, jnet):
        close(to_np(port._states[1]["r"]), np.asarray(jnet._states[1]["r"]),
              FN_RTOL, "r")
        assert port._states[1]["seen"].dtype == torch.int32
        assert int(port._states[1]["seen"]) == int(jnet._states[1]["seen"])

    port = _train_pair(jconf, [(x, dummy)] * 5, check=state_check)
    assert int(port._states[1]["seen"]) == 5
    assert float(port._states[1]["r"]) != 0.0
    scores = port.output(x).toNumpy()
    assert scores.shape == (32, 1)


# ---------------------------------------------------------------------------
# the reference's own cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [J, P], ids=["jax", "torch"])
def test_oversized_crop_raises(m):
    with pytest.raises(ValueError):
        m.Cropping2D(cropping=(5, 4, 0, 0)).infer(
            m.InputType.convolutional(8, 8, 1))
    with pytest.raises(ValueError):
        m.Cropping1D(cropping=(3, 3)).infer(m.InputType.recurrent(2, 5))
    with pytest.raises(ValueError):
        m.Cropping3D(cropping=(2, 0, 0)).infer(
            m.InputType.convolutional3D(3, 3, 3, 1))


@pytest.mark.parametrize("cls", [jx_extra.CenterLossOutputLayer,
                                 layers_extra.CenterLossOutputLayer],
                         ids=["jax", "torch"])
def test_center_loss_alpha_warns_once(cls):
    cls._warned_alpha = False
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        cls.Builder(nIn=3, nOut=2, alpha=0.25).build()
        cls.Builder(nIn=3, nOut=2, alpha=0.25).build()
    assert len([w for w in rec if "alpha" in str(w.message)]) == 1


def test_frozen_batchnorm_state_untouched_by_fit():
    conf = _conf(P, [
        P.DenseLayer.Builder(nIn=4, nOut=5, activation="tanh").build(),
        P.FrozenLayer(layer=P.BatchNormalization.Builder().nIn(5).build()),
        P.OutputLayer.Builder(nIn=5, nOut=2).build()])
    net = MultiLayerNetwork(conf, device="cpu").init()
    m0 = to_np(net._states[1])
    w0 = to_np(net._params[1])
    x = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32) + 3
    net.fit([(x, _cls(8, 2, 0))] * 5)
    compare_trees(net._states[1], m0, 0.0, "frozen BN state")
    compare_trees(net._params[1], w0, 0.0, "frozen BN params")


# ---------------------------------------------------------------------------
# zips in both directions
# ---------------------------------------------------------------------------

def test_zips_restore_in_the_other_package(tmp_path):
    jconf = _conf(J, [
        J.DenseLayer.Builder(nIn=3, nOut=4, activation="tanh").build(),
        J.FrozenLayer(layer=J.BatchNormalization.Builder().build()),
        J.CenterLossOutputLayer.Builder(nOut=2, lambdaCoeff=0.1).build()])
    port, jnet = net_pair(jconf, 1)
    port._states[1] = {"mean": torch.tensor([0.1, -0.2, 0.3, 0.4]),
                       "var": torch.tensor([1.5, 0.5, 2.0, 1.0])}
    x = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    port.fit((x, _cls(5, 2, 0)))
    path = str(tmp_path / "port.zip")
    ModelSerializer.writeModel(port, path)
    back = JaxSerializer.restoreMultiLayerNetwork(path)
    compare_trees([back._params, back._states, back._opt_states],
                  [port._params, port._states, port._opt_states], 0.0,
                  "port -> JAX")
    close(np.asarray(back.output(x).numpy()), port.output(x).toNumpy())

    oconf = _ocnn_conf(J, windowSize=100)
    port, jnet = net_pair(oconf, 2)
    xo = np.random.default_rng(1).normal(size=(16, 2)).astype(np.float32)
    jnet.fit([(xo, np.zeros((16, 1), np.float32))] * 3)
    jpath = str(tmp_path / "jax.zip")
    JaxSerializer.writeModel(jnet, jpath)
    got = ModelSerializer.restoreMultiLayerNetwork(jpath, device="cpu")
    assert got._states[1]["seen"].dtype == torch.int32
    assert int(got._states[1]["seen"]) == 3
    compare_trees([got._params, got._states, got._opt_states],
                  [jnet._params, jnet._states, jnet._opt_states], 0.0,
                  "JAX -> port")
    assert got.getIterationCount() == 3


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@cuda
def test_cuda_wrapped_lstm_trains_as_the_cpu():
    """MaskZeroLayer(LSTM) and FrozenLayer(LSTM) on the card (the LSTM
    kernels) against the CPU from the same weights: output, each of 2
    Adam steps from the same state (loss to 1e-4 relative, params to 1e-4
    of each array's largest), the frozen weights bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from deeplearning4j_tpu_torch.kernels import lstm
    from deeplearning4j_tpu_torch.tree_util import tree_leaves

    conf = _conf(P, [
        P.MaskZeroLayer(underlying=P.LSTM.Builder(nOut=16).build()),
        P.FrozenLayer(layer=P.LSTM.Builder(nOut=16).build()),
        P.RnnOutputLayer.Builder().nOut(2).build()],
        P.InputType.recurrent(8, 20))
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    gpu = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json())).init(as_torch(to_np(cpu._params), "cuda"))
    frozen = to_np(gpu._params[1])
    x = _padded_sequences(6, 8, 20, 0)
    close(gpu.output(x).toNumpy(), cpu.output(x).toNumpy(), 1e-4)
    lstm.lstm_seq_fwd.launches = lstm.lstm_seq_bwd.launches = 0
    for step in range(2):
        with torch.no_grad():
            for a, b in zip(tree_leaves([gpu._params, gpu._opt_states]),
                            tree_leaves([cpu._params, cpu._opt_states])):
                b.copy_(a)
        y = np.eye(2, dtype=np.float32)[np.random.default_rng(step)
                                        .integers(0, 2, (6, 20))]
        y = y.transpose(0, 2, 1)
        gpu.fit((x, y))
        cpu.fit((x, y))
        assert abs(gpu.score() - cpu.score()) <= 1e-4 * cpu.score()
        compare_trees(gpu._params, cpu._params, 1e-4, f"step {step}", 1e-7)
    assert lstm.lstm_seq_fwd.launches == 4 and lstm.lstm_seq_bwd.launches \
        == 4
    for k, v in frozen.items():
        np.testing.assert_array_equal(to_np(gpu._params[1][k]), v)
