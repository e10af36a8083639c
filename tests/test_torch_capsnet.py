"""The CapsNet layers in the port, against the JAX package.

- PrimaryCapsules, CapsuleLayer (routings 1, 2 and 3) and
  CapsuleStrengthLayer: JSON both ways, ``infer``, output and param and
  input gradients to 1e-5 of each array's largest element, on
  transferred weights; ``_squash`` against the reference's.
- The reference's capsule net (conv, PrimaryCapsules, CapsuleLayer with
  3 routings, CapsuleStrengthLayer, softmax, mcxent) with the port's
  weights in both packages: every layer's activation and the gradients
  to 1e-5, 2 Adam steps from the same state (losses to 1e-5 relative,
  params and moments to 1e-4); squashed capsule lengths stay below 1.
- The reference's config edges: flat input reshaped before
  PrimaryCapsules, feed-forward input refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nn as J
from deeplearning4j_tpu.nn.conf import capsnet as jax_capsnet
from deeplearning4j_tpu.optimize import updaters as JU
from deeplearning4j_tpu_torch import nn as P
from deeplearning4j_tpu_torch.nn.conf import capsnet
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import updaters as PU
from torch_parity import (
    FN_RTOL, TRAIN_RTOL, check_layer, close, compare_trees, net_pair, sync,
    to_np)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _capsnet(m, routings=3, seed=3):
    U = JU if m is J else PU
    return (m.NeuralNetConfiguration.Builder().seed(seed)
            .updater(U.Adam(1e-3)).list()
            .layer(m.ConvolutionLayer.Builder().nOut(8).kernelSize([3, 3])
                   .activation("relu").build())
            .layer(m.PrimaryCapsules.Builder(capsuleDimensions=4,
                                             channels=2, kernelSize=[3, 3],
                                             stride=[2, 2]).build())
            .layer(m.CapsuleLayer.Builder(capsules=3, capsuleDimensions=6,
                                          routings=routings).build())
            .layer(m.CapsuleStrengthLayer.Builder().build())
            .layer(m.ActivationLayer.Builder().activation("softmax")
                   .build())
            .layer(m.LossLayer(lossFunction="mcxent", activation="identity"))
            .setInputType(m.InputType.convolutional(12, 12, 1))
            .build())


def _x(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 1, 12, 12)).astype(
        np.float32)


def test_squash_matches_the_reference():
    s = np.random.default_rng(0).normal(size=(3, 5, 4)).astype(np.float32)
    s[0, 0] = 0.0
    for axis in (-1, 1):
        close(to_np(capsnet._squash(torch.tensor(s), axis)),
              np.asarray(jax_capsnet._squash(jnp.asarray(s), axis)))


@pytest.mark.parametrize("index,routings", [(1, 3), (2, 1), (2, 2), (2, 3),
                                            (3, 3)],
                         ids=["primary", "caps_r1", "caps_r2", "caps_r3",
                              "strength"])
def test_layer_matches_the_reference(index, routings):
    jconf = _capsnet(J, routings)
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert conf.to_json() == jconf.to_json()
    assert _capsnet(P, routings).to_json() == jconf.to_json()
    jl, pl = jconf.layers[index], conf.layers[index]
    assert pl.to_json() == jl.to_json()
    assert pl.infer(conf.layer_input_types[index]).to_json() == \
        jl.infer(jconf.layer_input_types[index]).to_json()
    params = to_np(pl.init_params(torch.Generator().manual_seed(index)))
    want = jax.eval_shape(lambda k: jl.init_params(k), jax.random.key(0))
    assert {k: v.shape for k, v in params.items()} == {
        k: v.shape for k, v in want.items()}
    shape = {1: (2, 8, 10, 10), 2: (2, 32, 4), 3: (2, 3, 6)}[index]
    x = np.random.default_rng(index).normal(size=shape).astype(np.float32)
    if index == 2:
        x = x * 0.3
    check_layer(jl, pl, params, x)


def test_capsnet_trains_as_the_reference():
    port, jnet = net_pair(_capsnet(J), 3)
    x = _x(4, 0)
    y = np.eye(3, dtype=np.float32)[[0, 1, 2, 1]]
    for got, want in zip(port.feedForward(x), jnet.feedForward(x)):
        close(got.toNumpy(), np.asarray(want.numpy()))
    acts = port.feedForward(x)
    assert acts[2].shape() == (4, 32, 4) and acts[3].shape() == (4, 3, 6)
    assert np.all(np.linalg.norm(acts[3].toNumpy(), axis=-1) < 1.0)
    compare_trees(port.gradients(x, y), jnet.gradients(x, y), FN_RTOL,
                  "gradients")
    for step in range(2):
        sync(port, jnet)
        port.fit((x, y))
        jnet.fit((x, y))
        assert abs(port.score() - jnet.score()) <= FN_RTOL * abs(
            jnet.score())
        compare_trees([port._params, port._opt_states],
                      [jnet._params, jnet._opt_states], TRAIN_RTOL,
                      f"step {step}", TRAIN_RTOL * 1e-4)


def test_flat_input_gets_reshape_preprocessor():
    conf = (P.NeuralNetConfiguration.Builder().seed(1).list()
            .layer(P.PrimaryCapsules.Builder(capsuleDimensions=3,
                                             channels=2, kernelSize=[3, 3],
                                             stride=[2, 2]).build())
            .layer(P.CapsuleStrengthLayer.Builder().build())
            .layer(P.LossLayer(lossFunction="mse", activation="identity"))
            .setInputType(P.InputType.convolutionalFlat(8, 8, 1)).build())
    assert conf.preprocessors[0] == ("ff_to_cnn", (1, 8, 8))
    net = MultiLayerNetwork(conf, device="cpu").init()
    x = np.random.default_rng(0).normal(size=(2, 64)).astype(np.float32)
    assert net.output(x).shape() == (2, 18)


@pytest.mark.parametrize("m", [J, P], ids=["jax", "torch"])
def test_feedforward_input_rejected_clearly(m):
    with pytest.raises(ValueError, match="convolutional input"):
        (m.NeuralNetConfiguration.Builder().list()
         .layer(m.PrimaryCapsules.Builder(capsuleDimensions=3,
                                          channels=2).build())
         .layer(m.LossLayer(lossFunction="mse"))
         .setInputType(m.InputType.feedForward(10))
         .build())


def test_capsule_layer_needs_its_input_dimensions():
    with pytest.raises(ValueError, match="inputCapsuleDimensions"):
        capsnet.CapsuleLayer().infer(P.InputType.recurrent(8))
