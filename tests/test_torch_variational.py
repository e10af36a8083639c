"""AutoEncoder, VariationalAutoencoder and pretraining in the port,
against the JAX package.

The noise is matched by value, never by seed: the tests draw the JAX
package's noise with its own calls (``jax.random.bernoulli`` for the
AutoEncoder's corruption, ``jax.random.normal(fold_in(rng, s), ...)``
for the VAE's eps) and hand it to the port's functions that take it; to
run the JAX package on the port's noise (``pretrainLayer``), its
``jax.random`` draw is replaced, inside the test, by one that returns the
port's draws in order.

- AutoEncoder (with corruption, and with sparsity) and VAE (Bernoulli and
  Gaussian reconstruction, 1 and 3 samples, two encoder and decoder
  layers): JSON both ways with the distribution, ``infer``, the
  supervised forward with its param and input gradients, the pretrain
  loss (-ELBO) and its gradients at the same noise, to 1e-5;
  ``reconstruction_log_probability`` (the IWAE bound at 1 and 8
  samples), ``generate_at_mean_given_z`` and ``activate_latent``.
- ``MultiLayerNetwork.pretrainLayer`` and ``pretrain``: 3 steps of each
  pretrainable layer, each from the same state and on the same noise,
  params and Adam moments to 1e-4 of each array's largest element; the
  layers below stay as they were, and a network without a pretrainable
  layer is refused as in the reference.
- The reference's own cases: the activation fallbacks and a global
  default, the Bernoulli distribution with an identity activation, a
  one-shot generator feeding every pretrainable layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nn as J
from deeplearning4j_tpu.nn.conf import variational as jvar
from deeplearning4j_tpu.optimize import updaters as JU
from deeplearning4j_tpu_torch import nn as P
from deeplearning4j_tpu_torch.nn.conf import variational as pvar
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork, _dropout_generator)
from deeplearning4j_tpu_torch.optimize import updaters as PU
from torch_parity import (
    FN_RTOL, TRAIN_RTOL, as_jax, as_torch, check_layer, close,
    compare_trees, leaves, net_pair, sync, to_np)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _data(n=16, d=12, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, d)) > 0.5).astype(np.float32)
    y = np.zeros((n, 2), np.float32)
    y[np.arange(n), (x.sum(1) > d / 2).astype(int)] = 1.0
    return x, y


def _conf(m, layers, seed=12345):
    b = (m.NeuralNetConfiguration.Builder().seed(seed)
         .updater((JU if m is J else PU).Adam(1e-2)).list())
    for lr in layers:
        b = b.layer(lr)
    return b.build()


LAYERS = {
    "ae": lambda m: m.AutoEncoder.Builder(nIn=12, nOut=6,
                                          corruptionLevel=0.3).build(),
    "ae_sparse_tanh": lambda m: m.AutoEncoder.Builder(
        nIn=12, nOut=5, corruptionLevel=0.2, sparsity=0.05,
        activation="sigmoid", lossFunction="mse").build(),
    "vae_bernoulli": lambda m: m.VariationalAutoencoder.Builder(
        nIn=12, nOut=3, encoderLayerSizes=(10,),
        decoderLayerSizes=(9,)).build(),
    "vae_gaussian_3": lambda m: m.VariationalAutoencoder.Builder(
        nIn=12, nOut=2, encoderLayerSizes=(8, 6), decoderLayerSizes=(6, 8),
        numSamples=3, activation="tanh",
        reconstructionDistribution=m.GaussianReconstructionDistribution(
            "tanh")).build(),
}


def _pair(name):
    jconf = _conf(J, [LAYERS[name](J), J.OutputLayer.Builder().nOut(2)
                      .build()])
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert conf.to_json() == jconf.to_json()
    assert _conf(P, [LAYERS[name](P), P.OutputLayer.Builder().nOut(2)
                     .build()]).to_json() == jconf.to_json()
    jl, pl = jconf.layers[0], conf.layers[0]
    params = to_np(pl.init_params(torch.Generator().manual_seed(3)))
    want = jax.eval_shape(lambda k: jl.init_params(k), jax.random.key(0))
    assert sorted(params) == sorted(want)
    assert {k: v.shape for k, v in params.items()} == {
        k: v.shape for k, v in want.items()}
    return jl, pl, params


def _jax_noise(jl, x, key):
    """The JAX package's own draws for ``pretrain_loss(params, x, key)``:
    (the port's keyword, the value)."""
    if isinstance(jl, jvar.AutoEncoder):
        return "keep", np.asarray(jax.random.bernoulli(
            key, 1.0 - jl.corruptionLevel, x.shape))
    return "eps", np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, s), (x.shape[0], jl.nOut), jnp.float32))
        for s in range(jl.numSamples)])


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_forward_and_pretrain_loss_match(name):
    jl, pl, params = _pair(name)
    x, _ = _data(6, 12, 1)
    if "gaussian" in name:
        x = np.random.default_rng(2).normal(size=(6, 12)).astype(np.float32)
    check_layer(jl, pl, params, x)
    key = jax.random.key(7)
    kw, noise = _jax_noise(jl, x, key)
    want, jg = jax.value_and_grad(
        lambda p: jl.pretrain_loss(p, jnp.asarray(x), key))(as_jax(params))
    tp = {k: v.requires_grad_() for k, v in as_torch(params).items()}
    got = pl.pretrain_loss(tp, torch.tensor(x), **{kw: torch.tensor(noise)})
    flat = [v for _, v in leaves(tp)]
    tg = torch.autograd.grad(got, flat)
    close(float(got.detach()), float(want), FN_RTOL, "pretrain loss")
    for (k, g) in zip([k for k, _ in leaves(tp)], tg):
        close(to_np(g), np.asarray(jg[k]), FN_RTOL, f"d{k}")


@pytest.mark.parametrize("name", ["vae_bernoulli", "vae_gaussian_3"])
def test_vae_inference_apis_match(name):
    jl, pl, params = _pair(name)
    x, _ = _data(5, 12, 3)
    tp, jp = as_torch(params), as_jax(params)
    for s in (1, 8):
        key = jax.random.key(11 + s)
        eps = np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(key, i), (5, jl.nOut), jnp.float32))
            for i in range(s)])
        got = pl.reconstruction_log_probability(tp, torch.tensor(x),
                                                eps=torch.tensor(eps))
        want = jl.reconstruction_log_probability(jp, x, key, num_samples=s)
        close(to_np(got), np.asarray(want), FN_RTOL, f"log p(x), S={s}")
        assert got.shape == (5,) and bool(torch.isfinite(got).all())
    z = np.random.default_rng(0).normal(size=(4, jl.nOut)).astype(
        np.float32)
    close(to_np(pl.generate_at_mean_given_z(tp, torch.tensor(z))),
          np.asarray(jl.generate_at_mean_given_z(jp, z)))
    for a, b in zip(pl.activate_latent(tp, torch.tensor(x)),
                    jl.activate_latent(jp, x)):
        close(to_np(a), np.asarray(b))
    # a generator draws eps of the right shape; None draws from seed 0
    lp = pl.reconstruction_log_probability(
        tp, torch.tensor(x), torch.Generator().manual_seed(1), 4)
    assert lp.shape == (5,)
    assert pl.draw_eps(torch.tensor(x), None, 2).shape == (2, 5, jl.nOut)


def test_distributions_json_and_bernoulli_identity():
    for m, mod in ((J, jvar), (P, pvar)):
        dist = mod.BernoulliReconstructionDistribution(activation="identity")
        lp = float(dist.log_prob(
            (jnp if m is J else torch).asarray([[1.0, 0.0]]) if m is J
            else torch.tensor([[1.0, 0.0]]),
            jnp.asarray([[0.9, 0.2]]) if m is J
            else torch.tensor([[0.9, 0.2]]))[0])
        assert lp == pytest.approx(np.log(0.9) + np.log(0.8), abs=1e-5)
    g = pvar.GaussianReconstructionDistribution("tanh")
    assert g.to_json() == jvar.GaussianReconstructionDistribution(
        "tanh").to_json()
    assert isinstance(pvar.ReconstructionDistribution.from_json(
        g.to_json()), pvar.GaussianReconstructionDistribution)
    with pytest.raises(ValueError, match="unknown reconstruction"):
        pvar._resolve_distribution("poisson")


@pytest.fixture
def port_noise(monkeypatch):
    """A function that replaces the JAX package's ``jax.random.bernoulli``
    and ``jax.random.normal`` by draws taken in order from a queue (for
    the rest of the test), and returns the queue, which the test fills
    with the port's noise."""
    queue = []

    def take(*args, **kw):
        if not queue:
            raise AssertionError("the JAX package drew more noise than "
                                 "the port")
        return jnp.asarray(queue.pop(0))

    def patch():
        monkeypatch.setattr(jvar.jax.random, "normal", take)
        monkeypatch.setattr(jvar.jax.random, "bernoulli", take)
        return queue

    return patch


def _port_step_noise(port, layer_idx, h):
    """The noise the port's pretrainLayer draws at its next step."""
    lr = port.layers[layer_idx]
    gen = _dropout_generator(port.conf.seed, port._iteration, "cpu",
                             offset=2 + layer_idx)
    h = torch.tensor(h)
    if isinstance(lr, pvar.AutoEncoder):
        return [to_np(lr.corruption_mask(h, gen))]
    return list(to_np(lr.draw_eps(h, gen, lr.numSamples)))


def test_pretrain_layers_train_as_the_reference(port_noise):
    jconf = _conf(J, [
        J.AutoEncoder.Builder(nIn=12, nOut=8, corruptionLevel=0.2).build(),
        J.VariationalAutoencoder.Builder(
            nOut=3, encoderLayerSizes=(6,), decoderLayerSizes=(6,),
            reconstructionDistribution="gaussian", numSamples=2).build(),
        J.OutputLayer.Builder().nOut(2).build()])
    port, jnet = net_pair(jconf, 5)
    port_noise = port_noise()
    out_before = to_np(port._params[2])
    for layer_idx in (0, 1):
        for step in range(3):
            x, _ = _data(8, 12, 10 * layer_idx + step)
            with torch.no_grad():
                h = port._forward(port._params, port._states,
                                  torch.tensor(x), upto=layer_idx)[0]
            sync(port, jnet)
            jnet._iteration = port._iteration
            jnet._infer_fns.clear()          # retrace on this step's noise
            port_noise[:] = _port_step_noise(port, layer_idx, to_np(h))
            port.pretrainLayer(layer_idx, (x, None))
            jnet.pretrainLayer(layer_idx, (x, None))
            assert not port_noise
            close(port.score(), jnet.score(), FN_RTOL, "pretrain loss")
            compare_trees([port._params, port._opt_states],
                          [jnet._params, jnet._opt_states], TRAIN_RTOL,
                          f"layer {layer_idx} step {step}",
                          TRAIN_RTOL * 1e-4)
    compare_trees(port._params[2], out_before, 0.0, "the output layer")
    assert port.getIterationCount() == 6


def test_pretrain_feeds_every_layer_from_a_generator():
    x, _ = _data(16)
    conf = _conf(P, [P.AutoEncoder.Builder(nIn=12, nOut=8).build(),
                     P.AutoEncoder.Builder(nIn=8, nOut=4).build(),
                     P.OutputLayer.Builder(nIn=4, nOut=2).build()])
    net = MultiLayerNetwork(conf, device="cpu").init()
    before = to_np(net._params)
    net.pretrain(((x, None) for _ in range(3)))
    assert net.getIterationCount() == 6
    for i in (0, 1):
        assert not np.allclose(to_np(net._params[i]["W"]), before[i]["W"])
    compare_trees(net._params[2], before[2], 0.0, "output layer")
    assert net.output(x).shape() == (16, 2)


def test_pretrain_rejects_non_pretrainable():
    conf = _conf(P, [P.DenseLayer.Builder(nIn=12, nOut=6).build(),
                     P.OutputLayer.Builder(nIn=6, nOut=2).build()])
    net = MultiLayerNetwork(conf, device="cpu").init()
    with pytest.raises(ValueError, match="no unsupervised pretrain loss"):
        net.pretrainLayer(0, (np.zeros((2, 12), np.float32), None))


def test_supervised_fit_through_a_vae_matches():
    jconf = _conf(J, [LAYERS["vae_bernoulli"](J),
                      J.OutputLayer.Builder().nOut(2).build()])
    port, jnet = net_pair(jconf, 8)
    x, y = _data(8, 12, 4)
    close(port.output(x).toNumpy(), np.asarray(jnet.output(x).numpy()))
    for step in range(2):
        sync(port, jnet)
        port.fit((x, y))
        jnet.fit((x, y))
        assert abs(port.score() - jnet.score()) <= FN_RTOL * abs(
            jnet.score())
        compare_trees(port._params, jnet._params, TRAIN_RTOL,
                      f"step {step}", TRAIN_RTOL * 1e-4)


def test_activation_defaults_propagate():
    for m in (J, P):
        conf = (m.NeuralNetConfiguration.Builder().activation("tanh").list()
                .layer(m.AutoEncoder.Builder(nIn=6, nOut=4).build())
                .layer(m.VariationalAutoencoder.Builder(
                    nIn=4, nOut=2, encoderLayerSizes=(5,),
                    decoderLayerSizes=(5,)).build())
                .layer(m.OutputLayer.Builder(nIn=2, nOut=2).build())
                .build())
        assert [lr.activation for lr in conf.layers[:2]] == ["tanh"] * 2
        conf2 = _conf(m, [m.AutoEncoder.Builder(nIn=6, nOut=4).build(),
                          m.VariationalAutoencoder.Builder(
                              nIn=4, nOut=2).build(),
                          m.OutputLayer.Builder(nIn=2, nOut=2).build()])
        assert [lr.activation for lr in conf2.layers[:2]] == [
            "sigmoid", "leakyrelu"]
