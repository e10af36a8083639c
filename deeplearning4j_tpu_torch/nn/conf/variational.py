"""Unsupervised pretrain layers: AutoEncoder and VariationalAutoencoder.

Counterpart of ``deeplearning4j_tpu/nn/conf/variational.py``, with the
reconstruction distributions (Gaussian, Bernoulli), the same config
fields, JSON and param names. In supervised forward and backprop both
layers are feed-forward encoders (the AutoEncoder encodes, the VAE gives
the mean of q(z|x)); ``MultiLayerNetwork.pretrain`` and ``pretrainLayer``
minimize their ``pretrain_loss``.

The noise is drawn from a ``torch.Generator`` and handed to functions
that take it: the AutoEncoder's corruption ``keep`` mask, the VAE's
``eps`` [S, N, nOut] of standard normals (the reparameterization z =
mean + exp(log_var / 2) * eps). The JAX package draws eps with
``jax.random.normal(fold_in(rng, s), ...)``; passed the same eps, both
packages compute the same ELBO, log-probabilities and gradients.
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.nn.activations import resolve_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import BaseLayer, _register
from deeplearning4j_tpu_torch.nn.losses import resolve_loss
from deeplearning4j_tpu_torch.nn.weights import init_weight


# ---------------------------------------------------------------------------
# reconstruction distributions
# ---------------------------------------------------------------------------

class ReconstructionDistribution:
    """p(x|z) from the decoder's pre-activations.
    ``distribution_input_size(nIn)``: the decoder outputs it needs."""

    name = "base"

    def distribution_input_size(self, n_in: int) -> int:
        raise NotImplementedError

    def log_prob(self, x, pre):
        """log p(x|z) summed over the data dims, [N]."""
        raise NotImplementedError

    def sample_mean(self, pre):
        """E[x|z] (for generateAtMeanGivenZ)."""
        raise NotImplementedError

    def to_json(self):
        return {"@dist": type(self).__name__, **{
            k: v for k, v in self.__dict__.items() if not k.startswith("_")}}

    @staticmethod
    def from_json(d):
        d = dict(d)
        cls = _DISTRIBUTIONS[d.pop("@dist")]
        return cls(**d)


class GaussianReconstructionDistribution(ReconstructionDistribution):
    """The decoder gives [mean, log(sigma^2)] a data dim; the activation
    applies to the mean half only."""

    name = "gaussian"

    def __init__(self, activation="identity"):
        self.activation = activation

    def distribution_input_size(self, n_in):
        return 2 * n_in

    def _split(self, pre):
        n = pre.shape[-1] // 2
        return resolve_activation(self.activation)(pre[..., :n]), \
            pre[..., n:]

    def log_prob(self, x, pre):
        mean, log_var = self._split(pre)
        log_var = torch.clamp(log_var, -10.0, 10.0)
        lp = -0.5 * (math.log(2.0 * math.pi) + log_var
                     + torch.square(x - mean) / torch.exp(log_var))
        return torch.sum(lp, dim=-1)

    def sample_mean(self, pre):
        return self._split(pre)[0]


class BernoulliReconstructionDistribution(ReconstructionDistribution):
    """One logit a data dim; the sigmoid gives p(x = 1)."""

    name = "bernoulli"

    def __init__(self, activation="sigmoid"):
        self.activation = activation

    def distribution_input_size(self, n_in):
        return n_in

    def log_prob(self, x, pre):
        if self.activation == "sigmoid":
            # the stable sigmoid cross-entropy on the logits
            lp = -(torch.clamp(pre, min=0.0) - pre * x
                   + torch.log1p(torch.exp(-torch.abs(pre))))
            return torch.sum(lp, dim=-1)
        p = torch.clamp(resolve_activation(self.activation)(pre), 1e-7,
                        1.0 - 1e-7)
        return torch.sum(x * torch.log(p) + (1.0 - x) * torch.log1p(-p),
                         dim=-1)

    def sample_mean(self, pre):
        return resolve_activation(self.activation)(pre)


_DISTRIBUTIONS = {c.__name__: c for c in (
    GaussianReconstructionDistribution, BernoulliReconstructionDistribution)}


def _resolve_distribution(d):
    if isinstance(d, ReconstructionDistribution):
        return d
    if isinstance(d, dict):
        return ReconstructionDistribution.from_json(d)
    key = str(d).lower()
    if key == "bernoulli":
        return BernoulliReconstructionDistribution()
    if key == "gaussian":
        return GaussianReconstructionDistribution()
    raise ValueError(f"unknown reconstruction distribution {d!r}")


def _sizes(v):
    return tuple(int(s) for s in (v if isinstance(v, (list, tuple))
                                  else (v,)))


# ---------------------------------------------------------------------------
# AutoEncoder
# ---------------------------------------------------------------------------

@_register
class AutoEncoder(BaseLayer):
    """Denoising autoencoder. Forward = encode, act(x W + b). Pretrain
    loss: the input corrupted by masking noise (``corruptionLevel``),
    encoded, decoded through the tied W^T and the visible bias ``vb``,
    the reconstruction scored against the clean input, plus a KL sparsity
    penalty when ``sparsity`` is set."""

    HAS_PRETRAIN_LOSS = True

    def __init__(self, nIn=None, nOut=None, corruptionLevel=0.3,
                 sparsity=0.0, lossFunction="mse", **kw):
        super().__init__(**kw)
        self.nIn = nIn
        self.nOut = nOut
        self.corruptionLevel = corruptionLevel
        self.sparsity = sparsity
        self.lossFunction = lossFunction

    def apply_defaults(self, defaults):
        # "sigmoid" only when no global activation default is set
        if self.activation is None and defaults.get("activation") is None:
            self.activation = "sigmoid"
        super().apply_defaults(defaults)

    def infer(self, input_type):
        self.nIn = self.nIn or input_type.arrayElementsPerExample()
        return InputType.feedForward(self.nOut)

    def param_shapes(self):
        return {"W": (self.nIn, self.nOut), "b": (self.nOut,),
                "vb": (self.nIn,)}

    def init_params(self, generator, dtype=torch.float32, device="cpu"):
        return {
            "W": init_weight(self.weightInit, generator,
                             (self.nIn, self.nOut), self.nIn, self.nOut,
                             dtype, device),
            "b": torch.full((self.nOut,), float(self.biasInit or 0.0),
                            dtype=dtype, device=device),
            "vb": torch.zeros((self.nIn,), dtype=dtype, device=device),
        }

    def apply(self, params, state, x, training=False, generator=None):
        return self._dropout(self._encode(params, x), training,
                             generator), state

    def _encode(self, params, x):
        return self._act(x @ params["W"] + params["b"])

    def _decode(self, params, h):
        return self._act(h @ params["W"].T + params["vb"])

    def corruption_mask(self, x, generator):
        """The masking noise's keep mask (1 keeps an input), or None when
        there is no corruption or no generator."""
        if not self.corruptionLevel or generator is None:
            return None
        return torch.rand(x.shape, generator=generator, device=x.device,
                          dtype=x.dtype) < 1.0 - self.corruptionLevel

    def pretrain_loss(self, params, x, generator=None, keep=None):
        """The denoising pass's mean reconstruction loss; ``keep`` (a
        boolean mask of x's shape) is drawn from ``generator`` unless
        given."""
        if keep is None:
            keep = self.corruption_mask(x, generator)
        xc = x if keep is None else torch.where(keep, x,
                                                torch.zeros_like(x))
        recon = self._decode(params, self._encode(params, xc))
        # the decode applied the activation: score with the identity head
        loss = resolve_loss(self.lossFunction)(x, recon, "identity", None)
        if self.sparsity:
            rho = self.sparsity
            h_mean = torch.clamp(torch.mean(self._encode(params, x), dim=0),
                                 1e-6, 1.0 - 1e-6)
            loss = loss + torch.sum(rho * torch.log(rho / h_mean)
                                    + (1 - rho) * torch.log(
                                        (1 - rho) / (1 - h_mean)))
        return loss


# ---------------------------------------------------------------------------
# VariationalAutoencoder
# ---------------------------------------------------------------------------

@_register
class VariationalAutoencoder(BaseLayer):
    """VAE layer: nOut is the latent size, encoderLayerSizes and
    decoderLayerSizes the hidden MLP widths. Forward gives the mean of
    q(z|x). Pretrain loss = -ELBO = KL(q(z|x) || N(0, I)) - (1/S) sum_s
    log p(x | z_s)."""

    HAS_PRETRAIN_LOSS = True

    def __init__(self, nIn=None, nOut=None, encoderLayerSizes=(256,),
                 decoderLayerSizes=(256,), pzxActivationFunction="identity",
                 reconstructionDistribution="bernoulli", numSamples=1, **kw):
        super().__init__(**kw)
        self.nIn = nIn
        self.nOut = nOut
        self.encoderLayerSizes = _sizes(encoderLayerSizes)
        self.decoderLayerSizes = _sizes(decoderLayerSizes)
        self.pzxActivationFunction = pzxActivationFunction
        self.reconstructionDistribution = _resolve_distribution(
            reconstructionDistribution)
        self.numSamples = int(numSamples)

    def apply_defaults(self, defaults):
        if self.activation is None and defaults.get("activation") is None:
            self.activation = "leakyrelu"
        super().apply_defaults(defaults)

    def infer(self, input_type):
        self.nIn = self.nIn or input_type.arrayElementsPerExample()
        return InputType.feedForward(self.nOut)

    def param_shapes(self):
        shapes = {}

        def dense(prefix, widths):
            for i, (a, b) in enumerate(zip(widths, widths[1:])):
                shapes[f"{prefix}W{i}"] = (a, b)
                shapes[f"{prefix}b{i}"] = (b,)
            return widths[-1]

        e_last = dense("e", (self.nIn,) + self.encoderLayerSizes)
        shapes["meanW"] = (e_last, self.nOut)
        shapes["meanB"] = (self.nOut,)
        shapes["logVarW"] = (e_last, self.nOut)
        shapes["logVarB"] = (self.nOut,)
        d_last = dense("d", (self.nOut,) + self.decoderLayerSizes)
        out = self.reconstructionDistribution.distribution_input_size(
            self.nIn)
        shapes["xW"] = (d_last, out)
        shapes["xB"] = (out,)
        return shapes

    def init_params(self, generator, dtype=torch.float32, device="cpu"):
        """Weights ("...W...") by the weight init, biases zero."""
        return {k: (init_weight(self.weightInit, generator, s, s[0], s[1],
                                dtype, device) if len(s) == 2 else
                    torch.zeros(s, dtype=dtype, device=device))
                for k, s in self.param_shapes().items()}

    def _mlp(self, params, prefix, n, x):
        act = resolve_activation(self.activation)
        for i in range(n):
            x = act(x @ params[f"{prefix}W{i}"] + params[f"{prefix}b{i}"])
        return x

    def _posterior(self, params, x):
        h = self._mlp(params, "e", len(self.encoderLayerSizes), x)
        mean = resolve_activation(self.pzxActivationFunction)(
            h @ params["meanW"] + params["meanB"])
        log_var = torch.clamp(h @ params["logVarW"] + params["logVarB"],
                              -10.0, 10.0)
        return mean, log_var

    def _decode_pre(self, params, z):
        h = self._mlp(params, "d", len(self.decoderLayerSizes), z)
        return h @ params["xW"] + params["xB"]

    def apply(self, params, state, x, training=False, generator=None):
        mean, _ = self._posterior(params, x)
        return self._dropout(mean, training, generator), state

    def draw_eps(self, x, generator, n_samples):
        """[n_samples, N, nOut] standard normals from ``generator`` (one
        seeded 0 on x's device when None)."""
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        return torch.randn((n_samples, x.shape[0], self.nOut),
                           generator=generator, device=x.device,
                           dtype=x.dtype)

    def _sample_log_probs(self, params, x, eps):
        """For each eps_s: z_s = mean + exp(log_var / 2) eps_s. Returns
        (kl [N], log p(x|z_s) [S, N], log p(z_s) - log q(z_s|x) [S, N])."""
        mean, log_var = self._posterior(params, x)
        kl = 0.5 * torch.sum(torch.exp(log_var) + torch.square(mean) - 1.0
                             - log_var, dim=-1)
        log_2pi = math.log(2 * math.pi)
        recon, weight = [], []
        for e in eps:
            z = mean + torch.exp(0.5 * log_var) * e
            recon.append(self.reconstructionDistribution.log_prob(
                x, self._decode_pre(params, z)))
            log_p_z = -0.5 * torch.sum(torch.square(z) + log_2pi, dim=-1)
            log_q_z = -0.5 * torch.sum(torch.square(e) + log_2pi + log_var,
                                       dim=-1)
            weight.append(log_p_z - log_q_z)
        return kl, torch.stack(recon), torch.stack(weight)

    def pretrain_loss(self, params, x, generator=None, eps=None):
        """-ELBO averaged over the batch; ``eps`` [numSamples, N, nOut] is
        drawn from ``generator`` unless given."""
        if eps is None:
            eps = self.draw_eps(x, generator, self.numSamples)
        kl, recon, _ = self._sample_log_probs(params, x, eps)
        return torch.mean(kl - torch.mean(recon, dim=0))

    def reconstruction_log_probability(self, params, x, generator=None,
                                       num_samples=None, eps=None):
        """Each example's importance-sampled estimate of log p(x) (the
        IWAE bound): logsumexp_s[log p(x|z_s) + log p(z_s) - log
        q(z_s|x)] - log S."""
        x = torch.as_tensor(x)
        if eps is None:
            eps = self.draw_eps(x, generator,
                                num_samples or self.numSamples)
        _, recon, weight = self._sample_log_probs(params, x, eps)
        return torch.logsumexp(recon + weight, dim=0) - math.log(
            float(len(eps)))

    def generate_at_mean_given_z(self, params, z):
        """E[x|z]."""
        return self.reconstructionDistribution.sample_mean(
            self._decode_pre(params, torch.as_tensor(z)))

    def activate_latent(self, params, x):
        """The mean and log-variance of q(z|x)."""
        return self._posterior(params, torch.as_tensor(x))
