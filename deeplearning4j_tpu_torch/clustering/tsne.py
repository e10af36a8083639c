"""t-SNE embedding with exact gradients, on the device.

Counterpart of ``deeplearning4j_tpu/clustering/tsne.py``: the same
perplexity calibration (40 bisection steps over every row at once), the
same symmetrised P, and the same gradient descent with early
exaggeration (x12 until ``stopLyingIteration``), gains and momentum, as
a loop of PyTorch ops on the device with no host read an iteration (the
reference's ``lax.scan``). The start ``y0`` is ``1e-4`` times a normal
draw from a ``torch.Generator`` seeded with ``seed``; ``_optimize(p, y0)``
takes it as an input, so a test can hand it the reference's draw. The
BarnesHutTsne builder surface is kept; ``theta`` is accepted for config
parity (the gradients are exact).

Reference capability: org.deeplearning4j.plot.BarnesHutTsne
(deeplearning4j-manifold; SURVEY.md §2.7 domain libs)."""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend import resolve_device


def _pairwise_sq_dists(x):
    s = torch.sum(torch.square(x), dim=1)
    d = s[:, None] + s[None, :] - 2.0 * (x @ x.T)
    return torch.clamp(d, min=0.0)


def _binary_search_betas(d, perplexity, iters=40):
    """Per-point precision (beta = 1/2sigma^2) matching the target
    perplexity: ``iters`` bisection steps over all rows at once; returns
    the row-normalised conditional P."""
    n = d.shape[0]
    log_u = torch.log(torch.tensor(perplexity, dtype=d.dtype,
                                   device=d.device))
    eye = torch.eye(n, dtype=torch.bool, device=d.device)

    def entropy(beta):
        p = torch.where(eye, 0.0, torch.exp(-d * beta[:, None]))
        sum_p = torch.clamp(torch.sum(p, dim=1), min=1e-12)
        h = torch.log(sum_p) + beta * torch.sum(d * p, dim=1) / sum_p
        return h, p / sum_p[:, None]

    beta = torch.ones(n, dtype=d.dtype, device=d.device)
    lo = torch.zeros_like(beta)
    hi = torch.full_like(beta, float("inf"))
    for _ in range(iters):
        h, _ = entropy(beta)
        too_high = h > log_u          # entropy too high -> raise beta
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(
            too_high,
            torch.where(torch.isinf(hi), beta * 2.0, (beta + hi) / 2.0),
            (lo + beta) / 2.0)
    return entropy(beta)[1]


class BarnesHutTsne:
    """Builder-compatible t-SNE (exact gradients, the loop on the
    device)."""

    class Builder:
        # setter name -> constructor kwarg; typos fail loudly
        _KEYS = {k: k for k in (
            "numDimension", "perplexity", "theta", "learningRate",
            "momentum", "finalMomentum", "maxIter", "stopLyingIteration",
            "switchMomentumIteration", "seed", "usePca")}
        _KEYS["setMaxIter"] = "maxIter"

        def __init__(self):
            self._kw = {}

        def __getattr__(self, item):
            if item.startswith("_"):
                raise AttributeError(item)
            if item not in self._KEYS:
                raise AttributeError(
                    f"unknown BarnesHutTsne setting {item!r} "
                    f"(known: {sorted(self._KEYS)})")

            def setter(v):
                self._kw[self._KEYS[item]] = v
                return self

            return setter

        def build(self, device=None):
            return BarnesHutTsne(**self._kw, device=device)

    def __init__(self, numDimension=2, perplexity=30.0, theta=0.5,
                 learningRate=200.0, momentum=0.5, finalMomentum=0.8,
                 maxIter=1000, stopLyingIteration=100,
                 switchMomentumIteration=250, seed=42, usePca=False,
                 device=None):
        self.device = resolve_device(device)
        self.numDimension = int(numDimension)
        self.perplexity = float(perplexity)
        self.theta = theta                  # parity knob (exact gradients)
        self.learningRate = float(learningRate)
        self.momentum = float(momentum)
        self.finalMomentum = float(finalMomentum)
        self.maxIter = int(maxIter)
        self.stopLyingIteration = int(stopLyingIteration)
        self.switchMomentumIteration = int(switchMomentumIteration)
        self.seed = int(seed)
        self.usePca = usePca
        self._embedding = None

    def _affinities(self, x):
        """The symmetrised joint P of the points ``x`` (numpy [N, F]) on
        the device, after the optional PCA to 50 dimensions."""
        n = x.shape[0]
        if self.usePca and x.shape[1] > 50:
            xc = x - x.mean(0)
            _, _, vt = np.linalg.svd(xc, full_matrices=False)
            x = xc @ vt[:50].T
        perp = min(self.perplexity, (n - 1) / 3.0)
        d = _pairwise_sq_dists(torch.from_numpy(
            np.ascontiguousarray(x, np.float32)).to(self.device))
        p_cond = _binary_search_betas(d, perp)
        p = (p_cond + p_cond.T) / (2.0 * n)
        return torch.clamp(p, min=1e-12)

    def _optimize(self, p, y0, iters=None):
        """Gradient descent from ``y0`` over ``iters`` (default maxIter)
        iterations; the embedding tensor."""
        n = p.shape[0]
        eye = torch.eye(n, dtype=torch.bool, device=p.device)
        lying, lr = 12.0, self.learningRate
        p_lying = p * lying
        y = y0
        vel = torch.zeros_like(y0)
        gains = torch.ones_like(y0)
        for it in range(self.maxIter if iters is None else iters):
            p_eff = p_lying if it < self.stopLyingIteration else p
            dy = _pairwise_sq_dists(y)
            num = torch.where(eye, 0.0, 1.0 / (1.0 + dy))   # student-t
            q = torch.clamp(num / torch.sum(num), min=1e-12)
            w = (p_eff - q) * num                            # [N, N]
            # grad_i = 4 * sum_j w_ij (y_i - y_j)
            g = 4.0 * (torch.sum(w, dim=1, keepdim=True) * y - w @ y)
            # DL4J/van-der-Maaten gain adaptation
            gains = torch.where(torch.sign(g) != torch.sign(vel),
                                gains + 0.2, gains * 0.8)
            gains = torch.clamp(gains, min=0.01)
            mom = (self.momentum if it < self.switchMomentumIteration
                   else self.finalMomentum)
            vel = mom * vel - lr * gains * g
            y = y + vel
            y = y - torch.mean(y, dim=0)
        return y

    def fit(self, x):
        x = np.asarray(x, np.float32)
        p = self._affinities(x)
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed)
        y0 = 1e-4 * torch.randn((x.shape[0], self.numDimension),
                                generator=g, device=self.device)
        self._embedding = self._optimize(p, y0).cpu().numpy()
        return self

    def getData(self) -> np.ndarray:
        if self._embedding is None:
            raise RuntimeError("call fit() first")
        return self._embedding

    def saveAsFile(self, labels, path):
        """Reference: BarnesHutTsne.saveAsFile(labels, path) — one
        'x y ... label' line per point."""
        emb = self.getData()
        with open(path, "w") as f:
            for i in range(emb.shape[0]):
                coords = " ".join(f"{v:.6f}" for v in emb[i])
                f.write(f"{coords} {labels[i]}\n")
