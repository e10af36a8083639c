"""GloVe word embeddings.

Counterpart of ``deeplearning4j_tpu/nlp/glove.py``: co-occurrence-count
factorization with the weighted least-squares objective

    J = sum_ij f(X_ij) (w_i . w~_j + b_i + b~_j - log X_ij)^2,
    f(x) = min(1, (x / xMax)^alpha)

The co-occurrence pass is the same host ETL (1/distance weighting), the
batch order the same numpy permutation; the AdaGrad step is autograd of
the same loss on the model's device. As in the reference, the AdaGrad
accumulators start from zero at every ``fit`` (a quirk kept for parity),
the ragged tail is padded with zero-weighted cells, and the loss curve is
the per-epoch sum of the step losses over the cell count (summed on the
host in float64 in the reference's order, read once an epoch). The
vectors start from a ``torch.Generator`` seeded with ``seed`` unless a
state was installed (``utils/convert.py`` ``embeddings_from_numpy``).

Reference capability: `deeplearning4j-nlp` org.deeplearning4j.models.glove
.Glove (SURVEY.md §2.7 NLP row)."""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend import resolve_device
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.nlp.word2vec import (
    VocabCache, Word2Vec, _generator, _host)


def _glove_loss(params, rows, cols, logx, weight):
    w, wt, b, bt = params["w"], params["wt"], params["b"], params["bt"]
    dots = torch.sum(w[rows] * wt[cols], dim=-1)
    diff = dots + b[rows] + bt[cols] - logx
    return torch.sum(weight * diff * diff)


class Glove:
    class Builder:
        def __init__(self):
            self._kw = {
                "minWordFrequency": 1, "vectorLength": 100,
                "windowSize": 5, "xMax": 100.0, "alpha": 0.75,
                "learningRate": 0.05, "epochs": 5, "batchSize": 4096,
                "seed": 0, "symmetric": True, "shuffle": True,
            }
            self._iter = None
            self._tok = None

        def minWordFrequency(self, n):
            self._kw["minWordFrequency"] = int(n)
            return self

        def vectorLength(self, n):
            self._kw["vectorLength"] = int(n)
            return self

        # DL4J name alias
        layerSize = vectorLength

        def windowSize(self, n):
            self._kw["windowSize"] = int(n)
            return self

        def xMax(self, x):
            self._kw["xMax"] = float(x)
            return self

        def alpha(self, a):
            self._kw["alpha"] = float(a)
            return self

        def learningRate(self, lr):
            self._kw["learningRate"] = float(lr)
            return self

        def epochs(self, n):
            self._kw["epochs"] = int(n)
            return self

        def batchSize(self, n):
            self._kw["batchSize"] = int(n)
            return self

        def seed(self, s):
            self._kw["seed"] = int(s)
            return self

        def symmetric(self, b):
            self._kw["symmetric"] = bool(b)
            return self

        def shuffle(self, b):
            self._kw["shuffle"] = bool(b)
            return self

        def iterate(self, sentence_iterator):
            self._iter = sentence_iterator
            return self

        def tokenizerFactory(self, tok):
            self._tok = tok
            return self

        def build(self, device=None) -> "Glove":
            return Glove(self._iter, self._tok or
                         DefaultTokenizerFactory(), device=device,
                         **self._kw)

    def __init__(self, sentence_iterator, tokenizer_factory, device=None,
                 **kw):
        self.device = resolve_device(device)
        self.sentences = sentence_iterator
        self.tokenizer = tokenizer_factory
        self.cfg = kw
        self.vocab = VocabCache()
        self.params = None

    # -- vocab + co-occurrence (host ETL) -----------------------------------
    def buildVocab(self):
        counts: dict[str, int] = {}
        for sent in self.sentences:
            for t in self.tokenizer.create(sent).getTokens():
                counts[t] = counts.get(t, 0) + 1
        min_f = self.cfg["minWordFrequency"]
        for w, c in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
            if c >= min_f:
                self.vocab.add(w, c)
        if self.vocab.numWords() == 0:
            raise ValueError(
                f"empty vocab: no word reaches minWordFrequency={min_f}")
        return self

    def _cooccurrences(self):
        """{(i, j): weighted count} with 1/distance weighting (the
        reference's CoOccurrences pass)."""
        win = self.cfg["windowSize"]
        sym = self.cfg["symmetric"]
        co: dict[tuple, float] = {}
        for sent in self.sentences:
            idxs = [self.vocab.indexOf(t)
                    for t in self.tokenizer.create(sent).getTokens()]
            idxs = [i for i in idxs if i >= 0]
            for pos, i in enumerate(idxs):
                for off in range(1, win + 1):
                    j_pos = pos + off
                    if j_pos >= len(idxs):
                        break
                    j = idxs[j_pos]
                    wgt = 1.0 / off
                    co[(i, j)] = co.get((i, j), 0.0) + wgt
                    if sym:
                        co[(j, i)] = co.get((j, i), 0.0) + wgt
        return co

    # -- device training -----------------------------------------------------
    def _step(self, grads_sq, rows, cols, logx, weight):
        """One AdaGrad step in place of ``self.params``; the loss as a 0-d
        tensor."""
        lr = self.cfg["learningRate"]
        leaves = {k: p.detach().requires_grad_()
                  for k, p in self.params.items()}
        with torch.enable_grad():
            loss = _glove_loss(leaves, rows, cols, logx, weight)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        for (k, p), g in zip(self.params.items(), grads):
            gsq = grads_sq[k] + g * g
            self.params[k] = p - lr * g / torch.sqrt(gsq + 1e-8)
            grads_sq[k] = gsq
        return loss.detach()

    def fit(self):
        if self.vocab.numWords() == 0:
            self.buildVocab()
        cfg = self.cfg
        v, d = self.vocab.numWords(), cfg["vectorLength"]
        rng = np.random.default_rng(cfg["seed"])
        dev = self.device
        if self.params is None:
            g = _generator(cfg["seed"], dev)
            init = lambda: (torch.rand(  # noqa: E731
                (v, d), generator=g, device=dev) - 0.5) / d
            self.params = {"w": init(), "wt": init(),
                           "b": torch.zeros(v, device=dev),
                           "bt": torch.zeros(v, device=dev)}
        # AdaGrad's accumulators start from zero at every fit, as the
        # reference's do
        grads_sq = {k: torch.zeros_like(p) for k, p in self.params.items()}

        co = self._cooccurrences()
        if not co:
            raise ValueError("no co-occurrences (corpus too small?)")
        pairs = np.asarray(list(co.keys()), np.int32)
        counts = np.asarray(list(co.values()), np.float32)
        logx = np.log(counts)
        weight = np.minimum(
            1.0, (counts / cfg["xMax"]) ** cfg["alpha"]).astype(np.float32)
        bsz = min(cfg["batchSize"], len(pairs))
        rows_d = torch.from_numpy(pairs[:, 0].astype(np.int64)).to(dev)
        cols_d = torch.from_numpy(pairs[:, 1].astype(np.int64)).to(dev)
        logx_d = torch.from_numpy(logx).to(dev)
        weight_d = torch.from_numpy(weight).to(dev)

        losses = []
        with torch.no_grad():
            for _epoch in range(cfg["epochs"]):
                order = (rng.permutation(len(pairs)) if cfg["shuffle"]
                         else np.arange(len(pairs)))
                step_losses = []
                for s in range(0, len(order) - bsz + 1, bsz):
                    sel = torch.from_numpy(order[s:s + bsz]).to(dev)
                    step_losses.append(self._step(
                        grads_sq, rows_d[sel], cols_d[sel], logx_d[sel],
                        weight_d[sel]))
                tail = order[len(order) - (len(order) % bsz):]
                if len(tail):
                    # pad the ragged tail with zero-weight cells
                    pad = bsz - len(tail)
                    sel = torch.from_numpy(
                        np.concatenate([tail, tail[:1].repeat(pad)])).to(dev)
                    wpad = weight_d[sel].clone()
                    wpad[len(tail):] = 0.0
                    step_losses.append(self._step(
                        grads_sq, rows_d[sel], cols_d[sel], logx_d[sel],
                        wpad))
                total = 0.0
                for loss in torch.stack(step_losses).tolist():
                    total += loss
                losses.append(total / max(len(pairs), 1))
        self._loss_curve = losses
        return self

    # -- lookups (same surface as Word2Vec) ----------------------------------
    def getWordVectorMatrix(self) -> np.ndarray:
        # the published GloVe convention: w + w~ as the final embedding
        return _host(self.params["w"]) + _host(self.params["wt"])

    def getWordVector(self, word) -> np.ndarray:
        i = self.vocab.indexOf(word)
        if i < 0:
            raise KeyError(word)
        return self.getWordVectorMatrix()[i]

    def hasWord(self, w):
        return self.vocab.containsWord(w)

    similarity = Word2Vec.similarity
    wordsNearest = Word2Vec.wordsNearest
