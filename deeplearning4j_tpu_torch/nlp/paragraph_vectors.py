"""ParagraphVectors (doc2vec), PV-DBOW.

Counterpart of ``deeplearning4j_tpu/nlp/paragraph_vectors.py``: a document
vector predicts the words it contains (skip-gram with the doc id as the
'center'); ``inferVector()`` runs gradient steps on a fresh doc vector
with the word vectors frozen. The numpy draws (the pair order, the
negatives, inferVector's start) are the reference's, in its order; the
steps are autograd of the same losses on the model's device. The
vectors start from a ``torch.Generator`` seeded with ``seed + 1`` where
the reference seeds its JAX key, unless a state was installed
(``utils/convert.py`` ``embeddings_from_numpy``).

Reference capability: org.deeplearning4j.models.paragraphvectors
.ParagraphVectors (SURVEY.md §2.7)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.nlp.word2vec import (
    Word2Vec, _generator, _host, _sgns_loss)


class LabelledDocument:
    def __init__(self, content, label):
        self.content = content
        self.label = label


class ParagraphVectors(Word2Vec):
    class Builder(Word2Vec.Builder):
        def __init__(self):
            super().__init__()
            self._docs = None

        def iterate(self, docs):
            """docs: list of LabelledDocument or (label, text) tuples."""
            self._docs = [
                d if isinstance(d, LabelledDocument)
                else LabelledDocument(d[1], d[0]) for d in docs
            ]
            return self

        def build(self, device=None) -> "ParagraphVectors":
            from deeplearning4j_tpu_torch.nlp.tokenization import (
                CollectionSentenceIterator)

            sentences = CollectionSentenceIterator(
                [d.content for d in self._docs])
            pv = ParagraphVectors(sentences,
                                  self._tok or DefaultTokenizerFactory(),
                                  device=device, **self._kw)
            pv.docs = self._docs
            return pv

    def __init__(self, sentence_iterator, tokenizer_factory, device=None,
                 **kw):
        super().__init__(sentence_iterator, tokenizer_factory,
                         device=device, **kw)
        self.docs: list[LabelledDocument] = []
        self.doc_vecs = None
        self._labels: list[str] = []

    def fit(self):
        if self.vocab.numWords() == 0:
            self.buildVocab()
        if self._neg_table is None:
            self._build_neg_tables()
        cfg = self.cfg
        rng = np.random.default_rng(cfg["seed"])
        v, d = self.vocab.numWords(), cfg["layerSize"]
        n_docs = len(self.docs)
        self._labels = [doc.label for doc in self.docs]
        g = _generator(cfg["seed"] + 1, self.device)
        if self.syn0 is None:
            self.syn0 = (torch.rand((v, d), generator=g, device=self.device)
                         - 0.5) / d
            self.syn1 = torch.zeros((v, d), device=self.device)
        if self.doc_vecs is None:
            self.doc_vecs = (torch.rand((n_docs, d), generator=g,
                                        device=self.device) - 0.5) / d
        k_neg = cfg["negative"]
        # the same autograd step as Word2Vec's, with the doc vectors as
        # the input table
        step = self._build_step(cbow=False)
        dev = self.device
        bsz = cfg["batchSize"]
        for _epoch in range(cfg["epochs"]):
            doc_ids, words = [], []
            for di, doc in enumerate(self.docs):
                for tok in self.tokenizer.create(doc.content).getTokens():
                    wi = self.vocab.indexOf(tok)
                    if wi >= 0:
                        doc_ids.append(di)
                        words.append(wi)
            doc_ids = np.asarray(doc_ids, np.int32)
            words = np.asarray(words, np.int32)
            order = rng.permutation(len(doc_ids))
            doc_ids, words = doc_ids[order], words[order]
            for i in range(0, len(doc_ids), bsz):
                dids = doc_ids[i:i + bsz]
                ws = words[i:i + bsz]
                b = len(dids)
                if b == 0:
                    continue
                # zero-weight-pad the tail to the batch size
                full = max(bsz, b)
                pad = full - b
                weights = np.concatenate(
                    [np.ones(b, np.float32), np.zeros(pad, np.float32)])
                if pad:
                    dids = np.concatenate([dids, np.zeros(pad, np.int32)])
                    ws = np.concatenate([ws, np.zeros(pad, np.int32)])
                negs = rng.choice(v, size=(full, k_neg),
                                  p=self._neg_table).astype(np.int32)
                _loss, self.doc_vecs, self.syn1 = step(
                    self.doc_vecs, self.syn1,
                    *(torch.from_numpy(a).to(dev).long()
                      for a in (dids, ws, negs)),
                    torch.from_numpy(weights).to(dev))
        return self

    def getVector(self, label) -> np.ndarray:
        return _host(self.doc_vecs[self._labels.index(label)])

    def inferVector(self, text, steps=20) -> np.ndarray:
        """Fit a fresh doc vector against frozen word output vectors."""
        cfg = self.cfg
        rng = np.random.default_rng(0)
        words = [self.vocab.indexOf(t)
                 for t in self.tokenizer.create(text).getTokens()]
        words = np.asarray([w for w in words if w >= 0], np.int32)
        if len(words) == 0:
            return np.zeros(cfg["layerSize"], np.float32)
        vec = (rng.random(cfg["layerSize"]).astype(np.float32) - 0.5) \
            / cfg["layerSize"]
        dev = self.device
        vec = torch.from_numpy(vec).to(dev)
        syn1 = self.syn1.detach()
        lr = cfg["learningRate"]
        pos = syn1[torch.from_numpy(words).to(dev).long()]

        def loss_fn(v, neg):
            dv = v.expand(len(words), v.shape[0])
            p = torch.sum(dv * pos, dim=-1)
            ns = torch.einsum("bd,bkd->bk", dv, neg)
            # a mean: inferVector fits ONE vector, so a per-word sum
            # would scale the step with the document's length
            return torch.mean(F.softplus(-p)
                              + torch.sum(F.softplus(ns), dim=-1))

        for _ in range(steps):
            negs = rng.choice(self.vocab.numWords(),
                              size=(len(words), cfg["negative"]),
                              p=self._neg_table).astype(np.int32)
            neg = syn1[torch.from_numpy(negs).to(dev).long()]
            v = vec.detach().requires_grad_()
            with torch.enable_grad():
                (g,) = torch.autograd.grad(loss_fn(v, neg), (v,))
            vec = vec - lr * g
        return _host(vec)

    def similarityToLabel(self, text, label) -> float:
        a = self.inferVector(text)
        b = self.getVector(label)
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))

    def nearestLabels(self, text, n=5) -> list:
        a = self.inferVector(text)
        m = _host(self.doc_vecs)
        sims = m @ a / np.maximum(
            np.linalg.norm(m, axis=1) * (np.linalg.norm(a) + 1e-12), 1e-12)
        order = np.argsort(-sims)[:n]
        return [self._labels[int(i)] for i in order]
