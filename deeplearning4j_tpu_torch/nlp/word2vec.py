"""Word2Vec: SkipGram / CBOW with negative sampling, on the GPU.

Counterpart of ``deeplearning4j_tpu/nlp/word2vec.py``. The host ETL
(vocab, negative tables, subsampling, host pairs, CBOW batches) is the
same numpy code and consumes the numpy generator in the same order, so
it matches the JAX package bit for bit. The device work is PyTorch ops on
the model's device ("cuda" unless the caller names the CPU):

- pair generation (``pair_slots``): subsampling by a keep test and a
  compaction of the token stream, then the skip-gram window over the
  compacted corpus and a compaction of the pairs, both as a cumsum and a
  ``scatter_`` into fixed slots (no host read until the epoch's pair
  count);
- the SGNS steps (``sgns_update``): the analytic update of the
  reference's ``_build_multi_step_fused``/``_build_multi_step``, with
  one gather of the context and negative rows, two ``bmm`` and two
  ``index_add_`` (never an indexed ``-=``, which would drop repeated
  rows);
- the CBOW step (``_build_step``): autograd of the same loss, a dense
  SGD update as the reference's ``jax.grad`` step.

Device draws come from ``torch.Generator``s seeded from the numpy
``rng.integers(0, 2**31)`` calls where the reference seeds its JAX keys,
so the numpy stream is consumed exactly as the reference consumes it.
The draws themselves differ from JAX's; the inner functions take them as
inputs (``pair_slots`` takes ``u`` and ``b``, ``sgns_epoch`` the
negatives), so tests can hand them the reference's own draws.

Reference capability: deeplearning4j-nlp org.deeplearning4j.models.word2vec
.Word2Vec + SkipGram/CBOW learning algorithms (BASELINE.json configs[4],
SURVEY.md §2.7)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.backend import resolve_device
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory, SentenceIterator)

# the pooled negatives' window: step i starts at
# (i * POOL_STRIDE mod 2^32) mod (n_pool - span), uint32 in the reference
POOL_STRIDE = 2654435761


class VocabWord:
    def __init__(self, word, count, index):
        self.word = word
        self.count = count
        self.index = index


class VocabCache:
    def __init__(self):
        self.words: list[VocabWord] = []
        self._by_word: dict[str, VocabWord] = {}

    def add(self, word, count):
        vw = VocabWord(word, count, len(self.words))
        self.words.append(vw)
        self._by_word[word] = vw
        return vw

    def containsWord(self, w):
        return w in self._by_word

    def indexOf(self, w):
        return self._by_word[w].index if w in self._by_word else -1

    def wordAtIndex(self, i):
        return self.words[i].word

    def wordFrequency(self, w):
        return self._by_word[w].count if w in self._by_word else 0

    def numWords(self):
        return len(self.words)

    def totalWordOccurrences(self):
        return sum(w.count for w in self.words)


def _sgns_loss(syn0, syn1, centers, contexts, negatives, weights):
    """Skip-gram negative sampling loss for a batch, summed over pairs.
    centers [B], contexts [B], negatives [B,K], weights [B] (0 = padding)."""
    c = syn0[centers]
    pos = syn1[contexts]
    neg = syn1[negatives]
    pos_score = torch.sum(c * pos, dim=-1)
    neg_score = torch.einsum("bd,bkd->bk", c, neg)
    per_pair = F.softplus(-pos_score) + torch.sum(F.softplus(neg_score), -1)
    return torch.sum(per_pair * weights)


def _cbow_loss(syn0, syn1, contexts_mat, context_mask, centers, negatives,
               weights):
    """CBOW: the mean of the context vectors predicts the center.
    contexts_mat [B,W], context_mask [B,W], centers [B], negatives [B,K],
    weights [B] (0 = padding)."""
    ctx = syn0[contexts_mat]
    m = context_mask[..., None]
    mean = torch.sum(ctx * m, dim=1) / torch.clamp(torch.sum(m, dim=1),
                                                   min=1.0)
    pos = syn1[centers]
    neg = syn1[negatives]
    pos_score = torch.sum(mean * pos, dim=-1)
    neg_score = torch.einsum("bd,bkd->bk", mean, neg)
    per_pair = F.softplus(-pos_score) + torch.sum(F.softplus(neg_score), -1)
    return torch.sum(per_pair * weights)


def _compaction_dests(valid, cap):
    """Stream-compaction destinations for ``cap`` slots with validity mask
    ``valid``: a valid slot goes to its rank among the valid slots
    (cumsum - 1), an invalid one to the one spare slot ``cap`` of a
    ``cap + 1`` buffer, whose value is thrown away. Returns (dests int64,
    the valid count as a 0-d tensor). The cumsum of a bool tensor is
    int64, so it is reused in place as the destinations."""
    dest = torch.cumsum(valid, 0)
    n_valid = dest[-1].clone()
    return dest.sub_(1).masked_fill_(~valid, cap), n_valid


def _compact(values, dest, cap, fill):
    """``values`` scattered to ``dest`` in a buffer of ``cap`` slots
    (+ the spare), the rest ``fill``."""
    out = torch.full((cap + 1,), fill, dtype=values.dtype,
                     device=values.device)
    return out.scatter_(0, dest, values)[:cap]


def _shift(a, d):
    """a[clip(pos + d, 0, p - 1)] as slice + concat, as the reference's."""
    if d > 0:
        return torch.cat([a[d:], a[-1:].expand(d)])
    return torch.cat([a[:1].expand(-d), a[:d]])


def pair_slots(flat, sid, window, b, keep_prob=None, u=None):
    """The epoch's skip-gram pairs, compacted, from the padded corpus.

    ``flat`` [p] token ids and ``sid`` [p] sentence ids (-1 = padding),
    int32 on the device; ``b`` [p] the window radii, drawn in [1,
    window]; with subsampling, ``keep_prob`` [V] float32 and ``u`` [p]
    the uniform draws of the keep test ``u < keep_prob[flat]``.

    Subsampling compacts the token stream first (the window closes over
    removed tokens); then position pos pairs with pos + d for 0 < |d| <=
    b[pos] inside its sentence. Pairs come out in corpus order (position
    major, d ascending) in the first n of ``p * 2 * window`` slots.
    Returns (centers, contexts, n) with n a 0-d tensor."""
    p = flat.shape[0]
    if u is not None:
        keep = (sid >= 0) & (u < keep_prob[flat])
        dest, _ = _compaction_dests(keep, p)
        flat = _compact(flat, dest, p, 0)
        sid = _compact(sid, dest, p, -1)
        del keep, dest
    pos = torch.arange(p, dtype=torch.int32, device=flat.device)
    real = sid >= 0
    offsets = (*range(-window, 0), *range(1, window + 1))
    valid = torch.stack([
        real & (_shift(sid, d) == sid) & (b >= abs(d))
        & ((pos >= -d) if d < 0 else (pos < p - d)) for d in offsets], 1)
    valid = valid.reshape(-1)
    del pos, real
    cap = valid.shape[0]
    dest, n_real = _compaction_dests(valid, cap)
    del valid
    centers = _compact(flat[:, None].expand(p, len(offsets)).reshape(-1),
                       dest, cap, 0)
    contexts = _compact(
        torch.stack([_shift(flat, d) for d in offsets], 1).reshape(-1),
        dest, cap, 0)
    return centers, contexts, n_real


def pool_offset(i, n_pool, span):
    """Where step i's negatives start in the pool: the reference's uint32
    ``i * 2654435761 % (n_pool - span)``, in Python integers."""
    return (i * POOL_STRIDE & 0xFFFFFFFF) % (n_pool - span)


def sgns_update(syn0, syn1, cent, ctx, negs, lr):
    """One analytic SGNS step on the rows of ``cent`` [B], ``ctx`` [B] and
    ``negs`` [B, K], in place on ``syn0`` and ``syn1``.

    With scores s = syn1[ids] . syn0[cent] for ids = (ctx, negs), the
    gradient factor is sigmoid(s) - label (label 1 for the context, 0
    for a negative): exactly the reference's -(1 - sigmoid) and sigmoid.
    Both updates read the rows before either table changes, as the
    reference's do."""
    b, d = cent.shape[0], syn0.shape[1]
    ids = torch.cat([ctx[:, None].to(negs.dtype), negs], 1).reshape(-1)
    c = syn0.index_select(0, cent)                             # [B, D]
    rows = syn1.index_select(0, ids).view(b, -1, d)            # [B, 1+K, D]
    g = torch.bmm(rows, c.unsqueeze(2)).squeeze(2).sigmoid_()  # [B, 1+K]
    g[:, 0] -= 1.0
    gc = torch.bmm(g.unsqueeze(1), rows).squeeze(1)            # [B, D]
    syn0.index_add_(0, cent, gc, alpha=-lr)
    syn1.index_add_(0, ids, (g.unsqueeze(2) * c.unsqueeze(1)).view(-1, d),
                    alpha=-lr)


def sgns_epoch(syn0, syn1, cent, ctx, n, negs_for, bsz, lr, steps=None):
    """SGNS over the first ``n`` pairs of ``cent``/``ctx`` in steps of
    ``bsz``; ``negs_for(i)`` gives step i's [bsz, K] negatives. The
    reference pads the epoch to its K bucket with zero-weighted pairs;
    they add exactly zero, so only the real pairs are run (the last step
    takes the first rows of its negatives). ``steps`` stops early."""
    n_steps = -(-n // bsz)
    for i in range(n_steps if steps is None else min(steps, n_steps)):
        lo, hi = i * bsz, min(n, (i + 1) * bsz)
        sgns_update(syn0, syn1, cent[lo:hi], ctx[lo:hi],
                    negs_for(i)[:hi - lo], lr)


def pooled_negatives(pool, bsz, k_neg):
    """``negs_for`` of the fused path: step i's negatives are the window
    of ``bsz * k_neg`` pool entries at ``pool_offset(i)``."""
    span = bsz * k_neg
    n_pool = pool.shape[0]

    def negs_for(i):
        off = pool_offset(i, n_pool, span)
        return pool[off:off + span].view(bsz, k_neg)

    return negs_for


def _generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def _host(t) -> np.ndarray:
    """A numpy copy of a tensor (never a view of the model's storage,
    which the in-place updates change)."""
    return t.detach().to("cpu", copy=True).numpy()


class Word2Vec:
    class Builder:
        def __init__(self):
            # batchSize 8192: the reference's measured step throughput
            # rose to it; SGNS quality is batch-tolerant
            self._kw = dict(minWordFrequency=5, layerSize=100, windowSize=5,
                            negative=5, learningRate=0.025, epochs=1,
                            iterations=1, seed=42, batchSize=8192,
                            sampling=1e-3, algorithm="skipgram")
            self._iter = None
            self._tok = None

        def minWordFrequency(self, n):
            self._kw["minWordFrequency"] = n
            return self

        def layerSize(self, n):
            self._kw["layerSize"] = n
            return self

        def windowSize(self, n):
            self._kw["windowSize"] = n
            return self

        def negativeSampling(self, n):
            self._kw["negative"] = int(n)
            return self

        def negative(self, n):
            return self.negativeSampling(n)

        def negativeSample(self, n):
            # DL4J name: Word2Vec.Builder#negativeSample(double)
            return self.negativeSampling(n)

        def learningRate(self, lr):
            self._kw["learningRate"] = lr
            return self

        def epochs(self, n):
            self._kw["epochs"] = n
            return self

        def iterations(self, n):
            self._kw["iterations"] = n
            return self

        def seed(self, s):
            self._kw["seed"] = s
            return self

        def batchSize(self, n):
            self._kw["batchSize"] = n
            return self

        def deviceETL(self, b=True):
            """Generate skip-gram pairs on the device (default ON for the
            SGNS path). Turn off to use the host/native pair generator
            (needed for shufflePairs)."""
            self._kw["deviceETL"] = bool(b)
            return self

        def shufflePairs(self, b=True):
            """Globally shuffle the epoch's (center, context) pairs before
            batching (host pairs only). The reference trains in corpus
            order, so this defaults OFF."""
            self._kw["shufflePairs"] = bool(b)
            return self

        def sampling(self, s):
            self._kw["sampling"] = s
            return self

        def exactNegatives(self, b=True):
            """Draw fresh negatives for every pair in every step. Default
            OFF: negatives come from a per-epoch pool of iid
            unigram^0.75 draws, each step slicing a pseudo-random window
            (same marginal distribution; windows can overlap across
            steps)."""
            self._kw["exactNegatives"] = bool(b)
            return self

        def elementsLearningAlgorithm(self, name):
            self._kw["algorithm"] = ("cbow" if "cbow" in str(name).lower()
                                     else "skipgram")
            return self

        def iterate(self, sentence_iterator: SentenceIterator):
            self._iter = sentence_iterator
            return self

        def tokenizerFactory(self, tok):
            self._tok = tok
            return self

        def build(self, device=None) -> "Word2Vec":
            return Word2Vec(self._iter, self._tok or
                            DefaultTokenizerFactory(), device=device,
                            **self._kw)

    def __init__(self, sentence_iterator, tokenizer_factory, device=None,
                 **kw):
        self.device = resolve_device(device)
        self.sentences = sentence_iterator
        self.tokenizer = tokenizer_factory
        self.cfg = kw
        self.vocab = VocabCache()
        self.syn0 = None     # input vectors [V,D] on self.device
        self.syn1 = None     # output vectors [V,D]
        self._neg_table = None
        self._neg_table_int = None
        self._step_fn = None
        self._k_bucket = None

    # -- vocab ---------------------------------------------------------------
    def _invalidate_corpus_caches(self):
        """Drop every token/corpus cache derived from the current
        sentences+vocab. Called by buildVocab(); call directly after
        mutating ``sentences`` in place without rebuilding the vocab."""
        for attr in ("_tok_flat", "_tok_offsets", "_keep_prob",
                     "_corpus_dev", "_keep_prob_dev", "_neg_table_dev"):
            if hasattr(self, attr):
                delattr(self, attr)
        self._k_bucket = None
        self._step_fn = None

    def buildVocab(self):
        self._invalidate_corpus_caches()
        old_words = [w.word for w in self.vocab.words]
        self.vocab = VocabCache()
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
        if self.syn0 is not None and \
                [w.word for w in self.vocab.words] != old_words:
            # the word -> index mapping changed: trained vectors no
            # longer line up with indices, so restart
            self.syn0 = None
            self.syn1 = None
        self._build_neg_tables()
        return self

    def _build_neg_tables(self):
        """Unigram^0.75 negative-sampling tables from the current vocab —
        callable lazily too, for models whose vocab was installed by a
        deserializer or a state transfer rather than buildVocab()."""
        freqs = np.array([max(w.count, 1) for w in self.vocab.words],
                         np.float64)
        probs = freqs ** 0.75
        self._neg_table = (probs / probs.sum()).astype(np.float64)
        # quantized unigram table: sampling is a uniform-int gather
        table_size = min(1_000_000, max(10_000, 100 * len(freqs)))
        counts = np.maximum(
            1, np.round(self._neg_table * table_size)).astype(np.int64)
        self._neg_table_int = np.repeat(
            np.arange(len(freqs), dtype=np.int32), counts)

    # -- pair generation (host ETL) -----------------------------------------
    def _encode_corpus(self, rng):
        total = self.vocab.totalWordOccurrences()
        t = self.cfg["sampling"]
        encoded = []
        for sent in self.sentences:
            idxs = []
            for tok in self.tokenizer.create(sent).getTokens():
                i = self.vocab.indexOf(tok)
                if i < 0:
                    continue
                if t > 0:
                    f = self.vocab.words[i].count / total
                    keep = (math.sqrt(f / t) + 1) * (t / f) if f > t else 1.0
                    if rng.random() > keep:
                        continue
                idxs.append(i)
            if len(idxs) > 1:
                encoded.append(np.asarray(idxs, np.int32))
        return encoded

    def _flat_token_cache(self):
        """One-time tokenize+index of the whole corpus into a flat int32
        array + sentence offsets, and the per-word keep probabilities."""
        if getattr(self, "_tok_flat", None) is not None:
            return self._tok_flat, self._tok_offsets, self._keep_prob
        by_word = self.vocab._by_word
        flats, lens = [], []
        for sent in self.sentences:
            toks = self.tokenizer.create(sent).getTokens()
            idx = [by_word[t].index for t in toks if t in by_word]
            flats.append(np.asarray(idx, np.int32))
            lens.append(len(idx))
        self._tok_flat = (np.concatenate(flats) if flats
                          else np.zeros(0, np.int32))
        self._tok_offsets = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=self._tok_offsets[1:])
        t = self.cfg["sampling"]
        if t > 0:
            total = self.vocab.totalWordOccurrences()
            f = np.array([w.count / total for w in self.vocab.words],
                         np.float64)
            keep = np.where(f > t, (np.sqrt(f / t) + 1) * (t / f), 1.0)
            self._keep_prob = np.minimum(keep, 1.0).astype(np.float32)
        else:
            self._keep_prob = None
        return self._tok_flat, self._tok_offsets, self._keep_prob

    def _subsampled_flat(self, rng):
        """Per-epoch frequent-word subsampling, vectorized over the flat
        token array. Returns (flat, offsets)."""
        flat, offsets, keep_prob = self._flat_token_cache()
        if keep_prob is None:
            return flat, offsets
        mask = rng.random(len(flat)) < keep_prob[flat]
        kept = flat[mask]
        csum = np.zeros(len(flat) + 1, np.int64)
        np.cumsum(mask, out=csum[1:])
        new_offsets = csum[offsets]
        return kept.astype(np.int32), new_offsets

    # -- device-side pair generation ----------------------------------------
    def _corpus_on_device(self):
        """The padded corpus (token ids, sentence ids; -1 = padding, to a
        multiple of 1024 as in the reference) and the keep probabilities,
        uploaded once across epochs."""
        flat, offsets, keep_prob = self._flat_token_cache()
        if getattr(self, "_corpus_dev", None) is None:
            sid = np.repeat(np.arange(len(offsets) - 1, dtype=np.int32),
                            np.diff(offsets))
            p_b = -(-max(1, len(flat)) // 1024) * 1024
            flat_pad = np.zeros(p_b, np.int32)
            flat_pad[:len(flat)] = flat
            sid_pad = np.full(p_b, -1, np.int32)
            sid_pad[:len(flat)] = sid
            self._corpus_dev = (torch.from_numpy(flat_pad).to(self.device),
                                torch.from_numpy(sid_pad).to(self.device))
            self._keep_prob_dev = (
                torch.from_numpy(keep_prob).to(self.device)
                if keep_prob is not None else None)
        return self._corpus_dev, self._keep_prob_dev

    def _device_pairs(self, rng):
        """Generate + compact the epoch's pairs on the device (subsampling
        included). Returns (cent, ctx, n) with cent/ctx of the padded slot
        capacity (the first n are real); n is read on the host once."""
        (flat, sid), keep_prob = self._corpus_on_device()
        seed_sub = int(rng.integers(0, 2 ** 31))
        seed_b = int(rng.integers(0, 2 ** 31))
        p = flat.shape[0]
        u = None
        if keep_prob is not None:
            u = torch.rand(p, generator=_generator(seed_sub, self.device),
                           device=self.device)
        b = torch.randint(1, self.cfg["windowSize"] + 1, (p,),
                          generator=_generator(seed_b, self.device),
                          device=self.device, dtype=torch.int32)
        cent, ctx, n = pair_slots(flat, sid, self.cfg["windowSize"], b,
                                  keep_prob, u)
        return cent, ctx, int(n)

    def _make_pairs_flat(self, flat, offsets, rng):
        """Skip-gram pairs straight from (flat, offsets) — native kernel
        when available, list-based fallback otherwise."""
        win = self.cfg["windowSize"]
        bs_all = rng.integers(1, win + 1, len(flat)).astype(np.int32)

        from deeplearning4j_tpu_torch import native

        if native.available():
            pairs = native.sg_pairs_flat(flat, offsets, bs_all)
            if pairs is not None:
                return pairs
        centers, contexts = [], []
        for i in range(len(offsets) - 1):
            idxs = flat[offsets[i]:offsets[i + 1]]
            bs = bs_all[offsets[i]:offsets[i + 1]]
            n = len(idxs)
            for pos in range(n):
                b = bs[pos]
                lo, hi = max(0, pos - b), min(n, pos + b + 1)
                for j in range(lo, hi):
                    if j != pos:
                        centers.append(idxs[pos])
                        contexts.append(idxs[j])
        return (np.asarray(centers, np.int32),
                np.asarray(contexts, np.int32))

    def _make_pairs(self, encoded, rng):
        """List-of-sentences front end over _make_pairs_flat."""
        if not encoded:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32))
        flat = np.concatenate(encoded).astype(np.int32)
        offsets = np.zeros(len(encoded) + 1, np.int64)
        np.cumsum([len(s) for s in encoded], out=offsets[1:])
        return self._make_pairs_flat(flat, offsets, rng)

    # -- training ------------------------------------------------------------
    def _build_step(self, cbow):
        """One SGD step by autograd of the summed loss: (loss, syn0 -
        lr * g0, syn1 - lr * g1), dense as the reference's jax.grad
        step."""
        lr = self.cfg["learningRate"]
        loss_fn = _cbow_loss if cbow else _sgns_loss

        def step(syn0, syn1, *batch):
            s0 = syn0.detach().requires_grad_()
            s1 = syn1.detach().requires_grad_()
            with torch.enable_grad():
                loss = loss_fn(s0, s1, *batch)
                g0, g1 = torch.autograd.grad(loss, (s0, s1))
            return loss.detach(), syn0 - lr * g0, syn1 - lr * g1

        return step

    def _init_vectors(self):
        v, d = self.vocab.numWords(), self.cfg["layerSize"]
        g = _generator(self.cfg["seed"], self.device)
        self.syn0 = (torch.rand((v, d), generator=g, device=self.device)
                     - 0.5) / d
        self.syn1 = torch.zeros((v, d), device=self.device)

    def _fused_epoch(self, cent, ctx, n, seed):
        """One pass of the fused path: a pool of ``max(2^21, 2 * bsz *
        K)`` unigram^0.75 draws (one randint + a table gather), each step
        slicing its window of it."""
        bsz, k_neg = self.cfg["batchSize"], self.cfg["negative"]
        table = self._neg_table_dev
        n_pool = max(1 << 21, 2 * bsz * k_neg)
        draws = torch.randint(0, table.shape[0], (n_pool,),
                              generator=_generator(seed, self.device),
                              device=self.device)
        sgns_epoch(self.syn0, self.syn1, cent, ctx, n,
                   pooled_negatives(table[draws], bsz, k_neg), bsz,
                   self.cfg["learningRate"])

    def _exact_epoch(self, cent, ctx, n, seed):
        """One pass with fresh negatives for every step (exactNegatives,
        or host pairs)."""
        bsz, k_neg = self.cfg["batchSize"], self.cfg["negative"]
        table = self._neg_table_dev
        g = _generator(seed, self.device)

        def negs_for(_i):
            return table[torch.randint(0, table.shape[0], (bsz, k_neg),
                                       generator=g, device=self.device)]

        sgns_epoch(self.syn0, self.syn1, cent, ctx, n, negs_for, bsz,
                   self.cfg["learningRate"])

    def fit(self):
        if self.vocab.numWords() == 0:
            self.buildVocab()
        if self._neg_table_int is None:
            # vocab may have been installed by a deserializer
            self._build_neg_tables()
        cfg = self.cfg
        rng = np.random.default_rng(cfg["seed"])
        if self.syn0 is None:
            self._init_vectors()
        cbow = cfg["algorithm"] == "cbow"
        if cbow and self._step_fn is None:
            self._step_fn = self._build_step(cbow)
        if not cbow and getattr(self, "_neg_table_dev", None) is None:
            self._neg_table_dev = torch.from_numpy(
                self._neg_table_int).to(self.device)
        with torch.no_grad():
            for _epoch in range(cfg["epochs"]):
                if cbow:
                    self._cbow_epoch(rng)
                    continue
                device_etl = (cfg.get("deviceETL", True)
                              and not cfg.get("shufflePairs"))
                if device_etl:
                    cent, ctx, n = self._device_pairs(rng)
                else:
                    flat, offsets = self._subsampled_flat(rng)
                    centers, contexts = self._make_pairs_flat(
                        flat, offsets, rng)
                    if cfg.get("shufflePairs"):
                        order = rng.permutation(len(centers))
                        centers = centers[order]
                        contexts = contexts[order]
                    n = len(centers)
                    cent = torch.from_numpy(centers).to(self.device)
                    ctx = torch.from_numpy(contexts).to(self.device)
                # the reference's K bucket (a 2% margin, a multiple of 8)
                # fixes its scan's length across epochs; its extra steps
                # are zero-weighted, so here they are not run
                bsz = cfg["batchSize"]
                k = max(1, (n + bsz - 1) // bsz)
                k = -(-(k + max(8, k // 50)) // 8) * 8
                if self._k_bucket is None or k > self._k_bucket:
                    self._k_bucket = k
                epoch = (self._fused_epoch if device_etl and
                         not cfg.get("exactNegatives") else
                         self._exact_epoch)
                for _it in range(cfg["iterations"]):
                    epoch(cent, ctx, n, int(rng.integers(0, 2 ** 31)))
                del cent, ctx
        return self

    def _cbow_epoch(self, rng):
        v, k_neg, bsz = (self.vocab.numWords(), self.cfg["negative"],
                         self.cfg["batchSize"])
        encoded = self._encode_corpus(rng)
        batches = self._cbow_batches(encoded, rng, bsz)
        dev = self.device
        for _ in range(self.cfg["iterations"]):
            for batch in batches:
                b = len(batch[0])
                if b == 0:
                    continue
                # pad the tail batch to the full batch size with
                # zero-weighted rows, as the reference does
                full = max(bsz, b)
                pad = full - b
                weights = np.concatenate(
                    [np.ones(b, np.float32), np.zeros(pad, np.float32)])
                batch = tuple(
                    np.concatenate(
                        [a, np.zeros((pad,) + a.shape[1:], a.dtype)])
                    if pad else a for a in batch)
                negs = rng.choice(v, size=(full, k_neg),
                                  p=self._neg_table).astype(np.int32)
                ctx_mat, mask, cent = (torch.from_numpy(a).to(dev)
                                       for a in batch)
                _loss, self.syn0, self.syn1 = self._step_fn(
                    self.syn0, self.syn1, ctx_mat.long(), mask,
                    cent.long(), torch.from_numpy(negs).to(dev).long(),
                    torch.from_numpy(weights).to(dev))

    def _cbow_batches(self, encoded, rng, bsz):
        win = self.cfg["windowSize"]
        rows_ctx, rows_mask, rows_center = [], [], []
        width = 2 * win
        for idxs in encoded:
            n = len(idxs)
            bs = rng.integers(1, win + 1, n)
            for pos in range(n):
                b = bs[pos]
                lo, hi = max(0, pos - b), min(n, pos + b + 1)
                ctx = [idxs[j] for j in range(lo, hi) if j != pos]
                if not ctx:
                    continue
                row = np.zeros(width, np.int32)
                msk = np.zeros(width, np.float32)
                row[:len(ctx)] = ctx
                msk[:len(ctx)] = 1.0
                rows_ctx.append(row)
                rows_mask.append(msk)
                rows_center.append(idxs[pos])
        ctx_m = np.stack(rows_ctx)
        mask = np.stack(rows_mask)
        cent = np.asarray(rows_center, np.int32)
        order = np.random.default_rng(0).permutation(len(cent))
        ctx_m, mask, cent = ctx_m[order], mask[order], cent[order]
        out = [(ctx_m[i:i + bsz], mask[i:i + bsz], cent[i:i + bsz])
               for i in range(0, len(cent), bsz)]
        return out or [(ctx_m, mask, cent)]

    # -- lookups (numpy, as the reference's) --------------------------------
    def getWordVector(self, word) -> np.ndarray:
        i = self.vocab.indexOf(word)
        if i < 0:
            raise KeyError(word)
        return _host(self.syn0[i])

    def getWordVectorMatrix(self) -> np.ndarray:
        return _host(self.syn0)

    def hasWord(self, w):
        return self.vocab.containsWord(w)

    def similarity(self, a, b) -> float:
        va, vb = self.getWordVector(a), self.getWordVector(b)
        return float(va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb)
                                + 1e-12))

    def wordsNearest(self, word_or_vec, n=10) -> list:
        if isinstance(word_or_vec, str):
            vec = self.getWordVector(word_or_vec)
            exclude = {word_or_vec}
        else:
            vec = np.asarray(word_or_vec)
            exclude = set()
        m = self.getWordVectorMatrix()
        norms = np.linalg.norm(m, axis=1) * (np.linalg.norm(vec) + 1e-12)
        sims = m @ vec / np.maximum(norms, 1e-12)
        order = np.argsort(-sims)
        out = []
        for i in order:
            w = self.vocab.wordAtIndex(int(i))
            if w not in exclude:
                out.append(w)
            if len(out) >= n:
                break
        return out
