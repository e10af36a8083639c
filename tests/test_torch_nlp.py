"""The port's NLP package (``deeplearning4j_tpu_torch/nlp``) against the JAX
package's, on the CPU.

- Bitwise: tokenization and the iterators, the vocab, both negative
  tables, the host ETL (``_flat_token_cache``, ``_subsampled_flat``,
  ``_encode_corpus``, ``_make_pairs_flat`` native and list, ``_cbow_batches``)
  for the same numpy seeds; the device pair generation (``pair_slots``)
  fed the reference's own draws (``jax.random.uniform`` of its
  ``key_sub`` and ``randint`` of its rbg ``key_b``, as its
  ``_build_pairgen`` draws them), slots and counts; the word-vector files,
  text and binary, written by either package and read by the other.
- Float32, from the same state: one SGNS and one CBOW step with explicit
  negatives against the reference's ``_build_step`` (loss relative
  ``STEP_TOL``, tables within ``STEP_TOL`` of the step's largest update);
  a whole fused epoch fed the reference's pool against
  ``_build_multi_step_fused``, and an exact-negatives epoch fed its
  per-step draws against ``_build_multi_step`` (``EPOCH_TOL`` of the
  largest update: only the order of the sums differs); whole ``fit``s of
  CBOW, ParagraphVectors (with ``inferVector``) and GloVe from a state
  carried across by ``utils/convert.py`` (``FIT_TOL`` of the largest
  element; numpy drives every draw in those paths, so the two runs take
  the same batches).
- ``tests/test_nlp.py``'s cases run on the port with ``device="cpu"``.
- Entry points raise without CUDA; ``cuda``-marked cases hold the card
  against the CPU (pair generation exactly, fused steps and a CBOW fit
  within the tolerances above) and skip here.
"""

import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nlp import (
    BasicLineIterator as JBasicLineIterator,
    CollectionSentenceIterator as JCollection, CommonPreprocessor as JCommon,
    DefaultTokenizerFactory as JTokFactory, Glove as JGlove,
    LabelledDocument as JDoc, ParagraphVectors as JPV, Word2Vec as JW2V,
    WordVectorSerializer as JSerializer)
from deeplearning4j_tpu import native as jnative
from deeplearning4j_tpu_torch import native
from deeplearning4j_tpu_torch.nlp import (
    BasicLineIterator, CollectionSentenceIterator, CommonPreprocessor,
    DefaultTokenizerFactory, Glove, LabelledDocument, ParagraphVectors,
    Word2Vec, WordVectorSerializer)
from deeplearning4j_tpu_torch.nlp import word2vec as pw
from deeplearning4j_tpu_torch.utils.convert import embeddings_from_numpy

STEP_TOL = 1e-5     # one step: relative loss, tables of the largest update
EPOCH_TOL = 1e-5    # a whole SGNS epoch, of the largest update
FIT_TOL = 1e-5      # a whole fit from the same state, of the largest element


def _zipf_corpus(n=300, vocab=60, length=12, seed=0):
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{i}" for i in rng.zipf(1.3, length) % vocab)
            for _ in range(n)]


def _synthetic_corpus(n=400, seed=0):
    """Two topic clusters; words within a topic co-occur (as
    tests/test_nlp.py's)."""
    rng = np.random.default_rng(seed)
    animals = ["cat", "dog", "horse", "cow", "sheep"]
    tech = ["cpu", "gpu", "ram", "disk", "net"]
    sents = []
    for _ in range(n):
        topic = animals if rng.random() < 0.5 else tech
        sents.append(" ".join(rng.choice(topic, 6)))
    return sents


def _pair(sents, window=5, sampling=1e-2, algorithm="skipgram", bsz=64,
          neg=3, layer=16, epochs=1, seed=3, **extra):
    """(reference, port on the CPU) built alike, vocab built."""
    models = []
    for cls, kw in ((JW2V, {}), (Word2Vec, {"device": "cpu"})):
        b = (cls.Builder().minWordFrequency(1).layerSize(layer)
             .windowSize(window).negativeSample(neg).batchSize(bsz)
             .sampling(sampling).epochs(epochs).seed(seed)
             .elementsLearningAlgorithm(algorithm).iterate(sents))
        for name, value in extra.items():
            getattr(b, name)(value)
        m = b.build(**kw)
        m.buildVocab()
        models.append(m)
    return models


def _state(rng, v, d):
    return (rng.normal(0, 0.1, (v, d)).astype(np.float32),
            rng.normal(0, 0.1, (v, d)).astype(np.float32))


def _vocab_state(model):
    return {"words": [w.word for w in model.vocab.words],
            "counts": [w.count for w in model.vocab.words]}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _update_err(got, want, start):
    """max |got - want| over the largest element of the update."""
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want - start).max())


# -- tokenization --------------------------------------------------------------

TEXTS = ["Hello  world foo", "Hello, World! 123", "  ", "a.b:c,d \"e\" (f)",
         "MiXeD [case] |pipe| x/y? z!; 9.5", "tab\tsep\nline"]


@pytest.mark.parametrize("text", TEXTS)
@pytest.mark.parametrize("pre", [False, True])
def test_tokens_equal_the_reference(text, pre):
    want_f, got_f = JTokFactory(), DefaultTokenizerFactory()
    if pre:
        want_f.setTokenPreProcessor(JCommon())
        got_f.setTokenPreProcessor(CommonPreprocessor())
    want, got = want_f.create(text), got_f.create(text)
    assert got.getTokens() == want.getTokens()
    assert got.countTokens() == want.countTokens()


def test_iterators_equal_the_reference(tmp_path):
    p = tmp_path / "c.txt"
    p.write_text("one two\n\n  three four \nfive\n")
    for got, want in ((BasicLineIterator(str(p)), JBasicLineIterator(str(p))),
                      (CollectionSentenceIterator(["x y", "z"]),
                       JCollection(["x y", "z"]))):
        assert list(got) == list(want)
        assert list(got) == list(want)       # reset
        got.reset()
        assert got.hasNext() and got.nextSentence() == list(want)[0]


# -- vocab and host ETL --------------------------------------------------------

@pytest.mark.parametrize("min_freq", [1, 3])
def test_vocab_and_negative_tables_bitwise(min_freq):
    sents = _zipf_corpus()
    j, p = _pair(sents)
    for m in (j, p):
        m.cfg["minWordFrequency"] = min_freq
        m.buildVocab()
    assert _vocab_state(p) == _vocab_state(j)
    assert [w.index for w in p.vocab.words] == list(range(p.vocab.numWords()))
    assert p.vocab.totalWordOccurrences() == j.vocab.totalWordOccurrences()
    assert p._neg_table.tobytes() == j._neg_table.tobytes()
    assert p._neg_table_int.tobytes() == j._neg_table_int.tobytes()
    for w in ("w1", "w0", "nope"):
        assert p.vocab.indexOf(w) == j.vocab.indexOf(w)
        assert p.vocab.wordFrequency(w) == j.vocab.wordFrequency(w)


@pytest.mark.parametrize("sampling", [0.0, 1e-2, 1e-1])
def test_flat_cache_subsampling_and_encoding_bitwise(sampling):
    j, p = _pair(_zipf_corpus(), sampling=sampling)
    for a, b in zip(p._flat_token_cache(), j._flat_token_cache()):
        assert (a is None and b is None) or a.tobytes() == b.tobytes()
    for a, b in zip(p._subsampled_flat(np.random.default_rng(4)),
                    j._subsampled_flat(np.random.default_rng(4))):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    rp, rj = np.random.default_rng(5), np.random.default_rng(5)
    got, want = p._encode_corpus(rp), j._encode_corpus(rj)
    assert len(got) == len(want)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(got, want))
    assert rp.random() == rj.random()     # the stream is consumed alike


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("window", [1, 3, 5])
def test_host_pairs_bitwise(use_native, window, monkeypatch):
    j, p = _pair(_zipf_corpus(), window=window)
    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    else:
        assert native.available()
    flat, offsets = p._subsampled_flat(np.random.default_rng(6))
    got = p._make_pairs_flat(flat, offsets, np.random.default_rng(7))
    want = j._make_pairs_flat(flat, offsets, np.random.default_rng(7))
    assert [a.tobytes() for a in got] == [b.tobytes() for b in want]
    enc = j._encode_corpus(np.random.default_rng(8))
    got = p._make_pairs(enc, np.random.default_rng(9))
    want = j._make_pairs(enc, np.random.default_rng(9))
    assert [a.tobytes() for a in got] == [b.tobytes() for b in want]


@pytest.mark.parametrize("window", [2, 5])
def test_cbow_batches_bitwise(window):
    j, p = _pair(_zipf_corpus(), window=window, algorithm="cbow", bsz=50)
    enc = j._encode_corpus(np.random.default_rng(1))
    got = p._cbow_batches(enc, np.random.default_rng(2), 50)
    want = j._cbow_batches(enc, np.random.default_rng(2), 50)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [a.dtype for a in g] == [a.dtype for a in w]
        assert [a.tobytes() for a in g] == [a.tobytes() for a in w]


# -- device pair generation ----------------------------------------------------

def _reference_draws(p, window, rng):
    """The reference's draws for an epoch: its key_sub uniform and its rbg
    key_b window radii, from the same two numpy seeds."""
    key_sub = jax.random.key(int(rng.integers(0, 2 ** 31)))
    key_b = jax.random.key(int(rng.integers(0, 2 ** 31)), impl="rbg")
    u = np.asarray(jax.random.uniform(key_sub, (p,)))
    b = np.asarray(jax.random.randint(key_b, (p,), 1, window + 1))
    return u, b


@pytest.mark.parametrize("window,sampling", [(5, 1e-2), (5, 1e-1), (5, 0.0),
                                             (1, 0.0), (3, 5e-2)])
def test_device_pairs_equal_the_reference_from_its_draws(window, sampling):
    j, p = _pair(_zipf_corpus(), window=window, sampling=sampling)
    cj, xj, nj = j._device_pairs(np.random.default_rng(11))
    (flat, sid), keep_prob = p._corpus_on_device()
    u, b = _reference_draws(flat.shape[0], window, np.random.default_rng(11))
    c, x, n = pw.pair_slots(
        flat, sid, window, torch.tensor(b, dtype=torch.int32), keep_prob,
        torch.tensor(u) if keep_prob is not None else None)
    assert int(n) == nj and nj > 0
    assert c.dtype == x.dtype == torch.int32
    assert c.numpy().tobytes() == np.asarray(cj).tobytes()
    assert x.numpy().tobytes() == np.asarray(xj).tobytes()


def test_device_pairs_at_window_1_equal_the_host_pairs():
    # window 1 fixes every radius, so with sampling off the device pairs
    # are the host generator's, in order (tests/test_nlp.py's contract)
    j, p = _pair(["a b c d e", "f g a b", "c c d"] * 40, window=1,
                 sampling=0.0)
    flat, offsets = p._subsampled_flat(np.random.default_rng(0))
    hc, hx = p._make_pairs_flat(flat, offsets, np.random.default_rng(1))
    cent, ctx, n = p._device_pairs(np.random.default_rng(2))
    assert n == len(hc)
    assert cent[:n].numpy().tobytes() == hc.tobytes()
    assert ctx[:n].numpy().tobytes() == hx.tobytes()


def test_device_pairs_consume_the_numpy_stream_as_the_reference():
    j, p = _pair(_zipf_corpus())
    rj, rp = np.random.default_rng(3), np.random.default_rng(3)
    j._device_pairs(rj)
    cent, ctx, n = p._device_pairs(rp)
    assert rj.integers(0, 2 ** 31) == rp.integers(0, 2 ** 31)
    v = p.vocab.numWords()
    assert ((cent[:n] >= 0) & (cent[:n] < v)).all()
    assert ((ctx[:n] >= 0) & (ctx[:n] < v)).all()
    assert (cent[n:] == 0).all() and (ctx[n:] == 0).all()


def test_pool_offset_is_the_reference_uint32_arithmetic():
    n_pool, span = 1 << 21, 8192 * 5
    i = np.arange(0, 5000, dtype=np.uint32)
    want = (i * np.uint32(2654435761) % np.uint32(n_pool - span))
    assert [pw.pool_offset(int(k), n_pool, span) for k in i] == \
        want.astype(np.int64).tolist()


# -- the steps -----------------------------------------------------------------

def test_one_sgns_step_with_explicit_negatives():
    j, p = _pair(_zipf_corpus(), bsz=32)
    rng = np.random.default_rng(1)
    v, d = p.vocab.numWords(), 16
    s0, s1 = _state(rng, v, d)
    cent = rng.integers(0, v, 32).astype(np.int32)
    ctx = rng.integers(0, v, 32).astype(np.int32)
    negs = rng.integers(0, v, (32, 3)).astype(np.int32)
    w = (np.arange(32) < 27).astype(np.float32)   # a padded tail
    wl, w0, w1 = j._build_step(False)(jnp.asarray(s0), jnp.asarray(s1),
                                      cent, ctx, negs, w)
    gl, g0, g1 = p._build_step(False)(
        torch.tensor(s0), torch.tensor(s1),
        *(torch.from_numpy(a).long() for a in (cent, ctx, negs)),
        torch.from_numpy(w))
    assert abs(float(gl) - float(wl)) <= STEP_TOL * abs(float(wl))
    assert _update_err(g0, w0, s0) <= STEP_TOL
    assert _update_err(g1, w1, s1) <= STEP_TOL


def test_one_cbow_step_with_explicit_negatives():
    j, p = _pair(_zipf_corpus(), algorithm="cbow", bsz=32, window=3)
    rng = np.random.default_rng(2)
    v, d = p.vocab.numWords(), 16
    s0, s1 = _state(rng, v, d)
    ctx = rng.integers(0, v, (32, 6)).astype(np.int32)
    mask = (rng.random((32, 6)) < 0.7).astype(np.float32)
    mask[3] = 0.0                                  # no context at all
    cent = rng.integers(0, v, 32).astype(np.int32)
    negs = rng.integers(0, v, (32, 3)).astype(np.int32)
    w = (np.arange(32) < 30).astype(np.float32)
    wl, w0, w1 = j._build_step(True)(jnp.asarray(s0), jnp.asarray(s1),
                                     ctx, mask, cent, negs, w)
    gl, g0, g1 = p._build_step(True)(
        torch.tensor(s0), torch.tensor(s1), torch.from_numpy(ctx).long(),
        torch.from_numpy(mask), torch.from_numpy(cent).long(),
        torch.from_numpy(negs).long(), torch.from_numpy(w))
    assert abs(float(gl) - float(wl)) <= STEP_TOL * abs(float(wl))
    assert _update_err(g0, w0, s0) <= STEP_TOL
    assert _update_err(g1, w1, s1) <= STEP_TOL


def _epoch_inputs(j, bsz):
    cent, ctx, n = j._device_pairs(np.random.default_rng(1))
    k = -(-n // bsz)
    k = -(-(k + max(8, k // 50)) // 8) * 8      # the reference's bucket
    full = k * bsz
    cent = jnp.pad(cent, (0, max(0, full - cent.shape[0])))
    ctx = jnp.pad(ctx, (0, max(0, full - ctx.shape[0])))
    return cent, ctx, n, k


@pytest.mark.parametrize("bsz", [64, 200])
def test_fused_epoch_fed_the_reference_pool(bsz):
    j, p = _pair(_zipf_corpus(), bsz=bsz)
    v, d, k_neg = p.vocab.numWords(), 16, 3
    s0, s1 = _state(np.random.default_rng(3), v, d)
    cent, ctx, n, k = _epoch_inputs(j, bsz)
    n_pool = max(1 << 21, 2 * bsz * k_neg)
    table = jnp.asarray(j._neg_table_int)
    key = jax.random.key(1234)
    w0, w1 = j._build_multi_step_fused(k, bsz, n_pool)(
        jnp.asarray(s0), jnp.asarray(s1), cent, ctx, jnp.int32(n), table,
        key)
    pool = np.asarray(table[jax.random.randint(key, (n_pool,), 0,
                                               table.shape[0])])
    g0, g1 = torch.tensor(s0), torch.tensor(s1)
    pw.sgns_epoch(g0, g1, torch.from_numpy(np.asarray(cent)),
                  torch.from_numpy(np.asarray(ctx)), n,
                  pw.pooled_negatives(torch.from_numpy(pool), bsz, k_neg),
                  bsz, 0.025)
    assert n % bsz != 0          # a ragged last step
    assert _update_err(g0, w0, s0) <= EPOCH_TOL
    assert _update_err(g1, w1, s1) <= EPOCH_TOL


def test_exact_negatives_epoch_fed_the_reference_draws():
    bsz, k_neg = 64, 3
    j, p = _pair(_zipf_corpus(), bsz=bsz)
    v, d = p.vocab.numWords(), 16
    s0, s1 = _state(np.random.default_rng(4), v, d)
    cent, ctx, n, k = _epoch_inputs(j, bsz)
    w_k = (jnp.arange(k * bsz) < n).astype(jnp.float32).reshape(k, bsz)
    table = jnp.asarray(j._neg_table_int)
    key = jax.random.key(99)
    _losses, w0, w1 = j._build_multi_step()(
        jnp.asarray(s0), jnp.asarray(s1), cent[:k * bsz].reshape(k, bsz),
        ctx[:k * bsz].reshape(k, bsz), w_k, table, key)

    def negs_for(i):
        draws = jax.random.randint(jax.random.fold_in(key, i),
                                   (bsz, k_neg), 0, table.shape[0])
        return torch.from_numpy(np.asarray(table[draws]))

    g0, g1 = torch.tensor(s0), torch.tensor(s1)
    pw.sgns_epoch(g0, g1, torch.from_numpy(np.asarray(cent)),
                  torch.from_numpy(np.asarray(ctx)), n, negs_for, bsz, 0.025)
    assert _update_err(g0, w0, s0) <= EPOCH_TOL
    assert _update_err(g1, w1, s1) <= EPOCH_TOL


def test_sgns_update_adds_every_repeated_row():
    # a batch that repeats one center and one context row: an indexed
    # `-=` would keep one update, index_add_ keeps them all
    rng = np.random.default_rng(5)
    s0, s1 = _state(rng, 4, 8)
    cent = torch.tensor([1, 1, 1, 2], dtype=torch.int32)
    ctx = torch.tensor([3, 3, 0, 3], dtype=torch.int32)
    negs = torch.tensor([[0, 2], [0, 0], [3, 1], [2, 2]], dtype=torch.int32)
    g0, g1 = torch.tensor(s0, dtype=torch.float64), \
        torch.tensor(s1, dtype=torch.float64)
    pw.sgns_update(g0, g1, cent, ctx, negs, 0.5)
    w0, w1 = s0.astype(np.float64), s1.astype(np.float64)
    d0, d1 = np.zeros_like(w0), np.zeros_like(w1)
    for b in range(4):
        c = w0[cent[b]]
        for idx, label in [(int(ctx[b]), 1.0)] + [(int(i), 0.0)
                                                  for i in negs[b]]:
            g = 1 / (1 + np.exp(-c @ w1[idx])) - label
            d0[cent[b]] += g * w1[idx]
            d1[idx] += g * c
    np.testing.assert_allclose(g0.numpy(), w0 - 0.5 * d0, rtol=0, atol=1e-12)
    np.testing.assert_allclose(g1.numpy(), w1 - 0.5 * d1, rtol=0, atol=1e-12)


# -- whole fits from a carried-over state --------------------------------------

def _carry_w2v(j, p, seed=0):
    v, d = j.vocab.numWords(), j.cfg["layerSize"]
    s0, s1 = _state(np.random.default_rng(seed), v, d)
    j.syn0, j.syn1 = jnp.asarray(s0), jnp.asarray(s1)
    embeddings_from_numpy(p, dict(_vocab_state(j), syn0=s0, syn1=s1))
    return s0, s1


@pytest.mark.parametrize("sampling", [0.0, 1e-2])
def test_cbow_fit_from_carried_state(sampling):
    j, p = _pair(_zipf_corpus(), algorithm="cbow", window=3, bsz=100,
                 sampling=sampling, epochs=2)
    _carry_w2v(j, p)
    j.fit()
    p.fit()
    assert p.syn0.device.type == "cpu"
    assert _rel(p.syn0, j.syn0) <= FIT_TOL
    assert _rel(p.syn1, j.syn1) <= FIT_TOL


def _docs(cls, n=12, seed=3):
    rng = np.random.default_rng(seed)
    animals = ["cat", "dog", "horse", "cow"]
    tech = ["cpu", "gpu", "ram", "disk"]
    docs = []
    for i in range(n):
        topic, name = ((animals, f"animal_{i}") if i % 2 == 0
                       else (tech, f"tech_{i}"))
        docs.append(cls(" ".join(rng.choice(topic, 12)), name))
    return docs


def test_paragraph_vectors_fit_and_infer_from_carried_state():
    models = []
    for cls, doc, kw in ((JPV, JDoc, {}), (ParagraphVectors,
                                            LabelledDocument,
                                            {"device": "cpu"})):
        m = (cls.Builder().minWordFrequency(1).layerSize(16).epochs(5)
             .learningRate(0.01).seed(2).batchSize(20).sampling(0)
             .iterate(_docs(doc)).build(**kw))
        m.buildVocab()
        models.append(m)
    j, p = models
    rng = np.random.default_rng(1)
    v, d = j.vocab.numWords(), 16
    s0, s1 = _state(rng, v, d)
    docs = rng.normal(0, 0.1, (len(j.docs), d)).astype(np.float32)
    j.syn0, j.syn1, j.doc_vecs = (jnp.asarray(a) for a in (s0, s1, docs))
    embeddings_from_numpy(p, dict(_vocab_state(j), syn0=s0, syn1=s1,
                                  doc_vecs=docs))
    j.fit()
    p.fit()
    assert _rel(p.doc_vecs, j.doc_vecs) <= FIT_TOL
    assert _rel(p.syn1, j.syn1) <= FIT_TOL
    assert p.syn0.numpy().tobytes() == s0.tobytes()     # not trained
    assert _rel(p.getVector("tech_3"), j.getVector("tech_3")) <= FIT_TOL
    for text in ("cat dog cow horse cat dog", "gpu ram zzz disk"):
        assert _rel(p.inferVector(text), j.inferVector(text)) <= FIT_TOL
    assert p.nearestLabels("cat dog cow", 3) == j.nearestLabels(
        "cat dog cow", 3)
    assert np.array_equal(p.inferVector("zzz"), j.inferVector("zzz"))


GLOVE_CORPUS = ["the king sits on the throne",
                "the queen sits on the throne",
                "the dog runs in the park",
                "the cat runs in the park",
                "king and queen rule the land",
                "dog and cat play in the park"] * 8


@pytest.mark.parametrize("symmetric,shuffle,bsz", [
    (True, True, 64), (False, True, 50), (True, False, 4096)])
def test_glove_fit_from_carried_state(symmetric, shuffle, bsz):
    models = []
    for cls, kw in ((JGlove, {}), (Glove, {"device": "cpu"})):
        g = (cls.Builder().minWordFrequency(1).vectorLength(16)
             .windowSize(3).learningRate(0.05).epochs(4).seed(1)
             .batchSize(bsz).symmetric(symmetric).shuffle(shuffle)
             .iterate(GLOVE_CORPUS).build(**kw))
        g.buildVocab()
        models.append(g)
    j, p = models
    assert p._cooccurrences() == j._cooccurrences()
    rng = np.random.default_rng(7)
    v = j.vocab.numWords()
    state = dict(_vocab_state(j), w=rng.normal(0, 0.1, (v, 16)),
                 wt=rng.normal(0, 0.1, (v, 16)), b=rng.normal(0, 0.1, v),
                 bt=rng.normal(0, 0.1, v))
    j.params = {k: jnp.asarray(np.asarray(state[k], np.float32))
                for k in ("w", "wt", "b", "bt")}
    embeddings_from_numpy(p, state)
    for _ in range(2):       # the AdaGrad state restarts at every fit
        j.fit()
        p.fit()
        for k in ("w", "wt", "b", "bt"):
            assert _rel(p.params[k], j.params[k]) <= FIT_TOL, k
        np.testing.assert_allclose(p._loss_curve, j._loss_curve,
                                   rtol=FIT_TOL)
    assert _rel(p.getWordVectorMatrix(), j.getWordVectorMatrix()) <= FIT_TOL
    assert p.wordsNearest("king", 3) == j.wordsNearest("king", 3)


def test_carried_state_is_checked():
    j, p = _pair(_zipf_corpus())
    v = j.vocab.numWords()
    with pytest.raises(ValueError, match="syn0"):
        embeddings_from_numpy(p, dict(_vocab_state(j), syn0=np.zeros((v, 3)),
                                      syn1=np.zeros((v, 16))))
    with pytest.raises(ValueError, match="counts"):
        embeddings_from_numpy(p, {"words": ["a"], "counts": [],
                                  "syn0": None, "syn1": None})


# -- persistence across packages -----------------------------------------------

def _tiny(cls, **kw):
    m = cls(None, None, minWordFrequency=1, layerSize=4, windowSize=2,
            negative=2, learningRate=0.025, epochs=1, iterations=1, seed=0,
            batchSize=8, sampling=0, algorithm="skipgram", **kw)
    for w in ("alpha", "beta", "gamma", "日本語"):
        m.vocab.add(w, 1)
    rng = np.random.default_rng(0)
    mat = (rng.normal(0, 1, (4, 4)) * 10.0 ** rng.integers(-9, 6, (4, 4))) \
        .astype(np.float32)
    mat[1] = 0.0
    mat[2, :2] = (-0.0, 5e-7)      # a negative zero, a value that rounds up
    return m, mat


@pytest.mark.parametrize("fmt", ["text", "binary"])
def test_word_vector_files_cross_packages(fmt, tmp_path):
    j, mat = _tiny(JW2V)
    p, _ = _tiny(Word2Vec, device="cpu")
    j.syn0, p.syn0 = jnp.asarray(mat), torch.tensor(mat)
    write, read = {"text": ("writeWord2VecModel", "readWord2VecModel"),
                   "binary": ("writeWord2VecBinary",
                              "readWord2VecBinary")}[fmt]
    pj, pp = tmp_path / "j", tmp_path / "p"
    getattr(JSerializer, write)(j, str(pj))
    getattr(WordVectorSerializer, write)(p, str(pp))
    assert pp.read_bytes() == pj.read_bytes()
    for path in (pj, pp):
        got = getattr(WordVectorSerializer, read)(str(path), device="cpu")
        want = getattr(JSerializer, read)(str(path))
        assert got.syn0.device.type == "cpu"
        assert _vocab_state(got) == _vocab_state(want)
        assert got.getWordVectorMatrix().tobytes() == np.asarray(
            want.getWordVectorMatrix()).tobytes()
        assert (got.syn1 == 0).all()
        auto = WordVectorSerializer.loadStaticModel(str(path), device="cpu")
        assert auto.getWordVectorMatrix().tobytes() == \
            got.getWordVectorMatrix().tobytes()


# -- tests/test_nlp.py's cases on the port -------------------------------------

class TestPortTokenization:
    def test_default_tokenizer(self):
        tok = DefaultTokenizerFactory().create("Hello  world foo")
        assert tok.getTokens() == ["Hello", "world", "foo"]
        assert tok.countTokens() == 3

    def test_common_preprocessor(self):
        f = DefaultTokenizerFactory()
        f.setTokenPreProcessor(CommonPreprocessor())
        assert f.create("Hello, World! 123").getTokens() == ["hello",
                                                            "world"]

    def test_line_iterator(self, tmp_path):
        p = tmp_path / "c.txt"
        p.write_text("one two\nthree four\n\n")
        it = BasicLineIterator(str(p))
        assert list(it) == ["one two", "three four"]
        assert list(it) == ["one two", "three four"]


class TestPortWord2Vec:
    def _fit(self, algorithm="skipgram", epochs=3):
        return (Word2Vec.Builder()
                .minWordFrequency(2).layerSize(24).windowSize(3)
                .negativeSampling(5).learningRate(0.025).epochs(epochs)
                .seed(1).batchSize(128).sampling(0)
                .elementsLearningAlgorithm(algorithm)
                .iterate(CollectionSentenceIterator(_synthetic_corpus()))
                .tokenizerFactory(DefaultTokenizerFactory())
                .build(device="cpu").fit())

    def test_vocab_built(self):
        vec = self._fit(epochs=1)
        assert vec.vocab.numWords() == 10
        assert vec.hasWord("cat") and vec.hasWord("cpu")

    def test_topic_structure_learned(self):
        vec = self._fit()
        within = vec.similarity("cat", "dog")
        across = vec.similarity("cat", "cpu")
        assert within > across + 0.2, (within, across)

    def test_words_nearest(self):
        vec = self._fit()
        nearest = vec.wordsNearest("cat", 4)
        animals = {"dog", "horse", "cow", "sheep"}
        assert len(set(nearest) & animals) >= 3, nearest

    def test_cbow_learns_too(self):
        vec = self._fit(algorithm="cbow")
        assert vec.similarity("cat", "dog") > vec.similarity("cat", "cpu")

    def test_word_vector_shape(self):
        vec = self._fit(epochs=1)
        assert vec.getWordVector("cat").shape == (24,)
        with pytest.raises(KeyError):
            vec.getWordVector("zebra")

    def test_serialization_roundtrip(self, tmp_path):
        vec = self._fit(epochs=1)
        p = str(tmp_path / "w2v.txt")
        WordVectorSerializer.writeWord2VecModel(vec, p)
        loaded = WordVectorSerializer.readWord2VecModel(p, device="cpu")
        np.testing.assert_allclose(loaded.getWordVector("cat"),
                                   vec.getWordVector("cat"), atol=1e-5)
        assert loaded.vocab.numWords() == vec.vocab.numWords()

    def test_empty_vocab_raises(self):
        with pytest.raises(ValueError):
            (Word2Vec.Builder().minWordFrequency(100)
             .iterate(CollectionSentenceIterator(["a b c"]))
             .build(device="cpu").buildVocab())


class TestPortParagraphVectors:
    def test_doc_clusters(self):
        rng = np.random.default_rng(3)
        animals = ["cat", "dog", "horse", "cow"]
        tech = ["cpu", "gpu", "ram", "disk"]
        docs = []
        for i in range(20):
            topic, name = ((animals, f"animal_{i}") if i % 2 == 0
                           else (tech, f"tech_{i}"))
            docs.append(LabelledDocument(
                " ".join(rng.choice(topic, 12)), name))
        pv = (ParagraphVectors.Builder()
              .minWordFrequency(1).layerSize(16).epochs(30)
              .learningRate(0.01).seed(2).batchSize(64).sampling(0)
              .iterate(docs).build(device="cpu").fit())
        a = pv.getVector("animal_0")
        assert a.shape == (16,)
        labels = pv.nearestLabels("cat dog cow horse cat dog", 4)
        n_animal = sum(1 for lab in labels if lab.startswith("animal"))
        assert n_animal >= 3, labels


class TestPortGlove:
    def test_trains_and_loss_decreases(self):
        g = (Glove.Builder().minWordFrequency(1).vectorLength(16)
             .windowSize(3).learningRate(0.05).epochs(12).seed(1)
             .iterate(GLOVE_CORPUS).build(device="cpu"))
        g.fit()
        assert g._loss_curve[-1] < g._loss_curve[0]
        vec = g.getWordVector("king")
        assert vec.shape == (16,) and np.isfinite(vec).all()

    def test_distributional_similarity(self):
        g = (Glove.Builder().minWordFrequency(1).vectorLength(24)
             .windowSize(4).learningRate(0.08).epochs(60).seed(3)
             .iterate(GLOVE_CORPUS).build(device="cpu"))
        g.fit()
        assert g.similarity("king", "queen") > g.similarity("king", "park")

    def test_unknown_word_raises(self):
        g = (Glove.Builder().minWordFrequency(1).vectorLength(8)
             .epochs(1).iterate(["a b c"]).build(device="cpu"))
        g.fit()
        with pytest.raises(KeyError):
            g.getWordVector("zebra")


class TestPortWord2VecBinaryFormat:
    def _tiny_model(self):
        m = Word2Vec(None, None, device="cpu", minWordFrequency=1,
                     layerSize=4, windowSize=2, negative=2,
                     learningRate=0.025, epochs=1, iterations=1, seed=0,
                     batchSize=8, sampling=0, algorithm="skipgram")
        for w in ("alpha", "beta", "gamma"):
            m.vocab.add(w, 1)
        m.syn0 = torch.from_numpy(
            np.arange(12, dtype=np.float32).reshape(3, 4) / 10.0)
        m.syn1 = torch.zeros_like(m.syn0)
        return m

    def test_binary_round_trip(self, tmp_path):
        m = self._tiny_model()
        p = str(tmp_path / "vec.bin")
        WordVectorSerializer.writeWord2VecBinary(m, p)
        r = WordVectorSerializer.readWord2VecBinary(p, device="cpu")
        assert r.vocab.wordAtIndex(1) == "beta"
        assert np.allclose(r.getWordVectorMatrix(), m.getWordVectorMatrix())

    def test_load_static_model_autodetects(self, tmp_path):
        m = self._tiny_model()
        pb = str(tmp_path / "vec.bin")
        pt = str(tmp_path / "vec.txt")
        WordVectorSerializer.writeWord2VecBinary(m, pb)
        WordVectorSerializer.writeWord2VecModel(m, pt)
        for p in (pb, pt):
            r = WordVectorSerializer.loadStaticModel(p, device="cpu")
            assert np.allclose(r.getWordVectorMatrix(),
                               m.getWordVectorMatrix(), atol=1e-5)

    def test_load_static_model_hard_cases(self, tmp_path):
        m = self._tiny_model()
        m.syn0 = torch.zeros_like(m.syn0)          # all-zero binary payload
        pb = str(tmp_path / "zeros.bin")
        WordVectorSerializer.writeWord2VecBinary(m, pb)
        r = WordVectorSerializer.loadStaticModel(pb, device="cpu")
        assert np.allclose(r.getWordVectorMatrix(), 0.0)
        mat = self._tiny_model().getWordVectorMatrix()
        pt = str(tmp_path / "uni.txt")
        with io.open(pt, "w", encoding="utf-8") as f:
            f.write(f"{mat.shape[0]} {mat.shape[1]}\n")
            for i in range(mat.shape[0]):
                word = "日本語テスト" * 12 + str(i)
                f.write(word + " "
                        + " ".join(f"{x:.6f}" for x in mat[i]) + "\n")
        r2 = WordVectorSerializer.loadStaticModel(pt, device="cpu")
        assert np.allclose(r2.getWordVectorMatrix(), mat, atol=1e-5)


class TestPortDevicePairGen:
    def _w2v(self, window, sampling=0.0):
        sents = ["a b c d e", "f g a b", "c c d"] * 40
        w = (Word2Vec.Builder().minWordFrequency(1).layerSize(16)
             .windowSize(window).negativeSample(2).batchSize(64)
             .sampling(sampling).epochs(1).seed(3).iterate(sents)
             .build(device="cpu"))
        w.buildVocab()
        return w

    def test_window3_pair_count_and_validity(self):
        w2v = self._w2v(3)
        cent, ctx, n = w2v._device_pairs(np.random.default_rng(5))
        v = w2v.vocab.numWords()
        c, x = cent[:n].numpy(), ctx[:n].numpy()
        assert n > 0
        assert ((0 <= c) & (c < v)).all() and ((0 <= x) & (x < v)).all()
        rng = np.random.default_rng(0)
        flat, offsets = w2v._subsampled_flat(rng)
        lo, _ = self._w2v(1)._make_pairs_flat(flat, offsets,
                                              np.random.default_rng(1))
        assert len(lo) <= n

    @pytest.mark.parametrize("options", [
        {"deviceETL": False}, {"shufflePairs": True},
        {"exactNegatives": True}, {}])
    def test_every_sgns_path_trains(self, options):
        b = (Word2Vec.Builder().minWordFrequency(1).layerSize(8)
             .windowSize(2).negativeSample(2).batchSize(32).epochs(2)
             .seed(0).iterate(["x y z w v u t s"] * 30))
        for name, value in options.items():
            getattr(b, name)(value)
        w2v = b.build(device="cpu")
        w2v.buildVocab()
        w2v.fit()
        start = w2v.getWordVectorMatrix()
        w2v.fit()
        assert np.isfinite(w2v.getWordVectorMatrix()).all()
        assert not np.array_equal(w2v.getWordVectorMatrix(), start)
        assert w2v._k_bucket % 8 == 0


# -- the device rule -----------------------------------------------------------

def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m, mat = _tiny(Word2Vec, device="cpu")
    m.syn0 = torch.tensor(mat)
    path = str(tmp_path / "v.bin")
    WordVectorSerializer.writeWord2VecBinary(m, path)
    for call in (lambda: Word2Vec.Builder().iterate(["a b"]).build(),
                 lambda: ParagraphVectors.Builder().iterate(
                     [("l", "a b")]).build(),
                 lambda: Glove.Builder().iterate(["a b"]).build(),
                 lambda: Word2Vec(None, None, layerSize=4),
                 lambda: WordVectorSerializer.readWord2VecBinary(path),
                 lambda: WordVectorSerializer.loadStaticModel(path),
                 lambda: Word2Vec.Builder().iterate(["a b"]).build("cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert Word2Vec.Builder().iterate(["a b"]).build(
        "cpu").device.type == "cpu"


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _port_model(device, **kw):
    b = (Word2Vec.Builder().minWordFrequency(1).layerSize(32).windowSize(5)
         .negativeSample(5).batchSize(256).sampling(1e-2).epochs(1).seed(5)
         .iterate(_zipf_corpus(2000, 500, 20)))
    for name, value in kw.items():
        getattr(b, name)(value)
    m = b.build(device)
    m.buildVocab()
    return m


@pytest.mark.cuda
def test_pair_generation_on_the_card_equals_the_cpu(cuda):
    g, c = _port_model(cuda), _port_model("cpu")
    (flat, sid), keep = g._corpus_on_device()
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    u = torch.rand(flat.shape[0], generator=gen, device=cuda)
    b = torch.randint(1, 6, flat.shape, generator=gen, device=cuda,
                      dtype=torch.int32)
    got = pw.pair_slots(flat, sid, 5, b, keep, u)
    (cflat, csid), ckeep = c._corpus_on_device()
    want = pw.pair_slots(cflat, csid, 5, b.cpu(), ckeep, u.cpu())
    assert int(got[2]) == int(want[2]) > 0
    for a, w in zip(got[:2], want[:2]):
        assert a.device == cuda and a.cpu().numpy().tobytes() == \
            w.numpy().tobytes()


@pytest.mark.cuda
def test_fused_steps_on_the_card_equal_the_cpu(cuda):
    g, c = _port_model(cuda), _port_model("cpu")
    g.fit()
    cent, ctx, n = g._device_pairs(np.random.default_rng(0))
    table = torch.from_numpy(g._neg_table_int)
    pool = table[torch.randint(0, len(table), (1 << 21,),
                               generator=torch.Generator().manual_seed(1))]
    s0, s1 = g.syn0.cpu(), g.syn1.cpu()
    tables = [(g.syn0, g.syn1), (s0.clone(), s1.clone())]
    for (t0, t1), dev in zip(tables, (cuda, "cpu")):
        pw.sgns_epoch(t0, t1, cent.to(dev), ctx.to(dev), n,
                      pw.pooled_negatives(pool.to(dev), 256, 5), 256, 0.025,
                      steps=8)
    for got, want, start in zip(tables[0], tables[1], (s0, s1)):
        assert _update_err(got.cpu(), want, start.numpy()) <= EPOCH_TOL


@pytest.mark.cuda
def test_cbow_fit_on_the_card_equals_the_cpu(cuda):
    g = _port_model(cuda, elementsLearningAlgorithm="cbow", epochs=2)
    c = _port_model("cpu", elementsLearningAlgorithm="cbow", epochs=2)
    s0, s1 = _state(np.random.default_rng(2), g.vocab.numWords(), 32)
    for m in (g, c):
        embeddings_from_numpy(m, dict(_vocab_state(g), syn0=s0, syn1=s1))
        m.fit()
    assert g.syn0.device == cuda
    assert _rel(g.syn0.cpu(), c.syn0) <= FIT_TOL
    assert _rel(g.syn1.cpu(), c.syn1) <= FIT_TOL
