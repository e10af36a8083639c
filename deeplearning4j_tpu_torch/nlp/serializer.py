"""Word-vector persistence.

Counterpart of ``deeplearning4j_tpu/nlp/serializer.py``: the same text and
binary formats, byte for byte, so a file written by either package reads
in the other. The readers take ``device=None`` (the card unless the CPU
is named) and put the vectors there.

Reference capability: org.deeplearning4j.models.embeddings.loader
.WordVectorSerializer (SURVEY.md §2.7): the word2vec text format
(header 'V D', then 'word v1 v2 ...' per line) readable by the original
word2vec tooling and gensim."""

from __future__ import annotations

import numpy as np
import torch


def _model_from_vectors(words, mat, device=None):
    """Assemble a query-ready Word2Vec around loaded vectors on ``device``
    (placeholder training hyperparameters; both the text and binary
    readers use this)."""
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

    model = Word2Vec(None, None, device=device, minWordFrequency=1,
                     layerSize=mat.shape[1], windowSize=5, negative=5,
                     learningRate=0.025, epochs=1, iterations=1, seed=0,
                     batchSize=1024, sampling=0, algorithm="skipgram")
    for w in words:
        model.vocab.add(w, 1)
    model.syn0 = torch.from_numpy(mat).to(model.device)
    model.syn1 = torch.zeros_like(model.syn0)
    return model


class WordVectorSerializer:
    @staticmethod
    def writeWord2VecModel(model, path):
        m = model.getWordVectorMatrix()
        with open(path, "w") as f:
            f.write(f"{m.shape[0]} {m.shape[1]}\n")
            for i in range(m.shape[0]):
                word = model.vocab.wordAtIndex(i)
                # Python floats (exact copies of the float32 values)
                # format to the same text as numpy's scalars, faster
                vec = " ".join(f"{x:.6f}" for x in m[i].tolist())
                f.write(f"{word} {vec}\n")

    @staticmethod
    def readWord2VecModel(path, device=None):
        with open(path, encoding="utf-8") as f:
            header = f.readline().split()
            v, d = int(header[0]), int(header[1])
            mat = np.zeros((v, d), np.float32)
            words = []
            for i in range(v):
                parts = f.readline().rstrip("\n").split(" ")
                words.append(parts[0])
                mat[i] = [float(x) for x in parts[1:d + 1]]
        return _model_from_vectors(words, mat, device)

    # -- Google word2vec BINARY format (reference: WordVectorSerializer
    # readBinaryModel/writeWordVectors(binary=true) — '<V> <D>\n' header
    # then per word: 'word ' + D little-endian float32 + '\n') -----------
    @staticmethod
    def writeWord2VecBinary(model, path):
        m = np.asarray(model.getWordVectorMatrix(), np.float32)
        with open(path, "wb") as f:
            f.write(f"{m.shape[0]} {m.shape[1]}\n".encode())
            for i in range(m.shape[0]):
                word = model.vocab.wordAtIndex(i)
                f.write(word.encode("utf-8") + b" ")
                f.write(m[i].astype("<f4").tobytes())
                f.write(b"\n")

    @staticmethod
    def readWord2VecBinary(path, device=None):
        with open(path, "rb") as f:
            header = f.readline().split()
            v, d = int(header[0]), int(header[1])
            mat = np.zeros((v, d), np.float32)
            words = []
            for i in range(v):
                word = bytearray()
                while True:
                    ch = f.read(1)
                    if not ch or ch == b" ":
                        break
                    word.extend(ch)
                mat[i] = np.frombuffer(f.read(4 * d), "<f4")
                nl = f.read(1)           # trailing newline
                if nl not in (b"\n", b""):
                    f.seek(-1, 1)        # some writers omit it
                words.append(word.decode("utf-8"))
        return _model_from_vectors(words, mat, device)

    @staticmethod
    def loadStaticModel(path, device=None):
        """Auto-detect text vs binary word2vec files (reference:
        WordVectorSerializer.loadStaticModel). Text is tried FIRST and
        fully parsed — a valid text model always succeeds, while binary
        payloads fail the utf-8 decode or the float parse and fall
        through; a byte-window probe would misroute text files whose
        window cuts a multibyte character."""
        try:
            return WordVectorSerializer.readWord2VecModel(path, device)
        except (UnicodeDecodeError, ValueError, IndexError):
            return WordVectorSerializer.readWord2VecBinary(path, device)
