"""DeepWalk graph embeddings.

Counterpart of ``deeplearning4j_tpu/graph/deepwalk.py``: the same graph,
the same numpy random walks (bit for bit), embedded by the port's
Word2Vec on ``fit``'s device (the card unless the CPU is named).

Reference capability: deeplearning4j-graph org.deeplearning4j.graph.models
.deepwalk.DeepWalk (SURVEY.md §2.7): uniform random walks over a graph,
embedded by skip-gram. Walk generation is host-side; the skip-gram step is
the same batched device op as Word2Vec (the reference instead runs its own
hierarchical-softmax loop)."""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.nlp.tokenization import (
    CollectionSentenceIterator)
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec


class Graph:
    """Simple undirected/directed graph keyed by int vertex ids
    (reference: org.deeplearning4j.graph.graph.Graph)."""

    def __init__(self, numVertices, directed=False):
        self.n = int(numVertices)
        self.directed = directed
        self.adj: list[list[int]] = [[] for _ in range(self.n)]

    def addEdge(self, a, b):
        self.adj[a].append(b)
        if not self.directed:
            self.adj[b].append(a)

    def getConnectedVertices(self, v):
        return list(self.adj[v])

    def numVertices(self):
        return self.n


class RandomWalkIterator:
    """Uniform random walks of fixed length from every vertex
    (reference: org.deeplearning4j.graph.iterator.RandomWalkIterator)."""

    def __init__(self, graph: Graph, walkLength: int, seed=0,
                 walksPerVertex: int = 1):
        self.graph = graph
        self.walkLength = walkLength
        self.seed = seed
        self.walksPerVertex = walksPerVertex

    def walks(self):
        rng = np.random.default_rng(self.seed)
        for _ in range(self.walksPerVertex):
            for start in range(self.graph.n):
                walk = [start]
                cur = start
                for _ in range(self.walkLength - 1):
                    nbrs = self.graph.adj[cur]
                    if not nbrs:
                        break
                    cur = int(nbrs[rng.integers(len(nbrs))])
                    walk.append(cur)
                yield walk


class DeepWalk:
    class Builder:
        def __init__(self):
            self._kw = dict(vectorSize=64, windowSize=4, learningRate=0.01,
                            seed=0, epochs=3, negative=5, batchSize=128)
            self._walk_len = 20
            self._walks_per_vertex = 4

        def vectorSize(self, n):
            self._kw["vectorSize"] = n
            return self

        def windowSize(self, n):
            self._kw["windowSize"] = n
            return self

        def learningRate(self, lr):
            self._kw["learningRate"] = lr
            return self

        def seed(self, s):
            self._kw["seed"] = s
            return self

        def epochs(self, n):
            self._kw["epochs"] = n
            return self

        def walkLength(self, n):
            self._walk_len = n
            return self

        def walksPerVertex(self, n):
            self._walks_per_vertex = n
            return self

        def build(self):
            dw = DeepWalk()
            dw.cfg = dict(self._kw)
            dw.walk_len = self._walk_len
            dw.walks_per_vertex = self._walks_per_vertex
            return dw

    def __init__(self):
        self.cfg = {}
        self.walk_len = 20
        self.walks_per_vertex = 4
        self._w2v: Word2Vec | None = None

    def fit(self, graph: Graph, device=None):
        it = RandomWalkIterator(graph, self.walk_len, self.cfg["seed"],
                                self.walks_per_vertex)
        sentences = [" ".join(str(v) for v in walk) for walk in it.walks()]
        self._w2v = (Word2Vec.Builder()
                     .minWordFrequency(1)
                     .layerSize(self.cfg["vectorSize"])
                     .windowSize(self.cfg["windowSize"])
                     .learningRate(self.cfg["learningRate"])
                     .negativeSampling(self.cfg["negative"])
                     .epochs(self.cfg["epochs"])
                     .seed(self.cfg["seed"])
                     .batchSize(self.cfg["batchSize"])
                     .sampling(0)
                     .iterate(CollectionSentenceIterator(sentences))
                     .build(device).fit())
        return self

    def getVertexVector(self, v) -> np.ndarray:
        return self._w2v.getWordVector(str(v))

    def similarity(self, a, b) -> float:
        return self._w2v.similarity(str(a), str(b))

    def verticesNearest(self, v, n=5):
        return [int(w) for w in self._w2v.wordsNearest(str(v), n)]
