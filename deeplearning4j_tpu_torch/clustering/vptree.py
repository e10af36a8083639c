"""VP-tree exact nearest-neighbor search.

Reference capability: deeplearning4j-nearestneighbors
org.deeplearning4j.clustering.vptree.VPTree (SURVEY.md §2.7): vantage-point
tree over a point set with euclidean/cosine distance; search(k) returns the
k nearest. Host-side recursive structure (tree search is pointer-chasing,
not MXU work); distance batches use numpy vectorization.

Copied from ``deeplearning4j_tpu/clustering/vptree.py`` (numpy only; the
port keeps its own copy): the same tree for the same seed and the same
answers, bit for bit."""

from __future__ import annotations

import numpy as np


class _Node:
    __slots__ = ("index", "radius", "inside", "outside")

    def __init__(self, index):
        self.index = index
        self.radius = 0.0
        self.inside = None
        self.outside = None


class VPTree:
    def __init__(self, points, distance="euclidean", seed=0):
        self.points = np.asarray(points, np.float64)
        self.distance = distance
        if distance == "cosine":
            norms = np.linalg.norm(self.points, axis=1, keepdims=True)
            self._unit = self.points / np.maximum(norms, 1e-12)
        rng = np.random.default_rng(seed)
        self.root = self._build(list(range(len(self.points))), rng)

    def _dist_many(self, idx, others):
        if self.distance == "cosine":
            return 1.0 - self._unit[others] @ self._unit[idx]
        diff = self.points[others] - self.points[idx]
        return np.sqrt(np.sum(diff * diff, axis=1))

    def _dist_point(self, q, others):
        if self.distance == "cosine":
            qn = q / max(np.linalg.norm(q), 1e-12)
            return 1.0 - self._unit[others] @ qn
        diff = self.points[others] - q
        return np.sqrt(np.sum(diff * diff, axis=1))

    def _build(self, indices, rng):
        if not indices:
            return None
        vp = indices[rng.integers(len(indices))]
        rest = [i for i in indices if i != vp]
        node = _Node(vp)
        if not rest:
            return node
        d = self._dist_many(vp, rest)
        node.radius = float(np.median(d))
        inside = [rest[i] for i in range(len(rest))
                  if d[i] <= node.radius]
        outside = [rest[i] for i in range(len(rest))
                   if d[i] > node.radius]
        node.inside = self._build(inside, rng)
        node.outside = self._build(outside, rng)
        return node

    def search(self, query, k):
        """Returns (indices, distances) of the k nearest points."""
        q = np.asarray(query, np.float64)
        best: list[tuple[float, int]] = []  # sorted (dist, idx), len<=k

        def visit(node):
            if node is None:
                return
            d = float(self._dist_point(q, [node.index])[0])
            if len(best) < k:
                best.append((d, node.index))
                best.sort()
            elif d < best[-1][0]:
                best[-1] = (d, node.index)
                best.sort()
            tau = best[-1][0] if len(best) == k else np.inf
            if d <= node.radius:
                visit(node.inside)
                if d + tau > node.radius:
                    visit(node.outside)
            else:
                visit(node.outside)
                if d - tau <= node.radius:
                    visit(node.inside)

        visit(self.root)
        idxs = [i for _, i in best]
        dists = [d for d, _ in best]
        return idxs, dists
