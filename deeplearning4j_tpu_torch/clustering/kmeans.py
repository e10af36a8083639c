"""K-means clustering on the device.

Counterpart of ``deeplearning4j_tpu/clustering/kmeans.py``: the first
centers are the same numpy draw (``default_rng(seed).choice``); each
Lloyd step (``lloyd_step``) assigns by one argmin over the distance matrix
and moves each center to its points' mean, an empty cluster's center
staying where it was; the loop stops when the new centers are within
``allclose(atol=1e-6)`` of the old (one host read a step, as in the
reference). ``applyTo`` returns numpy assignments and keeps numpy
``centers``.

Reference capability: deeplearning4j-nearestneighbors-parent's
org.deeplearning4j.clustering.kmeans.KMeansClustering (SURVEY.md §2.7)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.backend import resolve_device


def lloyd_step(x, centers):
    """(new centers, assignments) of one Lloyd step."""
    d = (torch.sum(x * x, 1)[:, None] - 2 * x @ centers.T
         + torch.sum(centers * centers, 1)[None])
    assign = torch.argmin(d, dim=1)
    one_hot = F.one_hot(assign, centers.shape[0]).to(x.dtype)
    members = one_hot.sum(0)
    new_centers = (one_hot.T @ x) / torch.clamp(members, min=1.0)[:, None]
    # keep empty clusters where they were
    return torch.where((members == 0)[:, None], centers, new_centers), \
        assign


class KMeansClustering:
    def __init__(self, k, maxIterations=100, distance="euclidean", seed=0,
                 device=None):
        self.device = resolve_device(device)
        self.k = int(k)
        self.maxIterations = maxIterations
        self.seed = seed
        self.centers = None

    @staticmethod
    def setup(k, maxIterations=100, distanceFunction="euclidean", seed=0,
              device=None):
        return KMeansClustering(k, maxIterations, distanceFunction, seed,
                                device=device)

    def applyTo(self, points):
        x = torch.from_numpy(np.asarray(points, np.float32)).to(self.device)
        n = x.shape[0]
        rng = np.random.default_rng(self.seed)
        centers = x[torch.from_numpy(rng.choice(n, self.k, replace=False))
                    .to(self.device)]
        assign = None
        for _ in range(self.maxIterations):
            new_centers, assign = lloyd_step(x, centers)
            done = torch.allclose(new_centers, centers, atol=1e-6)
            centers = new_centers
            if done:
                break
        self.centers = centers.cpu().numpy()
        return assign.to(torch.int32).cpu().numpy()   # int32, as the reference returns
