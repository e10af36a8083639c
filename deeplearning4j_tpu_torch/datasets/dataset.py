"""DataSet: the features + labels (+ masks) minibatch container.

Copied from ``deeplearning4j_tpu/datasets/dataset.py`` (numpy only; the port
keeps its own copy). Arrays stay host-side numpy until a step moves them to
the network's device. ``MultiDataSet`` holds lists of them, for graphs
with several inputs or outputs.
"""

from __future__ import annotations

import numpy as np


def _np(x):
    if hasattr(x, "detach"):   # a torch tensor, on any device
        return x.detach().cpu().numpy()
    return np.asarray(x)


class DataSet:
    def __init__(self, features=None, labels=None, featuresMask=None,
                 labelsMask=None):
        self.features = _np(features) if features is not None else None
        self.labels = _np(labels) if labels is not None else None
        self.featuresMask = _np(featuresMask) if featuresMask is not None \
            else None
        self.labelsMask = _np(labelsMask) if labelsMask is not None else None

    # reference accessor names
    def getFeatures(self):
        return self.features

    def getLabels(self):
        return self.labels

    def getFeaturesMaskArray(self):
        return self.featuresMask

    def getLabelsMaskArray(self):
        return self.labelsMask

    def setFeatures(self, f):
        self.features = _np(f)

    def setLabels(self, l):
        self.labels = _np(l)

    def numExamples(self) -> int:
        return 0 if self.features is None else self.features.shape[0]

    def sample(self, n, rng=None) -> "DataSet":
        rng = rng or np.random.default_rng()
        idx = rng.choice(self.numExamples(), size=n, replace=False)
        return DataSet(self.features[idx],
                       None if self.labels is None else self.labels[idx])

    def splitTestAndTrain(self, fraction_or_n, rng=None):
        """fraction in (0,1) or absolute train count; returns SplitTestAndTrain
        with .train/.test (reference: DataSet.splitTestAndTrain)."""
        n = self.numExamples()
        n_train = int(fraction_or_n * n) if isinstance(
            fraction_or_n, float) and 0 < fraction_or_n < 1 \
            else int(fraction_or_n)
        train = DataSet(
            self.features[:n_train],
            None if self.labels is None else self.labels[:n_train])
        test = DataSet(
            self.features[n_train:],
            None if self.labels is None else self.labels[n_train:])
        return SplitTestAndTrain(train, test)

    def shuffle(self, seed=None):
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.numExamples())
        self.features = self.features[idx]
        if self.labels is not None:
            self.labels = self.labels[idx]
        if self.featuresMask is not None:
            self.featuresMask = self.featuresMask[idx]
        if self.labelsMask is not None:
            self.labelsMask = self.labelsMask[idx]

    def batchBy(self, batch_size) -> list:
        n = self.numExamples()
        return [DataSet(self.features[i:i + batch_size],
                        None if self.labels is None
                        else self.labels[i:i + batch_size])
                for i in range(0, n, batch_size)]

    def asList(self) -> list:
        return self.batchBy(1)

    @staticmethod
    def merge(datasets) -> "DataSet":
        return DataSet(
            np.concatenate([d.features for d in datasets]),
            np.concatenate([d.labels for d in datasets])
            if datasets[0].labels is not None else None)

    def save(self, path):
        # np.savez silently appends .npz; normalize so load(path) matches
        if not str(path).endswith(".npz"):
            path = str(path) + ".npz"
        np.savez(path, **{k: v for k, v in [
            ("features", self.features), ("labels", self.labels),
            ("featuresMask", self.featuresMask),
            ("labelsMask", self.labelsMask)] if v is not None})

    @staticmethod
    def load(path) -> "DataSet":
        if not str(path).endswith(".npz"):
            path = str(path) + ".npz"
        z = np.load(path)
        return DataSet(z.get("features"), z.get("labels"),
                       z.get("featuresMask"), z.get("labelsMask"))

    def __repr__(self):
        fs = None if self.features is None else self.features.shape
        ls = None if self.labels is None else self.labels.shape
        return f"DataSet(features={fs}, labels={ls})"


class SplitTestAndTrain:
    def __init__(self, train, test):
        self.train = train
        self.test = test

    def getTrain(self):
        return self.train

    def getTest(self):
        return self.test


class MultiDataSet:
    """Multi-input/multi-output container: lists of features, labels and
    their masks (one array is taken as a list of one)."""

    def __init__(self, features=None, labels=None, featuresMasks=None,
                 labelsMasks=None):
        as_list = lambda v: None if v is None else [  # noqa: E731
            _np(x) for x in (v if isinstance(v, (list, tuple)) else [v])]
        self.features = as_list(features) or []
        self.labels = as_list(labels) or []
        self.featuresMasks = as_list(featuresMasks)
        self.labelsMasks = as_list(labelsMasks)

    def getFeatures(self, i=None):
        return self.features if i is None else self.features[i]

    def getLabels(self, i=None):
        return self.labels if i is None else self.labels[i]

    def numFeatureArrays(self):
        return len(self.features)

    def numLabelsArrays(self):
        return len(self.labels)

    def numExamples(self):
        return 0 if not self.features else self.features[0].shape[0]
