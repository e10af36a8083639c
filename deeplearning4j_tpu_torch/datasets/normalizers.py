"""Data normalizers with fit/transform/revert + persistence.

Copied from ``deeplearning4j_tpu/datasets/normalizers.py`` (numpy only;
the port keeps its own copy): the same statistics, transforms and ``_state()``,
so a normalizer saved by either package loads in the other.

Reference capability: org.nd4j.linalg.dataset.api.preprocessor.
{NormalizerStandardize, NormalizerMinMaxScaler, ImagePreProcessingScaler}
(SURVEY.md §2.4 "Normalizers"): fitted on a DataSetIterator, applied as a
preProcessor on iterators, persisted alongside models (ModelSerializer
addNormalizerToModel capability)."""

from __future__ import annotations

import numpy as np


class Normalizer:
    def fit(self, data):
        """Accepts a DataSet or a DataSetIterator."""
        if hasattr(data, "reset"):
            data.reset()
            stats = None
            while data.hasNext():
                ds = data.next()
                stats = self._accumulate(stats, ds.getFeatures())
            self._finalize(stats)
            data.reset()
        else:
            f = data.getFeatures() if hasattr(data, "getFeatures") else data
            self._finalize(self._accumulate(None, np.asarray(f)))
        return self

    def preProcess(self, ds):
        ds.setFeatures(self.transform(ds.getFeatures()))

    def transform(self, features):
        raise NotImplementedError

    def revert(self, features):
        raise NotImplementedError

    # persistence
    def save(self, path):
        # np.savez silently appends .npz; normalize so load(path) matches
        if not str(path).endswith(".npz"):
            path = str(path) + ".npz"
        np.savez(path, __class__=type(self).__name__, **self._state())

    @staticmethod
    def load(path) -> "Normalizer":
        if not str(path).endswith(".npz"):
            path = str(path) + ".npz"
        z = np.load(path, allow_pickle=True)
        cls = {c.__name__: c for c in (NormalizerStandardize,
                                       NormalizerMinMaxScaler,
                                       ImagePreProcessingScaler)}[
            str(z["__class__"])]
        obj = cls.__new__(cls)
        obj._load_state(z)
        return obj


class NormalizerStandardize(Normalizer):
    """Per-feature (x - mean) / std via streaming sufficient statistics."""

    def __init__(self):
        self.mean = None
        self.std = None

    def _accumulate(self, stats, f):
        f = np.asarray(f, np.float64).reshape(f.shape[0], -1)
        if stats is None:
            stats = [0, np.zeros(f.shape[1]), np.zeros(f.shape[1])]
        stats[0] += f.shape[0]
        stats[1] += f.sum(axis=0)
        stats[2] += (f ** 2).sum(axis=0)
        return stats

    def _finalize(self, stats):
        n, s, s2 = stats
        self.mean = (s / n).astype(np.float32)
        var = np.maximum(s2 / n - (s / n) ** 2, 0.0)
        self.std = np.sqrt(var).astype(np.float32)
        self.std[self.std < 1e-8] = 1.0

    def transform(self, f):
        shape = f.shape
        f2 = np.asarray(f, np.float32).reshape(shape[0], -1)
        return ((f2 - self.mean) / self.std).reshape(shape)

    def revert(self, f):
        shape = f.shape
        f2 = np.asarray(f, np.float32).reshape(shape[0], -1)
        return (f2 * self.std + self.mean).reshape(shape)

    def _state(self):
        return {"mean": self.mean, "std": self.std}

    def _load_state(self, z):
        self.mean = z["mean"]
        self.std = z["std"]


class NormalizerMinMaxScaler(Normalizer):
    def __init__(self, minRange=0.0, maxRange=1.0):
        self.minRange = minRange
        self.maxRange = maxRange
        self.dataMin = None
        self.dataMax = None

    def _accumulate(self, stats, f):
        f = np.asarray(f, np.float64).reshape(f.shape[0], -1)
        lo, hi = f.min(axis=0), f.max(axis=0)
        if stats is None:
            return [lo, hi]
        return [np.minimum(stats[0], lo), np.maximum(stats[1], hi)]

    def _finalize(self, stats):
        self.dataMin = stats[0].astype(np.float32)
        self.dataMax = stats[1].astype(np.float32)

    def transform(self, f):
        shape = f.shape
        f2 = np.asarray(f, np.float32).reshape(shape[0], -1)
        rng = np.maximum(self.dataMax - self.dataMin, 1e-8)
        y = (f2 - self.dataMin) / rng
        y = y * (self.maxRange - self.minRange) + self.minRange
        return y.reshape(shape)

    def revert(self, f):
        shape = f.shape
        f2 = np.asarray(f, np.float32).reshape(shape[0], -1)
        rng = np.maximum(self.dataMax - self.dataMin, 1e-8)
        y = (f2 - self.minRange) / (self.maxRange - self.minRange)
        return (y * rng + self.dataMin).reshape(shape)

    def _state(self):
        return {"dataMin": self.dataMin, "dataMax": self.dataMax,
                "minRange": self.minRange, "maxRange": self.maxRange}

    def _load_state(self, z):
        self.dataMin = z["dataMin"]
        self.dataMax = z["dataMax"]
        self.minRange = float(z["minRange"])
        self.maxRange = float(z["maxRange"])


class ImagePreProcessingScaler(Normalizer):
    """Pixel scaling [0,255] -> [minRange,maxRange] (no fit needed)."""

    def __init__(self, minRange=0.0, maxRange=1.0, maxPixelVal=255.0):
        self.minRange = minRange
        self.maxRange = maxRange
        self.maxPixelVal = maxPixelVal

    def fit(self, data):
        return self

    def transform(self, f):
        f = np.asarray(f, np.float32)
        return (f / self.maxPixelVal) * (self.maxRange - self.minRange) \
            + self.minRange

    def revert(self, f):
        f = np.asarray(f, np.float32)
        return (f - self.minRange) / (self.maxRange - self.minRange) \
            * self.maxPixelVal

    def _state(self):
        return {"minRange": self.minRange, "maxRange": self.maxRange,
                "maxPixelVal": self.maxPixelVal}

    def _load_state(self, z):
        self.minRange = float(z["minRange"])
        self.maxRange = float(z["maxRange"])
        self.maxPixelVal = float(z["maxPixelVal"])
