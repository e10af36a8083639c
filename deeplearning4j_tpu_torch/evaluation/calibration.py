"""Probability-calibration evaluation.

Counterpart of ``deeplearning4j_tpu/evaluation/calibration.py``, whose
numpy code it copies (reference capability:
org.deeplearning4j.eval.EvaluationCalibration): reliability diagrams (mean
predicted probability vs observed positive fraction per bin), residual
plots and probability histograms over network outputs. Accumulation is
streaming numpy (eval per batch, merge-able), like the other evaluation
classes; inputs are read to the host by ``classification._to_np``.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.evaluation.classification import _to_np


class ReliabilityDiagram:
    def __init__(self, mean_predicted, frac_positives, counts):
        self.meanPredictedValueX = np.asarray(mean_predicted)
        self.fractionPositivesY = np.asarray(frac_positives)
        self.binCounts = np.asarray(counts)

    def getMeanPredictedValueX(self):
        return self.meanPredictedValueX

    def getFractionPositivesY(self):
        return self.fractionPositivesY


class EvaluationCalibration:
    def __init__(self, reliabilityDiagNumBins=10, histogramNumBins=50):
        self.rBins = int(reliabilityDiagNumBins)
        self.hBins = int(histogramNumBins)
        self._num_classes = None
        # per class, per reliability bin: sum(p), count, positives
        self._sum_p = None
        self._count = None
        self._pos = None
        self._prob_hist = None       # all predicted probabilities
        self._label_hist = None      # probabilities of the true class
        self._residual_hist = None   # |label - p|

    def _ensure(self, n_classes):
        if self._num_classes is None:
            self._num_classes = n_classes
            self._sum_p = np.zeros((n_classes, self.rBins))
            self._count = np.zeros((n_classes, self.rBins), np.int64)
            self._pos = np.zeros((n_classes, self.rBins), np.int64)
            self._prob_hist = np.zeros(self.hBins, np.int64)
            self._label_hist = np.zeros(self.hBins, np.int64)
            self._residual_hist = np.zeros(self.hBins, np.int64)
        elif self._num_classes != n_classes:
            raise ValueError(
                f"class count changed: {self._num_classes} -> {n_classes}")

    def eval(self, labels, predictions, mask=None):
        """labels: one-hot [N, C]; predictions: probabilities [N, C];
        mask: optional per-example [N] (0 = exclude, the padded-batch
        convention shared with the other evaluators)."""
        labels = np.asarray(_to_np(labels), np.float64)
        p = np.asarray(_to_np(predictions), np.float64)
        if labels.shape != p.shape or labels.ndim != 2:
            raise ValueError(f"shapes must match and be 2-D, got "
                             f"{labels.shape} vs {p.shape}")
        if mask is not None:
            keep = _to_np(mask).reshape(-1) > 0
            labels, p = labels[keep], p[keep]
        n, c = p.shape
        self._ensure(c)
        bins = np.clip((p * self.rBins).astype(np.int64), 0, self.rBins - 1)
        is_pos = labels > 0.5
        # one scatter per accumulator over the flattened (class, bin)
        # index — no per-class Python loop
        flat = (np.arange(c)[None, :] * self.rBins + bins).ravel()
        np.add.at(self._sum_p.reshape(-1), flat, p.ravel())
        np.add.at(self._count.reshape(-1), flat, 1)
        np.add.at(self._pos.reshape(-1), flat,
                  is_pos.astype(np.int64).ravel())
        hb = np.clip((p * self.hBins).astype(np.int64), 0, self.hBins - 1)
        np.add.at(self._prob_hist, hb.ravel(), 1)
        true_p = p[is_pos]
        np.add.at(self._label_hist,
                  np.clip((true_p * self.hBins).astype(np.int64), 0,
                          self.hBins - 1), 1)
        resid = np.abs(labels - p)
        np.add.at(self._residual_hist,
                  np.clip((resid * self.hBins).astype(np.int64), 0,
                          self.hBins - 1).ravel(), 1)
        return self

    def merge(self, other: "EvaluationCalibration"):
        if other._num_classes is None:
            return self
        if (self.rBins, self.hBins) != (other.rBins, other.hBins):
            raise ValueError(
                f"bin configuration mismatch: ({self.rBins}, {self.hBins})"
                f" vs ({other.rBins}, {other.hBins})")
        self._ensure(other._num_classes)
        self._sum_p += other._sum_p
        self._count += other._count
        self._pos += other._pos
        self._prob_hist += other._prob_hist
        self._label_hist += other._label_hist
        self._residual_hist += other._residual_hist
        return self

    def getReliabilityDiagram(self, classIdx) -> ReliabilityDiagram:
        if self._num_classes is None:
            raise ValueError("no data evaluated")
        cnt = self._count[classIdx]
        nz = cnt > 0
        mean_p = np.zeros(self.rBins)
        frac = np.zeros(self.rBins)
        mean_p[nz] = self._sum_p[classIdx][nz] / cnt[nz]
        frac[nz] = self._pos[classIdx][nz] / cnt[nz]
        return ReliabilityDiagram(mean_p[nz], frac[nz], cnt[nz])

    def expectedCalibrationError(self, classIdx=None) -> float:
        """ECE = sum_b (n_b/N) |acc_b - conf_b| (macro-averaged over
        classes when classIdx is None)."""
        if self._num_classes is None:
            raise ValueError("no data evaluated")
        idxs = ([classIdx] if classIdx is not None
                else range(self._num_classes))
        eces = []
        for ci in idxs:
            cnt = self._count[ci]
            total = cnt.sum()
            if total == 0:
                continue
            nz = cnt > 0
            conf = self._sum_p[ci][nz] / cnt[nz]
            acc = self._pos[ci][nz] / cnt[nz]
            eces.append(float(np.sum(cnt[nz] / total * np.abs(acc - conf))))
        return float(np.mean(eces)) if eces else 0.0

    def getProbabilityHistogramAllClasses(self):
        return np.asarray(self._prob_hist)

    def getProbabilityHistogram(self):
        """Histogram of predicted probability for the TRUE class."""
        return np.asarray(self._label_hist)

    def getResidualPlotAllClasses(self):
        return np.asarray(self._residual_hist)

    def stats(self) -> str:
        return (f"EvaluationCalibration(classes={self._num_classes}, "
                f"ECE={self.expectedCalibrationError():.4f})")
