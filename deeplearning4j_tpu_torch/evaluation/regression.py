"""Regression evaluation.

Counterpart of ``deeplearning4j_tpu/evaluation/regression.py``, whose
numpy code it copies (reference: org.nd4j.evaluation.regression.
RegressionEvaluation): per-column MSE/MAE/RMSE/RSE/PC/R2 accumulated
across eval() calls via sufficient statistics (float64). Inputs are read
to the host by ``classification._to_np``, which upcasts sub-fp32 floats
before the per-batch sums.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.evaluation.classification import _to_np


class RegressionEvaluation:
    def __init__(self, nColumns=None, columnNames=None):
        self.columnNames = columnNames
        self._n = 0
        self._sum_err2 = None   # sum (p-l)^2
        self._sum_abs = None    # sum |p-l|
        self._sum_l = None
        self._sum_l2 = None
        self._sum_p = None
        self._sum_p2 = None
        self._sum_lp = None

    def eval(self, labels, predictions, mask=None):
        l = _to_np(labels)
        p = _to_np(predictions)
        if l.ndim == 3:
            # [N, C, T] (NCW layout) -> fold time into batch, C columns
            l = np.moveaxis(l, 2, 1).reshape(-1, l.shape[1])
            p = np.moveaxis(p, 2, 1).reshape(-1, p.shape[1])
        else:
            l = l.reshape(-1, l.shape[-1])
            p = p.reshape(-1, p.shape[-1])
        if self._sum_err2 is None:
            k = l.shape[1]
            for name in ("_sum_err2", "_sum_abs", "_sum_l", "_sum_l2",
                         "_sum_p", "_sum_p2", "_sum_lp"):
                setattr(self, name, np.zeros(k))
        self._n += l.shape[0]
        self._sum_err2 += ((p - l) ** 2).sum(axis=0)
        self._sum_abs += np.abs(p - l).sum(axis=0)
        self._sum_l += l.sum(axis=0)
        self._sum_l2 += (l ** 2).sum(axis=0)
        self._sum_p += p.sum(axis=0)
        self._sum_p2 += (p ** 2).sum(axis=0)
        self._sum_lp += (l * p).sum(axis=0)
        return self

    def meanSquaredError(self, col=0):
        return float(self._sum_err2[col] / self._n)

    def meanAbsoluteError(self, col=0):
        return float(self._sum_abs[col] / self._n)

    def rootMeanSquaredError(self, col=0):
        return float(np.sqrt(self._sum_err2[col] / self._n))

    def relativeSquaredError(self, col=0):
        ss_tot = self._sum_l2[col] - self._sum_l[col] ** 2 / self._n
        return float(self._sum_err2[col] / ss_tot) if ss_tot else 0.0

    def pearsonCorrelation(self, col=0):
        n = self._n
        cov = self._sum_lp[col] - self._sum_l[col] * self._sum_p[col] / n
        vl = self._sum_l2[col] - self._sum_l[col] ** 2 / n
        vp = self._sum_p2[col] - self._sum_p[col] ** 2 / n
        d = np.sqrt(vl * vp)
        return float(cov / d) if d else 0.0

    def rSquared(self, col=0):
        return 1.0 - self.relativeSquaredError(col)

    def averageMeanSquaredError(self):
        return float((self._sum_err2 / self._n).mean())

    def averagerootMeanSquaredError(self):
        return float(np.sqrt(self._sum_err2 / self._n).mean())

    def averageMeanAbsoluteError(self):
        return float((self._sum_abs / self._n).mean())

    def stats(self):
        k = len(self._sum_err2)
        names = self.columnNames or [f"col_{i}" for i in range(k)]
        lines = ["Column    MSE        MAE        RMSE       RSE        R^2"]
        for i in range(k):
            lines.append(
                f"{names[i]:<9} {self.meanSquaredError(i):<10.5f} "
                f"{self.meanAbsoluteError(i):<10.5f} "
                f"{self.rootMeanSquaredError(i):<10.5f} "
                f"{self.relativeSquaredError(i):<10.5f} "
                f"{self.rSquared(i):.5f}")
        return "\n".join(lines)
