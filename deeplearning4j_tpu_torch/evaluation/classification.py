"""Classification evaluation.

Counterpart of ``deeplearning4j_tpu/evaluation/classification.py``, whose
numpy code it copies (reference capability:
org.nd4j.evaluation.classification.{Evaluation, EvaluationBinary, ROC,
ROCMultiClass}). Accumulation is a confusion-matrix merge per
eval(labels, predictions) call on the host; the stats() report is
host-side formatting. Every method takes numpy, a torch tensor on any
device or the port's ``INDArray``, and gives the JAX package's numbers
bit for bit on the same numpy inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.ndarray import INDArray


def _to_np(x):
    """``x`` as a host numpy array: an ``INDArray`` through ``toNumpy()``,
    a tensor detached and copied to the host. Floats narrower than 32 bits
    (bfloat16, float16) are upcast to float32 BEFORE any accumulation, as
    in the JAX package: ROC cumsums and binary-count sums lose counts past
    the narrow mantissa on long iterators."""
    if isinstance(x, INDArray):
        a = x.toNumpy()
    elif isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.is_floating_point() and t.element_size() < 4:
            t = t.float()
        a = t.numpy()
    elif hasattr(x, "numpy"):
        a = np.asarray(x.numpy())
    else:
        a = np.asarray(x)
    # numpy float16 (kind 'f') and ml_dtypes' bfloat16 (kind 'V')
    if a.dtype.itemsize < 4 and a.dtype.kind in ("f", "V"):
        a = a.astype(np.float32)
    return a


def _class_indices(arr):
    a = _to_np(arr)
    if a.ndim >= 2 and a.shape[-1] > 1:
        return np.argmax(a, axis=-1).reshape(-1)
    return a.reshape(-1).astype(np.int64)


class Evaluation:
    """Multiclass accuracy/precision/recall/F1 + confusion matrix."""

    def __init__(self, numClasses=None, labelsList=None):
        self.numClasses = numClasses
        self.labelsList = labelsList
        self._conf = None if numClasses is None else np.zeros(
            (numClasses, numClasses), np.int64)

    # -- accumulation --------------------------------------------------------
    def eval(self, labels, predictions, mask=None):
        labels = _to_np(labels)
        predictions = _to_np(predictions)
        if labels.ndim == 3:
            # [N, C, T] time series -> fold time into batch
            labels = np.moveaxis(labels, 2, 1).reshape(-1, labels.shape[1])
            predictions = np.moveaxis(predictions, 2, 1).reshape(
                -1, predictions.shape[1])
        t = _class_indices(labels)
        p = _class_indices(predictions)
        if mask is not None:
            m = _to_np(mask).reshape(-1).astype(bool)
            t, p = t[m], p[m]
        # grow past a fixed numClasses too: an out-of-range class index
        # must widen the matrix, not crash np.add.at with an IndexError
        n = max(self.numClasses or 0,
                int(max(t.max(initial=0), p.max(initial=0))) + 1)
        if self._conf is None or n > self._conf.shape[0]:
            conf = np.zeros((n, n), np.int64)
            if self._conf is not None:
                conf[: self._conf.shape[0], : self._conf.shape[1]] = self._conf
            self._conf = conf
            self.numClasses = n
        np.add.at(self._conf, (t, p), 1)
        return self

    # -- metrics -------------------------------------------------------------
    def _require(self):
        if self._conf is None:
            raise ValueError("no data accumulated; call eval() first")
        return self._conf

    def accuracy(self):
        c = self._require()
        tot = c.sum()
        return float(np.trace(c) / tot) if tot else 0.0

    def _tp(self):
        return np.diag(self._require()).astype(np.float64)

    def precision(self, cls=None):
        c = self._require()
        col = c.sum(axis=0).astype(np.float64)
        per = np.divide(self._tp(), col, out=np.zeros_like(col),
                        where=col > 0)
        return float(per[cls]) if cls is not None else float(
            per[col > 0].mean() if (col > 0).any() else 0.0)

    def recall(self, cls=None):
        c = self._require()
        row = c.sum(axis=1).astype(np.float64)
        per = np.divide(self._tp(), row, out=np.zeros_like(row),
                        where=row > 0)
        return float(per[cls]) if cls is not None else float(
            per[row > 0].mean() if (row > 0).any() else 0.0)

    def f1(self, cls=None):
        p = self.precision(cls)
        r = self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) > 0 else 0.0

    def falsePositiveRate(self, cls):
        c = self._require()
        fp = c[:, cls].sum() - c[cls, cls]
        tn = c.sum() - c[cls, :].sum() - c[:, cls].sum() + c[cls, cls]
        return float(fp / (fp + tn)) if (fp + tn) else 0.0

    def confusionMatrix(self):
        return self._require().copy()

    def getNumRowCounter(self):
        return int(self._require().sum())

    def stats(self) -> str:
        c = self._require()
        n = c.shape[0]
        names = list(self.labelsList or [])
        # the matrix may have grown past the provided labels list (an
        # out-of-range class index widens it); pad names to match
        names += [str(i) for i in range(len(names), n)]
        lines = [
            "========================Evaluation Metrics========================",
            f" # of classes:    {n}",
            f" Accuracy:        {self.accuracy():.4f}",
            f" Precision:       {self.precision():.4f}",
            f" Recall:          {self.recall():.4f}",
            f" F1 Score:        {self.f1():.4f}",
            "",
            "=========================Confusion Matrix=========================",
        ]
        width = max(len(nm) for nm in names) + 2
        header = " " * width + " ".join(f"{i:>6d}" for i in range(n))
        lines.append(header)
        for i in range(n):
            row = " ".join(f"{c[i, j]:>6d}" for j in range(n))
            lines.append(f"{names[i]:<{width}}{row}")
        return "\n".join(lines)

    def __str__(self):
        return self.stats()


class EvaluationBinary:
    """Per-output independent binary evaluation (sigmoid outputs)."""

    def __init__(self, nOutputs=None, threshold=0.5):
        self.threshold = threshold
        self._tp = self._fp = self._tn = self._fn = None

    def eval(self, labels, predictions, mask=None):
        t = _to_np(labels)
        p = (_to_np(predictions) >= self.threshold).astype(np.int64)
        t = (t >= 0.5).astype(np.int64)
        if self._tp is None:
            k = t.shape[-1]
            self._tp = np.zeros(k, np.int64)
            self._fp = np.zeros(k, np.int64)
            self._tn = np.zeros(k, np.int64)
            self._fn = np.zeros(k, np.int64)
        self._tp += ((p == 1) & (t == 1)).sum(axis=0)
        self._fp += ((p == 1) & (t == 0)).sum(axis=0)
        self._tn += ((p == 0) & (t == 0)).sum(axis=0)
        self._fn += ((p == 0) & (t == 1)).sum(axis=0)
        return self

    def accuracy(self, i):
        tot = self._tp[i] + self._fp[i] + self._tn[i] + self._fn[i]
        return float((self._tp[i] + self._tn[i]) / tot) if tot else 0.0

    def precision(self, i):
        d = self._tp[i] + self._fp[i]
        return float(self._tp[i] / d) if d else 0.0

    def recall(self, i):
        d = self._tp[i] + self._fn[i]
        return float(self._tp[i] / d) if d else 0.0

    def f1(self, i):
        p, r = self.precision(i), self.recall(i)
        return 2 * p * r / (p + r) if (p + r) > 0 else 0.0

    def stats(self):
        k = len(self._tp)
        lines = ["Label  Acc     Precision  Recall   F1"]
        for i in range(k):
            lines.append(f"{i:<6d} {self.accuracy(i):<7.4f} "
                         f"{self.precision(i):<10.4f} {self.recall(i):<8.4f} "
                         f"{self.f1(i):.4f}")
        return "\n".join(lines)


class ROC:
    """Binary ROC / AUC / AUPRC with exact thresholding (thresholdSteps=0
    semantics of the reference: every distinct score is a threshold)."""

    def __init__(self, thresholdSteps=0):
        self.thresholdSteps = thresholdSteps
        self._scores = []
        self._labels = []

    def eval(self, labels, predictions, mask=None):
        lab = _to_np(labels)
        pred = _to_np(predictions)
        if lab.ndim >= 2 and lab.shape[-1] == 2:
            lab = lab[..., 1]
            pred = pred[..., 1]
        self._labels.append(lab.reshape(-1))
        self._scores.append(pred.reshape(-1))
        return self

    def _collect(self):
        y = np.concatenate(self._labels)
        s = np.concatenate(self._scores)
        return y, s

    def calculateAUC(self):
        y, s = self._collect()
        order = np.argsort(-s, kind="stable")
        y = y[order]
        tps = np.cumsum(y)
        fps = np.cumsum(1 - y)
        P, N = tps[-1], fps[-1]
        if P == 0 or N == 0:
            return 0.0
        tpr = np.concatenate([[0], tps / P])
        fpr = np.concatenate([[0], fps / N])
        return float(np.trapezoid(tpr, fpr))

    def calculateAUCPR(self):
        y, s = self._collect()
        order = np.argsort(-s, kind="stable")
        y = y[order]
        tps = np.cumsum(y)
        P = tps[-1]
        if P == 0:
            return 0.0
        prec = tps / np.arange(1, len(y) + 1)
        rec = tps / P
        return float(np.trapezoid(prec, rec))


class ROCMultiClass:
    def __init__(self, thresholdSteps=0):
        self._rocs: dict[int, ROC] = {}

    def eval(self, labels, predictions, mask=None):
        lab = _to_np(labels)
        pred = _to_np(predictions)
        for c in range(lab.shape[-1]):
            self._rocs.setdefault(c, ROC()).eval(lab[..., c], pred[..., c])
        return self

    def calculateAUC(self, cls):
        return self._rocs[cls].calculateAUC()

    def calculateAverageAUC(self):
        return float(np.mean([r.calculateAUC() for r in self._rocs.values()]))


class ROCBinary:
    """Per-output ROC for MULTI-LABEL binary outputs [N, nOut] (reference:
    org.nd4j.evaluation.classification.ROCBinary — one ROC per sigmoid
    output, vs ROC's single binary problem)."""

    def __init__(self, thresholdSteps=0):
        self.thresholdSteps = thresholdSteps
        self._rocs: dict[int, ROC] = {}

    def eval(self, labels, predictions, mask=None):
        lab = _to_np(labels)
        pred = _to_np(predictions)
        if lab.ndim == 1:
            lab = lab[:, None]
            pred = pred[:, None]
        m = None if mask is None else _to_np(mask)
        if lab.ndim == 3:
            # DL4J time series [N, nOut, T]: fold time into the batch so
            # the per-OUTPUT axis stays axis -1. A [N, T] mask folds to
            # per-example; a [N, nOut, T] mask folds to per-output.
            lab = lab.transpose(0, 2, 1).reshape(-1, lab.shape[1])
            pred = pred.transpose(0, 2, 1).reshape(-1, pred.shape[1])
            if m is not None:
                m = (m.transpose(0, 2, 1).reshape(-1, m.shape[1])
                     if m.ndim == 3 else m.reshape(-1))
        for i in range(lab.shape[-1]):
            li, pi = lab[..., i].reshape(-1), pred[..., i].reshape(-1)
            if m is not None:
                # per-output mask [N, nOut] selects its column; a
                # per-example mask [N] applies to every output
                mi = m[..., i] if m.ndim == lab.ndim else m
                keep = mi.reshape(-1) > 0
                li, pi = li[keep], pi[keep]
            self._rocs.setdefault(i, ROC(self.thresholdSteps)).eval(li, pi)
        return self

    def numLabels(self):
        return len(self._rocs)

    def calculateAUC(self, outputNum):
        return self._rocs[outputNum].calculateAUC()

    def calculateAUCPR(self, outputNum):
        return self._rocs[outputNum].calculateAUCPR()

    def calculateAverageAUC(self):
        if not self._rocs:
            return 0.0
        return float(np.mean([r.calculateAUC()
                              for r in self._rocs.values()]))

    def stats(self):
        lines = ["ROCBinary (per-output AUC / AUCPR)"]
        for i, r in sorted(self._rocs.items()):
            lines.append(f"  out {i}: AUC {r.calculateAUC():.4f}  "
                         f"AUCPR {r.calculateAUCPR():.4f}")
        return "\n".join(lines)
