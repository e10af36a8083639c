"""Host-side object-detection post-processing.

The port's own copy of ``deeplearning4j_tpu/nn/objdetect.py`` (numpy,
which the port keeps rather than imports): ``DetectedObject``, ``_iou``
and ``YoloUtils``. The decode runs on the device in
``Yolo2OutputLayer.apply``; thresholding and per-class non-max
suppression are a host loop over the few boxes that survive.
``getPredictedObjects`` takes the decoded output as a tensor (on any
device), the port's ``INDArray`` or a numpy array.
"""

from __future__ import annotations

import numpy as np
import torch


class DetectedObject:
    """One detection; coordinates in grid units, (cx, cy) the box's
    centre."""

    def __init__(self, example, cx, cy, w, h, predicted_class, confidence,
                 class_predictions):
        self.exampleNumber = int(example)
        self.centerX = float(cx)
        self.centerY = float(cy)
        self.width = float(w)
        self.height = float(h)
        self.predictedClass = int(predicted_class)
        self.confidence = float(confidence)
        self.classPredictions = np.asarray(class_predictions)

    def getTopLeftXY(self):
        return (self.centerX - self.width / 2,
                self.centerY - self.height / 2)

    def getBottomRightXY(self):
        return (self.centerX + self.width / 2,
                self.centerY + self.height / 2)

    def __repr__(self):
        return (f"DetectedObject(example={self.exampleNumber}, "
                f"class={self.predictedClass}, conf={self.confidence:.3f}, "
                f"cx={self.centerX:.2f}, cy={self.centerY:.2f}, "
                f"w={self.width:.2f}, h={self.height:.2f})")


def _iou(a, b):
    ax1, ay1 = a.getTopLeftXY()
    ax2, ay2 = a.getBottomRightXY()
    bx1, by1 = b.getTopLeftXY()
    bx2, by2 = b.getBottomRightXY()
    iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    ih = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = iw * ih
    union = ((ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter)
    return inter / union if union > 0 else 0.0


def _host(decoded):
    if isinstance(decoded, torch.Tensor):
        return decoded.detach().cpu().numpy()
    if hasattr(decoded, "toNumpy"):
        return decoded.toNumpy()
    return np.asarray(decoded)


class YoloUtils:
    @staticmethod
    def getPredictedObjects(decoded, threshold=0.5,
                            nms_threshold=0.4) -> list:
        """decoded: ``Yolo2OutputLayer``'s output [N, B, 5+C, H, W] (xy
        cell-relative, wh in grid units, confidence, class
        probabilities). The DetectedObjects whose object confidence is
        above ``threshold``, suppressed per example and class at
        ``nms_threshold`` IoU."""
        d = _host(decoded)
        out = []
        conf = d[:, :, 4]                       # [N, B, H, W]
        for ex, a, gy, gx in np.argwhere(conf > threshold):
            vec = d[ex, a, :, gy, gx]
            cls = vec[5:]
            out.append(DetectedObject(ex, vec[0] + gx, vec[1] + gy, vec[2],
                                      vec[3], int(np.argmax(cls)),
                                      vec[4] * cls.max(), cls))
        return YoloUtils.nonMaxSuppression(out, nms_threshold)

    @staticmethod
    def nonMaxSuppression(objects, iou_threshold=0.4) -> list:
        """Greedy NMS per example and class, highest confidence first."""
        kept = []
        by_key: dict = {}
        for o in objects:
            by_key.setdefault((o.exampleNumber, o.predictedClass),
                              []).append(o)
        for group in by_key.values():
            group.sort(key=lambda o: -o.confidence)
            chosen: list = []
            for o in group:
                if all(_iou(o, c) <= iou_threshold for c in chosen):
                    chosen.append(o)
            kept.extend(chosen)
        kept.sort(key=lambda o: (o.exampleNumber, -o.confidence))
        return kept
