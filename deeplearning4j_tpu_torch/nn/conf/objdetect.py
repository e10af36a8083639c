"""Object detection: the YOLOv2 output layer.

Counterpart of ``deeplearning4j_tpu/nn/conf/objdetect.py``: the same loss
terms, decode, config fields and JSON. The loss is one function of
tensors with no data-dependent control flow: anchor responsibility is the
one-hot ``argmax`` of the prior IoU masked by objectness (``torch.argmax``
takes the first maximum, as ``jnp.argmax`` does, so an empty cell, IoU 0
for every prior, picks prior 0 in both packages), and the confidence
target is the predicted box's IoU, detached.

Layout (as in the JAX package and DL4J):
  network output: [N, B*(5+C), H, W]   B anchors, C classes, per anchor
                  (tx, ty, tw, th, to, c_0..c_{C-1})
  labels:         [N, 4+C, H, W]       (x1, y1, x2, y2) in GRID units and
                  a one-hot class, zero everywhere in an empty cell.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf.layers import LossLayer, _register


def _anchor_iou(wh_gt, priors):
    """IoU of centred boxes: wh_gt [..., 2] against priors [B, 2] ->
    [..., B]."""
    gw, gh = wh_gt[..., 0:1], wh_gt[..., 1:2]
    pw, ph = priors[:, 0], priors[:, 1]
    inter = torch.minimum(gw, pw) * torch.minimum(gh, ph)
    union = gw * gh + pw * ph - inter
    return inter / torch.clamp(union, min=1e-9)


@_register
class Yolo2OutputLayer(LossLayer):
    """The YOLOv2 detection loss: L2 (or L1) position and sqrt-size
    penalties scaled by ``lambdaCoord``, confidence against the detached
    IoU (``lambdaNoObj`` on the anchors not responsible), class L2 (or
    mcxent) on the responsible anchors, summed and divided by N.
    ``boundingBoxPriors``: [B, 2] anchor (width, height) in grid units."""

    def __init__(self, boundingBoxPriors=None, lambdaCoord=5.0,
                 lambdaNoObj=0.5, lossPositionScale="l2",
                 lossClassPredictions="l2", **kw):
        kw.setdefault("lossFunction", "mse")
        super().__init__(**kw)
        if boundingBoxPriors is None:
            raise ValueError("Yolo2OutputLayer requires boundingBoxPriors")
        self.boundingBoxPriors = [[float(v) for v in p]
                                  for p in np.asarray(boundingBoxPriors)]
        self.lambdaCoord = float(lambdaCoord)
        self.lambdaNoObj = float(lambdaNoObj)
        self.lossPositionScale = lossPositionScale
        self.lossClassPredictions = lossClassPredictions
        self.activation = "identity"

    @property
    def n_anchors(self):
        return len(self.boundingBoxPriors)

    def _priors(self, x):
        return torch.tensor(self.boundingBoxPriors, dtype=x.dtype,
                            device=x.device)

    def _split(self, x):
        """[N, B*(5+C), H, W] -> txy [N,B,2,H,W], twh [N,B,2,H,W],
        to [N,B,H,W], logits [N,B,C,H,W]."""
        n, ch, h, w = x.shape
        b = self.n_anchors
        x = x.reshape(n, b, ch // b, h, w)
        return x[:, :, 0:2], x[:, :, 2:4], x[:, :, 4], x[:, :, 5:]

    def _decode(self, x):
        """[N, B, 5+C, H, W]: xy the cell-relative sigmoid, wh = prior *
        exp(twh) in grid units, the confidence's sigmoid, the classes'
        softmax."""
        txy, twh, to, logits = self._split(x)
        priors = self._priors(x)
        wh = priors[None, :, :, None, None] * torch.exp(
            torch.clamp(twh, -10.0, 10.0))
        return torch.cat([torch.sigmoid(txy), wh,
                          torch.sigmoid(to)[:, :, None],
                          torch.softmax(logits, dim=2)], dim=2)

    def apply(self, params, state, x, training=False, generator=None):
        return self._decode(x), state

    def compute_loss(self, params, x, labels, mask=None):
        """The composite loss; labels [N, 4+C, H, W] in grid units."""
        labels = labels.to(x.dtype)
        n, _, h, w = x.shape
        b = self.n_anchors
        priors = self._priors(x)

        txy, twh, to, logits = self._split(x)
        cls_gt = labels[:, 4:]
        obj = (cls_gt.sum(dim=1) > 0).to(x.dtype)            # [N, H, W]

        x1, y1, x2, y2 = labels[:, 0], labels[:, 1], labels[:, 2], \
            labels[:, 3]
        cx, cy = (x1 + x2) * 0.5, (y1 + y2) * 0.5
        gw, gh = x2 - x1, y2 - y1

        # anchor responsibility: argmax IoU(prior, gt wh), one-hot masked
        iou_a = _anchor_iou(torch.stack([gw, gh], dim=-1), priors)
        resp = F.one_hot(torch.argmax(iou_a, dim=-1), b).to(x.dtype)
        resp = resp.permute(0, 3, 1, 2) * obj[:, None]        # [N, B, H, W]

        if str(self.lossPositionScale).lower() == "l1":
            pen = torch.abs
        else:
            pen = torch.square
        tx_gt = torch.clamp(cx - torch.floor(cx), 0.0, 1.0)
        ty_gt = torch.clamp(cy - torch.floor(cy), 0.0, 1.0)
        pxy = torch.sigmoid(txy)                               # [N,B,2,H,W]
        pos = (pen(pxy[:, :, 0] - tx_gt[:, None])
               + pen(pxy[:, :, 1] - ty_gt[:, None]))
        pwh = priors[None, :, :, None, None] * torch.exp(
            torch.clamp(twh, -10.0, 10.0))
        eps = 1e-9
        size = (pen(torch.sqrt(pwh[:, :, 0] + eps)
                    - torch.sqrt(torch.clamp(gw, min=0.0) + eps)[:, None])
                + pen(torch.sqrt(pwh[:, :, 1] + eps)
                      - torch.sqrt(torch.clamp(gh, min=0.0) + eps)[:, None]))
        loss_pos = self.lambdaCoord * torch.sum(resp * (pos + size))

        # confidence: responsible anchors target IoU(pred, gt); the rest 0
        cell_x = torch.arange(w, dtype=x.dtype, device=x.device)[
            None, None, None, :]
        cell_y = torch.arange(h, dtype=x.dtype, device=x.device)[
            None, None, :, None]
        pcx = pxy[:, :, 0] + cell_x
        pcy = pxy[:, :, 1] + cell_y
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        inter_w = torch.maximum(zero, torch.minimum(
            pcx + pwh[:, :, 0] / 2, (cx + gw / 2)[:, None])
            - torch.maximum(pcx - pwh[:, :, 0] / 2, (cx - gw / 2)[:, None]))
        inter_h = torch.maximum(zero, torch.minimum(
            pcy + pwh[:, :, 1] / 2, (cy + gh / 2)[:, None])
            - torch.maximum(pcy - pwh[:, :, 1] / 2, (cy - gh / 2)[:, None]))
        inter = inter_w * inter_h
        union = pwh[:, :, 0] * pwh[:, :, 1] + (gw * gh)[:, None] - inter
        iou = inter / torch.clamp(union, min=1e-9)
        conf = torch.sigmoid(to)
        loss_conf = (torch.sum(resp * torch.square(conf - iou.detach()))
                     + self.lambdaNoObj * torch.sum((1.0 - resp)
                                                    * torch.square(conf)))

        probs = torch.softmax(logits, dim=2)                   # [N,B,C,H,W]
        if str(self.lossClassPredictions).lower() in (
                "mcxent", "negativeloglikelihood"):
            cls_term = -torch.sum(cls_gt[:, None] * torch.log(
                torch.clamp(probs, min=1e-9)), dim=2)
        else:   # L2 on the softmax outputs (the default)
            cls_term = torch.sum(torch.square(probs - cls_gt[:, None]),
                                 dim=2)
        loss_cls = torch.sum(resp * cls_term)
        return (loss_pos + loss_conf + loss_cls) / n

    def infer(self, input_type):
        return input_type
