"""Loss functions for output layers.

Counterpart of ``deeplearning4j_tpu/nn/losses.py``: each loss maps
(labels, pre_output, activation_name, mask) -> the scalar mean per-example
score, with the same definitions. Softmax + MCXENT and sigmoid + XENT are
computed from the logits (log_softmax / the stable binary form) instead of
activating first.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.activations import resolve_activation


class LossFunction:
    MCXENT = "mcxent"
    NEGATIVELOGLIKELIHOOD = "negativeloglikelihood"
    MSE = "mse"
    L2 = "l2"
    XENT = "xent"
    MAE = "mae"
    L1 = "l1"
    HINGE = "hinge"
    SQUARED_HINGE = "squared_hinge"
    KL_DIVERGENCE = "kl_divergence"
    POISSON = "poisson"
    COSINE_PROXIMITY = "cosine_proximity"
    SPARSE_MCXENT = "sparse_mcxent"


def _flatten_time(labels, pre):
    """RNN outputs arrive as [N, C, T] (DL4J NCW) and segmentation outputs
    as [N, C, H, W]. Fold time/space into the batch so every loss sees
    [N*, C]."""
    if pre.dim() >= 3:
        c = pre.shape[1]
        pre = torch.movedim(pre, 1, -1).reshape(-1, c)
        labels = torch.movedim(labels, 1, -1).reshape(-1, labels.shape[1])
    return labels, pre


def _per_example(loss_fn):
    def wrapped(labels, pre_output, activation, mask=None):
        labels, pre_output = _flatten_time(labels, pre_output)
        per_ex = loss_fn(labels, pre_output, activation)  # [N*]
        if mask is not None:
            m = mask.reshape(-1).to(per_ex.dtype)
            if m.numel() != per_ex.numel() and \
                    per_ex.numel() % m.numel() == 0:
                # per-example mask against per-timestep/pixel entries
                m = torch.repeat_interleave(m, per_ex.numel() // m.numel())
            return (per_ex * m).sum() / torch.clamp(m.sum(), min=1.0)
        return per_ex.mean()

    return wrapped


def _mcxent(labels, pre, activation):
    if activation == "softmax":
        logp = torch.log_softmax(pre, dim=-1)
    elif activation in ("identity", "logsoftmax"):
        logp = pre if activation == "logsoftmax" else torch.log(
            torch.clamp(pre, 1e-10, 1.0))
    else:
        out = resolve_activation(activation)(pre)
        logp = torch.log(torch.clamp(out, 1e-10, 1.0))
    return -(labels * logp).sum(dim=-1)


def _sparse_mcxent(labels, pre, activation):
    logp = torch.log_softmax(pre, dim=-1)
    idx = labels.to(torch.int64)
    if idx.dim() == logp.dim():  # [N,1] -> [N]
        idx = idx[..., 0]
    return -torch.gather(logp, -1, idx[..., None])[..., 0]


def _xent(labels, pre, activation):
    if activation == "sigmoid":
        # stable binary CE from logits: max(x,0) - x*z + log1p(exp(-|x|))
        per = (torch.clamp(pre, min=0) - pre * labels
               + torch.log1p(torch.exp(-pre.abs())))
    else:
        out = torch.clamp(resolve_activation(activation)(pre), 1e-10,
                          1 - 1e-10)
        per = -(labels * torch.log(out) + (1 - labels) * torch.log(1 - out))
    return per.sum(dim=-1)


def _mse(labels, pre, activation):
    out = resolve_activation(activation)(pre)
    return ((labels - out) ** 2).mean(dim=-1)


def _l2(labels, pre, activation):
    out = resolve_activation(activation)(pre)
    return ((labels - out) ** 2).sum(dim=-1)


def _mae(labels, pre, activation):
    out = resolve_activation(activation)(pre)
    return (labels - out).abs().mean(dim=-1)


def _l1(labels, pre, activation):
    out = resolve_activation(activation)(pre)
    return (labels - out).abs().sum(dim=-1)


def _hinge(labels, pre, activation):
    out = resolve_activation(activation)(pre)
    return torch.clamp(1.0 - labels * out, min=0.0).sum(dim=-1)


def _squared_hinge(labels, pre, activation):
    out = resolve_activation(activation)(pre)
    return (torch.clamp(1.0 - labels * out, min=0.0) ** 2).sum(dim=-1)


def _kld(labels, pre, activation):
    out = torch.clamp(resolve_activation(activation)(pre), 1e-10, 1.0)
    lab = torch.clamp(labels, 1e-10, 1.0)
    return (labels * (torch.log(lab) - torch.log(out))).sum(dim=-1)


def _poisson(labels, pre, activation):
    out = resolve_activation(activation)(pre)
    return (out - labels * torch.log(torch.clamp(out, min=1e-10))).sum(
        dim=-1)


def _cosine(labels, pre, activation):
    out = resolve_activation(activation)(pre)
    dot = (labels * out).sum(dim=-1)
    norms = (torch.linalg.vector_norm(labels, dim=-1)
             * torch.linalg.vector_norm(out, dim=-1))
    return -dot / torch.clamp(norms, min=1e-10)


_LOSSES = {
    LossFunction.MCXENT: _mcxent,
    LossFunction.NEGATIVELOGLIKELIHOOD: _mcxent,
    LossFunction.SPARSE_MCXENT: _sparse_mcxent,
    LossFunction.MSE: _mse,
    LossFunction.L2: _l2,
    LossFunction.XENT: _xent,
    LossFunction.MAE: _mae,
    LossFunction.L1: _l1,
    LossFunction.HINGE: _hinge,
    LossFunction.SQUARED_HINGE: _squared_hinge,
    LossFunction.KL_DIVERGENCE: _kld,
    LossFunction.POISSON: _poisson,
    LossFunction.COSINE_PROXIMITY: _cosine,
}


def resolve_loss(name):
    key = str(name).lower()
    if key not in _LOSSES:
        raise ValueError(f"unknown loss function {name!r}")
    return _per_example(_LOSSES[key])
