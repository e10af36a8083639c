"""Batch helpers of ``fit``.

The part of ``deeplearning4j_tpu/autodiff/samediff.py`` that
``MultiLayerNetwork.fit`` needs: turning its argument into batches,
splitting a batch into arrays and masks, and padding a ragged final batch
up to the batch-size bucket. SameDiff itself comes with a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.ndarray import INDArray


def _host_array(x, dtype=None):
    """Host numpy array of a batch: free for numpy, a copy for a tensor
    or an INDArray (which may lie on the GPU)."""
    if isinstance(x, INDArray):
        x = x.torch()
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def _prepare_batches(data, epoch_i, epochs):
    """Batches for one epoch. Materializes a one-shot iterable (generator)
    on the first epoch so later epochs see the data instead of silently
    training on nothing. Returns (batches, data) — rebind data to the
    second element."""
    batches = _as_batches(data)
    if (epoch_i == 0 and epochs > 1 and not hasattr(data, "reset")
            and not isinstance(batches, (list, tuple))):
        batches = list(batches)
        data = batches
    return batches, data


def _ones_mask(labels):
    """Example mask of ones matching the loss's per-example view: [N, T]
    for NCW time-series labels, else [N]."""
    if labels.ndim == 3:
        return np.ones((labels.shape[0], labels.shape[2]), np.float32)
    return np.ones((labels.shape[0],), np.float32)


def _pad_to_bucket(arrs, mask, bucket):
    """Pad batch axis of every array (and the mask) up to `bucket` rows by
    repeating the last row; padding rows get mask 0 so they cannot bias the
    loss. A ragged final minibatch then runs at the bucket's shape, as in
    the JAX package, where that keeps one compiled step."""
    n = arrs[0].shape[0]
    if n == bucket:
        return arrs, mask, n
    pad = bucket - n
    out = []
    for a in arrs:
        a = np.asarray(a)
        out.append(np.concatenate([a, np.repeat(a[-1:], pad, axis=0)],
                                  axis=0))
    mask = np.concatenate(
        [np.asarray(mask),
         np.zeros((pad,) + np.asarray(mask).shape[1:], np.float32)], axis=0)
    return out, mask, n


def _as_batches(data):
    if data is None:
        raise ValueError("fit() requires data")
    if isinstance(data, (tuple,)) and len(data) == 2 and not isinstance(
        data[0], (tuple, list)
    ):
        return [data]
    if hasattr(data, "getFeatures") or hasattr(data, "features"):
        return [data]
    if hasattr(data, "reset"):
        data.reset()
    return data


def _split_dataset(ds):
    """Accept (features, labels) tuples, DataSet-like objects, or
    MultiDataSet-like (lists of arrays)."""
    if isinstance(ds, tuple) and len(ds) == 2:
        f, l = ds
    elif hasattr(ds, "getFeatures"):
        f, l = ds.getFeatures(), ds.getLabels()
    else:
        f, l = ds.features, ds.labels
    if not isinstance(f, (list, tuple)):
        f = [f]
    if not isinstance(l, (list, tuple)):
        l = [l]
    return f, l


def _split_dataset_full(ds):
    """Like _split_dataset but also returns (featuresMasks, labelsMasks)
    lists (None entries when absent). Reference: DataSet.getFeaturesMaskArray
    / getLabelsMaskArray — masks mark valid timesteps for variable-length
    sequences and MUST reach the loss (SURVEY.md §2.5 masking row)."""
    f, l = _split_dataset(ds)
    fm = lm = None
    if hasattr(ds, "getFeaturesMaskArray"):
        fm = ds.getFeaturesMaskArray()
        lm = ds.getLabelsMaskArray()
    elif hasattr(ds, "featuresMasks"):
        fm, lm = ds.featuresMasks, ds.labelsMasks
    elif hasattr(ds, "featuresMask"):
        fm, lm = ds.featuresMask, ds.labelsMask
    if not isinstance(fm, (list, tuple)):
        fm = [fm] * len(f) if fm is None else [fm]
    if not isinstance(lm, (list, tuple)):
        lm = [lm] * len(l) if lm is None else [lm]
    return f, l, fm, lm
