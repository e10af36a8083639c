"""Weights from numpy into the port's parameter layout.

No JAX counterpart. ``params_from_numpy`` takes the per-layer
``{name: ndarray}`` dicts of a network (the JAX package's
``net._params`` as numpy arrays, or the arrays of a ``params.npz``) and
returns the port's per-layer ``{name: Tensor}`` dicts, checked against the
configuration's shapes. Both packages then compute the same function.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(conf, arrays, device):
    """``arrays``: one dict per layer of ``conf``, each holding exactly the
    layer's parameters by name. Returns tensors of ``conf``'s dtype on
    ``device`` (copies: the caller's arrays are never aliased)."""
    if len(arrays) != len(conf.layers):
        raise ValueError(f"{len(arrays)} param dicts for "
                         f"{len(conf.layers)} layers")
    out = []
    for i, (lr, arrs) in enumerate(zip(conf.layers, arrays)):
        want = lr.param_shapes()
        if set(arrs) != set(want):
            raise ValueError(f"layer {i} ({type(lr).__name__}) has params "
                             f"{sorted(want)}, got {sorted(arrs)}")
        p = {}
        for name, shape in want.items():
            a = np.asarray(arrs[name])
            if a.shape != shape:
                raise ValueError(f"layer {i} param {name}: shape {a.shape},"
                                 f" configuration says {shape}")
            p[name] = torch.tensor(a, dtype=conf.dtype, device=device)
        out.append(p)
    return out
