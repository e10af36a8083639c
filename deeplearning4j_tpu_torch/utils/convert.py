"""Weights and updater state from numpy into the port's layout, and back.

No JAX counterpart. ``params_from_numpy`` takes the per-layer
``{name: ndarray}`` dicts of a network (the JAX package's
``net._params`` as numpy arrays, or the arrays of a ``params.npz``) and
returns the port's per-layer ``{name: Tensor}`` dicts, checked against the
configuration's shapes. A layer whose params nest groups (Bidirectional's
``{"fwd": {...}, "bwd": {...}}``) takes nested dicts alike. Both packages
then compute the same function.
``opt_states_from_numpy`` does the same for the updater state (the JAX
package's ``net._opt_states`` as numpy: per layer ``()`` or nested dicts
such as Adam's ``{"m": {...}, "v": {...}}``), and ``opt_states_to_numpy``
is its inverse, so both packages can start from the same state.
``bert_params_from_numpy`` and ``bert_params_to_numpy`` carry a BERT
parameter tree (``models/bert.py``) between the two packages, and
``bottleneck_params_from_numpy`` the bottleneck probe's parameters
(``kernels/bottleneck.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.tree_util import tree_map


def params_from_numpy(conf, arrays, device):
    """``arrays``: one dict per layer of ``conf``, each holding exactly the
    layer's parameters by name. Returns tensors of ``conf``'s dtype on
    ``device`` (copies: the caller's arrays are never aliased)."""
    if len(arrays) != len(conf.layers):
        raise ValueError(f"{len(arrays)} param dicts for "
                         f"{len(conf.layers)} layers")
    return [_group_from_numpy(lr.param_shapes(), arrs, conf.dtype, device,
                              f"layer {i} ({type(lr).__name__})")
            for i, (lr, arrs) in enumerate(zip(conf.layers, arrays))]


def _group_from_numpy(want, arrs, dtype, device, where):
    """One param group (nested groups recursively) in ``want``'s names
    and order, each array checked against its shape."""
    if not isinstance(arrs, dict) or set(arrs) != set(want):
        got = sorted(arrs) if isinstance(arrs, dict) else type(arrs).__name__
        raise ValueError(f"{where} has params {sorted(want)}, got {got}")
    p = {}
    for name, shape in want.items():
        if isinstance(shape, dict):
            p[name] = _group_from_numpy(shape, arrs[name], dtype, device,
                                        f"{where} group {name}")
            continue
        a = np.asarray(arrs[name])
        if a.shape != shape:
            raise ValueError(f"{where} param {name}: shape {a.shape}, "
                             f"configuration says {shape}")
        p[name] = torch.tensor(a, dtype=dtype, device=device)
    return p


def opt_states_from_numpy(conf, arrays, device):
    """``arrays``: one updater state per layer of ``conf`` with numpy
    leaves. Returns the same structure with tensors of ``conf``'s dtype on
    ``device`` (copies)."""
    if len(arrays) != len(conf.layers):
        raise ValueError(f"{len(arrays)} updater states for "
                         f"{len(conf.layers)} layers")
    return [tree_map(lambda a: torch.tensor(np.asarray(a), dtype=conf.dtype,
                                             device=device), st)
            for st in arrays]


def opt_states_to_numpy(states):
    """The port's per-layer updater states with numpy leaves (host
    copies)."""
    return [tree_map(lambda t: t.detach().cpu().numpy(), st)
            for st in states]


_BERT_TOP = {"tok_emb", "pos_emb", "type_emb", "emb_ln", "layers",
             "mlm_bias"}
_BERT_LAYER = {"qkv_w", "qkv_b", "out_w", "out_b", "ln1", "ln2",
               "ffn_in_w", "ffn_in_b", "ffn_out_w", "ffn_out_b"}


def bert_params_from_numpy(tree, device):
    """A BERT parameter tree in the JAX package's layout (nested dicts,
    ``layers`` a list of dicts, numpy leaves) as float32 tensors on
    ``device`` (copies), for ``deeplearning4j_tpu_torch.models.bert``."""
    if set(tree) != _BERT_TOP:
        raise ValueError(f"BERT params have {sorted(_BERT_TOP)}, got "
                         f"{sorted(tree)}")
    for i, layer in enumerate(tree["layers"]):
        if "moe" in layer:
            raise NotImplementedError(
                "MoE BERT layers are not ported yet (ROADMAP queue 1, "
                "the parallel tier)")
        if set(layer) != _BERT_LAYER:
            raise ValueError(f"BERT layer {i} has {sorted(_BERT_LAYER)}, "
                             f"got {sorted(layer)}")
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32),
                                            device=device), tree)


def bert_params_to_numpy(params):
    """The inverse of ``bert_params_from_numpy``: numpy leaves (host
    copies), in the JAX package's layout."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)


_BOTTLENECK = {"w1": torch.bfloat16, "w2": torch.bfloat16,
               "w3": torch.bfloat16, "s1": torch.float32,
               "b1": torch.float32, "s2": torch.float32,
               "b2": torch.float32, "s3": torch.float32,
               "b3": torch.float32}


def bottleneck_params_from_numpy(tree, device):
    """The bottleneck probe's parameters (the reference's ``make_params``
    dict, numpy leaves: w1 (C, F), w2 (9, F, F), w3 (F, C) in bf16; s1, b1,
    s2, b2 (1, F) and s3, b3 (1, C)) as tensors on ``device`` (copies):
    bf16 weights, float32 affines, for ``kernels/bottleneck.py``. Leaves in
    a numpy bf16 dtype go through float32, which holds them exactly."""
    if set(tree) != set(_BOTTLENECK):
        raise ValueError(f"bottleneck params have {sorted(_BOTTLENECK)}, "
                         f"got {sorted(tree)}")
    return {k: torch.tensor(np.asarray(tree[k], np.float32),
                            device=device).to(dtype)
            for k, dtype in _BOTTLENECK.items()}
