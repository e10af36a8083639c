"""Weights and updater state from numpy into the port's layout, and back.

No JAX counterpart. ``params_from_numpy`` takes the per-layer
``{name: ndarray}`` dicts of a network (the JAX package's
``net._params`` as numpy arrays, or the arrays of a ``params.npz``) and
returns the port's per-layer ``{name: Tensor}`` dicts, checked against the
configuration's shapes. Both packages then compute the same function.
``opt_states_from_numpy`` does the same for the updater state (the JAX
package's ``net._opt_states`` as numpy: per layer ``()`` or nested dicts
such as Adam's ``{"m": {...}, "v": {...}}``), and ``opt_states_to_numpy``
is its inverse, so both packages can start from the same state.
``bert_params_from_numpy`` and ``bert_params_to_numpy`` carry a BERT
parameter tree (``models/bert.py``) between the two packages.
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


def _tree_map(fn, tree):
    """``fn`` on every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def opt_states_from_numpy(conf, arrays, device):
    """``arrays``: one updater state per layer of ``conf`` with numpy
    leaves. Returns the same structure with tensors of ``conf``'s dtype on
    ``device`` (copies)."""
    if len(arrays) != len(conf.layers):
        raise ValueError(f"{len(arrays)} updater states for "
                         f"{len(conf.layers)} layers")
    return [_tree_map(lambda a: torch.tensor(np.asarray(a), dtype=conf.dtype,
                                             device=device), st)
            for st in arrays]


def opt_states_to_numpy(states):
    """The port's per-layer updater states with numpy leaves (host
    copies)."""
    return [_tree_map(lambda t: t.detach().cpu().numpy(), st)
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
    return _tree_map(lambda a: torch.tensor(np.asarray(a, np.float32),
                                            device=device), tree)


def bert_params_to_numpy(params):
    """The inverse of ``bert_params_from_numpy``: numpy leaves (host
    copies), in the JAX package's layout."""
    return _tree_map(lambda t: t.detach().cpu().numpy(), params)
