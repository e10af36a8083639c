"""Weights and updater state from numpy into the port's layout, and back.

No JAX counterpart. ``params_from_numpy`` takes the per-layer
``{name: ndarray}`` dicts of a network (the JAX package's
``net._params`` as numpy arrays, or the arrays of a ``params.npz``) and
returns the port's per-layer ``{name: Tensor}`` dicts, checked against the
configuration's shapes; for a ComputationGraph the dicts are keyed by
node name instead of listed by layer. A layer whose params nest groups
(Bidirectional's ``{"fwd": {...}, "bwd": {...}}``) takes nested dicts
alike. Both packages
then compute the same function.
``states_from_numpy`` does the same for the layer states (per layer a
dict of the layer's state, e.g. BatchNormalization's running ``mean`` and
``var``, OCNN's ``r`` and its int32 ``seen``, each leaf in the dtype of
the layer's ``init_state``; ``{}`` for a layer without), and
``states_to_numpy`` is its inverse. A wrapper's (FrozenLayer,
MaskZeroLayer) params and state are its inner layer's. ``opt_states_from_numpy`` does the same for the updater state (the JAX
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


def _each(conf, arrays, what, suffix, fn):
    """``fn(layer, arrays, where)`` for each layer of a
    MultiLayerConfiguration (a list, by index) or each node of a
    ComputationGraphConfiguration (a dict, by name; ``layer`` None for a
    vertex), with ``arrays`` checked to cover exactly those."""
    if hasattr(conf, "nodes"):
        if not isinstance(arrays, dict) or set(arrays) != set(conf.nodes):
            got = sorted(arrays) if isinstance(arrays, dict) else \
                type(arrays).__name__
            raise ValueError(f"{what} for {got}, the graph has "
                             f"{sorted(conf.nodes)}")
        return {name: fn(node if hasattr(node, "param_shapes") else None,
                         arrays[name],
                         f"node {name!r} ({type(node).__name__}){suffix}")
                for name, (node, _) in conf.nodes.items()}
    if len(arrays) != len(conf.layers):
        raise ValueError(f"{len(arrays)} {what} for {len(conf.layers)} "
                         f"layers")
    return [fn(lr, a, f"layer {i} ({type(lr).__name__}){suffix}")
            for i, (lr, a) in enumerate(zip(conf.layers, arrays))]


def params_from_numpy(conf, arrays, device):
    """``arrays``: for a MultiLayerConfiguration one dict per layer, for a
    ComputationGraphConfiguration one dict per node by name (``{}`` for a
    vertex), each holding exactly the layer's parameters by name. Returns
    tensors of ``conf``'s dtype on ``device`` in the same layout (copies:
    the caller's arrays are never aliased)."""
    return _each(conf, arrays, "param dicts", "", lambda lr, arrs, where:
                 _group_from_numpy({} if lr is None else lr.param_shapes(),
                                   arrs, conf.dtype, device, where))


def _group_from_numpy(want, arrs, dtype, device, where):
    """One param group (nested groups recursively) in ``want``'s names
    and order, each array checked against its shape. A leaf of ``want``
    may be a (shape, dtype) pair, whose dtype then overrides ``dtype``
    (OCNN's int32 step count ``seen``)."""
    if not isinstance(arrs, dict) or set(arrs) != set(want):
        got = sorted(arrs) if isinstance(arrs, dict) else type(arrs).__name__
        raise ValueError(f"{where} has params {sorted(want)}, got {got}")
    p = {}
    for name, shape in want.items():
        if isinstance(shape, dict):
            p[name] = _group_from_numpy(shape, arrs[name], dtype, device,
                                        f"{where} group {name}")
            continue
        leaf_dtype = dtype
        if isinstance(shape, tuple) and len(shape) == 2 and isinstance(
                shape[1], torch.dtype):
            shape, leaf_dtype = shape
        a = np.asarray(arrs[name])
        if a.shape != shape:
            raise ValueError(f"{where} param {name}: shape {a.shape}, "
                             f"configuration says {shape}")
        p[name] = torch.tensor(a, dtype=leaf_dtype, device=device)
    return p


def states_from_numpy(conf, arrays, device):
    """``arrays``: the layer states in ``params_from_numpy``'s layout
    (the JAX package's ``net._states`` as numpy). Returns tensors of
    ``conf``'s dtype on ``device`` (copies)."""
    def state(lr, arrs, where):
        want = {} if lr is None else tree_map(
            lambda t: (tuple(t.shape), t.dtype),
            lr.init_state(conf.dtype, "meta"))
        return _group_from_numpy(want, arrs, conf.dtype, device, where)

    return _each(conf, arrays, "layer states", " state", state)


def opt_states_from_numpy(conf, arrays, device):
    """``arrays``: the updater states with numpy leaves, one a layer (a
    list) or a node (a dict by name). Returns the same structure with
    tensors of ``conf``'s dtype on ``device`` (copies)."""
    return _each(conf, arrays, "updater states", "", lambda lr, st, where:
                 tree_map(lambda a: torch.tensor(
                     np.asarray(a), dtype=conf.dtype, device=device), st))


def opt_states_to_numpy(states):
    """The port's updater states, or layer states (``states_to_numpy``),
    per layer (a list) or per node (a dict), with numpy leaves (host
    copies)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), states)


states_to_numpy = opt_states_to_numpy


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
