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
The tensors take the configuration's precision policy's param dtype.
An array in the JAX package's bfloat16 (ml_dtypes: numpy kind ``'V'``,
two bytes, named ``bfloat16``) is read by its bits, with no import of
ml_dtypes; the ``*_to_numpy`` functions give a bfloat16 leaf as float32
(which holds it exactly), since numpy has no bfloat16 of its own.
``bert_params_from_numpy`` and ``bert_params_to_numpy`` carry a BERT
parameter tree (``models/bert.py``) between the two packages, and
``bottleneck_params_from_numpy`` the bottleneck probe's parameters
(``kernels/bottleneck.py``). ``embeddings_from_numpy`` installs the JAX
package's embedding state (vocab, ``syn0``/``syn1``, ``doc_vecs``,
GloVe's ``{w, wt, b, bt}``, k-means' ``centers``) into the port's NLP and
clustering models; both packages draw initial vectors only where the
state is None, so a whole ``fit`` from it can be compared where numpy
drives every draw.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.tree_util import tree_map


def _is_bfloat16(a) -> bool:
    """Whether a numpy array is in ml_dtypes' bfloat16 (read without
    importing ml_dtypes)."""
    return a.dtype.kind == "V" and a.dtype.itemsize == 2 and \
        a.dtype.name == "bfloat16"


def tensor_from_numpy(a, dtype, device) -> torch.Tensor:
    """A copy of ``a`` as a ``dtype`` tensor on ``device``; a bfloat16
    array by its bits."""
    a = np.asarray(a)
    if _is_bfloat16(a):
        bits = torch.from_numpy(np.array(a).view(np.int16))   # a copy
        return bits.view(torch.bfloat16).to(device=device, dtype=dtype)
    return torch.tensor(a, dtype=dtype, device=device)


def tensor_to_numpy(t) -> np.ndarray:
    """A host copy of a tensor; bfloat16 as float32."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy().copy()


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
    tensors of ``conf``'s param dtype on ``device`` in the same layout
    (copies: the caller's arrays are never aliased)."""
    dtype = conf.precision_policy.param_torch
    return _each(conf, arrays, "param dicts", "", lambda lr, arrs, where:
                 _group_from_numpy({} if lr is None else lr.param_shapes(),
                                   arrs, dtype, device, where))


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
        p[name] = tensor_from_numpy(a, leaf_dtype, device)
    return p


def states_from_numpy(conf, arrays, device):
    """``arrays``: the layer states in ``params_from_numpy``'s layout
    (the JAX package's ``net._states`` as numpy). Returns tensors of
    ``conf``'s param dtype on ``device`` (copies)."""
    dtype = conf.precision_policy.param_torch

    def state(lr, arrs, where):
        want = {} if lr is None else tree_map(
            lambda t: (tuple(t.shape), t.dtype),
            lr.init_state(dtype, "meta"))
        return _group_from_numpy(want, arrs, dtype, device, where)

    return _each(conf, arrays, "layer states", " state", state)


def opt_states_from_numpy(conf, arrays, device):
    """``arrays``: the updater states with numpy leaves, one a layer (a
    list) or a node (a dict by name). Returns the same structure with
    tensors of ``conf``'s param dtype on ``device`` (copies)."""
    dtype = conf.precision_policy.param_torch
    return _each(conf, arrays, "updater states", "", lambda lr, st, where:
                 tree_map(lambda a: tensor_from_numpy(a, dtype, device), st))


def opt_states_to_numpy(states):
    """The port's updater states, or layer states (``states_to_numpy``),
    per layer (a list) or per node (a dict), with numpy leaves (host
    copies; bfloat16 as float32)."""
    return tree_map(tensor_to_numpy, states)


states_to_numpy = opt_states_to_numpy


_BERT_TOP = {"tok_emb", "pos_emb", "type_emb", "emb_ln", "layers",
             "mlm_bias"}
_BERT_LAYER = {"qkv_w", "qkv_b", "out_w", "out_b", "ln1", "ln2",
               "ffn_in_w", "ffn_in_b", "ffn_out_w", "ffn_out_b"}
_BERT_MOE_LAYER = {"qkv_w", "qkv_b", "out_w", "out_b", "ln1", "ln2", "moe"}
_BERT_MOE = {"gate_w", "w1", "b1", "w2", "b2"}


def bert_params_from_numpy(tree, device):
    """A BERT parameter tree in the JAX package's layout (nested dicts,
    ``layers`` a list of dicts, numpy leaves) as float32 tensors on
    ``device`` (copies), for ``deeplearning4j_tpu_torch.models.bert``. A
    MoE layer carries its ``moe`` subtree (gate_w, w1, b1, w2, b2) in
    place of the dense FFN."""
    if set(tree) != _BERT_TOP:
        raise ValueError(f"BERT params have {sorted(_BERT_TOP)}, got "
                         f"{sorted(tree)}")
    for i, layer in enumerate(tree["layers"]):
        want = _BERT_MOE_LAYER if "moe" in layer else _BERT_LAYER
        if set(layer) != want:
            raise ValueError(f"BERT layer {i} has {sorted(want)}, "
                             f"got {sorted(layer)}")
        if "moe" in layer and set(layer["moe"]) != _BERT_MOE:
            raise ValueError(f"BERT layer {i} moe has {sorted(_BERT_MOE)}, "
                             f"got {sorted(layer['moe'])}")
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


def _vocab_from(words, counts):
    from deeplearning4j_tpu_torch.nlp.word2vec import VocabCache

    if len(words) != len(counts):
        raise ValueError(f"{len(words)} words but {len(counts)} counts")
    vocab = VocabCache()
    for w, c in zip(words, counts):
        vocab.add(str(w), int(c))
    return vocab


def _table(a, rows, cols, what, device):
    """A float32 copy of ``a`` on ``device``, checked to be [rows, cols]
    ([rows] where ``cols`` is None)."""
    a = np.asarray(a, np.float32)
    want = (rows,) if cols is None else (rows, cols)
    if a.shape != want:
        raise ValueError(f"{what} has shape {a.shape}, want {want}")
    return torch.tensor(a, device=device)


def embeddings_from_numpy(model, state):
    """Install ``state`` (numpy, in the JAX package's layout) into a model
    of the port, on the model's device, and return the model:

    - ``Word2Vec`` (and ``ParagraphVectors``): ``words`` and ``counts``
      (the vocab in index order, word for word), ``syn0``, ``syn1`` [V,
      D], and for ``ParagraphVectors`` ``doc_vecs`` [docs, D]; the
      negative tables are rebuilt from the counts and the corpus caches
      dropped;
    - ``Glove``: ``words``, ``counts``, ``w``, ``wt`` [V, D], ``b``,
      ``bt`` [V];
    - ``KMeansClustering``: ``centers`` [k, F], kept as numpy as
      ``applyTo`` keeps them.
    """
    from deeplearning4j_tpu_torch.clustering.kmeans import KMeansClustering
    from deeplearning4j_tpu_torch.nlp.glove import Glove
    from deeplearning4j_tpu_torch.nlp.paragraph_vectors import (
        ParagraphVectors)
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

    if isinstance(model, KMeansClustering):
        centers = np.asarray(state["centers"], np.float32)
        if centers.ndim != 2 or centers.shape[0] != model.k:
            raise ValueError(f"centers have shape {centers.shape}, want "
                             f"({model.k}, F)")
        model.centers = centers.copy()
        return model
    if not isinstance(model, (Word2Vec, Glove)):
        raise TypeError(f"no embedding state for {type(model).__name__}")
    vocab = _vocab_from(state["words"], state["counts"])
    v, dev = vocab.numWords(), model.device
    if isinstance(model, Glove):
        d = model.cfg["vectorLength"]
        model.vocab = vocab
        model.params = {k: _table(state[k], v, d if k in ("w", "wt")
                                  else None, k, dev)
                        for k in ("w", "wt", "b", "bt")}
        return model
    d = model.cfg["layerSize"]
    syn0 = _table(state["syn0"], v, d, "syn0", dev)
    syn1 = _table(state["syn1"], v, d, "syn1", dev)
    model._invalidate_corpus_caches()
    model.vocab = vocab
    model._build_neg_tables()
    model.syn0, model.syn1 = syn0, syn1
    if isinstance(model, ParagraphVectors):
        model.doc_vecs = _table(state["doc_vecs"], len(model.docs), d,
                                "doc_vecs", dev)
    return model
