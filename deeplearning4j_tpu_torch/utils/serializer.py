"""Model persistence in the JAX package's ModelSerializer zip.

Counterpart of the single-file half of
``deeplearning4j_tpu/utils/serializer.py``, for MultiLayerNetwork and
ComputationGraph. The zip holds ``modelType``, ``configuration.json`` and
``params.npz``, whose keys are ``p<SEP>layer<SEP>name`` (parameters) and
``s<SEP>layer<SEP>name`` (layer state, such as BatchNormalization's
running ``mean`` and ``var``) with SEP the unit separator, and
``p<SEP>layer<SEP>group<SEP>name`` for a nested group's leaves
(Bidirectional's ``fwd`` and ``bwd``), a graph's node name in place of
the layer's index; with
the updater, ``updaterState.npz`` (the updater state's leaves keyed
"0", "1", ... in ``jax.tree_util.tree_flatten`` order: layers in order
(a graph's nodes by sorted name), dict keys sorted at every level, so
Adam writes m.R, m.W, m.b, v.R, v.W, v.b, and under Bidirectional m.bwd.R, ..., m.fwd.b, v.bwd.R, ...) and
``trainingState.json`` (iteration and epoch, and ``lossScale``, the loss
scaler's state, under a loss-scaling policy: a restored mixed-precision
run resumes at its warmed scale, not at ``init_scale``). A bfloat16 leaf
is stored as its bits, a same-width ``uint16`` array, and named
``"bfloat16"`` in ``paramDtypes.json`` (params and layer states) or
``updaterDtypes.json`` (updater state), as the JAX package does; neither
writing nor reading imports ml_dtypes (``Tensor.view(torch.int16)`` and
back). A zip written by either package restores in the other, bit-equal.
A layer state's leaf keeps the dtype of the layer's ``init_state``
(OCNN's int32 ``seen``); a wrapper's (FrozenLayer, MaskZeroLayer) params
and state are its inner layer's. A normalizer (``writeModel(...,
normalizer=)``, ``addNormalizerToModel``) rides in ``normalizer.npz``: its
class name under ``__class__`` and its ``_state()`` arrays, as the JAX
package writes it, so ``restoreNormalizerFromFile`` reads a zip of either
package. Sharded checkpoints (with the scaler state's ``prec`` tree) come
with a later slice.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend import resolve_device
from deeplearning4j_tpu_torch.datasets.normalizers import (
    ImagePreProcessingScaler, NormalizerMinMaxScaler, NormalizerStandardize)
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.tree_util import (
    tree_fill, tree_items, tree_leaves)
from deeplearning4j_tpu_torch.utils.convert import (
    params_from_numpy, states_from_numpy, tensor_from_numpy)

_SEP = "\x1f"  # unit separator: cannot appear in layer names


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of a leaf; bfloat16 as its bits in uint16 (numpy has no
    bfloat16 of its own)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _encoded(named) -> tuple[dict, dict]:
    """(arrays as written, {key: "bfloat16"} for the bfloat16 leaves)."""
    return ({k: _host(v) for k, v in named.items()},
            {k: "bfloat16" for k, v in named.items()
             if v.dtype == torch.bfloat16})


def _decoded(arr, dtype_name) -> np.ndarray:
    """A stored array's values: a leaf named "bfloat16" from its uint16
    bits as float32 (which holds every bfloat16 exactly, so the cast back
    gives the same bits); any other as stored."""
    if dtype_name is None:
        return arr
    if dtype_name != "bfloat16":
        raise ValueError(f"stored dtype {dtype_name!r} is not one the port "
                         f"reads")
    bits = np.ascontiguousarray(arr).view(np.uint16).astype(np.uint32)
    return (bits << np.uint32(16)).view(np.float32)


def _npz_bytes(named) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **named)
    return buf.getvalue()


def _normalizer_bytes(normalizer) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, __class__=type(normalizer).__name__, **normalizer._state())
    return buf.getvalue()


def _groups(groups):
    """(key, group) pairs: a network's layers by index, a graph's nodes by
    name."""
    return groups.items() if isinstance(groups, dict) else enumerate(groups)


class ModelSerializer:
    @staticmethod
    def writeModel(model, path, saveUpdater: bool = True, normalizer=None,
                   includeFlatCoefficients: bool = False):
        """Write ``model`` (a MultiLayerNetwork or a ComputationGraph) to
        the single-file zip at ``path``, with its updater state and
        training counters unless ``saveUpdater`` is False, and
        ``normalizer`` (a fitted ``datasets.normalizers`` instance) where
        given. A graph's arrays are keyed by node name.

        ``includeFlatCoefficients`` also writes ``coefficients.bin``: the
        params as one raw little-endian float32 vector in ``params()``
        order, the reference's bytes where it can write them (on nested
        groups, Bidirectional's, the reference raises; the port writes
        its ``tree_leaves`` order). The reference refuses the flag with
        ``sharded=True``; the port's writeModel takes no ``sharded=``
        yet (ROADMAP.md, queue 1 item 12b), so the flag always goes to the
        single file."""
        is_graph = isinstance(model, ComputationGraph)
        named = {}
        for kind, groups in (("p", model._params), ("s", model._states)):
            for owner, group in _groups(groups):
                for keys, v in tree_items(group):
                    if len(keys) > 2:
                        raise ValueError(
                            f"{owner}'s {'/'.join(keys)} nests deeper "
                            f"than one group, which the zip's keys cannot "
                            f"hold")
                    named[_SEP.join((kind, str(owner), *keys))] = v
        arrays, dtypes = _encoded(named)
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr("configuration.json", model.conf.to_json())
            zf.writestr("modelType", "ComputationGraph" if is_graph
                        else "MultiLayerNetwork")
            if includeFlatCoefficients:
                flat = model.params().toNumpy().astype("<f4")
                zf.writestr("coefficients.bin", flat.tobytes())
            if dtypes:
                zf.writestr("paramDtypes.json", json.dumps(dtypes))
            zf.writestr("params.npz", _npz_bytes(arrays))
            if saveUpdater:
                leaves = tree_leaves(model._opt_states)
                arrays, dtypes = _encoded(
                    {str(i): v for i, v in enumerate(leaves)})
                if dtypes:
                    zf.writestr("updaterDtypes.json", json.dumps(dtypes))
                zf.writestr("updaterState.npz", _npz_bytes(arrays))
                ts = {"iteration": model._iteration, "epoch": model._epoch}
                if model._prec_state:
                    # the scaler's state, so a resumed run keeps its
                    # warmed scale (one read of three device scalars)
                    ts["lossScale"] = {k: float(v) for k, v in
                                       model._prec_state.items()}
                zf.writestr("trainingState.json", json.dumps(ts))
            if normalizer is not None:
                zf.writestr("normalizer.npz", _normalizer_bytes(normalizer))

    @staticmethod
    def addNormalizerToModel(path, normalizer):
        """Rewrite the zip at ``path`` with ``normalizer`` in it (in place of
        any it held)."""
        with zipfile.ZipFile(path) as zf:
            entries = {n: zf.read(n) for n in zf.namelist()
                       if n != "normalizer.npz"}
        entries["normalizer.npz"] = _normalizer_bytes(normalizer)
        with zipfile.ZipFile(path, "w") as zf:
            for n, data in entries.items():
                zf.writestr(n, data)

    @staticmethod
    def restoreNormalizerFromFile(path):
        """The normalizer the zip at ``path`` holds, or None."""
        with zipfile.ZipFile(path) as zf:
            if "normalizer.npz" not in zf.namelist():
                return None
            z = np.load(io.BytesIO(zf.read("normalizer.npz")))
            cls = {c.__name__: c for c in (
                NormalizerStandardize, NormalizerMinMaxScaler,
                ImagePreProcessingScaler)}[str(z["__class__"])]
            obj = cls.__new__(cls)
            obj._load_state(z)
            return obj

    @staticmethod
    def _restore(path, expect, loadUpdater, device):
        device = resolve_device(device)
        with zipfile.ZipFile(path) as zf:
            names = set(zf.namelist())
            mtype = zf.read("modelType").decode()
            if mtype != expect:
                raise ValueError(f"model file holds a {mtype}, not {expect}")
            stored = {name: json.loads(zf.read(name)) if name in names
                      else {} for name in ("paramDtypes.json",
                                           "updaterDtypes.json")}
            text = zf.read("configuration.json").decode()
            if mtype == "ComputationGraph":
                conf = ComputationGraphConfiguration.from_json(text)
                arrays = {kind: {name: {} for name in conf.nodes}
                          for kind in ("p", "s")}
                model = ComputationGraph(conf, device=device)
            else:
                conf = MultiLayerConfiguration.from_json(text)
                arrays = {kind: [{} for _ in conf.layers]
                          for kind in ("p", "s")}
                model = MultiLayerNetwork(conf, device=device)
            npz = np.load(io.BytesIO(zf.read("params.npz")))
            for key in npz.files:
                parts = key.split(_SEP)
                if len(parts) not in (3, 4):
                    raise ValueError(f"params.npz key {key!r} has "
                                     f"{len(parts)} parts, not 3 or 4")
                kind, owner, *path = parts
                if kind not in arrays:
                    raise ValueError(f"params.npz key {key!r} is neither "
                                     f"a parameter nor a layer state")
                group = arrays[kind][owner if mtype == "ComputationGraph"
                                     else int(owner)]
                for name in path[:-1]:   # a nested group
                    group = group.setdefault(name, {})
                group[path[-1]] = _decoded(
                    npz[key], stored["paramDtypes.json"].get(key))
            model.init(params_from_numpy(conf, arrays["p"], device))
            model._states = states_from_numpy(conf, arrays["s"], device)
            if loadUpdater and "updaterState.npz" in names:
                data = np.load(io.BytesIO(zf.read("updaterState.npz")))
                n_leaves = len(tree_leaves(model._opt_states))
                if len(data.files) != n_leaves:
                    raise ValueError(
                        f"updaterState.npz holds {len(data.files)} arrays; "
                        f"the configuration's updaters have {n_leaves}")
                dtype = conf.precision_policy.param_torch
                leaves = (tensor_from_numpy(_decoded(
                    data[str(i)], stored["updaterDtypes.json"].get(str(i))),
                    dtype, device) for i in range(n_leaves))
                model._opt_states = tree_fill(model._opt_states, leaves)
                ts = json.loads(zf.read("trainingState.json"))
                model._iteration = ts["iteration"]
                model._epoch = ts["epoch"]
                if ts.get("lossScale") and model._prec_state:
                    model._prec_state = {
                        k: torch.tensor(v, dtype=model._prec_state[k].dtype,
                                        device=device)
                        for k, v in ts["lossScale"].items()}
        return model

    @staticmethod
    def restoreMultiLayerNetwork(path, loadUpdater: bool = True,
                                 device=None):
        """The network saved at ``path``, on ``device`` ("cuda" unless the
        caller names another), with its updater state and training
        counters when the zip holds them and ``loadUpdater``."""
        return ModelSerializer._restore(path, "MultiLayerNetwork",
                                        loadUpdater, device)

    @staticmethod
    def restoreComputationGraph(path, loadUpdater: bool = True,
                                device=None):
        """The graph saved at ``path``, as ``restoreMultiLayerNetwork``."""
        return ModelSerializer._restore(path, "ComputationGraph",
                                        loadUpdater, device)
