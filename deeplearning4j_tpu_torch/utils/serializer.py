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
``trainingState.json`` (iteration and epoch). A zip written by either
package restores in the other. A layer state's leaf keeps the dtype of
the layer's ``init_state`` (OCNN's int32 ``seen``); a wrapper's
(FrozenLayer, MaskZeroLayer) params and state are its inner layer's.
Sharded checkpoints, normalizers and bfloat16 parameters come with later
slices.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend import resolve_device
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.tree_util import (
    tree_fill, tree_items, tree_leaves)
from deeplearning4j_tpu_torch.utils.convert import (
    params_from_numpy, states_from_numpy)

_SEP = "\x1f"  # unit separator: cannot appear in layer names


def _host(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:   # numpy has no bfloat16
        raise NotImplementedError(
            "writing bfloat16 arrays (paramDtypes.json) comes with the "
            "precision slice")
    return t.detach().cpu().numpy()


def _npz_bytes(named) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **named)
    return buf.getvalue()


def _groups(groups):
    """(key, group) pairs: a network's layers by index, a graph's nodes by
    name."""
    return groups.items() if isinstance(groups, dict) else enumerate(groups)


class ModelSerializer:
    @staticmethod
    def writeModel(model, path, saveUpdater: bool = True):
        """Write ``model`` (a MultiLayerNetwork or a ComputationGraph) to
        the single-file zip at ``path``, with its updater state and
        training counters unless ``saveUpdater`` is False. A graph's
        arrays are keyed by node name."""
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
                    named[_SEP.join((kind, str(owner), *keys))] = _host(v)
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr("configuration.json", model.conf.to_json())
            zf.writestr("modelType", "ComputationGraph" if is_graph
                        else "MultiLayerNetwork")
            zf.writestr("params.npz", _npz_bytes(named))
            if saveUpdater:
                leaves = tree_leaves(model._opt_states)
                zf.writestr("updaterState.npz", _npz_bytes(
                    {str(i): _host(v) for i, v in enumerate(leaves)}))
                zf.writestr("trainingState.json", json.dumps(
                    {"iteration": model._iteration, "epoch": model._epoch}))

    @staticmethod
    def _restore(path, expect, loadUpdater, device):
        device = resolve_device(device)
        with zipfile.ZipFile(path) as zf:
            names = set(zf.namelist())
            mtype = zf.read("modelType").decode()
            if mtype != expect:
                raise ValueError(f"model file holds a {mtype}, not {expect}")
            if names & {"paramDtypes.json", "updaterDtypes.json"}:
                raise NotImplementedError(
                    "non-native parameter dtypes (paramDtypes.json) come "
                    "with the precision slice")
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
                group[path[-1]] = npz[key]
            model.init(params_from_numpy(conf, arrays["p"], device))
            model._states = states_from_numpy(conf, arrays["s"], device)
            if loadUpdater and "updaterState.npz" in names:
                data = np.load(io.BytesIO(zf.read("updaterState.npz")))
                n_leaves = len(tree_leaves(model._opt_states))
                if len(data.files) != n_leaves:
                    raise ValueError(
                        f"updaterState.npz holds {len(data.files)} arrays; "
                        f"the configuration's updaters have {n_leaves}")
                leaves = (torch.tensor(data[str(i)], dtype=conf.dtype,
                                       device=device)
                          for i in range(n_leaves))
                model._opt_states = tree_fill(model._opt_states, leaves)
                ts = json.loads(zf.read("trainingState.json"))
                model._iteration = ts["iteration"]
                model._epoch = ts["epoch"]
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
