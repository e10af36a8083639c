"""Model persistence in the JAX package's ModelSerializer zip.

Counterpart of the single-file half of
``deeplearning4j_tpu/utils/serializer.py``. The zip holds ``modelType``, ``configuration.json`` and ``params.npz``,
whose keys are ``p<SEP>layer<SEP>name`` (parameters) and
``s<SEP>layer<SEP>name`` (layer state) with SEP the unit separator, and
``p<SEP>layer<SEP>group<SEP>name`` for a nested group's leaves
(Bidirectional's ``fwd`` and ``bwd``); with
the updater, ``updaterState.npz`` (the updater state's leaves keyed
"0", "1", ... in ``jax.tree_util.tree_flatten`` order: layers in order,
dict keys sorted at every level, so Adam writes m.R, m.W, m.b, v.R, v.W,
v.b, and under Bidirectional m.bwd.R, ..., m.fwd.b, v.bwd.R, ...) and
``trainingState.json`` (iteration and epoch). A zip written by either
package restores in the other. Sharded checkpoints, normalizers and
bfloat16 parameters come with later slices.
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
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.tree_util import (
    tree_fill, tree_items, tree_leaves)
from deeplearning4j_tpu_torch.utils.convert import params_from_numpy

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


class ModelSerializer:
    @staticmethod
    def writeModel(model, path, saveUpdater: bool = True):
        """Write ``model`` (a MultiLayerNetwork) to the single-file zip at
        ``path``, with its updater state and training counters unless
        ``saveUpdater`` is False."""
        named = {}
        for kind, groups in (("p", model._params), ("s", model._states)):
            for i, group in enumerate(groups):
                for keys, v in tree_items(group):
                    if len(keys) > 2:
                        raise ValueError(
                            f"layer {i}'s {'/'.join(keys)} nests deeper "
                            f"than one group, which the zip's keys cannot "
                            f"hold")
                    named[_SEP.join((kind, str(i), *keys))] = _host(v)
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr("configuration.json", model.conf.to_json())
            zf.writestr("modelType", "MultiLayerNetwork")
            zf.writestr("params.npz", _npz_bytes(named))
            if saveUpdater:
                leaves = tree_leaves(model._opt_states)
                zf.writestr("updaterState.npz", _npz_bytes(
                    {str(i): _host(v) for i, v in enumerate(leaves)}))
                zf.writestr("trainingState.json", json.dumps(
                    {"iteration": model._iteration, "epoch": model._epoch}))

    @staticmethod
    def restoreMultiLayerNetwork(path, loadUpdater: bool = True,
                                 device=None):
        """The network saved at ``path``, on ``device`` ("cuda" unless the
        caller names another), with its updater state and training
        counters when the zip holds them and ``loadUpdater``."""
        device = resolve_device(device)
        with zipfile.ZipFile(path) as zf:
            names = set(zf.namelist())
            mtype = zf.read("modelType").decode()
            if mtype != "MultiLayerNetwork":
                raise ValueError(f"model file holds a {mtype}, not "
                                 f"MultiLayerNetwork")
            if names & {"paramDtypes.json", "updaterDtypes.json"}:
                raise NotImplementedError(
                    "non-native parameter dtypes (paramDtypes.json) come "
                    "with the precision slice")
            conf = MultiLayerConfiguration.from_json(
                zf.read("configuration.json").decode())
            npz = np.load(io.BytesIO(zf.read("params.npz")))
            arrays = [{} for _ in conf.layers]
            for key in npz.files:
                parts = key.split(_SEP)
                if len(parts) not in (3, 4):
                    raise ValueError(f"params.npz key {key!r} has "
                                     f"{len(parts)} parts, not 3 or 4")
                kind, idx, *path = parts
                if kind == "p":
                    group = arrays[int(idx)]
                    for name in path[:-1]:   # a nested group
                        group = group.setdefault(name, {})
                    group[path[-1]] = npz[key]
                elif kind == "s":
                    # the layers ported so far keep no state between fits
                    raise ValueError(f"unexpected layer state {key!r}")
            net = MultiLayerNetwork(conf, device=device)
            net.init(params_from_numpy(conf, arrays, device))
            if loadUpdater and "updaterState.npz" in names:
                data = np.load(io.BytesIO(zf.read("updaterState.npz")))
                n_leaves = len(tree_leaves(net._opt_states))
                if len(data.files) != n_leaves:
                    raise ValueError(
                        f"updaterState.npz holds {len(data.files)} arrays; "
                        f"the configuration's updaters have {n_leaves}")
                leaves = (torch.tensor(data[str(i)], dtype=conf.dtype,
                                       device=device)
                          for i in range(n_leaves))
                net._opt_states = tree_fill(net._opt_states, leaves)
                ts = json.loads(zf.read("trainingState.json"))
                net._iteration = ts["iteration"]
                net._epoch = ts["epoch"]
        return net
