"""Model restore from the JAX package's ModelSerializer zip.

Counterpart of the restore half of ``deeplearning4j_tpu/utils/serializer.py``.
The zip holds ``modelType``, ``configuration.json`` and ``params.npz``,
whose keys are ``p<SEP>layer<SEP>name`` (parameters) and
``s<SEP>layer<SEP>name`` (layer state) with SEP the unit separator. The
updater state and ``writeModel`` come with the training slice.
"""

from __future__ import annotations

import io
import zipfile

import numpy as np

from deeplearning4j_tpu_torch.backend import resolve_device
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.convert import params_from_numpy

_SEP = "\x1f"  # unit separator: cannot appear in layer names


class ModelSerializer:
    @staticmethod
    def restoreMultiLayerNetwork(path, loadUpdater: bool = False,
                                 device=None):
        """The network saved at ``path``, on ``device`` ("cuda" unless the
        caller names another)."""
        if loadUpdater:
            raise NotImplementedError(
                "updater state is restored with the training slice; pass "
                "loadUpdater=False")
        device = resolve_device(device)
        with zipfile.ZipFile(path) as zf:
            names = set(zf.namelist())
            mtype = zf.read("modelType").decode()
            if mtype != "MultiLayerNetwork":
                raise ValueError(f"model file holds a {mtype}, not "
                                 f"MultiLayerNetwork")
            if "paramDtypes.json" in names:
                raise NotImplementedError(
                    "non-native parameter dtypes (paramDtypes.json) come "
                    "with the precision slice")
            conf = MultiLayerConfiguration.from_json(
                zf.read("configuration.json").decode())
            npz = np.load(io.BytesIO(zf.read("params.npz")))
            arrays = [{} for _ in conf.layers]
            for key in npz.files:
                parts = key.split(_SEP)
                if len(parts) != 3:
                    raise NotImplementedError(
                        f"nested parameter groups ({key!r}) belong to layers "
                        f"not ported yet")
                kind, idx, name = parts
                if kind == "p":
                    arrays[int(idx)][name] = npz[key]
                elif kind == "s":
                    # the layers ported so far keep no state
                    raise ValueError(f"unexpected layer state {key!r}")
        net = MultiLayerNetwork(conf, device=device)
        return net.init(params_from_numpy(conf, arrays, device))
