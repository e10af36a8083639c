"""Tensor-parallel sharding recipes.

Counterpart of ``deeplearning4j_tpu/parallel/sharding.py``. The reference
builds a tree of ``PartitionSpec``\\ s shaped as ``net._params`` and hands
it to ``ShardedTrainer``, and XLA partitions the matmuls over the ``model``
axis. The port's spec is a tuple of axis names or None (``()`` for
replicated), and in one process a spec places nothing and changes no
number (``parallel/__init__.py``); across ranks a ``model`` axis is ROADMAP
queue 1 item 12b.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.parallel.mesh import MODEL_AXIS
from deeplearning4j_tpu_torch.tree_util import tree_map


def replicated_specs(net):
    return [tree_map(lambda _: (), p) for p in net._params]


def alternating_dense_specs(net, axis: str = MODEL_AXIS, axis_size=None):
    """Megatron MLP pattern over a dense stack: even dense layers are
    column-parallel (W [in, out] sharded on out, bias sharded), odd ones
    row-parallel (W sharded on in, bias replicated). Output layers and any
    dim not divisible by axis_size stay replicated."""
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        DenseLayer, OUTPUT_LAYER_TYPES)

    def divisible(dim):
        return axis_size is None or dim % axis_size == 0

    specs = []
    col = True  # start column-parallel
    for i, lr in enumerate(net.layers):
        p = net._params[i]
        if isinstance(lr, DenseLayer) and "W" in p \
                and not isinstance(lr, OUTPUT_LAYER_TYPES):
            w_shape = p["W"].shape
            if col and divisible(w_shape[1]):
                s = {"W": (None, axis)}
                if "b" in p:
                    s["b"] = (axis,)
                col = False
            elif not col and divisible(w_shape[0]):
                s = {"W": (axis, None)}
                if "b" in p:
                    s["b"] = ()
                col = True
            else:
                s = {k: () for k in p}
            specs.append(s)
        else:
            specs.append({k: () for k in p})
    return specs
