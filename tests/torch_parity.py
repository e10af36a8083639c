"""Helpers of the port's layer and network parity tests (not a test file).

Builds one configuration in both packages from the JAX package's JSON,
moves weights between them as numpy, and compares outputs, gradients
and trained state within a relative tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deeplearning4j_tpu.nn.conf.configuration import (
    MultiLayerConfiguration as JaxMLConf)
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JaxNetwork)
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.tree_util import tree_map

FN_RTOL = 1e-5
TRAIN_RTOL = 1e-4


def close(got, want, rtol=FN_RTOL, what="", floor=0.0):
    """Every element within rtol of the largest of ``want`` (and of its
    own), never tighter than ``floor``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=max(rtol * scale, floor), err_msg=what)


def to_np(tree):
    """Numpy copies of a tree of tensors or JAX arrays."""
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return np.array(tree)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def compare_trees(got, want, rtol=FN_RTOL, what="", floor=0.0):
    got, want = dict(leaves(to_np(got))), dict(leaves(to_np(want)))
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for path in want:
        close(got[path], want[path], rtol, f"{what} {path}", floor)


def as_jax(tree):
    return tree_map(jnp.asarray, to_np(tree))


def as_torch(tree, device="cpu"):
    """Tensors on ``device`` of a tree of arrays (no JAX call: the card's
    tests run with JAX stubbed out)."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device),
                    to_np(tree))


def _init_from(layers, params, init):
    """``init()`` with each JAX layer's ``init_params`` returning the
    port's params for it: nothing drawn (drawing compiles a threefry
    kernel for each weight shape, which costs more than the tests)."""
    for lr, p in zip(layers, params):
        lr.init_params = lambda key, dtype=None, p=p: as_jax(p)
    try:
        return init()
    finally:
        for lr in layers:
            lr.__dict__.pop("init_params", None)


def net_pair(jax_conf, seed=0):
    """(port network on the CPU, JAX network) of ``jax_conf``'s JSON, the
    port's JSON asserted equal to it, both on the port's weights (drawn
    from ``seed``), layer states and fresh updater state."""
    text = jax_conf.to_json()
    conf = MultiLayerConfiguration.from_json(text)
    assert conf.to_json() == text
    conf.seed = seed
    port = MultiLayerNetwork(conf, device="cpu").init()
    jconf = JaxMLConf.from_json(text)
    jnet = _init_from(jconf.layers, port._params,
                      JaxNetwork(jconf).init)
    sync(port, jnet)
    return port, jnet


def sync(port, jnet):
    """The JAX network's params, states and updater state set to the
    port's (each step of a comparison from the same state)."""
    jnet._params = as_jax(port._params)
    jnet._states = as_jax(port._states)
    jnet._opt_states = as_jax(port._opt_states)


def layer_grads(jlayer, player, params, x, state=None, training=False,
                seed=0):
    """Each package's output of one layer and the gradients of
    sum(output * r) (r fixed normals) with respect to the params and the
    input, as numpy: ((y, dparams, dx) port, (y, dparams, dx) JAX)."""
    state = {} if state is None else state
    y0, _ = player.apply(as_torch(params), as_torch(state),
                         torch.tensor(x), training)
    r = np.random.default_rng(seed).normal(size=tuple(y0.shape)).astype(
        np.float32)

    def jloss(p, xx):
        y, _ = jlayer.apply(p, as_jax(state), xx, training, None)
        return jnp.sum(y * r), y

    (_, jy), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        as_jax(params), jnp.asarray(x))
    tp = tree_map(lambda t: t.requires_grad_(), as_torch(params))
    tx = torch.tensor(x, requires_grad=True)
    ty, _ = player.apply(tp, as_torch(state), tx, training)
    flat = [v for _, v in leaves(tp)]
    grads = torch.autograd.grad((ty * torch.tensor(r)).sum(), flat + [tx],
                                allow_unused=True)
    # a param the output does not reach has a zero gradient, as in JAX
    gp = {k: torch.zeros_like(v) if g is None else g
          for (k, v), g in zip(leaves(tp), grads[:-1])}
    return (to_np(ty), {k: to_np(v) for k, v in gp.items()},
            to_np(grads[-1])), (to_np(jy), dict(leaves(to_np(jgp))),
                                to_np(jgx))


def check_layer(jlayer, player, params, x, state=None, training=False,
                rtol=FN_RTOL):
    """Output, param gradients and input gradient of one layer to
    ``rtol`` of each array's largest element."""
    (py, pgp, pgx), (jy, jgp, jgx) = layer_grads(jlayer, player, params,
                                                 x, state, training)
    close(py, jy, rtol, f"{type(player).__name__} output")
    assert sorted(pgp) == sorted(jgp)
    for k in jgp:
        close(pgp[k], jgp[k], rtol, f"{type(player).__name__} d{k}")
    close(pgx, jgx, rtol, f"{type(player).__name__} dx")
    return py


def graph_pair(jax_conf, seed=0):
    """``net_pair`` for a ComputationGraphConfiguration: (port graph on
    the CPU, JAX graph), both on the port's weights."""
    from deeplearning4j_tpu.nn.conf.graph_conf import (
        ComputationGraphConfiguration as JaxGraphConf)
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
        ComputationGraphConfiguration)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    text = jax_conf.to_json()
    conf = ComputationGraphConfiguration.from_json(text)
    assert conf.to_json() == text
    assert conf.topo_order == jax_conf.topo_order
    conf.seed = seed
    port = ComputationGraph(conf, device="cpu").init()
    jconf = JaxGraphConf.from_json(text)
    names = [n for n, (node, _) in jconf.nodes.items()
             if hasattr(node, "init_params")]
    jg = _init_from([jconf.nodes[n][0] for n in names],
                    [port._params[n] for n in names], JaxGraph(jconf).init)
    sync(port, jg)
    return port, jg
