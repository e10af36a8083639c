"""Nested parameter groups: the leaves of dicts, lists and tuples.

The port's stand-in for the part of ``jax.tree_util`` that the JAX package
uses on parameters and updater state. A layer's parameters are a
``{name: Tensor}`` dict, or for a wrapper such as Bidirectional a dict of
such groups (``{"fwd": {...}, "bwd": {...}}``). Leaves come in
``jax.tree_util.tree_leaves`` order: dict keys sorted at every level
(so ``bwd`` before ``fwd``), lists and tuples in order, None skipped.
"""

from __future__ import annotations


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree_util.tree_leaves`` order."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_items(tree, prefix=()):
    """(path, leaf) pairs in leaf order; a path is the tuple of keys (and
    list positions) from the root to the leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def tree_map(fn, tree, *rest):
    """``fn`` on every leaf of ``tree`` (and the leaves at the same places
    of the trees in ``rest``), keeping the structure of ``tree``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def tree_fill(tree, leaves):
    """``tree``'s structure with its leaves taken in leaf order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: tree_fill(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_fill(v, leaves) for v in tree)
    return None if tree is None else next(leaves)


def is_nested(group) -> bool:
    """Whether a layer's ``{name: ...}`` group holds groups of its own."""
    return isinstance(group, dict) and any(isinstance(v, dict)
                                           for v in group.values())


def flatten_group(group) -> dict:
    """A nested group as one flat dict keyed by leaf path (the same leaf
    objects, so an in-place op on a value writes into the group)."""
    return dict(tree_items(group))


def unflatten_group(flat) -> dict:
    """The inverse of ``flatten_group``: nested dicts from path keys."""
    out = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out
