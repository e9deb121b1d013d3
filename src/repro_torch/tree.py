"""Parameter trees: nested dicts and lists whose leaves are tensors (or
numpy arrays) — the reference's layouts, from feel-mlp's list of
``{"w", "b"}`` to a transformer's nested dicts with stacked layers.

Dict keys are visited in sorted order, as ``jax.tree_util`` does, so
:func:`tree_leaves` lists leaves in the reference's order."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(other[key] for other in rest))
                for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, leaf, *(other[i] for other in rest))
                          for i, leaf in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
