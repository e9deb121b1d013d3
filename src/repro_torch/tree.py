"""Parameter trees: nested dicts and lists whose leaves are tensors (or
numpy arrays) — the reference's layouts, from feel-mlp's list of
``{"w", "b"}`` to a transformer's nested dicts with stacked layers.

Dict keys are visited in sorted order, as ``jax.tree_util`` does, so
:func:`tree_leaves` lists leaves in the reference's order.
:func:`tree_map_with_path` also gives each leaf its key path, the string
the reference's ``jax.tree_util.keystr`` writes (:func:`keystr`), and
walks the dataclasses registered with :func:`register_node`
(``fed.train_step.TrainState``) as the reference walks its registered
pytree nodes."""
from __future__ import annotations

import dataclasses


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


# ---------------------------------------------------------------------------
# key paths: each leaf with the string ``jax.tree_util.keystr`` gives it in
# the reference, so rules written over those strings read the same leaves
# ---------------------------------------------------------------------------

# dataclasses whose instances are inner nodes of a tree, their fields the
# children in declared order (the reference registers such a class with
# ``jax.tree_util.register_pytree_node``, which keys them by flat index)
_NODE_TYPES = set()


def register_node(cls):
    """Make instances of the dataclass ``cls`` inner nodes of a tree for
    the path functions below (``[<flat index i>]`` for field i); returns
    ``cls``."""
    _NODE_TYPES.add(cls)
    return cls


def keystr(path: tuple) -> str:
    """A key path as the reference's ``jax.tree_util.keystr`` writes it:
    ``['layers']['attn']['wq']`` for dict keys, ``[0]`` for list and
    tuple items, ``[<flat index 1>]`` for a registered node's field."""
    return "".join(path)


def _children(tree):
    """``(key, child)`` pairs of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{key!r}]", tree[key]) for key in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", child) for i, child in enumerate(tree)]
    if type(tree) in _NODE_TYPES:
        return [(f"[<flat index {i}>]", getattr(tree, f.name))
                for i, f in enumerate(dataclasses.fields(tree))]
    return None


def tree_map_with_path(fn, tree, *rest, path: tuple = ()):
    """Apply ``fn(path, leaf, *others)`` leafwise over trees of one
    structure, ``path`` the leaf's key tuple (:func:`keystr` joins it).
    ``None`` is an empty subtree, as in the reference: it stays None and
    ``fn`` never sees it."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(path, tree, *rest)
    others = [[child for _, child in _children(other)] for other in rest]
    out = [tree_map_with_path(fn, child, *(o[i] for o in others),
                              path=path + (key,))
           for i, (key, child) in enumerate(kids)]
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), out))
    if isinstance(tree, (list, tuple)):
        return type(tree)(out)
    return type(tree)(*out)


def tree_leaves_with_path(tree) -> list:
    """``(path, leaf)`` pairs in :func:`tree_map_with_path`'s order."""
    out = []
    tree_map_with_path(lambda p, leaf: out.append((p, leaf)), tree)
    return out
