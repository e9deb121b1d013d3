"""Parameter trees: the reference's list-of-``{"w", "b"}`` layout."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over list-of-dict trees of one structure."""
    return [{key: fn(leaf, *(other[i][key] for other in rest))
             for key, leaf in layer.items()}
            for i, layer in enumerate(tree)]

