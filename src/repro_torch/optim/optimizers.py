"""Optimizers over parameter trees (port of the reference's
``optim/optimizers.py``): ``Optimizer`` packages ``(init, update)``, and
``update(grads, state, params, lr)`` returns ``(updates, new_state)``
that :func:`apply_updates` adds.

The paper's Step 5 is plain SGD with η scaled ∝ √B; momentum and AdamW
are not ported.  ``lr`` is a scalar or a tensor over the leading (row)
axes of every leaf, so one call steps a whole bucket of rows, each at
its own rate.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.tree import tree_map


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable      # (grads, state, params, lr) -> (updates, state)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def _leading(lr, leaf: torch.Tensor):
    """``lr`` shaped to broadcast over ``leaf``'s trailing axes."""
    if not isinstance(lr, torch.Tensor):
        return lr
    return lr.reshape(lr.shape + (1,) * (leaf.dim() - lr.dim()))


def sgd() -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, lr):
        return tree_map(lambda g: -_leading(lr, g) * g, grads), state

    return Optimizer(init, update)
