"""Optimizers over parameter trees (port of the reference's
``optim/optimizers.py``): ``Optimizer`` packages ``(init, update)``, and
``update(grads, state, params, lr)`` returns ``(updates, new_state)``
that :func:`apply_updates` adds.

The paper's Step 5 is plain SGD with η scaled ∝ √B; SGD with momentum
and AdamW serve the big-model training driver (``launch.train``).
``lr`` is a scalar or a tensor over the leading (row) axes of every
leaf, so one call steps a whole bucket of rows, each at its own rate.
``update`` is functional: it allocates the updates and the new state
and changes none of its inputs (``fed.train_step`` applies it one leaf
at a time and writes the results in place).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.tree import tree_leaves, tree_map


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


def momentum(beta: float = 0.9, state_dtype=torch.float32) -> Optimizer:
    """SGD with momentum; ``state_dtype=torch.bfloat16`` halves the
    optimizer state's footprint."""
    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                              device=p.device), params)

    def update(grads, state, params, lr):
        new_m = tree_map(lambda m, g: (beta * m.float() + g.float()).to(
            state_dtype), state, grads)
        upd = tree_map(lambda m: -_leading(lr, m) * m.float(), new_m)
        return upd, new_m

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with bias correction; the state is ``{"m", "v", "t"}``, ``t``
    a 0-d int32 step count on the parameters' device."""
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa
                                      device=p.device)
        device = tree_leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads, state, params, lr):
        t = state["t"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g.float().square(),
                     state["v"], grads)
        bc1 = 1 - b1 ** t.float()
        bc2 = 1 - b2 ** t.float()

        def upd(m_, v_, p):
            step = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            return -_leading(lr, step) * step

        return tree_map(upd, m, v, params), {"m": m, "v": v, "t": t}

    return Optimizer(init, update)
