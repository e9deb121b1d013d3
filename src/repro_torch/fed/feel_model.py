"""The paper-scale classifier (feel-mlp config): an MLP over 3072-dim
inputs, in the reference's parameter layout — a list of ``{"w", "b"}``
dicts, ``w`` of shape (in, out).

The functions take one parameter set; batched callers (rows × devices)
map them with ``torch.func.vmap``.  ``init`` draws from a CPU
``torch.Generator`` and then moves to ``device``, so one seed gives the
same weights on the CPU and on the GPU.  It is a different random stream
from the reference's ``jax.random`` init; parity tests carry the
reference's weights across with :mod:`repro_torch.interop`.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.feel_mlp import CLASSES, DEPTH, HIDDEN, INPUT_DIM


def init(generator: torch.Generator, hidden: int = HIDDEN,
         classes: int = CLASSES, depth: int = DEPTH,
         input_dim: int = INPUT_DIM, device="cpu"):
    """He-normal weights, zero biases."""
    dims = [input_dim] + [hidden] * (depth - 1) + [classes]
    return [{
        "w": (torch.randn((i, o), generator=generator, dtype=torch.float32)
              * math.sqrt(2.0 / i)).to(device),
        "b": torch.zeros((o,), dtype=torch.float32, device=device),
    } for i, o in zip(dims[:-1], dims[1:])]


def apply(params, x):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def loss_fn(params, x, y, w=None):
    """Weighted cross-entropy; w: per-example weights (eq. (1) masking)."""
    logp = torch.log_softmax(apply(params, x), dim=-1)
    nll = -torch.gather(logp, 1, y[:, None].long())[:, 0]
    if w is None:
        return nll.mean()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1e-9)


def accuracy(params, x, y):
    return (apply(params, x).argmax(-1) == y).to(torch.float32).mean()
