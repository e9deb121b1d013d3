"""The big-model train step's pieces (port of the reference's
``fed/train_step.py``): the train state and the weighted next-token
cross-entropy behind the FEEL aggregation (eq. (1)).

Losses are per parameter copy: ``params`` is a stack of N sets and the
batch's tokens, labels and weights are (N, B, S), so one call gives the
(N,) losses of N devices (or rows), each over its own examples with its
own denominator.

:func:`make_serve_step` is the one-token decode step (the reference's
``make_serve_step``) over one parameter set.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import Runtime, decode_step, forward
from repro_torch.tree import tree_map


@dataclass
class TrainState:
    params: Any
    opt: Any
    step: int
    residual: Any = None   # SBC error-feedback accumulator


def zero_residual(params):
    """A zeroed error-feedback accumulator matching ``params``' structure."""
    return tree_map(torch.zeros_like, params)


def weighted_ce(cfg: ArchConfig, logits, labels, weights):
    """Weighted next-token CE per copy: logits (N, B, S, V), labels and
    weights (N, B, S) → (N,).  eq. (1): Σ_k B_k·ḡ_k / Σ B_k equals
    Σ_i w_i·g_i / Σ w_i.  The denominator is ``max(Σw, 1e-6)``, so a
    device with all-zero weights has loss 0 and an exact zero gradient."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    dims = tuple(range(1, nll.dim()))
    denom = torch.clamp(weights.sum(dims), min=1e-6)
    return (nll * weights).sum(dims) / denom


def make_loss_fn(cfg: ArchConfig, rt: Runtime):
    def loss_fn(params, batch):
        logits = forward(cfg, params, batch["tokens"], rt=rt)
        return weighted_ce(cfg, logits, batch["labels"], batch["weights"])

    return loss_fn


def make_serve_step(cfg: ArchConfig, rt: Runtime):
    def serve(params, cache, tokens):
        return decode_step(cfg, params, cache, tokens, rt=rt)

    return serve
