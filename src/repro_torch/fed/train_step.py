"""Training and serving step builders for the big-model configs (port of
the reference's ``fed/train_step.py``).

:func:`make_train_step` realizes the FEEL aggregation (eq. (1)) on one
parameter set: per-example weights (the federated B_k masks of the
scheduler's plan) enter the weighted cross-entropy, so the gradient of
the weighted mean IS the paper's Step-3 aggregate.  Optional
``compress_uplink`` applies SBC to the gradients before the optimizer —
the paper's Step-2 compression — with the error-feedback residual
carried in ``TrainState.residual``.

Losses in :func:`weighted_ce` and :func:`make_loss_fn` (the weighted CE
plus the MoE blocks' load-balance loss, as the reference's) are per
parameter copy: ``params`` is a stack of N sets and the batch's tokens,
labels and weights are (N, B, S), so one call gives the (N,) losses of N
devices (or rows), each over its own examples with its own denominator
(the FEEL engines' form).  The train, prefill and serve steps run one set in the
reference's layout (no copy axis) and add a copy axis of 1 inside.

The steps run as they stand on a mesh over a ``torch.distributed``
world, where the state, batch and cache are DTensors (:func:`place_state`,
:func:`repro_torch.launch.sharding.place`): the forward and backward
insert the tensor-parallel collectives, each gradient is reduced to its
optimizer state's placements (an all-reduce over the data axes, or under
ZeRO-1 — ``state_shardings_zero1`` — a reduce-scatter), the update runs
on those shards, and the parameters come back in their own layout (an
all-gather under ZeRO-1), as XLA lowers the reference's jitted step.
The weighted CE over data-split rows reduces across ranks.  Plain
tensors that meet DTensors there (masks, positions) count as replicated.

:func:`input_specs` gives the reference's abstract inputs of an (arch,
shape) pair as tensors on the ``meta`` device.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.compression.sbc import sbc_uplink
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import sharding as shd
from repro_torch.models import sharded
from repro_torch.models.model import (Runtime, _one_copy, decode_step,
                                      forward, init_cache)
from repro_torch.optim import Optimizer
from repro_torch.tree import (register_node, tree_leaves, tree_map,
                              tree_unflatten)


@register_node
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
    weights (N, B, S) → (N,); audio's logits (N, B, S, n_cb, V) and
    labels (N, B, S, n_cb) sum the codebooks' losses at each position.
    eq. (1): Σ_k B_k·ḡ_k / Σ B_k equals Σ_i w_i·g_i / Σ w_i.  The
    denominator is ``max(Σw, 1e-6)``, so a device with all-zero weights
    has loss 0 and an exact zero gradient."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if cfg.n_codebooks > 1:
        nll = nll.sum(-1)                       # sum codebook losses
    dims = tuple(range(1, nll.dim()))
    denom = torch.clamp(weights.sum(dims), min=1e-6)
    return (nll * weights).sum(dims) / denom


def _total_and_ce(cfg: ArchConfig, rt: Runtime):
    """``fn(params, batch) -> (CE + aux, CE)``, each (N,)."""
    def fn(params, batch):
        logits, aux = forward(cfg, params, batch["tokens"],
                              prefix_embeds=batch.get("prefix"), rt=rt)
        ce = weighted_ce(cfg, logits, batch["labels"], batch["weights"])
        return ce + aux, ce

    return fn


def make_loss_fn(cfg: ArchConfig, rt: Runtime):
    """``loss_fn(params, batch)`` → (N,): the weighted CE plus the MoE
    load-balance loss (0 for the other families), the objective the
    reference's ``make_loss_fn`` differentiates."""
    total_and_ce = _total_and_ce(cfg, rt)
    return lambda params, batch: total_and_ce(params, batch)[0]


def _leaf_state(state, like, i: int):
    """Leaf ``i``'s slice of an optimizer state: every subtree shaped like
    the parameters (``like``) gives its i-th leaf; anything else (AdamW's
    step count) is shared by all leaves and passed whole."""
    if _same_structure(state, like):
        return tree_leaves(state)[i]
    if isinstance(state, dict):
        return {k: _leaf_state(v, like, i) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_leaf_state(v, like, i) for v in state)
    return state


def _same_structure(a, b) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return (sorted(a) == sorted(b)
                and all(_same_structure(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same_structure(x, y) for x, y in zip(a, b)))
    return not isinstance(a, (dict, list, tuple)) and not isinstance(
        b, (dict, list, tuple))


def _write_state(state, new, like, i: int, shared: list):
    """Copy leaf ``i``'s new optimizer state into ``state`` in place;
    the shared parts' new values are collected in ``shared`` (written
    once every leaf has read the old ones)."""
    if _same_structure(state, like):
        tree_leaves(state)[i].copy_(new)
    elif isinstance(state, dict):
        for k in state:
            _write_state(state[k], new[k], like, i, shared)
    elif isinstance(state, (list, tuple)):
        for old, nw in zip(state, new):
            _write_state(old, nw, like, i, shared)
    elif i == 0:
        shared.append((state, new))


def apply_in_place(opt: Optimizer, params, grads: list, state, lr):
    """One optimizer step written into ``params`` and ``state``, one leaf
    at a time: ``opt.update`` (functional) on leaf i alone, its result
    copied into the leaf and its state, and the gradient leaf dropped
    from ``grads`` — so one leaf's update is alive at once, not a second
    copy of the model and its state.  The same arithmetic as the
    reference's ``apply_updates(params, opt.update(...))``.  On DTensors
    an update in other placements than its parameter's (ZeRO-1's
    shards) is brought to the parameter's (an all-gather) before it is
    added."""
    shared = []
    for i, p in enumerate(tree_leaves(params)):
        upd, new = opt.update(grads[i], _leaf_state(state, params, i), p, lr)
        upd = upd.to(p.dtype)
        if sharded.is_dtensor(upd) and upd.placements != p.placements:
            upd = upd.redistribute(p.device_mesh, p.placements)
        p.add_(upd)
        _write_state(state, new, params, i, shared)
        grads[i] = None
        del upd, new
    for old, new in shared:
        old.copy_(new)


def make_train_step(cfg: ArchConfig, rt: Runtime, opt: Optimizer,
                    compress_uplink: bool = False,
                    compress_ratio: float = 0.005):
    """``train_step(state, batch, lr) -> (state, metrics)`` on one
    parameter set; ``batch`` holds ``tokens`` and ``labels`` (B, S)
    integers and ``weights`` (B, S) float32, ``lr`` a float.

    The step updates the parameters, the optimizer state and the residual
    IN PLACE, as a donated jit buffer would be on the reference's
    accelerator, and returns the same tensors in a new ``TrainState`` with
    ``step + 1``; a caller that needs the old values clones them first.
    Gradients come from ``torch.autograd``; with ``compress_uplink`` they
    go through :func:`sbc_uplink` (a residual of None starts from zeros)
    and the optimizer steps on the approximation.  ``metrics``: ``loss``
    (the weighted CE), ``total_loss`` (CE + the MoE load-balance loss,
    which the gradients are of) and ``grad_norm`` (of the gradients the
    optimizer took), 0-d tensors on the parameters' device."""
    total_and_ce = _total_and_ce(cfg, rt)

    def train_step(state: TrainState, batch, lr):
        leaves = tree_leaves(state.params)
        on_mesh = sharded.is_dtensor(leaves[0])
        if on_mesh and compress_uplink:
            raise NotImplementedError(
                "compress_uplink on a mesh of several devices is not "
                "ported; SBC runs on one card")
        with _on_mesh(on_mesh), torch.enable_grad():
            req = [p.detach().requires_grad_() for p in leaves]
            views = _one_copy(tree_unflatten(state.params, req))
            total, ce = total_and_ce(views, _one_copy(batch))
            # the one copy's loss: a sum of one on DTensors, whose select
            # has no sharded backward
            grads = list(torch.autograd.grad(
                total.sum() if on_mesh else total[0], req))
        total, loss = total[0].detach(), ce[0].detach()
        del req, views
        residual = state.residual
        if compress_uplink:     # the gradients become their approximation
            _, residual = sbc_uplink(tree_unflatten(state.params, grads),
                                     compress_ratio, residual)
        with _on_mesh(on_mesh):
            if on_mesh:
                grads = [g.redistribute(g.device_mesh,
                                        _grad_layout(state, i, p))
                         for i, (g, p) in enumerate(zip(grads, leaves))]
            gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
            with torch.no_grad():
                apply_in_place(opt, state.params, grads, state.opt, lr)
        metrics = {"loss": loss, "total_loss": total, "grad_norm": gnorm}
        if on_mesh:
            metrics = {k: v.full_tensor() for k, v in metrics.items()}
        return TrainState(state.params, state.opt, state.step + 1,
                          residual), metrics

    return train_step


def make_multi_train_step(cfg: ArchConfig, rt: Runtime, opt: Optimizer,
                          compress_uplink: bool = False,
                          compress_ratio: float = 0.005):
    """T periods of :func:`make_train_step` (the reference scans them; a
    Python loop here).  Call as ``many(state, batches, lrs)``, every leaf
    of ``batches`` with a leading T axis and ``lrs`` (T,); returns the
    final state and the per-period metrics stacked (T,).  Under
    ``compress_uplink`` a residual of None is materialized as zeros
    before the first period, as the reference does for its scan carry.
    The state is updated in place, as in :func:`make_train_step`."""
    step = make_train_step(cfg, rt, opt, compress_uplink, compress_ratio)

    def many(state: TrainState, batches, lrs):
        if compress_uplink and state.residual is None:
            state = TrainState(state.params, state.opt, state.step,
                               zero_residual(state.params))
        per = []
        for t in range(len(lrs)):
            state, metrics = step(state, tree_map(lambda b: b[t], batches),
                                  float(lrs[t]))
            per.append(metrics)
        return state, {k: torch.stack([m[k] for m in per]) for k in per[0]}

    return many


def make_prefill_step(cfg: ArchConfig, rt: Runtime):
    def prefill(params, batch):
        prefix = batch.get("prefix")
        with _on_mesh(sharded.is_dtensor(batch["tokens"])):
            return forward(cfg, _one_copy(params), batch["tokens"][None],
                           prefix_embeds=(None if prefix is None
                                          else prefix[None]),
                           rt=rt)[0][0]

    return prefill


def make_serve_step(cfg: ArchConfig, rt: Runtime):
    def serve(params, cache, tokens):
        with _on_mesh(sharded.is_dtensor(tokens)):
            return decode_step(cfg, params, cache, tokens, rt=rt)

    return serve


def _on_mesh(on: bool):
    """Plain tensors (masks, positions, ids) that meet DTensors count as
    replicated inside a step on a mesh."""
    if not on:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _grad_layout(state: TrainState, i: int, p) -> tuple:
    """The placements leaf i's gradient is reduced to: its optimizer
    state's (ZeRO-1's shards over the data axes), or its parameter's
    where the optimizer keeps no state of its shape."""
    for t in tree_leaves(_leaf_state(state.opt, state.params, i)):
        if sharded.is_dtensor(t) and t.shape == p.shape:
            return t.placements
    return p.placements


def place_state(params, opt: Optimizer, mesh, *,
                zero1: bool = False) -> TrainState:
    """A fresh ``TrainState`` of ``params`` on ``mesh`` by the reference's
    rules (``state_shardings``, or ``state_shardings_zero1``: the
    optimizer state also split over the data axes): the parameters
    placed (:func:`~repro_torch.launch.sharding.place`: each rank holds
    the same ``params`` and keeps its shards) and the optimizer's zeros
    made straight into their shards."""
    like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), params)
    spec = TrainState(like, opt.init(like), 0)
    rule = shd.state_shardings_zero1 if zero1 else shd.state_shardings
    sh = rule(mesh, spec)
    return TrainState(shd.place(params, sh.params),
                      shd.place_zeros(spec.opt, sh.opt), 0)


# ---------------------------------------------------------------------------
# input specs (meta-device stand-ins: the reference's dry-run contract)
# ---------------------------------------------------------------------------


def input_specs(cfg: ArchConfig, shape: ShapeConfig, rt: Runtime):
    """Abstract inputs of every model input of the given (arch, shape), as
    tensors on the ``meta`` device with the reference's shapes and dtypes.

    Train/prefill: the token batch, (B, S) or (B, S, n_cb) for audio (+
    labels alike and weights (B, S) float32 for train, and the VLM's
    prefix embeddings (B, min(vlm_prefix, S // 2), d) in ``rt.dtype``).
    Decode: one new token per sequence, (B, 1) or (B, 1, n_cb), + the KV
    (MLA: ``ckv``) / SSM cache, allocated
    at ``min(seq_len, window)`` context under a sliding window (the
    documented ``init_cache`` contract: decode only ever addresses
    ``window`` ring-buffer slots)."""
    B, S = shape.global_batch, shape.seq_len
    cb = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    meta = dict(device="meta")
    if shape.mode in ("train", "prefill"):
        batch = {"tokens": torch.empty((B, S) + cb, dtype=torch.int32,
                                       **meta)}
        if cfg.vlm_prefix:
            P = min(cfg.vlm_prefix, S // 2)
            batch["prefix"] = torch.empty((B, P, cfg.d_model),
                                          dtype=rt.dtype, **meta)
        if shape.mode == "train":
            batch["labels"] = torch.empty((B, S) + cb, dtype=torch.int32,
                                          **meta)
            batch["weights"] = torch.empty((B, S), dtype=torch.float32,
                                           **meta)
        return batch
    win = rt.win(cfg)
    ctx = min(S, win) if win else S
    return {"cache": init_cache(cfg, B, ctx, rt, device="meta"),
            "tokens": torch.empty((B, 1) + cb, dtype=torch.int32, **meta)}
