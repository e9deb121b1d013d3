"""Mixture-of-Experts layer with grouped dispatch, group = batch row (port
of the reference's ``models/moe.py``).

Routing positions and the expert buffers are per batch row: a row's
tokens fill buffers (E, C, d), C the per-row capacity.  Two dispatch
impls, as the reference's:

  scatter        — token-choice top-k with per-row capacity: a token's k
                   experts by gate, its slot in each expert's buffer from
                   the running count over the row's (S·K) choices in
                   token-major, k-minor order; a choice at slot >= C is
                   dropped;
  expert_choice  — per row, each expert takes its top-C tokens (Zhou et
                   al. 2022): drop-free.

Shared experts (DeepSeek) and a dense residual FFN (Arctic) ride on top.
Every apply function takes a stack of N parameter copies and activations
(N, B, S, d) (:mod:`.layers`); the experts of all copies run as one
batched product (``nbecd,nedf->nbecf``), never a loop over experts.

On DTensors (a mesh over a ``torch.distributed`` world) the routed part
runs through ``local_map`` (:func:`_routed_local`): each rank takes its
batch rows — split over ``moe_shard_axes``, the reference's constraint
on the expert buffers — and its experts (split over ``"model"`` by the
sharding rules), routes every token over all experts, fills and runs
only its own experts' buffers, and returns a partial sum over
``"model"``, which the block's output pin all-reduces.  Nothing is
replicated to get there.

Top-k is a stable descending sort: on ties the lowest index comes first,
as ``jax.lax.top_k`` (``torch.topk`` orders ties otherwise).  Dispatch
and combine are one-hot products — buffers and outputs gather by a 0/1
matrix — so their values are exact copies and their gradients are plain
batched GEMMs: no scatter-add, so the card is bitwise reproducible.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import sharded
from repro_torch.models.layers import dense_init, ffn, ffn_init, linear

IMPLS = ("scatter", "expert_choice")


def _expert_stack(gen: torch.Generator, cfg: ArchConfig, dtype, out=None):
    """The experts' SwiGLU weights stacked (E, d, f) / (E, f, d), drawn
    expert by expert (w_gate, w_up, w_down each) and copied into ``out``
    (preallocated stacks, e.g. a layer's slot of the model's) or new
    ones: the draw's peak is one expert matrix.  On the meta device
    (shapes only) nothing is drawn."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.n_experts
    if out is None:
        out = {name: torch.empty((E,) + shape, dtype=dtype, device=gen.device)
               for name, shape in (("w_gate", (d, f)), ("w_up", (d, f)),
                                   ("w_down", (f, d)))}
    if gen.device.type == "meta":
        return out
    for e in range(E):
        for name, (d_in, d_out) in (("w_gate", (d, f)), ("w_up", (d, f)),
                                    ("w_down", (f, d))):
            out[name][e].copy_(dense_init(gen, d_in, d_out, dtype))
    return out


def moe_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
             experts=None):
    """Router, experts, then (when configured) the shared experts' FFN of
    width ``d_ff_expert · n_shared`` and the dense residual FFN of width
    ``d_ff``, drawn in that order (the reference's shapes and scales, the
    router at scale 0.1).  ``experts``: preallocated stacks to draw the
    experts into (:func:`_expert_stack`)."""
    m = cfg.moe
    p = {"router": dense_init(gen, cfg.d_model, m.n_experts, dtype,
                              scale=0.1),
         "experts": _expert_stack(gen, cfg, dtype, experts)}
    if m.n_shared:
        p["shared"] = ffn_init(gen, cfg.d_model, m.d_ff_expert * m.n_shared,
                               dtype)
    if m.dense_residual:
        p["dense"] = ffn_init(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def capacity(tokens_per_group: int, cfg: ArchConfig,
             factor: float = 1.25) -> int:
    m = cfg.moe
    c = int(tokens_per_group * m.top_k * factor / m.n_experts)
    return max(4, (c + 3) // 4 * 4)


def top_k(x: torch.Tensor, k: int):
    """The k largest along the last axis, largest first, ties to the
    lowest index (``jax.lax.top_k``'s order): ``(values, indices)``."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _expert_ffn(ex, buf):
    """(N, B, E, C, d) through each copy's stacked experts → (N, B, E, C,
    d), one batched product a matrix."""
    g = F.silu(torch.einsum("nbecd,nedf->nbecf", buf, ex["w_gate"]))
    u = torch.einsum("nbecd,nedf->nbecf", buf, ex["w_up"])
    return torch.einsum("nbecf,nefd->nbecd", g * u, ex["w_down"])


def route_scatter(probs, K: int, C: int):
    """Token-choice routing of probs (N, B, S, E): ``(expert_idx,
    gate_vals, pos, keep)``, each (N, B, S, K) — the top-K experts of
    each token, their gates renormalised to sum 1, each choice's slot in
    its expert's buffer (the count of earlier choices of that expert in
    the row's token-major, k-minor order) and whether the slot is under
    ``C``."""
    gate_vals, expert_idx = top_k(probs, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    E = probs.shape[-1]
    flat = expert_idx.flatten(-2)                              # (N, B, S·K)
    onehot = F.one_hot(flat, E)
    earlier = torch.cumsum(onehot, dim=-2) - onehot
    pos = torch.gather(earlier, -1, flat[..., None])[..., 0]
    pos = pos.reshape(expert_idx.shape)
    return expert_idx, gate_vals, pos, pos < C


def _slots(expert_idx, pos, keep, E: int, C: int, dtype, e0: int = 0):
    """(N, B, S, K, E, C) 0/1: choice (s, k) sits at (expert - e0, slot),
    for the E experts from ``e0`` (a rank's own; all of them by
    default)."""
    mine = keep & (expert_idx >= e0) & (expert_idx < e0 + E)
    slot = torch.where(keep, pos, 0)
    return (F.one_hot(torch.where(mine, expert_idx - e0, 0), E).to(dtype)
            [..., None]
            * F.one_hot(slot, C).to(dtype)[..., None, :]
            * mine.to(dtype)[..., None, None])


def _scatter_routed(experts, cfg: ArchConfig, x, probs, C: int, e0: int = 0):
    """The routed experts' output, for the experts of ``experts`` (the
    ones from ``e0``), and the (N, B, S, E) assignment of every token's
    top-K experts."""
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    expert_idx, gate_vals, pos, keep = route_scatter(probs, K, C)
    where = _slots(expert_idx, pos, keep, experts["w_gate"].shape[1], C,
                   x.dtype, e0)
    # a kept choice lands alone in its slot; a dropped one adds nothing
    buf = torch.einsum("nbskec,nbsd->nbecd", where, x)
    out = _expert_ffn(experts, buf)
    y = torch.zeros_like(x)
    w = (gate_vals * keep).to(x.dtype)
    for k in range(K):
        got = torch.einsum("nbsec,nbecd->nbsd", where[:, :, :, k], out)
        y = y + got * w[..., k, None]
    return y, F.one_hot(expert_idx, E).float().sum(-2)


def _balance(cfg: ArchConfig, probs_mean, picked_mean):
    """The load-balance loss (N,) from the (N, E) means over the rows and
    positions of the router's probabilities and of the picks."""
    E = cfg.moe.n_experts
    return (E * (probs_mean * picked_mean).mean(-1)
            * cfg.moe.load_balance_coef)


def _scatter(params, cfg: ArchConfig, x, probs, C: int):
    y, assign = _scatter_routed(params["experts"], cfg, x, probs, C)
    return y, _balance(cfg, probs.mean((1, 2)), assign.mean((1, 2)))


def route_expert_choice(probs, C: int):
    """Expert-choice routing of probs (N, B, S, E): ``(weights,
    token_idx)``, each (N, B, E, min(S, C)) — each expert's top tokens of
    the row and their probabilities."""
    return top_k(probs.transpose(-1, -2), min(probs.shape[-2], C))


def _expert_choice_routed(experts, cfg: ArchConfig, x, probs, C: int,
                          e0: int = 0):
    """The output of the experts of ``experts`` (the ones from ``e0``),
    each taking its top tokens, and the (N, B, S, E) top-1 picks."""
    E, S = cfg.moe.n_experts, x.shape[2]
    n = experts["w_gate"].shape[1]
    sel_p, sel_idx = route_expert_choice(probs[..., e0:e0 + n], C)
    picks = F.one_hot(sel_idx, S).to(x.dtype)              # (N,B,E,C',S)
    buf = torch.einsum("nbecs,nbsd->nbecd", picks, x)
    out = _expert_ffn(experts, buf) * sel_p.to(x.dtype)[..., None]
    y = torch.einsum("nbecs,nbecd->nbsd", picks, out)
    return y, F.one_hot(probs.argmax(-1), E).float()


def _expert_choice(params, cfg: ArchConfig, x, probs, C: int):
    y, top1 = _expert_choice_routed(params["experts"], cfg, x, probs, C)
    return y, _balance(cfg, probs.mean((1, 2)), top1.mean((1, 2)))


def _routed_local(params, cfg: ArchConfig, x, probs, C: int, impl: str,
                  shard_axes):
    """The routed part on DTensors, each rank its rows and its experts
    (module docstring): ``(y, aux)``, y a partial sum over ``"model"``
    where the experts are split over it.  The rows are split over
    ``shard_axes`` (the batch's own split when empty)."""
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    experts = params["experts"]
    rows = tuple(shard_axes) or sharded.sharded_axes(x, 1)
    mine = sharded.sharded_axes(experts["w_gate"], 1)
    xpl = sharded.placements(x, {1: rows})
    # a token's gradient from this rank's experts alone: a partial sum
    gpl = sharded.placements(x, {1: rows}, partial=mine)
    epl = sharded.placements(experts["w_gate"], {1: mine})
    # an expert's gradient from this rank's rows alone: a partial sum
    egpl = sharded.placements(experts["w_gate"], {1: mine}, partial=rows)
    x, probs = sharded.pin(x, xpl), sharded.pin(probs, xpl)
    routed = (_expert_choice_routed if impl == "expert_choice"
              else _scatter_routed)

    def body(x, probs, w_gate, w_up, w_down):
        e0 = sharded.model_rank(mesh)[0] * w_gate.shape[1] if mine else 0
        ex = {"w_gate": w_gate, "w_up": w_up, "w_down": w_down}
        y, picked = routed(ex, cfg, x, probs, C, e0)
        return y, picked.sum((1, 2))

    y, picked = local_map(
        body, out_placements=(list(gpl),
                              list(sharded.placements(x, {},
                                                      partial=rows))),
        in_placements=(xpl, xpl, epl, epl, epl),
        in_grad_placements=(gpl, gpl, egpl, egpl, egpl),
        device_mesh=mesh)(x, probs, experts["w_gate"], experts["w_up"],
                          experts["w_down"])
    count = x.shape[1] * x.shape[2]
    return y, _balance(cfg, probs.mean((1, 2)), picked / count)


def moe_forward(params, cfg: ArchConfig, x, *, capacity_factor: float = 1.25,
                cap: int = 0, impl: str = "scatter", shard_axes=()):
    """x (N, B, S, d) → (y (N, B, S, d), aux (N,) float32), the
    load-balance loss per copy.  ``cap`` overrides the per-row capacity
    (decode passes S·top_k: drop-free).  ``shard_axes``: the mesh axes
    that carry the rows on DTensors (the reference's constraint on the
    expert buffers; see the module docstring)."""
    if impl not in IMPLS:
        raise ValueError(f"MoE impl {impl!r} not in {IMPLS}")
    m = cfg.moe
    S = x.shape[2]
    C = min(cap or capacity(S, cfg, capacity_factor), S * m.top_k)
    probs = torch.softmax(linear(x, params["router"]).float(), dim=-1)
    if sharded.is_dtensor(x):
        y, aux = _routed_local(params, cfg, x, probs, C, impl, shard_axes)
    else:
        route = _expert_choice if impl == "expert_choice" else _scatter
        y, aux = route(params, cfg, x, probs, C)
    if m.n_shared:
        y = y + ffn(params["shared"], x)
    if m.dense_residual:
        y = y + ffn(params["dense"], x)
    return y, aux
