"""The decoder model of the dense transformer and SSM families (port of
the reference's ``models/model.py``) over a padded-vocab embedding, with a
final norm and an untied LM head:

  dense : [ln → GQA → ln → SwiGLU] × L
  ssm   : [ln → mamba2] × L      (the Mamba-2 block, :mod:`.mamba2`)

Parameters follow the reference's layout — ``embed.table``, ``lm_head``,
``final_norm.scale`` and ``layers.*`` stacked over a leading layer axis —
and :func:`forward` takes a stack of N such sets (a leading copy axis on
every leaf, :mod:`.layers`).  The stacked layer axis runs as a Python
loop where the reference scans.

Decode (:func:`init_cache`, :func:`decode_step`) runs one parameter set
in the reference's layout (no copy axis): one token per sequence against
the KV cache (dense) or the conv and SSM states (ssm), all updated in
place, with the shared position ``pos`` a 0-d int32 tensor on the
device, so a decode loop never waits for the card.  The other families
(MoE, hybrid, audio, VLM) are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models.layers import (dense_init, embedding_init, ffn,
                                       ffn_init, linear, padded_vocab,
                                       rmsnorm, rmsnorm_init)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class Runtime:
    """Execution knobs independent of the architecture (the model runs in
    float32)."""
    attn_impl: str = "pallas"      # pallas | naive
    window: Optional[int] = None   # overrides cfg.attn_window when set

    def win(self, cfg: ArchConfig):
        return self.window if self.window is not None else cfg.attn_window


# ArchConfig fields whose other values select parts that are not ported
_UNPORTED = ("attn_kind", "moe", "mla", "ssm", "hybrid_every",
             "n_codebooks", "vlm_prefix", "ffn_kind", "norm_eps")
# the values each ported family takes where it differs from the defaults
# (a class: any instance of it)
_FAMILY_FIELDS = {"dense": {},
                  "ssm": {"attn_kind": "none", "ssm": SSMConfig}}


def _require_ported(cfg: ArchConfig):
    """Refuse a config that asks for what the port does not run, rather
    than run a different model."""
    if cfg.family not in _FAMILY_FIELDS:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet; the PyTorch "
            f"port runs {sorted(_FAMILY_FIELDS)}")
    want = {f.name: f.default for f in fields(ArchConfig)}
    want.update(_FAMILY_FIELDS[cfg.family])
    for name in _UNPORTED:
        got = getattr(cfg, name)
        if got != want[name] and not (isinstance(want[name], type)
                                      and isinstance(got, want[name])):
            raise NotImplementedError(
                f"ArchConfig.{name}={got!r} is not ported yet for family "
                f"{cfg.family!r}; the port runs {name}={want[name]!r}")


def _dense_layer_init(gen, cfg: ArchConfig, dtype):
    return {"ln1": rmsnorm_init(cfg.d_model, dtype, gen.device),
            "attn": attn.gqa_init(gen, cfg, dtype),
            "ln2": rmsnorm_init(cfg.d_model, dtype, gen.device),
            "ffn": ffn_init(gen, cfg.d_model, cfg.d_ff, dtype,
                            cfg.ffn_kind)}


def _ssm_layer_init(gen, cfg: ArchConfig, dtype):
    return {"ln": rmsnorm_init(cfg.d_model, dtype, gen.device),
            "mixer": m2.mamba2_init(gen, cfg, dtype)}


_LAYER_INIT = {"dense": _dense_layer_init, "ssm": _ssm_layer_init}


def init(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32):
    """One parameter set on ``gen``'s device, drawn from ``gen`` in this
    order: embedding table, LM head, then per layer the attention
    projections (q, k, v, o) and the FFN (gate, up, down) — or, for the
    SSM family, the mixer's in_proj, conv_w and out_proj.  Same shapes
    and scales as the reference's init, another random stream.  Each
    layer is drawn and copied into its slot of the stacked leaves, so
    the peak is the model's size plus one layer."""
    _require_ported(cfg)
    params = {"embed": embedding_init(gen, cfg.vocab, cfg.d_model, dtype),
              "lm_head": dense_init(gen, cfg.d_model,
                                    padded_vocab(cfg.vocab), dtype),
              "final_norm": rmsnorm_init(cfg.d_model, dtype, gen.device)}
    first = _LAYER_INIT[cfg.family](gen, cfg, dtype)
    layers = tree_map(lambda t: t.new_empty((cfg.n_layers,) + t.shape),
                      first)
    for i in range(cfg.n_layers):
        layer = first if i == 0 else _LAYER_INIT[cfg.family](gen, cfg, dtype)
        tree_map(lambda stack, t: stack[i].copy_(t), layers, layer)
    params["layers"] = layers
    return params


def _embed(params, cfg: ArchConfig, tokens):
    """Rows of each copy's table, as a one-hot product (N, B, S, d): the
    same values as a gather, with a gradient that is a plain batched GEMM
    (no scatter-add), so it is bitwise reproducible on the card."""
    table = params["embed"]["table"]
    ids = torch.arange(table.shape[1], device=tokens.device)
    return linear((tokens[..., None] == ids).to(table.dtype), table)


def _unembed(params, cfg: ArchConfig, x):
    """Padded-vocab logits; padding ids masked to ``finfo(f32).min``."""
    logits = linear(x, params["lm_head"])
    pv = logits.shape[-1]
    if pv != cfg.vocab:
        mask = torch.arange(pv, device=x.device) < cfg.vocab
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    return logits


def _dense_block(lp, cfg: ArchConfig, x, rt: Runtime):
    x = x + attn.gqa_forward(lp["attn"], cfg, rmsnorm(lp["ln1"], x),
                             window=rt.win(cfg), impl=rt.attn_impl)
    return x + ffn(lp["ffn"], rmsnorm(lp["ln2"], x))


def _ssm_block(lp, cfg: ArchConfig, x, rt: Runtime):
    return x + m2.mamba2_forward(lp["mixer"], cfg, rmsnorm(lp["ln"], x))


_BLOCK = {"dense": _dense_block, "ssm": _ssm_block}


def _layer_params(layers, n_layers: int):
    """Per-layer views of the stacked layer params (layer axis 1, after
    the copy axis); ``unbind`` keeps the gradient one stack per leaf."""
    per_leaf = [leaf.unbind(1) for leaf in tree_leaves(layers)]
    return [tree_unflatten(layers, [u[i] for u in per_leaf])
            for i in range(n_layers)]


def forward(cfg: ArchConfig, params, tokens, *, rt: Runtime = Runtime()):
    """Full-sequence forward of N parameter copies: tokens (N, B, S)
    integers → logits (N, B, S, padded vocab).  The ported families have
    no auxiliary loss, so only the logits are returned."""
    _require_ported(cfg)
    block = _BLOCK[cfg.family]
    x = _embed(params, cfg, tokens)
    for lp in _layer_params(params["layers"], cfg.n_layers):
        x = block(lp, cfg, x, rt)
    return _unembed(params, cfg, rmsnorm(params["final_norm"], x))


# ---------------------------------------------------------------------------
# decode (one token, KV/SSM caches)
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, ctx: int, rt: Runtime = Runtime(),
               device="cpu"):
    """The decode cache, zeroed, on ``device`` (the reference's layout):
    ``pos`` a 0-d int32; dense: ``k``/``v`` (L, B, ctx', Hkv, hd) with
    ``ctx' = min(ctx, window)`` under a window (a ring buffer); ssm:
    ``conv`` (L, B, d_conv-1, CH) and ``ssm`` (L, B, H, P, N) float32."""
    _require_ported(cfg)
    zeros = lambda *shape: torch.zeros(shape, device=device)  # noqa: E731
    c = {"pos": torch.zeros((), dtype=torch.int32, device=device)}
    L = cfg.n_layers
    if cfg.family == "dense":
        win = rt.win(cfg)
        kv_ctx = min(ctx, win) if win else ctx
        c["k"] = zeros(L, batch, kv_ctx, cfg.n_kv_heads, cfg.hd())
        c["v"] = zeros(L, batch, kv_ctx, cfg.n_kv_heads, cfg.hd())
    else:
        _, H, CH = m2.dims(cfg)
        s = cfg.ssm
        c["conv"] = zeros(L, batch, s.d_conv - 1, CH)
        c["ssm"] = zeros(L, batch, H, s.head_dim, s.d_state)
    return c


def _dense_block_decode(lp, cfg: ArchConfig, x, cache, i, pos, rt: Runtime):
    x = x + attn.gqa_decode(lp["attn"], cfg, rmsnorm(lp["ln1"], x),
                            cache["k"][i], cache["v"][i], pos,
                            window=rt.win(cfg), impl=rt.attn_impl)
    return x + ffn(lp["ffn"], rmsnorm(lp["ln2"], x))


def _ssm_block_decode(lp, cfg: ArchConfig, x, cache, i, pos, rt: Runtime):
    return x + m2.mamba2_decode(lp["mixer"], cfg, rmsnorm(lp["ln"], x),
                                cache["conv"][i], cache["ssm"][i])


_BLOCK_DECODE = {"dense": _dense_block_decode, "ssm": _ssm_block_decode}


def _one_copy(tree):
    """Views with a copy axis of 1, for the stacked-copy apply functions."""
    return tree_map(lambda t: t[None], tree)


def decode_step(cfg: ArchConfig, params, cache, tokens, *,
                rt: Runtime = Runtime()):
    """One decode step for the whole batch: tokens (B, 1) integers →
    logits (B, 1, padded vocab).  ``cache`` (from :func:`init_cache`) is
    updated in place — layer i's KV slot or states, then ``pos`` advanced
    by one — and returned, as the reference's jitted step donates it."""
    _require_ported(cfg)
    block = _BLOCK_DECODE[cfg.family]
    pos = cache["pos"]
    # a gather, as the reference's _embed: no gradient flows here, so the
    # training path's one-hot product (a pass over the whole table) is not
    # needed
    x = params["embed"]["table"][tokens][None]            # (1, B, 1, d)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = tree_map(lambda t: t[i][None], layers)
        x = block(lp, cfg, x, cache, i, pos, rt)
    x = rmsnorm(_one_copy(params["final_norm"]), x)
    logits = _unembed(_one_copy({"lm_head": params["lm_head"]}), cfg, x)[0]
    cache["pos"] = pos + 1
    return logits, cache
