"""The decoder model of the dense transformer and SSM families (port of
the reference's ``models/model.py``) over a padded-vocab embedding, with a
final norm and an untied LM head:

  dense : [ln → GQA → ln → SwiGLU] × L
  ssm   : [ln → mamba2] × L      (the Mamba-2 block, :mod:`.mamba2`)

Parameters follow the reference's layout — ``embed.table``, ``lm_head``,
``final_norm.scale`` and ``layers.*`` stacked over a leading layer axis —
and :func:`forward` takes a stack of N such sets (a leading copy axis on
every leaf, :mod:`.layers`).  The stacked layer axis runs as a Python
loop where the reference scans.  The other families (MoE, hybrid, audio,
VLM) and decode are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

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


# ArchConfig fields whose other values select parts that are not ported
_UNPORTED = ("attn_kind", "moe", "mla", "ssm", "hybrid_every",
             "n_codebooks", "vlm_prefix", "qkv_bias", "ffn_kind",
             "norm_eps")
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
    return {"ln1": rmsnorm_init(cfg.d_model, dtype),
            "attn": attn.gqa_init(gen, cfg, dtype),
            "ln2": rmsnorm_init(cfg.d_model, dtype),
            "ffn": ffn_init(gen, cfg.d_model, cfg.d_ff, dtype,
                            cfg.ffn_kind)}


def _ssm_layer_init(gen, cfg: ArchConfig, dtype):
    return {"ln": rmsnorm_init(cfg.d_model, dtype),
            "mixer": m2.mamba2_init(gen, cfg, dtype)}


_LAYER_INIT = {"dense": _dense_layer_init, "ssm": _ssm_layer_init}


def init(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32):
    """One parameter set, drawn from ``gen`` in this order: embedding
    table, LM head, then per layer the attention projections (q, k, v,
    o) and the FFN (gate, up, down) — or, for the SSM family, the
    mixer's in_proj, conv_w and out_proj.  Same shapes and scales as the
    reference's init, another random stream."""
    _require_ported(cfg)
    params = {"embed": embedding_init(gen, cfg.vocab, cfg.d_model, dtype),
              "lm_head": dense_init(gen, cfg.d_model,
                                    padded_vocab(cfg.vocab), dtype),
              "final_norm": rmsnorm_init(cfg.d_model, dtype)}
    layers = [_LAYER_INIT[cfg.family](gen, cfg, dtype)
              for _ in range(cfg.n_layers)]
    params["layers"] = tree_map(lambda *ls: torch.stack(ls), *layers)
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
                             window=cfg.attn_window, impl=rt.attn_impl)
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
