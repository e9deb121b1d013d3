"""The decoder model of the dense, VLM, audio, SSM and hybrid families
(port of the reference's ``models/model.py``) over a padded-vocab
embedding, with a final norm and an untied LM head:

  dense / vlm : [ln → GQA → ln → FFN] × L   (FFN: SwiGLU or the GELU MLP)
  audio       : the same, over the sum of ``n_codebooks`` embeddings, with
                one LM head a codebook
  ssm         : [ln → mamba2] × L      (the Mamba-2 block, :mod:`.mamba2`)
  hybrid      : L mamba2 layers in segments of ``hybrid_every``; after
                each segment ONE shared attention + FFN block (the same
                weights every time, ``shared_attn``) runs

Parameters follow the reference's layout — ``embed.table``, ``lm_head``,
``final_norm.scale``, ``layers.*`` stacked over a leading layer axis and,
for the hybrid, ``shared_attn`` with no layer axis — and :func:`forward`
takes a stack of N such sets (a leading copy axis on every leaf,
:mod:`.layers`).  The stacked layer axis runs as a Python loop where the
reference scans.  A VLM's pre-projected patch embeddings enter
:func:`forward` as ``prefix_embeds`` and replace the first positions.

Decode (:func:`init_cache`, :func:`decode_step`) runs one parameter set
in the reference's layout (no copy axis): one token per sequence (one a
codebook for audio) against the KV cache (dense, vlm, audio; the
hybrid's one a segment) and the conv and SSM states (ssm, hybrid), all
updated in place, with the shared position ``pos`` a 0-d int32 tensor on
the device, so a decode loop never waits for the card.  MoE and MLA are
not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models.layers import (FFN_KINDS, dense_init,
                                       embedding_init, ffn, ffn_init, linear,
                                       padded_vocab, rmsnorm, rmsnorm_init)
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
# the values each ported family admits where it differs from the defaults:
# a class (any instance of it), a tuple (any of its members) or a value
_FAMILY_FIELDS = {"dense": {"ffn_kind": FFN_KINDS},
                  "vlm": {"ffn_kind": FFN_KINDS, "vlm_prefix": int},
                  "audio": {"ffn_kind": FFN_KINDS, "n_codebooks": int},
                  "ssm": {"attn_kind": "none", "ssm": SSMConfig},
                  "hybrid": {"ffn_kind": FFN_KINDS, "ssm": SSMConfig,
                             "hybrid_every": int}}
# the families whose layers are dense blocks
_DENSE = ("dense", "vlm", "audio")


def _admits(want, got) -> bool:
    if isinstance(want, type):
        return isinstance(got, want)
    if isinstance(want, tuple):
        return got in want
    return got == want


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
        if not _admits(want[name], getattr(cfg, name)):
            raise NotImplementedError(
                f"ArchConfig.{name}={getattr(cfg, name)!r} is not ported "
                f"yet for family {cfg.family!r}; the port runs "
                f"{name}={want[name]!r}")
    if cfg.family == "hybrid" and not (
            cfg.hybrid_every >= 1 and cfg.n_layers % cfg.hybrid_every == 0):
        raise ValueError(f"hybrid_every={cfg.hybrid_every} must divide "
                         f"n_layers={cfg.n_layers}")


def _dense_layer_init(gen, cfg: ArchConfig, dtype):
    return {"ln1": rmsnorm_init(cfg.d_model, dtype, gen.device),
            "attn": attn.gqa_init(gen, cfg, dtype),
            "ln2": rmsnorm_init(cfg.d_model, dtype, gen.device),
            "ffn": ffn_init(gen, cfg.d_model, cfg.d_ff, dtype,
                            cfg.ffn_kind)}


def _ssm_layer_init(gen, cfg: ArchConfig, dtype):
    return {"ln": rmsnorm_init(cfg.d_model, dtype, gen.device),
            "mixer": m2.mamba2_init(gen, cfg, dtype)}


_LAYER_INIT = {"dense": _dense_layer_init, "vlm": _dense_layer_init,
               "audio": _dense_layer_init, "ssm": _ssm_layer_init,
               "hybrid": _ssm_layer_init}


def _codebook_stack(draw, n_codebooks: int):
    """``n_codebooks`` draws stacked on a leading axis, or the one draw."""
    if n_codebooks == 1:
        return draw()
    return torch.stack([draw() for _ in range(n_codebooks)])


def init(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32):
    """One parameter set on ``gen``'s device, drawn from ``gen`` in this
    order: the embedding table (one a codebook), the LM head (one a
    codebook), then per layer the attention projections (q, k, v, o) and
    the FFN (gate, up, down; up, down for the GELU MLP) — or, for the SSM
    and hybrid families, the mixer's in_proj, conv_w and out_proj — and
    last the hybrid's shared attention block.  Same shapes and scales as
    the reference's init, another random stream.  Each layer is drawn
    and copied into its slot of the stacked leaves, so the peak is the
    model's size plus one layer."""
    _require_ported(cfg)
    pv, ncb = padded_vocab(cfg.vocab), cfg.n_codebooks
    params = {
        "embed": {"table": _codebook_stack(lambda: embedding_init(
            gen, cfg.vocab, cfg.d_model, dtype)["table"], ncb)},
        "lm_head": _codebook_stack(lambda: dense_init(
            gen, cfg.d_model, pv, dtype), ncb),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, gen.device)}
    layer_init = _LAYER_INIT[cfg.family]
    first = layer_init(gen, cfg, dtype)
    layers = tree_map(lambda t: t.new_empty((cfg.n_layers,) + t.shape),
                      first)
    for i in range(cfg.n_layers):
        layer = first if i == 0 else layer_init(gen, cfg, dtype)
        tree_map(lambda stack, t: stack[i].copy_(t), layers, layer)
    params["layers"] = layers
    if cfg.family == "hybrid":
        params["shared_attn"] = _dense_layer_init(gen, cfg, dtype)
    return params


def _embed(params, cfg: ArchConfig, tokens):
    """Rows of each copy's table, as a one-hot product (N, B, S, d): the
    same values as a gather, with a gradient that is a plain batched GEMM
    (no scatter-add), so it is bitwise reproducible on the card.  Audio
    tokens (N, B, S, n_cb) take the sum of the codebooks' rows, in
    codebook order (MusicGen §3.1)."""
    table = params["embed"]["table"]
    ids = torch.arange(table.shape[-2], device=tokens.device)
    if cfg.n_codebooks == 1:
        return linear((tokens[..., None] == ids).to(table.dtype), table)
    x = 0
    for i in range(cfg.n_codebooks):
        x = x + linear((tokens[..., i, None] == ids).to(table.dtype),
                       table[:, i])
    return x


def _unembed(params, cfg: ArchConfig, x):
    """Padded-vocab logits, (N, B, S, pv) or (N, B, S, n_cb, pv) for
    audio; padding ids masked to ``finfo(f32).min``."""
    head = params["lm_head"]
    if cfg.n_codebooks == 1:
        logits = linear(x, head)
    else:
        logits = torch.stack([linear(x, head[:, i])
                              for i in range(cfg.n_codebooks)], dim=-2)
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


def _layer_params(layers, n_layers: int):
    """Per-layer views of the stacked layer params (layer axis 1, after
    the copy axis); ``unbind`` keeps the gradient one stack per leaf."""
    per_leaf = [leaf.unbind(1) for leaf in tree_leaves(layers)]
    return [tree_unflatten(layers, [u[i] for u in per_leaf])
            for i in range(n_layers)]


def _ends_segment(cfg: ArchConfig, i: int) -> bool:
    """Whether the hybrid's shared block runs after layer ``i``."""
    return cfg.family == "hybrid" and (i + 1) % cfg.hybrid_every == 0


def forward(cfg: ArchConfig, params, tokens, *, prefix_embeds=None,
            rt: Runtime = Runtime()):
    """Full-sequence forward of N parameter copies: tokens (N, B, S)
    integers, or (N, B, S, n_cb) for audio → logits (N, B, S, padded
    vocab), or (N, B, S, n_cb, padded vocab).  ``prefix_embeds`` (N, B,
    P, d), a VLM's pre-projected patch embeddings, replace the first P
    positions.  The ported families have no auxiliary loss, so only the
    logits are returned.  The hybrid's shared block runs after every
    ``hybrid_every`` SSM layers with the same weights, so its gradient is
    the sum over its applications."""
    _require_ported(cfg)
    block = _dense_block if cfg.family in _DENSE else _ssm_block
    x = _embed(params, cfg, tokens)
    if prefix_embeds is not None:
        P = prefix_embeds.shape[2]
        x = torch.cat([prefix_embeds.to(x.dtype), x[:, :, P:]], dim=2)
    for i, lp in enumerate(_layer_params(params["layers"], cfg.n_layers)):
        x = block(lp, cfg, x, rt)
        if _ends_segment(cfg, i):
            x = _dense_block(params["shared_attn"], cfg, x, rt)
    return _unembed(params, cfg, rmsnorm(params["final_norm"], x))


# ---------------------------------------------------------------------------
# decode (one token, KV/SSM caches)
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, ctx: int, rt: Runtime = Runtime(),
               device="cpu"):
    """The decode cache, zeroed, on ``device`` (the reference's layout):
    ``pos`` a 0-d int32; dense, vlm, audio: ``k``/``v`` (L, B, ctx', Hkv,
    hd) with ``ctx' = min(ctx, window)`` under a window (a ring buffer);
    ssm and hybrid: ``conv`` (L, B, d_conv-1, CH) and ``ssm`` (L, B, H,
    P, N) float32; hybrid also ``k``/``v`` (L / hybrid_every, B, ctx',
    Hkv, hd), one a segment for the shared block."""
    _require_ported(cfg)
    zeros = lambda *shape: torch.zeros(shape, device=device)  # noqa: E731
    c = {"pos": torch.zeros((), dtype=torch.int32, device=device)}
    L = cfg.n_layers
    win = rt.win(cfg)
    kv_ctx = min(ctx, win) if win else ctx
    if cfg.family in ("ssm", "hybrid"):
        _, H, CH = m2.dims(cfg)
        s = cfg.ssm
        c["conv"] = zeros(L, batch, s.d_conv - 1, CH)
        c["ssm"] = zeros(L, batch, H, s.head_dim, s.d_state)
    if cfg.family != "ssm":
        n_kv = L // cfg.hybrid_every if cfg.family == "hybrid" else L
        c["k"] = zeros(n_kv, batch, kv_ctx, cfg.n_kv_heads, cfg.hd())
        c["v"] = zeros(n_kv, batch, kv_ctx, cfg.n_kv_heads, cfg.hd())
    return c


def _dense_block_decode(lp, cfg: ArchConfig, x, cache, i, pos, rt: Runtime):
    x = x + attn.gqa_decode(lp["attn"], cfg, rmsnorm(lp["ln1"], x),
                            cache["k"][i], cache["v"][i], pos,
                            window=rt.win(cfg), impl=rt.attn_impl)
    return x + ffn(lp["ffn"], rmsnorm(lp["ln2"], x))


def _ssm_block_decode(lp, cfg: ArchConfig, x, cache, i, pos, rt: Runtime):
    return x + m2.mamba2_decode(lp["mixer"], cfg, rmsnorm(lp["ln"], x),
                                cache["conv"][i], cache["ssm"][i])


def _one_copy(tree):
    """Views with a copy axis of 1, for the stacked-copy apply functions."""
    return tree_map(lambda t: t[None], tree)


def decode_step(cfg: ArchConfig, params, cache, tokens, *,
                rt: Runtime = Runtime()):
    """One decode step for the whole batch: tokens (B, 1) integers, or
    (B, 1, n_cb) for audio → logits (B, 1, padded vocab), or (B, 1, n_cb,
    padded vocab).  ``cache`` (from :func:`init_cache`) is updated in
    place — layer i's KV slot or states (the hybrid's shared block: segment
    i's KV slot), then ``pos`` advanced by one — and returned, as the
    reference's jitted step donates it."""
    _require_ported(cfg)
    block = (_dense_block_decode if cfg.family in _DENSE
             else _ssm_block_decode)
    pos = cache["pos"]
    # a gather (a sum of gathers over the codebooks), as the reference's
    # _embed: no gradient flows here, so the training path's one-hot
    # product (a pass over the whole table) is not needed
    table = params["embed"]["table"]
    if cfg.n_codebooks == 1:
        x = table[tokens]
    else:
        x = sum(table[i][tokens[..., i]] for i in range(cfg.n_codebooks))
    x = x[None]                                           # (1, B, 1, d)
    layers = params["layers"]
    shared = (_one_copy(params["shared_attn"]) if cfg.family == "hybrid"
              else None)
    for i in range(cfg.n_layers):
        lp = tree_map(lambda t: t[i][None], layers)
        x = block(lp, cfg, x, cache, i, pos, rt)
        if _ends_segment(cfg, i):
            x = _dense_block_decode(shared, cfg, x, cache,
                                    i // cfg.hybrid_every, pos, rt)
    x = rmsnorm(_one_copy(params["final_norm"]), x)
    logits = _unembed(_one_copy({"lm_head": params["lm_head"]}), cfg, x)[0]
    cache["pos"] = pos + 1
    return logits, cache
