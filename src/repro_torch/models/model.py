"""The decoder model of every ported family (port of the reference's
``models/model.py``) over a padded-vocab embedding, with a final norm and
an untied LM head:

  dense / vlm : [ln → attn → ln → FFN] × L   (FFN: SwiGLU or the GELU MLP)
  audio       : the same, over the sum of ``n_codebooks`` embeddings, with
                one LM head a codebook
  moe         : [ln → attn → ln → MoE] × L, the first
                ``first_dense_layers`` dense blocks (``dense0``)
  ssm         : [ln → mamba2] × L      (the Mamba-2 block, :mod:`.mamba2`)
  hybrid      : L mamba2 layers in segments of ``hybrid_every``; after
                each segment ONE shared attention + FFN block (the same
                weights every time, ``shared_attn``) runs

where attn is GQA or, with ``attn_kind="mla"`` (dense and MoE), MLA.
Parameters follow the reference's layout — ``embed.table``, ``lm_head``,
``final_norm.scale``, ``layers.*`` (and the MoE family's ``dense0.*``)
stacked over a leading layer axis and, for the hybrid, ``shared_attn``
with no layer axis — and :func:`forward` takes a stack of N such sets (a
leading copy axis on every leaf, :mod:`.layers`).  The stacked layer
axis runs as a Python loop where the reference scans.  A VLM's
pre-projected patch embeddings enter :func:`forward` as ``prefix_embeds``
and replace the first positions.

Decode (:func:`init_cache`, :func:`decode_step`) runs one parameter set
in the reference's layout (no copy axis): one token per sequence (one a
codebook for audio) against the KV cache (GQA; the hybrid's one a
segment), the compressed ``ckv`` cache (MLA) and the conv and SSM states
(ssm, hybrid), all updated in place, with the shared position ``pos`` a
0-d int32 tensor on the device, so a decode loop never waits for the
card.  MoE decode is drop-free (capacity S·top_k).

:class:`Runtime` carries the reference's execution knobs: the
activations' dtype (bf16 in the reference's production runtime, with the
parameters drawn in it: :func:`param_spec`), ``remat`` (each layer body
recomputed in the backward) and the attention and MoE switches.  On a
mesh over a ``torch.distributed`` world, where the parameters and the
batch are DTensors (:func:`repro_torch.launch.sharding.place`), the
forward and decode run on them as they stand: DTensor's propagation
inserts the tensor-parallel collectives, :mod:`.sharded` pins each
sub-block's input and output (the Megatron pair), ``seq_parallel`` pins
the residual stream to its sequence split over ``"model"`` at the
reference's five points (:func:`_sp`), attention runs on each rank's
heads, the MoE layer on each rank's experts (``moe_shard_axes``) and
the Mamba-2 mixer on each rank's heads (:mod:`.mamba2`), and decode
runs against caches split as ``cache_shardings`` places them (a
windowed KV ring split on its sequence too).  On plain tensors none of
this runs, so every one-card path is unchanged.
:func:`param_spec` and :func:`cache_spec` give shapes and dtypes on the
``meta`` device, as the reference's ``eval_shape``.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import (ArchConfig, MLAConfig, MoEConfig,
                                      SSMConfig)
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models import sharded
from repro_torch.models.layers import (FFN_KINDS, checkpointed, dense_init,
                                       embedding_init, ffn, ffn_init, linear,
                                       padded_vocab, rmsnorm, rmsnorm_init)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class Runtime:
    """Execution knobs independent of the architecture: the reference's
    fields and defaults, but ``attn_impl``, which defaults to the kernel
    route.  ``dtype`` is the activations' type (the parameters are drawn
    in it: :func:`param_spec`); ``remat`` recomputes each layer body in
    the backward (``torch.utils.checkpoint``), ``remat_attn`` each query
    chunk of the chunked attention; ``gqa_expand`` repeats the KV heads
    before the attention.  ``moe_shard_axes`` (the data axes that carry
    the MoE layer's rows) and ``seq_parallel`` (the residual stream split
    on its sequence over ``"model"``) are placements on a mesh of several
    devices: they change nothing on plain tensors."""
    dtype: torch.dtype = torch.float32
    attn_impl: str = "pallas"   # auto | naive | blockwise | flashjnp | pallas
    block_q: int = 256
    window: Optional[int] = None   # overrides cfg.attn_window when set
    remat: bool = False
    remat_attn: bool = False
    capacity_factor: float = 1.25
    moe_impl: str = "scatter"      # scatter | expert_choice
    moe_shard_axes: tuple = ()
    gqa_expand: bool = False
    seq_parallel: bool = False

    def win(self, cfg: ArchConfig):
        return self.window if self.window is not None else cfg.attn_window


SMOKE_RT = Runtime(dtype=torch.float32, attn_impl="naive")


def _sp(x, rt: Runtime):
    """Sequence parallelism (Megatron-SP): under ``rt.seq_parallel`` a
    DTensor residual stream (N, B, S, d) is split on its sequence over
    ``"model"``; a plain tensor passes unchanged."""
    if not (rt.seq_parallel and sharded.is_dtensor(x)):
        return x
    return sharded.pin(x, sharded.with_model(x, sharded.Shard(2)))


def _maybe_remat(fn, rt: Runtime):
    """``fn`` recomputed in the backward under ``rt.remat`` (the
    reference's ``jax.checkpoint`` of a layer body), else ``fn``."""
    if not rt.remat:
        return fn
    return lambda *args: checkpointed(fn, *args)


# ArchConfig fields whose other values select parts that are not ported
_UNPORTED = ("attn_kind", "moe", "mla", "ssm", "hybrid_every",
             "n_codebooks", "vlm_prefix", "ffn_kind", "norm_eps")
# the values each ported family admits where it differs from the defaults:
# a class (any instance of it), a tuple (any of its members) or a value
_MLA = {"attn_kind": ("gqa", "mla"), "mla": (None, MLAConfig)}
_FAMILY_FIELDS = {"dense": {"ffn_kind": FFN_KINDS, **_MLA},
                  "vlm": {"ffn_kind": FFN_KINDS, "vlm_prefix": int},
                  "audio": {"ffn_kind": FFN_KINDS, "n_codebooks": int},
                  "ssm": {"attn_kind": "none", "ssm": SSMConfig},
                  "hybrid": {"ffn_kind": FFN_KINDS, "ssm": SSMConfig,
                             "hybrid_every": int},
                  "moe": {"moe": MoEConfig, **_MLA}}


def _admits(want, got) -> bool:
    if isinstance(want, tuple):
        return any(_admits(w, got) for w in want)
    if isinstance(want, type):
        return isinstance(got, want)
    return got == want


def _require_ported(cfg: ArchConfig):
    """Refuse a config that asks for what the port does not run, rather
    than run a different model."""
    if cfg.family == "mlp":
        raise NotImplementedError(
            f"{cfg.name!r} is family 'mlp', the paper's classifier: its "
            "model is repro_torch.fed.feel_model, not this decoder stack "
            "(the reference's models.model does not run it either)")
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
    if (cfg.attn_kind == "mla") != (cfg.mla is not None):
        raise NotImplementedError(
            f"attn_kind={cfg.attn_kind!r} with mla={cfg.mla!r} is not "
            "ported: MLA takes attn_kind='mla' and an MLAConfig together")
    if cfg.family == "hybrid" and not (
            cfg.hybrid_every >= 1 and cfg.n_layers % cfg.hybrid_every == 0):
        raise ValueError(f"hybrid_every={cfg.hybrid_every} must divide "
                         f"n_layers={cfg.n_layers}")


def _first_dense(cfg: ArchConfig) -> int:
    """The MoE family's leading dense blocks (``dense0``); 0 otherwise."""
    return cfg.moe.first_dense_layers if cfg.family == "moe" else 0


class MetaGenerator(torch.Generator):
    """A CPU generator whose draws land on the meta device: an init drawn
    from it allocates nothing, and gives the shapes."""
    @property
    def device(self):
        return torch.device("meta")


def _attn_init(gen, cfg: ArchConfig, dtype):
    if cfg.attn_kind == "mla":
        return attn.mla_init(gen, cfg, dtype)
    return attn.gqa_init(gen, cfg, dtype)


def _dense_layer_init(gen, cfg: ArchConfig, dtype):
    return {"ln1": rmsnorm_init(cfg.d_model, dtype, gen.device),
            "attn": _attn_init(gen, cfg, dtype),
            "ln2": rmsnorm_init(cfg.d_model, dtype, gen.device),
            "ffn": ffn_init(gen, cfg.d_model, cfg.d_ff, dtype,
                            cfg.ffn_kind)}


def _moe_layer_init(gen, cfg: ArchConfig, dtype, experts=None):
    return {"ln1": rmsnorm_init(cfg.d_model, dtype, gen.device),
            "attn": _attn_init(gen, cfg, dtype),
            "ln2": rmsnorm_init(cfg.d_model, dtype, gen.device),
            "moe": moe_mod.moe_init(gen, cfg, dtype, experts)}


def _ssm_layer_init(gen, cfg: ArchConfig, dtype):
    return {"ln": rmsnorm_init(cfg.d_model, dtype, gen.device),
            "mixer": m2.mamba2_init(gen, cfg, dtype)}


_LAYER_INIT = {"dense": _dense_layer_init, "vlm": _dense_layer_init,
               "audio": _dense_layer_init, "ssm": _ssm_layer_init,
               "hybrid": _ssm_layer_init, "moe": _moe_layer_init}


def _codebook_stack(draw, n_codebooks: int):
    """``n_codebooks`` draws stacked on a leading axis, or the one draw."""
    if n_codebooks == 1:
        return draw()
    return torch.stack([draw() for _ in range(n_codebooks)])


def _stacked_layers(gen, cfg: ArchConfig, dtype, n: int, layer_init):
    """``n`` layers stacked on a leading axis: the stacked leaves are
    allocated first (their shapes from a draw on the meta device), then
    each layer is drawn and copied into its slot — its experts straight
    into theirs, a matrix at a time — so the peak is the stack plus one
    layer's leaves outside the experts plus one expert matrix."""
    like = layer_init(MetaGenerator(), cfg, dtype)
    stack = tree_map(lambda t: torch.empty((n,) + t.shape, dtype=t.dtype,
                                           device=gen.device), like)
    for i in range(n):
        slot = tree_map(lambda t: t[i], stack)
        kw = {"experts": slot["moe"]["experts"]} if "moe" in slot else {}
        layer = layer_init(gen, cfg, dtype, **kw)
        for into, t in zip(tree_leaves(slot), tree_leaves(layer)):
            if into is not t:
                into.copy_(t)
        del layer
    return stack


def init(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32):
    """One parameter set on ``gen``'s device, drawn from ``gen`` in this
    order: the embedding table (one a codebook), the LM head (one a
    codebook), then per layer (the MoE family's dense blocks first) the
    attention projections (GQA: q, k, v, o; MLA: :func:`attn.mla_init`'s
    order) and the FFN (gate, up, down; up, down for the GELU MLP) or the
    MoE block (router, each expert's gate, up, down, the shared and the
    dense FFN) — or, for the SSM and hybrid families, the mixer's
    in_proj, conv_w and out_proj — and last the hybrid's shared attention
    block.  Same shapes and scales as the reference's init, another
    random stream.  Layers are drawn into their slots of the stacked
    leaves (:func:`_stacked_layers`), so the peak is the model's size
    plus about one layer outside its experts."""
    _require_ported(cfg)
    pv, ncb = padded_vocab(cfg.vocab), cfg.n_codebooks
    params = {
        "embed": {"table": _codebook_stack(lambda: embedding_init(
            gen, cfg.vocab, cfg.d_model, dtype)["table"], ncb)},
        "lm_head": _codebook_stack(lambda: dense_init(
            gen, cfg.d_model, pv, dtype), ncb),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, gen.device)}
    nd = _first_dense(cfg)
    if nd:
        params["dense0"] = _stacked_layers(gen, cfg, dtype, nd,
                                           _dense_layer_init)
    params["layers"] = _stacked_layers(gen, cfg, dtype, cfg.n_layers - nd,
                                       _LAYER_INIT[cfg.family])
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


def _attn_fwd(lp, cfg: ArchConfig, x, rt: Runtime):
    if cfg.attn_kind == "mla":
        return attn.mla_forward(lp, cfg, x, impl=rt.attn_impl,
                                window=rt.win(cfg), block_q=rt.block_q,
                                remat_chunks=rt.remat_attn)
    return attn.gqa_forward(lp, cfg, x, window=rt.win(cfg),
                            impl=rt.attn_impl, block_q=rt.block_q,
                            remat_chunks=rt.remat_attn,
                            expand_heads=rt.gqa_expand)


def _attn_res(lp, cfg: ArchConfig, x, rt: Runtime):
    """The attention sub-block's output in the residual's placements."""
    h = sharded.tp_in(rmsnorm(lp["ln1"], x))
    return sharded.tp_out(_attn_fwd(lp["attn"], cfg, h, rt), x)


def _dense_block(lp, cfg: ArchConfig, x, rt: Runtime):
    x = _sp(x, rt)
    x = x + _attn_res(lp, cfg, x, rt)
    x = _sp(x, rt)
    h = sharded.tp_in(rmsnorm(lp["ln2"], x))
    return x + sharded.tp_out(ffn(lp["ffn"], h), x)


def _moe_block(lp, cfg: ArchConfig, x, rt: Runtime):
    """A MoE block: (x, its load-balance loss (N,))."""
    x = _sp(x, rt)
    x = x + _attn_res(lp, cfg, x, rt)
    x = _sp(x, rt)
    y, aux = moe_mod.moe_forward(lp["moe"], cfg,
                                 sharded.tp_in(rmsnorm(lp["ln2"], x)),
                                 capacity_factor=rt.capacity_factor,
                                 impl=rt.moe_impl,
                                 shard_axes=rt.moe_shard_axes)
    return x + sharded.tp_out(y, x), aux


def _ssm_block(lp, cfg: ArchConfig, x, rt: Runtime):
    """An SSM layer: the mixer's input whole over ``"model"`` (under
    ``seq_parallel`` its sequence gathered: the scan runs along it), its
    output a partial sum handed back to the residual's placements."""
    x = _sp(x, rt)
    h = sharded.tp_in(rmsnorm(lp["ln"], x))
    return x + sharded.tp_out(m2.mamba2_forward(lp["mixer"], cfg, h), x)


def _layer_params(layers):
    """Per-layer views of the stacked layer params (layer axis 1, after
    the copy axis); ``unbind`` keeps the gradient one stack per leaf."""
    per_leaf = [leaf.unbind(1) for leaf in tree_leaves(layers)]
    return [tree_unflatten(layers, list(views))
            for views in zip(*per_leaf)]


def _ends_segment(cfg: ArchConfig, i: int) -> bool:
    """Whether the hybrid's shared block runs after layer ``i``."""
    return cfg.family == "hybrid" and (i + 1) % cfg.hybrid_every == 0


def _require_dtype(params, rt: Runtime):
    """Refuse parameters in another type than ``rt.dtype``: the reference
    promotes mixed products, PyTorch's batched GEMM does not."""
    got = params["embed"]["table"].dtype
    if got != rt.dtype:
        raise ValueError(f"parameters in {got} under Runtime(dtype="
                         f"{rt.dtype}): draw them in the runtime's type "
                         f"(init(cfg, gen, rt.dtype), as param_spec)")


def forward(cfg: ArchConfig, params, tokens, *, prefix_embeds=None,
            rt: Runtime = Runtime()):
    """Full-sequence forward of N parameter copies: tokens (N, B, S)
    integers, or (N, B, S, n_cb) for audio → ``(logits, aux)``: logits
    (N, B, S, padded vocab), or (N, B, S, n_cb, padded vocab), and aux
    (N,) float32, the sum of the MoE blocks' load-balance losses (zeros
    for the other families).  ``prefix_embeds`` (N, B, P, d), a VLM's
    pre-projected patch embeddings, replace the first P positions.  The
    hybrid's shared block runs after every ``hybrid_every`` SSM layers
    with the same weights, so its gradient is the sum over its
    applications.  Activations run in ``rt.dtype``, the parameters'
    type; under ``rt.remat`` each layer body (a dense, MoE or SSM layer,
    each application of the shared block) is recomputed in the
    backward."""
    _require_ported(cfg)
    _require_dtype(params, rt)
    x = sharded.tp_in(_embed(params, cfg, tokens))
    if prefix_embeds is not None:
        P = prefix_embeds.shape[2]
        x = torch.cat([prefix_embeds.to(rt.dtype), x[:, :, P:]], dim=2)
    aux = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    dense = _maybe_remat(_dense_block, rt)
    if "dense0" in params:
        for lp in _layer_params(params["dense0"]):
            x = dense(lp, cfg, x, rt)
    block = _maybe_remat({"ssm": _ssm_block, "hybrid": _ssm_block,
                          "moe": _moe_block}.get(cfg.family, _dense_block),
                         rt)
    for i, lp in enumerate(_layer_params(params["layers"])):
        if cfg.family == "moe":
            x, a = block(lp, cfg, x, rt)
            aux = aux + a
        else:
            x = block(lp, cfg, x, rt)
        if _ends_segment(cfg, i):
            x = dense(params["shared_attn"], cfg, x, rt)
    # the head reads every position: under seq_parallel the sequence is
    # gathered here, as Megatron-SP does before its LM head
    x = sharded.tp_in(x)
    return _unembed(params, cfg, rmsnorm(params["final_norm"], x)), aux


# ---------------------------------------------------------------------------
# decode (one token, KV/SSM caches)
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, ctx: int, rt: Runtime = Runtime(),
               device="cpu"):
    """The decode cache, zeroed, on ``device`` (the reference's layout):
    ``pos`` a 0-d int32; GQA (dense, vlm, audio, moe): ``k``/``v`` (L, B,
    ctx', Hkv, hd) with ``ctx' = min(ctx, window)`` under a window (a ring
    buffer); MLA: ``ckv`` (L, B, ctx', kv_lora + rope), every layer's
    (the MoE family's dense blocks first); ssm and hybrid: ``conv`` (L,
    B, d_conv-1, CH) and ``ssm`` (L, B, H, P, N) float32; hybrid also
    ``k``/``v`` (L / hybrid_every, B, ctx', Hkv, hd), one a segment for
    the shared block.  Every cache but ``pos`` and ``ssm`` is in
    ``rt.dtype``."""
    _require_ported(cfg)
    zeros = lambda *shape, dtype=rt.dtype: torch.zeros(  # noqa: E731
        shape, dtype=dtype, device=device)
    c = {"pos": torch.zeros((), dtype=torch.int32, device=device)}
    L = cfg.n_layers
    win = rt.win(cfg)
    kv_ctx = min(ctx, win) if win else ctx
    if cfg.family in ("ssm", "hybrid"):
        _, H, CH = m2.dims(cfg)
        s = cfg.ssm
        c["conv"] = zeros(L, batch, s.d_conv - 1, CH)
        c["ssm"] = zeros(L, batch, H, s.head_dim, s.d_state,
                         dtype=torch.float32)
    if cfg.attn_kind == "mla":
        m = cfg.mla
        c["ckv"] = zeros(L, batch, kv_ctx, m.kv_lora_rank + m.qk_rope_head_dim)
    elif cfg.family != "ssm":
        n_kv = L // cfg.hybrid_every if cfg.family == "hybrid" else L
        c["k"] = zeros(n_kv, batch, kv_ctx, cfg.n_kv_heads, cfg.hd())
        c["v"] = zeros(n_kv, batch, kv_ctx, cfg.n_kv_heads, cfg.hd())
    return c


def _attn_decode(lp, cfg: ArchConfig, x, cache, i, pos, rt: Runtime):
    if cfg.attn_kind == "mla":
        return attn.mla_decode(lp, cfg, x, cache["ckv"][i], pos)
    return attn.gqa_decode(lp, cfg, x, cache["k"][i], cache["v"][i], pos,
                           window=rt.win(cfg), impl=rt.attn_impl)


def _dense_block_decode(lp, cfg: ArchConfig, x, cache, i, pos, rt: Runtime):
    x = x + _attn_decode(lp["attn"], cfg, rmsnorm(lp["ln1"], x), cache, i,
                         pos, rt)
    return x + ffn(lp["ffn"], rmsnorm(lp["ln2"], x))


def _moe_block_decode(lp, cfg: ArchConfig, x, cache, i, pos, rt: Runtime):
    x = x + _attn_decode(lp["attn"], cfg, rmsnorm(lp["ln1"], x), cache, i,
                         pos, rt)
    # decode is drop-free: per-row capacity = S·top_k (= top_k at S = 1)
    y, _ = moe_mod.moe_forward(lp["moe"], cfg, rmsnorm(lp["ln2"], x),
                               cap=x.shape[2] * cfg.moe.top_k)
    return x + y


def _ssm_block_decode(lp, cfg: ArchConfig, x, cache, i, pos, rt: Runtime):
    return x + m2.mamba2_decode(lp["mixer"], cfg, rmsnorm(lp["ln"], x),
                                cache["conv"][i], cache["ssm"][i])


_BLOCK_DECODE = {"dense": _dense_block_decode, "vlm": _dense_block_decode,
                 "audio": _dense_block_decode, "ssm": _ssm_block_decode,
                 "hybrid": _ssm_block_decode, "moe": _moe_block_decode}


def _one_copy(tree):
    """Views with a copy axis of 1, for the stacked-copy apply functions."""
    return tree_map(lambda t: t[None], tree)


def decode_step(cfg: ArchConfig, params, cache, tokens, *,
                rt: Runtime = Runtime()):
    """One decode step for the whole batch: tokens (B, 1) integers, or
    (B, 1, n_cb) for audio → logits (B, 1, padded vocab), or (B, 1, n_cb,
    padded vocab).  ``cache`` (from :func:`init_cache`) is updated in
    place — layer i's KV or ``ckv`` slot or states (the hybrid's shared
    block: segment i's KV slot), then ``pos`` advanced by one — and
    returned, as the reference's jitted step donates it.  Activations
    run in ``rt.dtype``, the parameters' type."""
    _require_ported(cfg)
    _require_dtype(params, rt)
    pos = cache["pos"]
    # a gather (a sum of gathers over the codebooks), as the reference's
    # _embed: no gradient flows here, so the training path's one-hot
    # product (a pass over the whole table) is not needed; F.embedding,
    # which DTensor runs on a vocab-split table without gathering it
    table = params["embed"]["table"]
    if cfg.n_codebooks == 1:
        x = F.embedding(tokens, table)
    else:
        x = sum(F.embedding(tokens[..., i], table[i])
                for i in range(cfg.n_codebooks))
    x = sharded.tp_in(x)[None]                            # (1, B, 1, d)
    nd = _first_dense(cfg)
    shared = (_one_copy(params["shared_attn"]) if cfg.family == "hybrid"
              else None)
    for i in range(cfg.n_layers):
        if i < nd:
            lp = tree_map(lambda t: t[i][None], params["dense0"])
            x = _dense_block_decode(lp, cfg, x, cache, i, pos, rt)
        else:
            lp = tree_map(lambda t: t[i - nd][None], params["layers"])
            x = _BLOCK_DECODE[cfg.family](lp, cfg, x, cache, i, pos, rt)
        if _ends_segment(cfg, i):
            x = _dense_block_decode(shared, cfg, x, cache,
                                    i // cfg.hybrid_every, pos, rt)
    x = rmsnorm(_one_copy(params["final_norm"]), x)
    logits = _unembed(_one_copy({"lm_head": params["lm_head"]}), cfg, x)[0]
    cache["pos"] = pos + 1
    return logits, cache


def param_spec(cfg: ArchConfig, dtype=torch.float32):
    """The parameters' shapes and dtypes: :func:`init`'s tree on the
    ``meta`` device (the reference's ``eval_shape`` of its init)."""
    return init(cfg, MetaGenerator(), dtype)


def cache_spec(cfg: ArchConfig, batch: int, ctx: int,
               rt: Runtime = SMOKE_RT):
    """The decode cache's shapes and dtypes: :func:`init_cache` on the
    ``meta`` device."""
    return init_cache(cfg, batch, ctx, rt, device="meta")
