"""Attention: grouped-query attention and multi-head latent attention
(port of the reference's ``models/attention.py``).

``attend`` takes q (B, Sq, Hq, hd), k (B, Sk, Hkv, hd) and v (B, Sk,
Hkv, hd_v) with their positions (contiguous from 0 when not given) and
switches on ``impl`` as the reference's:

* ``"pallas"`` (the reference's kernel route) → the flash kernels
  through :func:`repro_torch.kernels.ops.flash_attention`, forward and
  backward;
* ``"naive"``, and ``"auto"`` at Sq <= 1024 → :func:`attend_naive`, the
  plain PyTorch forward differentiated by autograd;
* ``"blockwise"``, and ``"auto"`` above 1024 → :func:`attend_chunked`,
  naive attention a chunk of ``block_q`` queries at a time;
* ``"flashjnp"`` → :func:`attend_flashjnp`, the online softmax over
  (``block_q`` × 512) score tiles in plain PyTorch.

The kernel route and the flash double loop take one head dim for q, k and
v, as the reference's do: attention whose v head dim differs from q's
(MLA's) raises ``ValueError`` there, where the reference fails on a
reshape (ROADMAP caveat C-ref-10).  The chunked and flash variants fall
back (flash → chunked → naive) when their blocks do not divide S.

:func:`gqa_decode` is the one-token step against a KV cache, whose
attention goes through :func:`attend_decode`: ``"pallas"`` → the
flash-decode kernel through :func:`repro_torch.kernels.ops.flash_decode`,
any other impl → its plain version (the reference's einsum formula).
:func:`mla_forward` is MLA in its decompressed form (train and prefill);
:func:`mla_decode` the absorbed form against the compressed ``ckv``
cache, in plain PyTorch as the reference's (no kernel there either).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops
from repro_torch.models import sharded
from repro_torch.models.layers import (_per_copy, apply_rope, checkpointed,
                                       dense_init, linear, rmsnorm,
                                       rmsnorm_init)

IMPLS = ("auto", "naive", "blockwise", "flashjnp", "pallas")
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# core attention math
# ---------------------------------------------------------------------------


def _mask(pos_q, pos_k, causal: bool, window: Optional[int]):
    """(Sq, Sk) boolean: True = attend."""
    m = torch.ones((pos_q.shape[0], pos_k.shape[0]), dtype=torch.bool,
                   device=pos_q.device)
    if causal:
        m &= pos_k[None, :] <= pos_q[:, None]
    if window is not None:
        m &= pos_k[None, :] > pos_q[:, None] - window
    return m


def _one_head_dim(what: str, q, v):
    if v.shape[-1] != q.shape[-1]:
        raise ValueError(
            f"{what}: q, k and v must share one head dim, got q "
            f"{q.shape[-1]} and v {v.shape[-1]} (MLA has no such route in "
            f"the reference either: ROADMAP caveat C-ref-10)")


def attend_naive(q, k, v, pos_q, pos_k, *, causal: bool = True,
                 window: Optional[int] = None):
    """q (B, Sq, Hq, hd), k (B, Sk, Hkv, hd), v (B, Sk, Hkv, hd_v) →
    (B, Sq, Hq, hd_v): float32 scores scaled by ``1/√hd``, masked at
    -1e30, softmax, P·V; query head h reads KV head ``h // (Hq / Hkv)``.
    The arithmetic of the flash kernels' plain forward; in bf16 the
    probabilities are rounded to v's type before P·V, as the
    reference's (its products accumulate in float32)."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, sq, hkv, hq // hkv, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (
        1.0 / math.sqrt(hd))
    s = torch.where(_mask(pos_q, pos_k, causal, window), s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, sq, hq, v.shape[-1]).to(q.dtype)


def attend_chunked(q, k, v, pos_q, pos_k, *, causal: bool = True,
                   window: Optional[int] = None, block_q: int = 256,
                   remat_chunks: bool = False):
    """Exact attention a chunk of ``block_q`` queries at a time (naive when
    ``block_q`` does not divide Sq), so the live scores are (B, H,
    block_q, Sk).  ``remat_chunks`` recomputes each chunk's scores in the
    backward instead of keeping every chunk's probabilities."""
    sq = q.shape[1]
    if sq % block_q:
        return attend_naive(q, k, v, pos_q, pos_k, causal=causal,
                            window=window)

    def chunk(qi, pi):
        return attend_naive(qi, k, v, pi, pos_k, causal=causal,
                            window=window)

    run = (lambda qi, pi: checkpointed(chunk, qi, pi)) if remat_chunks \
        else chunk
    return torch.cat([run(q[:, i:i + block_q], pos_q[i:i + block_q])
                      for i in range(0, sq, block_q)], dim=1)


def attend_flashjnp(q, k, v, pos_q, pos_k, *, causal: bool = True,
                    window: Optional[int] = None, block_q: int = 256,
                    block_k: int = 512):
    """Online-softmax (flash) attention in plain PyTorch: a loop over
    (``block_q`` × ``block_k``) score tiles carrying the running max,
    sum and output (the reference's double scan); chunked when either
    block does not divide S."""
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    if sq % block_q or sk % block_k:
        return attend_chunked(q, k, v, pos_q, pos_k, causal=causal,
                              window=window, block_q=block_q)
    _one_head_dim("flash attention in plain PyTorch", q, v)
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for i in range(0, sq, block_q):
        qi = q[:, i:i + block_q].float().reshape(b, block_q, hkv, g, hd)
        acc = q.new_zeros((b, hkv, g, block_q, hd), dtype=torch.float32)
        m = torch.full((b, hkv, g, block_q), NEG_INF, device=q.device)
        l = torch.zeros((b, hkv, g, block_q), device=q.device)
        for j in range(0, sk, block_k):
            s = torch.einsum("bqkgd,bskd->bkgqs", qi,
                             k[:, j:j + block_k].float()) * scale
            s = torch.where(_mask(pos_q[i:i + block_q],
                                  pos_k[j:j + block_k], causal, window),
                            s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(v.dtype).float(),
                v[:, j:j + block_k].float())
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, block_q, hq, hd)
                    .to(q.dtype))
    return torch.cat(outs, dim=1)


def attend(q, k, v, pos_q=None, pos_k=None, *, causal: bool = True,
           window: Optional[int] = None, impl: str = "pallas",
           block_q: int = 256, remat_chunks: bool = False):
    if pos_q is None:
        pos_q = torch.arange(q.shape[1], device=q.device)
    if pos_k is None:
        pos_k = torch.arange(k.shape[1], device=q.device)
    if impl == "naive" or (impl == "auto" and q.shape[1] <= 1024):
        return attend_naive(q, k, v, pos_q, pos_k, causal=causal,
                            window=window)
    if impl == "pallas":
        _one_head_dim("the flash attention kernels", q, v)
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    if impl == "flashjnp":
        return attend_flashjnp(q, k, v, pos_q, pos_k, causal=causal,
                               window=window, block_q=block_q)
    if impl in ("auto", "blockwise"):
        return attend_chunked(q, k, v, pos_q, pos_k, causal=causal,
                              window=window, block_q=block_q,
                              remat_chunks=remat_chunks)
    raise ValueError(f"attention impl {impl!r} not in {IMPLS}")


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------


def gqa_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32):
    """Query, key, value and output projections, drawn in that order; with
    ``cfg.qkv_bias`` also zero ``bq``, ``bk`` and ``bv``, which draw
    nothing (as the reference's)."""
    hd = cfg.hd()
    p = {"wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, dtype),
         "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype),
         "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype),
         "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, dtype)}
    if cfg.qkv_bias:
        zeros = lambda n: torch.zeros((n,), dtype=dtype,  # noqa: E731
                                      device=gen.device)
        p["bq"] = zeros(cfg.n_heads * hd)
        p["bk"] = zeros(cfg.n_kv_heads * hd)
        p["bv"] = zeros(cfg.n_kv_heads * hd)
    return p


def _qkv(params, cfg: ArchConfig, x, positions):
    """x: (N, B, S, d) → q (N·B, S, Hq, hd), k and v (N·B, S, Hkv, hd),
    with the biases (``cfg.qkv_bias``) added before RoPE on q and k."""
    n, b, s, _ = x.shape
    hd = cfg.hd()
    q, k, v = (linear(x, params[w]) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = (t + _per_copy(params[name], t)
                   for t, name in ((q, "bq"), (k, "bk"), (v, "bv")))
    q = q.reshape(n * b, s, cfg.n_heads, hd)
    k = k.reshape(n * b, s, cfg.n_kv_heads, hd)
    v = v.reshape(n * b, s, cfg.n_kv_heads, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def gqa_forward(params, cfg: ArchConfig, x, *, window=None,
                impl: str = "pallas", block_q: int = 256,
                remat_chunks: bool = False, expand_heads: bool = False):
    """Full-sequence causal self-attention per copy: x (N, B, S, d).
    ``expand_heads`` repeats each KV head over its query group first
    (``jnp.repeat``'s order), as the reference's uneven-GQA knob.  On
    DTensors the attention runs on each rank's batch rows and heads
    (:func:`_attend_local`), q, k and v pinned to head sharding over
    ``"model"`` (the reference's constraint under ``expand_heads``)."""
    positions = torch.arange(x.shape[2], device=x.device)
    q, k, v = _qkv(params, cfg, x, positions)
    if expand_heads and cfg.n_kv_heads < cfg.n_heads:
        g = cfg.n_heads // cfg.n_kv_heads
        k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    out = _attend_local(x, q, k, v, causal=True, window=window, impl=impl,
                        block_q=block_q, remat_chunks=remat_chunks)
    return linear(out.reshape(x.shape[:3] + (-1,)), params["wo"])


def _attend_local(x, q, k, v, **opts):
    """:func:`attend` over contiguous positions; on DTensors through
    ``local_map`` on each rank's rows (those of x (N, B, S, d)) and heads
    — the kernel route's three kernels each on its own card."""
    if not sharded.is_dtensor(q):
        pos = torch.arange(q.shape[1], device=q.device)
        return attend(q, k, v, pos, pos, **opts)
    return sharded.on_local_heads(lambda a, b, c: attend(a, b, c, **opts),
                                  q, k, v, sharded.sharded_axes(x, 1))


def attend_decode(q, k, v, pos, *, window: Optional[int] = None,
                  impl: str = "pallas", lse: bool = False, off: int = 0,
                  ring: Optional[int] = None):
    """Decode attention of q against the cache k, v (``off`` and
    ``ring``: a part of a ring split over cards)."""
    if impl == "pallas":
        return ops.flash_decode(q, k, v, pos, window=window, lse=lse,
                                off=off, ring=ring)
    if impl in IMPLS:
        return fd.flash_decode_plain(q, k, v, pos, window=window, lse=lse,
                                     off=off, ring=ring)
    raise ValueError(f"attention impl {impl!r} not in {IMPLS}")


def _write_slot(cache, new, slot, off: int):
    """``new`` (B, 1, ...) into ``cache`` (B, c, ...), this rank's part of
    a sequence split over cards from slot ``off``, at the global ``slot``
    (a 0-d tensor) where it falls in this part; nothing waits for the
    card."""
    c = cache.shape[1]
    local = slot - off
    at = local.clamp(0, c - 1).reshape(1).long()
    inside = (local >= 0) & (local < c)
    cache.index_copy_(1, at, torch.where(inside, new,
                                         cache.index_select(1, at)))


def _decode_local(q, k, v, cache_k, cache_v, pos, *, window, impl):
    """Write and attend against DTensor caches (B, ctx, Hkv, hd) placed
    by ``cache_shardings``: rows over the data axes, and the sequence —
    or, where it does not divide, the heads — over ``"model"``.  The
    kernel runs through ``local_map`` on each rank's rows and heads and
    its part of the cache; where the sequence is split, each part's
    output and log-sum-exp are merged over ``"model"`` (flash decoding
    across cards: two all-reduces of (B, Hq) and one of the output).  Each
    part attends as the slots ``off ..`` of the whole cache of ``ctx``
    slots (B5's ``off`` and ``ring``); a windowed cache is a ring of them,
    the token going to global slot ``pos % ctx``."""
    from torch.distributed.tensor.experimental import local_map
    mesh = cache_k.device_mesh
    split = bool(sharded.sharded_axes(cache_k, 1))
    dims = {0: sharded.sharded_axes(cache_k, 0)}
    if sharded.sharded_axes(cache_k, 2):
        dims[2] = sharded.MODEL
    qpl, cpl = sharded.placements(q, dims), cache_k.placements
    q, k, v = (sharded.pin(t, qpl) for t in (q, k, v))
    pos = sharded.pin(pos, sharded.placements(pos, {}))
    ctx = cache_k.shape[1]

    def body(q, k, v, ck, cv, pos):
        r, m = sharded.model_rank(mesh) if split else (0, 1)
        off = r * ck.shape[1]
        slot = pos % ctx if window is not None else pos.clamp(max=ctx - 1)
        _write_slot(ck, k, slot, off)
        _write_slot(cv, v, slot, off)
        if m == 1:
            return attend_decode(q, ck, cv, pos, window=window, impl=impl)
        o, lse = attend_decode(q, ck, cv, pos, window=window, impl=impl,
                               lse=True, off=off, ring=ctx)
        top = sharded.model_reduce(lse, "max", mesh)
        w = torch.exp(lse - top)                              # (B, Hq)
        num = sharded.model_reduce(o.float() * w[:, None, :, None], "sum",
                                   mesh)
        den = sharded.model_reduce(w, "sum", mesh)
        return (num / den[:, None, :, None]).to(o.dtype)

    return local_map(body, out_placements=list(qpl),
                     in_placements=(qpl, qpl, qpl, cpl, cpl,
                                    pos.placements),
                     device_mesh=mesh)(q, k, v, cache_k, cache_v, pos)


def gqa_decode(params, cfg: ArchConfig, x, cache_k, cache_v, pos, *,
               window=None, impl: str = "pallas"):
    """One-token decode of one parameter set (leaves with a copy axis of
    1), synchronized batch.

    x: (1, B, 1, d); cache_k/v: (B, ctx, Hkv, hd), ring-buffered when
    ``window`` is set, written in place at slot ``pos % ctx`` (window) or
    ``pos`` — clamped to ``ctx - 1``, as the reference's
    ``dynamic_update_slice`` clamps its start; ``pos``: a 0-d int32
    tensor on x's device, the new token's absolute position.  Slot and
    mask are computed on the device: nothing here waits for the card.
    Returns out (1, B, 1, d).  On DTensor caches the write and the
    attention run on each rank's part (:func:`_decode_local`)."""
    ctx = cache_k.shape[1]
    q, k, v = _qkv(params, cfg, x, pos[None])
    if sharded.is_dtensor(cache_k):
        out = _decode_local(q, k, v, cache_k, cache_v, pos, window=window,
                            impl=impl)
        return linear(out.reshape(x.shape[:3] + (-1,)), params["wo"])
    slot = pos % ctx if window is not None else pos.clamp(max=ctx - 1)
    slot = slot.reshape(1).long()
    cache_k.index_copy_(1, slot, k)
    cache_v.index_copy_(1, slot, v)
    out = attend_decode(q, cache_k, cache_v, pos, window=window, impl=impl)
    return linear(out.reshape(x.shape[:3] + (-1,)), params["wo"])


# ---------------------------------------------------------------------------
# MLA block (DeepSeek-V2 / MiniCPM3)
# ---------------------------------------------------------------------------


def mla_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32):
    """The latent KV down-projection, the shared rope key's projection,
    the K and V up-projections, the output projection, then the query's
    down- and up-projections (``q_lora_rank``) or its one projection,
    drawn in that order (the reference's shapes and scales; the norms
    draw nothing)."""
    m = cfg.mla
    H, dev = cfg.n_heads, gen.device
    p = {"w_dkv": dense_init(gen, cfg.d_model, m.kv_lora_rank, dtype),
         "kv_norm": rmsnorm_init(m.kv_lora_rank, dtype, dev),
         "w_kr": dense_init(gen, cfg.d_model, m.qk_rope_head_dim, dtype),
         "w_uk": dense_init(gen, m.kv_lora_rank, H * m.qk_nope_head_dim,
                            dtype),
         "w_uv": dense_init(gen, m.kv_lora_rank, H * m.v_head_dim, dtype),
         "wo": dense_init(gen, H * m.v_head_dim, cfg.d_model, dtype)}
    qdim = H * (m.qk_nope_head_dim + m.qk_rope_head_dim)
    if m.q_lora_rank:
        p["w_dq"] = dense_init(gen, cfg.d_model, m.q_lora_rank, dtype)
        p["q_norm"] = rmsnorm_init(m.q_lora_rank, dtype, dev)
        p["w_uq"] = dense_init(gen, m.q_lora_rank, qdim, dtype)
    else:
        p["w_q"] = dense_init(gen, cfg.d_model, qdim, dtype)
    return p


def _mla_q(params, cfg: ArchConfig, x, positions):
    """x (N, B, S, d) → q_nope (N·B, S, H, nope) and q_rope (N·B, S, H,
    rope), RoPE applied."""
    m = cfg.mla
    n, b, s, _ = x.shape
    if m.q_lora_rank:
        q = linear(rmsnorm(params["q_norm"], linear(x, params["w_dq"])),
                   params["w_uq"])
    else:
        q = linear(x, params["w_q"])
    q = q.reshape(n * b, s, cfg.n_heads,
                  m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(params, cfg: ArchConfig, x, positions):
    """The compressed KV (N·B, S, r), normed, and the shared rope key
    (N·B, S, rope), RoPE applied."""
    n, b, s, _ = x.shape
    c_kv = rmsnorm(params["kv_norm"], linear(x, params["w_dkv"]))
    k_rope = linear(x, params["w_kr"]).reshape(n * b, s, 1, -1)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0]
    return c_kv.reshape(n * b, s, -1), k_rope


def mla_forward(params, cfg: ArchConfig, x, *, impl: str = "pallas",
                window=None, block_q: int = 256,
                remat_chunks: bool = False):
    """Full-sequence causal MLA per copy, x (N, B, S, d), in the
    decompressed form: per-head keys (nope from the latent, the rope key
    broadcast over heads) and values, then :func:`attend`."""
    m = cfg.mla
    n, b, s, _ = x.shape
    H = cfg.n_heads
    positions = torch.arange(s, device=x.device)
    q_nope, q_rope = _mla_q(params, cfg, x, positions)
    c_kv, k_rope = _mla_latent(params, cfg, x, positions)
    k_nope = linear(c_kv.reshape(n, b * s, -1), params["w_uk"])
    v = linear(c_kv.reshape(n, b * s, -1), params["w_uv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope.reshape(n * b, s, H, m.qk_nope_head_dim),
                   k_rope[:, :, None].expand(n * b, s, H,
                                             m.qk_rope_head_dim)], dim=-1)
    out = _attend_local(x, q, k, v.reshape(n * b, s, H, m.v_head_dim),
                        causal=True, window=window, impl=impl,
                        block_q=block_q, remat_chunks=remat_chunks)
    return linear(out.reshape(n, b, s, H * m.v_head_dim), params["wo"])


def mla_decode(params, cfg: ArchConfig, x, cache_ckv, pos):
    """One-token absorbed-matrix MLA of one parameter set (a copy axis of
    1), synchronized batch: x (1, B, 1, d); cache_ckv (B, ctx, kv_lora +
    rope), the normed latent and the rope key of every position, written
    in place at slot ``pos`` clamped to ``ctx - 1`` (the reference's
    ``dynamic_update_slice``); ``pos`` a 0-d int32 tensor on x's device.
    W_UK is absorbed into the query (``q_lat`` in float32) and W_UV
    applied to the attended latent.  Returns out (1, B, 1, d).  On a
    DTensor cache the write and the attention over the latent run on each
    rank's part (:func:`_mla_attend_local`)."""
    m = cfg.mla
    b, H, r = x.shape[1], cfg.n_heads, m.kv_lora_rank
    ctx = cache_ckv.shape[1]
    q_nope, q_rope = _mla_q(params, cfg, x, pos[None])        # (B,1,H,·)
    c_kv, k_rope = _mla_latent(params, cfg, x, pos[None])     # (B,1,·)
    new = torch.cat([c_kv, k_rope], dim=-1)
    w_uk = params["w_uk"][0].reshape(r, H, m.qk_nope_head_dim)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), w_uk.float())
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    if sharded.is_dtensor(cache_ckv):
        out_lat = _mla_attend_local(q_lat, q_rope[:, 0].float(), new,
                                    cache_ckv, pos, r, scale)
    else:
        slot = pos.clamp(max=ctx - 1).reshape(1).long()
        cache_ckv.index_copy_(1, slot, new)
        ckv, krope = cache_ckv[..., :r], cache_ckv[..., r:]
        logits = (torch.einsum("bhr,bsr->bhs", q_lat, ckv.float())
                  + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(),
                                 krope.float())) * scale
        valid = torch.arange(ctx, device=x.device) <= pos
        logits = torch.where(valid, logits, NEG_INF)
        out_lat = torch.einsum("bhs,bsr->bhr",
                               torch.softmax(logits, dim=-1), ckv.float())
    w_uv = params["w_uv"][0].reshape(r, H, m.v_head_dim)
    out = torch.einsum("bhr,rhd->bhd", out_lat, w_uv.float())
    return linear(out.reshape(1, b, 1, H * m.v_head_dim).to(x.dtype),
                  params["wo"])


def _mla_attend_local(q_lat, q_rope, new, cache_ckv, pos, r: int,
                      scale: float):
    """MLA's write and attention over the latent against a DTensor
    ``ckv`` cache (B, ctx, r + rope) placed by ``cache_shardings`` (rows
    over the data axes, the sequence over ``"model"``): each rank scores
    its part of the cache for every head; where the sequence is split the
    softmax is merged over ``"model"`` (the maximum, the sum and the
    weighted latent all-reduced).  q_lat (B, H, r) and q_rope (B, H,
    rope) float32 → the attended latent (B, H, r) float32."""
    from torch.distributed.tensor.experimental import local_map
    mesh = cache_ckv.device_mesh
    split = bool(sharded.sharded_axes(cache_ckv, 1))
    qpl = sharded.placements(q_lat, {0: sharded.sharded_axes(cache_ckv, 0)})
    q_lat, q_rope, new = (sharded.pin(t, qpl) for t in (q_lat, q_rope, new))
    pos = sharded.pin(pos, sharded.placements(pos, {}))
    ctx = cache_ckv.shape[1]

    def body(q_lat, q_rope, new, cache, pos):
        rank, m = sharded.model_rank(mesh) if split else (0, 1)
        c = cache.shape[1]
        off = rank * c
        _write_slot(cache, new, pos.clamp(max=ctx - 1), off)
        ckv, krope = cache[..., :r], cache[..., r:]
        logits = (torch.einsum("bhr,bsr->bhs", q_lat, ckv.float())
                  + torch.einsum("bhd,bsd->bhs", q_rope,
                                 krope.float())) * scale
        valid = torch.arange(off, off + c, device=cache.device) <= pos
        logits = torch.where(valid, logits, NEG_INF)
        if m == 1:
            return torch.einsum("bhs,bsr->bhr",
                                torch.softmax(logits, dim=-1), ckv.float())
        top = sharded.model_reduce(logits.amax(-1, keepdim=True), "max",
                                   mesh)
        e = torch.exp(logits - top)
        den = sharded.model_reduce(e.sum(-1, keepdim=True), "sum", mesh)
        num = sharded.model_reduce(
            torch.einsum("bhs,bsr->bhr", e, ckv.float()), "sum", mesh)
        return num / den

    return local_map(body, out_placements=list(qpl),
                     in_placements=(qpl, qpl, qpl, cache_ckv.placements,
                                    pos.placements),
                     device_mesh=mesh)(q_lat, q_rope, new, cache_ckv, pos)
