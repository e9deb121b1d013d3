"""Grouped-query attention (port of the reference's ``models/attention.py``,
the GQA block and the ``attend`` switch).

``attend`` takes q (B, S, Hq, hd) and k, v (B, S, Hkv, hd) with positions
contiguous from 0 (full-sequence train/prefill):

* ``impl="pallas"`` (the reference's kernel route) → the flash kernels
  through :func:`repro_torch.kernels.ops.flash_attention`, forward and
  backward;
* ``impl="naive"`` → the plain PyTorch forward, differentiated by
  autograd.

:func:`gqa_decode` is the one-token step against a KV cache (the
reference's ``gqa_decode``), whose attention goes through
:func:`attend_decode`'s switch: ``"pallas"`` → the flash-decode kernel
through :func:`repro_torch.kernels.ops.flash_decode`, ``"naive"`` → its
plain PyTorch version (the reference's einsum formula).  MLA and the
chunked and flash-jnp variants are not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, linear

IMPLS = ("pallas", "naive")


def attend(q, k, v, *, causal: bool = True, window: Optional[int] = None,
           impl: str = "pallas"):
    if impl == "pallas":
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    if impl == "naive":
        return fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                            window=window)[0]
    raise ValueError(f"attention impl {impl!r} not in {IMPLS}")


def gqa_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32):
    """Query, key, value and output projections, drawn in that order."""
    if cfg.qkv_bias:
        raise NotImplementedError("qkv_bias is not ported yet")
    hd = cfg.hd()
    return {"wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, dtype),
            "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype),
            "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype),
            "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, dtype)}


def _qkv(params, cfg: ArchConfig, x, positions):
    """x: (N, B, S, d) → q (N·B, S, Hq, hd), k and v (N·B, S, Hkv, hd),
    with RoPE on q and k."""
    n, b, s, _ = x.shape
    hd = cfg.hd()
    q = linear(x, params["wq"]).reshape(n * b, s, cfg.n_heads, hd)
    k = linear(x, params["wk"]).reshape(n * b, s, cfg.n_kv_heads, hd)
    v = linear(x, params["wv"]).reshape(n * b, s, cfg.n_kv_heads, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def gqa_forward(params, cfg: ArchConfig, x, *, window=None,
                impl: str = "pallas"):
    """Full-sequence causal self-attention per copy: x (N, B, S, d)."""
    positions = torch.arange(x.shape[2], device=x.device)
    q, k, v = _qkv(params, cfg, x, positions)
    out = attend(q, k, v, causal=True, window=window, impl=impl)
    return linear(out.reshape(x.shape[:3] + (-1,)), params["wo"])


def attend_decode(q, k, v, pos, *, window: Optional[int] = None,
                  impl: str = "pallas"):
    if impl == "pallas":
        return ops.flash_decode(q, k, v, pos, window=window)
    if impl == "naive":
        return fd.flash_decode_plain(q, k, v, pos, window=window)
    raise ValueError(f"attention impl {impl!r} not in {IMPLS}")


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
    Returns out (1, B, 1, d)."""
    ctx = cache_k.shape[1]
    q, k, v = _qkv(params, cfg, x, pos[None])
    slot = pos % ctx if window is not None else pos.clamp(max=ctx - 1)
    slot = slot.reshape(1).long()
    cache_k.index_copy_(1, slot, k)
    cache_v.index_copy_(1, slot, v)
    out = attend_decode(q, cache_k, cache_v, pos, window=window, impl=impl)
    return linear(out.reshape(x.shape[:3] + (-1,)), params["wo"])
