"""Grouped-query attention (port of the reference's ``models/attention.py``,
the GQA block and the ``attend`` switch).

``attend`` takes q (B, S, Hq, hd) and k, v (B, S, Hkv, hd) with positions
contiguous from 0 (full-sequence train/prefill):

* ``impl="pallas"`` (the reference's kernel route) → the flash kernels
  through :func:`repro_torch.kernels.ops.flash_attention`, forward and
  backward;
* ``impl="naive"`` → the plain PyTorch forward, differentiated by
  autograd.

MLA, the chunked and flash-jnp variants and decode are not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import flash_attention as fa
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
