"""Public compositions over the kernels.

``sbc_compress`` is the exact-top-k SBC of one tensor through the kernel
pair (the reference's ``kernels/ops.py::sbc_compress``): the threshold is
``torch.topk``, outside the kernels, then stats → group choice → apply.
Its oracle is ``kernels.ref.sbc_ref`` (``sbc_tensor(exact=True)``).

``flash_attention`` is differentiable attention through the flash
kernels (the reference's ``kernels/ops.py::flash_attention``): a
``torch.autograd.Function`` whose forward kernel saves ``(q, k, v, o,
lse)`` and whose backward runs the dQ kernel and then the dK/dV kernel.
On CPU tensors every step is the kernel's plain version, so the CPU path
and the card path differ only in what computes each step.  Its oracle is
``kernels.ref.attention_ref``.

``ssd`` is the differentiable Mamba-2 SSD scan (the reference's
``kernels/ops.py::ssd``): a ``torch.autograd.Function`` whose forward is
the SSD forward kernel and whose backward is the SSD backward kernel
(dx, ddt, dA, dBm, dCm), with the same CPU rule.  Its oracle is
``kernels.ref.ssd_ref``.

``flash_decode`` is one-token attention against a KV cache (the
reference's ``kernels/ops.py::flash_decode``): the flash-decode kernel on
CUDA, its plain version on the CPU.  Unlike the reference wrapper it
resolves grouped-query heads by index — no repeated K/V, no transposed
copy of the cache.  Its oracle is ``kernels.ref.decode_attention_ref``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.compression.sbc import group_scalars, n_keep, topk_threshold
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ssd_scan
from repro_torch.kernels.sbc import sbc_apply, sbc_stats


def sbc_compress(x: torch.Tensor, ratio: float = 0.005) -> torch.Tensor:
    """Dense SBC approximation of one tensor via the kernel pair."""
    flat = x.reshape(1, -1).to(torch.float32).contiguous()
    thr = topk_threshold(flat.abs(), n_keep(flat.shape[1], ratio))
    out, _ = sbc_apply(flat, group_scalars(thr, sbc_stats(flat, thr)))
    return out.reshape(x.shape).to(x.dtype)


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                        window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        opts = dict(causal=ctx.causal, window=ctx.window)
        do = do.contiguous()
        dq, dsum = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, **opts)
        dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, lse, do, dsum, **opts)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, Hq, hd); k, v: (B, S, Hkv, hd) → (B, S, Hq, hd).

    Grouped-query heads are resolved inside the kernels by index (no
    repeated K/V).  Positions are contiguous from 0 (full-sequence
    train/prefill), as in the reference wrapper."""
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal, window)


class _SSD(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        return ssd_scan.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)

    @staticmethod
    def backward(ctx, dy):
        grads = ssd_scan.ssd_scan_bwd(*ctx.saved_tensors, dy.contiguous(),
                                      chunk=ctx.chunk)
        return (*grads, None)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, *, chunk: int = 256) -> torch.Tensor:
    """x (B, S, H, P), dt (B, S, H), A (H,) or (copies, H), Bm and Cm (B,
    S, G, N) → y (B, S, H, P) (shapes as in :mod:`.ssd_scan`)."""
    return _SSD.apply(x, dt, A, Bm, Cm, min(chunk, x.shape[1]))


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos, *,
                 window: Optional[int] = None, lse: bool = False,
                 off: int = 0, ring: Optional[int] = None):
    """q: (B, 1, Hq, hd); k, v caches: (B, ctx, Hkv, hd); ``pos`` the
    decoded token's position, a one-element integer tensor on q's device
    (or an int) → (B, 1, Hq, hd); with ``lse`` also the rows' (B, Hq)
    log-sum-exp of their scores.  ``off`` and ``ring``: k and v are the
    slots from ``off`` of a ring of ``ring`` (a part of a cache split
    over cards; default the whole cache)."""
    return fd.flash_decode(q.contiguous(), k.contiguous(), v.contiguous(),
                           pos, window=window, lse=lse, off=off, ring=ring)
