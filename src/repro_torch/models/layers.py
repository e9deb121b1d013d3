"""Shared model layers (port of the reference's ``models/layers.py``):
init helpers, RMSNorm, RoPE, embeddings, the SwiGLU FFN.

Parameters are nested dicts of tensors.  Every apply function takes a
*stack* of N parameter sets — each leaf with a leading copy axis — and
activations ``(N, ..., d)`` whose leading axis picks the copy: the port
writes out the reference's ``vmap`` over devices as that axis, so one
batched product serves every (row, device) copy (:func:`linear`).

Init draws from a ``torch.Generator`` with the reference's shapes and
scales, on the generator's own device (a CUDA generator draws a
full-width model on the card; a CPU generator gives the same stream as
ever); it is a different random stream from the reference's
``jax.random`` (parity tests carry the reference's weights across).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

VOCAB_PAD_MULTIPLE = 128


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` per copy: x (N, ..., d_in), w (N, d_in, d_out) →
    (N, ..., d_out), as one batched GEMM."""
    n = x.shape[0]
    out = torch.bmm(x.reshape(n, -1, x.shape[-1]), w)
    return out.reshape(x.shape[:-1] + (w.shape[-1],))


def _per_copy(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-copy vector (N, d) shaped to broadcast over (N, ..., d)."""
    return t.reshape(t.shape[:1] + (1,) * (like.dim() - 2) + t.shape[1:])


# ---------------------------------------------------------------------------
# init helpers (one parameter set, no copy axis)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: float = 1.0) -> torch.Tensor:
    std = scale / math.sqrt(d_in)
    return (torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                        device=gen.device) * std).to(dtype)


def rmsnorm_init(d: int, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def padded_vocab(vocab: int) -> int:
    return -(-vocab // VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE


def embedding_init(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32):
    table = torch.randn((padded_vocab(vocab), d), generator=gen,
                        dtype=torch.float32, device=gen.device) * 0.02
    return {"table": table.to(dtype)}


def ffn_init(gen: torch.Generator, d: int, d_ff: int, dtype=torch.float32,
             kind: str = "swiglu"):
    """SwiGLU weights, drawn gate, up, down."""
    if kind != "swiglu":
        raise NotImplementedError(f"ffn kind {kind!r} is not ported yet; "
                                  "the port runs SwiGLU")
    return {"w_gate": dense_init(gen, d, d_ff, dtype),
            "w_up": dense_init(gen, d, d_ff, dtype),
            "w_down": dense_init(gen, d_ff, d, dtype)}


# ---------------------------------------------------------------------------
# apply (stacked copies)
# ---------------------------------------------------------------------------


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm computed in float32; ``params["scale"]`` (N, d)."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (x * _per_copy(params["scale"].float(), x)).to(dt)


def rope_freqs(head_dim: int, theta: float) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32)
                            / half))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    """:func:`rope_freqs` computed on the CPU and kept on ``device``: one
    copy a device, so a decode loop does not copy (and wait) every layer."""
    return rope_freqs(head_dim, theta).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Split-halves RoPE.  x: (..., S, heads, head_dim); positions:
    (..., S) integers."""
    inv = _rope_freqs_on(x.shape[-1], theta, x.device)
    ang = positions[..., :, None].float() * inv          # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def ffn(params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x W_gate) ∘ x W_up) W_down`` per copy."""
    g = F.silu(linear(x, params["w_gate"]))
    return linear(g * linear(x, params["w_up"]), params["w_down"])
