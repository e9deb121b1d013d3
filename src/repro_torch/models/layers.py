"""Shared model layers (port of the reference's ``models/layers.py``):
init helpers, RMSNorm, RoPE, embeddings, the SwiGLU and GELU FFNs.

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
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.checkpoint import checkpoint

VOCAB_PAD_MULTIPLE = 128


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` per copy: x (N, ..., d_in), w (N, d_in, d_out) →
    (N, ..., d_out), as one batched GEMM."""
    n = x.shape[0]
    out = torch.bmm(x.reshape(n, -1, x.shape[-1]), w)
    return out.reshape(x.shape[:-1] + (w.shape[-1],))


def checkpointed(fn, *args):
    """``fn(*args)`` recomputed in the backward (non-reentrant
    ``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).
    Refused inside a ``torch.func`` transform, where PyTorch's checkpoint
    does not run (the FEEL engines keep ``remat`` off)."""
    if any(isinstance(a, torch.Tensor)
           and torch._C._functorch.is_functorch_wrapped_tensor(a)
           for a in args):
        raise ValueError("remat (Runtime.remat / remat_attn) does not run "
                         "under torch.func transforms; use a Runtime with "
                         "remat=False and remat_attn=False there")
    return checkpoint(fn, *args, use_reentrant=False)


def _per_copy(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-copy vector (N, d) shaped to broadcast over (N, ..., d)."""
    return t.reshape(t.shape[:1] + (1,) * (like.dim() - 2) + t.shape[1:])


# ---------------------------------------------------------------------------
# init helpers (one parameter set, no copy axis)
# ---------------------------------------------------------------------------


def scaled_normal(gen: torch.Generator, shape, std: float,
                  dtype=torch.float32) -> torch.Tensor:
    """float32 N(0, std²) draws of ``shape`` from ``gen``, on its device,
    rounded once to ``dtype``; on the ``meta`` device
    (``models.model.MetaGenerator``) an empty tensor of the shape and
    dtype, which is all a draw there gives, without the meta kernels'
    cost."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * std).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: float = 1.0) -> torch.Tensor:
    return scaled_normal(gen, (d_in, d_out), scale / math.sqrt(d_in), dtype)


def rmsnorm_init(d: int, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def padded_vocab(vocab: int) -> int:
    return -(-vocab // VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE


def embedding_init(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32):
    return {"table": scaled_normal(gen, (padded_vocab(vocab), d), 0.02,
                                   dtype)}


FFN_KINDS = ("swiglu", "mlp")


def ffn_init(gen: torch.Generator, d: int, d_ff: int, dtype=torch.float32,
             kind: str = "swiglu"):
    """SwiGLU weights, drawn gate, up, down; or, for ``kind="mlp"`` (the
    GPT-BigCode 2-matrix GELU MLP), up and down alone, as the reference's
    init draws no gate for it."""
    if kind not in FFN_KINDS:
        raise NotImplementedError(f"ffn kind {kind!r} is not ported yet; "
                                  f"the port runs {FFN_KINDS}")
    p = {"w_gate": dense_init(gen, d, d_ff, dtype)} if kind == "swiglu" else {}
    p["w_up"] = dense_init(gen, d, d_ff, dtype)
    p["w_down"] = dense_init(gen, d_ff, d, dtype)
    return p


# ---------------------------------------------------------------------------
# apply (stacked copies)
# ---------------------------------------------------------------------------


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5,
            across=None) -> torch.Tensor:
    """RMSNorm computed in float32; ``params["scale"]`` (N, d).  ``across``
    takes the mean of squares of this part of d to the whole's (a sum
    over the ranks that hold the other parts); none when x is whole."""
    dt = x.dtype
    x = x.float()
    ms = x.square().mean(-1, keepdim=True)
    if across is not None:
        ms = across(ms)
    x = x * torch.rsqrt(ms + eps)
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
    (..., S) integers.  Under a fake-tensor trace (the static analysis'
    probe) the frequencies are computed in the traced graph and the cache
    is left alone: it holds real tensors only."""
    if isinstance(x, FakeTensor):
        inv = rope_freqs(x.shape[-1], theta).to(x.device)
    else:
        inv = _rope_freqs_on(x.shape[-1], theta, x.device)
    ang = positions[..., :, None].float() * inv          # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def ffn(params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU, ``(silu(x W_gate) ∘ x W_up) W_down``, where the parameters
    hold a gate; else the GELU MLP, ``gelu(x W_up) W_down``, with the
    reference's ``jax.nn.gelu``: its tanh approximation, not the erf."""
    if "w_gate" in params:
        g = F.silu(linear(x, params["w_gate"]))
        return linear(g * linear(x, params["w_up"]), params["w_down"])
    h = F.gelu(linear(x, params["w_up"]), approximate="tanh")
    return linear(h, params["w_down"])
