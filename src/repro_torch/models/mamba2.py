"""The Mamba-2 block — SSD, state-space duality (port of the reference's
``models/mamba2.py``, the train path).

Every apply function takes a stack of N parameter copies and activations
``(N, B, S, d)`` (:mod:`.layers`): the projections are batched GEMMs, the
depthwise causal conv has per-copy weights ``(N, d_conv, CH)``, and the
decay rates ``A = -exp(A_log)`` are per copy, ``(N, H)``.  The scan
itself flattens the copy axis into the batch — ``(N·B, S, H, P)`` — and
goes through :func:`repro_torch.kernels.ops.ssd` (the SSD kernels on
CUDA, their plain versions on the CPU).

:func:`ssd_reference` is the chunked SSD scan (intra-chunk quadratic
block plus the inter-chunk state recurrence), the oracle of the kernels.
:func:`mamba2_decode` is the one-token step over one parameter set (a
copy axis of 1): the rolling conv window and the per-head SSM state
recurrence, both caches updated in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (_per_copy, dense_init, linear,
                                       rmsnorm, rmsnorm_init)


def dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    return d_in, n_heads, conv_ch


def mamba2_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32):
    """One mixer's parameters, drawn in_proj, conv_w, out_proj from
    ``gen`` on its device (the reference's shapes and scales); ``A_log =
    log(linspace(1, 16, H))`` (computed on the CPU), ``D = 1`` and
    ``dt_bias = 0`` as in the reference."""
    s = cfg.ssm
    d_in, H, conv_ch = dims(cfg)
    proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + H   # z, x, B, C, dt
    dev = gen.device
    in_proj = dense_init(gen, cfg.d_model, proj_out, dtype)
    conv_w = (torch.randn((s.d_conv, conv_ch), generator=gen,
                          dtype=torch.float32, device=dev) * 0.1).to(dtype)
    out_proj = dense_init(gen, d_in, cfg.d_model, dtype)
    return {"in_proj": in_proj,
            "conv_w": conv_w,
            "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
            "A_log": torch.log(torch.linspace(1.0, 16.0, H,
                                              dtype=torch.float32)).to(dev),
            "D": torch.ones((H,), dtype=torch.float32, device=dev),
            "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
            "norm": rmsnorm_init(d_in, dtype, dev),
            "out_proj": out_proj}


def _split_proj(cfg: ArchConfig, proj):
    """``(z, xbc, dt)`` views of the in-projection; xbc holds the conv
    channels (x, B, C)."""
    s = cfg.ssm
    d_in, H, _ = dims(cfg)
    gn = s.n_groups * s.d_state
    return torch.split(proj, [d_in, d_in + 2 * gn, H], dim=-1)


def _causal_conv(w, b, xbc):
    """Depthwise causal conv per copy: w (N, W, CH), b (N, CH), xbc (N, B,
    S, CH) → silu(conv + b), summed tap by tap in the reference's order."""
    W, S = w.shape[1], xbc.shape[-2]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = sum(pad[..., i:i + S, :] * _per_copy(w[:, i], xbc)
              for i in range(W))
    return F.silu(out + _per_copy(b, xbc))


def segsum(a):
    """Stable 'segment sum': out[..., i, j] = sum_{j<k<=i} a[..., k]."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return out.masked_fill(~mask, -torch.inf)


def per_sequence_A(A, batch: int):
    """Decay rates per sequence, (B, H): A is (H,), shared by every
    sequence, or (n_copies, H), copy c owning ``B / n_copies``
    consecutive sequences."""
    if A.dim() == 1:
        return A.expand(batch, A.shape[0])
    if batch % A.shape[0]:
        raise ValueError(f"{batch} sequences do not split over "
                         f"{A.shape[0]} copies of A")
    return A.repeat_interleave(batch // A.shape[0], dim=0)


def ssd_reference(x, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD scan.

    x: (B, S, H, P)   dt: (B, S, H)   A: (H,) or (n_copies, H), negative
    decay rates (:func:`per_sequence_A`)   Bm, Cm: (B, S, G, N), H % G == 0.
    Returns y (B, S, H, P) in x's dtype and the final state (B, H, P, N).
    Computes in float32 (float64 for float64 inputs, a finer oracle).
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = S // chunk
    rep = H // G
    work = torch.promote_types(x.dtype, torch.float32)

    def ch(t):  # (B, S, ...) -> (B, nc, chunk, ...) in the working type
        return t.to(work).reshape((Bsz, nc, chunk) + t.shape[2:])

    xc, dtc, Bc, Cc = ch(x), ch(dt), ch(Bm), ch(Cm)
    # broadcast groups to heads
    Bh = Bc.repeat_interleave(rep, dim=3)                 # (B,nc,l,H,N)
    Ch_ = Cc.repeat_interleave(rep, dim=3)

    dA = dtc * per_sequence_A(A.to(work), Bsz)[:, None, None, :]
    dA_cum = torch.cumsum(dA, dim=2)                      # within chunk
    # intra-chunk (diagonal block): y = (C B^T ∘ L) (dt x)
    Lmat = torch.exp(segsum(dA.movedim(-1, -2)))          # (B,nc,H,l,l)
    scores = torch.einsum("bclhn,bcshn->bchls", Ch_, Bh)
    xdt = xc * dtc[..., None]                             # (B,nc,l,H,P)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores * Lmat, xdt)

    # chunk states: S_c = sum_s exp(dA_end - dA_cum_s) B_s (dt x)_s
    decay_out = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)  # (B,nc,l,H)
    states = torch.einsum("bclhn,bclh,bclhp->bchpn", Bh, decay_out, xdt)

    # inter-chunk recurrence, emitting the state entering each chunk
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])          # (B,nc,H)
    carry = torch.zeros((Bsz, H, P, N), dtype=work, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                # (B,nc,H,P,N)

    # off-diagonal contribution: C_t exp(dA_cum_t) state_in
    y_off = torch.einsum("bclhn,bclh,bchpn->bclhp", Ch_, torch.exp(dA_cum),
                         prev_states)
    y = (y_diag + y_off).reshape(Bsz, S, H, P)
    return y.to(x.dtype), carry


def mamba2_forward(params, cfg: ArchConfig, x):
    """Full-sequence train path of N copies: x (N, B, S, d) → same."""
    # the kernels' module imports this one for its oracle: import late
    from repro_torch.kernels import ops
    s = cfg.ssm
    d_in, H, _ = dims(cfg)
    n, b, S, _ = x.shape
    proj = linear(x, params["in_proj"])
    z, xbc, dt = _split_proj(cfg, proj)
    xbc = _causal_conv(params["conv_w"], params["conv_b"], xbc)
    gn = s.n_groups * s.d_state
    # views of the conv output (row stride conv_ch), no copies
    xs, Bm, Cm = torch.split(xbc, [d_in, gn, gn], dim=-1)
    xs = xs.reshape(n * b, S, H, s.head_dim)
    Bm = Bm.reshape(n * b, S, s.n_groups, s.d_state)
    Cm = Cm.reshape(n * b, S, s.n_groups, s.d_state)
    # softplus as the reference's jax.nn.softplus: logaddexp(x, 0)
    dt = dt.float() + _per_copy(params["dt_bias"], dt)
    dt = torch.logaddexp(dt, torch.zeros_like(dt)).reshape(n * b, S, H)
    A = -torch.exp(params["A_log"])                        # (N, H)
    y = ops.ssd(xs, dt, A, Bm, Cm, chunk=min(s.chunk, S))
    y = y.reshape(n, b, S, H, s.head_dim)
    y = y + xs.reshape(y.shape) * params["D"].reshape(n, 1, 1, H, 1).to(
        y.dtype)
    y = y.reshape(n, b, S, d_in)
    y = rmsnorm(params["norm"], y * F.silu(z))
    return linear(y, params["out_proj"])


def mamba2_decode(params, cfg: ArchConfig, x, conv_state, ssm_state):
    """One-token step of one parameter set (leaves with a copy axis of 1):
    x (1, B, 1, d); conv_state (B, d_conv-1, CH) and ssm_state (B, H, P,
    N) float32, both updated in place (the reference returns new ones).
    Returns y (1, B, 1, d)."""
    s = cfg.ssm
    d_in, H, _ = dims(cfg)
    b = x.shape[1]
    proj = linear(x[:, :, 0], params["in_proj"])          # (1, B, ·)
    z, xbc, dt = _split_proj(cfg, proj)

    # rolling conv window
    win = torch.cat([conv_state, xbc[0, :, None, :]], dim=1)   # (B, W, CH)
    conv = F.silu(torch.einsum("bwc,wc->bc", win, params["conv_w"][0])
                  + params["conv_b"][0])
    conv_state.copy_(win[:, 1:])

    gn = s.n_groups * s.d_state
    xs, Bm, Cm = torch.split(conv, [d_in, gn, gn], dim=-1)
    xs = xs.reshape(b, H, s.head_dim).float()
    rep = H // s.n_groups
    Bh = Bm.reshape(b, s.n_groups, s.d_state).float().repeat_interleave(
        rep, dim=1)                                        # (B, H, N)
    Ch_ = Cm.reshape(b, s.n_groups, s.d_state).float().repeat_interleave(
        rep, dim=1)

    # softplus as the reference's jax.nn.softplus: logaddexp(x, 0)
    dt = dt[0].float() + params["dt_bias"][0]              # (B, H)
    dt = torch.logaddexp(dt, torch.zeros_like(dt))
    A = -torch.exp(params["A_log"][0])
    dA = torch.exp(dt * A[None, :])
    upd = torch.einsum("bh,bhp,bhn->bhpn", dt, xs, Bh)
    ssm_state.mul_(dA[:, :, None, None]).add_(upd)
    y = torch.einsum("bhpn,bhn->bhp", ssm_state, Ch_)
    y = y + xs * params["D"][0][None, :, None]
    y = y.reshape(1, b, 1, d_in).to(x.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z[:, :, None, :]))
    return linear(y, params["out_proj"])
