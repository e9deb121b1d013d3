"""Sparse Binary Compression (Sattler et al. [24]) — the paper's gradient
compression substrate (r = 0.005, §VI-A).

Per tensor: (1) magnitude top-k sparsification at rate ``ratio``;
(2) among survivors, keep only the sign group (positive or negative) with
the larger magnitude sum; (3) binarize survivors to that group's mean
magnitude.  With error feedback (residual accumulation) this preserves
convergence.  ``compressed_bits`` reproduces the paper's payload model
s = r·d·p.

:func:`sbc_tensor` is the plain oracle of one tensor.  :func:`compress_dense`
is the training path: every (row, device) upload of a leaf is one segment
of the segmented kernel pair in ``kernels.sbc`` behind the bisection
threshold — the CUDA kernels for CUDA tensors, their plain versions for
CPU tensors.  For a given threshold, stats + group choice + apply compute
exactly ``sbc_tensor(exact=False)``: the same keep mask, and
``pos_sum / max(pos_cnt, 1)`` is the oracle's ``grp_sum / max(Σgrp, 1)``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sbc import sbc_apply, sbc_stats
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

# f32 constants of the reference's bisection bracket hi = max·(1+1e-6)+1e-30
_HI_SCALE = torch.tensor(1.0 + 1e-6, dtype=torch.float32)
_HI_FLOOR = torch.tensor(1e-30, dtype=torch.float32)


def n_keep(n: int, ratio: float) -> int:
    """Survivors per segment: ``max(1, round(n·ratio))`` (Python round)."""
    return max(1, int(round(n * ratio)))


def topk_threshold(mag: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-th largest magnitude along the last axis."""
    return torch.topk(mag, k, dim=-1).values[..., -1]


def topk_threshold_bisect(mag: torch.Tensor, k: int,
                          iters: int = 20) -> torch.Tensor:
    """~k-th largest magnitude along the last axis by value-domain
    bisection: ``iters`` O(n) count passes instead of a sort.  Returns the
    largest threshold t with ``|{mag >= t}| >= k`` up to
    ``max(mag)/2^iters`` resolution.  Reproduces the reference's f32
    arithmetic step for step (bracket, midpoint, integer counts), so the
    same magnitudes give the bitwise same threshold."""
    lo = torch.zeros(mag.shape[:-1], dtype=torch.float32, device=mag.device)
    hi = mag.amax(-1) * _HI_SCALE + _HI_FLOOR
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        geq = (mag >= mid[..., None]).sum(-1) >= k
        lo = torch.where(geq, mid, lo)
        hi = torch.where(geq, hi, mid)
    return lo


def sbc_tensor(g: torch.Tensor, ratio: float,
               exact: bool = True) -> torch.Tensor:
    """Dense SBC approximation of one tensor (plain oracle).

    ``exact=True`` uses the literal top-k threshold, ``exact=False`` the
    bisection threshold of the training path."""
    flat = g.reshape(-1).to(torch.float32)
    k = n_keep(flat.shape[0], ratio)
    mag = flat.abs()
    thr = topk_threshold(mag, k) if exact else topk_threshold_bisect(mag, k)
    keep = mag >= thr
    pos = keep & (flat > 0)
    neg = keep & (flat < 0)
    zero = torch.zeros((), dtype=torch.float32, device=g.device)
    pos_sum = torch.where(pos, mag, zero).sum()
    neg_sum = torch.where(neg, mag, zero).sum()
    use_pos = pos_sum >= neg_sum
    grp = torch.where(use_pos, pos, neg)
    grp_sum = torch.where(use_pos, pos_sum, neg_sum)
    mean_mag = grp_sum / torch.clamp(grp.sum(), min=1)
    val = torch.where(use_pos, mean_mag, -mean_mag)
    out = torch.where(grp, val, zero)
    return out.reshape(g.shape).to(g.dtype)


def group_scalars(thr: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """Per segment, the ``[thr, val_pos, val_neg]`` that ``sbc_apply``
    takes: the larger-magnitude sign group keeps its mean magnitude, the
    other group's value is 0."""
    pos_sum, neg_sum, pos_cnt, neg_cnt = stats.unbind(-1)
    use_pos = pos_sum >= neg_sum
    mean_mag = torch.where(use_pos, pos_sum / torch.clamp(pos_cnt, min=1.0),
                           neg_sum / torch.clamp(neg_cnt, min=1.0))
    zero = torch.zeros((), dtype=torch.float32, device=thr.device)
    return torch.stack([thr, torch.where(use_pos, mean_mag, zero),
                        torch.where(use_pos, zero, -mean_mag)], dim=-1)


def compress_segments(acc: torch.Tensor, ratio: float):
    """SBC of every row of ``acc`` (S, n) behind the bisection threshold:
    returns ``(approx, acc - approx)``."""
    thr = topk_threshold_bisect(acc.abs(), n_keep(acc.shape[1], ratio))
    return sbc_apply(acc, group_scalars(thr, sbc_stats(acc, thr)))


def compress_dense(grads, ratio: float = 0.005, residual=None,
                   batch_dims: int = 0):
    """Apply SBC to every leaf, with error-feedback residuals when given.

    Leaves carry ``batch_dims`` leading axes (the engine passes (rows,
    devices): 2); every trailing tensor is one upload, compressed on its
    own with ``k = max(1, round(n·ratio))``.  All uploads of a leaf go to
    the kernels as one segmented launch each.

    Returns ``(approx_grads, new_residual)``."""
    if residual is None:
        residual = tree_map(torch.zeros_like, grads)

    def one(g, r):
        acc = (g + r).reshape(-1, g[(0,) * batch_dims].numel())
        approx, res = compress_segments(acc, ratio)
        return approx.reshape(g.shape), res.reshape(g.shape)

    pairs = [one(g, r) for g, r in zip(tree_leaves(grads),
                                       tree_leaves(residual))]
    return (tree_unflatten(grads, [a for a, _ in pairs]),
            tree_unflatten(grads, [r for _, r in pairs]))


def compressed_bits(n_params: int, ratio: float = 0.005,
                    bits_per_term: int = 64) -> float:
    """Paper's payload model: s = r·d·p."""
    return ratio * bits_per_term * n_params
