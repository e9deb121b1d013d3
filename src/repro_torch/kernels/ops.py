"""Public compositions over the kernels.

``sbc_compress`` is the exact-top-k SBC of one tensor through the kernel
pair (the reference's ``kernels/ops.py::sbc_compress``): the threshold is
``torch.topk``, outside the kernels, then stats → group choice → apply.
Its oracle is ``kernels.ref.sbc_ref`` (``sbc_tensor(exact=True)``).
"""
from __future__ import annotations

import torch

from repro_torch.compression.sbc import group_scalars, n_keep, topk_threshold
from repro_torch.kernels.sbc import sbc_apply, sbc_stats


def sbc_compress(x: torch.Tensor, ratio: float = 0.005) -> torch.Tensor:
    """Dense SBC approximation of one tensor via the kernel pair."""
    flat = x.reshape(1, -1).to(torch.float32).contiguous()
    thr = topk_threshold(flat.abs(), n_keep(flat.shape[1], ratio))
    out, _ = sbc_apply(flat, group_scalars(thr, sbc_stats(flat, thr)))
    return out.reshape(x.shape).to(x.dtype)
