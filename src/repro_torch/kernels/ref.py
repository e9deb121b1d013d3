"""Plain oracles of the kernels' compositions (the allclose targets)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.compression.sbc import sbc_tensor as sbc_ref  # noqa: F401


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None):
    """q, k, v: (BH, S, hd) → (BH, S, hd); plain softmax attention with
    masked scores at -1e30 (the reference's ``kernels/ref.py``)."""
    s_len, hd = q.shape[1], q.shape[2]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (1.0 / hd ** 0.5)
    pos = torch.arange(s_len, device=q.device)
    mask = torch.ones((s_len, s_len), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    w = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)
