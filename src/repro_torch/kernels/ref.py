"""Plain oracles of the kernels' compositions (the allclose targets)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.compression.sbc import sbc_tensor as sbc_ref  # noqa: F401
from repro_torch.kernels.flash_decode import visible_slots
from repro_torch.models.mamba2 import ssd_reference


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


def ssd_ref(x, dt, A, Bm, Cm, chunk: int = 256):
    """Returns y only (the kernel contract), as the reference's
    ``kernels/ref.py``."""
    y, _ = ssd_reference(x, dt, A, Bm, Cm, min(chunk, x.shape[1]))
    return y


def decode_attention_ref(q, k, v, pos, *, window: Optional[int] = None):
    """q: (BH, 1, hd); k, v: (BH, ctx, hd); ``pos`` an int or a 0-d
    tensor — one-token attention over the visible cache slots (ring-buffer
    aware when ``window``), as the reference's ``kernels/ref.py``."""
    ctx, hd = k.shape[1], k.shape[2]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (1.0 / hd ** 0.5)
    s = torch.where(visible_slots(pos, ctx, window, q.device), s, -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)
