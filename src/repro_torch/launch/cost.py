"""FLOP counts of a step (the counterpart of the reference's
``launch/hlo_cost.py``, which parses XLA's HLO text and multiplies scan
bodies by their trip counts: a PyTorch step has no HLO, so its products
are counted as it runs).

:func:`count` runs a callable under ``torch.utils.flop_counter.
FlopCounterMode``: every product PyTorch dispatches (``mm``, ``bmm``,
the ``einsum`` they lower to, convolutions, its attention calls) counts
2·M·N·K, in the forward and the backward, a loop body as many times as
it runs and a layer recomputed under ``remat`` again.  Elementwise
operations count nothing (the reference's parser adds one a element for
arithmetic).

The port's CUDA kernels run outside PyTorch's dispatcher, so the counter
does not see them; the functions below give their products by formula,
2 FLOPs a multiply-add, from a launch's shapes:

* :func:`attention_flops` — B4's forward, QKᵀ and PV over the visible
  (query, key) pairs; :func:`attention_bwd_flops` — B4′ (QKᵀ and dO·Vᵀ
  again, dS·K) and B4″ (QKᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q);
* :func:`decode_flops` — B5: one query a sequence and head against its
  visible keys;
* :func:`ssd_flops` — B3: the chunked scan at the kernel's 16-token
  tiles, CBᵀ and the diagonal block (2·L·(N + P) a token and head), the
  tile's state and its term in y (4·N·P); B3′ counts twice that, the
  two products of each forward product's gradient.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from torch.utils.flop_counter import FlopCounterMode

SSD_TILE = 16        # tokens of the SSD kernels' tiles (csrc kSeg / kTile)


@dataclass
class Count:
    flops: int = 0
    by_op: dict = field(default_factory=dict)   # op name -> FLOPs


def count(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), Count)``: the products PyTorch dispatched
    while ``fn`` ran."""
    mode = FlopCounterMode(display=False)
    with mode:
        out = fn(*args, **kwargs)
    by_op = {str(op): int(n)
             for op, n in mode.get_flop_counts().get("Global", {}).items()}
    return out, Count(int(mode.get_total_flops()), by_op)


def visible_pairs(s: int, causal: bool = True,
                  window: Optional[int] = None) -> int:
    """(query, key) pairs of an S-token sequence that attend: key k
    attends query q where k <= q (causal) and k > q - window."""
    w = s if window is None else min(window, s)
    if causal:        # q < w sees q + 1 keys, the rest w
        return w * (w + 1) // 2 + (s - w) * w
    # q < w sees all s keys, q >= w the s - (q - w + 1) after its window
    return w * s + (s - w) * (s - w + 1) // 2 + (s - w) * (w - 1)


def attention_flops(b: int, s: int, hq: int, hd: int, causal: bool = True,
                    window: Optional[int] = None) -> int:
    """B4's forward over (B, S, Hq, hd)."""
    return 4 * b * hq * hd * visible_pairs(s, causal, window)


def attention_bwd_flops(b: int, s: int, hq: int, hd: int,
                        causal: bool = True,
                        window: Optional[int] = None) -> dict:
    """B4′ (dQ) and B4″ (dK, dV) over (B, S, Hq, hd)."""
    pairs = b * hq * hd * visible_pairs(s, causal, window)
    return {"flash_attention_bwd_dq": 6 * pairs,
            "flash_attention_bwd_dkdv": 8 * pairs}


def decode_flops(b: int, hq: int, hd: int, visible: int) -> int:
    """B5: B sequences of Hq heads against ``visible`` keys each."""
    return 4 * b * hq * hd * visible


def ssd_flops(b: int, s: int, h: int, p: int, n: int) -> int:
    """B3 over (B, S, H, P) with state N."""
    tile = min(SSD_TILE, s)
    return b * s * h * (2 * tile * (n + p) + 4 * n * p)
