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

:func:`count_sharded` counts a step on a mesh over a ``torch.
distributed`` world, on this device: a ``TorchDispatchMode`` that lets
DTensor lower each operation first and then sees the local operations —
their products counted as :func:`count` counts them (PyTorch's FLOP
formulas, on the local shapes), and the functional collectives DTensor
issues (``all_reduce``, ``reduce_scatter_tensor``,
``all_gather_into_tensor``, ``all_to_all``) each at its result's bytes,
as the reference counts an HLO collective's result shape (its
``collective_bytes`` / ``collective_by_op``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

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


# functional collectives (torch.ops._c10d_functional and the legacy
# c10d_functional) by the names the rows use
COLLECTIVES = {"all_reduce": "all_reduce",
               "reduce_scatter_tensor": "reduce_scatter_tensor",
               "all_gather_into_tensor": "all_gather_into_tensor",
               "all_to_all_single": "all_to_all"}
_NAMESPACES = ("_c10d_functional", "c10d_functional",
               "_c10d_functional_autograd")


@dataclass
class Collectives:
    bytes: int = 0
    by_op: dict = field(default_factory=dict)   # name -> result bytes
    count: dict = field(default_factory=dict)   # name -> collectives


class _StepCounter(TorchDispatchMode):

    def __init__(self):
        super().__init__()
        self.flops = Count()
        self.tally = Collectives()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # let DTensor lower it to local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = getattr(func, "_overloadpacket", None)
        if not _real(out):
            return out            # DTensor's shape propagation, not work
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops.flops += n
            key = str(packet)
            self.flops.by_op[key] = self.flops.by_op.get(key, 0) + n
        name = COLLECTIVES.get(getattr(packet, "__name__", ""))
        if name and getattr(packet, "_qualified_op_name", "").split(
                "::")[0] in _NAMESPACES:
            n = out.numel() * out.element_size()
            t = self.tally
            t.bytes += n
            t.by_op[name] = t.by_op.get(name, 0) + n
            t.count[name] = t.count.get(name, 0) + 1
        return out


def _real(out) -> bool:
    """Whether an operation's result is data (not the meta or fake tensors
    DTensor propagates shapes with)."""
    from torch._subclasses.fake_tensor import FakeTensor
    t = out[0] if isinstance(out, (tuple, list)) and out else out
    return not (isinstance(t, FakeTensor)
                or getattr(t, "device", None) == torch.device("meta"))


def count_sharded(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), Count, Collectives)``: the products this
    device ran and the collectives it issued while ``fn`` ran on DTensors
    (or plain tensors)."""
    mode = _StepCounter()
    with mode:
        out = fn(*args, **kwargs)
    return out, mode.flops, mode.tally


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
