"""Traced stand-ins for the kernels, for the static analysis' probe.

``api.lowering.trace_bucket`` traces a bucket's program with
``make_fx`` under fake tensors.  A kernel writes its outputs through raw
pointers, so a trace of the card's call would see ``torch.empty`` and
nothing that fills it; a trace of the CPU call would see the kernel's
plain version, op by op, which is not what the card runs.  While
:func:`probing` is active, each kernel wrapper a FEEL program reaches —
``sbc_stats``, ``sbc_apply``, ``flash_attention_fwd``, ``_bwd_dq``,
``_bwd_dkdv``, ``ssd_scan_fwd`` and ``_bwd`` — instead returns the output
of one ``repro_torch::<kernel>`` op of ``torch.library``, so the kernel
is one node of the traced graph.  The op has a fake implementation
(shapes and dtypes, the kernel's contract) and is never executed: its
eager implementation raises.  Outside a probe nothing changes: a CUDA
tensor launches the kernel or raises, a CPU tensor runs the plain
version.  The padding-taint pass gives each stand-in its transfer rule
(``analysis.taint``); ``chip_smoke.py`` holds those rules on the card.

The ops are registered at the first probe, not at import.  This module
leaves its annotations unpostponed: ``torch.library`` reads the stand-ins'
schemas from them.
"""
import contextlib
import functools
import threading
from types import SimpleNamespace
from typing import Optional

import torch
from torch import Tensor

_LOCAL = threading.local()

# the stand-ins' names, each its wrapper's
KERNELS = ("sbc_stats", "sbc_apply", "flash_attention_fwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkdv",
           "ssd_scan_fwd", "ssd_scan_bwd")


def active() -> bool:
    """Whether this thread is inside :func:`probing`."""
    return getattr(_LOCAL, "depth", 0) > 0


@contextlib.contextmanager
def probing():
    """Kernel wrappers called in this block (on this thread) emit their
    stand-in op instead of launching or running the plain version."""
    _LOCAL.depth = getattr(_LOCAL, "depth", 0) + 1
    try:
        yield
    finally:
        _LOCAL.depth -= 1


def _never(name: str):
    raise RuntimeError(f"repro_torch::{name} is the probe's traced "
                       "stand-in of a kernel and is never executed")


@functools.cache
def ops() -> SimpleNamespace:
    """The registered stand-in ops, by kernel name."""
    lib = "repro_torch::"

    @torch.library.custom_op(lib + "sbc_stats", mutates_args=())
    def sbc_stats(x: Tensor, thr: Tensor) -> Tensor:
        _never("sbc_stats")

    @sbc_stats.register_fake
    def _(x, thr):
        return x.new_empty((x.shape[0], 4))

    @torch.library.custom_op(lib + "sbc_apply", mutates_args=())
    def sbc_apply(x: Tensor, scalars: Tensor) -> tuple[Tensor, Tensor]:
        _never("sbc_apply")

    @sbc_apply.register_fake
    def _(x, scalars):
        return torch.empty_like(x), torch.empty_like(x)

    @torch.library.custom_op(lib + "flash_attention_fwd", mutates_args=())
    def flash_attention_fwd(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                            window: Optional[int]) -> tuple[Tensor, Tensor]:
        _never("flash_attention_fwd")

    @flash_attention_fwd.register_fake
    def _(q, k, v, causal, window):
        return (torch.empty_like(q),
                q.new_empty((q.shape[0], q.shape[2], q.shape[1]),
                            dtype=torch.float32))

    @torch.library.custom_op(lib + "flash_attention_bwd_dq",
                             mutates_args=())
    def flash_attention_bwd_dq(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                               lse: Tensor, do: Tensor, causal: bool,
                               window: Optional[int]
                               ) -> tuple[Tensor, Tensor]:
        _never("flash_attention_bwd_dq")

    @flash_attention_bwd_dq.register_fake
    def _(q, k, v, o, lse, do, causal, window):
        return torch.empty_like(q), torch.empty_like(lse)

    @torch.library.custom_op(lib + "flash_attention_bwd_dkdv",
                             mutates_args=())
    def flash_attention_bwd_dkdv(q: Tensor, k: Tensor, v: Tensor,
                                 lse: Tensor, do: Tensor, dsum: Tensor,
                                 causal: bool, window: Optional[int]
                                 ) -> tuple[Tensor, Tensor]:
        _never("flash_attention_bwd_dkdv")

    @flash_attention_bwd_dkdv.register_fake
    def _(q, k, v, lse, do, dsum, causal, window):
        return torch.empty_like(k), torch.empty_like(v)

    @torch.library.custom_op(lib + "ssd_scan_fwd", mutates_args=())
    def ssd_scan_fwd(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor,
                     Cm: Tensor, chunk: int) -> Tensor:
        _never("ssd_scan_fwd")

    @ssd_scan_fwd.register_fake
    def _(x, dt, A, Bm, Cm, chunk):
        return torch.empty_like(x, memory_format=torch.contiguous_format)

    @torch.library.custom_op(lib + "ssd_scan_bwd", mutates_args=())
    def ssd_scan_bwd(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor,
                     Cm: Tensor, dy: Tensor, chunk: int
                     ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
        _never("ssd_scan_bwd")

    @ssd_scan_bwd.register_fake
    def _(x, dt, A, Bm, Cm, dy, chunk):
        def like(t):
            return torch.empty(t.shape, dtype=t.dtype, device=t.device)
        return like(x), like(dt), like(A), like(Bm), like(Cm)

    return SimpleNamespace(**{name: locals()[name] for name in KERNELS})
