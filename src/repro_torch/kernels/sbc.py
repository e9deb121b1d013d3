"""Sparse-binary-compression kernels: the two streaming passes of the
paper's uplink compression (Step 2, [24]), segmented over many uploads.

  * :func:`sbc_stats` — per segment, magnitude sums and counts of the
    positive and the negative values at or above the segment's threshold.
  * :func:`sbc_apply` — per segment, binarize survivors to the chosen
    group's value and write the error-feedback residual ``x - out``.

Each function takes an ``(S, n)`` float32 tensor: S independent segments
(every (row, device) upload of one parameter leaf) of n values.  On a CUDA
tensor it launches the hand-written kernel in ``csrc/sbc.cu`` (which
replaces the TPU package's ``kernels/sbc.py::_stats_kernel`` and
``_apply_kernel``) and adds one to its ``launches`` count; on a CPU tensor
it runs the plain PyTorch version beside it.  There is no fallback: a
CUDA tensor either launches the kernel or raises.  Inside
``probe.probing()`` each emits its traced stand-in instead.

The threshold itself is computed outside the kernels (the exact top-k in
:mod:`.ops`, the bisection in ``compression.sbc``), as ``lax.top_k`` stays
outside Pallas in the reference.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, probe


@functools.cache
def _library():
    """The built ``csrc/sbc.cu`` with its C signatures declared."""
    c = build.load("sbc").cdll
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    c.sbc_tile.argtypes, c.sbc_tile.restype = [], i32
    c.sbc_partial_bytes.argtypes, c.sbc_partial_bytes.restype = [], i32
    c.sbc_stats_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i64, i32, ptr]
    c.sbc_stats_launch.restype = i32
    c.sbc_apply_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i64, i32, ptr]
    c.sbc_apply_launch.restype = i32
    return c


def _check(x: torch.Tensor, per_seg: torch.Tensor, width: int, what: str):
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous (S, n) float32 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    want = (x.shape[0],) if width == 1 else (x.shape[0], width)
    if (tuple(per_seg.shape) != want or per_seg.dtype != torch.float32
            or per_seg.device != x.device or not per_seg.is_contiguous()):
        raise ValueError(f"{what}: per-segment operand must be a "
                         f"contiguous {want} float32 tensor on {x.device}, "
                         f"got {tuple(per_seg.shape)} {per_seg.dtype} "
                         f"on {per_seg.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def _launch_args(x: torch.Tensor, *written: torch.Tensor):
    """(segments, n, vec4, stream): the float4 path when n % 4 == 0 and x
    and every tensor the kernel writes start on a 16-byte boundary."""
    segments, n = x.shape
    if segments > 65535:
        raise ValueError(f"{segments} segments exceed the grid's y limit")
    vec4 = int(n % 4 == 0 and all(t.data_ptr() % 16 == 0
                                  for t in (x,) + written))
    return segments, n, vec4, torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{rc}")


# ---------------------------------------------------------------------------
# sbc_stats
# ---------------------------------------------------------------------------


def sbc_stats_plain(x: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``sbc_stats``: sums accumulated in float64, as the
    kernel does, then rounded to float32."""
    mag = x.abs()
    keep = mag >= thr[:, None]
    pos = keep & (x > 0)
    neg = keep & (x < 0)
    m64 = mag.double()
    zero = torch.zeros((), dtype=torch.float64, device=x.device)
    return torch.stack([torch.where(pos, m64, zero).sum(-1),
                        torch.where(neg, m64, zero).sum(-1),
                        pos.sum(-1).double(), neg.sum(-1).double()],
                       dim=-1).float()


def sbc_stats(x: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """x: (S, n) f32; thr: (S,) f32 → (S, 4) f32
    ``[pos_sum, neg_sum, pos_cnt, neg_cnt]``."""
    _check(x, thr, 1, "sbc_stats")
    if probe.active():
        return probe.ops().sbc_stats(x, thr)
    if x.device.type == "cpu":
        return sbc_stats_plain(x, thr)
    lib = _library()
    segments, n, vec4, stream = _launch_args(x)
    out = torch.empty((segments, 4), dtype=torch.float32, device=x.device)
    if n == 0:
        return out.zero_()
    tiles = math.ceil(n / lib.sbc_tile())
    partials = torch.empty(segments * tiles * lib.sbc_partial_bytes(),
                           dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        _raise_on(lib.sbc_stats_launch(x.data_ptr(), thr.data_ptr(),
                                       partials.data_ptr(), out.data_ptr(),
                                       segments, n, vec4, stream),
                  "sbc_stats")
    sbc_stats.launches += 1
    return out


sbc_stats.launches = 0


# ---------------------------------------------------------------------------
# sbc_apply
# ---------------------------------------------------------------------------


def sbc_apply_plain(x: torch.Tensor, scalars: torch.Tensor):
    """Plain PyTorch ``sbc_apply``: returns ``(out, x - out)``."""
    thr, val_pos, val_neg = (scalars[:, j:j + 1] for j in range(3))
    keep = x.abs() >= thr
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    out = torch.where(keep & (x > 0), val_pos,
                      torch.where(keep & (x < 0), val_neg, zero))
    return out, x - out


def _check_destination(t, x: torch.Tensor, what: str) -> None:
    """``t`` (when given) must be a tensor the kernel may write: x's
    shape, dtype and device, contiguous, and apart from x (the kernel
    reads x through the read-only cache)."""
    if t is None:
        return
    if (t.shape != x.shape or t.dtype != x.dtype or t.device != x.device
            or not t.is_contiguous()):
        raise ValueError(f"sbc_apply: {what} must be a contiguous "
                         f"{tuple(x.shape)} {x.dtype} tensor on {x.device}")
    x0, x1 = x.data_ptr(), x.data_ptr() + 4 * x.numel()
    t0, t1 = t.data_ptr(), t.data_ptr() + 4 * t.numel()
    if x.numel() and t0 < x1 and x0 < t1:
        raise ValueError(f"sbc_apply: {what} overlaps x")


def sbc_apply(x: torch.Tensor, scalars: torch.Tensor, *, out=None,
              res=None):
    """x: (S, n) f32; scalars: (S, 3) f32 ``[thr, val_pos, val_neg]`` (the
    dropped group's value is 0) → ``(out, residual)``, each (S, n), with
    ``residual = x - out`` bitwise.  ``out`` and ``res``, when given, are
    where the two are written (each apart from x); else they are new."""
    _check(x, scalars, 3, "sbc_apply")
    _check_destination(out, x, "out")
    _check_destination(res, x, "res")
    if probe.active() or x.device.type == "cpu":
        p_out, p_res = (probe.ops().sbc_apply(x, scalars) if probe.active()
                        else sbc_apply_plain(x, scalars))
        return (p_out if out is None else out.copy_(p_out),
                p_res if res is None else res.copy_(p_res))
    lib = _library()
    out = torch.empty_like(x) if out is None else out
    res = torch.empty_like(x) if res is None else res
    segments, n, vec4, stream = _launch_args(x, out, res)
    if n == 0:
        return out, res
    with torch.cuda.device(x.device):
        _raise_on(lib.sbc_apply_launch(x.data_ptr(), scalars.data_ptr(),
                                       out.data_ptr(), res.data_ptr(),
                                       segments, n, vec4, stream),
                  "sbc_apply")
    sbc_apply.launches += 1
    return out, res


sbc_apply.launches = 0
