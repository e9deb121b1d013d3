"""Flash decode: one query token per sequence against a KV cache, the
kernel beside its plain PyTorch version (replaces the TPU package's
``kernels/flash_decode.py::_decode_kernel``).

Tensors keep the model's layout: q and o (B, 1, Hq, hd), the caches k and
v (B, ctx, Hkv, hd), contiguous, with ``Hq`` a multiple of ``Hkv``
(grouped query attention: query head h reads KV head ``h // (Hq //
Hkv)``; K and V are never repeated).  ``pos`` is the absolute position
of the token being decoded, shared by the batch: a one-element int32
tensor on q's device (the kernel reads it from device memory, so the
host never waits for it), or a Python int.  Slots past ``pos`` are
masked; with ``window`` set the cache is a ring buffer, slot i holding
position ``pos - ((pos - i) mod ctx)`` (a floored modulo), visible when
it lies in ``(pos - window, pos]`` and is not negative.  Any ctx is
taken (the TPU kernel needs ``ctx % block_s == 0``).

On a CUDA tensor :func:`flash_decode` launches the hand-written kernel
in ``csrc/flash_decode.cu`` (one launch a call: the cache split into
runs over CTAs, the last CTA of each (sequence, KV head) merging the
runs) and adds one to its ``launches`` count; on a CPU tensor it runs
:func:`flash_decode_plain`.  There is no fallback: a CUDA tensor either
launches the kernel or raises.  It takes float32 or bfloat16 (q, k, v in
one type; accumulation in float32) and head dims 64 and 128.  A call
allocates only its output: the runs' partials and the arrival counts
live in a buffer kept per device and stream, allocated on first use.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
MAX_SPLITS = 32           # runs the kernel cuts a (sequence, head) into

# (device index, stream) -> (partials, arrival counts): kept between calls
# (the kernel leaves every count at 0), grown for a larger shape
_scratch: dict = {}


@functools.cache
def _library():
    """The built ``csrc/flash_decode.cu`` with its C signature."""
    c = build.load("flash_decode").cdll
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # q, k, v, pos, part, arrivals, o; B, ctx, Hq, Hkv, hd, window; scale;
    # bf16; stream
    c.flash_decode_launch.argtypes = [ptr] * 7 + [i32] * 6 + [f32, i32, ptr]
    c.flash_decode_launch.restype = i32
    # B, ctx, Hq, Hkv, hd, bf16; out[7]
    c.flash_decode_resources.argtypes = [i32] * 6 + [ptr]
    c.flash_decode_resources.restype = i32
    return c


def _check(q, k, v, pos, window):
    what = "flash_decode"
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: q must be (B, 1, Hq, hd) and k, v one "
                         f"(B, ctx, Hkv, hd) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hq, hd = q.shape
    hkv = k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or hkv == 0 or hq % hkv:
        raise ValueError(f"{what}: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (Hq must be a multiple of Hkv)")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window must be >= 1, got {window}")
    for t in (q, k, v):
        if (t.dtype not in (torch.float32, torch.bfloat16)
                or t.dtype != q.dtype):
            raise ValueError(f"{what}: q, k, v must share float32 or "
                             f"bfloat16, got {t.dtype} and {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{what}: tensors must be on one device")
    if isinstance(pos, torch.Tensor) and (
            pos.numel() != 1 or pos.device != q.device
            or pos.dtype not in (torch.int32, torch.int64)):
        raise ValueError(f"{what}: pos must be one integer on {q.device}, "
                         f"got {tuple(pos.shape)} {pos.dtype} on "
                         f"{pos.device}")
    if q.device.type == "cuda":
        if hd not in HEAD_DIMS:
            raise ValueError(f"{what}: the kernel takes head dims "
                             f"{HEAD_DIMS}, got {hd}")
        for t in (q, k, v):
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{what}: q, k, v must be contiguous and "
                                 "16-byte aligned")


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def visible_slots(pos, ctx: int, window: Optional[int], device):
    """(ctx,) boolean: which cache slots hold a key the token at ``pos``
    attends to (``pos`` an int or a 0-d tensor; torch's ``%`` floors)."""
    idx = torch.arange(ctx, device=device)
    if window is None:
        return idx <= pos
    key_pos = pos - ((pos - idx) % ctx)
    return (key_pos >= 0) & (key_pos <= pos) & (key_pos > pos - window)


def flash_decode_plain(q, k, v, pos, *, window: Optional[int] = None):
    """Plain PyTorch decode attention: the reference oracle's arithmetic
    (``kernels/ref.py::decode_attention_ref``: float32 scores scaled by
    ``1/√hd``, masked at -1e30, softmax, P·V) over the model's layout,
    grouped-query heads by index.  o like q."""
    b, _, hq, hd = q.shape
    ctx, hkv = k.shape[1], k.shape[2]
    if isinstance(pos, torch.Tensor):
        pos = pos.reshape(())
    qg = q.float().reshape(b, hkv, hq // hkv, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * (1.0 / hd ** 0.5)
    s = torch.where(visible_slots(pos, ctx, window, q.device), s, NEG_INF)
    o = torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, dim=-1), v.float())
    return o.reshape(b, 1, hq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def flash_decode(q, k, v, pos, *, window: Optional[int] = None):
    """o (B, 1, Hq, hd) in q's dtype."""
    _check(q, k, v, pos, window)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, pos, window=window)
    b, _, hq, hd = q.shape
    ctx, hkv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    if q.numel() == 0 or ctx == 0:
        return o.zero_()
    if not (isinstance(pos, torch.Tensor) and pos.dtype == torch.int32):
        pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part, arrivals = _scratch_for(q.device, stream, b * hq * MAX_SPLITS
                                  * (hd + 4), b * hkv)
    rc = _library().flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        part.data_ptr(), arrivals.data_ptr(), o.data_ptr(), b, ctx, hq, hkv,
        hd, 0 if window is None else int(window), 1.0 / hd ** 0.5,
        int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode: kernel launch failed with CUDA "
                           f"error {rc}")
    flash_decode.launches += 1
    return o


flash_decode.launches = 0


def _scratch_for(device, stream: int, n_part: int, n_arrivals: int):
    """The partials (``n_part`` floats at least) and arrival counts
    (``n_arrivals`` int32 at least, zero) the kernel uses on ``stream``."""
    part, arrivals = _scratch.get((device.index, stream), (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=device)
    if arrivals is None or arrivals.numel() < n_arrivals:
        arrivals = torch.zeros(n_arrivals, dtype=torch.int32, device=device)
    _scratch[(device.index, stream)] = (part, arrivals)
    return part, arrivals


_RESOURCE_KEYS = ("registers", "local_bytes", "static_smem_bytes",
                  "dynamic_smem_bytes", "threads", "ctas_per_sm", "splits")


def resources(b: int, ctx: int, hq: int, hkv: int, hd: int,
              dtype=torch.float32) -> dict:
    """What the kernel instance for a shape takes on the current card:
    registers and local memory (spills) a thread, static and dynamic shared
    memory a CTA, threads a CTA, resident CTAs an SM, and the runs the
    launch cuts a (sequence, KV head) into."""
    out = (ctypes.c_int * len(_RESOURCE_KEYS))()
    rc = _library().flash_decode_resources(b, ctx, hq, hkv, hd,
                                           int(dtype == torch.bfloat16), out)
    if rc != 0:
        raise RuntimeError(f"flash_decode_resources failed with CUDA error "
                           f"{rc}")
    return dict(zip(_RESOURCE_KEYS, out))
