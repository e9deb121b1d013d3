"""Flash attention: the forward kernel and a deterministic backward pair,
each beside its plain PyTorch version.

  * :func:`flash_attention_fwd` — ``(o, lse)``: causal and/or
    sliding-window softmax attention with scale ``1/√hd`` and the row
    log-sum-exp the backward needs (replaces the TPU package's
    ``kernels/flash_attention.py::_flash_kernel``);
  * :func:`flash_attention_bwd_dq` — ``(dq, D)`` with ``D = rowsum(dO∘O)``;
  * :func:`flash_attention_bwd_dkdv` — ``(dk, dv)`` from the ``D`` that
    :func:`flash_attention_bwd_dq` returned.

The TPU package has no backward kernel (its gradient flows through the
jnp oracle on the CPU); the backward pair is the port's own.

Tensors keep the model's layout: ``q``/``o`` (B, S, Hq, hd) and ``k``/``v``
(B, S, Hkv, hd), contiguous, with ``Hq`` a multiple of ``Hkv`` (grouped
query attention: query head h reads KV head ``h // (Hq // Hkv)``; K and V
are never repeated).  ``lse`` and ``D`` are (B, Hq, S) float32.  Positions
run from 0 to S-1; any S is taken (the TPU kernel needs ``S % block == 0``).

On a CUDA tensor each function launches its hand-written kernel in
``csrc/flash_attention.cu`` and adds one to its ``launches`` count; on a
CPU tensor it runs the plain version beside it.  There is no fallback: a
CUDA tensor either launches the kernel or raises (inside
``probe.probing()`` each emits its traced stand-in).  Every kernel takes
float32 or bfloat16 (q, k, v, o and dO in one type; lse and D float32),
head dims 32, 64, 112 and 128, any group size Hq / Hkv and tensors whose
data start on a 16-byte boundary (the copies are 16-byte vectors); each
reads its inputs in their type, computes in float32 and rounds its
outputs once to that type.  The forward runs on a persistent grid of
units (sequence, KV head, query tile) that cover a KV head's query heads
together (:func:`fwd_resources` reports its instances); the dQ kernel
runs on the forward's units, the dK/dV kernel on a persistent grid of
units (sequence, KV head, 16-key tile) that cover the KV head's query
heads together, and :func:`dq_resources` and :func:`dkdv_resources`
report their instances.  In bf16 the plain versions compute in float32
on the bf16 values and round each gradient once, as the reference's
oracle does under autograd.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build, probe

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 112, 128)


@functools.cache
def _library():
    """The built ``csrc/flash_attention.cu`` with its C signatures."""
    c = build.load("flash_attention").cdll
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    shape = [i32] * 7 + [f32]        # B, S, Hq, Hkv, hd, causal, window, scale
    c.flash_attention_fwd_launch.argtypes = [ptr] * 5 + shape + [i32, ptr]
    c.flash_attention_bwd_dq_launch.argtypes = [ptr] * 8 + shape + [i32,
                                                                     ptr]
    c.flash_attention_bwd_dkdv_launch.argtypes = [ptr] * 8 + shape + [i32,
                                                                       ptr]
    # hd, bf16; out[6]
    c.flash_attention_fwd_resources.argtypes = [i32, i32, ptr]
    c.flash_attention_bwd_dq_resources.argtypes = [i32, i32, ptr]
    c.flash_attention_bwd_dkdv_resources.argtypes = [i32, i32, ptr]
    for fn in (c.flash_attention_fwd_launch, c.flash_attention_bwd_dq_launch,
               c.flash_attention_bwd_dkdv_launch,
               c.flash_attention_fwd_resources,
               c.flash_attention_bwd_dq_resources,
               c.flash_attention_bwd_dkdv_resources):
        fn.restype = i32
    return c


def _check(what: str, q, k, v, window, dtypes, *like_q):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: q must be (B, S, Hq, hd) and k, v one "
                         f"(B, S, Hkv, hd) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, hd) or hq % hkv:
        raise ValueError(f"{what}: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (Hq must be a multiple of Hkv)")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window must be >= 1, got {window}")
    if any(t.shape != q.shape for t in like_q):
        raise ValueError(f"{what}: o and dO must have q's shape "
                         f"{tuple(q.shape)}")
    for t in (q, k, v, *like_q):
        if t.dtype not in dtypes or t.dtype != q.dtype:
            raise ValueError(f"{what}: tensors must share one dtype of "
                             f"{dtypes}, got {t.dtype} and {q.dtype}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous and on "
                             f"one device")
    if q.device.type == "cuda" and hd not in HEAD_DIMS:
        raise ValueError(f"{what}: the kernel takes head dims {HEAD_DIMS}, "
                         f"got {hd}")


def _check_stats(what: str, q, *stats):
    b, s, hq, _ = q.shape
    for t in stats:
        if (tuple(t.shape) != (b, hq, s) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{what}: row statistics must be contiguous "
                             f"({b}, {hq}, {s}) float32 on {q.device}")


def _shape_args(q, k, causal: bool, window: Optional[int]):
    b, s, hq, hd = q.shape
    return (b, s, hq, k.shape[2], hd, int(causal),
            0 if window is None else int(window), 1.0 / math.sqrt(hd))


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_aligned(what: str, *tensors):
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: inputs must start on a 16-byte boundary "
                         f"(the kernel copies 16-byte vectors)")


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{rc}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _mask(s: int, causal: bool, window: Optional[int], device):
    """(S, S) boolean, True = attend, by absolute position."""
    pos = torch.arange(s, device=device)
    m = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        m &= pos[None, :] <= pos[:, None]
    if window is not None:
        m &= pos[None, :] > pos[:, None] - window
    return m


def _grouped(q, k):
    """q as (B, S, Hkv, g, hd) float32 and the score scale."""
    b, s, hq, hd = q.shape
    return (q.float().reshape(b, s, k.shape[2], hq // k.shape[2], hd),
            1.0 / math.sqrt(hd))


def _probs(q, k, lse, causal, window):
    """P = exp(S - lse) (0 where masked) as (B, Hkv, g, Sq, Sk), with the
    grouped q and the scale."""
    qg, scale = _grouped(q, k)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    mask = _mask(q.shape[1], causal, window, q.device)
    lse = lse.reshape(s.shape[:-1])
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    return p, qg, scale


def _grad_scores(q, k, v, lse, do, dsum, causal, window):
    """P, dS = P∘(dP - D) and the grouped q/dO, for the backward formulas."""
    p, qg, scale = _probs(q, k, lse, causal, window)
    dog = do.float().reshape(qg.shape)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.float())
    ds = p * (dp - dsum.reshape(p.shape[:-1])[..., None])
    return p, ds, qg, dog, scale


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True,
                              window: Optional[int] = None):
    """Plain PyTorch forward: masked scores at -1e30 (as the TPU kernel
    and the reference oracle), softmax in float32; returns ``(o, lse)``."""
    qg, scale = _grouped(q, k)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    s = torch.where(_mask(q.shape[1], causal, window, q.device), s, NEG_INF)
    o = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(s, dim=-1),
                     v.float())
    b, sq, hq, hd = q.shape
    lse = torch.logsumexp(s, dim=-1).reshape(b, hq, sq)
    return o.reshape(q.shape).to(q.dtype).contiguous(), lse


def flash_attention_bwd_dq_plain(q, k, v, o, lse, do, *, causal: bool = True,
                                 window: Optional[int] = None):
    """Plain PyTorch dQ kernel: ``(dq, D)``."""
    dsum = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    _, ds, _, _, scale = _grad_scores(q, k, v, lse, do, dsum, causal, window)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    return dq.reshape(q.shape).to(q.dtype).contiguous(), dsum


def flash_attention_bwd_dkdv_plain(q, k, v, lse, do, dsum, *,
                                   causal: bool = True,
                                   window: Optional[int] = None):
    """Plain PyTorch dK/dV kernel: ``(dk, dv)``."""
    p, ds, qg, dog, scale = _grad_scores(q, k, v, lse, do, dsum, causal,
                                         window)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    return dk.to(k.dtype).contiguous(), dv.to(v.dtype).contiguous()


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: Optional[int] = None):
    """Plain PyTorch backward from the saved ``lse``: ``(dq, dk, dv)``."""
    dq, dsum = flash_attention_bwd_dq_plain(q, k, v, o, lse, do,
                                            causal=causal, window=window)
    dk, dv = flash_attention_bwd_dkdv_plain(q, k, v, lse, do, dsum,
                                            causal=causal, window=window)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None):
    """``(o, lse)``: o like q, lse (B, Hq, S) float32."""
    _check("flash_attention_fwd", q, k, v, window,
           (torch.float32, torch.bfloat16))
    if probe.active():
        return probe.ops().flash_attention_fwd(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         window=window)
    _check_aligned("flash_attention_fwd", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                      dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    with torch.cuda.device(q.device):
        _raise_on(_library().flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), *_shape_args(q, k, causal, window),
            int(q.dtype == torch.bfloat16), _stream(q)),
            "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0

_RESOURCE_KEYS = ("registers", "local_bytes", "static_smem_bytes",
                  "dynamic_smem_bytes", "threads", "ctas_per_sm")


def _resources(entry: str, *args) -> dict:
    out = (ctypes.c_int * len(_RESOURCE_KEYS))()
    _raise_on(getattr(_library(), entry)(*args, out), entry)
    return dict(zip(_RESOURCE_KEYS, out))


def fwd_resources(hd: int, dtype=torch.float32) -> dict:
    """What the forward kernel's instance for a head dim and type takes on
    the current card: registers and local memory (spills) a thread, static
    and dynamic shared memory a CTA, threads a CTA and resident CTAs an SM
    (its persistent grid is that many CTAs an SM)."""
    return _resources("flash_attention_fwd_resources", hd,
                      int(dtype == torch.bfloat16))


def dq_resources(hd: int, dtype=torch.float32) -> dict:
    """What the dQ kernel's instance for a head dim and type takes on the
    current card, with :func:`fwd_resources`'s keys."""
    return _resources("flash_attention_bwd_dq_resources", hd,
                      int(dtype == torch.bfloat16))


def dkdv_resources(hd: int, dtype=torch.float32) -> dict:
    """What the dK/dV kernel's instance for a head dim and type takes on
    the current card, with :func:`fwd_resources`'s keys."""
    return _resources("flash_attention_bwd_dkdv_resources", hd,
                      int(dtype == torch.bfloat16))


def flash_attention_bwd_dq(q, k, v, o, lse, do, *, causal: bool = True,
                           window: Optional[int] = None):
    """``(dq, D)``: dq like q, ``D = rowsum(dO∘O)`` (B, Hq, S) float32."""
    _check("flash_attention_bwd_dq", q, k, v, window,
           (torch.float32, torch.bfloat16), o, do)
    _check_stats("flash_attention_bwd_dq", q, lse)
    if probe.active():
        return probe.ops().flash_attention_bwd_dq(q, k, v, o, lse, do,
                                                  causal, window)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, o, lse, do,
                                            causal=causal, window=window)
    _check_aligned("flash_attention_bwd_dq", q, k, v, o, do)
    dq = torch.empty_like(q)
    dsum = torch.empty_like(lse)
    if q.numel() == 0:
        return dq, dsum
    with torch.cuda.device(q.device):
        _raise_on(_library().flash_attention_bwd_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dsum.data_ptr(),
            *_shape_args(q, k, causal, window),
            int(q.dtype == torch.bfloat16), _stream(q)),
            "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq, dsum


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkdv(q, k, v, lse, do, dsum, *, causal: bool = True,
                             window: Optional[int] = None):
    """``(dk, dv)``, each like k, from the ``D`` of
    :func:`flash_attention_bwd_dq`."""
    _check("flash_attention_bwd_dkdv", q, k, v, window,
           (torch.float32, torch.bfloat16), do)
    _check_stats("flash_attention_bwd_dkdv", q, lse, dsum)
    if probe.active():
        return probe.ops().flash_attention_bwd_dkdv(q, k, v, lse, do, dsum,
                                                    causal, window)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkdv_plain(q, k, v, lse, do, dsum,
                                              causal=causal, window=window)
    _check_aligned("flash_attention_bwd_dkdv", q, k, v, do)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.numel() == 0:
        return dk, dv
    with torch.cuda.device(q.device):
        _raise_on(_library().flash_attention_bwd_dkdv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
            do.data_ptr(), dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_shape_args(q, k, causal, window),
            int(q.dtype == torch.bfloat16), _stream(q)),
            "flash_attention_bwd_dkdv")
    flash_attention_bwd_dkdv.launches += 1
    return dk, dv


flash_attention_bwd_dkdv.launches = 0
