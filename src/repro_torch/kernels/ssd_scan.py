"""The Mamba-2 SSD scan: a forward kernel and a deterministic backward
kernel, each beside its plain PyTorch version.

  * :func:`ssd_scan_fwd` — y of the chunked SSD scan (replaces the TPU
    package's ``kernels/ssd_scan.py::_ssd_kernel``);
  * :func:`ssd_scan_bwd` — ``(dx, ddt, dA, dBm, dCm)`` for an upstream
    ``dy``.  The TPU package has no backward kernel (its gradient flows
    through the jnp oracle on the CPU); this one is the port's own.

Shapes: x (B, S, H, P), dt (B, S, H), Bm and Cm (B, S, G, N) with H a
multiple of G (head h reads group ``h // (H // G)``), y like x.  A holds
negative decay rates, float32: (H,), shared by every sequence, or
(copies, H), copy c owning ``B / copies`` consecutive sequences — the
port's per-(row, device) parameter copies flattened into the batch.  dA
has A's shape.  ``chunk`` is the chunk of the plain (chunked) version;
S must be a multiple of ``min(chunk, S)``, as in the reference.  x, Bm
and Cm may be slices of the channels of one wider tensor (the conv
output): the kernels read them with their token stride, no copy.

On a CUDA tensor each function launches its hand-written kernel in
``csrc/ssd_scan.cu`` and adds one to its ``launches`` count; on a CPU
tensor it runs the plain version beside it.  There is no fallback: a CUDA
tensor either launches the kernel or raises (inside ``probe.probing()``
each emits its traced stand-in).  The forward takes x, Bm and
Cm in float32 or bfloat16 (one type), dt in float32 (as the reference's
scan reads it) or in x's type, and N up to 128; the kernel reads dt in
float32.  The backward takes the same types and N, and P a power of two
up to 128: it reads bf16 x, Bm, Cm and dy, computes in float32, and
writes dx, dBm and dCm in float32, which the wrapper rounds once to
their inputs' type (ddt to dt's, dA stays float32 as A).  Its CTAs own
units of a group's (head, p) rows: the whole group where it has at most
512 (N <= 16), 256 (N <= 32) or 128 rows, else head blocks of that many
rows, whose partial dBm and dCm a second pass sums in unit order.  Both
kernels sum over token pairs
within 16-token tiles (the dual form; states cross tiles only when S >
16): the forward y, the backward the gradient of the per-token
recurrence; the plain versions are the chunked
:func:`repro_torch.models.mamba2.ssd_reference` and its autograd.
:func:`fwd_resources` and :func:`bwd_resources` say what the kernels take
on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, probe
from repro_torch.models.mamba2 import ssd_reference

FWD_MAX_STATE = 128       # N the forward kernel takes
BWD_MAX_STATE = 128       # N the backward kernel takes
BWD_MAX_P = 128           # P the backward kernel takes (a power of two)
SEGMENT = 16              # tokens of one backward segment (csrc kSeg)


@functools.cache
def _library():
    """The built ``csrc/ssd_scan.cu`` with its C signatures."""
    c = build.load("ssd_scan").cdll
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dims = [i32] * 7 + [i64] * 3     # B, S, H, P, G, N, per_copy, ld x/B/C
    c.ssd_scan_fwd_launch.argtypes = [ptr] * 6 + dims + [i32, ptr]
    c.ssd_scan_bwd_launch.argtypes = [ptr] * 14 + dims + [i32, ptr]
    c.ssd_scan_bwd_units.argtypes = [i32] * 4 + [ptr]
    c.ssd_scan_fwd_resources.argtypes = [i32] * 6 + [ptr]
    c.ssd_scan_bwd_resources.argtypes = [i32] * 6 + [ptr]
    c.ssd_scan_fwd_launch.restype = i32
    c.ssd_scan_bwd_launch.restype = i32
    c.ssd_scan_bwd_units.restype = i32
    c.ssd_scan_fwd_resources.restype = i32
    c.ssd_scan_bwd_resources.restype = i32
    return c


def _token_stride(what: str, name: str, t) -> int:
    """Elements between consecutive tokens of a (B, S, heads, width)
    tensor whose (heads, width) block is packed: a contiguous tensor, or
    a slice of the channels of a wider one."""
    b, s, k, w = t.shape
    packed = (w == 1 or t.stride(3) == 1) and (k == 1 or t.stride(2) == w)
    ld = t.stride(1) if s > 1 else (t.stride(0) if b > 1 else k * w)
    if not packed or ld < k * w or (b > 1 and s > 1
                                    and t.stride(0) != s * ld):
        raise ValueError(f"{what}: {name} must be token rows with a packed "
                         f"(heads, width) block, got strides {t.stride()}")
    return ld


def _check(what: str, x, dt, A, Bm, Cm, chunk: int, dtypes, max_state: int,
           *like_x, dt_f32: bool = False):
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 4 or Bm.shape != Cm.shape:
        raise ValueError(f"{what}: x must be (B, S, H, P), dt (B, S, H) and "
                         f"Bm, Cm one (B, S, G, N) shape")
    b, s, h, _ = x.shape
    g = Bm.shape[2]
    if (tuple(dt.shape) != (b, s, h) or tuple(Bm.shape[:2]) != (b, s)
            or g == 0 or h % g):
        raise ValueError(f"{what}: dt {tuple(dt.shape)}, Bm "
                         f"{tuple(Bm.shape)} do not match x {tuple(x.shape)}"
                         " (H must be a multiple of G)")
    if (A.dim() not in (1, 2) or A.shape[-1] != h or A.dtype != torch.float32
            or (A.dim() == 2 and (A.shape[0] == 0 or b % A.shape[0]))):
        raise ValueError(f"{what}: A must be float32 (H,) or (copies, H) "
                         f"with B a multiple of copies, got "
                         f"{tuple(A.shape)} {A.dtype}")
    if chunk < 1 or s % min(chunk, max(s, 1)):
        raise ValueError(f"{what}: S={s} is not a multiple of chunk={chunk}")
    if any(t.shape != x.shape for t in like_x):
        raise ValueError(f"{what}: dy must have x's shape {tuple(x.shape)}")
    for t in (x, dt, Bm, Cm, *like_x):
        if t is dt and dt_f32 and dt.dtype == torch.float32:
            continue
        if t.dtype not in dtypes or t.dtype != x.dtype:
            raise ValueError(f"{what}: x, dt, Bm, Cm must share one dtype of "
                             f"{dtypes}, got {t.dtype} and {x.dtype}")
    for t in (x, dt, A, Bm, Cm, *like_x):
        if t.device != x.device:
            raise ValueError(f"{what}: tensors must be on one device")
    if x.device.type == "cuda":
        if Bm.shape[3] > max_state:
            raise ValueError(f"{what}: the kernel takes N <= {max_state}, "
                             f"got {Bm.shape[3]}")
        for t in (dt, A, *like_x):
            if not t.is_contiguous():
                raise ValueError(f"{what}: dt, A and dy must be contiguous")


def _dims(what: str, x, A, Bm, Cm):
    b, s, h, p = x.shape
    copies = A.shape[0] if A.dim() == 2 else 1
    return (b, s, h, p, Bm.shape[2], Bm.shape[3], b // copies,
            _token_stride(what, "x", x), _token_stride(what, "Bm", Bm),
            _token_stride(what, "Cm", Cm))


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{rc}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def ssd_scan_fwd_plain(x, dt, A, Bm, Cm, *, chunk: int = 256):
    """Plain PyTorch forward: the chunked scan, y in x's dtype."""
    return ssd_reference(x, dt, A, Bm, Cm, min(chunk, x.shape[1]))[0]


def ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy, *, chunk: int = 256):
    """Plain PyTorch backward: autograd of :func:`ssd_scan_fwd_plain`,
    ``(dx, ddt, dA, dBm, dCm)``, each in its input's type (in bf16 the
    scan computes in float32 and each gradient is rounded once, as the
    reference's oracle)."""
    leaves = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    with torch.enable_grad():
        y = ssd_scan_fwd_plain(*leaves, chunk=chunk)
        return torch.autograd.grad(y, leaves, dy)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def ssd_scan_fwd(x, dt, A, Bm, Cm, *, chunk: int = 256):
    """y (B, S, H, P) in x's dtype; dt float32 or x's dtype."""
    _check("ssd_scan_fwd", x, dt, A, Bm, Cm, chunk,
           (torch.float32, torch.bfloat16), FWD_MAX_STATE, dt_f32=True)
    if probe.active():
        return probe.ops().ssd_scan_fwd(x, dt, A, Bm, Cm, chunk)
    if x.device.type == "cpu":
        return ssd_scan_fwd_plain(x, dt, A, Bm, Cm, chunk=chunk)
    dt = dt.float()                  # exact; the kernel reads dt in f32
    dims = _dims("ssd_scan_fwd", x, A, Bm, Cm)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        _raise_on(_library().ssd_scan_fwd_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), *dims,
            int(x.dtype == torch.bfloat16), _stream(x)), "ssd_scan_fwd")
    ssd_scan_fwd.launches += 1
    return y


ssd_scan_fwd.launches = 0


def bwd_units(h: int, p: int, g: int, n: int) -> tuple:
    """``(units, rows)``: the backward's units a group and (head, p) rows
    of a unit at most, at a shape (H, P, G, N) it takes, as the kernel
    cuts them (``csrc/ssd_scan.cu::bwd_plan``)."""
    out = (ctypes.c_int * 2)()
    rc = _library().ssd_scan_bwd_units(h, p, g, n, out)
    if rc != 0:
        raise ValueError(f"ssd_scan_bwd: the kernel does not take (H, P, "
                         f"G, N) = {(h, p, g, n)}")
    return out[0], out[1]


def ssd_scan_bwd(x, dt, A, Bm, Cm, dy, *, chunk: int = 256):
    """``(dx, ddt, dA, dBm, dCm)``, each like its input (contiguous); dt
    float32 or x's dtype."""
    what = "ssd_scan_bwd"
    _check(what, x, dt, A, Bm, Cm, chunk, (torch.float32, torch.bfloat16),
           BWD_MAX_STATE, dy, dt_f32=True)
    if probe.active():
        return probe.ops().ssd_scan_bwd(x, dt, A, Bm, Cm, dy, chunk)
    if x.device.type == "cpu":
        return ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy, chunk=chunk)
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if p & (p - 1) or p > BWD_MAX_P:
        raise ValueError(f"{what}: the kernel takes P a power of two up to "
                         f"{BWD_MAX_P}, got P={p}")
    dt_in = dt.dtype
    dt = dt.float()                  # exact; the kernel reads dt in f32
    units, rows = bwd_units(h, p, g, n)
    dims = _dims(what, x, A, Bm, Cm)
    new = functools.partial(torch.empty, device=x.device,
                            dtype=torch.float32)
    dx, ddt, dA = new(x.shape), new(dt.shape), new(A.shape)
    dBm, dCm = new(Bm.shape), new(Cm.shape)
    if x.numel() == 0 or Bm.numel() == 0:
        grads = (dx.zero_(), ddt.zero_(), dA.zero_(), dBm.zero_(),
                 dCm.zero_())
    else:
        part = torch.empty((b, h), dtype=torch.float64, device=x.device)
        # the states and carries only across segments, per unit
        segments = -(-s // SEGMENT)
        ws = new((b * g * units * (segments + 1) * n * rows
                  if segments > 1 else 1,))
        # each unit's dBm and dCm where a group has more than one
        dbc = new((2 * units * Bm.numel(),) if units > 1 else (1,))
        with torch.cuda.device(x.device):
            _raise_on(_library().ssd_scan_bwd_launch(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
                dA.data_ptr(), dBm.data_ptr(), dCm.data_ptr(),
                part.data_ptr(), ws.data_ptr(), dbc.data_ptr(), *dims,
                int(x.dtype == torch.bfloat16), _stream(x)), what)
        ssd_scan_bwd.launches += 1
        grads = (dx, ddt, dA, dBm, dCm)
    dx, ddt, dA, dBm, dCm = grads
    # the kernel writes float32; each gradient is rounded once to its
    # input's type
    return (dx.to(x.dtype), ddt.to(dt_in), dA, dBm.to(Bm.dtype),
            dCm.to(Cm.dtype))


ssd_scan_bwd.launches = 0


_RESOURCE_KEYS = ("registers", "local_bytes", "static_smem_bytes",
                  "dynamic_smem_bytes", "ctas_per_sm", "threads")


def bwd_resources(h: int, p: int, g: int, n: int, dtype=torch.float32,
                  s: int = SEGMENT) -> dict:
    """What the backward's kernels take on the current card at a shape
    (H, P, G, N), sequence length S (beyond one segment the kernel stages
    a head block's state rows in shared memory) and input type: for
    ``ssd_bwd_kernel``,
    ``ssd_dA_reduce_kernel`` and ``ssd_dbc_reduce_kernel``, registers and
    local memory (spills) a thread, static and dynamic shared memory a
    CTA, resident CTAs and warps an SM, threads a CTA."""
    out = (ctypes.c_int * 18)()
    _raise_on(_library().ssd_scan_bwd_resources(
        h, p, g, n, s, int(dtype == torch.bfloat16), out),
        "ssd_scan_bwd_resources")
    res = {}
    for i, name in enumerate(("ssd_bwd_kernel", "ssd_dA_reduce_kernel",
                              "ssd_dbc_reduce_kernel")):
        rec = dict(zip(_RESOURCE_KEYS, out[6 * i:6 * i + 6]))
        rec["warps_per_sm"] = rec["ctas_per_sm"] * rec["threads"] // 32
        res[name] = rec
    return res


def fwd_resources(h: int, p: int, g: int, n: int) -> dict:
    """What the forward kernel takes on the current card at a shape (H, P,
    G, N), for each of its instances there: float32 and bfloat16, each
    without a state (S <= 16) and with one (S > 16, ``_carry``).  Each
    record: registers and local memory (spills) a thread, static and
    dynamic shared memory a CTA, resident CTAs and warps an SM (its
    persistent grid is that many CTAs an SM), threads a CTA."""
    res = {}
    for dtype in ("float32", "bfloat16"):
        for s, tag in ((SEGMENT, ""), (SEGMENT + 1, "_carry")):
            out = (ctypes.c_int * len(_RESOURCE_KEYS))()
            _raise_on(_library().ssd_scan_fwd_resources(
                h, p, g, n, s, int(dtype == "bfloat16"), out),
                "ssd_scan_fwd_resources")
            rec = dict(zip(_RESOURCE_KEYS, out))
            rec["warps_per_sm"] = rec["ctas_per_sm"] * rec["threads"] // 32
            res[dtype + tag] = rec
    return res
