#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --profile    # also a torch.profiler breakdown

It drives the port's FEEL paths through ``repro_torch.api.Experiment.run``
on the FEEL scheme with the Table-II fleet at K = 12 — the main path with
feel-mlp at full width (3072→256→256→10, 855 050 parameters, 16 rows),
the transformer family at the spec's defaults (feel-transformer-h256-d3:
d_model 256, 4 query / 2 KV heads of 64, SwiGLU 512, 16-token sequences,
1 836 800 parameters, 8 rows) and the mamba2 family at the spec's
defaults (feel-mamba2-h256-d3: d_model 256, 64 SSD heads of 8, state
16, chunk 4, 1 330 208 parameters, 8 rows) — and the token-decode
driver ``repro_torch.launch.serve.main`` at the full width of
mistral-nemo-12b (40 layers, d_model 5120, 32 query / 8 KV heads of 128,
12.25 B parameters in float32) and mamba2-2.7b, and holds every kernel of
those paths against its plain PyTorch version on the card:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
     (one nvcc per source, all started together);
  3. kernels against their plain versions at the paths' shapes, plus edge
     cases: the SBC pair (16 rows × 12 devices per leaf), ``compress_dense``
     on the card against the port's CPU path, and the flash-attention
     forward and backward (against the plain versions and autograd of the
     oracle; the forward also at 450 seams of S, window, group size and
     head dim in f32 and bf16; the forward and backward bitwise
     reproducible, the forward batch-invariant); 3c. the SSD scan
     forward and backward at the mamba2 cell's shape, four edge shapes and
     six seams of the backward (against the plain versions in float64, and
     in float32 wherever those are within half the tolerance of float64;
     the backward bitwise reproducible, and a copy's gradients bitwise
     alone and among 8); 3d. flash decode at the decode cell's shape
     and edge cases (pos 0, the last slot, the runs' seams at pos 31, 32,
     33 and where runs are empty, ring buffers, head dim 64 at g 1/4/8,
     a ragged ctx; f32 2e-5, bf16 2e-2; bitwise twice);
  4. the main path, with launch counts read around it;
  4b. the transformer cell and 4c. the mamba2 cell, each with launch
     counts read around it and held against the formula stated in
     PERF.md; 4d. ``launch.serve.main`` on mistral-nemo-12b (batch 8,
     prompt 128, 64 generated tokens, ctx 2048: 40 x 192 = 7 680 flash
     decode launches) and on mamba2-2.7b (none), each with its launch
     count, tokens/s and peak memory;
  5. the card against the port's CPU path (three periods of one row),
     chunked == monolithic bitwise on the card, and a padded row against
     its solo twin; 5b. the same for the transformer, 5c. for mamba2;
     5d. decode at the reduced configs (and a window of 8) over 12
     tokens: card vs CPU path (1e-4 in log-softmax) and decode vs the
     port's full-sequence forward on the card (2e-3);
  6. the SSD backward's and the attention forward's resources
     (registers, spills, shared memory, resident warps or CTAs an SM);
     kernel times (CUDA events, cold L2; the attention forward also on
     the card from the profiler) beside
     their bound, the plain versions' times and, for attention and
     decode, one PyTorch call
     (``scaled_dot_product_attention``) as a yardstick (none computes the
     SBC pair or the SSD scan in one call); flash decode also at one
     layer of a 32k-token cache (B 16) in bf16 and f32, with its time on
     the card from the profiler, the kernels a call puts there (must be
     1) and its resources (registers, spills, shared memory, runs).

Every phase that fails makes the script exit non-zero.  The last three
lines of standard output are the card's ``name, power.limit``, one JSON
object with the kernels' records, and ``{"ok": true, "device": ...}``.
It needs one CUDA device; without one (or outside a checkout) it exits
non-zero and prints no result.  With a card, the whole log and a JSON
report go to ``chiprun_out/chip_smoke.log`` and ``chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import itertools
import json
import subprocess
import sys
import time
from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# non-tensor-core float32 rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

# the main path's SBC segments: one per (row, device) upload of each leaf
LEAF_LENGTHS = (786_432, 256, 65_536, 256, 2_560, 10)
ROWS, DEVICES, RATIO = 16, 12, 0.005
PERIODS = 20

# the transformer cell: 8 rows x 12 devices x 128 slots of 16-token
# sequences per gradient forward; its attention shape per forward
T_ROWS, T_PERIODS, SEQ = 8, 10, 16
T_SHAPE = (T_ROWS * DEVICES * 128, SEQ, 4, 2, 64)      # B, S, Hq, Hkv, hd
# launches a period: 4 forwards (loss before, gradient, loss after, test)
# x 3 layers; one backward x 3 layers; SBC of the 12 stacked leaves
T_LAUNCHES = {"flash_attention_fwd": 12, "flash_attention_bwd_dq": 3,
              "flash_attention_bwd_dkdv": 3, "sbc_stats": 12,
              "sbc_apply": 12}
ATTN_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
# the attention kernels' cases (B, S, Hq, Hkv, hd, causal, window): the
# cell's shape, longer sequences, windows, a ragged S, non-causal
ATTN_CASES = [T_SHAPE + (True, None), (4, 128, 4, 2, 64, True, None),
              (4, 256, 4, 2, 128, True, 64), (4, 100, 4, 2, 64, True, 16),
              (4, 100, 4, 2, 128, False, None),
              (4, 256, 4, 1, 64, False, 16)]
# the forward's seams, every combination at B 3 over 2 KV heads: S around
# its 16-key tiles, windows around them, group sizes g and head dims
ATTN_SEAMS = {"S": (1, 15, 16, 17, 33), "window": (None, 1, 8, 16, 17),
              "causal": (True, False), "g": (1, 2, 4), "hd": (32, 64, 128)}
# the mamba2 cell: the same rows and sequences; its SSD shape per forward
# (copies = rows x devices, each with 128 sequences; B, S, H, P, G, N,
# chunk) and its launches a period (the same 4 forwards and 1 backward
# over 3 layers, the same 12 stacked leaves)
M_ROWS, M_PERIODS = 8, 10
M_COPIES = M_ROWS * DEVICES
M_SHAPE = (M_COPIES * 128, SEQ, 64, 8, 1, 16, 4)
M_LAUNCHES = {"ssd_scan_fwd": 12, "ssd_scan_bwd": 3, "sbc_stats": 12,
              "sbc_apply": 12}
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
# the backward's seams (copies, B per copy, S, H, P, G, N, chunk): one
# 16-token segment exactly; a ragged last segment (S 17, 40: the states
# and carries across segments); G 4 at the admitted (H / G) * P (512 at N
# 16, 128 at N 64); P 1 with rows that are not 16-byte aligned
SSD_BWD_SEAMS = [(2, 2, 16, 8, 16, 2, 32, 16), (2, 2, 17, 8, 8, 1, 16, 17),
                 (1, 3, 40, 4, 32, 2, 64, 40), (1, 2, 32, 256, 8, 4, 16, 16),
                 (1, 2, 24, 16, 32, 4, 64, 24), (1, 2, 20, 6, 1, 2, 16, 20)]
# the decode cell: launch.serve at full width, prefill by stepping the
# decode path over the prompt, then greedy decode; mistral-nemo-12b's
# cache (B, ctx, Hq, Hkv, hd) per layer and the last position the path
# decodes; one layer of a 32k-token cache
D_ARCHS = ("mistral-nemo-12b", "mamba2-2.7b")
D_BATCH, D_PROMPT, D_GEN, D_CTX = 8, 128, 64, 2048
D_ARGV = ["--full", "--batch", str(D_BATCH), "--prompt-len", str(D_PROMPT),
          "--gen", str(D_GEN), "--ctx", str(D_CTX)]
D_LAYERS = {"mistral-nemo-12b": 40, "mamba2-2.7b": 0}   # attention layers
D_SHAPE = (D_BATCH, D_CTX, 32, 8, 128)
D_POS = D_PROMPT + D_GEN - 1
D_LONG = (16, 32_768, 32, 8, 128)
# the runs' seams (B, ctx, Hq, Hkv, hd, pos, window): the first tile's last
# slot and the second's first; pos below 32 x the runs, where runs are
# empty; a ring not yet wrapped; two tiles, the second ragged
D_SEAMS = [D_SHAPE + (31, None), D_SHAPE + (32, None), D_SHAPE + (33, None),
           D_SHAPE + (100, None), (2, 256, 8, 2, 64, 40, 256),
           (2, 40, 8, 2, 64, 39, None)]
DECODE_SOURCE = "src/repro_torch/kernels/csrc/flash_decode.cu"
SOURCES = ("sbc", "flash_attention", "ssd_scan", "flash_decode")


class _Log:
    """Where log lines also go once the run has a card: the report
    directory's ``chip_smoke.log`` (standard output may be cut)."""
    file = None


def log(msg: str) -> None:
    print(msg, flush=True)
    if _Log.file is not None:
        _Log.file.write(msg + "\n")
        _Log.file.flush()


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    if _Log.file is not None:
        _Log.file.write(f"FAIL: {msg}\n")
        _Log.file.flush()
    return 1


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def fleet(DeviceProfile, k: int):
    """Table-II CPU fleet: f_cpu tiers 0.7 / 1.4 / 2.1 GHz."""
    tiers = [0.7e9, 1.4e9, 2.1e9]
    return tuple(DeviceProfile(kind="cpu", f_cpu=tiers[i % 3])
                 for i in range(k))


def cold_ms(torch, fn, iters: int = 20) -> float:
    """Median time of ``fn`` on the card with the 50 MB L2 flushed before
    every call (CUDA events around the call alone)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_ms(torch, fn, name: str, iters: int = 20):
    """The card's own time of ``fn`` under torch.profiler, with the L2
    flushed before every call as in :func:`cold_ms`, so that no host time
    counts as kernel time: (milliseconds a call in the kernels whose names
    hold ``name``, and medians over the calls of the kernels a call puts on
    the card besides the flush and of its span there, from its first
    kernel's start to its last kernel's end, gaps between them included)."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    us, calls = 0.0, []             # calls: [first start, last end, count]
    for e in kernels:
        if "Fill" in e.name:                 # the flush opens the next call
            calls.append(None)
            continue
        if name in e.name:
            us += e.time_range.end - e.time_range.start
        if not calls or calls[-1] is None:
            calls.append([e.time_range.start, e.time_range.end, 0])
        calls[-1][1:] = [e.time_range.end, calls[-1][2] + 1]
    calls = [c for c in calls if c is not None]
    if not calls:
        return float("nan"), 0.0, float("nan")
    median = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    return (us / 1e3 / iters, median([c[2] for c in calls]),
            median([c[1] - c[0] for c in calls]) / 1e3)


def attention_inputs(torch, gen, b, s, hq, hkv, hd, dtype=None):
    dtype = dtype or torch.float32
    return tuple(torch.randn((b, s, h, hd), generator=gen, device="cuda")
                 .to(dtype) for h in (hq, hkv, hkv))


def attention_oracle(attention_ref, q, k, v, causal, window):
    """The plain oracle over the (BH, S, hd) layout after GQA expansion."""
    b, s, hq, hd = q.shape
    g = hq // k.shape[2]

    def flat(t):
        return t.transpose(1, 2).reshape(b * hq, s, hd)
    out = attention_ref(flat(q), flat(k.repeat_interleave(g, 2)),
                        flat(v.repeat_interleave(g, 2)), causal=causal,
                        window=window)
    return out.reshape(b, hq, s, hd).transpose(1, 2)


def attention_checks(torch, kfa, kops, attention_ref):
    """The three attention kernels against their plain versions on the
    card (forward 2e-5, bf16 forward 2e-2, lse 2e-5, backward 1e-4 against
    the plain backward and autograd of the oracle) at ``ATTN_CASES``; the
    forward at every seam of ``ATTN_SEAMS`` in f32 and bf16, with the
    backward from its lse in f32; the forward run twice bitwise; the first
    and a middle sequence of the cell's batch alone bitwise the same rows
    of the whole launch; and the backward run twice bitwise.  Returns the
    max abs errors of the comparisons with the plain versions; raises
    AssertionError on a disagreement."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {"flash_attention_fwd": 0.0, "flash_attention_bwd_dq": 0.0,
            "flash_attention_bwd_dkdv": 0.0, "bf16_fwd": 0.0,
            "bwd_vs_autograd": 0.0, "seams": 0}

    def close(key, got, want, tol, label):
        got, want = got.float(), want.float()
        if not torch.allclose(got, want, rtol=tol, atol=tol):
            raise AssertionError(
                f"{label}: {key} beyond {tol} (max abs err "
                f"{float((got - want).abs().max()):.3g})")
        errs[key] = max(errs[key], float((got - want).abs().max()))

    def forward(q, k, v, opts, label, bf16_key="bf16_fwd"):
        """The forward in f32 and bf16 against the plain version, each
        run twice bitwise; returns the f32 (o, lse)."""
        out = None
        for dtype, key, tol in ((torch.float32, "flash_attention_fwd", 2e-5),
                                (torch.bfloat16, bf16_key, 2e-2)):
            qq, kk, vv = (t.to(dtype) for t in (q, k, v))
            o, lse = kfa.flash_attention_fwd(qq, kk, vv, **opts)
            po, plse = kfa.flash_attention_fwd_plain(qq, kk, vv, **opts)
            close(key, o, po, tol, f"{label} {dtype}")
            close("flash_attention_fwd", lse, plse, 2e-5,
                  f"{label} {dtype} lse")
            o2, lse2 = kfa.flash_attention_fwd(qq, kk, vv, **opts)
            if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                raise AssertionError(f"{label} {dtype}: the forward is not "
                                     "bitwise reproducible")
            if out is None:
                out = (o, lse)
        return out

    def backward(q, k, v, o, lse, opts, label, autograd=True):
        do = torch.randn(q.shape, generator=gen, device="cuda")
        dq, dsum = kfa.flash_attention_bwd_dq(q, k, v, o, lse, do, **opts)
        dk, dv = kfa.flash_attention_bwd_dkdv(q, k, v, lse, do, dsum, **opts)
        pdq, pdk, pdv = kfa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                      **opts)
        close("flash_attention_bwd_dq", dq, pdq, 1e-4, label)
        close("flash_attention_bwd_dkdv", dk, pdk, 1e-4, label + " dk")
        close("flash_attention_bwd_dkdv", dv, pdv, 1e-4, label + " dv")
        if autograd:
            causal, window = opts["causal"], opts["window"]
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            auto = torch.autograd.grad(
                attention_oracle(attention_ref, *leaves, causal, window),
                leaves, do)
            for got, want in zip((dq, dk, dv), auto):
                close("bwd_vs_autograd", got, want, 1e-4,
                      label + " autograd")

    for b, s, hq, hkv, hd, causal, window in ATTN_CASES:
        label = (f"attention B={b} S={s} Hq={hq} Hkv={hkv} hd={hd} "
                 f"causal={causal} window={window}")
        opts = dict(causal=causal, window=window)
        q, k, v = attention_inputs(torch, gen, b, s, hq, hkv, hd)
        o, lse = forward(q, k, v, opts, label)
        if (b, s, hq, hkv, hd) == T_SHAPE:     # batch-invariant, bitwise
            for i in (0, b // 2):
                oi, li = kfa.flash_attention_fwd(q[i:i + 1], k[i:i + 1],
                                                 v[i:i + 1], **opts)
                if not (torch.equal(oi, o[i:i + 1])
                        and torch.equal(li, lse[i:i + 1])):
                    raise AssertionError(
                        f"{label}: sequence {i} alone differs from the "
                        "same rows of the whole batch")
        backward(q, k, v, o, lse, opts, label)
        del q, k, v, o, lse
    for s, window, causal, g, hd in itertools.product(*ATTN_SEAMS.values()):
        label = (f"attention seam B=3 S={s} Hq={2 * g} Hkv=2 hd={hd} "
                 f"causal={causal} window={window}")
        opts = dict(causal=causal, window=window)
        q, k, v = attention_inputs(torch, gen, 3, s, 2 * g, 2, hd)
        o, lse = forward(q, k, v, opts, label)
        backward(q, k, v, o, lse, opts, label, autograd=False)
        errs["seams"] += 1
    q, k, v = (t.requires_grad_() for t in attention_inputs(
        torch, gen, *T_SHAPE[:5]))
    do = torch.randn(q.shape, generator=gen, device="cuda")
    runs = [torch.autograd.grad(kops.flash_attention(q, k, v), (q, k, v), do)
            for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("the attention backward is not bitwise "
                             "reproducible")
    return errs


def attention_bound(torch, q, k, causal, window):
    """(bound_ms, bound_by, bytes, ops) of one attention forward: q, k, v
    read once, o and the f32 lse written once, over 3.35 TB/s, against the
    visible (query, key) pairs' 4 hd + 4 operations over the peak rate of
    the inputs' type."""
    b, s, hq, hd = q.shape
    pos = torch.arange(s)
    mask = torch.ones((s, s), dtype=torch.bool)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    pairs = b * hq * int(mask.sum())
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + 4 * b * hq * s
    ops = pairs * (4 * hd + 4)
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    bound_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    bound_ops = 1e3 * ops / rate
    return (max(bound_bytes, bound_ops),
            "bytes" if bound_bytes >= bound_ops else "operations", nbytes,
            ops)


def sdpa_call(torch, F, q, k, v, causal, window):
    """``scaled_dot_product_attention`` on the (B, H, S, hd) views of the
    same inputs (GQA by ``enable_gqa``; a window as a boolean mask): one
    PyTorch call for the forward, the yardstick of the kernel."""
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    s = q.shape[1]
    mask = None
    if window is not None:
        pos = torch.arange(s, device=q.device)
        mask = pos[None, :] > pos[:, None] - window
        if causal:
            mask &= pos[None, :] <= pos[:, None]

    def call():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)
    return call


def attention_times(torch, kfa, F):
    """Cold-L2 median times at the transformer cell's attention shape:
    each kernel, its plain version, and scaled_dot_product_attention
    (forward; forward + backward for the backward kernels) as a
    yardstick.  Bounds: bytes moved (each input read once, each output
    written once) over 3.35 TB/s vs the visible pairs' f32 operations
    over 67 TFLOP/s."""
    b, s, hq, hkv, hd = T_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = attention_inputs(torch, gen, b, s, hq, hkv, hd)
    do = torch.randn(q.shape, generator=gen, device="cuda")
    o, lse = kfa.flash_attention_fwd(q, k, v)
    _, dsum = kfa.flash_attention_bwd_dq(q, k, v, o, lse, do)
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                             enable_gqa=True)
        return torch.autograd.grad(out, leaves, dot)

    pairs = b * hq * s * (s + 1) // 2          # visible (query, key) pairs
    size = {"q": q.numel() * 4, "kv": k.numel() * 4, "stat": lse.numel() * 4}
    runs = {
        "flash_attention_fwd": (
            lambda: kfa.flash_attention_fwd(q, k, v),
            lambda: kfa.flash_attention_fwd_plain(q, k, v),
            sdpa_call(torch, F, q, k, v, True, None),
            *attention_bound(torch, q, k, True, None)[2:]),
        "flash_attention_bwd_dq": (
            lambda: kfa.flash_attention_bwd_dq(q, k, v, o, lse, do),
            lambda: kfa.flash_attention_bwd_dq_plain(q, k, v, o, lse, do),
            sdpa_fwd_bwd, 4 * size["q"] + 2 * size["kv"] + 2 * size["stat"],
            pairs * (6 * hd + 4) + b * hq * s * 2 * hd),
        "flash_attention_bwd_dkdv": (
            lambda: kfa.flash_attention_bwd_dkdv(q, k, v, lse, do, dsum),
            lambda: kfa.flash_attention_bwd_dkdv_plain(q, k, v, lse, do,
                                                       dsum),
            sdpa_fwd_bwd, 2 * size["q"] + 4 * size["kv"] + 2 * size["stat"],
            pairs * (8 * hd + 4)),
    }
    out = {}
    for name, (kern, plain, lib, nbytes, ops) in runs.items():
        bound_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        bound_ops = 1e3 * ops / F32_OPS_PER_S
        out[name] = {"ms": cold_ms(torch, kern),
                     "plain_ms": cold_ms(torch, plain),
                     "library_ms": cold_ms(torch, lib),
                     "bound_ms": max(bound_bytes, bound_ops),
                     "bound_by": ("bytes" if bound_bytes >= bound_ops
                                  else "operations"),
                     "bytes": nbytes, "ops": ops}
    out["flash_attention_fwd"]["device_ms"] = device_ms(
        torch, runs["flash_attention_fwd"][0], "fwd_kernel")[0]
    return out


def ssd_inputs(torch, gen, copies, per, s, h, p, g, n):
    """SSD inputs as the reference's kernel tests draw them, with x, Bm
    and Cm slices of one conv-like tensor (token stride h*p + 2*g*n), as
    on the mamba2 path; A is per copy; and an upstream dy."""
    b = copies * per
    scale = torch.full((h * p + 2 * g * n,), 0.5, device="cuda")
    scale[:h * p] = 1.0
    conv = torch.randn((b, s, scale.numel()), generator=gen,
                       device="cuda") * scale
    x = conv[..., :h * p].reshape(b, s, h, p)
    bm = conv[..., h * p:h * p + g * n].reshape(b, s, g, n)
    cm = conv[..., h * p + g * n:].reshape(b, s, g, n)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen,
                                                  device="cuda"))
    a = -torch.exp(torch.randn((copies, h), generator=gen, device="cuda")
                   * 0.3)
    dy = torch.randn((b, s, h, p), generator=gen, device="cuda")
    return (x, dt, a, bm, cm), dy


def close_to_plain(torch, got, plain, exact, tol, label):
    """got within tol (rtol = atol) of the plain version run in float64,
    everywhere, and of the float32 plain version wherever that is itself
    within tol / 2 of float64.  Returns (max abs err vs float32 plain over
    all elements, vs float64, the float32 plain version's own max abs err
    vs float64, elements left out of the float32 comparison); raises
    AssertionError."""
    exact = exact.double()
    err = float((got.double() - exact).abs().max())
    if not torch.allclose(got.double(), exact, rtol=tol, atol=tol):
        raise AssertionError(f"{label}: beyond {tol} of the float64 plain "
                             f"version (max abs err {err:.3g})")
    sound = (plain.double() - exact).abs() <= tol / 2 * (1 + exact.abs())
    if not torch.allclose(got[sound].float(), plain[sound].float(), rtol=tol,
                          atol=tol):
        raise AssertionError(f"{label}: beyond {tol} of the plain version")
    return (float((got.float() - plain.float()).abs().max()), err,
            float((plain.double() - exact).abs().max()), int((~sound).sum()))


def ssd_checks(torch, kssd, kops):
    """The SSD kernels against their plain versions on the card: forward
    2e-5 (bf16 2e-2), backward 1e-4, each against the plain version in
    float64 and in float32 (where sound), at the mamba2 cell's shape and
    at the reference's four kernel-test shapes; the backward run twice
    bitwise.  Returns the max abs errors; raises AssertionError."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    errs = {"ssd_scan_fwd": 0.0, "ssd_scan_bwd": 0.0, "bf16_fwd": 0.0,
            "fwd_vs_f64": 0.0, "bwd_vs_f64": 0.0, "plain_fwd_vs_f64": 0.0,
            "plain_bwd_vs_f64": 0.0, "left_out": 0}
    b, s, h, p, g, n, chunk = M_SHAPE
    cases = [(M_COPIES, b // M_COPIES, s, h, p, g, n, chunk),
             (2, 1, 128, 4, 32, 2, 16, 32), (1, 1, 64, 2, 64, 1, 32, 16),
             (1, 2, 256, 8, 32, 4, 64, 64), (1, 1, 128, 4, 32, 4, 16, 128)]
    cases += SSD_BWD_SEAMS

    def note(key, f64_key, got):
        errs[key] = max(errs[key], got[0])
        errs[f64_key] = max(errs[f64_key], got[1])
        errs[f"plain_{f64_key}"] = max(errs[f"plain_{f64_key}"], got[2])
        errs["left_out"] += got[3]

    for copies, per, s, h, p, g, n, chunk in cases:
        label = (f"ssd copies={copies} B={copies * per} S={s} H={h} P={p} "
                 f"G={g} N={n} chunk={chunk}")
        ins, dy = ssd_inputs(torch, gen, copies, per, s, h, p, g, n)
        y = kssd.ssd_scan_fwd(*ins, chunk=chunk)
        exact_in = [t.double() for t in ins]
        note("ssd_scan_fwd", "fwd_vs_f64", close_to_plain(
            torch, y, kssd.ssd_scan_fwd_plain(*ins, chunk=chunk),
            kssd.ssd_scan_fwd_plain(*exact_in, chunk=chunk), 2e-5, label))
        bf = [t.bfloat16() for t in ins]
        bf[2] = ins[2]                                   # A stays float32
        yb = kssd.ssd_scan_fwd(*bf, chunk=chunk).float()
        pb = kssd.ssd_scan_fwd_plain(*bf, chunk=chunk).float()
        if not torch.allclose(yb, pb, rtol=2e-2, atol=2e-2):
            raise AssertionError(f"{label}: bf16 forward beyond 2e-2")
        errs["bf16_fwd"] = max(errs["bf16_fwd"],
                               float((yb - pb).abs().max()))
        got = kssd.ssd_scan_bwd(*ins, dy, chunk=chunk)
        plain = kssd.ssd_scan_bwd_plain(*ins, dy, chunk=chunk)
        exact = kssd.ssd_scan_bwd_plain(*exact_in, dy.double(), chunk=chunk)
        for name, a, pl, ex in zip(("dx", "ddt", "dA", "dBm", "dCm"), got,
                                   plain, exact):
            note("ssd_scan_bwd", "bwd_vs_f64",
                 close_to_plain(torch, a, pl, ex, 1e-4, f"{label} {name}"))
        del ins, dy, y, exact_in, bf, got, plain, exact
        torch.cuda.empty_cache()
    ins, dy = ssd_inputs(torch, gen, *cases[0][:7])
    leaves = [t.detach().clone().requires_grad_() for t in ins]
    runs = [torch.autograd.grad(kops.ssd(*leaves, chunk=M_SHAPE[-1]), leaves,
                                dy) for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("the SSD backward is not bitwise reproducible")
    # one copy launched alone against the same copy among 8: bitwise
    _, _, s, h, p, g, n, chunk = cases[0]
    k, per = 3, 16
    ins, dy = ssd_inputs(torch, gen, 8, per, s, h, p, g, n)
    among = kssd.ssd_scan_bwd(*ins, dy, chunk=chunk)
    seqs = slice(k * per, (k + 1) * per)
    alone = kssd.ssd_scan_bwd(*(t[seqs] for t in ins[:2]), ins[2][k:k + 1],
                              *(t[seqs] for t in ins[3:]), dy[seqs],
                              chunk=chunk)
    for name, a, m in zip(("dx", "ddt", "dA", "dBm", "dCm"), alone, among):
        if not torch.equal(a, m[k:k + 1] if name == "dA" else m[seqs]):
            raise AssertionError(f"the SSD backward of copy {k} alone is not "
                                 f"bitwise the same copy among 8 ({name})")
    return errs


def ssd_work(ins, dy):
    """Bytes (each input read once, each output written once) and f32
    operations of the SSD kernels at a one-segment shape (S <= 16): the
    forward's per-token recurrence, 5N + 2 a (sequence, token, head, p)
    row (the state update a*h + u*B and y = h.C); the backward's sums over
    the token pairs s <= t of a sequence, 4P + 8 a (pair, head) (dy_t .
    x_s, the dx update, the decay, W, W CB, the dx weight, the sums over
    heads and pairs), 4N a (pair, group) (C_t . B_s, dB, dC) and P + 4 a
    (token, head) (dx, ddt, dA)."""
    x, dt, a, bm, cm = ins
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    read = 4 * (x.numel() + dt.numel() + a.numel() + bm.numel() + cm.numel())
    pairs = b * s * (s + 1) // 2
    return {"ssd_scan_fwd": (read + 4 * x.numel(), b * s * h * p * (5 * n + 2)),
            "ssd_scan_bwd": (2 * read + 4 * dy.numel(),
                             pairs * h * (4 * p + 8) + pairs * g * 4 * n
                             + b * s * h * (p + 4))}


def bound(nbytes, ops):
    """(bound_ms, bound_by): bytes over 3.35 TB/s vs f32 operations over
    67 TFLOP/s."""
    bound_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    bound_ops = 1e3 * ops / F32_OPS_PER_S
    return (max(bound_bytes, bound_ops),
            "bytes" if bound_bytes >= bound_ops else "operations")


def ssd_times(torch, kssd):
    """Cold-L2 median times at the mamba2 cell's SSD shape (x, Bm, Cm
    slices of the conv output, as on the path): each kernel and its plain
    version, beside the bound of :func:`ssd_work`."""
    b, s, h, p, g, n, chunk = M_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(4)
    ins, dy = ssd_inputs(torch, gen, M_COPIES, b // M_COPIES, s, h, p, g, n)
    work = ssd_work(ins, dy)
    runs = {
        "ssd_scan_fwd": (lambda: kssd.ssd_scan_fwd(*ins, chunk=chunk),
                         lambda: kssd.ssd_scan_fwd_plain(*ins, chunk=chunk)),
        "ssd_scan_bwd": (lambda: kssd.ssd_scan_bwd(*ins, dy, chunk=chunk),
                         lambda: kssd.ssd_scan_bwd_plain(*ins, dy,
                                                         chunk=chunk)),
    }
    out = {}
    for name, (kern, plain) in runs.items():
        nbytes, ops = work[name]
        bound_ms, bound_by = bound(nbytes, ops)
        out[name] = {"ms": cold_ms(torch, kern),
                     "plain_ms": cold_ms(torch, plain),
                     "library_ms": None, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bytes": nbytes, "ops": ops}
    return out


def decode_inputs(torch, gen, b, ctx, hq, hkv, hd, dtype=None):
    """q (B, 1, Hq, hd) and the caches (B, ctx, Hkv, hd), as the model
    stores them."""
    dtype = dtype or torch.float32
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                 for shape in ((b, 1, hq, hd), (b, ctx, hkv, hd),
                               (b, ctx, hkv, hd)))


def decode_checks(torch, kfd):
    """Flash decode against its plain version on the card: f32 2e-5,
    bf16 2e-2, at the decode cell's shape at the path's last position,
    pos 0 and the last slot, the runs' seams (``D_SEAMS``), ring
    buffers (pos < ctx and pos 1000), head
    dim 64 at g 1, 4 and 8, and a ctx that is not a multiple of the
    kernel's 32-slot tile; every case run twice and required bitwise
    equal.  Returns the max abs errors; raises AssertionError."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    errs = {"flash_decode": 0.0, "bf16": 0.0}
    b, ctx, hq, hkv, hd = D_SHAPE
    cases = [D_SHAPE + (D_POS, None), D_SHAPE + (0, None),
             D_SHAPE + (ctx - 1, None), *D_SEAMS,
             (4, 256, 8, 2, 64, 100, 256), (4, 256, 8, 2, 64, 1000, 256),
             (4, 512, 16, 4, 128, 700, 128),
             (4, 256, 8, 8, 64, 200, None), (4, 256, 8, 2, 64, 200, None),
             (4, 256, 64, 8, 64, 255, 64), (3, 1000, 32, 8, 128, 999, None),
             (3, 1000, 32, 8, 128, 5000, None)]
    for b, ctx, hq, hkv, hd, pos, window in cases:
        label = (f"flash_decode B={b} ctx={ctx} Hq={hq} Hkv={hkv} hd={hd} "
                 f"pos={pos} window={window}")
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        for dtype, tol, key in ((torch.float32, 2e-5, "flash_decode"),
                                (torch.bfloat16, 2e-2, "bf16")):
            q, k, v = decode_inputs(torch, gen, b, ctx, hq, hkv, hd, dtype)
            got = kfd.flash_decode(q, k, v, p, window=window)
            want = kfd.flash_decode_plain(q, k, v, p, window=window)
            err = float((got.float() - want.float()).abs().max())
            if not torch.allclose(got.float(), want.float(), rtol=tol,
                                  atol=tol):
                raise AssertionError(f"{label} {dtype}: beyond {tol} of the "
                                     f"plain version (max abs err {err:.3g})")
            if not torch.equal(got, kfd.flash_decode(q, k, v, p,
                                                     window=window)):
                raise AssertionError(f"{label} {dtype}: not bitwise "
                                     "reproducible")
            errs[key] = max(errs[key], err)
    return errs


def decode_cell(torch, serve, kfd, arch):
    """``launch.serve.main`` at full width on ``arch`` with the flash
    decode launch count set to 0 just before and read just after (held
    against one launch per attention layer and step); the driver's own
    lines go to the log.  Returns the report; raises AssertionError (the
    driver raises on non-finite logits)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kfd.flash_decode.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        tps = serve.main(["--arch", arch] + D_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kfd.flash_decode.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    for line in out.getvalue().splitlines():
        log(f"[4d decode]   {line}")
    want = D_LAYERS[arch] * (D_PROMPT + D_GEN)
    ms = 1e3 * D_BATCH / tps
    log(f"[4d decode] launch.serve.main --arch {arch} {' '.join(D_ARGV)}: "
        f"{tps:.1f} tokens/s = {ms:.2f} ms per decode step (batch "
        f"{D_BATCH}); whole call {wall:.2f} s (init, prefill, decode); "
        f"peak device memory {peak:.2f} GiB; flash_decode launches "
        f"{launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"4d {arch}: flash_decode launches {launches}, "
                             f"expected {want}")
    if not tps > 0:
        raise AssertionError(f"4d {arch}: rate {tps}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"tokens_per_s": tps, "ms_per_step": ms, "wall_s": wall,
            "peak_gib": peak, "launches": {"flash_decode": launches},
            "argv": ["--arch", arch] + D_ARGV}


def decode_contracts(torch, tm, get_arch, tree_map):
    """Decode at the reduced configs (and mistral-nemo-12b with a window
    of 8, a ring buffer) over 12 tokens of 2 sequences: the card against
    the CPU path (1e-4 in log-softmax), and decode against the port's
    full-sequence forward on the card (2e-3, the reference's bound).
    Returns the max errors; raises AssertionError."""
    n, b = 12, 2
    errs = {}
    for arch, window in (("mistral-nemo-12b", None), ("mistral-nemo-12b", 8),
                         ("mamba2-2.7b", None)):
        cfg = get_arch(arch).reduced()
        if window is not None:
            cfg = dataclasses.replace(cfg, attn_window=window)
        params = tm.init(cfg, torch.Generator().manual_seed(0))
        card = tree_map(lambda t: t.cuda(), params)
        toks = torch.randint(0, cfg.vocab, (b, n),
                             generator=torch.Generator().manual_seed(1))
        caches = [tm.init_cache(cfg, b, n),
                  tm.init_cache(cfg, b, n, device="cuda")]
        on_cpu, on_card = [], []
        for t in range(n):
            lc, caches[0] = tm.decode_step(cfg, params, caches[0],
                                           toks[:, t:t + 1])
            lg, caches[1] = tm.decode_step(cfg, card, caches[1],
                                           toks[:, t:t + 1].cuda())
            on_cpu.append(lc)
            on_card.append(lg)
        lsm = lambda x: torch.log_softmax(  # noqa: E731
            torch.cat(x, 1)[..., :cfg.vocab].float().cpu(), -1)
        full = tm.forward(cfg, tree_map(lambda t: t[None], card),
                          toks.cuda()[None])[0]
        cpu_err = float((lsm(on_card) - lsm(on_cpu)).abs().max())
        fwd_err = float((lsm(on_card) - lsm([full])).abs().max())
        label = f"{cfg.name} window={window}"
        log(f"[5d decode] {label}: {n} tokens card vs CPU path log-softmax "
            f"max abs err {cpu_err:.3g} (tol 1e-4); decode vs forward on the "
            f"card {fwd_err:.3g} (tol 2e-3)")
        if not (cpu_err <= 1e-4 and fwd_err <= 2e-3):
            raise AssertionError(f"5d {label}: card vs CPU {cpu_err:.3g}, "
                                 f"decode vs forward {fwd_err:.3g}")
        errs[label] = {"card_vs_cpu": cpu_err, "decode_vs_forward": fwd_err}
    return errs


def decode_bound(torch, q, k, pos):
    """(bound_ms, bound_by, bytes, ops) of one flash-decode call: the bytes
    it needs (q and o once, the visible K/V slots once) over 3.35 TB/s vs
    the f32 operations of the visible (row, slot) pairs (4 hd + 4 each)
    over the peak rate of the inputs' type."""
    b, _, hq, hd = q.shape
    ctx, hkv = k.shape[1], k.shape[2]
    esize = q.element_size()
    visible = min(pos + 1, ctx)
    nbytes = 2 * q.numel() * esize + 2 * b * visible * hkv * hd * esize
    ops = b * hq * visible * (4 * hd + 4)
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    bound_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    bound_ops = 1e3 * ops / rate
    return (max(bound_bytes, bound_ops),
            "bytes" if bound_bytes >= bound_ops else "operations", nbytes,
            ops)


def decode_times(torch, kfd, F):
    """Cold-L2 median times of flash decode, its plain version and
    ``scaled_dot_product_attention`` (a boolean mask of the visible
    slots, ``enable_gqa=True``, over the cache's (B, Hkv, ctx, hd) view)
    at the decode cell's shape at the path's last position (f32) and at
    one layer of a full 32k-token cache (bf16 and f32), beside the bound
    of :func:`decode_bound`.  Beside the
    CUDA-event time (the wrapper's host work included): the card's own
    time a call from the profiler and the kernels a call puts on the card,
    and the kernel's resources at the shape."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for key, shape, pos, dtype in (
            ("path", D_SHAPE, D_POS, torch.float32),
            ("32k_bf16", D_LONG, D_LONG[1] - 1, torch.bfloat16),
            ("32k_f32", D_LONG, D_LONG[1] - 1, torch.float32)):
        b, ctx, hq, hkv, hd = shape
        q, k, v = decode_inputs(torch, gen, b, ctx, hq, hkv, hd, dtype)
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        mask = kfd.visible_slots(p, ctx, None, "cuda")[None, None, None, :]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)

        want = kfd.flash_decode_plain(q, k, v, p).transpose(1, 2)
        lib_err = float((sdpa().float() - want.float()).abs().max())
        bound_ms, bound_by, nbytes, ops = decode_bound(torch, q, k, pos)
        dev_ms, per_call, span_ms = device_ms(
            torch, lambda: kfd.flash_decode(q, k, v, p), "decode_kernel")
        out[key] = {"shape": list(shape), "pos": pos,
                    "dtype": str(dtype).split(".")[-1],
                    "ms": cold_ms(torch, lambda: kfd.flash_decode(q, k, v,
                                                                  p)),
                    "device_ms": dev_ms, "device_span_ms": span_ms,
                    "kernels_per_call": per_call,
                    "resources": kfd.resources(b, ctx, hq, hkv, hd, dtype),
                    "plain_ms": cold_ms(torch, lambda: kfd.flash_decode_plain(
                        q, k, v, p)),
                    "library_ms": cold_ms(torch, sdpa),
                    "library_max_abs_err": lib_err,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "bytes": nbytes, "ops": ops}
        del q, k, v, qt, kt, vt, want
        torch.cuda.empty_cache()
    return out


def decode_profile(torch, tm, get_arch, make_serve_step):
    """Host and device time of 16 decode steps at full width (batch 8,
    position 128 of a 2048-slot cache): the host's enqueue time against
    the wall time to the end of the steps, and the device busy share
    under torch.profiler.  A step whose enqueue takes as long as its wall
    is bound by the host's launch rate."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for arch in D_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_arch(arch)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = tm.init(cfg, gen)
        cache = tm.init_cache(cfg, D_BATCH, D_CTX, device="cuda")
        step = make_serve_step(cfg, tm.Runtime(attn_impl="pallas"))
        tok = torch.zeros((D_BATCH, 1), dtype=torch.long, device="cuda")
        for _ in range(D_PROMPT):
            step(params, cache, tok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(16):
            step(params, cache, tok)
        enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(16):
                step(params, cache, tok)
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        events = prof.key_averages()
        busy = sum(e.self_device_time_total for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation) / 1e3
        log(f"[profile decode {arch}] 16 steps: enqueue {1e3 * enqueue:.1f} "
            f"ms, wall {1e3 * wall:.1f} ms ({1e3 * wall / 16:.2f} ms/step); "
            f"profiled wall {1e3 * window:.1f} ms, device busy {busy:.1f} ms "
            f"({100 * busy / (1e3 * window):.1f}%)")
        table = events.table(sort_by="self_device_time_total", row_limit=20)
        log(table)
        out[arch] = {"enqueue_ms": 1e3 * enqueue, "wall_ms": 1e3 * wall,
                     "profile_window_ms": 1e3 * window, "busy_ms": busy,
                     "table": table}
        del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


Env = namedtuple("Env", "torch np Experiment ScenarioSpec SerialExecutor "
                        "DeviceProfile lowering data test")


def family_cell(env, tag, family, rows, periods, per_period, counted):
    """One big-model cell at full width: ``rows`` rows (iid and noniid x
    seeds) x 12 devices x ``periods`` periods through Experiment.run after
    a 1-period warm-up, with the kernels' launch counts set to 0 just
    before and read just after (held against ``per_period`` x periods);
    then the same bucket's host planning and device loop timed apart.
    Returns the report, the specs and the bucket; raises AssertionError."""
    torch, np = env.torch, env.np
    specs = [env.ScenarioSpec(fleet=fleet(env.DeviceProfile, DEVICES),
                              name="K12", partition=p, policy="proposed",
                              b_max=128, base_lr=0.05,
                              seeds=tuple(range(rows // 2)),
                              model_family=family)
             for p in ("iid", "noniid")]
    t0 = time.perf_counter()
    env.Experiment(env.data, env.test, specs).run(1)     # warm-up period
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = env.Experiment(env.data, env.test, specs).run(periods)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {name: n * periods for name, n in per_period.items()}
    arch = f"feel-{family}-h256-d3"
    log(f"[{tag}] Experiment.run {arch}: {res.rows} rows x {periods} "
        f"periods in {wall:.3f} s = {1e3 * wall / periods:.1f} ms/period "
        f"(warm-up run of 1 period {t_warm:.2f} s); peak device memory "
        f"{peak:.2f} GiB")
    log(f"[{tag}] launches during the run: {launches} (expected {want})")
    log(f"[{tag}] mean accuracy period 1 {res.accs[:, 0].mean():.4f} -> "
        f"period {periods} {res.final_acc.mean():.4f} (chance 0.1); mean "
        f"loss {res.losses[:, 0].mean():.4f} -> "
        f"{res.losses[:, -1].mean():.4f}")
    if launches != want:
        raise AssertionError(f"{tag}: kernel launches {launches}, expected "
                             f"{want}")
    if not (np.isfinite(res.losses).all() and np.isfinite(res.accs).all()
            and np.isfinite(res.times).all()):
        raise AssertionError(f"{tag}: non-finite series")
    if res.rows != rows or not (res.losses[:, -1] != res.losses[:, 0]).all():
        raise AssertionError(f"{tag}: a row's loss did not change over the "
                             "run")
    if not res.losses[:, -1].mean() < res.losses[:, 0].mean():
        raise AssertionError(f"{tag}: the mean loss did not fall over the "
                             "run")
    bucket = env.Experiment(env.data, env.test, specs).lower()[0]
    t0 = time.perf_counter()
    plan = env.lowering.plan_bucket(bucket, env.data, periods)
    t_plan = time.perf_counter() - t0
    arrays = env.lowering.DeviceData(env.data, env.test, "cuda")
    arrays.tokens
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handle = env.lowering.dispatch_bucket(plan, arrays)
    t_enqueue = time.perf_counter() - t0
    env.lowering.collect_bucket(handle)
    t_device = time.perf_counter() - t0
    log(f"[{tag}] phases: host planning {t_plan:.3f} s "
        f"({1e3 * t_plan / periods:.1f} ms/period); device loop "
        f"{t_device:.3f} s ({1e3 * t_device / periods:.1f} ms/period, of "
        f"which {t_enqueue:.3f} s until the last period was enqueued)")
    return {"specs": specs, "bucket": bucket, "report": {
        "rows": res.rows, "periods": periods, "wall_s": wall,
        "ms_per_period": 1e3 * wall / periods, "plan_s": t_plan,
        "device_loop_s": t_device, "enqueue_s": t_enqueue,
        "peak_gib": peak, "final_acc": res.final_acc.tolist(),
        "loss_first": res.losses[:, 0].tolist(),
        "loss_last": res.losses[:, -1].tolist(), "launches": launches}}


def family_contracts(env, tag, family, specs):
    """The card against the port's CPU path (1 row, slot 16, 3 periods:
    ledgers bitwise, losses 1e-4, accuracies two test predictions),
    chunked == monolithic bitwise over the cell's rows x 3 periods, and a
    padded K = 9 row against its solo twin (ledgers bitwise, losses
    1e-4; the gap is reported).  Raises AssertionError."""
    np, Experiment, data, test = env.np, env.Experiment, env.data, env.test
    one = [env.ScenarioSpec(fleet=fleet(env.DeviceProfile, DEVICES),
                            name="K12", partition="iid", seeds=(0,),
                            b_max=16, model_family=family)]
    card = Experiment(data, test, one).run(3)
    cpu = Experiment(data, test, one, device="cpu").run(3)
    loss_err = float(np.abs(card.losses - cpu.losses).max())
    acc_err = float(np.abs(card.accs - cpu.accs).max())
    log(f"[{tag} card vs cpu] 3 periods, 1 row, slot 16: losses "
        f"{card.losses[0]} vs {cpu.losses[0]} (max abs err "
        f"{loss_err:.3g}); accs max abs err {acc_err:.3g}")
    if not (np.array_equal(card.times, cpu.times)
            and np.array_equal(card.global_batch, cpu.global_batch)
            and np.allclose(card.losses, cpu.losses, rtol=1e-4, atol=1e-4)
            and acc_err <= 2.0 / len(test.y) + 1e-7):
        raise AssertionError(f"{tag}: card and CPU path disagree beyond "
                             "ledgers bitwise, losses 1e-4, accuracies two "
                             "test predictions")
    fields = ("losses", "accs", "times", "global_batch")
    mono = Experiment(data, test, specs).run(3)
    chunk = Experiment(data, test, specs).run(
        3, executor=env.SerialExecutor(chunk_periods=1))
    if not all(np.array_equal(getattr(mono, f), getattr(chunk, f))
               for f in fields):
        raise AssertionError(f"{tag}: chunked run differs from the "
                             "monolithic one")
    mixed = [env.ScenarioSpec(fleet=fleet(env.DeviceProfile, k),
                              name=f"K{k}", partition="iid", seeds=(0,),
                              model_family=family) for k in (12, 9)]
    both = Experiment(data, test, mixed).run(3)
    solo = Experiment(data, test, mixed[1:]).run(3)
    pad_err = float(np.abs(both.losses[1] - solo.losses[0]).max())
    same = np.array_equal(both.times[1], solo.times[0])
    log(f"[{tag} card] chunked (1-period chunks) == monolithic bitwise over "
        f"{mono.rows} rows x 3 periods; padded K=9 row vs its solo twin: "
        f"ledgers {'equal' if same else 'DIFFER'}, losses max abs err "
        f"{pad_err:.3g}")
    if not (same
            and np.array_equal(both.global_batch[1], solo.global_batch[0])
            and np.allclose(both.losses[1], solo.losses[0], rtol=1e-4,
                            atol=1e-4)):
        raise AssertionError(f"{tag}: padded row and its solo twin disagree "
                             "beyond ledgers bitwise, losses 1e-4")
    return {"card_vs_cpu_loss_max_abs_err": loss_err,
            "card_vs_cpu_acc_max_abs_err": acc_err,
            "chunked_equals_monolithic": True,
            "padded_vs_solo_loss_max_abs_err": pad_err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace two periods with torch.profiler")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this smoke run "
                    "needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.api import Experiment, ScenarioSpec, SerialExecutor
        from repro_torch.compression import sbc as csbc
        from repro_torch.core.latency import DeviceProfile
        from repro_torch.data.pipeline import ClassificationData
        from repro_torch.api import lowering
        from repro_torch.kernels import build
        from repro_torch.kernels import flash_attention as kfa
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels import sbc as ksbc
        from repro_torch.kernels import ssd_scan as kssd
        from repro_torch.kernels import flash_decode as kfd
        from repro_torch.kernels.ref import attention_ref
        from repro_torch.configs import get_arch
        from repro_torch.fed.train_step import make_serve_step
        from repro_torch.launch import serve
        from repro_torch.models import model as tm
        from repro_torch.tree import tree_map
    except ImportError as exc:
        return fail(f"the port is not importable from {ROOT}: {exc}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    OUT_DIR.mkdir(exist_ok=True)
    _Log.file = open(OUT_DIR / "chip_smoke.log", "w")

    # ---- 1. device --------------------------------------------------------
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1 device] {kind}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:       # one nvcc each
        libs = dict(zip(SOURCES, pool.map(build.load, SOURCES)))
    log(f"[2 build] {', '.join(f'{n}.cu' for n in SOURCES)} built and "
        f"loaded in {time.perf_counter() - t0:.2f} s (nvcc "
        + ", ".join(f"{n} {lib.build_seconds:.2f} s"
                    for n, lib in libs.items()) + ")")
    for name, lib in libs.items():
        for line in lib.log.splitlines():
            if "Function properties for" in line:
                log(f"[2 build]   {name}: {line.split('for ')[-1].strip()}")
            elif "registers" in line or "spill" in line:
                log(f"[2 build]     {line.strip()}")

    # ---- 3. kernels against their plain versions ---------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    segs = ROWS * DEVICES
    errs = {"sbc_stats": 0.0, "sbc_apply": 0.0}

    def check_pair(x, thr, label):
        got = ksbc.sbc_stats(x, thr)
        want = ksbc.sbc_stats_plain(x, thr)
        if not torch.equal(got[:, 2:], want[:, 2:]):
            raise AssertionError(f"{label}: sbc_stats counts differ")
        if not torch.allclose(got[:, :2], want[:, :2], rtol=1e-6, atol=0):
            raise AssertionError(f"{label}: sbc_stats sums beyond rtol 1e-6")
        errs["sbc_stats"] = max(errs["sbc_stats"], float(
            (got[:, :2] - want[:, :2]).abs().max()))
        scalars = csbc.group_scalars(thr, want)
        out, res = ksbc.sbc_apply(x, scalars)
        pout, pres = ksbc.sbc_apply_plain(x, scalars)
        if not (torch.equal(out, pout) and torch.equal(res, pres)):
            raise AssertionError(f"{label}: sbc_apply is not bitwise the "
                                 "plain version")
        errs["sbc_apply"] = max(errs["sbc_apply"],
                                float((out - pout).abs().max()))

    try:
        for n in LEAF_LENGTHS:
            x = torch.randn((segs, n), generator=gen, device="cuda")
            x[0] = 0.0                                   # all-zero upload
            thr = csbc.topk_threshold_bisect(x.abs(), csbc.n_keep(n, RATIO))
            check_pair(x, thr, f"n={n}")
        edge = torch.randn((4, 1001), generator=gen, device="cuda")
        edge[0] = 0.0                                    # all zeros
        edge[1, ::5] = 0.75                              # ties at thr
        edge[1, 2::5] = -0.75
        check_pair(edge, torch.tensor([0.0, 0.75, 0.5, 1e9], device="cuda"),
                   "edge n=1001")
        tiny = torch.tensor([[0.1, -5.0, 0.2]], device="cuda")
        check_pair(tiny, torch.tensor([5.0], device="cuda"), "n=3")
        torch.cuda.synchronize()
    except AssertionError as exc:
        return fail(f"phase 3: {exc}")
    log(f"[3 kernels] stats counts equal, sums within rtol 1e-6 (max abs "
        f"err {errs['sbc_stats']:.3g}); apply bitwise equal; "
        f"lengths {LEAF_LENGTHS} x {segs} segments + edge cases")

    from repro_torch.fed import feel_model
    shapes = feel_model.init(torch.Generator().manual_seed(0))
    grads = [{k: torch.randn((ROWS, DEVICES) + tuple(v.shape), generator=gen,
                             device="cuda") * 1e-2
              for k, v in layer.items()} for layer in shapes]
    resid = [{k: torch.randn_like(v) * 1e-3 for k, v in layer.items()}
             for layer in grads]
    approx, new_res = csbc.compress_dense(grads, RATIO, resid, batch_dims=2)
    cpu = lambda t: [{k: v.cpu() for k, v in l.items()} for l in t]  # noqa
    p_approx, p_res = csbc.compress_dense(cpu(grads), RATIO, cpu(resid),
                                          batch_dims=2)
    dense_err = 0.0
    for a, b, r, pr in zip(approx, p_approx, new_res, p_res):
        for k in a:
            ac = a[k].cpu()
            if not torch.equal(ac != 0, b[k] != 0):
                return fail(f"phase 3: compress_dense keep mask differs "
                            f"between the card and the CPU path ({k})")
            if not (torch.allclose(ac, b[k], rtol=2e-5, atol=2e-5) and
                    torch.allclose(r[k].cpu(), pr[k], rtol=2e-5, atol=2e-5)):
                return fail("phase 3: compress_dense values beyond 2e-5")
            dense_err = max(dense_err, float((ac - b[k]).abs().max()))
    log(f"[3 kernels] compress_dense card vs CPU path: keep masks identical, "
        f"values max abs err {dense_err:.3g} (tol 2e-5)")
    del grads, resid, approx, new_res, p_approx, p_res
    try:
        attn_errs = attention_checks(torch, kfa, kops, attention_ref)
        torch.cuda.synchronize()
    except AssertionError as exc:
        return fail(f"phase 3: {exc}")
    errs.update({k: v for k, v in attn_errs.items() if k.startswith("flash")})
    log(f"[3 kernels] attention at {T_SHAPE} (B, S, Hq, Hkv, hd) + S in "
        f"(128, 256, 100), hd in (64, 128), windows (16, 64), non-causal, "
        f"and {attn_errs['seams']} seams {ATTN_SEAMS}: "
        f"fwd max abs err {attn_errs['flash_attention_fwd']:.3g} (tol 2e-5; "
        f"lse in f32 and bf16 too), "
        f"bf16 fwd {attn_errs['bf16_fwd']:.3g} (tol 2e-2), dq "
        f"{attn_errs['flash_attention_bwd_dq']:.3g}, dk/dv "
        f"{attn_errs['flash_attention_bwd_dkdv']:.3g} vs the plain backward, "
        f"{attn_errs['bwd_vs_autograd']:.3g} vs autograd of the oracle "
        f"(tol 1e-4); every forward run twice bitwise equal; sequences 0 "
        f"and {T_SHAPE[0] // 2} alone bitwise the same rows of the whole "
        f"batch; backward run twice bitwise equal")
    report["attention_errors"] = attn_errs
    try:
        ssd_errs = ssd_checks(torch, kssd, kops)
        torch.cuda.synchronize()
    except AssertionError as exc:
        return fail(f"phase 3c: {exc}")
    errs.update({k: v for k, v in ssd_errs.items() if k.startswith("ssd")})
    log(f"[3c kernels] SSD scan at {M_SHAPE} (B, S, H, P, G, N, chunk; "
        f"{M_COPIES} copies of A) + the reference's kernel-test shapes (S up "
        f"to 256, P up to 64, N up to 64, G up to 4, chunk up to 128) + the "
        f"backward's seams {SSD_BWD_SEAMS} (copies, B per copy, S, H, P, G, "
        f"N, chunk): fwd "
        f"max abs err {ssd_errs['ssd_scan_fwd']:.3g} vs the plain version, "
        f"{ssd_errs['fwd_vs_f64']:.3g} vs it in float64 (tol 2e-5; the "
        f"float32 plain version {ssd_errs['plain_fwd_vs_f64']:.3g}), bf16 "
        f"fwd {ssd_errs['bf16_fwd']:.3g} (tol 2e-2); bwd "
        f"{ssd_errs['ssd_scan_bwd']:.3g} vs the plain version, "
        f"{ssd_errs['bwd_vs_f64']:.3g} vs it in float64 (tol 1e-4; the "
        f"float32 plain version {ssd_errs['plain_bwd_vs_f64']:.3g}); "
        f"{ssd_errs['left_out']} elements where the float32 plain version "
        f"is itself beyond half the tolerance of float64; backward run "
        f"twice bitwise equal, and a copy alone bitwise the same copy among "
        f"8")
    report["ssd_errors"] = ssd_errs
    try:
        dec_errs = decode_checks(torch, kfd)
        torch.cuda.synchronize()
    except AssertionError as exc:
        return fail(f"phase 3d: {exc}")
    errs["flash_decode"] = dec_errs["flash_decode"]
    log(f"[3d kernels] flash decode at {D_SHAPE} (B, ctx, Hq, Hkv, hd) at "
        f"pos {D_POS}, 0 and {D_CTX - 1}, the runs' seams {D_SEAMS} "
        f"(B, ctx, Hq, Hkv, hd, pos, window), ring buffers (pos 100 and 1000 "
        f"in 256 slots, pos 700 with window 128), hd 64 at g 1, 4 and 8, ctx "
        f"1000 (pos 999 and 5000): max abs err {dec_errs['flash_decode']:.3g} "
        f"(tol 2e-5), bf16 {dec_errs['bf16']:.3g} (tol 2e-2); every case run "
        f"twice bitwise equal")
    report["decode_errors"] = dec_errs

    # ---- 4. the main path at full width ------------------------------------
    t0 = time.perf_counter()
    full = ClassificationData.synthetic(n=12_000, dim=3072, seed=0,
                                        spread=6.0)
    data, test = full.split(1200)
    specs = [ScenarioSpec(fleet=fleet(DeviceProfile, DEVICES), name="K12",
                          partition=p, policy="proposed", b_max=128,
                          base_lr=0.05, seeds=tuple(range(8)))
             for p in ("iid", "noniid")]
    log(f"[4 main] data made in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    Experiment(data, test, specs).run(1)                 # warm-up period
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    ksbc.sbc_stats.launches = 0
    ksbc.sbc_apply.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = Experiment(data, test, specs).run(PERIODS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"sbc_stats": ksbc.sbc_stats.launches,
                "sbc_apply": ksbc.sbc_apply.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    want_launches = len(LEAF_LENGTHS) * PERIODS
    log(f"[4 main] Experiment.run: {res.rows} rows x {PERIODS} periods in "
        f"{wall:.3f} s = {1e3 * wall / PERIODS:.1f} ms/period (warm-up "
        f"run of 1 period {warm:.2f} s); peak device memory {peak:.2f} GiB")
    log(f"[4 main] launches during the run: {launches} "
        f"(expected {want_launches} each)")
    final = res.final_acc
    log(f"[4 main] mean accuracy period 1 {res.accs[:, 0].mean():.4f} -> "
        f"period {PERIODS} {final.mean():.4f} (iid "
        f"{res.sel(partition='iid').final_acc.mean():.4f}, noniid "
        f"{res.sel(partition='noniid').final_acc.mean():.4f}; chance 0.1); "
        f"mean loss {res.losses[:, 0].mean():.4f} -> "
        f"{res.losses[:, -1].mean():.4f}")
    if launches != {"sbc_stats": want_launches, "sbc_apply": want_launches}:
        return fail(f"phase 4: kernel launches {launches}, expected "
                    f"{want_launches} each")
    if not (np.isfinite(res.losses).all() and np.isfinite(res.accs).all()
            and np.isfinite(res.times).all()):
        return fail("phase 4: non-finite series")
    if res.rows != ROWS or (final <= 0.1).any():
        return fail(f"phase 4: final accuracy {final} not above chance")
    if not res.losses[:, -1].mean() < res.losses[:, 0].mean():
        return fail("phase 4: the mean loss did not fall over the run")
    # the same bucket through the three lowering phases, timed apart:
    # host planning (numpy) vs the device loop (enqueue + wait)
    bucket = Experiment(data, test, specs).lower()[0]
    t0 = time.perf_counter()
    plan = lowering.plan_bucket(bucket, data, PERIODS)
    t_plan = time.perf_counter() - t0
    arrays = lowering.DeviceData(data, test, "cuda")
    arrays.features
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handle = lowering.dispatch_bucket(plan, arrays)
    t_enqueue = time.perf_counter() - t0
    lowering.collect_bucket(handle)
    t_device = time.perf_counter() - t0
    log(f"[4 main] phases: host planning {t_plan:.3f} s "
        f"({1e3 * t_plan / PERIODS:.1f} ms/period); device loop "
        f"{t_device:.3f} s ({1e3 * t_device / PERIODS:.1f} ms/period, of "
        f"which {t_enqueue:.3f} s until the last period was enqueued)")
    report["main"] = {"rows": res.rows, "periods": PERIODS,
                      "wall_s": wall, "ms_per_period": 1e3 * wall / PERIODS,
                      "plan_s": t_plan, "device_loop_s": t_device,
                      "enqueue_s": t_enqueue,
                      "peak_gib": peak, "final_acc": final.tolist(),
                      "launches": launches}
    del arrays, handle

    # ---- 4b/4c. the transformer and mamba2 cells at full width ------------
    env = Env(torch, np, Experiment, ScenarioSpec, SerialExecutor,
              DeviceProfile, lowering, data, test)
    cells = {}
    for tag, family, rows, periods, per_period, counted in (
            ("4b transformer", "transformer", T_ROWS, T_PERIODS, T_LAUNCHES,
             {"flash_attention_fwd": kfa.flash_attention_fwd,
              "flash_attention_bwd_dq": kfa.flash_attention_bwd_dq,
              "flash_attention_bwd_dkdv": kfa.flash_attention_bwd_dkdv}),
            ("4c mamba2", "mamba2", M_ROWS, M_PERIODS, M_LAUNCHES,
             {"ssd_scan_fwd": kssd.ssd_scan_fwd,
              "ssd_scan_bwd": kssd.ssd_scan_bwd})):
        counted = dict(counted, sbc_stats=ksbc.sbc_stats,
                       sbc_apply=ksbc.sbc_apply)
        try:
            cells[family] = family_cell(env, tag, family, rows, periods,
                                        per_period, counted)
        except AssertionError as exc:
            return fail(f"phase {exc}")
        report[family] = cells[family]["report"]
    t_launches = report["transformer"]["launches"]
    m_launches = report["mamba2"]["launches"]

    # ---- 4d. the token-decode driver at full width ------------------------
    for arch in D_ARCHS:
        try:
            report[f"decode_{arch}"] = decode_cell(torch, serve, kfd, arch)
        except (AssertionError, FloatingPointError) as exc:
            return fail(f"phase 4d: {exc}")
    d_launches = {arch: report[f"decode_{arch}"]["launches"]["flash_decode"]
                  for arch in D_ARCHS}

    # ---- 5. the card against the port's CPU path ---------------------------
    one = [ScenarioSpec(fleet=fleet(DeviceProfile, DEVICES), name="K12",
                        partition="iid", seeds=(0,))]
    on_card = Experiment(data, test, one).run(3)
    on_cpu = Experiment(data, test, one, device="cpu").run(3)
    loss_err = float(np.abs(on_card.losses - on_cpu.losses).max())
    acc_err = float(np.abs(on_card.accs - on_cpu.accs).max())
    log(f"[5 card vs cpu] 3 periods, 1 row: losses {on_card.losses[0]} vs "
        f"{on_cpu.losses[0]} (max abs err {loss_err:.3g}); accs max abs err "
        f"{acc_err:.3g}")
    if not (np.array_equal(on_card.times, on_cpu.times)
            and np.allclose(on_card.losses, on_cpu.losses, rtol=1e-4,
                            atol=1e-4)
            and acc_err <= 2.0 / len(test.y) + 1e-7):
        return fail("phase 5: card and CPU path disagree beyond losses "
                    "1e-4, accuracies two test predictions")
    report["card_vs_cpu"] = {"loss_max_abs_err": loss_err,
                             "acc_max_abs_err": acc_err}

    # within the port on the card: chunked == monolithic bitwise, and a
    # padded row against its solo twin (K = 9 padded to 12 in a bucket)
    mono = Experiment(data, test, specs).run(4)
    chunked = Experiment(data, test, specs).run(
        4, executor=SerialExecutor(chunk_periods=1))
    fields = ("losses", "accs", "times", "global_batch")
    if not all(np.array_equal(getattr(mono, f), getattr(chunked, f))
               for f in fields):
        return fail("phase 5: chunked run differs from the monolithic one")
    mixed = [ScenarioSpec(fleet=fleet(DeviceProfile, k), name=f"K{k}",
                          partition="iid", seeds=(0,)) for k in (12, 9)]
    both = Experiment(data, test, mixed).run(3)
    solo = Experiment(data, test, mixed[1:]).run(3)
    pad_err = float(np.abs(both.losses[1] - solo.losses[0]).max())
    log(f"[5 card] chunked (1-period chunks) == monolithic bitwise over 16 "
        f"rows x 4 periods; padded K=9 row vs its solo twin: ledgers "
        f"{'equal' if np.array_equal(both.times[1], solo.times[0]) else 'DIFFER'}"
        f", losses max abs err {pad_err:.3g}")
    if not (np.array_equal(both.times[1], solo.times[0])
            and np.array_equal(both.global_batch[1], solo.global_batch[0])
            and np.allclose(both.losses[1], solo.losses[0], rtol=1e-4,
                            atol=1e-4)):
        return fail("phase 5: padded row and its solo twin disagree beyond "
                    "ledgers bitwise, losses 1e-4")
    report["card_contracts"] = {"chunked_equals_monolithic": True,
                                "padded_vs_solo_loss_max_abs_err": pad_err}

    # ---- 5b/5c. the big-model families: card vs CPU, chunked, padded -------
    for tag, family in (("5b transformer", "transformer"),
                        ("5c mamba2", "mamba2")):
        try:
            report[f"{family}_contracts"] = family_contracts(
                env, tag, family, cells[family]["specs"])
        except AssertionError as exc:
            return fail(f"phase {exc}")

    # ---- 5d. decode: card vs CPU, decode vs forward ------------------------
    try:
        report["decode_contracts"] = decode_contracts(torch, tm, get_arch,
                                                      tree_map)
    except AssertionError as exc:
        return fail(f"phase {exc}")

    # ---- 6. times ----------------------------------------------------------
    records = []
    for name, kern, plain in (("sbc_stats", ksbc.sbc_stats,
                               ksbc.sbc_stats_plain),
                              ("sbc_apply", ksbc.sbc_apply,
                               ksbc.sbc_apply_plain)):
        tot = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0}
        for n in LEAF_LENGTHS:
            x = torch.randn((segs, n), generator=gen, device="cuda")
            thr = csbc.topk_threshold_bisect(x.abs(), csbc.n_keep(n, RATIO))
            arg = (thr if name == "sbc_stats" else
                   csbc.group_scalars(thr, ksbc.sbc_stats_plain(x, thr)))
            ms = cold_ms(torch, lambda: kern(x, arg))
            pms = cold_ms(torch, lambda: plain(x, arg))
            if name == "sbc_stats":   # read x, thr; write (S, 4)
                nbytes = 4 * segs * n + 4 * segs + 16 * segs
                ops = 4 * segs * n      # abs, compare, sign test, add
            else:                     # read x, scalars; write out, res
                nbytes = 12 * segs * n + 12 * segs
                ops = 5 * segs * n      # abs, compare, 2 sign tests, sub
            bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
            log(f"[6 times] {name} n={n:>7} x {segs}: kernel {ms:.4f} ms, "
                f"plain {pms:.4f} ms, bound {bound:.4f} ms")
            tot["ms"] += ms
            tot["plain_ms"] += pms
            tot["bytes"] += nbytes
            tot["ops"] += ops
        bound_bytes = 1e3 * tot["bytes"] / HBM_BYTES_PER_S
        bound_ops = 1e3 * tot["ops"] / F32_OPS_PER_S
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sbc.cu",
            "replaces": ("src/repro/kernels/sbc.py:25" if name == "sbc_stats"
                         else "src/repro/kernels/sbc.py:70"),
            "launches": launches[name],
            "launches_by_path": {"feel_mlp": launches[name],
                                 "transformer": t_launches[name],
                                 "mamba2": m_launches[name]},
            "max_abs_err": errs[name],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": None})
        log(f"[6 times] {name}: one period's six leaves: kernel "
            f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, bound "
            f"{records[-1]['bound_ms']:.4f} ms ({records[-1]['bound_by']}); "
            f"library_ms none (no single PyTorch call computes it)")
    # the forward's six instances on this card
    fwd_res = {f"{str(dt).split('.')[-1]}_hd{hd}": kfa.fwd_resources(hd, dt)
               for hd in (32, 64, 128)
               for dt in (torch.float32, torch.bfloat16)}
    for key, r in fwd_res.items():
        log(f"[6 resources] fwd_kernel {key}: {r['registers']} registers and "
            f"{r['local_bytes']} bytes of local memory (spills) a thread; "
            f"{r['static_smem_bytes'] + r['dynamic_smem_bytes']} bytes of "
            f"shared memory and {r['threads']} threads a CTA; "
            f"{r['ctas_per_sm']} CTAs resident an SM (the persistent grid)")
    if any(r["local_bytes"] or r["static_smem_bytes"]
           for r in fwd_res.values()):
        return fail("phase 6: an attention forward instance spills or has "
                    "static shared memory")
    for name, t in attention_times(torch, kfa, F).items():
        records.append({
            "name": name, "route": "cuda", "source": ATTN_SOURCE,
            "replaces": ("src/repro/kernels/flash_attention.py:24"
                         if name == "flash_attention_fwd"
                         else "none: backward of B4, C-ref-3"),
            "launches": t_launches[name],
            "launches_by_path": {"transformer": t_launches[name]},
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        if name == "flash_attention_fwd":
            records[-1]["device_ms"] = t["device_ms"]
            records[-1]["resources"] = fwd_res
            log(f"[6 times] flash_attention_fwd at {T_SHAPE}: "
                f"{t['device_ms']:.4f} ms on the card (profiler)")
        log(f"[6 times] {name} at {T_SHAPE} (B, S, Hq, Hkv, hd), causal: "
            f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']} bytes, "
            f"{t['ops']} f32 ops); scaled_dot_product_attention "
            + ("forward" if name == "flash_attention_fwd"
               else "forward + backward")
            + f" {t['library_ms']:.4f} ms")
    # what the backward's kernels take on this card at the cell's shape
    res = kssd.bwd_resources(*M_SHAPE[2:6])
    for name, r in res.items():
        log(f"[6 resources] {name} at {M_SHAPE} (B, S, H, P, G, N, chunk): "
            f"{r['registers']} registers and {r['local_bytes']} bytes of "
            f"local memory (spills) a thread; "
            f"{r['static_smem_bytes'] + r['dynamic_smem_bytes']} bytes of "
            f"shared memory and {r['threads']} threads a CTA; "
            f"{r['ctas_per_sm']} CTAs = {r['warps_per_sm']} warps resident "
            f"an SM")
    report["ssd_bwd_resources"] = res
    for name, t in ssd_times(torch, kssd).items():
        records.append({
            "name": name, "route": "cuda", "source": SSD_SOURCE,
            "replaces": ("src/repro/kernels/ssd_scan.py:35"
                         if name == "ssd_scan_fwd"
                         else "none: backward of B3, C-ref-3"),
            "launches": m_launches[name],
            "launches_by_path": {"mamba2": m_launches[name]},
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
        if name == "ssd_scan_bwd":
            records[-1]["resources"] = res
        log(f"[6 times] {name} at {M_SHAPE} (B, S, H, P, G, N, chunk): "
            f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']} bytes, "
            f"{t['ops']} f32 ops); library_ms none (no single PyTorch call "
            f"computes the SSD scan)")

    dt = decode_times(torch, kfd, F)
    path = dt["path"]
    records.append({
        "name": "flash_decode", "route": "cuda", "source": DECODE_SOURCE,
        "replaces": "src/repro/kernels/flash_decode.py:25",
        "launches": d_launches["mistral-nemo-12b"],
        "launches_by_path": {f"decode {a}": n for a, n in d_launches.items()},
        "max_abs_err": errs["flash_decode"], "ms": path["ms"],
        "plain_ms": path["plain_ms"], "bound_ms": path["bound_ms"],
        "bound_by": path["bound_by"], "library_ms": path["library_ms"],
        "device_ms": path["device_ms"],
        "device_span_ms": path["device_span_ms"],
        "kernels_per_call": path["kernels_per_call"],
        "resources": path["resources"],
        "at_32k": {k: {f: dt[k][f] for f in ("shape", "pos", "dtype", "ms",
                                             "device_ms", "device_span_ms",
                                             "kernels_per_call", "plain_ms",
                                             "bound_ms", "bound_by",
                                             "library_ms")}
                   for k in ("32k_bf16", "32k_f32")}})
    for key, t in dt.items():
        r = t["resources"]
        log(f"[6 times] flash_decode {key} at {tuple(t['shape'])} (B, ctx, "
            f"Hq, Hkv, hd), pos {t['pos']}, {t['dtype']}: kernel "
            f"{t['ms']:.4f} ms (CUDA events), {t['device_ms']:.4f} ms on the "
            f"card (profiler; first kernel's start to last kernel's end "
            f"{t['device_span_ms']:.4f} ms), {t['kernels_per_call']:g} "
            f"kernel a call; "
            f"plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']} bytes, "
            f"{t['ops']} ops); scaled_dot_product_attention "
            f"{t['library_ms']:.4f} ms (max abs err vs plain "
            f"{t['library_max_abs_err']:.3g})")
        log(f"[6 resources] flash_decode {key}: {r['registers']} registers "
            f"and {r['local_bytes']} bytes of local memory (spills) a "
            f"thread; {r['static_smem_bytes'] + r['dynamic_smem_bytes']} "
            f"bytes of shared memory and {r['threads']} threads a CTA; "
            f"{r['ctas_per_sm']} CTAs resident an SM; {r['splits']} runs a "
            f"(sequence, KV head)")
    report["decode_times"] = dt
    if any(t["kernels_per_call"] != 1 for t in dt.values()):
        return fail("phase 6: a flash_decode call put "
                    + ", ".join(f"{t['kernels_per_call']:g}"
                                for t in dt.values())
                    + " kernels on the card, not 1")

    if args.profile:
        report["profile_decode"] = decode_profile(torch, tm, get_arch,
                                                  make_serve_step)
        # device time by kernel over the device loop of two periods of
        # each path
        from torch.profiler import ProfilerActivity, profile
        for path, pbucket, form in (
                ("feel_mlp", bucket, "features"),
                ("transformer", cells["transformer"]["bucket"], "tokens"),
                ("mamba2", cells["mamba2"]["bucket"], "tokens")):
            plan = lowering.plan_bucket(pbucket, data, 2)
            arrays = lowering.DeviceData(data, test, "cuda")
            getattr(arrays, form)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                lowering.collect_bucket(lowering.dispatch_bucket(plan,
                                                                 arrays))
                window = time.perf_counter() - t0
            events = prof.key_averages()
            busy = sum(e.self_device_time_total for e in events
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not e.is_user_annotation) / 1e3
            log(f"[profile {path}] device loop of 2 periods: wall "
                f"{1e3 * window:.1f} ms, device busy {busy:.1f} ms "
                f"({100 * busy / (1e3 * window):.1f}%)")
            table = events.table(sort_by="self_device_time_total",
                                 row_limit=30)
            log(table)
            report[f"profile_{path}"] = {"window_ms": 1e3 * window,
                                         "busy_ms": busy, "table": table}

    report["kernels"] = records
    report["device"] = {"kind": kind, "smi": smi}
    try:
        (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    except OSError as exc:
        log(f"(report not written: {exc})")
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
