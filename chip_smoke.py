#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --profile    # also a torch.profiler breakdown

It drives the port's paths through ``repro_torch.api.Experiment.run``,
``repro_torch.serve.ExperimentService`` and ``FeelSimulation`` with the
Table-II fleet at K = 12 — the main path, the FEEL scheme with
feel-mlp at full width (3072→256→256→10, 855 050 parameters, 16 rows),
the four Table-II schemes, τ local steps and the cell→edge→cloud
hierarchy on the same model,
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
     reproducible, the forward, dQ with D and dK/dV batch-invariant);
     3c. the SSD scan forward and backward at the mamba2 cell's shape,
     four edge shapes and
     six seams of the backward, the forward also at six seams of its
     16-token tiles and at N 128 (against the plain versions in float64,
     and in float32 wherever those are within half the tolerance of
     float64; both bitwise reproducible, a sequence's y bitwise alone and
     among the cell's 12 288, and a copy's gradients bitwise alone and
     among 8); 3d. flash decode at the decode cell's shape
     and edge cases (pos 0, the last slot, the runs' seams at pos 31, 32,
     33 and where runs are empty, ring buffers, head dim 64 at g 1/4/8,
     a ragged ctx; f32 2e-5, bf16 2e-2; bitwise twice);
  4. the main path, with launch counts read around it;
  4b. the transformer cell and 4c. the mamba2 cell, each with launch
     counts read around it and held against the formula stated in
     PERF.md; 4d. ``launch.serve.main`` on mistral-nemo-12b (batch 8,
     prompt 128, 64 generated tokens, ctx 2048: 40 x 192 = 7 680 flash
     decode launches) and on mamba2-2.7b (none), each with its launch
     count, tokens/s and peak memory; 4e. ``Experiment(data, test,
     grid(...))`` over the main cell (4 policies x 2 SBC ratios x 2
     partitions x 2 seeds: 32 rows in two buckets) under the serial,
     async (plain, chunked, capped) and mesh executors, each run bitwise
     the serial one, with its launch counts, wall and planning split;
     4f. the main cell in the dynamic worlds: bucket 1 (static,
     ``Sampling(size=6)``, weighted, ``Faults``, an ``EnergyBudget`` that
     binds; 20 rows) and bucket 2 (``Fading`` with sampling and faults; 4
     rows), 20 periods each, with the budget's shed and dropped counts,
     the planning cost of the solo-planned dynamic schedulers against the
     fused ones, each bucket's launch counts, wall, planning split and
     peak memory, and the bitwise pins on the card (identity dynamics ==
     static, full cohort == unsampled, chunked == monolithic, a poisoned
     sampled-out column changes nothing);
     4g. the main cell as the Table-II schemes (``grid(base, scheme=[4],
     partition=[2])``, seeds (0, 1): 16 rows in 3 buckets — individual,
     model_fl, gradient_fl + feel), at ``local_steps`` 2 and 4 (8 rows in
     2 buckets) and under ``Topology(cells=4, edges=2, agg_every=3)`` (4
     rows), 20 periods each, with each bucket's wall, planning split,
     peak memory and SBC launches (120 where the rows compress, 0 in a
     dev bucket), the Table-II report (final accuracy, simulated time,
     time to 0.6, speedup against individual), and the bitwise pins on
     the card (chunked == monolithic for a dev, a τ and the hierarchical
     bucket; a sampled-out individual user holds still);
     4h. the closed loop at ``replan=5`` over 20 periods: the main cell's
     16 rows (one scheduler a row) under the serial and async executors
     and the serial one again, bitwise equal, with each run's wall,
     planning split, peak memory and SBC launches, and its decisions held
     against the open loop's (if ``global_batch`` equals it, the series
     bitwise too); ``benchmarks/fig_replan.py``'s GPU fleet open and
     closed loop (B* per chunk, the decay caps, the ξ-calibration error);
     adaptive τ from 1 over (1, 2, 4) (τ and wall per chunk); and the
     drifting channel of ``examples/quickstart.py``'s part 5, open loop
     against closed (simulated seconds at period 20);
     4i. ``repro_torch.serve.ExperimentService`` at the main cell's width
     under ``benchmarks/serve_load.py``'s traffic (two hot templates of 6
     periods, 12 Poisson arrivals at 6/s on a virtual clock advanced by
     measured wall, after an untimed warm-up; a 24-period background
     request and a transformer and a mamba2 request, 2 seeds, 4 periods;
     chunk 2, window 0.02, ``max_batch`` 2): hit rate >= 0.5, a
     preemption, no ledger event in a warm admission, launches against
     the formulas, p50/p99 result latency, wall and peak memory; every
     ticket bitwise its admission group's ``Experiment`` twin, and its
     solo twin's ledgers bitwise, losses 1e-4 (the gap printed);
     4j. ``FeelSimulation`` at the same width, ``engine="scan"`` against
     ``engine="python"`` over 20 periods (times bitwise, the loss gap
     stated) and ``run_seed_batch`` of 4 seeds bitwise its
     ``Experiment`` bucket, with each one's wall a period;
  5. the card against the port's CPU path (three periods of one row,
     and of one row per batchsize policy through ``Experiment``),
     chunked == monolithic bitwise on the card, and a padded row against
     its solo twin; 5b. the same for the transformer, 5c. for mamba2;
     5d. decode at the reduced configs (and a window of 8) over 12
     tokens: card vs CPU path (1e-4 in log-softmax) and decode vs the
     port's full-sequence forward on the card (2e-3); 5e. the dynamic
     worlds, card vs CPU path: one feel-mlp row each of sampling,
     weighted sampling, fading with faults and the budget, and a
     weighted-sampled transformer row (through B4, B4′ and B4″), 3
     periods: ledgers bitwise, losses 1e-4; 5f. the schemes, card vs
     CPU path: one row each of individual, model_fl (and one sampled),
     gradient_fl, τ 2 (compressed and not) and the hierarchy, 3 periods,
     the same tolerances; 5g. the closed loop, card vs CPU path:
     ``replan=2`` over 4 periods on one row each of 4h's main cell, GPU
     fleet and adaptive-τ row and a transformer row (through B1, B2, B4,
     B4′ and B4″): ``global_batch`` and the τ sequence equal, times
     within rtol 1e-9, losses 1e-4; 5h. the service, card vs CPU path: one
     fixed-step tape (a transformer ticket and three feel-mlp ones):
     ``stats.to_dict()`` equal, ledgers bitwise, losses 1e-4;
  6. the SSD kernels' and the three attention kernels' resources
     (registers, spills, shared memory, resident warps or CTAs an SM; the
     SSD forward and the attention kernels in every instance, failing on a
     spill); kernel times (CUDA events, cold L2; the attention kernels and
     the SSD forward also on the card from the profiler) beside
     their bound, the plain versions' times and, for attention and
     decode, one PyTorch call
     (``scaled_dot_product_attention``; for the attention backward its
     forward + backward and its backward alone) as a yardstick (none
     computes the SBC pair or the SSD scan in one call); flash decode
     also at one
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

# the grid cell (phase 4e): the main cell's model, data and fleet swept
# over the four batchsize policies x two SBC ratios x two partitions, 2
# seeds: 32 rows in two buckets (one a ratio) of 16, under each executor
G_POLICIES = ("online", "full", "random", "proposed")
G_RATIOS = (0.005, 0.02)
G_TARGET = 0.6
G_SERIAL = "SerialExecutor()"

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
# the forward's own seams: S around its 16-token tiles (1, 15; 33, 40: a
# state across two and three tiles), P wider than a unit's 256 rows, P 3
# with a state (one row a thread, rows not 16-byte aligned); and N 128,
# mamba2-2.7b's heads (H 80, P 64), one tile and three
SSD_FWD_SEAMS = [(2, 2, 1, 8, 8, 2, 32, 1), (2, 2, 15, 8, 8, 2, 32, 15),
                 (2, 2, 33, 8, 8, 2, 32, 33), (2, 2, 40, 8, 8, 2, 32, 40),
                 (1, 2, 16, 2, 320, 1, 16, 16), (1, 2, 40, 4, 3, 2, 16, 40)]
SSD_FWD_N128 = [(1, 2, 16, 80, 64, 1, 128, 16),
                (1, 2, 40, 80, 64, 1, 128, 40)]
# (H, P, G, N) at which phase 6 reads the forward's resources: every
# instance (N 16, 32, 64, 128; P % 4 == 0 or not), the cell's shape first
SSD_FWD_RESOURCE_SHAPES = [(64, 8, 1, 16), (8, 16, 2, 32), (8, 32, 4, 64),
                           (80, 64, 1, 128), (6, 1, 2, 16), (4, 3, 2, 32),
                           (4, 3, 2, 64), (4, 3, 2, 128)]
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
# the dynamic-worlds cell (phase 4f): the main cell's model, data and
# fleet, seeds (0, 1), iid and noniid, under five value-only worlds (one
# bucket of 20 rows) and under fading with sampling and faults (one
# bucket of 4: the chain's state count is structural).  The budget, in J
# a user a period at the default 1 W compute and 1 W radio, binds on the
# Table-II fleet: it sheds and drops (user, period) pairs and empties no
# period (the plan's own counts are printed and checked)
F_BUDGET_J = 0.5
F_SEEDS = (0, 1)
F_PIN_PERIODS = 5
# the schemes cell (phase 4g): the main cell's model, data and fleet,
# seeds (0, 1), iid and noniid, as the four Table-II schemes (16 rows in
# 3 buckets: individual, model_fl, gradient_fl + feel), at τ local steps
# (8 rows in 2 buckets) and under a cell→edge→cloud topology (4 rows);
# the B1/B2 launches a bucket: 6 leaves x PERIODS where the rows
# compress (once a period whatever τ), none in a dev bucket
S_SCHEMES = ("individual", "model_fl", "gradient_fl", "feel")
S_TAUS = (2, 4)
S_TOPOLOGY = dict(cells=4, edges=2, agg_every=3)
S_CHUNK = 5
# the closed-loop cell (phase 4h): the main cell at replan=5 (four
# chunks), the adaptive-τ choices and the drifting channel of
# examples/quickstart.py's part 5
H_REPLAN = 5
H_TAUS = (1, 2, 4)
H_FADING = dict(states=3, spread=1.2, stickiness=0.95)


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
    counts as kernel time: (the median over the calls of the milliseconds
    in the kernels whose names hold ``name``, taken over the calls in
    which the trace holds such a kernel, and the medians over the calls of
    the kernels a call puts on the card besides the flush and of its span
    there, from its first kernel's start to its last kernel's end, gaps
    between them included)."""
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
    calls = []          # [first start, last end, kernels, us in `name`]
    for e in kernels:
        if "Fill" in e.name:                 # the flush opens the next call
            calls.append(None)
            continue
        if not calls or calls[-1] is None:
            calls.append([e.time_range.start, e.time_range.end, 0, 0.0])
        call = calls[-1]
        call[1:3] = [e.time_range.end, call[2] + 1]
        if name in e.name:
            call[3] += e.time_range.end - e.time_range.start
    calls = [c for c in calls if c is not None]
    median = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    named = [c[3] for c in calls if c[3] > 0]
    if not named:
        return float("nan"), 0.0, float("nan")
    return (median(named) / 1e3, median([c[2] for c in calls]),
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
    of the whole launch (forward, dQ with D, and dK/dV); and the backward
    run twice bitwise.  Returns the
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
        """The backward pair against the plain backward (and autograd of
        the oracle), D against the plain dQ kernel's; returns (dO, dq, D,
        dk, dv)."""
        do = torch.randn(q.shape, generator=gen, device="cuda")
        dq, dsum = kfa.flash_attention_bwd_dq(q, k, v, o, lse, do, **opts)
        dk, dv = kfa.flash_attention_bwd_dkdv(q, k, v, lse, do, dsum, **opts)
        pdq, pdsum = kfa.flash_attention_bwd_dq_plain(q, k, v, o, lse, do,
                                                      **opts)
        pdk, pdv = kfa.flash_attention_bwd_dkdv_plain(q, k, v, lse, do, pdsum,
                                                      **opts)
        close("flash_attention_bwd_dq", dq, pdq, 1e-4, label)
        close("flash_attention_bwd_dq", dsum, pdsum, 1e-4, label + " D")
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
        return do, dq, dsum, dk, dv

    for b, s, hq, hkv, hd, causal, window in ATTN_CASES:
        label = (f"attention B={b} S={s} Hq={hq} Hkv={hkv} hd={hd} "
                 f"causal={causal} window={window}")
        opts = dict(causal=causal, window=window)
        q, k, v = attention_inputs(torch, gen, b, s, hq, hkv, hd)
        o, lse = forward(q, k, v, opts, label)
        do, dq, dsum, dk, dv = backward(q, k, v, o, lse, opts, label)
        if (b, s, hq, hkv, hd) == T_SHAPE:     # batch-invariant, bitwise
            for i in (0, b // 2):
                one = slice(i, i + 1)
                oi, li = kfa.flash_attention_fwd(q[one], k[one], v[one],
                                                 **opts)
                dqi, dsi = kfa.flash_attention_bwd_dq(
                    q[one], k[one], v[one], o[one], lse[one], do[one],
                    **opts)
                dki, dvi = kfa.flash_attention_bwd_dkdv(
                    q[one], k[one], v[one], lse[one], do[one], dsum[one],
                    **opts)
                if not (torch.equal(oi, o[one]) and torch.equal(li, lse[one])
                        and torch.equal(dqi, dq[one])
                        and torch.equal(dsi, dsum[one])
                        and torch.equal(dki, dk[one])
                        and torch.equal(dvi, dv[one])):
                    raise AssertionError(
                        f"{label}: sequence {i} alone differs from the "
                        "same rows of the whole batch (o, lse, dq, D, dk or "
                        "dv)")
        del q, k, v, o, lse, do, dq, dsum, dk, dv
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


def visible_pairs(torch, q, causal, window) -> int:
    """The (sequence, query head, query, key) pairs that the mask lets
    through."""
    b, s, hq, _ = q.shape
    pos = torch.arange(s)
    mask = torch.ones((s, s), dtype=torch.bool)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    return b * hq * int(mask.sum())


def bound(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    """(bound_ms, bound_by): bytes over 3.35 TB/s vs operations over the
    peak rate of their type (f32: 67 TFLOP/s)."""
    bound_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    bound_ops = 1e3 * ops / ops_per_s
    return (max(bound_bytes, bound_ops),
            "bytes" if bound_bytes >= bound_ops else "operations")


def attention_bound(torch, q, k, causal, window):
    """(bound_ms, bound_by, bytes, ops) of one attention forward: q, k, v
    read once, o and the f32 lse written once, over 3.35 TB/s, against the
    visible (query, key) pairs' 4 hd + 4 operations over the peak rate of
    the inputs' type."""
    b, s, hq, hd = q.shape
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + 4 * b * hq * s
    ops = visible_pairs(torch, q, causal, window) * (4 * hd + 4)
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    return (*bound(nbytes, ops, rate), nbytes, ops)


def dq_bound(torch, q, k, causal, window):
    """(bound_ms, bound_by, bytes, ops) of one dQ call (f32): q, o, dO, k,
    v and lse read once, dq and D written once, over 3.35 TB/s, against the
    visible pairs' 6 hd + 4 operations and D's 2 hd a row over 67
    TFLOP/s."""
    b, s, hq, hd = q.shape
    nbytes = 4 * (4 * q.numel() + 2 * k.numel() + 2 * b * hq * s)
    ops = (visible_pairs(torch, q, causal, window) * (6 * hd + 4)
           + b * hq * s * 2 * hd)
    return (*bound(nbytes, ops), nbytes, ops)


def dkdv_bound(torch, q, k, causal, window):
    """(bound_ms, bound_by, bytes, ops) of one dK/dV call (f32): q, dO, k,
    v, lse and D read once, dk and dv written once, over 3.35 TB/s, against
    the visible pairs' 8 hd + 4 operations over 67 TFLOP/s."""
    b, s, hq, hd = q.shape
    nbytes = 4 * (2 * q.numel() + 4 * k.numel() + 2 * b * hq * s)
    ops = visible_pairs(torch, q, causal, window) * (8 * hd + 4)
    return (*bound(nbytes, ops), nbytes, ops)


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
    (forward; forward + backward for the backward kernels, and its
    backward alone on a graph built once) as a yardstick.  Bounds: bytes
    moved (each input read once, each output written once) over 3.35 TB/s
    vs the visible pairs' f32 operations over 67 TFLOP/s.  Each kernel
    also on the card (profiler)."""
    b, s, hq, hkv, hd = T_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = attention_inputs(torch, gen, b, s, hq, hkv, hd)
    do = torch.randn(q.shape, generator=gen, device="cuda")
    o, lse = kfa.flash_attention_fwd(q, k, v)
    _, dsum = kfa.flash_attention_bwd_dq(q, k, v, o, lse, do)
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]

    def sdpa_fwd():
        return F.scaled_dot_product_attention(*leaves, is_causal=True,
                                              enable_gqa=True)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa_fwd(), leaves, dot)

    graph = sdpa_fwd()

    def sdpa_bwd():
        return torch.autograd.grad(graph, leaves, dot, retain_graph=True)

    runs = {
        "flash_attention_fwd": (
            lambda: kfa.flash_attention_fwd(q, k, v),
            lambda: kfa.flash_attention_fwd_plain(q, k, v),
            sdpa_call(torch, F, q, k, v, True, None),
            *attention_bound(torch, q, k, True, None)[2:]),
        "flash_attention_bwd_dq": (
            lambda: kfa.flash_attention_bwd_dq(q, k, v, o, lse, do),
            lambda: kfa.flash_attention_bwd_dq_plain(q, k, v, o, lse, do),
            sdpa_fwd_bwd, *dq_bound(torch, q, k, True, None)[2:]),
        "flash_attention_bwd_dkdv": (
            lambda: kfa.flash_attention_bwd_dkdv(q, k, v, lse, do, dsum),
            lambda: kfa.flash_attention_bwd_dkdv_plain(q, k, v, lse, do,
                                                       dsum),
            sdpa_fwd_bwd, *dkdv_bound(torch, q, k, True, None)[2:]),
    }
    out = {}
    for name, (kern, plain, lib, nbytes, ops) in runs.items():
        bound_ms, bound_by = bound(nbytes, ops)
        out[name] = {"ms": cold_ms(torch, kern),
                     "plain_ms": cold_ms(torch, plain),
                     "library_ms": cold_ms(torch, lib),
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bytes": nbytes, "ops": ops}
    library_bwd_ms = cold_ms(torch, sdpa_bwd)
    for name, kernel in (("flash_attention_fwd", "fwd_kernel"),
                         ("flash_attention_bwd_dq", "dq_kernel"),
                         ("flash_attention_bwd_dkdv", "dkdv_kernel")):
        out[name]["device_ms"] = device_ms(torch, runs[name][0], kernel)[0]
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv"):
        out[name]["library_bwd_ms"] = library_bwd_ms
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
    float64 and in float32 (where sound), at the mamba2 cell's shape, at
    the reference's four kernel-test shapes and at the backward's seams;
    the forward also at its own seams and at N 128.  The forward and the
    backward run twice bitwise; a sequence's y, and a copy's gradients,
    bitwise the same alone and among the rest.  Returns the max abs
    errors; raises AssertionError."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    errs = {"ssd_scan_fwd": 0.0, "ssd_scan_bwd": 0.0, "bf16_fwd": 0.0,
            "fwd_vs_f64": 0.0, "bwd_vs_f64": 0.0, "plain_fwd_vs_f64": 0.0,
            "plain_bwd_vs_f64": 0.0, "left_out": 0}
    b, s, h, p, g, n, chunk = M_SHAPE
    cases = [(M_COPIES, b // M_COPIES, s, h, p, g, n, chunk),
             (2, 1, 128, 4, 32, 2, 16, 32), (1, 1, 64, 2, 64, 1, 32, 16),
             (1, 2, 256, 8, 32, 4, 64, 64), (1, 1, 128, 4, 32, 4, 16, 128)]
    cases += SSD_BWD_SEAMS
    fwd_only = SSD_FWD_SEAMS + SSD_FWD_N128

    def note(key, f64_key, got):
        errs[key] = max(errs[key], got[0])
        errs[f64_key] = max(errs[f64_key], got[1])
        errs[f"plain_{f64_key}"] = max(errs[f"plain_{f64_key}"], got[2])
        errs["left_out"] += got[3]

    for copies, per, s, h, p, g, n, chunk in cases + fwd_only:
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
        if (copies, per, s, h, p, g, n, chunk) in fwd_only:
            del ins, dy, y, exact_in, bf, yb, pb
            continue
        got = kssd.ssd_scan_bwd(*ins, dy, chunk=chunk)
        plain = kssd.ssd_scan_bwd_plain(*ins, dy, chunk=chunk)
        exact = kssd.ssd_scan_bwd_plain(*exact_in, dy.double(), chunk=chunk)
        for name, a, pl, ex in zip(("dx", "ddt", "dA", "dBm", "dCm"), got,
                                   plain, exact):
            note("ssd_scan_bwd", "bwd_vs_f64",
                 close_to_plain(torch, a, pl, ex, 1e-4, f"{label} {name}"))
        del ins, dy, y, exact_in, bf, got, plain, exact
        torch.cuda.empty_cache()
    # the forward at the cell's whole batch: twice bitwise (f32, bf16), and
    # sequences alone bitwise the same rows among the 12 288
    ins, _ = ssd_inputs(torch, gen, *cases[0][:7])
    bf = [t.bfloat16() for t in ins]
    bf[2] = ins[2]
    for args in (ins, bf):
        first = kssd.ssd_scan_fwd(*args, chunk=M_SHAPE[-1])
        if not torch.equal(first, kssd.ssd_scan_fwd(*args,
                                                    chunk=M_SHAPE[-1])):
            raise AssertionError("the SSD forward is not bitwise "
                                 "reproducible")
        per = M_SHAPE[0] // M_COPIES
        for k in (0, 5000, M_SHAPE[0] - 1):
            alone = kssd.ssd_scan_fwd(
                *(t[k:k + 1] for t in args[:2]),
                args[2][k // per:k // per + 1],
                *(t[k:k + 1] for t in args[3:]), chunk=M_SHAPE[-1])
            if not torch.equal(alone, first[k:k + 1]):
                raise AssertionError(f"the SSD forward of sequence {k} "
                                     f"alone is not bitwise the same "
                                     f"sequence among {M_SHAPE[0]}")
    del ins, bf, first, alone
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
    forward's as the per-token recurrence counts them, 5N + 2 a (sequence,
    token, head, p) row (the state update a*h + u*B and y = h.C; kept for
    the dual form too, so that both designs meet one bound, which bytes
    set either way); the backward's sums over
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


def ssd_times(torch, kssd):
    """Cold-L2 median times at the mamba2 cell's SSD shape (x, Bm, Cm
    slices of the conv output, as on the path): each kernel and its plain
    version, beside the bound of :func:`ssd_work`; the forward also on the
    card from the profiler."""
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
    out["ssd_scan_fwd"]["device_ms"] = device_ms(
        torch, runs["ssd_scan_fwd"][0], "ssd_fwd_kernel")[0]
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
                        "DeviceProfile lowering data test engine tree_leaves")


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


def grid_cell(env, api, counted):
    """Phase 4e: ``Experiment(data, test, grid(...)).run(PERIODS)`` at the
    main cell's full width under each executor below (the serial one first
    and again last, for the spread of its wall), after a 1-period
    warm-up.  Around each run the SBC counts are set to 0 and read
    (expected: six leaves x PERIODS x two buckets), peak memory is reset
    and read, and the executor's timings (host planning, enqueue,
    collect) are kept.  Every run must equal the
    serial one bitwise (losses, accuracies, times, global batch).  Raises
    AssertionError."""
    torch, np = env.torch, env.np
    base = env.ScenarioSpec(fleet=fleet(env.DeviceProfile, DEVICES),
                            name="K12", b_max=128, base_lr=0.05,
                            seeds=(0, 1))
    study = api.grid(base, policy=list(G_POLICIES),
                     compression=list(G_RATIOS), partition=["iid", "noniid"])
    exp = env.Experiment(env.data, env.test, study)
    buckets = exp.lower()
    if (len(buckets) != 2 or [len(b.rows) for b in buckets] != [16, 16]):
        raise AssertionError(f"4e: the grid lowered to "
                             f"{[len(b.rows) for b in buckets]} rows a "
                             "bucket, expected two buckets of 16")
    t0 = time.perf_counter()
    exp.run(1)                                           # warm-up period
    torch.cuda.synchronize()
    log(f"[4e grid] {study!r}: {sum(len(b.rows) for b in buckets)} rows in "
        f"{len(buckets)} buckets of 16 x {DEVICES} devices; warm-up run of "
        f"1 period {time.perf_counter() - t0:.2f} s")
    want = {name: len(LEAF_LENGTHS) * PERIODS * len(buckets)
            for name in counted}
    executors = [
        (G_SERIAL, api.SerialExecutor()),
        ("AsyncExecutor()", api.AsyncExecutor()),
        ("AsyncExecutor(chunk_periods=5)", api.AsyncExecutor(chunk_periods=5)),
        ("AsyncExecutor(max_in_flight=1, chunk_periods=5)",
         api.AsyncExecutor(max_in_flight=1, chunk_periods=5)),
        ("MeshExecutor()", api.MeshExecutor()),
        (G_SERIAL + " again", api.SerialExecutor())]
    runs, out = {}, {}
    for label, executor in executors:
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = exp.run(PERIODS, executor=executor)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counted.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        tm = dict(executor.timings)
        runs[label] = res
        log(f"[4e grid] {label}: {res.rows} rows x {PERIODS} periods in "
            f"{wall:.3f} s = {1e3 * wall / PERIODS:.1f} ms/period; host "
            f"planning {tm['plan']:.3f} s, enqueue {tm['dispatch']:.3f} s, "
            f"collect {tm['collect']:.3f} s; peak device memory {peak:.2f} GiB; launches {launches} "
            f"(expected {want})")
        if launches != want:
            raise AssertionError(f"4e: {label}: kernel launches {launches}, "
                                 f"expected {want}")
        out[label] = {"wall_s": wall, "ms_per_period": 1e3 * wall / PERIODS,
                      "timings_s": tm, "peak_gib": peak,
                      "launches": launches}
    serial = runs[G_SERIAL]
    fields = ("losses", "accs", "times", "global_batch")
    for label, res in runs.items():
        if not all(np.array_equal(getattr(res, f), getattr(serial, f))
                   for f in fields):
            raise AssertionError(f"4e: {label} differs from {G_SERIAL}")
    if not (np.isfinite(serial.losses).all()
            and np.isfinite(serial.accs).all()):
        raise AssertionError("4e: non-finite series")
    if not serial.losses[:, -1].mean() < serial.losses[:, 0].mean():
        raise AssertionError("4e: the mean loss did not fall over the run")
    speed = {}
    for policy in G_POLICIES:
        sub = serial.sel(policy=policy)
        speed[policy] = {"speed_s": sub.speed(G_TARGET).tolist(),
                         "final_acc": sub.final_acc.tolist(),
                         "final_time_s": sub.times[:, -1].tolist()}
        log(f"[4e grid] policy={policy}: speed({G_TARGET}) "
            f"{np.round(sub.speed(G_TARGET), 3).tolist()} simulated s; "
            f"final accuracy mean {sub.final_acc.mean():.4f}; simulated "
            f"time at period {PERIODS} mean {sub.times[:, -1].mean():.3f} s")
    log(f"[4e grid] all {len(runs) - 1} other runs bitwise equal to "
        f"{G_SERIAL} (losses, accuracies, times, global batch)")
    return {"rows": serial.rows, "buckets": len(buckets),
            "periods": PERIODS, "executors": out, "speed": speed}


def policy_contracts(env, api):
    """Phase 5, per policy: one row of each of the four batchsize
    policies (the main cell's K = 12, iid) for 3 periods on the card and
    on the port's CPU path: ledgers bitwise, losses 1e-4, accuracies two
    test predictions.  Raises AssertionError."""
    np, data, test = env.np, env.data, env.test
    base = env.ScenarioSpec(fleet=fleet(env.DeviceProfile, DEVICES),
                            name="K12", partition="iid", seeds=(0,))
    study = api.grid(base, policy=list(G_POLICIES))
    card = env.Experiment(data, test, study).run(3)
    cpu = env.Experiment(data, test, study, device="cpu").run(3)
    loss_err = float(np.abs(card.losses - cpu.losses).max())
    acc_err = float(np.abs(card.accs - cpu.accs).max())
    log(f"[5 card vs cpu] one row per policy {G_POLICIES}, 3 periods: "
        f"global batch {card.global_batch[:, -1].tolist()}; losses max abs "
        f"err {loss_err:.3g}; accs max abs err {acc_err:.3g}")
    if not (np.array_equal(card.times, cpu.times)
            and np.array_equal(card.global_batch, cpu.global_batch)
            and np.allclose(card.losses, cpu.losses, rtol=1e-4, atol=1e-4)
            and acc_err <= 2.0 / len(test.y) + 1e-7):
        raise AssertionError("5: per policy, card and CPU path disagree "
                             "beyond ledgers bitwise, losses 1e-4, "
                             "accuracies two test predictions")
    return {"loss_max_abs_err": loss_err, "acc_max_abs_err": acc_err}


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


def dynamic_worlds(api):
    """Phase 4f's worlds: bucket 1's five value-only ones and bucket 2's
    fading world, each as a label and the spec fields that make it."""
    faults = api.Faults(slow_prob=0.1, slow_factor=4.0, drop_prob=0.1)
    bucket1 = {
        "static": {},
        "Sampling(size=6)": {"sampling": api.Sampling(size=6)},
        "Sampling(size=6, weighted=True)": {
            "sampling": api.Sampling(size=6, weighted=True)},
        "Faults(0.1, x4, drop 0.1)": {"faults": faults},
        f"EnergyBudget({F_BUDGET_J} J)": {
            "energy": api.EnergyBudget(budget_j=F_BUDGET_J)}}
    bucket2 = {"Fading(3, 0.6, 0.9) + Sampling(size=6) + Faults": {
        "fading": api.Fading(states=3, spread=0.6, stickiness=0.9),
        "sampling": api.Sampling(size=6), "faults": faults}}
    return bucket1, bucket2


def world_specs(env, worlds, partitions=("iid", "noniid"), seeds=F_SEEDS,
                **kw):
    """The main cell's spec in each world, each partition."""
    kw = dict(dict(b_max=128, base_lr=0.05), **kw)
    return [env.ScenarioSpec(fleet=fleet(env.DeviceProfile, DEVICES),
                             name="K12", partition=p, seeds=seeds,
                             **fields, **kw)
            for fields in worlds.values() for p in partitions]


def budget_counts(env, specs):
    """The budget's (user, period) pairs over the cell's horizon from the
    lowering's plan: shed (a smaller batch than the static twin's, same
    partition and seed) and dropped, and the periods left empty."""
    np = env.np
    (bucket,) = env.lowering.group_rows(specs)
    plan = env.lowering.plan_bucket(bucket, env.data, PERIODS)
    twin = {(r.spec.partition, r.seed): i for i, r in enumerate(bucket.rows)
            if r.spec.energy is None and r.spec.sampling is None
            and r.spec.faults is None}
    shed = dropped = empty = 0
    for i, r in enumerate(bucket.rows):
        if r.spec.energy is None:
            continue
        batch = plan.schedules[i].batch
        static = plan.schedules[twin[(r.spec.partition, r.seed)]].batch
        shed += int(((batch < static) & (batch > 0)).sum())
        dropped += int((plan.active[i] < 0.5).sum())
        empty += int((plan.active[i].sum(-1) == 0).sum())
    return {"shed": shed, "dropped": dropped, "empty_periods": empty,
            "rows": sum(r.spec.energy is not None for r in bucket.rows)}


def planning_costs(env, specs):
    """Host planning of bucket 1's schedulers over the cell's horizon, ms
    a scheduler-period: the fused non-dynamic ones (``plan_horizons_batch``
    on them alone, and one by one) against the dynamic ones, which plan
    solo by design."""
    from repro_torch.core.scheduler import plan_horizons_batch
    (bucket,) = env.lowering.group_rows(specs)

    def schedulers():
        return env.lowering._FeelPlanner(bucket, env.data).schedulers

    fused = [s for s in schedulers() if not s.dynamic]
    t0 = time.perf_counter()
    plan_horizons_batch(fused, PERIODS)
    t_fused = time.perf_counter() - t0
    one_by_one = [s for s in schedulers() if not s.dynamic]
    t0 = time.perf_counter()
    for s in one_by_one:
        s.plan_horizon(PERIODS)
    t_one = time.perf_counter() - t0
    dynamic = [s for s in schedulers() if s.dynamic]
    t0 = time.perf_counter()
    for s in dynamic:
        s.plan_horizon(PERIODS)
    t_dyn = time.perf_counter() - t0
    per = lambda t, n: 1e3 * t / (n * PERIODS)           # noqa: E731
    return {"fused_schedulers": len(fused),
            "dynamic_schedulers": len(dynamic),
            "fused_ms_per_scheduler_period": per(t_fused, len(fused)),
            "fused_one_by_one_ms_per_scheduler_period":
                per(t_one, len(one_by_one)),
            "dynamic_solo_ms_per_scheduler_period":
                per(t_dyn, len(dynamic))}


def dynamics_cell(env, api, counted):
    """Phase 4f: the main cell in the dynamic worlds at full width, each
    bucket through ``Experiment.run(PERIODS, executor=SerialExecutor())``
    after a 1-period warm-up, with the SBC counts set to 0 just before and
    read just after (expected: six leaves x PERIODS a bucket), its wall,
    the executor's planning / enqueue / collect split and peak memory.
    Then the bitwise pins on the card: identity dynamics == static,
    Sampling(size=12) == unsampled, bucket 2 under
    AsyncExecutor(chunk_periods=5) == monolithic, and a sampled-out column
    poisoned with garbage weights and batches changes nothing.  Raises
    AssertionError."""
    torch, np, lowering = env.torch, env.np, env.lowering
    Experiment, data, test = env.Experiment, env.data, env.test
    worlds1, worlds2 = dynamic_worlds(api)
    cells = {"bucket 1": world_specs(env, worlds1),
             "bucket 2": world_specs(env, worlds2)}
    out = {"worlds": {"bucket 1": list(worlds1), "bucket 2": list(worlds2)},
           "budget_j": F_BUDGET_J}
    for tag, specs in cells.items():
        buckets = Experiment(data, test, specs).lower()
        want_rows = 2 * len(F_SEEDS) * (5 if tag == "bucket 1" else 1)
        if [len(b.rows) for b in buckets] != [want_rows]:
            raise AssertionError(f"4f: {tag} lowered to "
                                 f"{[len(b.rows) for b in buckets]} rows a "
                                 f"bucket, expected one of {want_rows}")
    counts = budget_counts(env, cells["bucket 1"])
    log(f"[4f dynamics] EnergyBudget(budget_j={F_BUDGET_J}) on the Table-II "
        f"fleet over {PERIODS} periods, {counts['rows']} rows: "
        f"{counts['shed']} (user, period) pairs shed, {counts['dropped']} "
        f"dropped, {counts['empty_periods']} empty periods")
    if not (counts["shed"] > 0 and counts["dropped"] > 0
            and counts["empty_periods"] == 0):
        raise AssertionError(f"4f: the budget does not bind as stated: "
                             f"{counts}")
    out["budget"] = counts
    costs = planning_costs(env, cells["bucket 1"])
    log(f"[4f dynamics] bucket 1 host planning, ms a scheduler-period: "
        f"{costs['fused_schedulers']} fused schedulers "
        f"{costs['fused_ms_per_scheduler_period']:.3f} (one by one "
        f"{costs['fused_one_by_one_ms_per_scheduler_period']:.3f}); "
        f"{costs['dynamic_schedulers']} dynamic schedulers, solo "
        f"{costs['dynamic_solo_ms_per_scheduler_period']:.3f}")
    out["planning"] = costs
    want = {name: len(LEAF_LENGTHS) * PERIODS for name in counted}
    runs = {}
    for tag, specs in cells.items():
        exp = Experiment(data, test, specs)
        t0 = time.perf_counter()
        exp.run(1)                                       # warm-up period
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        executor = env.SerialExecutor()
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = exp.run(PERIODS, executor=executor)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counted.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        tm = dict(executor.timings)
        runs[tag] = res
        log(f"[4f dynamics] {tag} ({', '.join(out['worlds'][tag])}; iid and "
            f"noniid x seeds {F_SEEDS}): {res.rows} rows x {PERIODS} periods "
            f"in {wall:.3f} s = {1e3 * wall / PERIODS:.1f} ms/period "
            f"(warm-up run of 1 period {t_warm:.2f} s); host planning "
            f"{tm['plan']:.3f} s, enqueue {tm['dispatch']:.3f} s, collect "
            f"{tm['collect']:.3f} s; peak device memory {peak:.2f} GiB; "
            f"launches {launches} (expected {want})")
        log(f"[4f dynamics] {tag}: mean accuracy period 1 "
            f"{res.accs[:, 0].mean():.4f} -> period {PERIODS} "
            f"{res.final_acc.mean():.4f}; mean loss "
            f"{res.losses[:, 0].mean():.4f} -> {res.losses[:, -1].mean():.4f}"
            f"; simulated time at period {PERIODS} per row "
            f"{np.round(res.times[:, -1], 3).tolist()} s")
        if launches != want:
            raise AssertionError(f"4f: {tag}: kernel launches {launches}, "
                                 f"expected {want}")
        if not (np.isfinite(res.losses).all() and np.isfinite(res.accs).all()
                and np.isfinite(res.times).all()):
            raise AssertionError(f"4f: {tag}: non-finite series")
        if not res.losses[:, -1].mean() < res.losses[:, 0].mean():
            raise AssertionError(f"4f: {tag}: the mean loss did not fall")
        out[tag] = {"rows": res.rows, "periods": PERIODS, "wall_s": wall,
                    "ms_per_period": 1e3 * wall / PERIODS, "timings_s": tm,
                    "peak_gib": peak, "launches": launches,
                    "final_acc": res.final_acc.tolist(),
                    "final_time_s": res.times[:, -1].tolist()}

    fields = ("losses", "accs", "times", "global_batch")

    def same(a, b):
        return all(np.array_equal(getattr(a, f), getattr(b, f))
                   for f in fields)

    def pin_run(worlds):
        return Experiment(data, test, world_specs(
            env, worlds, partitions=("iid",))).run(F_PIN_PERIODS)

    static = pin_run({"static": {}})
    identity = pin_run({"identity": {
        "fading": api.Fading(spread=0.0),
        "faults": api.Faults(slow_prob=0.0, drop_prob=0.0),
        "energy": api.EnergyBudget()}})
    full = pin_run({"full": {"sampling": api.Sampling(size=DEVICES)}})
    chunked = Experiment(data, test, cells["bucket 2"]).run(
        PERIODS, executor=api.AsyncExecutor(chunk_periods=5))
    pins = {"identity dynamics == static": same(identity, static),
            "Sampling(size=12) == unsampled": same(full, static),
            "bucket 2 AsyncExecutor(chunk_periods=5) == monolithic":
                same(chunked, runs["bucket 2"])}
    # a sampled-out column poisoned: the engine on the lowering's plan
    (bucket,) = lowering.group_rows(world_specs(
        env, {"s6": {"sampling": api.Sampling(size=6)}},
        partitions=("iid",)))
    plan = lowering.plan_bucket(bucket, data, F_PIN_PERIODS)
    features = lowering.DeviceData(data, test, "cuda").features

    def engine_run(schedules):
        params0 = lowering._init_params_batch(bucket.rows, plan.input_dim,
                                              "cuda")
        state = env.engine.EngineState(
            params0, env.engine.zero_residual(params0, DEVICES))
        state, series = env.engine.run_trajectory_batch(
            state, schedules, features, ratio=RATIO, active=plan.active)
        return [t.cpu() for t in series] + [
            t.cpu() for t in env.tree_leaves(state.params)
            + env.tree_leaves(state.residual)]

    clean = engine_run(plan.schedules)
    poisoned = []
    for i, s in enumerate(plan.schedules):
        dead = plan.active[i] < 0.5
        weight, batch = s.weight.copy(), s.batch.copy()
        weight[dead] = 1e6
        batch[dead] = 9.9e5
        poisoned.append(dataclasses.replace(s, weight=weight, batch=batch))
    pins["a poisoned sampled-out column changes nothing"] = all(
        torch.equal(a, b) for a, b in zip(clean, engine_run(poisoned)))
    log(f"[4f dynamics] on the card, bitwise ({F_PIN_PERIODS} periods, iid, "
        f"seeds {F_SEEDS}; bucket 2 over {PERIODS}): "
        + "; ".join(f"{k}: {'yes' if v else 'NO'}" for k, v in pins.items()))
    if not all(pins.values()):
        raise AssertionError(f"4f: a bitwise pin fails: {pins}")
    out["pins"] = pins
    return out


def dynamics_contracts(env, api, counted_attn):
    """Phase 5e: one row each of Sampling(size=6), weighted sampling,
    fading with faults and the budget (the main cell, iid, seed 0) for 3
    periods on the card and on the port's CPU path: ledgers bitwise,
    losses 1e-4, accuracies two test predictions.  Then one transformer
    row with Sampling(size=6, weighted=True) (slot 16) the same way, with
    the attention kernels' launches counted around its card run.  Raises
    AssertionError."""
    np, Experiment, data, test = env.np, env.Experiment, env.data, env.test
    _, worlds2 = dynamic_worlds(api)
    worlds = {"Sampling(size=6)": {"sampling": api.Sampling(size=6)},
              "Sampling(size=6, weighted=True)": {
                  "sampling": api.Sampling(size=6, weighted=True)},
              "Fading + Faults": {
                  k: v for k, v in next(iter(worlds2.values())).items()
                  if k != "sampling"},
              f"EnergyBudget({F_BUDGET_J} J)": {
                  "energy": api.EnergyBudget(budget_j=F_BUDGET_J)}}
    out = {}

    def compare(tag, specs, counted=None):
        if counted:
            for fn in counted.values():
                fn.launches = 0
        card = Experiment(data, test, specs).run(3)
        launches = ({name: fn.launches for name, fn in counted.items()}
                    if counted else None)
        cpu = Experiment(data, test, specs, device="cpu").run(3)
        loss_err = float(np.abs(card.losses - cpu.losses).max())
        acc_err = float(np.abs(card.accs - cpu.accs).max())
        log(f"[5e card vs cpu] {tag}, 3 periods: global batch "
            f"{card.global_batch[:, -1].tolist()}; losses max abs err "
            f"{loss_err:.3g}; accs max abs err {acc_err:.3g}"
            + (f"; launches on the card {launches}" if counted else ""))
        if not (np.array_equal(card.times, cpu.times)
                and np.array_equal(card.global_batch, cpu.global_batch)
                and np.allclose(card.losses, cpu.losses, rtol=1e-4,
                                atol=1e-4)
                and acc_err <= 2.0 / len(test.y) + 1e-7):
            raise AssertionError(f"5e: {tag}: card and CPU path disagree "
                                 "beyond ledgers bitwise, losses 1e-4, "
                                 "accuracies two test predictions")
        if counted and not all(n > 0 for n in launches.values()):
            raise AssertionError(f"5e: {tag}: a kernel was not launched: "
                                 f"{launches}")
        return {"loss_max_abs_err": loss_err, "acc_max_abs_err": acc_err,
                "launches": launches}

    out["feel_mlp"] = compare(
        "one feel-mlp row each of " + ", ".join(worlds),
        world_specs(env, worlds, partitions=("iid",), seeds=(0,)))
    out["transformer"] = compare(
        "transformer, Sampling(size=6, weighted=True), slot 16",
        world_specs(env, {"w": {"sampling": api.Sampling(size=6,
                                                         weighted=True)}},
                    partitions=("iid",), seeds=(0,), b_max=16,
                    model_family="transformer"), counted_attn)
    return out


def schemes_base(env, **kw):
    """The main cell's spec (K = 12, b_max 128, SBC 0.005) with ``kw``."""
    kw = dict(dict(name="K12", b_max=128, base_lr=0.05, seeds=F_SEEDS), **kw)
    return env.ScenarioSpec(fleet=fleet(env.DeviceProfile, DEVICES), **kw)


def schemes_cell(env, api, counted):
    """Phase 4g: the main cell at full width as the Table-II schemes, at τ
    local steps and under a topology, each grid through
    ``Experiment.stream(PERIODS, executor=SerialExecutor())`` after a
    1-period warm-up.  After each bucket's collection the SBC counts
    (expected 6 leaves x PERIODS where the rows compress, 0 in a dev
    bucket) and peak memory are read and reset, with the bucket's wall
    and the executor's planning / enqueue / collect split.  Then the
    Table-II report (per scheme and partition: final accuracy, simulated
    time, time to G_TARGET, speedup against ``individual``) and the
    bitwise pins on the card: chunked (S_CHUNK) == monolithic for a dev,
    a τ and the hierarchical bucket, and a sampled-out ``individual``
    user's parameters held still.  Returns the report and, for
    ``--profile``, the ``model_fl``, τ 4 and hierarchical buckets.
    Raises AssertionError."""
    torch, np, lowering = env.torch, env.np, env.lowering
    Experiment, data, test = env.Experiment, env.data, env.test
    parts = ["iid", "noniid"]
    leaves = len(LEAF_LENGTHS) * PERIODS
    topo = api.Topology(**S_TOPOLOGY)
    cells = {
        "Table II": (api.grid(schemes_base(env), scheme=list(S_SCHEMES),
                              partition=parts),
                     [4, 4, 8], [0, 0, leaves]),
        "local steps": (api.grid(schemes_base(env),
                                 local_steps=list(S_TAUS), partition=parts),
                        [4, 4], [leaves, leaves]),
        f"hierarchy {topo}": (api.grid(schemes_base(env, topology=topo),
                                       partition=parts), [4], [leaves])}
    out, results, profiled = {}, {}, {}
    for tag, (study, want_rows, want_launches) in cells.items():
        exp = Experiment(data, test, study)
        buckets = exp.lower()
        # the buckets --profile traces: model_fl, τ 4, the hierarchy
        b = buckets[1] if tag == "Table II" else buckets[-1]
        spec0 = b.rows[0].spec
        profiled[spec0.scheme if b.kind == "dev" else
                 tag if spec0.topology is not None else
                 f"local_steps={spec0.local_steps}"] = b
        if [len(b.rows) for b in buckets] != want_rows:
            raise AssertionError(f"4g: {tag} lowered to "
                                 f"{[len(b.rows) for b in buckets]} rows a "
                                 f"bucket, expected {want_rows}")
        t0 = time.perf_counter()
        exp.run(1)                                       # warm-up period
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        executor = env.SerialExecutor()
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        per_bucket, before = [], {"plan": 0.0, "dispatch": 0.0,
                                  "collect": 0.0}
        t0 = t_start = time.perf_counter()
        for bucket, res in zip(buckets, exp.stream(PERIODS,
                                                   executor=executor)):
            wall = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in counted.items()}
            peak = torch.cuda.max_memory_allocated() / 2**30
            tm = {k: v - before[k] for k, v in executor.timings.items()}
            before = dict(executor.timings)
            spec0 = bucket.rows[0].spec
            label = (f"{bucket.kind} {sorted({r.spec.scheme for r in bucket.rows})}"
                     f" local_steps={spec0.local_steps}"
                     + ("" if spec0.topology is None
                        else f" topology={spec0.topology}"))
            want = {name: want_launches[len(per_bucket)] for name in counted}
            log(f"[4g schemes] {tag}, bucket {len(per_bucket) + 1} ({label}):"
                f" {len(bucket.rows)} rows x {PERIODS} periods in {wall:.3f}"
                f" s = {1e3 * wall / PERIODS:.1f} ms/period; host planning "
                f"{1e3 * tm['plan'] / PERIODS:.1f} ms/period, enqueue "
                f"{1e3 * tm['dispatch'] / PERIODS:.1f}, collect "
                f"{1e3 * tm['collect'] / PERIODS:.2f}; peak device memory "
                f"{peak:.2f} GiB; launches {launches} (expected {want})")
            if launches != want:
                raise AssertionError(f"4g: {tag} bucket {label}: kernel "
                                     f"launches {launches}, expected {want}")
            per_bucket.append({"bucket": label, "rows": len(bucket.rows),
                               "wall_s": wall,
                               "ms_per_period": 1e3 * wall / PERIODS,
                               "timings_s": tm, "peak_gib": peak,
                               "launches": launches})
            for fn in counted.values():
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
        total = time.perf_counter() - t_start
        log(f"[4g schemes] {tag}: {res.rows} rows in {len(buckets)} buckets"
            f" in {total:.3f} s = {1e3 * total / PERIODS:.1f} ms/period "
            f"(warm-up run of 1 period {t_warm:.2f} s)")
        if not (np.isfinite(res.losses).all() and np.isfinite(res.accs).all()
                and np.isfinite(res.times).all()):
            raise AssertionError(f"4g: {tag}: non-finite series")
        if not res.losses[:, -1].mean() < res.losses[:, 0].mean():
            raise AssertionError(f"4g: {tag}: the mean loss did not fall")
        results[tag] = res
        out[tag] = {"rows": res.rows, "buckets": per_bucket,
                    "wall_s": total, "warmup_s": t_warm}

    table2 = results["Table II"]
    report = {}
    for part in parts:
        base_t = None
        for scheme in S_SCHEMES:
            sub = table2.sel(partition=part, scheme=scheme)
            t_reach = float(np.median(sub.speed(G_TARGET)))
            if scheme == "individual":
                base_t = t_reach
            speedup = (base_t / t_reach if np.isfinite(t_reach)
                       and np.isfinite(base_t) else 0.0)
            row = {"final_acc": float(sub.final_acc.mean()),
                   "sim_time_s": float(sub.times[:, -1].mean()),
                   "time_to_target_s": t_reach, "speedup": speedup}
            report[f"{part}/{scheme}"] = row
            log(f"[4g Table II] {part} {scheme:>11}: final accuracy "
                f"{row['final_acc']:.4f}; simulated time at period "
                f"{PERIODS} {row['sim_time_s']:.3f} s; time to "
                f"{G_TARGET} (median) {t_reach:.3f} s; speedup vs "
                f"individual {speedup:.2f}x")
    for tag in list(cells)[1:]:
        res = results[tag]
        for part in parts:
            sub = res.sel(partition=part)
            log(f"[4g {tag}] {part}: final accuracy "
                f"{[round(float(a), 4) for a in sub.final_acc]}; simulated "
                f"time at period {PERIODS} "
                f"{[round(float(t), 3) for t in sub.times[:, -1]]} s")
    out["table2"] = report

    # the bitwise pins on the card
    fields = ("losses", "accs", "times", "global_batch")
    pins = {}
    hier = f"hierarchy {topo}"
    for tag, mono, specs in (
            ("model_fl", results["Table II"].sel(scheme="model_fl"),
             api.grid(schemes_base(env, scheme="model_fl"),
                      partition=parts)),
            (f"local_steps={S_TAUS[0]}",
             results["local steps"].sel(local_steps=S_TAUS[0]),
             api.grid(schemes_base(env, local_steps=S_TAUS[0]),
                      partition=parts)),
            (f"topology={topo}", results[hier], cells[hier][0])):
        chunked = Experiment(data, test, specs).run(
            PERIODS, executor=env.SerialExecutor(chunk_periods=S_CHUNK))
        pins[f"{tag} chunk_periods={S_CHUNK} == monolithic"] = (
            chunked.rows == mono.rows == 4 and all(
                np.array_equal(getattr(chunked, f), getattr(mono, f))
                for f in fields))
    # a sampled-out individual user holds still, period by period
    (bucket,) = lowering.group_rows([schemes_base(
        env, scheme="individual", partition="iid", seeds=(0,),
        sampling=api.Sampling(size=6))])
    plan = lowering.plan_bucket(bucket, data, F_PIN_PERIODS)
    features = lowering.DeviceData(data, test, "cuda").features
    params0 = lowering._init_params_batch(bucket.rows, plan.input_dim, "cuda")
    state = env.engine.EngineState(lowering._broadcast_rows(params0,
                                                            DEVICES))
    held = True
    for p in range(F_PIN_PERIODS):
        before_p = state.params
        state, _ = env.engine.run_dev_trajectory_batch(
            state, plan.idx[:, p:p + 1], plan.lr, features, average=False,
            active=plan.active[:, p:p + 1])
        out_users = torch.from_numpy(plan.active[0, p] < 0.5).cuda()
        pairs = list(zip(env.tree_leaves(before_p),
                         env.tree_leaves(state.params)))
        held &= (bool(out_users.any()) and all(
            torch.equal(a[0, out_users], b[0, out_users]) for a, b in pairs)
            and all(not torch.equal(a[0, ~out_users], b[0, ~out_users])
                    for a, b in pairs))
    pins["a sampled-out individual user holds still"] = held
    log(f"[4g schemes] on the card, bitwise ({PERIODS} periods, iid and "
        f"noniid x seeds {F_SEEDS}; the held user over {F_PIN_PERIODS}): "
        + "; ".join(f"{k}: {'yes' if v else 'NO'}" for k, v in pins.items()))
    if not all(pins.values()):
        raise AssertionError(f"4g: a bitwise pin fails: {pins}")
    out["pins"] = pins
    return out, profiled


def schemes_contracts(env, api):
    """Phase 5f: one row each of ``individual``, ``model_fl`` (and one
    with ``Sampling(size=6)``), ``gradient_fl``, ``feel`` at τ 2 (and
    the same uncompressed, which shows what SBC's keep set adds to the
    gap of the τ row's (p0 − pτ)/lr upload) and ``feel`` under phase
    4g's topology (the main cell, iid, seed 0) for 3 periods on the card
    and on the port's CPU path: ledgers bitwise, losses 1e-4, accuracies
    two test predictions.  Raises AssertionError."""
    np, data, test = env.np, env.data, env.test
    rows = {"individual": {"scheme": "individual"},
            "model_fl": {"scheme": "model_fl"},
            "model_fl, Sampling(size=6)": {
                "scheme": "model_fl", "sampling": api.Sampling(size=6)},
            "gradient_fl": {"scheme": "gradient_fl"},
            f"local_steps={S_TAUS[0]}": {"local_steps": S_TAUS[0]},
            f"local_steps={S_TAUS[0]}, compress=False": {
                "local_steps": S_TAUS[0], "compress": False},
            f"topology={api.Topology(**S_TOPOLOGY)}": {
                "topology": api.Topology(**S_TOPOLOGY)}}
    specs = [schemes_base(env, partition="iid", seeds=(0,), **kw)
             for kw in rows.values()]
    card = env.Experiment(data, test, specs).run(3)
    cpu = env.Experiment(data, test, specs, device="cpu").run(3)
    loss_err = np.abs(card.losses - cpu.losses).max(1)
    acc_err = float(np.abs(card.accs - cpu.accs).max())
    for (tag, _), err in zip(rows.items(), loss_err):
        log(f"[5f card vs cpu] {tag}, 3 periods: losses max abs err "
            f"{err:.3g}")
    log(f"[5f card vs cpu] {len(specs)} rows: global batch "
        f"{card.global_batch[:, -1].tolist()}; accs max abs err "
        f"{acc_err:.3g}; ledgers "
        f"{'bitwise' if np.array_equal(card.times, cpu.times) else 'DIFFER'}")
    if not (np.array_equal(card.times, cpu.times)
            and np.array_equal(card.global_batch, cpu.global_batch)
            and np.allclose(card.losses, cpu.losses, rtol=1e-4, atol=1e-4)
            and acc_err <= 2.0 / len(test.y) + 1e-7):
        raise AssertionError("5f: card and CPU path disagree beyond ledgers "
                             "bitwise, losses 1e-4, accuracies two test "
                             "predictions")
    return {"rows": list(rows), "loss_max_abs_err": loss_err.tolist(),
            "acc_max_abs_err": acc_err}


def closed_loop_specs(env, api, **kw):
    """The main cell's rows (phase 4's: iid and noniid x seeds 0-7, or
    ``kw``'s) for the closed-loop phases."""
    kw = dict(dict(partitions=("iid", "noniid"), seeds=tuple(range(8))),
              **kw)
    return world_specs(env, {"static": {}}, **kw)


def gpu_fleet(DeviceProfile):
    """``benchmarks/fig_replan.py``'s GPU fleet: flat-then-affine
    latency, so the open loop's B* is interior."""
    return tuple(DeviceProfile(kind="gpu", gpu_t_low=0.02, gpu_slope=5e-4,
                               gpu_b_th=16 + 4 * i) for i in range(4))


def drive_closed(env, bucket, periods, chunk, device, on_chunk=None):
    """Run one bucket chunk by chunk through ``BucketRun`` on ``device``,
    plan → dispatch → collect; ``on_chunk(run, plan)`` sees each chunk
    after its collect.  Returns the run."""
    lowering = env.lowering
    run = lowering.BucketRun(bucket, env.data, periods, chunk,
                             lowering.DeviceData(env.data, env.test, device))
    while not run.done:
        plan = run.plan_next()
        run.dispatch(plan)
        run.collect()
        if on_chunk is not None:
            on_chunk(run, plan)
    return run


def closed_loop_cell(env, api, counted):
    """Phase 4h: the closed loop at full width, 20 periods, ``replan=5``.

    (i) The main cell (phase 4's 16 rows) through ``Experiment.run(
    PERIODS, replan=H_REPLAN)`` under ``SerialExecutor()``,
    ``AsyncExecutor()`` and ``SerialExecutor()`` again, after a 1-period
    warm-up: wall, planning split, peak memory and SBC launches (six
    leaves x PERIODS) of each; the schedulers planned (one a row) against
    the open loop's; the runs bitwise equal; then the open loop at
    ``chunk_periods=H_REPLAN``: whether ``global_batch`` equals it, and
    if so losses and accuracies bitwise and ``times`` within rtol 1e-12,
    else the chunk at which the decay cap first moved B*.
    (ii) ``benchmarks/fig_replan.py``'s GPU fleet on the main cell's data
    and model, noniid, seeds (0, 1), open and closed loop: B* per chunk,
    the decay caps at each boundary and ``fig_replan``'s calibration
    error over the second half.  (iii) The main cell, iid, seeds (0, 1),
    ``local_steps=1, adapt_tau=TauAdapt(H_TAUS)``: τ and wall per chunk,
    SBC launches.  (iv) The main cell, iid, seeds (0, 1), under
    ``Fading(**H_FADING)``, open loop against ``replan=H_REPLAN``: the
    simulated seconds at period PERIODS.  Returns the report and the
    closed-loop bucket of (i) for ``--profile``.  Raises AssertionError."""
    torch, np, lowering = env.torch, env.np, env.lowering
    Experiment, data, test = env.Experiment, env.data, env.test
    fields = ("losses", "accs", "times", "global_batch")
    want = {name: len(LEAF_LENGTHS) * PERIODS for name in counted}
    out = {}

    def reset():
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()

    def read(t0, timings=None):
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec = {"wall_s": wall, "ms_per_period": 1e3 * wall / PERIODS,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": {n: fn.launches for n, fn in counted.items()}}
        if timings is not None:
            rec["timings_s"] = dict(timings)
        return rec

    # (i) the main cell
    exp = Experiment(data, test, closed_loop_specs(env, api))
    (bucket,) = exp.lower(replan=H_REPLAN)
    n_closed = len(lowering._FeelPlanner(bucket, data,
                                         per_row=True).schedulers)
    n_open = len(lowering._FeelPlanner(exp.lower()[0], data).schedulers)
    t0 = time.perf_counter()
    exp.run(1, replan=H_REPLAN)                          # warm-up period
    torch.cuda.synchronize()
    log(f"[4h closed loop] main cell, {len(bucket.rows)} rows, replan="
        f"{H_REPLAN}: {n_closed} schedulers (one a row) against the open "
        f"loop's {n_open}; warm-up run of 1 period "
        f"{time.perf_counter() - t0:.2f} s")
    runs = {}
    for tag, executor in (("SerialExecutor()", env.SerialExecutor()),
                          ("AsyncExecutor()", api.AsyncExecutor()),
                          ("SerialExecutor() again", env.SerialExecutor()),
                          (f"open loop, SerialExecutor(chunk_periods="
                           f"{H_REPLAN})",
                           env.SerialExecutor(chunk_periods=H_REPLAN))):
        reset()
        t0 = time.perf_counter()
        res = exp.run(PERIODS, executor=executor,
                      replan=None if tag.startswith("open") else H_REPLAN)
        rec = read(t0, executor.timings)
        tm = rec["timings_s"]
        log(f"[4h closed loop] {tag}: {res.rows} rows x {PERIODS} periods "
            f"in {rec['wall_s']:.3f} s = {rec['ms_per_period']:.1f} "
            f"ms/period; host planning {1e3 * tm['plan'] / PERIODS:.1f} "
            f"ms/period, enqueue {1e3 * tm['dispatch'] / PERIODS:.1f}, "
            f"collect {1e3 * tm['collect'] / PERIODS:.2f}; peak device "
            f"memory {rec['peak_gib']:.2f} GiB; launches {rec['launches']} "
            f"(expected {want})")
        if rec["launches"] != want:
            raise AssertionError(f"4h: {tag}: kernel launches "
                                 f"{rec['launches']}, expected {want}")
        if not (np.isfinite(res.losses).all() and np.isfinite(res.accs).all()
                and np.isfinite(res.times).all()):
            raise AssertionError(f"4h: {tag}: non-finite series")
        runs[tag] = (res, rec)
    (serial, _), (asy, _), (again, _), (opened, _) = runs.values()
    pins = {"AsyncExecutor() == SerialExecutor()": all(
                np.array_equal(getattr(asy, f), getattr(serial, f))
                for f in fields),
            "SerialExecutor() again == the first": all(
                np.array_equal(getattr(again, f), getattr(serial, f))
                for f in fields)}
    same_b = bool(np.array_equal(serial.global_batch, opened.global_batch))
    moved = None
    if same_b:
        pins["losses, accuracies bitwise the open loop's"] = (
            np.array_equal(serial.losses, opened.losses)
            and np.array_equal(serial.accs, opened.accs))
        pins["times within rtol 1e-12 of the open loop's"] = bool(
            np.allclose(serial.times, opened.times, rtol=1e-12, atol=0))
    else:
        first = int(np.argwhere(serial.global_batch
                                != opened.global_batch)[:, 1].min())
        moved = first // H_REPLAN + 1
    starts = slice(0, PERIODS, H_REPLAN)
    log(f"[4h closed loop] global batch equal to the open loop's: "
        f"{'yes' if same_b else 'no'}"
        + ("" if same_b else f"; the decay cap first moved B* in chunk "
           f"{moved} of {PERIODS // H_REPLAN}")
        + f"; B* at each chunk start, mean over rows: closed "
        f"{serial.global_batch[:, starts].mean(0).tolist()}, open "
        f"{opened.global_batch[:, starts].mean(0).tolist()}; simulated "
        f"seconds at period {PERIODS}, mean: closed "
        f"{serial.times[:, -1].mean():.4f}, open "
        f"{opened.times[:, -1].mean():.4f}; final accuracy, mean: closed "
        f"{serial.final_acc.mean():.4f}, open {opened.final_acc.mean():.4f}")
    log("[4h closed loop] on the card, bitwise: " + "; ".join(
        f"{k}: {'yes' if v else 'NO'}" for k, v in pins.items()))
    if not all(pins.values()):
        raise AssertionError(f"4h: a pin fails: {pins}")
    out["main"] = {"rows": serial.rows, "schedulers": n_closed,
                   "open_loop_schedulers": n_open,
                   "runs": {tag: rec for tag, (_, rec) in runs.items()},
                   "global_batch_equal_open": same_b,
                   "cap_first_moved_b_in_chunk": moved, "pins": pins}

    # (ii) fig_replan's GPU fleet on the main cell's data and model
    gspec = env.ScenarioSpec(fleet=gpu_fleet(env.DeviceProfile),
                             name="gpu4", partition="noniid", b_max=128,
                             base_lr=0.05, seeds=F_SEEDS)
    g_open = Experiment(data, test, [gspec]).run(
        PERIODS, executor=env.SerialExecutor(chunk_periods=H_REPLAN))
    xi_at_plan, caps = [], []

    def note(run, plan):
        xi_at_plan.append([s.xi_est.xi for s in run._planner.schedulers])
        caps.append([s.xi_est.decay_cap for s in run._planner.schedulers])

    (gbucket,) = lowering.group_rows([gspec], replan=H_REPLAN)
    # the estimators before the first chunk: the prior, uncapped
    prior = lowering._FeelPlanner(gbucket, data, per_row=True)
    xi_at_plan.append([s.xi_est.xi for s in prior.schedulers])
    grun = drive_closed(env, gbucket, PERIODS, H_REPLAN, "cuda", note)
    _, _, _, g_gb = grun.result()
    realized = grun.realized_decays
    xi_series = np.concatenate([
        np.repeat(np.asarray(xi)[:, None], H_REPLAN, axis=1)
        for xi in xi_at_plan[:PERIODS // H_REPLAN]], axis=1)
    late = PERIODS // 2
    scale = float(np.mean(np.abs(realized[:, late:]))) + 1e-12

    def calibration(pred):
        return float(np.mean(np.abs(pred[:, late:] - realized[:, late:])))\
            / scale

    cal_open = calibration(xi_at_plan[0][0] * np.sqrt(g_gb))
    cal_closed = calibration(xi_series * np.sqrt(g_gb))
    b_open = g_open.global_batch[:, starts]
    b_closed = g_gb[:, starts]
    log(f"[4h fig_replan] GPU fleet ({len(gspec.fleet)} GPUs, b_th 16 + 4i), "
        f"noniid x seeds {F_SEEDS}, {PERIODS} periods: B* per chunk open "
        f"{b_open.tolist()}, closed {b_closed.tolist()}; decay cap at each "
        f"boundary {[[round(c, 6) for c in cc] for cc in caps[:-1]]}"
        f"; the cap moved B*: "
        f"{'yes' if not np.array_equal(b_open, b_closed) else 'no'}; "
        f"calibration |xi^ sqrt(B) - realized| / realized over the second "
        f"half: open {cal_open:.4f}, closed {cal_closed:.4f}; final "
        f"accuracy open {g_open.final_acc.tolist()}, closed "
        f"{grun.result()[1][:, -1].tolist()}")
    out["fig_replan"] = {"b_open": b_open.tolist(),
                         "b_closed": b_closed.tolist(),
                         "caps": caps[:-1], "cal_open": cal_open,
                         "cal_closed": cal_closed}

    # (iii) adaptive τ on the main cell
    (abucket,) = lowering.group_rows(closed_loop_specs(
        env, api, partitions=("iid",), seeds=F_SEEDS, local_steps=1,
        replan=H_REPLAN, adapt_tau=api.TauAdapt(H_TAUS)))
    taus, walls = [], []
    stamp = [0.0]

    def chunk_wall(run, plan):
        torch.cuda.synchronize()
        taus.append(plan.tau)
        walls.append(time.perf_counter() - stamp[0])
        stamp[0] = time.perf_counter()

    reset()
    t0 = stamp[0] = time.perf_counter()
    drive_closed(env, abucket, PERIODS, H_REPLAN, "cuda", chunk_wall)
    rec = read(t0)
    log(f"[4h adaptive tau] main cell, iid x seeds {F_SEEDS}, TauAdapt("
        f"{H_TAUS}) from local_steps=1: tau per chunk {taus}; wall per "
        f"chunk {[round(w, 3) for w in walls]} s ({rec['ms_per_period']:.1f}"
        f" ms/period); launches {rec['launches']} (expected {want})")
    if rec["launches"] != want:
        raise AssertionError(f"4h: adaptive tau: kernel launches "
                             f"{rec['launches']}, expected {want}")
    out["adaptive_tau"] = dict(rec, taus=taus, chunk_wall_s=walls)

    # (iv) drift: open loop against the closed loop
    dexp = Experiment(data, test, closed_loop_specs(
        env, api, partitions=("iid",), seeds=F_SEEDS,
        fading=api.Fading(**H_FADING)))
    d_open = dexp.run(PERIODS)
    d_closed = dexp.run(PERIODS, replan=H_REPLAN)
    log(f"[4h drift] Fading({H_FADING}), iid x seeds {F_SEEDS}: simulated "
        f"seconds at period {PERIODS} open loop "
        f"{d_open.times[:, -1].tolist()}, replan={H_REPLAN} "
        f"{d_closed.times[:, -1].tolist()}; final accuracy open "
        f"{d_open.final_acc.tolist()}, closed {d_closed.final_acc.tolist()}")
    out["drift"] = {"open_s": d_open.times[:, -1].tolist(),
                    "closed_s": d_closed.times[:, -1].tolist()}
    return out, bucket


def closed_loop_contracts(env, api, counted_attn):
    """Phase 5g: 4 periods at ``replan=2`` on the card and on the port's
    CPU path, one row each of 4h's main cell (iid, seed 0), its GPU fleet
    (noniid, seed 0), its adaptive-τ row (iid, seed 0) and a transformer
    row (phase 5e's: feel-transformer-h256-d3, slot 16), each bucket
    driven chunk by chunk through ``BucketRun``: ``global_batch`` and the
    τ sequence equal, ``times`` within rtol 1e-9, losses 1e-4, accuracies
    two test predictions; the attention kernels' launches counted around
    the card run.  Raises AssertionError."""
    np, lowering = env.np, env.lowering
    main = dict(partitions=("iid",), seeds=(0,))
    specs = (closed_loop_specs(env, api, **main)
             + [env.ScenarioSpec(fleet=gpu_fleet(env.DeviceProfile),
                                 name="gpu4", partition="noniid", b_max=128,
                                 base_lr=0.05, seeds=(0,))]
             + closed_loop_specs(env, api, local_steps=1, replan=2,
                                 adapt_tau=api.TauAdapt(H_TAUS), **main)
             + closed_loop_specs(env, api, b_max=16,
                                 model_family="transformer", **main))
    buckets = lowering.group_rows(specs, replan=2)

    def drive(device):
        out = []
        for b in buckets:
            taus = []
            run = drive_closed(env, b, 4, 2, device,
                               lambda run, plan: taus.append(plan.tau))
            out.append((run, taus))
        return out

    for fn in counted_attn.values():
        fn.launches = 0
    card = drive("cuda")
    launches = {name: fn.launches for name, fn in counted_attn.items()}
    cpu = drive("cpu")
    out = {"launches": launches, "buckets": []}
    for b, (crun, ctaus), (prun, ptaus) in zip(buckets, card, cpu):
        cl, ca, ct, cg = crun.result()
        pl, pa, pt, pg = prun.result()
        labels = [r.spec.label + (f" {r.spec.model_family}"
                                  if r.spec.model_family != "feel_mlp"
                                  else "")
                  + ("" if r.spec.adapt_tau is None
                     else f" {r.spec.adapt_tau}") for r in b.rows]
        loss_err = float(np.abs(cl - pl).max())
        acc_err = float(np.abs(ca - pa).max())
        gap = float(np.abs(ct / pt - 1).max())
        log(f"[5g card vs cpu] {labels}, replan=2, 4 periods: global batch "
            f"{cg.tolist()}; tau {ctaus} (CPU {ptaus}); times rel gap "
            f"{gap:.3g}; losses max abs err {loss_err:.3g}; accs max abs "
            f"err {acc_err:.3g}")
        if not (np.array_equal(cg, pg) and ctaus == ptaus):
            scores = [[(s.xi_est.xi, s.xi_est.decay_cap, s._last_lat,
                        s._last_comp) for s in run._planner.schedulers]
                      for run in (crun, prun)]
            raise AssertionError(
                f"5g: {labels}: decisions differ, global batch {cg.tolist()}"
                f" vs {pg.tolist()}, tau {ctaus} vs {ptaus}; (xi, cap, "
                f"latency, compute) card {scores[0]}, CPU {scores[1]}")
        if not (np.allclose(ct, pt, rtol=1e-9, atol=0)
                and np.allclose(cl, pl, rtol=1e-4, atol=1e-4)
                and acc_err <= 2.0 / len(env.test.y) + 1e-7):
            raise AssertionError(f"5g: {labels}: card and CPU path disagree "
                                 "beyond times rtol 1e-9, losses 1e-4, "
                                 "accuracies two test predictions")
        out["buckets"].append({"rows": labels, "taus": ctaus,
                               "times_rel_gap": gap,
                               "loss_max_abs_err": loss_err,
                               "acc_max_abs_err": acc_err})
    log(f"[5g card vs cpu] launches on the card {launches}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"5g: a kernel was not launched: {launches}")
    return out


# the service cell (phase 4i): benchmarks/serve_load.py's traffic at the
# main cell's width — two hot templates (noniid seeds (0, 1), iid seeds
# (2, 3)) of 6 periods, 12 Poisson arrivals at 6/s (seed 7) on a virtual
# clock advanced by each step's measured wall, after an untimed warm-up; a
# 24-period priority-5 background request, then one transformer and one
# mamba2 request (family defaults, 2 seeds, 4 periods), also priority 5:
# the background starts first, and the hot arrivals preempt it
I_RATE, I_ARRIVALS, I_SEED = 6.0, 12, 7
I_HOT, I_LONG, I_FAMILY = 6, 24, 4
I_CHUNK, I_WINDOW, I_MAX_BATCH = 2, 0.02, 2
# the launches a dispatched period: B1/B2 once a leaf, B4 4 forwards x 3
# layers, B4' / B4'' and B3' one backward x 3 layers
I_FEEL_SBC = len(LEAF_LENGTHS)
I_FAMILY_LAUNCHES = {"transformer": T_LAUNCHES, "mamba2": M_LAUNCHES}
# phase 5h: a fixed-step tape through the service on the card and on the
# CPU path, at slot widths no other phase runs (so both devices' programs
# start cold alike): three feel-mlp arrivals of one seed (2 periods, chunk
# 1) and one transformer ticket
H5_FEEL_BMAX, H5_T_BMAX, H5_STEP = 112, 24, 0.05


def _service_specs(env, **kw):
    base = dict(fleet=fleet(env.DeviceProfile, DEVICES), name="K12",
                b_max=128, base_lr=0.05)
    return env.ScenarioSpec(**dict(base, **kw))


def _watch_admissions(svc):
    """The tickets of each admission group, in admission order (read off
    the scheduler's ``add``)."""
    groups, add = [], svc._scheduler.add

    def record(srun):
        groups.append([r.ticket for r in srun.requests])
        add(srun)
    svc._scheduler.add = record
    return groups


def service_cell(env, counted, device=None):
    """Phase 4i: ``repro_torch.serve.ExperimentService`` at the main
    cell's full width under serve_load's traffic (the constants above),
    with the kernels' launch counts set to 0 after the warm-up and read
    after the drain, held against 6 B1/B2 a dispatched feel-mlp period
    and the families' formulas.  Then every ticket is held bitwise
    against its admission group's ``Experiment`` twin (chunked as the
    service chunks) and against its solo twin (ledgers bitwise, losses
    1e-4; the gap printed).  Raises AssertionError."""
    from repro_torch.serve import ExperimentService, ProgramCache
    from repro_torch.testing import (VirtualClock, assign_templates,
                                     poisson_arrivals)
    torch, np = env.torch, env.np
    hot = [_service_specs(env, partition="noniid", seeds=(0, 1)),
           _service_specs(env, partition="iid", seeds=(2, 3))]
    clock = VirtualClock()
    svc = ExperimentService(env.data, env.test, device=device,
                            chunk_periods=I_CHUNK, window=I_WINDOW,
                            max_batch=I_MAX_BATCH, clock=clock,
                            cache=ProgramCache(shared=False))
    # untimed warm-up: the single-request (2-row) and paired (4-row) hot
    # shapes, as serve_load warms them
    t0 = time.perf_counter()
    svc.submit(hot[0], periods=I_HOT)
    svc.drain()
    svc.submit(hot[0], periods=I_HOT)
    svc.submit(hot[1], periods=I_HOT)
    svc.drain()
    t_warm = time.perf_counter() - t0
    stats = svc.reset_stats()
    groups = _watch_admissions(svc)
    for fn in counted.values():
        fn.launches = 0
    if device is None:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tickets = [svc.submit(_service_specs(env, partition="iid", seeds=(4,)),
                          periods=I_LONG, priority=5)]
    tickets += [svc.submit(_service_specs(env, seeds=(0, 1),
                                          model_family=family),
                           periods=I_FAMILY, priority=5)
                for family in I_FAMILY_LAUNCHES]
    tape = assign_templates(poisson_arrivals(I_RATE, I_ARRIVALS,
                                             seed=I_SEED, start=0.05), hot)
    i = 0
    while True:
        while i < len(tape) and clock.now() >= tape[i][0]:
            tickets.append(svc.submit(tape[i][1], periods=I_HOT))
            i += 1
        t1 = time.perf_counter()
        if svc.step():
            clock.advance(time.perf_counter() - t1)
        elif i < len(tape):
            clock.advance_to(tape[i][0])    # idle until the next arrival
        else:
            break
    svc.drain()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    peak = (torch.cuda.max_memory_allocated() / 2**30 if device is None
            else float("nan"))
    s = stats.to_dict()
    feel_periods = I_HOT * (s["admissions"] - 3) + I_LONG
    full = {name: I_FEEL_SBC * feel_periods
            for name in ("sbc_stats", "sbc_apply")}
    for per in I_FAMILY_LAUNCHES.values():
        for name, n in per.items():
            full[name] = full.get(name, 0) + n * I_FAMILY
    want = {name: full.get(name, 0) for name in counted}
    lat, first = s["latency"], s["first_result_latency"]
    log(f"[4i service] {len(tickets)} tickets ({I_ARRIVALS} hot arrivals at "
        f"{I_RATE:g}/s, seed {I_SEED}; a {I_LONG}-period background; a "
        f"transformer and a mamba2 request) in {wall:.3f} s (warm-up "
        f"{t_warm:.2f} s): {s['admissions']} admissions, {s['chunks']} "
        f"chunks, {s['preemptions']} preemptions, {s['resumes']} resumes; "
        f"result latency p50 {lat['p50']:.4f} s, p90 {lat['p90']:.4f} s, "
        f"p99 {lat['p99']:.4f} s; first result p50 {first['p50']:.4f} s; "
        f"program-cache hit rate {s['cache_hit_rate']:.3f} "
        f"({s['cache_hits']} / {s['cache_hits'] + s['cache_misses']}); "
        f"{s['new_traces']} ledger events, {s['warm_admission_traces']} in "
        f"warm admissions; peak device memory {peak:.2f} GiB")
    log(f"[4i service] launches during the run: {launches} (expected "
        f"{want}: {I_FEEL_SBC} B1/B2 a feel-mlp period x {feel_periods} "
        f"dispatched, the families' formulas x {I_FAMILY} periods each)")
    if not all(t.done for t in tickets):
        raise AssertionError("4i: the service left unfinished tickets")
    if not (s["cache_hit_rate"] >= 0.5 and s["preemptions"] >= 1
            and s["warm_admission_traces"] == 0):
        raise AssertionError(f"4i: hit rate {s['cache_hit_rate']:.3f} "
                             f"(>= 0.5), preemptions {s['preemptions']} "
                             f"(>= 1), warm-admission events "
                             f"{s['warm_admission_traces']} (0)")
    if device is None and launches != want:
        raise AssertionError(f"4i: kernel launches {launches}, expected "
                             f"{want}")
    # each ticket against its admission group's Experiment twin (bitwise)
    # and its solo twin (ledgers bitwise, losses 1e-4)
    fields = ("losses", "accs", "times", "global_batch")
    twins, solos, gap = {}, {}, 0.0
    for group in groups:
        specs = tuple(t.spec for t in group)
        key = (specs, group[0].periods)
        if key not in twins:
            twins[key] = env.Experiment(env.data, env.test, list(specs),
                                        device=device).run(
                group[0].periods,
                executor=env.SerialExecutor(chunk_periods=I_CHUNK))
        offset = 0
        for t in group:
            got = t.result()
            rows = [offset + j for j in range(t.n_rows)]
            offset += t.n_rows
            if not all(np.array_equal(getattr(got, f),
                                      getattr(twins[key], f)[rows])
                       for f in fields):
                raise AssertionError(f"4i: ticket {t.record.ticket_id} "
                                     f"({t.spec.label}) is not bitwise its "
                                     "admission group's Experiment twin")
            skey = (t.spec, t.periods)
            if skey not in solos:
                solos[skey] = env.Experiment(env.data, env.test, [t.spec],
                                             device=device).run(t.periods)
            solo = solos[skey]
            if not (np.array_equal(got.times, solo.times)
                    and np.array_equal(got.global_batch, solo.global_batch)
                    and np.allclose(got.losses, solo.losses, rtol=1e-4,
                                    atol=1e-4)):
                raise AssertionError(f"4i: ticket {t.record.ticket_id} and "
                                     "its solo twin disagree beyond ledgers "
                                     "bitwise, losses 1e-4")
            gap = max(gap, float(np.abs(got.losses - solo.losses).max()))
    log(f"[4i service] every ticket bitwise its admission group's Experiment"
        f" twin ({len(twins)} twins for {len(groups)} admissions); against "
        f"its solo twin ({len(solos)}): ledgers bitwise, losses max abs gap "
        f"{gap:.3g} (tol 1e-4)")
    return {"stats": s, "wall_s": wall, "warmup_s": t_warm,
            "peak_gib": peak, "launches": launches, "expected": want,
            "feel_periods": feel_periods, "solo_loss_gap": gap,
            "admissions": len(groups), "group_twins": len(twins)}


def trainer_cell(env, counted, device=None):
    """Phase 4j: ``repro_torch.fed.trainer.FeelSimulation`` at the main
    cell's width (noniid, seed 0), ``engine="scan"`` against
    ``engine="python"`` (one period a Python iteration, a host sync a
    step) over ``PERIODS`` periods: times bitwise, losses and accuracies
    within 1e-5 or the gap stated (a fault past 1e-3); then
    ``run_seed_batch`` of seeds 0-3 (iid) bitwise the ``Experiment``
    bucket of the same rows.  Launches counted around each run (6 B1/B2 a
    period).  Raises AssertionError."""
    from repro_torch.fed.sweep import run_seed_batch
    from repro_torch.fed.trainer import FeelSimulation
    torch, np = env.torch, env.np
    devices = list(fleet(env.DeviceProfile, DEVICES))

    def sim(engine, seed=0, partition="noniid"):
        return FeelSimulation(devices, env.data, env.test,
                              partition=partition, b_max=128, base_lr=0.05,
                              seed=seed, engine=engine, device=device)

    def timed(fn):
        for kern in counted.values():
            kern.launches = 0
        t0 = time.perf_counter()
        out = fn()
        if device is None:
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {
            name: kern.launches for name, kern in counted.items()}

    want = {name: I_FEEL_SBC * PERIODS for name in counted}
    runs = {}
    for engine in ("scan", "python"):
        s = sim(engine)
        runs[engine] = timed(lambda s=s: s.run(PERIODS, eval_every=1))
    (rs, ws, ls), (rp, wp, lp) = runs["scan"], runs["python"]
    loss_gap = float(np.abs(np.subtract(rs.losses, rp.losses)).max())
    acc_gap = float(np.abs(np.subtract(rs.accs, rp.accs)).max())
    within = (np.allclose(rs.losses, rp.losses, rtol=1e-5, atol=1e-5)
              and np.allclose(rs.accs, rp.accs, rtol=1e-5, atol=1e-5))
    log(f"[4j trainer] FeelSimulation {DEVICES} devices x {PERIODS} periods:"
        f" scan {ws:.3f} s = {1e3 * ws / PERIODS:.1f} ms/period, python "
        f"{wp:.3f} s = {1e3 * wp / PERIODS:.1f} ms/period "
        f"({wp / ws:.2f}x); times {'bitwise' if rs.times == rp.times else 'DIFFER'};"
        f" losses max abs gap {loss_gap:.3g}, accs {acc_gap:.3g} "
        f"({'within' if within else 'beyond'} 1e-5); launches scan {ls}, "
        f"python {lp} (expected {want} each)")
    if rs.times != rp.times or rs.global_batches != rp.global_batches:
        raise AssertionError("4j: scan and python ledgers differ")
    if not (np.allclose(rs.losses, rp.losses, rtol=1e-3, atol=1e-3)
            and np.isfinite(rs.losses).all()):
        raise AssertionError(f"4j: scan and python losses {loss_gap:.3g} "
                             "apart, past 1e-3")
    sims = [sim("scan", seed=s, partition="iid") for s in range(4)]
    (bl, ba, bt, bg), wb, lb = timed(lambda: run_seed_batch(sims, PERIODS))
    spec = _service_specs(env, partition="iid", seeds=tuple(range(4)))
    twin, we, le = timed(lambda: env.Experiment(
        env.data, env.test, [spec], device=device).run(PERIODS))
    bitwise = all(np.array_equal(a, b) for a, b in (
        (bl, twin.losses), (ba, twin.accs), (bt, twin.times),
        (bg, twin.global_batch)))
    log(f"[4j trainer] run_seed_batch of 4 seeds x {PERIODS} periods "
        f"{wb:.3f} s = {1e3 * wb / PERIODS:.1f} ms/period (the Experiment "
        f"bucket {1e3 * we / PERIODS:.1f}); "
        f"{'bitwise' if bitwise else 'NOT bitwise'} the Experiment bucket; "
        f"launches {lb}")
    if not bitwise:
        raise AssertionError("4j: run_seed_batch is not bitwise its "
                             "Experiment bucket")
    if device is None and not (ls == lp == lb == want):
        raise AssertionError(f"4j: launches scan {ls}, python {lp}, seed "
                             f"batch {lb}, expected {want} each")
    return {"scan_ms_per_period": 1e3 * ws / PERIODS,
            "python_ms_per_period": 1e3 * wp / PERIODS,
            "seed_batch_ms_per_period": 1e3 * wb / PERIODS,
            "experiment_ms_per_period": 1e3 * we / PERIODS,
            "loss_gap": loss_gap, "acc_gap": acc_gap,
            "within_1e-5": bool(within),
            "launches": {"scan": ls, "python": lp, "seed_batch": lb}}


def service_contracts(env, counted, devices=(None, "cpu")):
    """Phase 5h: one fixed-step tape (``H5_STEP`` s of virtual clock a
    service step) through the service on the card and on the port's CPU
    path: a transformer ticket (seed 0, 2 periods) at 0 s, then feel-mlp
    tickets of one seed (2 periods) at 0.02, 0.04 and 0.2 s; chunk 1,
    window 0.05, ``max_batch`` 2.  ``stats.to_dict()`` equal, each
    ticket's ledgers bitwise, losses 1e-4, accuracies two test
    predictions; launches counted around the card run.  Raises
    AssertionError."""
    from repro_torch.serve import ExperimentService, ProgramCache
    from repro_torch.testing import VirtualClock
    np = env.np
    tape = [(0.0, _service_specs(env, b_max=H5_T_BMAX, seeds=(0,),
                                 model_family="transformer"))]
    tape += [(t, _service_specs(env, b_max=H5_FEEL_BMAX, partition=p,
                                seeds=(seed,)))
             for t, p, seed in ((0.02, "iid", 0), (0.04, "noniid", 1),
                                (0.2, "iid", 0))]
    out, launches = [], None
    for device in devices:
        if device is None:
            for fn in counted.values():
                fn.launches = 0
        clock = VirtualClock()
        svc = ExperimentService(env.data, env.test, device=device,
                                chunk_periods=1, window=0.05, max_batch=2,
                                clock=clock, cache=ProgramCache(shared=False))
        tickets, pending = [], list(tape)
        while pending or not svc.idle:
            clock.advance(H5_STEP)
            while pending and pending[0][0] <= clock.now():
                tickets.append(svc.submit(pending.pop(0)[1], periods=2))
            svc.step()
        if device is None:
            launches = {name: fn.launches for name, fn in counted.items()}
        out.append((svc.stats.to_dict(), [t.result() for t in tickets]))
    (card_stats, card), (cpu_stats, cpu) = out
    loss_err = max(float(np.abs(a.losses - b.losses).max())
                   for a, b in zip(card, cpu))
    acc_err = max(float(np.abs(a.accs - b.accs).max())
                  for a, b in zip(card, cpu))
    log(f"[5h card vs cpu] service tape ({len(tape)} tickets, a transformer "
        f"one among them): stats {'equal' if card_stats == cpu_stats else 'DIFFER'}"
        f" ({card_stats['admissions']} admissions, {card_stats['chunks']} "
        f"chunks, {card_stats['new_traces']} ledger events); losses max abs "
        f"err {loss_err:.3g}, accs {acc_err:.3g}; launches on the card "
        f"{launches}")
    if card_stats != cpu_stats:
        raise AssertionError(f"5h: service stats differ: card {card_stats}, "
                             f"CPU {cpu_stats}")
    for a, b in zip(card, cpu):
        if not (np.array_equal(a.times, b.times)
                and np.array_equal(a.global_batch, b.global_batch)
                and np.allclose(a.losses, b.losses, rtol=1e-4, atol=1e-4)):
            raise AssertionError("5h: a ticket's card and CPU results "
                                 "disagree beyond ledgers bitwise, losses "
                                 "1e-4")
    if acc_err > 2.0 / len(env.test.y) + 1e-7:
        raise AssertionError(f"5h: accuracies {acc_err:.3g} apart")
    if launches is not None and not all(n > 0 for n in launches.values()):
        raise AssertionError(f"5h: a kernel was not launched: {launches}")
    return {"stats": card_stats, "loss_max_abs_err": loss_err,
            "acc_max_abs_err": acc_err, "launches": launches}


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
        from repro_torch import api
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
        from repro_torch.fed import engine
        from repro_torch.tree import tree_leaves, tree_map
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
        f"{attn_errs['flash_attention_bwd_dq']:.3g} (D too), dk/dv "
        f"{attn_errs['flash_attention_bwd_dkdv']:.3g} vs the plain backward, "
        f"{attn_errs['bwd_vs_autograd']:.3g} vs autograd of the oracle "
        f"(tol 1e-4); every forward run twice bitwise equal; sequences 0 "
        f"and {T_SHAPE[0] // 2} alone bitwise the same rows of the whole "
        f"batch (forward, dQ with D, dK/dV); backward run twice bitwise "
        f"equal")
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
        f"backward's seams {SSD_BWD_SEAMS} + the forward's seams "
        f"{SSD_FWD_SEAMS} and N 128 {SSD_FWD_N128} (forward only) (copies, B "
        f"per copy, S, H, P, G, N, chunk): fwd "
        f"max abs err {ssd_errs['ssd_scan_fwd']:.3g} vs the plain version, "
        f"{ssd_errs['fwd_vs_f64']:.3g} vs it in float64 (tol 2e-5; the "
        f"float32 plain version {ssd_errs['plain_fwd_vs_f64']:.3g}), bf16 "
        f"fwd {ssd_errs['bf16_fwd']:.3g} (tol 2e-2); bwd "
        f"{ssd_errs['ssd_scan_bwd']:.3g} vs the plain version, "
        f"{ssd_errs['bwd_vs_f64']:.3g} vs it in float64 (tol 1e-4; the "
        f"float32 plain version {ssd_errs['plain_bwd_vs_f64']:.3g}); "
        f"{ssd_errs['left_out']} elements where the float32 plain version "
        f"is itself beyond half the tolerance of float64; forward (f32, "
        f"bf16) run twice bitwise equal at {M_SHAPE[0]} sequences, and "
        f"sequences 0, 5000 and {M_SHAPE[0] - 1} alone bitwise the same rows "
        f"among them; backward run twice bitwise equal, and a copy alone "
        f"bitwise the same copy among 8")
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
              DeviceProfile, lowering, data, test, engine, tree_leaves)
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

    # ---- 4e. the grid through the executors at full width -----------------
    try:
        report["grid"] = grid_cell(env, api, {"sbc_stats": ksbc.sbc_stats,
                                              "sbc_apply": ksbc.sbc_apply})
    except AssertionError as exc:
        return fail(f"phase {exc}")
    g_launches = report["grid"]["executors"][G_SERIAL]["launches"]

    # ---- 4f. the main cell in the dynamic worlds ---------------------------
    try:
        report["dynamics"] = dynamics_cell(
            env, api, {"sbc_stats": ksbc.sbc_stats,
                       "sbc_apply": ksbc.sbc_apply})
    except AssertionError as exc:
        return fail(f"phase {exc}")
    f_launches = {tag: report["dynamics"][tag]["launches"]
                  for tag in ("bucket 1", "bucket 2")}

    # ---- 4g. the Table-II schemes, τ local steps, the hierarchy -----------
    try:
        report["schemes"], schemes_buckets = schemes_cell(
            env, api, {"sbc_stats": ksbc.sbc_stats,
                       "sbc_apply": ksbc.sbc_apply})
    except AssertionError as exc:
        return fail(f"phase {exc}")

    # ---- 4h. the closed loop and adaptive local steps ---------------------
    try:
        report["closed_loop"], closed_bucket = closed_loop_cell(
            env, api, {"sbc_stats": ksbc.sbc_stats,
                       "sbc_apply": ksbc.sbc_apply})
    except AssertionError as exc:
        return fail(f"phase {exc}")
    h_launches = report["closed_loop"]["main"]["runs"][G_SERIAL]["launches"]

    # ---- 4i. the experiment service at full width -------------------------
    all_kernels = {"sbc_stats": ksbc.sbc_stats, "sbc_apply": ksbc.sbc_apply,
                   "flash_attention_fwd": kfa.flash_attention_fwd,
                   "flash_attention_bwd_dq": kfa.flash_attention_bwd_dq,
                   "flash_attention_bwd_dkdv": kfa.flash_attention_bwd_dkdv,
                   "ssd_scan_fwd": kssd.ssd_scan_fwd,
                   "ssd_scan_bwd": kssd.ssd_scan_bwd}
    try:
        report["service"] = service_cell(env, all_kernels)
    except AssertionError as exc:
        return fail(f"phase {exc}")
    i_launches = report["service"]["launches"]

    # ---- 4j. FeelSimulation: scan vs python, run_seed_batch ----------------
    try:
        report["trainer"] = trainer_cell(env, {"sbc_stats": ksbc.sbc_stats,
                                               "sbc_apply": ksbc.sbc_apply})
    except AssertionError as exc:
        return fail(f"phase {exc}")
    j_launches = report["trainer"]["launches"]

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
    try:
        report["card_vs_cpu_policies"] = policy_contracts(env, api)
    except AssertionError as exc:
        return fail(f"phase {exc}")

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

    # ---- 5e. the dynamic worlds: card vs CPU --------------------------------
    try:
        report["dynamics_contracts"] = dynamics_contracts(
            env, api, {"flash_attention_fwd": kfa.flash_attention_fwd,
                       "flash_attention_bwd_dq": kfa.flash_attention_bwd_dq,
                       "flash_attention_bwd_dkdv":
                           kfa.flash_attention_bwd_dkdv})
    except AssertionError as exc:
        return fail(f"phase {exc}")
    e_launches = report["dynamics_contracts"]["transformer"]["launches"]

    # ---- 5f. the schemes, τ and the hierarchy: card vs CPU ----------------
    try:
        report["schemes_contracts"] = schemes_contracts(env, api)
    except AssertionError as exc:
        return fail(f"phase {exc}")

    # ---- 5g. the closed loop: card vs CPU ----------------------------------
    try:
        report["closed_loop_contracts"] = closed_loop_contracts(
            env, api, {"flash_attention_fwd": kfa.flash_attention_fwd,
                       "flash_attention_bwd_dq": kfa.flash_attention_bwd_dq,
                       "flash_attention_bwd_dkdv":
                           kfa.flash_attention_bwd_dkdv,
                       "sbc_stats": ksbc.sbc_stats,
                       "sbc_apply": ksbc.sbc_apply})
    except AssertionError as exc:
        return fail(f"phase {exc}")
    g5_launches = report["closed_loop_contracts"]["launches"]

    # ---- 5h. the service: card vs CPU ---------------------------------------
    try:
        report["service_contracts"] = service_contracts(
            env, {name: all_kernels[name] for name in (
                "sbc_stats", "sbc_apply", "flash_attention_fwd",
                "flash_attention_bwd_dq", "flash_attention_bwd_dkdv")})
    except AssertionError as exc:
        return fail(f"phase {exc}")
    h5_launches = report["service_contracts"]["launches"]

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
                                 "mamba2": m_launches[name],
                                 "feel_mlp grid, each executor":
                                     g_launches[name],
                                 "feel_mlp dynamics, bucket 1":
                                     f_launches["bucket 1"][name],
                                 "feel_mlp dynamics, bucket 2":
                                     f_launches["bucket 2"][name],
                                 "feel_mlp closed loop, each executor":
                                     h_launches[name],
                                 "closed-loop rows on the card, 4 periods":
                                     g5_launches[name],
                                 "service, 4i": i_launches[name],
                                 **{f"FeelSimulation {run}, 4j": n[name]
                                    for run, n in j_launches.items()},
                                 "service card vs CPU, 5h":
                                     h5_launches[name]},
            "max_abs_err": errs[name],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": None})
        log(f"[6 times] {name}: one period's six leaves: kernel "
            f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, bound "
            f"{records[-1]['bound_ms']:.4f} ms ({records[-1]['bound_by']}); "
            f"library_ms none (no single PyTorch call computes it)")
    # the forward's six instances, the dQ and dK/dV kernels' three each
    attn_res = {
        "flash_attention_fwd": (
            "fwd_kernel",
            {f"{str(dt).split('.')[-1]}_hd{hd}": kfa.fwd_resources(hd, dt)
             for hd in (32, 64, 128)
             for dt in (torch.float32, torch.bfloat16)}),
        "flash_attention_bwd_dq": (
            "dq_kernel",
            {f"float32_hd{hd}": kfa.dq_resources(hd)
             for hd in (32, 64, 128)}),
        "flash_attention_bwd_dkdv": (
            "dkdv_kernel",
            {f"float32_hd{hd}": kfa.dkdv_resources(hd)
             for hd in (32, 64, 128)})}
    for kernel, recs in attn_res.values():
        for key, r in recs.items():
            log(f"[6 resources] {kernel} {key}: {r['registers']} registers "
                f"and {r['local_bytes']} bytes of local memory (spills) a "
                f"thread; {r['static_smem_bytes'] + r['dynamic_smem_bytes']} "
                f"bytes of shared memory and {r['threads']} threads a CTA; "
                f"{r['ctas_per_sm']} CTAs resident an SM (the persistent "
                f"grid)")
        if any(r["local_bytes"] or r["static_smem_bytes"]
               for r in recs.values()):
            return fail(f"phase 6: an attention {kernel} instance spills or "
                        f"has static shared memory")
    for name, t in attention_times(torch, kfa, F).items():
        records.append({
            "name": name, "route": "cuda", "source": ATTN_SOURCE,
            "replaces": ("src/repro/kernels/flash_attention.py:24"
                         if name == "flash_attention_fwd"
                         else "none: backward of B4, C-ref-3"),
            "launches": t_launches[name],
            "launches_by_path": {"transformer": t_launches[name],
                                 "transformer weighted-sampled, 3 periods":
                                     e_launches[name],
                                 "transformer closed loop, 4 periods":
                                     g5_launches[name],
                                 "service, 4i": i_launches[name],
                                 "service card vs CPU, 5h":
                                     h5_launches[name]},
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        if name in attn_res:
            records[-1]["device_ms"] = t["device_ms"]
            records[-1]["resources"] = attn_res[name][1]
            log(f"[6 times] {name} at {T_SHAPE}: {t['device_ms']:.4f} ms on "
                f"the card (profiler)")
        if "library_bwd_ms" in t:
            records[-1]["library_bwd_ms"] = t["library_bwd_ms"]
        log(f"[6 times] {name} at {T_SHAPE} (B, S, Hq, Hkv, hd), causal: "
            f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']} bytes, "
            f"{t['ops']} f32 ops); scaled_dot_product_attention "
            + ("forward" if name == "flash_attention_fwd"
               else "forward + backward")
            + f" {t['library_ms']:.4f} ms"
            + (f", its backward alone {t['library_bwd_ms']:.4f} ms"
               if "library_bwd_ms" in t else ""))
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
    # the forward's instances: each (H, P, G, N) of the list in f32 and
    # bf16, without a state (S <= 16) and with one
    fwd_ssd_res = {"H{}_P{}_G{}_N{}".format(*shape): kssd.fwd_resources(
        *shape) for shape in SSD_FWD_RESOURCE_SHAPES}
    for shape, recs in fwd_ssd_res.items():
        for key, r in recs.items():
            log(f"[6 resources] ssd_fwd_kernel {shape} {key}: "
                f"{r['registers']} registers and {r['local_bytes']} bytes of "
                f"local memory (spills) a thread; "
                f"{r['static_smem_bytes'] + r['dynamic_smem_bytes']} bytes of "
                f"shared memory and {r['threads']} threads a CTA; "
                f"{r['ctas_per_sm']} CTAs resident an SM (the persistent "
                f"grid)")
    report["ssd_fwd_resources"] = fwd_ssd_res
    if any(r["local_bytes"] for recs in fwd_ssd_res.values()
           for r in recs.values()):
        return fail("phase 6: an SSD forward instance spills")
    for name, t in ssd_times(torch, kssd).items():
        records.append({
            "name": name, "route": "cuda", "source": SSD_SOURCE,
            "replaces": ("src/repro/kernels/ssd_scan.py:35"
                         if name == "ssd_scan_fwd"
                         else "none: backward of B3, C-ref-3"),
            "launches": m_launches[name],
            "launches_by_path": {"mamba2": m_launches[name],
                                 "service, 4i": i_launches[name]},
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
        if name == "ssd_scan_bwd":
            records[-1]["resources"] = res
        else:
            records[-1]["resources"] = fwd_ssd_res
            records[-1]["device_ms"] = t["device_ms"]
            log(f"[6 times] ssd_scan_fwd at {M_SHAPE}: {t['device_ms']:.4f} "
                f"ms on the card (profiler)")
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
        # each path; the closed loop's two periods (one chunk) with its
        # planning and feedback, as it runs them
        from torch.profiler import ProfilerActivity, profile
        for path, pbucket, form in (
                ("feel_mlp", bucket, "features"),
                ("transformer", cells["transformer"]["bucket"], "tokens"),
                ("mamba2", cells["mamba2"]["bucket"], "tokens"),
                *((f"4g {tag}", b, "features")
                  for tag, b in schemes_buckets.items()),
                ("4h closed loop, planning and feedback included",
                 closed_bucket, None)):
            if form is None:
                def work(b=pbucket):
                    drive_closed(env, b, 2, H_REPLAN, "cuda")
            else:
                plan = lowering.plan_bucket(pbucket, data, 2)
                arrays = lowering.DeviceData(data, test, "cuda")
                getattr(arrays, form)

                def work(plan=plan, arrays=arrays):
                    lowering.collect_bucket(lowering.dispatch_bucket(
                        plan, arrays))
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                work()
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
