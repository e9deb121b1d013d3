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
12.25 B parameters in float32), mamba2-2.7b, qwen1.5-4b,
llava-next-mistral-7b, musicgen-large (4 codebooks), minicpm3-4b (MLA,
62 layers) and deepseek-v2-lite-16b (MLA and 64 experts top-6, 15.71 B
parameters), and with their depth cut granite-34b (from 88 to 20
layers; the GELU MLP, 48 query heads over one KV head), arctic-480b
(from 35 to 1 layer; 128 experts top-2 beside a dense FFN, 56 query
heads over 8 KV heads) and zamba2-7b (from 81 to 27 SSM layers, each 9
followed by a shared block of 32 heads of 112),
llava-next-mistral-7b's prefill with a 2880-patch prefix, and the
training driver ``repro_torch.launch.train.main`` at qwen1.5-4b's full
width and depth (40 layers, d_model 2560, 20 heads of 128 with qkv
biases, 3.95 B parameters in float32) and minicpm3-4b's, and the train
step with the SBC uplink at deepseek-v2-lite-16b's full width (6 of its
27 layers), and the reference's production runtime (bf16, remat) through
the dry-run driver ``repro_torch.launch.dryrun`` at qwen1.5-4b's and
mamba2-2.7b's full width, and holds every kernel of those paths against
its plain PyTorch version on the card:

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
     a ragged ctx; head dim 112 at zamba2-7b's shape and its seams, g 48
     over one KV head, 32 / 32 heads of 64, arctic-480b's g 7 and its
     seams, and phase 4n's batch of 4 at the last slot of a 32k cache;
     f32 2e-5, bf16 rtol 2e-2 with an atol of 2e-2 of the mean |o|;
     bitwise twice; and on the parts of a ring of 64 slots split over
     cards, ``off`` and ``ring``: windows 64 and 24, pos 10, 63, 64 and
     200, 2 and 4 parts, each part's o and lse against the plain
     version's and the parts merged by their lse against the whole
     ring's call);
  4. the main path, with launch counts read around it;
  4b. the transformer cell and 4c. the mamba2 cell, each with launch
     counts read around it and held against the formula stated in
     PERF.md; 4d. ``launch.serve.main`` on mistral-nemo-12b and
     qwen1.5-4b (batch 8, prompt 128, 64 generated tokens, ctx 2048: 40
     x 192 = 7 680 flash decode launches each; qwen's at g = 1), on
     mamba2-2.7b (none), llava-next-mistral-7b (32 x 192),
     musicgen-large (48 x 192), minicpm3-4b and deepseek-v2-lite-16b
     (none: MLA decodes in plain PyTorch), and granite-34b at 20 of its
     88 layers, arctic-480b at 1 of its 35 and zamba2-7b at 27 of its 81
     SSM layers (3 segments, head dim 112) through ``init`` /
     ``init_cache`` / ``make_serve_step`` (20 x 192, 1 x 192, 3 x 192),
     each with its launch count, tokens/s and peak memory; 4l. llava-next-mistral-7b's
     ``make_prefill_step`` at full width (B 1, S 6144, the first 2880
     positions a patch prefix) under B4 and under naive attention in
     ``torch.inference_mode()``: log-softmax of the last 16 positions
     within 1e-4, B4 32 launches; 4e. ``Experiment(data, test,
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
     4k. ``launch.train.main`` at qwen1.5-4b's full width and depth: (i)
     momentum at the driver's defaults (K 4 x slot 8 x 64 tokens), (ii)
     with ``--compress-uplink --slot 2`` (15 B1 and 15 B2 launches a
     step), each 6 steps with finite losses, peak memory and launches;
     then B1 and B2 against their plain versions on one segment of
     ``w_down``'s 707 788 800 elements, with their times; (iii)
     ``make_train_step`` with sgd under ``attn_impl="pallas"`` against
     ``"naive"`` (each from the same seed: first loss and gradient norm
     within rtol 1e-4, 40 launches of B4, B4′ and B4″ a step), 3 timed
     steps each for ms a step and tokens/s, and a compressed naive run
     for the SBC uplink's share of a step; 4m. (i) ``launch.train.main``
     at minicpm3-4b's full width and depth (momentum, the driver's
     defaults, 6 steps), (ii) ``make_train_step`` with momentum and the
     SBC uplink at deepseek-v2-lite-16b's full width, 6 of its 27 layers
     (31 leaves: 31 B1 and 31 B2 launches a step), 3 steps, each with
     finite losses, peak memory, launches and tokens/s; 4n. the
     reference's production runtime (``launch.dryrun.runtime_for``:
     bf16, blockwise attention at block_q 512, remat when training)
     through ``launch.dryrun.run_pair`` at full width, each run with its
     ms a step, tokens/s, peak memory, counted and model FLOPs, useful
     ratio and MFU: (i) train_4k on qwen1.5-4b at full depth (one
     4096-token sequence, momentum) under the perf variants baseline,
     remat_attn, flashjnp and opt_bf16 (no kernel launched), and the
     remat step's loss and gradients bitwise the no-remat step's at 4
     layers; (ii) prefill_32k (one 32768-token sequence) on qwen1.5-4b at
     4 of its 40 layers under blockwise and under B4 in bf16 (4 launches a
     step; the two variants' logits compared) and on mamba2-2.7b at full
     depth (B3 in bf16 at N 128 with dt in f32: 64 a step), B4 at one
     layer against ``attend_chunked`` in f32 on the same bf16 values
     (rtol 2e-2, atol 2e-2 of the mean |o|), with its time; (iii)
     decode_32k on qwen1.5-4b at batch 4 (53.7 GB of bf16 cache), 16
     steps up to the last slot, under B5 in bf16
     (40 a step) and under the plain decode attention (B3 and B5 at
     these shapes are cases of phases 3c, 3d and 6); 4o. SSM and hybrid
     training through the backward kernels: (i) ``launch.train.main``
     on mamba2-2.7b at full width, f32, 3 steps (B3 and B3′ 64 a step);
     (ii) train_4k through ``run_pair`` under ``runtime_for`` (bf16,
     remat), one 4096-token sequence, mamba2-2.7b at full depth and
     zamba2-7b at 54 of its 81 layers (memory); (iii) zamba2-7b's step
     under B4, B4′ and B4″ at head dim 112, its first loss against
     blockwise's within ``bf16_tols``; (iv) reduced mamba2 at N 128 and
     zamba2 at head dim 112, 3 momentum steps card vs CPU path, f32
     (1e-4) and bf16 (2e-2); every run's launches checked; 4p. the
     static analysis (``repro_torch.analysis``): (i) the main cell
     through ``Experiment.run(periods=3, audit=True)``, its report ok,
     B1/B2 6 a period, losses and ledgers bitwise the unaudited run, both
     walls and the probe's seconds a bucket; (ii) 4i's service tape with
     ``audit=True``: each cold admission probed once, no warm one; (iii)
     ``python -m repro_torch.analysis.audit`` (default grid, its run on
     the card) exits 0 with every program certified; (iv) the SBC
     stand-ins' rule: zero segments give zero stats, approximation and
     residual, a segment alone is bitwise itself among the rest; 4q. the
     mesh half of ``launch``: (i) the sharding rules over every assigned
     arch at full width x the four shapes on the 16 x 16 and 2 x 16 x 16
     production meshes (host only): sharded leaves and argument bytes a
     device, with zero1 lower on every train shape; (ii) 4n's decode_32k
     under B5 again with ``multi_pod`` (mesh 2x16x16, 40 launches a step,
     the last logits bitwise 4n's) and ``launch.perf --multi-pod`` on
     train_4k at 2 layers (zero1's argument bytes a device below
     baseline's); (iii) the batch mesh over two entries of the card: the
     main cell, a 3-row ragged bucket (padded to 4), ``AsyncExecutor``
     on the main cell and a 3-ticket ``ExperimentService`` tape, each
     against ``SerialExecutor`` on the card alone (ledgers bitwise, losses
     and accuracies within 1e-5; B1/B2 6 a period a shard), with both
     walls; 4r. the sharded step on a one-rank NCCL world, every
     argument a DTensor, bitwise the same step on plain tensors with the
     same launches: qwen1.5-4b at 4 layers (train_4k baseline and ZeRO-1
     through B4-B4″, decode_32k through B5), mamba2-2.7b at 4 layers (the
     Mamba-2 mixer on DTensors: train_4k baseline and ZeRO-1 through B3
     and B3′, decode_32k against DTensor conv and SSM caches) and
     zamba2-7b at 9 layers (one segment and its shared block, train_4k);
  5. the card against the port's CPU path (three periods of one row,
     and of one row per batchsize policy through ``Experiment``),
     chunked == monolithic bitwise on the card, and a padded row against
     its solo twin; 5b. the same for the transformer, 5c. for mamba2;
     5d. decode at the reduced configs of all ten decoders (and a
     window of 8; zamba2-7b also at head dim 112) over 12 tokens: card vs
     CPU path (1e-4 in log-softmax) and decode vs the port's
     full-sequence forward on the card (2e-3; for MLA under naive
     attention, the kernel route refusing it); 5e. the dynamic
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
     ``stats.to_dict()`` equal, ledgers bitwise, losses 1e-4; 5i. the
     reduced qwen1.5-4b's train step, card vs CPU path: momentum and
     AdamW, each with the SBC uplink off and on, 3 steps, losses 1e-4
     (AdamW teacher-forced, its free gap printed), SBC keep-mask flips
     counted; and a checkpoint on the card: 2 steps, ``save_state``,
     ``restore_state`` bitwise, the resumed third step bitwise the
     uninterrupted one; 5j. reduced musicgen-large and zamba2-7b (B3 and
     B3′ in the hybrid's SSM layers), momentum, 3 steps, card vs CPU path,
     losses 1e-4; 5k. reduced minicpm3-4b, deepseek-v2-lite-16b and
     arctic-480b, momentum, 3 steps, card vs CPU path: losses 1e-4, aux
     1e-5, the first step's expert indices, positions and keep masks
     equal, the card's run twice bitwise;
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
     1) and its resources (registers, spills, shared memory, runs); the
     attention kernels also at qwen1.5-4b's step (B 32, S 64, 20 / 20
     heads of 128) and flash decode at its decode shape (g = 1) and at
     zamba2-7b's (head dim 112, f32 and bf16), granite-34b's (g 48),
     musicgen-large's and arctic-480b's (g 7), with every flash decode
     instance's registers and spills from the build (failing on a
     spill); 4o's kernels at its shapes: B3′ at the two archs' layers
     and B4, B4′, B4″ at head dim 112 (f32, bf16) and at qwen1.5-4b's
     step in bf16, each against its plain version, twice bitwise and a
     sequence alone bitwise among 8, with its resources (failing on a
     spill).

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
import math
import os
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
BF16_RTOL = 2e-2       # bf16 outputs against their plain versions

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
              (32, 64, 20, 20, 128, True, None),     # qwen1.5-4b, phase 4k
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
D_ARCHS = ("mistral-nemo-12b", "mamba2-2.7b", "qwen1.5-4b",
           "llava-next-mistral-7b", "musicgen-large", "minicpm3-4b",
           "deepseek-v2-lite-16b")
D_PROFILED = D_ARCHS[:3]        # --profile's 16 steps a model
D_BATCH, D_PROMPT, D_GEN, D_CTX = 8, 128, 64, 2048
D_ARGV = ["--full", "--batch", str(D_BATCH), "--prompt-len", str(D_PROMPT),
          "--gen", str(D_GEN), "--ctx", str(D_CTX)]
# B5 launches a step: its GQA attention layers (MLA decodes against its
# ckv cache in plain PyTorch, as the reference's, so minicpm3-4b and
# deepseek-v2-lite-16b launch none)
D_LAYERS = {"mistral-nemo-12b": 40, "mamba2-2.7b": 0, "qwen1.5-4b": 40,
            "llava-next-mistral-7b": 32, "musicgen-large": 48,
            "minicpm3-4b": 0, "deepseek-v2-lite-16b": 0}
# decoders at full width with their depth cut: granite-34b's 88 layers
# hold ~136 GB of float32, 20 of them (with the embedding and head) ~33
# GB; one layer of arctic-480b (128 experts of 4864 beside the dense
# residual FFN) holds 54 GB, one layer with the embedding and head 56 GB;
# zamba2-7b (which fits) at 27 of its 81 SSM layers, three segments, to
# keep the script near half its time limit (the host-bound decode of its
# 81 layers took 35 s)
CUT_DECODE = (("granite-34b", 20), ("arctic-480b", 1), ("zamba2-7b", 27))
D_SHAPE = (D_BATCH, D_CTX, 32, 8, 128)        # also llava-next-mistral-7b
D_ZAMBA = (D_BATCH, D_CTX, 32, 32, 112)       # zamba2-7b's shared block
D_GRANITE = (D_BATCH, D_CTX, 48, 1, 128)      # granite-34b's MQA, g 48
D_MUSICGEN = (D_BATCH, D_CTX, 32, 32, 64)     # musicgen-large's MHA
D_ARCTIC = (D_BATCH, D_CTX, 56, 8, 128)       # arctic-480b's GQA, g 7
D_POS = D_PROMPT + D_GEN - 1
D_LONG = (16, 32_768, 32, 8, 128)
# the runs' seams (B, ctx, Hq, Hkv, hd, pos, window): the first tile's last
# slot and the second's first; pos below 32 x the runs, where runs are
# empty; a ring not yet wrapped; two tiles, the second ragged
D_SEAMS = [D_SHAPE + (31, None), D_SHAPE + (32, None), D_SHAPE + (33, None),
           D_SHAPE + (100, None), (2, 256, 8, 2, 64, 40, 256),
           (2, 40, 8, 2, 64, 39, None)]
# hd 112's seams: the runs' (pos 31, 32, 33), a ring buffer (wrapped, and
# a window under ctx), a ctx that is not a multiple of the 32-slot tile
D_SEAMS_112 = [D_ZAMBA + (31, None), D_ZAMBA + (32, None),
               D_ZAMBA + (33, None), (4, 256, 32, 32, 112, 1000, 256),
               (4, 512, 16, 4, 112, 700, 128),
               (3, 1000, 32, 32, 112, 999, None)]
# g 7's seams: the runs' (pos 31, 32, 33) with the last warp's rows short
D_SEAMS_G7 = [D_ARCTIC + (31, None), D_ARCTIC + (32, None),
              D_ARCTIC + (33, None)]
DECODE_SOURCE = "src/repro_torch/kernels/csrc/flash_decode.cu"
# llava's prefill (phase 4l): one sequence of 6144 positions whose first
# 2880 are the anyres patch embeddings (5 tiles of 24 x 24), under B4 and
# under naive attention; log-softmax compared at the last 16 positions
L_ARCH, L_PREFIX, L_SEQ, L_LAST = "llava-next-mistral-7b", 2880, 6144, 16
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
# the training cell (phase 4k): launch.train at qwen1.5-4b's full width
# and depth with the driver's defaults (K 4 devices x slot 8 x 64-token
# sequences, momentum 0.9, lr 0.1), then with the SBC uplink at slot 2;
# its 15 leaves are one B1/B2 segment each a step, the largest
# layers.ffn.w_down (40 x 6912 x 2560); make_train_step with sgd under
# the flash kernels against naive attention at the driver's batch
Q_ARCH = "qwen1.5-4b"
Q_STEPS, Q_K, Q_SLOT, Q_SEQ, Q_SLOT_SBC = 6, 4, 8, 64, 2
Q_LEAVES, Q_LAYERS = 15, 40
Q_SHAPE = (Q_K * Q_SLOT, Q_SEQ, 20, 20, 128)          # B, S, Hq, Hkv, hd
Q_W_DOWN = Q_LAYERS * 6912 * 2560
Q_LRS = (0.1, 0.05, 0.02)
Q_TIMED = 3
Q_DECODE = (D_BATCH, D_CTX, 20, 20, 128)              # B, ctx, Hq, Hkv, hd
# the MoE and MLA training cell (phase 4m): (i) launch.train at
# minicpm3-4b's full width and depth with the driver's defaults; (ii)
# make_train_step, momentum with the SBC uplink, at deepseek-v2-lite-16b's
# full width with its depth cut from 27 to 6 layers (layer 0 dense, 5 MoE;
# 3 424 678 912 parameters: parameters, gradients, momentum and residual
# ~55 GB) on the driver's batch; its 31 leaves are one B1/B2 segment each
# a step, the largest the experts' three matrices (5 x 64 x 2048 x 1408)
M4_TRAIN_ARCH, M4_SBC_ARCH, M4_SBC_LAYERS = ("minicpm3-4b",
                                             "deepseek-v2-lite-16b", 6)
M4_SBC_STEPS, M4_SBC_LEAVES = 3, 31
M4_EXPERT_MATRIX = 5 * 64 * 2048 * 1408
# the MoE and MLA families card vs CPU (phase 5k), reduced
K5_ARCHS = ("minicpm3-4b", "deepseek-v2-lite-16b", "arctic-480b")
# the production runtime (phase 4n): launch.dryrun.run_pair under
# runtime_for (bf16, blockwise attention at block_q 512, remat when
# training) at full width; (i) train_4k on qwen1.5-4b at full depth, one
# 4096-token sequence, momentum, under four perf variants, and remat ==
# no remat bitwise at N_REMAT_LAYERS (no remat needs ~2.7 GB of attention
# probabilities a layer); (ii) prefill_32k, one 32768-token sequence:
# qwen1.5-4b with its depth cut to N_PREFILL_LAYERS (a 32k-token layer
# takes ~0.4 s of attention either way) and mamba2-2.7b at full depth;
# (iii) decode_32k on qwen1.5-4b at batch 4 (53.7 GB of bf16 cache), 16
# steps up to the last slot
N_ARCH, N_SSM_ARCH = "qwen1.5-4b", "mamba2-2.7b"
N_TRAIN_VARIANTS = ("baseline", "remat_attn", "flashjnp", "opt_bf16")
N_TRAIN_REPEATS, N_REMAT_LAYERS = 2, 4
N_PREFILL_LAYERS, N_PREFILL_REPEATS = 4, 1
N_DECODE_STEPS, N_DECODE_BATCH = 16, 4
N_ATTN = (1, 32_768, 20, 20, 128)          # B, S, Hq, Hkv, hd (B4, bf16)
N_SSD = (1, 32_768, 80, 64, 1, 128, 256)   # B, S, H, P, G, N, chunk (B3)
N_DECODE = (N_DECODE_BATCH, 32_768, 20, 20, 128)     # B, ctx, ... (B5)
# the SSM and hybrid training cell (phase 4o): (i) launch.train at
# mamba2-2.7b's full width and depth in f32, momentum at the driver's
# defaults (K 4 x slot 8 x 64 tokens), 3 steps; (ii) train_4k through
# run_pair under runtime_for (bf16, blockwise, remat), one 4096-token
# sequence (the global batch cut from 256 to 1), mamba2-2.7b at full depth
# and zamba2-7b at O_LAYERS'; (iii) zamba2-7b's train_4k step under attn_impl="pallas"
# (B4, B4' and B4'' at its shared block's head dim 112), its first loss
# against blockwise's; (iv) card vs CPU, 3 momentum steps of 64-token
# sequences in f32 and bf16, reduced mamba2-2.7b at d_state 128 and
# reduced zamba2-7b at head dim 112, both under the kernels
O_TRAIN_ARCH, O_HYBRID_ARCH = "mamba2-2.7b", "zamba2-7b"
O_STEPS, O_REPEATS, O_CPU_SEQ = 3, 1, 64
# zamba2-7b's train_4k steps run with its depth cut from 81 to 54 SSM
# layers (6 of its 9 segments): at 81 the step's gradient norm takes a
# float32 copy and its square of the stacked in_proj gradient (4.2 G
# elements, 17 GB each) beside 58 GB of bf16 parameters and gradients
# and float32 momentum, past the card's 80 GB
O_LAYERS = {"mamba2-2.7b": 0, "zamba2-7b": 54}
# B3' at the two archs' train_4k layers (B, S, H, P, G, N, chunk) and B4,
# B4', B4'' at zamba2-7b's shared block (B, S, Hq, Hkv, hd), phase 6
O_SSD = {"mamba2-2.7b": (1, 4096, 80, 64, 1, 128, 256),
         "zamba2-7b": (1, 4096, 112, 64, 1, 64, 256)}
O_ATTN = (1, 4096, 32, 32, 112)
O_AMONG = 8                   # sequences a batch-invariance check runs
# f32 B3' at O_SSD against the plain version and it in float64 (rtol =
# atol): the backward's 1e-4 (phase 3c's); at S 4096 the kernel needs
# 2.91e-5 (mamba2) and 3.42e-5 (zamba2) against float64, the float32 plain
# version 4.2e-3 and 1.6e-2 (phase 6 on an NVIDIA H100 80GB HBM3, 700 W)
O_SSD_TOL = 1e-4
O_ATTN_TOL = 2e-5             # f32 B4' and B4'' at O_ATTN (rtol = atol)
# the mesh half of launch (phase 4q): (i) the sharding rules at full width
# on the two production meshes (abstract: they size, nothing is placed);
# (ii) phase 4n's decode_32k pallas run again with multi_pod, and the perf
# driver's --multi-pod on one train pair at Q_PERF_LAYERS layers; (iii)
# the batch mesh: two entries of the one card, the main cell (16 rows), a
# 3-row ragged bucket (K 12, 12 and 10; padded to 4 rows), AsyncExecutor
# on the main cell and a short service tape, each against SerialExecutor
# on the card alone: ledgers bitwise, losses and accuracies within 1e-5
# (the reference's own test's tolerance)
Q_MESHES = ("16x16", "2x16x16")
Q_PERF_LAYERS = 2
Q_RAGGED_K = (12, 12, 10)
Q_TOL = 1e-5
Q_SERVICE_PERIODS, Q_SERVICE_CHUNK = 6, 2

# the sharded step on the one card (phase 4r): a one-rank NCCL world on a
# (1, 1) ("data", "model") mesh, each cell at full width with its depth
# cut, under attn_impl="pallas": (i) train_4k (one 4096-token sequence,
# bf16, remat, momentum) R_TRAIN_STEPS steps unsharded, on the mesh, and
# on the mesh under ZeRO-1 (the kernels through local_map); (ii)
# decode_32k at batch R_DECODE_BATCH, R_DECODE_STEPS steps up to the last
# slot of a 32k cache; every sharded run held bitwise to the unsharded
# one (losses, parameters, logits, caches) with its kernel launches equal
R_TRAIN_STEPS = 2
R_DECODE_BATCH, R_DECODE_STEPS = 4, 4
# its cells: (arch, layers, sharded train variants, decode too) — qwen at
# 4 of 40 layers (B4-B4''; B5), mamba2-2.7b at 4 of 64 (the Mamba-2 mixer
# on DTensors: B3 and B3'; decode on DTensor conv and SSM caches) and
# zamba2-7b at 9 of 81 (one segment and its shared block: B3, B3', B4-B4'')
R_CELLS = ((N_ARCH, 4, ("baseline", "zero1"), True),
           (N_SSM_ARCH, 4, ("baseline", "zero1"), True),
           ("zamba2-7b", 9, ("baseline",), False))

# B5 on the parts of a ring split over cards (phase 3d): a ring of D_RING
# slots under each window, at each pos (10: parts past it empty; 64: the
# wrap), cut into each count of parts, at qwen's and zamba2's decode heads
D_RING, D_RING_WINDOWS, D_RING_POS = 64, (64, 24), (10, 63, 64, 200)
D_RING_PARTS = (2, 4)
D_RING_SHAPES = ((4, 32, 8, 128), (4, 32, 32, 112))


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
    card (forward 2e-5, bf16 forward :func:`bf16_tols`, lse 2e-5,
    backward 1e-4 against
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
        """Within ``tol`` (rtol = atol), or :func:`bf16_tols` for None."""
        got, want = got.float(), want.float()
        rtol, atol = bf16_tols(want) if tol is None else (tol, tol)
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            raise AssertionError(
                f"{label}: {key} beyond rtol {rtol:.3g}, atol {atol:.3g} "
                f"(max abs err {float((got - want).abs().max()):.3g})")
        errs[key] = max(errs[key], float((got - want).abs().max()))

    def forward(q, k, v, opts, label, bf16_key="bf16_fwd"):
        """The forward in f32 and bf16 against the plain version, each
        run twice bitwise; returns the f32 (o, lse)."""
        out = None
        for dtype, key, tol in ((torch.float32, "flash_attention_fwd", 2e-5),
                                (torch.bfloat16, bf16_key, None)):
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
    from repro_torch.launch.cost import visible_pairs as pairs
    b, s, hq, _ = q.shape
    return b * hq * pairs(s, causal, window)


def bf16_tols(want):
    """(rtol, atol) of a bf16 kernel output against its plain version:
    rtol 2e-2 (bf16 keeps 8 bits; both round one float32 result) and atol
    2e-2 times the plain output's mean magnitude.  An output that averages
    many rows (attention over a long context) is small, so a fixed atol
    of 2e-2 would pass a kernel that drops or repeats keys."""
    return BF16_RTOL, BF16_RTOL * float(want.float().abs().mean())


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
    """(bound_ms, bound_by, bytes, ops) of one dQ call: q, o, dO, k, v (in
    their type) and lse read once, dq (in q's) and D written once, over
    3.35 TB/s, against the visible pairs' 6 hd + 4 operations and D's 2 hd
    a row over the peak rate of the inputs' type (f32: 67 TFLOP/s)."""
    b, s, hq, hd = q.shape
    e = q.element_size()
    nbytes = e * (4 * q.numel() + 2 * k.numel()) + 4 * 2 * b * hq * s
    ops = (visible_pairs(torch, q, causal, window) * (6 * hd + 4)
           + b * hq * s * 2 * hd)
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    return (*bound(nbytes, ops, rate), nbytes, ops)


def dkdv_bound(torch, q, k, causal, window):
    """(bound_ms, bound_by, bytes, ops) of one dK/dV call: q, dO, k, v (in
    their type), lse and D read once, dk and dv written once, over 3.35
    TB/s, against the visible pairs' 8 hd + 4 operations over the peak
    rate of the inputs' type."""
    b, s, hq, hd = q.shape
    e = q.element_size()
    nbytes = e * (2 * q.numel() + 4 * k.numel()) + 4 * 2 * b * hq * s
    ops = visible_pairs(torch, q, causal, window) * (8 * hd + 4)
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    return (*bound(nbytes, ops, rate), nbytes, ops)


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


def attention_times(torch, kfa, F, shape=T_SHAPE):
    """Cold-L2 median times at an attention shape (the transformer cell's
    by default):
    each kernel, its plain version, and scaled_dot_product_attention
    (forward; forward + backward for the backward kernels, and its
    backward alone on a graph built once) as a yardstick.  Bounds: bytes
    moved (each input read once, each output written once) over 3.35 TB/s
    vs the visible pairs' f32 operations over 67 TFLOP/s.  Each kernel
    also on the card (profiler)."""
    b, s, hq, hkv, hd = shape
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


def ssd_bf16_check(torch, kssd, ins, chunk, label):
    """The bf16 forward against its plain version within :func:`bf16_tols`;
    returns the max abs err."""
    got = kssd.ssd_scan_fwd(*ins, chunk=chunk).float()
    want = kssd.ssd_scan_fwd_plain(*ins, chunk=chunk).float()
    rtol, atol = bf16_tols(want)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{label}: bf16 forward beyond rtol {rtol}, "
                             f"atol {atol:.3g} (max abs err {err:.3g})")
    return err


def ssd_checks(torch, kssd, kops):
    """The SSD kernels against their plain versions on the card: forward
    2e-5 (bf16, with dt in float32 as the model gives it:
    :func:`bf16_tols`), backward 1e-4, each against the plain version in
    float64 and in float32 (where sound), at the mamba2 cell's shape, at
    the reference's four kernel-test shapes and at the backward's seams;
    the forward also at its own seams and at N 128, and in bf16 at phase
    4n's mamba2-2.7b shape ``N_SSD``.  The forward and the
    backward run twice bitwise; a sequence's y, and a copy's gradients,
    bitwise the same alone and among the rest.  Returns the max abs
    errors; raises AssertionError."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    errs = {"ssd_scan_fwd": 0.0, "ssd_scan_bwd": 0.0, "bf16_fwd": 0.0,
            "prod_bf16_fwd": 0.0, "fwd_vs_f64": 0.0, "bwd_vs_f64": 0.0,
            "plain_fwd_vs_f64": 0.0,
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
        bf[1:3] = ins[1:3]                        # dt and A stay float32
        errs["bf16_fwd"] = max(errs["bf16_fwd"],
                               ssd_bf16_check(torch, kssd, bf, chunk, label))
        if (copies, per, s, h, p, g, n, chunk) in fwd_only:
            del ins, dy, y, exact_in, bf
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
    b, s, h, p, g, n, chunk = N_SSD
    ins, _ = ssd_inputs(torch, gen, 1, b, s, h, p, g, n)
    bf = [t.bfloat16() for t in ins]
    bf[1:3] = ins[1:3]
    errs["prod_bf16_fwd"] = ssd_bf16_check(torch, kssd, bf, chunk,
                                           f"ssd at 4n's {N_SSD}")
    del ins, bf
    # the forward at the cell's whole batch: twice bitwise (f32, bf16 with
    # a bf16 dt), and sequences alone bitwise the same rows among the 12 288
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
    # phase 4n's mamba2-2.7b layer at prefill_32k: bf16, dt f32
    b, s, h, p, g, n, chunk = N_SSD
    ins, _ = ssd_inputs(torch, gen, 1, b, s, h, p, g, n)
    ins = tuple(t if i in (1, 2) else t.bfloat16() for i, t in enumerate(ins))
    x, dt, a, bm, cm = ins
    nbytes = 2 * (2 * x.numel() + bm.numel() + cm.numel()) + 4 * (
        dt.numel() + a.numel())
    ops = b * s * h * p * (5 * n + 2)
    bound_ms, bound_by = bound(nbytes, ops, BF16_OPS_PER_S)
    out["ssd_scan_fwd"]["at_prod_bf16"] = {
        "shape": list(N_SSD), "dtype": "bfloat16",
        "ms": cold_ms(torch, lambda: kssd.ssd_scan_fwd(*ins, chunk=chunk),
                      iters=10),
        "plain_ms": cold_ms(torch, lambda: kssd.ssd_scan_fwd_plain(
            *ins, chunk=chunk), iters=3),
        "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes": nbytes, "ops": ops}
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
    bf16 :func:`bf16_tols`, at the decode cell's shape at the path's last
    position,
    pos 0 and the last slot, the runs' seams (``D_SEAMS``), ring
    buffers (pos < ctx and pos 1000), head
    dim 64 at g 1, 4 and 8, and a ctx that is not a multiple of the
    kernel's 32-slot tile; and the new paths' shapes: zamba2-7b's head
    dim 112 (``D_ZAMBA``, with its seams ``D_SEAMS_112``), granite-34b's
    g 48 over one KV head (the R = 8 instance in two passes over the
    rows), musicgen-large's 32 / 32 heads of 64 and arctic-480b's 56 / 8
    (g 7: the R = 2 instance with the last warp's second row empty, also
    at the runs' seams ``D_SEAMS_G7``), and phase 4n's qwen1.5-4b batch of
    4 at the last slot of a 32k cache (``N_DECODE``); every case run twice
    and required bitwise equal, and a third time with its log-sum-exp (o
    bitwise, lse within 1e-4 of the plain version's).  Returns the max abs
    errors (hd 112, g 7, phase 4n's shape and lse apart too); raises
    AssertionError."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    errs = {"flash_decode": 0.0, "bf16": 0.0, "hd112": 0.0,
            "hd112_bf16": 0.0, "g7": 0.0, "g7_bf16": 0.0, "prod": 0.0,
            "prod_bf16": 0.0, "lse": 0.0}
    b, ctx, hq, hkv, hd = D_SHAPE
    cases = [D_SHAPE + (D_POS, None), Q_DECODE + (D_POS, None),
             D_SHAPE + (0, None),
             D_SHAPE + (ctx - 1, None), *D_SEAMS,
             (4, 256, 8, 2, 64, 100, 256), (4, 256, 8, 2, 64, 1000, 256),
             (4, 512, 16, 4, 128, 700, 128),
             (4, 256, 8, 8, 64, 200, None), (4, 256, 8, 2, 64, 200, None),
             (4, 256, 64, 8, 64, 255, 64), (3, 1000, 32, 8, 128, 999, None),
             (3, 1000, 32, 8, 128, 5000, None),
             D_ZAMBA + (D_POS, None), *D_SEAMS_112,
             D_GRANITE + (D_POS, None), D_MUSICGEN + (D_POS, None),
             D_ARCTIC + (D_POS, None), *D_SEAMS_G7,
             N_DECODE + (N_DECODE[1] - 1, None)]
    for b, ctx, hq, hkv, hd, pos, window in cases:
        label = (f"flash_decode B={b} ctx={ctx} Hq={hq} Hkv={hkv} hd={hd} "
                 f"pos={pos} window={window}")
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        for dtype, tol, key in ((torch.float32, 2e-5, "flash_decode"),
                                (torch.bfloat16, None, "bf16")):
            q, k, v = decode_inputs(torch, gen, b, ctx, hq, hkv, hd, dtype)
            got = kfd.flash_decode(q, k, v, p, window=window)
            want = kfd.flash_decode_plain(q, k, v, p, window=window)
            err = float((got.float() - want.float()).abs().max())
            rtol, atol = bf16_tols(want) if tol is None else (tol, tol)
            if not torch.allclose(got.float(), want.float(), rtol=rtol,
                                  atol=atol):
                raise AssertionError(f"{label} {dtype}: beyond rtol {rtol}, "
                                     f"atol {atol:.3g} of the plain version "
                                     f"(max abs err {err:.3g})")
            if not torch.equal(got, kfd.flash_decode(q, k, v, p,
                                                     window=window)):
                raise AssertionError(f"{label} {dtype}: not bitwise "
                                     "reproducible")
            # the output with the log-sum-exp (a sequence split over
            # cards merges its parts by it): o bitwise, lse 1e-4
            got2, lse = kfd.flash_decode(q, k, v, p, window=window, lse=True)
            _, want_lse = kfd.flash_decode_plain(q, k, v, p, window=window,
                                                 lse=True)
            if not (torch.equal(got2, got) and torch.allclose(
                    lse, want_lse, rtol=1e-4, atol=1e-4)):
                raise AssertionError(
                    f"{label} {dtype}: with lse, o bitwise "
                    f"{torch.equal(got2, got)}, lse max abs err "
                    f"{float((lse - want_lse).abs().max()):.3g}")
            errs["lse"] = max(errs["lse"],
                              float((lse - want_lse).abs().max()))
            errs[key] = max(errs[key], err)
            for apart, case in (("hd112", hd == 112),
                                ("g7", hq == 7 * hkv),
                                ("prod", (b, ctx, hq, hkv, hd) == N_DECODE)):
                if case:
                    sub = apart if key == "flash_decode" else apart + "_bf16"
                    errs[sub] = max(errs[sub], err)
    return errs


def ring_part_checks(torch, kfd):
    """B5 on the parts of a ring split over cards (``off``, ``ring``), as
    decode against a windowed cache split on its sequence runs it: a ring
    of ``D_RING`` slots under windows ``D_RING_WINDOWS``, pos
    ``D_RING_POS`` (10: the parts past it empty; 64: the wrap), in
    ``D_RING_PARTS`` parts, f32 and bf16, at qwen's and zamba2's decode
    heads (``D_RING_SHAPES``).  Each part's o against the plain version's
    (f32 2e-5, bf16 :func:`bf16_tols`) and its lse within 1e-4; the parts
    merged by their lse against the whole ring's call within the same;
    off 0 and the ring's own length bitwise the call without them.
    Returns the max abs errors; raises AssertionError."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    errs = {"part": 0.0, "part_bf16": 0.0, "lse": 0.0, "merged": 0.0,
            "merged_bf16": 0.0, "cases": 0}
    for (b, hq, hkv, hd), window, parts, pos in itertools.product(
            D_RING_SHAPES, D_RING_WINDOWS, D_RING_PARTS, D_RING_POS):
        c = D_RING // parts
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        for dtype, tol, key in ((torch.float32, 2e-5, ""),
                                (torch.bfloat16, None, "_bf16")):
            label = (f"flash_decode ring {D_RING} in {parts} parts B={b} "
                     f"Hq={hq} Hkv={hkv} hd={hd} pos={pos} window={window} "
                     f"{dtype}")
            q, k, v = decode_inputs(torch, gen, b, D_RING, hq, hkv, hd,
                                    dtype)
            whole, whole_lse = kfd.flash_decode(q, k, v, p, window=window,
                                                lse=True)
            same = kfd.flash_decode(q, k, v, p, window=window, lse=True,
                                    off=0, ring=D_RING)
            if not (torch.equal(same[0], whole)
                    and torch.equal(same[1], whole_lse)):
                raise AssertionError(f"{label}: off 0 and the ring's length "
                                     "not bitwise the call without them")
            got = []
            for i in range(parts):
                kp, vp = (t[:, i * c:(i + 1) * c].contiguous()
                          for t in (k, v))
                o, lse = kfd.flash_decode(q, kp, vp, p, window=window,
                                          lse=True, off=i * c, ring=D_RING)
                po, plse = kfd.flash_decode_plain(q, kp, vp, p,
                                                  window=window, lse=True,
                                                  off=i * c, ring=D_RING)
                rtol, atol = bf16_tols(po) if tol is None else (tol, tol)
                err = float((o.float() - po.float()).abs().max())
                lerr = float((lse - plse).abs().max())
                if not (torch.allclose(o.float(), po.float(), rtol=rtol,
                                       atol=atol)
                        and torch.allclose(lse, plse, rtol=1e-4,
                                           atol=1e-4)):
                    raise AssertionError(
                        f"{label}, part {i}: o max abs err {err:.3g} (rtol "
                        f"{rtol}, atol {atol:.3g}), lse {lerr:.3g} (1e-4)")
                errs["part" + key] = max(errs["part" + key], err)
                errs["lse"] = max(errs["lse"], lerr)
                got.append((o, lse))
            top = torch.stack([lse for _, lse in got]).amax(0)
            w = [torch.exp(lse - top) for _, lse in got]
            merged = sum(o.float() * wi[:, None, :, None]
                         for (o, _), wi in zip(got, w)) / sum(w)[
                             :, None, :, None]
            rtol, atol = bf16_tols(whole) if tol is None else (tol, tol)
            err = float((merged - whole.float()).abs().max())
            if not torch.allclose(merged, whole.float(), rtol=rtol,
                                  atol=atol):
                raise AssertionError(f"{label}: merged parts max abs err "
                                     f"{err:.3g} of the whole ring's call")
            errs["merged" + key] = max(errs["merged" + key], err)
            errs["cases"] += 1
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


def cut_decode_cell(torch, tm, get_arch, make_serve_step, kfd, tree_leaves,
                    arch, n_layers):
    """4d for a decoder at full width with its depth cut to ``n_layers``
    (granite-34b: d_model 6144, 48 query heads of 128 over one KV head,
    the GELU MLP of 24576; arctic-480b: d_model 7168, 56 / 8 heads of
    128, 128 experts top-2 beside the dense residual FFN; zamba2-7b:
    segments of 9 SSM layers, each followed by the shared block of 32
    heads of 112), driven as ``launch.serve.main`` drives a model (which
    takes no depth): ``init``, ``init_cache`` and ``make_serve_step``,
    the prompt stepped through the decode path, then greedy decode, with
    the flash decode count set to 0 just before and read just after.
    Returns the report; raises AssertionError."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_arch(arch), n_layers=n_layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = tm.init(cfg, gen)
    prompt = torch.randint(0, cfg.vocab, (D_BATCH, D_PROMPT), generator=gen,
                           device="cuda")
    serve = make_serve_step(cfg, tm.Runtime(attn_impl="pallas"))
    cache = tm.init_cache(cfg, D_BATCH, D_CTX, device="cuda")
    kfd.flash_decode.launches = 0
    for t in range(D_PROMPT):
        logits, cache = serve(params, cache, prompt[:, t:t + 1])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(D_GEN):
        nxt = torch.argmax(logits[..., :cfg.vocab], dim=-1)
        logits, cache = serve(params, cache, nxt)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    launches = kfd.flash_decode.launches
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(t.numel() for t in tree_leaves(params))
    tps = D_GEN * D_BATCH / dt
    attn_layers = (n_layers // cfg.hybrid_every if cfg.family == "hybrid"
                   else n_layers)
    want = attn_layers * (D_PROMPT + D_GEN)
    log(f"[4d decode] {arch} at full width, depth cut from "
        f"{get_arch(arch).n_layers} to {n_layers} layers ({n_params} "
        f"float32 parameters), batch {D_BATCH}, prompt {D_PROMPT}, "
        f"{D_GEN} generated, ctx {D_CTX}: {tps:.1f} tokens/s = "
        f"{1e3 * D_BATCH / tps:.2f} ms per decode step; prefill "
        f"{t1 - t0:.2f} s with init; whole {wall:.2f} s; peak device "
        f"memory {peak:.2f} GiB; flash_decode launches {launches} "
        f"(expected {want})")
    if not bool(torch.isfinite(logits[..., :cfg.vocab]).all()):
        raise AssertionError(f"4d {arch}: non-finite logits")
    if launches != want:
        raise AssertionError(f"4d {arch}: flash_decode launches "
                             f"{launches}, expected {want}")
    del params, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return {"tokens_per_s": tps, "ms_per_step": 1e3 * D_BATCH / tps,
            "wall_s": wall, "peak_gib": peak, "n_params": n_params,
            "n_layers": n_layers, "launches": {"flash_decode": launches}}


def llava_prefill_cell(torch, ts, tm, get_arch, kfa, smi):
    """Phase 4l: ``make_prefill_step`` on llava-next-mistral-7b at full
    width and depth, one sequence of ``L_SEQ`` positions whose first
    ``L_PREFIX`` are patch embeddings (``batch["prefix"]``), inside
    ``torch.inference_mode()``, under ``attn_impl="pallas"`` (B4, one
    launch a layer, counted from 0 just before) and ``"naive"``: the
    log-softmax of the last ``L_LAST`` positions within 1e-4.  Returns the
    report; raises AssertionError."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_arch(L_ARCH)
    params = tm.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, L_SEQ), generator=gen,
                                     device="cuda"),
             "prefix": 0.02 * torch.randn((1, L_PREFIX, cfg.d_model),
                                          generator=gen, device="cuda")}
    report, lsm = {}, {}
    for impl in ("pallas", "naive"):
        prefill = ts.make_prefill_step(cfg, tm.Runtime(attn_impl=impl))
        torch.cuda.reset_peak_memory_stats()
        kfa.flash_attention_fwd.launches = 0
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = prefill(params, batch)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            lsm[impl] = torch.log_softmax(
                logits[:, -L_LAST:, :cfg.vocab].float(), -1)
            finite = bool(torch.isfinite(logits[..., :cfg.vocab]).all())
        del logits
        launches = kfa.flash_attention_fwd.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        report[impl] = {"ms": ms, "tokens_per_s": L_SEQ / ms * 1e3,
                        "peak_gib": peak,
                        "launches": {"flash_attention_fwd": launches}}
        log(f"[4l prefill] make_prefill_step {L_ARCH} full, B 1, S "
            f"{L_SEQ} with a {L_PREFIX}-patch prefix, attn_impl={impl}: "
            f"{ms:.1f} ms = {L_SEQ / ms * 1e3:.0f} tokens/s (one call); "
            f"peak device memory {peak:.2f} GiB; flash_attention_fwd "
            f"launches {launches}; {smi}")
        if not finite:
            raise AssertionError(f"4l {impl}: non-finite logits")
    err = float((lsm["pallas"] - lsm["naive"]).abs().max())
    report["log_softmax_max_abs_err"] = err
    log(f"[4l prefill] pallas vs naive: log-softmax of the last {L_LAST} "
        f"positions max abs err {err:.3g} (tol 1e-4)")
    want = {"pallas": cfg.n_layers, "naive": 0}
    for impl, n in want.items():
        got = report[impl]["launches"]["flash_attention_fwd"]
        if got != n:
            raise AssertionError(f"4l {impl}: B4 launches {got}, expected "
                                 f"{n}")
    if not err <= 1e-4:
        raise AssertionError(f"4l: pallas vs naive log-softmax {err:.3g} "
                             f"beyond 1e-4")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return report


def decode_contracts(torch, tm, get_arch, tree_map, kfa):
    """Decode at the reduced configs (and mistral-nemo-12b with a window
    of 8, a ring buffer; zamba2-7b also at head dim 112) over 12 tokens of
    2 sequences: the card against the CPU path (1e-4 in log-softmax), and
    decode against the port's full-sequence forward on the card (2e-3,
    the reference's bound; the forward under B4, head dim 112 too; for
    MLA, whose v head dim is not q's (C-ref-10), under naive attention,
    after checking that the kernel route refuses it; the MoE
    family's forward drop-free at capacity factor 64, as decode is and as
    the reference's ``tests/test_models.py`` holds it).  Returns the max
    errors; raises AssertionError."""
    n, b = 12, 2
    errs = {}
    for arch, window, hd in (
            ("mistral-nemo-12b", None, None), ("mistral-nemo-12b", 8, None),
            ("mamba2-2.7b", None, None), ("granite-34b", None, None),
            ("musicgen-large", None, None),
            ("llava-next-mistral-7b", None, None),
            ("zamba2-7b", None, None), ("zamba2-7b", None, 112),
            ("minicpm3-4b", None, None), ("deepseek-v2-lite-16b", None, None),
            ("arctic-480b", None, None)):
        cfg = get_arch(arch).reduced()
        if window is not None:
            cfg = dataclasses.replace(cfg, attn_window=window)
        if hd is not None:
            cfg = dataclasses.replace(cfg, head_dim=hd)
        params = tm.init(cfg, torch.Generator().manual_seed(0))
        card = tree_map(lambda t: t.cuda(), params)
        cb = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
        toks = torch.randint(0, cfg.vocab, (b, n) + cb,
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
        stacked = tree_map(lambda t: t[None], card)
        impl = "pallas"
        mla = cfg.attn_kind == "mla"
        if mla or (cfg.n_heads and cfg.hd() not in kfa.HEAD_DIMS):
            try:
                tm.forward(cfg, stacked, toks.cuda()[None])
            except ValueError as exc:
                if mla and "C-ref-10" not in str(exc):
                    raise AssertionError(f"5d {cfg.name}: {exc}") from exc
                log(f"[5d decode] {cfg.name} hd={cfg.hd()}: forward under "
                    f"B4 refused as it must be: {exc}")
            else:
                raise AssertionError(f"5d {cfg.name}: B4 took "
                                     + ("MLA" if mla else
                                        f"head dim {cfg.hd()}"))
            impl = "naive"
        rt = tm.Runtime(attn_impl=impl,
                        capacity_factor=64.0 if cfg.moe else 1.25)
        full = tm.forward(cfg, stacked, toks.cuda()[None], rt=rt)[0][0]
        cpu_err = float((lsm(on_card) - lsm(on_cpu)).abs().max())
        fwd_err = float((lsm(on_card) - lsm([full])).abs().max())
        label = f"{cfg.name} window={window} hd={cfg.hd()}"
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
    at the decode cell's shape at the path's last position (f32), at
    qwen1.5-4b's (g = 1) there, at the new paths' (zamba2-7b's head dim
    112 in f32 and bf16, granite-34b's g 48 over one KV head,
    musicgen-large's 32 / 32 heads of 64, arctic-480b's g 7;
    llava-next-mistral-7b's is the decode cell's), at one layer of a
    full 32k-token cache (bf16 and f32) and at phase 4n's qwen1.5-4b
    decode_32k layer (bf16, ``N_DECODE``), beside the bound of
    :func:`decode_bound`.  Beside the
    CUDA-event time (the wrapper's host work included): the card's own
    time a call from the profiler and the kernels a call puts on the card,
    and the kernel's resources at the shape."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for key, shape, pos, dtype in (
            ("path", D_SHAPE, D_POS, torch.float32),
            ("qwen_path", Q_DECODE, D_POS, torch.float32),
            ("zamba2_path", D_ZAMBA, D_POS, torch.float32),
            ("zamba2_bf16", D_ZAMBA, D_POS, torch.bfloat16),
            ("granite_path", D_GRANITE, D_POS, torch.float32),
            ("musicgen_path", D_MUSICGEN, D_POS, torch.float32),
            ("arctic_path", D_ARCTIC, D_POS, torch.float32),
            ("32k_bf16", D_LONG, D_LONG[1] - 1, torch.bfloat16),
            ("32k_f32", D_LONG, D_LONG[1] - 1, torch.float32),
            ("prod_bf16", N_DECODE, N_DECODE[1] - 1, torch.bfloat16)):
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
    for arch in D_PROFILED:
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


def _drive_tape(env, counted, device=None, audit=False):
    """serve_load's traffic through a fresh ``ExperimentService`` (the
    constants above): an untimed warm-up, then the launch counts set to 0
    and the tape driven on a virtual clock advanced by the host's time
    and drained.  Returns ``(svc, tickets, groups, stats, wall, t_warm,
    launches, want)``, ``want`` the launches the tape must make."""
    from repro_torch.serve import ExperimentService, ProgramCache
    from repro_torch.testing import (VirtualClock, assign_templates,
                                     poisson_arrivals)
    hot = [_service_specs(env, partition="noniid", seeds=(0, 1)),
           _service_specs(env, partition="iid", seeds=(2, 3))]
    clock = VirtualClock()
    svc = ExperimentService(env.data, env.test, device=device,
                            chunk_periods=I_CHUNK, window=I_WINDOW,
                            max_batch=I_MAX_BATCH, clock=clock,
                            cache=ProgramCache(shared=False), audit=audit)
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
        env.torch.cuda.reset_peak_memory_stats()
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
    s = stats.to_dict()
    feel_periods = I_HOT * (s["admissions"] - 3) + I_LONG
    full = {name: I_FEEL_SBC * feel_periods
            for name in ("sbc_stats", "sbc_apply")}
    for per in I_FAMILY_LAUNCHES.values():
        for name, n in per.items():
            full[name] = full.get(name, 0) + n * I_FAMILY
    want = {name: full.get(name, 0) for name in counted}
    return svc, tickets, groups, s, wall, t_warm, launches, want


def service_cell(env, counted, device=None):
    """Phase 4i: ``repro_torch.serve.ExperimentService`` at the main
    cell's full width under serve_load's traffic (the constants above),
    with the kernels' launch counts set to 0 after the warm-up and read
    after the drain, held against 6 B1/B2 a dispatched feel-mlp period
    and the families' formulas.  Then every ticket is held bitwise
    against its admission group's ``Experiment`` twin (chunked as the
    service chunks) and against its solo twin (ledgers bitwise, losses
    1e-4; the gap printed).  Raises AssertionError."""
    torch, np = env.torch, env.np
    _, tickets, groups, s, wall, t_warm, launches, want = _drive_tape(
        env, counted, device)
    peak = (torch.cuda.max_memory_allocated() / 2**30 if device is None
            else float("nan"))
    feel_periods = I_HOT * (s["admissions"] - 3) + I_LONG
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


def _train_lines(out: str, tag: str = "4k train"):
    """The driver's printed lines into the log; the per-step losses and
    wall seconds it printed."""
    losses, walls = [], []
    for line in out.splitlines():
        log(f"[{tag}]   {line}")
        if "loss=" in line and "wall=" in line:
            losses.append(float(line.split("loss=")[1].split()[0]))
            walls.append(float(line.split("wall=")[1].strip().rstrip("s")))
    return losses, walls


def train_cell(torch, train, counted, smi):
    """Phase 4k (i) and (ii): ``launch.train.main`` at qwen1.5-4b's full
    width and depth, momentum at the driver's defaults, then with
    ``--compress-uplink --slot 2``; each with its launch counts (set to 0
    just before, read just after), peak memory, whole-call wall and the
    driver's losses (all finite).  Returns the report; raises
    AssertionError."""
    report = {}
    for tag, extra, slot in (
            ("momentum", [], Q_SLOT),
            ("compressed", ["--compress-uplink", "--slot", str(Q_SLOT_SBC)],
             Q_SLOT_SBC)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in counted.values():
            fn.launches = 0
        argv = ["--arch", Q_ARCH, "--full", "--steps", str(Q_STEPS)] + extra
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            final = train.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counted.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses, walls = _train_lines(out.getvalue())
        step_s = ((walls[-1] - walls[0]) / (len(walls) - 1)
                  if len(walls) > 1 else float("nan"))
        tokens = Q_K * slot * Q_SEQ
        want = Q_LEAVES * Q_STEPS if "--compress-uplink" in extra else 0
        log(f"[4k train] ({'i' if tag == 'momentum' else 'ii'}) "
            f"launch.train.main {' '.join(argv)}: {tokens} tokens a step; "
            f"losses {losses}; whole call {wall:.2f} s (init, data, "
            f"{Q_STEPS} steps); about {step_s:.2f} s a step from the "
            f"driver's wall= lines (0.1 s resolution); peak device memory "
            f"{peak:.2f} GiB; launches {launches} (expected {want} each of "
            f"the SBC pair); {smi}")
        if len(losses) != Q_STEPS or not all(map(math.isfinite,
                                                 losses + [final])):
            raise AssertionError(f"4k {tag}: losses {losses}, final {final}")
        if launches != {name: want for name in counted}:
            raise AssertionError(f"4k {tag}: launches {launches}, expected "
                                 f"{want} each")
        report[tag] = {"argv": argv, "losses": losses, "wall_s": wall,
                       "step_s_from_driver": step_s, "peak_gib": peak,
                       "tokens_per_step": tokens, "launches": launches}
    gc.collect()
    torch.cuda.empty_cache()
    return report


def sbc_at_w_down(torch, csbc, ksbc):
    """B1 and B2 against their plain versions on one segment of
    ``layers.ffn.w_down``'s size (707 788 800 elements, drawn from the
    seed) behind its bisection threshold: counts and keep mask bitwise,
    sums within rtol 1e-6 (both sum in float64: about 3.5 M kept terms
    give a relative error near 3.5e6 x 1.1e-16 = 4e-10, far below
    float32's half ulp of 6e-8, so the two round to the same float32 or
    its neighbour), apply bitwise; then cold times of each against its
    plain version, and the bounds.  Returns the report; raises
    AssertionError."""
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(7)
    n = Q_W_DOWN
    x = torch.randn((1, n), generator=gen, device="cuda") * 1e-3
    thr = csbc.topk_threshold_bisect(x.abs(), csbc.n_keep(n, RATIO))
    got = ksbc.sbc_stats(x, thr)
    want = ksbc.sbc_stats_plain(x, thr)
    if not torch.equal(got[:, 2:], want[:, 2:]):
        raise AssertionError(f"4k w_down: sbc_stats counts {got} vs {want}")
    if not torch.allclose(got[:, :2], want[:, :2], rtol=1e-6, atol=0):
        raise AssertionError(f"4k w_down: sbc_stats sums {got} vs {want}")
    stats_err = float((got[:, :2] - want[:, :2]).abs().max())
    scalars = csbc.group_scalars(thr, want)
    out, res = ksbc.sbc_apply(x, scalars)
    pout, pres = ksbc.sbc_apply_plain(x, scalars)
    if not (torch.equal(out, pout) and torch.equal(res, pres)):
        raise AssertionError("4k w_down: sbc_apply is not bitwise the plain "
                             "version")
    kept = int(want[0, 2] + want[0, 3])
    del out, res, pout, pres
    torch.cuda.empty_cache()
    rec = {"n": n, "kept": kept, "stats": [float(v) for v in want[0]]}
    for name, kern, plain, arg, nbytes, ops in (
            ("sbc_stats", ksbc.sbc_stats, ksbc.sbc_stats_plain, thr,
             4 * n + 4 + 16, 4 * n),
            ("sbc_apply", ksbc.sbc_apply, ksbc.sbc_apply_plain, scalars,
             12 * n + 12, 5 * n)):
        bound_ms, bound_by = bound(nbytes, ops)
        rec[name] = {"ms": cold_ms(torch, lambda: kern(x, arg), iters=5),
                     "plain_ms": cold_ms(torch, lambda: plain(x, arg),
                                         iters=3),
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bytes": nbytes, "ops": ops,
                     "max_abs_err": stats_err if name == "sbc_stats"
                     else 0.0}
        torch.cuda.empty_cache()
    del x, thr, scalars
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def pallas_vs_naive(torch, ts, tm, optim, get_arch, counted, smi):
    """Phase 4k (iii): ``make_train_step`` with ``sgd()`` at qwen1.5-4b's
    full width and depth on the driver's batch shape (32 sequences of
    64 tokens), under ``Runtime(attn_impl="naive")`` and then
    ``"pallas"``, each run drawing its weights afresh from the same seed
    (two resident copies would not fit): the first step's loss and
    gradient norm within rtol 1e-4; B4, B4′ and B4″ launched 40 times each
    a pallas step (counts set to 0 just before the run); then 3 more
    steps timed with the card synchronized.  A third run, naive with
    ``compress_uplink``, times what the SBC uplink adds to a step.
    Returns the report; raises AssertionError."""
    cfg = get_arch(Q_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(8)
    toks = torch.randint(0, 512, (Q_K * Q_SLOT, Q_SEQ + 1), generator=gen,
                         device="cuda", dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous(),
             "weights": torch.ones((Q_K * Q_SLOT, Q_SEQ), device="cuda")}
    report = {}
    for run in ("naive", "pallas", "naive+sbc"):
        impl = run.split("+")[0]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = tm.init(cfg, torch.Generator(device="cuda").manual_seed(0))
        opt = optim.sgd()
        state = ts.TrainState(params, opt.init(params), 0)
        step = ts.make_train_step(cfg, tm.Runtime(attn_impl=impl), opt,
                                  compress_uplink=run.endswith("+sbc"))
        del params
        for fn in counted.values():
            fn.launches = 0
        state, m = step(state, batch, Q_LRS[0])
        first = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(Q_TIMED):
            state, m = step(state, batch, Q_LRS[0])
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / Q_TIMED
        launches = {name: fn.launches for name, fn in counted.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        tokens = Q_K * Q_SLOT * Q_SEQ
        report[run] = {"first": first, "last_loss": float(m["loss"]),
                       "ms_per_step": ms, "tokens_per_s": tokens / ms * 1e3,
                       "peak_gib": peak, "launches": launches}
        log(f"[4k train] (iii) make_train_step sgd {Q_ARCH} full, "
            f"attn_impl={impl}{', compress_uplink' if '+' in run else ''}, "
            f"{Q_K * Q_SLOT} x {Q_SEQ} tokens: first "
            f"step loss {first['loss']:.6f}, grad_norm "
            f"{first['grad_norm']:.6f}; {ms:.1f} ms a step over "
            f"{Q_TIMED} steps after it = {tokens / ms * 1e3:.0f} tokens/s; "
            f"peak device memory {peak:.2f} GiB; launches over "
            f"{1 + Q_TIMED} steps {launches}; {smi}")
        del state, step, m
    want = {name: Q_LAYERS * (1 + Q_TIMED) for name in counted}
    if report["pallas"]["launches"] != want:
        raise AssertionError(f"4k pallas: launches "
                             f"{report['pallas']['launches']}, expected "
                             f"{want}")
    if any(report["naive"]["launches"].values()):
        raise AssertionError("4k naive: an attention kernel was launched")
    sbc_ms = (report["naive+sbc"]["ms_per_step"]
              - report["naive"]["ms_per_step"])
    report["sbc_ms_per_step"] = sbc_ms
    log(f"[4k train] (iii) the SBC uplink of 15 leaves (3.95 B values) adds "
        f"{sbc_ms:.1f} ms to a step (the compressed step's time less the "
        f"plain one's); {smi}")
    for key in ("loss", "grad_norm"):
        a, b = report["pallas"]["first"][key], report["naive"]["first"][key]
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"4k pallas vs naive: first {key} {a} vs "
                                 f"{b} beyond rtol 1e-4")
    gc.collect()
    torch.cuda.empty_cache()
    return report


def _qwen_smoke(torch, tm, get_arch, tree_map, device):
    """Reduced qwen1.5-4b (2 layers, d_model 256) drawn on the CPU from
    seed 0 with its qkv biases set non-zero, then moved to ``device``;
    and the phase's batch (K 2 x slot 2 x 16 tokens, B_k = (1, 2))."""
    cfg = get_arch(Q_ARCH).reduced()
    gen = torch.Generator().manual_seed(0)
    params = tm.init(cfg, gen)
    for name in ("bq", "bk", "bv"):
        b = params["layers"]["attn"][name]
        b.copy_(0.1 * torch.randn(b.shape, generator=gen))
    toks = torch.randint(0, cfg.vocab, (4, 17), generator=gen,
                         dtype=torch.int32)
    w = torch.tensor([1.0, 0.0, 1.0, 1.0])[:, None].expand(4, 16)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "weights": w.contiguous()}
    move = lambda t: t.to(device)  # noqa: E731
    return cfg, tree_map(move, params), tree_map(move, batch)


def _card_cpu_steps(torch, ts, tm, optim, get_arch, tree_map, tree_leaves,
                    opt_name, compress, forced):
    """3 steps of the reduced qwen1.5-4b on the card and on the CPU path
    (``_qwen_smoke``); with ``forced``, each CPU step starts from a copy
    of the card's state (teacher forcing).  Returns the per-step losses
    and SBC keep masks of each device."""
    runs = {}
    for device in ("cuda", "cpu"):
        cfg, params, batch = _qwen_smoke(torch, tm, get_arch, tree_map,
                                         device)
        opt = getattr(optim, opt_name)()
        step = ts.make_train_step(cfg, tm.Runtime(attn_impl="naive"), opt,
                                  compress_uplink=compress)
        runs[device] = [step, batch, ts.TrainState(params, opt.init(params),
                                                   0)]
    losses = {"cuda": [], "cpu": []}
    masks = {"cuda": [], "cpu": []}
    real = ts.sbc_uplink
    copy = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
    for lr in Q_LRS:
        if forced:
            card = runs["cuda"][2]
            runs["cpu"][2] = ts.TrainState(
                tree_map(copy, card.params), tree_map(copy, card.opt),
                card.step, None if card.residual is None
                else tree_map(copy, card.residual))
        for device, (step, batch, state) in runs.items():
            def recording(grads, ratio, residual, out=masks[device]):
                result = real(grads, ratio, residual)
                out.append([(g != 0).cpu() for g in tree_leaves(result[0])])
                return result
            ts.sbc_uplink = recording
            try:
                state, m = step(state, batch, lr)
            finally:
                ts.sbc_uplink = real
            runs[device][2] = state
            losses[device].append(float(m["loss"]))
    return cfg, losses, masks


def train_contracts(torch, np, ts, tm, optim, get_arch, tree_map,
                    tree_leaves, counted):
    """Phase 5i: the reduced qwen1.5-4b through 3 steps of
    ``make_train_step`` on the card and on the port's CPU path, momentum
    and adamw, each with ``compress_uplink`` off and on: losses within
    1e-4, SBC keep masks compared leaf by leaf every step (the flips
    counted and named, not failed on), launches counted on the card.
    AdamW is held teacher-forced — each CPU step from a copy of the
    card's state — because run free the two part after one step: its
    first update is lr·g/(|g| + eps), so an element whose gradient is at
    rounding level moves by up to ±lr on either side of a last-bit gap;
    the free run's gap is printed beside it.  Returns the report; raises
    AssertionError."""
    report = {}
    before = {name: fn.launches for name, fn in counted.items()}
    compressed_runs = 0
    names = _leaf_names(_qwen_smoke(torch, tm, get_arch, tree_map, "cpu")[1])
    for opt_name in ("momentum", "adamw"):
        for compress in (False, True):
            label = f"{opt_name} compress_uplink={compress}"
            forced = opt_name == "adamw"
            args = (torch, ts, tm, optim, get_arch, tree_map, tree_leaves,
                    opt_name, compress)
            runs = [(forced, _card_cpu_steps(*args, forced))]
            if forced:
                runs.append((False, _card_cpu_steps(*args, False)))
            compressed_runs += len(runs) * compress
            rec = {}
            for is_forced, (cfg, losses, masks) in runs:
                card, cpu = np.array(losses["cuda"]), np.array(losses["cpu"])
                flips = {f"step {t + 1} {name}": int((x != y).sum())
                         for t, (a, b) in enumerate(zip(masks["cuda"],
                                                        masks["cpu"]))
                         for name, x, y in zip(names, a, b)
                         if int((x != y).sum())}
                err = float(np.abs(card - cpu).max())
                how = "teacher-forced" if is_forced else "free"
                log(f"[5i card vs cpu] {cfg.name} {label}, 3 steps, {how}: "
                    f"losses {card.tolist()} vs {cpu.tolist()} (max abs err "
                    f"{err:.3g}{', tol 1e-4' if is_forced == forced else ''}"
                    f"); SBC keep-mask flips {flips if compress else 'n/a'}")
                rec[how] = {"loss_max_abs_err": err, "mask_flips": flips}
                if is_forced == forced and not np.allclose(
                        card, cpu, rtol=1e-4, atol=1e-4):
                    raise AssertionError(f"5i {label} ({how}): losses {card}"
                                         f" vs {cpu}")
            report[label] = rec
    launches = {name: fn.launches - before[name]
                for name, fn in counted.items()}
    want = compressed_runs * Q_LEAVES * len(Q_LRS)
    log(f"[5i card vs cpu] launches on the card {launches} (expected {want} "
        f"each)")
    if launches != {name: want for name in counted}:
        raise AssertionError(f"5i: launches {launches}, expected {want} "
                             f"each")
    report["launches"] = launches
    return report


def family_train_contracts(torch, np, ts, tm, optim, get_arch, tree_map,
                           counted):
    """Phase 5j: reduced musicgen-large (4 codebooks) and reduced
    zamba2-7b (two SSM segments, each followed by the shared block)
    through 3 momentum steps of ``make_train_step`` (naive attention, as
    ``launch.train``) on the card and on the port's CPU path, from the
    same seed-0 weights and batch (K 2 x slot 2 x 16 tokens, B_k = (1,
    2)): losses within 1e-4; zamba2's SSD forward and backward (B3, B3′)
    launched once a layer a step on the card.  Returns the report; raises
    AssertionError."""
    report = {}
    for arch in ("musicgen-large", "zamba2-7b"):
        cfg = get_arch(arch).reduced()
        gen = torch.Generator().manual_seed(0)
        params = tm.init(cfg, gen)
        cb = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
        toks = torch.randint(0, cfg.vocab, (4, 17) + cb, generator=gen,
                             dtype=torch.int32)
        w = torch.tensor([1.0, 0.0, 1.0, 1.0])[:, None].expand(4, 16)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                 "weights": w.contiguous()}
        losses = {}
        for device in ("cuda", "cpu"):
            move = lambda t: t.to(device, copy=True)  # noqa: E731
            p = tree_map(move, params)
            opt = optim.momentum(0.9)
            step = ts.make_train_step(cfg, tm.Runtime(attn_impl="naive"),
                                      opt)
            state = ts.TrainState(p, opt.init(p), 0)
            dev_batch = tree_map(move, batch)
            before = {name: fn.launches for name, fn in counted.items()}
            out = []
            for lr in Q_LRS:
                state, m = step(state, dev_batch, lr)
                out.append(float(m["loss"]))
            losses[device] = np.array(out)
            if device == "cuda":
                launches = {name: fn.launches - before[name]
                            for name, fn in counted.items()}
        err = float(np.abs(losses["cuda"] - losses["cpu"]).max())
        ssm_layers = cfg.n_layers if cfg.ssm is not None else 0
        want = {name: ssm_layers * len(Q_LRS) for name in counted}
        log(f"[5j card vs cpu] {cfg.name} momentum, 3 steps: losses "
            f"{losses['cuda'].tolist()} vs {losses['cpu'].tolist()} (max abs "
            f"err {err:.3g}, tol 1e-4); launches on the card {launches} "
            f"(expected {want})")
        if not np.allclose(losses["cuda"], losses["cpu"], rtol=1e-4,
                           atol=1e-4):
            raise AssertionError(f"5j {cfg.name}: losses {losses}")
        if launches != want:
            raise AssertionError(f"5j {cfg.name}: launches {launches}, "
                                 f"expected {want}")
        report[cfg.name] = {"loss_max_abs_err": err, "launches": launches}
    return report


def _leaf_names(params, path=""):
    """Dotted leaf names in tree order (``layers.attn.bq``)."""
    if isinstance(params, dict):
        return [n for k in sorted(params)
                for n in _leaf_names(params[k], f"{path}.{k}".lstrip("."))]
    return [path]


def checkpoint_contract(torch, ts, tm, optim, get_arch, tree_leaves,
                        tree_map, checkpoint):
    """The reduced qwen1.5-4b on the card, momentum with the SBC uplink:
    2 steps, ``save_state`` (the residual as ``extra``), ``restore_state``
    into fresh tensors on the card, parameters, optimizer state and
    residual bitwise; the resumed third step's loss and parameters
    bitwise the uninterrupted run's.  Returns the report; raises
    AssertionError."""
    path = str(OUT_DIR / "smoke_checkpoint.ckpt")
    runs = {}
    for tag in ("straight", "resumed"):
        cfg, params, batch = _qwen_smoke(torch, tm, get_arch, tree_map,
                                         "cuda")
        opt = optim.momentum()
        step = ts.make_train_step(cfg, tm.Runtime(attn_impl="naive"), opt,
                                  compress_uplink=True)
        state = ts.TrainState(params, opt.init(params), 0)
        losses = []
        for t, lr in enumerate(Q_LRS):
            if tag == "resumed" and t == 2:
                checkpoint.save_state(path, state.step, state.params,
                                      state.opt, state.residual)
                like = lambda tree: tree_map(torch.empty_like,  # noqa
                                             tree)
                n, p, o, r = checkpoint.restore_state(
                    path, like(state.params), like(state.opt),
                    like(state.residual))
                if n != 2 or not all(
                        torch.equal(a, b) and a.device == b.device
                        for a, b in zip(tree_leaves((p, o, r)),
                                        tree_leaves((state.params, state.opt,
                                                     state.residual)))):
                    raise AssertionError("checkpoint: the restored state is "
                                         "not bitwise the saved one")
                state = ts.TrainState(p, o, n, r)
            state, m = step(state, batch, lr)
            losses.append(m["loss"])
        runs[tag] = (losses, state.params)
    Path(path).unlink()
    (a_losses, a_params), (b_losses, b_params) = runs["straight"], \
        runs["resumed"]
    same = (torch.equal(a_losses[2], b_losses[2])
            and all(torch.equal(x, y) for x, y in zip(tree_leaves(a_params),
                                                      tree_leaves(b_params))))
    log(f"[5i checkpoint] {cfg.name} momentum + SBC on the card: 2 steps, "
        f"save_state / restore_state bitwise; the resumed third step's "
        f"loss {float(b_losses[2]):.7f} vs {float(a_losses[2]):.7f} "
        f"uninterrupted: {'bitwise' if same else 'DIFFER'} (parameters "
        f"too)")
    if not same:
        raise AssertionError("checkpoint: the resumed step is not bitwise "
                             "the uninterrupted one")
    return {"resumed_bitwise": True, "loss": float(b_losses[2])}


def moe_train_cell(torch, train, ts, tm, optim, get_arch, tree_leaves,
                   counted, smi):
    """Phase 4m, MoE and MLA training at full width: (i)
    ``launch.train.main`` on minicpm3-4b at full width and depth with
    momentum at the driver's defaults (K 4 x slot 8 x 64 tokens), 6
    steps; (ii) ``make_train_step`` with momentum and ``compress_uplink``
    on deepseek-v2-lite-16b at full width with its depth cut to
    ``M4_SBC_LAYERS`` (layer 0 dense, the rest MoE), on the driver's
    batch shape (seeded tokens under its 512-token vocabulary, every
    weight 1), 3 steps: B1 and B2 once a leaf a step.  Each with its
    launch counts (set to 0 just before, read just after), losses (all
    finite), peak memory, wall and tokens/s.  Returns the report; raises
    AssertionError."""
    report = {}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counted.values():
        fn.launches = 0
    argv = ["--arch", M4_TRAIN_ARCH, "--full", "--steps", str(Q_STEPS)]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        final = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses, walls = _train_lines(out.getvalue())
    step_s = ((walls[-1] - walls[0]) / (len(walls) - 1)
              if len(walls) > 1 else float("nan"))
    tokens = Q_K * Q_SLOT * Q_SEQ
    log(f"[4m train] (i) launch.train.main {' '.join(argv)}: {tokens} tokens "
        f"a step; losses {losses}; whole call {wall:.2f} s (init, data, "
        f"{Q_STEPS} steps); about {step_s:.2f} s a step from the driver's "
        f"wall= lines (0.1 s resolution) = {tokens / step_s:.0f} tokens/s; "
        f"peak device memory {peak:.2f} GiB; launches {launches} (expected "
        f"0 each); {smi}")
    if len(losses) != Q_STEPS or not all(map(math.isfinite,
                                             losses + [final])):
        raise AssertionError(f"4m (i): losses {losses}, final {final}")
    if any(launches.values()):
        raise AssertionError(f"4m (i): launches {launches}, expected 0")
    report["minicpm3"] = {"argv": argv, "losses": losses, "wall_s": wall,
                          "step_s_from_driver": step_s, "peak_gib": peak,
                          "tokens_per_step": tokens, "launches": launches}

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch(M4_SBC_ARCH), n_layers=M4_SBC_LAYERS)
    params = tm.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    sizes = sorted((t.numel() for t in leaves), reverse=True)
    opt = optim.momentum(0.9)
    state = ts.TrainState(params, opt.init(params), 0)
    del params
    step = ts.make_train_step(cfg, tm.Runtime(attn_impl="naive"), opt,
                              compress_uplink=True)
    gen = torch.Generator(device="cuda").manual_seed(9)
    toks = torch.randint(0, 512, (Q_K * Q_SLOT, Q_SEQ + 1), generator=gen,
                         device="cuda", dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous(),
             "weights": torch.ones((Q_K * Q_SLOT, Q_SEQ), device="cuda")}
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    for fn in counted.values():
        fn.launches = 0
    losses, aux, times = [], [], []
    for t in range(M4_SBC_STEPS):
        t1 = time.perf_counter()
        state, m = step(state, batch, Q_LRS[t % len(Q_LRS)])
        losses.append(float(m["loss"]))
        aux.append(float(m["total_loss"] - m["loss"]))
        times.append(time.perf_counter() - t1)
    launches = {name: fn.launches for name, fn in counted.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = 1e3 * sum(times[1:]) / max(1, len(times) - 1)
    want = M4_SBC_LEAVES * M4_SBC_STEPS
    log(f"[4m train] (ii) make_train_step momentum + compress_uplink "
        f"{M4_SBC_ARCH} at full width, depth cut from "
        f"{get_arch(M4_SBC_ARCH).n_layers} to {M4_SBC_LAYERS} layers "
        f"({n_params} float32 parameters in {len(leaves)} leaves, the "
        f"largest {sizes[:3]}), {Q_K * Q_SLOT} x {Q_SEQ} tokens: losses "
        f"{losses}, aux {aux}; steps {[round(1e3 * x, 1) for x in times]} "
        f"ms (each waits for its loss) = {ms:.1f} ms a step after the first "
        f"= {tokens / ms * 1e3:.0f} tokens/s; init {t_init:.2f} s; peak "
        f"device memory {peak:.2f} GiB; launches {launches} (expected "
        f"{want} each: one a leaf a step); {smi}")
    if not all(map(math.isfinite, losses + aux)):
        raise AssertionError(f"4m (ii): losses {losses}, aux {aux}")
    if (len(leaves) != M4_SBC_LEAVES or sizes[0] != M4_EXPERT_MATRIX
            or launches != {name: want for name in counted}):
        raise AssertionError(f"4m (ii): {len(leaves)} leaves (largest "
                             f"{sizes[0]}), launches {launches}, expected "
                             f"{want} each")
    report["deepseek_sbc"] = {"n_layers": M4_SBC_LAYERS,
                              "n_params": n_params, "losses": losses,
                              "aux": aux, "step_ms": [1e3 * x for x in times],
                              "ms_per_step": ms,
                              "tokens_per_s": tokens / ms * 1e3,
                              "peak_gib": peak, "launches": launches}
    del state, step, m
    gc.collect()
    torch.cuda.empty_cache()
    return report


def _moe_smoke(torch, tm, get_arch, tree_map, arch):
    """A reduced config drawn on the CPU from seed 0 and the phase's batch
    (K 2 x slot 2 x 16 tokens, B_k = (1, 2))."""
    cfg = get_arch(arch).reduced()
    gen = torch.Generator().manual_seed(0)
    params = tm.init(cfg, gen)
    toks = torch.randint(0, cfg.vocab, (4, 17), generator=gen,
                         dtype=torch.int32)
    w = torch.tensor([1.0, 0.0, 1.0, 1.0])[:, None].expand(4, 16)
    return cfg, params, {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                         "weights": w.contiguous()}


def moe_contracts(torch, np, ts, tm, moe_mod, optim, get_arch, tree_map,
                  tree_leaves):
    """Phase 5k: reduced minicpm3-4b, deepseek-v2-lite-16b and arctic-480b
    through 3 momentum steps of ``make_train_step`` (naive attention, as
    ``launch.train``) on the card, twice, and on the port's CPU path, from
    the same seed-0 weights and batch: losses within 1e-4, the aux loss
    (``total_loss - loss``) within 1e-5, the first step's routing (expert
    indices, capacity positions and keep masks of every MoE layer) equal
    on card and CPU, and the card's two runs bitwise (losses and
    parameters).  Returns the report; raises AssertionError."""
    report = {}
    real = moe_mod.route_scatter
    for arch in K5_ARCHS:
        cfg, params, batch = _moe_smoke(torch, tm, get_arch, tree_map, arch)
        runs = {}
        for run in ("cuda", "cuda again", "cpu"):
            device = run.split()[0]
            move = lambda t: t.to(device, copy=True)  # noqa: E731
            p = tree_map(move, params)
            opt = optim.momentum(0.9)
            step = ts.make_train_step(cfg, tm.Runtime(attn_impl="naive"),
                                      opt)
            state = ts.TrainState(p, opt.init(p), 0)
            dev_batch = tree_map(move, batch)
            routes, losses, aux = [], [], []

            def recording(probs, K, C, out=routes):
                r = real(probs, K, C)
                out.append([r[i].cpu() for i in (0, 2, 3)])
                return r
            for t, lr in enumerate(Q_LRS):
                moe_mod.route_scatter = recording if t == 0 else real
                try:
                    state, m = step(state, dev_batch, lr)
                finally:
                    moe_mod.route_scatter = real
                losses.append(m["loss"].cpu())
                aux.append(m["total_loss"].cpu() - m["loss"].cpu())
            runs[run] = (torch.stack(losses), torch.stack(aux), routes,
                         [t.cpu() for t in tree_leaves(state.params)])
        (card, card_aux, card_routes, card_p), (again, _, _, again_p), \
            (cpu, cpu_aux, cpu_routes, _) = runs.values()
        loss_err = float((card - cpu).abs().max())
        aux_err = float((card_aux - cpu_aux).abs().max())
        routes_equal = len(card_routes) == len(cpu_routes) and all(
            torch.equal(a, b) for ra, rb in zip(card_routes, cpu_routes)
            for a, b in zip(ra, rb))
        bitwise = torch.equal(card, again) and all(
            torch.equal(a, b) for a, b in zip(card_p, again_p))
        n_moe = cfg.n_layers - (cfg.moe.first_dense_layers if cfg.moe else 0)
        log(f"[5k card vs cpu] {cfg.name} momentum, 3 steps: losses "
            f"{card.tolist()} vs {cpu.tolist()} (max abs err {loss_err:.3g}, "
            f"tol 1e-4); aux {card_aux.tolist()} (max abs err {aux_err:.3g}, "
            f"tol 1e-5); first step's routing of {len(card_routes)} MoE "
            f"layers (indices, positions, keep masks) "
            f"{'equal' if routes_equal else 'DIFFER'}; the card's run "
            f"twice: {'bitwise' if bitwise else 'DIFFER'}")
        if not (np.allclose(card.numpy(), cpu.numpy(), rtol=1e-4, atol=1e-4)
                and aux_err <= 1e-5 and routes_equal and bitwise
                and len(card_routes) == (n_moe if cfg.moe else 0)):
            raise AssertionError(f"5k {cfg.name}: losses {loss_err:.3g}, aux "
                                 f"{aux_err:.3g}, routes equal "
                                 f"{routes_equal}, bitwise {bitwise}")
        report[cfg.name] = {"loss_max_abs_err": loss_err,
                            "aux_max_abs_err": aux_err,
                            "aux": card_aux.tolist(),
                            "routes_equal": routes_equal,
                            "card_bitwise_twice": bitwise}
    return report


def _row_line(tag, r, smi):
    mem = r["memory"]["peak_bytes"]
    return (f"[4n {tag}] {r['arch']} x {r['shape']}, {r['dtype']}, batch "
            f"{r['batch']}, reduced {r['reduced']}: {r['ms_per_step']:.1f} "
            f"ms a step (median of {r['repeats']}; {r['ms_min']:.1f}-"
            f"{r['ms_max']:.1f}; first step {r['first_step_s']:.2f} s) = "
            f"{r['tokens_per_s']:.1f} tokens/s; peak {mem / 2**30:.2f} GiB; "
            f"FLOPs counted {r['counted_flops']:.4g} + kernels "
            f"{sum(r['kernel_flops'].values()):.4g} = {r['flops']:.4g}, "
            f"model {r['model_flops_total']:.4g} (useful ratio "
            f"{r['useful_flops_ratio']:.3f}), MFU {r['mfu']:.4f}; launches "
            f"in the counted (first) step {r['launches']}; {smi}")


def _zero(counted):
    for fn in counted.values():
        fn.launches = 0


def _read(counted):
    return {name: fn.launches for name, fn in counted.items()}


def _loss_and_grads(torch, ts, tm, tree_leaves, tree_unflatten, cfg, rt,
                    params, batch):
    """The train step's objective (CE + aux) and its gradients, one
    parameter set (a copy axis of 1 inside)."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        req = [t.detach().requires_grad_() for t in leaves]
        views = tm._one_copy(tree_unflatten(params, req))
        total = ts.make_loss_fn(cfg, rt)(views, tm._one_copy(batch))[0]
        grads = torch.autograd.grad(total, req)
    return total.detach(), grads


def production_cell(torch, F, dryrun, perf, ts, tm, get_arch, get_shape,
                    tree_leaves, tree_unflatten, counted, kfa, smi):
    """Phase 4n: the reference's production runtime (``runtime_for``)
    through ``launch.dryrun.run_pair`` at full width, every run's kernel
    counts set to 0 just before it and read just after: (i) train_4k on
    qwen1.5-4b at full depth under the perf variants ``N_TRAIN_VARIANTS``
    (no kernel: blockwise and flash-jnp attention are plain PyTorch), and
    the remat step's loss and every gradient bitwise the no-remat step's
    at ``N_REMAT_LAYERS``; (ii) prefill_32k on qwen1.5-4b at
    ``N_PREFILL_LAYERS`` under blockwise and under ``"pallas"`` (B4 in
    bf16: 4 launches a step) with the two variants' logits compared, and
    mamba2-2.7b at full depth (B3 in bf16 at N 128: 64 a step); B4 at one
    layer against its plain arithmetic (:func:`production_attention`);
    (iii) decode_32k on qwen1.5-4b at batch 4, 16 steps from pos 32752
    under ``"pallas"`` (B5 in bf16: 40 a step) and under blockwise (the
    plain decode attention).  B3 and B5 at these shapes are checked and
    timed with the other cases of phases 3c, 3d and 6.  Returns the
    report; raises AssertionError."""
    report = {"train": {}, "prefill": {}}
    train_shape = get_shape("train_4k")
    cfg = get_arch(N_ARCH)
    # (i) training at full depth
    for variant in N_TRAIN_VARIANTS:
        rt, opt, zero1 = perf.build(variant, cfg, train_shape)
        _zero(counted)
        r = dryrun.run_pair(N_ARCH, "train_4k", rt=rt, opt=opt,
                            zero1=zero1, repeats=N_TRAIN_REPEATS)
        r["launches_run"] = _read(counted)
        if any(r["launches_run"].values()):
            raise AssertionError(f"4n train {variant}: a kernel launched "
                                 f"{r['launches_run']}")
        report["train"][variant] = r
        log(_row_line(f"(i) train {variant}", r, smi))
    base = report["train"]["baseline"]
    for variant in N_TRAIN_VARIANTS[1:]:
        r = report["train"][variant]
        peak = r["memory"]["peak_bytes"] / base["memory"]["peak_bytes"]
        log(f"[4n (i) train] {variant} against baseline: ms "
            f"{r['ms_per_step'] / base['ms_per_step'] - 1:+.1%}, peak "
            f"{peak - 1:+.1%}, FLOPs {r['flops'] / base['flops'] - 1:+.1%}")
    # remat == no remat, bitwise, where no remat fits
    cut = dataclasses.replace(cfg, n_layers=N_REMAT_LAYERS)
    rt = dryrun.runtime_for(cfg, train_shape)
    gen = torch.Generator(device="cuda").manual_seed(11)
    params = tm.init(cut, gen, rt.dtype)
    toks = torch.randint(0, cfg.vocab, (1, train_shape.seq_len + 1),
                         generator=gen, device="cuda", dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous(),
             "weights": torch.ones((1, train_shape.seq_len), device="cuda")}
    runs = {}
    for remat in (True, False):
        torch.cuda.reset_peak_memory_stats()
        runs[remat] = _loss_and_grads(
            torch, ts, tm, tree_leaves, tree_unflatten, cut,
            dataclasses.replace(rt, remat=remat), params, batch)
        torch.cuda.synchronize()
        runs[remat] += (torch.cuda.max_memory_allocated() / 2**30,)
    same = (torch.equal(runs[True][0], runs[False][0])
            and all(torch.equal(a, b)
                    for a, b in zip(runs[True][1], runs[False][1])))
    report["remat_bitwise"] = {"layers": N_REMAT_LAYERS, "equal": same,
                               "loss": float(runs[True][0]),
                               "peak_gib": {"remat": runs[True][2],
                                            "no_remat": runs[False][2]}}
    log(f"[4n (i) train] remat vs no remat at {N_ARCH}'s full width, "
        f"{N_REMAT_LAYERS} of {cfg.n_layers} layers, bf16, one "
        f"{train_shape.seq_len}-token sequence: loss "
        f"{float(runs[True][0]):.6f} and all {len(runs[True][1])} gradients "
        f"{'bitwise equal' if same else 'DIFFER'}; peak {runs[True][2]:.2f} "
        f"GiB with remat, {runs[False][2]:.2f} without; {smi}")
    if not same:
        raise AssertionError("4n: the remat step is not bitwise the no-remat "
                             "step")
    del params, runs, batch, toks
    # (ii) prefill
    pre_shape = get_shape("prefill_32k")
    steps = N_PREFILL_REPEATS + 1
    for key, arch, layers, impl, kernel, per_step in (
            ("blockwise", N_ARCH, N_PREFILL_LAYERS, "blockwise", None, 0),
            ("pallas", N_ARCH, N_PREFILL_LAYERS, "pallas",
             "flash_attention_fwd", N_PREFILL_LAYERS),
            ("mamba2", N_SSM_ARCH, 0, "blockwise", "ssd_scan_fwd",
             get_arch(N_SSM_ARCH).n_layers)):
        acfg = get_arch(arch)
        rt = dataclasses.replace(dryrun.runtime_for(acfg, pre_shape),
                                 attn_impl=impl)
        _zero(counted)
        r = dryrun.run_pair(arch, "prefill_32k", rt=rt, layers=layers,
                            repeats=N_PREFILL_REPEATS)
        r["launches_run"] = _read(counted)
        want = {name: (per_step * steps if name == kernel else 0)
                for name in counted}
        if r["launches_run"] != want:
            raise AssertionError(f"4n prefill {key}: launches "
                                 f"{r['launches_run']}, expected {want}")
        report["prefill"][key] = r
        log(_row_line(f"(ii) prefill {key}", r, smi))
    # the two attention variants' logits, from one set of weights
    cut = dataclasses.replace(cfg, n_layers=N_PREFILL_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(12)
    params = tm.init(cut, gen, torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (1, pre_shape.seq_len),
                           generator=gen, device="cuda", dtype=torch.int32)
    rt = dryrun.runtime_for(cfg, pre_shape)
    with torch.inference_mode():
        chunked = ts.make_prefill_step(cut, rt)(params, {"tokens": tokens})
        kernel = ts.make_prefill_step(
            cut, dataclasses.replace(rt, attn_impl="pallas"))(
                params, {"tokens": tokens})
        gap = max(float((a[..., :cfg.vocab].float()
                         - b[..., :cfg.vocab].float()).abs().max())
                  for a, b in zip(chunked.split(4096, dim=1),
                                  kernel.split(4096, dim=1)))
        scale = float(chunked[..., :cfg.vocab].abs().max())
    report["prefill"]["logits_gap"] = {"max_abs": gap, "max_logit": scale}
    log(f"[4n (ii) prefill] {N_ARCH} at {N_PREFILL_LAYERS} layers, one "
        f"{pre_shape.seq_len}-token sequence: logits under pallas (B4) vs "
        f"blockwise max abs diff {gap:.4g} (max |logit| {scale:.4g})")
    del params, chunked, kernel, tokens
    gc.collect()
    torch.cuda.empty_cache()
    report["kernels"] = production_attention(torch, F, kfa, smi)
    # (iii) decode: runtime_for's blockwise picks the plain decode
    # attention, "pallas" B5
    report["decode"] = {}
    dec_shape = get_shape("decode_32k")
    for impl, kernel in (("blockwise", None), ("pallas", "flash_decode")):
        multi = impl == "pallas"          # phase 4q reads its 2x16x16 row
        rt = dataclasses.replace(dryrun.runtime_for(cfg, dec_shape, multi),
                                 attn_impl=impl)
        _zero(counted)
        r = dryrun.run_pair(N_ARCH, "decode_32k", rt=rt, multi_pod=multi,
                            batch=N_DECODE_BATCH, repeats=N_DECODE_STEPS - 1)
        r["launches_run"] = _read(counted)
        want = {name: (cfg.n_layers * N_DECODE_STEPS if name == kernel
                       else 0) for name in counted}
        if r["launches_run"] != want:
            raise AssertionError(f"4n decode {impl}: launches "
                                 f"{r['launches_run']}, expected {want}")
        report["decode"][impl] = r
        log(_row_line(f"(iii) decode {impl}", r, smi))
    return report


def production_attention(torch, F, kfa, smi):
    """B4 in bf16 at phase 4n's qwen1.5-4b prefill_32k layer against its
    plain version's arithmetic within :func:`bf16_tols`: float32 scores,
    softmax and P·V over the same bf16 values, rounded once to bf16, by
    ``attend_chunked`` at block_q 512 on their float32 copies (the plain
    forward's 32768² scores do not fit; ``attend_chunked`` in bf16 rounds
    the probabilities to bf16 before P·V, as the reference's blockwise
    path does, which B4 does not).  With its cold-L2 time beside the
    bound and ``scaled_dot_product_attention``.  (B3 and B5 at phase
    4n's shapes are cases of :func:`ssd_checks`, :func:`ssd_times`,
    :func:`decode_checks` and :func:`decode_times`.)"""
    from repro_torch.models.attention import attend_chunked
    gen = torch.Generator(device="cuda").manual_seed(13)
    b, s, hq, hkv, hd = N_ATTN
    q, k, v = attention_inputs(torch, gen, b, s, hq, hkv, hd, torch.bfloat16)
    qf, kf, vf = (t.float() for t in (q, k, v))
    pos = torch.arange(s, device="cuda")

    def plain():
        return attend_chunked(qf, kf, vf, pos, pos, block_q=512).to(q.dtype)

    got, want = kfa.flash_attention_fwd(q, k, v)[0], plain()
    err = float((got.float() - want.float()).abs().max())
    rtol, atol = bf16_tols(want)
    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"4n: B4 at {N_ATTN} bf16 beyond rtol {rtol}, "
                             f"atol {atol:.3g} of attend_chunked (max abs "
                             f"err {err:.3g})")
    bound_ms, bound_by, nbytes, ops = attention_bound(torch, q, k, True,
                                                      None)
    t = {"shape": list(N_ATTN), "dtype": "bfloat16", "max_abs_err": err,
         "atol": atol,
         "ms": cold_ms(torch, lambda: kfa.flash_attention_fwd(q, k, v),
                       iters=5),
         "plain_ms": cold_ms(torch, plain, iters=3),
         "library_ms": cold_ms(torch, sdpa_call(torch, F, q, k, v, True,
                                                None), iters=5),
         "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
         "ops": ops}
    del q, k, v, qf, kf, vf, got, want
    torch.cuda.empty_cache()
    log(f"[4n kernels] flash_attention_fwd at {N_ATTN}, bf16: max abs err "
        f"{err:.3g} vs attend_chunked in f32 on the same values, rounded "
        f"to bf16 (rtol {rtol}, atol {atol:.3g}); "
        f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}), "
        f"scaled_dot_product_attention {t['library_ms']:.4f} ms; {smi}")
    return {"flash_attention_fwd": t}


def _o_launches_ok(name, got, cfg, steps, attention):
    """Phase 4o's launch counts of a run of ``steps`` train steps: B3'
    once an SSM layer a step; B3 at least as often (twice under remat:
    the forward runs again in the backward); with ``attention`` (the
    hybrid's shared block under "pallas") B4' and B4'' once an
    application a step, B4 at least as often; no other kernel."""
    n_ssm = cfg.n_layers
    n_attn = n_ssm // cfg.hybrid_every if attention else 0
    bad = [k for k, n in got.items()
           if k not in ("ssd_scan_fwd", "ssd_scan_bwd",
                        "flash_attention_fwd", "flash_attention_bwd_dq",
                        "flash_attention_bwd_dkdv") and n]
    ok = (not bad and got["ssd_scan_bwd"] == n_ssm * steps
          and n_ssm * steps <= got["ssd_scan_fwd"] <= 2 * n_ssm * steps
          and got["flash_attention_bwd_dq"] == n_attn * steps
          and got["flash_attention_bwd_dkdv"] == n_attn * steps
          and n_attn * steps <= got["flash_attention_fwd"]
          <= 2 * n_attn * steps)
    if not ok:
        raise AssertionError(f"4o {name}: launches {got}, expected B3' "
                             f"{n_ssm * steps}, B4'/B4'' {n_attn * steps}")


def _o_smoke(torch, tm, get_arch, arch, dtype):
    """Phase 4o (iv)'s reduced config (mamba2-2.7b at d_state 128: 4 B3'
    units a sequence; zamba2-7b at head dim 112), drawn on the CPU from
    seed 0 in ``dtype``, and a batch of 4 sequences of O_CPU_SEQ tokens
    (B_k = (1, 2): one weight row 0)."""
    cfg = get_arch(arch).reduced()
    if cfg.family == "ssm":
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, d_state=128))
    else:
        cfg = dataclasses.replace(cfg, head_dim=112)
    gen = torch.Generator().manual_seed(0)
    params = tm.init(cfg, gen, dtype)
    toks = torch.randint(0, cfg.vocab, (4, O_CPU_SEQ + 1), generator=gen,
                         dtype=torch.int32)
    w = torch.tensor([1.0, 0.0, 1.0, 1.0])[:, None].expand(4, O_CPU_SEQ)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "weights": w.contiguous()}
    return cfg, params, batch


def ssm_train_cell(torch, np, train, dryrun, ts, tm, optim, get_arch,
                   get_shape, tree_map, counted, smi):
    """Phase 4o, SSM and hybrid training on the card, each run's kernel
    counts set to 0 just before it and read just after: (i)
    ``launch.train.main`` on mamba2-2.7b at full width and depth, f32,
    momentum at the driver's defaults, O_STEPS steps (B3 and B3' at N 128
    over 80 heads of 64: 40 B3' units a sequence); (ii) train_4k through
    ``run_pair`` under ``runtime_for`` (bf16, blockwise, remat) on
    mamba2-2.7b at full depth and zamba2-7b at O_LAYERS' depth, one
    4096-token sequence;
    (iii) zamba2-7b's train_4k step under ``"pallas"`` (B4, B4' and B4''
    at (1, 4096, 32, 32, 112) in bf16), and its first loss against
    blockwise's from the same weights and tokens within
    :func:`bf16_tols`; (iv) the card against the port's CPU path, 3
    momentum steps, reduced mamba2-2.7b at d_state 128 and reduced
    zamba2-7b at head dim 112 under the kernels, f32 (losses within 1e-4)
    and bf16 under ``runtime_for`` (within 2e-2).  Returns the report;
    raises AssertionError."""
    report = {}
    # (i) the training driver, f32
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", O_TRAIN_ARCH, "--full", "--steps", str(O_STEPS)]
    out = io.StringIO()
    _zero(counted)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        final = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read(counted)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses, walls = _train_lines(out.getvalue(), "4o train")
    step_s = ((walls[-1] - walls[0]) / (len(walls) - 1)
              if len(walls) > 1 else float("nan"))
    tokens = Q_K * Q_SLOT * Q_SEQ
    cfg = get_arch(O_TRAIN_ARCH)
    log(f"[4o train] (i) launch.train.main {' '.join(argv)}: f32, "
        f"{tokens} tokens a step; losses {losses}; whole call {wall:.2f} s "
        f"(init, data, {O_STEPS} steps); about {1e3 * step_s:.0f} ms a step "
        f"from the driver's wall= lines (0.1 s resolution) = "
        f"{tokens / step_s:.0f} tokens/s; peak device memory {peak:.2f} GiB;"
        f" launches {launches} = B3 {launches['ssd_scan_fwd'] / O_STEPS:g}, "
        f"B3' {launches['ssd_scan_bwd'] / O_STEPS:g} a step; {smi}")
    if len(losses) != O_STEPS or not all(map(math.isfinite,
                                             losses + [final])):
        raise AssertionError(f"4o (i): losses {losses}, final {final}")
    _o_launches_ok("(i)", launches, cfg, O_STEPS, False)
    report["train"] = {"argv": argv, "losses": losses, "wall_s": wall,
                       "ms_per_step_from_driver": 1e3 * step_s,
                       "tokens_per_step": tokens, "peak_gib": peak,
                       "launches": launches}
    # (ii) and (iii): the production runtime's train step
    shape = get_shape("train_4k")
    report["train_4k"] = {}
    for key, arch, impl in (("mamba2", O_TRAIN_ARCH, "blockwise"),
                            ("zamba2", O_HYBRID_ARCH, "blockwise"),
                            ("zamba2_pallas", O_HYBRID_ARCH, "pallas")):
        acfg = get_arch(arch)
        rt = dataclasses.replace(dryrun.runtime_for(acfg, shape),
                                 attn_impl=impl)
        _zero(counted)
        r = dryrun.run_pair(arch, "train_4k", rt=rt, repeats=O_REPEATS,
                            layers=O_LAYERS[arch])
        r["launches_run"] = _read(counted)
        tag = "(ii)" if impl == "blockwise" else "(iii)"
        report["train_4k"][key] = r
        log(_row_line(f"{tag} train {key}", r, smi).replace("[4n ", "[4o "))
        _o_launches_ok(f"{tag} {key}", r["launches_run"],
                       dataclasses.replace(acfg, n_layers=O_LAYERS[arch]
                                           or acfg.n_layers),
                       1 + O_REPEATS, impl == "pallas")
    # (iii) the first loss under pallas against blockwise's
    cfg = get_arch(O_HYBRID_ARCH)
    rt = dryrun.runtime_for(cfg, shape)
    gen = torch.Generator(device="cuda").manual_seed(14)
    params = tm.init(cfg, gen, rt.dtype)
    toks = torch.randint(0, cfg.vocab, (1, shape.seq_len + 1),
                         generator=gen, device="cuda", dtype=torch.int32)
    batch = tm._one_copy({"tokens": toks[:, :-1].contiguous(),
                          "labels": toks[:, 1:].contiguous(),
                          "weights": torch.ones((1, shape.seq_len),
                                                device="cuda")})
    first = {}
    with torch.no_grad():
        for impl in ("blockwise", "pallas"):
            first[impl] = ts.make_loss_fn(
                cfg, dataclasses.replace(rt, attn_impl=impl))(
                    tm._one_copy(params), batch)[0].float()
    rtol, atol = bf16_tols(first["blockwise"])
    gap = float((first["pallas"] - first["blockwise"]).abs())
    report["first_loss"] = {k: float(v) for k, v in first.items()}
    report["first_loss"].update(gap=gap, rtol=rtol, atol=atol)
    log(f"[4o (iii) train] {O_HYBRID_ARCH} x train_4k, bf16, one "
        f"{shape.seq_len}-token sequence: first loss under pallas "
        f"{float(first['pallas']):.6f} vs blockwise "
        f"{float(first['blockwise']):.6f} (abs diff {gap:.3g}; rtol {rtol}, "
        f"atol {atol:.3g})")
    if not torch.allclose(first["pallas"], first["blockwise"], rtol=rtol,
                          atol=atol):
        raise AssertionError(f"4o (iii): first loss {report['first_loss']}")
    del params, toks, batch, first
    gc.collect()
    torch.cuda.empty_cache()
    # (iv) the card against the CPU path
    report["card_vs_cpu"] = {}
    for arch in (O_TRAIN_ARCH, O_HYBRID_ARCH):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            cfg, params, batch = _o_smoke(torch, tm, get_arch, arch, dtype)
            rt = (tm.Runtime(attn_impl="pallas") if dtype == torch.float32
                  else dataclasses.replace(dryrun.runtime_for(cfg, shape),
                                           attn_impl="pallas"))
            losses = {}
            for device in ("cuda", "cpu"):
                move = lambda t: t.to(device, copy=True)  # noqa: E731
                p = tree_map(move, params)
                opt = optim.momentum(0.9)
                step = ts.make_train_step(cfg, rt, opt)
                state = ts.TrainState(p, opt.init(p), 0)
                dev_batch = tree_map(move, batch)
                _zero(counted)
                out = []
                for lr in Q_LRS:
                    state, m = step(state, dev_batch, lr)
                    out.append(float(m["loss"]))
                losses[device] = np.array(out)
                if device == "cuda":
                    launches = _read(counted)
            err = float(np.abs(losses["cuda"] - losses["cpu"]).max())
            label = (f"{cfg.name} {str(dtype).split('.')[-1]} "
                     f"(N {cfg.ssm.d_state}, hd {cfg.hd() if cfg.n_heads else '-'})")
            log(f"[4o (iv) card vs cpu] {label}, momentum, 3 steps of "
                f"{O_CPU_SEQ}-token sequences: losses "
                f"{losses['cuda'].tolist()} vs {losses['cpu'].tolist()} (max "
                f"abs err {err:.3g}, tol {tol}); launches on the card "
                f"{launches}")
            if not np.allclose(losses["cuda"], losses["cpu"], rtol=tol,
                               atol=tol):
                raise AssertionError(f"4o (iv) {label}: losses {losses}")
            _o_launches_ok(f"(iv) {label}", launches, cfg, len(Q_LRS),
                           cfg.family == "hybrid")
            report["card_vs_cpu"][label] = {"loss_max_abs_err": err,
                                            "tol": tol,
                                            "launches": launches}
    return report


def ssd_bwd_work(ins, dy):
    """Bytes (each input read once, each output written once, in its
    input's type) and operations of one SSD backward at any S: the dual
    form within 16-token segments (:func:`ssd_work`'s terms over each
    segment's token pairs) and, where S > 16, the boundary terms, 10 a
    (token, row, n) (the carry's B product and x.gB, h_start.C and dy.hC,
    dC's and dB's boundary sums, the carry) and pass 1's segment-end state,
    34 a (segment, row, n)."""
    x, dt, a, bm, cm = ins
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    size = lambda t: t.numel() * t.element_size()  # noqa: E731
    nbytes = 2 * sum(map(size, ins)) + size(dy)
    segs = [min(16, s - t0) for t0 in range(0, s, 16)]
    pairs = b * sum(t * (t + 1) // 2 for t in segs)
    ops = pairs * h * (4 * p + 8) + pairs * g * 4 * n + b * s * h * (p + 4)
    if len(segs) > 1:
        ops += b * s * h * p * n * 10 + b * (len(segs) - 1) * h * p * n * 34
    return nbytes, ops


def _bf16_outputs_close(torch, names, got, plain, label):
    """bf16 outputs within :func:`bf16_tols` of the plain versions (the
    float32 ones, ddt, dA and D, within the same); returns the max abs
    err over them."""
    worst = 0.0
    for name, a, p in zip(names, got, plain):
        rtol, atol = bf16_tols(p)
        err = float((a.float() - p.float()).abs().max())
        if a.dtype != p.dtype or not torch.allclose(a.float(), p.float(),
                                                    rtol=rtol, atol=atol):
            raise AssertionError(f"{label} {name}: {a.dtype} beyond rtol "
                                 f"{rtol}, atol {atol:.3g} of the plain "
                                 f"version (max abs err {err:.3g})")
        worst = max(worst, err)
    return worst


def train_ssd_rows(torch, kssd):
    """B3' at phase 4o's train_4k layers (:data:`O_SSD`), f32 and bf16 (x,
    Bm, Cm, dy in bf16, dt and A f32): against its plain version (f32:
    within O_SSD_TOL of it and of it run in float64, :func:`close_to_plain`;
    bf16: :func:`bf16_tols` against the plain float32 arithmetic on the
    same bf16 values, rounded once), run twice bitwise, and the sequence
    alone bitwise the same sequence among O_AMONG (each its own copy of A);
    its cold-L2 time (CUDA events and the profiler's card time), the plain
    version's, the bound of :func:`ssd_bwd_work` and the kernels'
    resources.  Returns the rows; raises AssertionError."""
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(15)
    names = ("dx", "ddt", "dA", "dBm", "dCm")
    for arch, (_, s, h, p, g, n, chunk) in O_SSD.items():
        for dtype in (torch.float32, torch.bfloat16):
            label = f"6 B3' {arch} {(1, s, h, p, g, n)} {dtype}"
            ins, dy = ssd_inputs(torch, gen, O_AMONG, 1, s, h, p, g, n)
            if dtype == torch.bfloat16:
                ins = tuple(t if i in (1, 2) else t.bfloat16()
                            for i, t in enumerate(ins))
                dy = dy.bfloat16()
            one = tuple(t[:1] for t in ins)

            def kern(one=one, dy=dy):
                return kssd.ssd_scan_bwd(*one, dy[:1], chunk=chunk)

            def plain(one=one, dy=dy):
                return kssd.ssd_scan_bwd_plain(*one, dy[:1], chunk=chunk)

            got = kern()
            if not all(torch.equal(a, b) for a, b in zip(got, kern())):
                raise AssertionError(f"{label}: two runs differ")
            among = kssd.ssd_scan_bwd(*ins, dy, chunk=chunk)
            if not all(torch.equal(a, m[:1]) for a, m in zip(got, among)):
                raise AssertionError(f"{label}: the sequence alone is not "
                                     f"bitwise itself among {O_AMONG}")
            del among
            want = plain()
            row = {"shape": [1, s, h, p, g, n], "dtype": str(dtype)[6:]}
            if dtype == torch.float32:
                exact = kssd.ssd_scan_bwd_plain(
                    *(t.double() for t in one), dy[:1].double(), chunk=chunk)
                # the least rtol = atol at which each output holds against
                # float64: the kernel's, and the float32 plain version's
                row["tol_needed"], row["plain_tol_needed"] = (max(
                    float(((a.double() - e).abs() / (1 + e.abs())).max())
                    for a, e in zip(outs, exact)) for outs in (got, want))
                errs = [close_to_plain(torch, a, w, e, O_SSD_TOL,
                                       f"{label} {name}")
                        for name, a, w, e in zip(names, got, want, exact)]
                row.update(max_abs_err=max(e[0] for e in errs),
                           vs_f64=max(e[1] for e in errs),
                           plain_vs_f64=max(e[2] for e in errs),
                           left_out=sum(e[3] for e in errs), tol=O_SSD_TOL)
                del exact
            else:
                row.update(max_abs_err=_bf16_outputs_close(
                    torch, names, got, want, label), tol="bf16_tols")
            nbytes, ops = ssd_bwd_work(one, dy[:1])
            rate = (BF16_OPS_PER_S if dtype == torch.bfloat16
                    else F32_OPS_PER_S)
            bound_ms, bound_by = bound(nbytes, ops, rate)
            row.update(
                ms=cold_ms(torch, kern, iters=5),
                device_ms=device_ms(torch, kern, "ssd_bwd_kernel",
                                    iters=5)[0],
                plain_ms=cold_ms(torch, plain, iters=3), library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=ops,
                units=kssd.bwd_units(h, p, g, n),
                resources=kssd.bwd_resources(h, p, g, n, dtype, s))
            rows[f"{arch}_{row['dtype']}"] = row
            del ins, dy, one, got, want
            gc.collect()
            torch.cuda.empty_cache()
    return rows


def train_attention_rows(torch, F, kfa):
    """B4, B4' and B4'' at zamba2-7b's shared block (:data:`O_ATTN`, head
    dim 112) in f32 and bf16, and at qwen1.5-4b's step shape
    (:data:`Q_SHAPE`) in bf16, causal: each against its plain version
    (f32: the forward within 2e-5, dq, D, dk and dv within O_ATTN_TOL;
    bf16: :func:`bf16_tols`), the three run twice bitwise, and the
    sequence alone bitwise the same sequence among O_AMONG; cold-L2 times
    (CUDA events and the profiler's card time), the plain versions', the
    bounds, ``scaled_dot_product_attention``'s forward, forward + backward
    and backward alone, and the instances' resources.  Returns the rows by
    (shape, dtype), each with the three kernels; raises AssertionError."""
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(16)
    for shape, dtype in ((O_ATTN, torch.float32), (O_ATTN, torch.bfloat16),
                         (Q_SHAPE, torch.bfloat16)):
        b, s, hq, hkv, hd = shape
        label = f"6 attention {shape} {dtype}"
        q, k, v = attention_inputs(torch, gen, O_AMONG, s, hq, hkv, hd,
                                   dtype)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)

        def three(q, k, v, do):
            o, lse = kfa.flash_attention_fwd(q, k, v)
            dq, dsum = kfa.flash_attention_bwd_dq(q, k, v, o, lse, do)
            return (o, lse, dq, dsum,
                    *kfa.flash_attention_bwd_dkdv(q, k, v, lse, do, dsum))

        among = three(q, k, v, do)
        q, k, v, do = (t[:b].contiguous() for t in (q, k, v, do))
        got = three(q, k, v, do)
        if not all(torch.equal(a, m[:b]) for a, m in zip(got, among)):
            raise AssertionError(f"{label}: the sequence alone is not "
                                 f"bitwise itself among {O_AMONG}")
        del among
        if not all(torch.equal(a, c) for a, c in zip(got, three(q, k, v,
                                                                 do))):
            raise AssertionError(f"{label}: two runs differ")
        o, lse, dq, dsum, dk, dv = got
        po, plse = kfa.flash_attention_fwd_plain(q, k, v)
        pdq, pdsum = kfa.flash_attention_bwd_dq_plain(q, k, v, o, lse, do)
        pdk, pdv = kfa.flash_attention_bwd_dkdv_plain(q, k, v, lse, do, dsum)
        # (kernel, output, plain, tolerance): f32 outputs within a fixed
        # tolerance (lse and D in bf16 runs too: both sides compute them
        # in float32 from the same values), bf16 ones within bf16_tols
        bf = dtype == torch.bfloat16
        checks = (("flash_attention_fwd", o, po, None if bf else 2e-5),
                  ("flash_attention_fwd", lse, plse, 2e-5),
                  ("flash_attention_bwd_dq", dq, pdq,
                   None if bf else O_ATTN_TOL),
                  ("flash_attention_bwd_dq", dsum, pdsum, O_ATTN_TOL),
                  ("flash_attention_bwd_dkdv", dk, pdk,
                   None if bf else O_ATTN_TOL),
                  ("flash_attention_bwd_dkdv", dv, pdv,
                   None if bf else O_ATTN_TOL))
        errs = dict.fromkeys(("flash_attention_fwd", "flash_attention_bwd_dq",
                              "flash_attention_bwd_dkdv"), 0.0)
        for name, a, p, tol in checks:
            rtol, atol = bf16_tols(p) if tol is None else (tol, tol)
            err = float((a.float() - p.float()).abs().max())
            if a.dtype != p.dtype or not torch.allclose(
                    a.float(), p.float(), rtol=rtol, atol=atol):
                raise AssertionError(f"{label} {name}: beyond rtol {rtol}, "
                                     f"atol {atol:.3g} of the plain version "
                                     f"(max abs err {err:.3g})")
            errs[name] = max(errs[name], err)
        del po, plse, pdq, pdsum, pdk, pdv
        qt, kt, vt, dot = (t.transpose(1, 2).contiguous()
                           for t in (q, k, v, do))
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
                lambda: kfa.flash_attention_fwd_plain(q, k, v), sdpa_fwd,
                attention_bound(torch, q, k, True, None), "fwd_kernel"),
            "flash_attention_bwd_dq": (
                lambda: kfa.flash_attention_bwd_dq(q, k, v, o, lse, do),
                lambda: kfa.flash_attention_bwd_dq_plain(q, k, v, o, lse,
                                                         do),
                sdpa_fwd_bwd, dq_bound(torch, q, k, True, None),
                "dq_kernel"),
            "flash_attention_bwd_dkdv": (
                lambda: kfa.flash_attention_bwd_dkdv(q, k, v, lse, do, dsum),
                lambda: kfa.flash_attention_bwd_dkdv_plain(q, k, v, lse, do,
                                                           dsum),
                sdpa_fwd_bwd, dkdv_bound(torch, q, k, True, None),
                "dkdv_kernel")}
        res_of = {"flash_attention_fwd": kfa.fwd_resources,
                  "flash_attention_bwd_dq": kfa.dq_resources,
                  "flash_attention_bwd_dkdv": kfa.dkdv_resources}
        library_bwd_ms = cold_ms(torch, sdpa_bwd, iters=5)
        key = f"{'x'.join(map(str, shape))}_{str(dtype)[6:]}"
        rows[key] = {}
        for name, (kern, plain, lib, bnd, kname) in runs.items():
            rows[key][name] = {
                "shape": list(shape), "dtype": str(dtype)[6:],
                "max_abs_err": errs[name],
                "tol": ("bf16_tols" if bf else 2e-5
                        if name == "flash_attention_fwd" else O_ATTN_TOL),
                "ms": cold_ms(torch, kern, iters=5),
                "device_ms": device_ms(torch, kern, kname, iters=5)[0],
                "plain_ms": cold_ms(torch, plain, iters=3),
                "library_ms": cold_ms(torch, lib, iters=5),
                "bound_ms": bnd[0], "bound_by": bnd[1], "bytes": bnd[2],
                "ops": bnd[3], "resources": res_of[name](hd, dtype)}
            if name != "flash_attention_fwd":
                rows[key][name]["library_bwd_ms"] = library_bwd_ms
        del q, k, v, do, got, leaves, graph
        gc.collect()
        torch.cuda.empty_cache()
    return rows


P_PERIODS = 3                 # phase 4p's audited run of the main cell
P_ZERO_LENGTHS = (786_432, 2_560)   # 4p(iv)'s SBC segments (main-cell leaves)


def _audit_summary(report):
    """Per bucket program of an ``AuditReport``: its taint summary and its
    hygiene summary, by program name."""
    return {name: (prog, report.programs.get(f"{name}/hygiene", {}))
            for name, prog in report.programs.items()
            if prog["pass"] == "taint"}


def audit_cell(env, specs, counted, all_kernels, csbc, ksbc, smi):
    """Phase 4p: the static analysis (``repro_torch.analysis``) on the
    card.  (i) The main cell's grid through ``Experiment.run(periods=3,
    audit=True)``: the report ok, its buckets' certified reductions,
    ledger events and probe seconds; B1/B2 launch 6 a period (the probe
    launches nothing); losses and ledgers bitwise the same run without
    ``audit``; both walls.  (ii) 4i's service tape with ``audit=True``:
    every cold admission probed once before it dispatches, no warm one
    probed, the report ok, the launches 4i's.  (iii) ``python -m
    repro_torch.analysis.audit`` (default grid, run on the card) exits 0
    with every program certified.  (iv) The SBC stand-ins' rule on the
    card: segments of exact zeros give exact zeros in the stats, the
    approximation and the residual, and every other segment is bitwise
    itself run alone.  Raises AssertionError."""
    torch, np = env.torch, env.np
    out = {}
    fields = ("losses", "accs", "times", "global_batch")
    # (i) the main cell, audited against unaudited
    exp = env.Experiment(env.data, env.test, specs)
    exp.run(P_PERIODS)                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = exp.run(P_PERIODS)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    for fn in counted.values():
        fn.launches = 0
    from repro_torch.analysis import AuditError
    t0 = time.perf_counter()
    try:
        audited = exp.run(P_PERIODS, audit=True)
    except AuditError as exc:
        raise AssertionError(f"4p (i): {exc}") from exc
    torch.cuda.synchronize()
    t_audit = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    want = {name: len(LEAF_LENGTHS) * P_PERIODS for name in counted}
    report = audited.audit
    bitwise = all(np.array_equal(getattr(audited, f), getattr(plain, f))
                  for f in fields)
    ledger = report.programs["trace-ledger"]
    buckets = _audit_summary(report)
    for name, (prog, hyg) in buckets.items():
        log(f"[4p (i) audit] bucket {name}: ok {prog['ok']}, "
            f"{prog['n_certified_reductions']} certified reductions over "
            f"{prog['n_eqns']} graph nodes, {prog['periods_traced']} period "
            f"traced (induction), probe {prog['probe_seconds']:.3f} s; "
            f"hygiene: {hyg.get('n_x64_leaks')} 64-bit leaks, "
            f"{hyg.get('n_int64_intermediates')} int64 intermediates; {smi}")
    log(f"[4p (i) audit] Experiment.run(periods={P_PERIODS}, audit=True) on "
        f"the main cell ({audited.rows} rows x K {DEVICES}, 3072-dim data, "
        f"SBC {RATIO}): report ok {report.ok}, {len(report.errors())} "
        f"errors, {len(report.warnings())} warnings; ledger "
        f"{ledger['n_traces']} events, {ledger['n_retraces']} retraces; "
        f"launches {launches} (expected {want}); losses and ledgers "
        f"bitwise the unaudited run: {'yes' if bitwise else 'NO'}; wall "
        f"{t_audit:.3f} s audited vs {t_plain:.3f} s without "
        f"(+{t_audit - t_plain:.3f} s); {smi}")
    if not (report.ok and bitwise and launches == want
            and ledger["n_retraces"] == 0 and buckets):
        raise AssertionError(f"4p (i): report ok {report.ok}, bitwise "
                             f"{bitwise}, launches {launches} (expected "
                             f"{want}), retraces {ledger['n_retraces']}")
    out["main"] = {"ok": report.ok, "bitwise": bitwise,
                   "launches": launches, "wall_audit_s": t_audit,
                   "wall_plain_s": t_plain, "ledger": ledger,
                   "buckets": {n: {"taint": p, "hygiene": h}
                               for n, (p, h) in buckets.items()}}
    # (ii) the service tape, audited: one probe a cold admission
    from repro_torch.serve import ExperimentService, ProgramCache
    probes, colds = [], []
    audit_cold, admit = ExperimentService._audit_cold, ProgramCache.admit

    def counting_audit(self, bucket, chunk_len):
        t1 = time.perf_counter()
        audit_cold(self, bucket, chunk_len)
        probes.append(time.perf_counter() - t1)

    def counting_admit(self, keys):
        hits, misses = admit(self, keys)
        colds.append(misses > 0)
        return hits, misses
    ExperimentService._audit_cold = counting_audit
    ProgramCache.admit = counting_admit
    try:
        svc, tickets, groups, s, wall, t_warm, launches, want = _drive_tape(
            env, all_kernels, audit=True)
    except AuditError as exc:
        raise AssertionError(f"4p (ii): {exc}") from exc
    finally:
        ExperimentService._audit_cold = audit_cold
        ProgramCache.admit = admit
    report = svc.audit_report
    n_cold = sum(colds)
    log(f"[4p (ii) service audit] 4i's tape with audit=True: "
        f"{len(colds)} admissions (warm-up included), {n_cold} cold, each "
        f"probed once before dispatch ({len(probes)} probes, "
        f"{sum(probes):.3f} s, {max(probes):.3f} s the longest), "
        f"{len(colds) - n_cold} warm with no probe; report ok {report.ok} "
        f"over {len(_audit_summary(report))} programs; tape {wall:.3f} s "
        f"(warm-up {t_warm:.2f} s); launches {launches} (expected {want}); "
        f"{smi}")
    if not (report.ok and len(probes) == n_cold and launches == want
            and all(t.done for t in tickets)
            and s["warm_admission_traces"] == 0):
        raise AssertionError(f"4p (ii): report ok {report.ok}, {len(probes)}"
                             f" probes for {n_cold} cold admissions, "
                             f"launches {launches} (expected {want})")
    out["service"] = {"admissions": len(colds), "cold": n_cold,
                      "probe_s": probes, "tape_s": wall, "ok": report.ok,
                      "launches": launches}
    # (iii) the audit CLI, its executed run on the card
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.audit", "--out",
         str(OUT_DIR / "AUDIT_report.json")], capture_output=True, text=True,
        timeout=900, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    t_cli = time.perf_counter() - t0
    for line in cli.stdout.splitlines():
        _Log.file.write(f"[4p (iii) cli] {line}\n")
    js = json.loads((OUT_DIR / "AUDIT_report.json").read_text()) \
        if cli.returncode in (0, 1) else {}
    taint_progs = {n: p for n, p in js.get("programs", {}).items()
                   if p["pass"] == "taint"}
    models = [n for n in taint_progs if n.startswith("models:")]
    log(f"[4p (iii) cli] python -m repro_torch.analysis.audit (users "
        f"4,8,16, periods 3, replan 2, the run on the card): exit "
        f"{cli.returncode} in {t_cli:.1f} s; "
        f"{cli.stdout.strip().splitlines()[0] if cli.stdout else ''}; "
        f"{sum(p['ok'] for p in taint_progs.values())} of "
        f"{len(taint_progs)} programs certified ({len(models)} models "
        f"programs: {sum(taint_progs[n]['ok'] for n in models)} ok); {smi}")
    if cli.returncode != 0 or not taint_progs or not models \
            or not all(p["ok"] for p in taint_progs.values()):
        raise AssertionError(f"4p (iii): the audit CLI exited "
                             f"{cli.returncode}: {cli.stderr[-2000:]}")
    out["cli"] = {"rc": cli.returncode, "seconds": t_cli,
                  "programs": len(taint_progs), "models": len(models),
                  "summary": cli.stdout.strip().splitlines()[0]}
    # (iv) the SBC stand-ins' rule on the card
    gen = torch.Generator(device="cuda").manual_seed(4)
    segs = ROWS * DEVICES
    zero = torch.arange(segs, device="cuda") % 3 == 1   # every third one
    for n in P_ZERO_LENGTHS:
        x = torch.randn((segs, n), generator=gen, device="cuda")
        x[zero] = 0.0
        thr = csbc.topk_threshold_bisect(x.abs(), csbc.n_keep(n, RATIO))
        stats = ksbc.sbc_stats(x, thr)
        scalars = csbc.group_scalars(thr, stats)
        approx, res = ksbc.sbc_apply(x, scalars)
        zeros_hold = not (stats[zero].any() or approx[zero].any()
                          or res[zero].any())
        alone = all(
            torch.equal(ksbc.sbc_stats(x[i:i + 1], thr[i:i + 1]),
                        stats[i:i + 1])
            and all(torch.equal(a, b[i:i + 1]) for a, b in zip(
                ksbc.sbc_apply(x[i:i + 1], scalars[i:i + 1]),
                (approx, res)))
            for i in (0, 2, segs - 1))
        log(f"[4p (iv) stand-ins] sbc_stats / sbc_apply on the card at "
            f"({segs}, {n}), {int(zero.sum())} segments exact zeros: stats, "
            f"approximation and residual exact zeros there: "
            f"{'yes' if zeros_hold else 'NO'}; segments 0, 2 and {segs - 1}"
            f" alone bitwise themselves among {segs}: "
            f"{'yes' if alone else 'NO'}")
        if not (zeros_hold and alone):
            raise AssertionError(f"4p (iv): the SBC stand-in rule fails on "
                                 f"the card at n={n}")
    log("[4p (iv) stand-ins] the attention and SSD stand-ins' rules (axis 0 "
        "independent; zero dO / dy give zero gradients) rest on phase 3's "
        "and 3c's checks: a sequence alone bitwise itself among the batch "
        "(forward, dQ with D, dK/dV) and a copy alone bitwise itself among "
        "8 (the SSD backward)")
    out["stand_ins"] = {"lengths": list(P_ZERO_LENGTHS), "segments": segs}
    return out


def mesh_cell(env, specs, api, dryrun, perf, get_arch, counted,
              n_decode_row, smi):
    """Phase 4q: the mesh half of ``launch`` and the batch mesh over
    several devices.  (i) For every assigned arch at full width and every
    shape, on the 16 × 16 and 2 × 16 × 16 production meshes (abstract:
    host only), the sharding rules' count of sharded leaves and
    ``argument_bytes_per_device`` (with ``zero1`` too on train shapes):
    every sharded dim exists (``sharded_arguments`` raises otherwise),
    per-device bytes <= whole, ``zero1`` lowers them on train shapes.
    (ii) 4n's ``run_pair(N_ARCH, "decode_32k", multi_pod=True)`` row under
    ``"pallas"`` (``n_decode_row``): its ``mesh`` is ``2x16x16``, its
    runtime's ``moe_shard_axes`` the reference's multi-pod axes and B5
    launched 40 times a step; ``perf.main([... "--multi-pod"])`` on
    train_4k at ``Q_PERF_LAYERS`` layers, baseline and zero1.  (iii)
    :func:`batch_mesh_cell` over two entries of the card.  ``counted``:
    B1 and B2.  Raises AssertionError."""
    import torch
    from repro_torch.configs import ASSIGNED, SHAPES
    from repro_torch.launch.mesh import Mesh, make_production_mesh
    out = {"sizing": {}}
    # (i) sizing on the production meshes
    t0 = time.perf_counter()
    for arch in ASSIGNED:
        cfg = get_arch(arch)
        for shape_name, shape in SHAPES.items():
            row = {}
            for mesh_name in Q_MESHES:
                multi = mesh_name == "2x16x16"
                mesh = make_production_mesh(multi_pod=multi)
                rt = dryrun.runtime_for(cfg, shape, multi)
                sized = {"base": dryrun.sharded_arguments(cfg, shape, rt,
                                                          mesh)}
                if shape.mode == "train":
                    sized["zero1"] = dryrun.sharded_arguments(
                        cfg, shape, rt, mesh, zero1=True)
                for key, r in sized.items():
                    if not (0 < r["argument_bytes_per_device"]
                            <= r["argument_bytes"]):
                        raise AssertionError(
                            f"4q (i) {arch} x {shape_name} x {mesh_name} "
                            f"{key}: {r}")
                if "zero1" in sized and not (
                        sized["zero1"]["argument_bytes_per_device"]
                        < sized["base"]["argument_bytes_per_device"]):
                    raise AssertionError(f"4q (i) {arch} x {shape_name} x "
                                         f"{mesh_name}: zero1 {sized}")
                row[mesh_name] = sized
            out["sizing"][f"{arch} x {shape_name}"] = row
            base = row["16x16"]["base"]

            def gib(r):
                return f"{r['argument_bytes_per_device'] / 2**30:.4f}"
            log(f"[4q (i) sizing] {arch} x {shape_name}: "
                f"{base['sharded_leaves']} of {base['leaves']} leaves "
                f"sharded, {base['argument_bytes'] / 2**30:.3f} GiB whole; "
                "a device: " + "; ".join(
                    f"{m} {gib(row[m]['base'])} GiB"
                    + (f" (zero1 {gib(row[m]['zero1'])})"
                       if "zero1" in row[m] else "") for m in Q_MESHES))
    out["sizing_s"] = time.perf_counter() - t0
    log(f"[4q (i) sizing] {len(out['sizing'])} (arch, shape) pairs x "
        f"{len(Q_MESHES)} meshes sized in {out['sizing_s']:.2f} s (host "
        "only; every sharded dim exists, per-device <= whole, zero1 "
        "lower on every train shape)")
    # (ii) the drivers under multi_pod: 4n's pallas decode ran with it
    cfg = get_arch(N_ARCH)
    r = n_decode_row
    want = {name: (cfg.n_layers * N_DECODE_STEPS if name == "flash_decode"
                   else 0) for name in r["launches_run"]}
    log(f"[4q (ii) decode pallas multi_pod] 4n's {N_ARCH} decode_32k "
        f"pallas row: mesh {r['mesh']}, "
        f"{r['memory']['argument_bytes_per_device']} argument bytes a "
        f"device, moe_shard_axes {r['runtime']['moe_shard_axes']}, "
        f"launches {r['launches_run']} (expected {want}); {smi}")
    if (r["mesh"] != "2x16x16" or r["launches_run"] != want
            or r["runtime"]["moe_shard_axes"] != str(("pod", "data"))):
        raise AssertionError(f"4q (ii): mesh {r['mesh']}, launches "
                             f"{r['launches_run']} (expected {want}), "
                             f"runtime {r['runtime']}")
    rows_file = OUT_DIR / "perf_multi_pod.jsonl"
    rows_file.unlink(missing_ok=True)
    perf.main(["--arch", N_ARCH, "--shape", "train_4k", "--variants",
               "baseline,zero1", "--layers", str(Q_PERF_LAYERS),
               "--multi-pod", "--out", str(rows_file)])
    rows = [json.loads(line) for line in rows_file.read_text().splitlines()]
    if (len(rows) != 2 or any("error" in x or x["mesh"] != "2x16x16"
                              for x in rows)
            or not (rows[1]["memory"]["argument_bytes_per_device"]
                    < rows[0]["memory"]["argument_bytes_per_device"])):
        raise AssertionError(f"4q (ii) perf --multi-pod: {rows}")
    out["perf_multi_pod"] = rows
    log(f"[4q (ii) perf --multi-pod] {N_ARCH} x train_4k at "
        f"{Q_PERF_LAYERS} layers: baseline / zero1 "
        + " / ".join(f"{x['ms_per_step']:.1f}" for x in rows)
        + " ms a step, arguments a device of 2x16x16 "
        + " / ".join(f"{x['memory']['argument_bytes_per_device'] / 2**30:.3f}"
                     for x in rows) + f" GiB; {smi}")
    gc.collect()
    torch.cuda.empty_cache()
    # (iii) the batch mesh: two entries of the one card
    card = torch.device("cuda", torch.cuda.current_device())
    out["batch_mesh"] = batch_mesh_cell(env, specs, api, counted, smi,
                                        Mesh((card, card)))
    return out


def batch_mesh_cell(env, specs, api, counted, smi, mesh, device=None,
                    strict=True, keep=None):
    """The batch mesh over ``mesh``'s devices (entries of one card, or
    several cards): the main cell, a 3-row ragged bucket (padded to the
    mesh), ``AsyncExecutor(mesh=)`` on the main cell and a short
    ``ExperimentService(mesh=)`` tape (against its admission group's
    twin), each against ``SerialExecutor`` on the experiment's card alone
    (ledgers bitwise, losses and accuracies within ``Q_TOL``), its B1/B2
    launches (``counted``) checked and its wall beside the serial one's.
    ``device="cpu"`` rehearses it on the port's CPU path with a mesh of
    ``cpu`` entries.  ``strict=False`` records a gap beyond ``Q_TOL``
    instead of raising on it; ``keep`` (a dict), when given, receives
    each run's ``Results`` (the service's as a list, ticket by ticket).
    Raises AssertionError."""
    import torch
    from repro_torch.serve import ExperimentService, ProgramCache
    from repro_torch.testing import VirtualClock
    np = env.np
    out = {}
    where = describe_mesh(mesh)

    def sync():
        if device is None:
            for d in set(mesh.devices):
                torch.cuda.synchronize(d)
    fields = ("times", "global_batch")
    ragged = [_service_specs(env, partition=p, seeds=(0,), name=f"K{k}",
                             fleet=fleet(env.DeviceProfile, k))
              for p, k in zip(("iid", "noniid", "iid"), Q_RAGGED_K)]
    runs = (("main cell, MeshExecutor", specs, api.MeshExecutor(mesh)),
            ("ragged 3 rows, MeshExecutor", ragged, api.MeshExecutor(mesh)),
            ("main cell, AsyncExecutor", specs, api.AsyncExecutor(mesh=mesh)))
    serial_runs = {}
    for label, run_specs, executor in runs:
        exp = env.Experiment(env.data, env.test, run_specs, device=device)
        key = id(run_specs)
        if key not in serial_runs:
            exp.run(1)                                  # warm-up
            sync()
            t0 = time.perf_counter()
            serial_runs[key] = (exp.run(PERIODS,
                                        executor=env.SerialExecutor()),
                                None)
            sync()
            serial_runs[key] = (serial_runs[key][0],
                                time.perf_counter() - t0)
        serial, serial_wall = serial_runs[key]
        exp.run(1, executor=executor)                    # warm-up
        sync()
        _zero(counted)
        t0 = time.perf_counter()
        res = exp.run(PERIODS, executor=executor)
        sync()
        wall = time.perf_counter() - t0
        launches = _read(counted)
        buckets = exp.lower()
        if len(buckets) != 1:
            raise AssertionError(f"4q (iii) {label}: {len(buckets)} "
                                 "buckets, expected one")
        n = len(buckets[0].rows)
        shards = mesh.size
        want = {name: (len(LEAF_LENGTHS) * PERIODS * shards
                       if name in ("sbc_stats", "sbc_apply") else 0)
                for name in counted}
        gaps = {f: float(np.abs(getattr(res, f) - getattr(serial, f)).max())
                for f in ("losses", "accs")}
        bitwise = all(np.array_equal(getattr(res, f), getattr(serial, f))
                      for f in fields)
        within = max(gaps.values()) <= Q_TOL
        out[label] = {
            "rows": n, "padded_to": n + (-n) % shards, "wall_s": wall,
            "serial_wall_s": serial_wall, "launches": launches,
            "ledgers_bitwise": bitwise, "max_abs_gap": gaps,
            "within_tol": within}
        if keep is not None:
            keep[label] = res
        log(f"[4q (iii) batch mesh] {label}: {n} rows padded to "
            f"{n + (-n) % shards} over {where}, {PERIODS} "
            f"periods in {wall:.3f} s = {1e3 * wall / PERIODS:.1f} "
            f"ms/period against SerialExecutor on the card alone "
            f"{serial_wall:.3f} s = {1e3 * serial_wall / PERIODS:.1f} "
            f"ms/period; ledgers bitwise: {'yes' if bitwise else 'NO'}; "
            f"max |gap| losses {gaps['losses']:.3g}, accuracies "
            f"{gaps['accs']:.3g} (tol {Q_TOL}"
            f"{'' if within else ', MISSED'}); launches {launches} "
            f"(expected {want}); {smi}")
        if not bitwise or launches != want or (strict and not within):
            raise AssertionError(f"4q (iii) {label}: ledgers bitwise "
                                 f"{bitwise}, gaps {gaps}, launches "
                                 f"{launches} (expected {want})")
    # a short service tape over the mesh against SerialExecutor twins
    tape = [_service_specs(env, partition="iid", seeds=(0, 1)),
            _service_specs(env, partition="noniid", seeds=(2,)),
            _service_specs(env, partition="iid", seeds=(3,),
                           name=f"K{Q_RAGGED_K[-1]}",
                           fleet=fleet(env.DeviceProfile, Q_RAGGED_K[-1]))]
    svc = ExperimentService(env.data, env.test, device=device, mesh=mesh,
                            chunk_periods=Q_SERVICE_CHUNK,
                            clock=VirtualClock(),
                            cache=ProgramCache(shared=False))
    _zero(counted)
    t0 = time.perf_counter()
    tickets = [svc.submit(spec, periods=Q_SERVICE_PERIODS) for spec in tape]
    svc.drain()
    sync()
    wall = time.perf_counter() - t0
    launches = _read(counted)
    # the admission group's twin: its rows in one bucket, unsharded
    t0 = time.perf_counter()
    twin = env.Experiment(env.data, env.test, tape, device=device).run(
        Q_SERVICE_PERIODS,
        executor=env.SerialExecutor(chunk_periods=Q_SERVICE_CHUNK))
    sync()
    serial_wall = time.perf_counter() - t0
    gaps = {"losses": 0.0, "accs": 0.0}
    bitwise, row = True, 0
    for ticket, spec in zip(tickets, tape):
        got, take = ticket.result(), slice(row, row + len(spec.seeds))
        row += len(spec.seeds)
        bitwise &= all(np.array_equal(getattr(got, f),
                                      getattr(twin, f)[take])
                       for f in fields)
        for f in gaps:
            gaps[f] = max(gaps[f], float(np.abs(
                getattr(got, f) - getattr(twin, f)[take]).max()))
    s = svc.stats.to_dict()
    within = max(gaps.values()) <= Q_TOL
    out["service"] = {
        "tickets": len(tickets), "admissions": s["admissions"],
        "wall_s": wall, "serial_twin_wall_s": serial_wall,
        "launches": launches, "ledgers_bitwise": bitwise,
        "max_abs_gap": gaps, "within_tol": within}
    if keep is not None:
        keep["service"] = [t.result() for t in tickets]
    log(f"[4q (iii) batch mesh] ExperimentService(mesh=) tape over "
        f"{where}: "
        f"{len(tickets)} tickets ({[len(sp.seeds) for sp in tape]} rows, "
        f"K {[sp.k for sp in tape]}), {s['admissions']} admissions, "
        f"{Q_SERVICE_PERIODS} periods in chunks of {Q_SERVICE_CHUNK}, in "
        f"{wall:.3f} s against its admission group's SerialExecutor twin "
        f"on the card alone {serial_wall:.3f} s; ledgers bitwise: "
        f"{'yes' if bitwise else 'NO'}; max |gap| losses "
        f"{gaps['losses']:.3g}, accuracies {gaps['accs']:.3g} (tol "
        f"{Q_TOL}{'' if within else ', MISSED'}); launches {launches}; "
        f"{smi}")
    # every admission dispatches one shard an entry of the mesh
    want = {name: (s["admissions"] * len(LEAF_LENGTHS) * Q_SERVICE_PERIODS
                   * mesh.size if name in ("sbc_stats", "sbc_apply") else 0)
            for name in counted}
    if not bitwise or launches != want or (strict and not within):
        raise AssertionError(f"4q (iii) service: ledgers bitwise {bitwise},"
                             f" gaps {gaps}, launches {launches} (expected "
                             f"{want})")
    return out




def sharded_cell(torch, ts, tm, optim, dryrun, get_arch, get_shape, counted,
                 smi, device="cuda", cells=None, seq=None, ctx=None):
    """Phase 4r: the sharded step on one card — a one-rank world (NCCL on
    the card, gloo on the CPU) on a (1, 1) ``("data", "model")`` mesh,
    every argument a DTensor, against the same step on plain tensors, for
    each cell of ``R_CELLS`` (arch at full width, depth cut): (i)
    train_4k under ``attn_impl="pallas"`` for ``R_TRAIN_STEPS`` steps,
    baseline and ZeRO-1 (``place_state``) as the cell asks, losses and
    parameters bitwise; (ii) where the cell asks, decode_32k for
    ``R_DECODE_STEPS`` steps, logits and caches bitwise.  Each run's
    kernel counts are set to 0 just before it and read just after, and
    must be equal.  ``cells`` ((cfg, variants, decode) triples), ``seq``
    and ``ctx`` cut the shapes (the CPU check of this function).  Tears
    its world down.  Returns the report by arch; raises
    AssertionError."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import init_world, make_device_mesh
    from repro_torch.tree import tree_leaves_with_path, tree_map
    cells = cells or [(dataclasses.replace(get_arch(a), n_layers=n), v, d)
                      for a, n, v, d in R_CELLS]
    train_shape, dec_shape = get_shape("train_4k"), get_shape("decode_32k")
    seq, ctx = seq or train_shape.seq_len, ctx or dec_shape.seq_len
    leaves = lambda tree: [t for _, t in tree_leaves_with_path(tree)]  # noqa
    same = lambda a, b: all(torch.equal(x, y)                           # noqa
                            for x, y in zip(leaves(a), leaves(b)))
    sync = ((lambda: torch.cuda.synchronize()) if device == "cuda"
            else (lambda: None))

    def run_cell(mesh, cfg, variants, decode):
        report = {"train": {}, "decode": {}}
        # (i) train_4k under the flash kernels
        rt = dataclasses.replace(dryrun.runtime_for(cfg, train_shape),
                                 attn_impl="pallas")
        gen = torch.Generator(device=device).manual_seed(41)
        params0 = tm.init(cfg, gen, rt.dtype)
        toks = torch.randint(0, cfg.vocab, (1, seq + 1), generator=gen,
                             device=device, dtype=torch.int32)
        batch = {"tokens": toks[:, :-1].contiguous(),
                 "labels": toks[:, 1:].contiguous(),
                 "weights": torch.ones((1, seq), device=device)}
        opt = optim.momentum(0.9)
        for name in ("unsharded",) + tuple(variants):
            params = tree_map(torch.clone, params0)
            if name == "unsharded":
                state, b = ts.TrainState(params, opt.init(params), 0), batch
            else:
                state = ts.place_state(params, opt, mesh,
                                       zero1=name == "zero1")
                b = shd.place(batch, shd.batch_shardings(mesh, batch))
            step = ts.make_train_step(cfg, rt, opt)
            losses, times = [], []
            _zero(counted)
            for _ in range(R_TRAIN_STEPS):
                sync()
                t0 = time.perf_counter()
                state, m = step(state, b, 1e-2)
                sync()
                times.append(1e3 * (time.perf_counter() - t0))
                losses.append(m["loss"])
            report["train"][name] = {
                "losses": torch.stack(losses), "launches": _read(counted),
                "params": shd.gather(state.params), "ms": times}
            del state, params
        base = report["train"]["unsharded"]
        for name in variants:
            r = report["train"][name]
            r["bitwise"] = (torch.equal(r["losses"], base["losses"])
                            and same(r["params"], base["params"]))
            if not r["bitwise"] or r["launches"] != base["launches"] \
                    or (device == "cuda" and not any(r["launches"].values())):
                raise AssertionError(
                    f"4r {cfg.name} train {name}: losses "
                    f"{r['losses'].tolist()} vs {base['losses'].tolist()}, "
                    f"bitwise {r['bitwise']}, launches {r['launches']} vs "
                    f"{base['launches']}")
        for name, r in report["train"].items():
            log(f"[4r (i) train_4k] {cfg.name}, {cfg.n_layers} layers, "
                f"pallas, one {seq}-token sequence, {name}: ms a step "
                f"{[round(t, 1) for t in r['ms']]}, losses "
                f"{r['losses'].tolist()}, launches {r['launches']}"
                + (f", losses and all {len(leaves(r['params']))} parameters "
                   f"after {R_TRAIN_STEPS} steps bitwise the unsharded step's"
                   if name != "unsharded" else "") + f"; {smi}")
        for r in report["train"].values():
            del r["params"]
            r["losses"] = r["losses"].tolist()
        del params0, batch, toks
        if not decode:
            return report
        # (ii) decode_32k under B5 (and the Mamba-2 step on DTensor caches)
        rt = dataclasses.replace(dryrun.runtime_for(cfg, dec_shape),
                                 attn_impl="pallas")
        params = tm.init(cfg, gen, rt.dtype)
        cache0 = tm.init_cache(cfg, R_DECODE_BATCH, ctx, rt, device=device)
        for name, t in cache0.items():
            if name != "pos":
                t.normal_(generator=gen)
        cache0["pos"].fill_(ctx - R_DECODE_STEPS)
        tokens = torch.randint(0, cfg.vocab,
                               (R_DECODE_STEPS, R_DECODE_BATCH, 1),
                               generator=gen, device=device,
                               dtype=torch.int32)
        serve = ts.make_serve_step(cfg, rt)
        for name in ("unsharded", "sharded"):
            cache = tree_map(torch.clone, cache0)
            p = params
            if name == "sharded":
                p = shd.place(params, shd.params_shardings(mesh, params))
                cache = shd.place(cache, shd.cache_shardings(mesh, cache))
            logits, times = [], []
            _zero(counted)
            with torch.no_grad():
                for tok in tokens:
                    if name == "sharded":
                        tok = shd.place({"t": tok}, shd.batch_shardings(
                            mesh, {"t": tok}))["t"]
                    sync()
                    t0 = time.perf_counter()
                    out, cache = serve(p, cache, tok)
                    sync()
                    times.append(1e3 * (time.perf_counter() - t0))
                    logits.append(shd.gather({"l": out})["l"])
            report["decode"][name] = {
                "logits": torch.stack(logits), "cache": shd.gather(cache),
                "launches": _read(counted), "ms": times}
            del cache, p
        base, r = report["decode"]["unsharded"], report["decode"]["sharded"]
        r["bitwise"] = (torch.equal(r["logits"], base["logits"])
                        and same(r["cache"], base["cache"]))
        attn_layers = {"ssm": 0, "hybrid": cfg.n_layers // max(
            cfg.hybrid_every, 1)}.get(cfg.family, cfg.n_layers)
        want = attn_layers * R_DECODE_STEPS if device == "cuda" else 0
        if not r["bitwise"] or r["launches"] != base["launches"] or \
                r["launches"].get("flash_decode") != want:
            raise AssertionError(
                f"4r {cfg.name} decode: bitwise {r['bitwise']}, launches "
                f"{r['launches']} vs {base['launches']} (flash_decode {want} "
                "expected)")
        for name, d in report["decode"].items():
            log(f"[4r (ii) decode_32k] {cfg.name}, {cfg.n_layers} layers, "
                f"pallas, batch {R_DECODE_BATCH}, {R_DECODE_STEPS} steps up "
                f"to slot {ctx - 1} of {ctx}, {name}: ms a step "
                f"{[round(t, 2) for t in d['ms']]}, launches {d['launches']}"
                + (", logits and caches bitwise the unsharded run's"
                   if name == "sharded" else "") + f"; {smi}")
        for d in report["decode"].values():
            del d["logits"], d["cache"]
        return report

    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        init_world("nccl" if device == "cuda" else "gloo",
                   init_method=f"file://{tmp}/rendezvous", rank=0,
                   world_size=1)
        try:
            mesh = make_device_mesh((1, 1))
            for cfg, variants, decode in cells:
                t0 = time.perf_counter()
                report[cfg.name] = run_cell(mesh, cfg, variants, decode)
                report[cfg.name]["wall_s"] = time.perf_counter() - t0
                log(f"[4r cell] {cfg.name} at {cfg.n_layers} layers: "
                    f"{report[cfg.name]['wall_s']:.1f} s")
        finally:
            dist.destroy_process_group()
    return report


def describe_mesh(mesh) -> str:
    """``"2 entries of cuda:0"`` or ``"4 cards (cuda:0, ...)"``."""
    devices = [str(d) for d in mesh.devices]
    if len(set(devices)) == 1:
        return f"{len(devices)} entries of {devices[0]}"
    return f"{len(devices)} cards ({', '.join(devices)})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace two periods with torch.profiler")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

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
        from repro_torch.launch import serve, train
        from repro_torch import checkpoint, optim
        from repro_torch.fed import train_step as ts
        from repro_torch.models import model as tm
        from repro_torch.models import moe as moe_mod
        from repro_torch.fed import engine
        from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
        from repro_torch.configs import get_shape
        from repro_torch.launch import dryrun, perf
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
        f"bf16 fwd {attn_errs['bf16_fwd']:.3g} (rtol 2e-2, atol 2e-2 of "
        f"the mean |o|), dq "
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
        f"fwd {ssd_errs['bf16_fwd']:.3g} (rtol 2e-2, atol 2e-2 of the mean "
        f"|y|; dt f32; at phase 4n's {N_SSD} "
        f"{ssd_errs['prod_bf16_fwd']:.3g}); bwd "
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
    t0 = time.perf_counter()
    try:
        ring_errs = ring_part_checks(torch, kfd)
        torch.cuda.synchronize()
    except AssertionError as exc:
        return fail(f"phase 3d: {exc}")
    log(f"[3d kernels] flash decode on parts of a ring of {D_RING} slots "
        f"(off, ring): windows {D_RING_WINDOWS}, pos {D_RING_POS}, "
        f"{D_RING_PARTS} parts, (B, Hq, Hkv, hd) {D_RING_SHAPES}, f32 and "
        f"bf16, {ring_errs['cases']} cases: each part's o max abs err "
        f"{ring_errs['part']:.3g} (tol 2e-5; bf16 "
        f"{ring_errs['part_bf16']:.3g}, bf16_tols), lse "
        f"{ring_errs['lse']:.3g} (tol 1e-4) vs the plain version; the "
        f"parts merged by their lse vs the whole ring's call "
        f"{ring_errs['merged']:.3g} (bf16 {ring_errs['merged_bf16']:.3g}); "
        f"off 0 and the ring's length bitwise the call without them; "
        f"{time.perf_counter() - t0:.1f} s")
    dec_errs["ring_parts"] = ring_errs
    log(f"[3d kernels] flash decode at {D_SHAPE} (B, ctx, Hq, Hkv, hd) at "
        f"pos {D_POS}, 0 and {D_CTX - 1}, the runs' seams {D_SEAMS} "
        f"(B, ctx, Hq, Hkv, hd, pos, window), ring buffers (pos 100 and 1000 "
        f"in 256 slots, pos 700 with window 128), hd 64 at g 1, 4 and 8, ctx "
        f"1000 (pos 999 and 5000), hd 112 at {D_ZAMBA} and its seams "
        f"{D_SEAMS_112}, g 48 at {D_GRANITE}, hd 64 MHA at {D_MUSICGEN}, "
        f"g 7 at {D_ARCTIC} (pos {D_POS}, 31, 32 and 33), {N_DECODE} at "
        f"pos {N_DECODE[1] - 1}: max "
        f"abs err {dec_errs['flash_decode']:.3g} (tol 2e-5; hd 112 "
        f"{dec_errs['hd112']:.3g}, g 7 {dec_errs['g7']:.3g}), bf16 "
        f"{dec_errs['bf16']:.3g} (rtol 2e-2, atol 2e-2 of the mean |o|; "
        f"hd 112 {dec_errs['hd112_bf16']:.3g}, g 7 "
        f"{dec_errs['g7_bf16']:.3g}, phase 4n's {N_DECODE} at pos "
        f"{N_DECODE[1] - 1} {dec_errs['prod_bf16']:.3g}); "
        f"every case run twice bitwise equal; with its log-sum-exp o "
        f"bitwise and lse max abs err {dec_errs['lse']:.3g} (tol 1e-4)")
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
    for arch, n_layers in CUT_DECODE:
        try:
            report[f"decode_{arch}"] = cut_decode_cell(
                torch, tm, get_arch, make_serve_step, kfd, tree_leaves, arch,
                n_layers)
        except AssertionError as exc:
            return fail(f"phase {exc}")
    d_launches = {arch: report[f"decode_{arch}"]["launches"]["flash_decode"]
                  for arch in D_ARCHS + tuple(a for a, _ in CUT_DECODE)}

    # ---- 4l. llava's prefill with its image prefix -------------------------
    try:
        report["prefill_llava"] = llava_prefill_cell(torch, ts, tm, get_arch,
                                                     kfa, smi)
    except AssertionError as exc:
        return fail(f"phase {exc}")
    l_launches = report["prefill_llava"]["pallas"]["launches"]

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

    # ---- 4k. the training driver at qwen1.5-4b's full width ---------------
    attn_kernels = {"flash_attention_fwd": kfa.flash_attention_fwd,
                    "flash_attention_bwd_dq": kfa.flash_attention_bwd_dq,
                    "flash_attention_bwd_dkdv": kfa.flash_attention_bwd_dkdv}
    try:
        report["train"] = train_cell(torch, train,
                                     {"sbc_stats": ksbc.sbc_stats,
                                      "sbc_apply": ksbc.sbc_apply}, smi)
        report["sbc_w_down"] = sbc_at_w_down(torch, csbc, ksbc)
        report["train_pallas"] = pallas_vs_naive(
            torch, ts, tm, optim, get_arch, attn_kernels, smi)
    except AssertionError as exc:
        return fail(f"phase {exc}")
    k_sbc = report["train"]["compressed"]["launches"]
    k_attn = report["train_pallas"]["pallas"]["launches"]
    w = report["sbc_w_down"]
    log(f"[4k train] B1/B2 at w_down's {Q_W_DOWN} elements ({w['kept']} "
        f"kept): stats counts and apply bitwise the plain versions, sums "
        f"within rtol 1e-6 (max abs err {w['sbc_stats']['max_abs_err']:.3g})"
        + "".join(f"; {name} {w[name]['ms']:.3f} ms, plain "
                  f"{w[name]['plain_ms']:.3f} ms, bound "
                  f"{w[name]['bound_ms']:.3f} ms ({w[name]['bound_by']})"
                  for name in ("sbc_stats", "sbc_apply")) + f"; {smi}")

    # ---- 4m. MoE and MLA training at full width -----------------------------
    t0 = time.perf_counter()
    try:
        report["train_moe"] = moe_train_cell(
            torch, train, ts, tm, optim, get_arch, tree_leaves,
            {"sbc_stats": ksbc.sbc_stats, "sbc_apply": ksbc.sbc_apply}, smi)
    except AssertionError as exc:
        return fail(f"phase {exc}")
    m4_sbc = report["train_moe"]["deepseek_sbc"]["launches"]
    log(f"[4m train] phase wall {time.perf_counter() - t0:.1f} s")

    # ---- 4n. the production runtime: bf16, remat, the dry-run driver ------
    t0 = time.perf_counter()
    try:
        report["production"] = production_cell(
            torch, F, dryrun, perf, ts, tm, get_arch, get_shape, tree_leaves,
            tree_unflatten, all_kernels | {"flash_decode": kfd.flash_decode},
            kfa, smi)
    except (AssertionError, FloatingPointError) as exc:
        return fail(f"phase {exc}")
    n_report = report["production"]
    log(f"[4n production] phase wall {time.perf_counter() - t0:.1f} s")

    # ---- 4o. SSM and hybrid training: B3' at full width, B4 at hd 112 ----
    t0 = time.perf_counter()
    try:
        report["train_ssm"] = ssm_train_cell(
            torch, np, train, dryrun, ts, tm, optim, get_arch, get_shape,
            tree_map, all_kernels | {"flash_decode": kfd.flash_decode}, smi)
    except (AssertionError, FloatingPointError) as exc:
        return fail(f"phase {exc}")
    o_report = report["train_ssm"]
    log(f"[4o train] phase wall {time.perf_counter() - t0:.1f} s")

    # ---- 4p. the static analysis on the card --------------------------------
    t0 = time.perf_counter()
    try:
        report["audit"] = audit_cell(
            env, specs, {"sbc_stats": ksbc.sbc_stats,
                         "sbc_apply": ksbc.sbc_apply}, all_kernels, csbc,
            ksbc, smi)
    except AssertionError as exc:
        return fail(f"phase {exc}")
    log(f"[4p audit] phase wall {time.perf_counter() - t0:.1f} s")

    # ---- 4q. the mesh half of launch, the batch mesh over two entries -------
    t0 = time.perf_counter()
    try:
        report["mesh"] = mesh_cell(
            env, specs, api, dryrun, perf, get_arch,
            {"sbc_stats": ksbc.sbc_stats, "sbc_apply": ksbc.sbc_apply},
            n_report["decode"]["pallas"], smi)
    except (AssertionError, FloatingPointError, ValueError) as exc:
        return fail(f"phase {exc}")
    q_mesh = report["mesh"]
    log(f"[4q mesh] phase wall {time.perf_counter() - t0:.1f} s")

    # ---- 4r. the sharded step on the one card: a one-rank world ----------
    t0 = time.perf_counter()
    try:
        report["sharded"] = sharded_cell(
            torch, ts, tm, optim, dryrun, get_arch, get_shape,
            all_kernels | {"flash_decode": kfd.flash_decode}, smi)
    except (AssertionError, FloatingPointError, ValueError) as exc:
        return fail(f"phase {exc}")
    log(f"[4r sharded] phase wall {time.perf_counter() - t0:.1f} s")

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
                                                      tree_map, kfa)
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

    # ---- 5i. the train step: card vs CPU; a checkpoint resumed -------------
    try:
        report["train_contracts"] = train_contracts(
            torch, np, ts, tm, optim, get_arch, tree_map, tree_leaves,
            {"sbc_stats": ksbc.sbc_stats, "sbc_apply": ksbc.sbc_apply})
        report["checkpoint"] = checkpoint_contract(
            torch, ts, tm, optim, get_arch, tree_leaves, tree_map,
            checkpoint)
    except AssertionError as exc:
        return fail(f"phase {exc}")

    # ---- 5j. the audio and hybrid train steps: card vs CPU -----------------
    try:
        report["family_train_contracts"] = family_train_contracts(
            torch, np, ts, tm, optim, get_arch, tree_map,
            {"ssd_scan_fwd": kssd.ssd_scan_fwd,
             "ssd_scan_bwd": kssd.ssd_scan_bwd})
    except AssertionError as exc:
        return fail(f"phase {exc}")

    # ---- 5k. the MoE and MLA train steps: card vs CPU ----------------------
    t0 = time.perf_counter()
    try:
        report["moe_contracts"] = moe_contracts(
            torch, np, ts, tm, moe_mod, optim, get_arch, tree_map,
            tree_leaves)
    except AssertionError as exc:
        return fail(f"phase {exc}")
    log(f"[5k card vs cpu] phase wall {time.perf_counter() - t0:.1f} s")

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
                                     h5_launches[name],
                                 f"{Q_ARCH} launch.train --compress-uplink "
                                 f"--slot {Q_SLOT_SBC}, {Q_STEPS} steps, 4k":
                                     k_sbc[name],
                                 f"{M4_SBC_ARCH} at {M4_SBC_LAYERS} layers, "
                                 f"make_train_step --compress-uplink, "
                                 f"{M4_SBC_STEPS} steps, 4m": m4_sbc[name],
                                 **{f"batch mesh of 2 entries, {label}, 4q":
                                    run["launches"][name]
                                    for label, run in
                                    q_mesh["batch_mesh"].items()}},
            "max_abs_err": errs[name],
            "at_w_down": report["sbc_w_down"][name],
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
        name: (kernel, {f"{str(dt).split('.')[-1]}_hd{hd}": fn(hd, dt)
                        for hd in kfa.HEAD_DIMS
                        for dt in (torch.float32, torch.bfloat16)})
        for name, kernel, fn in (
            ("flash_attention_fwd", "fwd_kernel", kfa.fwd_resources),
            ("flash_attention_bwd_dq", "dq_kernel", kfa.dq_resources),
            ("flash_attention_bwd_dkdv", "dkdv_kernel",
             kfa.dkdv_resources))}
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
    at_qwen = attention_times(torch, kfa, F, Q_SHAPE)
    for name, t in attention_times(torch, kfa, F).items():
        aq = at_qwen[name]
        log(f"[6 times] {name} at {Q_SHAPE} (qwen1.5-4b's step): kernel "
            f"{aq['ms']:.4f} ms ({aq['device_ms']:.4f} ms on the card), plain "
            f"{aq['plain_ms']:.4f} ms, bound {aq['bound_ms']:.4f} ms "
            f"({aq['bound_by']}), scaled_dot_product_attention "
            f"{aq['library_ms']:.4f} ms")
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
                                     h5_launches[name],
                                 f"{Q_ARCH} make_train_step pallas, "
                                 f"{1 + Q_TIMED} steps, 4k": k_attn[name],
                                 **({f"{L_ARCH} prefill, 4l":
                                     l_launches[name]}
                                    if name in l_launches else {}),
                                 f"{N_ARCH} prefill_32k bf16 at "
                                 f"{N_PREFILL_LAYERS} layers, pallas, "
                                 f"{N_PREFILL_REPEATS + 1} steps, 4n":
                                     n_report["prefill"]["pallas"][
                                         "launches_run"][name]},
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "at_qwen": {f: aq[f] for f in ("ms", "device_ms", "plain_ms",
                                          "library_ms", "bound_ms",
                                          "bound_by")}})
        if name in attn_res:
            records[-1]["device_ms"] = t["device_ms"]
            records[-1]["resources"] = attn_res[name][1]
            log(f"[6 times] {name} at {T_SHAPE}: {t['device_ms']:.4f} ms on "
                f"the card (profiler)")
        if "library_bwd_ms" in t:
            records[-1]["library_bwd_ms"] = t["library_bwd_ms"]
        if name in n_report["kernels"]:
            records[-1]["at_prod_bf16"] = n_report["kernels"][name]
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
                                 "service, 4i": i_launches[name],
                                 f"{N_SSM_ARCH} prefill_32k bf16, "
                                 f"{N_PREFILL_REPEATS + 1} steps, 4n":
                                     n_report["prefill"]["mamba2"][
                                         "launches_run"][name]},
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
        if name == "ssd_scan_bwd":
            records[-1]["resources"] = res
        else:
            records[-1]["resources"] = fwd_ssd_res
            records[-1]["at_prod_bf16"] = {
                **t["at_prod_bf16"],
                "max_abs_err": ssd_errs["prod_bf16_fwd"]}
            records[-1]["device_ms"] = t["device_ms"]
            tp = t["at_prod_bf16"]
            log(f"[6 times] ssd_scan_fwd at {N_SSD} (phase 4n's "
                f"{N_SSM_ARCH} layer), bf16 with dt f32: kernel "
                f"{tp['ms']:.4f} ms, plain {tp['plain_ms']:.4f} ms, bound "
                f"{tp['bound_ms']:.4f} ms ({tp['bound_by']}: {tp['bytes']} "
                f"bytes, {tp['ops']} ops); library_ms none")
            log(f"[6 times] ssd_scan_fwd at {M_SHAPE}: {t['device_ms']:.4f} "
                f"ms on the card (profiler)")
        log(f"[6 times] {name} at {M_SHAPE} (B, S, H, P, G, N, chunk): "
            f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']} bytes, "
            f"{t['ops']} f32 ops); library_ms none (no single PyTorch call "
            f"computes the SSD scan)")

    # phase 4o's training shapes: B3' at full width (f32, bf16), B4, B4'
    # and B4'' at head dim 112 (f32, bf16) and at qwen's step in bf16
    try:
        t_ssd = train_ssd_rows(torch, kssd)
        t_attn = train_attention_rows(torch, F, kfa)
    except AssertionError as exc:
        return fail(f"phase {exc}")
    by_name = {r["name"]: r for r in records}
    for key, t in t_ssd.items():
        r = t["resources"]["ssd_bwd_kernel"]
        log(f"[6 times] ssd_scan_bwd at {tuple(t['shape'])} (B, S, H, P, G, "
            f"N; phase 4o's {key.split('_')[0]} layer), {t['dtype']}: max "
            f"abs err {t['max_abs_err']:.3g}"
            + (f" vs the plain version, {t['vs_f64']:.3g} vs it in float64 "
               f"(tol {t['tol']}; the float32 plain version "
               f"{t['plain_vs_f64']:.3g})" if t["dtype"] == "float32"
               else " vs the plain float32 arithmetic on the same values "
               "(bf16_tols)")
            + f"; twice bitwise, alone bitwise among {O_AMONG}; kernel "
            f"{t['ms']:.4f} ms ({t['device_ms']:.4f} ms on the card), plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}: {t['bytes']} bytes, {t['ops']} ops); "
            f"{t['units'][0]} units of {t['units'][1]} rows a sequence; "
            f"{r['registers']} registers, {r['local_bytes']} bytes of local "
            f"memory (spills), "
            f"{r['static_smem_bytes'] + r['dynamic_smem_bytes']} bytes of "
            f"shared memory, {r['ctas_per_sm']} CTAs an SM; library_ms none; "
            f"{smi}")
        if any(x["local_bytes"] for x in t["resources"].values()):
            return fail(f"phase 6: B3' spills at {t['shape']} {t['dtype']}")
    for key, rows in t_attn.items():
        for name, t in rows.items():
            r = t["resources"]
            log(f"[6 times] {name} at {tuple(t['shape'])} (B, S, Hq, Hkv, "
                f"hd), causal, {t['dtype']}: max abs err "
                f"{t['max_abs_err']:.3g} (tol {t['tol']}); twice bitwise, "
                f"alone bitwise among {O_AMONG}; kernel {t['ms']:.4f} ms "
                f"({t['device_ms']:.4f} ms on the card), plain "
                f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}: {t['bytes']} bytes, {t['ops']} ops), "
                f"scaled_dot_product_attention "
                + ("forward" if name == "flash_attention_fwd"
                   else "forward + backward")
                + f" {t['library_ms']:.4f} ms"
                + (f", its backward alone {t['library_bwd_ms']:.4f} ms"
                   if "library_bwd_ms" in t else "")
                + f"; {r['registers']} registers, {r['local_bytes']} bytes "
                f"of local memory (spills), {r['ctas_per_sm']} CTAs an SM; "
                f"{smi}")
    o_paths = {
        f"{O_TRAIN_ARCH} launch.train f32, {O_STEPS} steps, 4o":
            o_report["train"]["launches"],
        **{f"{r['arch']} train_4k bf16 {r['runtime']['attn_impl']}, "
           f"{1 + O_REPEATS} steps, 4o": r["launches_run"]
           for r in o_report["train_4k"].values()}}
    for name in ("ssd_scan_bwd", "ssd_scan_fwd", "flash_attention_fwd",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkdv"):
        by_name[name]["launches_by_path"].update(
            {path: n[name] for path, n in o_paths.items() if n[name]})
    by_name["ssd_scan_bwd"]["at_train"] = t_ssd
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkdv"):
        by_name[name]["at_train"] = {key: rows[name]
                                     for key, rows in t_attn.items()}

    dt = decode_times(torch, kfd, F)
    path = dt["path"]
    records.append({
        "name": "flash_decode", "route": "cuda", "source": DECODE_SOURCE,
        "replaces": "src/repro/kernels/flash_decode.py:25",
        "launches": d_launches["mistral-nemo-12b"],
        "launches_by_path": {**{f"decode {a}": n
                                for a, n in d_launches.items()},
                             f"{N_ARCH} decode_32k bf16 multi_pod, batch "
                             f"{N_DECODE_BATCH}, {N_DECODE_STEPS} steps, "
                             "4n (4q reads its row)":
                                 n_report["decode"]["pallas"][
                                     "launches_run"]["flash_decode"]},
        "at_prod_bf16": {**{f: dt["prod_bf16"][f] for f in (
            "shape", "pos", "dtype", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")},
            "max_abs_err": dec_errs["prod_bf16"]},
        "max_abs_err": errs["flash_decode"], "ms": path["ms"],
        "plain_ms": path["plain_ms"], "bound_ms": path["bound_ms"],
        "bound_by": path["bound_by"], "library_ms": path["library_ms"],
        "device_ms": path["device_ms"],
        "device_span_ms": path["device_span_ms"],
        "kernels_per_call": path["kernels_per_call"],
        "resources": path["resources"],
        **{f"at_{key[:-len('_path')] if key.endswith('_path') else key}":
           {f: dt[key][f] for f in ("shape", "pos", "dtype", "ms",
                                    "device_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")}
           for key in ("qwen_path", "zamba2_path", "zamba2_bf16",
                       "granite_path", "musicgen_path", "arctic_path")},
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
    # every instance the build made: 2 types x 3 head dims x 4 row counts
    fd_build = {name: r for name, r in build.ptxas_report(
        libs["flash_decode"].log).items() if "decode_kernel" in name}
    for name, r in sorted(fd_build.items()):
        log(f"[6 resources] flash_decode build {name}: {r['registers']} "
            f"registers, {r['spill_stores']} bytes of spill stores and "
            f"{r['spill_loads']} of spill loads")
    report["decode_build_resources"] = fd_build
    if len(fd_build) != 24 or any(
            r["spill_stores"] or r["spill_loads"] for r in fd_build.values()):
        return fail(f"phase 6: {len(fd_build)} flash_decode instances built "
                    f"(24 expected), or one spills")
    if any(t["resources"]["local_bytes"] for t in dt.values()):
        return fail("phase 6: a flash_decode instance spills")
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

    # phase 4r's runs on DTensors: each kernel's launches a run
    by_name = {r["name"]: r for r in records}
    for arch, cell in report["sharded"].items():
        for part, runs in (("train_4k", cell["train"]),
                           ("decode_32k", cell["decode"])):
            for run, r in runs.items():
                if run == "unsharded":
                    continue
                path = f"{arch} {part} {run} on a one-rank world, 4r"
                for name, n in r["launches"].items():
                    if n and name in by_name:
                        by_name[name]["launches_by_path"][path] = n

    report["kernels"] = records
    report["device"] = {"kind": kind, "smi": smi}
    report["seconds"] = time.perf_counter() - t_start
    log(f"[done] every phase passed in {report['seconds']:.1f} s")
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
