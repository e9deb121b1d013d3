#!/usr/bin/env python3
"""Time a kernel against an earlier version of its source on one NVIDIA
GPU, in one process.

    git show <rev>:src/repro_torch/kernels/csrc/ssd_scan.cu > old_ssd.cu
    python3 kernel_ab.py --kernel ssd_bwd --old old_ssd.cu
    python3 kernel_ab.py --kernel ssd_fwd --old old_ssd.cu
    git show <rev>:src/repro_torch/kernels/csrc/flash_decode.cu > old_fd.cu
    python3 kernel_ab.py --kernel flash_decode --old old_fd.cu
    git show <rev>:src/repro_torch/kernels/csrc/flash_attention.cu > old_fa.cu
    python3 kernel_ab.py --kernel flash_attention_fwd --old old_fa.cu
    python3 kernel_ab.py --kernel flash_attention_dkdv --old old_fa.cu
    python3 kernel_ab.py --kernel flash_attention_dq --old old_fa.cu

The old source is built with the port's nvcc flags into ``chiprun_out/``
and called through its C entry point beside the current kernel, on the
same inputs: their outputs' largest differences, then cold-L2 times in
the order old, new, new, old, beside the bound of ``chip_smoke``.

* ``ssd_bwd``: the SSD-scan backward at the mamba2 cell's shape
  (``chip_smoke.ssd_inputs``) and at ``SSD_BWD_LONG``, shapes of many
  segments that an old kernel of one CTA a (sequence, group) takes (N <=
  64, at most 128 (head, p) rows a group), medians of 20 CUDA-event
  times (5 at the long shapes), and each output against the plain version
  in float64.  The old ``ssd_scan_bwd_launch`` takes the arguments of the
  f32 dual-form backward of one CTA a (sequence, group): x, dt, A, Bm,
  Cm, dy, the five outputs, the f64 dA partials and the workspace (B * G
  * (ceil(S / 16) + 1) * N * (H / G) * P floats), then the dims.
* ``ssd_fwd``: the SSD-scan forward at the mamba2 cell's shape
  (``chip_smoke.M_SHAPE``, x, Bm and Cm slices of the conv output as on
  the path) in f32 and bf16, and at chip_smoke's other phase-3c shapes
  that both sources take (N <= 64) in f32, both called through their
  ``ssd_scan_fwd_launch`` (the same signature) on the same inputs: the
  largest differences of y between them and against the plain version
  in float64; cold-L2 medians of 20 of the profiler's kernel time and of
  the CUDA-event time; the bound of ``chip_smoke.ssd_work`` (bytes at the
  inputs' own widths); the new kernel's resources (registers, spills,
  shared memory, CTAs an SM) at chip_smoke's resource shapes.
* ``flash_decode``: flash decode at the decode cell's shape (B 8, ctx
  2048, 32 query / 8 KV heads of 128, f32) at pos 0, 31, 32, 191 and
  2047, and at one layer of a 32k-token cache (B 16) in bf16 and f32.
  The old ``flash_decode_launch`` takes the split design's arguments (q,
  k, v, pos, part, o, ...), with its per-call workspace ``part`` of B *
  Hq * 32 * (hd + 4) floats allocated as its wrapper did.  Each version
  gets its CUDA-event time (the wrapper's host work included) and, from
  the profiler, its kernels' time on the card and the span of a call
  there (the gap between the split design's two kernels included), with
  the kernels a call launches;
  the new kernel's resources (registers, spills, shared memory, runs) at
  each shape.
* ``flash_attention_fwd``: the attention forward at the transformer
  cell's shape (``chip_smoke.T_SHAPE``, causal) in f32 and bf16 and at
  chip_smoke's other attention cases (``ATTN_CASES``) in f32, both
  sources called through their ``flash_attention_fwd_launch`` (the same
  signature) on the same inputs: the largest differences of o and lse
  between them and against the plain version; cold-L2 medians of 20 of
  the profiler's kernel time and of the CUDA-event time;
  ``scaled_dot_product_attention`` on the same inputs and the bound of
  ``chip_smoke.attention_bound``; the new kernel's resources (registers,
  spills, shared memory, CTAs an SM) for all six instances.
* ``flash_attention_dkdv``: the attention backward's dK/dV kernel at the
  transformer cell's shape and at chip_smoke's other attention cases, in
  f32 (the backward's only type), both sources called through their
  ``flash_attention_bwd_dkdv_launch`` (the same signature) on the same
  inputs (lse and D from the current forward and dQ kernels): the
  largest differences of dk and dv between them and against the plain
  version; cold-L2 medians of 20 of the profiler's kernel time and of the
  CUDA-event time; the bound of ``chip_smoke.dkdv_bound`` (the one
  ``chip_smoke.attention_times`` reports); the new kernel's resources for
  its three instances.
* ``flash_attention_dq``: the attention backward's dQ kernel at the
  transformer cell's shape and at chip_smoke's other attention cases, in
  f32, both sources called through their ``flash_attention_bwd_dq_launch``
  (the same signature) on the same inputs (o and lse from the current
  forward): the largest differences of dq and D between them and against
  the plain version; cold-L2 medians of 20 of the profiler's kernel time
  and of the CUDA-event time; the bound of ``chip_smoke.dq_bound``; the
  new kernel's resources for its three instances.

Each compiler report's registers and spills are printed.  The last line
is one JSON object with the times.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the SSD backward's long shapes (copies, B per copy, S, H, P, G, N): 128
# segments of one group of 128 rows at N 64; 16 segments over 4 groups
SSD_BWD_LONG = [(4, 1, 2048, 2, 64, 1, 64), (1, 2, 256, 8, 32, 4, 64)]


def old_library(build, src: Path, tag: str):
    """The old source built and loaded, and its compiler report."""
    out = ROOT / "chiprun_out" / "kernel_ab"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"lib{tag}_old.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return ctypes.CDLL(str(so)), proc.stdout + proc.stderr


def print_report(build, log: str, what: str, match: str) -> dict:
    """Registers and spills of the entry functions whose names hold
    ``match``, from a build's report."""
    found = {n: r for n, r in build.ptxas_report(log).items() if match in n}
    for name, r in found.items():
        print(f"[{what} build] {name}: {r}")
    return found


# ---------------------------------------------------------------------------
# the SSD-scan backward
# ---------------------------------------------------------------------------


def old_bwd(torch, kssd, lib, x, dt, A, Bm, Cm, dy):
    """The old kernel's (dx, ddt, dA, dBm, dCm)."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    new = functools.partial(torch.empty, device=x.device,
                            dtype=torch.float32)
    outs = (new(x.shape), new(dt.shape), new(A.shape), new(Bm.shape),
            new(Cm.shape))
    part = torch.empty((b, h), dtype=torch.float64, device=x.device)
    ws = new((max(b * g * (-(-s // 16) + 1) * n * (h // g) * p, 1),))
    rc = lib.ssd_scan_bwd_launch(
        *(t.data_ptr() for t in (x, dt, A, Bm, Cm, dy, *outs, part, ws)),
        *kssd._dims("old ssd_scan_bwd", x, A, Bm, Cm), kssd._stream(x))
    if rc != 0:
        raise RuntimeError(f"old ssd_scan_bwd_launch returned {rc}")
    return outs


def ssd_bwd_ab(torch, cs, build, lib, log) -> dict:
    from repro_torch.kernels import ssd_scan as kssd
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_bwd_launch.argtypes = ([ptr] * 13 + [i32] * 7 + [i64] * 3
                                        + [ptr])
    lib.ssd_scan_bwd_launch.restype = i32
    print_report(build, log, "old", "bwd_kernel")
    b, s, h, p, g, n, chunk = cs.M_SHAPE
    shapes = [(cs.M_COPIES, b // cs.M_COPIES, s, h, p, g, n)] + SSD_BWD_LONG
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = []
    for copies, per, s, h, p, g, n in shapes:
        ins, dy = cs.ssd_inputs(torch, gen, copies, per, s, h, p, g, n)
        old = old_bwd(torch, kssd, lib, *ins, dy)
        cur = kssd.ssd_scan_bwd(*ins, dy, chunk=s)
        exact = kssd.ssd_scan_bwd_plain(*(t.double() for t in (*ins, dy)),
                                        chunk=s)
        diffs = {}
        for name, a, o, e in zip(("dx", "ddt", "dA", "dBm", "dCm"), cur, old,
                                 exact):
            diffs[name] = [float((a - o).abs().max()),
                           float((a.double() - e).abs().max()),
                           float((o.double() - e).abs().max())]
            print(f"[outputs] {name}: max abs difference {diffs[name][0]:.3g}"
                  f" (max |old| {float(o.abs().max()):.3g}); against float64"
                  f" new {diffs[name][1]:.3g}, old {diffs[name][2]:.3g}")
        runs = {"old": lambda: old_bwd(torch, kssd, lib, *ins, dy),
                "new": lambda: kssd.ssd_scan_bwd(*ins, dy, chunk=s)}
        times = {"old": [], "new": []}
        iters = 20 if s <= 16 else 5
        for who in ("old", "new", "new", "old"):
            times[who].append(cs.cold_ms(torch, runs[who], iters=iters))
        shape = (copies * per, s, h, p, g, n)
        bound_ms, bound_by = cs.bound(*cs.ssd_bwd_work(ins, dy))
        print(f"[times] ssd_scan_bwd at {shape} (B, S, H, P, G, N), cold L2, "
              f"median of {iters}: old {times['old']} ms, new "
              f"{times['new']} ms; bound {bound_ms:.4f} ms ({bound_by})")
        out.append({"shape": shape, "old_ms": times["old"],
                    "new_ms": times["new"], "bound_ms": bound_ms,
                    "bound_by": bound_by, "max_abs_diff": diffs})
    return {"shapes": out}


# ---------------------------------------------------------------------------
# the SSD-scan forward
# ---------------------------------------------------------------------------


def old_fwd(torch, kssd, lib, x, dt, A, Bm, Cm):
    """The old source's y, through its ssd_scan_fwd_launch."""
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rc = lib.ssd_scan_fwd_launch(
        *(t.data_ptr() for t in (x, dt, A, Bm, Cm, y)),
        *kssd._dims("old ssd_scan_fwd", x, A, Bm, Cm),
        int(x.dtype == torch.bfloat16), kssd._stream(x))
    if rc != 0:
        raise RuntimeError(f"old ssd_scan_fwd_launch returned {rc}")
    return y


def ssd_fwd_ab(torch, cs, build, lib, log) -> dict:
    from repro_torch.kernels import ssd_scan as kssd
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_fwd_launch.argtypes = ([ptr] * 6 + [i32] * 7 + [i64] * 3
                                        + [i32, ptr])
    lib.ssd_scan_fwd_launch.restype = i32
    old_report = print_report(build, log, "old", "fwd_kernel")
    new_report = print_report(build, build.load("ssd_scan").log, "new",
                              "fwd_kernel")
    resources = {"H{}_P{}_G{}_N{}".format(*shape): kssd.fwd_resources(*shape)
                 for shape in cs.SSD_FWD_RESOURCE_SHAPES}
    for shape, recs in resources.items():
        for key, r in recs.items():
            print(f"[resources] ssd_fwd_kernel {shape} {key}: {r}")
    b, s, h, p, g, n, chunk = cs.M_SHAPE
    cell = (cs.M_COPIES, b // cs.M_COPIES, s, h, p, g, n, chunk)
    others = [(2, 1, 128, 4, 32, 2, 16, 32), (1, 1, 64, 2, 64, 1, 32, 16),
              (1, 2, 256, 8, 32, 4, 64, 64), (1, 1, 128, 4, 32, 4, 16, 128)]
    others += cs.SSD_BWD_SEAMS + cs.SSD_FWD_SEAMS
    cases = [("cell_f32", cell, torch.float32),
             ("cell_bf16", cell, torch.bfloat16)]
    cases += [(f"case{i}_f32", case, torch.float32)
              for i, case in enumerate(others, 1)]
    gen = torch.Generator(device="cuda").manual_seed(8)
    out = {}
    for key, (copies, per, s, h, p, g, n, chunk), dtype in cases:
        ins, dy = cs.ssd_inputs(torch, gen, copies, per, s, h, p, g, n)
        exact = kssd.ssd_scan_fwd_plain(*(t.double() for t in ins),
                                        chunk=chunk)
        if dtype == torch.bfloat16:
            ins = tuple(t if i == 2 else t.bfloat16()
                        for i, t in enumerate(ins))
        runs = {"old": lambda: old_fwd(torch, kssd, lib, *ins),
                "new": lambda: kssd.ssd_scan_fwd(*ins, chunk=chunk)}
        y_old, y_new = runs["old"](), runs["new"]()
        diff = lambda a, c: float((a.double() - c.double()).abs().max())  # noqa
        rec = {"shape": [copies * per, s, h, p, g, n, chunk],
               "dtype": str(dtype).split(".")[-1],
               "y_new_vs_old": diff(y_new, y_old),
               "y_new_vs_f64": diff(y_new, exact),
               "y_old_vs_f64": diff(y_old, exact),
               "old_ms": [], "new_ms": [], "old_device_ms": [],
               "new_device_ms": []}
        for who in ("old", "new", "new", "old"):
            rec[f"{who}_ms"].append(cs.cold_ms(torch, runs[who]))
            rec[f"{who}_device_ms"].append(
                cs.device_ms(torch, runs[who], "ssd_fwd_kernel")[0])
        nbytes = 2 * ins[0].numel() * ins[0].element_size() + sum(
            t.numel() * t.element_size() for t in ins[1:])
        ops = cs.ssd_work(ins, dy)["ssd_scan_fwd"][1]
        rec["bound_ms"], rec["bound_by"] = cs.bound(nbytes, ops)
        rec["bytes"], rec["ops"] = nbytes, ops
        print(f"[times] ssd_scan_fwd {key} at {tuple(rec['shape'])} (B, S, "
              f"H, P, G, N, chunk), {rec['dtype']}, cold L2, median of 20: "
              f"on the card (profiler) old {rec['old_device_ms']} ms, new "
              f"{rec['new_device_ms']} ms; CUDA events old {rec['old_ms']} "
              f"ms, new {rec['new_ms']} ms; bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}: {nbytes} bytes, {ops} ops); y new vs old "
              f"{rec['y_new_vs_old']:.3g}; vs float64: new "
              f"{rec['y_new_vs_f64']:.3g}, old {rec['y_old_vs_f64']:.3g}")
        out[key] = rec
        del ins, dy, exact, y_old, y_new
        torch.cuda.empty_cache()
    return {"cases": out, "resources": resources, "old_build": old_report,
            "new_build": new_report}


# ---------------------------------------------------------------------------
# flash decode
# ---------------------------------------------------------------------------


def old_decode(torch, lib, q, k, v, pos):
    """The split design's call, as its wrapper made it: pos as an int32
    tensor, a workspace of 32 runs of (acc, m, l) a row, o."""
    b, _, hq, hd = q.shape
    ctx, hkv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    part = torch.empty((b, hq, 32, hd + 4), dtype=torch.float32,
                       device=q.device)
    rc = lib.flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        part.data_ptr(), o.data_ptr(), b, ctx, hq, hkv, hd, 0,
        1.0 / hd ** 0.5, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"old flash_decode_launch returned {rc}")
    return o


def flash_decode_ab(torch, cs, build, lib, log) -> dict:
    from repro_torch.kernels import flash_decode as kfd
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_decode_launch.argtypes = [ptr] * 6 + [i32] * 6 + [f32, i32,
                                                                ptr]
    lib.flash_decode_launch.restype = i32
    old_report = print_report(build, log, "old", "decode_")
    new_report = print_report(build, build.load("flash_decode").log, "new",
                              "decode_kernel")
    cases = [(f"path_pos{pos}", cs.D_SHAPE, pos, torch.float32)
             for pos in (0, 31, 32, cs.D_POS, cs.D_CTX - 1)]
    cases += [("32k_bf16", cs.D_LONG, cs.D_LONG[1] - 1, torch.bfloat16),
              ("32k_f32", cs.D_LONG, cs.D_LONG[1] - 1, torch.float32)]
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for key, shape, pos, dtype in cases:
        b, ctx, hq, hkv, hd = shape
        q, k, v = cs.decode_inputs(torch, gen, b, ctx, hq, hkv, hd, dtype)
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        runs = {"old": lambda: old_decode(torch, lib, q, k, v, p),
                "new": lambda: kfd.flash_decode(q, k, v, p)}
        names = {"old": "decode_", "new": "decode_kernel"}
        diff = float((runs["new"]().float() - runs["old"]().float())
                     .abs().max())
        rec = {"shape": list(shape), "pos": pos,
               "dtype": str(dtype).split(".")[-1], "max_abs_diff": diff,
               "old_ms": [], "new_ms": [], "old_device_ms": [],
               "new_device_ms": [], "old_span_ms": [], "new_span_ms": [],
               "kernels_per_call": {}}
        for who in ("old", "new", "new", "old"):
            rec[f"{who}_ms"].append(cs.cold_ms(torch, runs[who]))
            dev, per_call, span = cs.device_ms(torch, runs[who], names[who])
            rec[f"{who}_device_ms"].append(dev)
            rec[f"{who}_span_ms"].append(span)
            rec["kernels_per_call"][who] = per_call
        rec["bound_ms"], rec["bound_by"], _, _ = cs.decode_bound(torch, q, k,
                                                                 pos)
        rec["resources"] = kfd.resources(b, ctx, hq, hkv, hd, dtype)
        print(f"[times] flash_decode {key} at {tuple(shape)} (B, ctx, Hq, "
              f"Hkv, hd), pos {pos}, {rec['dtype']}, cold L2, median of 20: "
              f"CUDA events old {rec['old_ms']} ms, new {rec['new_ms']} ms; "
              f"on the card (profiler), kernels' time old "
              f"{rec['old_device_ms']} ms, new {rec['new_device_ms']} ms; "
              f"first kernel's start to last kernel's end old "
              f"{rec['old_span_ms']} ms, new {rec['new_span_ms']} ms; "
              f"kernels a call "
              f"{rec['kernels_per_call']}; bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}); outputs differ by at most {diff:.3g}")
        print(f"[resources] flash_decode {key}: {rec['resources']}")
        out[key] = rec
        del q, k, v
        torch.cuda.empty_cache()
    return {"cases": out, "old_build": old_report, "new_build": new_report}


# ---------------------------------------------------------------------------
# the flash-attention forward
# ---------------------------------------------------------------------------


def old_attention_fwd(torch, lib, q, k, v, causal, window):
    """The old source's (o, lse), through its flash_attention_fwd_launch."""
    b, s, hq, hd = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    rc = lib.flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, s, hq, k.shape[2], hd, int(causal),
        0 if window is None else window, 1.0 / hd ** 0.5,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"old flash_attention_fwd_launch returned {rc}")
    return o, lse


def flash_attention_fwd_ab(torch, cs, build, lib, log) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd_launch.argtypes = ([ptr] * 5 + [i32] * 7
                                               + [f32, i32, ptr])
    lib.flash_attention_fwd_launch.restype = i32
    old_report = print_report(build, log, "old", "fwd_kernel")
    new_report = print_report(build, build.load("flash_attention").log,
                              "new", "fwd_kernel")
    resources = {}
    for hd in (32, 64, 128):
        for dtype in (torch.float32, torch.bfloat16):
            key = f"{str(dtype).split('.')[-1]}_hd{hd}"
            resources[key] = kfa.fwd_resources(hd, dtype)
            print(f"[resources] fwd_kernel {key}: {resources[key]}")
    cases = [("cell_f32", cs.ATTN_CASES[0], torch.float32),
             ("cell_bf16", cs.ATTN_CASES[0], torch.bfloat16)]
    cases += [(f"case{i}_f32", case, torch.float32)
              for i, case in enumerate(cs.ATTN_CASES[1:], 1)]
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for key, (b, s, hq, hkv, hd, causal, window), dtype in cases:
        q, k, v = (t.to(dtype) for t in cs.attention_inputs(
            torch, gen, b, s, hq, hkv, hd))
        opts = dict(causal=causal, window=window)
        runs = {"old": lambda: old_attention_fwd(torch, lib, q, k, v,
                                                 causal, window),
                "new": lambda: kfa.flash_attention_fwd(q, k, v, **opts)}
        (o_old, l_old), (o_new, l_new) = runs["old"](), runs["new"]()
        po, plse = kfa.flash_attention_fwd_plain(q, k, v, **opts)
        diff = lambda a, c: float((a.float() - c.float()).abs().max())  # noqa
        rec = {"shape": [b, s, hq, hkv, hd], "causal": causal,
               "window": window, "dtype": str(dtype).split(".")[-1],
               "o_new_vs_old": diff(o_new, o_old),
               "lse_new_vs_old": diff(l_new, l_old),
               "o_new_vs_plain": diff(o_new, po),
               "o_old_vs_plain": diff(o_old, po),
               "lse_new_vs_plain": diff(l_new, plse),
               "old_ms": [], "new_ms": [], "old_device_ms": [],
               "new_device_ms": []}
        for who in ("old", "new", "new", "old"):
            rec[f"{who}_ms"].append(cs.cold_ms(torch, runs[who]))
            rec[f"{who}_device_ms"].append(
                cs.device_ms(torch, runs[who], "fwd_kernel")[0])
        sdpa = cs.sdpa_call(torch, F, q, k, v, causal, window)
        rec["sdpa_ms"] = cs.cold_ms(torch, sdpa)
        rec["sdpa_device_ms"] = cs.device_ms(torch, sdpa, "")[0]
        rec["bound_ms"], rec["bound_by"], rec["bytes"], rec["ops"] = (
            cs.attention_bound(torch, q, k, causal, window))
        print(f"[times] flash_attention_fwd {key} at ({b}, {s}, {hq}, {hkv}, "
              f"{hd}) (B, S, Hq, Hkv, hd), causal={causal} window={window}, "
              f"{rec['dtype']}, cold L2, median of 20: on the card "
              f"(profiler) old {rec['old_device_ms']} ms, new "
              f"{rec['new_device_ms']} ms; CUDA events old {rec['old_ms']} "
              f"ms, new {rec['new_ms']} ms; scaled_dot_product_attention "
              f"{rec['sdpa_ms']:.4f} ms (card {rec['sdpa_device_ms']:.4f}); "
              f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
              f"{rec['bytes']} bytes, {rec['ops']} ops); o new vs old "
              f"{rec['o_new_vs_old']:.3g}, lse {rec['lse_new_vs_old']:.3g}; "
              f"vs plain: o new {rec['o_new_vs_plain']:.3g}, old "
              f"{rec['o_old_vs_plain']:.3g}, lse new "
              f"{rec['lse_new_vs_plain']:.3g}")
        out[key] = rec
        del q, k, v, o_old, o_new, l_old, l_new, po, plse
        torch.cuda.empty_cache()
    return {"cases": out, "resources": resources, "old_build": old_report,
            "new_build": new_report}


# ---------------------------------------------------------------------------
# the flash-attention dK/dV kernel
# ---------------------------------------------------------------------------


def old_attention_dkdv(torch, lib, q, k, v, lse, do, dsum, causal, window):
    """The old source's (dk, dv), through its
    flash_attention_bwd_dkdv_launch."""
    b, s, hq, hd = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = lib.flash_attention_bwd_dkdv_launch(
        *(t.data_ptr() for t in (q, k, v, lse, do, dsum, dk, dv)), b, s, hq,
        k.shape[2], hd, int(causal), 0 if window is None else window,
        1.0 / hd ** 0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"old flash_attention_bwd_dkdv_launch returned "
                           f"{rc}")
    return dk, dv


def flash_attention_dkdv_ab(torch, cs, build, lib, log) -> dict:
    from repro_torch.kernels import flash_attention as kfa
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_bwd_dkdv_launch.argtypes = ([ptr] * 8 + [i32] * 7
                                                    + [f32, ptr])
    lib.flash_attention_bwd_dkdv_launch.restype = i32
    old_report = print_report(build, log, "old", "dkdv_kernel")
    new_report = print_report(build, build.load("flash_attention").log,
                              "new", "dkdv_kernel")
    resources = {f"float32_hd{hd}": kfa.dkdv_resources(hd)
                 for hd in (32, 64, 128)}
    for key, r in resources.items():
        print(f"[resources] dkdv_kernel {key}: {r}")
    cases = [("cell_f32" if i == 0 else f"case{i}_f32", case)
             for i, case in enumerate(cs.ATTN_CASES)]
    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    for key, (b, s, hq, hkv, hd, causal, window) in cases:
        q, k, v = cs.attention_inputs(torch, gen, b, s, hq, hkv, hd)
        do = torch.randn(q.shape, generator=gen, device="cuda")
        opts = dict(causal=causal, window=window)
        o, lse = kfa.flash_attention_fwd(q, k, v, **opts)
        _, dsum = kfa.flash_attention_bwd_dq(q, k, v, o, lse, do, **opts)
        args = (q, k, v, lse, do, dsum)
        runs = {"old": lambda: old_attention_dkdv(torch, lib, *args, causal,
                                                  window),
                "new": lambda: kfa.flash_attention_bwd_dkdv(*args, **opts)}
        (dk_old, dv_old), (dk_new, dv_new) = runs["old"](), runs["new"]()
        pdk, pdv = kfa.flash_attention_bwd_dkdv_plain(*args, **opts)
        diff = lambda a, c: float((a - c).abs().max())  # noqa: E731
        rec = {"shape": [b, s, hq, hkv, hd], "causal": causal,
               "window": window, "dtype": "float32",
               "dk_new_vs_old": diff(dk_new, dk_old),
               "dv_new_vs_old": diff(dv_new, dv_old),
               "dk_new_vs_plain": diff(dk_new, pdk),
               "dv_new_vs_plain": diff(dv_new, pdv),
               "dk_old_vs_plain": diff(dk_old, pdk),
               "dv_old_vs_plain": diff(dv_old, pdv),
               "old_ms": [], "new_ms": [], "old_device_ms": [],
               "new_device_ms": []}
        for who in ("old", "new", "new", "old"):
            rec[f"{who}_ms"].append(cs.cold_ms(torch, runs[who]))
            rec[f"{who}_device_ms"].append(
                cs.device_ms(torch, runs[who], "dkdv_kernel")[0])
        rec["bound_ms"], rec["bound_by"], rec["bytes"], rec["ops"] = (
            cs.dkdv_bound(torch, q, k, causal, window))
        print(f"[times] flash_attention_dkdv {key} at ({b}, {s}, {hq}, {hkv}, "
              f"{hd}) (B, S, Hq, Hkv, hd), causal={causal} window={window}, "
              f"float32, cold L2, median of 20: on the card (profiler) old "
              f"{rec['old_device_ms']} ms, new {rec['new_device_ms']} ms; "
              f"CUDA events old {rec['old_ms']} ms, new {rec['new_ms']} ms; "
              f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
              f"{rec['bytes']} bytes, {rec['ops']} ops); new vs old: dk "
              f"{rec['dk_new_vs_old']:.3g}, dv {rec['dv_new_vs_old']:.3g}; "
              f"vs plain: dk new {rec['dk_new_vs_plain']:.3g}, old "
              f"{rec['dk_old_vs_plain']:.3g}, dv new "
              f"{rec['dv_new_vs_plain']:.3g}, old "
              f"{rec['dv_old_vs_plain']:.3g}")
        out[key] = rec
        del q, k, v, do, o, lse, dsum, args, dk_old, dv_old, dk_new, dv_new
        del pdk, pdv
        torch.cuda.empty_cache()
    return {"cases": out, "resources": resources, "old_build": old_report,
            "new_build": new_report}


# ---------------------------------------------------------------------------
# the flash-attention dQ kernel
# ---------------------------------------------------------------------------


def old_attention_dq(torch, lib, q, k, v, o, lse, do, causal, window):
    """The old source's (dq, D), through its flash_attention_bwd_dq_launch."""
    b, s, hq, hd = q.shape
    dq, dsum = torch.empty_like(q), torch.empty_like(lse)
    rc = lib.flash_attention_bwd_dq_launch(
        *(t.data_ptr() for t in (q, k, v, o, lse, do, dq, dsum)), b, s, hq,
        k.shape[2], hd, int(causal), 0 if window is None else window,
        1.0 / hd ** 0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"old flash_attention_bwd_dq_launch returned {rc}")
    return dq, dsum


def flash_attention_dq_ab(torch, cs, build, lib, log) -> dict:
    from repro_torch.kernels import flash_attention as kfa
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_bwd_dq_launch.argtypes = ([ptr] * 8 + [i32] * 7
                                                  + [f32, ptr])
    lib.flash_attention_bwd_dq_launch.restype = i32
    old_report = print_report(build, log, "old", "dq_kernel")
    new_report = print_report(build, build.load("flash_attention").log,
                              "new", "dq_kernel")
    resources = {f"float32_hd{hd}": kfa.dq_resources(hd)
                 for hd in (32, 64, 128)}
    for key, r in resources.items():
        print(f"[resources] dq_kernel {key}: {r}")
    cases = [("cell_f32" if i == 0 else f"case{i}_f32", case)
             for i, case in enumerate(cs.ATTN_CASES)]
    gen = torch.Generator(device="cuda").manual_seed(10)
    out = {}
    for key, (b, s, hq, hkv, hd, causal, window) in cases:
        q, k, v = cs.attention_inputs(torch, gen, b, s, hq, hkv, hd)
        do = torch.randn(q.shape, generator=gen, device="cuda")
        opts = dict(causal=causal, window=window)
        o, lse = kfa.flash_attention_fwd(q, k, v, **opts)
        args = (q, k, v, o, lse, do)
        runs = {"old": lambda: old_attention_dq(torch, lib, *args, causal,
                                                window),
                "new": lambda: kfa.flash_attention_bwd_dq(*args, **opts)}
        (dq_old, d_old), (dq_new, d_new) = runs["old"](), runs["new"]()
        pdq, pd = kfa.flash_attention_bwd_dq_plain(*args, **opts)
        diff = lambda a, c: float((a - c).abs().max())  # noqa: E731
        rec = {"shape": [b, s, hq, hkv, hd], "causal": causal,
               "window": window, "dtype": "float32",
               "dq_new_vs_old": diff(dq_new, dq_old),
               "D_new_vs_old": diff(d_new, d_old),
               "dq_new_vs_plain": diff(dq_new, pdq),
               "D_new_vs_plain": diff(d_new, pd),
               "dq_old_vs_plain": diff(dq_old, pdq),
               "D_old_vs_plain": diff(d_old, pd),
               "old_ms": [], "new_ms": [], "old_device_ms": [],
               "new_device_ms": []}
        for who in ("old", "new", "new", "old"):
            rec[f"{who}_ms"].append(cs.cold_ms(torch, runs[who]))
            rec[f"{who}_device_ms"].append(
                cs.device_ms(torch, runs[who], "dq_kernel")[0])
        rec["bound_ms"], rec["bound_by"], rec["bytes"], rec["ops"] = (
            cs.dq_bound(torch, q, k, causal, window))
        print(f"[times] flash_attention_dq {key} at ({b}, {s}, {hq}, {hkv}, "
              f"{hd}) (B, S, Hq, Hkv, hd), causal={causal} window={window}, "
              f"float32, cold L2, median of 20: on the card (profiler) old "
              f"{rec['old_device_ms']} ms, new {rec['new_device_ms']} ms; "
              f"CUDA events old {rec['old_ms']} ms, new {rec['new_ms']} ms; "
              f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
              f"{rec['bytes']} bytes, {rec['ops']} ops); new vs old: dq "
              f"{rec['dq_new_vs_old']:.3g}, D {rec['D_new_vs_old']:.3g}; "
              f"vs plain: dq new {rec['dq_new_vs_plain']:.3g}, old "
              f"{rec['dq_old_vs_plain']:.3g}, D new "
              f"{rec['D_new_vs_plain']:.3g}, old {rec['D_old_vs_plain']:.3g}")
        out[key] = rec
        del q, k, v, do, o, lse, args, dq_old, d_old, dq_new, d_new, pdq, pd
        torch.cuda.empty_cache()
    return {"cases": out, "resources": resources, "old_build": old_report,
            "new_build": new_report}


KERNELS = {"ssd_bwd": ssd_bwd_ab, "ssd_fwd": ssd_fwd_ab,
           "flash_decode": flash_decode_ab,
           "flash_attention_fwd": flash_attention_fwd_ab,
           "flash_attention_dkdv": flash_attention_dkdv_ab,
           "flash_attention_dq": flash_attention_dq_ab}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), required=True)
    ap.add_argument("--old", type=Path, required=True,
                    help="an earlier source of the kernel (csrc/*.cu)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build

    smi = cs.nvidia_smi_line()
    print(f"[device] {smi}")
    lib, log = old_library(build, args.old, args.kernel)
    result = KERNELS[args.kernel](torch, cs, build, lib, log)
    print(json.dumps({"kernel": args.kernel, "device": smi, **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
