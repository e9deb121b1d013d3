#!/usr/bin/env python3
"""Time the SSD-scan backward against an earlier version of its source on
one NVIDIA GPU, at the mamba2 cell's shape, in one process.

    git show <rev>:src/repro_torch/kernels/csrc/ssd_scan.cu > old_ssd.cu
    python3 ssd_bwd_ab.py --old old_ssd.cu

The old source is built with the port's nvcc flags into ``chiprun_out/``
and called through its ``ssd_scan_bwd_launch``, which must take the
arguments the current one takes, with the workspace of the
recurrence-based backward: B * G * (ceil(S / 16) - 1) * N * (H / G) * P
floats.  Both run on the same inputs (``chip_smoke.ssd_inputs``): their
outputs' largest differences, then cold-L2 medians of 20 launches in the
order old, new, new, old, beside the bound of ``chip_smoke.ssd_work``.
The last line is one JSON object with the times.
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


def old_library(build, src: Path):
    """The old source built and loaded, and its compiler report."""
    out = ROOT / "chiprun_out" / "ssd_bwd_ab"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libssd_scan_old.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_bwd_launch.argtypes = ([ptr] * 13 + [i32] * 7 + [i64] * 3
                                        + [ptr])
    lib.ssd_scan_bwd_launch.restype = i32
    return lib, proc.stdout + proc.stderr


def old_bwd(torch, kssd, lib, x, dt, A, Bm, Cm, dy):
    """The old kernel's (dx, ddt, dA, dBm, dCm)."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    new = functools.partial(torch.empty, device=x.device,
                            dtype=torch.float32)
    outs = (new(x.shape), new(dt.shape), new(A.shape), new(Bm.shape),
            new(Cm.shape))
    part = torch.empty((b, h), dtype=torch.float64, device=x.device)
    ws = new((max(b * g * (-(-s // 16) - 1) * n * (h // g) * p, 1),))
    rc = lib.ssd_scan_bwd_launch(
        *(t.data_ptr() for t in (x, dt, A, Bm, Cm, dy, *outs, part, ws)),
        *kssd._dims("old ssd_scan_bwd", x, A, Bm, Cm), kssd._stream(x))
    if rc != 0:
        raise RuntimeError(f"old ssd_scan_bwd_launch returned {rc}")
    return outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="an earlier csrc/ssd_scan.cu")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_scan as kssd

    smi = cs.nvidia_smi_line()
    print(f"[device] {smi}")
    lib, log = old_library(build, args.old)
    keep = False
    for line in log.splitlines():
        if "Function properties" in line:
            keep = "bwd_kernel" in line
        if "spill" in line and keep:
            print(f"[old build] ssd_bwd_kernel: {line.strip()}")
    b, s, h, p, g, n, chunk = cs.M_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(4)
    ins, dy = cs.ssd_inputs(torch, gen, cs.M_COPIES, b // cs.M_COPIES, s, h,
                            p, g, n)
    old = old_bwd(torch, kssd, lib, *ins, dy)
    cur = kssd.ssd_scan_bwd(*ins, dy, chunk=chunk)
    diffs = {}
    for name, a, o in zip(("dx", "ddt", "dA", "dBm", "dCm"), cur, old):
        diffs[name] = float((a - o).abs().max())
        print(f"[outputs] {name}: max abs difference {diffs[name]:.3g} "
              f"(max |old| {float(o.abs().max()):.3g})")
    runs = {"old": lambda: old_bwd(torch, kssd, lib, *ins, dy),
            "new": lambda: kssd.ssd_scan_bwd(*ins, dy, chunk=chunk)}
    times = {"old": [], "new": []}
    for who in ("old", "new", "new", "old"):
        times[who].append(cs.cold_ms(torch, runs[who]))
    bound_ms, bound_by = cs.bound(*cs.ssd_work(ins, dy)["ssd_scan_bwd"])
    print(f"[times] ssd_scan_bwd at {cs.M_SHAPE} (B, S, H, P, G, N, chunk), "
          f"cold L2, median of 20: old {times['old']} ms, new "
          f"{times['new']} ms; bound {bound_ms:.4f} ms ({bound_by})")
    print(json.dumps({"shape": cs.M_SHAPE, "device": smi, "old_ms":
                      times["old"], "new_ms": times["new"], "bound_ms":
                      bound_ms, "bound_by": bound_by,
                      "max_abs_diff": diffs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
