"""Perf driver: run an (arch × shape) pair on one card under candidate
runtime knobs and report each one's change in ms a step, peak memory and
FLOPs against ``baseline`` (port of the reference's ``launch/perf.py``,
which compares the roofline terms of compiled TPU programs).

    python -m repro_torch.launch.perf --arch qwen1.5-4b --shape train_4k \\
        --variants baseline,remat_attn,flashjnp,opt_bf16 [--multi-pod]

A variant is ``+``-joined knobs over :func:`repro_torch.launch.dryrun.
runtime_for` (:func:`build`).  A variant that fails prints FAIL and the
driver goes on, as the reference's.  ``--multi-pod`` sizes the rows on
the 2 × 16 × 16 mesh (``mesh``, ``memory.argument_bytes_per_device``),
as the dry run's does.  With ``--mesh 2x2`` (``2x1x2`` with
``--multi-pod``) under ``torchrun --standalone --nproc-per-node 4`` each
variant runs sharded (``run_pair(mesh=...)``), so ``zero1`` and
``seq_parallel`` are run on the mesh, not only sized; rank 0 prints.

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.perf \\
        --arch qwen1.5-4b --shape train_4k --mesh 2x2 \\
        --variants baseline,zero1,seq_parallel
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch.configs import get_arch, get_shape
from repro_torch.launch.dryrun import rank0, run_pair, runtime_for, say
from repro_torch.optim import momentum


def build(variant: str, cfg, shape, multi_pod: bool = False):
    """variant: '+'-joined knobs -> (rt, opt, zero1)."""
    rt = runtime_for(cfg, shape, multi_pod)
    opt = None
    zero1 = False
    for knob in variant.split("+"):
        if knob in ("baseline", ""):
            continue
        elif knob == "flashjnp":
            rt = dataclasses.replace(rt, attn_impl="flashjnp")
        elif knob == "blockwise":
            rt = dataclasses.replace(rt, attn_impl="blockwise")
        elif knob == "seq_parallel":
            rt = dataclasses.replace(rt, seq_parallel=True)
        elif knob == "no_remat":
            rt = dataclasses.replace(rt, remat=False)
        elif knob == "remat_attn":
            rt = dataclasses.replace(rt, remat_attn=True)
        elif knob == "opt_bf16":
            opt = momentum(0.9, state_dtype=torch.bfloat16)
        elif knob == "zero1":
            zero1 = True
        elif knob == "cap1.0":
            rt = dataclasses.replace(rt, capacity_factor=1.0)
        elif knob == "expert_choice":
            rt = dataclasses.replace(rt, moe_impl="expert_choice")
        elif knob == "gqa_expand":
            rt = dataclasses.replace(rt, gqa_expand=True)
        elif knob.startswith("window"):
            rt = dataclasses.replace(rt, window=int(knob[6:]))
        elif knob.startswith("blockq"):
            rt = dataclasses.replace(rt, block_q=int(knob[6:]))
        else:
            raise ValueError(f"unknown knob {knob!r}")
    return rt, opt, zero1


def _change(r, base, key):
    return r[key] / base[key] - 1 if base[key] else 0.0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variants", default="baseline")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' for the "
                         "port's CPU path)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers")
    ap.add_argument("--batch", type=int, default=0,
                    help="global batch (default: dryrun.ONE_CARD_BATCH's, "
                         "times the mesh's data size)")
    ap.add_argument("--mesh", default=None,
                    help="run each variant sharded over this mesh of the "
                         "torch.distributed world, e.g. 2x2, under torchrun")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    shape = get_shape(args.shape)
    results = []
    base = None
    for variant in args.variants.split(","):
        rt, opt, zero1 = build(variant, cfg, shape, args.multi_pod)
        try:
            r = run_pair(args.arch, args.shape, rt=rt, opt=opt, zero1=zero1,
                         multi_pod=args.multi_pod, device=args.device,
                         layers=args.layers, batch=args.batch,
                         mesh=args.mesh)
            r["variant"] = variant
            r["peak_bytes"] = r["memory"]["peak_bytes"] or 0
            if variant == "baseline":
                base = r
            d = ""
            if base is not None and r is not base:
                d = ("  Δms={:+.1%} Δpeak={:+.1%} Δflops={:+.1%}".format(
                    *(_change(r, base, k) for k in
                      ("ms_per_step", "peak_bytes", "flops"))))
            say(f"[perf] {args.arch} x {args.shape} [{variant}] on "
                f"{r['device']}: {r['ms_per_step']:.2f} ms a step, peak "
                f"{r['peak_bytes'] / 2**30:.2f} GiB, {r['flops']:.4g} "
                f"FLOPs, "
                f"{r['memory']['argument_bytes_per_device'] / 2**30:.3f} "
                f"GiB of arguments a device of {r['mesh']}"
                + (f", collectives {r['collective_by_op']}"
                   if "collective_by_op" in r else "") + d)
        except Exception as e:                             # noqa: BLE001
            r = {"variant": variant, "arch": args.arch,
                 "shape": args.shape, "error": f"{type(e).__name__}: {e}"}
            say(f"[perf] {variant}: FAIL {r['error']}")
        results.append(r)
    if args.out and rank0():
        with open(args.out, "a") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
