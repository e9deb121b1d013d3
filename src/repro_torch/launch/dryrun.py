"""One-card dry run: an (arch × shape) step built and run on one GPU under
the reference's production runtime, with its time, memory and FLOPs
(port of the reference's ``launch/dryrun.py``).

The reference lowers and compiles each pair for a 256- or 512-chip TPU
mesh and reads XLA's cost analysis, with a cost model over its HLO. One
card runs the step instead: :func:`run_pair` draws the parameters on
the device in ``rt.dtype`` from seed 0, makes the inputs that
``input_specs`` describes (a decode cache filled from the seed, decoding
from ``pos = seq_len - steps``, so that the last step writes the last
slot), runs a warm-up step under :func:`repro_torch.launch.cost.count`
(its FLOPs and kernel launches are the row's) and then ``repeats`` timed
steps (host clock, synchronised; the median is reported).  The global batch
is cut to what one card holds (:data:`ONE_CARD_BATCH`, or ``batch``) and
``layers`` cuts the depth where the parameters do not fit; each cut is
listed in the row's ``reduced``.

A row keeps the reference's keys that mean something on one card —
``arch``, ``shape``, ``mode``, ``chips``, ``memory`` (``argument_bytes``,
the parameters, optimizer state and inputs; ``peak_bytes``,
``torch.cuda.max_memory_allocated``), ``compute_s`` (the FLOPs over the
card's peak) and ``memory_s`` (the argument bytes over its HBM rate),
``dominant``, ``model_flops_total`` and ``useful_flops_ratio`` — and
drops ``collective_s`` and the collective bytes: one card has no
collectives.  It adds ``ms_per_step`` (and its spread), ``tokens_per_s``,
``flops`` (the products PyTorch counted plus the port's kernels' by
formula, :mod:`.cost`), ``launches`` (each kernel's, in the counted step)
and ``mfu``, the model FLOPs a second over the H100 SXM's dense peak of
the run's dtype (:data:`PEAK_FLOPS`).  On the CPU the device terms
(``compute_s``, ``memory_s``, ``mfu``) are None.

The production mesh sizes the row as the reference's does: ``mesh`` is
``"16x16"``, or ``"2x16x16"`` with ``multi_pod`` (which also gives
``runtime_for`` the reference's ``moe_shard_axes``), and
``memory.argument_bytes_per_device`` is what one device of that mesh
holds of the *uncut* pair's arguments — parameters and train state (or
cache and inputs) at full depth and the full global batch — by the
sharding rules (:func:`sharded_arguments`).  ``zero1`` shards the
optimizer state over the data axes there, so it lowers that figure on a
train shape; ``chips`` stays 1, since the measured step ran on one card.

    python -m repro_torch.launch.dryrun --arch qwen1.5-4b --shape train_4k
    python -m repro_torch.launch.dryrun --arch qwen1.5-4b \\
        --shape decode_32k --device cpu --layers 2 --batch 1 --multi-pod

It runs on the GPU unless ``--device cpu`` is given, and raises when CUDA
is not available.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
import statistics
import subprocess
import sys
import time

import torch

from repro_torch.api.experiment import resolve_device
from repro_torch.configs import ASSIGNED, get_arch, get_shape, SHAPES
from repro_torch.fed.engine import full_f32
from repro_torch.fed.train_step import (TrainState, input_specs,
                                        make_prefill_step, make_serve_step,
                                        make_train_step)
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import flash_decode as kfd
from repro_torch.kernels import sbc as ksbc
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.launch import cost
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import mamba2 as m2
from repro_torch.models.model import Runtime, init, param_spec
from repro_torch.optim import momentum
from repro_torch.tree import tree_leaves, tree_leaves_with_path

# NVIDIA H100 SXM (data sheet): dense peaks by dtype, HBM rate
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BW = 3.35e12

# long-context policy: full-attention GQA archs use the sliding-window
# variant at 500k; MLA/SSM/hybrid run natively
LONG_CTX_WINDOW = 8192

# the global batch one card runs by default
ONE_CARD_BATCH = {"train": 1, "prefill": 1, "decode": 4}

KERNELS = {"flash_attention_fwd": kfa.flash_attention_fwd,
           "flash_attention_bwd_dq": kfa.flash_attention_bwd_dq,
           "flash_attention_bwd_dkdv": kfa.flash_attention_bwd_dkdv,
           "ssd_scan_fwd": kssd.ssd_scan_fwd,
           "ssd_scan_bwd": kssd.ssd_scan_bwd,
           "flash_decode": kfd.flash_decode,
           "sbc_stats": ksbc.sbc_stats, "sbc_apply": ksbc.sbc_apply}


def runtime_for(cfg, shape, multi_pod: bool = False):
    window = None
    if (shape.name == "long_500k" and cfg.attn_kind == "gqa"
            and cfg.n_heads and cfg.family not in ("ssm",)):
        window = LONG_CTX_WINDOW
    return Runtime(dtype=torch.bfloat16, attn_impl="blockwise", block_q=512,
                   window=window, remat=(shape.mode == "train"),
                   moe_shard_axes=(("pod", "data") if multi_pod
                                   else ("data",)))


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def sharded_arguments(cfg, shape, rt, mesh, opt=None,
                      zero1: bool = False) -> dict:
    """The bytes of the pair's step arguments (``param_spec`` and
    ``input_specs`` on the ``meta`` device, at ``cfg``'s depth and
    ``shape``'s global batch), whole and on one device of ``mesh`` by the
    sharding rules (``shard_shape`` rounds an uneven dimension up), with
    the count of tensor leaves and of those the rules shard.  Raises
    ``ValueError`` when a spec names a dimension the leaf lacks."""
    params = param_spec(cfg, rt.dtype)
    inputs = input_specs(cfg, shape, rt)
    # the step's arguments by the reference's rules: the train state and
    # batch (train), the parameters and batch (prefill), the parameters
    # and the cache and tokens (decode)
    if shape.mode == "train":
        state = TrainState(params, (opt or momentum(0.9)).init(params), 0)
        rule = shd.state_shardings_zero1 if zero1 else shd.state_shardings
        pairs = [(state, rule(mesh, state)),
                 (inputs, shd.batch_shardings(mesh, inputs))]
    elif shape.mode == "prefill":
        pairs = [(params, shd.params_shardings(mesh, params)),
                 (inputs, shd.batch_shardings(mesh, inputs))]
    else:
        pairs = [(params, shd.params_shardings(mesh, params)),
                 (inputs, shd.decode_input_shardings(mesh, inputs))]
    out = dict.fromkeys(("argument_bytes", "argument_bytes_per_device",
                         "leaves", "sharded_leaves"), 0)
    for tree, shardings in pairs:
        for (path, leaf), (_, sh) in zip(tree_leaves_with_path(tree),
                                         tree_leaves_with_path(shardings)):
            if not isinstance(leaf, torch.Tensor):      # the step count
                continue
            if len(sh.spec) > leaf.dim():
                raise ValueError(f"{cfg.name} x {shape.name}: spec {sh.spec} "
                                 f"for a {leaf.dim()}-d leaf at {path}")
            size = leaf.element_size()
            out["argument_bytes"] += leaf.numel() * size
            out["argument_bytes_per_device"] += size * math.prod(
                sh.shard_shape(tuple(leaf.shape)))
            out["leaves"] += 1
            out["sharded_leaves"] += any(a is not None for a in sh.spec)
    return out


def model_flops(cfg, shape) -> float:
    n_active = cfg.active_param_count()
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch        # decode: one token


@functools.cache
def device_label(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (asked
    once a device), or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader",
                          f"--id={device.index or 0}"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or torch.cuda.get_device_name(device)


def _batch(cfg, specs, gen, device):
    """Train / prefill inputs of ``input_specs``' shapes from ``gen``."""
    out = {}
    for name, spec in specs.items():
        if spec.dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab, spec.shape, generator=gen,
                                      dtype=torch.int32, device=device)
        elif name == "weights":
            out[name] = torch.ones(spec.shape, device=device)
        else:                                # the VLM's patch embeddings
            out[name] = (torch.randn(spec.shape, generator=gen,
                                     device=device) * 0.02).to(spec.dtype)
    return out


def _cache(specs, gen, device, pos: int):
    """A decode cache of ``input_specs``' shapes filled from ``gen``, its
    position at ``pos``."""
    cache = {}
    for name, spec in specs.items():
        t = torch.empty(spec.shape, dtype=spec.dtype, device=device)
        if name == "pos":
            t.fill_(pos)
        else:
            t.normal_(generator=gen)
        cache[name] = t
    return cache


def _build(cfg, shape, rt, opt, params, gen, device, steps: int):
    """``(one, state)``: one step of the pair as a callable returning what
    is checked for finite values, and the tensors it holds beside the
    parameters."""
    specs = input_specs(cfg, shape, rt)
    if shape.mode == "train":
        opt = opt or momentum(0.9)
        box = [TrainState(params, opt.init(params), 0)]
        batch = _batch(cfg, specs, gen, device)
        step = make_train_step(cfg, rt, opt)

        def one():
            box[0], metrics = step(box[0], batch, 1e-2)
            return metrics["total_loss"]
        return one, {"opt": box[0].opt, "batch": batch}
    if shape.mode == "prefill":
        batch = _batch(cfg, specs, gen, device)
        prefill = make_prefill_step(cfg, rt)

        def one():
            with torch.inference_mode():
                return prefill(params, batch)[..., :cfg.vocab]
        return one, {"batch": batch}
    cache = _cache(specs["cache"], gen, device, shape.seq_len - steps)
    tokens = torch.randint(0, cfg.vocab, specs["tokens"].shape,
                           generator=gen, dtype=torch.int32, device=device)
    serve = make_serve_step(cfg, rt)

    def one():
        with torch.inference_mode():
            return serve(params, cache, tokens)[0][..., :cfg.vocab]
    return one, {"cache": cache, "tokens": tokens}


def _kernel_flops(cfg, shape, rt, launches: dict, visible: int) -> dict:
    """The products of the port's kernels launched in one step."""
    b, s = shape.global_batch, shape.seq_len
    win = rt.win(cfg)
    per = {}
    if cfg.n_heads:
        hq, hd = cfg.n_heads, cfg.hd()
        per["flash_attention_fwd"] = cost.attention_flops(b, s, hq, hd,
                                                          True, win)
        per.update(cost.attention_bwd_flops(b, s, hq, hd, True, win))
        per["flash_decode"] = cost.decode_flops(b, hq, hd, visible)
    if cfg.ssm is not None:
        _, H, _ = m2.dims(cfg)
        per["ssd_scan_fwd"] = cost.ssd_flops(b, s, H, cfg.ssm.head_dim,
                                             cfg.ssm.d_state)
        per["ssd_scan_bwd"] = 2 * per["ssd_scan_fwd"]
    return {name: n * per[name] for name, n in launches.items()
            if n and name in per}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _finite(what: str, t):
    if not bool(torch.isfinite(t).all()):
        raise FloatingPointError(f"{what}: non-finite values")


def run_pair(arch: str, shape_name: str, rt=None, opt=None,
             zero1: bool = False, *, multi_pod: bool = False, device=None,
             layers: int = 0, batch: int = 0, repeats: int = 3) -> dict:
    """Run one (arch × shape) pair on one device; see the module's
    docstring for the row."""
    dev = resolve_device(device)
    full_f32(dev)
    cfg, shape = get_arch(arch), get_shape(shape_name)
    rt = rt or runtime_for(cfg, shape, multi_pod)
    sized = sharded_arguments(cfg, shape, rt,
                              make_production_mesh(multi_pod=multi_pod),
                              opt=opt, zero1=zero1)
    reduced = {}
    if layers and layers != cfg.n_layers:
        reduced["n_layers"] = [cfg.n_layers, layers]
        cfg = dataclasses.replace(cfg, n_layers=layers)
    b = batch or min(shape.global_batch, ONE_CARD_BATCH[shape.mode])
    if b != shape.global_batch:
        reduced["global_batch"] = [shape.global_batch, b]
        shape = dataclasses.replace(shape, global_batch=b)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    try:
        params = init(cfg, gen, rt.dtype)
        one, held = _build(cfg, shape, rt, opt, params, gen, dev,
                           repeats + 1)
        arg_bytes = sum(t.numel() * t.element_size()
                        for t in tree_leaves([params, held]))
        visible = 0
        if shape.mode == "decode":
            ctx = held["cache"]["k"].shape[2] if "k" in held["cache"] else 0
            visible = min(int(held["cache"]["pos"]) + 1, ctx)
        before = {name: k.launches for name, k in KERNELS.items()}
        t0 = time.perf_counter()
        out, counted = cost.count(one)
        _sync(dev)
        first_s = time.perf_counter() - t0
        launches = {name: k.launches - before[name]
                    for name, k in KERNELS.items()}
        _finite(f"{arch} x {shape_name}, first step", out)
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = one()
            _sync(dev)
            times.append(time.perf_counter() - t0)
        _finite(f"{arch} x {shape_name}", out)
        peak_bytes = (torch.cuda.max_memory_allocated(dev)
                      if dev.type == "cuda" else None)
        loss = float(out) if shape.mode == "train" else None
        opt_state = (str(tree_leaves(held["opt"])[0].dtype).split(".")[-1]
                     if shape.mode == "train" else None)
        del params, one, held, out
    finally:
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    kernel_flops = _kernel_flops(cfg, shape, rt, launches, visible)
    flops = counted.flops + sum(kernel_flops.values())
    ms = 1e3 * statistics.median(times)
    tokens = b * (shape.seq_len if shape.mode != "decode" else 1)
    mf = model_flops(cfg, shape)
    on_card = dev.type == "cuda"
    peak = PEAK_FLOPS.get(rt.dtype) if on_card else None
    terms = {"compute_s": flops / peak if peak else None,
             "memory_s": arg_bytes / HBM_BW if on_card else None}
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod),
        "mode": shape.mode, "chips": 1,
        "device": device_label(dev), "dtype": str(rt.dtype).split(".")[-1],
        "runtime": {f.name: str(getattr(rt, f.name))
                    for f in dataclasses.fields(rt)},
        "optimizer_state": opt_state,
        "zero1": zero1, "reduced": reduced, "batch": b,
        "ms_per_step": ms, "ms_min": 1e3 * min(times),
        "ms_max": 1e3 * max(times), "repeats": repeats,
        "first_step_s": first_s, "tokens_per_s": tokens / (ms / 1e3),
        "memory": {"argument_bytes": arg_bytes,
                   "argument_bytes_per_device":
                       sized["argument_bytes_per_device"],
                   "peak_bytes": peak_bytes},
        **terms,
        "dominant": (max(terms, key=terms.get) if on_card and peak
                     else None),
        "counted_flops": counted.flops, "flops_by_op": counted.by_op,
        "kernel_flops": kernel_flops, "flops": flops,
        "launches": {k: n for k, n in launches.items() if n},
        "model_flops_total": mf,
        "useful_flops_ratio": mf / flops if flops else None,
        "mfu": mf / (ms / 1e3) / peak if peak else None,
        "loss": loss,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' for the "
                         "port's CPU path)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers")
    ap.add_argument("--batch", type=int, default=0,
                    help="global batch (default: ONE_CARD_BATCH's)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ASSIGNED
    shapes = [args.shape] if args.shape else list(SHAPES)
    results = []
    for a in archs:
        for s in shapes:
            try:
                r = run_pair(a, s, multi_pod=args.multi_pod,
                             device=args.device, layers=args.layers,
                             batch=args.batch)
                print(f"[dryrun] {a} x {s} x {r['mesh']} on {r['device']}: "
                      f"OK "
                      f"{r['ms_per_step']:.2f} ms a step "
                      f"({r['tokens_per_s']:.1f} tokens/s), peak "
                      + (f"{r['memory']['peak_bytes'] / 2**30:.2f} GiB"
                         if r["memory"]["peak_bytes"] is not None
                         else "not measured")
                      + f", {r['flops']:.4g} FLOPs (model "
                      f"{r['model_flops_total']:.4g}, useful ratio "
                      f"{r['useful_flops_ratio']:.3f}), MFU "
                      + (f"{r['mfu']:.3f}" if r["mfu"] is not None
                         else "not measured")
                      + f", {r['memory']['argument_bytes_per_device']} "
                      f"argument bytes a device of {r['mesh']}, reduced "
                      f"{r['reduced']}", flush=True)
            except Exception as e:                            # noqa: BLE001
                r = {"arch": a, "shape": s, "mesh": mesh_name(args.multi_pod),
                     "error": f"{type(e).__name__}: {e}"}
                print(f"[dryrun] {a} x {s}: FAIL {r['error']}", flush=True)
            results.append(r)
    if args.out:
        with open(args.out, "w") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    fails = [r for r in results if "error" in r]
    print(f"[dryrun] {len(results) - len(fails)}/{len(results)} OK")
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
