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
``dominant``, ``model_flops_total`` and ``useful_flops_ratio`` — and,
on one card, which has no collectives, ``collective_s`` and the
collective bytes are left out.  It adds ``ms_per_step`` (and its
spread), ``tokens_per_s``, ``flops`` (the products PyTorch counted plus
the port's kernels' by formula, :mod:`.cost`), ``launches`` (each
kernel's, in the counted step), ``first_loss`` and ``loss`` (a train
step's first and last) and ``mfu``, the model FLOPs a second over the
H100 SXM's dense peak of the run's dtype (:data:`PEAK_FLOPS`).  On the
CPU the device terms (``compute_s``, ``memory_s``, ``mfu``) are None.

The production mesh sizes the row as the reference's does: ``mesh`` is
``"16x16"``, or ``"2x16x16"`` with ``multi_pod`` (which also gives
``runtime_for`` the reference's ``moe_shard_axes``), and
``memory.argument_bytes_per_device`` is what one device of that mesh
holds of the *uncut* pair's arguments — parameters and train state (or
cache and inputs) at full depth and the full global batch — by the
sharding rules (:func:`sharded_arguments`).  ``zero1`` shards the
optimizer state over the data axes there, so it lowers that figure on a
train shape; ``chips`` stays 1, since the measured step ran on one card.

**On a mesh of several devices** (``mesh="2x2"``, or ``"2x1x2"`` with
``multi_pod``: ``--mesh``), the step runs sharded, one process a device
under ``torch.distributed`` (``torchrun --standalone --nproc-per-node
4``; :func:`~repro_torch.launch.mesh.init_world` raises when there is no
world, so the row never quietly runs on one rank).  Each rank draws the
same parameters and inputs from seed 0 and keeps its shards
(:func:`~repro_torch.launch.sharding.place`, ``place_state`` with
``zero1``), the global batch is :data:`ONE_CARD_BATCH` times the mesh's
data size (or ``batch``; a cut is listed in ``reduced``), and the
warm-up step is counted on each device (:func:`repro_torch.launch.cost.
count_sharded`).  The row gets back the reference's keys: ``chips`` is
the world size, ``collective_bytes_per_device`` and ``collective_by_op``
(rank 0's collectives, at their results' bytes), ``collective_s`` (those
bytes over :data:`NVLINK_BW`) and ``dominant`` over the three terms;
``compute_s`` and ``memory_s`` are per device too (the FLOPs rank 0 ran,
its arguments; the kernels' products at the rows and heads, or part of
the cache, that one device launches them on).  Every assigned arch runs
on a mesh at every shape: the dense, VLM, audio and MoE families (GQA or
MLA), the SSM family and the hybrid with the Mamba-2 mixer on each
rank's heads (its caches split on channels and heads at decode), and
``long_500k``'s decode against the window's ring of 8192 slots split on
its sequence over ``"model"``.  ``memory.argument_bytes_per_device`` is
measured from rank 0's local shards, beside
``memory.sized_argument_bytes_per_device`` (the rules at this mesh and
cut) and
``memory.production_argument_bytes_per_device`` (the production mesh's,
uncut); ``memory.peak_bytes`` is the largest over the ranks.  Rank 0
returns the row (the others return it too) and ``main`` prints it on
rank 0 only.

    python -m repro_torch.launch.dryrun --arch qwen1.5-4b --shape train_4k
    python -m repro_torch.launch.dryrun --arch qwen1.5-4b \\
        --shape decode_32k --device cpu --layers 2 --batch 1 --multi-pod
    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.dryrun \\
        --arch qwen1.5-4b --shape train_4k --mesh 2x2

It runs on the GPU unless ``--device cpu`` is given (on a mesh, ``gloo``
on the CPU), and raises when CUDA is not available.
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
import torch.distributed as dist

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
from repro_torch.fed.train_step import place_state
from repro_torch.launch import cost
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import (data_size, init_world, make_device_mesh,
                                     make_production_mesh, parse_mesh)
from repro_torch.models import mamba2 as m2
from repro_torch.models.model import Runtime, init, param_spec
from repro_torch.models.sharded import is_dtensor
from repro_torch.optim import momentum
from repro_torch.tree import tree_leaves_with_path

# NVIDIA H100 SXM (data sheet): dense peaks by dtype, HBM rate, and NVLink:
# the sheet's 900 GB/s is both directions together, so a device takes in
# at most half of it
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BW = 3.35e12
NVLINK_BW = 450e9

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


def _cache(specs, gen, device, pos: int, mesh=None):
    """A decode cache of ``input_specs``' shapes filled from ``gen``, its
    position at ``pos``; on ``mesh`` each leaf is placed by
    ``cache_shardings`` as soon as it is drawn, so a card holds one whole
    leaf at a time (a 32k cache does not fit on one card whole)."""
    cache = {}
    for name, spec in specs.items():
        t = torch.empty(spec.shape, dtype=spec.dtype, device=device)
        if name == "pos":
            t.fill_(pos)
        else:
            t.normal_(generator=gen)
        if mesh is not None:
            t = shd.place({name: t}, shd.cache_shardings(mesh, {name: t}))[
                name]
        cache[name] = t
    return cache


def _build(cfg, shape, rt, opt, params, gen, device, steps: int,
           mesh=None, zero1: bool = False):
    """``(one, held)``: one step of the pair as a callable returning what
    is checked for finite values, and the step's arguments (the
    parameters, or the train state, and the inputs).  On ``mesh`` (over a
    world) every argument is placed by the rules, the optimizer state by
    ``zero1``'s when asked."""
    specs = input_specs(cfg, shape, rt)
    put = (lambda tree, rule: tree) if mesh is None else (
        lambda tree, rule: shd.place(tree, rule(mesh, tree)))
    # DTensor runs no view under inference mode: no_grad on a mesh
    infer = torch.inference_mode if mesh is None else torch.no_grad
    if shape.mode == "train":
        opt = opt or momentum(0.9)
        box = [TrainState(params, opt.init(params), 0) if mesh is None
               else place_state(params, opt, mesh, zero1=zero1)]
        batch = put(_batch(cfg, specs, gen, device), shd.batch_shardings)
        step = make_train_step(cfg, rt, opt)

        def one():
            box[0], metrics = step(box[0], batch, 1e-2)
            return metrics["total_loss"]
        return one, {"state": box[0], "batch": batch}
    params = put(params, shd.params_shardings)
    if shape.mode == "prefill":
        batch = put(_batch(cfg, specs, gen, device), shd.batch_shardings)
        prefill = make_prefill_step(cfg, rt)

        def one():
            with infer():
                return _whole(prefill(params, batch))[..., :cfg.vocab]
        return one, {"params": params, "batch": batch}
    cache = _cache(specs["cache"], gen, device, shape.seq_len - steps, mesh)
    tokens = put({"t": torch.randint(0, cfg.vocab, specs["tokens"].shape,
                                     generator=gen, dtype=torch.int32,
                                     device=device)},
                 shd.batch_shardings)["t"]
    serve = make_serve_step(cfg, rt)

    def one():
        with infer():
            return _whole(serve(params, cache, tokens)[0])[..., :cfg.vocab]
    return one, {"params": params, "cache": cache, "tokens": tokens}


def _whole(t):
    """A DTensor as its full tensor (a plain tensor as it is)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _local_bytes(tree) -> int:
    """The bytes of ``tree``'s tensors on this device (a DTensor's local
    shard)."""
    return sum((t.to_local() if is_dtensor(t) else t).numel()
               * t.element_size() for _, t in tree_leaves_with_path(tree)
               if isinstance(t, torch.Tensor))


def _kernel_flops(cfg, shape, rt, launches: dict, visible: int,
                  rows: int = 0, split: int = 1) -> dict:
    """The products of the port's kernels launched in one step on one
    device: its ``rows`` of the batch (default all of it) and, over a
    ``"model"`` axis of ``split``, its part of the heads (B4, B3) or of
    the heads or the cache (B5: each card scores ``1 / split`` of the
    visible (head, slot) pairs)."""
    b, s = rows or shape.global_batch, shape.seq_len
    win = rt.win(cfg)
    per = {}
    if cfg.n_heads:
        hq, hd = cfg.n_heads, cfg.hd()
        per["flash_attention_fwd"] = cost.attention_flops(
            b, s, hq // split, hd, True, win)
        per.update(cost.attention_bwd_flops(b, s, hq // split, hd, True,
                                            win))
        per["flash_decode"] = cost.decode_flops(b, hq, hd, visible) // split
    if cfg.ssm is not None:
        _, H, _ = m2.dims(cfg)
        per["ssd_scan_fwd"] = cost.ssd_flops(b, s, H // split,
                                             cfg.ssm.head_dim,
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


def _on_mesh(mesh, multi_pod: bool, device):
    """``(Mesh, this rank's device)`` for ``run_pair``'s ``mesh``: a Mesh
    over the world, or its text (``"2x2"``) made over the world — which
    must be initialised already or come from the environment
    (:func:`init_world` raises otherwise)."""
    if isinstance(mesh, str):
        backend = "gloo" if torch.device(device or "cuda").type == "cpu" \
            else None
        init_world(backend)
        mesh = make_device_mesh(*parse_mesh(mesh, multi_pod))
    if mesh.device_mesh is None:
        raise ValueError(f"mesh {mesh.shape} is not over a world; build it "
                         "with launch.mesh.make_device_mesh")
    return mesh, mesh.devices[dist.get_rank()]


def _max_over_ranks(value: int, device) -> int:
    t = torch.tensor([value], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def run_pair(arch: str, shape_name: str, rt=None, opt=None,
             zero1: bool = False, *, multi_pod: bool = False, device=None,
             layers: int = 0, batch: int = 0, repeats: int = 3,
             mesh=None) -> dict:
    """Run one (arch × shape) pair on one device, or sharded over ``mesh``
    (``"2x2"``, ``"2x1x2"`` with ``multi_pod``, or a Mesh over the
    world); see the module's docstring for the row."""
    if mesh is not None:
        mesh, dev = _on_mesh(mesh, multi_pod, device)
    else:
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
    ways = data_size(mesh) if mesh is not None else 1
    b = batch or min(shape.global_batch, ONE_CARD_BATCH[shape.mode] * ways)
    if b != shape.global_batch:
        reduced["global_batch"] = [shape.global_batch, b]
        shape = dataclasses.replace(shape, global_batch=b)
    chips = mesh.size if mesh is not None else 1
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    try:
        params = init(cfg, gen, rt.dtype)
        one, held = _build(cfg, shape, rt, opt, params, gen, dev,
                           repeats + 1, mesh=mesh, zero1=zero1)
        del params            # on a mesh, each rank keeps its shards only
        gc.collect()
        arg_bytes = _local_bytes(held)
        visible = 0
        if shape.mode == "decode":
            cache = held["cache"]
            ctx = cache["k"].shape[2] if "k" in cache else 0
            visible = min(int(_whole(cache["pos"])) + 1, ctx)
        before = {name: k.launches for name, k in KERNELS.items()}
        t0 = time.perf_counter()
        if mesh is None:
            out, counted = cost.count(one)
            coll = None
        else:
            out, counted, coll = cost.count_sharded(one)
        _sync(dev)
        first_s = time.perf_counter() - t0
        launches = {name: k.launches - before[name]
                    for name, k in KERNELS.items()}
        _finite(f"{arch} x {shape_name}, first step", out)
        first_loss = float(out) if shape.mode == "train" else None
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = one()
            _sync(dev)
            times.append(time.perf_counter() - t0)
        _finite(f"{arch} x {shape_name}", out)
        peak_bytes = (torch.cuda.max_memory_allocated(dev)
                      if dev.type == "cuda" else None)
        if mesh is not None and peak_bytes is not None:
            peak_bytes = _max_over_ranks(peak_bytes, dev)
        loss = float(out) if shape.mode == "train" else None
        opt_state = (str(tree_leaves_with_path(held["state"].opt)[0][1].dtype
                         ).split(".")[-1]
                     if shape.mode == "train" else None)
        del one, held, out
    finally:
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    # the kernels run on each device's rows and heads (or part of the
    # cache): what one device launched
    split = mesh.shape.get("model", 1) if mesh is not None else 1
    kernel_flops = _kernel_flops(cfg, shape, rt, launches, visible,
                                 rows=b // ways if b % ways == 0 else b,
                                 split=split)
    flops = counted.flops + sum(kernel_flops.values())
    ms = 1e3 * statistics.median(times)
    tokens = b * (shape.seq_len if shape.mode != "decode" else 1)
    mf = model_flops(cfg, shape)
    on_card = dev.type == "cuda"
    peak = PEAK_FLOPS.get(rt.dtype) if on_card else None
    terms = {"compute_s": flops / peak if peak else None,
             "memory_s": arg_bytes / HBM_BW if on_card else None}
    memory = {"argument_bytes": arg_bytes,
              "argument_bytes_per_device": sized["argument_bytes_per_device"],
              "peak_bytes": peak_bytes}
    collectives = {}
    if mesh is not None:
        terms["collective_s"] = coll.bytes / NVLINK_BW if on_card else None
        at_mesh = sharded_arguments(cfg, shape, rt, mesh, opt=opt,
                                    zero1=zero1)
        memory = {"argument_bytes": at_mesh["argument_bytes"],
                  "argument_bytes_per_device": arg_bytes,
                  "sized_argument_bytes_per_device":
                      at_mesh["argument_bytes_per_device"],
                  "production_argument_bytes_per_device":
                      sized["argument_bytes_per_device"],
                  "peak_bytes": peak_bytes}
        collectives = {"collective_bytes_per_device": coll.bytes,
                       "collective_by_op": coll.by_op,
                       "collective_count_by_op": coll.count}
    return {
        "arch": arch, "shape": shape_name,
        "mesh": ("x".join(map(str, mesh.axis_sizes)) if mesh is not None
                 else mesh_name(multi_pod)),
        "mode": shape.mode, "chips": chips,
        "device": device_label(dev), "dtype": str(rt.dtype).split(".")[-1],
        "runtime": {f.name: str(getattr(rt, f.name))
                    for f in dataclasses.fields(rt)},
        "optimizer_state": opt_state,
        "zero1": zero1, "reduced": reduced, "batch": b,
        "ms_per_step": ms, "ms_min": 1e3 * min(times),
        "ms_max": 1e3 * max(times), "repeats": repeats,
        "first_step_s": first_s, "tokens_per_s": tokens / (ms / 1e3),
        "memory": memory,
        **collectives,
        **terms,
        "dominant": (max(terms, key=terms.get) if on_card and peak
                     else None),
        "counted_flops": counted.flops, "flops_by_op": counted.by_op,
        "kernel_flops": kernel_flops, "flops": flops,
        "launches": {k: n for k, n in launches.items() if n},
        "model_flops_total": mf,
        "useful_flops_ratio": mf / (chips * flops) if flops else None,
        "mfu": mf / (ms / 1e3) / (chips * peak) if peak else None,
        "loss": loss, "first_loss": first_loss,
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
                    help="global batch (default: ONE_CARD_BATCH's, times "
                         "the mesh's data size)")
    ap.add_argument("--mesh", default=None,
                    help="run sharded over this mesh of the torch."
                         "distributed world, e.g. 2x2 (2x1x2 with "
                         "--multi-pod), under torchrun")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ASSIGNED
    shapes = [args.shape] if args.shape else list(SHAPES)
    results = []
    for a in archs:
        for s in shapes:
            try:
                r = run_pair(a, s, multi_pod=args.multi_pod,
                             device=args.device, layers=args.layers,
                             batch=args.batch, mesh=args.mesh)
                say(f"[dryrun] {a} x {s} x {r['mesh']} on {r['device']}: "
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
                      f"argument bytes a device of {r['mesh']}"
                      + (f", collectives {r['collective_by_op']} "
                         f"({r['collective_s']} s)"
                         if "collective_by_op" in r else "")
                      + f", reduced {r['reduced']}")
            except Exception as e:                            # noqa: BLE001
                r = {"arch": a, "shape": s,
                     "mesh": args.mesh or mesh_name(args.multi_pod),
                     "error": f"{type(e).__name__}: {e}"}
                say(f"[dryrun] {a} x {s}: FAIL {r['error']}")
            results.append(r)
    if args.out and rank0():
        with open(args.out, "w") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    fails = [r for r in results if "error" in r]
    say(f"[dryrun] {len(results) - len(fails)}/{len(results)} OK")
    sys.exit(1 if fails else 0)


def rank0() -> bool:
    """Whether this process prints: rank 0 of a world, or the only one."""
    return (not torch.distributed.is_initialized()
            or dist.get_rank() == 0)


def say(text: str):
    if rank0():
        print(text, flush=True)


if __name__ == "__main__":
    main()
