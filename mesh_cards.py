#!/usr/bin/env python3
"""The batch mesh over distinct cards, and the sharded step over a
four-card ``torch.distributed`` world, on a machine with NVIDIA GPUs
(two or more; four for the world).

    python3 mesh_cards.py                  # both parts
    python3 mesh_cards.py --parts world    # the four-card world alone
    python3 mesh_cards.py --parts world --world f,d,e,g

Phase 4q (iii) of ``chip_smoke.py`` runs the batch mesh over two entries
of one card.  This script runs the same cell (``chip_smoke.
batch_mesh_cell``: the main cell at full width, 16 rows, K = 12, 20
periods; a 3-row ragged bucket padded to the mesh;
``AsyncExecutor(mesh=)``; a short ``ExperimentService(mesh=)`` tape)
twice with the same number of shards:

* over ``make_batch_mesh()``, every card the process sees, so each
  shard's loop and its SBC kernels (B1/B2) run on a card of its own;
* over as many entries of the first card.

The two must be bitwise equal, run by run (losses, accuracies, times,
global batch): the shards run the same programs at the same shapes on
identical cards, so distinct cards may change nothing.  Each run's host
ledgers must be bitwise ``SerialExecutor``'s on the first card alone and
B1/B2 must launch 6 times a period a shard; the losses' and accuracies'
gaps to the serial run are printed against the reference's 1e-5, which a
shard of one row can miss on the card (its batched products run at
another row count).  To tell that apart from the mesh, each row of the
ragged bucket also runs alone (``SerialExecutor`` on the first card) and
is held against its row in the 3-row serial run, period by period, and
against its shard over the cards.  ``MeshExecutor()`` with no mesh must
build the mesh of every card.  Prints each card's name and power limit,
each run's wall beside the serial one's, and as its last line one JSON
object; exits 1 on any failure and when fewer than two cards are
visible.

**The four-card world** (``--parts world``; four processes, one a card,
NCCL, a (2, 2) ``("data", "model")`` mesh, ``launch.mesh.
make_device_mesh``), the sharded step of ``launch.dryrun``:

* (a) agreement with one card: qwen1.5-4b at full width and
  ``A_LAYERS`` of its 40 layers in float32 (``runtime_for``'s blockwise
  attention and remat, global batch 2 of 4096 tokens), under baseline,
  ZeRO-1, ``seq_parallel`` and ``attn_impl="pallas"`` (B4, B4', B4'' on
  each card's heads), each against the same step on card 0 alone: the
  first loss within rtol 1e-5, the parameters after 2 steps within 1e-4;
* (b) qwen1.5-4b at full width and depth in bf16: ``run_pair``'s
  train_4k rows at global batch 2 under the same four variants, the first
  loss within ``bf16_tols`` of card 0's loss of the same weights and
  batch, and decode_32k at batch 4, 16 steps under B5 (each card its rows
  and half of the 32k cache, merged by the kernel's log-sum-exp);
* (c) deepseek-v2-lite-16b train_4k under ZeRO-1 and
  ``moe_shard_axes=("data",)``: its ``C_CUT``-layer cut first, the first
  loss within 2e-2 of card 0's, then all 27 layers;
* (d) mamba2-2.7b, the Mamba-2 mixer on each card's heads: at
  ``D_CUT`` layers in float32 the train step under baseline, ZeRO-1 and
  ``seq_parallel`` against card 0 alone as in (a), and ``DECODE_AGREE``
  decode_32k steps against DTensor conv and SSM caches, the logits within
  1e-4 of card 0's; then at all 64 layers in bf16 ``run_pair``'s
  train_4k rows under the three variants, prefill_32k and decode_32k;
* (e) zamba2-7b (the mixer and the shared attention block): train_4k
  under ZeRO-1 at its ``E_CUT``-layer cut, the first loss within
  ``bf16_tols`` of card 0's, then at all 81 layers (one card holds 54),
  and decode_32k and long_500k under B5;
* (f) qwen1.5-4b at long_500k: ``F_STEPS`` decode steps under B5 against
  the window's ring of 8192 slots split on its sequence over ``"model"``
  (each card its half of the ring, ``off`` and ``ring``), at ``F_CUT``
  layers in float32 the logits within 1e-4 of card 0's unsplit ring,
  then at all 40 layers in bf16;
* (g) the other GQA archs at long_500k (mistral-nemo-12b, granite-34b,
  llava-next-mistral-7b, musicgen-large, arctic-480b), their depth cut
  (``G_ARCHS``), 2 decode steps under B5 on the split ring each.

Each row gives ms a step, tokens/s, the peak GiB of the fullest card, the
collectives by op and MFU, beside the cards' name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIELDS = ("losses", "accs", "times", "global_batch")

# the four-card world
W_MESH = (2, 2)
W_VARIANTS = ("baseline", "zero1", "seq_parallel", "pallas")
A_ARCH, A_LAYERS, A_STEPS, A_LR = "qwen1.5-4b", 4, 2, 1e-2
DECODE_BATCH, DECODE_STEPS = 4, 16
C_ARCH, C_CUT = "deepseek-v2-lite-16b", 6
D_ARCH, D_CUT, D_VARIANTS = "mamba2-2.7b", 4, ("baseline", "zero1",
                                                "seq_parallel")
DECODE_AGREE, D_DECODE_STEPS = 4, 4
E_ARCH, E_CUT = "zamba2-7b", 9
F_ARCH, F_CUT, F_STEPS = "qwen1.5-4b", 4, 16
# (g): the other GQA archs at long_500k, their depth cut (arctic-480b's
# layer alone is 27 GB of bf16 experts, drawn whole on each card)
G_ARCHS = (("mistral-nemo-12b", 2), ("granite-34b", 2),
           ("llava-next-mistral-7b", 2), ("musicgen-large", 2),
           ("arctic-480b", 1))
WORLD_TIMEOUT = 1500.0


def _same(a, b) -> bool:
    """Two ``Results`` (or lists of them, ticket by ticket) bitwise."""
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    import numpy as np
    return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


def rows_alone(env, api, DeviceProfile, cs, sharded, smi) -> list:
    """Each row of phase 4q's ragged bucket run alone, serially on the
    first card, against the same row in the bucket's serial run (the
    losses' gap at the first period, its largest and the first period it
    is not 0) and against its one-row shard over the cards (``sharded``;
    bitwise where the row's K is the bucket's padded K)."""
    import numpy as np
    ragged = [cs._service_specs(env, partition=p, seeds=(0,), name=f"K{k}",
                                fleet=cs.fleet(DeviceProfile, k))
              for p, k in zip(("iid", "noniid", "iid"), cs.Q_RAGGED_K)]
    together = api.Experiment(env.data, env.test, ragged).run(
        cs.PERIODS, executor=api.SerialExecutor())
    out = []
    for i, spec in enumerate(ragged):
        got = api.Experiment(env.data, env.test, [spec]).run(
            cs.PERIODS, executor=api.SerialExecutor())
        gap = np.abs(got.losses[0] - together.losses[i])
        moved = np.flatnonzero(gap)
        same = bool(np.array_equal(got.losses[0], sharded.losses[i])
                    and np.array_equal(got.accs[0], sharded.accs[i]))
        row = {"row": i, "k": spec.k, "gap_first": float(gap[0]),
               "gap_max": float(gap.max()),
               "first_moved": int(moved[0]) if moved.size else None,
               "bitwise_shard": same}
        out.append(row)
        print(f"[alone] ragged row {i} (K {spec.k}) alone on the first card "
              f"vs the same row in the 3-row serial run: losses gap "
              f"{row['gap_first']:.3g} at period 0, largest "
              f"{row['gap_max']:.3g}, first non-zero at period "
              f"{row['first_moved']}; bitwise its one-row shard over the "
              f"cards: {'yes' if same else 'no'}; {smi}", flush=True)
    return out


def _variant(rt, name: str):
    """``(rt, zero1)`` of a four-card variant over ``rt``."""
    knobs = {"seq_parallel": {"seq_parallel": True},
             "pallas": {"attn_impl": "pallas"}}
    return dataclasses.replace(rt, **knobs.get(name, {})), name == "zero1"


def _one_card_loss(torch, cfg, shape, rt, device):
    """Card 0's loss (CE + aux) of the weights and batch ``run_pair``
    draws from seed 0 on ``device``, forward only."""
    from repro_torch.fed import train_step as ts
    from repro_torch.launch import dryrun
    from repro_torch.models import model as tm
    gen = torch.Generator(device=device).manual_seed(0)
    params = tm.init(cfg, gen, rt.dtype)
    batch = dryrun._batch(cfg, ts.input_specs(cfg, shape, rt), gen, device)
    with torch.no_grad():
        loss = ts.make_loss_fn(cfg, rt)(tm._one_copy(params),
                                        tm._one_copy(batch))[0]
    out = float(loss)
    del params, batch, loss
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _row(tag, r, smi) -> str:
    peak = r["memory"]["peak_bytes"] / 2**30
    return (f"[world {tag}] {r['arch']} x {r['shape']} on the {r['mesh']} "
            f"mesh ({r['chips']} cards), {r['dtype']}, batch {r['batch']}, "
            f"zero1 {r['zero1']}, reduced {r['reduced']}: "
            f"{r['ms_per_step']:.1f} ms a step ({r['ms_min']:.1f}-"
            f"{r['ms_max']:.1f}) = {r['tokens_per_s']:.1f} tokens/s; peak "
            f"{peak:.2f} GiB on the fullest card; arguments "
            f"{r['memory']['argument_bytes_per_device'] / 2**30:.3f} GiB a "
            f"card (sized "
            f"{r['memory']['sized_argument_bytes_per_device'] / 2**30:.3f});"
            f" collectives {r['collective_by_op']} bytes a card "
            f"({r['collective_count_by_op']}), collective_s "
            f"{r['collective_s']:.4g}, compute_s {r['compute_s']:.4g}, "
            f"memory_s {r['memory_s']:.4g}, dominant {r['dominant']}; MFU "
            f"{r['mfu']:.4f}; launches {r['launches']}; first loss "
            f"{r['first_loss']}; {smi}")


def _agreement(torch, cs, mesh, smi, arch=A_ARCH, layers=A_LAYERS,
               variants=W_VARIANTS, tag="a") -> dict:
    """(a): ``arch`` at ``layers`` layers in float32, each variant on the
    mesh against card 0 alone (also (d)'s cut)."""
    import torch.distributed as dist
    from repro_torch import optim
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.fed import train_step as ts
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as shd
    from repro_torch.models import model as tm
    from repro_torch.tree import tree_leaves_with_path, tree_map
    rank, dev = dist.get_rank(), torch.device("cuda", torch.cuda.current_device())
    cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
    shape = get_shape("train_4k")
    base_rt = dataclasses.replace(dryrun.runtime_for(cfg, shape),
                                  dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(21)
    params0 = tm.init(cfg, gen, torch.float32)
    toks = torch.randint(0, cfg.vocab, (2, shape.seq_len + 1), generator=gen,
                         device=dev, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous(),
             "weights": torch.ones((2, shape.seq_len), device=dev)}
    leaves = lambda t: [x for _, x in tree_leaves_with_path(t)]  # noqa
    one_card, out = {}, {}
    for variant in variants:
        rt, zero1 = _variant(base_rt, variant)
        if rank == 0 and rt.attn_impl not in one_card:
            opt = optim.momentum(0.9)
            p = tree_map(torch.clone, params0)
            state = ts.TrainState(p, opt.init(p), 0)
            step = ts.make_train_step(cfg, rt, opt)
            losses = []
            for _ in range(A_STEPS):
                state, m = step(state, batch, A_LR)
                losses.append(float(m["loss"]))
            one_card[rt.attn_impl] = (losses, leaves(state.params))
            del state, p
        dist.barrier()
        opt = optim.momentum(0.9)
        state = ts.place_state(tree_map(torch.clone, params0), opt, mesh,
                               zero1=zero1)
        b = shd.place(batch, shd.batch_shardings(mesh, batch))
        step = ts.make_train_step(cfg, rt, opt)
        losses, ms = [], []
        for _ in range(A_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b, A_LR)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(m["loss"]))
        got = leaves(shd.gather(state.params))
        del state, b
        if rank == 0:
            want_losses, want = one_card[rt.attn_impl]
            loss_gap = abs(losses[0] - want_losses[0]) / abs(want_losses[0])
            gap = max(float((a - w).abs().max()) for a, w in zip(got, want))
            ok = loss_gap <= 1e-5 and all(
                torch.allclose(a, w, rtol=1e-4, atol=1e-4)
                for a, w in zip(got, want))
            out[variant] = {"losses": losses, "one_card": want_losses,
                            "first_loss_rel_gap": loss_gap,
                            "params_max_abs_gap": gap, "ms": ms, "ok": ok}
            print(f"[world ({tag})] {arch} at full width, {layers} layers, "
                  f"f32, {rt.attn_impl}, batch 2 x {shape.seq_len} on the "
                  f"2x2 mesh, {variant}: losses {losses} vs card 0's "
                  f"{want_losses} (first: rel gap {loss_gap:.3g}, tol "
                  f"1e-5); parameters after {A_STEPS} steps max abs gap "
                  f"{gap:.3g} (tol 1e-4): {'ok' if ok else 'FAIL'}; ms a "
                  f"step {[round(t, 1) for t in ms]}; {smi}", flush=True)
        del got
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _full_qwen(torch, cs, mesh, smi, counted) -> dict:
    """(b): qwen1.5-4b at full width and depth in bf16, run_pair's
    train_4k rows on the mesh, the first loss against card 0's."""
    import torch.distributed as dist
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.launch import dryrun
    rank, dev = dist.get_rank(), torch.device("cuda", torch.cuda.current_device())
    cfg, shape = get_arch(A_ARCH), get_shape("train_4k")
    out = {"train": {}}
    for variant in W_VARIANTS:
        rt, zero1 = _variant(dryrun.runtime_for(cfg, shape), variant)
        cs._zero(counted)
        r = dryrun.run_pair(A_ARCH, "train_4k", rt=rt, zero1=zero1,
                            mesh=mesh, repeats=2)
        r["launches_run"] = cs._read(counted)
        if rank == 0:
            want = _one_card_loss(torch, cfg, dataclasses.replace(
                shape, global_batch=r["batch"]), rt, dev)
            rtol, atol = cs.bf16_tols(torch.tensor(want))
            r["one_card_first_loss"] = want
            r["first_loss_ok"] = abs(r["first_loss"] - want) <= atol + \
                rtol * abs(want)
            print(_row(f"(b) train {variant}", r, smi)
                  + f"; card 0's first loss {want} (bf16_tols rtol {rtol}, "
                  f"atol {atol:.3g}): "
                  f"{'ok' if r['first_loss_ok'] else 'FAIL'}", flush=True)
        dist.barrier()
        out["train"][variant] = r
    return out


def _decode(torch, cs, mesh, smi, counted) -> dict:
    """(b), decode: qwen1.5-4b's decode_32k at batch DECODE_BATCH under
    B5 on the mesh, DECODE_STEPS steps up to the last slot."""
    from repro_torch.configs import get_arch
    r = _rows(torch, cs, mesh, smi, counted, A_ARCH, {
        "decode pallas": ("decode_32k", "pallas",
                          {"batch": DECODE_BATCH,
                           "repeats": DECODE_STEPS - 1})}, "b")[
        "decode pallas"]
    want = get_arch(A_ARCH).n_layers * DECODE_STEPS
    r["launches_ok"] = r["launches_run"].get("flash_decode") == want
    return r


def _deepseek(torch, cs, mesh, smi) -> dict:
    """(c): deepseek-v2-lite-16b train_4k under ZeRO-1, its cut against
    card 0 first, then at full depth."""
    import torch.distributed as dist
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.launch import dryrun
    cfg, shape = get_arch(C_ARCH), get_shape("train_4k")
    rt = dryrun.runtime_for(cfg, shape)
    out = {"cut": _cut_loss(torch, cs, mesh, smi, C_ARCH, C_CUT, "c",
                            rtol=2e-2)}
    r = dryrun.run_pair(C_ARCH, "train_4k", rt=rt, zero1=True, mesh=mesh,
                        repeats=2)
    if dist.get_rank() == 0:
        print(_row(f"(c) train zero1, all {cfg.n_layers} layers", r, smi),
              flush=True)
    out["full"] = r
    return out


def _decode_agreement(torch, cs, mesh, smi, arch, layers, shape_name,
                      steps, tag) -> dict:
    """``steps`` decode steps of ``arch`` at ``layers`` layers in float32
    under B5 at ``shape_name``'s cache (a ring under ``runtime_for``'s
    window), batch ``DECODE_BATCH``, on the mesh (the cache placed by
    ``cache_shardings``) against card 0 alone: the logits within 1e-4."""
    import torch.distributed as dist
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.fed import train_step as ts
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as shd
    from repro_torch.models import model as tm
    from repro_torch.tree import tree_map
    rank, dev = dist.get_rank(), torch.device("cuda", torch.cuda.current_device())
    cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
    shape = dataclasses.replace(get_shape(shape_name),
                                global_batch=DECODE_BATCH)
    rt = dataclasses.replace(dryrun.runtime_for(cfg, shape),
                             dtype=torch.float32, attn_impl="pallas")
    gen = torch.Generator(device=dev).manual_seed(23)
    params = tm.init(cfg, gen, torch.float32)
    specs = ts.input_specs(cfg, shape, rt)
    cache0 = dryrun._cache(specs["cache"], gen, dev, shape.seq_len - steps)
    tokens = torch.randint(0, cfg.vocab, (steps, DECODE_BATCH, 1),
                           generator=gen, device=dev, dtype=torch.int32)
    serve = ts.make_serve_step(cfg, rt)
    want = None
    with torch.no_grad():
        if rank == 0:
            c = tree_map(torch.clone, cache0)
            want = torch.stack([serve(params, c, t)[0] for t in tokens])
            del c
        dist.barrier()
        p = shd.place(params, shd.params_shardings(mesh, params))
        c = shd.place(tree_map(torch.clone, cache0),
                      shd.cache_shardings(mesh, cache0))
        got = []
        for t in tokens:
            t = shd.place({"t": t}, shd.batch_shardings(mesh, {"t": t}))["t"]
            got.append(shd.gather({"l": serve(p, c, t)[0]})["l"])
        got = torch.stack(got)
    out = {}
    if rank == 0:
        gap = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, rtol=1e-4, atol=1e-4))
        ring = {k: tuple(v.shape) for k, v in cache0.items() if v.dim()}
        out = {"logits_max_abs_gap": gap, "ok": ok, "cache": ring}
        print(f"[world ({tag})] {arch} at full width, {layers} layers, f32, "
              f"pallas, {shape_name} decode, batch {DECODE_BATCH}, {steps} "
              f"steps from pos {shape.seq_len - steps} on the 2x2 mesh "
              f"(cache {ring}, placed by cache_shardings) vs card 0 alone: "
              f"logits max abs gap {gap:.3g} (tol 1e-4): "
              f"{'ok' if ok else 'FAIL'}; {smi}", flush=True)
    del p, c, params, cache0
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _rows(torch, cs, mesh, smi, counted, arch, runs, tag) -> dict:
    """``run_pair`` rows of ``arch`` on the mesh: ``runs`` maps a label to
    ``(shape, variant, kwargs)``; each row's launches counted around
    it."""
    import torch.distributed as dist
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.launch import dryrun
    cfg = get_arch(arch)
    out = {}
    for label, (shape, variant, kw) in runs.items():
        rt, zero1 = _variant(dryrun.runtime_for(cfg, get_shape(shape)),
                             variant)
        cs._zero(counted)
        r = dryrun.run_pair(arch, shape, rt=rt, zero1=zero1, mesh=mesh,
                            **kw)
        r["launches_run"] = cs._read(counted)
        if dist.get_rank() == 0:
            print(_row(f"({tag}) {label}", r, smi)
                  + f"; launches on card 0 in the run {r['launches_run']}",
                  flush=True)
        dist.barrier()
        out[label] = r
    return out


def _cut_loss(torch, cs, mesh, smi, arch, layers, tag, rtol=None) -> dict:
    """train_4k of ``arch`` cut to ``layers`` under ZeRO-1 on the mesh,
    its first loss against card 0's within ``bf16_tols`` (or ``rtol``)."""
    import torch.distributed as dist
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.launch import dryrun
    rank, dev = dist.get_rank(), torch.device("cuda", torch.cuda.current_device())
    cfg, shape = get_arch(arch), get_shape("train_4k")
    rt = dryrun.runtime_for(cfg, shape)
    r = dryrun.run_pair(arch, "train_4k", rt=rt, zero1=True, mesh=mesh,
                        layers=layers, repeats=1)
    if rank == 0:
        want = _one_card_loss(torch, dataclasses.replace(cfg, n_layers=layers),
                              dataclasses.replace(shape,
                                                  global_batch=r["batch"]),
                              rt, dev)
        tol, atol = ((rtol, 0.0) if rtol
                     else cs.bf16_tols(torch.tensor(want)))
        r["one_card_first_loss"] = want
        r["first_loss_ok"] = abs(r["first_loss"] - want) <= atol + \
            tol * abs(want)
        print(_row(f"({tag}) train zero1, {layers} layers", r, smi)
              + f"; card 0's first loss {want} (rtol {tol}, atol "
              f"{atol:.3g}): {'ok' if r['first_loss_ok'] else 'FAIL'}",
              flush=True)
    dist.barrier()
    return r


def _mamba2(torch, cs, mesh, smi, counted) -> dict:
    """(d): mamba2-2.7b on the mesh."""
    out = {"agree": _agreement(torch, cs, mesh, smi, D_ARCH, D_CUT,
                               D_VARIANTS, "d"),
           "decode_agree": _decode_agreement(torch, cs, mesh, smi, D_ARCH,
                                             D_CUT, "decode_32k",
                                             DECODE_AGREE, "d")}
    runs = {f"train {v}": ("train_4k", v, {"repeats": 2})
            for v in D_VARIANTS}
    runs["prefill"] = ("prefill_32k", "baseline", {"repeats": 1})
    runs["decode"] = ("decode_32k", "baseline",
                      {"repeats": D_DECODE_STEPS - 1})
    out["rows"] = _rows(torch, cs, mesh, smi, counted, D_ARCH, runs, "d")
    return out


def _zamba2(torch, cs, mesh, smi, counted) -> dict:
    """(e): zamba2-7b on the mesh."""
    out = {"cut": _cut_loss(torch, cs, mesh, smi, E_ARCH, E_CUT, "e")}
    out["rows"] = _rows(torch, cs, mesh, smi, counted, E_ARCH, {
        "train zero1": ("train_4k", "zero1", {"repeats": 1}),
        "prefill pallas": ("prefill_32k", "pallas", {"repeats": 1}),
        "decode pallas": ("decode_32k", "pallas",
                          {"repeats": D_DECODE_STEPS - 1}),
        "long_500k pallas": ("long_500k", "pallas",
                             {"repeats": D_DECODE_STEPS - 1})}, "e")
    return out


def _long_sweep(torch, cs, mesh, smi, counted) -> dict:
    """(g): each arch of ``G_ARCHS`` at long_500k under B5 against the
    window's ring split on its sequence, its depth cut, 2 steps; B5
    launched once a layer a step on card 0."""
    out = {}
    for arch, layers in G_ARCHS:
        r = _rows(torch, cs, mesh, smi, counted, arch, {
            f"long_500k pallas, {layers} layers": (
                "long_500k", "pallas", {"repeats": 1, "layers": layers})},
            "g")[f"long_500k pallas, {layers} layers"]
        r["launches_ok"] = r["launches_run"].get("flash_decode") == 2 * layers
        out[arch] = r
    return out


def _long_ring(torch, cs, mesh, smi, counted) -> dict:
    """(f): qwen1.5-4b's long_500k decode against the ring split on its
    sequence."""
    from repro_torch.configs import get_arch
    out = {"agree": _decode_agreement(torch, cs, mesh, smi, F_ARCH, F_CUT,
                                      "long_500k", F_STEPS, "f")}
    out["rows"] = _rows(torch, cs, mesh, smi, counted, F_ARCH, {
        "long_500k pallas": ("long_500k", "pallas",
                             {"repeats": F_STEPS - 1})}, "f")
    want = get_arch(F_ARCH).n_layers * F_STEPS
    r = out["rows"]["long_500k pallas"]
    r["launches_ok"] = r["launches_run"].get("flash_decode") == want
    return out


def four_card_world(cells: tuple) -> dict:
    """Rank body of the four-card world: the cells ``cells`` of (a), (b)
    (``"b"`` its training, ``"bd"`` its decode), (c), (d), (e), (f) and
    (g) on a (2, 2) mesh; rank 0's report."""
    import torch
    import chip_smoke as cs
    from repro_torch.fed.engine import full_f32
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.launch.mesh import make_device_mesh
    full_f32("cuda")
    smi = cs.nvidia_smi_line()
    mesh = make_device_mesh(W_MESH, ("data", "model"))
    counted = {"flash_attention_fwd": kfa.flash_attention_fwd,
               "flash_attention_bwd_dq": kfa.flash_attention_bwd_dq,
               "flash_attention_bwd_dkdv": kfa.flash_attention_bwd_dkdv,
               "flash_decode": kfd.flash_decode,
               "ssd_scan_fwd": kssd.ssd_scan_fwd,
               "ssd_scan_bwd": kssd.ssd_scan_bwd}
    out = {"devices": [str(d) for d in mesh.devices]}
    for cell, fn in (("a", lambda: _agreement(torch, cs, mesh, smi)),
                     ("b", lambda: _full_qwen(torch, cs, mesh, smi,
                                              counted)),
                     ("bd", lambda: _decode(torch, cs, mesh, smi,
                                            counted)),
                     ("c", lambda: _deepseek(torch, cs, mesh, smi)),
                     ("f", lambda: _long_ring(torch, cs, mesh, smi,
                                              counted)),
                     ("d", lambda: _mamba2(torch, cs, mesh, smi, counted)),
                     ("e", lambda: _zamba2(torch, cs, mesh, smi,
                                           counted)),
                     ("g", lambda: _long_sweep(torch, cs, mesh, smi,
                                               counted))):
        if cell in cells:
            t0 = time.perf_counter()
            out[cell] = fn()
            out[f"{cell}_wall_s"] = time.perf_counter() - t0
            import torch.distributed as dist
            if dist.get_rank() == 0:
                print(f"[world] cell ({cell}) wall "
                      f"{out[f'{cell}_wall_s']:.1f} s", flush=True)
    return out


def _ssm_launches_bad(tag, arch, rows) -> list:
    """(d) and (e): each row's B3, B3′ and B5 launches on card 0 against
    its arch and shape, times the row's steps (the first and
    ``repeats``): B3 once a Mamba-2 layer a train or prefill step (twice
    in train under remat, which runs the forward again), B3′ once a layer
    a train step, B5 once a shared attention block a decode step under
    pallas."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    bad = []
    for label, r in rows.items():
        layers = r["reduced"].get("n_layers", (0, cfg.n_layers))[1]
        attn = layers // cfg.hybrid_every if cfg.hybrid_every else 0
        steps, mode, rt = r["repeats"] + 1, r["mode"], r["runtime"]
        fwd = (0 if mode == "decode"
               else 2 if mode == "train" and rt["remat"] == "True" else 1)
        pallas = rt["attn_impl"] == "pallas"
        want = {"ssd_scan_fwd": layers * fwd * steps,
                "ssd_scan_bwd": layers * (mode == "train") * steps,
                "flash_decode": attn * (mode == "decode" and pallas) * steps}
        got = {k: r["launches_run"].get(k) for k in want}
        if got != want:
            bad.append(f"({tag}) {label} launches {got}, expected {want}")
    return bad


def _world_ok(report: dict) -> list:
    """The four-card world's failures, by cell."""
    bad = []
    for v, r in report.get("a", {}).items():
        if not r["ok"]:
            bad.append(f"(a) {v}")
    for v, r in report.get("b", {}).get("train", {}).items():
        if not r.get("first_loss_ok"):
            bad.append(f"(b) train {v}")
    if "bd" in report and not report["bd"]["launches_ok"]:
        bad.append("(b) decode launches")
    c = report.get("c", {})
    if c and not c["cut"].get("first_loss_ok"):
        bad.append(f"(c) {C_CUT}-layer cut")
    d = report.get("d", {})
    bad += [f"(d) {v}" for v, r in d.get("agree", {}).items()
            if not r["ok"]]
    if d and not d["decode_agree"]["ok"]:
        bad.append("(d) decode logits")
    bad += _ssm_launches_bad("d", D_ARCH, d.get("rows", {}))
    e = report.get("e", {})
    if e and not e["cut"].get("first_loss_ok"):
        bad.append(f"(e) {E_CUT}-layer cut")
    bad += _ssm_launches_bad("e", E_ARCH, e.get("rows", {}))
    f = report.get("f", {})
    if f and not f["agree"]["ok"]:
        bad.append("(f) logits")
    if f and not f["rows"]["long_500k pallas"]["launches_ok"]:
        bad.append("(f) launches")
    bad += [f"(g) {a} launches" for a, r in report.get("g", {}).items()
            if not r["launches_ok"]]
    return bad


def run_world(torch, cells) -> tuple:
    """The four-card world from this process: the kernels built first
    (each rank loads them), then four processes; ``(report, failures)``."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build
    from repro_torch.testing.distributed import World
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(build.load, ("flash_attention", "flash_decode",
                                   "ssd_scan")))
    print(f"[world] kernels built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        world = World(four_card_world, (tuple(cells),), world=4,
                      init_file=f"{tmp}/rendezvous", timeout=WORLD_TIMEOUT,
                      backend="nccl")
        report = world.result()
    return report, _world_ok(report)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default="batch,world",
                    help="batch (the batch mesh) and/or world (the "
                         "four-card world)")
    ap.add_argument("--world", default="a,b,bd,c,f,d,e",
                    help="the world's cells: a, b (train), bd (b's "
                         "decode), c, d, e, f and/or g (not by default)")
    args = ap.parse_args(argv)
    parts = args.parts.split(",")
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch import api
    from repro_torch.api import lowering
    from repro_torch.core.latency import DeviceProfile
    from repro_torch.data.pipeline import ClassificationData
    from repro_torch.fed import engine
    from repro_torch.kernels import build
    from repro_torch.kernels import sbc as ksbc
    from repro_torch.launch.mesh import Mesh, make_batch_mesh
    from repro_torch.tree import tree_leaves

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("FAIL: this needs two or more CUDA devices", file=sys.stderr)
        return 1
    if "world" in parts and torch.cuda.device_count() < 4:
        print("FAIL: the four-card world needs four CUDA devices",
              file=sys.stderr)
        return 1
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    for i, line in enumerate(cards):
        print(f"[cards] {i}: {line.strip()}", flush=True)
    summary = {"cards": cards}
    if "world" in parts:         # first: this process holds no card yet
        t0 = time.perf_counter()
        try:
            summary["world"], bad = run_world(torch, args.world.split(","))
        except (RuntimeError, TimeoutError) as exc:
            print(f"FAIL: the four-card world: {exc}", file=sys.stderr)
            return 1
        print(f"[world] wall {time.perf_counter() - t0:.1f} s", flush=True)
        if bad:
            print(json.dumps(summary, default=str))
            print(f"FAIL: the four-card world: {bad}", file=sys.stderr)
            return 1
    if "batch" not in parts:
        print(json.dumps(summary, default=str))
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    t0 = time.perf_counter()
    build.load("sbc")
    print(f"[build] sbc.cu in {time.perf_counter() - t0:.1f} s", flush=True)
    data, test = ClassificationData.synthetic(
        n=12_000, dim=3072, seed=0, spread=6.0).split(1200)
    specs = [api.ScenarioSpec(fleet=cs.fleet(DeviceProfile, cs.DEVICES),
                              name="K12", partition=p, policy="proposed",
                              b_max=128, base_lr=0.05,
                              seeds=tuple(range(8)))
             for p in ("iid", "noniid")]
    env = cs.Env(torch, np, api.Experiment, api.ScenarioSpec,
                 api.SerialExecutor, DeviceProfile, lowering, data, test,
                 engine, tree_leaves)
    mesh = make_batch_mesh()
    if api.MeshExecutor()._resolve_mesh("cuda") != mesh:
        print("FAIL: MeshExecutor() did not build the mesh of every card",
              file=sys.stderr)
        return 1
    meshes = {"cards": mesh,
              "entries": Mesh((mesh.devices[0],) * mesh.size)}
    runs, kept = {}, {}
    for name, m in meshes.items():
        t0 = time.perf_counter()
        kept[name] = {}
        try:
            runs[name] = cs.batch_mesh_cell(
                env, specs, api,
                {"sbc_stats": ksbc.sbc_stats, "sbc_apply": ksbc.sbc_apply},
                smi, m, strict=False, keep=kept[name])
        except AssertionError as exc:
            print(f"FAIL: {name}: {exc}", file=sys.stderr)
            return 1
        print(f"[mesh] {cs.describe_mesh(m)} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    same = {label: _same(kept["cards"][label], kept["entries"][label])
            for label in kept["cards"]}
    alone = rows_alone(env, api, DeviceProfile, cs,
                       kept["cards"]["ragged 3 rows, MeshExecutor"], smi)
    for label, ok in same.items():
        print(f"[mesh] {label}: {cs.describe_mesh(meshes['cards'])} "
              f"bitwise {cs.describe_mesh(meshes['entries'])}: "
              f"{'yes' if ok else 'NO'}", flush=True)
    print(json.dumps({**summary,
                      "meshes": {k: [str(d) for d in m.devices]
                                 for k, m in meshes.items()},
                      "runs": runs, "cards_bitwise_entries": same,
                      "rows_alone": alone}, default=str))
    if not all(same.values()):
        print("FAIL: distinct cards differ from entries of one card",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
