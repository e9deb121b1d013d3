#!/usr/bin/env python3
"""The batch mesh over distinct cards, on a machine with two or more
NVIDIA GPUs, in one process.

    python3 mesh_cards.py

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
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIELDS = ("losses", "accs", "times", "global_batch")


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


def main() -> int:
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    for i, line in enumerate(cards):
        print(f"[cards] {i}: {line.strip()}", flush=True)
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
    print(json.dumps({"cards": cards,
                      "meshes": {k: [str(d) for d in m.devices]
                                 for k, m in meshes.items()},
                      "runs": runs, "cards_bitwise_entries": same,
                      "rows_alone": alone}))
    if not all(same.values()):
        print("FAIL: distinct cards differ from entries of one card",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
