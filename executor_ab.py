#!/usr/bin/env python3
"""Time the experiment executors against each other on one NVIDIA GPU, in
one process.

    python3 executor_ab.py

Two cells at ``chip_smoke``'s full width: the phase-4e grid (the main
cell's feel-mlp, data and K = 12 fleet over 4 policies x 2 SBC ratios x
2 partitions x 2 seeds: 32 rows in two buckets of 16, 20 periods;
host-launch-bound) and the transformer cell of phase 4b (8 rows x 10
periods; card-bound).  Each runs, after a 1-period warm-up, under these
schedules in turns (the list, then the list reversed), monolithic and in
chunks:

* ``serial``: ``SerialExecutor``;
* ``async``: ``AsyncExecutor``, which plans and dispatches every chunk of
  a bucket back to back on the caller's thread and collects afterwards;
* ``thread``: the same schedule with the plans made on one worker
  thread, one step ahead, so the worker plans step j+1 (the next chunk,
  or the next bucket's first) while the caller dispatches step j.

Every run must equal the serial one bitwise (losses, accuracies, times,
global batch).  Printed per run: the wall per period and the executor's
timings (host planning, enqueue, collect, and for ``thread`` the
caller's wait for plans); the last line is one JSON object with all of
them and the card's name and power limit.
"""
from __future__ import annotations

import json
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def variants(api):
    """name -> a factory of the executor under test, given chunk_periods."""

    class ThreadedPlanning(api.AsyncExecutor):
        """``AsyncExecutor``'s schedule, planned one step ahead on a
        worker thread while the caller dispatches."""

        def execute(self, buckets, data, arrays, periods):
            self._resolve_mesh(arrays.device)
            self.timings = {"plan_wait": 0.0}
            runs = [self._run(b, data, arrays, periods) for b in buckets]
            steps = [run for run in runs for _ in range(run.n_chunks)]
            cap = self.max_in_flight or len(runs)
            pending = deque()
            with ThreadPoolExecutor(max_workers=1) as pool:
                ahead = pool.submit(steps[0].plan_next)
                for j, run in enumerate(steps):
                    t0 = time.perf_counter()
                    plan = ahead.result()
                    self.timings["plan_wait"] += time.perf_counter() - t0
                    if j + 1 < len(steps):
                        ahead = pool.submit(steps[j + 1].plan_next)
                    if run.dispatched == 0:
                        if len(pending) >= cap:
                            yield self._finish(pending.popleft())
                        pending.append(run)
                    run.dispatch(plan)
                while pending:
                    yield self._finish(pending.popleft())

    return {"serial": lambda c: api.SerialExecutor(chunk_periods=c),
            "async": lambda c: api.AsyncExecutor(chunk_periods=c),
            "thread": lambda c: ThreadedPlanning(chunk_periods=c)}


def run_cell(torch, np, exp, periods, chunk, makers, label):
    """All variants in turns (forward, then reversed) at one chunk size;
    returns per-variant lists of records.  Raises AssertionError when a
    run differs from the first serial one."""
    order = list(makers) + list(reversed(makers))
    out = {name: [] for name in makers}
    ref = None
    for name in order:
        executor = makers[name](chunk)
        t0 = time.perf_counter()
        res = exp.run(periods, executor=executor)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if ref is None:
            ref = res
        elif not all(np.array_equal(getattr(res, f), getattr(ref, f))
                     for f in ("losses", "accs", "times", "global_batch")):
            raise AssertionError(f"{label} {name} chunk {chunk} differs "
                                 "from serial")
        tm = dict(executor.timings)
        rec = {"ms_per_period": 1e3 * wall / periods, "timings_s": tm}
        out[name].append(rec)
        print(f"[{label}] chunk_periods={chunk} {name}: "
              f"{rec['ms_per_period']:.1f} ms/period; plan {tm['plan']:.3f}"
              f" s, plan_wait {tm.get('plan_wait', float('nan')):.3f} s, "
              f"enqueue {tm['dispatch']:.3f} s, collect {tm['collect']:.3f}"
              f" s", flush=True)
    return out


def main(argv=None) -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch import api
    from repro_torch.core.latency import DeviceProfile
    from repro_torch.data.pipeline import ClassificationData
    from repro_torch.kernels import build

    smi = cs.nvidia_smi_line()
    print(f"[device] {smi}", flush=True)
    with ThreadPoolExecutor(2) as pool:                 # one nvcc each
        list(pool.map(build.load, ("sbc", "flash_attention")))
    data, test = ClassificationData.synthetic(
        n=12_000, dim=3072, seed=0, spread=6.0).split(1200)
    fleet = cs.fleet(DeviceProfile, cs.DEVICES)
    grid_study = api.grid(
        api.ScenarioSpec(fleet=fleet, name="K12", b_max=128, base_lr=0.05,
                         seeds=(0, 1)),
        policy=list(cs.G_POLICIES), compression=list(cs.G_RATIOS),
        partition=["iid", "noniid"])
    t_specs = [api.ScenarioSpec(fleet=fleet, name="K12", partition=p,
                                b_max=128, base_lr=0.05,
                                seeds=tuple(range(cs.T_ROWS // 2)),
                                model_family="transformer")
               for p in ("iid", "noniid")]
    makers = variants(api)
    report = {"device": smi}
    for label, specs, periods, chunks in (
            ("grid", grid_study, cs.PERIODS, (None, 5)),
            ("transformer", t_specs, cs.T_PERIODS, (None, 2))):
        exp = api.Experiment(data, test, specs)
        exp.run(1)                                       # warm-up period
        torch.cuda.synchronize()
        for chunk in chunks:
            try:
                report[f"{label} chunk {chunk}"] = run_cell(
                    torch, np, exp, periods, chunk, makers, label)
            except AssertionError as exc:
                print(f"FAIL: {exc}", file=sys.stderr)
                return 1
    print(smi)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
