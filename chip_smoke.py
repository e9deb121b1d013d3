#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --profile    # also a torch.profiler breakdown

It drives the port's main path — ``repro_torch.api.Experiment.run`` on the
FEEL scheme with feel-mlp at full width (3072→256→256→10, 855 050
parameters), the Table-II fleet at K = 12, 16 rows — and holds every
kernel of that path against its plain PyTorch version on the card:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. kernels against their plain versions at the main path's shapes
     (16 rows × 12 devices per leaf), plus edge cases; ``compress_dense``
     on the card against the port's CPU path from the same inputs;
  4. the main path, with launch counts read around it;
  5. the card against the port's CPU path (three periods of one row),
     chunked == monolithic bitwise on the card, and a padded row against
     its solo twin;
  6. kernel times (CUDA events, cold L2) beside their bandwidth bound and
     the plain versions' times.

Every phase that fails makes the script exit non-zero.  The last three
lines of standard output are the card's ``name, power.limit``, one JSON
object with the kernels' records, and ``{"ok": true, "device": ...}``.
It needs one CUDA device; without one (or outside a checkout) it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# non-tensor-core float32 rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# the main path's SBC segments: one per (row, device) upload of each leaf
LEAF_LENGTHS = (786_432, 256, 65_536, 256, 2_560, 10)
ROWS, DEVICES, RATIO = 16, 12, 0.005
PERIODS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace two periods with torch.profiler")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this smoke run "
                    "needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.api import Experiment, ScenarioSpec, SerialExecutor
        from repro_torch.compression import sbc as csbc
        from repro_torch.core.latency import DeviceProfile
        from repro_torch.data.pipeline import ClassificationData
        from repro_torch.api import lowering
        from repro_torch.fed import engine
        from repro_torch.kernels import build
        from repro_torch.kernels import sbc as ksbc
    except ImportError as exc:
        return fail(f"the port is not importable from {ROOT}: {exc}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}

    # ---- 1. device --------------------------------------------------------
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1 device] {kind}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = build.load("sbc")
    log(f"[2 build] sbc.cu built and loaded in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {lib.build_seconds:.2f} s)")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[2 build]   {line.strip()}")

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
    arrays = engine.dataset_to_device(data, test, "cuda")
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
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": None})
        log(f"[6 times] {name}: one period's six leaves: kernel "
            f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, bound "
            f"{records[-1]['bound_ms']:.4f} ms ({records[-1]['bound_by']}); "
            f"library_ms none (no single PyTorch call computes it)")

    if args.profile:
        # device time by kernel over the device loop of two periods
        from torch.profiler import ProfilerActivity, profile
        plan = lowering.plan_bucket(bucket, data, 2)
        arrays = engine.dataset_to_device(data, test, "cuda")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            lowering.collect_bucket(lowering.dispatch_bucket(plan, arrays))
            window = time.perf_counter() - t0
        events = prof.key_averages()
        busy = sum(e.self_device_time_total for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation) / 1e3
        log(f"[profile] device loop of 2 periods: wall {1e3 * window:.1f} "
            f"ms, device busy {busy:.1f} ms "
            f"({100 * busy / (1e3 * window):.1f}%)")
        table = events.table(sort_by="self_device_time_total", row_limit=30)
        log(table)
        report["profile"] = {"window_ms": 1e3 * window, "busy_ms": busy,
                             "table": table}

    report["kernels"] = records
    report["device"] = {"kind": kind, "smi": smi}
    try:
        OUT_DIR.mkdir(exist_ok=True)
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
