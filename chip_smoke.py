#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --profile    # also a torch.profiler breakdown

It drives the port's two paths through ``repro_torch.api.Experiment.run``
on the FEEL scheme with the Table-II fleet at K = 12 — the main path with
feel-mlp at full width (3072→256→256→10, 855 050 parameters, 16 rows)
and the transformer family at the spec's defaults (feel-transformer-
h256-d3: d_model 256, 4 query / 2 KV heads of 64, SwiGLU 512, 16-token
sequences, 1 836 800 parameters, 8 rows) — and holds every kernel of
those paths against its plain PyTorch version on the card:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
     (one nvcc per source, all started together);
  3. kernels against their plain versions at the paths' shapes, plus edge
     cases: the SBC pair (16 rows × 12 devices per leaf), ``compress_dense``
     on the card against the port's CPU path, and the flash-attention
     forward and backward (against the plain versions and autograd of the
     oracle; the backward bitwise reproducible);
  4. the main path, with launch counts read around it;
  4b. the transformer cell, with launch counts read around it and held
     against the formula stated in PERF.md;
  5. the card against the port's CPU path (three periods of one row),
     chunked == monolithic bitwise on the card, and a padded row against
     its solo twin; 5b. the same for the transformer;
  6. kernel times (CUDA events, cold L2) beside their bound, the plain
     versions' times and, for attention, one PyTorch call
     (``scaled_dot_product_attention``) as a yardstick.

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
from concurrent.futures import ThreadPoolExecutor
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
SOURCES = ("sbc", "flash_attention")


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
    card (forward 2e-5, bf16 forward 2e-2, backward 1e-4 against the plain
    backward and autograd of the oracle) and the backward run twice
    bitwise.  Returns the max abs errors of the f32 comparisons with the
    plain versions; raises AssertionError on a disagreement."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {"flash_attention_fwd": 0.0, "flash_attention_bwd_dq": 0.0,
            "flash_attention_bwd_dkdv": 0.0, "bf16_fwd": 0.0,
            "bwd_vs_autograd": 0.0}

    def close(key, got, want, tol, label):
        got, want = got.float(), want.float()
        if not torch.allclose(got, want, rtol=tol, atol=tol):
            raise AssertionError(
                f"{label}: {key} beyond {tol} (max abs err "
                f"{float((got - want).abs().max()):.3g})")
        errs[key] = max(errs[key], float((got - want).abs().max()))

    cases = [T_SHAPE + (True, None), (4, 128, 4, 2, 64, True, None),
             (4, 256, 4, 2, 128, True, 64), (4, 100, 4, 2, 64, True, 16),
             (4, 100, 4, 2, 128, False, None),
             (4, 256, 4, 1, 64, False, 16)]
    for b, s, hq, hkv, hd, causal, window in cases:
        label = (f"attention B={b} S={s} Hq={hq} Hkv={hkv} hd={hd} "
                 f"causal={causal} window={window}")
        opts = dict(causal=causal, window=window)
        q, k, v = attention_inputs(torch, gen, b, s, hq, hkv, hd)
        o, lse = kfa.flash_attention_fwd(q, k, v, **opts)
        po, plse = kfa.flash_attention_fwd_plain(q, k, v, **opts)
        close("flash_attention_fwd", o, po, 2e-5, label)
        close("flash_attention_fwd", lse, plse, 2e-5, label + " lse")
        qb, kb, vb = (t.bfloat16() for t in (q, k, v))
        close("bf16_fwd", kfa.flash_attention_fwd(qb, kb, vb, **opts)[0],
              kfa.flash_attention_fwd_plain(qb, kb, vb, **opts)[0], 2e-2,
              label + " bf16")
        do = torch.randn(q.shape, generator=gen, device="cuda")
        dq, dsum = kfa.flash_attention_bwd_dq(q, k, v, o, lse, do, **opts)
        dk, dv = kfa.flash_attention_bwd_dkdv(q, k, v, lse, do, dsum, **opts)
        pdq, pdk, pdv = kfa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                      **opts)
        close("flash_attention_bwd_dq", dq, pdq, 1e-4, label)
        close("flash_attention_bwd_dkdv", dk, pdk, 1e-4, label + " dk")
        close("flash_attention_bwd_dkdv", dv, pdv, 1e-4, label + " dv")
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        auto = torch.autograd.grad(
            attention_oracle(attention_ref, *leaves, causal, window),
            leaves, do)
        for got, want in zip((dq, dk, dv), auto):
            close("bwd_vs_autograd", got, want, 1e-4, label + " autograd")
        del q, k, v, o, lse, do, dq, dk, dv, auto, leaves
    q, k, v = (t.requires_grad_() for t in attention_inputs(
        torch, gen, *T_SHAPE[:5]))
    do = torch.randn(q.shape, generator=gen, device="cuda")
    runs = [torch.autograd.grad(kops.flash_attention(q, k, v), (q, k, v), do)
            for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("the attention backward is not bitwise "
                             "reproducible")
    return errs


def attention_times(torch, kfa, F):
    """Cold-L2 median times at the transformer cell's attention shape:
    each kernel, its plain version, and scaled_dot_product_attention
    (forward; forward + backward for the backward kernels) as a
    yardstick.  Bounds: bytes moved (each input read once, each output
    written once) over 3.35 TB/s vs the visible pairs' f32 operations
    over 67 TFLOP/s."""
    b, s, hq, hkv, hd = T_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = attention_inputs(torch, gen, b, s, hq, hkv, hd)
    do = torch.randn(q.shape, generator=gen, device="cuda")
    o, lse = kfa.flash_attention_fwd(q, k, v)
    _, dsum = kfa.flash_attention_bwd_dq(q, k, v, o, lse, do)
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                             enable_gqa=True)
        return torch.autograd.grad(out, leaves, dot)

    pairs = b * hq * s * (s + 1) // 2          # visible (query, key) pairs
    size = {"q": q.numel() * 4, "kv": k.numel() * 4, "stat": lse.numel() * 4}
    runs = {
        "flash_attention_fwd": (
            lambda: kfa.flash_attention_fwd(q, k, v),
            lambda: kfa.flash_attention_fwd_plain(q, k, v), sdpa,
            2 * size["q"] + 2 * size["kv"] + size["stat"],
            pairs * (4 * hd + 4)),
        "flash_attention_bwd_dq": (
            lambda: kfa.flash_attention_bwd_dq(q, k, v, o, lse, do),
            lambda: kfa.flash_attention_bwd_dq_plain(q, k, v, o, lse, do),
            sdpa_fwd_bwd, 4 * size["q"] + 2 * size["kv"] + 2 * size["stat"],
            pairs * (6 * hd + 4) + b * hq * s * 2 * hd),
        "flash_attention_bwd_dkdv": (
            lambda: kfa.flash_attention_bwd_dkdv(q, k, v, lse, do, dsum),
            lambda: kfa.flash_attention_bwd_dkdv_plain(q, k, v, lse, do,
                                                       dsum),
            sdpa_fwd_bwd, 2 * size["q"] + 4 * size["kv"] + 2 * size["stat"],
            pairs * (8 * hd + 4)),
    }
    out = {}
    for name, (kern, plain, lib, nbytes, ops) in runs.items():
        bound_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        bound_ops = 1e3 * ops / F32_OPS_PER_S
        out[name] = {"ms": cold_ms(torch, kern),
                     "plain_ms": cold_ms(torch, plain),
                     "library_ms": cold_ms(torch, lib),
                     "bound_ms": max(bound_bytes, bound_ops),
                     "bound_by": ("bytes" if bound_bytes >= bound_ops
                                  else "operations"),
                     "bytes": nbytes, "ops": ops}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace two periods with torch.profiler")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.nn.functional as F
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
        from repro_torch.kernels import build
        from repro_torch.kernels import flash_attention as kfa
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels import sbc as ksbc
        from repro_torch.kernels.ref import attention_ref
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
    with ThreadPoolExecutor(max_workers=2) as pool:      # one nvcc each
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
        f"(128, 256, 100), hd in (64, 128), windows (16, 64), non-causal: "
        f"fwd max abs err {attn_errs['flash_attention_fwd']:.3g} (tol 2e-5), "
        f"bf16 fwd {attn_errs['bf16_fwd']:.3g} (tol 2e-2), dq "
        f"{attn_errs['flash_attention_bwd_dq']:.3g}, dk/dv "
        f"{attn_errs['flash_attention_bwd_dkdv']:.3g} vs the plain backward, "
        f"{attn_errs['bwd_vs_autograd']:.3g} vs autograd of the oracle "
        f"(tol 1e-4); backward run twice bitwise equal")
    report["attention_errors"] = attn_errs

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

    # ---- 4b. the transformer cell at full width -----------------------------
    tspecs = [ScenarioSpec(fleet=fleet(DeviceProfile, DEVICES), name="K12",
                           partition=p, policy="proposed", b_max=128,
                           base_lr=0.05, seeds=tuple(range(T_ROWS // 2)),
                           model_family="transformer")
              for p in ("iid", "noniid")]
    counted = {"flash_attention_fwd": kfa.flash_attention_fwd,
               "flash_attention_bwd_dq": kfa.flash_attention_bwd_dq,
               "flash_attention_bwd_dkdv": kfa.flash_attention_bwd_dkdv,
               "sbc_stats": ksbc.sbc_stats, "sbc_apply": ksbc.sbc_apply}
    t0 = time.perf_counter()
    Experiment(data, test, tspecs).run(1)                # warm-up period
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tres = Experiment(data, test, tspecs).run(T_PERIODS)
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t0
    t_launches = {name: fn.launches for name, fn in counted.items()}
    t_peak = torch.cuda.max_memory_allocated() / 2**30
    want_t = {name: n * T_PERIODS for name, n in T_LAUNCHES.items()}
    log(f"[4b transformer] Experiment.run feel-transformer-h256-d3: "
        f"{tres.rows} rows x {T_PERIODS} periods in {t_wall:.3f} s = "
        f"{1e3 * t_wall / T_PERIODS:.1f} ms/period (warm-up run of 1 period "
        f"{t_warm:.2f} s); peak device memory {t_peak:.2f} GiB")
    log(f"[4b transformer] launches during the run: {t_launches} "
        f"(expected {want_t})")
    log(f"[4b transformer] mean accuracy period 1 "
        f"{tres.accs[:, 0].mean():.4f} -> period {T_PERIODS} "
        f"{tres.final_acc.mean():.4f} (chance 0.1); mean loss "
        f"{tres.losses[:, 0].mean():.4f} -> {tres.losses[:, -1].mean():.4f}")
    if t_launches != want_t:
        return fail(f"phase 4b: kernel launches {t_launches}, expected "
                    f"{want_t}")
    if not (np.isfinite(tres.losses).all() and np.isfinite(tres.accs).all()
            and np.isfinite(tres.times).all()):
        return fail("phase 4b: non-finite series")
    if tres.rows != T_ROWS or not (tres.losses[:, -1] != tres.losses[:, 0]
                                   ).all():
        return fail("phase 4b: a row's loss did not change over the run")
    if not tres.losses[:, -1].mean() < tres.losses[:, 0].mean():
        return fail("phase 4b: the mean loss did not fall over the run")
    tbucket = Experiment(data, test, tspecs).lower()[0]
    t0 = time.perf_counter()
    tplan = lowering.plan_bucket(tbucket, data, T_PERIODS)
    t_plan = time.perf_counter() - t0
    tarrays = lowering.DeviceData(data, test, "cuda")
    tarrays.tokens
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    thandle = lowering.dispatch_bucket(tplan, tarrays)
    t_enqueue = time.perf_counter() - t0
    lowering.collect_bucket(thandle)
    t_device = time.perf_counter() - t0
    log(f"[4b transformer] phases: host planning {t_plan:.3f} s "
        f"({1e3 * t_plan / T_PERIODS:.1f} ms/period); device loop "
        f"{t_device:.3f} s ({1e3 * t_device / T_PERIODS:.1f} ms/period, of "
        f"which {t_enqueue:.3f} s until the last period was enqueued)")
    report["transformer"] = {
        "rows": tres.rows, "periods": T_PERIODS, "wall_s": t_wall,
        "ms_per_period": 1e3 * t_wall / T_PERIODS, "plan_s": t_plan,
        "device_loop_s": t_device, "enqueue_s": t_enqueue,
        "peak_gib": t_peak, "final_acc": tres.final_acc.tolist(),
        "loss_first": tres.losses[:, 0].tolist(),
        "loss_last": tres.losses[:, -1].tolist(), "launches": t_launches}
    del tarrays, thandle

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

    # ---- 5b. the transformer: card vs CPU path, chunked == monolithic -------
    tone = [ScenarioSpec(fleet=fleet(DeviceProfile, DEVICES), name="K12",
                         partition="iid", seeds=(0,), b_max=16,
                         model_family="transformer")]
    t_card = Experiment(data, test, tone).run(3)
    t_cpu = Experiment(data, test, tone, device="cpu").run(3)
    tloss_err = float(np.abs(t_card.losses - t_cpu.losses).max())
    tacc_err = float(np.abs(t_card.accs - t_cpu.accs).max())
    log(f"[5b transformer card vs cpu] 3 periods, 1 row, slot 16: losses "
        f"{t_card.losses[0]} vs {t_cpu.losses[0]} (max abs err "
        f"{tloss_err:.3g}); accs max abs err {tacc_err:.3g}")
    if not (np.array_equal(t_card.times, t_cpu.times)
            and np.array_equal(t_card.global_batch, t_cpu.global_batch)
            and np.allclose(t_card.losses, t_cpu.losses, rtol=1e-4,
                            atol=1e-4)
            and tacc_err <= 2.0 / len(test.y) + 1e-7):
        return fail("phase 5b: card and CPU path disagree beyond ledgers "
                    "bitwise, losses 1e-4, accuracies two test predictions")
    tmono = Experiment(data, test, tspecs).run(3)
    tchunk = Experiment(data, test, tspecs).run(
        3, executor=SerialExecutor(chunk_periods=1))
    if not all(np.array_equal(getattr(tmono, f), getattr(tchunk, f))
               for f in fields):
        return fail("phase 5b: chunked transformer run differs from the "
                    "monolithic one")
    tmixed = [ScenarioSpec(fleet=fleet(DeviceProfile, k), name=f"K{k}",
                           partition="iid", seeds=(0,),
                           model_family="transformer") for k in (12, 9)]
    tboth = Experiment(data, test, tmixed).run(3)
    tsolo = Experiment(data, test, tmixed[1:]).run(3)
    tpad_err = float(np.abs(tboth.losses[1] - tsolo.losses[0]).max())
    same = np.array_equal(tboth.times[1], tsolo.times[0])
    log(f"[5b transformer card] chunked (1-period chunks) == monolithic "
        f"bitwise over {T_ROWS} rows x 3 periods; padded K=9 row vs its "
        f"solo twin: ledgers {'equal' if same else 'DIFFER'}, losses max "
        f"abs err {tpad_err:.3g}")
    if not (same
            and np.array_equal(tboth.global_batch[1], tsolo.global_batch[0])
            and np.allclose(tboth.losses[1], tsolo.losses[0], rtol=1e-4,
                            atol=1e-4)):
        return fail("phase 5b: padded transformer row and its solo twin "
                    "disagree beyond ledgers bitwise, losses 1e-4")
    report["transformer_contracts"] = {
        "card_vs_cpu_loss_max_abs_err": tloss_err,
        "card_vs_cpu_acc_max_abs_err": tacc_err,
        "chunked_equals_monolithic": True,
        "padded_vs_solo_loss_max_abs_err": tpad_err}

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
                                 "transformer": t_launches[name]},
            "max_abs_err": errs[name],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": None})
        log(f"[6 times] {name}: one period's six leaves: kernel "
            f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, bound "
            f"{records[-1]['bound_ms']:.4f} ms ({records[-1]['bound_by']}); "
            f"library_ms none (no single PyTorch call computes it)")
    for name, t in attention_times(torch, kfa, F).items():
        records.append({
            "name": name, "route": "cuda", "source": ATTN_SOURCE,
            "replaces": ("src/repro/kernels/flash_attention.py:24"
                         if name == "flash_attention_fwd"
                         else "none: backward of B4, C-ref-3"),
            "launches": t_launches[name],
            "launches_by_path": {"transformer": t_launches[name]},
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        log(f"[6 times] {name} at {T_SHAPE} (B, S, Hq, Hkv, hd), causal: "
            f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']} bytes, "
            f"{t['ops']} f32 ops); scaled_dot_product_attention "
            + ("forward" if name == "flash_attention_fwd"
               else "forward + backward")
            + f" {t['library_ms']:.4f} ms")

    if args.profile:
        # device time by kernel over the device loop of two periods of
        # each path
        from torch.profiler import ProfilerActivity, profile
        for path, pbucket, form in (("feel_mlp", bucket, "features"),
                                    ("transformer", tbucket, "tokens")):
            plan = lowering.plan_bucket(pbucket, data, 2)
            arrays = lowering.DeviceData(data, test, "cuda")
            getattr(arrays, form)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                lowering.collect_bucket(lowering.dispatch_bucket(plan,
                                                                 arrays))
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
