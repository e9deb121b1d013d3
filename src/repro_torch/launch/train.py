"""End-to-end FEEL training driver for the transformer zoo (port of the
reference's ``launch/train.py``).

Maps the paper's K edge devices onto the groups of one global batch:
each step the FEEL scheduler plans (B_k, lr) from simulated channels;
B_k becomes the per-group example mask of the batch, and eq. (1)'s
aggregation is the weighted mean inside the train step
(``fed.train_step.make_train_step``), a momentum-SGD step with the
optional SBC uplink (``--compress-uplink``).  ``--ckpt`` writes the
final state in the reference's checkpoint format.

    python -m repro_torch.launch.train --device cpu          # reduced, CPU
    python -m repro_torch.launch.train --arch qwen1.5-4b --full

It runs on the GPU unless ``--device cpu`` is given, and raises when CUDA
is not available.  The model runs in float32 with TF32 off and naive
attention (``Runtime(attn_impl="naive")``, as the reference's driver);
under ``--compress-uplink`` each leaf goes through the SBC kernel pair
(``kernels.sbc``) once a step.  Parameters, momentum and the residual
are updated in place, so a full-width qwen1.5-4b step fits on one 80 GB
card.  It prints the reference's lines and returns the last loss.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.api.experiment import resolve_device
from repro_torch.configs import get_arch
from repro_torch.core import DeviceProfile, FeelScheduler
from repro_torch.data.pipeline import TokenData
from repro_torch.fed.engine import full_f32
from repro_torch.fed.train_step import TrainState, make_train_step
from repro_torch.models.model import Runtime, init
from repro_torch.optim import momentum
from repro_torch.tree import tree_leaves


def device_fleet(k: int):
    """Heterogeneous CPU fleet like the paper: 0.7/1.4/2.1 GHz tiers."""
    tiers = [0.7e9, 1.4e9, 2.1e9]
    return [DeviceProfile(kind="cpu", f_cpu=tiers[i % 3]) for i in range(k)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--devices", type=int, default=4, help="FEEL K")
    ap.add_argument("--slot", type=int, default=8,
                    help="max examples per device per period (B^max)")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--policy", default="proposed",
                    choices=["proposed", "online", "full", "random"])
    ap.add_argument("--compress-uplink", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="use the full (non-reduced) architecture")
    ap.add_argument("--layers", type=int, default=0,
                    help="override layer count (scaled custom variant)")
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (heads scale with width/64)")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' for the "
                         "port's CPU path)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    full_f32(device)
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    if args.layers or args.d_model:
        d = args.d_model or cfg.d_model
        heads = max(4, d // 64) if cfg.n_heads else 0
        cfg = dataclasses.replace(
            cfg, name=f"{cfg.name}-custom",
            n_layers=args.layers or cfg.n_layers, d_model=d,
            n_heads=heads, n_kv_heads=min(cfg.n_kv_heads, heads) or heads,
            head_dim=64 if heads else 0,
            d_ff=4 * d if cfg.d_ff else 0)
    rt = Runtime(dtype=torch.float32, attn_impl="naive")
    params = init(cfg, torch.Generator(device=device).manual_seed(args.seed))
    opt = momentum(0.9)
    state = TrainState(params, opt.init(params), 0)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"[train] {cfg.name}: {n_params/1e6:.2f}M params, "
          f"K={args.devices} devices, policy={args.policy}")

    devs = device_fleet(args.devices)
    sched = FeelScheduler(devices=devs, n_params=n_params,
                          policy=args.policy, b_max=args.slot,
                          base_lr=args.lr, ref_batch=args.devices * args.slot,
                          seed=args.seed)
    data = TokenData.synthetic(n=4096, seq=args.seq,
                               vocab=min(cfg.vocab, 512), seed=args.seed)
    rng = np.random.default_rng(args.seed)

    step_fn = make_train_step(cfg, rt, opt,
                              compress_uplink=args.compress_uplink)
    sim_time, t0 = 0.0, time.time()
    prev_loss = None
    for step in range(args.steps):
        plan = sched.plan()
        # per-group masks -> per-example weights over the (K*slot) batch
        w = np.zeros((args.devices, args.slot), np.float32)
        for g in range(args.devices):
            w[g, :min(plan.batch[g], args.slot)] = 1.0
        idx = rng.integers(0, len(data.tokens),
                           size=args.devices * args.slot)
        toks = data.tokens[idx]
        if cfg.n_codebooks > 1:     # the same ids in every codebook
            t_in = np.repeat(toks[:, :-1, None], cfg.n_codebooks, axis=2)
            t_lab = np.repeat(toks[:, 1:, None], cfg.n_codebooks, axis=2)
        else:
            t_in, t_lab = toks[:, :-1], toks[:, 1:]
        batch = {
            "tokens": torch.from_numpy(t_in).to(device),
            "labels": torch.from_numpy(t_lab % cfg.vocab).to(device),
            "weights": torch.from_numpy(w.reshape(-1)).to(device)[:, None]
            .expand(args.devices * args.slot, args.seq).contiguous(),
        }
        state, metrics = step_fn(state, batch, plan.lr)
        loss = float(metrics["loss"])
        sim_time += plan.predicted_latency
        if prev_loss is not None:
            sched.observe(prev_loss - loss, plan.global_batch)
        prev_loss = loss
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            print(f"  step {step:4d} loss={loss:.4f} B={plan.global_batch:4d}"
                  f" lr={plan.lr:.4f} simT={sim_time:8.2f}s"
                  f" wall={time.time()-t0:6.1f}s", flush=True)
    if args.ckpt:
        checkpoint.save_state(args.ckpt, int(state.step), state.params,
                              state.opt)
        print(f"[train] checkpoint -> {args.ckpt}")
    print(f"[train] done: final loss {prev_loss:.4f}, "
          f"simulated wall-clock {sim_time:.1f}s")
    return prev_loss


if __name__ == "__main__":
    main()
