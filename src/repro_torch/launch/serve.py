"""Batched LLM token-decode driver: prefill a prompt batch, then decode
with the KV/SSM cache (port of the reference's ``launch/serve.py``).

Despite the filename this is *token decoding* for the model zoo, not the
FEEL experiment service.  It builds ``--arch`` (``configs.get_arch``;
``--full`` for the published widths, else the reduced smoke variant),
draws random weights and a random prompt from ``--seed``, prefills by
stepping the decode path over the prompt (as the reference does), then
decodes ``--gen`` tokens greedily, and returns the decode rate in
tokens/s.  An audio model's prompt and tokens carry one id a codebook,
(B, 1, n_cb) a step.

    python -m repro_torch.launch.serve --arch mistral-nemo-12b --full \\
        --batch 8 --prompt-len 128 --gen 64 --ctx 2048
    python -m repro_torch.launch.serve --device cpu     # reduced, CPU

It runs on the GPU unless ``--device cpu`` is given, and raises when CUDA
is not available.  The model runs in float32 with TF32 off; attention
goes through the flash-decode kernel (``Runtime(attn_impl="pallas")``;
its plain version on the CPU).  The loop never waits for the card:
positions, cache slots and the greedy tokens stay on the device until
the end.  It raises if the last logits are not finite.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.api.experiment import resolve_device
from repro_torch.configs import get_arch
from repro_torch.fed.engine import full_f32
from repro_torch.fed.train_step import make_serve_step
from repro_torch.models.model import Runtime, init, init_cache


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-2.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--ctx", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' for the "
                         "port's CPU path)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    full_f32(device)
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    rt = Runtime(dtype=torch.float32, attn_impl="pallas")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init(cfg, gen)
    shape = (args.batch, args.prompt_len) + (
        (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ())
    prompt = torch.randint(0, cfg.vocab, shape, generator=gen,
                           device=device)

    serve = make_serve_step(cfg, rt)
    cache = init_cache(cfg, args.batch, args.ctx, rt, device=device)

    _sync(device)
    t0 = time.perf_counter()
    logits = None
    for t in range(args.prompt_len):
        logits, cache = serve(params, cache, prompt[:, t:t + 1])
    _sync(device)
    t_prefill = time.perf_counter() - t0

    toks = []
    t0 = time.perf_counter()
    for _ in range(args.gen):
        # (B, 1), or (B, 1, n_cb): one greedy token a codebook
        nxt = torch.argmax(logits[..., :cfg.vocab], dim=-1)
        logits, cache = serve(params, cache, nxt)
        toks.append(nxt)
    _sync(device)
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(logits[..., :cfg.vocab]).all()):
        raise FloatingPointError(f"{cfg.name}: non-finite logits after "
                                 f"{args.prompt_len + args.gen} steps")
    tps = args.gen * args.batch / dt
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU")
    print(f"[serve] {cfg.name}: batch={args.batch} prefill={t_prefill:.2f}s "
          f"decode {args.gen} toks/seq at {tps:.1f} tok/s ({where})")
    out = torch.cat(toks, dim=1).cpu().numpy()
    print(f"[serve] sample continuation (seq 0): {out[0].reshape(-1)[:16]}")
    return tps


if __name__ == "__main__":
    main()
