"""Big-model FEEL engine: the transformer and mamba2 families' per-device
train steps (port of the reference's ``fed/model_engine.py``).

A spec with ``model_family="transformer"`` or ``"mamba2"`` lowers here.
Each period runs, for a whole (rows, devices) batch: per-device
gradients of the weighted-CE loss (``fed.train_step``), per-device SBC
uploads with error feedback (``compress_dense``, the SBC kernels on
CUDA), the eq. (1) ``B_k``-weighted aggregation and the ``optim.sgd``
step, then the loss after the step and the test accuracy.

**Per-device gradients.**  The reference takes ``vmap(grad)`` over
devices.  A kernel launched through ``ctypes`` is opaque to
``torch.func.vmap``, so the port gives every (row, device) its own copy
of the row's parameters (leaves ``(R·K, …)``), runs one batched forward
over all copies — the dense products as batched GEMMs, attention and
the SSD scan as one flat batch through their kernels (the scan with a
per-copy decay ``A``) — and takes one backward of the sum of the
per-device losses, each with its own denominator.  Each copy's gradient
is then exactly its device's gradient.  Nothing here depends on the
family: any forward that takes a copy axis trains this way.

The runtime pins ``attn_impl="pallas"``: attention runs the flash
kernels (``kernels/csrc/flash_attention.cu``) on CUDA and their plain
versions on the CPU, forward and backward.  The mamba2 family always
runs the SSD kernels (``kernels/csrc/ssd_scan.cu``) the same way.

The classification workload rides along unchanged: features are
quantized to token sequences (:func:`tokenize`), the class label is the
final next-token target, and test accuracy reads the last position's
argmax over the class-id slice of the vocab.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from repro_torch.compression.sbc import compress_dense
from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.fed.engine import (EngineState, _Program,
                                    aggregation_weights, full_f32,
                                    host_to_device, normalize_active,
                                    ratio_key, stack_schedules)
from repro_torch.fed.train_step import TrainState, make_loss_fn
from repro_torch.models.model import Runtime, forward
from repro_torch.models.model import init as model_init
from repro_torch.optim import apply_updates, sgd
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

# tokenization constants: VOCAB feature bins (class ids live in the first
# N_CLASSES slots of the same vocab), sequences capped at SEQ_CAP tokens
SEQ_CAP = 16
VOCAB = 32
N_CLASSES = 10

# the kernel-dispatch runtime: attention through the flash kernels
KERNEL_RT = Runtime(attn_impl="pallas")


@lru_cache(maxsize=None)
def family_arch(model_family: str, hidden: int, depth: int) -> ArchConfig:
    """The family's architecture from the spec's (hidden, depth): the
    transformer uses 4 query heads over ``hidden`` (2 KV heads) and a
    SwiGLU of width ``2·hidden``; the SSM uses 8-wide state heads over
    ``2·hidden`` inner channels (N 16, one group, chunk 4)."""
    if model_family == "transformer":
        return ArchConfig(
            name=f"feel-transformer-h{hidden}-d{depth}", family="dense",
            n_layers=depth, d_model=hidden, n_heads=4, n_kv_heads=2,
            d_ff=2 * hidden, vocab=VOCAB)
    if model_family == "mamba2":
        return ArchConfig(
            name=f"feel-mamba2-h{hidden}-d{depth}", family="ssm",
            n_layers=depth, d_model=hidden, n_heads=0, n_kv_heads=0,
            d_ff=0, vocab=VOCAB, attn_kind="none",
            ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=8,
                          n_groups=1, chunk=4))
    raise ValueError(f"unknown big-model family {model_family!r}")


@lru_cache(maxsize=None)
def family_n_params(model_family: str, hidden: int, depth: int) -> int:
    """True parameter count (prices the planner's uplink payload)."""
    return family_arch(model_family, hidden, depth).param_count()


def tokenize(data, seq_cap: int = SEQ_CAP, vocab: int = VOCAB):
    """Deterministic host-side feature quantization → (tokens, labels).

    Each example's first ``min(seq_cap, D)`` features (rounded down to a
    multiple of 4) are squashed with tanh and binned into ``vocab`` ids
    by a fixed affine map, in float64 (the reference's arithmetic, so the
    tokens are bitwise its tokens).  Labels are the next-token sequence
    with the class id as the final target."""
    x = np.asarray(data.x, np.float64)
    y = np.asarray(data.y)
    S = max(4, (min(seq_cap, x.shape[1]) // 4) * 4)
    if x.shape[1] < S:  # tiny feature dims: tile columns up to one chunk
        x = np.tile(x, (1, -(-S // x.shape[1])))
    bins = np.floor((np.tanh(x[:, :S] / 4.0) + 1.0) * 0.5 * vocab)
    tokens = np.clip(bins, 0, vocab - 1).astype(np.int64)
    labels = np.concatenate([tokens[:, 1:], y[:, None]], axis=1)
    return tokens, labels.astype(np.int64)


def tokens_to_device(data, test, device):
    """``(tokens, labels, test_tokens, test_y)`` on ``device`` (int32)."""
    tok, lab = tokenize(data)
    test_tok, _ = tokenize(test)
    return host_to_device((tok, lab, test_tok, np.asarray(test.y)), device)


def init_params_batch(model_family: str, hidden: int, depth: int,
                      seeds: Sequence[int], device):
    """Row-batched initial params: each row draws ``models.model.init``
    from a CPU generator seeded with its seed, so a row's weights do not
    depend on the device or on its bucket neighbours."""
    cfg = family_arch(model_family, hidden, depth)
    per_row = [model_init(cfg, torch.Generator().manual_seed(int(s)))
               for s in seeds]
    return tree_map(lambda *leaves: torch.stack(leaves).to(device),
                    *per_row)


# ---------------------------------------------------------------------------
# the period step (Steps 1-5 on the big-model train step)
# ---------------------------------------------------------------------------


def _device_grads(loss_fn, params, batch, k: int):
    """Per-device gradients of the rows' params: leaves (R, K, ...)."""
    copies = tree_map(lambda p: p.repeat_interleave(k, dim=0)
                      .requires_grad_(), params)
    leaves = tree_leaves(copies)
    with torch.enable_grad():
        losses = loss_fn(copies, batch)
        grads = torch.autograd.grad(losses.sum(), leaves)
    return tree_unflatten(params, [g.reshape((-1, k) + g.shape[1:])
                                   for g in grads])


def _model_period_step(cfg, rt, loss_fn, opt, compress: bool, ratio: float,
                       arrays, active, state: TrainState, xs: dict):
    tok, lab, test_tok, test_y = arrays
    # the schedule already zeroes inactive users; multiplying keeps that
    # invariant for hand-built schedules and is bitwise free otherwise
    w = xs["weight"] * active[..., None]
    bk = xs["batch"] * active
    lr = xs["lr"]
    t = tok[xs["idx"]]                             # (R, K, slot, S)
    l_ = lab[xs["idx"]]
    wt = w[..., None].expand(l_.shape)
    rows, k = t.shape[:2]
    joint = {"tokens": t.reshape(rows, -1, t.shape[-1]),
             "labels": l_.reshape(rows, -1, t.shape[-1]),
             "weights": wt.reshape(rows, -1, t.shape[-1])}
    loss_before = loss_fn(state.params, joint)

    per_device = {key: v.reshape((rows * k,) + v.shape[2:])
                  for key, v in (("tokens", t), ("labels", l_),
                                 ("weights", wt))}
    grads = _device_grads(loss_fn, state.params, per_device, k)
    residual = state.residual
    if compress:
        # per-device SBC with per-device error feedback: every stacked
        # leaf of every device is one upload (inactive users' too)
        grads, residual = compress_dense(grads, ratio, residual,
                                         batch_dims=2)
    # eq. (1), over aggden where positive as in the feel-mlp step
    wk = aggregation_weights(bk, xs["aggden"])
    agg = tree_map(lambda g: torch.einsum("rk,rk...->r...", wk, g), grads)
    updates, opt_state = opt.update(agg, state.opt, state.params, lr)
    params = apply_updates(state.params, updates)
    state = TrainState(params, opt_state, state.step + 1, residual)

    loss_after = loss_fn(params, joint)
    logits = forward(cfg, params,
                     test_tok.expand((rows,) + test_tok.shape), rt=rt)
    acc = (logits[:, :, -1, :N_CLASSES].argmax(-1) == test_y).to(
        torch.float32).mean(-1)
    return state, (loss_after, acc, loss_before - loss_after)


@lru_cache(maxsize=None)
def _model_trajectory_fn(model_family: str, hidden: int, depth: int,
                         compress: bool, ratio, batched: bool):
    cfg = family_arch(model_family, hidden, depth)
    loss_fn = make_loss_fn(cfg, KERNEL_RT)
    opt = sgd()

    def run(params, residual, active, xs, *arrays):
        train = TrainState(params, opt.init(params), 0, residual)
        series = []
        for p in range(xs["batch"].shape[1]):
            train, out = _model_period_step(
                cfg, KERNEL_RT, loss_fn, opt, compress, ratio, arrays,
                active[:, p], train, {key: v[:, p] for key, v in xs.items()})
            series.append(out)
        return (train.params, train.residual,
                tuple(torch.stack(s, dim=1) for s in zip(*series)))

    return _Program("model", (model_family, hidden, depth, compress, ratio,
                              batched), run)


@torch.no_grad()
def run_model_trajectory_batch(state: EngineState, schedules: Sequence,
                               arrays, *, model_family: str, hidden: int,
                               depth: int, compress: bool = True,
                               ratio: float = 0.005, active=None):
    """Advance every row of a big-model bucket through its schedule — the
    reference's ``run_model_trajectory_batch`` and
    ``resume_model_trajectory_batch`` in one (a fresh trajectory starts
    from :func:`init_params_batch` and ``engine.zero_residual``).

    Same contract as ``engine.run_trajectory_batch``, except ``arrays``
    is :func:`tokens_to_device`'s tuple.  Returns ``(EngineState,
    (losses, accs, decays))``, each series (R, P) on the device; the work
    is enqueued and not waited for."""
    device = arrays[0].device
    full_f32(device)
    xs = stack_schedules(schedules, device)
    rows, periods, k = xs["batch"].shape
    active = normalize_active(active, rows, periods, k, device)
    fn = _model_trajectory_fn(model_family, int(hidden), int(depth),
                              bool(compress), ratio_key(compress, ratio),
                              True)
    params, residual, series = fn(state.params, state.residual, active, xs,
                                  *arrays)
    return EngineState(params, residual), series
