"""Device trajectory engine for the FEEL family.

  * host side (numpy, done once up front): the scheduler plans the full
    horizon (``FeelScheduler.plan_horizon``), the batcher pre-samples every
    period's indices/masks, and the latency ledger is cumsum'd into a time
    axis — that is the :class:`Schedule`;
  * device side: a loop over periods runs gather → per-device grads → SBC
    compression with error-feedback residuals → eq. (1) aggregation → SGD
    update → test metrics, for a whole (rows, devices) batch at once and
    with no per-period host transfer.  Rows are the flattened (scenario ×
    seed) axis of a bucket; per-device gradients are one batched
    ``torch.func.vmap(torch.func.grad(...))`` over (rows, devices).

The loop is resumable: the carry is an explicit :class:`EngineState`
(params + SBC residuals) that every ``run_*`` function takes in and hands
back, so a horizon may run as N chunks — each consuming one slice of the
schedule — bitwise equal to one monolithic run (the period step is a pure
function of carry and inputs with the same shapes in both).

On CUDA the engine keeps float32 products in full float32: TF32 is turned
off for matmuls and for cuDNN (:func:`full_f32`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch.compression.sbc import compress_dense
from repro_torch.fed import feel_model
from repro_torch.tree import tree_map

# ---------------------------------------------------------------------------
# host -> device dtype boundary
# ---------------------------------------------------------------------------
#
# Host planners work in numpy float64 (the latency ledgers are cumulative
# sums where 32-bit drift would change simulated-time results); device
# programs are strictly 32-bit.  ``host_to_device`` is the one crossing:
# floats → float32, ints → int32.  ``times``/``global_batch`` never cross.

_DEVICE_DTYPES = {"f": torch.float32, "i": torch.int32, "u": torch.int32,
                  "b": torch.bool}


def host_to_device(tree, device):
    """Cast numpy arrays (alone, or in a tuple/list/dict) to 32-bit tensors
    on ``device``."""
    if isinstance(tree, dict):
        return {k: host_to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(host_to_device(v, device) for v in tree)
    a = np.asarray(tree)
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=_DEVICE_DTYPES[a.dtype.kind])


def full_f32(device) -> None:
    """Keep float32 products in full float32 on CUDA (TF32 off)."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def dataset_to_device(data, test, device):
    """The four dataset arrays ``(x, y, test_x, test_y)`` on ``device``."""
    return host_to_device((data.x, data.y, test.x, test.y), device)


@dataclass(frozen=True)
class Schedule:
    """Everything host-generated that one trajectory consumes."""
    idx: np.ndarray           # (P, K, slot) int32 — per-device sample indices
    weight: np.ndarray        # (P, K, slot) f32 — eq. (1) masks realizing B_k
    batch: np.ndarray         # (P, K) f32 — B_k (aggregation weights)
    lr: np.ndarray            # (P,) f32 — η per period
    times: np.ndarray         # (P,) f64 — cumulative simulated seconds
    global_batch: np.ndarray  # (P,) int
    # (P,) f32 fixed aggregation denominator, or None.  Weighted
    # (Horvitz-Thompson) sampling divides each cohort's eq. (1) sum by
    # p·Σ_all b̄_k instead of the realized Σ_cohort b_k; zero entries (the
    # None default) fall back to the realized sum inside the step.
    aggden: Optional[np.ndarray] = None

    @property
    def periods(self) -> int:
        return self.idx.shape[0]


def slice_schedule(schedule: Schedule, lo: int, hi: int) -> Schedule:
    """The ``[lo, hi)`` period window of a schedule (chunked execution).
    ``times`` keeps its absolute cumulative values."""
    return Schedule(idx=schedule.idx[lo:hi], weight=schedule.weight[lo:hi],
                    batch=schedule.batch[lo:hi], lr=schedule.lr[lo:hi],
                    times=schedule.times[lo:hi],
                    global_batch=schedule.global_batch[lo:hi],
                    aggden=None if schedule.aggden is None
                    else schedule.aggden[lo:hi])


def pad_schedule(schedule: Schedule, k: int) -> Schedule:
    """Zero-pad a schedule's user axis to ``k`` (the ragged-fleet bucket
    contract): padded users get index 0, weight 0 and batch 0, so they
    contribute nothing to any weighted loss, gradient or aggregation."""
    kk = schedule.idx.shape[1]
    if kk == k:
        return schedule
    pad3 = ((0, 0), (0, k - kk), (0, 0))
    return Schedule(idx=np.pad(schedule.idx, pad3),
                    weight=np.pad(schedule.weight, pad3),
                    batch=np.pad(schedule.batch, ((0, 0), (0, k - kk))),
                    lr=schedule.lr, times=schedule.times,
                    global_batch=schedule.global_batch,
                    aggden=schedule.aggden)


def build_schedule(scheduler, batcher, periods: int, horizon=None,
                   time_offset: float = 0.0) -> Schedule:
    """Pre-generate one run's plans, sample indices and time axis.

    ``horizon`` short-circuits planning when the caller already planned
    it (``core.scheduler.plan_horizons_batch`` across a bucket).
    ``time_offset`` seeds the cumulative time axis of a chunk: the cumsum
    accumulates *from* the offset, the only form bitwise equal to the
    monolithic ledger (offset 0.0 is the plain cumsum)."""
    if horizon is None:
        horizon = scheduler.plan_horizon(periods)
    idx = np.empty((periods, batcher.k, batcher.slot), np.int32)
    w = np.empty((periods, batcher.k, batcher.slot), np.float32)
    for p in range(periods):
        idx[p], w[p] = batcher.sample(horizon.batch[p])
    times = np.cumsum(np.concatenate([[time_offset], horizon.latency]))[1:]
    return Schedule(idx=idx, weight=w,
                    batch=horizon.batch.astype(np.float32),
                    lr=horizon.lr.astype(np.float32),
                    times=times, global_batch=horizon.global_batch,
                    aggden=None if horizon.aggden is None
                    else horizon.aggden.astype(np.float32))


@dataclass
class EngineState:
    """Explicit loop carry, in and out of every trajectory function:
    ``params`` leaves (R, ...) and SBC error-feedback ``residual`` leaves
    (R, K, ...), on the device."""
    params: object
    residual: object


def zero_residual(params, k: int):
    """Fresh SBC error-feedback state for row-batched params: one residual
    per (row, device) per leaf."""
    return tree_map(lambda p: torch.zeros((p.shape[0], k) + p.shape[1:],
                                          dtype=p.dtype, device=p.device),
                    params)


def _aggden_of(schedule: Schedule) -> np.ndarray:
    """A schedule's ``aggden``, zeros when unset, so it always crosses."""
    if schedule.aggden is None:
        return np.zeros(schedule.periods, np.float32)
    return schedule.aggden


def stack_schedules(schedules: Sequence[Schedule], device):
    """Stack per-row schedules along a leading row axis, on ``device``:
    ``idx``/``weight`` (R, P, K, slot), ``batch`` (R, P, K), ``lr`` and
    ``aggden`` (R, P).  ``aggden`` always crosses (zeros when unset), so
    weighted and unweighted rows share one bucket."""
    xs = {key: np.stack([getattr(s, key) for s in schedules])
          for key in ("idx", "weight", "batch", "lr")}
    xs["aggden"] = np.stack([_aggden_of(s) for s in schedules])
    return host_to_device(xs, device)


def normalize_active(active, rows: int, periods: int, k: int, device):
    """A batched ``active`` mask as the (R, P, K) float32 tensor the loop
    reads: ``None`` is all ones; a static (R, K) mask (ragged-fleet
    padding) broadcasts over periods; a time-varying (R, P, K) mask
    (participation, dropout, energy drops) passes through."""
    if active is None:
        return torch.ones((rows, periods, k), dtype=torch.float32,
                          device=device)
    active = host_to_device(np.asarray(active, np.float32), device)
    if active.dim() == 2:
        active = active[:, None, :].expand(rows, periods, k)
    return active


# ---------------------------------------------------------------------------
# the period step (Steps 1-5 of the paper's §II-A loop) over (rows, devices)
# ---------------------------------------------------------------------------

# per row: the weighted loss and the test accuracy of one parameter set
_row_loss = vmap(feel_model.loss_fn)
_row_accuracy = vmap(feel_model.accuracy, in_dims=(0, None, None))
# per (row, device): the gradient of the device's weighted loss at the
# row's global parameters
_device_grads = vmap(vmap(grad(feel_model.loss_fn), in_dims=(None, 0, 0, 0)))


def aggregation_weights(bk, aggden):
    """eq. (1)'s weights B_k / den over (R, K): den is the row's
    ``aggden`` where positive (weighted sampling's fixed denominator),
    else the realized Σ_k B_k (inactive and padded users carry B_k = 0),
    which is bitwise the plain eq. (1) step."""
    den = aggden[:, None]
    return bk / torch.where(den > 0, den, bk.sum(-1, keepdim=True))


def _period_step(arrays, active, compress: bool, ratio: float,
                 carry: EngineState, xs: dict):
    data_x, data_y, test_x, test_y = arrays
    params, residual = carry.params, carry.residual
    # active: the period's (R, K) {0,1} user mask; the schedule already
    # carries zero weights/batch for inactive users, and multiplying keeps
    # that invariant for hand-built schedules too (x * 1.0 == x bitwise)
    w = xs["weight"] * active[..., None]
    bk = xs["batch"] * active
    lr = xs["lr"]
    idx = xs["idx"]
    x = data_x[idx]                              # (R, K, slot, D)
    y = data_y[idx]
    rows = x.shape[0]
    xf = x.reshape(rows, -1, x.shape[-1])
    yf = y.reshape(rows, -1)
    wf = w.reshape(rows, -1)
    loss_before = _row_loss(params, xf, yf, wf)

    grads = _device_grads(params, x, y, w)       # leaves (R, K, ...)
    if compress:
        # per-device SBC: every device sparsifies its OWN upload, so a
        # padded (all-zero-gradient) user compresses to exact zeros.  An
        # inactive user still compresses and updates its residual, as in
        # the reference: only its aggregation weight is zero.
        grads, residual = compress_dense(grads, ratio, residual,
                                         batch_dims=2)
    wk = aggregation_weights(bk, xs["aggden"])
    agg = tree_map(lambda g: torch.einsum("rk,rk...->r...", wk, g), grads)
    params = tree_map(
        lambda p, g: p - lr.reshape((-1,) + (1,) * (p.dim() - 1)) * g,
        params, agg)

    loss_after = _row_loss(params, xf, yf, wf)
    acc = _row_accuracy(params, test_x, test_y)
    return (EngineState(params, residual),
            (loss_after, acc, loss_before - loss_after))


@torch.no_grad()
def run_trajectory_batch(state: EngineState, schedules: Sequence[Schedule],
                         arrays, *, compress: bool = True,
                         ratio: float = 0.005, active=None):
    """Advance every row of a bucket through its schedule — the
    counterpart of the reference's ``run_trajectory_batch`` and
    ``resume_trajectory_batch`` in one (a fresh trajectory starts from
    init params and :func:`zero_residual`).

    ``state`` holds the row-batched params (R, ...) and residuals
    (R, K, ...); ``schedules`` is one :class:`Schedule` per row, padded to
    a common K (:func:`pad_schedule`); ``arrays`` is
    :func:`dataset_to_device`'s tuple; ``active`` an optional {0,1} user
    mask (default all-active), static (R, K) — padded users — or
    time-varying (R, P, K) — per-period participation.

    Returns ``(EngineState, (losses, accs, decays))``, each series
    (R, P) on the device.  The work is enqueued and not waited for."""
    device = arrays[0].device
    full_f32(device)
    xs = stack_schedules(schedules, device)
    rows, periods, k = xs["batch"].shape
    active = normalize_active(active, rows, periods, k, device)
    series = []
    for p in range(periods):
        state, out = _period_step(arrays, active[:, p], compress, ratio,
                                  state,
                                  {key: v[:, p] for key, v in xs.items()})
        series.append(out)
    losses, accs, decays = (torch.stack(s, dim=1) for s in zip(*series))
    return state, (losses, accs, decays)

