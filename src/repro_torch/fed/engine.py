"""Device trajectory engine for the feel-mlp model, in the three forms
of the reference's engine: the flat FEEL loop, the per-device-parameter
loop of the ``individual`` / ``model_fl`` schemes, and the hierarchical
cell→edge→cloud FEEL loop.

  * host side (numpy, done once up front): the scheduler plans the full
    horizon (``FeelScheduler.plan_horizon``), the batcher pre-samples every
    period's indices/masks, and the latency ledger is cumsum'd into a time
    axis — that is the :class:`Schedule`;
  * device side: a loop over periods runs gather → per-device grads → SBC
    compression with error-feedback residuals → eq. (1) aggregation → SGD
    update → test metrics, for a whole (rows, devices) batch at once and
    with no per-period host transfer.  Rows are the flattened (scenario ×
    seed) axis of a bucket; per-device gradients are one batched
    ``torch.func.vmap(torch.func.grad(...))`` over (rows, devices), taken
    at the row's global parameters (one local step) or at per-device
    parameters (τ > 1 local steps, the dev schemes and the hierarchy's
    per-edge replicas).

The loops are resumable: the carry is an explicit :class:`EngineState`
(params + SBC residuals; the dev loop's per-device parameter stack; the
hierarchy's per-edge replicas + residuals) that every ``run_*`` function
takes in and hands back, so a horizon may run as N chunks — each
consuming one slice of the schedule — bitwise equal to one monolithic run
(the period step is a pure function of carry and inputs with the same
shapes in both).

On CUDA the engine keeps float32 products in full float32: TF32 is turned
off for matmuls and for cuDNN (:func:`full_f32`).

**The dispatch ledger.**  Each loop runs as a *program*: one object per
static key, built by an ``lru_cache``'d constructor with the reference's
key tuples (``_trajectory_fn``'s ``(local_steps, compress, ratio,
batched)``, ``_dev_trajectory_fn``'s ``(average, batched)``,
``_hier_trajectory_fn``'s and ``model_engine``'s).  A program records one
:class:`TraceEvent` ``(kind, key, signature)`` the first time it is
called with an argument signature — the flattened ``(shape, dtype,
device)`` tuple of its tensors, row axis kept — and nothing when the
signature repeats.  An event is therefore not a compile: eager PyTorch
compiles nothing (the CUDA kernels are built once per source, apart from
this).  It marks the first dispatch of one program at one signature in
this process, the nearest thing to the reference's jit trace (which is
per device too), so "warm" means what it means there: this exact program
already ran these exact shapes on this device.
``testing.no_retrace`` and ``serve.ExperimentService`` read the ledger.  An
uncompressed program keys its ratio as ``None``, as ``bucket_key``
does: the ratio does not enter its loop.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch.compression.sbc import compress_dense
from repro_torch.fed import feel_model
from repro_torch.tree import tree_leaves, tree_map

# ---------------------------------------------------------------------------
# the dispatch ledger
# ---------------------------------------------------------------------------

_TRACES = {"n": 0, "events": [], "suspended": 0}


class TraceEvent(NamedTuple):
    """The first dispatch of a program at one argument signature.

    ``kind`` names the program family (``feel`` / ``dev`` / ``hier`` /
    ``model``); ``key`` is the static key its constructor is cached on;
    ``signature`` the flattened (shape, dtype, device) tuple of its
    arguments.  Two equal events would mean one program met one signature
    twice as if new (a retrace)."""
    kind: str
    key: tuple
    signature: tuple


def trace_count() -> int:
    """Events recorded so far in this process."""
    return _TRACES["n"]


def trace_events() -> tuple:
    """The ledger, one :class:`TraceEvent` per first dispatch."""
    return tuple(_TRACES["events"])


@contextlib.contextmanager
def suspend_trace_count():
    """Run programs without recording: a dispatch under this context
    neither records an event nor marks its signature as seen, so the
    next dispatch outside it records as the first."""
    _TRACES["suspended"] += 1
    try:
        yield
    finally:
        _TRACES["suspended"] -= 1


def _signature(args) -> tuple:
    return tuple((tuple(a.shape), str(a.dtype), str(a.device))
                 for a in tree_leaves(args) if a is not None)


def _record_trace(kind: str, key: tuple, signature: tuple) -> None:
    _TRACES["n"] += 1
    _TRACES["events"].append(TraceEvent(kind, key, signature))


class _Program:
    """One loop fixed by its static ``key``; records a :class:`TraceEvent`
    at the first call with each argument signature."""

    def __init__(self, kind: str, key: tuple, body):
        self.kind, self.key, self._body = kind, key, body
        self._seen = set()

    def __call__(self, *args):
        if not _TRACES["suspended"]:
            sig = _signature(args)
            if sig not in self._seen:
                self._seen.add(sig)
                _record_trace(self.kind, self.key, sig)
        return self._body(*args)


def _one_row(body, n_row_args: int):
    """A batched program body as a single-row one: the first
    ``n_row_args`` arguments gain a row axis of 1, the outputs lose it."""
    def run(*args):
        rows = tree_map(lambda a: a[None], args[:n_row_args])
        out = body(*rows, *args[n_row_args:])
        return tree_map(lambda a: a[0], out)
    return run


def ratio_key(compress: bool, ratio: float):
    """The ratio a program keys on: ``None`` when it does not compress."""
    return float(ratio) if compress else None


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
                   time_offset: float = 0.0,
                   local_steps: int = 1) -> Schedule:
    """Pre-generate one run's plans, sample indices and time axis.

    ``horizon`` short-circuits planning when the caller already planned
    it (``core.scheduler.plan_horizons_batch`` across a bucket).
    ``time_offset`` seeds the cumulative time axis of a chunk: the cumsum
    accumulates *from* the offset, the only form bitwise equal to the
    monolithic ledger (offset 0.0 is the plain cumsum).

    ``local_steps`` τ > 1 adds τ − 1 more local computations to every
    period (paper §VII): the straggler max over the scheduler's fleet of
    each user's slowed-down local latency, over the period's participants
    only when the horizon samples (a GPU's b = 0 floor latency is
    nonzero, so an unmasked max would charge absent users' idle
    floors)."""
    if horizon is None:
        horizon = scheduler.plan_horizon(periods)
    idx = np.empty((periods, batcher.k, batcher.slot), np.int32)
    w = np.empty((periods, batcher.k, batcher.slot), np.float32)
    for p in range(periods):
        idx[p], w[p] = batcher.sample(horizon.batch[p])
    per_period = horizon.latency.copy()
    if local_steps > 1:
        devices = scheduler.devices
        part = horizon.participation
        slow = horizon.slowdown
        if slow is None:
            slow = np.ones_like(np.asarray(horizon.batch, np.float64))
        if part is None:
            per_period += (local_steps - 1) * np.array(
                [max(float(sl) * float(d.local_grad_latency(b))
                     for d, b, sl in zip(devices, bp, sp))
                 for bp, sp in zip(horizon.batch, slow)])
        else:
            per_period += (local_steps - 1) * np.array(
                [max(float(sl) * float(d.local_grad_latency(b))
                     for d, b, m, sl in zip(devices, bp, mp, sp) if m > 0.5)
                 for bp, mp, sp in zip(horizon.batch, part, slow)])
    times = np.cumsum(np.concatenate([[time_offset], per_period]))[1:]
    return Schedule(idx=idx, weight=w,
                    batch=horizon.batch.astype(np.float32),
                    lr=horizon.lr.astype(np.float32),
                    times=times, global_batch=horizon.global_batch,
                    aggden=None if horizon.aggden is None
                    else horizon.aggden.astype(np.float32))


@dataclass
class EngineState:
    """Explicit loop carry, in and out of every trajectory function, on
    the device: ``params`` leaves (R, ...) — the dev loop's (R, K, ...)
    per-device stacks, the hierarchy's (R, E, ...) per-edge replicas —
    and SBC error-feedback ``residual`` leaves (R, K, ...), None in the
    dev loop (it does not compress)."""
    params: object
    residual: object = None


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


def _single_row_active(active, periods: int, k: int, device):
    """A single-row program's ``active`` mask as the (P, K) tensor it
    reads: ``None`` is all ones, a static (K,) mask broadcasts over
    periods, a (P, K) mask passes through."""
    if active is not None:
        active = np.broadcast_to(np.asarray(active, np.float32),
                                 (periods, k))[None]
    return normalize_active(active, 1, periods, k, device)[0]


# ---------------------------------------------------------------------------
# the period step (Steps 1-5 of the paper's §II-A loop) over (rows, devices)
# ---------------------------------------------------------------------------

# per row: the weighted loss and the test accuracy of one parameter set
_row_loss = vmap(feel_model.loss_fn)
_row_accuracy = vmap(feel_model.accuracy, in_dims=(0, None, None))
# per (row, device): the gradient of the device's weighted loss at the
# row's global parameters
_device_grads = vmap(vmap(grad(feel_model.loss_fn), in_dims=(None, 0, 0, 0)))
# per (row, device): the gradient at the device's OWN parameters, leaves
# (R, K, ...): τ > 1 local steps, the dev loop and the hierarchy.  Called
# with per-example weights (weighted loss) or without (plain mean).
_local_grads = vmap(vmap(grad(feel_model.loss_fn)))


def _per_row(v, like):
    """A per-row (R,) or (R, K) tensor shaped to broadcast over ``like``'s
    trailing axes."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def _local_sgd(params, x, y, w, lr, local_steps: int):
    """τ local SGD steps on every device from its own ``params`` (leaves
    (R, K, ...)), uploading the cumulative update as the "gradient":
    ``(p0 − pτ) / lr`` (paper §VII).  A user with all-zero weights has a
    zero gradient at every step, so its delta is exactly 0."""
    dev = params
    for _ in range(local_steps):
        g = _local_grads(dev, x, y, w)
        dev = tree_map(lambda p, gg: p - _per_row(lr, gg) * gg, dev, g)
    return tree_map(lambda p0, pk: (p0 - pk) / _per_row(lr, pk), params, dev)


def aggregation_weights(bk, aggden):
    """eq. (1)'s weights B_k / den over (R, K): den is the row's
    ``aggden`` where positive (weighted sampling's fixed denominator),
    else the realized Σ_k B_k (inactive and padded users carry B_k = 0),
    which is bitwise the plain eq. (1) step."""
    den = aggden[:, None]
    return bk / torch.where(den > 0, den, bk.sum(-1, keepdim=True))


def _period_step(arrays, active, compress: bool, ratio: float,
                 carry: EngineState, xs: dict, local_steps: int = 1):
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

    if local_steps == 1:
        grads = _device_grads(params, x, y, w)   # leaves (R, K, ...)
    else:
        k = x.shape[1]
        dev = tree_map(lambda a: a[:, None].expand((rows, k) + a.shape[1:]),
                       params)
        grads = _local_sgd(dev, x, y, w, lr, local_steps)
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


@lru_cache(maxsize=None)
def _trajectory_fn(local_steps: int, compress: bool, ratio, batched: bool):
    def run(params, residual, active, xs, *arrays):
        state, series = EngineState(params, residual), []
        for p in range(xs["batch"].shape[1]):
            state, out = _period_step(arrays, active[:, p], compress, ratio,
                                      state,
                                      {key: v[:, p] for key, v in xs.items()},
                                      local_steps)
            series.append(out)
        return (state.params, state.residual,
                tuple(torch.stack(s, dim=1) for s in zip(*series)))

    return _Program("feel", (local_steps, compress, ratio, batched),
                    run if batched else _one_row(run, 4))


@torch.no_grad()
def run_trajectory(state: EngineState, schedule: Schedule, arrays, *,
                   compress: bool = True, ratio: float = 0.005, active=None,
                   local_steps: int = 1):
    """One trajectory (the reference's single-row ``run_trajectory``):
    ``state`` holds unbatched params and (K, ...) residuals; ``active`` an
    optional (K,) or (P, K) {0,1} mask.  Returns ``(EngineState, (losses,
    accs, decays))``, each series (P,) on the device."""
    device = arrays[0].device
    full_f32(device)
    xs = {key: v[0] for key, v in stack_schedules([schedule],
                                                  device).items()}
    periods, k = xs["batch"].shape
    active = _single_row_active(active, periods, k, device)
    fn = _trajectory_fn(local_steps, compress, ratio_key(compress, ratio),
                        False)
    params, residual, series = fn(state.params, state.residual, active, xs,
                                  *arrays)
    return EngineState(params, residual), series


@torch.no_grad()
def run_trajectory_batch(state: EngineState, schedules: Sequence[Schedule],
                         arrays, *, compress: bool = True,
                         ratio: float = 0.005, active=None,
                         local_steps: int = 1):
    """Advance every row of a bucket through its schedule — the
    counterpart of the reference's ``run_trajectory_batch`` and
    ``resume_trajectory_batch`` in one (a fresh trajectory starts from
    init params and :func:`zero_residual`).

    ``state`` holds the row-batched params (R, ...) and residuals
    (R, K, ...); ``schedules`` is one :class:`Schedule` per row, padded to
    a common K (:func:`pad_schedule`); ``arrays`` is
    :func:`dataset_to_device`'s tuple; ``active`` an optional {0,1} user
    mask (default all-active), static (R, K) — padded users — or
    time-varying (R, P, K) — per-period participation; ``local_steps``
    τ > 1 runs τ local SGD steps a period on every device and uploads the
    parameter delta.

    Returns ``(EngineState, (losses, accs, decays))``, each series
    (R, P) on the device.  The work is enqueued and not waited for."""
    device = arrays[0].device
    full_f32(device)
    xs = stack_schedules(schedules, device)
    rows, periods, k = xs["batch"].shape
    active = normalize_active(active, rows, periods, k, device)
    fn = _trajectory_fn(local_steps, compress, ratio_key(compress, ratio),
                        True)
    params, residual, series = fn(state.params, state.residual, active, xs,
                                  *arrays)
    return EngineState(params, residual), series



# ---------------------------------------------------------------------------
# the per-device-parameter schemes (individual / model_fl)
# ---------------------------------------------------------------------------


def _masked_mean(a, active):
    """Mean over the device axis of ``a`` (R, K, ...) over the active users
    only: padded and sampled-out users never enter it (all-active, it is
    sum / K)."""
    m = _per_row(active, a)
    return (a * m).sum(1) / _per_row(active.sum(1), a[:, 0])


# per row: the plain test loss of one parameter set
_row_test_loss = vmap(feel_model.loss_fn, in_dims=(0, None, None))


def _dev_step(arrays, average: bool, lr, dev_params, idx, active):
    """One SGD step of every device on its own parameters at the period's
    minibatch (the ledger prices a local epoch), then FedAvg
    (``average``: every copy replaced by the masked mean), and the test
    loss and accuracy of the masked device mean.  The update is
    masked, so a sampled-out user's parameters hold still (all-active,
    ``g * 1.0 == g``)."""
    data_x, data_y, test_x, test_y = arrays
    x = data_x[idx]                              # (R, K, batch, D)
    y = data_y[idx]
    g = _local_grads(dev_params, x, y)
    dev_params = tree_map(
        lambda p, gg: p - _per_row(lr, gg) * (gg * _per_row(active, gg)),
        dev_params, g)
    if average:
        dev_params = tree_map(
            lambda a: _masked_mean(a, active)[:, None].expand(a.shape),
            dev_params)
    avg = tree_map(lambda a: _masked_mean(a, active), dev_params)
    loss = _row_test_loss(avg, test_x, test_y)
    acc = _row_accuracy(avg, test_x, test_y)
    return dev_params, (loss, acc)


@lru_cache(maxsize=None)
def _dev_trajectory_fn(average: bool, batched: bool):
    def run(dev_params, idx, lr, active, *arrays):
        series = []
        for p in range(idx.shape[1]):
            dev_params, out = _dev_step(arrays, average, lr, dev_params,
                                        idx[:, p], active[:, p])
            series.append(out)
        return dev_params, tuple(torch.stack(s, dim=1) for s in zip(*series))

    return _Program("dev", (average, batched),
                    run if batched else _one_row(run, 4))


@torch.no_grad()
def run_dev_trajectory(state: EngineState, idx, lr: float, arrays, *,
                       average: bool, active=None):
    """One dev-scheme trajectory (the reference's single-row
    ``run_dev_trajectory``): ``state.params`` leaves (K, ...), ``idx``
    (P, K, batch), ``active`` an optional (K,) or (P, K) mask.  Returns
    ``(EngineState, (losses, accs))``, each series (P,) on the device."""
    device = arrays[0].device
    full_f32(device)
    idx = host_to_device(np.asarray(idx), device)
    periods, k = idx.shape[:2]
    active = _single_row_active(active, periods, k, device)
    lr = host_to_device(np.float32(lr), device)
    fn = _dev_trajectory_fn(bool(average), False)
    dev_params, series = fn(state.params, idx, lr, active, *arrays)
    return EngineState(dev_params), series


@torch.no_grad()
def run_dev_trajectory_batch(state: EngineState, idx, lr, arrays, *,
                             average: bool, active=None):
    """Advance every row of a dev-family bucket through its index block —
    the reference's ``run_dev_trajectory_batch`` and
    ``resume_dev_trajectory_batch`` in one.

    ``state.params`` leaves are the per-device stacks (R, K, ...) (a fresh
    run broadcasts each row's init over K); ``idx`` is (R, P, K, batch),
    ``lr`` (R,); ``active`` as in :func:`run_trajectory_batch`.
    ``average`` is ``model_fl``'s FedAvg step.  Returns
    ``(EngineState, (losses, accs))``, each series (R, P) on the device;
    chunked calls are bitwise one monolithic call."""
    device = arrays[0].device
    full_f32(device)
    idx = host_to_device(np.asarray(idx), device)
    lr = host_to_device(np.asarray(lr, np.float32), device)
    rows, periods, k = idx.shape[:3]
    active = normalize_active(active, rows, periods, k, device)
    fn = _dev_trajectory_fn(bool(average), True)
    dev_params, series = fn(state.params, idx, lr, active, *arrays)
    return EngineState(dev_params), series


# ---------------------------------------------------------------------------
# hierarchical FEEL (cell → edge server → cloud, topology.Topology)
# ---------------------------------------------------------------------------
#
# The flat loop keeps one global model a row; the hierarchical loop keeps
# one replica per edge server (leaves (R, E, ...)) and the (R, E, K)
# one-hot ``member`` routes users to replicas.  Every period each edge
# aggregates its own users' (compressed) gradients eq.-(1)-style into its
# replica; on cloud rounds the replicas merge into the batch-weighted
# global average, which is also the model every reported metric
# evaluates.  Padded users are all-zero ``member`` columns and active-mask
# zeros, so they enter neither the routing nor the weights.


def _hier_period_step(arrays, member, active, cloud, compress: bool,
                      ratio: float, local_steps: int, carry: EngineState,
                      xs: dict):
    data_x, data_y, test_x, test_y = arrays
    params_e, residual = carry.params, carry.residual
    w = xs["weight"] * active[..., None]
    bk = xs["batch"] * active
    lr = xs["lr"]
    # s_e: per-edge batch mass; wk: per-edge eq. (1) weights (an edge
    # without participants gets zero weights and a guard denominator, so
    # its replica holds still); beta: each edge's batch share, the
    # cloud-merge and evaluation weights
    s_e = torch.einsum("rek,rk->re", member, bk)
    wk = member * bk[:, None, :] / torch.where(
        s_e > 0, s_e, torch.ones_like(s_e))[..., None]
    beta = s_e / s_e.sum(-1, keepdim=True)

    def cloud_view(tree):
        return tree_map(lambda a: torch.einsum("re,re...->r...", beta, a),
                        tree)

    # each user trains from its edge's replica (one-hot gather)
    user_params = tree_map(
        lambda a: torch.einsum("rek,re...->rk...", member, a), params_e)
    idx = xs["idx"]
    x = data_x[idx]                              # (R, K, slot, D)
    y = data_y[idx]
    rows = x.shape[0]
    xf = x.reshape(rows, -1, x.shape[-1])
    yf = y.reshape(rows, -1)
    wf = w.reshape(rows, -1)
    loss_before = _row_loss(cloud_view(params_e), xf, yf, wf)

    if local_steps == 1:
        grads = _local_grads(user_params, x, y, w)
    else:
        grads = _local_sgd(user_params, x, y, w, lr, local_steps)
    if compress:
        grads, residual = compress_dense(grads, ratio, residual,
                                         batch_dims=2)
    # per-edge eq. (1) aggregation and SGD step on each replica
    agg = tree_map(lambda g: torch.einsum("rek,rk...->re...", wk, g), grads)
    params_e = tree_map(lambda p, g: p - _per_row(lr, p) * g, params_e, agg)
    # cloud round: replicas → batch-weighted global average, broadcast back
    merge = cloud > 0.5                                  # (R,)
    params_e = tree_map(
        lambda a: torch.where(
            _per_row(merge, a),
            torch.einsum("re,re...->r...", beta, a)[:, None].expand(a.shape),
            a), params_e)
    global_after = cloud_view(params_e)
    loss_after = _row_loss(global_after, xf, yf, wf)
    acc = _row_accuracy(global_after, test_x, test_y)
    return (EngineState(params_e, residual),
            (loss_after, acc, loss_before - loss_after))


@lru_cache(maxsize=None)
def _hier_trajectory_fn(local_steps: int, compress: bool, ratio,
                        n_edges: int, batched: bool):
    def run(params, residual, member, active, cloud, xs, *arrays):
        state, series = EngineState(params, residual), []
        for p in range(xs["batch"].shape[1]):
            state, out = _hier_period_step(
                arrays, member, active[:, p], cloud[:, p], compress, ratio,
                local_steps, state, {key: v[:, p] for key, v in xs.items()})
            series.append(out)
        return (state.params, state.residual,
                tuple(torch.stack(s, dim=1) for s in zip(*series)))

    return _Program("hier", (local_steps, compress, ratio, n_edges, batched),
                    run)


@torch.no_grad()
def run_hier_trajectory_batch(state: EngineState, member, cloud,
                              schedules: Sequence[Schedule], arrays, *,
                              compress: bool = True, ratio: float = 0.005,
                              active=None, local_steps: int = 1):
    """Advance every row of a hierarchical bucket through its schedule —
    the reference's ``run_hier_trajectory_batch`` and
    ``resume_hier_trajectory_batch`` in one.

    ``state.params`` leaves are (R, E, ...), one replica per edge server
    (a fresh run broadcasts each row's init over E), ``state.residual``
    (R, K, ...); ``member`` is (R, E, K) user→edge one-hot (padded users:
    all-zero columns); ``cloud`` (R, P) {0,1} cloud-round flags
    (``Topology.cloud_rounds``, counted in global periods); the rest as
    in :func:`run_trajectory_batch`.  Returns ``(EngineState, (losses,
    accs, decays))``."""
    device = arrays[0].device
    full_f32(device)
    xs = stack_schedules(schedules, device)
    rows, periods, k = xs["batch"].shape
    active = normalize_active(active, rows, periods, k, device)
    member = host_to_device(np.asarray(member, np.float32), device)
    cloud = host_to_device(np.asarray(cloud, np.float32), device)
    fn = _hier_trajectory_fn(local_steps, compress,
                             ratio_key(compress, ratio),
                             int(member.shape[1]), True)
    params, residual, series = fn(state.params, state.residual, member,
                                  active, cloud, xs, *arrays)
    return EngineState(params, residual), series
