"""Experiment runtimes: how buckets are scheduled on the device.

The lowering (``api.lowering``) splits every bucket into three phases —
host-side *plan*, asynchronous device *dispatch*, blocking *collect* —
and an :class:`Executor` is a composition policy over them.  Every bucket
runs through a :class:`~repro_torch.api.lowering.BucketRun`: one chunk of
the whole horizon, or ``chunk_periods``-period chunks carrying the engine
state between them (bitwise equal to the monolithic run).  All executors
are bitwise equal in results; they differ only in wall time.

* :class:`SerialExecutor` — plan → dispatch → collect one chunk at a
  time, one bucket at a time.  The reference schedule and the default.
* :class:`AsyncExecutor` — the reference's pipelined schedule on the
  caller's thread: every chunk of a bucket is planned and dispatched back
  to back, and results are collected only when the ``max_in_flight``
  window is full or at the end.  In eager PyTorch the dispatch is a
  Python loop that enqueues every launch, so planning never runs while
  the caller enqueues; what the schedule hides is the card's queued tail,
  which runs on while the host plans the next chunk instead of waiting in
  a per-chunk collect.
* :class:`MeshExecutor` — the serial schedule over a ``launch.mesh``
  batch mesh, built over every device of the experiment's device type
  when none is given.

A mesh (``mesh=`` on any executor) is a ``"batch"`` mesh.  Of one
device, it must be the experiment's own, and the bucket runs there
unchanged; of several, each must be of the experiment's device type (its
entries may repeat one device), and every bucket's rows are padded
cyclically to a multiple of the mesh, cut into one contiguous shard a
device and dispatched shard after shard, each against a copy of the data
sets on its device; the collect gathers them in shard order and slices
back (``api.lowering.dispatch_bucket``).  Host ledgers are the plain
run's bitwise; device series agree to float tolerance, since a shard's
batched products run at another row count.  A mesh on another device
(type) raises ``ValueError`` — an executor does not move an experiment
behind the caller's back.

A bucket whose specs set ``replan=`` (or run under
``Experiment.run(replan=)``) is closed-loop: it chunks at the replan
interval whatever ``chunk_periods`` says, and must collect chunk *c*,
whose realized decays are copied to the host for the ξ estimators,
before it plans chunk *c+1*.  Under :class:`AsyncExecutor` such a bucket
cannot run ahead; only the buckets after it can.

Executors yield ``(bucket, (losses, accs, times, global_batch))`` in
bucket order, which is what lets ``Experiment.stream`` hand back
incrementally collected ``Results``.  After a run, ``executor.timings``
holds its seconds: ``plan`` (host planning), ``dispatch`` (enqueue) and
``collect`` (waiting for the device).  What the pipeline hides shows as
the wall against :class:`SerialExecutor`'s at the same chunking.
"""
from __future__ import annotations

from collections import deque
from typing import Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.api.lowering import Bucket, BucketRun
from repro_torch.launch.mesh import (canonical_device, ensure_batch_mesh,
                                     make_batch_mesh)

BucketSeries = Tuple[Bucket, tuple]


def _check_mesh(mesh, device):
    """A validated batch mesh for an experiment on ``device``: one device,
    the experiment's own, or several of its device type."""
    mesh = ensure_batch_mesh(mesh)
    if mesh.abstract:
        raise ValueError("an abstract mesh holds no devices to run on")
    if mesh.size == 1:
        if canonical_device(mesh.devices[0]) != canonical_device(device):
            raise ValueError(
                f"the mesh's device {mesh.devices[0]} is not the "
                f"experiment's device {device}; build the Experiment on "
                "the mesh's device")
        return mesh
    kind = torch.device(device).type
    other = [d for d in mesh.devices if torch.device(d).type != kind]
    if other:
        raise ValueError(
            f"the mesh's devices {other} are not of the experiment's "
            f"device type {kind!r}; build the Experiment on that type")
    return mesh


class Executor:
    """Composition policy over the plan/dispatch/collect bucket phases."""

    def __init__(self, mesh=None, chunk_periods: Optional[int] = None):
        if chunk_periods is not None and chunk_periods < 1:
            raise ValueError(
                f"chunk_periods must be >= 1, got {chunk_periods}")
        self.mesh = mesh
        self.chunk_periods = chunk_periods
        self.timings = {}
        self._mesh = None

    def _resolve_mesh(self, device):
        return None if self.mesh is None else _check_mesh(self.mesh, device)

    def _start(self, device) -> None:
        """Validate the mesh and zero the timings before a run."""
        self._mesh = self._resolve_mesh(device)
        self.timings = {}

    def _chunk_for(self, bucket: Bucket) -> Optional[int]:
        """The bucket's chunk size, or ``None`` for one monolithic chunk.
        A closed-loop bucket chunks at its replan interval (the feedback
        boundary is semantic, not a tuning knob); otherwise the
        executor's ``chunk_periods`` applies."""
        if bucket.replan is not None:
            return bucket.replan
        return self.chunk_periods

    def _run(self, bucket: Bucket, data, arrays, periods: int) -> BucketRun:
        chunk = self._chunk_for(bucket)
        return BucketRun(bucket, data, periods,
                         periods if chunk is None else chunk, arrays,
                         mesh=self._mesh)

    def _bank(self, run: BucketRun) -> None:
        for key, sec in run.seconds.items():
            self.timings[key] = self.timings.get(key, 0.0) + sec

    def execute(self, buckets: Sequence[Bucket], data, arrays,
                periods: int) -> Iterator[BucketSeries]:
        """Yield ``(bucket, (losses, accs, times, global_batch))`` per
        bucket, in bucket order.  ``data`` is the host training set (for
        planning), ``arrays`` the experiment's
        :class:`~repro_torch.api.lowering.DeviceData`."""
        raise NotImplementedError


class SerialExecutor(Executor):
    """One bucket at a time, plan → dispatch → collect per chunk."""

    def execute(self, buckets, data, arrays, periods):
        self._start(arrays.device)
        for bucket in buckets:
            run = self._run(bucket, data, arrays, periods)
            series = run.run_serial()
            self._bank(run)
            yield bucket, series


class AsyncExecutor(Executor):
    """Plan and dispatch back to back, collect afterwards.

    Each bucket's chunks are all planned and dispatched as soon as the
    bucket starts, so the host plans chunk c+1 while the card still runs
    what chunk c enqueued.  ``max_in_flight`` bounds how many dispatched
    buckets' device values stay resident: once the window is full, the
    oldest bucket is collected (blocking) before the next one is planned
    and dispatched.  A chunked bucket counts as one unit.  ``None`` keeps
    every bucket in flight; ``max_in_flight=1`` is the serial schedule
    across buckets with every chunk of a bucket still dispatched before
    its first collect.  Capped or not, chunked or not, the results are
    bitwise :class:`SerialExecutor`'s: every phase is a pure function of
    its bucket and the carried state, and each planner consumes its rng
    streams in chunk order as a serial run does."""

    def __init__(self, mesh=None, max_in_flight: Optional[int] = None,
                 chunk_periods: Optional[int] = None):
        super().__init__(mesh=mesh, chunk_periods=chunk_periods)
        if max_in_flight is not None and max_in_flight < 1:
            raise ValueError(
                f"max_in_flight must be >= 1, got {max_in_flight}")
        self.max_in_flight = max_in_flight

    def _finish(self, run: BucketRun) -> BucketSeries:
        series = run.drain()
        self._bank(run)
        return run.bucket, series

    def execute(self, buckets, data, arrays, periods):
        self._start(arrays.device)
        cap = self.max_in_flight or len(buckets)
        pending: deque = deque()
        for bucket in buckets:
            if len(pending) >= cap:
                yield self._finish(pending.popleft())
            run = self._run(bucket, data, arrays, periods)
            while run.can_advance:
                run.advance()
            pending.append(run)
        while pending:
            yield self._finish(pending.popleft())


class MeshExecutor(SerialExecutor):
    """The serial schedule over a batch mesh; builds
    ``make_batch_mesh(max_devices)`` over the experiment's device type
    when no mesh is given."""

    def __init__(self, mesh=None, max_devices: Optional[int] = None,
                 chunk_periods: Optional[int] = None):
        super().__init__(mesh=mesh, chunk_periods=chunk_periods)
        self.max_devices = max_devices

    def _resolve_mesh(self, device):
        if self.mesh is None:
            self.mesh = make_batch_mesh(self.max_devices,
                                        device=torch.device(device).type)
        return _check_mesh(self.mesh, device)
