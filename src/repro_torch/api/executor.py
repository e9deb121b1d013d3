"""Experiment runtimes: how buckets are scheduled on the device.

The lowering (``api.lowering``) splits every bucket into three phases —
host-side *plan*, asynchronous device *dispatch*, blocking *collect* —
and an :class:`Executor` is a composition policy over them.

* :class:`SerialExecutor` — plan → dispatch → collect one bucket at a
  time.  With ``chunk_periods=C`` each bucket runs as C-period chunks
  through :class:`~repro_torch.api.lowering.BucketRun`, carrying the
  engine state between chunks (bitwise equal to the monolithic run).

Executors yield ``(bucket, (losses, accs, times, global_batch))`` in
bucket order, which is what lets ``Experiment.stream`` hand back
incrementally collected ``Results``.
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

from repro_torch.api.lowering import (Bucket, BucketRun, collect_bucket,
                                      dispatch_bucket, plan_bucket)

BucketSeries = Tuple[Bucket, tuple]


class Executor:
    """Composition policy over the plan/dispatch/collect bucket phases."""

    def __init__(self, chunk_periods: Optional[int] = None):
        if chunk_periods is not None and chunk_periods < 1:
            raise ValueError(
                f"chunk_periods must be >= 1, got {chunk_periods}")
        self.chunk_periods = chunk_periods

    def execute(self, buckets: Sequence[Bucket], data, arrays,
                periods: int) -> Iterator[BucketSeries]:
        """Yield ``(bucket, (losses, accs, times, global_batch))`` per
        bucket, in bucket order.  ``data`` is the host training set (for
        planning), ``arrays`` the experiment's
        :class:`~repro_torch.api.lowering.DeviceData`."""
        raise NotImplementedError


class SerialExecutor(Executor):
    """One bucket at a time, blocking at each collection."""

    def execute(self, buckets, data, arrays, periods):
        for bucket in buckets:
            if self.chunk_periods is None:
                handle = dispatch_bucket(plan_bucket(bucket, data, periods),
                                         arrays)
                yield bucket, collect_bucket(handle)
            else:
                run = BucketRun(bucket, data, periods, self.chunk_periods,
                                arrays)
                yield bucket, run.run_serial()
