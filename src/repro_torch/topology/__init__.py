"""Fleet topology: per-round client sampling, hierarchical
cell→edge→cloud aggregation, and K-banded sub-bucketing.

* :class:`Sampling` / :class:`ParticipationSampler` — S-of-K per-period
  participation, realized as a *time-varying* user mask through the
  lowering's ``active`` machinery (the static padding mask is the
  constant special case);
* :class:`Topology` — two-tier edge aggregation with a per-cell
  Algorithm-1 solve and a wired backhaul ledger on cloud rounds;
* :func:`band_width` / :func:`split_bands` — powers-of-two user-axis pads,
  so a grid whose fleet sizes span decades pads each row to its band
  instead of the grid's largest fleet.

A copy of the reference's ``topology`` package, drawing the same streams
in the same order.
"""
from repro_torch.topology.bands import band_width, split_bands
from repro_torch.topology.hierarchy import Topology
from repro_torch.topology.sampling import ParticipationSampler, Sampling

__all__ = ["Sampling", "ParticipationSampler", "Topology",
           "band_width", "split_bands"]
