"""Two-tier cell → edge-server → cloud aggregation topology.

:class:`Topology` is the frozen spec-side value (``ScenarioSpec.topology``):
the fleet's K users split contiguously across ``cells`` wireless cells,
the cells split contiguously across ``edges`` edge servers, and the edge
servers sync to the cloud every ``agg_every`` periods over a wired
backhaul.  Semantics (HierFAVG-style, after the edge/client selection in
the ``drzhang3/Fed`` server and the hierarchy surveyed by Qin et al.
2005.05265):

* every period, Algorithm 1 allocates batchsize/slots *within each cell*
  (a masked per-cell rows solve over the same channel draws the flat
  scenario uses — the cell partition is a mask, not a new Monte-Carlo
  stream), and each edge server aggregates its own users' gradients into
  its own model replica;
* every ``agg_every``-th period is a *cloud round*: edge replicas merge
  into the batch-weighted global average (which is also the model every
  reported metric evaluates), and the period's latency ledger gains the
  edge→cloud backhaul round trip on top of the slowest cell's radio
  round;
* ``(cells, edges, agg_every)`` is *structural* (it shapes the hierarchical
  loop: number of edge replicas, cloud-merge cadence), while
  ``backhaul_bps`` only changes ledger values — so scenarios differing
  only in backhaul rate share one program.

A copy of the reference's ``topology.hierarchy`` (pure numpy).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.channels.model import wired_latency

__all__ = ["Topology"]


@dataclass(frozen=True)
class Topology:
    """Cell→edge→cloud grouping for one scenario (see module docstring)."""
    cells: int = 2
    edges: int = 1
    agg_every: int = 1
    backhaul_bps: float = 1e9

    def __post_init__(self):
        for name in ("cells", "edges", "agg_every"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(
                    f"topology {name} must be a positive int, got {v!r}")
        if self.edges > self.cells:
            raise ValueError(
                f"topology needs edges <= cells, got {self.edges} edge "
                f"servers over {self.cells} cells")
        if self.backhaul_bps <= 0:
            raise ValueError(
                f"backhaul_bps must be positive, got {self.backhaul_bps!r}")

    # ---- structural identity ---------------------------------------------
    def structural_key(self) -> tuple:
        """The bucket-key element: everything that shapes the
        hierarchical device loop.  ``backhaul_bps`` is absent on purpose (ledger
        values only)."""
        return (self.cells, self.edges, self.agg_every)

    # ---- membership ------------------------------------------------------
    def cell_of_users(self, k: int) -> np.ndarray:
        """Contiguous user→cell assignment, ``(k,)`` int."""
        if k < self.cells:
            raise ValueError(
                f"fleet of {k} users cannot populate {self.cells} cells")
        out = np.empty(k, np.int64)
        for c, idx in enumerate(np.array_split(np.arange(k), self.cells)):
            out[idx] = c
        return out

    def edge_of_cells(self) -> np.ndarray:
        """Contiguous cell→edge assignment, ``(cells,)`` int."""
        out = np.empty(self.cells, np.int64)
        for e, idx in enumerate(np.array_split(np.arange(self.cells),
                                               self.edges)):
            out[idx] = e
        return out

    def cell_masks(self, k: int) -> np.ndarray:
        """``(cells, k)`` float {0,1} one-hot rows (disjoint, covering)."""
        cell = self.cell_of_users(k)
        return (cell[None, :] == np.arange(self.cells)[:, None]) * 1.0

    def member_matrix(self, k: int, k_pad: int = None) -> np.ndarray:
        """``(edges, k_pad)`` float32 user→edge one-hot; pad columns (users
        beyond the true fleet) belong to no edge — all-zero columns, so
        padded lanes carry the monoid identity through every edge
        contraction."""
        k_pad = k if k_pad is None else k_pad
        edge = self.edge_of_cells()[self.cell_of_users(k)]
        member = np.zeros((self.edges, k_pad), np.float32)
        member[edge, np.arange(k)] = 1.0
        return member

    # ---- ledgers ---------------------------------------------------------
    def cloud_rounds(self, periods: int, offset: int = 0) -> np.ndarray:
        """``(periods,)`` float32 {0,1}: 1 on cloud-round periods.  The
        cadence counts *global* periods (``offset`` = periods already
        planned), so chunked horizons reproduce the monolithic cadence."""
        p = offset + 1 + np.arange(periods)
        return (p % self.agg_every == 0).astype(np.float32)

    def backhaul_roundtrip(self, payload_bits: float) -> float:
        """Edge→cloud upload + cloud→edge broadcast wall time for one
        model-sized payload in each direction."""
        return (wired_latency(payload_bits, self.backhaul_bps)
                + wired_latency(payload_bits, self.backhaul_bps))

    def __str__(self) -> str:  # readable grid-axis coordinate
        return (f"c{self.cells}e{self.edges}a{self.agg_every}")
