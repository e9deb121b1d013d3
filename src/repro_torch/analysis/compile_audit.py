"""Compile-hygiene audit: dispatch discipline + graph hygiene (the port of
the reference's ``analysis/compile_audit.py``).

Two surfaces:

* **Trace ledger** (:func:`audit_traces`) — consumes the engine's
  dispatch ledger (:func:`repro_torch.fed.engine.trace_events`: one
  ``TraceEvent(kind, key, signature)`` at a program's first dispatch with
  an argument signature) and proves the one-trace-per-bucket contract: no
  (kind, cache-key, arg-signature) triple is ever recorded twice.  A
  chunked horizon records once per distinct chunk *length* (different
  shapes); a duplicate triple means a program met a signature it had
  already run as if it were new — e.g. an ``lru_cache`` defeated by a
  non-hashable static argument.
* **Graph hygiene** (:func:`audit_graph_hygiene`) — walks a bucket program
  traced to a ``torch.fx.GraphModule`` of aten ops (``api.lowering
  .trace_bucket``) and flags (a) 64-bit values — host planners work in
  float64 and must cross ``engine.host_to_device``, which makes float32
  and int32 — and (b) large constants folded into the graph (a captured
  array is baked into the program; datasets must be passed as arguments).

**What counts as a 64-bit leak.**  Every 64-bit program *input*, float
or integer, is an ERROR: nothing 64-bit crosses ``host_to_device``.
Inside the graph, every float64 or complex128 value is an ERROR.  int64
*intermediates* are not: they are torch's own index and count types —
``gather`` and ``scatter_add`` take int64 indices (the loss casts its
int32 labels with ``.long()``), ``argmax`` returns int64, and a ``sum``
of a bool mask counts in int64 (the SBC threshold's count passes).  The
reference's XLA programs count in int32 under the same rule; torch has no
such mode.  They are counted in the program's summary
(``n_int64_intermediates``), so a change in their number shows.
"""
from __future__ import annotations

import operator
from collections import Counter
from typing import Optional

import torch

from repro_torch.analysis.report import AuditReport, Severity

__all__ = ["audit_traces", "audit_graph_hygiene"]

# one 64-bit scalar is harmless; a folded dataset is not
_CONST_ELEMENT_LIMIT = 4096
_WIDE_FLOATS = (torch.float64, torch.complex128)
_WIDE_INTS = (torch.int64, torch.uint64)


def audit_traces(events=None, *, label: str = "trace-ledger",
                 expect_total: Optional[int] = None,
                 report: Optional[AuditReport] = None) -> AuditReport:
    """Audit a dispatch ledger for retraces.

    ``events`` defaults to the engine's full process ledger; pass a
    slice (``engine.trace_events()[mark:]``) to audit one run.
    ``expect_total`` additionally pins the exact number of events (the
    per-Experiment contract: one per (bucket, chunk-length) program).
    """
    if report is None:
        report = AuditReport()
    if events is None:
        from repro_torch.fed import engine
        events = engine.trace_events()
    counts = Counter(events)
    n_dup = 0
    for ev, n in counts.items():
        if n > 1:
            n_dup += n - 1
            report.add(
                "compile.retrace", Severity.ERROR, f"{label}:{ev.kind}",
                f"program {ev.kind}{ev.key} traced {n}x for identical "
                f"argument signature — the program cache should have "
                f"absorbed {n - 1} of these; signature={ev.signature}")
    if expect_total is not None and len(events) != expect_total:
        report.add(
            "compile.trace-count", Severity.ERROR, label,
            f"expected exactly {expect_total} trace(s), ledger has "
            f"{len(events)}: {[(e.kind, e.key) for e in events]}")
    report.programs[label] = {
        "pass": "compile",
        "n_traces": len(events),
        "n_unique_programs": len(counts),
        "n_retraces": n_dup,
        "ok": n_dup == 0 and (expect_total is None
                              or len(events) == expect_total),
    }
    return report


def _tensors(val):
    """The tensors of a node's ``meta["val"]`` (one, or a tuple's)."""
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (tuple, list)):
        return [v for v in val if isinstance(v, torch.Tensor)]
    return []


def audit_graph_hygiene(gm: torch.fx.GraphModule, *,
                        program: str = "program",
                        report: Optional[AuditReport] = None
                        ) -> AuditReport:
    """64-bit-leak and folded-constant audit over one traced program."""
    if report is None:
        report = AuditReport()
    n_wide = n_vals = n_int64 = n_large = 0
    for node in gm.graph.nodes:
        if node.op == "output" or node.target is operator.getitem:
            continue
        for t in _tensors(node.meta.get("val")):
            n_vals += 1
            wide = (t.dtype in _WIDE_FLOATS
                    or (node.op == "placeholder" and t.dtype in _WIDE_INTS))
            if wide:
                n_wide += 1
                what = ("program input" if node.op == "placeholder"
                        else "value inside the device program")
                report.add(
                    "compile.x64-leak", Severity.ERROR,
                    f"{program}:{node.name}",
                    f"{t.dtype} {what} (shape {tuple(t.shape)}) — host "
                    "64-bit planning leaked past engine.host_to_device")
            elif t.dtype in _WIDE_INTS:
                n_int64 += 1
        if node.op == "get_attr":
            const = getattr(gm, node.target)
            size = const.numel() if isinstance(const, torch.Tensor) else 0
            if size > _CONST_ELEMENT_LIMIT:
                n_large += 1
                report.add(
                    "compile.folded-constant", Severity.WARN,
                    f"{program}:{node.target}",
                    f"constant of {size} elements "
                    f"({size * const.element_size()} bytes) folded into "
                    "the graph — pass large arrays as arguments so they "
                    "are shared, not baked into the program")
    report.programs[f"{program}/hygiene"] = {
        "pass": "compile",
        "n_values_checked": n_vals,
        "n_x64_leaks": n_wide,
        "n_int64_intermediates": n_int64,
        "n_large_constants": n_large,
        "ok": n_wide == 0,
    }
    return report
