"""Static analysis over traced bucket programs (the port of the
reference's ``analysis`` package).

Three passes turn the repo's example-tested invariants into all-inputs
guarantees:

* :mod:`repro_torch.analysis.taint` — abstract interpretation over the
  aten graph of every bucket program (FEEL, dev, hierarchy and big-model
  families; ``api.lowering.trace_bucket`` traces one period of it with
  each kernel one stand-in node), proving padded user lanes are
  mask-dominated before any cross-user reduction;
* :mod:`repro_torch.analysis.determinism` — lint for non-bit-stable
  idioms (pairwise-unrolled reductions, unseeded cumsum ledgers, PRNG key
  collisions across streams);
* :mod:`repro_torch.analysis.compile_audit` — dispatch-ledger audit (one
  trace per bucket, zero retraces across chunks/replan rounds), 64-bit
  leak and folded-constant detection on the traced graph itself.

:mod:`repro_torch.analysis.report` defines the shared finding/report
datamodel; ``python -m repro_torch.analysis.audit`` sweeps the benchmark
grids and writes ``AUDIT_report.json``.
"""
from repro_torch.analysis.report import (AuditError, AuditReport, Finding,
                                         Severity)

__all__ = ["AuditError", "AuditReport", "Finding", "Severity"]
