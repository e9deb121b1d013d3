"""Shared finding/report datamodel for the static-analysis passes.

Every pass emits :class:`Finding` rows into an :class:`AuditReport`;
severities split machine-enforceable errors (taint escapes, retraces,
64-bit leaks) from advisory warnings (PRNG stream collisions) and
informational notes (assumptions the proofs rest on).  The report
serializes to the ``AUDIT_report.json`` schema the CI job uploads.
"""
from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field


class Severity(str, enum.Enum):
    """How bad a finding is.

    ``ERROR`` findings fail the audit (CLI exit 1, ``AuditError`` under
    ``Experiment.run(audit=True)``); ``WARN`` is advisory; ``INFO``
    records proof assumptions and certificate statistics.
    """
    ERROR = "error"
    WARN = "warn"
    INFO = "info"


@dataclass(frozen=True)
class Finding:
    """One analysis result row.

    ``check``   — machine name of the rule (e.g. ``taint.unmasked-reduction``)
    ``severity``— :class:`Severity`
    ``where``   — program path to the site (eqn trail, file:line, ...)
    ``detail``  — human-readable explanation
    """
    check: str
    severity: Severity
    where: str
    detail: str

    def to_json(self) -> dict:
        return {"check": self.check, "severity": self.severity.value,
                "where": self.where, "detail": self.detail}


class AuditError(RuntimeError):
    """Raised when an audit surfaces error-severity findings."""

    def __init__(self, report: "AuditReport"):
        self.report = report
        lines = [f"  [{f.severity.value}] {f.check} @ {f.where}: {f.detail}"
                 for f in report.errors()]
        super().__init__(
            f"audit failed with {len(report.errors())} error finding(s):\n"
            + "\n".join(lines))


@dataclass
class AuditReport:
    """Findings from one or more passes over one or more programs.

    ``programs`` maps a program label (e.g. the bucket key) to its
    per-program summary dict (certified reduction counts, trace totals,
    ...); ``findings`` is the flat finding list across all programs.
    """
    findings: list = field(default_factory=list)
    programs: dict = field(default_factory=dict)

    def add(self, check: str, severity: Severity, where: str,
            detail: str) -> None:
        self.findings.append(Finding(check, severity, where, detail))

    def extend(self, other: "AuditReport") -> None:
        self.findings.extend(other.findings)
        self.programs.update(other.programs)

    def errors(self) -> list:
        return [f for f in self.findings if f.severity is Severity.ERROR]

    def warnings(self) -> list:
        return [f for f in self.findings if f.severity is Severity.WARN]

    @property
    def ok(self) -> bool:
        """True iff no error-severity findings."""
        return not self.errors()

    def raise_on_error(self) -> "AuditReport":
        if not self.ok:
            raise AuditError(self)
        return self

    def to_json(self) -> dict:
        return {
            "ok": self.ok,
            "n_errors": len(self.errors()),
            "n_warnings": len(self.warnings()),
            "programs": self.programs,
            "findings": [f.to_json() for f in self.findings],
        }

    def write(self, path) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=2, sort_keys=True)
            fh.write("\n")

    def summary(self) -> str:
        """One-line human summary for CLI output."""
        status = "OK" if self.ok else "FAIL"
        return (f"audit {status}: {len(self.programs)} program(s), "
                f"{len(self.errors())} error(s), "
                f"{len(self.warnings())} warning(s), "
                f"{len(self.findings)} finding(s) total")
