"""Determinism lint: non-bit-stable idioms the repo has been burned by
(the port of the reference's ``analysis/determinism.py``: the same rules,
coupled paths and finding texts, over the port's sources by default).

Three AST-level rules over the library sources (device programs are
covered by the taint/compile passes; this pass guards the HOST planning
code, whose numerics are part of the bit-exactness contract):

* ``det.pairwise-sum`` — in modules that define the strictly-sequential
  ``_ssum`` row reduction (``np.sum`` pairwise-splits long axes,
  so a padded row's sum need not bit-match the unpadded row's),
  any other ``np.sum`` call is suspect.
* ``det.unseeded-cumsum`` — ``np.cumsum(x) + offset`` is not
  bit-identical to the seeded ``np.cumsum(concatenate([[offset], x]))``
  form (float addition is non-associative); chunked ledgers must
  use the seeded form.
* ``det.prng-stream-collision`` — distinct rng *streams* (channel
  fading, batch sampling, scheduler jitter) constructed from the same
  seed expression are correlated.  Advisory (WARN): the repo's existing
  collisions are frozen into bit-exact expectations, so the lint
  documents rather than breaks them; new streams should derive distinct
  seeds (e.g. ``seed + 1`` as ``FeelScheduler`` does).
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Optional

from repro_torch.analysis.report import AuditReport, Severity

__all__ = ["lint_sources"]

# modules whose rng streams must be mutually independent (they interleave
# in one simulation): channel draws, batch sampling, scheduler jitter
_PRNG_COUPLED = ("channels/model.py", "core/scheduler.py",
                 "data/pipeline.py", "fed/engine.py")


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _is_np_sum(node) -> bool:
    return (isinstance(node, ast.Call) and _call_name(node) == "sum"
            and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in ("np", "numpy"))


def _is_cumsum(node) -> bool:
    return isinstance(node, ast.Call) and _call_name(node) == "cumsum"


def _norm_seed_expr(expr: ast.AST) -> str:
    """Normalize a seed expression: ``self.seed`` / ``args.seed`` and the
    bare ``seed`` are the same stream source."""
    text = ast.unparse(expr)
    for prefix in ("self.", "args.", "cfg.", "spec."):
        text = text.replace(prefix, "")
    return text


class _Walker(ast.NodeVisitor):
    """AST walk tracking the enclosing class/function qualname."""

    def __init__(self):
        self.stack = []
        self.sites = []  # (qualname, node)

    def visit_scoped(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = visit_AsyncFunctionDef = visit_ClassDef = \
        visit_scoped

    def generic_visit(self, node):
        self.sites.append((".".join(self.stack), node))
        super().generic_visit(node)


def _scoped_nodes(tree):
    w = _Walker()
    w.visit(tree)
    return w.sites


def _lint_file(path: Path, rel: str, report: AuditReport, prng_sites: dict):
    tree = ast.parse(path.read_text(), filename=str(path))
    sites = _scoped_nodes(tree)
    defines_ssum = any(isinstance(n, ast.FunctionDef) and n.name == "_ssum"
                       for _, n in sites)
    for qual, node in sites:
        # rule 1: np.sum in an _ssum-disciplined module
        if defines_ssum and _is_np_sum(node) and "_ssum" not in qual:
            report.add(
                "det.pairwise-sum", Severity.WARN,
                f"{rel}:{node.lineno}",
                f"np.sum in {qual or '<module>'}: this module sums over "
                "padded fleet axes and must use the strictly-sequential "
                "_ssum (np.sum pairwise-splits long axes; padded rows "
                "would stop bit-matching solo rows)")
        # rule 2: cumsum + offset instead of seeded cumsum
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add) \
                and (_is_cumsum(node.left) or _is_cumsum(node.right)):
            report.add(
                "det.unseeded-cumsum", Severity.ERROR,
                f"{rel}:{node.lineno}",
                f"cumsum(x) + offset in {qual or '<module>'}: float "
                "addition is non-associative — chunked ledgers must seed "
                "the cumsum (np.cumsum(concatenate([[offset], x]))[1:]) "
                "to stay bit-identical to the monolithic ledger")
        # rule 3 collection: default_rng seed expressions in coupled files
        if any(rel.endswith(m) for m in _PRNG_COUPLED) \
                and isinstance(node, ast.Call) \
                and _call_name(node) == "default_rng" and node.args:
            seed = _norm_seed_expr(node.args[0])
            prng_sites.setdefault(seed, []).append(
                (rel, node.lineno, qual or "<module>"))


def lint_sources(root=None,
                 report: Optional[AuditReport] = None) -> AuditReport:
    """Run the determinism lint over the library sources.

    ``root`` defaults to the installed ``repro_torch`` package directory;
    any package's tree lints the same way (``rel`` paths start at its
    name).
    Findings accumulate into ``report`` (a fresh one when None); a
    summary lands in ``report.programs["determinism-lint"]``.
    """
    if report is None:
        report = AuditReport()
    if root is None:
        import repro_torch
        root = Path(list(repro_torch.__path__)[0])
    root = Path(root)
    prng_sites: dict = {}
    n_files = 0
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root.parent).as_posix()
        if "/analysis/" in rel or "/testing/" in rel:
            continue  # the analyzers themselves are out of scope
        n_files += 1
        _lint_file(path, rel, report, prng_sites)
    n_collisions = 0
    for seed, sites in sorted(prng_sites.items()):
        scopes = {(rel, qual) for rel, _, qual in sites}
        if len(scopes) < 2:
            continue
        n_collisions += 1
        listing = ", ".join(f"{rel}:{line} ({qual})"
                            for rel, line, qual in sites)
        report.add(
            "det.prng-stream-collision", Severity.WARN,
            sites[0][0] + f":{sites[0][1]}",
            f"{len(sites)} rng streams derive from the same seed "
            f"expression {seed!r}: {listing} — streams are correlated; "
            "new streams should derive a distinct seed (cf. "
            "FeelScheduler's seed + 1)")
    report.programs["determinism-lint"] = {
        "pass": "determinism",
        "n_files": n_files,
        "n_prng_collision_groups": n_collisions,
        "ok": not any(f.severity is Severity.ERROR
                      for f in report.findings
                      if f.check.startswith("det.")),
    }
    return report
