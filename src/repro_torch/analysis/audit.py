"""Benchmark-grid audit CLI: ``python -m repro_torch.analysis.audit`` (the
port of the reference's ``analysis/audit.py``: the same flags, grids and
exit status, plus ``--device``).

Sweeps the repo's benchmark program families through every static pass
and writes a machine-readable ``AUDIT_report.json``:

* **taint + hygiene** over the traced bucket program of every grid
  cell: the four Table-II schemes (feel/gradient_fl at both compression
  settings, individual, model_fl), the ragged padded-fleet program
  (``--users``), the ``local_steps > 1`` delta-upload variant, the
  per-round-sampled (time-varying participation mask) programs on both
  engines, the hierarchical cell→edge→cloud family (alone and composed
  with sampling), the K-banded sub-bucketed sweep, the dynamics
  families (drifting block-fading channels, straggler/dropout faults,
  energy-budget shedding — alone and composed with sampling), and the
  big-model families (transformer / Mamba-2 train steps, SBC-compressed
  and dense uploads);
* **dispatch ledger** over a real chunked closed-loop run
  (``Experiment.run(replan=R, audit=True)``) — proving one trace per
  (bucket, chunk-length) program and zero retraces across replan
  rounds, while also exercising the ``audit=True`` hook end to end.  The
  run is on the card (``--device``, default ``cuda``; it raises without
  CUDA) unless ``--device cpu`` is given;
* **determinism lint** over the library sources.

Exit status 1 iff any error-severity finding survives.  Shapes are
deliberately tiny (the passes certify *programs*, which are shape-
polymorphic in everything but rank), so the sweep is CI-cheap.  Every
probe traces one period on the CPU under fake tensors, whatever
``--device`` says (``api.lowering.trace_bucket``).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.analysis import compile_audit, determinism
from repro_torch.analysis.report import AuditError, AuditReport, Severity
from repro_torch.api import ScenarioSpec, SerialExecutor
from repro_torch.api.experiment import Experiment, resolve_device
from repro_torch.api.lowering import (audit_bucket_taint, group_rows,
                                      plan_bucket)
from repro_torch.core import DeviceProfile
from repro_torch.data.pipeline import ClassificationData
from repro_torch.dynamics import EnergyBudget, Fading, Faults
from repro_torch.fed import engine
from repro_torch.topology import Sampling, Topology


def _fleet(k: int):
    return tuple(DeviceProfile(kind="cpu", f_cpu=(0.7 + 0.35 * (i % 3)) * 1e9)
                 for i in range(k))


def _spec(k: int, **kw) -> ScenarioSpec:
    kw.setdefault("name", f"K{k}")
    kw.setdefault("b_max", 12)
    kw.setdefault("base_lr", 0.15)
    kw.setdefault("hidden", 16)
    kw.setdefault("seeds", (0,))
    return ScenarioSpec(fleet=_fleet(k), **kw)


def _grid_specs(users):
    """The audited program families (one spec list per labeled grid)."""
    k = users[0]
    return {
        # Table II: feel == gradient_fl+SBC; gradient_fl (uncompressed
        # upload) is the compress=False program family
        "schemes": [
            _spec(k, scheme="feel"),
            _spec(k, scheme="feel", compress=False),
            _spec(k, scheme="individual"),
            _spec(k, scheme="model_fl"),
        ],
        # the ragged padded-fleet program: one bucket, k_pad = max(users)
        "ragged": [_spec(u, scheme="feel") for u in users],
        # tau > 1 local SGD (delta uploads must cancel on padded lanes)
        "local-steps": [_spec(k, scheme="feel", local_steps=2)],
        # per-round S-of-K participation: the time-varying (n, P, K)
        # active mask must dominate every cross-user reduction exactly
        # like the static padding mask it generalizes — on BOTH engines
        "sampled": [_spec(u, scheme="feel", sampling=Sampling(size=2))
                    for u in users]
                   + [_spec(k, scheme="individual",
                            sampling=Sampling(size=2)),
                      _spec(k, scheme="model_fl",
                            sampling=Sampling(size=2))],
        # cell→edge→cloud hierarchy: the "hier" program family (member
        # routing one-hots, cloud-cadence merges), plus its composition
        # with per-round sampling
        "hier": [_spec(k, scheme="feel",
                       topology=Topology(cells=2, edges=2, agg_every=2)),
                 _spec(k, scheme="feel", sampling=Sampling(size=2),
                       topology=Topology(cells=2, edges=2, agg_every=2))],
        # K-banded sub-bucketing: the ragged sweep again, one program
        # per power-of-two band (group_rows(..., bands=True) below)
        "banded": [_spec(u, scheme="feel", sampling=Sampling(fraction=0.5))
                   for u in users],
        # dynamics: drifting block-fading channels — structural
        # via the Markov state count — alone and composed with sampling
        "fading": [_spec(k, scheme="feel",
                         fading=Fading(states=3, spread=0.8)),
                   _spec(k, scheme="feel", sampling=Sampling(size=2),
                         fading=Fading(states=3, spread=0.8))],
        # straggler slowdowns + mid-horizon dropout: the config-static
        # time-varying mask must dominate reductions like sampling's
        "faults": [_spec(u, scheme="feel",
                         faults=Faults(slow_prob=0.3, drop_prob=0.2))
                   for u in users],
        # per-user energy budgets: post-solve shedding is one more
        # participation mask through the same active machinery
        "energy": [_spec(k, scheme="feel",
                         energy=EnergyBudget(budget_j=0.5)),
                   _spec(k, scheme="feel", sampling=Sampling(size=2),
                         energy=EnergyBudget(budget_j=0.5),
                         faults=Faults(slow_prob=0.2, drop_prob=0.2))],
        # big-model train steps: the transformer / mamba2 program
        # families — SBC-compressed and dense uploads, plus composition
        # with per-round sampling — certify like the MLP loop they mirror
        "models": [_spec(k, scheme="feel", model_family="transformer"),
                   _spec(k, scheme="feel", model_family="mamba2"),
                   _spec(k, scheme="feel", model_family="transformer",
                         compress=False),
                   _spec(k, scheme="feel", model_family="mamba2",
                         sampling=Sampling(size=2))],
    }


def _audit_static(report: AuditReport, data, test, users, periods: int):
    """Taint + graph hygiene over every grid cell's bucket program."""
    for grid, specs in _grid_specs(users).items():
        for bucket in group_rows(specs, bands=(grid == "banded")):
            plan = plan_bucket(bucket, data, periods)
            audit_bucket_taint(plan, data, test, report, prefix=f"{grid}:")


def _audit_chunked_run(report: AuditReport, data, test, periods: int,
                       replan: int, device):
    """A real chunked closed-loop run, trace-audited end to end."""
    specs = [_spec(3, scheme="feel", seeds=(0, 1)),
             _spec(3, scheme="individual")]
    mark = len(engine.trace_events())
    res = Experiment(data, test, specs, device=device).run(
        periods=periods, executor=SerialExecutor(), replan=replan,
        audit=True)
    run_report = res.audit
    # fold the hook's findings in under distinct labels
    for f in run_report.findings:
        report.findings.append(f)
    for k, v in run_report.programs.items():
        report.programs[f"replan-run:{k}"] = v
    events = engine.trace_events()[mark:]
    compile_audit.audit_traces(
        events, label=f"chunked-replan={replan}", report=report)
    return len(events)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.audit",
        description="static padding-taint / determinism / compile-hygiene "
                    "audit over the benchmark bucket programs")
    ap.add_argument("--out", default="AUDIT_report.json",
                    help="report path (default: %(default)s)")
    ap.add_argument("--users", default="4,8,16",
                    help="ragged fleet sizes, comma-separated "
                         "(default: %(default)s)")
    ap.add_argument("--periods", type=int, default=3,
                    help="horizon length for probed programs "
                         "(default: %(default)s)")
    ap.add_argument("--replan", type=int, default=2,
                    help="closed-loop chunk length for the trace-audited "
                         "run (default: %(default)s)")
    ap.add_argument("--skip-run", action="store_true",
                    help="skip the executed chunked-run trace audit "
                         "(static passes only)")
    ap.add_argument("--device", default=None,
                    help="device of the executed run (default: cuda, "
                         "raising without it; 'cpu' for the CPU path)")
    args = ap.parse_args(argv)
    users = sorted(int(u) for u in args.users.split(","))
    device = None if args.skip_run else resolve_device(args.device)

    full = ClassificationData.synthetic(n=220, dim=12, seed=0, spread=6.0)
    data, test = full.split(60)

    report = AuditReport()
    _audit_static(report, data, test, users, args.periods)
    if not args.skip_run:
        try:
            _audit_chunked_run(report, data, test, args.periods,
                               args.replan, device)
        except Exception as exc:  # an AuditError already carries findings
            if not isinstance(exc, AuditError):
                report.add("compile.run-failed", Severity.ERROR,
                           "chunked-replan-run", repr(exc))
    determinism.lint_sources(report=report)

    report.write(args.out)
    print(report.summary())
    for name, prog in sorted(report.programs.items()):
        certified = prog.get("n_certified_reductions")
        extra = f", certified={certified}" if certified is not None else ""
        print(f"  [{'ok' if prog.get('ok') else 'FAIL'}] {name}"
              f" ({prog['pass']}{extra})")
    for f in report.errors():
        print(f"  ERROR {f.check} @ {f.where}: {f.detail}")
    print(f"wrote {args.out}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
