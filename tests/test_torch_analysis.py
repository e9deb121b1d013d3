"""The port's static analysis (``repro_torch.analysis``), as counterparts
of the reference's ``tests/test_analysis.py`` over traced aten graphs.

* The taint lattice on small torch functions traced by ``make_fx``:
  mask-dominated reductions certify, the seeded poisoned-padding mutant
  is rejected, identity mismatches, broken output contracts and poisoned
  outputs are flagged, ``Same`` lanes cancel, and a battery of per-op
  rules (within-lane ops keep the certificate, cross-lane ones are
  flagged at the site).
* The kernel stand-ins' rules: SBC maps zero segments to zero
  approximations and residuals; a kernel fed a user digit off its
  independent axis is flagged.
* Real bucket programs: the feel-mlp program carries and proves the SBC
  residual contract, holds one stand-in node per kernel call and no
  64-bit value; a reduced transformer program records the attention
  stand-ins' backward; the one-period induction's premise holds.
* Compile hygiene (dispatch ledger, 64-bit leaks, folded constants), the
  determinism lint, ``Experiment.run(audit=True)`` (its losses bitwise
  the unaudited run's), ``AuditError`` and ``assert_device_safe``.
* The numeric check behind the certificate: large finite garbage on the
  padded lanes of a padded bucket's variant inputs leaves every active
  row's losses, parameters and residuals bitwise unchanged (feel-mlp and
  dev, K 4 padded to 8).

Shapes (dim 20, hidden 24, b_max 10) follow the reference's module."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.analysis import (AuditError, AuditReport, Severity,
                                  compile_audit, determinism, taint)
from repro_torch.analysis.report import Finding
from repro_torch.analysis.taint import NO_LABEL, LaneLabel, OutContract
from repro_torch.api import Experiment, ScenarioSpec, SerialExecutor
from repro_torch.api import lowering
from repro_torch.compression.sbc import compress_segments
from repro_torch.core.latency import DeviceProfile
from repro_torch.data.pipeline import ClassificationData
from repro_torch.fed import engine
from repro_torch.kernels import probe
from repro_torch.tree import tree_leaves

DIM, HIDDEN, BMAX = 20, 24, 10
PERIODS = 3


@pytest.fixture(scope="module")
def dataset():
    full = ClassificationData.synthetic(n=260, dim=DIM, seed=0, spread=6.0)
    return full.split(60)


def _fleet(k):
    return tuple(DeviceProfile(kind="cpu", f_cpu=(0.7 + 0.35 * (i % 3)) * 1e9)
                 for i in range(k))


def _spec(k, **kw):
    kw.setdefault("name", f"K{k}")
    kw.setdefault("b_max", BMAX)
    kw.setdefault("base_lr", 0.15)
    kw.setdefault("hidden", HIDDEN)
    kw.setdefault("seeds", (0,))
    return ScenarioSpec(fleet=_fleet(k), **kw)


def _analyze(fn, args, labels, contracts=None, program="synthetic"):
    with probe.probing():
        gm = make_fx(fn, tracing_mode="fake")(*args)
    return taint.analyze_graph(gm, labels, contracts, program=program,
                               report=AuditReport())


def _checks(report):
    return {f.check for f in report.errors()}


def _ok(fn, args, labels):
    report = _analyze(fn, args, labels)
    assert report.ok, [f.detail for f in report.errors()]
    return report


def _fails(fn, args, labels, check):
    report = _analyze(fn, args, labels)
    assert not report.ok and check in _checks(report), _checks(report)
    return report


_X = torch.zeros(4, 3)
_M = torch.zeros(4)
_XM = [LaneLabel(0), LaneLabel(0, 0.0)]


# ---------------------------------------------------------------------------
# the taint lattice on small traced functions
# ---------------------------------------------------------------------------

_CASES = [(k, feat, op) for op in ("sum", "reshape-sum", "dot")
          for k, feat in ((2, 1), (3, 4), (6, 6))]


@pytest.mark.parametrize("k,feat,op", _CASES)
def test_mask_dominated_reductions_certify(k, feat, op):
    """A cross-user reduction of a mask-multiplied operand (padded lanes
    provably the monoid identity) certifies, through a reshape that
    merges the user axis and through a contraction."""
    def good(x, mask):
        xm = x * mask[:, None]
        if op == "sum":
            return xm.sum(0) / (mask.sum() + 1.0)
        if op == "reshape-sum":
            return xm.reshape(-1).sum() / (mask.sum() + 1.0)
        return mask @ x
    report = _ok(good, (torch.zeros(k, feat), torch.zeros(k)), _XM)
    summary = report.programs["synthetic"]
    assert summary["n_certified_reductions"] >= 1
    assert summary["n_poisoned_outputs"] == 0


@pytest.mark.parametrize("k,feat,op", _CASES)
def test_poisoned_padding_mutant_rejected(k, feat, op):
    """The seeded mutant — the mask dropped from one reduction — fails
    with an unmasked-reduction (or -contraction) finding."""
    def poisoned(x, mask):
        if op == "sum":
            return x.sum(0) / (mask.sum() + 1.0)
        if op == "reshape-sum":
            return x.reshape(-1).sum() / (mask.sum() + 1.0)
        return (torch.ones(k) * 1.0 + 0.0 * mask) @ x
    report = _analyze(poisoned, (torch.zeros(k, feat), torch.zeros(k)),
                      _XM)
    assert not report.ok
    assert _checks(report) & {"taint.unmasked-reduction",
                              "taint.unmasked-contraction"}


@pytest.mark.parametrize("fn,check", [
    # Known(0) lanes prove a sum safe, not a max (identity -inf) or a mean
    (lambda x, m: (x * m[:, None]).amax(0), "taint.unmasked-reduction"),
    (lambda x, m: (x * m[:, None]).mean(0), "taint.unmasked-reduction"),
    # a poisoned value reaching an output is an error on its own
    (lambda x, m: x.sum(0), "taint.poisoned-output"),
], ids=["max", "mean", "poisoned-output"])
def test_identity_mismatch_and_poisoned_output_rejected(fn, check):
    _fails(fn, (_X, _M), _XM, check)


def test_output_contract_violation_detected():
    """An output contracted to Known(0) on padded lanes fails when the
    program leaves those lanes variant; one contracted lane-free fails
    when it carries a user axis."""
    for contract in (OutContract(axis=0, value=0.0), OutContract(axis=None)):
        report = _analyze(lambda x: x * 2.0, (_X,), [LaneLabel(0)],
                          contracts={0: contract})
        assert "taint.output-contract" in _checks(report)


def test_same_lane_cancellation():
    """pk's lanes are variant, so pk − broadcast(p) does not cancel..."""
    report = _analyze(lambda p, pk: (pk - p[None, :]).sum(0),
                      (torch.zeros(3), _X), [NO_LABEL, LaneLabel(0)])
    assert not report.ok


def test_same_lane_cancellation_through_broadcast():
    """...but when pk's padded lanes provably EQUAL the broadcast source
    (the Same element: τ > 1's parameter delta), the difference is
    Known(0) and its cross-user sum certifies."""
    def delta(p, g):
        pk = p[None, :].expand(4, 3) - 0.5 * g
        return (p[None, :] - pk).sum(0)
    _ok(delta, (torch.zeros(3), _X), [NO_LABEL, LaneLabel(0, 0.0)])


# per-op rules: within-lane ops keep the certificate, cross-lane flagged
@pytest.mark.parametrize("fn", [
    lambda x, m: torch.where(m[:, None] > 0, x, 0.0).sum(0),
    lambda x, m: torch.clamp(x * m[:, None], 0.0, 1.0).sum(0),
    lambda x, m: (x * m[:, None]).to(torch.int32).sum(0),
    lambda x, m: torch.nn.functional.pad(x * m[:, None], (1, 1)).sum(0),
    lambda x, m: (x * m[:, None])[:, 1:].sum(0),
    lambda x, m: torch.cat([x * m[:, None], x * m[:, None]], 1).sum(0),
    lambda x, m: torch.stack((x * m[:, None]).unbind(1), 0).sum(1),
    lambda x, m: sum(t.sum(0) for t in (x * m[:, None]).split(2, 1)),
    lambda x, m: torch.cumsum(x * m[:, None], 1).sum(0),
    lambda x, m: (x * m[:, None])[:, torch.tensor([2, 0])].sum(0),
    lambda x, m: ((x * m[:, None]) @ torch.ones(3, 5)).sum(0),
    lambda x, m: torch.log_softmax(x * m[:, None], 1).mul(m[:, None])
    .sum(0),
], ids=["where", "clamp", "convert", "pad", "slice", "cat", "stack-unbind",
        "split", "cumsum-within", "index-within", "dot-free-axis",
        "log-softmax-within"])
def test_within_lane_ops_keep_the_certificate(fn):
    _ok(fn, (_X, _M), _XM)


@pytest.mark.parametrize("fn,check", [
    (lambda x, m: torch.cumsum(x, 0), "taint.cumulative-over-user-axis"),
    (lambda x, m: x[torch.tensor([0, 1]), :],
     "taint.gather-over-user-axis"),
    (lambda x, m: x[1], "taint.gather-over-user-axis"),
    (lambda x, m: torch.gather(x, 0, torch.zeros(2, 3, dtype=torch.long)),
     "taint.gather-over-user-axis"),
    (lambda x, m: torch.zeros(6, 3).scatter_add(
        0, torch.tensor([1, 3, 0, 2])[:, None].expand(4, 3), x),
     "taint.scatter-across-user-axis"),
    (lambda x, m: torch.softmax(x, 0), "taint.unmasked-reduction"),
    (lambda x, m: torch.sort(x, 0).values, "taint.unhandled-primitive"),
], ids=["cumsum", "index", "select", "gather", "scatter-add", "softmax",
        "no-rule"])
def test_cross_lane_ops_are_flagged(fn, check):
    _fails(fn, (_X, _M), _XM, check)


def test_autograd_function_is_traced_through():
    class Double(torch.autograd.Function):
        @staticmethod
        def forward(ctx, v):
            return v * 2.0

        @staticmethod
        def backward(ctx, g):
            return g * 2.0
    _ok(lambda x, m: Double.apply(x * m[:, None]).sum(0), (_X, _M), _XM)


# ---------------------------------------------------------------------------
# the kernel stand-ins' rules
# ---------------------------------------------------------------------------


def test_sbc_stand_ins_map_zero_segments_to_zero():
    """compress_segments on segments whose padded rows are Known(0): the
    approximation and the residual are Known(0) there, and the stand-ins
    are what the trace holds (no plain version, no kernel)."""
    with probe.probing():
        gm = make_fx(lambda x, m: compress_segments(x * m[:, None], 0.25),
                     tracing_mode="fake")(torch.zeros(4, 16), _M)
    ops = {str(n.target) for n in gm.graph.nodes}
    assert {"repro_torch.sbc_stats.default",
            "repro_torch.sbc_apply.default"} <= ops
    report = taint.analyze_graph(gm, _XM, {0: OutContract(0, 0.0),
                                           1: OutContract(0, 0.0)})
    assert report.ok, [f.detail for f in report.errors()]


def test_kernel_fed_a_user_axis_off_its_segments_is_flagged():
    report = _analyze(lambda x, m: compress_segments(x.t().contiguous(),
                                                     0.25),
                      (torch.zeros(4, 16), _M), _XM)
    assert "taint.kernel-over-user-axis" in _checks(report)


def test_stand_ins_are_never_executed_and_outside_a_probe_change_nothing():
    x = torch.randn(3, 8)
    thr = torch.full((3,), 0.5)
    with pytest.raises(RuntimeError, match="never executed"):
        probe.ops().sbc_stats(x, thr)
    from repro_torch.kernels.sbc import sbc_stats, sbc_stats_plain
    assert not probe.active()
    torch.testing.assert_close(sbc_stats(x, thr), sbc_stats_plain(x, thr),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# real bucket programs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def feel_traced(dataset):
    data, test = dataset
    bucket = lowering.group_rows([_spec(3, scheme="feel")])[0]
    plan = lowering.plan_bucket(bucket, data, PERIODS)
    mark = engine.trace_count()
    traced = lowering.trace_bucket(plan, data, test)
    assert engine.trace_count() == mark       # the probe records nothing
    return traced


def test_feel_bucket_carries_and_proves_the_residual_contract(feel_traced):
    """The SBC residual carry is pinned to Known(0) on padded lanes and
    the global parameters to no user lane (the next period's labels);
    both hold, and the one-period premise holds."""
    traced = feel_traced
    axes = sorted({(c.axis, c.value) for c in
                   traced.out_contracts.values()}, key=str)
    assert axes == [(1, 0.0), (None, 0.0)]
    assert traced.premise == []
    report = taint.analyze_graph(traced.graph, traced.in_labels,
                                 traced.out_contracts,
                                 program=traced.program)
    assert report.ok, [f.detail for f in report.errors()]
    assert report.programs[traced.program]["n_certified_reductions"] >= 1


def test_feel_program_holds_one_stand_in_per_kernel_call(feel_traced):
    """Six leaves, one period: six SBC pairs, as on the card (B1/B2 six
    launches a period); no float64 value (the plain stats' float64 sums
    stay inside the stats node) and no 64-bit input."""
    graph = feel_traced.graph.graph
    counts = {k: sum(str(n.target) == f"repro_torch.{k}.default"
                     for n in graph.nodes) for k in ("sbc_stats",
                                                     "sbc_apply")}
    assert counts == {"sbc_stats": 6, "sbc_apply": 6}
    report = compile_audit.audit_graph_hygiene(feel_traced.graph,
                                               program="feel")
    summary = report.programs["feel/hygiene"]
    assert report.ok and summary["n_x64_leaks"] == 0
    assert summary["n_int64_intermediates"] > 0     # counts, not leaks


def test_induction_premise_flags_a_whole_horizon_read():
    gm = make_fx(lambda a, xs: (a + xs.sum(1)[:, None],),
                 tracing_mode="fake")(torch.zeros(2, 1), torch.zeros(2, 3))
    assert lowering._period_premise(gm, [False, True], 1)
    gm = make_fx(lambda a, xs: (a + xs[:, 0][:, None],),
                 tracing_mode="fake")(torch.zeros(2, 1), torch.zeros(2, 3))
    assert lowering._period_premise(gm, [False, True], 1) == []


def test_transformer_program_records_the_attention_backward(dataset):
    """make_fx records the backward kernels/ops.py's autograd Function
    runs: the dQ and dK/dV stand-ins are in the graph, and it certifies."""
    data, test = dataset
    bucket = lowering.group_rows([_spec(3, scheme="feel", hidden=16,
                                        depth=1,
                                        model_family="transformer")])[0]
    plan = lowering.plan_bucket(bucket, data, 1)
    traced = lowering.trace_bucket(plan, data, test)
    ops = [str(n.target) for n in traced.graph.graph.nodes]
    for kernel in ("flash_attention_fwd", "flash_attention_bwd_dq",
                   "flash_attention_bwd_dkdv"):
        assert f"repro_torch.{kernel}.default" in ops, kernel
    report = taint.analyze_graph(traced.graph, traced.in_labels,
                                 traced.out_contracts,
                                 program=traced.program)
    assert report.ok, [f.detail for f in report.errors()]


# ---------------------------------------------------------------------------
# compile hygiene
# ---------------------------------------------------------------------------


def test_trace_ledger_flags_retrace_and_count():
    ev = engine.TraceEvent("feel", (1, True), (("f32", (2, 3)),))
    ok = compile_audit.audit_traces([ev], label="t1", expect_total=1)
    assert ok.ok and ok.programs["t1"]["n_retraces"] == 0
    bad = compile_audit.audit_traces([ev, ev], label="t2")
    assert any(f.check == "compile.retrace" for f in bad.errors())
    miscount = compile_audit.audit_traces([ev], label="t3", expect_total=2)
    assert any(f.check == "compile.trace-count" for f in miscount.errors())


@pytest.mark.parametrize("fn,x,leaks", [
    (lambda x: x * 2.0, torch.zeros(3, dtype=torch.float64), 2),
    (lambda x: x + 1, torch.zeros(3, dtype=torch.int64), 1),
    (lambda x: x.double().sum().float(), torch.zeros(3), 2),
    (lambda x: x.long().sum(), torch.zeros(3), 0),
], ids=["f64-input", "i64-input", "f64-inside", "i64-inside"])
def test_hygiene_flags_64_bit_leaks(fn, x, leaks):
    """64-bit inputs and float64 values inside are leaks; int64
    intermediates (torch's index and count types) are counted only."""
    report = compile_audit.audit_graph_hygiene(
        make_fx(fn, tracing_mode="fake")(x), program="x64")
    summary = report.programs["x64/hygiene"]
    assert summary["n_x64_leaks"] == leaks and report.ok == (leaks == 0)
    assert leaks or summary["n_int64_intermediates"] == 2


def test_hygiene_flags_folded_constant():
    big = torch.zeros(5000)
    report = compile_audit.audit_graph_hygiene(
        make_fx(lambda x: x + big)(torch.zeros(())), program="folded")
    assert report.ok                               # WARN, not ERROR
    assert any(f.check == "compile.folded-constant"
               for f in report.warnings())


# ---------------------------------------------------------------------------
# determinism lint
# ---------------------------------------------------------------------------


def test_determinism_lint_on_the_port_sources():
    """The port's host planning passes with zero errors; its one PRNG
    seed-sharing group (the reference's) surfaces as an advisory WARN."""
    report = determinism.lint_sources()
    assert not report.errors(), [f.detail for f in report.errors()]
    assert report.programs["determinism-lint"]["ok"]
    assert any(f.check == "det.prng-stream-collision"
               for f in report.warnings())


def test_determinism_lint_catches_unseeded_cumsum(tmp_path):
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "bad.py").write_text(
        "import numpy as np\n"
        "def ledger(x, offset):\n"
        "    return np.cumsum(x) + offset\n")
    report = determinism.lint_sources(root=tmp_path / "pkg")
    assert any(f.check == "det.unseeded-cumsum" for f in report.errors())


# ---------------------------------------------------------------------------
# run(audit=True), the report surface, the dtype boundary
# ---------------------------------------------------------------------------


def test_run_audit_attaches_clean_report_and_runs_the_same_run(dataset):
    """run(audit=True) on a chunked closed-loop grid: Results.audit is a
    passing AuditReport whose scoped ledger proves zero retraces across
    chunks and replan rounds, and the run is bitwise the unaudited one."""
    data, test = dataset
    specs = [_spec(3, scheme="feel", seeds=(0, 1)),
             _spec(3, scheme="individual")]
    exp = Experiment(data, test, specs, device="cpu")
    res = exp.run(PERIODS, SerialExecutor(), 2, True)   # audit, positional
    report = res.audit
    assert isinstance(report, AuditReport) and report.ok
    ledger = report.programs["trace-ledger"]
    assert ledger["n_retraces"] == 0
    assert ledger["n_traces"] == ledger["n_unique_programs"]
    taint_progs = [p for p in report.programs.values()
                   if p["pass"] == "taint"]
    assert len(taint_progs) == 2 and all(p["ok"] for p in taint_progs)
    assert all(p["periods_traced"] == 1 for p in taint_progs)
    assert res.sel(scheme="individual").audit is report
    assert report.to_json()["programs"]["trace-ledger"]["n_retraces"] == 0
    plain = exp.run(PERIODS, executor=SerialExecutor(), replan=2)
    assert plain.audit is None
    for name in ("losses", "accs", "times", "global_batch"):
        np.testing.assert_array_equal(getattr(res, name),
                                      getattr(plain, name))


def test_audit_error_raises_with_findings():
    report = AuditReport()
    report.add("taint.unmasked-reduction", Severity.ERROR, "x", "boom")
    assert not report.ok
    with pytest.raises(AuditError):
        report.raise_on_error()
    f = report.findings[0]
    assert isinstance(f, Finding) and f.to_json()["severity"] == "error"


def test_host_to_device_casts_and_gate_rejects_x64():
    tree = {"a": np.arange(4, dtype=np.float64),
            "b": np.arange(4, dtype=np.int64),
            "c": np.ones(2, dtype=np.bool_)}
    cast = engine.host_to_device(tree, "cpu")
    assert cast["a"].dtype == torch.float32
    assert cast["b"].dtype == torch.int32
    assert cast["c"].dtype == torch.bool
    engine.assert_device_safe(cast, "test")       # casts pass the gate
    for bad in (np.zeros(3, np.float64), torch.zeros(3, dtype=torch.int64)):
        with pytest.raises(TypeError, match="64"):
            engine.assert_device_safe({"x": bad}, "test")


# ---------------------------------------------------------------------------
# the numeric check: garbage on padded lanes moves no active value
# ---------------------------------------------------------------------------

BIG = 1e3


def _garbage_schedule(s, k):
    """Large finite values on a schedule's padded users (index in range)."""
    idx, weight, batch = s.idx.copy(), s.weight.copy(), s.batch.copy()
    idx[:, k:] = (np.arange(idx[:, k:].size).reshape(idx[:, k:].shape)
                  * 7) % 200
    weight[:, k:] = BIG
    batch[:, k:] = BIG
    return dataclasses.replace(s, idx=idx, weight=weight, batch=batch)


@pytest.mark.parametrize("scheme", ["feel", "individual"])
def test_garbage_on_padded_lanes_moves_no_active_value(dataset, scheme):
    """A K 4 row padded to 8 beside a K 8 row: its losses, parameters (a
    dev row's active devices') and SBC residuals (active users') are
    bitwise those of the run with zeros on the padded lanes, and its
    padded residual lanes stay exactly 0 (the output contract)."""
    data, test = dataset
    bucket = lowering.group_rows([_spec(4, scheme=scheme),
                                  _spec(8, scheme=scheme)])[0]
    assert bucket.k_pad == 8 and len(bucket.rows) == 2
    plan = lowering.plan_bucket(bucket, data, PERIODS)
    arrays = lowering.DeviceData(data, test, "cpu")
    if scheme == "feel":
        dirty = dataclasses.replace(plan, schedules=[
            _garbage_schedule(plan.schedules[0], 4), plan.schedules[1]])
        state = None
    else:
        idx = plan.idx.copy()
        idx[0, :, 4:] = 123
        dirty = dataclasses.replace(plan, idx=idx)
        params = lowering._init_params_batch(bucket.rows, DIM, "cpu")
        dev = lowering._broadcast_rows(params, 8)
        for leaf in tree_leaves(dev):
            leaf[0, 4:] = BIG
        state = (engine.EngineState(dev),)      # one shard's carry
    clean = lowering.dispatch_bucket(plan, arrays)
    moved = lowering.dispatch_bucket(dirty, arrays, state=state)
    # one device: one shard of both rows
    np.testing.assert_array_equal(clean.losses[0][0].numpy(),
                                  moved.losses[0][0].numpy())
    np.testing.assert_array_equal(clean.accs[0][0].numpy(),
                                  moved.accs[0][0].numpy())
    lanes = slice(None) if scheme == "feel" else slice(0, 4)
    for a, b in zip(tree_leaves(clean.state[0].params),
                    tree_leaves(moved.state[0].params)):
        np.testing.assert_array_equal(a[0][lanes].numpy(),
                                      b[0][lanes].numpy())
    if scheme == "feel":
        for a, b in zip(tree_leaves(clean.state[0].residual),
                        tree_leaves(moved.state[0].residual)):
            np.testing.assert_array_equal(a[0, :4].numpy(),
                                          b[0, :4].numpy())
            assert not b[0, 4:].any()
