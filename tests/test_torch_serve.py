"""The port's experiment service and its dispatch ledger, against the
reference's ``repro.serve`` and trace ledger on the same inputs.

* The ledger: a two-bucket grid (one FEEL, one dev) through both
  packages' ``Experiment`` records the same number of events with the
  same ``(kind, key)`` sequence, monolithic and chunked; a warm re-run
  records none; ``program_key``s are equal as tuples.
* Every test of the reference's ``tests/test_serve.py`` except its audit
  one, as a port counterpart (``audit=True`` raises here: the analysis
  package is not ported).
* One seeded Poisson tape on a virtual clock advanced by fixed steps
  through both services, with the reference's weights carried across:
  ``stats.to_dict()`` equal, each ticket's ledgers bitwise, losses within
  1e-4 (SBC on; see ``tests/test_torch_experiment.py`` for why 1e-4).
* The warm contract over every form a program key must cover: feature
  and token data, the dev and hierarchical loops, padded K, a ragged last
  chunk, an uncompressed bucket at another ratio.

Shapes (dim 21 / 23, hidden 20, b_max 11 / 9) are this module's alone,
so the engines' program caches of both packages start cold here."""
import jax
import numpy as np
import pytest

import repro.api as ref_api
import repro.serve as ref_serve
from repro.api import lowering as ref_lowering
from repro.core import DeviceProfile as RefDevice
from repro.data.pipeline import ClassificationData as RefData
from repro.fed import engine as ref_engine
from repro.fed import feel_model as ref_model
from repro.testing import VirtualClock as RefClock
from repro.testing import burst_arrivals as ref_burst
from repro.testing import poisson_arrivals as ref_poisson

from repro_torch.api import (Experiment, ScenarioSpec, SerialExecutor,
                             Topology, lowering)
from repro_torch.core.latency import DeviceProfile
from repro_torch.data.pipeline import ClassificationData
from repro_torch.dynamics import TauAdapt
from repro_torch.fed import engine
from repro_torch.interop import params_from_numpy
from repro_torch.serve import (AdmissionQueue, ExperimentService,
                               PendingRequest, ProgramCache)
from repro_torch.testing import (VirtualClock, WallClock, assign_templates,
                                 burst_arrivals, no_retrace, poisson_arrivals)

DIM, HIDDEN, BMAX = 21, 20, 11
PERIODS = 4
CHUNK = 2
TIERS = (0.7e9, 1.4e9, 2.1e9)


def _fleet(DP, k=3):
    return tuple(DP(kind="cpu", f_cpu=TIERS[i % 3]) for i in range(k))


@pytest.fixture(scope="module")
def dataset():
    return ClassificationData.synthetic(n=320, dim=DIM, seed=0,
                                        spread=6.0).split(64)


@pytest.fixture(scope="module")
def ref_dataset():
    return RefData.synthetic(n=320, dim=DIM, seed=0, spread=6.0).split(64)


@pytest.fixture(scope="module")
def fleet():
    return _fleet(DeviceProfile)


def _spec(fleet, **kw):
    kw.setdefault("name", "srv3")
    kw.setdefault("b_max", BMAX)
    kw.setdefault("base_lr", 0.15)
    kw.setdefault("hidden", HIDDEN)
    return ScenarioSpec(fleet=fleet, **kw)


def _service(data, test, **kw):
    """A deterministic service on the CPU: virtual clock + isolated cache
    index, so every test's hit/miss counters start from zero."""
    kw.setdefault("device", "cpu")
    kw.setdefault("chunk_periods", CHUNK)
    kw.setdefault("clock", VirtualClock())
    kw.setdefault("cache", ProgramCache(shared=False))
    return ExperimentService(data, test, **kw)


def _twin(data, test, specs, periods, chunk=CHUNK):
    return Experiment(data, test, specs, device="cpu").run(
        periods, executor=SerialExecutor(chunk_periods=chunk))


def _assert_bitwise(a, b):
    np.testing.assert_array_equal(a.losses, b.losses)
    np.testing.assert_array_equal(a.accs, b.accs)
    np.testing.assert_array_equal(a.times, b.times)
    np.testing.assert_array_equal(a.global_batch, b.global_batch)


def _reference_init(rows, input_dim, device):
    per_row = [ref_model.init(jax.random.key(r.seed), r.spec.hidden,
                              depth=r.spec.depth, input_dim=input_dim)
               for r in rows]
    stacked = jax.tree_util.tree_map(
        lambda *a: np.stack([np.asarray(x) for x in a]), *per_row)
    return params_from_numpy(stacked, device)


# ---------------------------------------------------------------------------
# the dispatch ledger against the reference's trace ledger
# ---------------------------------------------------------------------------


def test_ledger_matches_the_reference_trace_ledger():
    """A FEEL and a dev bucket: the same events in the same order, cold,
    chunked and warm; program keys equal as tuples."""
    kw = dict(name="led", b_max=9, hidden=HIDDEN, base_lr=0.1, seeds=(0, 1))
    data, test = ClassificationData.synthetic(n=300, dim=23, seed=1,
                                              spread=6.0).split(60)
    rdata, rtest = RefData.synthetic(n=300, dim=23, seed=1,
                                     spread=6.0).split(60)
    specs = [ScenarioSpec(fleet=_fleet(DeviceProfile), **kw),
             ScenarioSpec(fleet=_fleet(DeviceProfile), scheme="individual",
                          **kw)]
    ref_specs = [ref_api.ScenarioSpec(fleet=_fleet(RefDevice), **kw),
                 ref_api.ScenarioSpec(fleet=_fleet(RefDevice),
                                      scheme="individual", **kw)]
    for b, rb in zip(lowering.group_rows(specs),
                     ref_lowering.group_rows(ref_specs)):
        assert (lowering.bucket_program_keys(b, 2, 5, 2, data, test)
                == ref_lowering.bucket_program_keys(rb, 2, 5, 2, rdata,
                                                    rtest))

    def events(run, ledger):
        mark = len(ledger.trace_events())
        run()
        return [(e.kind, e.key) for e in ledger.trace_events()[mark:]]

    exp = Experiment(data, test, specs, device="cpu")
    ref = ref_api.Experiment(rdata, rtest, ref_specs)
    # monolithic: one event a bucket; 2-period chunks over 4 periods add
    # each bucket's 2-period signature once
    for chunk in (None, 2):
        got = events(lambda: exp.run(4, executor=SerialExecutor(
            chunk_periods=chunk)), engine)
        want = events(lambda: ref.run(4, executor=ref_api.SerialExecutor(
            chunk_periods=chunk)), ref_engine)
        assert got == want
        assert [kind for kind, _ in got] == ["feel", "dev"]
        with no_retrace():                       # warm: nothing new
            exp.run(4, executor=SerialExecutor(chunk_periods=chunk))


def test_suspended_dispatch_records_nothing_and_stays_cold():
    """Under ``suspend_trace_count`` a program runs without recording and
    without marking its signature seen: the next dispatch records it.
    Shapes (dim 25, b_max 5) are this test's alone."""
    data, test = ClassificationData.synthetic(n=120, dim=25, seed=4,
                                              spread=6.0).split(30)
    exp = Experiment(data, test, [ScenarioSpec(
        fleet=_fleet(DeviceProfile), hidden=HIDDEN, b_max=5, seeds=(0,))],
        device="cpu")
    with engine.suspend_trace_count(), no_retrace():
        suspended = exp.run(2)
    with no_retrace(expect=1):
        _assert_bitwise(exp.run(2), suspended)
    with no_retrace():
        exp.run(2)


# ---------------------------------------------------------------------------
# deterministic fixtures: clocks + seeded arrival processes
# ---------------------------------------------------------------------------


def test_virtual_clock_and_arrival_fixtures():
    t1 = poisson_arrivals(4.0, 20, seed=3, start=0.5)
    np.testing.assert_array_equal(t1, poisson_arrivals(4.0, 20, seed=3,
                                                       start=0.5))
    np.testing.assert_array_equal(t1, ref_poisson(4.0, 20, seed=3,
                                                  start=0.5))
    assert not np.array_equal(t1, poisson_arrivals(4.0, 20, seed=4,
                                                   start=0.5))
    assert len(t1) == 20 and t1[0] > 0.5 and np.all(np.diff(t1) > 0)
    with pytest.raises(ValueError, match="rate"):
        poisson_arrivals(0.0, 5, seed=0)

    b = burst_arrivals(bursts=3, size=4, spacing=2.0, intra=0.01, seed=1)
    assert len(b) == 12 and np.all(np.diff(b) >= 0)
    assert b[4] - b[3] > 1.0                  # inter-burst gap dominates
    np.testing.assert_array_equal(
        b, ref_burst(bursts=3, size=4, spacing=2.0, intra=0.01, seed=1))

    tape = assign_templates(np.array([0.1, 0.2, 0.3]), ["x", "y"])
    assert [t for _, t in tape] == ["x", "y", "x"]     # round-robin

    clk = VirtualClock(start=1.0)
    assert clk.advance(0.5) == 1.5
    assert clk.advance_to(1.2) == 1.5         # never moves backwards
    assert clk.advance_to(3.0) == 3.0
    with pytest.raises(ValueError, match="negative"):
        clk.advance(-0.1)
    assert WallClock().now() >= 0.0


# ---------------------------------------------------------------------------
# the online bucketer (pure host logic — no device work)
# ---------------------------------------------------------------------------


def _req(spec, periods, t, seq, priority=0, deadline=None):
    return PendingRequest(ticket=None, spec=spec, periods=periods,
                          priority=priority, submitted_at=t, seq=seq,
                          deadline=deadline)


def test_admission_queue_windows_merge_and_slice(fleet):
    a = _spec(fleet, partition="iid", seeds=(0,))
    b = _spec(fleet, partition="noniid", base_lr=0.3, seeds=(1,))
    c = _spec(fleet, b_max=BMAX - 4, seeds=(0,))
    q = AdmissionQueue(window=1.0)
    q.push(_req(a, 4, 0.0, 0))
    q.push(_req(b, 4, 0.2, 1))                # non-structural diffs merge
    q.push(_req(c, 4, 0.1, 2))                # b_max splits
    q.push(_req(a, 6, 0.3, 3))                # horizon splits
    assert q.pending == 4
    assert q.pop_due(0.5) == []               # everyone inside the window
    assert q.next_due_at() == 1.0
    assert [[r.seq for r in g] for g in q.pop_due(1.05)] == [[0, 1]]
    assert [[r.seq for r in g] for g in q.pop_due(5.0)] == [[2], [3]]
    assert q.pending == 0 and q.next_due_at() is None

    # max_batch bounds the micro-batch SIZE: an oversize group slices
    # into full batches; the remainder keeps waiting for its window
    q = AdmissionQueue(window=10.0, max_batch=2)
    for s in range(5):
        q.push(_req(a, 4, float(s), s))
    assert [[r.seq for r in g]
            for g in q.pop_due(4.5)] == [[0, 1], [2, 3]]
    assert q.pending == 1
    assert q.pop_due(4.6) == []               # remainder not window-due
    assert [[r.seq for r in g]
            for g in q.pop_due(0.0, flush=True)] == [[4]]

    with pytest.raises(ValueError, match="window"):
        AdmissionQueue(window=-0.5)
    with pytest.raises(ValueError, match="max_batch"):
        AdmissionQueue(max_batch=0)


def test_admission_deadline_slack_ordering(fleet):
    a = _spec(fleet, seeds=(0,))
    b = _spec(fleet, b_max=BMAX - 4, seeds=(0,))
    c = _spec(fleet, b_max=BMAX - 6, seeds=(0,))
    q = AdmissionQueue(window=0.0)
    q.push(_req(a, 4, 0.0, 0))                      # no deadline (FIFO)
    q.push(_req(b, 4, 0.1, 1, deadline=5.0))
    q.push(_req(c, 4, 0.2, 2, deadline=2.0))        # tightest → first
    assert [[r.seq for r in g] for g in q.pop_due(1.0)] == [[2], [1], [0]]

    q = AdmissionQueue(window=1.0)
    q.push(_req(a, 4, 0.0, 0))
    q.push(_req(b, 4, 0.0, 1))
    q.push(_req(a, 4, 0.5, 2, deadline=1.5))        # merges with seq 0
    assert [[r.seq for r in g]
            for g in q.pop_due(1.1)] == [[0, 2], [1]]

    q = AdmissionQueue(window=0.0)
    q.push(_req(b, 4, 0.0, 0))
    q.push(_req(a, 4, 0.1, 1))
    assert [[r.seq for r in g] for g in q.pop_due(1.0)] == [[0], [1]]
    assert PendingRequest(ticket=None, spec=a, periods=4, priority=0,
                          submitted_at=0.0, seq=0).slack(99.0) == \
        float("inf")


def test_program_keys_and_chunk_lengths(dataset, ref_dataset, fleet):
    assert lowering.chunk_lengths(7, 3) == (3, 3, 1)
    assert lowering.chunk_lengths(4, None) == (4,)
    assert lowering.chunk_lengths(4, 9) == (4,)
    data, test = dataset
    b = lowering.group_rows([_spec(fleet, seeds=(0, 1))])[0]
    keys = lowering.bucket_program_keys(b, 2, 7, 3, data, test)
    assert len(keys) == 2                     # distinct chunk lengths 3, 1
    keys44 = lowering.bucket_program_keys(b, 2, 4, 2, data, test)
    assert len(keys44) == 1
    b2 = lowering.group_rows([_spec(fleet, partition="iid", base_lr=0.3,
                                    seeds=(5, 6))])[0]
    assert lowering.bucket_program_keys(b2, 2, 4, 2, data, test) == keys44
    assert lowering.bucket_program_keys(b, 3, 4, 2, data, test) != keys44
    # the reference's keys, as tuples
    rdata, rtest = ref_dataset
    rb = ref_lowering.group_rows([ref_api.ScenarioSpec(
        fleet=_fleet(RefDevice), name="srv3", b_max=BMAX, base_lr=0.15,
        hidden=HIDDEN, seeds=(0, 1))])[0]
    assert keys == ref_lowering.bucket_program_keys(rb, 2, 7, 3, rdata,
                                                    rtest)


def test_program_cache_index_scopes(tmp_path):
    ProgramCache.clear_shared()
    k1, k2 = ("tsrv-fake", 1), ("tsrv-fake", 2)
    a, b = ProgramCache(), ProgramCache()
    assert a.admit([k1, k2]) == (0, 2)
    assert b.admit([k1]) == (1, 0)            # process-shared registry
    assert b.use_count(k1) == 2 and k2 in b and len(b) == 2
    iso = ProgramCache(shared=False)
    assert iso.admit([k1]) == (0, 1)          # isolated index
    assert len(iso) == 1 and a.use_count(k1) == 2
    ProgramCache.clear_shared()
    assert a.admit([k1]) == (0, 1)
    ProgramCache.clear_shared()
    # no executables to persist: the disk scope is refused, the registry
    # stays process-scoped and nothing is written
    assert ProgramCache._enable_disk_cache(str(tmp_path)) is False
    assert len(ProgramCache(shared=False, persist_dir=str(tmp_path))) == 0
    assert list(tmp_path.iterdir()) == []


# ---------------------------------------------------------------------------
# the service: streaming, warm admissions, preemption, fan-out
# ---------------------------------------------------------------------------


def test_service_streams_chunks_bit_identical_to_experiment(dataset,
                                                            fleet):
    data, test = dataset
    spec = _spec(fleet, partition="noniid", seeds=(0, 1))
    svc = _service(data, test)
    t = svc.submit(spec, periods=PERIODS)
    assert not t.admitted and not t.done
    with pytest.raises(RuntimeError, match="not complete"):
        t.result()
    growth = []
    while not t.done:
        assert svc.step()                     # work available every turn
        part = t.partial()
        assert part.complete == t.done
        growth.append(part.losses.shape[1])
        if not t.done:                        # valid-but-absent selects
            assert part.sel(scheme="individual").rows == 0
    assert growth == [CHUNK, PERIODS]         # one chunk per step
    assert t.admitted and svc.idle
    assert svc.stats.admissions == 1 and svc.stats.completed == 1
    assert svc.stats.chunks == PERIODS // CHUNK

    res = t.result()
    assert res.complete and res.rows == 2
    _assert_bitwise(res, _twin(data, test, [spec], PERIODS))
    with pytest.raises(ValueError, match="matches no row"):
        res.sel(scheme="no-such-scheme")


def test_warm_admission_records_zero_traces(dataset, fleet):
    data, test = dataset
    svc = _service(data, test)
    t0 = svc.submit(_spec(fleet, partition="noniid", seeds=(0, 1)),
                    periods=PERIODS)
    svc.drain()
    assert t0.done
    assert svc.stats.cold_admissions == 1 and svc.stats.cache_misses == 1

    warm_spec = _spec(fleet, name="w2", partition="iid", base_lr=0.05,
                      seeds=(5, 6))
    with no_retrace():
        t1 = svc.submit(warm_spec, periods=PERIODS)
        svc.drain()
    assert t1.done
    assert svc.stats.warm_admissions == 1 and svc.stats.cache_hits == 1
    assert svc.stats.warm_admission_traces == 0
    assert t1.result().rows == 2


def test_preempt_park_resume_bit_identity(dataset, fleet):
    data, test = dataset
    svc = _service(data, test)
    long_spec = _spec(fleet, partition="iid", seeds=(0,))
    t_long = svc.submit(long_spec, periods=6, priority=5)
    assert svc.step()                         # admit + run first chunk
    assert t_long.collected == CHUNK and not t_long.done

    hot_spec = _spec(fleet, partition="noniid", base_lr=0.2, seeds=(1,))
    t_hot = svc.submit(hot_spec, periods=PERIODS, priority=0)
    svc.drain()
    assert t_long.done and t_hot.done
    assert svc.stats.preemptions == 1 and svc.stats.resumes == 1
    assert svc.stats.warm_admissions == 1
    assert svc.stats.warm_admission_traces == 0
    _assert_bitwise(t_long.result(), _twin(data, test, [long_spec], 6))
    _assert_bitwise(t_hot.result(), _twin(data, test, [hot_spec], PERIODS))


def test_out_of_order_completion_partial_views(dataset, fleet):
    data, test = dataset
    svc = _service(data, test)
    slow = _spec(fleet, partition="iid", seeds=(0,))
    fast = _spec(fleet, scheme="individual", seeds=(0,))
    t_slow = svc.submit(slow, periods=6, priority=1)
    t_fast = svc.submit(fast, periods=PERIODS, priority=0)
    while not t_fast.done:
        svc.step()
    assert not t_slow.done                    # earlier ticket still going
    part = t_slow.partial()
    assert not part.complete
    assert part.sel(scheme="individual").rows == 0    # empty, no raise
    assert part.sel(partition="iid").rows == 1
    assert t_fast.result().sel(scheme="individual").rows == 1
    svc.drain()
    assert t_slow.done
    _assert_bitwise(t_slow.result(), _twin(data, test, [slow], 6))


def test_window_batches_duplicates_onto_shared_rows(dataset, fleet):
    data, test = dataset
    clock = VirtualClock()
    svc = _service(data, test, window=1.0, clock=clock)
    spec = _spec(fleet, partition="noniid", seeds=(0, 1))
    t1 = svc.submit(spec, periods=PERIODS)
    t2 = svc.submit(spec, periods=PERIODS)
    assert not svc.step()                     # window holds both back
    assert not t1.admitted
    assert svc.next_admission_at() == 1.0
    clock.advance_to(1.0)
    assert svc.step()                         # window expired: one batch
    assert t1.admitted and t2.admitted
    svc.drain()
    assert svc.stats.admissions == 1 and svc.stats.admitted_requests == 2
    _assert_bitwise(t1.result(), t2.result())


def test_closed_loop_replan_through_service(dataset, fleet):
    data, test = dataset
    spec = _spec(fleet, partition="iid", replan=2, seeds=(0,))
    svc = _service(data, test, chunk_periods=3)   # replan must win
    t = svc.submit(spec, periods=PERIODS)
    svc.drain()
    assert t.done and t.collected == PERIODS
    _assert_bitwise(t.result(),
                    Experiment(data, test, [spec], device="cpu").run(
                        PERIODS))


def test_submit_and_construction_validation(dataset, fleet, monkeypatch):
    data, test = dataset
    svc = _service(data, test)
    with pytest.raises(TypeError, match="ScenarioSpec"):
        svc.submit("not-a-spec", periods=3)
    with pytest.raises(ValueError, match="periods"):
        svc.submit(_spec(fleet), periods=0)
    with pytest.raises(ValueError, match="adapt_tau"):
        svc.submit(_spec(fleet, replan=2,
                         adapt_tau=TauAdapt(choices=(1, 2))), periods=3)
    with pytest.raises(ValueError, match="chunk_periods"):
        _service(data, test, chunk_periods=0)
    with pytest.raises(ValueError, match="window"):
        _service(data, test, window=-0.1)
    with pytest.raises(ValueError, match="max_batch"):
        _service(data, test, max_batch=0)
    # the analysis package is not ported: the flag raises, never skips
    with pytest.raises(NotImplementedError, match="Queue A item 10"):
        _service(data, test, audit=True)
    # a mesh must be one device, the service's own
    from repro_torch.launch.mesh import make_batch_mesh
    assert _service(data, test,
                    mesh=make_batch_mesh(device="cpu")).mesh is not None
    # the GPU by default, raising without one
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExperimentService(data, test)


# ---------------------------------------------------------------------------
# a seeded arrival tape through both services
# ---------------------------------------------------------------------------


def _drive_tape(svc, clock, tape, step_s):
    """Submit each arrival when the clock passes it, one service step per
    fixed clock step, then drain; returns the tickets in tape order."""
    tickets, pending = [], list(tape)
    while pending or not svc.idle:
        clock.advance(step_s)
        while pending and pending[0][0] <= clock.now():
            _, (spec, periods, prio) = pending.pop(0)
            tickets.append(svc.submit(spec, periods=periods, priority=prio))
        svc.step()
    return tickets


def test_poisson_tape_matches_the_reference_service(monkeypatch):
    """Two hot templates and a long background request on a Poisson tape
    (rate 4/s, seed 7), a fixed 0.1 s step: equal stats, bitwise
    ledgers, losses within 1e-4."""
    monkeypatch.setattr(lowering, "_init_params_batch", _reference_init)
    data, test = ClassificationData.synthetic(
        n=360, dim=DIM, seed=2, spread=6.0).split(60)
    rdata, rtest = RefData.synthetic(n=360, dim=DIM, seed=2,
                                     spread=6.0).split(60)
    kw = dict(name="tape", b_max=BMAX, hidden=HIDDEN, base_lr=0.1,
              compression=0.05)

    def templates(SS, DP):
        hot = [(SS(fleet=_fleet(DP), partition="noniid", seeds=(0, 1), **kw),
                PERIODS, 0),
               (SS(fleet=_fleet(DP), partition="iid", seeds=(2, 3), **kw),
                PERIODS, 0)]
        return hot, (SS(fleet=_fleet(DP), partition="iid", seeds=(4,),
                        **kw), 3 * PERIODS, 5)

    times = poisson_arrivals(4.0, 6, seed=7)
    out = {}
    for pkg, (SS, DP, Svc, Cache, Clock, extra) in {
            "port": (ScenarioSpec, DeviceProfile, ExperimentService,
                     ProgramCache, VirtualClock, dict(device="cpu")),
            "ref": (ref_api.ScenarioSpec, RefDevice,
                    ref_serve.ExperimentService, ref_serve.ProgramCache,
                    RefClock, {})}.items():
        hot, background = templates(SS, DP)
        tape = [(0.0, background)] + assign_templates(times, hot)
        clock = Clock()
        svc = Svc(data if pkg == "port" else rdata,
                  test if pkg == "port" else rtest, chunk_periods=CHUNK,
                  window=0.3, max_batch=2, clock=clock,
                  cache=Cache(shared=False), **extra)
        out[pkg] = (svc, _drive_tape(svc, clock, tape, 0.1))
    (svc, tickets), (ref_svc, ref_tickets) = out["port"], out["ref"]
    stats, ref_stats = svc.stats.to_dict(), ref_svc.stats.to_dict()
    assert stats == ref_stats
    assert stats["completed"] == 7 and stats["preemptions"] >= 1
    assert stats["warm_admission_traces"] == 0
    err = 0.0
    for t, rt in zip(tickets, ref_tickets):
        got, want = t.result(), rt.result()
        np.testing.assert_array_equal(got.times, want.times)
        np.testing.assert_array_equal(got.global_batch, want.global_batch)
        np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got.accs, want.accs, rtol=1e-4,
                                   atol=1e-4)
        err = max(err, float(np.abs(got.losses - want.losses).max()))
    print(f"PARITY ExperimentService Poisson tape: stats equal "
          f"({stats['admissions']} admissions, {stats['chunks']} chunks, "
          f"{stats['new_traces']} events), losses max_abs_err={err:.3g} "
          f"tol=1e-4")


# ---------------------------------------------------------------------------
# the warm contract over every form a program key must cover
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["features", "tokens", "dev", "hier",
                                  "padded", "ragged", "uncompressed"])
def test_warm_admission_of_every_form_records_nothing(dataset, fleet, form):
    """A cold admission, then a structural twin differing in every value
    the key leaves out: the twin is warm and records no event."""
    data, test = dataset
    big = _fleet(DeviceProfile, 4)
    periods, chunk = PERIODS, CHUNK
    cold = dict(features=dict(), tokens=dict(model_family="transformer",
                                             hidden=16, depth=1),
                dev=dict(scheme="model_fl"),
                hier=dict(topology=Topology(cells=2, edges=2, agg_every=2)),
                padded=dict(), ragged=dict(),
                uncompressed=dict(compress=False, compression=0.02))[form]
    warm = dict(cold, partition="iid", base_lr=0.07, seeds=(7, 8))
    if form == "uncompressed":
        warm["compression"] = 0.3
    if form == "ragged":
        periods, chunk = 5, 2
    svc = _service(data, test, window=1.0, chunk_periods=chunk,
                   clock=VirtualClock())
    first = [_spec(fleet, seeds=(0, 1), **cold)]
    second = [_spec(fleet, **warm)]
    if form == "padded":                 # K 3 and 4 share a padded bucket
        first.append(_spec(big, name="k4", seeds=(0, 1)))
        second.append(_spec(big, name="k4", partition="iid", seeds=(3, 9)))
    for spec in first:
        svc.submit(spec, periods=periods)
    svc.drain()
    assert svc.stats.cold_admissions == 1
    with no_retrace():
        tickets = [svc.submit(spec, periods=periods) for spec in second]
        svc.drain()
    assert svc.stats.warm_admissions == 1
    assert svc.stats.warm_admission_traces == 0
    assert all(t.done for t in tickets)
