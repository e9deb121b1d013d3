"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without an NVIDIA GPU these tests skip (a CUDA kernel
has no CPU mode).  On the card:

    python -m pytest -m cuda tests/test_torch_cuda.py

``sbc_apply`` must equal its plain version bitwise; ``sbc_stats`` counts
must be equal and its sums agree to rtol 1e-6 (both accumulate in
float64, in different orders); ``compress_dense`` on the card must keep
the same survivors as the CPU path and agree with it to 2e-5; a chunked
``Experiment.run`` on the card must equal the monolithic one bitwise.
The flash-attention forward must agree with its plain version to 2e-5
(bf16: 2e-2; lse 2e-5) and the backward pair to 1e-4, against the plain
backward and autograd of the oracle, also at the forward's seams (S
around its 16-key tiles, windows around them, g 1, 2 and 4, hd 32, 64
and 128); the forward and the backward are bitwise reproducible, the
forward is batch-invariant at the cell's shape, none of its six
instances spills; the dQ kernel holds dq and D to 1e-4 of its plain
version at the cases, at all 450 combinations of the seams and at groups
of 40 heads a KV head, bitwise the same run twice and batch-invariant at
the cell's shape, and none of its three instances spills; the dK/dV
kernel holds the same tolerance at every seam and at groups of 40 heads a
KV head, is bitwise the same run twice and batch-invariant at the cell's
shape, and none of its three instances spills; the wrappers raise on what
the kernels do not take (a forward, dQ or dK/dV input off a 16-byte
boundary too).  The SSD forward must
agree with its plain version to 2e-5 (bf16: 2e-2) and the backward to
1e-4 — against the plain version run in float64 everywhere, and against
the float32 plain version wherever that is itself within half the
tolerance of the float64 value, also at the backward's seams (one
segment, ragged segments, G 4 at the admitted widths, unaligned rows)
and, for the forward, at its own (S around its 16-token tiles, P wider
than a unit, P 3, N 128); the forward is bitwise reproducible and
batch-invariant, and none of its instances spills (3 CTAs an SM at the
cell's shape); the backward is bitwise reproducible, a copy's gradients
are bitwise the same alone and among 8, and its kernel spills nothing
and keeps 32 warps resident an SM at the cell's shape; a mamba2
``Experiment.run`` on the card matches the CPU path.  The
flash-decode kernel must agree with its plain version to 2e-5 (bf16:
2e-2) at every pos, window and group size it takes, bitwise from run to
run, also at the runs' seams (pos 31, 32, 33 and runs left empty);
one call puts one kernel on the card and allocates nothing but its
output, and no instance spills; the decode driver on the card matches
its CPU path (1e-4 in log-softmax) and runs every attention layer
through the kernel.  ``AsyncExecutor`` (capped or not, chunked or not)
and ``MeshExecutor`` on the card equal ``SerialExecutor`` bitwise on a
two-bucket grid, launching the SBC pair as often, and a planning error
stops the run and reaches the caller.  The reduced qwen1.5-4b train step
through the three attention kernels matches the naive step (1e-4), and
``sbc_uplink`` on one leaf of 2^27 elements matches the plain versions
(keep masks equal, values rtol 1e-6)."""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.api import (AsyncExecutor, Experiment, MeshExecutor,
                             ScenarioSpec, SerialExecutor, grid)
from repro_torch.api import lowering
from repro_torch.compression import sbc as csbc
from repro_torch.core.latency import DeviceProfile
from repro_torch.data.pipeline import ClassificationData
from repro_torch.kernels import sbc as ksbc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("segments,n", [(192, 10), (192, 256), (7, 1001),
                                        (3, 8192), (2, 8193), (192, 65_536),
                                        (5, 786_432)])
def test_kernels_match_plain_versions(cuda, segments, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((segments, n), generator=gen, device=cuda)
    x[0] = 0.0
    if segments > 2:
        x[1, ::3] = 0.5
        x[1, 1::3] = -0.5
    thr = csbc.topk_threshold_bisect(x.abs(), csbc.n_keep(n, 0.005))
    thr[1] = 0.5 if segments > 2 else thr[1]
    before = (ksbc.sbc_stats.launches, ksbc.sbc_apply.launches)
    got = ksbc.sbc_stats(x, thr)
    want = ksbc.sbc_stats_plain(x, thr)
    assert torch.equal(got[:, 2:], want[:, 2:])
    torch.testing.assert_close(got[:, :2], want[:, :2], rtol=1e-6, atol=0)
    scalars = csbc.group_scalars(thr, want)
    out, res = ksbc.sbc_apply(x, scalars)
    pout, pres = ksbc.sbc_apply_plain(x, scalars)
    assert torch.equal(out, pout) and torch.equal(res, pres)
    assert (ksbc.sbc_stats.launches, ksbc.sbc_apply.launches) == (
        before[0] + 1, before[1] + 1)


def test_unaligned_rows_take_the_scalar_path(cuda):
    x = torch.randn(3 * 1000 + 1, device=cuda)[1:].reshape(3, 1000)
    thr = torch.full((3,), 1.0, device=cuda)
    torch.testing.assert_close(ksbc.sbc_stats(x, thr),
                               ksbc.sbc_stats_plain(x, thr), rtol=1e-6,
                               atol=0)
    sc = torch.stack([thr, thr, -thr], -1)
    for a, b in zip(ksbc.sbc_apply(x, sc), ksbc.sbc_apply_plain(x, sc)):
        assert torch.equal(a, b)


def test_stats_are_bitwise_reproducible(cuda):
    x = torch.randn((64, 100_000), device=cuda)
    thr = torch.full((64,), 2.0, device=cuda)
    assert torch.equal(ksbc.sbc_stats(x, thr), ksbc.sbc_stats(x, thr))


def test_compress_dense_on_the_card_matches_the_cpu_path(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    shapes = [(3072, 64), (64,), (64, 10), (10,)]
    grads = [{"w": torch.randn((2, 3) + shapes[i], generator=gen,
                               device=cuda),
              "b": torch.randn((2, 3) + shapes[i + 1], generator=gen,
                               device=cuda)} for i in (0, 2)]
    resid = [{k: 0.1 * torch.randn_like(v) for k, v in l.items()}
             for l in grads]
    approx, new_res = csbc.compress_dense(grads, 0.005, resid, batch_dims=2)
    cpu = lambda t: [{k: v.cpu() for k, v in l.items()} for l in t]  # noqa
    p_approx, p_res = csbc.compress_dense(cpu(grads), 0.005, cpu(resid),
                                          batch_dims=2)
    for a, b, r, pr in zip(approx, p_approx, new_res, p_res):
        for k in a:
            assert torch.equal(a[k].cpu() != 0, b[k] != 0)
            torch.testing.assert_close(a[k].cpu(), b[k], rtol=2e-5,
                                       atol=2e-5)
            torch.testing.assert_close(r[k].cpu(), pr[k], rtol=2e-5,
                                       atol=2e-5)


def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    x = torch.randn((2, 16), device=cuda)
    with pytest.raises(ValueError):
        ksbc.sbc_stats(x, torch.zeros(2))          # threshold on the CPU
    with pytest.raises(ValueError):
        ksbc.sbc_apply(x[:, ::2], torch.zeros((2, 3), device=cuda))


def test_chunked_run_equals_monolithic_bitwise_on_the_card(cuda):
    data, test = ClassificationData.synthetic(n=600, dim=64,
                                              spread=6.0).split(100)
    fleet = tuple(DeviceProfile(kind="cpu", f_cpu=f * 1e9)
                  for f in (0.7, 1.4, 2.1, 0.7))
    specs = [ScenarioSpec(fleet=fleet[:k], partition=p, hidden=32, b_max=16,
                          compression=0.05, seeds=(0, 1))
             for k in (3, 4) for p in ("iid", "noniid")]
    before = ksbc.sbc_stats.launches
    mono = Experiment(data, test, specs, device=cuda).run(4)
    assert ksbc.sbc_stats.launches - before == 6 * 4
    chunked = Experiment(data, test, specs, device=cuda).run(
        4, executor=SerialExecutor(chunk_periods=3))
    for f in ("losses", "accs", "times", "global_batch"):
        np.testing.assert_array_equal(getattr(chunked, f), getattr(mono, f))



def _two_bucket_grid():
    data, test = ClassificationData.synthetic(n=600, dim=64,
                                              spread=6.0).split(100)
    fleet = tuple(DeviceProfile(kind="cpu", f_cpu=f * 1e9)
                  for f in (0.7, 1.4, 2.1, 0.7))
    study = grid(ScenarioSpec(fleet=fleet, hidden=32, b_max=16,
                              seeds=(0, 1)),
                 policy=["online", "full", "random", "proposed"],
                 compression=[0.02, 0.05], partition=["iid", "noniid"])
    return data, test, study


@pytest.mark.parametrize("executor", [
    AsyncExecutor(), AsyncExecutor(chunk_periods=2),
    AsyncExecutor(max_in_flight=1, chunk_periods=2), MeshExecutor()],
    ids=["async", "async-chunk2", "async-cap1-chunk2", "mesh"])
def test_executors_equal_serial_bitwise_on_the_card(cuda, executor):
    data, test, study = _two_bucket_grid()
    exp = Experiment(data, test, study, device=cuda)
    assert [len(b.rows) for b in exp.lower()] == [16, 16]
    serial = exp.run(5, executor=SerialExecutor())
    before = (ksbc.sbc_stats.launches, ksbc.sbc_apply.launches)
    got = exp.run(5, executor=executor)
    assert (ksbc.sbc_stats.launches - before[0],
            ksbc.sbc_apply.launches - before[1]) == (6 * 5 * 2, 6 * 5 * 2)
    for f in ("losses", "accs", "times", "global_batch"):
        np.testing.assert_array_equal(getattr(got, f), getattr(serial, f))


def test_planning_exception_reaches_the_caller_on_the_card(cuda,
                                                           monkeypatch):
    data, test, study = _two_bucket_grid()
    plan = lowering._FeelPlanner.plan
    calls = []

    def failing_plan(self, periods):
        calls.append(periods)
        if len(calls) == 2:
            raise FloatingPointError("planner failed")
        return plan(self, periods)

    monkeypatch.setattr(lowering._FeelPlanner, "plan", failing_plan)
    with pytest.raises(FloatingPointError, match="planner failed"):
        Experiment(data, test, study, device=cuda).run(
            4, executor=AsyncExecutor(chunk_periods=2))
    assert calls == [2, 2]

# ---------------------------------------------------------------------------
# flash attention: forward at 2e-5 (bf16 2e-2), backward at 1e-4 against
# the plain versions and autograd of the oracle, bitwise reproducible
# ---------------------------------------------------------------------------

from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.ref import attention_ref  # noqa: E402

ATTN_CASES = [  # (B, S, Hq, Hkv, hd, causal, window)
    (96, 16, 4, 2, 64, True, None),        # the transformer cell's shape
    (3, 128, 4, 2, 64, True, None),
    (2, 256, 4, 1, 128, True, 64),
    (2, 100, 4, 2, 64, True, 16),          # ragged: S % 16 != 0
    (2, 100, 2, 2, 32, False, None),
    (2, 77, 6, 3, 128, False, 16),
]


def _qkv(cuda, b, s, hq, hkv, hd, dtype=torch.float32, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(torch.randn((b, s, h, hd), generator=gen, device=cuda)
                 .to(dtype) for h in (hq, hkv, hkv))


def _oracle(q, k, v, causal, window):
    """attention_ref over the (BH, S, hd) layout after GQA expansion."""
    b, s, hq, hd = q.shape
    g = hq // k.shape[2]
    flat = lambda t: t.transpose(1, 2).reshape(b * hq, s, hd)  # noqa: E731
    out = attention_ref(flat(q), flat(k.repeat_interleave(g, 2)),
                        flat(v.repeat_interleave(g, 2)), causal=causal,
                        window=window)
    return out.reshape(b, hq, s, hd).transpose(1, 2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_forward_matches_plain(cuda, case, dtype, tol):
    b, s, hq, hkv, hd, causal, window = case
    q, k, v = _qkv(cuda, b, s, hq, hkv, hd, dtype)
    before = kfa.flash_attention_fwd.launches
    o, lse = kfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    assert kfa.flash_attention_fwd.launches == before + 1
    po, plse = kfa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                             window=window)
    assert o.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), po.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, plse, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_backward_matches_plain_and_autograd(cuda, case):
    b, s, hq, hkv, hd, causal, window = case
    q, k, v = _qkv(cuda, b, s, hq, hkv, hd)
    do = torch.randn_like(q)
    o, lse = kfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    before = (kfa.flash_attention_bwd_dq.launches,
              kfa.flash_attention_bwd_dkdv.launches)
    dq, dsum = kfa.flash_attention_bwd_dq(q, k, v, o, lse, do,
                                          causal=causal, window=window)
    dk, dv = kfa.flash_attention_bwd_dkdv(q, k, v, lse, do, dsum,
                                          causal=causal, window=window)
    assert (kfa.flash_attention_bwd_dq.launches,
            kfa.flash_attention_bwd_dkdv.launches) == (before[0] + 1,
                                                       before[1] + 1)
    got = (dq, dk, dv)
    plain = kfa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                          causal=causal, window=window)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(_oracle(*leaves, causal, window), leaves, do)
    for a, p, r in zip(got, plain, auto):
        torch.testing.assert_close(a, p, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4)


def test_attention_backward_is_bitwise_reproducible(cuda):
    q, k, v = (t.requires_grad_() for t in _qkv(cuda, 96, 16, 4, 2, 64))
    do = torch.randn_like(q)
    runs = [torch.autograd.grad(kops.flash_attention(q, k, v), (q, k, v), do)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# the forward's seams (B, S, Hq, Hkv, hd, causal, window): S around its
# 16-key tiles, windows around them, g 1, 2 and 4, hd 32, 64 and 128; each
# (S, window, causal) once, the (g, hd) pairs taken in turn
ATTN_SEAMS = [
    (3, s, 2 * g, 2, hd, causal, window)
    for i, (s, window, causal) in enumerate(
        (s, w, c) for s in (1, 15, 16, 17, 33)
        for w in (None, 1, 8, 16, 17) for c in (True, False))
    for g, hd in [((1, 2, 4)[i % 3], (32, 64, 128)[i // 3 % 3])]]
# groups wider than a unit's 32 rows: 40 heads a KV head, cut into chunks
ATTN_WIDE_GROUPS = [(2, 20, 80, 2, 64, True, None),
                    (1, 9, 40, 1, 32, False, 4)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", ATTN_SEAMS + ATTN_WIDE_GROUPS)
def test_attention_forward_seams_match_plain_and_repeat_bitwise(cuda, case,
                                                                dtype, tol):
    b, s, hq, hkv, hd, causal, window = case
    q, k, v = _qkv(cuda, b, s, hq, hkv, hd, dtype, seed=s + hd)
    o, lse = kfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    po, plse = kfa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                             window=window)
    torch.testing.assert_close(o.float(), po.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, plse, rtol=2e-5, atol=2e-5)
    o2, lse2 = kfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("case", ATTN_SEAMS[::3])
def test_attention_backward_from_the_forward_at_seams(cuda, case):
    b, s, hq, hkv, hd, causal, window = case
    q, k, v = _qkv(cuda, b, s, hq, hkv, hd, seed=s)
    do = torch.randn_like(q)
    o, lse = kfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    dq, dsum = kfa.flash_attention_bwd_dq(q, k, v, o, lse, do,
                                          causal=causal, window=window)
    dk, dv = kfa.flash_attention_bwd_dkdv(q, k, v, lse, do, dsum,
                                          causal=causal, window=window)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(_oracle(*leaves, causal, window), leaves, do)
    for got, want in zip((dq, dk, dv), auto):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_forward_is_batch_invariant(cuda, dtype):
    """The cell's shape: the first and a middle sequence alone give the
    same bits as the same rows of the whole launch."""
    b = 12288
    q, k, v = _qkv(cuda, b, 16, 4, 2, 64, dtype)
    o, lse = kfa.flash_attention_fwd(q, k, v)
    for i in (0, b // 2):
        oi, li = kfa.flash_attention_fwd(q[i:i + 1], k[i:i + 1], v[i:i + 1])
        assert torch.equal(oi, o[i:i + 1]) and torch.equal(li, lse[i:i + 1])


def test_attention_forward_spills_nothing(cuda):
    from repro_torch.kernels import build
    kfa.flash_attention_fwd(*_qkv(cuda, 2, 16, 4, 2, 64))
    report = build.ptxas_report(build.load("flash_attention").log)
    instances = {n: r for n, r in report.items() if "fwd_kernel" in n}
    assert len(instances) == 8, report       # 2 types x 4 head dims
    for name, r in instances.items():
        assert r["spill_stores"] == 0 and r["spill_loads"] == 0, (name, r)
    for hd in (32, 64, 112, 128):
        for dtype in (torch.float32, torch.bfloat16):
            res = kfa.fwd_resources(hd, dtype)
            assert res["local_bytes"] == 0 and res["static_smem_bytes"] == 0
            assert res["ctas_per_sm"] >= 1 and res["threads"] == 256, res


def test_attention_wrappers_raise_instead_of_falling_back(cuda):
    q, k, v = _qkv(cuda, 2, 16, 4, 2, 64)
    o, lse = kfa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError):                  # head dim 48: no kernel
        kfa.flash_attention_fwd(*_qkv(cuda, 2, 16, 4, 2, 48))
    with pytest.raises(ValueError):                  # head dim 48, dQ
        q48, k48, v48 = _qkv(cuda, 2, 16, 4, 2, 48)
        kfa.flash_attention_bwd_dq(q48, k48, v48, q48,
                                   torch.zeros_like(lse), q48)
    # the bf16 backward launches its kernels (it raised before they took
    # bf16), each gradient in bf16
    bf = [t.bfloat16() for t in (q, k, v, o)]
    before = (kfa.flash_attention_bwd_dq.launches,
              kfa.flash_attention_bwd_dkdv.launches)
    dq, dsum = kfa.flash_attention_bwd_dq(*bf, lse, bf[0])
    dk, dv = kfa.flash_attention_bwd_dkdv(*bf[:3], lse, bf[0], dsum)
    assert (kfa.flash_attention_bwd_dq.launches,
            kfa.flash_attention_bwd_dkdv.launches) == (before[0] + 1,
                                                       before[1] + 1)
    assert {t.dtype for t in (dq, dk, dv)} == {torch.bfloat16}
    assert dsum.dtype == torch.float32
    with pytest.raises(ValueError):                  # lse on the CPU
        kfa.flash_attention_bwd_dq(q, k, v, o, lse.cpu(), q)
    with pytest.raises(ValueError):                  # non-contiguous q
        kfa.flash_attention_fwd(q.transpose(1, 2).contiguous().transpose(1, 2),
                                k, v)


def test_attention_forward_raises_on_unaligned_tensors(cuda):
    q, k, v = _qkv(cuda, 2, 16, 4, 2, 64)
    shifted = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError):
        kfa.flash_attention_fwd(shifted, k, v)


def _dq_matches_plain_twice(cuda, case, seed):
    """dq and D of the dQ kernel against its plain version (1e-4), and the
    same bits when run again."""
    b, s, hq, hkv, hd, causal, window = case
    q, k, v = _qkv(cuda, b, s, hq, hkv, hd, seed=seed)
    do = torch.randn_like(q)
    opts = dict(causal=causal, window=window)
    o, lse = kfa.flash_attention_fwd(q, k, v, **opts)
    dq, dsum = kfa.flash_attention_bwd_dq(q, k, v, o, lse, do, **opts)
    pdq, pdsum = kfa.flash_attention_bwd_dq_plain(q, k, v, o, lse, do,
                                                  **opts)
    torch.testing.assert_close(dq, pdq, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dsum, pdsum, rtol=1e-4, atol=1e-4)
    dq2, dsum2 = kfa.flash_attention_bwd_dq(q, k, v, o, lse, do, **opts)
    assert torch.equal(dq, dq2) and torch.equal(dsum, dsum2)


@pytest.mark.parametrize("case", ATTN_CASES + ATTN_WIDE_GROUPS)
def test_attention_dq_matches_plain_and_repeats_bitwise(cuda, case):
    _dq_matches_plain_twice(cuda, case, seed=case[1] + 11)


@pytest.mark.parametrize("s", (1, 15, 16, 17, 33))
def test_attention_dq_at_every_seam_combination(cuda, s):
    """All 450 combinations of the seams (B 3 over 2 KV heads): S, window
    around the 16-key tiles, causal or not, g 1, 2 and 4, hd 32, 64 and
    128; this S's 90."""
    for window, causal, g, hd in itertools.product(
            (None, 1, 8, 16, 17), (True, False), (1, 2, 4), (32, 64, 128)):
        _dq_matches_plain_twice(cuda, (3, s, 2 * g, 2, hd, causal, window),
                                seed=s + hd + g)


def test_attention_dq_is_batch_invariant(cuda):
    """The cell's shape: sequences 0 and B/2 alone give the same bits of
    dq and D as the same rows of the whole launch."""
    b = 12288
    q, k, v = _qkv(cuda, b, 16, 4, 2, 64, seed=6)
    do = torch.randn_like(q)
    o, lse = kfa.flash_attention_fwd(q, k, v)
    dq, dsum = kfa.flash_attention_bwd_dq(q, k, v, o, lse, do)
    for i in (0, b // 2):
        one = slice(i, i + 1)
        dqi, dsi = kfa.flash_attention_bwd_dq(q[one], k[one], v[one], o[one],
                                              lse[one], do[one])
        assert torch.equal(dqi, dq[one]) and torch.equal(dsi, dsum[one])


def test_attention_dq_spills_nothing(cuda):
    from repro_torch.kernels import build
    q, k, v = _qkv(cuda, 2, 16, 4, 2, 64)
    o, lse = kfa.flash_attention_fwd(q, k, v)
    kfa.flash_attention_bwd_dq(q, k, v, o, lse, torch.randn_like(q))
    report = build.ptxas_report(build.load("flash_attention").log)
    instances = {n: r for n, r in report.items() if "dq_kernel" in n}
    assert len(instances) == 8, report       # 2 types x 4 head dims
    for name, r in instances.items():
        assert r["spill_stores"] == 0 and r["spill_loads"] == 0, (name, r)
    for hd in (32, 64, 112, 128):
        for dtype in (torch.float32, torch.bfloat16):
            res = kfa.dq_resources(hd, dtype)
            assert res["local_bytes"] == 0 and res["static_smem_bytes"] == 0
            assert res["ctas_per_sm"] >= 1 and res["threads"] == 256, res


def test_attention_dq_raises_on_unaligned_tensors(cuda):
    q, k, v = _qkv(cuda, 2, 16, 4, 2, 64)
    o, lse = kfa.flash_attention_fwd(q, k, v)
    shifted = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError):
        kfa.flash_attention_bwd_dq(shifted, k, v, o, lse, torch.randn_like(q))


def _dkdv_inputs(cuda, case, seed):
    """q, k, v, dO and the lse and D the dK/dV kernel reads (from the
    forward and dQ kernels)."""
    b, s, hq, hkv, hd, causal, window = case
    q, k, v = _qkv(cuda, b, s, hq, hkv, hd, seed=seed)
    do = torch.randn_like(q)
    o, lse = kfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    _, dsum = kfa.flash_attention_bwd_dq(q, k, v, o, lse, do, causal=causal,
                                         window=window)
    return q, k, v, lse, do, dsum


@pytest.mark.parametrize("case", ATTN_SEAMS + ATTN_WIDE_GROUPS)
def test_attention_dkdv_seams_match_plain_and_autograd(cuda, case):
    """The dK/dV kernel at every seam and at groups of 40 heads a KV head,
    against its plain version and autograd of the oracle, bitwise the same
    when run twice."""
    causal, window = case[5:]
    q, k, v, lse, do, dsum = _dkdv_inputs(cuda, case, seed=case[1] + 3)
    opts = dict(causal=causal, window=window)
    dk, dv = kfa.flash_attention_bwd_dkdv(q, k, v, lse, do, dsum, **opts)
    pdk, pdv = kfa.flash_attention_bwd_dkdv_plain(q, k, v, lse, do, dsum,
                                                  **opts)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    _, adk, adv = torch.autograd.grad(_oracle(*leaves, causal, window),
                                      leaves, do)
    for got, plain, auto in ((dk, pdk, adk), (dv, pdv, adv)):
        torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got, auto, rtol=1e-4, atol=1e-4)
    dk2, dv2 = kfa.flash_attention_bwd_dkdv(q, k, v, lse, do, dsum, **opts)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def test_attention_dkdv_is_batch_invariant(cuda):
    """The cell's shape: sequences 0 and B/2 alone give the same bits as
    the same rows of the whole launch."""
    b = 12288
    q, k, v, lse, do, dsum = _dkdv_inputs(cuda, (b, 16, 4, 2, 64, True,
                                                 None), seed=5)
    dk, dv = kfa.flash_attention_bwd_dkdv(q, k, v, lse, do, dsum)
    for i in (0, b // 2):
        one = slice(i, i + 1)
        dki, dvi = kfa.flash_attention_bwd_dkdv(q[one], k[one], v[one],
                                                lse[one], do[one], dsum[one])
        assert torch.equal(dki, dk[one]) and torch.equal(dvi, dv[one])


def test_attention_dkdv_spills_nothing(cuda):
    from repro_torch.kernels import build
    kfa.flash_attention_bwd_dkdv(*_dkdv_inputs(cuda, (2, 16, 4, 2, 64, True,
                                                      None), seed=0))
    report = build.ptxas_report(build.load("flash_attention").log)
    instances = {n: r for n, r in report.items() if "dkdv_kernel" in n}
    assert len(instances) == 8, report       # 2 types x 4 head dims
    for name, r in instances.items():
        assert r["spill_stores"] == 0 and r["spill_loads"] == 0, (name, r)
    for hd in (32, 64, 112, 128):
        for dtype in (torch.float32, torch.bfloat16):
            res = kfa.dkdv_resources(hd, dtype)
            assert res["local_bytes"] == 0 and res["static_smem_bytes"] == 0
            assert res["ctas_per_sm"] >= 1 and res["threads"] == 256, res


def test_attention_dkdv_raises_on_unaligned_tensors(cuda):
    q, k, v, lse, do, dsum = _dkdv_inputs(cuda, (2, 16, 4, 2, 64, True,
                                                 None), seed=0)
    shifted = torch.empty(do.numel() + 1, device=cuda)[1:].view(do.shape)
    shifted.copy_(do)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError):
        kfa.flash_attention_bwd_dkdv(q, k, v, lse, shifted, dsum)


# ---------------------------------------------------------------------------
# the SSD scan: forward at 2e-5 (bf16 2e-2), backward at 1e-4, against the
# plain versions, bitwise reproducible, through Experiment.run
# ---------------------------------------------------------------------------

from repro_torch.kernels import ssd_scan as kssd  # noqa: E402

SSD_CASES = [  # (copies, B per copy, S, H, P, G, N, chunk)
    (8, 32, 16, 64, 8, 1, 16, 4),          # the mamba2 cell's shape, cut
    (2, 1, 128, 4, 32, 2, 16, 32),
    (1, 1, 64, 2, 64, 1, 32, 16),
    (1, 2, 256, 8, 32, 4, 64, 64),
    (1, 1, 128, 4, 32, 4, 16, 128),
]
SSD_BWD_SEAMS = [  # the backward's seams
    (2, 2, 16, 8, 16, 2, 32, 16),          # one 16-token segment exactly
    (2, 2, 17, 8, 8, 1, 16, 17),           # a last segment of one token
    (1, 3, 40, 4, 32, 2, 64, 40),          # three segments, N 64
    (1, 2, 32, 256, 8, 4, 16, 16),         # G 4, (H / G) * P = 512 at N 16
    (1, 2, 24, 16, 32, 4, 64, 24),         # G 4, (H / G) * P = 128 at N 64
    (1, 2, 20, 6, 1, 2, 16, 20),           # P 1: rows not 16-byte aligned
]
SSD_FWD_SEAMS = [  # the forward's own: S around its 16-token tiles, wide P
    (2, 2, 1, 8, 8, 2, 32, 1),
    (2, 2, 15, 8, 8, 2, 32, 15),
    (2, 2, 33, 8, 8, 2, 32, 33),           # a state across three tiles
    (2, 2, 40, 8, 8, 2, 32, 40),
    (1, 2, 16, 2, 320, 1, 16, 16),         # P wider than a unit's 256 rows
    (1, 2, 40, 4, 3, 2, 16, 40),           # P 3 with a state
    (1, 2, 16, 80, 64, 1, 128, 16),        # N 128: mamba2-2.7b's heads
    (1, 2, 40, 80, 64, 1, 128, 40),
]


def _ssd_inputs(cuda, copies, per, s, h, p, g, n, seed=0):
    """As the reference's kernel tests draw them; x, Bm and Cm are slices
    of one conv-like tensor (token stride h*p + 2*g*n), as on the path."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    b = copies * per
    scale = torch.full((h * p + 2 * g * n,), 0.5, device=cuda)
    scale[:h * p] = 1.0
    conv = torch.randn((b, s, scale.numel()), generator=gen,
                       device=cuda) * scale
    x = conv[..., :h * p].reshape(b, s, h, p)
    bm = conv[..., h * p:h * p + g * n].reshape(b, s, g, n)
    cm = conv[..., h * p + g * n:].reshape(b, s, g, n)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen,
                                                  device=cuda))
    a = -torch.exp(torch.randn((copies, h), generator=gen, device=cuda) * 0.3)
    dy = torch.randn((b, s, h, p), generator=gen, device=cuda)
    return (x, dt, a, bm, cm), dy


def _close_to_plain(got, plain, exact, tol):
    """got within tol of the plain version run in float64 everywhere, and
    of the float32 plain version wherever that is itself within tol / 2
    of the float64 value."""
    torch.testing.assert_close(got.double(), exact, rtol=tol, atol=tol)
    sound = (plain.double() - exact).abs() <= tol / 2 * (1 + exact.abs())
    torch.testing.assert_close(got[sound], plain[sound], rtol=tol, atol=tol)


@pytest.mark.parametrize("case", SSD_CASES + SSD_BWD_SEAMS + SSD_FWD_SEAMS)
def test_ssd_forward_matches_plain(cuda, case):
    copies, per, s, h, p, g, n, chunk = case
    ins, _ = _ssd_inputs(cuda, copies, per, s, h, p, g, n)
    before = kssd.ssd_scan_fwd.launches
    y = kssd.ssd_scan_fwd(*ins, chunk=chunk)
    assert kssd.ssd_scan_fwd.launches == before + 1
    _close_to_plain(y, kssd.ssd_scan_fwd_plain(*ins, chunk=chunk),
                    kssd.ssd_scan_fwd_plain(*(t.double() for t in ins),
                                            chunk=chunk), 2e-5)
    bf = [t.bfloat16() for t in ins]
    bf[2] = ins[2]                                   # A stays float32
    yb = kssd.ssd_scan_fwd(*bf, chunk=chunk)
    assert yb.dtype == torch.bfloat16
    torch.testing.assert_close(
        yb.float(), kssd.ssd_scan_fwd_plain(*bf, chunk=chunk).float(),
        rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("case", SSD_CASES + SSD_BWD_SEAMS)
def test_ssd_backward_matches_plain(cuda, case):
    copies, per, s, h, p, g, n, chunk = case
    ins, dy = _ssd_inputs(cuda, copies, per, s, h, p, g, n)
    before = kssd.ssd_scan_bwd.launches
    got = kssd.ssd_scan_bwd(*ins, dy, chunk=chunk)
    assert kssd.ssd_scan_bwd.launches == before + 1
    plain = kssd.ssd_scan_bwd_plain(*ins, dy, chunk=chunk)
    exact = kssd.ssd_scan_bwd_plain(*(t.double() for t in (*ins, dy)),
                                    chunk=chunk)
    for a, pl, ex in zip(got, plain, exact):
        assert a.shape == pl.shape
        _close_to_plain(a, pl, ex, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_forward_is_bitwise_reproducible_and_batch_invariant(cuda,
                                                                 dtype):
    copies, per, s, h, p, g, n, chunk = SSD_CASES[0]
    ins, _ = _ssd_inputs(cuda, copies, per, s, h, p, g, n)
    ins = [t if i == 2 else t.to(dtype) for i, t in enumerate(ins)]
    among = kssd.ssd_scan_fwd(*ins, chunk=chunk)
    assert torch.equal(among, kssd.ssd_scan_fwd(*ins, chunk=chunk))
    for k in (0, 77, copies * per - 1):
        alone = kssd.ssd_scan_fwd(*(t[k:k + 1] for t in ins[:2]),
                                  ins[2][k // per:k // per + 1],
                                  *(t[k:k + 1] for t in ins[3:]),
                                  chunk=chunk)
        assert torch.equal(alone, among[k:k + 1]), k


@pytest.mark.parametrize("h,p,g,n,ctas", [
    (64, 8, 1, 16, 3),         # the mamba2 cell's shape: 3 CTAs an SM
    (80, 64, 1, 128, 1),       # N 128
    (6, 1, 2, 16, 1),          # one row a thread (P % 4 != 0)
    (8, 32, 4, 64, 1),
])
def test_ssd_forward_spills_nothing(cuda, h, p, g, n, ctas):
    res = kssd.fwd_resources(h, p, g, n)
    assert set(res) == {"float32", "bfloat16", "float32_carry",
                        "bfloat16_carry"}
    for key, rec in res.items():
        assert rec["local_bytes"] == 0 and rec["static_smem_bytes"] == 0, \
            (key, rec)
        assert rec["ctas_per_sm"] >= 1, (key, rec)
    assert res["float32"]["ctas_per_sm"] >= ctas, res


def test_ssd_backward_is_bitwise_reproducible(cuda):
    ins, dy = _ssd_inputs(cuda, *SSD_CASES[0][:7])
    leaves = [t.detach().clone().requires_grad_() for t in ins]
    runs = [torch.autograd.grad(kops.ssd(*leaves, chunk=4), leaves, dy)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", [(8, 32, 16, 64, 8, 1, 16, 4),
                                  (8, 2, 40, 4, 32, 2, 64, 40)])
def test_ssd_backward_of_a_copy_is_bitwise_alone_and_among_8(cuda, case):
    copies, per, s, h, p, g, n, chunk = case
    ins, dy = _ssd_inputs(cuda, copies, per, s, h, p, g, n)
    among = kssd.ssd_scan_bwd(*ins, dy, chunk=chunk)
    for k in (0, 5):
        seqs = slice(k * per, (k + 1) * per)
        alone = kssd.ssd_scan_bwd(*(t[seqs] for t in ins[:2]),
                                  ins[2][k:k + 1],
                                  *(t[seqs] for t in ins[3:]), dy[seqs],
                                  chunk=chunk)
        for name, a, m in zip(("dx", "ddt", "dA", "dBm", "dCm"), alone,
                              among):
            assert torch.equal(a, m[k:k + 1] if name == "dA" else m[seqs]), \
                (k, name)


@pytest.mark.parametrize("h,p,g,n,warps", [
    (64, 8, 1, 16, 32),        # the mamba2 cell's shape: 4 CTAs an SM
    (6, 1, 2, 16, 32),         # the narrow instance (P < 8)
    (16, 32, 4, 64, 24),       # N 64: 61 600 bytes of shared memory, 3 CTAs
])
def test_ssd_backward_spills_nothing_and_keeps_its_warps(cuda, h, p, g, n,
                                                         warps):
    res = kssd.bwd_resources(h, p, g, n)["ssd_bwd_kernel"]
    assert res["local_bytes"] == 0, res
    assert res["warps_per_sm"] >= warps, res


def test_ssd_wrappers_raise_instead_of_falling_back(cuda):
    ins, dy = _ssd_inputs(cuda, 1, 2, 16, 4, 8, 1, 16)
    with pytest.raises(ValueError):                  # N = 129: no kernel
        big, _ = _ssd_inputs(cuda, 1, 2, 16, 4, 8, 1, 129)
        kssd.ssd_scan_fwd(*big, chunk=4)
    with pytest.raises(ValueError):                  # N = 256: no backward
        big, bdy = _ssd_inputs(cuda, 1, 2, 16, 4, 8, 1, 256)
        kssd.ssd_scan_bwd(*big, bdy, chunk=4)
    with pytest.raises(ValueError):                  # P = 12: not 2^k
        odd, ody = _ssd_inputs(cuda, 1, 2, 16, 4, 12, 1, 16)
        kssd.ssd_scan_bwd(*odd, ody, chunk=4)
    with pytest.raises(ValueError):                  # A on the CPU
        kssd.ssd_scan_fwd(ins[0], ins[1], ins[2].cpu(), *ins[3:], chunk=4)
    # N 128 and the bf16 backward (dt float32) launch the kernel (they
    # raised before it took them), each gradient in its input's type
    big, bdy = _ssd_inputs(cuda, 1, 2, 16, 4, 8, 1, 128)
    bf = [t.bfloat16() for t in ins]
    bf[1], bf[2] = ins[1], ins[2]
    for args, grad in ((big, bdy), (bf, dy.bfloat16())):
        before = kssd.ssd_scan_bwd.launches
        got = kssd.ssd_scan_bwd(*args, grad, chunk=4)
        assert kssd.ssd_scan_bwd.launches == before + 1
        assert [t.dtype for t in got] == [args[0].dtype, torch.float32,
                                          torch.float32, args[3].dtype,
                                          args[4].dtype]


def test_mamba2_run_on_the_card_matches_the_cpu_path(cuda):
    data, test = ClassificationData.synthetic(n=600, dim=64,
                                              spread=6.0).split(100)
    fleet = tuple(DeviceProfile(kind="cpu", f_cpu=f * 1e9)
                  for f in (0.7, 1.4, 2.1, 0.7))
    specs = [ScenarioSpec(fleet=fleet, hidden=32, depth=2, b_max=16,
                          compression=0.05, seeds=(0,),
                          model_family="mamba2")]
    before = (kssd.ssd_scan_fwd.launches, kssd.ssd_scan_bwd.launches)
    card = Experiment(data, test, specs, device=cuda).run(3)
    assert (kssd.ssd_scan_fwd.launches - before[0],
            kssd.ssd_scan_bwd.launches - before[1]) == (4 * 2 * 3, 2 * 3)
    cpu = Experiment(data, test, specs, device="cpu").run(3)
    np.testing.assert_array_equal(card.times, cpu.times)
    np.testing.assert_array_equal(card.global_batch, cpu.global_batch)
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=1e-4, atol=1e-4)
    assert np.abs(card.accs - cpu.accs).max() <= 2.0 / len(test.y) + 1e-7


# ---------------------------------------------------------------------------
# flash decode: 2e-5 (bf16 2e-2) against the plain version, bitwise
# reproducible; the decode driver on the card against its CPU path
# ---------------------------------------------------------------------------

from repro_torch.kernels import flash_decode as kfd  # noqa: E402

DECODE_CASES = [  # (B, ctx, Hq, Hkv, hd, pos, window)
    (8, 2048, 32, 8, 128, 191, None),     # the decode cell's shape
    (8, 2048, 32, 8, 128, 0, None),
    (8, 2048, 32, 8, 128, 2047, None),
    (2, 128, 8, 2, 64, 50, 128),          # ring buffer, pos < ctx
    (2, 128, 8, 2, 64, 1000, 128),        # ring buffer, pos >> ctx
    (2, 128, 8, 8, 64, 70, None),         # g = 1
    (2, 128, 64, 8, 64, 70, 32),          # g = 8
    (3, 100, 40, 1, 64, 99, None),        # ctx not a multiple of 32, g 40
    (2, 64, 8, 2, 128, 500, None),        # pos past ctx without a window
    # the runs' seams: the first tile's last slot and the second's first,
    # and pos below 32 x the runs, where the runs past pos are empty
    (8, 2048, 32, 8, 128, 31, None),
    (8, 2048, 32, 8, 128, 32, None),
    (8, 2048, 32, 8, 128, 33, None),
    (8, 2048, 32, 8, 128, 100, None),
    (2, 256, 8, 2, 64, 40, 256),          # a ring not yet wrapped
    (2, 40, 8, 2, 64, 39, None),          # two tiles, the second ragged
    (1, 32768, 32, 8, 128, 32767, None),  # a 32k cache: many tiles a run
    # head dim 112 (zamba2-7b's shared block: 28 lanes of 4 columns) at
    # its decode shape, the runs' seams, a ring buffer and a ragged ctx
    (8, 2048, 32, 32, 112, 191, None),
    (8, 2048, 32, 32, 112, 31, None),
    (8, 2048, 32, 32, 112, 32, None),
    (8, 2048, 32, 32, 112, 33, None),
    (2, 128, 8, 2, 112, 1000, 128),
    (3, 100, 8, 2, 112, 99, None),
    (8, 2048, 48, 1, 128, 191, None),     # granite-34b's MQA: g 48
    (8, 2048, 32, 32, 64, 191, None),     # musicgen-large's MHA at hd 64
    # arctic-480b's GQA: g 7, the last warp's second row empty
    (8, 2048, 56, 8, 128, 191, None),
    (8, 2048, 56, 8, 128, 32, None)]


def _decode_inputs(cuda, b, ctx, hq, hkv, hd, dtype=torch.float32):
    gen = torch.Generator(device=cuda).manual_seed(ctx + hq)
    return tuple(torch.randn(shape, generator=gen, device=cuda).to(dtype)
                 for shape in ((b, 1, hq, hd), (b, ctx, hkv, hd),
                               (b, ctx, hkv, hd)))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_flash_decode_matches_plain(cuda, case, dtype, tol):
    b, ctx, hq, hkv, hd, pos, window = case
    q, k, v = _decode_inputs(cuda, b, ctx, hq, hkv, hd, dtype)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    before = kfd.flash_decode.launches
    o = kfd.flash_decode(q, k, v, p, window=window)
    assert kfd.flash_decode.launches == before + 1
    torch.testing.assert_close(
        o.float(), kfd.flash_decode_plain(q, k, v, p, window=window).float(),
        rtol=tol, atol=tol)
    assert torch.equal(o, kfd.flash_decode(q, k, v, p, window=window))


def test_flash_decode_puts_one_kernel_on_the_card_and_no_workspace(cuda):
    from torch.profiler import ProfilerActivity, profile
    q, k, v = _decode_inputs(cuda, 8, 2048, 32, 8, 128)
    p = torch.tensor(191, dtype=torch.int32, device=cuda)
    kfd.flash_decode(q, k, v, p)                     # build and warm up
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        o = kfd.flash_decode(q, k, v, p)
        torch.cuda.synchronize()
    allocated = torch.cuda.memory_stats()["allocation.all.allocated"]
    assert allocated - before == 1                   # o, nothing else
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "decode_kernel" in kernels[0], kernels
    assert torch.equal(o, kfd.flash_decode(q, k, v, p))


@pytest.mark.parametrize("hd,dtype", [(128, torch.float32),
                                      (128, torch.bfloat16),
                                      (64, torch.float32),
                                      (64, torch.bfloat16),
                                      (112, torch.float32),
                                      (112, torch.bfloat16)])
def test_flash_decode_spills_nothing(cuda, hd, dtype):
    from repro_torch.kernels import build
    kfd.flash_decode(*_decode_inputs(cuda, 2, 64, 8, 2, hd, dtype), 10)
    report = build.ptxas_report(build.load("flash_decode").log)
    instances = {n: r for n, r in report.items() if "decode_kernel" in n}
    assert len(instances) == 24, report      # 2 types x 3 hd x 4 R
    for name, r in instances.items():
        assert r["spill_stores"] == 0 and r["spill_loads"] == 0, (name, r)
    # the path's instance on this card: no local memory, several runs
    res = kfd.resources(8, 2048, 32, 8, hd, dtype)
    assert res["local_bytes"] == 0, res
    assert 1 < res["splits"] <= 32, res


def test_flash_decode_wrapper_raises_instead_of_falling_back(cuda):
    q, k, v = _decode_inputs(cuda, 2, 64, 8, 2, 64)
    with pytest.raises(ValueError):                  # head dim 32: no kernel
        kfd.flash_decode(*_decode_inputs(cuda, 2, 64, 8, 2, 32), 3)
    with pytest.raises(ValueError):                  # pos on the CPU
        kfd.flash_decode(q, k, v, torch.tensor(3, dtype=torch.int32))
    with pytest.raises(ValueError):                  # non-contiguous cache
        kfd.flash_decode(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                         v, 3)


@pytest.mark.parametrize("arch,window", [("mistral-nemo-12b", None),
                                         ("mistral-nemo-12b", 8),
                                         ("mamba2-2.7b", None),
                                         ("granite-34b", None),
                                         ("musicgen-large", None),
                                         ("llava-next-mistral-7b", None),
                                         ("zamba2-7b", None),
                                         ("minicpm3-4b", None),
                                         ("deepseek-v2-lite-16b", None),
                                         ("arctic-480b", None)])
def test_decode_on_the_card_matches_the_cpu_path(cuda, arch, window):
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import model as tm
    from repro_torch.tree import tree_map
    cfg = get_arch(arch).reduced()
    if window is not None:
        cfg = dataclasses.replace(cfg, attn_window=window)
    params = tm.init(cfg, torch.Generator().manual_seed(0))
    on_card = tree_map(lambda t: t.to(cuda), params)
    cb = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    toks = torch.randint(0, cfg.vocab, (2, 16) + cb,
                         generator=torch.Generator().manual_seed(1))
    caches = {"cpu": tm.init_cache(cfg, 2, 16),
              "cuda": tm.init_cache(cfg, 2, 16, device=cuda)}
    before = kfd.flash_decode.launches
    for t in range(16):
        cpu, caches["cpu"] = tm.decode_step(cfg, params, caches["cpu"],
                                            toks[:, t:t + 1])
        card, caches["cuda"] = tm.decode_step(cfg, on_card, caches["cuda"],
                                              toks[:, t:t + 1].to(cuda))
        torch.testing.assert_close(
            torch.log_softmax(card[..., :cfg.vocab], -1).cpu(),
            torch.log_softmax(cpu[..., :cfg.vocab], -1), rtol=1e-4,
            atol=1e-4)
    # B5 a GQA layer a step (MLA decodes in plain PyTorch)
    attn_layers = {"ssm": 0, "hybrid": cfg.n_layers // max(
        cfg.hybrid_every, 1)}.get(cfg.family, cfg.n_layers)
    if cfg.attn_kind == "mla":
        attn_layers = 0
    want = 16 * attn_layers
    assert kfd.flash_decode.launches - before == want
    assert int(caches["cuda"]["pos"]) == 16


def test_qwen_train_step_pallas_matches_naive_on_the_card(cuda):
    """Reduced qwen1.5-4b (qkv biases non-zero), sgd, 2 steps at B_k =
    (1, 2): the step through B4, B4′ and B4″ (2 layers: 2 launches of
    each a step) against the naive step, losses, gradient norms and
    parameters within 1e-4."""
    from repro_torch import optim
    from repro_torch.configs import get_arch
    from repro_torch.fed.train_step import TrainState, make_train_step
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import model as tm
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_arch("qwen1.5-4b").reduced()
    gen = torch.Generator().manual_seed(0)
    params = tm.init(cfg, gen)
    for name in ("bq", "bk", "bv"):
        params["layers"]["attn"][name].normal_(0.0, 0.1, generator=gen)
    toks = torch.randint(0, cfg.vocab, (4, 17), generator=gen).to(cuda)
    w = torch.tensor([1.0, 0.0, 1.0, 1.0], device=cuda)[:, None]
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "weights": w.expand(4, 16).contiguous()}
    kernels = (kfa.flash_attention_fwd, kfa.flash_attention_bwd_dq,
               kfa.flash_attention_bwd_dkdv)
    out = {}
    for impl in ("naive", "pallas"):
        before = [k.launches for k in kernels]
        state = TrainState(tree_map(lambda t: t.to(cuda), params), (), 0)
        step = make_train_step(cfg, tm.Runtime(attn_impl=impl), optim.sgd())
        metrics = []
        for lr in (0.1, 0.05):
            state, m = step(state, batch, lr)
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
        out[impl] = (metrics, state.params)
        launched = [k.launches - b for k, b in zip(kernels, before)]
        assert launched == ([2 * cfg.n_layers] * 3 if impl == "pallas"
                            else [0, 0, 0])
    np.testing.assert_allclose(out["pallas"][0], out["naive"][0],
                               rtol=1e-4, atol=1e-4)
    for a, b in zip(tree_leaves(out["pallas"][1]),
                    tree_leaves(out["naive"][1])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_sbc_uplink_matches_plain_on_a_2_27_leaf(cuda):
    """``sbc_uplink`` on one leaf of 2^27 elements through B1 and B2 (one
    launch each) against the same in the plain versions on the card:
    keep masks equal; the kept value within rtol 1e-6 (the group sums,
    in float64 in both, may round one ulp apart), and so the residual
    within 1e-6 of that value; the gradient and the residual are written
    in place."""
    from repro_torch.compression import sbc as c
    gen = torch.Generator(device=cuda).manual_seed(27)
    g = torch.randn((1 << 27,), generator=gen, device=cuda) * 1e-3
    r = torch.randn((1 << 27,), generator=gen, device=cuda) * 1e-4
    acc = (g + r).reshape(1, -1)
    thr = c.topk_threshold_bisect(acc.abs(), c.n_keep(acc.shape[1], 0.005))
    stats = ksbc.sbc_stats_plain(acc, thr)
    want_out, want_res = ksbc.sbc_apply_plain(acc, c.group_scalars(thr,
                                                                   stats))
    del acc
    before = (ksbc.sbc_stats.launches, ksbc.sbc_apply.launches)
    out, res = c.sbc_uplink({"w": g}, 0.005, {"w": r})
    assert out["w"] is g and res["w"] is r
    assert (ksbc.sbc_stats.launches, ksbc.sbc_apply.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(g != 0, want_out[0] != 0)
    torch.testing.assert_close(g, want_out[0], rtol=1e-6, atol=0)
    val = float(want_out.abs().max())
    torch.testing.assert_close(r, want_res[0], rtol=0, atol=1e-6 * val)


# ---------------------------------------------------------------------------
# the training shapes of mamba2-2.7b and zamba2-7b: B3' at full width (N
# 128 over 80 heads of 64, N 64 over 112 heads) and the attention kernels
# at head dim 112, in f32 and in bf16 (the bf16 ones against the plain
# versions' float32 arithmetic on the same bf16 values, rounded once)
# ---------------------------------------------------------------------------

SSD_WIDE = [  # (copies, B per copy, S, H, P, G, N, chunk): full width, S cut
    (1, 1, 48, 80, 64, 1, 128, 48),        # mamba2-2.7b: 40 units
    (1, 1, 48, 112, 64, 1, 64, 48),        # zamba2-7b: 56 units
    (1, 2, 16, 80, 64, 1, 128, 16),        # one segment, two sequences
]
ATTN_TRAIN = [  # (B, S, Hq, Hkv, hd, causal, window)
    (2, 64, 4, 4, 112, True, None),        # zamba2-7b's shared block (MHA)
    (2, 100, 4, 2, 112, True, 16),         # ragged S, a window, g 2
    (1, 33, 2, 1, 112, False, None),
    (2, 64, 4, 2, 64, True, None),         # the other head dims in bf16
    (1, 80, 4, 4, 128, True, None),
    (2, 40, 2, 2, 32, False, 8),
]


def _bf16_close(got, plain):
    """rtol 2e-2 (bf16 keeps 8 bits; both round one float32 result) and
    atol 2e-2 of the plain output's mean magnitude."""
    assert got.dtype == plain.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), plain.float(), rtol=2e-2,
                               atol=2e-2 * float(plain.float().abs().mean()))


def _bf16_ssd(ins, dy):
    bf = [t.bfloat16() for t in ins]
    bf[1], bf[2] = ins[1], ins[2]                    # dt and A float32
    return bf, dy.bfloat16()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_WIDE)
def test_ssd_backward_at_full_width_matches_plain(cuda, case, dtype):
    copies, per, s, h, p, g, n, chunk = case
    ins, dy = _ssd_inputs(cuda, copies, per, s, h, p, g, n, seed=h)
    if dtype == torch.bfloat16:
        ins, dy = _bf16_ssd(ins, dy)
    before = kssd.ssd_scan_bwd.launches
    got = kssd.ssd_scan_bwd(*ins, dy, chunk=chunk)
    assert kssd.ssd_scan_bwd.launches == before + 1
    plain = kssd.ssd_scan_bwd_plain(*ins, dy, chunk=chunk)
    if dtype == torch.float32:
        exact = kssd.ssd_scan_bwd_plain(*(t.double() for t in (*ins, dy)),
                                        chunk=chunk)
        for a, pl, ex in zip(got, plain, exact):
            _close_to_plain(a, pl, ex, 1e-4)
    else:
        for name, a, pl in zip(("dx", "ddt", "dA", "dBm", "dCm"), got,
                               plain):
            if name in ("ddt", "dA"):            # float32, as dt and A
                assert a.dtype == torch.float32
                torch.testing.assert_close(a, pl, rtol=2e-2, atol=2e-2 *
                                           float(pl.abs().mean()))
            else:
                _bf16_close(a, pl)
    assert torch.equal(got[0], kssd.ssd_scan_bwd(*ins, dy, chunk=chunk)[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,n", [(80, 128), (112, 64)])
def test_ssd_backward_at_full_width_is_bitwise_alone_and_among_8(cuda, h, n,
                                                                 dtype):
    ins, dy = _ssd_inputs(cuda, 8, 1, 32, h, 64, 1, n, seed=3)
    if dtype == torch.bfloat16:
        ins, dy = _bf16_ssd(ins, dy)
    among = kssd.ssd_scan_bwd(*ins, dy, chunk=32)
    for a, b in zip(among, kssd.ssd_scan_bwd(*ins, dy, chunk=32)):
        assert torch.equal(a, b)
    for k in (0, 5):
        one = slice(k, k + 1)
        alone = kssd.ssd_scan_bwd(*(t[one] for t in ins), dy[one],
                                  chunk=32)
        for name, a, m in zip(("dx", "ddt", "dA", "dBm", "dCm"), alone,
                              among):
            assert torch.equal(a, m[one]), (k, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,p,g,n", [(80, 64, 1, 128), (112, 64, 1, 64)])
def test_ssd_backward_spills_nothing_at_full_width(cuda, h, p, g, n, dtype):
    assert kssd.bwd_units(h, p, g, n) == (h * p // 128, 128)
    for s in (16, 4096):        # one segment; the state's rows staged
        for name, res in kssd.bwd_resources(h, p, g, n, dtype, s).items():
            assert res["local_bytes"] == 0 and res["ctas_per_sm"] >= 1, (
                s, name, res)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_TRAIN)
def test_attention_train_shapes_match_plain_and_repeat_bitwise(cuda, case,
                                                               dtype):
    """Forward, dQ (with D) and dK/dV at head dim 112 and, in bf16, at the
    other head dims: against the plain versions (f32: 2e-5 forward, 1e-4
    backward), each run twice bitwise."""
    b, s, hq, hkv, hd, causal, window = case
    q, k, v = _qkv(cuda, b, s, hq, hkv, hd, dtype, seed=hd + s)
    do = torch.randn(q.shape, device=cuda).to(dtype)
    opts = dict(causal=causal, window=window)
    runs = []
    for _ in range(2):
        o, lse = kfa.flash_attention_fwd(q, k, v, **opts)
        dq, dsum = kfa.flash_attention_bwd_dq(q, k, v, o, lse, do, **opts)
        dk, dv = kfa.flash_attention_bwd_dkdv(q, k, v, lse, do, dsum, **opts)
        runs.append((o, lse, dq, dsum, dk, dv))
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)
    o, lse, dq, dsum, dk, dv = runs[0]
    po, plse = kfa.flash_attention_fwd_plain(q, k, v, **opts)
    pdq, pdsum = kfa.flash_attention_bwd_dq_plain(q, k, v, o, lse, do,
                                                  **opts)
    pdk, pdv = kfa.flash_attention_bwd_dkdv_plain(q, k, v, lse, do, dsum,
                                                  **opts)
    torch.testing.assert_close(lse, plse, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(dsum, pdsum, rtol=1e-4, atol=1e-4)
    if dtype == torch.float32:
        torch.testing.assert_close(o, po, rtol=2e-5, atol=2e-5)
        for got, plain in ((dq, pdq), (dk, pdk), (dv, pdv)):
            torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)
    else:
        for got, plain in ((o, po), (dq, pdq), (dk, pdk), (dv, pdv)):
            _bf16_close(got, plain)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_at_head_dim_112_is_batch_invariant(cuda, dtype):
    """Sequences 0 and 5 of 8 alone give the same bits of o, lse, dq, D,
    dk and dv as the same rows of the whole launch."""
    q, k, v = _qkv(cuda, 8, 48, 4, 4, 112, dtype, seed=8)
    do = torch.randn(q.shape, device=cuda).to(dtype)

    def all_three(q, k, v, do):
        o, lse = kfa.flash_attention_fwd(q, k, v)
        dq, dsum = kfa.flash_attention_bwd_dq(q, k, v, o, lse, do)
        return (o, lse, dq, dsum, *kfa.flash_attention_bwd_dkdv(
            q, k, v, lse, do, dsum))

    among = all_three(q, k, v, do)
    for i in (0, 5):
        one = slice(i, i + 1)
        for a, m in zip(all_three(q[one], k[one], v[one], do[one]), among):
            assert torch.equal(a, m[one]), i


def test_one_rank_world_train_step_is_bitwise_the_unsharded_one(cuda,
                                                                tmp_path):
    """A one-rank NCCL world on a (1, 1) ("data", "model") mesh: the
    reduced qwen1.5-4b train step through the three attention kernels on
    DTensors (baseline and ZeRO-1) gives the unsharded step's losses and
    parameters bitwise over 2 steps, with the same kernel launches."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.fed import train_step as ts
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import init_world, make_device_mesh
    from repro_torch.models.model import Runtime, init
    from repro_torch.optim import momentum
    from repro_torch.tree import tree_leaves_with_path, tree_map

    cfg = get_arch("qwen1.5-4b").reduced()
    rt = Runtime(attn_impl="pallas")
    gen = torch.Generator(device=cuda).manual_seed(3)
    params0 = init(cfg, gen)
    toks = torch.randint(0, cfg.vocab, (2, 65), generator=gen, device=cuda,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous(),
             "weights": torch.ones((2, 64), device=cuda)}
    kernels = (kfa.flash_attention_fwd, kfa.flash_attention_bwd_dq,
               kfa.flash_attention_bwd_dkdv)
    init_world("nccl", init_method=f"file://{tmp_path}/rendezvous", rank=0,
               world_size=1)
    try:
        mesh = make_device_mesh((1, 1))
        runs = {}
        for name, zero1 in (("unsharded", None), ("baseline", False),
                            ("zero1", True)):
            params, opt = tree_map(torch.clone, params0), momentum(0.9)
            if zero1 is None:
                state, b = ts.TrainState(params, opt.init(params), 0), batch
            else:
                state = ts.place_state(params, opt, mesh, zero1=zero1)
                b = shd.place(batch, shd.batch_shardings(mesh, batch))
            before = [k.launches for k in kernels]
            step = ts.make_train_step(cfg, rt, opt)
            losses = []
            for _ in range(2):
                state, m = step(state, b, 1e-2)
                losses.append(m["loss"])
            runs[name] = (torch.stack(losses),
                          [t for _, t in tree_leaves_with_path(
                              shd.gather(state.params))],
                          [k.launches - n for k, n in zip(kernels, before)])
    finally:
        dist.destroy_process_group()
    want = runs["unsharded"]
    assert all(n > 0 for n in want[2])
    for name in ("baseline", "zero1"):
        got = runs[name]
        assert torch.equal(got[0], want[0]), name
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1])), name
        assert got[2] == want[2], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("window", [64, 24])
def test_flash_decode_on_parts_of_a_ring(cuda, window, parts, dtype):
    """B5 on the parts of a ring of 64 slots split as decode against a
    ring split over cards splits it (``off``, ``ring``), at pos 10 (the
    parts past it empty), 63, 64 (the wrap) and 200: each part's o within
    2e-5 (bf16 2e-2) and lse within 1e-4 of the plain version's, the
    parts merged by their lse within the same of the whole ring's call;
    off 0 and the part's own length bitwise the call without them."""
    ring, c = 64, 64 // parts
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    q, k, v = _decode_inputs(cuda, 2, ring, 8, 2, 128, dtype)
    for pos in (10, 63, 64, 200):
        p = torch.tensor(pos, dtype=torch.int32, device=cuda)
        whole, whole_lse = kfd.flash_decode(q, k, v, p, window=window,
                                            lse=True)
        o0, lse0 = kfd.flash_decode(q, k, v, p, window=window, lse=True,
                                    off=0, ring=ring)
        assert torch.equal(o0, whole) and torch.equal(lse0, whole_lse)
        got = []
        for i in range(parts):
            kp, vp = (t[:, i * c:(i + 1) * c].contiguous() for t in (k, v))
            o, lse = kfd.flash_decode(q, kp, vp, p, window=window, lse=True,
                                      off=i * c, ring=ring)
            po, plse = kfd.flash_decode_plain(q, kp, vp, p, window=window,
                                              lse=True, off=i * c, ring=ring)
            torch.testing.assert_close(o.float(), po.float(), rtol=tol,
                                       atol=tol)
            torch.testing.assert_close(lse, plse, rtol=1e-4, atol=1e-4)
            got.append((o, lse))
        top = torch.stack([lse for _, lse in got]).amax(0)
        w = [torch.exp(lse - top) for _, lse in got]
        merged = sum(o.float() * wi[:, None, :, None]
                     for (o, _), wi in zip(got, w)) / sum(w)[:, None, :, None]
        torch.testing.assert_close(merged, whole.float(), rtol=tol,
                                   atol=tol)


def test_one_rank_world_mamba2_mixer_is_bitwise_the_unsharded_one(cuda,
                                                                  tmp_path):
    """A one-rank NCCL world on a (1, 1) ("data", "model") mesh: the
    reduced mamba2-2.7b train step through B3 and B3′ on DTensors gives
    the unsharded step's losses and parameters bitwise over 2 steps, and
    4 decode steps against DTensor caches its logits and caches bitwise,
    with the same kernel launches."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.fed import train_step as ts
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import init_world, make_device_mesh
    from repro_torch.models.model import Runtime, init, init_cache
    from repro_torch.optim import momentum
    from repro_torch.tree import tree_leaves_with_path, tree_map

    cfg = get_arch("mamba2-2.7b").reduced()
    rt = Runtime(attn_impl="pallas")
    gen = torch.Generator(device=cuda).manual_seed(3)
    params0 = init(cfg, gen)
    toks = torch.randint(0, cfg.vocab, (2, 65), generator=gen, device=cuda,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous(),
             "weights": torch.ones((2, 64), device=cuda)}
    cache0 = init_cache(cfg, 2, 16, rt, device=cuda)
    for name, t in cache0.items():
        if name != "pos":
            t.normal_(generator=gen)
    dec = torch.randint(0, cfg.vocab, (4, 2, 1), generator=gen, device=cuda,
                        dtype=torch.int32)
    kernels = (kssd.ssd_scan_fwd, kssd.ssd_scan_bwd)
    leaves = lambda t: [x for _, x in tree_leaves_with_path(t)]  # noqa
    init_world("nccl", init_method=f"file://{tmp_path}/rendezvous", rank=0,
               world_size=1)
    try:
        mesh = make_device_mesh((1, 1))
        runs = {}
        for name, zero1 in (("unsharded", None), ("baseline", False),
                            ("zero1", True)):
            params, opt = tree_map(torch.clone, params0), momentum(0.9)
            if zero1 is None:
                state, b = ts.TrainState(params, opt.init(params), 0), batch
            else:
                state = ts.place_state(params, opt, mesh, zero1=zero1)
                b = shd.place(batch, shd.batch_shardings(mesh, batch))
            before = [k.launches for k in kernels]
            step = ts.make_train_step(cfg, rt, opt)
            losses = []
            for _ in range(2):
                state, m = step(state, b, 1e-2)
                losses.append(m["loss"])
            runs[name] = (torch.stack(losses),
                          leaves(shd.gather(state.params)),
                          [k.launches - n for k, n in zip(kernels, before)])
        serve = ts.make_serve_step(cfg, rt)
        for name in ("unsharded", "sharded"):
            p, c = params0, tree_map(torch.clone, cache0)
            if name == "sharded":
                p = shd.place(p, shd.params_shardings(mesh, p))
                c = shd.place(c, shd.cache_shardings(mesh, c))
            logits = []
            with torch.no_grad():
                for tok in dec:
                    if name == "sharded":
                        tok = shd.place({"t": tok}, shd.batch_shardings(
                            mesh, {"t": tok}))["t"]
                    out, c = serve(p, c, tok)
                    logits.append(shd.gather({"l": out})["l"])
            runs["decode " + name] = (torch.stack(logits),
                                      leaves(shd.gather(c)))
    finally:
        dist.destroy_process_group()
    want = runs["unsharded"]
    assert all(n > 0 for n in want[2])
    for name in ("baseline", "zero1"):
        got = runs[name]
        assert torch.equal(got[0], want[0]), name
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1])), name
        assert got[2] == want[2], name
    got, want = runs["decode sharded"], runs["decode unsharded"]
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
