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
instances spills; the wrappers raise on what the kernels do not take (a
forward input off a 16-byte boundary too).  The SSD forward must
agree with its plain version to 2e-5 (bf16: 2e-2) and the backward to
1e-4 — against the plain version run in float64 everywhere, and against
the float32 plain version wherever that is itself within half the
tolerance of the float64 value, also at the backward's seams (one
segment, ragged segments, G 4 at the admitted widths, unaligned rows);
the backward is bitwise reproducible, a copy's gradients are bitwise
the same alone and among 8, and its kernel spills nothing and keeps 32
warps resident an SM at the cell's shape; a mamba2 ``Experiment.run`` on the card matches
the CPU path.  The
flash-decode kernel must agree with its plain version to 2e-5 (bf16:
2e-2) at every pos, window and group size it takes, bitwise from run to
run, also at the runs' seams (pos 31, 32, 33 and runs left empty);
one call puts one kernel on the card and allocates nothing but its
output, and no instance spills; the decode driver on the card matches
its CPU path (1e-4 in log-softmax) and runs every attention layer
through the kernel."""
import numpy as np
import pytest
import torch

from repro_torch.api import Experiment, ScenarioSpec, SerialExecutor
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
    assert len(instances) == 6, report       # 2 types x 3 head dims
    for name, r in instances.items():
        assert r["spill_stores"] == 0 and r["spill_loads"] == 0, (name, r)
    for hd in (32, 64, 128):
        for dtype in (torch.float32, torch.bfloat16):
            res = kfa.fwd_resources(hd, dtype)
            assert res["local_bytes"] == 0 and res["static_smem_bytes"] == 0
            assert res["ctas_per_sm"] >= 1 and res["threads"] == 256, res


def test_attention_wrappers_raise_instead_of_falling_back(cuda):
    q, k, v = _qkv(cuda, 2, 16, 4, 2, 64)
    o, lse = kfa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError):                  # head dim 48: no kernel
        kfa.flash_attention_fwd(*_qkv(cuda, 2, 16, 4, 2, 48))
    with pytest.raises(ValueError):                  # bf16 backward
        bf = [t.bfloat16() for t in (q, k, v, o)]
        kfa.flash_attention_bwd_dq(*bf, lse, bf[0])
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


@pytest.mark.parametrize("case", SSD_CASES)
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
    with pytest.raises(ValueError):                  # N = 128: no kernel
        big, _ = _ssd_inputs(cuda, 1, 2, 16, 4, 8, 1, 128)
        kssd.ssd_scan_fwd(*big, chunk=4)
    with pytest.raises(ValueError):                  # P = 12: not 2^k
        odd, ody = _ssd_inputs(cuda, 1, 2, 16, 4, 12, 1, 16)
        kssd.ssd_scan_bwd(*odd, ody, chunk=4)
    with pytest.raises(ValueError):                  # A on the CPU
        kssd.ssd_scan_fwd(ins[0], ins[1], ins[2].cpu(), *ins[3:], chunk=4)
    with pytest.raises(ValueError):                  # bf16 backward
        bf = [t.bfloat16() for t in ins]
        bf[2] = ins[2]
        kssd.ssd_scan_bwd(*bf, dy.bfloat16(), chunk=4)


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
    (1, 32768, 32, 8, 128, 32767, None)]  # a 32k cache: many tiles a run


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
                                      (64, torch.bfloat16)])
def test_flash_decode_spills_nothing(cuda, hd, dtype):
    from repro_torch.kernels import build
    kfd.flash_decode(*_decode_inputs(cuda, 2, 64, 8, 2, hd, dtype), 10)
    report = build.ptxas_report(build.load("flash_decode").log)
    instances = {n: r for n, r in report.items() if "decode_kernel" in n}
    assert len(instances) == 16, report      # 2 types x 2 hd x 4 R
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
                                         ("mamba2-2.7b", None)])
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
    toks = torch.randint(0, cfg.vocab, (2, 16),
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
    want = 16 * cfg.n_layers if cfg.family == "dense" else 0
    assert kfd.flash_decode.launches - before == want
    assert int(caches["cuda"]["pos"]) == 16
