"""The SSD backward kernel's algorithm, in plain float32 PyTorch, against
the float64 plain backward, on the CPU.

``csrc/ssd_scan.cu::ssd_bwd_kernel`` does not run the recurrence
backward: within each 16-token segment it sums the gradient over token
pairs s <= t (the dual form, decays as running products of a), and
across segments it carries the states at segment ends and one adjoint
(the note at the top of the source).  The kernel itself runs only on the
card (``tests/test_torch_cuda.py``); :func:`dual_bwd` is the same
algorithm, term for term, vectorised over sequences and heads, so its
float32 error can be held here at every shape ``chip_smoke.py`` phase 3c
holds the kernel at (scaled down in the batch): within 1e-4 of
``ssd_scan_bwd_plain`` run in float64, the kernel's own contract."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ssd_scan as ks

SEG = 16            # tokens of a segment (csrc kSeg)

CASES = [  # (copies, B per copy, S, H, P, G, N): phase 3c's, batch cut
    (4, 4, 16, 64, 8, 1, 16),       # the mamba2 cell's shape
    (2, 1, 128, 4, 32, 2, 16),
    (1, 1, 64, 2, 64, 1, 32),
    (1, 2, 256, 8, 32, 4, 64),
    (1, 1, 128, 4, 32, 4, 16),
    (2, 2, 16, 8, 16, 2, 32),       # the backward's seams
    (2, 2, 17, 8, 8, 1, 16),
    (1, 3, 40, 4, 32, 2, 64),
    (1, 2, 32, 256, 8, 4, 16),
    (1, 2, 24, 16, 32, 4, 64),
    (1, 2, 20, 6, 1, 2, 16),
]


def _suffix_sum(v, dim):
    """sum over indices >= i along dim, each a direct sum (no
    differences)."""
    return torch.flip(torch.cumsum(torch.flip(v, (dim,)), dim), (dim,))


def dual_bwd(x, dt, A, Bm, Cm, dy):
    """``(dx, ddt, dA, dBm, dCm)`` by the kernel's algorithm, float32."""
    b, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hg, copies = H // G, A.shape[0]
    per = b // copies
    xg = x.reshape(b, S, G, hg, P)
    dyg = dy.reshape(b, S, G, hg, P)
    dtg = dt.reshape(b, S, G, hg)
    Ab = A.repeat_interleave(per, 0).reshape(b, 1, G, hg)
    a_all = torch.exp(dtg * Ab)                            # (b, S, G, hg)
    nseg = -(-S // SEG)
    bounds = [(k * SEG, min(S, (k + 1) * SEG)) for k in range(nseg)]

    def decays(a):
        """pre(t) = a_0 .. a_t, post(t) = a_{n-1} .. a_{t+1}, and D[t, s]
        = a_{s+1} .. a_t (t >= s, else 0), running products."""
        n = a.shape[1]
        pre = torch.cumprod(a, 1)
        post = torch.ones_like(a)
        for t in range(n - 2, -1, -1):
            post[:, t] = post[:, t + 1] * a[:, t + 1]
        D = a.new_zeros(a.shape[:1] + a.shape[2:] + (n, n))
        for s in range(n):
            d = torch.ones_like(a[:, 0])
            for t in range(s, n):
                if t > s:
                    d = d * a[:, t]
                D[..., t, s] = d
        return pre, post, D

    # pass 1: the state at the end of every segment but the last
    zero = x.new_zeros((b, G, hg, P, N))
    starts = [zero]
    for t0, t1 in bounds[:-1]:
        pre, post, _ = decays(a_all[:, t0:t1])
        u = dtg[:, t0:t1, ..., None] * xg[:, t0:t1]
        starts.append(pre[:, -1, ..., None, None] * starts[-1] + torch.einsum(
            "bsgh,bsghp,bsgn->bghpn", post, u, Bm[:, t0:t1]))

    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dBm, dCm = torch.empty_like(Bm), torch.empty_like(Cm)
    dA = torch.zeros((b, G, hg), dtype=torch.float64)
    carry = zero                                   # a_{t1} g_{t1}
    for k in range(nseg - 1, -1, -1):
        t0, t1 = bounds[k]
        h0 = starts[k]
        xs, dys, dts = xg[:, t0:t1], dyg[:, t0:t1], dtg[:, t0:t1]
        Bs, Cs = Bm[:, t0:t1], Cm[:, t0:t1]
        pre, post, D = decays(a_all[:, t0:t1])     # D: (b, G, hg, t, s)
        CB = torch.einsum("btgn,bsgn->bgts", Cs, Bs)[:, :, None]
        K = torch.einsum("btghp,bsghp->bghts", dys, xs)
        W = D * dts.permute(0, 2, 3, 1)[..., None, :] * K
        Z = W * CB
        du = torch.einsum("bghts,bghts,btghp->bsghp", D, CB.expand_as(D),
                          dys)
        xd = torch.einsum("bghts,bghts,bghts->bsgh", D, CB.expand_as(D), K)
        n = t1 - t0
        lower = torch.ones(n, n).tril(-1).T                # [s, t]: s < t
        Zs = _suffix_sum(Z, 3)                             # [t, s]: t' >= t
        dl = (Zs.transpose(-1, -2) * lower).sum(-2)        # (b, G, hg, t)
        dl = dl.permute(0, 3, 1, 2)                        # (b, t, G, hg)
        # the boundary terms
        gb = torch.einsum("bghpn,bsgn->bsghp", carry, Bs)
        du = du + post[..., None] * gb
        e = (xs * gb).sum(-1)
        xd = xd + post * e
        t3 = post * dts * e                                # for every t > s
        dl = dl + torch.einsum("bsgh,st->btgh", t3, lower)
        q = (dys * torch.einsum("bghpn,btgn->btghp", h0, Cs)).sum(-1) * pre
        dl = dl + _suffix_sum(q, 1)
        dl = dl + pre[:, -1:] * (carry * h0).sum((-1, -2))[:, None]
        dx[:, t0:t1] = (dts[..., None] * du).reshape(b, n, H, P)
        ddt[:, t0:t1] = (xd + Ab * dl).reshape(b, n, H)
        dA += (dts.double() * dl.double()).sum(1)
        Wg = W.sum(2)                                      # (b, G, t, s)
        dCm[:, t0:t1] = torch.einsum("bgts,bsgn->btgn", Wg, Bs) + \
            torch.einsum("btgh,btghp,bghpn->btgn", pre, dys, h0)
        dBm[:, t0:t1] = torch.einsum("bgts,btgn->bsgn", Wg, Cs) + \
            torch.einsum("bsgh,bsghp,bghpn->bsgn", post * dts, xs, carry)
        carry = torch.einsum("btgh,btghp,btgn->bghpn", pre, dys, Cs) + \
            pre[:, -1, ..., None, None] * carry
    dA = dA.reshape(copies, per, H).sum(1).float()
    return dx, ddt, dA, dBm, dCm


def _inputs(copies, per, s, h, p, g, n, seed=0):
    """As ``chip_smoke.ssd_inputs`` draws them (x, Bm, Cm slices of one
    conv-like tensor), from numpy."""
    rng = np.random.default_rng(seed)
    b = copies * per
    scale = np.full(h * p + 2 * g * n, 0.5, np.float32)
    scale[:h * p] = 1.0
    conv = torch.from_numpy(
        (rng.normal(size=(b, s, scale.size)) * scale).astype(np.float32))
    x = conv[..., :h * p].reshape(b, s, h, p)
    bm = conv[..., h * p:h * p + g * n].reshape(b, s, g, n)
    cm = conv[..., h * p + g * n:].reshape(b, s, g, n)
    dt = torch.from_numpy(
        np.logaddexp(rng.normal(size=(b, s, h)), 0).astype(np.float32))
    a = torch.from_numpy(
        (-np.exp(rng.normal(size=(copies, h)) * 0.3)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(b, s, h, p)).astype(np.float32))
    return (x, dt, a, bm, cm), dy


@pytest.mark.parametrize("case", CASES)
def test_dual_form_backward_is_within_1e_4_of_float64(case):
    copies, per, s, h, p, g, n = case
    ins, dy = _inputs(copies, per, s, h, p, g, n)
    got = dual_bwd(*ins, dy)
    exact = ks.ssd_scan_bwd_plain(*(t.double() for t in ins), dy.double(),
                                  chunk=s)
    worst = 0.0
    for name, a, ex in zip(("dx", "ddt", "dA", "dBm", "dCm"), got, exact):
        assert a.dtype == torch.float32 and a.shape == ex.shape, name
        torch.testing.assert_close(a.double(), ex, rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"{name}: {m}")
        worst = max(worst, float(((a.double() - ex).abs()
                                  / (1e-4 + 1e-4 * ex.abs())).max()))
    print(f"PARITY ssd bwd dual form copies={copies} B={copies * per} S={s} "
          f"H={h} P={p} G={g} N={n}: worst {worst:.3f} of the 1e-4 "
          f"tolerance vs float64")
