"""The SSD forward kernel's algorithm, in plain float32 PyTorch, against
the float64 plain forward and the reference's Pallas kernel, on the CPU.

``csrc/ssd_scan.cu::ssd_fwd_kernel`` does not run the per-token
recurrence: within each 16-token tile it sums y over token pairs s <= t
(the dual form: CB[t, s] = C_t . B_s once for a group's heads, W_h[t, s]
= D(t, s) CB[t, s] dt_s with the decays D as running products of a =
exp(dt A)), and across tiles (S > 16 only) it carries each row's state,
adding pre(t) C_t . h_in to y before it updates h (the note at the top of
the source).  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``); :func:`tiled_fwd` is the same algorithm,
term for term and with the kernel's order of the sums over tokens and
over n in CB, vectorised over sequences and heads, so its float32 error
can be held here at every shape ``chip_smoke.py`` phase 3c holds the
kernel at (scaled down in the batch), at S in {1, 15, 16, 17, 33, 40}
and at N 128 (mamba2-2.7b's head shape): within 2e-5 (rtol = atol) of ``ssd_scan_fwd_plain`` run in
float64, the kernel's own contract, and, where S is a multiple of the
chunk, within 3e-4 of the reference's Pallas ``ssd_scan`` in interpret
mode (the reference's own tolerance; ``tests/test_torch_ssd.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as ref_ssd_scan

from repro_torch.kernels import ssd_scan as ks

TILE = 16           # tokens of a tile (csrc kTile)

CASES = [  # (copies, B per copy, S, H, P, G, N, chunk)
    # phase 3c's: the mamba2 cell's shape, the reference's kernel tests
    (4, 4, 16, 64, 8, 1, 16, 4),
    (2, 1, 128, 4, 32, 2, 16, 32),
    (1, 1, 64, 2, 64, 1, 32, 16),
    (1, 2, 256, 8, 32, 4, 64, 64),
    (1, 1, 128, 4, 32, 4, 16, 128),
    # the backward's seams (chip_smoke.SSD_BWD_SEAMS)
    (2, 2, 16, 8, 16, 2, 32, 16),
    (2, 2, 17, 8, 8, 1, 16, 17),
    (1, 3, 40, 4, 32, 2, 64, 40),
    (1, 2, 32, 256, 8, 4, 16, 16),
    (1, 2, 24, 16, 32, 4, 64, 24),
    (1, 2, 20, 6, 1, 2, 16, 20),
    # the forward's tile seams (chip_smoke.SSD_FWD_SEAMS): S around 16
    (2, 2, 1, 8, 8, 2, 32, 1),
    (2, 2, 15, 8, 8, 2, 32, 15),
    (2, 2, 33, 8, 8, 2, 32, 33),
    (2, 2, 40, 8, 8, 2, 32, 40),
    (1, 2, 16, 2, 320, 1, 16, 16),      # P wider than a unit's 256 rows
    (1, 2, 40, 4, 3, 2, 16, 40),        # P 3 with a state
    # N 128 (chip_smoke.SSD_FWD_N128): mamba2-2.7b's heads
    (1, 2, 16, 80, 64, 1, 128, 16),
    (1, 2, 40, 80, 64, 1, 128, 40),
]


def tiled_fwd(x, dt, A, Bm, Cm):
    """y (B, S, H, P) by the kernel's algorithm, float32."""
    b, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hg = H // G
    A2 = A if A.dim() == 2 else A[None]
    per = b // A2.shape[0]
    xg = x.float().reshape(b, S, G, hg, P)
    dtg = dt.float().reshape(b, S, G, hg)
    Ab = A2.float().repeat_interleave(per, 0).reshape(b, 1, G, hg)
    a_all = torch.exp(dtg * Ab)                            # (b, S, G, hg)
    y = torch.empty((b, S, G, hg, P))
    h = torch.zeros((b, G, hg, P, N))                      # the state
    for t0 in range(0, S, TILE):
        n = min(TILE, S - t0)
        a = a_all[:, t0:t0 + n]
        xs, dts = xg[:, t0:t0 + n], dtg[:, t0:t0 + n]
        Bs, Cs = Bm[:, t0:t0 + n].float(), Cm[:, t0:t0 + n].float()
        # CB[t, s] = C_t . B_s, over n in order          (b, G, t, s)
        CB = torch.zeros((b, G, n, n))
        for i in range(N):
            CB = CB + Cs[:, :, :, i].permute(0, 2, 1)[..., None] * \
                Bs[:, :, :, i].permute(0, 2, 1)[..., None, :]
        # D[t, s] = a_{s+1} ... a_t, running products   (b, G, hg, t, s)
        D = torch.zeros((b, G, hg, n, n))
        for s in range(n):
            d = torch.ones((b, G, hg))
            for t in range(s, n):
                if t > s:
                    d = d * a[:, t]
                D[..., t, s] = d
        W = D * CB[:, :, None] * dts.permute(0, 2, 3, 1)[..., None, :]
        # the state entering the tile, into y: pre(t) C_t . h_in
        pre = torch.cumprod(a, 1)                          # (b, t, G, hg)
        acc = pre[..., None] * torch.einsum("btgn,bghpn->btghp", Cs, h)
        if t0 == 0:
            acc = torch.zeros_like(acc)
        for s in range(n):                   # + sum_{s <= t} W x_s
            acc[:, s:] = acc[:, s:] + W[..., s:, s].permute(0, 3, 1, 2)[
                ..., None] * xs[:, s, None]
        y[:, t0:t0 + n] = acc
        if t0 + n < S:                       # the state leaving the tile
            post = torch.ones_like(a)
            for t in range(n):
                for q in range(n - 1, t, -1):
                    post[:, t] = post[:, t] * a[:, q]
            h = h * pre[:, -1, ..., None, None]
            for s in range(n):
                coef = post[:, s, ..., None] * (dts[:, s, ..., None]
                                                * xs[:, s])
                h = h + coef[..., None] * Bs[:, s, :, None, None, :]
    return y.reshape(b, S, H, P)


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
    return x, dt, a, bm, cm


def _pallas(x, dt, A, Bm, Cm, chunk):
    """The reference's Pallas kernel in interpret mode, one copy of A at a
    time (it takes A of shape (H,)), on the first two sequences of each
    copy."""
    per = x.shape[0] // A.shape[0]
    keep = min(per, 2)
    out = []
    for c in range(A.shape[0]):
        rows = slice(c * per, c * per + keep)
        ins = [jnp.asarray(t[rows].contiguous().numpy())
               for t in (x, dt)] + [jnp.asarray(A[c].numpy())] + \
            [jnp.asarray(t[rows].contiguous().numpy()) for t in (Bm, Cm)]
        out.append(np.asarray(ref_ssd_scan(*ins, chunk=chunk,
                                           interpret=True)))
    return np.concatenate(out), keep, per


@pytest.mark.parametrize("case", CASES)
def test_tiled_forward_is_within_2e_5_of_float64_and_pallas(case):
    copies, per, s, h, p, g, n, chunk = case
    ins = _inputs(copies, per, s, h, p, g, n)
    got = tiled_fwd(*ins)
    assert got.dtype == torch.float32 and got.shape == ins[0].shape
    exact = ks.ssd_scan_fwd_plain(*(t.double() for t in ins), chunk=chunk)
    torch.testing.assert_close(got.double(), exact, rtol=2e-5, atol=2e-5)
    err = float((got.double() - exact).abs().max())
    worst = float(((got.double() - exact).abs()
                   / (2e-5 + 2e-5 * exact.abs())).max())
    line = (f"PARITY ssd fwd tiles copies={copies} B={copies * per} S={s} "
            f"H={h} P={p} G={g} N={n}: vs float64 max_abs_err={err:.3g} "
            f"({worst:.3f} of the 2e-5 tolerance)")
    if s % min(chunk, s) == 0:
        want, keep, per_ = _pallas(*ins, chunk)
        mine = torch.cat([got[c * per_:c * per_ + keep]
                          for c in range(copies)]).numpy()
        np.testing.assert_allclose(mine, want, rtol=3e-4, atol=3e-4)
        line += (f"; vs pallas interpret max_abs_err="
                 f"{float(np.abs(mine - want).max()):.3g} tol=3e-4")
    print(line)

