"""The flash-attention dK/dV kernel's partition, mirrored in float32 on the
CPU, against the reference.

:func:`unit_dkdv` is ``csrc/flash_attention.cu::dkdv_kernel`` term for
term, vectorised over its units: units (sequence, KV head, key tile of 16
aligned to 16) in the kernel's order, each walking the query rows its keys
can see in the forward's 32-row layout (row r = position q0 + r / hc, head
r % hc of a chunk of hc = min(g, 32) heads) — head chunks, then query tiles
of 32 / hc positions from the first visible to the last; s = q.k and dp =
dO.v as four partial sums over the head dim (element d into sum d mod 4,
then (s0 + s1) + (s2 + s3)), p = exp(s scale - lse) and dS = p (dp - D),
both 0 where masked; dV += p dO and dK += dS q over the step's 32 rows in
row order, steps in order; dK scaled once at the end.  It differs from the
kernel only where the kernel fuses a multiply and an add.

* The partition sums every (key row, visible query row, head) pair exactly
  once, and no other, also for a group of 40 heads cut into chunks of 32.
* The mirror against ``jax.vjp`` of the reference's ``attention_ref`` (the
  TPU package has no backward kernel) and against the port's
  ``flash_attention_bwd_dkdv_plain``: at the seams S ∈ {1, 15, 16, 17, 33},
  window ∈ {None, 1, 8, 16, 17}, causal and not, with g ∈ {1, 2, 4} and
  hd ∈ {32, 64, 128} taken in turn, at head dim 112 (5 more seams), and
  at chip_smoke's attention cases
  with B cut to 2.  1e-4, the backward's tolerance.
* Batch invariance: a sequence alone and inside a batch give the same
  bits."""
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_ref

from repro_torch.kernels import flash_attention as fa

UNIT_ROWS = 32       # query rows of a step (csrc kUnitRows)
KEY_TILE = 16        # keys of a unit (csrc kKeyTile)
TOL = 1e-4


def plan(hq: int, hkv: int):
    """(g, hc, qt, nhc) as ``dkdv_plan``: heads of the group, heads of a
    step, positions of a step, head chunks."""
    g = hq // hkv
    hc = min(g, UNIT_ROWS)
    return g, hc, UNIT_ROWS // hc, -(-g // hc)


def units(b: int, s: int, hq: int, hkv: int, causal: bool, window):
    """Every unit in the kernel's order (key tile fastest, then KV head,
    sequence): (b, hk, k0, qb, nq), its query tiles [qb, qb + nq) from
    ``query_range``."""
    _, _, qt, _ = plan(hq, hkv)
    out = []
    for bb, hk, kt in itertools.product(range(b), range(hkv),
                                        range(-(-s // KEY_TILE))):
        k0 = kt * KEY_TILE
        lo = k0 if causal else 0
        hi = min(s, k0 + KEY_TILE - 1 + window) if window is not None else s
        out.append((bb, hk, k0, lo // qt, -(-hi // qt) - lo // qt))
    return out


def step_rows(hq: int, hkv: int, s: int, qb, nq, e: int):
    """Step e's rows of units with query tiles (qb, nq) (int tensors of
    shape (U,)): (position, head in the group, live) of shape (U, 32)."""
    g, hc, qt, _ = plan(hq, hkv)
    c = e // nq
    q0 = (qb + e - c * nq) * qt
    r = torch.arange(UNIT_ROWS)
    pos = q0[:, None] + r // hc
    hi = c[:, None] * hc + r % hc
    return pos, hi, (r < qt * hc) & (pos < s) & (hi < g)


def _visible(pos, pk, s, causal, window):
    vis = (pk < s) & (pos < s)
    if causal:
        vis &= pk <= pos
    if window is not None:
        vis &= pk > pos - window
    return vis


def _four_sums(a, b):
    """sum_d a[..., d] b[..., d] as the kernel's four partial sums:
    a (U, 32, hd), b (U, 16, hd) -> (U, 32, 16)."""
    part = [torch.zeros(a.shape[:2] + b.shape[1:2]) for _ in range(4)]
    for d in range(a.shape[-1]):
        part[d % 4] = part[d % 4] + a[:, :, None, d] * b[:, None, :, d]
    return (part[0] + part[1]) + (part[2] + part[3])


def unit_dkdv(q, k, v, lse, do, dsum, *, causal: bool = True, window=None):
    """``(dk, dv)`` by the kernel's units, steps and order of the sums in
    float32: q, do (B, S, Hq, hd), k, v (B, S, Hkv, hd), lse and D (B, Hq,
    S)."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g, _, _, nhc = plan(hq, hkv)
    info = units(b, s, hq, hkv, causal, window)
    bb, hk, k0, qb, nq = (torch.tensor(col) for col in zip(*info))
    steps = nhc * nq
    pk = k0[:, None] + torch.arange(KEY_TILE)                   # (U, 16)
    kin = pk < s
    zero = torch.tensor(0.0)
    tile = lambda x: torch.where(  # noqa: E731
        kin[..., None], x.float()[bb[:, None], pk.clamp(max=s - 1),
                                  hk[:, None]], zero)
    kt, vt = tile(k), tile(v)                                   # (U, 16, hd)
    gk = torch.zeros(kt.shape)
    gv = torch.zeros(kt.shape)
    scale = 1.0 / math.sqrt(hd)
    for e in range(int(steps.max())):
        active = (e < steps)[:, None, None]
        pos, hi, live = step_rows(hq, hkv, s, qb, nq, e)
        head = hk[:, None] * g + hi.clamp(max=g - 1)
        p_, ub = pos.clamp(max=s - 1), bb[:, None]
        rows = lambda x: torch.where(  # noqa: E731
            live[..., None], x.float()[ub, p_, head], zero)
        stat = lambda x: torch.where(live, x[ub, head, p_], zero)  # noqa
        qr, dor = rows(q), rows(do)                             # (U, 32, hd)
        sc, dp = _four_sums(qr, kt), _four_sums(dor, vt)
        vis = live[..., None] & _visible(pos[..., None], pk[:, None, :], s,
                                         causal, window)
        p = torch.where(vis, torch.exp(sc * scale - stat(lse)[..., None]),
                        zero)
        ds = torch.where(vis, p * (dp - stat(dsum)[..., None]), zero)
        nk, nv = gk, gv
        for r in range(UNIT_ROWS):
            nv = nv + p[:, r, :, None] * dor[:, None, r, :]
            nk = nk + ds[:, r, :, None] * qr[:, None, r, :]
        gk = torch.where(active, nk, gk)
        gv = torch.where(active, nv, gv)
    dk = torch.zeros(k.shape)
    dv = torch.zeros(v.shape)
    ub = bb[:, None].expand_as(pk)
    uh = hk[:, None].expand_as(pk)
    dk[ub[kin], pk[kin], uh[kin]] = (gk * scale)[kin]
    dv[ub[kin], pk[kin], uh[kin]] = gv[kin]
    return dk, dv


def _inputs(b, s, hq, hkv, hd, seed):
    """q, k, v and dO, float32 numpy from a seed."""
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, s, h, hd)).astype(np.float32)
                 for h in (hq, hkv, hkv, hq))


def _stats(q, k, v, do, causal, window):
    """lse and D = rowsum(dO o) from the port's plain forward, the inputs
    the kernel reads."""
    o, lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                          window=window)
    _, dsum = fa.flash_attention_bwd_dq_plain(q, k, v, o, lse, do,
                                              causal=causal, window=window)
    return lse, dsum


def _reference(q, k, v, do, causal, window):
    """dK and dV from ``jax.vjp`` of the reference's ``attention_ref`` over
    the (BH, S, hd) layout after the GQA expansion, summed back over each
    KV head's group, as (B, S, Hkv, hd) float32 numpy."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv

    def bhsd(a, rep=1):
        a = np.repeat(a, rep, axis=2).transpose(0, 2, 1, 3)
        return jnp.asarray(a.reshape(b * hq, s, hd))
    _, vjp = jax.vjp(lambda *a: ref_ref.attention_ref(
        *a, causal=causal, window=window), bhsd(q), bhsd(k, g), bhsd(v, g))
    _, dk, dv = vjp(bhsd(do))
    back = lambda x: np.asarray(x, np.float32).reshape(  # noqa: E731
        b, hkv, g, s, hd).sum(2).transpose(0, 2, 1, 3)
    return back(dk), back(dv)


def _parity(got, want, tol=TOL):
    got = np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    return float(np.abs(got - want).max())


def _check(case, seed):
    b, s, hq, hkv, hd, causal, window = case
    q, k, v, do = _inputs(b, s, hq, hkv, hd, seed)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    lse, dsum = _stats(tq, tk, tv, tdo, causal, window)
    dk, dv = unit_dkdv(tq, tk, tv, lse, tdo, dsum, causal=causal,
                       window=window)
    pdk, pdv = fa.flash_attention_bwd_dkdv_plain(tq, tk, tv, lse, tdo, dsum,
                                                 causal=causal, window=window)
    rdk, rdv = _reference(q, k, v, do, causal, window)
    return max(_parity(dk, rdk), _parity(dv, rdv), _parity(pdk, dk.numpy()),
               _parity(pdv, dv.numpy()))


# the seams (B, S, Hq, Hkv, hd, causal, window): each (S, window, causal)
# once, the (g, hd) pairs taken in turn
SEAMS = [
    (2, s, 2 * g, 2, hd, causal, window)
    for i, (s, window, causal) in enumerate(
        (s, w, c) for s in (1, 15, 16, 17, 33)
        for w in (None, 1, 8, 16, 17) for c in (True, False))
    for g, hd in [((1, 2, 4)[i % 3], (32, 64, 128)[i // 3 % 3])]]

# head dim 112 (zamba2-7b's shared block: 7 output columns a thread, 28
# 16-byte chunks a row in float32): each S once, the (window, causal)
# pairs and g taken in turn
SEAMS_112 = [
    (2, s, 2 * g, 2, 112, causal, window)
    for i, s in enumerate((1, 15, 16, 17, 33))
    for (window, causal), g in [(((None, True), (8, True), (17, False))[i % 3],
                                 (1, 2, 4)[i % 3])]]

# chip_smoke's attention cases with B cut to 2
CHIP_CASES = [(2, 16, 4, 2, 64, True, None), (2, 128, 4, 2, 64, True, None),
              (2, 256, 4, 2, 128, True, 64), (2, 100, 4, 2, 64, True, 16),
              (2, 100, 4, 2, 128, False, None),
              (2, 256, 4, 1, 64, False, 16)]


@pytest.mark.parametrize("s,hq,hkv", [(16, 4, 2), (17, 4, 2), (33, 4, 4),
                                      (100, 6, 3), (5, 80, 2), (40, 8, 1)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 8),
                                           (False, None), (False, 5)])
def test_partition_sums_each_visible_pair_once(s, hq, hkv, causal, window):
    b = 2
    g, _, _, nhc = plan(hq, hkv)
    info = units(b, s, hq, hkv, causal, window)
    assert len(info) == b * hkv * -(-s // KEY_TILE)
    bb, hk, k0, qb, nq = (torch.tensor(col) for col in zip(*info))
    pk = k0[:, None] + torch.arange(KEY_TILE)
    summed = []
    for e in range(int((nhc * nq).max())):
        pos, hi, live = step_rows(hq, hkv, s, qb, nq, e)
        vis = ((e < nhc * nq)[:, None, None] & live[..., None]
               & _visible(pos[..., None], pk[:, None, :], s, causal, window))
        u, r, j = np.nonzero(vis.numpy())
        summed += zip(bb[u].tolist(), (hk[u] * g + hi[u, r]).tolist(),
                      pos[u, r].tolist(), pk[u, j].tolist())
    pos = np.arange(s)
    mask = np.ones((s, s), bool)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    want = {(x, h, pq, kk) for x in range(b) for h in range(hq)
            for pq, kk in zip(*np.nonzero(mask))}
    assert len(summed) == len(set(summed)) and set(summed) == want


@pytest.mark.parametrize("case", SEAMS + SEAMS_112)
def test_mirror_matches_reference_vjp_at_seams(case):
    b, s, hq, hkv, hd, causal, window = case
    err = _check(case, seed=s * 7 + hd + hq)
    print(f"PARITY attention dkdv tiles seam S={s} g={hq // hkv} hd={hd} "
          f"causal={causal} window={window}: max_abs_err={err:.3g} "
          f"tol={TOL}")


@pytest.mark.parametrize("case", CHIP_CASES)
def test_mirror_matches_reference_vjp_at_chip_cases(case):
    err = _check(case, seed=case[1] + case[4])
    print(f"PARITY attention dkdv tiles {case}: max_abs_err={err:.3g} "
          f"tol={TOL}")


@pytest.mark.parametrize("s,hq,hkv,causal,window", [
    (16, 4, 2, True, None), (100, 4, 2, True, 16), (33, 8, 2, False, 17),
    (17, 2, 2, False, None), (9, 40, 1, True, None)])
def test_mirror_is_batch_invariant(s, hq, hkv, causal, window):
    """Sequences 0 and 3 alone give the bits of the same rows among 8."""
    q, k, v, do = map(torch.from_numpy, _inputs(8, s, hq, hkv, 32, seed=s))
    lse, dsum = _stats(q, k, v, do, causal, window)
    dk, dv = unit_dkdv(q, k, v, lse, do, dsum, causal=causal, window=window)
    for i in (0, 3):
        one = slice(i, i + 1)
        dki, dvi = unit_dkdv(q[one], k[one], v[one], lse[one], do[one],
                             dsum[one], causal=causal, window=window)
        assert torch.equal(dki, dk[one]) and torch.equal(dvi, dv[one])
