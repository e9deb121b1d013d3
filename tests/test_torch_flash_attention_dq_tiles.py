"""The flash-attention dQ kernel's partition, mirrored in float32 on the
CPU, against the reference.

:func:`unit_dq` is ``csrc/flash_attention.cu::dq_kernel`` term for term,
vectorised over its units: the forward's units of 32 query rows (hc =
min(g, 32) query heads of a KV head's group by 32 / hc positions) in the
kernel's order; D = rowsum(dO o) of a unit's rows, eight lanes a row, lane
l over the 16-byte chunks l, l + 8, ... in order, then the xor butterfly;
key tiles of 16 aligned to multiples of 16 from the tile of a unit's first
visible key to that of its last; s = q.k and dp = dO.v as four partial
sums over the head dim (element d into sum d mod 4, then (s0 + s1) + (s2 +
s3)); p = exp(s scale - lse) and dp - D, each 0 where masked, dS = p (dp -
D); dQ += dS K over a tile's keys in order, tiles in order; dQ scaled once
at the end.  It differs from the kernel only where the kernel fuses a
multiply and an add.

* The partition sums every (visible key, query row, head) pair exactly
  once, and no other, and owns every query row once, also for a group of
  40 heads cut into chunks of 32.
* The mirror against ``jax.vjp`` of the reference's ``attention_ref`` (the
  TPU package has no backward kernel; D against rowsum(dO o) of the
  reference's o) and against the port's ``flash_attention_bwd_dq_plain``:
  at the seams S ∈ {1, 15, 16, 17, 33}, window ∈ {None, 1, 8, 16, 17},
  causal and not, with g ∈ {1, 2, 4} and hd ∈ {32, 64, 128} taken in
  turn, at head dim 112 (5 more seams: 28 chunks a row, lanes 0-3 take
  four, lanes 4-7 three), and at chip_smoke's attention cases with B cut
  to 2.  1e-4, the
  backward's tolerance.
* Batch invariance: a sequence alone and inside a batch give the same
  bits of dq and D."""
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_ref

from repro_torch.kernels import flash_attention as fa

UNIT_ROWS = 32       # query rows of a unit (csrc kUnitRows)
KEY_TILE = 16        # keys of a tile (csrc kKeyTile)
D_LANES = 8          # threads a row for D (csrc kDLanes)
VEC = 4              # floats of a 16-byte chunk
TOL = 1e-4


def plan(s: int, hq: int, hkv: int):
    """(g, hc, qt, nhc, nqt) as ``fwd_plan``: heads of the group, heads of
    a unit, positions of a unit, head chunks and query tiles."""
    g = hq // hkv
    hc = min(g, UNIT_ROWS)
    qt = UNIT_ROWS // hc
    return g, hc, qt, -(-g // hc), -(-s // qt)


def units(b: int, s: int, hq: int, hkv: int, causal: bool, window):
    """Every unit in the kernel's order (query tile fastest, then head
    chunk, KV head, sequence): (b, hk, t_begin, t_end) of shape (U,) each,
    and its rows' positions (-1 for a row of no (position, head)) and
    heads, of shape (U, 32)."""
    g, hc, qt, nhc, nqt = plan(s, hq, hkv)
    info, pos, head = [], [], []
    r = np.arange(UNIT_ROWS)
    for bb, hk, c, t in itertools.product(range(b), range(hkv), range(nhc),
                                          range(nqt)):
        q0 = t * qt
        hi = min(q0 + qt, s) if causal else s
        lo = max(0, q0 - window + 1) if window is not None else 0
        info.append((bb, hk, lo // KEY_TILE, -(-hi // KEY_TILE)))
        p, hig = q0 + r // hc, c * hc + r % hc
        pos.append(np.where((r < qt * hc) & (p < s) & (hig < g), p, -1))
        head.append(hk * g + hig)
    cols = (torch.tensor(col) for col in zip(*info))
    return (*cols, torch.from_numpy(np.stack(pos)),
            torch.from_numpy(np.stack(head)))


def _visible(pos, pk, s, causal, window):
    vis = (pos >= 0) & (pk < s)
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


def _row_sums(dor, orow):
    """D of (U, 32, hd) rows: lane l of a row sums the elements of chunks
    l, l + 8, ... (as many as the row has) in order, then the lanes' xor
    butterfly (4, 2, 1)."""
    u, rows, hd = dor.shape
    prod = (dor * orow).reshape(u, rows, hd // VEC, VEC)
    lanes = torch.zeros((u, rows, D_LANES))
    for c in range(hd // VEC):
        for w in range(VEC):
            lanes[..., c % D_LANES] = lanes[..., c % D_LANES] + prod[:, :, c,
                                                                     w]
    idx = torch.arange(D_LANES)
    off = D_LANES // 2
    while off:
        lanes = lanes + lanes[..., idx ^ off]
        off //= 2
    return lanes[..., 0]


def unit_dq(q, k, v, o, lse, do, *, causal: bool = True, window=None):
    """``(dq, D)`` by the kernel's units, tiles and order of the sums in
    float32: q, o, do (B, S, Hq, hd), k, v (B, S, Hkv, hd), lse (B, Hq, S);
    dq like q, D (B, Hq, S)."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    bb, hk, t_begin, t_end, pos, head = units(b, s, hq, hkv, causal, window)
    live = pos >= 0
    zero = torch.tensor(0.0)
    ub, p_, h_ = bb[:, None], pos.clamp(min=0), head.clamp(max=hq - 1)
    rows = lambda x: torch.where(  # noqa: E731
        live[..., None], x.float()[ub, p_, h_], zero)
    qu, dou = rows(q), rows(do)                                 # (U, 32, hd)
    dr = torch.where(live, _row_sums(dou, rows(o)), zero)
    lr = torch.where(live, lse[ub, h_, p_], zero)
    acc = torch.zeros(qu.shape)
    scale = 1.0 / math.sqrt(hd)
    for t in range(int(t_begin.min()), int(t_end.max())):
        active = ((t_begin <= t) & (t < t_end))[:, None, None]
        pk = t * KEY_TILE + torch.arange(KEY_TILE)
        kin = pk < s
        tile = lambda x: torch.where(  # noqa: E731
            kin[None, :, None], x.float()[ub, pk.clamp(max=s - 1)[None, :],
                                          hk[:, None]], zero)
        kt, vt = tile(k), tile(v)                               # (U, 16, hd)
        vis = _visible(pos[..., None], pk[None, None, :], s, causal, window)
        p = torch.where(vis, torch.exp(_four_sums(qu, kt) * scale
                                       - lr[..., None]), zero)
        ds = p * torch.where(vis, _four_sums(dou, vt) - dr[..., None], zero)
        nxt = acc
        for j in range(KEY_TILE):
            nxt = nxt + ds[..., j:j + 1] * kt[:, None, j, :]
        acc = torch.where(active, nxt, acc)
    dq = torch.zeros((b, s, hq, hd))
    dsum = torch.zeros((b, hq, s))
    ub = ub.expand_as(pos)
    dq[ub[live], pos[live], head[live]] = (acc * scale)[live]
    dsum[ub[live], head[live], pos[live]] = dr[live]
    return dq, dsum


def _inputs(b, s, hq, hkv, hd, seed):
    """q, k, v and dO, float32 numpy from a seed."""
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, s, h, hd)).astype(np.float32)
                 for h in (hq, hkv, hkv, hq))


def _reference(q, k, v, do, causal, window):
    """dQ from ``jax.vjp`` of the reference's ``attention_ref`` over the
    (BH, S, hd) layout after the GQA expansion, as (B, S, Hq, hd), and D =
    rowsum(dO o) of the reference's o, as (B, Hq, S); float32 numpy."""
    b, s, hq, hd = q.shape
    g = hq // k.shape[2]

    def bhsd(a, rep=1):
        a = np.repeat(a, rep, axis=2).transpose(0, 2, 1, 3)
        return jnp.asarray(a.reshape(b * hq, s, hd))
    out, vjp = jax.vjp(lambda *a: ref_ref.attention_ref(
        *a, causal=causal, window=window), bhsd(q), bhsd(k, g), bhsd(v, g))
    dq, _, _ = vjp(bhsd(do))
    back = lambda x: np.asarray(x, np.float32).reshape(  # noqa: E731
        b, hq, s, hd).transpose(0, 2, 1, 3)
    return back(dq), (do * back(out)).sum(-1).transpose(0, 2, 1)


def _parity(got, want, tol=TOL):
    got = np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    return float(np.abs(got - want).max())


def _check(case, seed):
    b, s, hq, hkv, hd, causal, window = case
    q, k, v, do = _inputs(b, s, hq, hkv, hd, seed)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    opts = dict(causal=causal, window=window)
    o, lse = fa.flash_attention_fwd_plain(tq, tk, tv, **opts)
    dq, dsum = unit_dq(tq, tk, tv, o, lse, tdo, **opts)
    pdq, pdsum = fa.flash_attention_bwd_dq_plain(tq, tk, tv, o, lse, tdo,
                                                 **opts)
    rdq, rdsum = _reference(q, k, v, do, causal, window)
    return max(_parity(dq, rdq), _parity(dsum, rdsum),
               _parity(pdq, dq.numpy()), _parity(pdsum, dsum.numpy()))


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
    g, _, _, nhc, nqt = plan(s, hq, hkv)
    bb, hk, t_begin, t_end, pos, head = units(b, s, hq, hkv, causal, window)
    assert len(bb) == b * hkv * nhc * nqt
    live = pos >= 0
    owned = list(zip(bb[:, None].expand_as(pos)[live].tolist(),
                     head[live].tolist(), pos[live].tolist()))
    assert len(owned) == len(set(owned)) == b * hq * s
    summed = []
    for t in range(int(t_begin.min()), int(t_end.max())):
        pk = t * KEY_TILE + torch.arange(KEY_TILE)
        vis = (((t_begin <= t) & (t < t_end))[:, None, None]
               & _visible(pos[..., None], pk[None, None, :], s, causal,
                          window))
        u, r, j = np.nonzero(vis.numpy())
        summed += zip(bb[u].tolist(), head[u, r].tolist(),
                      pos[u, r].tolist(), pk[j].tolist())
    p = np.arange(s)
    mask = np.ones((s, s), bool)
    if causal:
        mask &= p[None, :] <= p[:, None]
    if window is not None:
        mask &= p[None, :] > p[:, None] - window
    want = {(x, h, pq, kk) for x in range(b) for h in range(hq)
            for pq, kk in zip(*np.nonzero(mask))}
    assert len(summed) == len(set(summed)) and set(summed) == want


@pytest.mark.parametrize("case", SEAMS + SEAMS_112)
def test_mirror_matches_reference_vjp_at_seams(case):
    b, s, hq, hkv, hd, causal, window = case
    err = _check(case, seed=s * 7 + hd + hq)
    print(f"PARITY attention dq tiles seam S={s} g={hq // hkv} hd={hd} "
          f"causal={causal} window={window}: max_abs_err={err:.3g} "
          f"tol={TOL}")


@pytest.mark.parametrize("case", CHIP_CASES)
def test_mirror_matches_reference_vjp_at_chip_cases(case):
    err = _check(case, seed=case[1] + case[4])
    print(f"PARITY attention dq tiles {case}: max_abs_err={err:.3g} "
          f"tol={TOL}")


@pytest.mark.parametrize("s,hq,hkv,causal,window", [
    (16, 4, 2, True, None), (100, 4, 2, True, 16), (33, 8, 2, False, 17),
    (17, 2, 2, False, None), (9, 40, 1, True, None)])
def test_mirror_is_batch_invariant(s, hq, hkv, causal, window):
    """Sequences 0 and 3 alone give the bits of the same rows among 8."""
    q, k, v, do = map(torch.from_numpy, _inputs(8, s, hq, hkv, 32, seed=s))
    opts = dict(causal=causal, window=window)
    o, lse = fa.flash_attention_fwd_plain(q, k, v, **opts)
    dq, dsum = unit_dq(q, k, v, o, lse, do, **opts)
    for i in (0, 3):
        one = slice(i, i + 1)
        dqi, dsi = unit_dq(q[one], k[one], v[one], o[one], lse[one], do[one],
                           **opts)
        assert torch.equal(dqi, dq[one]) and torch.equal(dsi, dsum[one])
