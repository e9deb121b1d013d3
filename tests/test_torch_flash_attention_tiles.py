"""The flash-attention forward kernel's partition, mirrored in float32 on
the CPU, against the reference.

:func:`unit_attention` is ``csrc/flash_attention.cu::fwd_kernel`` term
for term, vectorised over its units: units of 32 query rows (hc =
min(g, 32) query heads of a KV head's group by 32 / hc positions), key
tiles of 16 aligned to multiples of 16 from the tile of a unit's first
visible key to that of its last, scores as four partial sums over the
head dim (element d into sum d mod 4), the row max and sum by the
half-warp's xor butterfly, masked scores given p = 0, P.V in key order,
and o = acc * (1 / max(l, 1e-30)), lse = m + log(l).  It differs from
the kernel only where the kernel fuses a multiply and an add.

* The partition covers every (sequence, head, position) row once, and a
  unit's tiles hold every key its rows can see (and tiles outside hold
  none), also for a group of 40 heads cut into chunks of 32.
* The mirror against the reference's Pallas kernel in interpret mode
  (block = S, so S always divides it) and ``attention_ref``: at the
  seams S ∈ {1, 15, 16, 17, 33}, window ∈ {None, 1, 8, 16, 17}, causal
  and not, with g ∈ {1, 2, 4} and hd ∈ {32, 64, 128} taken in turn; at
  chip_smoke's attention cases with B cut to 2; and in bfloat16.  2e-5
  (bfloat16 2e-2).
* Batch invariance: a sequence alone and inside a batch give the same
  bits, so do its rows whatever the batch around them.
* The plain forward (what the kernel is held against on the card) and
  the mirror agree with each other to 2e-5 at every seam."""
import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_ref
from repro.kernels.flash_attention import flash_attention_bhsd

from repro_torch.kernels import flash_attention as fa

UNIT_ROWS = 32       # query rows of a unit (csrc kUnitRows)
KEY_TILE = 16        # keys of a tile (csrc kKeyTile)
NEG_INF = -1e30


def plan(s: int, hq: int, hkv: int):
    """(g, hc, qt, nhc, nqt) as ``fwd_plan``: heads of the group, heads of
    a unit, positions of a unit, head chunks and query tiles."""
    g = hq // hkv
    hc = min(g, UNIT_ROWS)
    qt = UNIT_ROWS // hc
    return g, hc, qt, -(-g // hc), -(-s // qt)


def units(b: int, s: int, hq: int, hkv: int, causal: bool, window):
    """Every unit in the kernel's order (query tile fastest, then head
    chunk, KV head, sequence): (b, hk, chunk, q0, t_begin, t_end), and its
    rows as (position or -1, head) pairs of shape (U, 32)."""
    g, hc, qt, nhc, nqt = plan(s, hq, hkv)
    out, pos, head = [], [], []
    for bb, hk, c, t in itertools.product(range(b), range(hkv), range(nhc),
                                          range(nqt)):
        q0 = t * qt
        hi = min(q0 + qt, s) if causal else s
        lo = max(0, q0 - window + 1) if window is not None else 0
        out.append((bb, hk, c, q0, lo // KEY_TILE, -(-hi // KEY_TILE)))
        r = np.arange(UNIT_ROWS)
        p, hig = q0 + r // hc, c * hc + r % hc
        live = (r < qt * hc) & (p < s) & (hig < g)
        pos.append(np.where(live, p, -1))
        head.append(hk * g + hig)
    return out, np.stack(pos), np.stack(head)


def _butterfly(x, op):
    """The half-warp's xor reduction over the last axis (16 keys): every
    lane ends with the same bits."""
    lanes = torch.arange(KEY_TILE)
    off = KEY_TILE // 2
    while off:
        x = op(x, x[..., lanes ^ off])
        off //= 2
    return x


def unit_attention(q, k, v, *, causal: bool = True, window=None):
    """``(o, lse)`` by the kernel's units, tiles and online-softmax order in
    float32: q (B, S, Hq, hd), k, v (B, S, Hkv, hd); o in q's type, lse
    (B, Hq, S) float32."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    info, pos, head = units(b, s, hq, hkv, causal, window)
    bb = torch.tensor([u[0] for u in info])
    hk = torch.tensor([u[1] for u in info])
    t_begin = torch.tensor([u[4] for u in info])
    t_end = torch.tensor([u[5] for u in info])
    pos, head = torch.from_numpy(pos), torch.from_numpy(head)
    live = pos >= 0
    qf, kf, vf = q.float(), k.float(), v.float()
    qu = torch.where(live[..., None],
                     qf[bb[:, None], pos.clamp(min=0), head.clamp(max=hq - 1)],
                     torch.tensor(0.0))                        # (U, 32, hd)
    n = len(info)
    m = torch.full((n, UNIT_ROWS, 1), NEG_INF)
    l = torch.zeros((n, UNIT_ROWS, 1))
    acc = torch.zeros((n, UNIT_ROWS, hd))
    scale = 1.0 / math.sqrt(hd)
    for t in range(int(t_begin.min()), int(t_end.max())):
        active = ((t_begin <= t) & (t < t_end))[:, None, None]
        pk = t * KEY_TILE + torch.arange(KEY_TILE)
        kin = pk < s
        gather = lambda x: torch.where(  # noqa: E731
            kin[None, :, None], x[bb[:, None], pk.clamp(max=s - 1)[None, :],
                                  hk[:, None]], torch.tensor(0.0))
        kt, vt = gather(kf), gather(vf)                        # (U, 16, hd)
        part = [torch.zeros((n, UNIT_ROWS, KEY_TILE)) for _ in range(4)]
        for d in range(hd):
            part[d % 4] = part[d % 4] + qu[:, :, None, d] * kt[:, None, :, d]
        sc = (part[0] + part[1]) + (part[2] + part[3])
        vis = live[..., None] & kin[None, None, :]
        if causal:
            vis &= pk[None, None, :] <= pos[..., None]
        if window is not None:
            vis &= pk[None, None, :] > pos[..., None] - window
        sc = torch.where(vis, sc * scale, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, _butterfly(sc, torch.maximum)[..., :1])
        p = torch.where(vis, torch.exp(sc - m_new), torch.tensor(0.0))
        corr = torch.exp(m - m_new)
        l_new = l * corr + _butterfly(p, torch.add)[..., :1]
        acc_new = acc * corr
        for j in range(KEY_TILE):
            acc_new = acc_new + p[..., j:j + 1] * vt[:, None, j, :]
        m = torch.where(active, m_new, m)
        l = torch.where(active, l_new, l)
        acc = torch.where(active, acc_new, acc)
    o_rows = acc * (1.0 / torch.clamp(l, min=1e-30))
    lse_rows = (m + torch.log(l))[..., 0]
    o = torch.zeros((b, s, hq, hd))
    lse = torch.zeros((b, hq, s))
    ub = bb[:, None].expand_as(pos)
    o[ub[live], pos[live], head[live]] = o_rows[live]
    lse[ub[live], head[live], pos[live]] = lse_rows[live]
    return o.to(q.dtype), lse


def _inputs(b, s, hq, hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, s, h, hd)).astype(np.float32)
                 for h in (hq, hkv, hkv))


def _reference(q, k, v, causal, window, dtype=jnp.float32):
    """The reference's Pallas kernel in interpret mode (blocks of S) and
    its ``attention_ref``, over the (BH, S, hd) layout after the GQA
    expansion, back in (B, S, Hq, hd) as float32 numpy."""
    b, s, hq, hd = q.shape
    g = hq // k.shape[2]

    def bhsd(a, rep=1):
        a = np.repeat(a, rep, axis=2).transpose(0, 2, 1, 3)
        return jnp.asarray(a.reshape(b * hq, s, hd), dtype)
    args = (bhsd(q), bhsd(k, g), bhsd(v, g))
    back = lambda x: np.asarray(x, np.float32).reshape(  # noqa: E731
        b, hq, s, hd).transpose(0, 2, 1, 3)
    kernel = flash_attention_bhsd(*args, causal=causal, window=window,
                                  block_q=s, block_k=s, interpret=True)
    oracle = ref_ref.attention_ref(*args, causal=causal, window=window)
    return back(kernel), back(oracle)


def _parity(got, want, tol):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    return float(np.abs(got - want).max())


# the seams (B, S, Hq, Hkv, hd, causal, window): each (S, window, causal)
# once, the (g, hd) pairs taken in turn
SEAMS = [
    (2, s, 2 * g, 2, hd, causal, window)
    for i, (s, window, causal) in enumerate(
        (s, w, c) for s in (1, 15, 16, 17, 33)
        for w in (None, 1, 8, 16, 17) for c in (True, False))
    for g, hd in [((1, 2, 4)[i % 3], (32, 64, 128)[i // 3 % 3])]]

# chip_smoke's attention cases with B cut to 2
CHIP_CASES = [(2, 16, 4, 2, 64, True, None), (2, 128, 4, 2, 64, True, None),
              (2, 256, 4, 2, 128, True, 64), (2, 100, 4, 2, 64, True, 16),
              (2, 100, 4, 2, 128, False, None),
              (2, 256, 4, 1, 64, False, 16)]


@pytest.mark.parametrize("s,hq,hkv", [(16, 4, 2), (17, 4, 2), (33, 4, 4),
                                      (100, 6, 3), (5, 80, 2), (40, 8, 1)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 8),
                                           (False, None), (False, 5)])
def test_partition_covers_each_row_once_and_its_visible_keys(s, hq, hkv,
                                                             causal, window):
    b = 2
    info, pos, head = units(b, s, hq, hkv, causal, window)
    g, hc, qt, nhc, nqt = plan(s, hq, hkv)
    assert len(info) == b * hkv * nhc * nqt
    rows = [(info[u][0], head[u, r], pos[u, r]) for u in range(len(info))
            for r in range(UNIT_ROWS) if pos[u, r] >= 0]
    assert len(rows) == len(set(rows)) == b * hq * s
    keys = np.arange(s)
    for u, (_, hk, _, _, t0, t1) in enumerate(info):
        for r in np.flatnonzero(pos[u] >= 0):
            p = pos[u, r]
            assert head[u, r] // g == hk
            vis = np.ones(s, bool)
            if causal:
                vis &= keys <= p
            if window is not None:
                vis &= keys > p - window
            tiles = keys[vis] // KEY_TILE
            assert vis.any() and t0 <= tiles.min() and tiles.max() < t1


@pytest.mark.parametrize("case", SEAMS)
def test_mirror_matches_reference_kernel_at_seams(case):
    b, s, hq, hkv, hd, causal, window = case
    q, k, v = _inputs(b, s, hq, hkv, hd, seed=s * 7 + hd + hq)
    kernel, oracle = _reference(q, k, v, causal, window)
    o, lse = unit_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                            window=window)
    plain_o, plain_lse = fa.flash_attention_fwd_plain(
        *map(torch.from_numpy, (q, k, v)), causal=causal, window=window)
    err = max(_parity(o, kernel, 2e-5), _parity(o, oracle, 2e-5),
              _parity(plain_o, o.numpy(), 2e-5),
              _parity(plain_lse, lse.numpy(), 2e-5))
    print(f"PARITY attention fwd tiles seam S={s} g={hq // hkv} hd={hd} "
          f"causal={causal} window={window}: max_abs_err={err:.3g} tol=2e-05")


@pytest.mark.parametrize("case", CHIP_CASES)
def test_mirror_matches_reference_kernel_at_chip_cases(case):
    b, s, hq, hkv, hd, causal, window = case
    q, k, v = _inputs(b, s, hq, hkv, hd, seed=s + hd)
    kernel, oracle = _reference(q, k, v, causal, window)
    o, lse = unit_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                            window=window)
    _, plain_lse = fa.flash_attention_fwd_plain(
        *map(torch.from_numpy, (q, k, v)), causal=causal, window=window)
    err = max(_parity(o, kernel, 2e-5), _parity(o, oracle, 2e-5),
              _parity(plain_lse, lse.numpy(), 2e-5))
    print(f"PARITY attention fwd tiles {case}: max_abs_err={err:.3g} "
          f"tol=2e-05")


@pytest.mark.parametrize("case", [CHIP_CASES[0], CHIP_CASES[3], SEAMS[13],
                                  SEAMS[40]])
def test_mirror_in_bfloat16_matches_reference_kernel(case):
    b, s, hq, hkv, hd, causal, window = case
    q, k, v = (a.astype(jnp.bfloat16).astype(np.float32)
               for a in _inputs(b, s, hq, hkv, hd, seed=hd))
    kernel, oracle = _reference(q, k, v, causal, window, jnp.bfloat16)
    o, _ = unit_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                          causal=causal, window=window)
    assert o.dtype == torch.bfloat16
    err = max(_parity(o, kernel, 2e-2), _parity(o, oracle, 2e-2))
    print(f"PARITY attention fwd tiles bf16 {case}: max_abs_err={err:.3g} "
          f"tol=2e-02")


@pytest.mark.parametrize("s,hq,hkv,causal,window", [
    (16, 4, 2, True, None), (100, 4, 2, True, 16), (33, 8, 2, False, 17),
    (17, 2, 2, False, None)])
def test_mirror_is_batch_invariant(s, hq, hkv, causal, window):
    """Sequences 0 and 3 alone give the bits of the same rows among 8."""
    q, k, v = map(torch.from_numpy, _inputs(8, s, hq, hkv, 32, seed=s))
    o, lse = unit_attention(q, k, v, causal=causal, window=window)
    for i in (0, 3):
        oi, li = unit_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                causal=causal, window=window)
        assert torch.equal(oi, o[i:i + 1]) and torch.equal(li, lse[i:i + 1])
