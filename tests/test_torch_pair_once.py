"""What the ni and cos-matrix CUDA kernels rely on when they visit each
unordered pair of a row once, checked on the CPU in f64 with Python mirrors
of the kernels' index arithmetic (the kernels themselves run only on the
card, tests/test_torch_cuda.py):

  * csrc/ni_bp.cu `list_pairs`: candidate t of a row with n compacted slots
    (n <= 256) is the pair (j, j + d mod n), d = t / n + 1, j = t mod n,
    with t / n taken as the high word of t * ceil(2^32 / n) (`div_magic`);
    the candidates go 32 a round into tiles of at most 512 listed pairs,
    a tile closed when it could not take another round;
  * csrc/annp_cos.cu: thread j of a row with n_act active lanes takes
    k = j + d mod n_act for d = 1 .. n_act / 2, the half step d = n_act / 2
    only for j < n_act / 2 when n_act is even;
  * csrc/annp_gcos.cu: the same steps, but a part-full last warp's lanes
    may be dealt in chunks to the threads of the full warps, and partners
    are read from a doubled array at j + d without a wrap;
  * ni_g's stage 2: G4 = 1/2 sum_{p != q} equals the sum over the listed
    unordered pairs, each once and undoubled, when the list admits a pair by
    both legs inside Rc and r_jk^2 < Rc^2 from the law of cosines.
"""
import numpy as np
import pytest

from meng_zhang_tpu_torch.ops import fused_ni as fn
from meng_zhang_tpu_torch.testing import synthetic_ni_potential
from meng_zhang_tpu_torch.units import CFLENGTH
from torch_port_util import ni_short_planes, reduced_ni_potential, t64


TILE = 512              # ni_bp.cu kTile


def div_magic(n):
    """ni_bp.cu div_magic: ceil(2^32 / n) as a 32-bit word (n > 1)."""
    return 0xFFFFFFFF // n + 1 if n > 1 else 0


def ni_pair_map(n):
    """list_pairs' candidates for n compacted slots: [(t, d - 1, j, k)]."""
    magic = div_magic(n)
    out = []
    for t in range(n * (n - 1) // 2):
        dd = (t * magic) >> 32
        j = t - dd * n
        k = j + dd + 1
        if k >= n:
            k -= n
        out.append((t, dd, j, k))
    return out


def ni_pair_tiles(n_cand, admit):
    """The tiles that list_pairs fills, as the kernels' tile loop calls it:
    [[admitted candidate t, ...], ...]; admit(t) says whether candidate t's
    third leg lies inside the cutoff."""
    tiles, cand = [], 0
    while True:                         # do { ... } while (cand < n_cand)
        tile = []
        while cand < n_cand and len(tile) <= TILE - 32:
            tile += [t for t in range(cand, min(cand + 32, n_cand))
                     if admit(t)]
            cand += 32
        tiles.append(tile)
        if cand >= n_cand:
            return tiles


@pytest.mark.parametrize("n", list(range(33)) + [33, 63, 64, 65, 86, 100,
                                                 127, 128, 129, 200, 255,
                                                 256])
def test_ni_pair_map_visits_each_pair_once(n):
    pairs = ni_pair_map(n)
    assert all(dd == t // n for t, dd, _, _ in pairs)
    assert all(0 <= j < n and 0 <= k < n and j != k for _, _, j, k in pairs)
    seen = sorted((min(j, k), max(j, k)) for _, _, j, k in pairs)
    assert seen == [(j, k) for j in range(n) for k in range(j + 1, n)]
    # the pair fits the list's 16-bit j | k << 8
    assert all(j | (k << 8) < 1 << 16 for _, _, j, k in pairs)


@pytest.mark.parametrize("n,share", [(0, 1.0), (2, 1.0), (32, 1.0),
                                     (32, 0.5), (86, 0.6), (128, 1.0),
                                     (256, 0.3), (256, 1.0)])
def test_ni_pair_tiles_cover_the_candidates(n, share):
    """Every admitted candidate lands in one tile, in order, no tile holds
    more than TILE pairs, and a row of <= 32 slots is one tile."""
    n_cand = n * (n - 1) // 2
    rng = np.random.default_rng(n)
    keep = rng.random(n_cand) < share
    tiles = ni_pair_tiles(n_cand, lambda t: bool(keep[t]))
    assert max(len(tile) for tile in tiles) <= TILE
    assert [t for tile in tiles for t in tile] == list(np.flatnonzero(keep))
    if n <= 32:
        assert len(tiles) == 1
    else:
        # a tile closes only when another round could overflow it
        assert all(len(tile) > TILE - 32 for tile in tiles[:-1])


def cos_schedule(n_act):
    """The cos kernels' (j, k) visits of a row with n_act active lanes."""
    out = []
    for tid in range(n_act):
        nd = (n_act - 1) // 2 + int(n_act % 2 == 0 and tid < n_act // 2)
        kk = tid
        for _ in range(nd):
            kk = 0 if kk + 1 == n_act else kk + 1
            out.append((tid, kk))
    return out


@pytest.mark.parametrize("n_act", [0, 1, 2, 3, 107, 108, 128, 191, 192, 255,
                                   256])
def test_cos_schedule_visits_each_pair_once(n_act):
    visits = cos_schedule(n_act)
    seen = sorted((min(j, k), max(j, k)) for j, k in visits)
    assert seen == [(j, k) for j in range(n_act)
                    for k in range(j + 1, n_act)]
    # no thread takes more than n_act / 2 steps: the block's loop length
    per_thread = np.bincount([j for j, _ in visits], minlength=max(n_act, 1))
    assert per_thread.max(initial=0) <= n_act // 2


def g_cos_schedule(n_act, threads):
    """g_cos_kernel's (thread, j, slot of k in the doubled array) visits in
    a block of `threads` threads, and whether it dealt the last warp's
    lanes."""
    nd = (n_act - 1) // 2
    rest = n_act & 31
    full = n_act - rest
    per = full // rest if rest else 0
    chunk = (nd + per - 1) // per if per else 0
    deal = (per > 0 and chunk * (full // 32) < nd
            and 2 * (full // 32) > threads // 32)
    busy = full if deal else n_act
    out = []
    for tid in range(busy):
        cnt = nd + int(n_act % 2 == 0 and tid < n_act // 2)
        out += [(tid, tid, tid + 1 + d) for d in range(cnt)]
        if deal:
            c = tid // rest
            d0 = c * chunk
            if d0 < nd:
                j = full + tid - c * rest
                cnt = chunk if d0 + chunk < nd else nd - d0
                out += [(tid, j, j + d0 + 1 + d) for d in range(cnt)]
    return out, deal


@pytest.mark.parametrize("n_act,threads", [
    (0, 32), (1, 32), (2, 32), (3, 64), (4, 128), (31, 32), (32, 32),
    (33, 64), (63, 64), (64, 64), (65, 96), (97, 128), (107, 128),
    (108, 128), (108, 192), (127, 128), (128, 128), (128, 256), (191, 192),
    (192, 192), (225, 256), (255, 256), (256, 256)])
def test_g_cos_schedule_visits_each_pair_once(n_act, threads):
    visits, deal = g_cos_schedule(n_act, threads)
    assert all(j < n_act and slot < 2 * n_act for _, j, slot in visits)
    seen = sorted((min(j, s % n_act), max(j, s % n_act))
                  for _, j, s in visits)
    assert seen == [(j, k) for j in range(n_act)
                    for k in range(j + 1, n_act)]
    # dealing never costs the block more warp-steps than the plain schedule
    steps = np.bincount([t for t, _, _ in visits], minlength=threads)
    warps = [int(steps[w:w + 32].max()) for w in range(0, threads, 32)]
    assert sum(warps) <= -(-n_act // 32) * (n_act // 2)
    if n_act == 108:                    # the fe scene's usual row
        assert (deal, warps[:3]) == ((True, [61, 61, 60]) if threads == 128
                                     else (False, [54, 54, 53]))


def g4_pairs_once(dxx, dxy, dxz, table):
    """The angular columns of ni_g as its kernel sums them: per row the
    lanes inside Rc compacted in lane order, list_pairs' candidates admitted
    by r_jk^2 < Rc^2, each listed pair's term added once. numpy, f64."""
    _, rc_a, ang = table
    p, _ = dxx.shape
    g = np.zeros((p, fn.NSF_SUB))
    listed = 0
    for i in range(p):
        d = np.stack([dxx[i], dxy[i], dxz[i]], -1)
        rsq = (d * d).sum(-1)
        valid = rsq > 1.0e-12
        r = np.sqrt(np.where(valid, rsq, 1.0))
        a = r * CFLENGTH
        lanes = np.flatnonzero(valid & (a < rc_a))
        u, a = d[lanes] / r[lanes, None], a[lanes]
        fc = 0.5 * (np.cos(np.pi * a / rc_a) + 1.0)
        cand = ni_pair_map(len(lanes))
        if not cand:
            continue
        j, k = (np.array([c[i_] for c in cand]) for i_ in (2, 3))
        cs = (u[j] * u[k]).sum(-1)
        rjk2 = a[j] ** 2 + a[k] ** 2 - 2.0 * a[j] * a[k] * cs
        ok = rjk2 < rc_a * rc_a
        j, k, cs, rjk2 = j[ok], k[ok], cs[ok], rjk2[ok]
        listed += len(j)
        rjk = np.sqrt(np.maximum(rjk2, 1.0e-12))
        fc3 = fc[j] * fc[k] * 0.5 * (np.cos(np.pi * rjk / rc_a) + 1.0)
        r2sum = a[j] ** 2 + a[k] ** 2 + rjk2
        for eta, fns in ang:
            t_eta = np.exp(-eta * r2sum) * fc3
            for lam, zeta, col in fns:
                g[i, col] = (2.0 ** (1.0 - zeta) * (1.0 + lam * cs) ** zeta
                             * t_eta).sum()
    return g, listed


def _odd(coeang):
    """Zetas 3 and 6 (no powers of two) and one function moved into the
    first eta group, as chip_smoke.py's pow-route table."""
    coeang = np.array(coeang, dtype=np.float64)
    coeang[1, 2], coeang[13, 2], coeang[16, 0] = 3.0, 6.0, coeang[0, 0]
    return coeang


@pytest.mark.parametrize("width", ["reduced", "full", "full-odd", "wide"])
def test_g4_over_listed_pairs_once_matches_plain(width):
    """"wide": Rc 6.0 A, Ks 128, ~86 partners a row and thousands of
    listed pairs, over the tiles' boundaries."""
    pot = {"reduced": reduced_ni_potential,
           "wide": lambda: synthetic_ni_potential(
               0, rc_bohr=6.0 * CFLENGTH)}.get(
        width, lambda: synthetic_ni_potential(0))()
    ks = {"reduced": 16, "wide": 128}.get(width, 32)
    rc_s = float(pot.sym_coeang[0, 3]) / CFLENGTH + 0.2
    planes, filler = ni_short_planes(rc_s, ks, n_cells=4 if width == "wide"
                                     else 3, seed=5, capacity=160)
    assert filler.any()                      # filler lanes take part
    table = fn.ni_table(pot.sym_coerad, _odd(pot.sym_coeang)
                        if width.endswith("odd") else pot.sym_coeang)
    want = fn.ni_g_plain(*(t64(a) for a in planes), table).numpy()
    got, listed = g4_pairs_once(*planes, table)
    assert listed > 10 * len(planes[0])      # the rows do hold leg pairs
    nrad = len(table.rad)
    cols = [col for _, fns in table.ang for _, _, col in fns]
    assert sorted(cols) == list(range(nrad, nrad + len(cols)))
    scale = np.abs(want[:, cols]).max(0)
    assert (scale > 0).all()
    assert (np.abs(got[:, cols] - want[:, cols]).max(0)
            <= 1.0e-12 * scale).all()
