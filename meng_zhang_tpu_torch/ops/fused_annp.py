"""Fused-kernel evaluator for the Chebyshev ANNP.

Counterpart of `PallasAnnp` (meng_zhang_tpu/ops/pallas_annp.py:912) on both
of its angular paths:
  * tables `cheb_legendre`, `harm_tables`, `harm_layout` (:229-296), in
    numpy (the JAX module imports jax);
  * `pair_dx_planes` (:577) without the x8 packing and TILE padding;
  * `compact_short_plain` with the rev-free semantics of
    `_compact_block_norev` (:698): rows keep the entries within
    rc + short_delta, ascending by partner id, padded with n; the plain
    twin of the CUDA kernel in csrc/short_list.cu, which `compact_short`
    launches through ops/kernels.py;
  * `g_harm_plain` / `force_harm_plain`: plain PyTorch versions of the two
    harmonic-path TPU kernels `_g_kernel_harm` (:299) and
    `_force_kernel_harm` (:352); their CUDA kernels live in
    csrc/annp_harm.cu. `g_harm_tiles` / `force_harm_tiles` take rows of
    any width through either as tiles (`split_rows`);
  * `g_cos_plain` / `force_cos_plain`: plain PyTorch versions of the two
    cos-matrix TPU kernels `_g_kernel` (:116, row body `_row_g` :88) and
    `_force_kernel` (:193, `_row_force` :131); their CUDA kernels live in
    csrc/annp_cos.cu. All four are launched through ops/kernels.py;
  * `FusedAnnp._mlp_eat_dedg_harm` (:1044) and `_mlp_eat_dedg` (:1017),
    the MLP and its hand VJP, with the per-row network select of
    multi-element potentials (`elems`, :994-995, `_el_rows` :1068);
  * delivery: F_i = -sum_s Fj[i, s] + sum of Fj over the entries whose
    partner is i, as one `index_add_` (the JAX package routes the same sums
    with a sort, `_assemble` :638, because the TPU has no fast scatter);
  * `energy_forces_short` (:1571) with its per-atom tallies (`per_atom`,
    :1578-1585, :1625-1638), `energy_forces` (:1648) and `energy_dedg`
    (:1641).

`element_networks`, `mlp_eat_dedg` and `evaluate_pairs` (gather, delivery,
virial, poisoning; its steps `deliver` and `pair_virial` are functions of
their own, which the per-phase profiles time) are shared with the BP
evaluator (ops/fused_ni.py), as `PairTableOps` (:623) is shared with
`PallasNi` in the JAX package.

Device frames (the sharded drivers, parallel/domain.py): both evaluators
take the frame methods of ops/frames.py (`FrameOps`), as `PairTableOps`
carries them in the JAX package.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import profiling
from ..io.potential import ActivationStyle
from ..models.mlp import _FE_A, _FE_B, _FE_C
from . import kernels
from .frames import FrameOps

NSF_PAD = 128    # g_raw / dedg_rad row width
AB_PAD = 384     # A / B row width: 361 harmonics for L = 18; B col 361 is 2q


# ---------------------------------------------------------------- tables
def cheb_legendre(ntsf):
    """c[n, l] with sum_{j,k} T_n((cos_jk+1)/2) fc_j fc_k = sum_l c_nl S_l
    (Gauss-Legendre, exact: the integrand is a polynomial of degree
    <= 2(ntsf-1) < 128)."""
    nodes, wts = np.polynomial.legendre.leggauss(64)
    xs = 0.5 * (nodes + 1.0)
    t = np.zeros((ntsf, 64))
    t[0] = 1.0
    if ntsf > 1:
        t[1] = xs
    for n in range(2, ntsf):
        t[n] = 2.0 * xs * t[n - 1] - t[n - 2]
    p = np.zeros((ntsf, 64))
    p[0] = 1.0
    if ntsf > 1:
        p[1] = nodes
    for l in range(2, ntsf):
        p[l] = ((2 * l - 1) * nodes * p[l - 1] - (l - 1) * p[l - 2]) / l
    return 2.0 * np.pi * np.einsum("ni,li,i->nl", t, p, wts)


def harm_tables(lmax):
    """Normalized real-harmonic recurrence coefficients (h0, d1, e1, e2).

    Y_lm^c = H_lm(z) c_m(x, y), Y_lm^s = H_lm(z) s_m(x, y) with
    c_m + i s_m = (x + i y)^m form an orthonormal real basis; the ladder
    H_mm = h0[m], H_{m+1,m} = d1[m] z H_mm,
    H_lm = e1[l,m] z H_{l-1,m} - e2[l,m] H_{l-2,m} keeps every value O(1)."""
    alpha = {}
    for l in range(lmax + 1):
        for m in range(l + 1):
            nlm = math.sqrt((2 * l + 1) / (4 * math.pi)
                            * math.factorial(l - m) / math.factorial(l + m))
            alpha[(l, m)] = (math.sqrt(2.0) if m > 0 else 1.0) * nlm
    dfact = 1.0
    h0 = []
    for m in range(lmax + 1):
        if m > 0:
            dfact *= (2 * m - 1)
        h0.append(alpha[(m, m)] * dfact)
    d1 = [(2 * m + 1) * alpha[(m + 1, m)] / alpha[(m, m)]
          for m in range(lmax)]
    e1, e2 = {}, {}
    for m in range(lmax + 1):
        for l in range(m + 2, lmax + 1):
            e1[(l, m)] = ((2 * l - 1) / (l - m)) * alpha[(l, m)] \
                / alpha[(l - 1, m)]
            e2[(l, m)] = ((l + m - 1) / (l - m)) * alpha[(l, m)] \
                / alpha[(l - 2, m)]
    return h0, d1, e1, e2


def harm_layout(lmax):
    """l of each A/B column: m-major, l ascending, cosine then sine."""
    l_of_col = []
    for m in range(lmax + 1):
        for l in range(m, lmax + 1):
            l_of_col.append(l)
            if m > 0:
                l_of_col.append(l)
    return l_of_col


def ladder_table(lmax):
    """The ladder coefficients as one flat float64 array for the CUDA
    kernels: [h0 (L+1) | d1 (L+1, last 0) | e1 (L+1)^2 | e2 (L+1)^2], with
    e1/e2 at index l*(L+1) + m (0 where the recurrence does not use them)."""
    h0, d1, e1, e2 = harm_tables(lmax)
    nl = lmax + 1
    t = np.zeros(2 * nl + 2 * nl * nl)
    t[:nl] = h0
    t[nl:nl + lmax] = d1
    for (l, m), v in e1.items():
        t[2 * nl + l * nl + m] = v
    for (l, m), v in e2.items():
        t[2 * nl + nl * nl + l * nl + m] = v
    return t


# ------------------------------------------------------- pair geometry
def pair_geometry(dxx, dxy, dxz, rc):
    """Per-pair scalars on [P, K] planes; masked lanes get r = 1 before 1/r
    so filler lanes give exactly zero."""
    rsq = dxx * dxx + dxy * dxy + dxz * dxz
    mask = (rsq < rc * rc) & (rsq > 1.0e-12)
    zero = torch.zeros_like(rsq)
    r = torch.sqrt(torch.where(mask, rsq, torch.ones_like(rsq)))
    fc = torch.where(mask, 0.5 * (torch.cos(math.pi / rc * r) + 1.0), zero)
    dfc = torch.where(mask, -0.5 * math.pi / rc
                      * torch.sin(math.pi / rc * r), zero)
    inv_r = 1.0 / r
    m = mask.to(r.dtype)
    return r, fc, dfc, inv_r, m, dxx * inv_r * m, dxy * inv_r * m, \
        dxz * inv_r * m


def pair_dx_planes(x, box, sidx, pbc, row0=0, x_ext=None):
    """dx = x_i - x_j as three [P, K] planes for the neighbor rows sidx
    [P, K] of atoms row0 .. row0 + P - 1, whose partners index x_ext (the
    image-extended table, default x). Filler lanes (sidx == len(x_ext))
    get 2*box + 10 on every axis; the periodic wrap applies per axis."""
    src = x if x_ext is None else x_ext
    p = sidx.shape[0]
    valid = sidx < src.shape[0]
    xp = torch.cat([src, src.new_zeros(1, 3)])
    out = []
    for d in range(3):
        dd = x[row0:row0 + p, d][:, None] - xp[sidx, d]
        if pbc[d]:
            dd = dd - box[d] * torch.round(dd / box[d])
        out.append(torch.where(valid, dd, 2.0 * box[d] + 10.0))
    return out


class ShortList(NamedTuple):
    """Refresh-static short-neighbor list (see compact_short)."""
    sidx: torch.Tensor       # [N, Ks] int64 partner ids, n filler:
                             # ascending from the port's list builds
    ref_x: torch.Tensor      # [N, 3] positions at compaction
    overflow: torch.Tensor   # bool: some row had > Ks entries within rc_s


def compact_short(x, box, nbr_idx, rc_s, ks, pbc, x_ext=None):
    """The short list of compact_short_plain: one launch of the
    hand-written kernel (kernels.compact_short, csrc/short_list.cu) for
    CUDA tensors, which keeps each row's in-range partners in the skin
    row's order and makes no host read; compact_short_plain itself for
    CPU tensors. The two agree where the skin rows are ascending by
    partner id, as every build in system/neighbors.py writes them; rows
    in another order keep it on the card (the same partners, unsorted)."""
    return kernels.compact_short(x, box, nbr_idx, rc_s, ks, pbc, x_ext=x_ext)


def compact_short_plain(x, box, nbr_idx, rc_s, ks, pbc, row_chunk=16384,
                        x_ext=None):
    """Compact each skin-list row to its entries within rc_s, ascending by
    partner id, padded with the sentinel (n, or R*n for rows that index
    the image-extended table x_ext) to Ks columns (rev-free,
    `_compact_block_norev` semantics). The list stays valid while no atom
    moves more than (rc_s - rc)/2 since this call. With tracing on, it
    counts the compaction (nbr.shorts), its partners within rc_s
    (nbr.short_lanes) and its slots, rows x Ks (nbr.short_slots)."""
    n = x.shape[0] if x_ext is None else x_ext.shape[0]
    profiling.count("nbr.shorts", 1)
    profiling.count("nbr.short_slots", x.shape[0] * ks)
    parts = []
    overflow = torch.zeros((), dtype=torch.bool, device=x.device)
    for i0 in range(0, x.shape[0], row_chunk):
        idx_c = nbr_idx[i0:i0 + row_chunk]
        dx, dy, dz = pair_dx_planes(x, box, idx_c, pbc, row0=i0,
                                    x_ext=x_ext)
        rsq = dx * dx + dy * dy + dz * dz
        # filler lanes lie at 2*box + 10 per axis, beyond any rc_s
        mask = (rsq < rc_s * rc_s) & (rsq > 1.0e-12)
        lanes = mask.sum(dim=1)
        profiling.count("nbr.short_lanes", lanes)
        overflow = overflow | (lanes > ks).any()
        key = torch.where(mask, idx_c, torch.full_like(idx_c, n))
        # a copy of the first ks columns, so that the chunk's sorted
        # [row_chunk, K] keys are freed (_compact_rows, system/neighbors.py)
        key = torch.sort(key, dim=1).values[:, :ks].contiguous()
        if key.shape[1] < ks:
            key = torch.cat([key, torch.full((key.shape[0], ks - key.shape[1]),
                                             n, dtype=key.dtype,
                                             device=key.device)], dim=1)
        parts.append(key)
    return ShortList(torch.cat(parts), x, overflow)


# ------------------------------------------- plain versions of the kernels
def _radial_g(r, fc, m, npsf, rc):
    """Radial G_m = sum_j T_m(2r/rc - 1) fc_j, m < npsf (npsf >= 2), as a
    list of [P] columns."""
    xch = 2.0 * r / rc - 1.0
    tp, tc = m, xch * m
    cols = [(tp * fc).sum(1), (tc * fc).sum(1)]
    for _ in range(2, npsf):
        tp, tc = tc, 2.0 * xch * tc - tp
        cols.append((tc * fc).sum(1))
    return cols


def _radial_coeff(r, fc, dfc, m, dedg, npsf, rc):
    """[P, K] radial force coefficient sum_n w_n (T'_n (2/rc) fc + T_n dfc),
    w_n = dedg[:, n]: Fj gains coeff * u_j."""
    def wn(n):
        return dedg[:, n:n + 1]

    xch = 2.0 * r / rc - 1.0
    tp, tc = m, xch * m
    dp, dc = torch.zeros_like(r), m
    coeff = wn(0) * (tp * dfc)
    coeff = coeff + wn(1) * (dc * (2.0 / rc) * fc + tc * dfc)
    for n in range(2, npsf):
        tp, tc, dp, dc = tc, 2.0 * xch * tc - tp, dc, \
            2.0 * tc + 2.0 * xch * dc - dp
        coeff = coeff + wn(n) * (dc * (2.0 / rc) * fc + tc * dfc)
    return coeff


def g_harm_plain(dxx, dxy, dxz, npsf, ntsf, rc):
    """Plain PyTorch `_g_kernel_harm`: (g_raw [P, 128], A [P, 384]).

    g_raw cols [0, npsf) radial G_m = sum_j T_m(2r/rc - 1) fc_j, cols
    [npsf, npsf+ntsf) S_l, col npsf+ntsf F2, rest 0; A holds A_lm in
    harm_layout order, rest 0."""
    lmax = ntsf - 1
    h0, d1, e1, e2 = harm_tables(lmax)
    r, fc, dfc, inv_r, m, ux, uy, uz = pair_geometry(dxx, dxy, dxz, rc)
    cols = _radial_g(r, fc, m, npsf, rc)
    a_cols = []
    s_l = [None] * (lmax + 1)
    cm, sm = m, torch.zeros_like(m)
    for mm in range(lmax + 1):
        if mm > 0:
            cm, sm = ux * cm - uy * sm, ux * sm + uy * cm
        h1 = h2 = None
        for ll in range(mm, lmax + 1):
            if ll == mm:
                h = h0[mm] * m
            elif ll == mm + 1:
                h = d1[mm] * uz * h1
            else:
                h = e1[(ll, mm)] * uz * h1 - e2[(ll, mm)] * h2
            w = fc * h
            ac = (w * cm).sum(1)
            a_cols.append(ac)
            ss = ac * ac
            if mm > 0:
                as_ = (w * sm).sum(1)
                a_cols.append(as_)
                ss = ss + as_ * as_
            s_l[ll] = ss if s_l[ll] is None else s_l[ll] + ss
            h2, h1 = h1, h
    cols.extend(s_l)
    cols.append((fc * fc).sum(1))
    g = torch.stack(cols, 1)
    a = torch.stack(a_cols, 1)
    return (torch.nn.functional.pad(g, (0, NSF_PAD - g.shape[1])),
            torch.nn.functional.pad(a, (0, AB_PAD - a.shape[1])))


def force_harm_plain(dxx, dxy, dxz, dedg_rad, b, npsf, ntsf, rc):
    """Plain PyTorch `_force_kernel_harm`: per-pair Fj = -dE_i/dx_j as three
    [P, K] planes. dedg_rad [P, 128] holds the radial dE/dG columns, b
    [P, 384] the B_lm coefficients in harm_layout order with 2q after them."""
    lmax = ntsf - 1
    h0, d1, e1, e2 = harm_tables(lmax)
    r, fc, dfc, inv_r, m, ux, uy, uz = pair_geometry(dxx, dxy, dxz, rc)
    coeff = _radial_coeff(r, fc, dfc, m, dedg_rad, npsf, rc)

    zero = torch.zeros_like(r)
    sy, gx, gy, gz = zero, zero, zero, zero
    cm, sm = m, zero
    cm1 = sm1 = None
    col = 0
    for mm in range(lmax + 1):
        if mm > 0:
            cm1, sm1 = cm, sm
            cm, sm = ux * cm - uy * sm, ux * sm + uy * cm
        h1 = h2 = hd1 = hd2 = None
        for ll in range(mm, lmax + 1):
            if ll == mm:
                h = h0[mm] * m
                hd = zero
            elif ll == mm + 1:
                h = d1[mm] * uz * h1
                hd = d1[mm] * h1
            else:
                h = e1[(ll, mm)] * uz * h1 - e2[(ll, mm)] * h2
                hd = e1[(ll, mm)] * (h1 + uz * hd1) - e2[(ll, mm)] * hd2
            bc = b[:, col:col + 1]
            col += 1
            if mm > 0:
                bs = b[:, col:col + 1]
                col += 1
                wc = bc * cm + bs * sm
                gx = gx + (mm * h) * (bc * cm1 + bs * sm1)
                gy = gy + (mm * h) * (bs * cm1 - bc * sm1)
            else:
                wc = bc * cm
            sy = sy + h * wc
            gz = gz + hd * wc
            h2, h1 = h1, h
            hd2, hd1 = hd1, hd
    q2 = b[:, col:col + 1]
    udotg = ux * gx + uy * gy + uz * gz
    pref = dfc * (sy + q2 * fc) + fc * inv_r * (-udotg)
    fcr = fc * inv_r
    return ((coeff + pref) * ux + fcr * gx, (coeff + pref) * uy + fcr * gy,
            (coeff + pref) * uz + fcr * gz)


def sum_tiles(part):
    """part [P, T, ...] summed over its T tiles in tile order (a fixed
    order: the tiled kernels' partials add up the same way on every run)."""
    out = part[:, 0]
    for t in range(1, part.shape[1]):
        out = out + part[:, t]
    return out


def split_rows(planes, tile, rc):
    """The [P, K] dx planes of rows wider than a tile as [P T, tile] planes
    of T = ceil(K / tile) virtual rows (row i's tile t is virtual row
    i T + t), K padded to T tile with lanes at 2 rc + 10 on every axis:
    beyond the cutoff, they give exactly 0, as filler lanes do. Returns
    (planes, T)."""
    p, k = planes[0].shape
    t = -(-k // tile)
    out = []
    for d in planes:
        if t * tile > k:
            d = torch.nn.functional.pad(d, (0, t * tile - k),
                                        value=2.0 * rc + 10.0)
        out.append(d.reshape(p * t, tile))
    return out, t


def power_sums(a, ntsf):
    """S_l = sum_m A_lm^2, [P, ntsf], from A [P, 384] in harm_layout order,
    in g_harm_plain's order: m ascending, each m's cosine square then its
    sine square."""
    s = a[:, :ntsf] * a[:, :ntsf]                   # m = 0, l = 0 .. L
    col = ntsf
    for m in range(1, ntsf):
        blk = a[:, col:col + 2 * (ntsf - m)].reshape(-1, ntsf - m, 2)
        ss = blk[..., 0] * blk[..., 0] + blk[..., 1] * blk[..., 1]
        s = torch.cat([s[:, :m], s[:, m:] + ss], dim=1)
        col += 2 * (ntsf - m)
    return s


def g_harm_tiles(dxx, dxy, dxz, npsf, ntsf, rc, tile, piece):
    """g_harm of rows of any width as tiles of `tile` slots: the virtual
    rows of `split_rows` through `piece` (kernels.g_harm: the kernel on the
    card, g_harm_plain on the CPU), their radial G, F2 and A summed over
    each row's tiles, then S_l recomputed from the summed A (the only
    columns not additive over partners). Returns (g_raw [P, 128],
    A [P, 384])."""
    planes, t = split_rows((dxx, dxy, dxz), tile, rc)
    g, a = piece(*planes, npsf, ntsf, rc)
    p = dxx.shape[0]
    g = sum_tiles(g.view(p, t, -1))
    a = sum_tiles(a.view(p, t, -1))
    g = torch.cat([g[:, :npsf], power_sums(a, ntsf), g[:, npsf + ntsf:]],
                  dim=1)
    return g, a


def force_harm_tiles(dxx, dxy, dxz, dedg_rad, b, npsf, ntsf, rc, tile,
                     piece):
    """force_harm of rows of any width as tiles of `tile` slots: a lane's
    Fj depends on its own geometry and its row's coefficients only, so
    each virtual row of `split_rows` takes its row's dedg_rad and b, and
    the Fj planes of `piece` (kernels.force_harm) are viewed back as
    [P, K]."""
    planes, t = split_rows((dxx, dxy, dxz), tile, rc)
    fj = piece(*planes, dedg_rad.repeat_interleave(t, dim=0),
               b.repeat_interleave(t, dim=0), npsf, ntsf, rc)
    p, k = dxx.shape
    return tuple(f.view(p, t * tile)[:, :k].contiguous() for f in fj)


def _row_chunk(k, device):
    """Rows per chunk of the cos-matrix plain versions: 2^24 [K, K] entries
    on the card, so that their ~10 live [rows, K, K] tensors stay near
    1.3 GB in f64; 2^18 on the CPU, whose ~2 MB temporaries stay in cache
    (4x faster at K 384 than 2^24)."""
    entries = 1 << 24 if device.type == "cuda" else 1 << 18
    return max(1, entries // (k * k))


def _angular_matrices(ux, uy, uz, fc):
    """cos[r, k, j] = u_k . u_j, the weight w = fc_k fc_j with its diagonal
    zeroed by index, and the [K, K] diagonal mask, for [rows, K] lanes
    (`_angular_matrices`, meng_zhang_tpu/ops/pallas_annp.py:77)."""
    k = ux.shape[1]
    cos = (ux[:, :, None] * ux[:, None, :] + uy[:, :, None] * uy[:, None, :]
           + uz[:, :, None] * uz[:, None, :])
    diag = torch.eye(k, dtype=torch.bool, device=ux.device)
    w = torch.where(diag, 0.0, fc[:, :, None] * fc[:, None, :])
    return cos, w, diag


def g_cos_plain(dxx, dxy, dxz, npsf, ntsf, rc):
    """Plain PyTorch `_g_kernel`: raw descriptors g [P, 128], cols
    [0, npsf) radial G_m, cols npsf + n the angular
    G_n = 1/2 sum_{j!=k} T_n((cos_jk + 1)/2) fc_j fc_k, rest 0. The [K, K]
    matrices are built in row chunks."""
    p, k = dxx.shape
    r, fc, dfc, inv_r, m, ux, uy, uz = pair_geometry(dxx, dxy, dxz, rc)
    g = dxx.new_zeros(p, NSF_PAD)
    g[:, :npsf] = torch.stack(_radial_g(r, fc, m, npsf, rc), 1)
    rows = _row_chunk(k, dxx.device)
    for i0 in range(0, p, rows):
        c = slice(i0, i0 + rows)
        cos, w, _ = _angular_matrices(ux[c], uy[c], uz[c], fc[c])
        xa = 0.5 * (cos + 1.0)
        tp, tc = torch.ones_like(xa), xa
        sums = [(w * tp).sum((1, 2)), (w * tc).sum((1, 2))]
        for _ in range(2, ntsf):
            tp, tc = tc, 2.0 * xa * tc - tp
            sums.append((w * tc).sum((1, 2)))
        g[c, npsf:npsf + ntsf] = 0.5 * torch.stack(sums[:ntsf], 1)
    return g


def force_cos_plain(dxx, dxy, dxz, dedg, npsf, ntsf, rc):
    """Plain PyTorch `_force_kernel`: per-pair Fj = -dE_i/dx_j as three
    [P, K] planes from dedg [P, 128], dE/dG already multiplied by
    sf_scale * e_scale. With P = sum_n w_n T_n(x_kj), the matrices
    A[k, j] = 1/4 fc_k fc_j P'(x_kj) and B[k, j] = fc_k dfc_j P(x_kj)
    (diagonal excluded by index) give
    Fj = coeff u_j - ((sac u_j - sau) 2 / r_j - sb u_j), with the column
    sums sac = sum_k A cos, sau = sum_k A u_k, sb = sum_k B."""
    p, k = dxx.shape
    r, fc, dfc, inv_r, m, ux, uy, uz = pair_geometry(dxx, dxy, dxz, rc)
    coeff = _radial_coeff(r, fc, dfc, m, dedg, npsf, rc)
    out = [torch.empty_like(dxx) for _ in range(3)]
    rows = _row_chunk(k, dxx.device)
    for i0 in range(0, p, rows):
        c = slice(i0, i0 + rows)
        cos, w, diag = _angular_matrices(ux[c], uy[c], uz[c], fc[c])

        def wn(n):
            return dedg[c, npsf + n].reshape(-1, 1, 1)

        xa = 0.5 * (cos + 1.0)
        tp = (~diag).to(xa.dtype)
        tc = xa * tp
        dp = torch.zeros_like(xa)
        dc = tp
        p_sum = wn(0) * tp
        dp_sum = torch.zeros_like(xa)
        if ntsf > 1:
            p_sum = p_sum + wn(1) * tc
            dp_sum = dp_sum + wn(1) * dc
        for n in range(2, ntsf):
            tp, tc, dp, dc = tc, 2.0 * xa * tc - tp, dc, \
                2.0 * tc + 2.0 * xa * dc - dp
            p_sum = p_sum + wn(n) * tc
            dp_sum = dp_sum + wn(n) * dc
        a_mat = (0.5 * 0.5) * w * dp_sum
        b_mat = torch.where(diag, 0.0,
                            fc[c][:, :, None] * dfc[c][:, None, :]) * p_sum
        sac = (a_mat * cos).sum(1)
        sb = b_mat.sum(1)
        for o, u in zip(out, (ux, uy, uz)):
            sau = (a_mat * u[c][:, :, None]).sum(1)
            o[c] = (coeff[c] * u[c] - ((sac * u[c] - sau) * 2.0 * inv_r[c]
                                       - sb * u[c])) * m[c]
    return tuple(out)


# ------------------------------------------------------------ evaluator
def _act_and_grad(z, flag: int, style: str):
    if flag == 0:
        return z, torch.ones_like(z)
    if flag == 1:
        t = torch.tanh(z)
        return t, 1.0 - t * t
    if flag == 2:
        s = 1.0 / (1.0 + torch.exp(z))
        return s, s * (1.0 - s)
    if style == ActivationStyle.FE:
        t = torch.tanh(_FE_B * z)
        if flag == 3:
            return _FE_A * t, _FE_A * _FE_B * (1.0 - t * t)
        return _FE_A * t + _FE_C * z, _FE_A * _FE_B * (1.0 - t * t) + _FE_C
    t = torch.tanh(z)
    return t, 1.0 - t * t


def element_networks(params):
    """Every element's ((w1, w2, w3), (b1, b2, b3)), in element order, of a
    two-hidden-layer params dict, the network shape the fused evaluators
    take."""
    if len(params["w"]) != 3:
        raise NotImplementedError("the fused path assumes two hidden "
                                  "layers, as every shipped potential")
    return tuple((tuple(w[e] for w in params["w"]),
                  tuple(b[e] for b in params["b"]))
                 for e in range(params["w"][0].shape[0]))


def _mlp_one(cfg, net, g, scale):
    (w1, w2, w3), (b1, b2, b3) = net
    fl, style = cfg.flagact, cfg.act_style
    h1, d1 = _act_and_grad(g @ w1.T + b1, fl[0], style)
    h2, d2 = _act_and_grad(h1 @ w2.T + b2, fl[1], style)
    out, d3 = _act_and_grad(h2 @ w3.T + b3, fl[2], style)
    eat = cfg.e_scale * out[:, 0]
    v = d3 * w3
    v = (v * d2) @ w2
    v = (v * d1) @ w1
    return eat, v * scale * cfg.e_scale


def mlp_eat_dedg(cfg, nets, g, scale, el=None):
    """MLP forward and hand VJP on normalized descriptors g [P, nsf]:
    (eat [P], dE/dG_raw [P, nsf]). eat is the shift-free per-atom energy
    e_scale * nn(g); the gradient is taken with respect to the raw
    descriptors, g = (G_raw - shift) * scale, and carries e_scale.

    nets: `element_networks(params)`. el [P] (int, the element of each
    row) selects each row's network when there are several: every network
    runs on all rows and a where keeps the row's own (a row whose element
    has no network gets 0), the dense select of `_mlp_eat_dedg(el)`;
    el None, or one network, runs the first network alone. Counterpart of
    `_mlp_eat_dedg` (meng_zhang_tpu/ops/pallas_annp.py:1017,
    ops/pallas_ni.py:339)."""
    if el is None or len(nets) == 1:
        return _mlp_one(cfg, nets[0], g, scale)
    eat = g.new_zeros(g.shape[0])
    dedg = torch.zeros_like(g)
    for e, net in enumerate(nets):
        ea, de = _mlp_one(cfg, net, g, scale)
        sel = el == e
        eat = torch.where(sel, ea, eat)
        dedg = torch.where(sel[:, None], de, dedg)
    return eat, dedg


# LAMMPS vatom columns (xx, yy, zz, xy, xz, yz) as (dx axis, Fj axis)
VATOM_ORDER = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))


def deliver(fj, sidx, n, x_ext=None):
    """Partner-force delivery of the per-pair Fj planes (fjx, fjy, fjz)
    [P, K] of the rows sidx [P, K]: each row's atom gets -sum_s Fj and each
    partner +Fj, through one index_add_ (the port's counterpart of the JAX
    `_assemble`). Returns (forces [P, 3], the lanes' target rows [P*K]):
    a lane's Fj goes to its partner (the real atom sidx % n when the rows
    index the image-extended table x_ext). Filler lanes (the sentinel)
    carry Fj exactly 0 and add it to their own row: sent to one shared
    dump row instead, their ~2e6 atomic adds per step serialise on one
    address."""
    fjs = torch.stack(fj, dim=-1)                          # [P, K, 3]
    rows = torch.arange(sidx.shape[0], device=sidx.device)[:, None]
    if x_ext is None:
        target = torch.where(sidx < n, sidx, rows).reshape(-1)
    else:
        target = torch.where(sidx < x_ext.shape[0], sidx % n,
                             rows).reshape(-1)
    forces = -fjs.sum(dim=1)
    forces.index_add_(0, target, fjs.reshape(-1, 3))
    return forces, target


def pair_virial(dd, fj):
    """W = -sum dx (x) Fj over the lanes of the dx planes dd and the Fj
    planes fj, symmetrised: filler lanes and lanes beyond rc carry Fj = 0
    exactly, so the sum needs no mask."""
    w = torch.stack([torch.stack([-(da * fb).sum() for fb in fj])
                     for da in dd])
    return 0.5 * (w + w.T)


def evaluate_pairs(eval_fj, x, box, sidx, bad, pbc, e_shift, shift,
                   want_virial=True, per_atom=False, el=None, x_ext=None):
    """One evaluation against the short rows sidx [P, K]: gather the dx
    planes, eval_fj(dxx, dxy, dxz, el) -> (eat [P], (fjx, fjy, fjz)
    [P, K]) with Fj = -dE_i/dx_j per pair, then deliver. el [P]: the
    rows' element ids, or None. Returns (E, F [N, 3]), then W [3, 3] with
    want_virial, then eatom [N] and vatom [N, 6] with per_atom; `bad`
    NaN-poisons every output but W.

    x_ext [R*N, 3]: the image-extended partner table that sidx indexes
    (sentinel R*N); a lane's Fj goes to the real atom sidx % N, and
    W = -sum dx (x) Fj over the image separations dx.

    eatom includes e_shift whatever `shift` is (LAMMPS pe/atom). vatom is
    the +-1/2-per-pair virial tally in LAMMPS order (xx, yy, zz, xy, xz,
    yz): the lane tally T = -1/2 dx (x) Fj (dx_a Fj_b, unsymmetrised) goes to
    the row's own atom and, through the delivery's index_add_, to its
    partner, so both ends of a pair receive 1/2 dx (x) (the pair's force on
    the row's atom), the value the JAX package reads from the reverse slot
    (`energy_forces_short(per_atom=True)`,
    meng_zhang_tpu/ops/pallas_annp.py:1625-1638)."""
    n = x.shape[0]
    with profiling.span("eval.gather"):
        dd = pair_dx_planes(x, box, sidx, pbc, x_ext=x_ext)
    eat, fj = eval_fj(*dd, el)
    with profiling.span("eval.delivery"):
        forces, target = deliver(fj, sidx, n, x_ext)
    e = eat.sum()
    if shift:
        e = e + n * e_shift
    nan = torch.full((), float("nan"), dtype=x.dtype, device=x.device)
    out = (torch.where(bad, nan, e), torch.where(bad, nan, forces))
    if want_virial:
        with profiling.span("eval.virial"):
            out = out + (pair_virial(dd, fj),)
    if per_atom:
        t = torch.stack([-0.5 * dd[a] * fj[b] for a, b in VATOM_ORDER],
                        dim=-1)                            # [P, K, 6]
        vat = t.sum(dim=1)
        vat.index_add_(0, target, t.reshape(-1, 6))
        out = out + (torch.where(bad, nan, eat + e_shift),
                     torch.where(bad, nan, vat))
    return out


class FusedAnnp(FrameOps):
    """Per-step evaluator: gather -> descriptor kernel -> MLP + VJP -> force
    kernel -> index_add delivery.

    k_short: short-list width Ks (128 on the benchmark path: bcc-Fe has at
    most ~112 partners within 6.9 A). short_delta: the inner skin of the
    refresh-static short list. angular: "harmonic" (g_harm / force_harm)
    selects the harmonic path, any other value the cos-matrix path (g_cos /
    force_cos), as `PallasAnnp(angular=...)` does. plain=True runs the plain
    PyTorch versions of the kernels (the compaction's too) on any device
    (the f64 reference on the card); with plain=False the kernel wrappers
    run, which launch the CUDA kernels for CUDA tensors and take the plain
    versions only for CPU tensors. elems [N] (int): each atom's element,
    which selects its network on a multi-element potential
    (`mlp_eat_dedg`), as `PallasAnnp(elems=...)` does; the evaluation
    methods also take elems per call, which overrides these. None
    evaluates every atom with the first element's network.

    Built for a CUDA device, it turns TF32 off for matmuls and cuDNN
    (process-wide flags): the angular descriptors come out of S_l @ cmat
    and then lose a mean up to ~70x their spread in the normalisation, so
    TF32's 10-bit mantissa would reach the network inputs at the percent
    level.
    """

    def __init__(self, cfg, params, k_short=128, short_delta=0.3,
                 plain=False, angular="harmonic", elems=None):
        self.cfg = cfg
        self.k_short = k_short
        self.short_delta = short_delta
        self.plain = plain
        self.angular = angular
        self.pbc = tuple(cfg.pbc)
        self.npsf, self.ntsf = cfg.npsf, cfg.ntsf
        dt = params["sf_scale"].dtype
        dev = params["sf_scale"].device
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if angular == "harmonic":
            self.cmat = torch.as_tensor(cheb_legendre(cfg.ntsf), dtype=dt,
                                        device=dev)
            layout = harm_layout(cfg.ntsf - 1)
            self.n_harm = len(layout)
            assert self.n_harm <= AB_PAD - 1
            self.l_of_col = torch.as_tensor(layout, device=dev)
        self.scale, self.shift = params["sf_scale"], params["sf_shift"]
        self.nets = element_networks(params)
        self.elems = None if elems is None else torch.as_tensor(elems,
                                                                device=dev)

    @property
    def short_rc(self):
        return self.cfg.cut

    def compact_short(self, x, box, nbr_idx):
        fn = compact_short_plain if self.plain else compact_short
        return fn(x, box, nbr_idx, self.cfg.cut + self.short_delta,
                  self.k_short, self.pbc)

    def _mlp_eat_dedg(self, g, el=None):
        """MLP + VJP from raw descriptors g [P, 128], each row through the
        network of its element el [P]: (eat [P], dedg [P, 128], zero beyond
        nsf, the cos force kernel's input)."""
        nsf = self.npsf + self.ntsf
        eat, dedg = mlp_eat_dedg(self.cfg, self.nets,
                                 (g[:, :nsf] - self.shift) * self.scale,
                                 self.scale, el)
        return eat, torch.nn.functional.pad(dedg, (0, NSF_PAD - nsf))

    def _g_cos(self):
        return g_cos_plain if self.plain else kernels.g_cos

    def _mlp_eat_dedg_harm(self, g_raw, a, el=None):
        """S_l power sums -> angular G, MLP + VJP (rows' elements el), then
        the force kernel's per-atom coefficients: dedg_rad [P, 128] and b
        [P, 384] (B_lm, then 2q in column n_harm)."""
        npsf, ntsf = self.npsf, self.ntsf
        s_l = g_raw[:, npsf:npsf + ntsf]
        f2 = g_raw[:, npsf + ntsf:npsf + ntsf + 1]
        g_ang = 0.5 * (s_l @ self.cmat.T - f2)
        g_all = torch.cat([g_raw[:, :npsf], g_ang], dim=1)
        eat, dedg = mlp_eat_dedg(self.cfg, self.nets,
                                 (g_all - self.shift) * self.scale,
                                 self.scale, el)
        dedg_ang = dedg[:, npsf:]
        bco = dedg_ang @ self.cmat
        b = a[:, :self.n_harm] * bco[:, self.l_of_col]
        q2 = -dedg_ang.sum(dim=1, keepdim=True)
        b = torch.cat([b, q2, b.new_zeros(b.shape[0],
                                          AB_PAD - self.n_harm - 1)], dim=1)
        dedg_rad = torch.nn.functional.pad(dedg[:, :npsf],
                                           (0, NSF_PAD - npsf))
        return eat, dedg_rad, b

    def _eval_fj(self, dxx, dxy, dxz, el=None):
        c = self.cfg
        if self.angular != "harmonic":
            f_fn = force_cos_plain if self.plain else kernels.force_cos
            with profiling.span("eval.descriptors"):
                g = self._g_cos()(dxx, dxy, dxz, c.npsf, c.ntsf, c.cut)
            with profiling.span("eval.network"):
                eat, dedg = self._mlp_eat_dedg(g, el)
            with profiling.span("eval.forces"):
                return eat, f_fn(dxx, dxy, dxz, dedg, c.npsf, c.ntsf, c.cut)
        g_fn = g_harm_plain if self.plain else kernels.g_harm
        f_fn = force_harm_plain if self.plain else kernels.force_harm
        with profiling.span("eval.descriptors"):
            g_raw, a = g_fn(dxx, dxy, dxz, c.npsf, c.ntsf, c.cut)
        with profiling.span("eval.network"):
            eat, dedg_rad, b = self._mlp_eat_dedg_harm(g_raw, a, el)
        with profiling.span("eval.forces"):
            return eat, f_fn(dxx, dxy, dxz, dedg_rad, b, c.npsf, c.ntsf,
                             c.cut)

    def _el(self, elems):
        return self.elems if elems is None else elems

    def energy_dedg(self, x, box, nbr_idx, elems=None):
        """Per-atom energies and descriptor gradients from the skin list
        nbr_idx [N, K] at its full width, through g_cos whatever `angular`
        is (counterpart of `PallasAnnp.energy_dedg`,
        meng_zhang_tpu/ops/pallas_annp.py:1641).

        Returns (eat [N], dedg [N, 128]). eat is shift-free, as everywhere in
        this package: the JAX method's eat includes e_shift and equals
        eat + cfg.e_shift. dedg is dE_i/dG_raw, carrying sf_scale * e_scale,
        zero beyond nsf."""
        c = self.cfg
        dd = pair_dx_planes(x, box, nbr_idx, self.pbc)
        return self._mlp_eat_dedg(
            self._g_cos()(*dd, c.npsf, c.ntsf, c.cut), self._el(elems))

    def energy_forces_short(self, x, box, sl: ShortList, want_virial=True,
                            shift=False, per_atom=False, elems=None,
                            x_ext=None):
        """(E, F [N, 3]), then W [3, 3] with want_virial, then eatom [N]
        and vatom [N, 6] with per_atom, against a refresh-static ShortList
        (`evaluate_pairs` gives the per-atom contract and x_ext's, the
        image-extended table the rows index in a thin box).

        E is shift-free unless shift=True (readers add n * e_shift in f64);
        W_ab = -sum dx_a Fj_b over real lanes, symmetrized; the light MD
        step passes want_virial=False and skips W. Short-list overflow
        NaN-poisons E, F, eatom and vatom."""
        return evaluate_pairs(self._eval_fj, x, box, sl.sidx, sl.overflow,
                              self.pbc, self.cfg.e_shift, shift, want_virial,
                              per_atom, self._el(elems), x_ext)

    def energy_forces(self, x, box, nbr_idx, want_virial=True, shift=False,
                      per_atom=False, elems=None):
        """Full evaluation from a skin list: compact to Ks at rc, then the
        same per-step evaluation. Overflow of Ks NaN-poisons the
        outputs."""
        fn = compact_short_plain if self.plain else compact_short
        sl = fn(x, box, nbr_idx, self.cfg.cut, self.k_short, self.pbc)
        return self.energy_forces_short(x, box, sl, want_virial, shift,
                                        per_atom, elems)
