"""Fused-kernel evaluator for the Behler-Parrinello ANNP (ni).

Counterpart of meng_zhang_tpu/ops/pallas_ni.py:
  * `ni_table`, the kernels' static configuration (`_ni_cfg_key`, :57);
  * `ni_g_plain` / `ni_force_plain`: plain PyTorch versions of the two TPU
    kernels `_ni_g_kernel` (:126) and `_ni_force_kernel` (:170). Their CUDA
    kernels live in csrc/ni_bp.cu and are launched through ops/kernels.py;
    `ni_g_tiles_plain` / `ni_force_tiles_plain` are the plain twins of
    their cross-tile instances `ni_g_tiles` / `ni_force_tiles`, which
    take rows of more than 512 slots (`ni_force_tiles_part_plain` and
    `ni_force_tiles_sum_plain` those of ni_force_tiles' two kernels);
  * `FusedNi`, the counterpart of `PallasNi` (:298), with the frame methods
    of the sharded drivers (`frames.FrameOps`): refresh-static short
    list at the descriptor cutoff + short_delta, gather, G2/G4 descriptors,
    the min-max-normalised MLP and its hand VJP, per-pair forces, and the
    `index_add_` delivery shared with ops/fused_annp.py. `PallasNi` is
    single-element; `FusedNi(elems=...)` also selects each atom's network
    (`fused_annp.mlp_eat_dedg`), so that the chunked BP functions
    (models/annp.py), which run on FusedNi, honour their `elems` as the JAX
    functions do (`_chunk_mlp_eat`, meng_zhang_tpu/models/annp.py:239).

Layout: the TPU kernels run transposed [Ks, 128] blocks (the ni rows hold
only ~20 partners, so the fe layout would waste 3/4 of each TPU vector
register). The port keeps the [P, Ks] planes of the fe path: g and dedg
are [P, 32] (NSF_SUB, nsf = 27), Fj three [P, Ks] planes.

Units: descriptor math runs in Bohr (r_Bohr = r_A * CFLENGTH); dE/dG
carries e_scale = NI_HARTREE_EV, so dE/dG * dG/dr_Bohr * CFLENGTH is a force
in eV/A.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import profiling
from ..units import CFLENGTH
from . import fused_annp as fa
from . import kernels
from .frames import FrameOps

NSF_SUB = 32      # g / dedg row width (nsf = 27 in the shipped potential)


class NiTable(NamedTuple):
    """Static kernel configuration: radial ((eta, rc), ...) per radial
    function; rc_a, the one angular cutoff; angular ((eta, ((lam, zeta,
    col), ...)), ...) grouped by eta, col the descriptor column npsf + n of
    coeang row n (all in Bohr units)."""
    rad: tuple
    rc_a: float
    ang: tuple


def ni_table(coerad, coeang) -> NiTable:
    """The kernels' table from the coefficient tables (arrays or tensors).

    Grouping by eta shares exp(-eta * r2sum) across the functions of each
    eta (2 lambda x 4 zeta in the shipped table); groups come in order of
    first appearance, functions in row order, and columns follow the row
    order whatever the grouping."""
    coerad = np.asarray(torch.as_tensor(coerad).cpu(), np.float64)
    coeang = np.asarray(torch.as_tensor(coeang).cpu(), np.float64)
    rad = tuple((float(e), float(rc)) for e, _, rc in coerad)
    rc_a = float(coeang[0, 3])
    if not np.all(coeang[:, 3] == coeang[0, 3]):
        raise ValueError("per-function angular cutoffs are not supported in "
                         "the fused ni kernels")
    groups = {}
    for n, (eta, lam, zeta, _rc) in enumerate(coeang):
        groups.setdefault(float(eta), []).append(
            (float(lam), float(zeta), len(rad) + n))
    ang = tuple((eta, tuple(fns)) for eta, fns in groups.items())
    return NiTable(rad, rc_a, ang)


def _pow_zeta(f1, zeta):
    """(f1^zeta, zeta * f1^(zeta-1)) by repeated squaring when zeta is a
    power of two (every zeta of the shipped table), by pow otherwise; the
    products run in the TPU kernel's order (`_pow_zeta`, :79). The pow
    route gives 0 for both where f1 <= 0, as the BP definition skips those
    terms (descriptors.behler_g): rounding can leave 1 + lambda cos a few
    ulps below 0, which a fractional zeta would turn into NaN."""
    zi = int(zeta)
    if zeta == zi and zi > 0 and (zi & (zi - 1)) == 0:
        p, fzm = f1, None
        for _ in range(zi.bit_length() - 1):
            fzm = p if fzm is None else fzm * p
            p = p * p
        return p, zeta * (torch.ones_like(f1) if fzm is None else fzm)
    pos = f1 > 0.0
    fb = torch.where(pos, f1, torch.ones_like(f1))
    zero = torch.zeros_like(f1)
    return (torch.where(pos, fb ** zeta, zero),
            torch.where(pos, zeta * fb ** (zeta - 1.0), zero))


def _shape_powers(cos, shapes, with_d):
    """{(lambda, zeta): (f^zeta, zeta f^(zeta - 1), or None without
    with_d)} with f = 1 + lambda cos, for each (lambda, zeta) of `shapes`:
    the values `_pow_zeta` gives, the power-of-two zetas of one lambda read
    off one squaring chain (as ni_force's kernel walks them) instead of one
    chain a function."""
    out = {}
    for lam in sorted({lam for lam, _ in shapes}):
        f1 = 1.0 + lam * cos
        p, fzm, level = f1, None, 0
        for zeta in sorted(z for lm, z in shapes if lm == lam):
            zi = int(zeta)
            if not (zeta == zi and zi > 0 and (zi & (zi - 1)) == 0):
                out[(lam, zeta)] = _pow_zeta(f1, zeta)
                continue
            while level < zi.bit_length() - 1:
                if with_d:
                    fzm = p if fzm is None else fzm * p
                p = p * p
                level += 1
            out[(lam, zeta)] = (p, zeta * (torch.ones_like(f1) if fzm is None
                                           else fzm) if with_d else None)
    return out


def _ni_geometry(dxx, dxy, dxz, rc_a):
    """Per-pair scalars on [P, K] planes (`_ni_geometry`, :105). Masked
    lanes get a Bohr radius a = rc_a + 1 so exp and sqrt stay finite;
    filler lanes (dx = 2 box + 10) are masked by in_a."""
    rsq = dxx * dxx + dxy * dxy + dxz * dxz
    valid = rsq > 1.0e-12
    r = torch.sqrt(torch.where(valid, rsq, torch.ones_like(rsq)))
    inv_r = 1.0 / r
    m = valid.to(dxx.dtype)
    ux, uy, uz = dxx * inv_r * m, dxy * inv_r * m, dxz * inv_r * m
    rm_true = r * CFLENGTH
    in_a = valid & (rm_true < rc_a)
    a = torch.where(in_a, rm_true, torch.full_like(rm_true, rc_a + 1.0))
    zero = torch.zeros_like(r)
    fc_a = torch.where(in_a, 0.5 * (torch.cos(math.pi / rc_a * a) + 1.0),
                       zero)
    dfc_a = torch.where(in_a, -0.5 * math.pi / rc_a
                        * torch.sin(math.pi / rc_a * a), zero)
    return r, inv_r, ux, uy, uz, rm_true, in_a, a, fc_a, dfc_a


def _radial_in(r, rm_true, rc_r):
    in_r = (rm_true < rc_r) & (r > 1.0e-6)
    return in_r, torch.where(in_r, rm_true, torch.full_like(rm_true, rc_r))


def _angular_lanes(in_a):
    """(the lanes q that some row holds inside the angular cutoff, the
    number of lanes up to the last of them): every other lane adds exactly
    zero to the angular sums (the filler columns of compacted rows), so
    the q loops and the angular terms skip them."""
    qs = torch.nonzero(in_a.any(dim=0)).flatten().tolist()
    return qs, qs[-1] + 1 if qs else 0


def _first_lanes(planes, n):
    """The first n lanes of per-lane [P, K] tensors (contiguous copies
    unless n is K)."""
    if n == planes[0].shape[1]:
        return planes
    return tuple(t[:, :n].contiguous() for t in planes)


def _pair_legs(ux, uy, uz, a, in_a, q, rc_a, mine):
    """The (p, q) pair terms of the q loop for every lane p of `mine` =
    (ux, uy, uz, a, in_a, lane index) at once (q runs over the whole
    row)."""
    uq = (ux[:, q:q + 1], uy[:, q:q + 1], uz[:, q:q + 1])
    aq = a[:, q:q + 1]
    pux, puy, puz, ap, p_in, lane = mine
    cos = pux * uq[0] + puy * uq[1] + puz * uq[2]
    rjk2 = ap * ap + aq * aq - 2.0 * ap * aq * cos
    legs = p_in & in_a[:, q:q + 1] & (rjk2 < rc_a * rc_a) & (lane != q)
    rjk = torch.sqrt(torch.where(legs, rjk2.clamp_min(1.0e-12),
                                 torch.ones_like(rjk2)))
    r2sum = ap * ap + aq * aq + torch.where(legs, rjk2,
                                            torch.zeros_like(rjk2))
    return uq, aq, cos, legs, rjk, r2sum


def _ni_g_lanes(dxx, dxy, dxz, table: NiTable):
    """Each lane's share of g: ({radial col: [P, K] exp(-eta r^2) fc},
    {angular col: [P, K'] 1/2 sum_{q != p} of the lane p's terms}), the
    angular lanes K' <= K ending at the last lane that some row holds
    inside the angular cutoff (the rest add exactly zero)."""
    rad, rc_a, ang = table
    r, inv_r, ux, uy, uz, rm_true, in_a, a, fc_a, dfc_a = _ni_geometry(
        dxx, dxy, dxz, rc_a)
    zero = torch.zeros_like(r)
    radial = {}
    for mi, (eta, rc_r) in enumerate(rad):
        in_r, rr = _radial_in(r, rm_true, rc_r)
        fc_r = torch.where(in_r, 0.5 * (torch.cos(math.pi / rc_r * rr)
                                        + 1.0), zero)
        radial[mi] = torch.exp(-eta * rr * rr) * fc_r
    qs, n_ang = _angular_lanes(in_a)
    lane = torch.arange(dxx.shape[1], device=dxx.device)[None, :]
    pux, puy, puz, ap, p_in, fcp, plane = _first_lanes(
        (ux, uy, uz, a, in_a, fc_a, lane), n_ang)
    mine = (pux, puy, puz, ap, p_in, plane)
    zero = torch.zeros_like(ap)
    acc = {col: zero for _, fns in ang for _, _, col in fns}
    shapes = {(lam, zeta) for _, fns in ang for lam, zeta, _ in fns}
    for q in qs:
        _, _, cos, legs, rjk, r2sum = _pair_legs(ux, uy, uz, a, in_a, q, rc_a,
                                                 mine)
        fc_jk = 0.5 * (torch.cos(math.pi / rc_a * rjk) + 1.0)
        fc3 = torch.where(legs, fcp * fc_a[:, q:q + 1] * fc_jk, zero)
        powers = _shape_powers(cos, shapes, with_d=False)
        for eta, fns in ang:
            t_eta = torch.exp(-eta * r2sum) * fc3
            for lam, zeta, col in fns:
                fz = powers[(lam, zeta)][0]
                acc[col] = acc[col] + (2.0 ** (1.0 - zeta)) * fz * t_eta
    return radial, {col: 0.5 * v for col, v in acc.items()}


def _g_of_lanes(radial, angular):
    """g [P, 32] from _ni_g_lanes' shares."""
    ref = next(iter(radial.values()))
    cols = [ref.new_zeros(ref.shape[0])] * NSF_SUB
    for col, v in list(radial.items()) + list(angular.items()):
        cols[col] = v.sum(dim=1)
    return torch.stack(cols, dim=1)


def ni_g_plain(dxx, dxy, dxz, table: NiTable):
    """Plain PyTorch `_ni_g_kernel`: raw descriptors g [P, 32] from the
    [P, K] dx planes. Cols [0, npsf) radial G2 = sum exp(-eta r^2) fc,
    cols npsf + n angular G4 = 1/2 sum_{p != q} 2^(1-zeta)
    (1 + lambda cos)^zeta exp(-eta r2sum) fc fc fc, rest 0 (Bohr)."""
    return _g_of_lanes(*_ni_g_lanes(dxx, dxy, dxz, table))


def cross_units(nt):
    """The work units of the cross-tile kernels on a row of nt tiles: its
    unordered tile pairs (a, b), a <= b, in unit order."""
    return [(a, b) for a in range(nt) for b in range(a, nt)]


def _tile_sums(v, tile, nt):
    """v [P, n], n <= nt tile, summed within tiles of `tile` lanes:
    [P, nt]."""
    p, n = v.shape
    v = torch.nn.functional.pad(v, (0, nt * tile - n))
    return v.view(p, nt, tile).sum(dim=2)


def ni_g_tiles_plain(dxx, dxy, dxz, table: NiTable, tile):
    """Plain twin of the cross-tile `ni_g_tiles` kernel: the row cut into
    T tiles of `tile` slots, g_part [P, U, 32] over the units (a, b) of
    cross_units(T). Unit (a, b) holds the angular terms of the unordered
    leg pairs (p in tile a, q in tile b; p < q where a == b), each once,
    undoubled, and unit (a, a) tile a's radial G2; `fused_annp.sum_tiles`
    of it is g. The q loop takes each q's pairs p < q and sums their terms
    within the tiles of p."""
    rad, rc_a, ang = table
    r, inv_r, ux, uy, uz, rm_true, in_a, a, fc_a, dfc_a = _ni_geometry(
        dxx, dxy, dxz, rc_a)
    p, k = dxx.shape
    nt = -(-k // tile)
    zero = torch.zeros_like(r)
    sums = {}                      # col: [P, T, T], unit (a, b) at [:, a, b]
    for mi, (eta, rc_r) in enumerate(rad):
        in_r, rr = _radial_in(r, rm_true, rc_r)
        fc_r = torch.where(in_r, 0.5 * (torch.cos(math.pi / rc_r * rr)
                                        + 1.0), zero)
        sums[mi] = torch.diag_embed(
            _tile_sums(torch.exp(-eta * rr * rr) * fc_r, tile, nt))
    cols = [col for _, fns in ang for _, _, col in fns]
    angular = dxx.new_zeros((len(cols), p, nt, nt))
    shapes = {(lam, zeta) for _, fns in ang for lam, zeta, _ in fns}
    lane = torch.arange(k, device=dxx.device)[None, :]
    for q in _angular_lanes(in_a)[0]:
        mine = tuple(t[:, :q] for t in (ux, uy, uz, a, in_a, lane))
        _, _, cos, legs, rjk, r2sum = _pair_legs(ux, uy, uz, a, in_a, q, rc_a,
                                                 mine)
        fc_jk = 0.5 * (torch.cos(math.pi / rc_a * rjk) + 1.0)
        fc3 = torch.where(legs, fc_a[:, :q] * fc_a[:, q:q + 1] * fc_jk,
                          zero[:, :q])
        powers = _shape_powers(cos, shapes, with_d=False)
        terms = []
        for eta, fns in ang:
            t_eta = torch.exp(-eta * r2sum) * fc3
            terms += [(2.0 ** (1.0 - zeta)) * powers[(lam, zeta)][0] * t_eta
                      for lam, zeta, _ in fns]
        angular[:, :, :, q // tile] += _tile_sums(
            torch.stack(terms).view(len(cols) * p, q), tile, nt).view(
                len(cols), p, nt)
    sums.update(zip(cols, angular))
    ua, ub = (list(t) for t in zip(*cross_units(nt)))
    out = dxx.new_zeros((p, len(ua), NSF_SUB))
    for col, s in sums.items():
        out[:, :, col] = s[:, ua, ub]
    return out


def _force_weights(dedg, table: NiTable):
    """(the table's shapes, each angular column's weight dE/dG
    2^(1 - zeta), and that times lambda) for _pair_force."""
    ang = table.ang
    shapes = {(lam, zeta) for _, fns in ang for lam, zeta, _ in fns}
    wv = {col: dedg[:, col:col + 1] * (2.0 ** (1.0 - zeta))
          for _, fns in ang for _, zeta, col in fns}
    wvl = {col: wv[col] * lam for _, fns in ang for lam, _, col in fns}
    return shapes, wv, wvl


def _pair_force(geo, table: NiTable, weights, q, n, both=False):
    """ni_force's terms of the leg pairs (p, q) for the lanes p < n at
    once: (u_q, C1, C2) of p's side, d(sum w G)/dx_p = C1 u_p + C2 u_q,
    and with `both` also q's C1 and C2 (p and q exchanged). geo: the whole
    row's (ux, uy, uz, a, in_a, fc_a, dfc_a, inv_r); weights:
    _force_weights."""
    _, rc_a, ang = table
    shapes, wv, wvl = weights
    ux, uy, uz, a, in_a, fc_a, dfc_a, inv_r = geo
    lane = torch.arange(n, device=ux.device)[None, :]
    pux, puy, puz, ap, p_in, fcp, dfcp, irp = (
        t[:, :n] for t in (ux, uy, uz, a, in_a, fc_a, dfc_a, inv_r))
    zero = torch.zeros_like(ap)
    uq, aq, cos, legs, rjk, r2sum = _pair_legs(
        ux, uy, uz, a, in_a, q, rc_a, (pux, puy, puz, ap, p_in, lane))
    fcq = fc_a[:, q:q + 1]
    ang_jk = math.pi / rc_a * rjk
    fc_jk = 0.5 * (torch.cos(ang_jk) + 1.0)
    dfc_jk = -0.5 * math.pi / rc_a * torch.sin(ang_jk)
    lm = legs.to(ux.dtype)
    fc3 = fcp * fcq * fc_jk * lm
    powers = _shape_powers(cos, shapes, with_d=True)
    p_a = p_e = p_cs = zero        # sum_eta e S_A, eta e S_A, e S_C
    for eta, fns in ang:
        e_eta = torch.exp(-eta * r2sum)
        s_a = s_c = zero
        for lam, zeta, col in fns:
            fz, dfz = powers[(lam, zeta)]
            s_a = s_a + wv[col] * fz
            s_c = s_c + wvl[col] * dfz
        t_a = e_eta * s_a
        p_a = p_a + t_a
        p_e = p_e + eta * t_a
        p_cs = p_cs + e_eta * s_c
    # partials of h in the independent variables c, a_p, rjk
    p_c = fc3 * p_cs
    p_ap = -2.0 * ap * p_e * fc3 + dfcp * fcq * fc_jk * lm * p_a
    p_jk = -2.0 * rjk * p_e * fc3 + fcp * fcq * dfc_jk * lm * p_a
    inv_rjk = torch.where(legs, 1.0 / rjk, zero)
    # d(sum w G)/dx_p = C1 u_p + C2 u_q, from dc/dx_p = (c u_p - u_q)/r_p,
    # da_p/dx_p = -CFL u_p, drjk/dx_p = CFL (a_q u_q - a_p u_p)/rjk
    c1 = (p_c * cos * irp - CFLENGTH * p_ap
          - CFLENGTH * p_jk * ap * inv_rjk)
    c2 = -p_c * irp + CFLENGTH * p_jk * aq * inv_rjk
    if not both:
        return uq, c1, c2
    irq = inv_r[:, q:q + 1]
    p_aq = -2.0 * aq * p_e * fc3 + dfc_a[:, q:q + 1] * fcp * fc_jk * lm * p_a
    c1q = (p_c * cos * irq - CFLENGTH * p_aq
           - CFLENGTH * p_jk * aq * inv_rjk)
    c2q = -p_c * irq + CFLENGTH * p_jk * ap * inv_rjk
    return uq, c1, c2, c1q, c2q


def _ni_force(dxx, dxy, dxz, dedg, table: NiTable, angular):
    """Fj planes from the radial terms and angular(geo, qs, n_ang), the
    angular sums (acc1, acc2x, acc2y, acc2z) of the lanes [0, n_ang)."""
    rad, rc_a, _ = table
    r, inv_r, ux, uy, uz, rm_true, in_a, a, fc_a, dfc_a = _ni_geometry(
        dxx, dxy, dxz, rc_a)
    zero = torch.zeros_like(r)
    coeff = zero
    for mi, (eta, rc_r) in enumerate(rad):
        in_r, rr = _radial_in(r, rm_true, rc_r)
        fc_r = 0.5 * (torch.cos(math.pi / rc_r * rr) + 1.0)
        dfc_r = -0.5 * math.pi / rc_r * torch.sin(math.pi / rc_r * rr)
        e_r = torch.exp(-eta * rr * rr)
        dg = torch.where(in_r, e_r * (dfc_r - 2.0 * eta * rr * fc_r), zero)
        coeff = coeff + dedg[:, mi:mi + 1] * dg
    # dG2/dx_j = dg * CFL * (-u_j);  Fj = -w dG => + CFL w dg u
    coeff = coeff * CFLENGTH
    qs, n_ang = _angular_lanes(in_a)
    acc = angular((ux, uy, uz, a, in_a, fc_a, dfc_a, inv_r), qs, n_ang)
    # Fj = -(d sum w G / dx_j): radial +coeff u (sign folded above),
    # angular -(acc1 u + acc2), 0 past the lanes that hold a leg
    pad = dxx.shape[1] - n_ang
    acc1, acc2x, acc2y, acc2z = (torch.nn.functional.pad(t, (0, pad))
                                 for t in acc)
    return tuple((coeff - acc1) * u - acc2
                 for u, acc2 in zip((ux, uy, uz), (acc2x, acc2y, acc2z)))


def ni_force_plain(dxx, dxy, dxz, dedg, table: NiTable):
    """Plain PyTorch `_ni_force_kernel`: per-pair Fj = -dE_i/dx_j as three
    [P, K] planes, from dedg [P, 32] = dE/dG already multiplied by
    sf_scale * e_scale. Radial: Fj += CFL w dg u; angular: the u_p
    coefficient (acc1) and the u_q-projected vector (acc2) accumulate over
    the q loop, Fj -= acc1 u + acc2; no reductions."""
    def angular(geo, qs, n_ang):
        weights = _force_weights(dedg, table)
        acc1 = acc2x = acc2y = acc2z = geo[0].new_zeros(
            (geo[0].shape[0], n_ang))
        for q in qs:
            uq, c1, c2 = _pair_force(geo, table, weights, q, n_ang)
            acc1 = acc1 + c1
            acc2x = acc2x + c2 * uq[0]
            acc2y = acc2y + c2 * uq[1]
            acc2z = acc2z + c2 * uq[2]
        return acc1, acc2x, acc2y, acc2z
    return _ni_force(dxx, dxy, dxz, dedg, table, angular)


def _places(in_a, tile, nt):
    """(in_a, each slot's place among its tile's slots inside the angular
    cutoff, in slot order: the kernels' compaction), both [P, T, tile]."""
    p, k = in_a.shape
    inn = torch.nn.functional.pad(in_a.to(torch.int64),
                                  (0, nt * tile - k)).view(p, nt, tile)
    return inn.bool(), inn.cumsum(2) - 1


def ni_force_tiles_part_plain(dxx, dxy, dxz, dedg, table: NiTable, tile):
    """Plain twin of ni_force_tiles' unit kernel: part [P, T, T, 4, tile],
    at [:, a, b] the angular sums (acc1, acc2x, acc2y, acc2z) of tile a's
    slots over their leg pairs with the slots of tile b, each slot at its
    place among its tile's slots inside the angular cutoff (0 past them).
    Each unordered leg pair (p, q), p < q, once, both sides' terms from one
    symmetric part."""
    r, inv_r, ux, uy, uz, rm_true, in_a, a, fc_a, dfc_a = _ni_geometry(
        dxx, dxy, dxz, table.rc_a)
    geo = (ux, uy, uz, a, in_a, fc_a, dfc_a, inv_r)
    qs, n_ang = _angular_lanes(in_a)
    p, k = dxx.shape
    nt = -(-k // tile)
    by_slot = dxx.new_zeros((4, p, nt, n_ang))      # [c, P, b, slot]
    if qs:
        weights = _force_weights(dedg, table)
    for q in qs:
        uq, c1, c2, c1q, c2q = _pair_force(geo, table, weights, q, q,
                                            both=True)
        by_slot[:, :, q // tile, :q] += torch.stack(
            (c1, c2 * uq[0], c2 * uq[1], c2 * uq[2]))
        other = torch.stack((c1q, c2q * ux[:, :q], c2q * uy[:, :q],
                             c2q * uz[:, :q]))
        by_slot[:, :, :, q] += _tile_sums(other.view(4 * p, q), tile,
                                          nt).view(4, p, nt)
    src = torch.nn.functional.pad(by_slot, (0, nt * tile - n_ang)).view(
        4, p, nt, nt, tile).permute(1, 3, 2, 0, 4)     # [P, a, b, c, slot]
    inn, place = _places(in_a, tile, nt)
    idx = torch.where(inn, place, tile)[:, :, None, None, :].expand(
        p, nt, nt, 4, tile)
    out = dxx.new_zeros((p, nt, nt, 4, tile + 1))
    return out.scatter_(4, idx, src)[..., :tile].contiguous()


def ni_force_tiles_sum_plain(dxx, dxy, dxz, dedg, part, table: NiTable):
    """Plain twin of ni_force_tiles' sum kernel: Fj planes from the units'
    partials part [P, T, T, 4, tile] (ni_force_tiles_part_plain's layout),
    each slot's T partials added in tile order, then its radial term."""
    p, nt, _, _, tile = part.shape

    def angular(geo, qs, n_ang):
        acc = fa.sum_tiles(part.transpose(1, 2))          # [P, a, c, place]
        inn, place = _places(geo[4], tile, nt)
        got = torch.gather(acc, 3, place.clamp_min(0)[:, :, None, :].expand(
            p, nt, 4, tile))
        got = torch.where(inn[:, :, None, :], got, torch.zeros_like(got))
        return tuple(got.permute(2, 0, 1, 3).reshape(4, p, nt * tile)
                     [:, :, :n_ang])
    return _ni_force(dxx, dxy, dxz, dedg, table, angular)


def ni_force_tiles_plain(dxx, dxy, dxz, dedg, table: NiTable, tile):
    """Plain twin of the cross-tile `ni_force_tiles`: the plain twins of
    its two kernels in turn. Equals ni_force_plain up to the rounding of
    the sums' order."""
    return ni_force_tiles_sum_plain(
        dxx, dxy, dxz, dedg,
        ni_force_tiles_part_plain(dxx, dxy, dxz, dedg, table, tile), table)


class FusedNi(FrameOps):
    """Per-step BP evaluator: gather -> ni_g -> min-max MLP + VJP ->
    ni_force -> index_add delivery.

    k_short: short-list width Ks (32 on the ni path: fcc has 18 partners
    within rc + 0.2 = 4.10 A; 128 at Rc 6.0 A, 86 partners within 6.2 A;
    352 at Rc 9.2 A, 320 partners within 9.4 A), at most kernels.NI_MAX_K
    = 512, the JAX fused evaluators' ceiling (the chunked functions of
    models/annp.py take wider rows). short_delta: the inner skin of the
    refresh-static short list. plain=True runs the plain PyTorch versions
    of the two kernels on any device (the f64 reference on the card); with
    plain=False the kernel wrappers run, which launch the CUDA kernels for
    CUDA tensors and take the plain versions only for CPU tensors. elems:
    each atom's element, as in FusedAnnp.

    Built for a CUDA device, it turns TF32 off for matmuls and cuDNN
    (process-wide flags), as FusedAnnp does: min-max normalisation divides
    some G4 columns by spans near 1e-6, so the network inputs must keep
    full f32.
    """

    def __init__(self, cfg, params, k_short=32, short_delta=0.3,
                 plain=False, elems=None):
        if not 1 <= k_short <= kernels.NI_MAX_K:
            raise ValueError(f"k_short {k_short} outside the kernels' [1, "
                             f"NI_MAX_K = {kernels.NI_MAX_K}]")
        self.cfg = cfg
        self.nets = fa.element_networks(params)
        self.k_short = k_short
        self.short_delta = short_delta
        self.plain = plain
        self.pbc = tuple(cfg.pbc)
        self.table = ni_table(params["coerad"], params["coeang"])
        self.rc = max(max(rc for _, rc in self.table.rad),
                      self.table.rc_a) / CFLENGTH            # Angstrom
        self.nsf = cfg.npsf + cfg.ntsf
        if self.nsf > NSF_SUB:
            raise ValueError(f"{self.nsf} descriptors exceed the kernels' "
                             f"{NSF_SUB} columns")
        if params["sf_scale"].device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.scale, self.shift = params["sf_scale"], params["sf_shift"]
        self.elems = None if elems is None else torch.as_tensor(
            elems, device=params["sf_scale"].device)

    @property
    def short_rc(self):
        return self.rc

    def compact_short(self, x, box, nbr_idx):
        return fa.compact_short(x, box, nbr_idx,
                                self.short_rc + self.short_delta,
                                self.k_short, self.pbc)

    def _mlp_eat_dedg(self, g, el=None):
        """MLP + VJP from raw descriptors g [P, 32], each row through the
        network of its element el [P] (`PallasNi._mlp_eat_dedg`,
        meng_zhang_tpu/ops/pallas_ni.py:339): (eat [P], dedg [P, 32], zero
        beyond nsf, ni_force's input)."""
        # ni normalisation (G - min) * 1/(max - min)
        eat, dedg = fa.mlp_eat_dedg(
            self.cfg, self.nets, (g[:, :self.nsf] - self.shift) * self.scale,
            self.scale, el)
        return eat, torch.nn.functional.pad(dedg, (0, NSF_SUB - self.nsf))

    def _eval_fj(self, dxx, dxy, dxz, el=None):
        g_fn = ni_g_plain if self.plain else kernels.ni_g
        f_fn = ni_force_plain if self.plain else kernels.ni_force
        with profiling.span("eval.descriptors"):
            g = g_fn(dxx, dxy, dxz, self.table)
        with profiling.span("eval.network"):
            eat, dedg = self._mlp_eat_dedg(g, el)
        with profiling.span("eval.forces"):
            return eat, f_fn(dxx, dxy, dxz, dedg, self.table)

    def energy_forces_short(self, x, box, sl: fa.ShortList, want_virial=True,
                            shift=False, per_atom=False, elems=None,
                            x_ext=None):
        """(E, F [N, 3]), then W [3, 3] with want_virial, then eatom [N]
        and vatom [N, 6] with per_atom (the contract of
        `PallasNi.energy_forces_short(per_atom=True)`,
        meng_zhang_tpu/ops/pallas_ni.py:372-417), against a refresh-static
        ShortList (rows into x_ext in a thin box, as in FusedAnnp). E is
        shift-free unless shift=True; the light MD step passes
        want_virial=False and skips W. Short-list overflow NaN-poisons E,
        F, eatom and vatom."""
        return fa.evaluate_pairs(self._eval_fj, x, box, sl.sidx, sl.overflow,
                                 self.pbc, self.cfg.e_shift, shift,
                                 want_virial, per_atom,
                                 self.elems if elems is None else elems,
                                 x_ext)

    def energy_forces(self, x, box, nbr_idx, want_virial=True, shift=False,
                      per_atom=False, elems=None):
        """Full evaluation from a skin list: compact to Ks at the
        descriptor cutoff + short_delta, then the per-step evaluation."""
        return self.energy_forces_short(x, box,
                                        self.compact_short(x, box, nbr_idx),
                                        want_virial, shift, per_atom, elems)
