"""Chebyshev descriptors of the fe ANNP (the reference's fe_v2
pair_annp.cpp), by their definition:

    G[m]      = sum_j T_m(2 r_ij / rc - 1) fc(r_ij)                 m < npsf
    G[npsf+n] = sum_{j<k} T_n((cos t_jik + 1) / 2) fc(r_ij) fc(r_ik) n < ntsf

fc(r) = (cos(pi r / rc) + 1) / 2 inside rc, every partner within rc.
"""
from __future__ import annotations

import math

import torch


def descriptors(dx, valid, pot, tables, prec):
    """G [R, npsf + ntsf] of rows whose partners lie at dx [R, W, 3]."""
    rc, npsf, ntsf = float(pot["cutoff"]), pot["npsf"], pot["ntsf"]
    r2 = (dx * dx).sum(-1)
    m = valid & (r2 < rc * rc) & (r2 > 1.0e-12)
    r = torch.sqrt(torch.where(m, r2, 1.0))
    fc = torch.where(m, 0.5 * (torch.cos(math.pi / rc * r) + 1.0), 0.0)
    xr = 2.0 * r / rc - 1.0
    t = [torch.ones_like(xr), xr]
    for _ in range(2, npsf):
        t.append(2.0 * xr * t[-1] - t[-2])
    radial = [(tm * fc).sum(1) for tm in t[:npsf]]

    u = torch.where(m[..., None], dx / r[..., None], 0.0)
    cos = prec.mm(u, u.transpose(1, 2))
    w = fc[:, :, None] * fc[:, None, :]
    w = w * (1.0 - torch.eye(w.shape[1], dtype=w.dtype, device=w.device))
    x2 = cos + 1.0                       # 2 (cos + 1) / 2
    tp, tc = torch.ones_like(x2), 0.5 * x2

    def wsum(t):
        return torch.einsum("rjk,rjk->r", w, t)

    ang = [wsum(tp), wsum(tc)]
    for _ in range(2, ntsf):
        tp, tc = tc, (x2 * tc).sub_(tp)
        ang.append(wsum(tc))
    return torch.stack(radial + [0.5 * a for a in ang[:ntsf]], dim=1)


def make_potential(config, device):
    """The fe ANNP of the shipped shape (npsf, ntsf, two hidden layers of
    nnod, rc) with weights drawn from config["potential_seed"]:
    normalisation rows from a thermal bcc box (Gaussian displacements of
    config["norm_disp"] A from config["norm_seed"]; norm_row1 the mean,
    norm_row0 the mean square of the raw descriptors), then wells around
    the perfect lattice's normalised descriptors (`paired_wells`, scale
    2.0), activation flags (4, 4, 0) in the fe style."""
    import numpy as np

    from mdbench.lattice import lattice
    from mdbench.potentials import paired_wells
    from mdbench.reference.model import descriptors_of
    a, cut = config["lattice_A"], float(config["cutoff_A"])
    cells = max(5, int(2.0 * cut / a) + 1)
    pot = {"reference": "chebyshev", "cutoff": cut, "npsf": config["npsf"],
           "ntsf": config["ntsf"], "flagact": [4, 4, 0], "style": "fe",
           "norm_style": "gaussian", "e_scale": config["e_scale"],
           "e_shift": config["e_shift"], "mass": config["mass"]}
    x, box = lattice("bcc", cells, a)
    noisy = x + np.random.default_rng(config["norm_seed"]).normal(
        scale=config["norm_disp"], size=x.shape)
    rows = None if cells == 5 else range(0, len(x), 4)
    g = descriptors_of(pot, noisy, box, device, rows)
    row1, row0 = g.mean(0), (g * g).mean(0)
    scale = 1.0 / np.sqrt(row0 - row1 ** 2)
    g0n = (descriptors_of(pot, x, box, device, [0])[0] - row1) * scale
    rng = np.random.default_rng(config["potential_seed"])
    w, b = paired_wells(rng, g0n, config["hidden"][0], 2.0)
    pot.update(norm_row0=row0, norm_row1=row1, weights=w, biases=b)
    return pot


def work(pot, census):
    """{kernel: (FLOPs, bytes)} of one evaluation, and "step": the step's
    FLOPs (descriptors, network forward and input gradient, forces), on
    the harmonic form's per-lane figures whichever evaluation runs: the
    pair geometry 20 a lane, a radial Chebyshev term 4 (g) or 8 (force:
    T and T'), a harmonic (l, m >= 0) step 9 (g_harm: H, w, the two A sums)
    or 22 (force_harm: H, dH, the B contractions) and 30 more a lane in
    force_harm; a fused multiply-add counts 2, a sqrt, cos or sin 1. Per
    atom: the power sums and the Chebyshev-Legendre products, the network
    and its input gradient. Bytes in float32: each in-cutoff lane's dx read
    once, the per-atom rows (g: npsf + ntsf + 1 columns, A: (ntsf)^2 of
    them; force: npsf + ntsf^2 + 1 coefficients) read or written once, Fj
    written once a lane."""
    npsf, ntsf = pot["npsf"], pot["ntsf"]
    lanes, atoms = census["lanes"], census["atoms"]
    n_lm = ntsf * (ntsf + 1) // 2
    n_harm = ntsf * ntsf
    g_lane = 20 + 4 * npsf + 9 * n_lm
    f_lane = 20 + 8 * npsf + 22 * n_lm + 30
    sizes = [npsf + ntsf] + [len(b) for b in pot["biases"]]
    mlp = 4 * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    atom = 2 * n_harm + 4 * ntsf * ntsf + mlp
    return {
        "g_harm": (lanes * g_lane,
                   4 * (3 * lanes + atoms * (npsf + ntsf + 1 + n_harm))),
        "force_harm": (lanes * f_lane,
                       4 * (6 * lanes + atoms * (npsf + n_harm + 1))),
        "step": lanes * (g_lane + f_lane) + atoms * atom,
    }
