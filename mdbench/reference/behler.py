"""Behler-Parrinello descriptors of the ni ANNP (the reference's ni
pair_annp.cpp), by their definition, with lengths in Bohr
(r_b = r * CFLENGTH):

    G[m]      = sum_j exp(-eta_m r_b^2) fc(r_b, Rc_m)        r_b < Rc_m
    G[npsf+n] = sum_{j<k} 2^(1-zeta) (1 + lambda cos t_jik)^zeta
                * exp(-eta (r_ij^2 + r_ik^2 + r_jk^2)) fc fc fc

the angular terms only where all three legs lie within Rc and
1 + lambda cos > 0; fc(r, Rc) = (cos(pi r / Rc) + 1) / 2.
"""
from __future__ import annotations

import math

import torch

CFLENGTH = 1.889726          # Angstrom -> Bohr (ni/src/pair_annp.h)
CENSUS_LEGS = True           # work() counts in-cutoff leg pairs


def _fc(rb, rc):
    return 0.5 * (torch.cos(math.pi / rc * rb) + 1.0)


def descriptors(dx, valid, pot, tables, prec):
    """G [R, npsf + ntsf] of rows whose partners lie at dx [R, W, 3]."""
    coerad, coeang = tables["coerad"], tables["coeang"]
    rc = float(pot["cutoff"])                       # Angstrom
    r2 = (dx * dx).sum(-1)
    m = valid & (r2 < rc * rc) & (r2 > 1.0e-12)
    r = torch.sqrt(torch.where(m, r2, 1.0))
    rb = r * CFLENGTH
    radial = []
    for eta, _, rcr in coerad.tolist():
        keep = m & (rb < rcr)
        radial.append(torch.where(keep, torch.exp(-eta * rb * rb)
                                  * _fc(rb, rcr), 0.0).sum(1))

    u = torch.where(m[..., None], dx / r[..., None], 0.0)
    cos = prec.mm(u, u.transpose(1, 2))
    k = dx.shape[1]
    pair = m[:, :, None] & m[:, None, :] & ~torch.eye(
        k, dtype=torch.bool, device=dx.device)
    djk = dx[:, None, :, :] - dx[:, :, None, :]
    rjk = torch.sqrt(torch.where(pair, (djk * djk).sum(-1), 1.0)) * CFLENGTH
    rca = float(coeang[0, 3])
    legs = pair & (rb[:, :, None] < rca) & (rb[:, None, :] < rca) \
        & (rjk < rca)
    r2sum = rb[:, :, None] ** 2 + rb[:, None, :] ** 2 + rjk * rjk
    fc3 = _fc(rb, rca)[:, :, None] * _fc(rb, rca)[:, None, :] \
        * _fc(rjk, rca)
    ang = []
    for eta, lam, zeta, _ in coeang.tolist():
        flag = 1.0 + lam * cos
        ok = legs & (flag > 0.0)
        term = 2.0 ** (1.0 - zeta) * torch.where(ok, flag, 1.0) ** zeta \
            * torch.exp(-eta * r2sum) * fc3
        ang.append(0.5 * torch.where(ok, term, 0.0).sum((1, 2)))
    return torch.stack(radial + ang, dim=1)


def _radial_derivs(coerad, r, h=1.0e-3):
    """First and second r-derivatives (Bohr) of each radial function at r,
    by central differences."""
    import numpy as np

    def basis(v):
        return np.array([np.exp(-eta * v * v) * 0.5
                         * (np.cos(np.pi / rc * v) + 1.0)
                         for eta, _, rc in coerad])
    b = [basis(r - h), basis(r), basis(r + h)]
    return (b[2] - b[0]) / (2.0 * h), (b[2] - 2.0 * b[1] + b[0]) / (h * h)


def make_potential(config, device):
    """The ni BP ANNP of the shipped shape with weights drawn from
    config["potential_seed"]: radial rows (eta, 0, Rc), angular rows
    (eta, lambda, zeta, Rc) from config["angular"]; min-max normalisation
    over a thermal fcc box (config["norm_disp"] A from
    config["norm_seed"]), each span widened by 5 %; wells around the
    perfect lattice (`paired_wells`, scale 8.0) whose last pair is one
    cohesion unit, a pair potential with phi' = 0 and phi'' = 1 per Bohr^2
    at the first shell and phi'' = 0 at the second; tanh hidden layers, the
    output scaled by w_out, in Hartree (e_scale converts to eV)."""
    import numpy as np

    from mdbench.lattice import lattice
    from mdbench.potentials import paired_wells
    from mdbench.reference.model import descriptors_of
    a, rcb = config["lattice_A"], config["rc_bohr"]
    coerad = np.array([(eta, 0.0, rcb) for eta in config["radial_etas"]])
    coeang = np.array([(eta, lam, zeta, rcb)
                       for eta, lam, zeta in config["angular"]])
    npsf = len(coerad)
    cut = rcb / CFLENGTH
    cells = max(4, int(2.0 * cut / a) + 1)
    pot = {"reference": "behler", "cutoff": cut, "npsf": npsf,
           "ntsf": len(coeang), "flagact": [1, 1, 0], "style": "ni",
           "norm_style": "minmax", "e_scale": 51.422515 / CFLENGTH,
           "e_shift": 0.0, "mass": config["mass"], "coerad": coerad,
           "coeang": coeang}
    x, box = lattice("fcc", cells, a)
    noisy = x + np.random.default_rng(config["norm_seed"]).normal(
        scale=config["norm_disp"], size=x.shape)
    rows = None if cells == 4 else range(0, len(x), 16)
    g = descriptors_of(pot, noisy, box, device, rows)
    lo, hi = g.min(0), g.max(0)
    pad = 0.05 * (hi - lo)
    row0, row1 = lo - pad, hi + pad
    g0 = descriptors_of(pot, x, box, device, [0])[0]
    g0n = (g0 - row0) / (row1 - row0)
    rng = np.random.default_rng(config["potential_seed"])
    (w1, w2, w3), (b1, b2, b3) = paired_wells(rng, g0n,
                                              config["hidden"][0], 8.0)
    (s1, c1), (_, c2) = (_radial_derivs(coerad, r * CFLENGTH)
                         for r in (a / np.sqrt(2.0), a))
    m = min(npsf, 3)
    c = np.zeros(npsf)
    c[:m] = np.linalg.solve(np.stack([s1, c1, c2])[:m, :m],
                            np.array([0.0, 1.0, 0.0])[:m])
    amp = c * (row1 - row0)[:npsf]
    w1[-2:] = 0.0
    w1[-2, :npsf] = amp
    b1[-2:] = 0.0
    b1[-2] = -amp @ g0n[:npsf]
    w2[:, -2:] = (0.5, 0.0)
    pot.update(norm_row0=row0, norm_row1=row1,
               weights=[w1, w2, config["w_out"] * w3], biases=[b1, b2, b3])
    return pot


def work(pot, census):
    """{kernel: (FLOPs, bytes)} of one evaluation, and "step": the step's
    FLOPs (descriptors, network forward and input gradient, forces). Per
    in-cutoff lane the geometry (15) and each radial function (cos, exp
    and 8: 10 in ni_g; with sin and dfc 15 in ni_force). A G4 term is
    symmetric in its legs, so per in-cutoff unordered leg pair: its
    geometry (cos, r_jk, sqrt, cos, fc3, r2sum: 20; with sin 24), an exp a
    group of one eta (2), and per function 1 + lambda cos, the zeta
    squarings (2 log2 zeta) and the sum (5 in ni_g; with the derivative
    and two sums 8 in ni_force); ni_force then forms the shared partials in
    cos and r_jk (8) and, on each side, the partial in its own leg and its
    four sums (22). A fused multiply-add counts 2. Per atom the network and
    its input gradient. Bytes in float32: each in-cutoff lane's dx read
    once, the per-atom G (ni_g) or dE/dG (ni_force) row once, Fj written
    once a lane."""
    coeang = pot["coeang"]
    n_r, n_f = len(pot["coerad"]), len(coeang)
    n_eta = len({float(row[0]) for row in coeang})
    zl = sum(int(row[2]).bit_length() - 1 for row in coeang)
    lanes, legs, atoms = census["lanes"], census["legs"], census["atoms"]
    nsf = n_r + n_f
    g = lanes * (15 + 10 * n_r) + legs * (20 + 2 * n_eta + 5 * n_f + 2 * zl)
    f = lanes * (15 + 15 * n_r) + legs * (24 + 2 * n_eta + 8 * n_f + 2 * zl
                                          + 8 + 2 * 22)
    sizes = [nsf] + [len(b) for b in pot["biases"]]
    mlp = 4 * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    return {
        "ni_g": (g, 4 * (3 * lanes + atoms * nsf)),
        "ni_force": (f, 4 * (6 * lanes + atoms * nsf)),
        "step": g + f + atoms * mlp,
    }
