"""Synthetic ANNP and ANNA-ADP potentials of the shipped shapes (numpy
only).

The shipped `fe_annp_potential_2.ann`, `ni_annp_potential_2.ann` and
`fe_adp_potential_2310.anna` are not part of the repository, so the port's
tests and `chip_smoke.py` run on potentials with the same shapes and
random weights drawn from a seed:

  * fe (Chebyshev): npsf 9 + ntsf 19 = 28 descriptors, two hidden layers of
    10 nodes, rc 6.5 A, activation flags (4, 4, 0), FE activation style,
    Gaussian normalisation;
  * ni (Behler-Parrinello): npsf 3 + ntsf 24 = 27 descriptors, two hidden
    layers of 24 nodes, Rc 7.3699319 Bohr, min-max normalisation, NI
    activation style (the shape tests/test_potential_io.py pins);
  * ANNA-ADP: npsf 9 + ntsf 19 raw Chebyshev descriptors, two hidden
    layers of 6 nodes, two outputs (d2, q2), Rc 5.055 A, activation flags
    (modified, modified, linear) in the ANNA style, e_base -4473.0075,
    e_scale 1, and 17 global ADP parameters chosen to hold bcc-Fe.

`with_elements` gives either ANNP more elements whose networks are small
perturbations of the first's (`synthetic_fe_potential_multi`,
`synthetic_ni_potential_multi`).

Kernel cost does not depend on the weight values, and both packages
evaluate the same numbers from them.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .geometry.lattice import bcc, fcc
from .io.potential import (ACT_LINEAR, ACT_MTANH, ACT_TANH, ACT_TTANH,
                           ActivationStyle, AnnaPotential, AnnpPotential,
                           NetworkParams, SYM_BEHLER, SYM_CHEBYSHEV)
from .units import CFLENGTH, MASS_FE, MASS_NI

RC_NI_BOHR = 7.3699319        # the shipped ni coefficient tables' Rc
NI_ETAS = (0.01, 0.02, 0.05)  # the shipped radial etas
# angular rows (eta, lambda, zeta): 3 eta groups x lambda -1, +1 x zeta
# 1, 2, 4, 16, ending with (0.05, 1, 16) as the shipped table does
NI_ANGULAR = tuple((eta, lam, zeta) for eta in NI_ETAS for lam in (-1.0, 1.0)
                   for zeta in (1.0, 2.0, 4.0, 16.0))
# A BP table at the kernels' full reach, nsf = 10 + 22 = 32: ten radial
# etas, and 22 angular rows at 20 distinct etas (the first two hold two
# functions each) over 22 distinct (lambda, zeta) shapes, lambda -1 and +1
# x zeta 1, 1.5, 2, 3, 4, 5, 6, 8, 10, 12, 16: the power-of-two zetas'
# squaring chains broken by pow shapes, more shapes than ni_force holds at
# once, and eta groups of one or two shapes each
NI_WIDE_RAD_ETAS = tuple(np.geomspace(0.004, 0.2, 10).tolist())
_NI_WIDE_ETAS = np.geomspace(0.002, 0.1, 20).tolist()
NI_WIDE_ANGULAR = tuple(
    (eta, lam, zeta) for eta, (lam, zeta) in zip(
        _NI_WIDE_ETAS[:2] + _NI_WIDE_ETAS,
        [(lam, zeta) for lam in (-1.0, 1.0)
         for zeta in (1.0, 1.5, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0, 12.0,
                      16.0)]))


def _chebyshev_g_np(x, box, npsf, ntsf, rc, rows=None):
    """Raw Chebyshev descriptors [len(rows), npsf + ntsf] of a fully
    periodic box (the definition of models/descriptors.chebyshev_g, in
    numpy); rows defaults to every atom."""
    rows = range(len(x)) if rows is None else rows
    out = np.zeros((len(rows), npsf + ntsf))
    for o, i in enumerate(rows):
        dx = x[i] - x
        dx -= box * np.round(dx / box)
        r = np.sqrt((dx * dx).sum(1))
        keep = (r < rc) & (r > 1.0e-6)
        r, dx = r[keep], dx[keep]
        fc = 0.5 * (np.cos(np.pi / rc * r) + 1.0)
        xr = 2.0 * r / rc - 1.0
        t = [np.ones_like(xr), xr]
        for _ in range(2, npsf):
            t.append(2.0 * xr * t[-1] - t[-2])
        out[o, :npsf] = [(tm * fc).sum() for tm in t[:npsf]]
        u = dx / r[:, None]
        xa = 0.5 * (u @ u.T + 1.0)
        w = fc[:, None] * fc[None, :]
        np.fill_diagonal(w, 0.0)
        tp, tc = np.ones_like(xa), xa
        sums = [(w * tp).sum(), (w * tc).sum()]
        for _ in range(2, ntsf):
            tp, tc = tc, 2.0 * xa * tc - tp
            sums.append((w * tc).sum())
        out[o, npsf:] = 0.5 * np.asarray(sums[:ntsf])
    return out


def thermal_bcc(cells, seed=0, disp=0.08):
    """bcc-Fe block of `cells` (int or 3-tuple) unit cells, a = 2.8553 A,
    with Gaussian displacements of `disp` A per component drawn from
    `seed`; returns numpy (x [N, 3], box [3])."""
    x, box = bcc(cells)
    return x + np.random.default_rng(seed).normal(scale=disp,
                                                  size=x.shape), box


def _paired_wells(rng, g0n, nnod, v_scale):
    """Random weights (w1, w2, w3), (b1, b2, b3) of a two-hidden-layer
    network whose energy has a stable minimum at the normalised
    descriptors g0n [nsf] of the perfect lattice (a fully random network
    leaves the crystal mechanically unstable: it melts within a few hundred
    steps). First-layer units come in pairs z = +-v.(g - g0) + c, c < 0;
    f(z+) + f(z-) is then an even well in v.g, of width about 1/(2|v|) in
    normalised units (|v| ~ v_scale) and bounded depth, so that atoms near
    a free surface, far outside every well, gain little energy by crowding
    their neighbours. Second-layer units weigh both units of a pair alike
    with weights >= 0 and the output weights are positive, so each well
    survives the monotone activations."""
    if nnod % 2:
        raise ValueError("nnod must be even (first-layer units in pairs)")
    nsf = len(g0n)
    npair = nnod // 2
    v = v_scale * rng.normal(size=(npair, nsf)) / np.sqrt(nsf)
    c = -rng.uniform(0.5, 1.5, npair)
    w1 = np.empty((nnod, nsf))
    w1[0::2], w1[1::2] = v, -v
    b1 = np.empty(nnod)
    b1[0::2], b1[1::2] = c - v @ g0n, c + v @ g0n
    w2 = np.repeat(rng.uniform(0.0, 0.5, (nnod, npair)), 2, axis=1)
    w3 = np.abs(rng.normal(size=(1, nnod))) / np.sqrt(nnod)
    return (w1, w2, w3), (b1, 0.1 * rng.normal(size=nnod), np.zeros(1))


def _cells_for(cells, cut, a):
    """`cells`, or more where a periodic cube of `cells` unit cells of edge
    `a` is no wider than 2 cut: the minimum-image descriptors of the
    normalisation boxes would miss the partners beyond half the box."""
    return max(cells, int(2.0 * cut / a) + 1)


def synthetic_fe_potential(seed=0, npsf=9, ntsf=19, nnod=10, cut=6.5,
                           e_scale=0.1) -> AnnpPotential:
    """A Chebyshev ANNP of the shipped fe shape with seeded random weights.

    Normalisation rows: norm_row1 is the mean and norm_row0 the mean square
    of the raw descriptors over a 5x5x5 bcc box (a = 2.8553 A; at cut 9.7 A,
    whose box must exceed 2 cut, every 4th atom of 7^3 cells, to keep the
    build to seconds) with Gaussian displacements of 0.1 A per component,
    so norm_row0 > norm_row1**2 and the normalised network inputs are O(1)
    in bulk.

    The weights are random but arranged so that the perfect lattice is a
    stable minimum (`_paired_wells`); e_scale sets its stiffness.
    A weaker potential melts: at RMS forces near 0.05 eV/A the 300 K
    lattice drifts by 0.4 A in 200 steps and its rows within rc + 0.4 A
    outgrow the short list's 128 slots. The default e_scale = 0.1 was
    chosen on the 152,880-atom benchmark slab (chip_smoke.py, 300 steps of
    y-coupled NPT at 300 K): the crystal and its free surfaces hold, the
    box stays within 0.3 % of its start, at most 126 partners lie within
    6.9 A and no atom moves more than 0.15 A in a 10-step short-list epoch.
    On a periodic 432-atom bcc box held at 300 K (NVT, f64, this package's
    evaluator) it gives an RMS force component of 0.52 eV/A, an RMS
    displacement of 0.060 A and a thermal pressure near 385 kbar: the wells
    stiffen under disorder, far more than real iron does. On the slab the
    y-coupled pressure stays within a few tens of kbar. e_shift = -4479.8 eV
    (with e_atom 0) puts the energy per atom near the shipped potential's,
    so the shift-free energy bookkeeping is exercised at its real
    magnitude.
    """
    rng = np.random.default_rng(seed)
    nsf = npsf + ntsf
    cells = _cells_for(5, cut, 2.8553)
    x, box = thermal_bcc(cells, seed=12345, disp=0.1)
    g = _chebyshev_g_np(x, box, npsf, ntsf, cut,
                        rows=None if cells == 5 else range(0, len(x), 4))
    norm_row1 = g.mean(0)
    norm_row0 = (g * g).mean(0)
    scale = 1.0 / np.sqrt(norm_row0 - norm_row1 ** 2)
    g0n = (_chebyshev_g_np(*bcc(cells), npsf, ntsf, cut, rows=[0])[0]
           - norm_row1) * scale
    weights, biases = _paired_wells(rng, g0n, nnod, 2.0)
    net = NetworkParams(weights=weights, biases=biases,
                        flagact=(ACT_TTANH, ACT_TTANH, ACT_LINEAR),
                        act_style=ActivationStyle.FE)
    return AnnpPotential(
        elements=("Fe",), masses=np.asarray([MASS_FE]), ntl=4, nhl=2,
        nnod=nnod, nsf=nsf, npsf=npsf, ntsf=ntsf, cut=float(cut),
        flagsym=SYM_CHEBYSHEV, norm_row0=norm_row0, norm_row1=norm_row1,
        norm_style="gaussian", e_scale=float(e_scale), e_shift=-4479.8,
        e_atom=0.0, networks=(net,), sym_coerad=None, sym_coeang=None)


def _behler_g_np(x, box, coerad, coeang, rows=None):
    """Raw Behler-Parrinello descriptors [len(rows), npsf + ntsf] of a fully
    periodic box (the definition of models/descriptors.behler_g, in numpy:
    lengths in Bohr, the j-k leg from the displacement difference, terms
    with 1 + lambda cos <= 0 skipped); rows defaults to every atom."""
    rows = range(len(x)) if rows is None else rows
    npsf = len(coerad)
    rc_a = coeang[0, 3]
    rc = max(coerad[:, 2].max(), rc_a) / CFLENGTH

    def fc(rb, rcb):
        return 0.5 * (np.cos(np.pi / rcb * rb) + 1.0)

    out = np.zeros((len(rows), npsf + len(coeang)))
    for o, i in enumerate(rows):
        dx = x[i] - x
        dx -= box * np.round(dx / box)
        r = np.sqrt((dx * dx).sum(1))
        keep = (r < rc) & (r > 1.0e-6)
        dx, r = dx[keep], r[keep]
        rm = r * CFLENGTH
        for m, (eta, _, rc_r) in enumerate(coerad):
            out[o, m] = np.where(rm < rc_r, np.exp(-eta * rm * rm)
                                 * fc(rm, rc_r), 0.0).sum()
        u = dx / r[:, None]
        cos = u @ u.T
        djk = dx[None, :, :] - dx[:, None, :]
        rjk = np.sqrt((djk * djk).sum(-1)) * CFLENGTH
        legs = (rm[:, None] < rc_a) & (rm[None, :] < rc_a) & (rjk < rc_a)
        np.fill_diagonal(legs, False)
        r2sum = rm[:, None] ** 2 + rm[None, :] ** 2 + rjk ** 2
        fc3 = fc(rm, rc_a)[:, None] * fc(rm, rc_a)[None, :] * fc(rjk, rc_a)
        for n, (eta, lam, zeta, _) in enumerate(coeang):
            flag = 1.0 + lam * cos
            ok = legs & (flag > 0.0)
            term = (2.0 ** (1.0 - zeta) * np.where(ok, flag, 1.0) ** zeta
                    * np.exp(-eta * r2sum) * fc3)
            out[o, npsf + n] = 0.5 * np.where(ok, term, 0.0).sum()
    return out


def _radial_derivs(coerad, r, h=1.0e-3):
    """First and second r-derivatives of each radial basis function
    exp(-eta r^2) fc(r) at r (Bohr), by central differences."""
    def basis(x):
        return np.array([np.exp(-eta * x * x)
                         * 0.5 * (np.cos(np.pi / rc * x) + 1.0)
                         for eta, _, rc in coerad])
    b = [basis(r - h), basis(r), basis(r + h)]
    return (b[2] - b[0]) / (2.0 * h), (b[2] - 2.0 * b[1] + b[0]) / (h * h)


def thermal_fcc(cells, seed=0, disp=0.08, a=3.52):
    """fcc block of `cells` (int or 3-tuple) unit cells, lattice constant
    `a` (fcc-Ni 3.52 A), with Gaussian displacements of `disp` A per
    component drawn from `seed`; returns numpy (x [N, 3], box [3])."""
    x, box = fcc(cells, a)
    return x + np.random.default_rng(seed).normal(scale=disp,
                                                  size=x.shape), box


def synthetic_ni_potential(seed=0, npsf=3, nnod=24, rc_bohr=RC_NI_BOHR,
                           ang=NI_ANGULAR, w_out=2.0,
                           rad_etas=NI_ETAS) -> AnnpPotential:
    """A Behler-Parrinello ANNP of the shipped ni shape with seeded random
    weights.

    Coefficient tables: radial rows (eta, 0, Rc) for the first npsf of
    rad_etas (default the shipped 0.01, 0.02, 0.05; NI_WIDE_RAD_ETAS and
    NI_WIDE_ANGULAR give a table of 32 functions); angular rows (eta,
    lambda, zeta, Rc) from `ang` (ntsf = len(ang)). No test pins the
    shipped angular etas, so the default table reuses the radial three: 3
    eta groups x lambda -1, +1 x zeta 1, 2, 4, 16 = 24 rows, ending with
    (0.05, 1, 16, 7.3699319) as the shipped file does. rc_bohr is every row's Rc (7.3699319 Bohr =
    3.90 A); the header cutoff stays the shipped 6.5 A, or is Rc where Rc
    lies beyond it (the chunked functions evaluate within the smaller of
    the two, `models/annp.descriptor_cutoff`).

    Normalisation is min-max, (G - min) / (max - min), with min and max
    taken over the descriptors of a 4x4x4 fcc box (a = 3.52 A; at Rc 9.2 A,
    whose box must exceed 2 Rc, every 16th atom of 6^3 cells) with
    Gaussian displacements of 0.2 A per component, each widened by 5 % of
    its span. A 0.1 A box would give the (1 - cos)^16 columns spans near
    1e-6, and their normalised values would then reach ~10 at 0.15 A.
    Activations: tanh hidden layers, linear output, NI style.

    The weights are random but arranged so that the perfect fcc lattice is
    a stable minimum. nnod/2 - 1 pairs of first-layer units form wells
    (`_paired_wells`, width about 1/16 in normalised units); w_out scales
    the output layer and with it the energy (in Hartree; the model
    multiplies it by NI_HARTREE_EV). The wells see each atom's descriptors
    only to first order in shell sums, which shear leaves unchanged: alone
    they leave the transverse modes quartic and the lattice drifts (0.33 A
    RMS in 100 steps at 400 K). So the last pair becomes one cohesion unit,
    linear near the lattice, whose input is sum_m c_m (G_m - G0_m) over
    the radial descriptors: a pair potential phi(r) = sum_m c_m
    exp(-eta_m r^2) fc(r) with phi' = 0 and phi'' = 1 per Bohr^2 at the
    first shell (2.49 A) and phi'' = 0 at the second (3.52 A), where a
    negative curvature would soften <100> modes. Nearest-neighbour springs
    make fcc rigid: on a 108-atom box every Hessian eigenvalue but the
    three translations is >= 0.5 eV/A^2 (f64 plain path).

    On a periodic 864-atom box (6^3 cells) NVT at 1200 K from 600 K (dt
    1 fs, tau_t 0.1 ps, f32, the port's plain path on the CPU) the
    temperature dips to ~200 K and recovers to ~375 K in 100 steps, the
    RMS displacement levels off at 0.12 A, at most 22 partners lie within
    rc + 0.2 = 4.10 A (Ks = 32; fcc has 18, its third shell of 24 sits at
    4.31 A), and the thermal pressure is ~330 kbar. On the 256,000-atom
    scene of `scripts/model_bench.py --model ni` on an NVIDIA H100 (f32,
    the CUDA kernels, chip_smoke.py) the temperature reads 560 K after 5
    steps, 187 K at step 40 and 348 K at step 100, the widest short row
    holds 25 of 32 partners, and the pressure stays within 278-359 kbar.
    A weaker or plainly random potential melts the crystal and the thermal
    rows outgrow Ks. The network is stiff: forces reach hundreds of eV/A
    on a box displaced by 0.08 A per component.
    """
    rng = np.random.default_rng(seed)
    coerad = np.array([(eta, 0.0, rc_bohr) for eta in rad_etas[:npsf]])
    coeang = np.array([(eta, lam, zeta, rc_bohr) for eta, lam, zeta in ang])
    cells = _cells_for(4, rc_bohr / CFLENGTH, 3.52)
    x, box = thermal_fcc(cells, seed=12345, disp=0.2)
    g = _behler_g_np(x, box, coerad, coeang,
                     rows=None if cells == 4 else range(0, len(x), 16))
    lo, hi = g.min(0), g.max(0)
    pad = 0.05 * (hi - lo)
    norm_row0, norm_row1 = lo - pad, hi + pad
    g0 = _behler_g_np(*fcc(cells, 3.52), coerad, coeang, rows=[0])[0]
    g0n = (g0 - norm_row0) / (norm_row1 - norm_row0)
    (w1, w2, w3), (b1, b2, b3) = _paired_wells(rng, g0n, nnod, 8.0)
    # cohesion unit: c solves phi'(r1) = 0, phi''(r1) = 1, phi''(r2) = 0
    # (as many conditions as radial functions, on the first three at most)
    (s1, c1), (_, c2) = (_radial_derivs(coerad, r * CFLENGTH)
                         for r in (3.52 / np.sqrt(2.0), 3.52))
    m = min(npsf, 3)
    c = np.zeros(npsf)
    c[:m] = np.linalg.solve(np.stack([s1, c1, c2])[:m, :m],
                            np.array([0.0, 1.0, 0.0])[:m])
    a = c * (norm_row1 - norm_row0)[:npsf]
    w1[-2:] = 0.0
    w1[-2, :npsf] = a
    b1[-2:] = 0.0
    b1[-2] = -a @ g0n[:npsf]
    w2[:, -2:] = (0.5, 0.0)
    net = NetworkParams(weights=(w1, w2, w_out * w3), biases=(b1, b2, b3),
                        flagact=(ACT_TANH, ACT_TANH, ACT_LINEAR),
                        act_style=ActivationStyle.NI)
    return AnnpPotential(
        elements=("Ni",), masses=np.asarray([MASS_NI]), ntl=4, nhl=2,
        nnod=nnod, nsf=npsf + len(coeang), npsf=npsf, ntsf=len(coeang),
        cut=max(6.5, rc_bohr / CFLENGTH), flagsym=SYM_BEHLER,
        norm_row0=norm_row0,
        norm_row1=norm_row1, norm_style="minmax", e_scale=1.0, e_shift=0.0,
        e_atom=0.0, networks=(net,), sym_coerad=coerad, sym_coeang=coeang)


# the extra elements of the multi-element potentials: (symbol, mass)
EXTRA_ELEMENTS = {"Fe": (("Cr", 51.996), ("Mn", 54.938)),
                  "Ni": (("Cu", 63.546), ("Co", 58.933))}
# an extra element's network: element 1's, each weight times
# 1 + W_REL N(0, 1) and each bias plus B_ABS N(0, 1)
W_REL, B_ABS = 0.02, 0.01


def with_elements(pot: AnnpPotential, ne=2, seed=1) -> AnnpPotential:
    """`pot` with ne - 1 more elements (at most 3 in all), whose networks
    are element 1's perturbed by W_REL and B_ABS, drawn from `seed`.
    Descriptors and their normalisation are shared by the elements, as
    the .ann format has it."""
    rng = np.random.default_rng(seed)
    net = pot.networks[0]
    nets, names, masses = [net], [pot.elements[0]], [pot.masses[0]]
    for name, mass in EXTRA_ELEMENTS[pot.elements[0]][:ne - 1]:
        nets.append(NetworkParams(
            weights=tuple(w * (1.0 + W_REL * rng.normal(size=w.shape))
                          for w in net.weights),
            biases=tuple(b + B_ABS * rng.normal(size=b.shape)
                         for b in net.biases),
            flagact=net.flagact, act_style=net.act_style))
        names.append(name)
        masses.append(mass)
    return dataclasses.replace(pot, elements=tuple(names),
                               masses=np.asarray(masses),
                               networks=tuple(nets))


def synthetic_fe_potential_multi(ne=2, seed=0, **kw) -> AnnpPotential:
    """`synthetic_fe_potential(seed, **kw)` with ne elements
    (`with_elements`: Fe, Cr, Mn). At the full fe width the two-element
    one holds the 152,880-atom benchmark slab with types 1/2 drawn 50/50
    at 300 K (chip_smoke.py [multi-fe])."""
    return with_elements(synthetic_fe_potential(seed, **kw), ne)


def synthetic_ni_potential_multi(ne=2, seed=0, **kw) -> AnnpPotential:
    """`synthetic_ni_potential(seed, **kw)` with ne elements (Ni, Cu,
    Co)."""
    return with_elements(synthetic_ni_potential(seed, **kw), ne)


E_BASE_ANNA = -4473.0075        # the shipped .anna file's e_base
# The 17 global ADP parameters (A0, yy, gamma, C0, c1F, c2F, V0, b1, b2,
# delta, r0, r1, hc, d1, q1, d3, q3) of synthetic_anna_potential.
ANNA_GPARAMS = (1000.0, 1.5, 4.0, 0.05, -0.3, 1.0e-3, -0.15, 4.0, 8.0,
                0.02, 0.5, 2.9, 0.3, 0.1, 0.04, 0.01, 0.005)
# A set whose density terms reach the cutoff (gamma 0.6, hc 0.8): there the
# reference's d_rho quirk moves the hand forces away from the gradient by
# far more than rounding, which a test of the quirk needs.
ANNA_GPARAMS_QUIRK = (1.0, 1.5, 0.6, 0.05, -0.3, 1.0e-3, -0.15, 4.0, 8.0,
                      0.02, 0.5, 2.9, 0.8, 0.1, 0.04, 0.01, 0.005)


def synthetic_anna_potential(seed=0, npsf=9, ntsf=19, nnod=6, cut=5.055,
                             gparams=ANNA_GPARAMS, lp0=(0.3, 0.3),
                             elements=("Fe",)) -> AnnaPotential:
    """An ANNA-ADP potential of the shipped shape with seeded random
    network weights, one network per element.

    The network maps the raw Chebyshev descriptors (no normalisation rows in
    ANNA) to (d2, q2). Its first layer is scaled by the descriptors' size:
    w1 = N(0, 1) / sqrt(nsf) / std(G) per column and b1 = -w1 . mean(G),
    with mean and spread taken over a 5x5x5 bcc box (a = 2.8553 A) with
    Gaussian displacements of 0.1 A per component, so that the first
    layer's inputs are O(1) in bulk; the output layer's weights are small
    (0.05 N(0, 1)) and its biases lp0, so that (d2, q2) stay positive and
    near lp0 (1/A) in any environment: the ANNA activation 1.7 tanh(0.3 x)
    bounds every hidden value by 1.7.

    gparams (ANNA_GPARAMS by default): the pair term has its well of depth
    V0 = -0.15 eV at r1 = 2.9 A, just beyond bcc's second shell (2.86 A),
    so that the first two shells push and the lattice sits near zero
    pressure; the density decays as e^-4r from r0 = 0.5 A, below every
    pair distance, and so does the d_rho quirk of the hand forces (the
    autodiff forces differ from them by ~1e-5 eV/A near the cutoff). The
    dipole and quadrupole terms (d1, q1) both vanish on the perfect lattice
    and grow quadratically under any distortion: they stiffen it, and
    d1 = 0.1, q1 = 0.04 keep the stiffness near real iron's. Measured with
    this package in f64 on the CPU: the perfect 128-atom periodic lattice
    carries +20 kbar, and the Hessian of its frozen-(d2, q2) energy has
    eigenvalues from 8.5 to 63 eV/A^2 besides the three translations
    (without d1 and q1: 0.40 to 10); on a periodic 432-atom box in NVE
    from 300 K velocities (the fast path, k_short 72, delta 0.2, 300
    steps) the temperature settles near 150 K (the lattice takes up half
    the kinetic energy), no atom strays more than 0.14 A from its site
    (RMS 0.045 A), the widest row within rc + 0.2 A holds 58 partners, as
    perfect bcc does (the next shell lies at 5.71 A), and (d2, q2) stay
    within 0.29-0.34 /A. The forces freeze (d2, q2), so NVE conserves
    energy only approximately (here to 0.02 eV in 300 steps).
    tests/test_torch_anna_md.py::test_synthetic_anna_holds_bcc checks the
    128-atom figures and a 100-step NVE run of that box.
    """
    rng = np.random.default_rng(seed)
    nsf = npsf + ntsf
    x, box = thermal_bcc(5, seed=12345, disp=0.1)
    g = _chebyshev_g_np(x, box, npsf, ntsf, cut)
    mean, std = g.mean(0), np.maximum(g.std(0), 1e-6)
    nets = []
    for _ in elements:
        w1 = rng.normal(size=(nnod, nsf)) / np.sqrt(nsf) / std
        b1 = -w1 @ mean
        w2 = rng.normal(size=(nnod, nnod)) / np.sqrt(nnod)
        b2 = 0.1 * rng.normal(size=nnod)
        w3 = 0.05 * rng.normal(size=(2, nnod))
        nets.append(NetworkParams(
            weights=(w1, w2, w3), biases=(b1, b2, np.asarray(lp0, float)),
            flagact=(ACT_MTANH, ACT_MTANH, ACT_LINEAR),
            act_style=ActivationStyle.ANNA))
    return AnnaPotential(
        elements=tuple(elements),
        masses=np.asarray([MASS_FE] * len(elements)), ntl=4, nhl=2,
        nnod=nnod, nout=2, nsf=nsf, npsf=npsf, ntsf=ntsf, cut=float(cut),
        flagsym=SYM_CHEBYSHEV, e_base=E_BASE_ANNA, e_scale=1.0,
        gparams=np.asarray(gparams, dtype=np.float64), networks=tuple(nets))


def anna_text(pot: AnnaPotential) -> str:
    """`pot` as `.anna` text at the fixed line offsets `read_anna` reads
    (pair_anna_adp.cpp:392-562), numbers with 17 significant digits so
    that they read back to the bit. Test tooling: the JAX package writes no
    `.anna` file either."""
    act = {ACT_LINEAR: "linear", ACT_TANH: "hyperbolic", ACT_MTANH: "modified",
           ACT_TTANH: "tanh"}

    def nums(a):
        return "\t".join(f"{v:.17g}" for v in np.ravel(a))

    ne = len(pot.elements)
    lines = ["#ANNA-ADP potential (synthetic)", "#", "#", "",
             "#element parameters_(nelement #n element mass)", str(ne)]
    lines += [f"{k + 1}\t{el}\t{m:.17g}"
              for k, (el, m) in enumerate(zip(pot.elements, pot.masses))]
    lines += ["", "#ann parameters_(TL HL Nodes_HL Nout Num_SF Num_PSF "
              "Num_TSF Cut)",
              "\t".join(str(v) for v in (pot.ntl, pot.nhl, pot.nnod, pot.nout,
                                         pot.nsf, pot.npsf, pot.ntsf))
              + f"\t{pot.cut:.17g}", "",
              "#types of symmetry function and activation function",
              "\t".join(["Chebyshev"] + [act[f] for f in
                                         pot.networks[0].flagact]), "",
              "#energy_(E_base E_scale)",
              f"{pot.e_base:.17g}\t{pot.e_scale:.17g}", "",
              "#global parameters", str(len(pot.gparams)), nums(pot.gparams)]
    for el, net in zip(pot.elements, pot.networks):
        lines.append(f"#{el}")
        for layer, (w, b) in enumerate(zip(net.weights, net.biases), start=1):
            lines.append(f"#{layer}_(weight)")
            lines += [nums(row) for row in w]
            # bias rows hold nnod entries; the last layer uses the first nout
            lines.append(f"#{layer}_(bias)")
            lines.append(nums(np.pad(b, (0, pot.nnod - len(b)))))
    return "\n".join(lines) + "\n"
