"""Synthetic fe Chebyshev-ANNP potentials of the shipped shape (numpy only).

The shipped `fe_annp_potential_2.ann` is not part of the repository, so the
port's tests and `chip_smoke.py` run on a potential with the same shape --
npsf 9 + ntsf 19 = 28 descriptors, two hidden layers of 10 nodes, rc 6.5 A,
activation flags (4, 4, 0), FE activation style, Gaussian normalisation --
and random weights drawn from a seed. Kernel cost does not depend on the
weight values, and both packages evaluate the same numbers from it.
"""
from __future__ import annotations

import numpy as np

from meng_zhang_tpu.geometry.lattice import bcc
from meng_zhang_tpu.io.potential import (ACT_LINEAR, ACT_TTANH,
                                         ActivationStyle, AnnpPotential,
                                         NetworkParams, SYM_CHEBYSHEV)
from meng_zhang_tpu.units import MASS_FE


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


def synthetic_fe_potential(seed=0, npsf=9, ntsf=19, nnod=10, cut=6.5,
                           e_scale=0.1) -> AnnpPotential:
    """A Chebyshev ANNP of the shipped fe shape with seeded random weights.

    Normalisation rows: norm_row1 is the mean and norm_row0 the mean square
    of the raw descriptors over a 5x5x5 bcc box (a = 2.8553 A) with Gaussian
    displacements of 0.1 A per component, so norm_row0 > norm_row1**2 and
    the normalised network inputs are O(1) in bulk.

    The weights are random but arranged so that the perfect lattice is a
    stable minimum (see the comment below); e_scale sets its stiffness.
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
    x, box = thermal_bcc(5, seed=12345, disp=0.1)
    g = _chebyshev_g_np(x, box, npsf, ntsf, cut)
    norm_row1 = g.mean(0)
    norm_row0 = (g * g).mean(0)
    # Random weights arranged so that the perfect lattice is a stable
    # minimum (a fully random network leaves bcc mechanically unstable: the
    # crystal melts within a few hundred steps). First-layer units come in
    # pairs z = +-v.(g - g0) + c, c < 0, centred on the perfect lattice's
    # normalised descriptors g0; f(z+) + f(z-) is then an even well in v.g,
    # of width about 1/(2|v|) in normalised units and bounded depth, so
    # that atoms near a free surface, far outside every well, gain little
    # energy by crowding their neighbours. Second-layer units weigh both
    # units of a pair alike with weights >= 0 and the output weights are
    # positive, so each well survives the monotone activations.
    if nnod % 2:
        raise ValueError("nnod must be even (first-layer units in pairs)")
    npair = nnod // 2
    scale = 1.0 / np.sqrt(norm_row0 - norm_row1 ** 2)
    g0n = (_chebyshev_g_np(*bcc(5), npsf, ntsf, cut, rows=[0])[0]
           - norm_row1) * scale
    v = 2.0 * rng.normal(size=(npair, nsf)) / np.sqrt(nsf)
    c = -rng.uniform(0.5, 1.5, npair)
    w1 = np.empty((nnod, nsf))
    w1[0::2], w1[1::2] = v, -v
    b1 = np.empty(nnod)
    b1[0::2], b1[1::2] = c - v @ g0n, c + v @ g0n
    w2 = np.repeat(rng.uniform(0.0, 0.5, (nnod, npair)), 2, axis=1)
    w3 = np.abs(rng.normal(size=(1, nnod))) / np.sqrt(nnod)
    weights = (w1, w2, w3)
    biases = (b1, 0.1 * rng.normal(size=nnod), np.zeros(1))
    net = NetworkParams(weights=weights, biases=biases,
                        flagact=(ACT_TTANH, ACT_TTANH, ACT_LINEAR),
                        act_style=ActivationStyle.FE)
    return AnnpPotential(
        elements=("Fe",), masses=np.asarray([MASS_FE]), ntl=4, nhl=2,
        nnod=nnod, nsf=nsf, npsf=npsf, ntsf=ntsf, cut=float(cut),
        flagsym=SYM_CHEBYSHEV, norm_row0=norm_row0, norm_row1=norm_row1,
        norm_style="gaussian", e_scale=float(e_scale), e_shift=-4479.8,
        e_atom=0.0, networks=(net,), sym_coerad=None, sym_coeang=None)
