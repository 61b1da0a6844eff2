"""ANNP energy model, Chebyshev (fe) and Behler-Parrinello (ni) variants
(plain torch, forces by autograd).

Counterpart of meng_zhang_tpu/models/annp.py: `NI_HARTREE_EV` (:36),
`AnnpConfig`, `make_annp` (:58), `effective_cutoff` (:96),
`atom_energies` with its descriptor dispatch (:111-146), `energy`,
`energy_forces` (:153) and `descriptor_cutoff` (:397). It is the slow
oracle the fused evaluators (ops/fused_annp.py, ops/fused_ni.py) are held
against.

Energy bookkeeping: E_i = e_scale * nn(G_i) + e_shift. fe: e_shift
includes e_atom. ni: the network's output is in Hartree and e_scale is
NI_HARTREE_EV = CFFORCE / CFLENGTH, so E is in eV and -dE/dx reproduces
the reference's CFFORCE-converted forces; e_shift is 0.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..io.potential import AnnpPotential, SYM_BEHLER, SYM_CHEBYSHEV
from ..system.cell import min_image
from ..units import CFFORCE, CFLENGTH
from .descriptors import behler_g, chebyshev_g
from .mlp import mlp_apply

NI_HARTREE_EV = CFFORCE / CFLENGTH   # 27.2115951, the Hartree -> eV factor
                                     # the reference's force conversion implies


@dataclasses.dataclass(frozen=True)
class AnnpConfig:
    """Static model configuration (same fields as the JAX AnnpConfig)."""
    descriptor: int
    npsf: int
    ntsf: int
    cut: float
    flagact: tuple
    act_style: str
    e_scale: float
    e_shift: float
    pbc: tuple = (True, True, True)

    @property
    def nsf(self) -> int:
        return self.npsf + self.ntsf


def params_from_numpy(params_np, dtype=torch.float64, device="cuda"):
    """The JAX package's params dict (`w`, `b`: per-layer arrays
    [ne, n_out, n_in] / [ne, n_out]; `sf_scale`, `sf_shift` [nsf]; for the
    BP variant also `coerad` [npsf, 3] and `coeang` [ntsf, 4]), given as
    numpy arrays, as torch tensors of `dtype` on `device`. Both packages
    then compute the same function from the same weights."""
    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)
    out = {"w": tuple(t(w) for w in params_np["w"]),
           "b": tuple(t(b) for b in params_np["b"]),
           "sf_scale": t(params_np["sf_scale"]),
           "sf_shift": t(params_np["sf_shift"])}
    for key in ("coerad", "coeang"):
        if key in params_np:
            out[key] = t(params_np[key])
    return out


def make_annp(pot: AnnpPotential, dtype=torch.float32, device="cuda",
              pbc=(True, True, True)):
    """(config, params) from a parsed `.ann` potential.

    The BP (ni) variant is selected by the presence of the symmetry-function
    coefficient tables, whatever the file's descriptor label; its params
    also carry `coerad` and `coeang`."""
    is_ni = pot.sym_coerad is not None
    net = pot.networks[0]
    if is_ni:
        cfg = AnnpConfig(
            descriptor=SYM_BEHLER, npsf=pot.npsf, ntsf=pot.ntsf, cut=pot.cut,
            flagact=tuple(net.flagact), act_style=net.act_style,
            e_scale=NI_HARTREE_EV, e_shift=0.0, pbc=tuple(pbc))
    else:
        cfg = AnnpConfig(
            descriptor=SYM_CHEBYSHEV, npsf=pot.npsf, ntsf=pot.ntsf,
            cut=pot.cut, flagact=tuple(net.flagact), act_style=net.act_style,
            e_scale=pot.e_scale, e_shift=pot.e_shift + pot.e_atom,
            pbc=tuple(pbc))
    ne = len(pot.elements)
    nl = pot.networks[0].n_layers
    params_np = {
        "w": [np.stack([pot.networks[e].weights[l] for e in range(ne)])
              for l in range(nl)],
        "b": [np.stack([pot.networks[e].biases[l] for e in range(ne)])
              for l in range(nl)],
        "sf_scale": pot.sf_scale, "sf_shift": pot.sf_shift}
    if is_ni:
        params_np["coerad"] = pot.sym_coerad
        params_np["coeang"] = pot.sym_coeang
    return cfg, params_from_numpy(params_np, dtype, device)


def _bp_cutoff_bohr(coerad, coeang):
    return max(float(np.max(np.asarray(coerad)[:, 2])),
               float(np.max(np.asarray(coeang)[:, 3])))


def effective_cutoff(pot: AnnpPotential) -> float:
    """Smallest neighbor-list cutoff that preserves the model exactly (A):
    the header cutoff for Chebyshev potentials; for BP, where the header's
    6.5 A is the LAMMPS list cutoff, the coefficient tables' Rc
    (7.3699319 Bohr = 3.90 A in the shipped ni file) if that is smaller."""
    if pot.sym_coerad is None:
        return pot.cut
    return min(pot.cut,
               _bp_cutoff_bohr(pot.sym_coerad, pot.sym_coeang) / CFLENGTH)


def descriptor_cutoff(cfg: AnnpConfig, params) -> float:
    """The radius beyond which the descriptors vanish (A): cfg.cut for
    Chebyshev; the coefficient tables' Rc (Bohr -> A) for BP."""
    if cfg.descriptor == SYM_CHEBYSHEV:
        return cfg.cut
    rc_bohr = _bp_cutoff_bohr(params["coerad"].cpu(), params["coeang"].cpu())
    return min(cfg.cut, rc_bohr / CFLENGTH)


def _gather_dx(x, box, nbr_idx, pbc):
    n = x.shape[0]
    x_pad = torch.cat([x, x.new_zeros(1, 3)])
    dx = min_image(x[:, None, :] - x_pad[nbr_idx], box, pbc)
    return dx, nbr_idx < n


def atom_energies(cfg: AnnpConfig, params, x, box, nbr_idx, elems=None):
    """Per-atom energies [N] from positions and a padded neighbor table."""
    dx, mask = _gather_dx(x, box, nbr_idx, cfg.pbc)
    if cfg.descriptor == SYM_CHEBYSHEV:
        rsq = (dx * dx).sum(dim=-1)
        m = mask & (rsq < cfg.cut * cfg.cut)
        g_raw = chebyshev_g(dx, m, cfg.npsf, cfg.ntsf, cfg.cut)
    else:
        g_raw = behler_g(dx, mask, params["coerad"], params["coeang"])
    g = (g_raw - params["sf_shift"]) * params["sf_scale"]
    ne = params["w"][0].shape[0]
    out = None
    for e in range(ne):
        o = mlp_apply([w[e] for w in params["w"]], [b[e] for b in params["b"]],
                      cfg.flagact, cfg.act_style, g)[:, 0]
        if out is None:
            out = o
        else:
            out = torch.where(elems == e, o, out)
    return cfg.e_scale * out + cfg.e_shift


def energy(cfg: AnnpConfig, params, x, box, nbr_idx, elems=None):
    return atom_energies(cfg, params, x, box, nbr_idx, elems).sum()


def energy_forces(cfg: AnnpConfig, params, x, box, nbr_idx, elems=None):
    """(E, F = -dE/dx) through autograd."""
    xg = x.detach().requires_grad_(True)
    with torch.enable_grad():
        e = energy(cfg, params, xg, box, nbr_idx, elems)
        (g,) = torch.autograd.grad(e, xg)
    return e.detach(), -g
