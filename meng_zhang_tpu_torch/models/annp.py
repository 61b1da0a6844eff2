"""Chebyshev ANNP energy model (plain torch, forces by autograd).

Counterpart of the Chebyshev parts of meng_zhang_tpu/models/annp.py:
`AnnpConfig`, `make_annp` (:58), `atom_energies`, `energy` and
`energy_forces` (:153). It is the slow oracle the fused evaluator
(ops/fused_annp.py) is held against. The Behler-Parrinello (ni) variant is
not ported yet.

Energy bookkeeping: E_i = e_scale * nn(G_i) + e_shift (e_shift includes
e_atom).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from meng_zhang_tpu.io.potential import AnnpPotential, SYM_CHEBYSHEV

from ..system.cell import min_image
from .descriptors import chebyshev_g
from .mlp import mlp_apply


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


def params_from_numpy(params_np, dtype=torch.float64, device="cpu"):
    """The JAX package's params dict (`w`, `b`: per-layer arrays
    [ne, n_out, n_in] / [ne, n_out]; `sf_scale`, `sf_shift` [nsf]), given
    as numpy arrays, as torch tensors of `dtype` on `device`. Both packages
    then compute the same function from the same weights."""
    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)
    return {"w": tuple(t(w) for w in params_np["w"]),
            "b": tuple(t(b) for b in params_np["b"]),
            "sf_scale": t(params_np["sf_scale"]),
            "sf_shift": t(params_np["sf_shift"])}


def make_annp(pot: AnnpPotential, dtype=torch.float32, device="cpu",
              pbc=(True, True, True)):
    """(config, params) from a parsed Chebyshev `.ann` potential."""
    if pot.sym_coerad is not None:
        raise NotImplementedError("the Behler-Parrinello (ni) ANNP is not "
                                  "ported yet")
    cfg = AnnpConfig(
        descriptor=SYM_CHEBYSHEV, npsf=pot.npsf, ntsf=pot.ntsf, cut=pot.cut,
        flagact=tuple(pot.networks[0].flagact),
        act_style=pot.networks[0].act_style, e_scale=pot.e_scale,
        e_shift=pot.e_shift + pot.e_atom, pbc=tuple(pbc))
    ne = len(pot.elements)
    nl = pot.networks[0].n_layers
    params_np = {
        "w": [np.stack([pot.networks[e].weights[l] for e in range(ne)])
              for l in range(nl)],
        "b": [np.stack([pot.networks[e].biases[l] for e in range(ne)])
              for l in range(nl)],
        "sf_scale": pot.sf_scale, "sf_shift": pot.sf_shift}
    return cfg, params_from_numpy(params_np, dtype, device)


def _gather_dx(x, box, nbr_idx, pbc):
    n = x.shape[0]
    x_pad = torch.cat([x, x.new_zeros(1, 3)])
    dx = min_image(x[:, None, :] - x_pad[nbr_idx], box, pbc)
    return dx, nbr_idx < n


def atom_energies(cfg: AnnpConfig, params, x, box, nbr_idx, elems=None):
    """Per-atom energies [N] from positions and a padded neighbor table."""
    dx, mask = _gather_dx(x, box, nbr_idx, cfg.pbc)
    rsq = (dx * dx).sum(dim=-1)
    m = mask & (rsq < cfg.cut * cfg.cut)
    g_raw = chebyshev_g(dx, m, cfg.npsf, cfg.ntsf, cfg.cut)
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
