"""Time integrators and thermostats/barostats (LAMMPS metal units).

Counterpart of meng_zhang_tpu/md/integrate.py (the whole module): velocity
Verlet, Langevin (BAOAB's Ornstein-Uhlenbeck half), Nose-Hoover chains and
the MTK barostat masses. Functions take and return tensors and never read a
device value back to the host; random numbers come from an explicit
`torch.Generator`.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from meng_zhang_tpu.units import BOLTZ, MVV2E


class NHCState(NamedTuple):
    """Nose-Hoover chain variables (xi is kept for the conserved
    quantity)."""
    xi: torch.Tensor      # [M]
    v_xi: torch.Tensor    # [M]

    @staticmethod
    def zeros(m=3, dtype=torch.float32, device="cpu"):
        return NHCState(torch.zeros(m, dtype=dtype, device=device),
                        torch.zeros(m, dtype=dtype, device=device))


def kinetic_energy(v, masses):
    """KE in eV; v in A/ps, masses in g/mol."""
    return 0.5 * MVV2E * (masses[:, None] * v * v).sum()


def temperature(v, masses, ndof):
    return 2.0 * kinetic_energy(v, masses) / (ndof * BOLTZ)


def remove_drift(v, masses):
    p = (masses[:, None] * v).sum(dim=0)
    return v - p / masses.sum()


def vv_kick(v, f, masses, dt):
    """Half/full kick: dv = F/m * dt / MVV2E (force eV/A -> A/ps^2)."""
    return v + (dt / MVV2E) * f / masses[:, None]


def vv_drift(x, v, dt):
    return x + dt * v


def nhc_masses(ndof, t_target, tau, m, dtype, device="cpu"):
    q = torch.full((m,), BOLTZ * t_target * tau * tau, dtype=dtype,
                   device=device)
    q[0] = ndof * BOLTZ * t_target * tau * tau
    return q


def nhc_propagate(ke2, nhc: NHCState, q, kt, ndof, dt):
    """Half-step Nose-Hoover chain update driven by 2*KE of the coupled
    degrees of freedom; returns (velocity scale factor, new chain).

    MTK chain propagation (outer -> inner -> scale -> inner -> outer) with
    one Suzuki-Yoshida term, as the JAX function. Used for the particle
    thermostat (ke2 = 2 KE) and the barostat's chain (ke2 = W sum v_eps^2,
    ndof = coupled axes)."""
    m = q.shape[0]
    dt2, dt4, dt8 = dt / 2.0, dt / 4.0, dt / 8.0
    qs = q.unbind()
    v = list(nhc.v_xi.unbind())

    def force(k, ke2_):
        if k == 0:
            return (ke2_ - ndof * kt) / qs[0]
        return (qs[k - 1] * v[k - 1] ** 2 - kt) / qs[k]

    if m > 1:
        v[m - 1] = v[m - 1] + dt4 * force(m - 1, ke2)
    for k in range(m - 2, -1, -1):
        coupling = torch.exp(-dt8 * v[k + 1])
        v[k] = (v[k] * coupling + dt4 * force(k, ke2)) * coupling

    scale = torch.exp(-dt2 * v[0])
    ke2 = ke2 * scale * scale
    xi = nhc.xi + dt2 * torch.stack(v)

    for k in range(m - 1):
        coupling = torch.exp(-dt8 * v[k + 1])
        v[k] = (v[k] * coupling + dt4 * force(k, ke2)) * coupling
    if m > 1:
        v[m - 1] = v[m - 1] + dt4 * force(m - 1, ke2)
    return scale, NHCState(xi, torch.stack(v))


def nhc_step(v, masses, nhc: NHCState, q, t_target, ndof, dt):
    """Half-step particle Nose-Hoover chain; returns (scaled v, new
    chain)."""
    ke2 = 2.0 * kinetic_energy(v, masses)
    scale, nhc = nhc_propagate(ke2, nhc, q, BOLTZ * t_target, ndof, dt)
    return v * scale, nhc


def nhc_conserved(nhc: NHCState, q, t_target, ndof):
    """Thermostat contribution to the conserved quantity (eV)."""
    kt = BOLTZ * t_target
    e = 0.5 * (q * nhc.v_xi ** 2).sum()
    return e + ndof * kt * nhc.xi[0] + kt * nhc.xi[1:].sum()


def langevin_ou(v, masses, generator, t_target, damp, dt):
    """Ornstein-Uhlenbeck half of BAOAB: v' = c1 v + c2 sigma xi, with the
    normal draws xi from `generator` (a torch.Generator on v's device)."""
    c1 = math.exp(-dt / damp)
    sigma = torch.sqrt(BOLTZ * t_target / (masses[:, None] * MVV2E))
    noise = torch.randn(v.shape, generator=generator, dtype=v.dtype,
                        device=v.device)
    return c1 * v + math.sqrt(1.0 - c1 * c1) * sigma * noise


def npt_baro_masses(n_atoms, t_target, tau_p, dtype, device="cpu"):
    """MTK barostat mass W = (N+1) kB T tau_p^2 (per coupled axis)."""
    return torch.tensor((n_atoms + 1) * BOLTZ * t_target * tau_p * tau_p,
                        dtype=dtype, device=device)
