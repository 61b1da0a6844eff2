"""One MD step of the reference, in float64: velocity Verlet with the
Nose-Hoover chain thermostat (NVT) and the MTK barostat on chosen axes
(NPT) in LAMMPS fix_nh's order, LAMMPS metal units.

`Step` advances two sets of velocities through the same step: every
atom's (`v`, kicked with the forces `f_all` it is given) and a sample's
(`vs`, kicked with forces of its own). The thermostat's and barostat's
scalars (kinetic energy, pressure) come from the first set, and scale both.
"""
from __future__ import annotations

import math

import torch

BOLTZ = 8.617343e-5          # eV/K
MVV2E = 1.0364269e-4         # (g/mol)(A/ps)^2 -> eV
NKTV2P = 1.6021765e6         # eV/A^3 -> bar


def nhc_masses(ndof, t, tau, m):
    q = [BOLTZ * t * tau * tau] * m
    q[0] = ndof * BOLTZ * t * tau * tau
    return q


def nhc_propagate(ke2, xi, vxi, q, kt, ndof, dt):
    """Half-step Nose-Hoover chain driven by ke2 = 2 KE (MTK chain with one
    Suzuki-Yoshida term): (velocity scale, xi, vxi) as Python floats."""
    m = len(q)
    v = list(vxi)
    dt2, dt4, dt8 = dt / 2.0, dt / 4.0, dt / 8.0

    def force(k, e2):
        if k == 0:
            return (e2 - ndof * kt) / q[0]
        return (q[k - 1] * v[k - 1] ** 2 - kt) / q[k]

    if m > 1:
        v[m - 1] += dt4 * force(m - 1, ke2)
    for k in range(m - 2, -1, -1):
        c = math.exp(-dt8 * v[k + 1])
        v[k] = (v[k] * c + dt4 * force(k, ke2)) * c
    scale = math.exp(-dt2 * v[0])
    ke2 = ke2 * scale * scale
    xi = [a + dt2 * b for a, b in zip(xi, v)]
    for k in range(m - 1):
        c = math.exp(-dt8 * v[k + 1])
        v[k] = (v[k] * c + dt4 * force(k, ke2)) * c
    if m > 1:
        v[m - 1] += dt4 * force(m - 1, ke2)
    return scale, xi, v


class Step:
    """md: the workload's "md" settings; mass: one atom's; state: the
    program's state before the step, float64 tensors and lists: x, v, box,
    virial [3, 3], nhc (xi, vxi), v_eps [3], baro (xi, vxi)."""

    def __init__(self, md, mass, n, state):
        self.md, self.m, self.n = md, mass, n
        self.ndof = 3 * n - 3
        self.t = md["t_target"]
        self.kt = BOLTZ * self.t
        self.dt = md["dt"]
        ens = md["ensemble"]
        self.thermo = ens in ("nvt", "npt")
        self.npt = ens == "npt"
        self.q = nhc_masses(self.ndof, self.t, md.get("tau_t", 0.1),
                            md.get("nhc_len", 3))
        couple = [bool(c) for c in md.get("p_couple", (0, 0, 0))]
        self.couple = torch.tensor([float(c) for c in couple],
                                   dtype=torch.float64)
        self.n_couple = max(1, sum(couple))
        tau_p = md.get("tau_p", 1.0)
        self.w_mass = (n + 1) * self.kt * tau_p * tau_p
        self.baro_q = nhc_masses(self.n_couple, self.t, tau_p,
                                 md.get("pchain", 3))
        self.p_ext = torch.tensor(md.get("p_target", (0.0,) * 3),
                                  dtype=torch.float64) / NKTV2P
        self.x, self.v, self.box = state["x"], state["v"], state["box"].cpu()
        self.w = state["virial"].cpu()
        self.nhc = state["nhc"]
        self.v_eps = state["v_eps"].cpu().clone()
        self.baro = state["baro"]
        self.vs = None

    def _ke2(self):
        return self.m * MVV2E * float((self.v * self.v).sum())

    def _scale(self, s):
        self.v = self.v * s
        self.vs = self.vs * s

    def _nhc(self):
        s, xi, vxi = nhc_propagate(self._ke2(), *self.nhc, self.q, self.kt,
                                   self.ndof, self.dt)
        self.nhc = (xi, vxi)
        self._scale(s)

    def _baro_thermo(self):
        ke2 = self.w_mass * float((self.v_eps ** 2 * self.couple).sum())
        s, xi, vxi = nhc_propagate(ke2, *self.baro, self.baro_q, self.kt,
                                   self.n_couple, self.dt)
        self.baro = (xi, vxi)
        self.v_eps = self.v_eps * s

    def _baro_half(self):
        dt2 = 0.5 * self.dt
        vol = float(self.box.prod())
        kin = self.m * MVV2E * (self.v * self.v).sum(0).cpu()
        p_int = (kin + torch.diagonal(self.w)) / vol
        g = (vol * (p_int - self.p_ext) + (self._ke2() / self.ndof)
             * self.couple / self.n_couple) / self.w_mass
        self.v_eps = self.v_eps + dt2 * g * self.couple
        tr = float((self.v_eps * self.couple).sum())
        s = torch.exp(-dt2 * (self.v_eps + tr / self.ndof))
        s = torch.where(self.couple > 0, s, torch.ones_like(s))
        self._scale(s.to(self.v.device)[None, :])

    def _kick(self, f_all, f_s):
        c = 0.5 * self.dt / (self.m * MVV2E)
        self.v = self.v + c * f_all
        self.vs = self.vs + c * f_s

    def first_half(self, sample, f_all, f_s):
        """Thermostat, barostat, kick and drift: the new positions of every
        atom (from f_all) and the box."""
        self.vs = self.v[sample]
        if self.thermo:
            self._nhc()
        if self.npt:
            self._baro_thermo()
            self._baro_half()
        self._kick(f_all, f_s)
        dt = self.dt
        if self.npt:
            y = torch.where(self.couple > 0, 0.5 * dt * self.v_eps, 0.0)
            y2 = y * y
            sinhx_x = 1.0 + y2 / 6.0 * (1.0 + y2 / 20.0 * (1.0 + y2 / 42.0))
            vcoef = (dt * torch.exp(y) * sinhx_x).to(self.v.device)
            ex = torch.where(self.couple > 0, torch.exp(dt * self.v_eps), 1.0)
            self.x = self.x * ex.to(self.x.device) + vcoef * self.v
            self.box = self.box * ex
        else:
            self.x = self.x + dt * self.v
        return self.x, self.box

    def second_half(self, f_all, f_s, virial):
        """Kick with the new forces, then the barostat and thermostat
        halves; virial: the new positions' [3, 3]."""
        self._kick(f_all, f_s)
        self.w = virial.cpu()
        if self.npt:
            self._baro_half()
            self._baro_thermo()
        if self.thermo:
            self._nhc()
