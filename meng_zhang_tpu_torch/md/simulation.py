"""MD driver: velocity Verlet with NVE, NHC NVT, MTK NPT and Langevin.

Counterpart of meng_zhang_tpu/md/simulation.py: `MDConfig`, `MDState`,
`Thermo`, `npt_drift_vcoef` (:111), `create_velocities` and `Simulator`,
with its thin-box image mode (`image_shifts`, :188-212, :370-378).

The JAX driver is one jitted `lax.scan`; here a thermo block is a plain
Python loop of steps. A step keeps every flag (`stale`, `unsafe`,
`overflow`) on the device and reads nothing back to the host; `run` reads
one bool per block and rebuilds the skin list there when a step flagged it
stale, as the JAX `run` does. The model's short list is refreshed on a fixed
cadence of `short_every` steps inside the block. With a `force_fn_light`,
outside NPT every step of a block but the last skips the virial, as the
JAX `run_device` does (:445-478).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from .. import profiling
from ..system.neighbors import (NeighborList, build_neighbors_cell,
                                build_neighbors_cell_rowsweep,
                                build_neighbors_images, build_neighbors_n2,
                                max_displacement_sq)
from ..units import BOLTZ, MVV2E, NKTV2P
from . import integrate as I


class MDState(NamedTuple):
    x: torch.Tensor          # [N, 3] positions (A)
    v: torch.Tensor          # [N, 3] velocities (A/ps)
    f: torch.Tensor          # [N, 3] forces (eV/A)
    box: torch.Tensor        # [3]
    pe: torch.Tensor         # potential energy (eV)
    virial: torch.Tensor     # [3, 3] (eV)
    nbrs: NeighborList
    nhc: I.NHCState
    v_eps: torch.Tensor      # [3] barostat strain rates
    baro_nhc: I.NHCState
    generator: torch.Generator   # Langevin noise stream
    step: torch.Tensor       # int64 step counter
    overflow: torch.Tensor   # sticky neighbor-capacity overflow
    stale: torch.Tensor      # the skin list needs a rebuild (host acts)
    unsafe: torch.Tensor     # sticky: an atom moved > skin/2 (or > short
                             # skin/2) while a list was in use: pairs may
                             # have been missed (a LAMMPS "dangerous build")
    short: Any               # the model's refresh-static short list (with
                             # .ref_x), None when disabled


class Thermo(NamedTuple):
    step: torch.Tensor
    temp: torch.Tensor
    pe: torch.Tensor
    ke: torch.Tensor
    press: torch.Tensor
    vol: torch.Tensor
    conserved: torch.Tensor


@dataclasses.dataclass(frozen=True)
class MDConfig:
    dt: float                       # ps
    cutoff: float                   # model cutoff (A)
    skin: float = 2.0
    capacity: int = 256
    nbr_method: str = "cell"        # "cell" | "rowsweep" | "n2"
    cell_dims: Optional[tuple] = None
    cell_capacity: int = 64
    ensemble: str = "nve"           # "nve" | "nvt" | "npt" | "langevin"
    t_target: float = 300.0
    tau_t: float = 0.1              # ps (LAMMPS Tdamp)
    damp: float = 0.1               # ps (Langevin)
    p_target: tuple = (0.0, 0.0, 0.0)   # bar, per axis
    p_couple: tuple = (False, False, False)
    tau_p: float = 1.0              # ps (LAMMPS Pdamp)
    nhc_len: int = 3                # particle chain (LAMMPS tchain)
    pchain: int = 3                 # barostat chain (LAMMPS pchain)
    thermo_every: int = 10
    pbc: tuple = (True, True, True)
    stale_factor: float = 0.8       # flag staleness at stale_factor*skin/2
    short_every: int = 0            # refresh the short list every this many
                                    # steps (must divide thermo_every)
    short_skin: float = 0.0         # the model's short_delta
    short_host_refresh: bool = False  # not ported (colored delivery)


def npt_drift_vcoef(v_eps, couple, dt):
    """Velocity coefficient [1, 3] of the exact MTK barostat drift
    x' = x e^{dt v_eps} + dt v e^{y} sinh(y)/y, y = dt v_eps / 2; the even
    series of sinh(y)/y is exact to machine precision for |y| < 0.3."""
    y = torch.where(couple > 0, 0.5 * dt * v_eps, torch.zeros_like(v_eps))
    y2 = y * y
    sinhx_x = 1.0 + y2 / 6.0 * (1.0 + y2 / 20.0 * (1.0 + y2 / 42.0))
    return (dt * torch.exp(y) * sinhx_x)[None, :]


def create_velocities(generator, masses, t_target, dtype=torch.float32):
    """Maxwell-Boltzmann draw with drift removal and exact-T rescale
    (LAMMPS `velocity all create T seed mom yes`); the normal draws come
    from `generator`, a torch.Generator on the masses' device."""
    n = masses.shape[0]
    sigma = torch.sqrt(BOLTZ * t_target / (masses[:, None] * MVV2E))
    v = sigma * torch.randn((n, 3), generator=generator, dtype=dtype,
                            device=masses.device)
    v = I.remove_drift(v, masses)
    t_now = I.temperature(v, masses, 3 * n - 3)
    return v * torch.sqrt(t_target / t_now)


class Simulator:
    """MD driver bound to a force model.

    force_fn(x, box, nbrs) -> (pe, forces, virial [3, 3]); with short_build
    (x, box, nbrs) -> short list (a NamedTuple with .ref_x), force_fn is
    called as force_fn(x, box, nbrs, short) and the short list is rebuilt
    every cfg.short_every steps. force_fn_light has force_fn's signature
    and may return a zero virial cheaply; outside NPT it serves every step
    whose virial nobody reads, all but the last of each thermo block (the
    block-end thermo row reads the virial; NPT's barostat reads it every
    step). masses [N] fix the dtype and device of the run's constants.

    image_shifts [R, 3] (models/annp.image_shift_table) runs a box with
    periodic edges thinner than 2 (cutoff + skin): the skin list is built
    over the image-extended table (`build_neighbors_images`, cfg.pbc the
    table's pbc_eff) and force_fn must read it so
    (models/annp.energy_forces_virial_images). As in the JAX Simulator,
    image mode takes no short_build."""

    def __init__(self, force_fn: Callable, masses, cfg: MDConfig,
                 short_build: Optional[Callable] = None,
                 short_build_colored: Optional[Callable] = None,
                 force_fn_light: Optional[Callable] = None,
                 image_shifts=None):
        if short_build_colored is not None or cfg.short_host_refresh:
            raise NotImplementedError("the colored short list and its host "
                                      "refresh are not ported")
        if image_shifts is not None and short_build is not None:
            raise NotImplementedError(
                "thin-box image mode takes no short_build: its force_fn "
                "evaluates the skin list (energy_forces_virial_images), as "
                "in the JAX Simulator")
        if cfg.nbr_method not in ("cell", "rowsweep", "n2"):
            raise ValueError(f"unknown nbr_method {cfg.nbr_method!r}")
        if short_build is not None and not (
                cfg.short_every > 0 and cfg.short_skin > 0.0
                and cfg.thermo_every % cfg.short_every == 0):
            raise ValueError("short_build needs short_every > 0 dividing "
                             "thermo_every and short_skin > 0")
        self.force_fn = force_fn
        self.force_fn_light = force_fn_light
        self.masses = masses
        self.cfg = cfg
        self.short_build = short_build
        self.n = masses.shape[0]
        self.ndof = 3 * self.n - 3
        self.image_shifts = None if image_shifts is None else \
            torch.as_tensor(image_shifts, device=masses.device)
        self.rebuild_count = 0
        dt, dev = masses.dtype, masses.device
        c = cfg
        # constants built once: creating a small tensor from host values
        # inside a step would copy it to the device and synchronise
        self._q = I.nhc_masses(self.ndof, c.t_target, c.tau_t, c.nhc_len, dt,
                               dev)
        self._couple = torch.tensor(c.p_couple, dtype=dt, device=dev)
        self._p_ext = torch.tensor(c.p_target, dtype=dt, device=dev) / NKTV2P
        self._w_mass = I.npt_baro_masses(self.n, c.t_target, c.tau_p, dt, dev)
        self._n_couple = max(1, sum(bool(p) for p in c.p_couple))
        self._baro_q = I.nhc_masses(self._n_couple, c.t_target, c.tau_p,
                                    c.pchain, dt, dev)

    # ---------- neighbor handling ----------
    def build_nbrs(self, x, box):
        c = self.cfg
        rlist = c.cutoff + c.skin
        with profiling.span("nbr.build"):
            profiling.count("nbr.builds", 1)
            if self.image_shifts is not None:
                return build_neighbors_images(x, box, self.image_shifts,
                                              rlist, c.capacity, pbc=c.pbc)
            if c.nbr_method == "n2":
                return build_neighbors_n2(x, box, rlist, c.capacity,
                                          pbc=c.pbc)
            if c.cell_dims is None:
                raise ValueError("cell_dims required for the cell neighbor "
                                 "method")
            build = build_neighbors_cell_rowsweep \
                if c.nbr_method == "rowsweep" else build_neighbors_cell
            return build(x, box, rlist, c.capacity, c.cell_dims,
                         c.cell_capacity, pbc=c.pbc)

    # ---------- single step ----------
    def _eval_force(self, x, box, nbrs, short=None, light=False):
        fn = self.force_fn_light if (light and self.force_fn_light
                                     is not None) else self.force_fn
        with profiling.span("eval"):
            if self.short_build is not None:
                return fn(x, box, nbrs, short)
            return fn(x, box, nbrs)

    def _refresh_short(self, s: MDState) -> MDState:
        with profiling.span("nbr.short"):
            return s._replace(short=self.short_build(s.x, s.box, s.nbrs))

    def step(self, s: MDState, light: bool = False) -> MDState:
        """One velocity-Verlet step; light=True evaluates forces with
        force_fn_light (no virial)."""
        c = self.cfg
        dt = c.dt
        m = self.masses
        with profiling.span("md.step"):
            profiling.count("md.steps", 1)
            with profiling.span("md.integrate"):
                if c.ensemble in ("nvt", "npt"):
                    v, nhc = I.nhc_step(s.v, m, s.nhc, self._q, c.t_target,
                                        self.ndof, dt)
                    s = s._replace(v=v, nhc=nhc)
                if c.ensemble == "npt":
                    # LAMMPS fix_nh order: nhc_temp -> nhc_press ->
                    # omega_dot -> v
                    s = self._npt_baro_thermo(s, dt)
                    s = self._npt_baro_half(s)

                v = I.vv_kick(s.v, s.f, m, 0.5 * dt)
                if c.ensemble == "npt":
                    x, box = self._npt_drift(s.x, v, s.box, s.v_eps, dt)
                else:
                    x, box = I.vv_drift(s.x, v, dt), s.box
                if c.ensemble == "langevin":
                    v = I.langevin_ou(v, m, s.generator, c.t_target, c.damp,
                                      dt)

            # staleness is flagged at stale_factor * skin/2 so the drift
            # until the next block-end rebuild stays inside skin/2; crossing
            # skin/2 (or short_skin/2 for the short list) latches `unsafe`
            nbrs = s.nbrs
            with profiling.span("nbr.check"):
                msq = max_displacement_sq(nbrs.ref_x, x, box, c.pbc)
                stale = s.stale | (msq > (0.5 * c.stale_factor * c.skin) ** 2)
                unsafe = s.unsafe | (msq > (0.5 * c.skin) ** 2)
                if self.short_build is not None:
                    msq_s = max_displacement_sq(s.short.ref_x, x, box, c.pbc)
                    unsafe = unsafe | (msq_s > (0.5 * c.short_skin) ** 2)
            pe, f, w = self._eval_force(x, box, nbrs, s.short, light)

            with profiling.span("md.integrate"):
                v = I.vv_kick(v, f, m, 0.5 * dt)
                s = MDState(x=x, v=v, f=f, box=box, pe=pe, virial=w,
                            nbrs=nbrs, nhc=s.nhc, v_eps=s.v_eps,
                            baro_nhc=s.baro_nhc, generator=s.generator,
                            step=s.step + 1,
                            overflow=s.overflow | nbrs.overflow, stale=stale,
                            unsafe=unsafe, short=s.short)
                if c.ensemble == "npt":
                    s = self._npt_baro_half(s)
                    s = self._npt_baro_thermo(s, dt)
                if c.ensemble in ("nvt", "npt"):
                    v, nhc = I.nhc_step(s.v, m, s.nhc, self._q, c.t_target,
                                        self.ndof, dt)
                    s = s._replace(v=v, nhc=nhc)
        return s

    # ---------- NPT pieces (MTK, per-axis couple) ----------
    def _pressure_diag(self, s: MDState):
        vol = s.box[0] * s.box[1] * s.box[2]
        kin = MVV2E * (self.masses[:, None] * s.v * s.v).sum(dim=0)
        return (kin + torch.diagonal(s.virial)) / vol          # eV/A^3

    def _npt_baro_thermo(self, s: MDState, dt) -> MDState:
        """Half-step NHC thermostat on the barostat strain rates v_eps."""
        ke2 = self._w_mass * (s.v_eps * s.v_eps * self._couple).sum()
        scale, bnhc = I.nhc_propagate(ke2, s.baro_nhc, self._baro_q,
                                      BOLTZ * self.cfg.t_target,
                                      self._n_couple, dt)
        return s._replace(v_eps=s.v_eps * scale, baro_nhc=bnhc)

    def _npt_baro_half(self, s: MDState) -> MDState:
        dt2 = 0.5 * self.cfg.dt
        couple = self._couple
        vol = s.box[0] * s.box[1] * s.box[2]
        p_int = self._pressure_diag(s)
        ke2 = 2.0 * I.kinetic_energy(s.v, self.masses)
        n_couple = couple.sum().clamp(min=1.0)
        g_eps = (vol * (p_int - self._p_ext)
                 + (ke2 / self.ndof) * couple / n_couple) / self._w_mass
        v_eps = s.v_eps + dt2 * g_eps * couple
        # MTK velocity correction
        tr = (v_eps * couple).sum()
        scale = torch.exp(-dt2 * (v_eps + tr / self.ndof))
        v = s.v * torch.where(couple > 0, scale, torch.ones_like(scale))[None]
        return s._replace(v=v, v_eps=v_eps)

    def _npt_drift(self, x, v, box, v_eps, dt):
        couple = self._couple
        ex = torch.where(couple > 0, torch.exp(dt * v_eps),
                         torch.ones_like(v_eps))
        return (x * ex[None, :] + npt_drift_vcoef(v_eps, couple, dt) * v,
                box * ex)

    # ---------- state init ----------
    def init_state(self, x, box, v=None, seed=0, t_init=None):
        """State at x (its dtype and device set the run's); velocities
        from `v` or drawn at t_init (default t_target) from a torch.Generator
        seeded with `seed`, which then feeds the Langevin noise."""
        rlist = self.cfg.cutoff + self.cfg.skin
        small = [float(b) for b, p in zip(box.tolist(), self.cfg.pbc)
                 if p and float(b) < 2.0 * rlist]
        if small and self.image_shifts is None:
            raise ValueError(
                f"box edges {small} are below 2*(cutoff+skin)="
                f"{2 * rlist:.2f} A: the single-image minimum-image "
                "convention would miss periodic images. Pass image_shifts "
                "(meng_zhang_tpu_torch.models.annp.image_shift_table + "
                "energy_forces_virial_images, with cfg.pbc = pbc_eff) or "
                "replicate the scene "
                "(meng_zhang_tpu_torch.geometry.lattice.replicate_data).")
        dtype, dev = x.dtype, x.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        if v is None:
            t0 = self.cfg.t_target if t_init is None else t_init
            v = create_velocities(gen, self.masses.to(dtype), t0, dtype)
        nbrs = self.build_nbrs(x, box)
        short = None
        if self.short_build is not None:
            short = self.short_build(x, box, nbrs)
        pe, f, w = self._eval_force(x, box, nbrs, short)
        c = self.cfg
        return MDState(
            x=x, v=v, f=f, box=box, pe=pe, virial=w, nbrs=nbrs,
            nhc=I.NHCState.zeros(c.nhc_len, dtype, dev),
            v_eps=torch.zeros(3, dtype=dtype, device=dev),
            baro_nhc=I.NHCState.zeros(c.pchain, dtype, dev),
            generator=gen,
            step=torch.zeros((), dtype=torch.int64, device=dev),
            overflow=nbrs.overflow.clone(),
            stale=torch.zeros((), dtype=torch.bool, device=dev),
            unsafe=torch.zeros((), dtype=torch.bool, device=dev),
            short=short)

    # ---------- thermo ----------
    def thermo(self, s: MDState) -> Thermo:
        c = self.cfg
        ke = I.kinetic_energy(s.v, self.masses)
        temp = 2.0 * ke / (self.ndof * BOLTZ)
        vol = s.box[0] * s.box[1] * s.box[2]
        press = (self._pressure_diag(s).sum() / 3.0) * NKTV2P
        conserved = s.pe + ke
        if c.ensemble in ("nvt", "npt"):
            conserved = conserved + I.nhc_conserved(s.nhc, self._q,
                                                    c.t_target, self.ndof)
        if c.ensemble == "npt":
            conserved = conserved + 0.5 * self._w_mass * (
                s.v_eps * s.v_eps * self._couple).sum()
            conserved = conserved + I.nhc_conserved(
                s.baro_nhc, self._baro_q, c.t_target, self._n_couple)
            p_hydro = (self._p_ext * self._couple).sum() / self._n_couple
            conserved = conserved + p_hydro * vol
        return Thermo(step=s.step, temp=temp, pe=s.pe, ke=ke, press=press,
                      vol=vol, conserved=conserved)

    # ---------- run loop ----------
    def run_block(self, s: MDState):
        """thermo_every steps, refreshing the short list every short_every
        steps; returns (state, Thermo of the block's last step). With a
        light force variant outside NPT, all steps but the block's last
        skip the virial."""
        every = self.cfg.thermo_every
        light = (self.force_fn_light is not None
                 and self.cfg.ensemble != "npt")
        se = every if self.short_build is None else self.cfg.short_every
        for i in range(every):
            if self.short_build is not None and i % se == 0:
                s = self._refresh_short(s)
            s = self.step(s, light=light and i < every - 1)
        with profiling.span("md.thermo"):
            return s, self.thermo(s)

    def rebuild(self, s: MDState) -> MDState:
        """Skin-list rebuild (and short-list refresh from the new list);
        counterpart of the JAX Simulator._rebuild."""
        nbrs = self.build_nbrs(s.x, s.box)
        s = s._replace(nbrs=nbrs, stale=torch.zeros_like(s.stale),
                       overflow=s.overflow | nbrs.overflow)
        if self.short_build is not None:
            s = self._refresh_short(s)
        return s

    def run(self, state: MDState, n_blocks: int):
        """Advance n_blocks x thermo_every steps, rebuilding the skin list
        at block ends whenever a step flagged staleness (one bool read back
        per block). Returns (state, Thermo with one row per block)."""
        thermos = []
        self.rebuild_count = 0
        for _ in range(n_blocks):
            state, th = self.run_block(state)
            thermos.append(th)
            with profiling.span("md.stale_read"):
                stale = bool(state.stale)
            if stale:
                state = self.rebuild(state)
                self.rebuild_count += 1
        return state, Thermo(*(torch.stack(col) for col in zip(*thermos)))
