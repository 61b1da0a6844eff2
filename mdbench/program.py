"""The system under test, driven as its users drive it: the
meng_zhang_tpu_torch Simulator over an evaluator of the port (the path a
cell names, `paths/<name>.py`), in float32. This module and the paths are
the only ones of the benchmark that import the program, and only when a
run calls them."""
from __future__ import annotations

import numpy as np
import torch


def annp_potential(pot):
    """The benchmark's potential dict as the program's parsed .ann."""
    from meng_zhang_tpu_torch.io.potential import (AnnpPotential,
                                                   NetworkParams,
                                                   SYM_BEHLER, SYM_CHEBYSHEV)
    bp = "coerad" in pot
    net = NetworkParams(weights=tuple(np.asarray(w) for w in pot["weights"]),
                        biases=tuple(np.asarray(b) for b in pot["biases"]),
                        flagact=tuple(pot["flagact"]), act_style=pot["style"])
    nsf = pot["npsf"] + pot["ntsf"]
    return AnnpPotential(
        elements=(pot.get("element", "X"),),
        masses=np.asarray([pot["mass"]]), ntl=len(pot["weights"]) + 1,
        nhl=len(pot["weights"]) - 1, nnod=len(pot["biases"][0]), nsf=nsf,
        npsf=pot["npsf"], ntsf=pot["ntsf"],
        # a BP file's header cutoff is the LAMMPS list's (6.5 A in the
        # shipped ni file); the program reads the tables' Rc for its rows
        cut=max(6.5, pot["cutoff"]) if bp else pot["cutoff"],
        flagsym=SYM_BEHLER if bp else SYM_CHEBYSHEV,
        norm_row0=np.asarray(pot["norm_row0"]),
        norm_row1=np.asarray(pot["norm_row1"]),
        norm_style=pot["norm_style"],
        # BP: the program converts the network's Hartree itself
        e_scale=1.0 if bp else pot["e_scale"], e_shift=pot["e_shift"],
        e_atom=0.0, networks=(net,),
        sym_coerad=np.asarray(pot["coerad"]) if bp else None,
        sym_coeang=np.asarray(pot["coeang"]) if bp else None)


class Program:
    """The Simulator of a cell and its evaluator. sim.force_fn,
    sim.force_fn_light, sim.short_build and sim.rebuild are what the
    harness's spans wrap."""

    def __init__(self, pot, wl, n, box, device):
        from mdbench import found
        from meng_zhang_tpu_torch.md.simulation import MDConfig, Simulator
        from meng_zhang_tpu_torch.models.annp import (effective_cutoff,
                                                      make_annp)
        from meng_zhang_tpu_torch.system.neighbors import cell_grid_dims
        md = wl["md"]
        pbc = tuple(wl["scene"]["pbc"])
        ppot = annp_potential(pot)
        mcfg, params = make_annp(ppot, torch.float32, device, pbc=pbc)
        self.rc = effective_cutoff(ppot)
        ev = found.load("paths", wl["path"]).evaluator(mcfg, params, wl)
        self.evaluator = ev
        dims = cell_grid_dims(np.asarray(box) * md.get("dims_share", 1.0),
                              self.rc + md["skin"])
        cell = min(dims) >= 3
        self.cfg = MDConfig(
            dt=md["dt"], cutoff=self.rc, skin=md["skin"],
            capacity=md["capacity"], nbr_method="cell" if cell else "n2",
            cell_dims=dims if cell else None,
            cell_capacity=md["cell_capacity"], ensemble=md["ensemble"],
            t_target=md["t_target"], tau_t=md.get("tau_t", 0.1),
            p_target=tuple(md.get("p_target", (0.0, 0.0, 0.0))),
            p_couple=tuple(bool(c) for c in md.get("p_couple",
                                                   (0, 0, 0))),
            tau_p=md.get("tau_p", 1.0), thermo_every=md["thermo_every"],
            pbc=pbc, stale_factor=md["stale_factor"],
            short_every=md["short_every"], short_skin=wl["short_delta"])
        virial = md.get("virial", "every")

        def force_fn(x, b, nbrs, short):
            if virial == "never":
                e, f = ev.energy_forces_short(x, b, short, want_virial=False)
                return e, f, x.new_zeros(3, 3)
            return ev.energy_forces_short(x, b, short)

        def force_fn_light(x, b, nbrs, short):
            e, f = ev.energy_forces_short(x, b, short, want_virial=False)
            return e, f, x.new_zeros(3, 3)

        masses = torch.full((n,), float(pot["mass"]), dtype=torch.float32,
                            device=device)
        self.sim = Simulator(
            force_fn, masses, self.cfg,
            short_build=lambda x, b, nbrs: ev.compact_short(x, b, nbrs.idx),
            force_fn_light=force_fn_light if virial == "block_end" else None)

    def relax(self, x, box, opts):
        """FIRE on one skin list, each evaluation on a fresh compaction, as
        the program's scale_demo relaxes the 2M scene: the relaxed
        positions and the iterations."""
        from meng_zhang_tpu_torch.md.minimize import fire_minimize
        ev = self.evaluator

        def ef(xx, bb, idx):
            return ev.energy_forces_short(xx, bb, ev.compact_short(xx, bb, idx),
                                          want_virial=False)

        st = fire_minimize(ef, x, box, self.sim.build_nbrs(x, box).idx,
                           **opts)
        return st.x, int(st.n_iter)
