"""The system under test, driven as its users drive it: the
meng_zhang_tpu_torch Simulator over the program side of the path a cell
names, in float32. This module and the paths (and the helpers they call,
such as `annp.py`) are the only ones of the benchmark that build the
program (stages.py reads its spans), and only when a run calls them.

A path, `paths/<name>.py`, has `build(pot, wl, device)`: from the
potential dict and the cell's workload, an object with

  cutoff                 the model's cutoff (A); the skin list's is cutoff
                         + md.skin, the short list's cutoff + short_delta
  energy_forces(x, box, nbrs, short, want_virial)
                         -> (E, F [N, 3], W [3, 3] or None without
                         want_virial), against the skin list nbrs (the
                         port's NeighborList) and the short list
  short_build(x, box, nbrs)
                         -> the short list, of any type with .ref_x (what
                         the Simulator keeps and hands back)
  short_list(short)      -> (partner ids [N, Ks], sentinel N; the
                         positions it was built at; its overflow flag),
                         what the check and the flags read

`Program.relax` (a relaxed scene's FIRE) needs energy_forces and
short_build alone. Program keeps only what every model shares: the
MDConfig of the workload, the masses, the Simulator and the virial policy
(`md.virial`: `every` step, `block_end` through a light force callable,
or `never`).
"""
from __future__ import annotations

import numpy as np
import torch


class Program:
    """The Simulator of a cell over its path's program side (`side`).
    sim.force_fn, sim.force_fn_light, sim.short_build and sim.rebuild are
    what the harness's spans wrap."""

    def __init__(self, pot, wl, n, box, device):
        from mdbench import found
        from meng_zhang_tpu_torch.md.simulation import MDConfig, Simulator
        from meng_zhang_tpu_torch.system.neighbors import cell_grid_dims
        md = wl["md"]
        pbc = tuple(wl["scene"]["pbc"])
        side = found.load("paths", wl["path"]).build(pot, wl, device)
        self.side = side
        self.rc = side.cutoff
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
            e, f, w = side.energy_forces(x, b, nbrs, short,
                                         virial != "never")
            return e, f, x.new_zeros(3, 3) if w is None else w

        def force_fn_light(x, b, nbrs, short):
            e, f, _ = side.energy_forces(x, b, nbrs, short, False)
            return e, f, x.new_zeros(3, 3)

        masses = torch.full((n,), float(pot["mass"]), dtype=torch.float32,
                            device=device)
        self.sim = Simulator(
            force_fn, masses, self.cfg, short_build=side.short_build,
            force_fn_light=force_fn_light if virial == "block_end" else None)

    def relax(self, x, box, opts):
        """FIRE on one skin list, each evaluation on a fresh short list, as
        the program's scale_demo relaxes the 2M scene: the relaxed
        positions and the iterations."""
        from meng_zhang_tpu_torch.md.minimize import fire_minimize
        side = self.side

        def ef(xx, bb, nbrs):
            e, f, _ = side.energy_forces(xx, bb, nbrs,
                                         side.short_build(xx, bb, nbrs),
                                         False)
            return e, f

        st = fire_minimize(ef, x, box, self.sim.build_nbrs(x, box), **opts)
        return st.x, int(st.n_iter)
