"""The program side of the ANNP paths (`paths/fused_annp.py`,
`paths/fused_ni.py`): the benchmark's potential dict as the program's
parsed .ann, `make_annp` in float32, and an evaluator of the port over its
short list (`ops/fused_annp.ShortList`). The one module of the benchmark
that knows the ANNP's shape: E = sum of e_scale * nn(G_i), F = -dE/dx."""
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


class Side:
    """What `program.Program` reads of a path (see its docstring), for an
    evaluator `make_evaluator(mcfg, params, wl)` with the port's
    `compact_short(x, box, nbr_idx)` and `energy_forces_short`."""

    def __init__(self, pot, wl, device, make_evaluator):
        from meng_zhang_tpu_torch.models.annp import (effective_cutoff,
                                                      make_annp)
        ppot = annp_potential(pot)
        mcfg, params = make_annp(ppot, torch.float32, device,
                                 pbc=tuple(wl["scene"]["pbc"]))
        self.cutoff = effective_cutoff(ppot)
        self.evaluator = make_evaluator(mcfg, params, wl)

    def energy_forces(self, x, box, nbrs, short, want_virial):
        out = self.evaluator.energy_forces_short(x, box, short,
                                                 want_virial=want_virial)
        return out if want_virial else (*out, None)

    def short_build(self, x, box, nbrs):
        return self.evaluator.compact_short(x, box, nbrs.idx)

    @staticmethod
    def short_list(short):
        return short.sidx, short.ref_x, short.overflow
