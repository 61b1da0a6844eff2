"""Screw-dislocation core relaxation with per-atom energies and stresses
(BASELINE.json config 4). Counterpart of scripts/disloc_core.py.

Builds the oriented bcc-Fe box with a 1/2<111> screw dislocation along z
(geometry/screw.py, 22 x 38 x 3 lattice units, 30,096 atoms; pbc F F T),
FIRE-relaxes it with the boundary shell (type 2, farther than the
boundary radius from the box centre) held fixed by zeroing its forces,
through `md/minimize.fire_relax`: passes of at most 400 iterations, each
on a skin list built at the pass's start, until fmax <= f_tol. A fresh
skin list at the relaxed positions then carries one evaluation, whose
forces give the reported fmax and whose per-atom energies and stresses
(LAMMPS pe/atom and stress/atom, FusedAnnp's harmonic short path) give
the radial profile of the mobile atoms' energy around the core line, the
core-excess statistics and whether the per-atom stresses sum to the
virial. Prints the record's headline numbers as one JSON line on stdout;
--out writes the whole record, --dump the per-atom dump (id type x y z
c_pe c_stress[1..6]).

The JAX script runs one such pass on one list and tallies on that list:
on the synthetic potential that pass ends well above f_tol, and its atoms
move farther than the half-skin (0.3 A) for which one list holds. The
record carries the passes, the iterations, and the largest move of an
atom within a pass, over all passes and in the last one. The skin list is
built by cells where every axis holds three cells of rc + skin and by
all pairs otherwise: the scene's periodic z (14.8 A) holds two cells of
7.1 A, where the cell list of both packages refuses (the JAX script calls
it there and stops).

    python -m meng_zhang_tpu_torch.scripts.disloc_core --out core.json \\
        --dump core.lammpstrj
"""
from __future__ import annotations

import argparse
import json
import time
from typing import NamedTuple

import numpy as np
import torch

from ..run import log, resolve_device
from . import device_label, peak_mem_gib

NUM_LATTICE = (22, 38, 3)      # z = 3 units (14.8 A) > 2 (rc + skin)
PBC = (False, False, True)
SHORT_DELTA, SKIN, CAPACITY, CELL_CAPACITY = 0.3, 0.6, 160, 64
BOUNDARY_RADIUS = 60.0         # A; atoms beyond it form the frozen shell
FIRE = dict(f_tol=5e-3, max_iter=400, block=20)     # a pass
MAX_PASSES = 20
BULK_R, CORE_R = 40.0, 10.0    # A from the core line
EDGES = np.arange(0.0, 62.0, 2.0)


class DislocRun(NamedTuple):
    record: dict
    x0: np.ndarray           # [N, 3] the scene before relaxation
    x: np.ndarray            # [N, 3] relaxed positions
    types: np.ndarray        # [N] 1 mobile, 2 frozen shell
    eatom: np.ndarray        # [N] per-atom energies (eV, e_shift included)
    vatom: np.ndarray        # [N, 6] per-atom virials (eV; xx yy zz xy xz yz)
    virial: np.ndarray       # [3, 3]


def build_nbrs(x, box, cutoff, capacity, pbc):
    """Skin list by cells where every axis holds >= 3 cells of the cutoff,
    else by all pairs."""
    from ..system.neighbors import (build_neighbors_cell, build_neighbors_n2,
                                    cell_grid_dims)
    dims = cell_grid_dims(box.tolist(), cutoff)
    if min(dims) >= 3:
        return build_neighbors_cell(x, box, cutoff, capacity, dims,
                                    CELL_CAPACITY, pbc=pbc)
    return build_neighbors_n2(x, box, cutoff, capacity, pbc=pbc)


def profile(x, types, eat, core_xy):
    """Radial per-atom-energy profile of the mobile atoms around the core
    line and the core-excess statistics (scripts/disloc_core.py:103-125);
    NaN where a radius range holds no mobile atom (a reduced scene)."""
    r = np.hypot(x[:, 0] - core_xy[0], x[:, 1] - core_xy[1])
    mob = types == 1
    far = mob & (r > BULK_R)
    bulk = float(np.median(eat[far])) if far.any() else float("nan")
    prof = []
    for lo, hi in zip(EDGES[:-1], EDGES[1:]):
        m = mob & (r >= lo) & (r < hi)
        if m.any():
            prof.append({"r_mid": float(0.5 * (lo + hi)),
                         "count": int(m.sum()),
                         "mean_excess_eV": float(np.mean(eat[m]) - bulk),
                         "max_excess_eV": float(np.max(eat[m]) - bulk)})
    core = mob & (r < CORE_R)
    return {"bulk_eatom_eV": bulk, "core_atoms_r10": int(core.sum()),
            "core_excess_eV": float(np.sum(eat[core] - bulk)),
            "core_max_excess_eV": (float(np.max(eat[core]) - bulk)
                                   if core.any() else float("nan")),
            "radial_profile": prof}


def build_parser():
    ap = argparse.ArgumentParser(
        prog="meng_zhang_tpu_torch.scripts.disloc_core",
        description="BASELINE.json config 4: screw-dislocation core "
                    "relaxation with per-atom energies and stresses")
    ap.add_argument("--potential", default=None,
                    help=".ann file (default: the synthetic fe potential "
                         "of the shipped width, testing.py)")
    ap.add_argument("--dump", default=None,
                    help="write the per-atom dump (.lammpstrj) here")
    ap.add_argument("--out", default=None, help="write the record here")
    return ap


def main(argv=None, device=None, *, num_lattice=NUM_LATTICE,
         boundary_radius=BOUNDARY_RADIUS, max_iter=FIRE["max_iter"],
         max_passes=MAX_PASSES, dtype=torch.float32) -> DislocRun:
    """The config-4 run; the keywords size a reduced run (the scene, the
    iterations of a FIRE pass, the passes, the dtype)."""
    args = build_parser().parse_args(argv)
    from ..geometry.screw import make_screw_dislocation
    from ..io.dump import DumpWriter
    from ..io.potential import read_ann
    from ..md.minimize import fire_relax
    from ..models.annp import make_annp
    from ..ops.fused_annp import FusedAnnp
    from ..system.neighbors import max_displacement_sq
    from ..testing import synthetic_fe_potential

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    scene = make_screw_dislocation(num_lattice=tuple(num_lattice),
                                   with_dislocation=True,
                                   boundary_radius=boundary_radius)
    x_np, types, box_np = scene.x, scene.types, scene.box
    n = len(x_np)
    core_xy = (box_np[0] / 2.0, box_np[1] / 2.0)
    log(f"screw-dislocation scene: {n} atoms, box {np.round(box_np, 2)}, "
        f"{int((types == 2).sum())} frozen boundary atoms")
    pot = read_ann(args.potential) if args.potential else \
        synthetic_fe_potential(0)
    mcfg, params = make_annp(pot, dtype, dev, pbc=PBC)
    ev = FusedAnnp(mcfg, params, short_delta=SHORT_DELTA)
    x = torch.as_tensor(x_np, dtype=dtype, device=dev)
    box = torch.as_tensor(box_np, dtype=dtype, device=dev)
    frozen = torch.as_tensor(types == 2, device=dev)[:, None]
    evals, starts, moves = [0], [], []

    def ef(xx, bb, idx):
        evals[0] += 1
        e, f = ev.energy_forces_short(xx, bb, ev.compact_short(xx, bb, idx),
                                      want_virial=False)
        return e, torch.where(frozen, 0.0, f)    # boundary shell held fixed

    def build(xx, bb):
        """A skin list at xx; logs the largest move of the pass that ended
        at xx (from the previous list's positions)."""
        if starts:
            moves.append(float(max_displacement_sq(starts[-1], xx, bb,
                                                   PBC)) ** 0.5)
            log(f"FIRE pass {len(moves)}: {evals[0]} evaluations so far, "
                f"largest move {moves[-1]:.3f} A")
        starts.append(xx)
        nbrs = build_nbrs(xx, bb, mcfg.cut + SKIN, CAPACITY, PBC)
        if bool(nbrs.overflow):
            raise RuntimeError("skin-list capacity overflow")
        return nbrs

    t0 = time.time()
    x, _ = fire_relax(ef, build, x, box, max_outer=max_passes,
                      **{**FIRE, "max_iter": max_iter})
    nbrs = build(x, box)             # fresh: the last pass's list may be stale
    fire_s = time.time() - t0
    passes = len(moves)
    iters = evals[0] - passes        # each pass evaluates its start once more

    sl = ev.compact_short(x, box, nbrs.idx)
    e, f, w, eat, vat = ev.energy_forces_short(x, box, sl, want_virial=True,
                                               per_atom=True)
    pe = float(e) + n * mcfg.e_shift
    fmax = float(torch.where(frozen, 0.0, f).abs().max())
    log(f"FIRE: {fire_s:.1f}s {iters} iterations in {passes} passes; on a "
        f"fresh list fmax={fmax:.2e} pe={pe:.6e} eV "
        f"converged={fmax <= FIRE['f_tol']}")
    xh = x.double().cpu().numpy()
    eat = eat.double().cpu().numpy()
    vat = vat.double().cpu().numpy()
    w = w.double().cpu().numpy()
    if args.dump:
        with DumpWriter(args.dump, types=types) as dw:
            dw.write(0, xh, box_np, extra={"c_pe": eat, "c_stress": vat})
        log(f"wrote {args.dump}")

    rec = {
        "scene": f"screw-dislocation bcc-Fe (config 4), {n} atoms, "
                 f"orient (1,1,-2)/(1,-1,0)/(-1,-1,-1), z periodic",
        "atoms": n, "frozen_atoms": int((types == 2).sum()),
        "fmax_eV_A": fmax, "converged": fmax <= FIRE["f_tol"],
        "fire_iters": iters, "fire_passes": passes,
        "fire_max_disp_A": max(moves), "fire_last_pass_disp_A": moves[-1],
        "fire_s": fire_s, "pe_eV": pe,
        **profile(xh, types, eat, core_xy),
        "vatom_sum_matches_virial": bool(np.allclose(
            vat.sum(0)[:3], np.diag(w), rtol=1e-4, atol=1e-3)),
        "peak_mem_gib": peak_mem_gib(dev),
        "dtype": str(dtype).removeprefix("torch."),
        "device": device_label(dev),
    }
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rec, fh, indent=1)
        log(f"wrote {args.out}")
    print(json.dumps({k: rec[k] for k in
                      ("pe_eV", "fmax_eV_A", "converged", "core_excess_eV",
                       "core_max_excess_eV", "vatom_sum_matches_virial",
                       "device")}), flush=True)
    return DislocRun(rec, x_np, xh, types, eat, vat, w)


if __name__ == "__main__":
    main()
