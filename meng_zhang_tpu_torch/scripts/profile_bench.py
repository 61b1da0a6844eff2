"""Per-phase times of the fe benchmark step on one NVIDIA GPU.
Counterpart of scripts/profile_bench.py.

The scene is the reference benchmark's 152,880-atom bcc-Fe slab
(positions from artifacts/bench_minimized.npz, box 184 x 85.659 x
112.5 A, `boundary m p m`), NPT at 300 K with the y-coupled barostat, on
the script's own settings: skin 1.2 A, capacity 192, cell capacity 96,
the cell grid sized for 0.92 of the box, FusedAnnp's harmonic short path
(Ks 128, short_delta 0.3, refreshed every 10-step thermo block). Each
phase runs alone on the outputs of the one before (`reps` timed calls
after one untimed; the card's time between CUDA events):

  rebuild        the cell-list build of the skin list (no reverse slots)
  compact        FusedAnnp.compact_short (the short-list refresh)
  gather         pair_dx_planes on the short rows
  g_kernel       kernels.g_harm
  mlp            FusedAnnp._mlp_eat_dedg_harm (the MLP and its hand VJP)
  f_kernel       kernels.force_harm
  deliver        fused_annp.deliver: the Fj stack and the index_add_ (the
                 port's counterpart of the JAX `assemble`)
  virial         fused_annp.pair_virial
  energy_forces  the whole evaluation, energy_forces_short with the virial
  step_block     one NPT step of a 10-step block (Simulator.run_block)

Left out as TPU workarounds: the reverse slots of `rebuild`, and the
colored delivery's phases (`compact_colored`, `assemble_colored`). The
chained phases' forces (`ProfileRun.chained`) equal energy_forces'
(`ProfileRun.ef`), which the smoke run and the tests check. Prints one
JSON record on stdout (times_s, share_of_step, atom_steps_per_s_step);
--out also writes it to a file.

    python -m meng_zhang_tpu_torch.scripts.profile_bench
"""
from __future__ import annotations

import argparse
import os
from typing import Any, NamedTuple

import numpy as np
import torch

from ..run import log, resolve_device
from . import device_label, emit, time_call

SCENE_NPZ = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "artifacts",
    "bench_minimized.npz")
BOX = (184.0, 85.659, 112.5)
PBC = (False, True, False)           # boundary m p m
SKIN, CAPACITY, CELL_CAPACITY, DIMS_SHARE = 1.2, 192, 96, 0.92
K_SHORT, SHORT_DELTA, THERMO = 128, 0.3, 10
REPS = 10


class ProfileRun(NamedTuple):
    record: dict
    chained: tuple           # (E, F, W) of the chained phases
    ef: tuple                # (E, F, W) of energy_forces_short
    evaluator: Any
    sim: Any                 # the Simulator (its build_nbrs gives the
                             # phases' skin list at x)
    state: Any               # the MD state after step_block
    x: torch.Tensor          # the phases' positions
    box: torch.Tensor
    kernel_calls: int        # calls of each of the path's two kernels


def build_parser():
    ap = argparse.ArgumentParser(
        prog="meng_zhang_tpu_torch.scripts.profile_bench",
        description="per-phase times of the fe benchmark NPT step")
    ap.add_argument("--potential", default=None,
                    help=".ann file (default: the synthetic fe potential "
                         "of the shipped width, testing.py)")
    ap.add_argument("--out", default=None, help="also write the record here")
    return ap


def short_phases(ev, x, box, sl, phase, split=True, virial=True):
    """Run gather, the two harmonic kernels with the MLP between them
    (with `split`; else the three as one phase, `kernels_mlp`, FusedAnnp's
    _eval_fj), deliver and (with `virial`) the pair virial, each through
    phase(name, fn), which times fn and returns its output; returns the
    chained (E, F, W) (W None without `virial`). Shared by the fe
    profiles."""
    from ..ops import fused_annp as fa
    from ..ops import kernels
    c = ev.cfg
    dd = phase("gather", lambda: fa.pair_dx_planes(x, box, sl.sidx, ev.pbc))
    if split:
        g_raw, a = phase("g_kernel", lambda: kernels.g_harm(
            *dd, c.npsf, c.ntsf, c.cut))
        eat, dedg_rad, b = phase("mlp", lambda: ev._mlp_eat_dedg_harm(g_raw,
                                                                      a))
        del g_raw, a
        fj = phase("f_kernel", lambda: kernels.force_harm(
            *dd, dedg_rad, b, c.npsf, c.ntsf, c.cut))
        del dedg_rad, b
    else:
        eat, fj = phase("kernels_mlp", lambda: ev._eval_fj(*dd))
    forces = phase("deliver", lambda: fa.deliver(fj, sl.sidx,
                                                 x.shape[0]))[0]
    w = phase("virial", lambda: fa.pair_virial(dd, fj)) if virial else None
    return eat.sum(), forces, w


def main(argv=None, device=None, *, scene=None, reps=REPS,
         dtype=torch.float32) -> ProfileRun:
    """The profile; `scene` (x [N, 3], box [3] numpy) replaces the
    benchmark scene, `reps` the timed calls a phase, `dtype` the run's
    precision (the CPU tests run a reduced scene in float64)."""
    args = build_parser().parse_args(argv)
    from ..io.potential import read_ann
    from ..md.simulation import MDConfig, Simulator
    from ..models.annp import make_annp
    from ..ops.fused_annp import FusedAnnp
    from ..system.neighbors import cell_grid_dims
    from ..testing import synthetic_fe_potential
    from ..units import MASS_FE

    dev = resolve_device(device)
    if scene is None:
        scene = (np.load(SCENE_NPZ)["x"], np.asarray(BOX))
    x = torch.as_tensor(scene[0], dtype=dtype, device=dev)
    box = torch.as_tensor(scene[1], dtype=dtype, device=dev)
    n = x.shape[0]
    pot = read_ann(args.potential) if args.potential else \
        synthetic_fe_potential(0)
    mcfg, params = make_annp(pot, dtype, dev, pbc=PBC)
    ev = FusedAnnp(mcfg, params, k_short=K_SHORT, short_delta=SHORT_DELTA)
    dims = cell_grid_dims(np.asarray(scene[1]) * DIMS_SHARE,
                          mcfg.cut + SKIN)
    cfg = MDConfig(dt=0.001, cutoff=mcfg.cut, skin=SKIN, capacity=CAPACITY,
                   nbr_method="cell", cell_dims=dims,
                   cell_capacity=CELL_CAPACITY, ensemble="npt",
                   t_target=300.0, tau_t=0.1, p_target=(0.0,) * 3,
                   p_couple=(False, True, False), tau_p=1.0,
                   thermo_every=THERMO, pbc=PBC, short_every=THERMO,
                   short_skin=SHORT_DELTA)
    sim = Simulator(
        lambda xx, bb, nbrs, short: ev.energy_forces_short(xx, bb, short),
        torch.full((n,), MASS_FE, dtype=dtype, device=dev), cfg,
        short_build=lambda xx, bb, nbrs: ev.compact_short(xx, bb, nbrs.idx))

    log(f"scene: {n} atoms; building neighbors...")
    res = {}

    def phase(name, fn, n_reps=reps, warmup=1):
        res[name], out = time_call(fn, dev, n_reps, warmup)
        log(f"{name}: {res[name] * 1e3:.3f} ms")
        return out

    nbrs = phase("rebuild", lambda: sim.build_nbrs(x, box),
                 max(1, reps // 2))
    sl = phase("compact", lambda: ev.compact_short(x, box, nbrs.idx))
    if bool(nbrs.overflow) or bool(sl.overflow):
        raise RuntimeError("neighbor or short-list overflow on the scene")
    del nbrs
    chained = short_phases(ev, x, box, sl, phase)
    ef = phase("energy_forces", lambda: ev.energy_forces_short(x, box, sl))

    st = sim.init_state(x, box, seed=1, t_init=300.0)
    st, _ = sim.run_block(st)                 # warm-up
    blocks = max(1, reps // 2)

    def block():
        nonlocal st
        st, th = sim.run_block(st)
        return th

    phase("step_block", block, blocks, warmup=0)
    res["step_block"] /= THERMO
    log(f"full NPT step (in a {THERMO}-step block): "
        f"{res['step_block'] * 1e3:.3f} ms")
    tot = res["step_block"]
    rec = {
        "scene": f"{n}-atom benchmark slab NPT (boundary m p m, y-coupled), "
                 f"skin {SKIN}, K={CAPACITY}, static short Ks={K_SHORT} "
                 f"delta={SHORT_DELTA} every={THERMO}",
        "atoms": n, "times_s": res,
        "share_of_step": {k: v / tot for k, v in res.items()},
        "atom_steps_per_s_step": n / tot, "device": device_label(dev),
    }
    emit(rec, args.out)
    # the split phase and energy_forces 1 + reps each; init_state, the
    # warm-up block and the timed blocks one a step
    calls = 2 * (1 + reps) + 1 + THERMO * (1 + blocks)
    return ProfileRun(rec, chained, ef, ev, sim, st, x, box, calls)


if __name__ == "__main__":
    main()
