"""Per-phase times of the ni (Behler-Parrinello) step on one NVIDIA GPU.
Counterpart of scripts/profile_ni.py.

The scene is fcc-Ni of --cells^3 cells (40: 256,000 atoms, a = 3.52 A)
with Gaussian displacements of 0.05 A per component from
numpy.random.default_rng(0), on the script's settings: skin 0.5 A,
capacity 64, cell capacity 24, FusedNi (Ks --k-short, short_delta 0.2).
Each phase runs alone on the outputs of the one before (`reps` timed calls
after one untimed; the card's time between CUDA events):

  rebuild     the cell-list build at rc + skin
  compact     FusedNi.compact_short (the refresh-static short list)
  gather      pair_dx_planes on the short rows
  g_kernel    kernels.ni_g (G2/G4 on the [N, Ks] planes)
  mlp         FusedNi._mlp_eat_dedg (the MLP and its hand VJP)
  f_kernel    kernels.ni_force
  deliver     fused_annp.deliver (the Fj stack and the index_add_; the
              port's counterpart of the JAX `assemble`)
  ef          energy_forces_short without the virial (the light step)
  efv         energy_forces_short with the pair virial (a thermo step)
  step_block  one 5-step NVT block (1200 K, from 600 K velocities) of the
              Simulator wired as model_bench's kernels backend, after two
              warm-up blocks; as in the JAX script, a block's time, and the
              shares are of one step (step_block / 5)

The JAX script's transposes into [Ks, 128] blocks are a TPU layout and
are not ported (the port's ni kernels take the [N, Ks] planes). The
chained phases' (E, F) (`ProfileRun.chained`) equal ef's (`ProfileRun.ef`).
Prints one JSON record on stdout; --out also writes it to a file.

    python -m meng_zhang_tpu_torch.scripts.profile_ni [--cells 40]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..run import log, resolve_device
from . import device_label, emit, time_call
from .profile_bench import ProfileRun

SKIN, CAPACITY, CELL_CAPACITY, DELTA, THERMO = 0.5, 64, 24, 0.2, 5
JITTER = 0.05
REPS = 6


def build_parser():
    ap = argparse.ArgumentParser(
        prog="meng_zhang_tpu_torch.scripts.profile_ni",
        description="per-phase times of the ni NVT step")
    ap.add_argument("--cells", type=int, default=40)
    ap.add_argument("--k-short", type=int, default=32)
    ap.add_argument("--potential", default=None,
                    help=".ann file (default: the synthetic ni potential "
                         "of the shipped width, testing.py)")
    ap.add_argument("--out", default=None, help="also write the record here")
    return ap


def main(argv=None, device=None, *, reps=REPS,
         dtype=torch.float32) -> ProfileRun:
    """The profile; `reps` sets the timed calls a phase, `dtype` the run's
    precision (the CPU tests run a reduced scene in float64)."""
    args = build_parser().parse_args(argv)
    from ..geometry.lattice import fcc
    from ..io.potential import read_ann
    from ..md.simulation import MDConfig, Simulator
    from ..models.annp import effective_cutoff, make_annp
    from ..ops import fused_annp as fa
    from ..ops import kernels
    from ..ops.fused_ni import FusedNi
    from ..system.neighbors import build_neighbors_cell, cell_grid_dims
    from ..testing import synthetic_ni_potential
    from ..units import MASS_NI

    dev = resolve_device(device)
    pot = read_ann(args.potential) if args.potential else \
        synthetic_ni_potential(0)
    mcfg, params = make_annp(pot, dtype, dev)
    rc = effective_cutoff(pot)
    x_np, box_np = fcc(args.cells, a=3.52)
    x_np = x_np + np.random.default_rng(0).normal(scale=JITTER,
                                                  size=x_np.shape)
    n = len(x_np)
    rlist = rc + SKIN
    dims = cell_grid_dims(np.asarray(box_np), rlist)
    log(f"scene: {n} atoms fcc-Ni, rc={rc:.3f} rlist={rlist:.2f} "
        f"K={CAPACITY} Ks={args.k_short}")
    x = torch.as_tensor(x_np, dtype=dtype, device=dev)
    box = torch.as_tensor(box_np, dtype=dtype, device=dev)
    ev = FusedNi(mcfg, params, k_short=args.k_short, short_delta=DELTA)

    t = {}
    t["rebuild"], nbrs = time_call(lambda: build_neighbors_cell(
        x, box, rlist, CAPACITY, dims, CELL_CAPACITY), dev, reps)
    t["compact"], sl = time_call(lambda: ev.compact_short(x, box, nbrs.idx),
                                 dev, reps)
    if bool(nbrs.overflow) or bool(sl.overflow):
        raise RuntimeError("neighbor or short-list overflow on the scene")
    t["gather"], dd = time_call(
        lambda: fa.pair_dx_planes(x, box, sl.sidx, ev.pbc), dev, reps)
    t["g_kernel"], g = time_call(lambda: kernels.ni_g(*dd, ev.table), dev,
                                 reps)
    t["mlp"], (eat, dedg) = time_call(lambda: ev._mlp_eat_dedg(g), dev, reps)
    del g
    t["f_kernel"], fj = time_call(
        lambda: kernels.ni_force(*dd, dedg, ev.table), dev, reps)
    del dedg
    t["deliver"], (forces, _) = time_call(
        lambda: fa.deliver(fj, sl.sidx, n), dev, reps)
    chained = (eat.sum(), forces)
    del dd, fj
    t["ef"], ef = time_call(lambda: ev.energy_forces_short(
        x, box, sl, want_virial=False), dev, reps)
    t["efv"], _ = time_call(lambda: ev.energy_forces_short(x, box, sl), dev,
                            reps)

    # the full production step block (model_bench's kernels wiring)
    def force_fn_light(xx, bb, nbr, short):
        e, f = ev.energy_forces_short(xx, bb, short, want_virial=False)
        return e, f, xx.new_zeros(3, 3)

    cfg = MDConfig(dt=0.001, cutoff=rc, skin=SKIN, capacity=CAPACITY,
                   nbr_method="cell", cell_dims=dims,
                   cell_capacity=CELL_CAPACITY, ensemble="nvt",
                   t_target=1200.0, tau_t=0.1, thermo_every=THERMO,
                   stale_factor=0.5, short_every=THERMO, short_skin=DELTA)
    sim = Simulator(
        lambda xx, bb, nbr, short: ev.energy_forces_short(xx, bb, short),
        torch.full((n,), MASS_NI, dtype=dtype, device=dev), cfg,
        short_build=lambda xx, bb, nbr: ev.compact_short(xx, bb, nbr.idx),
        force_fn_light=force_fn_light)
    st = sim.init_state(x, box, seed=1, t_init=600.0)
    st, _ = sim.run(st, 2)
    blocks = max(1, (2 * reps) // 3)

    def block():
        nonlocal st
        st, th = sim.run(st, 1)
        return th

    t["step_block"], _ = time_call(block, dev, blocks, warmup=0)
    for k, v in t.items():
        log(f"{k}: {v * 1e3:.3f} ms")
    step = t["step_block"] / THERMO
    rec = {
        "scene": f"fcc-Ni {n} atoms, rc={rc:.3f}, K={CAPACITY}, "
                 f"Ks={args.k_short}, fused kernels (ops/fused_ni)",
        "atoms": n, "times_s": t,
        "share_of_step": {k: v / step for k, v in t.items()},
        "atom_steps_per_s_step": n / step, "device": device_label(dev),
    }
    emit(rec, args.out)
    # g_kernel / f_kernel, ef and efv 1 + reps each; init_state and the
    # blocks one a step
    calls = 3 * (1 + reps) + 1 + THERMO * (2 + blocks)
    return ProfileRun(rec, chained, ef, ev, sim, st, x, box, calls)


if __name__ == "__main__":
    main()
