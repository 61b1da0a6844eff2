"""Per-phase times and memory of the 2M-atom STGB NVE step on one NVIDIA
GPU. Counterpart of scripts/profile_2m.py.

The scene is scale_demo's `--config 2m` bicrystal (1,964,085 atoms, as
built; --positions FILE.npz with arrays x and box, e.g. FIRE-relaxed
positions, replaces it, where the JAX script read its /tmp scene cache),
on the script's settings: skin 0.8 A, capacity 168, cell capacity 48, the
cell grid over the whole box, FusedAnnp's harmonic short path (Ks 128,
short_delta 0.3, refreshed every 10-step block), NVE at 300 K. Each phase
runs alone on the outputs of the one before (`reps` timed calls after one
untimed; the card's time between CUDA events), and frees its outputs
before the next:

  rebuild        the cell-list build of the skin list (no reverse slots)
  compact        FusedAnnp.compact_short
  gather         pair_dx_planes on the short rows
  kernels_mlp    FusedAnnp._eval_fj: g_harm, the MLP and force_harm
  deliver        fused_annp.deliver (the Fj stack and the index_add_; the
                 port's counterpart of the JAX `assemble`)
  energy_forces  the whole evaluation, energy_forces_short, no virial
  step_block     one NVE step of a 10-step block (Simulator.run_block)

Besides each phase's time the record holds its peak device memory
(`peak_mem_gib_by_phase`, torch.cuda.max_memory_allocated over the phase,
the counter reset at its start) and what was allocated when it started
(`held_mem_gib_by_phase`); `init_state` adds a memory-only entry, the
MD state's first skin list, short list and evaluation. Left out as TPU
workarounds: `rev_slots_baseline` (the port has no reverse slots) and
`assemble_flat4` (a sort delivery). The chained phases' (E, F)
(`ProfileRun.chained`) equal energy_forces' (`ProfileRun.ef`). Prints one
JSON record on stdout; --out also writes it to a file.

    python -m meng_zhang_tpu_torch.scripts.profile_2m [--positions x.npz]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..run import log, resolve_device
from . import device_label, emit, peak_mem_gib, time_call
from .profile_bench import ProfileRun, short_phases

SKIN, CAPACITY, CELL_CAPACITY, THERMO = 0.8, 168, 48, 10
K_SHORT, SHORT_DELTA = 128, 0.3
REPS = 3


def build_parser():
    ap = argparse.ArgumentParser(
        prog="meng_zhang_tpu_torch.scripts.profile_2m",
        description="per-phase times and memory of the 2M-atom STGB NVE "
                    "step")
    ap.add_argument("--positions", default=None,
                    help=".npz with arrays x [N, 3] and box [3] (default: "
                         "scale_demo's 2m scene as built)")
    ap.add_argument("--potential", default=None,
                    help=".ann file (default: the synthetic fe potential "
                         "of the shipped width, testing.py)")
    ap.add_argument("--out", default=None, help="also write the record here")
    return ap


class _Memory:
    """Each phase's peak and starting allocation (GiB) on the card."""

    def __init__(self, dev):
        self.dev, self.peak, self.held = dev, {}, {}

    def start(self, name):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            self.held[name] = torch.cuda.memory_allocated(self.dev) / 2**30
            torch.cuda.reset_peak_memory_stats(self.dev)

    def stop(self, name):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            self.peak[name] = peak_mem_gib(self.dev)
            log(f"{name}: peak {self.peak[name]:.3f} GiB (held at its "
                f"start {self.held[name]:.3f} GiB)")


def main(argv=None, device=None, *, scene=None, reps=REPS,
         dtype=torch.float32) -> ProfileRun:
    """The profile; `scene` (x [N, 3], box [3]) replaces the scene (and
    --positions), `reps` sets the timed calls a phase, `dtype` the run's
    precision (the CPU tests run a reduced scene in float64)."""
    args = build_parser().parse_args(argv)
    from ..io.potential import read_ann
    from ..md.simulation import MDConfig, Simulator
    from ..models.annp import make_annp
    from ..ops.fused_annp import FusedAnnp
    from ..system.neighbors import cell_grid_dims
    from ..testing import synthetic_fe_potential
    from ..units import MASS_FE
    from .scale_demo import build_scene

    dev = resolve_device(device)
    if scene is None:
        if args.positions:
            z = np.load(args.positions)
            scene = (z["x"], z["box"])
        else:
            scene = build_scene("2m")[:2]
    x = torch.as_tensor(scene[0], dtype=dtype, device=dev)
    box = torch.as_tensor(scene[1], dtype=dtype, device=dev)
    box_np = box.double().cpu().numpy()
    del scene
    n = x.shape[0]
    log(f"STGB scene: {n} atoms, box {np.round(box_np, 1)}")
    pot = read_ann(args.potential) if args.potential else \
        synthetic_fe_potential(0)
    mcfg, params = make_annp(pot, dtype, dev)
    ev = FusedAnnp(mcfg, params, k_short=K_SHORT, short_delta=SHORT_DELTA)
    cfg = MDConfig(dt=0.001, cutoff=mcfg.cut, skin=SKIN, capacity=CAPACITY,
                   nbr_method="cell",
                   cell_dims=cell_grid_dims(box_np, mcfg.cut + SKIN),
                   cell_capacity=CELL_CAPACITY, ensemble="nve",
                   t_target=300.0, thermo_every=THERMO, stale_factor=0.5,
                   short_every=THERMO, short_skin=SHORT_DELTA)

    def force_fn(xx, bb, nbrs, short):
        e, f = ev.energy_forces_short(xx, bb, short, want_virial=False)
        return e, f, xx.new_zeros(3, 3)

    sim = Simulator(force_fn, torch.full((n,), MASS_FE, dtype=dtype,
                                         device=dev), cfg,
                    short_build=lambda xx, bb, nbrs: ev.compact_short(
                        xx, bb, nbrs.idx))
    res, mem = {}, _Memory(dev)

    def phase(name, fn, n_reps=reps, warmup=1):
        mem.start(name)
        res[name], out = time_call(fn, dev, n_reps, warmup)
        log(f"{name}: {res[name]:.4f} s")
        mem.stop(name)
        return out

    nbrs = phase("rebuild", lambda: sim.build_nbrs(x, box),
                 max(1, (2 * reps) // 3))
    sl = phase("compact", lambda: ev.compact_short(x, box, nbrs.idx))
    if bool(nbrs.overflow) or bool(sl.overflow):
        raise RuntimeError("neighbor or short-list overflow on the scene")
    del nbrs
    chained = short_phases(ev, x, box, sl, phase, split=False,
                           virial=False)[:2]
    ef = phase("energy_forces", lambda: ev.energy_forces_short(
        x, box, sl, want_virial=False))
    del sl

    mem.start("init_state")
    st = sim.init_state(x, box, seed=1, t_init=300.0)
    mem.stop("init_state")
    st, _ = sim.run_block(st)                 # warm-up
    blocks = max(1, (2 * reps) // 3)

    def block():
        nonlocal st
        st, th = sim.run_block(st)
        return th

    phase("step_block", block, blocks, warmup=0)
    res["step_block"] /= THERMO
    log(f"full NVE step (in a {THERMO}-step block): "
        f"{res['step_block']:.4f} s -> {n / res['step_block']:,.0f} "
        "atom-steps/s")
    tot = res["step_block"]
    rec = {
        "scene": f"{n}-atom STGB NVE, skin {SKIN}, K={CAPACITY}, short "
                 f"Ks={K_SHORT} delta={SHORT_DELTA} every={THERMO}",
        "atoms": n, "times_s": res,
        "share_of_step": {k: v / tot for k, v in res.items()},
        "atom_steps_per_s_step": n / tot,
        "peak_mem_gib_by_phase": mem.peak or None,
        "held_mem_gib_by_phase": mem.held or None,
        "device": device_label(dev),
    }
    emit(rec, args.out)
    # kernels_mlp and energy_forces 1 + reps each; init_state, the warm-up
    # block and the timed blocks one a step
    calls = 2 * (1 + reps) + 1 + THERMO * (1 + blocks)
    return ProfileRun(rec, chained, ef, ev, sim, st, x, box, calls)


if __name__ == "__main__":
    main()
