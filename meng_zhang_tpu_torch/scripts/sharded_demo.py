"""The 1-D slab driver (ShardedMD) on the fe potential, D shards on one
NVIDIA GPU. Counterpart of scripts/sharded_demo.py.

  --scene small : bcc-Fe 28 x 6 x 6 cells (2,016 atoms; y and z 17.13 A >
                  2 rlist = 14.6 A, as one device's single-image convention
                  needs) on min(--devices, 4) shards, 1000 NPT steps
                  (--steps), chunk 128; and the single-device reference run
                  of the same trajectory, for the 1-vs-N parity block;
  --scene 100k  : bcc-Fe 125 x 20 x 20 cells (100,000 atoms) on --devices
                  (8) shards, 30 NPT steps, chunk 512.

The shards run over the in-process ShardMesh on the one card (every
per-shard tensor [D, ...], one batched frame evaluation a step), where
the JAX script ran a virtual CPU mesh. The model is XlaFrameModel(k_short
128): the chunked ANNP functions' frame route, through g_harm and
force_harm. NPT on x, y and z at 0 bar and 300 K, skin 0.8 A, halo_b and
capacity derived from the scene by ShardedMD._auto_geometry. Velocities
come from create_velocities at 300 K with a torch.Generator seeded
4928459 (the JAX PRNGKey stream cannot be matched). The first block runs
apart (the JAX script's compile block), then the timed window.

The single-device reference (small) is the n2 Simulator on the same start
and velocities, each evaluation compacting the skin rows to k_short at rc
(compact_neighbor_rows) before energy_forces_virial_chunked, NaN on a
compaction overflow. The record's `parity` block holds the first 100
steps' largest |dT| and |dPE| (the two f32 trajectories have not yet
diverged) and the run's mean differences and largest |dT|. Prints one
JSON record on stdout; --out also writes it to a file.

    python -m meng_zhang_tpu_torch.scripts.sharded_demo --scene small
    python -m meng_zhang_tpu_torch.scripts.sharded_demo --scene 100k
"""
from __future__ import annotations

import argparse
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from ..run import log, resolve_device
from . import device_label, emit

SEED = 4928459
THERMO, SKIN, K_SHORT = 5, 0.8, 128
# per scene: bcc cells, default steps, chunk, most shards
SCENES = {"small": dict(cells=(28, 6, 6), steps=1000, chunk=128, most=4),
          "100k": dict(cells=(125, 20, 20), steps=30, chunk=512, most=None)}
PARITY_ROWS = 20                 # thermo rows of the first 100 steps


class ShardedRun(NamedTuple):
    record: dict
    md: Any                  # the ShardedMD
    state: Any               # ShardState after the run
    thermo: Any              # Thermo of the timed blocks
    ref_thermo: Any          # the single-device run's Thermo (small), else
                             # None
    evaluations: int         # frame evaluations of the sharded run


def build_parser():
    ap = argparse.ArgumentParser(
        prog="meng_zhang_tpu_torch.scripts.sharded_demo",
        description="the 1-D slab driver on one GPU")
    ap.add_argument("--scene", choices=tuple(SCENES), default="small")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--devices", type=int, default=8,
                    help="shards (small takes at most 4)")
    ap.add_argument("--potential", default=None,
                    help=".ann file (default: the synthetic fe potential "
                         "of the shipped width, testing.py)")
    ap.add_argument("--out", default=None, help="also write the record here")
    return ap


def single_device(mcfg, params, masses, capacity, chunk):
    """The n2 Simulator of the reference run (JAX :132-152)."""
    from ..md.simulation import MDConfig, Simulator
    from ..models.annp import (compact_neighbor_rows,
                               energy_forces_virial_chunked)
    cfg1 = MDConfig(dt=0.001, cutoff=mcfg.cut, skin=SKIN, capacity=capacity,
                    nbr_method="n2", ensemble="npt", t_target=300.0,
                    tau_t=0.1, p_target=(0.0,) * 3,
                    p_couple=(True, True, True), tau_p=1.0,
                    thermo_every=THERMO, stale_factor=0.5)

    def force_fn(xx, bb, nbrs):
        idx_s, ovf = compact_neighbor_rows(xx, bb, nbrs.idx, mcfg.cut,
                                           K_SHORT)
        e, f, w = energy_forces_virial_chunked(mcfg, params, xx, bb, idx_s,
                                               chunk=chunk, shift=False)
        nan = torch.full((), float("nan"), dtype=f.dtype, device=f.device)
        return torch.where(ovf, nan, e), torch.where(ovf, nan, f), w

    return Simulator(force_fn, masses, cfg1)


def main(argv=None, device=None, *, dtype=torch.float32,
         velocities=None) -> ShardedRun:
    """The scene's run; `dtype` sets its precision and `velocities` [N, 3]
    (numpy) replace the seeded draw (the CPU tests give both packages the
    same ones)."""
    args = build_parser().parse_args(argv)
    from ..geometry.lattice import bcc
    from ..io.potential import read_ann
    from ..md.simulation import create_velocities
    from ..models.annp import make_annp
    from ..parallel.domain import ShardConfig, ShardedMD, XlaFrameModel
    from ..testing import synthetic_fe_potential
    from ..units import MASS_FE

    dev = resolve_device(device)
    sc = SCENES[args.scene]
    d = args.devices if sc["most"] is None else min(args.devices, sc["most"])
    steps = args.steps or sc["steps"]
    pot = read_ann(args.potential) if args.potential else \
        synthetic_fe_potential(0)
    mcfg, params = make_annp(pot, dtype, dev)
    x_np, box_np = bcc(list(sc["cells"]))
    n = len(x_np)
    log(f"scene: {n} atoms, box {np.round(box_np, 1)}, {d} shards, "
        f"{steps} NPT steps")
    x = torch.as_tensor(x_np, dtype=dtype, device=dev)
    box = torch.as_tensor(box_np, dtype=dtype, device=dev)
    masses = torch.full((n,), MASS_FE, dtype=dtype, device=dev)
    if velocities is None:
        v0 = create_velocities(torch.Generator(device=dev).manual_seed(SEED),
                               masses, 300.0, dtype)
    else:
        v0 = torch.as_tensor(velocities, dtype=dtype, device=dev)

    model = XlaFrameModel(mcfg, params, chunk=sc["chunk"], k_short=K_SHORT)
    scfg = ShardConfig(
        n_devices=d, c_loc=n // d, cutoff=mcfg.cut, skin=SKIN, dt=0.001,
        ensemble="npt", t_target=300.0, tau_t=0.1, p_target=(0.0,) * 3,
        p_couple=(True, True, True), tau_p=1.0, thermo_every=THERMO,
        stale_factor=0.5)
    md = ShardedMD(model, MASS_FE, box_np, scfg, device=dev)
    t0 = time.time()
    st, _ = md.distribute(x, v0)
    ovf = int(st.overflow.max())
    if ovf:
        raise RuntimeError(f"coverage/capacity overflow bitmask={ovf}")
    log(f"distribute: {time.time() - t0:.1f}s  frame_wx={md.frame_wx:.1f}"
        f" dims={md.frame_dims}  halo_b={md.cfg.halo_b}"
        f" capacity={md.cfg.capacity}")
    t0 = time.time()
    st, _ = md.run(st, 1)
    log(f"first block: {time.time() - t0:.1f}s")
    n_blocks = steps // THERMO - 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    st, th = md.run(st, n_blocks)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    aps = n * n_blocks * THERMO / wall
    overflow = bool(st.overflow.any())
    log(f"{n_blocks * THERMO} steps in {wall:.1f}s -> {aps:,.0f} "
        f"atom-steps/s, rebuilds={md.rebuild_count}, overflow={overflow}, "
        f"unsafe={bool(st.unsafe.any())}")
    if overflow:
        raise RuntimeError(f"overflow flags {st.overflow.tolist()}")
    pe_off = n * mcfg.e_shift
    sharded = {"temp": th.temp.tolist(),
               "pe": [v + pe_off for v in th.pe.tolist()],
               "press": th.press.tolist(), "vol": th.vol.tolist()}
    rec = {
        "scene": args.scene, "atoms": n, "devices": d,
        "steps": (n_blocks + 1) * THERMO, "ensemble": "npt (xyz, 0 bar)",
        "wall_s": wall, "atom_steps_per_s": aps,
        "rebuilds": md.rebuild_count,
        "halo_b": md.cfg.halo_b, "capacity": md.cfg.capacity,
        "unsafe": bool(st.unsafe.any()), "overflow": overflow,
        "final": {k: v[-1] for k, v in sharded.items()},
        "dtype": str(dtype).removeprefix("torch."),
        "device": device_label(dev),
    }

    th1 = None
    if args.scene == "small":
        sim = single_device(mcfg, params, masses, md.cfg.capacity,
                            sc["chunk"])
        st1 = sim.init_state(x, box, v=v0, seed=1)
        t0 = time.time()
        st1, th1 = sim.run(st1, n_blocks + 1)
        log(f"single-device reference: {time.time() - t0:.1f}s, "
            f"rebuilds={sim.rebuild_count}")
        t1 = th1.temp[1:].double().cpu().numpy()
        p1 = th1.pe[1:].double().cpu().numpy() + pe_off
        tempd = np.abs(t1 - np.asarray(sharded["temp"]))
        ped = np.abs(p1 - np.asarray(sharded["pe"]))
        w = min(PARITY_ROWS, len(tempd))
        rec["parity"] = {
            "first100_temp_max_abs_K": float(np.max(tempd[:w])),
            "first100_pe_max_abs_eV": float(np.max(ped[:w])),
            # the run's statistics (f32 chaos makes the per-step max
            # meaningless over a long run)
            "run_temp_mean_diff_K": float(np.mean(t1)
                                          - np.mean(sharded["temp"])),
            "run_pe_mean_diff_eV": float(np.mean(p1)
                                         - np.mean(sharded["pe"])),
            "run_temp_max_abs_K": float(np.max(tempd)),
            "single_chip_rebuilds": sim.rebuild_count,
        }
        p = rec["parity"]
        log(f"parity: first100 dT_max={p['first100_temp_max_abs_K']:.3g} K "
            f" dPE_max={p['first100_pe_max_abs_eV']:.3g} eV; run mean "
            f"dT={p['run_temp_mean_diff_K']:.3g} K")
    emit(rec, args.out)
    return ShardedRun(rec, md, st, th, th1, 1 + (n_blocks + 1) * THERMO)


if __name__ == "__main__":
    main()
