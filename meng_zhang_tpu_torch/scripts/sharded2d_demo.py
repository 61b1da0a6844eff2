"""The 2-D grid driver (ShardedMD2D) on the fe potential: a (2, 4) grid of
columns on one NVIDIA GPU. Counterpart of scripts/sharded2d_demo.py.

The scene is bcc-Fe of --cells (default 18 x 22 x 16, 12,672 atoms) with
Gaussian displacements of 0.03 A per component from
numpy.random.default_rng(0); the model XlaFrameModel(chunk 512, k_short
128), through g_harm and force_harm; skin 0.8 A, NVE, velocities at 300 K
from a torch.Generator seeded 12 (the JAX PRNGKey stream cannot be
matched). At distribute the forces, energy and virial are held against
the single-device chunked path (cell-list skin rows compacted to k_short
at rc, energy_forces_virial_chunked), with the JAX script's limits:
|dF|max < 5e-4 eV/A and |dE| < 5e-2 eV, the f32 evaluation noise; then
--steps (20) NVE steps. The shards run over the in-process ShardMesh on
the one card, where the JAX script ran a virtual CPU mesh.

The JAX script's default, 18 x 18 x 16 cells, cannot be planned: its
y-blocks (51.4 A / 4 = 12.8 A) are narrower than the band 2 rlist = 14.6 A
that a periodic axis of four blocks needs plus the 0.4 A drift margin,
and both packages' planners refuse it. 22 y-cells give 15.7 A blocks.

Prints one JSON record on stdout; --out also writes it to a file.

    python -m meng_zhang_tpu_torch.scripts.sharded2d_demo
"""
from __future__ import annotations

import argparse
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from ..run import log, resolve_device
from . import device_label, emit

MESH = (2, 4)
SKIN, K_SHORT, CHUNK, THERMO = 0.8, 128, 512, 5
JITTER, SEED = 0.03, 12
F_LIMIT, E_LIMIT = 5e-4, 5e-2    # eV/A, eV: the f32 evaluation noise


class Sharded2DRun(NamedTuple):
    record: dict
    md: Any                  # the ShardedMD2D
    state: Any               # ShardState after the run
    thermo: Any              # Thermo of the NVE blocks
    evaluations: int         # frame evaluations of the sharded run


def build_parser():
    ap = argparse.ArgumentParser(
        prog="meng_zhang_tpu_torch.scripts.sharded2d_demo",
        description="the 2-D grid driver on a (2, 4) grid on one GPU")
    ap.add_argument("--cells", type=int, nargs=3, default=[18, 22, 16],
                    help="bcc cells (default 12,672 atoms)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--potential", default=None,
                    help=".ann file (default: the synthetic fe potential "
                         "of the shipped width, testing.py)")
    ap.add_argument("--out", default=None, help="also write the record here")
    return ap


def main(argv=None, device=None, *, dtype=torch.float32,
         velocities=None) -> Sharded2DRun:
    """The run; `dtype` sets its precision and `velocities` [N, 3] (numpy)
    replace the seeded draw (the CPU tests give both packages the same
    ones)."""
    args = build_parser().parse_args(argv)
    from ..geometry.lattice import bcc
    from ..io.potential import read_ann
    from ..md.simulation import create_velocities
    from ..models.annp import (compact_neighbor_rows,
                               energy_forces_virial_chunked, make_annp)
    from ..parallel.domain import XlaFrameModel
    from ..parallel.domain2d import Shard2DConfig, ShardedMD2D
    from ..system.neighbors import build_neighbors_cell, cell_grid_dims
    from ..testing import synthetic_fe_potential
    from ..units import MASS_FE

    dev = resolve_device(device)
    pot = read_ann(args.potential) if args.potential else \
        synthetic_fe_potential(0)
    mcfg, params = make_annp(pot, dtype, dev)
    x_np, box_np = bcc(args.cells)
    x_np = x_np + np.random.default_rng(0).normal(scale=JITTER,
                                                  size=x_np.shape)
    n = len(x_np)
    d = int(np.prod(MESH))
    x = torch.as_tensor(x_np, dtype=dtype, device=dev)
    box = torch.as_tensor(box_np, dtype=dtype, device=dev)
    log(f"scene: {n} atoms, box {np.round(box_np, 1)}, mesh {MESH}")
    cfg = Shard2DConfig(n_devices=d, mesh_shape=MESH, c_loc=n // d,
                        cutoff=mcfg.cut, skin=SKIN, dt=0.001,
                        thermo_every=THERMO, stale_factor=0.5)
    md = ShardedMD2D(XlaFrameModel(mcfg, params, chunk=CHUNK,
                                   k_short=K_SHORT),
                     MASS_FE, box_np, cfg, device=dev)
    if velocities is None:
        v0 = create_velocities(
            torch.Generator(device=dev).manual_seed(SEED),
            torch.full((n,), MASS_FE, dtype=dtype, device=dev), 300.0,
            dtype)
    else:
        v0 = torch.as_tensor(velocities, dtype=dtype, device=dev)
    t0 = time.time()
    st, _ = md.distribute(x, v0)
    ovf = int(st.overflow.max())
    if ovf:
        raise RuntimeError(f"overflow bitmask={ovf}")
    ghost = md.c_ext2d - cfg.c_loc
    log(f"distribute: {time.time() - t0:.1f}s  bx={md.bx} by={md.by} "
        f"c_ext={md.c_ext2d} (ghost fraction {ghost / cfg.c_loc:.2f}) "
        f"K={md.cfg.capacity}")

    # the single-device reference at t = 0
    rlist = mcfg.cut + SKIN
    nbrs = build_neighbors_cell(x, box, rlist, md.cfg.capacity,
                                cell_grid_dims(np.asarray(box_np), rlist),
                                96)
    idx_s, _ = compact_neighbor_rows(x, box, nbrs.idx, mcfg.cut, K_SHORT)
    e_ref, f_ref, w_ref = energy_forces_virial_chunked(
        mcfg, params, x, box, idx_s, chunk=CHUNK, shift=False)
    del nbrs, idx_s
    f_g = torch.empty_like(f_ref)
    f_g[st.gid.reshape(-1)] = st.f_loc.reshape(n, 3)
    d_f = float((f_g - f_ref).abs().max())
    d_e = abs(float(st.pe.double().sum()) - float(e_ref))
    d_w = float((st.virial - w_ref).abs().max())
    log(f"parity at t=0: |dF|max={d_f:.3g} eV/A  |dE|={d_e:.3g} eV "
        f"|dW|max={d_w:.3g}")
    if not (d_f < F_LIMIT and d_e < E_LIMIT):
        raise RuntimeError(f"parity at t=0 off the single-device path: "
                           f"|dF|max {d_f:.3g} (limit {F_LIMIT}), |dE| "
                           f"{d_e:.3g} (limit {E_LIMIT})")

    n_blocks = args.steps // THERMO
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    st, th = md.run(st, n_blocks)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    aps = n * n_blocks * THERMO / wall
    overflow = bool(st.overflow.any())
    log(f"{n_blocks * THERMO} NVE steps in {wall:.1f}s -> {aps:,.0f} "
        f"atom-steps/s, rebuilds={md.rebuild_count}, overflow={overflow}")
    if overflow:
        raise RuntimeError(f"overflow flags {st.overflow.tolist()}")
    rec = {
        "scene": f"bcc-Fe {list(args.cells)}", "atoms": n, "mesh": list(MESH),
        "steps": n_blocks * THERMO, "wall_s": wall, "atom_steps_per_s": aps,
        "rebuilds": md.rebuild_count, "ghost_rows_per_device": ghost,
        "ghost_fraction": ghost / cfg.c_loc,
        "parity_t0": {"f_max_abs": d_f, "e_abs": d_e, "w_max_abs": d_w},
        "final": {"temp": float(th.temp[-1]),
                  "pe": float(th.pe[-1]) + n * mcfg.e_shift},
        "unsafe": bool(st.unsafe.any()), "overflow": overflow,
        "dtype": str(dtype).removeprefix("torch."),
        "device": device_label(dev),
    }
    emit(rec, args.out)
    return Sharded2DRun(rec, md, st, th, 1 + n_blocks * THERMO)


if __name__ == "__main__":
    main()
