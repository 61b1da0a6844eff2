"""Halo (ghost) fraction of the sharded drivers' layouts on a near-cubic
box: 1-D slabs against 2-D columns and 3-D bricks. Counterpart of
scripts/halo_fraction.py.

Ghost fraction = ghost rows a shard / its owned rows: the per-step halo
exchange and frame-evaluation overhead of a layout. The rows come from the
drivers' own planning code, run on the host at `distribute`'s start:
ShardedMD._auto_geometry (slabs: 2 halo_b rows) and ShardedMD2D /
ShardedMD3D._plan_grid (the frame rows beyond the owned ones), on cubic
bcc-Fe of --cells^3 cells (100: 2,000,000 atoms, 285.5 A) with Gaussian
displacements of 0.03 A per component from numpy.random.default_rng(0),
rc 6.5 A and skin 1.2 A, for 8, 16 and 64 shards. A layout the planner
refuses gets no ghost count and the reason's first clause as its note.
No MD runs and nothing of the scene's size goes to the device: the
drivers are built over a mesh whose per-shard tensors are created at
`distribute`, which planning does not reach. `--cells` replaces the JAX
script's HALO_CELLS environment variable.

Prints one JSON record on stdout (scene, rows, note); --out also writes
it to a file.

    python -m meng_zhang_tpu_torch.scripts.halo_fraction [--cells 100]
"""
from __future__ import annotations

import argparse
import types
from typing import NamedTuple

import numpy as np
import torch

from ..run import log, resolve_device
from . import device_label, emit

CUTOFF, SKIN, MASS = 6.5, 1.2, 55.845
# shards and their layouts: None for slabs, else the grid's shape
LAYOUTS = ((8, (None, (2, 4), (4, 2), (2, 2, 2))),
           (16, (None, (4, 4), (2, 2, 4))),
           (64, (None, (8, 8), (4, 4, 4))))


class HaloRun(NamedTuple):
    record: dict


class _Stub:
    """Planning reads only the model's pbc (the grid drivers check it)."""
    e_shift = 0.0
    mcfg = types.SimpleNamespace(pbc=(True, True, True))


def build_parser():
    ap = argparse.ArgumentParser(
        prog="meng_zhang_tpu_torch.scripts.halo_fraction",
        description="ghost fraction of slabs, columns and bricks")
    ap.add_argument("--cells", type=int, default=100,
                    help="bcc cells a side (default 100: 2,000,000 atoms)")
    ap.add_argument("--out", default=None, help="also write the record here")
    return ap


def ghost_rows(x_np, box_np, d_tot, shape, dev):
    """(ghost rows a shard, note) of one layout, from its planner."""
    from ..parallel.domain import ShardConfig, ShardedMD
    from ..parallel.domain2d import Shard2DConfig, ShardedMD2D, grid_order
    from ..parallel.domain3d import Shard3DConfig, ShardedMD3D
    c = len(x_np) // d_tot
    common = dict(n_devices=d_tot, c_loc=c, cutoff=CUTOFF, skin=SKIN,
                  dt=0.001)
    try:
        if shape is None:
            md = ShardedMD(_Stub(), MASS, box_np, ShardConfig(**common),
                           device=dev)
            md._auto_geometry(np.sort(x_np[:, 0]), box_np)
            return 2 * md.cfg.halo_b, ""
        cls, cfg_cls = ((ShardedMD2D, Shard2DConfig) if len(shape) == 2
                        else (ShardedMD3D, Shard3DConfig))
        md = cls(_Stub(), MASS, box_np, cfg_cls(mesh_shape=shape, **common),
                 device=dev)
        md._plan_grid(x_np[grid_order(x_np, shape)], box_np)
        return md.n_frame - c, ""
    except ValueError as e:
        return None, str(e).split(":")[0]


def main(argv=None, device=None) -> HaloRun:
    args = build_parser().parse_args(argv)
    from ..geometry.lattice import bcc
    dev = resolve_device(device)
    x_np, box_np = bcc([args.cells] * 3)
    x_np = x_np + np.random.default_rng(0).normal(scale=0.03,
                                                  size=x_np.shape)
    n = len(x_np)
    log(f"scene: {n} atoms, cubic box {box_np[0]:.1f} A, rlist "
        f"{CUTOFF + SKIN}")
    rows = []
    for d_tot, shapes in LAYOUTS:
        c = n // d_tot
        for shape in shapes:
            ghost, note = ghost_rows(x_np, box_np, d_tot, shape, dev)
            label = (f"{d_tot} dev, 1-D slabs" if shape is None else
                     f"{d_tot} dev, {len(shape)}-D "
                     + "x".join(str(s) for s in shape))
            frac = None if ghost is None else ghost / c
            rows.append({"decomp": label, "owned": c, "ghost_rows": ghost,
                         "ghost_fraction": frac, "note": note})
            log(f"{label:24s} owned={c:8d} ghost={ghost} frac={frac} {note}")
    rec = {
        "scene": f"cubic bcc-Fe, {n} atoms, box {box_np[0]:.1f} A, "
                 f"rlist {CUTOFF + SKIN} A",
        "rows": rows,
        "note": "ghost fraction = frame rows beyond owned rows per shard; "
                "a 1-D slab's halo spans 2 (2 rlist + margin) of a box/D "
                "slab, 2-D pays two thinner bands plus corners, 3-D pays "
                "six faces plus edges and corners",
        "device": device_label(dev),
    }
    emit(rec, args.out)
    return HaloRun(rec)


if __name__ == "__main__":
    main()
