"""3-D (x, y, z) spatial domain decomposition over a shard mesh.

Counterpart of meng_zhang_tpu/parallel/domain3d.py: `Plan3D` (:50),
`Shard3DConfig` (:71) and `ShardedMD3D` (:76). At 64 devices an 8 x 8
column mesh carries about 3x ghost rows per owned row; a 4 x 4 x 4 brick
carries the 6-face surface. The layout is the 2-D driver's with a third
staged round (parallel/domain2d.py, `StagedMD`, which holds the rounds,
`plan_park_sites`, `_pack_rows` and `_mark` for both):

  * atoms sort into Dx x-slabs, Dy y-blocks a slab and Dz z-bricks a
    block, each equal-count; boundaries are box fractions;
  * the exchange runs three rounds, x, y, then z over the round-2 frame
    [own | x-blocks | y-blocks], so xz / yz edges and xyz corners ride
    along: the frame is seven blocks [own | x lo, hi | y lo, hi | z lo,
    hi];
  * the frame box is planned along all three axes (the park sites' z
    included) and built with no periodic axis; containment applies along
    z as along x and y;
  * migration runs x, y, then z rounds.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .domain import ShardConfig
from .domain2d import StagedMD


class Plan3D(NamedTuple):
    """The three-round exchange plan, a row a shard (int64, -1 pads).

    sxh/sxl index own rows, syh/syl round-1 frame rows (C + 2 bx), szh/szl
    round-2 frame rows (c1 + 2 by); f1v / f2v the frame rows' validity
    after rounds 1 / 2; padm the pad rows of the full frame; cov gates the
    retroactive coverage check (False right after distribute and
    migrate)."""
    sxh: torch.Tensor
    sxl: torch.Tensor
    syh: torch.Tensor
    syl: torch.Tensor
    szh: torch.Tensor
    szl: torch.Tensor
    f1v: torch.Tensor
    f2v: torch.Tensor
    padm: torch.Tensor
    cov: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Shard3DConfig(ShardConfig):
    """ShardConfig plus the (Dx, Dy, Dz) mesh shape."""
    mesh_shape: tuple = (2, 2, 2)


class ShardedMD3D(StagedMD):
    """Spatially sharded MD driver on a 3-D (x, y, z) shard grid."""
    plan_type = Plan3D

    def __init__(self, model, masses_scalar, box, cfg: Shard3DConfig,
                 mesh=None, device="cuda"):
        if len(cfg.mesh_shape) != 3:
            raise ValueError("mesh_shape must be (Dx, Dy, Dz)")
        if cfg.mesh_shape[2] < 2:
            raise ValueError("use ShardedMD2D (or ShardedMD) for Dz=1")
        super().__init__(model, masses_scalar, box, cfg, mesh=mesh,
                         device=device)

    @property
    def c1(self):
        return self.cfg.c_loc + 2 * self.bx

    @property
    def c2(self):
        return self.c1 + 2 * self.by

    @property
    def c_ext3d(self):
        return self.n_frame

    @property
    def park3d(self):
        return self.park
