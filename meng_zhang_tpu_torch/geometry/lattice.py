"""Cubic lattice builders (numpy only): counterpart of `simple_lattice`,
`bcc` and `fcc` in meng_zhang_tpu/geometry/lattice.py (:20-34)."""
from __future__ import annotations

import numpy as np

from ..units import A_BCC_FE

BCC_BASIS = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
FCC_BASIS = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                      [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])


def simple_lattice(n_cells, a, basis):
    """[nx, ny, nz] periodic box of a cubic lattice; returns (x [N,3], box[3])."""
    n_cells = np.broadcast_to(np.asarray(n_cells), (3,))
    grids = np.meshgrid(*[np.arange(nc) for nc in n_cells], indexing="ij")
    cells = np.stack(grids, axis=-1).reshape(-1, 3)
    x = (cells[:, None, :] + basis[None, :, :]).reshape(-1, 3) * a
    return x, n_cells * a


def bcc(n_cells, a=A_BCC_FE):
    return simple_lattice(n_cells, a, BCC_BASIS)


def fcc(n_cells, a):
    return simple_lattice(n_cells, a, FCC_BASIS)
