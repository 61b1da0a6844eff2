"""Cubic lattices (numpy): the benchmark makes its scenes itself."""
from __future__ import annotations

import numpy as np

BASES = {"bcc": np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
         "fcc": np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                          [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])}


def lattice(kind, cells, a):
    """(x [N, 3], box [3]) of `cells` (int or 3 ints) cubic cells."""
    cells = np.broadcast_to(np.asarray(cells), (3,))
    grid = np.stack(np.meshgrid(*[np.arange(c) for c in cells],
                                indexing="ij"), -1).reshape(-1, 3)
    x = (grid[:, None, :] + BASES[kind][None]).reshape(-1, 3) * a
    return x, cells * float(a)
