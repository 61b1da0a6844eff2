"""Symmetric-tilt grain-boundary (STGB) bicrystal generator.

Re-implementation of symmetry_tilt_grain_boundary/{stgb.cpp,stgb_b.cpp}:
grain 1 is an oriented crystal clipped to [0, Lx] (with +/-1 A x-tolerance,
stgb_b.cpp:158-164); grain 2 is its mirror x -> 2 Lx - x with atom type 2
(symm_crystal, :167-180); the box doubles in x (stgb.cpp:38). As the
reference README notes, overlapping atoms at the boundary must be deleted
afterwards -- `make_stgb(delete_overlap=...)` provides that step (LAMMPS
`delete_atoms overlap` equivalent) rather than leaving it to the user.

Numpy only; counterpart of meng_zhang_tpu/geometry/stgb.py (`make_stgb`
:23, `_prune_overlaps` :50).
"""
from __future__ import annotations

import numpy as np

from ..io.lammps_data import LammpsData
from ..units import A_BCC_FE
from .lattice import BCC_BASIS, oriented_crystal

DEFAULT_ORIENT = ((-1, 1, -2), (1, -1, -1), (1, 1, 0))
DEFAULT_LENGTH = (34.97014031, 49.45524671, 32.30403188)


def make_stgb(orient=DEFAULT_ORIENT, length_box=DEFAULT_LENGTH,
              a=A_BCC_FE, basis=BCC_BASIS, delete_overlap=None) -> LammpsData:
    """Build the STGB bicrystal as LammpsData (box doubled in x).

    delete_overlap: optional distance (A); boundary atoms of grain 2 closer
    than this to a grain-1 atom are removed (None reproduces the raw
    reference output, which keeps the duplicates).
    """
    length_box = np.asarray(length_box, dtype=np.float64)
    x1 = oriented_crystal(orient, length_box, a=a, basis=basis,
                          center_offset=False, clip_tol=(1.0, 1.0))
    x2 = x1.copy()
    x2[:, 0] = 2.0 * length_box[0] - x2[:, 0]

    if delete_overlap is not None:
        x2 = _prune_overlaps(x1, x2, delete_overlap,
                             np.array([2 * length_box[0], length_box[1],
                                       length_box[2]]))

    x = np.concatenate([x1, x2])
    types = np.concatenate([np.ones(len(x1), np.int32),
                            np.full(len(x2), 2, np.int32)])
    box_hi = np.array([2.0 * length_box[0], length_box[1], length_box[2]])
    return LammpsData(x=x, types=types, box_lo=np.zeros(3), box_hi=box_hi,
                      n_types=2)


def _prune_overlaps(x_keep, x_cand, r_min, box):
    """Drop candidates within r_min of any kept atom (periodic).

    Only atoms near the two boundary planes (x = Lx and, periodically,
    x = 0/2Lx) can overlap, so the pair check is restricted there.
    """
    lx = box[0] / 2.0
    margin = r_min + 1.0
    near_plane_c = (np.abs(x_cand[:, 0] - lx) < margin) \
        | (x_cand[:, 0] < margin) | (x_cand[:, 0] > box[0] - margin)
    near_plane_k = (np.abs(x_keep[:, 0] - lx) < margin) \
        | (x_keep[:, 0] < margin) | (x_keep[:, 0] > box[0] - margin)
    ck = x_keep[near_plane_k]
    drop = np.zeros(len(x_cand), dtype=bool)
    cand_idx = np.nonzero(near_plane_c)[0]
    for i0 in range(0, len(cand_idx), 512):
        sel = cand_idx[i0:i0 + 512]
        d = x_cand[sel][:, None, :] - ck[None, :, :]
        d -= box * np.round(d / box)
        drop[sel] = np.any(np.sum(d * d, axis=-1) < r_min * r_min, axis=1)
    return x_cand[~drop]
