"""The yardstick of the rooflines and of step_mfu: the peaks of one NVIDIA
H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit) and the census of
the work the positions need, counted by the reference's own search.

A configuration's reference module states the operations and bytes of
each of its kernels and of the whole step per unit of this census
(`work(pot, census)`): per in-cutoff lane, per in-cutoff unordered leg
pair, per atom; never per padded slot, so the count reads the same whatever
implements it."""
from __future__ import annotations

import torch

from mdbench.reference import neighbors as nb

PEAK_F32_FLOPS = 67e12       # float32 outside the tensor cores (TF32 off)
PEAK_BYTES = 3.35e12         # HBM3


def census(x, box, pbc, cutoff, legs=False, leg_cutoff=None):
    """{"atoms", "lanes": ordered pairs within cutoff, "legs": unordered
    partner pairs (j, k) of a row, both within leg_cutoff of the row's
    atom and of each other (with legs=True)} at positions x."""
    x = x.double()
    box = box.double()
    grid = nb.Grid(x, box, pbc, cutoff)
    n = x.shape[0]
    lanes = lg = 0
    size = 8192 if legs else 65536
    lc = cutoff if leg_cutoff is None else leg_cutoff
    for rows in nb.chunks(n, size, x.device):
        _, dx, valid = nb.partners(grid, rows)
        lanes += int(valid.sum())
        if legs:
            ok = valid & ((dx * dx).sum(-1) < lc * lc)
            d = dx[:, :, None, :] - dx[:, None, :, :]
            pair = ok[:, :, None] & ok[:, None, :] & ((d * d).sum(-1)
                                                      < lc * lc)
            pair &= ~torch.eye(dx.shape[1], dtype=torch.bool,
                               device=x.device)
            lg += int(pair.sum()) // 2
    return {"atoms": n, "lanes": lanes, "legs": lg}


def roofline_share(flops, nbytes, seconds):
    """The least time the card could take for this work (the larger of its
    operations over the f32 peak and its bytes over the memory rate) as a
    share of `seconds`, in %."""
    return 100.0 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) / seconds
