"""Orthogonal simulation cell (counterpart of meng_zhang_tpu/system/cell.py,
`min_image`)."""
from __future__ import annotations

import torch


def min_image(dx, box, pbc=(True, True, True)):
    """Nearest-image displacement x_i - x_j for an orthogonal box.

    dx: [..., 3]; box: [3] tensor; pbc: per-axis periodicity (the benchmark
    scene runs `boundary m p m`: only y periodic). torch.round rounds half
    to even, like jnp.round. The mixed case wraps axis by axis: a mask
    tensor built from `pbc` would be copied to the device on every call.
    """
    box = box.to(dx.dtype)
    if all(pbc):
        return dx - box * torch.round(dx / box)
    cols = []
    for d in range(3):
        c = dx[..., d]
        if pbc[d]:
            c = c - box[d] * torch.round(c / box[d])
        cols.append(c)
    return torch.stack(cols, dim=-1)
