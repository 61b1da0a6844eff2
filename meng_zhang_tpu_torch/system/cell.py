"""Orthogonal simulation cell (counterpart of meng_zhang_tpu/system/cell.py:
`min_image`, `wrap`, `pair_displacements`, `volume`), and the image-extended position table of thin periodic boxes
(built inline in the JAX package: models/annp.py:619,
md/simulation.py:209-210)."""
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


def wrap(x, box):
    """Positions wrapped into [0, box) on every axis."""
    box = box.to(x.dtype)
    return x - box * torch.floor(x / box)


def pair_displacements(x, idx, box):
    """dx[i, s] = min_image(x[i] - x[idx[i, s]]), every axis periodic (the
    reference's sign convention x_i - x_j). idx must index rows of x."""
    return min_image(x[:, None, :] - x[idx], box)


def volume(box):
    return box[0] * box[1] * box[2]


def image_table(x, box, shifts):
    """x_ext [R*N, 3]: row r*N + i is atom i shifted by shifts[r] box
    lengths (shifts [R, 3] integer, shifts[0] = 0, from
    models/annp.image_shift_table; pass it as a tensor on x's device to
    spare a host copy a call). Built from the current box, so the images
    follow an NPT box."""
    sh = torch.as_tensor(shifts, device=x.device).to(x.dtype)
    return (x[None, :, :] + (sh * box)[:, None, :]).reshape(-1, 3)
