"""Fixed-capacity padded neighbor lists, built on the device.

Counterpart of meng_zhang_tpu/system/neighbors.py: `build_neighbors_n2`
(:71), `cell_grid_dims` (:90), `build_neighbors_cell` (:187),
`max_displacement_sq` (:290) and `estimate_capacity` (:314).

Every list is a dense [N, K] int64 tensor whose rows hold the partner ids
ascending, padded with the sentinel N. Capacity problems are reported
through the `overflow` flag (a bool tensor that stays on the device): some
row has more than K entries, some cell more than its capacity, or an NPT
box shrank below the cell grid's cutoff (`dims_stale`). The reverse-slot
maps of the JAX package (`reverse_slots`, `with_rev`) exist only for its
sort-based delivery and are not ported.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .cell import min_image


class NeighborList(NamedTuple):
    idx: torch.Tensor        # [N, K] int64, ascending rows padded with N
    overflow: torch.Tensor   # bool scalar tensor
    ref_x: torch.Tensor      # [N, 3] positions at build time


def _compact_rows(within, cand, capacity, n):
    """Pack the True entries of `within` [R, C] into ascending [R, capacity]
    rows padded with n; also returns the per-row true counts."""
    keys = torch.where(within, cand, torch.full_like(cand, n))
    keys = torch.sort(keys, dim=1).values
    counts = within.sum(dim=1)
    if keys.shape[1] < capacity:
        keys = torch.cat([keys, torch.full(
            (keys.shape[0], capacity - keys.shape[1]), n, dtype=keys.dtype,
            device=keys.device)], dim=1)
    return keys[:, :capacity], counts


def build_neighbors_n2(x, box, cutoff, capacity, pbc=(True, True, True)):
    """All-pairs build (N up to a few thousand)."""
    n = x.shape[0]
    dx = min_image(x[:, None, :] - x[None, :, :], box, pbc)
    rsq = (dx * dx).sum(dim=-1)
    within = (rsq < cutoff * cutoff) & (rsq > 1.0e-12)
    within &= ~torch.eye(n, dtype=torch.bool, device=x.device)
    cand = torch.arange(n, device=x.device).expand(n, n)
    idx, counts = _compact_rows(within, cand, capacity, n)
    return NeighborList(idx, (counts > capacity).any(), x)


def cell_grid_dims(box, cutoff):
    """Static grid dimensions (>= 1 cell of edge >= cutoff per axis)."""
    return tuple(max(int(float(b) // cutoff), 1) for b in box)


def build_neighbors_cell(x, box, cutoff, capacity, dims, cell_capacity,
                         row_chunk=8192, pbc=(True, True, True)):
    """Cell-list build over atom rows.

    Atoms are binned into `dims` cells of at most `cell_capacity` atoms;
    each atom row then tests the 27 stencil cells' slots and packs its hits.
    Rows run in chunks of `row_chunk`, so at most a [row_chunk, 27 *
    cell_capacity] candidate table exists at a time (the 152,880-atom
    benchmark scene would otherwise hold [N, 2592]). Every dims entry must
    be >= 3 so the stencil never aliases a cell onto itself.
    """
    n = x.shape[0]
    dev = x.device
    nx, ny, nz = dims
    ncell = nx * ny * nz
    if min(dims) < 3:
        raise ValueError("cell list needs >= 3 cells per direction; use n2")
    cc = cell_capacity
    box = box.to(x.dtype)
    pbc_t = torch.tensor(pbc, dtype=torch.bool, device=dev)
    s = x / box
    frac = torch.where(pbc_t, s - torch.floor(s), s.clamp(0.0, 1.0))
    dvec = torch.tensor(dims, device=dev)
    c3 = torch.minimum((frac * dvec).to(torch.int64).clamp(min=0), dvec - 1)
    cid = (c3[:, 0] * ny + c3[:, 1]) * nz + c3[:, 2]

    order = torch.argsort(cid, stable=True)
    sorted_cid = cid[order]
    start = torch.searchsorted(sorted_cid, torch.arange(ncell, device=dev))
    rank = torch.arange(n, device=dev) - start[sorted_cid]
    cell_overflow = (rank >= cc).any()
    # grid[c, slot] = atom id, plus an all-sentinel cell at index ncell;
    # atoms beyond a full cell land in one dump slot past the grid
    dump = (ncell + 1) * cc
    grid = torch.full((dump + 1,), n, dtype=torch.int64, device=dev)
    grid[torch.where(rank < cc, sorted_cid * cc + rank, dump)] = order
    grid = grid[:dump].view(ncell + 1, cc)

    offs = torch.stack(torch.meshgrid(
        *([torch.arange(-1, 2, device=dev)] * 3), indexing="ij"),
        dim=-1).reshape(27, 3)
    all3 = torch.stack(torch.meshgrid(
        torch.arange(nx, device=dev), torch.arange(ny, device=dev),
        torch.arange(nz, device=dev), indexing="ij"), dim=-1).reshape(ncell, 3)
    nb3_raw = all3[:, None, :] + offs[None, :, :]
    cell_ok = (((nb3_raw >= 0) & (nb3_raw < dvec)) | pbc_t).all(dim=-1)
    nb3 = nb3_raw % dvec
    nb_cid = (nb3[..., 0] * ny + nb3[..., 1]) * nz + nb3[..., 2]
    nb_cid = torch.where(cell_ok, nb_cid, torch.full_like(nb_cid, ncell))

    xp = torch.cat([x, torch.zeros(1, 3, dtype=x.dtype, device=dev)])
    cut2 = cutoff * cutoff
    idx_parts, count_parts = [], []
    for i0 in range(0, n, row_chunk):
        ids = torch.arange(i0, min(i0 + row_chunk, n), device=dev)
        cand = grid[nb_cid[cid[ids]]].reshape(ids.shape[0], 27 * cc)
        rsq = torch.zeros(cand.shape, dtype=x.dtype, device=dev)
        for d in range(3):
            dd = xp[ids, d][:, None] - xp[cand, d]
            if pbc[d]:
                dd = dd - box[d] * torch.round(dd / box[d])
            rsq = rsq + dd * dd
        within = (cand < n) & (cand != ids[:, None]) \
            & (rsq < cut2) & (rsq > 1.0e-12)
        idx_c, cnt_c = _compact_rows(within, cand, capacity, n)
        idx_parts.append(idx_c)
        count_parts.append(cnt_c)
    idx = torch.cat(idx_parts)
    counts = torch.cat(count_parts)
    dims_stale = ((box / dvec.to(box.dtype) < cutoff) & pbc_t).any()
    overflow = (counts > capacity).any() | cell_overflow | dims_stale
    return NeighborList(idx, overflow, x)


def max_displacement_sq(ref_x, x, box, pbc=(True, True, True)):
    """Largest squared (minimum-image) displacement of x from ref_x, as a
    0-d tensor on the device. The JAX function takes the NeighborList; here
    the reference positions are passed directly, so the same call serves
    the skin list (nbrs.ref_x) and the short list (short.ref_x)."""
    dd = min_image(x - ref_x, box, pbc)
    return (dd * dd).sum(dim=1).max()


def estimate_capacity(box, cutoff, n, headroom=1.25, minimum=8):
    """Padded capacity estimate from mean density (rounded up to 8)."""
    vol = float(box[0]) * float(box[1]) * float(box[2])
    mean = n / vol * (4.0 / 3.0) * math.pi * cutoff ** 3
    k = int(mean * headroom) + 1
    return max(minimum, -(-k // 8) * 8)
