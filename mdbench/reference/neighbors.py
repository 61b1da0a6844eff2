"""The reference's own neighbor search, in plain torch.

Atoms are sorted by cell (cells of edge >= the cutoff; an axis of fewer
than three such cells is one cell), and each queried row gathers the atoms
of its 27 (or fewer) neighbouring cells by the sorted ranges, so no cell
has a capacity and no row a width fixed in advance. Distances take the
minimum image on the periodic axes only; a non-periodic axis is binned
over the atoms' own extent, whatever the box says.
"""
from __future__ import annotations

import itertools

import torch


class Grid:
    """Atoms binned by cell: `order` sorts atoms by cell id, `start[c]` and
    `count[c]` give cell c's range in that order."""

    def __init__(self, x, box, pbc, cutoff):
        dev = x.device
        self.x, self.box, self.pbc, self.cutoff = x, box, tuple(pbc), cutoff
        lo, ext = [], []
        for d in range(3):
            if self.pbc[d]:
                lo.append(0.0)
                ext.append(float(box[d]))
            else:
                lo.append(float(x[:, d].min()))
                ext.append(max(float(x[:, d].max()) - lo[-1], 1e-9))
        self.dims = [max(int(e // cutoff), 1) for e in ext]
        self.dims = [n if n >= 3 else 1 for n in self.dims]
        self.lo = torch.tensor(lo, dtype=x.dtype, device=dev)
        self.edge = torch.tensor([e / n for e, n in zip(ext, self.dims)],
                                 dtype=x.dtype, device=dev)
        self.dvec = torch.tensor(self.dims, device=dev)
        c3 = self.cell3(x)
        cid = self.flat(c3)
        self.order = torch.argsort(cid)
        ncell = self.dims[0] * self.dims[1] * self.dims[2]
        sorted_cid = cid[self.order]
        self.start = torch.searchsorted(sorted_cid,
                                        torch.arange(ncell, device=dev))
        self.count = torch.bincount(cid, minlength=ncell)
        self.widest = int(self.count.max())

    def cell3(self, p):
        s = p - self.lo
        for d in range(3):
            if self.pbc[d]:
                s[:, d] = torch.remainder(s[:, d], self.box[d])
        c = torch.floor(s / self.edge).to(torch.int64)
        return torch.minimum(c.clamp(min=0), self.dvec - 1)

    def flat(self, c3):
        return (c3[:, 0] * self.dims[1] + c3[:, 1]) * self.dims[2] + c3[:, 2]

    def offsets(self):
        steps = [range(-1, 2) if n >= 3 else range(1) for n in self.dims]
        return list(itertools.product(*steps))


def min_image(d, box, pbc):
    for a in range(3):
        if pbc[a]:
            d[..., a] = d[..., a] - box[a] * torch.round(d[..., a] / box[a])
    return d


def partners(grid, rows, cutoff=None):
    """For the atoms `rows` [R]: (idx [R, W], dx [R, W, 3], valid [R, W]),
    each row's partners within `cutoff` (default the grid's) in ascending
    id, dx = x_row - x_partner (minimum image), padded with -1 and
    invalid entries to the widest row W."""
    x, box, pbc = grid.x, grid.box, grid.pbc
    cut = grid.cutoff if cutoff is None else cutoff
    if cut > grid.cutoff:
        raise ValueError("cutoff beyond the grid's cell edge")
    n = x.shape[0]
    dev = x.device
    c3 = grid.cell3(x[rows])
    span = torch.arange(grid.widest, device=dev)
    cands = []
    for off in grid.offsets():
        nb = c3 + torch.tensor(off, device=dev)
        inside = torch.ones(len(rows), dtype=torch.bool, device=dev)
        for d in range(3):
            if pbc[d]:
                nb[:, d] = torch.remainder(nb[:, d], grid.dims[d])
            else:
                inside &= (nb[:, d] >= 0) & (nb[:, d] < grid.dims[d])
        cid = grid.flat(torch.minimum(nb.clamp(min=0), grid.dvec - 1))
        cnt = torch.where(inside, grid.count[cid], 0)
        pos = grid.start[cid][:, None] + span[None, :]
        ok = span[None, :] < cnt[:, None]
        cands.append(torch.where(ok, grid.order[pos.clamp(max=n - 1)], -1))
    cand = torch.cat(cands, dim=1)
    d = min_image(x[rows][:, None, :] - x[cand.clamp(min=0)], box, pbc)
    r2 = (d * d).sum(-1)
    keep = (cand >= 0) & (cand != rows[:, None]) & (r2 < cut * cut)
    key = torch.where(keep, cand, n)
    key, order = torch.sort(key, dim=1)
    width = max(int(keep.sum(1).max()) if len(rows) else 0, 1)
    key, order = key[:, :width], order[:, :width]
    valid = key < n
    d = torch.gather(d, 1, order[..., None].expand(-1, -1, 3))
    return torch.where(valid, key, -1), d, valid


def chunks(n, size, device):
    for i0 in range(0, n, size):
        yield torch.arange(i0, min(i0 + size, n), device=device)
