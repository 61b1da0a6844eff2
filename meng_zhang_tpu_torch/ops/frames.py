"""Device-frame evaluations of the sharded drivers (parallel/domain.py),
shared by both fused evaluators (ops/fused_annp.py, ops/fused_ni.py).

`FrameOps` ports the frame half of `PairTableOps`
(meng_zhang_tpu/ops/pallas_annp.py): `compact_short_frame` (:749),
`energy_forces_frame_short` (:812) and `energy_forces_frame` (:1087). A
frame is a shard's position table x_src [M, 3] (its atoms and the halos
around them) whose centre rows t = 0 .. cc - 1 sit at frame rows off + t;
rows index the frame, sentinel M. Every frame method also has a batched
form over a leading shard axis ([D, ...] tensors): `frame_tables` stacks
the D frames into one [D*M] table and one [D*R, K] set of rows, so that
each kernel launches once for all shards (`evaluate_frames`).

Delivery adds a lane's Fj to its row (-Fj) and, only where the partner is a
centre row of the same frame, to that row (+Fj): a lane whose partner lies
in the halo delivers nothing, because the partner's force belongs to its
owning shard (the JAX package's self-keyed delivery band). The two-sort
delivery keys (`akey`) and the reverse slots are TPU workarounds and are
not ported.
"""
from __future__ import annotations

import torch

from . import fused_annp as fa


def frame_tables(idx, n_src, off, cc):
    """Stack D frames' rows into one table. idx [D, R, K]: frame indices
    into each frame's [n_src] table, sentinel n_src; row t of a frame is
    its centre row t for t < cc (R >= cc; rows past cc are padding).

    Returns (sidx [D*R, K] into the stacked [D*n_src] table, sentinel
    D*n_src; ctr [D*R, K]: the stacked row d*R + (idx - off) of a partner
    that is a centre row of frame d, else -1)."""
    d, r, k = idx.shape
    base = torch.arange(d, device=idx.device).view(d, 1, 1)
    real = idx < n_src
    sidx = torch.where(real, idx + base * n_src, d * n_src)
    t = idx - off
    ctr = torch.where(real & (t >= 0) & (t < cc), t + base * r, -1)
    return sidx.reshape(d * r, k), ctr.reshape(d * r, k)


def frame_planes(xc, x_src, box, sidx, pbc):
    """dx planes [D*R, K] of the stacked centre rows xc [D, R, 3] against
    the stacked frames x_src [D, M, 3] (sidx from frame_tables)."""
    xf = xc.reshape(-1, 3)
    return fa.pair_dx_planes(xf, box, sidx, pbc, x_ext=x_src.reshape(-1, 3))


def compact_frames(x_src, box, idx, off, cc, rc, ks, pbc):
    """Each centre row's skin entries idx [D, cc, K] within rc, in the
    skin row's order (ascending frame indices on slabs, ascending atom ids
    on the 2-D and 3-D grids), padded with M to ks columns: (sidx [D, cc,
    ks], counts [D, cc] of the entries within rc)."""
    d, m = x_src.shape[:2]
    k = idx.shape[2]
    sidx_f, _ = frame_tables(idx, m, off, cc)
    dx, dy, dz = frame_planes(x_src[:, off:off + cc], x_src, box, sidx_f, pbc)
    rsq = dx * dx + dy * dy + dz * dz
    # filler lanes lie at 2*box + 10 per axis, beyond any rc
    mask = (rsq < rc * rc) & (rsq > 1.0e-12)
    # the kept entries first, in their order (a stable partition)
    keep = torch.sort((~mask).to(torch.int32), dim=1, stable=True).indices
    key = torch.where(torch.gather(mask, 1, keep),
                      torch.gather(idx.reshape(-1, k), 1, keep), m)[:, :ks]
    if key.shape[1] < ks:
        key = torch.nn.functional.pad(key, (0, ks - key.shape[1]), value=m)
    return key.view(d, cc, ks), mask.sum(dim=1).view(d, cc)


def evaluate_frames(eval_fj, xc, x_src, box, idx, off, cc, pbc,
                    want_virial=True, vslice=None, centre_lanes=False):
    """One evaluation of D frames at once: xc [D, R, 3] centre rows (R >=
    cc), x_src [D, M, 3] frames, idx [D, R, K] frame indices (sentinel M).
    Gathers one [D*R, K] set of dx planes, runs eval_fj once, and delivers
    each lane's Fj to its row (-Fj) and, where the partner is a centre row
    of the same frame, to that row (+Fj).

    Returns (eat [D, cc] shift-free, forces [D, cc, 3]) and, with
    want_virial, W [3, 3] = -sum dx (x) Fj over the rows [lo, hi) of every
    frame (vslice, default all R), symmetrised: with vslice each shard's
    local rows, every pair is counted once over the shards (the
    +-1/2-per-pair convention). centre_lanes keeps only lanes whose
    partner is a centre row in W (`energy_forces_frame`'s mask); lanes
    beyond the cutoff and fillers carry Fj = 0 exactly either way. Only
    rows whose partners are all centre rows (every local row, by the
    drivers' coverage proof) get physical forces."""
    d, r = xc.shape[:2]
    sidx, ctr = frame_tables(idx, x_src.shape[1], off, cc)
    dd = frame_planes(xc, x_src, box, sidx, pbc)
    eat, fj = eval_fj(*dd, None)
    fjs = torch.stack(fj, dim=-1)                          # [D*R, K, 3]
    nr = d * r
    own = torch.arange(nr, device=xc.device)[:, None]
    # fillers (Fj = 0) go to their own row; real lanes whose partner is
    # not a centre row go to a discard row of their own, nr + row, so
    # that no single address takes their atomic adds
    target = torch.where(ctr >= 0, ctr,
                         torch.where(sidx < d * x_src.shape[1], own + nr,
                                     own))
    forces = torch.cat([-fjs.sum(dim=1), fjs.new_zeros(nr, 3)])
    forces.index_add_(0, target.reshape(-1), fjs.reshape(-1, 3))
    out = (eat.view(d, r)[:, :cc], forces[:nr].view(d, r, 3)[:, :cc])
    if not want_virial:
        return out
    lo, hi = (0, r) if vslice is None else vslice
    k = sidx.shape[1]
    m = (ctr.view(d, r, k)[:, lo:hi] >= 0).to(xc.dtype) if centre_lanes \
        else None

    def part(a):
        a = a.view(d, r, k)[:, lo:hi]
        return a if m is None else a * m

    w = torch.stack([torch.stack([-(part(da) * fb.view(d, r, k)[:, lo:hi])
                                  .sum() for fb in fj]) for da in dd])
    return out + (0.5 * (w + w.T),)


class FrameOps:
    """The frame methods of both fused evaluators (counterpart of the frame
    half of `PairTableOps`). Needs `k_short`, `short_delta`, `short_rc`,
    `pbc` and `_eval_fj`. Single-frame methods take [M, 3] / [R, K]
    tensors; the `*_frames` methods the same with a leading shard axis."""

    def compact_short_frames(self, x_src, box, idx, off, cc):
        """The short rows of D frames at short_rc + short_delta: (sidx [D,
        cc, Ks] frame indices in the skin rows' order, sentinel M; overflow
        [D] bool).

        Ks = min(k_short, K). A frame overflows when a row keeps more than
        Ks entries, or when its centre rows' kept pairs are not symmetric
        (some centre row is the partner of more or fewer centre rows than
        it lists): the JAX function's band check, which catches a skin
        list that lost a pair."""
        d, m = x_src.shape[:2]
        ks = min(self.k_short, idx.shape[2])
        sidx, counts = compact_frames(x_src, box, idx, off, cc,
                                      self.short_rc + self.short_delta, ks,
                                      self.pbc)
        t = sidx - off
        in_ctr = (sidx < m) & (t >= 0) & (t < cc)
        base = torch.arange(d, device=idx.device).view(d, 1, 1) * cc
        tgt = torch.where(in_ctr, t + base, d * cc).reshape(-1)
        in_deg = torch.bincount(tgt, minlength=d * cc + 1)[:-1].view(d, cc)
        out_deg = in_ctr.sum(dim=2)
        overflow = (counts > ks).any(dim=1) | (in_deg != out_deg).any(dim=1)
        return sidx, overflow

    def compact_short_frame(self, x_src, box, idx, off, cc):
        """One frame: x_src [M, 3], idx [cc, K] skin rows of the centre rows
        (frame indices). Returns (sidx [cc, Ks], overflow)."""
        sidx, ovf = self.compact_short_frames(x_src[None], box, idx[None],
                                              off, cc)
        return sidx[0], ovf[0]

    def energy_forces_frames_short(self, xc_pad, x_src, box, sidx, cc,
                                   want_virial=False, vslice=None, off=None):
        """Per-step evaluation of D frames against their short rows sidx
        [D, P, Ks] (P >= cc, xc_pad [D, P, 3] the centre rows): (eat [D,
        cc] shift-free, forces [D, cc, 3][, W]); W over rows [lo, hi) of
        every frame, all real lanes. off: the first centre row's frame
        index, default (M - cc) / 2 (the 1-D slab's halo_b - bc)."""
        off = (x_src.shape[1] - cc) // 2 if off is None else off
        return evaluate_frames(self._eval_fj, xc_pad, x_src, box, sidx, off,
                               cc, self.pbc, want_virial, vslice)

    def energy_forces_frame_short(self, xc_pad, x_src, box, sidx, cc,
                                  want_virial=False, vslice=None, off=None):
        """One frame of energy_forces_frames_short: (eat [cc], forces
        [cc, 3][, W])."""
        out = self.energy_forces_frames_short(
            xc_pad[None], x_src[None], box, sidx[None], cc, want_virial,
            vslice, off)
        return (out[0][0], out[1][0]) + out[2:]

    def energy_forces_frames(self, xc, x_src, box, idx, off,
                             want_virial=False, vslice=None):
        """D frames from their skin rows idx [D, cc, K] at full width (no
        compaction; K at most MAX_K on the cos pair, any K on the harmonic
        and ni kernels, which take wider rows in tiles): (eat [D, cc]
        shift-free, forces [D, cc, 3][, W over lanes whose partner is a
        centre row])."""
        return evaluate_frames(self._eval_fj, xc, x_src, box, idx, off,
                               idx.shape[1], self.pbc, want_virial, vslice,
                               centre_lanes=True)

    def energy_forces_frame(self, xc, x_src, box, idx, off,
                            want_virial=False, vslice=None):
        """One frame of energy_forces_frames; off is the JAX method's `bc`
        argument (the centre rows' offset in the frame)."""
        out = self.energy_forces_frames(xc[None], x_src[None], box,
                                        idx[None], off, want_virial, vslice)
        return (out[0][0], out[1][0]) + out[2:]
