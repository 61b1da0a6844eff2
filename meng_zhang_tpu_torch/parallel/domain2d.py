"""2-D (x, y) spatial domain decomposition over a shard mesh.

Counterpart of meng_zhang_tpu/parallel/domain2d.py: `plan_park_sites`
(:85), `Plan2D` (:113), `Shard2DConfig` (:134) and `ShardedMD2D` (:142).
The staged-round machinery that the 2-D and 3-D drivers share lives here
in `StagedMD`; parallel/domain3d.py adds the third round. On a near-cubic
box at 8+ devices, 1-D slabs pay a halo that approaches the slab width /
rlist ratio; a grid of columns (or bricks) cuts the ghost volume.

  * Atoms are sorted by x into Dx equal-count slabs, then by y into Dy
    equal-count blocks a slab (then by z into Dz bricks a block, 3-D):
    shard (sx, sy[, sz]), flat index in row-major order, owns C rows. The
    boundaries are kept as box fractions, so NPT moves them with the box.
  * Ghosts come in staged rounds (the LAMMPS comm order): round 1 ships
    x-face rows to the two x-neighbours, round 2 y-face rows of the round-1
    frame [own + x-ghosts] to the two y-neighbours (corners ride along),
    round 3 (3-D) z-face rows of the round-2 frame. Every round is two
    `ShardMesh.ppermute` calls, the JAX `lax.ppermute` pairs of `_perm`.
    The halos keep the positions as sent, and the evaluation takes each
    pair's minimum image, as on one device, so the two shards that hold a
    pair compute its displacement as exact negatives; the periodic seam's
    -L / +L shift (first / last shard along that axis) makes the frame
    contiguous only where a rebuild needs it, for the cell build (the JAX
    drivers ship the shifted positions and evaluate on them). A block on
    a periodic axis of up to three blocks must span the w_need band of
    its neighbour's face: the plan refuses a narrower one, which the JAX
    plan accepts while the atoms beyond it go missing.
  * The send sets are index tables carried in the state (the plan),
    recomputed from the current positions at every rebuild with a window
    w_send = 2 rlist + skin/2 a face; only their capacities are planned on
    the host at `distribute` (25 % headroom). A rebuild latches
    OVF_COVERAGE when an atom now within w_need = 2 rlist of a face was not
    in the ending epoch's send set (the retroactive check, gated by
    plan.cov, which distribute and migrate clear) or when a table
    overflows; OVF_FRAME when an own atom left its rectangle by more than
    the static containment margin (axes with devices two steps apart) or
    a frame row left the frame box.
  * A -1 slot of a send table ships the sender's row 0, so pad rows of the
    halos hold a real atom's position: the build parks them at the park
    sites of `plan_park_sites` (> rlist from every real atom, at most half
    a cell's capacity a site), so they are in no neighbor row, and at
    evaluation they are centres with empty rows whose energy is not
    summed.
  * Every frame row is a centre (off 0, cc = the frame's rows, the own
    rows first): ghosts within rlist of an own row have complete rows by
    the coverage check, so the own rows' forces are exact. The skin list
    idx [D, rows, K] indexes the frame, sentinel `_frame_rows()`; each
    row lists its partners by ascending atom id (the JAX build's rows
    ascend by frame row), so both shards that evaluate a pair sum the
    same rows in the same order and its Fj agrees to the bit: the f32
    forces conserve momentum to rounding, as on one device.
  * Migration (cfg.migrate_b > 0) runs `domain.migrate_round` along x,
    then y (then z): rows re-sorted by that axis before each round. The
    halos and the plan are left to the rebuild that run() makes next.

The integrator, thermostat, barostat, thermo, `run`, `gather_positions` and
`redistribute` are ShardedMD's: the layout lives behind its hooks
(`_frame`, `_short_geom`, `_frame_rows`, `_own_rows`,
`_exchange_and_force`, `_rebuild_body`). Each step runs one batched
evaluation of all D frames; a rebuild runs D cell-list builds. Over a
process group every rank plans from the whole scene on the host (the same
numbers on every rank) and holds its L shards' rows: `_grid_np` is the
global grid, `_pos` the local shards' grid positions.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import NamedTuple

import numpy as np
import torch

from ..md import integrate as I
from ..system.neighbors import (build_neighbors_cell, build_neighbors_n2,
                                cell_grid_dims, estimate_capacity)
from .domain import (OVF_COVERAGE, OVF_FRAME, OVF_NEIGHBOR, ShardConfig,
                     ShardedMD, ShardState, _tensor, migrate_round)

AXES = "xyz"


def plan_park_sites(n_rows, w_after_x, wy, wz, rlist, cell_capacity):
    """Static pad-park geometry for a frame of n_rows rows.

    Pads must sit > rlist from every real atom and not overload any cell
    of the frame's build: a strip of park sites beyond the real x-extent,
    pitch rlist + 0.1, row r on site r mod n_sites; pads on one site
    exclude each other through the builds' 1e-12 self-overlap guard, and
    n_sites holds the worst case (every row a pad) at half a cell's
    capacity a site.

    Returns (wx_total, park_xyz [n_rows, 3] float64)."""
    rl = float(rlist) + 0.1
    ny_s = max(1, int(wy // rl))
    nz_s = max(1, int(wz // rl))
    n_sites = -(-n_rows // max(1, cell_capacity // 2))
    nx_s = -(-n_sites // (ny_s * nz_s))
    base_x = w_after_x + rl
    wx_total = base_x + nx_s * rl + rl
    s = np.arange(n_rows) % (nx_s * ny_s * nz_s)
    ix, rem = np.divmod(s, ny_s * nz_s)
    iy, iz = np.divmod(rem, nz_s)
    park = np.stack([base_x + (ix + 0.5) * rl, (iy + 0.5) * rl,
                     (iz + 0.5) * rl], axis=1)
    return wx_total, park


class Plan2D(NamedTuple):
    """The exchange plan, a row a shard (int64 tables, -1 pads).

    sxh/sxl: [D, bx] own-row send tables toward x+1 / x-1;
    syh/syl: [D, by] round-1 frame-row send tables toward y+1 / y-1;
    f1v:     [D, C + 2 bx] round-1 frame-row validity;
    padm:    [D, rows] pad rows of the frame;
    cov:     [D] bool: the tables describe the current rows, so the
             retroactive coverage check at the next rebuild applies."""
    sxh: torch.Tensor
    sxl: torch.Tensor
    syh: torch.Tensor
    syl: torch.Tensor
    f1v: torch.Tensor
    padm: torch.Tensor
    cov: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Shard2DConfig(ShardConfig):
    """ShardConfig plus the (Dx, Dy) mesh shape. halo_b is a 1-D option and
    stays None; the ghost-block capacities come from the scene at
    distribute. migrate_b enables the in-run migration."""
    mesh_shape: tuple = (2, 2)


_SEND = ("sxh", "sxl", "syh", "syl", "szh", "szl")
_VALID = ("f1v", "f2v")


def grid_order(xh, shape):
    """The rows of xh [n, 3] (numpy) in (slab, block[, brick]) order: a
    stable sort by x, then by y within each of the shape[0] equal-count
    slabs (then by z within each block), as `distribute` deals them."""
    n = len(xh)
    order = np.argsort(xh[:, 0], kind="stable")
    for a in range(1, len(shape)):
        g = n // int(np.prod(shape[:a]))
        for o in range(0, n, g):
            sl = order[o:o + g]
            order[o:o + g] = sl[np.argsort(xh[sl, a], kind="stable")]
    return order


def _shift_col(t, a, s):
    """t [D, R, 3] with s [D] added to column a."""
    cols = list(t.unbind(-1))
    cols[a] = cols[a] + s[:, None]
    return torch.stack(cols, dim=-1)


class StagedMD(ShardedMD):
    """The staged-round grid driver of ShardedMD2D and ShardedMD3D over
    len(mesh_shape) split axes; subclasses name the plan type
    (`plan_type`)."""

    def __init__(self, model, masses_scalar, box, cfg, mesh=None,
                 device="cuda"):
        shape = tuple(int(s) for s in cfg.mesh_shape)
        if int(np.prod(shape)) != cfg.n_devices:
            raise ValueError("mesh_shape must multiply to n_devices")
        if cfg.halo_b is not None:
            raise ValueError("halo_b is a 1-D slab option")
        super().__init__(model, masses_scalar, box, cfg, mesh=mesh,
                         device=device)
        # the halos keep their positions as sent: the evaluation needs the
        # minimum image along every periodic axis
        mcfg = getattr(self.model, "mcfg", None) or self.model.pk.cfg
        if any(p and not q for p, q in zip(cfg.pbc, mcfg.pbc)):
            raise ValueError(f"the model's pbc {tuple(mcfg.pbc)} must be "
                             f"periodic wherever the box's {cfg.pbc} is")
        self.shape = shape
        self.k = len(shape)
        grid = np.stack(np.unravel_index(np.arange(cfg.n_devices), shape),
                        axis=1)
        self._grid_np = grid                                    # [D, k]
        self._pos = torch.as_tensor(self.mesh.local(grid),
                                    device=self.device)         # [L, k]
        self._perms = {(a, s): self._perm(a, s) for a in range(self.k)
                       for s in (1, -1)}

    # ================= planning (host, at distribute) =================
    def _plan_grid(self, xs: np.ndarray, box: np.ndarray):
        """Boundaries, send-table capacities, the frame box and grid and the
        park sites from the initial coordinates xs [n, 3] in (slab, block,
        brick) order (JAX `_plan2d`, domain2d.py:158, and `_plan3d`,
        domain3d.py:92: the same numbers)."""
        cfg = self.cfg
        shape, k, C, n, D = self.shape, self.k, cfg.c_loc, self.n, \
            cfg.n_devices
        lens = [float(b) for b in box]
        rlist = cfg.rlist
        self.w_need = 2.0 * rlist
        self.w_send = self.w_need + 0.5 * cfg.skin
        self.m_drift = 0.5 * cfg.skin

        # ---- nominal boundaries (count medians) of every level ----
        bounds = []
        for a in range(k):
            g_par = n // int(np.prod(shape[:a]))     # rows of a parent block
            g = g_par // shape[a]
            b = np.empty(shape[:a] + (shape[a] + 1,))
            for p in np.ndindex(*shape[:a]):
                o = int(np.ravel_multi_index(p, shape[:a])) * g_par \
                    if a else 0
                c = np.sort(xs[o:o + g_par, a])
                for t in range(1, shape[a]):
                    b[p + (t,)] = 0.5 * (c[t * g - 1] + c[t * g])
                if cfg.pbc[a]:
                    seam = 0.5 * (c[-1] + c[0] + lens[a])
                    b[p + (0,)], b[p + (shape[a],)] = seam - lens[a], seam
                else:
                    b[p + (0,)] = c[0] - 1e-6
                    b[p + (shape[a],)] = c[-1] + 1e-6
            bounds.append(b)
        self.b_frac = [b / lens[a] for a, b in enumerate(bounds)]
        for a in range(k):
            setattr(self, f"{AXES[a]}b_frac", self.b_frac[a])

        # ---- static separation: shards two grid steps apart stay out of
        # the w_need band while every own atom stays within its rectangle
        # plus m_contain (checked at every rebuild); delta is the largest
        # boundary misalignment between adjacent parent blocks ----
        self.m_contain = []
        for a in range(k):
            b = bounds[a]
            min_w = float(np.diff(b, axis=-1).min())
            delta = 0.0
            if shape[a] > 1:
                for p in np.ndindex(*shape[:a]):
                    for off in itertools.product((-1, 0, 1), repeat=a):
                        q = [p[i] + o for i, o in enumerate(off)]
                        q = [qi % shape[i] if cfg.pbc[i] else qi
                             for i, qi in enumerate(q)]
                        if not any(off) or not all(
                                0 <= qi < shape[i] for i, qi in enumerate(q)):
                            continue
                        delta = max(delta, float(np.max(np.abs(
                            b[p][1:shape[a]] - b[tuple(q)][1:shape[a]]))))
            far = shape[a] >= 4 or (shape[a] == 3 and not cfg.pbc[a])
            m = min_w - self.w_need - delta
            if far and m <= self.m_drift:
                raise ValueError(
                    f"{AXES[a]}-block width {min_w:.2f} (boundary "
                    f"misalignment {delta:.2f}) leaves no drift margin over "
                    f"w_need {self.w_need:.2f}: too many {AXES[a]}-blocks "
                    "for this box")
            if cfg.pbc[a] and not far and m <= 0.0:
                # on a periodic ring of 1-3 blocks the band of a face
                # reaches past the next block into a block that sends
                # nothing there (the JAX plan accepts this and evaluates
                # with those atoms missing)
                raise ValueError(
                    f"{AXES[a]}-block width {min_w:.2f} (boundary "
                    f"misalignment {delta:.2f}) is under w_need "
                    f"{self.w_need:.2f}: the next block cannot hold a "
                    f"face's band; use fewer {AXES[a]}-blocks or a larger "
                    "box")
            self.m_contain.append(m if far else None)
            setattr(self, f"m_contain_{AXES[a]}", self.m_contain[-1])

        # ---- send-table capacities from the initial membership, round by
        # round over the frames the rounds before assemble ----
        grid = self._grid_np
        f = xs.reshape(D, C, 3)
        valid = np.ones((D, C), bool)
        self.caps = []
        for a in range(k):
            p_idx = tuple(grid[:, :a].T)
            lo_b = bounds[a][p_idx + (grid[:, a],)]
            hi_b = bounds[a][p_idx + (grid[:, a] + 1,)]
            pos = grid[:, a]
            need_hi = cfg.pbc[a] | (pos < shape[a] - 1)
            need_lo = cfg.pbc[a] | (pos > 0)
            mem_hi = need_hi[:, None] & valid & (
                f[..., a] > hi_b[:, None] - self.w_send)
            mem_lo = need_lo[:, None] & valid & (
                f[..., a] < lo_b[:, None] + self.w_send)
            rows = f.shape[1]
            cap = max(int(mem_hi.sum(1).max()), int(mem_lo.sum(1).max()))
            cap = min(max(8, -(-int(cap * 1.25 + 2) // 8) * 8), rows)
            self.caps.append(cap)
            if a == k - 1:
                break
            nf = np.zeros((D, rows + 2 * cap, 3))
            nv = np.zeros((D, rows + 2 * cap), bool)
            nf[:, :rows], nv[:, :rows] = f, valid
            for d in range(D):
                for side, (step, mem) in enumerate(((-1, mem_hi),
                                                    (1, mem_lo))):
                    if not cfg.pbc[a] and (
                            (side == 0 and pos[d] == 0)
                            or (side == 1 and pos[d] == shape[a] - 1)):
                        continue                 # the wrap block: invalid
                    src = dict(self._perms[(a, step)])[d]
                    idx = np.nonzero(mem[src])[0]
                    o = rows + side * cap
                    nf[d, o:o + len(idx)] = f[src, idx]
                    nv[d, o:o + len(idx)] = True
            f, valid = nf, nv
        for a in range(k):
            setattr(self, f"b{AXES[a]}", self.caps[a])
        self.n_frame = C + 2 * sum(self.caps)

        # ---- frame box and grid, park sites in the x-gutter: the window
        # is the send window plus a skin of drift a side ----
        self.w_frame = self.w_send + cfg.skin
        widths = [float(np.diff(b, axis=-1).max()) + 2 * self.w_frame
                  for b in bounds]
        wz = widths[2] if k == 3 else lens[2]
        wx, park = plan_park_sites(self.n_frame, widths[0], widths[1], wz,
                                   rlist, cfg.cell_capacity)
        self.park = park
        self.wx_frame, self.wy_frame = wx, widths[1]
        if k == 3:
            self.wz_frame = wz
        # 2-D: the frame's z is the box's, which NPT may shrink
        shrink = 0.92 if (k == 2 and cfg.ensemble == "npt") else 1.0
        dims = cell_grid_dims((wx, widths[1], wz * shrink), rlist)
        method = cfg.nbr_method
        if method == "auto":
            method = "cell" if (min(dims) >= 3
                                and self.n_frame > 2048) else "n2"
        self.frame_dims = dims if method == "cell" else None
        if cfg.capacity is None:
            self.cfg = dataclasses.replace(
                cfg, capacity=estimate_capacity(box, rlist, n))

    # layout hooks: every frame row is a centre, the own rows first
    def _short_geom(self):
        return 0, self.n_frame

    def _frame_rows(self):
        return self.n_frame

    def _own_rows(self):
        return 0, self.cfg.c_loc

    # ================= distribution =================
    def distribute(self, x, v=None, box=None):
        """Level-by-level stable sort (x, then y within a slab, then z
        within a block) into the shards, the plan, the first rebuild and
        forces. Returns (ShardState, order): order maps a row (flattened
        [D, C]) to its original atom."""
        cfg = self.cfg
        dev = self.device
        x = _tensor(x, dev)
        n = x.shape[0]
        if n != self.n:
            raise ValueError(f"need n == n_devices*c_loc ({self.n}), got {n}")
        box_np = self.box0 if box is None else np.asarray(
            torch.as_tensor(box).cpu(), np.float64)
        xh = x.double().cpu().numpy()
        order = grid_order(xh, self.shape)
        self._plan_grid(xh[order], box_np)
        self._constants(x.dtype)
        cfg = self.cfg

        D, C, dtype = cfg.n_devices, cfg.c_loc, x.dtype
        mesh = self.mesh
        L = mesh.n_local
        order = torch.as_tensor(order, device=dev)
        xs = x[order]
        vs = _tensor(v, dev, dtype)[order] if v is not None \
            else torch.zeros_like(xs)
        x_l = mesh.local(xs.reshape(D, C, 3))
        tables = {name: torch.full((L, self.caps[i // 2]), -1,
                                   dtype=torch.int64, device=dev)
                  for i, name in enumerate(_SEND[:2 * self.k])}
        valids = {name: torch.zeros((L, C + 2 * sum(self.caps[:i + 1])),
                                    dtype=torch.bool, device=dev)
                  for i, name in enumerate(_VALID[:self.k - 1])}
        plan0 = self.plan_type(
            **tables, **valids,
            padm=torch.ones((L, self.n_frame), dtype=torch.bool, device=dev),
            cov=torch.zeros(L, dtype=torch.bool, device=dev))
        hshape = (L, sum(self.caps), 3)
        st = ShardState(
            x_loc=x_l, v_loc=mesh.local(vs.reshape(D, C, 3)),
            f_loc=torch.zeros_like(x_l), gid=mesh.local(order.reshape(D, C)),
            halo_l=torch.zeros(hshape, dtype=dtype, device=dev),
            halo_r=torch.zeros(hshape, dtype=dtype, device=dev),
            idx=torch.zeros((L, self.n_frame, cfg.capacity),
                            dtype=torch.int64, device=dev),
            ref_loc=x_l, pe=torch.zeros(L, dtype=dtype, device=dev),
            box=_tensor(box_np, dev, dtype),
            virial=torch.zeros((3, 3), dtype=dtype, device=dev),
            nhc=I.NHCState.zeros(cfg.nhc_len, dtype, dev),
            v_eps=torch.zeros(3, dtype=dtype, device=dev),
            baro_nhc=I.NHCState.zeros(cfg.pchain, dtype, dev),
            step=torch.zeros((), dtype=torch.int64, device=dev),
            stale=torch.zeros(L, dtype=torch.bool, device=dev),
            unsafe=torch.zeros(L, dtype=torch.bool, device=dev),
            overflow=torch.zeros(L, dtype=torch.int32, device=dev),
            plan=plan0)
        st = self.rebuild(st)           # replans, exchanges, builds
        st = self.refill_forces(st)
        return st, order

    # ================= the staged exchange =================
    def _perm(self, axis, step):
        """The JAX ppermute pairs (src, dst) of a +-1 ring shift along one
        grid axis (flat shards in row-major order)."""
        out = []
        for d in range(self.cfg.n_devices):
            c = list(np.unravel_index(d, self.shape))
            c[axis] = (c[axis] + step) % self.shape[axis]
            out.append((d, int(np.ravel_multi_index(c, self.shape))))
        return out

    def _bounds(self, box, dtype):
        """(lo, hi) [L, k]: every local shard's rectangle at the current
        box."""
        lo, hi = [], []
        for a, frac in enumerate(self.b_frac):
            b = torch.as_tensor(frac, dtype=dtype, device=self.device) \
                * box[a]
            p = tuple(self._pos[:, i] for i in range(a))
            lo.append(b[p + (self._pos[:, a],)])
            hi.append(b[p + (self._pos[:, a] + 1,)])
        return torch.stack(lo, dim=1), torch.stack(hi, dim=1)

    def _tables(self, plan):
        """[(hi table, lo table)] of every round."""
        return [(getattr(plan, _SEND[2 * a]), getattr(plan, _SEND[2 * a + 1]))
                for a in range(self.k)]

    def _ship(self, f, table, a, step, box=None):
        """The rows `table` [D, b] (a -1 slot sends row 0) of every shard's
        f [D, R, 3] to its neighbour at `step` along axis a; with `box`,
        the seam shard shifts the block it receives by -step L along a."""
        send = torch.gather(f, 1, table.clamp(min=0)[..., None].expand(
            -1, -1, 3))
        recv = self.mesh.ppermute(send, self._perms[(a, step)])
        if box is not None and self.cfg.pbc[a]:
            edge = 0 if step > 0 else self.shape[a] - 1
            s = torch.where(self._pos[:, a] == edge, -step * box[a],
                            torch.zeros_like(box[a]))
            recv = _shift_col(recv, a, s)
        return recv

    def _exchange(self, plan, x):
        """The staged rounds from the plan: (halo_l, halo_r), halo_l the
        blocks received from below ([xg_l | yg_d | zg_b]), halo_r those
        from above, at their positions as sent (no seam shift)."""
        f, lows, highs = x, [], []
        for a, (t_hi, t_lo) in enumerate(self._tables(plan)):
            lows.append(self._ship(f, t_hi, a, 1))
            highs.append(self._ship(f, t_lo, a, -1))
            if a < self.k - 1:
                f = torch.cat([f, lows[-1], highs[-1]], dim=1)
        return torch.cat(lows, dim=1), torch.cat(highs, dim=1)

    def exchange(self, st: ShardState) -> ShardState:
        """Refresh the halos from the current own positions."""
        hl, hr = self._exchange(st.plan, st.x_loc)
        return st._replace(halo_l=hl, halo_r=hr)

    def _frame(self, x, hl, hr):
        """[own | x-blocks lo, hi | y-blocks lo, hi (| z-blocks lo, hi)]."""
        parts, o = [x], 0
        for cap in self.caps:
            parts += [hl[:, o:o + cap], hr[:, o:o + cap]]
            o += cap
        return torch.cat(parts, dim=1)

    def _exchange_and_force(self, st: ShardState, x, box):
        hl, hr = self._exchange(st.plan, x)
        pe, f, w = self._force_local(x, hl, hr, box, st.idx, short=st.short)
        return {"halo_l": hl, "halo_r": hr}, pe, f, w

    # ---------- in-graph replanning ----------
    @staticmethod
    def _pack_rows(mem, cap):
        """(indices [D, cap] of each row's True entries ascending, -1 pads;
        overflow [D]): a stable sort of the member flags."""
        key = (~mem).to(torch.int32)
        srt = torch.sort(key, dim=1, stable=True).indices[:, :cap]
        cnt = mem.sum(dim=1)
        lane = torch.arange(cap, device=mem.device)
        return (torch.where(lane[None, :] < cnt[:, None], srt, -1),
                cnt > cap)

    @staticmethod
    def _mark(idx, rows):
        """Membership [D, rows] from an index table [D, b] (-1 pads)."""
        m = torch.zeros((idx.shape[0], rows + 1), dtype=torch.bool,
                        device=idx.device)
        m.scatter_(1, torch.where(idx >= 0, idx, rows), True)
        return m[:, :rows]

    def _replan_exchange(self, st: ShardState, x, box, lo, hi):
        """New send tables from the current positions, the staged exchange
        with validity, the new plan, and the retroactive coverage check of
        the ending epoch's plan. Returns (plan, halo_l, halo_r as sent,
        the frame with the seam shifts, the frame rows' atom ids [D,
        rows], bad_cov [D], plan_ovf [D]).

        Round a reads column a only, which no earlier round shifts, so the
        halos as sent serve the check and the membership; the shifts make
        the frame contiguous for the build."""
        cfg = self.cfg
        L, C = self.mesh.n_local, cfg.c_loc
        need = [(cfg.pbc[a] | (self._pos[:, a] < self.shape[a] - 1),
                 cfg.pbc[a] | (self._pos[:, a] > 0)) for a in range(self.k)]

        # (a) retroactive coverage: every row of a round's input frame now
        # within w_need of the face was in that face's old send set
        old = st.plan
        bad = torch.zeros(L, dtype=torch.bool, device=x.device)
        f, o = x, 0
        for a, (t_hi, t_lo) in enumerate(self._tables(old)):
            if a:
                cap = self.caps[a - 1]
                f = torch.cat([f, st.halo_l[:, o:o + cap],
                               st.halo_r[:, o:o + cap]], dim=1)
                o += cap
            col, rows = f[..., a], f.shape[1]
            m_hi = (col > hi[:, a, None] - self.w_need) \
                & ~self._mark(t_hi, rows)
            m_lo = (col < lo[:, a, None] + self.w_need) \
                & ~self._mark(t_lo, rows)
            if a:
                v = getattr(old, _VALID[a - 1])
                m_hi, m_lo = m_hi & v, m_lo & v
            bad = bad | (need[a][0] & m_hi.any(dim=1)) \
                | (need[a][1] & m_lo.any(dim=1))
        bad = bad & old.cov

        # the rounds, replanned: f the frame with the seam shifts (as the
        # JAX drivers ship it), f_raw and lows / highs as sent, g the rows'
        # atom ids
        f = f_raw = x
        g = st.gid
        fv = torch.ones((L, C), dtype=torch.bool, device=x.device)
        plan_ovf = torch.zeros(L, dtype=torch.bool, device=x.device)
        fields, lows, highs = {}, [], []
        for a in range(self.k):
            col = f[..., a]
            mem_hi = need[a][0][:, None] & fv & (
                col > hi[:, a, None] - self.w_send)
            mem_lo = need[a][1][:, None] & fv & (
                col < lo[:, a, None] + self.w_send)
            t_hi, ov_hi = self._pack_rows(mem_hi, self.caps[a])
            t_lo, ov_lo = self._pack_rows(mem_lo, self.caps[a])
            plan_ovf = plan_ovf | ov_hi | ov_lo
            fields[_SEND[2 * a]], fields[_SEND[2 * a + 1]] = t_hi, t_lo
            lows.append(self._ship(f_raw, t_hi, a, 1))
            highs.append(self._ship(f_raw, t_lo, a, -1))
            v_lo = self.mesh.ppermute(t_hi >= 0, self._perms[(a, 1)])
            v_hi = self.mesh.ppermute(t_lo >= 0, self._perms[(a, -1)])
            f = torch.cat([f, self._ship(f, t_hi, a, 1, box),
                           self._ship(f, t_lo, a, -1, box)], dim=1)
            f_raw = torch.cat([f_raw, lows[-1], highs[-1]], dim=1)
            g = torch.cat([g] + [self.mesh.ppermute(
                torch.gather(g, 1, t.clamp(min=0)), self._perms[(a, step)])
                for t, step in ((t_hi, 1), (t_lo, -1))], dim=1)
            fv = torch.cat([fv, v_lo, v_hi], dim=1)
            if a < self.k - 1:
                fields[_VALID[a]] = fv
        plan = self.plan_type(**fields, padm=~fv,
                              cov=torch.ones(L, dtype=torch.bool,
                                             device=x.device))
        return (plan, torch.cat(lows, dim=1), torch.cat(highs, dim=1), f, g,
                bad, plan_ovf)

    # ---------- rebuild: replan + exchange + per-shard builds ----------
    def _rebuild_body(self, st: ShardState) -> ShardState:
        cfg = self.cfg
        x, box = st.x_loc, st.box
        dtype = x.dtype
        lo, hi = self._bounds(box, dtype)
        plan, hl, hr, x_ext, gid, bad_cov, plan_ovf = self._replan_exchange(
            st, x, box, lo, hi)

        # (b) containment on axes with shards two grid steps apart
        bad_frame = torch.zeros(x.shape[0], dtype=torch.bool,
                                device=x.device)
        for a, m in enumerate(self.m_contain):
            if m is not None:
                bad_frame = bad_frame | (
                    (x[..., a] < lo[:, a, None] - m)
                    | (x[..., a] > hi[:, a, None] + m)).any(dim=1)

        # frame-local coordinates along the split axes; pads parked
        w_lo = lo - self.w_frame
        cols = list(x_ext.unbind(-1))
        for a in range(self.k):
            cols[a] = cols[a] - w_lo[:, a, None]
        xs = torch.stack(cols, dim=-1)
        pad = plan.padm
        park = torch.as_tensor(self.park, dtype=dtype, device=x.device)
        xs = torch.where(pad[..., None], park, xs)
        widths = (self.wx_frame, self.wy_frame) + (
            (self.wz_frame,) if self.k == 3 else ())
        outside = torch.zeros_like(pad)
        for a, w in enumerate(widths):
            outside = outside | (xs[..., a] < 0.0) | (xs[..., a] >= w)
        out_of_frame = (~pad & outside).any(dim=1)

        frame_box = torch.cat([torch.tensor(widths, dtype=dtype,
                                            device=x.device)]
                              + ([box[2:3]] if self.k == 2 else []))
        fpbc = (False, False, cfg.pbc[2] if self.k == 2 else False)
        idxs, nbr_ovf = [], []
        for d in range(x.shape[0]):
            if self.frame_dims is not None:
                nl = build_neighbors_cell(xs[d], frame_box, cfg.rlist,
                                          cfg.capacity, self.frame_dims,
                                          cfg.cell_capacity, pbc=fpbc)
            else:
                nl = build_neighbors_n2(xs[d], frame_box, cfg.rlist,
                                        cfg.capacity, pbc=fpbc)
            idxs.append(nl.idx)
            nbr_ovf.append(nl.overflow)
        # each row's partners in ascending atom id: the two shards that
        # evaluate a pair sum the same rows in the same order, so its Fj
        # agrees to the bit and the forces conserve momentum to rounding
        idx = torch.stack(idxs)
        rows = self.n_frame
        key = torch.gather(gid, 1, idx.clamp(max=rows - 1).flatten(1))
        key = torch.where(idx < rows, key.view_as(idx), self.n)
        idx = torch.gather(idx, 2, torch.sort(key, dim=2).indices)
        zero = torch.zeros_like(st.overflow)
        ovf = (st.overflow
               | torch.where(torch.stack(nbr_ovf), OVF_NEIGHBOR, zero)
               | torch.where(out_of_frame | bad_frame, OVF_FRAME, zero)
               | torch.where(bad_cov | plan_ovf, OVF_COVERAGE, zero))
        return st._replace(idx=idx, ref_loc=x, halo_l=hl,
                           halo_r=hr, plan=plan,
                           stale=torch.zeros_like(st.stale),
                           overflow=ovf.to(torch.int32))

    # ---------- migration, one round an axis ----------
    def migrate(self, st: ShardState) -> ShardState:
        """x, then y (then z) rounds of `migrate_round` (JAX
        `_migrate_body`, domain2d.py:677, domain3d.py:687): before each
        round the rows are stably re-sorted by that axis. The halos and the
        plan are left to the rebuild that run() makes next (plan.cov is
        cleared: rows moved). Tallies self.migrated."""
        cfg = self.cfg
        pay = torch.cat([st.x_loc, st.v_loc, st.f_loc], dim=2)   # [D, C, 9]
        gid = st.gid
        n_in = torch.zeros(self.mesh.n_local, dtype=torch.int64,
                           device=self.device)
        for a in range(self.k):
            perm = torch.argsort(pay[..., a], dim=1, stable=True)
            pay = torch.gather(pay, 1, perm[..., None].expand(-1, -1, 9))
            gid = torch.gather(gid, 1, perm)
            pos = self._pos[:, a]
            pay, gid, n_a = migrate_round(
                pay, gid, a, cfg.migrate_b,
                lambda t, a=a: self.mesh.ppermute(t, self._perms[(a, 1)]),
                lambda t, a=a: self.mesh.ppermute(t, self._perms[(a, -1)]),
                pos == 0, pos == self.shape[a] - 1, cfg.pbc[a], st.box[a])
            n_in = n_in + n_a
        x2 = pay[..., 0:3].contiguous()
        self.migrated += int(self.mesh.psum(n_in))
        return st._replace(
            x_loc=x2, v_loc=pay[..., 3:6].contiguous(),
            f_loc=pay[..., 6:9].contiguous(), gid=gid, ref_loc=x2,
            plan=st.plan._replace(cov=torch.zeros_like(st.plan.cov)))


class ShardedMD2D(StagedMD):
    """Spatially sharded MD driver on a 2-D (x, y) shard grid; the frame's
    z is the box's (periodic when the box is)."""
    plan_type = Plan2D

    def __init__(self, model, masses_scalar, box, cfg: Shard2DConfig,
                 mesh=None, device="cuda"):
        if len(cfg.mesh_shape) != 2:
            raise ValueError("mesh_shape must be (Dx, Dy)")
        if cfg.mesh_shape[1] < 2:
            raise ValueError("use the 1-D ShardedMD for a Dy=1 mesh")
        super().__init__(model, masses_scalar, box, cfg, mesh=mesh,
                         device=device)

    @property
    def c1(self):
        return self.cfg.c_loc + 2 * self.bx

    @property
    def c_ext2d(self):
        return self.n_frame

    @property
    def park2d(self):
        return self.park
