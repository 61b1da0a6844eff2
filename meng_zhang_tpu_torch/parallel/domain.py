"""The 1-D slab driver: spatial domain decomposition over a shard mesh.

Counterpart of meng_zhang_tpu/parallel/domain.py: `ShardConfig` (:137),
`FrameShort` and `ShardState` (:70-117, without the reverse slots and the
two-sort delivery keys), the `OVF_*` flags (:119-121), the four model
adapters (:190-291) and `ShardedMD` (:294-1057). The three collectives run
on the in-process mesh of parallel/mesh.py: every per-shard tensor carries
the D shards on its leading axis, so one card (or the CPU) runs all of them
and each step's force evaluation is one batched call for every shard (each
kernel launches once a step, not D times).

  * Atoms are sorted by x once, at `distribute`, and cut into D slabs of C
    rows each; a slab's atoms stay its own (rows move between neighbours
    only through `migrate`, when cfg.migrate_b > 0).
  * Every step each shard takes its two halo blocks (B = halo_b rows) from
    its ring neighbours (`_halo_refresh`) and evaluates its frame, [halo_l,
    own rows, halo_r], at its cc = C + 2 bc centre rows (bc = B / 2): the
    own rows' forces are exact when every atom within rlist of an own row
    is a centre row and every atom within rlist of a centre row is in the
    frame.
  * The skin list is rebuilt per shard over its own frame (x shifted to a
    frame-local origin) at block ends when a step flagged staleness. Each
    rebuild proves the two coverage conditions above on six scalars per
    shard; a failure latches `OVF_COVERAGE`. With x not periodic, the edge
    halos of the first and last slab are the box's far end: they are parked
    (left out of every pair and of the proof).
  * NHC and MTK run the single-device math on global sums (psum of the
    kinetic energy and the virial); NPT scales every shard's positions and
    the one box.

Over a process group (ShardMesh(group=...), parallel/launch.py) each rank
holds its L = D / W consecutive shards: the per-shard leaves of the state
are [L, ...], every rank plans from the whole scene as every JAX program
sees the same host arrays, the shard ids that decide edges and
neighbours are global (`mesh.shard_ids`), and the rebuild decision, the
tallies, `flags`, `gather_positions` and `redistribute` read global
values, the same on every rank.

Energies are shift-free throughout (no e_shift / e_base), as in the
single-device Simulator; `model.e_shift` is there for readers who add
n * e_shift.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..md import integrate as I
from ..md.simulation import Thermo, npt_drift_vcoef
from ..system.neighbors import (build_neighbors_cell, build_neighbors_n2,
                                cell_grid_dims, estimate_capacity)
from ..units import BOLTZ, MVV2E, NKTV2P
from .mesh import ShardMesh


class FrameShort(NamedTuple):
    """Refresh-static short rows of every shard's centre rows
    (FrameShortModel), recompacted from the stored skin list at every block
    boundary; a compaction overflow latches OVF_SHORT."""
    sidx: torch.Tensor    # [D, cc, Ks] frame indices ascending, C_ext filler
    ref: torch.Tensor     # [D, C, 3] own positions at refresh (drift guard)


class ShardState(NamedTuple):
    """Sharded MD state: leaves with a leading [D] axis hold one row per
    shard (this rank's L shards over a process group); the rest are
    shared, bitwise equal on every rank."""
    x_loc: torch.Tensor      # [D, C, 3]
    v_loc: torch.Tensor      # [D, C, 3]
    f_loc: torch.Tensor      # [D, C, 3]
    gid: torch.Tensor        # [D, C] int64 original atom id of each row
    halo_l: torch.Tensor     # [D, B, 3] ring-received edge positions
    halo_r: torch.Tensor     # [D, B, 3]
    idx: torch.Tensor        # [D, cc, K] skin rows of the centre rows
    ref_loc: torch.Tensor    # [D, C, 3] own positions at the last rebuild
    pe: torch.Tensor         # [D] shift-free potential energy of each shard
    box: torch.Tensor        # [3]
    virial: torch.Tensor     # [3, 3] global (summed over the shards)
    nhc: I.NHCState          # particle thermostat chain
    v_eps: torch.Tensor      # [3] barostat strain rates
    baro_nhc: I.NHCState     # barostat thermostat chain
    step: torch.Tensor       # int64
    stale: torch.Tensor      # [D] bool: a rebuild is wanted
    unsafe: torch.Tensor     # [D] bool, sticky: drift crossed skin/2
    overflow: torch.Tensor   # [D] int32 sticky bitmask of OVF_* (0 healthy)
    plan: Any = None         # a layout's exchange plan (none for slabs)
    short: Any = None        # FrameShort (FrameShortModel), else None


# overflow bits (ShardState.overflow): a nonzero value means the run is
# invalid, the bits say why
OVF_NEIGHBOR = 1   # a neighbor row exceeded capacity K (or a cell its own)
OVF_FRAME = 2      # an atom left the frame's x-extent
OVF_COVERAGE = 4   # the rebuild-time halo coverage proof failed
OVF_SHORT = 8      # frame short-list overflow or asymmetric short rows


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    n_devices: int                 # shards D
    c_loc: int                     # atoms a shard (n must equal D * C)
    cutoff: float
    skin: float
    dt: float
    halo_b: Optional[int] = None   # halo rows a side; None: derived from the
                                   # scene at distribute (_auto_geometry)
    capacity: Optional[int] = None  # skin-list width K; None: from density
    ensemble: str = "nve"          # "nve" | "nvt" | "npt"
    t_target: float = 300.0
    tau_t: float = 0.1
    nhc_len: int = 3
    p_target: tuple = (0.0, 0.0, 0.0)
    p_couple: tuple = (False, False, False)
    tau_p: float = 1.0
    pchain: int = 3
    thermo_every: int = 10
    pbc: tuple = (True, True, True)
    cell_capacity: int = 64
    nbr_method: str = "auto"       # "auto" | "cell" | "n2"
    stale_factor: float = 0.8      # flag staleness at stale_factor*skin/2
    migrate_b: int = 0             # edge rows exchanged per slab boundary at
                                   # each rebuild (0: fixed assignment);
                                   # at most c_loc // 2

    @property
    def bc(self) -> int:          # centre-row extension a side
        return self.halo_b // 2

    @property
    def c_ext(self) -> int:       # position rows of a frame
        return self.c_loc + 2 * self.halo_b

    @property
    def cc(self) -> int:          # centre rows of a frame
        return self.c_loc + 2 * self.bc

    @property
    def rlist(self) -> float:
        return self.cutoff + self.skin


# ------------------------------------------------------------ adapters
# Each evaluates the D frames at once: xc [D, cc, 3] centre rows, x_ext
# [D, C_ext, 3] frames, idx [D, cc, K] skin rows (frame indices), off the
# first centre row's frame row, vslice the own rows among the centre rows.
# They return (eat [D, cc] shift-free, forces [D, cc, 3], W [3, 3] over
# every shard's own rows).
class AnnpFrameModel:
    """A fused evaluator (FusedAnnp, either angular path) on the skin rows
    at their full width (`energy_forces_frames`)."""

    def __init__(self, pk):
        self.pk = pk
        self.e_shift = pk.cfg.e_shift

    def eval(self, xc, x_ext, box, idx, off, vslice, want_virial):
        return self.pk.energy_forces_frames(xc, x_ext, box, idx, off,
                                            want_virial, vslice)


class FrameShortModel:
    """A fused evaluator (FusedAnnp or FusedNi) through the refresh-static
    frame short list: the skin list built at a rebuild stays in the state,
    every block boundary the driver compacts it at short_rc + short_delta
    (`compact_short_frames`), and each step evaluates the short rows
    (`energy_forces_frames_short`), the single-device ShortList epochs per
    frame."""
    is_short = True

    def __init__(self, pk):
        self.pk = pk
        self.e_shift = pk.cfg.e_shift

    @property
    def short_delta(self):
        return self.pk.short_delta

    @property
    def k_short(self):
        return self.pk.k_short

    def refresh(self, x_ext, box, idx, off, cc):
        return self.pk.compact_short_frames(x_ext, box, idx, off, cc)

    def eval_short(self, xc, x_ext, box, sidx, cc, off, vslice, want_virial):
        return self.pk.energy_forces_frames_short(xc, x_ext, box, sidx, cc,
                                                  want_virial, vslice, off)


class XlaFrameModel:
    """The chunked ANNP functions' frame route (fe and ni,
    models/annp.energy_forces_virial_frames): the fused evaluator of
    (mcfg, params) on the rows, compacted to k_short at the descriptor
    cutoff when given. `chunk` keeps the JAX signature."""

    def __init__(self, mcfg, params, chunk=512, k_short=None):
        from ..models import annp
        self._m = annp
        self.mcfg = mcfg
        self.params = params
        self.chunk = chunk
        self.k_short = k_short
        self.e_shift = mcfg.e_shift

    def eval(self, xc, x_ext, box, idx, off, vslice, want_virial):
        return self._m.energy_forces_virial_frames(
            self.mcfg, self.params, x_ext, box, idx, off, vslice,
            chunk=self.chunk, k_short=self.k_short)


class AnnaFrameModel:
    """ANNA-ADP's two-phase halo recompute: every shard computes the fields
    the reference exchanges between its two phases (rho, mu, lambda, d2,
    q2) for all its centre rows from the position halo, so no field is
    exchanged. fast=True takes the plane path (phase 1 on g_harm,
    `energy_forces_frames_fast`), else the reference-shaped one."""

    def __init__(self, mcfg, params, fast=False):
        from ..models import anna_adp
        self._m = anna_adp
        self.mcfg = mcfg
        self.params = params
        self.e_shift = mcfg.e_base
        self.fast = fast

    def eval(self, xc, x_ext, box, idx, off, vslice, want_virial):
        fn = (self._m.energy_forces_frames_fast if self.fast
              else self._m.energy_forces_frames)
        return fn(self.mcfg, self.params, xc, x_ext, box, idx, off, vslice,
                  want_virial=want_virial)


# -------------------------------------------------------------- driver
def _tensor(a, device, dtype=None):
    return torch.as_tensor(a, device=device, dtype=dtype)


def migrate_round(pay, gid, axis, bm, ship_up, ship_down, first, last,
                  periodic, length):
    """One bounded edge-block exchange along `axis` (the LAMMPS exchange()
    analogue; JAX `_migrate_body` of the 1-D driver, :748, and
    `_migrate_round` of the 2-D and 3-D ones): pay [D, C, 9] (x, v, f) and
    gid [D, C] of every shard, rows sorted by the axis coordinate. At every
    boundary the bm top rows of the lower shard and the bm bottom rows of
    the upper one are merged by that coordinate, in the lower shard's
    coordinate patch, and split again, each shard keeping the half nearest
    it: counts stay equal, an atom moves at most bm rows a call, and one
    that crosses the periodic seam gets one exact +-length shift.

    ship_up / ship_down move each shard's block to its upper / lower
    neighbour along the axis (ring calls of the mesh); first / last [D]
    bool mark the shards at the axis's two ends, which exchange nothing
    across a non-periodic end. Returns (pay, gid, atoms received [D])."""
    c = pay.shape[1]
    dev = pay.device
    top, bot = pay[:, c - bm:], pay[:, :bm]
    gtop, gbot = gid[:, c - bm:], gid[:, :bm]
    recv_top, grecv_top = ship_up(top), ship_up(gtop)      # lower's top
    recv_bot, grecv_bot = ship_down(bot), ship_down(gbot)  # upper's bottom

    def merge(t_pay, t_gid, b_pay, b_gid, s):
        """Sort the 2 bm union [top of the lower shard ++ bottom of the
        upper shard] by the coordinate in the lower shard's patch (the
        upper side is offset by s [D] at the seam); an atom that changes
        sides takes one exact s shift."""
        key = torch.cat([t_pay[..., axis], b_pay[..., axis] - s[:, None]],
                        dim=1)
        srcs = torch.cat([torch.zeros(bm, dtype=torch.int64, device=dev),
                          torch.ones(bm, dtype=torch.int64, device=dev)])
        order = torch.argsort(key, dim=1, stable=True)
        vals = torch.gather(torch.cat([t_pay, b_pay], dim=1), 1,
                            order[..., None].expand(-1, -1, 9))
        gids = torch.gather(torch.cat([t_gid, b_gid], dim=1), 1, order)
        src = srcs[order]
        dest = (torch.arange(2 * bm, device=dev) >= bm).to(torch.int64)
        vals = vals.clone()
        vals[..., axis] = vals[..., axis] + s[:, None] * (dest - src).to(
            vals.dtype)
        return vals, gids, src

    zero = torch.zeros(first.shape[0], dtype=pay.dtype, device=dev)
    if periodic:
        s_r = torch.where(last, -length, zero)       # my upper side
        s_l = torch.where(first, -length, zero)      # my lower side
    else:
        s_r = s_l = zero
    mr, gr, src_r = merge(top, gtop, recv_bot, grecv_bot, s_r)
    ml, gl, src_l = merge(recv_top, grecv_top, bot, gbot, s_l)
    new_top, new_gtop = mr[:, :bm], gr[:, :bm]
    new_bot, new_gbot = ml[:, bm:], gl[:, bm:]
    in_r = src_r[:, :bm].sum(dim=1)            # the upper's atoms now mine
    in_l = (1 - src_l[:, bm:]).sum(dim=1)      # the lower's atoms now mine
    if not periodic:
        # no wrap: the outermost faces exchange nothing
        new_top = torch.where(last[:, None, None], top, new_top)
        new_gtop = torch.where(last[:, None], gtop, new_gtop)
        new_bot = torch.where(first[:, None, None], bot, new_bot)
        new_gbot = torch.where(first[:, None], gbot, new_gbot)
        in_r = torch.where(last, 0, in_r)
        in_l = torch.where(first, 0, in_l)
    return (torch.cat([new_bot, pay[:, bm:c - bm], new_top], dim=1),
            torch.cat([new_gbot, gid[:, bm:c - bm], new_gtop], dim=1),
            in_l + in_r)


class ShardedMD:
    """Spatially sharded MD driver (1-D slabs along x) over a shard mesh.

    model: one of the adapters above (a bare FusedAnnp is taken as
    AnnpFrameModel); masses_scalar: the one atomic mass; box [3]; mesh: a
    ShardMesh of cfg.n_devices shards (default: in this process on
    `device`)."""

    def __init__(self, model, masses_scalar, box, cfg: ShardConfig,
                 mesh: Optional[ShardMesh] = None, device="cuda"):
        if hasattr(model, "energy_forces_frames"):
            model = AnnpFrameModel(model)
        self.model = model
        self.m = float(masses_scalar)
        self.cfg = cfg
        if cfg.n_devices < 2:
            raise ValueError("use md.simulation.Simulator for one shard")
        if (cfg.halo_b is not None and cfg.n_devices == 2
                and 2 * cfg.halo_b > cfg.c_loc):
            raise ValueError("a 2-shard ring needs halo_b <= c_loc/2 (the "
                             "two halo blocks must not overlap)")
        if 2 * cfg.migrate_b > cfg.c_loc:
            raise ValueError("migrate_b must be <= c_loc/2 (the two edge "
                             "blocks of a shard must not overlap)")
        if cfg.nbr_method not in ("auto", "cell", "n2"):
            raise ValueError(f"unknown nbr_method {cfg.nbr_method!r}")
        self.mesh = ShardMesh(cfg.n_devices, device) if mesh is None else mesh
        if self.mesh.n_shards != cfg.n_devices:
            raise ValueError("the mesh's shard count is not n_devices")
        self.device = self.mesh.device
        self.box0 = np.asarray(torch.as_tensor(box).cpu(), np.float64)
        self.n = cfg.n_devices * cfg.c_loc
        self.ndof = 3 * self.n - 3
        self.frame_wx: Optional[float] = None      # set by distribute()
        self.frame_dims: Optional[tuple] = None
        self.rebuild_count = 0
        self.migrated = 0              # atoms moved between shards (run())

    # ================= planning =================
    def _auto_geometry(self, xs_sorted_x: np.ndarray, box):
        """Derive halo_b (and capacity) from the sorted x coordinates: for
        every slab edge, count the atoms inside an rlist + skin/4 window on
        each side; bc is the largest count with 6.25 % headroom, rounded up
        to 8 (JAX :326, the same numbers). The rebuild-time coverage proof
        stays the exact backstop."""
        cfg = self.cfg
        n, C, D = self.n, cfg.c_loc, cfg.n_devices
        L = float(box[0])
        w = cfg.rlist + 0.25 * cfg.skin
        xs = xs_sorted_x
        if cfg.halo_b is not None:        # only capacity was left to derive
            self.cfg = dataclasses.replace(
                cfg, capacity=estimate_capacity(box, cfg.rlist, n))
            return
        need = 0
        for e in range(D):
            edge = e * C          # boundary between slabs e-1 and e
            x_e = xs[edge] if edge < n else xs[0] + L
            if cfg.pbc[0]:
                ext = np.concatenate([xs - L, xs, xs + L])
                lo = np.searchsorted(ext, x_e - w, side="right")
                hi = np.searchsorted(ext, x_e + w, side="left")
                mid = np.searchsorted(ext, x_e, side="left")
            else:
                ext = xs
                lo = np.searchsorted(ext, x_e - w, side="right")
                hi = np.searchsorted(ext, x_e + w, side="left")
                mid = edge
            need = max(need, mid - lo, hi - mid)
        bc = -(-int(need * 1.0625 + 1) // 8) * 8
        halo_b = 2 * bc
        cap = min(C // 2 if D == 2 else C, self.n // 2)
        if halo_b > cap:
            # clamp to the largest legal block: the coverage proof decides
            # whether it suffices
            clamped = (cap // 16) * 16
            if clamped // 2 < need:
                raise ValueError(
                    f"derived halo_b={halo_b} exceeds the slab bound {cap} "
                    f"and clamping below the {need}-row requirement: the "
                    f"scene is too thin in x for {D} slabs -- use fewer "
                    "shards or a wider box")
            halo_b = clamped
        updates = {"halo_b": halo_b}
        if cfg.capacity is None:
            updates["capacity"] = estimate_capacity(box, cfg.rlist, n)
        self.cfg = dataclasses.replace(cfg, **updates)

    def _plan_frame(self, xs_sorted_x: np.ndarray, box):
        """The frames' x-extent and cell grid from the sorted x (JAX
        :386)."""
        cfg = self.cfg
        n, C, B = self.n, cfg.c_loc, cfg.halo_b
        L = float(box[0])
        spans = []
        for d in range(cfg.n_devices):
            i0, i1 = d * C - B, d * C + C + B
            if 0 <= i0 and i1 <= n:
                spans.append(xs_sorted_x[i1 - 1] - xs_sorted_x[i0])
            elif cfg.pbc[0]:
                lo = xs_sorted_x[i0 % n] - L if i0 < 0 else xs_sorted_x[i0]
                hi = xs_sorted_x[(i1 - 1) % n] + (L if i1 > n else 0.0)
                spans.append(hi - lo)
            else:
                i0c, i1c = max(i0, 0), min(i1, n)
                spans.append(xs_sorted_x[i1c - 1] - xs_sorted_x[i0c])
        self.frame_wx = float(np.max(spans)) + cfg.rlist
        shrink = 0.92 if cfg.ensemble == "npt" else 1.0
        dims = cell_grid_dims(
            (self.frame_wx, float(box[1]) * shrink, float(box[2]) * shrink),
            cfg.rlist)
        method = cfg.nbr_method
        if method == "auto":
            method = "cell" if (min(dims) >= 3 and cfg.c_ext > 2048) else "n2"
        self.frame_dims = dims if method == "cell" else None

    def _constants(self, dtype):
        """The thermostat and barostat constants of the run's dtype."""
        c, dev = self.cfg, self.device
        self._q = I.nhc_masses(self.ndof, c.t_target, c.tau_t, c.nhc_len,
                               dtype, dev)
        self._n_couple = max(1, sum(bool(p) for p in c.p_couple))
        self._baro_q = I.nhc_masses(self._n_couple, c.t_target, c.tau_p,
                                    c.pchain, dtype, dev)
        self._couple = _tensor(c.p_couple, dev, dtype)
        self._p_ext = _tensor(c.p_target, dev, dtype) / NKTV2P
        self._w_mass = I.npt_baro_masses(self.n, c.t_target, c.tau_p, dtype,
                                         dev)

    # ================= distribution =================
    def distribute(self, x, v=None, box=None):
        """Sort by x -> slabs -> per-shard skin lists and forces.

        x, v: [N, 3] tensors (or arrays); their dtype sets the run's.
        Returns (ShardState, order): order maps sorted row -> original
        atom."""
        cfg = self.cfg
        dev = self.device
        x = _tensor(x, dev)
        n = x.shape[0]
        if n != self.n:
            raise ValueError(f"need n == n_devices*c_loc ({self.n}), got {n}")
        box_np = self.box0 if box is None else np.asarray(
            torch.as_tensor(box).cpu(), np.float64)
        order = torch.argsort(x[:, 0], stable=True)
        xs = x[order]
        vs = _tensor(v, dev, x.dtype)[order] if v is not None \
            else torch.zeros_like(xs)
        xs_np = xs[:, 0].double().cpu().numpy()
        if cfg.halo_b is None or cfg.capacity is None:
            self._auto_geometry(xs_np, box_np)
            cfg = self.cfg
        self._plan_frame(xs_np, box_np)
        self._constants(x.dtype)

        D, C, B = cfg.n_devices, cfg.c_loc, cfg.halo_b
        mesh = self.mesh
        L = mesh.n_local
        d_idx = mesh.shard_ids
        ids_l = (d_idx[:, None] * C - B + torch.arange(B, device=dev)) % n
        ids_r = (d_idx[:, None] * C + C + torch.arange(B, device=dev)) % n
        x_l = mesh.local(xs.reshape(D, C, 3))
        dtype = x.dtype
        st = ShardState(
            x_loc=x_l, v_loc=mesh.local(vs.reshape(D, C, 3)),
            f_loc=torch.zeros_like(x_l), gid=mesh.local(order.reshape(D, C)),
            halo_l=xs[ids_l], halo_r=xs[ids_r],
            idx=torch.zeros((L, cfg.cc, cfg.capacity), dtype=torch.int64,
                            device=dev),
            ref_loc=x_l, pe=torch.zeros(L, dtype=dtype, device=dev),
            box=_tensor(box_np, dev, dtype),
            virial=torch.zeros((3, 3), dtype=dtype, device=dev),
            nhc=I.NHCState.zeros(cfg.nhc_len, dtype, dev),
            v_eps=torch.zeros(3, dtype=dtype, device=dev),
            baro_nhc=I.NHCState.zeros(cfg.pchain, dtype, dev),
            step=torch.zeros((), dtype=torch.int64, device=dev),
            stale=torch.zeros(L, dtype=torch.bool, device=dev),
            unsafe=torch.zeros(L, dtype=torch.bool, device=dev),
            overflow=torch.zeros(L, dtype=torch.int32, device=dev))
        st = self.rebuild(st)
        st = self.refill_forces(st)
        return st, order

    @property
    def _is_short(self):
        return getattr(self.model, "is_short", False)

    def _short_geom(self):
        """(off, cc) of the centre rows inside the frame (layout hook)."""
        return self.cfg.halo_b - self.cfg.bc, self.cfg.cc

    def _frame_rows(self):
        """Rows of a frame, the skin lists' sentinel (layout hook)."""
        return self.cfg.c_ext

    def _own_rows(self):
        """[lo, hi) of the own rows among the centre rows (layout hook)."""
        return self.cfg.bc, self.cfg.bc + self.cfg.c_loc

    # ---------- frame helpers ----------
    def _frame(self, x, hl, hr):
        return torch.cat([hl, x, hr], dim=1)               # [D, C_ext, 3]

    def _force_local(self, x, hl, hr, box, idx, short=None):
        """(pe [D] shift-free, f [D, C, 3] of the own rows, W [3, 3] summed
        over all the shards): one evaluation of every local shard's
        frame."""
        x_ext = self._frame(x, hl, hr)
        off, cc = self._short_geom()
        xc = x_ext[:, off:off + cc]
        sl = self._own_rows()
        if short is not None:
            eat, forces, w = self.model.eval_short(xc, x_ext, box, short.sidx,
                                                   cc, off, sl, True)
        else:
            eat, forces, w = self.model.eval(xc, x_ext, box, idx, off, sl,
                                             True)
        # w sums this rank's frames: psum adds the ranks' in rank order
        return (eat[:, sl[0]:sl[1]].sum(dim=1), forces[:, sl[0]:sl[1]],
                self.mesh.psum(w[None]))

    def _halo_refresh(self, x_loc):
        b = self.cfg.halo_b
        return (self.mesh.ring_shift(x_loc[:, -b:], 1),
                self.mesh.ring_shift(x_loc[:, :b], -1))

    # the two layout hooks the 2-D and 3-D drivers override -----------
    def _exchange_and_force(self, st: ShardState, x, box):
        """Refresh the halos from x and evaluate. Returns (halo updates for
        st._replace, pe, f, W)."""
        hl, hr = self._halo_refresh(x)
        pe, f, w = self._force_local(x, hl, hr, box, st.idx, short=st.short)
        return {"halo_l": hl, "halo_r": hr}, pe, f, w

    def _force_stored(self, st: ShardState):
        """Evaluation with the halos stored in the state."""
        return self._force_local(st.x_loc, st.halo_l, st.halo_r, st.box,
                                 st.idx, short=st.short)

    def _max_displacement_sq(self, x, ref, box):
        """[D]: each shard's largest squared displacement of x from ref."""
        rsq = torch.zeros(x.shape[:2], dtype=x.dtype, device=x.device)
        for d in range(3):
            dd = x[..., d] - ref[..., d]
            if self.cfg.pbc[d]:
                dd = dd - box[d] * torch.round(dd / box[d])
            rsq = rsq + dd * dd
        return rsq.max(dim=1).values

    # ---------- rebuild: per-shard build + coverage proof ----------
    def _valid_rows(self, i):
        """Frame rows [lo, hi) of shard i (a global id) that hold real
        neighbours: with x not periodic, the first shard's left halo and
        the last shard's right halo are the box's far end and are
        parked."""
        cfg = self.cfg
        lo, hi = 0, cfg.c_ext
        if not cfg.pbc[0]:
            if i == 0:
                lo = cfg.halo_b
            if i == cfg.n_devices - 1:
                hi = cfg.c_loc + cfg.halo_b
        return lo, hi

    def _build_shard(self, i, x, hl, hr, box):
        """Shard i's (a global id) skin rows of its centre rows [cc, K]
        (frame indices, sentinel C_ext) and its neighbor-overflow and
        out-of-frame flags."""
        cfg = self.cfg
        D, B, bc = cfg.n_devices, cfg.halo_b, cfg.bc
        if cfg.pbc[0]:
            # unwrap the ring-edge halos so that the frame is x-contiguous
            if i == 0:
                hl = hl - torch.stack([box[0], box[0] * 0, box[0] * 0])
            if i == D - 1:
                hr = hr + torch.stack([box[0], box[0] * 0, box[0] * 0])
        x_ext = torch.cat([hl, x, hr])
        lo, hi = self._valid_rows(i)
        xv = x_ext[lo:hi]
        wx = self.frame_wx
        origin = 0.5 * (xv[:, 0].min() + xv[:, 0].max()) - 0.5 * wx
        xv = xv - torch.stack([origin, origin * 0, origin * 0])
        out_of_frame = ((xv[:, 0] < 0.0) | (xv[:, 0] >= wx)).any()
        frame_box = torch.stack([box[0] * 0 + wx, box[1], box[2]])
        fpbc = (False, cfg.pbc[1], cfg.pbc[2])
        if self.frame_dims is not None:
            nl = build_neighbors_cell(xv, frame_box, cfg.rlist, cfg.capacity,
                                      self.frame_dims, cfg.cell_capacity,
                                      pbc=fpbc)
        else:
            nl = build_neighbors_n2(xv, frame_box, cfg.rlist, cfg.capacity,
                                    pbc=fpbc)
        m = self._frame_rows()
        idx = torch.full((m, cfg.capacity), m, dtype=torch.int64,
                         device=x.device)
        idx[lo:hi] = torch.where(nl.idx < hi - lo, nl.idx + lo, m)
        off = B - bc
        return idx[off:off + cfg.cc], nl.overflow, out_of_frame, x_ext

    def _coverage(self, x, ctr_lo, ctr_hi, box):
        """[D] bool: the coverage proof fails on a shard, from each shard's
        own x-intervals (x [D, C, 3]) and its valid centre rows' extent
        [ctr_lo, ctr_hi] ([D] each): (a) no atom outside its frame within
        rlist of a centre row, (b) no atom outside its centre rows within
        rlist of an own row. Each shard's atoms occupy a contiguous
        x-interval, so every outside set is a union of the other shards'
        intervals: an exact circular interval test on gathered scalars."""
        cfg = self.cfg
        D, C, B, bc = cfg.n_devices, cfg.c_loc, cfg.halo_b, cfg.bc
        rl = cfg.rlist
        xx = x[..., 0]
        big = torch.full((x.shape[0],), 1e30, dtype=x.dtype,
                         device=x.device)
        loc_min, loc_max = xx.min(dim=1).values, xx.max(dim=1).values
        L = box[0]

        def hits_band(b_lo, b_hi, a_lo, a_w):
            """[b_lo, b_hi] meets [a_lo, a_lo + a_w] (circularly for
            periodic x)."""
            b_w = b_hi - b_lo
            if cfg.pbc[0]:
                dd = b_lo - a_lo
                dd = dd - L * torch.floor(dd / L)              # [0, L)
                return (dd < a_w) | (dd > L - b_w)
            return (b_lo < a_lo + a_w) & (a_lo < b_lo + b_w)

        def seg(lo_r, hi_r):
            if hi_r <= lo_r:
                return None
            s = xx[:, lo_r:hi_r]
            return s.min(dim=1).values, s.max(dim=1).values

        # the gathered [D] values are indexed by global shard ids, the
        # result is a row a local shard (ar)
        g = self.mesh.all_gather
        ar = self.mesh.shard_ids
        every = torch.arange(D, device=x.device)
        if D == 2:
            # both halos come from the same neighbour: its non-frame and
            # non-centre rows are the single mid blocks [B, C-B), [bc, C-bc)
            o = 1 - ar
            bad = torch.zeros(ar.shape[0], dtype=torch.bool, device=x.device)
            for (b0, b1), (a_lo, a_hi) in (((B, C - B), (ctr_lo, ctr_hi)),
                                           ((bc, C - bc), (loc_min, loc_max))):
                s = seg(b0, b1)
                if s is None:
                    continue
                lo_g, hi_g = g(s[0]), g(s[1])
                bad = bad | hits_band(lo_g[o], hi_g[o], a_lo - rl,
                                      (a_hi - a_lo) + 2.0 * rl)
            return bad
        # the left neighbour's rows [0, C-B) and the right neighbour's
        # [B, C) are the adjacent non-frame blocks; every other shard is
        # entirely non-frame
        pb_b = xx[:, :C - B].max(dim=1).values if C > B else -big
        pa_b = xx[:, B:].min(dim=1).values if C > B else big
        pb_c = xx[:, :C - bc].max(dim=1).values if C > bc else -big
        pa_c = xx[:, bc:].min(dim=1).values if C > bc else big
        lo_g, hi_g = g(loc_min), g(loc_max)
        il, ir = (ar - 1) % D, (ar + 1) % D
        if cfg.pbc[0]:
            far = (every[None, :] != il[:, None]) \
                & (every[None, :] != ar[:, None]) \
                & (every[None, :] != ir[:, None])
        else:
            far = (every[None, :] < ar[:, None] - 1) \
                | (every[None, :] > ar[:, None] + 1)
        bad = torch.zeros(ar.shape[0], dtype=torch.bool, device=x.device)
        for pb, pa, a_lo, a_hi, nonempty in (
                (pb_b, pa_b, ctr_lo, ctr_hi, C > B),
                (pb_c, pa_c, loc_min, loc_max, C > bc)):
            a0 = a_lo - rl
            aw = (a_hi - a_lo) + 2.0 * rl
            hit = hits_band(lo_g[None, :], hi_g[None, :], a0[:, None],
                            aw[:, None])
            bad = bad | (far & hit).any(dim=1)
            if nonempty:
                pb_g, pa_g = g(pb), g(pa)
                hit_l = hits_band(lo_g[il], pb_g[il], a0, aw)
                hit_r = hits_band(pa_g[ir], hi_g[ir], a0, aw)
                if not cfg.pbc[0]:
                    hit_l = hit_l & (ar >= 1)
                    hit_r = hit_r & (ar <= D - 2)
                bad = bad | hit_l | hit_r
        return bad

    def _rebuild_body(self, st: ShardState) -> ShardState:
        off, cc = self._short_geom()
        idxs, nbr_ovf, frame_ovf, ctr_lo, ctr_hi = [], [], [], [], []
        for j in range(self.mesh.n_local):
            i = self.mesh.first + j                   # the global shard id
            idx_c, ovf, oof, x_ext = self._build_shard(
                i, st.x_loc[j], st.halo_l[j], st.halo_r[j], st.box)
            idxs.append(idx_c)
            nbr_ovf.append(ovf)
            frame_ovf.append(oof)
            # the valid centre rows' x-extent (parked rows excluded)
            lo, hi = self._valid_rows(i)
            c0, c1 = max(off, lo), min(off + cc, hi)
            ctr_lo.append(x_ext[c0:c1, 0].min())
            ctr_hi.append(x_ext[c0:c1, 0].max())
        bad_cover = self._coverage(st.x_loc, torch.stack(ctr_lo),
                                   torch.stack(ctr_hi), st.box)
        zero = torch.zeros_like(st.overflow)
        ovf = (st.overflow
               | torch.where(torch.stack(nbr_ovf), OVF_NEIGHBOR, zero)
               | torch.where(torch.stack(frame_ovf), OVF_FRAME, zero)
               | torch.where(bad_cover, OVF_COVERAGE, zero))
        return st._replace(idx=torch.stack(idxs), ref_loc=st.x_loc,
                           stale=torch.zeros_like(st.stale),
                           overflow=ovf.to(torch.int32))

    def rebuild(self, st: ShardState) -> ShardState:
        st = self._rebuild_body(st)
        if self._is_short:
            st = self.refresh_short(st)
        return st

    # ---------- frame short-list refresh (FrameShortModel) ----------
    def refresh_short(self, st: ShardState) -> ShardState:
        """Recompact the stored skin rows against the current positions
        (every block boundary: the single-device ShortList epoch)."""
        x_ext = self._frame(st.x_loc, st.halo_l, st.halo_r)
        off, cc = self._short_geom()
        sidx, ovf = self.model.refresh(x_ext, st.box, st.idx, off, cc)
        overflow = st.overflow | torch.where(
            ovf, OVF_SHORT, torch.zeros_like(st.overflow))
        return st._replace(short=FrameShort(sidx, st.x_loc),
                           overflow=overflow.to(torch.int32))

    # ---------- force refill (distribute, restart) ----------
    def refill_forces(self, st: ShardState) -> ShardState:
        pe, f, w = self._force_stored(st)
        return st._replace(pe=pe, f_loc=f, virial=w)

    # ---------- bounded migration (the LAMMPS exchange() analogue) ----
    def migrate(self, st: ShardState) -> ShardState:
        """Move boundary-crossing atoms to the ring neighbour (JAX
        `_migrate_body`, :748): every shard's rows are sorted by x (their
        payloads with them), then `migrate_round` exchanges the migrate_b
        edge rows at every slab boundary. The neighbor tables are stale
        afterwards: run() follows every migrate with rebuild(). Tallies
        self.migrated."""
        D = self.cfg.n_devices
        pay = torch.cat([st.x_loc, st.v_loc, st.f_loc], dim=2)   # [D, C, 9]
        perm = torch.argsort(st.x_loc[..., 0], dim=1, stable=True)
        pay = torch.gather(pay, 1, perm[..., None].expand(-1, -1, 9))
        gid = torch.gather(st.gid, 1, perm)
        ar = self.mesh.shard_ids
        sh = self.mesh.ring_shift
        pay, gid, n_in = migrate_round(
            pay, gid, 0, self.cfg.migrate_b, lambda t: sh(t, 1),
            lambda t: sh(t, -1), ar == 0, ar == D - 1, self.cfg.pbc[0],
            st.box[0])
        x2 = pay[..., 0:3].contiguous()
        hl, hr = self._halo_refresh(x2)
        self.migrated += int(self.mesh.psum(n_in))
        return st._replace(x_loc=x2, v_loc=pay[..., 3:6].contiguous(),
                           f_loc=pay[..., 6:9].contiguous(), gid=gid,
                           halo_l=hl, halo_r=hr, ref_loc=x2)

    # ---------- thermostat / barostat pieces (on global sums) ----------
    def _kin(self, v):
        """[3] global m v^2 per axis (eV)."""
        return self.mesh.psum(MVV2E * (self.m * v * v).sum(dim=1))

    def _nhc_half(self, v, nhc, dt):
        scale, nhc = I.nhc_propagate(self._kin(v).sum(), nhc, self._q,
                                     BOLTZ * self.cfg.t_target, self.ndof, dt)
        return v * scale, nhc

    def _baro_thermo(self, v_eps, baro_nhc, dt):
        ke2 = self._w_mass * (v_eps * v_eps * self._couple).sum()
        scale, bnhc = I.nhc_propagate(ke2, baro_nhc, self._baro_q,
                                      BOLTZ * self.cfg.t_target,
                                      self._n_couple, dt)
        return v_eps * scale, bnhc

    def _baro_half(self, v, v_eps, box, virial):
        dt2 = 0.5 * self.cfg.dt
        couple = self._couple
        vol = box[0] * box[1] * box[2]
        kin = self._kin(v)
        p_int = (kin + torch.diagonal(virial)) / vol
        ke2 = kin.sum()
        n_couple = couple.sum().clamp(min=1.0)
        g_eps = (vol * (p_int - self._p_ext) + (ke2 / self.ndof) * couple
                 / n_couple) / self._w_mass
        v_eps = v_eps + dt2 * g_eps * couple
        tr = (v_eps * couple).sum()
        scale = torch.exp(-dt2 * (v_eps + tr / self.ndof))
        v = v * torch.where(couple > 0, scale, torch.ones_like(scale))
        return v, v_eps

    # ---------- one velocity-Verlet step of every shard ----------
    def _step_device(self, st: ShardState) -> ShardState:
        """Layout-independent: the halo layout lives behind
        `_exchange_and_force`."""
        cfg = self.cfg
        dt, m = cfg.dt, self.m
        x, v, f = st.x_loc, st.v_loc, st.f_loc
        box, virial = st.box, st.virial
        nhc, v_eps, bnhc = st.nhc, st.v_eps, st.baro_nhc
        if cfg.ensemble in ("nvt", "npt"):
            v, nhc = self._nhc_half(v, nhc, dt)
        if cfg.ensemble == "npt":
            v_eps, bnhc = self._baro_thermo(v_eps, bnhc, dt)
            v, v_eps = self._baro_half(v, v_eps, box, virial)

        v = v + (0.5 * dt / MVV2E) * f / m
        if cfg.ensemble == "npt":
            couple = self._couple
            ex = torch.where(couple > 0, torch.exp(dt * v_eps),
                             torch.ones_like(v_eps))
            box = box * ex
            x = x * ex + npt_drift_vcoef(v_eps, couple, dt) * v
        else:
            x = x + dt * v

        msq = self._max_displacement_sq(x, st.ref_loc, box)
        stale = st.stale | (msq > (0.5 * cfg.stale_factor * cfg.skin) ** 2)
        unsafe = st.unsafe | (msq > (0.5 * cfg.skin) ** 2)
        if self._is_short:
            # a pair beyond rc + short_delta enters the cutoff unseen only
            # after two half-delta moves since the refresh
            msq_s = self._max_displacement_sq(x, st.short.ref, box)
            unsafe = unsafe | (msq_s > (0.5 * self.model.short_delta) ** 2)

        halo_up, pe, f, virial = self._exchange_and_force(st, x, box)
        v = v + (0.5 * dt / MVV2E) * f / m
        if cfg.ensemble == "npt":
            v, v_eps = self._baro_half(v, v_eps, box, virial)
            v_eps, bnhc = self._baro_thermo(v_eps, bnhc, dt)
        if cfg.ensemble in ("nvt", "npt"):
            v, nhc = self._nhc_half(v, nhc, dt)
        return st._replace(
            x_loc=x, v_loc=v, f_loc=f, pe=pe, box=box, virial=virial,
            nhc=nhc, v_eps=v_eps, baro_nhc=bnhc, step=st.step + 1,
            stale=stale, unsafe=unsafe, **halo_up)

    # ---------- thermo ----------
    def _thermo_device(self, st: ShardState) -> Thermo:
        cfg = self.cfg
        kin = self._kin(st.v_loc)
        ke = 0.5 * kin.sum()
        temp = 2.0 * ke / (self.ndof * BOLTZ)
        pe = self.mesh.psum(st.pe)
        box = st.box
        vol = box[0] * box[1] * box[2]
        press = ((kin + torch.diagonal(st.virial)) / vol).sum() / 3.0 \
            * NKTV2P
        conserved = pe + ke
        if cfg.ensemble in ("nvt", "npt"):
            conserved = conserved + I.nhc_conserved(st.nhc, self._q,
                                                    cfg.t_target, self.ndof)
        if cfg.ensemble == "npt":
            conserved = conserved + 0.5 * self._w_mass * (
                st.v_eps * st.v_eps * self._couple).sum()
            conserved = conserved + I.nhc_conserved(
                st.baro_nhc, self._baro_q, cfg.t_target, self._n_couple)
            p_hydro = (self._p_ext * self._couple).sum() / self._n_couple
            conserved = conserved + p_hydro * vol
        return Thermo(step=st.step, temp=temp, pe=pe, ke=ke, press=press,
                      vol=vol, conserved=conserved)

    # ---------- run ----------
    def make_run(self, n_blocks: int):
        """A runner of n_blocks x thermo_every steps on fixed neighbor
        tables: st -> (state, Thermo stacked [n_blocks])."""
        def runner(st: ShardState):
            rows = []
            for _ in range(n_blocks):
                for _ in range(self.cfg.thermo_every):
                    st = self._step_device(st)
                rows.append(self._thermo_device(st))
            return st, Thermo(*(torch.stack(c) for c in zip(*rows)))
        return runner

    def run(self, st: ShardState, n_blocks: int):
        """Advance n_blocks x thermo_every steps, rebuilding at block ends
        when a step flagged staleness (one bool read back a block; with
        cfg.migrate_b a migrate first); with a FrameShortModel the short
        rows are recompacted at every block boundary. Returns (state,
        Thermo with one row per block)."""
        run1 = self.make_run(1)
        thermos = []
        self.rebuild_count = 0
        self.migrated = 0
        for _ in range(n_blocks):
            # a short list refreshed at these very positions (distribute,
            # rebuild, refresh_short) holds them as its reference
            if self._is_short and st.short.ref is not st.x_loc:
                st = self.refresh_short(st)
            st, th = run1(st)
            thermos.append(th)
            # a global read: a rebuild's collectives need every rank
            if self.mesh.any(st.stale):
                if self.cfg.migrate_b:
                    st = self.migrate(st)
                st = self.rebuild(st)
                self.rebuild_count += 1
        return st, Thermo(*(torch.cat(c) for c in zip(*thermos)))

    # ---------- convenience ----------
    def flags(self, st: ShardState):
        """(overflow [D] int32, unsafe [D] bool) of every shard, the same
        on every rank."""
        return self.mesh.all_gather(st.overflow), \
            self.mesh.all_gather(st.unsafe)

    def gather_positions(self, st: ShardState, order=None):
        """Positions back in the original atom order, [N, 3], from the
        state's gid rows (which follow migration), on every rank; `order`
        is accepted and ignored, as in JAX."""
        g = self.mesh.all_gather
        inv = torch.argsort(g(st.gid).reshape(-1))
        return g(st.x_loc).reshape(-1, 3)[inv]

    def redistribute(self, st: ShardState, order=None):
        """Sort the atoms into slabs anew (for diffusive scenes when the
        coverage proof starts to fail; cfg.migrate_b keeps up in-run).
        Thermostat and barostat state carry over; sticky flags are kept."""
        g = self.mesh.all_gather
        inv = torch.argsort(g(st.gid).reshape(-1))
        x = g(st.x_loc).reshape(-1, 3)[inv]
        v = g(st.v_loc).reshape(-1, 3)[inv]
        overflow, unsafe = self.flags(st)
        st2, order2 = self.distribute(x, v, box=st.box)
        st2 = st2._replace(
            nhc=st.nhc, v_eps=st.v_eps, baro_nhc=st.baro_nhc, step=st.step,
            unsafe=st2.unsafe | unsafe.any(),
            overflow=st2.overflow | overflow.max())
        return st2, order2
