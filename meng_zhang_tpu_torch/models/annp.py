"""ANNP energy model, Chebyshev (fe) and Behler-Parrinello (ni) variants
(plain torch, forces by autograd).

Counterpart of meng_zhang_tpu/models/annp.py: `NI_HARTREE_EV` (:36),
`AnnpConfig`, `make_annp` (:58), `effective_cutoff` (:96),
`atom_energies` with its descriptor dispatch (:111-146), `energy`,
`energy_forces` (:153), `energy_forces_virial` (:704) and
`descriptor_cutoff` (:397). It is the slow oracle the fused evaluators
(ops/fused_annp.py, ops/fused_ni.py) are held against.

The chunked function API that the run path and the minimizers call --
`compact_neighbor_rows` (:354), `energy_chunked` (:494),
`energy_forces_chunked` (:539), `energy_forces_virial_chunked` (:547),
`ShortRows` and `make_short_chunked_fns` (:645-701) -- is a thin layer over
the fused evaluators, `FusedAnnp` (Chebyshev, harmonic path) and `FusedNi`
(BP): on CUDA tensors they launch the hand kernels, on CPU tensors the
kernels' plain versions run. The JAX functions scan rematerialised row
chunks through autodiff; the evaluators take every row at once, so the
`chunk` argument only keeps the JAX signatures. `elems` (each atom's
element) selects the atoms' networks of a multi-element potential; it is
passed to the evaluator per call, so two scenes sharing one potential (and
one cached evaluator) keep their own element ids.

Thin periodic boxes: `image_shift_table` (:566) and
`energy_forces_virial_images` (:591), the latter on the same fused
evaluators over the image-extended partner table (ops/fused_annp.py), not
through autodiff.

Device frames (parallel/domain.py's `XlaFrameModel`):
`energy_forces_virial_frame` (:407) and its batched form over a leading
shard axis, on the fused evaluators' frame path (`ops/frames.py`):
the JAX function differentiates the summed centre-row energies; the frame
delivery gives every centre row the same forces.

Single-atom functions: `atom_energy` (:111) and `raw_nn_energy` (:126).

Energy bookkeeping: E_i = e_scale * nn(G_i) + e_shift. fe: e_shift
includes e_atom. ni: the network's output is in Hartree and e_scale is
NI_HARTREE_EV = CFFORCE / CFLENGTH, so E is in eV and -dE/dx reproduces
the reference's CFFORCE-converted forces; e_shift is 0.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import NamedTuple

import numpy as np
import torch

from ..io.potential import AnnpPotential, SYM_BEHLER, SYM_CHEBYSHEV
from ..system.cell import image_table, min_image
from ..units import CFFORCE, CFLENGTH
from ..ops import fused_annp as fa
from ..ops import fused_ni as fn
from ..ops import frames
from ..ops import kernels
from ..system.neighbors import _compact_rows
from .descriptors import behler_g, chebyshev_g
from .mlp import mlp_apply

NI_HARTREE_EV = CFFORCE / CFLENGTH   # 27.2115951, the Hartree -> eV factor
                                     # the reference's force conversion implies


@dataclasses.dataclass(frozen=True)
class AnnpConfig:
    """Static model configuration (same fields as the JAX AnnpConfig)."""
    descriptor: int
    npsf: int
    ntsf: int
    cut: float
    flagact: tuple
    act_style: str
    e_scale: float
    e_shift: float
    pbc: tuple = (True, True, True)

    @property
    def nsf(self) -> int:
        return self.npsf + self.ntsf


def params_from_numpy(params_np, dtype=torch.float64, device="cuda"):
    """The JAX package's params dict (`w`, `b`: per-layer arrays
    [ne, n_out, n_in] / [ne, n_out]; `sf_scale`, `sf_shift` [nsf]; for the
    BP variant also `coerad` [npsf, 3] and `coeang` [ntsf, 4]), given as
    numpy arrays, as torch tensors of `dtype` on `device`. Both packages
    then compute the same function from the same weights."""
    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)
    out = {"w": tuple(t(w) for w in params_np["w"]),
           "b": tuple(t(b) for b in params_np["b"]),
           "sf_scale": t(params_np["sf_scale"]),
           "sf_shift": t(params_np["sf_shift"])}
    for key in ("coerad", "coeang"):
        if key in params_np:
            out[key] = t(params_np[key])
    return out


def make_annp(pot: AnnpPotential, dtype=torch.float32, device="cuda",
              pbc=(True, True, True)):
    """(config, params) from a parsed `.ann` potential.

    The BP (ni) variant is selected by the presence of the symmetry-function
    coefficient tables, whatever the file's descriptor label; its params
    also carry `coerad` and `coeang`."""
    is_ni = pot.sym_coerad is not None
    net = pot.networks[0]
    if is_ni:
        cfg = AnnpConfig(
            descriptor=SYM_BEHLER, npsf=pot.npsf, ntsf=pot.ntsf, cut=pot.cut,
            flagact=tuple(net.flagact), act_style=net.act_style,
            e_scale=NI_HARTREE_EV, e_shift=0.0, pbc=tuple(pbc))
    else:
        cfg = AnnpConfig(
            descriptor=SYM_CHEBYSHEV, npsf=pot.npsf, ntsf=pot.ntsf,
            cut=pot.cut, flagact=tuple(net.flagact), act_style=net.act_style,
            e_scale=pot.e_scale, e_shift=pot.e_shift + pot.e_atom,
            pbc=tuple(pbc))
    ne = len(pot.elements)
    nl = pot.networks[0].n_layers
    params_np = {
        "w": [np.stack([pot.networks[e].weights[l] for e in range(ne)])
              for l in range(nl)],
        "b": [np.stack([pot.networks[e].biases[l] for e in range(ne)])
              for l in range(nl)],
        "sf_scale": pot.sf_scale, "sf_shift": pot.sf_shift}
    if is_ni:
        params_np["coerad"] = pot.sym_coerad
        params_np["coeang"] = pot.sym_coeang
    return cfg, params_from_numpy(params_np, dtype, device)


def _bp_cutoff_bohr(coerad, coeang):
    return max(float(np.max(np.asarray(coerad)[:, 2])),
               float(np.max(np.asarray(coeang)[:, 3])))


def effective_cutoff(pot: AnnpPotential) -> float:
    """Smallest neighbor-list cutoff that preserves the model exactly (A):
    the header cutoff for Chebyshev potentials; for BP, where the header's
    6.5 A is the LAMMPS list cutoff, the coefficient tables' Rc
    (7.3699319 Bohr = 3.90 A in the shipped ni file) if that is smaller."""
    if pot.sym_coerad is None:
        return pot.cut
    return min(pot.cut,
               _bp_cutoff_bohr(pot.sym_coerad, pot.sym_coeang) / CFLENGTH)


def descriptor_cutoff(cfg: AnnpConfig, params) -> float:
    """The radius beyond which the descriptors vanish (A): cfg.cut for
    Chebyshev; the coefficient tables' Rc (Bohr -> A) for BP."""
    if cfg.descriptor == SYM_CHEBYSHEV:
        return cfg.cut
    rc_bohr = _bp_cutoff_bohr(params["coerad"].cpu(), params["coeang"].cpu())
    return min(cfg.cut, rc_bohr / CFLENGTH)


def _gather_dx(x, box, nbr_idx, pbc):
    n = x.shape[0]
    x_pad = torch.cat([x, x.new_zeros(1, 3)])
    dx = min_image(x[:, None, :] - x_pad[nbr_idx], box, pbc)
    return dx, nbr_idx < n


def atom_energies(cfg: AnnpConfig, params, x, box, nbr_idx, elems=None):
    """Per-atom energies [N] from positions and a padded neighbor table;
    elems [N] selects each atom's network (None: the first element's)."""
    dx, mask = _gather_dx(x, box, nbr_idx, cfg.pbc)
    return _atom_energies_dx(cfg, params, dx, mask, elems)


def _atom_energies_dx(cfg, params, dx, mask, elems):
    if cfg.descriptor == SYM_CHEBYSHEV:
        rsq = (dx * dx).sum(dim=-1)
        m = mask & (rsq < cfg.cut * cfg.cut)
        g_raw = chebyshev_g(dx, m, cfg.npsf, cfg.ntsf, cfg.cut)
    else:
        g_raw = behler_g(dx, mask, params["coerad"], params["coeang"])
    g = (g_raw - params["sf_shift"]) * params["sf_scale"]
    ne = params["w"][0].shape[0] if elems is not None else 1
    out = None
    for e in range(ne):
        o = mlp_apply([w[e] for w in params["w"]], [b[e] for b in params["b"]],
                      cfg.flagact, cfg.act_style, g)[:, 0]
        if out is None:
            out = o
        else:
            out = torch.where(elems == e, o, out)
    return cfg.e_scale * out + cfg.e_shift


def atom_energy(cfg: AnnpConfig, params, dx, mask, elem):
    """Energy of one atom (e_shift included) from its neighbor
    displacements dx [K, 3] and mask [K], through the network of element
    `elem`."""
    el = torch.as_tensor(elem, device=dx.device).reshape(1)
    return _atom_energies_dx(cfg, params, dx[None], mask[None], el)[0]


def raw_nn_energy(cfg: AnnpConfig, params, dx, mask, elem=0):
    """The network's unscaled output for one atom: the reference's evdwl
    before e_scale and e_shift (fe), its raw Hartree value (ni)."""
    cfg0 = dataclasses.replace(cfg, e_shift=0.0)
    return atom_energy(cfg0, params, dx, mask, elem) / cfg.e_scale


def energy(cfg: AnnpConfig, params, x, box, nbr_idx, elems=None):
    return atom_energies(cfg, params, x, box, nbr_idx, elems).sum()


def energy_forces(cfg: AnnpConfig, params, x, box, nbr_idx, elems=None):
    """(E, F = -dE/dx) through autograd."""
    xg = x.detach().requires_grad_(True)
    with torch.enable_grad():
        e = energy(cfg, params, xg, box, nbr_idx, elems)
        (g,) = torch.autograd.grad(e, xg)
    return e.detach(), -g


def energy_forces_virial(cfg: AnnpConfig, params, x, box, nbr_idx,
                         elems=None):
    """(E, F, W) through autograd, W = -dE/d(strain) symmetrised: the
    displacements are strained as dx (I + eps) and W = -1/2 (g + g^T) with
    g = dE/d eps at eps = 0. The small-box oracle of the multi-element
    fused paths."""
    xg = x.detach().requires_grad_(True)
    eps = torch.zeros((3, 3), dtype=x.dtype, device=x.device,
                      requires_grad=True)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    with torch.enable_grad():
        dx, mask = _gather_dx(xg, box, nbr_idx, cfg.pbc)
        e = _atom_energies_dx(cfg, params, dx @ (eye + eps), mask,
                              elems).sum()
        g_x, g_eps = torch.autograd.grad(e, (xg, eps))
    return e.detach(), -g_x, -0.5 * (g_eps + g_eps.T)


# ------------------------------------------------- chunked function API
def compact_neighbor_rows(x, box, idx, rc, k_short, pbc=(True, True, True),
                          row_chunk=8192):
    """Per-eval short-neighbor repack (the reference's k_annp_short_nbor,
    fe/lib/lal_annp.cu:267-344): each skin row [N, K] is compacted to its
    entries within rc, ascending, padded with n to k_short columns.
    Returns (idx_short [N, k_short], overflow: some row held more than
    k_short entries, a bool tensor on the device)."""
    n = x.shape[0]
    parts, counts = [], []
    for i0 in range(0, n, row_chunk):
        ic = idx[i0:i0 + row_chunk]
        dx, dy, dz = fa.pair_dx_planes(x, box, ic, pbc, row0=i0)
        # filler lanes lie at 2*box + 10 per axis, beyond any rc
        within = (ic < n) & (dx * dx + dy * dy + dz * dz < rc * rc)
        idx_c, cnt = _compact_rows(within, ic, k_short, n)
        parts.append(idx_c)
        counts.append(cnt)
    return torch.cat(parts), (torch.cat(counts) > k_short).any()


# evaluators built once per (cfg, params): {(cfg, id(params)): (params, ev)}
_FUSED = {}
_FUSED_MAX = 8


def fused_evaluator(cfg: AnnpConfig, params):
    """The fused evaluator of (cfg, params) -- FusedAnnp (harmonic path)
    for Chebyshev, FusedNi for BP -- built at the first call and reused
    while `params` is the same object. It holds no element ids: the
    chunked functions pass theirs per call."""
    key = (cfg, id(params))
    hit = _FUSED.get(key)
    if hit is not None and hit[0] is params:
        return hit[1]
    if cfg.descriptor == SYM_CHEBYSHEV:
        ev = fa.FusedAnnp(cfg, params, k_short=kernels.MAX_K)
    else:
        ev = fn.FusedNi(cfg, params, k_short=kernels.NI_MAX_K)
    if len(_FUSED) >= _FUSED_MAX:
        _FUSED.pop(next(iter(_FUSED)))
    _FUSED[key] = (params, ev)
    return ev


def _width(cfg, widest):
    """Columns of rows compacted to their partners, `widest` at most
    (kernels.tiled_width, in the tiles of cfg's kernels)."""
    return kernels.tiled_width(widest, kernels.NI_TILE
                               if cfg.descriptor == SYM_BEHLER
                               else kernels.HARM_TILE)


def _short_list(ev, cfg, params, x, box, nbr_idx, x_ext=None, rc_scale=1.0):
    """nbr_idx rows as the evaluator's ShortList. Rows no wider than the
    single launches take (ev.k_short: MAX_K = 512 fe, NI_MAX_K = 512 BP)
    are evaluated as they are, exactly as the JAX functions evaluate any
    row; wider rows are compacted to their partners within rc_scale times
    the descriptor cutoff (one host read per call, on this path only), to
    ev.k_short columns where they fit and otherwise to the widest row's
    count rounded up to whole tiles, which the kernels take in tiles (the
    JAX CLI's route compacts rows the same way, `compact_neighbor_rows`).
    On the card the compacted rows keep nbr_idx's order: ascending, as
    the ShortList contract has it, for lists from system/neighbors.py;
    the same partners in the caller's order otherwise.
    x_ext: the image-extended table the rows index."""
    if nbr_idx.shape[1] <= ev.k_short:
        return fa.ShortList(nbr_idx, x, torch.zeros(
            (), dtype=torch.bool, device=x.device))
    sl = fa.compact_short(x, box, nbr_idx,
                          rc_scale * descriptor_cutoff(cfg, params),
                          nbr_idx.shape[1], cfg.pbc, x_ext=x_ext)
    n_src = x.shape[0] if x_ext is None else x_ext.shape[0]
    ks = _width(cfg, int((sl.sidx < n_src).sum(1).max()))
    return sl._replace(sidx=sl.sidx[:, :ks].contiguous())


def _elems(elems, x):
    return None if elems is None else torch.as_tensor(elems, device=x.device)


def _evaluate(cfg, params, x, box, nbr_idx, shift, want_virial, elems):
    """One evaluation of the cached evaluator, with the call's elems."""
    ev = fused_evaluator(cfg, params)
    sl = _short_list(ev, cfg, params, x, box, nbr_idx)
    return ev.energy_forces_short(x, box, sl, want_virial=want_virial,
                                  shift=shift, elems=_elems(elems, x))


def energy_chunked(cfg: AnnpConfig, params, x, box, nbr_idx, elems=None,
                   chunk=256, eps=None, shift=True):
    """Total energy (n * e_shift included unless shift=False). eps [3, 3]
    strains every pair displacement, dx -> dx (I + eps), as the JAX
    function's strain argument does; here it is a value, not a variable to
    differentiate (the virial comes from energy_forces_virial_chunked).
    Rows wider than the kernels take are compacted at the descriptor
    cutoff grown by 1 / (1 - |eps|), which keeps every pair the strain can
    bring inside it."""
    if eps is None:
        return _evaluate(cfg, params, x, box, nbr_idx, shift, False,
                         elems)[0]
    eps = torch.as_tensor(eps, dtype=x.dtype, device=x.device)
    norm = float(torch.linalg.matrix_norm(eps))
    if norm >= 0.5:
        raise ValueError(f"strain |eps| = {norm} is not small")
    ev = fused_evaluator(cfg, params)
    sl = _short_list(ev, cfg, params, x, box, nbr_idx,
                     rc_scale=1.0 / (1.0 - norm))
    dd = fa.pair_dx_planes(x, box, sl.sidx, cfg.pbc)
    dd = [dd[a] + sum(dd[b] * eps[b, a] for b in range(3)) for a in range(3)]
    e = ev._eval_fj(*dd, _elems(elems, x))[0].sum()
    return e + x.shape[0] * cfg.e_shift if shift else e


def energy_forces_chunked(cfg: AnnpConfig, params, x, box, nbr_idx,
                          elems=None, chunk=256, shift=True):
    """(E, F [N, 3])."""
    return _evaluate(cfg, params, x, box, nbr_idx, shift, False, elems)


def energy_forces_virial_chunked(cfg: AnnpConfig, params, x, box, nbr_idx,
                                 elems=None, chunk=256, shift=True):
    """(E, F [N, 3], W [3, 3]); W is the pairwise tally -sum dx (x) Fj,
    symmetrised, which equals the JAX function's strain derivative."""
    return _evaluate(cfg, params, x, box, nbr_idx, shift, True, elems)


def image_shift_table(box, rlist, pbc):
    """Integer image-shift table for boxes with periodic dims thinner than
    2*rlist (where the single-image minimum-image convention misses
    periodic self-images -- LAMMPS handles these with ghost atoms).

    Returns (shifts [R, 3] int array with shifts[0] == 0, pbc_eff): the
    neighbor build and the models then run over the image-extended
    position table x_ext = (x[None] + shifts*box).reshape(-1, 3) with the
    thin dims' periodicity OFF (images are explicit). R is bounded by the
    per-dim replication 2*ceil(rlist/L) + 1. Returns (None, pbc) when no
    dim is thin. (numpy; a copy of the JAX function)"""
    ms = [int(np.ceil(rlist / float(b)))
          if (p and float(b) < 2.0 * rlist) else 0
          for b, p in zip(np.asarray(box), pbc)]
    if not any(ms):
        return None, tuple(pbc)
    shifts = [np.zeros(3, np.int64)]
    for s in itertools.product(*[range(-m, m + 1) for m in ms]):
        if any(s):
            shifts.append(np.asarray(s, np.int64))
    pbc_eff = tuple(bool(p) and m == 0 for p, m in zip(pbc, ms))
    return np.stack(shifts), pbc_eff


def energy_forces_virial_images(cfg: AnnpConfig, params, x, box, nbr_idx,
                                shifts, elems=None, chunk=256, shift=True):
    """(E, F [N, 3], W [3, 3]) of a thin periodic box through explicit
    images, on the fused evaluator (its kernels on CUDA tensors).

    nbr_idx [N, K] indexes the image-extended table (rows [0, R*N); row
    r*N + i is atom i shifted by shifts[r], `system.cell.image_table`,
    rebuilt here from the current box); cfg.pbc must be the pbc_eff of
    `image_shift_table` (thin dims off). Each lane's Fj is delivered to
    the real atom behind its partner, so an atom interacting with several
    images of one partner (or of itself) tallies every image pair, as the
    JAX function's autodiff through x_ext does; W = -sum dx (x) Fj over the
    image separations, which equals its strain derivative. Rows wider than
    the kernels take are compacted at the descriptor cutoff (`_short_list`).
    `chunk` only keeps the JAX signature."""
    ev = fused_evaluator(cfg, params)
    x_ext = image_table(x, box, shifts)
    sl = _short_list(ev, cfg, params, x, box, nbr_idx, x_ext)
    return ev.energy_forces_short(x, box, sl, want_virial=True, shift=shift,
                                  elems=_elems(elems, x), x_ext=x_ext)


def energy_forces_virial_frames(cfg: AnnpConfig, params, x_src, box, idx,
                                off, vslice, chunk=512, k_short=None):
    """D device frames at once (fe and ni), on the fused evaluator's frame
    path: x_src [D, M, 3] the frames, centre rows at frame rows [off, off
    + cc); idx [D, cc, K] their neighbor rows (frame indices, sentinel M);
    vslice (lo, hi) the local centre rows, over which W is tallied.

    Returns (eat [D, cc] shift-free, forces [D, cc, 3], W [3, 3] summed
    over the frames). Every centre row's force is -d(sum of the centre
    rows' energies)/dx, the JAX function's gradient; only rows whose
    partners are all centre rows (the local ones) are physical. k_short <
    K compacts the rows to k_short at the descriptor cutoff first, and a
    row over it NaN-poisons eat and forces, as in JAX; rows still wider
    than the single launches take are compacted as in `_short_list`.
    `chunk` only keeps the JAX signature."""
    ev = fused_evaluator(cfg, params)
    d, cc, k = idx.shape
    rc = descriptor_cutoff(cfg, params)
    poison = None
    if k_short is not None and k_short < k:
        idx, counts = frames.compact_frames(x_src, box, idx, off, cc, rc,
                                        k_short, cfg.pbc)
        poison = (counts > k_short).any()
        k = k_short
    if k > ev.k_short:
        idx, counts = frames.compact_frames(x_src, box, idx, off, cc, rc, k,
                                            cfg.pbc)
        idx = idx[..., :_width(cfg, int(counts.max()))].contiguous()
    eat, f, w = frames.evaluate_frames(ev._eval_fj, x_src[:, off:off + cc],
                                   x_src, box, idx, off, cc, cfg.pbc, True,
                                   vslice)
    if poison is not None:
        nan = torch.full((), float("nan"), dtype=f.dtype, device=f.device)
        eat, f = torch.where(poison, nan, eat), torch.where(poison, nan, f)
    return eat, f, w


def energy_forces_virial_frame(cfg: AnnpConfig, params, x_src, box, idx,
                               off, vslice, chunk=512, k_short=None):
    """One frame of energy_forces_virial_frames: x_src [M, 3], idx [cc,
    K]. Returns (eat [cc] shift-free, forces [cc, 3], W [3, 3]); the JAX
    function's eat includes e_shift."""
    eat, f, w = energy_forces_virial_frames(cfg, params, x_src[None], box,
                                            idx[None], off, vslice, chunk,
                                            k_short)
    return eat[0], f[0], w


class ShortRows(NamedTuple):
    """Refresh-static compacted neighbor rows of the chunked path (the
    Simulator rebuilds them every cfg.short_every steps)."""
    idx: torch.Tensor        # [N, k_short] compacted rows (sentinel n)
    ref_x: torch.Tensor      # positions at refresh (drift guard)
    overflow: torch.Tensor   # bool: some row exceeded k_short (poisons)


def make_short_chunked_fns(cfg: AnnpConfig, params, k_short=32, delta=0.3,
                           chunk=1024, elems=None):
    """(force_fn, force_fn_light, short_build) for
    Simulator(force_fn, ..., short_build=short_build,
    force_fn_light=force_fn_light) with cfg.short_every > 0 and
    cfg.short_skin == delta: rows compacted against the descriptor cutoff
    + delta once per short_every steps; short-list overflow NaN-poisons E
    and F; the light variant returns a zero virial. elems: the atoms'
    elements, passed to every call of the chunked functions."""
    rc = descriptor_cutoff(cfg, params)

    def short_build(x, box, nbrs):
        idx_s, ovf = compact_neighbor_rows(x, box, nbrs.idx, rc + delta,
                                           k_short, pbc=cfg.pbc)
        return ShortRows(idx=idx_s, ref_x=x, overflow=ovf)

    def _poison(e, f, ovf):
        nan = torch.full((), float("nan"), dtype=f.dtype, device=f.device)
        return torch.where(ovf, nan, e), torch.where(ovf, nan, f)

    def force_fn(x, box, nbrs, short):
        e, f, w = energy_forces_virial_chunked(cfg, params, x, box,
                                               short.idx, elems, chunk=chunk,
                                               shift=False)
        e, f = _poison(e, f, short.overflow)
        return e, f, w

    def force_fn_light(x, box, nbrs, short):
        e, f = energy_forces_chunked(cfg, params, x, box, short.idx, elems,
                                     chunk=chunk, shift=False)
        e, f = _poison(e, f, short.overflow)
        return e, f, torch.zeros((3, 3), dtype=x.dtype, device=x.device)

    return force_fn, force_fn_light, short_build
