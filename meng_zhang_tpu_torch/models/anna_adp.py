"""ANNA-ADP: the physically-informed neural-network potential of
anna-gpu-lammps/bcc_fe.

Counterpart of meng_zhang_tpu/models/anna_adp.py: `AnnaConfig`, `make_anna`
(:43-70), `local_params` (:81), `atom_energies_fields` and its block
(:130-211), `energy`, `atom_energies`, `energy_forces_autodiff`
(:214-242), `_center_pair_force`, `energy_forces`, `energy_forces_virial`,
`_ef_impl` (:245-373) and the fast path `_pair_force_planes`,
`_force_r_shared`, `_fields_from_planes`, `_FIELD_ORDER`,
`_force_from_planes`, `AnnaShort`, `make_anna_fast_fns` (:403-662), and
the device-frame functions of the sharded drivers `_frame_planes`,
`energy_forces_frame_fast` and `energy_forces_frame` (:671-877), each also
batched over a leading shard axis (`energy_forces_frames_fast`,
`energy_forces_frames`: one g_harm launch for all shards).

The network does not output energy. Per atom it maps the raw Chebyshev
descriptors to two local ADP parameters (d2, q2); energy and forces come
from an analytic angular-dependent potential:

  step(r)  = x^4 / (1 + x^4),  x = (r - Rc) / hc
  rho_i    = sum_j step (A0 (r - r0)^yy e^-gz (1 + e^-gz) + C0),  z = r - r0
  embed_i  = c1F sqrt(rho_i) + c2F rho_i^2
  repul_i  = sum_j step (V0 / (b2 - b1) (b2 / z^b1 - b1 / z^b2) + delta),
             z = r / r1
  mu_i     = sum_j step (d1 e^-d2 r + d3) x_ij
  lambda_i = sum_j step (q1 e^-q2 r + q3) x_ij x_ij^T
  E_i = 1/2 repul_i + embed_i + 1/2 |mu_i|^2 + 1/2 ||lambda_i||^2
        - 1/6 tr(lambda_i)^2 + e_base

Forces hold the network's outputs (d2, q2) constant, the reference's PINN
approximation: they are not the full gradient of the energy, so NVE does
not conserve it. `energy_forces` transcribes the reference's hand-derived
pair force, including its d_rho quirk (the step factor is missing on the
gamma terms); `energy_forces_autodiff` is the true frozen-(d2, q2)
gradient. The two agree where e^-gamma(r - r0) is negligible near the
cutoff.

Phase 1 (descriptors -> (d2, q2)) is one function, `_phase1`, for both
paths: the dx planes go through `ops.kernels.g_harm` (the CUDA kernel on
the card, its plain version on the CPU), and the angular descriptors are
formed from the power sums S_l as `FusedAnnp` forms them. The JAX
reference-shaped path evaluates them over each row's [K, K] cos matrix;
both give the same G. Rows wider than `kernels.MAX_K` are first compacted
to their partners within the cutoff, which is exact; a row with more
partners than that raises.

The JAX functions scan 512- or 2048-row chunks with `lax.map`; eager torch
would launch every elementwise op once per chunk, so here rows go in
chunks of `ROW_CHUNK` (one chunk for the 128,000-atom scene), only to bound
memory.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..io.potential import AnnaPotential
from ..ops import fused_annp as fa
from ..ops import frames
from ..ops import kernels
from ..system.cell import min_image
from ..system.neighbors import _compact_rows
from .annp import compact_neighbor_rows
from .mlp import mlp_apply

ROW_CHUNK = 131072   # rows per chunk: [C, K, 3, 3] f32 at K 256 is 1.2 GB
#                      (2.4 GB at g_harm's widest row, K 512)


@dataclasses.dataclass(frozen=True)
class AnnaConfig:
    npsf: int
    ntsf: int
    cut: float
    flagact: tuple
    act_style: str
    e_base: float
    e_scale: float
    pbc: tuple = (True, True, True)


def params_from_numpy(params_np, dtype=torch.float64, device="cuda"):
    """The JAX package's ANNA params dict (`w`, `b`: per-layer arrays
    [ne, n_out, n_in] / [ne, n_out]; `gp` [17]), given as numpy arrays, as
    torch tensors of `dtype` on `device`. On a CUDA device TF32 is turned
    off (process-wide), as FusedAnnp does: phase 1's S_l -> G product would
    otherwise round the network's inputs to ~1e-3."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)
    return {"w": tuple(t(w) for w in params_np["w"]),
            "b": tuple(t(b) for b in params_np["b"]),
            "gp": t(params_np["gp"])}


def make_anna(pot: AnnaPotential, dtype=torch.float32, device="cuda",
              pbc=(True, True, True)):
    """(config, params) from a parsed `.anna` potential."""
    net = pot.networks[0]
    cfg = AnnaConfig(npsf=pot.npsf, ntsf=pot.ntsf, cut=pot.cut,
                     flagact=tuple(net.flagact), act_style=net.act_style,
                     e_base=pot.e_base, e_scale=pot.e_scale, pbc=tuple(pbc))
    ne = len(pot.elements)
    nl = net.n_layers
    params_np = {
        "w": [np.stack([pot.networks[e].weights[l] for e in range(ne)])
              for l in range(nl)],
        "b": [np.stack([pot.networks[e].biases[l] for e in range(ne)])
              for l in range(nl)],
        "gp": pot.gparams}
    return cfg, params_from_numpy(params_np, dtype, device)


def _gp(params):
    """The 17 global ADP parameters as Python floats (one host read)."""
    return tuple(params["gp"].tolist())


# ------------------------------------------------------------- phase 1
@functools.cache
def _cmat(ntsf, dtype, device):
    return torch.as_tensor(fa.cheb_legendre(ntsf), dtype=dtype, device=device)


def _planes(xc, x_src, box, idx, pbc):
    """dx = x_c - x_src[idx] as three [C, K] planes (fa.pair_dx_planes with
    a separate gather source); filler lanes (idx >= len(x_src)) at
    2 box + 10 on every axis, beyond any cutoff."""
    n_src = x_src.shape[0]
    valid = idx < n_src
    xp = torch.cat([x_src, x_src.new_zeros(1, 3)])
    out = []
    for d in range(3):
        dd = xc[:, d][:, None] - xp[idx, d]
        if pbc[d]:
            dd = dd - box[d] * torch.round(dd / box[d])
        out.append(torch.where(valid, dd, 2.0 * box[d] + 10.0))
    return out


def _phase1(cfg: AnnaConfig, params, planes, elems=None, plain=False):
    """(d2, q2) [P, 2] from the dx planes of P rows: raw Chebyshev G
    through g_harm (radial G, then the angular
    G_n = 1/2 (sum_l c_nl S_l - F2)), then the network of each row's
    element (network 0 for every row when elems is None). plain=True
    takes g_harm's plain version on any device."""
    npsf, ntsf = cfg.npsf, cfg.ntsf
    g_fn = fa.g_harm_plain if plain else kernels.g_harm
    g_raw, _ = g_fn(*planes, npsf, ntsf, cfg.cut)
    s_l = g_raw[:, npsf:npsf + ntsf]
    f2 = g_raw[:, npsf + ntsf:npsf + ntsf + 1]
    cmat = _cmat(ntsf, g_raw.dtype, g_raw.device)
    g = torch.cat([g_raw[:, :npsf], 0.5 * (s_l @ cmat.T - f2)], dim=1)
    ne = params["w"][0].shape[0]
    out = None
    for e in range(1 if elems is None else ne):
        o = mlp_apply([w[e] for w in params["w"]],
                      [b[e] for b in params["b"]], cfg.flagact,
                      cfg.act_style, g)
        out = o if out is None else torch.where((elems == e)[:, None], o,
                                                out)
    return out


def local_params(cfg: AnnaConfig, params, x, box, nbr_idx, elems=None,
                 chunk=ROW_CHUNK, x_src=None):
    """Phase 1: per-atom (d2, q2), [N, 2]. x_src (default x) is the gather
    source of the neighbor positions. Rows wider than kernels.MAX_K are
    compacted to their partners within cfg.cut (one host read per chunk);
    more partners than MAX_K raise."""
    src = x if x_src is None else x_src
    n_src = src.shape[0]
    out = []
    for i0 in range(0, x.shape[0], chunk):
        xc, idx = x[i0:i0 + chunk], nbr_idx[i0:i0 + chunk]
        planes = _planes(xc, src, box, idx, cfg.pbc)
        if idx.shape[1] > kernels.MAX_K:
            rsq = sum(p * p for p in planes)
            idx, counts = _compact_rows(rsq < cfg.cut * cfg.cut, idx,
                                        kernels.MAX_K, n_src)
            if int(counts.max()) > kernels.MAX_K:
                raise ValueError(
                    f"a neighbor row holds more than {kernels.MAX_K} "
                    f"partners within {cfg.cut} A: g_harm takes at most "
                    f"MAX_K = {kernels.MAX_K} slots a row (ops/kernels.py)")
            planes = _planes(xc, src, box, idx, cfg.pbc)
        out.append(_phase1(cfg, params, planes,
                           None if elems is None else elems[i0:i0 + chunk]))
    return torch.cat(out)


# ---------------------------------------------- reference-shaped path
def atom_energies_fields(cfg: AnnaConfig, params, x, box, nbr_idx, lparams,
                         eps=None, chunk=ROW_CHUNK, x_src=None):
    """(e_at [N], rho [N], mu [N, 3], lam [N, 3, 3]) given frozen local
    parameters; e_at includes e_base. eps [3, 3] strains every pair
    displacement, dx -> dx (1 + eps). x_src (default x) is the neighbor
    gather source."""
    src = x if x_src is None else x_src
    gp = _gp(params)
    parts = [_atom_energies_fields_block(cfg, gp, x[i0:i0 + chunk], src, box,
                                         nbr_idx[i0:i0 + chunk],
                                         lparams[i0:i0 + chunk], eps)
             for i0 in range(0, x.shape[0], chunk)]
    return tuple(torch.cat(col) for col in zip(*parts))


def _atom_energies_fields_block(cfg: AnnaConfig, gp, xc, x_all, box, nbr_idx,
                                lparams, eps=None):
    """Per-atom ADP energy and the fields the reference forward-communicates
    between its two GPU phases, for the rows xc."""
    (A0, yy, gamma, C0, c1F, c2F, V0, b1, b2, delta, r0, r1, hc,
     d1, q1, d3, q3) = gp
    rc = cfg.cut
    n_all = x_all.shape[0]
    x_pad = torch.cat([x_all, x_all.new_zeros(1, 3)])
    dx = min_image(xc[:, None, :] - x_pad[nbr_idx], box, cfg.pbc)
    mask = nbr_idx < n_all
    if eps is not None:
        dx = dx @ (torch.eye(3, dtype=xc.dtype, device=xc.device) + eps)

    rsq = (dx * dx).sum(dim=-1)
    m = mask & (rsq < rc * rc)
    r = torch.sqrt(torch.where(m, rsq, 1.0))
    stx = (r - rc) / hc
    st4 = stx ** 4
    step = torch.where(m, st4 / (1.0 + st4), 0.0)

    d2, q2 = lparams[:, 0:1], lparams[:, 1:2]
    u = step * (d1 * torch.exp(-d2 * r) + d3)
    w = step * (q1 * torch.exp(-q2 * r) + q3)
    mu = (u[..., None] * dx).sum(dim=1)                               # [C, 3]
    lam = (w[..., None, None] * dx[..., :, None] * dx[..., None, :]).sum(
        dim=1)                                                     # [C, 3, 3]

    z = r - r0
    ez = torch.exp(-gamma * z)
    rho = (step * (A0 * torch.where(m, z, 1.0) ** yy * ez * (1.0 + ez)
                   + C0)).sum(dim=1)
    zr = r / r1
    repul = (step * (V0 / (b2 - b1) * (b2 / zr ** b1 - b1 / zr ** b2)
                     + delta)).sum(dim=1)

    rho_safe = torch.where(rho > 1e-30, rho, 1.0)
    embed = torch.where(rho > 1e-30,
                        c1F * torch.sqrt(rho_safe) + c2F * rho * rho, 0.0)
    nu = torch.diagonal(lam, dim1=-2, dim2=-1).sum(dim=-1)
    angular = (0.5 * (mu * mu).sum(dim=-1) + 0.5 * (lam * lam).sum((-2, -1))
               - nu * nu / 6.0)
    e = 0.5 * repul + embed + angular + cfg.e_base
    return e, rho, mu, lam


def energy(cfg: AnnaConfig, params, x, box, nbr_idx, elems=None):
    lp = local_params(cfg, params, x, box, nbr_idx, elems).detach()
    return atom_energies_fields(cfg, params, x, box, nbr_idx, lp)[0].sum()


def atom_energies(cfg: AnnaConfig, params, x, box, nbr_idx, elems=None):
    lp = local_params(cfg, params, x, box, nbr_idx, elems)
    return atom_energies_fields(cfg, params, x, box, nbr_idx, lp)[0]


def energy_forces_autodiff(cfg: AnnaConfig, params, x, box, nbr_idx,
                           elems=None):
    """Total energy and the true frozen-(d2, q2) gradient forces through
    autograd. It differs from `energy_forces` by the reference's d_rho
    quirk: where e^-gamma(r - r0) is negligible at the pairs with
    step < 1, the two agree to rounding."""
    lp = local_params(cfg, params, x, box, nbr_idx, elems).detach()
    xg = x.detach().requires_grad_(True)
    with torch.enable_grad():
        e = atom_energies_fields(cfg, params, xg, box, nbr_idx, lp)[0].sum()
        (g,) = torch.autograd.grad(e, xg)
    return e.detach(), -g


def _center_pair_force(gp, rho_c, mu_c, lam_c, d2_c, q2_c, dx, r, rc):
    """The reference's pair force g(fields of the center, x_ct) for
    x_ct = x_center - x_target, over trailing pair axes (the analytic form
    of pair_anna_adp.cpp:216-272, d_rho quirk included)."""
    (A0, yy, gamma, C0, c1F, c2F, V0, b1, b2, delta, r0, r1, hc,
     d1, q1, d3, q3) = gp
    stx = (r - rc) / hc
    t1 = 1.0 + stx ** 4
    stpf = stx ** 4 / t1
    dstpf = 4.0 * stx ** 3 / (t1 * t1) / hc

    z = r - r0
    ez = torch.exp(-gamma * z)
    zyy = A0 * z ** yy
    gazyy = zyy * gamma
    drho = (ez * (1.0 + ez) * (zyy * (dstpf + stpf * yy / z) - gazyy)
            + C0 * dstpf - gazyy * ez * ez)
    rho_s = torch.where(rho_c > 1e-30, rho_c, 1.0)
    dembed = (0.5 * c1F / torch.sqrt(rho_s) + 2.0 * c2F * rho_c) * drho

    repc = V0 / (b2 - b1)
    zr = r / r1
    zb1 = zr ** b1
    zb2 = zr ** b2
    rep1 = repc * (b2 / zb1 - b1 / zb2) + delta
    drep = dstpf * rep1 + stpf * repc * (b2 * b1 / r1 / zr
                                         * (-1.0 / zb1 + 1.0 / zb2))

    ut = d1 * torch.exp(-d2_c * r)
    wt = q1 * torch.exp(-q2_c * r)
    au = stpf * (ut + d3)
    aw = 2.0 * stpf * (wt + q3)
    dau = dstpf * (ut + d3) + stpf * (-d2_c * ut)
    daw = dstpf * (wt + q3) + stpf * (-q2_c * wt)

    # elementwise forms, as in the JAX function: the same arithmetic on the
    # self- and neighbor-centered sides keeps the pair terms cancelling
    lam_x = (lam_c * dx[..., None, :]).sum(dim=-1)
    lamq = (dx * lam_x).sum(dim=-1)
    mu_x = (mu_c * dx).sum(dim=-1)
    f_v = -torch.diagonal(lam_c, dim1=-2, dim2=-1).sum(dim=-1) / 3.0

    dterm1 = 0.5 * drep + dembed + dau * mu_x + daw * lamq
    dterm3 = f_v * (daw * r + aw)
    return (dterm1 / r + dterm3)[..., None] * dx + aw[..., None] * lam_x \
        + au[..., None] * mu_c


def energy_forces(cfg: AnnaConfig, params, x, box, nbr_idx, elems=None):
    """Total energy and the reference's forces, by the newton-off gather of
    its GPU kernel (lal_anna_adp.cu:642-804): per ordered pair (a, j),
    F_a += g(fields_j, x_j - x_a) - g(fields_a, x_a - x_j)."""
    e, f, _ = _ef_impl(cfg, params, x, box, nbr_idx, elems, want_virial=False)
    return e, f


def energy_forces_virial(cfg: AnnaConfig, params, x, box, nbr_idx,
                         elems=None, shift=True):
    return _ef_impl(cfg, params, x, box, nbr_idx, elems, want_virial=True,
                    shift=shift)


def _ef_impl(cfg: AnnaConfig, params, x, box, nbr_idx, elems, want_virial,
             chunk=ROW_CHUNK, shift=True):
    n = x.shape[0]
    gp = _gp(params)
    rc = cfg.cut
    lp = local_params(cfg, params, x, box, nbr_idx, elems, chunk=chunk)
    e_at, rho, mu, lam = atom_energies_fields(cfg, params, x, box, nbr_idx,
                                              lp, chunk=chunk)
    x_pad = torch.cat([x, x.new_zeros(1, 3)])
    fs, w = [], torch.zeros((3, 3), dtype=x.dtype, device=x.device)
    for i0 in range(0, n, chunk):
        c = slice(i0, i0 + chunk)
        idx = nbr_idx[c]
        dx = min_image(x[c][:, None, :] - x_pad[idx], box, cfg.pbc)
        rsq = (dx * dx).sum(dim=-1)
        m = (idx < n) & (rsq < rc * rc)
        r = torch.sqrt(torch.where(m, rsq, 1.0))
        idx_c = idx.clamp(max=n - 1)
        g_self = _center_pair_force(gp, rho[c][:, None], mu[c][:, None, :],
                                    lam[c][:, None], lp[c, 0:1], lp[c, 1:2],
                                    dx, r, rc)
        g_nbr = _center_pair_force(gp, rho[idx_c], mu[idx_c], lam[idx_c],
                                   lp[idx_c, 0], lp[idx_c, 1], -dx, r, rc)
        f_pair = torch.where(m[..., None], g_nbr - g_self, 0.0)
        fs.append(f_pair.sum(dim=1))
        if want_virial:
            w = w + 0.5 * torch.einsum("nka,nkb->ab", dx * m[..., None],
                                       f_pair)
    f = torch.cat(fs)
    w = 0.5 * (w + w.T) if want_virial else None
    # shift-free sum: e_base ~ -4.5e3 eV an atom would swamp f32
    e = (e_at - cfg.e_base).sum()
    if shift:
        e = e + n * cfg.e_base
    return e, f, w


# ----------------------------------------------------------- fast path
# Every per-pair quantity is a [C, K] plane of the refresh-static short
# rows: dx as three planes gathered once per evaluation, phase 1 through
# g_harm, phase 2 the per-atom fields (rho, mu, lambda as six columns, d2,
# q2) and energies from the same planes, phase 3 the newton-off pair force
# with the partner fields gathered from one packed table, the in-graph
# counterpart of the reference's 12 forward_comm ghost fields
# (src/pair_anna_adp_gpu.cpp:135-158). The JAX table is [N + 1, 16],
# gathered by rows; here it is [16, N + 1], so that one gather by column
# gives each field as a contiguous [C, K] plane.
_FIELD_ORDER = ("rho", "mux", "muy", "muz", "lxx", "lyy", "lzz",
                "lxy", "lxz", "lyz", "d2", "q2")


def _pair_force_planes(gp, fields, dxx, dxy, dxz, r, stpf, dstpf, rsh):
    """`_center_pair_force` on component planes: g(fields of the center,
    x_ct) for x_ct = (dxx, dxy, dxz). `fields` maps _FIELD_ORDER to
    broadcast-compatible planes (center: [C, 1]; neighbor: [C, K]); `rsh`
    holds the terms that depend on r only (_force_r_shared)."""
    c1F, c2F = gp[4], gp[5]
    d1, q1, d3, q3 = gp[13], gp[14], gp[15], gp[16]

    rho_c = fields["rho"]
    rho_s = torch.where(rho_c > 1e-30, rho_c, 1.0)
    dembed = (0.5 * c1F / torch.sqrt(rho_s) + 2.0 * c2F * rho_c) * rsh["drho"]

    d2_c, q2_c = fields["d2"], fields["q2"]
    ut = d1 * torch.exp(-d2_c * r)
    wt = q1 * torch.exp(-q2_c * r)
    au = stpf * (ut + d3)
    aw = 2.0 * stpf * (wt + q3)
    dau = dstpf * (ut + d3) + stpf * (-d2_c * ut)
    daw = dstpf * (wt + q3) + stpf * (-q2_c * wt)

    lxx, lyy, lzz = fields["lxx"], fields["lyy"], fields["lzz"]
    lxy, lxz, lyz = fields["lxy"], fields["lxz"], fields["lyz"]
    lam_x = lxx * dxx + lxy * dxy + lxz * dxz     # (lam . dx) components
    lam_y = lxy * dxx + lyy * dxy + lyz * dxz
    lam_z = lxz * dxx + lyz * dxy + lzz * dxz
    lamq = dxx * lam_x + dxy * lam_y + dxz * lam_z
    mux, muy, muz = fields["mux"], fields["muy"], fields["muz"]
    mu_x = mux * dxx + muy * dxy + muz * dxz
    f_v = -(lxx + lyy + lzz) / 3.0

    dterm1 = rsh["drep_half"] + dembed + dau * mu_x + daw * lamq
    s = dterm1 / r + f_v * (daw * r + aw)
    return (s * dxx + aw * lam_x + au * mux,
            s * dxy + aw * lam_y + au * muy,
            s * dxz + aw * lam_z + au * muz)


def _force_r_shared(gp, r, stpf, dstpf, m):
    """The terms of the pair force that depend on r only, computed once for
    both centers. z = r - r0 is set to 1 on masked lanes (m False) before
    the power: masked lanes carry r = 1, and with r0 > 1 a non-integer yy
    would give NaN there, which the JAX function's `* mf` keeps. Wherever
    the JAX terms are finite, these are the same numbers."""
    A0, yy, gamma = gp[0], gp[1], gp[2]
    C0, V0, b1, b2 = gp[3], gp[6], gp[7], gp[8]
    delta, r0, r1 = gp[9], gp[10], gp[11]
    z = torch.where(m, r - r0, 1.0)
    ez = torch.exp(-gamma * z)
    zyy = A0 * z ** yy
    gazyy = zyy * gamma
    drho = (ez * (1.0 + ez) * (zyy * (dstpf + stpf * yy / z) - gazyy)
            + C0 * dstpf - gazyy * ez * ez)
    repc = V0 / (b2 - b1)
    zr = r / r1
    zb1 = zr ** b1
    zb2 = zr ** b2
    rep1 = repc * (b2 / zb1 - b1 / zb2) + delta
    drep = dstpf * rep1 + stpf * repc * (b2 * b1 / r1 / zr
                                         * (-1.0 / zb1 + 1.0 / zb2))
    return {"drho": drho, "drep_half": 0.5 * drep}


def _fields_from_planes(cfg, gp, dxx, dxy, dxz, lp_c):
    """Per-atom fields and energies from the displacement planes [C, K].
    Returns (e_at [C] without e_base, fields [12, C] in _FIELD_ORDER)."""
    (A0, yy, gamma, C0, c1F, c2F, V0, b1, b2, delta, r0, r1, hc,
     d1, q1, d3, q3) = gp
    rc = cfg.cut
    rsq = dxx * dxx + dxy * dxy + dxz * dxz
    m = (rsq < rc * rc) & (rsq > 1.0e-12)       # plane fillers sit far out
    r = torch.sqrt(torch.where(m, rsq, 1.0))
    stx = (r - rc) / hc
    st4 = stx ** 4
    step = torch.where(m, st4 / (1.0 + st4), 0.0)

    d2, q2 = lp_c[:, 0:1], lp_c[:, 1:2]                  # [C, 1]
    u = step * (d1 * torch.exp(-d2 * r) + d3)
    w = step * (q1 * torch.exp(-q2 * r) + q3)
    f = {"d2": d2[:, 0], "q2": q2[:, 0]}
    f["mux"] = (u * dxx).sum(dim=1)
    f["muy"] = (u * dxy).sum(dim=1)
    f["muz"] = (u * dxz).sum(dim=1)
    f["lxx"] = (w * dxx * dxx).sum(dim=1)
    f["lyy"] = (w * dxy * dxy).sum(dim=1)
    f["lzz"] = (w * dxz * dxz).sum(dim=1)
    f["lxy"] = (w * dxx * dxy).sum(dim=1)
    f["lxz"] = (w * dxx * dxz).sum(dim=1)
    f["lyz"] = (w * dxy * dxz).sum(dim=1)

    z = r - r0
    ez = torch.exp(-gamma * z)
    rho = (step * (A0 * torch.where(m, z, 1.0) ** yy * ez * (1.0 + ez)
                   + C0)).sum(dim=1)
    f["rho"] = rho
    zr = r / r1
    repul = (step * (V0 / (b2 - b1) * (b2 / zr ** b1 - b1 / zr ** b2)
                     + delta)).sum(dim=1)
    rho_safe = torch.where(rho > 1e-30, rho, 1.0)
    embed = torch.where(rho > 1e-30,
                        c1F * torch.sqrt(rho_safe) + c2F * rho * rho, 0.0)
    nu = f["lxx"] + f["lyy"] + f["lzz"]
    musq = f["mux"] ** 2 + f["muy"] ** 2 + f["muz"] ** 2
    lamsq = (f["lxx"] ** 2 + f["lyy"] ** 2 + f["lzz"] ** 2
             + 2.0 * (f["lxy"] ** 2 + f["lxz"] ** 2 + f["lyz"] ** 2))
    e_at = 0.5 * repul + embed + 0.5 * musq + 0.5 * lamsq - nu * nu / 6.0
    return e_at, torch.stack([f[k] for k in _FIELD_ORDER])


def _force_from_planes(cfg, gp, dxx, dxy, dxz, idx, ftab, own, want_virial,
                       vrow=None):
    """Newton-off pair forces of C rows from their displacement planes:
    both the i- and the j-centered terms, partner fields gathered
    (lal_anna_adp.cu:642-804), the r-only terms computed once. ftab
    [16, N + 1] packs _FIELD_ORDER (column N is the filler's: zeros); own
    [12, C] the rows' own fields; idx [C, K] uses N as its sentinel.
    Returns (fx, fy, fz [C], virial [3, 3] or None); vrow [C] (0/1)
    weights the rows of the virial, default all."""
    rc = cfg.cut
    hc = gp[12]
    n = ftab.shape[1] - 1
    rsq = dxx * dxx + dxy * dxy + dxz * dxz
    m = (idx < n) & (rsq < rc * rc) & (rsq > 1.0e-12)
    mf = m.to(dxx.dtype)
    r = torch.sqrt(torch.where(m, rsq, 1.0))
    stx = (r - rc) / hc
    t1 = 1.0 + stx ** 4
    stpf = stx ** 4 / t1
    dstpf = 4.0 * stx ** 3 / (t1 * t1) / hc
    rsh = _force_r_shared(gp, r, stpf, dstpf, m)

    fj = ftab[:, idx]                                   # [16, C, K]
    nbr = {k: fj[c] for c, k in enumerate(_FIELD_ORDER)}
    ctr = {k: own[c][:, None] for c, k in enumerate(_FIELD_ORDER)}
    g_self = _pair_force_planes(gp, ctr, dxx, dxy, dxz, r, stpf, dstpf, rsh)
    g_nbr = _pair_force_planes(gp, nbr, -dxx, -dxy, -dxz, r, stpf, dstpf,
                               rsh)
    fp = [(gn - gs) * mf for gn, gs in zip(g_nbr, g_self)]
    f = [c.sum(dim=1) for c in fp]
    if not want_virial:
        return f[0], f[1], f[2], None
    dx = (dxx, dxy, dxz) if vrow is None else \
        tuple(d * vrow[:, None] for d in (dxx, dxy, dxz))
    wv = torch.stack([torch.stack([0.5 * (dx[a] * fp[b]).sum()
                                   for b in range(3)]) for a in range(3)])
    return f[0], f[1], f[2], wv


class AnnaShort(NamedTuple):
    """Refresh-static compacted rows of the fast path (no delivery keys:
    the newton-off gather needs no assembly)."""
    idx: torch.Tensor        # [N, k_short] ascending partner ids, sentinel N
    ref_x: torch.Tensor      # positions at refresh (drift guard)
    overflow: torch.Tensor   # bool: some row exceeded k_short (poisons)


def make_anna_fast_fns(cfg: AnnaConfig, params, k_short=64, delta=0.3,
                       chunk=ROW_CHUNK, plain=False):
    """(force_fn, force_fn_light, short_build) for
    Simulator(force_fn, ..., short_build=short_build,
    force_fn_light=force_fn_light) with cfg.short_every > 0 and
    cfg.short_skin == delta.

    Per evaluation: (1) the dx planes of the short rows [N, k_short],
    g_harm and the network (network 0: the fast path is single-element, as
    the JAX one) -> (d2, q2); (2) the per-atom fields and energies from the
    same planes; (3) newton-off pair forces with the partner fields gathered
    from one packed table. Short-list overflow NaN-poisons E and F; the
    light variant returns a zero virial. E is shift-free (no e_base).
    plain=True runs g_harm's plain version on any device (the f64
    reference of the kernel path on the card)."""
    if k_short > kernels.MAX_K:
        raise ValueError(f"k_short {k_short} > MAX_K = {kernels.MAX_K}, the "
                         "widest row g_harm takes")
    gp = _gp(params)
    rc = cfg.cut
    nf = len(_FIELD_ORDER)

    def short_build(x, box, nbrs):
        idx_s, ovf = compact_neighbor_rows(x, box, nbrs.idx, rc + delta,
                                           k_short, pbc=cfg.pbc)
        return AnnaShort(idx=idx_s, ref_x=x, overflow=ovf)

    def _eval(x, box, idx, want_virial):
        n = x.shape[0]
        rows = [slice(i0, i0 + chunk) for i0 in range(0, n, chunk)]
        planes, e_at, fcols = [], [], []
        for c in rows:
            pl = fa.pair_dx_planes(x, box, idx[c], cfg.pbc, row0=c.start)
            e_c, f_c = _fields_from_planes(cfg, gp, *pl,
                                           _phase1(cfg, params, pl,
                                                   plain=plain))
            planes.append(pl)
            e_at.append(e_c)
            fcols.append(f_c)
        fcols = torch.cat(fcols, dim=1)                         # [12, N]
        ftab = torch.nn.functional.pad(fcols, (0, 1, 0, 16 - nf))
        f, w = [], None
        for c, pl in zip(rows, planes):
            fx, fy, fz, wv = _force_from_planes(cfg, gp, *pl, idx[c], ftab,
                                                fcols[:, c], want_virial)
            f.append(torch.stack([fx, fy, fz], dim=1))
            if want_virial:
                w = wv if w is None else w + wv
        if want_virial:
            w = 0.5 * (w + w.T)
        return torch.cat(e_at).sum(), torch.cat(f), w

    def _poison(e, f, ovf):
        nan = torch.full((), float("nan"), dtype=f.dtype, device=f.device)
        return torch.where(ovf, nan, e), torch.where(ovf, nan, f)

    def force_fn(x, box, nbrs, short):
        e, f, w = _eval(x, box, short.idx, want_virial=True)
        e, f = _poison(e, f, short.overflow)
        return e, f, w

    def force_fn_light(x, box, nbrs, short):
        e, f, _ = _eval(x, box, short.idx, want_virial=False)
        e, f = _poison(e, f, short.overflow)
        return e, f, torch.zeros((3, 3), dtype=x.dtype, device=x.device)

    return force_fn, force_fn_light, short_build


# ------------------------------------------------------- device frames
def _frame_planes(xc, x_src, box, idx, pbc):
    """Displacement planes [cc, K] x3 of centre rows xc against the frame
    x_src (JAX :671, without its padding of the rows to 8)."""
    return _planes(xc, x_src, box, idx, pbc)


def energy_forces_frames_fast(cfg: AnnaConfig, params, xc, x_src, box, idx,
                              off, vslice, want_virial=False, plain=False):
    """The fast path on D device frames at once: xc [D, cc, 3] centre rows,
    x_src [D, M, 3] frames (centre row t at frame row off + t), idx [D,
    cc, K] frame indices (sentinel M), vslice (lo, hi) the local rows.

    One [D*cc, K] set of dx planes goes through phase 1 (one g_harm
    launch), the fields and energies of every centre row, then the
    newton-off pair forces with the partner fields gathered from the
    centre rows' table: a lane whose partner is not a centre row of its
    frame (frame-edge rows, whose forces the drivers discard) is masked,
    so the reference's 12 ghost fields need no exchange. Returns (eat [D,
    cc] without e_base, forces [D, cc, 3]) and with want_virial W [3, 3]
    over the vslice rows of every frame. plain=True takes g_harm's plain
    version on any device."""
    d, cc, k = idx.shape
    if k > kernels.MAX_K:
        raise ValueError(f"K = {k} > MAX_K = {kernels.MAX_K}, the widest "
                         "row g_harm takes")
    gp = _gp(params)
    sidx, ctr = frames.frame_tables(idx, x_src.shape[1], off, cc)
    planes = frames.frame_planes(xc, x_src, box, sidx, cfg.pbc)
    e_at, fcols = _fields_from_planes(
        cfg, gp, *planes, _phase1(cfg, params, planes, plain=plain))
    nr = d * cc
    ftab = torch.nn.functional.pad(fcols, (0, 1, 0, 16 - len(_FIELD_ORDER)))
    ic = torch.where(ctr >= 0, ctr, nr)
    vrow = None
    if want_virial:
        t = torch.arange(cc, device=xc.device)
        vrow = ((t >= vslice[0]) & (t < vslice[1])).to(xc.dtype).repeat(d)
    fx, fy, fz, wv = _force_from_planes(cfg, gp, *planes, ic, ftab, fcols,
                                        want_virial, vrow)
    f = torch.stack([fx, fy, fz], dim=1).view(d, cc, 3)
    if not want_virial:
        return e_at.view(d, cc), f
    return e_at.view(d, cc), f, 0.5 * (wv + wv.T)


def energy_forces_frame_fast(cfg: AnnaConfig, params, xc, x_src, box, idx,
                             off, vslice, want_virial=False, plain=False):
    """One frame of energy_forces_frames_fast: (eat [cc], forces [cc, 3][,
    W]). The JAX function's eat includes e_base."""
    out = energy_forces_frames_fast(cfg, params, xc[None], x_src[None], box,
                                    idx[None], off, vslice, want_virial,
                                    plain)
    return (out[0][0], out[1][0]) + out[2:]


def energy_forces_frames(cfg: AnnaConfig, params, xc, x_src, box, idx, off,
                         vslice, want_virial=False, chunk=ROW_CHUNK):
    """The reference-shaped two-phase evaluation on D device frames (the
    halo-recompute form of the reference's energy kernel -> 12-field
    forward_comm -> force kernel): (d2, q2), the ADP fields and energies
    of every centre row from frame positions, then the newton-off pair
    force of the local rows vslice, partner fields read through the
    frame -> centre-row map. Arguments as energy_forces_frames_fast.
    Returns (eat [D, cc] without e_base, forces [D, cc, 3] with the rows
    outside vslice zero, W [3, 3] over the local rows or None)."""
    d, cc, k = idx.shape
    gp = _gp(params)
    rc = cfg.cut
    sidx, ctr = frames.frame_tables(idx, x_src.shape[1], off, cc)
    xf, src = xc.reshape(-1, 3), x_src.reshape(-1, 3)
    lp = local_params(cfg, params, xf, box, sidx, chunk=chunk, x_src=src)
    e_at, rho, mu, lam = atom_energies_fields(
        dataclasses.replace(cfg, e_base=0.0), params, xf, box, sidx, lp,
        chunk=chunk, x_src=src)
    lo, hi = vslice
    rows = (torch.arange(d, device=xc.device)[:, None] * cc
            + torch.arange(lo, hi, device=xc.device)[None, :]).reshape(-1)
    src_pad = torch.cat([src, src.new_zeros(1, 3)])
    forces = xf.new_zeros(d * cc, 3)
    w = xf.new_zeros(3, 3)
    for i0 in range(0, rows.shape[0], chunk):
        rr = rows[i0:i0 + chunk]
        t = ctr[rr]
        dx = min_image(xf[rr][:, None, :] - src_pad[sidx[rr]], box, cfg.pbc)
        rsq = (dx * dx).sum(dim=-1)
        m = (t >= 0) & (rsq < rc * rc)
        r = torch.sqrt(torch.where(m, rsq, 1.0))
        t_c = t.clamp(min=0)
        g_self = _center_pair_force(gp, rho[rr][:, None], mu[rr][:, None, :],
                                    lam[rr][:, None], lp[rr, 0:1],
                                    lp[rr, 1:2], dx, r, rc)
        g_nbr = _center_pair_force(gp, rho[t_c], mu[t_c], lam[t_c],
                                   lp[t_c, 0], lp[t_c, 1], -dx, r, rc)
        f_pair = torch.where(m[..., None], g_nbr - g_self, 0.0)
        forces[rr] = f_pair.sum(dim=1)
        if want_virial:
            w = w + 0.5 * torch.einsum("nka,nkb->ab", dx * m[..., None],
                                       f_pair)
    return (e_at.view(d, cc), forces.view(d, cc, 3),
            0.5 * (w + w.T) if want_virial else None)


def energy_forces_frame(cfg: AnnaConfig, params, xc, x_src, box, idx, off,
                        vslice, want_virial=False, chunk=ROW_CHUNK):
    """One frame of energy_forces_frames: (eat [cc], forces [cc, 3], W or
    None). The JAX function's eat includes e_base."""
    e, f, w = energy_forces_frames(cfg, params, xc[None], x_src[None], box,
                                   idx[None], off, vslice, want_virial,
                                   chunk)
    return e[0], f[0], w
