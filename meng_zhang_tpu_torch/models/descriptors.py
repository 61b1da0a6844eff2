"""Chebyshev and Behler-Parrinello symmetry-function descriptors (the
plain-math oracles).

Counterpart of meng_zhang_tpu/models/descriptors.py: `cutoff_cos`,
`chebyshev_t`, `chebyshev_g` (:44) and `behler_g` (:82). Derivatives come
from torch autograd, as they come from jax.grad there.
"""
from __future__ import annotations

import math

import torch

from ..units import CFLENGTH


def cutoff_cos(r, rc):
    """fc(r) = 0.5*(cos(pi r / rc) + 1)."""
    return 0.5 * (torch.cos(math.pi / rc * r) + 1.0)


def chebyshev_t(x, n: int):
    """[..., n] Chebyshev polynomials T_0..T_{n-1} by recurrence."""
    ts = [torch.ones_like(x), x]
    for _ in range(2, n):
        ts.append(2.0 * x * ts[-1] - ts[-2])
    return torch.stack(ts[:n], dim=-1)


def chebyshev_g(dx, mask, npsf: int, ntsf: int, rc):
    """Raw Chebyshev descriptor vector(s).

    G[m]      = sum_j  T_m(2 r_ij/Rc - 1) fc(r_ij)            m < npsf
    G[npsf+n] = sum_{j<k} T_n((cos t_jik + 1)/2) fc_ij fc_ik  n < ntsf

    dx [..., K, 3], mask [..., K] (real neighbors with r < Rc);
    returns [..., npsf + ntsf]. The leading axes batch atoms (the JAX
    function is vmapped over them instead).
    """
    rsq = (dx * dx).sum(dim=-1)
    one = torch.ones_like(rsq)
    r = torch.where(mask, torch.sqrt(torch.where(mask, rsq, one)), one)
    fc = torch.where(mask, cutoff_cos(r, rc), torch.zeros_like(r))
    tp = chebyshev_t(2.0 * r / rc - 1.0, npsf)                   # [..., K, m]
    g_rad = (torch.where(mask[..., None], tp, torch.zeros_like(tp))
             * fc[..., None]).sum(dim=-2)
    # masked unit vectors are zeroed: padded slots would feed |cos| >> 1
    # into the recurrence
    u = torch.where(mask[..., None], dx / r[..., None], torch.zeros_like(dx))
    cosjk = torch.matmul(u, u.transpose(-1, -2))                 # [..., K, K]
    k = mask.shape[-1]
    pair_m = mask[..., :, None] & mask[..., None, :]
    pair_m = pair_m & ~torch.eye(k, dtype=torch.bool, device=dx.device)
    wjk = torch.where(pair_m, fc[..., :, None] * fc[..., None, :],
                      torch.zeros_like(cosjk))
    xa = 0.5 * (cosjk + 1.0)
    t_prev = torch.ones_like(xa)
    t_cur = xa
    sums = [(wjk * t_prev).sum(dim=(-1, -2))]
    if ntsf > 1:
        sums.append((wjk * t_cur).sum(dim=(-1, -2)))
    for _ in range(2, ntsf):
        t_prev, t_cur = t_cur, 2.0 * xa * t_cur - t_prev
        sums.append((wjk * t_cur).sum(dim=(-1, -2)))
    g_ang = 0.5 * torch.stack(sums, dim=-1)
    return torch.cat([g_rad, g_ang], dim=-1)


def behler_g(dx, mask, coerad, coeang):
    """Raw Behler-Parrinello descriptor vector(s) (ni variant).

    Lengths enter in Bohr (r_m = r * CFLENGTH). Radial G2, ignoring the
    parsed-but-unused rs column:
        G[m] = sum_j exp(-eta_m r_m^2) fc(r_m, Rc_m)          for r_m < Rc_m
    Angular G4 with the j-k leg:
        G[npsf+n] = sum_{j<k} 2^(1-zeta)(1+lambda cos t)^zeta
                    * exp(-eta (rij^2+rik^2+rjk^2)) fc fc fc
        for all three legs < Rc; terms with (1+lambda cos t) <= 0 skipped.

    dx [..., K, 3] in Angstrom, mask [..., K]; coerad [npsf, 3]
    (eta, rs, Rc) and coeang [ntsf, 4] (eta, lambda, zeta, Rc) in atomic
    units, of dx's dtype and device; returns [..., npsf + ntsf]. The
    leading axes batch atoms (the JAX function is vmapped over them).
    """
    rsq = (dx * dx).sum(dim=-1)
    one = torch.ones_like(rsq)
    r = torch.where(mask, torch.sqrt(torch.where(mask, rsq, one)), one)
    rm = r * CFLENGTH                                          # Bohr
    zero = torch.zeros((), dtype=dx.dtype, device=dx.device)
    # radial
    eta_r, rc_r = coerad[:, 0], coerad[:, 2]
    in_r = mask[..., None] & (rm[..., None] < rc_r)            # [..., K, m]
    fc_r = cutoff_cos(rm[..., None], rc_r)
    g_rad = torch.where(in_r, torch.exp(-eta_r * rm[..., None] ** 2) * fc_r,
                        zero).sum(dim=-2)

    # angular (masked unit vectors zeroed, see chebyshev_g)
    u = torch.where(mask[..., None], dx / r[..., None], zero)
    cosjk = torch.matmul(u, u.transpose(-1, -2))               # [..., K, K]
    k = mask.shape[-1]
    pair_m = mask[..., :, None] & mask[..., None, :]
    pair_m = pair_m & ~torch.eye(k, dtype=torch.bool, device=dx.device)
    # r_jk from the displacement difference: x_j - x_k = dx_k - dx_j
    djk = dx[..., None, :, :] - dx[..., :, None, :]
    rjk = torch.sqrt(torch.where(pair_m, (djk * djk).sum(dim=-1),
                                 torch.ones_like(cosjk)))
    rjk_m = torch.where(pair_m, rjk * CFLENGTH, torch.ones_like(rjk))
    eta_a, lam_a, zet_a = coeang[:, 0], coeang[:, 1], coeang[:, 2]
    rc_a = coeang[0, 3]
    legs = pair_m & (rm[..., :, None] < rc_a) & (rm[..., None, :] < rc_a) \
        & (rjk_m < rc_a)
    r2sum = rm[..., :, None] ** 2 + rm[..., None, :] ** 2 + rjk_m ** 2
    fcfcfc = (cutoff_cos(rm[..., :, None], rc_a)
              * cutoff_cos(rm[..., None, :], rc_a) * cutoff_cos(rjk_m, rc_a))
    flag = 1.0 + lam_a * cosjk[..., None]                   # [..., K, K, n]
    ok = legs[..., None] & (flag > 0.0)
    term = (2.0 ** (1.0 - zet_a)
            * torch.where(ok, flag, torch.ones_like(flag)) ** zet_a
            * torch.exp(-eta_a * r2sum[..., None]) * fcfcfc[..., None])
    g_ang = 0.5 * torch.where(ok, term, zero).sum(dim=(-3, -2))
    return torch.cat([g_rad, g_ang], dim=-1)
