"""Chebyshev symmetry-function descriptors (the plain-math oracle).

Counterpart of meng_zhang_tpu/models/descriptors.py: `cutoff_cos`,
`chebyshev_t`, `chebyshev_g` (:44). Derivatives come from torch autograd,
as they come from jax.grad there.
"""
from __future__ import annotations

import math

import torch


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
