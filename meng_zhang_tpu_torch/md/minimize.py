"""Structure relaxation: Polak-Ribiere CG (the reference benchmark's
`min_style cg`, in.st_test:20-21) and FIRE.

Counterpart of meng_zhang_tpu/md/minimize.py: `fire_minimize` (:35),
`fire_relax` (:91), `cg_minimize` (:114), `_cg_probe` (:220) and
`cg_relax` (:226), with the same iterates.

CG follows LAMMPS MinCG semantics: steepest-descent first iteration, a
host-driven line search along the conjugate direction with a
max-atom-displacement cap (LAMMPS dmax 0.1 A), Polak-Ribiere beta with
automatic restart, and the LAMMPS stopping criteria (relative energy change
< etol, force 2-norm < ftol). Each of its scalar reads is a host sync;
the minimizer is not the hot path.

FIRE (fast inertial relaxation engine) runs blocks of `block` iterations
that stay on the device, with the host's convergence check between
blocks, as the JAX package's jitted blocks do.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class FireState(NamedTuple):
    x: torch.Tensor
    v: torch.Tensor
    f: torch.Tensor
    pe: torch.Tensor
    dt: torch.Tensor
    alpha: torch.Tensor
    n_pos: torch.Tensor
    n_iter: torch.Tensor
    fmax: torch.Tensor


def fire_minimize(force_fn: Callable, x0, box, nbr_idx,
                  dt0=1e-3, dt_max=1e-2, f_tol=1e-6, max_iter=2000,
                  alpha0=0.1, f_inc=1.1, f_dec=0.5, f_alpha=0.99, n_min=5,
                  block=50):
    """Minimize with FIRE on a fixed neighbor list.

    force_fn(x, box, nbr) -> (pe, forces); `nbr_idx` is passed through to
    force_fn as it is. Iterations run in blocks of `block` with a host
    convergence check between blocks, so n_iter is a multiple of `block`.
    Callers rebuild the neighbor list and re-run until displacement
    converges (see `fire_relax`)."""
    pe, f = force_fn(x0, box, nbr_idx)
    dev = x0.device
    s = FireState(x=x0, v=torch.zeros_like(x0), f=f, pe=pe,
                  dt=torch.tensor(dt0, dtype=x0.dtype, device=dev),
                  alpha=torch.tensor(alpha0, dtype=x0.dtype, device=dev),
                  n_pos=torch.zeros((), dtype=torch.int32, device=dev),
                  n_iter=torch.zeros((), dtype=torch.int32, device=dev),
                  fmax=f.abs().max())

    def body(s):
        v = s.v + s.dt * s.f
        power = (s.f * v).sum()
        f_norm = torch.sqrt((s.f * s.f).sum()) + 1e-30
        v_norm = torch.sqrt((v * v).sum())
        v_mixed = (1.0 - s.alpha) * v + s.alpha * v_norm * s.f / f_norm

        uphill = power <= 0.0
        v = torch.where(uphill, torch.zeros_like(v), v_mixed)
        n_pos = torch.where(uphill, torch.zeros_like(s.n_pos), s.n_pos + 1)
        grow = (~uphill) & (n_pos > n_min)
        dt = torch.where(grow, torch.clamp(s.dt * f_inc, max=dt_max),
                         torch.where(uphill, s.dt * f_dec, s.dt))
        alpha = torch.where(grow, s.alpha * f_alpha,
                            torch.where(uphill, torch.full_like(
                                s.alpha, alpha0), s.alpha))

        x = s.x + dt * v
        pe, f = force_fn(x, box, nbr_idx)
        return FireState(x=x, v=v, f=f, pe=pe, dt=dt, alpha=alpha,
                         n_pos=n_pos, n_iter=s.n_iter + 1,
                         fmax=f.abs().max())

    while float(s.fmax) > f_tol and int(s.n_iter) < max_iter:
        for _ in range(block):
            s = body(s)
    return s


def fire_relax(force_fn, build_nbrs, x0, box, f_tol=1e-6, max_outer=20,
               **fire_kw):
    """Outer loop: FIRE + neighbor rebuild until converged (host-driven)."""
    x = x0
    for _ in range(max_outer):
        nbrs = build_nbrs(x, box)
        st = fire_minimize(force_fn, x, box, nbrs.idx, f_tol=f_tol, **fire_kw)
        x = st.x
        if float(st.fmax) <= f_tol:
            break
    return x, st


class CGState(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    pe: torch.Tensor
    n_iter: int
    n_evals: int
    fnorm: float
    converged: str       # "" | "etol" | "ftol" | "maxiter" | "linesearch"


def cg_minimize(force_fn, x0, box, nbr_idx, etol=1.0e-6, ftol=1.0e-6,
                max_iter=100, dmax=0.1, line_evals=6, e_offset=0.0):
    """Polak-Ribiere conjugate-gradient minimization (LAMMPS MinCG).

    force_fn(x, box, nbr_idx) -> (pe, forces) on a FIXED neighbor list --
    callers rebuild and re-run for large relaxations (cg_relax).

    Semantics matched to LAMMPS min_cg + linemin quadratic
    (in.st_test:20-21 runs `minimize 1e-6 1e-6 1000 10000`, which stops
    after ONE iteration because the relative energy change ~1.2e-7 beats
    etol=1e-6):
      * iteration 1 searches along h = F (steepest descent),
      * the step is capped so no atom moves more than dmax,
      * the line minimum is located by secant iterations on
        phi'(alpha) = -F(x + alpha h) . h with an energy-decrease backstop,
      * beta_PR = F1.(F1 - F0)/F0.F0, clamped at 0 (restart) when negative
        or when the new direction is not a descent direction,
      * stop on |E_i - E_{i-1}| <= etol * (|E_i + e_offset|+eps),
        ||F||_2 <= ftol, or a line search that cannot reduce the energy.

    e_offset: constant added to the energy ONLY inside the etol stopping
    rule. Models that return shift-free energies pass n*e_shift here so the
    relative-change criterion sees the same |E| LAMMPS does.
    """
    pe0, f0 = force_fn(x0, box, nbr_idx)
    pe0 = float(pe0)
    n_evals = 1
    x = x0
    f = f0
    h = f0
    gg = float((f0 * f0).sum())
    converged = ""
    it = 0
    for it in range(1, max_iter + 1):
        fnorm = gg ** 0.5
        if fnorm <= ftol:
            converged = "ftol"
            break
        hmax = float(h.abs().max())
        if hmax == 0.0:
            converged = "ftol"
            break
        a_cap = dmax / hmax
        # secant on phi'(a) = -F(x+a h).h  (phi'(0) = -gh < 0 for descent)
        gh = float((f * h).sum())
        if gh <= 0.0:                      # not a descent direction: restart
            h = f
            gh = gg
            hmax = float(h.abs().max())
            a_cap = dmax / hmax
        a_prev, d_prev = 0.0, -gh
        a = a_cap
        best = (pe0, None, None, 0.0)      # (pe, x, f, alpha)
        for _ in range(line_evals):
            pe_a, f_a, x_a, d_a = _cg_probe(force_fn, x, h, a, box, nbr_idx)
            pe_a = float(pe_a)
            d_a = float(d_a)
            n_evals += 1
            if pe_a < best[0]:
                best = (pe_a, x_a, f_a, a)
            if d_a > 0.0 or pe_a > pe0:
                # overshot (or energy rose): secant/bisect back
                denom = d_a - d_prev
                a_new = (a_prev - d_prev * (a - a_prev) / denom
                         if denom > 0.0 else 0.5 * (a_prev + a))
                a = min(max(a_new, 0.1 * a), 0.9 * a)
            else:
                # still descending at a: try extending toward the cap
                # unless already there
                a_prev, d_prev = a, d_a
                if a >= a_cap * 0.999:
                    break
                a = min(2.0 * a, a_cap)
        if best[1] is None:
            converged = "linesearch"
            break
        pe1, x, f, _ = best
        gg_new = float((f * f).sum())
        dgg = float((f * (f - f0)).sum())   # Polak-Ribiere numerator
        beta = max(0.0, dgg / gg) if gg > 0.0 else 0.0
        h = f + beta * h
        f0 = f
        de = abs(pe1 - pe0)
        pe_scale = abs(pe1 + e_offset) + 1e-30
        pe0 = pe1
        gg = gg_new
        if de <= etol * pe_scale:
            converged = "etol"
            break
    else:
        converged = "maxiter"
    return CGState(x=x, f=f, pe=torch.tensor(pe0, dtype=x0.dtype,
                                             device=x0.device),
                   n_iter=it, n_evals=n_evals, fnorm=gg ** 0.5,
                   converged=converged)


def _cg_probe(force_fn, x, h, a, box, nbr):
    x_a = x + a * h
    pe_a, f_a = force_fn(x_a, box, nbr)
    return pe_a, f_a, x_a, -(f_a * h).sum()


def cg_relax(force_fn, build_nbrs, x0, box, etol=1.0e-6, ftol=1.0e-6,
             max_outer=10, **cg_kw):
    """Outer loop: CG + neighbor rebuild until converged (host-driven)."""
    x = x0
    st = None
    for _ in range(max_outer):
        nbrs = build_nbrs(x, box)
        st = cg_minimize(force_fn, x, box, nbrs.idx, etol=etol, ftol=ftol,
                         **cg_kw)
        x = st.x
        if st.converged in ("etol", "ftol"):
            break
    return x, st
