"""The default reference (check.reference): the ANNP's energy, forces and
virial from per-atom descriptors of a config's reference module
(`reference/<name>.py`, function `descriptors`), the normalised network,
E_i = e_scale * nn(G_i), forces by autograd; `Model`, `evaluate` and
`forces_on` are the hooks a reference module that brings its own model
defines alike.

Runs in float64. The control runs the same code in float32 with every
matrix product's inputs rounded to TF32 (10 mantissa bits) and the sums
kept in float32, which is what TF32 tensor cores compute.
"""
from __future__ import annotations

import numpy as np
import torch

from mdbench import found
from mdbench.reference import neighbors as nb

ACT_LINEAR, ACT_TANH, ACT_SIGMOID, ACT_MTANH, ACT_TTANH = 0, 1, 2, 3, 4


def _round_tf32(t):
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32(torch.autograd.Function):
    """Rounds to TF32 (10 mantissa bits) going forward, and the gradient
    coming back."""

    @staticmethod
    def forward(ctx, t):
        return _round_tf32(t)

    @staticmethod
    def backward(ctx, g):
        return _round_tf32(g)


def tf32(t):
    """t (float32) rounded to the nearest TF32 value."""
    return _TF32.apply(t)


class Precision:
    """float64 (the reference) or TF32 (its control)."""

    def __init__(self, control=False):
        self.control = control
        self.dtype = torch.float32 if control else torch.float64

    def mm(self, a, b):
        if self.control:
            return torch.matmul(tf32(a), tf32(b))
        return torch.matmul(a, b)


def activation(z, flag, style):
    """The reference potentials' activation table (pair_annp.cpp)."""
    if flag == ACT_LINEAR:
        return z
    if flag == ACT_TANH:
        return torch.tanh(z)
    if flag == ACT_SIGMOID:
        return 1.0 / (1.0 + torch.exp(z))
    if style == "fe":
        t = 1.7159 * torch.tanh(0.666666666666667 * z)
        return t if flag == ACT_MTANH else t + 0.1 * z
    return torch.tanh(z)           # ni: flags 3 and 4 are plain tanh



class Model:
    """A potential (the plain dict of potentials.build) in one precision."""

    def __init__(self, pot, device, control=False):
        self.pot = pot
        self.prec = Precision(control)
        dt = self.prec.dtype
        self.desc = found.load("reference", pot["reference"]).descriptors
        r0 = np.asarray(pot["norm_row0"], np.float64)
        r1 = np.asarray(pot["norm_row1"], np.float64)
        if pot["norm_style"] == "gaussian":
            var = r0 - r1 * r1
            scale = np.where(var > 1e-20, 1.0 / np.sqrt(np.maximum(var, 1e-300)),
                             0.0)
            scale[np.sqrt(np.maximum(var, 0.0)) <= 1e-10] = 0.0
            shift = r1
        else:
            scale, shift = 1.0 / (r1 - r0), r0
        self.scale = torch.tensor(scale, dtype=dt, device=device)
        self.shift = torch.tensor(shift, dtype=dt, device=device)
        self.w = [torch.tensor(np.asarray(w), dtype=dt, device=device)
                  for w in pot["weights"]]
        self.b = [torch.tensor(np.asarray(b), dtype=dt, device=device)
                  for b in pot["biases"]]
        self.tables = {k: torch.tensor(np.asarray(pot[k]), dtype=dt,
                                       device=device)
                       for k in ("coerad", "coeang") if k in pot}
        self.cut = float(pot["cutoff"])

    def atom_energy(self, dx, valid):
        """E_i [R] of rows with partner displacements dx [R, W, 3]."""
        g = self.desc(dx, valid, self.pot, self.tables, self.prec)
        h = (g - self.shift) * self.scale
        for w, b, flag in zip(self.w, self.b, self.pot["flagact"]):
            h = activation(self.prec.mm(h, w.T) + b, flag, self.pot["style"])
        return self.pot["e_scale"] * h[:, 0]


# [rows, W, W] entries of one chunk: the angular terms keep some tens of
# such tensors alive for the backward pass (~8 GB in float64)
PAIR_BUDGET = 1 << 24


def evaluate(model, x, box, pbc, rows=None, grad=True, grid=None):
    """E = sum of E_i over `rows` (default all atoms), and with grad the
    forces F = -dE/dx [N, 3] and the pair virial W [3, 3] = -sum over
    rows and partners of dx (x) dE_i/d(dx), symmetrised (dx = x_i - x_j),
    whose forces reach every atom a row touches. Returns (E, F, W);
    F and W are None without grad. Everything in the model's precision;
    E is summed in float64."""
    dt = model.prec.dtype
    x = x.to(dt)
    box = box.to(dt)
    n = x.shape[0]
    grid = grid or nb.Grid(x, box, pbc, model.cut)
    rows = torch.arange(n, device=x.device) if rows is None else rows
    e_tot = torch.zeros((), dtype=torch.float64, device=x.device)
    f = torch.zeros_like(x) if grad else None
    w = torch.zeros(3, 3, dtype=dt, device=x.device) if grad else None
    i0, size = 0, 64
    while i0 < len(rows):
        r = rows[i0:i0 + size]
        i0 += len(r)
        idx, dx, valid = nb.partners(grid, r)
        size = max(64, PAIR_BUDGET // (dx.shape[1] + 8) ** 2)
        if not grad:
            with torch.no_grad():
                e_tot += model.atom_energy(dx, valid).sum().double()
            continue
        dx = dx.detach().requires_grad_(True)
        e = model.atom_energy(dx, valid).sum()
        (g,) = torch.autograd.grad(e, dx)
        g = torch.where(valid[..., None], g, 0.0)
        e_tot += e.detach().double()
        f.index_add_(0, r, -g.sum(1))
        f.index_add_(0, idx.clamp(min=0).reshape(-1), g.reshape(-1, 3))
        w -= torch.einsum("rka,rkb->ab", dx.detach(), g)
    if grad:
        w = 0.5 * (w + w.T)
    return e_tot, f, w


def forces_on(model, x, box, pbc, atoms):
    """The model's forces on `atoms`, from every row they reach."""
    x = x.to(model.prec.dtype)
    box = box.to(model.prec.dtype)
    grid = nb.Grid(x, box, pbc, model.cut)
    idx, _, valid = nb.partners(grid, atoms)
    rows = torch.unique(torch.cat([atoms, idx[valid]]))
    _, f, _ = evaluate(model, x, box, pbc, rows=rows, grid=grid)
    return f[atoms].double()


def descriptors_of(pot, x, box, device, rows=None):
    """Raw descriptors [R, nsf] (numpy, float64) of the rows of a fully
    periodic box x [N, 3], box [3] (numpy): the potential generators'
    normalisation statistics."""
    prec = Precision()
    x = torch.tensor(x, dtype=torch.float64, device=device)
    box = torch.tensor(box, dtype=torch.float64, device=device)
    grid = nb.Grid(x, box, (True, True, True), float(pot["cutoff"]))
    rows = torch.arange(len(x), device=device) if rows is None else \
        torch.as_tensor(rows, device=device)
    tables = {k: torch.tensor(np.asarray(pot[k]), dtype=torch.float64,
                              device=device)
              for k in ("coerad", "coeang") if k in pot}
    _, dx, valid = nb.partners(grid, rows)
    return found.load("reference", pot["reference"]).descriptors(
        dx, valid, pot, tables, prec).cpu().numpy()
