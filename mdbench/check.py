"""Whether what the timed path produced is correct.

The window's last step is judged against the float64 reference
(`reference/`), which follows the program one step from the program's own
state: it cannot follow a chaotic trajectory from the start. What the
program handed over (`Capture`): the state before the last step (S0) and
after it (S1), the skin list and the short list of S1 with the positions
they were built at, and the program's flags. The numbers compared:

  list_misses  pairs of a seeded sample of rows that the reference's own
               search finds within the skin list's cutoff (rc + skin) at
               its build positions and the list lacks, plus entries of the
               list beyond that cutoff, plus the same for the short list
               (rc + short_delta at its refresh positions); pairs within
               BAND of a cutoff are left out. Exact: limit 0.
  force_gap    max |F - F_ref| over a seeded sample of atoms in S0 and S1,
               over the RMS of the reference's components there (the
               descriptors, the network and the delivery).
  energy_gap   |E - E_ref| / N in S1, eV an atom (every atom's energy).
  virial_gap   where the last step computed the virial: max over the
               entries of |W - W_ref| and the pressure's gap times the
               volume, over N k_B T (every row's pairs): the pressure's
               error over the ideal gas's.
  v_gap        the sample's velocities after the step against the
               reference's advance of S0 (its own forces for the sample;
               the thermostat's and barostat's scalars from every atom,
               kicked with the program's forces): max |dv| / RMS v.
  state_off    positions of every atom, box, barostat and thermostat
               chains after the step, against the same advance of every
               atom with the program's forces: how many lie beyond their
               float32 tolerance (STATE_TOL). Exact: limit 0.
  flags        the program's own alarms: skin-list or short-list overflow,
               the `unsafe` latch, any non-finite output. Limit 0.

The control (`control=True`) puts the reference, computed in TF32, in the
program's place for every number it can produce: the forces, the energy,
the virial and the sample's step.

The reference of a configuration is what `reference(pot)` returns (its
docstring gives the contract): a configuration's reference module may
bring its own model; one that brings none is judged by the ANNP's
(`reference/model.py`).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from mdbench import found
from mdbench.reference import neighbors as nb
from mdbench.reference.integrate import BOLTZ, MVV2E, NKTV2P, Step

BAND = 1.0e-3                # A, either side of a list's cutoff
# float32 tolerances of the step's other outputs: x within 2^-20 (|x| + 1)
# A (8 ulps), the box 1e-5 relative, v_eps and the chains 1e-3 relative
# plus 1e-6 absolute
STATE_TOL = {"x": 2.0 ** -20, "box": 1.0e-5, "rel": 1.0e-3, "abs": 1.0e-6}


class Capture:
    """What the program produced, as tensors (see the module docstring)."""

    def __init__(self, s0, s1, press1, flags):
        self.s0, self.s1, self.press1, self.flags = s0, s1, press1, flags


def seeded(n, k, seed, salt):
    g = torch.Generator()
    g.manual_seed((int(seed) * 1000003 + salt) % (1 << 62))
    return torch.randperm(n, generator=g)[:min(k, n)]


def list_misses(x_ref, box, pbc, idx, cutoff, rows):
    """Pairs the list idx [N, K] (sentinel N) misses or holds wrongly, on
    `rows`, against the reference's search at positions x_ref."""
    x = x_ref.double()
    box = box.double()
    n = x.shape[0]
    grid = nb.Grid(x, box, pbc, cutoff + BAND)
    ref, dx, valid = nb.partners(grid, rows)
    r = dx.norm(dim=-1)
    local = torch.arange(len(rows), device=x.device)[:, None]
    must = (local * (n + 1) + ref)[valid & (r < cutoff - BAND)]
    may = (local * (n + 1) + ref)[valid]
    prog = idx[rows].to(x.device)
    held = (local * (n + 1) + prog)[prog < n]
    missing = int((~torch.isin(must, held)).sum())
    wrong = int((~torch.isin(held, may)).sum())
    twice = held.numel() - torch.unique(held).numel()
    return missing + wrong + twice


class Reference(NamedTuple):
    """A configuration's reference: the hooks of `reference(pot)`."""
    Model: type
    evaluate: Callable
    forces_on: Callable


HOOKS = Reference._fields


def reference(pot):
    """The reference that judges a configuration, from its reference
    module (`reference/<pot["reference"]>.py`), which may define

      Model(pot, device, control=False)
            the potential in float64; with control=True the control, the
            same computed in the next precision below the configuration's
            (TF32 for float32);
      evaluate(model, x, box, pbc, grad=True)
            -> (E, F [N, 3], W [3, 3]) over every atom: E summed in
            float64; F the forces the program must match; W the virial,
            symmetrised: W_ab = sum of dx_a f_b over each term of a pair,
            dx = x_i - x_j and f the term's force on i; F and W None
            with grad=False;
      forces_on(model, x, box, pbc, atoms)
            -> the exact forces [len(atoms), 3] (float64) on `atoms`,
            taking whatever rows they need (one shell of partners where
            an atom's force reads its partners' energies, two where it
            reads fields that read theirs).

    F is whatever the published potential defines as the force: -dE/dx
    for the ANNPs; for a potential whose forces are not -dE/dx the
    reference computes the published force formula itself. A module
    defines all three or none; with none, `reference/model.py`'s (the
    ANNP: E_i = e_scale * nn(G_i) from the module's `descriptors`, forces
    by autograd, a sample's forces from one shell of rows) judge it."""
    mod = found.load("reference", pot["reference"])
    own = [k for k in HOOKS if hasattr(mod, k)]
    if own and len(own) < len(HOOKS):
        raise ValueError(f"reference/{pot['reference']}.py defines "
                         f"{', '.join(own)} but not all of "
                         f"{', '.join(HOOKS)}")
    if not own:
        from mdbench.reference import model as mod
    return Reference(*(getattr(mod, k) for k in HOOKS))


def _press(v, mass, w, box):
    kin = mass * MVV2E * (v * v).sum(0)
    return float((kin.cpu() + torch.diagonal(w.cpu())).sum()) / 3.0 \
        / float(box.prod()) * NKTV2P


def _state(s, dev):
    """A captured state as the reference's float64 tensors and lists."""
    return {"x": s["x"].double().to(dev), "v": s["v"].double().to(dev),
            "box": s["box"].double().cpu(),
            "virial": s["virial"].double().cpu(),
            "nhc": tuple(t.double().cpu().tolist() for t in s["nhc"]),
            "v_eps": s["v_eps"].double().cpu(),
            "baro": tuple(t.double().cpu().tolist() for t in s["baro"])}


def numbers(cap, pot, wl, seed, device, control=False, ref=None):
    """{name: value} of the comparison (module docstring); `ref`, a float64
    model of `reference(pot)` to reuse. With control=True, the control's
    numbers."""
    ck, md = wl["check"], wl["md"]
    pbc = tuple(wl["scene"]["pbc"])
    hooks = reference(pot)
    evaluate, forces_on = hooks.evaluate, hooks.forces_on
    ref = ref or hooks.Model(pot, device)
    s0, s1 = cap.s0, cap.s1
    n = s1["x"].shape[0]
    atoms = seeded(n, ck["atoms"], seed, 1).to(device)
    x0, x1 = s0["x"].double(), s1["x"].double()
    b0, b1 = s0["box"].double(), s1["box"].double()
    virial = md.get("virial", "every") != "never"
    out = {}
    if not control:
        rows = seeded(n, ck["list_rows"], seed, 2).to(device)
        rc = float(pot["cutoff"])
        out["list_misses"] = (
            list_misses(s1["nbrs_x"], s1["nbrs_box"], pbc, s1["nbrs_idx"],
                        rc + md["skin"], rows)
            + list_misses(s1["short_x"], s1["short_box"], pbc,
                          s1["short_idx"], rc + wl["short_delta"], rows))
    fr0 = forces_on(ref, x0, b0, pbc, atoms)
    if virial:
        e1, f_all, w1 = evaluate(ref, x1, b1, pbc)
        fr1 = f_all[atoms]
        del f_all
    else:
        fr1 = forces_on(ref, x1, b1, pbc, atoms)
        e1, _, _ = evaluate(ref, x1, b1, pbc, grad=False)
        w1 = None
    if control:
        ctl = hooks.Model(pot, device, control=True)
        fp0 = forces_on(ctl, x0, b0, pbc, atoms)
        if virial:
            ep1, f_all, wp1 = evaluate(ctl, x1, b1, pbc)
            fp1 = f_all[atoms].double()
            wp1 = wp1.double()
            del f_all
        else:
            fp1 = forces_on(ctl, x1, b1, pbc, atoms)
            ep1, _, _ = evaluate(ctl, x1, b1, pbc, grad=False)
    else:
        fp0 = s0["f"][atoms].double()
        fp1 = s1["f"][atoms].double()
        ep1 = s1["pe"].double()
        wp1 = s1["virial"].double() if virial else None
    fref = torch.cat([fr0, fr1])
    out["force_gap"] = float((torch.cat([fp0, fp1]) - fref).abs().max()
                             / fref.pow(2).mean().sqrt())
    out["energy_gap"] = abs(float(ep1) - float(e1)) / n
    if virial:
        mass = float(pot["mass"])
        v1 = s1["v"].double()
        press_r = _press(v1, mass, w1, b1)
        press_p = _press(v1, mass, wp1, b1) if control else cap.press1
        gap = max(float((wp1.cpu() - w1.cpu()).abs().max()),
                  abs(press_p - press_r) * float(b1.prod()) / NKTV2P)
        out["virial_gap"] = gap / (n * BOLTZ * md["t_target"])

    mass = float(pot["mass"])
    st0 = _state(s0, device)
    step = Step(md, mass, n, st0)
    f0_all, f1_all = s0["f"].double(), s1["f"].double()
    x_new, box_new = step.first_half(atoms, f0_all, fr0)
    w_new = s1["virial"].double() if virial else torch.zeros(3, 3,
                                                            dtype=torch.float64)
    step.second_half(f1_all, fr1, w_new)
    v_ref = step.vs
    if control:
        cstep = Step(md, mass, n, st0)
        cstep.first_half(atoms, f0_all, fp0)
        cstep.second_half(f1_all, fp1, w_new)
        v_prog = cstep.vs
    else:
        v_prog = s1["v"][atoms].double()
    out["v_gap"] = float((v_prog - v_ref).abs().max()
                         / v_ref.pow(2).mean().sqrt())
    if not control:
        out["state_off"], worst = state_off(s1, x_new, box_new, step)
        out["flags"] = int(sum(bool(f) for f in cap.flags.values()))
        out["_state_worst"] = worst
    return out


def state_off(s1, x_new, box_new, step):
    """(outputs of the step beyond tolerance, the worst gap over its
    tolerance)."""
    tol = STATE_TOL
    pairs = [(s1["x"].double(), x_new,
              tol["x"] * (x_new.abs() + 1.0)),
             (s1["box"].double().cpu(), box_new,
              tol["box"] * box_new.abs())]
    for got, want in ((s1["v_eps"], step.v_eps),
                      (s1["nhc"][0], step.nhc[0]), (s1["nhc"][1], step.nhc[1]),
                      (s1["baro"][0], step.baro[0]),
                      (s1["baro"][1], step.baro[1])):
        want = torch.as_tensor(want, dtype=torch.float64)
        pairs.append((got.double().cpu(), want,
                      tol["rel"] * want.abs() + tol["abs"]))
    off, worst = 0, 0.0
    for got, want, t in pairs:
        gap = (got.to(want.device) - want).abs()
        ratio = gap / t.to(want.device)
        off += int((~(ratio <= 1.0)).sum())
        worst = max(worst, float(ratio.max()) if ratio.numel() else 0.0)
    return off, worst


def verdict(values, limits):
    """(correct, {name: {"value", "limit"}}, failed names): a number passes
    when it is finite and no larger than its limit."""
    table, failed = {}, []
    for name, value in values.items():
        if name.startswith("_"):
            continue
        limit = limits[name]
        table[name] = {"value": value, "limit": limit}
        if not (isinstance(value, (int, float)) and math.isfinite(value)
                and value <= limit):
            failed.append(name)
    return not failed, table, failed
