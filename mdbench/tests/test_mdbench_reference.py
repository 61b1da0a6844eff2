"""The float64 reference: its forces against finite differences of its
energy, its energy, forces and virial against the port's CPU path in
float64 on small boxes, and its MD step against the port's Simulator
step."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from mdbench import found, potentials
from mdbench.annp import annp_potential
from mdbench.lattice import lattice
from mdbench.program import Program
from mdbench.reference.integrate import Step
from mdbench.reference.model import Model, evaluate

CPU = torch.device("cpu")
CASES = {"fe-annp": ("bcc", 5, 0.08), "ni-bp": ("fcc", 5, 0.05)}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    name = request.param
    cfg = found.data("configs", name)
    pot = potentials.build(cfg, 9, CPU)
    kind, cells, disp = CASES[name]
    x, box = lattice(kind, cells, cfg["lattice_A"])
    x = x + np.random.default_rng(1).normal(scale=disp, size=x.shape)
    return name, cfg, pot, torch.tensor(x), torch.tensor(box)


def test_forces_are_minus_the_gradient(case):
    _, _, pot, x, box = case
    model = Model(pot, CPU)
    pbc = (True, True, True)
    _, f, _ = evaluate(model, x, box, pbc)
    h = 1e-5
    for atom, axis in ((0, 0), (7, 1), (31, 2)):
        xp, xm = x.clone(), x.clone()
        xp[atom, axis] += h
        xm[atom, axis] -= h
        ep = evaluate(model, xp, box, pbc, grad=False)[0]
        em = evaluate(model, xm, box, pbc, grad=False)[0]
        fd = -(float(ep) - float(em)) / (2 * h)
        assert abs(fd - float(f[atom, axis])) < 1e-6 * max(1.0, abs(fd))


def test_matches_the_port_in_float64(case):
    """E, F and W against FusedAnnp / FusedNi (the kernels' plain
    versions) in float64 on the CPU, through the port's own compaction."""
    name, _, pot, x, box = case
    from meng_zhang_tpu_torch.models.annp import effective_cutoff, make_annp
    from meng_zhang_tpu_torch.system.neighbors import build_neighbors_n2
    ppot = annp_potential(pot)
    mcfg, params = make_annp(ppot, torch.float64, CPU)
    wl = {"k_short": 160, "short_delta": 0.3}
    ev = found.load("paths", "fused_annp" if name == "fe-annp"
                    else "fused_ni").evaluator(mcfg, params, wl)
    rc = effective_cutoff(ppot)
    nbrs = build_neighbors_n2(x, box, rc + 0.5, 200)
    e_p, f_p, w_p = ev.energy_forces(x, box, nbrs.idx)
    e_r, f_r, w_r = evaluate(Model(pot, CPU), x, box, (True, True, True))
    assert abs(float(e_p) - float(e_r)) < 1e-9 * len(x)
    assert float((f_p - f_r).abs().max()) < 1e-9 * float(f_r.abs().max())
    assert float((w_p - w_r).abs().max()) < 1e-9 * float(w_r.abs().max())


@pytest.mark.parametrize("ensemble", ["nve", "nvt", "npt"])
def test_step_matches_the_simulator(ensemble):
    """One step of the port's Simulator in float64 against the reference's
    Step given the Simulator's own forces (sample: every atom)."""
    cfg = found.data("configs", "fe-annp")
    pot = potentials.build(cfg, 2, CPU)
    x, box = lattice("bcc", 6, cfg["lattice_A"])
    x = x + np.random.default_rng(3).normal(scale=0.05, size=x.shape)
    md = {"dt": 0.001, "ensemble": ensemble, "t_target": 300.0,
          "tau_t": 0.1, "tau_p": 1.0, "p_target": [10.0, 0.0, 0.0],
          "p_couple": [True, True, False], "skin": 1.0, "capacity": 200,
          "cell_capacity": 64, "stale_factor": 0.8, "thermo_every": 1,
          "short_every": 1, "virial": "every"}
    wl = {"md": md, "path": "fused_annp", "k_short": 160,
          "short_delta": 0.4, "scene": {"pbc": [True, True, True]}}
    prog = Program(pot, wl, len(x), box, CPU)
    sim = prog.sim
    # the Simulator in float64: masses set the run's dtype
    masses = torch.full((len(x),), float(pot["mass"]), dtype=torch.float64)
    sim2 = type(sim)(sim.force_fn, masses, sim.cfg,
                     short_build=sim.short_build)
    ev = prog.side.evaluator
    from meng_zhang_tpu_torch.models.annp import make_annp
    mcfg, params = make_annp(annp_potential(pot), torch.float64, CPU)
    ev64 = type(ev)(mcfg, params, k_short=160, short_delta=0.4)
    sim2.force_fn = lambda xx, bb, nb, sh: ev64.energy_forces_short(xx, bb,
                                                                   sh)
    sim2.short_build = lambda xx, bb, nb: ev64.compact_short(xx, bb, nb.idx)
    g = torch.Generator().manual_seed(5)
    v = torch.randn(len(x), 3, generator=g, dtype=torch.float64) * 2.0
    st = sim2.init_state(torch.tensor(x), torch.tensor(box), v=v)
    st = st._replace(v_eps=torch.tensor([0.01, -0.02, 0.0],
                                        dtype=torch.float64))
    s1 = sim2.step(st)
    state = {"x": st.x, "v": st.v, "box": st.box, "virial": st.virial,
             "nhc": (st.nhc.xi.tolist(), st.nhc.v_xi.tolist()),
             "v_eps": st.v_eps,
             "baro": (st.baro_nhc.xi.tolist(), st.baro_nhc.v_xi.tolist())}
    step = Step(md, float(pot["mass"]), len(x), state)
    every = torch.arange(len(x))
    xn, boxn = step.first_half(every, st.f, st.f)
    assert float((xn - s1.x).abs().max()) < 1e-12
    assert float((boxn - s1.box).abs().max()) < 1e-12
    step.second_half(s1.f, s1.f, s1.virial)
    assert float((step.vs - s1.v).abs().max()) < 1e-11
    assert float((step.v - s1.v).abs().max()) < 1e-11
    assert np.allclose(step.nhc[1], s1.nhc.v_xi.tolist(), rtol=1e-10,
                       atol=1e-13)
    assert float((step.v_eps - s1.v_eps).abs().max()) < 1e-12
