"""The port's integrators and MD driver against the JAX package.

Both drivers run the short-list path (refresh every `short_every` steps,
Pallas interpret mode on the JAX side, the plain harmonic path in the port)
from the same numpy positions and velocities, in f64 at reduced width.
Tolerances: the force evaluations agree to rounding (summation order:
`index_add_` against a sort), and 10 steps do not amplify that beyond a few
ulps: positions and forces atol 1e-9 (A, eV/A), thermo rtol 1e-9.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu.md import integrate as JI
from meng_zhang_tpu.md import simulation as JS
from meng_zhang_tpu.models.annp import make_annp as jax_make_annp
from meng_zhang_tpu.ops.pallas_annp import PallasAnnp
from meng_zhang_tpu.units import MASS_FE
from meng_zhang_tpu_torch.md import integrate as I
from meng_zhang_tpu_torch.md import simulation as S
from meng_zhang_tpu_torch.models.annp import make_annp
from meng_zhang_tpu_torch.ops import fused_annp as fa
from torch_port_util import perturbed_bcc, reduced_potential, t64

RTOL, ATOL = 1e-9, 1e-9
CUT, KS = 4.0, 48


def _np(a):
    return np.asarray(a, dtype=np.float64)


def test_integrate_matches_jax():
    rng = np.random.default_rng(0)
    n = 40
    v = rng.normal(size=(n, 3)) * 5.0
    f = rng.normal(size=(n, 3))
    x = rng.uniform(0.0, 10.0, (n, 3))
    m = rng.uniform(20.0, 60.0, n)
    vt, ft, xt, mt = t64(v), t64(f), t64(x), t64(m)
    vj, fj, xj, mj = (jnp.asarray(a) for a in (v, f, x, m))
    np.testing.assert_allclose(float(I.kinetic_energy(vt, mt)),
                               float(JI.kinetic_energy(vj, mj)), rtol=1e-14)
    np.testing.assert_allclose(float(I.temperature(vt, mt, 3 * n - 3)),
                               float(JI.temperature(vj, mj, 3 * n - 3)),
                               rtol=1e-14)
    np.testing.assert_allclose(I.remove_drift(vt, mt).numpy(),
                               _np(JI.remove_drift(vj, mj)), atol=1e-13)
    np.testing.assert_allclose(I.vv_kick(vt, ft, mt, 5e-4).numpy(),
                               _np(JI.vv_kick(vj, fj, mj, 5e-4)), rtol=1e-14)
    np.testing.assert_allclose(I.vv_drift(xt, vt, 1e-3).numpy(),
                               _np(JI.vv_drift(xj, vj, 1e-3)), rtol=1e-14)
    for chain in (1, 3):
        q = I.nhc_masses(3 * n - 3, 300.0, 0.1, chain, torch.float64)
        qj = JI.nhc_masses(3 * n - 3, 300.0, 0.1, chain, jnp.float64)
        np.testing.assert_allclose(q.numpy(), _np(qj), rtol=1e-14)
        nhc = I.NHCState(t64(rng.normal(size=chain)),
                         t64(rng.normal(size=chain)))
        nhcj = JI.NHCState(jnp.asarray(nhc.xi.numpy()),
                           jnp.asarray(nhc.v_xi.numpy()))
        v1, s1 = I.nhc_step(vt, mt, nhc, q, 300.0, 3 * n - 3, 1e-3)
        v2, s2 = JI.nhc_step(vj, mj, nhcj, qj, 300.0, 3 * n - 3, 1e-3)
        np.testing.assert_allclose(v1.numpy(), _np(v2), rtol=1e-13)
        np.testing.assert_allclose(s1.xi.numpy(), _np(s2.xi), rtol=1e-13)
        np.testing.assert_allclose(s1.v_xi.numpy(), _np(s2.v_xi),
                                   rtol=1e-13)
        np.testing.assert_allclose(
            float(I.nhc_conserved(s1, q, 300.0, 3 * n - 3)),
            float(JI.nhc_conserved(s2, qj, 300.0, 3 * n - 3)), rtol=1e-13)
    np.testing.assert_allclose(
        float(I.npt_baro_masses(n, 300.0, 1.0, torch.float64)),
        float(JI.npt_baro_masses(n, 300.0, 1.0, jnp.float64)), rtol=1e-14)
    veps = rng.normal(size=3) * 0.1
    couple = np.array([0.0, 1.0, 0.0])
    np.testing.assert_allclose(
        S.npt_drift_vcoef(t64(veps), t64(couple), 1e-3).numpy(),
        _np(JS.npt_drift_vcoef(jnp.asarray(veps), jnp.asarray(couple),
                               1e-3)), rtol=1e-14)


def test_langevin_ou_uses_generator():
    """Same formula as the JAX function, with the normal draws taken from the
    given torch.Generator (JAX draws from its own key stream)."""
    rng = np.random.default_rng(1)
    v, m = t64(rng.normal(size=(30, 3))), t64(rng.uniform(20, 60, 30))
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    got = I.langevin_ou(v, m, g1, 300.0, 0.1, 1e-3)
    noise = torch.randn(v.shape, generator=g2, dtype=torch.float64)
    c1 = np.exp(-1e-3 / 0.1)
    sigma = np.sqrt(JI.BOLTZ * 300.0 / (m.numpy()[:, None] * JI.MVV2E))
    want = c1 * v.numpy() + np.sqrt(1 - c1 * c1) * sigma * noise.numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-14)


def _configs(ensemble, pbc):
    common = dict(dt=0.001, cutoff=CUT, skin=0.8, capacity=64,
                  nbr_method="n2", ensemble=ensemble, t_target=300.0,
                  tau_t=0.05, p_target=(0.0,) * 3, tau_p=0.5,
                  thermo_every=5, pbc=pbc, short_every=5, short_skin=0.4)
    couple = (False, True, False) if ensemble == "npt" else (False,) * 3
    return (JS.MDConfig(p_couple=couple, **common),
            S.MDConfig(p_couple=couple, **common))


@pytest.mark.parametrize("ensemble,pbc", [
    ("nve", (True, True, True)),
    ("nvt", (True, True, True)),
    ("npt", (False, True, False)),
])
def test_trajectory_matches_jax(ensemble, pbc):
    """10 steps (two thermo blocks, two short-list refreshes) of both
    Simulators on the short path; the NPT run is the benchmark's layout:
    `boundary m p m` with a y-coupled barostat."""
    pot = reduced_potential(cut=CUT)
    x, box = perturbed_bcc((4, 5, 4), seed=3, disp=0.08)
    n = len(x)
    rng = np.random.default_rng(4)
    v = rng.normal(scale=4.0, size=(n, 3))
    v -= v.mean(0)
    jcfg, jmc = _configs(ensemble, pbc)

    jc, jp = jax_make_annp(pot, dtype=jnp.float64, pbc=pbc)
    pk = PallasAnnp(jc, jp, k_short=KS, short_delta=0.4)
    jsim = JS.Simulator(
        lambda xx, bb, nb, sh: pk.energy_forces_short(
            xx, bb, sh, want_virial=True, shift=False),
        jnp.full(n, MASS_FE, jnp.float64), jcfg,
        short_build=lambda xx, bb, nb: pk.compact_short(xx, bb, nb.idx, None))
    js = jsim.init_state(jnp.asarray(x), jnp.asarray(box), v=jnp.asarray(v))
    js, jth = jsim.run(js, 2)

    cfg, params = make_annp(pot, torch.float64, pbc=pbc)
    ev = fa.FusedAnnp(cfg, params, k_short=KS, short_delta=0.4)
    sim = S.Simulator(
        lambda xx, bb, nb, sh: ev.energy_forces_short(xx, bb, sh),
        torch.full((n,), MASS_FE, dtype=torch.float64), jmc,
        short_build=lambda xx, bb, nb: ev.compact_short(xx, bb, nb.idx))
    st = sim.init_state(t64(x), t64(box), v=t64(v))
    st, th = sim.run(st, 2)

    np.testing.assert_allclose(st.x.numpy(), _np(js.x), rtol=0, atol=ATOL)
    np.testing.assert_allclose(st.v.numpy(), _np(js.v), rtol=0, atol=ATOL)
    np.testing.assert_allclose(st.f.numpy(), _np(js.f), rtol=0, atol=ATOL)
    np.testing.assert_allclose(st.box.numpy(), _np(js.box), rtol=1e-13)
    for name in S.Thermo._fields:
        np.testing.assert_allclose(getattr(th, name).numpy(),
                                   _np(getattr(jth, name)), rtol=RTOL,
                                   atol=1e-9, err_msg=name)
    assert int(st.step) == int(js.step) == 10
    for flag in ("overflow", "stale", "unsafe"):
        assert bool(getattr(st, flag)) == bool(getattr(js, flag))
    assert not bool(st.unsafe) and not bool(st.overflow)
    if ensemble == "npt":
        assert float(st.box[1]) != box[1]          # the barostat moved y
        np.testing.assert_allclose(st.v_eps.numpy(), _np(js.v_eps),
                                   rtol=1e-8, atol=1e-14)


def test_rebuild_and_flags():
    """A hot block flags the skin list stale; run() rebuilds it at the block
    end (one bool read per block) and the rebuilt list equals a fresh
    build. Asking for the unported JAX options raises."""
    pot = reduced_potential(cut=CUT)
    x, box = perturbed_bcc(4, seed=9, disp=0.05)
    n = len(x)
    cfg, params = make_annp(pot, torch.float64)
    ev = fa.FusedAnnp(cfg, params, k_short=KS, short_delta=0.4)
    mc = S.MDConfig(dt=0.001, cutoff=CUT, skin=0.2, capacity=64,
                    nbr_method="n2", ensemble="nve", thermo_every=5,
                    short_every=5, short_skin=0.4)
    sim = S.Simulator(
        lambda xx, bb, nb, sh: ev.energy_forces_short(xx, bb, sh),
        torch.full((n,), MASS_FE, dtype=torch.float64), mc,
        short_build=lambda xx, bb, nb: ev.compact_short(xx, bb, nb.idx))
    st = sim.init_state(t64(x), t64(box), seed=2, t_init=3000.0)
    st, th = sim.run(st, 2)
    assert sim.rebuild_count >= 1
    assert torch.isfinite(th.temp).all()
    st = sim.rebuild(st)
    assert torch.equal(st.nbrs.idx, sim.build_nbrs(st.x, st.box).idx)
    assert not bool(st.stale) and st.short.ref_x is st.x
    with pytest.raises(NotImplementedError):
        S.Simulator(sim.force_fn, sim.masses, mc, short_build=sim.short_build,
                    force_fn_light=sim.force_fn)
    with pytest.raises(NotImplementedError):
        S.Simulator(sim.force_fn, sim.masses,
                    S.MDConfig(dt=0.001, cutoff=CUT, short_host_refresh=True))


def test_create_velocities_seeded():
    m = torch.full((64,), MASS_FE, dtype=torch.float64)
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    v1 = S.create_velocities(g1, m, 300.0, torch.float64)
    v2 = S.create_velocities(g2, m, 300.0, torch.float64)
    assert torch.equal(v1, v2)
    assert float(I.temperature(v1, m, 3 * 64 - 3)) == pytest.approx(300.0)
    assert float((m[:, None] * v1).sum(0).abs().max()) < 1e-11


def test_langevin_run_is_seeded():
    """The Langevin noise comes from the state's torch.Generator, seeded by
    init_state: equal seeds give equal trajectories."""
    pot = reduced_potential(cut=CUT)
    x, box = perturbed_bcc(4, seed=10, disp=0.05)
    n = len(x)
    cfg, params = make_annp(pot, torch.float64)
    ev = fa.FusedAnnp(cfg, params, k_short=KS, short_delta=0.4)
    mc = S.MDConfig(dt=0.001, cutoff=CUT, skin=0.8, capacity=64,
                    nbr_method="n2", ensemble="langevin", damp=0.05,
                    thermo_every=5, short_every=5, short_skin=0.4)
    runs = []
    for _ in range(2):
        sim = S.Simulator(
            lambda xx, bb, nb, sh: ev.energy_forces_short(xx, bb, sh),
            torch.full((n,), MASS_FE, dtype=torch.float64), mc,
            short_build=lambda xx, bb, nb: ev.compact_short(xx, bb, nb.idx))
        st = sim.init_state(t64(x), t64(box), seed=8)
        runs.append(sim.run(st, 2))
    (s1, t1), (s2, t2) = runs
    assert torch.equal(s1.x, s2.x) and torch.equal(t1.temp, t2.temp)
    assert torch.isfinite(t1.conserved).all()
