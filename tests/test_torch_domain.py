"""The 1-D slab driver (meng_zhang_tpu_torch/parallel/domain.py): the port's
D shards on the in-process mesh against its own single-device evaluation and
Simulator, and against the JAX package's ShardedMD on the 8-device CPU mesh
(tests/conftest.py), all in f64 on the CPU, on the synthetic potentials at
reduced width (tests/test_multichip.py's cases as the checklist; no
reference file).

  * `_auto_geometry` and `_plan_frame` equal to JAX's (halo_b, capacity,
    frame width, cell grid), periodic and `m p m` x;
  * 1-vs-D (D = 2, 4) forces, PE and W of every adapter, periodic and
    non-periodic x, against the single-device evaluation: rtol 1e-9 (E),
    1e-9 of max |F| and max |W|;
  * NVE, NVT and y-coupled NPT thermo of 4 shards against the port's
    Simulator (rtol 1e-8, pressure 1e-6, the box 1e-10: the JAX test's
    bars), NPT also on the benchmark's `m p m`;
  * a hot run with in-run rebuilds on the ni potential, against the
    Simulator;
  * an undersized halo_b trips OVF_COVERAGE, on 2 and on 4 shards;
  * `migrate` against JAX's on the same state: x, v, f and gid exactly;
  * ANNA-ADP sharded forces (both frame paths) against one device;
  * each adapter end to end against JAX's ShardedMD over a few steps:
    thermo rtol 1e-9, positions atol 1e-9 A;
  * the cell-list build accepts rows outside [0, L) along a non-periodic
    axis as the JAX build does (the frame build of the parked halos'
    shards).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu.models import anna_adp as JA
from meng_zhang_tpu.models import annp as jannp
from meng_zhang_tpu.ops.pallas_annp import PallasAnnp
from meng_zhang_tpu.ops.pallas_ni import PallasNi
from meng_zhang_tpu.parallel import domain as JD
from meng_zhang_tpu.system import neighbors as JN
from meng_zhang_tpu_torch.models import anna_adp as A
from meng_zhang_tpu_torch.models import annp
from meng_zhang_tpu_torch.ops import fused_annp as fa
from meng_zhang_tpu_torch.ops import fused_ni as fn
from meng_zhang_tpu_torch.parallel import domain as D
from meng_zhang_tpu_torch.system.neighbors import (build_neighbors_cell,
                                                   build_neighbors_n2)
from meng_zhang_tpu_torch.testing import synthetic_anna_potential, thermal_fcc
from meng_zhang_tpu_torch.units import MASS_FE
from torch_port_util import (chunked_simulator, perturbed_bcc,
                             reduced_ni_potential, reduced_potential,
                             rel_max, t64, thermal_velocities)

M_NI = 58.6934
SKIN = 0.5
MPM = (False, True, False)


@functools.cache
def _fe(pbc=(True, True, True), cut=4.0):
    x, box = perturbed_bcc((16, 4, 4), seed=11, disp=0.04)    # 512 atoms
    pot = reduced_potential(cut=cut)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu", pbc=pbc)
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64, pbc=pbc)
    return x, box, cfg, params, jcfg, jparams


@functools.cache
def _ni():
    x, box = thermal_fcc((16, 4, 4), seed=11, disp=0.02)      # 1024 atoms
    pot = reduced_ni_potential()
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64)
    return x, box, cfg, params, jcfg, jparams


def _scfg(n, n_dev, cut, **kw):
    return D.ShardConfig(n_devices=n_dev, c_loc=n // n_dev, cutoff=cut,
                         skin=kw.pop("skin", SKIN), dt=0.001, **kw)


def _single(cfg, params, x, box):
    """(E shift-free, F, W) of the whole box through the fused evaluator."""
    rc = annp.descriptor_cutoff(cfg, params)
    nb = build_neighbors_n2(t64(x), t64(box), rc + SKIN, 64, cfg.pbc)
    assert not bool(nb.overflow)
    return annp.energy_forces_virial_chunked(cfg, params, t64(x), t64(box),
                                             nb.idx, shift=False)


def _global(st, order):
    """Forces in the original atom order."""
    return st.f_loc.reshape(-1, 3)[torch.argsort(order)]


def _adapter(kind, cfg, params, k_short=32):
    if kind == "annp":
        return D.AnnpFrameModel(fa.FusedAnnp(cfg, params, k_short=k_short,
                                             short_delta=0.4))
    if kind == "short":
        return D.FrameShortModel(fa.FusedAnnp(cfg, params, k_short=k_short,
                                              short_delta=0.4))
    if kind == "short-ni":
        return D.FrameShortModel(fn.FusedNi(cfg, params, k_short=k_short,
                                            short_delta=0.4))
    return D.XlaFrameModel(cfg, params)


# ------------------------------------------------------------ geometry
@pytest.mark.parametrize("n_dev,pbc,halo_b", [
    (2, (True, True, True), None), (4, (True, True, True), None),
    (4, MPM, None), (2, MPM, None),
    (4, (True, True, True), 96)])
def test_auto_geometry_matches_jax(n_dev, pbc, halo_b):
    x, box, cfg, params, jcfg, jparams = _fe()
    n = len(x)
    kw = dict(pbc=pbc, halo_b=halo_b, ensemble="npt")
    got = D.ShardedMD(D.XlaFrameModel(cfg, params), MASS_FE, box,
                      _scfg(n, n_dev, 4.0, **kw), device="cpu")
    want = JD.ShardedMD(JD.XlaFrameModel(jcfg, jparams), MASS_FE, box,
                        _scfg_j(n, n_dev, 4.0, **kw))
    xs = np.sort(x[:, 0])
    for md in (got, want):
        md._auto_geometry(xs, box)
        md._plan_frame(xs, box)
    assert (got.cfg.halo_b, got.cfg.capacity) == (want.cfg.halo_b,
                                                  want.cfg.capacity)
    assert got.frame_wx == want.frame_wx
    assert got.frame_dims == want.frame_dims


def _scfg_j(n, n_dev, cut, **kw):
    return JD.ShardConfig(n_devices=n_dev, c_loc=n // n_dev, cutoff=cut,
                          skin=kw.pop("skin", SKIN), dt=0.001, **kw)


def test_auto_geometry_too_thin_raises_as_jax():
    """8 slabs of 64 rows cannot hold the halo that rlist 6 A needs."""
    x, box, cfg, params, jcfg, jparams = _fe()
    xs = np.sort(x[:, 0])
    for md in (D.ShardedMD(D.XlaFrameModel(cfg, params), MASS_FE, box,
                           _scfg(len(x), 8, 4.0, skin=2.0), device="cpu"),
               JD.ShardedMD(JD.XlaFrameModel(jcfg, jparams), MASS_FE, box,
                            _scfg_j(len(x), 8, 4.0, skin=2.0))):
        with pytest.raises(ValueError, match="too thin"):
            md._auto_geometry(xs, box)


# ----------------------------------------------------- 1 vs D shards
@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("kind,pbc", [
    ("annp", (True, True, True)), ("short", (True, True, True)),
    ("xla", (True, True, True)), ("short", MPM), ("xla", MPM)])
def test_sharded_matches_single_device(n_dev, kind, pbc):
    x, box, cfg, params, _, _ = _fe(pbc)
    e, f, w = _single(cfg, params, x, box)
    md = D.ShardedMD(_adapter(kind, cfg, params), MASS_FE, box,
                     _scfg(len(x), n_dev, 4.0, pbc=pbc), device="cpu")
    st, order = md.distribute(t64(x))
    assert not bool(st.overflow.any()), st.overflow
    np.testing.assert_allclose(float(st.pe.sum()), float(e), rtol=1e-9)
    assert rel_max(_global(st, order), f) <= 1e-9
    assert rel_max(st.virial, w) <= 1e-9
    np.testing.assert_array_equal(
        md.gather_positions(st).numpy(), x)


def test_sharded_ni_matches_single_device():
    x, box, cfg, params, _, _ = _ni()
    e, f, w = _single(cfg, params, x, box)
    md = D.ShardedMD(_adapter("short-ni", cfg, params), M_NI, box,
                     _scfg(len(x), 4, annp.descriptor_cutoff(cfg, params)),
                     device="cpu")
    st, order = md.distribute(t64(x))
    assert not bool(st.overflow.any())
    np.testing.assert_allclose(float(st.pe.sum()), float(e), rtol=1e-9)
    assert rel_max(_global(st, order), f) <= 1e-9
    assert rel_max(st.virial, w) <= 1e-9


@pytest.mark.parametrize("n_dev,fast", [(2, True), (4, True), (4, False)])
def test_sharded_anna_matches_single_device(n_dev, fast):
    x, box = perturbed_bcc((24, 4, 4), seed=4, disp=0.05)     # 768 atoms
    cfg, params = A.make_anna(synthetic_anna_potential(0, npsf=4, ntsf=5,
                                                       nnod=6),
                              torch.float64, "cpu")
    nb = build_neighbors_n2(t64(x), t64(box), cfg.cut + SKIN, 80)
    e, f, w = A.energy_forces_virial(cfg, params, t64(x), t64(box), nb.idx,
                                     shift=False)
    md = D.ShardedMD(D.AnnaFrameModel(cfg, params, fast=fast), MASS_FE, box,
                     _scfg(len(x), n_dev, cfg.cut, capacity=80),
                     device="cpu")
    st, order = md.distribute(t64(x))
    assert not bool(st.overflow.any())
    np.testing.assert_allclose(float(st.pe.sum()), float(e), rtol=1e-9)
    assert rel_max(_global(st, order), f) <= 1e-9
    assert rel_max(st.virial, w) <= 1e-9


@pytest.mark.parametrize("n_dev", [2, 4])
def test_undersized_halo_trips_coverage_proof(n_dev):
    x, box, cfg, params, _, _ = _fe()
    md = D.ShardedMD(_adapter("xla", cfg, params), MASS_FE, box,
                     _scfg(len(x), n_dev, 4.0, halo_b=32, capacity=48),
                     device="cpu")
    st, _ = md.distribute(t64(x))
    assert bool((st.overflow & D.OVF_COVERAGE).any())
    # and the derived halo passes it
    md = D.ShardedMD(_adapter("xla", cfg, params), MASS_FE, box,
                     _scfg(len(x), n_dev, 4.0), device="cpu")
    assert not bool(md.distribute(t64(x))[0].overflow.any())


# ------------------------------------------------------------ dynamics
def _simulator(cfg, params, x, box, ensemble, thermo_every=5,
               mass=MASS_FE, **kw):
    return chunked_simulator(cfg, params, len(x), ensemble, mass,
                             thermo_every, **kw)


NPT = {"p_target": (0.0,) * 3, "p_couple": (False, True, False),
       "tau_p": 1.0}


@pytest.mark.parametrize("ensemble,kw,pbc", [
    ("nve", {}, (True, True, True)),
    ("nvt", {"t_target": 50.0, "tau_t": 0.1}, (True, True, True)),
    ("npt", dict(NPT, t_target=50.0, tau_t=0.1), (True, True, True)),
    ("npt", dict(NPT, t_target=50.0, tau_t=0.1), MPM)],
    ids=["nve", "nvt", "npt", "npt-mpm"])
def test_thermo_matches_simulator(ensemble, kw, pbc):
    x, box, cfg, params, _, _ = _fe(pbc)
    n = len(x)
    v0 = thermal_velocities(n, 50.0, MASS_FE, 7)
    sim = _simulator(cfg, params, x, box, ensemble, **kw)
    s1 = sim.init_state(t64(x), t64(box), v=t64(v0))
    s1, th1 = sim.run(s1, 4)
    md = D.ShardedMD(D.XlaFrameModel(cfg, params), MASS_FE, box,
                     _scfg(n, 4, 4.0, ensemble=ensemble, thermo_every=5,
                           pbc=pbc, **kw), device="cpu")
    st, _ = md.distribute(t64(x), t64(v0))
    st, th = md.run(st, 4)
    assert not bool(st.overflow.any()) and not bool(st.unsafe.any())
    np.testing.assert_allclose(th.temp.numpy(), th1.temp.numpy(), rtol=1e-8)
    np.testing.assert_allclose(th.pe.numpy(), th1.pe.numpy(), rtol=1e-8)
    np.testing.assert_allclose(th.press.numpy(), th1.press.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(th.conserved.numpy(), th1.conserved.numpy(),
                               rtol=1e-8)
    np.testing.assert_allclose(st.box.numpy(), s1.box.numpy(), rtol=1e-10)
    assert rel_max(md.gather_positions(st), s1.x) <= 1e-9


def test_inrun_rebuild_matches_simulator():
    """A hot NVE run on the ni potential (its descriptors vanish at 2.9 A,
    so the scene is cheap and stays solid at 600 K) long enough to trip
    staleness: the per-shard rebuilds fire and the run stays on the
    single-device track."""
    x, box, cfg, params, _, _ = _ni()
    n = len(x)
    v0 = thermal_velocities(n, 600.0, M_NI, 3)
    rc = annp.descriptor_cutoff(cfg, params)
    sim = _simulator(cfg, params, x, box, "nve", thermo_every=4, skin=0.3,
                     mass=M_NI)
    s1 = sim.init_state(t64(x), t64(box), v=t64(v0))
    s1, th1 = sim.run(s1, 12)
    assert sim.rebuild_count >= 1 and not bool(s1.unsafe)
    md = D.ShardedMD(_adapter("short-ni", cfg, params), M_NI, box,
                     _scfg(n, 4, rc, skin=0.3, thermo_every=4),
                     device="cpu")
    st, _ = md.distribute(t64(x), t64(v0))
    st, th = md.run(st, 12)
    assert md.rebuild_count >= 1
    assert not bool(st.overflow.any()) and not bool(st.unsafe.any())
    np.testing.assert_allclose(th.pe.numpy(), th1.pe.numpy(), rtol=1e-8)
    np.testing.assert_allclose(th.temp.numpy(), th1.temp.numpy(), rtol=1e-8)


def test_block_by_block_equals_one_run():
    """run(st, 1) called block by block refreshes the frame short list at
    every block boundary exactly as one run(st, n) does."""
    x, box, cfg, params, _, _ = _fe()
    n = len(x)
    v0 = t64(thermal_velocities(n, 300.0, MASS_FE, 8))
    md = D.ShardedMD(_adapter("short", cfg, params), MASS_FE, box,
                     _scfg(n, 4, 4.0, thermo_every=3), device="cpu")
    st1, th1 = md.run(md.distribute(t64(x), v0)[0], 4)
    st2 = md.distribute(t64(x), v0)[0]
    temps = []
    for _ in range(4):
        st2, th = md.run(st2, 1)
        temps.append(float(th.temp[0]))
    assert temps == th1.temp.tolist()
    assert torch.equal(st1.x_loc, st2.x_loc)
    assert torch.equal(st1.short.ref, st2.short.ref)


# ------------------------------------------------------------ migration
@pytest.mark.parametrize("pbc", [(True, True, True), MPM])
def test_migrate_matches_jax(pbc):
    x, box, cfg, params, jcfg, jparams = _fe(pbc)
    n = len(x)
    v0 = thermal_velocities(n, 50.0, MASS_FE, 5)
    kw = dict(halo_b=112, capacity=48, migrate_b=16, pbc=pbc)
    jmd = JD.ShardedMD(JD.XlaFrameModel(jcfg, jparams, chunk=128), MASS_FE,
                       box, _scfg_j(n, 4, 4.0, **kw))
    jst, _ = jmd.distribute(jnp.asarray(x), jnp.asarray(v0))
    C = jmd.cfg.c_loc
    x_loc = np.array(jst.x_loc)
    x_loc[0, C - 1, 0] += 1.5          # into shard 1's slab
    x_loc[3, C - 1, 0] += 1.5          # across the seam (periodic x)
    x_loc[2, 0, 0] -= 1.5              # into shard 1's slab from the right
    jst = jst._replace(x_loc=jnp.asarray(x_loc))
    md = D.ShardedMD(D.XlaFrameModel(cfg, params), MASS_FE, box,
                     _scfg(n, 4, 4.0, **kw), device="cpu")
    st, _ = md.distribute(t64(x), t64(v0))
    st = st._replace(x_loc=t64(x_loc), v_loc=t64(jst.v_loc),
                     f_loc=t64(jst.f_loc),
                     gid=torch.as_tensor(np.array(jst.gid)).long())
    jst2 = jmd.migrate(jst)
    st2 = md.migrate(st)
    for a, b in ((st2.x_loc, jst2.x_loc), (st2.v_loc, jst2.v_loc),
                 (st2.f_loc, jst2.f_loc), (st2.gid, jst2.gid),
                 (st2.halo_l, jst2.halo_l), (st2.halo_r, jst2.halo_r)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert md.migrated == jmd.migrated >= 2
    np.testing.assert_array_equal(np.sort(st2.gid.numpy().ravel()),
                                  np.arange(n))
    # the rebuild's flags, the coverage proof's included, equal JAX's
    st3, jst3 = md.rebuild(st2), jmd.rebuild(jst2)
    np.testing.assert_array_equal(st3.overflow.numpy(),
                                  np.asarray(jst3.overflow))


def test_redistribute_keeps_thermostat():
    x, box, cfg, params, _, _ = _fe()
    n = len(x)
    md = D.ShardedMD(D.XlaFrameModel(cfg, params), MASS_FE, box,
                     _scfg(n, 4, 4.0, ensemble="nvt", t_target=50.0,
                           thermo_every=3), device="cpu")
    st, _ = md.distribute(t64(x),
                          t64(thermal_velocities(n, 50.0, MASS_FE, 2)))
    st, th = md.run(st, 1)
    st2, order2 = md.redistribute(st)
    assert torch.equal(st2.nhc.v_xi, st.nhc.v_xi) and int(st2.step) == 3
    assert rel_max(md.gather_positions(st2), md.gather_positions(st)) == 0.0
    assert rel_max(st2.pe.sum(), st.pe.sum()) <= 1e-12


# ------------------------------------------- end to end against JAX
def _jax_adapter(kind, jcfg, jparams):
    if kind == "annp":
        return PallasAnnp(jcfg, jparams, k_short=32, short_delta=0.4)
    if kind == "short":
        return JD.FrameShortModel(PallasAnnp(jcfg, jparams, k_short=32,
                                             short_delta=0.4))
    if kind == "short-ni":
        return JD.FrameShortModel(PallasNi(jcfg, jparams, k_short=32,
                                           short_delta=0.4))
    return JD.XlaFrameModel(jcfg, jparams, chunk=128)


@pytest.mark.parametrize("kind", ["annp", "short", "short-ni", "xla",
                                  "anna"])
def test_end_to_end_matches_jax(kind):
    if kind == "anna":
        x, box = perturbed_bcc((16, 4, 4), seed=4, disp=0.05)
        pot = synthetic_anna_potential(0, npsf=4, ntsf=5, nnod=6)
        cfg, params = A.make_anna(pot, torch.float64, "cpu")
        jcfg, jparams = JA.make_anna(pot, dtype=jnp.float64)
        model = D.AnnaFrameModel(cfg, params, fast=True)
        jmodel = JD.AnnaFrameModel(jcfg, jparams, fast=True)
        cut, mass, kw = cfg.cut, MASS_FE, dict(capacity=80)
    else:
        x, box, cfg, params, jcfg, jparams = _ni() if kind == "short-ni" \
            else _fe()
        model = _adapter(kind, cfg, params)
        jmodel = _jax_adapter(kind, jcfg, jparams)
        cut = annp.descriptor_cutoff(cfg, params)
        mass = M_NI if kind == "short-ni" else MASS_FE
        kw = dict(capacity=48)
    n = len(x)
    v0 = thermal_velocities(n, 100.0, mass, 1)
    kw.update(ensemble="nvt", t_target=100.0, thermo_every=2)
    md = D.ShardedMD(model, mass, box, _scfg(n, 2, cut, **kw), device="cpu")
    st, _ = md.distribute(t64(x), t64(v0))
    st, th = md.run(st, 2)
    jmd = JD.ShardedMD(jmodel, mass, box, _scfg_j(n, 2, cut, **kw))
    jst, _ = jmd.distribute(jnp.asarray(x), jnp.asarray(v0))
    jst, jth = jmd.run(jst, 2)
    assert md.cfg.halo_b == jmd.cfg.halo_b
    assert not bool(st.overflow.any())
    for got, want in ((th.temp, jth.temp), (th.conserved, jth.conserved)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    np.testing.assert_allclose(th.pe.numpy(), np.asarray(jth.pe), rtol=1e-9,
                               atol=1e-9 * n)
    np.testing.assert_allclose(md.gather_positions(st).numpy(),
                               np.asarray(jmd.gather_positions(jst)),
                               rtol=0, atol=1e-9)


# ------------------------------------------------------------ builds
def test_cell_build_accepts_rows_outside_the_box():
    """Rows beyond [0, L) along a non-periodic axis bin into the edge cells
    (clamped), as the JAX build bins them, and the lists equal n2's."""
    x, box = perturbed_bcc((6, 5, 5), seed=2, disp=0.05)
    x[:20, 0] -= 3.0                    # below 0
    x[-20:, 0] += 3.0                   # beyond L
    pbc = (False, True, True)
    dims = (3, 3, 3)
    got = build_neighbors_cell(t64(x), t64(box), 4.5, 48, dims, 64, pbc=pbc)
    want = JN.build_neighbors_cell(jnp.asarray(x), jnp.asarray(box), 4.5, 48,
                                   dims, 64, pbc=pbc)
    n2 = build_neighbors_n2(t64(x), t64(box), 4.5, 48, pbc)
    assert not bool(got.overflow) and not bool(want.overflow)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.idx.numpy(), n2.idx.numpy())
