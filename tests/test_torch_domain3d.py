"""The 3-D grid driver (meng_zhang_tpu_torch/parallel/domain3d.py): the
port's ShardedMD3D on a (2, 2, 2) in-process mesh against its own
single-device evaluation and Simulator, and against the JAX package's
ShardedMD3D on the 8-device CPU mesh (tests/conftest.py), in f64 on the
CPU, on the synthetic potentials at reduced width
(tests/test_multichip3d.py's cases as the checklist; no reference file).

  * the plan at `distribute` equal to JAX's: the three levels'
    boundaries (`zb_frac` included), bx, by, bz, the frame rows
    (`c_ext3d`), park sites, frame box and grid, and the first plan's
    three rounds of send tables, the halos and the skin rows, row for
    row; periodic ni and `m p m` fe;
  * forces against one device: the ni XlaFrameModel (E rtol 1e-10, max
    |dF| < 1e-9, W rtol 1e-8, atol 1e-9), the fe FrameShortModel,
    AnnpFrameModel and ANNA's fast path (E rtol 1e-9, F and W rtol 1e-7,
    atol 1e-9);
  * a hot NVE run with in-run rebuilds and migration against the port's
    Simulator: PE rtol 1e-8, T rtol 1e-7;
  * the three-round `migrate` against JAX's on the same state, exactly;
    the x, y and z crossers on shards 4, 2 and 1;
  * end to end against the JAX ShardedMD3D: thermo rtol 1e-9, positions
    atol 1e-9 A.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu.models import annp as jannp
from meng_zhang_tpu.parallel import domain as JD
from meng_zhang_tpu.parallel import domain3d as JD3
from meng_zhang_tpu_torch.models import anna_adp as A
from meng_zhang_tpu_torch.models import annp
from meng_zhang_tpu_torch.ops import fused_annp as fa
from meng_zhang_tpu_torch.parallel import domain as D
from meng_zhang_tpu_torch.parallel import domain3d as D3
from meng_zhang_tpu_torch.system.neighbors import build_neighbors_n2
from meng_zhang_tpu_torch.testing import synthetic_anna_potential, thermal_fcc
from meng_zhang_tpu_torch.units import MASS_FE
from torch_port_util import (chunked_simulator, perturbed_bcc,
                             reduced_ni_potential, reduced_potential,
                             same_halos_and_rows, t64, thermal_velocities)

M_NI = 58.6934
SKIN = 0.5
PBC = (True, True, True)
MPM = (False, True, False)
MESH = (2, 2, 2)


@functools.cache
def _ni(w_out=2.0):
    """864-atom fcc cube, 21.1 A (w_out: see test_torch_domain2d.py)."""
    x, box = thermal_fcc((6, 6, 6), seed=8, disp=0.04)
    pot = reduced_ni_potential(w_out=w_out)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64)
    return x, box, cfg, params, jcfg, jparams


@functools.cache
def _fe(pbc=PBC):
    """1,024-atom bcc cube, 22.8 A."""
    x, box = perturbed_bcc((8, 8, 8), seed=9, disp=0.05)
    pot = reduced_potential(cut=4.0)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu", pbc=pbc)
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64, pbc=pbc)
    return x, box, cfg, params, jcfg, jparams


def _cfg(make, n, cut, **kw):
    return make(n_devices=8, mesh_shape=MESH, c_loc=n // 8, cutoff=cut,
                skin=kw.pop("skin", SKIN), dt=0.001, **kw)


def _md(model, mass, box, n, cut, **kw):
    return D3.ShardedMD3D(model, mass, box, _cfg(D3.Shard3DConfig, n, cut,
                                                 **kw), device="cpu")


def _jmd(model, mass, box, n, cut, **kw):
    return JD3.ShardedMD3D(model, mass, box, _cfg(JD3.Shard3DConfig, n, cut,
                                                  **kw))


def _global_f(st, order):
    return st.f_loc.reshape(-1, 3)[torch.argsort(order)]


# ----------------------------------------------------------- geometry
@pytest.mark.parametrize("case", ["ni-periodic", "fe-mpm"])
def test_plan_matches_jax(case):
    if case == "ni-periodic":
        (x, box, cfg, params, jcfg, jparams), pbc, cut = _ni(), PBC, 2.91
    else:
        (x, box, cfg, params, jcfg, jparams), pbc, cut = _fe(MPM), MPM, 4.0
    md = _md(D.XlaFrameModel(cfg, params), MASS_FE, box, len(x), cut,
             pbc=pbc)
    st, _ = md.distribute(t64(x))
    jmd = _jmd(JD.XlaFrameModel(jcfg, jparams, chunk=128), MASS_FE, box,
               len(x), cut, pbc=pbc)
    jst, _ = jmd.distribute(jnp.asarray(x))
    for name in ("xb_frac", "yb_frac", "zb_frac", "park3d"):
        np.testing.assert_array_equal(getattr(md, name), getattr(jmd, name))
    for name in ("bx", "by", "bz", "c1", "c2", "c_ext3d", "w_send",
                 "w_frame", "wx_frame", "wy_frame", "wz_frame",
                 "m_contain_x", "m_contain_y", "m_contain_z", "frame_dims"):
        assert getattr(md, name) == getattr(jmd, name), name
    assert md.cfg.capacity == jmd.cfg.capacity
    for name in D3.Plan3D._fields:
        np.testing.assert_array_equal(getattr(st.plan, name).numpy(),
                                      np.asarray(getattr(jst.plan, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(st.overflow.numpy(),
                                  np.asarray(jst.overflow))
    same_halos_and_rows(st, jst, box, pbc)


# ------------------------------------------------- 1 vs D shards
@pytest.mark.parametrize("kind", ["xla-ni", "short", "annp", "anna-fast"])
def test_forces_match_single_device(kind):
    if kind == "anna-fast":
        x, box = perturbed_bcc((8, 8, 8), seed=9, disp=0.05)
        cfg, params = A.make_anna(synthetic_anna_potential(
            0, npsf=4, ntsf=5, nnod=6, cut=4.0), torch.float64, "cpu")
        nb = build_neighbors_n2(t64(x), t64(box), cfg.cut + SKIN, 80)
        e, f, w = A.energy_forces_virial(cfg, params, t64(x), t64(box),
                                         nb.idx, shift=False)
        md = _md(D.AnnaFrameModel(cfg, params, fast=True), MASS_FE, box,
                 len(x), cfg.cut, capacity=80)
    else:
        x, box, cfg, params, _, _ = _ni() if kind == "xla-ni" else _fe()
        rc = annp.descriptor_cutoff(cfg, params)
        nb = build_neighbors_n2(t64(x), t64(box), rc + SKIN, 64)
        e, f, w = annp.energy_forces_virial_chunked(
            cfg, params, t64(x), t64(box), nb.idx, shift=False)
        if kind == "xla-ni":
            model = D.XlaFrameModel(cfg, params)
        elif kind == "short":
            model = D.FrameShortModel(fa.FusedAnnp(cfg, params, k_short=32,
                                                   short_delta=0.4))
        else:
            model = D.AnnpFrameModel(fa.FusedAnnp(cfg, params, k_short=32))
        md = _md(model, M_NI if kind == "xla-ni" else MASS_FE, box, len(x),
                 rc)
    st, order = md.distribute(t64(x))
    assert not bool(st.overflow.any()), st.overflow
    got = _global_f(st, order)
    if kind == "xla-ni":
        np.testing.assert_allclose(float(st.pe.sum()), float(e), rtol=1e-10)
        assert float((got - f).abs().max()) < 1e-9
        np.testing.assert_allclose(st.virial.numpy(), w.numpy(), rtol=1e-8,
                                   atol=1e-9)
    else:
        np.testing.assert_allclose(float(st.pe.sum()), float(e), rtol=1e-9)
        np.testing.assert_allclose(got.numpy(), f.numpy(), rtol=1e-7,
                                   atol=1e-9)
        np.testing.assert_allclose(st.virial.numpy(), w.numpy(), rtol=1e-7,
                                   atol=1e-9)


# ------------------------------------------------------------ dynamics
def test_hot_nve_with_rebuilds_matches_simulator():
    """600 K NVE with in-run replans, rebuilds and migration on the (2, 2,
    2) mesh stays on the single-device track."""
    x, box, cfg, params, _, _ = _ni(w_out=0.1)
    n = len(x)
    v0 = thermal_velocities(n, 600.0, M_NI, 6)
    sim = chunked_simulator(cfg, params, n, "nve", M_NI, thermo_every=4,
                            skin=0.3)
    s1 = sim.init_state(t64(x), t64(box), v=t64(v0))
    s1, th1 = sim.run(s1, 10)
    assert sim.rebuild_count >= 1 and not bool(s1.unsafe)
    md = _md(D.XlaFrameModel(cfg, params), M_NI, box, n,
             annp.descriptor_cutoff(cfg, params), skin=0.3, thermo_every=4,
             migrate_b=8)
    st, _ = md.distribute(t64(x), t64(v0))
    st, th = md.run(st, 10)
    assert md.rebuild_count >= 1
    assert not bool(st.overflow.any()) and not bool(st.unsafe.any())
    np.testing.assert_allclose(th.pe.numpy(), th1.pe.numpy(), rtol=1e-8)
    np.testing.assert_allclose(th.temp.numpy(), th1.temp.numpy(), rtol=1e-7)


# ------------------------------------------------------------ migration
def test_migrate_matches_jax():
    x, box, cfg, params, jcfg, jparams = _ni()
    n = len(x)
    v0 = thermal_velocities(n, 300.0, M_NI, 2)
    kw = dict(capacity=64, migrate_b=8)
    jmd = _jmd(JD.XlaFrameModel(jcfg, jparams, chunk=128), M_NI, box, n,
               2.91, **kw)
    jst, _ = jmd.distribute(jnp.asarray(x), jnp.asarray(v0))
    # shard (0, 0, 0)'s extreme atom past each of its high boundaries
    x_loc = np.array(jst.x_loc)
    vic = [int(np.argmax(x_loc[0, :, a])) for a in range(3)]
    assert len(set(vic)) == 3
    moved = [int(np.asarray(jst.gid)[0, i]) for i in vic]
    hi = (jmd.xb_frac[1] * box[0], jmd.yb_frac[0, 1] * box[1],
          jmd.zb_frac[0, 0, 1] * box[2])
    for a in range(3):
        x_loc[0, vic[a], a] = hi[a] + 0.9
    jst = jst._replace(x_loc=jnp.asarray(x_loc))
    md = _md(D.XlaFrameModel(cfg, params), M_NI, box, n, 2.91, **kw)
    st, _ = md.distribute(t64(x), t64(v0))
    st = st._replace(x_loc=t64(x_loc), v_loc=t64(jst.v_loc),
                     f_loc=t64(jst.f_loc),
                     gid=torch.as_tensor(np.array(jst.gid)).long())
    jst2, st2 = jmd.migrate(jst), md.migrate(st)
    for got, want in ((st2.x_loc, jst2.x_loc), (st2.v_loc, jst2.v_loc),
                      (st2.f_loc, jst2.f_loc), (st2.gid, jst2.gid)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert md.migrated == jmd.migrated >= 3
    # (1, 0, 0) is shard 4, (0, 1, 0) shard 2, (0, 0, 1) shard 1
    for g, d in zip(moved, (4, 2, 1)):
        assert g in st2.gid[d]
    np.testing.assert_array_equal(np.sort(st2.gid.numpy().ravel()),
                                  np.arange(n))
    st3, jst3 = md.rebuild(st2), jmd.rebuild(jst2)
    np.testing.assert_array_equal(st3.overflow.numpy(),
                                  np.asarray(jst3.overflow))
    for name in D3.Plan3D._fields:
        np.testing.assert_array_equal(getattr(st3.plan, name).numpy(),
                                      np.asarray(getattr(jst3.plan, name)))


# ------------------------------------------- end to end against JAX
def test_end_to_end_matches_jax():
    x, box, cfg, params, jcfg, jparams = _ni()
    n = len(x)
    v0 = thermal_velocities(n, 100.0, M_NI, 1)
    kw = dict(capacity=48, thermo_every=2, ensemble="nvt", t_target=100.0)
    md = _md(D.XlaFrameModel(cfg, params), M_NI, box, n, 2.91, **kw)
    st, _ = md.distribute(t64(x), t64(v0))
    st, th = md.run(st, 2)
    jmd = _jmd(JD.XlaFrameModel(jcfg, jparams, chunk=128), M_NI, box, n,
               2.91, **kw)
    jst, _ = jmd.distribute(jnp.asarray(x), jnp.asarray(v0))
    jst, jth = jmd.run(jst, 2)
    assert not bool(st.overflow.any())
    for got, want in ((th.temp, jth.temp), (th.conserved, jth.conserved),
                      (th.press, jth.press)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    np.testing.assert_allclose(th.pe.numpy(), np.asarray(jth.pe), rtol=1e-9,
                               atol=1e-9 * n)
    np.testing.assert_allclose(md.gather_positions(st).numpy(),
                               np.asarray(jmd.gather_positions(jst)),
                               rtol=0, atol=1e-9)
