"""The 2-D grid driver (meng_zhang_tpu_torch/parallel/domain2d.py): the
port's ShardedMD2D on the in-process mesh against its own single-device
evaluation and Simulator, and against the JAX package's ShardedMD2D on the
8-device CPU mesh (tests/conftest.py), all in f64 on the CPU, on the
synthetic potentials at reduced width (tests/test_multichip2d.py's cases
as the checklist; no reference file).

  * the plan at `distribute` equal to JAX's: boundaries, send-table
    capacities, frame rows, park sites, frame grid, skin capacity, and the
    first plan's send tables, halos and skin rows, row for row; periodic
    x and `m p m` (NPT), and the (2, 4) mesh with its y containment;
  * forces against one device on the (2, 2) and (2, 4) meshes: the
    XlaFrameModel (fe and ni) E rtol 1e-10, max |dF| < 1e-9, W rtol 1e-8
    (atol 1e-9); AnnpFrameModel, FrameShortModel (fe and ni) and
    AnnaFrameModel (both `fast` settings) E rtol 1e-9, F and W rtol 1e-7
    (atol 1e-9), the JAX tests' bars;
  * a hot NVE run with in-run rebuilds and migration against the port's
    Simulator: PE rtol 1e-8, T rtol 1e-7;
  * an atom teleported into a face band it was not sent from trips
    OVF_COVERAGE at the rebuild;
  * `migrate` against JAX's on the same state: x, v, f and gid exactly,
    the crossers on shards 2 and 1, transport exact up to one +-L shift,
    and the rebuild after it (flags and plan) equal to JAX's;
  * end to end against the JAX ShardedMD2D over a few blocks: thermo rtol
    1e-9, positions atol 1e-9 A.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu.models import annp as jannp
from meng_zhang_tpu.ops.pallas_annp import PallasAnnp
from meng_zhang_tpu.parallel import domain as JD
from meng_zhang_tpu.parallel import domain2d as JD2
from meng_zhang_tpu_torch.models import anna_adp as A
from meng_zhang_tpu_torch.models import annp
from meng_zhang_tpu_torch.ops import fused_annp as fa
from meng_zhang_tpu_torch.ops import fused_ni as fn
from meng_zhang_tpu_torch.parallel import domain as D
from meng_zhang_tpu_torch.parallel import domain2d as D2
from meng_zhang_tpu_torch.system.neighbors import build_neighbors_n2
from meng_zhang_tpu_torch.testing import synthetic_anna_potential, thermal_fcc
from meng_zhang_tpu_torch.units import MASS_FE
from torch_port_util import (chunked_simulator, full_potential,
                             perturbed_bcc, reduced_ni_potential,
                             reduced_potential, same_halos_and_rows, t64,
                             thermal_velocities)

M_NI = 58.6934
SKIN = 0.5
PBC = (True, True, True)
MPM = (False, True, False)
NPT = {"ensemble": "npt", "t_target": 50.0, "tau_t": 0.1,
       "p_target": (0.0,) * 3, "p_couple": (False, True, False),
       "tau_p": 1.0}


# ------------------------------------------------------------- scenes
@functools.cache
def _fe(pbc=PBC):
    """1,024-atom bcc box, 22.8 x 45.7 x 11.4 A: four y-blocks of 11.4 A
    hold the (2, 4) mesh's containment margin at rlist 4.5 A."""
    x, box = perturbed_bcc((8, 16, 4), seed=3, disp=0.05)
    pot = reduced_potential(cut=4.0)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu", pbc=pbc)
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64, pbc=pbc)
    return x, box, cfg, params, jcfg, jparams


@functools.cache
def _ni(cells=(8, 16, 4), w_out=2.0):
    """fcc block; w_out 0.1 keeps a 600 K run near its start temperature
    (the synthetic ni potential is stiff: at its default a thermal box
    heats to ~3,500 K)."""
    x, box = thermal_fcc(cells, seed=5, disp=0.02)
    pot = reduced_ni_potential(w_out=w_out)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64)
    return x, box, cfg, params, jcfg, jparams


@functools.cache
def _anna():
    x, box = perturbed_bcc((8, 16, 4), seed=4, disp=0.05)
    cfg, params = A.make_anna(synthetic_anna_potential(0, npsf=4, ntsf=5,
                                                       nnod=6, cut=4.0),
                              torch.float64, "cpu")
    return x, box, cfg, params


def _cfg(make, n, mesh, cut, **kw):
    d = int(np.prod(mesh))
    return make(n_devices=d, mesh_shape=mesh, c_loc=n // d, cutoff=cut,
                skin=kw.pop("skin", SKIN), dt=0.001, **kw)


def _md(model, mass, box, n, mesh, cut, **kw):
    return D2.ShardedMD2D(model, mass, box,
                          _cfg(D2.Shard2DConfig, n, mesh, cut, **kw),
                          device="cpu")


def _jmd(model, mass, box, n, mesh, cut, **kw):
    return JD2.ShardedMD2D(model, mass, box,
                           _cfg(JD2.Shard2DConfig, n, mesh, cut, **kw))


def _global_f(st, order):
    return st.f_loc.reshape(-1, 3)[torch.argsort(order)]


# ----------------------------------------------------------- geometry
GEOMETRY = {"periodic": ("fe", PBC, (2, 2), {}),
            "mpm-npt": ("fe", MPM, (2, 2), NPT),
            "ni-2x4": ("ni", PBC, (2, 4), {})}


@functools.cache
def _jax_distributed(case):
    """The JAX ShardedMD2D distributed on a GEOMETRY case (XlaFrameModel)."""
    scene, pbc, mesh, kw = GEOMETRY[case]
    x, box, _, _, jcfg, jparams = _fe(pbc) if scene == "fe" else _ni()
    cut = 4.0 if scene == "fe" else 2.91
    jmd = _jmd(JD.XlaFrameModel(jcfg, jparams, chunk=128), MASS_FE, box,
               len(x), mesh, cut, pbc=pbc, **kw)
    return jmd, jmd.distribute(jnp.asarray(x))[0]


@pytest.mark.parametrize("case", list(GEOMETRY))
def test_plan_matches_jax(case):
    scene, pbc, mesh, kw = GEOMETRY[case]
    x, box, cfg, params, _, _ = _fe(pbc) if scene == "fe" else _ni()
    cut = 4.0 if scene == "fe" else 2.91
    md = _md(D.XlaFrameModel(cfg, params), MASS_FE, box, len(x), mesh, cut,
             pbc=pbc, **kw)
    st, _ = md.distribute(t64(x))
    jmd, jst = _jax_distributed(case)
    for name in ("xb_frac", "yb_frac", "park2d"):
        np.testing.assert_array_equal(getattr(md, name),
                                      getattr(jmd, name))
    for name in ("bx", "by", "c1", "c_ext2d", "w_send", "w_frame",
                 "wx_frame", "wy_frame", "m_contain_x", "m_contain_y",
                 "frame_dims"):
        assert getattr(md, name) == getattr(jmd, name), name
    assert md.cfg.capacity == jmd.cfg.capacity
    if mesh == (2, 4):
        assert md.m_contain_y is not None      # far y shards: guard live
    for name in D2.Plan2D._fields:
        np.testing.assert_array_equal(getattr(st.plan, name).numpy(),
                                      np.asarray(getattr(jst.plan, name)),
                                      err_msg=name)
    for got, want in ((st.gid, jst.gid), (st.overflow, jst.overflow)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    same_halos_and_rows(st, jst, box, pbc)



def test_mesh_checks():
    """The JAX driver's mesh checks, and a model without the minimum image
    along a periodic axis of the box (the halos keep their positions as
    sent, so the evaluation needs it)."""
    x, box, cfg, params, _, _ = _fe()
    model = D.XlaFrameModel(cfg, params)
    for mesh, kw, match in (((2, 2), {"n_devices": 8}, "multiply"),
                            ((4, 1), {}, "Dy=1"),
                            ((2, 2), {"halo_b": 64}, "halo_b")):
        scfg = _cfg(D2.Shard2DConfig, len(x), mesh, 4.0)
        with pytest.raises(ValueError, match=match):
            D2.ShardedMD2D(model, MASS_FE, box,
                           dataclasses.replace(scfg, **kw), device="cpu")
    _, _, cfg_mpm, params_mpm, _, _ = _fe(MPM)
    with pytest.raises(ValueError, match="pbc"):
        _md(D.XlaFrameModel(cfg_mpm, params_mpm), MASS_FE, box, len(x),
            (2, 2), 4.0)


# ------------------------------------------------- 1 vs D shards
@functools.cache
def _single(kind):
    """(E shift-free, F, W) of the whole box on one device."""
    if kind.startswith("anna"):
        x, box, cfg, params = _anna()
        nb = build_neighbors_n2(t64(x), t64(box), cfg.cut + SKIN, 80)
        return A.energy_forces_virial(cfg, params, t64(x), t64(box), nb.idx,
                                      shift=False)
    x, box, cfg, params, _, _ = _ni() if kind.endswith("ni") else _fe()
    rc = annp.descriptor_cutoff(cfg, params)
    nb = build_neighbors_n2(t64(x), t64(box), rc + SKIN, 64)
    return annp.energy_forces_virial_chunked(cfg, params, t64(x), t64(box),
                                             nb.idx, shift=False)


def _sharded_case(kind):
    """(model, x, box, mass, cutoff, config keywords) of an adapter."""
    if kind.startswith("anna"):
        x, box, cfg, params = _anna()
        return (D.AnnaFrameModel(cfg, params, fast=kind == "anna-fast"), x,
                box, MASS_FE, cfg.cut, {"capacity": 80})
    x, box, cfg, params, _, _ = _ni() if kind.endswith("ni") else _fe()
    rc = annp.descriptor_cutoff(cfg, params)
    mass = M_NI if kind.endswith("ni") else MASS_FE
    if kind in ("xla", "xla-ni"):
        model = D.XlaFrameModel(cfg, params)
    elif kind == "annp":
        model = D.AnnpFrameModel(fa.FusedAnnp(cfg, params, k_short=32))
    elif kind == "short":
        model = D.FrameShortModel(fa.FusedAnnp(cfg, params, k_short=32,
                                               short_delta=0.4))
    else:
        model = D.FrameShortModel(fn.FusedNi(cfg, params, k_short=32,
                                             short_delta=0.2))
    return model, x, box, mass, rc, {}


@pytest.mark.parametrize("mesh", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
@pytest.mark.parametrize("kind", ["xla", "xla-ni", "annp", "short",
                                  "short-ni", "anna-fast", "anna"])
def test_forces_match_single_device(kind, mesh):
    model, x, box, mass, cut, kw = _sharded_case(kind)
    e, f, w = _single(kind)
    md = _md(model, mass, box, len(x), mesh, cut, **kw)
    st, order = md.distribute(t64(x))
    assert not bool(st.overflow.any()), st.overflow
    got = _global_f(st, order)
    if kind.startswith("xla"):
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
    np.testing.assert_array_equal(md.gather_positions(st).numpy(), x)
    # pad rows are centres with empty rows: no pair reaches a pad
    pad = st.plan.padm
    assert bool(pad.any())
    real = st.idx < md._frame_rows()
    hit = torch.zeros_like(pad)
    hit.scatter_(1, torch.where(real, st.idx, 0).flatten(1),
                 real.flatten(1))
    assert not bool((hit & pad).any())
    assert not bool((real.any(dim=2) & pad).any())


def test_f32_forces_conserve_momentum():
    """In f32, on the shipped fe width (where the descriptors' normalisation
    turns a sum's rounding into ~1e-4 of the network input), the sharded
    forces sum to zero within 1e-7 N rms|F|, a tenth of chip_smoke.py's
    sum_F gate: both shards that hold a pair sum its rows in one order
    (ascending atom id) from the positions as sent, so the pair's Fj
    cancels to the bit. Rows in frame order read ~1.4e-7 here, and the
    seam-shifted positions of the JAX drivers ~6e-7; on the 152,880-atom
    benchmark scene the two together read 1.8e-5, 18x that gate."""
    x, box = perturbed_bcc((12, 16, 6), seed=3, disp=0.05)
    x = (x + np.array([50.0, 80.0, 30.0])) % box     # atoms on every seam
    cfg, params = annp.make_annp(full_potential(), torch.float32,
                                 device="cpu")
    model = D.FrameShortModel(fa.FusedAnnp(cfg, params, k_short=128,
                                           short_delta=0.4))
    md = _md(model, MASS_FE, box, len(x), (2, 2), cfg.cut)
    st, _ = md.distribute(torch.tensor(x, dtype=torch.float32))
    assert not bool(st.overflow.any())
    f = st.f_loc.reshape(-1, 3).double()
    rms = float(f.pow(2).mean().sqrt())
    assert float(f.sum(0).abs().max()) <= 1e-7 * len(x) * rms


def test_plan_refuses_a_block_narrower_than_the_band():
    """Two periodic x-slabs of 11.4 A against w_need = 2 rlist = 14 A (rc
    6.5 A): a face's band reaches past the next slab into this slab's own
    image, which nobody sends. The port refuses the plan; the JAX plan
    accepts it, raises no flag, and its forces lack the pairs of the
    ghosts within rc of an own row whose partners lie in that image."""
    x, box = perturbed_bcc((8, 16, 6), seed=3, disp=0.05)
    x = (x + np.array([50.0, 80.0, 30.0])) % box
    pot = reduced_potential()
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    md = _md(D.XlaFrameModel(cfg, params), MASS_FE, box, len(x), (2, 2),
             6.5)
    with pytest.raises(ValueError, match="w_need"):
        md.distribute(t64(x))
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64)
    jmd = _jmd(JD.XlaFrameModel(jcfg, jparams, chunk=256), MASS_FE, box,
               len(x), (2, 2), 6.5, capacity=192)
    jst, jorder = jmd.distribute(jnp.asarray(x))
    assert not np.asarray(jst.overflow).any()
    nb = build_neighbors_n2(t64(x), t64(box), 7.0, 192)
    f = annp.energy_forces_virial_chunked(cfg, params, t64(x), t64(box),
                                          nb.idx, shift=False)[1].numpy()
    jf = np.asarray(jst.f_loc).reshape(-1, 3)[np.argsort(np.asarray(jorder))]
    assert np.abs(jf - f).max() > 1e-3 * np.abs(f).max()


# ------------------------------------------------------------ dynamics
def test_hot_nve_with_rebuilds_matches_simulator():
    """A 600 K NVE run on the ni potential through the frame short list,
    with migrate_b: the rebuilds (replans from the migrated rows) fire in
    the run, which stays on the single-device track."""
    x, box, cfg, params, _, _ = _ni((8, 8, 4), w_out=0.1)
    n = len(x)
    v0 = thermal_velocities(n, 600.0, M_NI, 3)
    sim = chunked_simulator(cfg, params, n, "nve", M_NI, thermo_every=4,
                            skin=0.3)
    s1 = sim.init_state(t64(x), t64(box), v=t64(v0))
    s1, th1 = sim.run(s1, 12)
    assert sim.rebuild_count >= 1 and not bool(s1.unsafe)
    model = D.FrameShortModel(fn.FusedNi(cfg, params, k_short=32,
                                         short_delta=0.2))
    md = _md(model, M_NI, box, n, (2, 2), annp.descriptor_cutoff(cfg, params),
             skin=0.3, thermo_every=4, migrate_b=16)
    st, _ = md.distribute(t64(x), t64(v0))
    st, th = md.run(st, 12)
    assert md.rebuild_count >= 2
    assert not bool(st.overflow.any()) and not bool(st.unsafe.any())
    np.testing.assert_allclose(th.pe.numpy(), th1.pe.numpy(), rtol=1e-8)
    np.testing.assert_allclose(th.temp.numpy(), th1.temp.numpy(), rtol=1e-7)
    np.testing.assert_array_equal(np.sort(st.gid.numpy().ravel()),
                                  np.arange(n))


def test_coverage_proof_trips():
    """An own atom of shard (0, 0) outside its y-high send set, teleported
    into that face band, trips OVF_COVERAGE on shard 0 at the rebuild, as
    in JAX (rlist 3.5 A: at rlist 4.5 the window covers every row of a
    block, and no non-member exists); a rebuild on the untouched state
    latches nothing."""
    x, box, cfg, params, jcfg, jparams = _fe()
    md = _md(D.XlaFrameModel(cfg, params), MASS_FE, box, len(x), (2, 2),
             3.0, capacity=64)
    st, _ = md.distribute(t64(x))
    assert not bool(st.overflow.any())
    assert not bool(md.rebuild(st).overflow.any())
    x_loc = st.x_loc.clone()
    yhi = md.yb_frac[0, 1] * float(box[1])
    outside = torch.nonzero(x_loc[0, :, 1] < yhi - md.w_send - 0.5)
    assert len(outside), "the scene must have send-set non-members"
    x_loc[0, int(outside[0]), 1] = yhi - 0.1
    st = md.rebuild(st._replace(x_loc=x_loc))
    assert st.overflow[0] & D.OVF_COVERAGE
    assert not bool(st.overflow[1:].any())
    jmd = _jmd(JD.XlaFrameModel(jcfg, jparams, chunk=128), MASS_FE, box,
               len(x), (2, 2), 3.0, capacity=64)
    jst, _ = jmd.distribute(jnp.asarray(x))
    jst = jmd.rebuild(jst._replace(x_loc=jnp.asarray(x_loc.numpy())))
    np.testing.assert_array_equal(st.overflow.numpy(),
                                  np.asarray(jst.overflow))


# ------------------------------------------------------------ migration
def test_migrate_matches_jax():
    x, box, cfg, params, jcfg, jparams = _fe()
    n = len(x)
    v0 = thermal_velocities(n, 50.0, MASS_FE, 5)
    kw = dict(capacity=64, migrate_b=8)
    jmd = _jmd(JD.XlaFrameModel(jcfg, jparams, chunk=128), MASS_FE, box, n,
               (2, 2), 3.0, **kw)
    jst, _ = jmd.distribute(jnp.asarray(x), jnp.asarray(v0))
    # push the shard (0, 0) atom of largest x past its x-high boundary,
    # and that of largest y past its y-high one
    x_loc = np.array(jst.x_loc)
    vic = [int(np.argmax(x_loc[0, :, a])) for a in (0, 1)]
    assert vic[0] != vic[1]
    moved = [int(np.asarray(jst.gid)[0, i]) for i in vic]
    x_loc[0, vic[0], 0] = jmd.xb_frac[1] * box[0] + 1.2
    x_loc[0, vic[1], 1] = jmd.yb_frac[0, 1] * box[1] + 1.2
    jst = jst._replace(x_loc=jnp.asarray(x_loc))
    md = _md(D.XlaFrameModel(cfg, params), MASS_FE, box, n, (2, 2), 3.0,
             **kw)
    st, _ = md.distribute(t64(x), t64(v0))
    st = st._replace(x_loc=t64(x_loc), v_loc=t64(jst.v_loc),
                     f_loc=t64(jst.f_loc),
                     gid=torch.as_tensor(np.array(jst.gid)).long())
    jst2, st2 = jmd.migrate(jst), md.migrate(st)
    for got, want in ((st2.x_loc, jst2.x_loc), (st2.v_loc, jst2.v_loc),
                      (st2.f_loc, jst2.f_loc), (st2.gid, jst2.gid),
                      (st2.plan.cov, jst2.plan.cov)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert md.migrated == jmd.migrated >= 2
    # the crossers live on shards (1, 0) and (0, 1); transport is exact
    # up to one +-L shift a coordinate
    assert moved[0] in st2.gid[2] and moved[1] in st2.gid[1]
    o0, o2 = torch.argsort(st.gid.ravel()), torch.argsort(st2.gid.ravel())
    np.testing.assert_array_equal(st2.gid.ravel()[o2].numpy(), np.arange(n))
    np.testing.assert_array_equal(st2.v_loc.reshape(-1, 3)[o2].numpy(),
                                  st.v_loc.reshape(-1, 3)[o0].numpy())
    dx = (st2.x_loc.reshape(-1, 3)[o2] - st.x_loc.reshape(-1, 3)[o0])
    for a in range(3):
        assert set((dx[:, a] / float(box[a])).tolist()) <= {-1.0, 0.0, 1.0}
    # the rebuild replans from the new rows, as JAX's
    st3, jst3 = md.rebuild(st2), jmd.rebuild(jst2)
    np.testing.assert_array_equal(st3.overflow.numpy(),
                                  np.asarray(jst3.overflow))
    for name in D2.Plan2D._fields:
        np.testing.assert_array_equal(getattr(st3.plan, name).numpy(),
                                      np.asarray(getattr(jst3.plan, name)))
    st4 = md.refill_forces(st3)
    assert not bool(st4.overflow.any()) and torch.isfinite(st4.pe).all()


# ------------------------------------------- end to end against JAX
@pytest.mark.parametrize("kind,pbc,kw", [
    ("xla", PBC, {"ensemble": "nvt", "t_target": 100.0}),
    ("short", MPM, NPT)], ids=["xla-nvt", "short-npt-mpm"])
def test_end_to_end_matches_jax(kind, pbc, kw):
    x, box, cfg, params, jcfg, jparams = _fe(pbc)
    n = len(x)
    v0 = thermal_velocities(n, 100.0, MASS_FE, 1)
    if kind == "xla":
        model = D.XlaFrameModel(cfg, params)
        jmodel = JD.XlaFrameModel(jcfg, jparams, chunk=128)
    else:
        model = D.FrameShortModel(fa.FusedAnnp(cfg, params, k_short=32,
                                               short_delta=0.4))
        jmodel = JD.FrameShortModel(PallasAnnp(jcfg, jparams, k_short=32,
                                               short_delta=0.4))
    kw = dict(kw, capacity=48, thermo_every=2, pbc=pbc)
    md = _md(model, MASS_FE, box, n, (2, 2), 4.0, **kw)
    st, _ = md.distribute(t64(x), t64(v0))
    st, th = md.run(st, 2)
    jmd = _jmd(jmodel, MASS_FE, box, n, (2, 2), 4.0, **kw)
    jst, _ = jmd.distribute(jnp.asarray(x), jnp.asarray(v0))
    jst, jth = jmd.run(jst, 2)
    assert not bool(st.overflow.any())
    np.testing.assert_array_equal(st.overflow.numpy(),
                                  np.asarray(jst.overflow))
    for got, want in ((th.temp, jth.temp), (th.conserved, jth.conserved),
                      (th.press, jth.press), (th.vol, jth.vol)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    np.testing.assert_allclose(th.pe.numpy(), np.asarray(jth.pe), rtol=1e-9,
                               atol=1e-9 * n)
    np.testing.assert_allclose(md.gather_positions(st).numpy(),
                               np.asarray(jmd.gather_positions(jst)),
                               rtol=0, atol=1e-9)

