"""The port's scale scripts (meng_zhang_tpu_torch/scripts/scale_demo.py and
disloc_core.py) against the JAX package's scripts/scale_demo.py and
scripts/disloc_core.py, which read the shipped potential and write into
artifacts/: here the JAX side is rebuilt from the JAX package's functions
with the scripts' values, on a reduced synthetic potential written as an
.ann file that both packages read.

Scenes are compared exactly; the runs in f64, the port's plain versions
against Pallas in interpret mode, to test_torch_md.py's trajectory
tolerances (positions, velocities and forces atol 1e-9, thermo rtol 1e-9);
the per-atom tallies at rtol 1e-10 of each column's scale.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu.geometry import lattice as j_lattice
from meng_zhang_tpu.geometry import stgb as j_stgb
from meng_zhang_tpu.geometry.screw import make_screw_dislocation as j_screw
from meng_zhang_tpu.io.potential import read_ann as j_read_ann
from meng_zhang_tpu.md import minimize as j_min
from meng_zhang_tpu.md import simulation as JS
from meng_zhang_tpu.models.annp import make_annp as j_make_annp
from meng_zhang_tpu.ops.pallas_annp import PallasAnnp
from meng_zhang_tpu.system.neighbors import build_neighbors_n2, cell_grid_dims
from meng_zhang_tpu.units import MASS_FE
from meng_zhang_tpu_torch.io.potential import write_ann
from meng_zhang_tpu_torch.md import simulation as S
from meng_zhang_tpu_torch.scripts import disloc_core, scale_demo
from torch_port_util import reduced_potential

ATOL, RTOL = 1e-9, 1e-9

# scripts/scale_demo.py's values, written out: :63-69 and :91-100 per
# configuration, :149-166 in common
SCRIPT = {
    "500k": dict(skin=1.2, capacity=256, cell_capacity=96, ensemble="npt",
                 p_couple=(True, True, True), thermo_every=5,
                 dims_share=0.95, box=(63 * 2.8553,) * 3, steps=200),
    "2m": dict(skin=0.8, capacity=168, cell_capacity=48, ensemble="nve",
               p_couple=(False, False, False), thermo_every=10,
               dims_share=1.0, box=(460.0, 325.0, 212.0), steps=100),
}
SCRIPT_COMMON = dict(dt=0.001, nbr_method="cell", t_target=300.0, tau_t=0.1,
                     p_target=(0.0, 0.0, 0.0), tau_p=1.0, stale_factor=0.5,
                     short_skin=0.4)


def _np(a):
    return np.asarray(a, dtype=np.float64)


@pytest.fixture(scope="module")
def ann_path(tmp_path_factory):
    """The reduced synthetic fe potential (npsf 4, ntsf 5, nnod 6, rc 6.5 A)
    as an .ann file."""
    path = tmp_path_factory.mktemp("pot") / "fe_reduced.ann"
    write_ann(str(path), reduced_potential())
    return str(path)


def test_scenes_match_jax():
    x, box, _ = scale_demo.build_scene("500k")
    jx, jbox = j_lattice.bcc([63, 63, 63])
    assert len(x) == 500094
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(box, jbox)
    x, box, label = scale_demo.build_scene("2m", 0.1)
    want = j_stgb.make_stgb(length_box=(230.0 * 0.1, 325.0 * 0.1, 212.0 * 0.1),
                            delete_overlap=2.3)
    np.testing.assert_array_equal(x, want.x)
    np.testing.assert_array_equal(box, want.box)
    assert f"{len(want.x):,}-atom" in label


@pytest.mark.parametrize("config", ["500k", "2m"])
def test_md_config_matches_jax_script(config):
    """Every MDConfig field the port has equals the JAX script's value;
    the JAX-only TPU workarounds (with_rev, short_host_refresh) are off."""
    s = SCRIPT[config]
    cut = 6.5
    box = np.asarray(s["box"])
    jcfg = JS.MDConfig(
        cutoff=cut, skin=s["skin"], capacity=s["capacity"],
        cell_dims=cell_grid_dims(box * s["dims_share"], cut + s["skin"]),
        cell_capacity=s["cell_capacity"], ensemble=s["ensemble"],
        p_couple=s["p_couple"], thermo_every=s["thermo_every"],
        with_rev=config != "2m", short_every=s["thermo_every"],
        short_host_refresh=config == "2m", **SCRIPT_COMMON)
    got = scale_demo.md_config(config, cut, box)
    for f in dataclasses.fields(got):
        if f.name == "short_host_refresh":
            assert got.short_host_refresh is False
        else:
            assert getattr(got, f.name) == getattr(jcfg, f.name), f.name
    c = scale_demo.CONFIGS[config]
    assert c["steps"] == s["steps"] and c["dims_share"] == s["dims_share"]
    assert (scale_demo.K_SHORT, scale_demo.SHORT_DELTA) == (128, 0.4)
    assert (scale_demo.SEED, scale_demo.T_INIT) == (4928459, 300.0)
    assert scale_demo.WARMUP_BLOCKS == 10
    assert scale_demo.FIRE == dict(f_tol=5e-2, dt0=5e-4, dt_max=5e-3,
                                   block=10)
    assert scale_demo.FIRE_MAX_ITER == 100


def test_reduced_2m_run_matches_jax(ann_path):
    """`--config 2m` at 0.12 of the scene's size (4,135 atoms; three cells
    of rc + skin on z, within the cell capacity): FIRE (one block of 10
    iterations), init_state, no warm-up, the latch reset and one timed
    block, through main(argv, device="cpu") in f64 against the JAX
    Simulator and PallasAnnp built with the script's values (its host
    refresh of the short list included: with short_every equal to
    thermo_every it refreshes where the port's in-block cadence does).
    Both runs start from the port's velocity draw."""
    f = 0.12
    run = scale_demo.main(
        ["--config", "2m", "--size-scale", str(f), "--steps", "10",
         "--potential", ann_path], device="cpu", warmup=0, fire_max_iter=10,
        dtype=torch.float64)
    rec, st = run.record, run.state

    jc, jp = j_make_annp(j_read_ann(ann_path), dtype=jnp.float64)
    pk = PallasAnnp(jc, jp, short_delta=0.4)
    d = j_stgb.make_stgb(length_box=(230.0 * f, 325.0 * f, 212.0 * f),
                         delete_overlap=2.3)
    n = len(d.x)
    x, box = jnp.asarray(d.x), jnp.asarray(d.box)
    cfg = JS.MDConfig(
        cutoff=jc.cut, skin=0.8, capacity=168,
        cell_dims=cell_grid_dims(d.box, jc.cut + 0.8), cell_capacity=48,
        ensemble="nve", p_couple=(False,) * 3, thermo_every=10,
        with_rev=False, short_every=10, short_host_refresh=True,
        **SCRIPT_COMMON)

    def force_fn(xx, bb, nbrs, short):
        e, fo = pk.energy_forces_short(xx, bb, short, shift=False)
        return e, fo, jnp.zeros((3, 3), xx.dtype)

    sim = JS.Simulator(force_fn, jnp.full(n, MASS_FE, jnp.float64), cfg,
                       short_build=lambda xx, bb, nbrs: pk.compact_short(
                           xx, bb, nbrs.idx, None))
    nbrs = sim.build_nbrs(x, box)

    def ef(xx, bb, nbr):
        sl = pk.compact_short(xx, bb, nbr[0], None)
        return pk.energy_forces_short(xx, bb, sl, shift=False)

    fst = j_min.fire_minimize(ef, x, box, (nbrs.idx, nbrs.rev), f_tol=5e-2,
                              max_iter=10, dt0=5e-4, dt_max=5e-3, block=10)
    np.testing.assert_allclose(run.x_start.numpy(), _np(fst.x), rtol=0,
                               atol=ATOL)
    assert rec["fire_iters"] == int(fst.n_iter) == 10
    v = S.create_velocities(torch.Generator().manual_seed(scale_demo.SEED),
                            torch.full((n,), MASS_FE, dtype=torch.float64),
                            300.0, torch.float64)
    js = sim.init_state(fst.x, box, v=jnp.asarray(v.numpy()))
    js, jth = sim.run(js, 1)

    for name in ("x", "v", "f"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   _np(getattr(js, name)), rtol=0, atol=ATOL,
                                   err_msg=name)
    th = run.sim.thermo(st)
    for name in S.Thermo._fields:
        np.testing.assert_allclose(float(getattr(th, name)),
                                   float(getattr(jth, name)[-1]), rtol=RTOL,
                                   atol=1e-9, err_msg=name)
    np.testing.assert_allclose(rec["temp_K"], float(jth.temp[-1]), rtol=RTOL)
    np.testing.assert_allclose(rec["pe_eV"],
                               float(jth.pe[-1]) + n * jc.e_shift, rtol=RTOL)
    assert rec["atoms"] == n and rec["steps"] == 10
    assert rec["rebuilds"] == sim.rebuild_count
    for flag in ("overflow", "unsafe"):
        assert rec[flag] == bool(getattr(js, flag)) is False
    assert rec["device"] == "cpu" and rec["peak_mem_gib"] is None
    assert rec["dtype"] == "float64"


def test_disloc_core_matches_jax(ann_path, tmp_path):
    """A reduced config-4 run (4 x 6 x 3 lattice units, boundary radius
    8 A: 864 atoms, 690 of them frozen; z periodic at 14.8 A, so the skin
    list is built by all pairs) through main(argv, device="cpu") in f64,
    two FIRE passes of 20 iterations (neither reaches f_tol), against the
    JAX package's fire_relax with the shell's forces zeroed, then the
    per-atom tallies on a fresh list at the relaxed positions. Frozen
    atoms end exactly where they started; the dump carries the
    tallies."""
    nl, rb = (4, 6, 3), 8.0
    dump = tmp_path / "core.lammpstrj"
    run = disloc_core.main(
        ["--potential", ann_path, "--dump", str(dump)], device="cpu",
        num_lattice=nl, boundary_radius=rb, max_iter=20, max_passes=2,
        dtype=torch.float64)

    pbc = (False, False, True)
    scene = j_screw(num_lattice=nl, with_dislocation=True,
                    boundary_radius=rb)
    np.testing.assert_array_equal(run.x0, scene.x)
    jc, jp = j_make_annp(j_read_ann(ann_path), dtype=jnp.float64, pbc=pbc)
    pk = PallasAnnp(jc, jp, short_delta=0.3)
    x, box = jnp.asarray(scene.x), jnp.asarray(scene.box)
    frozen = jnp.asarray((scene.types == 2)[:, None])

    def build(xx, bb):
        nbrs = build_neighbors_n2(xx, bb, jc.cut + 0.6, 160, pbc=pbc)
        assert not bool(nbrs.overflow)
        return nbrs

    def ef(xx, bb, idx):
        sl = pk.compact_short(xx, bb, idx, None)
        e, fo = pk.energy_forces_short(xx, bb, sl, shift=False)
        return e, jnp.where(frozen, 0.0, fo)

    jx, fst = j_min.fire_relax(ef, build, x, box, f_tol=5e-3, max_outer=2,
                               max_iter=20, block=20)
    sl = pk.compact_short(jx, box, build(jx, box).idx, None)
    e, fo, w, eat, vat = pk.energy_forces_short(jx, box, sl,
                                                want_virial=True,
                                                per_atom=True)

    rec = run.record
    assert int(fst.n_iter) == 20
    assert rec["fire_iters"] == 40 and rec["fire_passes"] == 2
    assert not rec["converged"]
    np.testing.assert_allclose(run.x, _np(jx), rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        rec["fmax_eV_A"], float(jnp.abs(jnp.where(frozen, 0.0, fo)).max()),
        rtol=1e-9)
    np.testing.assert_allclose(rec["pe_eV"], float(e), rtol=1e-10)
    assert rec["fire_last_pass_disp_A"] <= rec["fire_max_disp_A"]
    shell = run.types == 2
    assert shell.sum() > 0 and (~shell).sum() > 0
    np.testing.assert_array_equal(run.x[shell], run.x0[shell])
    for got, want in ((run.eatom, eat), (run.vatom, vat), (run.virial, w)):
        want = _np(want)
        np.testing.assert_allclose(got, want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())
    assert rec["vatom_sum_matches_virial"]
    assert rec["atoms"] == len(scene.x) and rec["device"] == "cpu"
    with open(dump) as fh:
        lines = fh.read().splitlines()
    assert lines[8].split()[-7:] == ["c_pe"] + [f"c_stress[{i}]"
                                               for i in range(1, 7)]
    assert len(lines) == 9 + rec["atoms"]
