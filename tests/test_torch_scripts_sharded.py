"""The port's sharded demos and halo table (meng_zhang_tpu_torch/scripts/
sharded_demo.py, sharded2d_demo.py, halo_fraction.py) against the JAX
package's scripts of those names, which read the shipped potential, run on
a virtual CPU mesh and write into artifacts/: here the JAX side is rebuilt
from the JAX package's drivers with the scripts' values, on the 8-device
CPU mesh of tests/conftest.py, on reduced synthetic potentials written as
.ann files that both packages read, from the same numpy velocities.

  * sharded_demo --scene small, 20 steps, in f64: thermo of the timed
    blocks and the final positions against the JAX ShardedMD on 4 devices
    (rtol 1e-9, atol 1e-9), and the single-device reference's thermo
    against the JAX script's n2 Simulator;
  * sharded2d_demo on 8 x 15 x 6 cells (1,440 atoms) at rc 4 A, so that a
    (2, 4) grid plans: the t = 0 parity within 1e-9 and one NVE block
    against the JAX ShardedMD2D;
  * halo_fraction --cells 24: the 8-shard rows equal the JAX planners'
    (16 and 64 shards need more devices than the JAX mesh has).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu.geometry import lattice as j_lattice
from meng_zhang_tpu.io.potential import read_ann as j_read_ann
from meng_zhang_tpu.md import simulation as JS
from meng_zhang_tpu.models import annp as JM
from meng_zhang_tpu.parallel import domain as JD
from meng_zhang_tpu.parallel import domain2d as JD2
from meng_zhang_tpu.parallel import domain3d as JD3
from meng_zhang_tpu.units import BOLTZ, MASS_FE, NKTV2P
from meng_zhang_tpu_torch.io.potential import write_ann
from meng_zhang_tpu_torch.scripts import (halo_fraction, sharded2d_demo,
                                          sharded_demo)
from torch_port_util import reduced_potential, thermal_velocities

RTOL, ATOL = 1e-9, 1e-9


@pytest.fixture(scope="module")
def ann_paths(tmp_path_factory):
    """Reduced synthetic fe potentials (npsf 4, ntsf 5, nnod 6) at rc 6.5
    and 4.0 A as .ann files."""
    d = tmp_path_factory.mktemp("pots")
    out = {}
    for cut in (6.5, 4.0):
        out[cut] = str(d / f"fe_{cut}.ann")
        write_ann(out[cut], reduced_potential(cut=cut))
    return out


def _thermo_close(got, want, n):
    """T, PE and V to rtol 1e-9; P, a near-cancelling sum of a kinetic and
    a virial term of a few thousand bar, to 1e-9 of its kinetic term."""
    for name in ("temp", "pe", "vol"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    p_kin = n * BOLTZ * np.asarray(want.temp) / np.asarray(want.vol) * NKTV2P
    np.testing.assert_allclose(got.press.numpy(), np.asarray(want.press),
                               rtol=0, atol=RTOL * float(p_kin.max()))


def test_sharded_small_matches_jax(ann_paths):
    """scripts/sharded_demo.py --scene small (:58-176) at 20 steps."""
    path = ann_paths[6.5]
    x, box = j_lattice.bcc([28, 6, 6])
    n = len(x)
    v0 = thermal_velocities(n, 300.0, MASS_FE, 7)
    run = sharded_demo.main(["--scene", "small", "--steps", "20",
                             "--potential", path], device="cpu",
                            dtype=torch.float64, velocities=v0)
    rec = run.record
    assert rec["atoms"] == 2016 and rec["devices"] == 4
    assert rec["steps"] == 20 and run.evaluations == 21

    jc, jp = JM.make_annp(j_read_ann(path), dtype=jnp.float64)
    scfg = JD.ShardConfig(
        n_devices=4, c_loc=n // 4, cutoff=jc.cut, skin=0.8, dt=0.001,
        ensemble="npt", t_target=300.0, tau_t=0.1, p_target=(0.0,) * 3,
        p_couple=(True, True, True), tau_p=1.0, thermo_every=5,
        stale_factor=0.5)
    md = JD.ShardedMD(JD.XlaFrameModel(jc, jp, chunk=128, k_short=128),
                      MASS_FE, jnp.asarray(box), scfg)
    st, _ = md.distribute(jnp.asarray(x), jnp.asarray(v0))
    st, _ = md.run(st, 1)
    st, th = md.run(st, 3)
    assert (rec["halo_b"], rec["capacity"]) == (md.cfg.halo_b,
                                                md.cfg.capacity)
    _thermo_close(run.thermo, th, n)
    np.testing.assert_allclose(
        run.md.gather_positions(run.state).numpy(),
        np.asarray(md.gather_positions(st)), rtol=0, atol=ATOL)
    pe_off = n * jc.e_shift
    np.testing.assert_allclose(rec["final"]["pe"], float(th.pe[-1]) + pe_off,
                               rtol=RTOL)

    # the single-device reference (:132-152)
    cfg1 = JS.MDConfig(dt=0.001, cutoff=jc.cut, skin=0.8,
                       capacity=md.cfg.capacity, nbr_method="n2",
                       ensemble="npt", t_target=300.0, tau_t=0.1,
                       p_target=(0.0,) * 3, p_couple=(True, True, True),
                       tau_p=1.0, thermo_every=5, stale_factor=0.5)

    def force_fn(xx, bb, nbrs):
        idx_s, ovf = JM.compact_neighbor_rows(xx, bb, nbrs.idx, jc.cut, 128)
        e, f, w = JM.energy_forces_virial_chunked(jc, jp, xx, bb, idx_s,
                                                  chunk=128, shift=False)
        return jnp.where(ovf, jnp.nan, e), jnp.where(ovf, jnp.nan, f), w

    sim = JS.Simulator(force_fn, jnp.full(n, MASS_FE, jnp.float64), cfg1)
    st1 = sim.init_state(jnp.asarray(x), jnp.asarray(box),
                         v=jnp.asarray(v0))
    st1, th1 = sim.run(st1, 4)
    _thermo_close(run.ref_thermo, th1, n)
    par = rec["parity"]
    t1 = np.asarray(th1.temp)[1:]
    np.testing.assert_allclose(par["first100_temp_max_abs_K"],
                               np.max(np.abs(t1 - np.asarray(th.temp))),
                               rtol=0, atol=1e-9)
    assert par["single_chip_rebuilds"] == sim.rebuild_count


def test_sharded2d_matches_jax(ann_paths):
    """scripts/sharded2d_demo.py (:55-120) on a reduced scene: the t = 0
    parity against one device within 1e-9, then one NVE block against the
    JAX ShardedMD2D."""
    path, cells = ann_paths[4.0], [8, 15, 6]
    x, box = j_lattice.bcc(cells)
    x = x + np.random.default_rng(0).normal(scale=0.03, size=x.shape)
    n = len(x)
    v0 = thermal_velocities(n, 300.0, MASS_FE, 12)
    run = sharded2d_demo.main(
        ["--cells", *map(str, cells), "--steps", "5", "--potential", path],
        device="cpu", dtype=torch.float64, velocities=v0)
    rec = run.record
    assert rec["atoms"] == n == 1440 and rec["mesh"] == [2, 4]
    par = rec["parity_t0"]
    assert par["f_max_abs"] <= 1e-9 and par["e_abs"] <= 1e-9
    assert par["w_max_abs"] <= 1e-9 * 1e3

    jc, jp = JM.make_annp(j_read_ann(path), dtype=jnp.float64)
    cfg = JD2.Shard2DConfig(n_devices=8, mesh_shape=(2, 4), c_loc=n // 8,
                            cutoff=jc.cut, skin=0.8, dt=0.001,
                            thermo_every=5, stale_factor=0.5)
    md = JD2.ShardedMD2D(JD.XlaFrameModel(jc, jp, chunk=512, k_short=128),
                         MASS_FE, jnp.asarray(box), cfg)
    st, _ = md.distribute(jnp.asarray(x), jnp.asarray(v0))
    assert rec["ghost_rows_per_device"] == md.c_ext2d - n // 8
    st, th = md.run(st, 1)
    _thermo_close(run.thermo, th, n)
    np.testing.assert_allclose(
        run.md.gather_positions(run.state).numpy(),
        np.asarray(md.gather_positions(st)), rtol=0, atol=ATOL)
    assert rec["steps"] == 5 and run.evaluations == 6


class _JStub:
    """scripts/halo_fraction.py's model stub (:29-32)."""
    with_rev = False
    e_shift = 0.0


def _jax_ghost(x, box, d_tot, shape):
    """scripts/halo_fraction.py's planning of one layout (:77-122)."""
    from meng_zhang_tpu_torch.parallel.domain2d import grid_order
    n = len(x)
    c = n // d_tot
    common = dict(n_devices=d_tot, c_loc=c, cutoff=6.5, skin=1.2, dt=0.001)
    try:
        if shape is None:
            md = JD.ShardedMD(_JStub(), 55.845, box, JD.ShardConfig(**common))
            md._auto_geometry(np.sort(x[:, 0]), box)
            return 2 * md.cfg.halo_b, ""
        xs = x[grid_order(x, shape)]
        if len(shape) == 2:
            md = JD2.ShardedMD2D(_JStub(), 55.845, box, JD2.Shard2DConfig(
                mesh_shape=shape, **common))
            md._plan2d(xs, box)
            return md.c_ext2d - c, ""
        md = JD3.ShardedMD3D(_JStub(), 55.845, box, JD3.Shard3DConfig(
            mesh_shape=shape, **common))
        md._plan3d(xs, box)
        return md.c_ext3d - c, ""
    except ValueError as e:
        return None, str(e).split(":")[0]


def test_halo_fraction_matches_jax():
    cells = 24
    rec = halo_fraction.main(["--cells", str(cells)], device="cpu").record
    x, box = j_lattice.bcc([cells] * 3)
    x = x + np.random.default_rng(0).normal(scale=0.03, size=x.shape)
    shapes = dict(halo_fraction.LAYOUTS)
    assert [r["decomp"] for r in rec["rows"][:4]] == [
        "8 dev, 1-D slabs", "8 dev, 2-D 2x4", "8 dev, 2-D 4x2",
        "8 dev, 3-D 2x2x2"]
    for row, shape in zip(rec["rows"][:4], shapes[8]):
        ghost, note = _jax_ghost(x, box, 8, shape)
        assert row["ghost_rows"] == ghost, row["decomp"]
        assert bool(row["note"]) == bool(note), (row, note)
        if shape is None:
            assert row["note"] == note
    assert sum(r["ghost_rows"] is not None for r in rec["rows"][:4]) >= 3
    for row in rec["rows"]:
        assert (row["ghost_rows"] is None) == bool(row["note"])
        if row["ghost_rows"] is not None:
            assert row["ghost_fraction"] == row["ghost_rows"] / row["owned"]
    assert len(rec["rows"]) == 10 and rec["device"] == "cpu"
