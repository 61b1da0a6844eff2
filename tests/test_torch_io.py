"""The port's host-side modules against the JAX package's: the `.ann` /
`.anna` readers and `.ann` writer, the LAMMPS data reader and writer, the
trajectory dump writer, the lattice, screw and stgb geometry generators and
the `tools` CLI. All numpy on both sides, so every comparison is exact:
equal fields, equal arrays, equal bytes (the written `.ann` files differ
only in their "Generated by" line).
"""
import dataclasses
import os

import numpy as np
import pytest

from meng_zhang_tpu import tools as j_tools
from meng_zhang_tpu.geometry import lattice as j_lattice
from meng_zhang_tpu.geometry import screw as j_screw
from meng_zhang_tpu.geometry import stgb as j_stgb
from meng_zhang_tpu.io import dump as j_dump
from meng_zhang_tpu.io import lammps_data as j_data
from meng_zhang_tpu.io import potential as j_potential
from meng_zhang_tpu_torch import tools
from meng_zhang_tpu_torch.geometry import lattice, screw, stgb
from meng_zhang_tpu_torch.io import dump, lammps_data, potential
from meng_zhang_tpu_torch.testing import (synthetic_fe_potential,
                                          synthetic_ni_potential)


def _assert_same(a, b):
    """Equal values, recursively through dataclasses, tuples and arrays."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _assert_same(u, v)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("make", [synthetic_fe_potential,
                                  synthetic_ni_potential], ids=["fe", "ni"])
def test_ann_write_read_matches_jax(make, tmp_path):
    """Each package's write_ann, then each package's read_ann: four equal
    potentials, equal to the one written (weights and energies to the bit
    through %.17g, the normalisation rows through %.15g, the ni trailer
    through %.7f)."""
    pot = make(0)
    jpot = j_potential.AnnpPotential(**{
        f.name: getattr(pot, f.name) for f in dataclasses.fields(pot)})
    mine, theirs = tmp_path / "port.ann", tmp_path / "jax.ann"
    potential.write_ann(str(mine), pot)
    j_potential.write_ann(str(theirs), jpot)
    a, b = _read(mine).splitlines(), _read(theirs).splitlines()
    assert a[0] == b"#Generated by meng_zhang_tpu_torch"
    assert b[0] == b"#Generated by meng_zhang_tpu"
    assert a[1:] == b[1:]
    got = [potential.read_ann(str(p)) for p in (mine, theirs)]
    want = [j_potential.read_ann(str(p)) for p in (mine, theirs)]
    for g, w in zip(got, want):
        _assert_same(g, w)
    assert got[0].norm_style == pot.norm_style
    # the normalisation rows are written with %.15g: 5e-16 relative
    for row in ("norm_row0", "norm_row1"):
        np.testing.assert_allclose(getattr(got[0], row), getattr(pot, row),
                                   rtol=1e-14)
    for net_r, net in zip(got[0].networks, pot.networks):
        _assert_same(net_r, net)
    if pot.sym_coerad is not None:
        np.testing.assert_allclose(got[0].sym_coerad, pot.sym_coerad,
                                   rtol=0, atol=5e-8)
        np.testing.assert_allclose(got[0].sym_coeang, pot.sym_coeang,
                                   rtol=0, atol=5e-8)


def _anna_text(seed=0, nsf=10, npsf=4, ntsf=6, nnod=6, nout=2):
    """A `.anna` file at the reader's fixed line offsets (one element)."""
    rng = np.random.default_rng(seed)
    row = "\t".join

    def nums(a):
        return row(f"{v:.17g}" for v in np.ravel(a))

    lines = ["#ANNA-ADP test potential", "#", "#", "",
             "#element parameters_(nelement #n element mass)", "1",
             "1\tFe\t55.847", "",
             "#ann parameters_(TL HL Nodes_HL Nout Num_SF Num_PSF Num_TSF "
             "Cut)",
             row(str(v) for v in (4, 2, nnod, nout, nsf, npsf, ntsf)) + "\t6.5",
             "", "#types of symmetry function and activation function",
             "Chebyshev\tmodified\tmodified\tlinear", "",
             "#energy_(E_base E_scale)", "-4.0123\t0.5", "",
             "#global parameters", "17", nums(rng.normal(size=17)),
             "#Fe"]
    shapes = [(nnod, nsf), (nnod, nnod), (nout, nnod)]
    for layer, (n_out, n_in) in enumerate(shapes, start=1):
        lines.append(f"#{layer}_(weight)")
        lines += [nums(r) for r in rng.normal(size=(n_out, n_in))]
        lines.append(f"#{layer}_(bias)")
        lines.append(nums(rng.normal(size=nnod)))
    return "\n".join(lines) + "\n"


def test_read_anna_matches_jax(tmp_path):
    path = tmp_path / "test.anna"
    path.write_text(_anna_text())
    got = potential.read_anna(str(path))
    want = j_potential.read_anna(str(path))
    _assert_same(got, want)
    assert isinstance(got, potential.AnnaPotential)
    assert (got.nnod, got.nout, got.nsf, got.gparams.shape) == \
        (6, 2, 10, (17,))
    assert got.networks[0].weights[2].shape == (2, 6)
    assert got.networks[0].biases[2].shape == (2,)
    assert got.flagsym == potential.SYM_CHEBYSHEV
    assert got.networks[0].flagact == (potential.ACT_MTANH,
                                       potential.ACT_MTANH,
                                       potential.ACT_LINEAR)
    assert got.q3 == want.gparams[16] and got.A0 == want.gparams[0]


def _data(seed=0, n=37, velocities=True):
    rng = np.random.default_rng(seed)
    lo = np.array([-3.25, 10.5, -0.125])
    hi = lo + np.array([12.0, 9.5, 14.75])
    x = rng.uniform(0.0, 1.0, (n, 3)) * (hi - lo)
    return dict(x=x, types=rng.integers(1, 3, n).astype(np.int32),
                box_lo=lo, box_hi=hi, n_types=2,
                v=rng.normal(size=(n, 3)) if velocities else None,
                masses=np.array([55.847, 58.6934]))


@pytest.mark.parametrize("velocities", [True, False], ids=["v", "no_v"])
def test_lammps_data_round_trip_matches_jax(velocities, tmp_path):
    """write_data then read_data with a non-zero origin and a Masses
    section: the port's files equal the JAX package's byte for byte, and
    each package reads them back to the same LammpsData (coordinates
    shifted into [0, box), the origin kept)."""
    fields = _data(velocities=velocities)
    mine, theirs = tmp_path / "port.dat", tmp_path / "jax.dat"
    lammps_data.write_data(str(mine), lammps_data.LammpsData(**fields),
                           comment="scene")
    j_data.write_data(str(theirs), j_data.LammpsData(**fields),
                      comment="scene")
    assert _read(mine) == _read(theirs)
    got = lammps_data.read_data(str(mine))
    want = j_data.read_data(str(mine))
    _assert_same(got, want)
    np.testing.assert_array_equal(got.box_lo, fields["box_lo"])
    np.testing.assert_array_equal(got.masses, fields["masses"])
    np.testing.assert_allclose(got.x, fields["x"], rtol=0, atol=1e-8)
    assert got.n == 37 and np.all(got.box == got.box_hi - got.box_lo)
    assert (got.v is None) == (not velocities)


def test_dump_writer_matches_jax(tmp_path):
    """Two snapshots, one with velocities and a box origin, with per-atom
    `extra` columns (c_pe and the six c_stress columns): equal bytes."""
    rng = np.random.default_rng(2)
    n = 9
    types = rng.integers(1, 3, n)
    snaps = [dict(step=0, x=rng.uniform(0, 5, (n, 3)), box=np.full(3, 5.0),
                  extra={"c_pe": rng.normal(size=n) - 4479.0,
                         "c_stress": rng.normal(size=(n, 6))}),
             dict(step=10, x=rng.uniform(0, 5, (n, 3)),
                  box=np.array([5.0, 5.5, 6.0]), v=rng.normal(size=(n, 3)),
                  box_lo=np.array([-1.0, 0.0, 2.5]),
                  extra={"c_pe": rng.normal(size=n)})]
    paths = []
    for mod, name in ((dump, "port"), (j_dump, "jax")):
        path = str(tmp_path / f"{name}.lammpstrj")
        with mod.DumpWriter(path, types=types) as w:
            for s in snaps:
                w.write(**s)
        paths.append(path)
    assert _read(paths[0]) == _read(paths[1])
    assert b"c_stress[6]" in _read(paths[0])


ORIENTS = [((1, 1, -2), (1, -1, 0), (-1, -1, -1)),
           ((-1, 1, -2), (1, -1, -1), (1, 1, 0)),
           ((1, 0, 0), (0, 1, 0), (0, 0, 1))]


def test_lattice_functions_match_jax():
    for orient in ORIENTS:
        np.testing.assert_array_equal(lattice.orientation_matrix(orient),
                                      j_lattice.orientation_matrix(orient))
        unit = lattice.orientation_matrix(orient)
        np.testing.assert_array_equal(lattice.euler_matrix_reference(unit),
                                      j_lattice.euler_matrix_reference(unit))
        np.testing.assert_array_equal(
            lattice.orient_box_lengths(orient, (3, 4, 0.5)),
            j_lattice.orient_box_lengths(orient, (3, 4, 0.5)))
    for kw in (dict(center_offset=True),
               dict(center_offset=False, clip_tol=(1.0, 1.0)),
               dict(a=3.52, basis=lattice.FCC_BASIS)):
        jkw = dict(kw)
        if "basis" in kw:
            jkw["basis"] = j_lattice.FCC_BASIS
        np.testing.assert_array_equal(
            lattice.oriented_crystal(ORIENTS[0], (20.0, 18.0, 9.0), **kw),
            j_lattice.oriented_crystal(ORIENTS[0], (20.0, 18.0, 9.0), **jkw))
    with pytest.raises(ValueError):
        lattice.orientation_matrix(((1, 1, 0), (1, 0, 0), (0, 0, 1)))
    for box, cut in (((4.9, 30.0, 12.0), 6.5), (np.array([20.0] * 3), 3.9)):
        assert lattice.min_replicas(box, cut) == \
            j_lattice.min_replicas(box, cut)
    fields = _data(velocities=True)
    got = lattice.replicate_data(lammps_data.LammpsData(**fields), (2, 1, 3))
    want = j_lattice.replicate_data(j_data.LammpsData(**fields), (2, 1, 3))
    _assert_same(got, want)


@pytest.mark.parametrize("kw", [
    dict(num_lattice=(6, 8, 0.5)),
    dict(num_lattice=(6, 8, 1), with_dislocation=True, boundary_radius=9.0),
    dict(num_lattice=(5, 7, 1), with_dislocation=True, core_xy=(3.1, 4.7))],
    ids=["perfect", "dislocation", "core"])
def test_screw_matches_jax(kw):
    _assert_same(screw.make_screw_dislocation(**kw),
                 j_screw.make_screw_dislocation(**kw))
    x = np.random.default_rng(0).uniform(0, 10, (50, 3))
    for eps in (0.0, 1e-3):
        np.testing.assert_array_equal(
            screw.screw_displacement(x, np.array([5.0, 5.0]), 2.47, eps),
            j_screw.screw_displacement(x, np.array([5.0, 5.0]), 2.47, eps))


@pytest.mark.parametrize("length,overlap", [
    ((12.0, 14.0, 10.0), None), ((12.0, 14.0, 10.0), 1.2),
    ((27.6, 39.0, 25.44), 2.3)], ids=["raw", "pruned", "two-planes"])
def test_stgb_matches_jax(length, overlap):
    """The generator and the cell-binned overlap prune against the JAX
    package's all-pairs prune; "two-planes" is the 2m configuration's scene
    (scripts/scale_demo.py) at 0.12 of its size, where the prune removes
    atoms at both boundary planes, x = Lx and x = 0 / 2 Lx."""
    got = stgb.make_stgb(length_box=length, delete_overlap=overlap)
    _assert_same(got, j_stgb.make_stgb(length_box=length,
                                       delete_overlap=overlap))
    x1 = got.x[got.types == 1]
    x2 = x1.copy()
    x2[:, 0] = 2.0 * length[0] - x2[:, 0]
    box = got.box
    for r_min in (2.0, overlap or 2.0):
        kept = stgb._prune_overlaps(x1, x2, r_min, box)
        np.testing.assert_array_equal(
            kept, j_stgb._prune_overlaps(x1, x2, r_min, box))
    if overlap == 2.3:
        gone = x2[~(x2[:, None, :] == kept[None, :, :]).all(-1).any(1)]
        mid = np.abs(gone[:, 0] - length[0]) < 1.0
        assert mid.sum() > 0 and (~mid).sum() > 0


@pytest.mark.parametrize("argv", [
    ["screw", "--num-lattice", "6", "8", "1", "--dislocation",
     "--boundary-radius", "9"],
    ["stgb", "--length", "12", "14", "10", "--delete-overlap", "1.2"]],
    ids=["screw", "stgb"])
def test_tools_cli_matches_jax(argv, tmp_path, capsys):
    mine, theirs = tmp_path / "port.dat", tmp_path / "jax.dat"
    tools.main(argv + ["--out", str(mine)])
    j_tools.main(argv + ["--out", str(theirs)])
    assert _read(mine) == _read(theirs)
    err = capsys.readouterr().err.splitlines()
    assert err[0].split()[0] == err[1].split()[0]
    assert os.path.getsize(mine) > 1000


@pytest.mark.parametrize("velocities", [True, False], ids=["v", "no_v"])
def test_native_reader_matches_python_and_jax(velocities, tmp_path,
                                              monkeypatch):
    """The port's ctypes binding of native/mzt_native.cpp (built with g++
    into meng_zhang_tpu_torch/_build/) reads what the pure-Python reader
    reads, and what the JAX package's binding (meng_zhang_tpu/io/native.py)
    reads through the library built from the same source; read_data takes
    it."""
    import shutil
    from meng_zhang_tpu.io import native as j_native
    from meng_zhang_tpu_torch.io import native
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the native reader")
    path = str(tmp_path / "scene.dat")
    lammps_data.write_data(path, lammps_data.LammpsData(
        **_data(seed=3, n=211, velocities=velocities)), comment="scene")
    lib = native.build()
    assert lib.startswith(os.path.join(os.path.dirname(tools.__file__),
                                       "_build"))
    got = native.read_data_native(path)
    assert got is not None
    # the JAX binding loads native/libmzt.so beside its package: give it a
    # package directory whose native/ holds the same library
    (tmp_path / "native").mkdir()
    shutil.copy(lib, tmp_path / "native" / "libmzt.so")
    monkeypatch.setattr(j_native, "__file__",
                        str(tmp_path / "pkg" / "io" / "native.py"))
    monkeypatch.setattr(j_native, "_TRIED", False)
    monkeypatch.setattr(j_native, "_LIB", None)
    _assert_same(got, j_native.read_data_native(path))
    py = lammps_data.read_data_python(path)
    fast = lammps_data.read_data(path)
    _assert_same(fast, py)
    x, types, v, masses, lo, hi, n_types = got
    np.testing.assert_array_equal(x - lo, py.x)
    np.testing.assert_array_equal(types, py.types)
    assert (v is None) == (not velocities) and n_types == py.n_types
    np.testing.assert_array_equal(masses, py.masses)
    # a file it cannot parse: None, and read_data's Python path raises
    bad = tmp_path / "missing.dat"
    assert native.read_data_native(str(bad)) is None
    with pytest.raises(FileNotFoundError):
        lammps_data.read_data(str(bad))
