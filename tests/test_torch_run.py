"""The port's command-line runner (`meng_zhang_tpu_torch.run.main`, device
"cpu") against the JAX package's (`meng_zhang_tpu.run.main`, Pallas in
interpret mode) on a reduced-width synthetic `.ann` and a small lattice
scene, and the port's checkpoint / restart.

Both CLIs draw their initial velocities from their own random streams, so
the tests give both the same Maxwell-Boltzmann draw (made with numpy from a
seed) through each package's `create_velocities`; everything after that is
each package's own code. The JAX CLI turns on JAX's persistent compilation
cache in a fixed directory: the tests keep it off.

Tolerances: both runs are f32. Per thermo row, f32 rounding of the
summations (in different orders) gives, beside one unit in the printed
last place: Temp and KinEng within 1e-5 relative; PotEng (the shift-free
f32 sum plus n * e_shift in f64) within 2e-3 eV; Press within 1e-4 of the
run's largest |Press| plus 0.05 bar on the fused engine, where both
packages tally the virial pair by pair (a sum of ~10^4 f32 pair terms that
cancel to ~1e-3 of their magnitude), and within 1e-3 on the chunked
(`--engine xla`) path, where the JAX package takes the virial as the f32
strain derivative of the energy instead; Volume within 1e-6 relative.
The stiff synthetic ni potential is the exception for Press: its pair
terms cancel to ~1e-6 of their magnitude (tr W is -0.12 eV in f64 on the
perfect 108-atom lattice, while each package's f32 tally reads noise of
~0.3 eV there, ~150 bar on its 1,177 A^3 box), so its rows hold Press
within 300 bar. The two-element BP run, where the JAX CLI takes its plain
route, holds PotEng within PE_ATOL_PLAIN (derived there). Dump columns: positions within 1e-5 A, c_pe within 2e-3 eV
(four f32 ULPs at |e_i| ~ 4.5e3 eV), c_stress within 1e-4 of its largest
|value|. A restart on the CPU continues an unbroken run bit for bit.
"""
import contextlib
import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu import run as jrun
from meng_zhang_tpu.io.potential import write_ann as j_write_ann
from meng_zhang_tpu.md import simulation as jsim
from meng_zhang_tpu_torch import run
from meng_zhang_tpu_torch.io.lammps_data import LammpsData, write_data
from meng_zhang_tpu_torch.io.potential import write_ann
from meng_zhang_tpu_torch.md import simulation as tsim
from meng_zhang_tpu_torch.testing import thermal_fcc, with_elements
from meng_zhang_tpu_torch.units import BOLTZ, MVV2E
from torch_port_util import perturbed_bcc, reduced_ni_potential, \
    reduced_potential

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (rtol, one unit in the printed last place)
ROW_TOL = {"Temp": (1e-5, 1e-3), "KinEng": (1e-5, 1e-4),
           "Volume": (1e-6, 1e-3)}
PE_ATOL = 2e-3
# The JAX CLI's plain route for a multi-element BP potential sums the f32
# per-atom energies of the skin list in one reduction: at |PotEng| ~ 8e3 eV
# (108 ni atoms) each of its ~100 adds rounds by up to half an ULP, 2.4e-4
# eV, 0.026 eV in the worst case
PE_ATOL_PLAIN = 0.03
PRESS_RTOL, PRESS_RTOL_STRAIN, PRESS_ATOL = 1e-4, 1e-3, 0.05
PRESS_ATOL_NI = 300.0
X_ATOL, PE_AT_ATOL, STRESS_RTOL = 1e-5, 2e-3, 1e-4
FE_SCENE = ["--lattice", "bcc", "--cells", "4", "4", "4", "--skin", "1.0",
            "--capacity", "64", "--steps", "20", "--thermo", "10"]
NI_SCENE = ["--lattice", "fcc", "--cells", "3", "3", "3", "--lattice-a",
            "3.52", "--skin", "1.0", "--steps", "10", "--thermo", "5"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    fe, ni = str(d / "fe.ann"), str(d / "ni.ann")
    write_ann(fe, reduced_potential(cut=4.0))
    write_ann(ni, reduced_ni_potential())
    x, box = perturbed_bcc(4, seed=9, disp=0.15)
    data = str(d / "displaced.dat")
    write_data(data, LammpsData(x=x, types=np.ones(len(x), np.int32),
                                box_lo=np.zeros(3), box_hi=box, n_types=1,
                                masses=np.array([55.847])))
    return dict(dir=d, fe=fe, ni=ni, data=data)


def _draw(masses, t_target):
    """One Maxwell-Boltzmann draw at exactly t_target, zero momentum."""
    m = np.asarray(masses, np.float64)
    v = np.random.default_rng(3).normal(size=(len(m), 3)) \
        * np.sqrt(BOLTZ * t_target / (m[:, None] * MVV2E))
    v -= (m[:, None] * v).sum(0) / m.sum()
    ke = 0.5 * MVV2E * (m[:, None] * v * v).sum()
    return v * np.sqrt(t_target / (2.0 * ke / ((3 * len(m) - 3) * BOLTZ)))


@pytest.fixture(autouse=True)
def same_velocities(monkeypatch):
    monkeypatch.setattr(jsim, "create_velocities",
                        lambda key, masses, t, dtype=jnp.float32:
                        jnp.asarray(_draw(masses, t), dtype))
    monkeypatch.setattr(tsim, "create_velocities",
                        lambda gen, masses, t, dtype=torch.float32:
                        torch.as_tensor(_draw(masses.cpu(), t), dtype=dtype))
    real = jax.config.update

    def update(key, value):
        if "compilation_cache" not in key and "persistent_cache" not in key:
            real(key, value)

    monkeypatch.setattr(jax.config, "update", update)


def _run(main, argv, **kw):
    """(thermo rows [R, 6] as parsed numbers, stdout text, stderr text)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv, **kw)
    lines = out.getvalue().splitlines()
    assert lines[0].split() == ["Step", "Temp", "PotEng", "KinEng", "Press",
                                "Volume"]
    rows = np.array([[float(v) for v in ln.split()] for ln in lines[1:]])
    return rows, out.getvalue(), err.getvalue()


def _port(argv):
    return _run(run.main, argv, device="cpu")


def _jax(argv):
    return _run(jrun.main, argv)


def _close_rows(got, want, press_rtol=PRESS_RTOL, press_atol=PRESS_ATOL,
                pe_atol=PE_ATOL):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    for col, name in ((1, "Temp"), (3, "KinEng"), (5, "Volume")):
        rtol, atol = ROW_TOL[name]
        np.testing.assert_allclose(got[:, col], want[:, col], rtol=rtol,
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=0, atol=pe_atol)
    p_tol = press_rtol * np.abs(want[:, 4]).max() + press_atol
    np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=0, atol=p_tol)


def _log_lines(err):
    """The stderr lines both CLIs print alike (all but the timing)."""
    return [ln for ln in err.splitlines() if not ln.startswith("Loop time")]


CASES = {
    "nve": ["--ensemble", "nve"],
    "nvt": ["--ensemble", "nvt", "--temp", "500"],
    "npt-mpm": ["--ensemble", "npt", "--couple", "y", "--boundary", "m p m"],
    "xla-nvt": ["--ensemble", "nvt", "--engine", "xla"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_fe_cli_matches_jax(files, case):
    argv = ["--potential", files["fe"]] + FE_SCENE + CASES[case]
    got, _, gerr = _port(argv)
    want, _, werr = _jax(argv)
    _close_rows(got, want, PRESS_RTOL_STRAIN if "xla" in case
                else PRESS_RTOL)
    assert got.shape == (3, 6)
    assert _log_lines(gerr) == _log_lines(werr)


def test_ni_cli_matches_jax(files):
    """BP through compact_neighbor_rows and the chunked functions."""
    argv = ["--potential", files["ni"], "--ensemble", "nvt", "--temp",
            "600"] + NI_SCENE
    got, _, gerr = _port(argv)
    want, _, werr = _jax(argv)
    _close_rows(got, want, PRESS_RTOL_STRAIN, PRESS_ATOL_NI)
    assert "short-neighbor repack width 16" in gerr
    assert _log_lines(gerr) == _log_lines(werr)


@pytest.fixture(scope="module")
def typed(tmp_path_factory):
    """Two-element .ann files (testing.with_elements) and typed data files
    (types 1/2 drawn 50/50 from a seed, no Masses section: each atom takes
    its element's mass from the potential)."""
    d = tmp_path_factory.mktemp("typed")
    out = {}
    for kind, pot, (x, box) in (
            ("fe", with_elements(reduced_potential(cut=4.0), 2),
             perturbed_bcc(4, seed=9, disp=0.1)),
            ("ni", with_elements(reduced_ni_potential(), 2),
             thermal_fcc(3, seed=9, disp=0.08))):
        out[kind] = str(d / f"{kind}2.ann")
        write_ann(out[kind], pot)
        types = np.random.default_rng(1).integers(1, 3, len(x))
        out[kind + "_data"] = str(d / f"{kind}2.dat")
        write_data(out[kind + "_data"], LammpsData(
            x=x, types=types.astype(np.int32), box_lo=np.zeros(3),
            box_hi=box, n_types=2))
    return out


TWO_ELEMENT = {
    "fe-npt": ("fe", ["--ensemble", "npt", "--couple", "y", "--boundary",
                      "m p m", "--skin", "1.0", "--capacity", "64",
                      "--steps", "20", "--thermo", "10"]),
    "ni-nvt": ("ni", ["--ensemble", "nvt", "--temp", "600", "--skin", "1.0",
                      "--steps", "10", "--thermo", "5"]),
}


@pytest.mark.parametrize("case", list(TWO_ELEMENT))
def test_two_element_cli_matches_jax(typed, case):
    """A two-element .ann on a typed data file: each atom's network by its
    type. Chebyshev on the fused engine (FusedAnnp(elems) against
    PallasAnnp(elems)); BP through the chunked functions with elems, where
    the JAX CLI runs the plain energy_forces_virial on the skin list (its
    strain virial: Press within the chunked path's bounds; PotEng within
    PE_ATOL_PLAIN)."""
    kind, extra = TWO_ELEMENT[case]
    argv = ["--data", typed[kind + "_data"], "--potential", typed[kind]] \
        + extra
    got, _, gerr = _port(argv)
    want, _, werr = _jax(argv)
    if kind == "fe":
        _close_rows(got, want)
    else:
        _close_rows(got, want, PRESS_RTOL_STRAIN, PRESS_ATOL_NI,
                    PE_ATOL_PLAIN)
    assert "elements=('Fe', 'Cr')" in gerr or "elements=('Ni', 'Cu')" in gerr
    # the port logs its repack width where the JAX CLI's plain route has
    # none
    assert [ln for ln in _log_lines(gerr)
            if not ln.startswith("short-neighbor")] == _log_lines(werr)


def test_boundary_letters_parse_alike(files):
    """'mpm' and 'm p m' name the same boundary."""
    argv = ["--potential", files["fe"]] + FE_SCENE + ["--steps", "10"]
    a = _port(argv + ["--boundary", "mpm"])[1]
    b = _port(argv + ["--boundary", "m p m"])[1]
    c = _port(argv)[1]
    assert a == b and a != c


def _read_dump(path):
    """{step: (column names, [N, C] array)} of a .lammpstrj."""
    with open(path) as f:
        lines = f.read().splitlines()
    snaps, i = {}, 0
    while i < len(lines):
        step, n = int(lines[i + 1]), int(lines[i + 3])
        cols = lines[i + 8].split()[2:]
        rows = np.array([[float(v) for v in ln.split()]
                         for ln in lines[i + 9:i + 9 + n]])
        snaps[step] = (cols, rows)
        i += 9 + n
    return snaps


def test_dump_checkpoint_restart_matches_jax(files):
    """--dump --dump-peratom --checkpoint in both CLIs, then the port's
    --restart from each package's checkpoint. (The JAX CLI's own --restart
    stops with "Attempt to donate the same buffer twice": its
    load_checkpoint puts one array in both x and the neighbor list's
    ref_x, and the donating run_device refuses it. So the restarts are
    held against the JAX package's unbroken 40-step run.)"""
    d = files["dir"]
    base = ["--potential", files["fe"]] + FE_SCENE + CASES["npt-mpm"]
    outs = {}
    for name, main in (("port", _port), ("jax", _jax)):
        outs[name] = main(base + ["--dump", str(d / f"{name}.lammpstrj"),
                                  "--dump-peratom",
                                  "--checkpoint", str(d / f"{name}.npz")])[0]
    _close_rows(outs["port"], outs["jax"])
    unbroken = _jax(base + ["--steps", "40"])[0]
    for ck in ("port", "jax"):
        rows = _port(base + ["--restart", str(d / f"{ck}.npz")])[0]
        # the restart's first row is the checkpoint's last
        _close_rows(rows[:1], outs[ck][-1:])
        _close_rows(rows, unbroken[2:])
    np.testing.assert_array_equal(
        _port(base + ["--restart", str(d / "port.npz")])[0][0],
        outs["port"][-1])
    got = _read_dump(d / "port.lammpstrj")
    want = _read_dump(d / "jax.lammpstrj")
    assert sorted(got) == sorted(want) == [10, 20]
    for step in got:
        (cols, a), (wcols, b) = got[step], want[step]
        assert cols == wcols == ["id", "type", "x", "y", "z", "c_pe"] + [
            f"c_stress[{k}]" for k in range(1, 7)]
        np.testing.assert_array_equal(a[:, :2], b[:, :2])
        np.testing.assert_allclose(a[:, 2:5], b[:, 2:5], rtol=0, atol=X_ATOL)
        np.testing.assert_allclose(a[:, 5], b[:, 5], rtol=0, atol=PE_AT_ATOL)
        s_tol = STRESS_RTOL * np.abs(b[:, 6:]).max()
        np.testing.assert_allclose(a[:, 6:], b[:, 6:], rtol=0, atol=s_tol)
    # c_pe carries e_shift: summed, it is the thermo row's PE (which adds
    # n e_shift back in f64) to the f32 rounding of 128 values of ~4.5e3
    assert abs(got[20][1][:, 5].sum() - outs["port"][-1, 2]) < 0.05


@pytest.mark.parametrize("ensemble", ["npt", "langevin"])
def test_restart_continues_bit_for_bit(files, ensemble):
    """20 steps in one run, or 10, a checkpoint, and 10 after --restart:
    the same rows, digit for digit (forces at a position do not depend on
    the list they were built from: each evaluation compacts at the cutoff;
    the Langevin generator's state is restored)."""
    d = files["dir"]
    base = ["--potential", files["fe"]] + FE_SCENE + [
        "--ensemble", ensemble, "--couple", "y"]
    whole = _port(base)[1].splitlines()
    ck = str(d / f"bit_{ensemble}.npz")
    half = _port(base + ["--steps", "10", "--checkpoint", ck])[1]
    rest = _port(base + ["--steps", "10", "--restart", ck])[1]
    half, rest = half.splitlines(), rest.splitlines()
    assert half[:3] == whole[:3]
    assert rest[1:] == [whole[2], whole[3]]


def test_langevin_restart_from_jax_checkpoint_reseeds(files):
    """A JAX checkpoint's PRNG key has no torch meaning: a Langevin restart
    reseeds and says so."""
    d = files["dir"]
    base = ["--potential", files["fe"]] + FE_SCENE
    ck = str(d / "jax_langevin.npz")
    _jax(base + ["--ensemble", "langevin", "--checkpoint", ck])
    rows, _, err = _port(base + ["--ensemble", "langevin", "--restart", ck])
    assert "JAX PRNG key" in err and "reseeded" in err
    assert np.isfinite(rows).all() and rows[0, 0] == 20
    # a deterministic ensemble reseeds silently
    err = _port(base + ["--ensemble", "nve", "--restart", ck])[2]
    assert "reseeded" not in err


def test_minimize_matches_jax(files):
    """--minimize: FIRE through the chunked functions before the run."""
    argv = ["--data", files["data"], "--potential", files["fe"],
            "--skin", "1.0", "--capacity", "64", "--steps", "10",
            "--thermo", "10", "--minimize", "--min-ftol", "0.05"]
    got, _, gerr = _port(argv)
    want, _, werr = _jax(argv)
    _close_rows(got, want)
    fmax = [[ln for ln in e.splitlines() if "fmax=" in ln][0]
            for e in (gerr, werr)]
    g, w = (float(s.split("fmax=")[1].split()[0]) for s in fmax)
    assert g <= 0.05 and w <= 0.05
    gpe, wpe = (float(s.split("pe=")[1]) for s in fmax)
    assert abs(gpe - wpe) < PE_ATOL


def test_cli_refusals(files, tmp_path):
    base = ["--lattice", "bcc", "--cells", "4", "4", "4", "--skin", "1.0",
            "--steps", "10"]
    # .anna files (and --model anna) go to the ANNA reader, which stops on
    # a file it cannot read with its own error; the ANNA runs themselves
    # are held to the JAX CLI in tests/test_torch_anna_md.py
    anna = tmp_path / "x.anna"
    anna.write_text("not read\n")
    with pytest.raises(IndexError):
        run.main(base + ["--potential", str(anna)], device="cpu")
    with pytest.raises(ValueError, match="invalid literal"):
        run.main(base + ["--potential", files["fe"], "--model", "anna"],
                 device="cpu")
    with pytest.raises(SystemExit, match="--dump-peratom needs --dump"):
        run.main(base + ["--potential", files["fe"], "--dump-peratom"],
                 device="cpu")
    # a two-element potential runs (test_two_element_cli_matches_jax), but
    # a data file with more types than elements stops, as in the JAX CLI
    two = reduced_potential(cut=4.0)
    two = type(two)(**{**two.__dict__, "elements": ("Fe", "Cr"),
                       "masses": np.array([55.847, 51.996]),
                       "networks": two.networks * 2})
    j_write_ann(str(tmp_path / "two.ann"), two)
    x, box = perturbed_bcc(4, seed=9, disp=0.15)
    three = str(tmp_path / "three.dat")
    write_data(three, LammpsData(x=x, types=np.arange(len(x)) % 3 + 1,
                                 box_lo=np.zeros(3), box_hi=box, n_types=3))
    for main, kw in ((run.main, {"device": "cpu"}), (jrun.main, {})):
        with pytest.raises(SystemExit, match="3 atom types but the "
                           "potential defines only 2 elements"):
            main(["--data", three, "--potential", str(tmp_path / "two.ann"),
                  "--steps", "10"], **kw)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            run.main(base + ["--potential", files["fe"]])


def test_python_m_entry_points(files, tmp_path):
    """`python -m meng_zhang_tpu_torch` runs run.main (on the card, so on a
    CUDA-less host it stops with the device error) and
    `python -m meng_zhang_tpu_torch.tools` writes its scene."""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "meng_zhang_tpu_torch", "--lattice", "bcc",
         "--potential", files["fe"], "--steps", "10"], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=300)
    if not torch.cuda.is_available():
        assert res.returncode != 0 and "no CUDA device" in res.stderr
    out = tmp_path / "screw.dat"
    res = subprocess.run(
        [sys.executable, "-m", "meng_zhang_tpu_torch.tools", "screw",
         "--num-lattice", "4", "6", "1", "--out", str(out)], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert out.stat().st_size > 0 and "atoms ->" in res.stderr


def test_profile_phases_and_trace(files, tmp_path):
    """--profile prints the phase table (md_block once a block, dump once
    a dump); profiling.torch_trace writes a Chrome trace."""
    from meng_zhang_tpu_torch import profiling
    profiling.reset()
    try:
        err = _port(["--potential", files["fe"]] + FE_SCENE + [
            "--dump", str(tmp_path / "d.lammpstrj"), "--profile"])[2]
    finally:
        profiling.enable(False)
    table = {ln.split()[0]: ln.split()[1:] for ln in err.splitlines()
             if ln.split()[:1] in (["md_block"], ["dump"])}
    assert table["md_block"][1] == "2" and table["dump"][1] == "2"
    assert "avg[ms]" in err
    profiling.reset()
    assert profiling.report().splitlines()[1:] == []
    trace = tmp_path / "trace.json"
    with profiling.torch_trace(str(trace)):
        torch.ones(4).sum()
    assert trace.stat().st_size > 0
