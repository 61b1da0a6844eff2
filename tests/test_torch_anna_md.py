"""ANNA-ADP beyond one evaluation: the synthetic potential's `.anna` text,
its bcc crystal, an NVE trajectory of the port's Simulator on the fast path
against the JAX package's (Pallas interpret mode), and the port's CLI on a
`.anna` against the JAX CLI.

The trajectory runs both packages in f64 from one numpy state: positions,
velocities, forces and thermo within 1e-9 (tests/test_torch_md.py's bars).
The CLI runs are f32 in both packages, with tests/test_torch_run.py's
tolerances and its shared Maxwell-Boltzmann draw, but for PotEng: the
ANNA atom energies carry e_base (-4473 eV) in f32, whose spacing there is
2^-11 eV, before the shift-free sum takes it out again; so each atom's
energy is quantised to 2^-11 eV in each package, and the printed PE of n
atoms agrees to n 2^-11 eV (0.0625 eV for 128 atoms, 1.1e-7 of |PE|).
FIRE's logged pe is the f32 total with n e_base in it, one f32 spacing
(2^-4 eV at 5.7e5 eV) coarser still. The JAX CLI's ANNA route is XLA only
(the reference-shaped functions), so the CLI cases run at the shipped
width (npsf 9, ntsf 19).
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu.io import potential as j_potential
from meng_zhang_tpu.md import simulation as JS
from meng_zhang_tpu.models import anna_adp as J
from meng_zhang_tpu_torch.geometry.lattice import bcc
from meng_zhang_tpu_torch.io import potential
from meng_zhang_tpu_torch.io.lammps_data import LammpsData, write_data
from meng_zhang_tpu_torch.md import simulation as S
from meng_zhang_tpu_torch.models import anna_adp as A
from meng_zhang_tpu_torch.system.neighbors import build_neighbors_n2
from meng_zhang_tpu_torch.testing import anna_text, synthetic_anna_potential
from meng_zhang_tpu_torch.units import MASS_FE
from test_torch_run import (PE_AT_ATOL, X_ATOL, _close_rows, _jax,
                            _log_lines, _port, _read_dump,
                            same_velocities)  # noqa: F401 (autouse fixture)
from torch_port_util import perturbed_bcc, t64

REDUCED = dict(npsf=4, ntsf=5, nnod=6)
RTOL, ATOL = 1e-9, 1e-9
PE_QUANTUM = 2.0 ** -11    # f32 spacing at |e_base| = 4473 eV
N_CLI = 128                # atoms of the CLI scenes
# 4^3 bcc cells (11.42 A) hold rc + skin = 5.555 A under half the box
SCENE = ["--lattice", "bcc", "--cells", "4", "4", "4", "--skin", "0.5",
         "--capacity", "96", "--steps", "20", "--thermo", "10"]


@pytest.mark.parametrize("elements", [("Fe",), ("Fe", "Cr")])
def test_anna_text_reads_back(tmp_path, elements):
    """testing.anna_text writes what both packages' readers read back to
    the bit."""
    pot = synthetic_anna_potential(0, elements=elements)
    path = tmp_path / "p.anna"
    path.write_text(anna_text(pot))
    for got in (potential.read_anna(str(path)),
                j_potential.read_anna(str(path))):
        assert got.elements == pot.elements
        assert (got.ntl, got.nhl, got.nnod, got.nout, got.nsf, got.npsf,
                got.ntsf, got.cut, got.e_base, got.e_scale) == \
            (pot.ntl, pot.nhl, pot.nnod, pot.nout, pot.nsf, pot.npsf,
             pot.ntsf, pot.cut, pot.e_base, pot.e_scale)
        np.testing.assert_array_equal(got.masses, pot.masses)
        np.testing.assert_array_equal(got.gparams, pot.gparams)
        for a, b in zip(got.networks, pot.networks):
            assert (a.flagact, a.act_style) == (b.flagact, b.act_style)
            for wa, wb in zip(a.weights + a.biases, b.weights + b.biases):
                np.testing.assert_array_equal(wa, wb)


def test_synthetic_anna_holds_bcc():
    """The stability testing.synthetic_anna_potential's docstring states:
    the perfect 128-atom lattice is a minimum of the frozen-(d2, q2) energy
    (Hessian eigenvalues 8.5 to 63 eV/A^2 besides the three translations)
    under ~+20 kbar, and 100 NVE steps from 300 K on the fast path (k_short
    72, delta 0.2) keep every atom near its site, the rows within rc + 0.2
    at perfect bcc's 58 partners and (d2, q2) near 0.3 /A."""
    pot = synthetic_anna_potential(0)
    cfg, p = A.make_anna(pot, torch.float64, "cpu")
    x0, box0 = bcc(4)
    x, box = t64(x0), t64(box0)
    nb = build_neighbors_n2(x, box, cfg.cut, 80)
    lp = A.local_params(cfg, p, x, box, nb.idx)

    def etot(xf):
        return A.atom_energies_fields(cfg, p, xf.reshape(-1, 3), box, nb.idx,
                                      lp)[0].sum()
    h = torch.autograd.functional.hessian(etot, x.reshape(-1),
                                          vectorize=True)
    ev = torch.linalg.eigvalsh(0.5 * (h + h.T))
    assert float(ev[:3].abs().max()) < 1e-9
    assert 8.0 < float(ev[3]) and float(ev[-1]) < 70.0
    _, f, w = A.energy_forces_virial(cfg, p, x, box, nb.idx)
    assert float(f.abs().max()) < 1e-10
    kbar = float(torch.trace(w)) / 3 / float(box.prod()) * 1.6021765e3
    assert 15.0 < kbar < 25.0

    fns = A.make_anna_fast_fns(cfg, p, k_short=72, delta=0.2)
    mc = S.MDConfig(dt=0.001, cutoff=cfg.cut, skin=0.5, capacity=96,
                    nbr_method="n2", ensemble="nve", thermo_every=5,
                    stale_factor=0.5, short_every=5, short_skin=0.2)
    sim = S.Simulator(fns[0], torch.full((len(x),), MASS_FE,
                                         dtype=torch.float64), mc,
                      short_build=fns[2], force_fn_light=fns[1])
    st = sim.init_state(x, box, seed=4928459, t_init=300.0)
    maxdisp, rowmax = 0.0, 0
    for _ in range(20):
        st, th = sim.run(st, 1)
        d = st.x - x
        d = d - box * torch.round(d / box)
        maxdisp = max(maxdisp, float(d.norm(dim=1).max()))
        rowmax = max(rowmax, int((st.short.idx < len(x)).sum(1).max()))
    assert torch.isfinite(th.pe).all() and torch.isfinite(th.temp).all()
    assert not bool(st.overflow) and not bool(st.unsafe)
    assert maxdisp < 0.3 and 58 <= rowmax <= 60
    lp = A.local_params(cfg, p, st.x, st.box, st.nbrs.idx)
    assert 0.25 < float(lp.min()) and float(lp.max()) < 0.4


def test_nve_trajectory_matches_jax():
    """10 NVE steps (two short-list refreshes) of both Simulators through
    make_anna_fast_fns, force_fn_light on every step but the last of a
    block, from one numpy state."""
    pot = synthetic_anna_potential(1, **REDUCED)
    x, box = perturbed_bcc(4, seed=3, disp=0.08)
    n = len(x)
    rng = np.random.default_rng(4)
    v = rng.normal(scale=2.0, size=(n, 3))
    v -= v.mean(0)
    common = dict(dt=0.001, cutoff=pot.cut, skin=0.5, capacity=96,
                  nbr_method="n2", ensemble="nve", thermo_every=5,
                  short_every=5, short_skin=0.2)

    jc, jp = J.make_anna(pot, dtype=jnp.float64)
    jf, jl, jsb = J.make_anna_fast_fns(jc, jp, k_short=72, delta=0.2,
                                       chunk=16)
    jsim = JS.Simulator(jf, jnp.full(n, MASS_FE, jnp.float64),
                        JS.MDConfig(**common), short_build=jsb,
                        force_fn_light=jl)
    js = jsim.init_state(jnp.asarray(x), jnp.asarray(box), v=jnp.asarray(v))
    js, jth = jsim.run(js, 2)

    cfg, p = A.make_anna(pot, torch.float64, "cpu")
    f, fl, sb = A.make_anna_fast_fns(cfg, p, k_short=72, delta=0.2)
    sim = S.Simulator(f, torch.full((n,), MASS_FE, dtype=torch.float64),
                      S.MDConfig(**common), short_build=sb,
                      force_fn_light=fl)
    st = sim.init_state(t64(x), t64(box), v=t64(v))
    st, th = sim.run(st, 2)

    for got, want in ((st.x, js.x), (st.v, js.v), (st.f, js.f)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
    for name in S.Thermo._fields:
        np.testing.assert_allclose(getattr(th, name).numpy(),
                                   np.asarray(getattr(jth, name)),
                                   rtol=RTOL, atol=1e-9, err_msg=name)
    assert int(st.step) == int(js.step) == 10
    np.testing.assert_array_equal(st.short.idx.numpy(),
                                  np.asarray(js.short.idx))
    assert not bool(st.overflow) and not bool(st.unsafe)


@pytest.fixture(scope="module")
def anna_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("anna_cli")
    one, two = str(d / "fe.anna"), str(d / "fecr.anna")
    with open(one, "w") as fh:
        fh.write(anna_text(synthetic_anna_potential(0)))
    with open(two, "w") as fh:
        fh.write(anna_text(synthetic_anna_potential(
            5, elements=("Fe", "Cr"))))
    x, box = perturbed_bcc(4, seed=9, disp=0.1)
    kinds = np.random.default_rng(2).integers(1, 3, len(x)).astype(np.int32)
    data = {}
    for name, t, masses in (("displaced", np.ones(len(x), np.int32),
                             [55.847]),
                            ("alloy", kinds, [55.847, 51.996])):
        data[name] = str(d / f"{name}.dat")
        write_data(data[name], LammpsData(
            x=x, types=t, box_lo=np.zeros(3), box_hi=box,
            n_types=len(masses), masses=np.array(masses)))
    return types.SimpleNamespace(dir=d, one=one, two=two, **data)


CLI_CASES = {
    "nve": ["--ensemble", "nve"],
    "nvt": ["--ensemble", "nvt", "--temp", "500"],
    "npt-mpm": ["--ensemble", "npt", "--couple", "y", "--boundary", "m p m"],
}


def _close_anna(got, want):
    """_close_rows, with PotEng to one e_base quantum an atom."""
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=0,
                               atol=N_CLI * PE_QUANTUM)
    got = got.copy()
    got[:, 2] = want[:, 2]
    _close_rows(got, want)


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_anna_cli_matches_jax(anna_files, case):
    argv = ["--potential", anna_files.one] + SCENE + CLI_CASES[case]
    got, _, gerr = _port(argv)
    want, _, werr = _jax(argv)
    _close_anna(got, want)
    assert got.shape == (3, 6) and np.isfinite(got).all()
    assert _log_lines(gerr) == _log_lines(werr)
    assert "falling back to xla" in gerr


def test_anna_cli_two_elements_matches_jax(anna_files):
    """A two-element .anna on a data file of types 1 and 2: each atom runs
    its type's network in both CLIs (per-atom masses from the data file)."""
    argv = ["--data", anna_files.alloy, "--potential", anna_files.two,
            "--skin", "0.5", "--capacity", "96", "--steps", "20",
            "--thermo", "10"]
    got, _, gerr = _port(argv)
    want, _, werr = _jax(argv)
    _close_anna(got, want)
    assert _log_lines(gerr) == _log_lines(werr)
    # the same scene read as all-Fe moves differently
    one = _port(["--data", anna_files.displaced, "--potential",
                 anna_files.two] + argv[4:])[0]
    assert np.abs(one[1:, 2] - got[1:, 2]).max() > 1e-2


def test_anna_cli_dump_minimize_restart(anna_files):
    """--minimize (FIRE through energy_forces), --dump --dump-peratom (c_pe
    from atom_energies) and --checkpoint in both CLIs; then the port's
    --restart from each package's checkpoint, held against the JAX CLI's
    unbroken 40-step run (its own --restart fails, see
    tests/test_torch_run.py)."""
    d = anna_files.dir
    base = ["--data", anna_files.displaced, "--potential", anna_files.one,
            "--skin", "0.5", "--capacity", "96", "--steps", "20",
            "--thermo", "10", "--ensemble", "nvt"]
    mini = ["--minimize", "--min-ftol", "0.05"]
    outs, errs = {}, {}
    for name, main in (("port", _port), ("jax", _jax)):
        outs[name], _, errs[name] = main(
            base + mini + ["--dump", str(d / f"{name}.lammpstrj"),
                           "--dump-peratom",
                           "--checkpoint", str(d / f"{name}.npz")])
    _close_anna(outs["port"], outs["jax"])
    fmax = [[ln for ln in errs[k].splitlines() if "fmax=" in ln][0]
            for k in ("port", "jax")]
    g, w = (float(s.split("fmax=")[1].split()[0]) for s in fmax)
    assert g <= 0.05 and w <= 0.05
    gpe, wpe = (float(s.split("pe=")[1]) for s in fmax)
    assert abs(gpe - wpe) < N_CLI * PE_QUANTUM + 2.0 ** -4
    got = _read_dump(d / "port.lammpstrj")
    want = _read_dump(d / "jax.lammpstrj")
    assert sorted(got) == sorted(want) == [10, 20]
    for step in got:
        (cols, a), (wcols, b) = got[step], want[step]
        assert cols == wcols == ["id", "type", "x", "y", "z", "c_pe"]
        np.testing.assert_allclose(a[:, 2:5], b[:, 2:5], rtol=0, atol=X_ATOL)
        np.testing.assert_allclose(a[:, 5], b[:, 5], rtol=0, atol=PE_AT_ATOL)
    # c_pe carries e_base: summed, it is the thermo row's PE (n e_base added
    # back in f64) to the f32 rounding of 128 values of ~4.5e3 eV
    assert abs(got[20][1][:, 5].sum() - outs["port"][-1, 2]) < 0.05
    unbroken = _jax(base + mini + ["--steps", "40"])[0]
    for ck in ("port", "jax"):
        rows = _port(base + ["--restart", str(d / f"{ck}.npz")])[0]
        _close_anna(rows[:1], outs[ck][-1:])
        _close_anna(rows, unbroken[2:])
