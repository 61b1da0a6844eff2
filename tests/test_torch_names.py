"""The small public names of the ported modules against the JAX package's,
in f64 on the CPU from the same numpy inputs:

  * `system.cell`: `wrap`, `pair_displacements`, `volume` (exact);
  * `models.annp`: `atom_energy` and `raw_nn_energy` (fe and ni, a second
    element's network), and `energy_chunked(eps=...)`, the strained energy
    (fe and ni, with and without n e_shift): rtol 1e-10, as
    tests/test_torch_chunked.py;
  * `md.integrate.BarostatState` (the JAX fields);
  * `io.native.available`: the port builds its reader itself, so it is
    available wherever the JAX package's prebuilt one is, and its reader
    then parses as the Python one does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu.md import integrate as JI
from meng_zhang_tpu.models import annp as jannp
from meng_zhang_tpu.io import native as jnative
from meng_zhang_tpu.system import cell as jcell
from meng_zhang_tpu_torch.io import native
from meng_zhang_tpu_torch.io.lammps_data import read_data_python
from meng_zhang_tpu_torch.md import integrate as I
from meng_zhang_tpu_torch.models import annp
from meng_zhang_tpu_torch.system import cell
from meng_zhang_tpu_torch.system.neighbors import build_neighbors_n2
from meng_zhang_tpu_torch.testing import (synthetic_fe_potential_multi,
                                          synthetic_ni_potential_multi,
                                          thermal_fcc)
from torch_port_util import perturbed_bcc, t64

RTOL = 1e-10


def test_cell_names_match_jax():
    rng = np.random.default_rng(0)
    box = np.array([7.5, 9.0, 11.25])
    x = rng.uniform(-20.0, 30.0, (40, 3))
    np.testing.assert_array_equal(cell.wrap(t64(x), t64(box)).numpy(),
                                  np.asarray(jcell.wrap(jnp.asarray(x),
                                                        jnp.asarray(box))))
    xw = np.asarray(jcell.wrap(jnp.asarray(x), jnp.asarray(box)))
    idx = rng.integers(0, 40, (40, 6))
    np.testing.assert_array_equal(
        cell.pair_displacements(t64(xw), torch.as_tensor(idx),
                                t64(box)).numpy(),
        np.asarray(jcell.pair_displacements(jnp.asarray(xw),
                                            jnp.asarray(idx),
                                            jnp.asarray(box))))
    assert float(cell.volume(t64(box))) == float(
        jcell.volume(jnp.asarray(box)))


def _scene(kind):
    if kind == "fe":
        x, box = perturbed_bcc(3, seed=1, disp=0.08)
        pot = synthetic_fe_potential_multi(2, npsf=4, ntsf=5, nnod=6,
                                           cut=4.0)
        return x, box, pot, 4.0
    x, box = thermal_fcc(3, seed=1, disp=0.05)
    return x, box, synthetic_ni_potential_multi(2, npsf=2, nnod=6,
                                                rc_bohr=5.5), 2.95


@pytest.mark.parametrize("kind", ["fe", "ni"])
def test_atom_energy_matches_jax(kind):
    x, box, pot, rc = _scene(kind)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64)
    nb = build_neighbors_n2(t64(x), t64(box), rc + 0.3, 48)
    idx = nb.idx.numpy()
    xp = np.concatenate([x, np.zeros((1, 3))])
    for i, elem in ((0, 0), (7, 1)):
        dx = x[i] - xp[idx[i]]
        dx -= box * np.round(dx / box)
        mask = idx[i] < len(x)
        got = annp.atom_energy(cfg, params, t64(dx), torch.as_tensor(mask),
                               elem)
        want = jannp.atom_energy(jcfg, jparams, jnp.asarray(dx),
                                 jnp.asarray(mask), jnp.asarray(elem))
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
        got = annp.raw_nn_energy(cfg, params, t64(dx), torch.as_tensor(mask),
                                 elem)
        want = jannp.raw_nn_energy(jcfg, jparams, jnp.asarray(dx),
                                   jnp.asarray(mask), elem)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-9)


@pytest.mark.parametrize("kind", ["fe", "ni"])
@pytest.mark.parametrize("shift", [True, False])
def test_energy_chunked_strain_matches_jax(kind, shift):
    x, box, pot, rc = _scene(kind)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64)
    nb = build_neighbors_n2(t64(x), t64(box), rc + 0.5, 48)
    el = np.arange(len(x)) % 2
    eps = np.array([[0.004, 0.001, -0.002], [0.0, -0.003, 0.001],
                    [0.002, 0.0, 0.005]])
    got = annp.energy_chunked(cfg, params, t64(x), t64(box), nb.idx,
                              torch.as_tensor(el), eps=t64(eps),
                              shift=shift)
    want = jannp.energy_chunked(jcfg, jparams, jnp.asarray(x),
                                jnp.asarray(box), jnp.asarray(nb.idx.numpy()),
                                jnp.asarray(el), chunk=64,
                                eps=jnp.asarray(eps), shift=shift)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    # and the strain moved the energy
    e0 = annp.energy_chunked(cfg, params, t64(x), t64(box), nb.idx,
                             torch.as_tensor(el), shift=shift)
    assert abs(float(got) - float(e0)) > 1e3 * RTOL * abs(float(e0))


def test_barostat_state_fields():
    assert I.BarostatState._fields == JI.BarostatState._fields
    st = I.BarostatState(torch.zeros(3),
                         I.NHCState.zeros(3, torch.float64, "cpu"))
    assert st.v_eps.shape == (3,) and st.nhc.xi.shape == (3,)


def test_native_available(tmp_path):
    from meng_zhang_tpu_torch.io.lammps_data import LammpsData, write_data
    avail = native.available()
    assert avail is (native._load() is not None)
    if jnative.available():
        assert avail
    if avail:
        x, box = perturbed_bcc(2, seed=3)
        path = str(tmp_path / "box.dat")
        write_data(path, LammpsData(x=x, types=np.ones(len(x), np.int32),
                                    box_lo=np.zeros(3), box_hi=box,
                                    n_types=1))
        got = native.read_data_native(path)
        want = read_data_python(path)
        np.testing.assert_allclose(got[0], want.x, rtol=1e-12)
