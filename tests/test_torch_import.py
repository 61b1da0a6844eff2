"""The PyTorch port imports neither JAX nor the JAX package, keeps its own
copies of the numpy-only modules it needs, and runs on the card by
default."""
import dataclasses
import inspect
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from meng_zhang_tpu import units as j_units
from meng_zhang_tpu.geometry import lattice as j_lattice
from meng_zhang_tpu.io import potential as j_potential
from meng_zhang_tpu_torch import run, units
from meng_zhang_tpu_torch.geometry import lattice
from meng_zhang_tpu_torch.io import potential
from meng_zhang_tpu_torch.md import integrate
from meng_zhang_tpu_torch.models import annp
from meng_zhang_tpu_torch.testing import (synthetic_fe_potential,
                                          synthetic_ni_potential)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
import numpy as np
import torch
import meng_zhang_tpu_torch
from meng_zhang_tpu_torch import profiling, run, tools
from meng_zhang_tpu_torch.geometry import lattice, screw, stgb
from meng_zhang_tpu_torch.io import dump, lammps_data, potential
from meng_zhang_tpu_torch.md import checkpoint, integrate, minimize, simulation
from meng_zhang_tpu_torch.models import annp, descriptors, mlp
from meng_zhang_tpu_torch.ops import fused_annp, fused_ni, kernels
from meng_zhang_tpu_torch.system import cell, neighbors
from meng_zhang_tpu_torch.testing import synthetic_fe_potential
pot = synthetic_fe_potential(0, npsf=4, ntsf=5, nnod=6, cut=4.0)
cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
x = torch.tensor(np.random.default_rng(0).uniform(0.0, 9.0, (16, 3)))
box = torch.full((3,), 9.0, dtype=torch.float64)
nbrs = neighbors.build_neighbors_n2(x, box, 4.0, 16)
for angular in ("harmonic", "matrix"):
    ev = fused_annp.FusedAnnp(cfg, params, k_short=16, angular=angular)
    e, f, w = ev.energy_forces(x, box, nbrs.idx)
    assert torch.isfinite(f).all() and f.shape == (16, 3)
from meng_zhang_tpu_torch.testing import synthetic_ni_potential
cfg, params = annp.make_annp(synthetic_ni_potential(0, npsf=2, nnod=6),
                             torch.float64, device="cpu")
e, f, w = fused_ni.FusedNi(cfg, params, k_short=16).energy_forces(
    x, box, nbrs.idx)
assert torch.isfinite(f).all() and f.shape == (16, 3)
e, f, w = annp.energy_forces_virial_chunked(cfg, params, x, box, nbrs.idx)
assert torch.isfinite(f).all() and f.shape == (16, 3)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "meng_zhang_tpu" or m.startswith("meng_zhang_tpu."))
assert not bad, bad
print("ok")
"""


def test_import_and_evaluate_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def _port_sources():
    files = []
    top = os.path.join(REPO, "meng_zhang_tpu_torch")
    for root, dirs, names in os.walk(top):
        dirs[:] = [d for d in dirs if d != "_build"]      # build outputs
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    assert len(files) > 10
    return files


def _read(path):
    with open(path) as f:
        return f.read()


# (import|from) meng_zhang_tpu[.module], but not meng_zhang_tpu_torch
_OLD_PKG = re.compile(r"^\s*(?:import|from)\s+meng_zhang_tpu((?:\.\w+)*)\b",
                      re.M)


def test_no_source_imports_jax():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax)\b", re.M)
    for path in [os.path.join(REPO, "chip_smoke.py")] + _port_sources():
        assert not pat.search(_read(path)), path


def test_port_imports_only_numpy_modules_of_jax_package():
    """No module of the JAX package at all, numpy-only ones included: the
    port keeps its own copies (units, io.potential, io.lammps_data,
    io.dump, geometry.lattice, geometry.screw, geometry.stgb, tools)."""
    for path in _port_sources():
        assert not _OLD_PKG.findall(_read(path)), path


def test_smoke_imports_nothing_of_jax_package():
    src = _read(os.path.join(REPO, "chip_smoke.py"))
    assert "meng_zhang_tpu_torch" in src
    assert not _OLD_PKG.findall(src)


def _public_constants(mod):
    return {k: getattr(mod, k) for k in dir(mod)
            if k.isupper() and not k.startswith("_")}


@pytest.mark.parametrize("make", [synthetic_fe_potential,
                                  synthetic_ni_potential],
                         ids=["gaussian", "minmax"])
def test_copies_equal_jax_package(make):
    """The copied constants, flags and lattices, and the normalisation of
    AnnpPotential, equal the JAX package's, on a gaussian (fe) and a
    min-max (ni) potential."""
    assert _public_constants(units) == _public_constants(j_units)
    assert _public_constants(potential) == _public_constants(j_potential)
    assert _public_constants(potential.ActivationStyle) == \
        _public_constants(j_potential.ActivationStyle)
    for got, want in ((lattice.bcc(3), j_lattice.bcc(3)),
                      (lattice.fcc((2, 3, 4), 3.52),
                       j_lattice.fcc((2, 3, 4), 3.52))):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    pot = make(0)
    jpot = j_potential.AnnpPotential(**{
        f.name: getattr(pot, f.name) for f in dataclasses.fields(pot)})
    assert pot.norm_style == jpot.norm_style
    np.testing.assert_array_equal(pot.sf_scale, jpot.sf_scale)
    np.testing.assert_array_equal(pot.sf_shift, jpot.sf_shift)


def test_entry_points_default_to_the_card():
    """make_annp, params_from_numpy, the md/integrate.py helpers and the
    CLI's run.main put their tensors on the card unless the caller names
    another device; on a torch without CUDA a call without a device raises
    instead of handing back CPU tensors (run.main: tests/test_torch_run.py)."""
    for fn in (annp.make_annp, annp.params_from_numpy, integrate.nhc_masses,
               integrate.npt_baro_masses, integrate.NHCState.zeros,
               run.main):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    pot = synthetic_fe_potential(0, npsf=4, ntsf=5, nnod=6, cut=4.0)
    calls = (lambda: annp.make_annp(pot, torch.float64),
             lambda: integrate.nhc_masses(30, 300.0, 0.1, 3, torch.float64),
             lambda: integrate.npt_baro_masses(10, 300.0, 1.0,
                                               torch.float64),
             lambda: integrate.NHCState.zeros(3, torch.float64))
    for call in calls:
        with pytest.raises((AssertionError, RuntimeError)):
            call()
