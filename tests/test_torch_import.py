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
from meng_zhang_tpu_torch.models import anna_adp, annp
from meng_zhang_tpu_torch.parallel import domain, domain2d, domain3d, mesh
from meng_zhang_tpu_torch.testing import (synthetic_anna_potential,
                                          synthetic_fe_potential,
                                          synthetic_ni_potential)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
import numpy as np
import torch
import meng_zhang_tpu_torch
from meng_zhang_tpu_torch import profiling, run, tools
from meng_zhang_tpu_torch.geometry import lattice, screw, stgb
from meng_zhang_tpu_torch.io import dump, lammps_data, native, potential
from meng_zhang_tpu_torch.md import checkpoint, integrate, minimize, simulation
from meng_zhang_tpu_torch.models import anna_adp, annp, descriptors, mlp
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
from meng_zhang_tpu_torch.testing import synthetic_anna_potential
cfg, params = anna_adp.make_anna(
    synthetic_anna_potential(0, npsf=4, ntsf=5, nnod=6, cut=4.0),
    torch.float64, device="cpu")
e, f, w = anna_adp.energy_forces_virial(cfg, params, x, box, nbrs.idx)
assert torch.isfinite(f).all() and f.shape == (16, 3)
from meng_zhang_tpu_torch.testing import (synthetic_fe_potential_multi,
                                          synthetic_ni_potential_multi,
                                          with_elements)
from meng_zhang_tpu_torch.models.annp import (energy_forces_virial,
                                              energy_forces_virial_images,
                                              image_shift_table)
from meng_zhang_tpu_torch.system.neighbors import (
    build_neighbors_cell_rowsweep, build_neighbors_images, needs_rebuild)
cfg, params = annp.make_annp(
    synthetic_fe_potential_multi(2, npsf=4, ntsf=5, nnod=6, cut=4.0),
    torch.float64, device="cpu")
el = torch.arange(16) % 2
e, f, w = fused_annp.FusedAnnp(cfg, params, k_short=16,
                               elems=el).energy_forces(x, box, nbrs.idx)
e, f, w = energy_forces_virial(cfg, params, x, box, nbrs.idx, el)
assert torch.isfinite(f).all() and not bool(needs_rebuild(nbrs, x, box, 1.0))
shifts, pbc_eff = image_shift_table(np.array([2.8553, 9.0, 9.0]), 4.5,
                                    (True,) * 3)
assert shifts.shape == (5, 3) and pbc_eff == (False, True, True)
assert callable(build_neighbors_cell_rowsweep) and callable(
    build_neighbors_images) and callable(energy_forces_virial_images)
assert len(synthetic_ni_potential_multi(2).networks) == 2
from meng_zhang_tpu_torch.ops import frames
from meng_zhang_tpu_torch.parallel import domain, mesh
from meng_zhang_tpu_torch.system.cell import pair_displacements, volume, wrap
from meng_zhang_tpu_torch.md.integrate import BarostatState
from meng_zhang_tpu_torch.models.annp import (atom_energy, raw_nn_energy,
                                              energy_forces_virial_frame)
from meng_zhang_tpu_torch.models.anna_adp import (
    _frame_planes, energy_forces_frame, energy_forces_frame_fast)
assert isinstance(native.available(), bool) and callable(atom_energy)
assert float(volume(box)) == 729.0 and callable(raw_nn_energy)
assert float(wrap(x - 9.0, box).min()) >= 0.0
assert pair_displacements(x, nbrs.idx.clamp(max=15), box).shape == (16, 16, 3)
assert BarostatState._fields == ("v_eps", "nhc")
for name in ("AnnpFrameModel", "FrameShortModel", "XlaFrameModel",
             "AnnaFrameModel", "ShardConfig", "ShardedMD", "ShardState",
             "FrameShort"):
    assert hasattr(domain, name), name
assert domain.OVF_COVERAGE == 4 and callable(frames.evaluate_frames)
assert mesh.ShardMesh(4, "cpu").psum(torch.ones(4, 2)).tolist() == [4.0, 4.0]
from meng_zhang_tpu_torch.parallel import domain2d, domain3d
for mod, names in ((domain2d, ("plan_park_sites", "Plan2D", "Shard2DConfig",
                               "ShardedMD2D")),
                   (domain3d, ("Plan3D", "Shard3DConfig", "ShardedMD3D"))):
    for name in names:
        assert hasattr(mod, name), name
t = torch.arange(8).view(4, 2)
assert torch.equal(mesh.ShardMesh(4, "cpu").ppermute(
    t, [(i, (i + 1) % 4) for i in range(4)]), mesh.ShardMesh(
    4, "cpu").ring_shift(t, 1))
assert domain2d.plan_park_sites(10, 5.0, 8.0, 8.0, 3.0, 8)[1].shape == (10, 3)
from meng_zhang_tpu_torch.parallel import launch
assert callable(launch.init_mesh) and callable(launch.spawn)
assert mesh.ShardMesh(4, "cpu").n_local == 4
from meng_zhang_tpu_torch.scripts import disloc_core, scale_demo
assert scale_demo.md_config("2m", 6.5, np.array([460.0, 325.0, 212.0])
                            ).cell_dims == (63, 44, 29)
assert callable(disloc_core.main) and callable(scale_demo.main)
from meng_zhang_tpu_torch.scripts import (
    bench, halo_fraction, model_bench, profile_2m, profile_bench, profile_ni,
    sharded2d_demo, sharded_demo)
for mod in (bench, halo_fraction, model_bench, profile_2m, profile_bench,
            profile_ni, sharded2d_demo, sharded_demo):
    assert callable(mod.main) and callable(mod.build_parser), mod
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
    """make_annp, make_anna, both params_from_numpy, the md/integrate.py
    helpers, the CLI's run.main and the sharded drivers (ShardedMD,
    ShardedMD2D, ShardedMD3D, ShardMesh) put their tensors on the card
    unless the caller names another device; on a torch without CUDA a call
    without a device raises instead of handing back CPU tensors (run.main:
    tests/test_torch_run.py)."""
    for fn in (annp.make_annp, annp.params_from_numpy, anna_adp.make_anna,
               anna_adp.params_from_numpy, integrate.nhc_masses,
               integrate.npt_baro_masses, integrate.NHCState.zeros,
               run.main, domain.ShardedMD, domain2d.ShardedMD2D,
               domain3d.ShardedMD3D, mesh.ShardMesh):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    pot = synthetic_fe_potential(0, npsf=4, ntsf=5, nnod=6, cut=4.0)
    model = domain.XlaFrameModel(*annp.make_annp(pot, torch.float64,
                                                 device="cpu"))
    calls = (lambda: annp.make_annp(pot, torch.float64),
             lambda: anna_adp.make_anna(synthetic_anna_potential(0),
                                        torch.float64),
             lambda: integrate.nhc_masses(30, 300.0, 0.1, 3, torch.float64),
             lambda: integrate.npt_baro_masses(10, 300.0, 1.0,
                                               torch.float64),
             lambda: integrate.NHCState.zeros(3, torch.float64),
             lambda: mesh.ShardMesh(4),
             lambda: domain2d.ShardedMD2D(
                 model, 55.845, np.ones(3) * 20,
                 domain2d.Shard2DConfig(n_devices=4, c_loc=8, cutoff=4.0,
                                        skin=0.5, dt=0.001)),
             lambda: domain3d.ShardedMD3D(
                 model, 55.845, np.ones(3) * 20,
                 domain3d.Shard3DConfig(n_devices=8, c_loc=8, cutoff=4.0,
                                        skin=0.5, dt=0.001)))
    for call in calls:
        with pytest.raises((AssertionError, RuntimeError)):
            call()


# every script with the argv of a run (not started: without a card the
# device is refused first)
SCRIPT_ARGV = {
    "scale_demo": ["--config", "500k"], "disloc_core": [],
    "model_bench": ["--model", "ni"], "profile_bench": [],
    "profile_ni": [], "profile_2m": [], "sharded_demo": [],
    "sharded2d_demo": [], "halo_fraction": [], "bench": [],
}


@pytest.mark.parametrize("name", sorted(SCRIPT_ARGV))
def test_scripts_default_to_the_card(name):
    """Each script's main(argv, device=None) runs on the card unless the
    caller names another device; on a torch without CUDA it exits before
    it builds anything."""
    import importlib
    mod = importlib.import_module(f"meng_zhang_tpu_torch.scripts.{name}")
    assert inspect.signature(mod.main).parameters["device"].default is None
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main(SCRIPT_ARGV[name])
