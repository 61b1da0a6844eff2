"""The PyTorch port never imports JAX."""
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
import numpy as np
import torch
import meng_zhang_tpu_torch
from meng_zhang_tpu_torch.md import integrate, simulation
from meng_zhang_tpu_torch.models import annp, descriptors, mlp
from meng_zhang_tpu_torch.ops import fused_annp, kernels
from meng_zhang_tpu_torch.system import cell, neighbors
from meng_zhang_tpu_torch.testing import synthetic_fe_potential
pot = synthetic_fe_potential(0, npsf=4, ntsf=5, nnod=6, cut=4.0)
cfg, params = annp.make_annp(pot, torch.float64)
x = torch.tensor(np.random.default_rng(0).uniform(0.0, 9.0, (16, 3)))
box = torch.full((3,), 9.0, dtype=torch.float64)
nbrs = neighbors.build_neighbors_n2(x, box, 4.0, 16)
ev = fused_annp.FusedAnnp(cfg, params, k_short=16)
e, f, w = ev.energy_forces(x, box, nbrs.idx)
assert torch.isfinite(f).all() and f.shape == (16, 3)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
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
    allowed = {".units", ".io.potential", ".io.lammps_data",
               ".geometry.lattice"}
    for path in _port_sources():
        for mod in _OLD_PKG.findall(_read(path)):
            assert mod in allowed, (path, "meng_zhang_tpu" + mod)


def test_smoke_imports_nothing_of_jax_package():
    src = _read(os.path.join(REPO, "chip_smoke.py"))
    assert "meng_zhang_tpu_torch" in src
    assert not _OLD_PKG.findall(src)
