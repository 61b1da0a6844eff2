"""No run of the benchmark loads JAX or the JAX package: module names are
compared whole by their top level, because the port's name begins with
the JAX package's."""
from __future__ import annotations

import json
import subprocess
import sys

from cpu_cells import run_cpu, small_copy

BUILD = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
from mdbench import found, harness, potentials
from mdbench.program import Program
for cell in ("fe-annp.bulk-npt-500k", "ni-bp.fcc-nvt-1200k"):
    wl = found.data("workloads", cell)
    cfg = found.data("configs", wl["config"])
    pot = potentials.build(cfg, 3, "cpu")
    x, box = found.load("scenes", wl["scene"]["builder"]).build(
        wl["scene"], cfg, "cpu")
    Program(pot, wl, len(x), box, torch.device("cpu"))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_forbidden_names_are_whole():
    from mdbench import harness
    before = dict(sys.modules)
    try:
        sys.modules.setdefault("meng_zhang_tpu_torch_fake", sys)
        assert "meng_zhang_tpu" not in harness.forbidden_modules() or \
            "meng_zhang_tpu" in before
        sys.modules["jaxlib.fake"] = sys
        assert "jaxlib" in harness.forbidden_modules()
    finally:
        sys.modules.pop("meng_zhang_tpu_torch_fake", None)
        sys.modules.pop("jaxlib.fake", None)


def test_building_cells_loads_no_jax(tmp_path):
    root = small_copy(str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", BUILD], cwd=root,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "meng_zhang_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "meng_zhang_tpu"}


def test_a_whole_run_loads_no_jax(tmp_path):
    root = small_copy(str(tmp_path))
    out = run_cpu(root, "ni-bp.fcc-nvt-1200k", 4)
    assert out["forbidden"] == []
