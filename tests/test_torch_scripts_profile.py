"""The port's per-phase profiles (meng_zhang_tpu_torch/scripts/
profile_bench.py, profile_ni.py, profile_2m.py), counterparts of the JAX
package's scripts of those names, at reduced scenes in f64 on the CPU, on
reduced synthetic potentials written as .ann files: every phase of the JAX
script that the port keeps is in the record with a positive time, the
shares are of the step, and the chained phases (gather, the kernels and
the MLP, deliver, and the pair virial where the profile has it) give
energy_forces_short's energy, forces and virial to 1e-12 of their scale,
as each phase times the code the evaluator runs.
"""
import numpy as np
import pytest
import torch

from meng_zhang_tpu_torch.io.potential import write_ann
from meng_zhang_tpu_torch.scripts import (profile_2m, profile_bench,
                                          profile_ni, scale_demo)
from meng_zhang_tpu_torch.testing import thermal_bcc
from torch_port_util import reduced_ni_potential, reduced_potential

PHASES = {
    "bench": ("rebuild", "compact", "gather", "g_kernel", "mlp", "f_kernel",
              "deliver", "virial", "energy_forces", "step_block"),
    "ni": ("rebuild", "compact", "gather", "g_kernel", "mlp", "f_kernel",
           "deliver", "ef", "efv", "step_block"),
    "2m": ("rebuild", "compact", "gather", "kernels_mlp", "deliver",
           "energy_forces", "step_block"),
}


@pytest.fixture(scope="module")
def pot_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pots")
    fe, ni = str(d / "fe.ann"), str(d / "ni.ann")
    write_ann(fe, reduced_potential())
    write_ann(ni, reduced_ni_potential())
    return {"fe": fe, "ni": ni}


def _run(name, pot_files):
    if name == "bench":
        # 9^3 bcc cells: y holds three cells of rlist at 0.92 of the box
        return profile_bench.main(
            ["--potential", pot_files["fe"]], device="cpu",
            scene=thermal_bcc(9, seed=0, disp=0.05), reps=1,
            dtype=torch.float64)
    if name == "ni":
        return profile_ni.main(["--cells", "4", "--potential",
                                pot_files["ni"]], device="cpu", reps=1,
                               dtype=torch.float64)
    return profile_2m.main(["--potential", pot_files["fe"]], device="cpu",
                           scene=scale_demo.build_scene("2m", 0.12)[:2],
                           reps=1, dtype=torch.float64)


@pytest.mark.parametrize("name", ["bench", "ni", "2m"])
def test_profile_phases_chain_to_energy_forces(name, pot_files):
    run = _run(name, pot_files)
    rec = run.record
    assert tuple(rec["times_s"]) == PHASES[name]
    assert all(t > 0.0 for t in rec["times_s"].values())
    step = rec["times_s"]["step_block"] / (5 if name == "ni" else 1)
    for k, t in rec["times_s"].items():
        assert rec["share_of_step"][k] == pytest.approx(t / step, rel=1e-12)
    assert rec["atom_steps_per_s_step"] == pytest.approx(rec["atoms"] / step,
                                                         rel=1e-12)
    assert rec["device"] == "cpu"
    for got, want in zip(run.chained, run.ef):
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1.0)
        assert float(np.abs(np.asarray(got) - want).max()) <= 1e-12 * scale
    assert len(run.chained) == (3 if name == "bench" else 2)
    assert bool(torch.isfinite(run.ef[1]).all())
    if name == "2m":
        assert rec["peak_mem_gib_by_phase"] is None
