"""The comparison that decides `correct`, on small cells on the CPU: sound
runs pass, the control (the reference in TF32 in the program's place)
fails, and a run whose timed path is broken underneath comes out not
correct, once for each fault such a cell can have (one card: no exchange
between chips to leave out)."""
from __future__ import annotations

import pytest

from mdbench import check
from cpu_cells import run_cpu, small_copy


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_copy(str(tmp_path_factory.mktemp("mdbench")))


@pytest.mark.parametrize("cell", ["fe-annp.bulk-npt-500k",
                                  "ni-bp.fcc-nvt-1200k"])
def test_program_passes_and_control_fails(root, cell):
    out = run_cpu(root, cell, 2**31 + 77, control=True)
    ok, _, failed = check.verdict(out["program"], out["limits"])
    assert ok, failed
    control = {k: v for k, v in out["control"].items()
               if not k.startswith("_")}
    ok, _, failed = check.verdict(control, out["limits"])
    assert not ok and "force_gap" in failed


@pytest.mark.parametrize("fault", ["frozen_step", "half_batch",
                                   "altered_answer"])
def test_broken_timed_path_is_not_correct(root, fault):
    cell, seed = "fe-annp.bulk-npt-500k", 2**31 + 78
    atom = int(check.seeded(432, 64, seed, 1)[0])
    out = run_cpu(root, cell, seed, fault=fault, atom=atom)
    assert out["correct"] is False, out["checks"]


def test_sound_run_is_correct(root):
    out = run_cpu(root, "fe-annp.bulk-npt-500k", 2**31 + 78)
    assert out["correct"] is True, out["checks"]
