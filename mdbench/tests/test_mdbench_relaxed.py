"""Relaxed positions kept as data: a file read back moves the scene by its
displacements, and one made for another scene or potential is refused."""
from __future__ import annotations

import numpy as np
import pytest

from mdbench import relaxed
from mdbench.lattice import lattice


def _pot(shift=0.0):
    return {"weights": [np.eye(2) + shift], "biases": [np.zeros(2)],
            "norm_row0": np.ones(2), "norm_row1": np.zeros(2)}


def test_displacements_are_read_back_and_checked(tmp_path, monkeypatch):
    monkeypatch.setattr(relaxed, "HERE", str(tmp_path))
    x, box = lattice("bcc", 3, 2.8553)
    dx = np.random.default_rng(0).integers(-2000, 2000, x.shape)
    np.savez_compressed(tmp_path / "r.npz", dx=dx.astype(np.int16),
                        key=np.array(relaxed.key(x, box, _pot())))
    spec = {"relaxed": "r.npz"}
    assert np.abs(relaxed.apply(spec, x, box, _pot()) - x
                  - dx * relaxed.UNIT).max() < 1e-12
    assert relaxed.apply({}, x, box, _pot()) is x
    with pytest.raises(ValueError):
        relaxed.apply(spec, x, box, _pot(1e-3))
    with pytest.raises(ValueError):
        relaxed.apply(spec, x + 0.01, box, _pot())
