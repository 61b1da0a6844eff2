"""The yardstick's census against a brute-force count, and the work
functions' figures per lane, leg pair and atom (never per padded slot)."""
from __future__ import annotations

import numpy as np
import torch

from mdbench import counts, found, potentials
from mdbench.lattice import lattice


def brute(x, box, pbc, rc):
    d = x[:, None, :] - x[None, :, :]
    for a in range(3):
        if pbc[a]:
            d[..., a] -= box[a] * np.round(d[..., a] / box[a])
    r = np.sqrt((d * d).sum(-1))
    within = (r < rc) & (r > 1e-6)
    lanes = int(within.sum())
    legs = 0
    for i in range(len(x)):
        j = np.nonzero(within[i])[0]
        dj = d[i, j]
        djk = np.sqrt(((dj[:, None] - dj[None]) ** 2).sum(-1))
        legs += int(np.triu(djk < rc, 1).sum())
    return lanes, legs


def test_census_matches_brute_force():
    rng = np.random.default_rng(0)
    for kind, cells, a, pbc, rc in (("fcc", 4, 3.52, (True,) * 3, 3.9),
                                    ("bcc", 5, 2.8553, (False, True, False),
                                     4.1)):
        x, box = lattice(kind, cells, a)
        x = x + rng.normal(scale=0.1, size=x.shape)
        c = counts.census(torch.tensor(x), torch.tensor(box), pbc, rc,
                          legs=True)
        assert (c["lanes"], c["legs"]) == brute(x, box, pbc, rc)
        assert c["atoms"] == len(x)


def test_work_per_unit():
    fe = potentials.canonical(found.data("configs", "fe-annp"), "cpu")
    w = found.load("reference", "chebyshev").work(
        fe, {"atoms": 1, "lanes": 1, "legs": 0})
    n_lm = 19 * 20 // 2
    assert w["g_harm"][0] == 20 + 4 * 9 + 9 * n_lm
    assert w["force_harm"][0] == 20 + 8 * 9 + 22 * n_lm + 30
    assert w["g_harm"][1] == 4 * (3 + 9 + 19 + 1 + 19 * 19)
    w2 = found.load("reference", "chebyshev").work(
        fe, {"atoms": 2, "lanes": 2, "legs": 0})
    assert w2["step"] == 2 * w["step"]
    ni = potentials.canonical(found.data("configs", "ni-bp"), "cpu")
    lane = found.load("reference", "behler").work(
        ni, {"atoms": 0, "lanes": 1, "legs": 0})
    leg = found.load("reference", "behler").work(
        ni, {"atoms": 0, "lanes": 0, "legs": 1})
    assert lane["ni_g"][0] == 15 + 10 * 3
    # 3 eta groups, 24 functions, zeta 1, 2, 4, 16: 6 x 7 squarings
    assert leg["ni_g"][0] == 20 + 2 * 3 + 5 * 24 + 2 * 42
    assert leg["ni_force"][0] == 24 + 2 * 3 + 8 * 24 + 2 * 42 + 8 + 44


def test_roofline_share():
    assert counts.roofline_share(67e12, 0, 1.0) == 100.0
    assert counts.roofline_share(0, 3.35e12, 2.0) == 50.0
