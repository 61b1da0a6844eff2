"""Neighbor lists and the cell: the port against the JAX package.

Rows of both packages hold their partner ids ascending, padded with N, so
the per-row sets compare as exact integer arrays.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu.system import cell as jcell
from meng_zhang_tpu.system import neighbors as jn
from meng_zhang_tpu_torch.system import cell as tcell
from meng_zhang_tpu_torch.system import neighbors as tn
from torch_port_util import perturbed_bcc, t64

PBCS = [(True, True, True), (False, True, False)]


@pytest.mark.parametrize("pbc", PBCS)
def test_min_image(pbc):
    rng = np.random.default_rng(3)
    dx = rng.uniform(-20.0, 20.0, (64, 3))
    box = np.array([9.0, 11.0, 13.0])
    want = np.asarray(jcell.min_image(jnp.asarray(dx), jnp.asarray(box), pbc))
    got = tcell.min_image(t64(dx), t64(box), pbc).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pbc", PBCS)
def test_n2_matches_jax(pbc):
    x, box = perturbed_bcc(3, seed=1, disp=0.1)
    want = jn.build_neighbors_n2(jnp.asarray(x), jnp.asarray(box), 4.5, 40,
                                 pbc=pbc)
    got = tn.build_neighbors_n2(t64(x), t64(box), 4.5, 40, pbc=pbc)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    assert not bool(got.overflow) and not bool(want.overflow)


@pytest.mark.parametrize("pbc", PBCS)
def test_cell_matches_jax_and_n2(pbc):
    x, box = perturbed_bcc((5, 6, 5), seed=2, disp=0.1)
    dims = tn.cell_grid_dims(box, 4.5)
    assert dims == jn.cell_grid_dims(box, 4.5)
    want = jn.build_neighbors_cell(jnp.asarray(x), jnp.asarray(box), 4.5, 40,
                                   dims, 24, pbc=pbc)
    got = tn.build_neighbors_cell(t64(x), t64(box), 4.5, 40, dims, 24,
                                  row_chunk=100, pbc=pbc)
    n2 = tn.build_neighbors_n2(t64(x), t64(box), 4.5, 40, pbc=pbc)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.idx.numpy(), n2.idx.numpy())
    assert not bool(got.overflow) and not bool(want.overflow)


def test_overflow_flags():
    x, box = perturbed_bcc((5, 6, 5), seed=2, disp=0.1)
    xt, bt = t64(x), t64(box)
    xj, bj = jnp.asarray(x), jnp.asarray(box)
    dims = tn.cell_grid_dims(box, 4.5)
    # per-atom count > K
    assert bool(tn.build_neighbors_n2(xt, bt, 4.5, 20).overflow)
    assert bool(jn.build_neighbors_n2(xj, bj, 4.5, 20).overflow)
    assert bool(tn.build_neighbors_cell(xt, bt, 4.5, 20, dims, 24).overflow)
    # cell overflow
    assert bool(tn.build_neighbors_cell(xt, bt, 4.5, 40, dims, 4).overflow)
    assert bool(jn.build_neighbors_cell(xj, bj, 4.5, 40, dims, 4).overflow)
    # dims_stale: a grid finer than the cutoff allows (a shrunk NPT box)
    fine = tuple(d + 1 for d in dims)
    assert bool(tn.build_neighbors_cell(xt, bt, 4.5, 40, fine, 24).overflow)
    assert bool(jn.build_neighbors_cell(xj, bj, 4.5, 40, fine, 24).overflow)
    with pytest.raises(ValueError):
        tn.build_neighbors_cell(xt, bt, 4.5, 40, (2, 3, 3), 24)


@pytest.mark.parametrize("pbc", PBCS)
def test_max_displacement_sq(pbc):
    x, box = perturbed_bcc(3, seed=4)
    x1 = x + np.random.default_rng(5).normal(scale=0.3, size=x.shape)
    x1[0] += box                     # a periodic image must not count
    want = jn.max_displacement_sq(
        jn.build_neighbors_n2(jnp.asarray(x), jnp.asarray(box), 4.5, 40),
        jnp.asarray(x1), jnp.asarray(box), pbc)
    got = tn.max_displacement_sq(t64(x), t64(x1), t64(box), pbc)
    assert float(got) == pytest.approx(float(want), rel=1e-14)


def test_estimate_capacity():
    box = np.array([14.3, 17.1, 14.3])
    for cut in (4.5, 7.7):
        assert tn.estimate_capacity(box, cut, 500) == \
            jn.estimate_capacity(box, cut, 500)
