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


@pytest.mark.parametrize("pbc", PBCS)
def test_rowsweep_matches_jax(pbc):
    """build_neighbors_cell_rowsweep under the JAX name and signature: the
    JAX row sweep's rows and flags, and build_neighbors_cell's, which it
    is; the Simulator's nbr_method="rowsweep" builds the same list."""
    x, box = perturbed_bcc((5, 6, 5), seed=2, disp=0.1)
    dims = tn.cell_grid_dims(box, 4.5)
    xj, bj = jnp.asarray(x), jnp.asarray(box)
    for cap, cell_cap in ((40, 24), (20, 24), (40, 4)):
        want = jn.build_neighbors_cell_rowsweep(xj, bj, 4.5, cap, dims,
                                                cell_cap, row_chunk=64,
                                                pbc=pbc)
        got = tn.build_neighbors_cell_rowsweep(t64(x), t64(box), 4.5, cap,
                                               dims, cell_cap, row_chunk=64,
                                               pbc=pbc)
        cell = tn.build_neighbors_cell(t64(x), t64(box), 4.5, cap, dims,
                                       cell_cap, pbc=pbc)
        assert bool(got.overflow) == bool(want.overflow) \
            == bool(cell.overflow)
        if not bool(want.overflow):
            np.testing.assert_array_equal(got.idx.numpy(),
                                          np.asarray(want.idx))
        assert torch.equal(got.idx, cell.idx)
    with pytest.raises(NotImplementedError):
        tn.build_neighbors_cell_rowsweep(t64(x), t64(box), 4.5, 40, dims, 24,
                                         with_rev=True)
    from meng_zhang_tpu_torch.md.simulation import MDConfig, Simulator
    sims = [Simulator(None, torch.ones(len(x), dtype=torch.float64),
                      MDConfig(dt=0.001, cutoff=4.0, skin=0.5, capacity=40,
                               nbr_method=m, cell_dims=dims,
                               cell_capacity=24, pbc=pbc))
            for m in ("rowsweep", "cell")]
    a, b = (s.build_nbrs(t64(x), t64(box)) for s in sims)
    assert torch.equal(a.idx, b.idx) and not bool(a.overflow)


@pytest.mark.parametrize("pbc", PBCS)
def test_needs_rebuild_matches_jax(pbc):
    """True exactly when some atom moved more than skin/2 since the build,
    on both sides of the threshold, as the JAX function; a periodic image
    of the reference position does not count on a periodic axis."""
    x, box = perturbed_bcc(3, seed=4)
    skin = 0.8
    nt = tn.build_neighbors_n2(t64(x), t64(box), 4.5, 40, pbc=pbc)
    nj = jn.build_neighbors_n2(jnp.asarray(x), jnp.asarray(box), 4.5, 40,
                               pbc=pbc)
    for move, rebuild in ((0.5 * skin * (1 - 1e-6), False),
                          (0.5 * skin * (1 + 1e-6), True)):
        x1 = x.copy()
        x1[7, 1] += move
        x1[3, 1] += box[1]               # y is periodic in both layouts
        got = tn.needs_rebuild(nt, t64(x1), t64(box), skin, pbc)
        want = jn.needs_rebuild(nj, jnp.asarray(x1), jnp.asarray(box), skin,
                                pbc)
        assert isinstance(got, torch.Tensor)
        assert bool(got) == bool(want) == rebuild


@pytest.mark.parametrize("capacity", [12, 80], ids=["narrower", "wider"])
def test_compact_rows_copies_out_of_the_sorted_keys(capacity):
    """The packed rows equal the JAX package's and own storage of their own
    size: a view into the sorted [R, C] keys kept each chunk's whole sort
    alive until the cell build's final cat (~20 GiB on the 1,964,085-atom
    config-5 scene)."""
    rng = np.random.default_rng(5)
    r, c, n = 64, 48, 1000
    within = rng.random((r, c)) < 0.2
    cand = rng.integers(0, n, (r, c))
    got, cnt = tn._compact_rows(torch.as_tensor(within),
                                torch.as_tensor(cand), capacity, n)
    want, wcnt = jn._compact_rows(jnp.asarray(within), jnp.asarray(cand),
                                  capacity, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))
    assert got.untyped_storage().nbytes() == r * capacity * 8

