"""The harmonic-path kernels' plain versions and the short list: the port
against the JAX package's Pallas kernels (interpret mode) on the same
displacement planes.

Tolerances (f64): the plain versions run the same recurrences as the Pallas
kernels, but torch and XLA sum the lanes in different orders, so each output
agrees to a few hundred ulps of its largest value: max |diff| <= 1e-12 of
max |value|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu.models.annp import make_annp as jax_make_annp
from meng_zhang_tpu.ops import pallas_annp as jpa
from meng_zhang_tpu.system.neighbors import build_neighbors_n2 as jax_n2
from meng_zhang_tpu_torch.models.annp import make_annp
from meng_zhang_tpu_torch.ops import fused_annp as fa
from meng_zhang_tpu_torch.ops import kernels
from meng_zhang_tpu_torch.system.neighbors import build_neighbors_n2
from torch_port_util import (kernel_coeffs, perturbed_bcc, reduced_potential,
                             rel_max, short_planes, t64)

RTOL = 1e-12


def _cfg_key(npsf, ntsf, cut):
    return (("npsf", npsf), ("ntsf", ntsf), ("rc", cut))


def _compare_kernels(planes, filler, npsf, ntsf, cut):
    dedg, b = kernel_coeffs(planes[0].shape[0], npsf, ntsf)
    key = _cfg_key(npsf, ntsf, cut)
    jp = [jnp.asarray(a) for a in planes]
    g_j, a_j = jpa._run_g_harm(*jp, key)
    f_j = jpa._run_force_harm(*jp, jnp.asarray(dedg), jnp.asarray(b), key)
    tp = [t64(a) for a in planes]
    g_t, a_t = fa.g_harm_plain(*tp, npsf, ntsf, cut)
    f_t = fa.force_harm_plain(*tp, t64(dedg), t64(b), npsf, ntsf, cut)
    assert rel_max(g_t, g_j) <= RTOL
    assert rel_max(a_t, a_j) <= RTOL
    for got, want in zip(f_t, f_j):
        assert rel_max(got, want) <= RTOL
    # filler lanes contribute exactly nothing
    assert filler.any()
    for got in f_t:
        assert np.all(got.numpy()[filler] == 0.0)


def test_tables_equal_jax():
    for ntsf in (1, 5, 19):
        np.testing.assert_array_equal(fa.cheb_legendre(ntsf),
                                      jpa._cheb_legendre(ntsf))
        assert fa.harm_layout(ntsf - 1) == jpa._harm_layout(ntsf - 1)
        assert fa.harm_tables(ntsf - 1) == jpa._harm_tables(ntsf - 1)
    h0, d1, e1, e2 = fa.harm_tables(18)
    tab = fa.ladder_table(18)
    assert tab[:19].tolist() == h0 and tab[19:37].tolist() == d1
    assert tab[38 + 5 * 19 + 2] == e1[(5, 2)]
    assert tab[38 + 361 + 7 * 19 + 3] == e2[(7, 3)]


@pytest.mark.parametrize("npsf,ntsf", [(4, 5), (2, 1)])
def test_plain_kernels_match_pallas_reduced(npsf, ntsf):
    _compare_kernels(*short_planes(3, 4.0, 32), npsf, ntsf, 4.0)


@pytest.fixture(scope="module")
def full_width_planes():
    p, filler = short_planes(5, 6.5, 128, seed=3)
    return [a[:16] for a in p], filler[:16]   # 16 rows: the interpreter's cost


def test_plain_kernels_match_pallas_full_width(full_width_planes):
    _compare_kernels(*full_width_planes, 9, 19, 6.5)


def test_wrappers_take_plain_on_cpu():
    planes = [t64(a) for a in short_planes(3, 4.0, 32)[0]]
    dedg, b = (t64(a) for a in kernel_coeffs(planes[0].shape[0], 4, 5))
    before = (kernels.g_harm.launches, kernels.force_harm.launches)
    g, a = kernels.g_harm(*planes, 4, 5, 4.0)
    g0, a0 = fa.g_harm_plain(*planes, 4, 5, 4.0)
    assert torch.equal(g, g0) and torch.equal(a, a0)
    f = kernels.force_harm(*planes, dedg, b, 4, 5, 4.0)
    f0 = fa.force_harm_plain(*planes, dedg, b, 4, 5, 4.0)
    assert all(torch.equal(u, v) for u, v in zip(f, f0))
    assert (kernels.g_harm.launches, kernels.force_harm.launches) == before
    meta = [t.to("meta") for t in planes]
    with pytest.raises(ValueError):
        kernels.g_harm(*meta, 4, 5, 4.0)


@pytest.mark.parametrize("pbc", [(True, True, True), (False, True, False)])
def test_compact_short_matches_jax_revfree(pbc):
    pot = reduced_potential(cut=4.0)
    x, box = perturbed_bcc((3, 4, 3), seed=5, disp=0.1)
    jcfg, jparams = jax_make_annp(pot, dtype=jnp.float64, pbc=pbc)
    jn = jax_n2(jnp.asarray(x), jnp.asarray(box), 4.5, 48, pbc=pbc)
    pk = jpa.PallasAnnp(jcfg, jparams, k_short=32, short_delta=0.4)
    want = pk.compact_short(jnp.asarray(x), jnp.asarray(box), jn.idx, None)
    cfg, params = make_annp(pot, torch.float64, device="cpu", pbc=pbc)
    ev = fa.FusedAnnp(cfg, params, k_short=32, short_delta=0.4)
    got = ev.compact_short(t64(x), t64(box),
                           torch.as_tensor(np.asarray(jn.idx)).long())
    np.testing.assert_array_equal(got.sidx.numpy(),
                                  np.asarray(want.sidx)[:len(x)])
    assert not bool(got.overflow) and not bool(want.overflow)


def test_short_overflow_poisons():
    pot = reduced_potential(cut=4.0)
    x, box = perturbed_bcc(4, seed=6)
    cfg, params = make_annp(pot, torch.float64, device="cpu")
    nbrs = build_neighbors_n2(t64(x), t64(box), 4.5, 48)
    ev = fa.FusedAnnp(cfg, params, k_short=16, short_delta=0.4)
    sl = ev.compact_short(t64(x), t64(box), nbrs.idx)
    assert bool(sl.overflow)
    e, f, w = ev.energy_forces_short(t64(x), t64(box), sl)
    assert torch.isnan(e) and torch.isnan(f).all()
    jcfg, jparams = jax_make_annp(pot, dtype=jnp.float64)
    jn = jax_n2(jnp.asarray(x), jnp.asarray(box), 4.5, 48)
    pk = jpa.PallasAnnp(jcfg, jparams, k_short=16, short_delta=0.4)
    jsl = pk.compact_short(jnp.asarray(x), jnp.asarray(box), jn.idx, None)
    je, jf = pk.energy_forces_short(jnp.asarray(x), jnp.asarray(box), jsl)
    assert bool(jsl.overflow) and np.isnan(float(je))
    assert np.isnan(np.asarray(jf)).all()
