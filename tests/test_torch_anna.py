"""The port's ANNA-ADP model (meng_zhang_tpu_torch/models/anna_adp.py)
against the JAX package's (meng_zhang_tpu/models/anna_adp.py), both in f64
on the CPU from the same numpy positions, on synthetic potentials of the
shipped shape (testing.synthetic_anna_potential): the reduced width (npsf 4,
ntsf 5) wherever the JAX side reaches its Pallas kernel (interpret mode),
plus the full width (9, 19) on the reference-shaped functions, whose JAX side
is XLA only.

Phase 1 differs in formulation only: the JAX reference-shaped path sums the
angular descriptors over each row's [K, K] cos matrix, the port forms them
from g_harm's power sums S_l (G_n = 1/2 (sum_l c_nl S_l - F2)), which
subtracts terms of the size of (sum fc)^2 and loses ~1e-13 of |G|; through
the network (d2, q2) and the energies then agree to rtol 1e-10. Forces and
virials are sums of pair terms that cancel pairwise: F rtol 1e-8 (atol
1e-10 eV/A), W rtol 1e-8 (atol 1e-9 eV), the JAX package's own bars
between its two paths.

The hand forces carry the reference's d_rho quirk (no step factor on the
gamma terms). On ANNA_GPARAMS_QUIRK (gamma 0.6, hc 0.8: the density terms
reach the cutoff band where step < 1) the quirk moves the forces by far
more than rounding, so there a port that fixed it would fail the JAX
comparison, and the port's own hand and autodiff forces visibly differ.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle_numpy
from meng_zhang_tpu.models import anna_adp as J
from meng_zhang_tpu_torch.models import anna_adp as A
from meng_zhang_tpu_torch.ops import kernels
from meng_zhang_tpu_torch.system.neighbors import build_neighbors_n2
from meng_zhang_tpu_torch.testing import (ANNA_GPARAMS, ANNA_GPARAMS_QUIRK,
                                          synthetic_anna_potential)
from torch_port_util import perturbed_bcc, t64

REDUCED = dict(npsf=4, ntsf=5, nnod=6)
E_RTOL, F_RTOL, F_ATOL, W_RTOL, W_ATOL = 1e-10, 1e-8, 1e-10, 1e-8, 1e-9


def _np(a):
    return np.asarray(a, dtype=np.float64)


def _case(pot, cells=3, seed=7, disp=0.08, capacity=64,
          pbc=(True, True, True)):
    """Both packages' (cfg, params) of `pot`, a perturbed bcc box and its
    neighbor rows at the cutoff, as (port, jax) pairs of inputs."""
    x, box = perturbed_bcc(cells, seed=seed, disp=disp)
    cfg, params = A.make_anna(pot, torch.float64, "cpu", pbc=pbc)
    jcfg, jparams = J.make_anna(pot, dtype=jnp.float64, pbc=pbc)
    nb = build_neighbors_n2(t64(x), t64(box), cfg.cut, capacity, pbc)
    assert not bool(nb.overflow)
    port = types.SimpleNamespace(cfg=cfg, p=params, x=t64(x), box=t64(box),
                                 nb=nb, idx=nb.idx)
    jx = types.SimpleNamespace(cfg=jcfg, p=jparams, x=jnp.asarray(x),
                               box=jnp.asarray(box),
                               idx=jnp.asarray(nb.idx.numpy().astype(np.int32)))
    return port, jx


def _elems(n, seed=3):
    return np.random.default_rng(seed).integers(0, 2, n)


@pytest.mark.parametrize("width,ne", [("reduced", 1), ("reduced", 2),
                                      ("full", 1)])
def test_local_params_match_jax(width, ne):
    kw = REDUCED if width == "reduced" else {}
    pot = synthetic_anna_potential(0, elements=("Fe", "Cr")[:ne], **kw)
    t, j = _case(pot)
    el = _elems(len(t.x)) if ne == 2 else None
    got = A.local_params(t.cfg, t.p, t.x, t.box, t.idx,
                         None if el is None else torch.as_tensor(el))
    want = J.local_params(j.cfg, j.p, j.x, j.box, j.idx,
                          None if el is None else jnp.asarray(el, jnp.int32))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-10)
    # rows in chunks give the same values (to the matmuls' blocking)
    chunked = A.local_params(t.cfg, t.p, t.x, t.box, t.idx,
                             None if el is None else torch.as_tensor(el),
                             chunk=7)
    np.testing.assert_allclose(chunked.numpy(), got.numpy(), rtol=1e-14)
    if ne == 2:
        one = A.local_params(t.cfg, t.p, t.x, t.box, t.idx)
        assert not np.allclose(one.numpy()[el == 1], got.numpy()[el == 1])


def test_local_params_compacts_wide_rows_to_tiles():
    """Rows wider than kernels.MAX_K are compacted at the cutoff first:
    the same values as from rows that fit; rows with more partners than
    MAX_K within the cutoff are compacted to whole tiles of
    kernels.HARM_TILE, which g_harm takes as virtual rows, and match the
    JAX function on the full rows."""
    pot = synthetic_anna_potential(0, **REDUCED)
    t, _ = _case(pot)
    wide = build_neighbors_n2(t.x, t.box, t.cfg.cut + 0.5,
                              kernels.MAX_K + 40)
    assert wide.idx.shape[1] > kernels.MAX_K
    got = A.local_params(t.cfg, t.p, t.x, t.box, wide.idx)
    want = A.local_params(t.cfg, t.p, t.x, t.box, t.idx)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-13)
    rng = np.random.default_rng(0)
    dense = rng.uniform(0.0, 8.0, (640, 3))          # 520-574 partners
    box8 = np.full(3, 8.0)
    nb = build_neighbors_n2(t64(dense), t64(box8), t.cfg.cut, 640)
    assert int((nb.idx < 640).sum(1).max()) > kernels.MAX_K
    jcfg, jparams = J.make_anna(pot, dtype=jnp.float64)
    np.testing.assert_allclose(
        A.local_params(t.cfg, t.p, t64(dense), t64(box8), nb.idx).numpy(),
        _np(J.local_params(jcfg, jparams, jnp.asarray(dense),
                           jnp.asarray(box8), jnp.asarray(nb.idx.numpy()))),
        rtol=1e-10)


@pytest.mark.parametrize("width", ["reduced", "full"])
def test_atom_energies_fields_match_jax(width):
    kw = REDUCED if width == "reduced" else {}
    t, j = _case(synthetic_anna_potential(1, **kw), pbc=(True, False, True))
    lp = A.local_params(t.cfg, t.p, t.x, t.box, t.idx)
    jlp = jnp.asarray(lp.numpy())
    eps = np.array([[0.01, 0.002, 0.0], [0.002, -0.005, 0.001],
                    [0.0, 0.001, 0.003]])
    for e in (None, eps):
        got = A.atom_energies_fields(t.cfg, t.p, t.x, t.box, t.idx, lp,
                                     eps=None if e is None else t64(e))
        want = J.atom_energies_fields(j.cfg, j.p, j.x, j.box, j.idx, jlp,
                                      eps=None if e is None else jnp.asarray(e))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-10,
                                       atol=1e-13)
    np.testing.assert_allclose(
        A.atom_energies(t.cfg, t.p, t.x, t.box, t.idx).numpy(),
        _np(J.atom_energies(j.cfg, j.p, j.x, j.box, j.idx)), rtol=1e-10)
    np.testing.assert_allclose(
        float(A.energy(t.cfg, t.p, t.x, t.box, t.idx)),
        float(J.energy(j.cfg, j.p, j.x, j.box, j.idx)), rtol=1e-10)


def test_x_src_gathers_match_jax():
    """local_params and atom_energies_fields with a separate gather source:
    the box's atoms in another order (the rows' partner ids mapped to it)
    give the values of the plain call, and JAX's with the same x_src."""
    t, j = _case(synthetic_anna_potential(4, **REDUCED))
    n = len(t.x)
    perm = np.random.default_rng(5).permutation(n)
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    idx = t.idx.numpy()
    idx_src = np.where(idx < n, inv[np.minimum(idx, n - 1)], n)
    x_src = t.x[torch.as_tensor(perm)]
    lp = A.local_params(t.cfg, t.p, t.x, t.box, torch.as_tensor(idx_src),
                        x_src=x_src)
    np.testing.assert_allclose(
        lp.numpy(), A.local_params(t.cfg, t.p, t.x, t.box, t.idx).numpy(),
        rtol=1e-13)
    jidx = jnp.asarray(idx_src.astype(np.int32))
    jx_src = jnp.asarray(x_src.numpy())
    np.testing.assert_allclose(
        lp.numpy(), _np(J.local_params(j.cfg, j.p, j.x, j.box, jidx,
                                       x_src=jx_src)), rtol=1e-10)
    got = A.atom_energies_fields(t.cfg, t.p, t.x, t.box,
                                 torch.as_tensor(idx_src), lp, x_src=x_src)
    want = J.atom_energies_fields(j.cfg, j.p, j.x, j.box, jidx,
                                  jnp.asarray(lp.numpy()), x_src=jx_src)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-10,
                                   atol=1e-13)


@pytest.mark.parametrize("pbc", [(True, True, True), (False, True, False)],
                         ids=["ppp", "mpm"])
def test_hand_forces_match_jax(pbc):
    """energy_forces and energy_forces_virial (shift on and off) on the
    quirk-visible parameter set."""
    pot = synthetic_anna_potential(2, gparams=ANNA_GPARAMS_QUIRK, **REDUCED)
    t, j = _case(pot, pbc=pbc)
    e, f = A.energy_forces(t.cfg, t.p, t.x, t.box, t.idx)
    je, jf = J.energy_forces(j.cfg, j.p, j.x, j.box, j.idx)
    np.testing.assert_allclose(float(e), float(je), rtol=E_RTOL)
    np.testing.assert_allclose(f.numpy(), _np(jf), rtol=F_RTOL, atol=F_ATOL)
    for shift in (True, False):
        e, f, w = A.energy_forces_virial(t.cfg, t.p, t.x, t.box, t.idx,
                                         shift=shift)
        je, jf, jw = J.energy_forces_virial(j.cfg, j.p, j.x, j.box, j.idx,
                                            shift=shift)
        np.testing.assert_allclose(float(e), float(je), rtol=E_RTOL)
        np.testing.assert_allclose(f.numpy(), _np(jf), rtol=F_RTOL,
                                   atol=F_ATOL)
        np.testing.assert_allclose(w.numpy(), _np(jw), rtol=W_RTOL,
                                   atol=W_ATOL)
        np.testing.assert_array_equal(w.numpy(), w.numpy().T)
    assert float(f.sum(0).abs().max()) < 1e-9       # newton-off: pairwise


def test_quirk_visible_and_kept():
    """On the quirk-visible set the hand forces equal JAX's energy_forces
    and differ from the autodiff forces (the true frozen-(d2, q2)
    gradient) by far more than the comparison's tolerance; the autodiff
    forces match JAX's autodiff."""
    pot = synthetic_anna_potential(2, gparams=ANNA_GPARAMS_QUIRK, **REDUCED)
    t, j = _case(pot)
    _, f_hand = A.energy_forces(t.cfg, t.p, t.x, t.box, t.idx)
    e_ad, f_ad = A.energy_forces_autodiff(t.cfg, t.p, t.x, t.box, t.idx)
    je_ad, jf_ad = J.energy_forces_autodiff(j.cfg, j.p, j.x, j.box, j.idx)
    np.testing.assert_allclose(float(e_ad), float(je_ad), rtol=1e-10)
    np.testing.assert_allclose(f_ad.numpy(), _np(jf_ad), rtol=1e-10,
                               atol=1e-12)
    _, jf_hand = J.energy_forces(j.cfg, j.p, j.x, j.box, j.idx)
    quirk = float((f_hand - f_ad).abs().max())
    assert quirk > 1e3 * F_ATOL + F_RTOL * float(f_ad.abs().max())
    assert np.abs(f_hand.numpy() - _np(jf_hand)).max() < 1e-3 * quirk


def test_autodiff_matches_finite_differences():
    """energy_forces_autodiff is the gradient of the frozen-lp energy; on
    the production set it also agrees with the hand forces to 1e-3 of the
    largest force, the quirk being small there (~1e-4 eV/A)."""
    pot = synthetic_anna_potential(0, **REDUCED)
    t, _ = _case(pot)
    lp = A.local_params(t.cfg, t.p, t.x, t.box, t.idx)
    _, f = A.energy_forces_autodiff(t.cfg, t.p, t.x, t.box, t.idx)

    def e_of(xx):
        # without e_base: its ~2.4e5 eV would round the difference at 3e-11
        return float((A.atom_energies_fields(t.cfg, t.p, xx, t.box, t.idx,
                                             lp)[0] - t.cfg.e_base).sum())
    h = 1e-5
    for i, d in [(0, 0), (7, 1), (13, 2), (40, 0)]:
        xp, xm = t.x.clone(), t.x.clone()
        xp[i, d] += h
        xm[i, d] -= h
        fd = -(e_of(xp) - e_of(xm)) / (2 * h)
        np.testing.assert_allclose(float(f[i, d]), fd, rtol=1e-6, atol=1e-8)
    _, f_hand = A.energy_forces(t.cfg, t.p, t.x, t.box, t.idx)
    assert float((f_hand - f).abs().max()) < 1e-3 * float(f.abs().max())


def _fast(pot, k_short=64, chunk=16, pbc=(True, True, True)):
    t, j = _case(pot, pbc=pbc, capacity=96)
    t.fns = A.make_anna_fast_fns(t.cfg, t.p, k_short=k_short, delta=0.3,
                                 chunk=chunk)
    j.fns = J.make_anna_fast_fns(j.cfg, j.p, k_short=k_short, delta=0.3,
                                 chunk=chunk)
    nbj = types.SimpleNamespace(idx=j.idx)
    t.short = t.fns[2](t.x, t.box, t.nb)
    j.short = j.fns[2](j.x, j.box, nbj)
    return t, j, nbj


@pytest.mark.parametrize("gp,pbc", [
    (ANNA_GPARAMS_QUIRK, (True, True, True)),
    (ANNA_GPARAMS, (False, True, False))], ids=["quirk-ppp", "prod-mpm"])
def test_fast_fns_match_jax(gp, pbc):
    """make_anna_fast_fns (Pallas interpret on the JAX side, chunk 16 on
    both: the port's rows go in chunks without padding) against JAX's:
    the short rows equal, force_fn at the bars above, force_fn_light's
    forces equal force_fn's and its virial zero; and the fast path against
    the port's reference-shaped energy_forces_virial."""
    t, j, nbj = _fast(synthetic_anna_potential(3, gparams=gp, **REDUCED),
                      pbc=pbc)
    np.testing.assert_array_equal(t.short.idx.numpy(), _np(j.short.idx))
    assert not bool(t.short.overflow) and not bool(j.short.overflow)
    e, f, w = t.fns[0](t.x, t.box, t.nb, t.short)
    je, jf, jw = j.fns[0](j.x, j.box, nbj, j.short)
    np.testing.assert_allclose(float(e), float(je), rtol=E_RTOL)
    np.testing.assert_allclose(f.numpy(), _np(jf), rtol=F_RTOL, atol=F_ATOL)
    np.testing.assert_allclose(w.numpy(), _np(jw), rtol=W_RTOL, atol=W_ATOL)
    el, fl, wl = t.fns[1](t.x, t.box, t.nb, t.short)
    np.testing.assert_allclose(fl.numpy(), f.numpy(), rtol=1e-12,
                               atol=1e-14)
    assert float(el) == float(e) and not bool(wl.any())
    re, rf, rw = A.energy_forces_virial(t.cfg, t.p, t.x, t.box, t.idx,
                                        shift=False)
    np.testing.assert_allclose(float(e), float(re), rtol=E_RTOL)
    np.testing.assert_allclose(f.numpy(), rf.numpy(), rtol=F_RTOL,
                               atol=F_ATOL)
    np.testing.assert_allclose(w.numpy(), rw.numpy(), rtol=W_RTOL,
                               atol=W_ATOL)


def test_fast_fns_poison_on_short_overflow():
    """k_short below the rows' partner count: both packages flag the
    overflow and NaN-poison E and F. k_short past kernels.MAX_K is no
    error (g_harm takes such rows in tiles): its rows are the fitting
    ones padded, and its E and F theirs."""
    pot = synthetic_anna_potential(0, **REDUCED)
    t, j, nbj = _fast(pot, k_short=40)
    assert bool(t.short.overflow) and bool(j.short.overflow)
    for fn, jfn in zip(t.fns[:2], j.fns[:2]):
        e, f, _ = fn(t.x, t.box, t.nb, t.short)
        je, jf, _ = jfn(j.x, j.box, nbj, j.short)
        assert np.isnan(float(e)) and np.isnan(float(je))
        assert bool(torch.isnan(f).all()) and bool(jnp.isnan(jf).all())
    fits = {ks: A.make_anna_fast_fns(t.cfg, t.p, k_short=ks, delta=0.3)
            for ks in (64, kernels.MAX_K + 1)}
    out = {}
    for ks, fns in fits.items():
        short = fns[2](t.x, t.box, t.nb)
        assert short.idx.shape[1] == ks and not bool(short.overflow)
        out[ks] = fns[1](t.x, t.box, t.nb, short)
    np.testing.assert_allclose(float(out[64][0]),
                               float(out[kernels.MAX_K + 1][0]), rtol=1e-13)
    assert np.max(np.abs(out[64][1].numpy()
                         - out[kernels.MAX_K + 1][1].numpy())) <= 1e-12


def test_fast_path_vs_oracle():
    """The fast path at full width against tests/oracle_numpy's
    transcription of the reference (newton-on loop with i-centered fields,
    its d_rho quirk included): max |dF| < 1e-6 eV/A, the JAX package's
    headline bar."""
    pot = synthetic_anna_potential(0)
    x, box = perturbed_bcc(3, seed=7, disp=0.08)
    e_ref, f_ref, eat_ref, lp_ref = oracle_numpy.anna_adp_energy_forces(
        pot, x, box)
    cfg, params = A.make_anna(pot, torch.float64, "cpu")
    nb = build_neighbors_n2(t64(x), t64(box), cfg.cut + 0.3, 96)
    force_fn, _, short_build = A.make_anna_fast_fns(cfg, params, k_short=72)
    short = short_build(t64(x), t64(box), nb)
    e, f, _ = force_fn(t64(x), t64(box), nb, short)
    assert np.max(np.abs(f.numpy() - f_ref)) < 1e-6
    np.testing.assert_allclose(float(e) + len(x) * cfg.e_base, e_ref,
                               rtol=1e-10)
    lp = A.local_params(cfg, params, t64(x), t64(box), nb.idx)
    np.testing.assert_allclose(lp.numpy(), lp_ref, rtol=1e-10)
