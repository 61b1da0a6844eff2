"""The port's Chebyshev ANNP model and fused evaluator against the JAX
package (Pallas in interpret mode, the autodiff model) and the numpy oracle.

Tolerances (f64): both packages run the same formulas, but the port delivers
partner forces with one `index_add_` where the JAX package sorts, and torch
and XLA sum lanes in different orders, so results agree to rounding:
energy rtol 1e-10, forces atol 1e-9 eV/A, virial rtol 1e-9.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle_numpy
from meng_zhang_tpu.models import annp as jannp
from meng_zhang_tpu.ops.pallas_annp import PallasAnnp
from meng_zhang_tpu.system.neighbors import build_neighbors_n2 as jax_n2
from meng_zhang_tpu_torch.models import annp
from meng_zhang_tpu_torch.ops import fused_annp as fa
from meng_zhang_tpu_torch.system.neighbors import build_neighbors_n2
from torch_port_util import (full_potential, params_numpy, perturbed_bcc,
                             reduced_potential, t64)

E_RTOL, F_ATOL, W_RTOL = 1e-10, 1e-9, 1e-9
CUT, KS, DELTA = 4.0, 48, 0.4
PBCS = [(True, True, True), (False, True, False)]


def _close_w(got, want):
    want = np.asarray(want)
    assert np.max(np.abs(np.asarray(got) - want)) <= \
        W_RTOL * np.max(np.abs(want))


@pytest.fixture(scope="module", params=PBCS, ids=["ppp", "mpm"])
def case(request):
    """Reduced-width scene with the JAX package's Pallas results, computed
    once: the rev-free short path and the full skin-list path."""
    pbc = request.param
    pot = reduced_potential(cut=CUT)
    x, box = perturbed_bcc((4, 5, 4), seed=7, disp=0.1)
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64, pbc=pbc)
    xj, bj = jnp.asarray(x), jnp.asarray(box)
    jn = jax_n2(xj, bj, CUT + 0.8, 64, with_rev=True, pbc=pbc)
    pk = PallasAnnp(jcfg, jparams, k_short=KS, short_delta=DELTA)
    jsl = pk.compact_short(xj, bj, jn.idx, None)
    short = pk.energy_forces_short(xj, bj, jsl, want_virial=True,
                                   shift=False)
    full = pk.energy_forces(xj, bj, jn.idx, jn.rev, want_virial=True,
                            shift=False)
    auto = jannp.energy_forces(jcfg, jparams, xj, bj, jn.idx)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu", pbc=pbc)
    return dict(pot=pot, x=x, box=box, pbc=pbc, jcfg=jcfg, jparams=jparams,
                idx=torch.as_tensor(np.array(jn.idx)).long(), short=short,
                full=full, auto=auto, cfg=cfg, params=params)


def test_params_from_numpy_round_trip(case):
    jparams = case["jparams"]
    p = annp.params_from_numpy(params_numpy(jparams), device="cpu")
    for key in ("w", "b"):
        for got, mine, want in zip(p[key], case["params"][key],
                                   jparams[key]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert torch.equal(got, mine)
    for key in ("sf_scale", "sf_shift"):
        np.testing.assert_array_equal(p[key].numpy(),
                                      np.asarray(jparams[key]))
    x, box, idx = t64(case["x"]), t64(case["box"]), case["idx"]
    got = annp.atom_energies(case["cfg"], p, x, box, idx)
    want = jannp.atom_energies(case["jcfg"], jparams, jnp.asarray(case["x"]),
                               jnp.asarray(case["box"]),
                               jnp.asarray(idx.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=E_RTOL)


def test_energy_forces_short_matches_pallas(case):
    x, box = t64(case["x"]), t64(case["box"])
    ev = fa.FusedAnnp(case["cfg"], case["params"], k_short=KS,
                      short_delta=DELTA)
    sl = ev.compact_short(x, box, case["idx"])
    e, f, w = ev.energy_forces_short(x, box, sl)
    je, jf, jw = case["short"]
    np.testing.assert_allclose(float(e), float(je), rtol=E_RTOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0,
                               atol=F_ATOL)
    _close_w(w, jw)
    # shift=True adds n * e_shift
    e1 = ev.energy_forces_short(x, box, sl, shift=True)[0]
    assert float(e1) == pytest.approx(
        float(e) + len(x) * case["cfg"].e_shift, rel=1e-14)


def test_energy_forces_matches_pallas_and_autodiff(case):
    x, box = t64(case["x"]), t64(case["box"])
    ev = fa.FusedAnnp(case["cfg"], case["params"], k_short=KS)
    e, f, w = ev.energy_forces(x, box, case["idx"])
    je, jf, jw = case["full"]
    np.testing.assert_allclose(float(e), float(je), rtol=E_RTOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0,
                               atol=F_ATOL)
    _close_w(w, jw)
    # the autograd model (shift included) against JAX's autodiff model
    ae, af = annp.energy_forces(case["cfg"], case["params"], x, box,
                                case["idx"])
    je2, jf2 = case["auto"]
    np.testing.assert_allclose(float(ae), float(je2), rtol=E_RTOL)
    np.testing.assert_allclose(af.numpy(), np.asarray(jf2), rtol=0,
                               atol=F_ATOL)
    np.testing.assert_allclose(float(ae), float(e) + len(x)
                               * case["cfg"].e_shift, rtol=E_RTOL)
    np.testing.assert_allclose(af.numpy(), f.numpy(), rtol=0, atol=F_ATOL)
    # momentum: index_add_ delivery puts each Fj on both ends of its pair
    assert float(f.sum(0).abs().max()) < 1e-11


def test_matches_numpy_oracle():
    """Fully periodic, against tests/oracle_numpy (the reference's loops)."""
    pot = reduced_potential(cut=CUT)
    x, box = perturbed_bcc(4, seed=11, disp=0.1)
    e_ref, f_ref, _ = oracle_numpy.annp_fe_energy_forces(pot, x, box)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    nbrs = build_neighbors_n2(t64(x), t64(box), CUT + 0.5, 64)
    ev = fa.FusedAnnp(cfg, params, k_short=KS)
    e, f, _ = ev.energy_forces(t64(x), t64(box), nbrs.idx, shift=True)
    np.testing.assert_allclose(float(e), e_ref, rtol=E_RTOL)
    np.testing.assert_allclose(f.numpy(), f_ref, rtol=0, atol=F_ATOL)


def test_finite_differences():
    """Forces against central differences of the energy, and the virial
    against the energy's response to a homogeneous strain."""
    pot = reduced_potential(cut=CUT)
    x, box = perturbed_bcc(4, seed=12, disp=0.1)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    ev = fa.FusedAnnp(cfg, params, k_short=KS)
    xt, bt = t64(x), t64(box)
    nbrs = build_neighbors_n2(xt, bt, CUT + 0.5, 64)
    _, f, w = ev.energy_forces(xt, bt, nbrs.idx)
    h = 1e-5

    def energy(xx, bb):
        return float(ev.energy_forces(xx, bb, nbrs.idx)[0])

    rng = np.random.default_rng(0)
    for i, a in zip(rng.choice(len(x), 6, replace=False),
                    rng.integers(0, 3, 6)):
        xp, xm = xt.clone(), xt.clone()
        xp[i, a] += h
        xm[i, a] -= h
        fd = -(energy(xp, bt) - energy(xm, bt)) / (2 * h)
        assert abs(fd - float(f[i, a])) < 1e-7
    for a in range(3):
        eps = torch.zeros(3, dtype=torch.float64)
        eps[a] = h
        ep = energy(xt * (1 + eps), bt * (1 + eps))
        em = energy(xt * (1 - eps), bt * (1 - eps))
        assert abs(-(ep - em) / (2 * h) - float(w[a, a])) < \
            1e-6 * float(w.abs().max())


def test_full_width_matches_jax_autodiff():
    """The shipped fe width (npsf 9, ntsf 19, nnod 10, rc 6.5) once, against
    the JAX autodiff model, on a 250-atom periodic box."""
    pot = full_potential()
    x, box = perturbed_bcc(5, seed=13, disp=0.08)
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64)
    jn = jax_n2(jnp.asarray(x), jnp.asarray(box), pot.cut, 128)
    je, jf = jannp.energy_forces(jcfg, jparams, jnp.asarray(x),
                                 jnp.asarray(box), jn.idx)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    ev = fa.FusedAnnp(cfg, params, k_short=128)
    e, f, _ = ev.energy_forces(t64(x), t64(box),
                               torch.as_tensor(np.array(jn.idx)).long(),
                               shift=True)
    np.testing.assert_allclose(float(e), float(je), rtol=E_RTOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0,
                               atol=F_ATOL)
