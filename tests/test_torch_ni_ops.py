"""The port's fused BP evaluator (`FusedNi`) against the JAX package:
`PallasNi` (Pallas interpret mode), the JAX autodiff model and its strain
virial, and the numpy oracle (tests/oracle_numpy.py, the reference's loops).

Tolerances (f64): both evaluators run the same formulas, but the port
delivers partner forces with one `index_add_` where the JAX package sorts,
and torch and XLA sum lanes in different orders, so results agree to
rounding: energy rtol 1e-10, forces atol 1e-9 eV/A, virial 1e-9 of its
largest entry. The oracle sums in yet another order and converts units
separately (Hartree, CFFORCE): the JAX package holds its own evaluator to it
at energy rtol 1e-10 and forces 1e-6 eV/A (tests/test_pallas_ni.py), and so
does this file.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle_numpy
from meng_zhang_tpu.models import annp as jannp
from meng_zhang_tpu.ops.pallas_ni import PallasNi
from meng_zhang_tpu.system.neighbors import build_neighbors_n2 as jax_n2
from meng_zhang_tpu_torch.models import annp
from meng_zhang_tpu_torch.ops import fused_ni as fn
from meng_zhang_tpu_torch.system.neighbors import build_neighbors_n2
from meng_zhang_tpu_torch.testing import synthetic_ni_potential, thermal_fcc
from torch_port_util import reduced_ni_potential, t64

E_RTOL, F_ATOL, W_RTOL = 1e-10, 1e-9, 1e-9
KS, DELTA = 16, 0.3


def _close_w(got, want):
    want = np.asarray(want)
    assert np.max(np.abs(np.asarray(got) - want)) <= \
        W_RTOL * np.max(np.abs(want))


@pytest.fixture(scope="module")
def case():
    """Reduced-width 107-atom fcc box with a vacancy and the JAX package's
    results, computed once: the rev-free short path, the full skin-list
    path, the autodiff model and its strain virial."""
    pot = reduced_ni_potential()
    x, box = thermal_fcc(3, seed=7, disp=0.1)
    x = x[1:]
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64)
    xj, bj = jnp.asarray(x), jnp.asarray(box)
    pk = PallasNi(jcfg, jparams, k_short=KS, short_delta=DELTA)
    jn = jax_n2(xj, bj, pk.rc + 0.5, 32, with_rev=True)
    assert not bool(jn.overflow)
    jsl = pk.compact_short(xj, bj, jn.idx, None)
    short = pk.energy_forces_short(xj, bj, jsl, want_virial=True,
                                   shift=False)
    full = pk.energy_forces(xj, bj, jn.idx, jn.rev, want_virial=True,
                            shift=False)
    strain = jannp.energy_forces_virial(jcfg, jparams, xj, bj, jn.idx)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    return dict(pot=pot, x=x, box=box, pk=pk, jcfg=jcfg, jparams=jparams,
                idx=torch.as_tensor(np.array(jn.idx)).long(), short=short,
                full=full, strain=strain, cfg=cfg, params=params)


def _ev(case, **kw):
    return fn.FusedNi(case["cfg"], case["params"], k_short=KS,
                      short_delta=DELTA, **kw)


def test_short_rc_matches_pallas(case):
    ev = _ev(case)
    assert ev.short_rc == case["pk"].short_rc
    assert ev.table == fn.NiTable(*(v for _, v in case["pk"].cfgn_key))


def test_energy_forces_short_matches_pallas(case):
    x, box = t64(case["x"]), t64(case["box"])
    ev = _ev(case)
    sl = ev.compact_short(x, box, case["idx"])
    assert not bool(sl.overflow)
    e, f, w = ev.energy_forces_short(x, box, sl)
    je, jf, jw = case["short"]
    np.testing.assert_allclose(float(e), float(je), rtol=E_RTOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0,
                               atol=F_ATOL)
    _close_w(w, jw)
    # the light step: the same E and F, no virial
    out = ev.energy_forces_short(x, box, sl, want_virial=False)
    assert len(out) == 2
    assert torch.equal(out[0], e) and torch.equal(out[1], f)
    # plain=True runs the same plain versions on the CPU
    e2, f2, _ = _ev(case, plain=True).energy_forces_short(x, box, sl)
    assert torch.equal(e2, e) and torch.equal(f2, f)


def test_energy_forces_matches_pallas_and_autodiff(case):
    x, box = t64(case["x"]), t64(case["box"])
    ev = _ev(case)
    e, f, w = ev.energy_forces(x, box, case["idx"], shift=True)
    je, jf, jw = case["full"]
    np.testing.assert_allclose(float(e), float(je), rtol=E_RTOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0,
                               atol=F_ATOL)
    _close_w(w, jw)
    # the hand VJP against the JAX autodiff model and its strain virial
    se, sf, sw = case["strain"]
    np.testing.assert_allclose(float(e), float(se), rtol=E_RTOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(sf), rtol=0,
                               atol=F_ATOL)
    _close_w(w, sw)
    # the port's autograd model agrees too
    ae, af = annp.energy_forces(case["cfg"], case["params"], x, box,
                                case["idx"])
    np.testing.assert_allclose(float(ae), float(e), rtol=E_RTOL)
    np.testing.assert_allclose(af.numpy(), f.numpy(), rtol=0, atol=F_ATOL)
    # momentum: index_add_ delivery puts each Fj on both ends of its pair
    assert float(f.sum(0).abs().max()) < 1e-11


def test_matches_numpy_oracle(case):
    """Against the reference's loops; the oracle's neighbor search runs to
    pot.cut, cut here to the descriptor cutoff + 0.3 A (the 6.5 A header
    cutoff exceeds half this box, and nothing beyond 2.91 A contributes)."""
    pot = dataclasses.replace(case["pot"], cut=_ev(case).rc + 0.3)
    x, box = case["x"], case["box"]
    e_ha, f_ref, _ = oracle_numpy.annp_ni_energy_forces(pot, x, box)
    e, f, _ = _ev(case).energy_forces(t64(x), t64(box), case["idx"])
    np.testing.assert_allclose(float(e), e_ha * annp.NI_HARTREE_EV,
                               rtol=E_RTOL)
    assert np.max(np.abs(f.numpy() - f_ref)) < 1e-6


def test_overflow_poisons(case):
    """A short row with more partners than Ks NaN-poisons E and F (the
    virial is left to the NaN forces' next step, as in the JAX package)."""
    x, box = t64(case["x"]), t64(case["box"])
    ev = fn.FusedNi(case["cfg"], case["params"], k_short=8,
                    short_delta=DELTA)
    sl = ev.compact_short(x, box, case["idx"])
    assert bool(sl.overflow)
    e, f, _ = ev.energy_forces_short(x, box, sl)
    assert torch.isnan(e) and torch.isnan(f).all()


def test_shortlist_epoch_drift(case):
    """A ShortList built at x stays exact for drift < short_delta/2: pairs
    outside rc + delta cannot have entered rc, and kept entries beyond rc
    evaluate to zero through the fc masks (test_ni_shortlist_epoch_drift)."""
    x, box = t64(case["x"]), t64(case["box"])
    ev = _ev(case)
    sl = ev.compact_short(x, box, case["idx"])
    rng = np.random.default_rng(7)
    dx = rng.uniform(-1, 1, size=x.shape)
    dx *= 0.4 * DELTA / 2 / np.abs(dx).max()
    x2 = x + t64(dx)
    e_sl, f_sl, _ = ev.energy_forces_short(x2, box, sl)
    nbrs2 = build_neighbors_n2(x2, box, ev.rc + 0.5, 32)
    e_ref, f_ref, _ = ev.energy_forces(x2, box, nbrs2.idx)
    np.testing.assert_allclose(float(e_sl), float(e_ref), rtol=1e-12)
    np.testing.assert_allclose(f_sl.numpy(), f_ref.numpy(), rtol=1e-9,
                               atol=1e-10)


def test_full_width_matches_autograd():
    """The shipped width (27 functions, Ks 32) on a 108-atom thermal fcc
    box: the hand-VJP evaluator against the port's autograd model, which
    tests/test_torch_ni_model.py holds to the JAX model."""
    pot = synthetic_ni_potential(0)
    x, box = thermal_fcc(3, seed=8, disp=0.1)
    x, box = t64(x), t64(box)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    ev = fn.FusedNi(cfg, params, k_short=32, short_delta=0.2)
    nbrs = build_neighbors_n2(x, box, ev.rc + 0.5, 64)
    sl = ev.compact_short(x, box, nbrs.idx)
    assert not bool(sl.overflow)
    e, f, w = ev.energy_forces_short(x, box, sl)
    ae, af = annp.energy_forces(cfg, params, x, box, sl.sidx)
    np.testing.assert_allclose(float(e), float(ae), rtol=E_RTOL)
    np.testing.assert_allclose(f.numpy(), af.numpy(), rtol=0, atol=F_ATOL)
    assert float(f.abs().max()) > 1e-2          # a thermal box has forces
    assert float(f.sum(0).abs().max()) < 1e-11
    assert torch.isfinite(w).all()


def test_tf32_off_on_cuda_only(case):
    """Built for the CPU the evaluator leaves the process-wide TF32 flags
    alone (it turns them off only for a CUDA device)."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    _ev(case)
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before


def test_unsupported_shapes_refused(case):
    """One hidden layer, or more descriptors than the kernels' 32 columns,
    are refused when the evaluator is built."""
    p = case["params"]
    with pytest.raises(NotImplementedError):
        fn.FusedNi(case["cfg"], dict(p, w=p["w"][:2], b=p["b"][:2]))
    wide = synthetic_ni_potential(0, npsf=2, nnod=6,
                                  ang=((0.01, 1.0, 1.0),) * 31)
    with pytest.raises(ValueError):
        fn.FusedNi(*annp.make_annp(wide, torch.float64, device="cpu"))
