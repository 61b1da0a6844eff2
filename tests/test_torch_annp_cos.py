"""The port's cos-matrix fe path against the JAX package: the plain versions
of `_g_kernel` / `_force_kernel` (Pallas interpret mode), the evaluator with
angular="matrix" against `PallasAnnp(angular="matrix")`, `energy_dedg`, and
the port's matrix path against its harmonic path.

Tolerances (f64), as in tests/test_torch_annp_ops.py and
tests/test_torch_annp_model.py: the kernels' plain versions run the Pallas
kernels' recurrences, summed in another order, so each output agrees to
max |diff| <= 1e-12 of max |value|; the evaluators agree to energy rtol
1e-10, forces atol 1e-9 eV/A and virial rtol 1e-9 (delivery by
`index_add_` against a sort). The matrix and harmonic paths compute the
same G_n through different algebra; in f64 they agree to E rel 1e-11 and
max |dF| 1e-9 eV/A.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu.models import annp as jannp
from meng_zhang_tpu.ops import pallas_annp as jpa
from meng_zhang_tpu.system.neighbors import build_neighbors_n2 as jax_n2
from meng_zhang_tpu_torch.models import annp
from meng_zhang_tpu_torch.ops import fused_annp as fa
from meng_zhang_tpu_torch.ops import kernels
from meng_zhang_tpu_torch.system.neighbors import build_neighbors_n2
from torch_port_util import (full_potential, perturbed_bcc,
                             reduced_potential, rel_max, short_planes, t64)

RTOL = 1e-12
E_RTOL, F_ATOL, W_RTOL = 1e-10, 1e-9, 1e-9
CUT, KS, DELTA = 4.0, 48, 0.4


def _dedg(p, nsf, seed=1):
    """Random dE/dG [P, 128], zero beyond nsf (numpy)."""
    d = np.zeros((p, fa.NSF_PAD))
    d[:, :nsf] = np.random.default_rng(seed).normal(size=(p, nsf))
    return d


def _compare_kernels(planes, filler, npsf, ntsf, cut):
    key = (("npsf", npsf), ("ntsf", ntsf), ("rc", cut))
    dedg = _dedg(planes[0].shape[0], npsf + ntsf)
    jp = [jnp.asarray(a) for a in planes]
    tp = [t64(a) for a in planes]
    g_t = fa.g_cos_plain(*tp, npsf, ntsf, cut)
    assert torch.all(g_t[:, npsf + ntsf:] == 0)
    if ntsf > 1:
        # the JAX `_row_g` appends the T_1 column whatever ntsf is, so its
        # kernel refuses ntsf = 1 (a 129-column row); see the ntsf = 1 case
        assert rel_max(g_t, jpa._run_g(*jp, key)) <= RTOL
    f_j = jpa._run_force(*jp, jnp.asarray(dedg), key)
    f_t = fa.force_cos_plain(*tp, t64(dedg), npsf, ntsf, cut)
    for got, want in zip(f_t, f_j):
        assert rel_max(got, want) <= RTOL
    assert filler.any()
    for got in f_t:
        assert np.all(got.numpy()[filler] == 0.0)
    return g_t


@pytest.mark.parametrize("npsf,ntsf", [(4, 5), (4, 2), (2, 1)])
def test_plain_cos_kernels_match_pallas_reduced(npsf, ntsf):
    planes, filler = short_planes(3, CUT, 32)
    g = _compare_kernels(planes, filler, npsf, ntsf, CUT)
    if ntsf == 1:
        # G_0 alone: the first columns of the ntsf = 2 result, exactly
        g2 = fa.g_cos_plain(*(t64(a) for a in planes), npsf, 2, CUT)
        assert torch.equal(g[:, :npsf + 1], g2[:, :npsf + 1])


def test_plain_cos_kernels_match_pallas_full_width():
    """The shipped fe width (npsf 9, ntsf 19, K 128) on 16 rows: the
    interpreter's cost."""
    p, filler = short_planes(5, 6.5, 128, seed=3)
    _compare_kernels([a[:16] for a in p], filler[:16], 9, 19, 6.5)


def test_cos_wrappers_take_plain_on_cpu():
    planes = [t64(a) for a in short_planes(3, CUT, 32)[0]]
    dedg = t64(_dedg(planes[0].shape[0], 9))
    before = (kernels.g_cos.launches, kernels.force_cos.launches)
    assert torch.equal(kernels.g_cos(*planes, 4, 5, CUT),
                       fa.g_cos_plain(*planes, 4, 5, CUT))
    f = kernels.force_cos(*planes, dedg, 4, 5, CUT)
    f0 = fa.force_cos_plain(*planes, dedg, 4, 5, CUT)
    assert all(torch.equal(u, v) for u, v in zip(f, f0))
    assert (kernels.g_cos.launches, kernels.force_cos.launches) == before
    meta = [t.to("meta") for t in planes]
    with pytest.raises(ValueError):
        kernels.g_cos(*meta, 4, 5, CUT)
    with pytest.raises(ValueError):
        kernels.force_cos(*meta, dedg.to("meta"), 4, 5, CUT)


@pytest.fixture(scope="module", params=[(True, True, True),
                                        (False, True, False)],
                ids=["ppp", "mpm"])
def case(request):
    """Reduced-width scene with the JAX package's cos-matrix results,
    computed once: the short path, the full skin-list path and
    energy_dedg."""
    pbc = request.param
    pot = reduced_potential(cut=CUT)
    x, box = perturbed_bcc((4, 5, 4), seed=7, disp=0.1)
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64, pbc=pbc)
    xj, bj = jnp.asarray(x), jnp.asarray(box)
    jn = jax_n2(xj, bj, CUT + 0.8, 64, with_rev=True, pbc=pbc)
    pk = jpa.PallasAnnp(jcfg, jparams, k_short=KS, short_delta=DELTA,
                        angular="matrix")
    jsl = pk.compact_short(xj, bj, jn.idx, None)
    short = pk.energy_forces_short(xj, bj, jsl, want_virial=True,
                                   shift=False)
    full = pk.energy_forces(xj, bj, jn.idx, jn.rev, want_virial=True,
                            shift=False)
    dedg = pk.energy_dedg(xj, bj, jn.idx)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu", pbc=pbc)
    return dict(x=t64(x), box=t64(box), cfg=cfg, params=params,
                idx=torch.as_tensor(np.array(jn.idx)).long(), short=short,
                full=full, dedg=dedg)


def _check(got, want):
    e, f, w = got
    je, jf, jw = want
    np.testing.assert_allclose(float(e), float(je), rtol=E_RTOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0,
                               atol=F_ATOL)
    jw = np.asarray(jw)
    assert np.max(np.abs(w.numpy() - jw)) <= W_RTOL * np.max(np.abs(jw))


def test_matrix_evaluator_matches_pallas(case):
    ev = fa.FusedAnnp(case["cfg"], case["params"], k_short=KS,
                      short_delta=DELTA, angular="matrix")
    assert not hasattr(ev, "cmat")          # no harmonic tables
    x, box = case["x"], case["box"]
    sl = ev.compact_short(x, box, case["idx"])
    _check(ev.energy_forces_short(x, box, sl), case["short"])
    _check(ev.energy_forces(x, box, case["idx"]), case["full"])


def test_energy_dedg_matches_pallas(case):
    """Skin-list width (64), whatever `angular` is; the port's eat is
    shift-free, JAX's carries e_shift."""
    for angular in ("matrix", "harmonic"):
        ev = fa.FusedAnnp(case["cfg"], case["params"], k_short=KS,
                          angular=angular)
        eat, dedg = ev.energy_dedg(case["x"], case["box"], case["idx"])
        jeat, jdedg = case["dedg"]
        np.testing.assert_allclose(eat.numpy() + case["cfg"].e_shift,
                                   np.asarray(jeat), rtol=E_RTOL)
        assert dedg.shape == (len(case["x"]), fa.NSF_PAD)
        assert rel_max(dedg, jdedg) <= E_RTOL
        assert torch.all(dedg[:, case["cfg"].nsf:] == 0)


def test_matrix_matches_harmonic_full_width():
    """The two angular formulations at the shipped fe width on a 250-atom
    periodic box, and energy_dedg's eat against the autograd model."""
    x, box = (t64(a) for a in perturbed_bcc(5, seed=13, disp=0.08))
    cfg, params = annp.make_annp(full_potential(), torch.float64,
                                 device="cpu")
    nbrs = build_neighbors_n2(x, box, cfg.cut, 128)
    out = {}
    for angular in ("matrix", "harmonic"):
        ev = fa.FusedAnnp(cfg, params, k_short=128, angular=angular)
        out[angular] = ev.energy_forces(x, box, nbrs.idx)
    (e_m, f_m, w_m), (e_h, f_h, w_h) = out["matrix"], out["harmonic"]
    assert abs(float(e_m) - float(e_h)) <= 1e-11 * abs(float(e_h))
    assert float((f_m - f_h).abs().max()) <= 1e-9
    assert float((w_m - w_h).abs().max()) <= W_RTOL * float(w_h.abs().max())
    eat, _ = ev.energy_dedg(x, box, nbrs.idx)
    want = annp.atom_energies(cfg, params, x, box, nbrs.idx) - cfg.e_shift
    assert float((eat - want).abs().max()) <= \
        E_RTOL * float(want.abs().max())
