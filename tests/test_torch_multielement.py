"""Multi-element potentials: the port's per-row network select against the
JAX package's, on the same seeded numpy inputs, in f64.

  * `FusedAnnp(elems=...)` on both angular paths against
    `PallasAnnp(elems=...)` (Pallas interpret mode), the full skin-list
    path, the short path (elems per call) and `energy_dedg`;
  * the chunked functions with `elems`, Chebyshev and BP, against the JAX
    chunked functions, and `make_short_chunked_fns(elems=...)`;
  * `energy_forces_virial(elems)` against the JAX function;
  * `FusedAnnp(elems=...)` and `FusedNi(elems=...)` (no Pallas
    counterpart: `PallasNi` is single-element) against the JAX autodiff
    model with elems;
  * the shipped fe width once, against the JAX autodiff model.

Potentials: `testing.with_elements` (element 2 is element 1 with weights
x (1 + 0.02 N(0, 1)) and biases + 0.01 N(0, 1)) on the reduced-width
synthetic fe and ni potentials; atom types drawn 50/50 from a seed.

Tolerances: the JAX package's own multi-element test
(tests/test_pallas_annp.py: E rtol 1e-11, F rtol 1e-8 and atol 1e-10) for
the fused evaluators against Pallas; the chunked and autodiff functions
sum in other orders (tests/test_torch_chunked.py): E rtol 1e-10, F atol
1e-9 eV/A; the virial within 1e-9 of max |W|. Every comparison has an
elems-blind control (every atom through the first network) that must fail
the same force tolerance, so a select that does nothing cannot pass.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu.io.potential import read_ann as j_read_ann
from meng_zhang_tpu.models import annp as jannp
from meng_zhang_tpu.ops.pallas_annp import PallasAnnp
from meng_zhang_tpu.system.neighbors import build_neighbors_n2 as jax_n2
from meng_zhang_tpu_torch.io.potential import read_ann, write_ann
from meng_zhang_tpu_torch.models import annp
from meng_zhang_tpu_torch.ops import fused_annp as fa
from meng_zhang_tpu_torch.ops import fused_ni as fn
from meng_zhang_tpu_torch.system.neighbors import NeighborList
from meng_zhang_tpu_torch.testing import (synthetic_fe_potential_multi,
                                          synthetic_ni_potential_multi,
                                          thermal_fcc, with_elements)
from torch_port_util import (perturbed_bcc, reduced_ni_potential,
                             reduced_potential, rel_max, t64)

E_RTOL, F_RTOL, F_ATOL = 1e-11, 1e-8, 1e-10          # fused vs Pallas
CE_RTOL, CF_ATOL, W_RTOL = 1e-10, 1e-9, 1e-9         # chunked, autodiff
CUT, KS, DELTA = 4.0, 48, 0.4


def _types(n, seed=0):
    return np.random.default_rng(seed).integers(0, 2, n)


def _close_w(got, want):
    want = np.asarray(want)
    assert np.max(np.abs(np.asarray(got) - want)) <= \
        W_RTOL * np.max(np.abs(want))


def _fused_close(got, want):
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=E_RTOL)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=F_RTOL, atol=F_ATOL)
    if len(want) > 2:
        _close_w(got[2], want[2])


def _blind_fails(f_blind, f_want, atol=F_ATOL, rtol=F_RTOL):
    assert not np.allclose(np.asarray(f_blind), np.asarray(f_want),
                           rtol=rtol, atol=atol)


@pytest.fixture(scope="module", params=["harmonic", "matrix"])
def fe_case(request):
    """Reduced-width two-element scene with PallasAnnp(elems)'s results,
    computed once per angular path."""
    angular = request.param
    pot = with_elements(reduced_potential(cut=CUT), 2)
    x, box = perturbed_bcc((4, 5, 4), seed=7, disp=0.1)
    el = _types(len(x))
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64)
    xj, bj = jnp.asarray(x), jnp.asarray(box)
    jn = jax_n2(xj, bj, CUT + 0.8, 64, with_rev=True)
    pk = PallasAnnp(jcfg, jparams, k_short=KS, short_delta=DELTA,
                    angular=angular, elems=jnp.asarray(el, jnp.int32))
    assert pk.ne == 2
    full = pk.energy_forces(xj, bj, jn.idx, jn.rev, want_virial=True,
                            shift=False)
    short = pk.energy_forces_short(xj, bj, pk.compact_short(xj, bj, jn.idx,
                                                            None),
                                   want_virial=True, shift=False)
    dedg = pk.energy_dedg(xj, bj, jn.idx)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    return dict(angular=angular, x=t64(x), box=t64(box), el=el,
                cfg=cfg, params=params, full=full, short=short, dedg=dedg,
                idx=torch.as_tensor(np.array(jn.idx)).long())


def _fused(case, **kw):
    return fa.FusedAnnp(case["cfg"], case["params"], k_short=KS,
                        short_delta=DELTA, angular=case["angular"], **kw)


def test_fused_annp_matches_pallas(fe_case):
    c = fe_case
    el = torch.as_tensor(c["el"])
    ev = _fused(c, elems=el)
    _fused_close(ev.energy_forces(c["x"], c["box"], c["idx"]), c["full"])
    # the short path, with the elements given per call to an evaluator
    # built without them (the chunked functions' route)
    sl = ev.compact_short(c["x"], c["box"], c["idx"])
    _fused_close(_fused(c).energy_forces_short(c["x"], c["box"], sl,
                                               elems=el), c["short"])
    blind = _fused(c).energy_forces(c["x"], c["box"], c["idx"])
    _blind_fails(blind[1], c["full"][1])


def test_energy_dedg_matches_pallas(fe_case):
    """eat (shift-free here, with e_shift in JAX) and dE/dG by element."""
    c = fe_case
    eat, dedg = _fused(c, elems=torch.as_tensor(c["el"])).energy_dedg(
        c["x"], c["box"], c["idx"])
    jeat, jdedg = c["dedg"]
    np.testing.assert_allclose(eat.numpy() + c["cfg"].e_shift,
                               np.asarray(jeat), rtol=E_RTOL)
    assert rel_max(dedg, jdedg) <= E_RTOL
    blind = _fused(c).energy_dedg(c["x"], c["box"], c["idx"])[1]
    assert rel_max(blind, jdedg) > 1e3 * E_RTOL


def _scene(kind):
    if kind == "fe":
        x, box = perturbed_bcc((4, 5, 4), seed=4, disp=0.1)
        return x, box, with_elements(reduced_potential(cut=CUT), 2), 0.9
    x, box = thermal_fcc((3, 4, 3), seed=4, disp=0.1)
    return x[1:], box, with_elements(reduced_ni_potential(), 2), 0.9


@pytest.fixture(scope="module", params=["fe", "ni"])
def chunk_case(request):
    """The chunked and autodiff JAX functions with elems, computed once."""
    kind = request.param
    pbc = (True, False, True)
    x, box, pot, skin = _scene(kind)
    el = _types(len(x), seed=1)
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64, pbc=pbc)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu", pbc=pbc)
    rc = annp.descriptor_cutoff(cfg, params)
    xj, bj, elj = jnp.asarray(x), jnp.asarray(box), jnp.asarray(el,
                                                                jnp.int32)
    jn = jax_n2(xj, bj, rc + skin, 64, pbc=pbc)
    assert not bool(jn.overflow)
    want = {
        "e": jannp.energy_chunked(jcfg, jparams, xj, bj, jn.idx, elj,
                                  chunk=32),
        "ef": jannp.energy_forces_chunked(jcfg, jparams, xj, bj, jn.idx, elj,
                                          chunk=32),
        "efv": jannp.energy_forces_virial_chunked(jcfg, jparams, xj, bj,
                                                  jn.idx, elj, chunk=32),
        "strain": jannp.energy_forces_virial(jcfg, jparams, xj, bj, jn.idx,
                                             elj),
        "strain0": jannp.energy_forces_virial(jcfg, jparams, xj, bj,
                                              jn.idx)}
    return dict(kind=kind, x=t64(x), box=t64(box), el=torch.as_tensor(el),
                cfg=cfg, params=params, rc=rc, want=want,
                idx=torch.as_tensor(np.array(jn.idx)).long())


def _chunk_close(got, want):
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=CE_RTOL)
    if len(want) > 1:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=0, atol=CF_ATOL)
    if len(want) > 2:
        _close_w(got[2], want[2])


def test_chunked_functions_match_jax(chunk_case):
    c = chunk_case
    args = (c["cfg"], c["params"], c["x"], c["box"], c["idx"], c["el"])
    w = c["want"]
    _chunk_close((annp.energy_chunked(*args),), (w["e"],))
    _chunk_close(annp.energy_forces_chunked(*args), w["ef"])
    _chunk_close(annp.energy_forces_virial_chunked(*args), w["efv"])
    blind = annp.energy_forces_chunked(*args[:5])
    _blind_fails(blind[1], w["ef"][1], CF_ATOL, 0.0)


def test_short_chunked_fns_pass_elems(chunk_case):
    """make_short_chunked_fns(elems=...) hands the elements to every call:
    the same numbers as the JAX chunked function with elems."""
    c = chunk_case
    ks = 32 if c["kind"] == "fe" else 16
    force_fn, light, short_build = annp.make_short_chunked_fns(
        c["cfg"], c["params"], k_short=ks, delta=0.3, elems=c["el"])
    nbrs = NeighborList(c["idx"], torch.tensor(False), c["x"])
    short = short_build(c["x"], c["box"], nbrs)
    assert not bool(short.overflow)
    e, f, w = force_fn(c["x"], c["box"], nbrs, short)
    e0 = float(c["want"]["efv"][0]) - len(c["x"]) * c["cfg"].e_shift
    _chunk_close((e, f, w), (e0,) + tuple(c["want"]["efv"][1:]))
    el, fl, wl = light(c["x"], c["box"], nbrs, short)
    assert torch.equal(fl, f) and float(el) == float(e)
    assert torch.all(wl == 0)


def test_energy_forces_virial_matches_jax(chunk_case):
    """The autograd oracle with elems, and with none (every atom the first
    element, as the JAX function)."""
    c = chunk_case
    args = (c["cfg"], c["params"], c["x"], c["box"], c["idx"])
    _chunk_close(annp.energy_forces_virial(*args, c["el"]),
                 c["want"]["strain"])
    _chunk_close(annp.energy_forces_virial(*args), c["want"]["strain0"])
    _blind_fails(c["want"]["strain0"][1], c["want"]["strain"][1], CF_ATOL,
                 0.0)
    # the autograd oracle's energy and forces are energy_forces'
    e, f = annp.energy_forces(*args, c["el"])
    _chunk_close((e, f), c["want"]["strain"][:2])


def test_fused_evaluator_matches_jax_autodiff(chunk_case):
    """FusedAnnp(elems) and FusedNi(elems) on the skin list against the
    JAX autodiff model with elems (FusedNi's only JAX counterpart: the JAX
    package's PallasNi is single-element)."""
    c = chunk_case
    if c["kind"] == "fe":
        make, ks = fa.FusedAnnp, 64
    else:
        make, ks = fn.FusedNi, 16
    ev = make(c["cfg"], c["params"], k_short=ks, elems=c["el"])
    e, f, w = ev.energy_forces(c["x"], c["box"], c["idx"], shift=True)
    _chunk_close((e, f, w), c["want"]["strain"])
    blind = make(c["cfg"], c["params"], k_short=ks).energy_forces(
        c["x"], c["box"], c["idx"])
    _blind_fails(blind[1], c["want"]["strain"][1], CF_ATOL, 0.0)


def test_full_width_matches_jax_autodiff():
    """The shipped fe width (npsf 9, ntsf 19, nnod 10, rc 6.5) with two
    elements, harmonic path, on a 250-atom periodic box."""
    pot = synthetic_fe_potential_multi(2)
    x, box = perturbed_bcc(5, seed=13, disp=0.08)
    el = _types(len(x), seed=2)
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64)
    jn = jax_n2(jnp.asarray(x), jnp.asarray(box), pot.cut, 128)
    je, jf = jannp.energy_forces(jcfg, jparams, jnp.asarray(x),
                                 jnp.asarray(box), jn.idx,
                                 jnp.asarray(el, jnp.int32))
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    idx = torch.as_tensor(np.array(jn.idx)).long()
    ev = fa.FusedAnnp(cfg, params, k_short=128, elems=torch.as_tensor(el))
    e, f, _ = ev.energy_forces(t64(x), t64(box), idx, shift=True)
    np.testing.assert_allclose(float(e), float(je), rtol=CE_RTOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0,
                               atol=CF_ATOL)
    blind = fa.FusedAnnp(cfg, params, k_short=128).energy_forces(
        t64(x), t64(box), idx)
    _blind_fails(blind[1], jf, CF_ATOL, 0.0)


@pytest.mark.parametrize("make", [synthetic_fe_potential_multi,
                                  synthetic_ni_potential_multi],
                         ids=["fe", "ni"])
def test_two_element_ann_round_trips(make, tmp_path):
    """write_ann of a two-element potential reads back equal through both
    packages' read_ann; the second network is a perturbed copy of the
    first."""
    pot = make(2)
    path = str(tmp_path / "two.ann")
    write_ann(path, pot)
    for got in (read_ann(path), j_read_ann(path)):
        assert tuple(got.elements) == tuple(pot.elements)
        np.testing.assert_array_equal(got.masses, pot.masses)
        for gn, wn in zip(got.networks, pot.networks):
            for a, b in zip(gn.weights + gn.biases, wn.weights + wn.biases):
                np.testing.assert_array_equal(np.asarray(a), b)
    w0, w1 = (n.weights[0] for n in pot.networks)
    nz = w0 != 0.0
    assert np.all(w1[~nz] == 0.0)        # a relative perturbation
    assert 0.0 < np.median(np.abs(w1[nz] / w0[nz] - 1.0)) < 0.05
