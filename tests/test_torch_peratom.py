"""Per-atom tallies of the port's fused evaluators against the JAX package:
`FusedAnnp` on both angular paths and `FusedNi`, each with per_atom=True,
against `PallasAnnp` / `PallasNi` with per_atom=True (Pallas interpret
mode), at reduced width on an anisotropic, non-cubic, displaced box.

Tolerances (f64): eatom and vatom elementwise within 1e-10 of the largest
|value| of each (both packages evaluate the same per-pair terms; the JAX
package reads the partner's value from the reverse slot, the port adds it
through index_add_); sum(eatom) - n e_shift = E within 1e-13 of
sum |eatom| (eatom carries e_shift, so the difference cancels digits); the
diagonal of sum(vatom) = diag(W) within 1e-12 of max |W|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu.models import annp as jannp
from meng_zhang_tpu.ops.pallas_annp import PallasAnnp
from meng_zhang_tpu.ops.pallas_ni import PallasNi
from meng_zhang_tpu.system.neighbors import build_neighbors_n2 as jax_n2
from meng_zhang_tpu_torch.models import annp
from meng_zhang_tpu_torch.ops import fused_annp as fa
from meng_zhang_tpu_torch.ops import fused_ni as fn
from meng_zhang_tpu_torch.testing import thermal_fcc
from torch_port_util import (perturbed_bcc, reduced_ni_potential,
                             reduced_potential, t64)

PER_ATOM_RTOL = 1e-10
SUM_RTOL = 1e-12
EAT_SUM_RTOL = 1e-13
# anisotropic strain, so that xx, yy, zz and the off-diagonal columns all
# differ, and one open axis
STRAIN = np.array([1.03, 0.97, 1.01])
PBC = (True, True, False)


def _scene(path):
    if path == "ni":
        x, box = thermal_fcc((3, 4, 3), seed=5, disp=0.12)
        return x[1:] * STRAIN, box * STRAIN, reduced_ni_potential(), 16, 0.3
    x, box = perturbed_bcc((4, 5, 4), seed=11, disp=0.12)
    return x * STRAIN, box * STRAIN, reduced_potential(cut=4.0), 48, 0.4


def _models(path, pot, ks, delta):
    """(PallasAnnp or PallasNi, FusedAnnp or FusedNi) of one path."""
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64, pbc=PBC)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu", pbc=PBC)
    if path == "ni":
        return (PallasNi(jcfg, jparams, k_short=ks, short_delta=delta),
                fn.FusedNi(cfg, params, k_short=ks, short_delta=delta))
    return (PallasAnnp(jcfg, jparams, k_short=ks, short_delta=delta,
                       angular=path),
            fa.FusedAnnp(cfg, params, k_short=ks, short_delta=delta,
                         angular=path))


@pytest.fixture(scope="module", params=["harmonic", "matrix", "ni"])
def case(request):
    """The JAX package's per-atom results on one path, computed once."""
    path = request.param
    x, box, pot, ks, delta = _scene(path)
    pk, ev = _models(path, pot, ks, delta)
    xj, bj = jnp.asarray(x), jnp.asarray(box)
    jn = jax_n2(xj, bj, pk.short_rc + delta + 0.2, 64, pbc=PBC)
    assert not bool(jn.overflow)
    jsl = pk.compact_short(xj, bj, jn.idx, None)
    want = pk.energy_forces_short(xj, bj, jsl, want_virial=True,
                                  shift=False, per_atom=True)
    return dict(path=path, pot=pot, x=x, box=box, ev=ev, want=want,
                jidx=jn.idx, idx=torch.as_tensor(np.array(jn.idx)).long())


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= rtol * np.max(np.abs(want))


def test_per_atom_matches_pallas(case):
    ev, x, box = case["ev"], t64(case["x"]), t64(case["box"])
    sl = ev.compact_short(x, box, case["idx"])
    assert not bool(sl.overflow)
    e, f, w, eat, vat = ev.energy_forces_short(x, box, sl, per_atom=True)
    je, jf, jw, jeat, jvat = case["want"]
    n = x.shape[0]
    assert tuple(eat.shape) == (n,) and tuple(vat.shape) == (n, 6)
    _close(eat, jeat, PER_ATOM_RTOL)
    # each column on its own: xy, xz and yz are the unsymmetrised
    # dx_a Fj_b sums, which a swapped orientation would fail
    for col in range(6):
        _close(vat[:, col], np.asarray(jvat)[:, col], PER_ATOM_RTOL)
    # eatom includes e_shift, E does not
    assert abs(float(eat.sum()) - n * ev.cfg.e_shift - float(e)) <= \
        EAT_SUM_RTOL * float(eat.abs().sum())
    np.testing.assert_allclose(float(e), float(je), rtol=PER_ATOM_RTOL)
    assert float((vat[:, :3].sum(0) - torch.diagonal(w)).abs().max()) <= \
        SUM_RTOL * float(w.abs().max())
    # the other outputs are those of the evaluation without per_atom
    e0, f0, w0 = ev.energy_forces_short(x, box, sl)
    assert torch.equal(e0, e) and torch.equal(f0, f) and torch.equal(w0, w)
    # and without the virial: (E, F, eatom, vatom)
    out = ev.energy_forces_short(x, box, sl, want_virial=False,
                                 per_atom=True)
    assert len(out) == 4 and torch.equal(out[2], eat) \
        and torch.equal(out[3], vat)


def test_per_atom_off_diagonal_orientation(case):
    """vatom's xy column is sum dx_x Fj_y, not dx_y Fj_x: per atom the two
    orders differ on this box, and the JAX package's order is the one
    matched."""
    ev, x, box = case["ev"], t64(case["x"]), t64(case["box"])
    sl = ev.compact_short(x, box, case["idx"])
    vat = ev.energy_forces_short(x, box, sl, per_atom=True)[4]
    jvat = np.asarray(case["want"][4])
    swapped = fa.VATOM_ORDER[:3] + tuple((b, a) for a, b in
                                         fa.VATOM_ORDER[3:])
    orig = fa.VATOM_ORDER
    try:
        fa.VATOM_ORDER = swapped
        vat_sw = ev.energy_forces_short(x, box, sl, per_atom=True)[4]
    finally:
        fa.VATOM_ORDER = orig
    for col in (3, 4, 5):
        d = np.max(np.abs(vat_sw[:, col].numpy() - jvat[:, col]))
        assert d > 1e3 * PER_ATOM_RTOL * np.max(np.abs(jvat[:, col]))
    _close(vat, jvat, PER_ATOM_RTOL)


def test_per_atom_from_skin_list(case):
    """energy_forces(per_atom=True) compacts the skin list at the cutoff and
    tallies the same values."""
    ev, x, box = case["ev"], t64(case["x"]), t64(case["box"])
    _, _, _, eat, vat = ev.energy_forces(x, box, case["idx"], per_atom=True)
    _, _, _, jeat, jvat = case["want"]
    _close(eat, jeat, PER_ATOM_RTOL)
    _close(vat, jvat, PER_ATOM_RTOL)


def test_per_atom_overflow_poisons(case):
    """A short row wider than Ks NaN-poisons eatom and vatom, as in the JAX
    package."""
    pk, ev = _models(case["path"], case["pot"], 8, case["ev"].short_delta)
    x, box = t64(case["x"]), t64(case["box"])
    sl = ev.compact_short(x, box, case["idx"])
    assert bool(sl.overflow)
    e, f, eat, vat = ev.energy_forces_short(x, box, sl, want_virial=False,
                                            per_atom=True)
    assert torch.isnan(e) and torch.isnan(f).all()
    assert torch.isnan(eat).all() and torch.isnan(vat).all()
    xj, bj = jnp.asarray(case["x"]), jnp.asarray(case["box"])
    jsl = pk.compact_short(xj, bj, case["jidx"], None)
    _, _, jeat, jvat = pk.energy_forces_short(xj, bj, jsl, per_atom=True)
    assert np.isnan(np.asarray(jeat)).all()
    assert np.isnan(np.asarray(jvat)).all()
