"""The light (no-virial) evaluation of the port's fe evaluator: `FusedAnnp`
with want_virial=False against itself with the virial and against
`PallasAnnp(...)(want_virial=False)` (Pallas interpret mode), on the harmonic
and the cos-matrix path, and an fe NVT `Simulator` wired with
`force_fn_light`.

Tolerances (f64), as tests/test_torch_annp_model.py: energy rtol 1e-10,
forces atol 1e-9 eV/A against the JAX package (delivery by `index_add_`
against a sort); with and without the virial the port runs the same
operations on E and F, so those agree exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu.models import annp as jannp
from meng_zhang_tpu.ops.pallas_annp import PallasAnnp
from meng_zhang_tpu.system.neighbors import build_neighbors_n2 as jax_n2
from meng_zhang_tpu.units import MASS_FE
from meng_zhang_tpu_torch.md import simulation as S
from meng_zhang_tpu_torch.models import annp
from meng_zhang_tpu_torch.ops import fused_annp as fa
from torch_port_util import perturbed_bcc, reduced_potential, t64

E_RTOL, F_ATOL = 1e-10, 1e-9
CUT, KS, DELTA = 4.0, 48, 0.4


@pytest.fixture(scope="module", params=["harmonic", "matrix"])
def case(request):
    """Reduced-width scene with the JAX package's light results on one
    angular path: the short path and the full skin-list path."""
    angular = request.param
    pot = reduced_potential(cut=CUT)
    x, box = perturbed_bcc((4, 5, 4), seed=7, disp=0.1)
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64)
    xj, bj = jnp.asarray(x), jnp.asarray(box)
    jn = jax_n2(xj, bj, CUT + 0.8, 64, with_rev=True)
    pk = PallasAnnp(jcfg, jparams, k_short=KS, short_delta=DELTA,
                    angular=angular)
    jsl = pk.compact_short(xj, bj, jn.idx, None)
    short = pk.energy_forces_short(xj, bj, jsl, want_virial=False,
                                   shift=False)
    full = pk.energy_forces(xj, bj, jn.idx, jn.rev, want_virial=False,
                            shift=False)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    ev = fa.FusedAnnp(cfg, params, k_short=KS, short_delta=DELTA,
                      angular=angular)
    return dict(x=t64(x), box=t64(box), ev=ev, short=short, full=full,
                idx=torch.as_tensor(np.array(jn.idx)).long())


def _check_light(light, heavy, want):
    assert len(light) == 2 and len(heavy) == 3 and len(want) == 2
    (e, f), (e3, f3, w3), (je, jf) = light, heavy, want
    assert torch.equal(e, e3) and torch.equal(f, f3)
    assert tuple(w3.shape) == (3, 3) and float(w3.abs().max()) > 0.0
    np.testing.assert_allclose(float(e), float(je), rtol=E_RTOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0,
                               atol=F_ATOL)


def test_energy_forces_short_light_matches_pallas(case):
    ev, x, box = case["ev"], case["x"], case["box"]
    sl = ev.compact_short(x, box, case["idx"])
    _check_light(ev.energy_forces_short(x, box, sl, want_virial=False),
                 ev.energy_forces_short(x, box, sl), case["short"])
    # want_virial and shift are independent: the shift adds n * e_shift
    e1, _ = ev.energy_forces_short(x, box, sl, want_virial=False, shift=True)
    e0, _ = ev.energy_forces_short(x, box, sl, want_virial=False)
    assert float(e1) == pytest.approx(
        float(e0) + len(x) * ev.cfg.e_shift, rel=1e-14)


def test_energy_forces_light_matches_pallas(case):
    ev, x, box = case["ev"], case["x"], case["box"]
    _check_light(ev.energy_forces(x, box, case["idx"], want_virial=False),
                 ev.energy_forces(x, box, case["idx"]), case["full"])


def _fe_nvt(light):
    """An fe NVT Simulator on the harmonic evaluator that records which
    variant served each evaluation; `light` wires force_fn_light as the ni
    main path does."""
    pot = reduced_potential(cut=CUT)
    x, box = perturbed_bcc(4, seed=11, disp=0.05)
    n = len(x)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    ev = fa.FusedAnnp(cfg, params, k_short=KS, short_delta=DELTA)
    calls = []

    def force_fn(xx, bb, nb, sh):
        calls.append("full")
        return ev.energy_forces_short(xx, bb, sh)

    def force_fn_light(xx, bb, nb, sh):
        calls.append("light")
        return ev.energy_forces_short(xx, bb, sh, want_virial=False) \
            + (xx.new_zeros(3, 3),)

    mc = S.MDConfig(dt=0.001, cutoff=CUT, skin=0.8, capacity=64,
                    nbr_method="n2", ensemble="nvt", t_target=300.0,
                    tau_t=0.05, thermo_every=5, short_every=5,
                    short_skin=DELTA)
    sim = S.Simulator(
        force_fn, torch.full((n,), MASS_FE, dtype=torch.float64), mc,
        short_build=lambda xx, bb, nb: ev.compact_short(xx, bb, nb.idx),
        force_fn_light=force_fn_light if light else None)
    st = sim.init_state(t64(x), t64(box), seed=5, t_init=300.0)
    st, th = sim.run(st, 2)
    return st, th, calls


def test_fe_nvt_light_on_all_but_block_end():
    """An fe NVT run takes FusedAnnp's light variant on every step of a
    block but the last, and ends where the run without it ends: the light
    steps' forces are the full ones, and the block-end virial (which the
    thermo pressure reads) is the full one."""
    st, th, calls = _fe_nvt(light=True)
    assert calls == ["full"] + (["light"] * 4 + ["full"]) * 2
    st0, th0, calls0 = _fe_nvt(light=False)
    assert calls0 == ["full"] * 11
    assert torch.equal(st.x, st0.x) and torch.equal(st.f, st0.f)
    assert torch.equal(st.virial, st0.virial)
    assert float(st.virial.abs().max()) > 0.0
    assert torch.equal(th.press, th0.press)
    assert torch.isfinite(th.press).all() and int(st.step) == 10
