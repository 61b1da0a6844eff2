"""The ni main path through the port's `Simulator` against the JAX package:
NHC NVT with the refresh-static short list and the light (no-virial) force
variant, `FusedNi` against `PallasNi` (Pallas interpret mode), and the call
pattern of `force_fn_light`.

Tolerances: as tests/test_torch_md.py, the force evaluations agree to
rounding (summation order: `index_add_` against a sort), and 10 steps do not
amplify that beyond a few ulps: positions, velocities and forces atol 1e-9
(A, A/ps, eV/A), thermo rtol 1e-9.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu.md import simulation as JS
from meng_zhang_tpu.models.annp import make_annp as jax_make_annp
from meng_zhang_tpu.ops.pallas_ni import PallasNi
from meng_zhang_tpu.units import MASS_NI
from meng_zhang_tpu_torch.md import simulation as S
from meng_zhang_tpu_torch.models.annp import effective_cutoff, make_annp
from meng_zhang_tpu_torch.ops import fused_annp as fa
from meng_zhang_tpu_torch.ops import fused_ni as fn
from meng_zhang_tpu_torch.testing import thermal_fcc
from torch_port_util import reduced_ni_potential, t64

RTOL, ATOL = 1e-9, 1e-9
KS, DELTA = 16, 0.2


def _np(a):
    return np.asarray(a, dtype=np.float64)


def _configs(pot, ensemble="nvt"):
    common = dict(dt=0.001, cutoff=effective_cutoff(pot), skin=0.5,
                  capacity=32, nbr_method="n2", ensemble=ensemble,
                  t_target=1200.0, tau_t=0.1, thermo_every=5,
                  stale_factor=0.5, short_every=5, short_skin=DELTA)
    return JS.MDConfig(**common), S.MDConfig(**common)


def test_nvt_trajectory_matches_jax():
    """10 steps (two thermo blocks, two short-list refreshes, eight light
    steps) of both Simulators on the ni main path's wiring
    (scripts/model_bench.py --model ni), from the same numpy velocities.
    The output layer is scaled down 200x: at the reduced 2.91 A cutoff the
    default network is stiff (forces near 500 eV/A at 0.08 A displacements)
    and the box would heat far past the short list's skin in 10 steps."""
    pot = reduced_ni_potential(w_out=0.01)
    x, box = thermal_fcc(3, seed=3, disp=0.08)
    n = len(x)
    rng = np.random.default_rng(4)
    v = rng.normal(scale=3.0, size=(n, 3))
    v -= v.mean(0)
    jmc, mc = _configs(pot)

    jc, jp = jax_make_annp(pot, dtype=jnp.float64)
    pk = PallasNi(jc, jp, k_short=KS, short_delta=DELTA)
    jsim = JS.Simulator(
        lambda xx, bb, nb, sh: pk.energy_forces_short(
            xx, bb, sh, want_virial=True, shift=False),
        jnp.full(n, MASS_NI, jnp.float64), jmc,
        short_build=lambda xx, bb, nb: pk.compact_short(xx, bb, nb.idx, None),
        force_fn_light=lambda xx, bb, nb, sh: pk.energy_forces_short(
            xx, bb, sh, shift=False) + (jnp.zeros((3, 3), xx.dtype),))
    js = jsim.init_state(jnp.asarray(x), jnp.asarray(box), v=jnp.asarray(v))
    js, jth = jsim.run(js, 2)

    cfg, params = make_annp(pot, torch.float64, device="cpu")
    ev = fn.FusedNi(cfg, params, k_short=KS, short_delta=DELTA)
    sim = S.Simulator(
        lambda xx, bb, nb, sh: ev.energy_forces_short(xx, bb, sh),
        torch.full((n,), MASS_NI, dtype=torch.float64), mc,
        short_build=lambda xx, bb, nb: ev.compact_short(xx, bb, nb.idx),
        force_fn_light=lambda xx, bb, nb, sh: ev.energy_forces_short(
            xx, bb, sh, want_virial=False) + (xx.new_zeros(3, 3),))
    st = sim.init_state(t64(x), t64(box), v=t64(v))
    st, th = sim.run(st, 2)

    np.testing.assert_allclose(st.x.numpy(), _np(js.x), rtol=0, atol=ATOL)
    np.testing.assert_allclose(st.v.numpy(), _np(js.v), rtol=0, atol=ATOL)
    np.testing.assert_allclose(st.f.numpy(), _np(js.f), rtol=0, atol=ATOL)
    for name in S.Thermo._fields:
        np.testing.assert_allclose(getattr(th, name).numpy(),
                                   _np(getattr(jth, name)), rtol=RTOL,
                                   atol=1e-9, err_msg=name)
    # the block-end virial is the full one (the thermo pressure reads it)
    np.testing.assert_allclose(st.virial.numpy(), _np(js.virial), rtol=0,
                               atol=1e-9 * float(np.abs(_np(js.virial)).max()))
    assert float(st.virial.abs().max()) > 0.0
    assert int(st.step) == int(js.step) == 10
    for flag in ("overflow", "stale", "unsafe"):
        assert bool(getattr(st, flag)) == bool(getattr(js, flag))
    assert not bool(st.unsafe) and not bool(st.overflow)


def _counting_sim(ensemble, with_short):
    """A Simulator on a harmonic tether to the start positions (cheap)
    that records which force function served each evaluation; the full
    function returns a nonzero virial, the light one zeros."""
    x, box = thermal_fcc(3, seed=5, disp=0.05)
    x0 = t64(x)
    calls = []

    def tether(kind):
        def f(xx, bb, nb, sh=None):
            calls.append(kind)
            d = xx - x0
            w = torch.eye(3, dtype=xx.dtype) * float(kind == "full")
            return 0.5 * (d * d).sum(), -d, w
        return f

    mc = S.MDConfig(dt=0.001, cutoff=2.9, skin=0.5, capacity=32,
                    nbr_method="n2", ensemble=ensemble, t_target=300.0,
                    thermo_every=6, short_every=3 if with_short else 0,
                    short_skin=0.2 if with_short else 0.0)
    short = (lambda xx, bb, nb: fa.ShortList(nb.idx, xx, torch.zeros(
        (), dtype=torch.bool))) if with_short else None
    sim = S.Simulator(tether("full"), torch.full((len(x),), MASS_NI,
                                                 dtype=torch.float64), mc,
                      short_build=short, force_fn_light=tether("light"))
    return sim, x0, t64(box), calls


@pytest.mark.parametrize("with_short", [True, False])
def test_force_fn_light_on_all_but_block_end(with_short):
    """Outside NPT every step of a block but the last takes the light
    function; init_state and each block's last step take the full one."""
    sim, x, box, calls = _counting_sim("nvt", with_short)
    st = sim.init_state(x, box, seed=1)
    assert calls == ["full"]
    st, th = sim.run(st, 2)
    assert calls[1:] == (["light"] * 5 + ["full"]) * 2
    assert torch.isfinite(th.press).all()


def test_force_fn_light_unused_in_npt():
    """NPT's barostat reads the virial every step: no light steps."""
    sim, x, box, calls = _counting_sim("npt", True)
    st = sim.init_state(x, box, seed=1)
    sim.run(st, 1)
    assert calls == ["full"] * 7
