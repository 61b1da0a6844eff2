"""The port's minimizers (md/minimize.py) against the JAX package's: FIRE
and Polak-Ribiere CG with each package's autograd model on the same
128-atom displaced bcc box, and the outer neighbor-rebuild loops.

Both run the same iteration in f64, with the same host decisions, so they
take the same iterates: equal n_iter, n_evals and stopping reason, and
final positions within 1e-9 A (the models agree to ~1e-12 eV/A per force
and the relaxation contracts any difference).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu.md import minimize as jmin
from meng_zhang_tpu.models import annp as jannp
from meng_zhang_tpu.system.neighbors import build_neighbors_n2 as jax_n2
from meng_zhang_tpu_torch.md import minimize
from meng_zhang_tpu_torch.models import annp
from meng_zhang_tpu_torch.system.neighbors import build_neighbors_n2
from torch_port_util import perturbed_bcc, reduced_potential, t64

X_ATOL = 1e-9         # A
E_RTOL = 1e-10
CUT, SKIN, CAP = 4.0, 0.8, 64


@pytest.fixture(scope="module")
def system():
    pot = reduced_potential(cut=CUT)
    x, box = perturbed_bcc(4, seed=3, disp=0.12)
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")

    def jef(xx, bb, idx):
        return jannp.energy_forces(jcfg, jparams, xx, bb, idx)

    def ef(xx, bb, idx):
        return annp.energy_forces(cfg, params, xx, bb, idx)

    jn = jax_n2(jnp.asarray(x), jnp.asarray(box), CUT + SKIN, CAP)
    return dict(x=x, box=box, jef=jef, ef=ef, jidx=jn.idx,
                idx=torch.as_tensor(np.array(jn.idx)).long(), n=len(x),
                e_shift=cfg.e_shift)


def _close_x(got, want):
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= X_ATOL


@pytest.mark.parametrize("kw", [dict(f_tol=2e-2, max_iter=400),
                                dict(f_tol=1e-9, max_iter=100, block=20)],
                         ids=["converges", "max_iter"])
def test_fire_minimize_matches_jax(system, kw):
    s = system
    want = jmin.fire_minimize(s["jef"], jnp.asarray(s["x"]),
                              jnp.asarray(s["box"]), s["jidx"], **kw)
    got = minimize.fire_minimize(s["ef"], t64(s["x"]), t64(s["box"]),
                                 s["idx"], **kw)
    assert int(got.n_iter) == int(want.n_iter)
    assert (float(got.fmax) <= kw["f_tol"]) == \
        (float(want.fmax) <= kw["f_tol"])
    _close_x(got.x, want.x)
    np.testing.assert_allclose(float(got.pe), float(want.pe), rtol=E_RTOL)
    for name in ("dt", "alpha", "n_pos"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), rtol=1e-12)
    assert float(got.pe) < float(s["ef"](t64(s["x"]), t64(s["box"]),
                                         s["idx"])[0])


@pytest.mark.parametrize("kw", [dict(etol=0.0, ftol=1e-2, max_iter=30),
                                dict(etol=1e-6, ftol=1e-6, max_iter=50),
                                dict(etol=0.0, ftol=0.0, max_iter=4)],
                         ids=["ftol", "etol", "maxiter"])
def test_cg_minimize_matches_jax(system, kw):
    s = system
    want = jmin.cg_minimize(s["jef"], jnp.asarray(s["x"]),
                            jnp.asarray(s["box"]), s["jidx"], **kw)
    got = minimize.cg_minimize(s["ef"], t64(s["x"]), t64(s["box"]),
                               s["idx"], **kw)
    assert (got.n_iter, got.n_evals, got.converged) == \
        (want.n_iter, want.n_evals, want.converged)
    _close_x(got.x, want.x)
    np.testing.assert_allclose(float(got.pe), float(want.pe), rtol=E_RTOL)
    np.testing.assert_allclose(got.fnorm, want.fnorm, rtol=1e-8)


def test_cg_e_offset_matches_jax(system):
    """Shift-free energies with e_offset = n e_shift: the relative-change
    rule sees the shifted |E| and stops where the shifted run does."""
    s = system
    off = s["n"] * s["e_shift"]

    def shift_free(ef):
        def f(xx, bb, idx):
            e, g = ef(xx, bb, idx)
            return e - off, g
        return f

    kw = dict(etol=1e-7, ftol=0.0, max_iter=50, e_offset=off)
    want = jmin.cg_minimize(shift_free(s["jef"]), jnp.asarray(s["x"]),
                            jnp.asarray(s["box"]), s["jidx"], **kw)
    got = minimize.cg_minimize(shift_free(s["ef"]), t64(s["x"]),
                               t64(s["box"]), s["idx"], **kw)
    assert (got.n_iter, got.n_evals, got.converged) == \
        (want.n_iter, want.n_evals, want.converged) and \
        got.converged == "etol"
    _close_x(got.x, want.x)
    ref = minimize.cg_minimize(s["ef"], t64(s["x"]), t64(s["box"]),
                               s["idx"], etol=1e-7, ftol=0.0, max_iter=50)
    assert (ref.n_iter, ref.n_evals) == (got.n_iter, got.n_evals)


@pytest.mark.parametrize("which", ["fire", "cg"])
def test_relax_outer_loop_matches_jax(system, which):
    """fire_relax / cg_relax rebuild the list between inner runs."""
    s = system

    def jbuild(xx, bb):
        return jax_n2(xx, bb, CUT + SKIN, CAP)

    def build(xx, bb):
        return build_neighbors_n2(xx, bb, CUT + SKIN, CAP)

    if which == "fire":
        jx, jst = jmin.fire_relax(s["jef"], jbuild, jnp.asarray(s["x"]),
                                  jnp.asarray(s["box"]), f_tol=2e-2,
                                  max_outer=3, max_iter=100)
        x, st = minimize.fire_relax(s["ef"], build, t64(s["x"]),
                                    t64(s["box"]), f_tol=2e-2, max_outer=3,
                                    max_iter=100)
        assert int(st.n_iter) == int(jst.n_iter)
    else:
        jx, jst = jmin.cg_relax(s["jef"], jbuild, jnp.asarray(s["x"]),
                                jnp.asarray(s["box"]), etol=0.0, ftol=1e-2,
                                max_outer=3, max_iter=10)
        x, st = minimize.cg_relax(s["ef"], build, t64(s["x"]), t64(s["box"]),
                                  etol=0.0, ftol=1e-2, max_outer=3,
                                  max_iter=10)
        assert (st.n_iter, st.n_evals, st.converged) == \
            (jst.n_iter, jst.n_evals, jst.converged)
    _close_x(x, jx)


def test_fire_blocks_stay_on_device(system, monkeypatch):
    """Within a block FIRE reads nothing back: the host converts a tensor
    to a Python number only in the convergence check before each block
    and after the last (two reads a check)."""
    s = system
    reads = []
    real_float = torch.Tensor.__float__
    real_int = torch.Tensor.__int__

    def counting(real):
        def f(self):
            reads.append(1)
            return real(self)
        return f

    monkeypatch.setattr(torch.Tensor, "__float__", counting(real_float))
    monkeypatch.setattr(torch.Tensor, "__int__", counting(real_int))
    st = minimize.fire_minimize(s["ef"], t64(s["x"]), t64(s["box"]),
                                s["idx"], f_tol=1e-9, max_iter=60, block=20)
    monkeypatch.undo()
    assert int(st.n_iter) == 60
    assert len(reads) == 2 * (3 + 1)
