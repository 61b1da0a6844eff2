"""The port's Behler-Parrinello (ni) descriptors and model against the JAX
package: `behler_g`, the BP branch of `make_annp` / `params_from_numpy` /
`atom_energies`, `effective_cutoff` and `descriptor_cutoff`, and the shape
of the synthetic ni potential.

Tolerances (f64): both packages evaluate the same formulas on the same
numpy inputs; torch and XLA sum the K x K angular terms in different
orders, so descriptors and energies agree to rounding, rtol 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu.io.potential import SYM_BEHLER, ActivationStyle
from meng_zhang_tpu.models import annp as jannp
from meng_zhang_tpu.models import descriptors as jdesc
from meng_zhang_tpu.system.neighbors import build_neighbors_n2 as jax_n2
from meng_zhang_tpu.units import CFFORCE, CFLENGTH
from meng_zhang_tpu_torch.models import annp
from meng_zhang_tpu_torch.models import descriptors
from meng_zhang_tpu_torch.testing import (NI_ETAS, RC_NI_BOHR,
                                          synthetic_ni_potential, thermal_fcc)
from torch_port_util import params_numpy, reduced_ni_potential, t64

RTOL = 1e-12


def _dx_batch(n_atoms, k, seed):
    """Neighbor displacements [A, K, 3] of random atoms: radii 1.8-4.2 A
    (inside and beyond the 3.90 A cutoff), some masked slots, and one
    antiparallel pair (cos = -1: 1 + lambda cos = 0 for lambda = +1)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n_atoms, k, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    dx = u * rng.uniform(1.8, 4.2, size=(n_atoms, k, 1))
    dx[0, 1] = -dx[0, 0] * 1.1
    mask = rng.uniform(size=(n_atoms, k)) > 0.2
    mask[0, :2] = True
    return dx, mask


@pytest.mark.parametrize("width", ["reduced", "full"])
def test_behler_g_matches_jax(width):
    pot = (reduced_ni_potential() if width == "reduced"
           else synthetic_ni_potential(0))
    dx, mask = _dx_batch(6, 20, seed=3)
    want = jax.vmap(jdesc.behler_g, in_axes=(0, 0, None, None))(
        jnp.asarray(dx), jnp.asarray(mask), jnp.asarray(pot.sym_coerad),
        jnp.asarray(pot.sym_coeang))
    got = descriptors.behler_g(t64(dx), torch.as_tensor(mask),
                               t64(pot.sym_coerad), t64(pot.sym_coeang))
    assert got.shape == (6, pot.nsf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))
    # a single atom (no leading axis), as the JAX function takes it
    one = descriptors.behler_g(t64(dx[2]), torch.as_tensor(mask[2]),
                               t64(pot.sym_coerad), t64(pot.sym_coeang))
    np.testing.assert_allclose(one.numpy(), got[2].numpy(), rtol=1e-15)


def test_behler_g_autograd_matches_jax_grad():
    """dG/ddx through torch autograd against jax.grad of the same sum."""
    pot = reduced_ni_potential()
    dx, mask = _dx_batch(1, 12, seed=5)
    dx, mask = dx[0] * 0.75, mask[0]            # most legs inside 2.91 A
    w = np.random.default_rng(6).normal(size=pot.nsf)

    def jsum(d):
        return jnp.dot(jdesc.behler_g(d, jnp.asarray(mask),
                                      jnp.asarray(pot.sym_coerad),
                                      jnp.asarray(pot.sym_coeang)),
                       jnp.asarray(w))

    want = jax.grad(jsum)(jnp.asarray(dx))
    d = t64(dx).requires_grad_(True)
    s = (descriptors.behler_g(d, torch.as_tensor(mask), t64(pot.sym_coerad),
                              t64(pot.sym_coeang)) * t64(w)).sum()
    (got,) = torch.autograd.grad(s, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-12 * float(np.abs(want).max()))


def test_make_annp_bp_matches_jax():
    pot = synthetic_ni_potential(1)
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    assert cfg.descriptor == jcfg.descriptor == SYM_BEHLER
    for field in ("npsf", "ntsf", "cut", "flagact", "act_style", "e_scale",
                  "e_shift", "pbc"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert cfg.e_scale == annp.NI_HARTREE_EV == jannp.NI_HARTREE_EV
    assert annp.NI_HARTREE_EV == pytest.approx(CFFORCE / CFLENGTH, rel=1e-15)
    assert set(params) == set(jparams)
    for key in ("sf_scale", "sf_shift", "coerad", "coeang"):
        np.testing.assert_array_equal(params[key].numpy(),
                                      np.asarray(jparams[key]))
    # params_from_numpy carries the coefficient tables through
    p2 = annp.params_from_numpy(params_numpy(jparams), device="cpu")
    for key in ("coerad", "coeang"):
        assert torch.equal(p2[key], params[key])
    for a, b in zip(p2["w"] + p2["b"], params["w"] + params["b"]):
        assert torch.equal(a, b)
    # f32 params for the card keep the tables in the working dtype
    _, p32 = annp.make_annp(pot, torch.float32, device="cpu")
    assert p32["coeang"].dtype == torch.float32


def test_cutoffs_match_jax():
    for pot in (synthetic_ni_potential(0), reduced_ni_potential()):
        rc = annp.effective_cutoff(pot)
        assert rc == jannp.effective_cutoff(pot)
        cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
        jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64)
        assert annp.descriptor_cutoff(cfg, params) == \
            jannp.descriptor_cutoff(jcfg, jparams) == rc
    assert annp.effective_cutoff(synthetic_ni_potential(0)) == \
        pytest.approx(RC_NI_BOHR / CFLENGTH)             # 3.90 A, not 6.5


def test_atom_energies_matches_jax():
    pot = reduced_ni_potential()
    x, box = thermal_fcc(3, seed=4, disp=0.1)
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64)
    jn = jax_n2(jnp.asarray(x), jnp.asarray(box), 3.2, 32)
    assert not bool(jn.overflow)
    want = jannp.atom_energies(jcfg, jparams, jnp.asarray(x),
                               jnp.asarray(box), jn.idx)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    idx = torch.as_tensor(np.array(jn.idx)).long()
    got = annp.atom_energies(cfg, params, t64(x), t64(box), idx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    je, jf = jannp.energy_forces(jcfg, jparams, jnp.asarray(x),
                                 jnp.asarray(box), jn.idx)
    e, f = annp.energy_forces(cfg, params, t64(x), t64(box), idx)
    np.testing.assert_allclose(float(e), float(je), rtol=RTOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0,
                               atol=1e-10)


def test_synthetic_ni_potential_shape():
    """The shipped ni shape, as tests/test_potential_io.py pins it on the
    real file, drawn deterministically from the seed."""
    p = synthetic_ni_potential(0)
    assert p.elements == ("Ni",)
    assert (p.ntl, p.nnod, p.nsf, p.npsf, p.ntsf) == (4, 24, 27, 3, 24)
    assert p.norm_style == "minmax"
    assert p.networks[0].act_style == ActivationStyle.NI
    np.testing.assert_allclose(p.sym_coerad[:, 0], NI_ETAS)
    np.testing.assert_allclose(p.sym_coerad[:, 2], 7.3699319)
    np.testing.assert_allclose(p.sym_coeang[-1], [0.05, 1.0, 16.0, 7.3699319])
    np.testing.assert_allclose(p.sf_scale, 1.0 / (p.norm_row1 - p.norm_row0))
    assert np.all(p.norm_row1 > p.norm_row0)
    q = synthetic_ni_potential(0)
    for a, b in zip(p.networks[0].weights, q.networks[0].weights):
        np.testing.assert_array_equal(a, b)
