"""The ni kernels' plain versions: the port against the JAX package's Pallas
kernels (`_run_ni_g`, `_run_ni_force`, interpret mode) on the same
displacement planes, and the kernels' table against `_ni_cfg_key`.

The JAX launchers take transposed [Ks, P] blocks with P padded to the
128-atom block (padding lanes at 2e4, as `PallasNi._eval_fj` pads); the
port takes the [P, Ks] planes as they are. Both get the same numpy planes,
with the port's own filler lanes (dx = 2 box + 10) and, from a vacancy,
rows with fewer partners than the rest.

Tolerance (f64): the plain versions run the Pallas kernels' arithmetic in
the same order per lane, but torch and XLA sum the lanes in different
orders, so each output agrees to a few hundred ulps of its largest value:
max |diff| <= 1e-12 of max |value|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu.ops import pallas_ni as jpn
from meng_zhang_tpu.units import CFLENGTH
from meng_zhang_tpu_torch.ops import fused_ni as fn
from meng_zhang_tpu_torch.ops import kernels
from meng_zhang_tpu_torch.testing import synthetic_ni_potential
from torch_port_util import (ni_short_planes, reduced_ni_potential, rel_max,
                             t64)

RTOL = 1e-12


def _jax_blocks(planes):
    p = planes[0].shape[0]
    pad = -(-p // jpn.AT) * jpn.AT - p
    return [jnp.asarray(np.concatenate(
        [a, np.full((pad, a.shape[1]), 2.0e4)]).T) for a in planes]


def _dedg(p, nsf, seed=1):
    dedg = np.zeros((p, fn.NSF_SUB))
    dedg[:, :nsf] = np.random.default_rng(seed).normal(size=(p, nsf))
    return dedg


def _pallas(planes, dedg, pot):
    key = jpn._ni_cfg_key(pot.sym_coerad, pot.sym_coeang)
    jb = _jax_blocks(planes)
    p = planes[0].shape[0]
    g = np.asarray(jpn._run_ni_g(*jb, key)).T[:p]
    dpad = np.zeros((jb[0].shape[1] - p, fn.NSF_SUB))
    fj = jpn._run_ni_force(*jb, jnp.asarray(np.concatenate([dedg, dpad]).T),
                           key)
    return g, [np.asarray(f).T[:p] for f in fj]


def _compare(planes, filler, pot):
    table = fn.ni_table(pot.sym_coerad, pot.sym_coeang)
    dedg = _dedg(planes[0].shape[0], pot.nsf)
    g_j, f_j = _pallas(planes, dedg, pot)
    tp = [t64(a) for a in planes]
    g_t = fn.ni_g_plain(*tp, table)
    f_t = fn.ni_force_plain(*tp, t64(dedg), table)
    assert rel_max(g_t, g_j) <= RTOL
    assert np.all(g_t.numpy()[:, pot.nsf:] == 0.0)
    for got, want in zip(f_t, f_j):
        assert rel_max(got, want) <= RTOL
    # filler lanes contribute exactly nothing
    assert filler.any()
    for got in f_t:
        assert np.all(got.numpy()[filler] == 0.0)


def _short_rc(pot):
    return float(pot.sym_coeang[0, 3]) / CFLENGTH + 0.2


@pytest.mark.parametrize("npsf,ang", [
    (3, None),                                  # the shipped table's layout
    (2, ((0.02, 1.0, 3.0), (0.05, -1.0, 1.0), (0.02, -1.0, 2.0))),
])
def test_ni_table_matches_jax(npsf, ang):
    kw = {} if ang is None else {"ang": ang}
    pot = synthetic_ni_potential(0, npsf=npsf, nnod=6, **kw)
    table = fn.ni_table(pot.sym_coerad, pot.sym_coeang)
    want = dict(jpn._ni_cfg_key(pot.sym_coerad, pot.sym_coeang))
    assert table.rad == want["rad"] and table.rc_a == want["rc_a"]
    assert table.ang == want["ang"]
    # the same table from float32 tensors, as FusedNi builds it
    t32 = fn.ni_table(torch.tensor(pot.sym_coerad, dtype=torch.float32),
                      torch.tensor(pot.sym_coeang, dtype=torch.float32))
    assert t32.rc_a == float(np.float32(pot.sym_coeang[0, 3]))
    # per-function angular cutoffs are refused, as `_ni_cfg_key` refuses
    bad = pot.sym_coeang.copy()
    bad[0, 3] += 0.5
    with pytest.raises(ValueError):
        fn.ni_table(pot.sym_coerad, bad)


@pytest.mark.parametrize("ang", [
    None,                                       # NI_REDUCED_ANG
    ((0.01, 1.0, 3.0), (0.05, -1.0, 2.0)),      # zeta 3: the pow path
])
def test_plain_kernels_match_pallas_reduced(ang):
    pot = reduced_ni_potential() if ang is None else reduced_ni_potential(
        ang=ang)
    _compare(*ni_short_planes(_short_rc(pot), 16), pot)


@pytest.fixture(scope="module")
def full_width():
    """The shipped width (27 functions, Ks 32) on 32 rows: the Pallas
    interpreter's trace of the unrolled 32-step q loop takes most of a
    minute."""
    pot = synthetic_ni_potential(0)
    planes, filler = ni_short_planes(_short_rc(pot), 32, seed=2)
    return [a[:32] for a in planes], filler[:32], pot


def test_plain_kernels_match_pallas_full_width(full_width):
    _compare(*full_width)


def test_pow_zeta_matches_jax():
    f1 = np.linspace(0.0, 2.0, 9)
    for zeta in (1.0, 2.0, 4.0, 16.0, 3.0, 2.5):
        got = fn._pow_zeta(t64(f1), zeta)
        want = jpn._pow_zeta(jnp.asarray(f1), zeta)
        for u, v in zip(got, want):
            np.testing.assert_allclose(u.numpy(), np.asarray(v), rtol=1e-15)


def test_wrappers_take_plain_on_cpu():
    pot = reduced_ni_potential()
    table = fn.ni_table(pot.sym_coerad, pot.sym_coeang)
    planes = [t64(a) for a in ni_short_planes(_short_rc(pot), 16)[0]]
    dedg = t64(_dedg(planes[0].shape[0], pot.nsf))
    before = (kernels.ni_g.launches, kernels.ni_force.launches)
    assert torch.equal(kernels.ni_g(*planes, table),
                       fn.ni_g_plain(*planes, table))
    got = kernels.ni_force(*planes, dedg, table)
    want = fn.ni_force_plain(*planes, dedg, table)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert (kernels.ni_g.launches, kernels.ni_force.launches) == before
    meta = [t.to("meta") for t in planes]
    with pytest.raises(ValueError):
        kernels.ni_g(*meta, table)
