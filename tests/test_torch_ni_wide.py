"""The ni (Behler-Parrinello) path at rows wider than one warp and at the
kernels' full table reach, against the JAX package, on the CPU in f64
(the kernel wrappers take their plain versions here; tests/test_torch_cuda.py
and chip_smoke.py hold the CUDA kernels to them on the card).

Scene: thermal_fcc(4, seed=3, disp=0.1), 256 atoms in a 14.08 A box, with
two synthetic BP potentials at Rc 6.0 A: the shipped table's shape (3
radial + 24 angular functions, "shipped") and the 10 + 22 table of
testing.NI_WIDE_ANGULAR (20 distinct etas, 22 shapes, zetas that are no
powers of two, "wide"). fcc holds 86 partners within 6.2 A: the short rows
read ~87 of Ks 128, the skin rows up to ~107 of 128, where the port's
kernels took at most 32 before.

JAX references: `energy_forces_virial_chunked` (the chunked autodiff of the
BP energy, chunk 32) for whole evaluations, and jax.vmap of
`descriptors.behler_g` with jax.grad for the kernels' plain versions.
PallasNi(k_short=128) in interpret mode is left out: its Pallas kernels
unroll a 128-step q loop, and one evaluation did not finish compiling in
10 minutes on a CPU even at 4 angular functions. JAX's vmap-over-atoms
`energy_forces` at this size peaks near 5 GB; the chunked form computes the
same function (they agree to 1.2e-12 eV/A here).

Tolerances as tests/test_torch_ni_ops.py: energy rtol 1e-10, forces atol
1e-9 eV/A, virial within 1e-9 of max |W|, descriptors and per-pair forces
within 1e-12 of their largest value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu.models import annp as jannp
from meng_zhang_tpu.models.descriptors import behler_g
from meng_zhang_tpu_torch.models import annp
from meng_zhang_tpu_torch.ops import fused_annp as fa
from meng_zhang_tpu_torch.ops import fused_ni as fn
from meng_zhang_tpu_torch.ops import kernels
from meng_zhang_tpu_torch.system.neighbors import build_neighbors_n2
from meng_zhang_tpu_torch.testing import (NI_WIDE_ANGULAR, NI_WIDE_RAD_ETAS,
                                          synthetic_ni_potential, thermal_fcc)
from meng_zhang_tpu_torch.units import CFLENGTH
from test_torch_ni_cfg import _check_against_table
from torch_port_util import t64

E_RTOL, F_ATOL, W_RTOL, REL = 1e-10, 1e-9, 1e-9, 1e-12
RC_BOHR = 6.0 * CFLENGTH
KS, DELTA, SKIN, CAPACITY = 128, 0.2, 0.5, 128
PLAIN_ROWS = 16


def _potential(table):
    if table == "shipped":
        return synthetic_ni_potential(0, rc_bohr=RC_BOHR)
    return synthetic_ni_potential(0, npsf=10, rc_bohr=RC_BOHR,
                                  ang=NI_WIDE_ANGULAR,
                                  rad_etas=NI_WIDE_RAD_ETAS)


@pytest.fixture(scope="module", params=["shipped", "wide"])
def case(request):
    """The scene, its skin list, both packages' models and the JAX
    chunked evaluation (E, F, W), computed once per table."""
    pot = _potential(request.param)
    x, box = thermal_fcc(4, seed=3, disp=0.1)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64)
    rc = annp.descriptor_cutoff(cfg, params)
    nb = build_neighbors_n2(t64(x), t64(box), rc + SKIN, CAPACITY)
    assert not bool(nb.overflow)
    want = jannp.energy_forces_virial_chunked(
        jcfg, jparams, jnp.asarray(x), jnp.asarray(box),
        jnp.asarray(nb.idx.numpy()), chunk=32, shift=False)
    return dict(table=request.param, pot=pot, x=x, box=box, cfg=cfg,
                params=params, rc=rc, idx=nb.idx, want=want)


def _check(got, want):
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=E_RTOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=F_ATOL)
    w = np.asarray(want[2])
    assert np.abs(got[2].numpy() - w).max() <= W_RTOL * np.abs(w).max()


def test_scene_rows_are_wide(case):
    assert case["rc"] == pytest.approx(6.0)
    ev = fn.FusedNi(case["cfg"], case["params"], k_short=KS,
                    short_delta=DELTA)
    x, box = t64(case["x"]), t64(case["box"])
    sl = ev.compact_short(x, box, case["idx"])
    widest = int((sl.sidx < len(x)).sum(1).max())
    assert not bool(sl.overflow)
    assert 80 <= widest <= KS
    assert int((case["idx"] < len(x)).sum(1).max()) > 96


def test_fused_ni_k128_matches_jax(case):
    """FusedNi at Ks 128: its short list at Rc + 0.2 A, the descriptors,
    the network and the per-pair forces of ~87-partner rows."""
    ev = fn.FusedNi(case["cfg"], case["params"], k_short=KS,
                    short_delta=DELTA)
    x, box = t64(case["x"]), t64(case["box"])
    _check(ev.energy_forces(x, box, case["idx"], shift=False), case["want"])


def test_chunked_bp_wide_rows_match_jax(case):
    """The chunked BP functions on the 128-wide skin rows (evaluated as
    they are) and on rows compacted to 96 at the descriptor cutoff, which
    the port refused while its kernels took 32 slots a row."""
    cfg, params = case["cfg"], case["params"]
    x, box, idx = t64(case["x"]), t64(case["box"]), case["idx"]
    want = case["want"]
    _check(annp.energy_forces_virial_chunked(cfg, params, x, box, idx,
                                             shift=False), want)
    e, f = annp.energy_forces_chunked(cfg, params, x, box, idx, shift=False)
    _check((e, f, torch.tensor(np.asarray(want[2]))), want)
    idx_s, ovf = annp.compact_neighbor_rows(x, box, idx, case["rc"], 96)
    assert not bool(ovf)
    _check(annp.energy_forces_virial_chunked(cfg, params, x, box, idx_s,
                                             shift=False), want)
    np.testing.assert_allclose(
        float(annp.energy_chunked(cfg, params, x, box, idx_s, shift=False)),
        float(want[0]), rtol=E_RTOL)


def _jax_g_and_grad(dx, mask, w, coerad, coeang):
    """Raw descriptors [P, nsf] of each row (behler_g) and d(w . G)/d dx
    [P, K, 3]: the per-pair Fj = -dE_i/dx_j, dx = x_i - x_j."""
    def g_row(d, m):
        return behler_g(d, m, coerad, coeang)

    def e_row(d, m, wr):
        return jnp.dot(wr, g_row(d, m))

    g = jax.vmap(g_row)(dx, mask)
    fj = jax.vmap(jax.grad(e_row))(dx, mask, w)
    return np.asarray(g), np.asarray(fj)


def test_plain_versions_at_k128_match_jax_descriptors(case):
    """ni_g_plain / ni_force_plain on PLAIN_ROWS rows of [P, 128] short
    planes (filler lanes included) against JAX's own BP descriptor
    definition and its gradient."""
    ev = fn.FusedNi(case["cfg"], case["params"], k_short=KS,
                    short_delta=DELTA)
    x, box = t64(case["x"]), t64(case["box"])
    sidx = ev.compact_short(x, box, case["idx"]).sidx[:PLAIN_ROWS]
    planes = fa.pair_dx_planes(x, box, sidx, ev.pbc)
    assert planes[0].shape == (PLAIN_ROWS, KS)
    nsf = case["pot"].nsf
    w = np.zeros((PLAIN_ROWS, fn.NSF_SUB))
    w[:, :nsf] = np.random.default_rng(5).normal(size=(PLAIN_ROWS, nsf))
    g = fn.ni_g_plain(*planes, ev.table).numpy()
    fj = np.stack([a.numpy() for a in fn.ni_force_plain(
        *planes, torch.as_tensor(w), ev.table)], -1)
    dx = np.stack([a.numpy() for a in planes], -1)
    g_want, fj_want = _jax_g_and_grad(
        jnp.asarray(dx), jnp.asarray((sidx < len(x)).numpy()),
        jnp.asarray(w[:, :nsf]), jnp.asarray(case["pot"].sym_coerad),
        jnp.asarray(case["pot"].sym_coeang))
    assert (g[:, nsf:] == 0.0).all()
    for got, want in ((g[:, :nsf], g_want), (fj, fj_want)):
        scale = np.abs(want).max()
        assert scale > 0
        assert np.abs(got - want).max() <= REL * scale


def test_ni_cfg_of_the_wide_potentials(case):
    """The kernels' table of each potential, field by field."""
    table = fn.ni_table(case["pot"].sym_coerad, case["pot"].sym_coeang)
    for suffix in ("f32", "f64"):
        c = kernels._ni_cfg(table, suffix)
        assert c.nrad + c.nang == case["pot"].nsf
    _check_against_table(kernels._ni_cfg(table, "f64"), table)


def test_fused_ni_takes_k_short_up_to_ni_max_k(case):
    for ks in (1, kernels.NI_MAX_K):
        assert fn.FusedNi(case["cfg"], case["params"], k_short=ks).k_short \
            == ks
    for ks in (0, kernels.NI_MAX_K + 1):
        with pytest.raises(ValueError, match="NI_MAX_K"):
            fn.FusedNi(case["cfg"], case["params"], k_short=ks)
