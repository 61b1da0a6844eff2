"""Rows of more than 512 partners (wider than the kernels' single launches,
MAX_K = NI_MAX_K = 512) through the port's entry points, against the JAX
package, on the CPU in f64. Here the harmonic wrappers run the plain
version on the virtual rows of the tile split, and the ni wrappers the
plain twins of the cross-tile kernels (tests/test_torch_cuda.py and
chip_smoke.py hold the CUDA kernels to them on the card).

  * The decompositions: the harmonic split and combine and the ni
    cross-tile twins against the plain versions on the whole row, at K
    513, 640 and 1,000 on rows of random partners in a ball (some filler
    lanes).
  * fe: perturbed bcc 9^3 cells (1,458 atoms, box 25.70 A >= 2 (rc +
    skin)) on the reduced-width synthetic potential (npsf 4, ntsf 5) at
    rc 11.5 A: 536 lattice partners within rc, ~620 within rc + 0.5 (the
    skin rows, 704 wide). The chunked functions on the skin rows and the
    frame function on 32 centre rows against the JAX autodiff functions;
    the images function on a 1 x 1 x 9-cell box thin along x and y
    (11 x 11 images) against the JAX one.
  * ANNA-ADP: the reduced-width synthetic `.anna` (cut 5.055 A) on bcc 7^3
    cells compressed to 0.42 a, whose minimum-image rows hold ~535
    partners within cut: local_params and energy_forces_virial,
    make_anna_fast_fns(k_short=640) and the frame fast path against the JAX
    functions.
  * ni: the reduced BP table (2 radial + 4 angular functions) at Rc 11.0 A
    (fcc: 530 lattice partners) on a thin 1 x 1 x 7-cell fcc box through
    images; at its Rc of 2.91 A on a periodic fcc 5 x 5 x 6 box compressed
    to 0.225 a, whose minimum-image rows hold ~570 partners within Rc,
    make_short_chunked_fns (the chunked functions under the Simulator's
    short rows) against the JAX trio, and the frame function on 16 of its
    rows (tests/test_torch_chunked.py holds the chunked functions on a
    0.23 a box).

Tolerances (f64), those of tests/test_torch_wide_rows.py: energies rtol
1e-10, forces atol 1e-9 eV/A, virials within 1e-10 of max |W| (ANNA: the
bars of tests/test_torch_anna.py); the delivered forces sum to zero within
1e-12 N max |F|. The decompositions reorder the row sums only: 1e-13 of
each output's largest value.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu.models import anna_adp as JA
from meng_zhang_tpu.models import annp as jannp
from meng_zhang_tpu.system.neighbors import build_neighbors_n2 as jax_n2
from meng_zhang_tpu_torch.geometry.lattice import bcc, fcc
from meng_zhang_tpu_torch.models import anna_adp as A
from meng_zhang_tpu_torch.models import annp
from meng_zhang_tpu_torch.ops import fused_annp as fa
from meng_zhang_tpu_torch.ops import fused_ni as fn
from meng_zhang_tpu_torch.ops import kernels
from meng_zhang_tpu_torch.system.neighbors import build_neighbors_n2
from meng_zhang_tpu_torch.testing import (synthetic_anna_potential,
                                          synthetic_ni_potential, thermal_fcc)
from meng_zhang_tpu_torch.units import CFLENGTH
from torch_port_util import (NI_REDUCED_ANG, perturbed_bcc,
                             reduced_ni_potential, reduced_potential,
                             rel_max, t64)

E_RTOL, F_ATOL, W_RTOL, SUM_F_REL = 1e-10, 1e-9, 1e-10, 1e-12
DECOMP_RTOL = 1e-13
FE_RC, SKIN, FE_CAP = 11.5, 0.5, 704
NI_RC = 11.0
ANNA_REDUCED = dict(npsf=4, ntsf=5, nnod=6)
A_RTOL, A_F_RTOL, A_F_ATOL, A_W_RTOL, A_W_ATOL = 1e-10, 1e-8, 1e-10, 1e-8, \
    1e-9
N_CENTRE = 32          # centre rows of the frame cases


def _check(got, want, n):
    """(E, F, W) against (E, F, W) at the bars above; F sums to zero."""
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=E_RTOL)
    f = got[1].numpy()
    np.testing.assert_allclose(f, np.asarray(want[1]), rtol=0, atol=F_ATOL)
    w = np.asarray(want[2])
    assert np.max(np.abs(got[2].numpy() - w)) <= W_RTOL * np.max(np.abs(w))
    assert np.max(np.abs(f.sum(0))) <= SUM_F_REL * n * np.max(np.abs(f))


def _widest(idx, n):
    return int((idx < n).sum(1).max())


def _ni_potential():
    """The reduced BP table at Rc 11.0 A. Its output weights are scaled to
    w_out 0.1 (2.0 by default): the default's forces on the thin box reach
    ~1.5e3 eV/A, where f64 rounding alone moves them by ~1e-9."""
    return synthetic_ni_potential(0, npsf=2, nnod=6, rc_bohr=NI_RC * CFLENGTH,
                                  ang=NI_REDUCED_ANG, w_out=0.1)


# ------------------------------------------------------- decompositions
def _ball_planes(p, k, rmax, seed):
    """[P, K] planes of partners spread through a ball of radius rmax, the
    last 40 lanes of row 0 filler (2 box + 10 on every axis)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(p, k, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    x = u * rmax * rng.uniform(0.05, 1.0, size=(p, k, 1)) ** (1.0 / 3.0)
    x[0, -40:] = 2.0 * 30.0 + 10.0
    return [t64(np.ascontiguousarray(x[..., a])) for a in range(3)]


@pytest.mark.parametrize("k", [513, 640, 1000])
def test_harmonic_tiles_equal_whole_rows(k):
    """The wrappers split a row wider than MAX_K into virtual rows of
    HARM_TILE slots: g_raw, A and Fj equal the plain versions on the whole
    row."""
    npsf, ntsf, rc = 9, 19, 6.5
    planes = _ball_planes(4, k, rc + 0.5, seed=k)
    rng = np.random.default_rng(1)
    dedg = t64(rng.normal(size=(4, fa.NSF_PAD)))
    b = t64(rng.normal(size=(4, fa.AB_PAD)))
    g, a = kernels.g_harm(*planes, npsf, ntsf, rc)
    g0, a0 = fa.g_harm_plain(*planes, npsf, ntsf, rc)
    assert rel_max(g, g0) <= DECOMP_RTOL and rel_max(a, a0) <= DECOMP_RTOL
    assert torch.all(g[:, npsf + ntsf + 1:] == 0)
    got = kernels.force_harm(*planes, dedg, b, npsf, ntsf, rc)
    want = fa.force_harm_plain(*planes, dedg, b, npsf, ntsf, rc)
    for u, v in zip(got, want):
        assert u.shape == (4, k) and u.is_contiguous()
        assert rel_max(u, v) <= DECOMP_RTOL
    assert bool((got[0][0, -40:] == 0).all())


@pytest.mark.parametrize("k", [513, 640, 1000])
def test_ni_cross_tiles_equal_whole_rows(k):
    """Rows wider than NI_MAX_K through the ni wrappers, which take the
    cross-tile twins on the CPU: g (the partials of the U = T (T + 1) / 2
    units, each unordered leg pair in one of them, summed in unit order)
    and Fj (each pair's two sides from one symmetric part, a slot's
    partials by partner tile added in tile order) equal the plain versions
    on the whole row."""
    pot = _ni_potential()
    table = fn.ni_table(pot.sym_coerad, pot.sym_coeang)
    planes = _ball_planes(2, k, NI_RC * 1.05, seed=k + 1)
    dedg = t64(np.random.default_rng(2).normal(size=(2, fn.NSF_SUB)))
    part = fn.ni_g_tiles_plain(*planes, table, kernels.NI_TILE)
    nt = -(-k // kernels.NI_TILE)
    assert part.shape == (2, nt * (nt + 1) // 2, fn.NSF_SUB)
    g = kernels.ni_g(*planes, table)
    assert torch.equal(g, fa.sum_tiles(part))
    assert rel_max(g, fn.ni_g_plain(*planes, table)) <= DECOMP_RTOL
    got = kernels.ni_force(*planes, dedg, table)
    for u, v, w in zip(got, fn.ni_force_tiles_plain(*planes, dedg, table,
                                                    kernels.NI_TILE),
                       fn.ni_force_plain(*planes, dedg, table)):
        assert u.shape == (2, k) and torch.equal(u, v)
        assert rel_max(u, w) <= DECOMP_RTOL
    assert bool((got[0][0, -40:] == 0).all())


@pytest.mark.parametrize("k,tile", [(60, 16), (90, 32),
                                    (200, kernels.NI_TILE)])
def test_ni_force_tiles_two_kernels(k, tile):
    """ni_force_tiles' two kernels, as their plain twins (at NI_TILE through
    the wrappers, `units` and `ni_force_tiles_sum`, which take them on the
    CPU): the unit partials part [P, T, T, 4, tile] hold a slot at its
    place among its tile's slots inside the angular cutoff and 0 past them;
    the sum reads those places alone (NaN past them changes no bit); the
    two in turn give ni_force_tiles_plain's bits, within DECOMP_RTOL of
    ni_force_plain."""
    pot = _ni_potential()
    table = fn.ni_table(pot.sym_coerad, pot.sym_coeang)
    planes = _ball_planes(2, k, NI_RC * 1.05, seed=k)
    dedg = t64(np.random.default_rng(3).normal(size=(2, fn.NSF_SUB)))
    if tile == kernels.NI_TILE:
        part = kernels.ni_force_tiles.units(*planes, dedg, table)
        got = kernels.ni_force_tiles_sum(*planes, dedg, part, table)
    else:
        part = fn.ni_force_tiles_part_plain(*planes, dedg, table, tile)
        got = fn.ni_force_tiles_sum_plain(*planes, dedg, part, table)
    nt = -(-k // tile)
    assert part.shape == (2, nt, nt, 4, tile)
    in_a = torch.nn.functional.pad(
        fn._ni_geometry(*planes, table.rc_a)[6], (0, nt * tile - k))
    n_in = in_a.view(2, nt, tile).sum(2)                 # [P, T]
    past = torch.arange(tile)[None, None, :] >= n_in[:, :, None]
    assert bool((n_in < tile).any())
    past = past[:, :, None, None, :].expand(part.shape)
    assert bool((part[past] == 0).all())
    poisoned = part.masked_fill(past, float("nan"))
    for u, v, w, x in zip(got, fn.ni_force_tiles_plain(*planes, dedg, table,
                                                       tile),
                          fn.ni_force_plain(*planes, dedg, table),
                          fn.ni_force_tiles_sum_plain(*planes, dedg,
                                                      poisoned, table)):
        assert u.shape == (2, k) and torch.equal(u, v) and torch.equal(u, x)
        assert rel_max(u, w) <= DECOMP_RTOL


# ------------------------------------------------------------------- fe
@pytest.fixture(scope="module")
def bulk():
    """The perturbed bcc 9^3 box and its skin rows at rc + skin (JAX
    build)."""
    x, box = perturbed_bcc(9, seed=7, disp=0.1)
    xj, bj = jnp.asarray(x), jnp.asarray(box)
    jn = jax_n2(xj, bj, FE_RC + SKIN, FE_CAP)
    assert not bool(jn.overflow)
    idx = torch.as_tensor(np.array(jn.idx)).long()
    within = (idx < len(x)) & (sum(
        d * d for d in fa.pair_dx_planes(t64(x), t64(box), idx,
                                         (True,) * 3)) < FE_RC ** 2)
    assert kernels.MAX_K < int(within.sum(1).min())
    return types.SimpleNamespace(x=t64(x), box=t64(box), xj=xj, bj=bj,
                                 jidx=jn.idx, idx=idx)


@pytest.fixture(scope="module")
def fe(bulk):
    pot = reduced_potential(cut=FE_RC)
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    want = jannp.energy_forces_virial_chunked(
        jcfg, jparams, bulk.xj, bulk.bj, bulk.jidx, chunk=16, shift=False)
    return types.SimpleNamespace(pot=pot, jcfg=jcfg, jparams=jparams, cfg=cfg,
                                 params=params, want=want)


def test_chunked_functions_take_widest_fe_rows(bulk, fe):
    """The chunked functions (run.py's --engine xla route) on skin rows of
    ~620 partners: compacted to their 530-560 partners within rc, in
    virtual rows of HARM_TILE slots, the JAX functions' E, F, W."""
    n = len(bulk.x)
    got = annp.energy_forces_virial_chunked(fe.cfg, fe.params, bulk.x,
                                            bulk.box, bulk.idx, shift=False)
    _check(got, fe.want, n)
    e, f = annp.energy_forces_chunked(fe.cfg, fe.params, bulk.x, bulk.box,
                                      bulk.idx, shift=False)
    assert float(e) == float(got[0]) and torch.equal(f, got[1])


def test_frame_takes_widest_fe_rows(bulk, fe):
    """energy_forces_virial_frame on a frame that is the whole box with
    its first N_CENTRE atoms as the centre rows: per-atom energies, forces
    and W against the JAX frame function on the same rows."""
    c = N_CENTRE
    eat, f, w = annp.energy_forces_virial_frame(
        fe.cfg, fe.params, bulk.x, bulk.box, bulk.idx[:c], 0, (0, c))
    eat_j, f_j, w_j = jannp.energy_forces_virial_frame(
        fe.jcfg, fe.jparams, bulk.xj, bulk.bj, bulk.jidx[:c], 0, (0, c),
        chunk=16)
    np.testing.assert_allclose(eat.numpy() + fe.cfg.e_shift,
                               np.asarray(eat_j), rtol=E_RTOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_j), rtol=0,
                               atol=F_ATOL)
    assert rel_max(w, w_j) <= W_RTOL


def _thin_case(x, box, pot, rc):
    """A thin box's image rows (JAX build over x_ext) and the JAX images
    evaluation: (cfg_eff, params, shifts, rows, want)."""
    pbc = (True, True, True)
    shifts, pbc_eff = jannp.image_shift_table(box, rc + SKIN, pbc)
    assert shifts is not None and pbc_eff == (False, False, True)
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64, pbc=pbc)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu", pbc=pbc)
    x_ext = (x[None] + (shifts * box)[:, None]).reshape(-1, 3)
    jn = jax_n2(jnp.asarray(x_ext), jnp.asarray(box), rc + SKIN, FE_CAP,
                pbc=pbc_eff)
    assert not bool(jn.overflow)
    rows = jn.idx[:len(x)]
    want = jannp.energy_forces_virial_images(
        dataclasses.replace(jcfg, pbc=pbc_eff), jparams, jnp.asarray(x),
        jnp.asarray(box), rows, shifts, chunk=16, shift=False)
    return (dataclasses.replace(cfg, pbc=pbc_eff), params, shifts,
            torch.as_tensor(np.array(rows)).long(), want)


@pytest.mark.parametrize("kind", ["fe", "ni"])
def test_images_take_widest_rows(kind):
    """energy_forces_virial_images on a box thin along x and y, whose
    image rows hold more than 512 partners within the cutoff, fe (bcc 1 x
    1 x 9 cells, rc 11.5 A: 11 x 11 images) and BP (fcc 1 x 1 x 7, Rc
    11.0 A: 9 x 9 images), against the JAX function."""
    rng = np.random.default_rng(4)
    if kind == "fe":
        x, box = bcc([1, 1, 9])
        pot, rc = reduced_potential(cut=FE_RC), FE_RC
    else:
        x, box = fcc([1, 1, 7], 3.52)
        pot, rc = _ni_potential(), NI_RC
    x = x + rng.normal(scale=0.05, size=x.shape)
    cfg, params, shifts, rows, want = _thin_case(x, box, pot, rc)
    n = len(x)
    dd = fa.pair_dx_planes(t64(x), t64(box), rows, cfg.pbc,
                           x_ext=t64((x[None] + (shifts * box)[:, None])
                                     .reshape(-1, 3)))
    assert kernels.MAX_K < int((sum(d * d for d in dd) < rc * rc).sum(1)
                               .max())
    got = annp.energy_forces_virial_images(cfg, params, t64(x), t64(box),
                                           rows, shifts, shift=False)
    _check(got, want, n)


# ------------------------------------------------------------------- ni
def test_short_chunked_fns_take_widest_ni_rows():
    """make_short_chunked_fns(k_short=640), the BP Simulator trio, on fcc
    5 x 5 x 6 cells (600 atoms) compressed to 0.225 a (box 3.96 x 3.96 x
    4.75 A) on the reduced BP potential (Rc 2.91 A): every minimum-image
    row lists the other 599 atoms within Rc + 0.3 and holds ~570 within
    Rc, more than NI_MAX_K. The short rows equal the JAX trio's; the force
    function (the chunked functions: rows compacted to whole tiles of
    kernels.NI_TILE, the cross-tile twins) gives its E, F, W. Both
    packages evaluate the same minimum-image rows (tests/
    test_torch_chunked.py holds a 0.23 a box through the chunked functions
    directly)."""
    pot = reduced_ni_potential()
    x, box = thermal_fcc((5, 5, 6), seed=5, disp=0.02)
    x, box = x * 0.225, box * 0.225
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    rc = annp.descriptor_cutoff(cfg, params)
    nb = build_neighbors_n2(t64(x), t64(box), rc + 0.5, len(x))
    assert not bool(nb.overflow)
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64)
    xj, bj = jnp.asarray(x), jnp.asarray(box)
    jnb = types.SimpleNamespace(idx=jnp.asarray(nb.idx.numpy()))
    f, _, sb = annp.make_short_chunked_fns(cfg, params, k_short=640,
                                           delta=0.3)
    jf, _, jsb = jannp.make_short_chunked_fns(jcfg, jparams, k_short=640,
                                              delta=0.3, chunk=16)
    sh, jsh = sb(t64(x), t64(box), nb), jsb(xj, bj, jnb)
    np.testing.assert_array_equal(sh.idx.numpy(), np.asarray(jsh.idx))
    assert not bool(sh.overflow) and not bool(jsh.overflow)
    within = sum(d * d for d in fa.pair_dx_planes(
        t64(x), t64(box), sh.idx, (True,) * 3)) < rc * rc
    assert kernels.NI_MAX_K < int(within.sum(1).max())
    _check(f(t64(x), t64(box), nb, sh), jf(xj, bj, jnb, jsh), len(x))


def test_frame_takes_widest_ni_rows():
    """energy_forces_virial_frame (the sharded drivers' XlaFrameModel) on
    the 600-atom box compressed to 0.225 a with its first N_CENTRE / 2
    atoms as the centre rows, their 599-wide minimum-image rows (~570
    partners within Rc): per-atom energies, forces and W against the JAX
    frame function."""
    pot = reduced_ni_potential()
    x, box = thermal_fcc((5, 5, 6), seed=5, disp=0.02)
    x, box = x * 0.225, box * 0.225
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64)
    rc = annp.descriptor_cutoff(cfg, params)
    c = N_CENTRE // 2
    nb = build_neighbors_n2(t64(x), t64(box), rc + 0.5, len(x))
    idx = nb.idx[:c]
    assert kernels.NI_MAX_K < _widest(idx, len(x))
    eat, f, w = annp.energy_forces_virial_frame(cfg, params, t64(x),
                                                t64(box), idx, 0, (0, c))
    eat_j, f_j, w_j = jannp.energy_forces_virial_frame(
        jcfg, jparams, jnp.asarray(x), jnp.asarray(box),
        jnp.asarray(idx.numpy()), 0, (0, c), chunk=16)
    np.testing.assert_allclose(eat.numpy() + cfg.e_shift, np.asarray(eat_j),
                               rtol=E_RTOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_j), rtol=0,
                               atol=F_ATOL)
    assert rel_max(w, w_j) <= W_RTOL


# ------------------------------------------------------------- ANNA-ADP
@pytest.fixture(scope="module")
def anna():
    """bcc 7^3 cells (686 atoms) compressed to 0.42 a (box 8.39 A, nearest
    pair 0.86 A, past the ADP density's r0 = 0.5 A) on the reduced-width
    synthetic `.anna` (cut 5.055 A): the minimum-image rows hold 529-540
    partners within cut and up to 606 within cut + 0.3; the rows at
    cut + 0.5 list every atom (685 wide). Both packages evaluate the same
    minimum-image rows."""
    x, box = perturbed_bcc(7, seed=7, disp=0.1)
    x, box = x * 0.42, box * 0.42
    pot = synthetic_anna_potential(0, **ANNA_REDUCED)
    cfg, params = A.make_anna(pot, torch.float64, "cpu")
    jcfg, jparams = JA.make_anna(pot, dtype=jnp.float64)
    nb = build_neighbors_n2(t64(x), t64(box), cfg.cut + 0.5, len(x))
    assert not bool(nb.overflow)
    within = sum(d * d for d in fa.pair_dx_planes(
        t64(x), t64(box), nb.idx, (True,) * 3)) < cfg.cut ** 2
    assert kernels.MAX_K < int(within.sum(1).min())
    return types.SimpleNamespace(cfg=cfg, p=params, jcfg=jcfg, jp=jparams,
                                 x=t64(x), box=t64(box), idx=nb.idx,
                                 xj=jnp.asarray(x), bj=jnp.asarray(box),
                                 jidx=jnp.asarray(nb.idx.numpy()
                                                  .astype(np.int32)))


def _anna_close(got, want):
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=A_RTOL)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=A_F_RTOL, atol=A_F_ATOL)
    np.testing.assert_allclose(np.asarray(got[2]), np.asarray(want[2]),
                               rtol=A_W_RTOL, atol=A_W_ATOL)


def test_anna_reference_functions_take_widest_rows(anna):
    """local_params (rows compacted to whole tiles of g_harm) and
    energy_forces_virial on the 685-wide rows against the JAX functions on
    the same rows."""
    a = anna
    got = A.local_params(a.cfg, a.p, a.x, a.box, a.idx)
    want = JA.local_params(a.jcfg, a.jp, a.xj, a.bj, a.jidx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=A_RTOL)
    _anna_close(A.energy_forces_virial(a.cfg, a.p, a.x, a.box, a.idx),
                JA.energy_forces_virial(a.jcfg, a.jp, a.xj, a.bj, a.jidx))


def test_anna_fast_fns_take_widest_rows(anna):
    """make_anna_fast_fns(k_short=640): short rows of ~600 partners within
    cut + 0.3 through the tiled g_harm, against the JAX fast path at the
    same k_short."""
    a = anna
    t = types.SimpleNamespace(idx=a.idx)
    force_fn, _, build = A.make_anna_fast_fns(a.cfg, a.p, k_short=640,
                                              delta=0.3)
    short = build(a.x, a.box, t)
    assert not bool(short.overflow)
    assert kernels.MAX_K < _widest(short.idx, len(a.x)) <= 640
    jfns = JA.make_anna_fast_fns(a.jcfg, a.jp, k_short=640, delta=0.3)
    nbj = types.SimpleNamespace(idx=a.jidx)
    _anna_close(force_fn(a.x, a.box, t, short),
                jfns[0](a.xj, a.bj, nbj, jfns[2](a.xj, a.bj, nbj)))


def test_anna_frame_fast_takes_widest_rows(anna):
    """energy_forces_frame_fast on the first N_CENTRE rows of the box as
    the frame's centre rows (685-wide rows, no compaction: g_harm in
    tiles) against the JAX function."""
    a, c = anna, N_CENTRE
    e, f, w = A.energy_forces_frame_fast(a.cfg, a.p, a.x[:c], a.x, a.box,
                                         a.idx[:c], 0, (0, c),
                                         want_virial=True)
    e_j, f_j, w_j = JA.energy_forces_frame_fast(
        a.jcfg, a.jp, a.xj[:c], a.xj, a.bj, a.jidx[:c], 0, (0, c),
        want_virial=True)
    np.testing.assert_allclose(e.numpy() + a.cfg.e_base, np.asarray(e_j),
                               rtol=A_RTOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_j), rtol=A_F_RTOL,
                               atol=A_F_ATOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=A_W_RTOL,
                               atol=A_W_ATOL)
