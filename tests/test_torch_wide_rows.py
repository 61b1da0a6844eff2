"""Rows of 257-512 partners (the kernels' MAX_K = NI_MAX_K = 512) through
the port's entry points, against the JAX package, on the CPU in f64 (the
kernel wrappers take their plain versions here; tests/test_torch_cuda.py
and chip_smoke.py hold the CUDA kernels to them on the card).

Scenes, each cut to the smallest periodic box that holds such rows:
  * fe: perturbed bcc 8^3 cells (1,024 atoms, box 22.84 A >= 2 (rc + skin))
    on the reduced-width synthetic potential (npsf 4, ntsf 5) at rc 9.7 A.
    The skin rows at rc + 0.8 hold up to ~420 partners (width 512), the
    short rows at rc + 0.4 up to ~364 of Ks 384. `FusedAnnp(k_short=384)`
    on both angular paths against `PallasAnnp(k_short=384)` in interpret
    mode, and the chunked and frame functions on the 512-wide skin rows
    against the JAX autodiff functions;
  * ni: thermal fcc 6^3 cells (864 atoms, box 21.12 A) on a reduced BP
    table (2 radial + 4 angular functions) at Rc 9.2 A, ~330 partners a
    row within Rc + 0.2 A, listed 352 wide. `FusedNi(k_short=352)` and the
    chunked functions on those rows against the JAX chunked functions.
    `PallasNi(k_short=352)` in interpret mode is left out: its kernels
    unroll the Ks-step q loop, and at Ks 128 one evaluation did not finish
    compiling in 10 minutes (tests/test_torch_ni_wide.py);
  * ANNA-ADP: the 54-atom scene of tests/test_torch_anna.py,
    `make_anna_fast_fns(k_short=320)` against its k_short 72 result and the
    JAX fast path's, and the reference-shaped functions on a 320-wide skin
    list against the JAX ones on the same list.

Tolerances (f64): energies rtol 1e-10, forces atol 1e-9 eV/A, virials within
1e-10 of max |W| (ANNA: the bars of tests/test_torch_anna.py); the
delivered forces sum to zero within 1e-12 N max |F| (each pair's Fj is
added to one row and taken from the other).
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu.models import anna_adp as JA
from meng_zhang_tpu.models import annp as jannp
from meng_zhang_tpu.ops.pallas_annp import PallasAnnp
from meng_zhang_tpu.system.neighbors import build_neighbors_n2 as jax_n2
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
                             reduced_potential, t64)

E_RTOL, F_ATOL, W_RTOL, SUM_F_REL = 1e-10, 1e-9, 1e-10, 1e-12
FE_RC, FE_KS, FE_DELTA, FE_SKIN = 9.7, 384, 0.4, 0.8
NI_RC, NI_KS, NI_DELTA = 9.2, 352, 0.2
ANNA_REDUCED = dict(npsf=4, ntsf=5, nnod=6)
A_RTOL, A_F_RTOL, A_F_ATOL, A_W_RTOL, A_W_ATOL = 1e-10, 1e-8, 1e-10, 1e-8, \
    1e-9


def _check(got, want, n, e_offset=0.0):
    """(E, F, W) against (E, F, W) at the bars above; F sums to zero."""
    np.testing.assert_allclose(float(got[0]) + e_offset, float(want[0]),
                               rtol=E_RTOL)
    f = got[1].numpy()
    np.testing.assert_allclose(f, np.asarray(want[1]), rtol=0, atol=F_ATOL)
    w = np.asarray(want[2])
    assert np.max(np.abs(got[2].numpy() - w)) <= W_RTOL * np.max(np.abs(w))
    assert np.max(np.abs(f.sum(0))) <= SUM_F_REL * n * np.max(np.abs(f))


def _widest(idx, n):
    return int((idx < n).sum(1).max())


@pytest.fixture(scope="module")
def fe():
    pot = reduced_potential(cut=FE_RC)
    x, box = perturbed_bcc(8, seed=7, disp=0.1)
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64)
    xj, bj = jnp.asarray(x), jnp.asarray(box)
    jn = jax_n2(xj, bj, FE_RC + FE_SKIN, kernels.MAX_K, with_rev=True)
    assert not bool(jn.overflow)
    idx = torch.as_tensor(np.array(jn.idx)).long()
    assert kernels.MAX_K // 2 < _widest(idx, len(x)) <= kernels.MAX_K
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    # the JAX chunked autodiff on the skin rows: shift-free E, F, W
    want = jannp.energy_forces_virial_chunked(jcfg, jparams, xj, bj, jn.idx,
                                              shift=False)
    return types.SimpleNamespace(x=t64(x), box=t64(box), xj=xj, bj=bj,
                                 jidx=jn.idx, idx=idx, jcfg=jcfg,
                                 jparams=jparams, cfg=cfg, params=params,
                                 want=want)


@pytest.mark.parametrize("angular", ["harmonic", "matrix"])
def test_fused_annp_wide_short_rows_match_pallas(fe, angular):
    """FusedAnnp(k_short=384) on short rows of ~360 partners: the same
    rows as PallasAnnp's, the same E, F, W as its evaluation and as the
    JAX autodiff on the skin rows."""
    ev = fa.FusedAnnp(fe.cfg, fe.params, k_short=FE_KS, short_delta=FE_DELTA,
                      angular=angular)
    sl = ev.compact_short(fe.x, fe.box, fe.idx)
    n = len(fe.x)
    assert not bool(sl.overflow)
    assert kernels.MAX_K // 2 < _widest(sl.sidx, n) <= FE_KS
    got = ev.energy_forces_short(fe.x, fe.box, sl)
    pk = PallasAnnp(fe.jcfg, fe.jparams, k_short=FE_KS,
                    short_delta=FE_DELTA, angular=angular)
    jsl = pk.compact_short(fe.xj, fe.bj, fe.jidx, None)
    np.testing.assert_array_equal(sl.sidx.numpy(),
                                  np.asarray(jsl.sidx)[:n])
    want = pk.energy_forces_short(fe.xj, fe.bj, jsl, want_virial=True,
                                  shift=False)
    _check(got, want, n)
    _check(got, fe.want, n)


def test_chunked_functions_take_wide_fe_rows(fe):
    """The chunked functions (run.py's route) evaluate the 512-wide skin
    rows as they are, no compaction, as the JAX functions do."""
    n = len(fe.x)
    got = annp.energy_forces_virial_chunked(fe.cfg, fe.params, fe.x, fe.box,
                                            fe.idx, shift=False)
    _check(got, fe.want, n)
    e, f = annp.energy_forces_chunked(fe.cfg, fe.params, fe.x, fe.box,
                                      fe.idx, shift=False)
    assert float(e) == float(got[0]) and torch.equal(f, got[1])


def test_frame_evaluation_takes_wide_fe_rows(fe):
    """energy_forces_virial_frame on one frame that is the whole periodic
    box (every row a local centre row), its 512-wide rows evaluated as
    they are: per-atom energies, forces and W against the JAX frame
    function, and E, F, W against the full-box evaluation."""
    n = len(fe.x)
    eat, f, w = annp.energy_forces_virial_frame(
        fe.cfg, fe.params, fe.x, fe.box, fe.idx, 0, (0, n))
    eat_j, f_j, w_j = jannp.energy_forces_virial_frame(
        fe.jcfg, fe.jparams, fe.xj, fe.bj, fe.jidx, 0, (0, n), chunk=128)
    np.testing.assert_allclose(eat.numpy() + fe.cfg.e_shift,
                               np.asarray(eat_j), rtol=E_RTOL)
    _check((eat.sum(), f, w), (np.sum(np.asarray(eat_j)) - n * fe.cfg.e_shift,
                               f_j, w_j), n)
    _check((eat.sum(), f, w), fe.want, n)


@pytest.fixture(scope="module")
def ni():
    pot = synthetic_ni_potential(0, npsf=2, nnod=6,
                                 rc_bohr=NI_RC * CFLENGTH, ang=NI_REDUCED_ANG)
    x, box = thermal_fcc(6, seed=3, disp=0.1)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    assert annp.descriptor_cutoff(cfg, params) == pytest.approx(NI_RC)
    nb = build_neighbors_n2(t64(x), t64(box), NI_RC + NI_DELTA, NI_KS)
    assert not bool(nb.overflow)
    assert kernels.NI_MAX_K // 2 < _widest(nb.idx, len(x))
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64)
    want = jannp.energy_forces_virial_chunked(
        jcfg, jparams, jnp.asarray(x), jnp.asarray(box),
        jnp.asarray(nb.idx.numpy()), chunk=32, shift=False)
    return types.SimpleNamespace(x=t64(x), box=t64(box), idx=nb.idx,
                                 cfg=cfg, params=params, want=want)


def test_fused_ni_wide_short_rows_match_jax(ni):
    """FusedNi(k_short=352) on short rows of ~330 partners against the JAX
    chunked functions."""
    ev = fn.FusedNi(ni.cfg, ni.params, k_short=NI_KS, short_delta=NI_DELTA)
    sl = ev.compact_short(ni.x, ni.box, ni.idx)
    n = len(ni.x)
    assert not bool(sl.overflow)
    assert kernels.NI_MAX_K // 2 < _widest(sl.sidx, n) <= NI_KS
    _check(ev.energy_forces_short(ni.x, ni.box, sl), ni.want, n)


def test_chunked_functions_take_wide_ni_rows(ni):
    """The chunked BP functions on the 352-wide rows, as they are."""
    got = annp.energy_forces_virial_chunked(ni.cfg, ni.params, ni.x, ni.box,
                                            ni.idx, shift=False)
    _check(got, ni.want, len(ni.x))


def _anna_case(capacity):
    pot = synthetic_anna_potential(0, **ANNA_REDUCED)
    x, box = perturbed_bcc(3, seed=7, disp=0.08)
    cfg, params = A.make_anna(pot, torch.float64, "cpu")
    jcfg, jparams = JA.make_anna(pot, dtype=jnp.float64)
    nb = build_neighbors_n2(t64(x), t64(box), cfg.cut, capacity)
    assert not bool(nb.overflow)
    return (types.SimpleNamespace(cfg=cfg, p=params, x=t64(x), box=t64(box),
                                  nb=nb),
            types.SimpleNamespace(cfg=jcfg, p=jparams, x=jnp.asarray(x),
                                  box=jnp.asarray(box),
                                  idx=jnp.asarray(nb.idx.numpy()
                                                  .astype(np.int32))))


def _anna_close(got, want):
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=A_RTOL)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=A_F_RTOL, atol=A_F_ATOL)
    np.testing.assert_allclose(np.asarray(got[2]), np.asarray(want[2]),
                               rtol=A_W_RTOL, atol=A_W_ATOL)


def test_anna_fast_fns_take_wide_rows():
    """make_anna_fast_fns(k_short=320): the same rows padded to 320 lanes,
    and the same E, F, W as at k_short 72 and as the JAX fast path."""
    t, j = _anna_case(96)
    fns = {ks: A.make_anna_fast_fns(t.cfg, t.p, k_short=ks, delta=0.3)
           for ks in (72, 320)}
    shorts = {ks: f[2](t.x, t.box, t.nb) for ks, f in fns.items()}
    assert shorts[320].idx.shape[1] == 320
    np.testing.assert_array_equal(shorts[320].idx[:, :72].numpy(),
                                  shorts[72].idx.numpy())
    assert bool((shorts[320].idx[:, 72:] == len(t.x)).all())
    got = fns[320][0](t.x, t.box, t.nb, shorts[320])
    _anna_close(got, fns[72][0](t.x, t.box, t.nb, shorts[72]))
    jfns = JA.make_anna_fast_fns(j.cfg, j.p, k_short=72, delta=0.3)
    nbj = types.SimpleNamespace(idx=j.idx)
    _anna_close(got, jfns[0](j.x, j.box, nbj, jfns[2](j.x, j.box, nbj)))


def test_anna_reference_functions_take_wide_rows():
    """local_params and energy_forces_virial on a 320-wide skin list go
    straight to g_harm (no compaction) and match the JAX functions on the
    same list."""
    t, j = _anna_case(320)
    assert kernels.MAX_K // 2 < t.nb.idx.shape[1] <= kernels.MAX_K
    got = A.local_params(t.cfg, t.p, t.x, t.box, t.nb.idx)
    want = JA.local_params(j.cfg, j.p, j.x, j.box, j.idx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=A_RTOL)
    _anna_close(A.energy_forces_virial(t.cfg, t.p, t.x, t.box, t.nb.idx),
                JA.energy_forces_virial(j.cfg, j.p, j.x, j.box, j.idx))
