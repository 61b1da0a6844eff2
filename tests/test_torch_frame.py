"""The device-frame evaluations of the sharded drivers: the port against the
JAX package on the same numpy frame, all in f64 on the CPU (Pallas in
interpret mode at the reduced widths), and the frames' local rows against
the full-box evaluation.

A frame is cut from a periodic slab scene as the 1-D driver cuts it
(parallel/domain.py): atoms sorted by x, shard d's C rows with B = 2 bc halo
rows on each side (x unwrapped across the periodic seam), its skin list
built over the frame with x non-periodic, and the cc = C + 2 bc centre rows
at frame rows [off, off + cc), off = B - bc; the local rows are centre rows
[bc, bc + C).

  * `compact_short_frame` (FusedAnnp, FusedNi) against
    `PairTableOps.compact_short_frame`: sidx equal, overflow equal, also on
    a row overflow and on a skin list that lost one pair (the JAX band
    check);
  * `energy_forces_frame_short` against the JAX function on both fe
    angular paths and ni: energies of every centre row and W to rtol
    1e-10, forces of the local rows to 1e-10 of max |F|. Frame-edge rows
    differ by design: the JAX delivery band gives a row its own halo
    lanes' Fj back, the port keeps them in the row's -sum Fj (both are
    discarded by the drivers). The total force on the centre rows equals
    minus the Fj of the lanes whose partner is a halo row, which holds
    only if such lanes deliver nothing;
  * `energy_forces_frame` (full skin width) against the JAX function with
    its reverse slots, every centre row;
  * `models.annp.energy_forces_virial_frame` against the JAX autodiff, fe
    (also through k_short) and ni, every centre row;
  * ANNA-ADP: `_frame_planes`, `energy_forces_frame_fast` and
    `energy_forces_frame` against the JAX functions;
  * every family's local rows against the full-box evaluation (F to 1e-10
    of max |F|, per-atom energies to rtol 1e-10), and the batched form of
    D frames against the frames one by one.
"""
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu.models import anna_adp as JA
from meng_zhang_tpu.models import annp as jannp
from meng_zhang_tpu.ops.pallas_annp import PallasAnnp
from meng_zhang_tpu.ops.pallas_ni import PallasNi
from meng_zhang_tpu.system.neighbors import build_neighbors_n2 as jax_n2
from meng_zhang_tpu.system.neighbors import reverse_slots
from meng_zhang_tpu_torch.models import anna_adp as A
from meng_zhang_tpu_torch.models import annp
from meng_zhang_tpu_torch.ops import frames
from meng_zhang_tpu_torch.ops import fused_annp as fa
from meng_zhang_tpu_torch.ops import fused_ni as fn
from meng_zhang_tpu_torch.system.neighbors import build_neighbors_n2
from meng_zhang_tpu_torch.testing import synthetic_anna_potential, thermal_fcc
from torch_port_util import (perturbed_bcc, reduced_ni_potential,
                             reduced_potential, rel_max, t64)

RTOL = 1e-10
N_DEV, SKIN = 4, 0.5
FPBC = (False, True, True)        # a frame is x-contiguous (unwrapped)


def make_frame(x, box, rlist, cap, bc, d=1, n_dev=N_DEV):
    """Shard d's frame of the periodic scene x, as numpy and torch."""
    n = len(x)
    c = n // n_dev
    b = 2 * bc
    order = np.argsort(x[:, 0], kind="stable")
    ids = np.arange(d * c - b, d * c + c + b)
    x_ext = x[order][ids % n].copy()
    x_ext[ids < 0, 0] -= box[0]
    x_ext[ids >= n, 0] += box[0]
    nl = jax_n2(jnp.asarray(x_ext), jnp.asarray(box), rlist, cap,
                with_rev=True, pbc=FPBC)
    assert not bool(nl.overflow)
    off, cc = b - bc, c + 2 * bc
    idx = np.array(nl.idx)[off:off + cc]
    # every local row's partners are centre rows (the coverage proof)
    loc = idx[bc:bc + c]
    t = loc - off
    assert np.all((loc == len(x_ext)) | ((t >= 0) & (t < cc)))
    return types.SimpleNamespace(
        x_ext=x_ext, idx=idx, rev=np.asarray(reverse_slots(nl))[off:off + cc],
        off=off, cc=cc, c=c, bc=bc, vslice=(bc, bc + c),
        gid=order[ids[off:off + cc] % n], box=box,
        tx=t64(x_ext), tidx=torch.as_tensor(idx).long(), tbox=t64(box),
        jx=jnp.asarray(x_ext), jidx=jnp.asarray(idx), jbox=jnp.asarray(box))


def _fe_scene(seed=3):
    x, box = perturbed_bcc((16, 4, 4), seed=seed, disp=0.06)   # 512 atoms
    return x, box, reduced_potential(cut=4.0)


def _ni_scene(seed=3):
    x, box = thermal_fcc((16, 4, 4), seed=seed, disp=0.05)     # 1024 atoms
    return x, box, reduced_ni_potential()


@functools.cache
def _case(kind):
    """(kind, frame, port cfg/params, jax cfg/params, full-box reference
    eatom and F of the scene)."""
    x, box, pot = _fe_scene() if kind == "fe" else _ni_scene()
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    rc = annp.descriptor_cutoff(cfg, params)
    # ~11.2 (bcc) and ~18.2 (fcc) atoms an A of x: bc spans rlist
    fr = make_frame(x, box, rc + SKIN, 64, 56 if kind == "fe" else 72)
    nb = build_neighbors_n2(t64(x), t64(box), rc + SKIN, 64)
    ev = (fa.FusedAnnp(cfg, params, k_short=32, short_delta=0.4)
          if kind == "fe" else fn.FusedNi(cfg, params, k_short=32,
                                          short_delta=0.4))
    e, f, w, eatom, _ = ev.energy_forces(t64(x), t64(box), nb.idx,
                                         per_atom=True)
    return types.SimpleNamespace(kind=kind, fr=fr, cfg=cfg, params=params,
                                 jcfg=jcfg, jparams=jparams,
                                 f_full=f.numpy(), eatom=eatom.numpy())


@pytest.fixture(params=["fe", "ni"])
def case(request):
    return _case(request.param)


def _jax_ev(c, angular="harmonic", k_short=32):
    if c.kind == "fe":
        return PallasAnnp(c.jcfg, c.jparams, k_short=k_short,
                          short_delta=0.4, angular=angular)
    return PallasNi(c.jcfg, c.jparams, k_short=k_short, short_delta=0.4)


def _port_ev(c, angular="harmonic", k_short=32):
    if c.kind == "fe":
        return fa.FusedAnnp(c.cfg, c.params, k_short=k_short,
                            short_delta=0.4, angular=angular)
    return fn.FusedNi(c.cfg, c.params, k_short=k_short, short_delta=0.4)


def _local_vs_full(c, eat, f):
    """The local rows against the full-box evaluation."""
    fr = c.fr
    lo, hi = fr.vslice
    g = fr.gid[lo:hi]
    assert rel_max(f[lo:hi], c.f_full[g]) <= RTOL
    np.testing.assert_allclose(np.asarray(eat[lo:hi]) + c.cfg.e_shift,
                               c.eatom[g], rtol=RTOL)


@pytest.mark.parametrize("variant", ["plain", "row-overflow", "lost-pair"])
def test_compact_short_frame_matches_jax(case, variant):
    c, fr = case, case.fr
    # bcc keeps 26 partners within rc + 0.4 = 4.4 A, fcc 12 within 3.3 A
    ks = 32 if variant != "row-overflow" else 16 if c.kind == "fe" else 8
    idx = fr.idx.copy()
    if variant == "lost-pair":
        # a centre row forgets its first partner (another centre row)
        row = fr.bc + 5
        assert fr.off <= idx[row, 0] < fr.off + fr.cc
        idx[row] = np.concatenate([idx[row, 1:], [len(fr.x_ext)]])
    sidx_j, _, ovf_j = _jax_ev(c, k_short=ks).compact_short_frame(
        fr.jx, fr.jbox, jnp.asarray(idx), fr.off, fr.cc)
    sidx, ovf = _port_ev(c, k_short=ks).compact_short_frame(
        fr.tx, fr.tbox, torch.as_tensor(idx).long(), fr.off, fr.cc)
    np.testing.assert_array_equal(sidx.numpy(), np.asarray(sidx_j)[:fr.cc])
    assert bool(ovf) == bool(ovf_j) == (variant != "plain")


def _halo_lane_total(ev, fr, sidx):
    """-sum of Fj over the lanes whose partner is a halo row, and whether
    such lanes exist with nonzero Fj."""
    m = len(fr.x_ext)
    sidx_f, ctr = frames.frame_tables(sidx[None], m, fr.off, fr.cc)
    dd = frames.frame_planes(fr.tx[fr.off:fr.off + fr.cc][None], fr.tx[None],
                         fr.tbox, sidx_f, ev.pbc)
    fj = ev._eval_fj(*dd, None)[1]
    halo = ((ctr < 0) & (sidx_f < m)).double()
    tot = torch.stack([-(f * halo).sum() for f in fj])
    return tot.numpy(), float(sum((f.abs() * halo).sum() for f in fj))


@pytest.mark.parametrize("kind,angular", [("fe", "harmonic"),
                                          ("fe", "matrix"),
                                          ("ni", "harmonic")])
def test_frame_short_matches_jax(kind, angular):
    c = _case(kind)
    fr = c.fr
    jev = _jax_ev(c, angular)
    sidx_j, akey_j, ovf_j = jev.compact_short_frame(fr.jx, fr.jbox, fr.jidx,
                                                    fr.off, fr.cc)
    p = sidx_j.shape[0]
    xc_pad = jnp.concatenate([fr.jx[fr.off:fr.off + fr.cc],
                              jnp.zeros((p - fr.cc, 3))])
    eat_j, f_j, w_j = jev.energy_forces_frame_short(
        xc_pad, fr.jx, fr.jbox, sidx_j, akey_j, fr.cc, want_virial=True,
        vslice=fr.vslice)
    ev = _port_ev(c, angular)
    sidx, ovf = ev.compact_short_frame(fr.tx, fr.tbox, fr.tidx, fr.off,
                                       fr.cc)
    assert not bool(ovf) and not bool(ovf_j)
    xc = fr.tx[fr.off:fr.off + fr.cc]
    eat, f, w = ev.energy_forces_frame_short(xc, fr.tx, fr.tbox, sidx, fr.cc,
                                             want_virial=True,
                                             vslice=fr.vslice, off=fr.off)
    np.testing.assert_allclose(eat.numpy() + c.cfg.e_shift,
                               np.asarray(eat_j), rtol=RTOL)
    lo, hi = fr.vslice
    assert rel_max(f[lo:hi], np.asarray(f_j)[lo:hi]) <= RTOL
    assert rel_max(w, w_j) <= RTOL
    _local_vs_full(c, eat, f.numpy())
    # halo lanes deliver nothing: what the centre rows' forces sum to
    want, size = _halo_lane_total(ev, fr, sidx)
    assert size > 0.0
    np.testing.assert_allclose(f.sum(0).numpy(), want, rtol=0,
                               atol=RTOL * size)


@pytest.mark.parametrize("angular", ["harmonic", "matrix"])
def test_energy_forces_frame_matches_jax(angular):
    x, box, pot = _fe_scene()
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    fr = make_frame(x, box, cfg.cut + SKIN, 48, 56)
    eat_j, f_j, w_j = PallasAnnp(jcfg, jparams, angular=angular) \
        .energy_forces_frame(fr.jx[fr.off:fr.off + fr.cc], fr.jx, fr.jbox,
                             fr.jidx, jnp.asarray(fr.rev), fr.off,
                             want_virial=True, vslice=fr.vslice)
    eat, f, w = fa.FusedAnnp(cfg, params, angular=angular) \
        .energy_forces_frame(fr.tx[fr.off:fr.off + fr.cc], fr.tx, fr.tbox,
                             fr.tidx, fr.off, want_virial=True,
                             vslice=fr.vslice)
    np.testing.assert_allclose(eat.numpy() + cfg.e_shift, np.asarray(eat_j),
                               rtol=RTOL)
    assert rel_max(f, f_j) <= RTOL
    assert rel_max(w, w_j) <= RTOL


@pytest.mark.parametrize("k_short", [None, 24])
def test_annp_frame_matches_jax(case, k_short):
    c, fr = case, case.fr
    if c.kind == "ni" and k_short is not None:
        k_short = 16
    eat_j, f_j, w_j = jannp.energy_forces_virial_frame(
        c.jcfg, c.jparams, fr.jx, fr.jbox, fr.jidx, fr.off, fr.vslice,
        chunk=64, k_short=k_short)
    eat, f, w = annp.energy_forces_virial_frame(
        c.cfg, c.params, fr.tx, fr.tbox, fr.tidx, fr.off, fr.vslice,
        k_short=k_short)
    np.testing.assert_allclose(eat.numpy() + c.cfg.e_shift,
                               np.asarray(eat_j), rtol=RTOL)
    assert rel_max(f, f_j) <= RTOL
    assert rel_max(w, w_j) <= RTOL
    _local_vs_full(c, eat, f.numpy())


def test_annp_frame_poisons_on_k_short_overflow(case):
    c, fr = case, case.fr
    eat, f, w = annp.energy_forces_virial_frame(
        c.cfg, c.params, fr.tx, fr.tbox, fr.tidx, fr.off, fr.vslice,
        k_short=4)
    eat_j, f_j, _ = jannp.energy_forces_virial_frame(
        c.jcfg, c.jparams, fr.jx, fr.jbox, fr.jidx, fr.off, fr.vslice,
        chunk=64, k_short=4)
    assert np.isnan(np.asarray(f_j)).all() and torch.isnan(f).all()
    assert torch.isnan(eat).all()


def test_batched_frames_equal_single_frames(case):
    """The [D, ...] form over every shard's frame equals the frames one
    by one, and W adds up over them."""
    c = case
    x, box, _ = _fe_scene() if c.kind == "fe" else _ni_scene()
    rc = annp.descriptor_cutoff(c.cfg, c.params)
    bc = c.fr.bc
    frs = [make_frame(x, box, rc + SKIN, 64, bc, d=d) for d in range(N_DEV)]
    ev = _port_ev(c)
    x_src = torch.stack([fr.tx for fr in frs])
    idx = torch.stack([fr.tidx for fr in frs])
    off, cc = frs[0].off, frs[0].cc
    sidx, ovf = ev.compact_short_frames(x_src, c.fr.tbox, idx, off, cc)
    eat, f, w = ev.energy_forces_frames_short(
        x_src[:, off:off + cc], x_src, c.fr.tbox, sidx, cc, True,
        c.fr.vslice)
    w_sum = 0.0
    for d, fr in enumerate(frs):
        s1, o1 = ev.compact_short_frame(fr.tx, fr.tbox, fr.tidx, off, cc)
        assert torch.equal(s1, sidx[d]) and bool(o1) == bool(ovf[d])
        e1, f1, w1 = ev.energy_forces_frame_short(
            fr.tx[off:off + cc], fr.tx, fr.tbox, s1, cc, True, fr.vslice)
        np.testing.assert_allclose(eat[d].numpy(), e1.numpy(), rtol=1e-13)
        assert rel_max(f[d], f1) <= 1e-13
        w_sum = w_sum + w1
    assert rel_max(w, w_sum) <= 1e-12
    # the shards' local rows make up the whole box
    lo, hi = c.fr.vslice
    gids = np.concatenate([fr.gid[lo:hi] for fr in frs])
    f_loc = f[:, lo:hi].reshape(-1, 3).numpy()
    assert sorted(gids) == list(range(len(x)))
    assert rel_max(f_loc, c.f_full[gids]) <= RTOL


# --------------------------------------------------------------- ANNA-ADP
@pytest.fixture(scope="module")
def anna():
    x, box = perturbed_bcc((16, 4, 4), seed=5, disp=0.06)      # 512 atoms
    pot = synthetic_anna_potential(0, npsf=4, ntsf=5, nnod=6)
    cfg, params = A.make_anna(pot, torch.float64, "cpu")
    jcfg, jparams = JA.make_anna(pot, dtype=jnp.float64)
    # rlist 5.555 A at 11.2 atoms an A of x: bc 64, B 128 = C
    fr = make_frame(x, box, cfg.cut + SKIN, 80, 64)
    nb = build_neighbors_n2(t64(x), t64(box), cfg.cut, 80)
    e, f, w = A.energy_forces_virial(cfg, params, t64(x), t64(box), nb.idx)
    eatom = A.atom_energies(cfg, params, t64(x), t64(box), nb.idx)
    return types.SimpleNamespace(cfg=cfg, params=params, jcfg=jcfg,
                                 jparams=jparams, fr=fr, f_full=f.numpy(),
                                 eatom=eatom.numpy())


def test_anna_frame_planes_match_jax(anna):
    fr = anna.fr
    want = JA._frame_planes(fr.jx[fr.off:fr.off + fr.cc], fr.jx, fr.jbox,
                            fr.jidx, (True,) * 3)
    got = A._frame_planes(fr.tx[fr.off:fr.off + fr.cc], fr.tx, fr.tbox,
                          fr.tidx, (True,) * 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:fr.cc])


@pytest.mark.parametrize("fast", [True, False])
def test_anna_frame_matches_jax(anna, fast):
    fr, a = anna.fr, anna
    xc_j = fr.jx[fr.off:fr.off + fr.cc]
    xc = fr.tx[fr.off:fr.off + fr.cc]
    if fast:
        e_j, f_j, w_j = JA.energy_forces_frame_fast(
            a.jcfg, a.jparams, xc_j, fr.jx, fr.jbox, fr.jidx, fr.off,
            fr.vslice, want_virial=True)
        e, f, w = A.energy_forces_frame_fast(a.cfg, a.params, xc, fr.tx,
                                             fr.tbox, fr.tidx, fr.off,
                                             fr.vslice, want_virial=True)
    else:
        e_j, f_j, w_j = JA.energy_forces_frame(
            a.jcfg, a.jparams, xc_j, fr.jx, fr.jbox, fr.jidx, fr.off,
            fr.vslice, want_virial=True)
        e, f, w = A.energy_forces_frame(a.cfg, a.params, xc, fr.tx, fr.tbox,
                                        fr.tidx, fr.off, fr.vslice,
                                        want_virial=True)
    np.testing.assert_allclose(e.numpy() + a.cfg.e_base, np.asarray(e_j),
                               rtol=RTOL)
    assert rel_max(f, f_j) <= RTOL
    assert rel_max(w, w_j) <= RTOL
    lo, hi = fr.vslice
    g = fr.gid[lo:hi]
    assert rel_max(f[lo:hi], a.f_full[g]) <= RTOL
    np.testing.assert_allclose(e[lo:hi].numpy() + a.cfg.e_base, a.eatom[g],
                               rtol=RTOL)
