"""The port's chunked function API (models/annp.py) against the JAX
package's: `compact_neighbor_rows`, `energy_chunked`,
`energy_forces_chunked`, `energy_forces_virial_chunked` and
`make_short_chunked_fns`, on a Chebyshev (fe) and a BP (ni) potential at
reduced width. The port's functions run the fused evaluators (their
kernels' plain versions on these CPU tensors); the JAX functions
differentiate chunked energies.

Tolerances (f64), as tests/test_torch_ni_ops.py: energy rtol 1e-10, forces
atol 1e-9 eV/A, virial within 1e-9 of max |W|; index tables exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu.models import annp as jannp
from meng_zhang_tpu.system.neighbors import build_neighbors_n2 as jax_n2
from meng_zhang_tpu_torch.models import annp
from meng_zhang_tpu_torch.ops import kernels
from meng_zhang_tpu_torch.system.neighbors import (NeighborList,
                                                   build_neighbors_n2)
from meng_zhang_tpu_torch.testing import thermal_fcc
from torch_port_util import (perturbed_bcc, reduced_ni_potential,
                             reduced_potential, t64)

E_RTOL, F_ATOL, W_RTOL = 1e-10, 1e-9, 1e-9
PBC = (True, False, True)


def _scene(kind):
    if kind == "fe":
        x, box = perturbed_bcc((4, 5, 4), seed=4, disp=0.1)
        return x, box, reduced_potential(cut=4.0), 0.9
    x, box = thermal_fcc((3, 4, 3), seed=4, disp=0.1)
    return x[1:], box, reduced_ni_potential(), 0.9


@pytest.fixture(scope="module", params=["fe", "ni"])
def case(request):
    kind = request.param
    x, box, pot, skin = _scene(kind)
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64, pbc=PBC)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu", pbc=PBC)
    rc = annp.descriptor_cutoff(cfg, params)
    xj, bj = jnp.asarray(x), jnp.asarray(box)
    jn = jax_n2(xj, bj, rc + skin, 64, pbc=PBC)
    assert not bool(jn.overflow)
    return dict(kind=kind, x=x, box=box, xj=xj, bj=bj, jcfg=jcfg,
                jparams=jparams, cfg=cfg, params=params, rc=rc,
                jidx=jn.idx, idx=torch.as_tensor(np.array(jn.idx)).long())


def _check(got, want):
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=E_RTOL)
    if len(want) > 1:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=0, atol=F_ATOL)
    if len(want) > 2:
        w = np.asarray(want[2])
        assert np.max(np.abs(got[2].numpy() - w)) <= \
            W_RTOL * np.max(np.abs(w))


@pytest.mark.parametrize("k_short", [32, 8], ids=["fits", "overflows"])
def test_compact_neighbor_rows_matches_jax(case, k_short):
    c = case
    jidx, jovf = jannp.compact_neighbor_rows(c["xj"], c["bj"], c["jidx"],
                                             c["rc"], k_short, PBC,
                                             row_chunk=32)
    idx, ovf = annp.compact_neighbor_rows(t64(c["x"]), t64(c["box"]),
                                          c["idx"], c["rc"], k_short, PBC,
                                          row_chunk=32)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert bool(ovf) == bool(jovf) == (k_short == 8)


@pytest.mark.parametrize("shift", [True, False])
@pytest.mark.parametrize("rows", ["skin", "short"])
def test_chunked_functions_match_jax(case, shift, rows):
    """The three chunked functions, on the skin list as it is and on rows
    repacked at the descriptor cutoff."""
    c = case
    jidx, idx = c["jidx"], c["idx"]
    if rows == "short":
        jidx, _ = jannp.compact_neighbor_rows(c["xj"], c["bj"], jidx,
                                              c["rc"], 32, PBC)
        idx, _ = annp.compact_neighbor_rows(t64(c["x"]), t64(c["box"]), idx,
                                            c["rc"], 32, PBC)
    args = (t64(c["x"]), t64(c["box"]), idx)
    jargs = (c["xj"], c["bj"], jidx)
    _check((annp.energy_chunked(c["cfg"], c["params"], *args, shift=shift),),
           (jannp.energy_chunked(c["jcfg"], c["jparams"], *jargs,
                                 shift=shift),))
    _check(annp.energy_forces_chunked(c["cfg"], c["params"], *args,
                                      shift=shift),
           jannp.energy_forces_chunked(c["jcfg"], c["jparams"], *jargs,
                                       shift=shift))
    _check(annp.energy_forces_virial_chunked(c["cfg"], c["params"], *args,
                                             chunk=512, shift=shift),
           jannp.energy_forces_virial_chunked(c["jcfg"], c["jparams"],
                                              *jargs, chunk=512,
                                              shift=shift))


def test_make_short_chunked_fns_matches_jax(case):
    """The Simulator trio: short rows at rc + delta, the full and the light
    force function, and NaN poisoning on short-row overflow."""
    c = case
    x, box = t64(c["x"]), t64(c["box"])
    jnb = jax_n2(c["xj"], c["bj"], c["rc"] + 0.9, 64, pbc=PBC)
    nb = NeighborList(c["idx"], torch.tensor(False), x)
    for k_short, poisoned in ((32, False), (8, True)):
        jf, jfl, jsb = jannp.make_short_chunked_fns(
            c["jcfg"], c["jparams"], k_short=k_short, delta=0.3)
        f, fl, sb = annp.make_short_chunked_fns(
            c["cfg"], c["params"], k_short=k_short, delta=0.3)
        jsh, sh = jsb(c["xj"], c["bj"], jnb), sb(x, box, nb)
        np.testing.assert_array_equal(sh.idx.numpy(), np.asarray(jsh.idx))
        assert bool(sh.overflow) == bool(jsh.overflow) == poisoned
        got, want = f(x, box, nb, sh), jf(c["xj"], c["bj"], jnb, jsh)
        light = fl(x, box, nb, sh)
        if poisoned:
            assert torch.isnan(got[0]) and torch.isnan(got[1]).all()
            assert np.isnan(np.asarray(want[1])).all()
            assert torch.isnan(light[1]).all()
            continue
        _check(got, want)
        _check(light[:2], jfl(c["xj"], c["bj"], jnb, jsh)[:2])
        assert torch.equal(light[2], torch.zeros(3, 3, dtype=x.dtype))


def test_evaluator_built_once(case):
    c = case
    ev = annp.fused_evaluator(c["cfg"], c["params"])
    assert annp.fused_evaluator(c["cfg"], c["params"]) is ev
    assert ev.k_short == (kernels.MAX_K if c["kind"] == "fe"
                          else kernels.NI_MAX_K)
    other = dict(c["params"])
    assert annp.fused_evaluator(c["cfg"], other) is not ev
    # the strain argument is ported (tests/test_torch_names.py holds it
    # against JAX): a zero strain gives the unstrained energy
    e_eps = annp.energy_chunked(c["cfg"], c["params"], t64(c["x"]),
                                t64(c["box"]), c["idx"],
                                eps=torch.zeros(3, 3, dtype=torch.float64))
    e = annp.energy_chunked(c["cfg"], c["params"], t64(c["x"]),
                            t64(c["box"]), c["idx"])
    np.testing.assert_allclose(float(e_eps), float(e), rtol=1e-14)


def test_bp_rows_of_any_width_match_jax():
    """A compressed fcc box puts 42 partners inside the descriptor cutoff,
    more than one warp's 32 lanes: the BP functions evaluate those rows as
    the JAX functions do. A box compressed further puts ~290 inside it,
    past the 256 slots the ni kernels took before NI_MAX_K = 512: those rows
    evaluate too. A 5 x 5 x 6-cell box compressed further still puts ~550
    inside it, more than NI_MAX_K: the BP functions compact the 600-wide
    skin rows to whole tiles of kernels.NI_TILE and evaluate them through
    the cross-tile kernels (their plain twins here), as the JAX functions
    evaluate the same rows compacted at the cutoff; a skin list wider than
    NI_MAX_K whose rows fit after compaction evaluates exactly."""
    pot = reduced_ni_potential()
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu")
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64)
    rc = annp.descriptor_cutoff(cfg, params)
    x, box = thermal_fcc(4, seed=1, disp=0.02)
    dense = (t64(x * 0.6), t64(box * 0.6))
    nb = build_neighbors_n2(*dense, rc + 0.5, 96)
    assert not bool(nb.overflow)
    assert 32 < int((nb.idx < len(x)).sum(1).max()) <= kernels.NI_MAX_K
    _check(annp.energy_forces_virial_chunked(cfg, params, *dense, nb.idx),
           jannp.energy_forces_virial_chunked(
               jcfg, jparams, jnp.asarray(x * 0.6), jnp.asarray(box * 0.6),
               jnp.asarray(nb.idx.numpy())))
    xd, bd = thermal_fcc(6, seed=1, disp=0.02)
    denser = (t64(xd * 0.32), t64(bd * 0.32))      # box 6.76 A > 2 rc
    nb = build_neighbors_n2(*denser, rc + 0.5, 640)
    assert not bool(nb.overflow)
    assert nb.idx.shape[1] > kernels.NI_MAX_K
    idx_s, ovf = annp.compact_neighbor_rows(*denser, nb.idx, rc, 320)
    assert not bool(ovf)
    assert 256 < int((idx_s < len(xd)).sum(1).max()) <= kernels.NI_MAX_K
    _check(annp.energy_forces_virial_chunked(cfg, params, *denser, idx_s),
           jannp.energy_forces_virial_chunked(
               jcfg, jparams, jnp.asarray(xd * 0.32), jnp.asarray(bd * 0.32),
               jnp.asarray(idx_s.numpy())))
    xd, bd = thermal_fcc((5, 5, 6), seed=1, disp=0.02)
    densest = (t64(xd * 0.23), t64(bd * 0.23))     # 600 atoms
    nb = build_neighbors_n2(*densest, rc + 0.5, len(xd))
    assert not bool(nb.overflow)
    idx_s, ovf = annp.compact_neighbor_rows(*densest, nb.idx, rc, 640)
    assert not bool(ovf)
    assert int((idx_s < len(xd)).sum(1).max()) > kernels.NI_MAX_K
    _check(annp.energy_forces_virial_chunked(cfg, params, *densest, nb.idx),
           jannp.energy_forces_virial_chunked(
               jcfg, jparams, jnp.asarray(xd * 0.23), jnp.asarray(bd * 0.23),
               jnp.asarray(idx_s.numpy()), chunk=16))
    # an unstrained box: 12 partners a row, the 552-wide list is compacted
    # (the JAX functions evaluate the same rows compacted to 32)
    x, box = (t64(a) for a in thermal_fcc(3, seed=1, disp=0.02))
    wide = build_neighbors_n2(x, box, rc + 2.0, kernels.NI_MAX_K + 40)
    assert wide.idx.shape[1] > kernels.NI_MAX_K
    want = jannp.energy_forces_virial_chunked(
        jcfg, jparams, jnp.asarray(x.numpy()), jnp.asarray(box.numpy()),
        jnp.asarray(annp.compact_neighbor_rows(
            x, box, wide.idx, rc, 32)[0].numpy()), chunk=32)
    _check(annp.energy_forces_virial_chunked(cfg, params, x, box, wide.idx),
           want)
