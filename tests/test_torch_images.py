"""Thin periodic boxes through explicit images: the port against the JAX
package and against its own evaluation of the explicitly replicated box.

  * `image_shift_table` equal to the JAX function's;
  * `build_neighbors_images` against the JAX Simulator's image build (all
    R*N rows over the image-extended table, the first N kept);
  * `energy_forces_virial_images` (the fused evaluator over the
    image-extended partner table) against the JAX function (autodiff
    through x_ext) on the 1 x 4 x 4-cell bcc box of tests/test_md.py
    (`thin_box_pair`), with and without elems, Chebyshev and BP, reduced
    width and the shipped fe width; and against the replicated box: E and
    W are 1/R of the replicated box's, F that of its first copy;
  * a few NVE steps of `Simulator(image_shifts=...)` against the JAX
    Simulator with the same shifts;
  * the thin-box error of `init_state` names this package's functions;
  * FIRE (`fire_relax`) on a thin screw-dislocation cell through the image
    route against FIRE on its z-replicated box from the same start: equal
    iterate counts, positions to 1e-10 A (in exact arithmetic the two are
    the same iteration: FIRE's norms and powers scale with the copies).

Tolerances (f64), as tests/test_torch_chunked.py: energy rtol 1e-10,
forces atol 1e-9 eV/A, virial within 1e-9 of max |W|; neighbor rows
exactly. Trajectories as tests/test_torch_md.py: positions, velocities
and forces atol 1e-9, thermo rtol 1e-9.
"""
import dataclasses
import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu.md import simulation as JS
from meng_zhang_tpu.models import annp as jannp
from meng_zhang_tpu.system.neighbors import build_neighbors_n2 as jax_n2
from meng_zhang_tpu_torch.geometry.lattice import bcc, fcc
from meng_zhang_tpu_torch.geometry.screw import make_screw_dislocation
from meng_zhang_tpu_torch.md.minimize import fire_relax
from meng_zhang_tpu_torch.md import simulation as S
from meng_zhang_tpu_torch.models import annp
from meng_zhang_tpu_torch.system.neighbors import (build_neighbors_images,
                                                   build_neighbors_n2)
from meng_zhang_tpu_torch.testing import synthetic_fe_potential_multi
from meng_zhang_tpu_torch.testing import with_elements
from meng_zhang_tpu_torch.units import MASS_FE
from torch_port_util import reduced_ni_potential, reduced_potential, t64

E_RTOL, F_ATOL, W_RTOL = 1e-10, 1e-9, 1e-9
SKIN = 0.5


def _close(got, want, n_rep=1):
    """(E, F, W) against want, whose E and W are n_rep times as large."""
    e, f, w = (np.asarray(a, dtype=np.float64) for a in got)
    we, wf, ww = (np.asarray(a, dtype=np.float64) for a in want)
    np.testing.assert_allclose(float(e), float(we) / n_rep, rtol=E_RTOL)
    np.testing.assert_allclose(f, wf[:len(f)], rtol=0, atol=F_ATOL)
    assert np.max(np.abs(w - ww / n_rep)) <= W_RTOL * np.max(np.abs(ww)) \
        / n_rep


@pytest.mark.parametrize("box,rlist,pbc", [
    ((2.8553, 11.4212, 11.4212), 7.0, (True, True, True)),
    ((2.8553, 11.4212, 11.4212), 4.5, (True, True, True)),
    ((153.9, 153.4, 2.473), 7.7, (False, False, True)),
    ((20.0, 30.0, 40.0), 7.7, (True, True, True)),
    ((5.0, 3.0, 40.0), 6.0, (True, False, True)),
], ids=["fe-full", "fe-reduced", "screw", "none-thin", "mixed"])
def test_image_shift_table_matches_jax(box, rlist, pbc):
    got, got_pbc = annp.image_shift_table(np.asarray(box), rlist, pbc)
    want, want_pbc = jannp.image_shift_table(np.asarray(box), rlist, pbc)
    assert got_pbc == want_pbc
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)
        assert not got[0].any()


def _thin_scene(kind):
    """(x, box, pot, elems or None) of the thin box of each case: the
    1 x 4 x 4-cell bcc box of tests/test_md.py, or a 1 x 4 x 4-cell fcc
    box for BP."""
    rng = np.random.default_rng(2)
    if kind.startswith("ni"):
        x, box = fcc([1, 4, 4], 3.52)
        pot = with_elements(reduced_ni_potential(), 2)
    else:
        x, box = bcc([1, 4, 4])
        pot = (synthetic_fe_potential_multi(2) if kind == "fe-full"
               else with_elements(reduced_potential(cut=4.0), 2))
    x = x + rng.normal(scale=0.03, size=x.shape)
    el = None if kind == "fe" else rng.integers(0, 2, len(x))
    return x, box, pot, el


@pytest.fixture(scope="module", params=["fe", "fe-2el", "ni-2el",
                                        "fe-full"])
def thin(request):
    """The JAX image build and energy_forces_virial_images, computed
    once per case."""
    x, box, pot, el = _thin_scene(request.param)
    pbc = (True, True, True)
    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64, pbc=pbc)
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu", pbc=pbc)
    rc = annp.descriptor_cutoff(cfg, params)
    shifts, pbc_eff = jannp.image_shift_table(box, rc + SKIN, pbc)
    assert shifts is not None and not pbc_eff[0]
    n = len(x)
    x_ext = (x[None] + (shifts * box)[:, None]).reshape(-1, 3)
    jn = jax_n2(jnp.asarray(x_ext), jnp.asarray(box), rc + SKIN, 192,
                pbc=pbc_eff)
    assert not bool(jn.overflow)
    jidx = jn.idx[:n]
    elj = None if el is None else jnp.asarray(el, jnp.int32)
    want = jannp.energy_forces_virial_images(
        dataclasses.replace(jcfg, pbc=pbc_eff), jparams, jnp.asarray(x),
        jnp.asarray(box), jidx, shifts, elj, chunk=16, shift=False)
    return dict(x=x, box=box, el=el, shifts=shifts, pbc=pbc,
                pbc_eff=pbc_eff, rc=rc, cfg=cfg, params=params,
                cfg_eff=dataclasses.replace(cfg, pbc=pbc_eff),
                jidx=np.asarray(jidx), want=want)


def test_image_build_matches_jax(thin):
    c = thin
    got = build_neighbors_images(t64(c["x"]), t64(c["box"]),
                                 torch.as_tensor(c["shifts"]),
                                 c["rc"] + SKIN, 192, c["pbc_eff"])
    np.testing.assert_array_equal(got.idx.numpy(), c["jidx"])
    assert not bool(got.overflow) and got.ref_x.shape == (len(c["x"]), 3)
    # where the thin edge is shorter than the list's cutoff, the rows list
    # images r*N + i of their own atom
    n = len(c["x"])
    own = (got.idx % n == torch.arange(n)[:, None]) \
        & (got.idx < len(c["shifts"]) * n)
    assert bool(own.any()) == (c["box"][0] < c["rc"] + SKIN)


def _images(c, shifts=None):
    el = None if c["el"] is None else torch.as_tensor(c["el"])
    return annp.energy_forces_virial_images(
        c["cfg_eff"], c["params"], t64(c["x"]), t64(c["box"]),
        torch.as_tensor(c["jidx"]).long(),
        c["shifts"] if shifts is None else shifts, el, shift=False)


def test_images_match_jax(thin):
    _close(_images(thin), thin["want"])
    # the shifts as a tensor: the same numbers
    _close(_images(thin, torch.as_tensor(thin["shifts"])), thin["want"])


def test_images_match_replicated_box(thin):
    """The scene replicated (2m + 1) times along each thin axis, evaluated
    as an ordinary periodic box by the chunked function."""
    c = thin
    reps = 2 * np.max(c["shifts"], axis=0) + 1
    cells = [np.asarray(s) for s in itertools.product(*map(range, reps))]
    x_rep = np.concatenate([c["x"] + s * c["box"] for s in cells])
    box_rep = c["box"] * reps
    nb = build_neighbors_n2(t64(x_rep), t64(box_rep), c["rc"] + SKIN, 192,
                            c["pbc"])
    assert not bool(nb.overflow)
    el = None if c["el"] is None else torch.as_tensor(np.tile(c["el"],
                                                              len(cells)))
    rep = annp.energy_forces_virial_chunked(
        c["cfg"], c["params"], t64(x_rep), t64(box_rep), nb.idx, el,
        shift=False)
    _close(_images(c), rep, n_rep=len(cells))
    if c["el"] is not None:
        blind = annp.energy_forces_virial_images(
            c["cfg_eff"], c["params"], t64(c["x"]), t64(c["box"]),
            torch.as_tensor(c["jidx"]).long(), c["shifts"], shift=False)
        assert not np.allclose(blind[1].numpy(), rep[1][:len(c["x"])],
                               rtol=0, atol=F_ATOL)


def test_simulator_images_match_jax():
    """Two blocks of two NVE steps of both Simulators in image mode, with
    two elements, from the same positions and velocities."""
    x, box, pot, el = _thin_scene("fe-2el")
    n = len(x)
    v = np.random.default_rng(5).normal(scale=3.0, size=(n, 3))
    v -= v.mean(0)
    rc = pot.cut
    shifts, pbc_eff = annp.image_shift_table(box, rc + SKIN, (True,) * 3)
    common = dict(dt=0.001, cutoff=rc, skin=SKIN, capacity=96,
                  nbr_method="n2", ensemble="nve", thermo_every=2,
                  pbc=pbc_eff)

    jcfg, jparams = jannp.make_annp(pot, dtype=jnp.float64, pbc=pbc_eff)
    elj = jnp.asarray(el, jnp.int32)
    jsim = JS.Simulator(
        lambda xx, bb, nb: jannp.energy_forces_virial_images(
            jcfg, jparams, xx, bb, nb.idx, shifts, elj, chunk=16,
            shift=False),
        jnp.full(n, MASS_FE, jnp.float64), JS.MDConfig(**common),
        image_shifts=shifts)
    js = jsim.init_state(jnp.asarray(x), jnp.asarray(box), v=jnp.asarray(v))
    js, jth = jsim.run(js, 2)

    cfg, params = annp.make_annp(pot, torch.float64, device="cpu",
                                 pbc=pbc_eff)
    sh, elt = torch.as_tensor(shifts), torch.as_tensor(el)
    sim = S.Simulator(
        lambda xx, bb, nb: annp.energy_forces_virial_images(
            cfg, params, xx, bb, nb.idx, sh, elt, shift=False),
        torch.full((n,), MASS_FE, dtype=torch.float64),
        S.MDConfig(**common), image_shifts=shifts)
    st = sim.init_state(t64(x), t64(box), v=t64(v))
    st, th = sim.run(st, 2)

    for name in ("x", "v", "f"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(js, name)), rtol=0,
                                   atol=1e-9, err_msg=name)
    for name in S.Thermo._fields:
        np.testing.assert_allclose(getattr(th, name).numpy(),
                                   np.asarray(getattr(jth, name)),
                                   rtol=1e-9, atol=1e-9, err_msg=name)
    assert int(st.step) == 4 and not bool(st.overflow)
    np.testing.assert_array_equal(st.nbrs.idx.numpy(),
                                  np.asarray(js.nbrs.idx))


def test_thin_box_refusals():
    """Without image_shifts a thin box stops in init_state, and the message
    names this package's image route and replicate_data (no function of
    the JAX package); image mode takes no short_build."""
    x, box = bcc([1, 4, 4])
    n = len(x)
    mc = S.MDConfig(dt=0.001, cutoff=4.0, skin=SKIN, capacity=96,
                    nbr_method="n2")
    sim = S.Simulator(lambda xx, bb, nb: None,
                      torch.full((n,), MASS_FE, dtype=torch.float64), mc,
                      image_shifts=None)
    with pytest.raises(ValueError) as err:
        sim.init_state(t64(x), t64(box))
    msg = str(err.value)
    assert "meng_zhang_tpu_torch.geometry.lattice.replicate_data" in msg
    assert "meng_zhang_tpu_torch.models.annp.image_shift_table" in msg
    assert "energy_forces_virial_images" in msg and "pbc_eff" in msg
    assert re.search(r"meng_zhang_tpu\.", msg) is None
    with pytest.raises(NotImplementedError, match="short_build"):
        S.Simulator(sim.force_fn, sim.masses, mc,
                    short_build=lambda xx, bb, nb: None,
                    image_shifts=np.zeros((1, 3), np.int64))


def test_fire_image_route_matches_replicated_box():
    """A 270-atom screw-dislocation cell one Burgers vector thick (pbc F F
    T, wrapped into [0, b) along z as the image route needs), relaxed by
    fire_relax through 5 explicit z-images and, from the same start, as
    its 5-fold z-replica through the ordinary path."""
    d = make_screw_dislocation(num_lattice=(5, 9, 0.5), with_dislocation=True)
    x, box = d.x.copy(), d.box_hi - d.box_lo
    x[:, 2] %= box[2]
    n, pbc, rlist, rep = len(x), (False, False, True), 4.0 + SKIN, 5
    pot = reduced_potential(cut=4.0)
    shifts, pbc_eff = annp.image_shift_table(box, rlist, pbc)
    assert len(shifts) == rep
    cfg, params = annp.make_annp(pot, torch.float64, device="cpu",
                                 pbc=pbc_eff)
    cfg_r, params_r = annp.make_annp(pot, torch.float64, device="cpu",
                                     pbc=pbc)
    sh = torch.as_tensor(shifts)
    x_img, s_img = fire_relax(
        lambda xx, bb, idx: annp.energy_forces_virial_images(
            cfg, params, xx, bb, idx, sh, shift=False)[:2],
        lambda xx, bb: build_neighbors_images(xx, bb, sh, rlist, 64,
                                              pbc_eff),
        t64(x), t64(box), f_tol=0.1)
    x_rep = np.concatenate([x + [0.0, 0.0, k * box[2]] for k in range(rep)])
    x_r, s_r = fire_relax(
        lambda xx, bb, idx: annp.energy_forces_chunked(
            cfg_r, params_r, xx, bb, idx, shift=False),
        lambda xx, bb: build_neighbors_n2(xx, bb, rlist, 64, pbc),
        t64(x_rep), t64(box * [1.0, 1.0, rep]), f_tol=0.1)
    assert int(s_img.n_iter) == int(s_r.n_iter) > 0
    assert float(s_img.fmax) <= 0.1
    np.testing.assert_allclose(float(s_r.pe) / rep, float(s_img.pe),
                               rtol=1e-10)
    np.testing.assert_allclose(x_img.numpy(), x_r[:n].numpy(), rtol=0,
                               atol=1e-10)
