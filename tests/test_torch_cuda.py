"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. These tests skip without an NVIDIA GPU; on a machine with one, run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX, which the port's machine
need not have; this file imports no JAX.)

Tolerance (f64): the kernels run the plain versions' recurrences per lane
(force_harm sums each m block's terms before it multiplies in the
(x + iy)^m factors) and reduce lanes in another order, so each output agrees
to a few hundred ulps of its largest value: max |diff| <= 1e-12 of max
|value|. In f32 the harmonic kernels' bound is chip_smoke.py's REL_BOUND,
1e-4, derived there; the ni kernels' longest per-lane sums run over ~30
pair terms at K 32 (ni_force: a lane's partners; ni_g: <= 16 listed pairs a
lane) and the G4 columns then sum 32 lanes: 1e-4 of max |value| leaves a
wide margin over the ~1e-6 that f32 rounding of those sums gives. At K 128
and 256 (the wide cases) a slot's sums take up to 255 partners and a
lane's G4 sums up to ~1,000 listed pairs: their worst-case linear growth
(~6e-5) nears the bound, but the roundings add at random and read ~1e-6
on the card (chip_smoke.py's [ni-wide-kernels]). At K 320 and 512 (~320
partners a row) the worst case passes the bound (chip_smoke.py derives
NI_WIDER_REL_BOUND = 4e-4 for it); the card reads ~1e-6 there too
([ni-wider]). The fe cases at K 300-512 (rc 9.7 A, ~360 partners) keep
the harmonic and cos bounds: the card reads <= 5e-6 of max |value|
([fe-wide-kernels]).
Rows wider than 512 slots (K 513, 640, 1,024 of partners spread through a
ball): the harmonic pair in virtual rows keeps HARM_RTOL (the plain
versions' longest sums, over <= 1,024 lanes, 6.1e-5 of their terms in
f32); the ni cross-tile instances are held to NI_TILES_RTOL,
chip_smoke.py's NI_WIDEST_REL_BOUND widened for these rows' ~880
partners. The cos kernels' f32 bounds are chip_smoke.py's COS_REL_BOUND,
derived there. The delivered forces of a kernel path sum to zero up to rounding:
chip_smoke.py's EVAL_REL["sum_F"], 1e-6 N rms|F|.
"""
import dataclasses

import numpy as np
import pytest
import torch

from meng_zhang_tpu_torch.ops import fused_annp as fa
from meng_zhang_tpu_torch.ops import fused_ni as fn
from meng_zhang_tpu_torch.models.annp import make_annp
from meng_zhang_tpu_torch.ops import kernels
from meng_zhang_tpu_torch.system.neighbors import build_neighbors_n2
from meng_zhang_tpu_torch.testing import (NI_WIDE_ANGULAR, NI_WIDE_RAD_ETAS,
                                          synthetic_fe_potential,
                                          synthetic_ni_potential,
                                          thermal_bcc, thermal_fcc)
from meng_zhang_tpu_torch.units import CFLENGTH
from torch_port_util import cuda_device  # noqa: F401  (fixture)
from torch_port_util import (kernel_coeffs, ni_short_planes,
                             reduced_ni_potential, rel_max, short_planes)

# harmonic kernels, per dtype: chip_smoke.REL_BOUND
HARM_RTOL = {torch.float64: 1e-12, torch.float32: 1e-4}
NI_RTOL = {torch.float64: 1e-12, torch.float32: 1e-4}
# the ni cross-tile instances on rows of up to ~900 partners inside Rc:
# chip_smoke.NI_WIDEST_REL_BOUND, derived there
NI_TILES_RTOL = {torch.float64: 2e-12, torch.float32: 1e-3}
# chip_smoke.COS_REL_BOUND (g_cos, force_cos)
COS_RTOL = {torch.float64: (1e-12, 1e-12), torch.float32: (1e-4, 3e-4)}
SUM_F_REL = 1e-6        # chip_smoke.EVAL_REL["sum_F"], of N rms|F|


def _capacity(cut):
    """Skin capacity of short_planes' bcc box at cut + 0.5: 128 up to the
    shipped fe cutoff, 512 at rc 9.7 A (~410 partners within 10.2 A)."""
    return 128 if cut < 7.0 else 512


def _with_filler_rows(planes, filler):
    """8 all-filler rows (dx = 2 box + 10, the planes' largest value) after
    the box's, where its atom count, a multiple of 8, left none."""
    if filler.all(1).any():
        return planes, filler
    return ([np.concatenate([a, np.full((8, a.shape[1]), a.max())])
             for a in planes],
            np.concatenate([filler, np.ones((8, filler.shape[1]), bool)]))


def _harm_case(n_cells, cut, ks, npsf, ntsf, dtype, device):
    """Short planes of a perturbed bcc box with their lanes permuted (one
    seeded permutation for every row), so that the box's neighbors reach
    every slot of a wide K and filler lanes sit between them; the padding
    rows past the box are all filler. Returns (planes, filler, dedg, b)."""
    planes, filler = _with_filler_rows(*short_planes(
        n_cells, cut, ks, capacity=_capacity(cut)))
    perm = np.random.default_rng(ks).permutation(ks)
    planes = [torch.as_tensor(np.ascontiguousarray(a[:, perm]), dtype=dtype,
                              device=device) for a in planes]
    dedg, b = (torch.as_tensor(a, dtype=dtype, device=device)
               for a in kernel_coeffs(planes[0].shape[0], npsf, ntsf))
    return planes, torch.as_tensor(np.ascontiguousarray(filler[:, perm])), \
        dedg, b


def _check_harm(planes, filler, dedg, b, npsf, ntsf, cut):
    """Both harmonic kernels against their plain versions; filler lanes'
    Fj and all-filler rows' g and A exactly 0."""
    tol = HARM_RTOL[planes[0].dtype]
    before = (kernels.g_harm.launches, kernels.force_harm.launches)
    got = kernels.g_harm(*planes, npsf, ntsf, cut)
    want = fa.g_harm_plain(*planes, npsf, ntsf, cut)
    for u, v in zip(got, want):
        assert rel_max(u.cpu(), v.cpu()) <= tol
    empty = filler.all(1)
    assert bool(empty.any())
    for u in got:
        assert torch.all(u.cpu()[empty] == 0)
    got = kernels.force_harm(*planes, dedg, b, npsf, ntsf, cut)
    want = fa.force_harm_plain(*planes, dedg, b, npsf, ntsf, cut)
    for u, v in zip(got, want):
        assert rel_max(u.cpu(), v.cpu()) <= tol
        assert torch.all(u.cpu()[filler] == 0)
    assert (kernels.g_harm.launches, kernels.force_harm.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n_cells,cut,ks,npsf,ntsf", [
    (3, 4.0, 32, 4, 1),          # ntsf 1: no m >= 1 block
    (3, 4.0, 32, 4, 2),          # ntsf 2: no recurrence step
    (3, 4.0, 32, 4, 5),          # reduced width
    (3, 4.0, 40, 4, 5),          # K not a multiple of 32
    (5, 6.5, 128, 9, 19),        # the shipped fe width
    (5, 6.5, 192, 9, 19),        # skin-list lanes
    (5, 6.5, 256, 9, 19),        # 8 slots a lane in g_harm, one tile
    (5, 6.5, 300, 9, 19),        # two tiles of 5 slots a lane; 2 blocks
    (8, 9.7, 384, 9, 19),        # rc 9.7 A: ~340 partners, 2 x 6 slots
    (8, 9.7, 512, 9, 19),        # MAX_K: 2 x 8 slots, 2 x 256 lanes
])
def test_kernels_match_plain(cuda_device, n_cells, cut, ks, npsf, ntsf,
                             dtype):
    _check_harm(*_harm_case(n_cells, cut, ks, npsf, ntsf, dtype,
                            cuda_device), npsf, ntsf, cut)


@pytest.mark.cuda
def test_harm_widths_interleaved(cuda_device):
    """ntsf 5, then 19, then 5 in one process: each launch carries its own
    ladder table, so no launch sees another width's coefficients."""
    for n_cells, cut, ks, npsf, ntsf in [(3, 4.0, 40, 4, 5),
                                         (5, 6.5, 128, 9, 19),
                                         (3, 4.0, 40, 4, 5)]:
        _check_harm(*_harm_case(n_cells, cut, ks, npsf, ntsf, torch.float64,
                                cuda_device), npsf, ntsf, cut)


@pytest.mark.cuda
def test_wrappers_refuse_bad_inputs(cuda_device):
    planes = [torch.zeros(8, 32, dtype=torch.float64, device=cuda_device)
              for _ in range(3)]
    with pytest.raises(ValueError):                 # mixed dtypes
        kernels.g_harm(planes[0], planes[1].float(), planes[2], 4, 5, 4.0)
    with pytest.raises(ValueError):                 # b of the wrong width
        kernels.force_harm(*planes, planes[0][:, :1].repeat(1, 128),
                           planes[0][:, :1].repeat(1, 100), 4, 5, 4.0)


def _thin_rows(planes, filler, counts):
    """Row i keeps its first counts[i] real lanes; the rest become filler
    lanes (dx = 2 box + 10, the planes' largest value). In place."""
    assert filler.any()
    for i, keep in enumerate(counts):
        real = np.flatnonzero(~filler[i])
        assert len(real) >= keep
        for a in planes:
            a[i, real[keep:]] = a.max()
        filler[i, real[keep:]] = True


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n_cells,cut,ks,npsf,ntsf", [
    (3, 4.0, 40, 4, 5),          # K not a multiple of 32
    (5, 6.5, 128, 9, 19),        # the shipped fe width, short-list lanes
    (5, 6.5, 192, 9, 19),        # skin-list lanes (energy_dedg)
    (5, 6.5, 256, 9, 19),        # 8 warps a row: the widest 8-warp block
    (5, 6.5, 300, 9, 19),        # a 16-warp block, ~112 active lanes
    (8, 9.7, 384, 9, 19),        # rc 9.7 A: ~340 active lanes
    (8, 9.7, 512, 9, 19),        # MAX_K: 16 warps
    (3, 4.0, 32, 4, 1),          # one angular function
    (3, 4.0, 32, 4, 2),          # no recurrence step
    (3, 4.0, 40, 4, 12),         # one more instance of force_cos
    (3, 4.0, 32, 4, 32),         # COS_MAX_T
])
def test_cos_kernels_match_plain(cuda_device, n_cells, cut, ks, npsf, ntsf,
                                 dtype):
    """Both cos kernels against their plain versions. The padding rows hold
    no active lane; rows 0-3 are cut down to 1, 2, 7 and 8 active lanes
    (force_cos pairs thread j with j + d: one lane has no pair, two lanes
    one, and an even count ends on a half step)."""
    planes, filler = _with_filler_rows(*short_planes(
        n_cells, cut, ks, capacity=_capacity(cut)))
    _thin_rows(planes, filler, (1, 2, 7, 8))
    assert filler.all(1).any()
    planes = [torch.as_tensor(a, dtype=dtype, device=cuda_device)
              for a in planes]
    p = planes[0].shape[0]
    dedg = np.zeros((p, fa.NSF_PAD))
    dedg[:, :npsf + ntsf] = np.random.default_rng(1).normal(
        size=(p, npsf + ntsf))
    dedg = torch.as_tensor(dedg, dtype=dtype, device=cuda_device)
    g_tol, f_tol = COS_RTOL[dtype]
    before = (kernels.g_cos.launches, kernels.force_cos.launches)
    g = kernels.g_cos(*planes, npsf, ntsf, cut)
    assert rel_max(g.cpu(), fa.g_cos_plain(*planes, npsf, ntsf, cut).cpu()) \
        <= g_tol
    assert torch.all(g[:, npsf + ntsf:] == 0)
    got = kernels.force_cos(*planes, dedg, npsf, ntsf, cut)
    want = fa.force_cos_plain(*planes, dedg, npsf, ntsf, cut)
    for u, v in zip(got, want):
        assert rel_max(u.cpu(), v.cpu()) <= f_tol
        assert torch.all(u.cpu()[torch.as_tensor(filler)] == 0)
    assert (kernels.g_cos.launches, kernels.force_cos.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_cos_wrappers_refuse_bad_inputs(cuda_device):
    planes = [torch.zeros(8, 32, dtype=torch.float64, device=cuda_device)
              for _ in range(3)]
    wide = [torch.zeros(8, kernels.MAX_K + 1, device=cuda_device)] * 3
    with pytest.raises(ValueError, match="MAX_K = 512"):   # K above MAX_K
        kernels.g_cos(*wide, 4, 5, 4.0)
    with pytest.raises(ValueError):                 # more than 32 functions
        kernels.g_cos(*planes, 4, 33, 4.0)
    with pytest.raises(ValueError):                 # dedg of the wrong width
        kernels.force_cos(*planes, planes[0][:, :1].repeat(1, 100), 4, 5,
                          4.0)


def _ni_case(width):
    """(planes [P, Ks] numpy, filler mask, potential) on a perturbed fcc box
    with a vacancy: reduced width at Ks 16, the shipped width at Ks 32 or,
    for "k17", 17 of its lanes, some of them filler (a K that leaves lanes of
    the warp idle). "wide": Rc 6.0 A at Ks 128 (~86 partners a row, 4 slots
    a lane), "k48" 48 of its lanes (2 slots a lane), "k70" 70 of them,
    "k256" its lanes spread over 256 by a seeded permutation, filler
    between them (8 slots a lane); "table": the 10 + 22 table of
    testing.NI_WIDE_ANGULAR at Rc 6.0 A, Ks 128. "k320": Rc 9.2 A on fcc
    6^3 cells at Ks 320 (~320 partners a row, 16 slots a lane), "k512"
    those rows spread over 512 lanes, filler between them."""
    if width in ("k320", "k512"):
        pot = synthetic_ni_potential(0, rc_bohr=9.2 * CFLENGTH)
        rc_s = float(pot.sym_coeang[0, 3]) / CFLENGTH + 0.2
        planes, filler = ni_short_planes(rc_s, 320, n_cells=6, seed=2,
                                         capacity=448)
        if width == "k512":
            planes, filler = _spread(planes, filler, 512)
        return planes, filler, pot
    if width in ("wide", "k48", "k70", "k256", "table"):
        pot = synthetic_ni_potential(0, rc_bohr=6.0 * CFLENGTH) \
            if width != "table" else synthetic_ni_potential(
                0, npsf=10, rc_bohr=6.0 * CFLENGTH, ang=NI_WIDE_ANGULAR,
                rad_etas=NI_WIDE_RAD_ETAS)
        ks = 128
    else:
        pot = reduced_ni_potential() if width == "reduced" \
            else synthetic_ni_potential(0)
        ks = 16 if width == "reduced" else 32
    rc_s = float(pot.sym_coeang[0, 3]) / CFLENGTH + 0.2
    planes, filler = ni_short_planes(rc_s, ks, n_cells=4, seed=2,
                                     capacity=160)
    if width in ("k17", "k48", "k70"):
        lanes = {"k17": slice(4, 21), "k48": slice(40, 88),
                 "k70": slice(40, 110)}[width]
        planes = [np.ascontiguousarray(a[:, lanes]) for a in planes]
        filler = np.ascontiguousarray(filler[:, lanes])
    if width == "k256":
        planes, filler = _spread(planes, filler, 256)
    return planes, filler, pot


def _spread(planes, filler, k):
    """The [P, Ks] planes' lanes spread over k by a seeded permutation,
    filler lanes (the planes' largest value) between them."""
    ks = planes[0].shape[1]
    pad = planes[0].max()
    perm = np.random.default_rng(k).permutation(k)
    planes = [np.ascontiguousarray(np.concatenate(
        [a, np.full((a.shape[0], k - ks), pad)], 1)[:, perm])
        for a in planes]
    filler = np.ascontiguousarray(np.concatenate(
        [filler, np.ones((filler.shape[0], k - ks), bool)], 1)[:, perm])
    return planes, filler


def _odd_coeang(pot):
    """The potential's angular table with two zetas that are no powers of
    two (ni_force's pow route) and, where it has three eta groups, one
    function moved into the first."""
    coeang = np.array(pot.sym_coeang, dtype=np.float64)
    coeang[1, 2], coeang[-1, 2] = 3.0, 6.0
    if len(coeang) > 16:
        coeang[16, 0] = coeang[0, 0]
    return coeang


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("width", ["reduced", "full", "reduced-odd",
                                   "full-odd", "k17", "wide", "wide-odd",
                                   "k48", "k70", "k256", "table", "k320",
                                   "k512"])
def test_ni_kernels_match_plain(cuda_device, width, dtype):
    """Both ni kernels against their plain versions, on the potential's
    table or (-odd) one with zetas 3 and 6. Rows 0-2 are cut down to 0, 1
    and 2 lanes (no candidate pair, none, one), and row 3 holds Ks lanes
    inside the angular cutoff in random directions: the longest pair list,
    496 candidates at Ks 32, 8,128 (16 tiles) at Ks 128, 32,640 at 256,
    130,816 at 512. The padding-free box also has rows of its usual
    partners (~12, ~86 at Rc 6.0 A, ~320 at 9.2 A), "k17" runs with K =
    17, "k48" with K = 48 and "k70" with K = 70."""
    width, _, odd = width.partition("-")
    planes, filler, pot = _ni_case(width)
    _thin_rows(planes, filler, (0, 1, 2))
    rng = np.random.default_rng(3)
    ks = planes[0].shape[1]
    u = rng.normal(size=(3, ks))
    r = float(pot.sym_coeang[0, 3]) / CFLENGTH * rng.uniform(0.5, 0.95, ks)
    for a, ud in zip(planes, u / np.linalg.norm(u, axis=0) * r):
        a[3] = ud
    filler[3] = False
    table = fn.ni_table(pot.sym_coerad,
                        _odd_coeang(pot) if odd else pot.sym_coeang)
    p = planes[0].shape[0]
    dedg = np.zeros((p, fn.NSF_SUB))
    dedg[:, :pot.nsf] = np.random.default_rng(1).normal(size=(p, pot.nsf))
    tp = [torch.as_tensor(a, dtype=dtype, device=cuda_device)
          for a in planes]
    td = torch.as_tensor(dedg, dtype=dtype, device=cuda_device)
    before = (kernels.ni_g.launches, kernels.ni_force.launches)
    g = kernels.ni_g(*tp, table)
    assert rel_max(g.cpu(), fn.ni_g_plain(*tp, table).cpu()) <= NI_RTOL[dtype]
    assert torch.all(g[:, pot.nsf:] == 0)
    fj = kernels.ni_force(*tp, td, table)
    for u, v in zip(fj, fn.ni_force_plain(*tp, td, table)):
        assert rel_max(u.cpu(), v.cpu()) <= NI_RTOL[dtype]
        # filler lanes give exact zeros
        assert torch.all(u.cpu()[torch.as_tensor(filler)] == 0)
        assert torch.isfinite(u).all()
    assert (kernels.ni_g.launches, kernels.ni_force.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ni_g_is_deterministic(cuda_device, dtype):
    """ni_g sums each lane's pair terms in list order in registers and
    reduces with shuffles, no atomics: two runs agree bit for bit."""
    planes, _, pot = _ni_case("full")
    table = fn.ni_table(pot.sym_coerad, pot.sym_coeang)
    tp = [torch.as_tensor(np.tile(a, (64, 1)), dtype=dtype,
                          device=cuda_device) for a in planes]
    first = kernels.ni_g(*tp, table)
    for _ in range(3):
        assert torch.equal(kernels.ni_g(*tp, table), first)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_g_cos_every_ntsf_instance(cuda_device, dtype):
    """g_cos has one compiled instance per ntsf: each of the 32 against the
    plain version on one set of planes."""
    npsf, cut = 4, 4.0
    planes, filler = short_planes(3, cut, 40)
    _thin_rows(planes, filler, (1, 2, 7, 8))
    planes = [torch.as_tensor(a, dtype=dtype, device=cuda_device)
              for a in planes]
    for ntsf in range(1, kernels.COS_MAX_T + 1):
        g = kernels.g_cos(*planes, npsf, ntsf, cut)
        want = fa.g_cos_plain(*planes, npsf, ntsf, cut)
        assert rel_max(g.cpu(), want.cpu()) <= COS_RTOL[dtype][0], ntsf
        assert torch.all(g[:, npsf + ntsf:] == 0)


@pytest.mark.cuda
def test_ni_wrappers_refuse_bad_inputs(cuda_device):
    pot = reduced_ni_potential()
    table = fn.ni_table(pot.sym_coerad, pot.sym_coeang)
    for k in (16, kernels.NI_MAX_K + 1):     # one-warp and cross-tile
        planes = [torch.zeros(8, k, device=cuda_device) for _ in range(3)]
        with pytest.raises(ValueError):             # dedg of the wrong width
            kernels.ni_force(*planes, torch.zeros(8, 27, device=cuda_device),
                             table)
        with pytest.raises(ValueError):             # mixed dtypes
            kernels.ni_g(planes[0], planes[1].double(), planes[2], table)


def _ball_rows(k, rmax, seed):
    """[8, K] planes (numpy) of rows of partners spread through a ball of
    radius rmax: rows 0-4 full (row 0's last 40 lanes filler), row 5 with
    only its first and last lanes real (one partner in its first and last
    tiles), row 6 with only lane 300, row 7 all filler (2 box + 10 = 70 A
    on every axis). Also the filler mask."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(8, k, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    x = u * rmax * rng.uniform(0.05, 1.0, size=(8, k, 1)) ** (1.0 / 3.0)
    filler = np.zeros((8, k), dtype=bool)
    filler[0, -40:] = True
    filler[5, 1:-1] = True
    filler[6] = True
    filler[6, 300] = False
    filler[7] = True
    x[filler] = 70.0
    return [np.ascontiguousarray(x[..., a]) for a in range(3)], filler


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k", [513, 640, 1024])
def test_harm_tiles_match_plain(cuda_device, k, dtype):
    """Rows wider than MAX_K through the harmonic kernels as virtual rows of
    HARM_TILE slots, one launch each: against the plain versions on the whole
    row (HARM_RTOL: the plain versions' longest sums run over <= 1,024
    lanes, 6.1e-5 of their terms in f32) and bitwise against the same
    split over the plain pieces' inputs where the kernels are exact (the
    filler lanes and rows: 0)."""
    npsf, ntsf, cut = 9, 19, 6.5
    planes, filler = _ball_rows(k, cut + 0.5, seed=k)
    tp = [torch.as_tensor(a, dtype=dtype, device=cuda_device) for a in planes]
    dedg, b = (torch.as_tensor(a, dtype=dtype, device=cuda_device)
               for a in kernel_coeffs(8, npsf, ntsf))
    g_fn, f_fn = kernels.GHarm(), kernels.ForceHarm()
    tol = HARM_RTOL[dtype]
    got = g_fn(*tp, npsf, ntsf, cut)
    for u, v in zip(got, fa.g_harm_plain(*tp, npsf, ntsf, cut)):
        assert rel_max(u.cpu(), v.cpu()) <= tol
        assert torch.all(u[7] == 0)
    fj = f_fn(*tp, dedg, b, npsf, ntsf, cut)
    for u, v in zip(fj, fa.force_harm_plain(*tp, dedg, b, npsf, ntsf, cut)):
        assert u.shape == (8, k)
        assert rel_max(u.cpu(), v.cpu()) <= tol
        assert torch.all(u.cpu()[torch.as_tensor(filler)] == 0)
    assert (g_fn.launches, f_fn.launches) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k,table", [(513, "full"), (640, "full"),
                                     (640, "odd"), (640, "gap"),
                                     (1024, "full")])
def test_ni_tiles_match_plain(cuda_device, k, table, dtype):
    """Rows wider than NI_MAX_K through the cross-tile instances, on the
    shipped table at Rc 11.0 A (or its pow-route variant, "odd"; "gap":
    the shipped table on rows whose third tile holds real partners, all
    beyond Rc, so that the units with that tile list no pair): against the
    plain versions on the whole row and the plain twins of the tiled
    decomposition (NI_TILES_RTOL), filler lanes exactly 0, one launch of
    each kernel a call (the rows in one chunk); ni_force_tiles' sum kernel
    on the unit kernel's partials against its plain twin on the same ones
    (NI_TILES_RTOL); two runs of each kernel agree bit for bit."""
    pot = synthetic_ni_potential(0, rc_bohr=11.0 * CFLENGTH)
    tab = fn.ni_table(pot.sym_coerad,
                      _odd_coeang(pot) if table == "odd" else pot.sym_coeang)
    planes, filler = _ball_rows(k, 11.0 * 1.05, seed=k + 1)
    if table == "gap":             # the third tile's partners to 1.2-1.5 Rc
        gap = slice(2 * kernels.NI_TILE, 3 * kernels.NI_TILE)
        d = np.stack([t[:, gap] for t in planes], -1)
        far = np.random.default_rng(k).uniform(1.2, 1.5, size=d.shape[:2])
        d = np.where(filler[:, gap, None], d, d / np.linalg.norm(
            d, axis=-1, keepdims=True) * (far * 11.0)[..., None])
        for a, t in enumerate(planes):
            t[:, gap] = d[..., a]
    tp = [torch.as_tensor(a, dtype=dtype, device=cuda_device) for a in planes]
    dedg = np.zeros((8, fn.NSF_SUB))
    dedg[:, :pot.nsf] = np.random.default_rng(1).normal(size=(8, pot.nsf))
    td = torch.as_tensor(dedg, dtype=dtype, device=cuda_device)
    g_fn, f_fn = kernels.NiGTiles(), kernels.NiForceTiles()
    sums0 = kernels.ni_force_tiles_sum.launches
    tol = NI_TILES_RTOL[dtype]
    g = g_fn(*tp, tab)
    for want in (fn.ni_g_plain(*tp, tab), fa.sum_tiles(
            fn.ni_g_tiles_plain(*tp, tab, kernels.NI_TILE))):
        assert rel_max(g.cpu(), want.cpu()) <= tol
    assert torch.all(g[:, pot.nsf:] == 0) and torch.all(g[7] == 0)
    fj = f_fn(*tp, td, tab)
    for want in (fn.ni_force_plain(*tp, td, tab),
                 fn.ni_force_tiles_plain(*tp, td, tab, kernels.NI_TILE)):
        for u, v in zip(fj, want):
            assert rel_max(u.cpu(), v.cpu()) <= tol
    for u in fj:
        assert torch.all(u.cpu()[torch.as_tensor(filler)] == 0)
        assert torch.isfinite(u).all()
        if table == "gap":
            assert torch.all(u[:, gap] == 0)
    assert (g_fn.launches, f_fn.launches) == (1, 1)
    assert kernels.ni_force_tiles_sum.launches == sums0 + 1
    assert torch.equal(g_fn(*tp, tab), g)
    for u, v in zip(f_fn(*tp, td, tab), fj):
        assert torch.equal(u, v)
    part = f_fn.units(*tp, td, tab)
    for u, v in zip(kernels.ni_force_tiles_sum(*tp, td, part, tab),
                    fn.ni_force_tiles_sum_plain(*tp, td, part, tab)):
        assert rel_max(u.cpu(), v.cpu()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ni_force_tiles_chunks_equal_one_pass(cuda_device, dtype,
                                              monkeypatch):
    """ni_force_tiles with a scratch of 3 rows (its 8 rows in 3 chunks,
    each through both kernels, 3 launches of each) gives the bits of one
    pass over all rows."""
    pot = synthetic_ni_potential(0, rc_bohr=11.0 * CFLENGTH)
    tab = fn.ni_table(pot.sym_coerad, pot.sym_coeang)
    planes, _ = _ball_rows(640, 11.0 * 1.05, seed=7)
    tp = [torch.as_tensor(a, dtype=dtype, device=cuda_device) for a in planes]
    td = torch.as_tensor(np.random.default_rng(3).normal(size=(8, 32)),
                         dtype=dtype, device=cuda_device)
    whole = kernels.ni_force_tiles(*tp, td, tab)
    nt = -(-640 // kernels.NI_TILE)
    row_bytes = nt * nt * 4 * kernels.NI_TILE * tp[0].element_size()
    monkeypatch.setattr(kernels, "NI_SCRATCH_BYTES", 3 * row_bytes)
    assert kernels.ni_scratch_rows(640, tp[0].element_size()) == 3
    kernels.reset_launch_counts()
    for u, v in zip(kernels.ni_force_tiles(*tp, td, tab), whole):
        assert torch.equal(u, v)
    assert kernels.ni_force_tiles.launches == 3
    assert kernels.ni_force_tiles_sum.launches == 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("path", ["matrix", "ni"])
def test_delivered_forces_match_plain_and_sum_to_zero(cuda_device, path,
                                                      dtype):
    """force_cos and ni_force through evaluate_pairs: each row's Fj plus
    the own-row term, delivered, against the plain path's forces, and the
    total momentum change."""
    if path == "matrix":
        cfg, params = make_annp(synthetic_fe_potential(0), dtype, cuda_device)
        x, box = thermal_bcc(5, seed=2, disp=0.08)
        kw = dict(k_short=128, angular="matrix")
        make, width = fa.FusedAnnp, cfg.cut
    else:
        cfg, params = make_annp(synthetic_ni_potential(0), dtype, cuda_device)
        x, box = thermal_fcc(4, seed=2, disp=0.08)
        kw = dict(k_short=32)
        make = fn.FusedNi
        width = float(params["coeang"][0, 3]) / CFLENGTH
    x = torch.as_tensor(x, dtype=dtype, device=cuda_device)
    box = torch.as_tensor(box, dtype=dtype, device=cuda_device)
    nbrs = build_neighbors_n2(x, box, width + 0.3, 128)
    assert not bool(nbrs.overflow)
    e, f, w = make(cfg, params, **kw).energy_forces(x, box, nbrs.idx)
    e0, f0, w0 = make(cfg, params, plain=True, **kw).energy_forces(
        x, box, nbrs.idx)
    assert torch.isfinite(f).all()
    # normalisation carries the descriptors' rounding to the network inputs
    # ~1e3x enlarged (chip_smoke.EVAL_REL["max_dF"], 1e-3 of max|F| in f32)
    tol = {torch.float64: 1e-10, torch.float32: 1e-3}[dtype]
    assert rel_max(f.cpu(), f0.cpu()) <= tol
    assert abs(float(e) - float(e0)) <= tol * abs(float(e0))
    assert rel_max(w.cpu(), w0.cpu()) <= tol
    rms = float(f.double().pow(2).mean().sqrt())
    assert float(f.double().sum(0).abs().max()) <= SUM_F_REL * len(x) * rms


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["harmonic", "ni"])
def test_per_atom_and_chunked_functions_match_plain(cuda_device, path):
    """The per-atom tallies and the chunked functions (models/annp.py)
    through the kernels in f64 against the plain evaluator: each output
    within 1e-10 of its largest |value| (the kernels' 1e-12 per output,
    carried through the network and the tallies)."""
    from meng_zhang_tpu_torch.models import annp
    dtype = torch.float64
    if path == "harmonic":
        cfg, params = make_annp(synthetic_fe_potential(0), dtype, cuda_device)
        x, box = thermal_bcc(5, seed=3, disp=0.08)
        kw, make, width = dict(k_short=128), fa.FusedAnnp, cfg.cut
    else:
        cfg, params = make_annp(synthetic_ni_potential(0), dtype, cuda_device)
        x, box = thermal_fcc(4, seed=3, disp=0.08)
        kw, make = dict(k_short=32), fn.FusedNi
        width = float(params["coeang"][0, 3]) / CFLENGTH
    x = torch.as_tensor(x, dtype=dtype, device=cuda_device)
    box = torch.as_tensor(box, dtype=dtype, device=cuda_device)
    nbrs = build_neighbors_n2(x, box, width + 0.3, 128)
    kernels.reset_launch_counts()
    got = make(cfg, params, **kw).energy_forces(x, box, nbrs.idx,
                                                per_atom=True)
    chunked = annp.energy_forces_virial_chunked(cfg, params, x, box,
                                                nbrs.idx, shift=False)
    names = ("g_harm", "force_harm") if path == "harmonic" \
        else ("ni_g", "ni_force")
    assert all(getattr(kernels, k).launches == 2 for k in names)
    want = make(cfg, params, plain=True, **kw).energy_forces(
        x, box, nbrs.idx, per_atom=True)
    for a, b in zip(got + chunked, want + want[:3]):
        assert torch.isfinite(a).all()
        assert rel_max(a.cpu(), b.cpu()) <= 1e-10


@pytest.mark.cuda
def test_cli_runs_on_the_card(cuda_device, tmp_path, capsys):
    """python -m meng_zhang_tpu_torch's run.main on the card (its default):
    NPT with a per-atom dump, through g_harm and force_harm."""
    from meng_zhang_tpu_torch import run
    from meng_zhang_tpu_torch.io.potential import write_ann
    from torch_port_util import reduced_potential
    ann = str(tmp_path / "fe.ann")
    write_ann(ann, reduced_potential(cut=4.0))
    kernels.reset_launch_counts()
    run.main(["--lattice", "bcc", "--cells", "6", "6", "6", "--potential",
              ann, "--skin", "1.0", "--capacity", "64", "--ensemble", "npt",
              "--couple", "y", "--boundary", "m p m", "--steps", "20",
              "--thermo", "10", "--dump", str(tmp_path / "d.lammpstrj"),
              "--dump-peratom"])
    rows = capsys.readouterr().out.splitlines()[1:]
    assert len(rows) == 3
    assert np.isfinite([[float(v) for v in r.split()] for r in rows]).all()
    # init, 20 steps, two per-atom dumps
    assert kernels.g_harm.launches == kernels.force_harm.launches == 23


# ANNA-ADP: g_harm at the ANNA scene's shape (K 72, rc 5.055), the fast and
# reference-shaped paths on the card against the same on the CPU, the CLI
ANNA_RC, ANNA_KS = 5.055, 72


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_g_harm_at_the_anna_shape(cuda_device, dtype):
    """g_harm on [P, 72] short planes at rc 5.055 A (its 3-slots-a-lane
    instance) at the shipped ANNA width (npsf 9, ntsf 19) against its
    plain version; all-filler rows exactly 0."""
    planes, filler = short_planes(5, ANNA_RC, ANNA_KS)
    planes = [torch.as_tensor(a, dtype=dtype, device=cuda_device)
              for a in planes]
    before = kernels.g_harm.launches
    got = kernels.g_harm(*planes, 9, 19, ANNA_RC)
    want = fa.g_harm_plain(*planes, 9, 19, ANNA_RC)
    assert kernels.g_harm.launches == before + 1
    empty = torch.as_tensor(filler).all(1)
    for u, v in zip(got, want):
        assert rel_max(u.cpu(), v.cpu()) <= HARM_RTOL[dtype]
        assert torch.all(u.cpu()[empty] == 0)


def _anna_case(device):
    from meng_zhang_tpu_torch.models import anna_adp as A
    from meng_zhang_tpu_torch.testing import synthetic_anna_potential
    cfg, params = A.make_anna(synthetic_anna_potential(0), torch.float64,
                              device)
    x, box = thermal_bcc(5, seed=3, disp=0.08)
    x = torch.as_tensor(x, dtype=torch.float64, device=device)
    box = torch.as_tensor(box, dtype=torch.float64, device=device)
    nbrs = build_neighbors_n2(x, box, cfg.cut + 0.3, 96)
    fns = A.make_anna_fast_fns(cfg, params, k_short=ANNA_KS, delta=0.2)
    short = fns[2](x, box, nbrs)
    return A, cfg, params, x, box, nbrs, fns, short


@pytest.mark.cuda
def test_anna_paths_on_card_match_cpu(cuda_device):
    """make_anna_fast_fns (force, light) and the reference-shaped
    energy_forces_virial / atom_energies in f64 on the card (g_harm's
    kernel) against the same on the CPU (its plain version): each output
    within 1e-10 of its largest |value| (the kernel's 1e-12 carried through
    the network and the ADP terms); one g_harm launch an evaluation."""
    kernels.reset_launch_counts()
    A, cfg, p, x, box, nbrs, fns, short = _anna_case(cuda_device)
    got = list(fns[0](x, box, nbrs, short)) \
        + list(fns[1](x, box, nbrs, short)[:2]) \
        + list(A.energy_forces_virial(cfg, p, x, box, nbrs.idx)) \
        + [A.atom_energies(cfg, p, x, box, nbrs.idx)]
    assert kernels.g_harm.launches == 4
    assert kernels.force_harm.launches == 0
    A, cfg, p, x, box, nbrs, fns, short = _anna_case("cpu")
    want = list(fns[0](x, box, nbrs, short)) \
        + list(fns[1](x, box, nbrs, short)[:2]) \
        + list(A.energy_forces_virial(cfg, p, x, box, nbrs.idx)) \
        + [A.atom_energies(cfg, p, x, box, nbrs.idx)]
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert rel_max(a.cpu(), b) <= 1e-10


@pytest.mark.cuda
def test_cli_anna_runs_on_the_card(cuda_device, tmp_path, capsys):
    """run.main on a .anna on the card: NVE with a per-atom dump, g_harm
    once an evaluation (init, 20 steps, two dumps), no force_harm."""
    from meng_zhang_tpu_torch import run
    from meng_zhang_tpu_torch.testing import (anna_text,
                                              synthetic_anna_potential)
    anna = tmp_path / "fe.anna"
    anna.write_text(anna_text(synthetic_anna_potential(0)))
    kernels.reset_launch_counts()
    run.main(["--lattice", "bcc", "--cells", "6", "6", "6", "--potential",
              str(anna), "--skin", "0.5", "--capacity", "96", "--steps",
              "20", "--thermo", "10", "--dump", str(tmp_path / "d.lammpstrj"),
              "--dump-peratom"])
    rows = capsys.readouterr().out.splitlines()[1:]
    assert len(rows) == 3
    assert np.isfinite([[float(v) for v in r.split()] for r in rows]).all()
    assert kernels.g_harm.launches == 23
    assert kernels.force_harm.launches == 0


# multi-element and thin-box paths: every kernel through the per-row network
# select and the image-extended partner table
MULTI_KERNELS = {"harmonic": ("g_harm", "force_harm"),
                 "matrix": ("g_cos", "force_cos"), "ni": ("ni_g", "ni_force")}


def _multi_case(path, device, dtype):
    """(make, cfg, params, kw, rc, scene, thin scene) for one path: a
    two-element potential, a thermal periodic box and a thin box (the
    1 x 4 x 4-cell bcc or fcc box) with its image shifts, both typed
    50/50."""
    from meng_zhang_tpu_torch.geometry.lattice import bcc, fcc
    from meng_zhang_tpu_torch.models import annp
    from meng_zhang_tpu_torch.testing import (synthetic_fe_potential_multi,
                                              synthetic_ni_potential_multi)
    rng = np.random.default_rng(4)
    if path == "ni":
        pot, kw, make = synthetic_ni_potential_multi(2), dict(k_short=32), \
            fn.FusedNi
        x, box = thermal_fcc(4, seed=2, disp=0.08)
        xt, bt = fcc([1, 4, 4], 3.52)
    else:
        pot, kw, make = synthetic_fe_potential_multi(2), dict(
            k_short=128, angular=path), fa.FusedAnnp
        x, box = thermal_bcc(5, seed=2, disp=0.08)
        xt, bt = bcc([1, 4, 4])
    xt = xt + rng.normal(scale=0.03, size=xt.shape)
    cfg, params = make_annp(pot, dtype, device)
    rc = annp.descriptor_cutoff(cfg, params)
    shifts, pbc_eff = annp.image_shift_table(bt, rc + 0.3, (True,) * 3)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    el = torch.as_tensor(rng.integers(0, 2, len(x)), device=device)
    el_t = torch.as_tensor(rng.integers(0, 2, len(xt)), device=device)
    return (make, cfg, params, kw, rc, (t(x), t(box), el),
            (t(xt), t(bt), el_t, torch.as_tensor(shifts, device=device),
             pbc_eff))


def _multi_outputs(make, cfg, params, kw, rc, scene, thin, plain):
    """The evaluator with elems on the periodic box, then over the thin
    box's image-extended table: E, F, W of each."""
    import dataclasses
    from meng_zhang_tpu_torch.system.cell import image_table
    from meng_zhang_tpu_torch.system.neighbors import build_neighbors_images
    x, box, el = scene
    nbrs = build_neighbors_n2(x, box, rc + 0.3, 128)
    out = list(make(cfg, params, plain=plain, elems=el, **kw).energy_forces(
        x, box, nbrs.idx))
    xt, bt, el_t, shifts, pbc_eff = thin
    ev = make(dataclasses.replace(cfg, pbc=pbc_eff), params, plain=plain,
              **kw)
    nb = build_neighbors_images(xt, bt, shifts, rc + 0.3, 192, pbc_eff)
    x_ext = image_table(xt, bt, shifts)
    sl = fa.compact_short(xt, bt, nb.idx, rc + 0.3, kw["k_short"], pbc_eff,
                          x_ext=x_ext)
    assert not bool(nb.overflow) and not bool(sl.overflow)
    out += ev.energy_forces_short(xt, bt, sl, elems=el_t, x_ext=x_ext)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("path", list(MULTI_KERNELS))
def test_multi_element_and_images_match_plain(cuda_device, path, dtype):
    """Each kernel pair through the per-row network select (two elements)
    and over an image-extended partner table (a thin box, self-image
    lanes included) against the plain path on the card. f64: E, F and W
    within 1e-10 of their largest |value| (the kernels' 1e-12 carried
    through the network and the tallies). f32 against f64: F within
    chip_smoke.py's evaluator bound (EVAL_REL / NI_EVAL_REL max_dF, 1e-3
    and 2e-4 of max|F|) and E within 1e-5 of |E| (dE_per_atom)."""
    case = _multi_case(path, cuda_device, dtype)
    kernels.reset_launch_counts()
    got = _multi_outputs(*case, plain=False)
    assert all(getattr(kernels, k).launches == 2
               for k in MULTI_KERNELS[path])
    ref = _multi_outputs(*_multi_case(path, cuda_device, torch.float64),
                         plain=True)
    if dtype == torch.float64:
        tols = (1e-10,) * 6
    else:
        f_tol = 2e-4 if path == "ni" else 1e-3
        tols = (1e-5, f_tol, None) * 2
    for a, b, tol in zip(got, ref, tols):
        assert torch.isfinite(a).all()
        if tol is not None:
            assert rel_max(a.double().cpu(), b.cpu()) <= tol


def _shard_case(path, device, plain=False, n_dev=2, ensemble="nve"):
    """A sharded slab (periodic; fe: the 1,200-atom 24 x 5 x 5-cell bcc
    slab of tests/test_multichip.py at the shipped width, ni: a 1,024-atom
    fcc slab) served by the frame short list of one fused evaluator in
    f64; returns (ShardedMD, x, v)."""
    from meng_zhang_tpu_torch.models.annp import descriptor_cutoff
    from meng_zhang_tpu_torch.parallel import domain as D
    if path == "fe":
        pot, mass = synthetic_fe_potential(0), 55.845
        x, box = thermal_bcc((24, 5, 5), seed=4, disp=0.05)
    else:
        pot, mass = synthetic_ni_potential(0), 58.6934
        x, box = thermal_fcc((16, 4, 4), seed=4, disp=0.05)
    cfg, params = make_annp(pot, torch.float64, device)
    make = fa.FusedAnnp if path == "fe" else fn.FusedNi
    ev = make(cfg, params, k_short=128 if path == "fe" else 32,
              short_delta=0.3, plain=plain)
    scfg = D.ShardConfig(n_devices=n_dev, c_loc=len(x) // n_dev,
                         cutoff=descriptor_cutoff(cfg, params), skin=0.5,
                         dt=0.001, ensemble=ensemble, t_target=300.0,
                         thermo_every=3)
    v = np.random.default_rng(1).normal(scale=3.0, size=x.shape)
    v -= v.mean(axis=0)
    md = D.ShardedMD(D.FrameShortModel(ev), mass, box, scfg, device=device)
    as_t = (lambda a: torch.as_tensor(a, dtype=torch.float64, device=device))
    return md, as_t(x), as_t(v)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fe", "ni"])
def test_frame_short_kernels_match_plain(cuda_device, path):
    """distribute() of 4 shards through the kernels against the plain
    path on the card, in f64: every shard's frame in one launch of each
    kernel; forces, PE and W within 1e-10 of their scale (the kernels'
    1e-12 carried through the networks)."""
    names = ("g_harm", "force_harm") if path == "fe" else ("ni_g",
                                                           "ni_force")
    kernels.reset_launch_counts()
    md, x, _ = _shard_case(path, cuda_device, n_dev=4)
    st, _ = md.distribute(x)
    for name in names:
        assert getattr(kernels, name).launches == 1, name
    md0, x0, _ = _shard_case(path, cuda_device, plain=True, n_dev=4)
    st0, _ = md0.distribute(x0)
    assert not bool(st.overflow.any()) and torch.isfinite(st.f_loc).all()
    assert rel_max(st.f_loc.cpu(), st0.f_loc.cpu()) <= 1e-10
    assert rel_max(st.virial.cpu(), st0.virial.cpu()) <= 1e-10
    assert abs(float(st.pe.sum() - st0.pe.sum())) <= 1e-10 * abs(
        float(st0.pe.sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fe", "ni"])
def test_sharded_steps_on_card_match_cpu(cuda_device, path):
    """Two NVT blocks of 3 steps on 2 shards on the card (the kernels)
    against the same on the CPU (their plain versions), in f64: thermo
    rtol 1e-10, positions within 1e-10 A; one launch of each kernel a
    step."""
    out = []
    for dev in (cuda_device, "cpu"):
        kernels.reset_launch_counts()
        md, x, v = _shard_case(path, dev, ensemble="nvt")
        st, _ = md.distribute(x, v)
        st, th = md.run(st, 2)
        if dev != "cpu":
            name = "force_harm" if path == "fe" else "ni_force"
            assert getattr(kernels, name).launches == 1 + 6
        assert not bool(st.overflow.any()) and not bool(st.unsafe.any())
        out.append((md.gather_positions(st).cpu(), th))
    (x1, th1), (x2, th2) = out
    assert float((x1 - x2).abs().max()) <= 1e-10
    for a, b in zip(th1[1:], th2[1:]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-10)


def _grid_case(layout, device, plain=False):
    """The 2-D driver on a (2, 2) mesh over a 1,728-atom bcc box of the
    shipped fe width ("2d-fe"), or the 3-D driver on a (2, 2, 2) mesh over
    an 864-atom fcc box of the shipped ni width ("3d-ni"), each through
    the frame short list of its fused evaluator in f64, NVT; returns
    (driver, x, v)."""
    from meng_zhang_tpu_torch.models.annp import descriptor_cutoff
    from meng_zhang_tpu_torch.parallel import domain as D
    from meng_zhang_tpu_torch.parallel import domain2d as D2
    from meng_zhang_tpu_torch.parallel import domain3d as D3
    if layout == "2d-fe":
        pot, mass = synthetic_fe_potential(0), 55.845
        x, box = thermal_bcc((12, 12, 6), seed=4, disp=0.05)
        make, mesh, driver = D2.Shard2DConfig, (2, 2), D2.ShardedMD2D
    else:
        pot, mass = synthetic_ni_potential(0), 58.6934
        x, box = thermal_fcc((6, 6, 6), seed=4, disp=0.05)
        make, mesh, driver = D3.Shard3DConfig, (2, 2, 2), D3.ShardedMD3D
    cfg, params = make_annp(pot, torch.float64, device)
    ev = (fa.FusedAnnp if layout == "2d-fe" else fn.FusedNi)(
        cfg, params, k_short=128 if layout == "2d-fe" else 32,
        short_delta=0.3, plain=plain)
    d = int(np.prod(mesh))
    scfg = make(n_devices=d, mesh_shape=mesh, c_loc=len(x) // d,
                cutoff=descriptor_cutoff(cfg, params), skin=0.5, dt=0.001,
                ensemble="nvt", t_target=300.0, thermo_every=3)
    v = np.random.default_rng(1).normal(scale=3.0, size=x.shape)
    v -= v.mean(axis=0)
    md = driver(D.FrameShortModel(ev), mass, box, scfg, device=device)
    as_t = (lambda a: torch.as_tensor(a, dtype=torch.float64, device=device))
    return md, as_t(x), as_t(v)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["2d-fe", "3d-ni"])
def test_grid_drivers_on_card_match_cpu(cuda_device, layout):
    """distribute and two NVT blocks of 3 steps of the 2-D and 3-D drivers
    on the card (the kernels) against the same on the CPU (their plain
    versions), in f64: the first plans equal, thermo rtol 1e-10, positions
    within 1e-10 A; one launch of each kernel a step for all shards."""
    name = "force_harm" if layout == "2d-fe" else "ni_force"
    out = []
    for dev in (cuda_device, "cpu"):
        kernels.reset_launch_counts()
        md, x, v = _grid_case(layout, dev)
        st, _ = md.distribute(x, v)
        plan = [t.cpu() for t in st.plan]
        st, th = md.run(st, 2)
        if dev != "cpu":
            assert getattr(kernels, name).launches == 1 + 6
        assert not bool(st.overflow.any()) and not bool(st.unsafe.any())
        out.append((plan, md.gather_positions(st).cpu(), th))
    (p1, x1, th1), (p2, x2, th2) = out
    for a, b in zip(p1, p2):
        assert torch.equal(a, b)
    assert float((x1 - x2).abs().max()) <= 1e-10
    for a, b in zip(th1[1:], th2[1:]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-10)


@pytest.mark.cuda
def test_grid_frame_evaluation_kernels_match_plain(cuda_device):
    """The (2, 2) fe frame evaluation at distribute through the kernels
    against the plain path on the card, in f64: every shard's frame, all
    its rows centres, in one launch of each kernel; forces, PE and W
    within 1e-10 of their scale."""
    kernels.reset_launch_counts()
    md, x, _ = _grid_case("2d-fe", cuda_device)
    st, _ = md.distribute(x)
    assert kernels.g_harm.launches == 1 and kernels.force_harm.launches == 1
    md0, x0, _ = _grid_case("2d-fe", cuda_device, plain=True)
    st0, _ = md0.distribute(x0)
    assert not bool(st.overflow.any()) and torch.isfinite(st.f_loc).all()
    assert rel_max(st.f_loc.cpu(), st0.f_loc.cpu()) <= 1e-10
    assert rel_max(st.virial.cpu(), st0.virial.cpu()) <= 1e-10
    assert abs(float(st.pe.sum() - st0.pe.sum())) <= 1e-10 * abs(
        float(st0.pe.sum()))


@pytest.mark.cuda
def test_grid_evaluation_on_two_gloo_ranks_matches_cpu(cuda_device):
    """The (2, 2) fe frame evaluation at distribute on 2 gloo ranks on the
    card (two shards a rank, the kernels; P2P blocks through host memory)
    against the in-process run on the CPU (the plain versions), in f64:
    forces, PE and W within 1e-10 of their scale; one launch of each
    harmonic kernel a rank."""
    from meng_zhang_tpu_torch.models.annp import descriptor_cutoff
    from meng_zhang_tpu_torch.parallel import launch
    from meng_zhang_tpu_torch.parallel.domain2d import Shard2DConfig
    pot = synthetic_fe_potential(0)
    x, box = thermal_bcc((12, 12, 6), seed=4, disp=0.05)
    rc = descriptor_cutoff(*make_annp(pot, torch.float64, "cpu"))
    cfg = Shard2DConfig(n_devices=4, mesh_shape=(2, 2), c_loc=len(x) // 4,
                        cutoff=rc, skin=0.5, dt=0.001)
    spec = launch.ShardRun(cfg=cfg, pot=pot, x=x, box=np.asarray(box),
                           mass=55.845, k_short=128, short_delta=0.3,
                           device="cpu")
    want = launch.run_sharded(spec, distributed=False)
    out = launch.spawn(launch.run_sharded, 2, "gloo", "cuda",
                       (dataclasses.replace(spec, device="cuda"),), 300.0)
    got = out.result
    assert (got["world"], got["n_local"]) == (2, 2)
    for launches in out.launches:
        assert (launches["g_harm"], launches["force_harm"]) == (1, 1)
    assert not got["overflow"].any() and np.isfinite(got["f"]).all()
    assert rel_max(got["f"], want["f"]) <= 1e-10
    assert rel_max(got["virial"], want["virial"]) <= 1e-10
    assert abs(got["pe"] - want["pe"]) <= 1e-10 * abs(want["pe"])
