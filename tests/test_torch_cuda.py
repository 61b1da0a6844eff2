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
pair terms (ni_force: a lane's partners; ni_g: <= 16 listed pairs a lane)
and the G4 columns then sum 32 lanes: 1e-4 of max |value| leaves a wide
margin over the ~1e-6 that f32 rounding of those sums gives.
The cos kernels' f32 bounds are chip_smoke.py's COS_REL_BOUND, derived
there. The delivered forces of a kernel path sum to zero up to rounding:
chip_smoke.py's EVAL_REL["sum_F"], 1e-6 N rms|F|.
"""
import numpy as np
import pytest
import torch

from meng_zhang_tpu_torch.ops import fused_annp as fa
from meng_zhang_tpu_torch.ops import fused_ni as fn
from meng_zhang_tpu_torch.models.annp import make_annp
from meng_zhang_tpu_torch.ops import kernels
from meng_zhang_tpu_torch.system.neighbors import build_neighbors_n2
from meng_zhang_tpu_torch.testing import (synthetic_fe_potential,
                                          synthetic_ni_potential,
                                          thermal_bcc, thermal_fcc)
from meng_zhang_tpu_torch.units import CFLENGTH
from torch_port_util import cuda_device  # noqa: F401  (fixture)
from torch_port_util import (kernel_coeffs, ni_short_planes,
                             reduced_ni_potential, rel_max, short_planes)

# harmonic kernels, per dtype: chip_smoke.REL_BOUND
HARM_RTOL = {torch.float64: 1e-12, torch.float32: 1e-4}
NI_RTOL = {torch.float64: 1e-12, torch.float32: 1e-4}
# chip_smoke.COS_REL_BOUND (g_cos, force_cos)
COS_RTOL = {torch.float64: (1e-12, 1e-12), torch.float32: (1e-4, 3e-4)}
SUM_F_REL = 1e-6        # chip_smoke.EVAL_REL["sum_F"], of N rms|F|


def _harm_case(n_cells, cut, ks, npsf, ntsf, dtype, device):
    """Short planes of a perturbed bcc box with their lanes permuted (one
    seeded permutation for every row), so that the box's neighbors reach
    every slot of a wide K and filler lanes sit between them; the padding
    rows past the box are all filler. Returns (planes, filler, dedg, b)."""
    planes, filler = short_planes(n_cells, cut, ks)
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
    (5, 6.5, 256, 9, 19),        # MAX_K: 8 slots a lane in g_harm
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
    with pytest.raises(ValueError):                 # K above 256 lanes
        kernels.g_harm(*[torch.zeros(8, 300, device=cuda_device)] * 3,
                       4, 5, 4.0)
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
    (5, 6.5, 256, 9, 19),        # MAX_K: 8 warps a row
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
    planes, filler = short_planes(n_cells, cut, ks)
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
    with pytest.raises(ValueError):                 # K above 256 lanes
        kernels.g_cos(*[torch.zeros(8, 300, device=cuda_device)] * 3,
                      4, 5, 4.0)
    with pytest.raises(ValueError):                 # more than 32 functions
        kernels.g_cos(*planes, 4, 33, 4.0)
    with pytest.raises(ValueError):                 # dedg of the wrong width
        kernels.force_cos(*planes, planes[0][:, :1].repeat(1, 100), 4, 5,
                          4.0)


def _ni_case(width):
    """(planes [P, Ks] numpy, filler mask, potential) on a perturbed fcc box
    with a vacancy: reduced width at Ks 16, the shipped width at Ks 32 or,
    for "k17", 17 of its lanes, some of them filler (a K that leaves lanes of
    the warp idle)."""
    pot = reduced_ni_potential() if width == "reduced" \
        else synthetic_ni_potential(0)
    ks = 16 if width == "reduced" else 32
    rc_s = float(pot.sym_coeang[0, 3]) / CFLENGTH + 0.2
    planes, filler = ni_short_planes(rc_s, ks, n_cells=4, seed=2)
    if width == "k17":
        planes = [np.ascontiguousarray(a[:, 4:21]) for a in planes]
        filler = np.ascontiguousarray(filler[:, 4:21])
    return planes, filler, pot


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
                                   "full-odd", "k17"])
def test_ni_kernels_match_plain(cuda_device, width, dtype):
    """Both ni kernels against their plain versions, on the potential's
    table or (-odd) one with zetas 3 and 6. Rows 0-2 are cut down to 0, 1
    and 2 lanes (no candidate pair, none, one), and row 3 holds Ks lanes
    inside the angular cutoff in random directions: the longest pair list,
    496 candidates at Ks 32. The padding-free box also has rows of its
    usual ~12 partners, and "k17" runs with K = 17."""
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
    wide = [torch.zeros(8, 40, device=cuda_device) for _ in range(3)]
    with pytest.raises(ValueError):                 # K above one warp
        kernels.ni_g(*wide, table)
    with pytest.raises(ValueError):
        kernels.ni_force(*wide, torch.zeros(8, fn.NSF_SUB,
                                            device=cuda_device), table)
    planes = [torch.zeros(8, 16, device=cuda_device) for _ in range(3)]
    with pytest.raises(ValueError):                 # dedg of the wrong width
        kernels.ni_force(*planes, torch.zeros(8, 27, device=cuda_device),
                         table)


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
