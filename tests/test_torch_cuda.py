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
(p, q) terms and the G4 columns then sum 32 lanes: 1e-4 of max |value|
leaves a wide margin over the ~1e-6 that f32 rounding of those sums gives.
The cos kernels' f32 bounds are chip_smoke.py's COS_REL_BOUND, derived
there.
"""
import numpy as np
import pytest
import torch

from meng_zhang_tpu_torch.ops import fused_annp as fa
from meng_zhang_tpu_torch.ops import fused_ni as fn
from meng_zhang_tpu_torch.ops import kernels
from meng_zhang_tpu_torch.testing import synthetic_ni_potential
from meng_zhang_tpu_torch.units import CFLENGTH
from torch_port_util import cuda_device  # noqa: F401  (fixture)
from torch_port_util import (kernel_coeffs, ni_short_planes,
                             reduced_ni_potential, rel_max, short_planes)

# harmonic kernels, per dtype: chip_smoke.REL_BOUND
HARM_RTOL = {torch.float64: 1e-12, torch.float32: 1e-4}
NI_RTOL = {torch.float64: 1e-12, torch.float32: 1e-4}
# chip_smoke.COS_REL_BOUND (g_cos, force_cos)
COS_RTOL = {torch.float64: (1e-12, 1e-12), torch.float32: (1e-4, 3e-4)}


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n_cells,cut,ks,npsf,ntsf", [
    (3, 4.0, 40, 4, 5),          # K not a multiple of 32
    (5, 6.5, 128, 9, 19),        # the shipped fe width, short-list lanes
    (5, 6.5, 192, 9, 19),        # skin-list lanes (energy_dedg)
    (3, 4.0, 32, 4, 1),          # one angular function
])
def test_cos_kernels_match_plain(cuda_device, n_cells, cut, ks, npsf, ntsf,
                                 dtype):
    planes, filler = short_planes(n_cells, cut, ks)
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
    with a vacancy: reduced width at Ks 16, the shipped width at Ks 32."""
    pot = reduced_ni_potential() if width == "reduced" \
        else synthetic_ni_potential(0)
    ks = 16 if width == "reduced" else 32
    rc_s = float(pot.sym_coeang[0, 3]) / CFLENGTH + 0.2
    planes, filler = ni_short_planes(rc_s, ks, n_cells=4, seed=2)
    return planes, filler, pot


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("width", ["reduced", "full"])
def test_ni_kernels_match_plain(cuda_device, width, dtype):
    planes, filler, pot = _ni_case(width)
    table = fn.ni_table(pot.sym_coerad, pot.sym_coeang)
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
