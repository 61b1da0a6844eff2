"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. These tests skip without an NVIDIA GPU; on a machine with one, run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX, which the port's machine
need not have; this file imports no JAX.)

Tolerance (f64): the kernels run the plain versions' recurrences in the same
order per lane, but reduce lanes in another order, so each output agrees to
a few hundred ulps of its largest value: max |diff| <= 1e-12 of max |value|.
"""
import pytest
import torch

from meng_zhang_tpu_torch.ops import fused_annp as fa
from meng_zhang_tpu_torch.ops import kernels
from torch_port_util import cuda_device  # noqa: F401  (fixture)
from torch_port_util import kernel_coeffs, rel_max, short_planes, t64

RTOL = 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("n_cells,cut,ks,npsf,ntsf", [
    (3, 4.0, 32, 4, 5),          # reduced width
    (5, 6.5, 128, 9, 19),        # the shipped fe width
])
def test_kernels_match_plain(cuda_device, n_cells, cut, ks, npsf, ntsf):
    planes, _ = short_planes(n_cells, cut, ks)
    planes = [t64(a).to(cuda_device) for a in planes]
    dedg, b = (t64(a).to(cuda_device)
               for a in kernel_coeffs(planes[0].shape[0], npsf, ntsf))
    before = (kernels.g_harm.launches, kernels.force_harm.launches)
    got = kernels.g_harm(*planes, npsf, ntsf, cut)
    want = fa.g_harm_plain(*planes, npsf, ntsf, cut)
    for u, v in zip(got, want):
        assert rel_max(u.cpu(), v.cpu()) <= RTOL
    got = kernels.force_harm(*planes, dedg, b, npsf, ntsf, cut)
    want = fa.force_harm_plain(*planes, dedg, b, npsf, ntsf, cut)
    for u, v in zip(got, want):
        assert rel_max(u.cpu(), v.cpu()) <= RTOL
    assert (kernels.g_harm.launches, kernels.force_harm.launches) == \
        (before[0] + 1, before[1] + 1)


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
