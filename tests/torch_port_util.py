"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

Both packages get the same numpy inputs; the JAX side runs on the CPU with
x64 on (tests/conftest.py) and Pallas in interpret mode, the port in f64 on
the CPU, where its kernel wrappers take their plain PyTorch versions.
"""
import numpy as np
import pytest
import torch

from meng_zhang_tpu_torch.ops import fused_annp as fa
from meng_zhang_tpu_torch.system.neighbors import build_neighbors_n2
from meng_zhang_tpu_torch.testing import synthetic_fe_potential
from meng_zhang_tpu_torch.testing import thermal_bcc as perturbed_bcc

# tier-1 runs six xdist workers on eight cores
torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    """The card, for tests marked `cuda`; decided at run time, so every
    xdist worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def reduced_potential(cut=6.5, seed=0):
    """Synthetic fe-shape potential at reduced width (npsf 4, ntsf 5,
    nnod 6): the Pallas interpreter traces the full-width (L = 18) ladder
    for about a minute, the reduced one in seconds."""
    return synthetic_fe_potential(seed, npsf=4, ntsf=5, nnod=6, cut=cut)


def full_potential(seed=0):
    return synthetic_fe_potential(seed)


def params_numpy(params):
    return {"w": tuple(np.asarray(w) for w in params["w"]),
            "b": tuple(np.asarray(b) for b in params["b"]),
            "sf_scale": np.asarray(params["sf_scale"]),
            "sf_shift": np.asarray(params["sf_shift"])}


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def rel_max(a, b):
    """max |a - b| / max |b| over numpy-convertible arrays."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def short_planes(n_cells, cut, ks, seed=0):
    """[P, Ks] displacement planes from the short list of a perturbed bcc
    box (P a multiple of 8, the Pallas tile), with filler lanes; numpy.
    Also returns the filler-lane mask."""
    x, box = perturbed_bcc(n_cells, seed=seed)
    nbrs = build_neighbors_n2(t64(x), t64(box), cut + 0.5, 128)
    sidx = fa.compact_short(t64(x), t64(box), nbrs.idx, cut + 0.4, ks,
                            (True, True, True)).sidx
    planes = fa.pair_dx_planes(t64(x), t64(box), sidx, (True, True, True))
    p = -(-len(x) // 8) * 8
    out = []
    for d in range(3):
        a = planes[d].numpy()
        pad = np.full((p - a.shape[0], ks), 2.0 * box[d] + 10.0)
        out.append(np.concatenate([a, pad]))
    filler = np.ones((p, ks), dtype=bool)
    filler[:len(x)] = sidx.numpy() == len(x)
    return out, filler


def kernel_coeffs(p, npsf, ntsf, seed=1):
    """Random force-kernel inputs: dedg_rad [P, 128], b [P, 384] (B_lm and
    2q); numpy."""
    rng = np.random.default_rng(seed)
    dedg = np.zeros((p, fa.NSF_PAD))
    dedg[:, :npsf] = rng.normal(size=(p, npsf))
    b = np.zeros((p, fa.AB_PAD))
    b[:, :ntsf * ntsf + 1] = rng.normal(size=(p, ntsf * ntsf + 1))
    return dedg, b
