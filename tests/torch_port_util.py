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
from meng_zhang_tpu_torch.testing import (synthetic_fe_potential,
                                          synthetic_ni_potential, thermal_fcc)
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
    out = {"w": tuple(np.asarray(w) for w in params["w"]),
           "b": tuple(np.asarray(b) for b in params["b"])}
    for key in ("sf_scale", "sf_shift", "coerad", "coeang"):
        if key in params:
            out[key] = np.asarray(params[key])
    return out


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


# reduced ni width: two eta groups, zeta 1 and 16 both present
NI_REDUCED_ANG = ((0.01, -1.0, 1.0), (0.01, 1.0, 16.0), (0.05, 1.0, 1.0),
                  (0.05, -1.0, 16.0))


def reduced_ni_potential(seed=0, ang=NI_REDUCED_ANG, **kw):
    """Synthetic ni-shape potential at reduced width (npsf 2, ntsf 4,
    nnod 6, Rc 5.5 Bohr = 2.91 A, so Ks = 16 holds fcc's 12 partners): the
    Pallas interpreter traces the full-width (27 functions, Ks 32) kernels
    for about a minute, the reduced ones in seconds. Keywords go to
    synthetic_ni_potential."""
    return synthetic_ni_potential(seed, npsf=2, nnod=6, rc_bohr=5.5, ang=ang,
                                  **kw)


def ni_short_planes(rc_s, ks, n_cells=3, seed=0, disp=0.1, capacity=64):
    """[P, Ks] displacement planes (numpy) from the short list at rc_s of
    a perturbed fcc box with one vacancy, so that some rows hold fewer
    partners than the rest; also the filler-lane mask. capacity: the skin
    list's, at rc_s + 0.3."""
    x, box = thermal_fcc(n_cells, seed=seed, disp=disp)
    x = x[1:]                                           # the vacancy
    nbrs = build_neighbors_n2(t64(x), t64(box), rc_s + 0.3, capacity)
    assert not bool(nbrs.overflow)
    sidx = fa.compact_short(t64(x), t64(box), nbrs.idx, rc_s, ks,
                            (True, True, True)).sidx
    planes = [a.numpy() for a in fa.pair_dx_planes(t64(x), t64(box), sidx,
                                                   (True, True, True))]
    return planes, sidx.numpy() == len(x)


def thermal_velocities(n, t, mass, seed):
    """Velocities [n, 3] (numpy, A/ps) at temperature t without drift."""
    from meng_zhang_tpu_torch.units import BOLTZ, MVV2E
    v = np.random.default_rng(seed).normal(size=(n, 3))
    v -= v.mean(axis=0)
    t_now = mass * MVV2E * (v * v).sum() / ((3 * n - 3) * BOLTZ)
    return v * np.sqrt(t / t_now)


def chunked_simulator(cfg, params, n, ensemble, mass, thermo_every=5,
                      skin=0.5, **kw):
    """The port's single-device Simulator of n atoms on the chunked
    functions (shift-free energies, n2 skin list of 64), in f64 on the CPU:
    the reference of the sharded drivers' runs."""
    from meng_zhang_tpu_torch.md.simulation import MDConfig, Simulator
    from meng_zhang_tpu_torch.models import annp

    def force_fn(xx, bb, nbrs):
        return annp.energy_forces_virial_chunked(cfg, params, xx, bb,
                                                 nbrs.idx, shift=False)
    mcfg = MDConfig(dt=0.001, cutoff=annp.descriptor_cutoff(cfg, params),
                    skin=skin, capacity=64, nbr_method="n2",
                    ensemble=ensemble, thermo_every=thermo_every,
                    pbc=cfg.pbc, **kw)
    return Simulator(force_fn, torch.full((n,), mass, dtype=torch.float64),
                     mcfg)


def same_halos_and_rows(st, jst, box, pbc):
    """A grid driver's state against the JAX driver's: the halos equal up
    to its seam shifts (the port keeps the positions as sent), and each
    skin row holds the same entries (the port's by ascending atom id,
    JAX's by frame row)."""
    for got, want in ((st.halo_l, jst.halo_l), (st.halo_r, jst.halo_r)):
        d = got.numpy() - np.asarray(want)
        for a in range(3):
            if pbc[a]:
                d[..., a] -= box[a] * np.round(d[..., a] / box[a])
        assert np.abs(d).max() <= 1e-12
    np.testing.assert_array_equal(np.sort(st.idx.numpy(), axis=-1),
                                  np.sort(np.asarray(jst.idx), axis=-1))
