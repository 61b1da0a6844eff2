"""`ops/kernels.py:_ni_cfg`, the ctypes table that the CUDA ni kernels read
(NiCfg in ops/csrc/ni_bp.cu), against `fused_ni.ni_table`: the per-function
arrays of ni_g and the structure ni_force reads (eta groups, distinct
(lambda, zeta) shapes, squaring chains). ctypes only: runs without a card.
"""
import numpy as np
import pytest

from meng_zhang_tpu_torch.ops import fused_ni as fn
from meng_zhang_tpu_torch.ops import kernels
from meng_zhang_tpu_torch.testing import synthetic_ni_potential
from torch_port_util import reduced_ni_potential


def _functions(c):
    """{column: (eta, lambda, zeta)} as ni_force reads the table: through
    each function's group and shape."""
    return {c.col[f]: (c.grp_eta[c.grp[f]], c.sh_lam[c.shp[f]],
                       c.sh_zeta[c.shp[f]]) for f in range(c.nang)}


def _chain_powers(c, base):
    """Per shape, (f^zeta, zeta f^(zeta - 1)) at f = base[lambda], walking
    the shapes as ni_force does: sh_new starts a chain, sh_adv squares it,
    -1 goes through pow."""
    out, pz, fzm = [], None, None
    for s in range(c.nshape):
        lam, zeta, adv = c.sh_lam[s], c.sh_zeta[s], c.sh_adv[s]
        if adv < 0:
            out.append((base[lam] ** zeta, zeta * base[lam] ** (zeta - 1.0)))
            continue
        if c.sh_new[s]:
            pz, fzm = base[lam], 1.0
        for _ in range(adv):
            fzm, pz = fzm * pz, pz * pz
        out.append((pz, zeta * fzm))
    return out


def _check_against_table(c, table):
    want = {col: (eta, lam, zeta) for eta, group in table.ang
            for lam, zeta, col in group}
    assert c.nang == len(want) and c.ngroup == len(table.ang)
    assert _functions(c) == want
    # ni_g's per-function arrays name the same functions
    assert {c.col[f]: (c.eta[f], c.lam[f], c.zeta[f])
            for f in range(c.nang)} == want
    for f in range(c.nang):
        assert c.coef[f] == 2.0 ** (1.0 - c.zeta[f])
    # shapes are distinct and sorted; the chains give each shape's powers
    shapes = [(c.sh_lam[s], c.sh_zeta[s]) for s in range(c.nshape)]
    assert shapes == sorted(set(shapes))
    base = {lam: 0.5 + 0.25 * lam for lam, _ in shapes}
    for (lam, zeta), (fz, dfz) in zip(shapes, _chain_powers(c, base)):
        assert fz == pytest.approx(base[lam] ** zeta, rel=1e-14)
        assert dfz == pytest.approx(zeta * base[lam] ** (zeta - 1.0),
                                    rel=1e-14)


@pytest.mark.parametrize("suffix", ["f32", "f64"])
def test_ni_cfg_shipped_shape(suffix):
    """3 eta x lambda +-1 x zeta 1, 2, 4, 16: 3 groups, 8 shapes, two
    squaring chains of 0, 1, 1 and 2 squarings."""
    pot = synthetic_ni_potential(0)
    table = fn.ni_table(pot.sym_coerad, pot.sym_coeang)
    c = kernels._ni_cfg(table, suffix)
    assert (c.nrad, c.nang, c.ngroup, c.nshape) == (3, 24, 3, 8)
    assert list(c.sh_lam)[:8] == [-1.0] * 4 + [1.0] * 4
    assert list(c.sh_zeta)[:8] == [1.0, 2.0, 4.0, 16.0] * 2
    assert list(c.sh_new)[:8] == [1, 0, 0, 0] * 2
    assert list(c.sh_adv)[:8] == [0, 1, 1, 2] * 2
    assert list(c.grp)[:24] == [0] * 8 + [1] * 8 + [2] * 8
    assert list(c.shp)[:24] == list(range(8)) * 3
    if suffix == "f64":
        _check_against_table(c, table)


def test_ni_cfg_odd_table():
    """Zetas that are no powers of two (the pow route, which also ends a
    chain), eta groups of unequal size and two functions alike."""
    pot = synthetic_ni_potential(0)
    coeang = np.array(pot.sym_coeang, dtype=np.float64)
    coeang[1, 2], coeang[13, 2], coeang[16, 0] = 3.0, 1.5, coeang[0, 0]
    table = fn.ni_table(pot.sym_coerad, coeang)
    assert [len(group) for _, group in table.ang] == [9, 8, 7]
    c = kernels._ni_cfg(table, "f64")
    _check_against_table(c, table)
    assert c.nshape == 10
    shapes = [(c.sh_lam[s], c.sh_zeta[s]) for s in range(c.nshape)]
    s3 = shapes.index((-1.0, 3.0))
    assert c.sh_adv[s3] == -1 and c.sh_adv[shapes.index((1.0, 1.5))] == -1
    # the chain starts anew after a pow shape: zeta 4 takes two squarings
    assert shapes[s3 + 1] == (-1.0, 4.0)
    assert (c.sh_new[s3 + 1], c.sh_adv[s3 + 1]) == (1, 2)
    # rows 0 and 16 are one function twice: same group and shape
    by_col = {c.col[f]: (c.grp[f], c.shp[f]) for f in range(c.nang)}
    assert by_col[3 + 0] == by_col[3 + 16]


def test_ni_cfg_reduced_and_limits():
    pot = reduced_ni_potential()
    table = fn.ni_table(pot.sym_coerad, pot.sym_coeang)
    c = kernels._ni_cfg(table, "f64")
    _check_against_table(c, table)
    assert (c.ngroup, c.nshape) == (2, 4)
    # more distinct (lambda, zeta) shapes than the kernel holds
    rc = float(pot.sym_coeang[0, 3])
    wide = np.array([[0.01, 1.0, 1.0 + 0.5 * n, rc] for n in range(17)])
    with pytest.raises(ValueError):
        kernels._ni_cfg(fn.ni_table(pot.sym_coerad, wide), "f64")
