"""`ops/kernels.py:_ni_cfg`, the ctypes table that the CUDA ni kernels read
(NiCfg in ops/csrc/ni_bp.cu), against `fused_ni.ni_table`: the per-function
arrays of ni_g and the structure ni_force reads (eta groups, distinct
(lambda, zeta) shapes, the (group, shape) entries that occur, squaring
chains), and a Python mirror of ni_force's walk over the entries. ctypes
only: runs without a card.
"""
import numpy as np
import pytest

from meng_zhang_tpu_torch.ops import fused_ni as fn
from meng_zhang_tpu_torch.ops import kernels
from meng_zhang_tpu_torch.testing import (NI_WIDE_ANGULAR, NI_WIDE_RAD_ETAS,
                                          synthetic_ni_potential)
from meng_zhang_tpu_torch.units import CFLENGTH
from torch_port_util import reduced_ni_potential

SHAPE_CHUNK = 16        # ni_bp.cu kShapeChunk


def _entries(c):
    """[(group, shape)] of the table's entries: group by group, each
    group's shapes the set bits of grp_mask, numbered from grp_off."""
    out = []
    for g in range(c.ngroup):
        assert c.grp_off[g] == len(out)
        out += [(g, s) for s in range(c.nshape) if (c.grp_mask[g] >> s) & 1]
    assert len(out) == c.nent
    return out


def _functions(c):
    """{column: (eta, lambda, zeta)} as ni_force reads the table: through
    each function's entry, its group and its shape."""
    ent = _entries(c)
    return {c.col[f]: (c.grp_eta[ent[c.ent[f]][0]],
                       c.sh_lam[ent[c.ent[f]][1]],
                       c.sh_zeta[ent[c.ent[f]][1]]) for f in range(c.nang)}


def _walk(c):
    """ni_force's stage-2 walk over the table, mirrored: shape chunks of
    SHAPE_CHUNK, within each the groups that use a shape of the chunk,
    their entries from grp_off + popc(mask below the chunk) on, one a set
    bit. Returns [(group, shape, entry)] in visiting order."""
    out = []
    for c0 in range(0, c.nshape, SHAPE_CHUNK):
        nsh = min(c.nshape - c0, SHAPE_CHUNK)
        full = (1 << nsh) - 1
        for g in range(c.ngroup):
            gm = c.grp_mask[g]
            m = (gm >> c0) & full
            if m == 0:
                continue
            e = c.grp_off[g] + bin(gm & ((1 << c0) - 1)).count("1")
            for i in range(nsh):
                if m == full or (m >> i) & 1:
                    out.append((g, c0 + i, e))
                    e += 1
    return out


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
    assert c.nrad == len(table.rad)
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
    # entries: the (group, shape) pairs that occur, each once, and the walk
    # visits each once under its own number
    ent = _entries(c)
    assert sorted(set(ent)) == ent
    assert set(ent) == {ent[c.ent[f]] for f in range(c.nang)}
    assert sorted(_walk(c), key=lambda t: t[2]) == [
        (g, s, e) for e, (g, s) in enumerate(ent)]


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
    # every group uses every shape: 24 entries, function f's the f-th
    assert c.nent == 24 and list(c.grp_mask)[:3] == [0xff] * 3
    assert [_entries(c)[c.ent[f]] for f in range(24)] == \
        [(g, s) for g in range(3) for s in range(8)]
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
    # rows 0 and 16 are one function twice: one entry
    by_col = {c.col[f]: c.ent[f] for f in range(c.nang)}
    assert by_col[3 + 0] == by_col[3 + 16]
    assert c.nent == 23


def test_ni_cfg_reduced_and_limits():
    """Every table that the TPU kernels take is taken: here 17 distinct
    (lambda, zeta) shapes in one eta group (two shape chunks of ni_force's
    walk). Refused only where JAX refuses too (pallas_ni.py:68, :317):
    more than NSF_SUB = 32 functions, or angular rows of more than one
    cutoff."""
    pot = reduced_ni_potential()
    table = fn.ni_table(pot.sym_coerad, pot.sym_coeang)
    c = kernels._ni_cfg(table, "f64")
    _check_against_table(c, table)
    assert (c.ngroup, c.nshape) == (2, 4)
    rc = float(pot.sym_coeang[0, 3])
    wide = np.array([[0.01, 1.0, 1.0 + 0.5 * n, rc] for n in range(17)])
    table = fn.ni_table(pot.sym_coerad, wide)
    c = kernels._ni_cfg(table, "f64")
    _check_against_table(c, table)
    assert (c.ngroup, c.nshape, c.nent) == (1, 17, 17)
    # nsf = 2 + 31 = 33
    over = np.array([[0.01 * (1 + n % 5), 1.0, 1.0 + n, rc]
                     for n in range(31)])
    with pytest.raises(ValueError, match="exceed"):
        kernels._ni_cfg(fn.ni_table(pot.sym_coerad, over), "f64")
    mixed = np.array(pot.sym_coeang, dtype=np.float64)
    mixed[-1, 3] = rc + 0.5
    with pytest.raises(ValueError, match="cutoffs"):
        fn.ni_table(pot.sym_coerad, mixed)


@pytest.mark.parametrize("suffix", ["f32", "f64"])
def test_ni_cfg_wide_table(suffix):
    """10 radial + 22 angular functions (nsf 32, every column) at 20
    distinct etas over 22 shapes: groups of one and two entries, the
    power-of-two chains broken by pow shapes, two shape chunks."""
    pot = synthetic_ni_potential(0, npsf=10, rc_bohr=6.0 * CFLENGTH,
                                 ang=NI_WIDE_ANGULAR,
                                 rad_etas=NI_WIDE_RAD_ETAS)
    table = fn.ni_table(pot.sym_coerad, pot.sym_coeang)
    c = kernels._ni_cfg(table, suffix)
    assert (c.nrad, c.nang, c.ngroup, c.nshape, c.nent) == (10, 22, 20, 22,
                                                            22)
    assert sorted(len(group) for _, group in table.ang) == [1] * 18 + [2] * 2
    assert list(c.rad_eta)[:10] == pytest.approx(NI_WIDE_RAD_ETAS, rel=0)
    pow_shapes = [s for s in range(c.nshape) if c.sh_adv[s] < 0]
    assert len(pow_shapes) == 12                  # zetas 1.5, 3, 5, 6, 10, 12
    if suffix == "f64":
        _check_against_table(c, table)
