"""Crystal lattices, plain and oriented periodic boxes (numpy
only): counterpart of meng_zhang_tpu/geometry/lattice.py, `simple_lattice`,
`bcc`, `fcc` (:20-34), `orientation_matrix`, `euler_matrix_reference`,
`oriented_crystal`, `replicate_data`, `min_replicas` and
`orient_box_lengths` (:37-156).

The replicate -> Euler-rotate -> clip pipeline both reference generators
share (building_matrix, screw_dislocation_bcc_fe.cpp:101-169;
build_crystal, stgb_b.cpp:91-165), vectorised, with the replication range
computed from the box diagonal.
"""
from __future__ import annotations

import numpy as np

from ..units import A_BCC_FE

BCC_BASIS = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
FCC_BASIS = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                      [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])


def simple_lattice(n_cells, a, basis):
    """[nx, ny, nz] periodic box of a cubic lattice; returns (x [N,3], box[3])."""
    n_cells = np.broadcast_to(np.asarray(n_cells), (3,))
    grids = np.meshgrid(*[np.arange(nc) for nc in n_cells], indexing="ij")
    cells = np.stack(grids, axis=-1).reshape(-1, 3)
    x = (cells[:, None, :] + basis[None, :, :]).reshape(-1, 3) * a
    return x, n_cells * a


def bcc(n_cells, a=A_BCC_FE):
    return simple_lattice(n_cells, a, BCC_BASIS)


def fcc(n_cells, a):
    return simple_lattice(n_cells, a, FCC_BASIS)


def orientation_matrix(orient):
    """Row-normalized orientation matrix: x_box = R @ x_crystal.

    `orient` rows are the crystal directions to align with the box x, y, z
    axes (e.g. {1,1,-2},{1,-1,0},{-1,-1,-1}, screw_…cpp:28). Rows must be
    mutually orthogonal. Numerically identical to the reference's Euler-angle
    composition (get_euler_angle + rotation_euler with the alpha/gamma swap,
    screw_…cpp:52-99) -- pinned by test_geometry.py.
    """
    o = np.asarray(orient, dtype=np.float64)
    r = o / np.linalg.norm(o, axis=1, keepdims=True)
    gram = r @ r.T - np.eye(3)
    if np.max(np.abs(gram)) > 1e-9:
        raise ValueError(f"orientation rows not orthogonal: {orient}")
    return r


def euler_matrix_reference(unit_orient):
    """The reference's literal Euler-angle construction, kept as a
    cross-check oracle (get_euler_angle screw_…cpp:52-71 with the
    rotation_euler alpha/gamma swap :73-90)."""
    u = np.asarray(unit_orient, dtype=np.float64)
    z1_proj = np.hypot(u[2, 0], u[2, 1])
    if z1_proj > np.finfo(float).eps:
        x1 = np.array([u[2, 1], -u[2, 0], 0.0])
        alpha = np.arctan2(x1 @ u[1], x1 @ u[0])
        beta = np.arctan2(z1_proj, u[2, 2])
        gamma = -np.arctan2(x1[1], x1[0])
    else:
        alpha = 0.0
        beta = 0.0 if u[2, 2] > 0 else np.pi
        gamma = -np.arctan2(u[0, 1], u[0, 0])
    # rotation_euler swaps alpha <-> gamma before composing
    alpha, gamma = gamma, alpha
    ca, sa = np.cos(alpha), np.sin(alpha)
    cb, sb = np.cos(beta), np.sin(beta)
    cg, sg = np.cos(gamma), np.sin(gamma)
    return np.array([
        [cg * ca - cb * sa * sg, cg * sa + cb * ca * sg, sg * sb],
        [-sg * ca - cb * sa * cg, -sg * sa + cb * ca * cg, cg * sb],
        [sb * sa, -sb * ca, cb],
    ])


def oriented_crystal(orient, length_box, a=A_BCC_FE, basis=BCC_BASIS,
                     center_offset=True, clip_tol=(0.0, 0.0)):
    """Build an oriented crystal filling an orthogonal box.

    Args:
      orient: 3x3 integer crystal directions for the box axes.
      length_box: [3] box edge lengths in Angstrom.
      a: lattice constant.
      basis: fractional basis atoms of the cubic cell.
      center_offset: seed the lattice from the box center (the screw
        generator does, screw_…cpp:107; the STGB generator seeds from the
        corner, stgb_b.cpp:105).
      clip_tol: (lo, hi) tolerance on the x-clip (STGB uses -1/+1 A,
        stgb_b.cpp:159).
    Returns: x [N, 3] positions inside the box.
    """
    r = orientation_matrix(orient)
    length_box = np.asarray(length_box, dtype=np.float64)
    half = length_box / 2.0

    # how many cubic cells to replicate: box half-diagonal in crystal frame
    reach = int(np.ceil(np.linalg.norm(half) / a)) + 2
    rng = np.arange(-reach, reach + 1)
    cells = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"),
                     axis=-1).reshape(-1, 3)
    pts = (cells[:, None, :] + basis[None, :, :]).reshape(-1, 3) * a
    if not center_offset:
        # STGB seeds the lattice at the box corner, then rotates about the
        # center (stgb_b.cpp:105,146-154); screw seeds at the center
        pts = pts - half
    x = pts @ r.T + half                     # rotate about the center
    # half-open upper clip: the reference's inclusive [0, L] keeps an atom
    # at both x=0 and x=L, which are the same periodic site -- an exact
    # overlap under PBC (consciously fixed here)
    eps = 1e-6                               # A; pairs a ~ 0 / a+L ~ L keep one
    lo_t, hi_t = clip_tol
    keep = ((x[:, 0] >= -lo_t - eps) & (x[:, 0] < length_box[0] + hi_t - eps)
            & (x[:, 1] >= -eps) & (x[:, 1] < length_box[1] - eps)
            & (x[:, 2] >= -eps) & (x[:, 2] < length_box[2] - eps))
    return x[keep]


def replicate_data(data, reps):
    """Replicate a LammpsData scene (nx, ny, nz) times.

    The engine's single-image minimum-image convention requires every box
    edge >= 2x the neighbor cutoff. The reference's thin generator scenes
    (e.g. the screw tool's half-cell z, screw_…cpp:31) rely on LAMMPS
    multi-image ghost atoms instead; replicating to a supercell gives
    identical physics within this engine's convention.
    """
    import copy
    reps = np.broadcast_to(np.asarray(reps, dtype=np.int64), (3,))
    grids = np.meshgrid(*[np.arange(r) for r in reps], indexing="ij")
    shifts = np.stack(grids, axis=-1).reshape(-1, 3) * data.box
    out = copy.copy(data)
    out.x = (data.x[None, :, :] + shifts[:, None, :]).reshape(-1, 3)
    out.types = np.tile(data.types, len(shifts))
    if data.v is not None:
        out.v = np.tile(data.v, (len(shifts), 1))
    out.box_hi = data.box_lo + data.box * reps
    return out


def min_replicas(box, cutoff):
    """Per-axis replication needed so every edge >= 2*cutoff."""
    return tuple(int(np.ceil(2.0 * cutoff / b)) for b in np.asarray(box))


def orient_box_lengths(orient, num_lattice, a=A_BCC_FE):
    """Box lengths from per-axis lattice-repeat counts
    (Box::get_length_unitorient, screw_…cpp:29-39):
    L_i = n_i * |orient_i| * a."""
    o = np.asarray(orient, dtype=np.float64)
    dims = np.linalg.norm(o, axis=1)
    return np.asarray(num_lattice, dtype=np.float64) * dims * a
