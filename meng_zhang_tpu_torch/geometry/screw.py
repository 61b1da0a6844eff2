"""Screw-dislocation bcc-Fe geometry generator.

Re-implementation of screw-dislocation-bcc-fe/screw_dislocation_bcc_fe.cpp:
an oriented bcc-Fe box ({1,1,-2},{1,-1,0},{-1,-1,-1} by default, :28) with an
optional 1/2<111> screw dislocation inserted via the isotropic elastic
displacement field u_z = (b/2pi) * theta around a core line along z
(screw_dislocation, :214-243; b = sqrt(3)/2 * a). The generator's hard-coded
source constants become function arguments; output matches the LAMMPS data
files the tool writes (:191-211).

Numpy only; counterpart of meng_zhang_tpu/geometry/screw.py
(`screw_displacement` :23, `make_screw_dislocation` :33).
"""
from __future__ import annotations

import numpy as np

from ..io.lammps_data import LammpsData
from ..units import A_BCC_FE
from .lattice import BCC_BASIS, orient_box_lengths, oriented_crystal

DEFAULT_ORIENT = ((1, 1, -2), (1, -1, 0), (-1, -1, -1))
DEFAULT_NUM_LATTICE = (22, 38, 0.5)


def screw_displacement(x, core_xy, b, eps=0.0):
    """Elastic screw-dislocation field: u_z = (b/2pi) * theta, theta in
    [0, 2pi) around the core (screw_…cpp:235-242, including its
    angle-branch convention)."""
    rot = np.stack([core_xy[0] - x[:, 0], core_xy[1] - x[:, 1]], axis=1)
    theta = np.arctan2(rot[:, 1], rot[:, 0])
    theta = np.where(rot[:, 1] >= eps, theta, theta + 2.0 * np.pi)
    return b / (2.0 * np.pi) * theta


def make_screw_dislocation(orient=DEFAULT_ORIENT,
                           num_lattice=DEFAULT_NUM_LATTICE,
                           a=A_BCC_FE,
                           with_dislocation=False,
                           core_xy=None,
                           boundary_radius=60.0) -> LammpsData:
    """Build the screw-dislocation scene as LammpsData.

    Type assignment matches what the reference writes: type 2 for atoms
    farther than `boundary_radius` (A) from the box center in 3D
    (screw_…cpp:206-210), i.e. a frozen boundary shell.

    When `with_dislocation`, the displacement field is applied around
    `core_xy` (defaults to the box center; the reference selects the core
    interactively from three atom ids, :230-233).
    """
    length_box = orient_box_lengths(orient, num_lattice, a)
    x = oriented_crystal(orient, length_box, a=a, basis=BCC_BASIS,
                         center_offset=True)

    if with_dislocation:
        if core_xy is None:
            core_xy = (length_box[0] / 2.0, length_box[1] / 2.0)
        b = np.sqrt(3.0) * a / 2.0
        x = x.copy()
        x[:, 2] += screw_displacement(x, np.asarray(core_xy, float), b)

    center = length_box / 2.0
    dis = np.linalg.norm(x - center, axis=1)
    types = np.where(dis < boundary_radius, 1, 2).astype(np.int32)
    return LammpsData(x=x, types=types, box_lo=np.zeros(3),
                      box_hi=np.asarray(length_box), n_types=2)
