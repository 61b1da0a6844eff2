"""LAMMPS data-file reader/writer (`atomic` atom style), numpy only.

Counterpart of meng_zhang_tpu/io/lammps_data.py: `LammpsData`, `read_data`
(:40) and `write_data` (:118). Like the JAX reader, `read_data` first tries
the native C++ parser (io/native.py, built from native/mzt_native.cpp at
first use) and falls back to the pure-Python reader, `read_data_python`,
which gives the same result.

Covers the subset the reference produces and consumes: the benchmark scene
`fe_st.dat` (read by LAMMPS `read_data`, in.st_test:13) and the output of
both geometry generators (screw_dislocation_bcc_fe.cpp:195-211,
stgb_b.cpp:183-205): header with `N atoms`, `M atom types`,
`xlo xhi`/`ylo yhi`/`zlo zhi`, then `Atoms # atomic` rows
`id type x y z [ix iy iz]`, optional `Velocities` rows `id vx vy vz` and
an optional `Masses` section.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LammpsData:
    x: np.ndarray             # [N, 3] positions, engine frame: [0, box)
    types: np.ndarray         # [N] 1-based atom types
    box_lo: np.ndarray        # [3]
    box_hi: np.ndarray        # [3]
    n_types: int
    v: np.ndarray | None = None          # [N, 3] velocities or None
    masses: np.ndarray | None = None     # [n_types] from a Masses section

    @property
    def box(self) -> np.ndarray:
        return self.box_hi - self.box_lo

    @property
    def n(self) -> int:
        return len(self.x)


_SECTIONS = ("Atoms", "Velocities", "Masses", "Bonds", "Angles", "Pair Coeffs",
             "PairIJ Coeffs")


def read_data(path: str) -> LammpsData:
    """Read a LAMMPS data file. Coordinates are shifted into the engine's
    [0, box) frame (x -= box_lo): the cell binning and wrap logic assume a
    zero origin, and LAMMPS boxes commonly have nonzero xlo/ylo/zlo.
    `box_lo` is kept so `write_data` restores the original frame exactly.
    The native parser reads the file when it is available
    (io/native.py), else `read_data_python`."""
    from .native import read_data_native
    nat = read_data_native(path)
    if nat is None:
        return read_data_python(path)
    x, types, v, masses, lo, hi, n_types = nat
    return LammpsData(x=x - lo, types=types, box_lo=lo, box_hi=hi,
                      n_types=n_types, v=v, masses=masses)


def read_data_python(path: str) -> LammpsData:
    """`read_data` in pure Python."""
    with open(path) as f:
        lines = f.read().splitlines()

    n = n_types = 0
    lo = np.zeros(3)
    hi = np.zeros(3)
    i = 1                                   # first line is a comment
    # --- header ---
    while i < len(lines):
        s = lines[i].split("#")[0].strip()
        if any(s.startswith(sec) for sec in _SECTIONS):
            break
        t = s.split()
        if len(t) >= 2 and t[1] == "atoms":
            n = int(t[0])
        elif len(t) >= 3 and t[1] == "atom" and t[2] == "types":
            n_types = int(t[0])
        elif len(t) >= 4 and t[2] == "xlo":
            lo[0], hi[0] = float(t[0]), float(t[1])
        elif len(t) >= 4 and t[2] == "ylo":
            lo[1], hi[1] = float(t[0]), float(t[1])
        elif len(t) >= 4 and t[2] == "zlo":
            lo[2], hi[2] = float(t[0]), float(t[1])
        i += 1

    x = np.zeros((n, 3))
    types = np.zeros(n, dtype=np.int32)
    v = None
    masses = None

    def read_rows(start, count, cols):
        rows = []
        k = start
        while len(rows) < count and k < len(lines):
            s = lines[k].strip()
            if s:
                rows.append([float(tok) for tok in s.split()[:cols]])
            k += 1
        return np.asarray(rows), k

    # --- sections ---
    while i < len(lines):
        s = lines[i].split("#")[0].strip()
        if s.startswith("Atoms"):
            rows, i = read_rows(i + 1, n, 5)
            ids = rows[:, 0].astype(np.int64) - 1
            types[ids] = rows[:, 1].astype(np.int32)
            x[ids] = rows[:, 2:5]
            continue
        if s.startswith("Velocities"):
            rows, i = read_rows(i + 1, n, 4)
            v = np.zeros((n, 3))
            ids = rows[:, 0].astype(np.int64) - 1
            v[ids] = rows[:, 1:4]
            continue
        if s.startswith("Masses"):
            rows, i = read_rows(i + 1, n_types, 2)
            masses = rows[:, 1].copy()
            continue
        i += 1

    return LammpsData(x=x - lo, types=types, box_lo=lo, box_hi=hi,
                      n_types=n_types, v=v, masses=masses)


def write_data(path: str, data: LammpsData, comment="generated by meng_zhang_tpu_torch"):
    """Write a LAMMPS data file in the original [box_lo, box_hi) frame
    (coordinates stored engine-frame are shifted back by box_lo)."""
    with open(path, "w") as f:
        f.write(f"#{comment}\n")
        f.write(f"{data.n} atoms\n")
        f.write(f"{data.n_types} atom types\n")
        f.write(f"{data.box_lo[0]:.10g} {data.box_hi[0]:.10g} xlo xhi\n")
        f.write(f"{data.box_lo[1]:.10g} {data.box_hi[1]:.10g} ylo yhi\n")
        f.write(f"{data.box_lo[2]:.10g} {data.box_hi[2]:.10g} zlo zhi\n")
        if data.masses is not None:
            f.write("\nMasses\n\n")
            for t, m in enumerate(data.masses, start=1):
                f.write(f"{t} {m:.6f}\n")
        f.write("\nAtoms # atomic\n\n")
        xw = data.x + data.box_lo
        for k in range(data.n):
            f.write(f"{k + 1} {int(data.types[k])} "
                    f"{xw[k, 0]:.10g} {xw[k, 1]:.10g} {xw[k, 2]:.10g}\n")
        if data.v is not None:
            f.write("\nVelocities\n\n")
            for k in range(data.n):
                f.write(f"{k + 1} {data.v[k, 0]:.10g} {data.v[k, 1]:.10g} "
                        f"{data.v[k, 2]:.10g}\n")
