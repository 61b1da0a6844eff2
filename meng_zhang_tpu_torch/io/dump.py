"""LAMMPS-style trajectory dump writer (`dump atom/custom` text format),
readable by OVITO/VMD (numpy only). Counterpart of
meng_zhang_tpu/io/dump.py (`DumpWriter`, :9)."""
from __future__ import annotations

import numpy as np


class DumpWriter:
    """Appends `ITEM:`-block snapshots to a .lammpstrj file."""

    def __init__(self, path: str, types=None):
        self.path = path
        self.types = types
        self._fh = open(path, "w")

    def write(self, step: int, x, box, v=None, box_lo=None, extra=None):
        """extra: optional {column_name: [N] or [N, C] array} of per-atom
        quantities appended as columns (LAMMPS `dump custom` style, e.g.
        c_pe from compute pe/atom, c_stress[1..6] from stress/atom --
        the observables the reference tallies via eatom/vatom,
        fe/src/pair_annp.cpp:183,197-205). Multi-column arrays expand to
        name[1]..name[C]."""
        x = np.asarray(x)
        box = np.asarray(box)
        lo = np.zeros(3) if box_lo is None else np.asarray(box_lo)
        n = len(x)
        fh = self._fh
        fh.write("ITEM: TIMESTEP\n%d\n" % step)
        fh.write("ITEM: NUMBER OF ATOMS\n%d\n" % n)
        fh.write("ITEM: BOX BOUNDS pp pp pp\n")
        for d in range(3):
            fh.write("%.10g %.10g\n" % (lo[d], lo[d] + box[d]))
        ecols, edata = [], []
        for name, arr in (extra or {}).items():
            a = np.asarray(arr)
            if a.ndim == 1:
                ecols.append(name)
                edata.append(a)
            else:
                for c in range(a.shape[1]):
                    ecols.append("%s[%d]" % (name, c + 1))
                    edata.append(a[:, c])
        cols = "id type x y z" + (" vx vy vz" if v is not None else "") \
            + ("".join(" " + c for c in ecols))
        fh.write("ITEM: ATOMS %s\n" % cols)
        types = self.types if self.types is not None else np.ones(n, int)
        v = None if v is None else np.asarray(v)
        for i in range(n):
            row = [x[i, 0], x[i, 1], x[i, 2]]
            if v is not None:
                row += [v[i, 0], v[i, 1], v[i, 2]]
            row += [col[i] for col in edata]
            fh.write("%d %d %s\n" % (i + 1, types[i],
                                     " ".join("%.8g" % r for r in row)))
        fh.flush()

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
