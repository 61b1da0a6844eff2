"""Geometry-generator CLI -- the runnable counterpart of the reference's
standalone C++ tools (screw_dislocation_bcc_fe.cpp, stgb.cpp), whose
configuration required editing source constants (screw_…cpp:28,31;
stgb.cpp:21-23). Here everything is a flag. Counterpart of
meng_zhang_tpu/tools.py, with the same flags and output files.

    python -m meng_zhang_tpu_torch.tools screw --num-lattice 22 38 0.5 \
        --dislocation --out fe_screw.dat
    python -m meng_zhang_tpu_torch.tools stgb --length 34.97 49.455 32.304 \
        --delete-overlap 1.2 --out fe.dat
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="meng_zhang_tpu_torch.tools")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("screw", help="oriented bcc-Fe box +/- screw dislocation")
    s.add_argument("--orient", type=int, nargs=9,
                   default=(1, 1, -2, 1, -1, 0, -1, -1, -1))
    s.add_argument("--num-lattice", type=float, nargs=3,
                   default=(22, 38, 0.5))
    s.add_argument("--lattice-a", type=float, default=2.8553)
    s.add_argument("--dislocation", action="store_true")
    s.add_argument("--core", type=float, nargs=2, default=None)
    s.add_argument("--boundary-radius", type=float, default=60.0)
    s.add_argument("--out", required=True)

    g = sub.add_parser("stgb", help="symmetric-tilt grain-boundary bicrystal")
    g.add_argument("--orient", type=int, nargs=9,
                   default=(-1, 1, -2, 1, -1, -1, 1, 1, 0))
    g.add_argument("--length", type=float, nargs=3,
                   default=(34.97014031, 49.45524671, 32.30403188))
    g.add_argument("--lattice-a", type=float, default=2.8553)
    g.add_argument("--delete-overlap", type=float, default=None)
    g.add_argument("--out", required=True)

    args = ap.parse_args(argv)
    from .io.lammps_data import write_data

    if args.cmd == "screw":
        from .geometry.screw import make_screw_dislocation
        orient = tuple(tuple(args.orient[i:i + 3]) for i in (0, 3, 6))
        data = make_screw_dislocation(
            orient=orient, num_lattice=tuple(args.num_lattice),
            a=args.lattice_a, with_dislocation=args.dislocation,
            core_xy=args.core, boundary_radius=args.boundary_radius)
        write_data(args.out, data, comment="bcc-Fe screw-dislocation scene")
    else:
        from .geometry.stgb import make_stgb
        orient = tuple(tuple(args.orient[i:i + 3]) for i in (0, 3, 6))
        data = make_stgb(orient=orient, length_box=tuple(args.length),
                         a=args.lattice_a, delete_overlap=args.delete_overlap)
        write_data(args.out, data, comment="bcc-Fe STGB bicrystal")
    print(f"{data.n} atoms -> {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
